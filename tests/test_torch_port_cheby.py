"""The port's Chebyshev (``cheby``) slice against kanvit and the reference.

- ``chebykan`` and ``cheby_qkv_grouped`` against kanvit's Pallas kernels in
  interpret mode (``dispatch.set_impl("pallas")``), forward and gradients,
  to 1e-5, with inputs where ``tanh(x)`` rounds to +-1 (|x| in [9.5, 20]).
  The gradient tests run through autograd of the plain version (the CPU
  path) and through the CUDA path's ``torch.autograd.Function``s with each
  launch emulated on the CPU (``kernel_math``).
- The executed-reference goldens (``layer_chebykan``, ``msa_cheby``).
- ``ChebyKANLayer``, the cheby ``MSA`` and the cheby ViT against kanvit's
  ``apply`` on the same weights, and 3 train steps against kanvit's step.

kanvit's plain twin ``chebykan_forward`` computes ``cos(n acos(tanh x))``,
whose gradient under ``jax.grad`` is NaN where ``tanh x`` rounds to +-1; its
Pallas kernel's recurrence gives the finite 0 there. The port follows the
kernel, and is held against it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.kernels import fused_basis as JFB
from kanvit.layers.attention import MSA as JMSA
from kanvit.layers.kan import ChebyKANLayer as JChebyKANLayer
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA, ChebyKANLayer
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import (
    _close_grads,
    _emu_bwd,
    _emu_fwd,
    _emu_lanes_bwd,
    _emu_lanes_fwd,
    _jax_grads,
    _maxdiff,
    _torch_grads,
)
from test_torch_port_train import check_grads, check_losses, check_params, run_steps

TOL = 1e-5
LOGIT_TOL = 1e-3
MNIST = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=64, n_heads=2,
             out_d=10)
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


@pytest.fixture(params=["plain", "kernel_math"])
def grad_path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: the CUDA path's Functions
    with each launch emulated on the CPU."""
    if request.param == "kernel_math":
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(FB, "_launch", _emu_fwd)
        monkeypatch.setattr(FB, "_launch_bwd", _emu_bwd)
        monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
        monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    return request.param


def _launched():
    return {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}


def cheby_inputs(rng, shape, saturated=0.2):
    """Normal inputs with a share where tanh(x) rounds to +-1 in f32
    (|x| in [9.5, 20], either sign)."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = (rng.uniform(9.5, 20.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


def cheby_coeffs(rng, *shape):
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


# --- the basis --------------------------------------------------------------

def test_cheby_bases_match_kanvit():
    """The recurrence's values against kanvit's ``cos(n acos t)``, and its
    derivative against kanvit's closed form ``n sin(n acos t) sqrt(1-t^2)``."""
    rng = np.random.default_rng(40)
    x = cheby_inputs(rng, (64, 12))
    b, db = K.cheby_bases_and_grad(torch.from_numpy(x), 4)
    jb, jdb = JK.cheby_bases_and_grad(jnp.asarray(x), 4)
    assert b.shape == db.shape == (64, 12, 5)
    assert _maxdiff(b, jb) <= TOL
    assert _maxdiff(K.cheby_bases(torch.from_numpy(x), 4), jb) <= TOL
    assert _maxdiff(db, jdb) <= TOL * max(1.0, float(np.abs(jdb).max()))
    sat = np.abs(x) >= 9.5
    assert np.all(db.numpy()[sat] == 0)


def test_cheby_plain_grad_is_finite_where_kanvits_twin_is_nan():
    """At x = [0.5, 9.5, -12, 3] (one output, unit coefficients): kanvit's
    jnp twin gives NaN at the saturated entries, its Pallas kernel 0; the
    port's plain version gives the kernel's numbers."""
    x = np.float32([[0.5, 9.5, -12.0, 3.0]])
    coeffs = np.ones((4, 1, 5), np.float32)

    def loss(f):
        return lambda xx: f(xx, jnp.asarray(coeffs)).sum()

    jdispatch.set_impl("jnp")
    twin = np.asarray(jax.grad(loss(JK.chebykan_forward))(jnp.asarray(x)))
    jdispatch.set_impl("pallas")
    kernel = np.asarray(jax.grad(loss(JFB.chebykan))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    FB.chebykan(xt, torch.from_numpy(coeffs)).sum().backward()
    got = xt.grad.numpy()
    assert np.isnan(twin[0, 1:3]).all() and np.isfinite(twin[0, [0, 3]]).all()
    assert np.isfinite(kernel).all() and np.all(kernel[0, 1:3] == 0)
    assert np.isfinite(got).all()
    assert _maxdiff(got, kernel) <= TOL * max(1.0, float(np.abs(kernel).max()))
    ok = np.isfinite(twin)
    assert _maxdiff(got[ok], twin[ok]) <= TOL * max(1.0, float(np.abs(twin[ok]).max()))


# --- the kernel wrappers against kanvit's Pallas kernels ---------------------

@pytest.mark.parametrize("n,nin,nout,lead", [(37, 16, 8, ()), (20, 24, 12, (2,))])
def test_chebykan_matches_pallas(n, nin, nout, lead):
    rng = np.random.default_rng(41)
    x = cheby_inputs(rng, (*lead, n, nin))
    cc = cheby_coeffs(rng, nin, nout, 5)
    want = JFB.chebykan(jnp.asarray(x), jnp.asarray(cc))
    with torch.inference_mode():
        got = FB.chebykan(torch.from_numpy(x), torch.from_numpy(cc))
    assert got.shape == (*lead, n, nout)
    assert _maxdiff(got, want) <= TOL
    assert _launched() == {}


@pytest.mark.parametrize("n,nin,nout", [(37, 16, 8), (20, 24, 12)])
def test_chebykan_grads_match_pallas(grad_path, n, nin, nout):
    """dx and dcoeffs through kanvit's Pallas backward, finite where tanh
    saturates."""
    rng = np.random.default_rng(42)
    x = cheby_inputs(rng, (n, nin))
    cc = cheby_coeffs(rng, nin, nout, 5)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads(JFB.chebykan, (x, cc), g)
    got_y, got = _torch_grads(FB.chebykan, (x, cc), g)
    assert all(np.isfinite(a).all() for a in (*want, *got))
    assert _maxdiff(got_y, want_y) <= TOL
    _close_grads(got, want)
    if grad_path == "kernel_math":
        assert _launched() == {"chebykan": 1, "chebykan_bwd": 1}
    else:
        assert _launched() == {}


def _qkv_inputs(rng, n, h, dh):
    return cheby_inputs(rng, (n, h * dh), 0.05), cheby_coeffs(rng, h, dh, 3 * dh, 5)


@pytest.mark.parametrize("n,h,dh", [(20, 2, 16), (13, 3, 8)])
def test_cheby_qkv_grouped_matches_pallas(n, h, dh):
    rng = np.random.default_rng(43)
    x2d, cc = _qkv_inputs(rng, n, h, dh)
    want = JFB.cheby_qkv_grouped(jnp.asarray(x2d), jnp.asarray(cc))
    assert want is not None  # the Pallas tier engaged
    with torch.inference_mode():
        got = FB.cheby_qkv_grouped(torch.from_numpy(x2d), torch.from_numpy(cc))
    assert got.shape == (n, h * 3 * dh)
    assert _maxdiff(got, want) <= TOL
    assert _launched() == {}


@pytest.mark.parametrize("n,h,dh", [(20, 2, 16), (13, 3, 8)])
def test_cheby_qkv_grouped_grads_match_pallas(grad_path, n, h, dh):
    rng = np.random.default_rng(44)
    x2d, cc = _qkv_inputs(rng, n, h, dh)
    g = rng.standard_normal((n, h * 3 * dh)).astype(np.float32)
    want_y, want = _jax_grads(JFB.cheby_qkv_grouped, (x2d, cc), g)
    got_y, got = _torch_grads(FB.cheby_qkv_grouped, (x2d, cc), g)
    assert _maxdiff(got_y, want_y) <= TOL
    _close_grads(got, want)
    if grad_path == "kernel_math":
        assert _launched() == {"cheby_qkv_grouped": 1, "cheby_qkv_grouped_bwd": 1}


# --- packing and argument checks ---------------------------------------------

def test_packed_cheby_weight_layout():
    """y = sum_s T_s(tanh x) W[s] under the packed layouts gives back the
    plain forwards."""
    rng = np.random.default_rng(45)
    x = torch.from_numpy(cheby_inputs(rng, (11, 12)))
    cc = torch.from_numpy(cheby_coeffs(rng, 12, 7, 5))
    w = FB.pack_cheby_weight(cc)
    assert w.shape == (1, 5, 12, 7)
    got = torch.einsum("nis,sio->no", K.cheby_bases(x, 4), w[0])
    assert _maxdiff(got, K.chebykan_forward(x, cc)) <= TOL

    n, h, dh = 9, 3, 4
    x2d = torch.from_numpy(cheby_inputs(rng, (n, h * dh)))
    qcc = torch.from_numpy(cheby_coeffs(rng, h, dh, 3 * dh, 5))
    wq = FB.pack_cheby_qkv_weight(qcc)
    assert wq.shape == (h, 5, dh, 3 * dh)
    basis = K.cheby_bases(x2d.reshape(n, h, dh), 4)
    got = torch.einsum("nhis,hsio->nho", basis, wq).reshape(n, -1)
    with torch.inference_mode():
        want = FB.cheby_qkv_grouped(x2d, qcc)
    assert _maxdiff(got, want) <= TOL


@pytest.mark.parametrize("bad,err,match", [
    ("degree", ValueError, "Chebyshev degree 4"),
    ("x64", TypeError, "x must be float32"),
    ("w64", TypeError, "weight must be float32"),
    ("slices", ValueError, "does not match packed weight"),
    ("stride", ValueError, "unit column stride"),
    ("rows", ValueError, "launch grid"),
])
def test_cheby_kernel_arg_checks(bad, err, match):
    x, w, degree = torch.zeros(10, 2 * 16), torch.zeros(2, 5, 16, 4), 4
    if bad == "degree":
        degree = 3
    elif bad == "x64":
        x = x.double()
    elif bad == "w64":
        w = w.double()
    elif bad == "slices":
        w = torch.zeros(2, 4, 16, 4)
    elif bad == "stride":
        x = torch.zeros(10, 4 * 16)[:, ::2]
    elif bad == "rows":
        x = torch.zeros(1, 2 * 16).expand(FB.ROWS_PER_TILE * FB.MAX_ROW_TILES + 1, -1)
    with pytest.raises(err, match=match):
        FB.check_cheby_args(x, w, degree)
    FB.check_cheby_args(torch.zeros(10, 64)[:, :32], torch.zeros(2, 5, 16, 4), 4)


# --- layers and model ---------------------------------------------------------

@pytest.mark.parametrize("case", ["2", "3"])
def test_chebykan_golden(case):
    """The executed reference (``cos(n acos t)``) to 1e-5; its 3-D output is
    the collapsed ``(B*T, out)`` (``y3flat``), the port keeps the lead dims."""
    g, sd = load_golden("layer_chebykan")
    layer = ChebyKANLayer(16, 8, 4)
    load_reference_state_dict(layer, sd)
    with torch.inference_mode():
        got = layer(torch.from_numpy(g[f"x{case}"])).numpy()
    want = g["y2"] if case == "2" else g["y3flat"]
    assert got.shape == (g[f"x{case}"].shape[:-1] + (8,))
    assert _maxdiff(got.reshape(want.shape), want) <= TOL


def test_msa_cheby_golden():
    g, sd = load_golden("msa_cheby")
    msa = MSA(16, n_heads=2, type="cheby")
    load_reference_state_dict(msa, sd)
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(g["x"])), g["y"]) <= TOL


def _numpy_sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("d,heads,t", [(16, 2, 5), (384, 6, 9)])
def test_msa_cheby_matches_kanvit(d, heads, t):
    """One ``cheby_qkv_grouped`` launch for every head against kanvit's
    shared-basis path (its grouped Pallas kernel)."""
    x = cheby_inputs(np.random.default_rng(46), (2, t, d), 0.05)
    src = MSA(d, n_heads=heads, type="cheby",
              generator=torch.Generator().manual_seed(3))
    params = params_from_torch_state_dict(
        _numpy_sd(src, "blocks.0.attn."))["blocks_0"]["attn"]
    want = jax.jit(JMSA(d, n_heads=heads, type="cheby").apply)(
        {"params": params}, jnp.asarray(x))
    msa = MSA(d, n_heads=heads, type="cheby")
    sd = state_dict_from_jax_params({"blocks_0": {"attn": params}})
    load_reference_state_dict(msa, {k[len("blocks.0.attn."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(x)), want) <= TOL


@pytest.fixture(scope="module")
def mnist_cheby():
    sd = _numpy_sd(create_model("cheby", **MNIST, seed=1))
    x = np.random.default_rng(47).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(sd), x


def test_cheby_model_matches_kanvit_apply(mnist_cheby):
    params, x = mnist_cheby
    want = np.asarray(jax.jit(j_create_model("cheby", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("cheby", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_cheby_converter_matches_torch_compat_bytes(mnist_cheby):
    params, _ = mnist_cheby
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k


def test_cheby_state_dict_skips_reference_arange():
    """The reference's ChebyKAN saves an ``arange`` buffer; the port derives
    it, and the loader skips it."""
    _, sd = load_golden("msa_cheby")
    assert any(k.endswith(".arange") for k in sd)
    msa = MSA(16, 2, "cheby")
    assert set(msa.state_dict()) == {k for k in sd if not k.endswith(".arange")}
    load_reference_state_dict(msa, sd)


def test_chebykan_init_matches_kanvit_distribution():
    """Normal, std 1/(in (degree+1)), on both sides."""
    nin, nout = 64, 48
    jp = np.asarray(JChebyKANLayer(nin, nout, 4).init(
        jax.random.PRNGKey(5), jnp.zeros((2, nin)))["params"]["cheby_coeffs"])
    tp = ChebyKANLayer(nin, nout, 4, generator=torch.Generator().manual_seed(5)
                       ).cheby_coeffs.detach().numpy()
    std = 1.0 / (nin * 5)
    for p in (jp, tp):
        assert p.shape == (nin, nout, 5)
        assert abs(p.std() / std - 1.0) < 0.05 and abs(p.mean()) < 0.05 * std


def test_cheby_model_gradients_take_the_function_path(monkeypatch):
    """The cheby ViT's backward reaches each Function once per launch; the
    embedder's backward asks for dW only (patches need no gradient)."""
    needs = []

    def emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
        needs.append((name, need_dx, need_dw))
        return _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw)

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", _emu_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    model = create_model("cheby", **SMALL)
    x = torch.from_numpy(cheby_inputs(np.random.default_rng(48), (3, 1, 28, 28)))
    model(x).square().sum().backward()
    assert _launched() == {"chebykan": 1, "cheby_qkv_grouped": 2,
                           "chebykan_bwd": 1, "cheby_qkv_grouped_bwd": 2,
                           "flash_attention_lanes": 2,
                           "flash_attention_lanes_bwd": 2}
    assert ("chebykan_bwd", False, True) in needs
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())


# --- the train step against kanvit's ------------------------------------------

@pytest.fixture(scope="module")
def cheby_steps():
    return run_steps("cheby", SMALL, seed=49)


def test_cheby_train_step_losses_match_kanvit(cheby_steps):
    check_losses(cheby_steps)


def test_cheby_train_step_grads_match_kanvit(cheby_steps):
    check_grads(cheby_steps)


def test_cheby_train_step_params_match_kanvit(cheby_steps):
    check_params(cheby_steps)
    assert math.isfinite(cheby_steps["tlosses"][-1])
