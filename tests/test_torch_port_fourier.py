"""The port's Fourier (``fourier``) slice against kanvit and the reference.

- ``fourierkan`` against kanvit's Pallas kernels in interpret mode
  (``dispatch.set_impl("pallas")``), forward and gradients, to 1e-5, at
  grid 5 (the layer's default) and 28 (the ViT's patch embedder), inputs up
  to |x| = 10. The gradient tests run through autograd of the plain version
  and through the CUDA path's Function with each launch emulated on the CPU
  (``kernel_math``).
- The executed-reference goldens (``layer_fourierkan``, ``msa_fourier``).
- ``FourierKANLayer`` and the fourier ViT (FourierKAN embedder, per-head
  Linear q/k/v) against kanvit's ``apply`` on the same weights, and 3 train
  steps against kanvit's step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.kernels import fused_basis as JFB
from kanvit.layers.kan import FourierKANLayer as JFourierKANLayer
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA, FourierKANLayer
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


def fourier_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-10, 10]."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-10.0, 10.0, flat[::7].size).astype(np.float32)
    return x


def fourier_params(rng, nout, nin, grid_size):
    coeffs = (rng.standard_normal((2, nout, nin, grid_size))
              / math.sqrt(nin * grid_size)).astype(np.float32)
    return coeffs, (rng.standard_normal(nout) * 0.1).astype(np.float32)


# --- the basis --------------------------------------------------------------

@pytest.mark.parametrize("grid_size", [5, 28])
def test_fourier_bases_match_kanvit(grid_size):
    """The plain bases and derivatives against kanvit's at |x| up to 10."""
    x = fourier_inputs(np.random.default_rng(50), (40, 6))
    b, db = K.fourier_bases_and_grad(torch.from_numpy(x), grid_size)
    jb, jdb = JK.fourier_bases_and_grad(jnp.asarray(x), grid_size)
    assert b.shape == (40, 6, 2 * grid_size)
    assert _maxdiff(b, jb) <= TOL and _maxdiff(db, jdb) <= TOL * grid_size
    assert _maxdiff(K.fourier_bases(torch.from_numpy(x), grid_size), jb) <= TOL


# --- the kernel wrapper against kanvit's Pallas kernels ----------------------

@pytest.mark.parametrize("grid_size,n,nin,nout,lead,bias", [
    (5, 37, 16, 8, (), "out"), (5, 20, 24, 12, (2,), None),
    (28, 37, 16, 24, (), "row"), (28, 9, 12, 70, (3,), "out")])
def test_fourierkan_matches_pallas(grid_size, n, nin, nout, lead, bias):
    rng = np.random.default_rng(51)
    x = fourier_inputs(rng, (*lead, n, nin))
    coeffs, b = fourier_params(rng, nout, nin, grid_size)
    want = JFB.fourierkan(jnp.asarray(x), jnp.asarray(coeffs),
                          None if bias is None else jnp.asarray(b))
    tb = None if bias is None else torch.from_numpy(b)
    if bias == "row":
        tb = tb.reshape(1, nout)  # the reference's (1, out) bias
    with torch.inference_mode():
        got = FB.fourierkan(torch.from_numpy(x), torch.from_numpy(coeffs), tb)
    assert got.shape == (*lead, n, nout)
    assert _maxdiff(got, want) <= TOL * max(1.0, float(np.abs(want).max()))
    assert _launched() == {}


@pytest.mark.parametrize("grid_size,n,nin,nout", [(5, 37, 16, 8), (28, 20, 12, 24)])
def test_fourierkan_grads_match_pallas(grad_path, grid_size, n, nin, nout):
    rng = np.random.default_rng(52)
    x = fourier_inputs(rng, (n, nin))
    coeffs, b = fourier_params(rng, nout, nin, grid_size)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads(JFB.fourierkan, (x, coeffs, b), g)
    got_y, got = _torch_grads(FB.fourierkan, (x, coeffs, b), g)
    assert _maxdiff(got_y, want_y) <= TOL * max(1.0, float(np.abs(want_y).max()))
    _close_grads(got, want)
    if grad_path == "kernel_math":
        assert _launched() == {"fourierkan": 1, "fourierkan_bwd": 1}
    else:
        assert _launched() == {}


# --- packing and argument checks ---------------------------------------------

def test_packed_fourier_weight_layout():
    """Slices 0..G-1 weight cos(kx), G..2G-1 sin(kx): the packed contraction
    gives back the plain forward (no bias)."""
    rng = np.random.default_rng(53)
    x = torch.from_numpy(fourier_inputs(rng, (11, 6)))
    coeffs = torch.from_numpy(fourier_params(rng, 5, 6, 7)[0])
    w = FB.pack_fourier_weight(coeffs)
    assert w.shape == (1, 14, 6, 5)
    got = torch.einsum("nis,sio->no", K.fourier_bases(x, 7), w[0])
    assert _maxdiff(got, K.fourierkan_forward(x, coeffs, None)) <= TOL


@pytest.mark.parametrize("bad,err,match", [
    ("grid", ValueError, "grid size must be >= 1"),
    ("slices", ValueError, "does not match packed weight"),
    ("x64", TypeError, "x must be float32"),
    ("wstrided", ValueError, "must be contiguous"),
    ("features", ValueError, "dW kernel's launch grid"),
])
def test_fourier_kernel_arg_checks(bad, err, match):
    x, w, grid_size = torch.zeros(10, 16), torch.zeros(1, 10, 16, 4), 5
    if bad == "grid":
        grid_size = 0
    elif bad == "slices":
        grid_size = 4
    elif bad == "x64":
        x = x.double()
    elif bad == "wstrided":
        w = torch.zeros(1, 10, 4, 16).transpose(2, 3)
    elif bad == "features":
        nin = FB.DW_TILE[0] * 65535 + 1
        x, w, grid_size = torch.zeros(2, nin), torch.zeros(1, 2, nin, 1), 1
    with pytest.raises(err, match=match):
        FB.check_fourier_args(x, w, grid_size)
    FB.check_fourier_args(torch.zeros(10, 16), torch.zeros(1, 56, 16, 4), 28)


# --- layers and model ---------------------------------------------------------

@pytest.mark.parametrize("case", ["2", "3"])
def test_fourierkan_golden(case):
    g, sd = load_golden("layer_fourierkan")
    layer = FourierKANLayer(16, 8, 5)
    load_reference_state_dict(layer, sd)
    with torch.inference_mode():
        got = layer(torch.from_numpy(g[f"x{case}"]))
    assert _maxdiff(got, g[f"y{case}"]) <= TOL


def test_msa_fourier_golden():
    """The fourier variant's MSA projects q/k/v with Linear layers."""
    g, sd = load_golden("msa_fourier")
    msa = MSA(16, n_heads=2, type="fourier")
    load_reference_state_dict(msa, sd)
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(g["x"])), g["y"]) <= TOL


def _numpy_sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mnist_fourier():
    sd = _numpy_sd(create_model("fourier", **MNIST, seed=1))
    sd["linear_mapper.bias"] = np.random.default_rng(54).standard_normal(
        (1, 64)).astype(np.float32) * 0.1  # a nonzero bias
    x = np.random.default_rng(55).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(sd), x


def test_fourier_model_matches_kanvit_apply(mnist_fourier):
    params, x = mnist_fourier
    assert params["linear_mapper"]["bias"].shape == (64,)
    want = np.asarray(jax.jit(j_create_model("fourier", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("fourier", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    assert model.linear_mapper.bias.shape == (1, 64)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_fourier_converter_matches_torch_compat_bytes(mnist_fourier):
    """kanvit's ``(out,)`` FourierKAN bias becomes the reference's
    ``(1, out)``, told apart from a Linear bias by its ``fouriercoeffs``
    sibling; every other leaf is carried byte for byte."""
    params, _ = mnist_fourier
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    assert got["linear_mapper.bias"].shape == (1, 64)
    assert got["blocks.0.attn.q_mappings.0.bias"].shape == (32,)
    back = params_from_torch_state_dict(got)
    np.testing.assert_array_equal(back["linear_mapper"]["bias"],
                                  params["linear_mapper"]["bias"])


@pytest.mark.parametrize("smooth", [False, True])
def test_fourierkan_init_matches_kanvit_distribution(smooth):
    """randn / (sqrt(in) sqrt(G)), or / (sqrt(in) k^2) under smooth init;
    zero bias of the reference's shape."""
    nin, nout, grid_size = 48, 40, 6
    jp = JFourierKANLayer(nin, nout, grid_size, smooth_initialization=smooth).init(
        jax.random.PRNGKey(6), jnp.zeros((2, nin)))["params"]
    layer = FourierKANLayer(nin, nout, grid_size, smooth_initialization=smooth,
                            generator=torch.Generator().manual_seed(6))
    assert layer.bias.shape == (1, nout) and not bool(layer.bias.any())
    k = np.arange(1, grid_size + 1)
    norm = k ** 2.0 if smooth else np.full(grid_size, math.sqrt(grid_size))
    for p in (np.asarray(jp["fouriercoeffs"]), layer.fouriercoeffs.detach().numpy()):
        assert p.shape == (2, nout, nin, grid_size)
        std = p.std(axis=(0, 1, 2))
        assert np.all(np.abs(std * math.sqrt(nin) * norm - 1.0) < 0.08)
    assert FourierKANLayer(4, 3, 5, add_bias=False).bias is None


def test_fourier_model_gradients_take_the_function_path(monkeypatch):
    """The fourier ViT launches one Fourier kernel a forward (the embedder,
    dW only in its backward) and the lanes attention per block; q/k/v are
    plain Linear layers."""
    needs = []

    def emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
        needs.append((name, need_dx, need_dw))
        return _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw)

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", _emu_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    model = create_model("fourier", **SMALL)
    x = torch.from_numpy(np.random.default_rng(56).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert _launched() == {"fourierkan": 1, "fourierkan_bwd": 1,
                           "flash_attention_lanes": 2,
                           "flash_attention_lanes_bwd": 2}
    assert needs == [("fourierkan_bwd", False, True)]
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())


# --- the train step against kanvit's ------------------------------------------

@pytest.fixture(scope="module")
def fourier_steps():
    return run_steps("fourier", SMALL, seed=57)


def test_fourier_train_step_losses_match_kanvit(fourier_steps):
    check_losses(fourier_steps)


def test_fourier_train_step_grads_match_kanvit(fourier_steps):
    check_grads(fourier_steps)


def test_fourier_train_step_params_match_kanvit(fourier_steps):
    check_params(fourier_steps)
