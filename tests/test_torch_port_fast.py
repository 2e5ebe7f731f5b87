"""The port's FastKAN (``fast``) slice against kanvit and the reference.

- ``fastkan`` and ``fastkan_qkv_grouped`` against kanvit's Pallas kernels in
  interpret mode (``dispatch.set_impl("pallas")``), forward and gradients
  (x, the LayerNorm's gamma and beta, the spline and base weights, the base
  bias), to 1e-5, at small ragged shapes: with the LayerNorm and the base
  branch (``_rbf_ln_base_op``, ``_rbf_ln_sg_op``), without the base branch
  (``_rbf_op``) and without the LayerNorm (``_rbf_base_op``). Inputs hold
  rows of one value (the LayerNorm's variance 0) and entries up to |x| = 60
  (silu's sigmoid and the RBF's exp saturate). The gradient tests run
  through autograd of the plain version and through the CUDA path's
  Function with each launch emulated on the CPU (``kernel_math``).
- The executed-reference goldens (``layer_fastkan``, ``msa_fast``,
  ``model_fast``).
- ``FastKANLayer`` and the fast ViT against kanvit's ``apply`` on the same
  weights, the converter against ``torch_compat`` byte for byte, the init
  distributions, and 3 train steps against kanvit's step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import load_golden
from kanvit.kernels import fused_basis as JFB
from kanvit.layers.kan import FastKANLayer as JFastKANLayer
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA, FastKANLayer
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import (
    _close_grads,
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
GRID = np.asarray(jnp.linspace(-2.0, 2.0, 8))  # kanvit's FastKAN centres
DEN = 4.0 / 7.0


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


# --- the RBF kernels' arithmetic, emulated on the CPU --------------------------

def _rbf_basis(xg, w, gamma, beta, grid, denominator, stats):
    """``(basis (N, G, nin, S), ln, x-hat)`` as the kernels compute them:
    LN(x) from the saved (mean, rstd), u = (LN(x) - c) * (1/h), exp(-u^2),
    then silu of the raw x for a 9-slice weight."""
    if gamma is None:
        xh = ln = xg
    else:
        xh = (xg - stats[..., :1]) * stats[..., 1:]
        ln = xh * gamma + beta
    u = (ln.unsqueeze(-1) - grid) * (1.0 / denominator)
    basis = torch.exp(-u * u)
    if w.shape[1] > FB.RBF_GRIDS:
        basis = torch.cat([basis, F.silu(xg).unsqueeze(-1)], -1)
    return basis, u, xh


def _emu_rbf_fwd(name, x2d, w, gamma, beta, grid, denominator):
    FB.check_rbf_args(x2d, w, gamma, beta, grid)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    xg = x2d.reshape(n, groups, nin)
    stats = None
    if gamma is not None:
        mean = xg.mean(-1)
        rstd = 1.0 / torch.sqrt((xg - mean.unsqueeze(-1)).square().mean(-1) + 1e-5)
        stats = torch.stack([mean, rstd], -1)
    basis, _, _ = _rbf_basis(xg, w, gamma, beta, grid, denominator, stats)
    FB.LAUNCHES[name] += 1
    return torch.einsum("ngis,gsio->ngo", basis, w).reshape(n, groups * out), stats


def _emu_rbf_bwd(name, x2d, w, gamma, beta, grid, denominator, stats, gy,
                 need_dx, need_dw):
    """dln = sum_k gW_k (-2u_k/h) b_k through the LayerNorm's VJP, the silu
    term gW_8 silu'(x) added after it; dgamma, dbeta column sums."""
    FB.check_rbf_args(x2d, w, gamma, beta, grid)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    xg = x2d.reshape(n, groups, nin)
    basis, u, xh = _rbf_basis(xg, w, gamma, beta, grid, denominator, stats)
    gyg = gy.reshape(n, groups, out)
    gw = torch.einsum("ngo,gsio->ngis", gyg, w)
    ng = FB.RBF_GRIDS
    dln = (gw[..., :ng] * (-2.0 / denominator) * u * basis[..., :ng]).sum(-1)
    dsilu = 0.0
    if w.shape[1] > ng:
        sig = torch.sigmoid(xg)
        dsilu = gw[..., ng] * (sig + xg * sig * (1 - sig))
    dgamma = dbeta = None
    if gamma is None:
        dx = dln + dsilu
    else:
        dxh = dln * gamma
        m1 = dxh.mean(-1, keepdim=True)
        m2 = (dxh * xh).mean(-1, keepdim=True)
        dx = stats[..., 1:] * (dxh - m1 - xh * m2) + dsilu
        dgamma, dbeta = (dln * xh).sum(0), dln.sum(0)
    dw = torch.einsum("ngis,ngo->gsio", basis, gyg)
    FB.LAUNCHES[name] += 1
    return (dx.reshape(n, -1) if need_dx else None), (dw if need_dw else None), \
        dgamma, dbeta


def _use_emulations(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_rbf", _emu_rbf_fwd)
    monkeypatch.setattr(FB, "_launch_rbf_bwd", _emu_rbf_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)


@pytest.fixture(params=["plain", "kernel_math"])
def grad_path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: the CUDA path's Functions
    with each launch emulated on the CPU."""
    if request.param == "kernel_math":
        _use_emulations(monkeypatch)
    return request.param


_JAX = {}


def _jax_grads_once(key, fn, arrays, g):
    """kanvit's output and gradients, computed once for both grad paths."""
    if key not in _JAX:
        _JAX[key] = _jax_grads(fn, arrays, g)
    return _JAX[key]


def _launched():
    return {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}


def fast_inputs(rng, shape):
    """Normal inputs (std 1.5); every 9th entry at |x| in [20, 60]; the first
    row of one value (0.5, summed exactly), where the LayerNorm's variance
    is 0 and its rstd 1/sqrt(1e-5)."""
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    flat[4::9] = (rng.uniform(20.0, 60.0, flat[4::9].size)
                  * rng.choice([-1.0, 1.0], flat[4::9].size)).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.5
    return x


def fast_params(rng, nout, nin, lead=()):
    """gamma, beta, spline_weight (out, in*8), base_weight, base_bias."""
    return ((1.0 + 0.1 * rng.standard_normal((*lead, nin))).astype(np.float32),
            (0.1 * rng.standard_normal((*lead, nin))).astype(np.float32),
            (0.1 * rng.standard_normal((*lead, nout, nin * 8))).astype(np.float32),
            (0.3 * rng.standard_normal((*lead, nout, nin))).astype(np.float32),
            (0.1 * rng.standard_normal((*lead, nout))).astype(np.float32))


VARIANTS = {
    # which of (gamma, beta, sw, bw, bb) are given; kanvit's tier
    "ln_base": (True, True),    # _rbf_ln_base_op: LN and silu in the kernel
    "no_base": (True, False),   # _rbf_op: LN outside, no silu slice
    "no_ln": (False, True),     # _rbf_base_op: time_benchmark, LN skipped
}


def _layer_fn(fb, variant, grid):
    ln, base = VARIANTS[variant]

    def fn(x, ga, be, sw, bw, bb):
        return fb(x, ga if ln else None, be if ln else None, grid, DEN, sw,
                  bw if base else None, bb if base else None)
    return fn


def _used(variant, arrays):
    """The arrays a variant differentiates: x and the parameters it has."""
    ln, base = VARIANTS[variant]
    keep = (True, ln, ln, True, base, base)
    return [a for a, k in zip(arrays, keep) if k]


def _variant_fn(fb, variant, grid):
    ln, base = VARIANTS[variant]
    full = _layer_fn(fb, variant, grid)

    def fn(*a):
        it = iter(a)
        x = next(it)
        ga, be = (next(it), next(it)) if ln else (None, None)
        sw = next(it)
        bw, bb = (next(it), next(it)) if base else (None, None)
        return full(x, ga, be, sw, bw, bb)
    return fn


# --- the basis ----------------------------------------------------------------

def test_rbf_bases_and_layernorm_match_kanvit():
    rng = np.random.default_rng(70)
    x = fast_inputs(rng, (40, 6))
    gamma, beta = fast_params(rng, 3, 6)[:2]
    b, db = K.rbf_bases_and_grad(torch.from_numpy(x), torch.from_numpy(GRID), DEN)
    jb, jdb = JK.rbf_bases_and_grad(jnp.asarray(x), jnp.asarray(GRID), DEN)
    assert b.shape == (40, 6, 8)
    assert _maxdiff(b, jb) <= TOL and _maxdiff(db, jdb) <= TOL
    assert _maxdiff(K.rbf_bases(torch.from_numpy(x), torch.from_numpy(GRID), DEN),
                    jb) <= TOL
    ln = K.layernorm(*map(torch.from_numpy, (x, gamma, beta)))
    assert _maxdiff(ln, JK.layernorm(*map(jnp.asarray, (x, gamma, beta)))) <= TOL
    # the reference's centres bit for bit, kanvit's to 6 ulp
    centres = FastKANLayer(4, 3).rbf_grid.numpy()
    np.testing.assert_array_equal(centres, load_golden("layer_fastkan")[1]["rbf.grid"])
    assert _maxdiff(centres, GRID) <= 1e-6


# --- the kernel wrappers against kanvit's Pallas kernels -------------------------

@pytest.mark.parametrize("variant,n,nin,nout,lead", [
    ("ln_base", 37, 16, 8, ()), ("ln_base", 20, 24, 12, (2,)),
    ("no_base", 37, 16, 8, ()), ("no_ln", 21, 12, 10, ())])
def test_fastkan_matches_pallas(variant, n, nin, nout, lead):
    rng = np.random.default_rng(71)
    x = fast_inputs(rng, (*lead, n, nin))
    params = fast_params(rng, nout, nin)
    want = _layer_fn(JFB.fastkan, variant, jnp.asarray(GRID))(
        jnp.asarray(x), *map(jnp.asarray, params))
    with torch.inference_mode():
        got = _layer_fn(FB.fastkan, variant, torch.from_numpy(GRID))(
            torch.from_numpy(x), *map(torch.from_numpy, params))
    assert got.shape == (*lead, n, nout)
    assert _maxdiff(got, want) <= TOL * max(1.0, float(np.abs(want).max()))
    assert _launched() == {}


@pytest.mark.parametrize("variant,n,nin,nout", [
    ("ln_base", 37, 16, 8), ("no_base", 20, 24, 12), ("no_ln", 21, 12, 10)])
def test_fastkan_grads_match_pallas(grad_path, variant, n, nin, nout):
    rng = np.random.default_rng(72)
    x = fast_inputs(rng, (n, nin))
    arrays = _used(variant, (x, *fast_params(rng, nout, nin)))
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads_once(
        (variant, n, nin, nout),
        _variant_fn(JFB.fastkan, variant, jnp.asarray(GRID)), arrays, g)
    got_y, got = _torch_grads(
        _variant_fn(FB.fastkan, variant, torch.from_numpy(GRID)), arrays, g)
    assert _maxdiff(got_y, want_y) <= TOL * max(1.0, float(np.abs(want_y).max()))
    _close_grads(got, want)
    assert _launched() == ({} if grad_path == "plain"
                           else {"fastkan": 1, "fastkan_bwd": 1})


@pytest.mark.parametrize("n,h,dh", [(20, 2, 16), (13, 3, 32)])
def test_fastkan_qkv_grouped_matches_pallas(grad_path, n, h, dh):
    """Forward and gradients of one grouped projection; kanvit's slot-grouped
    tier must have run (it returns None where it does not apply)."""
    rng = np.random.default_rng(73)
    x2d = fast_inputs(rng, (n, h * dh))
    params = fast_params(rng, dh, dh, (h,))
    g = rng.standard_normal((n, h * dh)).astype(np.float32)
    jgrid = jnp.asarray(GRID)
    assert JFB.fastkan_qkv_grouped(jnp.asarray(x2d), *map(jnp.asarray, params[:2]),
                                   jgrid, DEN, *map(jnp.asarray, params[2:])) is not None
    want_y, want = _jax_grads_once(
        (n, h, dh),
        lambda x, ga, be, *w: JFB.fastkan_qkv_grouped(x, ga, be, jgrid, DEN, *w),
        (x2d, *params), g)
    tgrid = torch.from_numpy(GRID)
    got_y, got = _torch_grads(
        lambda x, ga, be, *w: FB.fastkan_qkv_grouped(x, ga, be, tgrid, DEN, *w),
        (x2d, *params), g)
    assert got_y.shape == (n, h * dh)
    assert _maxdiff(got_y, want_y) <= TOL * max(1.0, float(np.abs(want_y).max()))
    _close_grads(got, want)
    assert _launched() == ({} if grad_path == "plain" else
                           {"fastkan_qkv_grouped": 1, "fastkan_qkv_grouped_bwd": 1})


# --- packing and argument checks -------------------------------------------------

def test_packed_fastkan_weight_layout():
    """Slices 0..7 weight the RBF of LN(x), slice 8 silu(x): the packed
    contraction gives back the plain forward (no bias), one head or many."""
    rng = np.random.default_rng(74)
    x = torch.from_numpy(fast_inputs(rng, (11, 6)))
    ga, be, sw, bw, _ = map(torch.from_numpy, fast_params(rng, 5, 6))
    grid = torch.from_numpy(GRID)
    w = FB.pack_fastkan_weight(sw, bw, 8)
    assert w.shape == (9, 6, 5)
    basis = torch.cat([K.rbf_bases(K.layernorm(x, ga, be), grid, DEN),
                       F.silu(x).unsqueeze(-1)], -1)
    want = K.fastkan_forward(x, ga, be, grid, DEN, sw, bw, torch.zeros(5))
    assert _maxdiff(torch.einsum("nis,sio->no", basis, w), want) <= TOL
    assert FB.pack_fastkan_weight(sw, None, 8).shape == (8, 6, 5)
    hw = FB.pack_fastkan_qkv_weight(sw[None].expand(3, -1, -1), bw[None].expand(3, -1, -1), 8)
    assert hw.shape == (3, 9, 6, 5) and torch.equal(hw[2], w)


@pytest.mark.parametrize("bad,err,match", [
    ("centres", ValueError, "8 RBF centres"),
    ("slices", ValueError, "packed weight must be"),
    ("x64", TypeError, "x must be float32"),
    ("gamma", ValueError, "gamma must be contiguous"),
    ("beta_only", ValueError, "both given or both None"),
])
def test_rbf_kernel_arg_checks(bad, err, match):
    x, w = torch.zeros(10, 32), torch.zeros(2, 9, 16, 4)
    gamma = beta = torch.ones(2, 16)
    grid = torch.from_numpy(GRID)
    if bad == "centres":
        grid = torch.zeros(7)
    elif bad == "slices":
        w = torch.zeros(2, 10, 16, 4)
    elif bad == "x64":
        x = x.double()
    elif bad == "gamma":
        gamma = torch.ones(16)
    elif bad == "beta_only":
        gamma = None
    with pytest.raises(err, match=match):
        FB.check_rbf_args(x, w, gamma, beta, grid)
    FB.check_rbf_args(torch.zeros(10, 32), torch.zeros(2, 8, 16, 4), None, None,
                      torch.from_numpy(GRID))


# --- layers and model ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["2", "3"])
def test_fastkan_golden(case):
    g, sd = load_golden("layer_fastkan")
    layer = FastKANLayer(16, 8)
    load_reference_state_dict(layer, sd)
    with torch.inference_mode():
        got = layer(torch.from_numpy(g[f"x{case}"]))
    assert _maxdiff(got, g[f"y{case}"]) <= TOL


def test_msa_fast_golden():
    g, sd = load_golden("msa_fast")
    msa = MSA(16, n_heads=2, type="fast")
    load_reference_state_dict(msa, sd)
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(g["x"])), g["y"]) <= TOL


def test_model_fast_golden():
    g, sd = load_golden("model_fast")
    model = create_model("fast", **MNIST)
    load_reference_state_dict(model, sd)
    with torch.inference_mode():
        assert _maxdiff(model(torch.from_numpy(g["x"])), g["y"]) <= LOGIT_TOL


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mnist_fast():
    x = np.random.default_rng(75).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(_numpy_sd(create_model("fast", **MNIST, seed=1))), x


def test_fast_model_matches_kanvit_apply(mnist_fast):
    params, x = mnist_fast
    want = np.asarray(jax.jit(j_create_model("fast", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("fast", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_fast_converter_matches_torch_compat_bytes(mnist_fast):
    """kanvit's FastKAN leaves take the reference's submodule names, told
    apart from KANLinear's bare ones by the ``ln_weight`` sibling; every
    leaf is carried byte for byte, and the reference's ``rbf.grid`` buffer
    is skipped on load."""
    params, _ = mnist_fast
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    assert got["linear_mapper.spline_linear.weight"].shape == (64, 128)
    assert "blocks.1.attn.v_mappings.1.layernorm.bias" in got
    layer = FastKANLayer(16, 8)
    load_reference_state_dict(layer, {**_numpy_sd(layer), "rbf.grid": GRID})


def test_fastkan_init_matches_kanvit_distribution():
    """LayerNorm ones and zeros; spline weight trunc-normal std 0.1; the
    base branch nn.Linear's kaiming-uniform weight and U(+-1/sqrt(in))
    bias; no base branch without ``use_base_update``."""
    nin, nout = 48, 40
    jp = JFastKANLayer(nin, nout).init(jax.random.PRNGKey(7),
                                       jnp.zeros((2, nin)))["params"]
    layer = FastKANLayer(nin, nout, generator=torch.Generator().manual_seed(7))
    tp = {"ln_weight": layer.layernorm.weight, "ln_bias": layer.layernorm.bias,
          "spline_weight": layer.spline_linear.weight,
          "base_weight": layer.base_linear.weight, "base_bias": layer.base_linear.bias}
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / nin)
    for params in (jax.tree.map(np.asarray, jp), {k: v.detach().numpy() for k, v in tp.items()}):
        assert np.all(params["ln_weight"] == 1) and np.all(params["ln_bias"] == 0)
        sw = params["spline_weight"]
        assert sw.shape == (nout, nin * 8) and np.abs(sw).max() <= 2.0
        assert abs(sw.std() - 0.1) < 0.005 and abs(sw.mean()) < 0.005
        assert np.abs(params["base_weight"]).max() <= bound
        assert abs(params["base_weight"].std() - bound / math.sqrt(3.0)) < 0.05 * bound
        assert np.abs(params["base_bias"]).max() <= 1.0 / math.sqrt(nin)
    assert FastKANLayer(4, 3, use_base_update=False).base_linear is None


def test_fast_model_gradients_take_the_function_path(monkeypatch):
    """The fast ViT launches one RBF kernel for the embedder, three grouped
    ones a block (q, k, v) and the lanes attention per block; the
    embedder's backward computes no dx (its dln pass still runs for dgamma
    and dbeta)."""
    needs = []

    def emu_bwd(name, *args):
        needs.append((name, *args[-2:]))
        return _emu_rbf_bwd(name, *args)

    _use_emulations(monkeypatch)
    monkeypatch.setattr(FB, "_launch_rbf_bwd", emu_bwd)
    model = create_model("fast", **SMALL)
    x = torch.from_numpy(np.random.default_rng(76).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert _launched() == {"fastkan": 1, "fastkan_bwd": 1,
                           "fastkan_qkv_grouped": 6, "fastkan_qkv_grouped_bwd": 6,
                           "flash_attention_lanes": 2,
                           "flash_attention_lanes_bwd": 2}
    assert ("fastkan_bwd", False, True) in needs
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())
    assert float(model.linear_mapper.layernorm.weight.grad.abs().max()) > 0


# --- the train step against kanvit's -------------------------------------------------

@pytest.fixture(scope="module")
def fast_steps():
    return run_steps("fast", SMALL, seed=77)


# FastKAN's Gaussian tails exp(-u^2) give gradients over more than six
# decades, many of them within 10x of Adam's eps, where the first update
# carries the gradient's rounding error over in full: those are left out
# (g_floor 1e-7, 10x eps), and 96% of the elements remain held (95% asked).
FAST_G_FLOOR, FAST_MIN_RESOLVED = 1e-7, 0.95


def test_fast_train_step_losses_match_kanvit(fast_steps):
    check_losses(fast_steps)


def test_fast_train_step_grads_match_kanvit(fast_steps):
    check_grads(fast_steps)


def test_fast_train_step_params_match_kanvit(fast_steps):
    check_params(fast_steps, g_floor=FAST_G_FLOOR, min_resolved=FAST_MIN_RESOLVED)
