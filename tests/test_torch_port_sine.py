"""The port's SineKAN (``sine``) slice against kanvit and the reference.

- ``sinekan`` and ``sinekan_qkv_grouped`` against kanvit's Pallas kernels in
  interpret mode (``dispatch.set_impl("pallas")``), forward and gradients
  (x, freq, amplitudes, bias), to 1e-5, at small ragged shapes and grid
  sizes 4, 5 and 28, inputs up to |x| = 20 (arguments of several pi). The
  gradient tests run through autograd of the plain version and through the
  CUDA path's Function with each launch emulated on the CPU
  (``kernel_math``).
- The executed-reference goldens (``layer_sinekan``, ``msa_sine``,
  ``model_sine``) and the phase table.
- ``SineKANLayer`` and the sine ViT against kanvit's ``apply`` on the same
  weights, the converter against ``torch_compat`` byte for byte, the init
  distributions, and 3 train steps against kanvit's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.kernels import fused_basis as JFB
from kanvit.layers.kan import SineKANLayer as JSineKANLayer
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA, SineKANLayer
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


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


# --- the sine kernels' arithmetic, emulated on the CPU --------------------------

def _sine_args(x2d, w, freq2d, phase):
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    xg = x2d.reshape(n, groups, nin)
    return xg, xg.unsqueeze(-1) * freq2d[:, None, :] + phase  # (N, G, nin, S)


def _emu_sine_fwd(name, x2d, w, freq2d, phase):
    FB.check_sine_args(x2d, w, freq2d, phase)
    _, arg = _sine_args(x2d, w, freq2d, phase)
    FB.LAUNCHES[name] += 1
    return torch.einsum("ngis,gsio->ngo", torch.sin(arg), w).reshape(x2d.shape[0], -1)


def _emu_sine_bwd(name, x2d, w, freq2d, phase, gy, need_dx, need_dw):
    """dx = sum_s gW_s freq_s cos(arg_s), dfreq_s = sum gW_s x cos(arg_s)
    over rows and features, dW = sin(arg)^T gy."""
    FB.check_sine_args(x2d, w, freq2d, phase)
    n = x2d.shape[0]
    xg, arg = _sine_args(x2d, w, freq2d, phase)
    gyg = gy.reshape(n, w.shape[0], -1)
    gw = torch.einsum("ngo,gsio->ngis", gyg, w)
    cos = torch.cos(arg)
    dx = (gw * freq2d[:, None, :] * cos).sum(-1).reshape(n, -1)
    dfreq = (gw * xg.unsqueeze(-1) * cos).sum((0, 2))
    dw = torch.einsum("ngis,ngo->gsio", torch.sin(arg), gyg)
    FB.LAUNCHES[name] += 1
    return (dx if need_dx else None), (dw if need_dw else None), dfreq


def _use_emulations(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_sine", _emu_sine_fwd)
    monkeypatch.setattr(FB, "_launch_sine_bwd", _emu_sine_bwd)
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


def sine_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-20, 20]."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-20.0, 20.0, flat[::7].size).astype(np.float32)
    return x


def sine_params(rng, nout, nin, grid_size, lead=()):
    """freq (k / (G+1) plus noise), amplitudes, bias."""
    freq = (np.arange(1, grid_size + 1) / (grid_size + 1)
            + 0.05 * rng.standard_normal((*lead, grid_size))).astype(np.float32)
    amps = (rng.uniform(-1.0, 1.0, (*lead, nout, nin, grid_size))
            / nout).astype(np.float32)
    return freq, amps, (rng.standard_normal((*lead, nout)) * 0.1).astype(np.float32)


# --- the basis ----------------------------------------------------------------

@pytest.mark.parametrize("nin,grid_size", [(16, 4), (7, 28)])
def test_sine_bases_and_phase_match_kanvit(nin, grid_size):
    """The phase table bit for bit, the bases and both derivatives."""
    phase = K.sinekan_phase_init(nin, grid_size)
    np.testing.assert_array_equal(phase.numpy(),
                                  np.asarray(JK.sinekan_phase_init(nin, grid_size)))
    rng = np.random.default_rng(80)
    x = sine_inputs(rng, (30, nin))
    freq = sine_params(rng, 3, nin, grid_size)[0]
    got = K.sine_bases_and_grad(torch.from_numpy(x), torch.from_numpy(freq), phase)
    want = JK.sine_bases_and_grad(jnp.asarray(x), jnp.asarray(freq),
                                  jnp.asarray(phase.numpy()))
    assert got[0].shape == (30, nin, grid_size)
    for a, b in zip(got, want):
        assert _maxdiff(a, b) <= TOL * max(1.0, float(np.abs(b).max()))
    assert _maxdiff(K.sine_bases(torch.from_numpy(x), torch.from_numpy(freq), phase),
                    want[0]) <= TOL


# --- the kernel wrappers against kanvit's Pallas kernels -------------------------

@pytest.mark.parametrize("grid_size,n,nin,nout,lead,bias", [
    (5, 37, 16, 8, (), "row"), (4, 20, 24, 12, (2,), None),
    (28, 9, 12, 70, (3,), "out")])
def test_sinekan_matches_pallas(grid_size, n, nin, nout, lead, bias):
    rng = np.random.default_rng(81)
    x = sine_inputs(rng, (*lead, n, nin))
    freq, amps, b = sine_params(rng, nout, nin, grid_size)
    phase = K.sinekan_phase_init(nin, grid_size)
    want = JFB.sinekan(jnp.asarray(x), jnp.asarray(freq), jnp.asarray(phase.numpy()),
                       jnp.asarray(amps), None if bias is None else jnp.asarray(b))
    tb = None if bias is None else torch.from_numpy(b)
    if bias == "row":
        tb = tb.reshape(1, nout)  # the reference's (1, out) bias
    with torch.inference_mode():
        got = FB.sinekan(torch.from_numpy(x), torch.from_numpy(freq).reshape(1, 1, 1, -1),
                         phase, torch.from_numpy(amps), tb)
    assert got.shape == (*lead, n, nout)
    assert _maxdiff(got, want) <= TOL * max(1.0, float(np.abs(want).max()))
    assert _launched() == {}


@pytest.mark.parametrize("grid_size,n,nin,nout", [(5, 37, 16, 8), (28, 20, 12, 24)])
def test_sinekan_grads_match_pallas(grad_path, grid_size, n, nin, nout):
    """dx, dfreq, damplitudes and dbias."""
    rng = np.random.default_rng(82)
    x = sine_inputs(rng, (n, nin))
    params = sine_params(rng, nout, nin, grid_size)
    phase = K.sinekan_phase_init(nin, grid_size)
    jphase = jnp.asarray(phase.numpy())
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads_once(
        (grid_size, n, nin, nout),
        lambda x, f, a, b: JFB.sinekan(x, f, jphase, a, b), (x, *params), g)
    got_y, got = _torch_grads(lambda x, f, a, b: FB.sinekan(x, f, phase, a, b),
                              (x, *params), g)
    assert _maxdiff(got_y, want_y) <= TOL * max(1.0, float(np.abs(want_y).max()))
    _close_grads(got, want)
    assert _launched() == ({} if grad_path == "plain"
                           else {"sinekan": 1, "sinekan_bwd": 1})


@pytest.mark.parametrize("n,h,dh,bias", [(20, 2, 16, True), (13, 3, 32, False)])
def test_sinekan_qkv_grouped_matches_pallas(grad_path, n, h, dh, bias):
    """Forward and gradients of one grouped projection (grid 4, a freq per
    head); kanvit's slot-grouped tier must have run (it returns None where
    it does not apply)."""
    rng = np.random.default_rng(83)
    x2d = sine_inputs(rng, (n, h * dh))
    freq, amps, b = sine_params(rng, dh, dh, 4, (h,))
    arrays = (x2d, freq, amps, b) if bias else (x2d, freq, amps)
    phase = K.sinekan_phase_init(dh, 4)
    jphase = jnp.asarray(phase.numpy())
    g = rng.standard_normal((n, h * dh)).astype(np.float32)

    def jfn(x, f, a, *bb):
        return JFB.sinekan_qkv_grouped(x, f, jphase, a, bb[0] if bb else None)

    assert jfn(*map(jnp.asarray, arrays)) is not None
    want_y, want = _jax_grads_once((n, h, dh, bias), jfn, arrays, g)
    got_y, got = _torch_grads(
        lambda x, f, a, *bb: FB.sinekan_qkv_grouped(x, f, phase, a,
                                                    bb[0] if bb else None),
        arrays, g)
    assert got_y.shape == (n, h * dh)
    assert _maxdiff(got_y, want_y) <= TOL * max(1.0, float(np.abs(want_y).max()))
    _close_grads(got, want)
    assert _launched() == ({} if grad_path == "plain" else
                           {"sinekan_qkv_grouped": 1, "sinekan_qkv_grouped_bwd": 1})


# --- packing and argument checks -------------------------------------------------

def test_packed_sine_weight_layout():
    """Slice s weights sin(x freq_s + phase_s): the packed contraction gives
    back the plain forward (no bias), one head or many."""
    rng = np.random.default_rng(84)
    x = torch.from_numpy(sine_inputs(rng, (11, 6)))
    freq, amps, _ = map(torch.from_numpy, sine_params(rng, 5, 6, 7))
    phase = K.sinekan_phase_init(6, 7)
    w = FB.pack_sine_weight(amps)
    assert w.shape == (1, 7, 6, 5)
    got = torch.einsum("nis,sio->no", K.sine_bases(x, freq, phase), w[0])
    assert _maxdiff(got, K.sinekan_forward(x, freq, phase, amps, None)) <= TOL
    hw = FB.pack_sine_qkv_weight(amps[None].expand(3, -1, -1, -1))
    assert hw.shape == (3, 7, 6, 5) and torch.equal(hw[1], w[0])


@pytest.mark.parametrize("bad,err,match", [
    ("freq", ValueError, "freq must be contiguous"),
    ("phase", ValueError, "phase must be contiguous"),
    ("x64", TypeError, "x must be float32"),
    ("wdim", ValueError, "packed weight must be"),
    ("features", ValueError, "dW kernel's launch grid"),
])
def test_sine_kernel_arg_checks(bad, err, match):
    x, w = torch.zeros(10, 32), torch.zeros(2, 5, 16, 4)
    freq, phase = torch.zeros(2, 5), torch.zeros(16, 5)
    if bad == "freq":
        freq = torch.zeros(1, 5)
    elif bad == "phase":
        phase = torch.zeros(5, 16).T
    elif bad == "x64":
        x = x.double()
    elif bad == "wdim":
        w = torch.zeros(5, 16, 4)
    elif bad == "features":
        nin = FB.DW_TILE[0] * 65535 + 1
        x, w = torch.zeros(2, nin), torch.zeros(1, 1, nin, 1)
        freq, phase = torch.zeros(1, 1), torch.zeros(nin, 1)
    with pytest.raises(err, match=match):
        FB.check_sine_args(x, w, freq, phase)
    FB.check_sine_args(torch.zeros(10, 32), torch.zeros(2, 5, 16, 4),
                       torch.zeros(2, 5), torch.zeros(16, 5))


# --- layers and model ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["2", "3"])
def test_sinekan_golden(case):
    """The reference's (1, 1, in, G) phase buffer is the port's table to a
    few ulp: the reference runs the damping loop in f32, kanvit and the
    port in f64, then round."""
    g, sd = load_golden("layer_sinekan")
    layer = SineKANLayer(16, 8, 4)
    phase = layer.phase.numpy()
    assert _maxdiff(phase, sd["phase"][0, 0]) <= 1e-6 * np.abs(phase).max()
    load_reference_state_dict(layer, sd)
    with torch.inference_mode():
        got = layer(torch.from_numpy(g[f"x{case}"]))
    assert _maxdiff(got, g[f"y{case}"]) <= TOL


def test_msa_sine_golden():
    """The sine MSA projects q/k/v with SineKAN grid 4."""
    g, sd = load_golden("msa_sine")
    msa = MSA(16, n_heads=2, type="sine")
    assert msa.q_mappings[0].grid_size == 4
    load_reference_state_dict(msa, sd)
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(g["x"])), g["y"]) <= TOL


def test_model_sine_golden():
    g, sd = load_golden("model_sine")
    model = create_model("sine", **MNIST)
    assert model.linear_mapper.amplitudes.shape == (64, 16, 28)
    load_reference_state_dict(model, sd)
    with torch.inference_mode():
        assert _maxdiff(model(torch.from_numpy(g["x"])), g["y"]) <= LOGIT_TOL


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mnist_sine():
    x = np.random.default_rng(85).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(_numpy_sd(create_model("sine", **MNIST, seed=1))), x


def test_sine_model_matches_kanvit_apply(mnist_sine):
    params, x = mnist_sine
    assert params["linear_mapper"]["freq"].shape == (28,)
    want = np.asarray(jax.jit(j_create_model("sine", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("sine", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_sine_converter_matches_torch_compat_bytes(mnist_sine):
    """kanvit's (G,) freq becomes the reference's (1, 1, 1, G) and its (out,)
    SineKAN bias (1, out), told apart from a Linear bias by the ``freq``
    sibling; every leaf is carried byte for byte, and the reference's
    ``phase`` buffer is skipped on load."""
    params, _ = mnist_sine
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    assert got["linear_mapper.freq"].shape == (1, 1, 1, 28)
    assert got["blocks.0.attn.k_mappings.1.bias"].shape == (1, 32)
    assert got["blocks.0.ff.0.bias"].shape == (256,)
    layer = SineKANLayer(16, 8, 4)
    load_reference_state_dict(layer, {**_numpy_sd(layer),
                                      "phase": np.zeros((1, 1, 16, 4), np.float32)})


@pytest.mark.parametrize("is_first", [False, True])
def test_sinekan_init_matches_kanvit_distribution(is_first):
    """One draw per (out, in) broadcast over the grid and divided by out * k
    (U(-1, 1), or normal * 0.4 for a first layer); freq k / (G+1) (k for a
    first layer); bias 1/out."""
    nin, nout, grid_size = 48, 40, 5
    jp = jax.tree.map(np.asarray, JSineKANLayer(nin, nout, grid_size, is_first=is_first)
                      .init(jax.random.PRNGKey(8), jnp.zeros((2, nin)))["params"])
    layer = SineKANLayer(nin, nout, grid_size, is_first=is_first,
                         generator=torch.Generator().manual_seed(8))
    tp = {k: v.detach().numpy() for k, v in layer.named_parameters()}
    k = np.arange(1, grid_size + 1)
    np.testing.assert_allclose(tp["freq"].reshape(-1), jp["freq"], rtol=1e-7)
    np.testing.assert_allclose(tp["bias"].reshape(-1), jp["bias"], rtol=1e-7)
    for amps in (jp["amplitudes"], tp["amplitudes"]):
        base = amps * nout * k  # the one draw, every harmonic
        assert np.allclose(base, base[..., :1], rtol=1e-5, atol=1e-7)
        if is_first:
            assert abs(base.std() - 0.4) < 0.02
        else:
            assert np.abs(base).max() <= 1.0 and abs(base.std() - 1 / np.sqrt(3)) < 0.02
    assert SineKANLayer(4, 3, add_bias=False).bias is None


def test_sine_model_gradients_take_the_function_path(monkeypatch):
    """The sine ViT launches one sine kernel for the embedder (grid 28),
    three grouped ones a block (grid 4) and the lanes attention per block;
    the embedder's backward computes no dx but dfreq."""
    needs = []

    def emu_bwd(name, *args):
        needs.append((name, *args[-2:]))
        return _emu_sine_bwd(name, *args)

    _use_emulations(monkeypatch)
    monkeypatch.setattr(FB, "_launch_sine_bwd", emu_bwd)
    model = create_model("sine", **SMALL)
    x = torch.from_numpy(np.random.default_rng(86).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert _launched() == {"sinekan": 1, "sinekan_bwd": 1,
                           "sinekan_qkv_grouped": 6, "sinekan_qkv_grouped_bwd": 6,
                           "flash_attention_lanes": 2,
                           "flash_attention_lanes_bwd": 2}
    assert ("sinekan_bwd", False, True) in needs
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())
    assert float(model.linear_mapper.freq.grad.abs().max()) > 0


# --- the train step against kanvit's -------------------------------------------------

@pytest.fixture(scope="module")
def sine_steps():
    return run_steps("sine", SMALL, seed=57)


def test_sine_train_step_losses_match_kanvit(sine_steps):
    check_losses(sine_steps)


def test_sine_train_step_grads_match_kanvit(sine_steps):
    check_grads(sine_steps)


def test_sine_train_step_params_match_kanvit(sine_steps):
    check_params(sine_steps)
