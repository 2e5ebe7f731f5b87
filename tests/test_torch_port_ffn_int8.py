"""The port's fused pre-LN FF and int8 serving against kanvit.

- ``ffn_pre_ln``: the plain version and the ``_FfnFn`` wrapper (each launch
  replaced by a CPU emulation of the kernels' arithmetic, ``kernel_math``)
  against kanvit's Pallas kernel in interpret mode, several row blocks
  (``KANVIT_FF_BN=8``): values within 1e-5 and the seven gradients against
  ``jax.grad`` within 1e-5 x max(1, max|g|); a 2-block ViT with
  ``fused_ff=True`` against kanvit's ``apply`` with ``KANVIT_FF=1`` (logits
  1e-3), and 3 train steps against kanvit's.
- int8: ``_quantize``, ``qdot`` and ``qdot_rowwise`` bit for bit against
  kanvit's; ``int8_linear`` against kanvit's kernel in interpret mode within
  the tie-aware bound of ``tests/test_quant.py``; ``TorchLinear``'s
  dispatch; ``Predictor(quant="int8")`` with and without the kernel and
  calibrated, against kanvit's int8 ``Predictor`` on the same weights and
  scales, and kanvit's own gates against f32; the calibrated scales' keys
  and values; the fused FF staying float under int8 serving.

f32 on the CPU; inputs from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.infer import Predictor as JPredictor
from kanvit.kernels import fused_ffn as JFFN
from kanvit.kernels import int8_matmul as JIM
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.ops import quant as JQ
from kanvit.utils.torch_compat import params_from_torch_state_dict
from kanvit_torch.infer import Predictor
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.kernels import int8_matmul as IM
from kanvit_torch.layers import TorchLinear
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.ops import quant as Q
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    scales_from_jax,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import _emu_lanes_fwd
from test_torch_port_train import check_grads, check_losses, check_params, run_steps

TOL = 1e-5
LOGIT_TOL = 1e-3
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)
# Linears of K and out multiples of 128: an 8x8x2 patch embedder (128 -> 128)
# and the FF pairs (128 -> 512 -> 128) take the int8 kernel, the 10-class
# head takes qdot.
INT8_GEOM = dict(chw=(2, 32, 32), n_patches=4, n_blocks=2, d_hidden=128,
                 n_heads=4, out_d=10)


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FFN.reset_launches()
    IM.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _rel(a, b):
    return _maxdiff(a, b) / max(1.0, float(np.abs(np.asarray(b)).max()))


# --- ffn_pre_ln ---------------------------------------------------------------

def _emu_ln(x2d, gamma, beta):
    mean = x2d.mean(1, keepdim=True)
    xc = x2d - mean
    rstd = 1.0 / torch.sqrt((xc * xc).mean(1, keepdim=True) + 1e-5)
    xhat = xc * rstd
    return xhat, xhat * gamma + beta, rstd


def _emu_ffn_fwd(x2d, gamma, beta, w1, b1, w2, b2):
    """The forward kernel's arithmetic on the CPU: LN (two-pass variance),
    h and its ReLU, the second product, + b2 + x."""
    FFN.check_args(x2d, gamma, beta, w1, b1, w2, b2)
    _, ln, _ = _emu_ln(x2d, gamma, beta)
    r = torch.relu(ln @ w1.T + b1)
    FFN.LAUNCHES["ffn_pre_ln"] += 1
    return x2d + (r @ w2.T + b2)


def _emu_ffn_bwd(x2d, gamma, beta, w1, b1, w2, g):
    """The backward kernels' formulas on the CPU: LN and h recomputed from
    x, then dW2 = g^T r, dh = (g W2)[h > 0], dW1 = dh^T LN, dln = dh W1,
    dgamma, dbeta and dx = g + rstd (gs - mean gs - xhat mean(gs xhat))."""
    xhat, ln, rstd = _emu_ln(x2d, gamma, beta)
    h = ln @ w1.T + b1
    dh = (g @ w2) * (h > 0)
    dln = dh @ w1
    gs = dln * gamma
    dx = g + rstd * (gs - gs.mean(1, keepdim=True)
                     - xhat * (gs * xhat).mean(1, keepdim=True))
    FFN.LAUNCHES["ffn_pre_ln_bwd"] += 1
    return (dx, (dln * xhat).sum(0), dln.sum(0), dh.T @ ln, dh.sum(0),
            g.T @ torch.relu(h), g.sum(0))


@pytest.fixture(params=["plain", "kernel_math"])
def ffn_path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: ``_FfnFn`` with each launch
    emulated on the CPU."""
    if request.param == "kernel_math":
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(FFN, "_launch", _emu_ffn_fwd)
        monkeypatch.setattr(FFN, "_launch_bwd", _emu_ffn_bwd)
    return request.param


def _ffn_arrays(seed, n, d, f):
    rng = np.random.default_rng(seed)
    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.2, 0.3, 0.3, 0.3, 0.3)
    arrays = [(rng.standard_normal(s) * sc).astype(np.float32)
              for s, sc in zip(shapes, scales)]
    arrays[1] += 1.0
    return arrays, rng.standard_normal((n, d)).astype(np.float32)


def test_ffn_pre_ln_plain_matches_kanvit_ops():
    arrays, _ = _ffn_arrays(70, 13, 24, 96)
    want = JK.ffn_pre_ln(*map(jnp.asarray, arrays))
    got = K.ffn_pre_ln(*map(torch.from_numpy, arrays))
    assert _maxdiff(got, want) <= TOL


@pytest.mark.parametrize("n,d,f", [(37, 24, 48), (20, 16, 64)])
def test_ffn_pre_ln_matches_kanvit_kernel(ffn_path, monkeypatch, n, d, f):
    """Values within 1e-5 and all seven gradients within 1e-5 x max(1,
    max|g|) of kanvit's Pallas kernel (interpret mode, 8-row blocks) and
    ``jax.grad`` through it."""
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    arrays, g = _ffn_arrays(71 + n, n, d, f)
    jargs = [jnp.asarray(a) for a in arrays]
    want = JFFN.ffn_pre_ln(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(JFFN.ffn_pre_ln(*a) * g),
                      argnums=tuple(range(7)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = FFN.ffn_pre_ln(*leaves)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert _maxdiff(got.detach(), want) <= TOL
    for name, a, b in zip(("x", "gamma", "beta", "w1", "b1", "w2", "b2"),
                          tgrads, jgrads):
        assert _rel(a, b) <= TOL, name
    want_launches = (1, 1) if ffn_path == "kernel_math" else (0, 0)
    assert (FFN.LAUNCHES["ffn_pre_ln"], FFN.LAUNCHES["ffn_pre_ln_bwd"]) == want_launches


def test_ffn_pre_ln_at_vit_b_width_matches_kanvit_kernel(ffn_path, monkeypatch):
    """vit-b's width (D 768, F 3,072; 9 rows), past the fused route's D 512:
    values within 1e-5 and all seven gradients within 1e-5 x max(1, max|g|)
    of kanvit's Pallas kernel (interpret mode) and ``jax.grad`` through it.
    The weights are scaled by 1/sqrt(fan-in), as a model initialises them,
    so y stays O(1)."""
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    n, d, f = 9, 768, 3072
    arrays, g = _ffn_arrays(78, n, d, f)
    arrays[3] *= np.float32(0.3 / np.sqrt(d))
    arrays[5] *= np.float32(0.3 / np.sqrt(f))
    jargs = [jnp.asarray(a) for a in arrays]
    want = JFFN.ffn_pre_ln(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(JFFN.ffn_pre_ln(*a) * g),
                      argnums=tuple(range(7)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = FFN.ffn_pre_ln(*leaves)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert _maxdiff(got.detach(), want) <= TOL
    for name, a, b in zip(("x", "gamma", "beta", "w1", "b1", "w2", "b2"),
                          tgrads, jgrads):
        assert _rel(a, b) <= TOL, name
    want_launches = (1, 1) if ffn_path == "kernel_math" else (0, 0)
    assert (FFN.LAUNCHES["ffn_pre_ln"], FFN.LAUNCHES["ffn_pre_ln_bwd"]) == want_launches


@pytest.mark.parametrize("bad,err,match", [
    ("dtype", TypeError, "b1 must be float32"),
    ("shape", ValueError, r"w2 must be \(8, 32\)"),
    ("width", ValueError, "D 520"),
])
def test_ffn_kernel_arg_checks(bad, err, match):
    arrays, _ = _ffn_arrays(72, 4, 8, 32)
    args = [torch.from_numpy(a) for a in arrays]
    if bad == "dtype":
        args[4] = args[4].double()
    elif bad == "shape":
        args[5] = args[5].T
    else:  # no hidden unit: every D is taken, F must be at least 1
        args = [torch.from_numpy(a) for a in _ffn_arrays(72, 4, 520, 0)[0]]
    with pytest.raises(err, match=match):
        FFN.check_args(*args)


@pytest.mark.parametrize("d,f", [(768, 3072), (1024, 4096), (2048, 256), (4096, 64)])
def test_ffn_kernel_arg_checks_take_every_width(d, f):
    """vit-b's and vit-l's widths and D past every preset: the fused
    route up to D 512, the tiled route past it."""
    shapes = ((3, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    FFN.check_args(*(torch.empty(s) for s in shapes))
    assert d > FFN.FUSED_MAX_D


def test_ffn_dw_splits_fill_the_card():
    # vit-s: 3 x 12 tiles of 128 x 128, 7 splits: 252 blocks, 2 an SM
    assert FFN.dw_splits(12608, 384, 1536) == 7
    assert FFN.dw_splits(100, 384, 1536) == 1
    assert FFN.dw_splits(10**6, 8, 32) == FFN.DW_TARGET_BLOCKS


def _vit_params(model):
    return params_from_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})


def test_fused_ff_block_at_vit_b_width_matches_kanvit_apply(monkeypatch):
    """A fused-FF ViT block at vit-b's width (D 768, 12 heads of 64, F
    3,072): the logits against kanvit's ``apply`` with ``KANVIT_FF=1``
    (its Pallas ``ffn_pre_ln`` in interpret mode)."""
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    geom = dict(SMALL, n_blocks=1, d_hidden=768, n_heads=12)
    params = _vit_params(create_model("vanilla", **geom, seed=76))
    x = np.random.default_rng(77).standard_normal((2, 1, 28, 28)).astype(np.float32)
    want = j_create_model("vanilla", **geom).apply({"params": params}, jnp.asarray(x))
    model = create_model("vanilla", **geom, seed=1, fused_ff=True)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    assert model.blocks[0].fused_ff and model.blocks[0].ff[0].out_features == 3072
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _maxdiff(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("variant", ["vanilla", "efficientkan"])
def test_fused_ff_vit_matches_kanvit_apply(monkeypatch, variant):
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    params = _vit_params(create_model(variant, **SMALL, seed=73))
    x = np.random.default_rng(74).standard_normal((3, 1, 28, 28)).astype(np.float32)
    want = j_create_model(variant, **SMALL).apply({"params": params}, jnp.asarray(x))
    model = create_model(variant, **SMALL, seed=1, fused_ff=True)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    calls = []
    for blk in model.blocks:
        blk.ff.register_forward_pre_hook(lambda *a: calls.append(1))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _maxdiff(got, want) <= LOGIT_TOL
    assert not calls  # the FF's Linears never run


@pytest.fixture(scope="module")
def fused_ff_steps():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KANVIT_FF", "1")
        mp.setenv("KANVIT_FF_BN", "8")
        return run_steps("vanilla", SMALL, seed=75, fused_ff=True)


def test_fused_ff_train_step_losses_match_kanvit(fused_ff_steps):
    check_losses(fused_ff_steps)


def test_fused_ff_train_step_grads_match_kanvit(fused_ff_steps):
    check_grads(fused_ff_steps)


def test_fused_ff_train_step_params_match_kanvit(fused_ff_steps):
    check_params(fused_ff_steps)


# --- int8 ---------------------------------------------------------------------

def _quant_step_bound(x, w):
    """The most one rounding-tie flip moves an output (kanvit's
    ``tests/test_quant.py:44-48``): the scale division may round apart by 1
    ulp between two compilers, flipping an element that lands on .5."""
    sx = np.abs(np.asarray(x, np.float32)).max(axis=-1).max() / 127.0
    sw = np.abs(np.asarray(w, np.float32)).max(axis=-1).max() / 127.0
    return 3.0 * sx * sw * 127.0


def _xw(seed, n=100, k=256, out=384):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            (rng.standard_normal((out, k)) * 0.05).astype(np.float32),
            rng.standard_normal(out).astype(np.float32))


@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_matches_kanvit(axis):
    x, _, _ = _xw(80)
    x[3, :5] = np.float32([0.5, -0.5, 1.5, 2.5, -2.5]) * (np.abs(x).max() / 127)
    jq, js = JQ._quantize(jnp.asarray(x), axis=axis)
    tq, ts = Q._quantize(torch.from_numpy(x), dim=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("static", [False, True])
def test_qdot_matches_kanvit(static):
    """Bit for bit: the same int8 values, an exact int32 product and the
    same f32 epilogue."""
    x, w, _ = _xw(81)
    scale = float(np.abs(x).max()) / 127.0 * 0.8 if static else None
    want = JQ.qdot(jnp.asarray(x), jnp.asarray(w), static_scale=scale)
    got = Q.qdot(torch.from_numpy(x), torch.from_numpy(w), static_scale=scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_bias", [True, False])
def test_qdot_rowwise_matches_kanvit(with_bias):
    x, w, b = _xw(82)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if with_bias else (None, None)
    want = JQ.qdot_rowwise(jnp.asarray(x).reshape(4, 25, -1), jnp.asarray(w), bias=jb)
    got = Q.qdot_rowwise(torch.from_numpy(x).reshape(4, 25, -1), torch.from_numpy(w),
                         bias=tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_mm_is_exact_past_f32():
    """K 1,536 (the FF's second Linear): 127 * 127 * K passes 2**24, where
    an f32 product of the int8 values would round."""
    aq = torch.full((3, 1536), 127, dtype=torch.int8)
    bq = torch.full((2, 1536), 127, dtype=torch.int8)
    bq[1, 0] = 126
    got = Q.int_mm(aq, bq)
    assert got.dtype == torch.int32
    assert got[0, 0].item() == 127 * 127 * 1536
    assert got[0, 1].item() == 127 * 127 * 1536 - 127


def _emu_int8(x2d, wq, sw, bias):
    """The kernel's arithmetic on the CPU: x quantized per row, the int32
    product, acc * s_x * s_w + b rounded step by step in f32, then once to
    x's dtype (the bf16 kernel's launches under ``int8_linear_bf16``)."""
    xq, sx = Q._quantize(x2d, dim=-1)
    y = torch._int_mm(xq, wq.t()).float() * sx * sw.reshape(1, -1)
    bf16 = x2d.dtype == torch.bfloat16
    IM.LAUNCHES["int8_linear_bf16" if bf16 else "int8_linear"] += 1
    return (y if bias is None else y + bias).to(x2d.dtype)


def _emulate_launches(monkeypatch):
    """The CUDA path's wrappers on the CPU, each launch emulated (the lanes
    attention's too, which a ViT's forward reaches)."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(IM, "_launch", _emu_int8)
    monkeypatch.setattr(FFN, "_launch", _emu_ffn_fwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)


@pytest.fixture(params=["plain", "kernel_math"])
def int8_path(request, monkeypatch):
    if request.param == "kernel_math":
        _emulate_launches(monkeypatch)
    return request.param


@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_linear_matches_kanvit_kernel(int8_path, monkeypatch, with_bias):
    """kanvit's kernel in interpret mode on a multi-block grid (64-row,
    128-output blocks, the weight not resident) against the port's
    ``int8_linear``, within the tie-aware bound; f32 out."""
    monkeypatch.setattr(JIM, "_BN", 64)
    monkeypatch.setattr(JIM, "_BO", 128)
    monkeypatch.setattr(JIM, "_W_RESIDENT_BYTES", 0)
    x, w, b = _xw(83)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if with_bias else (None, None)
    want = JIM.int8_linear(jnp.asarray(x), jnp.asarray(w), bias=jb)
    got = IM.int8_linear(torch.from_numpy(x), torch.from_numpy(w), tb)
    assert got.dtype == torch.float32 and got.shape == (100, 384)
    assert _maxdiff(got, want) <= _quant_step_bound(x, w)
    np.testing.assert_array_equal(
        got.numpy(), Q.qdot_rowwise(torch.from_numpy(x), torch.from_numpy(w), tb).numpy())
    assert IM.LAUNCHES["int8_linear"] == (1 if int8_path == "kernel_math" else 0)


@pytest.mark.parametrize("bad,err,match", [
    ("dtype", TypeError, "x must be float32 or bfloat16, got torch.float16"),
    ("ragged", ValueError, "multiples of 128"),
    ("bias", ValueError, "bias must be"),
    ("deep", ValueError, "exceeds the kernel's"),
])
def test_int8_kernel_arg_checks(bad, err, match):
    x, w, b = (torch.from_numpy(a) for a in _xw(84))
    if bad == "dtype":
        x = x.half()
    elif bad == "ragged":
        x, w = x[:, :100], w[:, :100]
    elif bad == "deep":
        x, w = torch.zeros(4, IM.MAX_K + IM.LANE), torch.zeros(128, IM.MAX_K + IM.LANE)
    else:
        b = b[:10]
    with pytest.raises(err, match=match):
        IM.check_args(x, w, b)


def test_int8_kernel_takes_max_k(monkeypatch):
    """K = ``MAX_K`` (a multiple of 128, the deepest the kernel's 16-row
    blocks fit) passes the checks and runs through the emulated launch
    with ``qdot_rowwise``'s bits."""
    rng = np.random.default_rng(85)
    x = torch.from_numpy(rng.standard_normal((5, IM.MAX_K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, IM.MAX_K)) * 0.05).astype(np.float32))
    IM.check_args(x, w, None)
    IM.reset_launches()
    _emulate_launches(monkeypatch)
    np.testing.assert_array_equal(IM.int8_linear(x, w).numpy(),
                                  Q.qdot_rowwise(x, w).numpy())
    assert IM.LAUNCHES["int8_linear"] == 1


def test_torchlinear_int8_dispatch(int8_path):
    """Under int8 serving: the kernel where switched on and K, out are
    multiples of 128; else qdot (plus the bias in f32), as kanvit orders
    them. Outside the context the float path is back bit for bit."""
    lin = TorchLinear(128, 256, generator=torch.Generator().manual_seed(3))
    head = TorchLinear(128, 10, generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(_xw(85, n=48, k=128)[0])
    with torch.inference_mode():
        y_f32 = lin(x)
        with Q.int8_serving(kernel=True):
            y_k, y_h = lin(x), head(x)
        with Q.int8_serving():
            y_q = lin(x)
        np.testing.assert_array_equal(y_k.numpy(), Q.qdot_rowwise(
            x, lin.weight, lin.bias).numpy())
        np.testing.assert_array_equal(y_q.numpy(), (Q.qdot(x, lin.weight)
                                                    + lin.bias).numpy())
        np.testing.assert_array_equal(y_h.numpy(), (Q.qdot(x, head.weight)
                                                    + head.bias).numpy())
        assert torch.equal(lin(x), y_f32)
    assert IM.LAUNCHES["int8_linear"] == (1 if int8_path == "kernel_math" else 0)
    assert JIM.int8_linear(jnp.zeros((4, 128)), jnp.zeros((10, 128))) is None


@pytest.fixture(scope="module")
def int8_models():
    """The port's vanilla ViT at ``INT8_GEOM``, kanvit's on the same weights,
    64 images and the f32 logits of both."""
    port = create_model("vanilla", **INT8_GEOM, seed=86)
    params = _vit_params(port)
    jmodel = j_create_model("vanilla", **INT8_GEOM)
    x = np.random.default_rng(87).standard_normal((40, 2, 32, 32)).astype(np.float32)
    jdispatch.set_impl("pallas")
    try:
        jf32 = JPredictor(jmodel, params, batch_size=16).logits(x)
    finally:
        jdispatch.set_impl("auto")
    f32 = Predictor(port, batch_size=16, device="cpu").logits(x)
    assert _maxdiff(f32, jf32) <= LOGIT_TOL
    return port, jmodel, params, x, f32


def _kanvit_int8(monkeypatch, jmodel, params, x, kernel, scales=None):
    if not kernel:
        monkeypatch.setenv("KANVIT_INT8_KERNEL", "0")
    pred = JPredictor(jmodel, params, batch_size=16, quant="int8")
    if scales == "calibrate":
        scales = pred.calibrate(x)
    return pred.logits(x), scales


def _gates(labels, probs, f32):
    """kanvit's own int8 gates (``tests/test_quant.py``): top-1 agreement
    with f32 >= 0.9 and probabilities within 0.2."""
    z = f32.astype(np.float64) - f32.max(-1, keepdims=True)
    pf = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    assert (labels == pf.argmax(-1)).mean() >= 0.9
    assert np.abs(probs - pf).max() < 0.2


# Logits of the port's and kanvit's int8 serving, x max|logit|: the int8
# values agree except where an activation lies within f32 rounding of a .5
# boundary (the two frameworks' LayerNorms and attention differ there by
# ~1e-7), and each such flip moves one pre-activation by s_x s_w |q(w)|.
INT8_LOGIT_TOL = 2e-3


@pytest.mark.parametrize("kernel", [True, False])
def test_int8_predictor_matches_kanvit(int8_path, monkeypatch, int8_models, kernel):
    port, jmodel, params, x, f32 = int8_models
    want, _ = _kanvit_int8(monkeypatch, jmodel, params, x, kernel)
    pred = Predictor(port, batch_size=16, device="cpu", quant="int8",
                     int8_kernel=kernel)
    got = pred.logits(x)
    # 3 padded batches of 16: the embedder and 2 FF pairs each
    assert IM.LAUNCHES["int8_linear"] == (3 * 5 if kernel and int8_path == "kernel_math"
                                          else 0)
    scale = float(np.abs(want).max())
    assert _maxdiff(got, want) <= INT8_LOGIT_TOL * scale
    assert not np.array_equal(got, f32)
    _gates(*pred.predict(x), f32)


@pytest.mark.parametrize("kernel", [True, False])
def test_int8_calibrated_predictor_matches_kanvit(monkeypatch, int8_models, kernel):
    """calibrate(): the same layers and maxima as kanvit's (keys through
    ``scales_from_jax``); served on kanvit's scales, the logits of kanvit's
    calibrated Predictor."""
    port, jmodel, params, x, f32 = int8_models
    want, jscales = _kanvit_int8(monkeypatch, jmodel, params, x, kernel, "calibrate")
    pred = Predictor(port, batch_size=16, device="cpu", quant="int8",
                     int8_kernel=kernel)
    scales = pred.calibrate(x)
    mapped = scales_from_jax(jscales)
    assert sorted(scales) == sorted(mapped) == sorted(
        ["linear_mapper", "mlp_head.1", *(f"blocks.{i}.ff.{j}" for i in range(2)
                                          for j in (0, 2))])
    for name, s in scales.items():
        assert abs(s - mapped[name]) <= 1e-6 * mapped[name], name
    pred.scales = mapped
    got = pred.logits(x)
    assert _maxdiff(got, want) <= INT8_LOGIT_TOL * float(np.abs(want).max())
    _gates(*pred.predict(x), f32)


def test_calibrate_needs_int8_and_scales_need_their_model():
    port = create_model("vanilla", **INT8_GEOM, seed=86)
    with pytest.raises(ValueError, match="quant='int8'"):
        Predictor(port, device="cpu").calibrate(np.zeros((1, 2, 32, 32), np.float32))
    with pytest.raises(KeyError, match="no layer"):
        with Q.int8_serving(port, {"blocks.9.ff.0": 1.0}):
            pass
    with pytest.raises(ValueError, match="not the scope"):
        scales_from_jax({"blocks_0/attn/q_mappings": 1.0})


def test_fused_ff_stays_float_under_int8(monkeypatch, int8_models):
    """fused FF + int8: the FF pairs run the float fused FF (no int8 launch,
    their Linears never called), the embedder and head int8, as kanvit's
    KANVIT_FF=1 int8 Predictor."""
    port, jmodel, params, x, _ = int8_models
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    _emulate_launches(monkeypatch)
    want, _ = _kanvit_int8(monkeypatch, jmodel, params, x, True)
    fused = create_model("vanilla", **INT8_GEOM, seed=1, fused_ff=True)
    fused.load_state_dict(port.state_dict())
    got = Predictor(fused, batch_size=16, device="cpu", quant="int8",
                    int8_kernel=True).logits(x)
    assert _maxdiff(got, want) <= INT8_LOGIT_TOL * float(np.abs(want).max())
    assert FFN.LAUNCHES["ffn_pre_ln"] == 3 * 2 and IM.LAUNCHES["int8_linear"] == 3
