"""The fused pre-LN FF's tensor-core arithmetic, emulated on the CPU.

The FF kernels (``kanvit_torch/kernels/csrc/fused_ffn.cu``) run every
product on ``mma.sync.m16n8k8`` in 3xTF32, as the attention kernels do:
each f32 operand split into big = tf32(x) and small = tf32(x - big), each
8-deep step of the contracted index small*big + big*small + big*big into a
zeroed accumulator that an f32 add takes into the running sum (``product``
of ``test_torch_port_attention_tc.py``, bit-level TF32 rounding). Here that
arithmetic replaces ``_launch`` / ``_launch_bwd`` in the kernels' order:

- the forward: h = LN W1^T + b1 over D, then y_acc += relu(h) W2^T chunk by
  chunk of hidden units (256, or 128 past D 384), one running sum, then
  x + (y_acc + b2); past D 512 the tiled route's products sum in the same
  order (h over D, then r W2^T over all of F in one running sum);
- the backward: h and dr = g W2 over D, dh = dr [h > 0], dln = dh W1 over F
  (past D 512 into device memory, then dx a row block at a time), dx and the
  48-row blocks' dgamma, dbeta partials summed in block order,
  and dW2 = g^T r, dW1 = dh^T LN over the row splits of ``dw_splits``,
  summed in split order, with db2, db1 the splits' column sums.

The results are held against kanvit's Pallas ``ffn_pre_ln`` in interpret
mode (``KANVIT_FF=1``, ``KANVIT_FF_BN=8``) and ``jax.grad`` through it:
values within 1e-5 x max(1, max|y|), all seven gradients within 1e-5 x
max(1, max|g|). One case shows that plain 1xTF32 breaks both the 1e-4 gate
against the plain version and the 1e-6 gate against f64 at vit-s widths,
the reason for the split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_ffn as JFFN
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_attention_tc import product

TOL = 1e-5
TOL_FFN = 1e-4      # chip_smoke.py's gate against the plain version
TOL_FFN_F64 = 1e-6  # and against f64
GRADS = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")


def chunk(d: int) -> int:
    """Hidden units a chunk of the forward kernel at width ``d``."""
    return 256 if d <= 384 else 128


def emu_ln(x2d, gamma, beta):
    mean = x2d.mean(1, keepdim=True)
    xc = x2d - mean
    rstd = 1.0 / torch.sqrt((xc * xc).mean(1, keepdim=True) + 1e-5)
    xhat = xc * rstd
    return xhat, xhat * gamma + beta, rstd


def emu_fwd(x2d, gamma, beta, w1, b1, w2, b2, relu_mask=None, passes="3xtf32"):
    """``kanvit_ffn_fwd``: h over D in 8-deep steps, then each chunk's
    r W2c^T into one running sum."""
    FFN.check_args(x2d, gamma, beta, w1, b1, w2, b2)
    _, ln, _ = emu_ln(x2d, gamma, beta)
    h = product(ln, w1.T, passes=passes) + b1
    if relu_mask is not None:
        relu_mask.copy_(h > 0)
    r = torch.relu(h)
    bf, acc = chunk(x2d.shape[1]), None
    for c0 in range(0, w1.shape[0], bf):
        acc = product(r[:, c0:c0 + bf], w2[:, c0:c0 + bf].T, acc, passes=passes)
    FFN.LAUNCHES["ffn_pre_ln"] += 1
    return x2d + (acc + b2)


def _ordered_sum(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _weight_grad(a, b, splits):
    """a^T b and the column sums of a over ``splits`` row splits, summed in
    split order."""
    n = a.shape[0]
    per = -(-n // splits)
    spans = [(lo, min(n, lo + per)) for lo in range(0, n, per)]
    dw = _ordered_sum([product(a[lo:hi].T, b[lo:hi]) for lo, hi in spans])
    return dw, _ordered_sum([a[lo:hi].sum(0) for lo, hi in spans])


def emu_bwd(x2d, gamma, beta, w1, b1, w2, g, passes="3xtf32"):
    """``kanvit_ffn_bwd``: the hidden kernel's h and dr over D, the dx
    kernel's dln over F and its per-block dgamma, dbeta, the weight-gradient
    kernel's row splits."""
    n, d = x2d.shape
    xhat, ln, rstd = emu_ln(x2d, gamma, beta)
    h = product(ln, w1.T, passes=passes) + b1
    dr = product(g, w2, passes=passes)
    r, dh = torch.relu(h), torch.where(h > 0, dr, torch.zeros(()))
    dln = product(dh, w1, passes=passes)
    gs = dln * gamma
    dx = g + rstd * (gs - gs.sum(1, keepdim=True) / d
                     - xhat * (gs * xhat).sum(1, keepdim=True) / d)
    blocks = range(0, n, FFN.ROWS_PER_BLOCK)
    dgamma = _ordered_sum([(dln * xhat)[r0:r0 + FFN.ROWS_PER_BLOCK].sum(0)
                           for r0 in blocks])
    dbeta = _ordered_sum([dln[r0:r0 + FFN.ROWS_PER_BLOCK].sum(0) for r0 in blocks])
    splits = FFN.dw_splits(n, d, w1.shape[0])
    dw2, db2 = _weight_grad(g, r, splits)
    dw1, db1 = _weight_grad(dh, ln, splits)
    FFN.LAUNCHES["ffn_pre_ln_bwd"] += 1
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


@pytest.fixture
def kernel_math(monkeypatch):
    """``_FfnFn`` with each launch replaced by the emulation."""
    jdispatch.set_impl("pallas")
    FFN.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FFN, "_launch", emu_fwd)
    monkeypatch.setattr(FFN, "_launch_bwd", emu_bwd)
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    yield
    jdispatch.set_impl("auto")


def _arrays(seed, n, d, f):
    rng = np.random.default_rng(seed)
    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.2, 0.3, 0.3, 0.3, 0.3)
    arrays = [(rng.standard_normal(s) * sc).astype(np.float32)
              for s, sc in zip(shapes, scales)]
    arrays[1] += 1.0
    return arrays, rng.standard_normal((n, d)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("n,d,f", [
    (53, 100, 400),  # ragged N, D not a multiple of 8, 2 chunks (the last 144 wide)
    (37, 24, 48),
    (20, 400, 136),  # past D 384: chunks of 128
    (520, 16, 40),   # two row splits of the weight gradients, 11 row blocks
    (12, 768, 512),  # past D 512: the tiled route (vit-b's D)
])
def test_ffn_tc_matches_kanvit_kernel(kernel_math, n, d, f):
    arrays, g = _arrays(130 + d, n, d, f)
    jargs = [jnp.asarray(a) for a in arrays]
    want = JFFN.ffn_pre_ln(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(JFFN.ffn_pre_ln(*a) * g),
                      argnums=tuple(range(7)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = FFN.ffn_pre_ln(*leaves)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert _rel(got.detach(), want) <= TOL
    for name, a, b in zip(GRADS, tgrads, jgrads):
        assert _rel(a, b) <= TOL, name
    assert FFN.LAUNCHES == {"ffn_pre_ln": 1, "ffn_pre_ln_bwd": 1, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}


def test_ffn_tc_relu_mask_is_the_backward_pattern(kernel_math):
    """The forward's ReLU pattern (``relu_mask``) is the one the backward
    recomputes: h is the same product, in the same order, in both."""
    arrays, g = _arrays(140, 45, 100, 200)
    args = [torch.from_numpy(a) for a in arrays]
    mask = torch.empty(45, 200, dtype=torch.uint8)
    emu_fwd(*args, relu_mask=mask)
    _, ln, _ = emu_ln(*args[:3])
    h = product(ln, args[3].T) + args[4]
    assert torch.equal(mask.bool(), h > 0)


def _vit_s_slice(rows=256, d=384, f=1536):
    """``chip_smoke.py``'s input scales at vit-s widths."""
    rng = np.random.default_rng(150)
    shapes = ((rows, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.1, d ** -0.5, 0.1, f ** -0.5, 0.1)
    args = [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
            for s, sc in zip(shapes, scales)]
    args[1] += 1.0
    return args


def test_ffn_1xtf32_breaks_the_gates_3xtf32_meets_them():
    """At vit-s widths (D 384, F 1,536, 256 rows) plain 1xTF32 (one product
    of the rounded operands a step) is past both TOL_FFN against the plain
    f32 version and TOL_FFN_F64 against f64; 3xTF32 meets both."""
    args = _vit_s_slice()
    plain = K.ffn_pre_ln(*args)
    exact = K.ffn_pre_ln(*(a.double() for a in args))
    scale = max(1.0, float(exact.abs().max()))
    errs = {}
    for passes in ("3xtf32", "1xtf32"):
        y = emu_fwd(*args, passes=passes)
        errs[passes] = (float((y - plain).abs().max()) / scale,
                        float((y.double() - exact).abs().max()) / scale)
    assert errs["3xtf32"][0] <= TOL_FFN and errs["3xtf32"][1] <= TOL_FFN_F64, errs
    assert errs["1xtf32"][0] > TOL_FFN and errs["1xtf32"][1] > TOL_FFN_F64, errs


def test_ffn_tc_backward_holds_f64():
    """The emulated 3xTF32 backward at a vit-s-width slice: every gradient
    within 1e-5 x max(1, max|g|) of f64 autograd on the same ReLU pattern."""
    args = _vit_s_slice(rows=64)
    g = torch.from_numpy(np.random.default_rng(151).standard_normal(
        (64, 384)).astype(np.float32))
    got = emu_bwd(*args[:6], g)
    _, ln, _ = emu_ln(*args[:3])
    pattern = (product(ln, args[3].T) + args[4]) > 0
    leaves = [a.double().requires_grad_(True) for a in args]

    def on_pattern(x, gamma, beta, w1, b1, w2, b2):
        h = K.layernorm(x, gamma, beta) @ w1.T + b1
        return x + ((h * pattern) @ w2.T + b2)

    want = torch.autograd.grad(on_pattern(*leaves), leaves, g.double())
    for name, a, b in zip(GRADS, got, want):
        assert _rel(a, b) <= TOL, name


def test_ffn_pitched_pads_only_what_needs_it():
    """``_pitched`` returns an aligned input of pitch ``ld`` as it is, and
    anything else as a copy with zero pad columns."""
    t = torch.arange(12.0).reshape(3, 4)
    assert FFN._pitched(t, FFN._pitch(4)) is t
    odd = torch.arange(15.0).reshape(3, 5)
    p = FFN._pitched(odd, FFN._pitch(5))
    assert p.shape == (3, 8) and torch.equal(p[:, :5], odd)
    assert not p[:, 5:].any()
    shifted = torch.arange(13.0)[1:].reshape(3, 4)
    assert shifted.data_ptr() % 16 != 0
    q = FFN._pitched(shifted, 4)
    assert q.data_ptr() % 16 == 0 and torch.equal(q, shifted)
