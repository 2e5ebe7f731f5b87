"""The tiled attention's tensor-core arithmetic, emulated on the CPU.

The tiled kernels (``kanvit_torch/kernels/csrc/flash_attention.cu``) run
head dims 8, 16, 32 and 64 on ``mma.sync.m16n8k8`` in 3xTF32, as the lanes
kernels do: each f32 operand split into big = tf32(x) and small =
tf32(x - big), each product small*big + big*small + big*big per 8-wide
step of the contracted index into a zeroed accumulator that an f32 add
takes into the running sum (``product`` of
``test_torch_port_attention_tc.py``, bit-level TF32 rounding). Here that
arithmetic replaces ``_launch_tiled`` / ``_launch_tiled_bwd`` at the
kernels' own tiles:

- the forward's online softmax over tiles of 32 keys, with the tiled
  tier's edge semantics (the finite NEG_INF on masked scores, p zeroed on
  invalid keys only, each tile's row sum clamped at 1e-10);
- the dq kernel's recomputed scores and dP = do V^T, dq = dS K;
- the dk/dv kernel's transposed ones, S^T = K (q scale)^T and dP^T =
  V do^T, then dv = P^T do and dk = dS^T (q scale).

The results are held against kanvit's Pallas tiled kernel in interpret
mode (forward and ``jax.vjp``) and against ``flash_attention_reference``
and autograd through it: forward within 1e-5 x max(1, max|o|), gradients
within 1e-4 x max(1, max|g|). One case shows that plain 1xTF32 breaks the
forward's f64 gate at T = 300, the reason for the split.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import flash_attention as JFA
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from test_torch_port_attention_tc import EPSILON, TOL_BWD, TOL_FWD, product

KEY_TILE = 32  # keys a streamed forward tile
NEG = float(np.finfo(np.float32).min)
TOL_F64 = 1e-6


def _scores(q, k, maskb, causal, passes):
    """Scaled q, the raw scores q k^T in the kernels' arithmetic, causal
    visibility (row at qpos = row - max(tk - tq, 0)) and key validity."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    qs = q * dh ** -0.5
    s = product(qs, k.transpose(-1, -2), passes=passes)
    qpos = torch.arange(tq) - max(tk - tq, 0)
    vis = (qpos[:, None] >= torch.arange(tk)[None, :]) if causal else (
        torch.ones(tq, tk, dtype=torch.bool))
    valid = (torch.ones(b, 1, 1, tk, dtype=torch.bool) if maskb is None
             else maskb.bool()[:, None, None, :])
    return qs, s, vis, valid


def emu_fwd(q, k, v, maskb, causal, with_stats, passes="3xtf32"):
    """``kanvit_flash_attention_fwd``: tiles of 32 keys, O += P V in 8-key
    steps after the running sum's rescale."""
    tk = k.shape[2]
    _, s, vis, valid = _scores(q, k, maskb, causal, passes)
    s = torch.where(valid & vis, s, NEG)
    m = torch.full((*q.shape[:3], 1), NEG)
    l = torch.zeros(*q.shape[:3], 1)
    acc = torch.zeros(q.shape)
    for k0 in range(0, tk, KEY_TILE):
        sl = s[..., k0:k0 + KEY_TILE]
        mt = torch.maximum(m, sl.amax(-1, keepdim=True))
        corr = torch.exp(m - mt)
        # 1 on a valid, causally masked key of a row whose max is NEG
        p = torch.where(valid[..., k0:k0 + KEY_TILE], torch.exp(sl - mt), 0.0)
        l = corr * l + p.sum(-1, keepdim=True).clamp_min(EPSILON)
        acc = product(p, v[:, :, k0:k0 + KEY_TILE], acc * corr, passes=passes)
        m = mt
    l = l.clamp_min(EPSILON)
    FA.LAUNCHES["flash_attention"] += 1
    stats = torch.cat([m, l], -1) if with_stats else None
    return (acc / l).transpose(1, 2).contiguous(), stats


def emu_bwd(q, k, v, maskb, o, stats, do, causal):
    """``kanvit_flash_attention_dq`` (which writes delta) and ``_dkv``, from
    the forward's (m, l); ``o``, ``do``: (B, Tq, H, dh)."""
    dh = q.shape[-1]
    qs, s, vis, valid = _scores(q, k, maskb, causal, "3xtf32")
    do4, o4 = do.transpose(1, 2), o.transpose(1, 2)
    delta = (do4 * o4).sum(-1, keepdim=True)
    m, rl = stats[..., :1], 1.0 / stats[..., 1:]

    seen = valid & vis
    p = torch.where(seen, torch.exp(s - m) * rl, 0.0)
    ds = torch.where(seen, p * (product(do4, v.transpose(-1, -2)) - delta), 0.0)
    dq = product(ds, k) * dh ** -0.5

    st = product(k, qs.transpose(-1, -2))  # (B, H, keys, queries)
    vis_t = vis.transpose(-1, -2)
    pt = torch.where(valid.transpose(-1, -2),
                     torch.exp(torch.where(vis_t, st, NEG) - m.transpose(-1, -2))
                     * rl.transpose(-1, -2), 0.0)
    dst = torch.where(vis_t, pt * (product(v, do4.transpose(-1, -2))
                                   - delta.transpose(-1, -2)), 0.0)
    dv = product(pt, do4)
    dk = product(dst, qs)
    FA.LAUNCHES["flash_attention_dq"] += 1
    FA.LAUNCHES["flash_attention_dkv"] += 1
    return [g.transpose(1, 2).contiguous() for g in (dq, dk, dv)]


@pytest.fixture
def tc_math(monkeypatch):
    """The CUDA path's Functions with each tiled launch emulated."""
    jdispatch.set_impl("pallas")
    FA.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch_tiled", emu_fwd)
    monkeypatch.setattr(FA, "_launch_tiled_bwd", emu_bwd)
    yield
    jdispatch.set_impl("auto")


# name: (b, h, tq, tk, dh, causal, masked keys per batch item or None, buckets)
CASES = {
    "noncausal": (2, 2, 37, 37, 32, False, None, (16, 16)),
    "causal": (2, 2, 37, 37, 32, True, None, (16, 16)),
    # qpos = row - 16: rows 0-15 see no key causally
    "causal_tq_lt_tk": (1, 2, 24, 40, 32, True, None, (16, 16)),
    # keys 0-3 masked: causal rows 0-3 see no valid key
    "masked_causal_rows": (1, 2, 24, 24, 32, True, [range(4)], (16, 16)),
    # batch item 1 masks every key
    "masked_ragged": (2, 2, 30, 41, 16, False, [range(3, 9), range(41)], (16, 16)),
    "causal_tq_gt_tk_dh64": (1, 2, 40, 24, 64, True, [range(20, 24)], (16, 16)),
    "dh8_masked_causal": (2, 2, 45, 45, 8, True, [range(5), range(45)], (16, 16)),
    # past two 32-key tiles, and a ragged last one
    "t300_causal_dh64": (1, 2, 300, 300, 64, True, None, (128, 128)),
}


def _case_inputs(name):
    b, h, tq, tk, dh, causal, masked, blocks = CASES[name]
    rng = np.random.default_rng(80)
    q = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, dh)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    mask = None
    if masked is not None:
        mask = np.ones((b, tk), bool)
        for i, keys in enumerate(masked):
            mask[i, list(keys)] = False
    return (q, k, v), g, mask, causal, blocks


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """kanvit's flash_attention (Pallas, interpret mode): output and VJP."""
    jdispatch.set_impl("pallas")
    (q, k, v), g, mask, causal, blocks = _case_inputs(name)
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda *a: JFA.flash_attention(*a, causal, *blocks, jmask),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _gate(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    limit = tol * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all() and err <= limit, (err, limit)
    return err


@pytest.mark.parametrize("name", list(CASES))
def test_tc_arithmetic_matches_pallas_and_reference(tc_math, name):
    """Forward and gradients through ``flash_attention`` with the tiled
    kernels' 3xTF32 arithmetic, against kanvit's Pallas tiled kernel
    (interpret mode, ``jax.vjp``) and ``flash_attention_reference``."""
    (q, k, v), g, mask, causal, blocks = _case_inputs(name)
    b, h, tq, dh = q.shape
    assert not FA.use_small(tq, k.shape[2], dh, h, *blocks)
    want_o, want_g = _pallas(name)
    tmask = None if mask is None else torch.from_numpy(mask)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got_o = FA.flash_attention(*leaves, causal, *blocks, tmask)
    got_g = torch.autograd.grad(got_o, leaves, torch.from_numpy(g))
    assert (FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_dq"],
            FA.LAUNCHES["flash_attention_dkv"]) == (1, 1, 1)
    plain_leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    plain_o = A.flash_attention_reference(*plain_leaves, causal, *blocks, tmask)[0]
    plain_g = torch.autograd.grad(plain_o, plain_leaves, torch.from_numpy(g))

    _gate(got_o.detach(), want_o, TOL_FWD)
    _gate(got_o.detach(), plain_o.detach(), TOL_FWD)
    for got, want, plain in zip(got_g, want_g, plain_g):
        _gate(got, want, TOL_BWD)
        _gate(got, plain, TOL_BWD)


def test_rows_with_no_visible_key_take_the_mean_of_v(tc_math):
    """Causal, keys 0-3 masked, in the kernels' arithmetic: rows 0-3 see no
    valid key and are the mean of v over keys 4-23, later keys included;
    their gradients stay finite."""
    (q, k, v), g, mask, causal, blocks = _case_inputs("masked_causal_rows")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = FA.flash_attention(*leaves, causal, *blocks, torch.from_numpy(mask))
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    rows = o.detach()[0, :, :4].numpy()
    uniform = v[0, :, 4:].mean(axis=1)  # (H, dh)
    _gate(rows, np.broadcast_to(uniform[:, None], rows.shape), TOL_FWD)
    assert all(bool(a.isfinite().all()) for a in grads)


def test_1xtf32_breaks_the_forward_f64_gate():
    """At T 300 (ten 32-key tiles), dh 64, causal: the 3xTF32 forward is
    within 1e-6 of f64, the gate the card holds the kernel to; one TF32
    product of the rounded operands is off by far more than the 1e-5
    forward gate."""
    (q, k, v), _, _, _, blocks = _case_inputs("t300_causal_dh64")
    q, k, v = map(torch.from_numpy, (q, k, v))
    exact = A.flash_attention_reference(q.double(), k.double(), v.double(), True,
                                        *blocks)[0]
    scale = max(1.0, float(exact.abs().max()))
    errs = {}
    for passes in ("3xtf32", "1xtf32"):
        o, _ = emu_fwd(q, k, v, None, True, False, passes=passes)
        errs[passes] = float((o.transpose(1, 2).double() - exact).abs().max()) / scale
    assert errs["3xtf32"] <= TOL_F64, errs
    assert errs["1xtf32"] > 10 * TOL_FWD, errs


def test_unaligned_rows_raise_before_any_launch(tc_math):
    """The tiled tensor-core head dims stage 16-byte rows: a (B, H, T, dh)
    view whose rows are not 16-byte aligned raises, with no copy and no
    launch; the (B, T, H, dh) projections' views and the generic head dims
    pass."""
    b, h, t, dh = 1, 2, 40, 16
    flat = torch.randn(b * t * h * dh + 1)
    shifted = flat[1:].view(b, t, h, dh).transpose(1, 2)  # data_ptr 4 bytes off
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(shifted, shifted, shifted, True, 16, 16)
    assert FA.LAUNCHES["flash_attention"] == 0
    y = torch.randn(b, t, 3 * h * dh)
    q, k, v = (a.view(b, t, h, dh).transpose(1, 2) for a in y.chunk(3, dim=-1))
    with torch.inference_mode():
        FA.flash_attention(q, k, v, True, 16, 16)
    assert FA.LAUNCHES["flash_attention"] == 1
    odd = torch.randn(b, t, h, 25)[..., 1:].transpose(1, 2)  # dh 24: generic
    FA.check_aligned("flash_attention", q=odd)
