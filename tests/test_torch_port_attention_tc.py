"""The lanes attention's tensor-core arithmetic, emulated on the CPU.

The lanes kernels (``kanvit_torch/kernels/csrc/attention_lanes.cu``) run
head dims 8, 16, 32 and 64 on ``mma.sync.m16n8k8`` in 3xTF32: each f32
operand x is split into big = tf32(x) and small = tf32(x - big)
(``cvt.rna.tf32.f32``, round to nearest with ties away from zero, on 10
mantissa bits), and each product is small*big + big*small + big*big in that
order, per 8-wide step of the contracted index, into a zeroed accumulator
that an f32 add takes into the running sum. The kernels number the
contracted index inside each 8-wide step in another order (keys 2t, 2t+1
on the fragment's t, t+4); one step is one ``mma`` whose terms the
hardware sums in its own order, so the emulation sums a step as a matmul
over those 8 and the permutation does not show.

Here that arithmetic replaces ``_launch`` / ``_launch_bwd`` (as the
``kernel_math`` fixtures of ``test_torch_port_kernels.py`` do) in the forward's
tiles of 32 keys with the online softmax, the dq kernel's recomputed scores
and the dk/dv kernel's transposed ones, and the results are held against
kanvit's Pallas lanes kernel in interpret mode (forward and ``jax.grad``)
and against the plain ``lanes_attention``: forward within 1e-5 x max(1,
max|o|), gradients within 1e-4 x max(1, max|g|). One case shows that plain
1xTF32 (one product of the rounded operands) breaks the 1e-5 forward gate,
the reason for the split.
"""

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

TOL_FWD = 1e-5
TOL_BWD = 1e-4
TILE = 32    # keys (queries in dk/dv) a staged tile
STEP = 8     # the mma's k: the contracted index in steps of 8
EPSILON = 1e-10
MAX_CLAMP = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (add half of the dropped 13 bits' range to the magnitude's
    bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, acc=None, passes="3xtf32"):
    """``acc + a @ b`` over the last dim of ``a`` in steps of 8: each step's
    three TF32 products (small*big, big*small, big*big) go into a zeroed
    accumulator, which an f32 add takes into the running sum;
    ``passes="1xtf32"``: one product of the rounded operands a step."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    (ab, as_), (bb, bs) = split(a), split(b)
    for c in range(0, a.shape[-1], STEP):
        sa, sb = slice(c, c + STEP), (..., slice(c, c + STEP), slice(None))
        if passes == "3xtf32":
            pairs = ((as_[..., sa], bb[sb]), (ab[..., sa], bs[sb]),
                     (ab[..., sa], bb[sb]))
        else:
            pairs = ((ab[..., sa], bb[sb]),)
        step = 0.0
        for x, y in pairs:
            step = step + x @ y
        out = out + step
    return out


def _layout(q4, k4, v4):
    """(B, T, H, dh) views -> (B, H, T, dh) tensors."""
    return (a.transpose(1, 2).contiguous() for a in (q4, k4, v4))


def _visible(maskb, causal, b, t):
    """(B, 1, T, T): query row i sees key j."""
    keys = (torch.ones(b, t, dtype=torch.bool) if maskb is None
            else maskb.bool())[:, None, None, :]
    if causal:
        keys = keys & torch.ones(t, t, dtype=torch.bool).tril()
    return keys.expand(b, 1, t, t)


def emu_fwd(q4, k4, v4, maskb, causal, with_stats, passes="3xtf32"):
    """The forward kernel: tiles of 32 keys, online softmax from the -1e30
    clamp, O += P V in 8-key steps, o = acc * (1 / max(l, 1e-10))."""
    b, t, h, dh = q4.shape
    q, k, v = _layout(q4, k4, v4)
    qs = q * dh ** -0.5
    seen = _visible(maskb, causal, b, t)
    m = torch.full((b, h, t), MAX_CLAMP)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, dh)
    for k0 in range(0, t, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        s = product(qs, kt.transpose(-1, -2), passes=passes)
        s = torch.where(seen[..., k0:k0 + TILE], s, float("-inf"))
        mt = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - mt)
        p = torch.exp(s - mt[..., None])  # exactly 0 for a masked key
        l = l * corr + p.sum(-1)
        acc = product(p, vt, acc * corr[..., None], passes=passes)
        m = mt
    o = acc * (1.0 / l.clamp_min(EPSILON))[..., None]
    FA.LAUNCHES["flash_attention_lanes"] += 1
    stats = torch.stack([m, l], -1) if with_stats else None
    return o.transpose(1, 2).reshape(b, t, h * dh), stats


def emu_bwd(q4, k4, v4, maskb, o, stats, do, causal):
    """The dq kernel (scores and dP = do V^T recomputed, dq = dS K in 8-key
    steps, times the scale) and the dk/dv kernel (S^T = K (q scale)^T and
    dP^T = V do^T with the keys as rows, dv = P^T do and dk = dS^T (q scale)
    in 8-query steps), both from the forward's (m, l)."""
    b, t, h, dh = q4.shape
    scale = dh ** -0.5
    q, k, v = _layout(q4, k4, v4)
    qs = q * scale
    do4 = do.reshape(b, t, h, dh).transpose(1, 2)
    o4 = o.reshape(b, t, h, dh).transpose(1, 2)
    delta = (do4 * o4).sum(-1)
    seen = _visible(maskb, causal, b, t)
    m, rl = stats[..., 0], 1.0 / stats[..., 1].clamp_min(EPSILON)

    s = product(qs, k.transpose(-1, -2))
    p = torch.where(seen, torch.exp(s - m[..., None]) * rl[..., None], 0.0)
    ds = p * (product(do4, v.transpose(-1, -2)) - delta[..., None])
    dq = product(ds, k) * scale

    st = product(k, qs.transpose(-1, -2))  # (B, H, keys, queries)
    pt = torch.where(seen.transpose(-1, -2),
                     torch.exp(st - m[..., None, :]) * rl[..., None, :], 0.0)
    dst = pt * (product(v, do4.transpose(-1, -2)) - delta[..., None, :])
    dv = product(pt, do4)
    dk = product(dst, qs)
    FA.LAUNCHES["flash_attention_lanes_bwd"] += 1
    return [g.transpose(1, 2).contiguous() for g in (dq, dk, dv)]


@pytest.fixture
def tc_math(monkeypatch):
    """The CUDA path's Functions with each launch emulated on the CPU."""
    jdispatch.set_impl("pallas")
    FA.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch", emu_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", emu_bwd)
    yield
    jdispatch.set_impl("auto")


def _inputs(rng, b, t, h, dh):
    """q, k, v as the strided slices of one grouped (N, H*3dh) projection
    output, and the gradient of o."""
    y = rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32)
    g = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    return y, g


def _views(y, b, t, h, dh):
    y4 = y.reshape(b, t, h, 3 * dh)
    return [y4[..., i * dh:(i + 1) * dh] for i in range(3)]


def _mask(rng, b, t, masked):
    if not masked:
        return None
    m = rng.random((b, t)) > 0.2
    m[0] = False     # batch item 0: every row fully masked
    m[1, 0] = False  # causal: query 0 of item 1 sees no key
    return m


def _gate(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    limit = tol * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all() and err <= limit, (err, limit)
    return err


CASES = [
    # b, t, h, dh, causal, masked
    (2, 197, 2, 64, False, False),
    (2, 197, 2, 64, True, True),
    (2, 50, 2, 8, False, True),
    (2, 17, 3, 8, True, False),
    (2, 50, 2, 32, True, True),
    (2, 50, 2, 32, False, False),
]


@pytest.mark.parametrize("b,t,h,dh,causal,masked", CASES)
def test_tc_arithmetic_matches_pallas_and_plain(tc_math, b, t, h, dh, causal,
                                                 masked):
    """Forward and gradients through ``flash_attention_lanes`` with the
    kernels' 3xTF32 arithmetic, against kanvit's Pallas lanes kernel
    (interpret mode, ``jax.vjp``) and the plain ``lanes_attention``."""
    rng = np.random.default_rng(70 + dh + t)
    y, g = _inputs(rng, b, t, h, dh)
    mask = _mask(rng, b, t, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    want_o, vjp = jax.vjp(lambda a: JFA.flash_attention_lanes(
        *(x.reshape(b, t, h * dh) for x in _views(a, b, t, h, dh)), h,
        causal=causal, mask=jmask), jnp.asarray(y))
    (want_g,) = vjp(jnp.asarray(g))

    def through(attn, leaf):
        return attn(*_views(leaf, b, t, h, dh), h, causal=causal, mask=tmask)

    leaf = torch.from_numpy(y).requires_grad_(True)
    got_o = through(FA.flash_attention_lanes, leaf)
    (got_g,) = torch.autograd.grad(got_o, leaf, torch.from_numpy(g))
    assert (FA.LAUNCHES["flash_attention_lanes"],
            FA.LAUNCHES["flash_attention_lanes_bwd"]) == (1, 1)
    plain_leaf = torch.from_numpy(y).requires_grad_(True)
    plain_o = through(A.lanes_attention, plain_leaf)
    (plain_g,) = torch.autograd.grad(plain_o, plain_leaf, torch.from_numpy(g))

    _gate(got_o.detach(), want_o, TOL_FWD)
    _gate(got_o.detach(), plain_o.detach(), TOL_FWD)
    _gate(got_g, want_g, TOL_BWD)
    _gate(got_g, plain_g, TOL_BWD)
    if masked:  # the fully masked item: output and gradients exactly 0
        assert bool((got_o[0] == 0).all())
        assert bool((got_g.view(b, t, -1)[0] == 0).all())


def _f64_attention(y, b, t, h, dh):
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).double()
               for a in _views(y, b, t, h, dh))
    return A.lanes_attention(q, k, v, h)


def test_1xtf32_breaks_the_forward_gate():
    """At vit-s's T 197 and dh 64, one TF32 product of the rounded operands
    is off the f32 result by far more than the 1e-5 gate; the 3xTF32 split
    is within it, and within 1e-6 of f64."""
    b, t, h, dh = 2, 197, 2, 64
    y, _ = _inputs(np.random.default_rng(77), b, t, h, dh)
    q4, k4, v4 = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in _views(y, b, t, h, dh))
    exact = _f64_attention(y, b, t, h, dh)
    plain = A.lanes_attention(q4, k4, v4, h)
    split3, _ = emu_fwd(q4, k4, v4, None, False, False)
    single, _ = emu_fwd(q4, k4, v4, None, False, False, passes="1xtf32")
    scale = max(1.0, float(exact.abs().max()))
    err3 = float((split3.double() - exact).abs().max()) / scale
    err1 = float((single.double() - exact).abs().max()) / scale
    assert err3 <= 1e-6, err3
    _gate(split3, plain, TOL_FWD)
    assert err1 > 10 * TOL_FWD, err1
    with pytest.raises(AssertionError):
        _gate(single, plain, TOL_FWD)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -12, 1.0),                   # below half an ulp: down
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),  # above half an ulp: up
    (2.0 - 2.0 ** -23, 2.0),                   # carries into the exponent
    (0.0, 0.0),
])
def test_tf32_rounding(x, want):
    """The emulated ``cvt.rna.tf32.f32`` on values whose rounding is known,
    and big + small recovers x to 2^-22 of it."""
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    big, small = split(torch.tensor([x], dtype=torch.float32))
    assert abs(float(big) + float(small) - x) <= 2.0 ** -22 * abs(x)


def test_rows_aligned_check_raises_and_copies_nothing(monkeypatch):
    """The tensor-core head dims need 16-byte-aligned rows: an unaligned
    view raises (no copy, no launch); the grouped projection's slices, and
    any dh the generic kernels take, pass."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch", emu_fwd)
    FA.reset_launches()
    b, t, h, dh = 2, 9, 2, 8
    flat = torch.randn(b * t * h * dh + 1)
    shifted = flat[1:].view(b, t, h * dh)        # data_ptr 4 bytes off
    y = torch.randn(b * t, h * 3 * dh)
    q, k, v = _views(y, b, t, h, dh)             # offsets of 0, 8, 16 floats
    assert all(FA.rows_aligned(a) for a in (q, k, v))
    assert not FA.rows_aligned(shifted)
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_lanes(shifted, k.reshape(b, t, -1), v.reshape(b, t, -1), h)
    odd = torch.randn(b, t, h, dh + 1)[..., 1:]  # row stride 9 floats
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_lanes(odd, odd, odd, h)
    assert FA.LAUNCHES["flash_attention_lanes"] == 0
    with torch.inference_mode():
        FA.flash_attention_lanes(q, k, v, h)
    assert FA.LAUNCHES["flash_attention_lanes"] == 1
    FA.check_aligned(q=torch.randn(b, t, h, 25)[..., 1:])  # dh 24: generic kernels
