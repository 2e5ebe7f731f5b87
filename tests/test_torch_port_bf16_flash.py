"""The tiled attention in bf16 and the bf16 causal decoder against kanvit.

kanvit's tiled kernels (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) take bf16 q, k and v, keep the softmax in f32, round
p and ds to bf16 at their products, accumulate in f32 and return bf16. The
port's plain twins (``A.flash_attention_bf16``, ``A.flash_attention_bwd_bf16``)
follow that policy over kanvit's own key blocks (``_plan``'s bk); here they
are held against kanvit's ``flash_attention`` in Pallas interpret mode
(``dispatch.set_impl("pallas")``) on the same bf16 inputs, drawn with numpy
from a seed, through the CPU route (``FA.flash_attention`` on CPU tensors,
``FA._FlashBf16Plain``).

The gates, stated before any run (``chip_smoke.py``'s bf16 gates): one
bf16 ulp elementwise, |a - b| <= 2^-7 |b| + 2^-12 max|b|, plus one ulp of
each rounded intermediate weighted as the next product weighs it: for o
2^-8 of the twin's attention over |v| (sum bf16(p) |v| / l), for dq, dk, dv
2^-8 of ``A.flash_attention_bwd_bf16(..., spread=True)`` (|ds| |k|,
|ds|^T |q|, |p|^T |do|). kanvit's (m, l): m within 2^-16 max(1, |m|) and l
within 2^-16 of l (f32 scores of depth dh and row sums in another order).

The kernels' own tiling, emulated on the CPU (``kernel_math``): the forward
streams 32-key tiles with its own running max, so each bf16(p) is rounded
against another max than the twin's (kanvit's 128-multiple blocks); each
side's p lies within 2^-8 of its f32 value, so the kernel's gate against
its twin has the two-sided p term 2^-7 of sum bf16(p) |v| / l besides the
output ulp. The backward renormalises by the final (m, l): no tiling
enters, but its kernels take exp(y) as 2^(y log2 e) with y log2 e rounded
to f32 (``_kernel_bwd_bf16``), so their gradients are held to the twin's
by its gate, not bit for bit.

The repair: before this file, a bf16 call at the tiled tier on the CPU ran
``flash_attention_reference`` and returned f32 with none of kanvit's
roundings; at ``_REPAIR``'s shape it was 4.96e-3 from kanvit's kernel (max
abs) and differed from it in 99.7% of the elements, where the twin
differs in 0.02% of them, by one ulp (measured once on a CPU).

Shapes: B 1-2, H 2, T 250-330 with 128-key buckets (at least three kanvit
key blocks, so p rounds against a moving max), causal and not, tq < tk with
masked keys (rows that see no valid key), dh 64 and dh 32 and 8 (where
dh^-1/2 is not a power of two and the scale's place shows in the bits), and
the head dims the card runs on its kernels padded to 128: 24, 40, 72 and
128 (kanvit pads every d to 128 lanes; the port pads in shared memory), at
the same gates. A head dim that is not a multiple of 8, or is past 128,
raises in f32 and bf16 on the card's route (kanvit takes it).
The bf16 ``CausalDecoder`` against kanvit's bf16 decoder (its params cast
to bf16 for the step, CE on f32 logits) on the same weights at both tiers,
at 2 heads of 16 and of 40:
logits within 2e-2 x max(1, max|logit|) and the loss within 5e-2 x
max(1, |loss|), kanvit's own bf16 gates (``tests/test_kernels.py:871``,
``:966-967``); every gradient within 5e-2 of its own max|g|, tighter than
kanvit's 5e-2 x max(1, max|g|), which at this decoder's gradients (all
below 1) is an absolute 5e-2 that a zeroed gradient would pass. torch on
one thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kanvit.models.decoder as jdecoder
from kanvit.kernels import flash_attention as JFA
from kanvit.layers.attention import FlashAttentionBlock as JBlock
from kanvit.ops import dispatch as jdispatch
from kanvit_torch import bench_decoder as BD
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.models import CausalDecoder
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params
from test_torch_port_bf16_train import _emu_lanes_bf16, _emu_lanes_bwd_bf16
from test_torch_port_decoder import (
    BLOCKS,
    DIM,
    HEADS,
    VOCAB,
    _init,
    _kanvit_decoder,
    _port_decoder,
    _tokens,
)

BF16 = torch.bfloat16
ULP_REL, ULP_ABS, ULP_MID = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
P_TWO_SIDED = 2.0 ** -7   # x sum bf16(p) |v| / l: the kernel's p against the twin's
STAT_TOL = 2.0 ** -16     # (m, l) against kanvit's
LOGIT_TOL = 2e-2          # x max(1, max|logit|)
GRAD_TOL = 5e-2           # x max(1, max|g|)
BUCKETS = (128, 128)


@pytest.fixture(autouse=True)
def one_thread_pallas():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jdispatch.set_impl("pallas")
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")
    torch.set_num_threads(threads)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _gate(got, want, spread=None, mid=ULP_MID):
    """One bf16 ulp of the output, plus ``mid`` of ``spread``."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    if spread is not None:
        bound = bound + mid * _f64(spread)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


def _close(got, want, tol, floor=1.0):
    """max|got - want| within ``tol`` x max(floor, max|want|)."""
    got, want = _f64(got), _f64(want)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= tol * max(floor, np.abs(want).max()), err


# name: (b, h, tq, tk, dh, causal, masked keys per batch item or None)
CASES = {
    "causal_dh64": (2, 2, 300, 300, 64, True, None),
    "masked_dh64": (2, 2, 300, 300, 64, False, [range(5, 40)]),
    # qpos = row - 80: rows 0-79 see no key; keys 0-3 masked: rows 80-83 see
    # no valid key; item 1 masks every key
    "causal_tq_lt_tk_dh32": (2, 2, 250, 330, 32, True, [range(4), range(330)]),
    "causal_masked_dh8": (1, 2, 300, 300, 8, True, [list(range(4)) + list(range(130, 200))]),
    # the head dims on the card's padded kernels: odd multiples of 8 (24, 72)
    # end in half a 16-deep step
    "causal_dh24": (2, 2, 300, 300, 24, True, None),
    "masked_dh40": (2, 2, 270, 270, 40, False, [range(5, 40)]),
    "causal_tq_lt_tk_dh72": (2, 2, 250, 330, 72, True, [range(4), range(330)]),
    "causal_masked_dh128": (1, 2, 300, 300, 128, True,
                            [list(range(4)) + list(range(130, 200))]),
}


def _case(name, seed=90):
    b, h, tq, tk, dh, causal, masked = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
                   for s in ((b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh), (b, h, tq, dh)))
    mask = None
    if masked is not None:
        mask = np.ones((b, tk), bool)
        for i, keys in enumerate(masked):
            mask[i, list(keys)] = False
    return (q, k, v), do, mask, causal


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """kanvit's flash_attention (Pallas, interpret mode) on the case: o, the
    VJP of do, and its forward's (m, l)."""
    jdispatch.set_impl("pallas")
    (q, k, v), do, mask, causal = _case(name)
    jmask = None if mask is None else jnp.asarray(mask)
    jqkv = [_jnp(a) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda *a: JFA.flash_attention(*a, causal, *BUCKETS, jmask), *jqkv)
    _, _, m, l = JFA._flash_fwd_impl(*jqkv, jmask, causal, *BUCKETS)
    return out, vjp(_jnp(do)), m, l


def _route(qkv, do, mask, causal):
    """``FA.flash_attention`` through autograd: o and dq, dk, dv."""
    leaves = [a.clone().requires_grad_(True) for a in qkv]
    tmask = None if mask is None else torch.from_numpy(mask)
    o = FA.flash_attention(*leaves, causal, *BUCKETS, tmask)
    o.backward(do)
    return o.detach(), [a.grad for a in leaves]


def _spreads(qkv, do, mask, causal, o, m, l):
    tmask = None if mask is None else torch.from_numpy(mask)
    q, k, v = qkv
    spread_o = A.flash_attention_bf16(q, k, v.abs(), causal, BUCKETS[1], tmask)[0]
    return spread_o, A.flash_attention_bwd_bf16(q, k, v, o, do, m, l, causal, tmask,
                                                spread=True)


@pytest.mark.parametrize("name", list(CASES))
def test_twins_match_pallas(name):
    """The CPU route (the twins through ``_FlashBf16Plain``) against kanvit's
    Pallas tiled kernels: o, (m, l) and the VJP, in bf16."""
    qkv, do, mask, causal = _case(name)
    tq, tk, dh = qkv[0].shape[2], qkv[1].shape[2], qkv[0].shape[3]
    assert A.kanvit_key_block(tk, BUCKETS[1]) == 128 and tk > 256
    assert not FA.use_small(tq, tk, dh, qkv[0].shape[1], *BUCKETS, 2)
    want_o, want_grads, want_m, want_l = _pallas(name)
    assert want_o.dtype == jnp.bfloat16
    o, grads = _route(qkv, do, mask, causal)
    assert o.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    tmask = None if mask is None else torch.from_numpy(mask)
    o2, m, l = A.flash_attention_bf16(*qkv, causal, BUCKETS[1], tmask)
    assert torch.equal(o, o2)
    spread_o, spread = _spreads(qkv, do, mask, causal, o, m, l)
    _gate(o, want_o, spread_o)
    _close(m, want_m, STAT_TOL)
    assert np.all(np.abs(_f64(l) - _f64(want_l)) <= STAT_TOL * _f64(want_l))
    for got, jg, sp in zip(grads, want_grads, spread):
        _gate(got, jg, sp)
    assert sum(FA.LAUNCHES.values()) == 0


_REPAIR = "causal_dh64"


def test_cpu_route_returns_bf16_with_kanvits_roundings():
    """The repaired CPU route: a bf16 call at the tiled tier returns bf16,
    nearly every element kanvit's bits; the old route
    (``flash_attention_reference``) returned f32 without kanvit's
    roundings, off in 99.7% of the elements (4.96e-3 max abs at this
    shape, the gap this closed)."""
    qkv, _, mask, causal = _case(_REPAIR)
    want = _f64(_pallas(_REPAIR)[0])
    with torch.inference_mode():
        new = FA.flash_attention(*qkv, causal, *BUCKETS)
        old = A.flash_attention_reference(*qkv, causal, *BUCKETS)[0]
    assert new.dtype == BF16 and old.dtype == torch.float32
    differ_new = float((_f64(new) != want).mean())
    differ_old = float((_f64(old) != want).mean())
    assert differ_new < 0.01 and differ_old > 0.5, (differ_new, differ_old)


@pytest.mark.parametrize("dh", [32, 8])
def test_scale_after_the_product(dh):
    """kanvit's tiled kernel scales the f32 product by the f32 dh^-1/2,
    where its lanes kernel scales q in bf16 by the bf16 one first: at dh 32
    and 8 the two give other scores in most places; the twin takes the
    tiled kernel's (and kanvit's bits, above)."""
    rng = np.random.default_rng(92)
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, 300, dh)).astype(np.float32))
            .to(BF16) for _ in range(2))
    assert A.bf16_scale(dh) != dh ** -0.5
    tiled = (q.float() @ k.float().transpose(-1, -2)) * torch.tensor(dh ** -0.5)
    lanes = (q * torch.tensor(A.bf16_scale(dh), dtype=BF16)).float() @ k.float().transpose(
        -1, -2)
    assert float((tiled != lanes).float().mean()) > 0.5
    _, m, _ = A.flash_attention_bf16(q, k, k, False, BUCKETS[1])
    assert torch.equal(m, tiled.amax(-1))


def test_backward_exact_is_the_f64_attention_gradient():
    """``A.flash_attention_bwd_bf16(..., exact=True)``, the f64 reference the
    card's gradients are held to, given the f64 attention's (o, m, l) of the
    same bf16 operands, is autograd's f64 gradient of causal softmax
    attention (every row sees a key; no mask), within 1e-10 of each max|g|,
    and returns f64."""
    rng = np.random.default_rng(94)
    b, h, t, dh = 1, 2, 70, 24
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32))
                   .to(BF16) for _ in range(4))
    leaves = [a.double().requires_grad_(True) for a in (q, k, v)]
    seen = torch.ones(t, t, dtype=torch.bool).tril()
    s = ((leaves[0] @ leaves[1].transpose(-1, -2)) * dh ** -0.5).masked_fill(~seen, -np.inf)
    m = s.max(-1).values
    l = torch.exp(s - m[..., None]).sum(-1)
    o = torch.softmax(s, -1) @ leaves[2]
    want = torch.autograd.grad(o, leaves, do.double())
    got = A.flash_attention_bwd_bf16(q, k, v, o.detach(), do, m.detach(), l.detach(), True,
                                     exact=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-10 * float(w.abs().max())


# --- the kernels' tiling, emulated on the CPU --------------------------------

KERNEL_KEYS = 32   # keys a streamed tile of the bf16 forward kernel


def _emu_fwd_bf16(q, k, v, maskb, causal, with_stats):
    """``kanvit_flash_attention_fwd_bf16``'s arithmetic: the twin's, over the
    kernel's 32-key tiles with its running max."""
    assert q.dtype == BF16
    keys = None if maskb is None else maskb.bool()
    o, m, l = A.flash_attention_bf16(q, k, v, causal, KERNEL_KEYS, keys)
    FA.LAUNCHES["flash_attention_bf16"] += 1
    return (o.transpose(1, 2).contiguous(),
            torch.stack([m, l], -1) if with_stats else None)


LOG2E = torch.tensor(1.44269504, dtype=torch.float32)  # the kernels' f32 log2(e)


def _kernel_bwd_bf16(q, k, v, o, do, m, l, causal, keys):
    """``A.flash_attention_bwd_bf16`` with the backward kernels' exp: exp(y)
    as 2^(y log2 e), y log2 e rounded to f32 (on the card ``ex2.approx`` of
    it, within ~2 f32 ulp of 2^x, far below p's bf16 rounding); the rest is
    the twin's, rounding for rounding."""
    b, h, tq, dh = q.shape
    scale = torch.tensor(dh ** -0.5)
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    valid, seen = A._tiled_masks(b, tq, k.shape[2], causal, keys, q.device)
    s = ((qf @ kf.transpose(-1, -2)) * scale).masked_fill(~seen, A.NEG)
    p = (torch.exp2((s - m[..., None]) * LOG2E) * (1.0 / l)[..., None]).masked_fill(~valid, 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = ((p * scale) * (dof @ vf.transpose(-1, -2) - delta)).masked_fill(~seen, 0.0)
    ds, p = (a.to(BF16).float() for a in (ds, p))
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof)
    return tuple(g.to(BF16) for g in grads)


def _emu_bwd_bf16(q, k, v, maskb, o, stats, do, causal):
    """``kanvit_flash_attention_dq_bf16`` and ``_dkv_bf16``'s arithmetic on
    the forward's (m, l): ``_kernel_bwd_bf16``."""
    assert q.dtype == o.dtype == do.dtype == BF16
    keys = None if maskb is None else maskb.bool()
    grads = _kernel_bwd_bf16(q, k, v, o.transpose(1, 2), do.transpose(1, 2), stats[..., 0],
                             stats[..., 1], causal, keys)
    FA.LAUNCHES["flash_attention_dq_bf16"] += 1
    FA.LAUNCHES["flash_attention_dkv_bf16"] += 1
    return [g.transpose(1, 2).contiguous() for g in grads]


def _emulate_bf16_kernels(monkeypatch):
    """The CUDA route on CPU tensors: bf16 tiled launches emulated above,
    bf16 lanes launches by their twins; an f32 tiled launch fails."""
    def no_f32(*a):
        raise AssertionError("an f32 tiled kernel on bf16 operands")

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
    monkeypatch.setattr(FA, "_launch_bwd_bf16", _emu_lanes_bwd_bf16)
    monkeypatch.setattr(FA, "_launch_tiled", lambda q, *a: (
        _emu_fwd_bf16(q, *a) if q.dtype == BF16 else no_f32()))
    monkeypatch.setattr(FA, "_launch_tiled_bwd", lambda q, *a: (
        _emu_bwd_bf16(q, *a) if q.dtype == BF16 else no_f32()))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_tiles_within_the_gate(monkeypatch, name):
    """The CUDA route's Functions with the bf16 kernels' tiling emulated:
    one bf16 forward, dq and dk/dv launch and nothing else; o within one
    ulp plus the two-sided p term of the twin, the gradients within the
    twin backward's gate of the twin's on the kernel forward's (o, m, l),
    and both within their gates of kanvit's kernel."""
    qkv, do, mask, causal = _case(name)
    _emulate_bf16_kernels(monkeypatch)
    o, grads = _route(qkv, do, mask, causal)
    assert {k: n for k, n in FA.LAUNCHES.items() if n} == {
        "flash_attention_bf16": 1, "flash_attention_dq_bf16": 1,
        "flash_attention_dkv_bf16": 1}
    tmask = None if mask is None else torch.from_numpy(mask)
    twin_o, m, l = A.flash_attention_bf16(*qkv, causal, BUCKETS[1], tmask)
    spread_o, _ = _spreads(qkv, do, mask, causal, twin_o, m, l)
    _gate(o, twin_o, spread_o, mid=P_TWO_SIDED)
    stats = _emu_fwd_bf16(*qkv, None if mask is None else tmask.to(torch.uint8), causal,
                          True)[1]
    want = A.flash_attention_bwd_bf16(*qkv, o, do, stats[..., 0], stats[..., 1], causal,
                                      tmask)
    spread = A.flash_attention_bwd_bf16(*qkv, o, do, stats[..., 0], stats[..., 1], causal,
                                        tmask, spread=True)
    for got, w, sp in zip(grads, want, spread):
        _gate(got, w, sp)
    want_o, want_grads, _, _ = _pallas(name)
    _gate(o, want_o, spread_o, mid=P_TWO_SIDED)
    for got, jg, sp in zip(grads, want_grads, spread):
        _gate(got, jg, sp)


def test_generic_head_dim_raises():
    """bf16 at the tiled tier takes every multiple of 8 through 128: dh 40
    runs through the CPU route and passes the card route's argument check,
    within the gates of kanvit's kernel; dh 12 and 136 raise before any
    launch, naming their ROADMAP entry. The CPU route refuses what the card
    refuses: a bf16 q with an f32 v, or a mask of another shape."""
    name = "masked_dh40"
    qkv, do, mask, causal = _case(name)
    tmask = torch.from_numpy(mask)
    with torch.inference_mode():
        o = FA.flash_attention(*qkv, causal, *BUCKETS, tmask)
    FA.check_flash_args(*qkv, tmask)
    assert o.dtype == BF16 and o.shape == qkv[0].shape
    spread_o = A.flash_attention_bf16(qkv[0], qkv[1], qkv[2].abs(), causal, BUCKETS[1],
                                      tmask)[0]
    _gate(o, _pallas(name)[0], spread_o)
    for dh in (12, 136):
        q = torch.zeros(1, 2, 300, dh, dtype=BF16)
        with pytest.raises(ValueError, match=f"head dim {dh}.*3c"):
            FA.flash_attention(q, q, q, True, *BUCKETS)
        with pytest.raises(ValueError, match=f"head dim {dh}.*3c"):
            FA.check_flash_args(q, q, q, None)
    q = torch.zeros(1, 2, 300, 40, dtype=BF16)
    with pytest.raises(TypeError, match="v must be bfloat16"):
        FA.check_flash_args(q, q, q.float(), None)
    q64 = torch.zeros(1, 2, 300, 64, dtype=BF16)
    with pytest.raises(TypeError, match="v must be bfloat16"):
        FA.flash_attention(q64, q64, q64.float(), True, *BUCKETS)
    with pytest.raises(ValueError, match="mask must be"):
        FA.flash_attention(q64, q64, q64, True, *BUCKETS, torch.ones(1, 299))
    FA.check_flash_args(q64, q64, q64, None)
    assert sum(FA.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("dh", [12, 136])
def test_head_dims_past_the_kernels_raise(monkeypatch, dh, dtype):
    """On the card's route (``use_kernel`` forced on CPU tensors) a head dim
    that is not a multiple of 8, or is past 128, raises on both tiers, in
    f32 and bf16, before any launch, naming the ROADMAP entry of the head
    dims kanvit takes and the port does not."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    lanes = torch.zeros(1, 9, 2 * dh, dtype=dtype)
    with pytest.raises(ValueError, match=f"head dim {dh}.*3c"):
        FA.flash_attention_lanes(lanes, lanes, lanes, 2)
    tiled = torch.zeros(1, 2, 600, dh, dtype=dtype)
    with pytest.raises(ValueError, match=f"head dim {dh}.*3c"):
        FA.flash_attention(tiled, tiled, tiled, True)
    assert sum(FA.LAUNCHES.values()) == 0


# --- the bf16 decoder ----------------------------------------------------------

# tier: (buckets, seq)
DECODER_TIERS = {"lanes": (None, 40), "tiled": (BUCKETS, 300)}


def _bf16_loss_jax(jmodel):
    def loss_fn(p, toks):
        p = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, p)
        logits = jmodel.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), toks[:, 1:]).mean(), logits
    return loss_fn


@pytest.mark.parametrize("tier", list(DECODER_TIERS))
def test_bf16_decoder_matches_kanvit(monkeypatch, tier):
    """``bench_decoder``'s bf16 loss on the port's decoder against kanvit's
    bf16 decoder (``benchmarks/causal_decoder.py``'s ``--bf16`` loss) on the
    same weights: logits, loss and the f32 parameters' gradients."""
    buckets, seq = DECODER_TIERS[tier]
    tokens = _tokens(2, seq, seed=91)
    jmodel = _kanvit_decoder(monkeypatch, buckets)
    params = _init(jmodel, tokens)
    (want_loss, want_logits), want_grads = jax.value_and_grad(
        _bf16_loss_jax(jmodel), has_aux=True)(params, jnp.asarray(tokens))
    assert want_logits.dtype == jnp.bfloat16

    model = _port_decoder(params, buckets)
    ttok = torch.from_numpy(tokens).long()
    loss, logits = BD.loss_and_logits(model, ttok, bf16=True)
    assert logits.dtype == BF16
    _close(logits, want_logits, LOGIT_TOL)
    _close(loss, want_loss, GRAD_TOL)
    loss.backward()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, g in want.items():
        assert grads[name].grad.dtype == torch.float32, name
        _close(grads[name].grad, g, GRAD_TOL, floor=0.0)


@pytest.mark.parametrize("tier", list(DECODER_TIERS))
def test_bf16_decoder_generic_head_dim_matches_kanvit(monkeypatch, tier):
    """The bf16 decoder at d 80 in 2 heads of 40 (the card's padded kernels),
    against kanvit's on the same weights at both tiers: logits, loss and
    every gradient at the gates above."""
    dim = 80
    buckets, seq = DECODER_TIERS[tier]
    tokens = _tokens(2, seq, seed=93)
    if buckets is not None:
        monkeypatch.setattr(jdecoder, "FlashAttentionBlock", functools.partial(
            JBlock, q_bucket_size=buckets[0], k_bucket_size=buckets[1]))
    jmodel = jdecoder.CausalDecoder(vocab=VOCAB, dim=dim, heads=HEADS, n_blocks=BLOCKS)
    params = _init(jmodel, tokens)
    (want_loss, want_logits), want_grads = jax.value_and_grad(
        _bf16_loss_jax(jmodel), has_aux=True)(params, jnp.asarray(tokens))
    model = CausalDecoder(VOCAB, dim, HEADS, BLOCKS)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    for blk in model.blocks:
        assert blk.dim_head == 40
        if buckets is not None:
            blk.q_bucket_size, blk.k_bucket_size = buckets
    loss, logits = BD.loss_and_logits(model, torch.from_numpy(tokens).long(), bf16=True)
    assert logits.dtype == BF16
    _close(logits, want_logits, LOGIT_TOL)
    _close(loss, want_loss, GRAD_TOL)
    loss.backward()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, g in want.items():
        _close(grads[name].grad, g, GRAD_TOL, floor=0.0)


def test_bf16_decoder_steps_take_the_bf16_tiled_kernels(monkeypatch):
    """Past one tile a bf16 step launches the bf16 tiled forward, dq and
    dk/dv kernels once a block and nothing else (here with 128-key buckets
    at T 300, as at T > 512 with the default ones); the loss falls."""
    _emulate_bf16_kernels(monkeypatch)
    model = BD.build_model(DIM, HEADS, BLOCKS, VOCAB, seed=4)
    for blk in model.blocks:
        blk.q_bucket_size, blk.k_bucket_size = BUCKETS
    step = BD.make_step(model, bf16=True)
    tokens = BD.make_tokens(2, 300, VOCAB)
    losses = []
    for _ in range(2):
        FA.reset_launches()
        losses.append(float(step(tokens)))
        assert {k: n for k, n in FA.LAUNCHES.items() if n} == {
            "flash_attention_bf16": BLOCKS, "flash_attention_dq_bf16": BLOCKS,
            "flash_attention_dkv_bf16": BLOCKS}
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
