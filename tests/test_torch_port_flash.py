"""The port's tiled attention, FlashAttentionBlock and flash-attn ViT against
kanvit and the executed reference.

- ``flash_attention_reference`` against the reference's goldens (forward
  1e-5, gradients 1e-4, the goldens' own bounds in ``test_ops_parity.py``).
- ``flash_attention`` against kanvit's under ``set_impl("pallas")`` (Pallas
  interpret mode), forward 1e-5 and gradients against ``jax.grad`` 1e-5 ×
  max(1, max|g|): f32 sums of depth ≤ 40 in another order and another
  tiling (the port's plain version tiles by the buckets, kanvit's kernel by
  128-lane blocks, and the kernels by 32 keys; the per-tile 1e-10 row-sum
  clamp moves l by ~1e-10 a tile). Each gradient case runs twice: through
  autograd of the plain version (the CPU path) and through the CUDA path's
  ``torch.autograd.Function``s with each launch replaced by an emulation of
  the kernel's arithmetic (``kernel_math``).
- Tier choice: the port takes lanes / single tile / tiled exactly where
  kanvit's predicates do, which decides what a row that sees no valid key
  gets (0 on the single-tile and lanes tiers, the mean of v over the valid
  keys on the tiled tier).
- ``FlashAttentionBlock`` and the flash-attn ViT (goldens, ``apply`` and
  ``Predictor``) on the same weights, 1e-5 a layer and 1e-3 the logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.infer import Predictor as JPredictor
from kanvit.kernels import flash_attention as JFA
from kanvit.layers.attention import FlashAttentionBlock as JBlock
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.infer import Predictor
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.layers import FlashAttentionBlock
from kanvit_torch.models import create_model
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import _emu_lanes_bwd, _emu_lanes_fwd

FWD_TOL = 1e-5
GRAD_TOL = 1e-5
GOLDEN_GRAD_TOL = 1e-4
LOGIT_TOL = 1e-3
MNIST = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=64, n_heads=2,
             out_d=10)
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _close_grads(got, want, tol=GRAD_TOL):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        assert _maxdiff(a, b) <= tol * max(1.0, float(np.abs(b).max()))


# --- the plain version against the reference's goldens ---------------------

def _golden_inputs(name):
    g, _ = load_golden(name)
    mask = torch.from_numpy(g["mask"]) if "mask" in g else None
    return g, [torch.from_numpy(g[n]) for n in ("q", "k", "v")], mask


@pytest.mark.parametrize("name,causal", [("flash_attention", False),
                                         ("flash_attention_causal", True),
                                         ("flash_attention_masked", False)])
def test_reference_matches_goldens(name, causal):
    g, qkv, mask = _golden_inputs(name)
    leaves = [t.requires_grad_(True) for t in qkv]
    out, lse = A.flash_attention_reference(*leaves, causal, 16, 16, mask)
    assert _maxdiff(out.detach(), g["out"]) <= FWD_TOL
    assert lse.shape == out.shape[:3]
    if "dq" in g:  # gradients of (out ** 2).sum(), the reference's Algorithm 2
        grads = torch.autograd.grad(out.square().sum(), leaves)
        for grad, key in zip(grads, ("dq", "dk", "dv")):
            assert _maxdiff(grad, g[key]) <= GOLDEN_GRAD_TOL


@pytest.mark.parametrize("tq,tk,causal,blocks", [(37, 37, True, (16, 16)),
                                                 (24, 40, True, (512, 1024)),
                                                 (40, 24, True, (16, 8))])
def test_reference_matches_kanvit_reference(tq, tk, causal, blocks):
    """``(o, lse)`` of kanvit's plain reference, with a partly and a fully
    masked batch item."""
    from kanvit.ops.attention import flash_attention_reference as JRef

    rng = np.random.default_rng(60)
    q = rng.standard_normal((2, 2, tq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, tk, 16)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, tk), bool)
    mask[0, :4] = False
    mask[1] = False
    want_o, want_lse = JRef(*map(jnp.asarray, (q, k, v)), causal, *blocks,
                            mask=jnp.asarray(mask))
    got_o, got_lse = A.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal, *blocks, torch.from_numpy(mask))
    assert _maxdiff(got_o, want_o) <= FWD_TOL
    lse_ok = np.isclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-6, atol=1e-5)
    assert lse_ok.all()


# --- flash_attention against the Pallas kernels -----------------------------

def _emu_scores(q, k, maskb, causal):
    """Scores, causal visibility and key validity as the kernels compute
    them; ``q, k``: (B, H, T, dh)."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    s = (q * dh ** -0.5) @ k.transpose(-1, -2)
    qpos = torch.arange(tq) - max(tk - tq, 0)
    vis = (qpos[:, None] >= torch.arange(tk)[None, :]) if causal else (
        torch.ones(tq, tk, dtype=torch.bool))
    valid = (torch.ones(b, 1, 1, tk, dtype=torch.bool) if maskb is None
             else maskb.bool()[:, None, None, :])
    return s, vis, valid


def _emu_tiled_fwd(q, k, v, maskb, causal, with_stats):
    """``kanvit_flash_attention_fwd``'s arithmetic on the CPU."""
    b, h, tq, dh = q.shape
    s, vis, valid = _emu_scores(q, k, maskb, causal)
    s = torch.where(valid & vis, s, NEG)
    m = torch.full((b, h, tq, 1), NEG)
    l = torch.zeros(b, h, tq, 1)
    acc = torch.zeros(b, h, tq, dh)
    for k0 in range(0, k.shape[2], 32):
        sl = s[..., k0:k0 + 32]
        mt = torch.maximum(m, sl.amax(-1, keepdim=True))
        corr = torch.exp(m - mt)
        p = torch.where(valid[..., k0:k0 + 32], torch.exp(sl - mt), 0.0)
        l = corr * l + p.sum(-1, keepdim=True).clamp_min(1e-10)
        acc = acc * corr + p @ v[:, :, k0:k0 + 32]
        m = mt
    l = l.clamp_min(1e-10)
    FA.LAUNCHES["flash_attention"] += 1
    stats = torch.cat([m, l], -1) if with_stats else None
    return (acc / l).transpose(1, 2).contiguous(), stats


def _emu_tiled_bwd(q, k, v, maskb, o, stats, do, causal):
    """``kanvit_flash_attention_dq`` and ``_dkv``'s arithmetic on the CPU."""
    dh = q.shape[-1]
    s, vis, valid = _emu_scores(q, k, maskb, causal)
    p = torch.where(valid, torch.exp(torch.where(vis, s, NEG) - stats[..., :1])
                    / stats[..., 1:], 0.0)
    do4, o4 = do.transpose(1, 2), o.transpose(1, 2)
    delta = (do4 * o4).sum(-1, keepdim=True)
    ds = torch.where(vis, p * (do4 @ v.transpose(-1, -2) - delta), 0.0)
    dq = ds @ k * dh ** -0.5
    dk = ds.transpose(-1, -2) @ (q * dh ** -0.5)
    dv = p.transpose(-1, -2) @ do4
    FA.LAUNCHES["flash_attention_dq"] += 1
    FA.LAUNCHES["flash_attention_dkv"] += 1
    return [g.transpose(1, 2).contiguous() for g in (dq, dk, dv)]


def _emulate_kernels(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    monkeypatch.setattr(FA, "_launch_tiled", _emu_tiled_fwd)
    monkeypatch.setattr(FA, "_launch_tiled_bwd", _emu_tiled_bwd)


@pytest.fixture(params=["plain", "kernel_math"])
def grad_path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: the CUDA path's Functions
    with each launch emulated on the CPU."""
    if request.param == "kernel_math":
        _emulate_kernels(monkeypatch)
    return request.param


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
    "single_tile": (2, 2, 20, 20, 16, True, [range(5), range(20)], (512, 1024)),
}


def _case_inputs(name):
    b, h, tq, tk, dh, causal, masked, blocks = CASES[name]
    rng = np.random.default_rng(61)
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


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_pallas(grad_path, name):
    (q, k, v), g, mask, causal, blocks = _case_inputs(name)
    want_o, want = _pallas(name)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = FA.flash_attention(*leaves, causal, *blocks, tmask)
    got = [t.numpy() for t in torch.autograd.grad(out, leaves, torch.from_numpy(g))]
    assert out.shape == q.shape
    assert _maxdiff(out.detach(), want_o) <= FWD_TOL
    _close_grads(got, want)
    small = name == "single_tile"
    assert FA.use_small(q.shape[2], k.shape[2], q.shape[3], q.shape[1], *blocks) == small
    if grad_path == "kernel_math":
        want_counts = ({"flash_attention_lanes": 1, "flash_attention_lanes_bwd": 1}
                       if small else {"flash_attention": 1, "flash_attention_dq": 1,
                                      "flash_attention_dkv": 1})
        assert {k_: n for k_, n in FA.LAUNCHES.items() if n} == want_counts
    else:
        assert sum(FA.LAUNCHES.values()) == 0


@pytest.mark.parametrize("grad_path_", ["plain", "kernel_math"])
def test_rows_with_no_visible_key(grad_path_, monkeypatch):
    """B 1, H 2, T 24, dh 32, causal, keys 0-3 masked: on the tiled tier
    rows 0-3 are the mean of v over keys 4-23 (later keys included); on the
    single-tile tier they are 0. kanvit's two Pallas tiers agree."""
    if grad_path_ == "kernel_math":
        _emulate_kernels(monkeypatch)
    rng = np.random.default_rng(62)
    q, k, v = (rng.standard_normal((1, 2, 24, 32)).astype(np.float32) for _ in range(3))
    mask = np.ones((1, 24), bool)
    mask[0, :4] = False
    for blocks in ((16, 16), (512, 1024)):
        want = np.asarray(JFA.flash_attention(*map(jnp.asarray, (q, k, v)), True,
                                              *blocks, jnp.asarray(mask)))
        with torch.inference_mode():
            got = FA.flash_attention(*map(torch.from_numpy, (q, k, v)), True,
                                     *blocks, torch.from_numpy(mask)).numpy()
        assert _maxdiff(got, want) <= FWD_TOL
        rows = got[0, :, :4]
        if blocks == (16, 16):
            uniform = v[0, :, 4:].mean(axis=1)  # (H, dh)
            assert _maxdiff(rows, np.broadcast_to(uniform[:, None], rows.shape)) <= FWD_TOL
        else:
            assert np.all(rows == 0)


# (t, tk, dh, h, q_block, k_block)
SHAPES = [
    (20, 20, 16, 2, 512, 1024),    # lanes / single tile
    (20, 20, 16, 2, 16, 16),       # explicit small buckets: tiled
    (24, 40, 16, 2, 512, 1024),    # tq != tk: tiled
    (197, 197, 64, 6, 512, 1024),  # vit-s: lanes in the block, tiled alone
    (500, 500, 16, 3, 512, 1024),  # the block's lanes tier up to 512 tokens
    (512, 512, 64, 4, 512, 1024),  # lanes' VMEM bound: tiled
    (600, 600, 16, 2, 512, 1024),  # past one tile
    (128, 128, 32, 2, 128, 128),   # one 128-bucket tile
    (129, 129, 32, 2, 128, 1024),  # just past it
]


@pytest.mark.parametrize("t,tk,dh,h,qb,kb", SHAPES)
def test_tier_choice_matches_kanvit(monkeypatch, t, tk, dh, h, qb, kb):
    """The port's predicates are kanvit's, and the port routes by them:
    ``flash_attention`` to the single-tile (lanes) kernels or the tiled
    ones, ``FlashAttentionBlock`` to the lanes attention or
    ``flash_attention``."""
    small = JFA._use_small(t, tk, dh, h, qb, kb, 4)
    assert FA.use_small(t, tk, dh, h, qb, kb) == small
    dm = h * dh
    lanes = jax.eval_shape(lambda q, k, v: JFA.flash_attention_lanes(
        q, k, v, h, q_block=qb, k_block=kb),
        jax.ShapeDtypeStruct((1, t, dm), jnp.float32),
        *[jax.ShapeDtypeStruct((1, tk, dm), jnp.float32)] * 2) is not None
    assert FA.lanes_applicable(t, tk, dm, h, qb, kb) == lanes

    _emulate_kernels(monkeypatch)
    q = torch.zeros(1, h, t, dh)
    kv = torch.zeros(1, h, tk, dh)
    with torch.inference_mode():
        FA.flash_attention(q, kv, kv, True, qb, kb)
    routed = {key for key, n in FA.LAUNCHES.items() if n}
    assert routed == ({"flash_attention_lanes"} if small else {"flash_attention"})

    calls = []
    for fn in ("flash_attention_lanes", "flash_attention"):
        monkeypatch.setattr(FA, fn, functools.partial(
            lambda name, real, *a, **kw: calls.append(name) or real(*a, **kw),
            fn, getattr(FA, fn)))
    blk = FlashAttentionBlock(dm, h, dh, q_bucket_size=qb, k_bucket_size=kb)
    with torch.inference_mode():
        blk(torch.zeros(1, t, dm), context=None if t == tk else torch.zeros(1, tk, dm))
    assert calls[0] == ("flash_attention_lanes" if lanes else "flash_attention")


@pytest.mark.parametrize("bad,err,match", [
    ("dtype", TypeError, "k must be float32"),
    ("headdim", ValueError, "head dim"),
    ("shapes", ValueError, r"\(B, H, Tk, dh\)"),
    ("mask", ValueError, "mask must be"),
    ("nokeys", ValueError, "at least one key"),
])
def test_flash_kernel_arg_checks(bad, err, match):
    q = torch.zeros(2, 3, 5, 16)
    k = v = torch.zeros(2, 3, 7, 16)
    mask = None
    if bad == "dtype":
        k = k.double()
    elif bad == "headdim":
        q, k, v = torch.zeros(2, 3, 5, 12), torch.zeros(2, 3, 7, 12), torch.zeros(2, 3, 7, 12)
    elif bad == "shapes":
        v = torch.zeros(2, 3, 6, 16)
    elif bad == "mask":
        mask = torch.ones(2, 5)
    elif bad == "nokeys":
        k = v = torch.zeros(2, 3, 0, 16)
    with pytest.raises(err, match=match):
        FA.check_flash_args(q, k, v, mask)
    FA.check_flash_args(torch.zeros(2, 7, 3, 16).transpose(1, 2),
                        torch.zeros(2, 3, 7, 16), torch.zeros(2, 3, 7, 16),
                        torch.ones(2, 7))


def test_tiled_kernel_reads_strided_views(monkeypatch):
    """``(B, T, H, dh)`` projections viewed as ``(B, H, T, dh)`` reach the
    tiled launch with their strides, uncopied, and give the contiguous
    inputs' result."""
    _emulate_kernels(monkeypatch)
    seen = []
    monkeypatch.setattr(FA, "_launch_tiled", lambda q, *a: seen.append(q.stride())
                        or _emu_tiled_fwd(q, *a))
    y = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (2, 40, 3 * 2 * 16)).astype(np.float32))
    q, k, v = (a.view(2, 40, 2, 16).transpose(1, 2) for a in y.chunk(3, dim=-1))
    with torch.inference_mode():
        got = FA.flash_attention(q, k, v, True, 16, 16)
        want = FA.flash_attention(*(a.contiguous() for a in (q, k, v)), True, 16, 16)
    assert seen[0] == q.stride() == (40 * 96, 16, 96, 1)
    assert torch.equal(got, want)


# --- FlashAttentionBlock and the flash-attn ViT -----------------------------

def _block_params(blk):
    return {name: {"weight": getattr(blk, name).weight.detach().numpy()}
            for name in ("to_q", "to_kv", "to_out")}


@pytest.mark.parametrize("causal,masked,context,buckets", [
    (False, False, None, None),        # lanes
    (True, True, None, None),          # lanes, rows with no visible key -> 0
    (True, True, None, (16, 16)),      # tiled, the same rows -> mean of v
    (False, True, 19, None),           # cross-attention, tk != t: tiled
    (True, False, 13, (16, 16)),       # causal cross-attention, qpos < 0 rows
])
def test_flash_block_matches_kanvit(causal, masked, context, buckets):
    rng = np.random.default_rng(64)
    dim, heads, dh, t = 32, 2, 16, 13
    x = rng.standard_normal((2, t, dim)).astype(np.float32)
    ctx = None if context is None else rng.standard_normal(
        (2, context, dim)).astype(np.float32)
    tk = t if context is None else context
    mask = None
    if masked:
        mask = np.ones((2, tk), bool)
        mask[0, :3] = False
        mask[1, 5:] = False
    qb, kb = buckets or (None, None)
    blk = FlashAttentionBlock(dim, heads, dh, causal=causal,
                              generator=torch.Generator().manual_seed(5))
    jblk = JBlock(dim, heads, dh, causal=causal)
    want = jblk.apply({"params": _block_params(blk)}, jnp.asarray(x),
                      None if ctx is None else jnp.asarray(ctx),
                      None if mask is None else jnp.asarray(mask), qb, kb)
    with torch.inference_mode():
        got = blk(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx),
                  None if mask is None else torch.from_numpy(mask), qb, kb)
    assert got.shape == (2, t, dim)
    assert _maxdiff(got, want) <= FWD_TOL


def test_flash_block_refuses_ring_attention():
    with pytest.raises(NotImplementedError, match="ring attention"):
        FlashAttentionBlock(32, 2, seq_axis="data")


def test_flash_vit_golden():
    g, sd = load_golden("model_flash-attn")
    model = create_model("flash-attn", **MNIST)
    load_reference_state_dict(model, sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(g["x"])).numpy()
    assert _maxdiff(got, g["y"]) <= LOGIT_TOL


@pytest.fixture(scope="module")
def flash_vit():
    """A flash-attn ViT drawn by the port, its weights as a kanvit tree, and
    a batch of images."""
    model = create_model("flash-attn", **MNIST, seed=8)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    x = np.random.default_rng(65).standard_normal((5, 1, 28, 28)).astype(np.float32)
    return model, params_from_torch_state_dict(sd), x


def test_flash_vit_matches_kanvit_apply(flash_vit):
    _, params, x = flash_vit
    want = np.asarray(jax.jit(j_create_model("flash-attn", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("flash-attn", **MNIST, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_flash_vit_predictor_matches_kanvit(flash_vit):
    model, params, x = flash_vit
    want = JPredictor(j_create_model("flash-attn", **MNIST), params, 4).logits(x)
    got = Predictor(model, 4, device="cpu").logits(x)
    assert got.shape == want.shape == (5, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL


def test_flash_vit_converter_matches_torch_compat_bytes(flash_vit):
    _, params, _ = flash_vit
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_flash_vit_gradients_take_the_lanes_kernels(monkeypatch):
    """The flash-attn ViT at T = 50 runs every block on the lanes kernels,
    forward and backward, and never the tiled ones."""
    _emulate_kernels(monkeypatch)
    model = create_model("flash-attn", **MNIST)
    x = torch.from_numpy(np.random.default_rng(66).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert {k: n for k, n in FA.LAUNCHES.items() if n} == {
        "flash_attention_lanes": 2, "flash_attention_lanes_bwd": 2}
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())


def test_flash_vit_trains_through_the_bench():
    """``kanvit_torch.bench --model-type flash-attn`` trains the flash-attn
    ViT (here on the CPU at the reference preset) and prints bench.py's
    metric for it."""
    from kanvit_torch import bench

    out = bench.run(bench.parse_args([
        "--device", "cpu", "--model-type", "flash-attn", "--preset", "reference",
        "--batch-size", "8", "--steps", "2", "--windows", "1", "--warmup", "1"]))
    assert out["metric"] == "mnist_flash-attn_train_images_per_sec_per_chip"
    assert out["value"] > 0 and out["batch_size"] == 8
