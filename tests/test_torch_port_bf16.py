"""bf16 serving of the efficientkan ViT against kanvit's bf16 policy.

kanvit's Pallas kernels take bf16 operands, keep the basis and softmax maths
in f32, round to bf16 at the dot, accumulate in f32 and return bf16. The
port's plain twins follow that policy (its kernel route, not its jnp route,
which makes the B-spline basis in bf16); here each is held against kanvit's
kernel in Pallas interpret mode (``dispatch.set_impl("pallas")``) on the
same bf16 inputs, drawn with numpy from a seed:

- ``bspline_kan`` (ragged rows, row-packed and not), ``bspline_qkv_grouped``
  at 2 heads of dh 16 and 32, the lanes attention at dh 8, 32 and 64 and at
  the head dims the card runs on its padded kernels, 24, 40, 72 and 128
  (masked, causal): within one bf16 ulp elementwise, |a - b| <= 2^-7 |b| +
  2^-12 max|b|, stated before any run;
- the scale rounded to bf16 as kanvit rounds it (not exact at dh 8, 32);
- the knot grid and the position table f32 under the cast, a refit grid's
  knots rounded to bf16;
- the slice: the port's ``make_eval_step(bf16=True)`` against kanvit's under
  forced Pallas, an efficientkan ViT at the MNIST geometry with 2 blocks and
  kanvit's weights carried across, loss and logits within 2e-2 x max(1,
  max|logits|) (kanvit's own bf16 gate, ``tests/test_kernels.py:871``);
  ``Predictor`` on the bf16 model gives the eval step's logits;
- the CUDA route's wrappers with each launch emulated on the CPU: the
  launch counts of a bf16 forward (1 + 2 + 2), a backward through it going
  to the bf16 backward kernels (which raise without a card, never falling
  back), a generic head dim (40) on the bf16 lanes and tiled kernels
  against kanvit's, and mixed dtypes raising;
- the attention tier predicates against kanvit's, by itemsize, over a grid
  of shapes with vit-l's;
- the converter on a tree whose leaves are already bf16.

Small shapes; torch on one thread.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kanvit.kernels import flash_attention as JFA
from kanvit.kernels import fused_basis as JFB
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit.train.state import create_train_state as j_create_train_state
from kanvit.train.steps import make_eval_step as j_make_eval_step
from kanvit_torch.infer import Predictor
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.models import create_model
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.train import create_train_state, make_eval_step, make_train_step
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params
from test_torch_port_bf16_flash import _emu_fwd_bf16

BF16 = torch.bfloat16
ULP_REL, ULP_ABS = 2.0 ** -7, 2.0 ** -12   # one bf16 ulp, elementwise
LOGIT_TOL = 2e-2                            # x max(1, max|logits|)
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)


@pytest.fixture(autouse=True)
def one_thread_pallas():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")
    torch.set_num_threads(threads)


def _bf16(rng, shape, scale=1.0):
    """numpy f32 normals rounded to bf16: ``(torch bf16, jax bf16)``."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _one_ulp(got, want):
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


def _spline_x(rng, shape, knots):
    """Normals with entries on knots and beyond every span, in bf16."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = knots[np.arange(flat[::5].size) % knots.size]
    flat[2::7] = np.float32([-3.0, -2.2, 2.2, 3.0])[np.arange(flat[2::7].size) % 4]
    t = torch.from_numpy(x).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("n,nin,nout", [(65, 16, 40), (37, 24, 24)])
def test_bspline_kan_matches_pallas(n, nin, nout):
    """Ragged rows; nin 16 runs kanvit's row-packed kernel, 24 its plain one."""
    rng = np.random.default_rng(60)
    grid = K.make_bspline_grid(nin)
    x, jx = _spline_x(rng, (n, nin), grid[0].numpy())
    (bw, jbw), (sw, jsw), (sc, jsc) = (_bf16(rng, s, 0.3) for s in (
        (nout, nin), (nout, nin, 8), (nout, nin)))
    want = JFB.bspline_kan(jx, jnp.asarray(grid.numpy()), jbw, jsw, jsc, 3)
    assert want.dtype == jnp.bfloat16
    got = FB.bspline_kan(x, grid, bw, sw, sc)
    assert got.dtype == BF16 and grid.dtype == torch.float32
    _one_ulp(got, want)


@pytest.mark.parametrize("dh", [16, 32])
def test_bspline_qkv_grouped_matches_pallas(dh):
    rng = np.random.default_rng(61)
    h, n = 2, 45
    grid = K.make_bspline_grid(dh)
    x, jx = _spline_x(rng, (n, h * dh), grid[0].numpy())
    (bw, jbw), (sw, jsw), (sc, jsc) = (_bf16(rng, s, 0.3) for s in (
        (h, 3 * dh, dh), (h, 3 * dh, dh, 8), (h, 3 * dh, dh)))
    want = JFB.bspline_qkv_grouped(jx, jnp.asarray(grid.numpy()), jbw, jsw, jsc)
    assert want is not None and want.dtype == jnp.bfloat16
    got = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
    assert got.dtype == BF16
    _one_ulp(got, want)


def _mask(b, t):
    m = np.ones((b, t), bool)
    m[0] = False            # every row of batch item 0 is fully masked
    m[1, 0] = False         # causal: query 0 of item 1 sees no key
    m[1, 7:11] = False
    return m


@pytest.mark.parametrize("dh,heads", [(8, 3), (32, 2), (64, 2), (24, 2), (40, 2), (72, 1),
                                      (128, 1)])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_lanes_attention_matches_pallas(dh, heads, causal, masked):
    rng = np.random.default_rng(62)
    b, t = 2, 23
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, (b, t, heads * dh)) for _ in range(3))
    mask = _mask(b, t) if masked else None
    want = JFA.flash_attention_lanes(jq, jk, jv, heads, causal=causal,
                                     mask=None if mask is None else jnp.asarray(mask))
    assert want is not None and want.dtype == jnp.bfloat16
    got = FA.flash_attention_lanes(q, k, v, heads, causal=causal,
                                   mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == BF16
    _one_ulp(got, want)
    if masked:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("dh", [8, 32, 64, 40, 128])
def test_scale_rounded_as_kanvit(dh):
    exact = dh ** -0.5
    got = A.bf16_scale(dh)
    assert got == float(jnp.asarray(exact, jnp.bfloat16).astype(jnp.float32))
    assert (got == exact) == (dh == 64)


def test_grid_stays_f32_under_bf16():
    model = create_model("efficientkan", **SMALL, seed=3)
    mapper = model.linear_mapper
    refit = model.blocks[0].attn.q_mappings[1]
    with torch.no_grad():
        refit.grid.mul_(1.1).add_(0.01)
    refit.refit_grid = True
    uniform, moved = mapper.grid.clone(), refit.grid.clone()
    params = precision.bf16_params(model)
    assert all(p.dtype == BF16 for n, p in params.items() if not n.endswith(".grid"))
    assert set(params) == {n for n, _ in model.named_parameters()} | {
        "blocks.0.attn.q_mappings.1.grid"}
    assert torch.equal(params["blocks.0.attn.q_mappings.1.grid"],
                       moved.to(BF16).float())
    precision.cast_params_(model)
    assert all(p.dtype == BF16 for p in model.parameters())
    assert mapper.grid.dtype == torch.float32 and torch.equal(mapper.grid, uniform)
    assert model.pos_embeddings.dtype == torch.float32
    assert refit.grid.dtype == torch.float32
    assert torch.equal(refit.grid, moved.to(BF16).float())
    assert not torch.equal(refit.grid, moved)
    assert precision.param_dtype(model) == BF16


@pytest.fixture(scope="module")
def served():
    """kanvit's efficientkan ViT (2 blocks, MNIST geometry), its bf16 eval
    step under forced Pallas on 6 images, and the port's model on the same
    weights."""
    rng = np.random.default_rng(63)
    x = rng.standard_normal((6, *SMALL["chw"])).astype(np.float32)
    y = rng.integers(0, SMALL["out_d"], 6)
    jmodel = j_create_model("efficientkan", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(5),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        jloss, jlogits = j_make_eval_step(bf16=True)(state, jnp.asarray(x), jnp.asarray(y))
        jloss, jlogits = float(jloss), np.asarray(jlogits)
    finally:
        jdispatch.set_impl("auto")
    model = create_model("efficientkan", **SMALL, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)))
    return model, x, y, jloss, jlogits, state.params


def _logits_close(got, want):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), err


def test_eval_step_matches_kanvit(served):
    model, x, y, jloss, jlogits, _ = served
    loss, logits = make_eval_step(bf16=True)(create_train_state(model),
                                             torch.from_numpy(x), torch.from_numpy(y))
    assert logits.dtype == torch.float32 and loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())  # untouched
    _logits_close(logits.numpy(), jlogits)
    assert abs(float(loss) - jloss) <= LOGIT_TOL * max(1.0, abs(jloss))
    per, _ = make_eval_step(bf16=True, per_example=True)(
        create_train_state(model), torch.from_numpy(x), torch.from_numpy(y))
    assert per.shape == (6,) and abs(float(per.mean()) - float(loss)) <= 1e-6


def test_predictor_on_bf16_model(served):
    model, x, y, _, jlogits, _ = served
    _, want = make_eval_step(bf16=True)(create_train_state(model),
                                        torch.from_numpy(x), torch.from_numpy(y))
    bf = precision.cast_params_(copy.deepcopy(model))
    got = Predictor(bf, batch_size=6, device="cpu").logits(x)
    assert got.dtype == np.float32 and got.shape == (6, SMALL["out_d"])
    assert np.array_equal(got, want.numpy())
    _logits_close(got, jlogits)
    # a ragged tail is zero-padded to the batch as in f32
    tail = Predictor(bf, batch_size=4, device="cpu").logits(x)
    assert np.array_equal(tail[:4], Predictor(bf, 4, device="cpu").logits(x[:4]))
    # int8 serving of the bf16 model (refused until ROADMAP.md Queue 2 entry
    # 3b.6; tests/test_torch_port_int8_bf16.py holds it against kanvit)
    int8 = Predictor(bf, 4, device="cpu", quant="int8").logits(x)
    assert int8.dtype == np.float32 and int8.shape == got.shape
    assert np.isfinite(int8).all()


def test_converter_takes_a_bf16_tree(served):
    model, _, _, _, _, params = served
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    sd = state_dict_from_jax_params(tree)
    assert sd["linear_mapper.base_weight"].dtype.name == "bfloat16"
    loaded = create_model("efficientkan", **SMALL, seed=1)
    load_reference_state_dict(loaded, sd)
    for name, p in loaded.named_parameters():
        want = dict(model.named_parameters())[name].detach().to(BF16).float()
        assert p.dtype == torch.float32 and torch.equal(p.detach(), want), name


def test_bf16_training_raises():
    """bf16 training of a fused-FF model (here a fourier ViT with the fused
    FF), which raised until ROADMAP.md Queue 2 entry 3b.4 ported the fused
    FF's bf16 kernels, trains: a finite f32 loss, f32 gradients
    (tests/test_torch_port_bf16_ffn.py holds it against kanvit)."""
    model = create_model("fourier", **SMALL, seed=3, fused_ff=True)
    x = torch.zeros(2, *SMALL["chw"])
    _, loss, _ = make_train_step(bf16=True)(create_train_state(model), x,
                                            torch.zeros(2, dtype=torch.long))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters() if p.requires_grad)


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_kan_bf16(name, x2d, w, grid):
    if name == "fourierkan":  # grid: the grid size
        FB.check_fourier_args(x2d, w, grid, bf16=True)
        FB.LAUNCHES[f"{name}_bf16"] += 1
        return K.fourier_grouped_forward_bf16(x2d, w)
    FB.check_args(x2d, grid, w, FB.SPLINE_ORDER, bf16=True)
    groups, _, nin, nout = w.shape
    ys = []
    for g in range(groups):
        xg = x2d[:, g * nin:(g + 1) * nin].float()
        bases = K.bspline_bases(xg, grid[g] if grid.dim() == 3 else grid)
        a = torch.cat([bases.transpose(1, 2), F.silu(xg).unsqueeze(1)], 1)
        ys.append(a.to(BF16).float().reshape(len(xg), -1) @ w[g].float().reshape(-1, nout))
    FB.LAUNCHES[f"{name}_bf16"] += 1
    return torch.cat(ys, 1).to(BF16)


def _emu_lanes_bf16(q4, k4, v4, maskb, causal, stats=None):
    FA.LAUNCHES["flash_attention_lanes_bf16"] += 1
    mask = None if maskb is None else maskb.bool()
    return A.lanes_attention(q4, k4, v4, q4.shape[2], causal=causal, mask=mask)


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_bf16", _emu_kan_bf16)
    monkeypatch.setattr(FA, "_launch_bf16", _emu_lanes_bf16)


def test_kernel_route_serves_bf16(kernel_route, served):
    """The eval step through the wrappers: 1 embedder, 2 grouped q/k/v and 2
    lanes launches, all bf16 ones, and the plain route's logits."""
    model, x, y, _, jlogits, _ = served
    _, logits = make_eval_step(bf16=True)(create_train_state(model),
                                          torch.from_numpy(x), torch.from_numpy(y))
    counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    assert counts == {"bspline_kan_bf16": 1, "bspline_qkv_grouped_bf16": 2,
                      "flash_attention_lanes_bf16": 2}
    _logits_close(logits.numpy(), jlogits)


def test_kernel_route_backward_raises(kernel_route):
    """A backward through a bf16 forward takes the bf16 backward kernels,
    which raise here (no card), rather than fall back to the plain twins
    or to the f32 kernels."""
    rng = np.random.default_rng(64)
    grid = K.make_bspline_grid(16)
    x, _ = _spline_x(rng, (20, 16), grid[0].numpy())
    bw, sw, sc = (_bf16(rng, s, 0.3)[0].requires_grad_(True)
                  for s in ((8, 16), (8, 16, 8), (8, 16)))
    y = FB.bspline_kan(x, grid, bw, sw, sc)
    assert FB.LAUNCHES["bspline_kan_bf16"] == 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        y.float().sum().backward()
    q, k, v = (_bf16(rng, (2, 9, 32))[0].requires_grad_(True) for _ in range(3))
    o = FA.flash_attention_lanes(q, k, v, 2)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        o.float().sum().backward()
    assert bw.grad is None and q.grad is None
    assert not any(n for name, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if "bwd" in name)


def test_kernel_route_refuses(kernel_route, monkeypatch):
    """A generic head dim (40, two heads) runs on the bf16 lanes and tiled
    kernels' route (each launch emulated by its twin) within one bf16 ulp
    of kanvit's lanes and tiled kernels (the tiled o also within 2^-7 of its
    attention over |v|: the kernel rounds p against its own tiles' max);
    mixed dtypes and f32 weights under a bf16 x still raise."""
    rng = np.random.default_rng(65)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, (2, 9, 80)) for _ in range(3))
    with pytest.raises(TypeError):
        FA.flash_attention_lanes(q, k.float(), v, 2)
    assert sum(FA.LAUNCHES.values()) == 0
    got = FA.flash_attention_lanes(q, k, v, 2)
    assert got.dtype == BF16 and FA.LAUNCHES["flash_attention_lanes_bf16"] == 1
    _one_ulp(got, JFA.flash_attention_lanes(jq, jk, jv, 2))
    monkeypatch.setattr(FA, "_launch_tiled", _emu_fwd_bf16)
    heads = [a.view(2, 9, 2, 40).transpose(1, 2) for a in (q, k, v)]
    tiled = FA.flash_attention(*heads, q_block=8, k_block=8)
    assert tiled.dtype == BF16 and FA.LAUNCHES["flash_attention_bf16"] == 1
    want = JFA.flash_attention(*(jnp.transpose(a.reshape(2, 9, 2, 40), (0, 2, 1, 3))
                                 for a in (jq, jk, jv)), False, 8, 8)
    spread = A.flash_attention_bf16(heads[0], heads[1], heads[2].abs(), False, 128)[0]
    err = np.abs(_f32(tiled).astype(np.float64) - _f32(want))
    bound = (ULP_REL * np.abs(_f32(want)) + ULP_ABS * np.abs(_f32(want)).max()
             + 2.0 ** -7 * _f32(spread))
    assert (err <= bound).all()
    grid = K.make_bspline_grid(16)
    x = _bf16(rng, (5, 16))[0]
    with pytest.raises(TypeError):   # f32 weights under bf16 x
        FB.bspline_kan(x, grid, torch.ones(4, 16), torch.ones(4, 16, 8), None)
    with pytest.raises(TypeError, match="weight"):   # f32 coefficients under bf16 x
        FB.fourierkan(x, torch.ones(2, 4, 16, 5), None)
    assert FB.fourierkan(x, torch.ones(2, 4, 16, 5, dtype=BF16), None).dtype == BF16


# --- the attention tier predicates, by itemsize --------------------------------

SHAPES = [(197, 384, 6), (197, 768, 12), (197, 1024, 16), (50, 64, 8), (17, 64, 8),
          (512, 1024, 16), (300, 2048, 16), (512, 512, 8), (600, 64, 2)]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_tier_predicates_match_kanvit(itemsize):
    for (t, dm, h), (qb, kb) in itertools.product(SHAPES, [(512, 1024), (256, 256)]):
        want = JFA._lanes_ok(t, t, dm, h, itemsize) and -(-t // 128) * 128 <= min(qb, kb)
        assert FA.lanes_applicable(t, t, dm, h, qb, kb, itemsize) == want, (t, dm, h)
        dh = dm // h
        assert FA.use_small(t, t, dh, h, qb, kb, itemsize) == JFA._use_small(
            t, t, dh, h, qb, kb, itemsize), (t, dm, h)
    vit_l = FA.lanes_applicable(197, 197, 1024, 16, 512, 1024, itemsize)
    assert vit_l == (itemsize == 2)   # ~13.7 MB in f32, ~7.2 MB in bf16
