"""bf16 serving and training of the Chebyshev ViT against kanvit's bf16 policy.

kanvit's Pallas kernels (``_fwd_kernel`` / ``_bwd_kernel`` with
``cheby_family``) take bf16 operands, make T_n(tanh x) and its derivative in
f32 from the upcast x, round T to bf16 at each dot, accumulate in f32 and
round y, dx and dW once. The port's plain twins
(``K.cheby_grouped_forward_bf16``, ``K.cheby_grouped_backward_bf16``) follow
that policy, and are the CPU route of a bf16 ``chebykan`` and
``cheby_qkv_grouped``; here each is held against kanvit's kernel in Pallas
interpret mode (``dispatch.set_impl("pallas")``) on the same bf16 inputs,
drawn with numpy from a seed, with a share of x where tanh rounds to +-1.
The gates, stated before any run: one bf16 ulp elementwise, |a - b| <=
2^-7 |b| + 2^-12 max|b|, plus one bf16 ulp of each rounded intermediate
weighted as the next product weighs it: 2^-8 |T| |W| for y
(``cheby_fwd_spread_bf16``) and 2^-8 |T|^T |gy| for dW
(``cheby_dw_spread_bf16``); dx rounds once from f32, one ulp.

- ``chebykan``: ragged rows, row-packed nin 16 and plain nin 24, forward
  and backward; ``cheby_qkv_grouped``: 2 heads of dh 16 and 32;
- below 32 packed rows kanvit's backward takes its block-diagonal fallback,
  whose ``_unpack_dw`` sums the 8 row slots' dW in bf16: the gap from the
  port's one rounding, for B-spline and Chebyshev at nin 16, held within
  kanvit's bf16 gradient gate, 5e-2 x max(1, max|g|);
- the slice: ``make_eval_step(bf16=True)`` and ``Predictor`` against
  kanvit's bf16 eval step (logits within 2e-2 x max(1, max|logits|)), the
  train step against ``jax.grad`` (``test_torch_port_bf16_train.py``'s
  ``test_train_step_matches_kanvit``, whose kinds include cheby), and
  ``grad_accum=2``, at the MNIST geometry with 2 blocks and kanvit's weights;
  the CPU route never runs ``K.chebykan_forward`` on bf16;
- the CUDA route's wrappers with each launch emulated on the CPU: a bf16
  step's launches (1 + 2 + 2 bf16 forwards and backwards), the embedder's
  no-dx route, the plain route's bits, and a raise, not a fall-back, where
  the launch itself cannot run;
- the bf16 step's casts (``precision.bf16_params``): the same loss and
  every f32 ``.grad`` bit for bit as a cast of each parameter written here,
  the parameters views of one flat buffer, their gradients of another.

Small shapes; torch on one thread.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.train.state import create_train_state as j_create_train_state
from kanvit.train.steps import make_eval_step as j_make_eval_step
from kanvit_torch.infer import Predictor
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.train import create_train_state, make_eval_step, make_train_step
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params
from test_torch_port_bf16_train import (
    _batch,
    _emu_kan_bf16,
    _emu_kan_bwd_bf16,
    _emu_lanes_bf16,
    _emu_lanes_bwd_bf16,
    _grads_close,
    _kanvit_bf16,
    _leaves,
    _port_model,
    _spline_x,
    _vjp,
)

BF16 = torch.bfloat16
ULP_REL, ULP_ABS, ULP_MID = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
LOGIT_TOL = 2e-2  # x max(1, max|logits|), kanvit's bf16 gate
GRAD_TOL = 5e-2   # x max(1, max|g|), kanvit's bf16 gradient gate
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


def _pair(a: np.ndarray):
    """numpy f32 rounded to bf16: ``(torch bf16, jax bf16)``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _cheby_x(rng, shape, saturated=0.15):
    """Normals with a share where tanh(x) rounds to +-1 (|x| in [9.5, 20])."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = rng.uniform(9.5, 20.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)
    return _pair(x)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _gate(got, want, spread=None):
    """One bf16 ulp of the output, plus 2^-8 of ``spread``."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    if spread is not None:
        bound = bound + ULP_MID * _f64(spread)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


# --- the twins against kanvit's Pallas kernels -------------------------------

@pytest.mark.parametrize("n,nin,nout", [(261, 16, 40), (37, 24, 24)])
def test_chebykan_matches_pallas(n, nin, nout):
    """nin 16 runs kanvit's row-packed kernel (8 rows a kernel row, 33 of
    them), 24 its plain one; ragged rows either way. Forward, dx and the
    coefficients' gradient."""
    rng = np.random.default_rng(90)
    (x, jx), (cc, jcc) = _cheby_x(rng, (n, nin)), _pair(
        rng.standard_normal((nin, nout, 5)) * 0.3)
    gy, jgy = _pair(rng.standard_normal((n, nout)))
    want, (jdx, jdcc) = _vjp(JFB.chebykan, (jx, jcc), jgy)
    assert want.dtype == jdx.dtype == jdcc.dtype == jnp.bfloat16
    tx, tcc = _leaves(x, cc)
    y = FB.chebykan(tx, tcc)
    y.backward(gy)
    assert y.dtype == tx.grad.dtype == tcc.grad.dtype == BF16
    w = FB.pack_cheby_weight(cc).contiguous()
    _gate(y, want, K.cheby_fwd_spread_bf16(x, w))
    _gate(tx.grad, jdx)
    _gate(tcc.grad, jdcc, K.cheby_dw_spread_bf16(x, w, gy)[0].permute(1, 2, 0))
    assert (tx.grad[x.float().abs() >= 9.5] == 0).all()  # T' (1 - t^2) = 0 there


@pytest.mark.parametrize("dh", [16, 32])
def test_cheby_qkv_grouped_matches_pallas(dh):
    rng = np.random.default_rng(91)
    h, n = 2, 45
    (x, jx), (cc, jcc) = _cheby_x(rng, (n, h * dh)), _pair(
        rng.standard_normal((h, dh, 3 * dh, 5)) * 0.3)
    gy, jgy = _pair(rng.standard_normal((n, h * 3 * dh)))
    assert JFB.cheby_qkv_grouped(jx, jcc) is not None  # kanvit's slot-grouped kernel
    want, (jdx, jdcc) = _vjp(JFB.cheby_qkv_grouped, (jx, jcc), jgy)
    tx, tcc = _leaves(x, cc)
    y = FB.cheby_qkv_grouped(tx, tcc)
    y.backward(gy)
    assert y.dtype == tx.grad.dtype == tcc.grad.dtype == BF16
    w = FB.pack_cheby_qkv_weight(cc).contiguous()
    _gate(y, want, K.cheby_fwd_spread_bf16(x, w))
    _gate(tx.grad, jdx)
    _gate(tcc.grad, jdcc, K.cheby_dw_spread_bf16(x, w, gy).permute(0, 2, 3, 1))


def test_twins_follow_the_kernel_route_bits():
    """The CPU route is the twins on the packed weight, bit for bit, and
    their f64 form sums the same rounded operands."""
    rng = np.random.default_rng(92)
    x, _ = _cheby_x(rng, (30, 24))
    cc, _ = _pair(rng.standard_normal((24, 12, 5)) * 0.3)
    w = FB.pack_cheby_weight(cc).contiguous()
    y = FB.chebykan(x, cc)
    assert torch.equal(y, K.cheby_grouped_forward_bf16(x, w))
    exact = K.cheby_grouped_forward_bf16(x, w, exact=True)
    t = K.cheby_bases(x.float(), 4).to(BF16).double()
    assert exact.dtype == torch.float64
    assert torch.allclose(exact, t.reshape(30, -1) @ cc.double().permute(0, 2, 1).reshape(-1, 12),
                          rtol=1e-12, atol=1e-12)


def test_bf16_forward_scratch_follows_the_entry():
    """The wrapper sizes the bf16 forward's split W for the entry's shape:
    ``kanvit_cheby_tc_fwd_bf16`` takes B-spline's bf16 rule (192 outputs a
    block past 64, not the f32 Chebyshev forward's 64 at every width), three
    16-deep steps of bf16 pairs a stage."""
    src = (Path(FB.__file__).parent / "csrc" / "kan_basis.cu").read_text()
    entry = src[src.index('extern "C" int kanvit_cheby_tc_fwd_bf16'):]
    assert "launch_tc_grouped_fwd<Cheby, CHEBY_BF16_WARPS, CHEBY_BF16_MINB, false, 0, Bf16>" \
        in entry[:entry.index("}")]
    for nout, outs in ((384, 192), (192, 192), (70, 192), (64, 64), (24, 64)):
        assert FB.tc_fwd_outs("cheby", nout, bf16=True) == outs
        w = torch.zeros(2, 5, 768, nout, dtype=BF16)
        words = FB._tc_grouped_fwd_scratch(w, "cpu", "cheby", bf16=True).numel()
        assert words == 2 * -(-nout // outs) * (768 // 8) * 3 * outs * 4 * 2
    assert FB.tc_fwd_outs("cheby", 384) == 64   # the f32 forward's tiles stay


# --- below 32 packed rows: kanvit's block-diagonal fallback ------------------

# The largest gap, relative to max(1, max|g|), between the port's dW (one
# rounding of the f32 sum over all the rows) and kanvit's below 32 packed
# rows (each of the 8 row slots' dW rounded to bf16, then summed in bf16):
# 5.8e-3 for B-spline and 6.0e-3 for Chebyshev at these inputs, within
# kanvit's own gate of 5e-2, where at 33 packed rows (kanvit's kernel tier)
# the twins agree within one bf16 ulp plus the rounded basis's term.
@pytest.mark.parametrize("family", ["bspline", "cheby"])
def test_small_shape_bwd_gap_to_kanvits_fallback(family):
    """150 rows at nin 16 are 19 rows of 8 packed slots, fewer than 32:
    kanvit's backward falls back to the block-diagonal form and
    ``_unpack_dw`` (``kanvit/kernels/fused_basis.py:1108-1117, 1139-1142``).
    The port keeps its one rounding; the gap is stated and held within
    kanvit's bf16 gradient gate, and dx (no such sum) within one ulp."""
    rng = np.random.default_rng(93)
    n, nin, nout = 150, 16, 40
    gy, jgy = _pair(rng.standard_normal((n, nout)))
    if family == "bspline":
        grid = K.make_bspline_grid(nin)
        jgrid = jnp.asarray(grid.numpy())
        x, jx = _spline_x(rng, (n, nin), grid[0].numpy())
        (bw, jbw), (sw, jsw) = (_pair(rng.standard_normal(s) * 0.3)
                                for s in ((nout, nin), (nout, nin, 8)))
        _, (jdx, jdbw, jdsw) = _vjp(lambda *a: JFB.bspline_kan(a[0], jgrid, a[1], a[2], None,
                                                               3), (jx, jbw, jsw), jgy)
        tx, tbw, tsw = _leaves(x, bw, sw)
        FB.bspline_kan(tx, grid, tbw, tsw, None).backward(gy)
        pairs = ((tbw.grad, jdbw), (tsw.grad, jdsw))
    else:
        (x, jx), (cc, jcc) = _cheby_x(rng, (n, nin)), _pair(
            rng.standard_normal((nin, nout, 5)) * 0.3)
        _, (jdx, jdcc) = _vjp(JFB.chebykan, (jx, jcc), jgy)
        tx, tcc = _leaves(x, cc)
        FB.chebykan(tx, tcc).backward(gy)
        pairs = ((tcc.grad, jdcc),)
    _gate(tx.grad, jdx)
    gap = max(float(np.abs(_f64(g) - _f64(j)).max()) / max(1.0, float(np.abs(_f64(j)).max()))
              for g, j in pairs)
    assert 0 < gap <= GRAD_TOL, gap


# --- the slice -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """kanvit's cheby ViT (2 blocks, MNIST geometry), its bf16 eval step
    under forced Pallas on 6 images, and the port's model on its weights."""
    rng = np.random.default_rng(94)
    x = rng.standard_normal((6, *SMALL["chw"])).astype(np.float32)
    y = rng.integers(0, SMALL["out_d"], 6)
    jmodel = j_create_model("cheby", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(8),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        jloss, jlogits = j_make_eval_step(bf16=True)(state, jnp.asarray(x), jnp.asarray(y))
        jloss, jlogits = float(jloss), np.asarray(jlogits)
    finally:
        jdispatch.set_impl("auto")
    model = create_model("cheby", **SMALL, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)))
    return model, x, y, jloss, jlogits


def _logits_close(got, want):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), err


def test_eval_step_and_predictor_match_kanvit(served, monkeypatch):
    """The bf16 eval step and ``Predictor`` on a bf16 copy against kanvit's
    bf16 eval step; neither reaches ``K.chebykan_forward`` (the jnp route,
    which makes the basis in bf16)."""
    model, x, y, jloss, jlogits = served

    def refuse(*a, **k):
        raise AssertionError("K.chebykan_forward ran on the bf16 route")

    monkeypatch.setattr(K, "chebykan_forward", refuse)
    loss, logits = make_eval_step(bf16=True)(create_train_state(model),
                                             torch.from_numpy(x), torch.from_numpy(y))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _logits_close(logits.numpy(), jlogits)
    assert abs(float(loss) - jloss) <= LOGIT_TOL * max(1.0, abs(jloss))
    bf = precision.cast_params_(copy.deepcopy(model))
    got = Predictor(bf, batch_size=6, device="cpu").logits(x)
    assert np.array_equal(got, logits.numpy())


def test_grad_accum_bf16_matches_one_chunk():
    """Two chunks of 3 images: the f32 .grad sums the chunks' gradients,
    divided by 2, within the slice's gate of the one-chunk step's."""
    params, _, _ = _kanvit_bf16("cheby")
    x, y = _batch(78)
    one, two = _port_model("cheby", params), _port_model("cheby", params)
    _, loss1, _ = make_train_step(bf16=True)(create_train_state(one), x, y)
    _, loss2, logits2 = make_train_step(bf16=True, grad_accum=2)(create_train_state(two), x, y)
    assert logits2.shape == (6, SMALL["out_d"])
    assert abs(float(loss2) - float(loss1)) <= 2e-2 * max(1.0, abs(float(loss1)))
    _grads_close({k: p.grad for k, p in two.named_parameters()},
                 {k: p.grad.numpy() for k, p in one.named_parameters()})


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_cheby_bf16(name, x2d, w, aux):
    if FB.BF16_FAMILY.get(name) != "cheby":
        return _emu_kan_bf16(name, x2d, w, aux)
    FB.check_cheby_args(x2d, w, aux, bf16=True)
    FB.LAUNCHES[f"{name}_bf16"] += 1
    return K.cheby_grouped_forward_bf16(x2d, w)


def _emu_cheby_bwd_bf16(asked):
    def launch(name, x2d, w, aux, gy, need_dx, need_dw):
        FB.check_cheby_args(x2d, w, aux, bf16=True)
        assert gy.dtype == BF16
        asked.append((name, need_dx, need_dw))
        FB.LAUNCHES[f"{name}_bwd_bf16"] += 1
        return K.cheby_grouped_backward_bf16(x2d, w, gy, need_dx, need_dw)
    return launch


def test_kernel_route_trains_bf16(monkeypatch):
    """A bf16 cheby step through the wrappers: 1 embedder, 2 grouped q/k/v
    and 2 lanes launches forward and as many backward, all bf16 ones and no
    f32 KAN or attention launch; the embedder asked for dW alone; the plain
    route's gradients and updated parameters, bit for bit."""
    x, y = _batch(95)
    plain = create_model("cheby", **SMALL, seed=11)
    routed = create_model("cheby", **SMALL, seed=11)
    make_train_step(bf16=True)(create_train_state(plain), x, y)
    asked = []
    with monkeypatch.context() as m:
        m.setattr(dispatch, "use_kernel", lambda t: True)
        m.setattr(FB, "_launch_bf16", _emu_cheby_bf16)
        m.setattr(FB, "_launch_bwd_bf16", _emu_cheby_bwd_bf16(asked))
        m.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
        m.setattr(FA, "_launch_bwd_bf16", _emu_lanes_bwd_bf16)
        make_train_step(bf16=True)(create_train_state(routed), x, y)
    counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    assert counts == {"chebykan_bf16": 1, "cheby_qkv_grouped_bf16": 2,
                      "flash_attention_lanes_bf16": 2, "chebykan_bwd_bf16": 1,
                      "cheby_qkv_grouped_bwd_bf16": 2, "flash_attention_lanes_bwd_bf16": 2}
    assert asked.count(("chebykan", False, True)) == 1
    assert asked.count(("cheby_qkv_grouped", True, True)) == 2
    for (name, p), q in zip(plain.named_parameters(), routed.parameters()):
        assert p.grad.dtype == q.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_kernel_route_raises_rather_than_falls_back(monkeypatch):
    """With the forwards emulated, the backward goes to the bf16 Chebyshev
    kernels, which cannot launch without a card: it raises, and no plain
    twin or f32 kernel runs instead."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(FB, "_launch_bf16", _emu_cheby_bf16)
    rng = np.random.default_rng(96)
    x, _ = _cheby_x(rng, (20, 16))
    cc = _pair(rng.standard_normal((16, 8, 5)))[0].requires_grad_(True)
    y = FB.chebykan(x, cc)
    assert y.dtype == BF16 and FB.LAUNCHES["chebykan_bf16"] == 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        y.float().sum().backward()
    assert cc.grad is None
    assert not any(n for name, n in FB.LAUNCHES.items() if "bwd" in name)
    with pytest.raises(TypeError):   # f32 coefficients under a bf16 x
        FB.chebykan(x, cc.detach().float())
    with pytest.raises(ValueError, match="degree"):
        FB._launch_bwd_bf16("chebykan", x, FB.pack_cheby_weight(cc.detach()).contiguous(),
                            3, x[:, :8], True, True)


# --- the bf16 step's casts ---------------------------------------------------------

def _per_parameter_casts(model):
    """The casts as one operation a parameter each way: every f32
    parameter's own ``.to(bf16)``, refit grids rounded."""
    out = {name: p.to(BF16) if p.dtype == torch.float32 else p
           for name, p in model.named_parameters()}
    out.update({name: g.to(BF16).float() for name, g in precision._refit_grids(model)})
    return out


@pytest.mark.parametrize("kind,grad_accum", [("cheby", 1), ("efficientkan", 1),
                                             ("cheby", 2)])
def test_flat_casts_match_per_parameter_casts(monkeypatch, kind, grad_accum):
    """The flat-buffer casts give the loss, the logits, every f32 ``.grad``
    and the updated parameters of per-parameter casts bit for bit, over two
    steps; the parameters become views of one flat f32 buffer (their names
    and objects unchanged) and their gradients views of one flat buffer."""
    x, y = _batch(97)
    ref = create_model(kind, **SMALL, seed=12)
    new = copy.deepcopy(ref)
    objects = [p for p in new.parameters()]
    step = make_train_step(bf16=True, grad_accum=grad_accum)
    with monkeypatch.context() as m:
        m.setattr(precision, "bf16_params", _per_parameter_casts)
        ref_state = create_train_state(ref)
        want = [step(ref_state, x, y)[1:] for _ in range(2)]
        want_grads = {k: p.grad.clone() for k, p in ref.named_parameters()}
    new_state = create_train_state(new)
    got = [step(new_state, x, y)[1:] for _ in range(2)]
    for (lw, ow), (lg, og) in zip(want, got):
        assert torch.equal(lw, lg) and torch.equal(ow, og)
    assert [k for k, _ in new.named_parameters()] == list(want_grads)
    for name, p in new.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, want_grads[name]), name
        assert torch.equal(p, dict(ref.named_parameters())[name]), name
    assert list(new.parameters()) == objects
    assert len({p.untyped_storage().data_ptr() for p in new.parameters()}) == 1
    if grad_accum == 1:
        assert len({p.grad.untyped_storage().data_ptr() for p in new.parameters()}) == 1
    assert new.state_dict().keys() == ref.state_dict().keys()


def test_flat_casts_follow_a_moved_model():
    """A deep copy (or ``.to()``) of a model whose parameters are flat views
    gets a flat buffer of its own at its first bf16 step; the original's
    stays."""
    x, y = _batch(98, n=2)
    model = create_model("cheby", **SMALL, seed=13)
    make_train_step(bf16=True)(create_train_state(model), x, y)
    flat = precision._FLAT[model]
    twin = copy.deepcopy(model)
    make_train_step(bf16=True)(create_train_state(twin), x, y)
    assert precision._FLAT[twin] is not flat and precision._FLAT[model] is flat
    assert twin.blocks[0].attn.q_mappings[0].cheby_coeffs.untyped_storage().data_ptr() \
        == precision._FLAT[twin].flat.untyped_storage().data_ptr()
    with torch.inference_mode():
        params = precision.bf16_params(model)
    assert all(v.dtype == BF16 for v in params.values())
    assert precision._FLAT[model] is flat
