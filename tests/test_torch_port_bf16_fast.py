"""bf16 serving and training of the fast (FastKAN) ViT against kanvit's bf16 policy.

kanvit's Pallas kernels with the LayerNorm inside (``_rbf_ln_fwd_kernel`` /
``_rbf_ln_bwd_kernel`` for the embedder, their ``_sg`` forms for one q/k/v
projection of every head) take bf16 operands, run the segment LayerNorm in
f32 from the upcast x, gamma and beta, make the RBF bases of it and silu of
the raw x in f32, round them to bf16 at the dot, accumulate in f32 and round
y, dx, dW, dgamma and dbeta once; the bias is added outside in bf16. The
port's plain twins (``K.fastkan_grouped_forward_bf16``,
``K.fastkan_grouped_backward_bf16``) follow that policy and are the CPU
route of a bf16 ``fastkan`` and ``fastkan_qkv_grouped``; here each is held
against kanvit's kernel in Pallas interpret mode
(``dispatch.set_impl("pallas")``) on the same bf16 inputs, drawn with numpy
from a seed. The shapes are ones where kanvit takes its LayerNorm-fused
tier: ``fastkan`` reaches ``_rbf_ln_base_op`` (a spy says so; below a
32-row block it would take ``_rbf_base_op``, the LayerNorm outside in
bf16), ``fastkan_qkv_grouped`` its slot-grouped op (not None: 2 heads of dh
16 or 32 fit ``_sg_slots``). The gates, stated before any run: one bf16 ulp
elementwise, |a - b| <= 2^-7 |b| + 2^-12 max|b|, plus one bf16 ulp of each
rounded intermediate weighted as the next product weighs it: 2^-8 |B| |W|
for y (``fastkan_fwd_spread_bf16``) and 2^-8 |B|^T |gy| for dW
(``fastkan_dw_spread_bf16``); dx, dgamma and dbeta round once from f32, one
ulp. The base bias's gradient is autograd's sum over the rows outside the
kernels, held by the slice's gate.

- ``fastkan`` at ragged rows and nin 24 (no row packing), forward and
  backward, also with a third of x at |x| 20-60 (silu(x) far beside bases
  <= 1); ``fastkan_qkv_grouped`` at 2 heads of dh 16 and 32;
- at nin 16 kanvit packs 8 rows a kernel row and sums the 8 slots' bf16 dW,
  dgamma and dbeta in bf16 through autograd, at every row count: the gap
  from the port's one rounding, held within kanvit's bf16 gradient gate,
  5e-2 x max(1, max|g|);
- the bf16 CPU route never runs the f32 route's basis or LayerNorm on bf16
  (kanvit's jnp route runs them in bf16, another function);
- the slice: ``make_eval_step(bf16=True)`` and ``Predictor`` against
  kanvit's bf16 eval step (logits within 2e-2 x max(1, max|logits|)), the
  train step against ``jax.grad`` (``test_torch_port_bf16_train.py``'s
  ``test_train_step_matches_kanvit``, whose kinds include fast), and
  ``grad_accum=2``, at the MNIST geometry with 2 blocks and kanvit's weights;
- the CUDA route's wrappers with each launch emulated on the CPU: a bf16
  step's launches (1 + 2 x 3 + 2 bf16 forwards and as many backwards at 2
  blocks), the embedder's no-dx route, the plain route's bits, and a raise,
  not a fall-back, where the launch itself cannot run.

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
    _emu_lanes_bf16,
    _emu_lanes_bwd_bf16,
    _grads_close,
    _kanvit_bf16,
    _leaves,
    _port_model,
    _vjp,
)

BF16 = torch.bfloat16
ULP_REL, ULP_ABS, ULP_MID = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
LOGIT_TOL = 2e-2  # x max(1, max|logits|), kanvit's bf16 gate
GRAD_TOL = 5e-2   # x max(1, max|g|), kanvit's bf16 gradient gate
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)
DEN = 4.0 / 7.0   # FastKAN's spacing of 8 centres on [-2, 2]


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


def _pair(a):
    """numpy f32 rounded to bf16: ``(torch bf16, jax bf16)``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


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


def _fast_x(rng, shape, large=False):
    """Normals (std 1.5), with ``large`` a third at |x| in [20, 60]."""
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    if large:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 3, replace=False)
        flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)
    return _pair(x)


def _fast_params(rng, lead, nin, nout):
    """gamma, beta, spline weight, base weight, base bias as ``_pair``s."""
    return [_pair(a) for a in (1 + 0.2 * rng.standard_normal((*lead, nin)),
                               0.2 * rng.standard_normal((*lead, nin)),
                               rng.standard_normal((*lead, nout, nin * 8)) * 0.3,
                               rng.standard_normal((*lead, nout, nin)) * 0.3,
                               rng.standard_normal((*lead, nout)) * 0.1)]


def _grid():
    grid = torch.linspace(-2.0, 2.0, 8)
    return grid, jnp.asarray(grid.numpy())


def _fastkan_both(n, nin, nout, seed, large=False):
    """``fastkan`` on the same bf16 operands through kanvit's Pallas kernel
    (its VJP of ``gy``) and the port's CPU route (autograd): returns the
    operands, kanvit's ``(y, grads)`` and the port's ``(y, grads)``, the
    grads of x, gamma, beta, spline and base weight and base bias."""
    rng = np.random.default_rng(seed)
    grid, jgrid = _grid()
    (x, jx), params = _fast_x(rng, (n, nin), large), _fast_params(rng, (), nin, nout)
    gy, jgy = _pair(rng.standard_normal((n, nout)))
    want, jgrads = _vjp(lambda xx, g, b, sw, bw, bb: JFB.fastkan(xx, g, b, jgrid, DEN, sw, bw,
                                                                  bb),
                        (jx, *(j for _, j in params)), jgy)
    leaves = _leaves(x, *(t for t, _ in params))
    y = FB.fastkan(leaves[0], leaves[1], leaves[2], grid, DEN, *leaves[3:])
    y.backward(gy)
    return (x, [t for t, _ in params], gy), (want, jgrads), (y, [t.grad for t in leaves])


def _fast_spreads(x, params, gy, grid):
    """The forward's and dW's rounded-basis terms of one FastKAN layer, the
    dW term split into the spline weight's (out, in*8) and the base
    weight's (out, in) layouts."""
    ga, be, sw, bw, _ = params
    nout = sw.shape[0]
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0)
    gamma, beta = ga.reshape(1, -1), be.reshape(1, -1)
    fwd = K.fastkan_fwd_spread_bf16(x, w, gamma, beta, grid, DEN)
    dw = K.fastkan_dw_spread_bf16(x, w, gamma, beta, grid, DEN, gy)[0]
    return fwd, dw[:8].permute(2, 1, 0).reshape(nout, -1), dw[8].T


# --- the twins against kanvit's Pallas kernels -------------------------------

@pytest.mark.parametrize("n,nin,nout,large", [(37, 24, 24, False), (101, 24, 40, False),
                                              (101, 24, 40, True)])
def test_fastkan_matches_pallas(monkeypatch, n, nin, nout, large):
    """nin 24 (no row packing), ragged rows, and a third of x at |x| 20-60;
    kanvit's LayerNorm-fused op runs (a spy on ``_rbf_ln_base_op``)."""
    taken, op = [], JFB._rbf_ln_base_op

    def spy(*a):
        taken.append(a[0].shape)
        return op(*a)

    monkeypatch.setattr(JFB, "_rbf_ln_base_op", spy)
    (x, params, gy), (want, jgrads), (y, grads) = _fastkan_both(n, nin, nout, 100 + n, large)
    assert taken and set(taken) == {(n, nin)}
    assert want.dtype == jgrads[0].dtype == jnp.bfloat16
    assert y.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    fwd, dsw, dbw = _fast_spreads(x, params, gy, _grid()[0])
    _gate(y, want, fwd)
    _gate(grads[0], jgrads[0])              # dx
    _gate(grads[1], jgrads[1])              # dgamma
    _gate(grads[2], jgrads[2])              # dbeta
    _gate(grads[3], jgrads[3], dsw)         # spline weight
    _gate(grads[4], jgrads[4], dbw)         # base weight


@pytest.mark.parametrize("dh", [16, 32])
def test_fastkan_qkv_grouped_matches_pallas(dh):
    rng = np.random.default_rng(110 + dh)
    h, n = 2, 45
    grid, jgrid = _grid()
    (x, jx), params = _fast_x(rng, (n, h * dh)), _fast_params(rng, (h,), dh, dh)
    gy, jgy = _pair(rng.standard_normal((n, h * dh)))
    jargs = [j for _, j in params]
    assert JFB.fastkan_qkv_grouped(jx, jargs[0], jargs[1], jgrid, DEN, *jargs[2:]) is not None
    want, jgrads = _vjp(lambda xx, g, b, sw, bw, bb: JFB.fastkan_qkv_grouped(
        xx, g, b, jgrid, DEN, sw, bw, bb), (jx, *jargs), jgy)
    leaves = _leaves(x, *(t for t, _ in params))
    y = FB.fastkan_qkv_grouped(leaves[0], leaves[1], leaves[2], grid, DEN, *leaves[3:])
    y.backward(gy)
    grads = [t.grad for t in leaves]
    assert y.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    ga, be, sw, bw, _ = (t for t, _ in params)
    w = FB.pack_fastkan_qkv_weight(sw, bw, 8)
    _gate(y, want, K.fastkan_fwd_spread_bf16(x, w, ga, be, grid, DEN))
    spread = K.fastkan_dw_spread_bf16(x, w, ga, be, grid, DEN, gy)
    for got, jg in zip(grads[:3], jgrads[:3]):
        _gate(got, jg)
    _gate(grads[3], jgrads[3], spread[:, :8].permute(0, 3, 2, 1).reshape(h, dh, -1))
    _gate(grads[4], jgrads[4], spread[:, 8].transpose(1, 2))


def test_twins_follow_the_kernel_route_bits():
    """The CPU route is the twins on the packed weight, bit for bit (its
    bias added in bf16), ``K.fastkan_forward`` on a bf16 x too; the twins'
    f64 form sums the same rounded operands, and the no-dx backward gives
    the all-gradients route's dW, dgamma and dbeta."""
    rng = np.random.default_rng(120)
    grid, _ = _grid()
    x, _ = _fast_x(rng, (30, 24))
    ga, be, sw, bw, bb = (t for t, _ in _fast_params(rng, (), 24, 12))
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0)
    gamma, beta = ga.reshape(1, -1), be.reshape(1, -1)
    y = FB.fastkan(x, ga, be, grid, DEN, sw, bw, bb)
    twin = K.fastkan_grouped_forward_bf16(x, w, gamma, beta, grid, DEN)
    assert torch.equal(y, twin + bb)
    assert torch.equal(K.fastkan_forward(x, ga, be, grid, DEN, sw, bw, bb), y)
    exact = K.fastkan_grouped_forward_bf16(x, w, gamma, beta, grid, DEN, exact=True)
    ln = K.seg_layernorm_f32(x.float(), ga, be)[0]
    b = torch.exp(-(((ln.unsqueeze(-1) - grid) * (1.0 / DEN)) ** 2))
    a = torch.cat([b.permute(0, 2, 1), (x.float() * torch.sigmoid(x.float())).unsqueeze(1)], 1)
    assert exact.dtype == torch.float64
    assert torch.allclose(exact, a.to(BF16).double().reshape(30, -1)
                          @ w[0].double().reshape(-1, 12), rtol=1e-12, atol=1e-12)
    gy = _pair(rng.standard_normal((30, 12)))[0]
    every = K.fastkan_grouped_backward_bf16(x, w, gamma, beta, grid, DEN, gy)
    no_dx = K.fastkan_grouped_backward_bf16(x, w, gamma, beta, grid, DEN, gy, need_dx=False)
    assert no_dx[0] is None and all(torch.equal(p, q) for p, q in zip(every[1:], no_dx[1:]))
    assert all(t.dtype == BF16 for t in every)


def test_bf16_route_never_runs_the_f32_basis(monkeypatch):
    """A bf16 ``fastkan`` and ``fastkan_qkv_grouped`` forward and backward
    on the CPU route run the twins only: the f32 route's RBF basis and
    LayerNorm (kanvit's jnp route runs them in bf16) never see a bf16
    tensor."""
    def refuse(name, f):
        def run(x, *a, **k):
            assert x.dtype != BF16, f"{name} ran on bf16"
            return f(x, *a, **k)
        return run

    for name in ("rbf_bases", "layernorm", "rbf_bases_and_grad"):
        monkeypatch.setattr(K, name, refuse(name, getattr(K, name)))
    rng = np.random.default_rng(121)
    grid, _ = _grid()
    x = _fast_x(rng, (20, 2 * 16))[0].requires_grad_(True)
    params = [t.requires_grad_(True) for t, _ in _fast_params(rng, (2,), 16, 16)]
    y = FB.fastkan_qkv_grouped(x, params[0], params[1], grid, DEN, *params[2:])
    z = FB.fastkan(y[:, :16], params[0][0], params[1][0], grid, DEN,
                   *(p[0] for p in params[2:]))
    (z.float().sum() + y.float().sum()).backward()
    assert z.dtype == BF16 and x.grad.dtype == BF16
    assert all(p.grad is not None and p.grad.dtype == BF16 for p in params)


def test_cpu_route_refuses_what_the_card_refuses():
    """The bf16 CPU route checks its operands as the bf16 kernels do and
    casts nothing: f32 weights, an f32 gamma or beta, or bf16 centres under
    a bf16 x raise on the CPU as on the card, for the embedder and the
    grouped q/k/v alike."""
    rng = np.random.default_rng(122)
    grid, _ = _grid()
    x = _fast_x(rng, (20, 2 * 16))[0]
    ga, be, sw, bw, bb = (t for t, _ in _fast_params(rng, (2,), 16, 16))
    cases = (((ga, be, grid, sw.float(), bw.float()), "weight"),
             ((ga.float(), be, grid, sw, bw), "gamma"),
             ((ga, be.float(), grid, sw, bw), "beta"),
             ((ga, be, grid.to(BF16), sw, bw), "grid"))
    for (g, b, c, s, w), what in cases:
        with pytest.raises(TypeError, match=what):
            FB.fastkan_qkv_grouped(x, g, b, c, DEN, s, w, bb)
        with pytest.raises(TypeError, match=what):
            FB.fastkan(x[:, :16], g[0], b[0], c, DEN, s[0], w[0], bb[0])
    assert FB.fastkan_qkv_grouped(x, ga, be, grid, DEN, sw, bw, bb).dtype == BF16


# --- row packing at nin 16: kanvit sums the slots' bf16 gradients ----------

# The largest gap, relative to max(1, max|g|), between the port's dgamma,
# dbeta and dW (one rounding of the f32 sum over all the rows) and kanvit's
# at nin 16, where it packs 8 rows a kernel row (_row_pack_factor,
# _pack_w3d, jnp.tile(ln_gamma, 8): kanvit/kernels/fused_basis.py:3529,
# :3537, :3623) and autograd sums the 8 slots' bf16 gradients in bf16, at
# every row count: held within kanvit's own gate of 5e-2; y and dx, which
# no such sum touches, within one ulp.
def test_packing_gap_at_nin_16():
    (x, params, gy), (want, jgrads), (y, grads) = _fastkan_both(261, 16, 40, 130)
    fwd, _, _ = _fast_spreads(x, params, gy, _grid()[0])
    _gate(y, want, fwd)
    _gate(grads[0], jgrads[0])
    gaps = [float(np.abs(_f64(g) - _f64(j)).max()) / max(1.0, float(np.abs(_f64(j)).max()))
            for g, j in zip(grads[1:5], jgrads[1:5])]
    assert 0 < max(gaps) <= GRAD_TOL, gaps


# --- the slice -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """kanvit's fast ViT (2 blocks, MNIST geometry), its bf16 eval step
    under forced Pallas on 6 images, and the port's model on its weights."""
    rng = np.random.default_rng(140)
    x = rng.standard_normal((6, *SMALL["chw"])).astype(np.float32)
    y = rng.integers(0, SMALL["out_d"], 6)
    jmodel = j_create_model("fast", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(8),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        jloss, jlogits = j_make_eval_step(bf16=True)(state, jnp.asarray(x), jnp.asarray(y))
        jloss, jlogits = float(jloss), np.asarray(jlogits)
    finally:
        jdispatch.set_impl("auto")
    model = create_model("fast", **SMALL, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)))
    return model, x, y, jloss, jlogits


def _logits_close(got, want):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), err


def test_eval_step_and_predictor_match_kanvit(served, monkeypatch):
    """The bf16 eval step and ``Predictor`` on a bf16 copy against kanvit's
    bf16 eval step; neither reaches ``K.fastkan_forward``."""
    model, x, y, jloss, jlogits = served

    def refuse(*a, **k):
        raise AssertionError("K.fastkan_forward ran on the bf16 route")

    monkeypatch.setattr(K, "fastkan_forward", refuse)
    loss, logits = make_eval_step(bf16=True)(create_train_state(model),
                                             torch.from_numpy(x), torch.from_numpy(y))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _logits_close(logits.numpy(), jlogits)
    assert abs(float(loss) - jloss) <= LOGIT_TOL * max(1.0, abs(jloss))
    bf = precision.cast_params_(copy.deepcopy(model))
    assert bf.linear_mapper.rbf_grid.dtype == torch.float32
    got = Predictor(bf, batch_size=6, device="cpu").logits(x)
    assert np.array_equal(got, logits.numpy())


def test_grad_accum_bf16_matches_one_chunk():
    """Two chunks of 3 images: the f32 .grad sums the chunks' gradients,
    divided by 2, within the slice's gate of the one-chunk step's."""
    params, _, _ = _kanvit_bf16("fast")
    x, y = _batch(78)
    one, two = _port_model("fast", params), _port_model("fast", params)
    _, loss1, _ = make_train_step(bf16=True)(create_train_state(one), x, y)
    _, loss2, logits2 = make_train_step(bf16=True, grad_accum=2)(create_train_state(two), x, y)
    assert logits2.shape == (6, SMALL["out_d"])
    assert abs(float(loss2) - float(loss1)) <= 2e-2 * max(1.0, abs(float(loss1)))
    _grads_close({k: p.grad for k, p in two.named_parameters()},
                 {k: p.grad.numpy() for k, p in one.named_parameters()})


def test_check_bf16_trainable():
    """The fast and fourier ViTs pass, and so does a fused-FF model of
    either kind, refused until ROADMAP.md Queue 2 entry 3b.4 ported the
    fused FF's bf16 kernels."""
    for kind in ("fast", "fourier"):
        precision.check_bf16_trainable(create_model(kind, **SMALL, seed=3))
    for kind, kw in (("fourier", {"fused_ff": True}), ("efficientkan", {"fused_ff": True}),
                     ("fast", {"fused_ff": True})):
        precision.check_bf16_trainable(create_model(kind, **SMALL, seed=3, **kw))


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_rbf_bf16(name, x2d, w, gamma, beta, grid, den):
    assert x2d.dtype == BF16
    FB.check_rbf_args(x2d, w, gamma, beta, grid, bf16=True)
    FB.LAUNCHES[f"{name}_bf16"] += 1
    stats = torch.zeros(x2d.shape[0], w.shape[0], 2)
    return K.fastkan_grouped_forward_bf16(x2d, w, gamma, beta, grid, den), stats


def _emu_rbf_bwd_bf16(asked):
    def launch(name, x2d, w, gamma, beta, grid, den, stats, gy, need_dx, need_dw):
        assert x2d.dtype == BF16
        FB.check_rbf_args(x2d, w, gamma, beta, grid, bf16=True)
        assert gy.dtype == BF16 and stats.shape == (x2d.shape[0], w.shape[0], 2)
        asked.append((name, need_dx, need_dw))
        FB.LAUNCHES[f"{name}_bf16"] += 1
        return K.fastkan_grouped_backward_bf16(x2d, w, gamma, beta, grid, den, gy, need_dx,
                                               need_dw)
    return launch


def test_kernel_route_serves_and_trains_bf16(monkeypatch, served):
    """A bf16 fast step through the wrappers: 1 embedder, 2 x 3 grouped
    q/k/v and 2 lanes launches forward and as many backward, all bf16 ones
    and no f32 KAN or attention launch; the embedder asked for no dx; the
    plain route's gradients and updated parameters bit for bit. The eval
    step the same forwards and the plain route's logits."""
    x, y = _batch(141)
    plain = create_model("fast", **SMALL, seed=11)
    routed = create_model("fast", **SMALL, seed=11)
    make_train_step(bf16=True)(create_train_state(plain), x, y)
    model, images, labels, _, jlogits = served
    asked = []
    with monkeypatch.context() as m:
        m.setattr(dispatch, "use_kernel", lambda t: True)
        m.setattr(FB, "_launch_rbf", _emu_rbf_bf16)
        m.setattr(FB, "_launch_rbf_bwd", _emu_rbf_bwd_bf16(asked))
        m.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
        m.setattr(FA, "_launch_bwd_bf16", _emu_lanes_bwd_bf16)
        make_train_step(bf16=True)(create_train_state(routed), x, y)
        counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
        FB.reset_launches()
        FA.reset_launches()
        _, logits = make_eval_step(bf16=True)(create_train_state(model),
                                              torch.from_numpy(images),
                                              torch.from_numpy(labels))
        serve = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    assert counts == {"fastkan_bf16": 1, "fastkan_qkv_grouped_bf16": 6,
                      "flash_attention_lanes_bf16": 2, "fastkan_bwd_bf16": 1,
                      "fastkan_qkv_grouped_bwd_bf16": 6, "flash_attention_lanes_bwd_bf16": 2}
    assert serve == {"fastkan_bf16": 1, "fastkan_qkv_grouped_bf16": 6,
                     "flash_attention_lanes_bf16": 2}
    _logits_close(logits.numpy(), jlogits)
    assert asked.count(("fastkan_bwd", False, True)) == 1
    assert asked.count(("fastkan_qkv_grouped_bwd", True, True)) == 6
    for (name, p), q in zip(plain.named_parameters(), routed.parameters()):
        assert p.grad.dtype == q.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_kernel_route_raises_rather_than_falls_back(monkeypatch):
    """With the forwards emulated, the backward goes to the bf16 FastKAN
    kernels, which cannot launch without a card: it raises, and no plain
    twin or f32 kernel runs instead; f32 weights, f32 gamma or a gamma
    without a beta under a bf16 x raise too."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(FB, "_launch_rbf", _emu_rbf_bf16)
    rng = np.random.default_rng(142)
    grid, _ = _grid()
    x = _fast_x(rng, (20, 16))[0]
    ga, be, sw, bw, bb = (t.requires_grad_(True) for t, _ in _fast_params(rng, (), 16, 8))
    y = FB.fastkan(x, ga, be, grid, DEN, sw, bw, bb)
    assert y.dtype == BF16 and FB.LAUNCHES["fastkan_bf16"] == 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        y.float().sum().backward()
    assert sw.grad is None and ga.grad is None
    assert not any(n for name, n in FB.LAUNCHES.items() if "bwd" in name)
    w = FB.pack_fastkan_weight(sw.detach(), bw.detach(), 8).unsqueeze(0).contiguous()
    g2, b2 = ga.detach().reshape(1, -1), be.detach().reshape(1, -1)
    with pytest.raises(TypeError):   # f32 weights under a bf16 x
        FB.check_rbf_args(x, w.float(), g2, b2, grid, bf16=True)
    with pytest.raises(TypeError, match="gamma"):   # f32 gamma under a bf16 x
        FB.check_rbf_args(x, w, g2.float(), b2, grid, bf16=True)
    with pytest.raises(ValueError, match="both"):   # a gamma without a beta
        FB.check_rbf_args(x, w, g2, None, grid, bf16=True)
    with pytest.raises(NotImplementedError):
        FB._launch_rbf_bwd("sinekan_bwd", x, w, g2, b2, grid, DEN, None, x[:, :8], True,
                           True)


def test_bf16_forward_scratch_follows_the_entry():
    """The wrapper sizes the bf16 RBF forward's split W for the entry's
    shape: 192 outputs a block past 64 and 64 up to it, five 16-deep steps
    of bf16 pairs a stage (9 slices; the f32 forward's remainders step
    has no bf16 counterpart)."""
    src = (Path(FB.__file__).parent / "csrc" / "kan_rbf_sine.cu").read_text()
    entry = src[src.index('extern "C" int kanvit_fastkan_tc_fwd_bf16'):]
    assert "launch_tc_grouped_fwd<Rbf, RBF_BF16_WARPS, RBF_BF16_MINB, false, 0, Bf16>" \
        in entry[:entry.index("\n}")]
    for nout, outs in ((384, 192), (70, 192), (64, 64), (24, 64)):
        assert FB.tc_fwd_outs("rbf", nout, bf16=True) == outs
        w = torch.zeros(2, 9, 768, nout, dtype=BF16)
        words = FB._tc_grouped_fwd_scratch(w, "cpu", "rbf", bf16=True).numel()
        assert words == 2 * -(-nout // outs) * (768 // 8) * 5 * outs * 4 * 2
    assert FB.tc_fwd_outs("rbf", 384) == 64   # the f32 forward's tiles stay
