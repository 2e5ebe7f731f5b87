"""bf16 training of the efficientkan ViT against kanvit's bf16 policy.

kanvit's Pallas backward kernels take bf16 operands, make the basis, B' and
the softmax in f32, round to bf16 at each dot (the basis, pn, dsc),
accumulate in f32 and round each gradient once. The port's plain twins
(``K.bspline_grouped_backward_bf16``, ``A.lanes_attention_bwd_bf16``) follow
that policy; here each is held against kanvit's kernel in Pallas interpret
mode (``dispatch.set_impl("pallas")``) on the same bf16 inputs, drawn with
numpy from a seed. The gates, stated before any run: one bf16 ulp
elementwise, |a - b| <= 2^-7 |b| + 2^-12 max|b|, plus one bf16 ulp of each
rounded intermediate weighted as the next product weighs it, 2^-8 of
``bspline_dw_spread_bf16`` (|B|^T |gy|) for dW and of
``lanes_attention_bwd_bf16(..., spread=True)`` for dq, dk and dv.

- ``bspline_kan``: ragged rows, row-packed nin 16 and plain nin 24, dx and
  the packed weight's gradient (no spline_scaler, so that the base and
  spline weights' gradients are its slices). kanvit runs a row count that
  reaches its kernel tier: below 32 packed rows its block-diagonal fallback
  sums the 8 row slots' dW in bf16 (``_unpack_dw``), other bits than the
  kernel's one rounding, which the port follows;
- ``bspline_qkv_grouped``: 2 heads of dh 16 and 32 against kanvit's
  slot-grouped op (``_bspline_op_sg``) on the same packed weight, and a
  grid a head against kanvit's per-head op (``_bspline_op``);
- the lanes backward at dh 8, 32 and 64, and at the head dims the card runs
  on its padded kernels, 24, 40, 72 and 128, masked and causal;
- the CUDA route's wrappers with each launch emulated on the CPU: a bf16
  step's launches (1 + 2 + 2 bf16 forwards and backwards at 2 blocks), the
  embedder's no-dx route, the plain route's gradient bits, and
  ``fused_ff=True`` (of the efficientkan and fourier ViTs) training a bf16
  step since the fused FF's bf16 kernels (the cheby, fast, sine and fourier
  ViTs' bf16 training:
  ``test_torch_port_bf16_cheby.py``, ``test_torch_port_bf16_fast.py``,
  ``test_torch_port_bf16_sine.py``, ``test_torch_port_bf16_fourier.py``);
- the slice: the port's ``make_train_step(bf16=True)`` against ``jax.grad``
  of kanvit's ``_loss_and_logits(..., bf16=True)`` at the MNIST geometry
  with 2 blocks (the efficientkan, cheby, fast, sine, fourier, vanilla and flash-attn ViTs,
  kanvit's weights carried across), loss within 2e-2 x max(1, |loss|) and every
  gradient within 5e-2 x max(1, max|g|), kanvit's own bf16 gradient gate
  (``tests/test_kernels.py:966-967``); the vanilla ViT also at 2 heads of 40
  and of 72 (kanvit's ``--n-heads`` on another width: the bf16 lanes
  attention at a generic head dim), its bf16 eval logits within 2e-2 x
  max(1, max|logit|) too; ``grad_accum=2``; the caller's cuBLAS reduction
  flag; ``python -m kanvit_torch.bench --bf16``.

Small shapes; torch on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import flash_attention as JFA
from kanvit.kernels import fused_basis as JFB
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.train.state import create_train_state as j_create_train_state
from kanvit.train.steps import _loss_and_logits as j_loss_and_logits
from kanvit_torch import bench as port_bench
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.models import create_model
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.train import create_train_state, make_eval_step, make_train_step
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params

BF16 = torch.bfloat16
ULP_REL, ULP_ABS, ULP_MID = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
LOSS_TOL = 2e-2   # x max(1, |loss|)
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


def _bf16(rng, shape, scale=1.0):
    """numpy f32 normals rounded to bf16: ``(torch bf16, jax bf16)``."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _gate(got, want, spread=None):
    """One bf16 ulp of the output, plus 2^-8 of ``spread`` (the rounded
    intermediates' weight)."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    if spread is not None:
        bound = bound + ULP_MID * _f64(spread)
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


def _vjp(f, args, ct):
    """``(f(*args), the VJP of ct)``, jitted."""
    def run(a, c):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(c)
    return jax.jit(run)(tuple(args), ct)


def _leaves(*ts):
    return [t.clone().requires_grad_(True) for t in ts]


# --- the twins against kanvit's Pallas backwards -------------------------------

@pytest.mark.parametrize("n,nin,nout", [(261, 16, 40), (37, 24, 24)])
def test_bspline_kan_bwd_matches_pallas(n, nin, nout):
    """nin 16 runs kanvit's row-packed kernel (8 rows a kernel row, 33 of
    them), 24 its plain one; ragged rows either way."""
    rng = np.random.default_rng(70)
    grid = K.make_bspline_grid(nin)
    jgrid = jnp.asarray(grid.numpy())
    (x, jx), (bw, jbw), (sw, jsw) = (_spline_x(rng, (n, nin), grid[0].numpy()),
                                     _bf16(rng, (nout, nin), 0.3),
                                     _bf16(rng, (nout, nin, 8), 0.3))
    gy, jgy = _bf16(rng, (n, nout))
    want, (jdx, jdbw, jdsw) = _vjp(
        lambda *a: JFB.bspline_kan(a[0], jgrid, a[1], a[2], None, 3), (jx, jbw, jsw), jgy)
    assert jdx.dtype == jdbw.dtype == jnp.bfloat16
    tx, tbw, tsw = _leaves(x, bw, sw)
    y = FB.bspline_kan(tx, grid, tbw, tsw, None)
    y.backward(gy)
    assert tx.grad.dtype == tbw.grad.dtype == BF16
    spread = K.bspline_dw_spread_bf16(x, grid, FB.pack_weight(bw, sw, None).unsqueeze(0), gy)
    _gate(y, want)
    _gate(tx.grad, jdx)
    _gate(tbw.grad, jdbw, spread[0, 8].T)
    _gate(tsw.grad, jdsw, spread[0, :8].permute(2, 1, 0))


def _packed_qkv(rng, h, dh, out):
    bw, sw, sc = (_bf16(rng, s, 0.3)[0] for s in ((h, out, dh), (h, out, dh, 8), (h, out, dh)))
    return FB.pack_qkv_weight(bw, sw, sc).contiguous()


def _twin_bwd(x, w, grid, gy):
    """The CPU route's bf16 B-spline layer on the packed weight, through
    autograd: ``(y, dx, dw)``."""
    tx, tw = _leaves(x, w)
    y = FB._KanBf16Plain.apply(tx, tw, grid)
    y.backward(gy)
    return y, tx.grad, tw.grad


@pytest.mark.parametrize("dh", [16, 32])
def test_bspline_qkv_grouped_bwd_matches_pallas(dh):
    rng = np.random.default_rng(71)
    h, n = 2, 45
    grid = K.make_bspline_grid(dh)
    x, jx = _spline_x(rng, (n, h * dh), grid[0].numpy())
    w = _packed_qkv(rng, h, dh, 3 * dh)
    gy, jgy = _bf16(rng, (n, h * 3 * dh))
    q = JFB._sg_slots(h, dh)
    gridt_q = jnp.tile(jnp.asarray(grid.numpy()).T, (1, q))
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16).reshape(-1, 3 * dh)
    want, (jdx, jdw) = _vjp(lambda a, b: JFB._bspline_op_sg(a, b, gridt_q, 5, 3, True, q),
                            (jx, jw), jgy)
    y, dx, dw = _twin_bwd(x, w, grid, gy)
    _gate(y, want)
    _gate(dx, jdx)
    _gate(dw, jdw.reshape(w.shape), K.bspline_dw_spread_bf16(x, grid, w, gy))


def test_bspline_grid_a_head_bwd_matches_pallas():
    """The MSA's route with refit grids: one projection of every head, a
    grid a head, against kanvit's per-head op on each head's grid."""
    rng = np.random.default_rng(72)
    h, dh, n = 2, 16, 45
    base = K.make_bspline_grid(dh)
    grid = torch.stack([base * (1 + 0.07 * i) + 0.02 * i for i in range(h)])
    x, jx = _spline_x(rng, (n, h * dh), base[0].numpy())
    w = _packed_qkv(rng, h, dh, dh)
    gy, jgy = _bf16(rng, (n, h * dh))
    y, dx, dw = _twin_bwd(x, w, grid, gy)
    spread = K.bspline_dw_spread_bf16(x, grid, w, gy)
    for i in range(h):
        cols = slice(i * dh, (i + 1) * dh)
        jw = jnp.asarray(w[i].float().numpy()).astype(jnp.bfloat16)
        gridt = jnp.asarray(grid[i].numpy()).T
        want, (jdx, jdw) = _vjp(lambda a, b: JFB._bspline_op(a, b, gridt, 5, 3, True),
                                (jx[:, cols], jw), jgy[:, cols])
        _gate(y[:, cols], want)
        _gate(dx[:, cols], jdx)
        _gate(dw[i], jdw, spread[i])


def _mask(b, t):
    m = np.ones((b, t), bool)
    m[0] = False            # every row of batch item 0 is fully masked
    m[1, 0] = False         # causal: query 0 of item 1 sees no key
    m[1, 7:11] = False
    return m


@pytest.mark.parametrize("dh,heads", [(8, 3), (32, 2), (64, 2), (24, 2), (40, 2), (72, 1),
                                      (128, 1)])
def test_lanes_bwd_matches_pallas(dh, heads):
    """Unmasked, then masked and causal, on the same inputs."""
    rng = np.random.default_rng(73)
    b, t = 2, 23
    (q, jq), (k, jk), (v, jv), (do, jdo) = (_bf16(rng, (b, t, heads * dh))
                                            for _ in range(4))
    for causal, mask in ((False, None), (True, _mask(b, t))):
        jmask = None if mask is None else jnp.asarray(mask)
        tmask = None if mask is None else torch.from_numpy(mask)
        want, jgrads = _vjp(lambda *a: JFA.flash_attention_lanes(
            *a, heads, causal=causal, mask=jmask), (jq, jk, jv), jdo)
        tq, tk, tv = _leaves(q, k, v)
        o = FA.flash_attention_lanes(tq, tk, tv, heads, causal=causal, mask=tmask)
        o.backward(do)
        _gate(o, want, A.lanes_attention(q, k, v.abs(), heads, causal=causal, mask=tmask))
        spread = A.lanes_attention_bwd_bf16(q, k, v, o.detach(), do, heads, causal, tmask,
                                            spread=True)
        for got, jg, sp in zip((tq.grad, tk.grad, tv.grad), jgrads, spread):
            assert got.dtype == BF16
            _gate(got, jg, sp)
        if mask is not None:
            assert (tq.grad[0] == 0).all() and (tk.grad[~tmask] == 0).all()
            assert (tv.grad[~tmask] == 0).all()


def test_scales_of_the_lanes_bwd():
    """qs takes the scale rounded to bf16 and dq the f32 one: at dh 32 they
    differ, and the twin's dq is the f32 scale times dsc k."""
    rng = np.random.default_rng(74)
    b, t, h, dh = 1, 9, 1, 32
    q, k, v, do = (_bf16(rng, (b, t, h * dh))[0] for _ in range(4))
    o = A.lanes_attention(q, k, v, h)
    dq, _, _ = A.lanes_attention_bwd_bf16(q, k, v, o, do, h, exact=True)
    dq_bf_scale = dq * (A.bf16_scale(dh) / dh ** -0.5)
    assert A.bf16_scale(dh) != dh ** -0.5
    assert not torch.allclose(dq, dq_bf_scale, rtol=1e-4, atol=0)
    got = A.lanes_attention_bwd_bf16(q, k, v, o, do, h)[0]
    _gate(got, dq, A.lanes_attention_bwd_bf16(q, k, v, o, do, h, spread=True)[0])


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_kan_bf16(name, x2d, w, grid):
    FB.check_args(x2d, grid, w, FB.SPLINE_ORDER, bf16=True)
    FB.LAUNCHES[f"{name}_bf16"] += 1
    return K.bspline_grouped_forward_bf16(x2d, grid, w)


def _emu_kan_bwd_bf16(asked):
    def launch(name, x2d, w, grid, gy, need_dx, need_dw):
        FB.check_args(x2d, grid, w, FB.SPLINE_ORDER, bf16=True)
        assert gy.dtype == BF16
        asked.append((name, need_dx, need_dw))
        FB.LAUNCHES[f"{name}_bwd_bf16"] += 1
        return K.bspline_grouped_backward_bf16(x2d, grid, w, gy, need_dx, need_dw)
    return launch


def _emu_lanes_bf16(q4, k4, v4, maskb, causal, stats=None):
    FA.LAUNCHES["flash_attention_lanes_bf16"] += 1
    mask = None if maskb is None else maskb.bool()
    return A.lanes_attention(q4, k4, v4, q4.shape[2], causal=causal, mask=mask)


def _emu_lanes_bwd_bf16(q4, k4, v4, maskb, o, stats, do, causal):
    assert stats is not None and stats.shape == (q4.shape[0], q4.shape[2], q4.shape[1], 2)
    FA.LAUNCHES["flash_attention_lanes_bwd_bf16"] += 1
    mask = None if maskb is None else maskb.bool()
    grads = A.lanes_attention_bwd_bf16(q4, k4, v4, o, do, q4.shape[2], causal, mask)
    return [g.view(q4.shape) for g in grads]


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' CUDA route on CPU tensors, each launch emulated by its
    plain twin; yields the (name, dx, dW) asked of each KAN backward."""
    asked = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_bf16", _emu_kan_bf16)
    monkeypatch.setattr(FB, "_launch_bwd_bf16", _emu_kan_bwd_bf16(asked))
    monkeypatch.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
    monkeypatch.setattr(FA, "_launch_bwd_bf16", _emu_lanes_bwd_bf16)
    yield asked


def _batch(seed, n=6, chw=SMALL["chw"], classes=SMALL["out_d"]):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, *chw)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, classes, n)))


def test_kernel_route_trains_bf16(monkeypatch):
    """A bf16 step through the wrappers: 1 embedder, 2 grouped q/k/v and 2
    lanes launches forward and as many backward, all bf16 ones; the
    embedder asked for dW alone; the plain route's gradients, bit for bit."""
    x, y = _batch(75)
    plain = create_model("efficientkan", **SMALL, seed=11)
    routed = create_model("efficientkan", **SMALL, seed=11)
    make_train_step(bf16=True)(create_train_state(plain), x, y)
    asked = []
    with monkeypatch.context() as m:
        m.setattr(dispatch, "use_kernel", lambda t: True)
        m.setattr(FB, "_launch_bf16", _emu_kan_bf16)
        m.setattr(FB, "_launch_bwd_bf16", _emu_kan_bwd_bf16(asked))
        m.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
        m.setattr(FA, "_launch_bwd_bf16", _emu_lanes_bwd_bf16)
        make_train_step(bf16=True)(create_train_state(routed), x, y)
    counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    assert counts == {"bspline_kan_bf16": 1, "bspline_qkv_grouped_bf16": 2,
                      "flash_attention_lanes_bf16": 2, "bspline_kan_bwd_bf16": 1,
                      "bspline_qkv_grouped_bwd_bf16": 2, "flash_attention_lanes_bwd_bf16": 2}
    assert ("bspline_kan", False, True) in asked
    assert asked.count(("bspline_qkv_grouped", True, True)) == 2
    for (name, p), q in zip(plain.named_parameters(), routed.parameters()):
        assert p.dtype == q.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


@pytest.mark.parametrize("kind,kw,entry", [("fourier", {"fused_ff": True}, "3b.4"),
                                           ("efficientkan", {"fused_ff": True}, "3b.4")])
def test_bf16_training_of_unported_kinds_raises(kind, kw, entry):
    """A fused-FF model, refused in bf16 until ROADMAP.md Queue 2 entry
    ``entry`` ported the fused FF's bf16 kernels, raises no more: it passes
    ``check_bf16_trainable`` and trains a bf16 step (the CPU route: the
    twins), a finite loss, every parameter moved or not as Adam moves it,
    f32 parameters with f32 gradients, and no launch counted
    (``tests/test_torch_port_bf16_ffn.py`` holds the card's route)."""
    assert entry == "3b.4"
    model = create_model(kind, **SMALL, seed=3, **kw)
    precision.check_bf16_trainable(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    x, y = _batch(76, n=2)
    _, loss, logits = make_train_step(bf16=True)(create_train_state(model), x, y)
    assert bool(torch.isfinite(loss)) and logits.dtype == torch.float32
    assert not any({**FB.LAUNCHES, **FA.LAUNCHES}.values())
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(p, before[k]) for k, p in model.named_parameters())


def test_bf16_backward_wrappers_refuse():
    """The bf16 backward launcher takes the B-spline, Chebyshev and Fourier
    entry points, each with its own operands, and bf16 gradients only
    (FastKAN and SineKAN have launchers of their own); it raises before
    touching a device, never falls back."""
    rng = np.random.default_rng(77)
    grid = K.make_bspline_grid(16)
    x = _spline_x(rng, (10, 16), grid[0].numpy())[0]
    w = FB.pack_weight(*(_bf16(rng, s)[0] for s in ((8, 16), (8, 16, 8), (8, 16)))
                       ).unsqueeze(0).contiguous()
    gy = _bf16(rng, (10, 8))[0]
    with pytest.raises(NotImplementedError, match="_launch_rbf_bwd"):
        FB._launch_bwd_bf16("fastkan", x, w, grid, gy, True, True)
    with pytest.raises(ValueError, match="does not match"):  # not a Fourier weight
        FB._launch_bwd_bf16("fourierkan", x, w, 5, gy, True, True)
    with pytest.raises(ValueError, match="bf16"):
        FB._launch_bwd_bf16("bspline_kan", x, w, grid, gy.float(), True, True)
    with pytest.raises(TypeError):
        FB._launch_bwd_bf16("bspline_kan", x.float(), w, grid, gy, True, True)
    assert not any(FB.LAUNCHES.values())


# --- the slice: the port's bf16 train step against kanvit's ------------------

_KANVIT = {}
_KANVIT_LOGITS = {}  # the bf16 step's logits, by _kanvit_bf16's key


def _kanvit_bf16(kind, geom=None):
    """kanvit's ``kind`` ViT (2 blocks, MNIST geometry, ``geom`` overriding
    it): its weights, and the loss and gradients of its bf16 policy on 6
    images under forced Pallas, from ``jax.grad`` of
    ``_loss_and_logits(..., bf16=True)``; computed once a kind."""
    key = (kind, tuple(sorted((geom or {}).items())))
    if key not in _KANVIT:
        x, y = _batch(78)
        jmodel = j_create_model(kind, **{**SMALL, **(geom or {})})
        jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
        state = j_create_train_state(jmodel, jax.random.PRNGKey(6),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            lambda p: j_loss_and_logits(state.apply_fn, p, jnp.asarray(x.numpy()),
                                        jnp.asarray(y.numpy()), True), has_aux=True,
        ))(state.params)
        _KANVIT[key] = (state_dict_from_jax_params(jax.tree.map(np.asarray, state.params)),
                        float(loss),
                        state_dict_from_jax_params(jax.tree.map(np.asarray, grads)))
        _KANVIT_LOGITS[key] = np.asarray(logits.astype(jnp.float32), np.float64)
    return _KANVIT[key]


def _port_model(kind, params, geom=None):
    model = create_model(kind, **{**SMALL, **(geom or {})}, seed=9)
    load_reference_state_dict(model, params)
    return model


def _grads_close(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        ref = np.asarray(want[name], np.float64)
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        err = float(np.abs(g.double().numpy() - ref).max())
        assert err <= GRAD_TOL * max(1.0, float(np.abs(ref).max())), (name, err)


@pytest.mark.parametrize("kind", ["efficientkan", "cheby", "fast", "sine", "fourier",
                                  "vanilla", "flash-attn"])
def test_train_step_matches_kanvit(kind):
    params, jloss, jgrads = _kanvit_bf16(kind)
    model = _port_model(kind, params)
    x, y = _batch(78)
    _, loss, logits = make_train_step(bf16=True)(create_train_state(model), x, y)
    assert loss.dtype == logits.dtype == torch.float32
    assert abs(float(loss) - jloss) <= LOSS_TOL * max(1.0, abs(jloss))
    _grads_close({k: p.grad for k, p in model.named_parameters()}, jgrads)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("dh", [40, 72])
def test_generic_head_dim_vit_matches_kanvit(dh):
    """The vanilla ViT at 2 heads of ``dh`` (d 2 dh): a bf16 training step's
    loss and gradients against kanvit's, as above, and the bf16 eval step's
    logits against kanvit's on the same weights."""
    geom = dict(d_hidden=2 * dh, n_heads=2)
    params, jloss, jgrads = _kanvit_bf16("vanilla", geom)
    model = _port_model("vanilla", params, geom)
    assert all(blk.attn.d_head == dh for blk in model.blocks)
    x, y = _batch(78)
    _, loss, _ = make_train_step(bf16=True)(create_train_state(model), x, y)
    assert abs(float(loss) - jloss) <= LOSS_TOL * max(1.0, abs(jloss))
    _grads_close({k: p.grad for k, p in model.named_parameters()}, jgrads)
    want = _KANVIT_LOGITS[("vanilla", tuple(sorted(geom.items())))]
    _, logits = make_eval_step(bf16=True)(create_train_state(_port_model("vanilla", params,
                                                                         geom)), x, y)
    err = float(np.abs(logits.double().numpy() - want).max())
    assert err <= LOSS_TOL * max(1.0, float(np.abs(want).max())), err


def test_grad_accum_bf16_matches_one_chunk():
    """Two chunks of 3 images: the f32 .grad sums the chunks' gradients,
    divided by 2, within the slice's gate of the one-chunk step's."""
    params, _, _ = _kanvit_bf16("efficientkan")
    x, y = _batch(78)
    one, two = _port_model("efficientkan", params), _port_model("efficientkan", params)
    _, loss1, _ = make_train_step(bf16=True)(create_train_state(one), x, y)
    _, loss2, logits2 = make_train_step(bf16=True, grad_accum=2)(create_train_state(two), x, y)
    assert logits2.shape == (6, SMALL["out_d"])
    assert abs(float(loss2) - float(loss1)) <= LOSS_TOL * max(1.0, abs(float(loss1)))
    _grads_close({k: p.grad for k, p in two.named_parameters()},
                 {k: p.grad.numpy() for k, p in one.named_parameters()})


def test_bf16_step_restores_the_reduction_flag():
    """cuBLAS reduces in f32 through the forward and the backward, and the
    caller's setting comes back after the step, whichever it was."""
    model = create_model("efficientkan", **SMALL, seed=5)
    seen = []
    model.mlp_head[1].weight.register_hook(lambda g: seen.append(
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        for caller in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = caller
            make_train_step(bf16=True)(create_train_state(model), *_batch(79, n=2))
            assert matmul.allow_bf16_reduced_precision_reduction == caller
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert seen == [False, False]


def test_bench_bf16_on_cpu():
    args = port_bench.parse_args(["--device", "cpu", "--preset", "reference", "--bf16",
                                  "--batch-size", "4", "--steps", "1", "--windows", "1",
                                  "--warmup", "1"])
    out = port_bench.run(args)
    assert out["bf16"] is True and out["value"] > 0 and out["batch_size"] == 4
    assert port_bench.run(port_bench.parse_args(
        ["--device", "cpu", "--batch-size", "4", "--steps", "1", "--windows", "1",
         "--warmup", "1"]))["bf16"] is False
