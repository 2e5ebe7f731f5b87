"""bf16 serving and training of the sine (SineKAN) ViT against kanvit's bf16 policy.

kanvit's Pallas sine kernels (the embedder's plain tier ``_fwd_kernel`` /
``_bwd_kernel_sine`` and K-blocked tier ``_fwd_kernel_kb`` /
``_dx_kernel_kb`` / ``_dw_kernel_kb_sine``; one q/k/v projection of every
head on ``_fwd_kernel_sine_sg`` / ``_bwd_kernel_sine_sg``) take bf16 x, W
and freq, form the argument ``a = x freq + phase`` in f32 (the phase table
f32), make sin(a) in f32, round it to bf16 at the dot, accumulate in f32 and
round y, dx, dW and dfreq once; the bias is added outside in bf16. The
port's plain twins (``K.sine_grouped_forward_bf16``,
``K.sine_grouped_backward_bf16``) follow that policy and are the CPU route
of a bf16 ``sinekan`` and ``sinekan_qkv_grouped``; here each is held
against kanvit's kernel in Pallas interpret mode
(``dispatch.set_impl("pallas")``) on the same bf16 inputs, drawn with numpy
from a seed, at shapes where kanvit takes a kernel tier (a spy names it;
its jnp route makes the basis in bf16, another function). The gates,
stated before any run: one bf16 ulp elementwise, |a - b| <= 2^-7 |b| +
2^-12 max|b|, plus one bf16 ulp of each rounded intermediate weighted as
the next product weighs it: 2^-8 |sin a| |W| for y
(``sine_fwd_spread_bf16``; it also covers XLA's f32 sin against the
port's, and an argument contracted into one FMA) and 2^-8 |sin a|^T |gy|
for dW (``sine_dw_spread_bf16``); dx rounds once from f32, one ulp. dfreq
is one f32 sum of n nin terms ``gW x cos a`` that cancel far below their
magnitudes, which two orders of summation can move by up to their longest
chain of additions times 2^-24 of ``sum |gW x cos a|``: its gate is one ulp
plus 2^-14 of that sum (``sine_dfreq_spread_bf16``, chains up to 1024
adds: kanvit's row blocks, the port's row tiles and features). The
bias's gradient is autograd's sum over the rows outside the kernels, held
within kanvit's bf16 gradient gate.

- ``sinekan`` on kanvit's plain tier at grids 5 and 28, ragged rows, with a
  third of x at |x| 20-60 (|a| in the hundreds), and on its K-blocked tier
  at grid 28; ``sinekan_qkv_grouped`` at 2 heads of dh 16 and 32, grid 4,
  the bias added outside in bf16;
- at nin 16 kanvit packs 8 rows a kernel row and sums the slots' dW and
  dfreq in f32 inside its plain tier: the port's one rounding holds the
  same gates;
- the bf16 CPU route never runs the f32 route's basis on bf16;
- the slice: ``make_eval_step(bf16=True)`` and ``Predictor`` against
  kanvit's bf16 eval step (logits within 2e-2 x max(1, max|logits|)), the
  train step against ``jax.grad`` (``test_torch_port_bf16_train.py``'s
  ``test_train_step_matches_kanvit``, whose kinds include sine), and
  ``grad_accum=2``, at the MNIST geometry with 2 blocks and kanvit's weights;
- the CUDA route's wrappers with each launch emulated on the CPU: a bf16
  step's launches (1 + 2 x 3 + 2 bf16 forwards and as many backwards at 2
  blocks), the embedder's no-dx route still giving dfreq, the plain route's
  bits, and a raise, not a fall-back, where the launch itself cannot run.

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
SUM_ORDER = 2.0 ** -14  # dfreq: chains up to 1024 f32 adds, x sum |gW x cos a|
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


def _pair(a):
    """numpy f32 rounded to bf16: ``(torch bf16, jax bf16)``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _gate(got, want, spread=None, weight=ULP_MID):
    """One bf16 ulp of the output, plus ``weight`` of ``spread``."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    if spread is not None:
        bound = bound + weight * _f64(spread)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


def _bias_close(got, want):
    """The bias's gradient is autograd's bf16 sum of gy over the rows,
    outside the kernels (torch and XLA each their own order and
    accumulation): within kanvit's bf16 gradient gate, 5e-2 x max(1,
    max|g|)."""
    got, want = _f64(got), _f64(want)
    assert np.abs(got - want).max() <= GRAD_TOL * max(1.0, np.abs(want).max())


def _sine_x(rng, shape, large=False):
    """Normals, with ``large`` a third at |x| in [20, 60]."""
    x = rng.standard_normal(shape).astype(np.float32)
    if large:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 3, replace=False)
        flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)
    return _pair(x)


def _sine_params(rng, lead, nin, nout, grid):
    """freq (as SineKAN's init, (1..G) / (G + 1), jittered), amplitudes
    (out, in, G) and bias (out,) as ``_pair``s, each with ``lead`` heads;
    and the f32 phase table (in, G), torch and jax."""
    freq = np.arange(1, grid + 1) / (grid + 1) * (1 + 0.1 * rng.standard_normal((*lead, grid)))
    phase = K.sinekan_phase_init(nin, grid)
    return ([_pair(a) for a in (freq,
                                rng.standard_normal((*lead, nout, nin, grid)) / np.sqrt(nin),
                                rng.standard_normal((*lead, nout)) * 0.1)],
            (phase, jnp.asarray(phase.numpy())))


def _sinekan_both(n, nin, nout, grid, seed, large=False):
    """``sinekan`` on the same bf16 operands through kanvit's Pallas kernel
    (its VJP of ``gy``) and the port's CPU route (autograd): returns the
    operands, kanvit's ``(y, grads)`` and the port's ``(y, grads)``, the
    grads of x, freq, amplitudes and bias."""
    rng = np.random.default_rng(seed)
    (x, jx) = _sine_x(rng, (n, nin), large)
    params, (phase, jphase) = _sine_params(rng, (), nin, nout, grid)
    gy, jgy = _pair(rng.standard_normal((n, nout)))
    want, jgrads = _vjp(lambda xx, f, a, b: JFB.sinekan(xx, f, jphase, a, b),
                        (jx, *(j for _, j in params)), jgy)
    leaves = _leaves(x, *(t for t, _ in params))
    y = FB.sinekan(leaves[0], leaves[1], phase, leaves[2], leaves[3])
    y.backward(gy)
    return (x, [t for t, _ in params], phase, gy), (want, jgrads), (y, [t.grad for t in leaves])


def _sine_spreads(x, params, phase, gy):
    """The forward's, dW's (in the amplitudes' (out, in, G) layout) and
    dfreq's spread terms of one SineKAN layer."""
    freq, amps, _ = params
    w = FB.pack_sine_weight(amps)
    f2 = freq.reshape(1, -1)
    return (K.sine_fwd_spread_bf16(x, w, f2, phase),
            K.sine_dw_spread_bf16(x, w, f2, phase, gy)[0].permute(2, 1, 0),
            K.sine_dfreq_spread_bf16(x, w, f2, phase, gy)[0])


def _check_sinekan(case, tier_hits):
    (x, params, phase, gy), (want, jgrads), (y, grads) = case
    assert tier_hits
    assert want.dtype == jgrads[0].dtype == jnp.bfloat16
    assert y.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    fwd, dw, dfreq = _sine_spreads(x, params, phase, gy)
    _gate(y, want, fwd)
    _gate(grads[0], jgrads[0])                            # dx
    _gate(grads[1], jgrads[1], dfreq, SUM_ORDER)          # dfreq
    _gate(grads[2], jgrads[2], dw)                        # amplitudes
    _bias_close(grads[3], jgrads[3])


def _spy(monkeypatch, names):
    hits = []
    for name in names:
        op = getattr(JFB, name)

        def spy(*a, _op=op, _name=name, **k):
            hits.append(_name)
            return _op(*a, **k)

        monkeypatch.setattr(JFB, name, spy)
    return hits


# --- the twins against kanvit's Pallas kernels -------------------------------

@pytest.mark.parametrize("n,nin,nout,grid,large", [(37, 24, 24, 5, False),
                                                   (101, 24, 40, 28, False),
                                                   (101, 24, 40, 28, True)])
def test_sinekan_matches_pallas_plain_tier(monkeypatch, n, nin, nout, grid, large):
    """nin 24 (no row packing), grids 5 and 28, ragged rows, and a third of
    x at |x| 20-60; kanvit's plain tier runs both ways (spies on
    ``_fused_fwd`` and ``_fused_bwd_sine_plain``)."""
    hits = _spy(monkeypatch, ("_fused_fwd", "_fused_bwd_sine_plain", "_fused_fwd_kb"))
    case = _sinekan_both(n, nin, nout, grid, 200 + n + grid, large)
    assert "_fused_fwd_kb" not in hits
    _check_sinekan(case, {"_fused_fwd", "_fused_bwd_sine_plain"} <= set(hits))


def test_sinekan_matches_pallas_kb_tier(monkeypatch):
    """Grid 28 at a weight past half kanvit's VMEM budget: its K-blocked
    tier runs both ways (spies on ``_fused_fwd_kb`` and ``_fused_bwd_kb``)."""
    hits = _spy(monkeypatch, ("_fused_fwd_kb", "_fused_bwd_kb", "_fused_fwd"))
    case = _sinekan_both(37, 96, 400, 28, 230)
    assert "_fused_fwd" not in hits
    _check_sinekan(case, {"_fused_fwd_kb", "_fused_bwd_kb"} <= set(hits))


@pytest.mark.parametrize("dh", [16, 32])
def test_sinekan_qkv_grouped_matches_pallas(dh):
    """2 heads at grid 4, the bias added outside in bf16; kanvit's
    slot-grouped op runs (not None)."""
    rng = np.random.default_rng(210 + dh)
    h, n, grid = 2, 45, 4
    x, jx = _sine_x(rng, (n, h * dh))
    params, (phase, jphase) = _sine_params(rng, (h,), dh, dh, grid)
    jargs = [j for _, j in params]
    assert JFB.sinekan_qkv_grouped(jx, jargs[0], jphase, *jargs[1:]) is not None
    gy, jgy = _pair(rng.standard_normal((n, h * dh)))
    want, jgrads = _vjp(lambda xx, f, a, b: JFB.sinekan_qkv_grouped(xx, f, jphase, a, b),
                        (jx, *jargs), jgy)
    leaves = _leaves(x, *(t for t, _ in params))
    y = FB.sinekan_qkv_grouped(leaves[0], leaves[1], phase, leaves[2], leaves[3])
    y.backward(gy)
    grads = [t.grad for t in leaves]
    assert y.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    freq, amps, _ = (t for t, _ in params)
    w = FB.pack_sine_qkv_weight(amps)
    _gate(y, want, K.sine_fwd_spread_bf16(x, w, freq, phase))
    _gate(grads[0], jgrads[0])
    _gate(grads[1], jgrads[1], K.sine_dfreq_spread_bf16(x, w, freq, phase, gy), SUM_ORDER)
    _gate(grads[2], jgrads[2], K.sine_dw_spread_bf16(x, w, freq, phase, gy).permute(0, 3, 2, 1))
    _bias_close(grads[3], jgrads[3])


def test_packing_at_nin_16(monkeypatch):
    """At nin 16 kanvit packs 8 rows a kernel row (``_row_pack_factor``,
    ``sinekan`` :3677-3683) and its plain tier sums the 8 slots' dW and
    dfreq in f32 inside the kernel (``_bwd_kernel_sine`` :1690-1696): the
    port's one rounding of the f32 sum over all the rows holds the same
    gates."""
    hits = _spy(monkeypatch, ("_fused_fwd", "_fused_bwd_sine_plain"))
    case = _sinekan_both(261, 16, 40, 28, 240)
    _check_sinekan(case, {"_fused_fwd", "_fused_bwd_sine_plain"} <= set(hits))


def test_twins_follow_the_kernel_route_bits():
    """The CPU route is the twins on the packed weight, bit for bit (its
    bias added in bf16), ``K.sinekan_forward`` on a bf16 x too; the twins'
    f64 form sums the same rounded operands, and the no-dx backward gives
    the all-gradients route's dW and dfreq."""
    rng = np.random.default_rng(220)
    x, _ = _sine_x(rng, (30, 24))
    params, (phase, _) = _sine_params(rng, (), 24, 12, 28)
    freq, amps, bias = (t for t, _ in params)
    w = FB.pack_sine_weight(amps)
    f2 = freq.reshape(1, -1)
    y = FB.sinekan(x, freq, phase, amps, bias)
    twin = K.sine_grouped_forward_bf16(x, w, f2, phase)
    assert torch.equal(y, twin + bias)
    assert torch.equal(K.sinekan_forward(x, freq, phase, amps, bias), y)
    exact = K.sine_grouped_forward_bf16(x, w, f2, phase, exact=True)
    a = torch.sin(x.float().unsqueeze(1) * freq.float().reshape(1, -1, 1) + phase.T)
    assert exact.dtype == torch.float64
    assert torch.allclose(exact, a.to(BF16).double().reshape(30, -1)
                          @ w[0].double().reshape(-1, 12), rtol=1e-12, atol=1e-12)
    gy = _pair(rng.standard_normal((30, 12)))[0]
    every = K.sine_grouped_backward_bf16(x, w, f2, phase, gy)
    no_dx = K.sine_grouped_backward_bf16(x, w, f2, phase, gy, need_dx=False)
    assert no_dx[0] is None and all(torch.equal(p, q) for p, q in zip(every[1:], no_dx[1:]))
    assert all(t.dtype == BF16 for t in every) and every[2].shape == (1, 28)


def test_bf16_route_never_runs_the_f32_basis(monkeypatch):
    """A bf16 ``sinekan`` and ``sinekan_qkv_grouped`` forward and backward
    on the CPU route run the twins only: the f32 route's sine basis
    (kanvit's jnp route makes it in bf16) never sees a bf16 tensor."""
    def refuse(name, f):
        def run(x, *a, **k):
            assert x.dtype != BF16, f"{name} ran on bf16"
            return f(x, *a, **k)
        return run

    for name in ("sine_bases", "sine_bases_and_grad"):
        monkeypatch.setattr(K, name, refuse(name, getattr(K, name)))
    rng = np.random.default_rng(221)
    x = _sine_x(rng, (20, 2 * 16))[0].requires_grad_(True)
    params, (phase, _) = _sine_params(rng, (2,), 16, 16, 4)
    params = [t.requires_grad_(True) for t, _ in params]
    y = FB.sinekan_qkv_grouped(x, params[0], phase, *params[1:])
    eparams, (ephase, _) = _sine_params(rng, (), 16, 8, 28)
    eparams = [t.requires_grad_(True) for t, _ in eparams]
    z = FB.sinekan(y[:, :16], eparams[0], ephase, *eparams[1:])
    (z.float().sum() + y.float().sum()).backward()
    assert z.dtype == BF16 and x.grad.dtype == BF16
    assert all(p.grad is not None and p.grad.dtype == BF16 for p in params + eparams)


def test_cpu_route_refuses_what_the_card_refuses():
    """The bf16 CPU route checks its operands as the bf16 kernels do and
    casts nothing: f32 amplitudes, an f32 freq or a bf16 phase table under
    a bf16 x raise on the CPU as on the card, for the embedder and the
    grouped q/k/v alike."""
    rng = np.random.default_rng(222)
    x = _sine_x(rng, (20, 2 * 16))[0]
    params, (phase, _) = _sine_params(rng, (2,), 16, 16, 4)
    freq, amps, bias = (t for t, _ in params)
    cases = (((freq, phase, amps.float()), "weight"),
             ((freq.float(), phase, amps), "freq"),
             ((freq, phase.to(BF16), amps), "phase"))
    for (f, ph, a), what in cases:
        with pytest.raises(TypeError, match=what):
            FB.sinekan_qkv_grouped(x, f, ph, a, bias)
        with pytest.raises(TypeError, match=what):
            FB.sinekan(x[:, :16], f[0], ph, a[0], bias[0])
    assert FB.sinekan_qkv_grouped(x, freq, phase, amps, bias).dtype == BF16


# --- the slice -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """kanvit's sine ViT (2 blocks, MNIST geometry), its bf16 eval step
    under forced Pallas on 6 images, and the port's model on its weights."""
    rng = np.random.default_rng(240)
    x = rng.standard_normal((6, *SMALL["chw"])).astype(np.float32)
    y = rng.integers(0, SMALL["out_d"], 6)
    jmodel = j_create_model("sine", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(8),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        jloss, jlogits = j_make_eval_step(bf16=True)(state, jnp.asarray(x), jnp.asarray(y))
        jloss, jlogits = float(jloss), np.asarray(jlogits)
    finally:
        jdispatch.set_impl("auto")
    model = create_model("sine", **SMALL, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)))
    return model, x, y, jloss, jlogits


def _logits_close(got, want):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), err


def test_eval_step_and_predictor_match_kanvit(served, monkeypatch):
    """The bf16 eval step and ``Predictor`` on a bf16 copy against kanvit's
    bf16 eval step; neither reaches ``K.sinekan_forward``, and the cast
    leaves the phase tables f32."""
    model, x, y, jloss, jlogits = served

    def refuse(*a, **k):
        raise AssertionError("K.sinekan_forward ran on the bf16 route")

    monkeypatch.setattr(K, "sinekan_forward", refuse)
    loss, logits = make_eval_step(bf16=True)(create_train_state(model),
                                             torch.from_numpy(x), torch.from_numpy(y))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _logits_close(logits.numpy(), jlogits)
    assert abs(float(loss) - jloss) <= LOGIT_TOL * max(1.0, abs(jloss))
    bf = precision.cast_params_(copy.deepcopy(model))
    phases = [b for name, b in bf.named_buffers() if name.endswith("phase")]
    assert phases and all(b.dtype == torch.float32 for b in phases)
    assert bf.linear_mapper.freq.dtype == BF16
    got = Predictor(bf, batch_size=6, device="cpu").logits(x)
    assert np.array_equal(got, logits.numpy())


def test_grad_accum_bf16_matches_one_chunk():
    """Two chunks of 3 images: the f32 .grad sums the chunks' gradients,
    divided by 2, within the slice's gate of the one-chunk step's."""
    params, _, _ = _kanvit_bf16("sine")
    x, y = _batch(78)
    one, two = _port_model("sine", params), _port_model("sine", params)
    _, loss1, _ = make_train_step(bf16=True)(create_train_state(one), x, y)
    _, loss2, logits2 = make_train_step(bf16=True, grad_accum=2)(create_train_state(two), x, y)
    assert logits2.shape == (6, SMALL["out_d"])
    assert abs(float(loss2) - float(loss1)) <= 2e-2 * max(1.0, abs(float(loss1)))
    _grads_close({k: p.grad for k, p in two.named_parameters()},
                 {k: p.grad.numpy() for k, p in one.named_parameters()})


def test_check_bf16_trainable():
    """The sine and fourier ViTs pass, and so does a fused-FF model of
    either kind, refused until ROADMAP.md Queue 2 entry 3b.4 ported the
    fused FF's bf16 kernels."""
    for kind in ("sine", "fourier"):
        precision.check_bf16_trainable(create_model(kind, **SMALL, seed=3))
    for kind, kw in (("fourier", {"fused_ff": True}), ("efficientkan", {"fused_ff": True}),
                     ("sine", {"fused_ff": True})):
        precision.check_bf16_trainable(create_model(kind, **SMALL, seed=3, **kw))


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_sine_bf16(name, x2d, w, freq2d, phase):
    assert x2d.dtype == BF16
    FB.check_sine_args(x2d, w, freq2d, phase, bf16=True)
    FB.LAUNCHES[f"{name}_bf16"] += 1
    return K.sine_grouped_forward_bf16(x2d, w, freq2d, phase)


def _emu_sine_bwd_bf16(asked):
    def launch(name, x2d, w, freq2d, phase, gy, need_dx, need_dw):
        assert x2d.dtype == BF16 and gy.dtype == BF16
        FB.check_sine_args(x2d, w, freq2d, phase, bf16=True)
        asked.append((name, need_dx, need_dw))
        FB.LAUNCHES[f"{name}_bf16"] += 1
        return K.sine_grouped_backward_bf16(x2d, w, freq2d, phase, gy, need_dx, need_dw)
    return launch


def test_kernel_route_serves_and_trains_bf16(monkeypatch, served):
    """A bf16 sine step through the wrappers: 1 embedder, 2 x 3 grouped
    q/k/v and 2 lanes launches forward and as many backward, all bf16 ones
    and no f32 KAN or attention launch; the embedder asked for no dx and
    still giving dfreq; the plain route's gradients and updated parameters
    bit for bit. The eval step the same forwards and the plain route's
    logits."""
    x, y = _batch(241)
    plain = create_model("sine", **SMALL, seed=11)
    routed = create_model("sine", **SMALL, seed=11)
    make_train_step(bf16=True)(create_train_state(plain), x, y)
    model, images, labels, _, jlogits = served
    asked = []
    with monkeypatch.context() as m:
        m.setattr(dispatch, "use_kernel", lambda t: True)
        m.setattr(FB, "_launch_sine", _emu_sine_bf16)
        m.setattr(FB, "_launch_sine_bwd", _emu_sine_bwd_bf16(asked))
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
    assert counts == {"sinekan_bf16": 1, "sinekan_qkv_grouped_bf16": 6,
                      "flash_attention_lanes_bf16": 2, "sinekan_bwd_bf16": 1,
                      "sinekan_qkv_grouped_bwd_bf16": 6, "flash_attention_lanes_bwd_bf16": 2}
    assert serve == {"sinekan_bf16": 1, "sinekan_qkv_grouped_bf16": 6,
                     "flash_attention_lanes_bf16": 2}
    _logits_close(logits.numpy(), jlogits)
    assert asked.count(("sinekan_bwd", False, True)) == 1
    assert asked.count(("sinekan_qkv_grouped_bwd", True, True)) == 6
    assert float(routed.linear_mapper.freq.grad.abs().max()) > 0
    for (name, p), q in zip(plain.named_parameters(), routed.parameters()):
        assert p.grad.dtype == q.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_kernel_route_raises_rather_than_falls_back(monkeypatch):
    """With the forwards emulated, the backward goes to the bf16 sine
    kernels, which cannot launch without a card: it raises, and no plain
    twin or f32 kernel runs instead; f32 amplitudes, an f32 freq or a bf16
    phase table under a bf16 x raise too, and so do the other families'
    launchers given a bf16 sine call."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(FB, "_launch_sine", _emu_sine_bf16)
    rng = np.random.default_rng(242)
    x = _sine_x(rng, (20, 16))[0]
    params, (phase, _) = _sine_params(rng, (), 16, 8, 28)
    freq, amps, bias = (t.requires_grad_(True) for t, _ in params)
    y = FB.sinekan(x, freq, phase, amps, bias)
    assert y.dtype == BF16 and FB.LAUNCHES["sinekan_bf16"] == 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        y.float().sum().backward()
    assert amps.grad is None and freq.grad is None
    assert not any(n for name, n in FB.LAUNCHES.items() if "bwd" in name)
    w = FB.pack_sine_weight(amps.detach()).contiguous()
    f2 = freq.detach().reshape(1, -1)
    with pytest.raises(TypeError, match="weight"):
        FB.check_sine_args(x, w.float(), f2, phase, bf16=True)
    with pytest.raises(TypeError, match="freq"):
        FB.check_sine_args(x, w, f2.float(), phase, bf16=True)
    with pytest.raises(TypeError, match="phase"):
        FB.check_sine_args(x, w, f2, phase.to(BF16), bf16=True)
    with pytest.raises(NotImplementedError):
        FB._launch_rbf_bwd("sinekan_bwd", x, w, None, None, torch.zeros(8), 1.0, None,
                           x[:, :8], True, True)
    with pytest.raises(NotImplementedError):
        FB._launch_sine_bwd("fourierkan_bwd", x, w, f2, phase, x[:, :8], True, True)


def test_bf16_forward_scratch_follows_the_entry():
    """The wrapper sizes the bf16 sine forward's split W for the entry's
    shape: 192 outputs a block past 64 and 64 up to it, two 16-deep steps of
    bf16 pairs a stage, a stage for each chunk of 4 slices (the embedder's
    28: 7)."""
    src = (Path(FB.__file__).parent / "csrc" / "kan_rbf_sine.cu").read_text()
    entry = src[src.index('extern "C" int kanvit_sinekan_tc_fwd_bf16'):]
    assert "launch_tc_grouped_fwd<Sine, SINE_BF16_WARPS, SINE_BF16_MINB, false, 0, Bf16>" \
        in entry[:entry.index("\n}")]
    for nout, outs, slices in ((384, 192, 28), (64, 64, 4), (24, 64, 5)):
        assert FB.tc_fwd_outs("sine", nout, bf16=True) == outs
        w = torch.zeros(2, slices, 768, nout, dtype=BF16)
        words = FB._tc_grouped_fwd_scratch(w, "cpu", "sine", bf16=True).numel()
        assert words == 2 * -(-nout // outs) * (768 // 8) * -(-slices // 4) * 2 * outs * 4 * 2
