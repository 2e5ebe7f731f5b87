"""bf16 serving and training of the fourier (NaiveFourierKAN) ViT against kanvit's bf16 policy.

kanvit's Pallas Fourier kernels take bf16 x and W, make cos(kx) and sin(kx)
in f32 from the upcast x, round them to bf16 at the dot, accumulate in f32
and round y, dx and dW once; the bias is added outside in bf16. Its plain
tier (``_fused_fwd`` / ``_fused_bwd`` with ``fourier_family``) evaluates
cos and sin of the f32 product k x directly; its K-blocked tier
(``_fwd_kernel_kbf``, ``_dx_kernel_kbf``, ``_dw_kernel_kbf``) makes them by
the angle-addition recurrence from cos(x), sin(x), seeded once for y and dx
and once a slab for dW. The port's plain twins
(``K.fourier_grouped_forward_bf16``, ``K.fourier_grouped_backward_bf16``)
follow the recurrence (seeded once for y and dx, once a chunk of 2
harmonics for dW, each product and sum rounded as kanvit's expression
reads) and are the CPU route of a bf16 ``fourierkan``; here each is held
against kanvit's kernels in Pallas interpret mode
(``dispatch.set_impl("pallas")``) on the same bf16 inputs, drawn with numpy
from a seed, at shapes where kanvit takes a kernel tier (a spy names it;
its jnp route makes the basis in bf16, another function).

The gates, stated before any run:

- one bf16 ulp elementwise, |a - b| <= 2^-7 |b| + 2^-12 max|b|;
- plus one bf16 ulp of each rounded basis value weighted as the next
  product weighs it: 2^-8 |B| |W| for y (``fourier_fwd_spread_bf16``) and
  2^-8 |B|^T |gy| for dW (``fourier_dw_spread_bf16``);
- plus the basis's drift: the two tiers' basis values (direct, or the
  recurrence from another seed, in XLA's f32 with its products fused into
  sums) differ from the twin's by up to ~k (1 + |x|) 2^-23; the gate allows
  DRIFT k (1 + |x|), DRIFT = 2^-21, a basis value, weighted as W weighs it
  for y and as gy weighs it for dW;
- dx, one f32 sum of k (gW_sin c_k - gW_cos s_k) over the harmonics: one
  ulp plus sum_k k (|gy| |W_cos,k|^T + |gy| |W_sin,k|^T) (DX_ORDER +
  DRIFT k (1 + |x|)), DX_ORDER = 2^-14 for gW's and the sum's f32 orders
  (chains up to 1024 adds) and the drift as dx weighs the basis.

The bias's gradient is autograd's sum over the rows outside the kernels,
held within kanvit's bf16 gradient gate.

- ``fourierkan`` on kanvit's plain tier at nin 24, grids 5 and 28, ragged
  rows, and on its K-blocked tier at grid 28 (the weight past its budget);
- the twin's basis against kanvit's ``_trig_state_init`` /
  ``_trig_state_read`` and its recurrence: bit for bit op by op from the
  same seeds, within 2^-20 k jitted (XLA fuses its products into sums);
- at nin 16 kanvit packs 8 rows a kernel row: from 32 packed rows its plain
  tier's kernel holds the gates; below them its block-diagonal fallback's
  ``_unpack_dw`` sums the 8 slots' dW in bf16, a gap from the port's one
  rounding stated and held within kanvit's bf16 gradient gate;
- the bf16 CPU route never runs the f32 basis on bf16;
- the slice: ``make_eval_step(bf16=True)`` and ``Predictor`` against
  kanvit's bf16 eval step (logits within 2e-2 x max(1, max|logits|)), the
  train step against ``jax.grad`` (``test_torch_port_bf16_train.py``'s
  ``test_train_step_matches_kanvit``, whose kinds include fourier), and
  ``grad_accum=2``, at the MNIST geometry with 2 blocks and kanvit's weights;
- the CUDA route's wrappers with each launch emulated on the CPU: a bf16
  step's launches (1 ``fourierkan`` and 2 lanes forwards and as many
  backwards at 2 blocks; the q/k/v are Linear), the embedder's no-dx route,
  the plain route's bits, and a raise, not a fall-back, where the launch
  itself cannot run.

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
from test_torch_port_bf16_sine import _bias_close, _f64, _logits_close, _pair, _spy
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
DRIFT = 2.0 ** -21     # x k (1 + |x|): a basis value, direct or recurrence against the twin's
DX_ORDER = 2.0 ** -14  # dx: gW's and the harmonics' f32 sums in other orders
REC = 2.0 ** -20       # x k: the twin's recurrence against kanvit's, jitted
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


def _gate(got, want, spread=None):
    """One bf16 ulp of the output, plus ``spread`` (already weighted)."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max()
    if spread is not None:
        bound = bound + spread
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


def _fourier_x(rng, shape):
    """Normals, every 7th entry over [-10, 10] (arguments k x up to 280)."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-10.0, 10.0, flat[::7].size)
    return _pair(x)


def _fourier_params(rng, nin, nout, grid):
    """coeffs (2, out, in, G) at NaiveFourierKAN's init scale and bias
    (out,), as ``_pair``s."""
    return [_pair(rng.standard_normal((2, nout, nin, grid)) / np.sqrt(nin * grid)),
            _pair(rng.standard_normal(nout) * 0.1)]


def _to_coeffs(packed):
    """A packed ``(1, 2G, in, out)`` array in the coefficients' ``(2, out,
    in, G)`` layout."""
    _, s, nin, nout = packed.shape
    return packed.reshape(2, s // 2, nin, nout).transpose(0, 3, 2, 1)


def _drift(x, grid):
    """DRIFT k (1 + |x|), ``(N, 2G, in)`` f64 in the packed order."""
    k = np.tile(np.arange(1, grid + 1, dtype=np.float64), 2)
    return DRIFT * k[None, :, None] * (1.0 + np.abs(_f64(x)))[:, None, :]


def _spreads(x, w, gy):
    """The weighted spread terms of y, dx and dW (dW in the coefficients'
    layout) of one Fourier layer on the packed bf16 weight ``w (1, 2G, in,
    out)``."""
    n, (_, s, nin, nout) = x.shape[0], w.shape
    grid = s // 2
    drift = _drift(x, grid)
    aw = np.abs(_f64(w[0]))                                    # (2G, in, out)
    agy = np.abs(_f64(gy))
    fwd = ULP_MID * _f64(K.fourier_fwd_spread_bf16(x, w)) + drift.reshape(n, -1) @ \
        aw.reshape(-1, nout)
    dw = ULP_MID * _f64(K.fourier_dw_spread_bf16(x, w, gy))[0] + \
        (drift.reshape(n, -1).T @ agy).reshape(s, nin, nout)
    agw = (agy @ aw.reshape(-1, nout).T).reshape(n, s, nin)   # >= |gW|
    k = np.arange(1, grid + 1, dtype=np.float64)[None, :, None]
    dx = (k * (agw[:, :grid] + agw[:, grid:])
          * (DX_ORDER + drift[:, :grid])).sum(1)
    return fwd, dx, _to_coeffs(dw[None])


def _fourierkan_both(n, nin, nout, grid, seed):
    """``fourierkan`` on the same bf16 operands through kanvit's Pallas
    kernels (its VJP of ``gy``) and the port's CPU route (autograd): returns
    the operands, kanvit's ``(y, grads)`` and the port's ``(y, grads)``, the
    grads of x, coeffs and bias."""
    rng = np.random.default_rng(seed)
    x, jx = _fourier_x(rng, (n, nin))
    params = _fourier_params(rng, nin, nout, grid)
    gy, jgy = _pair(rng.standard_normal((n, nout)))
    want, jgrads = _vjp(JFB.fourierkan, (jx, *(j for _, j in params)), jgy)
    leaves = _leaves(x, *(t for t, _ in params))
    y = FB.fourierkan(*leaves)
    y.backward(gy)
    return (x, params[0][0], gy), (want, jgrads), (y, [t.grad for t in leaves])


def _check_fourierkan(case, tier_hits):
    (x, coeffs, gy), (want, jgrads), (y, grads) = case
    assert tier_hits
    assert want.dtype == jgrads[0].dtype == jnp.bfloat16
    assert y.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    fwd, dx, dw = _spreads(x, FB.pack_fourier_weight(coeffs).contiguous(), gy)
    _gate(y, want, fwd)
    _gate(grads[0], jgrads[0], dx)
    _gate(grads[1], jgrads[1], dw)
    _bias_close(grads[2], jgrads[2])


# --- the twins against kanvit's Pallas kernels -------------------------------

@pytest.mark.parametrize("n,nin,nout,grid", [(37, 24, 24, 5), (101, 24, 40, 28)])
def test_fourierkan_matches_pallas_plain_tier(monkeypatch, n, nin, nout, grid):
    """nin 24 (no row packing), grids 5 and 28, ragged rows; kanvit's plain
    tier (direct cos and sin of k x) runs both ways (spies on ``_fused_fwd``
    and ``_fused_bwd``)."""
    hits = _spy(monkeypatch, ("_fused_fwd", "_fused_bwd", "_fused_fwd_kb"))
    case = _fourierkan_both(n, nin, nout, grid, 300 + n + grid)
    assert "_fused_fwd_kb" not in hits
    _check_fourierkan(case, {"_fused_fwd", "_fused_bwd"} <= set(hits))


def test_fourierkan_matches_pallas_kb_tier(monkeypatch):
    """Grid 28 at a weight past half kanvit's VMEM budget: its K-blocked
    recurrence tier runs both ways (spies on ``_fused_fwd_kb`` and
    ``_fused_bwd_kb``)."""
    hits = _spy(monkeypatch, ("_fused_fwd_kb", "_fused_bwd_kb", "_fused_fwd"))
    case = _fourierkan_both(37, 96, 400, 28, 330)
    assert "_fused_fwd" not in hits
    _check_fourierkan(case, {"_fused_fwd_kb", "_fused_bwd_kb"} <= set(hits))


def test_twin_basis_follows_kanvits_recurrence():
    """kanvit's K-blocked forward seeds its state with ``_trig_state_init``
    and reads it with ``_trig_state_read`` (``fused_basis.py:1858-1870``),
    then steps ``ch, sh = ch * c1 - sh * s1, sh * c1 + ch * s1`` a harmonic.
    Op by op (no jit) from the twin's own seeds that is the twin's basis bit
    for bit; jitted from XLA's seeds (its products fused into the sums, its
    cos and sin a rounding apart), within REC k of it. The dW twin seeds
    each chunk of 2 harmonics with cos and sin of the f32 product k x."""
    rng = np.random.default_rng(331)
    grid, nin = 28, 24
    x = _fourier_x(rng, (40, nin))[0].float()
    twin = K.fourier_slices_bf16(x, grid).numpy()               # (N, 2G, in)

    def recur(c1, s1, ch, sh):
        out = []
        for _ in range(grid):
            out.append((ch, sh))
            ch, sh = ch * c1 - sh * s1, sh * c1 + ch * s1
        return out

    trig = np.zeros((x.shape[0], 4 * nin), np.float32)
    JFB._trig_state_init(trig, jnp.asarray(x.numpy()))
    jitted = jax.jit(recur)(*(jnp.asarray(a) for a in JFB._trig_state_read(trig, nin)))
    c1, s1 = torch.cos(x).numpy(), torch.sin(x).numpy()
    with jax.disable_jit():
        eager = recur(*(jnp.asarray(a) for a in (c1, s1, c1, s1)))
    for k in range(1, grid + 1):
        for half, (e, j) in enumerate(zip(eager[k - 1], jitted[k - 1])):
            got = twin[:, half * grid + k - 1]
            assert np.array_equal(np.asarray(e), got), k
            assert np.abs(np.asarray(j, np.float64) - got).max() <= REC * k, k
    seeded = K.fourier_slices_bf16(x, grid, seed_chunks=True)
    for k in range(1, grid + 1, K.FOURIER_BF16_HARMONICS):
        assert torch.equal(seeded[:, k - 1], torch.cos(x * float(k)))
        assert torch.equal(seeded[:, grid + k - 1], torch.sin(x * float(k)))
    assert np.abs(seeded.numpy() - twin).max() <= REC * grid


def test_packing_at_nin_16(monkeypatch):
    """At nin 16 kanvit packs 8 rows a kernel row (``_row_pack_factor``,
    ``fourierkan`` :3765-3768); 261 rows are 33 packed rows, its plain tier's
    kernel: the port's one rounding of the f32 sum over all the rows holds
    the same gates."""
    hits = _spy(monkeypatch, ("_fused_fwd", "_fused_bwd"))
    case = _fourierkan_both(261, 16, 40, 28, 340)
    _check_fourierkan(case, {"_fused_fwd", "_fused_bwd"} <= set(hits))


# The largest gap, relative to max(1, max|g|), between the port's dcoeffs
# (one rounding of the f32 sum over all the rows) and kanvit's below 32
# packed rows (each of the 8 row slots' dW rounded to bf16, then summed in
# bf16): 6.6e-3 at these inputs, within kanvit's own gate of 5e-2, where at
# 33 packed rows (its kernel) the two agree to 2.7e-8.
def test_small_shape_bwd_gap_to_kanvits_fallback():
    """150 rows at nin 16 are 19 rows of 8 packed slots, fewer than 32:
    kanvit's backward falls back to the block-diagonal form and
    ``_unpack_dw`` (``kanvit/kernels/fused_basis.py:1108-1117, 1139-1142``).
    The port keeps its one rounding; the gap is stated and held within
    kanvit's bf16 gradient gate, and y and dx (no such sum) within their
    gates."""
    (x, coeffs, gy), (want, jgrads), (y, grads) = _fourierkan_both(150, 16, 40, 28, 341)
    fwd, dx, _ = _spreads(x, FB.pack_fourier_weight(coeffs).contiguous(), gy)
    _gate(y, want, fwd)
    _gate(grads[0], jgrads[0], dx)
    got, ref = _f64(grads[1]), _f64(jgrads[1])
    gap = float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))
    assert 0 < gap <= GRAD_TOL, gap


def test_twins_follow_the_kernel_route_bits():
    """The CPU route is the twins on the packed weight, bit for bit (its
    bias added in bf16), ``K.fourierkan_forward`` on a bf16 x too; the
    twins' f64 form sums the same rounded operands, and the no-dx backward
    gives the all-gradients route's dW."""
    rng = np.random.default_rng(342)
    x = _fourier_x(rng, (30, 24))[0]
    (coeffs, _), (bias, _) = _fourier_params(rng, 24, 12, 5)
    w = FB.pack_fourier_weight(coeffs).contiguous()
    y = FB.fourierkan(x, coeffs, bias)
    twin = K.fourier_grouped_forward_bf16(x, w)
    assert torch.equal(y, twin + bias)
    assert torch.equal(K.fourierkan_forward(x, coeffs, bias), y)
    exact = K.fourier_grouped_forward_bf16(x, w, exact=True)
    b = K.fourier_slices_bf16(x.float(), 5)
    assert exact.dtype == torch.float64
    assert torch.allclose(exact, b.to(BF16).double().reshape(30, -1)
                          @ w[0].double().reshape(-1, 12), rtol=1e-12, atol=1e-12)
    gy = _pair(rng.standard_normal((30, 12)))[0]
    every = K.fourier_grouped_backward_bf16(x, w, gy)
    no_dx = K.fourier_grouped_backward_bf16(x, w, gy, need_dx=False)
    assert no_dx[0] is None and torch.equal(every[1], no_dx[1])
    assert all(t.dtype == BF16 for t in every) and every[1].shape == w.shape


def test_bf16_route_never_runs_the_f32_basis(monkeypatch):
    """A bf16 ``fourierkan`` forward and backward on the CPU route run the
    twins only: the f32 route's Fourier basis (kanvit's jnp route makes it
    in bf16) never sees a bf16 tensor."""
    def refuse(name, f):
        def run(x, *a, **k):
            assert x.dtype != BF16, f"{name} ran on bf16"
            return f(x, *a, **k)
        return run

    for name in ("fourier_bases", "fourier_bases_and_grad"):
        monkeypatch.setattr(K, name, refuse(name, getattr(K, name)))
    rng = np.random.default_rng(343)
    x = _fourier_x(rng, (20, 16))[0].requires_grad_(True)
    coeffs, bias = (t.requires_grad_(True) for t, _ in _fourier_params(rng, 16, 8, 28))
    y = FB.fourierkan(x, coeffs, bias)
    y.float().sum().backward()
    assert y.dtype == BF16 and x.grad.dtype == BF16
    assert coeffs.grad.dtype == bias.grad.dtype == BF16


def test_cpu_route_refuses_what_the_card_refuses():
    """The bf16 CPU route checks its operands as the bf16 kernels do and
    casts nothing: f32 coefficients under a bf16 x raise on the CPU as on
    the card; so do a packed weight of another grid and two groups."""
    rng = np.random.default_rng(344)
    x = _fourier_x(rng, (20, 16))[0]
    (coeffs, _), (bias, _) = _fourier_params(rng, 16, 8, 5)
    with pytest.raises(TypeError, match="weight"):
        FB.fourierkan(x, coeffs.float(), bias)
    w = FB.pack_fourier_weight(coeffs).contiguous()
    with pytest.raises(ValueError, match="does not match"):
        FB._KanBf16Plain.apply(x, w, 4, "fourier")
    with pytest.raises(ValueError, match="one group"):
        FB.check_fourier_args(torch.cat([x, x], 1), torch.cat([w, w]), 5, bf16=True)
    assert FB.fourierkan(x, coeffs, bias).dtype == BF16


# --- the slice -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """kanvit's fourier ViT (2 blocks, MNIST geometry), its bf16 eval step
    under forced Pallas on 6 images, and the port's model on its weights."""
    rng = np.random.default_rng(350)
    x = rng.standard_normal((6, *SMALL["chw"])).astype(np.float32)
    y = rng.integers(0, SMALL["out_d"], 6)
    jmodel = j_create_model("fourier", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(8),
                                     jnp.zeros((1, *SMALL["chw"])))
        jdispatch.set_impl("pallas")
        jloss, jlogits = j_make_eval_step(bf16=True)(state, jnp.asarray(x), jnp.asarray(y))
        jloss, jlogits = float(jloss), np.asarray(jlogits)
    finally:
        jdispatch.set_impl("auto")
    model = create_model("fourier", **SMALL, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)))
    return model, x, y, jloss, jlogits


def test_eval_step_and_predictor_match_kanvit(served, monkeypatch):
    """The bf16 eval step and ``Predictor`` on a bf16 copy against kanvit's
    bf16 eval step; neither reaches the f32 basis (``K.fourier_bases``)."""
    model, x, y, jloss, jlogits = served

    def refuse(*a, **k):
        raise AssertionError("K.fourier_bases ran on the bf16 route")

    monkeypatch.setattr(K, "fourier_bases", refuse)
    loss, logits = make_eval_step(bf16=True)(create_train_state(model),
                                             torch.from_numpy(x), torch.from_numpy(y))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _logits_close(logits.numpy(), jlogits)
    assert abs(float(loss) - jloss) <= LOGIT_TOL * max(1.0, abs(jloss))
    bf = precision.cast_params_(copy.deepcopy(model))
    assert bf.linear_mapper.fouriercoeffs.dtype == BF16
    got = Predictor(bf, batch_size=6, device="cpu").logits(x)
    assert np.array_equal(got, logits.numpy())


def test_grad_accum_bf16_matches_one_chunk():
    """Two chunks of 3 images: the f32 .grad sums the chunks' gradients,
    divided by 2, within the slice's gate of the one-chunk step's."""
    params, _, _ = _kanvit_bf16("fourier")
    x, y = _batch(78)
    one, two = _port_model("fourier", params), _port_model("fourier", params)
    _, loss1, _ = make_train_step(bf16=True)(create_train_state(one), x, y)
    _, loss2, logits2 = make_train_step(bf16=True, grad_accum=2)(create_train_state(two), x, y)
    assert logits2.shape == (6, SMALL["out_d"])
    assert abs(float(loss2) - float(loss1)) <= 2e-2 * max(1.0, abs(float(loss1)))
    _grads_close({k: p.grad for k, p in two.named_parameters()},
                 {k: p.grad.numpy() for k, p in one.named_parameters()})


def test_check_bf16_trainable():
    """The fourier ViT passes (``precision.BF16_UNPORTED`` is empty), and so
    does a fused-FF fourier ViT since ROADMAP.md Queue 2 entry 3b.4 ported
    the fused FF's bf16 kernels."""
    assert precision.BF16_UNPORTED == ()
    precision.check_bf16_trainable(create_model("fourier", **SMALL, seed=3))
    precision.check_bf16_trainable(create_model("fourier", **SMALL, seed=3, fused_ff=True))


# --- the CUDA route's wrappers, each launch emulated on the CPU ---------------

def _emu_fourier_bf16(name, x2d, w, grid_size):
    assert name == "fourierkan" and x2d.dtype == BF16
    FB.check_fourier_args(x2d, w, grid_size, bf16=True)
    FB.LAUNCHES[f"{name}_bf16"] += 1
    return K.fourier_grouped_forward_bf16(x2d, w)


def _emu_fourier_bwd_bf16(asked):
    def launch(name, x2d, w, grid_size, gy, need_dx, need_dw):
        assert x2d.dtype == BF16 and gy.dtype == BF16
        FB.check_fourier_args(x2d, w, grid_size, bf16=True)
        asked.append((name, need_dx, need_dw))
        FB.LAUNCHES[f"{name}_bwd_bf16"] += 1
        return K.fourier_grouped_backward_bf16(x2d, w, gy, need_dx, need_dw)
    return launch


def test_kernel_route_serves_and_trains_bf16(monkeypatch, served):
    """A bf16 fourier step through the wrappers: 1 embedder and 2 lanes
    launches forward and as many backward, all bf16 ones and no f32 KAN or
    attention launch (the q/k/v are Linear); the embedder asked for no dx;
    the plain route's gradients and updated parameters bit for bit. The eval
    step the same forwards and the plain route's logits."""
    x, y = _batch(351)
    plain = create_model("fourier", **SMALL, seed=11)
    routed = create_model("fourier", **SMALL, seed=11)
    make_train_step(bf16=True)(create_train_state(plain), x, y)
    model, images, labels, _, jlogits = served
    asked = []
    with monkeypatch.context() as m:
        m.setattr(dispatch, "use_kernel", lambda t: True)
        m.setattr(FB, "_launch_bf16", _emu_fourier_bf16)
        m.setattr(FB, "_launch_bwd_bf16", _emu_fourier_bwd_bf16(asked))
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
    assert counts == {"fourierkan_bf16": 1, "flash_attention_lanes_bf16": 2,
                      "fourierkan_bwd_bf16": 1, "flash_attention_lanes_bwd_bf16": 2}
    assert serve == {"fourierkan_bf16": 1, "flash_attention_lanes_bf16": 2}
    _logits_close(logits.numpy(), jlogits)
    assert asked == [("fourierkan", False, True)]
    for (name, p), q in zip(plain.named_parameters(), routed.parameters()):
        assert p.grad.dtype == q.grad.dtype == torch.float32
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_kernel_route_raises_rather_than_falls_back(monkeypatch):
    """With the forward emulated, the backward goes to the bf16 Fourier
    kernels, which cannot launch without a card: it raises, and no plain
    twin or f32 kernel runs instead; f32 coefficients under a bf16 x raise
    too, and so does the sine launcher given a bf16 Fourier call."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(FB, "_launch_bf16", _emu_fourier_bf16)
    rng = np.random.default_rng(352)
    x = _fourier_x(rng, (20, 16))[0]
    coeffs, bias = (t.requires_grad_(True) for t, _ in _fourier_params(rng, 16, 8, 28))
    y = FB.fourierkan(x, coeffs, bias)
    assert y.dtype == BF16 and FB.LAUNCHES["fourierkan_bf16"] == 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        y.float().sum().backward()
    assert coeffs.grad is None
    assert not any(n for name, n in FB.LAUNCHES.items() if "bwd" in name)
    w = FB.pack_fourier_weight(coeffs.detach()).contiguous()
    with pytest.raises(TypeError, match="weight"):
        FB.check_fourier_args(x, w.float(), 28, bf16=True)
    with pytest.raises(NotImplementedError):
        FB._launch_sine_bwd("fourierkan_bwd", x, w, None, None, x[:, :8], True, True)


def test_bf16_forward_scratch_follows_the_entry():
    """The wrapper sizes the bf16 Fourier forward's split W for the entry's
    shape: 192 outputs a block past 64 and 64 up to it, two 16-deep steps of
    bf16 pairs a stage, a stage for each chunk of 2 harmonics (grid 28: 14;
    grid 5: 3); the entry reads the packed weight a chunk at a time
    (``FourierBf16::wslice``)."""
    src = (Path(FB.__file__).parent / "csrc" / "kan_basis.cu").read_text()
    entry = src[src.index('extern "C" int kanvit_fourierkan_tc_fwd_bf16'):]
    assert ("launch_tc_grouped_fwd<FourierBf16, FOURIER_BF16_WARPS, FOURIER_BF16_MINB, "
            "false, 0,\n                               Bf16>") in entry[:entry.index("\n}")]
    assert "return (l & 1) * (slices / 2) + (l >> 1);" in src
    for nout, outs, grid in ((384, 192, 28), (64, 64, 28), (24, 64, 5)):
        assert FB.tc_fwd_outs("fourier", nout, bf16=True) == outs
        w = torch.zeros(1, 2 * grid, 768, nout, dtype=BF16)
        words = FB._tc_grouped_fwd_scratch(w, "cpu", "fourier", bf16=True).numel()
        assert words == -(-nout // outs) * (768 // 8) * -(-grid // 2) * 2 * outs * 4 * 2
