"""The FastKAN embedder's backward and the grouped Chebyshev q/k/v forward on
the tensor cores, their arithmetic emulated on the CPU.

``fastkan``'s backward (the patch embedder's) runs on the grouped q/k/v
backward's templates at one group (``kanvit_torch/kernels/csrc/
kan_basis_tc.cuh``, part 2, entry ``kanvit_fastkan_qkv_tc_bwd``), and
``cheby_qkv_grouped``'s forward on part 3's template
(``kan_tc_fwd_grouped<Cheby, NT>``, entry ``kanvit_cheby_qkv_tc_fwd``), both
in 3xTF32 ``mma.sync.m16n8k8`` (``product`` of
``test_torch_port_attention_tc.py``: each f32 operand split into big +
small TF32 words, each 8-deep step small*big + big*small + big*big into a
zeroed accumulator that an f32 add takes into the running sum). Here that
arithmetic replaces the wrappers' launches, in the kernels' own order:

- the embedder's backward (``test_torch_port_qkv_tc_rbf_sine.rbf_tc`` at
  one group): dW over the rows in the splits of ``tc_grouped_dw_splits``
  (rounded up to whole waves of blocks) with a flush every 28 stages, gW =
  gy W^T over the outputs then the RBF fold, dln through the LayerNorm's
  VJP and into dgamma, dbeta as column sums over 64-row partials summed in
  groups of 16;
- the Chebyshev forward, per head
  (``test_torch_port_qkv_tc_fwd_cheby.grouped_fwd``): T_0..T_4 of tanh(x)
  by the recurrence, stages of 8 features, each stage's 5 slices one 8-deep
  step each, one running sum.

The results are held against kanvit's Pallas ``fastkan`` and
``cheby_qkv_grouped`` in interpret mode and ``jax.grad`` through the
former, within 1e-5 x max(1, max|.|): the embedder at 48 features and 40
outputs (three 16-feature dW tiles, one 64-output tile), ragged rows, with
and without its LayerNorm and its base branch, one case a third of whose
raw inputs lie at |x| 20-60, over one split a stage and over 2 splits of 2
flush groups; the Chebyshev forward at dh 8, 32 and 64 with ragged rows and
a share of x where tanh rounds to +-1. At the vit-s rows (the embedder's
12,544 over 16 features and its 384 outputs in its 11 row splits; the
q/k/v's 12,608 over one head of 64 -> 192) the kernels' results are within
``TOL_KAN`` of the plain f32 version and no further from f64 than twice
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_fast import DEN, GRID, fast_inputs, fast_params
from test_torch_port_kernels import _emu_basis, _jax_grads
from test_torch_port_qkv_tc import N_SM, TOL, TOL_KAN, _gates, _rel
from test_torch_port_qkv_tc_fwd_cheby import cheby_inputs, emu_tc_fwd, grouped_fwd
from test_torch_port_qkv_tc_fwd_rbf_sine import emu_rbf_fwd
from test_torch_port_qkv_tc_rbf_sine import emu_rbf_bwd, rbf_tc

CHEBY_DEGREE = FB.CHEBY_DEGREE


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations run thousands of 8-deep products: one intra-op thread
    a test process, so parallel test workers do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_math(monkeypatch):
    """The CUDA path's Functions with their launches replaced by the
    emulations (the embedder's forward and backward and the grouped
    Chebyshev forward on the tensor cores), kanvit on its Pallas kernels in
    interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_rbf", emu_rbf_fwd)
    monkeypatch.setattr(FB, "_launch", emu_tc_fwd)
    yield monkeypatch
    jdispatch.set_impl("auto")


def _grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, torch.from_numpy(g))


def large_inputs(rng, shape):
    """``fast_inputs`` with a third of the entries at |x| in [20, 60]: silu
    of the raw x dominates the base slice, the LayerNorm's rows spread."""
    x = fast_inputs(rng, shape)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 3, replace=False)
    flat[idx] = (rng.uniform(20.0, 60.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


# (n, LayerNorm, base branch, inputs, SMs): ragged rows at N_SM (one 32-row
# stage a split) with the LayerNorm and the base branch on, each off, large
# raw inputs; 2,000 rows over 2 splits of 32 and 31 stages, each 2 flush
# groups (one SM).
EMBEDDER_CASES = [(83, True, True, "fast", N_SM), (83, True, False, "fast", N_SM),
                  (83, False, True, "fast", N_SM), (83, True, True, "large", N_SM),
                  (2000, True, True, "fast", 1)]


@pytest.mark.parametrize("n,ln,base,inputs,sms", EMBEDDER_CASES)
def test_fastkan_tc_bwd_matches_kanvit(kernel_math, n, ln, base, inputs, sms):
    kernel_math.setattr(FB, "_launch_rbf_bwd", lambda *a, **k: emu_rbf_bwd(*a, **k, sms=sms))
    assert "fastkan_bwd" in FB.TC_GROUPED_BWD  # the route emulated here
    nin, nout = 48, 40
    rng = np.random.default_rng(500 + n + 2 * ln + base)
    x = (fast_inputs if inputs == "fast" else large_inputs)(rng, (n, nin))
    ga, be, sw, bw, bb = fast_params(rng, nout, nin)
    keep = (True, ln, ln, True, base, base)
    arrays = [a for a, k in zip((x, ga, be, sw, bw, bb), keep) if k]
    g = rng.standard_normal((n, nout)).astype(np.float32)
    jgrid, tgrid = jnp.asarray(GRID), torch.from_numpy(GRID.copy())

    def layer(fn, grid):
        def call(*a):
            it = iter(a)
            full = [next(it) if k else None for k in keep]
            return fn(full[0], full[1], full[2], grid, DEN, *full[3:])
        return call

    want_y, want = _jax_grads(layer(JFB.fastkan, jgrid), arrays, g)
    got_y, got = _grads(layer(FB.fastkan, tgrid), arrays, g)
    assert _rel(got_y, want_y) <= TOL
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert _rel(a, b) <= TOL, i
    assert (FB.LAUNCHES["fastkan"], FB.LAUNCHES["fastkan_bwd"]) == (1, 1)


# (n, heads, dh, saturated share): dh 8 (one stage, 24 outputs: a 64-output
# tile) with ragged rows, dh 32 (4 stages), dh 64 (8 stages, 192 outputs)
CHEBY_FWD_CASES = [(37, 2, 8, 0.1), (70, 2, 32, 0.1), (45, 1, 64, 0.2)]


@pytest.mark.parametrize("n,h,dh,saturated", CHEBY_FWD_CASES)
def test_cheby_qkv_grouped_tc_fwd_matches_kanvit(kernel_math, n, h, dh, saturated):
    assert "cheby_qkv_grouped" in FB.TC_GROUPED_FWD  # the route emulated here
    rng = np.random.default_rng(510 + n + dh)
    x2d = cheby_inputs(rng, (n, h * dh), saturated)
    cc = (rng.standard_normal((h, dh, 3 * dh, CHEBY_DEGREE + 1)) * 0.3).astype(np.float32)
    want = np.asarray(JFB.cheby_qkv_grouped(jnp.asarray(x2d), jnp.asarray(cc)))
    with torch.inference_mode():
        got = FB.cheby_qkv_grouped(torch.from_numpy(x2d), torch.from_numpy(cc))
    assert got.shape == (n, h * 3 * dh)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL
    assert FB.LAUNCHES["cheby_qkv_grouped"] == 1


def test_vit_s_rows_meet_the_gates():
    """The embedder's backward at its 12,544 rows, over 16 features (one dW
    block's) and its 384 outputs, in its 11 row splits: dW, dgamma and
    dbeta within TOL_KAN of the plain f32 version (autograd) and no further
    from f64 than twice it. The Chebyshev forward at the vit-s q/k/v's
    12,608 rows, one head (64 -> 192), a share of x saturating tanh: the
    same gates on y."""
    rng = np.random.default_rng(520)
    n, nin, nout = 12544, 16, 384
    splits = FB.tc_grouped_dw_splits(n, 1, 768, nout, N_SM)
    assert splits == 11
    g = rng.standard_normal((n, nout)).astype(np.float32)
    x = fast_inputs(rng, (n, nin))
    ga, be, sw, bw, bb = fast_params(rng, nout, nin)
    sw, bw = (sw * (10 / np.sqrt(nin * 8.0))).astype(np.float32), (bw * 0.75).astype(np.float32)
    grid = torch.from_numpy(GRID.copy())

    def rbf(x, ga, be, sw, bw, bb):
        return K.fastkan_forward(x, ga, be, grid.to(x.dtype), DEN, sw, bw, bb)

    def plain_grads(dtype):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (x, ga, be, sw, bw, bb)]
        grads = torch.autograd.grad(rbf(*leaves), leaves, torch.from_numpy(g).to(dtype))
        return (grads[1], grads[2], FB.pack_fastkan_weight(grads[3], grads[4], 8)[None])

    xt = torch.from_numpy(x).reshape(n, 1, nin)
    mean = xt.mean(-1)
    rstd = 1.0 / torch.sqrt((xt - mean.unsqueeze(-1)).square().mean(-1) + 1e-5)
    w = FB.pack_fastkan_weight(torch.from_numpy(sw), torch.from_numpy(bw), 8)[None]
    _, dw, dgamma, dbeta = rbf_tc(torch.from_numpy(x), w.contiguous(),
                                  torch.from_numpy(ga)[None], torch.from_numpy(be)[None], grid,
                                  DEN, torch.stack([mean, rstd], -1), torch.from_numpy(g),
                                  splits)
    for name, a, b, c in zip(("dgamma", "dbeta", "dW"), (dgamma[0], dbeta[0], dw),
                             plain_grads(torch.float32), plain_grads(torch.float64)):
        errs = _gates(f"embedder {name}", a, b, c)
        assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], (name, errs)

    n, nin, out = 12608, 64, 192
    xq = torch.from_numpy(cheby_inputs(rng, (n, nin), 0.02))
    w = torch.from_numpy((rng.standard_normal((5, nin, out)) / np.sqrt(nin * 5))
                         .astype(np.float32))
    b32, _ = _emu_basis("cheby", xq, CHEBY_DEGREE)
    b64, _ = _emu_basis("cheby", xq.double(), CHEBY_DEGREE)
    errs = _gates("cheby y", grouped_fwd(b32, w), torch.einsum("nis,sio->no", b32, w),
                  torch.einsum("nis,sio->no", b64, w.double()))
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs


def test_cheby_forward_scratch_holds_every_64_output_tile():
    """The Chebyshev forward takes 64-output blocks at every width: for
    every group and block of 64 outputs, ceil(nin / 8) stages of 5 slices x
    8 features x 64 outputs, two words a value (96 outputs: two blocks)."""
    for h, nin, out, words in ((6, 64, 192, 6 * 3 * 8 * 5 * 64 * 16),
                               (2, 32, 96, 2 * 2 * 4 * 5 * 64 * 16),
                               (4, 12, 24, 4 * 1 * 2 * 5 * 64 * 16)):
        w = torch.empty(h, 5, nin, out)
        assert FB._tc_grouped_fwd_scratch(w, "cpu", "cheby").numel() == words
