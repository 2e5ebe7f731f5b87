"""The FastKAN embedder's forward and the Chebyshev embedder's backward on
the tensor cores, their arithmetic emulated on the CPU.

``fastkan`` (the fast ViT's patch embedder) runs its forward on the grouped
q/k/v forward's template at one group (``kanvit_torch/kernels/csrc/
kan_basis_tc.cuh``, part 3, entry ``kanvit_fastkan_kan_tc_fwd``), and
``chebykan`` (the cheby ViT's) its backward on the grouped backward's
templates (part 2, entry ``kanvit_cheby_qkv_tc_bwd``), both in 3xTF32
``mma.sync.m16n8k8`` (``product`` of ``test_torch_port_attention_tc.py``:
each f32 operand split into big + small TF32 words, each 8-deep step
small*big + big*small + big*big into a zeroed accumulator that an f32 add
takes into the running sum). Here that arithmetic replaces the wrappers'
launches, in the kernels' own order:

- the FastKAN forward (``test_torch_port_qkv_tc_fwd_rbf_sine.rbf_tc_fwd``):
  the LayerNorm's (mean, rstd), stages of 8 features, the 8 RBF slices one
  8-deep step each into one running sum, the silu slice into a second one
  with exact products (six a step), the two added and into y every 12
  stages (``kan_rbf_sine.cu``'s ``FASTKAN_EMB_FLUSH``), levels summed in
  order;
- the Chebyshev backward (``test_torch_port_qkv_tc_fwd_cheby.emu_tc_bwd``):
  dW over the rows in the splits of ``tc_grouped_dw_splits`` (rounded up
  to whole waves of blocks) with a flush every 28 stages, the splits summed
  in order; dx as gy W^T over the outputs then sum_s T'_s gW_s in slice
  order, 0 where tanh rounds to +-1.

Both are held against kanvit's Pallas ``fastkan`` and ``chebykan`` in
interpret mode and ``jax.grad`` through the latter within 1e-5 x max(1,
max|.|): the forward with and without its LayerNorm and its base branch,
ragged rows and features, a sum past one level, a third of x at |x|
20-60; the backward with a share of x where tanh rounds to +-1, over one
split a stage and over 2 splits of 2 flush groups, with and without dx. At
the embedders' depth (768 features for y; 12,544 rows in 11 splits for dW,
384 outputs for dx) the emulated kernels are within ``TOL_KAN`` of the
plain f32 version and no further from f64 than twice it; a small batch
runs the forward's levels in blocks of their own; the q/k/v forward keeps
its shape and bits; and a small cheby ViT through the emulated routes
gives kanvit's logits and gradients.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_fast import DEN, GRID, fast_inputs, fast_params
from test_torch_port_kernels import _emu_basis, _emu_lanes_bwd, _emu_lanes_fwd, _jax_grads
from test_torch_port_qkv_tc import N_SM, TOL, TOL_KAN, _gates, _rel, grouped_dw, grouped_dx
from test_torch_port_qkv_tc_fwd_cheby import cheby_inputs, emu_tc_bwd, emu_tc_fwd
from test_torch_port_qkv_tc_fwd_rbf_sine import _model_against_kanvit, emu_rbf_fwd, rbf_tc_fwd
from test_torch_port_qkv_tc_rbf_sine import emu_rbf_bwd

RBF_SINE_CU = (Path(FB.__file__).resolve().parent / "csrc" / "kan_rbf_sine.cu").read_text()
FLUSH = FB.TCG_FWD_FLUSH["fastkan"]
DEGREE = FB.CHEBY_DEGREE


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
    """The CUDA path's Functions with every launch replaced by its
    emulation (the KAN forwards and backwards on the tensor cores but
    ``chebykan``'s forward, the lanes attention), kanvit on its Pallas
    kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_rbf", emu_rbf_fwd)
    monkeypatch.setattr(FB, "_launch_rbf_bwd", emu_rbf_bwd)
    monkeypatch.setattr(FB, "_launch", emu_tc_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_tc_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    yield monkeypatch
    jdispatch.set_impl("auto")


def large_inputs(rng, shape):
    """``fast_inputs`` with a third of the entries at |x| in [20, 60]: silu
    of the raw x dominates the base slice, the LayerNorm's rows spread."""
    x = fast_inputs(rng, shape)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 3, replace=False)
    flat[idx] = (rng.uniform(20.0, 60.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


INPUTS = {"fast": fast_inputs, "large": large_inputs}


# (n, nin, nout, LayerNorm, base branch, inputs): ragged rows and features
# (6 stages, the last of 4) at 40 outputs; 13 stages (past one level of the
# sum) at 70 outputs (two 64-output blocks); 13 stages with a third of x at
# |x| 20-60; no LayerNorm; no base branch; neither, 13 stages, large x
FWD_CASES = [(37, 44, 40, True, True, "fast"), (70, 100, 70, True, True, "fast"),
             (45, 104, 24, True, True, "large"), (29, 12, 36, False, True, "fast"),
             (33, 16, 20, True, False, "fast"), (50, 104, 30, False, False, "large")]


@pytest.mark.parametrize("n,nin,nout,ln,base,inputs", FWD_CASES)
def test_fastkan_tc_fwd_matches_kanvit(kernel_math, n, nin, nout, ln, base, inputs):
    assert "fastkan" in FB.TC_GROUPED_FWD  # the route emulated here
    rng = np.random.default_rng(700 + n + nin)
    x = INPUTS[inputs](rng, (n, nin))
    ga, be, sw, bw, bb = fast_params(rng, nout, nin)
    ln_gb = (ga, be) if ln else (None, None)
    sw_bw_bb = (sw, bw, bb) if base else (sw, None, None)

    def call(fn, conv, grid):
        def c(a):
            return None if a is None else conv(a)
        return fn(conv(x), *map(c, ln_gb), grid, DEN, *map(c, sw_bw_bb))

    want = np.asarray(call(JFB.fastkan, jnp.asarray, jnp.asarray(GRID)))
    with torch.inference_mode():
        got = call(FB.fastkan, torch.from_numpy, torch.from_numpy(GRID.copy()))
    assert got.shape == (n, nout)
    assert _rel(got, want) <= TOL
    assert FB.LAUNCHES["fastkan"] == 1


# (n, nin, nout, saturated share, SMs): one 32-row stage a split at N_SM, 48
# features (three 16-feature dW tiles) at 40 outputs; 100 features at 70
# outputs (a 192-output tile); 2,000 rows over 2 splits of 32 and 31
# stages, each 2 flush groups (one SM)
BWD_CASES = [(83, 48, 40, 0.2, N_SM), (83, 100, 70, 0.1, N_SM), (2000, 24, 40, 0.1, 1)]


@pytest.mark.parametrize("n,nin,nout,saturated,sms", BWD_CASES)
def test_chebykan_tc_bwd_matches_kanvit(kernel_math, n, nin, nout, saturated, sms):
    """Every gradient against ``jax.grad`` through kanvit's kernel, finite
    where tanh rounds to +-1; the training step's call (x no leaf) asks for
    no dx and gives the all-gradients call's dW bit for bit."""
    asked = []

    def bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
        asked.append((need_dx, need_dw))
        return emu_tc_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw, sms)

    kernel_math.setattr(FB, "_launch_bwd", bwd)
    assert "chebykan_bwd" in FB.TC_GROUPED_BWD  # the route emulated here
    rng = np.random.default_rng(710 + n + nin)
    x = cheby_inputs(rng, (n, nin), saturated)
    cc = (rng.standard_normal((nin, nout, DEGREE + 1)) / np.sqrt(nin)).astype(np.float32)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads(JFB.chebykan, (x, cc), g)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, cc)]
    y = FB.chebykan(*leaves)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    assert _rel(y.detach(), want_y) <= TOL
    for name, a, b in zip(("x", "coeffs"), got, want):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= TOL, name
    coeffs = torch.from_numpy(cc).requires_grad_(True)
    no_dx = torch.autograd.grad(FB.chebykan(torch.from_numpy(x), coeffs), coeffs,
                                torch.from_numpy(g))[0]
    assert torch.equal(no_dx, got[1])
    assert asked == [(True, True), (False, True)]
    assert (FB.LAUNCHES["chebykan"], FB.LAUNCHES["chebykan_bwd"]) == (2, 2)


def _fast_case(rng, n, nin, nout, inputs):
    x = torch.from_numpy(INPUTS[inputs](rng, (n, nin)))
    ga, be, sw, bw, _ = (torch.from_numpy(a) for a in fast_params(rng, nout, nin))
    return x, ga, be, sw * (10 / np.sqrt(nin * 8.0)), bw * 0.75


def _fast_plain(x, ga, be, sw, bw, dtype):
    grid = torch.from_numpy(GRID.copy())
    return K.fastkan_forward(*(a.to(dtype) for a in (x, ga, be, grid)), DEN, sw.to(dtype),
                             bw.to(dtype), torch.zeros(sw.shape[0], dtype=dtype))


@pytest.mark.parametrize("inputs", ["fast", "large"])
def test_embedder_depth_forward_meets_the_gates(inputs):
    """y at the embedder's 768 features (96 stages, 8 levels of 12), 1,024
    rows x 64 outputs, the LayerNorm and the base branch on: within TOL_KAN
    of the plain f32 version and no further from f64 than twice it, also
    with a third of x at |x| 20-60."""
    rng = np.random.default_rng(720 + len(inputs))
    x, ga, be, sw, bw = _fast_case(rng, 1024, 768, 64, inputs)
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()
    got, _ = rbf_tc_fwd(x, w, ga[None], be[None], torch.from_numpy(GRID.copy()), DEN, FLUSH)
    errs = _gates(f"fastkan y ({inputs})", got, _fast_plain(x, ga, be, sw, bw, torch.float32),
                  _fast_plain(x, ga, be, sw, bw, torch.float64))
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs


def test_embedder_depth_backward_meets_the_gates():
    """The Chebyshev embedder's dW over the vit-s embedder's 12,544 rows (16
    features, one dW block's, and its 384 outputs) in its 11 row splits,
    and dx over the 384 outputs, a tenth of x where tanh rounds to +-1:
    within TOL_KAN of the plain f32 version's autograd and no further from
    f64 than twice it, dx finite."""
    rng = np.random.default_rng(730)
    n, nin, out = 12544, 16, 384
    splits = FB.tc_grouped_dw_splits(n, 1, 768, out, N_SM)
    assert splits == 11
    x = torch.from_numpy(cheby_inputs(rng, (n, nin), 0.1))
    gy = torch.from_numpy(rng.standard_normal((n, out)).astype(np.float32))
    cc = torch.from_numpy((rng.standard_normal((nin, out, DEGREE + 1)) / np.sqrt(5 * nin))
                          .astype(np.float32))

    def plain(dtype):
        leaves = [a.to(dtype).requires_grad_(True) for a in (x, cc)]
        dx, dcc = torch.autograd.grad(K.chebykan_forward(*leaves), leaves, gy.to(dtype))
        return dx, FB.pack_cheby_weight(dcc)[0]

    b32, d32 = _emu_basis("cheby", x, DEGREE)
    w = FB.pack_cheby_weight(cc)[0]
    got = (grouped_dx(gy, w, d32), grouped_dw(b32, gy, splits))
    assert bool(torch.isfinite(got[0]).all())
    for name, a, p32, p64 in zip(("dx", "dW"), got, plain(torch.float32),
                                 plain(torch.float64)):
        errs = _gates(f"chebykan {name}", a, p32, p64)
        assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], (name, errs)


def test_small_batches_run_the_fastkan_levels_in_blocks_of_their_own():
    """The FastKAN embedder's forward takes 64-output blocks of 192 rows:
    one vit-s image (196 rows) is 2 x 6 = 12 blocks, below one wave, so its
    8 levels of 12 stages run as splits of their own, summed in level
    order, the order the emulation sums them in at every batch; batch 64
    (66 x 6 = 396 blocks) and the MNIST embedders (2 stages: one level) run
    one split. An image's rows give the same bits alone and in a batch."""
    assert FB.tc_fwd_outs("rbf", 384) == 64
    assert FB.tc_fwd_splits("fastkan", 196, 1, 768, 384, N_SM, "rbf") == 8
    assert FB.tc_fwd_splits("fastkan", 12544, 1, 768, 384, N_SM, "rbf") == 1
    assert FB.tc_fwd_splits("fastkan", 37 * 49, 1, 16, 64, N_SM, "rbf") == 1
    assert FB.tc_fwd_splits("fastkan_qkv_grouped", 196, 6, 64, 64, N_SM, "rbf") == 1
    w = torch.empty(1, 9, 768, 384)
    assert FB._tc_grouped_fwd_scratch(w, "cpu", "rbf").numel() == 6 * 96 * 10 * 64 * 16
    rng = np.random.default_rng(740)
    x, ga, be, sw, bw = _fast_case(rng, 60, 200, 16, "large")
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()
    grid = torch.from_numpy(GRID.copy())
    batch, _ = rbf_tc_fwd(x, w, ga[None], be[None], grid, DEN, FLUSH)
    alone, _ = rbf_tc_fwd(x[:7], w, ga[None], be[None], grid, DEN, FLUSH)
    assert torch.equal(batch[:7], alone)


def test_two_level_sum_leaves_the_fastkan_qkv_forward_alone():
    """``kan_rbf_sine.cu``'s q/k/v entry launches the template with no
    flush, in the 64-output shape it had (12 warps, one block an SM), now
    at every width; the embedder's with ``FASTKAN_EMB_FLUSH`` stages, the
    number ``TCG_FWD_FLUSH`` and the emulation use. Up to that many stages
    (the vit-s q/k/v's 64 features take 8) a two-level sum is one running
    sum, bit for bit, with the silu slice's second sum and without it; and
    the q/k/v's 64-output scratch is the one it had."""
    assert int(re.search(r"FASTKAN_EMB_FLUSH = (\d+);", RBF_SINE_CU).group(1)) == FLUSH

    def body(entry):
        return RBF_SINE_CU.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]

    assert "launch_tc_grouped_fwd<Rbf, RBF_FWD_WARPS, RBF_FWD_MINB, true>(" in body(
        "kanvit_fastkan_qkv_tc_fwd")
    assert "FASTKAN_EMB_FLUSH>(" in body("kanvit_fastkan_kan_tc_fwd")
    assert re.search(r"RBF_FWD_WARPS = 12, RBF_FWD_MINB = 1;", RBF_SINE_CU)
    assert FB.tc_fwd_outs("rbf", 64) == FB.tc_grouped_outs(64) == 64
    w = torch.empty(6, 9, 64, 64)
    assert FB._tc_grouped_fwd_scratch(w, "cpu", "rbf").numel() == 6 * 8 * 10 * 64 * 16
    rng = np.random.default_rng(750)
    grid = torch.from_numpy(GRID.copy())
    for nin in (64, 8 * FLUSH):
        x, ga, be, sw, bw = _fast_case(rng, 200, nin, 64, "large")
        for base in (bw, None):
            w = FB.pack_fastkan_weight(sw, base, 8).unsqueeze(0).contiguous()
            one, two = (rbf_tc_fwd(x, w, ga[None], be[None], grid, DEN, flush)[0]
                        for flush in (None, FLUSH))
            assert torch.equal(one, two)


def test_small_cheby_vit_through_the_tc_backward_matches_kanvit(kernel_math):
    """A small cheby ViT (2 blocks, d 16, 2 heads) with the embedder's
    backward and the q/k/v's forward and backward on the emulated tensor
    cores against kanvit's ``apply``: logits and gradients within 1e-3."""
    launched = _model_against_kanvit("cheby", kernel_math, 760)
    assert launched == {"chebykan": 1, "chebykan_bwd": 1,
                        "cheby_qkv_grouped": 2, "cheby_qkv_grouped_bwd": 2,
                        "flash_attention_lanes": 2, "flash_attention_lanes_bwd": 2}

