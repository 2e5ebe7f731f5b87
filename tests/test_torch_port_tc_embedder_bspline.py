"""The B-spline patch embedder on the tensor cores, its arithmetic emulated
on the CPU.

``bspline_kan`` (efficientkan's patch embedder) runs its forward on the
grouped q/k/v forward's template at one group (``kanvit_torch/kernels/
csrc/kan_basis_tc.cuh``, part 3, entry ``kanvit_bspline_kan_tc_fwd``) and
its backward on the grouped backward's templates (part 2, entry
``kanvit_bspline_qkv_tc_bwd``), both in 3xTF32 ``mma.sync.m16n8k8``
(``product`` of ``test_torch_port_attention_tc.py``: each f32 operand split
into big + small TF32 words, each 8-deep step small*big + big*small +
big*big into a zeroed accumulator that an f32 add takes into the running
sum). Here that arithmetic replaces the wrappers' launches, in the kernels'
own order:

- the forward (``test_torch_port_qkv_tc_fwd_cheby.grouped_fwd``): stages of
  8 features, each stage's 9 slices (8 cubic bases, silu) one 8-deep step
  each, the running sum of every 12 stages (``kan_basis.cu``'s
  ``BSPLINE_EMB_FLUSH``) added into y;
- dW (``test_torch_port_qkv_tc.grouped_dw``): over the rows in the splits
  of ``tc_grouped_dw_splits`` (rounded up to whole waves of blocks), a
  flush every 28 stages, the splits summed in order;
- dx (``grouped_dx``): gW = gy W^T over the outputs, then sum_s B'_s gW_s
  in slice order with the closed-form B-spline and silu derivatives.

Both are held against kanvit's Pallas ``bspline_kan`` in interpret mode and
``jax.grad`` through it within 1e-5 x max(1, max|.|): ragged rows, ragged
features (a stage of 4) and ragged outputs (40: one 64-output tile; 70: a
192-output tile), a sum past one level (13 stages), x on knots and outside
the spans, a third of x at |x| 20-60, over one split a stage and over 2
splits of 2 flush groups, with and without dx. At the embedder's depth (768
features, fewer rows; dW over vit-s's 12,544 rows in its 11 splits, dx
over its 384 outputs) the emulated kernels are within ``TOL_KAN`` of the
plain f32 version and no further from f64 than twice it; a small batch runs
the forward's levels in blocks of their own; and the two-level sum leaves
the grouped q/k/v forward's bits alone.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_kernels import _emu_basis, _jax_grads, kan_params, spline_inputs
from test_torch_port_qkv_tc import (
    N_SM,
    TOL,
    TOL_KAN,
    _gates,
    _rel,
    _torch_grads,
    emu_bwd,
    grouped_dw,
    grouped_dx,
)
from test_torch_port_qkv_tc_fwd_cheby import edge_inputs, emu_tc_fwd, grouped_fwd

KAN_BASIS_CU = (Path(FB.__file__).resolve().parent / "csrc" / "kan_basis.cu").read_text()
FLUSH = FB.TCG_FWD_FLUSH["bspline_kan"]


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
    """The CUDA path's Function with its launches replaced by the
    emulations; the backward's (need_dx, need_dw) recorded. kanvit on its
    Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    asked = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", emu_tc_fwd)
    yield monkeypatch, asked
    jdispatch.set_impl("auto")


def large_inputs(rng, shape, knots):
    """``spline_inputs`` with a third of the entries at |x| in [20, 60],
    outside every knot span: silu(x) dominates the row."""
    x = spline_inputs(rng, shape, knots)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 3, replace=False)
    flat[idx] = (rng.uniform(20.0, 60.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


INPUTS = {"spline": spline_inputs, "edges": edge_inputs, "large": large_inputs}


def _case(seed, n, nin, nout, inputs):
    rng = np.random.default_rng(seed)
    grid = np.array(JK.make_bspline_grid(nin))
    x = INPUTS[inputs](rng, (n, nin), grid[0])
    return rng, grid, x, kan_params(rng, nout, nin)


# (n, nin, nout, inputs): ragged rows and features (6 stages, the last of 4)
# at 40 outputs; 13 stages (past one level of the sum) at 70 outputs; 13
# stages with a third of x at |x| 20-60; 12 features (a ragged second
# stage), every x on a knot or outside the spans
FWD_CASES = [(37, 44, 40, "spline"), (70, 100, 70, "spline"), (45, 104, 24, "large"),
             (29, 12, 36, "edges")]


@pytest.mark.parametrize("n,nin,nout,inputs", FWD_CASES)
def test_bspline_kan_tc_fwd_matches_kanvit(kernel_math, n, nin, nout, inputs):
    assert "bspline_kan" in FB.TC_GROUPED_FWD  # the route emulated here
    _, grid, x, params = _case(600 + n + nin, n, nin, nout, inputs)
    want = np.asarray(JFB.bspline_kan(jnp.asarray(x), jnp.asarray(grid),
                                      *map(jnp.asarray, params)))
    with torch.inference_mode():
        got = FB.bspline_kan(torch.from_numpy(x), torch.from_numpy(grid),
                             *map(torch.from_numpy, params))
    assert got.shape == (n, nout)
    assert _rel(got, want) <= TOL
    assert FB.LAUNCHES["bspline_kan"] == 1


# (n, nin, nout, inputs, SMs): one 32-row stage a split at N_SM, 48 features
# (three 16-feature dW tiles) at 40 outputs; 13 forward stages at 70
# outputs with a third of x at |x| 20-60; 2,000 rows over 2 splits of 32
# and 31 stages, each 2 flush groups (one SM)
BWD_CASES = [(83, 48, 40, "spline", N_SM), (83, 100, 70, "large", N_SM),
             (2000, 24, 40, "spline", 1)]


@pytest.mark.parametrize("n,nin,nout,inputs,sms", BWD_CASES)
def test_bspline_kan_tc_bwd_matches_kanvit(kernel_math, n, nin, nout, inputs, sms):
    """Every gradient against ``jax.grad`` through kanvit's kernel; the
    training step's call (x no leaf) asks for no dx and gives the
    all-gradients call's weight gradients bit for bit."""
    monkeypatch, asked = kernel_math

    def bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
        asked.append((need_dx, need_dw))
        return emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw, sms)

    monkeypatch.setattr(FB, "_launch_bwd", bwd)
    assert "bspline_kan_bwd" in FB.TC_GROUPED_BWD  # the route emulated here
    rng, grid, x, params = _case(610 + n + nin, n, nin, nout, inputs)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    tgrid = torch.from_numpy(grid)
    want_y, want = _jax_grads(lambda *a: JFB.bspline_kan(a[0], jnp.asarray(grid), *a[1:]),
                              (x, *params), g)
    got_y, got = _torch_grads(lambda *a: FB.bspline_kan(a[0], tgrid, *a[1:]), (x, *params), g)
    assert _rel(got_y, want_y) <= TOL
    for name, a, b in zip(("x", "bw", "sw", "sc"), got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL, name
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in params]
    y = FB.bspline_kan(torch.from_numpy(x), tgrid, *leaves)
    no_dx = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    assert all(torch.equal(a, b) for a, b in zip(no_dx, got[1:]))
    assert asked == [(True, True), (False, True)]
    assert (FB.LAUNCHES["bspline_kan"], FB.LAUNCHES["bspline_kan_bwd"]) == (2, 2)


def _packed_plain(x, grid, w):
    """The plain version over the packed weight ``(9, nin, out)``."""
    return K.bspline_kan_forward(x, grid.to(x.dtype), w[-1].T, w[:-1].permute(2, 1, 0), None)


@pytest.mark.parametrize("inputs", ["spline", "large"])
def test_embedder_depth_forward_meets_the_gates(inputs):
    """y at the embedder's 768 features (96 stages, 8 levels of 12), 1,024
    rows x 64 outputs: within TOL_KAN of the plain f32 version and no
    further from f64 than twice it."""
    rng = np.random.default_rng(620 + len(inputs))
    n, nin, out = 1024, 768, 64
    grid = K.make_bspline_grid(nin)
    x = torch.from_numpy(INPUTS[inputs](rng, (n, nin), grid[0].numpy()))
    w = FB.pack_weight(*(torch.from_numpy(a) for a in (
        (rng.standard_normal((out, nin)) / np.sqrt(nin)).astype(np.float32),
        (rng.standard_normal((out, nin, 8)) * 0.1).astype(np.float32),
        (rng.standard_normal((out, nin)) / np.sqrt(nin)).astype(np.float32))))
    b32, _ = _emu_basis("bspline", x, grid)
    errs = _gates(f"y ({inputs})", grouped_fwd(b32, w, flush=FLUSH),
                  _packed_plain(x, grid, w), _packed_plain(x.double(), grid, w.double()))
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs


def test_embedder_depth_backward_meets_the_gates():
    """dW over the vit-s embedder's 12,544 rows (16 features, one dW
    block's, and its 384 outputs) in its 11 row splits, and dx over the
    384 outputs: within TOL_KAN of the plain f32 version's autograd and no
    further from f64 than twice it."""
    rng = np.random.default_rng(630)
    n, nin, out = 12544, 16, 384
    splits = FB.tc_grouped_dw_splits(n, 1, 768, out, N_SM)
    assert splits == 11
    grid = K.make_bspline_grid(nin)
    x = torch.from_numpy(spline_inputs(rng, (n, nin), grid[0].numpy()))
    gy = torch.from_numpy(rng.standard_normal((n, out)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((9, nin, out)) / np.sqrt(9 * nin))
                         .astype(np.float32))

    def plain(dtype):
        leaves = [a.to(dtype).requires_grad_(True) for a in (x, w)]
        return torch.autograd.grad(_packed_plain(*leaves[:1], grid, leaves[1]), leaves,
                                   gy.to(dtype))

    b32, d32 = _emu_basis("bspline", x, grid)
    for name, got, p32, p64 in zip(("dx", "dW"),
                                   (grouped_dx(gy, w, d32), grouped_dw(b32, gy, splits)),
                                   plain(torch.float32), plain(torch.float64)):
        errs = _gates(name, got, p32, p64)
        assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], (name, errs)


def test_small_batches_run_each_level_in_blocks_of_their_own():
    """Below one wave of forward blocks the embedder's levels run as splits
    of their own (one vit-s image: 2 row tiles x 2 output tiles = 4 blocks
    of 96 stages, 8 levels of 12), summed in level order, the order the
    emulation sums them in at every batch; at batch 64, and where there is
    one level (the MNIST embedders' 2 stages), one split; the grouped q/k/v
    (one level) never."""
    assert FB.tc_fwd_splits("bspline_kan", 196, 1, 768, 384, N_SM) == 8
    assert FB.tc_fwd_splits("bspline_kan", 12544, 1, 768, 384, N_SM) == 1
    assert FB.tc_fwd_splits("bspline_kan", 37 * 49, 1, 16, 64, N_SM) == 1
    assert FB.tc_fwd_splits("bspline_kan", 196, 1, 100, 70, N_SM) == 2  # 13 stages
    assert FB.tc_fwd_splits("bspline_qkv_grouped", 196, 6, 64, 192, N_SM) == 1


def test_two_level_sum_leaves_the_qkv_forward_alone():
    """Only the embedders' entries sum in two levels: ``TCG_FWD_FLUSH`` names
    the B-spline one, the FastKAN one (``kan_rbf_sine.cu``) and the
    Chebyshev one,
    ``kan_basis.cu``'s q/k/v entry launches the template with no flush, the
    embedder's with ``BSPLINE_EMB_FLUSH`` stages, the number
    ``TCG_FWD_FLUSH`` and the emulation use; and up to that many stages (nin
    <= 96: the vit-s q/k/v's 64 take 8) a two-level sum is one running sum,
    bit for bit."""
    assert set(FB.TCG_FWD_FLUSH) == {"bspline_kan", "fastkan", "chebykan"}
    assert int(re.search(r"BSPLINE_EMB_FLUSH = (\d+);", KAN_BASIS_CU).group(1)) == FLUSH

    def body(entry):
        return KAN_BASIS_CU.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]

    assert "launch_tc_grouped_fwd<Bspline>(" in body("kanvit_bspline_qkv_tc_fwd")
    assert "BSPLINE_EMB_FLUSH>(" in body("kanvit_bspline_kan_tc_fwd")
    rng = np.random.default_rng(640)
    for nin in (64, 8 * FLUSH):
        grid = K.make_bspline_grid(nin)
        x = torch.from_numpy(spline_inputs(rng, (200, nin), grid[0].numpy()))
        w = torch.from_numpy((rng.standard_normal((9, nin, 192)) * 0.3).astype(np.float32))
        b32, _ = _emu_basis("bspline", x, grid)
        assert torch.equal(grouped_fwd(b32, w), grouped_fwd(b32, w, flush=FLUSH))
