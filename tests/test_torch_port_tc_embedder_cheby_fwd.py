"""The Chebyshev embedder's forward on the tensor cores, its arithmetic
emulated on the CPU.

``chebykan`` (the cheby ViT's patch embedder) runs its forward on the
grouped q/k/v forward's template at one group (``kanvit_torch/kernels/
csrc/kan_basis_tc.cuh``, part 3, entry ``kanvit_chebykan_tc_fwd``): 64
outputs a block, ``CHEBY_EMB_WARPS`` warps of 16 rows, stages of 8
features whose 5 slices (T_0..T_4 of tanh x) are one 3xTF32
``mma.sync.m16n8k8`` step each (``product`` of
``test_torch_port_attention_tc.py``: each f32 operand split into big +
small TF32 words, each 8-deep step small*big + big*small + big*big into a
zeroed accumulator that an f32 add takes into the running sum), the
running sum added into y every ``CHEBY_EMB_FLUSH`` stages and restarted.
Here that arithmetic (``test_torch_port_qkv_tc_fwd_cheby.grouped_fwd`` at
one group with the flush) replaces the wrapper's launch.

It is held against kanvit's Pallas ``chebykan`` in interpret mode within
1e-5 x max(1, max|y|) at small shapes, with and without x where tanh
rounds to +-1, past one level of the sum; at the embedder's 768 features
(96 stages) it is within ``TOL_KAN`` of the plain f32 version and no
further from f64 than twice it, nearer than one running sum; a small
batch runs the levels in blocks of their own and an image's rows keep
their bits; the source's flush and warps are the wrapper's; and a small
cheby ViT through the emulated routes gives kanvit's logits and gradients.
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
from test_torch_port_kernels import _emu_basis, _emu_lanes_bwd, _emu_lanes_fwd
from test_torch_port_qkv_tc import N_SM, TOL, TOL_KAN, _gates, _rel
from test_torch_port_qkv_tc_fwd_cheby import cheby_inputs, emu_tc_bwd, emu_tc_fwd, grouped_fwd
from test_torch_port_qkv_tc_fwd_rbf_sine import _model_against_kanvit

CSRC = Path(FB.__file__).resolve().parent / "csrc"
KAN_BASIS_CU = (CSRC / "kan_basis.cu").read_text()
FLUSH = FB.TCG_FWD_FLUSH["chebykan"]
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
    emulation (the KAN forwards and backwards on the tensor cores, the
    lanes attention), kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", emu_tc_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_tc_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    yield monkeypatch
    jdispatch.set_impl("auto")


def _coeffs(rng, nin, nout):
    return (rng.standard_normal((nin, nout, DEGREE + 1)) / np.sqrt(5 * nin)).astype(np.float32)


# (n, nin, nout, saturated share): ragged rows and features (6 stages, the
# last of 4) at 40 outputs; 13 stages (past one level) at 70 outputs (two
# 64-output blocks) with a tenth saturated; narrow and three tenths; all
# of x saturated, 13 stages
FWD_CASES = [(37, 44, 40, 0.0), (70, 104, 70, 0.1), (45, 16, 24, 0.3), (50, 100, 30, 1.0)]


@pytest.mark.parametrize("n,nin,nout,saturated", FWD_CASES)
def test_chebykan_tc_fwd_matches_kanvit(kernel_math, n, nin, nout, saturated):
    assert "chebykan" in FB.TC_GROUPED_FWD  # the route emulated here
    rng = np.random.default_rng(800 + n + nin)
    x = cheby_inputs(rng, (n, nin), saturated)
    cc = _coeffs(rng, nin, nout)
    want = np.asarray(JFB.chebykan(jnp.asarray(x), jnp.asarray(cc)))
    with torch.inference_mode():
        got = FB.chebykan(torch.from_numpy(x), torch.from_numpy(cc))
    assert got.shape == (n, nout)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL
    assert FB.LAUNCHES["chebykan"] == 1


def _case(rng, n, nin, nout, saturated):
    x = torch.from_numpy(cheby_inputs(rng, (n, nin), saturated))
    return x, torch.from_numpy(_coeffs(rng, nin, nout))


@pytest.mark.parametrize("saturated", [0.0, 0.1])
def test_embedder_depth_forward_meets_the_gates(saturated):
    """y at the embedder's 768 features (96 stages, 4 levels of 24), 1,024
    rows x 64 outputs, without and with a tenth of x where tanh rounds to
    +-1: within TOL_KAN of the plain f32 version and no further from f64
    than twice it, and nearer f64 than one running sum over the 96 stages
    (1.6-2.3x the plain version's distance over five draws)."""
    rng = np.random.default_rng(810 + int(10 * saturated))
    x, cc = _case(rng, 1024, 768, 64, saturated)
    basis, _ = _emu_basis("cheby", x, DEGREE)
    w = FB.pack_cheby_weight(cc)[0]
    plain32, plain64 = K.chebykan_forward(x, cc), K.chebykan_forward(x.double(), cc.double())
    errs = _gates(f"chebykan y ({saturated})", grouped_fwd(basis, w, flush=FLUSH), plain32,
                  plain64)
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs
    one = _gates(f"chebykan y, one running sum ({saturated})", grouped_fwd(basis, w),
                 plain32, plain64)
    assert errs[1] < one[1], (errs, one)


def test_small_batches_run_the_cheby_levels_in_blocks_of_their_own():
    """The Chebyshev embedder's forward takes 64-output blocks of 12 warps
    (192 rows): one vit-s image (196 rows) is 2 x 6 = 12 blocks, below one
    wave, so its 4 levels of 24 stages run as splits of their own, summed
    in level order, the order the emulation sums them in at every batch;
    batch 64 (66 x 6 = 396 blocks) and the MNIST embedders (2 stages: one
    level) run one split; the q/k/v forward never splits. An image's rows
    give the same bits alone and in a batch."""
    assert FB.tc_fwd_outs("cheby", 384) == 64
    assert FB.tc_fwd_splits("chebykan", 196, 1, 768, 384, N_SM, "cheby") == 4
    assert FB.tc_fwd_splits("chebykan", 12544, 1, 768, 384, N_SM, "cheby") == 1
    assert FB.tc_fwd_splits("chebykan", 37 * 49, 1, 16, 64, N_SM, "cheby") == 1
    assert FB.tc_fwd_splits("cheby_qkv_grouped", 196, 6, 64, 192, N_SM, "cheby") == 1
    w = torch.empty(1, DEGREE + 1, 768, 384)
    assert FB._tc_grouped_fwd_scratch(w, "cpu", "cheby").numel() == 6 * 96 * 5 * 64 * 16
    rng = np.random.default_rng(820)
    x, cc = _case(rng, 60, 200, 16, 0.1)
    w = FB.pack_cheby_weight(cc)[0]
    batch = grouped_fwd(_emu_basis("cheby", x, DEGREE)[0], w, flush=FLUSH)
    alone = grouped_fwd(_emu_basis("cheby", x[:7], DEGREE)[0], w, flush=FLUSH)
    assert torch.equal(batch[:7], alone)


def test_source_flush_and_rows_a_block_are_the_wrappers():
    """``kan_basis.cu``'s embedder entry launches the template with
    ``CHEBY_EMB_FLUSH`` stages a level and ``CHEBY_EMB_WARPS`` warps, the
    numbers ``TCG_FWD_FLUSH`` and ``TCG_FWD_WARPS`` hold (``tc_fwd_splits``
    counts blocks of 16 x those warps rows), at 64-output tiles; the q/k/v
    entry without a flush in its own shape. The other two-level entries'
    warps are their launches' too: the B-spline embedder's 192-output shape
    (``tcf::WARPS``) and the FastKAN one's ``RBF_FWD_WARPS``."""
    consts = dict((k, int(v)) for k, v in re.findall(
        r"(CHEBY_EMB_\w+) = (\d+)", KAN_BASIS_CU))
    assert consts["CHEBY_EMB_FLUSH"] == FLUSH
    assert consts["CHEBY_EMB_WARPS"] == FB.TCG_FWD_WARPS["chebykan"]

    def body(entry):
        return KAN_BASIS_CU.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]

    assert ("launch_tc_grouped_fwd<Cheby, CHEBY_EMB_WARPS, CHEBY_EMB_MINB, true, "
            "CHEBY_EMB_FLUSH>(") in body("kanvit_chebykan_tc_fwd")
    assert "launch_tc_grouped_fwd<Cheby, CHEBY_FWD_WARPS, CHEBY_FWD_MINB, true>(" in body(
        "kanvit_cheby_qkv_tc_fwd")
    assert "tcf::WARPS, 1, false, BSPLINE_EMB_FLUSH>(" in body("kanvit_bspline_kan_tc_fwd")
    tc = (CSRC / "kan_basis_tc.cuh").read_text()
    assert int(re.search(r"constexpr int WARPS = (\d+);", tc).group(1)) == FB.TCG_FWD_WARPS[
        "bspline_kan"]
    rbf = (CSRC / "kan_rbf_sine.cu").read_text()
    assert int(re.search(r"RBF_FWD_WARPS = (\d+),", rbf).group(1)) == FB.TCG_FWD_WARPS[
        "fastkan"]
    assert "RBF_FWD_WARPS, RBF_FWD_MINB, true, FASTKAN_EMB_FLUSH>(" in rbf
    assert set(FB.TCG_FWD_WARPS) == set(FB.TCG_FWD_FLUSH)


def test_two_level_sum_leaves_the_cheby_qkv_forward_alone():
    """Up to ``FLUSH`` stages (the vit-s q/k/v's 64 features take 8) a
    two-level sum is one running sum, bit for bit, saturated x or not."""
    rng = np.random.default_rng(830)
    for nin in (64, 8 * FLUSH):
        x, cc = _case(rng, 200, nin, 64, 0.1)
        basis = _emu_basis("cheby", x, DEGREE)[0]
        w = FB.pack_cheby_weight(cc)[0]
        assert torch.equal(grouped_fwd(basis, w), grouped_fwd(basis, w, flush=FLUSH))


def test_small_cheby_vit_through_the_tc_forward_matches_kanvit(kernel_math):
    """A small cheby ViT (2 blocks, d 16, 2 heads) with the embedder's
    forward and backward and the q/k/v's on the emulated tensor cores
    against kanvit's ``apply``: logits and gradients within 1e-3."""
    launched = _model_against_kanvit("cheby", kernel_math, 840)
    assert launched == {"chebykan": 1, "chebykan_bwd": 1,
                        "cheby_qkv_grouped": 2, "cheby_qkv_grouped_bwd": 2,
                        "flash_attention_lanes": 2, "flash_attention_lanes_bwd": 2}
