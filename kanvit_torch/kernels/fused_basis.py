"""Fused KAN layers on the card, forward and backward (counterpart of
``kanvit/kernels/fused_basis.py``).

Nine entry points share the templated CUDA kernels of
``csrc/kan_basis.cuh``, one instantiation per basis family
(``csrc/kan_basis.cu``: B-spline, Chebyshev, Fourier; ``csrc/kan_rbf_sine.cu``:
RBF with its LayerNorm, sine):

- :func:`bspline_kan` — one efficient-kan KANLinear (the patch embedder);
- :func:`bspline_qkv_grouped` — the joint B-spline q/k/v projection of every
  attention head in one launch, one group per head;
- :func:`chebykan` — one ChebyKAN layer (degree 4);
- :func:`cheby_qkv_grouped` — the joint Chebyshev q/k/v projection;
- :func:`fourierkan` — one NaiveFourierKAN layer (any grid size);
- :func:`fastkan` — one FastKAN layer: its LayerNorm, 8 RBF centres and the
  silu base branch in the kernels (the LayerNorm and the base branch each
  optional);
- :func:`fastkan_qkv_grouped` — one FastKAN q, k or v projection of every
  head in one launch, a LayerNorm per head;
- :func:`sinekan` — one SineKAN layer (any grid size);
- :func:`sinekan_qkv_grouped` — one SineKAN q, k or v projection of every
  head in one launch, a freq per head.

:func:`fourierkan` and :func:`sinekan` run their forward and weight gradient
(sine's dfreq with it) on the tensor cores instead (``csrc/kan_basis_tc.cuh``,
3xTF32 ``mma.sync`` over a basis generated on chip), their dx on the
CUDA-core template. The backward (dx and dW) of :func:`bspline_qkv_grouped`,
:func:`cheby_qkv_grouped`, :func:`fastkan_qkv_grouped` and
:func:`sinekan_qkv_grouped`, and of :func:`bspline_kan`, :func:`fastkan` and
:func:`chebykan` as their one-group case, runs on the tensor cores too
(``csrc/kan_basis_tc.cuh``, part 2: 3xTF32 ``mma.sync``, dW over a basis
generated on chip in row splits summed in a fixed order, dx with the basis
derivative or the family's fold in the epilogue: FastKAN's dln for its
LayerNorm's VJP, sine's dfreq sums), and so does the forward of
:func:`bspline_qkv_grouped`, :func:`cheby_qkv_grouped`,
:func:`fastkan_qkv_grouped` (after its LayerNorm's statistics),
:func:`sinekan_qkv_grouped` and, as their one-group case with its 768-deep
sum in two levels, :func:`bspline_kan`, :func:`fastkan` and :func:`chebykan`
(part 3: each lane makes the basis of its own A fragments in registers).
The route is chosen by call site, never by size, with one exception: the
tensor-core tiles hold at most 4 sine slices, so a grouped sine forward or
backward of a larger grid takes the CUDA-core kernels.

Dispatch is by device (``kanvit_torch.ops.dispatch``): a CPU tensor runs the
plain version in ``kanvit_torch.ops.kan_bases`` and autograd differentiates
it; a CUDA tensor goes through :class:`_KanFn`, :class:`_RbfFn` or
:class:`_SineFn`, whose forward and backward launch the kernels or raise.
The kernels are built for f32; the B-spline one for spline order 3 and a
12-knot grid (grid size 5, the efficient-kan default), the Chebyshev one for
degree 4, the RBF one for 8 centres; they raise on anything else.

bf16 (kanvit's bf16 serving and training): every entry point above
(``BF16_FAMILY``) takes bf16 x and weights (the knot grid, the RBF centres
and the sine phase table stay f32; FastKAN's LayerNorm gamma and beta and
sine's freq bf16, upcast in the kernels) and returns bf16, through part 3's
``Bf16`` operand type forward and part 4's kernels backward
(``csrc/kan_basis_tc.cuh``): the basis (B-spline, T_0..T_4 of tanh x, the
RBF bases of the f32 LayerNorm and silu of the raw x, sin(x freq + phase)
with its argument formed in f32, or cos/sin(kx) by the angle-addition
recurrence from cos/sin(x)) made in f32 from the upcast x and rounded to
bf16 at the dot, ``spline_weight * spline_scaler`` formed in bf16 as kanvit
forms it, f32 accumulation, y, dx, dW (and dgamma, dbeta, dfreq) each
rounded once (kanvit's ``_fwd_kernel`` / ``_bwd_kernel``,
``_rbf_ln_fwd_kernel`` / ``_rbf_ln_bwd_kernel``, the sine kernels and the
Fourier K-blocked kernels on bf16 operands). The sine embedder's 28 slices
and the Fourier embedder's 56 walk the kernels' 4-slice tile in chunks.
Their launches count under ``<name>_bf16`` and ``<name>_bwd_bf16``. On the
CPU the bf16 route is the kernels' plain twins (``K.<family>_grouped_forward_bf16``
and ``K.<family>_grouped_backward_bf16`` of ``bspline``, ``cheby``,
``fourier``, ``fastkan`` and ``sine``) through :class:`_KanBf16Plain`,
:class:`_RbfBf16Plain` and :class:`_SineBf16Plain`, whose backward is
explicit: autograd through the forward twin would round at every op, which
is not kanvit's policy.

The Functions take the packed weight ``(G, S, nin, out)`` and return its
gradient, and the RBF one the LayerNorm's dgamma and dbeta, the sine one
dfreq; the packing (:func:`pack_weight` and the other ``pack_*``) is plain
differentiable torch, so autograd carries d(packed) back to the layer's
parameters, as kanvit builds its packed weight with jnp ops outside the
``custom_vjp``. The knot grid, the RBF centres and the sine phase table get
no gradient (kanvit returns zeros for them).

``LAUNCHES`` counts kernel launches per entry point (``<name>`` for the
forward, ``<name>_bwd`` for the backward); the CPU path never counts.
"""

from __future__ import annotations

import torch

from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K

KNOTS = 12
SPLINE_ORDER = 3
N_SPLINE = KNOTS - SPLINE_ORDER - 1  # 8 spline bases
N_SLICES = N_SPLINE + 1              # + the silu slice
CHEBY_DEGREE = 4
RBF_GRIDS = 8                        # RBF centres, as the kernel is built
SINE_CHUNK = 4                       # sine (and bf16 Fourier) slices a chunk, as in the kernels
MAX_ROW_TILES = 65535                # the kernel's grid.y limit, 64 rows each
ROWS_PER_TILE = 64

# The entry points with bf16 kernels and their families (C entries
# kanvit_bspline_tc_fwd_bf16 and kanvit_bspline_tc_bwd_bf16,
# kanvit_cheby_tc_fwd_bf16 and kanvit_cheby_tc_bwd_bf16,
# kanvit_fastkan_tc_fwd_bf16 and kanvit_fastkan_tc_bwd_bf16,
# kanvit_sinekan_tc_fwd_bf16 and kanvit_sinekan_tc_bwd_bf16,
# kanvit_fourierkan_tc_fwd_bf16 and kanvit_fourierkan_tc_bwd_bf16; the RBF and
# sine ones through _launch_rbf / _launch_rbf_bwd and _launch_sine /
# _launch_sine_bwd, by x's dtype).
BF16_FAMILY = {"bspline_kan": "bspline", "bspline_qkv_grouped": "bspline",
               "chebykan": "cheby", "cheby_qkv_grouped": "cheby",
               "fourierkan": "fourier",
               "fastkan": "rbf", "fastkan_qkv_grouped": "rbf",
               "sinekan": "sine", "sinekan_qkv_grouped": "sine"}
BF16_FWD = tuple(BF16_FAMILY)
# The families _launch_bf16 and _launch_bwd_bf16 take.
KAN_BF16 = ("bspline", "cheby", "fourier")
LAUNCHES = {name: 0 for base in ("bspline_kan", "bspline_qkv_grouped",
                                 "chebykan", "cheby_qkv_grouped", "fourierkan",
                                 "fastkan", "fastkan_qkv_grouped", "sinekan",
                                 "sinekan_qkv_grouped")
            for name in (base, f"{base}_bwd")}
LAUNCHES.update({f"{name}{sfx}_bf16": 0 for name in BF16_FWD for sfx in ("", "_bwd")})
# Blocks the dW reduction aims at before it cuts its rows into splits
# (132 SMs of an H100, several 64-thread blocks each).
DW_TARGET_BLOCKS = 1024
DW_MIN_ROWS_PER_SPLIT = 128
DW_TILE = (8, 64)  # (features, outputs) per dW block, as in the kernel
DX_TILE = (64, 16)  # (rows, features) per dx block, as in the kernel
LN_ROWS_PER_SPLIT = 64  # rows per partial of the LayerNorm's dgamma, dbeta
# The tensor-core kernels' tiles (csrc/kan_basis_tc.cuh): rows and outputs
# of C a block (the sine forward's 48 x 384), contracted entries a stage,
# features of a dW block and of a forward stage (Fourier: 16 features' cos
# and sin; sine: 32 features' sin).
TC_OUTS, TC_STAGE, TC_DW_FEATURES = 192, 32, 48
TC_SINE_FWD_ROWS, TC_SINE_FWD_OUTS = 48, 384
TC_FWD_FEATURES = {"fourier": 16, "sine": 32}
# The call sites on the tensor-core kernels (the rest: the CUDA-core ones).
TC_ROUTES = ("fourierkan", "sinekan")
# The grouped backward on the tensor cores (csrc/kan_basis_tc.cuh, part 2),
# and the B-spline, FastKAN and Chebyshev embedders' as its one-group case:
# features a block (an m16 tile a slice), the dW kernel's 32-row stages and
# its outputs a block (64 up to nout 64, else 192), and the dx kernel's rows
# a block and 16-output stages; the slices a family's tile holds (its SC).
# The Chebyshev embedder's no-dx backward keeps the tensor cores at one
# vit-s image, where the CUDA-core kernels took ~5 us less of the card
# (0.063 against 0.068 ms; at the MNIST embedders the tensor cores took 7
# us against 39; kanvit_torch/probe_embedder_rbf.py --cheby, NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md).
TC_GROUPED_BWD = ("bspline_qkv_grouped_bwd", "cheby_qkv_grouped_bwd",
                  "fastkan_qkv_grouped_bwd", "sinekan_qkv_grouped_bwd", "fastkan_bwd",
                  "bspline_kan_bwd", "chebykan_bwd")
TCG_FEATURES, TCG_DX_ROWS, TCG_DX_STAGE = 16, 128, 16
TCG_SLICES = {"bspline": N_SLICES, "cheby": CHEBY_DEGREE + 1, "rbf": RBF_GRIDS + 1,
              "sine": SINE_CHUNK, "fourier": SINE_CHUNK}
# The grouped forward on the tensor cores (part 3), and the B-spline and
# FastKAN embedders' as its one-group case: its features a stage (one mma
# step a slice), its outputs a block (``tc_fwd_outs``), and the steps of a
# stage's split W a family (its tile's slices; RBF one more, the silu
# slice's remainders; the entries take the scratch's word count and refuse
# one too short for their steps); sine up to SINE_CHUNK slices.
TC_GROUPED_FWD = ("bspline_qkv_grouped", "cheby_qkv_grouped", "fastkan_qkv_grouped",
                  "sinekan_qkv_grouped", "bspline_kan", "fastkan", "chebykan")
# The call sites whose forward sums in two levels, and the stages of a level
# (kan_basis.cu's BSPLINE_EMB_FLUSH and CHEBY_EMB_FLUSH, kan_rbf_sine.cu's
# FASTKAN_EMB_FLUSH); the warps of 16 rows a block of each one's launch
# (kan_basis.cu: the B-spline embedder's 192-output shape, tcf::WARPS, and
# CHEBY_EMB_WARPS; kan_rbf_sine.cu's RBF_FWD_WARPS), which decide with its
# outputs when its levels run in blocks of their own.
TCG_FWD_FLUSH = {"bspline_kan": 12, "fastkan": 12, "chebykan": 24}
TCG_FWD_WARPS = {"bspline_kan": 12, "fastkan": 12, "chebykan": 12}
# The B-spline and FastKAN embedders' forwards keep the tensor cores at
# every size: below one wave of their blocks (the MNIST embedders, 16 -> 64)
# the CUDA-core kernels took 1-6 us less of the card and ~25 us less of the
# host a call, but landed 3.0e-07 (B-spline) and 4.6e-07 (FastKAN) from f64
# against the plain f32 version's 1.3e-07, past the twice that the tensor
# cores hold (chip_smoke.py and kanvit_torch/probe_embedder_rbf.py
# --bspline, --fastkan, NVIDIA H100 80GB HBM3 at 700 W; PERF.md). So does
# the Chebyshev embedder's, by the call-site rule: at the MNIST embedder its
# CUDA-core kernel took 1.5 us less of the card (0.0097 against 0.0112 ms)
# and held the gate (3.3e-07 from f64, the plain's 4.1e-07, the tensor
# cores' 1.9e-07; chip_smoke.py, PERF.md).
TCG_FWD_FEATURES = 8
TCG_FWD_STEPS = {"bspline": N_SLICES, "cheby": CHEBY_DEGREE + 1, "rbf": RBF_GRIDS + 2,
                 "sine": SINE_CHUNK}
# 64 outputs a forward block at every width (RBF: its 10 steps a stage do
# not fit two stages of 192 outputs in shared memory); the bf16 forwards
# take 192 past 64 outputs (kan_basis.cu's CHEBY_BF16_*)
TCG_FWD_NARROW = ("cheby", "rbf")
TCG_DW_TARGET_BLOCKS = 4  # blocks an SM the dW row splits aim at


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def pack_weight(base_weight, spline_weight, spline_scaler):
    """``(out, in)``, ``(out, in, 8)``, ``(out, in)`` -> ``(9, in, out)``:
    the scaled spline slices then ``base_weight.T`` as the silu slice, as
    ``kanvit/kernels/fused_basis.py:3566-3586`` packs them (the port always
    folds the silu slice in)."""
    scaled = (spline_weight * spline_scaler.unsqueeze(-1)
              if spline_scaler is not None else spline_weight)
    return torch.cat([scaled.permute(2, 1, 0), base_weight.T.unsqueeze(0)], 0)


def pack_qkv_weight(bw, sw, sc):
    """Per-head ``(H, out, dh)``, ``(H, out, dh, 8)``, ``(H, out, dh)`` ->
    ``(H, 9, dh, out)`` (``kanvit/kernels/fused_basis.py:1383-1389``)."""
    scaled = (sw * sc.unsqueeze(-1)).permute(0, 3, 2, 1)  # (H, 8, dh, out)
    return torch.cat([scaled, bw.transpose(1, 2).unsqueeze(1)], 1)


def pack_cheby_weight(coeffs):
    """``(in, out, degree+1)`` -> ``(1, degree+1, in, out)``, slice n the
    weights of T_n (``kanvit/kernels/fused_basis.py:3785``)."""
    return coeffs.permute(2, 0, 1).unsqueeze(0)


def pack_cheby_qkv_weight(cc):
    """Per-head ``(H, dh, out, D)`` -> ``(H, D, dh, out)``
    (``kanvit/kernels/fused_basis.py:1408``)."""
    return cc.permute(0, 3, 1, 2)


def pack_fourier_weight(coeffs):
    """``(2, out, in, G)`` -> ``(1, 2G, in, out)``: the cos harmonics
    k = 1..G, then the sin harmonics (``kanvit/kernels/fused_basis.py:3766``)."""
    _, nout, nin, grid_size = coeffs.shape
    return coeffs.permute(0, 3, 2, 1).reshape(1, 2 * grid_size, nin, nout)


def pack_fastkan_weight(spline_weight, base_weight, num_grids):
    """``(out, in*G)`` and ``(out, in)`` or None -> ``(G [+1], in, out)``: the
    RBF slices, then ``base_weight.T`` as the silu slice
    (``kanvit/kernels/fused_basis.py:3612,3621``)."""
    nout = spline_weight.shape[0]
    w = spline_weight.reshape(nout, -1, num_grids).permute(2, 1, 0)
    if base_weight is None:
        return w
    return torch.cat([w, base_weight.T.unsqueeze(0)], 0)


def pack_fastkan_qkv_weight(sw, bw, num_grids):
    """Per-head ``(H, out, dh*G)`` and ``(H, out, dh)`` -> ``(H, G+1, dh, out)``
    (``kanvit/kernels/fused_basis.py:3319-3321``)."""
    h, nout, dh = bw.shape
    w = sw.reshape(h, nout, dh, num_grids).permute(0, 3, 2, 1)
    return torch.cat([w, bw.transpose(1, 2).unsqueeze(1)], 1)


def pack_sine_weight(amplitudes):
    """``(out, in, G)`` -> ``(1, G, in, out)``
    (``kanvit/kernels/fused_basis.py:3677``)."""
    return amplitudes.permute(2, 1, 0).unsqueeze(0)


def pack_sine_qkv_weight(amps):
    """Per-head ``(H, out, dh, G)`` -> ``(H, G, dh, out)``."""
    return amps.permute(0, 3, 2, 1)


def _chunks(family: str, slices: int) -> int:
    """Chunks of 4 slices a kernel walks: sine's (the CUDA-core dW and the
    bf16 kernels) and the bf16 Fourier kernels' (2 harmonics a chunk) of
    ``slices`` slices; one for the other families."""
    return -(-slices // SINE_CHUNK) if family in ("sine", "fourier") else 1


def _check_spline_order(spline_order: int) -> None:
    if spline_order != SPLINE_ORDER:
        raise ValueError(f"the kernel is built for spline order {SPLINE_ORDER}, "
                         f"got {spline_order}")


def _check_common(x2d: torch.Tensor, w: torch.Tensor, slices: int,
                  bf16: bool = False) -> None:
    """``bf16``: x and the weight may both be bf16 (the bf16 kernels)."""
    want = torch.bfloat16 if bf16 and x2d.dtype == torch.bfloat16 else torch.float32
    for name, t in (("x", x2d), ("weight", w)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {str(want)[6:]}, got {t.dtype} (bf16: "
                            "x and weight both bf16)")
    if x2d.dim() != 2 or w.dim() != 4:
        raise ValueError(f"expected x (N, G*nin) and w (G, {slices}, nin, out), "
                         f"got {tuple(x2d.shape)} and {tuple(w.shape)}")
    groups, s, nin, _ = w.shape
    if s != slices or x2d.shape[1] != groups * nin:
        raise ValueError(f"x {tuple(x2d.shape)} does not match packed weight "
                         f"{tuple(w.shape)}")
    if x2d.shape[1] > 1 and x2d.stride(1) != 1:
        raise ValueError("x must have a unit column stride")
    if not w.is_contiguous():
        raise ValueError("packed weight must be contiguous")
    if -(-x2d.shape[0] // ROWS_PER_TILE) > MAX_ROW_TILES or groups > 65535:
        raise ValueError(f"{x2d.shape[0]} rows x {groups} groups exceed the "
                         "kernel's launch grid")


def check_args(x2d: torch.Tensor, grid: torch.Tensor, w: torch.Tensor,
               spline_order: int, bf16: bool = False) -> None:
    """Raise on anything the B-spline kernel does not take (device aside).

    ``x2d (N, G*nin)`` with a unit column stride; ``grid (nin, 12)``, one
    for every group, or ``(G, nin, 12)``, a grid a group; ``w (G, 9, nin,
    out)`` contiguous; all f32, or (``bf16``, the bf16 kernels) x and w
    bf16 and the grid f32.
    """
    _check_spline_order(spline_order)
    if grid.dtype != torch.float32:
        raise TypeError(f"grid must be float32, got {grid.dtype}")
    _check_common(x2d, w, N_SLICES, bf16)
    groups, _, nin, _ = w.shape
    if tuple(grid.shape) not in ((nin, KNOTS), (groups, nin, KNOTS)):
        raise ValueError(f"grid must be ({nin}, {KNOTS}) or ({groups}, {nin}, "
                         f"{KNOTS}), got {tuple(grid.shape)}")


def _knot_rows(grid: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The knots as the kernels read them, ``(12, nin)`` rows (a grid a
    group: ``(G, 12, nin)``), and the stride between two groups' grids (0
    when they share one)."""
    gridt = grid.transpose(-1, -2).contiguous()
    return gridt, (gridt[0].numel() if grid.dim() == 3 else 0)


def check_cheby_args(x2d: torch.Tensor, w: torch.Tensor, degree: int,
                     bf16: bool = False) -> None:
    """Raise on anything the Chebyshev kernel does not take (device aside):
    degree 4, ``w (G, 5, nin, out)`` contiguous, f32, or (``bf16``, the bf16
    kernels) x and w both bf16."""
    if degree != CHEBY_DEGREE:
        raise ValueError(f"the kernel is built for Chebyshev degree "
                         f"{CHEBY_DEGREE}, got {degree}")
    _check_common(x2d, w, CHEBY_DEGREE + 1, bf16)


def _check_bf16(name: str, x2d, w, aux) -> str:
    """The family of the bf16 kernels of ``name`` (``BF16_FAMILY``;
    B-spline, Chebyshev or Fourier) after checking their operands (``aux``:
    the knot grid, the degree or the grid size)."""
    family = BF16_FAMILY[name]
    if family == "bspline":
        check_args(x2d, aux, w, SPLINE_ORDER, bf16=True)
    elif family == "cheby":
        check_cheby_args(x2d, w, aux, bf16=True)
    else:
        check_fourier_args(x2d, w, aux, bf16=True)
    _check_device(name, *_tensors(family, x2d, w, aux))
    return family


def _check_tc(x2d: torch.Tensor, w: torch.Tensor, harmonics: int) -> None:
    """The tensor-core kernels' limits: one group, a forward launch grid of
    (rows / 48, the sine forward's tile) and a dW grid of (features / 48) x
    ``harmonics`` (Fourier's harmonics, sine's slices) within 65535."""
    groups, _, nin, _ = w.shape
    if groups != 1:
        raise ValueError(f"the tensor-core kernels take one group, got {groups}")
    if -(-x2d.shape[0] // TC_SINE_FWD_ROWS) > 65535:
        raise ValueError(f"{x2d.shape[0]} rows exceed the forward kernel's launch grid")
    if -(-nin // TC_DW_FEATURES) * harmonics > 65535:
        raise ValueError(f"{nin} features x {harmonics} harmonics exceed the dW "
                         "kernel's launch grid")


def check_fourier_args(x2d: torch.Tensor, w: torch.Tensor, grid_size: int,
                       bf16: bool = False) -> None:
    """Raise on anything the Fourier kernels do not take (device aside):
    ``w (1, 2*grid_size, nin, out)`` contiguous, f32, within the
    tensor-core kernels' launch grids; or (``bf16``, the bf16 kernels) x and
    w both bf16, one group, and a dW launch grid of (features / 16) x
    (harmonics / 2) blocks within 65535."""
    if grid_size < 1:
        raise ValueError(f"grid size must be >= 1, got {grid_size}")
    _check_common(x2d, w, 2 * grid_size, bf16)
    if x2d.dtype != torch.bfloat16:
        _check_tc(x2d, w, grid_size)
        return
    if w.shape[0] != 1:
        raise ValueError(f"the Fourier kernels take one group, got {w.shape[0]}")
    if -(-w.shape[2] // TCG_FEATURES) * _chunks("fourier", 2 * grid_size) > 65535:
        raise ValueError(f"{w.shape[2]} features x grid size {grid_size} exceed the dW "
                         "kernel's launch grid")


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape}, got "
                         f"{tuple(t.shape)}")


def check_rbf_args(x2d, w, gamma, beta, grid, bf16: bool = False) -> None:
    """Raise on anything the RBF kernels do not take (device aside): ``w
    (G, 8 or 9, nin, out)`` (the 9th slice the silu base branch), ``gamma``
    and ``beta`` ``(G, nin)`` or both None (no LayerNorm), ``grid`` the 8
    centres, all f32 and contiguous; or (``bf16``, the bf16 kernels) x, w,
    gamma and beta bf16 and the centres f32."""
    if grid.numel() != RBF_GRIDS:
        raise ValueError(f"the kernel is built for {RBF_GRIDS} RBF centres, "
                         f"got {grid.numel()}")
    _check_f32("grid", grid, (RBF_GRIDS,))
    if w.dim() != 4 or w.shape[1] not in (RBF_GRIDS, RBF_GRIDS + 1):
        raise ValueError(f"packed weight must be (G, {RBF_GRIDS} or "
                         f"{RBF_GRIDS + 1}, nin, out), got {tuple(w.shape)}")
    _check_common(x2d, w, w.shape[1], bf16)
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta are both given or both None")
    if gamma is not None:
        shape = tuple(w.shape[:1]) + tuple(w.shape[2:3])
        for name, t in (("gamma", gamma), ("beta", beta)):
            if x2d.dtype == torch.bfloat16:
                if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous():
                    raise TypeError(f"{name} must be contiguous bf16 {shape} under a bf16 "
                                    f"x, got {t.dtype} {tuple(t.shape)}")
            else:
                _check_f32(name, t, shape)


def check_sine_args(x2d, w, freq2d, phase, tc: bool = False, bf16: bool = False) -> None:
    """Raise on anything the sine kernels do not take (device aside): ``w
    (G, S, nin, out)``, ``freq2d (G, S)``, ``phase (nin, S)``, all f32 and
    contiguous, and a dW launch grid of (features / 8) x (S / 4) blocks
    within 65535; ``tc``: the tensor-core kernels' limits too. ``bf16``
    (the bf16 kernels): x, w and freq bf16 and the phase table f32, and
    the grouped tensor-core kernels' grid of (features / 16) x groups x (S
    / 4) blocks within 65535."""
    if w.dim() != 4 or w.shape[1] < 1:
        raise ValueError(f"packed weight must be (G, S, nin, out), got "
                         f"{tuple(w.shape)}")
    groups, slices, nin, _ = w.shape
    _check_common(x2d, w, slices, bf16)
    if bf16:
        if (freq2d.dtype != torch.bfloat16 or tuple(freq2d.shape) != (groups, slices)
                or not freq2d.is_contiguous()):
            raise TypeError(f"freq must be contiguous bf16 {(groups, slices)} under a "
                            f"bf16 x, got {freq2d.dtype} {tuple(freq2d.shape)}")
        _check_f32("phase", phase, (nin, slices))
        if -(-nin // TCG_FEATURES) * groups * _chunks("sine", slices) > 65535:
            raise ValueError(f"{nin} features x {groups} groups x grid size {slices} "
                             "exceed the dW kernel's launch grid")
        return
    _check_f32("freq", freq2d, (groups, slices))
    _check_f32("phase", phase, (nin, slices))
    if -(-nin // DW_TILE[0]) * _chunks("sine", slices) > 65535:
        raise ValueError(f"{nin} features x grid size {slices} exceed the dW "
                         "kernel's launch grid")
    if tc:
        _check_tc(x2d, w, slices)


def _check(family: str, x2d, w, aux) -> None:
    if family == "bspline":
        check_args(x2d, aux, w, SPLINE_ORDER)
    elif family == "cheby":
        check_cheby_args(x2d, w, aux)
    else:
        check_fourier_args(x2d, w, aux)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")


def _empty(*shape, device) -> torch.Tensor:
    return torch.empty(*shape, dtype=torch.float32, device=device)


def _check_gy(name: str, gy: torch.Tensor, shape: tuple,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if gy.dtype != dtype or tuple(gy.shape) != shape:
        want = "bf16" if dtype == torch.bfloat16 else "f32"
        raise ValueError(f"{name}: gradient must be {want} {shape}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    return gy.contiguous()


def _dw_scratch(n, w, family, aux, dev):
    """``(splits, scratch of the dW splits or None)`` for a backward launch
    of ``family`` over ``n`` rows and the packed weight ``w``."""
    groups, _, nin, out = w.shape
    splits = dw_splits(n, groups, nin, out,
                       torch.cuda.get_device_properties(dev).multi_processor_count,
                       _chunks(family, w.shape[1]))
    return splits, (_empty(splits, *w.shape, device=dev) if splits > 1 else None)


def _tc_split(stages: int, nout: int, dev, outs: int = TC_OUTS) -> torch.Tensor:
    """Scratch for a tensor-core B operand split into TF32 words: ``stages``
    stages of ``TC_STAGE`` entries x ``nout`` rounded up to the tile's
    ``outs`` columns, two words a value."""
    npad = -(-nout // outs) * outs
    return torch.empty(stages * npad * 2 * TC_STAGE, dtype=torch.int32, device=dev)


def _tc_fwd_stages(family: str, nin: int, slices_per_feature: int) -> int:
    """Stages of a tensor-core forward: ``nin`` in chunks of the family's
    features, one harmonic (Fourier) or slice (sine) a stage."""
    return -(-nin // TC_FWD_FEATURES[family]) * slices_per_feature


def _tensors(family: str, x2d, w, aux, *more):
    return (x2d, w, *more, *((aux,) if family == "bspline" else ()))


def _counted(name: str, err: int, *outputs):
    """Raise on a failed launch, else count it and return ``outputs``."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return outputs


def _launch_bf16(name: str, x2d: torch.Tensor, w: torch.Tensor, aux) -> torch.Tensor:
    """``y (N, G*out)`` bf16 from the bf16 forward of ``name`` (``BF16_FWD``;
    B-spline, Chebyshev or Fourier): x and the packed weight bf16; ``aux``
    the knot grid (f32), the degree or the grid size (Fourier's packed
    weight cos harmonics first, its chunks of 2 harmonics read from it)."""
    if BF16_FAMILY.get(name) not in KAN_BF16:
        raise TypeError(f"{name}: no bf16 kernel on this launcher (FastKAN and SineKAN: "
                        "_launch_rbf, _launch_sine)")
    family = _check_bf16(name, x2d, w, aux)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    y = torch.empty(n, groups * out, dtype=torch.bfloat16, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    lib = _build.load()
    wsplit = _tc_grouped_fwd_scratch(w, x2d.device, family, bf16=True)
    tail = (w.data_ptr(), y.data_ptr(), wsplit.data_ptr(), wsplit.numel(), n, groups, nin,
            out, _stream(x2d.device))
    with torch.cuda.device(x2d.device):
        if family == "bspline":
            gridt, gstride = _knot_rows(aux)
            err = lib.kanvit_bspline_tc_fwd_bf16(x2d.data_ptr(), x2d.stride(0),
                                                 gridt.data_ptr(), gstride, *tail)
        elif family == "cheby":
            err = lib.kanvit_cheby_tc_fwd_bf16(x2d.data_ptr(), x2d.stride(0), *tail)
        else:
            err = lib.kanvit_fourierkan_tc_fwd_bf16(x2d.data_ptr(), x2d.stride(0), aux,
                                                    *tail)
    return _counted(f"{name}_bf16", err, y)[0]


def _launch_bwd_bf16(name: str, x2d: torch.Tensor, w: torch.Tensor, aux,
                     gy: torch.Tensor, need_dx: bool, need_dw: bool):
    """``(dx (N, G*nin) or None, dw (G, S, nin, out) or None)``, bf16, from
    the bf16 backward of ``name`` (``BF16_FWD``; B-spline, Chebyshev or
    Fourier): x, the packed weight and ``gy (N, G*out)`` bf16, ``aux`` the
    knot grid (f32), the degree or the grid size; dW's row splits summed in
    f32 in a scratch and rounded once."""
    if BF16_FAMILY.get(name) not in KAN_BF16:
        raise NotImplementedError(f"{name}: no bf16 backward kernel on this launcher "
                                  "(FastKAN and SineKAN: _launch_rbf_bwd, _launch_sine_bwd)")
    family = _check_bf16(name, x2d, w, aux)
    _check_device(name, x2d, gy)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    if gy.dtype != torch.bfloat16 or tuple(gy.shape) != (n, groups * out):
        raise ValueError(f"{name}: gradient must be bf16 {(n, groups * out)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    gy = gy.contiguous()
    dev = x2d.device
    dx = (torch.empty(n, groups * nin, dtype=torch.bfloat16, device=dev)
          if need_dx else None)
    dw = torch.empty_like(w) if need_dw else None
    if n == 0:
        return dx, (None if dw is None else dw.zero_())
    from kanvit_torch.kernels import _build

    splits, part = 1, None
    if need_dw:
        splits = tc_grouped_dw_splits(
            n, groups, nin, out, torch.cuda.get_device_properties(dev).multi_processor_count,
            _chunks(family, w.shape[1]))
        part = _empty(splits, *w.shape, device=dev)
    lib = _build.load()
    tail = (w.data_ptr(), gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), n, groups, nin, out,
            splits, _stream(dev))
    with torch.cuda.device(dev):
        if family == "bspline":
            gridt, gstride = _knot_rows(aux)
            err = lib.kanvit_bspline_tc_bwd_bf16(x2d.data_ptr(), x2d.stride(0),
                                                 gridt.data_ptr(), gstride, *tail)
        elif family == "cheby":
            err = lib.kanvit_cheby_tc_bwd_bf16(x2d.data_ptr(), x2d.stride(0), *tail)
        else:
            err = lib.kanvit_fourierkan_tc_bwd_bf16(x2d.data_ptr(), x2d.stride(0), aux,
                                                    *tail)
    return _counted(f"{name}_bwd_bf16", err, dx, dw)


def _launch(name: str, family: str, x2d: torch.Tensor, w: torch.Tensor,
            aux) -> torch.Tensor:
    """``y (N, G*out)`` from the forward kernel of ``family`` ("bspline",
    "cheby" or "fourier"); ``aux`` is the knot grid ``(nin, 12)``, the
    degree or the grid size. A bf16 x takes the bf16 forward (``BF16_FWD``;
    the others raise)."""
    if x2d.dtype == torch.bfloat16 and name in BF16_FWD:
        return _launch_bf16(name, x2d, w, aux)
    _check(family, x2d, w, aux)
    _check_device(name, *_tensors(family, x2d, w, aux))
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    y = torch.empty(n, groups * out, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    lib = _build.load()
    args = (x2d.data_ptr(), x2d.stride(0))
    shape = (n, groups, nin, out)
    with torch.cuda.device(x2d.device):
        stream = _stream(x2d.device)
        if family == "bspline":
            gridt, gstride = _knot_rows(aux)
            if name in TC_GROUPED_FWD:
                wsplit = _tc_grouped_fwd_scratch(w, x2d.device)
                head = (*args, gridt.data_ptr(), gstride, w.data_ptr(), y.data_ptr(),
                        wsplit.data_ptr(), wsplit.numel())
                if name == "bspline_kan":
                    splits = tc_fwd_splits(name, *shape, torch.cuda.get_device_properties(
                        x2d.device).multi_processor_count)
                    part = _empty(splits, n, out, device=x2d.device) if splits > 1 else None
                    err = lib.kanvit_bspline_kan_tc_fwd(*head, _ptr(part), splits, *shape,
                                                        stream)
                else:
                    err = lib.kanvit_bspline_qkv_tc_fwd(*head, *shape, stream)
            else:
                err = lib.kanvit_bspline_kan_fwd(*args, gridt.data_ptr(), gstride,
                                                 w.data_ptr(), y.data_ptr(), *shape,
                                                 stream)
        elif family == "cheby":
            if name in TC_GROUPED_FWD:
                wsplit = _tc_grouped_fwd_scratch(w, x2d.device, "cheby")
                head = (*args, w.data_ptr(), y.data_ptr(), wsplit.data_ptr(), wsplit.numel())
                if name == "chebykan":
                    splits = tc_fwd_splits(name, *shape, torch.cuda.get_device_properties(
                        x2d.device).multi_processor_count, "cheby")
                    part = _empty(splits, n, out, device=x2d.device) if splits > 1 else None
                    err = lib.kanvit_chebykan_tc_fwd(*head, _ptr(part), splits, *shape, stream)
                else:
                    err = lib.kanvit_cheby_qkv_tc_fwd(*head, *shape, stream)
            else:
                err = lib.kanvit_chebykan_fwd(*args, w.data_ptr(), y.data_ptr(),
                                              *shape, stream)
        else:
            wsplit = _tc_split(_tc_fwd_stages("fourier", nin, aux), out, x2d.device)
            err = lib.kanvit_fourierkan_fwd(*args, w.data_ptr(), y.data_ptr(),
                                            wsplit.data_ptr(), n, nin, out, aux,
                                            stream)
    return _counted(name, err, y)[0]


def dw_splits(n: int, groups: int, nin: int, out: int, n_sm: int,
              chunks: int = 1) -> int:
    """Row splits of the dW reduction: enough (feature x slice-chunk x
    output) tiles times splits to fill the card, each split at least
    ``DW_MIN_ROWS_PER_SPLIT`` rows. A function of the shape and the card
    only, so a run repeats its bits."""
    tiles = groups * chunks * -(-nin // DW_TILE[0]) * -(-out // DW_TILE[1])
    want = -(-(DW_TARGET_BLOCKS * n_sm // 132) // tiles)
    return max(1, min(want, n // DW_MIN_ROWS_PER_SPLIT, 65535 // groups))


def tc_grouped_outs(nout: int) -> int:
    """Outputs a block of the grouped tensor-core dW and forward kernels."""
    return 64 if nout <= 64 else 192


def tc_fwd_outs(family: str, nout: int, bf16: bool = False) -> int:
    """Outputs a block of the grouped tensor-core forward: 64 for a family
    in ``TCG_FWD_NARROW``, else (and for every ``bf16`` forward) the
    grouped dW's."""
    return 64 if family in TCG_FWD_NARROW and not bf16 else tc_grouped_outs(nout)


def tc_fwd_splits(name: str, n: int, groups: int, nin: int, nout: int, n_sm: int,
                  family: str = "bspline") -> int:
    """Splits of a two-level tensor-core forward (``TCG_FWD_FLUSH``) of
    ``family``: one a level where its blocks (``TCG_FWD_WARPS`` warps of 16
    rows) fill less than one wave (a vit-s image of 96 stages: B-spline 4
    blocks, FastKAN 12, 8 levels; Chebyshev 12, 4 levels), else 1. The
    levels are summed in the same order either way, so a row's bits do not
    depend on the batch."""
    flush = TCG_FWD_FLUSH.get(name)
    if flush is None:
        return 1
    rows = 16 * TCG_FWD_WARPS[name]
    blocks = -(-n // rows) * groups * -(-nout // tc_fwd_outs(family, nout))
    levels = -(-(-(-nin // TCG_FWD_FEATURES)) // flush)
    return levels if blocks < n_sm and levels > 1 else 1


def tc_grouped_dw_splits(n: int, groups: int, nin: int, nout: int, n_sm: int,
                         chunks: int = 1) -> int:
    """Row splits of the grouped tensor-core dW: enough (feature tile x
    group x slice chunk x output tile) blocks times splits for
    ``TCG_DW_TARGET_BLOCKS`` blocks an SM, rounded up to whole waves of
    ``n_sm`` blocks where at most twice as many splits do it (the FastKAN
    embedder's 96 tiles: 11 splits, 8 waves, not 6 splits' 4.36), whole
    32-row stages a split, none left empty. ``chunks``: the bf16 sine
    kernels' chunks of 4 slices. A function of the shape and the card only,
    so a run repeats its bits."""
    tiles = (groups * chunks * -(-nin // TCG_FEATURES)
             * -(-nout // tc_grouped_outs(nout)))
    stages = -(-n // TC_STAGE)
    want = -(-TCG_DW_TARGET_BLOCKS * n_sm // tiles)
    whole = next((s for s in range(want, 2 * want + 1) if tiles * s % n_sm == 0), want)
    per = -(-stages // min(stages, whole))
    return -(-stages // per)


def _tc_grouped_scratch(family, w, n, need_dx, need_dw, dev):
    """``(wtsplit or None, splits, dW partials or None)`` of a grouped
    tensor-core backward: W^T for the dx kernel, split once into TF32 words
    in its stage order (2 words a value), and the dW kernel's row splits."""
    groups, _, nin, out = w.shape
    wtsplit = (torch.empty(groups * -(-nin // TCG_FEATURES) * -(-out // TCG_DX_STAGE)
                           * 2 * TCG_SLICES[family] * 8 * 2 * TCG_DX_STAGE,
                           dtype=torch.int32, device=dev)
               if need_dx else None)
    splits, part = 1, None
    if need_dw:
        splits = tc_grouped_dw_splits(
            n, groups, nin, out, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = _empty(splits, *w.shape, device=dev) if splits > 1 else None
    return wtsplit, splits, part


def _tc_grouped_fwd_scratch(w, dev, family: str = "bspline",
                            bf16: bool = False) -> torch.Tensor:
    """W split for the grouped tensor-core forward: for every group and
    block of outputs (``tc_fwd_outs``), ``ceil(nin / 8)`` stages of the
    family's steps (the slices its tile holds, which the pre-pass writes
    whatever the weight's S, zeros past it; RBF one more, the silu slice's
    remainders) x 8 features x the block's outputs, two words a value;
    ``bf16``: steps of two of the tile's slices (no remainders step), one
    word (a bf16 pair) a value, and a bf16 sine weight past 4 slices a stage
    for each chunk of 4."""
    groups, slices, nin, out = w.shape
    outs = tc_fwd_outs(family, out, bf16)
    words = -(-TCG_SLICES[family] // 2) if bf16 else 2 * TCG_FWD_STEPS[family]
    chunks = _chunks(family, slices) if bf16 else 1
    return torch.empty(groups * -(-out // outs) * -(-nin // TCG_FWD_FEATURES) * chunks
                       * words * outs * TCG_FWD_FEATURES,
                       dtype=torch.int32, device=dev)


def _launch_grouped_tc_bwd(name, family, x2d, w, aux, gy, dx, dw, lib, stream):
    """``(dx, dw)`` of ``bspline_qkv_grouped`` or ``cheby_qkv_grouped``
    (``family``) from the tensor-core kernels, into ``dx`` and ``dw``
    (either None to skip it); ``aux`` the knot grid or the degree."""
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    wtsplit, splits, part = _tc_grouped_scratch(family, w, n, dx is not None,
                                                dw is not None, x2d.device)
    args = (x2d.data_ptr(), x2d.stride(0))
    grads = (w.data_ptr(), gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), _ptr(wtsplit), n,
             groups, nin, out, splits, stream)
    if family == "bspline":
        gridt, gstride = _knot_rows(aux)
        err = lib.kanvit_bspline_qkv_tc_bwd(*args, gridt.data_ptr(), gstride, *grads)
    else:
        err = lib.kanvit_cheby_qkv_tc_bwd(*args, *grads)
    return _counted(name, err, dx, dw)


def _launch_bwd(name: str, family: str, x2d: torch.Tensor, w: torch.Tensor,
                aux, gy: torch.Tensor, need_dx: bool, need_dw: bool):
    """``(dx (N, G*nin) or None, dw (G, S, nin, out) or None)`` from the
    backward kernels of ``family``; ``gy`` is the gradient of the forward's
    output."""
    _check(family, x2d, w, aux)
    _check_device(name, *_tensors(family, x2d, w, aux, gy))
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out))
    dev = x2d.device
    dx = _empty(n, groups * nin, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if n == 0:
        return dx, (None if dw is None else dw.zero_())
    from kanvit_torch.kernels import _build

    lib = _build.load()
    args = (x2d.data_ptr(), x2d.stride(0))
    with torch.cuda.device(dev):
        stream = _stream(dev)
        if name in TC_GROUPED_BWD:
            return _launch_grouped_tc_bwd(name, family, x2d, w, aux, gy, dx, dw, lib,
                                          stream)
        if family == "fourier":
            gysplit = _tc_split(-(-n // TC_STAGE), out, dev) if need_dw else None
            err = lib.kanvit_fourierkan_bwd(*args, w.data_ptr(), gy.data_ptr(),
                                            _ptr(dx), _ptr(dw), _ptr(gysplit), n,
                                            nin, out, aux, stream)
            return _counted(name, err, dx, dw)
        splits, part = (_dw_scratch(n, w, family, aux, dev) if need_dw
                        else (1, None))
        grads = (gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), n, groups, nin, out)
        if family == "bspline":
            gridt, gstride = _knot_rows(aux)
            err = lib.kanvit_bspline_kan_bwd(*args, gridt.data_ptr(), gstride,
                                             w.data_ptr(), *grads, splits, stream)
        else:
            err = lib.kanvit_chebykan_bwd(*args, w.data_ptr(), *grads, splits,
                                          stream)
    return _counted(name, err, dx, dw)


class _KanFn(torch.autograd.Function):
    """``y = x2d -> basis -> @ w`` on the card: the forward kernel of
    ``family``, and the backward kernels for dx and d(packed weight). Saves
    x and the packed weight (kanvit's residual, ``fused_basis.py:1327``)."""

    @staticmethod
    def forward(ctx, x2d, w, aux, name, family):
        ctx.name, ctx.family = name, family
        if torch.is_tensor(aux):
            ctx.save_for_backward(x2d, w, aux)
        else:
            ctx.save_for_backward(x2d, w)
            ctx.aux = aux
        return _launch(name, family, x2d, w, aux)

    @staticmethod
    def backward(ctx, gy):
        x2d, w, *grid = ctx.saved_tensors
        aux = grid[0] if grid else ctx.aux
        need = ctx.needs_input_grad[:2]
        if x2d.dtype == torch.bfloat16:
            dx, dw = _launch_bwd_bf16(ctx.name, x2d, w, aux, gy, *need)
        else:
            dx, dw = _launch_bwd(f"{ctx.name}_bwd", ctx.family, x2d, w, aux, gy, *need)
        return dx, dw, None, None, None


class _KanBf16Plain(torch.autograd.Function):
    """The CPU route of a bf16 B-spline, Chebyshev or Fourier layer
    (``family``): the plain twins of the bf16 kernels on the packed weight,
    forward and an explicit backward (dx only where asked, as on the card);
    ``aux`` the knot grid, the degree or the grid size. The Fourier route
    refuses what its bf16 kernels refuse."""

    @staticmethod
    def forward(ctx, x2d, w, aux, family="bspline"):
        ctx.family = family
        if family == "bspline":
            ctx.save_for_backward(x2d, w, aux)
            return K.bspline_grouped_forward_bf16(x2d, aux, w)
        ctx.save_for_backward(x2d, w)
        if family == "fourier":
            check_fourier_args(x2d, w, aux, bf16=True)
            return K.fourier_grouped_forward_bf16(x2d, w)
        return K.cheby_grouped_forward_bf16(x2d, w)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:2]
        if ctx.family == "bspline":
            x2d, w, grid = ctx.saved_tensors
            dx, dw = K.bspline_grouped_backward_bf16(x2d, grid, w, gy, *need)
        elif ctx.family == "fourier":
            x2d, w = ctx.saved_tensors
            dx, dw = K.fourier_grouped_backward_bf16(x2d, w, gy, *need)
        else:
            x2d, w = ctx.saved_tensors
            dx, dw = K.cheby_grouped_backward_bf16(x2d, w, gy, *need)
        return dx, dw, None, None


def bspline_kan(x, grid, base_weight, spline_weight, spline_scaler,
                spline_order=3):
    """KANLinear forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.bspline_kan_forward``;
    ``grid (in, 12)``, ``base_weight (out, in)``, ``spline_weight
    (out, in, 8)``, ``spline_scaler (out, in)`` or None.
    """
    kernel = dispatch.use_kernel(x)
    if not kernel and x.dtype != torch.bfloat16:
        return K.bspline_kan_forward(x, grid, base_weight, spline_weight,
                                     spline_scaler, spline_order)
    _check_spline_order(spline_order)
    lead, nin = x.shape[:-1], x.shape[-1]
    w = pack_weight(base_weight, spline_weight, spline_scaler).unsqueeze(0).contiguous()
    if kernel:
        y = _KanFn.apply(x.reshape(-1, nin), w, grid, "bspline_kan", "bspline")
    else:
        y = _KanBf16Plain.apply(x.reshape(-1, nin), w.to(torch.bfloat16), grid)
    return y.reshape(*lead, base_weight.shape[0])


def bspline_qkv_grouped(x2d, grid, bw, sw, sc, spline_order=3):
    """Joint q/k/v B-spline projection of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``;
    ``bw (H, out, dh)``, ``sw (H, out, dh, 8)``, ``sc (H, out, dh)`` the
    per-head q|k|v-concatenated KANLinear params (out = 3*dh), or one
    projection's (out = dh); ``grid (dh, 12)`` shared by all heads, or
    ``(H, dh, 12)``, a grid a head. Returns ``y (N, H*out)`` with head h at
    ``[h*out, (h+1)*out)``.
    """
    h, _, dh = bw.shape
    kernel = dispatch.use_kernel(x2d)
    if not kernel and x2d.dtype == torch.bfloat16:
        _check_spline_order(spline_order)
        w = pack_qkv_weight(bw, sw, sc).to(torch.bfloat16).contiguous()
        return _KanBf16Plain.apply(x2d, w, grid)
    if not kernel:
        return torch.cat([
            K.bspline_kan_forward(x2d[:, i * dh:(i + 1) * dh],
                                  grid[i] if grid.dim() == 3 else grid, bw[i],
                                  sw[i], sc[i], spline_order)
            for i in range(h)
        ], dim=1)
    _check_spline_order(spline_order)
    w = pack_qkv_weight(bw, sw, sc).contiguous()
    return _KanFn.apply(x2d, w, grid, "bspline_qkv_grouped", "bspline")


def chebykan(x, coeffs):
    """ChebyKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.chebykan_forward``;
    ``coeffs (in, out, degree+1)``. A bf16 x takes the bf16 kernels (on the
    CPU their plain twins).
    """
    kernel = dispatch.use_kernel(x)
    if not kernel and x.dtype != torch.bfloat16:
        return K.chebykan_forward(x, coeffs)
    lead, nin = x.shape[:-1], x.shape[-1]
    degree = coeffs.shape[2] - 1
    w = pack_cheby_weight(coeffs).contiguous()
    if kernel:
        y = _KanFn.apply(x.reshape(-1, nin), w, degree, "chebykan", "cheby")
    else:
        y = _KanBf16Plain.apply(x.reshape(-1, nin), w.to(torch.bfloat16), degree, "cheby")
    return y.reshape(*lead, coeffs.shape[1])


def cheby_qkv_grouped(x2d, cc):
    """Joint q/k/v Chebyshev projection of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``; ``cc
    (H, dh, out, D)`` the per-head q|k|v-concatenated ChebyKAN coefficients
    (out = 3*dh). Returns ``y (N, H*out)`` with head h at ``[h*out,
    (h+1)*out)``, as ``bspline_qkv_grouped``.
    """
    h, dh, _, deg1 = cc.shape
    kernel = dispatch.use_kernel(x2d)
    if not kernel and x2d.dtype == torch.bfloat16:
        w = pack_cheby_qkv_weight(cc).to(torch.bfloat16).contiguous()
        return _KanBf16Plain.apply(x2d, w, deg1 - 1, "cheby")
    if not kernel:
        return torch.cat([K.chebykan_forward(x2d[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)
    w = pack_cheby_qkv_weight(cc).contiguous()
    return _KanFn.apply(x2d, w, deg1 - 1, "cheby_qkv_grouped", "cheby")


def fourierkan(x, coeffs, bias):
    """NaiveFourierKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.fourierkan_forward``;
    ``coeffs (2, out, in, grid)``, ``bias`` ``(out,)``, ``(1, out)`` or
    None. The bias is added outside the kernel, as kanvit adds it. A bf16 x
    (bf16 coefficients and bias) takes the bf16 kernels (on the CPU their
    plain twins), the bias added in bf16.
    """
    kernel = dispatch.use_kernel(x)
    if not kernel and x.dtype != torch.bfloat16:
        return K.fourierkan_forward(x, coeffs, bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, _, grid_size = coeffs.shape
    w = pack_fourier_weight(coeffs).contiguous()
    y = (_KanFn.apply(x.reshape(-1, nin), w, grid_size, "fourierkan", "fourier") if kernel
         else _KanBf16Plain.apply(x.reshape(-1, nin), w, grid_size, "fourier"))
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


def _launch_rbf(name: str, x2d, w, gamma, beta, grid, denominator: float):
    """``(y (N, G*out), stats (N, G, 2) or None)`` from the RBF forward
    kernels: the LayerNorm's statistics when ``gamma`` is given, then the
    fused RBF (and silu, for a 9-slice weight) contraction on the tensor
    cores, the embedder's (``fastkan``) as the grouped q/k/v's one-group
    case with its 768-deep sum in two levels (``TCG_FWD_FLUSH``). A bf16 x
    (the packed weight, gamma and beta bf16, the centres f32) takes the bf16
    kernels (entry ``kanvit_fastkan_tc_fwd_bf16``: the statistics in f32,
    part 3's ``Bf16`` operand type, one running sum), y bf16, counted under
    ``<name>_bf16``."""
    bf16 = x2d.dtype == torch.bfloat16
    if bf16 and BF16_FAMILY.get(name) != "rbf":
        raise TypeError(f"{name}: no bf16 FastKAN kernel")
    check_rbf_args(x2d, w, gamma, beta, grid, bf16=bf16)
    _check_device(name, x2d, w, grid, *(() if gamma is None else (gamma, beta)))
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    dev = x2d.device
    y = torch.empty(n, groups * out, dtype=x2d.dtype, device=dev)
    stats = None if gamma is None else _empty(n, groups, 2, device=dev)
    if n == 0:
        return y, stats
    from kanvit_torch.kernels import _build

    lib = _build.load()
    common = (x2d.data_ptr(), x2d.stride(0), _ptr(gamma), _ptr(beta), grid.data_ptr(),
              1.0 / denominator, w.data_ptr(), y.data_ptr(), _ptr(stats))
    shape = (n, groups, nin, out, slices - RBF_GRIDS)
    with torch.cuda.device(dev):
        if bf16:
            wsplit = _tc_grouped_fwd_scratch(w, dev, "rbf", bf16=True)
            err = lib.kanvit_fastkan_tc_fwd_bf16(*common, wsplit.data_ptr(), wsplit.numel(),
                                                 *shape, _stream(dev))
            return _counted(f"{name}_bf16", err, y, stats)
        if name in TC_GROUPED_FWD:
            wsplit = _tc_grouped_fwd_scratch(w, dev, "rbf")
            head = (*common, wsplit.data_ptr(), wsplit.numel())
            if name in TCG_FWD_FLUSH:
                splits = tc_fwd_splits(name, *shape[:4], torch.cuda.get_device_properties(
                    dev).multi_processor_count, "rbf")
                part = _empty(splits, n, groups * out, device=dev) if splits > 1 else None
                err = lib.kanvit_fastkan_kan_tc_fwd(*head, _ptr(part), splits, *shape,
                                                    _stream(dev))
            else:
                err = lib.kanvit_fastkan_qkv_tc_fwd(*head, *shape, _stream(dev))
        else:
            err = lib.kanvit_fastkan_fwd(*common, *shape, _stream(dev))
    return _counted(name, err, y, stats)


def _launch_rbf_bwd(name: str, x2d, w, gamma, beta, grid, denominator: float,
                    stats, gy, need_dx: bool, need_dw: bool):
    """``(dx or None, dw or None, dgamma, dbeta)`` from the RBF backward
    kernels; dgamma and dbeta ``(G, nin)`` whenever the layer has its
    LayerNorm (its dln pass runs even with no dx), else None. The grouped
    q/k/v's and the embedder's (one group) run dx and dW on the tensor
    cores. A bf16 x takes the bf16 kernels (entry
    ``kanvit_fastkan_tc_bwd_bf16``), every output bf16, counted under
    ``<name>_bf16``: dln and the silu term in f32 from part 4's dx kernel
    (gW = gy W^T never rounded), the LayerNorm's VJP added and dx rounded
    once; dgamma and dbeta f32 column sums in two levels, rounded once; dW's
    row splits summed in f32 and rounded once."""
    bf16 = x2d.dtype == torch.bfloat16
    if bf16 and BF16_FAMILY.get(name.removesuffix("_bwd")) != "rbf":
        raise NotImplementedError(f"{name}: no bf16 FastKAN backward kernel")
    check_rbf_args(x2d, w, gamma, beta, grid, bf16=bf16)
    ln = gamma is not None
    _check_device(name, x2d, w, grid, gy, *((gamma, beta, stats) if ln else ()))
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out), x2d.dtype)
    dev = x2d.device
    dx = torch.empty(n, groups * nin, dtype=x2d.dtype, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    dgb = torch.empty(2, groups, nin, dtype=x2d.dtype, device=dev) if ln else None
    if n == 0:
        dgb = None if dgb is None else dgb.zero_()
        return (dx, None if dw is None else dw.zero_(),
                *((None, None) if dgb is None else dgb))
    from kanvit_torch.kernels import _build

    ln_splits = -(-n // LN_ROWS_PER_SPLIT)
    dln = _empty(n, groups * nin, device=dev) if ln else None
    dgb_part = _empty(ln_splits, 2, groups, nin, device=dev) if ln else None
    common = (x2d.data_ptr(), x2d.stride(0), _ptr(gamma), _ptr(beta), grid.data_ptr(),
              1.0 / denominator, _ptr(stats), w.data_ptr(), gy.data_ptr(), _ptr(dx),
              _ptr(dw))
    lib = _build.load()
    with torch.cuda.device(dev):
        if bf16:
            dxs = _empty(n, groups * nin, device=dev) if ln and need_dx else None
            splits, part = 1, None
            if need_dw:
                splits = tc_grouped_dw_splits(n, groups, nin, out, torch.cuda.
                                              get_device_properties(dev).multi_processor_count)
                part = _empty(splits, *w.shape, device=dev)
            err = lib.kanvit_fastkan_tc_bwd_bf16(
                *common, _ptr(part), _ptr(dln), _ptr(dxs), _ptr(dgb), _ptr(dgb_part), n,
                groups, nin, out, slices - RBF_GRIDS, splits, ln_splits, _stream(dev))
            name = f"{name}_bf16"
        elif name in TC_GROUPED_BWD:
            wtsplit, splits, part = _tc_grouped_scratch("rbf", w, n, need_dx or ln,
                                                        need_dw, dev)
            err = lib.kanvit_fastkan_qkv_tc_bwd(
                *common, _ptr(part), _ptr(dln), _ptr(dgb), _ptr(dgb_part), _ptr(wtsplit),
                n, groups, nin, out, slices - RBF_GRIDS, splits, ln_splits, _stream(dev))
        else:
            splits, part = _dw_scratch(n, w, "rbf", None, dev) if need_dw else (1, None)
            err = lib.kanvit_fastkan_bwd(
                *common, _ptr(part), _ptr(dln), _ptr(dgb), _ptr(dgb_part), n, groups,
                nin, out, slices - RBF_GRIDS, splits, ln_splits, _stream(dev))
    return _counted(name, err, dx, dw, *((None, None) if dgb is None else dgb))


class _RbfFn(torch.autograd.Function):
    """``y = x2d -> [LN] -> RBF (+ silu) -> @ w`` on the card; the backward
    returns dx, d(packed weight), dgamma and dbeta. Saves x, the packed
    weight, gamma, beta and the LayerNorm's (mean, rstd) (kanvit saves x and
    recomputes the statistics, ``fused_basis.py:2980``). A bf16 x takes the
    bf16 kernels both ways."""

    @staticmethod
    def forward(ctx, x2d, w, gamma, beta, grid, denominator, name):
        y, stats = _launch_rbf(name, x2d, w, gamma, beta, grid, denominator)
        ctx.name, ctx.denominator = name, denominator
        ctx.save_for_backward(x2d, w, gamma, beta, grid, stats)
        return y

    @staticmethod
    def backward(ctx, gy):
        x2d, w, gamma, beta, grid, stats = ctx.saved_tensors
        args = (x2d, w, gamma, beta, grid, ctx.denominator, stats, gy,
                ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        dx, dw, dgamma, dbeta = _launch_rbf_bwd(f"{ctx.name}_bwd", *args)
        return dx, dw, dgamma, dbeta, None, None, None


class _RbfBf16Plain(torch.autograd.Function):
    """The CPU route of a bf16 FastKAN layer: the plain twins of the bf16
    kernels on the packed weight, forward and an explicit backward (dx only
    where asked, as on the card; dgamma and dbeta with the LayerNorm). It
    refuses what the bf16 kernels refuse."""

    @staticmethod
    def forward(ctx, x2d, w, gamma, beta, grid, denominator):
        check_rbf_args(x2d, w, gamma, beta, grid, bf16=True)
        ctx.denominator = denominator
        ctx.save_for_backward(x2d, w, gamma, beta, grid)
        return K.fastkan_grouped_forward_bf16(x2d, w, gamma, beta, grid, denominator)

    @staticmethod
    def backward(ctx, gy):
        x2d, w, gamma, beta, grid = ctx.saved_tensors
        grads = K.fastkan_grouped_backward_bf16(x2d, w, gamma, beta, grid, ctx.denominator,
                                                gy, *ctx.needs_input_grad[:2])
        return (*grads, None, None)


def fastkan(x, ln_gamma, ln_beta, rbf_grid, rbf_denominator, spline_weight,
            base_weight, base_bias):
    """FastKAN layer forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.fastkan_forward``:
    ``ln_gamma``, ``ln_beta`` ``(in,)`` or None (no LayerNorm); ``rbf_grid``
    the 8 centres; ``spline_weight (out, in*8)``; ``base_weight (out, in)``
    and ``base_bias (out,)``, or None (no base branch). The LayerNorm and
    the silu base branch run inside the kernels; the bias is added outside,
    as kanvit adds it. A bf16 x (bf16 weights, gamma and beta; the centres
    f32) takes the bf16 kernels (on the CPU their plain twins).
    """
    kernel = dispatch.use_kernel(x)
    if not kernel and x.dtype != torch.bfloat16:
        return K.fastkan_forward(x, ln_gamma, ln_beta, rbf_grid, rbf_denominator,
                                 spline_weight, base_weight, base_bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = spline_weight.shape[0]
    w = pack_fastkan_weight(spline_weight, base_weight, rbf_grid.numel())
    gamma, beta = ((None, None) if ln_gamma is None
                   else (ln_gamma.reshape(1, nin), ln_beta.reshape(1, nin)))
    args = (x.reshape(-1, nin), w.unsqueeze(0).contiguous(), gamma, beta,
            rbf_grid.contiguous(), float(rbf_denominator))
    y = _RbfFn.apply(*args, "fastkan") if kernel else _RbfBf16Plain.apply(*args)
    if base_weight is not None:
        y = y + base_bias
    return y.reshape(*lead, nout)


def fastkan_qkv_grouped(x2d, ln_gamma, ln_beta, rbf_grid, rbf_denominator,
                        spline_weight, base_weight, base_bias):
    """One FastKAN projection (q, k or v) of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``; per-head
    stacked ``ln_gamma``, ``ln_beta`` ``(H, dh)``, ``spline_weight (H, out,
    dh*8)``, ``base_weight (H, out, dh)``, ``base_bias (H, out)``. Each head
    normalises its own dh features. Returns ``y (N, H*out)``, bias
    included, head h at ``[h*out, (h+1)*out)``. A bf16 x takes the bf16
    kernels (on the CPU their plain twins), the bias added in bf16.
    """
    h, nout, dh = base_weight.shape
    kernel = dispatch.use_kernel(x2d)
    if not kernel and x2d.dtype != torch.bfloat16:
        return torch.cat([
            K.fastkan_forward(x2d[:, i * dh:(i + 1) * dh], ln_gamma[i], ln_beta[i],
                              rbf_grid, rbf_denominator, spline_weight[i],
                              base_weight[i], base_bias[i])
            for i in range(h)
        ], dim=1)
    w = pack_fastkan_qkv_weight(spline_weight, base_weight, rbf_grid.numel())
    args = (x2d, w.contiguous(), ln_gamma.contiguous(), ln_beta.contiguous(),
            rbf_grid.contiguous(), float(rbf_denominator))
    y = (_RbfFn.apply(*args, "fastkan_qkv_grouped") if kernel
         else _RbfBf16Plain.apply(*args))
    return y + base_bias.reshape(1, h * nout)


def _launch_sine(name: str, x2d, w, freq2d, phase) -> torch.Tensor:
    """``y (N, G*out)`` from the sine forward kernel: the tensor-core ones
    for ``sinekan`` and for the grouped q/k/v up to 4 slices (every kanvit
    q/k/v), the CUDA-core one for the grouped q/k/v past that (the
    tensor-core tile holds 4). A bf16 x (the packed weight and freq bf16,
    the phase table f32) takes the bf16 kernel (entry
    ``kanvit_sinekan_tc_fwd_bf16``: part 3's ``Bf16`` operand type, the
    embedder's slices in chunks of 4, one running sum), y bf16, counted under
    ``<name>_bf16``."""
    bf16 = x2d.dtype == torch.bfloat16
    if bf16 and BF16_FAMILY.get(name) != "sine":
        raise TypeError(f"{name}: no bf16 SineKAN kernel")
    tc = name in TC_ROUTES
    check_sine_args(x2d, w, freq2d, phase, tc, bf16)
    _check_device(name, x2d, w, freq2d, phase)
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    y = torch.empty(n, groups * out, dtype=x2d.dtype, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    lib = _build.load()
    args = (x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(),
            w.data_ptr(), y.data_ptr())
    with torch.cuda.device(x2d.device):
        stream = _stream(x2d.device)
        if bf16:
            wsplit = _tc_grouped_fwd_scratch(w, x2d.device, "sine", bf16=True)
            err = lib.kanvit_sinekan_tc_fwd_bf16(*args, wsplit.data_ptr(), wsplit.numel(),
                                                 n, groups, nin, out, slices, stream)
            return _counted(f"{name}_bf16", err, y)[0]
        if tc:
            wsplit = _tc_split(_tc_fwd_stages("sine", nin, slices), out, x2d.device,
                               TC_SINE_FWD_OUTS)
            err = lib.kanvit_sinekan_tc_fwd(*args, wsplit.data_ptr(), n, nin, out,
                                            slices, stream)
        elif name in TC_GROUPED_FWD and slices <= SINE_CHUNK:
            wsplit = _tc_grouped_fwd_scratch(w, x2d.device, "sine")
            err = lib.kanvit_sinekan_qkv_tc_fwd(*args, wsplit.data_ptr(), wsplit.numel(),
                                                n, groups, nin, out, slices, stream)
        else:
            err = lib.kanvit_sinekan_fwd(*args, n, groups, nin, out, slices, stream)
    return _counted(name, err, y)[0]


def _launch_sine_bwd(name: str, x2d, w, freq2d, phase, gy, need_dx: bool,
                     need_dw: bool):
    """``(dx or None, dw or None, dfreq (G, S))`` from the sine backward
    kernels. ``sinekan``: dx (if asked) from the CUDA-core dx kernel, dW and
    dfreq (its D route) from the tensor-core dW kernel, which runs even when
    dW is not asked. The grouped q/k/v: the dx kernel (writing no dx unless
    asked) with its dfreq sums, and dW; on the tensor cores up to 4 slices
    (every kanvit q/k/v), on the CUDA cores past that (the tensor-core tile
    holds 4)."""
    if x2d.dtype == torch.bfloat16:
        return _launch_sine_bwd_bf16(name, x2d, w, freq2d, phase, gy, need_dx, need_dw)
    tc = name[:-len("_bwd")] in TC_ROUTES
    check_sine_args(x2d, w, freq2d, phase, tc)
    _check_device(name, x2d, w, freq2d, phase, gy)
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out))
    dev = x2d.device
    dx = _empty(n, groups * nin, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw or tc else None
    dfreq = _empty(groups, slices, device=dev)
    if n == 0:
        return dx, None if not need_dw else dw.zero_(), dfreq.zero_()
    from kanvit_torch.kernels import _build

    if tc:
        gysplit = _tc_split(-(-n // TC_STAGE), out, dev)
        part = _empty(-(-nin // TC_DW_FEATURES) * -(-out // TC_OUTS), slices, device=dev)
        with torch.cuda.device(dev):
            err = _build.load().kanvit_sinekan_tc_bwd(
                x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(),
                w.data_ptr(), gy.data_ptr(), _ptr(dx), dw.data_ptr(),
                dfreq.data_ptr(), gysplit.data_ptr(), part.data_ptr(), n, nin, out,
                slices, _stream(dev))
        return _counted(name, err, dx, dw if need_dw else None, dfreq)
    common = (x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(),
              w.data_ptr(), gy.data_ptr(), _ptr(dx), _ptr(dw))
    lib = _build.load()
    with torch.cuda.device(dev):
        if name in TC_GROUPED_BWD and slices <= SINE_CHUNK:
            wtsplit, splits, part = _tc_grouped_scratch("sine", w, n, True, need_dw, dev)
            blocks = -(-nin // TCG_FEATURES) * -(-n // TCG_DX_ROWS)
            dfreq_part = _empty(groups, blocks, slices, device=dev)
            err = lib.kanvit_sinekan_qkv_tc_bwd(
                *common, _ptr(part), dfreq.data_ptr(), dfreq_part.data_ptr(),
                wtsplit.data_ptr(), n, groups, nin, out, slices, splits, _stream(dev))
        else:
            splits, part = (_dw_scratch(n, w, "sine", slices, dev) if need_dw
                            else (1, None))
            blocks = -(-nin // DX_TILE[1]) * -(-n // DX_TILE[0])
            dfreq_part = _empty(groups, blocks, slices, device=dev)
            err = lib.kanvit_sinekan_bwd(
                *common, _ptr(part), dfreq.data_ptr(), dfreq_part.data_ptr(), n, groups,
                nin, out, slices, splits, _stream(dev))
    return _counted(name, err, dx, dw, dfreq)


def _launch_sine_bwd_bf16(name: str, x2d, w, freq2d, phase, gy, need_dx: bool,
                          need_dw: bool):
    """``(dx or None, dw or None, dfreq (G, S))``, bf16, from the bf16 sine
    backward (entry ``kanvit_sinekan_tc_bwd_bf16``, part 4), counted under
    ``<name>_bf16``: part 4's dx kernel (gW = gy W^T in f32, never rounded)
    runs on every call for dfreq, its per-(feature, slice) row-tile partials
    summed over the rows and then the features in a fixed order and rounded
    once, and writes dx only where asked (the embedder's training step asks
    none); dW over the sine basis made in f32 and rounded to bf16 at the dot,
    row splits summed in f32 and rounded once."""
    if BF16_FAMILY.get(name.removesuffix("_bwd")) != "sine":
        raise NotImplementedError(f"{name}: no bf16 SineKAN backward kernel")
    check_sine_args(x2d, w, freq2d, phase, bf16=True)
    _check_device(name, x2d, w, freq2d, phase, gy)
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out), torch.bfloat16)
    dev = x2d.device
    dx = torch.empty(n, groups * nin, dtype=torch.bfloat16, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    dfreq = torch.empty(groups, slices, dtype=torch.bfloat16, device=dev)
    if n == 0:
        return dx, None if dw is None else dw.zero_(), dfreq.zero_()
    from kanvit_torch.kernels import _build

    splits, part = 1, None
    if need_dw:
        splits = tc_grouped_dw_splits(
            n, groups, nin, out, torch.cuda.get_device_properties(dev).multi_processor_count,
            _chunks("sine", slices))
        part = _empty(splits, *w.shape, device=dev)
    dfreq_part = _empty(groups, slices, -(-n // TCG_DX_ROWS), nin, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().kanvit_sinekan_tc_bwd_bf16(
            x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(), w.data_ptr(),
            gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), dfreq.data_ptr(),
            dfreq_part.data_ptr(), n, groups, nin, out, slices, splits, _stream(dev))
    return _counted(f"{name}_bf16", err, dx, dw, dfreq)


class _SineFn(torch.autograd.Function):
    """``y = sin(x2d * freq + phase) @ w`` on the card; the backward returns
    dx, d(packed weight) and dfreq. Saves x, the packed weight, freq and
    the phase table (kanvit's residual, ``fused_basis.py:3399``)."""

    @staticmethod
    def forward(ctx, x2d, w, freq2d, phase, name):
        ctx.name = name
        ctx.save_for_backward(x2d, w, freq2d, phase)
        return _launch_sine(name, x2d, w, freq2d, phase)

    @staticmethod
    def backward(ctx, gy):
        x2d, w, freq2d, phase = ctx.saved_tensors
        dx, dw, dfreq = _launch_sine_bwd(f"{ctx.name}_bwd", x2d, w, freq2d, phase,
                                         gy, ctx.needs_input_grad[0],
                                         ctx.needs_input_grad[1])
        return dx, dw, dfreq, None, None


class _SineBf16Plain(torch.autograd.Function):
    """The CPU route of a bf16 SineKAN layer: the plain twins of the bf16
    kernels on the packed weight, forward and an explicit backward (dx only
    where asked, as on the card; dfreq always). It refuses what the bf16
    kernels refuse."""

    @staticmethod
    def forward(ctx, x2d, w, freq2d, phase):
        check_sine_args(x2d, w, freq2d, phase, bf16=True)
        ctx.save_for_backward(x2d, w, freq2d, phase)
        return K.sine_grouped_forward_bf16(x2d, w, freq2d, phase)

    @staticmethod
    def backward(ctx, gy):
        x2d, w, freq2d, phase = ctx.saved_tensors
        dx, dw, dfreq = K.sine_grouped_backward_bf16(x2d, w, freq2d, phase, gy,
                                                     *ctx.needs_input_grad[:2])
        return dx, dw, dfreq, None


def sinekan(x, freq, phase, amplitudes, bias):
    """SineKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.sinekan_forward``:
    ``freq`` with G entries (``(G,)`` or the reference's ``(1, 1, 1, G)``),
    ``phase (in, G)``, ``amplitudes (out, in, G)``, ``bias`` ``(out,)``,
    ``(1, out)`` or None, added outside the kernel as kanvit adds it. A bf16
    x (bf16 freq, amplitudes and bias; the phase table f32) takes the bf16
    kernels (on the CPU their plain twins), the bias added in bf16.
    """
    kernel = dispatch.use_kernel(x)
    if not kernel and x.dtype != torch.bfloat16:
        return K.sinekan_forward(x, freq, phase, amplitudes, bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = amplitudes.shape[0]
    w = pack_sine_weight(amplitudes).contiguous()
    args = (x.reshape(-1, nin), w, freq.reshape(1, -1).contiguous(), phase.contiguous())
    y = _SineFn.apply(*args, "sinekan") if kernel else _SineBf16Plain.apply(*args)
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


def sinekan_qkv_grouped(x2d, freq, phase, amplitudes, bias):
    """One SineKAN projection (q, k or v) of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``; ``freq
    (H, G)`` per head; ``phase (dh, G)``, the table every head shares;
    ``amplitudes (H, out, dh, G)``; ``bias (H, out)`` or None. Returns ``y
    (N, H*out)``, head h at ``[h*out, (h+1)*out)``. A bf16 x takes the bf16
    kernels (on the CPU their plain twins), the bias added in bf16.
    """
    h, nout, dh, _ = amplitudes.shape
    kernel = dispatch.use_kernel(x2d)
    if not kernel and x2d.dtype != torch.bfloat16:
        return torch.cat([
            K.sinekan_forward(x2d[:, i * dh:(i + 1) * dh], freq[i], phase,
                              amplitudes[i], None if bias is None else bias[i])
            for i in range(h)
        ], dim=1)
    w = pack_sine_qkv_weight(amplitudes).contiguous()
    args = (x2d, w, freq.contiguous(), phase.contiguous())
    y = (_SineFn.apply(*args, "sinekan_qkv_grouped") if kernel
         else _SineBf16Plain.apply(*args))
    return y if bias is None else y + bias.reshape(1, h * nout)
