"""Fused B-spline KAN layer on the card, forward and backward (counterpart
of ``kanvit/kernels/fused_basis.py``).

Two entry points share the CUDA kernels of ``csrc/bspline_kan.cu``:

- :func:`bspline_kan` — one KANLinear (the patch embedder), one group;
- :func:`bspline_qkv_grouped` — the joint q/k/v projection of every
  attention head in one launch, one group per head.

Dispatch is by device (``kanvit_torch.ops.dispatch``): a CPU tensor runs the
plain version in ``kanvit_torch.ops.kan_bases`` and autograd differentiates
it; a CUDA tensor goes through :class:`_BsplineFn`, whose forward and
backward launch the kernels or raise. The kernels are built for f32, spline
order 3 and a 12-knot grid (grid size 5, the efficient-kan default) and
raise on anything else.

The Function takes the packed weight ``(G, 9, nin, out)`` and returns its
gradient; the packing (:func:`pack_weight`, :func:`pack_qkv_weight`) is
plain differentiable torch, so autograd carries d(packed) back to
``base_weight``, ``spline_weight`` and ``spline_scaler``, as kanvit builds
its packed weight with jnp ops outside the ``custom_vjp``. The knot grid
gets no gradient (kanvit returns zeros for it).

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
MAX_ROW_TILES = 65535                # the kernel's grid.y limit, 64 rows each
ROWS_PER_TILE = 64

LAUNCHES = {"bspline_kan": 0, "bspline_qkv_grouped": 0,
            "bspline_kan_bwd": 0, "bspline_qkv_grouped_bwd": 0}
# Blocks the dW reduction aims at before it cuts its rows into splits
# (132 SMs of an H100, several 64-thread blocks each).
DW_TARGET_BLOCKS = 1024
DW_MIN_ROWS_PER_SPLIT = 128
DW_TILE = (8, 64)  # (features, outputs) per dW block, as in the kernel


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


def check_args(x2d: torch.Tensor, grid: torch.Tensor, w: torch.Tensor,
               spline_order: int) -> None:
    """Raise on anything the kernel does not take (device aside).

    ``x2d (N, G*nin)`` with a unit column stride; ``grid (nin, 12)``;
    ``w (G, 9, nin, out)`` contiguous; all f32.
    """
    if spline_order != SPLINE_ORDER:
        raise ValueError(f"the kernel is built for spline order {SPLINE_ORDER}, "
                         f"got {spline_order}")
    for name, t in (("x", x2d), ("grid", grid), ("weight", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(bf16 is not ported yet)")
    if x2d.dim() != 2 or w.dim() != 4:
        raise ValueError(f"expected x (N, G*nin) and w (G, 9, nin, out), got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    groups, slices, nin, _ = w.shape
    if slices != N_SLICES or x2d.shape[1] != groups * nin:
        raise ValueError(f"x {tuple(x2d.shape)} does not match packed weight "
                         f"{tuple(w.shape)}")
    if tuple(grid.shape) != (nin, KNOTS):
        raise ValueError(f"grid must be ({nin}, {KNOTS}), got {tuple(grid.shape)}")
    if x2d.shape[1] > 1 and x2d.stride(1) != 1:
        raise ValueError("x must have a unit column stride")
    if not w.is_contiguous():
        raise ValueError("packed weight must be contiguous")
    if -(-x2d.shape[0] // ROWS_PER_TILE) > MAX_ROW_TILES or groups > 65535:
        raise ValueError(f"{x2d.shape[0]} rows x {groups} groups exceed the "
                         "kernel's launch grid")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")


def _launch(name: str, x2d: torch.Tensor, grid: torch.Tensor,
            w: torch.Tensor, spline_order: int) -> torch.Tensor:
    check_args(x2d, grid, w, spline_order)
    _check_device(name, x2d, grid, w)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    y = torch.empty(n, groups * out, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    gridt = grid.T.contiguous()  # (12, nin): the kernel reads knot rows
    with torch.cuda.device(x2d.device):
        err = _build.load().kanvit_bspline_kan_fwd(
            x2d.data_ptr(), x2d.stride(0), gridt.data_ptr(), w.data_ptr(),
            y.data_ptr(), n, groups, nin, out, _stream(x2d.device),
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def dw_splits(n: int, groups: int, nin: int, out: int, n_sm: int) -> int:
    """Row splits of the dW reduction: enough (feature x output) tiles times
    splits to fill the card, each split at least ``DW_MIN_ROWS_PER_SPLIT``
    rows. A function of the shape and the card only, so a run repeats its
    bits."""
    tiles = groups * -(-nin // DW_TILE[0]) * -(-out // DW_TILE[1])
    want = -(-(DW_TARGET_BLOCKS * n_sm // 132) // tiles)
    return max(1, min(want, n // DW_MIN_ROWS_PER_SPLIT, 65535 // groups))


def _launch_bwd(name: str, x2d: torch.Tensor, grid: torch.Tensor,
                w: torch.Tensor, gy: torch.Tensor, need_dx: bool,
                need_dw: bool):
    """``(dx (N, G*nin) or None, dw (G, 9, nin, out) or None)`` from the
    backward kernels; ``gy`` is the gradient of the forward's output."""
    check_args(x2d, grid, w, SPLINE_ORDER)
    _check_device(name, x2d, grid, w, gy)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    if gy.dtype != torch.float32 or tuple(gy.shape) != (n, groups * out):
        raise ValueError(f"{name}: gradient must be f32 {(n, groups * out)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    dev = x2d.device
    dx = (torch.empty(n, groups * nin, dtype=torch.float32, device=dev)
          if need_dx else None)
    dw = torch.empty_like(w) if need_dw else None
    if n == 0:
        return dx, (None if dw is None else dw.zero_())
    from kanvit_torch.kernels import _build

    gy = gy.contiguous()
    gridt = grid.T.contiguous()
    splits = dw_splits(n, groups, nin, out,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    part = (torch.empty(splits, *w.shape, dtype=torch.float32, device=dev)
            if need_dw and splits > 1 else None)
    with torch.cuda.device(dev):
        err = _build.load().kanvit_bspline_kan_bwd(
            x2d.data_ptr(), x2d.stride(0), gridt.data_ptr(), w.data_ptr(),
            gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), n, groups, nin, out,
            splits, _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return dx, dw


class _BsplineFn(torch.autograd.Function):
    """``y = x2d -> basis -> @ w`` on the card: the forward kernel, and the
    backward kernels for dx and d(packed weight). Saves x and the packed
    weight (kanvit's residual, ``fused_basis.py:1327``)."""

    @staticmethod
    def forward(ctx, x2d, w, grid, name, spline_order):
        ctx.name = name
        ctx.save_for_backward(x2d, w, grid)
        return _launch(name, x2d, grid, w, spline_order)

    @staticmethod
    def backward(ctx, gy):
        x2d, w, grid = ctx.saved_tensors
        dx, dw = _launch_bwd(f"{ctx.name}_bwd", x2d, grid, w, gy,
                             ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, dw, None, None, None


def bspline_kan(x, grid, base_weight, spline_weight, spline_scaler,
                spline_order=3):
    """KANLinear forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.bspline_kan_forward``;
    ``grid (in, 12)``, ``base_weight (out, in)``, ``spline_weight
    (out, in, 8)``, ``spline_scaler (out, in)`` or None.
    """
    if not dispatch.use_kernel(x):
        return K.bspline_kan_forward(x, grid, base_weight, spline_weight,
                                     spline_scaler, spline_order)
    lead, nin = x.shape[:-1], x.shape[-1]
    w = pack_weight(base_weight, spline_weight, spline_scaler).unsqueeze(0)
    y = _BsplineFn.apply(x.reshape(-1, nin), w.contiguous(), grid,
                         "bspline_kan", spline_order)
    return y.reshape(*lead, base_weight.shape[0])


def bspline_qkv_grouped(x2d, grid, bw, sw, sc, spline_order=3):
    """Joint q/k/v B-spline projection of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``;
    ``bw (H, out, dh)``, ``sw (H, out, dh, 8)``, ``sc (H, out, dh)`` the
    per-head q|k|v-concatenated KANLinear params (out = 3*dh); ``grid
    (dh, 12)`` shared by all heads. Returns ``y (N, H*out)`` with head h at
    ``[h*out, (h+1)*out)``.
    """
    h, _, dh = bw.shape
    if not dispatch.use_kernel(x2d):
        return torch.cat([
            K.bspline_kan_forward(x2d[:, i * dh:(i + 1) * dh], grid, bw[i],
                                  sw[i], sc[i], spline_order)
            for i in range(h)
        ], dim=1)
    w = pack_qkv_weight(bw, sw, sc).contiguous()
    return _BsplineFn.apply(x2d, w, grid, "bspline_qkv_grouped", spline_order)
