"""Fused B-spline KAN forward on the card (counterpart of
``kanvit/kernels/fused_basis.py``).

Two entry points share the CUDA kernel ``csrc/bspline_kan.cu``:

- :func:`bspline_kan` — one KANLinear (the patch embedder), one group;
- :func:`bspline_qkv_grouped` — the joint q/k/v projection of every
  attention head in one launch, one group per head.

Dispatch is by device (``kanvit_torch.ops.dispatch``): a CPU tensor runs the
plain version in ``kanvit_torch.ops.kan_bases``; a CUDA tensor launches the
kernel or raises. The kernel is built for f32, spline order 3 and a 12-knot
grid (grid size 5, the efficient-kan default) and raises on anything else.
Forward only: an input that needs a gradient raises.

``LAUNCHES`` counts kernel launches per entry point; the CPU path never
counts.
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

LAUNCHES = {"bspline_kan": 0, "bspline_qkv_grouped": 0}


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


def _launch(name: str, x2d: torch.Tensor, grid: torch.Tensor,
            w: torch.Tensor, spline_order: int) -> torch.Tensor:
    check_args(x2d, grid, w, spline_order)
    if {t.device for t in (x2d, grid, w)} != {x2d.device}:
        raise ValueError(f"{name}: x, grid and weight must be on one device")
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    y = torch.empty(n, groups * out, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    gridt = grid.T.contiguous()  # (12, nin): the kernel reads knot rows
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = _build.load().kanvit_bspline_kan_fwd(
            x2d.data_ptr(), x2d.stride(0), gridt.data_ptr(), w.data_ptr(),
            y.data_ptr(), n, groups, nin, out, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def bspline_kan(x, grid, base_weight, spline_weight, spline_scaler,
                spline_order=3):
    """KANLinear forward, ``(..., in) -> (..., out)``.

    Same signature as ``kanvit_torch.ops.kan_bases.bspline_kan_forward``;
    ``grid (in, 12)``, ``base_weight (out, in)``, ``spline_weight
    (out, in, 8)``, ``spline_scaler (out, in)`` or None.
    """
    dispatch.check_no_grad("bspline_kan", x, base_weight, spline_weight,
                           spline_scaler)
    if not dispatch.use_kernel(x):
        return K.bspline_kan_forward(x, grid, base_weight, spline_weight,
                                     spline_scaler, spline_order)
    lead, nin = x.shape[:-1], x.shape[-1]
    w = pack_weight(base_weight, spline_weight, spline_scaler).unsqueeze(0)
    y = _launch("bspline_kan", x.reshape(-1, nin), grid, w.contiguous(),
                spline_order)
    return y.reshape(*lead, base_weight.shape[0])


def bspline_qkv_grouped(x2d, grid, bw, sw, sc, spline_order=3):
    """Joint q/k/v B-spline projection of every head.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``;
    ``bw (H, out, dh)``, ``sw (H, out, dh, 8)``, ``sc (H, out, dh)`` the
    per-head q|k|v-concatenated KANLinear params (out = 3*dh); ``grid
    (dh, 12)`` shared by all heads. Returns ``y (N, H*out)`` with head h at
    ``[h*out, (h+1)*out)``.
    """
    dispatch.check_no_grad("bspline_qkv_grouped", x2d, bw, sw, sc)
    h, _, dh = bw.shape
    if not dispatch.use_kernel(x2d):
        return torch.cat([
            K.bspline_kan_forward(x2d[:, i * dh:(i + 1) * dh], grid, bw[i],
                                  sw[i], sc[i], spline_order)
            for i in range(h)
        ], dim=1)
    w = pack_qkv_weight(bw, sw, sc).contiguous()
    return _launch("bspline_qkv_grouped", x2d, grid, w, spline_order)
