"""Fused KAN layers on the card, forward and backward (counterpart of
``kanvit/kernels/fused_basis.py``).

Six entry points share the templated CUDA kernels of ``csrc/kan_basis.cu``,
one instantiation per basis family:

- :func:`bspline_kan` — one efficient-kan KANLinear (the patch embedder);
- :func:`bspline_qkv_grouped` — the joint B-spline q/k/v projection of every
  attention head in one launch, one group per head;
- :func:`chebykan` — one ChebyKAN layer (degree 4);
- :func:`cheby_qkv_grouped` — the joint Chebyshev q/k/v projection;
- :func:`fourierkan` — one NaiveFourierKAN layer (any grid size).

Dispatch is by device (``kanvit_torch.ops.dispatch``): a CPU tensor runs the
plain version in ``kanvit_torch.ops.kan_bases`` and autograd differentiates
it; a CUDA tensor goes through :class:`_KanFn`, whose forward and backward
launch the kernels or raise. The kernels are built for f32; the B-spline
one for spline order 3 and a 12-knot grid (grid size 5, the efficient-kan
default), the Chebyshev one for degree 4; they raise on anything else.

The Function takes the packed weight ``(G, S, nin, out)`` and returns its
gradient; the packing (:func:`pack_weight`, :func:`pack_qkv_weight`, the
permutes in the Chebyshev and Fourier wrappers) is plain differentiable
torch, so autograd carries d(packed) back to the layer's parameters, as
kanvit builds its packed weight with jnp ops outside the ``custom_vjp``.
The knot grid gets no gradient (kanvit returns zeros for it).

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
FOURIER_CHUNK = 4                    # harmonics per slice chunk, as in the kernel
MAX_ROW_TILES = 65535                # the kernel's grid.y limit, 64 rows each
ROWS_PER_TILE = 64

LAUNCHES = {name: 0 for base in ("bspline_kan", "bspline_qkv_grouped",
                                 "chebykan", "cheby_qkv_grouped", "fourierkan")
            for name in (base, f"{base}_bwd")}
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


def _chunks(family: str, aux) -> int:
    """Slice chunks the kernels walk (Fourier: 4 harmonics a chunk)."""
    return -(-aux // FOURIER_CHUNK) if family == "fourier" else 1


def _check_spline_order(spline_order: int) -> None:
    if spline_order != SPLINE_ORDER:
        raise ValueError(f"the kernel is built for spline order {SPLINE_ORDER}, "
                         f"got {spline_order}")


def _check_common(x2d: torch.Tensor, w: torch.Tensor, slices: int) -> None:
    for name, t in (("x", x2d), ("weight", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(bf16 is not ported yet)")
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
               spline_order: int) -> None:
    """Raise on anything the B-spline kernel does not take (device aside).

    ``x2d (N, G*nin)`` with a unit column stride; ``grid (nin, 12)``;
    ``w (G, 9, nin, out)`` contiguous; all f32.
    """
    _check_spline_order(spline_order)
    if grid.dtype != torch.float32:
        raise TypeError(f"grid must be float32, got {grid.dtype}")
    _check_common(x2d, w, N_SLICES)
    if tuple(grid.shape) != (w.shape[2], KNOTS):
        raise ValueError(f"grid must be ({w.shape[2]}, {KNOTS}), got "
                         f"{tuple(grid.shape)}")


def check_cheby_args(x2d: torch.Tensor, w: torch.Tensor, degree: int) -> None:
    """Raise on anything the Chebyshev kernel does not take (device aside):
    degree 4, ``w (G, 5, nin, out)`` contiguous, f32."""
    if degree != CHEBY_DEGREE:
        raise ValueError(f"the kernel is built for Chebyshev degree "
                         f"{CHEBY_DEGREE}, got {degree}")
    _check_common(x2d, w, CHEBY_DEGREE + 1)


def check_fourier_args(x2d: torch.Tensor, w: torch.Tensor, grid_size: int) -> None:
    """Raise on anything the Fourier kernel does not take (device aside):
    ``w (G, 2*grid_size, nin, out)`` contiguous, f32, and a dW launch grid
    of (features / 8) x (grid_size / 4) blocks within 65535."""
    if grid_size < 1:
        raise ValueError(f"grid size must be >= 1, got {grid_size}")
    _check_common(x2d, w, 2 * grid_size)
    if -(-w.shape[2] // DW_TILE[0]) * _chunks("fourier", grid_size) > 65535:
        raise ValueError(f"{w.shape[2]} features x grid size {grid_size} exceed "
                         "the dW kernel's launch grid")


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


def _tensors(family: str, x2d, w, aux, *more):
    return (x2d, w, *more, *((aux,) if family == "bspline" else ()))


def _launch(name: str, family: str, x2d: torch.Tensor, w: torch.Tensor,
            aux) -> torch.Tensor:
    """``y (N, G*out)`` from the forward kernel of ``family`` ("bspline",
    "cheby" or "fourier"); ``aux`` is the knot grid ``(nin, 12)``, the
    degree or the grid size."""
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
            gridt = aux.T.contiguous()  # (12, nin): the kernel reads knot rows
            err = lib.kanvit_bspline_kan_fwd(*args, gridt.data_ptr(), w.data_ptr(),
                                             y.data_ptr(), *shape, stream)
        elif family == "cheby":
            err = lib.kanvit_chebykan_fwd(*args, w.data_ptr(), y.data_ptr(),
                                          *shape, stream)
        else:
            err = lib.kanvit_fourierkan_fwd(*args, w.data_ptr(), y.data_ptr(),
                                            *shape, aux, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def dw_splits(n: int, groups: int, nin: int, out: int, n_sm: int,
              chunks: int = 1) -> int:
    """Row splits of the dW reduction: enough (feature x slice-chunk x
    output) tiles times splits to fill the card, each split at least
    ``DW_MIN_ROWS_PER_SPLIT`` rows. A function of the shape and the card
    only, so a run repeats its bits."""
    tiles = groups * chunks * -(-nin // DW_TILE[0]) * -(-out // DW_TILE[1])
    want = -(-(DW_TARGET_BLOCKS * n_sm // 132) // tiles)
    return max(1, min(want, n // DW_MIN_ROWS_PER_SPLIT, 65535 // groups))


def _launch_bwd(name: str, family: str, x2d: torch.Tensor, w: torch.Tensor,
                aux, gy: torch.Tensor, need_dx: bool, need_dw: bool):
    """``(dx (N, G*nin) or None, dw (G, S, nin, out) or None)`` from the
    backward kernels of ``family``; ``gy`` is the gradient of the forward's
    output."""
    _check(family, x2d, w, aux)
    _check_device(name, *_tensors(family, x2d, w, aux, gy))
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
    splits = dw_splits(n, groups, nin, out,
                       torch.cuda.get_device_properties(dev).multi_processor_count,
                       _chunks(family, aux))
    part = (torch.empty(splits, *w.shape, dtype=torch.float32, device=dev)
            if need_dw and splits > 1 else None)
    lib = _build.load()
    args = (x2d.data_ptr(), x2d.stride(0))
    grads = (gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), n, groups, nin, out)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        if family == "bspline":
            gridt = aux.T.contiguous()
            err = lib.kanvit_bspline_kan_bwd(*args, gridt.data_ptr(), w.data_ptr(),
                                             *grads, splits, stream)
        elif family == "cheby":
            err = lib.kanvit_chebykan_bwd(*args, w.data_ptr(), *grads, splits,
                                          stream)
        else:
            err = lib.kanvit_fourierkan_bwd(*args, w.data_ptr(), *grads, aux,
                                            splits, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return dx, dw


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
        dx, dw = _launch_bwd(f"{ctx.name}_bwd", ctx.family, x2d, w, aux, gy,
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
    _check_spline_order(spline_order)
    lead, nin = x.shape[:-1], x.shape[-1]
    w = pack_weight(base_weight, spline_weight, spline_scaler).unsqueeze(0)
    y = _KanFn.apply(x.reshape(-1, nin), w.contiguous(), grid, "bspline_kan",
                     "bspline")
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
    _check_spline_order(spline_order)
    w = pack_qkv_weight(bw, sw, sc).contiguous()
    return _KanFn.apply(x2d, w, grid, "bspline_qkv_grouped", "bspline")


def chebykan(x, coeffs):
    """ChebyKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.chebykan_forward``;
    ``coeffs (in, out, degree+1)``.
    """
    if not dispatch.use_kernel(x):
        return K.chebykan_forward(x, coeffs)
    lead, nin = x.shape[:-1], x.shape[-1]
    w = pack_cheby_weight(coeffs).contiguous()
    y = _KanFn.apply(x.reshape(-1, nin), w, coeffs.shape[2] - 1, "chebykan",
                     "cheby")
    return y.reshape(*lead, coeffs.shape[1])


def cheby_qkv_grouped(x2d, cc):
    """Joint q/k/v Chebyshev projection of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``; ``cc
    (H, dh, out, D)`` the per-head q|k|v-concatenated ChebyKAN coefficients
    (out = 3*dh). Returns ``y (N, H*out)`` with head h at ``[h*out,
    (h+1)*out)``, as ``bspline_qkv_grouped``.
    """
    h, dh, _, deg1 = cc.shape
    if not dispatch.use_kernel(x2d):
        return torch.cat([K.chebykan_forward(x2d[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)
    w = pack_cheby_qkv_weight(cc).contiguous()
    return _KanFn.apply(x2d, w, deg1 - 1, "cheby_qkv_grouped", "cheby")


def fourierkan(x, coeffs, bias):
    """NaiveFourierKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.fourierkan_forward``;
    ``coeffs (2, out, in, grid)``, ``bias`` ``(out,)``, ``(1, out)`` or
    None. The bias is added outside the kernel, as kanvit adds it.
    """
    if not dispatch.use_kernel(x):
        return K.fourierkan_forward(x, coeffs, bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, _, grid_size = coeffs.shape
    w = pack_fourier_weight(coeffs).contiguous()
    y = _KanFn.apply(x.reshape(-1, nin), w, grid_size, "fourierkan", "fourier")
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)
