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

Dispatch is by device (``kanvit_torch.ops.dispatch``): a CPU tensor runs the
plain version in ``kanvit_torch.ops.kan_bases`` and autograd differentiates
it; a CUDA tensor goes through :class:`_KanFn`, :class:`_RbfFn` or
:class:`_SineFn`, whose forward and backward launch the kernels or raise.
The kernels are built for f32; the B-spline one for spline order 3 and a
12-knot grid (grid size 5, the efficient-kan default), the Chebyshev one for
degree 4, the RBF one for 8 centres; they raise on anything else.

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
FOURIER_CHUNK = 4                    # harmonics per slice chunk, as in the kernel
RBF_GRIDS = 8                        # RBF centres, as the kernel is built
SINE_CHUNK = 4                       # sine slices per chunk, as in the kernel
MAX_ROW_TILES = 65535                # the kernel's grid.y limit, 64 rows each
ROWS_PER_TILE = 64

LAUNCHES = {name: 0 for base in ("bspline_kan", "bspline_qkv_grouped",
                                 "chebykan", "cheby_qkv_grouped", "fourierkan",
                                 "fastkan", "fastkan_qkv_grouped", "sinekan",
                                 "sinekan_qkv_grouped")
            for name in (base, f"{base}_bwd")}
# Blocks the dW reduction aims at before it cuts its rows into splits
# (132 SMs of an H100, several 64-thread blocks each).
DW_TARGET_BLOCKS = 1024
DW_MIN_ROWS_PER_SPLIT = 128
DW_TILE = (8, 64)  # (features, outputs) per dW block, as in the kernel
DX_TILE = (64, 16)  # (rows, features) per dx block, as in the kernel
LN_ROWS_PER_SPLIT = 64  # rows per partial of the LayerNorm's dgamma, dbeta


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


def _chunks(family: str, aux) -> int:
    """Slice chunks the kernels walk (Fourier: 4 harmonics a chunk; sine:
    4 slices a chunk)."""
    if family == "fourier":
        return -(-aux // FOURIER_CHUNK)
    return -(-aux // SINE_CHUNK) if family == "sine" else 1


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


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape}, got "
                         f"{tuple(t.shape)}")


def check_rbf_args(x2d, w, gamma, beta, grid) -> None:
    """Raise on anything the RBF kernels do not take (device aside): ``w
    (G, 8 or 9, nin, out)`` (the 9th slice the silu base branch), ``gamma``
    and ``beta`` ``(G, nin)`` or both None (no LayerNorm), ``grid`` the 8
    centres, all f32 and contiguous."""
    if grid.numel() != RBF_GRIDS:
        raise ValueError(f"the kernel is built for {RBF_GRIDS} RBF centres, "
                         f"got {grid.numel()}")
    _check_f32("grid", grid, (RBF_GRIDS,))
    if w.dim() != 4 or w.shape[1] not in (RBF_GRIDS, RBF_GRIDS + 1):
        raise ValueError(f"packed weight must be (G, {RBF_GRIDS} or "
                         f"{RBF_GRIDS + 1}, nin, out), got {tuple(w.shape)}")
    _check_common(x2d, w, w.shape[1])
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta are both given or both None")
    if gamma is not None:
        for name, t in (("gamma", gamma), ("beta", beta)):
            _check_f32(name, t, tuple(w.shape[:1]) + tuple(w.shape[2:3]))


def check_sine_args(x2d, w, freq2d, phase) -> None:
    """Raise on anything the sine kernels do not take (device aside): ``w
    (G, S, nin, out)``, ``freq2d (G, S)``, ``phase (nin, S)``, all f32 and
    contiguous, and a dW launch grid of (features / 8) x (S / 4) blocks
    within 65535."""
    if w.dim() != 4 or w.shape[1] < 1:
        raise ValueError(f"packed weight must be (G, S, nin, out), got "
                         f"{tuple(w.shape)}")
    groups, slices, nin, _ = w.shape
    _check_common(x2d, w, slices)
    _check_f32("freq", freq2d, (groups, slices))
    _check_f32("phase", phase, (nin, slices))
    if -(-nin // DW_TILE[0]) * _chunks("sine", slices) > 65535:
        raise ValueError(f"{nin} features x grid size {slices} exceed the dW "
                         "kernel's launch grid")


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


def _check_gy(name: str, gy: torch.Tensor, shape: tuple) -> torch.Tensor:
    if gy.dtype != torch.float32 or tuple(gy.shape) != shape:
        raise ValueError(f"{name}: gradient must be f32 {shape}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    return gy.contiguous()


def _dw_scratch(n, w, family, aux, dev):
    """``(splits, scratch of the dW splits or None)`` for a backward launch
    of ``family`` over ``n`` rows and the packed weight ``w``."""
    groups, _, nin, out = w.shape
    splits = dw_splits(n, groups, nin, out,
                       torch.cuda.get_device_properties(dev).multi_processor_count,
                       _chunks(family, aux))
    return splits, (_empty(splits, *w.shape, device=dev) if splits > 1 else None)


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
    gy = _check_gy(name, gy, (n, groups * out))
    dev = x2d.device
    dx = _empty(n, groups * nin, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if n == 0:
        return dx, (None if dw is None else dw.zero_())
    from kanvit_torch.kernels import _build

    splits, part = _dw_scratch(n, w, family, aux, dev) if need_dw else (1, None)
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


def _launch_rbf(name: str, x2d, w, gamma, beta, grid, denominator: float):
    """``(y (N, G*out), stats (N, G, 2) or None)`` from the RBF forward
    kernels: the LayerNorm's statistics when ``gamma`` is given, then the
    fused RBF (and silu, for a 9-slice weight) contraction."""
    check_rbf_args(x2d, w, gamma, beta, grid)
    _check_device(name, x2d, w, grid, *(() if gamma is None else (gamma, beta)))
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    dev = x2d.device
    y = _empty(n, groups * out, device=dev)
    stats = None if gamma is None else _empty(n, groups, 2, device=dev)
    if n == 0:
        return y, stats
    from kanvit_torch.kernels import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.kanvit_fastkan_fwd(
            x2d.data_ptr(), x2d.stride(0), _ptr(gamma), _ptr(beta),
            grid.data_ptr(), 1.0 / denominator, w.data_ptr(), y.data_ptr(),
            _ptr(stats), n, groups, nin, out, slices - RBF_GRIDS, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y, stats


def _launch_rbf_bwd(name: str, x2d, w, gamma, beta, grid, denominator: float,
                    stats, gy, need_dx: bool, need_dw: bool):
    """``(dx or None, dw or None, dgamma, dbeta)`` from the RBF backward
    kernels; dgamma and dbeta ``(G, nin)`` whenever the layer has its
    LayerNorm (its dln pass runs even with no dx), else None."""
    check_rbf_args(x2d, w, gamma, beta, grid)
    ln = gamma is not None
    _check_device(name, x2d, w, grid, gy, *((gamma, beta, stats) if ln else ()))
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out))
    dev = x2d.device
    dx = _empty(n, groups * nin, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    dgb = _empty(2, groups, nin, device=dev) if ln else None
    if n == 0:
        dgb = None if dgb is None else dgb.zero_()
        return (dx, None if dw is None else dw.zero_(),
                *((None, None) if dgb is None else dgb))
    from kanvit_torch.kernels import _build

    splits, part = _dw_scratch(n, w, "rbf", None, dev) if need_dw else (1, None)
    ln_splits = -(-n // LN_ROWS_PER_SPLIT)
    dln = _empty(n, groups * nin, device=dev) if ln else None
    dgb_part = _empty(ln_splits, 2, groups, nin, device=dev) if ln else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.kanvit_fastkan_bwd(
            x2d.data_ptr(), x2d.stride(0), _ptr(gamma), _ptr(beta),
            grid.data_ptr(), 1.0 / denominator, _ptr(stats), w.data_ptr(),
            gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part), _ptr(dln), _ptr(dgb),
            _ptr(dgb_part), n, groups, nin, out, slices - RBF_GRIDS, splits,
            ln_splits, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return dx, dw, *((None, None) if dgb is None else dgb)


class _RbfFn(torch.autograd.Function):
    """``y = x2d -> [LN] -> RBF (+ silu) -> @ w`` on the card; the backward
    returns dx, d(packed weight), dgamma and dbeta. Saves x, the packed
    weight, gamma, beta and the LayerNorm's (mean, rstd) (kanvit saves x and
    recomputes the statistics, ``fused_basis.py:2980``)."""

    @staticmethod
    def forward(ctx, x2d, w, gamma, beta, grid, denominator, name):
        y, stats = _launch_rbf(name, x2d, w, gamma, beta, grid, denominator)
        ctx.name, ctx.denominator = name, denominator
        ctx.save_for_backward(x2d, w, gamma, beta, grid, stats)
        return y

    @staticmethod
    def backward(ctx, gy):
        x2d, w, gamma, beta, grid, stats = ctx.saved_tensors
        dx, dw, dgamma, dbeta = _launch_rbf_bwd(
            f"{ctx.name}_bwd", x2d, w, gamma, beta, grid, ctx.denominator, stats,
            gy, ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, dw, dgamma, dbeta, None, None, None


def fastkan(x, ln_gamma, ln_beta, rbf_grid, rbf_denominator, spline_weight,
            base_weight, base_bias):
    """FastKAN layer forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.fastkan_forward``:
    ``ln_gamma``, ``ln_beta`` ``(in,)`` or None (no LayerNorm); ``rbf_grid``
    the 8 centres; ``spline_weight (out, in*8)``; ``base_weight (out, in)``
    and ``base_bias (out,)``, or None (no base branch). The LayerNorm and
    the silu base branch run inside the kernels; the bias is added outside,
    as kanvit adds it.
    """
    if not dispatch.use_kernel(x):
        return K.fastkan_forward(x, ln_gamma, ln_beta, rbf_grid, rbf_denominator,
                                 spline_weight, base_weight, base_bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = spline_weight.shape[0]
    w = pack_fastkan_weight(spline_weight, base_weight, rbf_grid.numel())
    gamma, beta = ((None, None) if ln_gamma is None
                   else (ln_gamma.reshape(1, nin), ln_beta.reshape(1, nin)))
    y = _RbfFn.apply(x.reshape(-1, nin), w.unsqueeze(0).contiguous(), gamma, beta,
                     rbf_grid.contiguous(), float(rbf_denominator), "fastkan")
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
    included, head h at ``[h*out, (h+1)*out)``.
    """
    h, nout, dh = base_weight.shape
    if not dispatch.use_kernel(x2d):
        return torch.cat([
            K.fastkan_forward(x2d[:, i * dh:(i + 1) * dh], ln_gamma[i], ln_beta[i],
                              rbf_grid, rbf_denominator, spline_weight[i],
                              base_weight[i], base_bias[i])
            for i in range(h)
        ], dim=1)
    w = pack_fastkan_qkv_weight(spline_weight, base_weight, rbf_grid.numel())
    y = _RbfFn.apply(x2d, w.contiguous(), ln_gamma.contiguous(),
                     ln_beta.contiguous(), rbf_grid.contiguous(),
                     float(rbf_denominator), "fastkan_qkv_grouped")
    return y + base_bias.reshape(1, h * nout)


def _launch_sine(name: str, x2d, w, freq2d, phase) -> torch.Tensor:
    """``y (N, G*out)`` from the sine forward kernel."""
    check_sine_args(x2d, w, freq2d, phase)
    _check_device(name, x2d, w, freq2d, phase)
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    y = _empty(n, groups * out, device=x2d.device)
    if n == 0:
        return y
    from kanvit_torch.kernels import _build

    lib = _build.load()
    with torch.cuda.device(x2d.device):
        err = lib.kanvit_sinekan_fwd(
            x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(),
            w.data_ptr(), y.data_ptr(), n, groups, nin, out, slices,
            _stream(x2d.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _launch_sine_bwd(name: str, x2d, w, freq2d, phase, gy, need_dx: bool,
                     need_dw: bool):
    """``(dx or None, dw or None, dfreq (G, S))`` from the sine backward
    kernels: the dx kernel (writing no dx unless asked) with its dfreq
    sums, and dW."""
    check_sine_args(x2d, w, freq2d, phase)
    _check_device(name, x2d, w, freq2d, phase, gy)
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    gy = _check_gy(name, gy, (n, groups * out))
    dev = x2d.device
    dx = _empty(n, groups * nin, device=dev) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    dfreq = _empty(groups, slices, device=dev)
    if n == 0:
        return dx, None if dw is None else dw.zero_(), dfreq.zero_()
    from kanvit_torch.kernels import _build

    splits, part = (_dw_scratch(n, w, "sine", slices, dev) if need_dw
                    else (1, None))
    blocks = -(-nin // DX_TILE[1]) * -(-n // DX_TILE[0])
    dfreq_part = _empty(groups, blocks, slices, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.kanvit_sinekan_bwd(
            x2d.data_ptr(), x2d.stride(0), freq2d.data_ptr(), phase.data_ptr(),
            w.data_ptr(), gy.data_ptr(), _ptr(dx), _ptr(dw), _ptr(part),
            dfreq.data_ptr(), dfreq_part.data_ptr(), n, groups, nin, out, slices,
            splits, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return dx, dw, dfreq


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


def sinekan(x, freq, phase, amplitudes, bias):
    """SineKAN forward, ``(..., in) -> (..., out)``, differentiable.

    Same signature as ``kanvit_torch.ops.kan_bases.sinekan_forward``:
    ``freq`` with G entries (``(G,)`` or the reference's ``(1, 1, 1, G)``),
    ``phase (in, G)``, ``amplitudes (out, in, G)``, ``bias`` ``(out,)``,
    ``(1, out)`` or None, added outside the kernel as kanvit adds it.
    """
    if not dispatch.use_kernel(x):
        return K.sinekan_forward(x, freq, phase, amplitudes, bias)
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = amplitudes.shape[0]
    w = pack_sine_weight(amplitudes).contiguous()
    y = _SineFn.apply(x.reshape(-1, nin), w, freq.reshape(1, -1).contiguous(),
                      phase.contiguous(), "sinekan")
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


def sinekan_qkv_grouped(x2d, freq, phase, amplitudes, bias):
    """One SineKAN projection (q, k or v) of every head, differentiable.

    ``x2d (N, H*dh)`` with head h at columns ``[h*dh, (h+1)*dh)``; ``freq
    (H, G)`` per head; ``phase (dh, G)``, the table every head shares;
    ``amplitudes (H, out, dh, G)``; ``bias (H, out)`` or None. Returns ``y
    (N, H*out)``, head h at ``[h*out, (h+1)*out)``.
    """
    h, nout, dh, _ = amplitudes.shape
    if not dispatch.use_kernel(x2d):
        return torch.cat([
            K.sinekan_forward(x2d[:, i * dh:(i + 1) * dh], freq[i], phase,
                              amplitudes[i], None if bias is None else bias[i])
            for i in range(h)
        ], dim=1)
    w = pack_sine_qkv_weight(amplitudes).contiguous()
    y = _SineFn.apply(x2d, w, freq.contiguous(), phase.contiguous(),
                      "sinekan_qkv_grouped")
    return y if bias is None else y + bias.reshape(1, h * nout)
