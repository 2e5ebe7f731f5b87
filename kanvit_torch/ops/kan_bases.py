"""KAN basis math in plain PyTorch (counterpart of ``kanvit/ops/kan_bases.py``).

These functions are the plain versions of the CUDA kernels in
``kanvit_torch.kernels.fused_basis``: the CPU path runs them (autograd
through :func:`bspline_kan_forward`, :func:`chebykan_forward`,
:func:`fourierkan_forward`, :func:`fastkan_forward` and
:func:`sinekan_forward` is the backward kernels' plain version), and the
card holds the kernels against them: the B-spline (efficient-kan),
Chebyshev, Fourier, RBF (FastKAN, with its LayerNorm) and sine families.
The bf16 kernels' plain twins (kanvit's kernel route on bf16 operands:
the basis in f32, rounded to bf16 at the dot, f32 sums, each output
rounded once) are :func:`grouped_forward_bf16` and
:func:`grouped_backward_bf16` over a family's slices, for B-spline and
Chebyshev, and the FastKAN and SineKAN layers' own (``fastkan_grouped_*``,
``sine_grouped_*``); they are the CPU route of a bf16 layer. The fused
pre-LN FF's plain version is :func:`ffn_pre_ln`, its bf16 kernels' twins
:func:`ffn_pre_ln_bf16` and :func:`ffn_pre_ln_bwd_bf16`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_bspline_grid(
    in_features: int,
    grid_size: int = 5,
    spline_order: int = 3,
    grid_range=(-1.0, 1.0),
    *,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Uniform knot grid ``(in, grid_size + 2*spline_order + 1)`` float32.

    ``spline_order`` padding knots on each side, spacing
    ``h = (r1 - r0) / grid_size`` (reference ``effkan.py:44-53``); the same
    float32 arithmetic as ``kanvit.ops.kan_bases.make_bspline_grid``.
    """
    h = (grid_range[1] - grid_range[0]) / grid_size
    pts = (
        torch.arange(-spline_order, grid_size + spline_order + 1,
                     dtype=torch.float32, device=device)
        * h
        + grid_range[0]
    )
    return pts.expand(in_features, pts.shape[0]).contiguous()


def bspline_bases(x: torch.Tensor, grid: torch.Tensor,
                  spline_order: int = 3) -> torch.Tensor:
    """Cox–de Boor B-spline bases.

    ``x``: ``(N, in)``; ``grid``: ``(in, grid_size + 2*order + 1)``.
    Returns ``(N, in, grid_size + order)``. Order-0 bases are the half-open
    indicators ``g_j <= x < g_{j+1}``, so ``x`` outside every knot span gets
    all-zero bases (reference ``effkan.py:115-125``).
    """
    xe = x.unsqueeze(-1)  # (N, in, 1)
    bases = ((xe >= grid[:, :-1]) & (xe < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (xe - grid[:, : -(k + 1)]) / (grid[:, k:-1] - grid[:, : -(k + 1)])
        right = (grid[:, k + 1:] - xe) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def bspline_bases_and_grad(x: torch.Tensor, grid: torch.Tensor,
                           spline_order: int = 3):
    """B-spline bases and their x-derivative by the differentiated recurrence.

    Differentiating the Cox–de Boor refinement of :func:`bspline_bases`,
    ``B_k = w1 * B_{k-1}[:-1] + w2 * B_{k-1}[1:]``, gives
    ``B_k' = w1' B_{k-1}[:-1] + w1 B_{k-1}'[:-1] + w2' B_{k-1}[1:] +
    w2 B_{k-1}'[1:]`` with ``w1' = 1/(g[k:-1] - g[:-(k+1)])`` and
    ``w2' = -1/(g[k+1:] - g[1:-k])``; the order-0 derivative is 0 a.e.
    Returns ``(bases, dbases)``, each ``(N, in, grid_size + order)``. The
    plain version the backward kernel's closed-form B' is checked against
    (counterpart of ``kanvit.ops.kan_bases.bspline_bases_and_grad``).
    """
    xe = x.unsqueeze(-1)
    bases = ((xe >= grid[:, :-1]) & (xe < grid[:, 1:])).to(x.dtype)
    dbases = torch.zeros_like(bases)
    for k in range(1, spline_order + 1):
        inv1 = 1.0 / (grid[:, k:-1] - grid[:, : -(k + 1)])
        inv2 = 1.0 / (grid[:, k + 1:] - grid[:, 1:-k])
        w1 = (xe - grid[:, : -(k + 1)]) * inv1
        w2 = (grid[:, k + 1:] - xe) * inv2
        dbases = (inv1 * bases[..., :-1] + w1 * dbases[..., :-1]
                  - inv2 * bases[..., 1:] + w2 * dbases[..., 1:])
        bases = w1 * bases[..., :-1] + w2 * bases[..., 1:]
    return bases, dbases


def bspline_kan_forward(
    x: torch.Tensor,
    grid: torch.Tensor,
    base_weight: torch.Tensor,
    spline_weight: torch.Tensor,
    spline_scaler: torch.Tensor | None,
    spline_order: int = 3,
) -> torch.Tensor:
    """efficient-kan ``KANLinear`` forward (reference ``effkan.py:174-187``).

    ``base_weight (out, in)``, ``spline_weight (out, in, K)``, optional
    ``spline_scaler (out, in)``. Output =
    ``silu(x) @ Wb.T + bases(x).reshape(N, in*K) @ Ws.reshape(out, -1).T``,
    shape-preserving over leading dims.

    A bf16 ``x`` follows the bf16 kernel's policy (kanvit's kernel route,
    ``kanvit/kernels/fused_basis.py:521-531``, not its jnp route, which
    makes the basis in bf16): :func:`bspline_kan_forward_bf16`.
    """
    if x.dtype == torch.bfloat16:
        return bspline_kan_forward_bf16(x, grid, base_weight, spline_weight,
                                        spline_scaler, spline_order)
    lead = x.shape[:-1]
    in_features = x.shape[-1]
    xf = x.reshape(-1, in_features)
    out_features = base_weight.shape[0]

    base = F.silu(xf) @ base_weight.T
    scaled = (spline_weight * spline_scaler.unsqueeze(-1)
              if spline_scaler is not None else spline_weight)
    bases = bspline_bases(xf, grid, spline_order)  # (N, in, K)
    spline = bases.reshape(xf.shape[0], -1) @ scaled.reshape(out_features, -1).T
    return (base + spline).reshape(*lead, out_features)


def bspline_kan_forward_bf16(x, grid, base_weight, spline_weight, spline_scaler,
                             spline_order: int = 3, exact: bool = False) -> torch.Tensor:
    """The bf16 ``KANLinear`` forward as the bf16 kernel computes it: the
    B-spline bases and silu of the upcast x in f32 (the grid f32), each
    rounded to bf16 once; the weights in bf16, ``spline_weight *
    spline_scaler`` formed in bf16; the base branch folded into the one
    contraction (the silu slice), the products exact and summed in f32;
    y rounded to bf16 once. Returns bf16, shape-preserving over leading
    dims. ``exact``: the same rounded operands summed in f64 and returned
    unrounded, the reference a kernel's distance is measured from."""
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = base_weight.shape[0]
    bf16 = torch.bfloat16
    sw = spline_weight.to(bf16)
    scaled = sw * spline_scaler.to(bf16).unsqueeze(-1) if spline_scaler is not None else sw
    w = torch.cat([scaled.permute(2, 1, 0), base_weight.to(bf16).T.unsqueeze(0)], 0)
    y = bspline_grouped_forward_bf16(x.reshape(-1, nin), grid, w.unsqueeze(0),
                                     spline_order, exact)
    return y.reshape(*lead, nout)


def _bspline_levels(x: torch.Tensor, grid: torch.Tensor, order: int) -> torch.Tensor:
    """Cox–de Boor up to ``order`` as kanvit's kernel and the port's run
    it (``kanvit/kernels/fused_basis.py:450-483``): each blend multiplies
    by the reciprocal of its knot difference. ``(N, in, n0 - order)``."""
    xe = x.unsqueeze(-1)
    b = ((xe >= grid[:, :-1]) & ~(xe >= grid[:, 1:])).to(x.dtype)
    for k in range(1, order + 1):
        inv = 1.0 / (grid[:, k:] - grid[:, :-k])
        left = (xe - grid[:, :-(k + 1)]) * inv[:, :-1]
        right = (grid[:, k + 1:] - xe) * inv[:, 1:]
        b = left * b[..., :-1] + right * b[..., 1:]
    return b


def bspline_slices_bf16(xf: torch.Tensor, grid: torch.Tensor, spline_order: int = 3,
                        with_grad: bool = False):
    """The B-spline layer's contracted slices of the f32 ``xf (N, in)`` as
    the bf16 kernels make them, in f32: ``(N, K+1, in)``, the K bases then
    silu(x). ``with_grad``: also their x-derivatives, ``(N, K+1, in)``:
    B' in kanvit's closed form from the order-(k-1) bases, ``k (B_{k-1,j} /
    (g_{j+k} - g_j) - B_{k-1,j+1} / (g_{j+k+1} - g_{j+1}))``, and silu' =
    sig + silu (1 - sig)."""
    grid = grid.float()
    b = _bspline_levels(xf, grid, spline_order)
    sig = torch.sigmoid(xf)
    silu = xf * sig
    a = torch.cat([b.transpose(1, 2), silu.unsqueeze(1)], 1)
    if not with_grad:
        return a
    k = spline_order
    prev = _bspline_levels(xf, grid, k - 1)
    inv = 1.0 / (grid[:, k:] - grid[:, :-k])
    db = k * (prev[..., :-1] * inv[:, :-1] - prev[..., 1:] * inv[:, 1:])
    return a, torch.cat([db.transpose(1, 2), (sig + silu * (1.0 - sig)).unsqueeze(1)], 1)


def _bspline_slices_of(grid, spline_order):
    """``slices(g, xf, with_grad)`` of group ``g``'s B-spline layer
    (:func:`bspline_slices_bf16` on its grid: one shared, or a grid a
    group)."""
    def slices(g, xf, with_grad=False):
        return bspline_slices_bf16(xf, grid[g] if grid.dim() == 3 else grid, spline_order,
                                   with_grad)
    return slices


def grouped_forward_bf16(x2d: torch.Tensor, w: torch.Tensor, slices,
                         exact: bool = False) -> torch.Tensor:
    """The bf16 KAN kernels' forward on the packed weight, for any family:
    ``x2d (N, G*nin)`` and ``w (G, S, nin, out)`` bf16; ``slices(g, xf)``
    gives group ``g``'s ``(N, S, nin)`` contracted slices of its upcast x
    ``xf`` in f32. Per group, the slices rounded to bf16 once, the products
    exact and summed in f32, y rounded to bf16 once: ``(N, G*out)`` bf16.
    ``exact``: the same rounded operands summed in f64 and returned
    unrounded."""
    n = x2d.shape[0]
    groups, _, nin, nout = w.shape
    acc = torch.float64 if exact else torch.float32
    ys = []
    for g in range(groups):
        a = slices(g, x2d[:, g * nin:(g + 1) * nin].float()).to(torch.bfloat16)
        ys.append(a.to(acc).reshape(n, -1) @ w[g].to(acc).reshape(-1, nout))
    y = torch.cat(ys, 1)
    return y if exact else y.to(torch.bfloat16)


def grouped_backward_bf16(x2d, w, gy, slices, need_dx: bool = True, need_dw: bool = True,
                          exact: bool = False):
    """The bf16 KAN kernels' backward (kanvit's ``_bwd_kernel`` on bf16
    operands, ``kanvit/kernels/fused_basis.py:566-625``, and its split tier,
    ``:993-1039``; not ``_jnp_bwd``, which keeps the basis in f32), on
    :func:`grouped_forward_bf16`'s operands and ``gy (N, G*out)`` bf16;
    ``slices(g, xf, with_grad=True)`` also gives the slices' x-derivatives
    in f32. Per group:

    - ``gW = gy W^T``, bf16 operands, the products exact and summed in f32
      (never rounded);
    - ``dx = sum_s gW_s d_s(x)``, the derivatives made in f32 from the
      upcast x, summed in f32 in slice order and rounded to bf16 once;
    - ``dW = bf16(slices)^T gy``, summed in f32 over all the rows and
      rounded to bf16 once.

    Returns ``(dx (N, G*nin) or None, dw (G, S, nin, out) or None)``, bf16;
    ``exact``: the same rounded operands summed in f64, unrounded."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    acc = torch.float64 if exact else torch.float32
    dxs, dws = [], []
    for g in range(groups):
        gyg = gy[:, g * nout:(g + 1) * nout].to(acc)
        a, d = slices(g, x2d[:, g * nin:(g + 1) * nin].float(), with_grad=True)
        if need_dx:
            gw = (gyg @ w[g].to(acc).reshape(-1, nout).T).reshape(n, nslices, nin)
            dx = torch.zeros(n, nin, dtype=acc, device=x2d.device)
            for s in range(nslices):
                dx = dx + gw[:, s] * d[:, s].to(acc)
            dxs.append(dx)
        if need_dw:
            ab = a.to(torch.bfloat16).to(acc).reshape(n, -1)
            dws.append((ab.T @ gyg).reshape(nslices, nin, nout))
    out = (torch.cat(dxs, 1) if need_dx else None,
           torch.stack(dws) if need_dw else None)
    return out if exact else tuple(None if t is None else t.to(torch.bfloat16) for t in out)


def grouped_dw_spread_bf16(x2d, w, gy, slices) -> torch.Tensor:
    """``sum_n |bf16(slice)| |gy|`` in f32, ``(G, S, nin, out)``: what the
    bf16 dW moves by, times 2^8, when every slice value rounds to its
    neighbouring bf16 value (an f32 value one f32 ulp off can). The weight
    of the rounded intermediate in the bf16 dW's gate."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    out = []
    for g in range(groups):
        a = slices(g, x2d[:, g * nin:(g + 1) * nin].float()).to(torch.bfloat16).float().abs()
        out.append((a.reshape(n, -1).T @ gy[:, g * nout:(g + 1) * nout].float().abs())
                   .reshape(nslices, nin, nout))
    return torch.stack(out)


def grouped_fwd_spread_bf16(x2d, w, slices) -> torch.Tensor:
    """``|bf16(slices)| @ |W|`` in f32, ``(N, G*out)``: what the bf16
    forward moves by, times 2^8, when every slice value rounds to its
    neighbouring bf16 value. The weight of the rounded intermediate in the
    bf16 forward's gate."""
    n = x2d.shape[0]
    groups, _, nin, nout = w.shape
    return torch.cat([
        slices(g, x2d[:, g * nin:(g + 1) * nin].float()).to(torch.bfloat16).float().abs()
        .reshape(n, -1) @ w[g].float().abs().reshape(-1, nout) for g in range(groups)], 1)


def bspline_grouped_forward_bf16(x2d: torch.Tensor, grid: torch.Tensor, w: torch.Tensor,
                                 spline_order: int = 3, exact: bool = False) -> torch.Tensor:
    """The bf16 B-spline kernels' forward on the packed weight: ``x2d (N,
    G*nin)`` and ``w (G, K+1, nin, out)`` bf16, ``grid (nin, knots)`` or a
    grid a group ``(G, nin, knots)`` f32; :func:`grouped_forward_bf16` over
    :func:`bspline_slices_bf16`."""
    return grouped_forward_bf16(x2d, w, _bspline_slices_of(grid, spline_order), exact)


def bspline_grouped_backward_bf16(x2d, grid, w, gy, need_dx: bool = True,
                                  need_dw: bool = True, spline_order: int = 3,
                                  exact: bool = False):
    """The bf16 B-spline kernels' backward, :func:`grouped_backward_bf16`
    over :func:`bspline_slices_bf16` (B' in kanvit's closed form)."""
    return grouped_backward_bf16(x2d, w, gy, _bspline_slices_of(grid, spline_order), need_dx,
                                 need_dw, exact)


def bspline_dw_spread_bf16(x2d, grid, w, gy, spline_order: int = 3) -> torch.Tensor:
    """:func:`grouped_dw_spread_bf16` of the B-spline layer."""
    return grouped_dw_spread_bf16(x2d, w, gy, _bspline_slices_of(grid, spline_order))


def bspline_curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                        spline_order: int = 3) -> torch.Tensor:
    """Least-squares spline coefficients through points.

    ``x``: ``(batch, in)``; ``y``: ``(batch, in, out)``. Returns
    ``(out, in, grid_size + order)``: one lstsq per input feature, as
    reference ``effkan.py:134-164``. At init the system is under-determined
    (grid_size + 1 points, grid_size + order coefficients): the SVD driver
    ``gelsd`` returns its minimum-norm solution, as ``jnp.linalg.lstsq``
    does, and unlike the default ``gelsy`` gives the same bits on every run.
    CUDA has only the ``gels`` driver, which refuses such systems, so call
    this on CPU tensors.
    """
    a = bspline_bases(x, grid, spline_order).permute(1, 0, 2)  # (in, batch, K)
    b = y.permute(1, 0, 2)  # (in, batch, out)
    sol = torch.linalg.lstsq(a, b, driver="gelsd").solution  # (in, K, out)
    return sol.permute(2, 0, 1).contiguous()


# --- Fourier (NaiveFourierKAN) ------------------------------------------------

def fourier_bases(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """``cat([cos(k x), sin(k x)], -1)`` for ``k = 1..grid_size``, each
    argument ``k x`` rounded to f32 first, as kanvit computes it. Returns
    ``(..., in, 2*grid_size)``."""
    k = torch.arange(1, grid_size + 1, dtype=x.dtype, device=x.device)
    kx = x.unsqueeze(-1) * k
    return torch.cat([torch.cos(kx), torch.sin(kx)], dim=-1)


def fourier_bases_and_grad(x: torch.Tensor, grid_size: int):
    """Fourier bases and their x-derivative, ``d cos(kx) = -k sin(kx)`` and
    ``d sin(kx) = k cos(kx)``, in :func:`fourier_bases`' layout."""
    k = torch.arange(1, grid_size + 1, dtype=x.dtype, device=x.device)
    kx = x.unsqueeze(-1) * k
    c, s = torch.cos(kx), torch.sin(kx)
    return torch.cat([c, s], dim=-1), torch.cat([-k * s, k * c], dim=-1)


def fourierkan_forward(x: torch.Tensor, coeffs: torch.Tensor,
                       bias: torch.Tensor | None) -> torch.Tensor:
    """NaiveFourierKAN forward (reference ``nfkan.py:36-52``).

    ``coeffs (2, out, in, grid)``: ``coeffs[0]`` weights the cos terms,
    ``coeffs[1]`` the sin terms; ``bias`` ``(out,)`` or the reference's
    ``(1, out)``, or None. Shape-preserving over leading dims.

    A bf16 ``x`` follows the bf16 kernel's policy (kanvit's kernel route,
    not its jnp route, which makes the basis in bf16):
    :func:`fourier_grouped_forward_bf16`, the bias added after in bf16.
    """
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, _, grid_size = coeffs.shape
    if x.dtype == torch.bfloat16:
        w = coeffs.to(torch.bfloat16).permute(0, 3, 2, 1).reshape(1, 2 * grid_size, nin, nout)
        y = fourier_grouped_forward_bf16(x.reshape(-1, nin), w)
        if bias is not None:
            y = y + bias.to(torch.bfloat16).reshape(nout)
        return y.reshape(*lead, nout)
    basis = fourier_bases(x.reshape(-1, nin), grid_size)  # (N, in, 2G)
    w = torch.cat([coeffs[0], coeffs[1]], dim=-1)         # (out, in, 2G)
    y = basis.reshape(basis.shape[0], -1) @ w.reshape(nout, -1).T
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


# Harmonics a chunk of the bf16 Fourier kernels (cos k, sin k, cos k+1, sin
# k+1: their 4-slice tile); the dW kernel seeds each chunk afresh.
FOURIER_BF16_HARMONICS = 2


def _rotate(ch, sh, c1, s1):
    """One harmonic up by angle addition, each product and sum rounded as
    kanvit's ``ch * c1 - sh * s1, sh * c1 + ch * s1`` reads
    (``kanvit/kernels/fused_basis.py:1890``), no product fused into a sum."""
    return ch * c1 - sh * s1, sh * c1 + ch * s1


def fourier_slices_bf16(xf: torch.Tensor, grid_size: int, seed_chunks: bool = False):
    """The Fourier layer's contracted slices of the f32 ``xf (N, in)`` as the
    bf16 kernels make them, in f32: ``(N, 2G, in)``, cos(kx) for k = 1..G
    then sin(kx) (the packed weight's order), by the angle-addition
    recurrence of kanvit's K-blocked kernels (``_fwd_kernel_kbf``,
    ``_dx_kernel_kbf``, ``_dw_kernel_kbf``) from cos(x), sin(x):

    - ``seed_chunks`` False (the forward and dx): seeded once, at harmonic 1
      (cos(x), sin(x)), and carried through every harmonic, as kanvit's
      forward and dx carry it;
    - ``seed_chunks`` True (dW): seeded afresh at each chunk's first
      harmonic k = 1, 3, 5, .. by cos and sin of the f32 product k x, then
      one step on, as kanvit's dW seeds each slab's first harmonic.

    kanvit's plain tier evaluates cos and sin of k x directly instead; the
    two differ by up to ~k (1 + |x|) 2^-23."""
    c1, s1 = torch.cos(xf), torch.sin(xf)
    ch, sh = c1, s1
    cos, sin = [], []
    for k in range(1, grid_size + 1):
        if seed_chunks and (k - 1) % FOURIER_BF16_HARMONICS == 0:
            ch, sh = torch.cos(xf * float(k)), torch.sin(xf * float(k))
        cos.append(ch)
        sin.append(sh)
        ch, sh = _rotate(ch, sh, c1, s1)
    return torch.stack(cos + sin, 1)


def _fourier_slices_of(w, seed_chunks: bool = False):
    grid_size = w.shape[1] // 2
    return lambda g, xf: fourier_slices_bf16(xf, grid_size, seed_chunks)


def fourier_grouped_forward_bf16(x2d: torch.Tensor, w: torch.Tensor,
                                 exact: bool = False) -> torch.Tensor:
    """The bf16 Fourier kernel's forward on the packed weight ``w (1, 2G,
    nin, out)`` bf16 (cos harmonics first) and ``x2d (N, nin)`` bf16:
    cos/sin(kx) of the upcast x by the recurrence seeded once
    (:func:`fourier_slices_bf16`) in f32, rounded to bf16 once, the products
    exact and summed in f32 in one running sum, y rounded to bf16 once, no
    bias (kanvit's ``_fwd_kernel_kbf`` on bf16 operands):
    :func:`grouped_forward_bf16`."""
    return grouped_forward_bf16(x2d, w, _fourier_slices_of(w), exact)


def fourier_grouped_backward_bf16(x2d, w, gy, need_dx: bool = True, need_dw: bool = True,
                                  exact: bool = False):
    """The bf16 Fourier kernels' backward (kanvit's ``_dx_kernel_kbf`` and
    ``_dw_kernel_kbf`` on bf16 operands) on
    :func:`fourier_grouped_forward_bf16`'s operands and ``gy (N, out)``
    bf16:

    - ``gW = gy W^T``, bf16 operands, the products exact and summed in f32
      (never rounded);
    - ``dx``: for each harmonic k = 1..G in turn, ``k (gW_sin,k c_k -
      gW_cos,k s_k)`` added in f32, each product and sum rounded as kanvit's
      ``acc += m * (gw_sin * ch - gw_cos * sh)`` reads (:1917-1924), with
      c_k, s_k the recurrence seeded once; rounded to bf16 once;
    - ``dW = bf16(B)^T gy`` summed in f32 over all the rows and rounded once,
      B the recurrence seeded at each chunk of 2 harmonics.

    Returns ``(dx (N, nin) or None, dw (1, 2G, nin, out) or None)``, bf16;
    ``exact``: the same f32 basis values and rounded operands summed in f64,
    unrounded."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    grid_size = nslices // 2
    acc = torch.float64 if exact else torch.float32
    dxs, dws = [], []
    for g in range(groups):
        xf = x2d[:, g * nin:(g + 1) * nin].float()
        gyg = gy[:, g * nout:(g + 1) * nout].to(acc)
        if need_dx:
            gw = (gyg @ w[g].to(acc).reshape(-1, nout).T).reshape(n, nslices, nin)
            b = fourier_slices_bf16(xf, grid_size).to(acc)
            dx = torch.zeros(n, nin, dtype=acc, device=x2d.device)
            for k in range(1, grid_size + 1):
                c, s = b[:, k - 1], b[:, grid_size + k - 1]
                dx = dx + (gw[:, grid_size + k - 1] * c - gw[:, k - 1] * s) * float(k)
            dxs.append(dx)
        if need_dw:
            ab = fourier_slices_bf16(xf, grid_size, True).to(torch.bfloat16).to(acc)
            dws.append((ab.reshape(n, -1).T @ gyg).reshape(nslices, nin, nout))
    out = (torch.cat(dxs, 1) if need_dx else None,
           torch.stack(dws) if need_dw else None)
    return out if exact else tuple(None if t is None else t.to(torch.bfloat16) for t in out)


def fourier_fwd_spread_bf16(x2d, w) -> torch.Tensor:
    """:func:`grouped_fwd_spread_bf16` of the Fourier layer, |B| @ |W|."""
    return grouped_fwd_spread_bf16(x2d, w, _fourier_slices_of(w))


def fourier_dw_spread_bf16(x2d, w, gy) -> torch.Tensor:
    """:func:`grouped_dw_spread_bf16` of the Fourier layer, |B|^T |gy|
    (B seeded a chunk, as dW makes it)."""
    return grouped_dw_spread_bf16(x2d, w, gy, _fourier_slices_of(w, True))


# --- Chebyshev (ChebyKAN) -----------------------------------------------------

def cheby_bases(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Chebyshev polynomials ``T_0..T_degree`` of ``t = tanh(x)``.

    The three-term recurrence ``T_n = 2 t T_{n-1} - T_{n-2}``, which is what
    the kernel computes (kanvit's ``cheby_family``), not the reference's
    ``cos(n acos t)``: the values agree to f32 rounding, and autograd through
    the recurrence stays finite where ``tanh(x)`` rounds to +-1 (``|x| >~
    9.01``: ``dt/dx = 1 - t^2 = 0`` there), while autograd through ``acos``
    gives ``-inf * 0 = NaN``. Returns ``(..., in, degree+1)``.
    """
    t = torch.tanh(x)
    ts = [torch.ones_like(t), t]
    for _ in range(2, degree + 1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return torch.stack(ts[: degree + 1], dim=-1)


def cheby_bases_and_grad(x: torch.Tensor, degree: int):
    """Chebyshev bases of ``t = tanh(x)`` and their x-derivative by the
    differentiated recurrence ``T'_n = 2 T_{n-1} + 2 t T'_{n-1} - T'_{n-2}``
    times ``dt/dx = 1 - t^2``; finite (0) where ``t`` rounds to +-1. The
    plain version the backward kernel's derivative is checked against."""
    t = torch.tanh(x)
    ts, dts = [torch.ones_like(t), t], [torch.zeros_like(t), torch.ones_like(t)]
    for n in range(2, degree + 1):
        ts.append(2.0 * t * ts[n - 1] - ts[n - 2])
        dts.append(2.0 * ts[n - 1] + 2.0 * t * dts[n - 1] - dts[n - 2])
    dtdx = (1.0 - t * t).unsqueeze(-1)
    return (torch.stack(ts[: degree + 1], dim=-1),
            torch.stack(dts[: degree + 1], dim=-1) * dtdx)


def chebykan_forward(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """ChebyKAN forward (reference ``cheby.py:36-48``), ``coeffs (in, out,
    degree+1)``. Shape-preserving over leading dims: the reference collapses
    them and crashes the ViT, kanvit repairs that (SURVEY §2.9.1).

    A bf16 ``x`` follows the bf16 kernel's policy (kanvit's kernel route,
    not its jnp route, which makes the basis in bf16):
    :func:`cheby_grouped_forward_bf16`."""
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, deg1 = coeffs.shape
    if x.dtype == torch.bfloat16:
        w = coeffs.to(torch.bfloat16).permute(2, 0, 1).unsqueeze(0).contiguous()
        return cheby_grouped_forward_bf16(x.reshape(-1, nin), w).reshape(*lead, nout)
    basis = cheby_bases(x.reshape(-1, nin), deg1 - 1)  # (N, in, deg+1)
    y = basis.reshape(basis.shape[0], -1) @ coeffs.transpose(0, 1).reshape(nout, -1).T
    return y.reshape(*lead, nout)


def cheby_slices_bf16(xf: torch.Tensor, degree: int = 4, with_grad: bool = False):
    """The Chebyshev layer's contracted slices of the f32 ``xf (N, in)`` as
    the bf16 kernels make them, in f32 (every group the same family):
    ``(N, degree+1, in)``, T_n(tanh x) by the recurrence. ``with_grad``:
    also their x-derivatives, the differentiated recurrence times 1 - t^2
    (:func:`cheby_bases_and_grad`, kanvit's ``cheby_family``)."""
    if not with_grad:
        return cheby_bases(xf, degree).transpose(1, 2)
    b, d = cheby_bases_and_grad(xf, degree)
    return b.transpose(1, 2), d.transpose(1, 2)


def _cheby_slices_of(w):
    degree = w.shape[1] - 1
    return lambda g, xf, with_grad=False: cheby_slices_bf16(xf, degree, with_grad)


def cheby_grouped_forward_bf16(x2d: torch.Tensor, w: torch.Tensor,
                               exact: bool = False) -> torch.Tensor:
    """The bf16 Chebyshev kernels' forward on the packed weight ``w (G,
    degree+1, nin, out)`` bf16 (``chebykan``: one group; ``cheby_qkv_grouped``:
    a group a head) and ``x2d (N, G*nin)`` bf16: T_n(tanh x) of the upcast x
    made in f32 and rounded to bf16 once, the products exact and summed in
    f32 in one running sum, y rounded to bf16 once (kanvit's ``_fwd_kernel``
    on bf16 operands, :func:`grouped_forward_bf16`)."""
    return grouped_forward_bf16(x2d, w, _cheby_slices_of(w), exact)


def cheby_grouped_backward_bf16(x2d, w, gy, need_dx: bool = True, need_dw: bool = True,
                                exact: bool = False):
    """The bf16 Chebyshev kernels' backward (kanvit's ``_bwd_kernel`` on
    bf16 operands), :func:`grouped_backward_bf16` over
    :func:`cheby_slices_bf16`: gW = gy W^T in f32, never rounded; dx = sum_n
    gW_n T'_n (1 - t^2) in f32, rounded once; dW = bf16(T)^T gy over all the
    rows in f32, rounded once."""
    return grouped_backward_bf16(x2d, w, gy, _cheby_slices_of(w), need_dx, need_dw, exact)


def cheby_dw_spread_bf16(x2d, w, gy) -> torch.Tensor:
    """:func:`grouped_dw_spread_bf16` of the Chebyshev layer, |T|^T |gy|."""
    return grouped_dw_spread_bf16(x2d, w, gy, _cheby_slices_of(w))


def cheby_fwd_spread_bf16(x2d, w) -> torch.Tensor:
    """:func:`grouped_fwd_spread_bf16` of the Chebyshev layer, |T| @ |W|."""
    return grouped_fwd_spread_bf16(x2d, w, _cheby_slices_of(w))


# --- Gaussian RBF (FastKAN) ---------------------------------------------------

def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, biased variance (kanvit's
    ``kan_bases.layernorm``, the reference's ``nn.LayerNorm`` default)."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def ffn_pre_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    """Pre-LN transformer feed-forward (reference ``model.py:14-37``):
    ``x + relu(LN(x) @ w1.T + b1) @ w2.T + b2`` with torch-layout weights
    ``w1 (F, D)``, ``w2 (D, F)`` and LayerNorm eps 1e-5. kanvit's
    ``kan_bases.ffn_pre_ln``, the plain version of
    ``kanvit_torch.kernels.fused_ffn``."""
    h = torch.relu(layernorm(x, gamma, beta) @ w1.T + b1)
    return x + (h @ w2.T + b2)


# kanvit's row block of the fused FF on bf16 dots (``_bn``,
# ``kanvit/kernels/fused_ffn.py:146-152``): its backward sums the parameter
# gradients over blocks of this many rows, in f32, in block order.
FFN_BLOCK_BF16 = 512


def _ln_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """kanvit's ``_ln_stats`` on the upcast rows: ``(xhat, ln, rstd)`` in f32."""
    xr = x.float()
    xc = xr - xr.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    return xhat, xhat * gamma.float() + beta.float(), rstd


def ffn_pre_ln_bf16(x2d, gamma, beta, w1, b1, w2, b2, exact: bool = False,
                    pattern: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 fused FF's forward (kanvit's ``_ffn_fwd_kernel`` on bf16
    operands, ``kanvit/kernels/fused_ffn.py:62-77``), all seven tensors
    bf16: LN statistics and LN in f32 from the upcast x, LN rounded to bf16
    at the first dot; h = bf16(LN) W1^T, the products exact and summed in
    f32, + b1 in f32; relu(h) rounded to bf16 at the second dot; y = (r W2^T
    + b2) + x in f32, rounded to bf16 once: ``(N, D)`` bf16. ``exact``: the
    same rounded operands (bf16 LN and r) through the second product in
    f64, y unrounded. ``pattern`` (N, F) bool, if given, replaces h > 0
    (a check holds a model's gradients on the card's ReLU pattern)."""
    _, ln, _ = _ln_f32(x2d, gamma, beta)
    h = ln.to(torch.bfloat16).float() @ w1.float().T + b1.float()
    r = (torch.relu(h) if pattern is None else torch.where(pattern, h, 0.0)).to(torch.bfloat16)
    acc = torch.float64 if exact else torch.float32
    y = (r.to(acc) @ w2.to(acc).T + b2.to(acc)) + x2d.to(acc)
    return y if exact else y.to(torch.bfloat16)


def ffn_pre_ln_bwd_bf16(x2d, gamma, beta, w1, b1, w2, g, block: int = FFN_BLOCK_BF16,
                        pattern: torch.Tensor | None = None, exact: bool = False):
    """The bf16 fused FF's backward (kanvit's ``_ffn_bwd_kernel`` on bf16
    operands, ``kanvit/kernels/fused_ffn.py:80-143``) on
    :func:`ffn_pre_ln_bf16`'s operands and ``g (N, D)`` bf16, a block of
    ``block`` rows at a time (kanvit's ``_bn``): LN and h recomputed as the
    forward makes them; dW2 = g^T bf16(r), dr = g W2, dh = dr [h > 0],
    dW1 = bf16(dh)^T bf16(LN), dln = bf16(dh) W1, all with the products exact
    and summed in f32; db1 sums the unrounded dh, db2 g, dgamma dln xhat,
    dbeta dln; dx = g + rstd (gs - mean(gs) - xhat mean(gs xhat)), gs = dln
    gamma, in f32, rounded once. The parameter gradients sum over the blocks
    in f32 in block order and are rounded once. ``pattern`` (N, F) bool, if
    given, replaces h > 0 (a check holds the card's kernels on their own ReLU
    pattern). ``exact``: the same rounded operands (bf16 LN, r, dh) through
    every product and the LayerNorm's VJP in f64 over all the rows at once,
    unrounded. Returns ``(dx, dgamma, dbeta, dw1, db1, dw2, db2)``."""
    n, d = x2d.shape
    f = w1.shape[0]
    acc = torch.float64 if exact else torch.float32
    on = dict(dtype=acc, device=x2d.device)
    w1a, w2a = w1.to(acc), w2.to(acc)
    dw1, dw2 = torch.zeros(f, d, **on), torch.zeros(d, f, **on)
    db1, db2, dgam, dbet = (torch.zeros(k, **on) for k in (f, d, d, d))
    dx = torch.empty(n, d, dtype=acc if exact else torch.bfloat16, device=x2d.device)
    for r0 in range(0, n, n if exact else block):
        rows = slice(r0, r0 + (n if exact else block))
        xhat, ln, rstd = _ln_f32(x2d[rows], gamma, beta)
        lnd = ln.to(torch.bfloat16).float()
        h = lnd @ w1.float().T + b1.float()
        pos = h > 0 if pattern is None else pattern[rows]
        r = torch.where(pos, h, 0.0).to(torch.bfloat16)
        gb = g[rows].to(acc)
        dh = torch.where(pos, gb @ w2a, 0.0)
        dhd = (dh if not exact else torch.where(pos, g[rows].float() @ w2.float(), 0.0)
               ).to(torch.bfloat16).to(acc)
        if exact:
            xr = x2d[rows].double()
            xc = xr - xr.mean(-1, keepdim=True)
            rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5)
            xhat = xc * rstd
        dw2 += gb.T @ r.to(acc)
        dw1 += dhd.T @ lnd.to(acc)
        dlnp = dhd @ w1a
        db1 += dh.sum(0)
        db2 += gb.sum(0)
        dgam += (dlnp * xhat).sum(0)
        dbet += dlnp.sum(0)
        gs = dlnp * gamma.to(acc)
        m1 = gs.mean(1, keepdim=True)
        m2 = (gs * xhat).mean(1, keepdim=True)
        dx[rows] = gb + rstd * (gs - m1 - xhat * m2)
    out = (dx, dgam, dbet, dw1, db1, dw2, db2)
    return out if exact else tuple(t.to(torch.bfloat16) for t in out)


def ffn_spread_bf16(x2d, gamma, beta, w1, b1, w2, g=None, pattern=None):
    """How one bf16 ulp (2^-8 relative) of each rounded intermediate moves
    the bf16 fused FF's results, for their gates: ``|a| |b|`` in place of
    each product on the twin's operands. Forward: y by r's ulp through
    |r| |W2|^T and by LN's through h, (|LN| |W1|^T) |W2|^T. With ``g``, the
    backward's seven (dx, dgamma, dbeta, dW1, db1, dW2, db2), on
    ``pattern`` (N, F) bool in place of h > 0 if given: dln by dh's ulp,
    S = |dh| |W1|, into dx through the LayerNorm's VJP (rstd (|gamma| S +
    mean |gamma| S + |xhat| mean |gamma| S |xhat|)), dgamma (sum S |xhat|)
    and dbeta (sum S); dW1 by dh's and LN's, 2 |dh|^T |LN|; dW2 by r's and
    LN's (through h), |g|^T (|r| + |LN| |W1|^T). The sums over the rows
    are taken in other blocks than the twin's, so each also gets 2 N 2^-24
    of its sum of |terms|, as a share of 2^-8: db1 of |dh|, db2 of |g|, the
    others in proportion. f32."""
    xhat, ln, rstd = _ln_f32(x2d, gamma, beta)
    lnd = ln.to(torch.bfloat16).float().abs()
    w1a, w2a = w1.float().abs(), w2.float().abs()
    h = ln.to(torch.bfloat16).float() @ w1.float().T + b1.float()
    r = torch.relu(h).to(torch.bfloat16).float()
    via_h = lnd @ w1a.T
    if g is None:
        return (r + via_h) @ w2a.T
    gf = g.float()
    dhf = torch.where(h > 0 if pattern is None else pattern, gf @ w2.float(), 0.0).abs()
    dh = dhf.to(torch.bfloat16).float()
    s = dh @ w1a
    gs = gamma.float().abs() * s
    dx = rstd * (gs + gs.mean(1, keepdim=True)
                 + xhat.abs() * (gs * xhat.abs()).mean(1, keepdim=True))
    order = 2.0 * x2d.shape[0] * 2.0 ** -24 / 2.0 ** -8
    grow = 1.0 + order
    return (dx, grow * (s * xhat.abs()).sum(0), grow * s.sum(0), grow * 2 * dh.T @ lnd,
            order * dhf.sum(0), grow * gf.abs().T @ (r + via_h), order * gf.abs().sum(0))


def rbf_bases(x: torch.Tensor, grid: torch.Tensor,
              denominator: float) -> torch.Tensor:
    """``exp(-((x[..., None] - grid) / denominator)**2)`` (reference
    ``fastkan.py:29-30``); ``grid (num_grids,)``."""
    return torch.exp(-((x.unsqueeze(-1) - grid) / denominator) ** 2)


def rbf_bases_and_grad(x: torch.Tensor, grid: torch.Tensor, denominator: float):
    """RBF bases and their x-derivative ``-2u/denominator * exp(-u^2)``."""
    u = (x.unsqueeze(-1) - grid) / denominator
    b = torch.exp(-u * u)
    return b, (-2.0 / denominator) * u * b


def fastkan_forward(x, ln_gamma, ln_beta, rbf_grid, rbf_denominator,
                    spline_weight, base_weight, base_bias) -> torch.Tensor:
    """FastKAN layer forward (reference ``fastkan.py:66-76``): LayerNorm
    inside the layer, RBF expansion, ``spline_weight (out, in*num_grids)``;
    plus ``silu(x) @ base_weight.T + base_bias`` of the RAW x when the base
    branch exists. ``ln_gamma=None`` skips the LayerNorm (the reference's
    ``time_benchmark`` flag). Shape-preserving over leading dims.

    A bf16 ``x`` follows the bf16 kernel's policy (kanvit's kernel route,
    ``_rbf_ln_fwd_kernel``, not its jnp route, which runs the LayerNorm, the
    bases and the matmul in bf16): :func:`fastkan_grouped_forward_bf16`, the
    bias added after in bf16."""
    lead, nin = x.shape[:-1], x.shape[-1]
    if x.dtype == torch.bfloat16:
        bf16 = torch.bfloat16
        nout = spline_weight.shape[0]
        w = spline_weight.to(bf16).reshape(nout, nin, -1).permute(2, 1, 0)
        if base_weight is not None:
            w = torch.cat([w, base_weight.to(bf16).T.unsqueeze(0)], 0)
        gamma, beta = ((None, None) if ln_gamma is None
                       else (ln_gamma.reshape(1, nin), ln_beta.reshape(1, nin)))
        y = fastkan_grouped_forward_bf16(x.reshape(-1, nin), w.unsqueeze(0), gamma, beta,
                                         rbf_grid, rbf_denominator)
        if base_weight is not None:
            y = y + base_bias.to(bf16)
        return y.reshape(*lead, nout)
    xf = x.reshape(-1, nin)
    ln = xf if ln_gamma is None else layernorm(xf, ln_gamma, ln_beta)
    basis = rbf_bases(ln, rbf_grid, rbf_denominator)  # (N, in, G)
    y = basis.reshape(xf.shape[0], -1) @ spline_weight.T
    if base_weight is not None:
        y = y + F.silu(xf) @ base_weight.T + base_bias
    return y.reshape(*lead, spline_weight.shape[0])


def seg_layernorm_f32(xf: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """kanvit's in-kernel segment LayerNorm (``_seg_ln_into``) of the f32
    ``xf (N, nin)`` with the upcast ``gamma``, ``beta (nin,)``: the mean,
    the biased variance about it, ``rsqrt(v + 1e-5)``; returns ``(ln, xh,
    rstd)``, ``ln = xh gamma + beta``, ``xh = (x - mean) rstd``."""
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5)
    xh = xc * rstd
    return xh * gamma.float() + beta.float(), xh, rstd


def _rbf_u(ln: torch.Tensor, grid: torch.Tensor, denominator: float) -> torch.Tensor:
    """``(N, G, nin)``: ``u_k = (ln - c_k) / h`` as the kernels form it, the
    difference times 1/h in f32."""
    return (ln.unsqueeze(1) - grid.float().reshape(1, -1, 1)) * (1.0 / denominator)


def _rbf_slices_of(gamma, beta, grid, denominator, base: bool):
    """``slices(g, xf)`` of group ``g``'s FastKAN layer as the bf16 kernels
    make them, in f32 (kanvit's ``_rbf_ln_fwd_kernel`` on bf16 operands):
    ``(N, 8 [+1], nin)``, exp(-u_k^2) of the group's LayerNorm of the upcast
    x (``gamma`` None: of x itself), then silu(x) = x sigmoid(x) of the raw
    x where the layer has its base branch."""
    def slices(g, xf):
        ln = xf if gamma is None else seg_layernorm_f32(xf, gamma[g], beta[g])[0]
        u = _rbf_u(ln, grid, denominator)
        b = torch.exp(-u * u)
        return torch.cat([b, (xf * torch.sigmoid(xf)).unsqueeze(1)], 1) if base else b
    return slices


def fastkan_grouped_forward_bf16(x2d, w, gamma, beta, grid, denominator,
                                 exact: bool = False) -> torch.Tensor:
    """The bf16 FastKAN kernels' forward on the packed weight ``w (G, 8
    [+1], nin, out)`` bf16 (``fastkan``: one group; ``fastkan_qkv_grouped``:
    a group a head) and ``x2d (N, G*nin)`` bf16; ``gamma``, ``beta (G,
    nin)`` (upcast to f32) or None; ``grid`` the 8 centres, f32. The
    LayerNorm in f32, the RBF bases of it and silu of the raw x made in f32
    and rounded to bf16 once, the products exact and summed in f32 in one
    running sum, y rounded to bf16 once, no bias (kanvit adds it outside):
    :func:`grouped_forward_bf16`."""
    return grouped_forward_bf16(x2d, w, _rbf_slices_of(gamma, beta, grid, denominator,
                                                       w.shape[1] > grid.numel()), exact)


def fastkan_grouped_backward_bf16(x2d, w, gamma, beta, grid, denominator, gy,
                                  need_dx: bool = True, need_dw: bool = True,
                                  exact: bool = False):
    """The bf16 FastKAN kernels' backward (kanvit's ``_rbf_ln_bwd_kernel``
    and ``_rbf_ln_bwd_kernel_sg`` on bf16 operands) on
    :func:`fastkan_grouped_forward_bf16`'s operands and ``gy (N, G*out)``
    bf16. Per group:

    - ``gW = gy W^T``, bf16 operands, the products exact and summed in f32
      (never rounded);
    - ``dln = sum_k gW_k (-2 u_k / h) b_k`` in f32 in slice order (never
      rounded);
    - ``dx = rstd (gs - mean(gs) - xh mean(gs xh)) + gW_silu silu'(x)``,
      ``gs = dln gamma``, in f32 and rounded to bf16 once (no LayerNorm:
      ``dln`` + the silu term);
    - ``dW = bf16(slices)^T gy`` summed in f32 over all the rows, rounded
      once; dgamma and dbeta, the f32 column sums of ``dln xh`` and ``dln``
      over all the rows, each rounded once.

    Returns ``(dx (N, G*nin) or None, dw or None, dgamma (G, nin) or None,
    dbeta or None)``, bf16; dgamma and dbeta whenever the layer has its
    LayerNorm. ``exact``: the same f32 basis values and rounded operands
    summed in f64, unrounded."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    base = nslices > grid.numel()
    acc = torch.float64 if exact else torch.float32
    slices = _rbf_slices_of(gamma, beta, grid, denominator, base)
    dxs, dws, dgs, dbs = [], [], [], []
    for g in range(groups):
        xf = x2d[:, g * nin:(g + 1) * nin].float()
        gyg = gy[:, g * nout:(g + 1) * nout].to(acc)
        if need_dx or gamma is not None:
            if gamma is None:
                ln = xf
            else:
                ln, xh, rstd = seg_layernorm_f32(xf, gamma[g], beta[g])
                xh, rstd = xh.to(acc), rstd.to(acc)
            u = _rbf_u(ln, grid, denominator)
            coef = (-2.0 / denominator) * u * torch.exp(-u * u)
            gw = (gyg @ w[g].to(acc).reshape(-1, nout).T).reshape(n, nslices, nin)
            dln = torch.zeros(n, nin, dtype=acc, device=x2d.device)
            for k in range(coef.shape[1]):
                dln = dln + gw[:, k] * coef[:, k].to(acc)
            if gamma is not None:
                dgs.append((dln * xh).sum(0))
                dbs.append(dln.sum(0))
            if need_dx:
                if gamma is None:
                    dx = dln
                else:
                    gs = dln * gamma[g].to(acc)
                    dx = rstd * (gs - gs.mean(-1, keepdim=True)
                                 - xh * (gs * xh).mean(-1, keepdim=True))
                if base:
                    sig = torch.sigmoid(xf)
                    dx = dx + gw[:, -1] * (sig + xf * sig * (1.0 - sig)).to(acc)
                dxs.append(dx)
        if need_dw:
            ab = slices(g, xf).to(torch.bfloat16).to(acc).reshape(n, -1)
            dws.append((ab.T @ gyg).reshape(nslices, nin, nout))
    out = (torch.cat(dxs, 1) if need_dx else None,
           torch.stack(dws) if need_dw else None,
           *((None, None) if gamma is None else (torch.stack(dgs), torch.stack(dbs))))
    return out if exact else tuple(None if t is None else t.to(torch.bfloat16) for t in out)


def fastkan_fwd_spread_bf16(x2d, w, gamma, beta, grid, denominator) -> torch.Tensor:
    """:func:`grouped_fwd_spread_bf16` of the FastKAN layer, |B| @ |W|."""
    return grouped_fwd_spread_bf16(x2d, w, _rbf_slices_of(gamma, beta, grid, denominator,
                                                          w.shape[1] > grid.numel()))


def fastkan_dw_spread_bf16(x2d, w, gamma, beta, grid, denominator, gy) -> torch.Tensor:
    """:func:`grouped_dw_spread_bf16` of the FastKAN layer, |B|^T |gy|."""
    return grouped_dw_spread_bf16(x2d, w, gy, _rbf_slices_of(gamma, beta, grid, denominator,
                                                             w.shape[1] > grid.numel()))


# --- Sine (SineKAN) -----------------------------------------------------------

def sine_bases(x: torch.Tensor, freq: torch.Tensor,
               phase: torch.Tensor) -> torch.Tensor:
    """``sin(x[..., None] * freq + phase)`` (reference ``sinekan.py:85-86``);
    ``freq`` with ``grid`` entries (any shape, broadcast over inputs),
    ``phase (in, grid)``. Returns ``(..., in, grid)``."""
    return torch.sin(x.unsqueeze(-1) * freq.reshape(-1) + phase)


def sine_bases_and_grad(x: torch.Tensor, freq: torch.Tensor, phase: torch.Tensor):
    """Sine bases and their derivatives with respect to x, ``freq cos(arg)``,
    and to each slice's freq, ``x cos(arg)``."""
    f = freq.reshape(-1)
    arg = x.unsqueeze(-1) * f + phase
    c = torch.cos(arg)
    return torch.sin(arg), f * c, x.unsqueeze(-1) * c


def sinekan_forward(x, freq, phase, amplitudes, bias) -> torch.Tensor:
    """SineKAN forward (reference ``sinekan.py:81-91``): ``amplitudes (out,
    in, grid)``, ``bias`` ``(out,)``, ``(1, out)`` or None; the reference's
    einsum as one flattened matmul. Shape-preserving over leading dims.

    A bf16 ``x`` follows the bf16 kernel's policy (kanvit's kernel route,
    not its jnp route, which makes the basis in bf16):
    :func:`sine_grouped_forward_bf16`, the bias added after in bf16."""
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = amplitudes.shape[0]
    if x.dtype == torch.bfloat16:
        w = amplitudes.to(torch.bfloat16).permute(2, 1, 0).unsqueeze(0)
        y = sine_grouped_forward_bf16(x.reshape(-1, nin), w, freq.reshape(1, -1), phase)
        if bias is not None:
            y = y + bias.to(torch.bfloat16).reshape(nout)
        return y.reshape(*lead, nout)
    s = sine_bases(x.reshape(-1, nin), freq, phase)  # (N, in, grid)
    y = s.reshape(s.shape[0], -1) @ amplitudes.reshape(nout, -1).T
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


def sine_slices_bf16(xf: torch.Tensor, freq: torch.Tensor, phase: torch.Tensor,
                     with_grad: bool = False):
    """The SineKAN layer's contracted slices of the f32 ``xf (N, in)`` as the
    bf16 kernels make them, in f32: ``(N, S, in)``, sin(a) with the argument
    ``a = x freq_s + phase[i, s]`` formed in f32, the product and the sum
    each rounded (kanvit's ``x * freq + phase``); ``freq (S,)`` upcast,
    ``phase (in, S)`` f32. ``with_grad``: also ``(freq_s cos a, x cos a)``,
    the slices' derivatives in x and in freq_s."""
    a = xf.unsqueeze(1) * freq.float().reshape(1, -1, 1) + phase.float().T.unsqueeze(0)
    if not with_grad:
        return torch.sin(a)
    c = torch.cos(a)
    return torch.sin(a), freq.float().reshape(1, -1, 1) * c, xf.unsqueeze(1) * c


def _sine_slices_of(freq2d, phase):
    """``slices(g, xf)`` of group ``g``'s SineKAN layer (its row of ``freq2d
    (G, S)``, the shared phase table)."""
    return lambda g, xf: sine_slices_bf16(xf, freq2d[g], phase)


def sine_grouped_forward_bf16(x2d, w, freq2d, phase, exact: bool = False) -> torch.Tensor:
    """The bf16 SineKAN kernels' forward on the packed weight ``w (G, S,
    nin, out)`` bf16 (``sinekan``: one group; ``sinekan_qkv_grouped``: a
    group a head), ``x2d (N, G*nin)`` and ``freq2d (G, S)`` bf16, ``phase
    (nin, S)`` f32: sin(x freq + phase) of the upcast x made in f32 and
    rounded to bf16 once, the products exact and summed in f32 in one
    running sum, y rounded to bf16 once, no bias (kanvit's
    ``_fwd_kernel_sine_sg``, ``_fwd_kernel_kb`` and ``_fwd_kernel`` under
    the sine family on bf16 operands): :func:`grouped_forward_bf16`."""
    return grouped_forward_bf16(x2d, w, _sine_slices_of(freq2d, phase), exact)


def sine_grouped_backward_bf16(x2d, w, freq2d, phase, gy, need_dx: bool = True,
                               need_dw: bool = True, exact: bool = False):
    """The bf16 SineKAN kernels' backward (kanvit's ``_bwd_kernel_sine_sg``,
    ``_bwd_kernel_sine``, ``_dx_kernel_kb`` and ``_dw_kernel_kb_sine`` on
    bf16 operands) on :func:`sine_grouped_forward_bf16`'s operands and ``gy
    (N, G*out)`` bf16. Per group:

    - ``gW = gy W^T``, bf16 operands, the products exact and summed in f32
      (never rounded);
    - ``dx = sum_s gW_s (freq_s cos a_s)`` in f32 in slice order, rounded to
      bf16 once;
    - ``dW = bf16(sin a)^T gy`` summed in f32 over all the rows, rounded once;
    - ``dfreq_s = sum gW_s x cos a_s`` in f32, over the rows first and then
      the group's features (kanvit's q/k/v sums each lane over the rows, then
      a head's lanes in ``freqrow``'s VJP), rounded to bf16 once.

    Returns ``(dx (N, G*nin) or None, dw (G, S, nin, out) or None, dfreq (G,
    S))``, bf16; ``exact``: the same f32 basis values and rounded operands
    summed in f64, unrounded."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    acc = torch.float64 if exact else torch.float32
    dxs, dws, dfs = [], [], []
    for g in range(groups):
        xf = x2d[:, g * nin:(g + 1) * nin].float()
        gyg = gy[:, g * nout:(g + 1) * nout].to(acc)
        s, dfx, dff = sine_slices_bf16(xf, freq2d[g], phase, with_grad=True)
        gw = (gyg @ w[g].to(acc).reshape(-1, nout).T).reshape(n, nslices, nin)
        dfs.append((gw * dff.to(acc)).sum(0).sum(-1))
        if need_dx:
            dx = torch.zeros(n, nin, dtype=acc, device=x2d.device)
            for k in range(nslices):
                dx = dx + gw[:, k] * dfx[:, k].to(acc)
            dxs.append(dx)
        if need_dw:
            ab = s.to(torch.bfloat16).to(acc).reshape(n, -1)
            dws.append((ab.T @ gyg).reshape(nslices, nin, nout))
    out = (torch.cat(dxs, 1) if need_dx else None,
           torch.stack(dws) if need_dw else None, torch.stack(dfs))
    return out if exact else tuple(None if t is None else t.to(torch.bfloat16) for t in out)


def sine_dfreq_spread_bf16(x2d, w, freq2d, phase, gy) -> torch.Tensor:
    """``sum |gW_s x cos a_s|`` in f32 over each group's rows and features,
    ``(G, S)``: what an f32 sum of dfreq's terms in another order can move
    by, times its order's rounding (the sum can cancel far below it)."""
    n = x2d.shape[0]
    groups, nslices, nin, nout = w.shape
    out = []
    for g in range(groups):
        xf = x2d[:, g * nin:(g + 1) * nin].float()
        dff = sine_slices_bf16(xf, freq2d[g], phase, with_grad=True)[2]
        gw = (gy[:, g * nout:(g + 1) * nout].float() @ w[g].float().reshape(-1, nout).T)
        out.append((gw.reshape(n, nslices, nin) * dff).abs().sum((0, 2)))
    return torch.stack(out)


def sine_fwd_spread_bf16(x2d, w, freq2d, phase) -> torch.Tensor:
    """:func:`grouped_fwd_spread_bf16` of the SineKAN layer, |sin a| @ |W|."""
    return grouped_fwd_spread_bf16(x2d, w, _sine_slices_of(freq2d, phase))


def sine_dw_spread_bf16(x2d, w, freq2d, phase, gy) -> torch.Tensor:
    """:func:`grouped_dw_spread_bf16` of the SineKAN layer, |sin a|^T |gy|."""
    return grouped_dw_spread_bf16(x2d, w, gy, _sine_slices_of(freq2d, phase))


def sinekan_phase_init(input_dim: int, grid_size: int) -> torch.Tensor:
    """SineKAN's phase table ``(input_dim, grid_size)`` f32 (reference
    ``sinekan.py:59-75``, a copy of kanvit's): ``grid_phase + input_phase``
    through ``grid_size - 1`` damping steps ``phase *= A i^-K + C``, in f64."""
    a, k, c = 0.9724108095811765, 0.9884401790754128, 0.999449553483052
    grid_phase = np.arange(1, grid_size + 1, dtype=np.float64) / (grid_size + 1)
    input_phase = np.linspace(0, np.pi, input_dim)
    phase = grid_phase[None, :] + input_phase[:, None]
    for i in range(1, grid_size):
        phase = (a * i ** (-k) + c) * phase
    return torch.from_numpy(phase.astype(np.float32))
