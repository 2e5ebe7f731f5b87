"""B-spline KAN math in plain PyTorch (counterpart of ``kanvit/ops/kan_bases.py``).

These functions are the plain versions of the B-spline CUDA kernels in
``kanvit_torch.kernels.fused_basis``: the CPU path runs them (autograd
through :func:`bspline_kan_forward` is the backward kernels' plain version),
and the card holds the kernels against them. Only the B-spline
(efficient-kan) subset is ported so far.
"""

from __future__ import annotations

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
    """
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
