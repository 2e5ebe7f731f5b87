"""KAN basis math in plain PyTorch (counterpart of ``kanvit/ops/kan_bases.py``).

These functions are the plain versions of the CUDA kernels in
``kanvit_torch.kernels.fused_basis``: the CPU path runs them (autograd
through :func:`bspline_kan_forward`, :func:`chebykan_forward`,
:func:`fourierkan_forward`, :func:`fastkan_forward` and
:func:`sinekan_forward` is the backward kernels' plain version), and the
card holds the kernels against them: the B-spline (efficient-kan),
Chebyshev, Fourier, RBF (FastKAN, with its LayerNorm) and sine families.
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
    """
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, _, grid_size = coeffs.shape
    basis = fourier_bases(x.reshape(-1, nin), grid_size)  # (N, in, 2G)
    w = torch.cat([coeffs[0], coeffs[1]], dim=-1)         # (out, in, 2G)
    y = basis.reshape(basis.shape[0], -1) @ w.reshape(nout, -1).T
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


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
    them and crashes the ViT, kanvit repairs that (SURVEY §2.9.1)."""
    lead, nin = x.shape[:-1], x.shape[-1]
    _, nout, deg1 = coeffs.shape
    basis = cheby_bases(x.reshape(-1, nin), deg1 - 1)  # (N, in, deg+1)
    y = basis.reshape(basis.shape[0], -1) @ coeffs.transpose(0, 1).reshape(nout, -1).T
    return y.reshape(*lead, nout)


# --- Gaussian RBF (FastKAN) ---------------------------------------------------

def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, biased variance (kanvit's
    ``kan_bases.layernorm``, the reference's ``nn.LayerNorm`` default)."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


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
    ``time_benchmark`` flag). Shape-preserving over leading dims."""
    lead, nin = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, nin)
    ln = xf if ln_gamma is None else layernorm(xf, ln_gamma, ln_beta)
    basis = rbf_bases(ln, rbf_grid, rbf_denominator)  # (N, in, G)
    y = basis.reshape(xf.shape[0], -1) @ spline_weight.T
    if base_weight is not None:
        y = y + F.silu(xf) @ base_weight.T + base_bias
    return y.reshape(*lead, spline_weight.shape[0])


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
    einsum as one flattened matmul. Shape-preserving over leading dims."""
    lead, nin = x.shape[:-1], x.shape[-1]
    nout = amplitudes.shape[0]
    s = sine_bases(x.reshape(-1, nin), freq, phase)  # (N, in, grid)
    y = s.reshape(s.shape[0], -1) @ amplitudes.reshape(nout, -1).T
    if bias is not None:
        y = y + bias.reshape(nout)
    return y.reshape(*lead, nout)


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
