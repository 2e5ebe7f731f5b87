"""KAN layers as ``nn.Module``s (counterpart of ``kanvit/layers/kan.py``).

Parameter names, shapes and init distributions follow the PyTorch reference
(``models/effkan.py``), so reference-named weights load directly
(``kanvit_torch.utils.convert``). Modules are built on the CPU from an
explicit ``torch.Generator``; move them with ``.to(device)``: the Linear,
B-spline (efficient-kan), Chebyshev, Fourier, FastKAN and SineKAN layers.
Each widens its bf16 parameters to f32 where they meet f32 activations
(``kanvit_torch.utils.precision.promote``, JAX's promotion in kanvit).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.kernels import int8_matmul as IM
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.ops import quant
from kanvit_torch.utils import torch_init as tinit
from kanvit_torch.utils.precision import promote


class TorchLinear(nn.Module):
    """Dense layer with torch conventions: ``weight (out, in)``,
    kaiming-uniform(a=sqrt(5)) weight, ``U(+-1/sqrt(fan_in))`` bias.

    Under ``kanvit_torch.ops.quant.int8_serving`` it runs W8A8, in kanvit's
    order (``kan.py:63-70``): the ``int8_linear`` kernel when it is switched
    on and K and out are multiples of 128 (per-row activation scales, the
    bias in its epilogue); otherwise ``qdot`` with the layer's calibrated
    static scale, or a dynamic one, and the bias added in f32. ``qdot``
    returns f32 and ``int8_linear`` x's dtype, as kanvit's do; bf16 weights
    meeting f32 x are widened first.
    """

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        tinit.linear_default_weight_(self.weight, generator)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            tinit.linear_default_bias_(self.bias, in_features, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = promote(x, self.weight, self.bias)
        if not quant.int8_enabled():
            if x.dtype == torch.bfloat16 and b is not None:
                # kanvit's order: the product rounded to bf16, then + bias
                return F.linear(x, w) + b
            return F.linear(x, w, b)
        if quant.kernel_enabled() and IM.applicable(self.in_features,
                                                    self.out_features):
            return IM.int8_linear(x, w, b)
        y = quant.qdot(x, w, quant.static_scale_for(self))
        return y if b is None else y + b


class KANLinear(nn.Module):
    """efficient-kan B-spline KAN layer (reference ``models/effkan.py:8-97``).

    Params: ``base_weight (out, in)``, ``spline_weight (out, in, G+k)``,
    ``spline_scaler (out, in)`` when standalone scaling is enabled. The knot
    grid ``(in, G+2k+1)`` is a non-persistent buffer: the uniform grid of the
    constructor arguments, unless ``load_reference_state_dict`` loads the
    refit knots of a stateful-grid tree into it (and sets ``refit_grid``).
    The grid stays f32 under bf16, as kanvit keeps it outside the param
    tree; a refit grid is a param there, and bf16 rounds its values
    (``kanvit_torch.utils.precision``). The forward goes through
    ``kanvit_torch.kernels.fused_basis.bspline_kan``, and so does autograd:
    the backward kernels on the card, the plain version on the CPU.
    """

    def __init__(self, in_features: int, out_features: int,
                 grid_size: int = 5, spline_order: int = 3,
                 scale_noise: float = 0.1, scale_base: float = 1.0,
                 scale_spline: float = 1.0,
                 enable_standalone_scale_spline: bool = True,
                 grid_range=(-1.0, 1.0), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.grid_size = grid_size
        self.spline_order = spline_order
        self.scale_noise = scale_noise
        self.scale_base = scale_base
        self.scale_spline = scale_spline
        self.enable_standalone_scale_spline = enable_standalone_scale_spline
        self.register_buffer(
            "grid",
            K.make_bspline_grid(in_features, grid_size, spline_order, grid_range),
            persistent=False,
        )
        self.refit_grid = False
        self.base_weight = nn.Parameter(torch.empty(out_features, in_features))
        self.spline_weight = nn.Parameter(
            torch.empty(out_features, in_features, grid_size + spline_order))
        if enable_standalone_scale_spline:
            self.spline_scaler = nn.Parameter(
                torch.empty(out_features, in_features))
        else:
            self.register_parameter("spline_scaler", None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Reference init (``effkan.py:74-97``): kaiming base weight, spline
        coefficients least-squares fitted to uniform noise, kaiming scaler.
        Runs on the CPU (the fit is an under-determined lstsq)."""
        tinit.kaiming_uniform_(self.base_weight,
                               math.sqrt(5.0) * self.scale_base, generator)
        noise = (
            (torch.rand(self.grid_size + 1, self.in_features,
                        self.out_features, generator=generator) - 0.5)
            * self.scale_noise / self.grid_size
        )
        grid = self.grid.cpu()
        pts = grid.T[self.spline_order:-self.spline_order]  # (G+1, in)
        coeff = K.bspline_curve2coeff(pts, noise, grid, self.spline_order)
        scale = 1.0 if self.enable_standalone_scale_spline else self.scale_spline
        self.spline_weight.copy_(scale * coeff)
        if self.spline_scaler is not None:
            tinit.kaiming_uniform_(self.spline_scaler,
                                   math.sqrt(5.0) * self.scale_spline, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FB.bspline_kan(x, self.grid, *promote(
            x, self.base_weight, self.spline_weight, self.spline_scaler),
            self.spline_order)


class ChebyKANLayer(nn.Module):
    """ChebyKAN layer (reference ``models/cheby.py:10-48``).

    Param ``cheby_coeffs (in, out, degree+1)``, normal with std
    ``1/(in*(degree+1))``. The reference's ``arange`` buffer is derived, not
    stored. Output preserves leading dims (kanvit's repair of SURVEY §2.9.1).
    The forward goes through ``kanvit_torch.kernels.fused_basis.chebykan``.
    """

    def __init__(self, input_dim: int, output_dim: int, degree: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.degree = degree
        self.cheby_coeffs = nn.Parameter(
            torch.empty(input_dim, output_dim, degree + 1))
        tinit.chebykan_coeffs_(self.cheby_coeffs, input_dim, degree, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FB.chebykan(x, *promote(x, self.cheby_coeffs))


class FourierKANLayer(nn.Module):
    """NaiveFourierKAN layer (reference ``models/nfkan.py:5-52``).

    Params ``fouriercoeffs (2, out, in, grid)``, ``randn / (sqrt(in) *
    sqrt(grid))`` (or the per-harmonic ``k**2`` norm under smooth init), and
    ``bias (1, out)`` zeros, the reference's shape. The reference ViT passes
    ``grid_size=`` where the layer spells ``gridsize`` and crashes; kanvit
    and the port take ``grid_size``. The forward goes through
    ``kanvit_torch.kernels.fused_basis.fourierkan``.
    """

    def __init__(self, input_dim: int, output_dim: int, grid_size: int,
                 add_bias: bool = True, smooth_initialization: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.grid_size = grid_size
        self.fouriercoeffs = nn.Parameter(
            torch.empty(2, output_dim, input_dim, grid_size))
        tinit.fourierkan_coeffs_(self.fouriercoeffs, input_dim, grid_size,
                                 smooth_initialization, generator)
        if add_bias:
            self.bias = nn.Parameter(torch.zeros(1, output_dim))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FB.fourierkan(x, *promote(x, self.fouriercoeffs, self.bias))


class SplineLinear(nn.Module):
    """FastKAN's bias-free spline Linear (reference ``fastkan.py:6-12``):
    ``weight (out, in)``, trunc-normal with std ``init_scale`` cut at the
    absolute bounds [-2, 2]."""

    def __init__(self, in_features: int, out_features: int,
                 init_scale: float = 0.1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        tinit.trunc_normal_(self.weight, init_scale, generator=generator)


class FastKANLayer(nn.Module):
    """FastKAN RBF layer (reference ``models/fastkan.py:33-76``).

    The reference's names: ``layernorm.weight`` / ``.bias (in,)`` (the
    LayerNorm inside the layer; only its parameters are used, the kernels
    normalise), ``spline_linear.weight (out, in*num_grids)`` trunc-normal
    0.1, and with the base branch ``base_linear.weight (out, in)`` /
    ``.bias (out,)``. The RBF centres ``torch.linspace(grid_min, grid_max,
    num_grids)``, the reference's bits (kanvit's ``jnp.linspace`` differs by
    up to 6 ulp), are a non-persistent buffer. The forward goes through
    ``kanvit_torch.kernels.fused_basis.fastkan``; ``time_benchmark`` skips
    the LayerNorm (reference ``fastkan.py:66-70``).
    """

    def __init__(self, input_dim: int, output_dim: int, grid_min: float = -2.0,
                 grid_max: float = 2.0, num_grids: int = 8,
                 use_base_update: bool = True,
                 spline_weight_init_scale: float = 0.1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.denominator = (grid_max - grid_min) / (num_grids - 1)
        self.layernorm = nn.LayerNorm(input_dim, eps=1e-5)
        self.register_buffer("rbf_grid",
                             torch.linspace(grid_min, grid_max, num_grids),
                             persistent=False)
        self.spline_linear = SplineLinear(input_dim * num_grids, output_dim,
                                          spline_weight_init_scale,
                                          generator=generator)
        self.base_linear = (TorchLinear(input_dim, output_dim, generator=generator)
                            if use_base_update else None)

    def forward(self, x: torch.Tensor, time_benchmark: bool = False) -> torch.Tensor:
        ln = None if time_benchmark else self.layernorm
        base = self.base_linear
        gamma, beta, spline_w, base_w, base_b = promote(
            x, None if ln is None else ln.weight, None if ln is None else ln.bias,
            self.spline_linear.weight, None if base is None else base.weight,
            None if base is None else base.bias)
        return FB.fastkan(x, gamma, beta, self.rbf_grid, self.denominator,
                          spline_w, base_w, base_b)


class SineKANLayer(nn.Module):
    """SineKAN layer (reference ``models/sinekan.py:26-91``).

    Params in the reference's shapes: ``amplitudes (out, in, grid)`` (one
    draw per (out, in), divided by ``out * k``), trainable ``freq (1, 1, 1,
    grid)`` (``k / (grid + 1)``) and ``bias (1, out)`` (``1 / out``). The
    damped ``phase (in, grid)`` table is a non-persistent buffer, so kanvit's
    converted weights, which omit it, load. The forward goes through
    ``kanvit_torch.kernels.fused_basis.sinekan``.
    """

    def __init__(self, input_dim: int, output_dim: int, grid_size: int = 5,
                 is_first: bool = False, add_bias: bool = True,
                 norm_freq: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.grid_size = grid_size
        self.register_buffer("phase", K.sinekan_phase_init(input_dim, grid_size),
                             persistent=False)
        self.amplitudes = nn.Parameter(torch.empty(output_dim, input_dim, grid_size))
        tinit.sinekan_amplitudes_(self.amplitudes, is_first, generator)
        self.freq = nn.Parameter(torch.empty(1, 1, 1, grid_size))
        tinit.sinekan_freq_(self.freq, is_first, norm_freq)
        if add_bias:
            self.bias = nn.Parameter(torch.full((1, output_dim), 1.0 / output_dim))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freq, amplitudes, bias = promote(x, self.freq, self.amplitudes, self.bias)
        return FB.sinekan(x, freq, self.phase, amplitudes, bias)


def make_kan_layer(kind: str, in_features: int, out_features: int, *,
                   sine_grid_size: int = 5, fourier_grid_size: int = 5,
                   cheby_degree: int = 4,
                   generator: torch.Generator | None = None) -> nn.Module:
    """Variant-keyed layer factory of the patch embedder and the MSA
    projections (kanvit ``layers/kan.py:394-427``, reference ``model.py:67-80``
    and ``attention.py:135-173``)."""
    if kind in ("vanilla", "flash-attn", "linear"):
        return TorchLinear(in_features, out_features, generator=generator)
    if kind == "efficientkan":
        return KANLinear(in_features, out_features, generator=generator)
    if kind == "fourier":
        return FourierKANLayer(in_features, out_features, fourier_grid_size,
                               generator=generator)
    if kind == "cheby":
        return ChebyKANLayer(in_features, out_features, cheby_degree,
                             generator=generator)
    if kind == "fast":
        return FastKANLayer(in_features, out_features, generator=generator)
    if kind == "sine":
        return SineKANLayer(in_features, out_features, sine_grid_size,
                            generator=generator)
    raise ValueError(f"Unknown KAN layer kind: {kind!r}")
