"""PyTorch-convention initializers driven by an explicit ``torch.Generator``
(counterpart of ``kanvit/utils/torch_init.py``).

Weights follow the torch convention ``(out_features, in_features)``, so
fan-in is the last axis. Each function fills its tensor in place and returns
it.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def kaiming_uniform_(t: torch.Tensor, a: float,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """torch ``kaiming_uniform_`` with negative slope ``a`` (fan-in mode):
    ``U(-bound, bound)``, ``bound = sqrt(2 / (1 + a^2)) * sqrt(3 / fan_in)``
    with fan-in the last axis."""
    fan_in = t.shape[-1]
    bound = math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / fan_in)
    return t.uniform_(-bound, bound, generator=generator)


def linear_default_weight_(t: torch.Tensor,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """torch ``nn.Linear`` default weight init: kaiming_uniform(a=sqrt(5))."""
    return kaiming_uniform_(t, math.sqrt(5.0), generator)


@torch.no_grad()
def linear_default_bias_(t: torch.Tensor, fan_in: int,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """torch ``nn.Linear`` default bias init: ``U(-1/sqrt(fan_in), +)``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def chebykan_coeffs_(t: torch.Tensor, in_features: int, degree: int,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """ChebyKAN coefficients ``(in, out, degree+1)``: normal with std
    ``1 / (in * (degree + 1))`` (reference ``cheby.py:21-23``, kanvit
    ``layers/kan.py:376-383``)."""
    return t.normal_(0.0, 1.0 / (in_features * (degree + 1)), generator=generator)


@torch.no_grad()
def fourierkan_coeffs_(t: torch.Tensor, in_features: int, grid_size: int,
                       smooth: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """NaiveFourierKAN coefficients ``(2, out, in, grid)``: ``randn / (sqrt(in)
    * norm)`` with ``norm = sqrt(grid)``, or the per-harmonic ``(k)**2``
    under smooth init (reference ``nfkan.py:24-30``, kanvit
    ``layers/kan.py:332-346``)."""
    norm = ((torch.arange(grid_size, dtype=t.dtype) + 1) ** 2 if smooth
            else math.sqrt(grid_size))
    t.normal_(0.0, 1.0, generator=generator)
    return t.div_(math.sqrt(in_features) * norm)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, mean: float = 0.0,
                  lower: float = -2.0, upper: float = 2.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """torch ``trunc_normal_``: normal(mean, std) cut at the ABSOLUTE bounds
    ``[lower, upper]`` (kanvit ``utils/torch_init.py:50``, reference
    ``fastkan.py:11-12``); entries outside are drawn again."""
    t.normal_(mean, std, generator=generator)
    while True:
        out = (t < lower) | (t > upper)
        count = int(out.sum())
        if count == 0:
            return t
        t[out] = torch.empty(count, dtype=t.dtype).normal_(mean, std,
                                                            generator=generator)


@torch.no_grad()
def sinekan_amplitudes_(t: torch.Tensor, is_first: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """SineKAN amplitudes ``(out, in, grid)``: ONE draw per (out, in),
    ``normal * 0.4`` for a first layer else ``U(-1, 1)``, broadcast over the
    grid and divided by ``out * k`` for harmonic k = 1..grid (reference
    ``sinekan.py:49-57``, kanvit ``layers/kan.py:270-280``)."""
    nout, nin, grid_size = t.shape
    base = torch.empty(nout, nin, 1, dtype=t.dtype)
    if is_first:
        base.normal_(0.0, 1.0, generator=generator).mul_(0.4)
    else:
        base.uniform_(-1.0, 1.0, generator=generator)
    k = torch.arange(1, grid_size + 1, dtype=t.dtype)
    return t.copy_(base / nout / k)


@torch.no_grad()
def sinekan_freq_(t: torch.Tensor, is_first: bool = False,
                  norm_freq: bool = True) -> torch.Tensor:
    """SineKAN freq: ``k / (grid + 1)`` for k = 1..grid (``k`` for a first
    layer, or without ``norm_freq``), in ``t``'s shape (the reference's
    ``(1, 1, 1, grid)``)."""
    grid_size = t.numel()
    f = torch.arange(1, grid_size + 1, dtype=t.dtype)
    if norm_freq:
        f = f / (grid_size + 1) ** (1 - int(is_first))
    return t.copy_(f.reshape(t.shape))
