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
