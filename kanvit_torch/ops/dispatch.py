"""Kernel dispatch (counterpart of ``kanvit/ops/dispatch.py``).

The rule is the tensor's device and nothing else: a CUDA tensor goes to the
hand-written kernel (its backward kernel too, when autograd asks for a
gradient), a CPU tensor goes to the plain PyTorch version, which autograd
differentiates. There is no environment override and no shape threshold, and
a kernel that fails to build or launch raises; nothing falls back to the
plain version on the card.
"""

from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")

