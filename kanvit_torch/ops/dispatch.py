"""Kernel dispatch (counterpart of ``kanvit/ops/dispatch.py``).

The rule is the tensor's device and nothing else: a CUDA tensor goes to the
hand-written kernel, a CPU tensor goes to the plain PyTorch version. There is
no environment override and no shape threshold, and a kernel that fails to
build or launch raises; nothing falls back to the plain version on the card.
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


def check_no_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise if autograd would need a gradient through ``tensors``.

    The ported kernels are forward only in this slice; a wrapper refuses to
    hand back a result that silently drops the graph. Run the forward under
    ``torch.inference_mode()`` or ``torch.no_grad()``.
    """
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the backward kernel is not "
            "ported yet (ROADMAP.md, Queue 2); run under torch.inference_mode()"
        )
