"""Vectorized patch extraction (counterpart of ``kanvit/ops/patchify.py``)."""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, n_patches: int) -> torch.Tensor:
    """``[B, C, H, W] -> [B, n_patches**2, C * ph * pw]``.

    Patch ``idx = i * n_patches + j`` runs row-major over the patch grid and
    each patch is flattened in ``(C, ph, pw)`` C-order (reference
    ``model.py:111-126``).
    """
    b, c, h, w = images.shape
    if h % n_patches or w % n_patches:
        raise ValueError(
            f"image size ({h}x{w}) not divisible by n_patches={n_patches}"
        )
    ph, pw = h // n_patches, w // n_patches
    x = images.reshape(b, c, n_patches, ph, n_patches, pw)
    # -> (B, grid_i, grid_j, C, ph, pw): patch grid row-major, patch body C-major
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, n_patches * n_patches, c * ph * pw)
