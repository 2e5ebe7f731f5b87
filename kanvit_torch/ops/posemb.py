"""Sinusoidal positional embedding table (counterpart of ``kanvit/ops/posemb.py``).

Keeps the reference's quirk (``model.py:128-140``): for odd column ``j`` the
exponent is ``j / d``, not the canonical ``(j - 1) / d``. The table is built
in numpy float64 and stored as float32, exactly as the JAX package does.
"""

from __future__ import annotations

import numpy as np


def sinusoidal_positional_embeddings(seq_length: int, d: int) -> np.ndarray:
    """``(seq_length, d)`` float32 table with reference quirk parity."""
    i = np.arange(seq_length, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    angle = i / np.power(10000.0, j / d)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)
