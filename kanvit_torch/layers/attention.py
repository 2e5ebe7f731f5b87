"""Multi-head self-attention with per-head KAN projections (counterpart of
``kanvit/layers/attention.py``).

``MSA`` keeps the reference's semantics (``attention.py:112-202``): the
model dim splits into ``n_heads`` slices, each head has its own
``d_head -> d_head`` q/k/v projection, attention is
``softmax(q k^T / sqrt(d_head)) v`` per head and the heads concatenate back,
with no output projection and no dropout.

Only ``efficientkan`` is ported. Its forward is the JAX package's
shared-basis path (``_shared_basis_qkv``, ``attention.py:56-133``): the
per-head q/k/v weights concatenate into one grouped weight, one
``bspline_qkv_grouped`` launch projects every head, and the lanes attention
reads the three q/k/v slices of its output in place. Both are
differentiable: autograd reaches their backward kernels on the card, and
the per-head weight stacking carries the packed weight's gradient back to
each head's KANLinear.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers.kan import KANLinear

# Projection kinds of the reference MSA dispatch table
# (``_head_projection_cls_and_kwargs``) that are not ported yet.
NOT_PORTED = ("vanilla", "flash-attn", "fourier", "linear", "fast", "sine",
              "cheby")


def check_kind(kind: str) -> None:
    """ValueError for an unknown kind (the JAX message), NotImplementedError
    for a known kind that is not ported yet."""
    if kind == "efficientkan":
        return
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"MSA type {kind!r} is not ported to kanvit_torch yet "
            "(ROADMAP.md, Queue 1)"
        )
    raise ValueError(f"{kind} invalid. Please use a different argument.")


class MSA(nn.Module):
    """Multi-head self-attention with per-head KANLinear q/k/v projections.

    Parameters live in reference naming: ``q_mappings.<h>``,
    ``k_mappings.<h>``, ``v_mappings.<h>`` ``ModuleList``s of
    ``KANLinear(d_head, d_head)``.
    """

    def __init__(self, d: int, n_heads: int = 4, type: str = "vanilla", *,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_kind(type)
        if d % n_heads:
            raise ValueError(f"d={d} not divisible by n_heads={n_heads}")
        self.d = d
        self.n_heads = n_heads
        self.type = type
        self.d_head = d // n_heads
        for name in ("q_mappings", "k_mappings", "v_mappings"):
            setattr(self, name, nn.ModuleList(
                KANLinear(self.d_head, self.d_head, generator=generator)
                for _ in range(n_heads)
            ))

    def grouped_weights(self):
        """Per-head q|k|v-concatenated ``(bw, sw, sc)``: ``(H, 3dh, dh)``,
        ``(H, 3dh, dh, 8)``, ``(H, 3dh, dh)`` (``attention.py:82-87``).
        Rebuilt on every forward; caching it for serving is later work."""
        heads = list(zip(self.q_mappings, self.k_mappings, self.v_mappings))

        def stack(attr):
            return torch.stack([
                torch.cat([getattr(m, attr) for m in qkv], dim=0) for qkv in heads
            ])

        return stack("base_weight"), stack("spline_weight"), stack("spline_scaler")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, d) -> (B, T, d)``."""
        b, t, d = x.shape
        h, dh = self.n_heads, self.d_head
        bw, sw, sc = self.grouped_weights()
        grid = self.q_mappings[0].grid  # every head's (dh, knots) grid is equal
        y = FB.bspline_qkv_grouped(x.reshape(b * t, d), grid, bw, sw, sc)
        # (N, H*[q|k|v]) -> three (B, T, H, dh) strided views, no copy.
        y4 = y.view(b, t, h, 3 * dh)
        q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
        return FA.flash_attention_lanes(q, k, v, h)
