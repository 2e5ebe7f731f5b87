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

``FlashAttentionBlock`` is the reference's flash-attention module
(``attention.py:13-109``): bias-free ``to_q`` / ``to_kv`` / ``to_out``
around the lanes or the tiled attention, chosen as kanvit chooses them.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers.kan import KANLinear, TorchLinear

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


class FlashAttentionBlock(nn.Module):
    """Flash-attention module (counterpart of kanvit's
    ``layers/attention.py:581-676``).

    Projections ``to_q (dim -> h*dh)``, ``to_kv (dim -> 2*h*dh)`` and
    ``to_out (h*dh -> dim)``, all bias-free ``TorchLinear``; default
    ``dim_head=64``. Where kanvit's ``_lanes_ok`` and bucket guard hold, the
    attention runs on the head-concatenated projections in place
    (``flash_attention_lanes``); elsewhere on ``(B, H, T, dh)`` views of
    them (``flash_attention``, which takes kanvit's single-tile or tiled
    tier). Ring attention (``seq_axis``) is not ported.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, q_bucket_size: int = 512,
                 k_bucket_size: int = 1024, seq_axis: str | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                "ring attention (seq_axis) is not ported to kanvit_torch yet "
                "(ROADMAP.md, Queue 1 item 8)")
        self.heads = heads
        self.dim_head = dim_head
        self.causal = causal
        self.q_bucket_size = q_bucket_size
        self.k_bucket_size = k_bucket_size
        inner = heads * dim_head
        self.to_q = TorchLinear(dim, inner, use_bias=False, generator=generator)
        self.to_kv = TorchLinear(dim, 2 * inner, use_bias=False,
                                 generator=generator)
        self.to_out = TorchLinear(inner, dim, use_bias=False, generator=generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                q_bucket_size: int | None = None,
                k_bucket_size: int | None = None) -> torch.Tensor:
        """``(B, T, dim) -> (B, T, dim)``; ``context`` ``(B, Tk, dim)`` for
        the keys and values, ``mask`` an optional ``(B, Tk)`` key mask."""
        qb = q_bucket_size or self.q_bucket_size
        kb = k_bucket_size or self.k_bucket_size
        h, dh = self.heads, self.dim_head
        q = self.to_q(x)
        k, v = self.to_kv(x if context is None else context).chunk(2, dim=-1)
        b, t, inner = q.shape
        tk = k.shape[1]
        if FA.lanes_applicable(t, tk, inner, h, qb, kb):
            out = FA.flash_attention_lanes(q, k, v, h, causal=self.causal,
                                           mask=mask)
        else:
            out = FA.flash_attention(
                q.view(b, t, h, dh).transpose(1, 2),
                k.view(b, tk, h, dh).transpose(1, 2),
                v.view(b, tk, h, dh).transpose(1, 2),
                causal=self.causal, q_block=qb, k_block=kb, mask=mask,
            ).transpose(1, 2).reshape(b, t, inner)
        return self.to_out(out)
