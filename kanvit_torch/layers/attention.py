"""Multi-head self-attention with per-head KAN projections (counterpart of
``kanvit/layers/attention.py``).

``MSA`` keeps the reference's semantics (``attention.py:112-202``): the
model dim splits into ``n_heads`` slices, each head has its own
``d_head -> d_head`` q/k/v projection, attention is
``softmax(q k^T / sqrt(d_head)) v`` per head and the heads concatenate back,
with no output projection and no dropout.

The projection follows kanvit's dispatch (``attention.py:36-53``, forward
``:455-563``), and every kind feeds the lanes attention its q, k and v as views of the projections'
outputs, with no copy:

- ``efficientkan`` and ``cheby``: the shared-basis path (``_shared_basis_qkv``,
  ``attention.py:56-133``): the per-head q/k/v weights concatenate into one
  grouped weight and one ``bspline_qkv_grouped`` or ``cheby_qkv_grouped``
  launch projects every head;
- ``fast`` and ``sine``: no shared basis (each projection applies its own
  LayerNorm, or has its own freq), so one ``fastkan_qkv_grouped`` or
  ``sinekan_qkv_grouped`` launch per projection, three a block, each
  projecting every head (``_fused_qkv_fast``, ``_fused_qkv_sine_grouped``,
  ``attention.py:136-161,189-209``); sine with grid 4;
- ``vanilla``, ``fourier``, ``flash-attn`` and ``linear``: per-head
  ``TorchLinear`` q/k/v as one batched matmul over the heads (kanvit runs a
  block-diagonal dense matmul outside any Pallas kernel,
  ``_fused_qkv_linear_bd``, ``attention.py:164-186``).

All of it is differentiable: autograd reaches the backward kernels on the
card, and the per-head weight stacking carries the packed weight's gradient
back to each head's projection.

``FlashAttentionBlock`` is the reference's flash-attention module
(``attention.py:13-109``): bias-free ``to_q`` / ``to_kv`` / ``to_out``
around the lanes or the tiled attention, chosen as kanvit chooses them.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers.kan import TorchLinear, make_kan_layer

# Projection kinds of the reference MSA dispatch table
# (``_head_projection_cls_and_kwargs``, ``attention.py:36-53``).
LINEAR_KINDS = ("vanilla", "flash-attn", "fourier", "linear")
SHARED_BASIS_KINDS = ("efficientkan", "cheby")
PER_PROJECTION_KINDS = ("fast", "sine")
# The MSA's Chebyshev degree and sine grid (reference attention.py:159-162).
MSA_CHEBY_DEGREE = 4
MSA_SINE_GRID = 4


def check_kind(kind: str) -> None:
    """ValueError for an unknown kind, with the JAX message."""
    if kind not in (*LINEAR_KINDS, *SHARED_BASIS_KINDS, *PER_PROJECTION_KINDS):
        raise ValueError(f"{kind} invalid. Please use a different argument.")


class MSA(nn.Module):
    """Multi-head self-attention with per-head q/k/v projections.

    Parameters live in reference naming: ``q_mappings.<h>``,
    ``k_mappings.<h>``, ``v_mappings.<h>`` ``ModuleList``s of the kind's
    ``d_head -> d_head`` layer (``KANLinear``, ``ChebyKANLayer`` of degree
    4, or ``TorchLinear`` with bias).
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
        kind = "linear" if type in LINEAR_KINDS else type
        for name in ("q_mappings", "k_mappings", "v_mappings"):
            setattr(self, name, nn.ModuleList(
                make_kan_layer(kind, self.d_head, self.d_head,
                               sine_grid_size=MSA_SINE_GRID,
                               cheby_degree=MSA_CHEBY_DEGREE, generator=generator)
                for _ in range(n_heads)
            ))

    def grouped_weights(self):
        """Per-head q|k|v-concatenated weights (``attention.py:82-87,
        115-116``), rebuilt on every forward (caching them for serving is
        later work):

        - efficientkan: ``(bw, sw, sc)``, ``(H, 3dh, dh)``, ``(H, 3dh, dh, 8)``,
          ``(H, 3dh, dh)``;
        - cheby: ``(cc,)``, ``(H, dh, 3dh, 5)``;
        - the Linear kinds: ``(w, b)``, ``(H, 3dh, dh)``, ``(H, 3dh)``.

        For ``fast`` and ``sine`` see :meth:`projection_weights`.
        """
        heads = list(zip(self.q_mappings, self.k_mappings, self.v_mappings))

        def stack(attr, dim=0):
            return torch.stack([
                torch.cat([getattr(m, attr) for m in qkv], dim=dim) for qkv in heads
            ])

        if self.type == "efficientkan":
            return stack("base_weight"), stack("spline_weight"), stack("spline_scaler")
        if self.type == "cheby":
            return (stack("cheby_coeffs", dim=1),)
        return stack("weight"), stack("bias")

    def projection_weights(self, mappings: nn.ModuleList):
        """One projection's per-head weights, stacked over the heads:

        - fast: ``(ln_gamma, ln_beta, spline_weight, base_weight,
          base_bias)``, ``(H, dh)``, ``(H, dh)``, ``(H, dh, dh*8)``,
          ``(H, dh, dh)``, ``(H, dh)``;
        - sine: ``(freq, amplitudes, bias)``, ``(H, 4)``, ``(H, dh, dh, 4)``,
          ``(H, dh)``.
        """
        def stack(get):
            return torch.stack([get(m) for m in mappings])

        if self.type == "fast":
            return (stack(lambda m: m.layernorm.weight), stack(lambda m: m.layernorm.bias),
                    stack(lambda m: m.spline_linear.weight),
                    stack(lambda m: m.base_linear.weight),
                    stack(lambda m: m.base_linear.bias))
        return (stack(lambda m: m.freq.reshape(-1)), stack(lambda m: m.amplitudes),
                stack(lambda m: m.bias.reshape(-1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, d) -> (B, T, d)``."""
        b, t, d = x.shape
        h, dh = self.n_heads, self.d_head
        x2d = x.reshape(b * t, d)
        if self.type in PER_PROJECTION_KINDS:
            first = self.q_mappings[0]  # every head's centres / phase table
            qkv = []
            for mappings in (self.q_mappings, self.k_mappings, self.v_mappings):
                w = self.projection_weights(mappings)
                if self.type == "fast":
                    y = FB.fastkan_qkv_grouped(x2d, *w[:2], first.rbf_grid,
                                               first.denominator, *w[2:])
                else:
                    y = FB.sinekan_qkv_grouped(x2d, w[0], first.phase, *w[1:])
                qkv.append(y.view(b, t, d))
            return FA.flash_attention_lanes(*qkv, h)
        if self.type == "efficientkan":
            grid = self.q_mappings[0].grid  # every head's (dh, knots) grid is equal
            y = FB.bspline_qkv_grouped(x2d, grid, *self.grouped_weights())
        elif self.type == "cheby":
            y = FB.cheby_qkv_grouped(x2d, *self.grouped_weights())
        else:
            w, bias = self.grouped_weights()
            # (H, N, dh) @ (H, dh, 3dh) + (H, 1, 3dh) -> (H, N, 3dh)
            y = torch.baddbmm(bias.unsqueeze(1), x2d.view(b * t, h, dh).transpose(0, 1),
                              w.transpose(1, 2)).transpose(0, 1)
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
