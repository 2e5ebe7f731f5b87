"""Causal decoder (counterpart of ``kanvit/models/decoder.py``).

Token embedding -> N residual causal ``FlashAttentionBlock``s -> LayerNorm
-> vocab projection, trained with next-token CE
(``kanvit_torch.bench_decoder``). Past one tile (T > 512 at the default
buckets) every block runs the tiled attention kernels. Ring attention
(``seq_axis``) and kanvit's ``remat`` option are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch.layers.attention import FlashAttentionBlock
from kanvit_torch.layers.kan import TorchLinear


class CausalDecoder(nn.Module):
    """``(B, T)`` int64 tokens -> ``(B, T, vocab)`` logits.

    Parameter names follow kanvit's tree (``kanvit_torch.utils.convert``):
    ``embed.weight``, ``blocks.<i>.{to_q,to_kv,to_out}.weight``,
    ``norm.{weight,bias}``, ``lm_head.{weight,bias}``. The embedding is
    drawn as flax ``nn.Embed``'s default, normal with std ``dim ** -0.5``.
    """

    def __init__(self, vocab: int, dim: int = 256, heads: int = 4,
                 n_blocks: int = 4, seq_axis: str | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embed = nn.Embedding(vocab, dim)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, dim ** -0.5, generator=generator)
        self.blocks = nn.ModuleList(
            FlashAttentionBlock(dim, heads, dim // heads, causal=True,
                                seq_axis=seq_axis, generator=generator)
            for _ in range(n_blocks)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.lm_head = TorchLinear(dim, vocab, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        for blk in self.blocks:
            x = x + blk(x)
        return self.lm_head(self.norm(x))
