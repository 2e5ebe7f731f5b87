"""Pre-LN Transformer encoder block (counterpart of
``kanvit/layers/transformer.py``, reference ``model.py:14-37``).

``x + MSA(LN(x))`` then ``x + FF(LN(x))`` with
``FF = Linear(d, ff) -> ReLU -> Linear(ff, d)``; LayerNorm eps 1e-5. The FF
pair stays plain PyTorch, as the JAX package leaves it to XLA, unless
``fused_ff=True``: then LN2, both Linears, the ReLU and the residual run as
one ``kanvit_torch.kernels.fused_ffn.ffn_pre_ln`` (kanvit's opt-in
``KANVIT_FF=1``, ``transformer.py:31-47``; the port keeps no environment
switch). The fused FF is float under int8 serving too: kanvit takes it
before its Linears would quantize.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.layers.attention import MSA
from kanvit_torch.layers.kan import TorchLinear


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, feedforward_dim: int = 128,
                 attn_type: str = "vanilla", fused_ff: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fused_ff = fused_ff
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = MSA(d_model, n_heads, type=attn_type, generator=generator)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.ff = nn.Sequential(
            TorchLinear(d_model, feedforward_dim, generator=generator),
            nn.ReLU(),
            TorchLinear(feedforward_dim, d_model, generator=generator),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        if self.fused_ff:
            return FFN.ffn_pre_ln(x, self.norm2.weight, self.norm2.bias,
                                  self.ff[0].weight, self.ff[0].bias,
                                  self.ff[2].weight, self.ff[2].bias)
        return x + self.ff(self.norm2(x))
