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

The LayerNorms (:class:`LayerNorm`) and the fused FF widen bf16 parameters
to f32 where they meet f32 activations (``kanvit_torch.utils.precision.
promote``): int8 serving of a bf16 model turns the stream f32 at the first
``qdot``, and kanvit's LayerNorm and fused FF then run in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.layers.attention import MSA
from kanvit_torch.layers.kan import TorchLinear
from kanvit_torch.utils.precision import promote


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose bf16 gamma and beta are widened to f32 on f32
    activations (flax promotes them in kanvit); the same names and state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            *promote(x, self.weight, self.bias), self.eps)


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, feedforward_dim: int = 128,
                 attn_type: str = "vanilla", fused_ff: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fused_ff = fused_ff
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.attn = MSA(d_model, n_heads, type=attn_type, generator=generator)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.ff = nn.Sequential(
            TorchLinear(d_model, feedforward_dim, generator=generator),
            nn.ReLU(),
            TorchLinear(feedforward_dim, d_model, generator=generator),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        if self.fused_ff:
            return FFN.ffn_pre_ln(x, *promote(
                x, self.norm2.weight, self.norm2.bias, self.ff[0].weight,
                self.ff[0].bias, self.ff[2].weight, self.ff[2].bias))
        return x + self.ff(self.norm2(x))
