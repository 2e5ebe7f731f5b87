"""Vision Transformer assembly (counterpart of ``kanvit/models/vit.py``).

Reference ``model.py:40-169``: patchify -> patch embedding -> [class] token
-> sinusoidal position table (quirk parity) -> N pre-LN encoder blocks ->
LN + Linear head on the class token. Every variant is ported, for serving
and training (``kanvit_torch.train``): ``vanilla`` (Linear embedder),
``efficientkan`` (KANLinear), ``fast`` (FastKAN), ``sine`` (SineKAN, grid
28), ``cheby`` (ChebyKAN, degree 4) and ``fourier`` (FourierKAN, grid 28),
each with pre-LN blocks whose MSA projects q/k/v per head with the kind's
layer (Linear for ``vanilla`` and ``fourier``, SineKAN grid 4 for
``sine``); and ``flash-attn`` (Linear embedder, raw ``FlashAttentionBlock``s
with no LayerNorm, FF or residual, reference ``model.py:93-95,156-159``).
``fused_ff=True`` runs each block's FF as the fused ``ffn_pre_ln`` kernels
(kanvit's ``KANVIT_FF=1``); off by default, as in kanvit. Where a bf16
model's stream turns f32 (int8 serving on ``qdot``), the class token and the
head's LayerNorm are widened to it, as JAX promotes them.
"""

from __future__ import annotations

import torch
from torch import nn

from kanvit_torch import VARIANTS
from kanvit_torch.layers.attention import FlashAttentionBlock
from kanvit_torch.layers.kan import TorchLinear, make_kan_layer
from kanvit_torch.layers.transformer import LayerNorm, TransformerBlock
from kanvit_torch.ops.patchify import patchify
from kanvit_torch.ops.posemb import sinusoidal_positional_embeddings
from kanvit_torch.utils.precision import promote

# Model geometry presets, a copy of ``bench.py:28-37``: "reference" is the
# reference's MNIST ctor config (model.py:49); the ViT ones are 224x224
# images in 14x14 patches (197 tokens).
PRESETS = {
    "reference": dict(chw=(1, 28, 28), n_patches=7, n_blocks=4,
                      d_hidden=64, n_heads=2, out_d=10),
    "vit-s": dict(chw=(3, 224, 224), n_patches=14, n_blocks=12,
                  d_hidden=384, n_heads=6, out_d=1000),
    "vit-b": dict(chw=(3, 224, 224), n_patches=14, n_blocks=12,
                  d_hidden=768, n_heads=12, out_d=1000),
    "vit-l": dict(chw=(3, 224, 224), n_patches=14, n_blocks=24,
                  d_hidden=1024, n_heads=16, out_d=1000),
}

# The embedder's per-variant constants (reference call sites, model.py:72-76;
# kanvit models/vit.py:44-47).
MAPPER_SINE_GRID = 28
MAPPER_FOURIER_GRID = 28
MAPPER_CHEBY_DEGREE = 4


class VisionTransformer(nn.Module):
    """``[B, C, H, W] -> [B, out_d]`` logits.

    Parameter names are the reference's: ``linear_mapper``, ``v_class``,
    ``blocks.<i>``, ``mlp_head.0`` (LayerNorm), ``mlp_head.1`` (Linear).
    """

    def __init__(self, chw: tuple, n_patches: int = 7, n_blocks: int = 4,
                 d_hidden: int = 64, n_heads: int = 2, out_d: int = 10,
                 type: str = "vanilla", fused_ff: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if type not in VARIANTS:
            raise ValueError(f"Unknown transformer type: {type}")
        c, h, w = chw
        if h % n_patches or w % n_patches:
            raise ValueError(f"image {h}x{w} not divisible by n_patches={n_patches}")
        self.chw = tuple(chw)
        self.n_patches = n_patches
        self.d_hidden = d_hidden
        self.out_d = out_d
        self.type = type
        input_d = c * (h // n_patches) * (w // n_patches)

        self.linear_mapper = make_kan_layer(
            type, input_d, d_hidden, sine_grid_size=MAPPER_SINE_GRID,
            fourier_grid_size=MAPPER_FOURIER_GRID,
            cheby_degree=MAPPER_CHEBY_DEGREE, generator=generator)
        # Classification token (reference model.py:83: torch.randn)
        self.v_class = nn.Parameter(torch.randn(1, d_hidden, generator=generator))
        self.register_buffer(
            "pos_embeddings",
            torch.from_numpy(sinusoidal_positional_embeddings(
                n_patches ** 2 + 1, d_hidden)),
            persistent=False,
        )
        if type == "flash-attn":
            blocks = (FlashAttentionBlock(d_hidden, n_heads, generator=generator)
                      for _ in range(n_blocks))
        else:
            blocks = (TransformerBlock(d_hidden, n_heads,
                                       feedforward_dim=4 * d_hidden,
                                       attn_type=type, fused_ff=fused_ff,
                                       generator=generator)
                      for _ in range(n_blocks))
        self.blocks = nn.ModuleList(blocks)
        self.mlp_head = nn.Sequential(
            LayerNorm(d_hidden, eps=1e-5),
            TorchLinear(d_hidden, out_d, generator=generator),
        )

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, C, H, W] -> [B, T, d_hidden]`` tokens."""
        b = images.shape[0]
        tokens = self.linear_mapper(patchify(images, self.n_patches))
        cls, = promote(tokens, self.v_class)
        cls = cls.unsqueeze(0).expand(b, 1, self.d_hidden)
        tokens = torch.cat([cls, tokens], dim=1)
        # the f32 table in the tokens' dtype, as kanvit adds it (vit.py:130-132)
        return tokens + self.pos_embeddings[: tokens.shape[1]].to(tokens.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.embed(images)
        for blk in self.blocks:
            out = blk(out)
        return self.mlp_head(out[:, 0])


def create_model(
    model_type: str = "vanilla",
    *,
    chw: tuple = (3, 32, 32),
    n_patches: int = 4,
    n_blocks: int = 8,
    d_hidden: int = 64,
    n_heads: int = 8,
    out_d: int = 100,
    seed: int = 0,
    fused_ff: bool = False,
) -> VisionTransformer:
    """Registry entry point with ``kanvit.models.create_model``'s defaults.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the B-spline init is an under-determined lstsq, which CUDA's solver
    refuses); move the model with ``.to(device)``.
    """
    return VisionTransformer(
        chw=chw, n_patches=n_patches, n_blocks=n_blocks, d_hidden=d_hidden,
        n_heads=n_heads, out_d=out_d, type=model_type, fused_ff=fused_ff,
        generator=torch.Generator().manual_seed(seed),
    )
