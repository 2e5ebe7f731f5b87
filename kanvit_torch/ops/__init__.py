"""Plain PyTorch ops: the plain versions of every kanvit_torch kernel.

Each op is a plain function over tensors, runnable on the CPU; the CPU path
of every kernel wrapper runs it, and the card holds each kernel against it.
"""

from kanvit_torch.ops.attention import lanes_attention, multi_head_attention
from kanvit_torch.ops.kan_bases import (
    bspline_bases,
    bspline_curve2coeff,
    bspline_kan_forward,
    make_bspline_grid,
)
from kanvit_torch.ops.patchify import patchify
from kanvit_torch.ops.posemb import sinusoidal_positional_embeddings

__all__ = [
    "patchify",
    "sinusoidal_positional_embeddings",
    "make_bspline_grid",
    "bspline_bases",
    "bspline_kan_forward",
    "bspline_curve2coeff",
    "multi_head_attention",
    "lanes_attention",
]
