from kanvit_torch.layers.attention import MSA, FlashAttentionBlock
from kanvit_torch.layers.kan import (
    ChebyKANLayer,
    FourierKANLayer,
    KANLinear,
    TorchLinear,
    make_kan_layer,
)
from kanvit_torch.layers.transformer import TransformerBlock

__all__ = ["KANLinear", "ChebyKANLayer", "FourierKANLayer", "TorchLinear",
           "make_kan_layer", "MSA", "FlashAttentionBlock", "TransformerBlock"]
