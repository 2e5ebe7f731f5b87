from kanvit_torch.layers.attention import MSA, FlashAttentionBlock
from kanvit_torch.layers.kan import (
    ChebyKANLayer,
    FastKANLayer,
    FourierKANLayer,
    KANLinear,
    SineKANLayer,
    TorchLinear,
    make_kan_layer,
)
from kanvit_torch.layers.transformer import TransformerBlock

__all__ = ["KANLinear", "ChebyKANLayer", "FastKANLayer", "FourierKANLayer",
           "SineKANLayer", "TorchLinear", "make_kan_layer", "MSA",
           "FlashAttentionBlock", "TransformerBlock"]
