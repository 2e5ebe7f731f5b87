from kanvit_torch.layers.attention import MSA, FlashAttentionBlock
from kanvit_torch.layers.kan import KANLinear, TorchLinear
from kanvit_torch.layers.transformer import TransformerBlock

__all__ = ["KANLinear", "TorchLinear", "MSA", "FlashAttentionBlock",
           "TransformerBlock"]
