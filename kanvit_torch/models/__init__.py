from kanvit_torch.models.decoder import CausalDecoder
from kanvit_torch.models.vit import PRESETS, VisionTransformer, create_model

__all__ = ["CausalDecoder", "PRESETS", "VisionTransformer", "create_model"]
