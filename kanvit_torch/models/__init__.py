from kanvit_torch.models.vit import PRESETS, VisionTransformer, create_model

__all__ = ["PRESETS", "VisionTransformer", "create_model"]
