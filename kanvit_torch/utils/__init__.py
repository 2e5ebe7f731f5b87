from kanvit_torch.utils.torch_init import (
    kaiming_uniform_,
    linear_default_bias_,
    linear_default_weight_,
)

__all__ = ["kaiming_uniform_", "linear_default_weight_", "linear_default_bias_"]
