"""Training (counterpart of ``kanvit/train``): the optimizer chain and the
train and eval steps. The epoch loop, checkpoints and the CLI are not ported
yet (``ROADMAP.md``, Queue 1 item 6)."""

from kanvit_torch.train.state import (
    OptimizerChain,
    TrainState,
    create_train_state,
    make_optimizer,
)
from kanvit_torch.train.steps import make_eval_step, make_train_step

__all__ = [
    "OptimizerChain",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
