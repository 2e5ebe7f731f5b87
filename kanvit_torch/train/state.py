"""Optimizer and train state (counterpart of ``kanvit/train/state.py``).

The reference trains with ``torch.optim.Adam(lr)``, CE loss and no
schedule, decay or clipping (reference ``train.py:22-23``).
:func:`make_optimizer` keeps kanvit's optax chain, argument for argument:
an optional global-norm clip, Adam or AdamW (``torch.optim``) under a
``LambdaLR`` schedule, and an optional EMA of the post-step params.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping

import torch


def lr_multiplier(lr_schedule: str = "constant", warmup_steps: int = 0,
                  total_steps: int | None = None) -> Callable[[int], float]:
    """The schedule as a multiple of the peak learning rate at step count
    ``c`` (0 for the first update, as optax and ``LambdaLR`` both count).

    ``constant``: linear warmup from 0 over ``warmup_steps``, then 1.
    ``cosine``: the same warmup, then cosine decay to 0 at ``total_steps``
    (optax ``warmup_cosine_decay_schedule`` with ``end_value=0``).
    """
    w = max(0, warmup_steps)

    def warm(c: int) -> float:
        return min(c, w) / w

    if lr_schedule == "constant":
        if w == 0:
            return lambda c: 1.0
        return lambda c: warm(c) if c < w else 1.0
    if lr_schedule == "cosine":
        if not total_steps:
            raise ValueError("--lr-schedule cosine needs a known total step "
                             "count (epochs x steps/epoch)")
        if warmup_steps >= total_steps:
            raise ValueError(
                f"--warmup-steps ({warmup_steps}) must be < the total step "
                f"count ({total_steps}) under --lr-schedule cosine — there "
                "would be no decay phase left"
            )
        decay = total_steps - w

        def cosine(c: int) -> float:
            if c < w:
                return warm(c)
            t = min(c - w, decay) / decay
            return 0.5 * (1.0 + math.cos(math.pi * t))

        return cosine
    raise ValueError(f"unknown lr_schedule {lr_schedule!r} (constant|cosine)")


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: ``g`` if ``||g|| < c``, else
    ``g / ||g|| * c``. (``torch.nn.utils.clip_grad_norm_`` scales by
    ``c / (||g|| + 1e-6)`` instead, which differs.)"""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))  # optax.global_norm
    keep = norm < max_norm
    for g in grads:
        # where() keeps the unclipped bits exactly; the clipped branch divides
        # then multiplies, as optax does. No .item(): the step stays on the
        # device.
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class OptimizerChain:
    """kanvit's optimizer chain over named parameters.

    ``step()`` reads each parameter's ``.grad``: clip (if any), then one
    Adam/AdamW update at the scheduled rate, then the EMA (if any).
    ``zero_grad()`` clears the gradients. ``ema`` maps each name to its
    shadow tensor, or is None without ``ema_decay``.
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 learning_rate: float, multiplier: Callable[[int], float],
                 weight_decay: float, clip_grad_norm: float,
                 ema_decay: float):
        self.params: Dict[str, torch.Tensor] = dict(params)
        tensors = list(self.params.values())
        if weight_decay > 0:
            self.optim = torch.optim.AdamW(tensors, lr=learning_rate,
                                           weight_decay=weight_decay)
        else:
            self.optim = torch.optim.Adam(tensors, lr=learning_rate)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optim,
                                                           multiplier)
        self.clip_grad_norm = clip_grad_norm
        self.ema_decay = ema_decay
        self.ema = ({k: p.detach().clone() for k, p in self.params.items()}
                    if ema_decay > 0 else None)

    def zero_grad(self) -> None:
        self.optim.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.clip_grad_norm > 0:
            grads = [p.grad for p in self.params.values() if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_grad_norm)
        self.optim.step()
        self.scheduler.step()
        if self.ema is not None:
            d = self.ema_decay
            for k, p in self.params.items():
                self.ema[k].copy_(d * self.ema[k] + (1.0 - d) * p)


def make_optimizer(
    params: Mapping[str, torch.Tensor],
    learning_rate: float = 1e-3,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int | None = None,
    weight_decay: float = 0.0,
    clip_grad_norm: float = 0.0,
    ema_decay: float = 0.0,
) -> OptimizerChain:
    """The canonical optimizer (reference ``torch.optim.Adam(lr)``), with
    ``kanvit.train.state.make_optimizer``'s arguments and semantics.

    ``params``: name -> parameter (``dict(model.named_parameters())``).
    Schedules: ``constant`` with optional linear ``warmup_steps``, or
    ``cosine`` (linear warmup then cosine decay to 0 over ``total_steps``,
    which must exceed ``warmup_steps``). ``weight_decay`` > 0 switches Adam
    to AdamW (decoupled decay). ``clip_grad_norm`` > 0 clips gradients by
    global norm before the Adam moments see them, with optax's formula.
    ``ema_decay`` > 0 keeps a shadow EMA of the post-step params
    (``OptimizerChain.ema``).
    """
    return OptimizerChain(params, learning_rate,
                          lr_multiplier(lr_schedule, warmup_steps, total_steps),
                          weight_decay, clip_grad_norm, ema_decay)


@dataclass
class TrainState:
    """The model, its optimizer chain and the count of updates applied."""

    model: torch.nn.Module
    tx: OptimizerChain
    step: int = 0


def create_train_state(model: torch.nn.Module, learning_rate: float = 1e-3,
                       lr_schedule: str = "constant", warmup_steps: int = 0,
                       total_steps: int | None = None,
                       weight_decay: float = 0.0, clip_grad_norm: float = 0.0,
                       ema_decay: float = 0.0) -> TrainState:
    """A TrainState over an already initialised ``model`` (the port draws
    its weights in ``create_model``), with :func:`make_optimizer` over its
    named parameters."""
    tx = make_optimizer(dict(model.named_parameters()), learning_rate,
                        lr_schedule, warmup_steps, total_steps, weight_decay,
                        clip_grad_norm, ema_decay)
    return TrainState(model=model, tx=tx)
