"""Train and eval steps (counterpart of ``kanvit/train/steps.py``).

One step: forward, CE mean, ``loss.backward()`` (the backward kernels on the
card, autograd through the plain versions on the CPU) and one update of the
optimizer chain. Loss and logits stay device tensors: a step reads nothing
back to the host, as kanvit's jitted step does not.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from kanvit_torch.train.state import TrainState


def _loss_and_logits(model, x, y, reduce: bool = True):
    logits = model(x)
    loss = F.cross_entropy(logits, y, reduction="mean" if reduce else "none")
    return loss, logits


def make_train_step(bf16: bool = False, grad_accum: int = 1) -> Callable:
    """Returns ``step(state, x, y) -> (state, loss, logits)``.

    ``state`` is updated in place and returned. ``grad_accum > 1`` splits
    the batch into that many chunks, sums their gradients and divides by the
    count before ONE update, as kanvit's ``lax.scan`` does: CE is a
    per-example mean, so it is the full-batch update with one chunk's
    activations. The loss is the mean of the chunk losses.
    """
    if bf16:
        raise NotImplementedError(
            "bf16 training is not ported: the kernels are f32 only, and bf16 "
            "kernels are ROADMAP.md Queue 2 item 5")

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        model, tx = state.model, state.tx
        tx.zero_grad()
        if grad_accum <= 1:
            loss, logits = _loss_and_logits(model, x, y)
            loss.backward()
        else:
            b = x.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum={grad_accum}")
            losses, outs = [], []
            for xi, yi in zip(x.chunk(grad_accum), y.chunk(grad_accum)):
                li, oi = _loss_and_logits(model, xi, yi)
                li.backward()  # .grad sums the chunks
                losses.append(li.detach())
                outs.append(oi.detach())
            with torch.no_grad():
                for p in tx.params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
            loss, logits = torch.stack(losses).mean(), torch.cat(outs)
        tx.step()
        state.step += 1
        return state, loss.detach(), logits.detach()

    return train_step


def make_eval_step(per_example: bool = False) -> Callable:
    """Returns ``step(state, x, y) -> (loss, logits)`` under
    ``torch.inference_mode()``. ``per_example=True`` returns the unreduced
    ``(B,)`` CE vector, so a caller that pads the last batch can slice the
    padding out of the loss."""

    def eval_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        with torch.inference_mode():
            return _loss_and_logits(state.model, x, y, reduce=not per_example)

    return eval_step
