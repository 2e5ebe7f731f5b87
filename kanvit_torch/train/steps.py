"""Train and eval steps (counterpart of ``kanvit/train/steps.py``).

One step: forward, CE mean, ``loss.backward()`` (the backward kernels on the
card, autograd through the plain versions on the CPU) and one update of the
optimizer chain. Loss and logits stay device tensors: a step reads nothing
back to the host, as kanvit's jitted step does not.

``bf16=True`` is kanvit's policy (``kanvit/train/steps.py:23-31``): every
f32 parameter cast to bf16 for the step (``torch.func.functional_call`` over
a bf16 copy, the module's f32 parameters untouched), ``x`` cast to bf16,
the logits cast to f32 before CE, cuBLAS reducing in f32 in the forward and
the backward (``kanvit_torch.utils.precision``). In training the gradients
come back through the casts to the f32 parameters, whose ``.grad`` is f32,
and the optimizer runs in f32. The casts are a fixed number of operations
a step, forward and backward (``precision.bf16_params``). A bf16 training
step takes every ViT kind, with or without the fused FF
(``precision.check_bf16_trainable``).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from kanvit_torch.train.state import TrainState
from kanvit_torch.utils import precision


def _loss_and_logits(model, x, y, bf16: bool = False, reduce: bool = True):
    if bf16:
        params = precision.bf16_params(model)
        with precision.f32_accumulation():
            logits = torch.func.functional_call(model, params, (x.to(torch.bfloat16),))
        logits = logits.float()
    else:
        logits = model(x)
    loss = F.cross_entropy(logits, y, reduction="mean" if reduce else "none")
    return loss, logits


def make_train_step(bf16: bool = False, grad_accum: int = 1) -> Callable:
    """Returns ``step(state, x, y) -> (state, loss, logits)``.

    ``state`` is updated in place and returned. ``grad_accum > 1`` splits
    the batch into that many chunks, sums their gradients and divides by the
    count before ONE update, as kanvit's ``lax.scan`` does: CE is a
    per-example mean, so it is the full-batch update with one chunk's
    activations. The loss is the mean of the chunk losses. ``bf16=True``:
    kanvit's bf16 policy (above), for the models it takes.
    """

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        model, tx = state.model, state.tx
        if bf16:
            precision.check_bf16_trainable(model)
        tx.zero_grad()
        with precision.f32_accumulation() if bf16 else contextlib.nullcontext():
            if grad_accum <= 1:
                loss, logits = _loss_and_logits(model, x, y, bf16)
                loss.backward()
            else:
                b = x.shape[0]
                if b % grad_accum:
                    raise ValueError(
                        f"batch {b} not divisible by grad_accum={grad_accum}")
                losses, outs = [], []
                for xi, yi in zip(x.chunk(grad_accum), y.chunk(grad_accum)):
                    li, oi = _loss_and_logits(model, xi, yi, bf16)
                    li.backward()  # the f32 .grad sums the chunks
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


def make_eval_step(bf16: bool = False, per_example: bool = False) -> Callable:
    """Returns ``step(state, x, y) -> (loss, logits)`` under
    ``torch.inference_mode()``, the logits f32. ``bf16=True`` runs the
    forward in bf16 (kanvit's policy, above). ``per_example=True`` returns
    the unreduced ``(B,)`` CE vector, so a caller that pads the last batch
    can slice the padding out of the loss."""

    def eval_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        with torch.inference_mode():
            return _loss_and_logits(state.model, x, y, bf16, reduce=not per_example)

    return eval_step
