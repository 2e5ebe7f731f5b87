"""bf16 serving and training (counterpart of kanvit's ``--bf16`` policy,
``kanvit/train/steps.py:23-31`` and ``benchmarks/inference_serving.py:68-80``).

kanvit casts every f32 parameter to bf16 for a step and keeps its knot
grids, which live outside the param tree, in f32; a refit grid
(``stateful_grid``) is a param there and is rounded with the rest. The port
keeps a ``KANLinear``'s grid as an f32 buffer, flagged ``refit_grid`` when
``kanvit_torch.utils.convert.load_reference_state_dict`` loaded moved knots
into it, and rounds such a grid's values to bf16 (its dtype stays f32, as
the kernels read it). A stateful-grid tree whose knots never moved loads as
uniform knots and stays f32, where kanvit would round them: the port cannot
tell it from a reference checkpoint's saved uniform grid, which kanvit
skips and keeps f32.

cuBLAS may reduce a bf16 GEMM's split-K partials in bf16
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``, on
by default); kanvit accumulates in f32. :func:`f32_accumulation` turns that
off for the span of a bf16 forward (and, in training, its backward) and
restores the caller's setting after, so no global changes for the port's
callers.

:func:`check_bf16_trainable` raises for the models whose kernels have no
bf16 backward yet, before any launch.
"""

from __future__ import annotations

import contextlib

import torch


def _refit_grids(model: torch.nn.Module):
    """``(name, grid)`` of every ``KANLinear`` whose grid was refit."""
    from kanvit_torch.layers.kan import KANLinear

    for name, mod in model.named_modules():
        if isinstance(mod, KANLinear) and mod.refit_grid:
            yield f"{name}.grid" if name else "grid", mod.grid


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A bf16 copy of every f32 parameter of ``model`` (others as they
    are), and each refit grid rounded to bf16 values: the tensors for
    ``torch.func.functional_call`` of a bf16 step, which leaves the model's
    own f32 parameters untouched."""
    out = {name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
           for name, p in model.named_parameters()}
    out.update({name: _round_bf16(g) for name, g in _refit_grids(model)})
    return out


@torch.no_grad()
def cast_params_(model: torch.nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Cast ``model``'s float parameters, and only its parameters, to
    ``dtype`` in place (buffers such as the knot grids and the position
    table stay as they are); at bf16 also round each refit grid's values.
    Returns ``model``."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    if dtype == torch.bfloat16:
        for _, g in _refit_grids(model):
            g.copy_(_round_bf16(g))
    return model


def param_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype of ``model``'s first float parameter (f32 if none)."""
    return next((p.dtype for p in model.parameters() if p.is_floating_point()),
                torch.float32)


@contextlib.contextmanager
def f32_accumulation():
    """cuBLAS bf16 GEMMs with f32 reduction inside the block, the caller's
    setting restored after."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


# The ViT kinds whose KAN kernels have no bf16 path yet.
BF16_UNPORTED = ("cheby", "fourier", "fast", "sine")


def check_bf16_trainable(model: torch.nn.Module) -> None:
    """Raise ``NotImplementedError`` for a model that a bf16 training step
    cannot take: the cheby, fourier, fast and sine ViTs (their KAN kernels
    have no bf16 path: ROADMAP.md, Queue 2 entry 3b.2) and a fused-FF model
    (the fused FF's: entry 3b.4). The efficientkan, vanilla and flash-attn
    ViTs pass."""
    kind = getattr(model, "type", None)
    if kind in BF16_UNPORTED:
        raise NotImplementedError(
            f"bf16 training of the {kind} ViT: its KAN kernels have no bf16 path "
            "(ROADMAP.md, Queue 2 entry 3b.2)")
    if any(getattr(m, "fused_ff", False) for m in model.modules()):
        raise NotImplementedError(
            "bf16 training with fused_ff=True: the fused FF kernels have no bf16 "
            "path (ROADMAP.md, Queue 2 entry 3b.4)")
