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

A bf16 step casts every f32 parameter in a fixed number of operations,
whatever the parameter count (:func:`bf16_params`): the f32 parameters are
re-pointed once as views of one flat f32 buffer (the parameter objects,
their names and the optimizer's state stay), so the forward is one cast of
that buffer into a flat bf16 buffer whose views feed
``torch.func.functional_call``; the backward gathers the views' bf16
gradients into one flat buffer (``torch.cat``) and casts it once to f32,
whose views become the parameters' ``.grad``. The values are kanvit's: bf16
of each f32 parameter forward, f32 of each bf16 gradient back, bit for bit
what a cast of each parameter gives.

Where a bf16 model's parameters meet f32 activations, :func:`promote`
widens them exactly to f32 and the f32 route runs, as JAX's promotion does
in kanvit. That happens under int8 serving: ``qdot`` returns f32, so the
first Linear on it turns the residual stream to f32 (the vanilla and
flash-attn embedder, a KAN ViT's first FF), and every later LayerNorm, q/k/v
projection, attention and FF runs in f32 on widened bf16 weights; on the
kernel route ``int8_linear`` returns x's dtype and the stream stays bf16 up
to the head. The kernel wrappers stay strict: only the layers widen.

bf16 serving and training take every ViT kind (efficientkan, cheby,
fourier, fast, sine, vanilla, flash-attn), with or without the fused FF
(``fused_ff=True``); :func:`check_bf16_trainable` would raise, before any
launch, for a ViT kind whose kernels had no bf16 path (none has). The causal decoder's bf16 step
(``kanvit_torch.bench_decoder --bf16``) takes :func:`bf16_params` and
:func:`f32_accumulation` the same way; its embedding's bf16 weight makes
bf16 activations, as flax ``nn.Embed`` does on a bf16 table.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def _refit_grids(model: torch.nn.Module):
    """``(name, grid)`` of every ``KANLinear`` whose grid was refit."""
    from kanvit_torch.layers.kan import KANLinear

    for name, mod in model.named_modules():
        if isinstance(mod, KANLinear) and mod.refit_grid:
            yield f"{name}.grid" if name else "grid", mod.grid


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _FlatF32:
    """A model's f32 parameters as views of one flat f32 buffer: the
    parameter objects and the data pointers that say whether they still are
    those views."""

    def __init__(self, params: list[torch.Tensor]):
        self.params = params
        with torch.no_grad(), torch.inference_mode(False):
            self.flat = _flatten_dense_tensors([p.detach() for p in params])
            for p, view in zip(params, _unflatten_dense_tensors(self.flat, params)):
                p.data = view
        self.ptrs = self._ptrs(params)

    @staticmethod
    def _ptrs(params) -> tuple:
        return tuple(p.data_ptr() for p in params)

    def holds(self, params: list[torch.Tensor]) -> bool:
        return (len(params) == len(self.params)
                and all(p is q for p, q in zip(params, self.params))
                and self._ptrs(params) == self.ptrs)


# The flat buffer of each model whose f32 parameters a bf16 step re-pointed
# (weak: it goes with the model).
_FLAT: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _flat_f32(model: torch.nn.Module, params: list[torch.Tensor]) -> _FlatF32:
    """``model``'s f32 ``params`` as views of one flat buffer: the kept one
    while they still are its views, else a new one (the first bf16 step, or
    after ``.to()``, ``copy.deepcopy`` or an assignment to a ``.data``)."""
    flat = _FLAT.get(model)
    if flat is None or not flat.holds(params):
        flat = _FLAT[model] = _FlatF32(params)
    return flat


class _Bf16Cast(torch.autograd.Function):
    """bf16 copies of the f32 parameters ``params``, views of the flat
    buffer ``flat``: forward one cast of the buffer, the copies its views;
    backward the copies' bf16 gradients gathered into one flat buffer (one
    ``torch.cat``), one cast to f32, each parameter's gradient a view of it.
    The views are made and gathered in C++ (``torch._utils``' dense-tensor
    flattening), a few microseconds of host a parameter."""

    @staticmethod
    def forward(ctx, flat, *params):
        ctx.params = params
        return tuple(_unflatten_dense_tensors(flat.to(torch.bfloat16), params))

    @staticmethod
    def backward(ctx, *grads):
        g32 = _flatten_dense_tensors(grads).float()
        return (None, *_unflatten_dense_tensors(g32, ctx.params))


def bf16_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A bf16 copy of every f32 parameter of ``model`` (others as they
    are), and each refit grid rounded to bf16 values: the tensors for
    ``torch.func.functional_call`` of a bf16 step, which leaves the values
    of the model's own f32 parameters untouched. The f32 parameters become
    views of one flat buffer the first time, and the casts are one
    operation forward and a gather and one cast backward (the module
    docstring); gradients reach each f32 parameter's ``.grad`` as f32."""
    named = list(model.named_parameters())
    out = dict(named)
    f32 = [(name, p) for name, p in named if p.dtype == torch.float32]
    if f32:
        params = [p for _, p in f32]
        flat = _flat_f32(model, params)
        casts = _Bf16Cast.apply(flat.flat, *params)
        out.update(zip((name for name, _ in f32), casts))
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


def promote(x: torch.Tensor, *params):
    """``params`` as they meet the activations ``x``, by kanvit's promotion:
    where x is f32, each bf16 parameter widened exactly to f32 (a new
    tensor; autograd flows through the cast); every other mix, and None, as
    it is. Returns a tuple, one entry a parameter."""
    if x.dtype != torch.float32:
        return params
    return tuple(p.float() if p is not None and p.dtype == torch.bfloat16 else p
                 for p in params)


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


# The ViT kinds whose KAN kernels have no bf16 path yet: none (the fourier
# ViT's last, ROADMAP.md Queue 2 entry 3b.2).
BF16_UNPORTED = ()


def check_bf16_trainable(model: torch.nn.Module) -> None:
    """Raise ``NotImplementedError`` for a model that a bf16 training step
    cannot take: a ViT kind in ``BF16_UNPORTED``. None is: every model
    passes, the efficientkan, cheby, fourier, fast, sine, vanilla and
    flash-attn ViTs, each with or without the fused FF."""
    kind = getattr(model, "type", None)
    if kind in BF16_UNPORTED:
        raise NotImplementedError(
            f"bf16 training of the {kind} ViT: its KAN kernels have no bf16 path "
            "(ROADMAP.md, Queue 2 entry 3b)")
