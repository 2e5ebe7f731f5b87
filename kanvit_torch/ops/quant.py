"""int8 serving quantization (counterpart of ``kanvit/ops/quant.py``).

Forward-only serving can run the Linear layers (``TorchLinear``: the FF
pairs, a Linear patch embedder, the flash-attention block's projections and
the classifier head) W8A8:

- weights: symmetric per-output-channel int8 (scale = max|w_row| / 127);
- activations: symmetric int8, per tensor with a scale computed per call
  (:func:`qdot`), or with a static scale from calibration, or per row
  (:func:`qdot_rowwise`, the plain version of the ``int8_linear`` kernel);
- the products in exact int32, dequantized in f32.

x and W may be f32 or bf16: each is quantized from its exact f32 cast, and
:func:`qdot` and :func:`qdot_rowwise` return f32 either way, as kanvit's do
(``int8_linear`` rounds its result to x's dtype).

The int32 products are exact: ``torch._int_mm`` (on the card padded to its
shape rules). An f32 product of the int8 values would not be: 127 * 127 * K
passes 2**24 at K = 1,041, and the FF's second Linear has K 1,536.

The switches are context managers over ``contextvars``, read when a layer
runs (eager PyTorch has no trace time): :func:`int8_serving` turns the Linear
layers of a model to int8, with calibrated static scales where there are
some and the ``int8_linear`` kernel where it applies; :func:`calibrating`
records each Linear layer's input max through forward hooks, where kanvit's
flax layers ``sow`` it. KAN bases, LayerNorms and the attention stay float:
in the model's dtype, or in f32 on widened bf16 weights once a ``qdot``
has turned a bf16 model's stream f32 (``kanvit_torch.utils.precision.
promote``).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

EPS = 1e-12
QMAX = 127


@dataclass(frozen=True)
class _Serving:
    kernel: bool = False
    scales: dict = field(default_factory=dict)  # module -> static scale


_INT8_SERVING: contextvars.ContextVar[_Serving | None] = contextvars.ContextVar(
    "kanvit_torch_int8_serving", default=None)


def int8_enabled() -> bool:
    """True inside :func:`int8_serving`."""
    return _INT8_SERVING.get() is not None


def kernel_enabled() -> bool:
    """True inside ``int8_serving(kernel=True)``: a Linear whose K and out
    are multiples of 128 runs the ``int8_linear`` kernel."""
    serving = _INT8_SERVING.get()
    return serving is not None and serving.kernel


def static_scale_for(layer: torch.nn.Module) -> float | None:
    """The calibrated activation scale of ``layer`` (None = dynamic)."""
    serving = _INT8_SERVING.get()
    return None if serving is None else serving.scales.get(layer)


@contextlib.contextmanager
def int8_serving(model: torch.nn.Module | None = None,
                 scales: dict[str, float] | None = None, kernel: bool = False):
    """Run the Linear layers called inside this context W8A8.

    ``scales``: static activation scales by module name in ``model`` (from
    :func:`scales_from_amax`); layers without one take a dynamic per-call
    scale. ``kernel``: run the ``int8_linear`` kernel (per-row scales) where
    K and out are multiples of 128, as kanvit's kernel path does.
    """
    by_layer = {}
    if scales:
        if model is None:
            raise ValueError("static scales need the model whose layers they name")
        modules = dict(model.named_modules())
        unknown = sorted(set(scales) - set(modules))
        if unknown:
            raise KeyError(f"scales name no layer of the model: {unknown}")
        by_layer = {modules[name]: s for name, s in scales.items()}
    token = _INT8_SERVING.set(_Serving(kernel, by_layer))
    try:
        yield
    finally:
        _INT8_SERVING.reset(token)


@contextlib.contextmanager
def calibrating(model: torch.nn.Module):
    """Record ``max|x|`` of every Linear layer's input over the forward
    passes run inside this context (forward pre-hooks, one on each
    ``TorchLinear``, a bf16 input's max taken in bf16 and widened, which is
    exact); yields a dict that holds ``{module name: amax}`` once the
    context exits. A layer that never runs (the q/k/v of an MSA, whose
    weights the batched projection reads, or a fused FF pair) records
    nothing, as in kanvit."""
    from kanvit_torch.layers.kan import TorchLinear

    running: dict[str, torch.Tensor] = {}

    def record(name):
        def hook(module, args):
            m = args[0].detach().abs().amax().float()
            running[name] = m if name not in running else torch.maximum(running[name], m)
        return hook

    handles = [mod.register_forward_pre_hook(record(name))
               for name, mod in model.named_modules() if isinstance(mod, TorchLinear)]
    amax: dict[str, float] = {}
    try:
        yield amax
    finally:
        for h in handles:
            h.remove()
        amax.update({k: float(v) for k, v in running.items()})


def scales_from_amax(amax: dict) -> dict:
    """Per-layer symmetric int8 activation scales from calibration maxima."""
    return {k: max(v, EPS) / 127.0 for k, v in amax.items()}


def _quantize(a: torch.Tensor, dim: int | None):
    """Symmetric int8 quantization along ``dim`` (None = per tensor).
    Returns ``(q int8, scale f32)`` with ``a ~= q * scale``; the scale keeps
    the reduced dim (size 1) when ``dim`` is given."""
    a32 = a.float()
    amax = a32.abs().amax() if dim is None else a32.abs().amax(dim, keepdim=True)
    # 127 as a tensor on amax's device: CUDA divides by a Python scalar as a
    # product with its reciprocal, an ulp off the IEEE quotient the kernel
    # (and the CPU, and kanvit) computes
    scale = amax.clamp_min(EPS) / amax.new_tensor(127.0)
    return _round_clip(a32, scale), scale


def _round_clip(a32: torch.Tensor, scale) -> torch.Tensor:
    return torch.round(a32 / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def int_mm(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """Exact ``aq @ bq.T`` in int32 for int8 ``aq (n, k)`` and ``bq (out,
    k)``. On the card ``torch._int_mm`` wants more than 16 rows and k and
    out multiples of 8: the operands are padded with zeros, which add
    nothing, and the result cut back."""
    n, k = aq.shape
    out = bq.shape[0]
    if aq.device.type != "cuda":
        return torch._int_mm(aq, bq.t())
    kp, op, np_ = -(-k // 8) * 8, -(-out // 8) * 8, max(n, 17)
    a = F.pad(aq, (0, kp - k, 0, np_ - n)) if (kp, np_) != (k, n) else aq
    b = F.pad(bq, (0, kp - k, 0, op - out)) if (kp, op) != (k, out) else bq
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:n, :out]


def qdot_rowwise(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w.T (+ bias)`` with per-row activation scales and
    per-output-channel weight scales: ``(xq @ wq.T) * sx * sw (+ bias)`` in
    f32, each product and the sum rounded in that order, for f32 or bf16
    ``x``, ``w`` and ``bias``. kanvit's ``qdot_rowwise``; rounded once to
    x's dtype, the plain version of the ``int8_linear`` kernel."""
    k = x.shape[-1]
    xq, sx = _quantize(x.reshape(-1, k), dim=-1)  # (n, k), (n, 1)
    wq, sw = _quantize(w, dim=-1)                 # (out, k), (out, 1)
    y = int_mm(xq, wq).float() * sx * sw.reshape(1, -1)
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.reshape(*x.shape[:-1], w.shape[0])


def qdot(x: torch.Tensor, w: torch.Tensor,
         static_scale: float | None = None) -> torch.Tensor:
    """``x @ w.T`` with both operands quantized to int8 and an exact int32
    product: ``(xq @ wq.T) * (sx * sw)`` in f32. ``x`` is quantized per
    tensor with a scale computed per call, or with ``static_scale`` (from
    calibration, rounded to f32); ``w (out, in)`` per output channel. f32
    out for f32 or bf16 operands."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if static_scale is not None:
        sx = torch.tensor(static_scale, dtype=torch.float32, device=x.device)
        xq = _round_clip(x2.float(), sx)
    else:
        xq, sx = _quantize(x2, dim=None)
    wq, sw = _quantize(w, dim=-1)
    y = int_mm(xq, wq).float() * (sx * sw.reshape(-1))
    return y.reshape(*x.shape[:-1], w.shape[0])
