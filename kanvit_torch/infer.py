"""Inference: the batched serving ``Predictor`` (counterpart of
``kanvit/infer.py``).

Images are classified in fixed-size batches on the card unless the caller
names another device (``device="cpu"``), the ragged tail zero-padded so every forward sees the same shape, with the whole
forward under ``torch.inference_mode()``. ``microbatch`` runs each batch as
a plain loop over equal chunks. ``quant="int8"`` serves W8A8 Linear layers
(``kanvit_torch.ops.quant``); :meth:`Predictor.calibrate` pins calibrated
static activation scales. A model whose parameters are bf16
(``kanvit_torch.utils.precision.cast_params_``) serves in bf16, as
``benchmarks/inference_serving.py --bf16`` serves kanvit: images cast to
bf16 on the device, logits returned as f32 (every ViT kind: efficientkan,
cheby, fourier, fast, sine, vanilla and flash-attn), in float or int8 as
``--bf16 --quant int8`` serves it: on ``qdot`` the first int8 Linear turns
the stream f32 and the rest runs in f32 on widened bf16 weights; with the
``int8_linear`` kernel the stream stays bf16 up to the head.

Not ported yet: reading flax msgpack checkpoints, ``export`` and the CLI
(``ROADMAP.md``, Queue 1).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from kanvit_torch.models import create_model
from kanvit_torch.ops import quant as Q
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import load_reference_state_dict


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Predictor:
    """Batched, fixed-shape classifier.

    ``model`` must already live on ``device`` (move it with
    ``model.to(device)``); the Predictor moves nothing behind the caller's
    back and raises on a mismatch.

    ``quant="int8"`` runs every forward under
    ``kanvit_torch.ops.quant.int8_serving``: the Linear layers that run
    (FF pairs, a Linear embedder, the flash-attention projections, the head)
    go W8A8 with dynamic per-tensor scales, or the static ones
    :meth:`calibrate` pins. ``int8_kernel=True`` runs the ``int8_linear``
    kernel (per-row scales) where K and out are multiples of 128, as kanvit
    does when its kernel is switched on (``KANVIT_INT8_KERNEL``); off by
    default, as kanvit's auto mode leaves it.

    A model with bf16 parameters serves in bf16: each batch is copied to
    the device as f32 and cast there, the forward (and a calibration's)
    runs with cuBLAS reducing in f32 (``precision.f32_accumulation``), and
    the logits come back f32. With ``quant="int8"`` it follows kanvit's
    dtypes: ``qdot`` returns f32, so the first Linear on it turns the stream
    f32 and every later layer widens its bf16 weights
    (``precision.promote``); ``int8_linear`` returns bf16 on bf16 x, so with
    the kernel the stream stays bf16 where every Linear takes it.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 256,
                 microbatch: int | None = None, *, device="cuda",
                 quant: str | None = None, int8_kernel: bool = False):
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (int8)")
        self.model = model
        self.batch_size = batch_size
        self.microbatch = microbatch
        self.quant = quant
        self.int8_kernel = int8_kernel
        self.scales: dict[str, float] | None = None
        self.device = _resolve(device)
        placed = {t.device for t in (*model.parameters(), *model.buffers())}
        if placed != {self.device}:
            raise ValueError(f"model lives on {sorted(map(str, placed))}, "
                             f"not on {self.device}: call model.to(device) first")
        self.dtype = precision.param_dtype(model)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        mb = self.microbatch
        if mb and mb < self.batch_size and self.batch_size % mb == 0:
            return torch.cat([self.model(c) for c in x.split(mb)]).float()
        return self.model(x).float()

    def _batches(self, images: np.ndarray):
        """Each ``batch_size`` chunk of ``images`` on the device, the tail
        zero-padded, with the number of real images in it."""
        for lo in range(0, images.shape[0], self.batch_size):
            chunk = np.ascontiguousarray(images[lo:lo + self.batch_size],
                                         dtype=np.float32)
            real = chunk.shape[0]
            if real < self.batch_size:
                chunk = np.concatenate([chunk, np.zeros(
                    (self.batch_size - real, *chunk.shape[1:]), np.float32)])
            yield torch.from_numpy(chunk).to(self.device).to(self.dtype), real

    def _float(self):
        """The float forward's context: f32 reduction for a bf16 model."""
        if self.dtype == torch.bfloat16:
            return precision.f32_accumulation()
        return contextlib.nullcontext()

    def _serving(self):
        stack = contextlib.ExitStack()
        stack.enter_context(self._float())
        if self.quant == "int8":
            stack.enter_context(Q.int8_serving(self.model, self.scales,
                                               kernel=self.int8_kernel))
        return stack

    def calibrate(self, images: np.ndarray, max_batches: int = 2) -> dict:
        """Record each Linear layer's input max over float forwards of up to
        ``max_batches`` batches of ``images`` (tails zero-padded, as kanvit
        pads them), pin them as static int8 scales and return the scales,
        ``{module name: scale}``."""
        if self.quant != "int8":
            raise ValueError("calibrate() only applies to quant='int8'")
        n = min(len(images), self.batch_size * max_batches)
        with torch.inference_mode(), self._float(), Q.calibrating(self.model) as amax:
            for x, _ in self._batches(images[:n]):
                self._forward(x)
        self.scales = Q.scales_from_amax(amax)
        return self.scales

    def logits(self, images: np.ndarray) -> np.ndarray:
        """``(N, C, H, W) -> (N, out_d)`` float32; the tail batch is
        zero-padded so every forward has ``batch_size`` images."""
        out = []
        with torch.inference_mode(), self._serving():
            for x, real in self._batches(images):
                out.append(self._forward(x)[:real].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,))

    def predict(self, images: np.ndarray):
        """Returns ``(labels (N,), probabilities (N, out_d))``."""
        z = self.logits(images).astype(np.float64)
        z = z - z.max(-1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
        return probs.argmax(-1), probs


def load_predictor(
    model_type: str,
    state_dict_npz: str,
    *,
    device="cuda",
    chw=(1, 28, 28),
    n_patches=7,
    n_blocks=8,
    d_hidden=64,
    n_heads=8,
    out_d=10,
    batch_size=256,
    microbatch=None,
    quant=None,
) -> Predictor:
    """A Predictor over weights in reference naming, read from an ``.npz``
    (what ``python -m kanvit.utils.torch_compat --ckpt-dir ckpts --out
    sd.npz`` writes). Defaults mirror ``kanvit.infer.load_predictor``."""
    model = create_model(
        model_type, chw=chw, n_patches=n_patches, n_blocks=n_blocks,
        d_hidden=d_hidden, n_heads=n_heads, out_d=out_d,
    )
    with np.load(state_dict_npz) as data:
        load_reference_state_dict(model, {k: data[k] for k in data.files})
    return Predictor(model.to(device), batch_size, microbatch, device=device,
                     quant=quant)
