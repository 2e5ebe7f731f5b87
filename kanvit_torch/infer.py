"""Inference: the batched serving ``Predictor`` (counterpart of
``kanvit/infer.py``).

Images are classified in fixed-size batches on the card unless the caller
names another device (``device="cpu"``), the ragged tail zero-padded so every forward sees the same shape, with the whole
forward under ``torch.inference_mode()``. ``microbatch`` runs each batch as
a plain loop over equal chunks.

Not ported yet: reading flax msgpack checkpoints, int8 serving, ``export``
and the CLI (``ROADMAP.md``, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from kanvit_torch.models import create_model
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
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 256,
                 microbatch: int | None = None, *, device="cuda"):
        self.model = model
        self.batch_size = batch_size
        self.microbatch = microbatch
        self.device = _resolve(device)
        placed = {t.device for t in (*model.parameters(), *model.buffers())}
        if placed != {self.device}:
            raise ValueError(f"model lives on {sorted(map(str, placed))}, "
                             f"not on {self.device}: call model.to(device) first")

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        mb = self.microbatch
        if mb and mb < self.batch_size and self.batch_size % mb == 0:
            return torch.cat([self.model(c) for c in x.split(mb)])
        return self.model(x)

    def logits(self, images: np.ndarray) -> np.ndarray:
        """``(N, C, H, W) -> (N, out_d)`` float32; the tail batch is
        zero-padded so every forward has ``batch_size`` images."""
        n = images.shape[0]
        out = []
        with torch.inference_mode():
            for lo in range(0, n, self.batch_size):
                chunk = np.ascontiguousarray(images[lo:lo + self.batch_size],
                                             dtype=np.float32)
                pad = self.batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad, *chunk.shape[1:]), np.float32)])
                y = self._forward(torch.from_numpy(chunk).to(self.device))
                out.append(y[: self.batch_size - pad].cpu().numpy())
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
    return Predictor(model.to(device), batch_size, microbatch, device=device)
