"""Training throughput of the port's causal decoder — one JSON line per config.

The counterpart of ``benchmarks/causal_decoder.py::bench_config`` (which
imports jax): the same flags and the same JSON fields, timing a full step of
``CausalDecoder`` — forward, next-token CE of ``logits[:, :-1]`` against
``tokens[:, 1:]``, ``loss.backward()``, ``torch.optim.Adam(1e-3)`` — on one
fixed batch of tokens drawn from ``--seed``. ``impl`` is ``kernel`` (the
model as it runs: the tiled attention kernels past one tile) or ``plain``
(the same weights with every block's attention through
``flash_attention_reference`` on the same device; ``--skip-naive`` drops
it). Run on one card:

    python -m kanvit_torch.bench_decoder --seqs 2048 8192

``--bf16`` is kanvit's policy (``benchmarks/causal_decoder.py:73-80``):
every f32 parameter cast to bf16 for the step (``precision.bf16_params``
into ``torch.func.functional_call``), the forward and backward inside
``precision.f32_accumulation()``, CE on ``logits[:, :-1]`` cast to f32,
f32 master weights and Adam in f32. The tiled tier then runs the bf16
tiled kernels (``plain``: their twins, through ``FA.flash_attention_plain``):

    python -m kanvit_torch.bench_decoder --bf16 --seqs 2048 8192

``--heads`` sets the head count at ``--dim``: ``--bf16 --heads 2`` trains d
256 in 2 heads of 128 (kanvit's ``benchmarks/causal_decoder.py --bf16
--heads 2``) on the bf16 tiled kernels' instantiation padded to 128.

``batch = tokens_per_batch // seq``. ``--device`` (default ``cuda``) is
explicit: with no card the run raises. The timed window of ``--steps``
steps ends in a synchronise; ``loss`` is the last step's. Nothing is written
to disk. ``--ring`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
import torch.nn.functional as F
from torch import nn

from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.models import CausalDecoder
from kanvit_torch.utils import precision


def build_model(dim: int, heads: int, n_blocks: int, vocab: int,
                seed: int = 0) -> CausalDecoder:
    """A ``CausalDecoder`` drawn on the CPU from ``seed``."""
    return CausalDecoder(vocab, dim, heads, n_blocks,
                         generator=torch.Generator().manual_seed(seed))


def make_tokens(batch: int, seq: int, vocab: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, vocab, (batch, seq), generator=g)


def plain_logits(model: CausalDecoder, tokens: torch.Tensor) -> torch.Tensor:
    """``model``'s forward with every block's attention through the tiled
    tier's plain version (``FA.flash_attention_plain``: on bf16 projections
    the bf16 tiled kernels' twins), on whatever device the model lives."""
    x = model.embed(tokens)
    b, t, _ = x.shape
    for blk in model.blocks:
        h, dh = blk.heads, blk.dim_head
        heads = [a.view(b, t, h, dh).transpose(1, 2)
                 for a in (blk.to_q(x), *blk.to_kv(x).chunk(2, dim=-1))]
        o = FA.flash_attention_plain(*heads, True, blk.q_bucket_size, blk.k_bucket_size)
        x = x + blk.to_out(o.transpose(1, 2).reshape(b, t, h * dh))
    return model.lm_head(model.norm(x))


class _Plain(nn.Module):
    """``plain_logits`` of ``model`` as a module's forward, so that
    ``functional_call`` can swap its parameters (named ``model.<name>``)."""

    def __init__(self, model: CausalDecoder):
        super().__init__()
        self.model = model

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return plain_logits(self.model, tokens)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE: ``logits[:, :-1]`` against ``tokens[:, 1:]``, mean."""
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def loss_and_logits(model: CausalDecoder, tokens: torch.Tensor, impl: str = "kernel",
                    bf16: bool = False):
    """``(loss, logits)`` of one forward. ``bf16``: kanvit's policy, a bf16
    copy of every f32 parameter (``precision.bf16_params``, whose gradients
    reach the f32 parameters) into ``torch.func.functional_call``, CE on the
    logits cast to f32; run it, and its backward, inside
    ``precision.f32_accumulation()``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if not bf16:
        logits = model(tokens) if impl == "kernel" else plain_logits(model, tokens)
        return lm_loss(logits, tokens), logits
    params = precision.bf16_params(model)
    if impl == "kernel":
        logits = torch.func.functional_call(model, params, (tokens,))
    else:
        logits = torch.func.functional_call(
            _Plain(model), {f"model.{k}": v for k, v in params.items()}, (tokens,))
    return lm_loss(logits.float(), tokens), logits


def make_step(model: CausalDecoder, impl: str = "kernel", lr: float = 1e-3,
              bf16: bool = False):
    """``step(tokens) -> loss``: one Adam step in place on the f32
    parameters; the loss stays a device tensor. ``bf16``: the step in
    kanvit's bf16 policy (:func:`loss_and_logits`)."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        with precision.f32_accumulation() if bf16 else contextlib.nullcontext():
            loss, _ = loss_and_logits(model, tokens, impl, bf16)
            loss.backward()
        opt.step()
        return loss.detach()

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_config(seq: int, batch: int, dim: int, heads: int, n_blocks: int,
                 vocab: int, steps: int, warmup: int, impl: str,
                 device="cuda", seed: int = 0, bf16: bool = False) -> dict:
    """``warmup`` steps, then one timed window of ``steps`` steps."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False: this bench measures the card, pass "
                           "--device cpu explicitly for a CPU run")
    model = build_model(dim, heads, n_blocks, vocab, seed).to(device)
    tokens = make_tokens(batch, seq, vocab, seed).to(device)
    step = make_step(model, impl, bf16=bf16)
    for _ in range(warmup):
        step(tokens)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else str(device))
    return dict(seq=seq, batch=batch, impl=impl, bf16=bf16, ring=0,
                step_ms=dt / steps * 1000, tokens_per_sec=batch * seq * steps / dt,
                loss=float(loss), device=dev_name)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seqs", type=int, nargs="+", default=[2048, 8192])
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--n-blocks", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--tokens-per-batch", type=int, default=2 ** 15,
                   help="batch = tokens_per_batch // seq (>=1)")
    p.add_argument("--skip-naive", action="store_true",
                   help="time the kernel impl only, not the plain one")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--ring", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; no card raises (no move to the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the tokens")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    if args.ring:
        raise NotImplementedError(
            "ring attention is not ported (ROADMAP.md Queue 1 item 8)")
    if args.steps < 1:
        raise ValueError("--steps must be at least 1")
    results = []
    for seq in args.seqs:
        batch = max(1, args.tokens_per_batch // seq)
        for impl in ["kernel"] if args.skip_naive else ["kernel", "plain"]:
            try:
                r = bench_config(seq, batch, args.dim, args.heads, args.n_blocks,
                                 args.vocab, args.steps, args.warmup, impl,
                                 args.device, args.seed, args.bf16)
            except torch.cuda.OutOfMemoryError as e:
                # The plain impl keeps every score tile for autograd and runs
                # out of memory at long sequences: record it, as the JAX
                # script records its naive path. The kernels never get here.
                if impl != "plain":
                    raise
                torch.cuda.empty_cache()
                r = dict(seq=seq, batch=batch, impl=impl,
                         error=type(e).__name__, detail=str(e)[:200])
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
