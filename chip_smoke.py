"""Drive the kanvit_torch serving and training paths on one NVIDIA GPU and
check them.

Run from the root of a kanvit checkout on a machine with a CUDA device and
the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero:

1. toolchain and card: torch, CUDA and nvcc versions, the card's name and
   power limit; no CUDA device is an error, never a fall-back to the CPU;
2. build the CUDA kernels from ``kanvit_torch/kernels/csrc`` (nvcc, one
   process per source, all started together), with each kernel's registers
   and spills and the SASS instruction mix of the tensor-core kernels: the
   lanes and the tiled attention's at dh 64, the fused FF's at D 384 and
   its tiled route's first product, the Fourier and sine forward and dW
   kernels and the grouped B-spline q/k/v backward's dW and dx (HMMA
   against the rest, cuobjdump; a report, not a gate);
3. each forward kernel against its plain PyTorch version on the card, at
   the vit-s path's shapes (batch 64) and at a ragged narrow shape, with
   error and time (CUDA events) of both; the grouped q/k/v also at nin 8
   and with refit grids a head at vit-s, the lanes attention also at the
   reference geometry's head dim 8 (MNIST 50 and CIFAR 17 tokens, 8 heads,
   batch 64) and at head dims 40 and 128 (the generic kernels), causal,
   masked and with a fully masked item; each lanes forward also against f64
   on the card (within 1e-6 x max(1, max|o|) at the tensor-core head dims)
   and repeated for the same bits; the lanes kernels and
   ``scaled_dot_product_attention`` also by their kernels' device time
   (``torch.profiler``);
4. each backward kernel against autograd through its plain version on the
   card, at the same shapes (the attention also causal, masked and with a
   fully masked row), with error and time of both, the backward's bits
   repeated for the grouped q/k/v and the lanes attention; the grouped
   q/k/v backward (dx and dW on the tensor cores, 3xTF32) also no further
   from f64 than twice the plain f32 version, with its kernels' device time
   and the CUDA-core kernels' time on the same operands beside it;
5. the tiled attention's forward, dq and dk/dv kernels against
   ``flash_attention_reference`` and autograd through it, at the causal
   decoder's shapes (B 16, H 4, T 2048 and B 4, H 4, T 8192, dh 64) and at
   ragged masked shapes whose rows see no valid key (``tq < tk`` and keys
   0-3 masked, also at head dims 8, 40 and 128), with error and time of
   both, each kernel's and ``scaled_dot_product_attention``'s device time,
   and the bits of a repeated forward and backward; the forward at dh 64,
   seq 2048 also against f64 on the card (1e-6 x max(1, max|o|)); then
   ``flash_attention``'s single-tile route against ``lanes_attention``,
   forward and backward, with its device time;
5b. the tiled attention's three bf16 kernels (kanvit's bf16 policy: the
   f32 scale after the product, p and ds rounded to bf16 at their
   products) against their plain twins on the card at the decoder's shapes
   and layout (B 16, H 4, T 2048 and B 4, H 4, T 8192, dh 64, causal) and
   at ragged masked shapes at dh 32, 16, 8 and 64 (``tq < tk``, keys 0-3
   masked, an item with every key masked, not causal): o within one bf16
   ulp plus the two-sided p term (2^-7 of the twin's attention over |v|:
   the kernel rounds p against its own 32-key tiles' running max), the
   forward's (m, l), each gradient within one ulp plus one of each rounded
   p and ds; rows that see no valid key the mean of v; bits repeated; the
   forward at seq 2048 no further from f64 than twice the twin; each
   kernel's time (CUDA events, device), the twin's and
   ``scaled_dot_product_attention``'s in bf16 (forward, backward to q, to
   k and v, and to all three);
6. the Chebyshev and Fourier kernels (forward, dx and dW) against their
   plain versions and autograd through them on the card: ``chebykan`` and
   ``fourierkan`` (grid 28) at the vit-s embedder's shapes (12,544 x 768
   -> 384), ``cheby_qkv_grouped`` at the vit-s q/k/v (12,608 tokens, 6
   heads of 64 -> 192), ragged narrow shapes of each, inputs where tanh
   saturates (|x| >= 9.5) and Fourier inputs up to |x| = 10; the backward's
   bits repeated; error and time of both; ``fourierkan``'s tensor-core
   forward and dW and ``chebykan``'s tensor-core forward and backward also
   on the training path's backward (no dx, its bits those of the
   all-gradients route) and, at the embedder, no further from f64 than
   twice the plain f32 version, with their kernels' device times
   (``chebykan``'s beside the CUDA-core kernels'); ``chebykan``'s forward
   also without saturated x, at one vit-s image and the MNIST shape, its
   bits repeated and an image's rows with the batch's bits;
7. the RBF and sine kernels (forward, and the backward: dx, dW, the
   LayerNorm's dgamma and dbeta, sine's dfreq) against their plain versions
   and autograd through them: ``fastkan`` and ``sinekan`` (grid 28) at the
   vit-s embedder's shapes, ``fastkan_qkv_grouped`` and
   ``sinekan_qkv_grouped`` (grid 4) at one vit-s q/k/v projection, ragged
   narrow shapes of each (nin 16, d_head 32, odd N), inputs where silu, the
   RBF and the LayerNorm saturate (|x| up to 60, a constant row) and sine
   arguments of several pi; the sine embedder's gradients also against f64,
   and its tensor-core forward, dW and dfreq (on both backward routes) no
   further from f64 than twice the plain f32 version, with device times;
   ``fastkan``'s tensor-core forward so too, also with a third of x at |x|
   20-60, at one vit-s image and the MNIST shape, an image's rows with the
   batch's bits, beside the CUDA-core kernel; the backward's bits
   repeated; error and time of both;
8. the fused pre-LN FF (``ffn_pre_ln``, forward and backward) and the W8A8
   ``int8_linear`` against their plain versions and autograd through them:
   at vit-s (12,608 rows, D 384, F 1,536; the embedder and both FF
   Linears) and ragged shapes (odd N, D 100), the FF also past D 512 (its
   tiled route) at vit-b's and vit-l's widths (D 768, F 3,072; D 1,024, F
   4,096) at vit-s's rows and at D 2,048, each forward also against f64 on
   the card, ``int8_linear`` within
   kanvit's tie-aware bound and with no element differing at all (also at
   vit-b's FF2, the deepest K and a strided x),
   the FF's ReLU pattern held to the plain version's up to rounding,
   the FF forwards also against f64 on the card (within 1e-6 x
   max(1, max|y|)), and ``int8_linear`` at the TPU probe's (n, 768) x
   (768, 3072); the backward's bits repeated; times of the kernels (CUDA
   events, and the FF's by its kernels' device time), the plain versions
   and the library calls (``F.layer_norm`` + cuBLAS ``F.linear``;
   ``torch._int_mm`` with its quantize and dequantize passes, and f32
   ``F.linear``), and the card's ``mma.sync`` TF32 rate, the FF kernels'
   instruction (``csrc/mma_rate_probe.cu``); then ``int8_linear`` on bf16
   x, W and bias (its bf16 kernel) against its bf16 twin, no element
   differing and its bits repeated, at vit-b's FF1, FF2 and embedder
   (12,608 and 12,544 rows), vit-s's FF1, ragged rows and x strided by 3
   and by 4 values, timed beside the f32 kernel on the same operands, the
   twin and ``torch._int_mm`` with its quantize and dequantize passes;
8b. the bf16 fused FF (``csrc/fused_ffn_bf16.cu``, forward and backward)
   against its plain twins (``K.ffn_pre_ln_bf16`` / ``K.ffn_pre_ln_bwd_bf16``)
   at vit-s, one image, a ragged shape and vit-b's and vit-l's widths (the
   tiled route): one bf16 ulp plus one of LN, r and dh as the next product
   weighs them and the row sums' other order; the kernel's ReLU pattern
   within rounding of the twin's, the backward on it; no further than
   twice the twin from f64; bits repeated; times beside the f32 kernels',
   the twins' and ``F.layer_norm`` + cuBLAS bf16's; then (after phase 10)
   bf16 serving and training of the fused-FF ``efficientkan`` (+ 12
   ``ffn_pre_ln_bf16`` a forward, 12 ``ffn_pre_ln_bwd_bf16`` a backward,
   no f32 launch) beside the same model unfused, its gradients against the
   CPU's twins on the card's ReLU pattern;
9. serving, through ``Predictor(batch_size=64, device="cuda")`` for three
   requests (64, 64 and 37 images), of the vit-s ``efficientkan`` (1 + 12
   + 12 launches a batch), ``flash-attn`` (12 lanes), ``cheby`` (1
   ``chebykan`` + 12 ``cheby_qkv_grouped`` + 12 lanes), ``fourier`` (1
   ``fourierkan`` + 12 lanes; q/k/v on cuBLAS), ``fast`` (1 ``fastkan`` +
   36 ``fastkan_qkv_grouped`` + 12 lanes), ``sine`` (1 ``sinekan`` + 36
   ``sinekan_qkv_grouped`` + 12 lanes) and ``vanilla`` (12 lanes)
   models, and of the vit-s ``efficientkan`` with ``fused_ff=True`` (+ 12
   ``ffn_pre_ln``): exact launch counts and no backward launch, the logits
   of two images against the same model's CPU forward, the steady-state
   images/s;
10. training of the vit-s ``efficientkan``, ``cheby``, ``fourier``, ``fast``,
   ``sine``, ``vanilla`` and ``flash-attn`` models (the last two 12 lanes
   launches a step, a Linear embedder) and of the fused-FF ``efficientkan`` (+ 12
   ``ffn_pre_ln`` forward and backward), batch 64, 6 Adam steps on one
   fixed batch through ``kanvit_torch.train``: loss finite and falling,
   exact forward and backward launch counts a step, the embedder's backward
   computing no dx, the gradients of a 4-image batch against the same
   model's CPU gradients (in f64 on the card's own ReLU pattern, which the
   fused FF kernel reports, after bounding that pattern's flips against
   f64's), the steady-state step time and images/s, and a
   ``torch.profiler`` breakdown;
9b. bf16 serving of the vit-s ``efficientkan`` (kanvit's ``--bf16``
   policy): first its three bf16 kernels (``bspline_kan``,
   ``bspline_qkv_grouped``, the lanes attention's forward) against their
   plain twins on the card at the vit-s shapes and ragged narrow ones
   (one bf16 ulp elementwise; a fully masked row 0), against the f64 sum of
   the same rounded operands (no further than twice the twin), bits
   repeated, CUDA-event and device times beside the f32 kernel's on the
   same operands and, for the attention, ``scaled_dot_product_attention``'s
   in bf16; then ``Predictor`` on a bf16 copy of the f32 phase's weights
   (three requests) and ``make_eval_step(bf16=True)``: exactly 1 + 12 + 12
   bf16 launches a forward, logits within 2e-2 x max(1, max|logits|) of the
   CPU's bf16 forward, top-1 agreement with the card's f32 logits, device
   forward ms (in turns with f32) and images/s beside f32's;
9c. the cheby ViT's four bf16 kernels (``chebykan`` and
   ``cheby_qkv_grouped``, forward and backward) against their plain twins
   in 9b's phase, at the vit-s, one-image and MNIST shapes and dh 8 (one
   bf16 ulp plus one of each rounded T_n weighted as the next product weighs
   it; no further than twice the twin from f64; bits repeated; the no-dx
   dW the all-gradients dW's bits); bf16 training of the vit-s
   ``efficientkan`` and, after phase 10's cheby training, bf16 serving and
   training of the vit-s ``cheby`` ViT on its weights: exactly 1 + 12 + 12
   bf16 launches each way and no f32 KAN or attention launch, logits and a
   4-image step's gradients against the CPU's twins (2e-2 and 5e-2 x
   max(1, max)), the loss falling over 10 steps, images/s, device forward,
   host ms a step, busy, idle share and the largest device operations
   beside f32's, and the parameter casts' device kernels and the host's
   split of a step with the flat buffer and with a cast a parameter;
9d. the fast ViT's four bf16 kernels (``fastkan`` and
   ``fastkan_qkv_grouped``, forward and backward: dx, dW, dgamma, dbeta)
   against their plain twins in 9b's phase, at the vit-s, one-image and
   MNIST shapes and dh 8, the forwards also with a third of x at |x|
   20-60 (the same gates as 9c; the no-dx dW, dgamma and dbeta the
   all-gradients route's bits); after phase 10's fast training, bf16
   serving and training of the vit-s ``fast`` ViT on its weights: exactly
   1 + 36 + 12 bf16 launches each way (one ``fastkan_qkv_grouped`` a q, k
   or v projection) and nothing else, with 9c's checks and numbers;
9e. the sine ViT's four bf16 kernels (``sinekan`` at grid 28, its slices
   in chunks of 4, and ``sinekan_qkv_grouped`` at grid 4, forward and
   backward: dx, dW, dfreq) against their plain twins in 9b's phase, at the
   vit-s, one-image and MNIST shapes and dh 8, the embedder's forward also
   with a third of x at |x| 20-60 (9c's gates, dfreq's with a term for its
   cancelling f32 sum; the no-dx dW and dfreq the all-gradients route's
   bits); after phase 10's sine training, bf16 serving and training of the
   vit-s ``sine`` ViT on its weights: exactly 1 + 36 + 12 bf16 launches
   each way and nothing else, with 9c's checks and numbers. The bf16
   training phases of the efficientkan, cheby, fast, sine and fourier ViTs
   run at 6, 6, 4, 6 and 6 of their 12 blocks (``BF16_TRAIN_DEPTH``; their
   launches a step scaled to them), time two turns of each step, and
   profile the bf16 step alone (the f32 step's profile is phase 10's), so
   that the run stays well inside its time limit as phases are added;
9f. the fourier ViT's two bf16 KAN kernels (``fourierkan`` at grid 28, its
   56 slices in 14 chunks of 2 harmonics, cos/sin(kx) by the angle-addition
   recurrence; forward and backward: dx, dW) against their plain twins in
   9b's phase, at the vit-s, one-image and MNIST shapes and grid 5 (9c's
   gates; the no-dx dW the all-gradients route's bits), each beside the f32
   kernels on the same operands; after phase 10's fourier training, bf16
   serving and training of the vit-s ``fourier`` ViT on its weights (its
   q/k/v Linear): exactly 1 + 12 bf16 launches each way and nothing else,
   with 9c's checks and numbers;
11. int8 serving of the vit-s ``vanilla`` model through
   ``Predictor(quant="int8")``: with the ``int8_linear`` kernel (25
   launches a batch, the 1000-class head on qdot), calibrated, and on qdot
   alone; top-1 agreement with f32 and the probabilities' change (kanvit's
   gates), four images against the CPU's int8 forward and the same four
   replayed on the CPU a block at a time from the card's inputs, images/s
   of each and of f32, the device forward's time and profile of each and
   of f32, and the time of quantizing the weights once over;
11b. the same for a bf16 model (kanvit's ``--bf16 --quant int8``): the
   vit-b ``vanilla`` (d 768, 12 heads, 12 blocks) on a bf16 copy of seeded
   f32 weights, with the kernel (25 bf16 ``int8_linear`` + 12 bf16 lanes a
   batch), calibrated, and on qdot (no ``int8_linear``, 12 f32 lanes: the
   stream f32 after the embedder), the gates against the same bf16 model's
   float logits, and on qdot the widening casts; then gates and counts
   alone at 4 blocks: the vit-b ``flash-attn`` on the kernel route (its
   chained four images read, not gated) and the vit-s ``efficientkan`` on
   qdot;
12. the repaired faults: ``load_predictor``'s defaults (MNIST, d 64, 8 heads
   of 8) serving a request, the CIFAR geometry (d 64, 8 heads, 17 tokens)
   training ``efficientkan`` and ``vanilla`` with the gradient gate, and a
   vit-s ``efficientkan`` with refit grids per head serving (3 grouped
   launches a block);
13. decoder training through ``kanvit_torch.bench_decoder`` at
   ``benchmarks/causal_decoder.py``'s configs (d 256, 4 heads, 4 blocks,
   vocab 1024; seq 2048 batch 16 and seq 8192 batch 4): 6 Adam steps (loss
   finite and falling, exactly 4 tiled forward, 4 dq and 4 dk/dv launches a
   step and no lanes launch), the gradients of a 1-sequence batch at seq
   2048 against the CPU, tokens/s and ms a step of the kernel impl and, at
   seq 2048, of the plain impl, and a ``torch.profiler`` breakdown;
13b. the same in bf16 (``bench_decoder --bf16``, kanvit's policy): exactly
   4 bf16 tiled forward, 4 dq and 4 dk/dv launches a step and nothing else,
   the loss finite and falling, the gradients of a 1-sequence batch at seq
   2048 within 5e-2 x max|g| of the CPU's, each tensor's own (the kernels'
   plain twins), device ms a step by part (CUDA events), the idle share and a
   ``torch.profiler`` breakdown, and tokens/s and ms a step of the bf16 and
   the f32 kernel impl in turns (bf16, f32, bf16, f32);
14. the reference MNIST preset (batch 128) through ``kanvit_torch.bench``,
    whose JSON line is printed;
15. one JSON line of per-kernel results (each kernel's launches on its main
    path, and by path; its error, time and plain version's time; its bound,
    the least time the card could take for the same work, for the
    tensor-core attention and FF kernels at the dense TF32 rate for their
    three products a product with the CUDA-core f32 bound beside it, and the
    library call's time on the same inputs: for the attention kernels
    ``scaled_dot_product_attention``'s, for the FF ``F.layer_norm`` and
    cuBLAS ``F.linear``'s; the FF entries also carry the measured
    ``mma.sync`` TF32 rate and the bound at that rate), the card's
    ``nvidia-smi`` line, and last the result line
    ``{"ok": true, "device": {...}}``.

It imports torch, numpy and kanvit_torch only (no jax).
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BATCH = 64
REQUESTS = (64, 64, 37)
TOL_BSPLINE = 1e-4   # x max(1, max|y|): f32 sums of depth 6912 / 576 in another order
# Chebyshev and Fourier forwards, x max(1, max|y|): f32 sums of depth 3840
# (Chebyshev) and 43,008 (Fourier G 28) in another order, CUDA's sincosf and
# tanhf against the CPU's (each within 2 ulp).
TOL_KAN = 1e-4
TOL_ATTN = 1e-5      # x max(1, max|y|): f32 softmax, reduction depth 197
# The 3xTF32 lanes forward against f64 on the card, x max(1, max|o|): the
# split keeps f32's accuracy (plain 1xTF32 is ~6e-4 off,
# tests/test_torch_port_attention_tc.py).
TOL_ATTN_F64 = 1e-6
TOL_LOGITS = 1e-3    # GPU against CPU logits, 12 blocks deep
# Backward kernels, x max(1, max|g|) per gradient: f32 sums of depth up to
# 12,608 rows (dW), 3,456 (dx) and 197 (attention) in another order than
# cuBLAS / autograd, and probabilities recomputed from the forward's (m, l).
TOL_BWD = 1e-4
# GPU parameter gradients of a 4-image step against the CPU's in f64, x max|g|
# of each tensor: f32 through 12 blocks. The reference is f64 because f32
# rounding, on either side, flips ReLUs whose input lies within it of 0, and
# one flip in an early block moves that block's FF gradient by ~2e-3 of its
# max: the vit-s fourier model's CPU f32 gradients are 1.98e-3 from f64.
TOL_GRADS = 1e-3
# A tensor whose f64 max|g| is at most this share of the model's largest is
# at f32 rounding level (2^-24): its gradient is held against the largest.
F32_ROUNDING = 2.0 ** -24
# The card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms: f32
# outside the tensor cores (the KAN and FF kernels, the generic attention
# head dims), dense TF32 on the tensor cores (the attention kernels at
# TC_HEAD_DIMS, 3xTF32: three TF32 products for each f32 one) and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate (the bf16 kernels)
PEAK_BYTES = 3.35e12
# The fused FF against its plain version, x max(1, max|y|) and per gradient
# x max(1, max|g|): f32 sums of depth D (384) and F (1,536) and, for dW1,
# dW2, N (12,608) rows in another order than cuBLAS.
TOL_FFN = 1e-4
# The 3xTF32 FF forward against f64 on the card, x max(1, max|y|): the split
# keeps f32's accuracy (plain 1xTF32 is ~2e-4 off at vit-s widths,
# tests/test_torch_port_ffn_tc.py).
TOL_FFN_F64 = 1e-6
# int8 serving on the card against the CPU's, x max|logit|: the int8 values
# agree but where an activation lies within f32 rounding of a .5 step (the
# two sides' LayerNorms and attention round apart), each such flip moving one
# product term by s_x s_w |q(w)|.
TOL_INT8_LOGITS = 2e-2
# ReLU inputs that fall on the other side of 0 on the kernel's side than on
# the reference's: at most FLIP_SHARE of them (and FLIP_FLOOR), and each
# within rounding of 0. For the fused FF against its plain version: |h| at
# most 2 D 2^-24 of its sum of |terms| (sum_i |LN(x)_i W1_ji| + |b1_j|), the
# worst rounding of a depth-D f32 sum on each side. For a model's f32
# forward against f64: |h| at most FLIP_TOL_F64 of its row's max|h|, 100x the
# f32 error the served logits show (~1.5e-6, PERF.md).
FLIP_SHARE = 4e-6
FLIP_FLOOR = 8
FLIP_TOL_F64 = 1e-4
# The bf16 kernels against their plain twins (the same bf16 policy on the
# card), elementwise: one bf16 ulp, |a - b| <= 2^-7 |b| + 2^-12 max|b|
# (f32 sums in another order round a few outputs to the neighbouring bf16).
# The attention also rounds each probability to bf16, and its scores' f32
# sums in another order round a few p to the neighbouring bf16 (one output
# of vit-s's 4.8M lay 4.8e-6 past the one-ulp gate on the H100, PERF.md):
# its gate adds one bf16 ulp of every p, weighted as P V weights it,
# 2^-8 (bf16(p) @ |v|) / l.
BF16_ULP_REL, BF16_ULP_ABS, BF16_P_ULP = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
# The tiled bf16 forward rounds each p against its own 32-key tiles' running
# max, its twin against kanvit's 1,024-key blocks': each bf16(p) within
# 2^-8 of its f32 value on either side, so 2^-7 (bf16(p) @ |v|) / l.
BF16_P_TWO_SIDED = 2.0 ** -7
# The tiled bf16 forward's (m, l) against the twin's: m of max(1, max|m|),
# l of max(1, l) (a row with no valid key at all sums 1e-10 a tile, the
# kernel's tiles not the twin's blocks, and its p are all 0); f32 scores of
# depth dh and row sums of up to 8,192 terms in another order.
TOL_FLASH_STATS = 1e-4
# bf16 serving on the card against the CPU's bf16 forward, x max(1,
# max|logits|): kanvit's own bf16 gate (tests/test_kernels.py:871).
TOL_BF16_LOGITS = 2e-2
TRAIN_STEPS = 6
GRAD_IMAGES = 4
SEED = 0
# benchmarks/causal_decoder.py's model and its (seq, batch) configs
DECODER = dict(dim=256, heads=4, n_blocks=4, vocab=1024)
DECODER_CONFIGS = ((2048, 16), (8192, 4))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------
# Phase 1: toolchain and card
# --------------------------------------------------------------------------

def phase_toolchain():
    if not (HERE / "kanvit_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{HERE} is not a kanvit checkout: kanvit_torch/ "
                           "is missing beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: chip_smoke.py "
                           "runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kanvit_torch.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[toolchain] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  torch.version.cuda {torch.version.cuda}  nvcc: {nvcc[-1]}")
    print(f"[card] {smi}  (cuda:0 of {torch.cuda.device_count()})")
    return torch, smi


# --------------------------------------------------------------------------
# Phase 2: build
# --------------------------------------------------------------------------

def phase_build():
    from kanvit_torch.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build(ptxas_info=True)
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s -> {path.relative_to(HERE)}")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    sass_mix(path)
    return secs


# The tensor-core kernels whose instruction mix the build reports: what
# issues beside each HMMA (mma.sync) bounds them (PERF.md).
# An entry is a kernel's name, or the parts its mangled name holds (the
# Fourier and sine tensor-core kernels: the family, and Lb0 forward, Lb1 dW;
# the grouped backward's: the family and its NJ; the forward's: the family
# and its n8 tiles a warp, B-spline's, RBF's and Chebyshev's also its stages
# a level of the sum, 0 for the q/k/v's one running sum, 12 for the
# embedder's two levels; the int8 linear's: its rows a block and its
# activation type, f32 or bf16, its products IMMA, counted with the HMMA;
# the bf16 tiled backward's: its DH, its products wgmma, HGMMA).
SASS_KERNELS = ("attention_lanes_fwd_tcILi64", "attention_lanes_dq_tcILi64",
                "attention_lanes_dkv_tcILi64", "flash_fwd_tcILi64",
                "flash_dq_tcILi64", "flash_dkv_tcILi64", "ffn_fwd_tcILi3",
                "ffn_bwd_hidden_tc", "ffn_bwd_dx_tcILi3", "ffn_dw_tc",
                ("ffn_gemm_tcILi0",), ("kan_tc_dw_grouped", "Bspline"),
                ("kan_tc_dx_kernel", "Bspline"), ("kan_tc_dw_grouped", "3RbfELi1E"),
                ("kan_tc_dx_kernel", "3RbfE"), ("kan_tc_dw_grouped", "3RbfELi3E"),
                ("kan_tc_dw_grouped", "4SineELi1E"),
                ("kan_tc_dx_kernel", "4SineE"), ("kan_tc_dw_grouped", "5ChebyELi3E"),
                ("kan_tc_dx_kernel", "5ChebyE"),
                ("kan_tc_fwd_grouped", "7BsplineELi24E", "Tf32x3ELi0E"),
                ("kan_tc_fwd_grouped", "7BsplineELi8E", "Tf32x3ELi0E"),
                ("kan_tc_fwd_grouped", "7BsplineELi24E", "Tf32x3ELi12E"),
                ("kan_tc_fwd_grouped", "7BsplineELi24E", "4Bf16ELi0E"),
                "attention_lanes_fwd_bf16ILi64", "flash_fwd_bf16ILi64",
                "flash_dq_bf16ILi64EE", "flash_dkv_bf16ILi64EE",
                "attention_lanes_fwd_bf16ILi128ELb1", "attention_lanes_dq_bf16ILi128ELb1",
                "attention_lanes_dkv_bf16ILi128ELb1", "flash_fwd_bf16ILi128ELb1",
                "flash_dq_bf16ILi128EE", "flash_dkv_bf16ILi128EE",
                ("kan_tc_fwd_grouped", "3RbfELi8E", "Tf32x3ELi0E"),
                ("kan_tc_fwd_grouped", "3RbfELi8E", "Tf32x3ELi12E"),
                ("kan_tc_fwd_grouped", "4SineELi8E", "Tf32x3"),
                ("kan_tc_fwd_grouped", "4SineELi24E", "4Bf16"),
                ("kan_tc_fwd_grouped", "4SineELi8E", "4Bf16"),
                ("kan_bf16_dw", "4SineELi3E"), ("kan_bf16_dx", "4SineE"),
                ("kan_tc_fwd_grouped", "5ChebyELi8E", "Tf32x3ELi0E"),
                ("kan_tc_fwd_grouped", "5ChebyELi8ELi12E", "Tf32x3ELi24E"),
                ("kan_tc_kernel", "FourierTc", "Lb0"), ("kan_tc_kernel", "FourierTc", "Lb1"),
                ("kan_tc_kernel", "SineTc", "Lb0"), ("kan_tc_kernel", "SineTc", "Lb1"),
                ("int8_linear_kernelILi48E", "Li2EfE"),
                ("int8_linear_kernelILi48E", "nv_bfloat16"), "ffn_fwd_bf16ILi3",
                "ffn_bwd_hidden_bf16",
                "ffn_bwd_dx_bf16ILi3", "ffn_dw_bf16")


PRODUCTS = {"HMMA", "HGMMA"}  # the tensor cores' products in SASS: mma.sync, wgmma


def sass_mix(lib):
    """Static SASS instruction counts of ``SASS_KERNELS`` (cuobjdump): the
    HMMAs (tensor-core products of mma.sync; an int8 kernel's IMMA counted
    as one) and HGMMAs (wgmma) against everything else, and the most
    frequent mnemonics. A report for PERF.md, not a gate."""
    from kanvit_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    run = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True)
    if run.returncode:
        print(f"[build] SASS: cuobjdump failed: {run.stderr.strip()[:200]}")
        return
    functions = run.stdout.split("Function : ")[1:]
    for entry in SASS_KERNELS:
        parts = (entry,) if isinstance(entry, str) else entry
        name = " ".join(parts)
        body = next((f for f in functions
                     if all(part in f.split("\n", 1)[0] for part in parts)), "")
        code = [(int(at, 16), op, rest) for at, op, rest in re.findall(
            r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(.*)$",
            body, re.M)]
        if not code:
            print(f"[build] SASS {name}: not found in the library")
            continue
        code = [(at, "HMMA" if op == "IMMA" else op, rest) for at, op, rest in code]
        counts = {}
        for _, op, _ in code:
            counts[op] = counts.get(op, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
        # the main loop: the shortest backward branch spanning the most HMMA;
        # its HMMA blocks: the basic blocks that hold an HMMA (the products,
        # without the loop's once-a-tile or once-a-chunk code)
        back = [(int(m.group(1), 16), at) for at, op, rest in code if op == "BRA"
                for m in [re.search(r"0x([0-9a-f]+)", rest)]
                if m and int(m.group(1), 16) < at]
        loop = ""
        if back:
            def hmma(span):
                return sum(1 for at, op, _ in code if span[0] <= at <= span[1]
                           and op in PRODUCTS)

            most = max(hmma(b) for b in back)
            lo, hi = min((b for b in back if hmma(b) == most), key=lambda b: b[1] - b[0])
            body = [(at, op, rest) for at, op, rest in code if lo <= at <= hi]
            targets = {int(m.group(1), 16) for _, op, rest in body if op == "BRA"
                       for m in [re.search(r"0x([0-9a-f]+)", rest)] if m}
            blocks, cur = [], []
            for at, op, _ in body:
                if at in targets and cur:
                    blocks.append(cur)
                    cur = []
                cur.append(op)
                if op in ("BRA", "EXIT"):
                    blocks.append(cur)
                    cur = []
            blocks.append(cur)
            in_blocks = sum(len(b) for b in blocks if PRODUCTS & set(b))
            loop_ops = [op for _, op, _ in body]
            loop = (f"; main loop {loop_ops.count('HMMA')} HMMA + {loop_ops.count('HGMMA')} "
                    f"HGMMA of {len(body)}, its product blocks {in_blocks} "
                    f"({(in_blocks - most) / max(most, 1):.2f} others a product)")
        print(f"[build] SASS {name}: {counts.get('HMMA', 0)} HMMA + {counts.get('HGMMA', 0)} "
              f"HGMMA of {len(code)} instructions{loop}; "
              + " ".join(f"{op} {n}" for op, n in top))


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(events):
    """µs by kernel name of a profile's device-side events, without the GPU
    copies of record_function ranges (they span kernels counted already)
    and without spin kernels (``torch.cuda._sleep``'s: the fences and the
    first kernel of a trace, ``first_kernel``)."""
    by_name = {}
    for e in events:
        if ("cuda" in str(getattr(e, "device_type", "")).lower()
                and not getattr(e, "is_user_annotation", False) and not is_spin(e)):
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                          - e.time_range.start)
    return by_name


def is_spin(e):
    return "spin_kernel" in e.name


LEAD_SPINS = 200  # empty spins that open a trace, ahead of the kernels it times


def first_kernel(torch):
    """A 0.1 ms spin and ``LEAD_SPINS`` empty ones, waited for, as a trace's
    first kernels: a profile can lose the first few device records it sees
    (up to five on the H100: the spin and the next four kernels, whether the
    spin lasts 0.1 ms or 20; PERF.md §7), so the records it loses are
    spins, which ``kernel_times`` leaves out."""
    torch.cuda._sleep(int(0.1 * spin_cycles_per_ms(torch)))
    for _ in range(LEAD_SPINS):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def device_kernel_count(prof):
    """The device kernels of a profile, without record_function ranges'
    GPU copies and spins (``kernel_times``' events, counted)."""
    return sum(1 for e in prof.events()
               if "cuda" in str(getattr(e, "device_type", "")).lower()
               and not getattr(e, "is_user_annotation", False) and not is_spin(e))


def kernel_ms(torch, fn, iters=20, warmup=3, label=None):
    """The card's own time of one call of ``fn``: the summed durations of
    the kernels it launches, from ``torch.profiler``, over ``iters`` calls,
    without the host's time or the gaps between launches. ``label``: print
    the kernels by name. A profile now and then drops device events (all of
    them, or all but a few kernels'), so it profiles twice and keeps the
    trace with the most kernels, a third time if neither has any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    by_name, events = {}, 0
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first_kernel(torch)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = kernel_times(prof.events())
        count = device_kernel_count(prof)
        if count > events:
            by_name, events = got, count
        if attempt >= 1 and by_name:
            break
        if not got:
            print(f"[kernel] {label or 'kernel_ms'}: the profiler recorded no device "
                  "event; profiling again")
    check(bool(by_name), "the profiler recorded no device time")
    if label:
        print(f"[kernel] {label}, device ms a call: " + "; ".join(
            f"{name[:90]} {us / iters / 1e3:.4f}" for name, us in
            sorted(by_name.items(), key=lambda kv: -kv[1])))
    return sum(by_name.values()) / iters / 1e3


def spline_inputs(rng, shape, knots):
    """Normal inputs, with some entries exactly on knots and some beyond
    every knot span (|x| > 2.2)."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 16, replace=False)
    flat[idx[: idx.size // 2]] = knots[idx[: idx.size // 2] % knots.size]
    flat[idx[idx.size // 2:]] = rng.choice(
        np.float32([-3.5, -2.6, -2.2, 2.2, 2.6, 3.5]), idx.size - idx.size // 2)
    return x


def compare(name, got, want, tol):
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    ok = bool(got.isfinite().all()) and err <= tol * scale
    print(f"[kernel] {name}: max|err| {err:.3e}  limit {tol * scale:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"({err:.3e} > {tol * scale:.3e}) or is not finite")
    return err


def bound(flops, nbytes, library_ms=None, peak=PEAK_F32_FLOPS):
    """The least time the card could take for ``flops`` operations (f32,
    or at ``peak``) on ``nbytes`` of inputs read once and outputs written
    once: the larger of the two over the published peaks, and which one
    binds. ``library_ms`` is one PyTorch call's time for the same function,
    or None."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def kan_bound(n, groups, slices, nin, out, backward=False, extra_floats=0,
              tensor_cores=False, contractions=None, dx=True):
    """A KAN pass over x (n, G*nin) and the packed weight (G, S, nin, out):
    2 n G S nin out FLOPs a contraction, one forward, two backward (gW for
    dx, and dW; ``contractions`` overrides the count); bytes of x, W and y
    (backward: x, W, gy, dx (``dx``) and dW), plus ``extra_floats`` (the
    LayerNorm's, sine's freq and phase tables).

    ``tensor_cores``: the route is 3xTF32 on the tensor cores, so
    ``bound_ms`` counts three TF32 products for each f32 one at the dense
    TF32 peak and ``f32_bound_ms`` keeps the CUDA-core f32 bound beside it,
    as ``attention_bound`` does."""
    count = contractions or (2 if backward else 1)
    flops = 2.0 * n * groups * slices * nin * out * count
    floats = n * groups * nin + groups * slices * nin * out + n * groups * out
    if backward:
        floats += n * groups * nin * dx + groups * slices * nin * out
    f32 = bound(flops, 4.0 * (floats + extra_floats))
    if not tensor_cores:
        return f32
    tc = bound(TF32_PASSES * flops, 4.0 * (floats + extra_floats), peak=PEAK_TF32_FLOPS)
    return {**tc, "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"]}


def attention_bound(b, h, tq, tk, dh, causal, part, library_ms=None,
                    tensor_cores=False):
    """Attention over b*h heads: 2 tq tk dh FLOPs a product, of which the
    forward does 2 (q k^T, p v), dq 3 (s, dp, dq), dk/dv 4 (s, dp, dv, dk)
    and a joint backward 5; causal counts only the keys at or before each
    query (tq == tk). Bytes: q, k, v (+ o and do backward) in, o (dq, dk, dv)
    out, and the per-row (m, l) where the kernel reads them.

    ``tensor_cores``: the kernel's route is 3xTF32 on the tensor cores, so
    ``bound_ms`` counts three TF32 products for each f32 one at the dense
    TF32 peak; ``f32_bound_ms`` keeps the CUDA-core f32 bound beside it, as
    every other attention row has it."""
    pairs = tk * (tk + 1) / 2 if causal else tq * tk
    products = {"fwd": 2, "dq": 3, "dkv": 4, "bwd": 5}[part]
    row, col = b * h * tq * dh, b * h * tk * dh
    floats = {"fwd": 2 * row + 2 * col,
              "dq": 3 * row + 2 * col + 3 * b * h * tq,
              "dkv": 2 * row + 4 * col + 3 * b * h * tq,
              "bwd": 4 * row + 4 * col + 2 * b * h * tq}[part]
    flops, nbytes = 2.0 * b * h * pairs * dh * products, 4.0 * floats
    f32 = bound(flops, nbytes, library_ms)
    if not tensor_cores:
        return f32
    tc = bound(TF32_PASSES * flops, nbytes, library_ms, peak=PEAK_TF32_FLOPS)
    return {**tc, "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"]}


def sdpa_ms(torch, q, k, v, causal, mask, backward=None, iters=20, device=False):
    """``scaled_dot_product_attention`` on (B, H, T, dh) views with the same
    key mask and causality (query row r at position r - max(tk - tq, 0), as
    the port's kernels), forward alone, or its backward through autograd to
    the inputs in ``backward`` ("q", "kv" or "qkv"): the yardstick call,
    never used by the port. CUDA events around back-to-back calls, or with
    ``device`` the profiler's kernel time (kernel_ms), its kernels printed."""
    import torch.nn.functional as F

    def timer(fn):
        if device:
            return kernel_ms(torch, fn, iters, label=f"scaled_dot_product_attention "
                             f"{'fwd' if backward is None else 'bwd'} {tuple(q.shape)}")
        return time_ms(torch, fn, iters)

    b, _, tq, _ = q.shape
    tk = k.shape[2]
    attn_mask = None if mask is None else mask.bool().reshape(b, 1, 1, tk)
    if causal and (attn_mask is not None or tq != tk):
        seen = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(
            -max(tk - tq, 0))
        attn_mask = seen if attn_mask is None else attn_mask & seen
    causal_arg = causal and attn_mask is None
    if backward is None:
        with torch.inference_mode():
            return timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=causal_arg))
    leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                         is_causal=causal_arg)
    g = torch.randn_like(out)
    want = {"q": leaves[:1], "kv": leaves[1:], "qkv": leaves}[backward]
    return timer(lambda: torch.autograd.grad(out, want, g, retain_graph=True))


def bspline_case(torch, rng, n, nin, nout):
    """A KANLinear (n, nin) -> nout from the seed, its inputs (on and beyond
    the knots), its parameters ``(grid, base, spline, scaler)`` and packed
    weight ``(1, 9, nin, nout)``."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import KANLinear

    layer = KANLinear(nin, nout, generator=torch.Generator().manual_seed(SEED)).cuda()
    x = torch.from_numpy(spline_inputs(rng, (n, nin), layer.grid[0].cpu().numpy())).cuda()
    p = (layer.grid, *(t.detach() for t in (layer.base_weight, layer.spline_weight,
                                           layer.spline_scaler)))
    return x, p, FB.pack_weight(*p[1:]).unsqueeze(0).contiguous()


def bspline_packed_plain(x, grid, w):
    """The plain B-spline forward over the packed weight ``(1, 9, nin,
    out)``: autograd through it gives the plain version's dW and dx."""
    from kanvit_torch.ops import kan_bases as K

    return K.bspline_kan_forward(x, grid.to(x.dtype), w[0, -1].T, w[0, :-1].permute(2, 1, 0),
                                 None)


def check_bspline(torch, rng, n, nin, nout, label):
    """``bspline_kan``'s forward (3xTF32 on the tensor cores, its sum in two
    levels) against the plain version, no further from f64 than twice the
    plain f32 version, the bits of a second forward; CUDA-event and device
    times beside the CUDA-core kernel it replaced (``cuda_core_route``) on
    the same operands, whose distance from f64 is printed too, the plain
    version, and the 3xTF32 and f32 bounds."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x, p, w = bspline_case(torch, rng, n, nin, nout)
    tag = f"bspline_kan {label} N={n} {nin}->{nout}"

    def kernel():
        return FB._launch("bspline_kan", "bspline", x, w, p[0])

    with torch.inference_mode():
        y = FB.bspline_kan(x, *p)
        again = kernel()
        ref = K.bspline_kan_forward(x, *p)
        exact = K.bspline_kan_forward(*(a.double() for a in (x, *p)))
        torch.cuda.synchronize()
        err = compare(tag, y, ref, TOL_BSPLINE)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact)
        scale = max(1.0, float(exact.abs().max()))
        core_f64 = float((cuda_core_route(FB, kernel).double() - exact).abs().max()) / scale
        ms = time_ms(torch, kernel)
        dev_ms = kernel_ms(torch, kernel, 10, label=tag)
        core_ms = cuda_core_route(FB, lambda: time_ms(torch, kernel))
        core_dev_ms = cuda_core_route(FB, lambda: kernel_ms(torch, kernel, 10,
                                                            label=f"{tag}, CUDA cores"))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_kan(x, *p))
        plain_ms = time_ms(torch, lambda: K.bspline_kan_forward(x, *p))
    bounds = kan_bound(n, 1, 9, nin, nout, tensor_cores=True)
    print(f"[kernel] {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f}; the CUDA-core kernel "
          f"{core_ms:.4f}, device {core_dev_ms:.4f}, {core_f64:.3e} from f64)  with weight "
          f"packing {wrapper_ms:.4f} ms  plain {plain_ms:.4f} ms  bound 3xTF32 "
          f"{bounds['bound_ms']:.4f}, f32 {bounds['f32_bound_ms']:.4f}  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "cuda_core_ms": core_ms,
                               "cuda_core_device_ms": core_dev_ms,
                               "cuda_core_f64_err": core_f64}, bounds


def qkv_case(torch, rng, n, heads, dh, per_head):
    """An efficientkan MSA's grouped projection: ``x (N, H*dh)`` (entries on
    and beyond the knots), ``(grid, bw, sw, sc)`` and the plain version
    (each head through the plain KANLinear forward). The shared grid and
    the q|k|v weights; or, ``per_head``, a refit grid a head (each head's
    q knots scaled and shifted) and the q projection's weights, as the MSA
    launches one projection when its grids differ."""
    from kanvit_torch.layers import MSA
    from kanvit_torch.ops import kan_bases as K

    msa = MSA(heads * dh, heads, "efficientkan",
              generator=torch.Generator().manual_seed(SEED)).cuda()
    with torch.no_grad():
        if per_head:
            for m in msa.q_mappings:
                m.grid.mul_(float(rng.uniform(0.8, 1.3))).add_(
                    float(rng.uniform(-0.3, 0.3)))
            check(not msa.grids_equal(), "refit grids: the heads' grids are equal")
            params = msa.projection_weights(msa.q_mappings)
        else:
            params = (msa.q_mappings[0].grid, *msa.grouped_weights())
    grid = params[0]
    knots = grid.reshape(-1, grid.shape[-1])[:: dh].reshape(-1).cpu().numpy()
    x = torch.from_numpy(spline_inputs(rng, (n, heads * dh), knots)).cuda()

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(
            x[:, i * dh:(i + 1) * dh], grid[i] if per_head else grid, bw[i], sw[i],
            sc[i]) for i in range(heads)], dim=1)

    return x, params, plain


def check_qkv(torch, rng, n, heads, dh, label, per_head=False):
    """The grouped q/k/v forward (3xTF32 on the tensor cores) against the
    plain version, no further from f64 than twice the plain f32 version,
    the bits of a second forward; CUDA-event and device times beside the
    CUDA-core kernel it replaces (``cuda_core_route``) on the same operands,
    the plain version, and the 3xTF32 and f32 bounds."""
    from kanvit_torch.kernels import fused_basis as FB

    x, (grid, bw, sw, sc), plain = qkv_case(torch, rng, n, heads, dh, per_head)
    out = bw.shape[1]
    tag = f"{label} N={n} H={heads} dh={dh} out={out} grid {tuple(grid.shape)}"
    w = FB.pack_qkv_weight(bw, sw, sc).contiguous()

    def kernel():
        return FB._launch("bspline_qkv_grouped", "bspline", x, w, grid)

    with torch.inference_mode():
        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        again = kernel()
        ref = plain(x, bw, sw, sc)
        torch.cuda.synchronize()
        err = compare(f"bspline_qkv_grouped {tag}", y, ref, TOL_BSPLINE)
        check(torch.equal(y, again), f"bspline_qkv_grouped {label}: a second forward "
                                     "gave other bits")
        f64 = f64_gate(f"bspline_qkv_grouped {tag}", y, ref,
                       plain(*(a.double() for a in (x, bw, sw, sc))))
        ms = time_ms(torch, kernel)
        dev_ms = kernel_ms(torch, kernel, 10, label=f"bspline_qkv_grouped {tag}")
        core_ms = cuda_core_route(FB, lambda: time_ms(torch, kernel))
        core_dev_ms = cuda_core_route(FB, lambda: kernel_ms(
            torch, kernel, 10, label=f"bspline_qkv_grouped {tag}, CUDA cores"))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_qkv_grouped(x, grid, bw, sw, sc))
        plain_ms = time_ms(torch, lambda: plain(x, bw, sw, sc))
    bounds = kan_bound(n, heads, 9, dh, out, tensor_cores=True)
    print(f"[kernel] bspline_qkv_grouped {label}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f}; the CUDA-core kernel {core_ms:.4f}, device {core_dev_ms:.4f})  "
          f"with weight packing {wrapper_ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"3xTF32 {bounds['bound_ms']:.4f}, f32 {bounds['f32_bound_ms']:.4f}  "
          f"(bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "cuda_core_ms": core_ms,
                               "cuda_core_device_ms": core_dev_ms}, bounds


def check_attention(torch, rng, b, t, heads, dh, label, cases):
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    # q, k, v as the strided slices of a grouped (N, H*3dh) projection output
    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda()
    y4 = y.view(b, t, heads, 3 * dh)
    q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    errs = []
    with torch.inference_mode():
        for causal, mask in cases:
            o = FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)
            ref = A.lanes_attention(q, k, v, heads, causal=causal, mask=mask)
            torch.cuda.synchronize()
            tag = f"causal={causal} mask={'none' if mask is None else 'yes'}"
            errs.append(compare(f"flash_attention_lanes {label} B={b} T={t} "
                                f"H={heads} dh={dh} {tag}", o, ref, TOL_ATTN))
            if mask is not None:
                dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
                check(bool((o[dead] == 0).all()),
                      "a fully masked row must output exactly 0")
        causal, mask = cases[0]
        o = FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)
        again = FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)
        exact = A.lanes_attention(q.double(), k.double(), v.double(), heads,
                                  causal=causal, mask=mask)
        err64 = float((o.double() - exact).abs().max()) / max(
            1.0, float(exact.abs().max()))
        print(f"[kernel] flash_attention_lanes {label}: against f64 on the card "
              f"{err64:.3e} of max(1, max|o|); bits repeat {torch.equal(o, again)}")
        check(torch.equal(o, again), f"flash_attention_lanes {label}: the bits "
                                     "of a repeated forward differ")
        check(dh not in FA.TC_HEAD_DIMS or err64 <= TOL_ATTN_F64,
              f"flash_attention_lanes {label}: {err64:.3e} from f64, over "
              f"{TOL_ATTN_F64:.0e}")
        ms = time_ms(torch, lambda: FA.flash_attention_lanes(
            q, k, v, heads, causal=causal, mask=mask))
        dev_ms = kernel_ms(torch, lambda: FA.flash_attention_lanes(
            q, k, v, heads, causal=causal, mask=mask))
        plain_ms = time_ms(torch, lambda: A.lanes_attention(
            q, k, v, heads, causal=causal, mask=mask))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    lib_ms = sdpa_ms(torch, *views, causal, mask)
    lib_dev_ms = sdpa_ms(torch, *views, causal, mask, device=True)
    print(f"[kernel] flash_attention_lanes {label}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  scaled_dot_product_attention "
          f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f})")
    return errs[0], ms, plain_ms, {"err_vs_f64": err64, "device_ms": dev_ms,
                                   "library_device_ms": lib_dev_ms}, attention_bound(
        b, heads, t, t, dh, causal, "fwd", lib_ms, tensor_cores=dh in FA.TC_HEAD_DIMS)


def sub_entry(result):
    """A check's ``(err, ms, plain_ms, *extras)`` as a labelled sub-entry of
    its kernel in the ``kernels`` line."""
    err, ms, plain_ms, *extra = result
    entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    for more in extra:
        entry.update(more)
    return entry


def masked_items(torch, rng, b, t):
    """A key mask of ``(b, t)``: a fifth of the keys off at random, every
    key of item 0 off (its rows fully masked), and key 0 of item 1 (its
    causal query 0 sees no key)."""
    mask = torch.from_numpy(rng.random((b, t)) > 0.2).cuda()
    mask[0] = False
    mask[1, 0] = False
    return mask


# The head dims the paths run besides vit-s's 64: 8 (the reference geometry,
# d 64 in 8 heads: MNIST 50 tokens, CIFAR 17, at batch 64) on the templated
# kernels, and two the generic kernels take (csrc/attention_common.cuh).
ATTN_GEOMETRIES = (
    ("at_dh_8_mnist", BATCH, 50, 8, 8),
    ("at_dh_8_cifar", BATCH, 17, 8, 8),
    ("at_dh_40_generic", 16, 197, 4, 40),
    ("at_dh_128_generic", 16, 197, 2, 128),
)


def attention_cases(torch, rng, b, t):
    return [(False, None), (False, masked_items(torch, rng, b, t)),
            (True, masked_items(torch, rng, b, t))]


def phase_kernels(torch):
    rng = np.random.default_rng(SEED)
    geo = {"n_img": BATCH, "tokens": 197, "heads": 6, "dh": 64, "d": 384}
    results = {}
    results["bspline_kan"] = check_bspline(
        torch, rng, BATCH * 196, 768, 384, "vit-s embedder")
    results["bspline_qkv_grouped"] = check_qkv(
        torch, rng, BATCH * geo["tokens"], geo["heads"], geo["dh"], "vit-s q/k/v")
    results["flash_attention_lanes"] = check_attention(
        torch, rng, BATCH, geo["tokens"], geo["heads"], geo["dh"], "vit-s",
        [(False, None)])
    # ragged, narrow: the reference MNIST geometry with an odd batch of 37
    check_bspline(torch, rng, 37 * 49, 16, 64, "mnist embedder")
    check_qkv(torch, rng, 37 * 50, 2, 32, "mnist q/k/v")
    mask = torch.from_numpy(rng.random((37, 50)) > 0.2).cuda()
    mask[0] = False          # batch item 0: every row fully masked
    mask[1, 0] = False       # batch item 1, causal: query 0 sees no key
    check_attention(torch, rng, 37, 50, 2, 32, "mnist",
                    [(False, mask), (True, mask), (True, None)])
    # the grouped q/k/v at nin 8 (the reference geometry), and with refit
    # grids a head at vit-s (one projection, as the refit-grid path runs it)
    # one vit-s image: the embedder's forward runs its levels in blocks of
    # their own
    results["bspline_kan"] += ({"batch_1": sub_entry(check_bspline(
        torch, rng, 196, 768, 384, "vit-s embedder, one image"))},)
    results["bspline_qkv_grouped"] += (
        {"at_dh_8_mnist": sub_entry(check_qkv(torch, rng, BATCH * 50, 8, 8,
                                              "dh-8 mnist q/k/v"))},
        {"refit_grids_per_head": sub_entry(check_qkv(
            torch, rng, BATCH * geo["tokens"], geo["heads"], geo["dh"],
            "vit-s refit grids a head", per_head=True))})
    for key, b, t, heads, dh in ATTN_GEOMETRIES:
        results["flash_attention_lanes"] += ({key: sub_entry(check_attention(
            torch, rng, b, t, heads, dh, key[3:], attention_cases(torch, rng, b, t)))},)
    return results


# --------------------------------------------------------------------------
# Phase 4: backward kernels against autograd through their plain versions
# --------------------------------------------------------------------------

def grads_of(torch, fn, inputs, g, with_dx=True):
    """``(leaves, output, gradients of (output * g).sum())``; the graph is
    kept, so the backward alone can be timed again. Without ``with_dx`` the
    first input is no leaf (an embedder's training step) and the gradients
    are the other inputs'."""
    leaves = [t.detach().clone().requires_grad_(with_dx or i > 0)
              for i, t in enumerate(inputs)]
    out = fn(*leaves)
    asked = leaves if with_dx else leaves[1:]
    return leaves, out, torch.autograd.grad(out, asked, g, retain_graph=True)


def compare_grads(label, names, got, want):
    return max(compare(f"{label} d{nm}", a, b, TOL_BWD)
               for nm, a, b in zip(names, got, want))


def check_bspline_bwd(torch, rng, n, nin, nout, label):
    """``bspline_kan``'s backward (dW and dx on the tensor cores, 3xTF32):
    every gradient through the wrapper against autograd through the plain
    version; the kernels' dW and dx no further from f64 than twice the
    plain f32 version's (autograd over the packed weight); the training
    step's call (no dx) with the all-gradients call's dW bits, a second
    backward repeating them; CUDA-event and device times of both calls
    beside the CUDA-core kernels' on the same operands (``cuda_core_route``)
    and autograd's, and the 3xTF32 and f32 bounds of both (no dx: one
    contraction, no dx written)."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x, (grid, *params), w = bspline_case(torch, rng, n, nin, nout)
    g = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).cuda()
    tag = f"bspline_kan_bwd {label} N={n} {nin}->{nout}"
    inputs = [x, *params]
    _, _, got = grads_of(torch, lambda *a: FB.bspline_kan(a[0], grid, *a[1:]), inputs, g)
    leaves, out, want = grads_of(
        torch, lambda *a: K.bspline_kan_forward(a[0], grid, *a[1:]), inputs, g)
    torch.cuda.synchronize()
    err = compare_grads(tag, ("x", "base_weight", "spline_weight", "spline_scaler"), got, want)

    def bwd(with_dx=False):
        return FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, g, with_dx, True)

    with torch.inference_mode():
        dx, dw = bwd(True)
        no_dx = bwd()[1]
        dx2, dw2 = bwd(True)
    same = torch.equal(no_dx, dw)
    print(f"[kernel] {tag}: the training path's backward (no dx) gives the all-gradients "
          f"route's dW bits: {same}")
    check(same, f"{tag}: the no-dx dW differs from the all-gradients dW")
    check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
          f"{tag}: a second backward gave other bits")
    plain = grads_of(torch, lambda *a: bspline_packed_plain(a[0], grid, a[1]), [x, w], g)[2]
    exact = grads_of(torch, lambda *a: bspline_packed_plain(a[0], grid, a[1]),
                     [x.double(), w.double()], g.double())[2]
    extra = {f"f64_err_{nm}": f64_gate(f"{tag} {nm}", a, b, c)
             for nm, a, b, c in zip(("dx", "dW"), (dx, dw), plain, exact)}
    with torch.inference_mode():
        ms = time_ms(torch, lambda: bwd(True))
        dw_ms = time_ms(torch, bwd)
        extra.update({
            "no_dx_ms": dw_ms,
            "device_ms": kernel_ms(torch, lambda: bwd(True), 10, label=f"{tag}, all gradients"),
            "no_dx_device_ms": kernel_ms(torch, bwd, 10, label=f"{tag}, no dx"),
            "cuda_core_ms": cuda_core_route(FB, lambda: time_ms(torch, lambda: bwd(True))),
            "cuda_core_no_dx_ms": cuda_core_route(FB, lambda: time_ms(torch, bwd)),
            "cuda_core_no_dx_device_ms": cuda_core_route(FB, lambda: kernel_ms(
                torch, bwd, 10, label=f"{tag}, no dx, CUDA cores"))})
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    bounds = kan_bound(n, 1, 9, nin, nout, True, tensor_cores=True)
    no_dx_bounds = kan_bound(n, 1, 9, nin, nout, backward=True, contractions=1, dx=False,
                             tensor_cores=True)
    extra.update({"no_dx_bound_ms": no_dx_bounds["bound_ms"],
                  "no_dx_f32_bound_ms": no_dx_bounds["f32_bound_ms"]})
    print(f"[kernel] bspline_kan_bwd {label}: kernels dx+dW {ms:.4f} ms (device "
          f"{extra['device_ms']:.4f}; CUDA cores {extra['cuda_core_ms']:.4f}); dW alone, as "
          f"on the training path, {dw_ms:.4f} ms (device {extra['no_dx_device_ms']:.4f}; "
          f"CUDA cores {extra['cuda_core_no_dx_ms']:.4f}, device "
          f"{extra['cuda_core_no_dx_device_ms']:.4f})  plain autograd {plain_ms:.4f} ms  "
          f"bounds 3xTF32 {bounds['bound_ms']:.4f} (no dx {no_dx_bounds['bound_ms']:.4f}), "
          f"f32 {bounds['f32_bound_ms']:.4f} (no dx {no_dx_bounds['f32_bound_ms']:.4f})  "
          f"(bits repeated)")
    return err, ms, plain_ms, extra, bounds


def check_qkv_bwd(torch, rng, n, heads, dh, label, per_head=False):
    """The grouped q/k/v backward (dx and dW on the tensor cores, 3xTF32)
    against autograd through the plain version, every gradient no further
    from f64 than twice the plain f32 version, the bits of a second
    backward; CUDA-event and device times of the kernels beside the
    CUDA-core kernels they replace (``kanvit_bspline_kan_bwd`` on the same
    grouped operands), the plain version, and the 3xTF32 and f32 bounds."""
    from kanvit_torch.kernels import fused_basis as FB

    x, (grid, *weights), plain = qkv_case(torch, rng, n, heads, dh, per_head)
    out = weights[0].shape[1]
    g = torch.from_numpy(rng.standard_normal((n, heads * out))
                         .astype(np.float32)).cuda()
    inputs = [x, *(w.detach() for w in weights)]
    names = ("x", "bw", "sw", "sc")
    tag = f"bspline_qkv_grouped_bwd {label} N={n} H={heads} dh={dh} out={out}"
    _, _, got = grads_of(torch, lambda *a: FB.bspline_qkv_grouped(a[0], grid, *a[1:]),
                         inputs, g)
    leaves, y, want = grads_of(torch, plain, inputs, g)
    _, _, again = grads_of(torch, lambda *a: FB.bspline_qkv_grouped(a[0], grid, *a[1:]),
                           inputs, g)
    torch.cuda.synchronize()
    err = compare_grads(f"{tag} grid {tuple(grid.shape)}", names, got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"bspline_qkv_grouped_bwd {label}: a second backward gave other bits")
    _, _, want64 = grads_of(torch, lambda *a: plain(*a).double(),
                            [a.double() for a in inputs], g.double())
    f64 = {f"f64_err_d{nm}": f64_gate(f"{tag} d{nm}", a, b, c)
           for nm, a, b, c in zip(names, got, want, want64)}
    del want64
    w = FB.pack_qkv_weight(*inputs[1:]).contiguous()

    def kernels():
        return FB._launch_bwd("bspline_qkv_grouped_bwd", "bspline", x, w, grid, g, True,
                              True)

    def cuda_cores():  # the CUDA-core kernels the route replaces
        return FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, g, True, True)

    ms = time_ms(torch, kernels)
    dev_ms = kernel_ms(torch, kernels, 10, label=tag)
    core_ms = time_ms(torch, cuda_cores)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(y, leaves, g,
                                                          retain_graph=True))
    bounds = kan_bound(n, heads, 9, dh, out, True, tensor_cores=True)
    print(f"[kernel] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f}; the CUDA-core "
          f"kernels {core_ms:.4f})  plain autograd {plain_ms:.4f} ms  bound 3xTF32 "
          f"{bounds['bound_ms']:.4f}, f32 {bounds['f32_bound_ms']:.4f}  (bits repeated)")
    return err, ms, plain_ms, {**f64, "device_ms": dev_ms, "cuda_core_ms": core_ms}, bounds


def check_attention_bwd(torch, rng, b, t, heads, dh, label, cases):
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((b, t, heads * dh))
                         .astype(np.float32)).cuda()

    def through(attn, causal, mask):
        def fn(y):
            y4 = y.view(b, t, heads, 3 * dh)
            q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
            return attn(q, k, v, heads, causal=causal, mask=mask)
        return fn

    errs = []
    for causal, mask in cases:
        _, _, (got,) = grads_of(torch, through(FA.flash_attention_lanes, causal, mask),
                                [y], g)
        _, _, (want,) = grads_of(torch, through(A.lanes_attention, causal, mask),
                                 [y], g)
        torch.cuda.synchronize()
        tag = f"causal={causal} mask={'none' if mask is None else 'yes'}"
        errs.append(compare(f"flash_attention_lanes_bwd {label} B={b} T={t} "
                            f"H={heads} dh={dh} {tag} dqkv", got, want, TOL_BWD))
        if mask is not None:
            dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
            check(bool((got.view(b, t, -1)[dead] == 0).all()),
                  "a fully masked batch item must get gradients of exactly 0")
    causal, mask = cases[0]
    _, _, (first,) = grads_of(torch, through(FA.flash_attention_lanes, causal, mask),
                              [y], g)
    _, _, (again,) = grads_of(torch, through(FA.flash_attention_lanes, causal, mask),
                              [y], g)
    check(torch.equal(first, again), f"flash_attention_lanes_bwd {label}: the "
                                     "bits of a repeated backward differ")
    y4 = y.view(b, t, heads, 3 * dh)
    q4, k4, v4 = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    maskb = None if mask is None else A.key_valid(mask, b, t, y.device).to(torch.uint8)
    o, stats = FA._launch(q4, k4, v4, maskb, causal, True)
    ms = time_ms(torch, lambda: FA._launch_bwd(q4, k4, v4, maskb, o, stats, g, causal))
    dev_ms = kernel_ms(torch, lambda: FA._launch_bwd(q4, k4, v4, maskb, o, stats, g,
                                                     causal))
    leaves, out, _ = grads_of(torch, through(A.lanes_attention, causal, mask), [y], g)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    views = [a.transpose(1, 2) for a in (q4, k4, v4)]
    lib_ms = sdpa_ms(torch, *views, causal, mask, backward="qkv")
    lib_dev_ms = sdpa_ms(torch, *views, causal, mask, backward="qkv", device=True)
    print(f"[kernel] flash_attention_lanes_bwd {label}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f})  plain autograd {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention backward {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f})")
    return errs[0], ms, plain_ms, {"device_ms": dev_ms,
                                   "library_device_ms": lib_dev_ms}, attention_bound(
        b, heads, t, t, dh, causal, "bwd", lib_ms, tensor_cores=dh in FA.TC_HEAD_DIMS)


def phase_backward_kernels(torch):
    rng = np.random.default_rng(SEED + 3)
    results = {
        "bspline_kan_bwd": check_bspline_bwd(torch, rng, BATCH * 196, 768, 384,
                                             "vit-s embedder"),
        "bspline_qkv_grouped_bwd": check_qkv_bwd(torch, rng, BATCH * 197, 6, 64,
                                                 "vit-s q/k/v"),
        "flash_attention_lanes_bwd": check_attention_bwd(
            torch, rng, BATCH, 197, 6, 64, "vit-s", [(False, None)]),
    }
    # ragged, narrow: the reference MNIST geometry with an odd batch of 37
    check_bspline_bwd(torch, rng, 37 * 49, 16, 64, "mnist embedder")
    check_qkv_bwd(torch, rng, 37 * 50, 2, 32, "mnist q/k/v")
    mask = torch.from_numpy(rng.random((37, 50)) > 0.2).cuda()
    mask[0] = False          # batch item 0: every row fully masked
    mask[1, 0] = False       # batch item 1, causal: query 0 sees no key
    check_attention_bwd(torch, rng, 37, 50, 2, 32, "mnist",
                        [(False, mask), (True, mask), (True, None)])
    results["bspline_qkv_grouped_bwd"] += (
        {"at_dh_8_mnist": sub_entry(check_qkv_bwd(torch, rng, BATCH * 50, 8, 8,
                                                  "dh-8 mnist q/k/v"))},
        {"refit_grids_per_head": sub_entry(check_qkv_bwd(
            torch, rng, BATCH * 197, 6, 64, "vit-s refit grids a head",
            per_head=True))})
    for key, b, t, heads, dh in ATTN_GEOMETRIES:
        results["flash_attention_lanes_bwd"] += ({key: sub_entry(check_attention_bwd(
            torch, rng, b, t, heads, dh, key[3:], attention_cases(torch, rng, b, t)))},)
    return results


# --------------------------------------------------------------------------
# Phase 5: the tiled attention kernels against their plain versions
# --------------------------------------------------------------------------

def flash_inputs(torch, rng, b, h, tq, tk, dh):
    """q, k, v as ``(B, H, T, dh)`` views of ``(B, T, H, dh)`` tensors, the
    layout ``FlashAttentionBlock`` hands them over in."""
    def draw(t):
        return torch.from_numpy(rng.standard_normal((b, t, h, dh))
                                .astype(np.float32)).cuda().transpose(1, 2)
    return draw(tq), draw(tk), draw(tk)


def check_flash(torch, rng, b, h, tq, tk, dh, causal, mask, label, iters):
    """Forward, dq and dk/dv of ``flash_attention`` (tiled tier, buckets
    512/1024) against ``flash_attention_reference`` and autograd through
    it, and the bits of a repeated forward and backward; times of each
    kernel alone (CUDA events, and its device time from the profiler) and
    of its plain counterpart (the plain forward; autograd's backward to q,
    and to k and v), and ``scaled_dot_product_attention``'s. Returns ``(o,
    v, {kernel: (err, ms, plain_ms, extras, bound)})``."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    q, k, v = flash_inputs(torch, rng, b, h, tq, tk, dh)
    g = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(np.float32)).cuda()
    keys = None if mask is None else A.key_valid(mask, b, tk, mask.device)
    check(not FA.use_small(tq, tk, dh, h, 512, 1024), f"{label}: not the tiled tier")

    def kernel(*a):
        return FA.flash_attention(*a, causal, 512, 1024, mask)

    def plain(*a):
        return A.flash_attention_reference(*a, causal, 512, 1024, keys)[0]

    tag = (f"{label} B={b} H={h} Tq={tq} Tk={tk} dh={dh} causal={causal} "
           f"mask={'none' if mask is None else 'yes'}")
    with torch.inference_mode():
        o = kernel(q, k, v)
        err_fwd = compare(f"flash_attention {tag}", o, plain(q, k, v), TOL_ATTN)
        same_fwd = torch.equal(o, kernel(q, k, v))
    _, _, got = grads_of(torch, kernel, [q, k, v], g)
    _, _, again = grads_of(torch, kernel, [q, k, v], g)
    leaves, out, want = grads_of(torch, plain, [q, k, v], g)
    torch.cuda.synchronize()
    err_dq = compare(f"flash_attention_dq {tag} dq", got[0], want[0], TOL_BWD)
    err_dkv = max(compare(f"flash_attention_dkv {tag} d{nm}", a, w, TOL_BWD)
                  for nm, a, w in zip("kv", got[1:], want[1:]))
    same_bwd = all(torch.equal(a, w) for a, w in zip(got, again))
    print(f"[kernel] tiled attention {label}: bits repeat forward {same_fwd}, "
          f"backward {same_bwd}")
    check(same_fwd and same_bwd, f"tiled attention {label}: the bits of a "
                                 "repeated forward or backward differ")

    maskb = None if keys is None else keys.to(torch.uint8).contiguous()
    do = g.transpose(1, 2).contiguous()
    with torch.inference_mode():
        o4, stats = FA._launch_tiled(q, k, v, maskb, causal, True)
        _, delta = FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal)
        calls = {
            "fwd": lambda: FA._launch_tiled(q, k, v, maskb, causal, False),
            "dq": lambda: FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal),
            "dkv": lambda: FA._launch_tiled_dkv(q, k, v, maskb, stats, do, delta,
                                                causal),
        }
        ms = {part: time_ms(torch, fn, iters, 2) for part, fn in calls.items()}
        ms.update({f"{part} device": kernel_ms(torch, fn, iters, 2)
                   for part, fn in calls.items()})
        ms["plain fwd"] = time_ms(torch, lambda: plain(q, k, v), iters, 2)
    ms["plain dq"] = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves[:1], g, retain_graph=True), iters, 2)
    ms["plain dkv"] = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves[1:], g, retain_graph=True), iters, 2)
    for part in ("fwd", "dq", "dkv"):
        grad_of = None if part == "fwd" else part[1:]
        ms[f"sdpa {part}"] = sdpa_ms(torch, q, k, v, causal, keys, grad_of, iters)
        ms[f"sdpa {part} device"] = sdpa_ms(torch, q, k, v, causal, keys, grad_of,
                                            iters, device=True)
    print(f"[kernel] tiled attention {label}: " + "  ".join(
        f"{key} {val:.4f} ms" for key, val in ms.items()))
    tc = dh in FA.TC_HEAD_DIMS
    results = {}
    for name, part, err in (("flash_attention", "fwd", err_fwd),
                            ("flash_attention_dq", "dq", err_dq),
                            ("flash_attention_dkv", "dkv", err_dkv)):
        bnd = attention_bound(b, h, tq, tk, dh, causal and tq == tk, part,
                              ms[f"sdpa {part}"], tensor_cores=tc)
        results[name] = (err, ms[part], ms[f"plain {part}"],
                         {"device_ms": ms[f"{part} device"],
                          "library_device_ms": ms[f"sdpa {part} device"]}, bnd)
        print(f"[kernel] {name} {label}: {ms[part]:.4f} ms (device "
              f"{ms[f'{part} device']:.4f}); bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}, {bnd['bound_ms'] / ms[f'{part} device']:.1%} of "
              f"the device time)" + (f", f32 bound {bnd['f32_bound_ms']:.4f}" if tc
                                     else ""))
    return o, v, results


def check_flash_f64(torch, rng):
    """The tiled forward at dh 64 on the decoder's seq 2048 (B 2, H 4,
    causal) against ``flash_attention_reference`` in f64 on the card:
    within TOL_ATTN_F64 x max(1, max|o|), the accuracy of f32."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    q, k, v = flash_inputs(torch, rng, 2, 4, 2048, 2048, 64)
    with torch.inference_mode():
        o = FA.flash_attention(q, k, v, True, 512, 1024)
        exact = A.flash_attention_reference(q.double(), k.double(), v.double(),
                                            True, 512, 1024)[0]
    err = float((o.double() - exact).abs().max()) / max(1.0, float(exact.abs().max()))
    print(f"[kernel] flash_attention B=2 H=4 T=2048 dh=64 causal: against f64 on "
          f"the card {err:.3e} of max(1, max|o|)  limit {TOL_ATTN_F64:.0e}")
    check(err <= TOL_ATTN_F64, f"flash_attention: {err:.3e} from f64, over "
                               f"{TOL_ATTN_F64:.0e}")
    return err


def check_no_visible_key(torch, o, v, mask, rows, item, label, tol=TOL_ATTN):
    """Rows of ``item`` that see no valid key causally are the mean of v
    over every valid key (the tiled tier's semantics), or 0 with none;
    within ``tol`` x max(1, max|mean|) (bf16: one ulp)."""
    valid = mask[item].bool()
    want = (v[item][:, valid].mean(dim=1) if bool(valid.any())
            else torch.zeros_like(v[item][:, 0]))
    err = float((o[item][:, rows] - want[:, None]).abs().max())
    print(f"[kernel] tiled attention {label}: rows with no visible valid key "
          f"against the mean of v over the valid keys: max|err| {err:.3e}")
    check(err <= tol * max(1.0, float(want.abs().max())),
          f"{label}: rows with no visible valid key are not the mean of v")


def check_single_tile(torch, rng):
    """``flash_attention`` where kanvit's ``_use_small`` holds: the lanes
    kernels on (B, T, H, dh) views, against ``lanes_attention``. Returns
    the forward's and the backward's sub-entries, with the route's device
    time (kernel_ms: the lanes kernel and the route's copies) beside the
    CUDA events' time of its calls."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    b, h, t, dh = 16, 4, 256, 64
    check(FA.use_small(t, t, dh, h, 512, 1024), "single tile: not the small tier")
    q, k, v = flash_inputs(torch, rng, b, h, t, t, dh)
    mask = torch.from_numpy(rng.random((b, t)) > 0.2).cuda()
    mask[0, :4] = False
    g = torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32)).cuda()

    def plain(*a):
        o = A.lanes_attention(*(x.transpose(1, 2) for x in a), h, causal=True,
                              mask=mask)
        return o.view(b, t, h, dh).transpose(1, 2)

    def kernel(*a):
        return FA.flash_attention(*a, True, 512, 1024, mask)

    reset_counts()
    leaves, out, got = grads_of(torch, kernel, [q, k, v], g)
    plain_leaves, ref, want = grads_of(torch, plain, [q, k, v], g)
    torch.cuda.synchronize()
    counts = launch_counts()
    tag = f"single-tile route B={b} H={h} T={t} dh={dh} causal masked"
    err = compare(f"flash_attention {tag}", out.detach(), ref.detach(), TOL_ATTN)
    err_bwd = compare_grads(f"flash_attention {tag}", ("q", "k", "v"), got, want)
    check(bool((out[0, :, :4] == 0).all()),
          "single tile: rows with no visible valid key must be 0")
    check(counts["flash_attention_lanes"] == 1 and counts["flash_attention_lanes_bwd"] == 1
          and counts["flash_attention"] == 0,
          f"single tile: launches {counts}, want one lanes forward and backward")
    with torch.inference_mode():
        ms = {"fwd": time_ms(torch, lambda: kernel(q, k, v)),
              "fwd device": kernel_ms(torch, lambda: kernel(q, k, v),
                                      label=f"{tag} fwd"),
              "plain fwd": time_ms(torch, lambda: plain(q, k, v))}

    def backward():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)
    ms["bwd"] = time_ms(torch, backward)
    ms["bwd device"] = kernel_ms(torch, backward, label=f"{tag} bwd")
    ms["plain bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        ref, plain_leaves, g, retain_graph=True))
    for part, grad_of in (("fwd", None), ("bwd", "qkv")):
        for key, device in ((part, False), (f"{part} device", True)):
            ms[f"scaled_dot_product_attention {key}"] = sdpa_ms(
                torch, q, k, v, True, mask, backward=grad_of, device=device)
    print(f"[kernel] {tag}: " + "  ".join(f"{key} {val:.4f} ms"
                                          for key, val in ms.items()))
    sdpa = "scaled_dot_product_attention"
    return tuple((e, ms[part], ms[f"plain {part}"],
                  {"device_ms": ms[f"{part} device"],
                   "library_device_ms": ms[f"{sdpa} {part} device"]},
                  attention_bound(b, h, t, t, dh, True, part, ms[f"{sdpa} {part}"],
                                  tensor_cores=True))
                 for e, part in ((err, "fwd"), (err_bwd, "bwd")))


def phase_flash_kernels(torch):
    rng = np.random.default_rng(SEED + 4)
    _, _, main = check_flash(torch, rng, 16, 4, 2048, 2048, 64, True, None,
                             "decoder seq 2048", iters=10)
    _, _, long = check_flash(torch, rng, 4, 4, 8192, 8192, 64, True, None,
                             "decoder seq 8192", iters=3)
    # tq < tk: rows 0-216 sit at qpos < 0 and see no key; item 1 masks every
    # key, item 0 keys 0-3
    mask = torch.from_numpy(rng.random((3, 517)) > 0.2).cuda()
    mask[0, :4] = False
    mask[1] = False
    o, v, _ = check_flash(torch, rng, 3, 2, 300, 517, 32, True, mask,
                          "ragged tq<tk masked", iters=3)
    for item in (0, 1, 2):
        check_no_visible_key(torch, o, v, mask, slice(0, 217), item,
                             f"ragged tq<tk masked, item {item}")
    # tq == tk, keys 0-3 masked: causal rows 0-3 see no valid key
    mask = torch.ones(2, 1000, dtype=torch.bool, device="cuda")
    mask[0, :4] = False
    o, v, _ = check_flash(torch, rng, 2, 2, 1000, 1000, 16, True, mask,
                          "keys 0-3 masked", iters=3)
    check_no_visible_key(torch, o, v, mask, slice(0, 4), 0, "keys 0-3 masked")
    # head dim 8 (tensor cores) and two the generic kernels take
    by_dh = {}
    for key, dh in (("at_dh_8", 8), ("at_dh_40_generic", 40),
                    ("at_dh_128_generic", 128)):
        o, v, by_dh[key] = check_flash(torch, rng, 2, 2, 1000, 1000, dh, True, mask,
                                       f"keys 0-3 masked dh {dh}", iters=3)
        check_no_visible_key(torch, o, v, mask, slice(0, 4), 0,
                             f"keys 0-3 masked dh {dh}")
    err64 = check_flash_f64(torch, rng)
    out = {name: (*main[name], {"at_seq_8192_batch_4": sub_entry(long[name])},
                  *({key: sub_entry(r[name])} for key, r in by_dh.items()))
           for name in main}
    out["flash_attention"] += ({"err_vs_f64": err64},)
    return out


# --------------------------------------------------------------------------
# Phase 5b: the tiled attention's bf16 kernels
# --------------------------------------------------------------------------

def flash_bf16_inputs(torch, rng, b, h, tq, tk, dh):
    """bf16 q as a ``(B, H, T, dh)`` view of a ``(B, T, H*dh)`` projection,
    k and v of one ``(B, T, 2*H*dh)`` projection's two halves, as
    ``FlashAttentionBlock`` hands them over; do ``(B, H, Tq, dh)``."""
    def draw(t, width):
        return torch.from_numpy(rng.standard_normal((b, t, width)).astype(np.float32)
                                ).cuda().to(torch.bfloat16)

    q = draw(tq, h * dh).view(b, tq, h, dh).transpose(1, 2)
    k, v = (a.view(b, tk, h, dh).transpose(1, 2) for a in draw(tk, 2 * h * dh).chunk(2, -1))
    return q, k, v, draw(tq, h * dh).view(b, tq, h, dh).transpose(1, 2)


def attention_bound_bf16(b, h, tq, tk, dh, causal, part, library_ms=None):
    """The tiled bf16 kernels' work: 2 tq tk dh FLOPs a product (causal:
    the pairs at or before each query, tq == tk), forward 2 products, dq 3
    (s, dp, dq), dk/dv 4 (s, dp, dv, dk), at the dense bf16 rate; bytes:
    bf16 q, k, v, o (+ do, and dq or dk, dv) read or written once, f32
    (m, l) and delta."""
    pairs = tk * (tk + 1) / 2 if causal else tq * tk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[part]
    row, col, rows = b * h * tq * dh, b * h * tk * dh, b * h * tq
    nbytes = {"fwd": 2 * (2 * row + 2 * col) + 4 * 2 * rows,
              "dq": 2 * (4 * row + 2 * col) + 4 * 3 * rows,
              "dkv": 2 * (2 * row + 4 * col) + 4 * 3 * rows}[part]
    return bf16_bound(2.0 * b * h * pairs * dh * products, float(nbytes), library_ms)


def check_flash_bf16(torch, rng, b, h, tq, tk, dh, causal, mask, label, iters,
                     f64=False):
    """The bf16 tiled forward, dq and dk/dv kernels, each launched alone on
    the decoder's layout, against their plain twins on the card
    (``A.flash_attention_bf16`` over kanvit's 1,024-key blocks, and
    ``A.flash_attention_bwd_bf16`` on the kernel forward's o and (m, l)):
    o within one bf16 ulp plus the two-sided p term (2^-7 of the twin's
    attention over |v|: the kernel rounds p against its 32-key tiles'
    running max, the twin against kanvit's blocks'), (m, l) within
    TOL_FLASH_STATS, each gradient within one ulp plus one of each rounded
    p and ds (2^-8 of ``spread=True``) and no further from the same
    function in f64 (``exact=True``) than twice the twin; a row that sees
    no valid key the mean of v over the valid keys; the bits of a repeated
    forward and backward; with ``f64`` the forward no further from the f64
    reference than twice the twin. Times of each kernel (CUDA events, device), of the
    twin (forward; the whole backward for dq and dk/dv) and of
    ``scaled_dot_product_attention`` in bf16 (forward; backward to q, to k
    and v, and to all three). Returns ``(o, v, {kernel: (err, ms, plain_ms,
    extras, bound)})``."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    q, k, v, g = flash_bf16_inputs(torch, rng, b, h, tq, tk, dh)
    keys = None if mask is None else A.key_valid(mask, b, tk, mask.device)
    maskb = None if keys is None else keys.to(torch.uint8).contiguous()
    check(not FA.use_small(tq, tk, dh, h, 512, 1024, 2), f"{label}: not the tiled tier")
    tag = (f"bf16 {label} B={b} H={h} Tq={tq} Tk={tk} dh={dh} causal={causal} "
           f"mask={'none' if mask is None else 'yes'}")
    do = g.transpose(1, 2).contiguous()

    def forward():
        return FA._launch_tiled(q, k, v, maskb, causal, True)

    def backward(o4, stats):
        dq, delta = FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal)
        return (dq, *FA._launch_tiled_dkv(q, k, v, maskb, stats, do, delta, causal))

    with torch.inference_mode():
        o4, stats = forward()
        grads4 = backward(o4, stats)
        again4, again_stats = forward()
        again = backward(again4, again_stats)
        same = (torch.equal(o4, again4) and torch.equal(stats, again_stats)
                and all(torch.equal(a, w) for a, w in zip(grads4, again)))
        o = o4.transpose(1, 2)
        check(o.dtype == torch.bfloat16 and all(a.dtype == torch.bfloat16 for a in grads4),
              f"{tag}: the kernels' outputs are not bf16")
        twin, m, l = A.flash_attention_bf16(q, k, v, causal, 1024, keys)
        spread_o = A.flash_attention_bf16(q, k, v.abs(), causal, 1024, keys)[0]
        err_fwd = bf16_ulp_gate(f"flash_attention_bf16 {tag}", o, twin, spread_o,
                                BF16_P_TWO_SIDED)
        err_m = float((stats[..., 0] - m).abs().max()) / max(1.0, float(m.abs().max()))
        err_l = float(((stats[..., 1] - l).abs() / l.clamp_min(1.0)).max())
        print(f"[bf16] flash_attention_bf16 {tag}: (m, l) against the twin's: m "
              f"{err_m:.3e} of max(1, max|m|), l {err_l:.3e} of max(1, l)  limit "
              f"{TOL_FLASH_STATS:.0e}")
        check(err_m <= TOL_FLASH_STATS and err_l <= TOL_FLASH_STATS,
              f"{tag}: the forward's (m, l) differ from the twin's")
        want = A.flash_attention_bwd_bf16(q, k, v, o, g, stats[..., 0], stats[..., 1],
                                          causal, keys)
        spread = A.flash_attention_bwd_bf16(q, k, v, o, g, stats[..., 0], stats[..., 1],
                                            causal, keys, spread=True)
        errs = {nm: bf16_ulp_gate(f"flash_attention_{part}_bf16 {tag} {nm}",
                                  a.transpose(1, 2), w, sp)
                for nm, part, a, w, sp in zip(("dq", "dk", "dv"), ("dq", "dkv", "dkv"),
                                              grads4, want, spread)}
        del spread, spread_o
        # the same function in f64 with nothing rounded, a batch item at a time
        exact = [torch.cat(parts, 0) for parts in zip(*(
            A.flash_attention_bwd_bf16(q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1],
                                       g[i:i + 1], stats[i:i + 1, ..., 0],
                                       stats[i:i + 1, ..., 1], causal,
                                       None if keys is None else keys[i:i + 1], exact=True)
            for i in range(b)))]
        grad_f64 = {nm: f64_gate(f"flash_attention_{part}_bf16 {tag} {nm}", a.transpose(1, 2),
                                 w, e, "bf16 plain twin")
                    for nm, part, a, w, e in zip(("dq", "dk", "dv"), ("dq", "dkv", "dkv"),
                                                 grads4, want, exact)}
        del want, exact
        print(f"[kernel] tiled attention {tag}: bits repeat forward and backward {same}")
        check(same, f"{tag}: the bits of a repeated forward or backward differ")
        extras = {}
        if f64:
            exact = A.flash_attention_bf16(q, k, v, causal, 1024, keys, exact=True)[0]
            extras["f64_err"] = f64_gate(f"flash_attention_bf16 {tag}", o, twin, exact,
                                         "bf16 plain twin")
            del exact
        del twin
        delta = FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal)[1]
        calls = {"fwd": lambda: FA._launch_tiled(q, k, v, maskb, causal, False),
                 "dq": lambda: FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal),
                 "dkv": lambda: FA._launch_tiled_dkv(q, k, v, maskb, stats, do, delta,
                                                    causal)}
        ms = {part: time_ms(torch, fn, iters, 2) for part, fn in calls.items()}
        ms.update({f"{part} device": kernel_ms(torch, fn, iters, 2)
                   for part, fn in calls.items()})
        ms["plain fwd"] = time_ms(torch, lambda: A.flash_attention_bf16(
            q, k, v, causal, 1024, keys), max(1, iters // 2), 1)
        ms["plain bwd"] = time_ms(torch, lambda: A.flash_attention_bwd_bf16(
            q, k, v, o, g, stats[..., 0], stats[..., 1], causal, keys), max(1, iters // 2), 1)
    for part, grad_of in (("fwd", None), ("dq", "q"), ("dkv", "kv"), ("bwd", "qkv")):
        ms[f"sdpa {part}"] = sdpa_ms(torch, q, k, v, causal, keys, grad_of, iters)
        ms[f"sdpa {part} device"] = sdpa_ms(torch, q, k, v, causal, keys, grad_of, iters,
                                            device=True)
    print(f"[bf16] tiled attention {tag}: " + "  ".join(
        f"{key} {val:.4f} ms" for key, val in ms.items()))
    results = {}
    for name, part, err in (("flash_attention_bf16", "fwd", err_fwd),
                            ("flash_attention_dq_bf16", "dq", errs["dq"]),
                            ("flash_attention_dkv_bf16", "dkv", max(errs["dk"], errs["dv"]))):
        bnd = attention_bound_bf16(b, h, tq, tk, dh, causal and tq == tk, part,
                                   ms[f"sdpa {part}"])
        plain = ms["plain fwd" if part == "fwd" else "plain bwd"]
        grad_err = {"fwd": {}, "dq": {"grad_f64_err": grad_f64["dq"]},
                    "dkv": {"grad_f64_err": max(grad_f64["dk"], grad_f64["dv"])}}[part]
        results[name] = (err, ms[part], plain,
                         {"device_ms": ms[f"{part} device"],
                          "library_device_ms": ms[f"sdpa {part} device"],
                          "library_bwd_ms": ms["sdpa bwd"],
                          "library_bwd_device_ms": ms["sdpa bwd device"], **extras,
                          **grad_err},
                         bnd)
        print(f"[bf16] {name} {tag}: {ms[part]:.4f} ms (device {ms[f'{part} device']:.4f}); "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
              f"{bnd['bound_ms'] / ms[f'{part} device']:.1%} of the device time); "
              f"scaled_dot_product_attention bf16 {ms[f'sdpa {part}']:.4f} (device "
              f"{ms[f'sdpa {part} device']:.4f})")
    return o, v, results


def phase_flash_bf16_kernels(torch):
    """Phase 5b: the tiled attention's three bf16 kernels at the causal
    decoder's shapes (B 16, H 4, T 2048, the forward also against f64; B
    4, H 4, T 8192; dh 64), then at ragged masked shapes at dh 8, 16 and
    32 whose rows see no valid key (sub-entries) and at the backward's tile
    edges at dh 64 (``flash_bf16_edges``), then at the generic head dims:
    the decoder's shapes at 2 heads of 128, ragged masked shapes at dh 24,
    40, 72 and 120 and the tile edges at dh 128."""
    rng = np.random.default_rng(SEED + 12)
    _, _, main = check_flash_bf16(torch, rng, 16, 4, 2048, 2048, 64, True, None,
                                  "decoder seq 2048", iters=10, f64=True)
    _, _, long = check_flash_bf16(torch, rng, 4, 4, 8192, 8192, 64, True, None,
                                  "decoder seq 8192", iters=3)
    subs = {}
    # tq < tk: rows 0-216 sit at qpos < 0 and see no key; item 1 masks every
    # key, item 0 keys 0-3
    mask = torch.from_numpy(rng.random((3, 517)) > 0.2).cuda()
    mask[0, :4] = False
    mask[1] = False
    o, v, subs["ragged_tq_lt_tk_masked_dh_32"] = check_flash_bf16(
        torch, rng, 3, 2, 300, 517, 32, True, mask, "ragged tq<tk masked", iters=3)
    for item in (0, 1, 2):
        check_no_visible_key(torch, o.float(), v.float(), mask, slice(0, 217), item,
                             f"bf16 ragged tq<tk masked, item {item}", tol=BF16_ULP_REL)
    # tq == tk, keys 0-3 masked: causal rows 0-3 see no valid key
    mask = torch.ones(2, 1000, dtype=torch.bool, device="cuda")
    mask[0, :4] = False
    for dh in (16, 8):
        o, v, subs[f"keys_0_3_masked_dh_{dh}"] = check_flash_bf16(
            torch, rng, 2, 2, 1000, 1000, dh, True, mask, f"keys 0-3 masked dh {dh}",
            iters=3)
        check_no_visible_key(torch, o.float(), v.float(), mask, slice(0, 4), 0,
                             f"bf16 keys 0-3 masked dh {dh}", tol=BF16_ULP_REL)
    # not causal, tq > tk, a key mask
    mask = torch.from_numpy(rng.random((2, 700)) > 0.3).cuda()
    _, _, subs["not_causal_tq_gt_tk_masked_dh_64"] = check_flash_bf16(
        torch, rng, 2, 3, 900, 700, 64, False, mask, "not causal tq>tk masked", iters=3)
    subs.update(flash_bf16_edges(torch, rng, 64))
    subs.update(flash_bf16_generic(torch))
    return {name: (*main[name], {"at_seq_8192_batch_4": sub_entry(long[name])},
                   *({key: sub_entry(r[name])} for key, r in subs.items()))
            for name in main}


def flash_bf16_edges(torch, rng, dh):
    """The tiled bf16 kernels at the backward's tile edges (blocks of 128
    resident rows, two consumers of 64, streamed tiles of 64) at head dim
    ``dh``: tq = tk = 577 (just past 9 x 64) and 641 (just past 5 x 128),
    causal; tk > tq causal (449 queries, 705 keys: rows 0-255 at qpos < 0);
    masked keys with rows that see no valid key (tq 193 < tk 257, keys 0-3
    of item 0 off, item 1 all off). Returns the sub-entries."""
    subs = {}
    for b, h, tq, tk in ((2, 2, 577, 577), (1, 3, 641, 641), (2, 2, 449, 705)):
        subs[f"edge_tq_{tq}_tk_{tk}_dh_{dh}"] = check_flash_bf16(
            torch, rng, b, h, tq, tk, dh, True, None, f"edge tq {tq} tk {tk} dh {dh}",
            iters=3)[2]
    mask = torch.from_numpy(rng.random((2, 257)) > 0.2).cuda()
    mask[0, :4] = False
    mask[1] = False
    o, v, subs[f"edge_masked_tq_193_tk_257_dh_{dh}"] = check_flash_bf16(
        torch, rng, 2, 2, 193, 257, dh, True, mask, f"edge masked dh {dh}", iters=3)
    for item in (0, 1):  # qpos < 4: keys 0-3 of item 0 masked
        check_no_visible_key(torch, o.float(), v.float(), mask, slice(0, 257 - 193 + 4), item,
                             f"bf16 edge masked dh {dh}, item {item}", tol=BF16_ULP_REL)
    return subs


def flash_bf16_generic(torch):
    """The tiled bf16 kernels at head dims outside 8/16/32/64 (the forward's
    instantiation padded to 128; the backward's DH 64 through dh 64, DH 128
    past it): the decoder's shapes at 2 heads of 128 (``bench_decoder
    --bf16 --heads 2``: B 16, T 2048, the forward also against f64; B 4, T
    8192), then ragged masked shapes at dh 24, 40, 72 and 120 (odd
    multiples of 8 but 40: a 16-deep step's upper half past dh), rows that
    see no valid key among them, then the backward's tile edges at dh 128
    and a ragged masked shape at each other multiple of 8 through 128.
    Returns the sub-entries."""
    rng = np.random.default_rng(SEED + 14)
    subs = {}
    _, _, subs["decoder_dh_128_seq_2048"] = check_flash_bf16(
        torch, rng, 16, 2, 2048, 2048, 128, True, None, "decoder dh 128 seq 2048",
        iters=10, f64=True)
    _, _, subs["decoder_dh_128_seq_8192"] = check_flash_bf16(
        torch, rng, 4, 2, 8192, 8192, 128, True, None, "decoder dh 128 seq 8192", iters=3)
    # tq < tk: rows 0-216 at qpos < 0 see no key; item 1 masks every key
    mask = torch.from_numpy(rng.random((3, 517)) > 0.2).cuda()
    mask[0, :4] = False
    mask[1] = False
    for dh, causal, tq in ((24, True, 300), (40, False, 700), (72, True, 300),
                           (120, True, 517)):
        label = f"ragged masked dh {dh}"
        o, v, subs[f"ragged_masked_dh_{dh}"] = check_flash_bf16(
            torch, rng, 3, 2, tq, 517, dh, causal, mask, label, iters=3)
        if causal:
            rows = slice(0, 517 - tq + 4)  # qpos < 4: keys 0-3 of item 0 masked
            for item in (0, 1):
                check_no_visible_key(torch, o.float(), v.float(), mask, rows, item,
                                     f"bf16 {label}, item {item}", tol=BF16_ULP_REL)
    subs.update(flash_bf16_edges(torch, rng, 128))
    # the other multiples of 8 through 128, causal, rows 0-216 at qpos < 0,
    # keys 0-3 of item 0 masked (so every dh runs here)
    mask = torch.from_numpy(rng.random((2, 517)) > 0.2).cuda()
    mask[0, :4] = False
    for dh in (48, 56, 80, 88, 96, 104, 112):
        subs[f"sweep_dh_{dh}"] = check_flash_bf16(
            torch, rng, 2, 2, 300, 517, dh, True, mask, f"sweep dh {dh}", iters=3)[2]
    return subs


# --------------------------------------------------------------------------
# Phases 6 and 7: the Chebyshev, Fourier, RBF and sine kernels
# --------------------------------------------------------------------------

def cheby_inputs(rng, shape, saturated):
    """Normal inputs with a share where tanh(x) rounds to +-1 in f32
    (|x| in [9.5, 20], either sign): there the kernels' derivative is
    T'_n(+-1) (1 - t^2) = 0, and must be finite."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = (rng.uniform(9.5, 20.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


def fourier_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-10, 10]."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-10.0, 10.0, flat[::7].size).astype(np.float32)
    return x


def f64_gate(tag, got, plain32, exact, plain="plain f32"):
    """The kernel's result no further from f64 than twice the plain f32
    version's (``plain``: what that version is), each x max(1, max|exact|)."""
    scale = max(1.0, float(exact.abs().max()))
    k = float((got.double() - exact).abs().max()) / scale
    p = float((plain32.double() - exact).abs().max()) / scale
    ok = bool(got.isfinite().all()) and k <= 2 * p
    print(f"[kernel] {tag} against f64: kernel {k:.3e}, {plain} {p:.3e} (x max(1, "
          f"max|.|); limit twice the plain's)  {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: further from f64 than twice the {plain} version "
              f"({k:.3e} > 2 x {p:.3e})")
    return k


def check_kan(torch, rng, name, label, kernel, plain, inputs, names, launches,
              shape, f64=False, tc_grads=(), f64_gates=False, cuda_cores=None,
              fwd_cuda_cores=None, kernel_grads=None):
    """Forward, dx and the parameter gradients of a KAN wrapper against its
    plain version and autograd through it, on the card; the backward's bits
    repeated; CUDA-event times of the forward kernel, the backward kernels
    (everything, and as on the training path: no dx for an embedder), the
    plain forward and autograd's backward. ``launches`` is ``(forward(),
    backward(g), backward_train(g))``, the launches alone; ``shape`` ``(n,
    G, S, nin, out, extra floats, contractions of the training path's
    backward)`` for the bound. ``f64``: also hold the gradients against
    autograd through the plain version in f64 within TOL_BWD.

    ``tc_grads``: the wrapper runs the tensor-core kernels, whose weight
    gradients (and sine's dfreq) are these inputs': the training path's
    backward (no dx) is held against the plain version too and repeats the
    all-gradients route's bits, the bounds are the 3xTF32 ones, the device
    times are measured, and with ``f64_gates`` the forward and these
    gradients on both routes are held no further from f64 than twice the
    plain f32 version.

    ``cuda_cores(g)``: the backward is a grouped q/k/v's on the tensor cores
    (3xTF32), and this launches the CUDA-core kernels it replaces on the
    same operands: the gradients the kernels compute (``kernel_grads``, by
    default all) are held no further from f64 than twice the plain f32
    version, the rest (a bias's sum over the rows, which PyTorch computes
    outside every kernel) printed beside them, the backward's device time
    is measured beside the CUDA-core kernels' time (with ``tc_grads``, also
    their no-dx time, ``cuda_cores(g, False)``), and its bounds are the
    3xTF32 ones.

    ``fwd_cuda_cores()``: the forward is a grouped q/k/v's on the tensor
    cores (3xTF32), and this launches the CUDA-core kernel it replaces on
    the same operands: the forward is held no further from f64 than twice
    the plain f32 version, a second forward must repeat its bits, its
    device time is measured beside the CUDA-core kernel's (CUDA events and
    device), and its bounds are the 3xTF32 ones.
    Returns the ``(err, ms, plain_ms, extras...)`` of the forward and of the
    backward."""
    x = inputs[0]
    with torch.inference_mode():
        y = kernel(*inputs)
        ref = plain(*inputs)
        torch.cuda.synchronize()
        err_fwd = compare(f"{name} {label} {tuple(x.shape)}", y, ref, TOL_KAN)
        extra_fwd = {}
        if f64_gates or fwd_cuda_cores is not None:
            extra_fwd["f64_err"] = f64_gate(f"{name} {label}", y, ref,
                                            plain(*(a.double() for a in inputs)))
        if fwd_cuda_cores is not None:
            same = torch.equal(y, kernel(*inputs))
            print(f"[kernel] {name} {label}: a second forward repeats the bits: {same}")
            check(same, f"{name} {label}: a second forward gave other bits")
    g = torch.from_numpy(rng.standard_normal(tuple(ref.shape))
                         .astype(np.float32)).cuda()
    _, _, got = grads_of(torch, kernel, inputs, g)
    leaves, out, want = grads_of(torch, plain, inputs, g)
    torch.cuda.synchronize()
    err_bwd = compare_grads(f"{name}_bwd {label}", names, got, want)
    if tc_grads:
        step = dict(zip(names[1:], grads_of(torch, kernel, inputs, g, with_dx=False)[2]))
        compare_grads(f"{name}_bwd {label} no dx", names[1:], list(step.values()), want[1:])
        same = all(torch.equal(step[nm], a) for nm, a in zip(names, got) if nm in step)
        print(f"[kernel] {name}_bwd {label}: the training path's backward (no dx) "
              f"gives the all-gradients route's bits: {same}")
        check(same, f"{name}_bwd {label}: the no-dx route's gradients differ")
    extra_bwd = {}
    if f64 or f64_gates or cuda_cores is not None:
        _, _, want64 = grads_of(torch, lambda *a: plain(*a).double(),
                                [a.double() for a in inputs], g.double())
        for nm, a, b, c in zip(names, got, want, want64):
            scale = max(1.0, float(c.abs().max()))
            print(f"[kernel] {name}_bwd {label} d{nm} against f64: kernel "
                  f"{float((a.double() - c).abs().max()) / scale:.3e}, plain f32 "
                  f"{float((b.double() - c).abs().max()) / scale:.3e} (x max(1, max|g|))")
    if f64:
        compare_grads(f"{name}_bwd {label} against f64", names,
                      [a.double() for a in got], want64)
    if cuda_cores is not None:
        for nm, a, b, c in zip(names, got, want, want64):
            if nm in (names if kernel_grads is None else kernel_grads):
                extra_bwd[f"f64_err_d{nm}"] = f64_gate(f"{name}_bwd {label} d{nm}", a, b, c)
    if f64_gates:
        for nm, b, c in zip(names, want, want64):
            if nm in tc_grads:
                for route, a in (("all gradients", got[names.index(nm)]),
                                 ("no dx", step[nm])):
                    extra_bwd[f"f64_err_d{nm}_{route.replace(' ', '_')}"] = f64_gate(
                        f"{name}_bwd {label} d{nm} ({route})", a, b, c)
    _, _, again = grads_of(torch, kernel, inputs, g)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[kernel] {name}_bwd {label}: a second backward repeats the bits: {same}")
    check(same, f"{name}_bwd {label}: a second backward gave other bits")
    fwd, bwd, bwd_train = launches
    with torch.inference_mode():
        ms = time_ms(torch, fwd)
        plain_ms = time_ms(torch, lambda: plain(*inputs))
    bwd_ms = time_ms(torch, lambda: bwd(g))
    train_ms = time_ms(torch, lambda: bwd_train(g))
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                              retain_graph=True))
    *dims, extra, train_contractions = shape
    tc = bool(tc_grads)
    extra_bwd["no_dx_ms"] = train_ms
    if cuda_cores is not None:
        extra_bwd["device_ms"] = kernel_ms(torch, lambda: bwd(g), 10,
                                           label=f"{name}_bwd {label}, tensor cores")
        extra_bwd["cuda_core_ms"] = time_ms(torch, lambda: cuda_cores(g))
        extra_bwd["cuda_core_device_ms"] = kernel_ms(torch, lambda: cuda_cores(g), 10,
                                                     label=f"{name}_bwd {label}, CUDA cores")
        if tc:
            extra_bwd["cuda_core_no_dx_ms"] = time_ms(torch, lambda: cuda_cores(g, False))
    if fwd_cuda_cores is not None:
        with torch.inference_mode():
            extra_fwd["device_ms"] = kernel_ms(torch, fwd, 10,
                                               label=f"{name} {label}, tensor cores")
            extra_fwd["cuda_core_ms"] = time_ms(torch, fwd_cuda_cores)
            extra_fwd["cuda_core_device_ms"] = kernel_ms(
                torch, fwd_cuda_cores, 10, label=f"{name} {label}, CUDA cores")
    if f64_gates:
        if fwd_cuda_cores is None:
            with torch.inference_mode():
                extra_fwd["device_ms"] = kernel_ms(torch, fwd, 10, label=f"{name} {label}")
        extra_bwd["device_ms"] = kernel_ms(torch, lambda: bwd(g), 10,
                                           label=f"{name}_bwd {label}, all gradients")
        extra_bwd["no_dx_device_ms"] = kernel_ms(torch, lambda: bwd_train(g), 10,
                                                 label=f"{name}_bwd {label}, no dx")
    if tc:
        step_bound = kan_bound(*dims, backward=True, extra_floats=extra, tensor_cores=True,
                               contractions=train_contractions, dx=False)
        extra_bwd.update({"no_dx_bound_ms": step_bound["bound_ms"],
                          "no_dx_f32_bound_ms": step_bound["f32_bound_ms"]})
    print(f"[kernel] {name} {label}: forward kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f" | backward kernels, all gradients {bwd_ms:.4f} ms (no dx, as an "
          f"embedder's training step {train_ms:.4f} ms)  plain autograd "
          f"{plain_bwd_ms:.4f} ms" + "".join(
              f"; {part} {k} {v:.4f}" for part, extras in (("forward", extra_fwd),
                                                           ("backward", extra_bwd))
              for k, v in extras.items() if k.endswith(("device_ms", "cuda_core_ms"))))
    if fwd_cuda_cores is not None:
        fwd_bound = kan_bound(*dims, extra_floats=extra, tensor_cores=True)
        print(f"[kernel] {name} {label}: forward bound 3xTF32 {fwd_bound['bound_ms']:.4f} "
              f"ms, f32 {fwd_bound['f32_bound_ms']:.4f} ms")
    return ((err_fwd, ms, plain_ms, extra_fwd,
             kan_bound(*dims, extra_floats=extra,
                       tensor_cores=tc or fwd_cuda_cores is not None)),
            (err_bwd, bwd_ms, plain_bwd_ms, extra_bwd,
             kan_bound(*dims, backward=True, extra_floats=extra,
                       tensor_cores=tc or cuda_cores is not None)))


def check_basis(torch, rng, name, family, label, kernel, plain, inputs, w, aux,
                names, tc_gates=False):
    """``check_kan`` for the Chebyshev and Fourier wrappers: ``w`` is the
    packed weight and ``aux`` the degree or grid size the kernels take.
    ``tc_gates``: the grouped Chebyshev forward's and backward's tensor-core
    gates and times beside the CUDA-core kernels (``check_kan``'s
    ``fwd_cuda_cores`` and ``cuda_cores``). ``chebykan``'s forward and
    backward are on the tensor cores: at the embedder's 768 features its y,
    dx and dcoeffs are held no further from f64 than twice the plain f32
    version, dcoeffs on the no-dx route too, y's bits repeated, beside the
    CUDA-core kernels' times."""
    from kanvit_torch.kernels import fused_basis as FB

    x, bname = inputs[0], f"{name}_bwd"
    launches = (lambda: FB._launch(name, family, x, w, aux),
                lambda g: FB._launch_bwd(bname, family, x, w, aux, g, True, True),
                lambda g: FB._launch_bwd(bname, family, x, w, aux, g, False, True))

    def cuda_cores(g, with_dx=True):
        return cuda_core_route(FB, lambda: launches[1 if with_dx else 2](g))

    def fwd_cuda_cores():
        return cuda_core_route(FB, launches[0])

    tc = family == "fourier" or name == "chebykan"  # dW on the tensor cores
    embedder = name == "chebykan" and x.shape[1] >= 768
    return check_kan(torch, rng, name, label, kernel, plain, inputs, names, launches,
                     (x.shape[0], *w.shape, 0, 1), tc_grads=("coeffs",) if tc else (),
                     f64_gates=tc and x.shape[1] >= 768,
                     cuda_cores=cuda_cores if tc_gates or embedder else None,
                     fwd_cuda_cores=fwd_cuda_cores if tc_gates or embedder else None,
                     kernel_grads=("x", "coeffs") if embedder else None)


def fast_inputs(rng, shape):
    """Normal inputs (std 1.5) with a share at |x| in [20, 60], where silu's
    sigmoid and the RBF's exp saturate and one entry dominates its row's
    LayerNorm, and the first row constant (the LayerNorm's variance 0)."""
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[idx] = (rng.uniform(20.0, 60.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.5
    return x


def sine_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-20, 20]: arguments of
    x freq + phase over several pi."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-20.0, 20.0, flat[::7].size).astype(np.float32)
    return x


def cuda_core_route(FB, launch):
    """``launch()`` with the grouped q/k/v backwards and forward off the
    tensor cores: the CUDA-core kernels they replace, on the same operands,
    to time beside them."""
    routes = FB.TC_GROUPED_BWD, FB.TC_GROUPED_FWD
    FB.TC_GROUPED_BWD = FB.TC_GROUPED_FWD = ()
    try:
        return launch()
    finally:
        FB.TC_GROUPED_BWD, FB.TC_GROUPED_FWD = routes


def check_rbf(torch, rng, name, label, n, groups, nin, nout, tc_gates=False, base=True):
    """``fastkan`` (groups 1) or ``fastkan_qkv_grouped`` against the plain
    FastKAN forward (per head) and autograd through it: x, the LayerNorm's
    gamma and beta, spline and base weights, base bias; without ``base``
    (the grouped route only) an 8-slice weight through the grouped
    Function and no base weights. ``tc_gates``: the tensor-core gates and
    times beside the CUDA-core kernels (``check_kan``'s ``cuda_cores``), of
    the forward (``fwd_cuda_cores``: the grouped q/k/v's, the embedder's
    with its two-level sum) and the backward; of the embedder's backward,
    dgamma, dbeta and the spline and base weights no further from f64 than
    twice the plain f32 version on the all-gradients and the no-dx routes,
    the no-dx route's bits those of the all-gradients route
    (``tc_grads``)."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    lead = () if groups == 1 else (groups,)
    x = cuda(fast_inputs(rng, (n, groups * nin)))
    params = [cuda(1 + 0.1 * rng.standard_normal((*lead, nin))),
              cuda(0.1 * rng.standard_normal((*lead, nin))),
              cuda(rng.standard_normal((*lead, nout, nin * 8)) / np.sqrt(nin * 8)),
              cuda(rng.standard_normal((*lead, nout, nin)) / np.sqrt(nin)),
              cuda(0.1 * rng.standard_normal((*lead, nout)))][:5 if base else 3]
    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0
    if groups == 1:
        kernel = lambda x, ga, be, *w: FB.fastkan(x, ga, be, grid, den, *w)  # noqa: E731
        plain = lambda x, ga, be, *w: K.fastkan_forward(x, ga, be, grid, den, *w)  # noqa: E731
        w = FB.pack_fastkan_weight(params[2], params[3], 8).unsqueeze(0)
    else:
        def plain(x, ga, be, sw, bw=None, bb=None):
            return torch.cat([K.fastkan_forward(
                x[:, i * nin:(i + 1) * nin], ga[i], be[i], grid, den, sw[i],
                None if bw is None else bw[i], None if bb is None else bb[i])
                for i in range(groups)], dim=1)

        if base:
            kernel = lambda x, ga, be, *w: FB.fastkan_qkv_grouped(  # noqa: E731
                x, ga, be, grid, den, *w)
            w = FB.pack_fastkan_qkv_weight(params[2], params[3], 8)
        else:
            def kernel(x, ga, be, sw):
                return FB._RbfFn.apply(x, sw.reshape(groups, nout, nin, 8).permute(
                    0, 3, 2, 1).contiguous(), ga, be, grid, den, name)
            w = params[2].reshape(groups, nout, nin, 8).permute(0, 3, 2, 1)
    w = w.contiguous()
    ga, be = (p.reshape(groups, nin) for p in params[:2])
    with torch.inference_mode():
        _, stats = FB._launch_rbf(name, x, w, ga, be, grid, den)
    bname = f"{name}_bwd"
    launches = (
        lambda: FB._launch_rbf(name, x, w, ga, be, grid, den),
        lambda g: FB._launch_rbf_bwd(bname, x, w, ga, be, grid, den, stats, g, True, True),
        lambda g: FB._launch_rbf_bwd(bname, x, w, ga, be, grid, den, stats, g, False,
                                     True))

    def cuda_cores(g, with_dx=True):
        return cuda_core_route(FB, lambda: FB._launch_rbf_bwd(
            bname, x, w, ga, be, grid, den, stats, g, with_dx, True))

    def fwd_cuda_cores():
        return cuda_core_route(FB, launches[0])

    names = ("x", "gamma", "beta", "spline_weight", "base_weight", "base_bias")
    embedder = tc_gates and groups == 1
    return check_kan(torch, rng, name, label, kernel, plain, [x, *params],
                     names[:len(params) + 1], launches,
                     (n, groups, w.shape[1], nin, nout, 2 * groups * nin + 8, 2),
                     tc_grads=names[1:5] if embedder else (), f64_gates=embedder,
                     cuda_cores=cuda_cores if tc_gates else None,
                     fwd_cuda_cores=fwd_cuda_cores if tc_gates else None,
                     kernel_grads=() if embedder else names[:5])


def embedder_fwd_gates(torch, tag, x, kernel, plain, exact, bounds):
    """An embedder's tensor-core forward ``kernel(rows)`` (its sum in two
    levels) on ``x``: against ``plain()``, no further from f64 (``exact``)
    than twice the plain f32 version, the bits of a second forward and,
    past one image, the first image's 196 rows' bits alone (its levels then
    in blocks of their own); CUDA-event and device times beside the
    CUDA-core kernel it replaced (``cuda_core_route``, whose distance from
    f64 is printed too) and the plain version, and ``bounds`` (3xTF32 and
    f32). Returns ``check_kan``'s ``(err, ms, plain_ms, extras, bounds)``."""
    from kanvit_torch.kernels import fused_basis as FB

    n = x.shape[0]
    with torch.inference_mode():
        y = kernel(x)
        again = kernel(x)
        ref = plain()
        torch.cuda.synchronize()
        err = compare(tag, y, ref, TOL_KAN)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        if n > 196:
            same = torch.equal(kernel(x[:196]), y[:196])
            print(f"[kernel] {tag}: the first image's rows alone (levels in blocks of their "
                  f"own) give the batch's bits: {same}")
            check(same, f"{tag}: an image's rows gave other bits alone than in the batch")
        f64 = f64_gate(tag, y, ref, exact)
        scale = max(1.0, float(exact.abs().max()))
        core_f64 = float((cuda_core_route(FB, lambda: kernel(x)).double() - exact).abs().max()
                         ) / scale
        ms = time_ms(torch, lambda: kernel(x))
        dev_ms = kernel_ms(torch, lambda: kernel(x), 10, label=tag)
        core_ms = cuda_core_route(FB, lambda: time_ms(torch, lambda: kernel(x)))
        core_dev_ms = cuda_core_route(FB, lambda: kernel_ms(
            torch, lambda: kernel(x), 10, label=f"{tag}, CUDA cores"))
        plain_ms = time_ms(torch, plain)
    print(f"[kernel] {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f}; the CUDA-core kernel "
          f"{core_ms:.4f}, device {core_dev_ms:.4f}, {core_f64:.3e} from f64)  plain "
          f"{plain_ms:.4f} ms  bound 3xTF32 {bounds['bound_ms']:.4f}, f32 "
          f"{bounds['f32_bound_ms']:.4f}  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "cuda_core_ms": core_ms,
                               "cuda_core_device_ms": core_dev_ms,
                               "cuda_core_f64_err": core_f64}, bounds


def check_fastkan_fwd(torch, rng, n, nin, nout, label, large=False):
    """``fastkan``'s forward (``embedder_fwd_gates``) at an embedder's
    shape, with ``large`` a third of x at |x| 20-60, where silu(x)
    dominates the base slice."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    x = fast_inputs(rng, (n, nin))
    if large:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 3, replace=False)
        flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)
    x = cuda(x)
    params = [cuda(1 + 0.1 * rng.standard_normal((1, nin))),
              cuda(0.1 * rng.standard_normal((1, nin))),
              cuda(rng.standard_normal((nout, nin * 8)) / np.sqrt(nin * 8)),
              cuda(rng.standard_normal((nout, nin)) / np.sqrt(nin)), cuda(np.zeros(nout))]
    ga, be, sw, bw, _ = params
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()
    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0

    def plain(x, ga, be, *rest):
        return K.fastkan_forward(x, ga[0], be[0], grid.to(x.dtype), den, *rest)

    with torch.inference_mode():
        exact = plain(*(a.double() for a in (x, *params)))
    return embedder_fwd_gates(
        torch, f"fastkan {label} N={n} {nin}->{nout}", x,
        lambda rows: FB._launch_rbf("fastkan", rows, w, ga, be, grid, den)[0],
        lambda: plain(x, *params), exact,
        kan_bound(n, 1, 9, nin, nout, extra_floats=2 * nin + 8, tensor_cores=True))


def check_chebykan_fwd(torch, rng, n, nin, nout, label, saturated):
    """``chebykan``'s forward (``embedder_fwd_gates``) at an embedder's
    shape, ``saturated`` a share of x where tanh rounds to +-1."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x = torch.from_numpy(cheby_inputs(rng, (n, nin), saturated)).cuda()
    cc = torch.from_numpy((rng.standard_normal((nin, nout, 5)) / np.sqrt(nin * 5))
                          .astype(np.float32)).cuda()
    w = FB.pack_cheby_weight(cc).contiguous()
    with torch.inference_mode():
        exact = K.chebykan_forward(x.double(), cc.double())
    return embedder_fwd_gates(
        torch, f"chebykan {label} N={n} {nin}->{nout}", x,
        lambda rows: FB._launch("chebykan", "cheby", rows, w, 4),
        lambda: K.chebykan_forward(x, cc), exact,
        kan_bound(n, 1, 5, nin, nout, tensor_cores=True))


def check_sine(torch, rng, name, label, n, groups, nin, nout, grid_size, tc_gates=False):
    """``sinekan`` (groups 1) or ``sinekan_qkv_grouped`` against the plain
    SineKAN forward (per head) and autograd through it: x, freq, amplitudes,
    bias. At the embedder dfreq sums N * nin = 9.6M terms a slice: the
    gradients are held against f64 too. ``tc_gates``: as ``check_rbf``'s
    (the grouped forward on the tensor cores up to grid 4; the backward's
    f64 gates on x, freq and the amplitudes, the bias's gradient printed)."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    lead = () if groups == 1 else (groups,)
    x = cuda(sine_inputs(rng, (n, groups * nin)))
    k = np.arange(1, grid_size + 1)
    params = [cuda(k / (grid_size + 1) + 0.05 * rng.standard_normal((*lead, grid_size))),
              cuda(rng.uniform(-1.0, 1.0, (*lead, nout, nin, grid_size)) / nout / k),
              cuda(np.full((*lead, nout), 1.0 / nout))]
    phase = K.sinekan_phase_init(nin, grid_size).cuda()
    if groups == 1:
        kernel = lambda x, f, a, b: FB.sinekan(x, f, phase, a, b)  # noqa: E731
        plain = lambda x, f, a, b: K.sinekan_forward(  # noqa: E731
            x, f, phase.to(x.dtype), a, b)
        w = FB.pack_sine_weight(params[1])
    else:
        kernel = lambda x, f, a, b: FB.sinekan_qkv_grouped(x, f, phase, a, b)  # noqa: E731

        def plain(x, f, a, b):
            return torch.cat([K.sinekan_forward(x[:, i * nin:(i + 1) * nin], f[i],
                                                phase.to(x.dtype), a[i], b[i])
                              for i in range(groups)], dim=1)
        w = FB.pack_sine_qkv_weight(params[1])
    w, freq2d = w.contiguous(), params[0].reshape(groups, grid_size)
    bname = f"{name}_bwd"
    launches = (
        lambda: FB._launch_sine(name, x, w, freq2d, phase),
        lambda g: FB._launch_sine_bwd(bname, x, w, freq2d, phase, g, True, True),
        lambda g: FB._launch_sine_bwd(bname, x, w, freq2d, phase, g, False, True))

    def cuda_cores(g):
        return cuda_core_route(FB, lambda: FB._launch_sine_bwd(
            bname, x, w, freq2d, phase, g, True, True))

    def fwd_cuda_cores():
        return cuda_core_route(FB, launches[0])

    return check_kan(torch, rng, name, label, kernel, plain, [x, *params],
                     ("x", "freq", "amplitudes", "bias"), launches,
                     (n, groups, grid_size, nin, nout, (groups + nin) * grid_size, 2),
                     f64=groups == 1 and nin >= 768,
                     tc_grads=("freq", "amplitudes") if groups == 1 else (),
                     f64_gates=groups == 1 and nin >= 768,
                     cuda_cores=cuda_cores if tc_gates else None,
                     fwd_cuda_cores=fwd_cuda_cores if tc_gates else None,
                     kernel_grads=("x", "freq", "amplitudes"))


def check_cheby_qkv(torch, rng, n, h, dh, label):
    """``cheby_qkv_grouped`` (``check_basis``) over x with a share where
    tanh(x) rounds to +-1, coefficients of unit output scale; at the vit-s
    rows with the tensor-core forward's and backward's gates beside the
    CUDA-core kernels."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x = torch.from_numpy(cheby_inputs(rng, (n, h * dh), 0.02)).cuda()
    cc = torch.from_numpy((rng.standard_normal((h, dh, 3 * dh, 5)) / np.sqrt(dh * 5))
                          .astype(np.float32)).cuda()

    def plain(x, cc):
        return torch.cat([K.chebykan_forward(x[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)

    return check_basis(torch, rng, "cheby_qkv_grouped", "cheby", label,
                       FB.cheby_qkv_grouped, plain, [x, cc],
                       FB.pack_cheby_qkv_weight(cc).contiguous(), 4, ("x", "cc"),
                       tc_gates=n > 10000)


def phase_basis_kernels(torch):
    """``chebykan`` and ``fourierkan`` at the vit-s embedder (batch 64: 12,544
    patches, 768 -> 384; Fourier grid 28), ``cheby_qkv_grouped`` at the
    vit-s q/k/v (12,608 tokens, 6 heads, 64 -> 192 each), and ragged narrow
    shapes of each. Coefficients of unit output scale."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    rng = np.random.default_rng(SEED + 6)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    results = {}

    def keep(name, fwd_bwd):
        results.setdefault(name, fwd_bwd[0])
        results.setdefault(f"{name}_bwd", fwd_bwd[1])

    for n, nin, nout, label in ((BATCH * 196, 768, 384, "vit-s embedder"),
                                (1000, 16, 24, "ragged")):
        x = cuda(cheby_inputs(rng, (n, nin), 0.1))
        cc = cuda(rng.standard_normal((nin, nout, 5)) / np.sqrt(nin * 5))
        keep("chebykan", check_basis(
            torch, rng, "chebykan", "cheby", label, FB.chebykan,
            K.chebykan_forward, [x, cc], FB.pack_cheby_weight(cc).contiguous(), 4,
            ("x", "coeffs")))
    # the embedder's forward without saturated x and the batch's bits, at one
    # vit-s image (its levels in blocks of their own) and the MNIST shape
    results["chebykan"] += tuple(
        {key: sub_entry(check_chebykan_fwd(torch, rng, n, nin, nout, label, saturated))}
        for key, n, nin, nout, label, saturated in (
            ("unsaturated", BATCH * 196, 768, 384, "vit-s embedder, no saturated x", 0.0),
            ("batch_1", 196, 768, 384, "vit-s embedder, one image", 0.1),
            ("mnist", 37 * 49, 16, 64, "mnist embedder", 0.1)))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50, 2, 32, "ragged")):
        keep("cheby_qkv_grouped", check_cheby_qkv(torch, rng, n, h, dh, label))
    for n, nin, nout, gs, label in ((BATCH * 196, 768, 384, 28, "vit-s embedder G28"),
                                    (1000, 16, 24, 5, "ragged G5"),
                                    (999, 20, 70, 7, "ragged G7")):
        x = cuda(fourier_inputs(rng, (n, nin)))
        co = cuda(rng.standard_normal((2, nout, nin, gs)) / np.sqrt(nin * gs))
        bias = cuda(rng.standard_normal((1, nout)) * 0.1)
        keep("fourierkan", check_basis(
            torch, rng, "fourierkan", "fourier", label, FB.fourierkan,
            K.fourierkan_forward, [x, co, bias], FB.pack_fourier_weight(co).contiguous(),
            gs, ("x", "coeffs", "bias")))
    return results


def phase_rbf_sine_kernels(torch):
    """``fastkan`` and ``sinekan`` (grid 28) at the vit-s embedder (12,544
    patches, 768 -> 384), ``fastkan_qkv_grouped`` and ``sinekan_qkv_grouped``
    (grid 4) at one vit-s q/k/v projection (12,608 tokens, 6 heads of 64 ->
    64), there also FastKAN without its base branch and sine at grid 3 (the
    tensor-core tiles' slices left empty, sub-entries of their kernels),
    and ragged narrow shapes of each (nin 16, d_head 32, odd N); the
    FastKAN embedder's forward also with large raw inputs, at one vit-s
    image and at the MNIST shape (``check_fastkan_fwd``, sub-entries)."""
    rng = np.random.default_rng(SEED + 9)
    results = {}

    def keep(name, fwd_bwd):
        results.setdefault(name, fwd_bwd[0])
        results.setdefault(f"{name}_bwd", fwd_bwd[1])

    for n, nin, nout, label in ((BATCH * 196, 768, 384, "vit-s embedder"),
                                (37 * 49, 16, 64, "ragged")):
        keep("fastkan", check_rbf(torch, rng, "fastkan", label, n, 1, nin, nout,
                                  tc_gates=n > 10000))
    # the embedder's forward with large raw inputs and the batch's bits, at
    # one vit-s image (its levels in blocks of their own) and the MNIST shape
    results["fastkan"] += tuple(
        {key: sub_entry(check_fastkan_fwd(torch, rng, n, nin, nout, label, large))}
        for key, n, nin, nout, label, large in (
            ("large_silu", BATCH * 196, 768, 384, "vit-s embedder, a third of x at |x| "
             "20-60", True),
            ("batch_1", 196, 768, 384, "vit-s embedder, one image", False),
            ("mnist", 37 * 49, 16, 64, "mnist embedder", False)))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50 - 1, 2, 32, "ragged")):
        keep("fastkan_qkv_grouped", check_rbf(torch, rng, "fastkan_qkv_grouped",
                                              label, n, h, dh, dh, tc_gates=n > 10000))
    fwd, bwd = check_rbf(torch, rng, "fastkan_qkv_grouped", "vit-s q/k/v, no base branch",
                         BATCH * 197, 6, 64, 64, tc_gates=True, base=False)
    results["fastkan_qkv_grouped"] += ({"no_base_branch": sub_entry(fwd)},)
    results["fastkan_qkv_grouped_bwd"] += ({"no_base_branch": sub_entry(bwd)},)
    for n, nin, nout, gs, label in ((BATCH * 196, 768, 384, 28, "vit-s embedder G28"),
                                    (37 * 49, 16, 64, 28, "ragged G28"),
                                    (999, 20, 70, 7, "ragged G7")):
        keep("sinekan", check_sine(torch, rng, "sinekan", label, n, 1, nin, nout, gs))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50 - 1, 2, 32, "ragged")):
        keep("sinekan_qkv_grouped", check_sine(torch, rng, "sinekan_qkv_grouped",
                                               label, n, h, dh, dh, 4, tc_gates=n > 10000))
    fwd, bwd = check_sine(torch, rng, "sinekan_qkv_grouped", "vit-s q/k/v G3",
                          BATCH * 197, 6, 64, 64, 3, tc_gates=True)
    results["sinekan_qkv_grouped"] += ({"grid_3": sub_entry(fwd)},)
    results["sinekan_qkv_grouped_bwd"] += ({"grid_3": sub_entry(bwd)},)
    return results


# --------------------------------------------------------------------------
# Phase 8: the fused FF and the int8 linear kernels
# --------------------------------------------------------------------------

FFN_GRADS = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")


def ffn_bound(n, d, f, backward, library_ms):
    """The FF over x (n, d): 2 n d f FLOPs a product, two forward, five
    backward (h, g W2, dln, dW2, dW1); bytes of x, y, the weights and
    vectors (backward: x, g, dx, W1, W2, dW1, dW2 and the vectors). The
    kernels' route is 3xTF32 on the tensor cores: ``bound_ms`` counts three
    TF32 products for each f32 one at the dense TF32 peak, and
    ``f32_bound_ms`` keeps the CUDA-core f32 bound beside it, as
    ``attention_bound`` does."""
    flops = (10.0 if backward else 4.0) * n * d * f
    floats = (3 * n * d + 4 * d * f + 2 * f + 6 * d if backward
              else 2 * n * d + 2 * d * f + f + 3 * d)
    f32 = bound(flops, 4.0 * floats, library_ms)
    tc = bound(TF32_PASSES * flops, 4.0 * floats, library_ms, peak=PEAK_TF32_FLOPS)
    return {**tc, "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"]}


def ffn_library(x, gamma, beta, w1, b1, w2, b2):
    """The same function in PyTorch's calls: F.layer_norm, F.linear
    (cuBLAS f32), relu, F.linear, add; the yardstick, never used by the
    port."""
    import torch.nn.functional as F

    h = F.relu(F.linear(F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5), w1, b1))
    return x + F.linear(h, w2, b2)


def mma_sync_rate(torch, smi):
    """TFLOP/s of ``mma.sync.m16n8k8`` TF32 on this card: 8 blocks of 8
    warps an SM, each warp 8 independent accumulators, operands in
    registers (``csrc/mma_rate_probe.cu``); CUDA events."""
    from kanvit_torch.kernels import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 256
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(_build.load().kanvit_tf32_mma_rate(out.data_ptr(), blocks, iters,
                                                 stream) == 0, "mma rate probe launch")

    ms = time_ms(torch, run, iters=5, warmup=2)
    tflops = blocks * 8 * iters * 8 * 2048 / (ms * 1e-3) / 1e12
    print(f"[kernel] mma.sync.m16n8k8 TF32 issue rate on this card: {tflops:.1f} TFLOP/s "
          f"({tflops / (PEAK_TF32_FLOPS / 1e12):.1%} of the {PEAK_TF32_FLOPS / 1e12:.0f} "
          f"dense TF32 peak; {ms:.4f} ms for {blocks} blocks)  [{smi}]")
    return tflops


def check_flips(tag, flips, total, worst, limit, share=FLIP_SHARE):
    """Gate the ReLU inputs on the other side of 0 (see FLIP_SHARE)."""
    most = max(FLIP_FLOOR, int(share * total))
    print(f"{tag}: {flips} of {total} ReLU inputs on the other side of 0 (at most "
          f"{most}); the largest such |h| {worst:.3e} (limit {limit:.3e})")
    check(flips <= most and worst <= limit,
          f"{tag}: ReLU inputs on the other side of 0 beyond rounding")


def ffn_f64_err(torch, args):
    """The FF kernel's forward against the plain version in f64 on the card,
    as a share of max(1, max|y|)."""
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.ops import kan_bases as K

    with torch.inference_mode():
        y = FFN.ffn_pre_ln(*args)
        exact = K.ffn_pre_ln(*(a.double() for a in args))
    return float((y.double() - exact).abs().max()) / max(1.0, float(exact.abs().max()))


def check_ffn(torch, rng, n, d, f, label, f64=False):
    """``ffn_pre_ln`` forward against the plain version (with ``f64``, also
    against f64 on the card within TOL_FFN_F64), and backward against
    autograd through the plain version on the kernel's own ReLU pattern
    (f32 rounding puts a few of the N x F pre-activations that lie within it
    of 0 on the other side in cuBLAS's h, and each such flip moves its row's
    dx by ~0.1): the pattern is first held to the plain version's up to
    rounding (``check_flips``); the backward's bits repeated; times of the
    kernels (events and device), the plain version and the library calls."""
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.ops import kan_bases as K

    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.1, d ** -0.5, 0.1, f ** -0.5, 0.1)
    args = [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).cuda()
            for s, sc in zip(shapes, scales)]
    args[1] += 1.0
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    tag = f"{label} N={n} D={d} F={f}"
    with torch.inference_mode():
        y = FFN.ffn_pre_ln(*args)
        ref = K.ffn_pre_ln(*args)
        torch.cuda.synchronize()
        err = compare(f"ffn_pre_ln {tag}", y, ref, TOL_FFN)
    extra = {}
    if f64:
        err64 = ffn_f64_err(torch, args)
        print(f"[kernel] ffn_pre_ln {tag}: against f64 on the card {err64:.3e} of "
              f"max(1, max|y|)  limit {TOL_FFN_F64:.0e}")
        check(err64 <= TOL_FFN_F64, f"ffn_pre_ln {tag}: {err64:.3e} from f64, over "
                                    f"{TOL_FFN_F64:.0e}")
        extra["f64_rel_err"] = err64
    mask = torch.empty(n, f, dtype=torch.uint8, device=args[0].device)
    with torch.inference_mode():
        FFN._launch(*args, relu_mask=mask)
    pattern = mask.bool()
    with torch.no_grad():
        ln = K.layernorm(args[0], args[1], args[2])
        h = ln @ args[3].T + args[4]
        flipped = pattern != (h > 0)
        flips = int(flipped.sum())
        terms = ln.abs() @ args[3].abs().T + args[4].abs()
        worst = float((h.abs() / terms)[flipped].max()) if flips else 0.0
        del ln, h, terms
    # The limit counts the worst rounding of a depth-D f32 sum on each side,
    # D 2^-24 of sum|terms| each. The kernel's 3xTF32 h adds its own error:
    # small*small dropped (<= 2^-22 of each |term|) and each 8-term step
    # summed inside the tensor core, ~3 2^-22 of sum|terms| in all, 12 2^-24
    # against the 2 D 2^-24 allowed: 6% of it at D 100, 1.6% at D 384.
    check_flips(f"[kernel] ffn_pre_ln {tag}", flips, n * f, worst, 2 * d * 2.0 ** -24)

    def plain_on_pattern(x, gamma, beta, w1, b1, w2, b2):
        h = K.layernorm(x, gamma, beta) @ w1.T + b1
        return x + ((h * pattern) @ w2.T + b2)

    _, _, got = grads_of(torch, FFN.ffn_pre_ln, args, g)
    leaves, out, want = grads_of(torch, plain_on_pattern, args, g)
    _, _, again = grads_of(torch, FFN.ffn_pre_ln, args, g)
    torch.cuda.synchronize()
    err_bwd = max(compare(f"ffn_pre_ln_bwd {tag} d{nm}", a, b, TOL_FFN)
                  for nm, a, b in zip(FFN_GRADS, got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ffn_pre_ln_bwd {tag}: a second backward gave other bits")
    with torch.inference_mode():
        ms = time_ms(torch, lambda: FFN._launch(*args))
        plain_ms = time_ms(torch, lambda: K.ffn_pre_ln(*args))
        lib_ms = time_ms(torch, lambda: ffn_library(*args))
        dev_ms = kernel_ms(torch, lambda: FFN._launch(*args),
                           label=f"ffn_pre_ln {tag}")
        lib_dev_ms = kernel_ms(torch, lambda: ffn_library(*args))
    bwd_ms = time_ms(torch, lambda: FFN._launch_bwd(*args[:6], g))
    bwd_dev_ms = kernel_ms(torch, lambda: FFN._launch_bwd(*args[:6], g),
                           label=f"ffn_pre_ln_bwd {tag}")
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                              retain_graph=True))
    lib_leaves, lib_out, _ = grads_of(torch, ffn_library, args, g)

    def lib_grad():
        return torch.autograd.grad(lib_out, lib_leaves, g, retain_graph=True)

    lib_bwd_ms = time_ms(torch, lib_grad)
    lib_bwd_dev_ms = kernel_ms(torch, lib_grad)
    # the backward's device-memory scratch, written once and read again: LN
    # (n, d), r and dh (n, f), each at a pitch rounded up to 4 floats
    scratch = 4.0 * n * (-(-d // 4) * 4 + 2 * -(-f // 4) * 4)
    print(f"[kernel] ffn_pre_ln {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f})  "
          f"plain {plain_ms:.4f} ms  library (F.layer_norm, F.linear) {lib_ms:.4f} ms "
          f"(device {lib_dev_ms:.4f}); backward: kernels {bwd_ms:.4f} ms (device "
          f"{bwd_dev_ms:.4f})  plain autograd {plain_bwd_ms:.4f} ms  library autograd "
          f"{lib_bwd_ms:.4f} ms (device {lib_bwd_dev_ms:.4f}); backward scratch "
          f"{scratch / 1e6:.1f} MB, {2 * scratch / PEAK_BYTES * 1e3:.4f} ms to write "
          f"and read once at {PEAK_BYTES / 1e12:.2f} TB/s")
    return ((err, ms, plain_ms, ffn_bound(n, d, f, False, lib_ms),
             {**extra, "device_ms": dev_ms, "library_device_ms": lib_dev_ms}),
            (err_bwd, bwd_ms, plain_bwd_ms, ffn_bound(n, d, f, True, lib_bwd_ms),
             {"device_ms": bwd_dev_ms, "library_device_ms": lib_bwd_dev_ms,
              "scratch_bytes": scratch}))


def int8_bound(n, k, out, library_ms):
    """W8A8 (n, k) x (out, k): 2 n k out int8 operations at the dense int8
    rate; bytes of x and y in f32, W in int8 and its scales and bias."""
    return bound(2.0 * n * k * out, 4.0 * n * k + k * out + 4.0 * n * out + 8.0 * out,
                 library_ms, peak=PEAK_INT8_OPS)


def check_int8(torch, rng, n, k, out, label, pad=0):
    """``int8_linear`` against ``qdot_rowwise`` on the card: within kanvit's
    tie-aware bound (``tests/test_quant.py:44-48``), and no element
    differing at all (the same q(x) and q(W), an exact int32 sum, the same
    rounded epilogue); ``pad``: x a window of rows ``pad`` floats wider.
    Times of the kernel (weight quantized beforehand, as the kernel takes
    it), the plain version, the library route (per-row quantize,
    ``torch._int_mm``, dequantize), ``torch._int_mm`` alone and f32
    ``F.linear``, beside the bound and the kernel's share of it."""
    import torch.nn.functional as F

    from kanvit_torch.kernels import int8_matmul as IM
    from kanvit_torch.ops import quant as Q

    x = torch.from_numpy(rng.standard_normal((n, k + pad)).astype(np.float32)).cuda()[:, :k]
    w = torch.from_numpy((rng.standard_normal((out, k)) * 0.05).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(out).astype(np.float32)).cuda()
    tag = f"{label} N={n} K={k} out={out}" + (f" (x rows of {k + pad})" if pad else "")
    with torch.inference_mode():
        y = IM.int8_linear(x, w, b)
        ref = Q.qdot_rowwise(x, w, b)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        differ = int((y != ref).sum())
        limit = 3.0 * float(x.abs().amax(-1).max()) * float(w.abs().amax(-1).max()) / 127.0
        ok = (bool(y.isfinite().all()) and y.dtype == torch.float32 and err <= limit
              and differ == 0)
        print(f"[kernel] int8_linear {tag}: max|err| {err:.3e}  tie-aware limit "
              f"{limit:.3e}  {differ} of {y.numel()} elements differ at all (gate: 0)  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"int8_linear {tag}: kernel disagrees with qdot_rowwise ({differ} "
                  "elements differ)")
        wq, sw = Q._quantize(w, dim=-1)
        swr = sw.reshape(-1).contiguous()

        def library():
            xq, sx = Q._quantize(x, dim=-1)
            return torch._int_mm(xq, wq.t()).float() * sx * sw.reshape(1, -1) + b

        ms = time_ms(torch, lambda: IM._launch(x, wq, swr, b))
        plain_ms = time_ms(torch, lambda: Q.qdot_rowwise(x, w, b))
        lib_ms = time_ms(torch, library)
        xq = Q._quantize(x, dim=-1)[0]
        int_mm_ms = time_ms(torch, lambda: torch._int_mm(xq, wq.t()))
        f32_ms = time_ms(torch, lambda: F.linear(x, w, b))
    bounds = int8_bound(n, k, out, lib_ms)
    print(f"[kernel] int8_linear {tag}: kernel {ms:.4f} ms ({IM.rows_per_block(k)} rows a "
          f"block)  bound {bounds['bound_ms']:.4f} ms by {bounds['bound_by']} (share "
          f"{bounds['bound_ms'] / ms:.3f})  plain {plain_ms:.4f} ms  library (quantize, "
          f"torch._int_mm, dequantize) {lib_ms:.4f} ms  torch._int_mm alone "
          f"{int_mm_ms:.4f} ms  f32 F.linear {f32_ms:.4f} ms")
    return (err, ms, plain_ms, {"elements_differing": differ, "int_mm_ms": int_mm_ms,
                                "f32_linear_ms": f32_ms,
                                "rows_per_block": IM.rows_per_block(k)}, bounds)


def int8_bound_bf16(n, k, out, library_ms):
    """``int8_bound`` with x and y in bf16 bytes."""
    return bound(2.0 * n * k * out, 2.0 * n * k + k * out + 2.0 * n * out + 8.0 * out,
                 library_ms, peak=PEAK_INT8_OPS)


def check_int8_bf16(torch, rng, n, k, out, label, pad=0):
    """``int8_linear`` on bf16 x, W and bias against its bf16 twin
    (``qdot_rowwise`` rounded once to bf16) on the card: no element
    differing at all, and its bits repeated on a second call; ``pad``: x a
    window of rows ``pad`` values wider. Times (CUDA events; the device's
    own by ``torch.profiler``) of the kernel (weight quantized beforehand,
    as the kernel takes it), the f32 kernel on the same operands widened,
    the twin, the library route (per-row quantize, ``torch._int_mm``,
    dequantize, + b, one rounding to bf16) and ``torch._int_mm`` alone,
    beside the bound (x and y in bf16 bytes) and the kernel's share."""
    from kanvit_torch.kernels import int8_matmul as IM
    from kanvit_torch.ops import quant as Q

    bf16 = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((n, k + pad)).astype(np.float32)).cuda()
    x = x.to(bf16)[:, :k]
    w = torch.from_numpy((rng.standard_normal((out, k)) * 0.05).astype(np.float32)).cuda()
    w = w.to(bf16)
    b = torch.from_numpy(rng.standard_normal(out).astype(np.float32)).cuda().to(bf16)
    tag = f"{label} N={n} K={k} out={out}" + (f" (x rows of {k + pad})" if pad else "")
    with torch.inference_mode():
        y = IM.int8_linear(x, w, b)
        again = IM.int8_linear(x, w, b)
        ref = Q.qdot_rowwise(x, w, b).to(bf16)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        differ = int((y != ref).sum())
        repeated = bool(torch.equal(y, again))
        ok = (y.dtype == bf16 and bool(y.isfinite().all()) and differ == 0 and repeated)
        print(f"[kernel] int8_linear bf16 {tag}: {differ} of {y.numel()} elements differ "
              f"from the bf16 twin at all (gate: 0; max|err| {err:.3e}); bits repeated "
              f"{repeated}  {'ok' if ok else 'FAIL'}")
        check(ok, f"int8_linear bf16 {tag}: kernel disagrees with its bf16 twin ({differ} "
                  f"elements differ; bits repeated {repeated})")
        wq, sw = Q._quantize(w, dim=-1)
        swr, b32, x32 = sw.reshape(-1).contiguous(), b.float(), x.float()

        def library():
            xq, sx = Q._quantize(x, dim=-1)
            return (torch._int_mm(xq, wq.t()).float() * sx * sw.reshape(1, -1)
                    + b32).to(bf16)

        def kernel():
            return IM._launch(x, wq, swr, b32)

        ms = time_ms(torch, kernel)
        dev_ms = kernel_ms(torch, kernel)
        f32_ms = time_ms(torch, lambda: IM._launch(x32, wq, swr, b32))
        plain_ms = time_ms(torch, lambda: Q.qdot_rowwise(x, w, b).to(bf16))
        lib_ms = time_ms(torch, library)
        xq = Q._quantize(x, dim=-1)[0]
        int_mm_ms = time_ms(torch, lambda: torch._int_mm(xq, wq.t()))
    bounds = int8_bound_bf16(n, k, out, lib_ms)
    print(f"[kernel] int8_linear bf16 {tag}: kernel {ms:.4f} ms, device {dev_ms:.4f} "
          f"({IM.rows_per_block(k)} rows a block)  bound {bounds['bound_ms']:.4f} ms by "
          f"{bounds['bound_by']} (share {bounds['bound_ms'] / dev_ms:.3f})  the f32 kernel "
          f"on the same operands {f32_ms:.4f} ms  plain {plain_ms:.4f} ms  library "
          f"(quantize, torch._int_mm, dequantize) {lib_ms:.4f} ms  torch._int_mm alone "
          f"{int_mm_ms:.4f} ms")
    return (err, ms, plain_ms, {"elements_differing": differ, "bits_repeated": repeated,
                                "device_ms": dev_ms, "f32_ms": f32_ms,
                                "int_mm_ms": int_mm_ms,
                                "rows_per_block": IM.rows_per_block(k)}, bounds)


def phase_ffn_int8_kernels(torch, smi):
    from kanvit_torch.kernels import int8_matmul as IM

    rng = np.random.default_rng(SEED + 9)
    results = {}
    n = BATCH * 197
    results["ffn_pre_ln"], results["ffn_pre_ln_bwd"] = check_ffn(
        torch, rng, n, 384, 1536, "vit-s", f64=True)
    # past D 512, the tiled route: vit-b's and vit-l's widths at vit-s's rows,
    # and a D past every preset
    for key, d, f, rows in (("vit_b_widths", 768, 3072, n), ("vit_l_widths", 1024, 4096, n),
                            ("d_2048", 2048, 256, 1000)):
        fwd, bwd = check_ffn(torch, rng, rows, d, f, key.replace("_", "-"), f64=True)
        results["ffn_pre_ln"] += ({key: sub_entry(fwd)},)
        results["ffn_pre_ln_bwd"] += ({key: sub_entry(bwd)},)
    # the FF kernels beside what their instruction, mma.sync, reaches here
    rate = mma_sync_rate(torch, smi)
    for name, products in (("ffn_pre_ln", 4.0), ("ffn_pre_ln_bwd", 10.0)):
        results[name] += ({"mma_sync_tf32_tflops": rate, "mma_sync_bound_ms":
                           TF32_PASSES * products * n * 384 * 1536 / (rate * 1e12) * 1e3},)
    # ragged: odd N, D not a multiple of 32
    check_ffn(torch, rng, 37 * 50 + 1, 100, 400, "ragged")
    # vit-s FF1, FF2 and the embedder; vit-b's FF2 and the deepest K (the
    # kernel's rows a block: 48 but 16 at the deepest)
    results["int8_linear"] = check_int8(torch, rng, n, 384, 1536, "vit-s FF1")
    results["int8_linear"] += tuple(
        {key: sub_entry(check_int8(torch, rng, rows, k, out, label))}
        for key, rows, k, out, label in (
            ("vit_s_ff2", n, 1536, 384, "vit-s FF2"),
            ("vit_s_embedder", BATCH * 196, 768, 384, "vit-s embedder"),
            ("vit_b_ff2", n, 3072, 768, "vit-b FF2"),
            ("deepest_k", 33, IM.MAX_K, 256, "deepest K")))
    check_int8(torch, rng, 37 * 50 + 1, 256, 128, "ragged")
    check_int8(torch, rng, 333, 768, 384, "strided", pad=3)
    # tools/tpu_probe_mosaic_int8_rate.py's shape, (n, 768) x (768, 3072) at
    # batch 64: the kernel against torch._int_mm of pre-quantized operands
    probe = check_int8(torch, rng, n, 768, 3072, "TPU probe shape")
    results["int8_linear"][3]["at_probe_shape_768x3072"] = {
        "ms": probe[1], "int_mm_ms": probe[3]["int_mm_ms"],
        "library_ms": probe[4]["library_ms"], "bound_ms": probe[4]["bound_ms"]}
    results.update(timed("  bf16 int8_linear checks", int8_bf16_kernels, torch, rng))
    return results


def int8_bf16_kernels(torch, rng):
    """``int8_linear`` on bf16 x (``check_int8_bf16``): vit-b's FF1 (the
    entry), FF2 and embedder, vit-s FF1, ragged rows, and x strided by 3
    values (the scalar loads) and by 4 (the 8-byte ones)."""
    n = BATCH * 197
    entry = check_int8_bf16(torch, rng, n, 768, 3072, "vit-b FF1")
    entry += tuple(
        {key: sub_entry(check_int8_bf16(torch, rng, rows, k, out, label, pad))}
        for key, rows, k, out, label, pad in (
            ("vit_b_ff2", n, 3072, 768, "vit-b FF2", 0),
            ("vit_b_embedder", BATCH * 196, 768, 768, "vit-b embedder", 0),
            ("vit_s_ff1", n, 384, 1536, "vit-s FF1", 0),
            ("ragged", 37 * 50 + 1, 256, 128, "ragged", 0),
            ("strided_3", 333, 768, 384, "strided", 3),
            ("strided_4", 333, 768, 384, "strided", 4)))
    return {"int8_linear_bf16": entry}


# --------------------------------------------------------------------------
# Phase 8b: the bf16 fused FF
# --------------------------------------------------------------------------

# The bf16 fused FF's ReLU pattern against its twin's: the kernel's LN
# rounds to another bf16 where its f32 statistics (sums in another order)
# sit next to a rounding boundary, one LN value in ~2^15, and each such
# value moves F pre-activations by up to 2^-8 of their terms, flipping those
# within that of 0: at most FLIP_SHARE_BF16 of them, each within 2^-8 of its
# sum of |terms| plus the f32 sums' 2 D 2^-24. The backward is then held on
# the kernel's own pattern.
FLIP_SHARE_BF16 = 2.0 ** -14
# The bf16 FF's parameter gradients sum over all N rows in f32: the
# kernels in row splits and 48- and 64-row blocks, the twin in kanvit's
# 512-row blocks; each order within N 2^-24 of the sum of |terms|, 2 N 2^-24
# between the two (``K.ffn_spread_bf16(...)``).
FFN_BF16_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def ffn_bf16_case(torch, rng, n, d, f):
    """``check_ffn``'s operands at (n, d, f), rounded to bf16 on the card:
    ``(x, gamma, beta, w1, b1, w2, b2), g``."""
    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.1, d ** -0.5, 0.1, f ** -0.5, 0.1)
    arrays = [rng.standard_normal(s) * sc for s, sc in zip(shapes, scales)]
    arrays[1] += 1.0

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(torch.bfloat16)

    return [card(a) for a in arrays], card(rng.standard_normal((n, d)))


def ffn_library_bf16(torch, args):
    """``ffn_library`` on the bf16 operands, cuBLAS bf16 reducing in f32
    (``precision.f32_accumulation``): the yardstick, never used by the port."""
    from kanvit_torch.utils import precision

    with precision.f32_accumulation():
        return ffn_library(*args)


def check_ffn_bf16(torch, rng, n, d, f, label, timing=True):
    """The bf16 ``ffn_pre_ln`` kernels against their plain twins on the card
    (``K.ffn_pre_ln_bf16`` / ``K.ffn_pre_ln_bwd_bf16``): y within one bf16
    ulp plus 2^-8 of ``K.ffn_spread_bf16`` (one ulp of LN and r, weighted as
    W1 and W2 weigh them); the kernel's ReLU pattern (``relu_mask``) within
    rounding of the twin's (``check_flips``, FLIP_SHARE_BF16); the seven
    gradients, the twin held on the kernel's pattern, each within one bf16
    ulp plus 2^-8 of its spread (dh's ulp through W1 and the LayerNorm's
    VJP, LN's and r's, dh's and LN's) and, for the sums over the rows,
    2 N 2^-24 of the sum of |terms|; every result no further than twice
    the twin from the f64 sums of the same rounded operands; the bits of a
    second call. With ``timing``: CUDA-event and device times beside the f32
    kernels' on the same (upcast) operands, the twin's and the library's
    (``F.layer_norm`` + cuBLAS bf16 ``F.linear``, f32 reduction), and the
    bf16 bound."""
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.ops import kan_bases as K
    from kanvit_torch.utils import precision

    args, g = ffn_bf16_case(torch, rng, n, d, f)
    tag = f"ffn_pre_ln bf16 {label} N={n} D={d} F={f}"
    with torch.inference_mode():
        y, again = FFN._launch_bf16(*args), FFN._launch_bf16(*args)
        check(y.dtype == torch.bfloat16 and tuple(y.shape) == (n, d),
              f"{tag}: output {y.dtype} {tuple(y.shape)}")
        twin, exact = K.ffn_pre_ln_bf16(*args), K.ffn_pre_ln_bf16(*args, exact=True)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, twin, K.ffn_spread_bf16(*args[:6]))
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, twin, exact, "bf16 plain twin")
        del twin, exact, again
        mask = torch.empty(n, f, dtype=torch.uint8, device="cuda")
        FFN._launch_bf16(*args, relu_mask=mask)
        pattern = mask.bool()
        check(torch.equal(FFN._launch_bf16(*args, relu_mask=mask), y),
              f"{tag}: the forward with relu_mask gave other bits")
        _, ln, _ = K._ln_f32(*args[:3])
        lnd = ln.to(torch.bfloat16).float()
        h = lnd @ args[3].float().T + args[4].float()
        flipped = pattern != (h > 0)
        flips = int(flipped.sum())
        terms = lnd.abs() @ args[3].float().abs().T + args[4].float().abs()
        worst = float((h.abs() / terms)[flipped].max()) if flips else 0.0
        del ln, lnd, h, terms, flipped
    check_flips(f"[bf16] {tag}", flips, n * f, worst, 2.0 ** -8 + 2 * d * 2.0 ** -24,
                share=FLIP_SHARE_BF16)

    bwd_tag = tag.replace("ffn_pre_ln", "ffn_pre_ln_bwd")
    with torch.inference_mode():
        got, again = FFN._launch_bwd_bf16(*args[:6], g), FFN._launch_bwd_bf16(*args[:6], g)
        twin = K.ffn_pre_ln_bwd_bf16(*args[:6], g, pattern=pattern)
        exact = K.ffn_pre_ln_bwd_bf16(*args[:6], g, pattern=pattern, exact=True)
        # the sums over the rows: 2 N 2^-24 of their sum of |terms| beside
        # the rounded operands' spread (db1, db2: the order alone)
        spreads = K.ffn_spread_bf16(*args[:6], g=g, pattern=pattern)
        torch.cuda.synchronize()
        err_bwd, f64_bwd = 0.0, 0.0
        for name, a, b, c, e, sp in zip(FFN_BF16_GRADS, got, twin, exact, again, spreads):
            check(a.dtype == torch.bfloat16 and a.shape == b.shape,
                  f"{bwd_tag} {name}: {a.dtype} {tuple(a.shape)}")
            err_bwd = max(err_bwd, bf16_ulp_gate(f"{bwd_tag} {name}", a, b, sp))
            f64_bwd = max(f64_bwd, f64_gate(f"{bwd_tag} {name}", a, b, c, "bf16 plain twin"))
            check(torch.equal(a, e), f"{bwd_tag}: a second backward gave other {name} bits")
        del twin, exact, spreads, again, got
    fwd_extra, bwd_extra = {"f64_err": f64}, {"f64_err": f64_bwd}
    if not timing:
        return (err, None, None, fwd_extra), (err_bwd, None, None, bwd_extra)
    args32, g32 = [a.float() for a in args], g.float()
    lib_leaves, lib_out, _ = grads_of(torch, lambda *a: ffn_library_bf16(torch, a), args, g)

    def lib_grad():
        with precision.f32_accumulation():
            return torch.autograd.grad(lib_out, lib_leaves, g, retain_graph=True)

    with torch.inference_mode():
        times = {
            "ms": time_ms(torch, lambda: FFN._launch_bf16(*args)),
            "device_ms": kernel_ms(torch, lambda: FFN._launch_bf16(*args), label=tag),
            "f32_ms": time_ms(torch, lambda: FFN._launch(*args32)),
            "f32_device_ms": kernel_ms(torch, lambda: FFN._launch(*args32)),
            "plain_ms": time_ms(torch, lambda: K.ffn_pre_ln_bf16(*args), iters=5),
            "library_ms": time_ms(torch, lambda: ffn_library_bf16(torch, args)),
            "library_device_ms": kernel_ms(torch, lambda: ffn_library_bf16(torch, args))}
        btimes = {
            "ms": time_ms(torch, lambda: FFN._launch_bwd_bf16(*args[:6], g)),
            "device_ms": kernel_ms(torch, lambda: FFN._launch_bwd_bf16(*args[:6], g),
                                   label=bwd_tag),
            "f32_ms": time_ms(torch, lambda: FFN._launch_bwd(*args32[:6], g32)),
            "f32_device_ms": kernel_ms(torch, lambda: FFN._launch_bwd(*args32[:6], g32)),
            "plain_ms": time_ms(torch, lambda: K.ffn_pre_ln_bwd_bf16(*args[:6], g), iters=3)}
    btimes["library_ms"] = time_ms(torch, lib_grad)
    btimes["library_device_ms"] = kernel_ms(torch, lib_grad)
    # bytes in bf16: x, W1, W2, vectors in, y out; backward x, g, W1, W2 and
    # vectors in, dx, dW1, dW2 and the vector gradients out
    fwd_bound = bf16_bound(4.0 * n * d * f, 2.0 * (2 * n * d + 2 * d * f + f + 3 * d),
                           times["library_ms"])
    bwd_bound = bf16_bound(10.0 * n * d * f,
                           2.0 * (3 * n * d + 4 * d * f + 2 * f + 6 * d), btimes["library_ms"])
    for what, t, b in ((tag, times, fwd_bound), (bwd_tag, btimes, bwd_bound)):
        print(f"[bf16] {what}: kernels {t['ms']:.4f} ms (device {t['device_ms']:.4f})  the "
              f"f32 kernels {t['f32_ms']:.4f} (device {t['f32_device_ms']:.4f})  plain twin "
              f"{t['plain_ms']:.4f}  library (F.layer_norm, cuBLAS bf16 F.linear) "
              f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f})  bound "
              f"{b['bound_ms']:.4f} ({b['bound_by']}; share of device "
              f"{b['bound_ms'] / t['device_ms']:.3f})  (bits repeated)")
    return ((err, times.pop("ms"), times.pop("plain_ms"), {**fwd_extra, **times}, fwd_bound),
            (err_bwd, btimes.pop("ms"), btimes.pop("plain_ms"), {**bwd_extra, **btimes},
             bwd_bound))


def phase_ffn_bf16_kernels(torch):
    """The bf16 fused FF's forward and backward kernels at vit-s (12,608 x
    384 x 1,536), then (sub-entries) one vit-s image (197 rows), a ragged
    narrow shape, and vit-b's (768 x 3,072) and vit-l's (1,024 x 4,096)
    widths at vit-s's rows (the tiled route), timed there too."""
    rng = np.random.default_rng(SEED + 23)
    n = BATCH * 197
    fwd, bwd = check_ffn_bf16(torch, rng, n, 384, 1536, "vit-s")
    for key, rows, d, f, timing in (("batch_1", 197, 384, 1536, False),
                                    ("ragged", 37 * 50 + 1, 100, 400, False),
                                    ("vit_b_widths", n, 768, 3072, True),
                                    ("vit_l_widths", n, 1024, 4096, True)):
        sub_f, sub_b = check_ffn_bf16(torch, rng, rows, d, f, key.replace("_", "-"), timing)
        fwd += ({key: sub_entry(sub_f)},)
        bwd += ({key: sub_entry(sub_b)},)
    return {"ffn_pre_ln_bf16": fwd, "ffn_pre_ln_bwd_bf16": bwd}


# --------------------------------------------------------------------------
# Phase 9: serving
# --------------------------------------------------------------------------

def launch_counts():
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.kernels import int8_matmul as IM

    return {**FB.LAUNCHES, **FA.LAUNCHES, **FFN.LAUNCHES, **IM.LAUNCHES}


def reset_counts():
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.kernels import int8_matmul as IM

    for module in (FB, FA, FFN, IM):
        module.reset_launches()


def build_model(variant, preset="vit-s", **kw):
    """``preset``'s ``variant`` (``kw`` overriding the preset, e.g.
    ``n_blocks``), f32 weights from ``SEED``, on the CPU."""
    from kanvit_torch.models import PRESETS, create_model

    t0 = time.perf_counter()
    model_cpu = create_model(variant, **{**PRESETS[preset], **kw}, seed=SEED)
    n_params = sum(p.numel() for p in model_cpu.parameters())
    print(f"[main] {preset} {variant} {kw or ''} f32: {n_params} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return model_cpu


def serve_rate(torch, pred, batch):
    """Steady-state images/s of ``pred.logits`` at one batch, host to host."""
    for _ in range(3):
        pred.logits(batch)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.logits(batch)
    torch.cuda.synchronize()
    return iters * len(batch) / (time.perf_counter() - t0)


def phase_serve(torch, smi, model_cpu, tag, per_batch, seed):
    """Serve three requests (64, 64 and 37 images) through ``Predictor``:
    exactly ``per_batch`` kernel launches a forward batch and no backward
    launch, finite logits of the right shapes, probabilities that sum to 1,
    two images' logits against the same model's CPU forward, and the
    steady-state images/s."""
    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import PRESETS

    geom = PRESETS["vit-s"]
    model = copy.deepcopy(model_cpu).to("cuda")
    pred = Predictor(model, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((sum(REQUESTS), *geom["chw"])).astype(np.float32)
    bounds = np.cumsum((0,) + REQUESTS)
    reqs = [images[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

    reset_counts()
    logits = [pred.logits(reqs[0]), pred.logits(reqs[1])]
    labels, probs = pred.predict(reqs[2])
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fwd = len(REQUESTS)  # each request is one padded batch
    want = {k: 0 for k in counts}
    want.update({k: n_fwd * n for k, n in per_batch.items()})
    print(f"[{tag}] vit-s {model_cpu.type} launches over {n_fwd} forward batches: "
          f"{ {k: n for k, n in counts.items() if n} } (want per batch {per_batch}, "
          "nothing else, no backward)")
    check(counts == want, f"{tag}: launch counts {counts} != {want}")
    for r, y in zip(reqs, logits):
        check(y.shape == (len(r), geom["out_d"]), f"{tag}: logits shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{tag}: logits are not finite")
    check(probs.shape == (REQUESTS[2], geom["out_d"]) and labels.shape == (REQUESTS[2],),
          f"{tag}: predict shapes {probs.shape}, {labels.shape}")
    check(bool(np.isfinite(probs).all())
          and float(np.abs(probs.sum(-1) - 1).max()) < 1e-6,
          f"{tag}: predict probabilities do not sum to 1")

    with torch.inference_mode():
        ref = model_cpu(torch.from_numpy(reqs[0][:2])).numpy()
    err = float(np.abs(logits[0][:2] - ref).max())
    print(f"[{tag}] logits of 2 images, GPU against CPU plain forward: max|err| "
          f"{err:.3e}  limit {TOL_LOGITS:.0e}")
    check(err <= TOL_LOGITS, f"{tag}: GPU logits differ from the CPU forward by {err}")

    # steady state, batch 64: host images in, host logits out
    batch = reqs[0]
    ips = serve_rate(torch, pred, batch)
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(x), iters=10)
    print(f"[{tag}] Predictor.logits steady state, batch {BATCH}: {ips:.1f} images/s "
          f"({BATCH / ips * 1e3:.2f} ms per batch, host to host); device forward "
          f"{fwd_ms:.2f} ms per batch ({BATCH / fwd_ms * 1e3:.1f} images/s)  "
          f"[{smi}]")
    return {"images_per_s": ips, "device_forward_ms": fwd_ms,
            "logits_err": err, "launches": counts}


# --------------------------------------------------------------------------
# Phase 9b: bf16 serving
# --------------------------------------------------------------------------

def bf16_ulp_gate(tag, got, want, spread=None, p_ulp=BF16_P_ULP):
    """Elementwise within one bf16 ulp of the plain twin: |a - b| <=
    2^-7 |b| + 2^-12 max|b|, plus one bf16 ulp of every rounded
    intermediate weighted as the next product weighs it, 2^-8 ``spread``:
    for the attention every probability as P V weights it, (bf16(p) @ |v|)
    / l (the twin's attention over |v|); for a KAN forward every basis value
    as W weighs it, |T| |W|; for a KAN dW as gy weighs it, |T|^T |gy|.
    ``p_ulp`` replaces 2^-8 (the tiled bf16 forward: 2^-7, two-sided).
    Returns max|a - b|; prints how many elements lie past the one-ulp part
    alone."""
    got64, want64 = got.double(), want.double()
    err = (got64 - want64).abs()
    ulp = BF16_ULP_REL * want64.abs() + BF16_ULP_ABS * float(want64.abs().max())
    bound = ulp if spread is None else ulp + p_ulp * spread.double()
    ok = bool(got.isfinite().all()) and bool((err <= bound).all())
    worst = float((err - bound).max())
    past = int((err > ulp).sum())
    print(f"[bf16] {tag}: max|err| {float(err.max()):.3e}, worst margin to the gate "
          f"{worst:.3e}; {past} of {err.numel()} past one output ulp  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: bf16 kernel further than its gate from its plain twin")
    return float(err.max())


def bf16_bound(flops, nbytes, library_ms=None):
    """``bound`` at the dense bf16 tensor-core rate."""
    return bound(flops, nbytes, library_ms, peak=PEAK_BF16_FLOPS)


def check_bspline_bf16(torch, rng, name, label, n, heads, nin, nout, per_head=False):
    """A bf16 B-spline forward (``bspline_kan``: ``heads`` None;
    ``bspline_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card (one bf16 ulp) and the f64 sum of the same rounded
    operands (no further than twice the twin), its bits repeated; CUDA-event
    and device times beside the f32 kernel's on the same (upcast) operands
    and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    if heads is None:
        x, (grid, *p), _ = bspline_case(torch, rng, n, nin, nout)
        groups, entry, pack = 1, FB.bspline_kan, FB.pack_weight
    else:
        x, (grid, *p), _ = qkv_case(torch, rng, n, heads, nin, per_head)
        groups, entry, pack = heads, FB.bspline_qkv_grouped, FB.pack_qkv_weight
    xb, pb = x.to(bf16), [t.to(bf16) for t in p]
    out = pb[0].shape[-2]
    tag = f"{name} bf16 {label} N={n} G={groups} {nin}->{out}"

    def plain(exact=False):
        if heads is None:
            return K.bspline_kan_forward_bf16(xb, grid, *pb, exact=exact)
        return torch.cat([K.bspline_kan_forward_bf16(
            xb[:, i * nin:(i + 1) * nin], grid[i] if grid.dim() == 3 else grid,
            *(t[i] for t in pb), exact=exact) for i in range(heads)], dim=1)

    wb = pack(*pb).contiguous()
    w32 = pack(*(t.float() for t in pb)).contiguous()
    if heads is None:
        wb, w32 = wb.unsqueeze(0), w32.unsqueeze(0)
    x32 = xb.float()

    def kernel():
        return FB._launch(name, "bspline", xb, wb, grid)

    def f32_kernel():
        return FB._launch(name, "bspline", x32, w32, grid)

    with torch.inference_mode():
        y = entry(xb, grid, *pb)
        check(y.dtype == bf16, f"{tag}: output {y.dtype}")
        again = kernel()
        ref, exact = plain(), plain(exact=True)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, ref)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact, "bf16 plain twin")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernel")
        plain_ms = time_ms(torch, plain)
    flops = 2.0 * n * groups * FB.N_SLICES * nin * out
    nbytes = 2.0 * (n * groups * nin + groups * FB.N_SLICES * nin * out
                    + n * groups * out) + 4.0 * grid.numel()
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernel "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_attention_bf16(torch, rng, b, t, heads, dh, label, cases):
    """The bf16 lanes forward on q, k, v as strided slices of a bf16
    (N, H*3dh) projection output, each case against the plain twin (one
    bf16 ulp; a fully masked row exactly 0); the first case also against
    the f64 reference (no further than twice the twin), its bits repeated,
    CUDA-event and device times beside the f32 kernel's on the same
    (upcast) operands, the twin's and ``scaled_dot_product_attention``'s in
    bf16."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    bf16 = torch.bfloat16
    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda().to(bf16)
    y32 = y.float()

    def views(a):
        a4 = a.view(b, t, heads, 3 * dh)
        return [a4[..., i * dh:(i + 1) * dh] for i in range(3)]

    (q, k, v), (q32, k32, v32) = views(y), views(y32)
    tag = f"flash_attention_lanes bf16 {label} B={b} T={t} H={heads} dh={dh}"
    errs = []
    with torch.inference_mode():
        for causal, mask in cases:
            o = FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)
            check(o.dtype == bf16, f"{tag}: output {o.dtype}")
            ref = A.lanes_attention(q, k, v, heads, causal=causal, mask=mask)
            spread = A.lanes_attention(q, k, v.abs(), heads, causal=causal, mask=mask)
            torch.cuda.synchronize()
            case = f"causal={causal} mask={'none' if mask is None else 'yes'}"
            errs.append(bf16_ulp_gate(f"{tag} {case}", o, ref, spread))
            if mask is not None:
                dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
                check(bool((o[dead] == 0).all()), "a fully masked row must output exactly 0")
        causal, mask = cases[0]

        def kernel():
            return FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)

        def f32_kernel():
            return FA.flash_attention_lanes(q32, k32, v32, heads, causal=causal, mask=mask)

        def plain():
            return A.lanes_attention(q, k, v, heads, causal=causal, mask=mask)

        o, again = kernel(), kernel()
        check(torch.equal(o, again), f"{tag}: the bits of a repeated forward differ")
        f64 = f64_gate(tag, o, plain(), A.lanes_attention(
            q, k, v, heads, causal=causal, mask=mask, exact=True), "bf16 plain twin")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, label=f"{tag}, the f32 kernel")
        plain_ms = time_ms(torch, plain)
    lviews = [a.transpose(1, 2) for a in (q, k, v)]
    lib_ms = sdpa_ms(torch, *lviews, causal, mask)
    lib_dev_ms = sdpa_ms(torch, *lviews, causal, mask, device=True)
    pairs = t * (t + 1) / 2 if causal else t * t
    bounds = bf16_bound(2.0 * b * heads * pairs * dh * 2, 2.0 * 4 * b * t * heads * dh,
                        lib_ms)
    print(f"[bf16] {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernel "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  "
          f"scaled_dot_product_attention bf16 {lib_ms:.4f} (device {lib_dev_ms:.4f})  "
          f"bound {bounds['bound_ms']:.4f} ({bounds['bound_by']})")
    return errs[0], ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                                   "f32_device_ms": f32_dev_ms,
                                   "library_device_ms": lib_dev_ms}, bounds


def check_bspline_bwd_bf16(torch, rng, name, label, n, heads, nin, nout, per_head=False,
                           need_dx=True):
    """A bf16 B-spline backward (``bspline_kan``: ``heads`` None, asked for
    dx only where ``need_dx``, as the training step asks its embedder;
    ``bspline_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: dx within one bf16 ulp, dW within one bf16 ulp plus one
    of every rounded basis value weighted as gy weighs it, 2^-8 |B|^T |gy|;
    each no further than twice the twin from the f64 sum of the same rounded
    operands; the bits of a second call, and the no-dx dW the all-gradients
    dW's bits. CUDA-event and device times beside the f32 kernels' on the
    same (upcast) operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    if heads is None:
        x, (grid, *p), _ = bspline_case(torch, rng, n, nin, nout)
        groups, pack = 1, FB.pack_weight
    else:
        x, (grid, *p), _ = qkv_case(torch, rng, n, heads, nin, per_head)
        groups, pack = heads, FB.pack_qkv_weight
    xb = x.to(bf16)
    wb = pack(*(t.to(bf16) for t in p)).contiguous()
    if heads is None:
        wb = wb.unsqueeze(0)
    out = wb.shape[-1]
    gy = torch.from_numpy(rng.standard_normal((n, groups * out)).astype(np.float32)
                          ).cuda().to(bf16)
    x32, w32, gy32 = xb.float(), wb.float(), gy.float()
    tag = f"{name} bwd bf16 {label} N={n} G={groups} {nin}->{out}"

    def kernel(dx=need_dx):
        return FB._launch_bwd_bf16(name, xb, wb, grid, gy, dx, True)

    def f32_kernel():
        return FB._launch_bwd(f"{name}_bwd", "bspline", x32, w32, grid, gy32, need_dx, True)

    def plain(exact=False):
        return K.bspline_grouped_backward_bf16(xb, grid, wb, gy, need_dx, True, exact=exact)

    with torch.inference_mode():
        dx, dw = kernel()
        dx2, dw2 = kernel()
        _, dw_all = kernel(True)
        (pdx, pdw), (edx, edw) = plain(), plain(exact=True)
        spread = K.bspline_dw_spread_bf16(xb, grid, wb, gy)
        torch.cuda.synchronize()
        check(dw.dtype == bf16 and (dx is None) != need_dx, f"{tag}: outputs")
        err = bf16_ulp_gate(f"{tag} dW", dw, pdw, spread)
        f64 = f64_gate(f"{tag} dW", dw, pdw, edw, "bf16 plain twin")
        check(torch.equal(dw, dw2), f"{tag}: a second backward gave other dW bits")
        check(torch.equal(dw, dw_all), f"{tag}: the no-dx dW differs from the "
                                       "all-gradients dW")
        if need_dx:
            err = max(err, bf16_ulp_gate(f"{tag} dx", dx, pdx))
            f64 = max(f64, f64_gate(f"{tag} dx", dx, pdx, edx, "bf16 plain twin"))
            check(torch.equal(dx, dx2), f"{tag}: a second backward gave other dx bits")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain)
    flops = 2.0 * n * groups * FB.N_SLICES * nin * out * (2 if need_dx else 1)
    wsize = groups * FB.N_SLICES * nin * out  # W read for dx only, dW written
    nbytes = 2.0 * (n * groups * nin * (1 + need_dx) + wsize * (1 + need_dx)
                    + n * groups * out) + 4.0 * grid.numel()
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def cheby_bf16_case(torch, rng, n, heads, nin, nout):
    """The bf16 Chebyshev operands of the embedder (``heads`` None:
    ``chebykan``'s coefficients (nin, nout, 5)) or of the grouped q/k/v
    (``heads`` groups of ``nin``: ``cheby_qkv_grouped``'s (H, dh, out, 5)):
    x (n, G nin) with a tenth where tanh rounds to +-1, the coefficients at
    the init's scale and their packed weight (G, 5, nin, nout)."""
    from kanvit_torch.kernels import fused_basis as FB

    bf16 = torch.bfloat16
    groups = 1 if heads is None else heads
    x = torch.from_numpy(cheby_inputs(rng, (n, groups * nin), 0.1)).cuda().to(bf16)
    cc = torch.from_numpy((rng.standard_normal((groups, nin, nout, 5)) / np.sqrt(nin * 5))
                          .astype(np.float32)).cuda().to(bf16)
    if heads is None:
        return x, cc[0], FB.pack_cheby_weight(cc[0]).contiguous(), groups
    return x, cc, FB.pack_cheby_qkv_weight(cc).contiguous(), groups


def check_cheby_bf16(torch, rng, name, label, n, heads, nin, nout):
    """A bf16 Chebyshev forward (``chebykan``: ``heads`` None;
    ``cheby_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: one bf16 ulp plus one of every rounded T_n weighted as
    W weighs it, 2^-8 |T| |W|; no further than twice the twin from the f64
    sum of the same rounded operands; its bits repeated. CUDA-event and
    device times beside the f32 kernel's on the same (upcast) operands and
    the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    x, coeffs, wb, groups = cheby_bf16_case(torch, rng, n, heads, nin, nout)
    entry = FB.chebykan if heads is None else FB.cheby_qkv_grouped
    x32, w32 = x.float(), wb.float()
    tag = f"{name} bf16 {label} N={n} G={groups} {nin}->{nout}"

    def kernel():
        return FB._launch_bf16(name, x, wb, FB.CHEBY_DEGREE)

    def f32_kernel():
        return FB._launch(name, "cheby", x32, w32, FB.CHEBY_DEGREE)

    def plain(exact=False):
        return K.cheby_grouped_forward_bf16(x, wb, exact=exact)

    with torch.inference_mode():
        y = entry(x, coeffs)
        check(y.dtype == bf16 and tuple(y.shape) == (n, groups * nout),
              f"{tag}: output {y.dtype} {tuple(y.shape)}")
        again = kernel()
        ref, exact = plain(), plain(exact=True)
        spread = K.cheby_fwd_spread_bf16(x, wb)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, ref, spread)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact, "bf16 plain twin")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernel")
        plain_ms = time_ms(torch, plain)
    slices = FB.CHEBY_DEGREE + 1
    flops = 2.0 * n * groups * slices * nin * nout
    nbytes = 2.0 * (n * groups * nin + groups * slices * nin * nout + n * groups * nout)
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernel "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_cheby_bwd_bf16(torch, rng, name, label, n, heads, nin, nout, need_dx=True):
    """A bf16 Chebyshev backward (``chebykan``: ``heads`` None, asked for dx
    only where ``need_dx``, as the training step asks its embedder;
    ``cheby_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: dx within one bf16 ulp (a tenth of x where tanh rounds
    to +-1, whose dx is 0), dW within one bf16 ulp plus one of every rounded
    T_n weighted as gy weighs it, 2^-8 |T|^T |gy|; each no further than
    twice the twin from the f64 sum of the same rounded operands; the bits
    of a second call, and the no-dx dW the all-gradients dW's bits. Times
    beside the f32 kernels' on the same (upcast) operands and the twin's,
    and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    x, _, wb, groups = cheby_bf16_case(torch, rng, n, heads, nin, nout)
    gy = torch.from_numpy(rng.standard_normal((n, groups * nout)).astype(np.float32)
                          ).cuda().to(bf16)
    x32, w32, gy32 = x.float(), wb.float(), gy.float()
    deg = FB.CHEBY_DEGREE
    tag = f"{name} bwd bf16 {label} N={n} G={groups} {nin}->{nout}"

    def kernel(dx=need_dx):
        return FB._launch_bwd_bf16(name, x, wb, deg, gy, dx, True)

    def f32_kernel():
        return FB._launch_bwd(f"{name}_bwd", "cheby", x32, w32, deg, gy32, need_dx, True)

    def plain(exact=False):
        return K.cheby_grouped_backward_bf16(x, wb, gy, need_dx, True, exact=exact)

    with torch.inference_mode():
        dx, dw = kernel()
        dx2, dw2 = kernel()
        _, dw_all = kernel(True)
        (pdx, pdw), (edx, edw) = plain(), plain(exact=True)
        spread = K.cheby_dw_spread_bf16(x, wb, gy)
        torch.cuda.synchronize()
        check(dw.dtype == bf16 and (dx is None) != need_dx, f"{tag}: outputs")
        err = bf16_ulp_gate(f"{tag} dW", dw, pdw, spread)
        f64 = f64_gate(f"{tag} dW", dw, pdw, edw, "bf16 plain twin")
        check(torch.equal(dw, dw2), f"{tag}: a second backward gave other dW bits")
        check(torch.equal(dw, dw_all), f"{tag}: the no-dx dW differs from the "
                                       "all-gradients dW")
        if need_dx:
            err = max(err, bf16_ulp_gate(f"{tag} dx", dx, pdx))
            f64 = max(f64, f64_gate(f"{tag} dx", dx, pdx, edx, "bf16 plain twin"))
            check(torch.equal(dx, dx2), f"{tag}: a second backward gave other dx bits")
            check(bool((dx[x.float().abs() >= 9.5] == 0).all()),
                  f"{tag}: dx where tanh rounds to +-1 is not 0")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain)
    slices = deg + 1
    flops = 2.0 * n * groups * slices * nin * nout * (2 if need_dx else 1)
    wsize = groups * slices * nin * nout  # W read for dx only, dW written
    nbytes = 2.0 * (n * groups * nin * (1 + need_dx) + wsize * (1 + need_dx)
                    + n * groups * nout)
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def fast_bf16_case(torch, rng, n, heads, nin, nout, large=False):
    """The bf16 FastKAN operands of the embedder (``heads`` None, one group)
    or of one grouped q/k/v projection (``heads`` groups of ``nin``): x (n,
    G nin) from ``fast_inputs`` (with ``large`` a third at |x| 20-60, where
    silu(x) dominates the base slice), the LayerNorm's gamma and beta (G,
    nin) and the packed weight (G, 9, nin, nout) at the init's scale, all
    bf16; the 8 centres f32 and the spacing. Returns ``(x, w, gamma, beta,
    grid, den)``."""
    from kanvit_torch.kernels import fused_basis as FB

    bf16 = torch.bfloat16
    groups = 1 if heads is None else heads
    x = fast_inputs(rng, (n, groups * nin))
    if large:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 3, replace=False)
        flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(bf16)

    gamma = cuda(1 + 0.1 * rng.standard_normal((groups, nin)))
    beta = cuda(0.1 * rng.standard_normal((groups, nin)))
    sw = cuda(rng.standard_normal((groups, nout, nin * 8)) / np.sqrt(nin * 8))
    bw = cuda(rng.standard_normal((groups, nout, nin)) / np.sqrt(nin))
    w = FB.pack_fastkan_qkv_weight(sw, bw, 8).contiguous()
    grid = torch.linspace(-2.0, 2.0, 8, device="cuda")
    return cuda(x), w, gamma, beta, grid, 4.0 / 7.0


def check_fastkan_bf16(torch, rng, name, label, n, heads, nin, nout, large=False):
    """A bf16 FastKAN forward (``fastkan``: ``heads`` None;
    ``fastkan_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: one bf16 ulp plus one of every rounded basis value
    weighted as W weighs it, 2^-8 |B| |W|; no further than twice the twin
    from the f64 sum of the same rounded operands; its bits repeated. CUDA
    events and device times beside the f32 kernels' on the same (upcast)
    operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x, wb, ga, be, grid, den = fast_bf16_case(torch, rng, n, heads, nin, nout, large)
    groups, slices = wb.shape[:2]
    x32, w32, ga32, be32 = (t.float() for t in (x, wb, ga, be))
    tag = f"{name} bf16 {label} N={n} G={groups} {nin}->{nout}"

    def kernel():
        return FB._launch_rbf(name, x, wb, ga, be, grid, den)[0]

    def f32_kernel():
        return FB._launch_rbf(name, x32, w32, ga32, be32, grid, den)[0]

    def plain(exact=False):
        return K.fastkan_grouped_forward_bf16(x, wb, ga, be, grid, den, exact=exact)

    with torch.inference_mode():
        y, again = kernel(), kernel()
        check(y.dtype == torch.bfloat16 and tuple(y.shape) == (n, groups * nout),
              f"{tag}: output {y.dtype} {tuple(y.shape)}")
        ref, exact = plain(), plain(exact=True)
        spread = K.fastkan_fwd_spread_bf16(x, wb, ga, be, grid, den)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, ref, spread)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact, "bf16 plain twin")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain)
    flops = 2.0 * n * groups * slices * nin * nout
    # x, W, gamma and beta read, y written: the LayerNorm's statistics are
    # the port's, kept for its backward, not the function's
    nbytes = (2.0 * (n * groups * nin + groups * slices * nin * nout + n * groups * nout
                     + 2 * groups * nin) + 4.0 * grid.numel())
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_fastkan_bwd_bf16(torch, rng, name, label, n, heads, nin, nout, need_dx=True):
    """A bf16 FastKAN backward (``fastkan``: ``heads`` None, asked for dx
    only where ``need_dx``, as the training step asks its embedder;
    ``fastkan_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: dx, dgamma and dbeta within one bf16 ulp, dW within one
    bf16 ulp plus one of every rounded basis value weighted as gy weighs it,
    2^-8 |B|^T |gy|; each no further than twice the twin from the f64 sums of
    the same operands; the bits of a second call, and the no-dx dW, dgamma
    and dbeta the all-gradients route's bits. Times beside the f32 kernels'
    on the same (upcast) operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    x, wb, ga, be, grid, den = fast_bf16_case(torch, rng, n, heads, nin, nout)
    groups, slices = wb.shape[:2]
    gy = torch.from_numpy(rng.standard_normal((n, groups * nout)).astype(np.float32)
                          ).cuda().to(bf16)
    x32, w32, ga32, be32, gy32 = (t.float() for t in (x, wb, ga, be, gy))
    tag = f"{name} bwd bf16 {label} N={n} G={groups} {nin}->{nout}"
    with torch.inference_mode():
        _, stats = FB._launch_rbf(name, x, wb, ga, be, grid, den)
        _, stats32 = FB._launch_rbf(name, x32, w32, ga32, be32, grid, den)

    def kernel(dx=need_dx):
        return FB._launch_rbf_bwd(f"{name}_bwd", x, wb, ga, be, grid, den, stats, gy, dx,
                                  True)

    def f32_kernel():
        return FB._launch_rbf_bwd(f"{name}_bwd", x32, w32, ga32, be32, grid, den, stats32,
                                  gy32, need_dx, True)

    def plain(exact=False):
        return K.fastkan_grouped_backward_bf16(x, wb, ga, be, grid, den, gy, need_dx, True,
                                               exact=exact)

    with torch.inference_mode():
        got, again, every = kernel(), kernel(), kernel(True)
        twin, exact = plain(), plain(exact=True)
        spread = K.fastkan_dw_spread_bf16(x, wb, ga, be, grid, den, gy)
        torch.cuda.synchronize()
        check(all(t.dtype == bf16 for t in got[1:]) and (got[0] is None) != need_dx,
              f"{tag}: outputs")
        err, f64 = 0.0, 0.0
        for i, what in enumerate(("dx", "dW", "dgamma", "dbeta")):
            if got[i] is None:
                continue
            err = max(err, bf16_ulp_gate(f"{tag} {what}", got[i], twin[i],
                                         spread if what == "dW" else None))
            f64 = max(f64, f64_gate(f"{tag} {what}", got[i], twin[i], exact[i],
                                    "bf16 plain twin"))
            check(torch.equal(got[i], again[i]), f"{tag}: a second backward gave other "
                                                 f"{what} bits")
            if what != "dx":
                check(torch.equal(got[i], every[i]), f"{tag}: the no-dx {what} differs "
                                                     "from the all-gradients route's")
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain)
    # gW (dln needs it even without dx) and dW; W read once, dW written; the
    # function's own bytes, without the statistics the port keeps
    flops = 2.0 * n * groups * slices * nin * nout * 2
    wsize = groups * slices * nin * nout
    nbytes = (2.0 * (n * groups * nin * (1 + need_dx) + 2 * wsize + n * groups * nout
                     + 4 * groups * nin) + 4.0 * grid.numel())
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


# dfreq's f32 sum of n nin terms gW x cos a a slice cancels far below the
# terms' magnitudes; two orders of summation differ by up to their longest
# chain of additions times 2^-24 of sum |gW x cos a|: the gate's term, for
# chains up to 1024 adds (the kernel's row tiles and features, the twin's
# reductions), beside one bf16 ulp.
SINE_DFREQ_ORDER = 2.0 ** -14


def sine_bf16_case(torch, rng, n, heads, nin, nout, large=False):
    """The bf16 SineKAN operands of the embedder (``heads`` None, one
    group, grid 28) or of one grouped q/k/v projection (``heads`` groups of
    ``nin``, grid 4): x (n, G nin) from ``sine_inputs`` (with ``large`` a
    third at |x| 20-60, arguments in the hundreds), freq (G, S) at the
    init's k / (S + 1), jittered, and the packed weight (G, S, nin, nout) at
    the init's scale, all bf16; the phase table (nin, S) f32. Returns ``(x,
    w, freq2d, phase)``."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    groups, grid_size = (1, 28) if heads is None else (heads, 4)
    x = sine_inputs(rng, (n, groups * nin))
    if large:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 3, replace=False)
        flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(bf16)

    k = np.arange(1, grid_size + 1)
    freq = cuda(k / (grid_size + 1) + 0.05 * rng.standard_normal((groups, grid_size)))
    amps = cuda(rng.uniform(-1.0, 1.0, (groups, nout, nin, grid_size)) / np.sqrt(nin) / k)
    phase = K.sinekan_phase_init(nin, grid_size).cuda()
    return cuda(x), FB.pack_sine_qkv_weight(amps).contiguous(), freq, phase


def check_sine_bf16(torch, rng, name, label, n, heads, nin, nout, large=False):
    """A bf16 sine forward (``sinekan``: ``heads`` None, grid 28;
    ``sinekan_qkv_grouped``: ``heads`` groups of ``nin``, grid 4) against its
    plain twin on the card: one bf16 ulp plus one of every rounded basis
    value weighted as W weighs it, 2^-8 |sin a| |W|; no further than twice
    the twin from the f64 sum of the same rounded operands; its bits
    repeated. CUDA events and device times beside the f32 kernels' on the
    same (upcast) operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x, wb, f2, phase = sine_bf16_case(torch, rng, n, heads, nin, nout, large)
    groups, slices = wb.shape[:2]
    x32, w32, f32 = x.float(), wb.float(), f2.float()
    tag = f"{name} bf16 {label} N={n} G={groups} S={slices} {nin}->{nout}"

    def kernel():
        return FB._launch_sine(name, x, wb, f2, phase)

    def f32_kernel():
        return FB._launch_sine(name, x32, w32, f32, phase)

    def plain(exact=False):
        return K.sine_grouped_forward_bf16(x, wb, f2, phase, exact=exact)

    with torch.inference_mode():
        y, again = kernel(), kernel()
        check(y.dtype == torch.bfloat16 and tuple(y.shape) == (n, groups * nout),
              f"{tag}: output {y.dtype} {tuple(y.shape)}")
        ref, exact = plain(), plain(exact=True)
        spread = K.sine_fwd_spread_bf16(x, wb, f2, phase)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, ref, spread)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact, "bf16 plain twin")
        del ref, exact, spread
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain, iters=5)
    flops = 2.0 * n * groups * slices * nin * nout
    # x, W, freq read, y written, the phase table f32
    nbytes = (2.0 * (n * groups * nin + groups * slices * nin * nout + n * groups * nout
                     + groups * slices) + 4.0 * phase.numel())
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_sine_bwd_bf16(torch, rng, name, label, n, heads, nin, nout, need_dx=True):
    """A bf16 sine backward (``sinekan``: ``heads`` None, asked for dx only
    where ``need_dx``, as the training step asks its embedder;
    ``sinekan_qkv_grouped``: ``heads`` groups of ``nin``) against its plain
    twin on the card: dx within one bf16 ulp, dW within one bf16 ulp plus
    2^-8 |sin a|^T |gy|, dfreq within one bf16 ulp plus SINE_DFREQ_ORDER of
    sum |gW x cos a|; each no further than twice the twin from the f64 sums
    of the same operands; the bits of a second call, and the no-dx dW and
    dfreq the all-gradients route's bits. Times beside the f32 kernels' on
    the same (upcast) operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    x, wb, f2, phase = sine_bf16_case(torch, rng, n, heads, nin, nout)
    groups, slices = wb.shape[:2]
    gy = torch.from_numpy(rng.standard_normal((n, groups * nout)).astype(np.float32)
                          ).cuda().to(bf16)
    x32, w32, f32, gy32 = (t.float() for t in (x, wb, f2, gy))
    tag = f"{name} bwd bf16 {label} N={n} G={groups} S={slices} {nin}->{nout}"

    def kernel(dx=need_dx):
        return FB._launch_sine_bwd(f"{name}_bwd", x, wb, f2, phase, gy, dx, True)

    def f32_kernel():
        return FB._launch_sine_bwd(f"{name}_bwd", x32, w32, f32, phase, gy32, need_dx, True)

    def plain(exact=False):
        return K.sine_grouped_backward_bf16(x, wb, f2, phase, gy, need_dx, True, exact=exact)

    with torch.inference_mode():
        got, again, every = kernel(), kernel(), kernel(True)
        twin, exact = plain(), plain(exact=True)
        spreads = {"dW": (BF16_P_ULP, K.sine_dw_spread_bf16(x, wb, f2, phase, gy)),
                   "dfreq": (SINE_DFREQ_ORDER, K.sine_dfreq_spread_bf16(x, wb, f2, phase, gy))}
        torch.cuda.synchronize()
        check(all(t.dtype == bf16 for t in got[1:]) and (got[0] is None) != need_dx,
              f"{tag}: outputs")
        err, f64 = 0.0, 0.0
        for i, what in enumerate(("dx", "dW", "dfreq")):
            if got[i] is None:
                continue
            weight, spread = spreads.get(what, (0.0, None))
            err = max(err, bf16_ulp_gate(f"{tag} {what}", got[i], twin[i],
                                         None if spread is None
                                         else spread * (weight / BF16_P_ULP)))
            f64 = max(f64, f64_gate(f"{tag} {what}", got[i], twin[i], exact[i],
                                    "bf16 plain twin"))
            check(torch.equal(got[i], again[i]), f"{tag}: a second backward gave other "
                                                 f"{what} bits")
            if what != "dx":
                check(torch.equal(got[i], every[i]), f"{tag}: the no-dx {what} differs "
                                                     "from the all-gradients route's")
        del twin, exact, spreads
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain, iters=5)
    # gW (dfreq needs it even without dx) and dW; W read once, dW and dfreq
    # written, dx where asked
    flops = 2.0 * n * groups * slices * nin * nout * 2
    wsize = groups * slices * nin * nout
    nbytes = (2.0 * (n * groups * nin * (1 + need_dx) + 2 * wsize + n * groups * nout
                     + 2 * groups * slices) + 4.0 * phase.numel())
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def fourier_bf16_case(torch, rng, n, nin, nout, grid_size=28):
    """The bf16 Fourier embedder's operands: x (n, nin) from
    ``fourier_inputs`` (every 7th entry over [-10, 10], arguments k x up to
    280) and the packed weight (1, 2G, nin, nout), cos harmonics first, at
    NaiveFourierKAN's init scale, normals / sqrt(nin G), both bf16. Returns
    ``(x, w)``."""
    from kanvit_torch.kernels import fused_basis as FB

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(torch.bfloat16)

    coeffs = rng.standard_normal((2, nout, nin, grid_size)) / np.sqrt(nin * grid_size)
    return (cuda(fourier_inputs(rng, (n, nin))),
            FB.pack_fourier_weight(cuda(coeffs)).contiguous())


def check_fourier_bf16(torch, rng, label, n, nin, nout, grid_size=28):
    """The bf16 ``fourierkan`` forward against its plain twin on the card:
    one bf16 ulp plus one of every rounded basis value weighted as W weighs
    it, 2^-8 |B| |W|; no further than twice the twin from the f64 sum of the
    same rounded operands; its bits repeated. CUDA events and device times
    beside the f32 kernels' on the same (upcast) operands and the twin's,
    and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    x, wb = fourier_bf16_case(torch, rng, n, nin, nout, grid_size)
    x32, w32 = x.float(), wb.float()
    tag = f"fourierkan bf16 {label} N={n} G={grid_size} {nin}->{nout}"

    def kernel():
        return FB._launch_bf16("fourierkan", x, wb, grid_size)

    def f32_kernel():
        return FB._launch("fourierkan", "fourier", x32, w32, grid_size)

    def plain(exact=False):
        return K.fourier_grouped_forward_bf16(x, wb, exact=exact)

    with torch.inference_mode():
        y, again = kernel(), kernel()
        check(y.dtype == torch.bfloat16 and tuple(y.shape) == (n, nout),
              f"{tag}: output {y.dtype} {tuple(y.shape)}")
        ref, exact = plain(), plain(exact=True)
        spread = K.fourier_fwd_spread_bf16(x, wb)
        torch.cuda.synchronize()
        err = bf16_ulp_gate(tag, y, ref, spread)
        check(torch.equal(y, again), f"{tag}: a second forward gave other bits")
        f64 = f64_gate(tag, y, ref, exact, "bf16 plain twin")
        del ref, exact, spread
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain, iters=5)
    flops = 2.0 * n * 2 * grid_size * nin * nout
    nbytes = 2.0 * (n * nin + 2 * grid_size * nin * nout + n * nout)  # x, W read, y written
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_fourier_bwd_bf16(torch, rng, label, n, nin, nout, need_dx=True, grid_size=28):
    """The bf16 ``fourierkan`` backward (asked for dx only where
    ``need_dx``, as the training step asks its embedder) against its plain
    twin on the card: dx within one bf16 ulp, dW within one bf16 ulp plus
    2^-8 |B|^T |gy|; each no further than twice the twin from the f64 sums of
    the same operands; the bits of a second call, and the no-dx dW the
    all-gradients route's bits. Times beside the f32 kernels' on the same
    (upcast) operands and the twin's, and the bf16 bound."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    bf16 = torch.bfloat16
    x, wb = fourier_bf16_case(torch, rng, n, nin, nout, grid_size)
    gy = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).cuda().to(bf16)
    x32, w32, gy32 = x.float(), wb.float(), gy.float()
    tag = f"fourierkan bwd bf16 {label} N={n} G={grid_size} {nin}->{nout}"

    def kernel(dx=need_dx):
        return FB._launch_bwd_bf16("fourierkan", x, wb, grid_size, gy, dx, True)

    def f32_kernel():
        return FB._launch_bwd("fourierkan_bwd", "fourier", x32, w32, grid_size, gy32,
                              need_dx, True)

    def plain(exact=False):
        return K.fourier_grouped_backward_bf16(x, wb, gy, need_dx, True, exact=exact)

    with torch.inference_mode():
        got, again, every = kernel(), kernel(), kernel(True)
        twin, exact = plain(), plain(exact=True)
        spread = K.fourier_dw_spread_bf16(x, wb, gy)
        torch.cuda.synchronize()
        check(got[1].dtype == bf16 and (got[0] is None) != need_dx, f"{tag}: outputs")
        err, f64 = 0.0, 0.0
        for i, what in enumerate(("dx", "dW")):
            if got[i] is None:
                continue
            err = max(err, bf16_ulp_gate(f"{tag} {what}", got[i], twin[i],
                                         spread if what == "dW" else None))
            f64 = max(f64, f64_gate(f"{tag} {what}", got[i], twin[i], exact[i],
                                    "bf16 plain twin"))
            check(torch.equal(got[i], again[i]), f"{tag}: a second backward gave other "
                                                 f"{what} bits")
        check(torch.equal(got[1], every[1]), f"{tag}: the no-dx dW differs from the "
                                             "all-gradients route's")
        del twin, exact, spread
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, 10, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, 10, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, plain, iters=5)
    # dW, and gW for dx where asked; x and gy read, dW written, and W read
    # and dx written where dx is asked
    wsize = 2 * grid_size * nin * nout
    flops = 2.0 * n * wsize * (1 + need_dx)
    nbytes = 2.0 * (n * nin * (1 + need_dx) + n * nout + wsize * (1 + need_dx))
    bounds = bf16_bound(flops, nbytes)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  bound "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']})  (bits repeated)")
    return err, ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                               "f32_device_ms": f32_dev_ms}, bounds


def check_attention_bwd_bf16(torch, rng, b, t, heads, dh, label, cases):
    """The bf16 lanes backward on q, k, v as strided slices of a bf16
    (N, H*3dh) projection output, each case against the plain twin on the
    kernel forward's o: each gradient within one bf16 ulp plus one of each
    rounded intermediate weighted as the next product weighs it (2^-8 of
    ``A.lanes_attention_bwd_bf16(..., spread=True)``), the gradients of a
    query that sees no key and of a masked key exactly 0; the first case
    also against the f64 reference (no further than twice the twin), its
    bits repeated, CUDA-event and device times beside the f32 kernels' on
    the same (upcast) operands, the twin's and the backward of
    ``scaled_dot_product_attention`` in bf16."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    bf16 = torch.bfloat16
    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda().to(bf16)
    do = torch.from_numpy(rng.standard_normal((b, t, heads * dh))
                          .astype(np.float32)).cuda().to(bf16)
    y32 = y.float()

    def views(a):
        a4 = a.view(b, t, heads, 3 * dh)
        return [a4[..., i * dh:(i + 1) * dh] for i in range(3)]

    (q, k, v), (q32, k32, v32) = views(y), views(y32)
    tag = f"flash_attention_lanes bwd bf16 {label} B={b} T={t} H={heads} dh={dh}"
    errs = []

    def run(causal, mask, f32=False):
        qq, kk, vv = (q32, k32, v32) if f32 else (q, k, v)
        maskb = None if mask is None else A.key_valid(mask, b, t, mask.device).to(
            torch.uint8).contiguous()
        if f32:
            o, stats = FA._launch(qq, kk, vv, maskb, causal, True)
            return lambda: FA._launch_bwd(qq, kk, vv, maskb, o, stats, do.float(), causal)
        stats = torch.empty(b, heads, t, 2, device="cuda")
        o = FA._launch_bf16(qq, kk, vv, maskb, causal, stats)
        return o, lambda: FA._launch_bwd_bf16(qq, kk, vv, maskb, o, stats, do, causal)

    with torch.inference_mode():
        for causal, mask in cases:
            o, kernel = run(causal, mask)
            got = [g.reshape(b, t, heads * dh) for g in kernel()]
            want = A.lanes_attention_bwd_bf16(q, k, v, o, do, heads, causal, mask)
            spread = A.lanes_attention_bwd_bf16(q, k, v, o, do, heads, causal, mask,
                                                spread=True)
            torch.cuda.synchronize()
            case = f"causal={causal} mask={'none' if mask is None else 'yes'}"
            for nm, g, w, sp in zip(("dq", "dk", "dv"), got, want, spread):
                check(g.dtype == bf16, f"{tag}: {nm} {g.dtype}")
                errs.append(bf16_ulp_gate(f"{tag} {case} {nm}", g, w, sp))
            if mask is not None:
                keys = A.key_valid(mask, b, t, mask.device)
                dead = ~keys.any(dim=1)
                check(bool((got[0][dead] == 0).all()) and bool((got[1][~keys] == 0).all())
                      and bool((got[2][~keys] == 0).all()),
                      "a query that sees no key and a masked key must get gradients of 0")
        causal, mask = cases[0]
        o, kernel = run(causal, mask)
        got = [g.reshape(b, t, heads * dh) for g in kernel()]
        again = [g.reshape(b, t, heads * dh) for g in kernel()]
        check(all(torch.equal(a1, a2) for a1, a2 in zip(got, again)),
              f"{tag}: the bits of a repeated backward differ")
        want = A.lanes_attention_bwd_bf16(q, k, v, o, do, heads, causal, mask)
        exact = A.lanes_attention_bwd_bf16(q, k, v, o, do, heads, causal, mask, exact=True)
        f64 = max(f64_gate(f"{tag} {nm}", g, w, e, "bf16 plain twin")
                  for nm, g, w, e in zip(("dq", "dk", "dv"), got, want, exact))
        f32_kernel = run(causal, mask, f32=True)
        ms, dev_ms = time_ms(torch, kernel), kernel_ms(torch, kernel, label=tag)
        f32_ms = time_ms(torch, f32_kernel)
        f32_dev_ms = kernel_ms(torch, f32_kernel, label=f"{tag}, the f32 kernels")
        plain_ms = time_ms(torch, lambda: A.lanes_attention_bwd_bf16(
            q, k, v, o, do, heads, causal, mask))
    lviews = [a.transpose(1, 2) for a in (q, k, v)]
    lib_ms = sdpa_ms(torch, *lviews, causal, mask, backward="qkv")
    lib_dev_ms = sdpa_ms(torch, *lviews, causal, mask, backward="qkv", device=True)
    pairs = t * (t + 1) / 2 if causal else t * t
    bounds = bf16_bound(2.0 * b * heads * pairs * dh * 5, 2.0 * 8 * b * t * heads * dh,
                        lib_ms)
    print(f"[bf16] {tag}: kernels {ms:.4f} ms (device {dev_ms:.4f})  the f32 kernels "
          f"{f32_ms:.4f} (device {f32_dev_ms:.4f})  plain twin {plain_ms:.4f}  "
          f"scaled_dot_product_attention bf16 backward {lib_ms:.4f} (device "
          f"{lib_dev_ms:.4f})  bound {bounds['bound_ms']:.4f} ({bounds['bound_by']})")
    return max(errs), ms, plain_ms, {"f64_err": f64, "device_ms": dev_ms, "f32_ms": f32_ms,
                                     "f32_device_ms": f32_dev_ms,
                                     "library_device_ms": lib_dev_ms}, bounds


def phase_bf16_kernels(torch):
    """The ten bf16 kernels of the bf16 serving and training paths at their
    vit-s shapes, then at ragged narrow shapes (sub-entries): the
    efficientkan ViT's six, then the Chebyshev embedder's and q/k/v's
    forwards and backwards."""
    rng = np.random.default_rng(SEED + 11)
    results = {
        "bspline_kan_bf16": check_bspline_bf16(
            torch, rng, "bspline_kan", "vit-s embedder", BATCH * 196, None, 768, 384),
        "bspline_qkv_grouped_bf16": check_bspline_bf16(
            torch, rng, "bspline_qkv_grouped", "vit-s q/k/v", BATCH * 197, 6, 64, 192),
        "flash_attention_lanes_bf16": check_attention_bf16(
            torch, rng, BATCH, 197, 6, 64, "vit-s", [(False, None)]),
    }
    results["bspline_kan_bf16"] += (
        {"mnist_ragged": sub_entry(check_bspline_bf16(
            torch, rng, "bspline_kan", "mnist embedder", 37 * 49, None, 16, 64))},
        {"batch_1": sub_entry(check_bspline_bf16(
            torch, rng, "bspline_kan", "vit-s embedder, one image", 196, None, 768, 384))})
    results["bspline_qkv_grouped_bf16"] += (
        {"mnist_ragged": sub_entry(check_bspline_bf16(
            torch, rng, "bspline_qkv_grouped", "mnist q/k/v", 37 * 50, 2, 32, 96))},
        {"refit_grids_per_head": sub_entry(check_bspline_bf16(
            torch, rng, "bspline_qkv_grouped", "vit-s refit grids a head", BATCH * 197, 6,
            64, 64, per_head=True))},
        {"at_dh_8_mnist": sub_entry(check_bspline_bf16(
            torch, rng, "bspline_qkv_grouped", "dh-8 q/k/v", BATCH * 50, 8, 8, 24))})
    for key, b, t, heads, dh in (("mnist_ragged", 37, 50, 2, 32),
                                 ("at_dh_8_mnist", BATCH, 50, 8, 8),
                                 ("at_dh_16", 16, 197, 4, 16)):
        results["flash_attention_lanes_bf16"] += ({key: sub_entry(check_attention_bf16(
            torch, rng, b, t, heads, dh, key, attention_cases(torch, rng, b, t)))},)
    # the backwards: the training step's shapes first (the embedder asked
    # for no dx), then all gradients, the MNIST shapes and the other routes
    results["bspline_kan_bwd_bf16"] = check_bspline_bwd_bf16(
        torch, rng, "bspline_kan", "vit-s embedder, no dx", BATCH * 196, None, 768, 384,
        need_dx=False) + (
        {"all_gradients": sub_entry(check_bspline_bwd_bf16(
            torch, rng, "bspline_kan", "vit-s embedder", BATCH * 196, None, 768, 384))},
        {"mnist_ragged": sub_entry(check_bspline_bwd_bf16(
            torch, rng, "bspline_kan", "mnist embedder", 37 * 49, None, 16, 64))})
    results["bspline_qkv_grouped_bwd_bf16"] = check_bspline_bwd_bf16(
        torch, rng, "bspline_qkv_grouped", "vit-s q/k/v", BATCH * 197, 6, 64, 192) + (
        {"mnist_ragged": sub_entry(check_bspline_bwd_bf16(
            torch, rng, "bspline_qkv_grouped", "mnist q/k/v", 37 * 50, 2, 32, 96))},
        {"refit_grids_per_head": sub_entry(check_bspline_bwd_bf16(
            torch, rng, "bspline_qkv_grouped", "vit-s refit grids a head", BATCH * 197, 6,
            64, 64, per_head=True))},
        {"at_dh_8_mnist": sub_entry(check_bspline_bwd_bf16(
            torch, rng, "bspline_qkv_grouped", "dh-8 q/k/v", BATCH * 50, 8, 8, 24))})
    results["flash_attention_lanes_bwd_bf16"] = check_attention_bwd_bf16(
        torch, rng, BATCH, 197, 6, 64, "vit-s", [(False, None)])
    for key, b, t, heads, dh in (("mnist_ragged", 37, 50, 2, 32),
                                 ("at_dh_8_mnist", BATCH, 50, 8, 8),
                                 ("at_dh_16", 16, 197, 4, 16)):
        results["flash_attention_lanes_bwd_bf16"] += ({key: sub_entry(
            check_attention_bwd_bf16(torch, rng, b, t, heads, dh, key,
                                     attention_cases(torch, rng, b, t)))},)
    for name, subs in lanes_bf16_generic(torch).items():
        results[name] += tuple({key: entry} for key, entry in subs.items())
    results.update(cheby_bf16_kernels(torch))
    results.update(fast_bf16_kernels(torch))
    results.update(sine_bf16_kernels(torch))
    results.update(fourier_bf16_kernels(torch))
    return results


def lanes_bf16_generic(torch):
    """The bf16 lanes kernels at head dims outside 8/16/32/64, on the
    instantiation padded to 128: vit-s's width and tokens (B 64, T 197, d
    384) in 4 heads of 96 and 3 of 128, forward and backward, then the
    single-tile route at dh 40. Returns ``{kernel: {sub-entry: result}}``."""
    rng = np.random.default_rng(SEED + 15)
    fwd, bwd = {}, {}
    for heads, dh in ((4, 96), (3, 128)):
        key = f"vit_s_width_dh_{dh}"
        cases = [(False, None), (True, masked_items(torch, rng, BATCH, 197))]
        fwd[key] = sub_entry(check_attention_bf16(torch, rng, BATCH, 197, heads, dh, key,
                                                  cases))
        bwd[key] = sub_entry(check_attention_bwd_bf16(torch, rng, BATCH, 197, heads, dh,
                                                      key, cases))
    one, two = check_single_tile_bf16(torch, rng)
    fwd["single_tile_route_dh_40"], bwd["single_tile_route_dh_40"] = one, two
    return {"flash_attention_lanes_bf16": fwd, "flash_attention_lanes_bwd_bf16": bwd}


def check_single_tile_bf16(torch, rng, b=16, h=4, t=256, dh=40):
    """``flash_attention`` on bf16 where kanvit's ``_use_small`` holds: the
    bf16 lanes kernels on (B, T, H, dh) views, through autograd, causal with
    a key mask, against the twins (``A.lanes_attention``, and
    ``A.lanes_attention_bwd_bf16`` on the kernel's o) within the bf16 gates;
    one bf16 lanes forward and backward launch and no tiled one. Returns
    the forward's and the backward's sub-entries."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    check(FA.use_small(t, t, dh, h, 512, 1024, 2), "bf16 single tile: not the small tier")
    q, k, v = (a.to(torch.bfloat16) for a in flash_inputs(torch, rng, b, h, t, t, dh))
    mask = masked_items(torch, rng, b, t)
    g = torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    tag = f"bf16 single-tile route B={b} H={h} T={t} dh={dh} causal masked"

    def lanes(a):
        return a.transpose(1, 2)

    def run():
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        o = FA.flash_attention(*leaves, True, 512, 1024, mask)
        o.backward(g)
        return o.detach(), [a.grad for a in leaves]

    reset_counts()
    o, grads = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["flash_attention_lanes_bf16"] == 1
          and counts["flash_attention_lanes_bwd_bf16"] == 1
          and counts["flash_attention_bf16"] == counts["flash_attention_lanes"] == 0,
          f"{tag}: launches {counts}, want one bf16 lanes forward and backward")
    again, again_grads = run()
    check(torch.equal(o, again) and all(torch.equal(x, y) for x, y in zip(grads, again_grads)),
          f"{tag}: the bits of a repeated forward or backward differ")
    o3 = lanes(o).reshape(b, t, h * dh)
    with torch.inference_mode():
        ref = A.lanes_attention(*map(lanes, (q, k, v)), h, causal=True, mask=mask)
        spread = A.lanes_attention(lanes(q), lanes(k), lanes(v).abs(), h, causal=True,
                                   mask=mask)
        err = bf16_ulp_gate(f"flash_attention {tag}", o3, ref, spread)
        args = (*map(lanes, (q, k, v)), o3, lanes(g), h, True, mask)
        want = A.lanes_attention_bwd_bf16(*args)
        spreads = A.lanes_attention_bwd_bf16(*args, spread=True)
        err_bwd = max(bf16_ulp_gate(f"flash_attention {tag} {nm}",
                                    lanes(a).reshape(b, t, h * dh), w, sp)
                      for nm, a, w, sp in zip(("dq", "dk", "dv"), grads, want, spreads))
        dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
        check(bool((o3[dead] == 0).all()), f"{tag}: a fully masked row must output 0")

        def forward():
            return FA.flash_attention(q, k, v, True, 512, 1024, mask)
        ms = {"fwd": time_ms(torch, forward),
              "fwd device": kernel_ms(torch, forward, label=f"{tag} fwd"),
              "plain fwd": time_ms(torch, lambda: A.lanes_attention(
                  *map(lanes, (q, k, v)), h, causal=True, mask=mask))}
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*leaves, True, 512, 1024, mask)

    def backward():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)
    ms["bwd"] = time_ms(torch, backward)
    ms["bwd device"] = kernel_ms(torch, backward, label=f"{tag} bwd")
    ms["plain bwd"] = time_ms(torch, lambda: A.lanes_attention_bwd_bf16(*args))
    for part, grad_of in (("fwd", None), ("bwd", "qkv")):
        ms[f"sdpa {part}"] = sdpa_ms(torch, q, k, v, True, mask, backward=grad_of)
        ms[f"sdpa {part} device"] = sdpa_ms(torch, q, k, v, True, mask, backward=grad_of,
                                            device=True)
    print(f"[bf16] {tag}: " + "  ".join(f"{key} {val:.4f} ms" for key, val in ms.items()))
    pairs = t * (t + 1) / 2
    bounds = {"fwd": bf16_bound(2.0 * b * h * pairs * dh * 2, 2.0 * 4 * b * t * h * dh,
                                ms["sdpa fwd"]),
              "bwd": bf16_bound(2.0 * b * h * pairs * dh * 5, 2.0 * 8 * b * t * h * dh,
                                ms["sdpa bwd"])}
    return tuple(sub_entry((e, ms[part], ms[f"plain {part}"],
                            {"device_ms": ms[f"{part} device"],
                             "library_device_ms": ms[f"sdpa {part} device"]},
                            bounds[part]))
                 for e, part in ((err, "fwd"), (err_bwd, "bwd")))


def cheby_bf16_kernels(torch):
    """The cheby ViT's four bf16 kernels: the embedder (``chebykan``) and
    the grouped q/k/v (``cheby_qkv_grouped``), forward and backward, at the
    vit-s shapes (the embedder's backward first without dx, as the training
    step asks it), then at one vit-s image, the MNIST shapes and dh 8
    (sub-entries)."""
    rng = np.random.default_rng(SEED + 13)
    emb, qkv = "chebykan", "cheby_qkv_grouped"
    return {
        "chebykan_bf16": check_cheby_bf16(
            torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384) + (
            {"batch_1": sub_entry(check_cheby_bf16(
                torch, rng, emb, "vit-s embedder, one image", 196, None, 768, 384))},
            {"mnist_ragged": sub_entry(check_cheby_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "cheby_qkv_grouped_bf16": check_cheby_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 192) + (
            {"mnist_ragged": sub_entry(check_cheby_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 96))},
            {"at_dh_8_mnist": sub_entry(check_cheby_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 24))}),
        "chebykan_bwd_bf16": check_cheby_bwd_bf16(
            torch, rng, emb, "vit-s embedder, no dx", BATCH * 196, None, 768, 384,
            need_dx=False) + (
            {"all_gradients": sub_entry(check_cheby_bwd_bf16(
                torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384))},
            {"batch_1": sub_entry(check_cheby_bwd_bf16(
                torch, rng, emb, "vit-s embedder, one image, no dx", 196, None, 768, 384,
                need_dx=False))},
            {"mnist_ragged": sub_entry(check_cheby_bwd_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "cheby_qkv_grouped_bwd_bf16": check_cheby_bwd_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 192) + (
            {"mnist_ragged": sub_entry(check_cheby_bwd_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 96))},
            {"at_dh_8_mnist": sub_entry(check_cheby_bwd_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 24))}),
    }


def fast_bf16_kernels(torch):
    """The fast ViT's four bf16 kernels: the embedder (``fastkan``) and one
    grouped q/k/v projection (``fastkan_qkv_grouped``), forward and backward,
    at the vit-s shapes (the embedder's backward first without dx, as the
    training step asks it), then the forward with a third of x at |x| 20-60,
    one vit-s image, the MNIST shapes and dh 8 (sub-entries)."""
    rng = np.random.default_rng(SEED + 15)
    emb, qkv = "fastkan", "fastkan_qkv_grouped"
    return {
        "fastkan_bf16": check_fastkan_bf16(
            torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384) + (
            {"large_silu": sub_entry(check_fastkan_bf16(
                torch, rng, emb, "vit-s embedder, a third of x at |x| 20-60", BATCH * 196,
                None, 768, 384, large=True))},
            {"batch_1": sub_entry(check_fastkan_bf16(
                torch, rng, emb, "vit-s embedder, one image", 196, None, 768, 384))},
            {"mnist_ragged": sub_entry(check_fastkan_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "fastkan_qkv_grouped_bf16": check_fastkan_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 64) + (
            {"large_silu": sub_entry(check_fastkan_bf16(
                torch, rng, qkv, "vit-s q/k/v, a third of x at |x| 20-60", BATCH * 197, 6,
                64, 64, large=True))},
            {"mnist_ragged": sub_entry(check_fastkan_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 32))},
            {"at_dh_8_mnist": sub_entry(check_fastkan_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 8))}),
        "fastkan_bwd_bf16": check_fastkan_bwd_bf16(
            torch, rng, emb, "vit-s embedder, no dx", BATCH * 196, None, 768, 384,
            need_dx=False) + (
            {"all_gradients": sub_entry(check_fastkan_bwd_bf16(
                torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384))},
            {"batch_1": sub_entry(check_fastkan_bwd_bf16(
                torch, rng, emb, "vit-s embedder, one image, no dx", 196, None, 768, 384,
                need_dx=False))},
            {"mnist_ragged": sub_entry(check_fastkan_bwd_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "fastkan_qkv_grouped_bwd_bf16": check_fastkan_bwd_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 64) + (
            {"mnist_ragged": sub_entry(check_fastkan_bwd_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 32))},
            {"at_dh_8_mnist": sub_entry(check_fastkan_bwd_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 8))}),
    }


def sine_bf16_kernels(torch):
    """The sine ViT's four bf16 kernels: the embedder (``sinekan``, grid 28)
    and one grouped q/k/v projection (``sinekan_qkv_grouped``, grid 4),
    forward and backward, at the vit-s shapes (the embedder's backward first
    without dx, as the training step asks it), then the embedder's forward
    with a third of x at |x| 20-60, one vit-s image, the MNIST shapes and
    dh 8 (sub-entries)."""
    rng = np.random.default_rng(SEED + 17)
    emb, qkv = "sinekan", "sinekan_qkv_grouped"
    return {
        "sinekan_bf16": check_sine_bf16(
            torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384) + (
            {"large_x": sub_entry(check_sine_bf16(
                torch, rng, emb, "vit-s embedder, a third of x at |x| 20-60", BATCH * 196,
                None, 768, 384, large=True))},
            {"batch_1": sub_entry(check_sine_bf16(
                torch, rng, emb, "vit-s embedder, one image", 196, None, 768, 384))},
            {"mnist_ragged": sub_entry(check_sine_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "sinekan_qkv_grouped_bf16": check_sine_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 64) + (
            {"mnist_ragged": sub_entry(check_sine_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 32))},
            {"at_dh_8_mnist": sub_entry(check_sine_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 8))}),
        "sinekan_bwd_bf16": check_sine_bwd_bf16(
            torch, rng, emb, "vit-s embedder, no dx", BATCH * 196, None, 768, 384,
            need_dx=False) + (
            {"all_gradients": sub_entry(check_sine_bwd_bf16(
                torch, rng, emb, "vit-s embedder", BATCH * 196, None, 768, 384))},
            {"batch_1": sub_entry(check_sine_bwd_bf16(
                torch, rng, emb, "vit-s embedder, one image, no dx", 196, None, 768, 384,
                need_dx=False))},
            {"mnist_ragged": sub_entry(check_sine_bwd_bf16(
                torch, rng, emb, "mnist embedder", 37 * 49, None, 16, 64))}),
        "sinekan_qkv_grouped_bwd_bf16": check_sine_bwd_bf16(
            torch, rng, qkv, "vit-s q/k/v", BATCH * 197, 6, 64, 64) + (
            {"mnist_ragged": sub_entry(check_sine_bwd_bf16(
                torch, rng, qkv, "mnist q/k/v", 37 * 50, 2, 32, 32))},
            {"at_dh_8_mnist": sub_entry(check_sine_bwd_bf16(
                torch, rng, qkv, "dh-8 q/k/v", BATCH * 50, 8, 8, 8))}),
    }


def fourier_bf16_kernels(torch):
    """The fourier ViT's two bf16 KAN kernels: the embedder (``fourierkan``,
    grid 28, its 56 slices in 14 chunks of 2 harmonics), forward and
    backward, at the vit-s shape (the backward first without dx, as the
    training step asks it), then at one vit-s image, the MNIST embedder and
    grid 5 (an odd grid: a last chunk of one harmonic; sub-entries). Its
    q/k/v are Linear and its attention the lanes tier, in phase 9b."""
    rng = np.random.default_rng(SEED + 19)
    vit_s, image, mnist = (BATCH * 196, 768, 384), (196, 768, 384), (37 * 49, 16, 64)
    return {
        "fourierkan_bf16": check_fourier_bf16(torch, rng, "vit-s embedder", *vit_s) + (
            {"batch_1": sub_entry(check_fourier_bf16(
                torch, rng, "vit-s embedder, one image", *image))},
            {"mnist_ragged": sub_entry(check_fourier_bf16(
                torch, rng, "mnist embedder", *mnist))},
            {"grid_5": sub_entry(check_fourier_bf16(
                torch, rng, "mnist embedder, grid 5", *mnist, grid_size=5))}),
        "fourierkan_bwd_bf16": check_fourier_bwd_bf16(
            torch, rng, "vit-s embedder, no dx", *vit_s, need_dx=False) + (
            {"all_gradients": sub_entry(check_fourier_bwd_bf16(
                torch, rng, "vit-s embedder", *vit_s))},
            {"batch_1": sub_entry(check_fourier_bwd_bf16(
                torch, rng, "vit-s embedder, one image, no dx", *image, need_dx=False))},
            {"mnist_ragged": sub_entry(check_fourier_bwd_bf16(
                torch, rng, "mnist embedder", *mnist))},
            {"grid_5": sub_entry(check_fourier_bwd_bf16(
                torch, rng, "mnist embedder, grid 5", *mnist, grid_size=5))}),
    }


BF16_PER_BATCH = {"bspline_kan_bf16": 1, "bspline_qkv_grouped_bf16": 12,
                  "flash_attention_lanes_bf16": 12}
CHEBY_BF16_PER_BATCH = {"chebykan_bf16": 1, "cheby_qkv_grouped_bf16": 12,
                        "flash_attention_lanes_bf16": 12}
# one grouped launch per q, k and v projection
FAST_BF16_PER_BATCH = {"fastkan_bf16": 1, "fastkan_qkv_grouped_bf16": 36,
                       "flash_attention_lanes_bf16": 12}
SINE_BF16_PER_BATCH = {"sinekan_bf16": 1, "sinekan_qkv_grouped_bf16": 36,
                       "flash_attention_lanes_bf16": 12}
# the fourier ViT's q/k/v are Linear (cuBLAS)
FOURIER_BF16_PER_BATCH = {"fourierkan_bf16": 1, "flash_attention_lanes_bf16": 12}
# the efficientkan ViT with the fused FF
FFN_BF16_PER_BATCH = {**BF16_PER_BATCH, "ffn_pre_ln_bf16": 12}
# The variants served and trained in bf16 after their f32 phases.
BF16_VARIANTS = {"cheby": CHEBY_BF16_PER_BATCH, "fourier": FOURIER_BF16_PER_BATCH,
                 "fast": FAST_BF16_PER_BATCH, "sine": SINE_BF16_PER_BATCH}


def phase_bf16_serve(torch, smi, model_cpu, seed, variant="efficientkan",
                     per_batch=BF16_PER_BATCH):
    """Serve the vit-s ``variant`` (efficientkan, cheby) in bf16 (the f32
    phase's weights): ``Predictor`` on a bf16 copy for three requests and
    ``make_eval_step(bf16=True)`` on the f32 model, each forward exactly
    ``per_batch``'s 1 + 12 + 12 bf16 kernel launches (and a fused-FF
    model's 12 bf16 FF launches) and nothing else (no f32 KAN, attention or
    FF launch); logits finite, within 2e-2 x max(1, max|logits|) of the
    port's CPU bf16 forward (the plain twins), their top-1 agreement with
    the card's f32 logits; the device forward (CUDA events, in turns f32,
    bf16, bf16, f32), its device busy time by kernel and images/s beside
    f32's; a fused-FF model's also beside the same model with its FF
    unfused (cuBLAS bf16), in turns f32, bf16, unfused, unfused, bf16,
    f32."""
    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_eval_step
    from kanvit_torch.utils import precision

    geom = PRESETS["vit-s"]
    model32 = copy.deepcopy(model_cpu).to("cuda")
    model_bf = precision.cast_params_(copy.deepcopy(model_cpu)).to("cuda")
    grids = [getattr(model_bf.linear_mapper, g, None) for g in ("grid", "rbf_grid", "phase")]
    check(all(g is None or g.dtype == torch.float32 for g in grids)
          and model_bf.pos_embeddings.dtype == torch.float32,
          "bf16 cast: the knot grid, the RBF centres, the sine phase table and the position "
          "table must stay f32")
    pred = Predictor(model_bf, batch_size=BATCH, device="cuda")
    pred32 = Predictor(model32, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((sum(REQUESTS), *geom["chw"])).astype(np.float32)
    bounds = np.cumsum((0,) + REQUESTS)
    reqs = [images[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

    reset_counts()
    logits = [pred.logits(r) for r in reqs]
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update({k: len(REQUESTS) * n for k, n in per_batch.items()})
    print(f"[bf16] vit-s {variant} bf16 Predictor launches over {len(REQUESTS)} "
          f"batches: { {k: n for k, n in counts.items() if n} }")
    check(counts == want, f"bf16 serving: launch counts {counts} != {want}")
    for r, y in zip(reqs, logits):
        check(y.shape == (len(r), geom["out_d"]) and y.dtype == np.float32,
              f"bf16 serving: logits {y.shape} {y.dtype}")
        check(bool(np.isfinite(y).all()), "bf16 serving: logits are not finite")

    reset_counts()
    x = torch.from_numpy(reqs[0]).cuda()
    labels = torch.from_numpy(rng.integers(0, geom["out_d"], len(reqs[0]))).cuda()
    loss, step_logits = make_eval_step(bf16=True)(create_train_state(model32), x, labels)
    torch.cuda.synchronize()
    step_counts = {k: n for k, n in launch_counts().items() if n}
    check(step_counts == per_batch,
          f"bf16 eval step: launch counts {step_counts} != {per_batch}")
    check(step_logits.dtype == torch.float32 and bool(torch.isfinite(loss)),
          "bf16 eval step: logits f32 and a finite loss")
    check(all(p.dtype == torch.float32 for p in model32.parameters()),
          "bf16 eval step: the model's f32 parameters were changed")
    same = bool(np.array_equal(step_logits.cpu().numpy(), logits[0]))
    step_err = float(np.abs(step_logits.cpu().numpy() - logits[0]).max())

    model_bf_cpu = precision.cast_params_(copy.deepcopy(model_cpu))
    with torch.inference_mode():
        ref = model_bf_cpu(torch.from_numpy(reqs[0][:2]).to(torch.bfloat16)).float().numpy()
    err = float(np.abs(logits[0][:2] - ref).max())
    limit = TOL_BF16_LOGITS * max(1.0, float(np.abs(ref).max()))
    print(f"[bf16] logits of 2 images, card against the CPU's bf16 forward: max|err| "
          f"{err:.3e}  limit {limit:.3e}; the eval step's logits against the "
          f"Predictor's: {step_err:.3e} (bits equal {same})")
    check(err <= limit, f"bf16 serving: card logits differ from the CPU's by {err}")
    check(step_err <= limit, f"bf16 eval step: logits differ from the Predictor's by "
                             f"{step_err}")

    f32_logits = np.concatenate([pred32.logits(r) for r in reqs])
    bf_logits = np.concatenate(logits)
    top1 = float((f32_logits.argmax(-1) == bf_logits.argmax(-1)).mean())
    diff = float(np.abs(f32_logits - bf_logits).max())
    print(f"[bf16] top-1 agreement with the card's f32 logits over {len(images)} "
          f"images: {top1:.4f}; max|bf16 - f32| {diff:.3e}")

    batch = reqs[0]
    xb = torch.from_numpy(batch).cuda().to(torch.bfloat16)
    x32 = torch.from_numpy(batch).cuda()
    models = {"f32": (model32, x32), "bf16": (model_bf, xb)}
    preds = {"f32": pred32, "bf16": pred}
    turns = ("f32", "bf16", "bf16", "f32")
    if is_fused(model_cpu):
        model_un = unfused(copy.deepcopy(model_bf))
        models["bf16_unfused"] = (model_un, xb)
        preds["bf16_unfused"] = Predictor(model_un, batch_size=BATCH, device="cuda")
        turns = ("f32", "bf16", "bf16_unfused", "bf16_unfused", "bf16", "f32")
    with torch.inference_mode(), precision.f32_accumulation():
        fwd = {k: [] for k in models}
        for kind in turns:
            net, inp = models[kind]
            fwd[kind].append(time_ms(torch, lambda: net(inp), iters=10))
        busy = {k: kernel_ms(torch, lambda: net(inp), 5, label=f"vit-s {variant} {k} forward")
                for k, (net, inp) in models.items()}
    ips = {k: serve_rate(torch, p, batch) for k, p in preds.items()}
    fwd_ms = {k: sum(v) / len(v) for k, v in fwd.items()}
    print(f"[bf16] vit-s {variant}, batch {BATCH}: device forward " + "; ".join(
        f"{k} {fwd_ms[k]:.3f} ms ({fwd[k]}), busy {busy[k]:.3f} ms, Predictor.logits "
        f"{ips[k]:.1f} images/s (host to host)" for k in models) + f"  [{smi}]")
    return {"launches": counts, "logits_err": err, "top1_vs_f32": top1,
            "device_forward_ms": fwd_ms, "device_busy_ms": busy, "images_per_s": ips}


# The bf16 training phases of the variants trained in bf16 before the sine
# ViT run at a smaller depth, the first blocks of the f32 phases' weights, so
# that the whole run stays within the 664.9 s it took before the sine
# phases were added; ``python -m kanvit_torch.probe_bf16 --model-type
# <variant> --train`` runs any of them at full depth.
BF16_TRAIN_DEPTH = {"efficientkan": 6, "cheby": 6, "fast": 4, "sine": 6, "fourier": 6}


def at_depth(model_cpu, per_batch, variant):
    """``(model, label, per_batch)`` of ``variant``'s bf16 training phase,
    in ``phase_bf16_train``'s order: the first ``BF16_TRAIN_DEPTH[variant]``
    blocks of ``model_cpu`` (all of them where it names none), the phase's
    label, and its launches a step scaled to those blocks (the embedder's
    one stays)."""
    full = len(model_cpu.blocks)
    blocks = BF16_TRAIN_DEPTH.get(variant, full)
    if blocks == full:
        return model_cpu, variant, per_batch
    model = copy.deepcopy(model_cpu)
    model.blocks = model.blocks[:blocks]
    return (model, f"{variant} at {blocks} of {full} blocks",
            {k: n if n == 1 else n * blocks // full for k, n in per_batch.items()})


def per_step(per_batch):
    """A bf16 training step's launches: each forward's and as many of its
    backward's."""
    return {**per_batch, **{f"{k[:-5]}_bwd_bf16": n for k, n in per_batch.items()}}


BF16_TRAIN_STEPS = 10
# A fused-FF model's bf16 gradients are held on the card's ReLU pattern.
# The CPU's bf16 forward differs from the card's by bf16 rounding
# compounded over the blocks, so pre-activations within that of 0 fall on
# the other side of the ReLU on one of them, and each such flip moves its
# hidden unit's dW1 and db1 by a whole row's term (the phase prints how many
# tensors lie past the gate with the CPU's own pattern). So the CPU's twins
# take each block's pattern from the card's forward (``relu_mask``), after
# bounding the flips: at most MODEL_FLIP_SHARE_BF16 of the ReLU inputs,
# each within MODEL_FLIP_TOL_BF16 of its row's max|h| (16 bf16 ulps of the
# row's largest).
MODEL_FLIP_SHARE_BF16 = 2.0 ** -7
MODEL_FLIP_TOL_BF16 = 2.0 ** -4
# On that pattern every tensor is held within 5e-2 of its own max|g| of the
# twins', but for the attention's q and k projections (QK_TENSOR): in the
# late blocks bf16 rounding of p and dsc alone moves them further, the
# twins too from the f64 step. A q/k tensor may instead lie, in RMS, no
# further from the f64 step than F64_RATIO_BF16 x the twins'. The twins
# share the CPU's exp and sums with the f64 step and the card does not, so
# in a few such tensors the card lies further: over the 752 tensors the
# card's RMS distance over the twins' had a median of 0.95 and a largest of
# 2.73 (PERF.md). The phase reads planted faults against the gate.
F64_RATIO_BF16 = 3.0
QK_TENSOR = re.compile(r"\.attn\.[qk]_mappings\.")
# The card's bf16 step against the CPU's (the plain twins) on the same
# weights, x max(1, max|g|) per tensor: kanvit's own bf16 gradient gate
# (tests/test_kernels.py:966-967).
TOL_BF16_GRADS = 5e-2


def own_max_errs(got, want):
    """max|got - want| over want's max|g|, per tensor."""
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items()}


def qk_fallback_errs(got, twin, exact):
    """``own_max_errs(got, twin)``, a q/k tensor's (QK_TENSOR) the smaller of
    that and TOL_BF16_GRADS x its RMS distance from ``exact`` over
    F64_RATIO_BF16 x the twin's; and each tensor's RMS ratio."""
    errs, ratios = own_max_errs(got, twin), {}
    for name, want in twin.items():
        ratios[name] = float((got[name] - exact[name]).norm()) / max(
            float((want - exact[name]).norm()), 1e-30)
        if QK_TENSOR.search(name):
            errs[name] = min(errs[name], TOL_BF16_GRADS * ratios[name] / F64_RATIO_BF16)
    return errs, ratios


def fused_ff_grad_gate(torch, grads):
    """A fused-FF model's bf16 gradient gate: ``grads``' "cuda" against the
    CPU's twins ("cpu") on the card's ReLU pattern, by ``qk_fallback_errs``
    with the f64 step ("f64"). Prints the tensors by kind, the reading with
    the twins' own pattern ("own") and three faults planted in the card's
    gradients of the middle block: its dW1 zeroed and one hidden unit's dh
    dropped (the gate must fail both), and a q/k tensor scaled by 1.1
    (read). Returns the errors per tensor."""
    card, twin, exact = grads["cuda"], grads["cpu"], grads["f64"]
    rels, ratios = qk_fallback_errs(card, twin, exact)
    strict = own_max_errs(card, twin)
    own = own_max_errs(card, grads["own"])
    ff = [k for k in rels if re.search(r"\.(norm2|ff\.[02])\.", k)]
    qk = [k for k in rels if QK_TENSOR.search(k)]
    rest = [k for k in rels if k not in ff and k not in qk]
    r = list(ratios.values())
    print(f"[bf16-train] each tensor's RMS distance from the f64 step, the card's over the "
          f"CPU twins': median {float(np.median(r)):.3f}, largest {max(r):.3f}, past 2: "
          f"{sum(v > 2 for v in r)} of {len(r)}; q/k past 5e-2 of their own max|g|: "
          f"{sum(strict[k] > TOL_BF16_GRADS for k in qk)} of {len(qk)}, their largest RMS "
          f"ratio {max(ratios[k] for k in qk):.3f} (limit {F64_RATIO_BF16}); worst max|err| / "
          f"max|g|: the FF's {max(strict[k] for k in ff):.3e} "
          f"({max(ff, key=strict.get)}), the rest's {max(strict[k] for k in rest):.3e} "
          f"({max(rest, key=strict.get)}); with the CPU's own ReLU pattern "
          f"{sum(v > TOL_BF16_GRADS for v in own.values())} of {len(own)} past 5e-2, the "
          f"largest {max(own.values()):.3e} ({max(own, key=own.get)})")
    blocks = sorted({int(k.split(".")[1]) for k in ff})
    mid = blocks[len(blocks) // 2]
    w1, b1 = f"blocks.{mid}.ff.0.weight", f"blocks.{mid}.ff.0.bias"
    unit = int(card[w1].abs().amax(1).argsort()[card[w1].shape[0] // 2])
    no_dh = {w1: card[w1].clone(), b1: card[b1].clone()}
    no_dh[w1][unit], no_dh[b1][unit] = 0.0, 0.0
    near = max(qk, key=strict.get)
    faults = {f"block {mid}'s dW1 zeroed": {w1: torch.zeros_like(card[w1])},
              f"block {mid}'s hidden unit {unit} given no dh": no_dh,
              f"{near} x 1.1": {near: 1.1 * card[near]}}
    read = {}
    for label, planted in faults.items():
        errs = qk_fallback_errs({**card, **planted}, twin, exact)[0]
        read[label] = max(errs[k] for k in planted)
    print("[bf16-train] planted faults in the card's gradients, the gate's reading (limit "
          f"{TOL_BF16_GRADS:.0e}): " + "; ".join(f"{k} {v:.3e}" for k, v in read.items()))
    check(all(v > TOL_BF16_GRADS for v in list(read.values())[:2]),
          f"bf16 training: the gradient gate passed a planted FF fault: {read}")
    return rels


def per_parameter_casts(model):
    """The bf16 step's parameter casts as they were before the flat buffer:
    one cast of each f32 parameter forward, so one of each gradient back
    (refit grids rounded): the "before" of the casts' measurements."""
    import torch

    from kanvit_torch.utils import precision

    out = {name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
           for name, p in model.named_parameters()}
    out.update({name: precision._round_bf16(g) for name, g in precision._refit_grids(model)})
    return out


@contextlib.contextmanager
def casts_per_parameter():
    """``precision.bf16_params`` swapped for ``per_parameter_casts`` inside
    the block."""
    from kanvit_torch.utils import precision

    flat = precision.bf16_params
    precision.bf16_params = per_parameter_casts
    try:
        yield
    finally:
        precision.bf16_params = flat


def cast_kernels(torch, model, reps=10):
    """One bf16 step's parameter casts, forward and backward
    (``precision.bf16_params`` as it is bound: the flat buffer's, or
    ``per_parameter_casts`` inside ``casts_per_parameter``): their device
    kernels (the casts under ``torch.profiler``, then a backward from their
    outputs alone with gradients made outside the trace, each trace opened
    by ``first_kernel``), and their host ms, unprofiled: the median over
    ``reps`` of the host clock around the casts, and around that backward,
    each ending in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    from kanvit_torch.utils import precision

    def casts_and_grads():
        casts = precision.bf16_params(model)
        outs = [v for v in casts.values() if v.requires_grad]
        return outs, [torch.ones_like(v) for v in outs]

    precision.bf16_params(model)  # the flat buffer, where made, made here
    counts = []
    for backward in (False, True):
        outs, grads = casts_and_grads()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first_kernel(torch)
            if backward:
                torch.autograd.backward(outs, grads)
            else:
                precision.bf16_params(model)
            torch.cuda.synchronize()
        counts.append(device_kernel_count(prof))
        for p in model.parameters():
            p.grad = None
    host = {"forward": [], "backward": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        precision.bf16_params(model)
        torch.cuda.synchronize()
        host["forward"].append((time.perf_counter() - t0) * 1e3)
        outs, grads = casts_and_grads()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.backward(outs, grads)
        torch.cuda.synchronize()
        host["backward"].append((time.perf_counter() - t0) * 1e3)
        for p in model.parameters():
            p.grad = None
    return {"forward": counts[0], "backward": counts[1],
            "host_forward_ms": float(np.median(host["forward"])),
            "host_backward_ms": float(np.median(host["backward"]))}


def host_split(torch, step, state, x, y, steps=3):
    """The host's ms a bf16 step by ``torch.profiler``'s host ranges (CPU
    activity only, over ``steps`` steps; the profiler's own cost a range and
    an operation inflates each): the parameter casts forward
    (``precision.bf16_params``) and backward (their autograd nodes,
    ``_Bf16CastBackward`` or the per-parameter ``ToCopyBackward0``, whose
    count also holds the step's few other casts), ``functional_call``'s
    reparametrisation (``torch.func.functional_call`` less the model's
    forward inside it), and the KAN, attention and FF kernel wrappers, forward
    and backward; beside the host clock a step, profiled."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.utils import precision

    model, patched = state.model, []

    def ranged(obj, attr, label):
        fn = getattr(obj, attr)

        def wrapper(*a, **k):
            with record_function(label):
                return fn(*a, **k)

        setattr(obj, attr, wrapper)
        patched.append((obj, attr, fn))

    ranged(precision, "bf16_params", "split: casts forward")
    ranged(torch.func, "functional_call", "split: functional_call")
    ranged(model, "forward", "split: model forward")
    for mod, fwd, bwd in ((FB, "_launch_bf16", "_launch_bwd_bf16"),
                          (FA, "_launch_bf16", "_launch_bwd_bf16"),
                          (FFN, "_launch_bf16", "_launch_bwd_bf16"),
                          (FB, "_launch_rbf", "_launch_rbf_bwd"),
                          (FB, "_launch_sine", "_launch_sine_bwd")):
        ranged(mod, fwd, "split: kernel wrappers forward")
        ranged(mod, bwd, "split: kernel wrappers backward")
    try:
        step(state, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                step(state, x, y)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        for obj, attr, fn in reversed(patched):
            if obj is model:
                del model.forward
            else:
                setattr(obj, attr, fn)
    ms = {}
    for e in prof.key_averages():
        key = e.key
        if "Bf16CastBackward" in key or "ToCopyBackward" in key:
            key = "split: casts backward"
        if key.startswith("split: "):
            ms[key[7:]] = ms.get(key[7:], 0.0) + e.cpu_time_total / steps / 1e3
    out = {"step_ms_profiled": wall, "casts_forward_ms": ms.get("casts forward", 0.0),
           "casts_backward_ms": ms.get("casts backward", 0.0),
           "reparametrisation_ms": ms.get("functional_call", 0.0) - ms.get("model forward", 0.0),
           "wrappers_forward_ms": ms.get("kernel wrappers forward", 0.0),
           "wrappers_backward_ms": ms.get("kernel wrappers backward", 0.0)}
    return out


@contextlib.contextmanager
def recorded_ffn_patterns(torch, patterns):
    """The card's bf16 FF forwards inside the block write their ReLU
    pattern (``relu_mask``): each is appended to ``patterns`` (bool, on the
    CPU), in launch order."""
    from kanvit_torch.kernels import fused_ffn as FFN

    launch = FFN._launch_bf16

    def recording(*args):
        mask = torch.empty(args[0].shape[0], args[3].shape[0], dtype=torch.uint8,
                           device=args[0].device)
        y = launch(*args, relu_mask=mask)
        patterns.append(mask.bool().cpu())
        return y

    FFN._launch_bf16 = recording
    try:
        yield
    finally:
        FFN._launch_bf16 = launch


@contextlib.contextmanager
def imposed_ffn_patterns(patterns, flips, exact=False):
    """The CPU's FF inside the block on ``patterns``, one a forward in order:
    the bf16 twins (their backwards take the patterns in reverse, as
    autograd runs them), or with ``exact`` the plain version (the f32 or
    f64 step, autograd through it); each forward's flips against its own
    h > 0 appended to ``flips`` as (flipped, total, the largest flipped |h|
    over its row's max|h|)."""
    import torch

    from kanvit_torch.ops import kan_bases as K

    forward, backward, plain = K.ffn_pre_ln_bf16, K.ffn_pre_ln_bwd_bf16, K.ffn_pre_ln
    queue, stack = list(patterns), []

    def take(h):
        pattern = queue.pop(0).reshape(h.shape)
        flipped = pattern != (h > 0)
        share = h.abs() / h.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        flips.append((int(flipped.sum()), flipped.numel(),
                      float(share[flipped].max()) if flipped.any() else 0.0))
        return pattern

    def on_pattern(x2d, gamma, beta, w1, b1, w2, b2):
        _, ln, _ = K._ln_f32(x2d, gamma, beta)
        pattern = take(ln.to(torch.bfloat16).float() @ w1.float().T + b1.float())
        stack.append(pattern)
        return forward(x2d, gamma, beta, w1, b1, w2, b2, pattern=pattern)

    def bwd_on_pattern(*args):
        return backward(*args, pattern=stack.pop())

    def plain_on_pattern(x, gamma, beta, w1, b1, w2, b2):
        h = K.layernorm(x, gamma, beta) @ w1.T + b1
        with torch.no_grad():
            pattern = take(h)
        return x + ((h * pattern) @ w2.T + b2)

    if exact:
        K.ffn_pre_ln = plain_on_pattern
    else:
        K.ffn_pre_ln_bf16, K.ffn_pre_ln_bwd_bf16 = on_pattern, bwd_on_pattern
    try:
        yield
    finally:
        K.ffn_pre_ln_bf16, K.ffn_pre_ln_bwd_bf16, K.ffn_pre_ln = forward, backward, plain


def phase_bf16_train(torch, smi, model_cpu, variant="efficientkan", per_batch=BF16_PER_BATCH,
                     embedder="bspline_kan"):
    """Train the vit-s ``variant`` (efficientkan, cheby) in bf16 (kanvit's
    --bf16 policy, the f32 phase's weights) through
    ``make_train_step(bf16=True)``: exactly ``per_batch``'s 1 + 12 + 12 bf16
    forward and as many bf16 backward launches a step (a fused-FF model's
    12 bf16 FF launches each way too) and no other KAN, attention or FF
    launch, the embedder's backward asked for no dx; loss finite and falling
    over 10 Adam steps at batch 64; the gradients of a 4-image step within
    5e-2 x max(1, max|g|) per tensor of the CPU's bf16 step (the plain
    twins) on the same weights (a fused-FF model: the CPU's FF on the
    card's ReLU pattern, its flips bounded first, each tensor within 5e-2
    of its own max|g|, a q/k tensor or, in RMS, no further from the f64
    step on that pattern than F64_RATIO_BF16 x the twins; planted faults
    read, ``fused_ff_grad_gate``), the f32 parameters and gradients f32;
    the parameter casts' device kernels a step, forward and backward, and
    the host's split of a step (``host_split``), each with the flat buffer
    and with a cast a parameter (``per_parameter_casts``, before it); host
    ms a step and images/s of the f32 step, the bf16 step and the bf16 step
    with a cast a parameter (in turns f32, bf16, per-parameter,
    per-parameter, bf16, f32), CUDA events a step, and the profile's busy
    time, idle share and largest device operations of the bf16 step
    (``phase_profile``); a fused-FF model's bf16 step beside the same
    model with its FF unfused (cuBLAS bf16) in place of the cast a
    parameter."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["vit-s"]
    fused = is_fused(model_cpu)
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal((BATCH, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], BATCH)).cuda()
    state = create_train_state(model, 1e-3)
    step = make_train_step(bf16=True)
    want_step = {k: 0 for k in launch_counts()}
    want_step.update(per_step(per_batch))

    # the embedder's bf16 backward launcher (B-spline and Chebyshev:
    # _launch_bwd_bf16, by the forward's name; FastKAN: _launch_rbf_bwd, by
    # "<name>_bwd"), recording what the embedder's backward is asked for
    asked, attr = [], EMBEDDER_BWD.get(embedder, "_launch_bwd_bf16")
    launch_bwd = getattr(FB, attr)

    def recording(name, *args):
        if name.removesuffix("_bwd") == embedder:
            asked.append(tuple(args[-2:]))
        return launch_bwd(name, *args)

    clock = [time.perf_counter()]

    def lap(what):  # the phase's parts, on the host clock
        now = time.perf_counter()
        print(f"[time]   {variant} bf16 training, {what}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    reset_counts()
    losses, steps_ok = [], True
    setattr(FB, attr, recording)
    try:
        for _ in range(BF16_TRAIN_STEPS):
            before = launch_counts()
            state, loss, logits = step(state, x, y)
            after = launch_counts()
            steps_ok &= {k: after[k] - before[k] for k in after} == want_step
            losses.append(loss)
    finally:
        setattr(FB, attr, launch_bwd)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    print(f"[bf16-train] vit-s {variant} bf16, batch {BATCH}, {BF16_TRAIN_STEPS} "
          f"Adam(1e-3) steps on one batch: losses {[round(v, 6) for v in losses]}")
    print(f"[bf16-train] launches over {BF16_TRAIN_STEPS} steps: "
          f"{ {k: n for k, n in counts.items() if n} } (want per step "
          f"{ {k: n for k, n in want_step.items() if n} }, nothing else); the "
          f"embedder's backward asked for (dx, dW): {sorted(set(asked))}")
    check(steps_ok, f"bf16 training: a step's launches differ from {want_step}")
    check(asked == [(False, True)] * BF16_TRAIN_STEPS,
          f"bf16 training: the embedder's backward must compute no dx, got {asked}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"bf16 training: losses not finite or not falling: {losses}")
    check(logits.dtype == torch.float32 and tuple(logits.shape) == (BATCH, geom["out_d"]),
          f"bf16 training: logits {logits.dtype} {tuple(logits.shape)}")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "bf16 training: the parameters must stay f32")

    lap(f"{BF16_TRAIN_STEPS} steps")
    # gradients of a 4-image step, the card's against the CPU's bf16 twins;
    # a fused-FF model's also in f64, both on the card's ReLU pattern, and
    # the twins' on their own ("own", read and not gated)
    xg, yg = x[:GRAD_IMAGES].cpu(), y[:GRAD_IMAGES].cpu()
    grads, patterns, flips = {}, [], {"cpu": [], "f64": []}
    for dev in ("cuda", "cpu", "f64", "own") if fused else ("cuda", "cpu"):
        net = copy.deepcopy(model_cpu)
        where = "cpu" if dev == "own" else dev
        net, xd, yd = ((net.double(), xg.double(), yg) if dev == "f64"
                       else (net.to(where), xg.to(where), yg.to(where)))
        on = contextlib.nullcontext()
        if fused and dev != "own":  # the fused FF: the CPU's FF on the card's ReLU pattern
            on = (recorded_ffn_patterns(torch, patterns) if dev == "cuda"
                  else imposed_ffn_patterns(patterns, flips[dev], exact=dev == "f64"))
        with on:
            make_train_step(bf16=dev != "f64")(create_train_state(net, 1e-3), xd, yd)
        check(all(p.grad.dtype == (torch.float64 if dev == "f64" else torch.float32)
                  for p in net.parameters()), "bf16 training: the gradients must be f32")
        grads[dev] = {k: p.grad.double().cpu() for k, p in net.named_parameters()}
    for ref in ("cpu", "f64") if fused else ():
        got = flips[ref]
        flipped, total = sum(f[0] for f in got), sum(f[1] for f in got)
        far = max(f[2] for f in got)
        print(f"[bf16-train] the {ref} step's ReLU inputs on the other side of 0 from the "
              f"card's, block by block: {[f[0] for f in got]}; {flipped} of {total} (at most "
              f"{MODEL_FLIP_SHARE_BF16 * total:.0f}), the largest such |h| {far:.3e} of its "
              f"row's max|h| (limit {MODEL_FLIP_TOL_BF16:.3e})")
        check(len(got) == len(patterns) and flipped <= MODEL_FLIP_SHARE_BF16 * total
              and far <= MODEL_FLIP_TOL_BF16,
              f"bf16 training: the {ref} step's ReLU pattern is further from the card's "
              "than rounding")
    if fused:
        rels = fused_ff_grad_gate(torch, grads)
    else:  # x max(1, max|g|)
        rels = {name: float((grads["cuda"][name] - want).abs().max())
                / max(1.0, float(want.abs().max())) for name, want in grads["cpu"].items()}
    worst_name = max(rels, key=rels.get)
    worst = rels[worst_name]
    how = ("max|g| over tensors (a q/k tensor: or 5e-2 x its RMS distance from f64 over "
           "3x the twins)") if fused else "max(1, max|g|) over tensors"
    print(f"[bf16-train] gradients of {GRAD_IMAGES} images, card against the CPU's bf16 "
          f"twins, worst max|err| / {how}: {worst:.3e} ({worst_name})  limit "
          f"{TOL_BF16_GRADS:.0e}; the next: " +
          ", ".join(f"{k} {v:.3e}" for k, v in sorted(rels.items(), key=lambda kv: -kv[1])[1:6]))
    check(worst <= TOL_BF16_GRADS, f"bf16 training: the card's gradients differ from the "
                                   f"CPU's: {worst_name} {worst:.3e}")

    lap("the 4-image gradients on the card and the CPU")
    # the parameter casts: device kernels and the host's split of a step,
    # with the flat buffer and with a cast a parameter (before it)
    casts, split = {"flat": cast_kernels(torch, model)}, {"flat": host_split(torch, step, state,
                                                                             x, y)}
    if not fused:
        with casts_per_parameter():
            casts["per_parameter"] = cast_kernels(torch, model)
            split["per_parameter"] = host_split(torch, step, state, x, y)
    for kind in casts:
        c = casts[kind]
        print(f"[bf16-train] vit-s {variant} bf16 step, casts {kind}: {c['forward']} cast "
              f"kernels forward, {c['backward']} backward, for "
              f"{sum(1 for _ in model.parameters())} parameters; the casts alone "
              f"{c['host_forward_ms']:.2f} ms of host forward, {c['host_backward_ms']:.2f} "
              f"backward (median, unprofiled); host split (ms a step, torch.profiler host "
              f"ranges): " + ", ".join(f"{k} {v:.2f}" for k, v in split[kind].items()))

    lap("the casts' kernels and host splits")
    # steady state in turns with the f32 step and the per-parameter casts on
    # the same model: host clock around a synchronised window, CUDA events
    # around the same window
    f32_step, iters = make_train_step(), 10

    def per_parameter_step(*args):
        with casts_per_parameter():
            return step(*args)

    third = "bf16_per_parameter_casts"
    fns = {"f32": f32_step, "bf16": step, third: per_parameter_step}
    if fused:
        third = "bf16_unfused"
        other = create_train_state(unfused(copy.deepcopy(model_cpu)).to("cuda"), 1e-3)
        fns = {"f32": f32_step, "bf16": step,
               third: lambda _state, xs, ys: step(other, xs, ys)}
    times = {k: [] for k in fns}
    # two turns a kind, in the order f32, bf16, third, third, bf16, f32;
    # medians (here means), since the host clock of one window can stray by
    # 2x (PERF.md §5)
    for kind in ("f32", "bf16", third, third, "bf16", "f32"):
        fn = fns[kind]
        for _ in range(2):
            fn(state, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, window = device_ms(torch, lambda fn=fn: [fn(state, x, y) for _ in range(iters)])
        torch.cuda.synchronize()
        times[kind].append(((time.perf_counter() - t0) / iters * 1e3,
                            window[0].elapsed_time(window[1]) / iters))
    host = {k: float(np.median([h for h, _ in v])) for k, v in times.items()}
    events = {k: float(np.median([e for _, e in v])) for k, v in times.items()}
    ips = {k: BATCH / (v / 1e3) for k, v in host.items()}
    print(f"[bf16-train] steady state (medians of two turns), vit-s {variant} batch "
          f"{BATCH}: bf16 "
          f"{host['bf16']:.2f} ms a step, {ips['bf16']:.1f} images/s (host clock; CUDA "
          f"events {events['bf16']:.2f}); {third} {host[third]:.2f} ms, "
          f"{ips[third]:.1f} images/s (events {events[third]:.2f}); f32 {host['f32']:.2f} ms, "
          f"{ips['f32']:.1f} images/s (events {events['f32']:.2f}); turns {times}  [{smi}]")
    lap("the steady state's turns")
    # the bf16 step's profile alone: the f32 step's is phase 10's, and the
    # unfused bf16 step's is the efficientkan bf16 phase's
    profile = phase_profile(torch, step, state, x, y, f"vit-s {variant} bf16")
    lap("the profile")
    return {"launches": counts, "losses": losses, "grad_rel_err": worst,
            "step_ms": host, "events_ms": events, "images_per_s": ips,
            "cast_kernels": casts, "host_split": split, "profile": profile}


# The vit-s vanilla ViT in 3 heads of 128 (kanvit's --n-heads on the
# preset's width): its attention is the only kernel, the bf16 lanes one at a
# generic head dim (the padded instantiation), its q/k/v one baddbmm.
HEADS_BF16 = 3
HEADS_BF16_PER_BATCH = {"flash_attention_lanes_bf16": 12}


def phase_heads_bf16(torch, smi, vanilla_cpu):
    """Phase 12c: the vit-s vanilla ViT at ``HEADS_BF16`` heads of 128 served
    in bf16 (``phase_bf16_serve``: logits within 2e-2 x max(1, max|logit|)
    of the CPU's bf16 forward, 12 bf16 lanes launches a forward), then
    trained in bf16 through ``make_train_step(bf16=True)`` at batch 64:
    exactly 12 bf16 lanes forward and 12 backward launches a step and
    nothing else, losses finite and falling, the gradients of a 4-image
    step within 5e-2 x max(1, max|g|) per tensor of the CPU's bf16 step
    (the plain twins), and ms a step beside the 6-head (dh 64) model's in
    turns (3, 6, 6, 3 heads; host clock, CUDA events). Returns the serving
    and training launches as two paths."""
    from kanvit_torch.train import create_train_state, make_train_step

    model_cpu = build_model("vanilla", n_heads=HEADS_BF16)
    label = f"vanilla {HEADS_BF16} heads"
    serve = phase_bf16_serve(torch, smi, model_cpu, SEED + 16, label, HEADS_BF16_PER_BATCH)
    rng = np.random.default_rng(SEED + 17)
    x = torch.from_numpy(rng.standard_normal((BATCH, 3, 224, 224)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, BATCH)).cuda()
    step = make_train_step(bf16=True)
    states = {HEADS_BF16: create_train_state(copy.deepcopy(model_cpu).cuda(), 1e-3),
              6: create_train_state(copy.deepcopy(vanilla_cpu).cuda(), 1e-3)}
    want = {k: 0 for k in launch_counts()}
    want.update(per_step(HEADS_BF16_PER_BATCH))
    reset_counts()
    losses, steps_ok, state = [], True, states[HEADS_BF16]
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        state, loss, _ = step(state, x, y)
        after = launch_counts()
        steps_ok &= {k: after[k] - before[k] for k in after} == want
        losses.append(loss)
    states[HEADS_BF16] = state
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    print(f"[bf16-train] vit-s {label} bf16, batch {BATCH}, {TRAIN_STEPS} Adam(1e-3) steps "
          f"on one batch: losses {[round(v, 6) for v in losses]}; launches "
          f"{ {k: n for k, n in counts.items() if n} } (want per step "
          f"{ {k: n for k, n in want.items() if n} }, nothing else)")
    check(steps_ok, f"{label} bf16 training: a step's launches differ from {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label} bf16 training: losses not finite or not falling: {losses}")
    grads = {}
    for dev in ("cuda", "cpu"):
        net = copy.deepcopy(model_cpu).to(dev)
        make_train_step(bf16=True)(create_train_state(net, 1e-3), x[:GRAD_IMAGES].to(dev),
                                   y[:GRAD_IMAGES].to(dev))
        grads[dev] = {k: p.grad.double().cpu() for k, p in net.named_parameters()}
    rels = {name: float((grads["cuda"][name] - w).abs().max()) / max(1.0, float(w.abs().max()))
            for name, w in grads["cpu"].items()}
    worst = max(rels, key=rels.get)
    print(f"[bf16-train] {label}: gradients of {GRAD_IMAGES} images, card against the "
          f"CPU's bf16 twins, worst max|err| / max(1, max|g|) over tensors: "
          f"{rels[worst]:.3e} ({worst})  limit {TOL_BF16_GRADS:.0e}")
    check(rels[worst] <= TOL_BF16_GRADS,
          f"{label} bf16 training: the card's gradients differ from the CPU's: {worst}")
    times, iters = {h: [] for h in states}, 10
    for h in (HEADS_BF16, 6, 6, HEADS_BF16):
        for _ in range(2):
            states[h] = step(states[h], x, y)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, window = device_ms(torch, lambda h=h: [step(states[h], x, y) for _ in range(iters)])
        torch.cuda.synchronize()
        times[h].append(((time.perf_counter() - t0) / iters * 1e3,
                         window[0].elapsed_time(window[1]) / iters))
    host = {h: float(np.mean([a for a, _ in v])) for h, v in times.items()}
    events = {h: float(np.mean([e for _, e in v])) for h, v in times.items()}
    print(f"[bf16-train] vit-s vanilla bf16 steady state, batch {BATCH} (means of two "
          f"turns): " + "; ".join(f"{h} heads (dh {384 // h}) {host[h]:.2f} ms a step, "
                                  f"{BATCH / host[h] * 1e3:.1f} images/s (host clock; CUDA "
                                  f"events {events[h]:.2f})" for h in host)
          + f"; turns {times}  [{smi}]")
    return {"vanilla_3h_bf16_serve": serve["launches"], "vanilla_3h_bf16_train": counts}


# --------------------------------------------------------------------------
# Phase 10: training
# --------------------------------------------------------------------------

def device_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    return out, (start, end)


def grad_scale(name, grads):
    """max|g| of a tensor's CPU gradient; for a key projection's bias (Linear,
    FastKAN base branch or SineKAN) that of the projection's weight. The
    softmax cancels the bias (it adds the same q . b to every score of a
    row), so its gradient is 0 in exact arithmetic and rounding noise on
    both sides."""
    m = re.fullmatch(r"(.*\.k_mappings\.\d+\.)(base_linear\.)?bias", name)
    if m:
        name = next(m.group(1) + w for w in ("weight", "base_linear.weight", "amplitudes")
                    if m.group(1) + w in grads)
    return float(grads[name].abs().max())


def grads_against(got, want):
    """The worst ``max|got - want| / grad_scale`` over tensors, its name, and
    the tensors held against the model's largest max|g| instead: those whose
    reference max|g| is 0 or at f32 rounding level of it (a softmax that
    saturates makes a query projection's gradient 0 in exact arithmetic,
    rounding on the card), where their own max has no scale."""
    scales = {name: grad_scale(name, want) for name in want}
    top = max(scales.values())
    worst, worst_name, floored = 0.0, "", []
    for name, g in want.items():
        scale = scales[name]
        if scale <= F32_ROUNDING * top:
            scale = top
            floored.append(f"{name} {scales[name] / top:.1e}")
        rel = float((got[name] - g).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name, floored


def relu_patterns(torch, net, impose=None, inputs=None):
    """Forward hooks on every ReLU of ``net``: record each one's pattern
    (output > 0) into the returned dict, or, given ``impose`` (such a dict),
    compute ``input * pattern`` instead, so that the net takes the same
    linear piece as the run that recorded it. f32 rounding puts some
    pre-activations that lie within it of 0 on the other side (a few of
    vit-s's 14.5M a batch of 4), and each such flip moves its block's FF
    gradient by up to ~4e-3 of the tensor's max; on one pattern the
    gradients of the f32 run and of f64 differ by rounding alone. Given
    ``inputs`` (a dict), also record each ReLU's input there. Returns
    ``(patterns, hooks)``."""
    seen, hooks = {}, []

    def record(name):
        def hook(mod, inp, out):
            seen[name] = (out > 0).cpu()
            if inputs is not None:
                inputs[name] = inp[0].detach().cpu()
        return hook

    def follow(name):
        return lambda mod, inp, out: inp[0] * impose[name].to(
            inp[0].device, inp[0].dtype).reshape(inp[0].shape)

    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.ReLU):
            hook = record(name) if impose is None else follow(name)
            hooks.append(mod.register_forward_hook(hook))
    return seen, hooks


def fused_relu_patterns(torch, net):
    """The ReLU patterns of a fused-FF model's forward, as its kernel decides
    them (``relu_mask``), under the names of the unfused FF's ReLU modules
    (``blocks.<i>.ff.1``), whose hooks the references take them up with.
    Returns ``(patterns, restore)``."""
    from kanvit_torch.kernels import fused_ffn as FFN

    launch, seen = FFN._launch, {}
    names = iter([f"blocks.{i}.ff.1" for i in range(len(net.blocks))])

    def recording(x2d, gamma, beta, w1, *rest):
        mask = torch.empty(x2d.shape[0], w1.shape[0], dtype=torch.uint8,
                           device=x2d.device)
        y = launch(x2d, gamma, beta, w1, *rest, relu_mask=mask)
        seen[next(names)] = mask.bool().cpu()
        return y

    FFN._launch = recording
    return seen, lambda: setattr(FFN, "_launch", launch)


def is_fused(net):
    """Whether ``net``'s blocks run the fused FF."""
    return any(getattr(blk, "fused_ff", False) for blk in getattr(net, "blocks", ()))


def unfused(net):
    """``net`` with its blocks' FF unfused (the same function, plain
    modules whose ReLUs the pattern hooks see)."""
    for blk in getattr(net, "blocks", ()):
        if getattr(blk, "fused_ff", False):
            blk.fused_ff = False
    return net


def grad_gate(torch, model_cpu, xg, yg, tag):
    """Parameter gradients of the batch ``xg, yg`` on the card against the
    same model's on the CPU in f64, on the card's own ReLU pattern (see
    relu_patterns; a fused FF reports the kernel's), the free f64 and the
    CPU's f32 gradients beside them. Returns the worst relative error."""
    import torch.nn.functional as F

    grads, patterns, pre64 = {}, {}, {}
    for key, net, dtype in (("gpu", copy.deepcopy(model_cpu).to("cuda"), torch.float32),
                            ("cpu", unfused(copy.deepcopy(model_cpu)), torch.float32),
                            ("cpu64", unfused(copy.deepcopy(model_cpu)).double(),
                             torch.float64),
                            ("cpu64_gpu_relus", unfused(copy.deepcopy(model_cpu)).double(),
                             torch.float64)):
        dev = next(net.parameters()).device
        if any(getattr(b, "fused_ff", False) for b in getattr(net, "blocks", ())):
            seen, restore = fused_relu_patterns(torch, net)
        else:
            seen, hooks = relu_patterns(
                torch, net, patterns.get("gpu") if key == "cpu64_gpu_relus" else None,
                pre64 if key == "cpu64" else None)
            restore = lambda hooks=hooks: [h.remove() for h in hooks]  # noqa: E731
        try:
            F.cross_entropy(net(xg.to(dev, dtype)), yg.to(dev)).backward()
        finally:
            restore()
        patterns[key] = seen
        grads[key] = {name: p.grad.double().cpu() for name, p in net.named_parameters()}
    # the card's pattern (a fused FF's as its kernel reports it) against
    # f64's: few flips, each within rounding of 0
    flips, total, worst_flip = 0, 0, 0.0
    for k, gpu_pattern in patterns["gpu"].items():
        h64 = pre64[k].reshape(-1, pre64[k].shape[-1])
        flipped = gpu_pattern.reshape(h64.shape) != (h64 > 0)
        flips, total = flips + int(flipped.sum()), total + flipped.numel()
        if bool(flipped.any()):
            rel = h64.abs() / h64.abs().amax(-1, keepdim=True).clamp_min(1e-300)
            worst_flip = max(worst_flip, float(rel[flipped].max()))
    check_flips(f"[{tag}] gradients of {len(xg)} images: the GPU's forward against f64",
                flips, total, worst_flip, FLIP_TOL_F64)
    worst, worst_name, floored = grads_against(grads["gpu"], grads["cpu64_gpu_relus"])
    free_worst, free_name, _ = grads_against(grads["gpu"], grads["cpu64"])
    cpu_worst, cpu_name, _ = grads_against(grads["cpu"], grads["cpu64"])
    f32_worst, f32_name, _ = grads_against(grads["gpu"], grads["cpu"])
    print(f"[{tag}] gradients of {len(xg)} images, per tensor, worst max|err| / "
          f"max|g|: GPU against CPU f64 on the GPU's ReLU pattern {worst:.3e} "
          f"({worst_name})  limit {TOL_GRADS:.0e}; against free CPU f64 "
          f"{free_worst:.3e} ({free_name}; {flips} ReLU outputs of the GPU's "
          f"forward on the other side of 0 than f64's); CPU f32 against CPU f64 "
          f"{cpu_worst:.3e} ({cpu_name}); GPU against CPU f32 {f32_worst:.3e} "
          f"({f32_name}); {len(floored)} tensors with f64 max|g| at f32 rounding level "
          f"of the largest, held against it: {floored}")
    check(worst <= TOL_GRADS, f"{tag}: GPU gradients differ from the CPU's: "
                              f"{worst_name} {worst:.3e}")
    return worst


# The launcher of each embedder's backward, whose last two arguments are
# (need_dx, need_dw).
EMBEDDER_BWD = {"fastkan": "_launch_rbf_bwd", "sinekan": "_launch_sine_bwd"}


def phase_train(torch, smi, model_cpu, tag, per_step_fwd, embedder):
    """6 Adam steps at batch 64 on one batch through ``kanvit_torch.train``:
    exactly ``per_step_fwd`` forward launches a step and as many backward
    ones, the embedder's (``embedder``; None for a Linear embedder, which
    launches no kernel) asked for no dx; losses finite
    and falling; 4-image gradients against the CPU; ms a step and images/s;
    the device time's split and a ``torch.profiler`` breakdown."""
    import torch.nn.functional as F

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["vit-s"]
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal((BATCH, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], BATCH)).cuda()
    state = create_train_state(model, 1e-3)
    step = make_train_step()
    per_step = {k: 0 for k in launch_counts()}
    per_step.update(per_step_fwd)
    per_step.update({f"{k}_bwd": n for k, n in per_step_fwd.items()})

    asked = []  # (need_dx, need_dw) of each embedder backward launch
    attr = EMBEDDER_BWD.get(embedder, "_launch_bwd")
    launch_bwd = getattr(FB, attr)

    def recording_launch_bwd(name, *args):
        if name == f"{embedder}_bwd":
            asked.append(tuple(args[-2:]))
        return launch_bwd(name, *args)

    reset_counts()
    losses, steps_ok = [], True
    setattr(FB, attr, recording_launch_bwd)
    try:
        for _ in range(TRAIN_STEPS):
            before = launch_counts()
            state, loss, logits = step(state, x, y)
            after = launch_counts()
            steps_ok &= {k: after[k] - before[k] for k in after} == per_step
            losses.append(loss)
    finally:
        setattr(FB, attr, launch_bwd)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    print(f"[{tag}] vit-s {model_cpu.type} batch {BATCH}, {TRAIN_STEPS} Adam(1e-3) "
          f"steps on one batch: losses {[round(v, 6) for v in losses]}")
    print(f"[{tag}] launches over {TRAIN_STEPS} steps: "
          f"{ {k: n for k, n in counts.items() if n} } (want per step "
          f"{ {k: n for k, n in per_step.items() if n} }, nothing else); the "
          f"embedder's backward asked for (dx, dW): {sorted(set(asked))}")
    check(steps_ok, f"{tag}: a training step's launches differ from {per_step}")
    check(embedder is None or asked == [(False, True)] * TRAIN_STEPS,
          f"{tag}: the embedder's backward must compute no dx, got {asked}")
    check(all(np.isfinite(losses)), f"{tag}: training losses are not finite: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(tuple(logits.shape) == (BATCH, geom["out_d"])
          and bool(logits.isfinite().all()), f"{tag}: training logits")

    # gradients of a small batch on the card against the same model's on the
    # CPU in f64, on the card's own ReLU pattern
    worst = grad_gate(torch, model_cpu, x[:GRAD_IMAGES], y[:GRAD_IMAGES], tag)

    # steady state: host clock around a synchronised window, as the bench,
    # and CUDA events around the same window
    for _ in range(2):
        state, loss, _ = step(state, x, y)
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, window = device_ms(torch, lambda: [step(state, x, y) for _ in range(iters)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    step_ms, ips = secs / iters * 1e3, iters * BATCH / secs
    dev_step_ms = window[0].elapsed_time(window[1]) / iters

    # device time of forward + loss, backward and the optimizer, CUDA events
    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for _ in range(3):
        state.tx.zero_grad()
        loss, ev_f = device_ms(torch, lambda: F.cross_entropy(model(x), y))
        _, ev_b = device_ms(torch, loss.backward)
        _, ev_o = device_ms(torch, state.tx.step)
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_f, ev_b, ev_o)):
            parts[key].append(a.elapsed_time(b))
    parts = {k: float(np.median(v)) for k, v in parts.items()}
    total = sum(parts.values())
    print(f"[{tag}] steady state, vit-s {model_cpu.type} batch {BATCH}: "
          f"{step_ms:.2f} ms per step, {ips:.1f} images/s (host clock; CUDA events "
          f"{dev_step_ms:.2f} ms per step)  [{smi}]")
    print(f"[{tag}] device ms per step: " + ", ".join(
        f"{k} {v:.2f} ({v / total:.1%})" for k, v in parts.items()))
    profile = phase_profile(torch, step, state, x, y, f"vit-s {model_cpu.type}")
    return {"images_per_s": ips, "step_ms": step_ms, "launches": counts,
            "losses": losses, "grad_rel_err": worst, "parts_ms": parts,
            "profile": profile}


# KAN basis kernels are grouped by family too (their template argument).
KAN_FAMILIES = ("Bspline", "Cheby", "Fourier", "Rbf", "Sine")
KERNEL_GROUPS = (
    ("KAN basis fwd", ("kan_fwd_kernel",)),
    ("KAN q/k/v and embedder bwd on the tensor cores (B-spline, Chebyshev, RBF, "
     "sine: dW, dx)", ("kan_tc_dw_grouped", "kan_tc_dx_kernel", "WtSource")),
    ("KAN q/k/v and embedder bwd in bf16 (B-spline, Chebyshev, RBF, sine, Fourier: dW, "
     "dx, split sums, dfreq sums)",
     ("kan_bf16_dw", "kan_bf16_dx", "sum_splits_bf16", "sum_rows_features")),
    ("the bf16 step's parameter casts: the gradients' gather", ("CatArrayBatchedCopy",)),
    ("KAN q/k/v and embedder fwd on the tensor cores (B-spline, Chebyshev, RBF, sine; "
     "Fourier in bf16)",
     ("kan_tc_fwd_grouped", "kan_tc_fwd_split")),
    ("KAN basis on the tensor cores (Fourier, sine: fwd, dW)",
     ("kan_tc_kernel", "kan_tc_split")),
    ("KAN basis bwd", ("kan_dx_kernel", "kan_dw_kernel", "sum_splits_kernel",
                       "sum_blocks_kernel")),
    ("RBF LayerNorm stats and VJP", ("ln_stats_kernel", "ln_dx_kernel", "ln_dgb_kernel")),
    ("attention fwd", ("attention_lanes_fwd",)),
    ("attention bwd", ("attention_lanes_dq", "attention_lanes_dkv")),
    ("tiled attention fwd", ("flash_fwd_",)),
    ("tiled attention dq", ("flash_dq_",)),
    ("tiled attention dk/dv", ("flash_dkv_",)),
    ("fused FF fwd in bf16", ("ffn_fwd_bf16", "ffn_gemm_bf16<0", "ffn_gemm_bf16<1")),
    ("fused FF bwd in bf16", ("ffn_ln_rows_bf16", "ffn_bwd_hidden_bf16", "ffn_bwd_dx_bf16",
                              "ffn_dw_bf16", "ffn_sum_parts_bf16", "ffn_gemm_bf16<2",
                              "ffn_dx_rows_bf16")),
    ("fused FF fwd", ("ffn_fwd_tc", "ffn_gemm_tc<0>", "ffn_gemm_tc<1>", "ffn_split_rows")),
    ("fused FF bwd", ("ffn_ln_rows", "ffn_split_weights", "ffn_bwd_hidden_tc",
                      "ffn_bwd_dx_tc", "ffn_dw_tc", "ffn_sum_parts_kernel",
                      "ffn_gemm_tc<2>", "ffn_dx_rows")),
    ("int8 linear", ("int8_linear_kernel",)),
    ("GEMM (cuBLAS; torch._int_mm)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_",
                                      "nvjet")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("elementwise (int8 quantize and dequantize, residuals, activations)",
     ("elementwise_kernel",)),
    ("reductions (int8 amax)", ("reduce_kernel",)),
    ("LayerNorm", ("layer_norm",)),
)


PROFILE_TOL = 0.05  # a profile's busy time against CUDA events over the same steps
SPIN_OPS = 128      # operations a segment of a fenced run
_SPIN = {}


def spin_cycles_per_ms(torch):
    """torch.cuda._sleep's cycles a millisecond on this card (CUDA events
    around one 20-million-cycle spin), measured once a process."""
    if "per_ms" not in _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 20_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def device_kernels(prof):
    return [e for e in prof.events()
            if "cuda" in str(getattr(e, "device_type", "")).lower()
            and not getattr(e, "is_user_annotation", False)]


def spin_fence(torch, ops, spin_ms):
    """A dispatch mode (the backward's operations too) that queues a spin
    kernel of ``spin_ms`` before every ``ops``-th operation and after each
    place where the host waits for the card to drain (a copy between host
    and card, a value read back): the host enqueues the next operations'
    kernels while the card spins, so the card runs them back to back, and
    fewer than the launch queue holds wait at a time. CUDA events mark each
    stretch the card runs back to back, from a spin's end to the next spin
    or wait (``stretches``; ``cut`` closes the last one). Its ``fresh``, a
    function mode, does the same around a tensor made on the card from host
    data, whose copy the dispatch mode does not see; enter both."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_flatten
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    cycles = int(spin_ms * spin_cycles_per_ms(torch))
    copies = (aten._to_copy.default, aten.copy_.default)
    makers = (torch.tensor, torch.as_tensor, torch.scalar_tensor, torch.Tensor.new_tensor)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def waits(func, args, kwargs):
        tensors = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if func is aten._local_scalar_dense.default:
            return tensors[0].is_cuda
        kinds = {t.device.type for t in tensors if t.dim() or func in copies}
        if func in copies and kwargs.get("device") is not None:
            kinds.add(torch.device(kwargs["device"]).type)
        return {"cpu", "cuda"} <= kinds

    class SpinFence(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count, self.waits, self.threads = 0, 0, set()
            self.stretches, self.start = [], None
            self.fresh = Fresh(self)

        def spin(self):
            torch.cuda._sleep(cycles)
            self.start = event()

        def cut(self):
            if self.start is not None:
                self.stretches.append((self.start, event()))
                self.start = None

        def waited(self, call):
            self.waits += 1
            self.cut()
            out = call()
            self.spin()
            return out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.threads.add(threading.get_ident())
            if self.count % ops == 0 or self.start is None:
                self.cut()
                self.spin()
            self.count += 1
            if waits(func, args, kwargs):
                return self.waited(lambda: func(*args, **kwargs))
            return func(*args, **kwargs)

    class Fresh(TorchFunctionMode):
        def __init__(self, fence):
            super().__init__()
            self.fence = fence

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in makers:
                dev = kwargs.get("device", args[0].device if func is makers[-1] else None)
                if dev is not None and torch.device(dev).type == "cuda":
                    return self.fence.waited(lambda: func(*args, **kwargs))
            return func(*args, **kwargs)

    return SpinFence()


def host_ms_per_op(torch, step, state, x, y):
    """The host's ms an operation of one call of ``step`` (a fence that
    spins for no time counts them), and the operations a call."""
    fence = spin_fence(torch, 1 << 40, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fence.fresh, fence:
        step(state, x, y)
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms / max(1, fence.count), fence.count


def fenced_run(torch, step, state, x, y, steps, spin_ms, calibration=200):
    """``steps`` calls of ``step`` under ``torch.profiler`` and a spin fence
    (``spin_fence``): returns the profile's kernels without the spins, the
    card's time of the calls back to back (the sum of the fence's stretches
    by CUDA events) in ms, and the card's launch gap in µs, measured first in
    the same profile: ``calibration`` empty spins queued back to back, by
    CUDA events less their own durations."""
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fence = spin_fence(torch, SPIN_OPS, spin_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(5 * spin_cycles_per_ms(torch)))
        ev[0].record()
        for _ in range(calibration):
            torch.cuda._sleep(0)
        ev[1].record()
        torch.cuda.synchronize()
        with fence.fresh, fence:
            for _ in range(steps):
                step(state, x, y)
        fence.cut()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    empty = [e.time_range.end - e.time_range.start for e in kernels
             if is_spin(e) and e.time_range.end - e.time_range.start < 50]
    gap = (ev[0].elapsed_time(ev[1]) * 1e3 - sum(empty)) / calibration
    window = sum(a.elapsed_time(b) for a, b in fence.stretches)
    print(f"[profile]   fence: {fence.count} operations on {len(fence.threads)} threads, "
          f"{fence.waits} host waits, {len(fence.stretches)} stretches behind spins of "
          f"{spin_ms:.2f} ms; launch gap {gap:.3f} us ({len(empty)} of {calibration} empty "
          f"spins in the profile)")
    return [e for e in kernels if not is_spin(e)], window, gap


def phase_profile(torch, step, state, x, y, label, steps=2, what="training steps"):
    """Device time of ``steps`` training steps (or other calls, ``what``) by
    kernel, from ``torch.profiler``, held against CUDA events over the same
    steps. First the steps as the host feeds them (the idle share: of the
    window from the first kernel's start to the last kernel's end); then
    again behind a spin fence (``fenced_run``), so that CUDA events time
    their kernels back to back: that time, less the card's launch gap a
    kernel, is the device time, and each profile keeps every event when its
    busy time lies within PROFILE_TOL of it. A profile that does not is
    taken again, up to twice, and the phase fails if none does (a profile
    drops its first few device records, which ``first_kernel`` makes spins,
    and now and then times a step's kernels long: PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    def busy_of(kernels):
        return sum(kernel_times(kernels).values()) / steps / 1e3

    def fed_run():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first_kernel(torch)
            for _ in range(steps):
                step(state, x, y)
            torch.cuda.synchronize()
        return [e for e in device_kernels(prof) if not is_spin(e)]

    fed = fed_run()
    check(bool(fed), "the profiler recorded no device time")
    per_op, ops = host_ms_per_op(torch, step, state, x, y)
    spin_ms = max(1.0, 4 * SPIN_OPS * per_op)
    print(f"[profile] {label}: {ops} operations a call, {per_op * 1e3:.1f} us of host a "
          f"operation")
    for _ in range(3):
        kernels, window, gap = fenced_run(torch, step, state, x, y, steps, spin_ms)
        busy = busy_of(kernels)
        dev_ms = (window - len(kernels) * gap / 1e3) / steps
        ok = abs(busy - dev_ms) <= PROFILE_TOL * dev_ms
        print(f"[profile] {steps} {label} {what}, fenced: busy {busy:.3f} ms per step, CUDA "
              f"events {window / steps:.3f}, less {len(kernels) / steps:.0f} kernels' launch "
              f"gaps {dev_ms:.3f} ({busy / dev_ms - 1:+.2%})")
        if ok:
            break
        spin_ms *= 2
    check(ok, f"{label}: the profile's busy time {busy:.3f} ms a step is not within "
              f"{PROFILE_TOL:.0%} of CUDA events' {dev_ms:.3f}")
    fed_busy = busy_of(fed)
    for _ in range(2):
        if abs(fed_busy - dev_ms) <= PROFILE_TOL * dev_ms:
            break
        print(f"[profile] {label}: the fed profile's busy time {fed_busy:.3f} ms a step "
              f"({len(fed)} device records; the fenced one's {len(kernels)}) is not within "
              f"{PROFILE_TOL:.0%} of {dev_ms:.3f}; profiling again")
        fed = fed_run()
        fed_busy = busy_of(fed)
    check(abs(fed_busy - dev_ms) <= PROFILE_TOL * dev_ms,
          f"{label}: the fed profile's busy time {fed_busy:.3f} ms a step ({len(fed)} "
          f"device records; the fenced one's {len(kernels)}) is not within "
          f"{PROFILE_TOL:.0%} of {dev_ms:.3f}")
    by_name = kernel_times(kernels)
    window_fed = max(e.time_range.end for e in fed) - min(e.time_range.start for e in fed)
    idle = 1 - fed_busy * steps * 1e3 / window_fed
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        family = next((f for f in KAN_FAMILIES if f in name), None)
        if group.startswith("KAN") and family:
            group = f"{group} ({family})"
        groups[group] = groups.get(group, 0.0) + us
    total = busy * steps * 1e3
    print(f"[profile] {steps} {label} {what}: device busy {busy:.3f} ms per step (CUDA "
          f"events, the same steps back to back: {dev_ms:.3f}); as the host feeds them busy "
          f"{fed_busy:.3f}, idle share {idle:.4f} of the device window")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {us / total:6.1%}  {us / steps / 1e3:8.3f} ms/step  {group}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]     {us / steps / 1e3:8.3f} ms/step  {name[:110]}")
    return {"busy_ms_per_step": busy, "events_ms_per_step": dev_ms,
            "fed_busy_ms_per_step": fed_busy, "idle_share": idle, "launch_gap_us": gap,
            "groups_ms_per_step": {k: v / steps / 1e3 for k, v in groups.items()}}


# --------------------------------------------------------------------------
# Phase 11: int8 serving
# --------------------------------------------------------------------------

def top1_and_probs(logits, ref):
    """Top-1 agreement of ``logits`` with ``ref`` and the largest change of
    a probability (kanvit's int8 gates, ``tests/test_quant.py``)."""
    def probs(z):
        z = z.astype(np.float64) - z.max(-1, keepdims=True)
        return np.exp(z) / np.exp(z).sum(-1, keepdims=True)

    return (float((logits.argmax(-1) == ref.argmax(-1)).mean()),
            float(np.abs(probs(logits) - probs(ref)).max()))


def widening_casts(torch, fwd, reps=5):
    """The widening of bf16 parameters to f32 in one forward ``fwd()``
    (``precision.promote``, counted where the layers call it): how many
    tensors it widens, their device kernels and device ms (each widening
    call in a ``torch.profiler`` host range of its own, the kernels under
    it), and the host ms of the promote calls (median over ``reps``
    unprofiled forwards)."""
    import kanvit_torch.layers.attention as layer_attention
    import kanvit_torch.layers.kan as layer_kan
    import kanvit_torch.layers.transformer as layer_transformer
    import kanvit_torch.models.vit as model_vit
    from torch.profiler import ProfilerActivity, profile, record_function

    from kanvit_torch.utils import precision

    users = (layer_attention, layer_kan, layer_transformer, model_vit)
    seen = {"casts": 0, "host_s": 0.0, "ranges": False}

    def counted(x, *params):
        t0 = time.perf_counter()
        out = precision.promote(x, *params)
        widened = sum(1 for p, q in zip(params, out) if p is not q)
        if widened and seen["ranges"]:
            with record_function("kanvit_widen"):
                out = precision.promote(x, *params)
        seen["host_s"] += time.perf_counter() - t0
        seen["casts"] += widened
        return out

    for module in users:
        module.promote = counted
    try:
        host = []
        for _ in range(reps):
            seen.update(casts=0, host_s=0.0)
            fwd()
            torch.cuda.synchronize()
            host.append(seen["host_s"] * 1e3)
        casts = seen["casts"]
        seen["ranges"] = True
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first_kernel(torch)
            fwd()
            torch.cuda.synchronize()
    finally:
        for module in users:
            module.promote = precision.promote
    found = {"kernels": 0, "device_us": 0.0}

    def walk(event):
        for k in getattr(event, "kernels", ()):
            found["kernels"] += 1
            found["device_us"] += k.duration
        for child in event.cpu_children:
            walk(child)

    for event in prof.events():
        if event.name == "kanvit_widen":
            walk(event)
    return {"tensors_widened": casts, "device_kernels": found["kernels"],
            "device_ms": found["device_us"] / 1e3,
            "host_ms": float(np.median(host))}


def replay_blocks(torch, model, model_cpu, x, scales, kernel):
    """The card's int8 forward of ``x`` replayed on the CPU a block at a
    time: each block's input on the card fed to the same block of
    ``model_cpu``, and the card's last hidden state to the CPU's head, under
    the same int8 serving. Returns each block's and the head's max|card -
    CPU| over max(1, max|CPU|): the card's own inputs, so no earlier
    rounding difference carries into a block."""
    from kanvit_torch.ops import quant as Q
    from kanvit_torch.utils import precision

    seen = []
    hooks = [blk.register_forward_hook(
        lambda m, args, out: seen.append((args[0].detach().cpu(), out.detach().cpu())))
        for blk in model.blocks]
    try:
        with torch.inference_mode(), precision.f32_accumulation(), \
                Q.int8_serving(model, scales, kernel=kernel):
            logits = model(x).float().cpu()
    finally:
        for h in hooks:
            h.remove()

    def rel(got, want):
        want = want.float()
        return float((got.float() - want).abs().max()) / max(1.0, float(want.abs().max()))

    errs = []
    with torch.inference_mode(), Q.int8_serving(model_cpu, scales, kernel=kernel):
        for blk, (inp, out) in zip(model_cpu.blocks, seen):
            errs.append(rel(out, blk(inp)))
        errs.append(rel(logits, model_cpu.mlp_head(seen[-1][1][:, 0]).float()))
    return errs


# launches a batch of each int8 route ("kernel" also calibrated), by phase
INT8_PER_BATCH = {
    "vit-s vanilla": {"kernel": {"int8_linear": 25, "flash_attention_lanes": 12},
                      "qdot": {"flash_attention_lanes": 12}},
    "vit-b vanilla bf16": {"kernel": {"int8_linear_bf16": 25,
                                      "flash_attention_lanes_bf16": 12},
                           "qdot": {"flash_attention_lanes": 12}},
    # to_q, to_kv and to_out a block, and the embedder
    "vit-b flash-attn at 4 of 12 blocks bf16": {
        "kernel": {"int8_linear_bf16": 1 + 3 * 4, "flash_attention_lanes_bf16": 4}},
    # block 0 bf16 up to its FF, the stream f32 after it
    "vit-s efficientkan at 4 of 12 blocks bf16": {
        "qdot": {"bspline_kan_bf16": 1, "bspline_qkv_grouped_bf16": 1,
                 "flash_attention_lanes_bf16": 1, "bspline_qkv_grouped": 3,
                 "flash_attention_lanes": 3}},
}


def phase_int8_serve(torch, smi, model_f32, tag, bf16=False,
                     routes=("kernel", "calibrated", "qdot"), measure=True,
                     chained_gate=True):
    """``model_f32`` (random weights from ``SEED``; with ``bf16``, a bf16
    copy of it, kanvit's ``--bf16 --quant int8``) served float and int8
    through ``Predictor`` for three requests on each of ``routes``: the
    ``int8_linear`` kernel (the embedder and 12 FF pairs of a vanilla ViT;
    on bf16 its bf16 form, the stream bf16 up to the head), calibrated
    static scales with the kernel, and ``qdot`` alone (a bf16 stream turns
    f32 at the first int8 Linear, later layers on widened weights). Each:
    exactly ``INT8_PER_BATCH[tag]``'s launches a batch and nothing else;
    top-1 agreement at least 0.9 and no probability moved by 0.2 against
    the same model's float logits (kanvit's gates); four images against the
    CPU's int8 forward of the same model within 2e-2 x max(1,
    max|logit|), and the same four replayed on the CPU a block at a time
    from the card's own inputs (``replay_blocks``), each block and the head
    within 2e-2 x max(1, max|out|). ``chained_gate=False`` prints the
    chained four images' gap, and the f32 model's on the same path, without
    gating it: the flash-attn ViT's raw attention blocks (no residual or
    LayerNorm) turn a one-ulp difference of the attention, which int8 turns
    into whole quantization steps, into a gap at its class token that the
    head's LayerNorm spreads over the logits; in f32 too (PERF.md, §6).
    ``measure``: images/s host to host, the device forward (CUDA events)
    and one profile each of the float forward and each route, the time of
    quantizing the weights that run once over (which every int8 forward does
    again), and on a bf16 model the qdot route's widening casts
    (``widening_casts``)."""
    from kanvit_torch.infer import Predictor
    from kanvit_torch.ops import quant as Q
    from kanvit_torch.utils import precision

    dtype = torch.bfloat16 if bf16 else torch.float32
    model_cpu = precision.cast_params_(copy.deepcopy(model_f32)) if bf16 else model_f32
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + (12 if bf16 else 11))
    images = rng.standard_normal((sum(REQUESTS), *model.chw)).astype(np.float32)
    bounds = np.cumsum((0,) + REQUESTS)
    reqs = [images[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    x = torch.from_numpy(reqs[0]).cuda().to(dtype)

    def device_forward(name, scales=None, kernel=None):
        """CUDA-event ms of one batch-64 forward and its profile, float
        (``kernel`` None) or under int8 serving (bf16: with f32 reduction)."""
        def fwd(*_):
            with torch.inference_mode(), precision.f32_accumulation(), (
                    contextlib.nullcontext() if kernel is None
                    else Q.int8_serving(model, scales, kernel=kernel)):
                return model(x)
        ms = time_ms(torch, fwd, iters=10)
        profile = phase_profile(torch, fwd, None, None, None, f"{tag} {name}",
                                steps=3, what="forwards at batch 64")
        return ms, profile, fwd

    float_pred = Predictor(model, batch_size=BATCH, device="cuda")
    ref = np.concatenate([float_pred.logits(r) for r in reqs])
    out = {}
    if measure:
        fwd_ms, profile, _ = device_forward("float")
        out["float"] = {"images_per_s": serve_rate(torch, float_pred, reqs[0]),
                        "device_forward_ms": fwd_ms, "profile": profile}
        # the Linear layers an int8 forward quantizes (those that run), and
        # the time of quantizing their weights, once over
        with torch.inference_mode(), Q.calibrating(model) as ran:
            model(x)
        modules = dict(model.named_modules())
        weights = [modules[name].weight for name in ran]
        with torch.inference_mode():
            wq_ms = time_ms(torch, lambda: [Q._quantize(w, dim=-1) for w in weights],
                            iters=10)
        out["weight_quantize_ms"] = wq_ms
        print(f"[int8] {tag} float: {out['float']['images_per_s']:.1f} images/s host to "
              f"host; device forward {fwd_ms:.3f} ms; quantizing the weights of the "
              f"{len(weights)} Linear layers that run, per output channel, once over: "
              f"{wq_ms:.3f} ms (every int8 forward does it again)  [{smi}]")
    for route in routes:
        kernel = route != "qdot"
        pred = Predictor(model, batch_size=BATCH, device="cuda", quant="int8",
                         int8_kernel=kernel)
        if route == "calibrated":
            pred.calibrate(images)
        reset_counts()
        logits = np.concatenate([pred.logits(r) for r in reqs])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want.update({k: len(REQUESTS) * n for k, n in
                     INT8_PER_BATCH[tag]["kernel" if kernel else "qdot"].items()})
        check(counts == want, f"int8 {tag} {route}: launch counts "
                              f"{ {k: n for k, n in counts.items() if n} } != "
                              f"{ {k: n for k, n in want.items() if n} }")
        check(logits.dtype == np.float32 and bool(np.isfinite(logits).all()),
              f"int8 {tag} {route}: logits {logits.dtype}, not finite")
        agree, dprob = top1_and_probs(logits, ref)
        # the same 4-image batch on the card and the CPU (qdot's per-tensor
        # scale is the batch's)
        few = reqs[0][:4]
        on = {}
        for dev, net in (("cuda", model), ("cpu", model_cpu)):
            small = Predictor(net, batch_size=len(few), device=dev, quant="int8",
                              int8_kernel=kernel)
            small.scales = pred.scales
            on[dev] = small.logits(few)
        cpu_err = float(np.abs(on["cuda"] - on["cpu"]).max())
        limit = TOL_INT8_LOGITS * max(1.0, float(np.abs(on["cpu"]).max()))
        replay = replay_blocks(torch, model, model_cpu,
                               torch.from_numpy(few).cuda().to(dtype), pred.scales, kernel)
        f32_gap = ""
        if not chained_gate:  # the same path on the f32 model
            on32 = [Predictor(net, batch_size=len(few), device=dev, quant="int8",
                              int8_kernel=kernel).logits(few)
                    for dev, net in (("cuda", copy.deepcopy(model_f32).to("cuda")),
                                     ("cpu", model_f32))]
            gap = float(np.abs(on32[0] - on32[1]).max()) / max(1.0, float(
                np.abs(on32[1]).max()))
            f32_gap = (f" (not gated; the f32 model on this path: {gap:.3e} of max(1, "
                       "max|logit|))")
        print(f"[int8] {tag} {route}: launches over {len(REQUESTS)} batches "
              f"{ {k: n for k, n in counts.items() if n} }; top-1 agreement with the "
              f"float logits {agree:.4f} (gate 0.9), max probability change {dprob:.4f} "
              f"(gate 0.2), max|logit - float| {float(np.abs(logits - ref).max()):.4f}; "
              f"4 images against the CPU's int8 forward: max|err| {cpu_err:.3e}  limit "
              f"{limit:.3e}{f32_gap}; replayed a block at a time from the card's inputs, "
              f"err / max(1, max|out|) by block, then the head: "
              + " ".join(f"{e:.2e}" for e in replay) + f"  limit {TOL_INT8_LOGITS:.0e}")
        check(agree >= 0.9 and dprob < 0.2, f"int8 {tag} {route}: off the float logits "
                                            "beyond kanvit's gates")
        check(cpu_err <= limit or not chained_gate,
              f"int8 {tag} {route}: card logits differ from the CPU's by {cpu_err}")
        check(max(replay) <= TOL_INT8_LOGITS, f"int8 {tag} {route}: a block replayed on "
                                              f"the CPU differs by {max(replay):.3e}")
        out[route] = {"top1_agreement": agree, "max_prob_change": dprob,
                      "cpu_logits_err": cpu_err, "replay_errs": replay, "launches": counts}
        if measure:
            ips = serve_rate(torch, pred, reqs[0])
            fwd_ms, profile, fwd = device_forward(route, pred.scales, kernel)
            out[route].update(images_per_s=ips, device_forward_ms=fwd_ms, profile=profile)
            extra = ""
            if route == "qdot" and bf16:
                out[route]["widening"] = widen = widening_casts(torch, fwd)
                extra = (f"; the widening casts a forward: {widen['tensors_widened']} "
                         f"tensors, {widen['device_kernels']} device kernels, "
                         f"{widen['device_ms']:.3f} ms of device, {widen['host_ms']:.3f} ms "
                         f"of host in the promote calls")
            print(f"[int8] {tag} {route}: {ips:.1f} images/s host to host; device forward "
                  f"{fwd_ms:.3f} ms (float {out['float']['device_forward_ms']:.3f} "
                  f"ms){extra}  [{smi}]")
    return out


def int8_bf16_phases(torch, smi):
    """Phase 11b, a bf16 model served int8: vit-b vanilla at full depth on
    the three routes, measured; then gates and counts alone at 4 blocks:
    vit-b flash-attn on the kernel route (its chained gap read, not gated),
    vit-s efficientkan on qdot (its later blocks on the f32 KAN kernels over
    widened weights). The launches of each, by path."""
    vit_b = timed("  vit-b vanilla bf16 int8 serving", phase_int8_serve, torch, smi,
                  build_model("vanilla", "vit-b"), "vit-b vanilla bf16", True)
    flash = timed("  vit-b flash-attn bf16 int8 serving, 4 blocks", phase_int8_serve,
                  torch, smi, build_model("flash-attn", "vit-b", n_blocks=4),
                  "vit-b flash-attn at 4 of 12 blocks bf16", True, ("kernel",), False, False)
    kan = timed("  vit-s efficientkan bf16 int8 serving, 4 blocks", phase_int8_serve,
                torch, smi, build_model("efficientkan", n_blocks=4),
                "vit-s efficientkan at 4 of 12 blocks bf16", True, ("qdot",), False)
    return {"int8_bf16_serve": vit_b["kernel"]["launches"],
            "int8_bf16_flash": flash["kernel"]["launches"],
            "int8_bf16_efficientkan": kan["qdot"]["launches"]}


# --------------------------------------------------------------------------
# Phase 12: the repaired faults: head dim 8 and refit grids
# --------------------------------------------------------------------------

def train_steps(torch, model_cpu, per_step_fwd, steps, batch, tag):
    """``steps`` Adam steps on one batch through ``kanvit_torch.train``:
    exact forward and backward launches a step, losses finite and falling,
    and the 4-image gradient gate. Returns the launch counts."""
    from kanvit_torch.train import create_train_state, make_train_step

    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 12)
    x = torch.from_numpy(rng.standard_normal((batch, *model_cpu.chw))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, model_cpu.out_d, batch)).cuda()
    state, step = create_train_state(model, 1e-3), make_train_step()
    per_step = {k: 0 for k in launch_counts()}
    per_step.update(per_step_fwd)
    per_step.update({f"{k}_bwd": n for k, n in per_step_fwd.items()})
    reset_counts()
    losses, steps_ok = [], True
    for _ in range(steps):
        before = launch_counts()
        state, loss, _ = step(state, x, y)
        after = launch_counts()
        steps_ok &= {k: after[k] - before[k] for k in after} == per_step
        losses.append(float(loss))
    counts = launch_counts()
    print(f"[{tag}] {steps} Adam(1e-3) steps at batch {batch}: losses "
          f"{[round(v, 6) for v in losses]}; launches {({k: n for k, n in counts.items() if n})}")
    check(steps_ok, f"{tag}: a step's launches differ from {per_step}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{tag}: losses not finite or not falling: {losses}")
    grad_gate(torch, model_cpu, x[:GRAD_IMAGES].cpu(), y[:GRAD_IMAGES].cpu(), tag)
    return counts


def moved_grids(torch, model_cpu, seed):
    """``model_cpu`` with every MSA knot grid scaled and shifted per head and
    projection, as refits leave them."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for blk in model_cpu.blocks:
            for maps in (blk.attn.q_mappings, blk.attn.k_mappings, blk.attn.v_mappings):
                for m in maps:
                    m.grid.mul_(float(rng.uniform(0.8, 1.3))).add_(
                        float(rng.uniform(-0.3, 0.3)))
    return model_cpu


def phase_faults(torch, smi):
    """The reference's own geometry, head dim 8, on the card:
    ``load_predictor``'s defaults (MNIST, d 64, 8 heads, 8 blocks) serving a
    request, and the CIFAR geometry (32x32 in 4x4 patches, 17 tokens, d 64,
    8 heads) training efficientkan and vanilla; then a vit-s efficientkan
    model with refit grids per head serving (three grouped launches a
    block)."""
    from kanvit_torch.infer import load_predictor
    from kanvit_torch.models import create_model

    paths = {}
    src = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, out_d=10, seed=SEED)
    blocks = len(src.blocks)
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    npz = out_dir / "mnist_efficientkan.npz"
    np.savez(npz, **{k: v.numpy() for k, v in src.state_dict().items()})
    images = np.random.default_rng(SEED + 13).standard_normal(
        (BATCH, 1, 28, 28)).astype(np.float32)
    reset_counts()
    pred = load_predictor("efficientkan", str(npz))
    logits = pred.logits(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(bspline_kan=1, bspline_qkv_grouped=blocks, flash_attention_lanes=blocks)
    with torch.inference_mode():
        err = float(np.abs(logits[:4] - src(torch.from_numpy(images[:4])).numpy()).max())
    print(f"[faults] load_predictor defaults (MNIST, d 64, 8 heads of 8, {blocks} "
          f"blocks): launches {({k: n for k, n in counts.items() if n})}; logits of 4 "
          f"images against the CPU: max|err| {err:.3e}  limit {TOL_LOGITS:.0e}")
    check(counts == want, f"load_predictor: launch counts {counts} != {want}")
    check(err <= TOL_LOGITS, f"load_predictor: GPU logits differ by {err}")
    paths["mnist_serve"] = counts

    for variant in ("efficientkan", "vanilla"):
        model_cpu = create_model(variant, seed=SEED)  # the CIFAR defaults
        blocks = len(model_cpu.blocks)
        per_step = {"flash_attention_lanes": blocks}
        if variant == "efficientkan":
            per_step.update(bspline_kan=1, bspline_qkv_grouped=blocks)
        paths[f"cifar_train_{variant}"] = train_steps(
            torch, model_cpu, per_step, 3, BATCH, f"faults cifar {variant}")

    model_cpu = moved_grids(torch, build_model("efficientkan"), SEED + 14)
    blocks = len(model_cpu.blocks)
    paths["refit_serve"] = phase_serve(
        torch, smi, model_cpu, "refit-serve",
        {"bspline_kan": 1, "bspline_qkv_grouped": 3 * blocks,
         "flash_attention_lanes": blocks}, SEED + 15)["launches"]
    return paths


# --------------------------------------------------------------------------
# Phase 13: decoder training
# --------------------------------------------------------------------------

def decoder_parts(torch, model, tokens, bf16=False):
    """Device ms of forward + loss, backward and an Adam step (CUDA events),
    medians of 3; ``bf16``: the step in kanvit's bf16 policy."""
    from kanvit_torch import bench_decoder as BD
    from kanvit_torch.utils import precision

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for _ in range(3):
        opt.zero_grad()
        with precision.f32_accumulation():
            (loss, _), ev_f = device_ms(torch, lambda: BD.loss_and_logits(
                model, tokens, bf16=bf16))
            _, ev_b = device_ms(torch, loss.backward)
        _, ev_o = device_ms(torch, opt.step)
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_f, ev_b, ev_o)):
            parts[key].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in parts.items()}


def decoder_grads_against_cpu(torch, tokens, bf16=False, config=DECODER):
    """Parameter gradients of a 1-sequence batch on the card against the
    same model's on the CPU (``bf16``: both in kanvit's bf16 policy, the CPU
    through the kernels' plain twins); prints each tensor's max|g| and
    max|err| / max|g|, and returns the worst of those and its tensor. Each
    tensor is held to its own max|g|: this decoder's gradients are all
    below 1, where kanvit's max(1, max|g|) would make the bf16 gate an
    absolute one that a zeroed gradient passes."""
    from kanvit_torch import bench_decoder as BD
    from kanvit_torch.utils import precision

    cpu = BD.build_model(**config, seed=SEED)
    gpu = copy.deepcopy(cpu).cuda()
    one = tokens[:1]
    with precision.f32_accumulation():
        BD.loss_and_logits(gpu, one, bf16=bf16)[0].backward()
        BD.loss_and_logits(cpu, one.cpu(), bf16=bf16)[0].backward()
    worst, worst_name, rows = 0.0, "", []
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(pc.grad.abs().max())
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        rows.append(f"{name} max|g| {scale:.3e} err {rel:.3e}")
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[decoder] {'bf16' if bf16 else 'f32'} gradients, GPU against CPU: "
          + "; ".join(rows))
    return worst, worst_name


def phase_decoder(torch, smi, bf16=False, heads=None):
    """Phase 13 (``bf16``: 13b, kanvit's bf16 policy, its tiled attention on
    the bf16 kernels, with the f32 step's tokens/s beside it; ``heads``:
    13c, the bf16 decoder in that many heads, ``bench_decoder --bf16
    --heads 2``'s dh 128 on the padded bf16 kernels, with the tokens/s of
    the decoder's own heads beside it in the same turns)."""
    from kanvit_torch import bench_decoder as BD

    config = DECODER if heads is None else {**DECODER, "heads": heads}
    dh = config["dim"] // config["heads"]
    blocks = config["n_blocks"]
    sfx = "_bf16" if bf16 else ""
    per_step = {k: 0 for k in launch_counts()}
    per_step.update({f"flash_attention{sfx}": blocks, f"flash_attention_dq{sfx}": blocks,
                     f"flash_attention_dkv{sfx}": blocks})
    launches = {k: 0 for k in per_step}
    tol = TOL_BF16_GRADS if bf16 else TOL_GRADS
    precision_tag = ("bf16" if bf16 else "f32") + ("" if heads is None else f" dh {dh}")
    out = []
    for seq, batch in DECODER_CONFIGS:
        model = BD.build_model(**config, seed=SEED).cuda()
        tokens = BD.make_tokens(batch, seq, DECODER["vocab"], SEED).cuda()
        step = BD.make_step(model, bf16=bf16)
        reset_counts()
        losses, steps_ok = [], True
        for _ in range(TRAIN_STEPS):
            before = launch_counts()
            losses.append(step(tokens))
            after = launch_counts()
            steps_ok &= {k: after[k] - before[k] for k in after} == per_step
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: launches[k] + counts[k] for k in launches}
        losses = [float(v) for v in losses]
        label = f"decoder {precision_tag} seq {seq} batch {batch}"
        print(f"[decoder] {label}, {TRAIN_STEPS} Adam(1e-3) steps on one batch: "
              f"losses {[round(v, 6) for v in losses]}")
        print(f"[decoder] launches over {TRAIN_STEPS} steps: {counts} (want per "
              f"step {blocks} {precision_tag} tiled forward, {blocks} dq, {blocks} dk/dv, "
              "nothing else)")
        check(steps_ok, f"{label}: a step's launches differ from {per_step}")
        check(all(np.isfinite(losses)), f"{label}: losses are not finite: {losses}")
        check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
        result = {"seq": seq, "batch": batch, "losses": losses}
        if seq == DECODER_CONFIGS[0][0]:
            worst, name = decoder_grads_against_cpu(torch, tokens, bf16, config)
            print(f"[decoder] {label}: gradients of 1 sequence, GPU against CPU"
                  f"{' (its plain twins)' if bf16 else ''}, per tensor: worst max|err| / "
                  f"max|g| {worst:.3e} ({name})  limit {tol:.0e}")
            check(worst <= tol, f"{label}: GPU gradients differ from the CPU's: {name} "
                                f"{worst:.3e}")
            result["grad_rel_err"] = worst
        parts = decoder_parts(torch, model, tokens, bf16)
        total = sum(parts.values())
        print(f"[decoder] {label}: device ms per step: " + ", ".join(
            f"{k} {v:.2f} ({v / total:.1%})" for k, v in parts.items()))
        result["parts_ms"] = parts
        result["profile"] = phase_profile(torch, lambda *_: step(tokens), None, None,
                                          None, label)
        # bf16: the kernel impl in turns with f32's, on one seed's weights;
        # 13c: in turns with the decoder's own heads in bf16
        own = DECODER["heads"]
        if heads is not None:
            runs = [("kernel", True, heads), ("kernel", True, own), ("kernel", True, own),
                    ("kernel", True, heads)]
        elif bf16:
            runs = [("kernel", True, own), ("kernel", False, own), ("kernel", True, own),
                    ("kernel", False, own)]
        else:
            runs = [("kernel", False, own)] + (
                [("plain", False, own)] if seq == DECODER_CONFIGS[0][0] else [])
        for impl, in_bf16, n_heads in runs:
            r = BD.bench_config(seq, batch, **{**DECODER, "heads": n_heads}, steps=5,
                                warmup=2, impl=impl, seed=SEED, bf16=in_bf16)
            print(f"[decoder] {json.dumps(r)}")
            print(f"[decoder] {label} impl={impl} bf16={in_bf16} heads={n_heads} (dh "
                  f"{DECODER['dim'] // n_heads}): {r['tokens_per_sec']:.1f} tokens/s, "
                  f"{r['step_ms']:.2f} ms per step  [{smi}]")
            check(np.isfinite(r["loss"]) and r["step_ms"] > 0, f"{label}: bench result")
            key = (impl if not bf16 else "bf16" if in_bf16 else "f32") if heads is None \
                else f"dh_{DECODER['dim'] // n_heads}"
            result.setdefault(key, []).append(r)
        out.append(result)
        del model, step
        torch.cuda.empty_cache()
    return {"launches": launches, "configs": out}


# --------------------------------------------------------------------------
# Phase 14: the reference preset through the port's bench
# --------------------------------------------------------------------------

def phase_bench(torch, smi):
    from kanvit_torch import bench

    args = bench.parse_args(["--preset", "reference", "--batch-size", "128",
                             "--steps", "20", "--windows", "3", "--warmup", "5"])
    out = bench.run(args)
    print(f"[bench] {json.dumps(out)}")
    print(f"[bench] reference preset, batch 128: {out['value']} images/s, "
          f"{out['step_time_ms']} ms per step  [{smi}]")
    check(out["value"] > 0 and np.isfinite(out["step_time_ms"]), "bench result")
    args = bench.parse_args(["--preset", "vit-s", "--bf16", "--batch-size", str(BATCH),
                             "--steps", "10", "--windows", "3", "--warmup", "3"])
    bf = bench.run(args)
    print(f"[bench] {json.dumps(bf)}")
    print(f"[bench] python -m kanvit_torch.bench --preset vit-s --bf16, batch {BATCH}: "
          f"{bf['value']} images/s, {bf['step_time_ms']} ms per step  [{smi}]")
    check(bf["bf16"] is True and bf["value"] > 0 and np.isfinite(bf["step_time_ms"]),
          "bf16 bench result")

    # where the reference step's time goes
    from kanvit_torch.models import PRESETS, create_model
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["reference"]
    state = create_train_state(create_model("efficientkan", **geom, seed=SEED).cuda())
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((128, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], 128)).cuda()
    step = make_train_step()
    for _ in range(3):
        step(state, x, y)
    phase_profile(torch, step, state, x, y, "reference", steps=3)
    return out


# --------------------------------------------------------------------------
# Phase 15: results
# --------------------------------------------------------------------------

KAN_SRC = "kanvit_torch/kernels/csrc/kan_basis.cu"
RBF_SINE_SRC = "kanvit_torch/kernels/csrc/kan_rbf_sine.cu"
KAN_TC_SRC = "kanvit_torch/kernels/csrc/kan_basis_tc.cuh"
FB_PY = "kanvit/kernels/fused_basis.py"
SOURCES = {
    "bspline_kan": (KAN_TC_SRC, f"{FB_PY}:1067"),
    "bspline_qkv_grouped": (KAN_TC_SRC, f"{FB_PY}:1240"),
    "flash_attention_lanes": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                              "kanvit/kernels/flash_attention.py:571"),
    "bspline_kan_bwd": (KAN_TC_SRC, f"{FB_PY}:1159"),
    "bspline_qkv_grouped_bwd": (KAN_TC_SRC, f"{FB_PY}:1278"),
    "flash_attention_lanes_bwd": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                  "kanvit/kernels/flash_attention.py:604"),
    "flash_attention": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                        "kanvit/kernels/flash_attention.py:132"),
    "flash_attention_dq": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                           "kanvit/kernels/flash_attention.py:806"),
    "flash_attention_dkv": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                            "kanvit/kernels/flash_attention.py:831"),
    "chebykan": (KAN_TC_SRC, f"{FB_PY}:1067"),
    "chebykan_bwd": (KAN_TC_SRC, f"{FB_PY}:1159"),
    "cheby_qkv_grouped": (KAN_TC_SRC, f"{FB_PY}:1240"),
    "cheby_qkv_grouped_bwd": (KAN_TC_SRC, f"{FB_PY}:1278"),
    "fourierkan": (KAN_TC_SRC, f"{FB_PY}:2317"),
    "fourierkan_bwd": (KAN_TC_SRC, f"{FB_PY}:2564"),
    "fastkan": (KAN_TC_SRC, f"{FB_PY}:2947"),
    "fastkan_bwd": (KAN_TC_SRC, f"{FB_PY}:2995"),
    "fastkan_qkv_grouped": (KAN_TC_SRC, f"{FB_PY}:3191"),
    "fastkan_qkv_grouped_bwd": (KAN_TC_SRC, f"{FB_PY}:3246"),
    "sinekan": (KAN_TC_SRC, f"{FB_PY}:2317"),
    "sinekan_bwd": (KAN_TC_SRC, f"{FB_PY}:2523"),
    "sinekan_qkv_grouped": (KAN_TC_SRC, f"{FB_PY}:1518"),
    "sinekan_qkv_grouped_bwd": (KAN_TC_SRC, f"{FB_PY}:1557"),
    "ffn_pre_ln": ("kanvit_torch/kernels/csrc/fused_ffn.cu",
                   "kanvit/kernels/fused_ffn.py:177"),
    "ffn_pre_ln_bwd": ("kanvit_torch/kernels/csrc/fused_ffn.cu",
                       "kanvit/kernels/fused_ffn.py:217"),
    "ffn_pre_ln_bf16": ("kanvit_torch/kernels/csrc/fused_ffn_bf16.cu",
                        "kanvit/kernels/fused_ffn.py:177"),
    "ffn_pre_ln_bwd_bf16": ("kanvit_torch/kernels/csrc/fused_ffn_bf16.cu",
                            "kanvit/kernels/fused_ffn.py:217"),
    "int8_linear": ("kanvit_torch/kernels/csrc/int8_matmul.cu",
                    "kanvit/kernels/int8_matmul.py:134"),
    "int8_linear_bf16": ("kanvit_torch/kernels/csrc/int8_matmul.cu",
                         "kanvit/kernels/int8_matmul.py:134"),
    "bspline_kan_bf16": (KAN_TC_SRC, f"{FB_PY}:1067"),
    "bspline_qkv_grouped_bf16": (KAN_TC_SRC, f"{FB_PY}:1240"),
    "flash_attention_lanes_bf16": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                   "kanvit/kernels/flash_attention.py:571"),
    "bspline_kan_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:1159"),
    "bspline_qkv_grouped_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:1278"),
    "flash_attention_lanes_bwd_bf16": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                       "kanvit/kernels/flash_attention.py:604"),
    "chebykan_bf16": (KAN_TC_SRC, f"{FB_PY}:1067"),
    "cheby_qkv_grouped_bf16": (KAN_TC_SRC, f"{FB_PY}:1240"),
    "chebykan_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:1159"),
    "cheby_qkv_grouped_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:1278"),
    "fastkan_bf16": (KAN_TC_SRC, f"{FB_PY}:2947"),
    "fastkan_qkv_grouped_bf16": (KAN_TC_SRC, f"{FB_PY}:3191"),
    "fastkan_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:2995"),
    "fastkan_qkv_grouped_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:3246"),
    "sinekan_bf16": (KAN_TC_SRC, f"{FB_PY}:2317"),
    "sinekan_qkv_grouped_bf16": (KAN_TC_SRC, f"{FB_PY}:1518"),
    "sinekan_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:2523"),
    "sinekan_qkv_grouped_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:1557"),
    "fourierkan_bf16": (KAN_TC_SRC, f"{FB_PY}:2317"),
    "fourierkan_bwd_bf16": (KAN_TC_SRC, f"{FB_PY}:2564"),
    "flash_attention_bf16": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                             "kanvit/kernels/flash_attention.py:132"),
    "flash_attention_dq_bf16": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                                "kanvit/kernels/flash_attention.py:806"),
    "flash_attention_dkv_bf16": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                                 "kanvit/kernels/flash_attention.py:831"),
}
# The single-tile tier of flash_attention runs the lanes kernels (phase 5);
# fourierkan's and sinekan's kernels serve kanvit's generic tier below its
# K-blocked one too, and their backward both the K-blocked dx and dW (sine's
# opt-in split-residual pair and basis-saving forward, and sinekan_qkv, are
# the same functions); fastkan's, with the LayerNorm or the silu slice off,
# serve _rbf_base_op and _rbf_op.
ALSO_REPLACES = {
    "flash_attention_lanes": ["kanvit/kernels/flash_attention.py:410"],
    "flash_attention_lanes_bwd": ["kanvit/kernels/flash_attention.py:442"],
    "bspline_kan": [f"{FB_PY}:777"],
    "bspline_kan_bf16": [f"{FB_PY}:777", f"{FB_PY}:969"],
    "flash_attention_lanes_bf16": ["kanvit/kernels/flash_attention.py:410"],
    "bspline_kan_bwd_bf16": [f"{FB_PY}:810", f"{FB_PY}:1006"],
    "chebykan_bf16": [f"{FB_PY}:777", f"{FB_PY}:969"],
    "chebykan_bwd_bf16": [f"{FB_PY}:810", f"{FB_PY}:1006"],
    "flash_attention_lanes_bwd_bf16": ["kanvit/kernels/flash_attention.py:442"],
    "bspline_kan_bwd": [f"{FB_PY}:810", f"{FB_PY}:969", f"{FB_PY}:1006"],
    "fourierkan": [f"{FB_PY}:1067"],
    "fourierkan_bwd": [f"{FB_PY}:2492", f"{FB_PY}:1159"],
    "fastkan": [f"{FB_PY}:2726", f"{FB_PY}:1067"],
    "fastkan_bwd": [f"{FB_PY}:2769", f"{FB_PY}:1159"],
    "sinekan": [f"{FB_PY}:1067", f"{FB_PY}:2354"],
    "sinekan_bwd": [f"{FB_PY}:2492", f"{FB_PY}:1728", f"{FB_PY}:2401",
                    f"{FB_PY}:2433"],
    "sinekan_bf16": [f"{FB_PY}:1067", f"{FB_PY}:2354"],
    "sinekan_bwd_bf16": [f"{FB_PY}:2492", f"{FB_PY}:1728", f"{FB_PY}:2401",
                         f"{FB_PY}:2433"],
    "fourierkan_bf16": [f"{FB_PY}:1067"],
    "fourierkan_bwd_bf16": [f"{FB_PY}:2492", f"{FB_PY}:1159"],
}
# The Fourier and sine embedders' routes: the tensor-core kernels
# (kan_basis_tc.cuh, instantiated in the family's source), dx on the
# CUDA-core template.
TC_FWD = "3xTF32 mma.sync.m16n8k8 over a basis generated on chip (kan_tc_kernel<{}, false>)"
TC_BWD = ("dW{} on 3xTF32 mma.sync.m16n8k8 (kan_tc_kernel<{}, true>); dx, where "
          "asked, on the CUDA-core kan_dx_kernel")
# The bf16 attention kernels' head dims (attention_tc.cuh, BF16_PAD_DH).
PADDED_DH = ("; dh 8/16/32/64 on their own instantiations, every other multiple of 8 "
             "through 128 on <128, true>: rows zero past dh, the products over all 128 "
             "columns, stores stopping at dh")
PADDED_DKV = (", a padded dk/dv block holding 64 of dh's columns (ceil(dh / 64) blocks a "
              "key tile, each recomputing the scores)")
ROUTES = {
    "int8_linear_bf16": {
        "kernel": "int8_linear_kernel<48, 128, 2, __nv_bfloat16> (32 or 16 rows a block as "
                  "K grows): bf16 x read 8 bytes for 4 values and widened, rows quantized "
                  "once into shared memory, W through a ring of two 128-byte cp.async "
                  "stages, mma.sync s8 fed by ldmatrix, the f32 epilogue rounded once to "
                  "bf16 pairs",
        "instantiated_in": "kanvit_torch/kernels/csrc/int8_matmul.cu"},
    "bspline_kan": {
        "kernel": "the grouped q/k/v forward's template at one group: 3xTF32 "
                  "mma.sync.m16n8k8, kan_tc_fwd_grouped<Bspline, NT, 12, 1, Tf32x3, 12>, "
                  "each lane's A fragments the basis of its own x values made in registers, "
                  "W split once a call by kan_tc_fwd_split, the 768-deep sum in two levels "
                  "(the running sum of every 12 stages added into y)",
        "instantiated_in": KAN_SRC},
    "bspline_kan_bwd": {
        "kernel": "the grouped q/k/v backward's templates at one group: dW on 3xTF32 "
                  "mma.sync.m16n8k8, kan_tc_dw_grouped<Bspline, NJ> over a basis generated "
                  "on chip, in row splits filling whole waves, summed in a fixed order; dx, "
                  "where asked, from kan_tc_dx_kernel<Bspline> with B' in its epilogue",
        "instantiated_in": KAN_SRC},
    "bspline_qkv_grouped": {
        "kernel": "3xTF32 mma.sync.m16n8k8: kan_tc_fwd_grouped<Bspline, NT>, each lane's A "
                  "fragments the basis of its own x values made in registers, W split "
                  "once a call by kan_tc_fwd_split; both MSA routes (a shared grid, a "
                  "grid a head)",
        "instantiated_in": KAN_SRC},
    "cheby_qkv_grouped": {
        "kernel": "3xTF32 mma.sync.m16n8k8: kan_tc_fwd_grouped<Cheby, 8, 8, 3> (64 outputs "
                  "a block at every width), each lane's A fragments T_0..T_4 of tanh of its "
                  "own x values made in registers, W split once a call by kan_tc_fwd_split",
        "instantiated_in": KAN_SRC},
    "chebykan": {
        "kernel": "the grouped q/k/v forward's template at one group: 3xTF32 "
                  "mma.sync.m16n8k8, kan_tc_fwd_grouped<Cheby, 8, 12, 1, Tf32x3, 24> (64 "
                  "outputs a block), each lane's A fragments T_0..T_4 of tanh of its own x "
                  "values made in registers, W split once a call by kan_tc_fwd_split, the "
                  "768-deep sum in two levels (the running sum of every 24 stages added "
                  "into y)",
        "instantiated_in": KAN_SRC},
    "chebykan_bwd": {
        "kernel": "the grouped q/k/v backward's templates at one group: dW on 3xTF32 "
                  "mma.sync.m16n8k8, kan_tc_dw_grouped<Cheby, NJ> over T_0..T_4 of tanh x "
                  "generated on chip, in row splits filling whole waves, summed in a fixed "
                  "order; dx, where asked, from kan_tc_dx_kernel<Cheby> with T'_n (0 where "
                  "tanh rounds to +-1) in its epilogue",
        "instantiated_in": KAN_SRC},
    "cheby_qkv_grouped_bwd": {
        "kernel": "dW and dx on 3xTF32 mma.sync.m16n8k8: kan_tc_dw_grouped<Cheby, NJ> "
                  "over a basis generated on chip, in row splits summed in a fixed order; "
                  "kan_tc_dx_kernel<Cheby> with T'_n (0 where tanh rounds to +-1) in its "
                  "epilogue",
        "instantiated_in": KAN_SRC},
    "bspline_qkv_grouped_bwd": {
        "kernel": "dW and dx on 3xTF32 mma.sync.m16n8k8: kan_tc_dw_grouped<Bspline, NJ> "
                  "over a basis generated on chip, in row splits summed in a fixed order; "
                  "kan_tc_dx_kernel<Bspline> with B' in its epilogue",
        "instantiated_in": KAN_SRC},
    "fastkan_qkv_grouped": {
        "kernel": "the LayerNorm's statistics (ln_stats_kernel), then 3xTF32 "
                  "mma.sync.m16n8k8: kan_tc_fwd_grouped<Rbf, 8, ...>, each lane's A "
                  "fragments the RBF basis of its own x values made in registers from its "
                  "rows' statistics, W split once a call by kan_tc_fwd_split",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_qkv_grouped": {
        "kernel": "G <= 4: 3xTF32 mma.sync.m16n8k8: kan_tc_fwd_grouped<Sine, 8, ...>, each "
                  "lane's A fragments the sine basis of its own x values made in registers, "
                  "W split once a call by kan_tc_fwd_split; G > 4 on the CUDA-core "
                  "kan_fwd_kernel",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan_qkv_grouped_bwd": {
        "kernel": "dW and dx on 3xTF32 mma.sync.m16n8k8: kan_tc_dw_grouped<Rbf, NJ> over a "
                  "basis generated on chip, in row splits summed in a fixed order; "
                  "kan_tc_dx_kernel<Rbf> with the RBF fold (dln, the silu term) in its "
                  "epilogue; the LayerNorm's VJP, dgamma and dbeta on ln_dx_kernel and "
                  "ln_dgb_kernel",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan": {
        "kernel": "the LayerNorm's statistics (ln_stats_kernel), then the grouped q/k/v "
                  "forward's template at one group: 3xTF32 mma.sync.m16n8k8, "
                  "kan_tc_fwd_grouped<Rbf, 8, 12, 1, Tf32x3, 12> (64 outputs a block), each "
                  "lane's A fragments the RBF basis of its own x values made in registers, "
                  "the silu slice in a second running sum with exact products, W split once "
                  "a call by kan_tc_fwd_split, the 768-deep sum in two levels (the running "
                  "sums of every 12 stages added into y)",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan_bwd": {
        "kernel": "the grouped q/k/v backward's templates at one group: dW on 3xTF32 "
                  "mma.sync.m16n8k8, kan_tc_dw_grouped<Rbf, 3> over a basis generated on "
                  "chip, in row splits filling whole waves, summed in a fixed order; dln "
                  "from kan_tc_dx_kernel<Rbf> (the RBF fold in its epilogue; the silu term "
                  "too where dx is asked); the LayerNorm's dgamma and dbeta (and its VJP "
                  "for dx) on ln_dgb_kernel and ln_dx_kernel",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_qkv_grouped_bwd": {
        "kernel": "G <= 4: dW and dx on 3xTF32 mma.sync.m16n8k8: kan_tc_dw_grouped<Sine, NJ> "
                  "over a basis generated on chip, in row splits summed in a fixed order; "
                  "kan_tc_dx_kernel<Sine> with the sine fold (dx, dfreq's block sums) in "
                  "its epilogue, sum_blocks_kernel; G > 4 on the CUDA-core kernels",
        "instantiated_in": RBF_SINE_SRC},
    "bspline_kan_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Bspline, "
                  "NT, 12, 1, Bf16, 0> at one group (the bf16 q/k/v's template), the basis "
                  "made in f32 in registers and rounded to bf16 at the dot, two slices a "
                  "16-deep step, W split once a call into bf16 pairs by kan_tc_fwd_split, one "
                  "running sum, y rounded to bf16 once",
        "instantiated_in": KAN_SRC},
    "bspline_qkv_grouped_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Bspline, "
                  "NT, 12, 1, Bf16, 0>, the basis made in f32 in registers and rounded to "
                  "bf16 at the dot, two slices a 16-deep step, W split once a call into bf16 "
                  "pairs by kan_tc_fwd_split; both MSA routes (a shared grid, a grid a head)",
        "instantiated_in": KAN_SRC},
    "flash_attention_lanes_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: attention_lanes_fwd_bf16<dh>, "
                  "q scaled in bf16, K by ldmatrix and V by ldmatrix.trans from cp.async "
                  "tiles, two passes over the keys (the row max, then p against it: the "
                  "policy's whole-row softmax), p rounded to bf16 for P V, o rounded once"
                  + PADDED_DH},
    "bspline_kan_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4 at "
                  "one group: dW on kan_bf16_dw<Bspline, 3> over a basis made in f32 on chip "
                  "and rounded to bf16 at the dot, gy by ldmatrix.trans, row splits in f32 "
                  "partials summed in split order and rounded once (sum_splits_bf16_kernel); "
                  "dx, where asked, on kan_bf16_dx<Bspline>, B' in f32 in its epilogue, "
                  "rounded once",
        "instantiated_in": KAN_SRC},
    "bspline_qkv_grouped_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4: "
                  "kan_bf16_dw<Bspline, NJ> (the basis made in f32 and rounded to bf16 at "
                  "the dot, row splits in f32 partials, one rounding) and "
                  "kan_bf16_dx<Bspline> (gy W^T in f32, B' in the epilogue, one rounding); "
                  "both MSA routes (a shared grid, a grid a head)",
        "instantiated_in": KAN_SRC},
    "flash_attention_lanes_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: attention_lanes_dq_bf16<dh> "
                  "(writes delta) then attention_lanes_dkv_bf16<dh>, the forward's (m, l), "
                  "pn and dsc rounded to bf16 at their dots, qs by the bf16 scale and dq by "
                  "the f32 one; K, V, do tiles by cp.async and ldmatrix" + PADDED_DH
                  + PADDED_DKV},
    "flash_attention_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: flash_fwd_bf16<dh>, one "
                  "pass over 32-key tiles (K by ldmatrix, V by ldmatrix.trans, cp.async, "
                  "double buffered), the f32 product scaled by the f32 dh^-1/2, online "
                  "softmax in f32, p rounded to bf16 for P V against its tiles' running "
                  "max, o = bf16(acc / l); the causal frontier, longest blocks first"
                  + PADDED_DH},
    "flash_attention_dq_bf16": {
        "kernel": "bf16 wgmma.mma_async m64nNk16 with f32 accumulation on TMA-fed tiles: "
                  "flash_dq_bf16<DH> (DH 64 through dh 64, 128 past it; rows zero past dh "
                  "by TMA's fill), 384 threads a block of 128 query rows: a producer warp "
                  "streams 64-key tiles of K and V (4-D tensor maps, 128-byte swizzle) with "
                  "their keys' valid bits through a 3-stage mbarrier ring, two consumer "
                  "warpgroups (setmaxnreg 24 / 240) of 64 rows each take S and dP with their "
                  "q and do rows as register A fragments, delta from the bf16 o and do, p = "
                  "ex2.approx(y log2 e) (1 / l) from the forward's (m, l), ds = p scale (dp - "
                  "delta) rounded to bf16 for dS K (K MN-major), dq rounded once with no "
                  "scale after it; an interior tile skips the masks; longest blocks first"},
    "flash_attention_dkv_bf16": {
        "kernel": "bf16 wgmma.mma_async m64nNk16 with f32 accumulation on TMA-fed tiles: "
                  "flash_dkv_bf16<DH> (DH 64 through dh 64, 128 past it), 384 threads a "
                  "block of 128 keys: a producer warp streams 64-query tiles of q and do "
                  "with their rows' m, 1 / l and delta (loaded a tile ahead), two consumer "
                  "warpgroups (setmaxnreg 32 / 232) of 64 keys each hold all of dh's dK and "
                  "dV (no recomputation at dh 128), S^T and dP^T with k and v as register A "
                  "fragments at DH 64 and from shared memory at DH 128, p and ds as in dq "
                  "rounded to bf16 for P^T do and dS^T q (do, q MN-major, q unscaled), each "
                  "rounded once; without a key mask the rows with no valid key are those "
                  "at qpos < 0 (no scan), with one the block scans the rows' m"},
    "chebykan_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Cheby, "
                  "24, 12, 1, Bf16, 0> at one group (the bf16 q/k/v's template and shape, 192 "
                  "outputs a block), T_0..T_4 of tanh of the upcast x made in f32 in "
                  "registers and rounded to bf16 at the dot, two slices a 16-deep step, W "
                  "split once a call into bf16 pairs by kan_tc_fwd_split, one running sum, y "
                  "rounded to bf16 once",
        "instantiated_in": KAN_SRC},
    "cheby_qkv_grouped_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Cheby, "
                  "24, 12, 1, Bf16, 0> (192 outputs a block; up to 64 outputs <Cheby, 8, 8, 3, "
                  "Bf16, 0>), T_0..T_4 of tanh made in f32 in registers and rounded to bf16 at "
                  "the dot, two slices a 16-deep step, W split once a call into bf16 pairs by "
                  "kan_tc_fwd_split",
        "instantiated_in": KAN_SRC},
    "chebykan_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4 at "
                  "one group: dW on kan_bf16_dw<Cheby, 3> over T_0..T_4 made in f32 on chip "
                  "and rounded to bf16 at the dot, gy by ldmatrix.trans, row splits in f32 "
                  "partials summed in split order and rounded once (sum_splits_bf16_kernel); "
                  "dx, where asked, on kan_bf16_dx<Cheby>, T'_n (1 - t^2) in f32 in its "
                  "epilogue, rounded once",
        "instantiated_in": KAN_SRC},
    "cheby_qkv_grouped_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4: "
                  "kan_bf16_dw<Cheby, NJ> (T_n made in f32 and rounded to bf16 at the dot, "
                  "row splits in f32 partials, one rounding) and kan_bf16_dx<Cheby> (gy W^T in "
                  "f32, T'_n (1 - t^2) in the epilogue, one rounding)",
        "instantiated_in": KAN_SRC},
    "fastkan_bf16": {
        "kernel": "the LayerNorm's statistics of the bf16 x in f32 (ln_stats_kernel), then "
                  "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Rbf, 24, "
                  "12, 1, Bf16, 0> at one group (192 outputs a block), the RBF bases of the "
                  "f32 LayerNorm and silu of the raw x made in f32 in registers and rounded to "
                  "bf16 at the dot, two slices a 16-deep step (silu alone in the fifth), W "
                  "split once a call into bf16 pairs by kan_tc_fwd_split, one running sum, y "
                  "rounded to bf16 once",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan_qkv_grouped_bf16": {
        "kernel": "the LayerNorm's statistics of the bf16 x in f32 (ln_stats_kernel), then "
                  "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Rbf, 8, "
                  "4, 4, Bf16, 0> (64 outputs a block; past 64 <Rbf, 24, 12, 1, Bf16, 0>), "
                  "the RBF bases of each head's f32 LayerNorm and silu made in f32 in "
                  "registers and rounded to bf16 at the dot, W split once a call into bf16 "
                  "pairs by kan_tc_fwd_split",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4 at "
                  "one group: dln (and, where dx is asked, the silu term) in f32 from "
                  "kan_bf16_dx<Rbf> (gy W^T in f32, the RBF fold in its epilogue); the "
                  "LayerNorm's dgamma and dbeta on ln_dgb_kernel, summed in two levels and "
                  "rounded once (sum_splits_bf16_kernel), its VJP for dx on ln_dx_kernel "
                  "(rounded once); dW on kan_bf16_dw<Rbf, 3> over the RBF basis made in f32 "
                  "on chip and rounded to bf16 at the dot, row splits in f32 partials summed "
                  "in split order and rounded once",
        "instantiated_in": RBF_SINE_SRC},
    "fastkan_qkv_grouped_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4: "
                  "kan_bf16_dx<Rbf> (gy W^T in f32, dln and the silu term in f32 from the "
                  "RBF fold), ln_dx_kernel (the LayerNorm's VJP, dx rounded once), "
                  "ln_dgb_kernel (dgamma, dbeta in two levels, rounded once) and "
                  "kan_bf16_dw<Rbf, 1> (the basis made in f32 and rounded to bf16 at the "
                  "dot, row splits in f32 partials, one rounding)",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Sine, 24, "
                  "12, 1, Bf16, 0> at one group (192 outputs a block), the 28 slices in 7 "
                  "chunks of 4 walked inside each 8 features, sin(x freq + phase) made in f32 "
                  "in registers (the argument's product and sum each rounded) and rounded to "
                  "bf16 at the dot, W split once a call into bf16 pairs by kan_tc_fwd_split, "
                  "one running sum, y rounded to bf16 once",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_qkv_grouped_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<Sine, 8, "
                  "4, 4, Bf16, 0> (64 outputs a block), each head's sin(x freq + phase) made in "
                  "f32 in registers and rounded to bf16 at the dot, W split once a call into "
                  "bf16 pairs by kan_tc_fwd_split",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4 at "
                  "one group, the 28 slices in 7 chunks of 4: kan_bf16_dx<Sine> (gy W^T in "
                  "f32, the sine fold in its epilogue: dx where asked, rounded once, and "
                  "dfreq's per-feature row-tile sums, run without dx too), "
                  "sum_rows_features_kernel (dfreq over the rows, then the features, rounded "
                  "once), kan_bf16_dw<Sine, 3> (sin a made in f32 and rounded to bf16 at the "
                  "dot, row splits in f32 partials, one rounding)",
        "instantiated_in": RBF_SINE_SRC},
    "sinekan_qkv_grouped_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4: "
                  "kan_bf16_dx<Sine> (gy W^T in f32; dx and dfreq's per-feature row-tile sums "
                  "from the sine fold), sum_rows_features_kernel (each head's dfreq over the "
                  "rows, then its lanes, rounded once) and kan_bf16_dw<Sine, 1> (the basis "
                  "made in f32 and rounded to bf16 at the dot, row splits in f32 partials, "
                  "one rounding)",
        "instantiated_in": RBF_SINE_SRC},
    "fourierkan_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation: kan_tc_fwd_grouped<FourierBf16, "
                  "24, 12, 1, Bf16, 0> at one group (192 outputs a block), the 56 slices in 14 "
                  "chunks of 2 harmonics walked inside each 8 features, cos/sin(kx) by the "
                  "angle-addition recurrence from cos/sin(x) in f32 in registers, seeded once "
                  "and carried through the chunks, rounded to bf16 at the dot, W split once a "
                  "call into bf16 pairs by kan_tc_fwd_split (cos harmonics first, read a chunk "
                  "at a time), one running sum, y rounded to bf16 once",
        "instantiated_in": KAN_SRC},
    "fourierkan_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 with f32 accumulation, kan_basis_tc.cuh part 4 at "
                  "one group, the 56 slices in 14 chunks of 2 harmonics: kan_bf16_dx<FourierBf16>"
                  " where dx is asked (gy W^T in f32, k (gW_sin c_k - gW_cos s_k) added "
                  "harmonic by harmonic in its epilogue, the recurrence carried through the "
                  "chunks, rounded once), kan_bf16_dw<FourierBf16, 3> (a block a chunk, seeded "
                  "at its first harmonic, the basis rounded to bf16 at the dot, row splits in "
                  "f32 partials, one rounding)",
        "instantiated_in": KAN_SRC},
    "ffn_pre_ln_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 fed by ldmatrix, f32 accumulation: ffn_fwd_bf16<JJ> "
                  "(D <= 512), 48 rows and all of D a block, LN in f32 rounded once to bf16 "
                  "in shared memory, h over 256-unit chunks, relu(h + b1) rounded to bf16 as "
                  "the next product's A fragments, y in registers, (y + b2) + x rounded "
                  "once; W1, W2 tiles 32 deep by cp.async, double-buffered; past D 512 "
                  "ffn_ln_rows_bf16 + ffn_gemm_bf16 twice through device memory"},
    "ffn_pre_ln_bwd_bf16": {
        "kernel": "bf16 mma.sync.m16n8k16 fed by ldmatrix, f32 accumulation: ffn_ln_rows_bf16 "
                  "(LN as bf16, row stats), ffn_bwd_hidden_bf16 (h and dr = g W2 over D; r "
                  "and dh written as bf16, db1 from the f32 dh), ffn_bwd_dx_bf16<JJ> (dln = "
                  "dh W1, the LayerNorm's VJP in f32, dx rounded once, dgamma/dbeta "
                  "partials; past D 512 ffn_gemm_bf16 + ffn_dx_rows_bf16), ffn_dw_bf16 (dW2 "
                  "= g^T r with db2, dW1 = dh^T LN, row splits in f32 partials), "
                  "ffn_sum_parts_bf16 (fixed order, one rounding)"},
    "fourierkan": {"kernel": TC_FWD.format("FourierTc"), "instantiated_in": KAN_SRC},
    "fourierkan_bwd": {"kernel": TC_BWD.format("", "FourierTc"),
                       "instantiated_in": KAN_SRC},
    "sinekan": {"kernel": TC_FWD.format("SineTc"), "instantiated_in": RBF_SINE_SRC},
    "sinekan_bwd": {"kernel": TC_BWD.format(" and dfreq (the D route)", "SineTc"),
                    "instantiated_in": RBF_SINE_SRC},
}
# The main path each kernel must have been launched on ("train" otherwise).
MAIN_PATH = {"flash_attention": "decoder", "flash_attention_dq": "decoder",
             "flash_attention_dkv": "decoder",
             **{f"flash_attention{part}_bf16": "decoder_bf16" for part in ("", "_dq", "_dkv")},
             "chebykan": "cheby_train", "chebykan_bwd": "cheby_train",
             "cheby_qkv_grouped": "cheby_train",
             "cheby_qkv_grouped_bwd": "cheby_train",
             "fourierkan": "fourier_train", "fourierkan_bwd": "fourier_train",
             **{f"{name}{sfx}": f"{variant}_train"
                for variant, names in (("fast", ("fastkan", "fastkan_qkv_grouped")),
                                       ("sine", ("sinekan", "sinekan_qkv_grouped")))
                for name in names for sfx in ("", "_bwd")},
             "ffn_pre_ln": "ffn_train", "ffn_pre_ln_bwd": "ffn_train",
             "ffn_pre_ln_bf16": "ffn_bf16_serve", "ffn_pre_ln_bwd_bf16": "ffn_bf16_train",
             "int8_linear": "int8_serve", "int8_linear_bf16": "int8_bf16_serve",
             **{name: "bf16_serve" for name in ("bspline_kan_bf16",
                                                "bspline_qkv_grouped_bf16",
                                                "flash_attention_lanes_bf16")},
             **{name: "bf16_train" for name in ("bspline_kan_bwd_bf16",
                                                "bspline_qkv_grouped_bwd_bf16",
                                                "flash_attention_lanes_bwd_bf16")},
             "chebykan_bf16": "cheby_bf16_serve", "cheby_qkv_grouped_bf16": "cheby_bf16_serve",
             "chebykan_bwd_bf16": "cheby_bf16_train",
             "cheby_qkv_grouped_bwd_bf16": "cheby_bf16_train",
             "fastkan_bf16": "fast_bf16_serve", "fastkan_qkv_grouped_bf16": "fast_bf16_serve",
             "fastkan_bwd_bf16": "fast_bf16_train",
             "fastkan_qkv_grouped_bwd_bf16": "fast_bf16_train",
             "sinekan_bf16": "sine_bf16_serve", "sinekan_qkv_grouped_bf16": "sine_bf16_serve",
             "sinekan_bwd_bf16": "sine_bf16_train",
             "sinekan_qkv_grouped_bwd_bf16": "sine_bf16_train",
             "fourierkan_bf16": "fourier_bf16_serve", "fourierkan_bwd_bf16": "fourier_bf16_train"}


_START = [time.perf_counter()]


def timed(label, fn, *args):
    """``fn(*args)``, its seconds printed beside the run's total so far."""
    t0 = time.perf_counter()
    out = fn(*args)
    now = time.perf_counter()
    print(f"[time] {label}: {now - t0:.1f} s (total {now - _START[0]:.1f} s)", flush=True)
    return out


def main():
    _START[0] = time.perf_counter()
    torch, smi = phase_toolchain()
    timed("build", phase_build)
    results = timed("forward kernels", phase_kernels, torch)
    results.update(timed("backward kernels", phase_backward_kernels, torch))
    results.update(timed("tiled attention kernels", phase_flash_kernels, torch))
    results.update(timed("bf16 tiled attention kernels", phase_flash_bf16_kernels, torch))
    fwd, bwd = timed("single-tile route", check_single_tile, torch,
                     np.random.default_rng(SEED + 9))
    results["flash_attention_lanes"] += ({"single_tile_route": sub_entry(fwd)},)
    results["flash_attention_lanes_bwd"] += ({"single_tile_route": sub_entry(bwd)},)
    results.update(timed("Chebyshev and Fourier kernels", phase_basis_kernels, torch))
    results.update(timed("RBF and sine kernels", phase_rbf_sine_kernels, torch))
    results.update(timed("fused FF and int8 kernels", phase_ffn_int8_kernels, torch,
                         smi))
    results.update(timed("bf16 kernels", phase_bf16_kernels, torch))
    results.update(timed("bf16 fused FF kernels", phase_ffn_bf16_kernels, torch))

    from kanvit_torch.models import PRESETS

    blocks = PRESETS["vit-s"]["n_blocks"]
    lanes = {"flash_attention_lanes": blocks}
    efficientkan = {"bspline_kan": 1, "bspline_qkv_grouped": blocks, **lanes}
    cheby = {"chebykan": 1, "cheby_qkv_grouped": blocks, **lanes}
    fourier = {"fourierkan": 1, **lanes}
    # one grouped launch per q, k and v projection
    fast = {"fastkan": 1, "fastkan_qkv_grouped": 3 * blocks, **lanes}
    sine = {"sinekan": 1, "sinekan_qkv_grouped": 3 * blocks, **lanes}
    paths = {}
    model_cpu = build_model("efficientkan")
    paths["serve"] = timed("efficientkan serving", phase_serve, torch, smi, model_cpu,
                           "main", efficientkan, SEED + 1)["launches"]
    paths["bf16_serve"] = timed("efficientkan bf16 serving", phase_bf16_serve, torch, smi,
                                model_cpu, SEED + 1)["launches"]
    paths["train"] = timed("efficientkan training", phase_train, torch, smi, model_cpu,
                           "train", efficientkan, "bspline_kan")["launches"]
    paths["bf16_train"] = timed("efficientkan bf16 training", phase_bf16_train, torch, smi,
                                *at_depth(model_cpu, BF16_PER_BATCH, "efficientkan"))["launches"]
    paths["decoder"] = timed("decoder training", phase_decoder, torch, smi)["launches"]
    paths["decoder_bf16"] = timed("decoder bf16 training", phase_decoder, torch, smi,
                                  True)["launches"]
    paths["decoder_bf16_dh_128"] = timed("decoder bf16 training at 2 heads of 128",
                                         phase_decoder, torch, smi, True, 2)["launches"]
    paths["flash_serve"] = timed(
        "flash-attn serving", phase_serve, torch, smi, build_model("flash-attn"),
        "flash-serve", lanes, SEED + 5)["launches"]
    for variant, per_batch, embedder in (("cheby", cheby, "chebykan"),
                                         ("fourier", fourier, "fourierkan"),
                                         ("fast", fast, "fastkan"),
                                         ("sine", sine, "sinekan")):
        model_cpu = build_model(variant)
        paths[f"{variant}_serve"] = timed(
            f"{variant} serving", phase_serve, torch, smi, model_cpu,
            f"{variant}-serve", per_batch, SEED + 7)["launches"]
        paths[f"{variant}_train"] = timed(
            f"{variant} training", phase_train, torch, smi, model_cpu,
            f"{variant}-train", per_batch, embedder)["launches"]
        if variant in BF16_VARIANTS:  # bf16, on the f32 phases' weights
            per_batch = BF16_VARIANTS[variant]
            paths[f"{variant}_bf16_serve"] = timed(
                f"{variant} bf16 serving", phase_bf16_serve, torch, smi, model_cpu, SEED + 7,
                variant, per_batch)["launches"]
            paths[f"{variant}_bf16_train"] = timed(
                f"{variant} bf16 training", phase_bf16_train, torch, smi,
                *at_depth(model_cpu, per_batch, variant), embedder)["launches"]
    vanilla_cpu = build_model("vanilla")
    paths["vanilla_serve"] = timed(
        "vanilla serving", phase_serve, torch, smi, vanilla_cpu,
        "vanilla-serve", lanes, SEED + 8)["launches"]
    paths["vanilla_train"] = timed("vanilla training", phase_train, torch, smi,
                                   vanilla_cpu, "vanilla-train", lanes, None)["launches"]
    paths.update(timed("vanilla 3-head bf16 serving and training", phase_heads_bf16, torch,
                       smi, vanilla_cpu))
    # The flash-attn ViT chains raw attention blocks (no LayerNorm, FF or
    # residual), whose softmax saturates within a few blocks: the later
    # blocks' to_q gradients are 0 in exact arithmetic (f64 too), and the
    # gradient gate holds them against the model's largest (grads_against).
    paths["flash_train"] = timed("flash-attn training", phase_train, torch, smi,
                                 build_model("flash-attn"), "flash-train", lanes,
                                 None)["launches"]
    fused_cpu = build_model("efficientkan", fused_ff=True)
    fused = {**efficientkan, "ffn_pre_ln": blocks}
    paths["ffn_serve"] = timed("fused-FF serving", phase_serve, torch, smi, fused_cpu,
                               "ffn-serve", fused, SEED + 10)["launches"]
    paths["ffn_train"] = timed("fused-FF training", phase_train, torch, smi, fused_cpu,
                               "ffn-train", fused, "bspline_kan")["launches"]
    # bf16, on the fused-FF f32 phases' weights, beside the same model unfused
    paths["ffn_bf16_serve"] = timed(
        "fused-FF bf16 serving", phase_bf16_serve, torch, smi, fused_cpu, SEED + 10,
        "efficientkan fused-FF", FFN_BF16_PER_BATCH)["launches"]
    paths["ffn_bf16_train"] = timed(
        "fused-FF bf16 training", phase_bf16_train, torch, smi,
        *at_depth(fused_cpu, FFN_BF16_PER_BATCH, "efficientkan fused-FF"),
        "bspline_kan")["launches"]
    paths["int8_serve"] = timed("int8 serving", phase_int8_serve, torch, smi,
                                vanilla_cpu, "vit-s vanilla")["kernel"]["launches"]
    paths.update(timed("bf16 int8 serving", int8_bf16_phases, torch, smi))
    paths.update(timed("head dim 8 and refit grids", phase_faults, torch, smi))
    timed("reference bench", phase_bench, torch, smi)
    kernels = []
    for name, (err, ms, plain_ms, *extra) in results.items():
        src, replaces = SOURCES[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        main_path = MAIN_PATH.get(name, "train")
        check(by_path[main_path] > 0, f"the {main_path} path never launched {name}")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": by_path[main_path],
                 "launches_by_path": by_path,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        entry.update(ROUTES.get(name, {}))
        for more in extra:
            entry.update(more)
        check({"bound_ms", "bound_by", "library_ms"} <= set(entry),
              f"{name}: no bound in its result")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
