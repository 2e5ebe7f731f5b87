"""bf16 serving and training of the vit-s efficientkan (with and without
the fused FF), cheby, fast, sine and fourier ViTs, and bf16 training of the
causal decoder, on the card: checks and times.

    python -m kanvit_torch.probe_bf16 [--model-type {efficientkan,cheby,fast,sine,fourier,
                                                     decoder,attention,ffn,int8}]
                                      [--train] [--cheby-shapes] [--fast-shapes]
                                      [--sine-shapes] [--fourier-shapes] [--sincos]

``--model-type ffn`` runs phase 8b alone (the bf16 fused FF's forward and
backward kernels against their twins at vit-s, one image, a ragged shape
and vit-b's and vit-l's widths; ``phase_ffn_bf16_kernels``), then the bf16
serving and, with ``--train``, training of the vit-s efficientkan ViT with
``fused_ff=True`` beside the same model unfused.

``--model-type int8`` runs phase 8's bf16 ``int8_linear`` checks alone
(``int8_bf16_kernels``: the bf16 kernel against its twin at vit-b's and
vit-s's shapes, ragged and strided), phase 11 (the vit-s vanilla served
f32 and int8) and phase 11b (``int8_bf16_phases``:
the vit-b vanilla bf16 served int8 on the kernel, calibrated and qdot
routes, then the 4-block flash-attn and efficientkan holds).

``--model-type decoder`` runs ``chip_smoke.py``'s phase 5b alone (the tiled
attention's bf16 forward, dq and dk/dv against their twins at the
decoder's and ragged shapes; ``phase_flash_bf16_kernels``) and, with
``--train``, phase 13b (``bench_decoder``'s bf16 training beside f32's;
``phase_decoder(bf16=True)``); there is no decoder serving.

``--model-type attention`` runs the bf16 attention kernels at the head dims
outside 8/16/32/64 alone (the instantiations padded to 128: phase 5b's
``flash_bf16_generic``, the decoder's shapes at 2 heads of 128 and ragged
masked shapes at dh 24, 40, 72 and 120; ``lanes_bf16_generic``, vit-s's
width in 4 heads of 96 and 3 of 128 and the single-tile route at dh 40)
and, with ``--train``, phase 13c (the bf16 decoder at ``--heads 2``,
``phase_decoder(bf16=True, heads=2)``) and phase 12c (the vit-s vanilla
ViT in 3 heads served and trained in bf16, ``phase_heads_bf16``).

Builds the kernels (registers, spills and the SASS report), then runs
``chip_smoke.py``'s bf16 phases alone: the bf16 kernels of the model type
against their plain twins and f64 at the vit-s and ragged shapes, with
CUDA-event and device times beside the f32 kernels' on the same operands
(efficientkan: ``phase_bf16_kernels``, every bf16 kernel, ``bspline_kan``,
``bspline_qkv_grouped``, ``chebykan``, ``cheby_qkv_grouped``, ``fastkan``,
``fastkan_qkv_grouped``, ``sinekan``, ``sinekan_qkv_grouped`` and the lanes
attention, forward and backward; cheby: ``cheby_bf16_kernels``; fast:
``fast_bf16_kernels``; sine: ``sine_bf16_kernels``; fourier:
``fourier_bf16_kernels``, whose q/k/v are Linear), and the bf16
serving of the vit-s model through ``Predictor`` and
``make_eval_step(bf16=True)`` beside f32 (``phase_bf16_serve``);
``--train`` adds its bf16 training through ``make_train_step(bf16=True)``
(``phase_bf16_train``: launches, the loss over 10 steps, the 4-image
gradients against the CPU's bf16 twins, the parameter casts' kernels and
the host's split of a step with the flat buffer and with a cast a
parameter, ms a step beside f32's, the profiles).

``--sincos`` counts the floats (2^31 from a seed) whose ``sincosf``
differs from ``cosf`` and ``sinf`` in any bit: the bf16 Fourier kernels'
seeds against their plain twin's ``torch.cos`` and ``torch.sin``.

``--cheby-shapes``, ``--fast-shapes``, ``--sine-shapes`` and
``--fourier-shapes`` also build a library of the bf16 Chebyshev, RBF
(FastKAN), sine or Fourier forward's shapes (``CHEBY_BF16_SHAPES``,
``FAST_BF16_SHAPES``, ``SINE_BF16_SHAPES``, ``FOURIER_BF16_SHAPES``: n8
tiles a warp, warps a block, blocks an SM of ``kan_tc_fwd_grouped<F, NT,
WARPS, MINB, Bf16, 0>``) and time each at the vit-s embedder and q/k/v and
one vit-s image beside the route, each held to the route's bits (a shape
sums in the same order) and to the twin's gate.
The last line holds the times as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# (n8 tiles a warp, warps a block, blocks an SM) of the bf16 Chebyshev
# forward; the route's first (past 64 outputs 192 a block at 12 warps; up
# to 64 kan_basis.cu's CHEBY_BF16_WARPS and CHEBY_BF16_MINB, the f32 q/k/v's
# 8 warps at three blocks an SM)
CHEBY_BF16_SHAPES = ((24, 12, 1), (8, 8, 3), (8, 8, 2), (8, 8, 4), (8, 12, 1), (8, 12, 2),
                     (8, 16, 1), (24, 8, 1), (24, 8, 2))

# The same for the bf16 RBF forward; the route's first (past 64 outputs 192
# a block at 12 warps; up to 64 kan_rbf_sine.cu's RBF_BF16_WARPS and
# RBF_BF16_MINB, 4 warps at four blocks an SM), then the f32 RBF forward's
# 12 warps at one block an SM
FAST_BF16_SHAPES = ((24, 12, 1), (8, 4, 4), (8, 12, 1), (8, 8, 3), (8, 8, 2), (8, 12, 2),
                    (8, 16, 1), (24, 8, 1))

FAST_BF16_SOURCE = r"""
#include "kan_rbf_sine.cu"

extern "C" int probe_fast_fwd_bf16(int v, const void* x, long long ldx, const void* gamma,
                                   const void* beta, const float* centres, float inv_h,
                                   const void* w, void* y, float* stats, unsigned int* ws,
                                   long long ww, int n, int groups, int nin, int nout,
                                   void* stream) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* wb = static_cast<const bf*>(w);
  bf* yb = static_cast<bf*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = ln_stats_pass(xb, ldx, gamma, stats, n, groups, nin, st);
  if (err != 0) return err;
  const Rbf::Params p = rbf_params_bf16(static_cast<const bf*>(gamma),
                                        static_cast<const bf*>(beta), centres, inv_h, stats,
                                        groups, 1);
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Rbf, {nt}, {w}, {mb}, 0, Bf16>(xb, ldx, "
    f"p, wb, yb, ws, ww, n, groups, nin, nout, st);"
    for i, (nt, w, mb) in enumerate(FAST_BF16_SHAPES)))

# The same for the bf16 sine forward; the route's first (past 64 outputs 192
# a block at 12 warps; up to 64 kan_rbf_sine.cu's SINE_BF16_WARPS and
# SINE_BF16_MINB, 4 warps at four blocks an SM), then the f32 sine q/k/v's
# 8 warps at three blocks an SM
SINE_BF16_SHAPES = ((24, 12, 1), (8, 4, 4), (8, 8, 3), (8, 8, 2), (8, 12, 1), (8, 4, 6),
                    (8, 16, 1), (24, 8, 1))

SINE_BF16_SOURCE = r"""
#include "kan_rbf_sine.cu"

extern "C" int probe_sine_fwd_bf16(int v, const void* x, long long ldx, const void* freq,
                                   const float* phase, const void* w, void* y,
                                   unsigned int* ws, long long ww, int n, int groups, int nin,
                                   int nout, int grid_size, void* stream) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* wb = static_cast<const bf*>(w);
  bf* yb = static_cast<bf*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  const Sine::Params p = sine_params_bf16(freq, phase, grid_size);
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Sine, {nt}, {w}, {mb}, 0, Bf16>(xb, ldx, "
    f"p, wb, yb, ws, ww, n, groups, nin, nout, st);"
    for i, (nt, w, mb) in enumerate(SINE_BF16_SHAPES)))

# The same for the bf16 Fourier forward; the route's first (past 64 outputs
# 192 a block at 12 warps; up to 64 kan_basis.cu's FOURIER_BF16_WARPS and
# FOURIER_BF16_MINB, 4 warps at four blocks an SM), then 64- and 96-output
# tiles at more blocks an SM: the basis by the recurrence is cheap to make
# again an output tile, and 192-output blocks of 12 warps hold one block an
# SM
FOURIER_BF16_SHAPES = ((24, 12, 1), (8, 4, 4), (8, 4, 6), (8, 8, 2), (8, 8, 3), (8, 12, 1),
                       (12, 8, 2), (24, 8, 1))

FOURIER_BF16_SOURCE = r"""
#include "kan_basis.cu"

extern "C" int probe_fourier_fwd_bf16(int v, const void* x, long long ldx, const void* w,
                                      void* y, unsigned int* ws, long long ww, int n,
                                      int groups, int nin, int nout, int grid_size,
                                      void* stream) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* wb = static_cast<const bf*>(w);
  bf* yb = static_cast<bf*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  const FourierBf16::Params p{grid_size};
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<FourierBf16, {nt}, {w}, {mb}, 0, Bf16>(xb, "
    f"ldx, p, wb, yb, ws, ww, n, groups, nin, nout, st);"
    for i, (nt, w, mb) in enumerate(FOURIER_BF16_SHAPES)))

# sincosf against cosf and sinf, bit for bit: the bf16 Fourier kernels seed
# the recurrence with sincosf, their plain twin with torch.cos and torch.sin
# (cosf, sinf on the card). Half the floats any finite bit pattern, half
# over [-300, 300] (the arguments k x of the vit-s embedder's inputs).
SINCOS_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void sincos_differ(unsigned long long n, unsigned long long seed,
                              unsigned long long* bad) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += (unsigned long long)gridDim.x * blockDim.x) {
    unsigned long long h = (i + 1) * 0x9E3779B97F4A7C15ull ^ seed;
    h ^= h >> 31;
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 29;
    const float x = (i & 1) ? __uint_as_float((uint32_t)h)
                            : ((float)(h >> 40) / (float)(1ull << 24) - 0.5f) * 600.f;
    if (!isfinite(x)) continue;
    float s, c;
    sincosf(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(sinf(x)) ||
        __float_as_uint(c) != __float_as_uint(cosf(x)))
      atomicAdd(bad, 1ull);
  }
}

// The floats of n drawn from seed whose sincosf differs from cosf, sinf;
// ~0ull on a CUDA error.
extern "C" unsigned long long probe_sincos(unsigned long long n, unsigned long long seed) {
  unsigned long long* bad = nullptr;
  unsigned long long out = ~0ull;
  if (cudaMalloc(&bad, sizeof(*bad)) != cudaSuccess) return out;
  cudaMemset(bad, 0, sizeof(*bad));
  sincos_differ<<<132 * 16, 256>>>(n, seed, bad);
  if (cudaDeviceSynchronize() == cudaSuccess)
    cudaMemcpy(&out, bad, sizeof(out), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return out;
}
"""
SINCOS_FLOATS = 1 << 31

CHEBY_BF16_SOURCE = r"""
#include "kan_basis.cu"

extern "C" int probe_cheby_fwd_bf16(int v, const void* x, long long ldx, const void* w,
                                    void* y, unsigned int* ws, long long ww, int n,
                                    int groups, int nin, int nout, void* stream) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* wb = static_cast<const bf*>(w);
  bf* yb = static_cast<bf*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Cheby, {nt}, {w}, {mb}, 0, Bf16>(xb, ldx, "
    f"{{}}, wb, yb, ws, ww, n, groups, nin, nout, st);"
    for i, (nt, w, mb) in enumerate(CHEBY_BF16_SHAPES)))


def _cases(C, family):
    """``(label, n, heads, nin, nout)`` of the shapes' timings: the vit-s
    embedder, one vit-s image's and the vit-s q/k/v (Chebyshev: q|k|v, 192
    outputs a head; FastKAN and sine: one projection, 64; Fourier: the MNIST
    embedder in its place, its q/k/v Linear)."""
    qkv_out = 192 if family == "cheby" else 64
    last = (("mnist embedder", 37 * 49, None, 16, 64) if family == "fourier"
            else ("vit-s q/k/v", C.BATCH * 197, 6, 64, qkv_out))
    return (("vit-s embedder", C.BATCH * 196, None, 768, 384),
            ("vit-s embedder, one image", 196, None, 768, 384), last)


def bf16_shapes(lib, C, torch, family):
    """Each shape of ``CHEBY_BF16_SHAPES`` (``family`` "cheby"),
    ``FAST_BF16_SHAPES`` ("fast"), ``SINE_BF16_SHAPES`` ("sine") or
    ``FOURIER_BF16_SHAPES`` ("fourier") at the vit-s embedder, one vit-s
    image's embedder and the vit-s q/k/v (Fourier: the MNIST embedder):
    CUDA-event ms in turns with the route, the route's bits, and the twin's
    gate (one bf16 ulp plus the rounded basis's term)."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    if family == "cheby":
        shapes, fn = CHEBY_BF16_SHAPES, lib.probe_cheby_fwd_bf16
        fn.argtypes = [i32, p, i64, p, p, p, i64, *[i32] * 4, p]
        names = ("chebykan", "cheby_qkv_grouped")
    elif family == "fast":
        shapes, fn = FAST_BF16_SHAPES, lib.probe_fast_fwd_bf16
        fn.argtypes = [i32, p, i64, p, p, p, f32, p, p, p, p, i64, *[i32] * 4, p]
        names = ("fastkan", "fastkan_qkv_grouped")
    elif family == "sine":
        shapes, fn = SINE_BF16_SHAPES, lib.probe_sine_fwd_bf16
        fn.argtypes = [i32, p, i64, p, p, p, p, p, i64, *[i32] * 5, p]
        names = ("sinekan", "sinekan_qkv_grouped")
    else:
        shapes, fn = FOURIER_BF16_SHAPES, lib.probe_fourier_fwd_bf16
        fn.argtypes = [i32, p, i64, p, p, p, i64, *[i32] * 5, p]
        names = ("fourierkan", "fourierkan")
    fn.restype = i32
    rng = np.random.default_rng(C.SEED + {"cheby": 14, "fast": 16, "sine": 18,
                                          "fourier": 20}[family])
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for label, n, heads, nin, nout in _cases(C, family):
        name = names[heads is not None]
        extra, chunks = (), 1
        if family == "cheby":
            x, _, w, groups = C.cheby_bf16_case(torch, rng, n, heads, nin, nout)

            def route():
                return FB._launch_bf16(name, x, w, FB.CHEBY_DEGREE)

            twin = K.cheby_grouped_forward_bf16(x, w)
            spread = K.cheby_fwd_spread_bf16(x, w)

            def args(y):
                return (x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr())
        elif family == "fourier":
            x, w = C.fourier_bf16_case(torch, rng, n, nin, nout)
            groups, slices = w.shape[:2]
            extra, chunks = (slices // 2,), -(-slices // 4)

            def route():
                return FB._launch_bf16(name, x, w, slices // 2)

            twin = K.fourier_grouped_forward_bf16(x, w)
            spread = K.fourier_fwd_spread_bf16(x, w)

            def args(y):
                return (x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr())
        elif family == "sine":
            x, w, f2, phase = C.sine_bf16_case(torch, rng, n, heads, nin, nout)
            groups, slices = w.shape[:2]
            extra, chunks = (slices,), -(-slices // 4)

            def route():
                return FB._launch_sine(name, x, w, f2, phase)

            twin = K.sine_grouped_forward_bf16(x, w, f2, phase)
            spread = K.sine_fwd_spread_bf16(x, w, f2, phase)

            def args(y):
                return (x.data_ptr(), x.stride(0), f2.data_ptr(), phase.data_ptr(),
                        w.data_ptr(), y.data_ptr())
        else:
            x, w, ga, be, grid, den = C.fast_bf16_case(torch, rng, n, heads, nin, nout)
            groups = w.shape[0]
            stats = torch.empty(n, groups, 2, device="cuda")

            def route():
                return FB._launch_rbf(name, x, w, ga, be, grid, den)[0]

            twin = K.fastkan_grouped_forward_bf16(x, w, ga, be, grid, den)
            spread = K.fastkan_fwd_spread_bf16(x, w, ga, be, grid, den)

            def args(y):
                return (x.data_ptr(), x.stride(0), ga.data_ptr(), be.data_ptr(),
                        grid.data_ptr(), 1.0 / den, w.data_ptr(), y.data_ptr(),
                        stats.data_ptr())
        ws = torch.empty(groups * -(-nout // 192) * 192 * -(-nin // 8) * chunks * 5 * 8,
                         dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            want = route()
            C.bf16_ulp_gate(f"{name} {label} route", want, twin, spread)
            entry = {"route_ms": []}
            launches = {}
            for v, shape in enumerate(shapes):
                y = torch.empty_like(want)

                def launch(v=v, y=y, shape=shape):
                    err = fn(v, *args(y), ws.data_ptr(), ws.numel(), n, groups, nin, nout,
                             *extra, stream)
                    C.check(err == 0, f"{family} bf16 fwd {shape}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                launches[shape] = launch
                entry[str(shape)] = {"ms": [], "same_bits": torch.equal(y, want)}
            for _ in range(2):  # in turns: route, every shape, twice
                entry["route_ms"].append(C.time_ms(torch, route))
                for shape, launch in launches.items():
                    entry[str(shape)]["ms"].append(C.time_ms(torch, launch))
        times[f"{name} {label}"] = entry
        print(f"[probe_bf16] bf16 {name} {label} N={n} G={groups} {nin}->{nout}: route "
              f"{entry['route_ms']} ms", flush=True)
        for shape in shapes:
            e = entry[str(shape)]
            print(f"[probe_bf16]   (n8 tiles, warps, blocks an SM) {shape}: {e['ms']} ms"
                  f"{'' if e['same_bits'] else ' (other bits than the route)'}", flush=True)
    return times


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-type",
                   choices=("efficientkan", "cheby", "fast", "sine", "fourier", "decoder",
                            "attention", "ffn", "int8"),
                   default="efficientkan")
    p.add_argument("--train", action="store_true", help="also the bf16 training phase")
    p.add_argument("--cheby-shapes", action="store_true",
                   help="also time the bf16 Chebyshev forward's shapes")
    p.add_argument("--fast-shapes", action="store_true",
                   help="also time the bf16 RBF (FastKAN) forward's shapes")
    p.add_argument("--sine-shapes", action="store_true",
                   help="also time the bf16 sine forward's shapes")
    p.add_argument("--fourier-shapes", action="store_true",
                   help="also time the bf16 Fourier forward's shapes")
    p.add_argument("--sincos", action="store_true",
                   help="also count the floats whose sincosf differs from cosf, sinf")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    from kanvit_torch.probe_qkv_fwd import _finish, _nvcc

    torch, smi = C.phase_toolchain()
    libs = {family: _nvcc(C, source, f"probe_bf16_{family}")
            for family, source, asked in (("cheby", CHEBY_BF16_SOURCE, args.cheby_shapes),
                                          ("fast", FAST_BF16_SOURCE, args.fast_shapes),
                                          ("sine", SINE_BF16_SOURCE, args.sine_shapes),
                                          ("fourier", FOURIER_BF16_SOURCE,
                                           args.fourier_shapes))
            if asked}
    if args.sincos:
        libs["sincos"] = _nvcc(C, SINCOS_SOURCE, "probe_sincos")
    C.timed("build", C.phase_build)
    out = {"card": smi}
    if args.sincos:
        lib = _finish(C, *libs.pop("sincos"), "probe_sincos")
        lib.probe_sincos.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong]
        lib.probe_sincos.restype = ctypes.c_ulonglong
        differ = lib.probe_sincos(SINCOS_FLOATS, 12345)
        print(f"[probe_bf16] sincosf against cosf and sinf: {differ} of {SINCOS_FLOATS} floats "
              f"differ  [{smi}]", flush=True)
        C.check(differ != 2 ** 64 - 1, "probe_sincos: CUDA error")
        out["sincos_differ"] = {"floats": SINCOS_FLOATS, "differ": differ}
    for family, (proc, path) in libs.items():
        lib = _finish(C, proc, path, f"probe_bf16_{family}")
        out[f"{family}_bf16_shapes"] = C.timed(f"bf16 {family} shapes", bf16_shapes, lib, C,
                                               torch, family)
    if args.model_type == "int8":
        results = C.timed("bf16 int8 kernels", C.int8_bf16_kernels, torch,
                          np.random.default_rng(C.SEED + 9))
        out["kernels"] = {name: {"ms": r[1], "plain_ms": r[2], **r[3], **r[4],
                                 **{k: v for sub in r[5:] for k, v in sub.items()}}
                          for name, r in results.items()}
        C.timed("int8 serving", C.phase_int8_serve, torch, smi, C.build_model("vanilla"),
                "vit-s vanilla")
        C.timed("bf16 int8 serving", C.int8_bf16_phases, torch, smi)
        print(json.dumps(out))
        return
    if args.model_type == "attention":
        kernels = {}
        for key, results in C.timed("bf16 tiled attention, generic dh", C.flash_bf16_generic,
                                    torch).items():
            for name, r in results.items():
                kernels.setdefault(name, {})[key] = C.sub_entry(r)
        kernels.update(C.timed("bf16 lanes attention, generic dh", C.lanes_bf16_generic,
                               torch))
        out["kernels"] = kernels
        if args.train:
            train = C.timed("decoder bf16 training at 2 heads", C.phase_decoder, torch, smi,
                            True, 2)
            out["train"] = {k: v for k, v in train.items() if k != "launches"}
            C.timed("vanilla 3-head bf16", C.phase_heads_bf16, torch, smi,
                    C.build_model("vanilla"))
        print(json.dumps(out))
        return
    phase = {"efficientkan": C.phase_bf16_kernels, "cheby": C.cheby_bf16_kernels,
             "fast": C.fast_bf16_kernels, "sine": C.sine_bf16_kernels,
             "fourier": C.fourier_bf16_kernels,
             "decoder": C.phase_flash_bf16_kernels,
             "ffn": C.phase_ffn_bf16_kernels}[args.model_type]
    results = C.timed("bf16 kernels", phase, torch)
    out["kernels"] = {name: {"ms": r[1], "plain_ms": r[2], **r[3], **r[4],
                             **{k: v for sub in r[5:] for k, v in sub.items()}}
                      for name, r in results.items()}
    if args.model_type == "decoder":
        if args.train:
            train = C.timed("decoder bf16 training", C.phase_decoder, torch, smi, True)
            out["train"] = {k: v for k, v in train.items() if k != "launches"}
        print(json.dumps(out))
        return
    if args.model_type == "ffn":  # the efficientkan ViT with the fused FF
        model = C.build_model("efficientkan", fused_ff=True)
        label, per_batch = "efficientkan fused-FF", C.FFN_BF16_PER_BATCH
        serve = C.timed("bf16 serving", C.phase_bf16_serve, torch, smi, model, C.SEED + 10,
                        label, per_batch)
        out["serve"] = {k: v for k, v in serve.items() if k != "launches"}
        if args.train:
            train = C.timed("bf16 training", C.phase_bf16_train, torch, smi,
                            *C.at_depth(model, per_batch, label), "bspline_kan")
            out["train"] = {k: v for k, v in train.items() if k != "launches"}
        print(json.dumps(out))
        return
    model = C.build_model(args.model_type)
    per_batch, embedder = {"efficientkan": (C.BF16_PER_BATCH, "bspline_kan"),
                           "cheby": (C.CHEBY_BF16_PER_BATCH, "chebykan"),
                           "fast": (C.FAST_BF16_PER_BATCH, "fastkan"),
                           "sine": (C.SINE_BF16_PER_BATCH, "sinekan"),
                           "fourier": (C.FOURIER_BF16_PER_BATCH, "fourierkan")}[args.model_type]
    serve = C.timed("bf16 serving", C.phase_bf16_serve, torch, smi, model, C.SEED + 1,
                    args.model_type, per_batch)
    out["serve"] = {k: v for k, v in serve.items() if k != "launches"}
    if args.train:
        train = C.timed("bf16 training", C.phase_bf16_train, torch, smi, model,
                        args.model_type, per_batch, embedder)
        out["train"] = {k: v for k, v in train.items() if k != "launches"}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
