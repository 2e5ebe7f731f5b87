"""The grouped q/k/v forward's tile shapes on the card.

    python -m kanvit_torch.probe_qkv_fwd [--bspline] [--cheby]

Builds the kernels, then a library from ``csrc/kan_rbf_sine.cu`` with
variants of ``kan_tc_fwd_grouped`` (``csrc/kan_basis_tc.cuh``, part 3) for
the RBF (FastKAN) and sine families at 64 outputs a block (one q/k/v
projection): warps a block and blocks an SM (the launch bound, so the
registers a thread may hold), ``SHAPES``. Each runs
``fastkan_qkv_grouped``'s (the LayerNorm's statistics, then the
contraction; with and without the base branch) and
``sinekan_qkv_grouped``'s (grids 4 and 3) forward at one vit-s q/k/v
projection (12,608 rows, 6 heads of 64 -> 64) and at the reference
preset's (6,400 rows, 2 heads of 32 -> 32), against the route's output bit
for bit, timed by CUDA events beside the route and the CUDA-core kernel it
replaced; the two routes' host time a call (the enqueue alone) beside
them. ``--bspline`` adds PR 13's B-spline variants from
``csrc/kan_basis.cu`` (12 or 8 warps, 64-output tiles at every width,
local support) at the vit-s q/k/v, a refit grid a head and dh 8.
``--cheby`` adds the Chebyshev shapes (``CHEBY_SHAPES``: 192- or 64-output
tiles, warps a block, blocks an SM) of ``cheby_qkv_grouped``'s forward at
the vit-s q/k/v (a share of x where tanh rounds to +-1) and at the
reference preset's (6,400 rows, 2 heads of 32 -> 96). The registers and
spills of every variant are printed; the last line holds the times as
JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = ("route", "8 warps", "64-output tiles", "route, local support",
            "64-output tiles, local support")
# (warps a block, blocks an SM) at 64 outputs a block
SHAPES = ((12, 1), (12, 2), (8, 2), (8, 3), (4, 4))
# (n8 tiles a warp: 24 for 192 outputs a block, 8 for 64; warps a block,
# blocks an SM); the route's first
CHEBY_SHAPES = ((24, 12, 1), (24, 8, 1), (8, 12, 1), (8, 12, 2), (8, 8, 2), (8, 8, 3))

SOURCE = r"""
#include "kan_basis.cu"

namespace {
// B-spline with local support: the 4 nonzero cubic bases of x's knot
// interval j0 (g[j0] <= x < g[j0 + 1]) by levels' expressions, the rest 0.
struct BsplineLocal : Bspline {
  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>& st, const Elem& e,
                                                int, float (&v)[SC]) {
    const float xv = e.x;
    const float* gk = st.knots[e.kf];
    const float* iv = st.inv[e.kf];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < KNOTS; ++j) cnt += xv >= gk[j] ? 1 : 0;
    const int j0 = cnt - 1;
    const bool inside = cnt >= 1 && cnt <= KNOTS - 1;
    auto kn = [&](int j) { return gk[min(max(j, 0), KNOTS - 1)]; };
    auto inv = [&](int k, int j) { return iv[(k - 1) * KNOTS + min(max(j, 0), KNOTS - 1)]; };
    const float lm2 = xv - kn(j0 - 2), lm1 = xv - kn(j0 - 1), l0 = xv - kn(j0);
    const float r1 = kn(j0 + 1) - xv, r2 = kn(j0 + 2) - xv, r3 = kn(j0 + 3) - xv;
    const float u0 = r1 * inv(1, j0), u1 = l0 * inv(1, j0);
    const float c0 = (r1 * inv(2, j0 - 1)) * u0;
    const float c1 = (lm1 * inv(2, j0 - 1)) * u0 + (r2 * inv(2, j0)) * u1;
    const float c2 = (l0 * inv(2, j0)) * u1;
    const float d0 = (r1 * inv(3, j0 - 2)) * c0;
    const float d1 = (lm2 * inv(3, j0 - 2)) * c0 + (r2 * inv(3, j0 - 1)) * c1;
    const float d2 = (lm1 * inv(3, j0 - 1)) * c1 + (r3 * inv(3, j0)) * c2;
    const float d3 = (l0 * inv(3, j0)) * c2;
#pragma unroll
    for (int s = 0; s < NSPLINE; ++s) {
      const int k = s - j0 + 3;
      const float lo = (k & 1) ? d1 : d0, hi = (k & 1) ? d3 : d2;
      v[s] = inside && (unsigned)k < 4u ? ((k & 2) ? hi : lo) : 0.f;
    }
    v[NSPLINE] = silu(xv);
  }
};

template <class F>
int route(const float* x, long long ldx, typename F::Params p, const float* w, float* y,
          uint32_t* ws, long long ww, int n, int groups, int nin, int nout, cudaStream_t st) {
  if (nout <= 64) return launch_tc_fwd_grouped<F, 8>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
  return launch_tc_fwd_grouped<F, 24>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
}
}  // namespace

extern "C" int probe_qkv_fwd(int variant, const float* x, long long ldx, const float* gridt,
                             long long gstride, const float* w, float* y, unsigned int* ws,
                             long long ww, int n, int groups, int nin, int nout,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Bspline::Params p{gridt, gstride};
  switch (variant) {
    case 0: return route<Bspline>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
    case 1:
      if (nout <= 64) return launch_tc_fwd_grouped<Bspline, 8, 8>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
      return launch_tc_fwd_grouped<Bspline, 24, 8>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
    case 2: return launch_tc_fwd_grouped<Bspline, 8>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
    case 3: return route<BsplineLocal>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
    case 4: return launch_tc_fwd_grouped<BsplineLocal, 8>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
  }
  return -1;
}
"""


RBF_SINE_SOURCE = r"""
#include "kan_rbf_sine.cu"

namespace {
template <class F, int W, int MB>
int shape(const float* x, long long ldx, typename F::Params p, const float* w, float* y,
          uint32_t* ws, long long ww, int n, int groups, int nin, int nout, cudaStream_t st) {
  return launch_tc_fwd_grouped<F, 8, W, MB>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
}

template <class F>
int by_shape(int v, const float* x, long long ldx, typename F::Params p, const float* w,
             float* y, uint32_t* ws, long long ww, int n, int groups, int nin, int nout,
             cudaStream_t st) {
  switch (v) {
CASES
  }
  return -1;
}
}  // namespace

extern "C" int probe_fastkan_fwd(int v, const float* x, long long ldx, const float* gamma,
                                 const float* beta, const float* centres, float inv_h,
                                 const float* w, float* y, float* stats, unsigned int* ws,
                                 long long ww, int n, int groups, int nin, int nout, int base,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nout > 64) return -1;
  ln_stats_kernel<<<ln_blocks(n, groups), LN_WARPS * 32, 0, st>>>(x, ldx, stats, n, groups, nin);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const Rbf::Params p{stats, gamma, beta, centres, inv_h, groups, base};
  return by_shape<Rbf>(v, x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);
}

extern "C" int probe_sinekan_fwd(int v, const float* x, long long ldx, const float* freq,
                                 const float* phase, const float* w, float* y,
                                 unsigned int* ws, long long ww, int n, int groups, int nin,
                                 int nout, int grid_size, void* stream) {
  if (nout > 64 || grid_size > Sine::SC) return -1;
  return by_shape<Sine>(v, x, ldx, {freq, phase, grid_size}, w, y, ws, ww, n, groups, nin,
                        nout, (cudaStream_t)stream);
}
""".replace("CASES", "\n".join(
    f"    case {i}: return shape<F, {w}, {mb}>(x, ldx, p, w, y, ws, ww, n, groups, nin, nout, st);"
    for i, (w, mb) in enumerate(SHAPES)))


CHEBY_SOURCE = r"""
#include "kan_basis.cu"

extern "C" int probe_cheby_fwd(int v, const float* x, long long ldx, const float* w, float* y,
                               unsigned int* ws, long long ww, int n, int groups, int nin,
                               int nout, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Cheby, {nt}, {w}, {mb}>(x, ldx, {{}}, w, y, "
    f"ws, ww, n, groups, nin, nout, st);" for i, (nt, w, mb) in enumerate(CHEBY_SHAPES)))


def _nvcc(C, source, name):
    """Start nvcc on ``source`` into ``lib<name>.so``; returns (process,
    library path)."""
    from kanvit_torch.kernels import _build

    out = _build.BUILD_ROOT / f"{name}_{_build.source_hash()}"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "variants.cu", out / f"lib{name}.so"
    src.write_text(source)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(_build.CSRC), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def _finish(C, proc, lib, name):
    """Wait for an nvcc process, print its variants' registers and spills,
    and load the library."""
    log = proc.communicate()[0]
    C.check(proc.returncode == 0, f"{name} did not build:\n{log}")
    keep = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "kan_tc_fwd_grouped" in line
            if keep:
                print(f"[{name}] {line.split('kan_tc_fwd_grouped')[1][:70]}")
        elif keep and ("registers" in line or "spill" in line):
            print(f"[{name}]     {line.strip()}")
    return ctypes.CDLL(str(lib))


def bspline_variants(fn, C, torch, rng, times):
    """PR 13's B-spline variants (``--bspline``)."""
    from kanvit_torch.kernels import fused_basis as FB

    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, *[ctypes.c_void_p] * 3, ctypes.c_longlong,
                   *[ctypes.c_int] * 4, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for label, n, heads, dh, per_head in (("vit-s q/k/v", C.BATCH * 197, 6, 64, False),
                                          ("vit-s refit grids a head", C.BATCH * 197, 6, 64,
                                           True),
                                          ("dh-8 mnist q/k/v", C.BATCH * 50, 8, 8, False)):
        x, (grid, bw, sw, sc), _ = C.qkv_case(torch, rng, n, heads, dh, per_head)
        w = FB.pack_qkv_weight(bw, sw, sc).contiguous()
        groups, _, nin, nout = w.shape
        gridt, gstride = FB._knot_rows(grid)
        # room for every variant's tiles: 64-output tiles past 64 outputs
        ws = torch.empty(groups * -(-nin // 8) * 9 * 16 * (-(-nout // 64) * 64 + 192),
                         dtype=torch.int32, device=x.device)

        def route():
            return FB._launch("bspline_qkv_grouped", "bspline", x, w, grid)

        def call(v, y):
            return fn(v, x.data_ptr(), x.stride(0), gridt.data_ptr(), gstride, w.data_ptr(),
                      y.data_ptr(), ws.data_ptr(), ws.numel(), n, groups, nin, nout,
                      torch.cuda.current_stream().cuda_stream)

        times[f"bspline {label}"] = run_variants(C, torch, route, call, VARIANTS,
                                                 f"bspline {label}")


def cheby_variants(fn, C, torch, rng, times):
    """The Chebyshev shapes (``--cheby``)."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB

    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, *[ctypes.c_void_p] * 3,
                   ctypes.c_longlong, *[ctypes.c_int] * 4, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for label, n, heads, dh in (("vit-s q/k/v", C.BATCH * 197, 6, 64),
                                ("reference q/k/v", 128 * 50, 2, 32)):
        x = torch.from_numpy(C.cheby_inputs(rng, (n, heads * dh), 0.02)).cuda()
        cc = torch.from_numpy((rng.standard_normal((heads, dh, 3 * dh, 5))
                               / np.sqrt(dh * 5)).astype(np.float32)).cuda()
        w = FB.pack_cheby_qkv_weight(cc).contiguous()
        groups, _, nin, nout = w.shape
        # room for every variant's tiles: 64-output tiles past 64 outputs
        ws = torch.empty(groups * -(-nin // 8) * 5 * 16 * (-(-nout // 64) * 64 + 192),
                         dtype=torch.int32, device=x.device)

        def route():
            return FB._launch("cheby_qkv_grouped", "cheby", x, w, 4)

        def call(v, y):
            return fn(v, x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr(), ws.data_ptr(),
                      ws.numel(), n, groups, nin, nout, torch.cuda.current_stream().cuda_stream)

        times[f"cheby {label}"] = run_variants(C, torch, route, call, CHEBY_SHAPES,
                                               f"cheby {label}")


def host_ms(torch, fn, calls=200):
    """Host time a call of ``fn``: ``calls`` calls enqueued back to back
    (no wait for the card between them) over the host's clock."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def run_variants(C, torch, route, call, names, label):
    """Each variant ``call(v, y)`` against ``route()``'s bits, timed beside
    it and the CUDA-core kernel the route replaced."""
    from kanvit_torch.kernels import fused_basis as FB

    with torch.inference_mode():
        want = route()
        entry = {"route_ms": C.time_ms(torch, route),
                 "cuda_core_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, route)),
                 "route_host_ms": host_ms(torch, route),
                 "cuda_core_host_ms": C.cuda_core_route(FB, lambda: host_ms(torch, route))}
        for v, name in enumerate(names):
            y = torch.empty_like(want)

            def launch(v=v, y=y, name=name):
                err = call(v, y)
                C.check(err == 0, f"{label} {name}: launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            entry[str(name)] = {"ms": C.time_ms(torch, launch), "same_bits": torch.equal(y, want)}
    print(f"[probe_qkv_fwd] {label}: " + "  ".join(
        f"{k} {v['ms']:.4f} ms{'' if v['same_bits'] else ' (other bits)'}"
        if isinstance(v, dict) else f"{k} {v:.4f} ms" for k, v in entry.items()), flush=True)
    return entry


def rbf_sine_variants(lib, C, torch, rng, times):
    """The RBF and sine shapes at one vit-s q/k/v projection and at the
    reference preset's."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fast, sine = lib.probe_fastkan_fwd, lib.probe_sinekan_fwd
    fast.argtypes = [i32, p, i64, p, p, p, f32, *[p] * 4, i64, *[i32] * 5, p]
    sine.argtypes = [i32, p, i64, *[p] * 5, i64, *[i32] * 5, p]
    fast.restype = sine.restype = i32

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0
    for label, n, heads, dh in (("vit-s q/k/v", C.BATCH * 197, 6, 64),
                                ("reference q/k/v", 128 * 50, 2, 32)):
        x = cuda(C.fast_inputs(rng, (n, heads * dh)))
        ga = cuda(1 + 0.1 * rng.standard_normal((heads, dh)))
        be = cuda(0.1 * rng.standard_normal((heads, dh)))
        for slices in (9, 8):
            w = cuda(rng.standard_normal((heads, slices, dh, dh)) / np.sqrt(dh * slices))
            ws = FB._tc_grouped_fwd_scratch(w, x.device, "rbf")
            stats = torch.empty(n, heads, 2, device="cuda")

            def route(w=w):
                return FB._launch_rbf("fastkan_qkv_grouped", x, w, ga, be, grid, den)[0]

            def call(v, y, w=w, ws=ws, stats=stats, slices=slices):
                return fast(v, x.data_ptr(), x.stride(0), ga.data_ptr(), be.data_ptr(),
                            grid.data_ptr(), 1.0 / den, w.data_ptr(), y.data_ptr(),
                            stats.data_ptr(), ws.data_ptr(), ws.numel(), n, heads, dh, dh,
                            slices - 8, torch.cuda.current_stream().cuda_stream)

            tag = f"fastkan {label}{'' if slices == 9 else ' no base'}"
            times[tag] = run_variants(C, torch, route, call, SHAPES, tag)
        x = cuda(C.sine_inputs(rng, (n, heads * dh)))
        for gs in (4, 3):
            freq = cuda(np.arange(1, gs + 1) / (gs + 1)
                        + 0.05 * rng.standard_normal((heads, gs)))
            phase = K.sinekan_phase_init(dh, gs).cuda()
            w = cuda(rng.uniform(-1.0, 1.0, (heads, gs, dh, dh)) / dh)
            ws = FB._tc_grouped_fwd_scratch(w, x.device, "sine")

            def route(w=w, freq=freq, phase=phase):
                return FB._launch_sine("sinekan_qkv_grouped", x, w, freq, phase)

            def call(v, y, w=w, freq=freq, phase=phase, ws=ws, gs=gs):
                return sine(v, x.data_ptr(), x.stride(0), freq.data_ptr(), phase.data_ptr(),
                            w.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), n, heads,
                            dh, dh, gs, torch.cuda.current_stream().cuda_stream)

            tag = f"sinekan {label} G{gs}"
            times[tag] = run_variants(C, torch, route, call, SHAPES, tag)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bspline", action="store_true")
    ap.add_argument("--cheby", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    C.phase_build()
    builds = [("probe_qkv_fwd_rbf_sine", *_nvcc(C, RBF_SINE_SOURCE, "probe_qkv_fwd_rbf_sine"))]
    if args.bspline:
        builds.append(("probe_qkv_fwd", *_nvcc(C, SOURCE, "probe_qkv_fwd")))
    if args.cheby:
        builds.append(("probe_qkv_fwd_cheby", *_nvcc(C, CHEBY_SOURCE, "probe_qkv_fwd_cheby")))
    libs = dict((name, _finish(C, proc, lib, name)) for name, proc, lib in builds)
    rng = np.random.default_rng(C.SEED)
    times = {}
    rbf_sine_variants(libs["probe_qkv_fwd_rbf_sine"], C, torch, rng, times)
    if args.bspline:
        bspline_variants(libs["probe_qkv_fwd"].probe_qkv_fwd, C, torch, rng, times)
    if args.cheby:
        cheby_variants(libs["probe_qkv_fwd_cheby"].probe_cheby_fwd, C, torch, rng, times)
    print(f"[probe_qkv_fwd] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()
