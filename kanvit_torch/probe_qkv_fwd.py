"""The grouped B-spline q/k/v forward's tile and basis variants on the card.

    python -m kanvit_torch.probe_qkv_fwd

Builds the kernels, then a second library from ``csrc/kan_basis.cu`` with
variants of ``kan_tc_fwd_grouped`` (``csrc/kan_basis_tc.cuh``, part 3): the
route's own (12 warps of 16 rows; 192 outputs a block past 64 outputs, 64
up to them), 8 warps, 64-output tiles at every width (the basis made once
for each tile), and each with the B-spline basis from local support (the 4
nonzero cubic bases of x's knot interval by the same Cox-de Boor
expressions, the rest set to 0). Each runs at the vit-s q/k/v (12,608 rows,
6 heads of 64 -> 192), a refit grid a head (one projection, 64 outputs) and
dh 8 (MNIST, 24 outputs), against the route's output bit for bit, timed by
CUDA events beside the route and the CUDA-core kernel it replaced. The last
line holds the times as JSON.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = ("route", "8 warps", "64-output tiles", "route, local support",
            "64-output tiles, local support")

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
          uint32_t* ws, int n, int groups, int nin, int nout, cudaStream_t st) {
  if (nout <= 64) return launch_tc_fwd_grouped<F, 8>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
  return launch_tc_fwd_grouped<F, 24>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
}
}  // namespace

extern "C" int probe_qkv_fwd(int variant, const float* x, long long ldx, const float* gridt,
                             long long gstride, const float* w, float* y, unsigned int* ws,
                             int n, int groups, int nin, int nout, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Bspline::Params p{gridt, gstride};
  switch (variant) {
    case 0: return route<Bspline>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
    case 1:
      if (nout <= 64) return launch_tc_fwd_grouped<Bspline, 8, 8>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
      return launch_tc_fwd_grouped<Bspline, 24, 8>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
    case 2: return launch_tc_fwd_grouped<Bspline, 8>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
    case 3: return route<BsplineLocal>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
    case 4: return launch_tc_fwd_grouped<BsplineLocal, 8>(x, ldx, p, w, y, ws, n, groups, nin, nout, st);
  }
  return -1;
}
"""


def build_variants(C):
    from kanvit_torch.kernels import _build

    out = _build.BUILD_ROOT / f"probe_qkv_fwd_{_build.source_hash()}"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "variants.cu", out / "libprobe_qkv_fwd.so"
    src.write_text(SOURCE)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(_build.CSRC), "-o", str(lib), str(src)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    C.check(run.returncode == 0, f"the variants did not build:\n{run.stdout}{run.stderr}")
    keep = False
    for line in (run.stdout + run.stderr).splitlines():
        if "Compiling entry" in line:
            keep = "kan_tc_fwd_grouped" in line
            if keep:
                print(f"[probe_qkv_fwd] {line.split('kan_tc_fwd_grouped')[1][:60]}")
        elif keep and ("registers" in line or "spill" in line):
            print(f"[probe_qkv_fwd]     {line.strip()}")
    fn = ctypes.CDLL(str(lib)).probe_qkv_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 4,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from kanvit_torch.kernels import fused_basis as FB

    torch, smi = C.phase_toolchain()
    C.phase_build()
    fn = build_variants(C)
    rng = np.random.default_rng(C.SEED)
    times = {}
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
        with torch.inference_mode():
            want = FB._launch("bspline_qkv_grouped", "bspline", x, w, grid)
            entry = {"route_ms": C.time_ms(torch, lambda: FB._launch(
                "bspline_qkv_grouped", "bspline", x, w, grid))}
            entry["cuda_core_ms"] = C.cuda_core_route(FB, lambda: C.time_ms(
                torch, lambda: FB._launch("bspline_qkv_grouped", "bspline", x, w, grid)))
            for v, name in enumerate(VARIANTS):
                y = torch.empty_like(want)

                def call(v=v, y=y):
                    err = fn(v, x.data_ptr(), x.stride(0), gridt.data_ptr(), gstride,
                             w.data_ptr(), y.data_ptr(), ws.data_ptr(), n, groups, nin, nout,
                             torch.cuda.current_stream().cuda_stream)
                    C.check(err == 0, f"{name}: launch failed with CUDA error {err}")

                call()
                torch.cuda.synchronize()
                entry[name] = {"ms": C.time_ms(torch, call), "same_bits": torch.equal(y, want)}
        print(f"[probe_qkv_fwd] {label}: " + "  ".join(
            f"{k} {v['ms']:.4f} ms{'' if v['same_bits'] else ' (other bits)'}"
            if isinstance(v, dict) else f"{k} {v:.4f} ms" for k, v in entry.items()))
        times[label] = entry
    print(f"[probe_qkv_fwd] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()
