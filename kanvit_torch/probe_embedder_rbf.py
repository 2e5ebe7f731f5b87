"""The FastKAN embedder's backward on the tensor cores: its dW's tiles and
row splits, and the route's kernels timed apart.

    python -m kanvit_torch.probe_embedder_rbf

Builds the kernels, then a library from ``csrc/kan_rbf_sine.cu`` that runs
``kan_tc_dw_grouped<Rbf, NJ>`` (``csrc/kan_basis_tc.cuh``, part 2) at a
given row-split count: NJ 3 (192-output tiles, one block an SM, the
route's past 64 outputs) and NJ 1 (64-output tiles, two blocks an SM, the
basis made three times as often). At the vit-s embedder (12,544 rows, 768
-> 384, the LayerNorm, 8 centres and the silu slice) it times the route's
training-step backward (no dx) and its all-gradients backward by CUDA
events, the no-dx route's device time by kernel (the dx kernel writing dln,
the W^T split, the LayerNorm's dgamma and dbeta partials and their sums,
dW and its split sums) and the CUDA-core kernels it replaced; then each
(NJ, splits) of ``SPLITS``: its time, its blocks in waves of one SM's
resident blocks, and its distance from the route's dW (x max|dW|). The
last line holds the times as JSON.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (NJ, row splits) of the dW kernel; the route's are (3, tc_grouped_dw_splits)
SPLITS = ((3, 4), (3, 5), (3, 6), (3, 8), (3, 11), (3, 16), (3, 22), (1, 2), (1, 4),
          (1, 11))

SOURCE = r"""
#include "kan_rbf_sine.cu"

extern "C" int probe_rbf_dw(int nj, const float* x, long long ldx, const float* gamma,
                            const float* beta, const float* centres, float inv_h,
                            const float* stats, const float* gy, float* dw, float* dw_part,
                            int n, int nin, int nout, int base, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Rbf::Params p{stats, gamma, beta, centres, inv_h, 1, base};
  const int vec = tc_gy_vec(gy, 1, nout);
  if (nj == 1)
    return launch_tc_dw_grouped<Rbf, 1>(x, ldx, p, gy, nout, vec, dw, dw_part, n, 1, nin,
                                        nout, splits, st);
  return launch_tc_dw_grouped<Rbf, 3>(x, ldx, p, gy, nout, vec, dw, dw_part, n, 1, nin, nout,
                                      splits, st);
}
"""


def main(argv=None) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.probe_qkv_fwd import _finish, _nvcc

    torch, smi = C.phase_toolchain()
    C.phase_build()
    lib = _finish(C, *_nvcc(C, SOURCE, "probe_embedder_rbf"), "probe_embedder_rbf")
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn = lib.probe_rbf_dw
    fn.argtypes = [i32, p, i64, p, p, p, f32, *[p] * 4, *[i32] * 5, p]
    fn.restype = i32

    rng = np.random.default_rng(C.SEED + 9)
    n, nin, nout = C.BATCH * 196, 768, 384

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    x = cuda(C.fast_inputs(rng, (n, nin)))
    ga = cuda(1 + 0.1 * rng.standard_normal((1, nin)))
    be = cuda(0.1 * rng.standard_normal((1, nin)))
    sw = cuda(rng.standard_normal((nout, nin * 8)) / np.sqrt(nin * 8))
    bw = cuda(rng.standard_normal((nout, nin)) / np.sqrt(nin))
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()
    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0
    g = cuda(rng.standard_normal((n, nout)))
    name = "fastkan_bwd"
    with torch.inference_mode():
        _, stats = FB._launch_rbf("fastkan", x, w, ga, be, grid, den)

        def route(with_dx=False):
            return FB._launch_rbf_bwd(name, x, w, ga, be, grid, den, stats, g, with_dx, True)

        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        splits = FB.tc_grouped_dw_splits(n, 1, nin, nout, n_sm)
        want = route()[1]
        scale = float(want.abs().max())
        times = {"route_splits": splits,
                 "no_dx_ms": C.time_ms(torch, route),
                 "all_gradients_ms": C.time_ms(torch, lambda: route(True)),
                 "no_dx_device_ms": C.kernel_ms(torch, route, 10,
                                                label="fastkan_bwd no dx, by kernel"),
                 "cuda_core_no_dx_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, route)),
                 "cuda_core_no_dx_device_ms": C.cuda_core_route(FB, lambda: C.kernel_ms(
                     torch, route, 10, label="fastkan_bwd no dx, CUDA cores, by kernel"))}
        print(f"[probe_embedder_rbf] route: {splits} splits; no dx {times['no_dx_ms']:.4f} "
              f"ms (device {times['no_dx_device_ms']:.4f}), all gradients "
              f"{times['all_gradients_ms']:.4f}; CUDA cores no dx "
              f"{times['cuda_core_no_dx_ms']:.4f} (device "
              f"{times['cuda_core_no_dx_device_ms']:.4f})", flush=True)
        per_sm = {3: 1, 1: 2}  # tc_dw_blocks<9, NJ>
        for nj, count in SPLITS:
            dw = torch.empty_like(w)
            part = torch.empty(count, *w.shape, device="cuda")

            def launch(nj=nj, count=count, dw=dw, part=part):
                err = fn(nj, x.data_ptr(), x.stride(0), ga.data_ptr(), be.data_ptr(),
                         grid.data_ptr(), 1.0 / den, stats.data_ptr(), g.data_ptr(),
                         dw.data_ptr(), part.data_ptr(), n, nin, nout, 1, count,
                         torch.cuda.current_stream().cuda_stream)
                C.check(err == 0, f"dW NJ {nj} splits {count}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            blocks = -(-nin // FB.TCG_FEATURES) * -(-nout // (64 * nj)) * count
            entry = {"ms": C.time_ms(torch, launch),
                     "waves": blocks / (per_sm[nj] * n_sm),
                     "diff": float((dw - want).abs().max()) / scale}
            times[f"dW NJ {nj} splits {count}"] = entry
            print(f"[probe_embedder_rbf] dW NJ {nj} splits {count}: {entry['ms']:.4f} ms, "
                  f"{blocks} blocks = {entry['waves']:.2f} waves, against the route "
                  f"{entry['diff']:.2e} x max|dW|", flush=True)
    print(f"[probe_embedder_rbf] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()
