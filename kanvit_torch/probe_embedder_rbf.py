"""The patch embedders on the tensor cores: the FastKAN, B-spline and
Chebyshev embedders' forward and backward, their tiles and row splits, and
the routes' kernels timed apart.

    python -m kanvit_torch.probe_embedder_rbf [--bspline] [--fastkan] [--cheby]

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
resident blocks, and its distance from the route's dW (x max|dW|).

``--bspline`` does the same for the B-spline embedder (``bspline_kan``:
12,544 rows, 768 -> 384, 8 cubic bases and the silu slice) from a second
library built from ``csrc/kan_basis.cu`` beside the first: its forward on
``kan_tc_fwd_grouped<Bspline, NT, WARPS, MINB, Tf32x3, FLUSH>`` in the
shapes of ``BSPLINE_SHAPES`` (n8 tiles a warp, so 192, 128 or 64 outputs a
block; warps a block; blocks an SM; the stages a level of the sum, 0 for
one running sum), each against the route's bits, timed, and held against
f64 beside the plain f32 version (inputs as ``chip_smoke.py`` draws them,
and a third at |x| 20-60); its backward (no dx, all gradients, by kernel,
dW and dx against f64) and dW over ``SPLITS``; and both routes (the
tensor cores and the CUDA cores) at the MNIST embedders (1,813 and 6,272
rows, 16 -> 64) and at one vit-s image (196 rows), forward and no-dx
backward, by CUDA events, device time and host time a call, in three turns.

``--fastkan`` builds a library from ``csrc/kan_rbf_sine.cu`` with
``kan_tc_fwd_grouped<Rbf, NT, WARPS, MINB, Tf32x3, FLUSH>`` shapes
(``FASTKAN_SHAPES``: 128- and 64-output tiles, 8 or 12 warps, 1-3 blocks an
SM, flush 6, 12, 24 or none) and times the FastKAN embedder's forward at
vit-s as ``--bspline`` times the B-spline one (each shape against the
route's bits and f64, also with a third of x at |x| 20-60, beside the
CUDA-core kernel), then both routes at the MNIST embedders and one vit-s
image, with their distances from f64. ``--cheby`` builds one from
``csrc/kan_basis.cu`` exposing ``kan_tc_fwd_grouped<Cheby, NT, WARPS, MINB,
Tf32x3, FLUSH>`` shapes (``CHEBY_FWD_SHAPES``: 64-output tiles at 8 warps
and 3 or 2 blocks an SM or 12 warps and one, flush 6, 12, 24 or none, and
a 192-output tile) and ``kan_tc_dw_grouped<Cheby, NJ>`` at a split count,
and times the Chebyshev embedder's forward at vit-s as ``--fastkan`` times
the FastKAN one (no saturated x, and a tenth where tanh rounds to +-1; an
image's rows alone against the batch's bits), both routes' forward at the
small shapes with their distances from f64, then its backward at vit-s (a
tenth saturated: no dx, all gradients, by kernel, dW and dx against f64,
the CUDA-core kernels), dW over ``CHEBY_SPLITS``, and both routes' no-dx
backward at the small shapes. The last line holds the times as JSON.
"""

from __future__ import annotations

import argparse
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


# (n8 tiles a warp, warps a block, blocks an SM, stages a level of the sum)
# of the B-spline embedder's forward; the route's first
BSPLINE_SHAPES = ((24, 12, 1, 12), (24, 12, 1, 0), (24, 12, 1, 24), (16, 12, 1, 12),
                  (8, 12, 2, 12), (8, 8, 2, 12), (8, 8, 3, 12))

BSPLINE_SOURCE = r"""
#include "kan_basis.cu"

extern "C" int probe_bspline_fwd(int v, const float* x, long long ldx, const float* gridt,
                                 long long gstride, const float* w, float* y,
                                 unsigned int* ws, long long ww, int n, int nin, int nout,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Bspline::Params p{gridt, gstride};
  switch (v) {
CASES
  }
  return -1;
}

extern "C" int probe_bspline_dw(int nj, const float* x, long long ldx, const float* gridt,
                                long long gstride, const float* gy, float* dw, float* dw_part,
                                int n, int nin, int nout, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Bspline::Params p{gridt, gstride};
  const int vec = tc_gy_vec(gy, 1, nout);
  if (nj == 1)
    return launch_tc_dw_grouped<Bspline, 1>(x, ldx, p, gy, nout, vec, dw, dw_part, n, 1, nin,
                                            nout, splits, st);
  return launch_tc_dw_grouped<Bspline, 3>(x, ldx, p, gy, nout, vec, dw, dw_part, n, 1, nin,
                                          nout, splits, st);
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Bspline, {nt}, {w}, {mb}, {fl}>(x, ldx, p, "
    f"w, y, ws, ww, n, 1, nin, nout, st);" for i, (nt, w, mb, fl) in enumerate(BSPLINE_SHAPES)))


# The MNIST embedders and one vit-s image: (tag, rows, nin, nout)
SMALL = (("mnist embedder (chip_smoke.py)", 37 * 49, 16, 64),
         ("reference embedder, batch 128", 128 * 49, 16, 64),
         ("vit-s embedder, batch 1", 196, 768, 384))


def routes_in_turns(C, torch, FB, label, parts):
    """Each ``(part, fn)`` of ``parts`` on the tensor cores and on the CUDA
    cores (``cuda_core_route``) in three turns, to see the run's noise: CUDA
    events, device time and host time a call."""
    from kanvit_torch.probe_qkv_fwd import host_ms

    entry = {}
    with torch.inference_mode():
        for turn in range(3):
            for part, fn in parts:
                for route, wrap in (("tensor cores", lambda f: f()),
                                    ("CUDA cores", lambda f: C.cuda_core_route(FB, f))):
                    e = {"ms": wrap(lambda: C.time_ms(torch, fn, iters=200)),
                         "device_ms": wrap(lambda: C.kernel_ms(torch, fn, 50)),
                         "host_ms": wrap(lambda: host_ms(torch, fn))}
                    entry.setdefault(f"{part}, {route}", []).append(e)
                    print(f"[probe_embedder] {label}, turn {turn}, {part} on the {route}: "
                          f"{e['ms']:.4f} ms (device {e['device_ms']:.4f}, host "
                          f"{e['host_ms']:.4f} a call)", flush=True)
    return entry


def f64_dist(got, exact):
    """max|got - exact| x max(1, max|exact|)^-1."""
    return float((got.double() - exact).abs().max()) / max(1.0, float(exact.abs().max()))


def large_silu(rng, x):
    """``x`` with a third of its entries at |x| 20-60, outside every knot
    span, where silu(x) dominates the row."""
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 3, replace=False)
    flat[idx] = rng.uniform(20.0, 60.0, idx.size) * rng.choice([-1.0, 1.0], idx.size)
    return x


def bspline_embedder(lib, C, torch, times):
    """The B-spline embedder's routes, shapes and row splits (``--bspline``)."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import KANLinear
    from kanvit_torch.ops import kan_bases as K

    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd, dw_fn = lib.probe_bspline_fwd, lib.probe_bspline_dw
    fwd.argtypes = [i32, p, i64, p, i64, *[p] * 3, i64, *[i32] * 3, p]
    dw_fn.argtypes = [i32, p, i64, p, i64, *[p] * 3, *[i32] * 4, p]
    fwd.restype = dw_fn.restype = i32
    rng = np.random.default_rng(C.SEED + 10)

    def case(n, nin, nout, large=False):
        layer = KANLinear(nin, nout, generator=torch.Generator().manual_seed(C.SEED)).cuda()
        x = C.spline_inputs(rng, (n, nin), layer.grid[0].cpu().numpy())
        if large:
            x = large_silu(rng, x)
        x = torch.from_numpy(np.asarray(x, np.float32)).cuda()
        params = (layer.grid, layer.base_weight.detach(), layer.spline_weight.detach(),
                  layer.spline_scaler.detach())
        w = FB.pack_weight(*params[1:]).unsqueeze(0).contiguous()
        return x, params, w

    def packed_plain(x, grid, w):  # the plain version over the packed weight
        return K.bspline_kan_forward(x, grid.to(x.dtype), w[0, -1].T, w[0, :-1].permute(2, 1, 0),
                                     None)

    n, nin, nout = C.BATCH * 196, 768, 384
    stream = torch.cuda.current_stream().cuda_stream
    for tag, large in (("vit-s", False), ("vit-s, a third of x at |x| 20-60", True)):
        x, (grid, *_), w = case(n, nin, nout, large)
        gridt, gstride = FB._knot_rows(grid)
        ws = torch.empty(-(-nin // 8) * 9 * 16 * (-(-nout // 64) * 64 + 192), dtype=torch.int32,
                         device="cuda")
        with torch.inference_mode():
            def route():
                return FB._launch("bspline_kan", "bspline", x, w, grid)

            want = route()
            core = C.cuda_core_route(FB, route)
            plain = packed_plain(x, grid, w)
            exact = packed_plain(x.double(), grid, w.double())
            entry = {"route_ms": C.time_ms(torch, route),
                     "route_device_ms": C.kernel_ms(torch, route, 10,
                                                    label=f"bspline_kan {tag}, by kernel"),
                     "cuda_core_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, route)),
                     "f64_route": f64_dist(want, exact), "f64_plain": f64_dist(plain, exact),
                     "f64_cuda_core": f64_dist(core, exact)}
            for v, shape in enumerate(BSPLINE_SHAPES):
                y = torch.empty_like(want)

                def launch(v=v, y=y, shape=shape):
                    err = fwd(v, x.data_ptr(), x.stride(0), gridt.data_ptr(), gstride,
                              w.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), n, nin,
                              nout, stream)
                    C.check(err == 0, f"bspline fwd {shape}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                entry[str(shape)] = {"ms": C.time_ms(torch, launch),
                                     "same_bits": torch.equal(y, want),
                                     "f64": f64_dist(y, exact)}
        times[f"bspline_kan {tag}"] = entry
        print(f"[probe_embedder_bspline] forward {tag}: route {entry['route_ms']:.4f} ms "
              f"(device {entry['route_device_ms']:.4f}), CUDA cores "
              f"{entry['cuda_core_ms']:.4f}; f64: route {entry['f64_route']:.3e}, plain f32 "
              f"{entry['f64_plain']:.3e}, CUDA cores {entry['f64_cuda_core']:.3e}", flush=True)
        for shape in BSPLINE_SHAPES:
            e = entry[str(shape)]
            print(f"[probe_embedder_bspline]   (n8 tiles, warps, blocks an SM, flush) {shape}: "
                  f"{e['ms']:.4f} ms, f64 {e['f64']:.3e}"
                  f"{'' if e['same_bits'] else ' (other bits than the route)'}", flush=True)

    # the backward at vit-s: the route, its kernels, dW's row splits
    x, (grid, *_), w = case(n, nin, nout)
    gridt, gstride = FB._knot_rows(grid)
    g = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).cuda()
    name = "bspline_kan_bwd"

    def bwd(with_dx=False):
        return FB._launch_bwd(name, "bspline", x, w, grid, g, with_dx, True)

    entry = {}
    with torch.inference_mode():
        dx, dw = bwd(True)
        no_dx = bwd()[1]
        entry["no_dx_same_bits"] = torch.equal(no_dx, dw)
    leaves = [a.detach().clone().requires_grad_(True) for a in (x, w)]
    plain = torch.autograd.grad(packed_plain(leaves[0], grid, leaves[1]), leaves, g)
    leaves64 = [a.detach().double().requires_grad_(True) for a in (x, w)]
    exact = torch.autograd.grad(packed_plain(leaves64[0], grid, leaves64[1]), leaves64,
                                g.double())
    for nm, got, pl, ex in (("dx", dx, plain[0], exact[0]), ("dW", dw, plain[1], exact[1])):
        entry[f"f64_{nm}"], entry[f"f64_{nm}_plain"] = f64_dist(got, ex), f64_dist(pl, ex)
    with torch.inference_mode():
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        splits = FB.tc_grouped_dw_splits(n, 1, nin, nout, n_sm)
        entry.update({
            "route_splits": splits,
            "no_dx_ms": C.time_ms(torch, bwd),
            "all_gradients_ms": C.time_ms(torch, lambda: bwd(True)),
            "no_dx_device_ms": C.kernel_ms(torch, bwd, 10, label=f"{name} no dx, by kernel"),
            "all_gradients_device_ms": C.kernel_ms(torch, lambda: bwd(True), 10,
                                                   label=f"{name} all gradients, by kernel"),
            "cuda_core_no_dx_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, bwd)),
            "cuda_core_all_gradients_ms": C.cuda_core_route(
                FB, lambda: C.time_ms(torch, lambda: bwd(True)))})
        print(f"[probe_embedder_bspline] backward vit-s: {splits} splits; no dx "
              f"{entry['no_dx_ms']:.4f} ms (device {entry['no_dx_device_ms']:.4f}), all "
              f"gradients {entry['all_gradients_ms']:.4f} (device "
              f"{entry['all_gradients_device_ms']:.4f}); CUDA cores no dx "
              f"{entry['cuda_core_no_dx_ms']:.4f}, all {entry['cuda_core_all_gradients_ms']:.4f}; "
              f"f64 dW {entry['f64_dW']:.3e} (plain {entry['f64_dW_plain']:.3e}), dx "
              f"{entry['f64_dx']:.3e} (plain {entry['f64_dx_plain']:.3e}); no-dx bits = all "
              f"gradients' bits: {entry['no_dx_same_bits']}", flush=True)
        scale = float(dw.abs().max())
        for nj, count in SPLITS:
            out = torch.empty_like(w)
            part = torch.empty(count, *w.shape, device="cuda")

            def launch(nj=nj, count=count, out=out, part=part):
                err = dw_fn(nj, x.data_ptr(), x.stride(0), gridt.data_ptr(), gstride,
                            g.data_ptr(), out.data_ptr(), part.data_ptr(), n, nin, nout,
                            count, stream)
                C.check(err == 0, f"dW NJ {nj} splits {count}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            blocks = -(-nin // FB.TCG_FEATURES) * -(-nout // (64 * nj)) * count
            entry[f"dW NJ {nj} splits {count}"] = e = {
                "ms": C.time_ms(torch, launch), "waves": blocks / ({3: 1, 1: 2}[nj] * n_sm),
                "diff": float((out - dw).abs().max()) / scale}
            print(f"[probe_embedder_bspline]   dW NJ {nj} splits {count}: {e['ms']:.4f} ms, "
                  f"{blocks} blocks = {e['waves']:.2f} waves, against the route "
                  f"{e['diff']:.2e} x max|dW|", flush=True)
    times["bspline_kan_bwd vit-s"] = entry

    for tag, rows, nin, nout in SMALL:
        x, (grid, *_), w = case(rows, nin, nout)
        g = torch.from_numpy(rng.standard_normal((rows, nout)).astype(np.float32)).cuda()
        times[f"bspline_kan {tag}"] = routes_in_turns(C, torch, FB, f"bspline {tag} {rows} x "
                                                      f"{nin} -> {nout}", (
            ("forward", lambda: FB._launch("bspline_kan", "bspline", x, w, grid)),
            ("no-dx backward", lambda: FB._launch_bwd(name, "bspline", x, w, grid, g, False,
                                                      True))))


# (n8 tiles a warp, warps a block, blocks an SM, stages a level of the sum)
# of the FastKAN embedder's forward; the route's first. No 192-output tile:
# two stages of its 10 steps (the silu slice's remainders the tenth) would
# take 245,760 bytes of shared memory, past a block's 232,448.
FASTKAN_SHAPES = ((8, 12, 1, 12), (8, 12, 1, 6), (8, 12, 1, 24), (8, 12, 1, 0),
                  (8, 8, 2, 12), (8, 8, 3, 12), (16, 8, 1, 12), (16, 12, 1, 12))

FASTKAN_SOURCE = r"""
#include "kan_rbf_sine.cu"

extern "C" int probe_fastkan_fwd(int v, const float* x, long long ldx, const float* gamma,
                                 const float* beta, const float* centres, float inv_h,
                                 const float* stats, const float* w, float* y,
                                 unsigned int* ws, long long ww, int n, int nin, int nout,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Rbf::Params p{stats, gamma, beta, centres, inv_h, 1, 1};
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Rbf, {nt}, {w}, {mb}, {fl}>(x, ldx, p, w, y, "
    f"ws, ww, n, 1, nin, nout, st);" for i, (nt, w, mb, fl) in enumerate(FASTKAN_SHAPES)))

# (NJ, row splits) of the Chebyshev embedder's dW; the route's are (3,
# tc_grouped_dw_splits): 11 at vit-s
CHEBY_SPLITS = ((3, 8), (3, 11), (3, 16), (3, 22), (1, 4), (1, 11), (1, 22))

# (n8 tiles a warp, warps a block, blocks an SM, stages a level of the sum)
# of the Chebyshev embedder's forward; the route's first (kan_basis.cu's
# CHEBY_EMB_WARPS, CHEBY_EMB_MINB, CHEBY_EMB_FLUSH at 64-output tiles)
CHEBY_FWD_SHAPES = ((8, 8, 3, 12), (8, 12, 1, 12), (8, 8, 2, 12), (8, 8, 3, 6),
                    (8, 8, 3, 24), (8, 8, 3, 0), (24, 12, 1, 12), (8, 12, 1, 24),
                    (24, 12, 1, 24), (8, 8, 2, 24))

CHEBY_SOURCE = r"""
#include "kan_basis.cu"

extern "C" int probe_cheby_fwd(int v, const float* x, long long ldx, const float* w, float* y,
                               unsigned int* ws, long long ww, int n, int nin, int nout,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
CASES
  }
  return -1;
}

extern "C" int probe_cheby_dw(int nj, const float* x, long long ldx, const float* gy,
                              float* dw, float* dw_part, int n, int nin, int nout, int splits,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int vec = tc_gy_vec(gy, 1, nout);
  if (nj == 1)
    return launch_tc_dw_grouped<Cheby, 1>(x, ldx, {}, gy, nout, vec, dw, dw_part, n, 1, nin,
                                          nout, splits, st);
  return launch_tc_dw_grouped<Cheby, 3>(x, ldx, {}, gy, nout, vec, dw, dw_part, n, 1, nin,
                                        nout, splits, st);
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_tc_fwd_grouped<Cheby, {nt}, {w}, {mb}, {fl}>(x, ldx, {{}}, w, "
    f"y, ws, ww, n, 1, nin, nout, st);" for i, (nt, w, mb, fl) in enumerate(CHEBY_FWD_SHAPES)))


def fastkan_embedder(lib, C, torch, times):
    """The FastKAN embedder's forward (``--fastkan``): the route and the
    shapes of ``FASTKAN_SHAPES`` at vit-s, each against the route's bits,
    timed (the shapes without the LayerNorm's statistics pass, which the
    route runs first), and held against f64 beside the plain f32 version
    and the CUDA-core kernel (inputs as ``chip_smoke.py`` draws them, and a
    third at |x| 20-60); then both routes at the MNIST embedders and one
    vit-s image."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fwd = lib.probe_fastkan_fwd
    fwd.argtypes = [i32, p, i64, p, p, p, f32, *[p] * 4, i64, *[i32] * 3, p]
    fwd.restype = i32
    rng = np.random.default_rng(C.SEED + 11)
    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    def case(n, nin, nout, large=False):
        x = C.fast_inputs(rng, (n, nin))
        ga, be = cuda(1 + 0.1 * rng.standard_normal((1, nin))), cuda(
            0.1 * rng.standard_normal((1, nin)))
        sw = cuda(rng.standard_normal((nout, nin * 8)) / np.sqrt(nin * 8))
        bw = cuda(rng.standard_normal((nout, nin)) / np.sqrt(nin))
        x = cuda(large_silu(rng, x) if large else x)
        return x, ga, be, sw, bw, FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()

    def plain(x, ga, be, sw, bw):
        return K.fastkan_forward(x, ga[0], be[0], grid.to(x.dtype), den, sw, bw,
                                 torch.zeros(sw.shape[0], dtype=x.dtype, device=x.device))

    def f64_of(x, ga, be, sw, bw):
        return plain(*(a.double() for a in (x, ga, be, sw, bw)))

    n, nin, nout = C.BATCH * 196, 768, 384
    stream = torch.cuda.current_stream().cuda_stream
    ws = torch.empty(-(-nin // 8) * 10 * 16 * (-(-nout // 64) * 64 + 192), dtype=torch.int32,
                     device="cuda")
    for tag, large in (("vit-s", False), ("vit-s, a third of x at |x| 20-60", True)):
        x, ga, be, sw, bw, w = case(n, nin, nout, large)
        with torch.inference_mode():
            def route():
                return FB._launch_rbf("fastkan", x, w, ga, be, grid, den)

            want, stats = route()
            core = C.cuda_core_route(FB, route)[0]
            exact = f64_of(x, ga, be, sw, bw)
            entry = {"route_ms": C.time_ms(torch, route),
                     "route_device_ms": C.kernel_ms(torch, route, 10,
                                                    label=f"fastkan {tag}, by kernel"),
                     "cuda_core_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, route)),
                     "cuda_core_device_ms": C.cuda_core_route(FB, lambda: C.kernel_ms(
                         torch, route, 10, label=f"fastkan {tag}, CUDA cores, by kernel")),
                     "f64_route": f64_dist(want, exact),
                     "f64_plain": f64_dist(plain(x, ga, be, sw, bw), exact),
                     "f64_cuda_core": f64_dist(core, exact)}
            for v, shape in enumerate(FASTKAN_SHAPES):
                y = torch.empty_like(want)

                def launch(v=v, y=y, shape=shape):
                    err = fwd(v, x.data_ptr(), x.stride(0), ga.data_ptr(), be.data_ptr(),
                              grid.data_ptr(), 1.0 / den, stats.data_ptr(), w.data_ptr(),
                              y.data_ptr(), ws.data_ptr(), ws.numel(), n, nin, nout, stream)
                    C.check(err == 0, f"fastkan fwd {shape}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                entry[str(shape)] = {"ms": C.time_ms(torch, launch),
                                     "same_bits": torch.equal(y, want),
                                     "f64": f64_dist(y, exact)}
        times[f"fastkan {tag}"] = entry
        print(f"[probe_embedder_fastkan] forward {tag}: route {entry['route_ms']:.4f} ms "
              f"(device {entry['route_device_ms']:.4f}), CUDA cores "
              f"{entry['cuda_core_ms']:.4f} (device {entry['cuda_core_device_ms']:.4f}); f64: "
              f"route {entry['f64_route']:.3e}, plain f32 {entry['f64_plain']:.3e}, CUDA "
              f"cores {entry['f64_cuda_core']:.3e}", flush=True)
        for shape in FASTKAN_SHAPES:
            e = entry[str(shape)]
            print(f"[probe_embedder_fastkan]   (n8 tiles, warps, blocks an SM, flush) {shape}: "
                  f"{e['ms']:.4f} ms, f64 {e['f64']:.3e}"
                  f"{'' if e['same_bits'] else ' (other bits than the route)'}", flush=True)

    for tag, rows, nin, nout in SMALL:
        x, ga, be, sw, bw, w = case(rows, nin, nout)

        def route(x=x, ga=ga, be=be, w=w):
            return FB._launch_rbf("fastkan", x, w, ga, be, grid, den)

        label = f"fastkan {tag} {rows} x {nin} -> {nout}"
        entry = routes_in_turns(C, torch, FB, label, (("forward", route),))
        with torch.inference_mode():
            exact = f64_of(x, ga, be, sw, bw)
            entry.update({"f64_route": f64_dist(route()[0], exact),
                          "f64_cuda_core": f64_dist(C.cuda_core_route(FB, route)[0], exact),
                          "f64_plain": f64_dist(plain(x, ga, be, sw, bw), exact)})
        print(f"[probe_embedder_fastkan] {label} against f64: tensor cores "
              f"{entry['f64_route']:.3e}, CUDA cores {entry['f64_cuda_core']:.3e}, plain f32 "
              f"{entry['f64_plain']:.3e}", flush=True)
        times[f"fastkan {tag}"] = entry


def cheby_embedder(lib, C, torch, times):
    """The Chebyshev embedder (``--cheby``) at vit-s, x with a share where
    tanh rounds to +-1. Its forward: the route and the shapes of
    ``CHEBY_FWD_SHAPES``, each against the route's bits, timed, and held
    against f64 beside the plain f32 version and the CUDA-core kernel, with
    no saturated entries and with a tenth; then both routes' forward at the
    MNIST embedders and one vit-s image, with their distances from f64. Its
    backward, a tenth saturated: the route (no dx, all gradients, by
    kernel), dW and dx against f64 beside the plain f32 version, the no-dx
    dW's bits against the all-gradients dW's, the CUDA-core kernels; dW
    over ``CHEBY_SPLITS``; then both routes' no-dx backward at the MNIST
    embedders and one vit-s image."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dw_fn, fwd = lib.probe_cheby_dw, lib.probe_cheby_fwd
    dw_fn.argtypes = [i32, p, i64, *[p] * 3, *[i32] * 4, p]
    fwd.argtypes = [i32, p, i64, p, p, p, i64, *[i32] * 3, p]
    dw_fn.restype = fwd.restype = i32
    rng = np.random.default_rng(C.SEED + 12)
    name = "chebykan_bwd"

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    def case(n, nin, nout, saturated=0.1):
        x = cuda(C.cheby_inputs(rng, (n, nin), saturated))
        cc = rng.standard_normal((nin, nout, 5)) / np.sqrt(nin * 5)
        g = cuda(rng.standard_normal((n, nout)))
        return x, FB.pack_cheby_weight(cuda(cc)).contiguous(), g

    def plain(x, w):
        return K.chebykan_forward(x, w[0].permute(1, 2, 0))

    n, nin, nout = C.BATCH * 196, 768, 384
    stream = torch.cuda.current_stream().cuda_stream
    ws = torch.empty(-(-nin // 8) * 5 * 16 * (-(-nout // 64) * 64 + 192), dtype=torch.int32,
                     device="cuda")
    for tag, saturated in (("vit-s", 0.0), ("vit-s, a tenth of x where tanh rounds to +-1",
                                            0.1)):
        x, w, _ = case(n, nin, nout, saturated)
        with torch.inference_mode():
            def route():
                return FB._launch("chebykan", "cheby", x, w, 4)

            want = route()
            core = C.cuda_core_route(FB, route)
            exact = plain(x.double(), w.double())
            entry = {"route_ms": C.time_ms(torch, route),
                     "route_device_ms": C.kernel_ms(torch, route, 10,
                                                    label=f"chebykan {tag}, by kernel"),
                     "cuda_core_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, route)),
                     "cuda_core_device_ms": C.cuda_core_route(FB, lambda: C.kernel_ms(
                         torch, route, 10, label=f"chebykan {tag}, CUDA cores, by kernel")),
                     "f64_route": f64_dist(want, exact), "f64_plain": f64_dist(plain(x, w), exact),
                     "f64_cuda_core": f64_dist(core, exact),
                     "image_bits": torch.equal(FB._launch("chebykan", "cheby", x[:196], w, 4),
                                               want[:196])}
            for v, shape in enumerate(CHEBY_FWD_SHAPES):
                y = torch.empty_like(want)

                def launch(v=v, y=y, shape=shape):
                    err = fwd(v, x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr(),
                              ws.data_ptr(), ws.numel(), n, nin, nout, stream)
                    C.check(err == 0, f"cheby fwd {shape}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                entry[str(shape)] = {"ms": C.time_ms(torch, launch),
                                     "same_bits": torch.equal(y, want),
                                     "f64": f64_dist(y, exact)}
        times[f"chebykan {tag}"] = entry
        print(f"[probe_embedder_cheby] forward {tag}: route {entry['route_ms']:.4f} ms "
              f"(device {entry['route_device_ms']:.4f}), CUDA cores "
              f"{entry['cuda_core_ms']:.4f} (device {entry['cuda_core_device_ms']:.4f}); f64: "
              f"route {entry['f64_route']:.3e}, plain f32 {entry['f64_plain']:.3e}, CUDA "
              f"cores {entry['f64_cuda_core']:.3e}; an image's rows alone give the batch's "
              f"bits: {entry['image_bits']}", flush=True)
        for shape in CHEBY_FWD_SHAPES:
            e = entry[str(shape)]
            print(f"[probe_embedder_cheby]   (n8 tiles, warps, blocks an SM, flush) {shape}: "
                  f"{e['ms']:.4f} ms, f64 {e['f64']:.3e}"
                  f"{'' if e['same_bits'] else ' (other bits than the route)'}", flush=True)

    for tag, rows, nin_s, nout_s in SMALL:
        x, w, _ = case(rows, nin_s, nout_s)

        def route(x=x, w=w):
            return FB._launch("chebykan", "cheby", x, w, 4)

        label = f"chebykan {tag} {rows} x {nin_s} -> {nout_s}"
        entry = routes_in_turns(C, torch, FB, label, (("forward", route),))
        with torch.inference_mode():
            exact = plain(x.double(), w.double())
            entry.update({"f64_route": f64_dist(route(), exact),
                          "f64_cuda_core": f64_dist(C.cuda_core_route(FB, route), exact),
                          "f64_plain": f64_dist(plain(x, w), exact)})
        print(f"[probe_embedder_cheby] {label} against f64: tensor cores "
              f"{entry['f64_route']:.3e}, CUDA cores {entry['f64_cuda_core']:.3e}, plain f32 "
              f"{entry['f64_plain']:.3e}", flush=True)
        times[f"chebykan {tag}"] = entry

    def grads(x, w, g, dtype):
        leaves = [a.detach().to(dtype).requires_grad_(True) for a in (x, w)]
        return torch.autograd.grad(plain(*leaves), leaves, g.to(dtype))

    x, w, g = case(n, nin, nout)

    def bwd(with_dx=False):
        return FB._launch_bwd(name, "cheby", x, w, 4, g, with_dx, True)

    entry = {}
    with torch.inference_mode():
        dx, dw = bwd(True)
        no_dx = bwd()[1]
        entry["no_dx_same_bits"] = torch.equal(no_dx, dw)
        entry["dx_finite"] = bool(dx.isfinite().all())
    plain32, exact = grads(x, w, g, torch.float32), grads(x, w, g, torch.float64)
    for nm, got, pl, ex in zip(("dx", "dW"), (dx, dw), plain32, exact):
        entry[f"f64_{nm}"], entry[f"f64_{nm}_plain"] = f64_dist(got, ex), f64_dist(pl, ex)
    with torch.inference_mode():
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        splits = FB.tc_grouped_dw_splits(n, 1, nin, nout, n_sm)
        entry.update({
            "route_splits": splits,
            "no_dx_ms": C.time_ms(torch, bwd),
            "all_gradients_ms": C.time_ms(torch, lambda: bwd(True)),
            "no_dx_device_ms": C.kernel_ms(torch, bwd, 10, label=f"{name} no dx, by kernel"),
            "all_gradients_device_ms": C.kernel_ms(torch, lambda: bwd(True), 10,
                                                   label=f"{name} all gradients, by kernel"),
            "cuda_core_no_dx_ms": C.cuda_core_route(FB, lambda: C.time_ms(torch, bwd)),
            "cuda_core_all_gradients_ms": C.cuda_core_route(
                FB, lambda: C.time_ms(torch, lambda: bwd(True)))})
        print(f"[probe_embedder_cheby] backward vit-s: {splits} splits; no dx "
              f"{entry['no_dx_ms']:.4f} ms (device {entry['no_dx_device_ms']:.4f}), all "
              f"gradients {entry['all_gradients_ms']:.4f} (device "
              f"{entry['all_gradients_device_ms']:.4f}); CUDA cores no dx "
              f"{entry['cuda_core_no_dx_ms']:.4f}, all {entry['cuda_core_all_gradients_ms']:.4f}; "
              f"f64 dW {entry['f64_dW']:.3e} (plain {entry['f64_dW_plain']:.3e}), dx "
              f"{entry['f64_dx']:.3e} (plain {entry['f64_dx_plain']:.3e}), dx finite "
              f"{entry['dx_finite']}; no-dx bits = all gradients' bits: "
              f"{entry['no_dx_same_bits']}", flush=True)
        scale = float(dw.abs().max())
        for nj, count in CHEBY_SPLITS:
            out = torch.empty_like(w)
            part = torch.empty(count, *w.shape, device="cuda")

            def launch(nj=nj, count=count, out=out, part=part):
                err = dw_fn(nj, x.data_ptr(), x.stride(0), g.data_ptr(), out.data_ptr(),
                            part.data_ptr(), n, nin, nout, count,
                            torch.cuda.current_stream().cuda_stream)
                C.check(err == 0, f"dW NJ {nj} splits {count}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            blocks = -(-nin // FB.TCG_FEATURES) * -(-nout // (64 * nj)) * count
            entry[f"dW NJ {nj} splits {count}"] = e = {
                "ms": C.time_ms(torch, launch), "waves": blocks / ({3: 1, 1: 2}[nj] * n_sm),
                "diff": float((out - dw).abs().max()) / scale}
            print(f"[probe_embedder_cheby]   dW NJ {nj} splits {count}: {e['ms']:.4f} ms, "
                  f"{blocks} blocks = {e['waves']:.2f} waves, against the route "
                  f"{e['diff']:.2e} x max|dW|", flush=True)
    times["chebykan_bwd vit-s"] = entry

    for tag, rows, nin, nout in SMALL:
        x, w, g = case(rows, nin, nout)
        times[f"chebykan_bwd {tag}"] = routes_in_turns(
            C, torch, FB, f"chebykan {tag} {rows} x {nin} -> {nout}",
            (("no-dx backward", lambda x=x, w=w, g=g: FB._launch_bwd(
                name, "cheby", x, w, 4, g, False, True)),))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bspline", action="store_true")
    ap.add_argument("--fastkan", action="store_true")
    ap.add_argument("--cheby", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.probe_qkv_fwd import _finish, _nvcc

    torch, smi = C.phase_toolchain()
    C.phase_build()
    builds = [("probe_embedder_rbf", *_nvcc(C, SOURCE, "probe_embedder_rbf"))]
    for flag, source, name in ((args.bspline, BSPLINE_SOURCE, "probe_embedder_bspline"),
                               (args.fastkan, FASTKAN_SOURCE, "probe_embedder_fastkan"),
                               (args.cheby, CHEBY_SOURCE, "probe_embedder_cheby")):
        if flag:
            builds.append((name, *_nvcc(C, source, name)))
    libs = {name: _finish(C, proc, lib, name) for name, proc, lib in builds}
    lib = libs["probe_embedder_rbf"]
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
    if args.bspline:
        bspline_embedder(libs["probe_embedder_bspline"], C, torch, times)
    if args.fastkan:
        fastkan_embedder(libs["probe_embedder_fastkan"], C, torch, times)
    if args.cheby:
        cheby_embedder(libs["probe_embedder_cheby"], C, torch, times)
    print(f"[probe_embedder_rbf] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()
