"""The Fourier and sine KAN kernels' tensor-core arithmetic, emulated on the CPU.

``fourierkan`` and ``sinekan`` run their forward and weight gradient on
``mma.sync.m16n8k8`` in 3xTF32 (``kanvit_torch/kernels/csrc/kan_basis_tc.cuh``):
each f32 operand split into big + small TF32 words, each 8-deep step of the
contracted index small*big + big*small + big*big into a zeroed accumulator
that an f32 add takes into the running sum (``product`` of
``test_torch_port_attention_tc.py``), and the running sum two-level: every 28
stages of 32 entries it is added into a total and restarted. Here that
arithmetic replaces the wrappers' launches, in the kernels' own order of the
contracted index:

- the Fourier forward: stages of 16 features x one harmonic, entries 0-15
  cos(kx), 16-31 sin(kx), the harmonics inside each chunk of 16 features;
- the sine forward: stages of 32 features x one slice;
- dW: stages of 32 rows; sine's dfreq by the D route, D = (x cos(arg))^T gy
  with the same sums, each block's sum of W D over its 48 features and 192
  outputs, and the blocks summed in ``sum_blocks_kernel``'s order;
- dx (where asked) on the CUDA-core kernels' formulas, as
  ``test_torch_port_kernels.py`` emulates them.

The results are held against kanvit's Pallas ``fourierkan`` / ``sinekan`` in
interpret mode and ``jax.grad`` through them: values and every gradient
within 1e-5 x max(1, max|.|), with and without dx, at odd grids (5, 7),
ragged rows, features and outputs, and more than one flush group. At the
embedder's depth (nin 768, G 28 forward; 12,544 rows dW) 3xTF32 meets
``TOL_KAN`` against the plain f32 version and stays within twice the plain
f32's distance from f64; one running sum without the second level does not,
and neither does 1xTF32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_attention_tc import product
from test_torch_port_kernels import _emu_bwd, _emu_fwd, _jax_grads
from test_torch_port_sine import _emu_sine_bwd, _emu_sine_fwd

TOL = 1e-5
TOL_KAN = 1e-4     # chip_smoke.py's gate against the plain version
STAGE = FB.TC_STAGE
FLUSH = 28         # stages a level of the two-level sum
RED_THREADS = 256  # sum_blocks_kernel's threads


def _pad(t: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    extra = -t.shape[dim] % mult
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def two_level(a: torch.Tensor, b: torch.Tensor, passes="3xtf32", flush=FLUSH):
    """``a @ b`` as the kernels sum it: 8-deep 3xTF32 steps into a running
    sum over ``flush`` stages of 32 entries, each such sum added into the
    total in order. ``flush=None``: one running sum over all."""
    a, b = _pad(a, -1, STAGE), _pad(b, 0, STAGE)
    span = a.shape[-1] if flush is None else flush * STAGE
    total = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, a.shape[-1], span):
        total = total + product(a[:, c:c + span], b[c:c + span], passes=passes)
    return total


def fourier_fwd_order(basis, w, grid_size):
    """The Fourier forward's A (N, K) and B (K, out) in the kernel's order:
    per chunk of 16 features, per harmonic, cos then sin of the 16."""
    n, nin, _ = basis.shape
    a = _pad(basis, 1, 16).reshape(n, -1, 16, 2, grid_size).permute(0, 1, 4, 3, 2)
    b = _pad(w, 1, 16).reshape(2, grid_size, -1, 16, w.shape[-1]).permute(2, 1, 0, 3, 4)
    return a.reshape(n, -1), b.reshape(-1, w.shape[-1])


def sine_fwd_order(basis, w):
    """The sine forward's A and B: per chunk of 32 features, per slice."""
    n, _, slices = basis.shape
    a = _pad(basis, 1, 32).reshape(n, -1, 32, slices).permute(0, 1, 3, 2)
    b = _pad(w, 1, 32).reshape(slices, -1, 32, w.shape[-1]).permute(1, 0, 2, 3)
    return a.reshape(n, -1), b.reshape(-1, w.shape[-1])


def weight_grad(basis, gy, passes="3xtf32", flush=FLUSH):
    """dW (S, nin, out) = basis^T gy over the rows in stages of 32."""
    n, nin, slices = basis.shape
    at = basis.permute(2, 1, 0).reshape(slices * nin, n)
    return two_level(at, gy, passes, flush).reshape(slices, nin, -1)


def sum_blocks(parts: torch.Tensor) -> torch.Tensor:
    """``sum_blocks_kernel``: strided sums over 256 threads, then a tree."""
    acc = torch.zeros(RED_THREADS, *parts.shape[1:])
    for b in range(parts.shape[0]):
        acc[b % RED_THREADS] = acc[b % RED_THREADS] + parts[b]
    width = RED_THREADS // 2
    while width:
        acc = acc[:width] + acc[width:2 * width]
        width //= 2
    return acc[0]


def dfreq_of(w, d):
    """Each block's sum of W D over its 48 features and 192 outputs, the
    blocks (feature tile, output tile) in order, summed per slice."""
    slices, nin, out = w.shape
    parts = [(w[:, f0:f0 + FB.TC_DW_FEATURES, o0:o0 + FB.TC_OUTS]
              * d[:, f0:f0 + FB.TC_DW_FEATURES, o0:o0 + FB.TC_OUTS]).sum((1, 2))
             for f0 in range(0, nin, FB.TC_DW_FEATURES)
             for o0 in range(0, out, FB.TC_OUTS)]
    return sum_blocks(torch.stack(parts))


def emu_fwd(name, family, x2d, w, aux, passes="3xtf32", flush=FLUSH):
    """``_launch``: Fourier on the tensor cores, the rest as before."""
    if family != "fourier":
        return _emu_fwd(name, family, x2d, w, aux)
    FB.check_fourier_args(x2d, w, aux)
    a, b = fourier_fwd_order(K.fourier_bases(x2d, aux), w[0], aux)
    FB.LAUNCHES[name] += 1
    return two_level(a, b, passes, flush)


def emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
    """``_launch_bwd``: Fourier's dx on the CUDA-core formulas, its dW on the
    tensor cores."""
    if family != "fourier":
        return _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw)
    FB.check_fourier_args(x2d, w, aux)
    basis, deriv = K.fourier_bases_and_grad(x2d, aux)
    dx = (torch.einsum("no,sio->nis", gy, w[0]) * deriv).sum(-1) if need_dx else None
    dw = weight_grad(basis, gy).unsqueeze(0) if need_dw else None
    FB.LAUNCHES[name] += 1
    return dx, dw


def _sine_basis(x2d, freq2d, phase):
    arg = x2d.unsqueeze(-1) * freq2d[0] + phase
    return arg, torch.sin(arg)


def emu_sine_fwd(name, x2d, w, freq2d, phase, passes="3xtf32", flush=FLUSH):
    """``_launch_sine``: ``sinekan`` on the tensor cores, the grouped q/k/v
    on the CUDA-core emulation."""
    if name not in FB.TC_ROUTES:
        return _emu_sine_fwd(name, x2d, w, freq2d, phase)
    FB.check_sine_args(x2d, w, freq2d, phase, True)
    a, b = sine_fwd_order(_sine_basis(x2d, freq2d, phase)[1], w[0])
    FB.LAUNCHES[name] += 1
    return two_level(a, b, passes, flush)


def emu_sine_bwd(name, x2d, w, freq2d, phase, gy, need_dx, need_dw):
    """``_launch_sine_bwd``: for ``sinekan`` dx (if asked) on the CUDA-core
    formulas, dW and D on the tensor cores, dfreq from D."""
    if name[:-len("_bwd")] not in FB.TC_ROUTES:
        return _emu_sine_bwd(name, x2d, w, freq2d, phase, gy, need_dx, need_dw)
    FB.check_sine_args(x2d, w, freq2d, phase, True)
    arg, sin = _sine_basis(x2d, freq2d, phase)
    cos = torch.cos(arg)
    dx = ((torch.einsum("no,sio->nis", gy, w[0]) * freq2d[0] * cos).sum(-1)
          if need_dx else None)
    dw = weight_grad(sin, gy)
    d = weight_grad(x2d.unsqueeze(-1) * cos, gy)
    FB.LAUNCHES[name] += 1
    return dx, dw.unsqueeze(0) if need_dw else None, dfreq_of(w[0], d).unsqueeze(0)


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations run thousands of 8-deep products: one intra-op thread
    a test process, so parallel test workers do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_math(monkeypatch):
    """The CUDA path's Functions with each launch replaced by the
    emulations, kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", emu_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_bwd)
    monkeypatch.setattr(FB, "_launch_sine", emu_sine_fwd)
    monkeypatch.setattr(FB, "_launch_sine_bwd", emu_sine_bwd)
    yield
    jdispatch.set_impl("auto")


def _inputs(rng, shape, spread):
    """Normal inputs, every 7th entry spread over [-spread, spread]."""
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = rng.uniform(-spread, spread, x.reshape(-1)[::7].size)
    return x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _grads_against_kanvit(jfn, tfn, arrays, g, with_dx):
    """kanvit's output and gradients against the port's, through the
    emulated kernels; without dx, x is no leaf (the embedder's step)."""
    want_y, want = _jax_grads(jfn, arrays, g)
    leaves = [torch.from_numpy(a).requires_grad_(with_dx or i > 0)
              for i, a in enumerate(arrays)]
    got_y = tfn(*leaves)
    asked = leaves if with_dx else leaves[1:]
    got = torch.autograd.grad(got_y, asked, torch.from_numpy(g))
    assert _rel(got_y.detach(), want_y) <= TOL
    for i, (a, b) in enumerate(zip(got, want if with_dx else want[1:])):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL, i


# (grid, n, nin, nout): odd grids, ragged rows, features and outputs; 35
# forward stages (two flush groups) at nin 80 G 7; two output tiles at nout
# 200; 32 dW stages (two flush groups) at n 1000.
SHAPES = [(5, 37, 20, 24), (7, 53, 80, 70), (7, 1000, 9, 200)]


@pytest.mark.parametrize("grid_size,n,nin,nout", SHAPES)
@pytest.mark.parametrize("with_dx", [True, False])
def test_fourierkan_tc_matches_kanvit(kernel_math, grid_size, n, nin, nout, with_dx):
    rng = np.random.default_rng(170 + grid_size + nin)
    x = _inputs(rng, (n, nin), 10.0)
    coeffs = (rng.standard_normal((2, nout, nin, grid_size))
              / np.sqrt(nin * grid_size)).astype(np.float32)
    bias = (rng.standard_normal(nout) * 0.1).astype(np.float32)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    _grads_against_kanvit(JFB.fourierkan, FB.fourierkan, (x, coeffs, bias), g, with_dx)
    assert {k: v for k, v in FB.LAUNCHES.items() if v} == {"fourierkan": 1,
                                                             "fourierkan_bwd": 1}


@pytest.mark.parametrize("grid_size,n,nin,nout", [(5, 37, 20, 24), (7, 1000, 40, 70),
                                                  (7, 60, 130, 200)])
@pytest.mark.parametrize("with_dx", [True, False])
def test_sinekan_tc_matches_kanvit(kernel_math, grid_size, n, nin, nout, with_dx):
    """Values, dx, dfreq (the D route), damplitudes and dbias; 35 forward
    stages at nin 130 G 7, three dW feature tiles and two output tiles
    there, 32 dW stages at n 1000."""
    rng = np.random.default_rng(180 + grid_size + nin)
    x = _inputs(rng, (n, nin), 20.0)
    freq = (np.arange(1, grid_size + 1) / (grid_size + 1)
            + 0.05 * rng.standard_normal(grid_size)).astype(np.float32)
    amps = (rng.uniform(-1.0, 1.0, (nout, nin, grid_size)) / nout).astype(np.float32)
    bias = (rng.standard_normal(nout) * 0.1).astype(np.float32)
    phase = K.sinekan_phase_init(nin, grid_size)
    jphase = jnp.asarray(phase.numpy())
    g = rng.standard_normal((n, nout)).astype(np.float32)
    _grads_against_kanvit(lambda x, f, a, b: JFB.sinekan(x, f, jphase, a, b),
                          lambda x, f, a, b: FB.sinekan(x, f, phase, a, b),
                          (x, freq, amps, bias), g, with_dx)
    assert {k: v for k, v in FB.LAUNCHES.items() if v} == {"sinekan": 1, "sinekan_bwd": 1}


def _embedder_x(rng, rows, nin, spread):
    return torch.from_numpy(_inputs(rng, (rows, nin), spread))


def _gates(name, got, plain, exact):
    """(kernel against plain, kernel against f64, plain against f64), each
    x max(1, max|exact|)."""
    scale = max(1.0, float(exact.abs().max()))
    errs = (float((got - plain).abs().max()) / scale,
            float((got.double() - exact).abs().max()) / scale,
            float((plain.double() - exact).abs().max()) / scale)
    print(f"{name}: against plain {errs[0]:.3e}, against f64 {errs[1]:.3e}, "
          f"plain against f64 {errs[2]:.3e}")
    return errs


@pytest.mark.parametrize("family", ["fourier", "sine"])
def test_embedder_depth_forward_3xtf32_meets_the_gates(family):
    """The vit-s embedder's depth (nin 768, G 28: 43,008 Fourier and 21,504
    sine entries), 48 rows, 384 outputs: 3xTF32 with the two-level sum
    within TOL_KAN of the plain f32 version and within 2x its distance from
    f64; 1xTF32 past both."""
    rng = np.random.default_rng(200)
    nin, nout, gs, rows = 768, 384, 28, 48
    if family == "fourier":
        x = _embedder_x(rng, rows, nin, 10.0)
        co = torch.from_numpy((rng.standard_normal((2, nout, nin, gs))
                               / np.sqrt(nin * gs)).astype(np.float32))
        plain = K.fourierkan_forward(x, co, None)
        exact = K.fourierkan_forward(x.double(), co.double(), None)
        w = FB.pack_fourier_weight(co)

        def run(passes):
            return emu_fwd("fourierkan", "fourier", x, w, gs, passes)
    else:
        x = _embedder_x(rng, rows, nin, 20.0)
        freq = torch.from_numpy(np.arange(1, gs + 1, dtype=np.float32) / (gs + 1))
        amps = torch.from_numpy((rng.uniform(-1.0, 1.0, (nout, nin, gs)) / nout)
                                .astype(np.float32))
        phase = K.sinekan_phase_init(nin, gs)
        plain = K.sinekan_forward(x, freq, phase, amps, None)
        exact = K.sinekan_forward(x.double(), freq.double(), phase.double(),
                                  amps.double(), None)
        w = FB.pack_sine_weight(amps).contiguous()

        def run(passes):
            return emu_sine_fwd("sinekan", x, w, freq.reshape(1, -1), phase, passes)
    got = _gates(f"{family} 3xtf32", run("3xtf32"), plain, exact)
    one = _gates(f"{family} 1xtf32", run("1xtf32"), plain, exact)
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got
    assert one[0] > TOL_KAN and one[1] > 2 * one[2], one


@pytest.mark.parametrize("family", ["fourier", "sine"])
def test_embedder_depth_weight_grad_two_level_meets_the_gates(family):
    """dW (and sine's dfreq) over the vit-s embedder's 12,544 rows, for 12
    of its features, G 28, 384 outputs: the two-level sum within TOL_KAN of
    the plain f32 version and within 2x its distance from f64. Against f64
    of the same f32 basis (the sums' error alone), one running sum over the
    392 stages is past 2x the plain version's distance; two levels are not."""
    rng = np.random.default_rng(201)
    rows, nin, nout, gs = 12544, 12, 384, 28
    gy = torch.from_numpy(rng.standard_normal((rows, nout)).astype(np.float32))
    if family == "fourier":
        x = _embedder_x(rng, rows, nin, 10.0)
        bases = {"dW": lambda t: K.fourier_bases(t, gs)}
    else:
        x = _embedder_x(rng, rows, nin, 20.0)
        freq = torch.from_numpy(np.arange(1, gs + 1, dtype=np.float32) / (gs + 1))
        phase = K.sinekan_phase_init(nin, gs)

        def arg(t):
            return t.unsqueeze(-1) * freq.to(t.dtype) + phase.to(t.dtype)
        bases = {"dW": lambda t: torch.sin(arg(t)),
                 "D": lambda t: t.unsqueeze(-1) * torch.cos(arg(t))}
    for what, basis in bases.items():
        b32, b64 = basis(x), basis(x.double())
        # autograd of the plain version's GEMM: gy^T basis over the rows
        shape = (nout, nin, b32.shape[-1])
        plain = (gy.T @ b32.reshape(rows, -1)).reshape(shape).permute(2, 1, 0)
        exact = (gy.double().T @ b64.reshape(rows, -1)).reshape(shape).permute(2, 1, 0)
        two_level_sum = weight_grad(b32, gy)
        got = _gates(f"{family} {what}", two_level_sum, plain, exact)
        assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], (what, got)
        # the sums alone: against f64 of the same f32 basis, where the f32
        # arguments (k x; x freq + phase) no longer set the distance
        sums = (gy.double().T @ b32.double().reshape(rows, -1)).reshape(shape).permute(
            2, 1, 0)
        two = _gates(f"{family} {what} sums", two_level_sum, plain, sums)
        one = _gates(f"{family} {what} sums, one running sum",
                     weight_grad(b32, gy, flush=None), plain, sums)
        assert two[1] <= 2 * two[2] < one[1], (what, two, one)
        if what == "D":
            amps = torch.from_numpy((rng.uniform(-1.0, 1.0, (gs, nin, nout)) / nout)
                                    .astype(np.float32))
            got_f = dfreq_of(amps, two_level_sum)
            # the plain version's order: gW = gy W^T, then sum x cos(arg) gW
            plain_f = (b32 * torch.einsum("no,sio->nis", gy, amps)).sum((0, 1))
            exact_f = (b64 * torch.einsum("no,sio->nis", gy.double(),
                                          amps.double())).sum((0, 1))
            errs = _gates(f"{family} dfreq", got_f, plain_f, exact_f)
            assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs
