"""The grouped B-spline q/k/v backward's tensor-core arithmetic, emulated on the CPU.

``bspline_qkv_grouped``'s backward runs dW and dx on ``mma.sync.m16n8k8``
in 3xTF32 (``kanvit_torch/kernels/csrc/kan_basis_tc.cuh``, part 2): each f32
operand split into big + small TF32 words, each 8-deep step of the
contracted index small*big + big*small + big*big into a zeroed accumulator
that an f32 add takes into the running sum (``product`` of
``test_torch_port_attention_tc.py``). Here that arithmetic replaces the
wrapper's backward launch, in the kernels' own order of the contracted
index:

- dW, per head: the basis (all 9 slices of every feature) transposed times
  gy, over the rows in stages of 32; the rows cut into the splits of
  ``tc_grouped_dw_splits`` (whole stages, none empty), each split's running
  sum added into its partial every 28 stages, the partials summed in split
  order (``sum_splits_kernel``);
- dx, per head: gW = gy W^T over the outputs in one running sum, then
  sum_s B'_s(x) gW_s in slice order with the closed-form B-spline and silu
  derivatives.

The results are held against kanvit's Pallas ``bspline_qkv_grouped`` in
interpret mode (a grid a head: kanvit's Pallas ``bspline_kan`` a head) and
``jax.grad`` through it: every gradient within 1e-5 x max(1, max|.|), at dh
8 and 64, out 3dh and dh, ragged rows, more than one row split and more than
one flush group in a split. At the vit-s q/k/v's 12,608 rows (one head's 16
features, 192 outputs, vit-s's 22 splits) dW and dx are within ``TOL_KAN``
of the plain f32 version and no further from f64 than twice it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from test_torch_port_attention_tc import product
from test_torch_port_kernels import _emu_basis, _emu_bwd, _emu_fwd, _jax_grads, spline_inputs

TOL = 1e-5
TOL_KAN = 1e-4   # chip_smoke.py's gate against the plain version
STAGE = FB.TC_STAGE
FLUSH = 28       # stages a level of the running sum
N_SM = 132       # the card's SMs, which the launch sizes its row splits by


def grouped_dw(basis, gy, splits, passes="3xtf32"):
    """dW (S, nin, out) of one head: basis (n, nin, S) transposed times gy
    (n, out), rows in ``splits`` splits of whole 32-row stages, each split's
    flush groups of 28 stages added into its partial in order, the partials
    summed in split order."""
    n, nin, slices = basis.shape
    at = basis.permute(2, 1, 0).reshape(slices * nin, n)
    per = -(-(-(-n // STAGE)) // splits) * STAGE  # rows a split
    total = torch.zeros(slices * nin, gy.shape[1])
    for lo in range(0, n, per):
        hi, part = min(n, lo + per), None
        for c in range(lo, hi, FLUSH * STAGE):
            e = min(hi, c + FLUSH * STAGE)
            run = product(at[:, c:e], gy[c:e], passes=passes)
            part = run if part is None else part + run
        total = total + part
    return total.reshape(slices, nin, -1)


def grouped_dx(gy, w, deriv):
    """dx (n, nin) of one head: gW = gy W^T over the outputs in one running
    sum, then sum_s B'_s gW_s in slice order."""
    slices, nin, out = w.shape
    gw = product(gy, w.permute(2, 0, 1).reshape(out, slices * nin)).reshape(-1, slices, nin)
    dx = torch.zeros(gy.shape[0], nin)
    for s in range(slices):
        dx = dx + gw[:, s] * deriv[..., s]
    return dx


def emu_fwd(name, family, x2d, w, aux):
    """``_launch``: as ``test_torch_port_kernels.py`` emulates it, a head at
    a time where each head has its own grid."""
    if aux.dim() != 3:
        return _emu_fwd(name, family, x2d, w, aux)
    FB._check(family, x2d, w, aux)
    groups, _, nin, _ = w.shape
    FB.LAUNCHES[name] += 1
    return torch.cat([
        torch.einsum("nis,sio->no",
                     _emu_basis("bspline", x2d[:, g * nin:(g + 1) * nin], aux[g])[0], w[g])
        for g in range(groups)], 1)


def emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw, sms=N_SM):
    """``_launch_bwd``: the grouped backward on the tensor cores (its row
    splits sized for ``sms`` SMs), every other route as
    ``test_torch_port_kernels.py`` emulates it."""
    if name not in FB.TC_GROUPED_BWD:
        return _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw)
    FB._check(family, x2d, w, aux)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    splits = FB.tc_grouped_dw_splits(n, groups, nin, out, sms)
    dx, dw = [], []
    for g in range(groups):
        grid = aux[g] if aux.dim() == 3 else aux
        basis, deriv = _emu_basis("bspline", x2d[:, g * nin:(g + 1) * nin], grid)
        gyg = gy[:, g * out:(g + 1) * out]
        dx.append(grouped_dx(gyg, w[g], deriv))
        dw.append(grouped_dw(basis, gyg, splits))
    FB.LAUNCHES[name] += 1
    return (torch.cat(dx, 1) if need_dx else None), (torch.stack(dw) if need_dw else None)


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
    """The CUDA path's Function with the backward launch replaced by the
    emulation, kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", emu_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_bwd)
    yield
    jdispatch.set_impl("auto")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _params(rng, h, out, dh):
    return (rng.standard_normal((h, out, dh)).astype(np.float32) * 0.3,
            rng.standard_normal((h, out, dh, 8)).astype(np.float32) * 0.3,
            rng.standard_normal((h, out, dh)).astype(np.float32))


def _torch_grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, torch.from_numpy(g))


# (n, heads, dh, out per head, grid a head, SMs): dh 8 (half a feature tile)
# with ragged rows; dh 64 (4 feature tiles) with 3 row splits of one stage;
# one projection (out = dh) with a grid a head; 2 splits of 32 and 31
# stages, each 2 flush groups.
CASES = [(37, 2, 8, 24, False, 132), (70, 1, 64, 192, False, 132),
         (45, 2, 16, 16, True, 132), (2000, 2, 8, 24, False, 1)]


@pytest.mark.parametrize("n,h,dh,out,per_head,sms", CASES)
def test_bspline_qkv_grouped_tc_bwd_matches_kanvit(kernel_math, monkeypatch, n, h, dh,
                                                   out, per_head, sms):
    monkeypatch.setattr(FB, "_launch_bwd", lambda *a: emu_bwd(*a, sms=sms))
    rng = np.random.default_rng(210 + n + dh)
    shared = np.array(JK.make_bspline_grid(dh))
    if per_head:  # each head's knots scaled and shifted, as a refit moves them
        grids = np.stack([shared * rng.uniform(0.8, 1.3) + rng.uniform(-0.3, 0.3)
                          for _ in range(h)]).astype(np.float32)
    x2d = spline_inputs(rng, (n, h * dh), shared[0])
    params = _params(rng, h, out, dh)
    g = rng.standard_normal((n, h * out)).astype(np.float32)

    def kanvit(x, bw, sw, sc):
        if not per_head:
            return JFB.bspline_qkv_grouped(x, jnp.asarray(shared), bw, sw, sc)
        return jnp.concatenate([
            JFB.bspline_kan(x[:, i * dh:(i + 1) * dh], jnp.asarray(grids[i]), bw[i],
                            sw[i], sc[i]) for i in range(h)], axis=1)

    want_y, want = _jax_grads(kanvit, (x2d, *params), g)
    tgrid = torch.from_numpy(grids if per_head else shared)
    got_y, got = _torch_grads(lambda *a: FB.bspline_qkv_grouped(a[0], tgrid, *a[1:]),
                              (x2d, *params), g)
    assert _rel(got_y, want_y) <= TOL
    for name, a, b in zip(("x", "bw", "sw", "sc"), got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL, name
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == 1


def test_splits_cover_the_rows_in_whole_stages():
    """Every split holds whole 32-row stages and none is empty; vit-s's
    q/k/v (6 heads x 4 feature tiles) takes 22 splits, four blocks an SM."""
    assert FB.tc_grouped_dw_splits(12608, 6, 64, 192, N_SM) == 22
    for n, h, dh, out, sms in ((37, 2, 8, 24, N_SM), (2000, 2, 8, 24, 1),
                               (12608, 6, 64, 64, N_SM), (3200, 8, 8, 24, N_SM),
                               (33, 1, 16, 192, N_SM)):
        stages = -(-n // STAGE)
        splits = FB.tc_grouped_dw_splits(n, h, dh, out, sms)
        per = -(-stages // splits)
        assert 1 <= splits <= stages and (splits - 1) * per < stages


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


def test_vit_s_rows_meet_the_gates():
    """At the vit-s q/k/v's 12,608 rows, for one head's 16 features (one
    dW block's) and 192 outputs, with vit-s's 22 row splits: the emulated
    dW and dx within TOL_KAN of the plain f32 version and no further from
    f64 than twice it."""
    rng = np.random.default_rng(220)
    n, nin, out = 12608, 16, 192
    grid = K.make_bspline_grid(nin)
    x = torch.from_numpy(spline_inputs(rng, (n, nin), grid[0].numpy()))
    gy = torch.from_numpy(rng.standard_normal((n, out)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((9, nin, out)) * 0.3).astype(np.float32))
    splits = FB.tc_grouped_dw_splits(n, 6, 64, out, N_SM)
    b32, d32 = _emu_basis("bspline", x, grid)
    b64, d64 = _emu_basis("bspline", x.double(), grid.double())
    # the plain version's autograd: gy^T basis over the rows, and dx as gW
    # = gy W^T times B', summed over the slices
    plain_dw = torch.einsum("nis,no->sio", b32, gy)
    exact_dw = torch.einsum("nis,no->sio", b64, gy.double())
    got = _gates("dW", grouped_dw(b32, gy, splits), plain_dw, exact_dw)
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got
    plain_dx = (torch.einsum("no,sio->nis", gy, w) * d32).sum(-1)
    exact_dx = (torch.einsum("no,sio->nis", gy.double(), w.double()) * d64).sum(-1)
    got = _gates("dx", grouped_dx(gy, w, d32), plain_dx, exact_dx)
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got
