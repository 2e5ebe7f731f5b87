"""The grouped B-spline q/k/v forward's and the grouped Chebyshev q/k/v
backward's tensor-core arithmetic, emulated on the CPU.

``bspline_qkv_grouped``'s forward runs on ``mma.sync.m16n8k8`` in 3xTF32
(``kanvit_torch/kernels/csrc/kan_basis_tc.cuh``, part 3), and so does
``cheby_qkv_grouped``'s backward (part 2's templates, instantiated for the
Chebyshev family in ``kan_basis.cu``). Here that arithmetic (``product`` of
``test_torch_port_attention_tc.py``: each f32 operand split into big +
small TF32 words, each 8-deep step small*big + big*small + big*big into a
zeroed accumulator that an f32 add takes into the running sum) replaces
the wrappers' launches, in the kernels' own order of the contracted index:

- the forward, per head: y = basis W over (feature, slice) in stages of 8
  features, each stage's SC slices one 8-deep step each (slice s of the
  stage's 8 features), one running sum over every stage;
- the Chebyshev backward, per head: dW over the rows in the splits of
  ``tc_grouped_dw_splits`` with a flush every 28 stages, dx as gy W^T over
  the outputs then sum_s T'_s gW_s in slice order
  (``test_torch_port_qkv_tc.grouped_dw`` and ``grouped_dx``).

The results are held against kanvit's Pallas ``bspline_qkv_grouped`` and
``cheby_qkv_grouped`` in interpret mode (a grid a head, or one projection:
kanvit's Pallas ``bspline_kan`` a head) and ``jax.grad`` through them, each
within 1e-5 x max(1, max|.|): dh 8 and 64, out 3 dh and dh, ragged rows, x
on and outside the knots, more than one row split and flush group. Where
tanh(x) rounds to +-1 the Chebyshev gradients are held against the port's
plain version, finite (0 in dx) there. At the vit-s q/k/v's 12,608 rows (one
head) both routes are within ``TOL_KAN`` of the plain f32 version and no
further from f64 than twice it.
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
from test_torch_port_kernels import _emu_basis, _emu_fwd, _jax_grads, spline_inputs
from test_torch_port_qkv_tc import (
    N_SM,
    TOL,
    TOL_KAN,
    _gates,
    _params,
    _rel,
    _torch_grads,
    emu_bwd,
    grouped_dw,
    grouped_dx,
)

STAGE_FEATURES = FB.TCG_FWD_FEATURES
CHEBY_DEGREE = FB.CHEBY_DEGREE


def grouped_fwd(basis, w, passes="3xtf32", flush=None):
    """y (n, out) of one head: the basis (n, nin, S) times W (S, nin, out),
    nin in stages of 8 features (zero past nin), each stage's slices in
    order, each slice one 8-deep step of the stage's features; one running
    sum, or with ``flush`` two levels: the running sum of every ``flush``
    stages added into the total."""
    n, nin, slices = basis.shape
    nk = -(-nin // STAGE_FEATURES)
    pad = nk * STAGE_FEATURES
    a = torch.zeros(n, pad, slices)
    a[:, :nin] = basis
    b = torch.zeros(slices, pad, w.shape[-1])
    b[:, :nin] = w
    a = a.reshape(n, nk, STAGE_FEATURES, slices).permute(0, 1, 3, 2).reshape(n, -1)
    b = b.reshape(slices, nk, STAGE_FEATURES, -1).permute(1, 0, 2, 3).reshape(a.shape[1], -1)
    per, total = (flush or nk) * slices * STAGE_FEATURES, None
    for c in range(0, a.shape[1], per):
        run = product(a[:, c:c + per], b[c:c + per], passes=passes)
        total = run if total is None else total + run
    return total


def emu_tc_fwd(name, family, x2d, w, aux):
    """``_launch``: the grouped tensor-core forward a head at a time (its
    shared grid or its own; the Chebyshev degree; the B-spline embedder's
    two-level sum), every other route as ``test_torch_port_kernels.py``
    emulates it."""
    if name not in FB.TC_GROUPED_FWD:
        return _emu_fwd(name, family, x2d, w, aux)
    FB._check(family, x2d, w, aux)
    groups, _, nin, _ = w.shape
    FB.LAUNCHES[name] += 1
    return torch.cat([
        grouped_fwd(_emu_basis(family, x2d[:, g * nin:(g + 1) * nin],
                               aux[g] if torch.is_tensor(aux) and aux.dim() == 3 else aux)[0],
                    w[g], flush=FB.TCG_FWD_FLUSH.get(name))
        for g in range(groups)], 1)


def emu_tc_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw, sms=N_SM):
    """``_launch_bwd``: the Chebyshev backward on the tensor cores, the
    grouped q/k/v's and the embedder's (row splits sized for ``sms`` SMs),
    every other route as ``test_torch_port_qkv_tc.emu_bwd``."""
    if family != "cheby" or name not in FB.TC_GROUPED_BWD:
        return emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw, sms)
    FB._check(family, x2d, w, aux)
    n = x2d.shape[0]
    groups, _, nin, out = w.shape
    splits = FB.tc_grouped_dw_splits(n, groups, nin, out, sms)
    dx, dw = [], []
    for g in range(groups):
        basis, deriv = _emu_basis(family, x2d[:, g * nin:(g + 1) * nin], aux)
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
    """The CUDA path's Function with the launches replaced by the
    emulations, kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", emu_tc_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", emu_tc_bwd)
    yield
    jdispatch.set_impl("auto")


def edge_inputs(rng, shape, knots):
    """Every entry on a knot or outside every span (|x| >= 2.2), where the
    Cox-de Boor indicators decide alone."""
    pool = np.concatenate([knots, np.float32([-3.5, -2.6, -2.2, 2.2, 2.6, 3.5])])
    return rng.choice(pool, shape).astype(np.float32)


# (n, heads, dh, out per head, grid a head, inputs): dh 8 (one stage) with
# ragged rows; dh 64 (8 stages) at out 3 dh; one projection (out = dh) with
# a grid a head; dh 64 at out = dh over two row blocks, the last ragged;
# dh 12 (a ragged second stage) with every x on a knot or outside the spans.
FWD_CASES = [(37, 2, 8, 24, False, "spline"), (70, 1, 64, 192, False, "spline"),
             (45, 2, 16, 16, True, "spline"), (130, 2, 64, 64, False, "spline"),
             (29, 2, 12, 36, False, "edges")]


@pytest.mark.parametrize("n,h,dh,out,per_head,inputs", FWD_CASES)
def test_bspline_qkv_grouped_tc_fwd_matches_kanvit(kernel_math, n, h, dh, out, per_head,
                                                   inputs):
    rng = np.random.default_rng(310 + n + dh)
    shared = np.array(JK.make_bspline_grid(dh))
    grids = (np.stack([shared * rng.uniform(0.8, 1.3) + rng.uniform(-0.3, 0.3)
                       for _ in range(h)]).astype(np.float32) if per_head else None)
    draw = spline_inputs if inputs == "spline" else edge_inputs
    x2d = draw(rng, (n, h * dh), shared[0])
    bw, sw, sc = _params(rng, h, out, dh)
    if per_head or out != 3 * dh:  # kanvit's grouped tier takes one q|k|v grid
        want = np.concatenate([np.asarray(JFB.bspline_kan(
            jnp.asarray(x2d[:, i * dh:(i + 1) * dh]),
            jnp.asarray(grids[i] if per_head else shared), bw[i], sw[i], sc[i]))
            for i in range(h)], axis=1)
    else:
        want = JFB.bspline_qkv_grouped(jnp.asarray(x2d), jnp.asarray(shared), bw, sw, sc)
        assert want is not None  # the Pallas tier engaged
    tgrid = torch.from_numpy(grids if per_head else shared)
    with torch.inference_mode():
        got = FB.bspline_qkv_grouped(torch.from_numpy(x2d), tgrid, *map(torch.from_numpy,
                                                                         (bw, sw, sc)))
    assert got.shape == (n, h * out)
    assert _rel(got, want) <= TOL
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 1


def cheby_inputs(rng, shape, saturated):
    """Normal inputs with a share at |x| in [9.5, 20], where tanh(x) rounds
    to +-1 in f32."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = (rng.uniform(9.5, 20.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


def cheby_plain(h, dh):
    def plain(x2d, cc):
        return torch.cat([K.chebykan_forward(x2d[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], 1)
    return plain


# (n, heads, dh, SMs): dh 8 with ragged rows; dh 64 (4 feature tiles) in 3
# row splits of one stage; 2 splits of 32 and 31 stages, each 2 flush groups.
CHEBY_CASES = [(37, 2, 8, N_SM), (70, 1, 64, N_SM), (2000, 2, 8, 1)]


@pytest.mark.parametrize("n,h,dh,sms", CHEBY_CASES)
def test_cheby_qkv_grouped_tc_bwd_matches_kanvit(kernel_math, monkeypatch, n, h, dh, sms):
    monkeypatch.setattr(FB, "_launch_bwd", lambda *a: emu_tc_bwd(*a, sms=sms))
    rng = np.random.default_rng(320 + n + dh)
    x2d = cheby_inputs(rng, (n, h * dh), 0.0)
    cc = (rng.standard_normal((h, dh, 3 * dh, CHEBY_DEGREE + 1)) * 0.3).astype(np.float32)
    g = rng.standard_normal((n, h * 3 * dh)).astype(np.float32)
    want_y, want = _jax_grads(JFB.cheby_qkv_grouped, (x2d, cc), g)
    got_y, got = _torch_grads(FB.cheby_qkv_grouped, (x2d, cc), g)
    assert _rel(got_y, want_y) <= TOL
    for name, a, b in zip(("x", "cc"), got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL, name
    assert FB.LAUNCHES["cheby_qkv_grouped_bwd"] == 1


def test_cheby_qkv_grouped_tc_bwd_saturated(kernel_math):
    """A fifth of x where tanh(x) rounds to +-1: the emulated backward's
    gradients are finite, dx is 0 there, and both gradients match the
    port's plain version (autograd through the recurrence)."""
    rng = np.random.default_rng(330)
    n, h, dh = 300, 2, 16
    x2d = torch.from_numpy(cheby_inputs(rng, (n, h * dh), 0.2))
    cc = torch.from_numpy((rng.standard_normal((h, dh, 3 * dh, 5)) * 0.3).astype(np.float32))
    g = rng.standard_normal((n, h * 3 * dh)).astype(np.float32)
    _, got = _torch_grads(FB.cheby_qkv_grouped, (x2d.numpy(), cc.numpy()), g)
    _, want = _torch_grads(cheby_plain(h, dh), (x2d.numpy(), cc.numpy()), g)
    saturated = x2d.abs() >= 9.5
    assert bool(saturated.any())
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
        assert _rel(a, b) <= TOL
    assert bool((got[0][saturated] == 0).all()) and bool((want[0][saturated] == 0).all())
    assert FB.LAUNCHES["cheby_qkv_grouped_bwd"] == 1


def test_vit_s_rows_meet_the_gates():
    """At the vit-s q/k/v's 12,608 rows, one head (nin 64, 192 outputs):
    the emulated B-spline forward (72 steps in one running sum) and the
    emulated Chebyshev dW (vit-s's 22 row splits) and dx within TOL_KAN of
    the plain f32 version and no further from f64 than twice it."""
    rng = np.random.default_rng(340)
    n, nin, out = 12608, 64, 192
    grid = K.make_bspline_grid(nin)
    x = torch.from_numpy(spline_inputs(rng, (n, nin), grid[0].numpy()))
    w = torch.from_numpy((rng.standard_normal((9, nin, out)) * 0.3).astype(np.float32))
    b32, _ = _emu_basis("bspline", x, grid)
    b64, _ = _emu_basis("bspline", x.double(), grid.double())
    got = _gates("y", grouped_fwd(b32, w), torch.einsum("nis,sio->no", b32, w),
                 torch.einsum("nis,sio->no", b64, w.double()))
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got

    nin = 16  # one dW block's features
    x = torch.from_numpy(cheby_inputs(rng, (n, nin), 0.02))
    gy = torch.from_numpy(rng.standard_normal((n, out)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((5, nin, out)) * 0.3).astype(np.float32))
    splits = FB.tc_grouped_dw_splits(n, 6, 64, out, N_SM)
    assert splits == 22
    b32, d32 = _emu_basis("cheby", x, CHEBY_DEGREE)
    b64, d64 = _emu_basis("cheby", x.double(), CHEBY_DEGREE)
    got = _gates("dW", grouped_dw(b32, gy, splits), torch.einsum("nis,no->sio", b32, gy),
                 torch.einsum("nis,no->sio", b64, gy.double()))
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got
    plain_dx = (torch.einsum("no,sio->nis", gy, w) * d32).sum(-1)
    exact_dx = (torch.einsum("no,sio->nis", gy.double(), w.double()) * d64).sum(-1)
    got = _gates("dx", grouped_dx(gy, w, d32), plain_dx, exact_dx)
    assert got[0] <= TOL_KAN and got[1] <= 2 * got[2], got


def test_forward_scratch_holds_every_stage():
    """The split W the forward's pre-pass writes: for every group and block
    of outputs (64 up to nout 64, else 192), ceil(nin / 8) stages of 9
    slices x 8 features x the block's outputs, two words a value."""
    for h, nin, out, words in ((6, 64, 192, 6 * 8 * 9 * 192 * 16),
                               (8, 8, 24, 8 * 1 * 9 * 64 * 16),
                               (2, 12, 384, 2 * 2 * 2 * 9 * 192 * 16)):
        w = torch.empty(h, 9, nin, out)
        assert FB._tc_grouped_fwd_scratch(w, "cpu").numel() == words
