"""The grouped FastKAN and SineKAN q/k/v backwards' tensor-core arithmetic,
emulated on the CPU.

``fastkan_qkv_grouped``'s and ``sinekan_qkv_grouped``'s backwards run dW and
the gW = gy W^T of dx on ``mma.sync.m16n8k8`` in 3xTF32
(``kanvit_torch/kernels/csrc/kan_basis_tc.cuh``, part 2, the templates of
``bspline_qkv_grouped``'s backward, instantiated for the RBF and sine
families in ``kan_rbf_sine.cu``). Here that arithmetic replaces the
wrappers' backward launches, in the kernels' own order:

- dW, per head: the basis (all slices of every feature) transposed times
  gy over the rows in stages of 32, the rows in the splits of
  ``tc_grouped_dw_splits``, each split's running sum added into its partial
  every 28 stages, the partials summed in split order
  (``test_torch_port_qkv_tc.grouped_dw``);
- gW, per head: gy W^T over the outputs in one running sum, then the
  family's fold in slice order. FastKAN: dln = sum_k gW_k (-2 u_k / h)
  exp(-u_k^2) and the silu term gW_8 silu'(x) kept apart, dln through the
  LayerNorm's VJP (``ln_dx_kernel``: rstd (dxh - mean(dxh) - xh mean(dxh
  xh))) and into dgamma, dbeta as column sums over ``LN_ROWS_PER_SPLIT``
  rows, the partials summed in order in groups of 16; sine: dx = sum_s gW_s freq_s
  cos(arg_s), and dfreq's partials over the dx blocks of 128 rows x 16
  features, summed in block order.

The results are held against kanvit's Pallas ``fastkan_qkv_grouped`` and
``sinekan_qkv_grouped`` in interpret mode (its grouped tier must run: it
returns None where it does not apply) and ``jax.grad`` through them: every
gradient within 1e-5 x max(1, max|.|), at dh 8 and 64, out = dh and out !=
dh, ragged rows, more than one row split and flush group, FastKAN without
its base slice (against kanvit's ``fastkan`` a head, which has no grouped
tier without it) and sine grids 4 and 3 (a tile slice left empty). At the
vit-s q/k/v's 12,608 rows (one head's 16 features, 64 outputs, vit-s's 22
splits) every gradient is within ``TOL_KAN`` of the plain f32 version and
no further from f64 than twice it.
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
from test_torch_port_fast import DEN, GRID, _emu_rbf_bwd, _emu_rbf_fwd, _rbf_basis
from test_torch_port_fast import fast_inputs, fast_params
from test_torch_port_kernels import _jax_grads
from test_torch_port_qkv_tc import N_SM, TOL, TOL_KAN, _gates, _rel, grouped_dw
from test_torch_port_sine import _emu_sine_bwd, _emu_sine_fwd, _sine_args
from test_torch_port_sine import sine_inputs, sine_params


LN_PART_GROUP = 16  # dgamma / dbeta partials a group of the second pass (kan_rbf_sine.cu)


def grouped_gw(gy, w):
    """gW (n, G, S, nin): gy_g W_g^T per head over the outputs, one running
    sum (the dx kernel's products)."""
    n = gy.shape[0]
    groups, slices, nin, out = w.shape
    gyg = gy.reshape(n, groups, out)
    return torch.stack([product(gyg[:, g], w[g].permute(2, 0, 1).reshape(out, slices * nin))
                        .reshape(n, slices, nin) for g in range(groups)], 1)


def block_sums(parts, rows, features):
    """Column sums of ``parts`` (n, G, nin, S) over blocks of ``rows`` rows
    x ``features`` features (zero past the edges), each block's sum, then
    the blocks summed in order (row tile, then feature tile)."""
    n, groups, nin, slices = parts.shape
    pad = torch.zeros(-(-n // rows) * rows, groups, -(-nin // features) * features, slices)
    pad[:n, :, :nin] = parts
    blocks = pad.reshape(-1, rows, groups, pad.shape[2] // features, features, slices)
    blocks = blocks.sum((1, 4)).permute(1, 0, 2, 3).reshape(groups, -1, slices)
    total = torch.zeros(groups, slices)
    for b in range(blocks.shape[1]):
        total = total + blocks[:, b]
    return total


def rbf_tc(x2d, w, gamma, beta, grid, denominator, stats, gy, splits):
    """(dx, dW, dgamma, dbeta) of the RBF grouped backward on the tensor
    cores, as ``kanvit_fastkan_qkv_tc_bwd`` computes them."""
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    ng = FB.RBF_GRIDS
    xg = x2d.reshape(n, groups, nin)
    basis, u, xh = _rbf_basis(xg, w, gamma, beta, grid, denominator, stats)
    gyg = gy.reshape(n, groups, out)
    dw = torch.stack([grouped_dw(basis[:, g], gyg[:, g], splits) for g in range(groups)])
    gw = grouped_gw(gy, w)
    coef = torch.tensor(-2.0, dtype=torch.float32) * torch.tensor(1.0 / denominator,
                                                                  dtype=torch.float32)
    dln = torch.zeros(n, groups, nin)
    for k in range(ng):
        dln = dln + gw[:, :, k] * (coef * u[..., k] * basis[..., k])
    dsilu = torch.zeros_like(dln)
    if slices > ng:
        sig = 1.0 / (1.0 + torch.exp(-xg))
        dsilu = gw[:, :, ng] * (sig + xg * sig * (1.0 - sig))
    if gamma is None:
        return (dln + dsilu).reshape(n, -1), dw, None, None
    dxh = dln * gamma
    m1 = dxh.sum(-1, keepdim=True) / nin
    m2 = (dxh * xh).sum(-1, keepdim=True) / nin
    dx = dsilu + stats[..., 1:] * (dxh - m1 - xh * m2)
    rows = FB.LN_ROWS_PER_SPLIT
    parts = [torch.stack([(dln[r:r + rows] * xh[r:r + rows]).sum(0), dln[r:r + rows].sum(0)])
             for r in range(0, n, rows)]
    dgb = torch.zeros(2, groups, nin)
    for g0 in range(0, len(parts), LN_PART_GROUP):
        dgb = dgb + sum(parts[g0 + 1:g0 + LN_PART_GROUP], parts[g0])
    return dx.reshape(n, -1), dw, dgb[0], dgb[1]


def sine_tc(x2d, w, freq2d, phase, gy, splits):
    """(dx, dW, dfreq) of the sine grouped backward on the tensor cores, as
    ``kanvit_sinekan_qkv_tc_bwd`` computes them."""
    n = x2d.shape[0]
    groups, slices, nin, out = w.shape
    xg, arg = _sine_args(x2d, w, freq2d, phase)
    gyg = gy.reshape(n, groups, out)
    basis = torch.sin(arg)
    dw = torch.stack([grouped_dw(basis[:, g], gyg[:, g], splits) for g in range(groups)])
    gw = grouped_gw(gy, w).permute(0, 1, 3, 2)  # (n, G, nin, S)
    cos = torch.cos(arg)
    dx = torch.zeros(n, groups, nin)
    for s in range(slices):
        dx = dx + gw[..., s] * (freq2d[:, s, None] * cos[..., s])
    dfreq = block_sums(gw * xg.unsqueeze(-1) * cos, FB.TCG_DX_ROWS, FB.TCG_FEATURES)
    return dx.reshape(n, -1), dw, dfreq


def emu_rbf_bwd(name, x2d, w, gamma, beta, grid, denominator, stats, gy, need_dx,
                need_dw, sms=N_SM):
    """``_launch_rbf_bwd``: the grouped backward on the tensor cores (its
    row splits sized for ``sms`` SMs), the embedder's as
    ``test_torch_port_fast.py`` emulates it."""
    if name not in FB.TC_GROUPED_BWD:
        return _emu_rbf_bwd(name, x2d, w, gamma, beta, grid, denominator, stats, gy,
                            need_dx, need_dw)
    FB.check_rbf_args(x2d, w, gamma, beta, grid)
    groups, _, nin, out = w.shape
    splits = FB.tc_grouped_dw_splits(x2d.shape[0], groups, nin, out, sms)
    dx, dw, dgamma, dbeta = rbf_tc(x2d, w, gamma, beta, grid, denominator, stats, gy,
                                   splits)
    FB.LAUNCHES[name] += 1
    return (dx if need_dx else None), (dw if need_dw else None), dgamma, dbeta


def emu_sine_bwd(name, x2d, w, freq2d, phase, gy, need_dx, need_dw, sms=N_SM):
    """``_launch_sine_bwd``: the grouped backward on the tensor cores up to
    4 slices, every other route as ``test_torch_port_sine.py`` emulates
    it."""
    groups, slices, nin, out = w.shape
    if name not in FB.TC_GROUPED_BWD or slices > FB.SINE_CHUNK:
        return _emu_sine_bwd(name, x2d, w, freq2d, phase, gy, need_dx, need_dw)
    FB.check_sine_args(x2d, w, freq2d, phase)
    splits = FB.tc_grouped_dw_splits(x2d.shape[0], groups, nin, out, sms)
    dx, dw, dfreq = sine_tc(x2d, w, freq2d, phase, gy, splits)
    FB.LAUNCHES[name] += 1
    return (dx if need_dx else None), (dw if need_dw else None), dfreq


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
    """The CUDA path's Functions with every launch replaced by its
    emulation, kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_rbf", _emu_rbf_fwd)
    monkeypatch.setattr(FB, "_launch_sine", _emu_sine_fwd)
    yield monkeypatch
    jdispatch.set_impl("auto")


def _grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, torch.from_numpy(g))


def _assert_close(got_y, want_y, got, want):
    assert _rel(got_y, want_y) <= TOL
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert _rel(a, b) <= TOL, i


# (n, heads, dh, out per head, SMs): dh 8 (half a feature tile) with ragged
# rows; dh 64 (4 feature tiles) with out != dh; 2 splits of 32 and 31
# stages, each 2 flush groups.
CASES = [(37, 2, 8, 8, N_SM), (70, 2, 64, 40, N_SM), (2000, 2, 8, 24, 1)]


@pytest.mark.parametrize("n,h,dh,out,sms", CASES)
def test_fastkan_qkv_grouped_tc_bwd_matches_kanvit(kernel_math, n, h, dh, out, sms):
    kernel_math.setattr(FB, "_launch_rbf_bwd", lambda *a, **k: emu_rbf_bwd(*a, **k, sms=sms))
    rng = np.random.default_rng(300 + n + dh)
    x2d = fast_inputs(rng, (n, h * dh))
    params = fast_params(rng, out, dh, (h,))
    g = rng.standard_normal((n, h * out)).astype(np.float32)
    jgrid, tgrid = jnp.asarray(GRID), torch.from_numpy(GRID.copy())

    def kanvit(x, ga, be, *w):
        return JFB.fastkan_qkv_grouped(x, ga, be, jgrid, DEN, *w)

    assert kanvit(*map(jnp.asarray, (x2d, *params))) is not None  # the grouped tier
    want_y, want = _jax_grads(kanvit, (x2d, *params), g)
    got_y, got = _grads(lambda x, ga, be, *w: FB.fastkan_qkv_grouped(x, ga, be, tgrid, DEN, *w),
                        (x2d, *params), g)
    _assert_close(got_y, want_y, got, want)
    assert FB.LAUNCHES["fastkan_qkv_grouped_bwd"] == 1


def test_fastkan_grouped_tc_bwd_without_base_matches_kanvit(kernel_math):
    """The tensor-core route with an 8-slice weight (no silu slice; the tile's
    ninth slice left empty), through the Function the grouped projection
    uses, against kanvit's ``fastkan`` without its base branch a head."""
    kernel_math.setattr(FB, "_launch_rbf_bwd", emu_rbf_bwd)
    n, h, dh, out = 45, 2, 16, 16
    rng = np.random.default_rng(310)
    x2d = fast_inputs(rng, (n, h * dh))
    ga, be, sw, _, _ = fast_params(rng, out, dh, (h,))
    g = rng.standard_normal((n, h * out)).astype(np.float32)
    jgrid, tgrid = jnp.asarray(GRID), torch.from_numpy(GRID.copy())

    def kanvit(x, ga, be, sw):
        return jnp.concatenate([JFB.fastkan(x[:, i * dh:(i + 1) * dh], ga[i], be[i], jgrid,
                                            DEN, sw[i], None, None) for i in range(h)], 1)

    def port(x, ga, be, sw):
        w = sw.reshape(h, out, dh, 8).permute(0, 3, 2, 1).contiguous()  # (H, 8, dh, out)
        return FB._RbfFn.apply(x, w, ga, be, tgrid, DEN, "fastkan_qkv_grouped")

    want_y, want = _jax_grads(kanvit, (x2d, ga, be, sw), g)
    got_y, got = _grads(port, (x2d, ga, be, sw), g)
    _assert_close(got_y, want_y, got, want)
    assert FB.LAUNCHES["fastkan_qkv_grouped_bwd"] == 1


@pytest.mark.parametrize("n,h,dh,out,grid_size,sms",
                         [(*c[:4], 4, c[4]) for c in CASES] + [(45, 2, 16, 16, 3, N_SM)])
def test_sinekan_qkv_grouped_tc_bwd_matches_kanvit(kernel_math, n, h, dh, out, grid_size,
                                                   sms):
    kernel_math.setattr(FB, "_launch_sine_bwd",
                        lambda *a, **k: emu_sine_bwd(*a, **k, sms=sms))
    rng = np.random.default_rng(320 + n + dh + grid_size)
    x2d = sine_inputs(rng, (n, h * dh))
    params = sine_params(rng, out, dh, grid_size, (h,))
    phase = K.sinekan_phase_init(dh, grid_size)
    jphase = jnp.asarray(phase.numpy())
    g = rng.standard_normal((n, h * out)).astype(np.float32)

    def kanvit(x, f, a, b):
        return JFB.sinekan_qkv_grouped(x, f, jphase, a, b)

    assert kanvit(*map(jnp.asarray, (x2d, *params))) is not None  # the grouped tier
    want_y, want = _jax_grads(kanvit, (x2d, *params), g)
    got_y, got = _grads(lambda x, f, a, b: FB.sinekan_qkv_grouped(x, f, phase, a, b),
                        (x2d, *params), g)
    _assert_close(got_y, want_y, got, want)
    assert FB.LAUNCHES["sinekan_qkv_grouped_bwd"] == 1


def test_sine_grid_past_the_tile_takes_the_cuda_cores(kernel_math):
    """A grouped sine backward of 7 slices (more than the tile's 4) takes
    the CUDA-core kernels; at 4 the tensor-core ones."""
    routes = []

    def record(name, x2d, w, *rest, **kw):
        routes.append(name in FB.TC_GROUPED_BWD and w.shape[1] <= FB.SINE_CHUNK)
        return emu_sine_bwd(name, x2d, w, *rest, **kw)

    kernel_math.setattr(FB, "_launch_sine_bwd", record)
    rng = np.random.default_rng(330)
    for grid_size in (7, 4):
        x2d = torch.from_numpy(sine_inputs(rng, (20, 2 * 8))).requires_grad_(True)
        f, a, b = (torch.from_numpy(t) for t in sine_params(rng, 8, 8, grid_size, (2,)))
        FB.sinekan_qkv_grouped(x2d, f, K.sinekan_phase_init(8, grid_size), a, b).sum().backward()
    assert routes == [False, True]


def test_vit_s_rows_meet_the_gates():
    """At the vit-s q/k/v's 12,608 rows, for one head's 16 features and 64
    outputs, with vit-s's 22 row splits: the emulated RBF (dx through the
    LayerNorm, dW, dgamma, dbeta) and sine (dx, dW, dfreq) backwards within
    TOL_KAN of the plain f32 version and no further from f64 than twice
    it."""
    rng = np.random.default_rng(340)
    n, nin, out = 12608, 16, 64
    splits = FB.tc_grouped_dw_splits(n, 6, 64, out, N_SM)
    assert splits == 22
    g = rng.standard_normal((n, out)).astype(np.float32)

    def gates(label, got, plain, exact):
        for name, a, b, c in zip(label, got, plain, exact):
            errs = _gates(name, a, b, c)
            assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], (name, errs)

    def plain_grads(fn, arrays, dtype):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
        return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(g).to(dtype))

    # RBF: x, gamma, beta, the spline and base weights (packed: the RBF
    # slices, then silu), and the bias, which no gate reads
    x = fast_inputs(rng, (n, nin))
    ga, be, sw, bw, bb = fast_params(rng, out, nin)
    grid = torch.from_numpy(GRID.copy())
    w = FB.pack_fastkan_weight(torch.from_numpy(sw), torch.from_numpy(bw), 8)
    w = w.unsqueeze(0).contiguous()

    def rbf(x, ga, be, sw, bw, bb):
        return K.fastkan_forward(x, ga, be, grid.to(x.dtype), DEN, sw, bw, bb)

    arrays = (x, ga, be, sw, bw, bb)
    plain = plain_grads(rbf, arrays, torch.float32)
    exact = plain_grads(rbf, arrays, torch.float64)
    # the weights' gradients, packed as the kernel's dW
    plain, exact = ((*grads[:3], FB.pack_fastkan_weight(grads[3], grads[4], 8)[None])
                    for grads in (plain, exact))
    xt = torch.from_numpy(x).reshape(n, 1, nin)
    mean = xt.mean(-1)
    rstd = 1.0 / torch.sqrt((xt - mean.unsqueeze(-1)).square().mean(-1) + 1e-5)
    dx, dw, dgamma, dbeta = rbf_tc(torch.from_numpy(x), w, torch.from_numpy(ga)[None],
                                   torch.from_numpy(be)[None], grid, DEN,
                                   torch.stack([mean, rstd], -1), torch.from_numpy(g), splits)
    gates(("rbf dx", "rbf dgamma", "rbf dbeta", "rbf dW"), (dx, dgamma[0], dbeta[0], dw),
          plain, exact)

    # sine: x, freq, the amplitudes (packed as the kernel's dW)
    x = sine_inputs(rng, (n, nin))
    freq, amps, _ = sine_params(rng, out, nin, 4)
    phase = K.sinekan_phase_init(nin, 4)

    def sine(x, f, a):
        return K.sinekan_forward(x, f, phase.to(x.dtype), a, None)

    arrays = (x, freq, amps)
    plain, exact = ((*grads[:2], FB.pack_sine_weight(grads[2]))
                    for grads in (plain_grads(sine, arrays, dtype)
                                  for dtype in (torch.float32, torch.float64)))
    packed = FB.pack_sine_weight(torch.from_numpy(amps)).contiguous()
    dx, dw, dfreq = sine_tc(torch.from_numpy(x), packed, torch.from_numpy(freq)[None], phase,
                            torch.from_numpy(g), splits)
    gates(("sine dx", "sine dfreq", "sine dW"), (dx, dfreq[0], dw), plain, exact)
