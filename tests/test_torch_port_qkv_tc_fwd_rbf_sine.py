"""The grouped FastKAN and SineKAN q/k/v forwards' tensor-core arithmetic,
emulated on the CPU.

``fastkan_qkv_grouped``'s and ``sinekan_qkv_grouped``'s forwards run on
``mma.sync.m16n8k8`` in 3xTF32 (``kanvit_torch/kernels/csrc/kan_basis_tc.cuh``,
part 3, the template of ``bspline_qkv_grouped``'s forward, instantiated for
the RBF and sine families in ``kan_rbf_sine.cu``). Here that arithmetic
(``grouped_fwd`` of ``test_torch_port_qkv_tc_fwd_cheby.py``: per head, the
basis times W over (feature, slice) in stages of 8 features, each stage's
slices one 8-deep step each, one running sum) replaces the wrappers'
forward launches, with the family's basis as the kernel makes it:

- FastKAN: the LayerNorm's (mean, rstd) of each row's head segment (the
  statistics pass, saved for the backward), LN(x) = (x - mean) rstd gamma +
  beta, u_k = (LN(x) - c_k) (1/h), exp(-u_k^2), then silu of the raw x for
  a 9-slice weight. The 8 RBF slices go into one running sum; the silu
  slice into a second one, its products exact but for ~2^-33 (each operand
  in three TF32 words, six products a step: ``exact_product``), added to
  the first after the last stage;
- sine: sin(x freq_s + phase_s) up to 4 slices, one running sum; past 4
  the CUDA-core forward (``test_torch_port_sine.py``'s emulation).

The tile holds 9 RBF and 4 sine slices whatever the weight's S: the steps
past S multiply zeros into a zeroed accumulator and add nothing, so the
emulation runs the weight's S steps. The backward is emulated as
``test_torch_port_qkv_tc_rbf_sine.py`` emulates the tensor-core one.

The results are held against kanvit's Pallas ``fastkan_qkv_grouped`` and
``sinekan_qkv_grouped`` in interpret mode (its grouped tier must run: it
returns None where it does not apply) and ``jax.grad`` through them, within
1e-5 x max(1, max|.|): dh 8 and 64, out = dh and out != dh, ragged rows,
FastKAN without its base slice (against kanvit's ``fastkan`` a head) and
sine grids 1, 3 and 4. At the vit-s q/k/v's 12,608 rows (one head of 64 ->
64) both forwards are within ``TOL_KAN`` of the plain f32 version and no
further from f64 than twice it; so is each with one input in 9 at |x| in
[20, 60] (FastKAN, and the B-spline forward, whose silu slice stays in its
one running sum). A small fast ViT and a small sine ViT (2
blocks, d 16, 2 heads) through the emulated routes give kanvit's logits and
gradients within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_basis as JFB
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.utils.torch_compat import params_from_torch_state_dict
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params
from test_torch_port_attention_tc import STEP, product, tf32
from test_torch_port_fast import DEN, GRID, _emu_rbf_fwd, _rbf_basis, fast_inputs, fast_params
from test_torch_port_kernels import _emu_basis, _emu_lanes_bwd, _emu_lanes_fwd, _jax_grads
from test_torch_port_qkv_tc import TOL, TOL_KAN, _gates, _rel
from test_torch_port_qkv_tc_fwd_cheby import STAGE_FEATURES, grouped_fwd
from test_torch_port_qkv_tc_rbf_sine import emu_rbf_bwd, emu_sine_bwd
from test_torch_port_sine import _emu_sine_fwd, _sine_args, sine_inputs, sine_params

LOGIT_TOL = 1e-3
SMALL_VIT = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=16, n_heads=2, out_d=10)


def ln_stats(xg):
    """(N, G, 2): each row's head segment's mean and rstd (biased variance
    about the mean, eps 1e-5), as ``ln_stats_kernel`` saves them."""
    mean = xg.mean(-1)
    rstd = 1.0 / torch.sqrt((xg - mean.unsqueeze(-1)).square().mean(-1) + 1e-5)
    return torch.stack([mean, rstd], -1)


def split3(x):
    """x in three TF32 words: ``split_round``'s big and small, and the
    remainder (``tf32_rest``: exact, ~2 bits wide)."""
    big = tf32(x)
    small = tf32(x - big)
    return big, small, (x - big) - small


def exact_product(a, b):
    """``a @ b`` over the last dim of ``a`` in steps of 8 as
    ``Tf32x3::mma_exact``: six products a step (rest*big, big*rest,
    small*small, small*big, big*small, big*big) into a zeroed accumulator,
    which an f32 add takes into the running sum."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    (ab, as_, ar), (bb, bs, br) = split3(a), split3(b)
    for c in range(0, a.shape[-1], STEP):
        sa, sb = (..., slice(c, c + STEP)), (slice(c, c + STEP), slice(None))
        step = 0.0
        for x, y in ((ar, bb), (ab, br), (as_, bs), (as_, bb), (ab, bs), (ab, bb)):
            step = step + x[sa] @ y[sb]
        out = out + step
    return out


def rbf_grouped_fwd(basis, w, flush=None):
    """y (n, out) of one head: the 8 RBF slices in ``grouped_fwd``'s order
    into one running sum; a silu slice in stage order into a second one
    with ``exact_product``'s steps; the second added to the first. With
    ``flush`` (the FastKAN embedder's), two levels: the two running sums of
    every ``flush`` stages so added, then into the total in level order."""
    ng = FB.RBF_GRIDS
    n, nin, _ = basis.shape
    per = (flush or -(-nin // STAGE_FEATURES)) * STAGE_FEATURES
    total = None
    for f0 in range(0, nin, per):
        level, wl = basis[:, f0:f0 + per], w[:, f0:f0 + per]
        y = grouped_fwd(level[..., :ng], wl[:ng])
        if w.shape[0] > ng:
            depth = level.shape[1]
            pad = -(-depth // STAGE_FEATURES) * STAGE_FEATURES
            a, b = torch.zeros(n, pad), torch.zeros(pad, w.shape[-1])
            a[:, :depth], b[:depth] = level[..., ng], wl[ng]
            y = y + exact_product(a, b)
        total = y if total is None else total + y
    return total


def rbf_tc_fwd(x2d, w, gamma, beta, grid, denominator, flush=None):
    """(y, stats) of ``kanvit_fastkan_qkv_tc_fwd`` (and with ``flush`` of
    ``kanvit_fastkan_kan_tc_fwd``): the statistics, then a head at a time
    the basis from them times W in the kernel's order."""
    n = x2d.shape[0]
    groups, _, nin, _ = w.shape
    xg = x2d.reshape(n, groups, nin)
    stats = None if gamma is None else ln_stats(xg)
    basis, _, _ = _rbf_basis(xg, w, gamma, beta, grid, denominator, stats)
    return torch.cat([rbf_grouped_fwd(basis[:, g], w[g], flush) for g in range(groups)],
                     1), stats


def sine_tc_fwd(x2d, w, freq2d, phase):
    """y of ``kanvit_sinekan_qkv_tc_fwd``: sin(x freq + phase), a head at a
    time times W in the kernel's order."""
    _, arg = _sine_args(x2d, w, freq2d, phase)
    basis = torch.sin(arg)
    return torch.cat([grouped_fwd(basis[:, g], w[g]) for g in range(w.shape[0])], 1)


def emu_rbf_fwd(name, x2d, w, gamma, beta, grid, denominator):
    """``_launch_rbf``: the grouped forward on the tensor cores, and the
    embedder's as its one-group case with its two-level sum."""
    if name not in FB.TC_GROUPED_FWD:
        return _emu_rbf_fwd(name, x2d, w, gamma, beta, grid, denominator)
    FB.check_rbf_args(x2d, w, gamma, beta, grid)
    y, stats = rbf_tc_fwd(x2d, w, gamma, beta, grid, denominator,
                          FB.TCG_FWD_FLUSH.get(name))
    FB.LAUNCHES[name] += 1
    return y, stats


def emu_sine_fwd(name, x2d, w, freq2d, phase):
    """``_launch_sine``: the grouped forward on the tensor cores up to 4
    slices, every other route as ``test_torch_port_sine.py`` emulates it."""
    if name not in FB.TC_GROUPED_FWD or w.shape[1] > FB.SINE_CHUNK:
        return _emu_sine_fwd(name, x2d, w, freq2d, phase)
    FB.check_sine_args(x2d, w, freq2d, phase)
    FB.LAUNCHES[name] += 1
    return sine_tc_fwd(x2d, w, freq2d, phase)


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
    emulation (the grouped forwards and backwards on the tensor cores),
    kanvit on its Pallas kernels in interpret mode."""
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch_rbf", emu_rbf_fwd)
    monkeypatch.setattr(FB, "_launch_rbf_bwd", emu_rbf_bwd)
    monkeypatch.setattr(FB, "_launch_sine", emu_sine_fwd)
    monkeypatch.setattr(FB, "_launch_sine_bwd", emu_sine_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
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


# (n, heads, dh, out per head): dh 8 (one stage) with ragged rows; dh 64 (8
# stages) with out != dh; dh 16 at out = dh over more than one 192-row block.
CASES = [(37, 2, 8, 8), (70, 2, 64, 40), (400, 2, 16, 16)]


@pytest.mark.parametrize("n,h,dh,out", CASES)
def test_fastkan_qkv_grouped_tc_fwd_matches_kanvit(kernel_math, n, h, dh, out):
    rng = np.random.default_rng(400 + n + dh)
    x2d = fast_inputs(rng, (n, h * dh))
    params = fast_params(rng, out, dh, (h,))
    g = rng.standard_normal((n, h * out)).astype(np.float32)
    jgrid, tgrid = jnp.asarray(GRID), torch.from_numpy(GRID.copy())

    def kanvit(x, ga, be, *w):
        return JFB.fastkan_qkv_grouped(x, ga, be, jgrid, DEN, *w)

    assert kanvit(*map(jnp.asarray, (x2d, *params))) is not None  # the grouped tier
    assert "fastkan_qkv_grouped" in FB.TC_GROUPED_FWD  # the route emulated here
    want_y, want = _jax_grads(kanvit, (x2d, *params), g)
    got_y, got = _grads(lambda x, ga, be, *w: FB.fastkan_qkv_grouped(x, ga, be, tgrid, DEN, *w),
                        (x2d, *params), g)
    _assert_close(got_y, want_y, got, want)
    assert FB.LAUNCHES["fastkan_qkv_grouped"] == 1
    assert FB.LAUNCHES["fastkan_qkv_grouped_bwd"] == 1


def test_fastkan_grouped_tc_fwd_without_base_matches_kanvit(kernel_math):
    """The tensor-core forward with an 8-slice weight (no silu slice: the
    tile's ninth step multiplies zeros), through the Function the grouped
    projection uses, against kanvit's ``fastkan`` without its base branch
    a head."""
    n, h, dh, out = 45, 2, 16, 16
    rng = np.random.default_rng(410)
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
    assert FB.LAUNCHES["fastkan_qkv_grouped"] == 1


@pytest.mark.parametrize("n,h,dh,out,grid_size",
                         [(*c, 4) for c in CASES] + [(45, 2, 16, 16, 3), (37, 2, 8, 24, 1)])
def test_sinekan_qkv_grouped_tc_fwd_matches_kanvit(kernel_math, n, h, dh, out, grid_size):
    rng = np.random.default_rng(420 + n + dh + grid_size)
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
    assert FB.LAUNCHES["sinekan_qkv_grouped"] == 1
    assert FB.LAUNCHES["sinekan_qkv_grouped_bwd"] == 1


def test_sine_grid_past_the_tile_takes_the_cuda_core_forward(kernel_math):
    """A grouped sine forward of 7 slices (more than the tile's 4) takes the
    CUDA-core kernel; at 4 and below the tensor-core one."""
    routes = []

    def record(name, x2d, w, *rest):
        routes.append(name in FB.TC_GROUPED_FWD and w.shape[1] <= FB.SINE_CHUNK)
        return emu_sine_fwd(name, x2d, w, *rest)

    kernel_math.setattr(FB, "_launch_sine", record)
    rng = np.random.default_rng(430)
    for grid_size in (7, 4, 2):
        x2d = torch.from_numpy(sine_inputs(rng, (20, 2 * 8)))
        f, a, b = (torch.from_numpy(t) for t in sine_params(rng, 8, 8, grid_size, (2,)))
        with torch.inference_mode():
            FB.sinekan_qkv_grouped(x2d, f, K.sinekan_phase_init(8, grid_size), a, b)
    assert routes == [False, True, True]


def test_forward_scratch_holds_every_stage_below_the_tile():
    """The split W the forward's pre-pass writes holds the family's tile of
    slices (RBF 9, sine 4) whatever the weight's S, which the pre-pass pads
    with zeros, and RBF one more step, the silu slice's remainders: an RBF
    weight with or without its base slice gets the scratch of 10 steps,
    sine grids 1 and 3 of 4."""
    for family, h, s, nin, out, words in (
            ("rbf", 6, 8, 64, 64, 6 * 8 * 10 * 64 * 16),
            ("rbf", 6, 9, 64, 64, 6 * 8 * 10 * 64 * 16),
            ("sine", 6, 3, 64, 64, 6 * 8 * 4 * 64 * 16),
            ("sine", 2, 1, 12, 80, 2 * 2 * 4 * 192 * 16)):
        w = torch.empty(h, s, nin, out)
        assert FB._tc_grouped_fwd_scratch(w, "cpu", family).numel() == words


def test_vit_s_rows_meet_the_gates():
    """At the vit-s q/k/v's 12,608 rows, one head of 64 features and 64
    outputs (one projection): the emulated RBF forward (72 steps in one
    running sum; with and without the base slice) and sine forward (grid 4,
    32 steps; grid 3) within TOL_KAN of the plain f32 version and no
    further from f64 than twice it."""
    rng = np.random.default_rng(440)
    n, nin, out = 12608, 64, 64

    def gate(label, got, plain, exact):
        errs = _gates(label, got, plain, exact)
        assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], (label, errs)

    x = torch.from_numpy(fast_inputs(rng, (n, nin)))
    ga, be, sw, bw, bb = (torch.from_numpy(a) for a in fast_params(rng, out, nin))
    grid = torch.from_numpy(GRID.copy())
    for base in (True, False):
        w = FB.pack_fastkan_weight(sw, bw if base else None, 8).unsqueeze(0).contiguous()
        got, _ = rbf_tc_fwd(x, w, ga[None], be[None], grid, DEN)
        plain, exact = (K.fastkan_forward(x.to(dt), ga.to(dt), be.to(dt), grid.to(dt), DEN,
                                          sw.to(dt), bw.to(dt) if base else None,
                                          torch.zeros(out, dtype=dt) if base else None)
                        for dt in (torch.float32, torch.float64))
        gate(f"rbf{'' if base else ' no base'}", got, plain, exact)

    x = torch.from_numpy(sine_inputs(rng, (n, nin)))
    for grid_size in (4, 3):
        freq, amps, _ = (torch.from_numpy(a) for a in sine_params(rng, out, nin, grid_size))
        phase = K.sinekan_phase_init(nin, grid_size)
        w = FB.pack_sine_weight(amps).contiguous()
        got = sine_tc_fwd(x, w, freq[None], phase)
        plain, exact = (K.sinekan_forward(x.to(dt), freq.to(dt), phase.to(dt), amps.to(dt),
                                          None) for dt in (torch.float32, torch.float64))
        gate(f"sine G{grid_size}", got, plain, exact)


@pytest.mark.parametrize("n,nin", [(1849, 32), (301, 8)])
def test_rbf_forward_holds_f64_with_large_silu_inputs(n, nin):
    """One in 9 inputs at |x| in [20, 60]: silu(x) up to 60 beside RBF
    bases <= 1, in a contraction of 288 (72) entries. The emulated forward
    (the silu slice's exact products in a running sum of their own) no
    further from f64 than twice the plain f32 version."""
    rng = np.random.default_rng(470 + nin)
    x = torch.from_numpy(fast_inputs(rng, (n, nin)))
    ga, be, sw, bw, _ = (torch.from_numpy(a) for a in fast_params(rng, nin, nin))
    grid = torch.from_numpy(GRID.copy())
    w = FB.pack_fastkan_weight(sw, bw, 8).unsqueeze(0).contiguous()
    got, _ = rbf_tc_fwd(x, w, ga[None], be[None], grid, DEN)
    plain, exact = (K.fastkan_forward(x.to(dt), ga.to(dt), be.to(dt), grid.to(dt), DEN,
                                      sw.to(dt), bw.to(dt), torch.zeros(nin, dtype=dt))
                    for dt in (torch.float32, torch.float64))
    errs = _gates(f"rbf dh {nin}", got, plain, exact)
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs



@pytest.mark.parametrize("n,nin", [(1849, 32), (301, 8)])
def test_bspline_forward_holds_f64_with_large_silu_inputs(n, nin):
    """The RBF test's inputs through the B-spline forward, whose silu slice
    stays in its one running sum with two-word products: the inputs at |x|
    in [20, 60] lie outside every knot span, so silu(x) up to 60 is the
    only nonzero value of its feature, beside spline bases <= 1 of the
    others. The emulated forward (q|k|v, 3 nin outputs) no further from f64
    than twice the plain f32 version."""
    rng = np.random.default_rng(480 + nin)
    x = torch.from_numpy(fast_inputs(rng, (n, nin)))
    grid = K.make_bspline_grid(nin)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((3 * nin, nin), (3 * nin, nin, 8), (3 * nin, nin)))
    w = FB.pack_qkv_weight(bw[None], sw[None], sc[None])[0]
    got = grouped_fwd(_emu_basis("bspline", x, grid)[0], w)
    plain, exact = (K.bspline_kan_forward(x.to(dt), grid.to(dt), bw.to(dt), sw.to(dt),
                                          sc.to(dt)) for dt in (torch.float32, torch.float64))
    errs = _gates(f"bspline dh {nin}", got, plain, exact)
    assert errs[0] <= TOL_KAN and errs[1] <= 2 * errs[2], errs

def _model_against_kanvit(variant, kernel_math, seed):
    """A small ``variant`` ViT through the emulated routes against kanvit's
    ``apply`` (Pallas kernels in interpret mode) on the same weights:
    logits, and the gradients of sum(logits * g) carried across by the
    converter, each within 1e-3 x max(1, max|.|)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 1, 28, 28)).astype(np.float32)
    g = rng.standard_normal((3, 10)).astype(np.float32)
    params = params_from_torch_state_dict(
        {k: v.numpy() for k, v in create_model(variant, **SMALL_VIT, seed=1).state_dict().items()})
    apply = j_create_model(variant, **SMALL_VIT).apply
    want_y = np.asarray(jax.jit(apply)({"params": params}, jnp.asarray(x)))
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(apply({"params": p}, jnp.asarray(x)) * g)))(
        params)
    want = state_dict_from_jax_params(jgrads)
    model = create_model(variant, **SMALL_VIT, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    y = model(torch.from_numpy(x))
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(y.detach(), want_y) <= LOGIT_TOL
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, a in got.items():
        assert a.shape == want[k].shape, k
        assert _rel(a, want[k]) <= LOGIT_TOL, k
    return {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}


def test_small_fast_vit_through_the_tc_forward_matches_kanvit(kernel_math):
    launched = _model_against_kanvit("fast", kernel_math, 450)
    assert launched == {"fastkan": 1, "fastkan_bwd": 1,
                        "fastkan_qkv_grouped": 6, "fastkan_qkv_grouped_bwd": 6,
                        "flash_attention_lanes": 2, "flash_attention_lanes_bwd": 2}


def test_small_sine_vit_through_the_tc_forward_matches_kanvit(kernel_math):
    launched = _model_against_kanvit("sine", kernel_math, 460)
    assert launched == {"sinekan": 1, "sinekan_bwd": 1,
                        "sinekan_qkv_grouped": 6, "sinekan_qkv_grouped_bwd": 6,
                        "flash_attention_lanes": 2, "flash_attention_lanes_bwd": 2}

