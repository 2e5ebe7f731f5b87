"""The port's kernel modules against the JAX Pallas kernels.

On CPU tensors each wrapper in ``kanvit_torch.kernels`` runs its plain
version; here it is held against the JAX kernel it replaces, run in Pallas
interpret mode (``dispatch.set_impl("pallas")``, as ``tests/test_kernels.py``
does), on the same numpy inputs, to 1e-5: forward values, and gradients
against ``jax.grad`` through the Pallas backward kernels.

The gradient tests run twice: through autograd of the plain version (the CPU
path), and through the wrappers' ``torch.autograd.Function``s with the
launches replaced by CPU emulations of the CUDA kernels' own arithmetic
(closed-form B', the forward's saved (m, l), delta = rowsum(do * o)). The
second checks the Functions' wiring and the kernels' formulas without a
card. The CUDA wrappers' argument checks are plain functions and are tested
here too; the kernels themselves run on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import flash_attention as JFA
from kanvit.kernels import fused_basis as JFB
from kanvit.ops import dispatch as jdispatch
from kanvit.ops import kan_bases as JK
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K

TOL = 1e-5


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def spline_inputs(rng, shape, knots):
    """Normal inputs with entries exactly on knots and beyond every span."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = knots[np.arange(flat[::5].size) % knots.size]
    flat[2::7] = np.float32([-3.0, -2.2, 2.2, 3.0])[np.arange(flat[2::7].size) % 4]
    return x


def kan_params(rng, nout, nin):
    return (rng.standard_normal((nout, nin)).astype(np.float32) * 0.3,
            rng.standard_normal((nout, nin, 8)).astype(np.float32) * 0.3,
            rng.standard_normal((nout, nin)).astype(np.float32))


def _counts():
    return {**FB.LAUNCHES, **FA.LAUNCHES}


def _nonzero_counts():
    return {k: n for k, n in _counts().items() if n}


@pytest.mark.parametrize("n,nin,nout", [(37, 16, 8), (20, 24, 12)])
def test_bspline_kan_matches_pallas(n, nin, nout):
    rng = np.random.default_rng(10)
    grid = np.array(JK.make_bspline_grid(nin))
    x = spline_inputs(rng, (n, nin), grid[0])
    bw, sw, sc = kan_params(rng, nout, nin)
    want = JFB.bspline_kan(*map(jnp.asarray, (x, grid, bw, sw, sc)))
    with torch.inference_mode():
        got = FB.bspline_kan(*map(torch.from_numpy, (x, grid, bw, sw, sc)))
    assert got.shape == (n, nout)
    assert _maxdiff(got, want) <= TOL
    assert set(_counts()) >= {"bspline_kan", "bspline_qkv_grouped",
                              "bspline_kan_bwd", "bspline_qkv_grouped_bwd",
                              "flash_attention_lanes", "flash_attention_lanes_bwd"}
    assert sum(_counts().values()) == 0


@pytest.mark.parametrize("n,h,dh", [(20, 2, 16), (13, 3, 8)])
def test_bspline_qkv_grouped_matches_pallas(n, h, dh):
    rng = np.random.default_rng(11)
    grid = np.array(JK.make_bspline_grid(dh))
    x2d = spline_inputs(rng, (n, h * dh), grid[0])
    bw = rng.standard_normal((h, 3 * dh, dh)).astype(np.float32) * 0.3
    sw = rng.standard_normal((h, 3 * dh, dh, 8)).astype(np.float32) * 0.3
    sc = rng.standard_normal((h, 3 * dh, dh)).astype(np.float32)
    want = JFB.bspline_qkv_grouped(*map(jnp.asarray, (x2d, grid, bw, sw, sc)))
    assert want is not None  # the Pallas tier engaged
    with torch.inference_mode():
        got = FB.bspline_qkv_grouped(*map(torch.from_numpy, (x2d, grid, bw, sw, sc)))
    assert got.shape == (n, h * 3 * dh)
    assert _maxdiff(got, want) <= TOL
    assert sum(_counts().values()) == 0


def _attention_inputs(rng, b, t, h, dh):
    return [rng.standard_normal((b, t, h * dh)).astype(np.float32) for _ in range(3)]


def _mask(b, t):
    m = np.ones((b, t), bool)
    m[0] = False            # every row of batch item 0 is fully masked
    m[1, 0] = False         # causal: query 0 of item 1 sees no key
    m[1, 7:11] = False
    return m


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_lanes_attention_matches_pallas(causal, masked):
    rng = np.random.default_rng(12)
    b, t, h, dh = 2, 20, 3, 16
    q, k, v = _attention_inputs(rng, b, t, h, dh)
    mask = _mask(b, t) if masked else None
    want = JFA.flash_attention_lanes(
        *map(jnp.asarray, (q, k, v)), h, causal=causal,
        mask=None if mask is None else jnp.asarray(mask))
    assert want is not None  # the Pallas lanes kernel engaged
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        got = FA.flash_attention_lanes(*map(torch.from_numpy, (q, k, v)), h,
                                       causal=causal, mask=tmask)
    assert got.shape == (b, t, h * dh)
    assert _maxdiff(got, want) <= TOL
    if masked:
        assert np.all(got[0].numpy() == 0)  # fully masked rows output 0
        assert np.all(np.asarray(want)[0] == 0)
    assert sum(_counts().values()) == 0


def test_lanes_attention_reads_strided_qkv_views():
    """The MSA passes q/k/v as strided (B, T, H, dh) slices of the grouped
    projection's output; the result equals the contiguous-input one."""
    rng = np.random.default_rng(13)
    b, t, h, dh = 2, 9, 2, 8
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32))
    y4 = y.view(b, t, h, 3 * dh)
    views = [y4[..., i * dh:(i + 1) * dh] for i in range(3)]
    dense = [a.reshape(b, t, h * dh) for a in views]
    with torch.inference_mode():
        got = FA.flash_attention_lanes(*views, h, causal=True)
        want = FA.flash_attention_lanes(*dense, h, causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nin,nout,lead", [(16, 8, (37,)), (12, 5, (2, 3))])
def test_packed_weight_layout(nin, nout, lead):
    """The kernel computes y = sum_s B_s(x) W[s] with B_8 = silu(x); the
    wrapper's packing must give back the plain forward under that sum."""
    rng = np.random.default_rng(14)
    grid = K.make_bspline_grid(nin)
    x = torch.from_numpy(spline_inputs(rng, (*lead, nin), grid[0].numpy()))
    bw, sw, sc = map(torch.from_numpy, kan_params(rng, nout, nin))
    w = FB.pack_weight(bw, sw, sc)
    assert w.shape == (9, nin, nout)
    xf = x.reshape(-1, nin)
    basis = torch.cat([K.bspline_bases(xf, grid),
                       torch.nn.functional.silu(xf).unsqueeze(-1)], -1)
    got = torch.einsum("nis,sio->no", basis, w)
    want = K.bspline_kan_forward(xf, grid, bw, sw, sc)
    assert _maxdiff(got, want) <= TOL


def test_packed_qkv_weight_layout():
    rng = np.random.default_rng(15)
    n, h, dh = 11, 3, 8
    grid = K.make_bspline_grid(dh)
    x2d = torch.from_numpy(spline_inputs(rng, (n, h * dh), grid[0].numpy()))
    bw = torch.from_numpy(rng.standard_normal((h, 3 * dh, dh)).astype(np.float32) * 0.3)
    sw = torch.from_numpy(rng.standard_normal((h, 3 * dh, dh, 8)).astype(np.float32) * 0.3)
    sc = torch.from_numpy(rng.standard_normal((h, 3 * dh, dh)).astype(np.float32))
    w = FB.pack_qkv_weight(bw, sw, sc)
    assert w.shape == (h, 9, dh, 3 * dh)
    xh = x2d.reshape(n * h, dh)
    basis = torch.cat([K.bspline_bases(xh, grid),
                       torch.nn.functional.silu(xh).unsqueeze(-1)], -1)
    got = torch.einsum("nhis,hsio->nho", basis.reshape(n, h, dh, 9), w)
    with torch.inference_mode():
        want = FB.bspline_qkv_grouped(x2d, grid, bw, sw, sc)
    assert _maxdiff(got.reshape(n, -1), want) <= TOL


def _bspline_args():
    x = torch.zeros(10, 2 * 16)
    grid = K.make_bspline_grid(16)
    w = torch.zeros(2, 9, 16, 4)
    return x, grid, w


@pytest.mark.parametrize("bad,err,match", [
    ("x64", TypeError, "x must be float32"),
    ("w64", TypeError, "weight must be float32"),
    ("xshape", ValueError, "does not match packed weight"),
    ("grid", ValueError, "grid must be"),
    ("stride", ValueError, "unit column stride"),
    ("order", ValueError, "spline order"),
    ("wstrided", ValueError, "must be contiguous"),
    ("slices", ValueError, "does not match packed weight"),
])
def test_bspline_kernel_arg_checks(bad, err, match):
    x, grid, w = _bspline_args()
    order = 3
    if bad == "x64":
        x = x.double()
    elif bad == "w64":
        w = w.double()
    elif bad == "xshape":
        x = torch.zeros(10, 3 * 16)
    elif bad == "grid":
        grid = K.make_bspline_grid(16, grid_size=6)
    elif bad == "stride":
        x = torch.zeros(10, 4 * 16)[:, ::2]
    elif bad == "order":
        order = 2
    elif bad == "wstrided":
        w = torch.zeros(2, 9, 4, 16).transpose(2, 3)
    elif bad == "slices":
        w = torch.zeros(2, 8, 16, 4)
    with pytest.raises(err, match=match):
        FB.check_args(x, grid, w, order)


@pytest.mark.parametrize("gy", [torch.zeros(10, 7), torch.zeros(10, 8).double()])
def test_bspline_backward_arg_checks(gy):
    """The backward wrapper checks the output gradient before any launch."""
    x, grid, w = _bspline_args()
    with pytest.raises(ValueError, match="gradient must be f32"):
        FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, gy, True, True)
    assert sum(_counts().values()) == 0


def test_bspline_kernel_arg_checks_accept_valid():
    FB.check_args(*_bspline_args(), 3)
    x = torch.zeros(10, 64)[:, :32]  # row stride 64, unit column stride
    FB.check_args(x, K.make_bspline_grid(16), torch.zeros(2, 9, 16, 4), 3)


@pytest.mark.parametrize("bad,err,match", [
    ("dtype", TypeError, "q must be float32"),
    ("headdim", ValueError, "head dim"),
    ("shapes", ValueError, "share one"),
    ("mask", ValueError, "mask must be"),
    ("heads", ValueError, "not divisible"),
])
def test_attention_kernel_arg_checks(bad, err, match):
    q = k = v = torch.zeros(2, 5, 2 * 16)
    heads, mask = 2, None
    if bad == "dtype":
        q = q.double()
    elif bad == "headdim":
        q = k = v = torch.zeros(2, 5, 2 * 8)
    elif bad == "shapes":
        k = torch.zeros(2, 6, 2 * 16)
    elif bad == "mask":
        mask = torch.ones(2, 6, dtype=torch.bool)
    elif bad == "heads":
        heads = 3
    with pytest.raises(err, match=match):
        FA.check_args(q, k, v, heads, mask)


def test_attention_kernel_arg_checks_accept_views():
    y4 = torch.zeros(2, 5, 2, 3 * 32).view(2, 5, 2, 96)
    q4, k4, v4 = FA.check_args(y4[..., :32], y4[..., 32:64], y4[..., 64:], 2,
                               torch.ones(2, 5))
    assert q4.shape == (2, 5, 2, 32) and q4.stride() == (960, 192, 96, 1)
    with pytest.warns(UserWarning, match="copying"):
        c = FA._unit_inner(torch.zeros(2, 5, 2, 64)[..., ::2], "q")
    assert c.is_contiguous()


# --- gradients against jax.grad through the Pallas backward kernels ---------

def _emu_basis(family, xf, aux):
    """``(values, x-derivatives)``, each ``(N, nin, S)``, as the kernels of
    ``family`` compute them: B-spline with the closed-form
    B'_{3,j} = 3 (B_{2,j}/(g_{j+3}-g_j) - B_{2,j+1}/(g_{j+4}-g_{j+1})) and
    silu' = sig + silu (1 - sig); Chebyshev by the three-term recurrence
    and its derivative; Fourier as cos / sin of the f32 product k x."""
    if family == "cheby":
        return K.cheby_bases_and_grad(xf, aux)
    if family == "fourier":
        return K.fourier_bases_and_grad(xf, aux)
    grid = aux
    b2 = K.bspline_bases(xf, grid, 2)                  # (N, nin, 9)
    inv3 = 1.0 / (grid[:, 3:] - grid[:, :-3])          # (nin, 9)
    db = 3 * (b2[..., :-1] * inv3[:, :-1] - b2[..., 1:] * inv3[:, 1:])
    sig = torch.sigmoid(xf)
    silu = xf * sig
    deriv = torch.cat([db, (sig + silu * (1 - sig)).unsqueeze(-1)], -1)
    return torch.cat([K.bspline_bases(xf, grid), silu.unsqueeze(-1)], -1), deriv


def _emu_fwd(name, family, x2d, w, aux):
    """The forward kernels' arithmetic on the CPU."""
    FB._check(family, x2d, w, aux)
    n = x2d.shape[0]
    groups, s, nin, out = w.shape
    basis, _ = _emu_basis(family, x2d.reshape(n * groups, nin), aux)
    FB.LAUNCHES[name] += 1
    return torch.einsum("ngis,gsio->ngo", basis.reshape(n, groups, nin, s),
                        w).reshape(n, groups * out)


def _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
    """The backward kernels' arithmetic on the CPU: dx = sum_s B'_s (gy W_s^T),
    dW = B^T gy."""
    FB._check(family, x2d, w, aux)
    n = x2d.shape[0]
    groups, s, nin, out = w.shape
    basis, deriv = _emu_basis(family, x2d.reshape(n * groups, nin), aux)
    gyg = gy.reshape(n, groups, out)
    gw = torch.einsum("ngo,gsio->ngis", gyg, w)
    dx = (gw * deriv.reshape(n, groups, nin, s)).sum(-1).reshape(n, -1)
    dw = torch.einsum("ngis,ngo->gsio", basis.reshape(n, groups, nin, s), gyg)
    FB.LAUNCHES[name] += 1
    return (dx if need_dx else None), (dw if need_dw else None)


def _emu_lanes_probs(q4, k4, maskb, causal, stats=None):
    """Scores, validity and (from ``stats`` or afresh) normalised
    probabilities, as the kernels compute them."""
    b, t, h, dh = q4.shape
    qs = q4.transpose(1, 2) * dh ** -0.5
    s = qs @ k4.transpose(1, 2).transpose(-1, -2)
    valid = torch.ones(b, 1, 1, t, dtype=torch.bool) if maskb is None else (
        maskb.bool()[:, None, None, :])
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool).tril()
    s = torch.where(valid, s, float("-inf"))
    if stats is None:
        m = s.amax(-1).clamp_min(-1e30)
        stats = torch.stack([m, torch.exp(s - m[..., None]).sum(-1)], -1)
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:].clamp_min(1e-10)
    return qs, torch.where(valid, p, 0.0), stats


def _emu_lanes_fwd(q4, k4, v4, maskb, causal, with_stats):
    b, t, h, dh = q4.shape
    _, p, stats = _emu_lanes_probs(q4, k4, maskb, causal)
    o = (p @ v4.transpose(1, 2)).transpose(1, 2).reshape(b, t, h * dh)
    FA.LAUNCHES["flash_attention_lanes"] += 1
    return o, (stats if with_stats else None)


def _emu_lanes_bwd(q4, k4, v4, maskb, o, stats, do, causal):
    b, t, h, dh = q4.shape
    qs, p, _ = _emu_lanes_probs(q4, k4, maskb, causal, stats)
    do4 = do.reshape(b, t, h, dh).transpose(1, 2)
    delta = (do4 * o.reshape(b, t, h, dh).transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (do4 @ v4.transpose(1, 2).transpose(-1, -2) - delta)
    dq = ds @ k4.transpose(1, 2) * dh ** -0.5
    dk = ds.transpose(-1, -2) @ qs
    dv = p.transpose(-1, -2) @ do4
    FA.LAUNCHES["flash_attention_lanes_bwd"] += 1
    return [g.transpose(1, 2).contiguous() for g in (dq, dk, dv)]


@pytest.fixture(params=["plain", "kernel_math"])
def grad_path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: the CUDA path's Functions
    with each launch emulated on the CPU."""
    if request.param == "kernel_math":
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(FB, "_launch", _emu_fwd)
        monkeypatch.setattr(FB, "_launch_bwd", _emu_bwd)
        monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
        monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    return request.param


def _torch_grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(
        out, leaves, torch.from_numpy(g))]


def _jax_grads(fn, arrays, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _close_grads(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _maxdiff(a, b) <= TOL * max(1.0, float(np.abs(b).max()))


def _expect_launches(path, **bwd):
    if path == "plain":
        assert sum(_counts().values()) == 0
    else:
        for name, n in bwd.items():
            assert _counts()[name] == n, (name, _counts())


@pytest.mark.parametrize("n,nin,nout", [(37, 16, 8), (20, 24, 12)])
def test_bspline_kan_grads_match_pallas(grad_path, n, nin, nout):
    """dx and the three parameter grads, with inputs on knots and beyond
    every span."""
    rng = np.random.default_rng(16)
    grid = np.array(JK.make_bspline_grid(nin))
    x = spline_inputs(rng, (n, nin), grid[0])
    params = kan_params(rng, nout, nin)
    g = rng.standard_normal((n, nout)).astype(np.float32)
    want_y, want = _jax_grads(
        lambda *a: JFB.bspline_kan(a[0], jnp.asarray(grid), *a[1:]), (x, *params), g)
    tgrid = torch.from_numpy(grid)
    got_y, got = _torch_grads(lambda *a: FB.bspline_kan(a[0], tgrid, *a[1:]),
                              (x, *params), g)
    assert _maxdiff(got_y, want_y) <= TOL
    _close_grads(got, want)
    _expect_launches(grad_path, bspline_kan=1, bspline_kan_bwd=1)


@pytest.mark.parametrize("n,h,dh", [(20, 2, 16), (13, 3, 8)])
def test_bspline_qkv_grouped_grads_match_pallas(grad_path, n, h, dh):
    rng = np.random.default_rng(17)
    grid = np.array(JK.make_bspline_grid(dh))
    x2d = spline_inputs(rng, (n, h * dh), grid[0])
    params = (rng.standard_normal((h, 3 * dh, dh)).astype(np.float32) * 0.3,
              rng.standard_normal((h, 3 * dh, dh, 8)).astype(np.float32) * 0.3,
              rng.standard_normal((h, 3 * dh, dh)).astype(np.float32))
    g = rng.standard_normal((n, h * 3 * dh)).astype(np.float32)
    want_y, want = _jax_grads(
        lambda *a: JFB.bspline_qkv_grouped(a[0], jnp.asarray(grid), *a[1:]),
        (x2d, *params), g)
    tgrid = torch.from_numpy(grid)
    got_y, got = _torch_grads(
        lambda *a: FB.bspline_qkv_grouped(a[0], tgrid, *a[1:]), (x2d, *params), g)
    assert _maxdiff(got_y, want_y) <= TOL
    _close_grads(got, want)
    _expect_launches(grad_path, bspline_qkv_grouped=1, bspline_qkv_grouped_bwd=1)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_lanes_attention_grads_match_pallas(grad_path, causal, masked):
    """dq, dk, dv with no mask, a key mask, causal, and a fully masked batch
    item, whose gradients must be exactly 0 (kanvit's separate (m, l))."""
    rng = np.random.default_rng(18)
    b, t, h, dh = 2, 20, 3, 16
    q, k, v = _attention_inputs(rng, b, t, h, dh)
    g = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    mask = _mask(b, t) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want_o, want = _jax_grads(lambda *a: JFA.flash_attention_lanes(
        *a, h, causal=causal, mask=jmask), (q, k, v), g)
    got_o, got = _torch_grads(lambda *a: FA.flash_attention_lanes(
        *a, h, causal=causal, mask=tmask), (q, k, v), g)
    assert _maxdiff(got_o, want_o) <= TOL
    _close_grads(got, want)
    for grad in got:
        assert np.isfinite(grad).all()
        if masked:
            assert np.all(grad[0] == 0)
    if masked:
        assert all(np.all(a[0] == 0) for a in want)
    _expect_launches(grad_path, flash_attention_lanes=1,
                     flash_attention_lanes_bwd=1)


def test_model_gradients_take_the_function_path(monkeypatch):
    """A model's backward reaches each Function once per launch: the
    embedder once, q/k/v and attention once per block."""
    from kanvit_torch.models import create_model

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FB, "_launch", _emu_fwd)
    monkeypatch.setattr(FB, "_launch_bwd", _emu_bwd)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    model = create_model("efficientkan", chw=(1, 28, 28), n_patches=7,
                         n_blocks=2, d_hidden=32, n_heads=2, out_d=10)
    x = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert _nonzero_counts() == {"bspline_kan": 1, "bspline_qkv_grouped": 2,
                                 "bspline_kan_bwd": 1, "bspline_qkv_grouped_bwd": 2,
                                 "flash_attention_lanes": 2,
                                 "flash_attention_lanes_bwd": 2}
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())


@pytest.mark.parametrize("n,groups,nin,out,want", [
    (12544, 1, 768, 384, 2),    # vit-s embedder: 576 tiles
    (12608, 6, 64, 192, 8),     # vit-s q/k/v: 144 tiles
    (37 * 49, 1, 16, 64, 14),   # MNIST embedder: capped by 128 rows a split
    (100, 1, 16, 64, 1),
])
def test_dw_splits(n, groups, nin, out, want):
    """Enough blocks for 132 SMs, at least 128 rows a split, and a function
    of the shape and the card only."""
    assert FB.dw_splits(n, groups, nin, out, 132) == want
