"""The port's kernel modules against the JAX Pallas kernels.

On CPU tensors each wrapper in ``kanvit_torch.kernels`` runs its plain
version; here it is held against the JAX kernel it replaces, run in Pallas
interpret mode (``dispatch.set_impl("pallas")``, as ``tests/test_kernels.py``
does), on the same numpy inputs, to 1e-5. The CUDA wrappers' argument
checks are plain functions and are tested here without a card; the kernels
themselves run on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

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
    assert _counts() == {"bspline_kan": 0, "bspline_qkv_grouped": 0,
                         "flash_attention_lanes": 0}


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


@pytest.mark.parametrize("entry", ["bspline_kan", "bspline_qkv_grouped",
                                   "flash_attention_lanes"])
def test_wrappers_refuse_gradients(entry):
    """Forward only: a grad-requiring input raises instead of returning a
    result that silently drops the graph (CPU and CUDA alike)."""
    x = torch.zeros(4, 2 * 16)
    w = torch.zeros(2, 3 * 16, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward kernel is not ported"):
        if entry == "bspline_kan":
            FB.bspline_kan(x[:, :16], K.make_bspline_grid(16), w[0], w[0, ..., None]
                           .expand(-1, -1, 8), w[0])
        elif entry == "bspline_qkv_grouped":
            FB.bspline_qkv_grouped(x, K.make_bspline_grid(16), w,
                                   w[..., None].expand(-1, -1, -1, 8), w)
        else:
            q = torch.zeros(1, 4, 32, requires_grad=True)
            FA.flash_attention_lanes(q, q, q, 2)
