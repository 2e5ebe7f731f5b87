"""kanvit_torch.ops against kanvit.ops: the same numpy inputs through both.

f32 on the CPU; every op must agree to 1e-5 (most agree bit for bit).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.ops import attention as JA
from kanvit.ops import kan_bases as JK
from kanvit.ops.patchify import patchify as j_patchify
from kanvit.ops.posemb import sinusoidal_positional_embeddings as j_posemb
from kanvit_torch.ops import attention as TA
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as TK
from kanvit_torch.ops.patchify import patchify
from kanvit_torch.ops.posemb import sinusoidal_positional_embeddings

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def spline_inputs(rng, shape, knots):
    """Normal inputs with entries exactly on knots and beyond every span."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = knots[np.arange(flat[::5].size) % knots.size]
    flat[2::7] = np.float32([-3.0, -2.2, 2.2, 3.0])[np.arange(flat[2::7].size) % 4]
    return x


@pytest.mark.parametrize("chw,n_patches", [((1, 28, 28), 7), ((3, 32, 32), 4),
                                           ((3, 224, 224), 14)])
def test_patchify(chw, n_patches):
    x = np.random.default_rng(0).standard_normal((2, *chw)).astype(np.float32)
    got = patchify(torch.from_numpy(x), n_patches).numpy()
    want = np.asarray(j_patchify(jnp.asarray(x), n_patches))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_patchify_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        patchify(torch.zeros(1, 1, 28, 28), 5)


@pytest.mark.parametrize("t,d", [(50, 64), (197, 384), (17, 16)])
def test_posemb(t, d):
    got = sinusoidal_positional_embeddings(t, d)
    want = j_posemb(t, d)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nin,grid_size,order,rng_", [
    (16, 5, 3, (-1.0, 1.0)), (64, 5, 3, (-1.0, 1.0)), (8, 7, 2, (-2.0, 0.5))])
def test_make_bspline_grid(nin, grid_size, order, rng_):
    got = TK.make_bspline_grid(nin, grid_size, order, rng_).numpy()
    want = np.asarray(JK.make_bspline_grid(nin, grid_size, order, rng_))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_bspline_bases_knots_and_outside():
    rng = np.random.default_rng(1)
    grid = np.array(JK.make_bspline_grid(16))
    x = spline_inputs(rng, (40, 16), grid[0])
    got = TK.bspline_bases(torch.from_numpy(x), torch.from_numpy(grid)).numpy()
    want = np.asarray(JK.bspline_bases(jnp.asarray(x), jnp.asarray(grid)))
    assert got.shape == (40, 16, 8)
    assert _maxdiff(got, want) <= TOL
    # beyond every knot span all bases vanish; on a knot exactly, the
    # half-open intervals decide which bases are live — both must agree
    outside = np.abs(x) > 2.2
    assert outside.any() and np.all(got[outside] == 0)


@pytest.mark.parametrize("nin,grid_size,order", [(16, 5, 3), (8, 7, 2)])
def test_bspline_bases_and_grad(nin, grid_size, order):
    """B and B' by the differentiated recurrence, on knots and outside every
    span, against kanvit's; B' also against autograd through the bases and
    against the closed form the backward kernel uses."""
    rng = np.random.default_rng(6)
    grid = np.array(JK.make_bspline_grid(nin, grid_size, order))
    x = spline_inputs(rng, (40, nin), grid[0])
    got_b, got_d = TK.bspline_bases_and_grad(
        torch.from_numpy(x), torch.from_numpy(grid), order)
    want_b, want_d = JK.bspline_bases_and_grad(jnp.asarray(x), jnp.asarray(grid),
                                               order)
    assert got_b.shape == got_d.shape == (40, nin, grid_size + order)
    assert _maxdiff(got_b, want_b) <= TOL
    assert _maxdiff(got_d, want_d) <= TOL * max(1.0, float(np.abs(want_d).max()))
    outside = np.abs(x) > 1.0 + 2.0 / grid_size * (order + 0.5)
    assert outside.any() and np.all(got_d.numpy()[outside] == 0)
    tx = torch.from_numpy(x).requires_grad_(True)
    bases = TK.bspline_bases(tx, torch.from_numpy(grid), order)
    auto = torch.stack([torch.autograd.grad(bases[..., j].sum(), tx,
                                            retain_graph=True)[0]
                        for j in range(bases.shape[-1])], -1)
    assert _maxdiff(got_d, auto) <= 1e-4
    tg = torch.from_numpy(grid)
    prev = TK.bspline_bases(torch.from_numpy(x), tg, order - 1)
    inv = 1.0 / (tg[:, order:] - tg[:, :-order])
    closed = order * (prev[..., :-1] * inv[:, :-1] - prev[..., 1:] * inv[:, 1:])
    assert _maxdiff(got_d, closed) <= 1e-4


@pytest.mark.parametrize("lead,nin,nout,scaler", [
    ((37,), 16, 8, True), ((2, 5), 32, 12, True), ((7,), 8, 4, False)])
def test_bspline_kan_forward(lead, nin, nout, scaler):
    rng = np.random.default_rng(2)
    grid = np.array(JK.make_bspline_grid(nin))
    x = spline_inputs(rng, (*lead, nin), grid[0])
    bw = rng.standard_normal((nout, nin)).astype(np.float32) * 0.3
    sw = rng.standard_normal((nout, nin, 8)).astype(np.float32) * 0.3
    sc = rng.standard_normal((nout, nin)).astype(np.float32) if scaler else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    got = TK.bspline_kan_forward(t(x), t(grid), t(bw), t(sw), t(sc)).numpy()
    want = JK.bspline_kan_forward(j(x), j(grid), j(bw), j(sw), j(sc))
    assert got.shape == (*lead, nout)
    assert _maxdiff(got, want) <= TOL


def test_bspline_curve2coeff_interpolates():
    """At init the fit is under-determined (6 points, 8 coefficients): the
    port and kanvit may pick different particular solutions, so hold each to
    reproducing the noise it was fitted to."""
    rng = np.random.default_rng(3)
    nin, nout = 8, 5
    grid = TK.make_bspline_grid(nin)
    pts = grid.T[3:-3]  # (6, in): the interior knots
    y = torch.from_numpy(rng.uniform(-0.01, 0.01, (6, nin, nout)).astype(np.float32))
    coef = TK.bspline_curve2coeff(pts, y, grid)
    assert coef.shape == (nout, nin, 8)
    fit = torch.einsum("bik,oik->bio", TK.bspline_bases(pts, grid), coef)
    assert _maxdiff(fit, y) <= 1e-6
    jcoef = np.asarray(JK.bspline_curve2coeff(
        jnp.asarray(pts.numpy()), jnp.asarray(y.numpy()), jnp.asarray(grid.numpy())))
    jfit = np.einsum("bik,oik->bio", TK.bspline_bases(pts, grid).numpy(), jcoef)
    assert _maxdiff(jfit, y) <= 1e-6


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 20, 8), (1, 2, 50, 32)])
def test_multi_head_attention(shape, causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    got = TA.multi_head_attention(*map(torch.from_numpy, (q, k, v)), causal).numpy()
    want = JA.multi_head_attention(*map(jnp.asarray, (q, k, v)), causal)
    assert _maxdiff(got, want) <= TOL


def test_lanes_attention_matches_multi_head_without_mask():
    """Without a mask the lanes plain version is plain softmax attention in
    the head-concatenated layout."""
    rng = np.random.default_rng(5)
    b, t, h, dh = 2, 20, 3, 16
    q, k, v = (rng.standard_normal((b, t, h * dh)).astype(np.float32)
               for _ in range(3))
    got = TA.lanes_attention(*map(torch.from_numpy, (q, k, v)), h, causal=True)
    to_h = lambda a: jnp.asarray(a).reshape(b, t, h, dh).transpose(0, 2, 1, 3)
    want = JA.multi_head_attention(to_h(q), to_h(k), to_h(v), True)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, t, h * dh)
    assert _maxdiff(got.numpy(), want) <= TOL


def test_dispatch_by_device():
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


def test_port_imports_no_jax():
    """Every kanvit_torch module imports without jax, flax, optax or kanvit."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "optax", "kanvit"):
                    raise ImportError(f"kanvit_torch imported {name}")
                return None

        sys.meta_path.insert(0, Block())
        import kanvit_torch
        names = [m.name for m in pkgutil.walk_packages(
            kanvit_torch.__path__, "kanvit_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "kanvit")]
        assert not bad, bad
        print(" ".join(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20
    assert {"kanvit_torch.train.state", "kanvit_torch.train.steps",
            "kanvit_torch.bench"} <= names
