"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
an NVIDIA GPU and nvcc (jax not needed, so skip the JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances as ``chip_smoke.py``: B-spline 1e-4 and attention 1e-5, times
max(1, max|y|), both f32 with TF32 off.
"""

import numpy as np
import pytest
import torch

from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import kan_bases as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    FB.reset_launches()
    FA.reset_launches()
    return torch.device("cuda")


def _close(got, want, tol):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert got.isfinite().all() and err <= tol * max(1.0, float(want.abs().max())), err


def _spline_x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    knots = K.make_bspline_grid(1)[0].numpy()
    flat[::5] = knots[np.arange(flat[::5].size) % knots.size]
    flat[2::7] = np.float32([-3.0, -2.2, 2.2, 3.0])[np.arange(flat[2::7].size) % 4]
    return torch.from_numpy(x)


@pytest.mark.parametrize("n,nin,nout", [(1, 8, 3), (37 * 49, 16, 64), (300, 100, 70)])
def test_bspline_kan_kernel(cuda, n, nin, nout):
    rng = np.random.default_rng(40)
    x = _spline_x(rng, (n, nin)).to(cuda)
    grid = K.make_bspline_grid(nin, device=cuda)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
                  for s in ((nout, nin), (nout, nin, 8), (nout, nin)))
    with torch.inference_mode():
        y = FB.bspline_kan(x, grid, bw, sw, sc)
        _close(y, K.bspline_kan_forward(x, grid, bw, sw, sc), 1e-4)
    assert FB.LAUNCHES["bspline_kan"] == 1


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64)])
def test_bspline_qkv_grouped_kernel(cuda, n, h, dh):
    rng = np.random.default_rng(41)
    x = _spline_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
                  for s in ((h, 3 * dh, dh), (h, 3 * dh, dh, 8), (h, 3 * dh, dh)))
    with torch.inference_mode():
        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        want = torch.cat([K.bspline_kan_forward(x[:, i * dh:(i + 1) * dh], grid,
                                                bw[i], sw[i], sc[i])
                          for i in range(h)], dim=1)
        _close(y, want, 1e-4)
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 1


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("b,t,h,dh", [(3, 50, 2, 32), (2, 197, 6, 64), (2, 7, 4, 16)])
def test_attention_lanes_kernel(cuda, b, t, h, dh, causal, masked):
    rng = np.random.default_rng(42)
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32))
    y4 = y.to(cuda).view(b, t, h, 3 * dh)
    q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, t)) > 0.3).to(cuda)
        mask[0] = False
    with torch.inference_mode():
        o = FA.flash_attention_lanes(q, k, v, h, causal=causal, mask=mask)
        _close(o, A.lanes_attention(q, k, v, h, causal=causal, mask=mask), 1e-5)
        if masked:
            assert bool((o[0] == 0).all())
    assert FA.LAUNCHES["flash_attention_lanes"] == 1


def test_kernels_raise_not_fall_back(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float64)
    grid = K.make_bspline_grid(16, device=cuda)
    w = torch.zeros(3, 16, device=cuda)
    with torch.inference_mode(), pytest.raises(TypeError, match="float32"):
        FB.bspline_kan(x, grid, w, w[..., None].expand(-1, -1, 8), w)
    q = torch.zeros(1, 4, 2 * 8, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_lanes(q, q, q, 2)
    assert FB.LAUNCHES["bspline_kan"] == 0 and FA.LAUNCHES["flash_attention_lanes"] == 0


def test_model_forward_on_card(cuda):
    from kanvit_torch.models import create_model

    model = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, n_blocks=2,
                         d_hidden=64, n_heads=2, out_d=10)
    x = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (5, 1, 28, 28)).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3
    assert (FB.LAUNCHES["bspline_kan"], FB.LAUNCHES["bspline_qkv_grouped"],
            FA.LAUNCHES["flash_attention_lanes"]) == (1, 2, 2)
