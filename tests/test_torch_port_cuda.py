"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
an NVIDIA GPU and nvcc (jax not needed, so skip the JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances as ``chip_smoke.py``: forward B-spline 1e-4 and attention 1e-5,
backward 1e-4, times max(1, max|y|), all f32 with TF32 off. A backward
kernel is held against autograd through its plain version on the card.
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
    torch.backends.cudnn.allow_tf32 = False
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


def _grads(fn, inputs, g):
    """Gradients of ``(fn(*inputs) * g).sum()`` with respect to ``inputs``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("n,nin,nout", [(1, 8, 3), (37 * 49, 16, 64), (300, 100, 70)])
def test_bspline_kan_backward_kernel(cuda, n, nin, nout):
    rng = np.random.default_rng(44)
    x = _spline_x(rng, (n, nin)).to(cuda)
    grid = K.make_bspline_grid(nin, device=cuda)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
              for s in ((nout, nin), (nout, nin, 8), (nout, nin))]
    g = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).to(cuda)
    _, got = _grads(lambda *a: FB.bspline_kan(a[0], grid, *a[1:]), [x, *params], g)
    _, want = _grads(lambda *a: K.bspline_kan_forward(a[0], grid, *a[1:]),
                     [x, *params], g)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["bspline_kan"] == 1 and FB.LAUNCHES["bspline_kan_bwd"] == 1


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64)])
def test_bspline_qkv_grouped_backward_kernel(cuda, n, h, dh):
    rng = np.random.default_rng(45)
    x = _spline_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
              for s in ((h, 3 * dh, dh), (h, 3 * dh, dh, 8), (h, 3 * dh, dh))]
    g = torch.from_numpy(rng.standard_normal((n, h * 3 * dh)).astype(np.float32)).to(cuda)

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(x[:, i * dh:(i + 1) * dh], grid,
                                                bw[i], sw[i], sc[i])
                          for i in range(h)], dim=1)

    _, got = _grads(lambda *a: FB.bspline_qkv_grouped(a[0], grid, *a[1:]),
                    [x, *params], g)
    _, want = _grads(plain, [x, *params], g)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == 1


def test_bspline_backward_repeats_its_bits(cuda):
    """The dW reduction splits its rows and sums the splits in a fixed
    order: two runs give the same bits."""
    rng = np.random.default_rng(46)
    x = _spline_x(rng, (12608, 64)).to(cuda)
    grid = K.make_bspline_grid(64, device=cuda)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
              for s in ((192, 64), (192, 64, 8), (192, 64))]
    g = torch.from_numpy(rng.standard_normal((12608, 192)).astype(np.float32)).to(cuda)
    fn = lambda *a: FB.bspline_kan(a[0], grid, *a[1:])  # noqa: E731
    _, first = _grads(fn, [x, *params], g)
    _, second = _grads(fn, [x, *params], g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("b,t,h,dh", [(3, 50, 2, 32), (2, 197, 6, 64), (2, 7, 4, 16)])
def test_attention_lanes_backward_kernel(cuda, b, t, h, dh, causal, masked):
    rng = np.random.default_rng(47)
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32))
    y = y.to(cuda)
    g = torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(np.float32)).to(cuda)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, t)) > 0.3).to(cuda)
        mask[0] = False

    def through(attn):
        def fn(y):
            y4 = y.view(b, t, h, 3 * dh)
            q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
            return attn(q, k, v, h, causal=causal, mask=mask)
        return fn

    _, (got,) = _grads(through(FA.flash_attention_lanes), [y], g)
    _, (want,) = _grads(through(A.lanes_attention), [y], g)
    _close(got, want, 1e-4)
    if masked:  # the fully masked batch item: exactly 0
        assert bool((got.view(b, t, -1)[0] == 0).all())
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 1


def test_train_step_on_card(cuda):
    """Two Adam steps of a 2-block MNIST-geometry model on the card against
    the same steps on the CPU: losses and params within 1e-4 (f32, sums in
    another order; the first Adam step moves each parameter by about lr =
    1e-3 whatever its gradient, so 1e-4 of that is far above rounding)."""
    import copy

    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    cpu = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, n_blocks=2,
                       d_hidden=64, n_heads=2, out_d=10, seed=3)
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.standard_normal((6, 1, 28, 28)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 6))
    step = make_train_step()
    sc, sg = create_train_state(cpu), create_train_state(gpu)
    for _ in range(2):
        sc, lc, _ = step(sc, x, y)
        sg, lg, _ = step(sg, x.to(cuda), y.to(cuda))
        assert abs(float(lc) - float(lg)) <= 1e-4
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert float((pc - pg.cpu()).detach().abs().max()) <= 1e-4, name
    assert FB.LAUNCHES["bspline_kan_bwd"] == 2
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == 4
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 4
