"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
an NVIDIA GPU and nvcc (jax not needed, so skip the JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances as ``chip_smoke.py``: forward KAN 1e-4 and attention 1e-5,
backward 1e-4, times max(1, max|y|), all f32 with TF32 off. A backward
kernel is held against autograd through its plain version on the card.
"""

import re

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


# --- the tiled attention (flash_attention.cu) and its model family ------------

def _flash_inputs(rng, b, h, tq, tk, dh, masked):
    """q, k, v as (B, H, T, dh) views of (B, T, H, dh) projections; the key
    mask hides keys 0-3 of item 0 (causal rows there see no valid key) and
    every key of item 1."""
    q = torch.from_numpy(rng.standard_normal((b, tq, h, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, dh)).astype(np.float32))
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, tk)) > 0.2)
        mask[0, :4] = False
        if b > 1:
            mask[1] = False
    return [a.cuda().transpose(1, 2) for a in (q, k, v)], (
        None if mask is None else mask.cuda())


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("b,h,tq,tk,dh,blocks", [
    (2, 3, 200, 200, 64, (128, 128)),
    (2, 2, 300, 517, 32, (512, 1024)),   # tq < tk: rows with qpos < 0
    (2, 2, 517, 300, 16, (512, 1024)),   # tq > tk
    (1, 4, 1100, 1100, 64, (512, 1024)),
])
def test_flash_attention_kernels(cuda, b, h, tq, tk, dh, blocks, causal, masked):
    """Forward within 1e-5 and dq, dk, dv within 1e-4 (x max(1, max|y|)) of
    autograd through ``flash_attention_reference`` on the card."""
    rng = np.random.default_rng(49)
    (q, k, v), mask = _flash_inputs(rng, b, h, tq, tk, dh, masked)
    g = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(np.float32)).cuda()
    assert not FA.use_small(tq, tk, dh, h, *blocks)
    keys = None if mask is None else mask
    out, got = _grads(lambda *a: FA.flash_attention(*a, causal, *blocks, mask),
                      [q, k, v], g)
    ref, want = _grads(lambda *a: A.flash_attention_reference(
        *a, causal, *blocks, keys)[0], [q, k, v], g)
    _close(out, ref, 1e-5)
    for a, w in zip(got, want):
        _close(a, w, 1e-4)
    assert (FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_dq"],
            FA.LAUNCHES["flash_attention_dkv"]) == (1, 1, 1)
    assert FA.LAUNCHES["flash_attention_lanes"] == 0


def test_flash_attention_backward_repeats_its_bits(cuda):
    rng = np.random.default_rng(50)
    (q, k, v), mask = _flash_inputs(rng, 2, 4, 700, 700, 64, True)
    g = torch.randn(2, 4, 700, 64, device=cuda)
    fn = lambda *a: FA.flash_attention(*a, True, 512, 1024, mask)  # noqa: E731
    first, second = _grads(fn, [q, k, v], g), _grads(fn, [q, k, v], g)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


def test_flash_attention_single_tile_route(cuda):
    """Where kanvit's ``_use_small`` holds, ``flash_attention`` runs the lanes
    kernels on (B, T, H, dh) views: a row with no visible valid key is 0."""
    rng = np.random.default_rng(51)
    (q, k, v), mask = _flash_inputs(rng, 3, 2, 100, 100, 32, True)
    g = torch.from_numpy(rng.standard_normal((3, 2, 100, 32)).astype(np.float32)).cuda()
    assert FA.use_small(100, 100, 32, 2, 512, 1024)

    def plain(q, k, v):
        o = A.lanes_attention(*(a.transpose(1, 2) for a in (q, k, v)), 2,
                              causal=True, mask=mask)
        return o.view(3, 100, 2, 32).transpose(1, 2)

    out, got = _grads(lambda *a: FA.flash_attention(*a, True, 512, 1024, mask),
                      [q, k, v], g)
    ref, want = _grads(plain, [q, k, v], g)
    _close(out, ref, 1e-5)
    for a, w in zip(got, want):
        _close(a, w, 1e-4)
    assert bool((out[0, :, :4] == 0).all())
    assert (FA.LAUNCHES["flash_attention_lanes"], FA.LAUNCHES["flash_attention_lanes_bwd"],
            FA.LAUNCHES["flash_attention"]) == (1, 1, 0)


def test_flash_kernels_raise_not_fall_back(cuda):
    q = torch.zeros(1, 2, 600, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q, True)
    q = torch.zeros(1, 2, 600, 32, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        FA.flash_attention(q, q, q, True)
    assert sum(FA.LAUNCHES.values()) == 0


def test_decoder_train_step_on_card(cuda):
    """Two LM steps of a 2-block decoder at T = 600 (tiled tier) on the card
    against the same steps on the CPU: losses and params within 1e-4."""
    import copy

    from kanvit_torch import bench_decoder as BD

    cpu = BD.build_model(64, 2, 2, 128, seed=6)
    gpu = copy.deepcopy(cpu).to(cuda)
    tokens = BD.make_tokens(2, 600, 128)
    sc, sg = BD.make_step(cpu), BD.make_step(gpu)
    for _ in range(2):
        lc, lg = sc(tokens), sg(tokens.to(cuda))
        assert abs(float(lc) - float(lg)) <= 1e-4
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert float((pc - pg.cpu()).detach().abs().max()) <= 1e-4, name
    assert (FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_dq"],
            FA.LAUNCHES["flash_attention_dkv"], FA.LAUNCHES["flash_attention_lanes"]
            ) == (4, 4, 4, 0)


def test_flash_vit_forward_on_card(cuda):
    from kanvit_torch.models import create_model

    model = create_model("flash-attn", chw=(1, 28, 28), n_patches=7, n_blocks=2,
                         d_hidden=64, n_heads=2, out_d=10)
    x = torch.from_numpy(np.random.default_rng(52).standard_normal(
        (5, 1, 28, 28)).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3
    assert (FA.LAUNCHES["flash_attention_lanes"], FA.LAUNCHES["flash_attention"]) == (2, 0)


# --- the Chebyshev and Fourier kernels (kan_basis.cu) and their ViTs ----------

def _cheby_x(rng, shape, saturated=0.1):
    """Normal inputs with a share where tanh(x) rounds to +-1 (|x| >= 9.5)."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = (rng.uniform(9.5, 20.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return torch.from_numpy(x)


def _fourier_x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = rng.uniform(-10.0, 10.0, x.reshape(-1)[::7].size)
    return torch.from_numpy(x)


def _param(rng, shape, scale):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("n,nin,nout", [(1, 8, 3), (1000, 16, 24), (300, 100, 70)])
def test_chebykan_kernels(cuda, n, nin, nout):
    """Forward, dx and dcoeffs, with saturated inputs: finite, and 0 dx there."""
    rng = np.random.default_rng(60)
    x = _cheby_x(rng, (n, nin)).to(cuda)
    cc = _param(rng, (nin, nout, 5), 1.0 / nin).to(cuda)
    g = _param(rng, (n, nout), 1.0).to(cuda)
    y, got = _grads(FB.chebykan, [x, cc], g)
    ref, want = _grads(K.chebykan_forward, [x, cc], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert bool((got[0][x.abs() >= 9.5] == 0).all())
    assert FB.LAUNCHES["chebykan"] == 1 and FB.LAUNCHES["chebykan_bwd"] == 1


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64)])
def test_cheby_qkv_grouped_kernels(cuda, n, h, dh):
    rng = np.random.default_rng(61)
    x = _cheby_x(rng, (n, h * dh), 0.02).to(cuda)
    cc = _param(rng, (h, dh, 3 * dh, 5), 1.0 / dh).to(cuda)
    g = _param(rng, (n, h * 3 * dh), 1.0).to(cuda)

    def plain(x, cc):
        return torch.cat([K.chebykan_forward(x[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)

    y, got = _grads(FB.cheby_qkv_grouped, [x, cc], g)
    ref, want = _grads(plain, [x, cc], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["cheby_qkv_grouped"] == 1
    assert FB.LAUNCHES["cheby_qkv_grouped_bwd"] == 1


@pytest.mark.parametrize("n,nin,nout,grid_size", [
    (1, 8, 3, 1), (1000, 16, 24, 5), (999, 20, 70, 7), (300, 64, 96, 28)])
def test_fourierkan_kernels(cuda, n, nin, nout, grid_size):
    """Forward, dx, dcoeffs and dbias at |x| up to 10, G from 1 to 28 (a
    ragged last chunk of 4 harmonics at 1, 5 and 7)."""
    rng = np.random.default_rng(62)
    x = _fourier_x(rng, (n, nin)).to(cuda)
    co = _param(rng, (2, nout, nin, grid_size), 1.0 / np.sqrt(nin * grid_size)).to(cuda)
    bias = _param(rng, (1, nout), 0.1).to(cuda)
    g = _param(rng, (n, nout), 1.0).to(cuda)
    y, got = _grads(FB.fourierkan, [x, co, bias], g)
    ref, want = _grads(K.fourierkan_forward, [x, co, bias], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["fourierkan"] == 1 and FB.LAUNCHES["fourierkan_bwd"] == 1


@pytest.mark.parametrize("family", ["cheby", "fourier"])
def test_new_backward_repeats_its_bits(cuda, family):
    """dW splits its rows and sums the splits in a fixed order."""
    rng = np.random.default_rng(63)
    if family == "cheby":
        x = _cheby_x(rng, (12544, 96)).to(cuda)
        params = [_param(rng, (96, 48, 5), 0.01).to(cuda)]
        fn = FB.chebykan
    else:
        x = _fourier_x(rng, (12544, 96)).to(cuda)
        params = [_param(rng, (2, 48, 96, 28), 0.02).to(cuda), None]
        fn = FB.fourierkan
    g = _param(rng, (12544, 48), 1.0).to(cuda)
    _, first = _grads(lambda *a: fn(*a, *params[1:]), [x, params[0]], g)
    _, second = _grads(lambda *a: fn(*a, *params[1:]), [x, params[0]], g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_new_kernels_raise_not_fall_back(cuda):
    x = torch.zeros(4, 16, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="Chebyshev degree"):
        FB.chebykan(x, torch.zeros(16, 3, 4, device=cuda))
    with torch.inference_mode(), pytest.raises(TypeError, match="float32"):
        FB.fourierkan(x.double(), torch.zeros(2, 3, 16, 5, device=cuda,
                                              dtype=torch.float64), None)
    assert sum(FB.LAUNCHES.values()) == 0


@pytest.mark.parametrize("variant,launches", [
    ("cheby", {"chebykan": 1, "cheby_qkv_grouped": 2, "flash_attention_lanes": 2}),
    ("fourier", {"fourierkan": 1, "flash_attention_lanes": 2}),
    ("vanilla", {"flash_attention_lanes": 2}),
    ("fast", {"fastkan": 1, "fastkan_qkv_grouped": 6, "flash_attention_lanes": 2}),
    ("sine", {"sinekan": 1, "sinekan_qkv_grouped": 6, "flash_attention_lanes": 2})])
def test_variant_train_step_on_card(cuda, variant, launches):
    """A forward, then two Adam steps, of a 2-block MNIST-geometry model on
    the card against the CPU: logits within 1e-3, losses and params within
    1e-4; the launches of one forward. A key projection's constant term (a
    Linear, FastKAN or SineKAN key's bias, a ChebyKAN key's T_0 slice) has a
    gradient of 0 in
    exact arithmetic, since the softmax cancels it, so Adam moves it by
    rounding noise of either sign: it is held within 2 steps of lr."""
    import copy

    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    cpu = create_model(variant, chw=(1, 28, 28), n_patches=7, n_blocks=2,
                       d_hidden=64, n_heads=2, out_d=10, seed=3)
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(64)
    x = torch.from_numpy(rng.standard_normal((6, 1, 28, 28)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 6))
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3
    assert {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n} == launches
    step = make_train_step()
    sc, sg = create_train_state(cpu), create_train_state(gpu)
    for _ in range(2):
        sc, lc, _ = step(sc, x, y)
        sg, lg, _ = step(sg, x.to(cuda), y.to(cuda))
        assert abs(float(lc) - float(lg)) <= 1e-4
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        diff = (pc - pg.cpu()).detach().abs()
        noise = torch.zeros_like(diff, dtype=torch.bool)
        if re.search(r"\.k_mappings\.\d+\.(base_linear\.)?bias$", name):
            noise[...] = True
        elif ".k_mappings." in name and name.endswith(".cheby_coeffs"):
            noise[..., 0] = True
        assert float(torch.where(noise, 0.0, diff).max()) <= 1e-4, name
        assert float(torch.where(noise, diff, 0.0).max()) <= 2 * 2 * 1e-3, name


# --- the RBF and sine kernels (kan_rbf_sine.cu) ---------------------------------

RBF_GRID = torch.linspace(-2.0, 2.0, 8)


def _fast_x(rng, shape):
    """Normal inputs (std 1.5), every 9th entry at |x| in [20, 60], the
    first row constant (the LayerNorm's variance 0)."""
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    flat[4::9] = rng.uniform(20.0, 60.0, flat[4::9].size) * rng.choice([-1, 1], flat[4::9].size)
    x.reshape(-1, shape[-1])[0] = 0.5
    return torch.from_numpy(x)


def _fast_params(rng, nout, nin, lead=()):
    return [_param(rng, (*lead, nin), 0.1) + 1.0, _param(rng, (*lead, nin), 0.1),
            _param(rng, (*lead, nout, nin * 8), 0.1), _param(rng, (*lead, nout, nin), 0.3),
            _param(rng, (*lead, nout), 0.1)]


@pytest.mark.parametrize("ln,base", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("n,nin,nout", [(1, 8, 3), (37 * 49, 16, 64), (300, 100, 70)])
def test_fastkan_kernels(cuda, n, nin, nout, ln, base):
    """Forward, dx, dgamma, dbeta, the spline and base weights and bias; with
    and without the LayerNorm and the base branch."""
    rng = np.random.default_rng(65)
    x = _fast_x(rng, (n, nin)).to(cuda)
    params = [p.to(cuda) for p in _fast_params(rng, nout, nin)]
    g = _param(rng, (n, nout), 1.0).to(cuda)
    grid = RBF_GRID.to(cuda)
    used = [True, ln, ln, True, base, base]

    def through(fn):
        def call(*a):
            it = iter(a)
            full = [next(it) if u else None for u in used]
            return fn(full[0], full[1], full[2], grid, 4 / 7, *full[3:])
        return call

    inputs = [t for t, u in zip([x, *params], used) if u]
    y, got = _grads(through(FB.fastkan), inputs, g)
    ref, want = _grads(through(K.fastkan_forward), inputs, g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["fastkan"] == 1 and FB.LAUNCHES["fastkan_bwd"] == 1


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64)])
def test_fastkan_qkv_grouped_kernels(cuda, n, h, dh):
    rng = np.random.default_rng(66)
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    params = [p.to(cuda) for p in _fast_params(rng, dh, dh, (h,))]
    g = _param(rng, (n, h * dh), 1.0).to(cuda)
    grid = RBF_GRID.to(cuda)

    def plain(x, ga, be, sw, bw, bb):
        return torch.cat([K.fastkan_forward(x[:, i * dh:(i + 1) * dh], ga[i], be[i], grid,
                                            4 / 7, sw[i], bw[i], bb[i])
                          for i in range(h)], dim=1)

    y, got = _grads(lambda x, ga, be, *w: FB.fastkan_qkv_grouped(x, ga, be, grid, 4 / 7, *w),
                    [x, *params], g)
    ref, want = _grads(plain, [x, *params], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["fastkan_qkv_grouped"] == 1
    assert FB.LAUNCHES["fastkan_qkv_grouped_bwd"] == 1


def _sine_x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = rng.uniform(-20.0, 20.0, x.reshape(-1)[::7].size)
    return torch.from_numpy(x)


@pytest.mark.parametrize("n,nin,nout,grid_size", [
    (1, 8, 3, 1), (1000, 16, 24, 5), (999, 20, 70, 7), (300, 64, 96, 28)])
def test_sinekan_kernels(cuda, n, nin, nout, grid_size):
    """Forward, dx, dfreq, damplitudes and dbias at |x| up to 20, G from 1
    to 28 (a ragged last chunk of 4 slices at 1, 5 and 7)."""
    rng = np.random.default_rng(67)
    x = _sine_x(rng, (n, nin)).to(cuda)
    freq = (torch.arange(1, grid_size + 1) / (grid_size + 1)).reshape(1, 1, 1, -1).to(cuda)
    phase = K.sinekan_phase_init(nin, grid_size).to(cuda)
    amps = _param(rng, (nout, nin, grid_size), 1.0 / nout).to(cuda)
    bias = _param(rng, (1, nout), 0.1).to(cuda)
    g = _param(rng, (n, nout), 1.0).to(cuda)
    y, got = _grads(lambda x, f, a, b: FB.sinekan(x, f, phase, a, b), [x, freq, amps, bias], g)
    ref, want = _grads(lambda x, f, a, b: K.sinekan_forward(x, f, phase, a, b),
                       [x, freq, amps, bias], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["sinekan"] == 1 and FB.LAUNCHES["sinekan_bwd"] == 1


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64)])
def test_sinekan_qkv_grouped_kernels(cuda, n, h, dh):
    rng = np.random.default_rng(68)
    x = _sine_x(rng, (n, h * dh)).to(cuda)
    freq = (torch.arange(1, 5) / 5).repeat(h, 1).to(cuda) + _param(rng, (h, 4), 0.05).to(cuda)
    phase = K.sinekan_phase_init(dh, 4).to(cuda)
    amps = _param(rng, (h, dh, dh, 4), 1.0 / dh).to(cuda)
    bias = _param(rng, (h, dh), 0.1).to(cuda)
    g = _param(rng, (n, h * dh), 1.0).to(cuda)

    def plain(x, f, a, b):
        return torch.cat([K.sinekan_forward(x[:, i * dh:(i + 1) * dh], f[i], phase, a[i], b[i])
                          for i in range(h)], dim=1)

    y, got = _grads(lambda x, f, a, b: FB.sinekan_qkv_grouped(x, f, phase, a, b),
                    [x, freq, amps, bias], g)
    ref, want = _grads(plain, [x, freq, amps, bias], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["sinekan_qkv_grouped_bwd"] == 1


@pytest.mark.parametrize("family", ["rbf", "sine"])
def test_rbf_sine_backward_repeats_its_bits(cuda, family):
    """dW, dgamma, dbeta and dfreq are per-block partials summed in a fixed
    order."""
    rng = np.random.default_rng(69)
    g = _param(rng, (12544, 48), 1.0).to(cuda)
    if family == "rbf":
        x = _fast_x(rng, (12544, 96)).to(cuda)
        grid = RBF_GRID.to(cuda)
        inputs = [x, *[p.to(cuda) for p in _fast_params(rng, 48, 96)]]
        fn = lambda x, ga, be, *w: FB.fastkan(x, ga, be, grid, 4 / 7, *w)  # noqa: E731
    else:
        x = _sine_x(rng, (12544, 96)).to(cuda)
        phase = K.sinekan_phase_init(96, 28).to(cuda)
        inputs = [x, torch.rand(28, device=cuda), _param(rng, (48, 96, 28), 0.02).to(cuda)]
        fn = lambda x, f, a: FB.sinekan(x, f, phase, a, None)  # noqa: E731
    _, first = _grads(fn, inputs, g)
    _, second = _grads(fn, inputs, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_rbf_sine_kernels_raise_not_fall_back(cuda):
    x = torch.zeros(4, 16, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="8 RBF centres"):
        FB.fastkan(x, None, None, torch.zeros(5, device=cuda), 1.0,
                   torch.zeros(3, 16 * 5, device=cuda), None, None)
    with torch.inference_mode(), pytest.raises(TypeError, match="float32"):
        FB.sinekan(x.double(), torch.zeros(4, device=cuda, dtype=torch.float64),
                   torch.zeros(16, 4, device=cuda, dtype=torch.float64),
                   torch.zeros(3, 16, 4, device=cuda, dtype=torch.float64), None)
    assert sum(FB.LAUNCHES.values()) == 0
