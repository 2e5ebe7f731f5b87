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
from kanvit_torch.kernels import int8_matmul as IM
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


@pytest.mark.parametrize("n,h,dh", [(37 * 50, 2, 32), (129, 6, 64), (12608, 6, 64)])
def test_bspline_qkv_grouped_kernel(cuda, n, h, dh):
    """The tensor-core forward against the plain version, no further from
    f64 than twice it, and a second forward with the same bits."""
    rng = np.random.default_rng(41)
    x = _spline_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
                  for s in ((h, 3 * dh, dh), (h, 3 * dh, dh, 8), (h, 3 * dh, dh)))

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(x[:, i * dh:(i + 1) * dh], grid, bw[i],
                                                sw[i], sc[i]) for i in range(h)], dim=1)

    with torch.inference_mode():
        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        again = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        want = plain(x, bw, sw, sc)
        _close(y, want, 1e-4)
        _f64_gate(y, want, plain(*(a.double() for a in (x, bw, sw, sc))))
    assert torch.equal(y, again)
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 2


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


def test_attention_lanes_vit_s_repeats_bits_and_holds_f64(cuda):
    """The 3xTF32 tensor-core kernels at vit-s (B 64, T 197, 6 heads of
    64): forward and backward give the same bits twice, and the forward is
    within 1e-6 x max(1, max|o|) of f64 computed on the card."""
    rng = np.random.default_rng(96)
    b, t, h, dh = 64, 197, 6, 64
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32))
    y = y.to(cuda)
    g = torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(np.float32)).to(cuda)

    def fn(y):
        y4 = y.view(b, t, h, 3 * dh)
        return FA.flash_attention_lanes(*(y4[..., i * dh:(i + 1) * dh]
                                          for i in range(3)), h)

    first, (g1,) = _grads(fn, [y], g)
    again, (g2,) = _grads(fn, [y], g)
    assert torch.equal(first, again) and torch.equal(g1, g2)
    y4 = y.double().view(b, t, h, 3 * dh)
    exact = A.lanes_attention(*(y4[..., i * dh:(i + 1) * dh] for i in range(3)), h)
    _close(first.double(), exact, 1e-6)
    assert (FA.LAUNCHES["flash_attention_lanes"],
            FA.LAUNCHES["flash_attention_lanes_bwd"]) == (2, 2)


def test_attention_lanes_unaligned_rows_raise(cuda):
    """The tensor-core head dims stage 16-byte rows: a view whose rows are
    not 16-byte aligned raises, with no copy and no launch."""
    flat = torch.randn(2 * 9 * 16 + 1, device=cuda)
    q = flat[1:].view(2, 9, 16)
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_lanes(q, q, q, 2)
    assert FA.LAUNCHES["flash_attention_lanes"] == 0


def test_kernels_raise_not_fall_back(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float64)
    grid = K.make_bspline_grid(16, device=cuda)
    w = torch.zeros(3, 16, device=cuda)
    with torch.inference_mode(), pytest.raises(TypeError, match="float32"):
        FB.bspline_kan(x, grid, w, w[..., None].expand(-1, -1, 8), w)
    q = torch.zeros(1, 4, 2 * 12, device=cuda)
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


@pytest.mark.parametrize("dh", [64, 8])
def test_flash_attention_tc_repeats_bits_and_holds_f64(cuda, dh):
    """The tiled 3xTF32 tensor-core kernels at the decoder's seq 2048 (B 2,
    H 4, causal): forward and backward give the same bits twice, and the
    forward is within 1e-6 x max(1, max|o|) of f64 computed on the card."""
    rng = np.random.default_rng(98 + dh)
    (q, k, v), _ = _flash_inputs(rng, 2, 4, 2048, 2048, dh, masked=False)
    g = torch.from_numpy(rng.standard_normal((2, 4, 2048, dh)).astype(np.float32)).to(cuda)
    fn = lambda *a: FA.flash_attention(*a, True, 512, 1024)  # noqa: E731
    first, g1 = _grads(fn, [q, k, v], g)
    again, g2 = _grads(fn, [q, k, v], g)
    assert torch.equal(first, again)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    exact = A.flash_attention_reference(q.double(), k.double(), v.double(), True,
                                        512, 1024)[0]
    _close(first.double(), exact, 1e-6)
    assert (FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_dq"],
            FA.LAUNCHES["flash_attention_dkv"]) == (2, 2, 2)


def test_flash_attention_unaligned_rows_raise(cuda):
    """The tiled tensor-core head dims stage 16-byte rows: a view whose rows
    are not 16-byte aligned raises, with no copy and no launch."""
    flat = torch.randn(2 * 600 * 2 * 16 + 1, device=cuda)
    q = flat[1:].view(2, 600, 2, 16).transpose(1, 2)
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, q, q, True)
    assert FA.LAUNCHES["flash_attention"] == 0


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
    q = torch.zeros(1, 2, 600, 12, device=cuda)
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
def test_chebykan_kernels(cuda, monkeypatch, n, nin, nout):
    """Forward, dx and dcoeffs, with saturated inputs: finite, and 0 dx there;
    the forward the tensor-core entry's."""
    called = _recording(monkeypatch, ("kanvit_chebykan_tc_fwd", "kanvit_chebykan_fwd"))
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
    assert called == ["kanvit_chebykan_tc_fwd"]


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


@pytest.mark.parametrize("n,h,dh", [(12608, 6, 64), (37 * 50, 2, 32), (3200, 8, 8),
                                    (301, 2, 5)])
def test_cheby_qkv_grouped_tc_backward(cuda, n, h, dh):
    """The tensor-core backward (dx and dW in 3xTF32) with a share of x where
    tanh(x) rounds to +-1: every gradient finite, dx 0 there, within 1e-4 x
    max(1, max|g|) of the plain version and no further from f64 than twice
    it, and a second backward with the same bits; dh 5's 15 outputs a head
    take the 4-byte copies of gy."""
    rng = np.random.default_rng(64 + dh)
    x = _cheby_x(rng, (n, h * dh), 0.05).to(cuda)
    cc = _param(rng, (h, dh, 3 * dh, 5), 1.0 / np.sqrt(dh * 5)).to(cuda)
    g = _param(rng, (n, h * 3 * dh), 1.0).to(cuda)

    def plain(x, cc):
        return torch.cat([K.chebykan_forward(x[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)

    _, got = _grads(FB.cheby_qkv_grouped, [x, cc], g)
    _, again = _grads(FB.cheby_qkv_grouped, [x, cc], g)
    _, want = _grads(plain, [x, cc], g)
    _, exact = _grads(lambda *a: plain(*a).double(), [x.double(), cc.double()], g.double())
    for a, b, c in zip(got, want, exact):
        _close(a, b, 1e-4)
        _f64_gate(a, b, c)
    assert bool((got[0][x.abs() >= 9.5] == 0).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert FB.LAUNCHES["cheby_qkv_grouped_bwd"] == 2


@pytest.mark.parametrize("n,h,dh,saturated", [(12608, 6, 64, 0.05), (37 * 50 - 1, 2, 32, 0.05),
                                               (301, 4, 8, 0.05), (300, 2, 16, 1.0)])
def test_cheby_qkv_grouped_tc_forward(cuda, monkeypatch, n, h, dh, saturated):
    """The tensor-core forward (3xTF32; dh 8's 24 outputs a head in 64-output
    tiles) over x with a share where tanh(x) rounds to +-1 (all of it in the
    last case): within 1e-4 x max(1, max|y|) of the plain version and of
    the CUDA-core kernel it replaced, no further from f64 than twice the
    plain f32 version, a second forward with the same bits, and the
    tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_cheby_qkv_tc_fwd", "kanvit_chebykan_fwd"))
    rng = np.random.default_rng(74 + dh)
    x = _cheby_x(rng, (n, h * dh), saturated).to(cuda)
    cc = _param(rng, (h, dh, 3 * dh, 5), 1.0 / np.sqrt(dh * 5)).to(cuda)

    def plain(x, cc):
        return torch.cat([K.chebykan_forward(x[:, i * dh:(i + 1) * dh], cc[i])
                          for i in range(h)], dim=1)

    with torch.inference_mode():
        y = FB.cheby_qkv_grouped(x, cc)
        again = FB.cheby_qkv_grouped(x, cc)
        want = plain(x, cc)
        exact = plain(x.double(), cc.double())
        monkeypatch.setattr(FB, "TC_GROUPED_FWD", ())
        cores = FB.cheby_qkv_grouped(x, cc)
    _close(y, want, 1e-4)
    _close(y, cores, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert called == ["kanvit_cheby_qkv_tc_fwd"] * 2 + ["kanvit_chebykan_fwd"]
    assert FB.LAUNCHES["cheby_qkv_grouped"] == 3


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


def test_grouped_tc_entries_raise_not_fall_back(cuda, monkeypatch):
    """A tensor-core entry that fails (here: returns a CUDA error) makes the
    wrapper raise; the CUDA-core entries of the same call sites are never
    called, and nothing is counted."""
    from kanvit_torch.kernels import _build

    lib, called = _build.load(), []
    for name in ("kanvit_bspline_qkv_tc_fwd", "kanvit_cheby_qkv_tc_bwd"):
        monkeypatch.setattr(lib, name, lambda *args: 98)
    for name in ("kanvit_bspline_kan_fwd", "kanvit_chebykan_bwd"):
        def record(*args, _fn=getattr(lib, name), _name=name):
            called.append(_name)
            return _fn(*args)
        monkeypatch.setattr(lib, name, record)
    rng = np.random.default_rng(65)
    h, dh = 2, 8
    x = _spline_x(rng, (50, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    params = _spline_params(rng, h, 3 * dh, dh, cuda)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 98"):
        FB.bspline_qkv_grouped(x, grid, *params)
    cc = _param(rng, (h, dh, 3 * dh, 5), 0.1).to(cuda).requires_grad_(True)
    y = FB.cheby_qkv_grouped(x, cc)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        y.sum().backward()
    assert called == []
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 0
    assert FB.LAUNCHES["cheby_qkv_grouped_bwd"] == 0


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
    rounding noise of either sign: it is held within 2 steps of lr. So is an
    element at which the CPU, the reference, is itself unresolved: its Adam
    step more than half the tolerance from the step that f64 takes from the
    same parameters (an f64 copy of the CPU model at each step, Adam's
    moments in f64). The CPU and f64 alone choose these, before the card is
    compared; they are elements whose gradient is at rounding level beside
    Adam's eps (fourier's blocks.0.ff.2.weight[352]: 4.1e-9 in f64 beside
    the tensor's max|g| of 0.116), and the test prints how many. Before the
    second step the card takes the CPU's values and Adam moments at those
    elements, so that their first step, which rounding decides, does not
    move the second step's forward (ReLUs near 0 in the next block)."""
    import copy

    import torch.nn.functional as F

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
    moments, unresolved = {}, {}
    for t in (1, 2):
        exact = copy.deepcopy(cpu).double()
        exact.zero_grad(set_to_none=True)
        F.cross_entropy(exact(x.double()), y).backward()
        before = [p.detach().double().clone() for p in cpu.parameters()]
        sc, lc, _ = step(sc, x, y)
        sg, lg, _ = step(sg, x.to(cuda), y.to(cuda))
        assert abs(float(lc) - float(lg)) <= 1e-4
        for (name, pc), p0, pe in zip(cpu.named_parameters(), before, exact.parameters()):
            m, v = moments.get(name, (0.0, 0.0))
            m, v = 0.9 * m + 0.1 * pe.grad, 0.999 * v + 0.001 * pe.grad ** 2
            moments[name] = m, v
            step64 = -1e-3 * (m / (1 - 0.9 ** t)) / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)
            off = (pc.detach().double() - p0 - step64).abs() > 0.5e-4
            unresolved[name] = unresolved.get(name, off) | off
        if t == 1:
            with torch.no_grad():
                for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
                    u = unresolved[name].to(cuda)
                    pg.copy_(torch.where(u, pc.to(cuda), pg))
                    mc, mg = sc.tx.optim.state[pc], sg.tx.optim.state[pg]
                    for key in ("exp_avg", "exp_avg_sq"):
                        mg[key].copy_(torch.where(u, mc[key].to(cuda), mg[key]))
    print(f"{variant}: {sum(int(u.sum()) for u in unresolved.values())} elements where "
          "the CPU's Adam step is off f64's", {k: int(u.sum()) for k, u in unresolved.items()
                                              if u.any()})
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        diff = (pc - pg.cpu()).detach().abs()
        noise = unresolved[name].clone()
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


# (n, nin, nout, LayerNorm, base branch): the vit-s embedder, and ragged
# rows, features and outputs (48 features: three 16-feature dW tiles; 40
# outputs: one 64-output tile and gy's 4-byte copies at 70)
EMBEDDER_TC_SHAPES = [(12544, 768, 384, True, True), (37 * 49 + 3, 48, 40, True, True),
                      (1000, 100, 70, True, False), (999, 48, 40, False, True)]


@pytest.mark.parametrize("n,nin,nout,ln,base", EMBEDDER_TC_SHAPES)
def test_fastkan_tc_backward(cuda, monkeypatch, n, nin, nout, ln, base):
    """The embedder's backward on the tensor cores (the grouped templates at
    one group): every gradient within 1e-4 x max(1, max|g|) of the plain
    version; dgamma, dbeta and the spline and base weights no further from
    f64 than twice the plain f32 version; the training step's no-dx call
    gives the all-gradients call's bits for each of them, and a second
    backward repeats them; the tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_fastkan_qkv_tc_bwd", "kanvit_fastkan_bwd"))
    rng = np.random.default_rng(75 + nin)
    x = _fast_x(rng, (n, nin)).to(cuda)
    params = [p.to(cuda) for p in _fast_params(rng, nout, nin)]
    params[2], params[3] = params[2] / np.sqrt(8.0 * nin) * 10, params[3] / np.sqrt(nin) * 3
    g = _param(rng, (n, nout), 1.0).to(cuda)
    grid = RBF_GRID.to(cuda)
    used = [True, ln, ln, True, base, base]

    def through(fn):
        def call(*a):
            it = iter(a)
            full = [next(it) if u else None for u in used]
            return fn(full[0], full[1], full[2], grid.to(full[0].dtype), 4 / 7, *full[3:])
        return call

    inputs = [t for t, u in zip([x, *params], used) if u]
    names = [nm for nm, u in zip(("x", "gamma", "beta", "sw", "bw", "bb"), used) if u]
    _, got = _grads(through(FB.fastkan), inputs, g)
    _, again = _grads(through(FB.fastkan), inputs, g)
    _, no_dx = _grads(lambda *p: through(FB.fastkan)(x, *p), inputs[1:], g)
    _, want = _grads(through(K.fastkan_forward), inputs, g)
    _, exact = _grads(lambda *a: through(K.fastkan_forward)(*a).double(),
                      [t.double() for t in inputs], g.double())
    for name, a, b, c in zip(names, got, want, exact):
        _close(a, b, 1e-4)
        if name in ("gamma", "beta", "sw", "bw"):
            _f64_gate(a, b, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], no_dx))
    assert called == ["kanvit_fastkan_qkv_tc_bwd"] * 3
    assert FB.LAUNCHES["fastkan_bwd"] == 3


# (n, heads, dh, out per head): the tensor-core backward at dh 32, 64 and 8,
# out = dh and out != dh, ragged rows (37 * 50 is not a multiple of the
# 32-row dW stage or the 128-row dx block), nout 24 taking gy's 4-byte copies
GROUPED_TC_SHAPES = [(37 * 50, 2, 32, 32), (129, 6, 64, 64), (301, 4, 8, 24),
                     (1000, 2, 64, 40)]


@pytest.mark.parametrize("n,h,dh,out", GROUPED_TC_SHAPES)
def test_fastkan_qkv_grouped_kernels(cuda, n, h, dh, out):
    """Forward and every gradient against the plain version; the backward on
    the tensor cores."""
    rng = np.random.default_rng(66)
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    params = [p.to(cuda) for p in _fast_params(rng, out, dh, (h,))]
    g = _param(rng, (n, h * out), 1.0).to(cuda)
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


def test_fastkan_grouped_tc_backward_without_base_and_bits(cuda):
    """The grouped route with an 8-slice weight (no silu slice) against the
    plain version without the base branch, and a second backward of the
    9-slice route repeating its bits."""
    n, h, dh, out = 1000, 3, 32, 48
    rng = np.random.default_rng(166)
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    ga, be, sw, bw, bb = [p.to(cuda) for p in _fast_params(rng, out, dh, (h,))]
    g = _param(rng, (n, h * out), 1.0).to(cuda)
    grid = RBF_GRID.to(cuda)

    def plain(x, ga, be, sw):
        return torch.cat([K.fastkan_forward(x[:, i * dh:(i + 1) * dh], ga[i], be[i], grid,
                                            4 / 7, sw[i], None, None)
                          for i in range(h)], dim=1)

    def kernel(x, ga, be, sw):
        w = sw.reshape(h, out, dh, 8).permute(0, 3, 2, 1).contiguous()
        return FB._RbfFn.apply(x, w, ga, be, grid, 4 / 7, "fastkan_qkv_grouped")

    y, got = _grads(kernel, [x, ga, be, sw], g)
    ref, want = _grads(plain, [x, ga, be, sw], g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)

    def full(*a):
        return FB.fastkan_qkv_grouped(a[0], a[1], a[2], grid, 4 / 7, *a[3:])

    _, first = _grads(full, [x, ga, be, sw, bw, bb], g)
    _, second = _grads(full, [x, ga, be, sw, bw, bb], g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert FB.LAUNCHES["fastkan_qkv_grouped_bwd"] == 3


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


def _sine_grouped(rng, n, h, dh, out, grid_size, cuda):
    """(kernel, plain, inputs, g) of ``sinekan_qkv_grouped``."""
    x = _sine_x(rng, (n, h * dh)).to(cuda)
    freq = ((torch.arange(1, grid_size + 1) / (grid_size + 1)).repeat(h, 1)
            + _param(rng, (h, grid_size), 0.05)).to(cuda)
    phase = K.sinekan_phase_init(dh, grid_size).to(cuda)
    amps = _param(rng, (h, out, dh, grid_size), 1.0 / out).to(cuda)
    bias = _param(rng, (h, out), 0.1).to(cuda)
    g = _param(rng, (n, h * out), 1.0).to(cuda)

    def plain(x, f, a, b):
        return torch.cat([K.sinekan_forward(x[:, i * dh:(i + 1) * dh], f[i], phase, a[i], b[i])
                          for i in range(h)], dim=1)

    def kernel(x, f, a, b):
        return FB.sinekan_qkv_grouped(x, f, phase, a, b)

    return kernel, plain, [x, freq, amps, bias], g


@pytest.mark.parametrize("grid_size", [4, 3])
@pytest.mark.parametrize("n,h,dh,out", GROUPED_TC_SHAPES)
def test_sinekan_qkv_grouped_kernels(cuda, n, h, dh, out, grid_size):
    """Forward, dx, dfreq, the amplitudes and bias against the plain version;
    the backward on the tensor cores (grid 3 leaves a tile slice empty)."""
    kernel, plain, inputs, g = _sine_grouped(np.random.default_rng(68), n, h, dh, out,
                                             grid_size, cuda)
    y, got = _grads(kernel, inputs, g)
    ref, want = _grads(plain, inputs, g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert FB.LAUNCHES["sinekan_qkv_grouped_bwd"] == 1


@pytest.mark.parametrize("grid_size,entry", [(4, "kanvit_sinekan_qkv_tc_bwd"),
                                             (7, "kanvit_sinekan_bwd")])
def test_sinekan_qkv_grouped_route_by_grid(cuda, monkeypatch, grid_size, entry):
    """Up to 4 slices the grouped backward runs the tensor-core entry, past
    it the CUDA-core one; both against the plain version, and a second
    backward repeats the bits."""
    from kanvit_torch.kernels import _build

    lib, called = _build.load(), []
    for name in ("kanvit_sinekan_qkv_tc_bwd", "kanvit_sinekan_bwd"):
        def record(*args, _fn=getattr(lib, name), _name=name):
            called.append(_name)
            return _fn(*args)
        monkeypatch.setattr(lib, name, record)
    kernel, plain, inputs, g = _sine_grouped(np.random.default_rng(69), 999, 3, 32, 48,
                                             grid_size, cuda)
    y, got = _grads(kernel, inputs, g)
    assert called == [entry]
    _, again = _grads(kernel, inputs, g)
    ref, want = _grads(plain, inputs, g)
    _close(y, ref, 1e-4)
    for a, b, c in zip(got, want, again):
        _close(a, b, 1e-4)
        assert torch.equal(a, c)


def _recording(monkeypatch, names):
    """Wrap the library's entries ``names`` to record their calls."""
    from kanvit_torch.kernels import _build

    lib, called = _build.load(), []
    for name in names:
        def record(*args, _fn=getattr(lib, name), _name=name):
            called.append(_name)
            return _fn(*args)
        monkeypatch.setattr(lib, name, record)
    return called


# (n, heads, dh, base or grid size): one vit-s q/k/v projection (6 heads of
# 64 -> 64), ragged rows over two heads of 32, dh 8 over four heads
FWD_TC_SHAPES = [(12608, 6, 64), (37 * 50 - 1, 2, 32), (301, 4, 8)]


@pytest.mark.parametrize("base", [True, False])
@pytest.mark.parametrize("n,h,dh", FWD_TC_SHAPES)
def test_fastkan_qkv_grouped_tc_forward(cuda, monkeypatch, n, h, dh, base):
    """The tensor-core forward (the LayerNorm's statistics, then 3xTF32),
    with and without the base branch (an 8-slice weight in the 9-slice
    tile): within 1e-4 x max(1, max|y|) of the plain version, no further
    from f64 than twice it, a second forward with the same bits, and the
    tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_fastkan_qkv_tc_fwd", "kanvit_fastkan_fwd"))
    rng = np.random.default_rng(70 + dh)
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    ga, be, sw, bw, bb = [p.to(cuda) for p in _fast_params(rng, dh, dh, (h,))]
    sw, bw = sw / np.sqrt(8.0), bw / 3.0
    grid = RBF_GRID.to(cuda)
    w = FB.pack_fastkan_qkv_weight(sw, bw, 8) if base else (
        sw.reshape(h, dh, dh, 8).permute(0, 3, 2, 1))
    w = w.contiguous()

    def plain(x, ga, be, sw, bw):
        return torch.cat([K.fastkan_forward(x[:, i * dh:(i + 1) * dh], ga[i], be[i],
                                            grid.to(x.dtype), 4 / 7, sw[i],
                                            bw[i] if base else None,
                                            torch.zeros_like(bw[i, :, 0]) if base else None)
                          for i in range(h)], dim=1)

    with torch.inference_mode():
        y, stats = FB._launch_rbf("fastkan_qkv_grouped", x, w, ga, be, grid, 4 / 7)
        again, _ = FB._launch_rbf("fastkan_qkv_grouped", x, w, ga, be, grid, 4 / 7)
        want = plain(x, ga, be, sw, bw)
        exact = plain(*(a.double() for a in (x, ga, be, sw, bw)))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    xs = x.reshape(n, h, dh)
    _close(stats[..., 0], xs.mean(-1), 1e-5)
    assert called == ["kanvit_fastkan_qkv_tc_fwd"] * 2
    assert FB.LAUNCHES["fastkan_qkv_grouped"] == 2


@pytest.mark.parametrize("grid_size", [4, 3, 1])
@pytest.mark.parametrize("n,h,dh", FWD_TC_SHAPES)
def test_sinekan_qkv_grouped_tc_forward(cuda, monkeypatch, n, h, dh, grid_size):
    """The tensor-core forward at grids 4, 3 and 1 (tile slices left
    empty): within 1e-4 x max(1, max|y|) of the plain version, no further
    from f64 than twice it, a second forward with the same bits, and the
    tensor-core entry the one called; a grid of 7 takes the CUDA-core
    forward."""
    called = _recording(monkeypatch, ("kanvit_sinekan_qkv_tc_fwd", "kanvit_sinekan_fwd"))
    kernel, plain, inputs, _ = _sine_grouped(np.random.default_rng(71 + dh), n, h, dh, dh,
                                             grid_size, cuda)
    with torch.inference_mode():
        y = kernel(*inputs)
        again = kernel(*inputs)
        want = plain(*inputs)
        exact = plain(*(a.double() for a in inputs))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert called == ["kanvit_sinekan_qkv_tc_fwd"] * 2
    kernel, plain, inputs, _ = _sine_grouped(np.random.default_rng(72), 301, 2, 8, 8, 7, cuda)
    with torch.inference_mode():
        _close(kernel(*inputs), plain(*inputs), 1e-4)
    assert called[2:] == ["kanvit_sinekan_fwd"]
    assert FB.LAUNCHES["sinekan_qkv_grouped"] == 3


@pytest.mark.parametrize("n,h,dh", [(1849, 2, 32), (301, 4, 8), (12608, 6, 64)])
def test_bspline_qkv_grouped_tc_forward_large_silu_inputs(cuda, n, h, dh):
    """The B-spline tensor-core forward (one running sum, the silu slice
    in it) over inputs one in 9 at |x| in [20, 60], outside every knot
    span, where silu(x) dominates the row: within 1e-4 of the plain
    version, no further from f64 than twice it, bits repeated."""
    rng = np.random.default_rng(47 + dh)
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    bw, sw, sc = _spline_params(rng, h, 3 * dh, dh, cuda)

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(x[:, i * dh:(i + 1) * dh], grid.to(x.dtype),
                                                bw[i], sw[i], sc[i]) for i in range(h)], dim=1)

    with torch.inference_mode():
        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        again = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        want = plain(x, bw, sw, sc)
        exact = plain(*(a.double() for a in (x, bw, sw, sc)))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 2


@pytest.mark.parametrize("family", ["bspline", "cheby", "rbf", "sine"])
def test_grouped_tc_forward_refuses_a_short_scratch(cuda, monkeypatch, family):
    """The forward entries take the split W scratch's word count: sized for
    one step a stage fewer than the family's tile, the entry refuses it
    (cudaErrorInvalidValue) and the wrapper raises, writing nothing past
    it."""
    rng = np.random.default_rng(73)
    h, dh = 2, 16
    monkeypatch.setitem(FB.TCG_FWD_STEPS, family, FB.TCG_FWD_STEPS[family] - 1)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 1\\b"):
        if family == "bspline":
            x = _spline_x(rng, (50, h * dh)).to(cuda)
            FB.bspline_qkv_grouped(x, K.make_bspline_grid(dh, device=cuda),
                                   *_spline_params(rng, h, 3 * dh, dh, cuda))
        elif family == "cheby":
            x = _cheby_x(rng, (50, h * dh)).to(cuda)
            FB.cheby_qkv_grouped(x, _param(rng, (h, dh, 3 * dh, 5), 0.1).to(cuda))
        elif family == "rbf":
            x = _fast_x(rng, (50, h * dh)).to(cuda)
            ga, be, sw, bw, bb = [p.to(cuda) for p in _fast_params(rng, dh, dh, (h,))]
            FB.fastkan_qkv_grouped(x, ga, be, RBF_GRID.to(cuda), 4 / 7, sw, bw, bb)
        else:
            kernel, _, inputs, _ = _sine_grouped(rng, 50, h, dh, dh, 4, cuda)
            kernel(*inputs)
    assert sum(FB.LAUNCHES.values()) == 0


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


# --- the Fourier and sine embedders on the tensor cores ----------------------

def _tc_case(family, rng, n, nin, nout, grid_size, cuda):
    """(kernel wrapper, plain version, inputs, gradient) of ``fourierkan`` or
    ``sinekan``: the tensor-core forward and dW (sine's dfreq with it)."""
    g = _param(rng, (n, nout), 1.0).to(cuda)
    bias = _param(rng, (1, nout), 0.1).to(cuda)
    if family == "fourier":
        co = _param(rng, (2, nout, nin, grid_size), 1.0 / np.sqrt(nin * grid_size))
        return (FB.fourierkan, K.fourierkan_forward,
                [_fourier_x(rng, (n, nin)).to(cuda), co.to(cuda), bias], g)
    phase = K.sinekan_phase_init(nin, grid_size).to(cuda)
    freq = (torch.arange(1, grid_size + 1) / (grid_size + 1)).to(cuda)
    amps = _param(rng, (nout, nin, grid_size), 1.0 / nout).to(cuda)
    return (lambda x, f, a, b: FB.sinekan(x, f, phase, a, b),
            lambda x, f, a, b: K.sinekan_forward(x, f, phase, a, b),
            [_sine_x(rng, (n, nin)).to(cuda), freq, amps, bias], g)


@pytest.mark.parametrize("family", ["fourier", "sine"])
@pytest.mark.parametrize("n,nin,nout,grid_size", [
    (97, 13, 200, 5),     # ragged rows, nin not a multiple of 8, two output tiles
    (2000, 100, 70, 7),   # 49 forward stages and 63 dW stages: two-level sums
    (33, 3, 1, 1)])
def test_tc_embedder_kernels(cuda, family, n, nin, nout, grid_size):
    """Forward and every gradient against the plain version, and the
    training step's backward (no dx) against it too, with the
    all-gradients route's bits."""
    rng = np.random.default_rng(71 + nin)
    kernel, plain, inputs, g = _tc_case(family, rng, n, nin, nout, grid_size, cuda)
    y, got = _grads(kernel, inputs, g)
    ref, want = _grads(plain, inputs, g)
    _close(y, ref, 1e-4)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    leaves = [t.detach().clone().requires_grad_(i > 0) for i, t in enumerate(inputs)]
    step = torch.autograd.grad(kernel(*leaves), leaves[1:], g)
    assert all(torch.equal(a, b) for a, b in zip(step, got[1:]))
    name = "fourierkan" if family == "fourier" else "sinekan"
    assert FB.LAUNCHES[name] == 2 and FB.LAUNCHES[f"{name}_bwd"] == 2


@pytest.mark.parametrize("family", ["fourier", "sine"])
def test_tc_embedder_backward_repeats_its_bits(cuda, family):
    """dW and dfreq: no atomics, per-block partials summed in a fixed order."""
    rng = np.random.default_rng(72)
    kernel, _, inputs, g = _tc_case(family, rng, 12544, 96, 48, 28, cuda)
    _, first = _grads(kernel, inputs, g)
    _, second = _grads(kernel, inputs, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_tc_embedder_kernels_raise_not_fall_back(cuda):
    """A grouped weight or a dW grid past 65535 blocks is refused before
    any launch, never computed by the plain version."""
    x = torch.zeros(4, 32, device=cuda)
    with pytest.raises(ValueError, match="one group"):
        FB._launch("fourierkan", "fourier", x, torch.zeros(2, 10, 16, 4, device=cuda), 5)
    with pytest.raises(ValueError, match="one group"):
        FB._launch_sine("sinekan", x, torch.zeros(2, 4, 16, 4, device=cuda),
                        torch.zeros(2, 4, device=cuda), torch.zeros(16, 4, device=cuda))
    nin = FB.TC_DW_FEATURES * 2000 + 1
    x = torch.zeros(2, nin, device=cuda)
    with pytest.raises(ValueError, match="dW kernel's launch grid"):
        FB._launch_bwd("fourierkan_bwd", "fourier", x,
                       torch.zeros(1, 2 * 33, nin, 1, device=cuda), 33,
                       torch.zeros(2, 1, device=cuda), False, True)
    assert sum(FB.LAUNCHES.values()) == 0


# --- head dims 8-128, refit grids, the fused FF and int8 serving --------------

@pytest.fixture
def cuda_all(cuda):
    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.kernels import int8_matmul as IM

    FFN.reset_launches()
    IM.reset_launches()
    return cuda


@pytest.mark.parametrize("dh", [8, 24, 40, 128])
def test_attention_lanes_head_dims(cuda, dh):
    """Every multiple of 8 through 128: forward and backward against the
    plain version, causal and masked."""
    b, t, h = 3, 50, 2
    rng = np.random.default_rng(90 + dh)
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32))
    y = y.to(cuda)
    g = torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.random((b, t)) > 0.3).to(cuda)

    def through(attn):
        def fn(y):
            y4 = y.view(b, t, h, 3 * dh)
            q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
            return attn(q, k, v, h, causal=True, mask=mask)
        return fn

    got, (gy,) = _grads(through(FA.flash_attention_lanes), [y], g)
    want, (wy,) = _grads(through(A.lanes_attention), [y], g)
    _close(got, want, 1e-5)
    _close(gy, wy, 1e-4)
    assert (FA.LAUNCHES["flash_attention_lanes"],
            FA.LAUNCHES["flash_attention_lanes_bwd"]) == (1, 1)


@pytest.mark.parametrize("dh", [8, 40, 128])
def test_flash_attention_head_dims(cuda, dh):
    """The tiled kernels (600 tokens, past one tile) at dh 8, 40 and 128."""
    rng = np.random.default_rng(95 + dh)
    (q, k, v), mask = _flash_inputs(rng, 2, 2, 600, 600, dh, masked=True)
    g = torch.from_numpy(rng.standard_normal((2, 2, 600, dh)).astype(np.float32)).to(cuda)
    fn = lambda *a: FA.flash_attention(*a, True, 512, 1024, mask)  # noqa: E731
    ref = lambda *a: A.flash_attention_reference(*a, True, 512, 1024, mask)[0]  # noqa: E731
    got, gg = _grads(fn, [q, k, v], g)
    want, wg = _grads(ref, [q, k, v], g)
    _close(got, want, 1e-5)
    for a, b in zip(gg, wg):
        _close(a, b, 1e-4)
    assert (FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_dq"],
            FA.LAUNCHES["flash_attention_dkv"]) == (1, 1, 1)


def _spline_params(rng, h, out, dh, cuda):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
            for s in ((h, out, dh), (h, out, dh, 8), (h, out, dh))]


@pytest.mark.parametrize("per_head", [False, True])
def test_bspline_qkv_grouped_dh8_and_per_head_grids(cuda, per_head):
    """nin 8 (the reference's d 64 with 8 heads), with one grid or a moved
    grid a head: forward and backward against the plain version."""
    n, h, dh = 17 * 6, 8, 8
    out = dh if per_head else 3 * dh
    rng = np.random.default_rng(99)
    x = _spline_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    if per_head:
        shift = torch.from_numpy(rng.uniform(-0.3, 0.3, (h, dh, 1)).astype(np.float32))
        grid = grid * torch.from_numpy(rng.uniform(0.8, 1.3, (h, 1, 1)).astype(
            np.float32)).to(cuda) + shift.to(cuda)
    params = _spline_params(rng, h, out, dh, cuda)
    g = torch.from_numpy(rng.standard_normal((n, h * out)).astype(np.float32)).to(cuda)

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(
            x[:, i * dh:(i + 1) * dh], grid[i] if per_head else grid, bw[i], sw[i],
            sc[i]) for i in range(h)], dim=1)

    got, gg = _grads(lambda *a: FB.bspline_qkv_grouped(a[0], grid, *a[1:]),
                     [x, *params], g)
    want, wg = _grads(plain, [x, *params], g)
    _close(got, want, 1e-4)
    for a, b in zip(gg, wg):
        _close(a, b, 1e-4)
    with torch.inference_mode():
        again = FB.bspline_qkv_grouped(x, grid, *params)
        _f64_gate(got, want, plain(*(a.double() for a in (x, *params))))
    assert torch.equal(got, again)
    assert (FB.LAUNCHES["bspline_qkv_grouped"],
            FB.LAUNCHES["bspline_qkv_grouped_bwd"]) == (2, 1)


def _f64_gate(got, plain, exact):
    """The kernel's result no further from f64 than twice the plain f32
    version's, each x max(1, max|exact|)."""
    scale = max(1.0, float(exact.abs().max()))
    k = float((got.double() - exact).abs().max()) / scale
    p = float((plain.double() - exact).abs().max()) / scale
    assert got.isfinite().all() and k <= 2 * p, (k, p)


@pytest.mark.parametrize("n,h,dh,per_head", [(12608, 6, 64, False), (12608, 6, 64, True),
                                             (3200, 8, 8, False), (301, 2, 5, False)])
def test_bspline_qkv_grouped_tc_backward(cuda, n, h, dh, per_head):
    """The tensor-core backward (dx and dW in 3xTF32) at the vit-s q/k/v,
    with a grid a head (one projection, out = dh), at dh 8 and at dh 5,
    whose 15 outputs a head take the 4-byte copies of gy: every gradient
    within 1e-4 x max(1, max|g|) of the plain version and a second backward
    with the same bits; at the first three (chip_smoke.py's shapes) no
    further from f64 than twice the plain version."""
    out = dh if per_head else 3 * dh
    rng = np.random.default_rng(98 + dh)
    x = _spline_x(rng, (n, h * dh)).to(cuda)
    grid = K.make_bspline_grid(dh, device=cuda)
    if per_head:
        grid = grid * torch.from_numpy(rng.uniform(0.8, 1.3, (h, 1, 1)).astype(
            np.float32)).to(cuda) + 0.1
    params = [p * 0.3 for p in _spline_params(rng, h, out, dh, cuda)]
    g = torch.from_numpy(rng.standard_normal((n, h * out)).astype(np.float32)).to(cuda)

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(
            x[:, i * dh:(i + 1) * dh], grid[i] if per_head else grid, bw[i], sw[i],
            sc[i]) for i in range(h)], dim=1)

    def kernel(*a):
        return FB.bspline_qkv_grouped(a[0], grid, *a[1:])

    _, got = _grads(kernel, [x, *params], g)
    _, again = _grads(kernel, [x, *params], g)
    _, want = _grads(plain, [x, *params], g)
    _, exact = _grads(lambda *a: plain(*a).double(), [t.double() for t in (x, *params)],
                      g.double())
    for a, b, c in zip(got, want, exact):
        _close(a, b, 1e-4)
        if dh != 5:
            _f64_gate(a, b, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == 2


def _ffn_inputs(rng, n, d, f, cuda):
    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.1, d ** -0.5, 0.1, f ** -0.5, 0.1)
    out = [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(cuda)
           for s, sc in zip(shapes, scales)]
    out[1] += 1.0  # gamma around 1
    return out


@pytest.mark.parametrize("n,d,f", [(1, 8, 32), (37, 100, 400), (1000, 384, 1536),
                                   (129, 512, 200), (50, 30, 50), (300, 768, 3072),
                                   (200, 1024, 4096), (100, 2048, 256), (37, 520, 40)])
def test_ffn_pre_ln_kernels(cuda_all, n, d, f):
    from kanvit_torch.kernels import fused_ffn as FFN

    rng = np.random.default_rng(100 + d)
    args = _ffn_inputs(rng, n, d, f, cuda_all)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_all)
    # the gradients are held on the kernel's own ReLU pattern: a pre-activation
    # within f32 rounding of 0 may fall on the other side in cuBLAS's h
    mask = torch.empty(n, f, dtype=torch.uint8, device=cuda_all)
    with torch.inference_mode():
        FFN._launch(*args, relu_mask=mask)
    pattern = mask.bool()

    def plain_on_pattern(x, gamma, beta, w1, b1, w2, b2):
        return x + ((K.layernorm(x, gamma, beta) @ w1.T + b1) * pattern) @ w2.T + b2

    got, gg = _grads(FFN.ffn_pre_ln, args, g)
    _, wg = _grads(plain_on_pattern, args, g)
    want = K.ffn_pre_ln(*args)
    _close(got, want, 1e-4)
    for a, b in zip(gg, wg):
        _close(a, b, 1e-4)
    _, again = _grads(FFN.ffn_pre_ln, args, g)
    assert all(torch.equal(a, b) for a, b in zip(gg, again))
    assert FFN.LAUNCHES == {"ffn_pre_ln": 3, "ffn_pre_ln_bwd": 2, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}


def test_ffn_pre_ln_vit_s_holds_f64_and_repeats_bits(cuda_all):
    """At vit-s widths the 3xTF32 forward is within 1e-6 x max(1, max|y|) of
    f64 on the card (plain 1xTF32 would be ~2e-4 off), and two backwards
    give the same bits."""
    from kanvit_torch.kernels import fused_ffn as FFN

    rng = np.random.default_rng(120)
    args = _ffn_inputs(rng, 12 * 197, 384, 1536, cuda_all)
    g = torch.from_numpy(rng.standard_normal((12 * 197, 384)).astype(np.float32))
    g = g.to(cuda_all)
    with torch.inference_mode():
        y = FFN.ffn_pre_ln(*args)
        exact = K.ffn_pre_ln(*(a.double() for a in args))
    err = float((y.double() - exact).abs().max())
    assert err <= 1e-6 * max(1.0, float(exact.abs().max())), err
    _, first = _grads(FFN.ffn_pre_ln, args, g)
    _, second = _grads(FFN.ffn_pre_ln, args, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert FFN.LAUNCHES == {"ffn_pre_ln": 3, "ffn_pre_ln_bwd": 2, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}


def test_ffn_pre_ln_wide_holds_f64_and_repeats_bits(cuda_all):
    """Past D 512 (vit-b's D 768, F 3,072) the tiled route's forward is
    within 1e-6 x max(1, max|y|) of f64 on the card, and two backwards give
    the same bits."""
    from kanvit_torch.kernels import fused_ffn as FFN

    rng = np.random.default_rng(122)
    n, d, f = 12 * 197, 768, 3072
    args = _ffn_inputs(rng, n, d, f, cuda_all)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_all)
    with torch.inference_mode():
        y = FFN.ffn_pre_ln(*args)
        exact = K.ffn_pre_ln(*(a.double() for a in args))
    err = float((y.double() - exact).abs().max())
    assert err <= 1e-6 * max(1.0, float(exact.abs().max())), err
    _, first = _grads(FFN.ffn_pre_ln, args, g)
    _, second = _grads(FFN.ffn_pre_ln, args, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert FFN.LAUNCHES == {"ffn_pre_ln": 3, "ffn_pre_ln_bwd": 2, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}


def test_ffn_pre_ln_unaligned_inputs_run(cuda_all):
    """Inputs whose rows start off 16 bytes (views one float into their
    storage) are copied by the wrapper, not refused, and give the aligned
    inputs' values and gradients."""
    from kanvit_torch.kernels import fused_ffn as FFN

    rng = np.random.default_rng(121)
    n, d, f = 37, 64, 96
    args = _ffn_inputs(rng, n, d, f, cuda_all)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_all)

    def off16(t):
        flat = torch.zeros(t.numel() + 1, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    shifted = [off16(t).requires_grad_(True) for t in args]
    got = FFN.ffn_pre_ln(*shifted)
    gg = torch.autograd.grad(got, shifted, off16(g))
    want, wg = _grads(FFN.ffn_pre_ln, args, g)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(gg, wg))
    assert FFN.LAUNCHES == {"ffn_pre_ln": 2, "ffn_pre_ln_bwd": 2, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}


def test_ffn_pre_ln_raises_not_fall_back(cuda_all):
    from kanvit_torch.kernels import fused_ffn as FFN

    args = _ffn_inputs(np.random.default_rng(7), 4, 640, 1, cuda_all)
    # no hidden unit: every D is taken, F must be at least 1
    args[3], args[4], args[5] = args[3][:0], args[4][:0], args[5][:, :0].contiguous()
    with pytest.raises(ValueError, match="D 640"):
        FFN.ffn_pre_ln(*args)
    with pytest.raises(TypeError, match="float32"):
        FFN.ffn_pre_ln(args[0].double(), *args[1:])
    assert FFN.LAUNCHES["ffn_pre_ln"] == 0


# (n, K, out): K across the kernel's rows-a-block rule (48 rows up to K
# 3,968, 32 up to 6,016, 16 past it to MAX_K), N 1, 33 (a partial row
# tile) and the vit-s tokens
INT8_SHAPES = [(1, 128, 128), (37, 256, 384), (300, 384, 1536), (129, 1536, 384),
               (1, 768, 384), (33, 768, 384), (12608, 384, 1536), (12608, 1536, 384),
               (12544, 768, 384), (33, 3072, 768), (1, 3072, 256), (12608, 3072, 768),
               (33, 3968, 384), (33, 4096, 256), (1, 6016, 128), (33, 6144, 128),
               (33, IM.MAX_K, 256), (1, IM.MAX_K, 128), (12608, IM.MAX_K, 128)]


def _int8_case(rng, n, k, out, with_bias, cuda):
    x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((out, k)) * 0.05).astype(np.float32)).to(cuda)
    b = (torch.from_numpy(rng.standard_normal(out).astype(np.float32)).to(cuda)
         if with_bias else None)
    return x, w, b


@pytest.mark.parametrize("n,k,out", INT8_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_linear_kernel(cuda_all, n, k, out, with_bias):
    """The kernel's bits are ``qdot_rowwise``'s: the same q(x) and q(W), an
    exact int32 sum, the same rounded epilogue."""
    from kanvit_torch.ops import quant as Q

    rng = np.random.default_rng(110 + k)
    x, w, b = _int8_case(rng, n, k, out, with_bias, cuda_all)
    with torch.inference_mode():
        y = IM.int8_linear(x, w, b)
        want = Q.qdot_rowwise(x, w, b)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (n, out)
    assert torch.equal(y, want), int((y != want).sum())
    assert IM.LAUNCHES["int8_linear"] == 1


@pytest.mark.parametrize("pad,offset", [(4, 0), (3, 0), (0, 1), (5, 3)])
def test_int8_linear_kernel_strided_x(cuda_all, pad, offset):
    """x a column window of a wider tensor: rows 16-byte aligned (16-byte
    loads) or not (4-byte loads), the same bits as ``qdot_rowwise``."""
    from kanvit_torch.ops import quant as Q

    rng = np.random.default_rng(140 + pad + offset)
    n, k, out = 333, 768, 384
    wide, w, b = _int8_case(rng, n, k + pad + offset, out, True, cuda_all)
    x = wide[:, offset:offset + k]
    w = w[:, :k].contiguous()
    assert x.stride(0) == k + pad + offset
    with torch.inference_mode():
        y = IM.int8_linear(x, w, b)
        want = Q.qdot_rowwise(x.contiguous(), w, b)
    torch.cuda.synchronize()
    assert torch.equal(y, want), int((y != want).sum())
    assert IM.LAUNCHES["int8_linear"] == 1


@pytest.mark.parametrize("n,k,out", [(1, 128, 128), (37 * 50 + 1, 256, 128),
                                     (12608, 768, 3072), (33, IM.MAX_K, 256)])
@pytest.mark.parametrize("pad", [0, 3, 4])
def test_int8_linear_bf16_kernel(cuda_all, n, k, out, pad):
    """bf16 x, W and bias (x rows ``pad`` values wider: 8-byte loads at 0
    and 4, single values at 3): bf16 y with the bits of ``qdot_rowwise``
    rounded once to bf16, counted under ``int8_linear_bf16``."""
    from kanvit_torch.ops import quant as Q

    rng = np.random.default_rng(150 + pad)
    wide, w, b = (t.to(torch.bfloat16) if t is not None else None
                  for t in _int8_case(rng, n, k + pad, out, True, cuda_all))
    x, w = wide[:, :k], w[:, :k].contiguous()
    IM.reset_launches()
    with torch.inference_mode():
        y = IM.int8_linear(x, w, b)
        want = Q.qdot_rowwise(x, w, b).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (n, out)
    assert torch.equal(y, want), int((y != want).sum())
    assert IM.LAUNCHES == {"int8_linear": 0, "int8_linear_bf16": 1}
    with pytest.raises(TypeError, match="as x is"):
        IM.int8_linear(x, w.float(), b)


def test_int8_predictor_on_card(cuda_all):
    """A vanilla ViT whose Linears are multiples of 128 serves int8 with the
    kernel (embedder, 2 FF pairs: 5 launches a batch; the 10-class head on
    qdot), calibrated and without the kernel, near its f32 logits and the
    CPU's int8 logits."""
    import copy

    from kanvit_torch.infer import Predictor
    from kanvit_torch.kernels import int8_matmul as IM
    from kanvit_torch.models import create_model

    cpu = create_model("vanilla", chw=(2, 32, 32), n_patches=4, n_blocks=2,
                       d_hidden=128, n_heads=4, out_d=10, seed=5)
    gpu = copy.deepcopy(cpu).to(cuda_all)
    x = np.random.default_rng(111).standard_normal((20, 2, 32, 32)).astype(np.float32)
    f32 = Predictor(gpu, batch_size=8, device=cuda_all).logits(x)
    scale = float(np.abs(f32).max())
    for kernel in (True, False):
        pred = Predictor(gpu, batch_size=8, device=cuda_all, quant="int8",
                         int8_kernel=kernel)
        ref = Predictor(cpu, batch_size=8, device="cpu", quant="int8",
                        int8_kernel=kernel)
        IM.reset_launches()
        got = pred.logits(x)
        assert IM.LAUNCHES["int8_linear"] == (3 * 5 if kernel else 0)
        assert float(np.abs(got - ref.logits(x)).max()) <= 0.02 * scale
        assert float(np.abs(got - f32).max()) <= 0.05 * scale
        assert pred.calibrate(x).keys() == ref.calibrate(x).keys()
        assert float(np.abs(pred.logits(x) - f32).max()) <= 0.05 * scale


def test_int8_bf16_predictor_on_card(cuda_all):
    """The same ViT with bf16 parameters: with the kernel its stream stays
    bf16 (5 bf16 launches a batch), on qdot it turns f32; both near the
    bf16 float logits and the CPU's int8 logits of the bf16 model."""
    import copy

    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import create_model
    from kanvit_torch.utils import precision

    cpu = precision.cast_params_(create_model(
        "vanilla", chw=(2, 32, 32), n_patches=4, n_blocks=2, d_hidden=128, n_heads=4,
        out_d=10, seed=5))
    gpu = copy.deepcopy(cpu).to(cuda_all)
    x = np.random.default_rng(112).standard_normal((20, 2, 32, 32)).astype(np.float32)
    ref = Predictor(gpu, batch_size=8, device=cuda_all).logits(x)
    scale = max(1.0, float(np.abs(ref).max()))
    for kernel in (True, False):
        IM.reset_launches()
        got = Predictor(gpu, batch_size=8, device=cuda_all, quant="int8",
                        int8_kernel=kernel).logits(x)
        assert IM.LAUNCHES == {"int8_linear": 0, "int8_linear_bf16": 3 * 5 if kernel else 0}
        cpu_int8 = Predictor(cpu, batch_size=8, device="cpu", quant="int8",
                             int8_kernel=kernel).logits(x)
        assert got.dtype == np.float32
        assert float(np.abs(got - cpu_int8).max()) <= 0.02 * scale
        assert float(np.abs(got - ref).max()) <= 0.05 * scale


def test_fused_ff_train_step_on_card(cuda_all):
    """Two Adam steps with the fused FF at the reference geometry (d 64, 8
    heads: dh 8), on the card against the CPU."""
    from kanvit_torch.kernels import fused_ffn as FFN

    _train_against_cpu(cuda_all, "efficientkan", fused_ff=True)
    assert FFN.LAUNCHES == {"ffn_pre_ln": 4, "ffn_pre_ln_bwd": 4, "ffn_pre_ln_bf16": 0,
                            "ffn_pre_ln_bwd_bf16": 0}
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 4


@pytest.mark.parametrize("variant", ["efficientkan", "vanilla"])
def test_cifar_geometry_train_step_on_card(cuda, variant):
    """The CIFAR geometry (32x32, 4x4 patches, d 64, 8 heads of 8, 17
    tokens): the lanes and grouped KAN kernels at dh 8."""
    _train_against_cpu(cuda, variant)
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 4
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == (4 if variant == "efficientkan"
                                                      else 0)


def _train_against_cpu(cuda, variant, **kw):
    import copy

    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    cpu = create_model(variant, chw=(3, 32, 32), n_patches=4, n_blocks=2,
                       d_hidden=64, n_heads=8, out_d=100, seed=6, **kw)
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(112)
    x = torch.from_numpy(rng.standard_normal((6, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 100, 6))
    step = make_train_step()
    sc, sg = create_train_state(cpu), create_train_state(gpu)
    for _ in range(2):
        sc, lc, _ = step(sc, x, y)
        sg, lg, _ = step(sg, x.to(cuda), y.to(cuda))
        assert abs(float(lc) - float(lg)) <= 1e-4
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        # a key projection's bias has a gradient of exactly 0 (the softmax
        # cancels it) and rounding noise on either side, which Adam turns
        # into steps of up to lr each
        tol = 2 * 2 * 1e-3 if re.search(r"k_mappings\.\d+\.bias", name) else 1e-4
        assert float((pc - pg.cpu()).detach().abs().max()) <= tol, name


def test_load_predictor_default_geometry_on_card(cuda, tmp_path):
    """``load_predictor``'s defaults (MNIST, d 64, 8 heads of 8, 8 blocks,
    device cuda) serve a request."""
    from kanvit_torch.infer import load_predictor
    from kanvit_torch.models import create_model

    src = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, out_d=10, seed=7)
    path = tmp_path / "sd.npz"
    np.savez(path, **{k: v.numpy() for k, v in src.state_dict().items()})
    pred = load_predictor("efficientkan", str(path))
    x = np.random.default_rng(113).standard_normal((5, 1, 28, 28)).astype(np.float32)
    with torch.inference_mode():
        want = src(torch.from_numpy(x)).numpy()
    assert float(np.abs(pred.logits(x) - want).max()) <= 1e-3
    assert FA.LAUNCHES["flash_attention_lanes"] == 8


def test_refit_grid_model_on_card(cuda):
    """An efficientkan model with a moved grid per head: three grouped
    launches a block (one per projection), logits as on the CPU."""
    import copy

    from kanvit_torch.models import create_model

    cpu = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, n_blocks=2,
                       d_hidden=64, n_heads=2, out_d=10, seed=8)
    rng = np.random.default_rng(114)
    with torch.no_grad():
        for name, mod in cpu.named_modules():
            if hasattr(mod, "grid") and "attn" in name:
                mod.grid.mul_(float(rng.uniform(0.8, 1.3))).add_(float(rng.uniform(-.3, .3)))
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(rng.standard_normal((5, 1, 28, 28)).astype(np.float32))
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3
    assert FB.LAUNCHES["bspline_qkv_grouped"] == 6


# (n, nin, nout, large): the vit-s embedder, with a third of x at |x| 20-60
# too, and one vit-s image (its forward's 8 levels in blocks of their own);
# the reference preset's and chip_smoke.py's MNIST embedders; ragged rows,
# features and outputs (a 192-output tile, 13 stages: past one level of the
# forward's sum, in 2 splits)
BSPLINE_EMBEDDER_SHAPES = [(12544, 768, 384, False), (12544, 768, 384, True),
                           (196, 768, 384, False), (128 * 49, 16, 64, False),
                           (37 * 49, 16, 64, False), (300, 100, 70, False)]


def _bspline_embedder(rng, n, nin, nout, large, cuda):
    """x (on and beyond the knots; ``large``: a third at |x| 20-60), the
    grid, KANLinear-scaled (base, spline, scaler) and the packed weight."""
    x = _spline_x(rng, (n, nin))
    if large:
        flat = x.view(-1)
        idx = torch.from_numpy(rng.choice(flat.numel(), flat.numel() // 3, replace=False))
        flat[idx] = torch.from_numpy((rng.uniform(20.0, 60.0, idx.numel())
                                      * rng.choice([-1.0, 1.0], idx.numel())).astype(np.float32))
    params = [_param(rng, (nout, nin), 1 / np.sqrt(nin)), _param(rng, (nout, nin, 8), 0.1),
              _param(rng, (nout, nin), 1 / np.sqrt(nin))]
    params = [p.to(cuda) for p in params]
    return (x.to(cuda), K.make_bspline_grid(nin, device=cuda), params,
            FB.pack_weight(*params).unsqueeze(0).contiguous())


def _packed_plain(x, grid, w):
    """The plain B-spline forward over the packed weight (1, 9, nin, out)."""
    return K.bspline_kan_forward(x, grid.to(x.dtype), w[0, -1].T, w[0, :-1].permute(2, 1, 0),
                                 None)


@pytest.mark.parametrize("n,nin,nout,large", BSPLINE_EMBEDDER_SHAPES)
def test_bspline_kan_tc_forward(cuda, monkeypatch, n, nin, nout, large):
    """The embedder's forward on the tensor cores (3xTF32, its sum in two
    levels) at every size: within 1e-4 x max(1, max|y|) of the plain
    version, no further from f64 than twice the plain f32 version, a second
    forward with the same bits; the tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_bspline_kan_tc_fwd", "kanvit_bspline_kan_fwd"))
    rng = np.random.default_rng(80 + nin)
    x, grid, params, _ = _bspline_embedder(rng, n, nin, nout, large, cuda)
    with torch.inference_mode():
        y = FB.bspline_kan(x, grid, *params)
        again = FB.bspline_kan(x, grid, *params)
        want = K.bspline_kan_forward(x, grid, *params)
        exact = K.bspline_kan_forward(x.double(), grid.double(), *(p.double() for p in params))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert called == ["kanvit_bspline_kan_tc_fwd"] * 2
    assert FB.LAUNCHES["bspline_kan"] == 2


def test_bspline_kan_tc_forward_rows_keep_their_bits_at_any_batch(cuda):
    """One vit-s image runs the forward's levels in blocks of their own and
    sums them in level order, as a batch of 64 sums them in its blocks: the
    image's rows have the bits they have in the batch."""
    rng = np.random.default_rng(87)
    x, grid, params, _ = _bspline_embedder(rng, 12544, 768, 384, False, cuda)
    with torch.inference_mode():
        batch = FB.bspline_kan(x, grid, *params)
        for lo, hi in ((0, 196), (196 * 7, 196 * 8), (12544 - 196, 12544)):
            assert torch.equal(FB.bspline_kan(x[lo:hi], grid, *params), batch[lo:hi])


@pytest.mark.parametrize("n,nin,nout,large", BSPLINE_EMBEDDER_SHAPES)
def test_bspline_kan_tc_backward(cuda, monkeypatch, n, nin, nout, large):
    """The embedder's backward on the tensor cores (the grouped templates at
    one group): every gradient through the wrapper within 1e-4 x max(1,
    max|g|) of the plain version; the kernels' dW and dx no further from
    f64 than twice the plain f32 version's; the training step's call (no
    dx) with the all-gradients call's dW bits, and a second backward
    repeating them; the tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_bspline_qkv_tc_bwd", "kanvit_bspline_kan_bwd"))
    rng = np.random.default_rng(90 + nin)
    x, grid, params, w = _bspline_embedder(rng, n, nin, nout, large, cuda)
    g = _param(rng, (n, nout), 1.0).to(cuda)
    _, got = _grads(lambda *a: FB.bspline_kan(a[0], grid, *a[1:]), [x, *params], g)
    _, want = _grads(lambda *a: K.bspline_kan_forward(a[0], grid, *a[1:]), [x, *params], g)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    with torch.inference_mode():
        dx, dw = FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, g, True, True)
        no_dx = FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, g, False, True)
        again = FB._launch_bwd("bspline_kan_bwd", "bspline", x, w, grid, g, True, True)
    _, plain = _grads(lambda *a: _packed_plain(a[0], grid, a[1]), [x, w], g)
    _, exact = _grads(lambda *a: _packed_plain(a[0], grid, a[1]), [x.double(), w.double()],
                      g.double())
    for a, b, c in zip((dx, dw), plain, exact):
        _close(a, b, 1e-4)
        _f64_gate(a, b, c)
    assert no_dx[0] is None and torch.equal(no_dx[1], dw)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    assert called == ["kanvit_bspline_qkv_tc_bwd"] * 4
    assert FB.LAUNCHES["bspline_kan_bwd"] == 4


def test_bspline_kan_tc_raises_not_falls_back(cuda, monkeypatch):
    """A failing tensor-core entry of the embedder (here: one that returns a
    CUDA error) makes the wrapper raise, forward and backward; the
    CUDA-core entries are never called and nothing is counted."""
    from kanvit_torch.kernels import _build

    lib = _build.load()
    called = _recording(monkeypatch, ("kanvit_bspline_kan_fwd", "kanvit_bspline_kan_bwd"))
    rng = np.random.default_rng(95)
    x, grid, params, _ = _bspline_embedder(rng, 50, 16, 24, False, cuda)
    monkeypatch.setattr(lib, "kanvit_bspline_qkv_tc_bwd", lambda *args: 98)
    leaves = [p.clone().requires_grad_(True) for p in params]
    y = FB.bspline_kan(x, grid, *leaves)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        y.sum().backward()
    monkeypatch.setattr(lib, "kanvit_bspline_kan_tc_fwd", lambda *args: 98)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 98"):
        FB.bspline_kan(x, grid, *params)
    assert called == []
    assert (FB.LAUNCHES["bspline_kan"], FB.LAUNCHES["bspline_kan_bwd"]) == (1, 0)


# --- the FastKAN embedder's forward and the Chebyshev embedder's backward -----

# (n, nin, nout, ln, base, large): the vit-s embedder (also with a third of x
# at |x| 20-60, and without the LayerNorm or the base branch), one vit-s
# image (its forward's 8 levels in blocks of their own); the reference
# preset's and chip_smoke.py's MNIST embedders; ragged rows, features and
# outputs (13 stages: past one level of the forward's sum, in 2 splits)
FASTKAN_EMBEDDER_SHAPES = [(12544, 768, 384, True, True, False),
                           (12544, 768, 384, True, True, True),
                           (12544, 768, 384, False, True, False),
                           (12544, 768, 384, True, False, False),
                           (196, 768, 384, True, True, False),
                           (128 * 49, 16, 64, True, True, False),
                           (37 * 49, 16, 64, True, True, False),
                           (300, 100, 70, True, True, True)]


def _fastkan_embedder(rng, n, nin, nout, ln, base, large, cuda):
    """x (``large``: a third at |x| 20-60), the layer's (gamma, beta, spline,
    base, bias) with None where it has no LayerNorm or base branch, and the
    plain version over them."""
    x = _fast_x(rng, (n, nin))
    if large:
        flat = x.view(-1)
        idx = torch.from_numpy(rng.choice(flat.numel(), flat.numel() // 3, replace=False))
        flat[idx] = torch.from_numpy((rng.uniform(20.0, 60.0, idx.numel())
                                      * rng.choice([-1.0, 1.0], idx.numel())).astype(np.float32))
    ga, be, sw, bw, bb = [p.to(cuda) for p in _fast_params(rng, nout, nin)]
    params = [ga if ln else None, be if ln else None, sw / np.sqrt(nin * 8.0) * 10,
              bw / np.sqrt(nin) * 3 if base else None, bb if base else None]
    grid = RBF_GRID.to(cuda)

    def plain(x, ga, be, sw, bw, bb):
        return K.fastkan_forward(x, ga, be, grid.to(x.dtype), 4 / 7, sw, bw, bb)

    return x.to(cuda), params, grid, plain


def _f64(params):
    return [None if p is None else p.double() for p in params]


@pytest.mark.parametrize("n,nin,nout,ln,base,large", FASTKAN_EMBEDDER_SHAPES)
def test_fastkan_tc_forward(cuda, monkeypatch, n, nin, nout, ln, base, large):
    """The embedder's forward on the tensor cores (the LayerNorm's
    statistics, then 3xTF32, its sum in two levels) at every size: within
    1e-4 x max(1, max|y|) of the plain version, no further from f64 than
    twice the plain f32 version, a second forward with the same bits; the
    tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_fastkan_kan_tc_fwd", "kanvit_fastkan_fwd"))
    rng = np.random.default_rng(100 + nin + 2 * ln + base)
    x, params, grid, plain = _fastkan_embedder(rng, n, nin, nout, ln, base, large, cuda)
    with torch.inference_mode():
        y = FB.fastkan(x, *params[:2], grid, 4 / 7, *params[2:])
        again = FB.fastkan(x, *params[:2], grid, 4 / 7, *params[2:])
        want = plain(x, *params)
        exact = plain(x.double(), *_f64(params))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert called == ["kanvit_fastkan_kan_tc_fwd"] * 2
    assert FB.LAUNCHES["fastkan"] == 2


def test_fastkan_tc_forward_rows_keep_their_bits_at_any_batch(cuda):
    """One vit-s image runs the forward's levels in blocks of their own and
    sums them in level order, as a batch of 64 sums them in its blocks: the
    image's rows have the bits they have in the batch."""
    rng = np.random.default_rng(107)
    x, params, grid, _ = _fastkan_embedder(rng, 12544, 768, 384, True, True, True, cuda)
    with torch.inference_mode():
        batch = FB.fastkan(x, *params[:2], grid, 4 / 7, *params[2:])
        for lo, hi in ((0, 196), (196 * 7, 196 * 8), (12544 - 196, 12544)):
            alone = FB.fastkan(x[lo:hi], *params[:2], grid, 4 / 7, *params[2:])
            assert torch.equal(alone, batch[lo:hi])


# (n, nin, nout, saturated share): the vit-s embedder (11 row splits), one
# vit-s image, the MNIST embedders, ragged rows, features and outputs
CHEBY_EMBEDDER_SHAPES = [(12544, 768, 384, 0.1), (12544, 768, 384, 0.3), (196, 768, 384, 0.1),
                         (128 * 49, 16, 64, 0.1), (37 * 49, 16, 64, 0.2), (300, 100, 70, 0.1)]


@pytest.mark.parametrize("n,nin,nout,saturated", CHEBY_EMBEDDER_SHAPES)
def test_chebykan_tc_backward(cuda, monkeypatch, n, nin, nout, saturated):
    """The embedder's backward on the tensor cores (the grouped templates at
    one group), a share of x where tanh rounds to +-1: every gradient
    through the wrapper within 1e-4 x max(1, max|g|) of the plain version
    and finite; the kernels' dW and dx no further from f64 than twice the
    plain f32 version's; the training step's call (no dx) with the
    all-gradients call's dW bits, and a second backward repeating them; the
    tensor-core entry the one called."""
    called = _recording(monkeypatch, ("kanvit_cheby_qkv_tc_bwd", "kanvit_chebykan_bwd"))
    rng = np.random.default_rng(110 + nin)
    x = _cheby_x(rng, (n, nin), saturated).to(cuda)
    cc = _param(rng, (nin, nout, 5), 1.0 / np.sqrt(5 * nin)).to(cuda)
    g = _param(rng, (n, nout), 1.0).to(cuda)
    _, got = _grads(FB.chebykan, [x, cc], g)
    _, want = _grads(K.chebykan_forward, [x, cc], g)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    w = FB.pack_cheby_weight(cc).contiguous()
    with torch.inference_mode():
        dx, dw = FB._launch_bwd("chebykan_bwd", "cheby", x, w, 4, g, True, True)
        no_dx = FB._launch_bwd("chebykan_bwd", "cheby", x, w, 4, g, False, True)
        again = FB._launch_bwd("chebykan_bwd", "cheby", x, w, 4, g, True, True)

    def packed(x, w):
        return K.chebykan_forward(x, w[0].permute(1, 2, 0))

    _, plain = _grads(packed, [x, w], g)
    _, exact = _grads(packed, [x.double(), w.double()], g.double())
    for a, b, c in zip((dx, dw), plain, exact):
        _close(a, b, 1e-4)
        _f64_gate(a, b, c)
    assert no_dx[0] is None and torch.equal(no_dx[1], dw)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    assert called == ["kanvit_cheby_qkv_tc_bwd"] * 4
    assert FB.LAUNCHES["chebykan_bwd"] == 4


# (n, nin, nout, saturated share): the vit-s embedder without saturated x and
# with a tenth and three tenths, one vit-s image (its 8 levels in blocks of
# their own), the MNIST embedders, ragged rows, features and outputs (13
# stages: past one level, in 2 splits), all of x saturated
CHEBY_FWD_SHAPES = [(12544, 768, 384, 0.0), *CHEBY_EMBEDDER_SHAPES, (301, 100, 70, 1.0)]


@pytest.mark.parametrize("n,nin,nout,saturated", CHEBY_FWD_SHAPES)
def test_chebykan_tc_forward(cuda, monkeypatch, n, nin, nout, saturated):
    """The embedder's forward on the tensor cores (3xTF32, its sum in two
    levels) at every size, a share of x where tanh rounds to +-1: within
    1e-4 x max(1, max|y|) of the plain version and of the CUDA-core kernel
    it replaced, no further from f64 than twice the plain f32 version, a
    second forward with the same bits; the tensor-core entry the one
    called."""
    called = _recording(monkeypatch, ("kanvit_chebykan_tc_fwd", "kanvit_chebykan_fwd"))
    rng = np.random.default_rng(130 + nin)
    x = _cheby_x(rng, (n, nin), saturated).to(cuda)
    cc = _param(rng, (nin, nout, 5), 1.0 / np.sqrt(5 * nin)).to(cuda)
    with torch.inference_mode():
        y = FB.chebykan(x, cc)
        again = FB.chebykan(x, cc)
        want = K.chebykan_forward(x, cc)
        exact = K.chebykan_forward(x.double(), cc.double())
        monkeypatch.setattr(FB, "TC_GROUPED_FWD", ())
        cores = FB.chebykan(x, cc)
    _close(y, want, 1e-4)
    _close(y, cores, 1e-4)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert called == ["kanvit_chebykan_tc_fwd"] * 2 + ["kanvit_chebykan_fwd"]
    assert FB.LAUNCHES["chebykan"] == 3


def test_chebykan_tc_forward_rows_keep_their_bits_at_any_batch(cuda):
    """One vit-s image (and 37 of them) runs the forward's levels in blocks
    of their own and sums them in level order, as a batch of 64 sums them in
    its blocks: the images' rows have the bits they have in the batch."""
    rng = np.random.default_rng(137)
    x = _cheby_x(rng, (12544, 768), 0.1).to(cuda)
    cc = _param(rng, (768, 384, 5), 1.0 / np.sqrt(5 * 768)).to(cuda)
    with torch.inference_mode():
        batch = FB.chebykan(x, cc)
        for lo, hi in ((0, 196), (196 * 7, 196 * 8), (12544 - 196, 12544), (0, 196 * 37)):
            assert torch.equal(FB.chebykan(x[lo:hi], cc), batch[lo:hi])


def test_chebykan_tc_forward_raises_not_falls_back(cuda, monkeypatch):
    """A failing tensor-core forward entry (here: one that returns a CUDA
    error) makes the wrapper raise; the CUDA-core entry is never called and
    nothing is counted."""
    from kanvit_torch.kernels import _build

    lib = _build.load()
    called = _recording(monkeypatch, ("kanvit_chebykan_fwd",))
    rng = np.random.default_rng(138)
    x = _cheby_x(rng, (50, 16)).to(cuda)
    cc = _param(rng, (16, 24, 5), 0.1).to(cuda)
    monkeypatch.setattr(lib, "kanvit_chebykan_tc_fwd", lambda *args: 96)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 96"):
        FB.chebykan(x, cc)
    assert called == [] and FB.LAUNCHES["chebykan"] == 0


def test_fastkan_fwd_and_chebykan_bwd_raise_not_fall_back(cuda, monkeypatch):
    """A failing tensor-core entry (here: one that returns a CUDA error)
    makes the FastKAN embedder's forward and the Chebyshev embedder's
    backward raise; the CUDA-core entries are never called and nothing is
    counted for the failed launches."""
    from kanvit_torch.kernels import _build

    lib = _build.load()
    called = _recording(monkeypatch, ("kanvit_fastkan_fwd", "kanvit_chebykan_bwd"))
    rng = np.random.default_rng(115)
    x, params, grid, _ = _fastkan_embedder(rng, 50, 16, 24, True, True, False, cuda)
    monkeypatch.setattr(lib, "kanvit_fastkan_kan_tc_fwd", lambda *args: 97)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 97"):
        FB.fastkan(x, *params[:2], grid, 4 / 7, *params[2:])
    xc = _cheby_x(rng, (50, 16)).to(cuda)
    cc = _param(rng, (16, 24, 5), 0.1).to(cuda).requires_grad_(True)
    y = FB.chebykan(xc, cc)
    monkeypatch.setattr(lib, "kanvit_cheby_qkv_tc_bwd", lambda *args: 97)
    with pytest.raises(RuntimeError, match="CUDA error 97"):
        y.sum().backward()
    assert called == []
    assert (FB.LAUNCHES["fastkan"], FB.LAUNCHES["chebykan"],
            FB.LAUNCHES["chebykan_bwd"]) == (0, 1, 0)


@pytest.mark.parametrize("nout", [70, 192])
def test_fastkan_qkv_grouped_tc_forward_past_64_outputs(cuda, nout):
    """The grouped RBF forward takes 64-output blocks at every width (192
    outputs a block would not fit two stages in shared memory): two heads
    of 32 features to ``nout`` outputs each, within 1e-4 x max(1, max|y|)
    of the plain version and no further from f64 than twice it."""
    rng = np.random.default_rng(120 + nout)
    h, dh, n = 2, 32, 37 * 50
    x = _fast_x(rng, (n, h * dh)).to(cuda)
    ga, be, sw, bw, bb = [p.to(cuda) for p in _fast_params(rng, nout, dh, (h,))]
    grid = RBF_GRID.to(cuda)

    def plain(x, ga, be, sw, bw, bb):
        return torch.cat([K.fastkan_forward(x[:, i * dh:(i + 1) * dh], ga[i], be[i],
                                            grid.to(x.dtype), 4 / 7, sw[i], bw[i], bb[i])
                          for i in range(h)], dim=1)

    with torch.inference_mode():
        y = FB.fastkan_qkv_grouped(x, ga, be, grid, 4 / 7, sw, bw, bb)
        want = plain(x, ga, be, sw, bw, bb)
        exact = plain(*(a.double() for a in (x, ga, be, sw, bw, bb)))
    _close(y, want, 1e-4)
    _f64_gate(y, want, exact)
    assert FB.LAUNCHES["fastkan_qkv_grouped"] == 1


# --- bf16 serving: the bf16 forwards of bspline_kan, bspline_qkv_grouped and
# the lanes attention against their plain twins (kanvit's bf16 policy),
# elementwise within one bf16 ulp (|a - b| <= 2^-7 |b| + 2^-12 max|b|), and
# no further than twice the twin from the f64 sum of the same rounded
# operands.

BF16 = torch.bfloat16


def _bf16_ulp(got, want, spread=None, mid=2.0 ** -8):
    """One bf16 ulp of the output; ``spread`` (the attention): plus ``mid``
    (one ulp; the tiled forward 2^-7, two-sided) of every probability,
    weighted as P V weights it (chip_smoke.py's gate)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF16
    got, want = got.double(), want.double()
    bound = 2.0 ** -7 * want.abs() + 2.0 ** -12 * float(want.abs().max())
    if spread is not None:
        bound = bound + mid * spread.double()
    assert got.isfinite().all() and bool(((got - want).abs() <= bound).all()), float(
        ((got - want).abs() - bound).max())


@pytest.mark.parametrize("n,nin,nout", [(37 * 49, 16, 64), (300, 100, 70),
                                        (64 * 196, 768, 384)])
def test_bspline_kan_bf16_kernel(cuda, n, nin, nout):
    rng = np.random.default_rng(130)
    x = _spline_x(rng, (n, nin)).to(cuda).to(BF16)
    grid = K.make_bspline_grid(nin, device=cuda)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
                  .to(cuda).to(BF16) for s in ((nout, nin), (nout, nin, 8), (nout, nin)))
    with torch.inference_mode():
        y = FB.bspline_kan(x, grid, bw, sw, sc)
        again = FB.bspline_kan(x, grid, bw, sw, sc)
        twin = K.bspline_kan_forward(x, grid, bw, sw, sc)
        exact = K.bspline_kan_forward_bf16(x, grid, bw, sw, sc, exact=True)
    _bf16_ulp(y, twin)
    _f64_gate(y, twin, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES["bspline_kan_bf16"] == 2 and FB.LAUNCHES["bspline_kan"] == 0


@pytest.mark.parametrize("n,h,dh,per_head", [(37 * 50, 2, 32, False), (64 * 50, 8, 8, False),
                                             (64 * 197, 6, 64, False),
                                             (64 * 197, 6, 64, True)])
def test_bspline_qkv_grouped_bf16_kernel(cuda, n, h, dh, per_head):
    """The shared grid at q|k|v width, and a grid a head at one projection's."""
    rng = np.random.default_rng(131)
    x = _spline_x(rng, (n, h * dh)).to(cuda).to(BF16)
    grid = K.make_bspline_grid(dh, device=cuda)
    out = dh if per_head else 3 * dh
    if per_head:
        grid = torch.stack([grid * (1 + 0.05 * i) + 0.01 * i for i in range(h)])
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
                  .to(cuda).to(BF16) for s in ((h, out, dh), (h, out, dh, 8), (h, out, dh)))

    def twin(exact=False):
        return torch.cat([K.bspline_kan_forward_bf16(
            x[:, i * dh:(i + 1) * dh], grid[i] if per_head else grid, bw[i], sw[i], sc[i],
            exact=exact) for i in range(h)], dim=1)

    with torch.inference_mode():
        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        again = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        want, exact = twin(), twin(exact=True)
    _bf16_ulp(y, want)
    _f64_gate(y, want, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES["bspline_qkv_grouped_bf16"] == 2


@pytest.mark.parametrize("dh", [8, 16, 32, 64, 24, 40, 72, 96, 128])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_attention_lanes_bf16_kernel(cuda, dh, causal, masked):
    rng = np.random.default_rng(132)
    b, t, h = 5, 197 if dh == 64 else 50, 6 if dh == 64 else 3
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32)
                         ).to(cuda).to(BF16)
    y4 = y.view(b, t, h, 3 * dh)
    q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, t)) > 0.2).to(cuda)
        mask[0] = False
    with torch.inference_mode():
        o = FA.flash_attention_lanes(q, k, v, h, causal=causal, mask=mask)
        again = FA.flash_attention_lanes(q, k, v, h, causal=causal, mask=mask)
        want = A.lanes_attention(q, k, v, h, causal=causal, mask=mask)
        spread = A.lanes_attention(q, k, v.abs(), h, causal=causal, mask=mask)
        exact = A.lanes_attention(q, k, v, h, causal=causal, mask=mask, exact=True)
    _bf16_ulp(o, want, spread)
    _f64_gate(o, want, exact)
    assert torch.equal(o, again)
    if masked:
        assert (o[0] == 0).all()
    assert FA.LAUNCHES["flash_attention_lanes_bf16"] == 2
    assert FA.LAUNCHES["flash_attention_lanes"] == 0


def test_bf16_backward_and_other_head_dims_raise(cuda):
    """A backward through a bf16 forward takes the bf16 backward kernels
    (no f32 kernel, no plain version), at dh 64 and at a generic dh (40, the
    padded kernels); dh 12 and 136 and f32 Fourier coefficients under a bf16
    x raise, and nothing runs the plain version instead."""
    rng = np.random.default_rng(133)
    x = _spline_x(rng, (20, 16)).to(cuda).to(BF16)
    grid = K.make_bspline_grid(16, device=cuda)
    bw, sw, sc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(cuda).to(BF16).requires_grad_(True)
                  for s in ((8, 16), (8, 16, 8), (8, 16)))
    FB.bspline_kan(x, grid, bw, sw, sc).float().sum().backward()
    assert bw.grad.dtype == BF16
    q = torch.randn(2, 9, 64, device=cuda, dtype=BF16, requires_grad=True)
    FA.flash_attention_lanes(q, q, q, 2).float().sum().backward()
    assert q.grad.dtype == BF16
    assert FB.LAUNCHES["bspline_kan_bwd"] == 0 and FA.LAUNCHES["flash_attention_lanes_bwd"] == 0
    assert FB.LAUNCHES["bspline_kan_bwd_bf16"] == 1
    assert FA.LAUNCHES["flash_attention_lanes_bwd_bf16"] == 1
    q = torch.randn(2, 9, 80, device=cuda, dtype=BF16, requires_grad=True)
    FA.flash_attention_lanes(q, q, q, 2).float().sum().backward()
    assert q.grad.dtype == BF16 and FA.LAUNCHES["flash_attention_lanes_bwd_bf16"] == 2
    for dh in (12, 136):
        q = torch.zeros(2, 9, 2 * dh, device=cuda, dtype=BF16)
        with torch.inference_mode(), pytest.raises(ValueError, match=f"head dim {dh}"):
            FA.flash_attention_lanes(q, q, q, 2)
    with torch.inference_mode(), pytest.raises(TypeError, match="weight"):
        FB.fourierkan(torch.zeros(4, 16, device=cuda, dtype=BF16),
                      torch.zeros(2, 3, 16, 5, device=cuda), None)
    assert FA.LAUNCHES["flash_attention_lanes_bf16"] == 2
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 0


# --- bf16 Chebyshev: the bf16 forwards and backwards of chebykan and
# cheby_qkv_grouped against their plain twins, within one bf16 ulp plus one of
# each rounded T_n weighted as the next product weighs it (2^-8 |T| |W| for y,
# 2^-8 |T|^T |gy| for dW; chip_smoke.py's gates), no further than twice the
# twin from the f64 sum of the same rounded operands, their bits repeated.

CHEBY_BF16_SHAPES = [("chebykan", 37 * 49, None, 16, 64), ("chebykan", 300, None, 100, 70),
                     ("chebykan", 64 * 196, None, 768, 384),
                     ("cheby_qkv_grouped", 37 * 50, 2, 32, 96),
                     ("cheby_qkv_grouped", 64 * 50, 8, 8, 24),
                     ("cheby_qkv_grouped", 64 * 197, 6, 64, 192),
                     ("cheby_qkv_grouped", 301, 2, 20, 20)]


def _cheby_bf16_case(cuda, rng, n, heads, nin, nout):
    groups = 1 if heads is None else heads
    x = _cheby_x(rng, (n, groups * nin)).to(cuda).to(BF16)
    cc = (torch.from_numpy((rng.standard_normal((groups, nin, nout, 5))
                            / np.sqrt(nin * 5)).astype(np.float32)).to(cuda).to(BF16))
    if heads is None:
        return x, cc[0], FB.pack_cheby_weight(cc[0]).contiguous()
    return x, cc, FB.pack_cheby_qkv_weight(cc).contiguous()


@pytest.mark.parametrize("name,n,heads,nin,nout", CHEBY_BF16_SHAPES)
def test_cheby_bf16_kernel(cuda, name, n, heads, nin, nout):
    rng = np.random.default_rng(138)
    x, cc, w = _cheby_bf16_case(cuda, rng, n, heads, nin, nout)
    entry = FB.chebykan if heads is None else FB.cheby_qkv_grouped
    with torch.inference_mode():
        y = entry(x, cc)
        again = entry(x, cc)
        twin = K.cheby_grouped_forward_bf16(x, w)
        exact = K.cheby_grouped_forward_bf16(x, w, exact=True)
        spread = K.cheby_fwd_spread_bf16(x, w)
    _bf16_ulp(y, twin, spread)
    _f64_gate(y, twin, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES[f"{name}_bf16"] == 2 and FB.LAUNCHES[name] == 0


@pytest.mark.parametrize("name,n,heads,nin,nout", CHEBY_BF16_SHAPES)
def test_cheby_bwd_bf16_kernel(cuda, name, n, heads, nin, nout):
    rng = np.random.default_rng(139)
    x, _, w = _cheby_bf16_case(cuda, rng, n, heads, nin, nout)
    gy = torch.from_numpy(rng.standard_normal((n, w.shape[0] * nout)).astype(np.float32)
                          ).to(cuda).to(BF16)
    with torch.inference_mode():
        dx, dw = FB._launch_bwd_bf16(name, x, w, 4, gy, True, True)
        dx2, dw2 = FB._launch_bwd_bf16(name, x, w, 4, gy, True, True)
        _, dw_nodx = FB._launch_bwd_bf16(name, x, w, 4, gy, False, True)
        pdx, pdw = K.cheby_grouped_backward_bf16(x, w, gy)
        edx, edw = K.cheby_grouped_backward_bf16(x, w, gy, exact=True)
        spread = K.cheby_dw_spread_bf16(x, w, gy)
    _bf16_ulp(dx, pdx)
    _bf16_ulp(dw, pdw, spread)
    _f64_gate(dx, pdx, edx)
    _f64_gate(dw, pdw, edw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(dw, dw_nodx)
    assert bool((dx[x.float().abs() >= 9.5] == 0).all())
    assert FB.LAUNCHES[f"{name}_bwd_bf16"] == 3 and FB.LAUNCHES[f"{name}_bwd"] == 0


# --- bf16 FastKAN: the bf16 forwards and backwards of fastkan and
# fastkan_qkv_grouped against their plain twins, within one bf16 ulp plus one
# of each rounded basis value weighted as the next product weighs it (2^-8
# |B| |W| for y, 2^-8 |B|^T |gy| for dW; dx, dgamma and dbeta one ulp;
# chip_smoke.py's gates), no further than twice the twin from the f64 sums of
# the same operands, their bits repeated; a third of x at |x| 20-60 where
# silu(x) far exceeds the bases beside it in the one running sum.

FAST_BF16_SHAPES = [("fastkan", 37 * 49, None, 16, 64, False),
                    ("fastkan", 300, None, 100, 70, False),
                    ("fastkan", 64 * 196, None, 768, 384, False),
                    ("fastkan", 64 * 196, None, 768, 384, True),
                    ("fastkan_qkv_grouped", 37 * 50, 2, 32, 32, False),
                    ("fastkan_qkv_grouped", 64 * 50, 8, 8, 8, False),
                    ("fastkan_qkv_grouped", 64 * 197, 6, 64, 64, False),
                    ("fastkan_qkv_grouped", 64 * 197, 6, 64, 64, True),
                    ("fastkan_qkv_grouped", 301, 2, 20, 20, False)]


def _fast_bf16_case(cuda, rng, n, heads, nin, nout, large):
    """bf16 x (``large``: a third at |x| 20-60), gamma, beta (G, nin) and the
    packed weight (G, 9, nin, nout); the f32 centres."""
    groups = 1 if heads is None else heads
    x = _fast_x(rng, (n, groups * nin))
    if large:
        flat = x.view(-1)
        idx = torch.from_numpy(rng.choice(flat.numel(), flat.numel() // 3, replace=False))
        flat[idx] = torch.from_numpy((rng.uniform(20.0, 60.0, idx.numel())
                                      * rng.choice([-1.0, 1.0], idx.numel())).astype(np.float32))
    ga, be, sw, bw, _ = _fast_params(rng, nout, nin, (groups,))
    w = FB.pack_fastkan_qkv_weight(sw, bw, 8).contiguous()
    return [t.to(cuda).to(BF16) for t in (x, w, ga, be)]


@pytest.mark.parametrize("name,n,heads,nin,nout,large", FAST_BF16_SHAPES)
def test_fastkan_bf16_kernel(cuda, name, n, heads, nin, nout, large):
    rng = np.random.default_rng(140)
    x, w, ga, be = _fast_bf16_case(cuda, rng, n, heads, nin, nout, large)
    grid, den = RBF_GRID.to(cuda), 4.0 / 7.0
    with torch.inference_mode():
        y, stats = FB._launch_rbf(name, x, w, ga, be, grid, den)
        again, _ = FB._launch_rbf(name, x, w, ga, be, grid, den)
        twin = K.fastkan_grouped_forward_bf16(x, w, ga, be, grid, den)
        exact = K.fastkan_grouped_forward_bf16(x, w, ga, be, grid, den, exact=True)
        spread = K.fastkan_fwd_spread_bf16(x, w, ga, be, grid, den)
    _bf16_ulp(y, twin, spread)
    _f64_gate(y, twin, exact)
    assert torch.equal(y, again) and stats.dtype == torch.float32
    assert FB.LAUNCHES[f"{name}_bf16"] == 2 and FB.LAUNCHES[name] == 0


@pytest.mark.parametrize("name,n,heads,nin,nout,large",
                         [c for c in FAST_BF16_SHAPES if not c[-1]])
def test_fastkan_bwd_bf16_kernel(cuda, name, n, heads, nin, nout, large):
    """dx, dW, dgamma and dbeta; the no-dx route's dW, dgamma and dbeta the
    all-gradients route's bits."""
    rng = np.random.default_rng(141)
    x, w, ga, be = _fast_bf16_case(cuda, rng, n, heads, nin, nout, large)
    grid, den = RBF_GRID.to(cuda), 4.0 / 7.0
    gy = torch.from_numpy(rng.standard_normal((n, w.shape[0] * nout)).astype(np.float32)
                          ).to(cuda).to(BF16)
    with torch.inference_mode():
        _, stats = FB._launch_rbf(name, x, w, ga, be, grid, den)
        args = (f"{name}_bwd", x, w, ga, be, grid, den, stats, gy)
        got = FB._launch_rbf_bwd(*args, True, True)
        again = FB._launch_rbf_bwd(*args, True, True)
        no_dx = FB._launch_rbf_bwd(*args, False, True)
        twin = K.fastkan_grouped_backward_bf16(x, w, ga, be, grid, den, gy)
        exact = K.fastkan_grouped_backward_bf16(x, w, ga, be, grid, den, gy, exact=True)
        spread = K.fastkan_dw_spread_bf16(x, w, ga, be, grid, den, gy)
    for i, (g, t, e) in enumerate(zip(got, twin, exact)):
        _bf16_ulp(g, t, spread if i == 1 else None)
        _f64_gate(g, t, e)
        assert torch.equal(g, again[i])
    assert no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], no_dx[1:]))
    assert FB.LAUNCHES[f"{name}_bwd_bf16"] == 3 and FB.LAUNCHES[f"{name}_bwd"] == 0


# --- bf16 sine: the bf16 forwards and backwards of sinekan (grid 28, its
# slices in chunks of 4) and sinekan_qkv_grouped (grid 4) against their plain
# twins, within one bf16 ulp plus one of each rounded basis value weighted as
# the next product weighs it (2^-8 |sin a| |W| for y, 2^-8 |sin a|^T |gy| for
# dW; dx one ulp; dfreq one ulp plus 2^-14 of sum |gW x cos a|, two f32 sums
# of its cancelling terms in other orders; chip_smoke.py's gates), no
# further than twice the twin from the f64 sums of the same operands, their
# bits repeated.

SINE_BF16_SHAPES = [("sinekan", 37 * 49, None, 16, 64, 28),
                    ("sinekan", 300, None, 100, 70, 5),
                    ("sinekan", 64 * 196, None, 768, 384, 28),
                    ("sinekan_qkv_grouped", 37 * 50, 2, 32, 32, 4),
                    ("sinekan_qkv_grouped", 64 * 50, 8, 8, 8, 4),
                    ("sinekan_qkv_grouped", 64 * 197, 6, 64, 64, 4),
                    ("sinekan_qkv_grouped", 301, 2, 20, 20, 3)]


def _sine_bf16_case(cuda, rng, n, heads, nin, nout, grid_size):
    """bf16 x (|x| up to 20), freq (G, S) and the packed weight (G, S, nin,
    nout); the f32 phase table."""
    groups = 1 if heads is None else heads
    x = _sine_x(rng, (n, groups * nin))
    freq = ((torch.arange(1, grid_size + 1) / (grid_size + 1)).repeat(groups, 1)
            + _param(rng, (groups, grid_size), 0.05))
    amps = _param(rng, (groups, nout, nin, grid_size), 1.0 / np.sqrt(nin))
    w = FB.pack_sine_qkv_weight(amps).contiguous()
    return ([t.to(cuda).to(BF16) for t in (x, w, freq)]
            + [K.sinekan_phase_init(nin, grid_size).to(cuda)])


@pytest.mark.parametrize("name,n,heads,nin,nout,grid_size", SINE_BF16_SHAPES)
def test_sine_bf16_kernel(cuda, name, n, heads, nin, nout, grid_size):
    rng = np.random.default_rng(150)
    x, w, f2, phase = _sine_bf16_case(cuda, rng, n, heads, nin, nout, grid_size)
    with torch.inference_mode():
        y = FB._launch_sine(name, x, w, f2, phase)
        again = FB._launch_sine(name, x, w, f2, phase)
        twin = K.sine_grouped_forward_bf16(x, w, f2, phase)
        exact = K.sine_grouped_forward_bf16(x, w, f2, phase, exact=True)
        spread = K.sine_fwd_spread_bf16(x, w, f2, phase)
    _bf16_ulp(y, twin, spread)
    _f64_gate(y, twin, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES[f"{name}_bf16"] == 2 and FB.LAUNCHES[name] == 0


@pytest.mark.parametrize("name,n,heads,nin,nout,grid_size", SINE_BF16_SHAPES)
def test_sine_bwd_bf16_kernel(cuda, name, n, heads, nin, nout, grid_size):
    """dx, dW and dfreq; the no-dx route's dW and dfreq the all-gradients
    route's bits."""
    rng = np.random.default_rng(151)
    x, w, f2, phase = _sine_bf16_case(cuda, rng, n, heads, nin, nout, grid_size)
    gy = torch.from_numpy(rng.standard_normal((n, w.shape[0] * nout)).astype(np.float32)
                          ).to(cuda).to(BF16)
    with torch.inference_mode():
        args = (f"{name}_bwd", x, w, f2, phase, gy)
        got = FB._launch_sine_bwd(*args, True, True)
        again = FB._launch_sine_bwd(*args, True, True)
        no_dx = FB._launch_sine_bwd(*args, False, True)
        twin = K.sine_grouped_backward_bf16(x, w, f2, phase, gy)
        exact = K.sine_grouped_backward_bf16(x, w, f2, phase, gy, exact=True)
        spreads = (None, K.sine_dw_spread_bf16(x, w, f2, phase, gy),
                   K.sine_dfreq_spread_bf16(x, w, f2, phase, gy) * 2.0 ** -6)
    for g, t, e, spread, a in zip(got, twin, exact, spreads, again):
        _bf16_ulp(g, t, spread)
        _f64_gate(g, t, e)
        assert torch.equal(g, a)
    assert no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], no_dx[1:]))
    assert FB.LAUNCHES[f"{name}_bwd_bf16"] == 3 and FB.LAUNCHES[f"{name}_bwd"] == 0


# --- bf16 Fourier: the bf16 forward and backward of fourierkan (its 2G slices
# in chunks of 2 harmonics, cos/sin(kx) by the angle-addition recurrence)
# against their plain twins, within one bf16 ulp plus one of each rounded
# basis value weighted as the next product weighs it (2^-8 |B| |W| for y,
# 2^-8 |B|^T |gy| for dW; dx one ulp; chip_smoke.py's gates), no further
# than twice the twin from the f64 sums of the same operands, their bits
# repeated.

FOURIER_BF16_SHAPES = [(37 * 49, 16, 64, 28), (300, 100, 70, 5), (301, 24, 20, 3),
                       (64 * 196, 768, 384, 28)]


def _fourier_bf16_case(cuda, rng, n, nin, nout, grid_size):
    """bf16 x (every 7th entry over [-10, 10]) and the packed weight (1, 2G,
    nin, nout), cos harmonics first."""
    coeffs = _param(rng, (2, nout, nin, grid_size), 1.0 / np.sqrt(nin * grid_size))
    return (_fourier_x(rng, (n, nin)).to(cuda).to(BF16),
            FB.pack_fourier_weight(coeffs).contiguous().to(cuda).to(BF16))


@pytest.mark.parametrize("n,nin,nout,grid_size", FOURIER_BF16_SHAPES)
def test_fourier_bf16_kernel(cuda, n, nin, nout, grid_size):
    rng = np.random.default_rng(160)
    x, w = _fourier_bf16_case(cuda, rng, n, nin, nout, grid_size)
    with torch.inference_mode():
        y = FB._launch_bf16("fourierkan", x, w, grid_size)
        again = FB._launch_bf16("fourierkan", x, w, grid_size)
        twin = K.fourier_grouped_forward_bf16(x, w)
        exact = K.fourier_grouped_forward_bf16(x, w, exact=True)
        spread = K.fourier_fwd_spread_bf16(x, w)
    _bf16_ulp(y, twin, spread)
    _f64_gate(y, twin, exact)
    assert torch.equal(y, again)
    assert FB.LAUNCHES["fourierkan_bf16"] == 2 and FB.LAUNCHES["fourierkan"] == 0


@pytest.mark.parametrize("n,nin,nout,grid_size", FOURIER_BF16_SHAPES)
def test_fourier_bwd_bf16_kernel(cuda, n, nin, nout, grid_size):
    """dx and dW, all gradients and without dx (the training step's); the
    no-dx route's dW the all-gradients route's bits."""
    rng = np.random.default_rng(161)
    x, w = _fourier_bf16_case(cuda, rng, n, nin, nout, grid_size)
    gy = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).to(cuda).to(BF16)
    with torch.inference_mode():
        got = FB._launch_bwd_bf16("fourierkan", x, w, grid_size, gy, True, True)
        again = FB._launch_bwd_bf16("fourierkan", x, w, grid_size, gy, True, True)
        no_dx = FB._launch_bwd_bf16("fourierkan", x, w, grid_size, gy, False, True)
        twin = K.fourier_grouped_backward_bf16(x, w, gy)
        exact = K.fourier_grouped_backward_bf16(x, w, gy, exact=True)
        spreads = (None, K.fourier_dw_spread_bf16(x, w, gy))
    for g, t, e, spread, a in zip(got, twin, exact, spreads, again):
        _bf16_ulp(g, t, spread)
        _f64_gate(g, t, e)
        assert torch.equal(g, a)
    assert no_dx[0] is None and torch.equal(no_dx[1], got[1])
    assert FB.LAUNCHES["fourierkan_bwd_bf16"] == 3 and FB.LAUNCHES["fourierkan_bwd"] == 0


# --- bf16 training: the bf16 backwards of bspline_kan, bspline_qkv_grouped and
# the lanes attention against their plain twins, within one bf16 ulp plus one
# of each rounded intermediate weighted as the next product weighs it
# (chip_smoke.py's gates), no further than twice the twin from the f64 sum
# of the same rounded operands, their bits repeated.

def _bwd_bf16_case(cuda, rng, n, groups, nin, nout, per_head=False):
    x = _spline_x(rng, (n, groups * nin)).to(cuda).to(BF16)
    grid = K.make_bspline_grid(nin, device=cuda)
    if per_head:
        grid = torch.stack([grid * (1 + 0.05 * i) + 0.01 * i for i in range(groups)])
    w = (torch.from_numpy(rng.standard_normal((groups, 9, nin, nout)).astype(np.float32)
                          * 0.3).to(cuda).to(BF16))
    gy = torch.from_numpy(rng.standard_normal((n, groups * nout)).astype(np.float32)
                          ).to(cuda).to(BF16)
    return x, grid, w, gy


@pytest.mark.parametrize("name,n,groups,nin,nout,per_head", [
    ("bspline_kan", 37 * 49, 1, 16, 64, False), ("bspline_kan", 64 * 196, 1, 768, 384, False),
    ("bspline_qkv_grouped", 37 * 50, 2, 32, 96, False),
    ("bspline_qkv_grouped", 64 * 50, 8, 8, 24, False),
    ("bspline_qkv_grouped", 64 * 197, 6, 64, 192, False),
    ("bspline_qkv_grouped", 64 * 197, 6, 64, 64, True),
    ("bspline_qkv_grouped", 301, 2, 20, 20, False)])
def test_bspline_bwd_bf16_kernel(cuda, name, n, groups, nin, nout, per_head):
    """At the vit-s and MNIST shapes, a grid a head, and ragged ones (nout
    20 takes the element-wise copies)."""
    rng = np.random.default_rng(135)
    x, grid, w, gy = _bwd_bf16_case(cuda, rng, n, groups, nin, nout, per_head)
    with torch.inference_mode():
        dx, dw = FB._launch_bwd_bf16(name, x, w, grid, gy, True, True)
        dx2, dw2 = FB._launch_bwd_bf16(name, x, w, grid, gy, True, True)
        _, dw_nodx = FB._launch_bwd_bf16(name, x, w, grid, gy, False, True)
        pdx, pdw = K.bspline_grouped_backward_bf16(x, grid, w, gy)
        edx, edw = K.bspline_grouped_backward_bf16(x, grid, w, gy, exact=True)
        spread = K.bspline_dw_spread_bf16(x, grid, w, gy)
    _bf16_ulp(dx, pdx)
    _bf16_ulp(dw, pdw, spread)
    _f64_gate(dx, pdx, edx)
    _f64_gate(dw, pdw, edw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(dw, dw_nodx)
    assert FB.LAUNCHES[f"{name}_bwd_bf16"] == 3 and FB.LAUNCHES[f"{name}_bwd"] == 0


@pytest.mark.parametrize("dh", [8, 16, 32, 64, 24, 40, 72, 96, 128])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_attention_lanes_bwd_bf16_kernel(cuda, dh, causal, masked):
    rng = np.random.default_rng(136)
    b, t, h = 5, 197 if dh == 64 else 50, 6 if dh == 64 else 3
    y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh)).astype(np.float32)
                         ).to(cuda).to(BF16)
    do = torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(np.float32)
                          ).to(cuda).to(BF16)
    y4 = y.view(b, t, h, 3 * dh)
    q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, t)) > 0.2).to(cuda)
        mask[0] = False

    def grads():
        leaf = y.clone().requires_grad_(True)
        l4 = leaf.view(b, t, h, 3 * dh)
        o = FA.flash_attention_lanes(*(l4[..., i * dh:(i + 1) * dh] for i in range(3)), h,
                                     causal=causal, mask=mask)
        o.backward(do)
        g4 = leaf.grad.view(b, t, h, 3 * dh)
        return o.detach(), [g4[..., i * dh:(i + 1) * dh].reshape(b, t, h * dh)
                            for i in range(3)]

    o, got = grads()
    _, again = grads()
    with torch.inference_mode():
        want = A.lanes_attention_bwd_bf16(q, k, v, o, do, h, causal, mask)
        spread = A.lanes_attention_bwd_bf16(q, k, v, o, do, h, causal, mask, spread=True)
        exact = A.lanes_attention_bwd_bf16(q, k, v, o, do, h, causal, mask, exact=True)
    for g, g2, w, sp, e in zip(got, again, want, spread, exact):
        _bf16_ulp(g, w, sp)
        _f64_gate(g, w, e)
        assert torch.equal(g, g2)
    if masked:
        assert all((g[0] == 0).all() for g in got)
    assert FA.LAUNCHES["flash_attention_lanes_bwd_bf16"] == 2
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == 0


@pytest.mark.parametrize("kind,embedder,qkv", [("efficientkan", "bspline_kan",
                                                 "bspline_qkv_grouped"),
                                                ("cheby", "chebykan", "cheby_qkv_grouped"),
                                                ("fast", "fastkan", "fastkan_qkv_grouped"),
                                                ("sine", "sinekan", "sinekan_qkv_grouped"),
                                                ("fourier", "fourierkan", None)])
def test_bf16_train_step_on_card(cuda, kind, embedder, qkv):
    """One bf16 step of a 2-block MNIST-geometry efficientkan, cheby, fast,
    sine or fourier ViT on the card against the CPU's (the plain twins): 1 +
    2 + 2 bf16 launches forward and backward (fast, sine: 2 x 3 grouped
    q/k/v, one a projection; fourier: 1 + 2, its q/k/v Linear) and no f32
    ones, loss within 2e-2 x max(1, |loss|) and every gradient within 5e-2
    x max(1, max|g|) (kanvit's bf16 gates), the f32 parameters and
    gradients f32."""
    import copy

    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    cpu = create_model(kind, chw=(1, 28, 28), n_patches=7, n_blocks=2,
                       d_hidden=64, n_heads=2, out_d=10, seed=6)
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(137)
    x = torch.from_numpy(rng.standard_normal((6, 1, 28, 28)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 6))
    step = make_train_step(bf16=True)
    _, lc, _ = step(create_train_state(cpu), x, y)
    _, lg, _ = step(create_train_state(gpu), x.to(cuda), y.to(cuda))
    counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    grouped = 6 if kind in ("fast", "sine") else 2
    want = {f"{embedder}_bf16": 1, "flash_attention_lanes_bf16": 2,
            f"{embedder}_bwd_bf16": 1, "flash_attention_lanes_bwd_bf16": 2}
    if qkv is not None:
        want.update({f"{qkv}_bf16": grouped, f"{qkv}_bwd_bf16": grouped})
    assert counts == want
    assert abs(float(lc) - float(lg)) <= 2e-2 * max(1.0, abs(float(lc)))
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert pg.dtype == pg.grad.dtype == torch.float32, name
        err = float((pc.grad - pg.grad.cpu()).abs().max())
        assert err <= 5e-2 * max(1.0, float(pc.grad.abs().max())), (name, err)


def test_bf16_eval_step_and_predictor_on_card(cuda):
    """A small efficientkan ViT served in bf16 on the card: 1 + 2 + 2 bf16
    launches a forward, logits within 2e-2 x max(1, max|logits|) of the CPU's
    bf16 forward, the Predictor on a bf16 copy giving the eval step's
    logits, and the f32 parameters untouched."""
    import copy

    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_eval_step
    from kanvit_torch.utils import precision

    cpu = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, n_blocks=2,
                       d_hidden=64, n_heads=2, out_d=10, seed=4)
    x = np.random.default_rng(134).standard_normal((6, 1, 28, 28)).astype(np.float32)
    y = torch.zeros(6, dtype=torch.long)
    _, want = make_eval_step(bf16=True)(create_train_state(cpu), torch.from_numpy(x), y)
    model = copy.deepcopy(cpu).to(cuda)
    _, got = make_eval_step(bf16=True)(create_train_state(model),
                                       torch.from_numpy(x).to(cuda), y.to(cuda))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    counts = {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}
    assert counts == {"bspline_kan_bf16": 1, "bspline_qkv_grouped_bf16": 2,
                      "flash_attention_lanes_bf16": 2}
    err = float((got.cpu() - want).abs().max())
    assert got.dtype == torch.float32 and err <= 2e-2 * max(1.0, float(want.abs().max()))
    served = Predictor(precision.cast_params_(copy.deepcopy(cpu)).to(cuda), 6,
                       device=cuda).logits(x)
    assert np.abs(served - got.cpu().numpy()).max() <= 2e-2 * max(
        1.0, float(want.abs().max()))


# --- bf16 tiled attention (flash_attention.cu's bf16 kernels) and the bf16
# decoder: each kernel against its plain twin (A.flash_attention_bf16 over
# kanvit's key blocks, A.flash_attention_bwd_bf16 on the kernel forward's o
# and (m, l)); o within one bf16 ulp plus the two-sided p term (2^-7 of the
# twin's attention over |v|: the kernel rounds p against its own 32-key
# tiles' running max), each gradient within one ulp plus one of each rounded
# p and ds (chip_smoke.py's gates).

def _flash_bf16_case(rng, b, h, tq, tk, dh, masked):
    (q, k, v), mask = _flash_inputs(rng, b, h, tq, tk, dh, masked)
    do = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(np.float32)).cuda()
    return [a.to(BF16) for a in (q, k, v)], do.to(BF16), mask


def _flash_bf16_launch(q, k, v, mask, causal, do):
    """The three bf16 kernels launched alone: o, stats, (dq, dk, dv) as
    (B, H, T, dh) views."""
    maskb = None if mask is None else mask.to(torch.uint8).contiguous()
    do4 = do.transpose(1, 2).contiguous()
    with torch.inference_mode():
        o4, stats = FA._launch_tiled(q, k, v, maskb, causal, True)
        grads = FA._launch_tiled_bwd(q, k, v, maskb, o4, stats, do4, causal)
    return o4.transpose(1, 2), stats, [g.transpose(1, 2) for g in grads]


@pytest.mark.parametrize("causal,masked", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("b,h,tq,tk,dh", [
    (2, 4, 1100, 1100, 64),
    (3, 2, 300, 517, 32),   # tq < tk: rows with qpos < 0
    (2, 2, 517, 300, 16),   # tq > tk
    (2, 2, 700, 700, 8),
    # the padded kernels: odd multiples of 8 end in half a 16-deep step
    (2, 2, 1100, 1100, 128),
    (3, 2, 300, 517, 24),
    (2, 2, 517, 300, 40),
    (2, 2, 700, 700, 72),
    (1, 3, 600, 600, 120),
    # the backward's tile edges (blocks of 128 rows in two consumers of 64,
    # streamed tiles of 64): T just past 9 x 64 and 5 x 128, tk > tq
    (2, 2, 577, 577, 64), (1, 2, 641, 641, 64), (2, 2, 449, 705, 64),
    (2, 2, 577, 577, 72), (1, 2, 641, 641, 72), (2, 2, 449, 705, 72),
    (2, 2, 577, 577, 128), (1, 2, 641, 641, 128), (2, 2, 449, 705, 128),
    # the other multiples of 8 through 128
    *((2, 2, 300, 517, dh) for dh in (48, 56, 80, 88, 96, 104, 112)),
])
def test_flash_attention_bf16_kernels(cuda, b, h, tq, tk, dh, causal, masked):
    rng = np.random.default_rng(135)
    (q, k, v), do, mask = _flash_bf16_case(rng, b, h, tq, tk, dh, masked)
    o, stats, grads = _flash_bf16_launch(q, k, v, mask, causal, do)
    want, m, l = A.flash_attention_bf16(q, k, v, causal, 1024, mask)
    spread = A.flash_attention_bf16(q, k, v.abs(), causal, 1024, mask)[0]
    torch.cuda.synchronize()
    assert o.dtype == BF16
    bound = (2.0 ** -7 * want.double().abs() + 2.0 ** -12 * float(want.double().abs().max())
             + 2.0 ** -7 * spread.double())
    assert bool(((o.double() - want.double()).abs() <= bound).all())
    assert float((stats[..., 0] - m).abs().max()) <= 1e-4 * max(1.0, float(m.abs().max()))
    assert float(((stats[..., 1] - l).abs() / l.clamp_min(1.0)).max()) <= 1e-4
    twin = A.flash_attention_bwd_bf16(q, k, v, o, do, stats[..., 0], stats[..., 1], causal,
                                      mask)
    spreads = A.flash_attention_bwd_bf16(q, k, v, o, do, stats[..., 0], stats[..., 1],
                                         causal, mask, spread=True)
    for got, w, sp in zip(grads, twin, spreads):
        _bf16_ulp(got, w, sp)
    assert (FA.LAUNCHES["flash_attention_bf16"], FA.LAUNCHES["flash_attention_dq_bf16"],
            FA.LAUNCHES["flash_attention_dkv_bf16"]) == (1, 1, 1)
    assert FA.LAUNCHES["flash_attention"] == FA.LAUNCHES["flash_attention_dq"] == 0


@pytest.mark.parametrize("h,dh,tq,tk", [
    (4, 64, 2048, 2048), (2, 128, 2048, 2048), (3, 40, 2048, 2048),
    # the backward's tile edges: T just past 9 x 64 and 5 x 128, tk > tq
    (2, 64, 577, 577), (2, 64, 641, 641), (2, 64, 449, 705),
    (2, 72, 577, 577), (2, 72, 641, 641), (2, 72, 449, 705),
    (2, 128, 577, 577), (2, 128, 641, 641), (2, 128, 449, 705),
])
def test_flash_attention_bf16_repeats_its_bits(cuda, h, dh, tq, tk):
    """Forward and backward at the decoder's seq 2048 (B 2, causal; 4 heads
    of 64, and 2 of 128 and 3 of 40) and at the backward's tile edges give
    the same bits twice, through ``flash_attention`` and autograd (the
    tiled tier: T past the 512-row bucket, or tq != tk); o, dq, dk and dv
    are bf16."""
    rng = np.random.default_rng(136)
    (q, k, v), do, _ = _flash_bf16_case(rng, 2, h, tq, tk, dh, False)

    def run():
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        o = FA.flash_attention(*leaves, True, 512, 1024)
        o.backward(do)
        return [o.detach()] + [a.grad for a in leaves]

    first, second = run(), run()
    assert all(a.dtype == BF16 for a in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert (FA.LAUNCHES["flash_attention_bf16"], FA.LAUNCHES["flash_attention_dq_bf16"],
            FA.LAUNCHES["flash_attention_dkv_bf16"]) == (2, 2, 2)


def test_flash_attention_bf16_raises_not_falls_back(cuda):
    """A generic head dim in bf16 (40) runs on the padded kernels within the
    twin's gates, one launch of each; dh 12 and 136 raise before any
    launch, naming their ROADMAP entry; mixed dtypes raise; an unaligned
    view raises, at dh 16 and at dh 40."""
    rng = np.random.default_rng(137)
    (q, k, v), do, _ = _flash_bf16_case(rng, 1, 2, 600, 600, 40, False)
    o, stats, grads = _flash_bf16_launch(q, k, v, None, True, do)
    want, m, l = A.flash_attention_bf16(q, k, v, True, 1024)
    spread = A.flash_attention_bf16(q, k, v.abs(), True, 1024)[0]
    _bf16_ulp(o, want, spread, mid=2.0 ** -7)
    twin = A.flash_attention_bwd_bf16(q, k, v, o, do, stats[..., 0], stats[..., 1], True)
    spreads = A.flash_attention_bwd_bf16(q, k, v, o, do, stats[..., 0], stats[..., 1], True,
                                         spread=True)
    for got, w, sp in zip(grads, twin, spreads):
        _bf16_ulp(got, w, sp)
    assert (FA.LAUNCHES["flash_attention_bf16"], FA.LAUNCHES["flash_attention_dq_bf16"],
            FA.LAUNCHES["flash_attention_dkv_bf16"]) == (1, 1, 1)
    FA.reset_launches()
    for dh in (12, 136):
        q = torch.zeros(1, 2, 600, dh, device=cuda, dtype=BF16)
        with pytest.raises(ValueError, match=f"head dim {dh}.*3c"):
            FA.flash_attention(q, q, q, True)
    q = torch.zeros(1, 2, 600, 32, device=cuda, dtype=BF16)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention(q, q.float(), q, True)
    for dh in (16, 40):
        flat = torch.zeros(2 * 600 * 2 * dh + 1, device=cuda, dtype=BF16)
        q = flat[1:].view(2, 600, 2, dh).transpose(1, 2)
        with pytest.raises(ValueError, match="16-byte"):
            FA.flash_attention(q, q, q, True)
    assert sum(FA.LAUNCHES.values()) == 0


def test_decoder_bf16_train_step_on_card(cuda):
    """A bf16 step (``bench_decoder``'s) of a 2-block decoder at T 600 on the
    card against the same on the CPU (the kernels' twins): 2 + 2 + 2 bf16
    tiled launches and nothing else, the loss within 2e-2 and each f32
    parameter's gradient within 5e-2 of its own max|g| (the gradients are
    all below 1, where max(1, max|g|) would pass a zeroed one)."""
    import copy

    from kanvit_torch import bench_decoder as BD
    from kanvit_torch.utils import precision

    cpu = BD.build_model(64, 2, 2, 128, seed=7)
    gpu = copy.deepcopy(cpu).to(cuda)
    tokens = BD.make_tokens(2, 600, 128)
    with precision.f32_accumulation():
        lc = BD.loss_and_logits(cpu, tokens, bf16=True)[0]
        lc.backward()
        lg = BD.loss_and_logits(gpu, tokens.to(cuda), bf16=True)[0]
        lg.backward()
    lc, lg = float(lc.detach()), float(lg.detach())
    assert abs(lc - lg) <= 2e-2 * max(1.0, abs(lc))
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert pg.dtype == pg.grad.dtype == torch.float32, name
        err = float((pc.grad - pg.grad.cpu()).abs().max())
        assert err <= 5e-2 * float(pc.grad.abs().max()), (name, err)
    assert {k: n for k, n in FA.LAUNCHES.items() if n} == {
        "flash_attention_bf16": 2, "flash_attention_dq_bf16": 2, "flash_attention_dkv_bf16": 2}
    step = BD.make_step(gpu, bf16=True)
    losses = [float(step(tokens.to(cuda))) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --- the bf16 fused FF: forward and backward kernels against their plain
# twins (K.ffn_pre_ln_bf16 / K.ffn_pre_ln_bwd_bf16, kanvit's bf16 policy),
# within one bf16 ulp plus 2^-8 of K.ffn_spread_bf16 (one ulp of LN, r and
# dh weighted as the next product weighs it) and, for the sums over the
# rows (in other blocks than the twin's), 2 N 2^-24 of their sum of |terms|
# (K.ffn_spread_bf16); the backward held on the kernel's own ReLU pattern;
# bits repeated.

@pytest.mark.parametrize("n,d,f", [(12 * 197, 384, 1536), (37 * 50 + 1, 100, 400),
                                   (2 * 197, 768, 3072), (200, 1024, 4096)])
def test_ffn_pre_ln_bf16_kernels(cuda_all, n, d, f):
    """vit-s, a ragged narrow shape, vit-b's and vit-l's widths (the tiled
    route): y and the seven gradients within their gates of the twins, bf16,
    their bits repeated; 3 bf16 forward and 2 backward launches, no f32."""
    from kanvit_torch.kernels import fused_ffn as FFN

    rng = np.random.default_rng(140 + d)
    args = [a.to(BF16) for a in _ffn_inputs(rng, n, d, f, cuda_all)]
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_all).to(BF16)
    mask = torch.empty(n, f, dtype=torch.uint8, device=cuda_all)
    with torch.inference_mode():
        y, again = FFN._launch_bf16(*args), FFN._launch_bf16(*args, relu_mask=mask)
        _bf16_ulp(y, K.ffn_pre_ln_bf16(*args), K.ffn_spread_bf16(*args[:6]))
        assert torch.equal(y, again)
        pattern = mask.bool()
        got = FFN._launch_bwd_bf16(*args[:6], g)
        second = FFN._launch_bwd_bf16(*args[:6], g)
        twin = K.ffn_pre_ln_bwd_bf16(*args[:6], g, pattern=pattern)
        spreads = K.ffn_spread_bf16(*args[:6], g=g, pattern=pattern)
        for a, b, c, sp in zip(got, twin, second, spreads):
            _bf16_ulp(a, b, sp)
            assert torch.equal(a, c)
    assert FFN.LAUNCHES == {"ffn_pre_ln": 0, "ffn_pre_ln_bwd": 0, "ffn_pre_ln_bf16": 2,
                            "ffn_pre_ln_bwd_bf16": 2}
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = FFN.ffn_pre_ln(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    assert out.dtype == BF16 and all(t.dtype == BF16 for t in grads)
    assert torch.equal(out, y) and all(torch.equal(a, b) for a, b in zip(grads, got))
    assert FFN.LAUNCHES["ffn_pre_ln_bf16"] == 3 and FFN.LAUNCHES["ffn_pre_ln_bwd_bf16"] == 3
    mixed = [args[0].float(), *args[1:]]
    with pytest.raises(TypeError, match="gamma must be float32 as x is"):
        FFN.ffn_pre_ln(*mixed)


def test_fused_ff_bf16_train_step_on_card(cuda_all):
    """A bf16 step (``make_train_step(bf16=True)``) of a 2-block efficientkan
    ViT with the fused FF at the reference geometry on the card against the
    same on the CPU (the kernels' twins): 2 + 2 bf16 FF launches and no f32
    one, the loss within 2e-2 x max(1, |loss|), each f32 parameter's
    gradient within 5e-2 of its own max|g|, and the loss falling over 3
    steps."""
    import copy

    from kanvit_torch.kernels import fused_ffn as FFN
    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    cpu = create_model("efficientkan", chw=(3, 32, 32), n_patches=4, n_blocks=2, d_hidden=64,
                       n_heads=8, out_d=100, seed=6, fused_ff=True)
    gpu = copy.deepcopy(cpu).to(cuda_all)
    rng = np.random.default_rng(114)
    x = torch.from_numpy(rng.standard_normal((6, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 100, 6))
    step = make_train_step(bf16=True)
    _, lc, _ = step(create_train_state(cpu), x, y)
    sg, lg, _ = step(create_train_state(gpu), x.to(cuda_all), y.to(cuda_all))
    assert abs(float(lc) - float(lg)) <= 2e-2 * max(1.0, abs(float(lc)))
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert pg.dtype == pg.grad.dtype == torch.float32, name
        err = float((pc.grad - pg.grad.cpu()).abs().max())
        assert err <= 5e-2 * float(pc.grad.abs().max()), (name, err)
    assert FFN.LAUNCHES == {"ffn_pre_ln": 0, "ffn_pre_ln_bwd": 0, "ffn_pre_ln_bf16": 2,
                            "ffn_pre_ln_bwd_bf16": 2}
    losses = [float(lg)] + [float(step(sg, x.to(cuda_all), y.to(cuda_all))[1]) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
