"""The port's Linear-projection MSA and the ``vanilla`` ViT against kanvit
and the executed reference.

kanvit projects q/k/v of the ``vanilla``, ``flash-attn``, ``fourier`` and
``linear`` kinds with per-head Linear layers, as one block-diagonal dense
matmul outside any Pallas kernel (``_fused_qkv_linear_bd``); the port runs
one batched matmul over the heads and hands the lanes attention strided
views of its output. The only kernel on the vanilla ViT's path is the lanes
attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.layers.attention import MSA as JMSA
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA
from kanvit_torch.models import create_model
from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import _emu_lanes_bwd, _emu_lanes_fwd, _maxdiff
from test_torch_port_train import check_grads, check_losses, check_params, run_steps

TOL = 1e-5
LOGIT_TOL = 1e-3
MNIST = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=64, n_heads=2,
             out_d=10)
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _launched():
    return {k: n for k, n in {**FB.LAUNCHES, **FA.LAUNCHES}.items() if n}


def _numpy_sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


# --- executed-reference goldens ---------------------------------------------

def test_msa_vanilla_golden():
    g, sd = load_golden("msa_vanilla")
    msa = MSA(16, n_heads=2, type="vanilla")
    load_reference_state_dict(msa, sd)
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(g["x"])), g["y"]) <= TOL


def test_model_vanilla_golden():
    g, sd = load_golden("model_vanilla")
    model = create_model("vanilla", **MNIST)
    load_reference_state_dict(model, sd)
    with torch.inference_mode():
        assert _maxdiff(model(torch.from_numpy(g["x"])), g["y"]) <= LOGIT_TOL


def test_vanilla_state_dict_uses_reference_naming():
    _, ref = load_golden("model_vanilla")
    port = create_model("vanilla", **MNIST).state_dict()
    assert set(port) == set(ref)
    for k, v in port.items():
        assert tuple(v.shape) == ref[k].shape, k


# --- against kanvit on the same params --------------------------------------

@pytest.mark.parametrize("kind", ["vanilla", "flash-attn", "fourier", "linear"])
@pytest.mark.parametrize("d,heads,t", [(16, 2, 5), (384, 6, 9)])
def test_linear_msa_matches_kanvit(kind, d, heads, t):
    x = np.random.default_rng(60).standard_normal((2, t, d)).astype(np.float32)
    src = MSA(d, n_heads=heads, type=kind,
              generator=torch.Generator().manual_seed(7))
    params = params_from_torch_state_dict(
        _numpy_sd(src, "blocks.0.attn."))["blocks_0"]["attn"]
    want = jax.jit(JMSA(d, n_heads=heads, type=kind).apply)(
        {"params": params}, jnp.asarray(x))
    sd = state_dict_from_jax_params({"blocks_0": {"attn": params}})
    msa = MSA(d, n_heads=heads, type=kind)
    load_reference_state_dict(msa, {k[len("blocks.0.attn."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        assert _maxdiff(msa(torch.from_numpy(x)), want) <= TOL


def test_linear_msa_feeds_attention_strided_views(monkeypatch):
    """q/k/v reach the lanes attention as (B, T, H, dh) views of one
    projection output (no copy), equal to each head's own Linear."""
    seen = []

    def spy(q, k, v, n_heads, **kw):
        seen.append((q, k, v))
        return A.lanes_attention(q, k, v, n_heads, **kw)

    monkeypatch.setattr(FA, "flash_attention_lanes", spy)
    b, t, h, dh = 2, 5, 3, 8
    msa = MSA(h * dh, h, "vanilla", generator=torch.Generator().manual_seed(8))
    x = torch.from_numpy(np.random.default_rng(61).standard_normal(
        (b, t, h * dh)).astype(np.float32))
    with torch.inference_mode():
        msa(x)
        (q, k, v), = seen
        assert q.shape == (b, t, h, dh)
        assert q.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
        assert q.stride(-1) == 1
        for i, (got, maps) in enumerate(((q, msa.q_mappings), (k, msa.k_mappings),
                                         (v, msa.v_mappings))):
            want = torch.stack([maps[j](x[..., j * dh:(j + 1) * dh])
                                for j in range(h)], 2)
            assert _maxdiff(got, want) <= TOL, i


@pytest.fixture(scope="module")
def mnist_vanilla():
    sd = _numpy_sd(create_model("vanilla", **MNIST, seed=1))
    x = np.random.default_rng(62).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(sd), x


def test_vanilla_model_matches_kanvit_apply(mnist_vanilla):
    params, x = mnist_vanilla
    want = np.asarray(jax.jit(j_create_model("vanilla", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("vanilla", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    assert _maxdiff(got, want) <= LOGIT_TOL
    assert _launched() == {}


def test_vanilla_converter_matches_torch_compat_bytes(mnist_vanilla):
    params, _ = mnist_vanilla
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k


def test_vanilla_model_gradients_take_the_function_path(monkeypatch):
    """The lanes attention is the vanilla ViT's only kernel: one forward and
    one backward launch per block."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
    monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    model = create_model("vanilla", **SMALL)
    x = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (3, 1, 28, 28)).astype(np.float32))
    model(x).square().sum().backward()
    assert _launched() == {"flash_attention_lanes": 2,
                           "flash_attention_lanes_bwd": 2}
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in model.parameters())


# --- the train step against kanvit's ------------------------------------------

@pytest.fixture(scope="module")
def vanilla_steps():
    return run_steps("vanilla", SMALL, seed=64)


def test_vanilla_train_step_losses_match_kanvit(vanilla_steps):
    check_losses(vanilla_steps)


def test_vanilla_train_step_grads_match_kanvit(vanilla_steps):
    check_grads(vanilla_steps)


def test_vanilla_train_step_params_match_kanvit(vanilla_steps):
    check_params(vanilla_steps)
