"""The port's layers and model against kanvit and the executed reference.

Imported weights: each layer must agree to 1e-5 and the logits to 1e-3 with
the executed-reference goldens (``tests/goldens``) and with kanvit's
``model.apply`` on the same params. At init only distributions are compared:
the port draws from a ``torch.Generator``, kanvit from ``jax.random``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from kanvit.layers.attention import MSA as JMSA
from kanvit.layers.kan import KANLinear as JKANLinear
from kanvit.layers.kan import TorchLinear as JTorchLinear
from kanvit.models import create_model as j_create_model
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.layers import MSA, KANLinear, TorchLinear, TransformerBlock
from kanvit_torch.models import VisionTransformer, create_model
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-3
MNIST = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=64, n_heads=2,
             out_d=10)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _run(module, x):
    with torch.inference_mode():
        return module(torch.from_numpy(np.asarray(x))).numpy()


def _prefixed(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# --- executed-reference goldens ---------------------------------------------

@pytest.mark.parametrize("case", ["2", "3"])
def test_kanlinear_golden(case):
    g, sd = load_golden("layer_effkan")
    layer = KANLinear(16, 8)
    load_reference_state_dict(layer, sd)
    assert _maxdiff(_run(layer, g[f"x{case}"]), g[f"y{case}"]) <= LAYER_TOL


def test_msa_golden():
    g, sd = load_golden("msa_efficientkan")
    msa = MSA(16, n_heads=2, type="efficientkan")
    load_reference_state_dict(msa, sd)
    assert _maxdiff(_run(msa, g["x"]), g["y"]) <= LAYER_TOL


def test_model_golden():
    g, sd = load_golden("model_efficientkan")
    model = create_model("efficientkan", **MNIST)
    load_reference_state_dict(model, sd)
    assert _maxdiff(_run(model, g["x"]), g["y"]) <= LOGIT_TOL


# --- against kanvit on the same params --------------------------------------

def _numpy_sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mnist_params():
    """A kanvit efficientkan param tree (MNIST geometry, 2 blocks) and a
    batch of images; the weights are drawn by the port and carried into
    kanvit's tree by ``kanvit.utils.torch_compat``."""
    sd = _numpy_sd(create_model("efficientkan", **MNIST, seed=1))
    x = np.random.default_rng(20).standard_normal((3, 1, 28, 28)).astype(np.float32)
    return params_from_torch_state_dict(sd), x


def test_model_matches_kanvit_apply(mnist_params):
    params, x = mnist_params
    want = np.asarray(jax.jit(j_create_model("efficientkan", **MNIST).apply)(
        {"params": params}, jnp.asarray(x)))
    model = create_model("efficientkan", **MNIST, seed=2)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    assert _maxdiff(_run(model, x), want) <= LOGIT_TOL


@pytest.mark.parametrize("d,heads,t", [(16, 2, 5), (384, 6, 9)])
def test_msa_matches_kanvit(d, heads, t):
    x = np.random.default_rng(21).standard_normal((2, t, d)).astype(np.float32)
    src = MSA(d, n_heads=heads, type="efficientkan",
              generator=torch.Generator().manual_seed(3))
    params = params_from_torch_state_dict(
        _numpy_sd(src, "blocks.0.attn."))["blocks_0"]["attn"]
    want = jax.jit(JMSA(d, n_heads=heads, type="efficientkan").apply)(
        {"params": params}, jnp.asarray(x))
    sd = _prefixed(state_dict_from_jax_params({"blocks_0": {"attn": params}}),
                   "blocks.0.attn.")
    msa = MSA(d, n_heads=heads, type="efficientkan")
    load_reference_state_dict(msa, sd)
    assert _maxdiff(_run(msa, x), want) <= LAYER_TOL


def test_block_matches_kanvit():
    from kanvit.layers.transformer import TransformerBlock as JBlock

    x = np.random.default_rng(22).standard_normal((2, 7, 32)).astype(np.float32)
    src = TransformerBlock(32, 2, feedforward_dim=128, attn_type="efficientkan",
                           generator=torch.Generator().manual_seed(4))
    params = params_from_torch_state_dict(_numpy_sd(src, "blocks.0."))["blocks_0"]
    want = jax.jit(JBlock(32, 2, feedforward_dim=128,
                          attn_type="efficientkan").apply)(
        {"params": params}, jnp.asarray(x))
    sd = _prefixed(state_dict_from_jax_params({"blocks_0": params}), "blocks.0.")
    blk = TransformerBlock(32, 2, feedforward_dim=128, attn_type="efficientkan")
    load_reference_state_dict(blk, sd)
    assert _maxdiff(_run(blk, x), want) <= LAYER_TOL


# --- weights carried across -------------------------------------------------

def test_converter_matches_torch_compat_bytes(mnist_params):
    params, _ = mnist_params
    got = state_dict_from_jax_params(params)
    want = torch_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_state_dict_uses_reference_naming():
    """The port's parameters are exactly the executed reference's, name for
    name and shape for shape (its derived ``grid`` buffers aside)."""
    _, ref = load_golden("model_efficientkan")
    port = create_model("efficientkan", **MNIST).state_dict()
    assert set(port) == {k for k in ref if not k.endswith(".grid")}
    for k, v in port.items():
        assert tuple(v.shape) == ref[k].shape, k


def test_converter_rejects_unported_leaves():
    with pytest.raises(NotImplementedError, match="only the efficientkan"):
        state_dict_from_jax_params({"linear_mapper": {"ln_weight": np.zeros(3)}})
    with pytest.raises(ValueError, match="Unrecognized kanvit param group"):
        state_dict_from_jax_params({"bogus": {}})


def test_load_reference_state_dict_reports_missing():
    g, sd = load_golden("layer_effkan")
    del sd["spline_scaler"]
    with pytest.raises(KeyError, match="missing"):
        load_reference_state_dict(KANLinear(16, 8), sd)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(KANLinear(16, 8), {**load_golden("layer_effkan")[1],
                                                     "extra": np.zeros(1)})


# --- init distributions -----------------------------------------------------

def _kaiming_bound(fan_in, a=math.sqrt(5.0)):
    return math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / fan_in)


@pytest.fixture(scope="module")
def kan_inits():
    nin, nout = 64, 48
    jp = jax.jit(JKANLinear(nin, nout).init)(jax.random.PRNGKey(3),
                                             jnp.zeros((2, nin)))
    tp = KANLinear(nin, nout, generator=torch.Generator().manual_seed(3))
    return nin, jax.tree.map(np.asarray, jp["params"]), {
        k: v.detach().numpy() for k, v in tp.named_parameters()}


@pytest.mark.parametrize("name", ["base_weight", "spline_scaler"])
def test_kanlinear_kaiming_init(kan_inits, name):
    nin, jp, tp = kan_inits
    bound = _kaiming_bound(nin)
    for p in (jp[name], tp[name]):
        assert np.abs(p).max() <= bound
        assert abs(p.mean()) < 0.1 * bound
        assert abs(p.std() - bound / math.sqrt(3.0)) < 0.05 * bound


def test_kanlinear_spline_init(kan_inits):
    _, jp, tp = kan_inits
    j, t = jp["spline_weight"], tp["spline_weight"]
    assert j.shape == t.shape == (48, 64, 8)
    # both are lstsq fits to U(-0.01, 0.01) noise
    assert abs(t.std() / j.std() - 1.0) < 0.1
    assert abs(t.mean()) < 0.1 * t.std() and abs(j.mean()) < 0.1 * j.std()
    assert np.abs(t).max() < 0.05 and np.abs(j).max() < 0.05


def test_torchlinear_and_class_token_init():
    nin, nout = 96, 128
    jp = jax.tree.map(np.asarray, jax.jit(JTorchLinear(nin, nout).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, nin)))["params"])
    tp = TorchLinear(nin, nout, generator=torch.Generator().manual_seed(4))
    wb, bb = _kaiming_bound(nin), 1.0 / math.sqrt(nin)
    for w, b in ((jp["weight"], jp["bias"]),
                 (tp.weight.detach().numpy(), tp.bias.detach().numpy())):
        assert w.shape == (nout, nin) and b.shape == (nout,)
        assert np.abs(w).max() <= wb and np.abs(b).max() <= bb
        assert abs(w.std() - wb / math.sqrt(3.0)) < 0.05 * wb
    v = create_model("efficientkan", chw=(1, 28, 28), n_patches=7, n_blocks=1,
                     d_hidden=512, n_heads=2, out_d=10).v_class.detach().numpy()
    assert abs(v.std() - 1.0) < 0.15 and abs(v.mean()) < 0.15


def test_create_model_is_seeded():
    a = create_model("efficientkan", **MNIST, seed=5).state_dict()
    b = create_model("efficientkan", **MNIST, seed=5).state_dict()
    c = create_model("efficientkan", **MNIST, seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["v_class"], c["v_class"])


# --- what is not ported yet, and gradients ------------------------------------

def test_unknown_kinds_raise():
    with pytest.raises(ValueError, match="invalid. Please use a different argument"):
        MSA(16, 2, type="bogus")
    with pytest.raises(ValueError, match="Unknown transformer type"):
        VisionTransformer((1, 28, 28), type="bogus")


@pytest.mark.parametrize("kind", ["vanilla", "fast", "sine", "cheby", "fourier",
                                  "flash-attn"])
def test_unported_msa_kinds_raise(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MSA(16, 2, type=kind)


@pytest.mark.parametrize("kind", ["vanilla", "fast", "sine", "fourier", "cheby"])
def test_unported_variants_raise(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_model(kind, **MNIST)


def test_forward_carries_gradients():
    """With grad enabled the forward keeps its graph: every parameter gets a
    finite gradient (on the CPU, autograd through the plain versions)."""
    model = create_model("efficientkan", **MNIST)
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (2, 1, 28, 28)).astype(np.float32))
    model(x).logsumexp(-1).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.isfinite().all()), name
    assert float(model.linear_mapper.base_weight.grad.abs().max()) > 0
