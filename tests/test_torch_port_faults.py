"""The port's two recorded faults, repaired, against kanvit.

- Head dims: the lanes and tiled attention take every multiple of 8 from 8
  through 128, as kanvit's lanes tier takes any dh % 8 == 0, and refuse the
  rest. The reference trains at d 64 with 8 heads (dh 8): a block there
  matches kanvit's (its Pallas kernels in interpret mode) on the plain path
  and on the CUDA path's Functions with each launch emulated
  (``kernel_math``).
- Refit grids: a stateful-grid kanvit tree whose knots moved (per head,
  per projection) converts, loads its grids and gives kanvit's logits;
  an efficientkan MSA with unequal grids projects per projection, a grid per
  head, and one grouped launch a block where they are equal.

f32 on the CPU; inputs from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.layers.transformer import TransformerBlock as JBlock
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.utils.torch_compat import params_from_torch_state_dict
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.layers import MSA, TransformerBlock
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_kernels import _emu_basis, _emu_lanes_bwd, _emu_lanes_fwd

TOL = 1e-5
LOGIT_TOL = 1e-3
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FB.reset_launches()
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _emu_group_basis(family, x2d, w, aux):
    """Each group's ``(values, x-derivatives)``, ``(N, G, nin, S)``, on its
    own knot grid (``aux (G, nin, 12)``) or on the shared one."""
    groups, _, nin, _ = w.shape
    grids = aux if aux.dim() == 3 else aux.expand(groups, *aux.shape)
    pairs = [_emu_basis(family, x2d[:, g * nin:(g + 1) * nin], grids[g])
             for g in range(groups)]
    return (torch.stack([p[0] for p in pairs], 1),
            torch.stack([p[1] for p in pairs], 1))


def _emu_fwd(name, family, x2d, w, aux):
    """The forward kernels' arithmetic on the CPU, a knot grid a group."""
    FB._check(family, x2d, w, aux)
    n, (groups, _, _, out) = x2d.shape[0], w.shape
    basis, _ = _emu_group_basis(family, x2d, w, aux)
    FB.LAUNCHES[name] += 1
    return torch.einsum("ngis,gsio->ngo", basis, w).reshape(n, groups * out)


def _emu_bwd(name, family, x2d, w, aux, gy, need_dx, need_dw):
    """The backward kernels' arithmetic on the CPU, a knot grid a group:
    dx = sum_s B'_s (gy W_s^T), dW = B^T gy."""
    FB._check(family, x2d, w, aux)
    n, (groups, _, _, out) = x2d.shape[0], w.shape
    basis, deriv = _emu_group_basis(family, x2d, w, aux)
    gyg = gy.reshape(n, groups, out)
    dx = (torch.einsum("ngo,gsio->ngis", gyg, w) * deriv).sum(-1).reshape(n, -1)
    dw = torch.einsum("ngis,ngo->gsio", basis, gyg)
    FB.LAUNCHES[name] += 1
    return (dx if need_dx else None), (dw if need_dw else None)


@pytest.fixture(params=["plain", "kernel_math"])
def path(request, monkeypatch):
    """``plain``: the CPU path. ``kernel_math``: the CUDA path's Functions
    with each launch emulated on the CPU."""
    if request.param == "kernel_math":
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(FB, "_launch", _emu_fwd)
        monkeypatch.setattr(FB, "_launch_bwd", _emu_bwd)
        monkeypatch.setattr(FA, "_launch", _emu_lanes_fwd)
        monkeypatch.setattr(FA, "_launch_bwd", _emu_lanes_bwd)
    return request.param


# --- head dims ----------------------------------------------------------------

@pytest.mark.parametrize("dh", [8, 24, 40, 128])
def test_attention_wrappers_take_head_dims(dh):
    q = torch.zeros(2, 5, 3 * dh)
    assert FA.check_args(q, q, q, 3, None)[0].shape == (2, 5, 3, dh)
    t = torch.zeros(2, 3, 7, dh)
    FA.check_flash_args(t, t, t, None)


@pytest.mark.parametrize("dh", [4, 12, 136])
def test_attention_wrappers_refuse_other_head_dims(dh):
    q = torch.zeros(2, 5, 2 * dh)
    with pytest.raises(ValueError, match="multiple of 8 from 8 through 128"):
        FA.check_args(q, q, q, 2, None)
    t = torch.zeros(2, 2, 7, dh)
    with pytest.raises(ValueError, match="head dim"):
        FA.check_flash_args(t, t, t, None)


@pytest.mark.parametrize("dh", [8, 24, 40, 128])
def test_lanes_attention_head_dims_kernel_math(path, dh):
    """The lanes wrapper, forward and backward, at each head dim against the
    plain version (the kernel_math case runs ``_LanesFn``)."""
    from kanvit_torch.ops import attention as A

    rng = np.random.default_rng(120 + dh)
    y = torch.from_numpy(rng.standard_normal((2 * 9, 2 * 3 * dh)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 9, 2 * dh)).astype(np.float32))

    def run(attn):
        leaf = y.clone().requires_grad_(True)
        y4 = leaf.view(2, 9, 2, 3 * dh)
        o = attn(*(y4[..., i * dh:(i + 1) * dh] for i in range(3)), 2, causal=True)
        return o.detach(), torch.autograd.grad(o, leaf, g)[0]

    got, want = run(FA.flash_attention_lanes), run(A.lanes_attention)
    assert _maxdiff(got[0], want[0]) <= TOL and _maxdiff(got[1], want[1]) <= TOL
    assert FA.LAUNCHES["flash_attention_lanes_bwd"] == (path == "kernel_math")


@pytest.mark.parametrize("attn_type", ["efficientkan", "vanilla"])
def test_reference_geometry_block_matches_kanvit(path, attn_type):
    """d 64 with 8 heads (dh 8, the reference's training geometry; the
    grouped KAN projection's nin 8) against kanvit's block."""
    x = np.random.default_rng(121).standard_normal((2, 17, 64)).astype(np.float32)
    src = TransformerBlock(64, 8, feedforward_dim=256, attn_type=attn_type,
                           generator=torch.Generator().manual_seed(5))
    params = params_from_torch_state_dict(
        {"blocks.0." + k: v.numpy() for k, v in src.state_dict().items()})["blocks_0"]
    want = JBlock(64, 8, feedforward_dim=256, attn_type=attn_type).apply(
        {"params": params}, jnp.asarray(x))
    blk = TransformerBlock(64, 8, feedforward_dim=256, attn_type=attn_type)
    sd = state_dict_from_jax_params({"blocks_0": params})
    load_reference_state_dict(blk, {k[len("blocks.0."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = blk(torch.from_numpy(x))
    assert _maxdiff(got, want) <= TOL
    assert FA.LAUNCHES["flash_attention_lanes"] == (path == "kernel_math")


# --- refit grids --------------------------------------------------------------

def _moved(params, rng):
    """Each KANLinear grid of a kanvit tree scaled and shifted per feature
    (and so per head and projection), and the spline coefficients, which
    init draws near 0, scaled up as training grows them."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _moved(v, rng)
        elif k == "grid":
            lead = v.shape[:-1] + (1,)
            out[k] = (v * rng.uniform(0.7, 1.4, lead)
                      + rng.uniform(-0.4, 0.4, lead)).astype(np.float32)
        elif k == "spline_weight":
            out[k] = v * np.float32(30.0)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def refit_tree():
    """A stateful-grid kanvit efficientkan tree with moved grids, images,
    and kanvit's logits on it."""
    model = j_create_model("efficientkan", stateful_grid=True, **SMALL)
    x = np.random.default_rng(122).standard_normal((3, 1, 28, 28)).astype(np.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(6),
                                                 jnp.asarray(x))["params"])
    params = _moved(params, np.random.default_rng(123))
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    return params, x, want


def test_stateful_grid_tree_matches_kanvit(path, refit_tree):
    """The grids load (the embedder's and each head's q, k, v) and the
    logits are kanvit's; the MSA projects per projection, one grouped
    launch each, three a block."""
    params, x, want = refit_tree
    model = create_model("efficientkan", **SMALL, seed=3)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    np.testing.assert_array_equal(
        model.blocks[1].attn.k_mappings[1].grid.numpy(),
        params["blocks_1"]["attn"]["k_mappings"]["grid"][1])
    np.testing.assert_array_equal(model.linear_mapper.grid.numpy(),
                                  params["linear_mapper"]["grid"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _maxdiff(got, want) <= LOGIT_TOL
    assert not model.blocks[0].attn.grids_equal()
    assert FB.LAUNCHES["bspline_qkv_grouped"] == (3 * 2 if path == "kernel_math" else 0)


def test_stateful_grid_tree_without_its_grids_differs(refit_tree):
    """What the loader did before: the same tree with its grids dropped
    computes on the uniform grids, over ten times the logit gate away."""
    params, x, want = refit_tree
    model = create_model("efficientkan", **SMALL, seed=3)
    sd = {k: v for k, v in state_dict_from_jax_params(params).items()
          if not k.endswith(".grid")}
    load_reference_state_dict(model, sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _maxdiff(got, want) > 10 * LOGIT_TOL


def test_refit_grid_gradients_match_plain(path):
    """Training through per-head grids: the CUDA path's Functions give the
    plain path's gradients."""
    msa = MSA(32, 2, "efficientkan", generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(124)
    with torch.no_grad():
        for maps in (msa.q_mappings, msa.k_mappings, msa.v_mappings):
            for m in maps:
                m.grid.mul_(float(rng.uniform(0.8, 1.3))).add_(float(rng.uniform(-.3, .3)))
    x = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))

    def grads():
        leaf = x.clone().requires_grad_(True)
        out = msa(leaf)
        params = list(msa.parameters())
        return [out.detach(), *torch.autograd.grad(out, [leaf, *params], g)]

    got = grads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "use_kernel", lambda x: False)
        want = grads()
    for a, b in zip(got, want):
        assert _maxdiff(a, b) <= TOL * max(1.0, float(b.abs().max()))
    assert FB.LAUNCHES["bspline_qkv_grouped_bwd"] == (3 if path == "kernel_math" else 0)


def test_grids_equal_follows_writes():
    """One grouped launch a block while the 3H grids are equal; a write to
    any grid is seen (its version counter) and undone likewise."""
    msa = MSA(32, 2, "efficientkan")
    assert msa.grids_equal()
    grid = msa.v_mappings[1].grid
    saved = grid.clone()
    with torch.no_grad():
        grid[0, 0] -= 0.5
    assert not msa.grids_equal()
    with torch.no_grad():
        grid.copy_(saved)
    assert msa.grids_equal()
    with torch.inference_mode():
        inf = MSA(32, 2, "efficientkan")
        assert inf.grids_equal()


def test_loader_refuses_a_grid_of_another_shape():
    model = create_model("efficientkan", **SMALL)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["blocks.0.attn.q_mappings.0.grid"] = np.zeros((16, 13), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        load_reference_state_dict(model, sd)
    sd["blocks.0.attn.q_mappings.0.grid"] = np.zeros((16, 12), np.float32)
    sd["linear_mapper.nonsense.grid"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(model, sd)
