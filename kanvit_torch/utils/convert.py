"""Weights carried across from kanvit (JAX) to the port.

The port's parameter names are the reference naming that
``kanvit/utils/torch_compat.py:159-222`` emits (``linear_mapper.spline_weight``,
``blocks.0.attn.q_mappings.3.base_weight``, ``mlp_head.1.weight``, ...), so a
kanvit param tree converted here, ``torch_compat``'s ``.npz`` and the
executed-reference goldens all load with :func:`load_reference_state_dict`.

:func:`state_dict_from_jax_params` is numpy only: it needs no jax, and
takes the param tree as nested dicts of numpy arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# Leaves of the layers the port builds: TorchLinear (weight, bias),
# KANLinear (bare Parameters, plus the knot grid of stateful-grid trees),
# ChebyKANLayer, FourierKANLayer, FastKANLayer and SineKANLayer.
_LEAVES = ("weight", "bias", "base_weight", "spline_weight", "spline_scaler",
           "grid", "cheby_coeffs", "fouriercoeffs", "ln_weight", "ln_bias",
           "base_bias", "freq", "amplitudes")
# FastKAN keeps its weights in the reference's LayerNorm and Linear
# submodules (kanvit/utils/torch_compat.py:33-39); a FastKAN layer is told
# apart from a KANLinear, whose base_weight and spline_weight are bare
# Parameters, by its ln_weight sibling.
_FASTKAN_NAMES = {"ln_weight": "layernorm.weight", "ln_bias": "layernorm.bias",
                  "spline_weight": "spline_linear.weight",
                  "base_weight": "base_linear.weight",
                  "base_bias": "base_linear.bias"}
# Reference entries the port derives instead of loading: the knot grids and
# RBF centres, ChebyKAN's ``arange`` buffer, SineKAN's phase table and the
# positional table.
_BUFFERS = re.compile(r"(.*\.)?(grid|arange|phase|pos_embeddings)")


def _leaf(path: str, leaf: str, siblings) -> str:
    if leaf not in _LEAVES:
        raise NotImplementedError(
            f"{path}.{leaf}: not a leaf of any layer the port builds {_LEAVES}")
    return _FASTKAN_NAMES.get(leaf, leaf) if "ln_weight" in siblings else leaf


def _shaped(leaf: str, arr, siblings) -> np.ndarray:
    """SineKAN's freq is ``(G,)`` in kanvit and ``(1, 1, 1, G)`` in the
    reference and the port; FourierKAN's and SineKAN's bias ``(out,)`` and
    ``(1, out)``, told apart from a Linear bias by a ``fouriercoeffs`` or
    ``freq`` sibling (``kanvit/utils/torch_compat.py::_unshape_leaf``)."""
    arr = np.asarray(arr)
    if leaf == "freq":
        return arr.reshape(1, 1, 1, -1)
    if leaf == "bias" and arr.ndim == 1 and (
            "fouriercoeffs" in siblings or "freq" in siblings):
        return arr.reshape(1, -1)
    return arr


def state_dict_from_jax_params(params: Mapping) -> Dict[str, np.ndarray]:
    """kanvit ``params`` tree -> the port's ``{name: np.ndarray}`` state_dict.

    Per-head stacked ``(n_heads, ...)`` q/k/v params unstack into the
    reference's per-head ``ModuleList`` entries; flax LayerNorm
    ``scale``/``bias`` become ``weight``/``bias``; FastKAN's leaves take the
    reference's submodule names; FourierKAN's and SineKAN's bias become
    ``(1, out)`` and SineKAN's freq ``(1, 1, 1, G)``. Same output as
    ``kanvit.utils.torch_compat.torch_state_dict_from_params`` on a tree of
    any ViT variant. A ``CausalDecoder`` tree (``embed``, ``blocks_N``,
    ``norm``, ``lm_head``) maps to ``CausalDecoder``'s names.
    """
    sd: Dict[str, np.ndarray] = {}

    def emit(key: str, arr) -> None:
        sd[key] = np.asarray(arr)

    for top, sub in params.items():
        if top == "v_class":
            emit("v_class", sub)
        elif top == "embed":
            emit("embed.weight", sub["embedding"])
        elif top in ("linear_mapper", "lm_head"):
            for leaf, arr in sub.items():
                emit(f"{top}.{_leaf(top, leaf, sub)}", _shaped(leaf, arr, sub))
        elif top in ("head_norm", "norm"):
            name = "mlp_head.0" if top == "head_norm" else top
            emit(f"{name}.weight", sub["scale"])
            emit(f"{name}.bias", sub["bias"])
        elif top == "head_linear":
            emit("mlp_head.1.weight", sub["weight"])
            emit("mlp_head.1.bias", sub["bias"])
        elif m := re.fullmatch(r"blocks_(\d+)", top):
            blk = m.group(1)
            for name, node in sub.items():
                if name in ("norm1", "norm2"):
                    emit(f"blocks.{blk}.{name}.weight", node["scale"])
                    emit(f"blocks.{blk}.{name}.bias", node["bias"])
                elif name in ("ff_0", "ff_2"):
                    for leaf, arr in node.items():
                        emit(f"blocks.{blk}.ff.{name[-1]}.{_leaf(name, leaf, node)}",
                             arr)
                elif name in ("to_q", "to_kv", "to_out"):
                    for leaf, arr in node.items():
                        emit(f"blocks.{blk}.{name}.{_leaf(name, leaf, node)}", arr)
                elif name == "attn":
                    for proj, leaves in node.items():
                        n_heads = len(next(iter(leaves.values())))
                        for leaf, stacked in leaves.items():
                            stacked = np.asarray(stacked)
                            name = _leaf(proj, leaf, leaves)
                            for h in range(n_heads):
                                emit(f"blocks.{blk}.attn.{proj}.{h}.{name}",
                                     _shaped(leaf, stacked[h], leaves))
                else:
                    raise ValueError(
                        f"Unrecognized kanvit block param: blocks_{blk}.{name}")
        else:
            raise ValueError(f"Unrecognized kanvit param group: {top}")
    return sd


def load_reference_state_dict(module: torch.nn.Module,
                              state_dict: Mapping[str, np.ndarray]) -> None:
    """Copy a reference-named numpy state_dict into ``module`` in place.

    Loads with ``strict=False`` so the derived buffers the reference also
    saves (``*.grid``, ``*.arange``, ``*.phase``, ``pos_embeddings``) are
    skipped, then
    raises if any parameter was left unloaded or any other entry was not
    recognized.
    """
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
    result = module.load_state_dict(tensors, strict=False)
    unexpected = [k for k in result.unexpected_keys if not _BUFFERS.fullmatch(k)]
    if result.missing_keys or unexpected:
        raise KeyError(f"state_dict mismatch: missing {result.missing_keys}, "
                       f"unexpected {unexpected}")
