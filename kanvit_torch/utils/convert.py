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

# Leaves of the layers the port builds, named alike in kanvit and the
# reference: TorchLinear (weight, bias) and KANLinear (bare Parameters, plus
# the knot grid of stateful-grid trees).
_LEAVES = ("weight", "bias", "base_weight", "spline_weight", "spline_scaler",
           "grid")
# Reference entries the port derives instead of loading (non-persistent
# buffers): the knot grids and the positional table.
_BUFFERS = re.compile(r"(.*\.)?(grid|pos_embeddings)")


def _leaf(path: str, leaf: str) -> str:
    if leaf not in _LEAVES:
        raise NotImplementedError(
            f"{path}.{leaf}: only the efficientkan/Linear leaves {_LEAVES} "
            "are ported (ROADMAP.md, Queue 1)"
        )
    return leaf


def state_dict_from_jax_params(params: Mapping) -> Dict[str, np.ndarray]:
    """kanvit ``params`` tree -> the port's ``{name: np.ndarray}`` state_dict.

    Per-head stacked ``(n_heads, ...)`` q/k/v params unstack into the
    reference's per-head ``ModuleList`` entries; flax LayerNorm
    ``scale``/``bias`` become ``weight``/``bias``. Same output as
    ``kanvit.utils.torch_compat.torch_state_dict_from_params`` on an
    efficientkan or flash-attn tree. A ``CausalDecoder`` tree (``embed``,
    ``blocks_N``, ``norm``, ``lm_head``) maps to ``CausalDecoder``'s names.
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
                emit(f"{top}.{_leaf(top, leaf)}", arr)
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
                        emit(f"blocks.{blk}.ff.{name[-1]}.{_leaf(name, leaf)}", arr)
                elif name in ("to_q", "to_kv", "to_out"):
                    for leaf, arr in node.items():
                        emit(f"blocks.{blk}.{name}.{_leaf(name, leaf)}", arr)
                elif name == "attn":
                    for proj, leaves in node.items():
                        n_heads = len(next(iter(leaves.values())))
                        for leaf, stacked in leaves.items():
                            stacked = np.asarray(stacked)
                            _leaf(proj, leaf)
                            for h in range(n_heads):
                                emit(f"blocks.{blk}.attn.{proj}.{h}.{leaf}",
                                     stacked[h])
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
    saves (``*.grid``, ``pos_embeddings``) are skipped, then raises if any
    parameter was left unloaded or any other entry was not recognized.
    """
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
    result = module.load_state_dict(tensors, strict=False)
    unexpected = [k for k in result.unexpected_keys if not _BUFFERS.fullmatch(k)]
    if result.missing_keys or unexpected:
        raise KeyError(f"state_dict mismatch: missing {result.missing_keys}, "
                       f"unexpected {unexpected}")
