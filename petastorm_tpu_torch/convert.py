"""Weights of the flax ResNet and MLP <-> state_dicts of the torch modules.

Maps every leaf of ``{"params": ..., "batch_stats": ...}`` (nested dicts of
numpy arrays, as ``flax.linen`` ``init``/``apply`` use them) onto
:class:`petastorm_tpu_torch.models.ResNet`, all float32:

* conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in);
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  keep their names.

Every leaf is consumed exactly once: a leaf with no torch counterpart, or two
leaves landing on one key, raises.  Loading the result with
``load_state_dict(strict=True)`` then catches leaves the flax tree lacks.
:func:`flax_from_resnet_state` is the inverse.  :func:`mlp_state_from_flax`
and :func:`flax_from_mlp_state` do the same for
:class:`petastorm_tpu_torch.models.MLP`: flax's ``Dense_i`` is ``dense.i``,
its ``(in, out)`` kernel the transpose of the ``(out, in)`` weight.
:func:`long_context_params_from_jax` and :func:`jax_from_long_context_params`
carry the long-context example's ``{"embed": (vocab, d_model), "out":
(d_model, vocab)}`` between the two packages, in the same layout.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_BN_LEAVES = {"scale": "params", "bias": "params", "mean": "batch_stats",
              "var": "batch_stats"}


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_name(path: Tuple[str, ...]) -> str:
    """Flax module path -> torch module name (``BottleneckBlock_3/Conv_1`` -> ``blocks.3.conv1``)."""
    out = []
    for part in path:
        m = re.fullmatch(r"(BottleneckBlock|Conv|BatchNorm|Dense)_(\d+)", part)
        if m is None:
            if part not in ("conv_init", "bn_init", "conv_proj", "norm_proj"):
                raise KeyError(f"flax module {'/'.join(path)!r} has no torch counterpart")
            out.append(part)
        elif m.group(1) == "BottleneckBlock":
            out.append(f"blocks.{m.group(2)}")
        elif m.group(1) == "Dense":
            if m.group(2) != "0":
                raise KeyError(f"flax module {'/'.join(path)!r} has no torch counterpart")
            out.append("dense")
        else:
            out.append(("conv" if m.group(1) == "Conv" else "bn") + m.group(2))
    return ".".join(out)


def resnet_state_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Convert flax ResNet variables (numpy leaves) to a torch ResNet state_dict."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            module, leaf_name = _module_name(path[:-1]), path[-1]
            arr = np.asarray(leaf, dtype=np.float32)
            if (collection, leaf_name) == ("params", "kernel"):
                is_dense = module == "dense"
                if arr.ndim != (2 if is_dense else 4):
                    raise ValueError(f"{'/'.join(path)}: unexpected kernel shape {arr.shape}")
                key = module + ".weight"
                arr = arr.T if is_dense else arr.transpose(3, 2, 0, 1)
            elif module == "dense" and (collection, leaf_name) == ("params", "bias"):
                key = "dense.bias"
            elif _BN_LEAVES.get(leaf_name) == collection:
                key = f"{module}.{leaf_name}"
            else:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no torch counterpart")
            if key in state:
                raise KeyError(f"two flax leaves map to {key!r}")
            state[key] = torch.from_numpy(np.array(arr, order="C", copy=True))
    for collection in variables:
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"flax collection {collection!r} has no torch counterpart")
    return state


def _flax_path(module: str) -> Tuple[str, ...]:
    """Torch module name -> flax module path (``blocks.3.conv1`` -> ``BottleneckBlock_3/Conv_1``)."""
    out = []
    parts = module.split(".")
    while parts:
        part = parts.pop(0)
        if part == "blocks":
            out.append(f"BottleneckBlock_{parts.pop(0)}")
        elif part == "dense":
            out.append("Dense_0")
        elif part in ("conv_init", "bn_init", "conv_proj", "norm_proj"):
            out.append(part)
        else:
            m = re.fullmatch(r"(conv|bn)(\d+)", part)
            if m is None:
                raise KeyError(f"torch module {module!r} has no flax counterpart")
            out.append(("Conv" if m.group(1) == "conv" else "BatchNorm") + f"_{m.group(2)}")
    return tuple(out)


def flax_from_resnet_state(state: Dict[str, torch.Tensor]) -> Dict:
    """Convert a torch ResNet state_dict to flax variables: ``{"params": ...,
    "batch_stats": ...}`` of nested dicts of float32 numpy arrays."""
    variables: Dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state.items():
        module, leaf_name = key.rsplit(".", 1)
        arr = tensor.detach().cpu().float().numpy()
        if leaf_name == "weight":
            collection, leaf_name = "params", "kernel"
            arr = arr.T if module == "dense" else arr.transpose(2, 3, 1, 0)
        elif module == "dense" and leaf_name == "bias":
            collection = "params"
        elif leaf_name in _BN_LEAVES:
            collection = _BN_LEAVES[leaf_name]
        else:
            raise KeyError(f"torch leaf {key!r} has no flax counterpart")
        node = variables[collection]
        for part in _flax_path(module):
            node = node.setdefault(part, {})
        node[leaf_name] = np.ascontiguousarray(arr)
    return variables


def mlp_state_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Convert flax MLP params (``{"params": {"Dense_i": {"kernel", "bias"}}}``
    or the inner dict; numpy leaves) to a torch MLP state_dict."""
    params = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        m = re.fullmatch(r"Dense_(\d+)", name)
        if m is None or set(leaves) != {"kernel", "bias"}:
            raise KeyError(f"flax MLP leaf {name!r} has no torch counterpart")
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        if kernel.ndim != 2:
            raise ValueError(f"{name}/kernel: unexpected shape {kernel.shape}")
        state[f"dense.{m.group(1)}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        state[f"dense.{m.group(1)}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], dtype=np.float32, copy=True))
    return state


def flax_from_mlp_state(state: Dict[str, torch.Tensor]) -> Dict:
    """Convert a torch MLP state_dict to flax variables ``{"params":
    {"Dense_i": {"kernel", "bias"}}}`` of float32 numpy arrays."""
    params: Dict = {}
    for key, tensor in state.items():
        m = re.fullmatch(r"dense\.(\d+)\.(weight|bias)", key)
        if m is None:
            raise KeyError(f"torch MLP leaf {key!r} has no flax counterpart")
        arr = tensor.detach().cpu().float().numpy()
        leaf = "kernel" if m.group(2) == "weight" else "bias"
        params.setdefault(f"Dense_{m.group(1)}", {})[leaf] = np.ascontiguousarray(
            arr.T if leaf == "kernel" else arr)
    return {"params": params}


_LONG_CONTEXT_LEAVES = ("embed", "out")


def long_context_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX long-context example's params (``examples/long_context/
    train_ring_attention.py:49-52``) as float32 torch tensors of
    ``examples.long_context.train_ring_attention_cuda``, in the same layout."""
    if set(params) != set(_LONG_CONTEXT_LEAVES):
        raise ValueError(f"expected leaves {_LONG_CONTEXT_LEAVES}, got {sorted(params)}")
    return {name: torch.from_numpy(np.array(params[name], dtype=np.float32))
            for name in _LONG_CONTEXT_LEAVES}


def jax_from_long_context_params(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`long_context_params_from_jax`: numpy float32 leaves."""
    if set(params) != set(_LONG_CONTEXT_LEAVES):
        raise ValueError(f"expected leaves {_LONG_CONTEXT_LEAVES}, got {sorted(params)}")
    return {name: params[name].detach().cpu().numpy().astype(np.float32)
            for name in _LONG_CONTEXT_LEAVES}
