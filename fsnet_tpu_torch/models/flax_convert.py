"""Weight bridge: the JAX package's flax variables <-> the port's state_dict.

The inverse of ``fsnet_tpu.models.torch_convert`` for the port's own
modules. ``variables`` is ``{'params': tree, 'batch_stats': tree}`` of
nested mappings whose leaves are arrays (numpy or anything ``np.asarray``
takes); no JAX import is needed. Names map one to one:

* a module scope ``a/b/c`` is the submodule ``a.b.c``; the inner ``bn``
  scope of the JAX ``BatchNorm`` wrapper is dropped;
* ``kernel`` -> ``weight``, transposed HWIO -> OIHW where the port's module
  is a :class:`~fsnet_tpu_torch.models.blocks.Conv` (grouped and dilated
  ones too; the decoder's ``Conv3x3`` keeps HWIO, the layout its kernel
  reads, and the DLA head's grouped deconv its [k, k, 1, C]);
* a module whose flax leaf keeps another name than ``kernel`` says so in
  its ``flax_leaves`` (the deformable conv's own ``weight`` [K, K, Cin,
  Cout] stays ``weight``, HWIO);
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``.

The bridge is strict: every flax leaf is consumed exactly once, every
tensor of the port's state_dict is filled, and shapes must agree.
:func:`to_flax` is the inverse: port tensors by state_dict name (weights,
statistics or gradients) -> the flax tree, for leaf-by-leaf comparisons.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .blocks import BatchNorm, Conv

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "weight"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def torch_key(collection: str, path: Tuple[str, ...]) -> str:
    """The port's state_dict key of the flax leaf ``collection/path``."""
    name = _LEAF.get((collection, path[-1]))
    if name is None:
        raise KeyError(f"no port counterpart for flax leaf "
                       f"{collection}/{'/'.join(path)}")
    scope = list(path[:-1])
    if scope and scope[-1] == "bn":
        scope.pop()
    return ".".join(scope + [name])


def flax_to_state_dict(model: nn.Module,
                       variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map flax ``variables`` onto ``model``'s state_dict keys (CPU tensors
    in the port's dtypes)."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection in variables:
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected flax collection {collection!r}")
        for path, value in _leaves(variables[collection]):
            key = torch_key(collection, path)
            where = f"{collection}/{'/'.join(path)} -> {key}"
            if key in out:
                raise KeyError(f"two flax leaves map to one port tensor: {where}")
            if key not in target:
                raise KeyError(f"the port has no tensor for {where}")
            arr = np.asarray(value)
            module = model.get_submodule(key.rsplit(".", 1)[0])
            if isinstance(module, Conv) and key.endswith(".weight"):
                arr = arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
            if tuple(arr.shape) != tuple(target[key].shape):
                raise ValueError(f"shape {arr.shape} does not fit "
                                 f"{tuple(target[key].shape)}: {where}")
            out[key] = torch.from_numpy(np.array(arr, copy=True)).to(
                target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"flax variables leave port tensors unfilled: {missing}")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax ``variables`` into ``model`` in place (strict)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


_INVERSE = {
    False: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    True: {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")},
}


def flax_path(model: nn.Module, key: str) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of the flax leaf of the port tensor ``key``."""
    scope, leaf = key.rsplit(".", 1)
    module = model.get_submodule(scope)
    is_bn = isinstance(module, BatchNorm)
    collection, name = _INVERSE[is_bn][leaf]
    name = getattr(module, "flax_leaves", {}).get(leaf, name)
    return collection, tuple(scope.split(".")) + (("bn",) if is_bn else ()) \
        + (name,)


def to_flax(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict:
    """Port tensors keyed by ``model``'s state_dict names -> the nested
    ``{collection: tree}`` of numpy arrays in flax's layouts (HWIO
    kernels)."""
    out: Dict = {}
    for key, value in tensors.items():
        collection, path = flax_path(model, key)
        arr = value.detach().cpu().numpy()
        module = model.get_submodule(key.rsplit(".", 1)[0])
        if isinstance(module, Conv) and key.endswith(".weight"):
            arr = arr.transpose(2, 3, 1, 0)            # OIHW -> HWIO
        node = out.setdefault(collection, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    return out
