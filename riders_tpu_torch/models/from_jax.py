"""Load the JAX package's variables into the port's models.

The port's module and attribute names mirror the flax parameter tree,
so a flax path maps to a torch state-dict key by joining its names with
dots and renaming the leaf:

* conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw)
  (a depthwise (kh, kw, 1, C) kernel lands as (C, 1, kh, kw));
* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* BatchNorm / LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

Variables arrive as nested dicts of numpy arrays (``jax.device_get`` of
the flax variables); a gradient tree shaped like `params` maps the same
way (`torch_state_from_jax({"params": grads})`), so gradients can be
held against `param.grad` by key.  Nothing here imports JAX.  A leaf the
model does not have, or a model tensor no leaf fills, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RCNetConfig, SMLConfig
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def torch_state_from_jax(variables: Mapping[str, Any]
                         ) -> Dict[str, np.ndarray]:
    """Flax `params` and `batch_stats` -> {torch key: array in torch
    layout}."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    state: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            *modules, leaf = path
            if leaf not in _LEAF:
                raise KeyError(f"unknown leaf {'/'.join(path)}")
            arr = np.asarray(value)
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            state[".".join(modules + [_LEAF[leaf]])] = arr
    return state


@torch.no_grad()
def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Any]) -> nn.Module:
    """Copy JAX variables into `module`; every leaf must be used and
    every parameter and BN statistic filled, with matching shapes."""
    state = torch_state_from_jax(variables)
    own = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"missing: {missing[:10]}; unused: {unused[:10]}")
    for key, dst in own.items():
        src = torch.from_numpy(np.array(state[key], copy=True))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                             f"match {tuple(dst.shape)}")
        dst.copy_(src)
    return module


def rcnet_from_jax(config: RCNetConfig, variables: Mapping[str, Any],
                   device=None, dtype: torch.dtype = torch.float32) -> RCNet:
    """An RCNet holding the JAX RCNet's variables."""
    return load_jax_variables(RCNet(config, device, dtype), variables)


def sml_from_jax(config: SMLConfig, variables: Mapping[str, Any],
                 device=None, dtype: torch.dtype = torch.float32,
                 **backbone) -> ScaleMapLearner:
    """A ScaleMapLearner holding the JAX model's variables; `backbone`
    passes backbone_stages / backbone_taps / backbone_stem."""
    return load_jax_variables(
        ScaleMapLearner(config, device, dtype, **backbone), variables)
