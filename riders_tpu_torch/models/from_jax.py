"""Load the JAX package's variables into the port's models.

The port's module and attribute names mirror the flax parameter tree,
so a flax path maps to a torch state-dict key by joining its names with
dots and renaming the leaf:

* conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw)
  (a depthwise (kh, kw, 1, C) kernel lands as (C, 1, kh, kw));
* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* BatchNorm / LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

With the model given (as `load_jax_variables` always gives it), the
rule for a leaf is chosen by the type of the torch module that owns it,
which its name alone cannot tell:

* a ConvTranspose2d ``kernel`` (kh, kw, in, out), which flax correlates
  unflipped, -> ``weight`` (in, out, kh, kw) flipped in space (an
  in == out kernel has the same shape either way);
* a Linear ``kernel`` of flax attention, (C, heads, hd) or (heads, hd,
  C), -> (out, in) after flattening the head axes; its (heads, hd) bias
  is flattened;
* any other leaf name is a raw parameter of the owner, copied as it is,
  or transposed when the owner lists it in ``JAX_TRANSPOSED`` (BEiT's
  ``qkv_kernel``, used as x @ W in flax and as a Linear weight here).

Variables arrive as nested dicts of numpy arrays (``jax.device_get`` of
the flax variables); a gradient tree shaped like `params` maps the same
way (`torch_state_from_jax({"params": grads})`), so gradients can be
held against `param.grad` by key.  Nothing here imports JAX.  A leaf the
model does not have, or a model tensor no leaf fills, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RCNetConfig, SMLConfig
from riders_tpu_torch.models.dpt import DPTConfig, DPTScaleMapLearner
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


def _kernel(arr: np.ndarray, owner: Optional[nn.Module]) -> np.ndarray:
    if isinstance(owner, nn.ConvTranspose2d):
        return np.ascontiguousarray(arr[::-1, ::-1].transpose(2, 3, 0, 1))
    if isinstance(owner, nn.Linear) and arr.ndim != 2:
        return arr.reshape(owner.in_features, owner.out_features).T
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def torch_state_from_jax(variables: Mapping[str, Any],
                         module: Optional[nn.Module] = None
                         ) -> Dict[str, np.ndarray]:
    """Flax `params` and `batch_stats` -> {torch key: array in torch
    layout}.  Without `module`, raw parameters raise and every kernel
    takes the conv / Linear rule."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    owners = dict(module.named_modules()) if module is not None else {}
    state: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            *modules, leaf = path
            owner = owners.get(".".join(modules))
            arr = np.asarray(value)
            if leaf not in _LEAF:
                if owner is None:
                    raise KeyError(f"unknown leaf {'/'.join(path)}")
                if leaf in getattr(owner, "JAX_TRANSPOSED", ()):
                    arr = arr.T
                state[".".join(path)] = arr
                continue
            if leaf == "kernel":
                arr = _kernel(arr, owner)
            elif (leaf == "bias" and isinstance(owner, nn.Linear)
                  and arr.ndim != 1):
                arr = arr.reshape(-1)
            state[".".join(modules + [_LEAF[leaf]])] = arr
    return state


@torch.no_grad()
def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Any]) -> nn.Module:
    """Copy JAX variables into `module`; every leaf must be used and
    every parameter and BN statistic filled, with matching shapes."""
    return load_state(module, torch_state_from_jax(variables, module))


@torch.no_grad()
def load_state(module: nn.Module, state: Mapping[str, Any]) -> nn.Module:
    """Copy {torch key: array} into `module`'s parameters and buffers
    (BatchNorm's step counters aside): every key must be used and every
    tensor filled, with matching shapes."""
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


def dpt_from_jax(config: DPTConfig, variables: Mapping[str, Any],
                 device=None, dtype: torch.dtype = torch.float32
                 ) -> DPTScaleMapLearner:
    """A DPTScaleMapLearner holding the JAX model's variables."""
    return load_jax_variables(DPTScaleMapLearner(config, device, dtype),
                              variables)
