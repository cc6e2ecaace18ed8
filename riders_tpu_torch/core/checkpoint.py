"""Checkpoints of training states and weights, with torch.save.

One step-indexed layout for both stages:

    <dir>/<step>/state.pt   - model (parameters and BatchNorm
                              statistics), optimizer, scheduler, step

`save_train_state` / `restore_train_state` round-trip a TrainState (the
restore fills a template state in place); `restore_model` loads only the
model of a step, as the validation sweeps do; `save_params` /
`restore_params` keep weights only; `all_steps` lists the saved steps
and `latest_step` finds the resume point.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, List, Mapping, Optional

import torch
import torch.nn as nn

STATE_FILE = "state.pt"


def all_steps(directory) -> List[int]:
    """The steps saved under `directory`, ascending ([] if none)."""
    root = Path(directory)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def _atomic_save(obj: Any, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(directory, state, max_to_keep: Optional[int] = None
                     ) -> Path:
    """Save `state` under <directory>/<state.step>/; with `max_to_keep`,
    delete the oldest steps beyond it.  Returns the step's directory."""
    step_dir = Path(directory) / str(int(state.step))
    _atomic_save({"step": int(state.step),
                  "model": state.model.state_dict(),
                  "optimizer": state.optimizer.state_dict(),
                  "scheduler": state.scheduler.state_dict()},
                 step_dir / STATE_FILE)
    if max_to_keep is not None:
        for old in all_steps(directory)[:-max_to_keep]:
            shutil.rmtree(Path(directory) / str(old))
    return step_dir


def latest_step(directory) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load_step(directory, step: Optional[int]) -> Mapping:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return torch.load(Path(directory) / str(step) / STATE_FILE,
                      map_location="cpu", weights_only=True)


def restore_model(directory, model: nn.Module,
                  step: Optional[int] = None) -> nn.Module:
    """Load the model of the checkpoint at `step` (the latest by default)
    into `model`, cast to its dtype and device; returns the model."""
    model.load_state_dict(_load_step(directory, step)["model"])
    return model


def restore_train_state(directory, state, step: Optional[int] = None):
    """Load the checkpoint at `step` (the latest by default) into the
    template `state` (same model and optimizer structure), in place;
    returns the state.  The file is read onto the CPU and each tensor
    goes where its template keeps it: model and optimizer moments on the
    model's device, the optimizer's step counters on the CPU, as torch's
    Adam keeps them."""
    saved = _load_step(directory, step)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = saved["step"]
    return state


def save_params(path, model: nn.Module) -> None:
    """Weights only: the model's state dict in one file."""
    _atomic_save(model.state_dict(), Path(path))


def restore_params(path, model: nn.Module) -> nn.Module:
    """Load weights saved by `save_params` into `model`; a state dict
    nested under 'params', 'model' or 'state_dict' is unwrapped."""
    device = next(model.parameters()).device
    saved: Mapping = torch.load(path, map_location=device, weights_only=True)
    for key in ("params", "model", "state_dict"):
        if key in saved and isinstance(saved[key], Mapping):
            saved = saved[key]
            break
    model.load_state_dict(saved)
    return model
