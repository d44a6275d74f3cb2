"""Checkpoint / resume with ``torch.save`` (counterpart of
``clearvae_tpu/utils/checkpoint.py``, which saves through Orbax).

The layout is the JAX package's: one checkpoint per update count,
``step_{step:08d}.pt`` (a directory there), and with metadata a
``step_{step:08d}.meta.json`` beside it. A trainer's checkpoint is
``TrainerCore.state_dict()``: its modules' and optimizers' state dicts, the
train step's update count and the noise generator's state, so a run
resumed from it continues the random stream where the saved run stood.
"""

from __future__ import annotations

import json
import os

import torch


def save_checkpoint(directory: str, trainer_state: dict,
                    step: int | None = None,
                    metadata: dict | None = None) -> str:
    """Save a trainer state dict; returns the checkpoint's path. ``step``
    defaults to the state's update count."""
    step = int(trainer_state["step"]) if step is None else int(step)
    path = checkpoint_path(directory, step)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(trainer_state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(os.path.join(directory, f"step_{step:08d}.meta.json"),
                  "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return path


def checkpoint_path(directory: str, step: int) -> str:
    """Where ``save_checkpoint`` writes the checkpoint of update count
    ``step``."""
    return os.path.join(os.path.abspath(directory), f"step_{int(step):08d}.pt")


def latest_checkpoint(directory: str) -> str | None:
    """The checkpoint of the highest update count in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(f for f in os.listdir(directory)
                   if f.startswith("step_") and f.endswith(".pt"))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str, map_location="cpu") -> dict:
    """The trainer state dict saved at ``path`` (tensors on
    ``map_location``)."""
    return torch.load(path, map_location=map_location, weights_only=True)
