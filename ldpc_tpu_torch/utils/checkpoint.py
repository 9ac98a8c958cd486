"""Checkpoint / resume on ``torch.save`` (the port of
``ldpc_tpu.utils.checkpoint``, which uses orbax).

Replaces the reference's checkpointing (SURVEY.md §5): joblib-pickled
``vars.pkl`` + whole-model ``model.pt`` every ``save_freq`` epochs
(``openAIppo.py:507-508``, ``logx.py:180-280``).  A checkpoint is a nested
dict of tensors (``state_dict``s, optimiser states, generator states,
counters) under ``directory/<step>/state.pt``, one directory a step as
orbax lays them out, and it is restorable mid-training.

Only tensors and plain Python values go in: ``restore_checkpoint`` loads
with ``weights_only=True``, which refuses anything else (numpy arrays
included), so a checkpoint cannot run code when it is read.
"""

from __future__ import annotations

import os
import pathlib

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "state.pt"


def save_checkpoint(directory, step: int, state: dict) -> None:
    """Save a nested dict of tensors under ``directory/step``; the file
    appears whole or not at all."""
    path = pathlib.Path(directory).absolute() / str(int(step))
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path / _FILE)


def latest_step(directory) -> int | None:
    """The newest saved step in ``directory``, or None."""
    path = pathlib.Path(directory)
    if not path.is_dir():
        return None
    steps = [int(p.name) for p in path.iterdir()
             if p.name.isdigit() and (p / _FILE).is_file()]
    return max(steps, default=None)


def _same_keys(got, want, where="state") -> None:
    if isinstance(want, dict) and want:
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {where} does not match the "
                             "template's keys")
        for k in want:
            _same_keys(got[k], want[k], f"{where}[{k!r}]")


def restore_checkpoint(directory, step: int | None = None,
                       template=None) -> dict:
    """Restore the given (default: latest) step's state dict, tensors on
    the CPU.  ``template``, if given, is a dict of the structure the caller
    wants back: a checkpoint whose keys differ raises ``ValueError`` (an
    empty dict in it, such as a new optimiser's ``state``, takes any)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    state = torch.load(pathlib.Path(directory) / str(int(step)) / _FILE,
                       map_location="cpu", weights_only=True)
    if template is not None:
        _same_keys(state, template)
    return state
