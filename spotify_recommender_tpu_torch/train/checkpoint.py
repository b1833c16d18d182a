"""Checkpoint / resume for training state.

The port of the JAX package's `train/checkpoint.py`, with `torch.save` in
place of Orbax: one file per step, ``<dir>/step_<n>.pt``, written under a
temporary name and moved into place with `os.replace`, so a reader never
sees half a checkpoint.  A state is a nest of dicts, lists and tuples
whose leaves are tensors or Python scalars (an optimizer's `state_dict`
is one).  Orbax checkpoints need JAX to read, so the two packages do not
share this format (their model artifact, `models/mf.save_model`, they
do share).
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Union

import torch

from spotify_recommender_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
Device = Optional[Union[str, torch.device]]


def _place_like(template: Any, state: Any) -> Any:
    """`state` with each tensor leaf moved to the device of the template's
    leaf at the same place; the template's dict keys must match."""
    if isinstance(template, dict):
        if set(template) != set(state):
            raise KeyError(f"checkpoint keys {sorted(state)} do not match "
                           f"the template's {sorted(template)}")
        return {k: _place_like(template[k], state[k]) for k in template}
    if isinstance(template, torch.Tensor) and isinstance(state, torch.Tensor):
        return state.to(template.device)
    return state


def _load(path: str, template: Any, device: Device) -> Any:
    state = torch.load(path, map_location=device, weights_only=True)
    return state if template is None else _place_like(template, state)


class CheckpointManager:
    """Step-numbered checkpoints, keep-last-N retention, resume from the
    latest.  Saves are synchronous; `wait` and `close` are no-ops kept so
    that the call sites read like the JAX package's."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write `state` as step `step`, then drop all but the newest
        `max_to_keep` steps.  (`force` is accepted for the JAX call sites:
        every save here is written.)"""
        del force
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint saved: step %d -> %s", step, self.directory)
        return True

    def restore(self, step: Optional[int] = None, template: Any = None,
                device: Device = None) -> Any:
        """The state of `step` (default: the latest), or None when there is
        no checkpoint.  Tensors land on `device`, or with a `template`, on
        the device of the template's tensor at the same place."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return _load(self._path(step), template, device)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


def save_checkpoint(path: str, state: Any) -> None:
    """One-shot checkpoint save (no retention management)."""
    path = os.path.abspath(path)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    log.info("checkpoint saved: %s", path)


def restore_checkpoint(path: str, template: Any = None,
                       device: Device = None) -> Any:
    return _load(os.path.abspath(path), template, device)
