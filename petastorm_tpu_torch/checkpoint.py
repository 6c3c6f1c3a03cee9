"""Training checkpoints that hold the data cursor beside the model.

Counterpart of ``petastorm_tpu/jax/checkpoint.py`` without orbax: each step
is a directory under the manager's directory, named by the step, holding
``state.pt`` (a ``torch.save`` of the train state: for the ImageNet trainer,
``TrainStep.state_dict()``, the model's and optimizer's ``state_dict()``s
and the augment generator's state) and ``petastorm_tpu_loader.json`` (the
loader's ``state_dict()``, under the JAX module's key).  A step is written
into a temporary directory and moved into place with ``os.replace``, so a
reader of the directory never sees half a step; ``max_to_keep`` prunes the
oldest steps.  Loads use ``torch.load(weights_only=True)``.

The cursor's semantics are the reader's (``Reader.state_dict``): it counts
the work items the loader took, which run ahead of the batches it delivered
by the in-flight window.  ``loader.drain()`` before the save makes it exact.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch

from petastorm_tpu_torch.errors import PetastormTpuError

_LOADER_KEY = "petastorm_tpu_loader"
_STATE_FILE = "state.pt"


class CheckpointManager:
    """Numbered step directories under ``directory``, at most ``max_to_keep``
    of them (``None`` keeps every step)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        if max_to_keep is not None and max_to_keep < 1:
            raise PetastormTpuError("max_to_keep must be >= 1 or None")
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, train_state: Any, loader_state: Dict) -> bool:
        """Write ``step`` atomically (a step saved again is replaced whole)
        and prune the oldest steps past ``max_to_keep``."""
        if int(step) < 0:
            raise PetastormTpuError(f"step must be >= 0, got {step}")
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=self.directory)
        try:
            torch.save(train_state, os.path.join(tmp, _STATE_FILE))
            with open(os.path.join(tmp, f"{_LOADER_KEY}.json"), "w") as f:
                json.dump(loader_state, f)
            final = self.step_dir(step)
            if os.path.exists(final):
                # os.replace cannot overwrite a non-empty directory: move the
                # old step aside first, then drop it once the new one is in
                old = tempfile.mkdtemp(prefix=f".old-{int(step)}-", dir=self.directory)
                os.replace(final, os.path.join(old, "step"))
                os.replace(tmp, final)
                shutil.rmtree(old)
            else:
                os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old_step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old_step))
        return True

    def restore(self, step: int) -> Tuple[Any, Dict]:
        path = self.step_dir(step)
        if not os.path.isdir(path):
            raise PetastormTpuError(f"no checkpoint for step {step} in {self.directory}")
        train_state = torch.load(os.path.join(path, _STATE_FILE), weights_only=True)
        with open(os.path.join(path, f"{_LOADER_KEY}.json")) as f:
            return train_state, json.load(f)


def make_checkpoint_manager(directory: str, max_to_keep: Optional[int] = 3) -> CheckpointManager:
    """A manager for train-state + loader-state checkpoints.  A relative
    ``directory`` is made absolute up front (``jax/checkpoint.py:38-41``), so
    a later change of the working directory cannot split the steps."""
    if "://" not in str(directory):
        directory = os.path.abspath(directory)
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def save_checkpoint(manager: CheckpointManager, step: int, train_state: Any,
                    loader_or_state) -> bool:
    """Save ``train_state`` and the data cursor at ``step``.

    ``loader_or_state``: a ``CudaDataLoader`` or ``Reader`` (its
    ``state_dict()`` is taken) or a state dict already taken."""
    state = (loader_or_state if isinstance(loader_or_state, dict)
             else loader_or_state.state_dict())
    return manager.save(step, train_state, state)


def restore_checkpoint(manager: CheckpointManager, template: Any = None,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """``(train_state, loader_state)`` of ``step`` (default: the latest).

    ``template``: a train state of the expected structure; the restored one
    must hold every nested key of it and, where the template holds tensors,
    tensors of the same shapes and dtypes (``PetastormTpuError`` otherwise).
    Keys the template lacks pass (a fresh optimizer has no state yet).  Feed
    ``loader_state`` back through :func:`resume_reader_kwargs`."""
    step = step if step is not None else manager.latest_step()
    if step is None:
        raise ValueError("No checkpoint found to restore")
    train_state, loader_state = manager.restore(step)
    if template is not None:
        _check_structure(template, train_state, "train_state")
    return train_state, loader_state


def _check_structure(template: Any, value: Any, where: str) -> None:
    if isinstance(template, dict):
        if not isinstance(value, dict) or not set(template) <= set(value):
            got = sorted(map(str, value)) if isinstance(value, dict) else type(value).__name__
            raise PetastormTpuError(f"{where}: restored {got}, the template has keys"
                                    f" {sorted(map(str, template))}")
        for key in template:
            _check_structure(template[key], value[key], f"{where}[{key!r}]")
    elif isinstance(template, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(template) != len(value):
            raise PetastormTpuError(f"{where}: restored {type(value).__name__} does not match"
                                    f" the template's {len(template)} entries")
        for i, (t, v) in enumerate(zip(template, value)):
            _check_structure(t, v, f"{where}[{i}]")
    elif isinstance(template, torch.Tensor):
        if (not isinstance(value, torch.Tensor) or value.shape != template.shape
                or value.dtype != template.dtype):
            got = (f"{value.dtype} {tuple(value.shape)}" if isinstance(value, torch.Tensor)
                   else type(value).__name__)
            raise PetastormTpuError(f"{where}: restored {got}, the template has"
                                    f" {template.dtype} {tuple(template.shape)}")


def resume_reader_kwargs(loader_state: Dict) -> Dict:
    """kwargs for ``make_reader``/``make_batch_reader`` that resume at the
    checkpointed cursor; the other arguments must be the original run's.
    The full reader state passes through: ``items_per_epoch`` feeds the
    settings check and ``elastic_rebased`` the coordinate translation."""
    reader_state = loader_state.get("reader", loader_state)
    return {"resume_from": dict(reader_state)}
