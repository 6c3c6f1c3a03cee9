"""Device-resident shuffling buffer: decorrelate batches on the card.

Counterpart of ``petastorm_tpu/jax/device_buffer.py``.  The buffer holds
``capacity`` slots of one batch each, as one stacked ``(capacity, B, ...)``
tensor per field.  A push picks a uniformly random slot, merges the incoming
batch with the resident one (2B rows), permutes the merged rows, emits B of
them and writes the other B back into the slot.  Per step that is one slot
gather and scatter and a 2B-row permutation, O(batch) device traffic however
large the buffer, while rows random-walk across slots over time.  The
warm-up accumulates the first ``capacity`` batches and stacks them into the
store once.  ``drain()`` permutes the slots and the rows within them and
emits every resident batch.

The work is torch index ops (``torch.cat``, ``index_select``, ``copy_``):
per step it moves one slot, so it needs no hand kernel.  The draws come from
a draw source the caller may replace (:class:`TorchDraws` by default), so
that a test can feed the JAX buffer's own draws and compare the outputs bit
for bit.  On a CUDA device the slot is drawn on the host from a CPU generator
(a Python index costs no device sync) and each permutation on the device
with a CUDA generator, on the current stream: the loader calls ``push`` and
``drain`` on its copy stream, so the store is allocated and written there
only.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.errors import PetastormTpuError

Batch = Dict[str, torch.Tensor]


def _exchange(store: Batch, batch: Batch, slot: int, perm: torch.Tensor) -> Batch:
    """Swap-mix ``batch`` with ``store[slot]`` in place
    (``petastorm_tpu/jax/device_buffer.py:48``): the merged 2B rows at
    ``perm[:B]`` are returned, those at ``perm[B:]`` become the slot."""
    rows = next(iter(batch.values())).shape[0]
    out = {}
    for name, stacked in store.items():
        # the concatenation copies the resident rows before the slot is overwritten
        merged = torch.cat([stacked[slot], batch[name]])
        out[name] = merged.index_select(0, perm[:rows])
        stacked[slot].copy_(merged.index_select(0, perm[rows:]))
    return out


def _self_shuffle(store: Batch, slot_perm: torch.Tensor, row_perm: torch.Tensor) -> Batch:
    """Permute the slots and the rows within each slot (``:63``)."""
    return {name: stacked[slot_perm][:, row_perm] for name, stacked in store.items()}


class TorchDraws:
    """The buffer's draws from explicit torch generators seeded by ``seed``:
    the slot from a CPU generator, the permutations from a generator on
    ``device`` (drawn there, on the current stream)."""

    def __init__(self, seed: int, device: torch.device):
        self._device = device
        self._host = torch.Generator().manual_seed(seed)
        self._perms = torch.Generator(device=device).manual_seed(seed)

    def _perm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self._perms, device=self._device)

    def push(self, capacity: int, rows: int) -> Tuple[int, torch.Tensor]:
        """A slot uniform in ``[0, capacity)`` and a permutation of ``rows``."""
        slot = int(torch.randint(0, capacity, (1,), generator=self._host))
        return slot, self._perm(rows)

    def drain(self, slots: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A permutation of the ``slots`` and one of the ``rows`` of a slot."""
        return self._perm(slots), self._perm(rows)


class DeviceShufflingBuffer:
    """Exchange-shuffle ``capacity`` batches resident on ``device``.

    ``push(batch)`` returns a decorrelated batch once the buffer is warm
    (None while filling); ``drain()`` yields the resident batches, shuffled,
    whether or not the buffer ever filled, and leaves it empty.  All batches
    must share one set of fields and shapes (the loader guarantees this).
    ``seed=None`` draws one from OS entropy, as the JAX buffer does.
    ``draws`` replaces the draw source (:class:`TorchDraws`): any object
    with its ``push(capacity, rows)`` and ``drain(slots, rows)``.
    """

    def __init__(self, capacity: int, seed: Optional[int] = None, device="cuda",
                 draws=None):
        if capacity < 1:
            raise PetastormTpuError("device shuffle capacity must be >= 1")
        self._capacity = capacity
        if draws is None:
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            draws = TorchDraws(seed, resolve_device(device))
        self._draws = draws
        self._pending: List[Batch] = []  # warm-up accumulator
        self._store: Optional[Batch] = None  # field -> (capacity, B, ...)

    @staticmethod
    def _stack(batches: List[Batch]) -> Batch:
        return {name: torch.stack([b[name] for b in batches]) for name in batches[0]}

    def push(self, batch: Batch) -> Optional[Batch]:
        """Add one batch; once the buffer is full, return a batch mixed from
        it and a uniformly chosen resident one (None while filling)."""
        if self._store is None:
            self._pending.append(batch)
            if len(self._pending) == self._capacity:
                self._store, self._pending = self._stack(self._pending), []
            return None
        rows = next(iter(batch.values())).shape[0]
        slot, perm = self._draws.push(self._capacity, 2 * rows)
        return _exchange(self._store, batch, slot, perm)

    def drain(self) -> Iterator[Batch]:
        """Emit the resident batches (always shuffled); the buffer ends empty."""
        store = self._store
        if store is None:
            if not self._pending:
                return
            store = self._stack(self._pending)  # partial fill: < capacity slots
        self._store, self._pending = None, []
        first = next(iter(store.values()))
        slot_perm, row_perm = self._draws.drain(first.shape[0], first.shape[1])
        store = _self_shuffle(store, slot_perm, row_perm)
        for i in range(first.shape[0]):
            yield {name: stacked[i] for name, stacked in store.items()}
