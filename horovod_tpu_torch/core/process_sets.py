"""Process sets: collectives over rank subsets.

Counterpart of ``horovod_tpu/core/process_sets.py``. On the GPU a process set
is what it was in the original Horovod: a communicator of its own, here a
``torch.distributed`` group made with ``new_group``. Id 0 is the global set,
whose group is the default (world) group.

``torch.distributed.new_group`` is collective: every rank of the world calls
:meth:`ProcessSetTable.add` with the same ranks, members or not.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ProcessSet:
    """A named subset of ranks. ``process_set_id`` 0 is the global set."""

    process_set_id: int
    ranks: tuple

    def size(self) -> int:
        return len(self.ranks)

    def included(self, rank: int) -> bool:
        return rank in self.ranks

    def rank_in_set(self, global_rank: int) -> int:
        return self.ranks.index(global_rank)


class ProcessSetTable:
    """Registry of process sets and their groups; id 0 is the global set
    over all ranks, with the default group (``None``)."""

    def __init__(self, world_size: int):
        self._world_size = world_size
        self._next_id = 1
        self._lock = threading.Lock()
        self._sets: Dict[int, ProcessSet] = {
            0: ProcessSet(0, tuple(range(world_size)))
        }
        self._groups: Dict[int, object] = {0: None}

    @property
    def global_set(self) -> ProcessSet:
        return self._sets[0]

    def add(self, ranks: Sequence[int]) -> ProcessSet:
        import torch.distributed as dist
        ranks = tuple(sorted(set(int(r) for r in ranks)))
        if not ranks:
            raise ValueError("process set must contain at least one rank")
        if ranks[0] < 0 or ranks[-1] >= self._world_size:
            raise ValueError(
                f"ranks {ranks} out of range for world size {self._world_size}")
        with self._lock:
            for ps in self._sets.values():
                if ps.ranks == ranks:
                    return ps
            group = dist.new_group(list(ranks))
            ps = ProcessSet(self._next_id, ranks)
            self._sets[self._next_id] = ps
            self._groups[self._next_id] = group
            self._next_id += 1
            return ps

    def remove(self, ps: "ProcessSet | int") -> None:
        psid = ps.process_set_id if isinstance(ps, ProcessSet) else int(ps)
        if psid == 0:
            raise ValueError("cannot remove the global process set")
        with self._lock:
            self._sets.pop(psid, None)
            self._groups.pop(psid, None)

    def group(self, ps: Optional[ProcessSet]):
        """The ``torch.distributed`` group of ``ps`` (None: the world)."""
        if ps is None or ps.process_set_id == 0:
            return None
        with self._lock:
            if ps.process_set_id not in self._groups:
                raise ValueError(f"process set {ps.process_set_id} was "
                                 "removed")
            return self._groups[ps.process_set_id]
