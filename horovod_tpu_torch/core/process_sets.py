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
        self._layout: Optional[dict] = None  # the layout's groups, by ranks

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

    def layout_groups(self, rank: int, cross: int, intra: int):
        """This rank's ``(intra group, intra ranks, cross group, cross
        ranks)`` in a node-major ``cross x intra`` layout: node c holds
        ranks ``c * intra .. c * intra + intra - 1``. The first call makes
        every node's group, then every local index's, on every rank in that
        order (``new_group`` is collective), and keeps them."""
        import torch.distributed as dist
        with self._lock:
            if self._layout is None:
                nodes = [tuple(range(c * intra, (c + 1) * intra))
                         for c in range(cross)]
                across = [tuple(range(i, cross * intra, intra))
                          for i in range(intra)]
                self._layout = {ranks: dist.new_group(list(ranks))
                                for ranks in nodes + across}
            groups = self._layout
        node = tuple(range(rank - rank % intra, rank - rank % intra + intra))
        peers = tuple(range(rank % intra, cross * intra, intra))
        return groups[node], node, groups[peers], peers

    def group(self, ps: Optional[ProcessSet]):
        """The ``torch.distributed`` group of ``ps`` (None: the world)."""
        if ps is None or ps.process_set_id == 0:
            return None
        with self._lock:
            if ps.process_set_id not in self._groups:
                raise ValueError(f"process set {ps.process_set_id} was "
                                 "removed")
            return self._groups[ps.process_set_id]
