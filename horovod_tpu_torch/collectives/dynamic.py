"""Uneven collectives: allgather with per-rank first dims, and alltoallv.

Counterpart of ``horovod_tpu/collectives/dynamic.py``. The JAX package pads
every rank's rows to a common bound and sends the true sizes beside them,
because XLA programs have static shapes. The port returns exactly what the
JAX functions return — the padded rank-major layout, the size vector, the
truncation at ``max_split`` — although torch's uneven ``all_to_all_single``
could give a dense result directly: code written against either package
reads the same layout. :func:`compact_gathered` densifies it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.process_sets import ProcessSet
from . import ops as _ops


def allgather_v(tensor: torch.Tensor, valid_size, *,
                process_set: Optional[ProcessSet] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uneven allgather. ``tensor`` is this rank's rows padded to a first
    dim ``max`` common to every member; ``valid_size`` (an int or a 0-d
    tensor) is how many of them are real.

    Returns ``(gathered, sizes)``: ``gathered`` is ``[n * max, ...]``,
    member-major, each slot's padding zeroed; ``sizes`` is the ``[n]``
    int32 vector of true sizes. A rank outside ``process_set`` gets its own
    zero-padded rows and ``[valid_size]``, as a world of one does."""
    rows = torch.arange(tensor.shape[0], device=tensor.device).view(
        (-1,) + (1,) * (tensor.dim() - 1))
    valid = torch.as_tensor(valid_size, dtype=torch.int32,
                            device=tensor.device).reshape(1)
    tensor = torch.where(rows < valid, tensor, torch.zeros_like(tensor))
    return (_ops.allgather(tensor, process_set=process_set),
            _ops.allgather(valid, process_set=process_set))


def compact_gathered(gathered: torch.Tensor, sizes: torch.Tensor
                     ) -> torch.Tensor:
    """Densify a padded :func:`allgather_v` or :func:`alltoall_v` result
    into the reference's concatenated-by-rank layout."""
    sizes = [int(s) for s in sizes.tolist()]
    per = gathered.shape[0] // len(sizes)
    return torch.cat([gathered[i * per:i * per + s]
                      for i, s in enumerate(sizes)])


def alltoall_v(tensor: torch.Tensor, splits, *,
               max_split: Optional[int] = None,
               process_set: Optional[ProcessSet] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uneven all-to-all (parity: ``hvd.alltoall(tensor, splits)``).

    ``splits`` (n ints, n the member count) gives the rows this rank sends
    to each member, laid out consecutively from row 0, as in the
    reference's ``MPI_Alltoallv``. ``max_split`` is the bound on any one
    chunk (default ``tensor.shape[0]``, always enough).

    Returns ``(received, recv_splits)``: ``received`` is ``[n * max_split,
    ...]`` with the *i*-th member's rows in slot *i*, zero-padded;
    ``recv_splits[i]`` (int32) is how many are real. A chunk longer than
    ``max_split`` loses its tail on both the rows and the sizes; the
    offsets still come from the caller's splits, so later chunks do not
    shift. A rank outside ``process_set`` gets its own chunks back."""
    splits = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                               else splits)]
    if max_split is None:
        max_split = tensor.shape[0]
    n = _ops._set_size(process_set)
    if len(splits) != n:
        raise ValueError(f"alltoall_v needs one split per member ({n}), got "
                         f"{len(splits)}")
    chunks = tensor.new_zeros((n, max_split) + tuple(tensor.shape[1:]))
    off = 0
    for i, s in enumerate(splits):
        part = tensor[off:off + min(s, max_split)]
        chunks[i, :part.shape[0]] = part
        off += s
    sent = torch.tensor([min(s, max_split) for s in splits],
                        dtype=torch.int32, device=tensor.device)
    received = _ops.alltoall(chunks, process_set=process_set)
    recv = _ops.alltoall(sent, process_set=process_set)
    return received.reshape((n * max_split,) + tuple(tensor.shape[1:])), recv
