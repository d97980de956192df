"""``DistributedOptimizer`` under upstream Horovod's signature.

The port's ``optimizer.DistributedOptimizer`` with the positional order of
``horovod/torch/optimizer.py`` (``..., gradient_predivide_factor,
sparse_as_dense, process_set``) and its restriction on Adasum. Its
gradient buckets launch their all-reduces directly, in program order; they
do not go through the frontend's negotiation.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..collectives.compression import Compression
from ..core.process_sets import ProcessSet
from ..optimizer.distributed import DistributedOptimizer as _Distributed
from .mpi_ops import Adasum, Average


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: str = Average,
                         gradient_predivide_factor: float = 1.0,
                         sparse_as_dense: bool = False,
                         process_set: Optional[ProcessSet] = None):
    """Wrap ``optimizer`` so gradients are all-reduced across ranks during
    ``loss.backward()`` (reference ``hvd.DistributedOptimizer``)."""
    if op == Adasum and backward_passes_per_step > 1:
        raise ValueError(
            "backward_passes_per_step > 1 is not supported with Adasum "
            "(reference restriction)")
    if process_set is not None and process_set.process_set_id == 0:
        process_set = None
    return _Distributed(optimizer, named_parameters=named_parameters,
                        compression=compression,
                        backward_passes_per_step=backward_passes_per_step,
                        op=op,
                        gradient_predivide_factor=gradient_predivide_factor,
                        process_set=process_set,
                        sparse_as_dense=sparse_as_dense)
