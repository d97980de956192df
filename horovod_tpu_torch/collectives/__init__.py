"""Collectives over ``torch.distributed`` and their wire compression.

The names of ``horovod_tpu.collectives``, but ``eager``: each process of
the port calls the ops on its own tensors, so ``ops`` is also the
counterpart of the JAX package's eager per-rank wrappers.
"""

from .adasum import adasum_allreduce, hierarchical_adasum
from .compression import Compression
from .dynamic import allgather_v, alltoall_v, compact_gathered
from .join import iterate_with_join, join, join_allreduce, join_count
from .ops import (Adasum, Average, Max, Min, Product, Sum, allgather,
                  allreduce, alltoall, barrier, broadcast, grouped_allgather,
                  grouped_allreduce, grouped_broadcast, grouped_reducescatter,
                  hierarchical_allreduce, reducescatter, sparse_allreduce)

__all__ = [
    "adasum_allreduce", "hierarchical_adasum", "Compression",
    "allgather_v", "alltoall_v", "compact_gathered", "iterate_with_join",
    "join", "join_allreduce", "join_count", "hierarchical_allreduce",
    "Adasum", "Average", "Max", "Min", "Product", "Sum", "allgather",
    "allreduce", "alltoall", "barrier", "broadcast", "grouped_allgather",
    "grouped_allreduce", "grouped_broadcast", "grouped_reducescatter",
    "reducescatter", "sparse_allreduce",
]
