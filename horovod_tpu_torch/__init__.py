"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper.

A second package beside ``horovod_tpu`` (the JAX/TPU reference, which it is
tested against). One process per GPU in a ``torch.distributed`` world; NCCL
all-reduces over fusion buckets, flat or hierarchical, or the Adasum
butterfly; Horovod's other collectives (allgather, broadcast, alltoall,
reducescatter, their uneven and grouped forms, join, objects); the Pallas TPU
kernels rewritten by hand in CUDA C++ for ``sm_90a`` (``ops/csrc``).

This package imports ``torch`` and never ``jax`` or anything of
``horovod_tpu``. Its entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .collectives import (Adasum, Average, Compression, Max, Min, Product,
                          Sum, adasum_allreduce, allgather, allgather_v,
                          allreduce, alltoall, alltoall_v, barrier, broadcast,
                          compact_gathered, grouped_allgather,
                          grouped_allreduce, grouped_broadcast,
                          grouped_reducescatter, hierarchical_adasum,
                          hierarchical_allreduce, iterate_with_join, join,
                          join_allreduce, join_count, reducescatter)
from .collectives.ops import broadcast_
from .core.context_api import (add_process_set, cross_rank, cross_size,
                               cuda_built, device, global_process_set, init,
                               is_initialized, local_rank, local_size,
                               nccl_built, rank, remove_process_set,
                               shutdown, size)
from .core.exceptions import HorovodInternalError, NotInitializedError
from .optimizer import (DistributedOptimizer, SyncBatchNorm,
                        allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters)
