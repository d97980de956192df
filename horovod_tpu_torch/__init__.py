"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper.

A second package beside ``horovod_tpu`` (the JAX/TPU reference, which it is
tested against). One process per GPU in a ``torch.distributed`` world; NCCL
all-reduces over fusion buckets, or the Adasum butterfly; the Pallas TPU
kernels rewritten by hand in CUDA C++ for ``sm_90a`` (``ops/csrc``).

This package imports ``torch`` and never ``jax`` or anything of
``horovod_tpu``. Its entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .collectives.adasum import adasum_allreduce
from .collectives.compression import Compression
from .collectives.ops import (Adasum, Average, Max, Min, Product, Sum,
                              allreduce, barrier, broadcast, broadcast_,
                              grouped_allreduce)
from .core.context_api import (add_process_set, cross_rank, cross_size,
                               cuda_built, device, global_process_set, init,
                               is_initialized, local_rank, local_size,
                               nccl_built, rank, remove_process_set,
                               shutdown, size)
from .core.exceptions import HorovodInternalError, NotInitializedError
from .optimizer import (DistributedOptimizer, SyncBatchNorm,
                        broadcast_optimizer_state, broadcast_parameters)
