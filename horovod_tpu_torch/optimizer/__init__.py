"""DistributedOptimizer, SyncBatchNorm and the startup broadcasts."""

from .distributed import DistributedOptimizer
from .functions import (allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters)
from .sync_batch_norm import SyncBatchNorm
