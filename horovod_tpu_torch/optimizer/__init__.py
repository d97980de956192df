"""DistributedOptimizer, SyncBatchNorm, the startup broadcasts, Adagrad with
optax's rule (dense and row-sparse) and the MoE expert-bank optimizer
levers."""

from .adagrad import Adagrad, sparse_adagrad_update
from .distributed import DistributedOptimizer
from .functions import (allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters)
from .sync_batch_norm import SyncBatchNorm
from .moe_opt import (DeferredPair, MoEOptimizer, adafactor, adamw,
                      adamw_low_precision, deferred_pair, every_k,
                      frozen_like, is_expert_param, moe_adamw, optimizer_for,
                      param_groups, partition, scale_by_adam_low_precision)
