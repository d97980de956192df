"""Training steps and losses."""

from .dp import TrainState, batch_stats, create_train_state, make_train_step
from .gspmd import (create_gspmd_train_state, make_gspmd_deferred_train_step,
                    make_gspmd_train_step, mesh_param_groups, shard_tokens,
                    sharded_parameters)
from .losses import masked_label_loss, mlm_loss, next_token_loss
from .step_builder import accumulate_gradients
