"""Training steps and losses."""

from .dp import TrainState, batch_stats, create_train_state, make_train_step
from .gspmd import (create_gspmd_train_state, gspmd_shardings,
                    make_gspmd_deferred_train_step, make_gspmd_train_step,
                    mesh_param_groups, shard_tokens)
from .losses import (masked_label_loss, mlm_loss, mlm_loss_sums,
                     next_token_loss, vocab_parallel_nll)
from .step_builder import (Cadence, PipelineTrainState,
                           accumulate_gradients, create_pipeline_train_state,
                           make_pipeline_train_step)
