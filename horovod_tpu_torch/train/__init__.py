"""Training steps and losses."""

from .dp import TrainState, batch_stats, create_train_state, make_train_step
from .gspmd import make_gspmd_train_step, shard_tokens
from .losses import masked_label_loss, mlm_loss, next_token_loss
from .step_builder import accumulate_gradients
