"""Training steps and losses."""

from .dp import TrainState, create_train_state, make_train_step
from .losses import next_token_loss
