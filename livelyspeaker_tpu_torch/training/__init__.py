"""Training: the train step, AdamW, the host loop, checkpoints, logging."""

from .trainer import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)
