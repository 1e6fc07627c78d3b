"""The train step of the port (``repro.train``): the chunked loss and the
step's assembly."""
from repro_torch.train.loss import full_xent, xent_chunked
from repro_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_loss_fn,
    make_train_step,
    train_state_from_numpy,
)

__all__ = ["full_xent", "xent_chunked", "TrainConfig", "init_train_state",
           "make_loss_fn", "make_train_step", "train_state_from_numpy"]
