from .optimizer import adamw_init, adamw_update, cosine_lr
from .loop import init_state, make_train_step, TrainState

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "init_state",
           "make_train_step", "TrainState"]
