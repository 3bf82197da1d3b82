"""Training: AdamW with dtype-configurable state and f32 master weights, and
the train step (microbatched gradient accumulation, then the update)."""
from .optimizer import (OptConfig, adamw_init, adamw_update, global_norm,
                        lr_schedule, opt_state_defs)
from .trainer import (TrainState, abstract_train_state, init_train_state,
                      make_train_step, train_state_defs)

__all__ = ["OptConfig", "TrainState", "abstract_train_state", "adamw_init",
           "adamw_update", "global_norm", "init_train_state", "lr_schedule",
           "make_train_step", "opt_state_defs", "train_state_defs"]
