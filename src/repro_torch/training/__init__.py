"""repro_torch.training — optimizer, train step, schedules."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            clip_by_global_norm, global_norm,
                                            init_opt_state, lr_schedule)
from repro_torch.training.train_step import (grad_accum_fn, loss_fn,
                                             make_train_step, train_step)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "global_norm", "grad_accum_fn", "init_opt_state", "loss_fn",
           "lr_schedule", "make_train_step", "train_step"]
