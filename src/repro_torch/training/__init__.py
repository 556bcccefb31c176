from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, lr_schedule,
                                            opt_state_shapes)
from repro_torch.training.loop import make_train_step, train
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "opt_state_shapes", "make_train_step", "train", "save_checkpoint",
           "restore_checkpoint", "latest_checkpoint"]
