"""The train half's optimizers (``optimizer.py``) and int8 gradient
compression with error feedback (``compression.py``)."""
from repro_torch.optim import compression
from repro_torch.optim.optimizer import (AdafactorState, AdamWState,
                                         adafactor_init, adafactor_update,
                                         adamw_init, adamw_update,
                                         clip_by_global_norm, leaf_groups,
                                         lr_schedule, opt_init, opt_update)

__all__ = ["AdafactorState", "AdamWState", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compression", "leaf_groups",
           "lr_schedule", "opt_init", "opt_update"]
