"""AdamW and learning-rate schedules over trees (nested dicts) of tensors:
the port of the JAX package's ``optim``. ``core.predictors._fit_neural``
trains the neural predictors with ``adamw_update``; ``train.steps``
updates a model in place with ``adamw_update_``."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     adamw_update_, clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm",
           "cosine_schedule", "wsd_schedule"]
