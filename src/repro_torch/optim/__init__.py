"""AdamW, its schedules and gradient compression (counterpart of
``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup"]
