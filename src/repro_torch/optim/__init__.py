from .adamw import AdamWState, adamw_init, adamw_init_abstract, adamw_update
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_init_abstract", "adamw_update", "cosine_schedule", "linear_warmup_cosine",
]
