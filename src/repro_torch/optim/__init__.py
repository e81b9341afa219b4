"""AdamW over a module's parameters (``repro.optim``'s port)."""

from repro_torch.optim.adamw import (OptState, adamw_init, adamw_update,
                                     cosine_schedule, exp_decay_schedule,
                                     warmup_cosine_schedule)
