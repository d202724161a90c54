"""Optimizers and learning-rate schedules over nested-dict parameter trees."""
from repro_torch.optim.optimizers import (OptConfig, apply_updates,  # noqa: F401
                                          init_opt_state)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa: F401
                                         warmup_cosine)
