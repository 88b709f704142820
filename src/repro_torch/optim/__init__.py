"""Optimizers, learning-rate schedules, gradient compression."""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdamWConfig, SGDConfig, init_opt_state, opt_update,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_warmup, linear_warmup, constant,
)
