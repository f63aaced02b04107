"""Optimizer: AdamW through the fused Goldschmidt kernel, global-norm
clipping, and the cosine / WSD schedules."""

from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedules import cosine, wsd  # noqa: F401
