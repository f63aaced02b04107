"""Continuous-batching serving over the slot pool, greedy (slice 1)."""

from repro_torch.serving.cache import SlotCachePool  # noqa: F401
from repro_torch.serving.engine import (Engine, EngineConfig,  # noqa: F401
                                        ServeMetrics, ServeResult,
                                        generate_sequential)
from repro_torch.serving.requests import (FINISH_LENGTH,  # noqa: F401
                                          FINISH_NUMERIC, FINISH_STOP,
                                          GenerationResult, Request,
                                          SamplingParams)
from repro_torch.serving.sampler import sample_greedy  # noqa: F401
