"""Continuous-batching serving, greedy: the engine over the slot pool or the
paged pool (``EngineConfig(pool="paged")``: the block-table page arena with
exact prefix reuse, decode-time page appends and preemption)."""

from repro_torch.serving.cache import (PagedCachePool, PrefixHit,  # noqa: F401
                                       SlotCachePool, make_paged_cache)
from repro_torch.serving.engine import (Engine, EngineConfig,  # noqa: F401
                                        ServeMetrics, ServeResult,
                                        generate_sequential)
from repro_torch.serving.requests import (FINISH_LENGTH,  # noqa: F401
                                          FINISH_NUMERIC, FINISH_STOP,
                                          GenerationResult, Request,
                                          SamplingParams)
from repro_torch.serving.resilience import AdmissionError  # noqa: F401
from repro_torch.serving.sampler import sample_greedy  # noqa: F401
