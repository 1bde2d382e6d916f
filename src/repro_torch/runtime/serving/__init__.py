"""Public serving surface of the port: ``EngineConfig`` + ``ServingEngine``
and the request/queue objects (``Request``, ``RequestState``, ``Status``,
``SamplingParams``), the page accountant, the scheduler and speculative
decoding's ``SpecConfig`` / ``SpecController``."""
from repro_torch.runtime.serving.cache import PagedKVCacheManager
from repro_torch.runtime.serving.chunking import DEFAULT_BUCKETS
from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.engine import ServingEngine
from repro_torch.runtime.serving.request import Request, RequestState, Status
from repro_torch.runtime.serving.sampling import GREEDY, SamplingParams
from repro_torch.runtime.serving.scheduler import Scheduler
from repro_torch.runtime.serving.speculative import SpecConfig, SpecController

__all__ = ["EngineConfig", "ServingEngine", "PagedKVCacheManager",
           "DEFAULT_BUCKETS", "Request", "RequestState", "Status",
           "Scheduler", "GREEDY", "SamplingParams", "SpecConfig",
           "SpecController"]
