"""Public serving surface of the port (the reference's ``__all__``):
``EngineConfig`` + ``ServingEngine``; speculative decoding's
``SpecConfig`` / ``SpecController``; fault injection (``FaultPlan``,
``FaultSpec``, ``FaultInjector``, ``parse_fault_plan``); the health ladder
(``HealthConfig``, ``HealthMonitor``, ``HealthState``);
``AdmissionRejected``; the fleet (``Router``, ``RouterConfig``,
``PLACEMENT_POLICIES``, ``Replica``, ``StepClock``); the page accountant
with its ``AllocResult`` / ``PrefixMatch``; ``DEFAULT_BUCKETS``; the
request objects and the scheduler; sampling's ``GREEDY`` /
``SamplingParams``; and the tolerance harness."""
from repro_torch.runtime.serving.cache import (AllocResult,
                                               PagedKVCacheManager,
                                               PrefixMatch)
from repro_torch.runtime.serving.chunking import DEFAULT_BUCKETS
from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.engine import ServingEngine
from repro_torch.runtime.serving.faults import (FaultInjector, FaultPlan,
                                                FaultSpec, parse_fault_plan)
from repro_torch.runtime.serving.health import (HealthConfig, HealthMonitor,
                                                HealthState)
from repro_torch.runtime.serving.replica import Replica, StepClock
from repro_torch.runtime.serving.request import Request, RequestState, Status
from repro_torch.runtime.serving.router import (PLACEMENT_POLICIES, Router,
                                                RouterConfig)
from repro_torch.runtime.serving.sampling import GREEDY, SamplingParams
from repro_torch.runtime.serving.scheduler import AdmissionRejected, Scheduler
from repro_torch.runtime.serving.speculative import SpecConfig, SpecController
from repro_torch.runtime.serving.tolerance import (TokenMatchReport,
                                                   compare_streams, measure,
                                                   serve_streams)

__all__ = ["EngineConfig", "ServingEngine",
           "SpecConfig", "SpecController",
           "FaultPlan", "FaultSpec", "FaultInjector", "parse_fault_plan",
           "HealthConfig", "HealthMonitor", "HealthState",
           "AdmissionRejected",
           "Router", "RouterConfig", "PLACEMENT_POLICIES",
           "Replica", "StepClock",
           "PagedKVCacheManager", "AllocResult", "PrefixMatch",
           "DEFAULT_BUCKETS",
           "Request", "RequestState", "Status", "Scheduler",
           "GREEDY", "SamplingParams",
           "TokenMatchReport", "compare_streams", "measure",
           "serve_streams"]
