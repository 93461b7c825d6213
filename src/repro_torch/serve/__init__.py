"""Serving: the static-batch aging-aware engines and their steps, and the
continuous-batching online engines (live request queues)."""
from .engine import (FleetGenerateResult, FleetServeEngine,  # noqa: F401
                     GenerateResult, ServeEngine)
from .online import (OnlineFleetEngine, OnlineServeEngine,  # noqa: F401
                     OnlineServeResult, Request, RequestQueue,
                     requests_from_workload)
from .slots import SlotState, init_slots  # noqa: F401
