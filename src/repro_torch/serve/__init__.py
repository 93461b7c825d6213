"""Serving: the static-batch aging-aware engines and their steps."""
from .engine import (FleetGenerateResult, FleetServeEngine,  # noqa: F401
                     GenerateResult, ServeEngine)
