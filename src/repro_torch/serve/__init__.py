"""Serving: the static-batch aging-aware engine and its steps."""
from .engine import GenerateResult, ServeEngine  # noqa: F401
