from .pipeline import SyntheticLM, TokenBatch  # noqa: F401
