"""Measured characterisation: fault-injection sweeps over a model (port of
``repro.calibrate``).  :mod:`.resilience_sweep` measures the per-operator
BER -> accuracy-loss curves the fault-tolerant policy consumes."""
from .resilience_sweep import (DEFAULT_BER_GRID, QUICK_BER_GRID, SweepResult,
                               empirical_resilience, fit_sweep,
                               grid_fault_config, run_sweep, write_artifact)

__all__ = ["DEFAULT_BER_GRID", "QUICK_BER_GRID", "SweepResult",
           "empirical_resilience", "fit_sweep", "grid_fault_config",
           "run_sweep", "write_artifact"]
