"""Fault-tolerant training loop (port of ``repro.train.loop``):
auto-resume, async checkpoints and a straggler watchdog.

The data pipeline is stateless (a batch is a function of the step), so a
resume needs only the step counter.  Each step reads its loss back to the
host (``float(metrics["loss"])``): one synchronisation a step, as the
reference's ``jax.device_get``, so the step time is the device's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    action: str


class StragglerWatchdog:
    """Rolling-median step-time monitor with a mitigation decision rule:
    a step slower than ``threshold`` x the rolling median is flagged; one
    flag is a "warn", ``consecutive`` flags a "rebalance"."""

    def __init__(self, *, window: int = 32, threshold: float = 2.0,
                 consecutive: int = 3):
        self.window = window
        self.threshold = threshold
        self.consecutive = consecutive
        self._times: deque = deque(maxlen=window)
        self._flags = 0
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time: float) -> Optional[str]:
        med = float(np.median(self._times)) if len(self._times) >= 4 else None
        self._times.append(step_time)
        if med is None:
            return None
        if step_time > self.threshold * med:
            self._flags += 1
            action = ("rebalance" if self._flags >= self.consecutive
                      else "warn")
            self.events.append(StragglerEvent(step, step_time, med, action))
            return action
        self._flags = 0
        return None


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 300
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_keep: int = 2
    async_ckpt: bool = True


class TrainLoop:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` to completion."""

    def __init__(self, step_fn: Callable, data: SyntheticLM, *,
                 ckpt_dir: Optional[str] = None,
                 cfg: LoopConfig = LoopConfig(),
                 make_batch: Optional[Callable[[int], Dict[str, Any]]] = None,
                 log_fn: Callable[[str], None] = print,
                 time_fn: Callable[[], float] = time.monotonic):
        self.step_fn = step_fn
        self.data = data
        self.cfg = cfg
        self.log = log_fn
        self.time = time_fn
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(ckpt_dir, keep=cfg.ckpt_keep,
                                       save_every=cfg.ckpt_every)
                     if ckpt_dir else None)
        self._make_batch = make_batch or self._default_batch
        self.history: List[Dict[str, float]] = []

    def _default_batch(self, step: int) -> Dict[str, Any]:
        tb = self.data.batch_at(step)
        return {"tokens": tb.tokens, "labels": tb.labels}

    def run(self, init_fn: Callable[[], Any]) -> Any:
        """Run (or resume) to ``total_steps``; returns the final state."""
        if self.ckpt is not None:
            state, start = self.ckpt.restore_or_init(init_fn)
            if start:
                self.log(f"[loop] resumed from step {start}")
        else:
            state, start = init_fn(), 0

        for step in range(start, self.cfg.total_steps):
            t0 = self.time()
            batch = self._make_batch(step)
            state, metrics = self.step_fn(state, batch)
            # read the loss back so the step time is real, not launch time
            loss = float(metrics["loss"])
            dt = self.time() - t0

            action = self.watchdog.observe(step, dt)
            if action:
                self.log(f"[watchdog] step {step}: {dt * 1e3:.0f} ms "
                         f"({action})")
            if step % self.cfg.log_every == 0 or \
                    step == self.cfg.total_steps - 1:
                self.log(f"[train] step {step:5d} loss {loss:.4f} "
                         f"({dt * 1e3:.0f} ms)")
            self.history.append(dict(step=step, loss=loss, time=dt))

            if self.ckpt is not None and self.ckpt.should_save(step + 1):
                self.ckpt.save(step + 1, state, metadata={"loss": loss},
                               blocking=not self.cfg.async_ckpt)

        if self.ckpt is not None:
            self.ckpt.save(self.cfg.total_steps, state, blocking=True)
        return state
