"""Continuous-batching online serving: live request queues on the aging
fleet (port of ``repro.serve.online``).

The static-batch engines (:mod:`repro_torch.serve.engine`) answer
"generate n tokens for this fixed prompt batch".  Production traffic is a
queue: requests arrive mid-decode, finish at different lengths, and the
slots they vacate are refilled without stalling the requests in flight.

* :class:`Request` / :class:`RequestQueue` — host-side arrivals with
  bounded-queue admission control (the queue drops what it cannot hold);
* :func:`requests_from_workload` — a :mod:`repro_torch.sched.workload`
  arrival trace made into a request schedule (Little's-law sizing:
  ``load`` device-equivalents ~ ``load * n_slots * steps_per_epoch /
  max_new`` requests an epoch);
* :class:`OnlineServeEngine` — one device: a fixed-slot
  :class:`~repro_torch.serve.slots.SlotState` advances in decode chunks;
  between chunks the host harvests finished slots and refills them from
  the queue.  With no mid-decode arrivals its tokens are
  ``ServeEngine.generate``'s bit for bit;
* :class:`OnlineFleetEngine` — N fleet lanes in lockstep, their slots
  folded lane-major into ``N * K`` rows (one lane-batched forward a step,
  one lane-mode launch per faulted op for all lanes), with a
  :mod:`repro_torch.sched.router` policy handing queued requests to lanes,
  fed by the *measured* occupancy of the previous chunk;
* :class:`OnlineServeResult` — tok/s, p50/p99 latency, drops and the
  measured per-step occupancy, which :meth:`OnlineServeResult.
  lane_utilization` resamples into the ``util_trace`` that
  :meth:`repro_torch.core.fleet.FleetRuntime.apply_load` replays: slots ->
  duty -> aging on measured duty.

The reference counts its compiled functions per cache; the port compiles
nothing, so the four ``online_*`` served-shape counters
(:class:`~repro_torch.serve.engine._ServedShapes`) count the keys served
instead.  A chunk makes no host-device synchronisation; the harvest reads
the occupancy and ``active`` once a chunk (one copy), and the tokens only
when a slot finished.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..core.fleet import FleetRuntime
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs import metrics as obs_metrics
from ..obs.taps import taps_enabled, telemetry_to_host
from . import slots as slots_mod
from .engine import (ServeEngine, _check_params, _ServedShapes,
                     refuse_sharded_fleet)
from .slots import EMPTY, SlotState, init_slots


# --------------------------------------------------------------------------- #
# host-side requests
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Request:
    """One inference request moving through the online engine.

    ``arrival`` is in decode-step units on the engine's service clock;
    the engine stamps ``t_start`` (prefill) and ``t_done`` (completion)
    on the same clock, so ``t_done - arrival`` is the request latency in
    decode steps.  ``tokens`` holds the generated ids once finished.
    """

    id: int
    prompt: np.ndarray                    # (S,) int32
    max_new: int
    arrival: int = 0
    t_start: int = -1
    t_done: int = -1
    lane: int = -1
    n_generated: int = 0
    tokens: Optional[np.ndarray] = None

    @property
    def latency(self) -> int:
        return self.t_done - self.arrival


class RequestQueue:
    """Bounded FIFO admission queue: ``push`` admits until ``max_queue``
    and drops (and counts) the rest; ``take`` hands out up to ``k``
    requests in arrival order."""

    def __init__(self, max_queue: int = 64):
        self.max_queue = int(max_queue)
        self._q: collections.deque = collections.deque()
        self.n_arrived = 0
        self.n_admitted = 0
        self.n_dropped = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> bool:
        """Admit one request; returns False (and counts a drop) if full."""
        self.n_arrived += 1
        if len(self._q) >= self.max_queue:
            self.n_dropped += 1
            return False
        self.n_admitted += 1
        self._q.append(req)
        return True

    def take(self, k: int) -> List[Request]:
        out = []
        while len(out) < k and self._q:
            out.append(self._q.popleft())
        return out


def requests_from_workload(workload, *, n_slots: int,
                           steps_per_epoch: int, max_new: int,
                           prompt_len: int, vocab: int = 256,
                           n_devices: int = 1, seed: int = 0,
                           n_epochs: Optional[int] = None,
                           loads=None) -> List[Request]:
    """A :class:`~repro_torch.sched.workload.Workload` (or its registered
    name) made into requests, as the reference's.

    ``load`` device-equivalents in an epoch keep ``load`` devices' slots
    busy for the epoch: ``load * n_slots * steps_per_epoch`` slot-steps,
    i.e. ``~ / max_new`` requests (a Poisson count).  Arrival offsets are
    uniform within each epoch and prompts uniform token ids, from numpy's
    ``default_rng(seed)``; the trace itself is the workload's threefry
    draw at ``seed`` (on the CPU).  ``loads`` overrides the trace.
    """
    from ..sched.workload import Workload, get_workload
    if loads is None:
        wl = workload if isinstance(workload, Workload) else \
            get_workload(workload, n_devices=n_devices,
                         **({} if n_epochs is None
                            else {"n_epochs": n_epochs}))
        loads = wl.loads(seed, device="cpu").numpy().astype(np.float64)
    loads = np.atleast_1d(np.asarray(loads, np.float64))
    if loads.ndim != 1:
        raise ValueError(f"loads must be (E,), got {loads.shape}")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = 0
    per_req = max(int(max_new), 1)
    for e, load in enumerate(loads):
        lam = float(load) * n_slots * steps_per_epoch / per_req
        n = int(rng.poisson(max(lam, 0.0)))
        offs = np.sort(rng.integers(0, steps_per_epoch, size=n))
        for off in offs:
            reqs.append(Request(
                id=rid,
                prompt=rng.integers(0, vocab, size=prompt_len)
                          .astype(np.int32),
                max_new=per_req,
                arrival=int(e * steps_per_epoch + off)))
            rid += 1
    return reqs


# --------------------------------------------------------------------------- #
# result + occupancy -> aging replay
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class OnlineServeResult:
    """What an online serve run measured.

    ``occupancy`` is the per-step slot-activity trace — ``(T, K)`` for one
    device, ``(T, N, K)`` for a fleet — where idle steps (the system empty,
    waiting on arrivals) are all-False rows: the duty cycle the device
    sustained.  ``telemetry`` holds the chunks' logit taps when taps were
    enabled: ``{name: (T_served,)}``, or ``{name: (N, T_served)}`` for a
    fleet, over the steps the device decoded; ``None`` otherwise (the
    tokens are the same either way).  ``timings`` are host-clock seconds
    of the run's phases and their counts: ``refill_s`` / ``chunk_s`` up to
    the device read that follows each refill / chunk (so device time
    included), ``harvest_s`` the token reads and bookkeeping after.
    """

    completed: List[Request]
    occupancy: np.ndarray
    n_arrived: int
    n_dropped: int
    total_steps: int
    wall_s: float
    n_tokens: int
    telemetry: Optional[Dict[str, np.ndarray]] = None
    timings: Optional[Dict[str, float]] = None

    @property
    def n_completed(self) -> int:
        return len(self.completed)

    @property
    def drop_rate(self) -> float:
        return self.n_dropped / max(self.n_arrived, 1)

    @property
    def tok_per_s(self) -> float:
        return self.n_tokens / max(self.wall_s, 1e-9)

    @property
    def p50(self) -> float:
        """Median request latency [decode steps] (NaN with no completions)."""
        return self.latency_percentiles((50.0,))["p50"]

    @property
    def p99(self) -> float:
        """p99 request latency [decode steps] (NaN with no completions)."""
        return self.latency_percentiles((99.0,))["p99"]

    def latencies(self) -> np.ndarray:
        """Request latencies [decode steps], one per completed request."""
        return np.asarray([r.latency for r in self.completed], np.float64)

    def latency_percentiles(self, qs=(50.0, 99.0)) -> Dict[str, float]:
        lat = self.latencies()
        if lat.size == 0:
            return {f"p{q:g}": float("nan") for q in qs}
        return {f"p{q:g}": float(np.percentile(lat, q)) for q in qs}

    def lane_utilization(self, n_epochs: int) -> np.ndarray:
        """Measured duty cycle on an ``n_epochs`` grid: the step axis split
        into ``n_epochs`` contiguous windows, each the mean fraction of busy
        slots.  ``(E,)`` for one device, ``(E, N)`` for a fleet (the
        ``util_trace`` of ``FleetRuntime.apply_load``)."""
        occ = np.asarray(self.occupancy, np.float64)
        T = occ.shape[0]
        if T == 0:
            raise ValueError("no served steps to resample")
        duty = occ.mean(axis=-1)                      # (T,) or (T, N)
        edges = np.linspace(0, T, n_epochs + 1).astype(np.int64)
        out = np.zeros((n_epochs,) + duty.shape[1:], np.float64)
        for e in range(n_epochs):
            lo, hi = edges[e], max(edges[e + 1], edges[e] + 1)
            out[e] = duty[lo:min(hi, T)].mean(axis=0) if lo < T else 0.0
        return out

    def summary(self) -> Dict[str, float]:
        d = {"n_arrived": self.n_arrived, "n_dropped": self.n_dropped,
             "n_completed": self.n_completed,
             "drop_rate": self.drop_rate, "total_steps": self.total_steps,
             "n_tokens": self.n_tokens, "wall_s": self.wall_s,
             "tok_per_s": self.tok_per_s,
             "mean_occupancy": float(np.asarray(self.occupancy,
                                                np.float64).mean())}
        d.update(self.latency_percentiles())
        return d


def _record_online(res: OnlineServeResult) -> None:
    """Fold one finished online run into the metrics registry."""
    reg = obs_metrics.REGISTRY
    reg.counter("online_requests_arrived", "requests offered").inc(
        res.n_arrived)
    reg.counter("online_requests_dropped",
                "requests dropped at admission").inc(res.n_dropped)
    reg.counter("online_requests_completed", "requests completed").inc(
        res.n_completed)
    reg.counter("serve_tokens", "tokens generated").inc(res.n_tokens)
    reg.histogram("online_latency_steps",
                  "request latency [decode steps]") \
       .observe_many(res.latencies())
    reg.gauge("online_drop_rate", "drop rate of the last run").set(
        res.drop_rate)


# the reference's compile-cache names, counting the keys served
ONLINE_PREFILL = _ServedShapes("online_prefill")
ONLINE_CHUNK = _ServedShapes("online_chunk")
ONLINE_FLEET_PREFILL = _ServedShapes("online_fleet_prefill")
ONLINE_FLEET_CHUNK = _ServedShapes("online_fleet_chunk")


# --------------------------------------------------------------------------- #
# the service loop shared by both engines
# --------------------------------------------------------------------------- #
class _Loop:
    """State of one ``serve`` call: the pending arrivals, the queue, the
    live requests by row, the slot state and the records.  A row is a slot
    (one device) or ``lane * K + slot`` (a fleet); ``shape`` is the
    occupancy's per-step shape, ``(K,)`` or ``(N, K)``."""

    def __init__(self, eng, requests, shape, max_queue: int):
        C = eng.max_new_cap
        self.pending = sorted(requests, key=lambda r: r.arrival)
        if not all(len(r.prompt) + min(r.max_new, C) <= eng.max_len
                   for r in self.pending):
            raise ValueError("prompt_len + max_new must fit the cache "
                             "(max_len)")
        self.prompt_len = (len(self.pending[0].prompt) if self.pending
                           else 1)
        if not all(len(r.prompt) == self.prompt_len for r in self.pending):
            raise ValueError("online slots serve one fixed prompt length "
                             "per run")
        self.eng = eng
        self.shape = shape
        self.rows = int(np.prod(shape))
        self.queue = RequestQueue(max_queue)
        self.live: Dict[int, Request] = {}
        self.completed: List[Request] = []
        self.occ_rows: List[np.ndarray] = []
        self.telem_rows: List[Dict[str, np.ndarray]] = []
        self.now = 0
        self.slots: Optional[SlotState] = None
        self.timings = {"refill_s": 0.0, "chunk_s": 0.0, "harvest_s": 0.0,
                        "n_refills": 0, "n_chunks": 0}

    def admit(self) -> None:
        while self.pending and self.pending[0].arrival <= self.now:
            self.queue.push(self.pending.pop(0))

    def free_rows(self) -> List[int]:
        return [i for i in range(self.rows) if i not in self.live]

    def refill(self, assign: Dict[int, Request], fi, temp, eos,
               top_k, lanes) -> None:
        """Refill rows ``assign`` (row -> request): the whole prompt matrix
        goes through one prefill, then finished-at-prefill requests are
        harvested."""
        eng = self.eng
        prompts = np.zeros((self.rows, self.prompt_len), np.int64)
        mask = np.zeros((self.rows,), bool)
        rids = np.full((self.rows,), EMPTY, np.int32)
        mnew = np.ones((self.rows,), np.int32)
        K = self.shape[-1]
        for i, r in assign.items():
            prompts[i], mask[i], rids[i], mnew[i] = (r.prompt, True, r.id,
                                                     r.max_new)
            r.t_start = self.now
            if lanes is not None:
                r.lane = i // K
            self.live[i] = r
        t0 = time.perf_counter()
        dev = eng.device
        self.slots = slots_mod.refill(
            eng.params, eng.cfg, self.slots,
            torch.as_tensor(prompts, device=dev),
            torch.as_tensor(mask, device=dev),
            torch.as_tensor(rids, device=dev),
            torch.as_tensor(mnew, device=dev), fi, temperature=temp,
            eos=eos, max_len=eng.max_len, top_k=top_k, lanes=lanes)
        active = self.slots.active.cpu().numpy()
        self.timings["refill_s"] += time.perf_counter() - t0
        self.timings["n_refills"] += 1
        self.harvest(None, active)

    def chunk(self, fi, temp, eos, top_k, lanes) -> np.ndarray:
        """One decode chunk; returns its ``(chunk,) + shape`` occupancy."""
        eng = self.eng
        t0 = time.perf_counter()
        self.slots, trace, telem = slots_mod.decode_chunk(
            eng.params, eng.cfg, self.slots, fi,
            chunk_steps=eng.chunk_steps, temperature=temp, eos=eos,
            top_k=top_k, lanes=lanes)
        # one device read: the chunk's occupancy and the final `active`
        both = torch.cat([trace, self.slots.active[None]]).cpu().numpy()
        self.timings["chunk_s"] += time.perf_counter() - t0
        self.timings["n_chunks"] += 1
        trace = both[:-1].reshape((eng.chunk_steps,) + self.shape)
        self.occ_rows.append(trace)
        if taps_enabled():
            self.telem_rows.append(telemetry_to_host(telem))
        self.now += eng.chunk_steps
        self.harvest(trace.reshape(eng.chunk_steps, -1), both[-1])
        return trace

    def harvest(self, trace: Optional[np.ndarray],
                active: np.ndarray) -> None:
        """Move finished rows' requests out of ``live`` (``active`` as read
        after the refill or chunk); the tokens and counts are read only
        when a live row finished."""
        t0 = time.perf_counter()
        done = [i for i in self.live if not active[i]]
        if done:
            ngen = self.slots.n_generated.cpu().numpy()
            toks = self.slots.tokens.cpu().numpy()
            for i in done:
                r = self.live.pop(i)
                r.n_generated = int(ngen[i])
                r.tokens = toks[i, :r.n_generated].copy()
                if trace is None:
                    r.t_done = self.now            # finished at prefill
                else:
                    # last chunk step this row actually served
                    served = np.flatnonzero(trace[:, i])
                    last = int(served[-1]) + 1 if served.size else 0
                    r.t_done = self.now - trace.shape[0] + last
                self.completed.append(r)
        self.timings["harvest_s"] += time.perf_counter() - t0

    def idle(self, max_steps: Optional[int]) -> bool:
        """No live request: jump the clock to the next arrival, recording
        zero occupancy; False when there is nothing left to wait for."""
        if not self.pending:
            return False
        nxt = self.pending[0].arrival
        if max_steps is not None:
            nxt = min(nxt, max_steps)
        skip = max(nxt - self.now, 1)
        self.occ_rows.append(np.zeros((skip,) + self.shape, bool))
        self.now += skip
        return True

    def result(self, wall0: float, telem_axis: int) -> OnlineServeResult:
        if self.live:              # max_steps cut-off: partial progress
            ngen = self.slots.n_generated.cpu().numpy()
            toks = self.slots.tokens.cpu().numpy()
            for i, r in self.live.items():
                r.n_generated = int(ngen[i])
                r.tokens = toks[i, :r.n_generated].copy()
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)
        wall = time.perf_counter() - wall0
        occupancy = (np.concatenate(self.occ_rows, axis=0) if self.occ_rows
                     else np.zeros((0,) + self.shape, bool))
        n_tokens = int(sum(r.n_generated for r in self.completed))
        n_tokens += int(sum(r.n_generated for r in self.live.values()))
        telemetry = None
        if self.telem_rows:
            telemetry = {k: np.concatenate([row[k] for row in
                                            self.telem_rows],
                                           axis=telem_axis)
                         for k in self.telem_rows[0]}
        result = OnlineServeResult(
            completed=self.completed, occupancy=occupancy,
            n_arrived=self.queue.n_arrived, n_dropped=self.queue.n_dropped,
            total_steps=self.now, wall_s=wall, n_tokens=n_tokens,
            telemetry=telemetry, timings=dict(self.timings))
        if taps_enabled():
            _record_online(result)
        return result


def _check_engine(cfg: ModelConfig, params, device):
    tf.check_supported(cfg)
    slots_mod.check_family(cfg)
    return _check_params(cfg, params, device)


# --------------------------------------------------------------------------- #
# single-device online engine
# --------------------------------------------------------------------------- #
class OnlineServeEngine:
    """Serve a live request queue on one (aging) device.

    The service loop alternates two calls — refill freed slots (one prompt
    prefill, merged into the live state) and a ``chunk_steps``-long decode
    chunk — with host work between chunks limited to queue bookkeeping.
    With no mid-decode arrivals (all slots filled once, no EOS) the tokens
    equal ``ServeEngine.generate``'s at the same seed: the two engines
    derive the same key and fault-stream chains.  Defaults are the
    reference's (``use_systolic_kernel=False``, ``use_fused_kernel=True``);
    ``params`` must already live on ``device``.
    """

    def __init__(self, cfg: ModelConfig, params, *, runtime=None,
                 runtime_device: int = 0, n_slots: int = 4,
                 max_len: int = 512, max_new_cap: int = 64,
                 chunk_steps: int = 8, max_queue: int = 64,
                 use_systolic_kernel: bool = False,
                 use_fused_kernel: bool = True, seed: int = 0,
                 device="cuda"):
        """``runtime`` is a :class:`FleetRuntime` (served from its device
        ``runtime_device``, the reference's ``device=`` index) or any object
        exposing ``op_bers``."""
        self.device = _check_engine(cfg, params, device)
        self.cfg = cfg
        self.params = params
        if isinstance(runtime, FleetRuntime):
            runtime = runtime.device(runtime_device)
        self.runtime = runtime
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.max_new_cap = int(max_new_cap)
        self.chunk_steps = int(chunk_steps)
        self.max_queue = int(max_queue)
        self.use_kernel = use_systolic_kernel
        self.use_fused = use_fused_kernel
        self._key = prandom.PRNGKey(seed)

    # ServeEngine's derivation: the parity tests rely on the two engines
    # consuming identical key chains
    def _fault_config(self) -> Optional[FaultConfig]:
        if self.runtime is None:
            return None
        self._key, sub = prandom.split(self._key)
        return FaultConfig(bers=dict(self.runtime.op_bers()), key=sub,
                           step=0, use_systolic_kernel=self.use_kernel,
                           fused=self.use_fused)

    @torch.no_grad()
    def serve(self, requests: Sequence[Request], *, greedy: bool = True,
              temperature: Optional[float] = None,
              top_k: Optional[int] = None, eos_id: int = -1,
              max_steps: Optional[int] = None) -> OnlineServeResult:
        """Run the queue to completion (or ``max_steps``).  ``requests``
        arrive on the service clock at their ``arrival`` steps; the bounded
        queue applies admission control; ``eos_id=-1`` disables EOS."""
        K = self.n_slots
        fi = self._fault_config()
        self._key, call_key = prandom.split(self._key)
        temp = ServeEngine._temperature(greedy, temperature)
        loop = _Loop(self, requests, (K,), self.max_queue)
        ONLINE_PREFILL(self.cfg, self.max_len, top_k)
        ONLINE_CHUNK(self.cfg, self.chunk_steps, top_k)
        loop.slots = init_slots(self.cfg, K, self.max_len, self.max_new_cap,
                                call_key, dtype=tf.compute_dtype(self.params),
                                device=self.device)
        wall0 = time.perf_counter()
        while loop.pending or len(loop.queue) or loop.live:
            if max_steps is not None and loop.now >= max_steps:
                break
            loop.admit()
            free = loop.free_rows()
            take = loop.queue.take(len(free))
            if take:
                loop.refill(dict(zip(free, take)), fi, temp, eos_id, top_k,
                            None)
            if not loop.live:
                if len(loop.queue):
                    continue      # every refill finished at prefill
                if not loop.idle(max_steps):
                    break
                continue
            loop.chunk(fi, temp, eos_id, top_k, None)
        return loop.result(wall0, telem_axis=0)


# --------------------------------------------------------------------------- #
# fleet online engine: router-dispatched lanes, one forward a step
# --------------------------------------------------------------------------- #
class OnlineFleetEngine:
    """Serve a live queue across every lane of a :class:`FleetRuntime`.

    All N lanes advance in lockstep: one refill and one decode chunk per
    scheduling round for the whole fleet, the lanes' slots folded
    lane-major into ``N * K`` rows.  Between rounds a
    :mod:`repro_torch.sched.router` policy turns the queue's offered load
    into per-lane utilization targets, fed by each lane's measured
    occupancy of the previous chunk and the fleet's wear, and the
    dispatcher hands queued requests to the lanes with the most headroom.
    Each lane serves at its own row of the fleet's BER matrix, with its
    own fault and sampling streams (``split(key, N)``).
    """

    def __init__(self, cfg: ModelConfig, params, fleet: FleetRuntime, *,
                 n_slots: int = 4, max_len: int = 512,
                 max_new_cap: int = 64, chunk_steps: int = 8,
                 max_queue: int = 256, router="wear_level",
                 capacity: float = 1.0,
                 use_systolic_kernel: bool = False,
                 use_fused_kernel: bool = True, seed: int = 0,
                 device="cuda"):
        from ..sched.router import get_router
        self.device = _check_engine(cfg, params, device)
        refuse_sharded_fleet(fleet, "OnlineFleetEngine")
        self.cfg = cfg
        self.params = params
        self.fleet = fleet
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.max_new_cap = int(max_new_cap)
        self.chunk_steps = int(chunk_steps)
        self.max_queue = int(max_queue)
        self.router = get_router(router)
        self.capacity = float(capacity)
        self.use_kernel = use_systolic_kernel
        self.use_fused = use_fused_kernel
        self._key = prandom.PRNGKey(seed)

    @property
    def n_devices(self) -> int:
        return self.fleet.n_devices

    def _fleet_fault_config(self, key: torch.Tensor) -> FaultConfig:
        """The lane config: each lane's BERs from the fleet's (N, O)
        matrix and a key of its own, ``split(key, N)[i]``."""
        ber = self.fleet.op_ber_array()
        bers = {op: tuple(float(b) for b in ber[:, i])
                for i, op in enumerate(self.fleet.operators)}
        return FaultConfig(bers=bers,
                           key=prandom.split(key, self.n_devices), step=0,
                           use_systolic_kernel=self.use_kernel,
                           fused=self.use_fused)

    def _wear(self) -> np.ndarray:
        """Per-device wear signal for the router (worst-domain ΔVth_p)."""
        return np.asarray(self.fleet.snapshot().dvth_p_mv).max(axis=-1)

    def _route(self, loop: _Loop, util_prev: np.ndarray,
               wear: np.ndarray) -> Dict[int, Request]:
        """Queued requests -> free rows, by the router's targets (run on
        the host: float32 CPU tensors, as the co-sim's routers)."""
        N, K, C = self.n_devices, self.n_slots, self.max_new_cap
        free = {n: [k for k in range(K) if n * K + k not in loop.live]
                for n in range(N)}
        # offered load in device-equivalents over the next chunk
        demand = sum(min(r.max_new, C) for r in loop.queue._q)
        load = demand / max(self.chunk_steps * K, 1)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        util = self.router.assign(
            torch.tensor(load, dtype=torch.float32), f32(wear),
            f32(util_prev), self.capacity).numpy().astype(np.float64)
        # lane headroom: target slots minus already-busy slots
        busy = np.asarray([K - len(free[n]) for n in range(N)], np.float64)
        head = np.maximum(util * K - busy, 0.0)
        assign: Dict[int, List[Request]] = {}
        for n in np.argsort(-head, kind="stable"):
            n = int(n)
            grab = loop.queue.take(min(int(np.ceil(head[n])), len(free[n])))
            if grab:
                assign[n] = grab
        # leftovers when every targeted lane is full: spill to any free
        # slot (defer only when the fleet is saturated)
        for n in range(N):
            room = len(free[n]) - len(assign.get(n, []))
            if room > 0 and len(loop.queue):
                assign.setdefault(n, []).extend(loop.queue.take(room))
        return {n * K + k: r for n, rs in assign.items()
                for k, r in zip(free[n], rs)}

    @torch.no_grad()
    def serve(self, requests: Sequence[Request], *, greedy: bool = True,
              temperature: Optional[float] = None,
              top_k: Optional[int] = None, eos_id: int = -1,
              max_steps: Optional[int] = None) -> OnlineServeResult:
        """Run the queue across the fleet; see
        :meth:`OnlineServeEngine.serve`.  ``occupancy`` comes back ``(T, N,
        K)``, so ``lane_utilization`` yields the ``(E, N)`` trace that
        ``FleetRuntime.apply_load(util_trace=...)`` replays."""
        N, K = self.n_devices, self.n_slots
        self._key, fi_key = prandom.split(self._key)
        self._key, call_key = prandom.split(self._key)
        fi = self._fleet_fault_config(fi_key)
        temp = ServeEngine._temperature(greedy, temperature)
        loop = _Loop(self, requests, (N, K), self.max_queue)
        ONLINE_FLEET_PREFILL(self.cfg, self.max_len, top_k)
        ONLINE_FLEET_CHUNK(self.cfg, self.chunk_steps, top_k)
        loop.slots = init_slots(self.cfg, N * K, self.max_len,
                                self.max_new_cap, prandom.split(call_key, N),
                                dtype=tf.compute_dtype(self.params),
                                device=self.device)
        util_prev = np.zeros((N,), np.float64)        # measured, fed back
        wear = self._wear()
        wall0 = time.perf_counter()
        while loop.pending or len(loop.queue) or loop.live:
            if max_steps is not None and loop.now >= max_steps:
                break
            loop.admit()
            if len(loop.queue):
                assign = self._route(loop, util_prev, wear)
                if assign:
                    loop.refill(assign, fi, temp, eos_id, top_k, N)
            if not loop.live:
                if len(loop.queue):
                    continue      # freed at prefill: dispatch again
                if not loop.idle(max_steps):
                    break
                util_prev = np.zeros((N,), np.float64)
                continue
            trace = loop.chunk(fi, temp, eos_id, top_k, N)
            util_prev = trace.mean(axis=(0, 2))       # measured duty (N,)
        return loop.result(wall0, telem_axis=-1)
