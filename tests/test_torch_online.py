"""The port's one-device continuous-batching engine against the
reference's on the CPU (``tests/test_serve_online.py``'s cases, each held
against ``repro.serve.online``): the no-arrival contract (clean and
faulted, also against ``ServeEngine.generate``), the 3-requests / 2-slots
schedule, EOS, admission control, the queue bound, the measured
occupancy, no new served-shape key across refills, the workload sizing,
and the MoE family's capacity case (garbage rows of idle slots compete
for expert capacity, as in the reference).

Tolerances: tokens, ``t_start`` / ``t_done``, occupancy and drop counts
exact; utilization to 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import transformer as jax_tf
from repro.serve.online import OnlineServeEngine as JaxOnlineServeEngine
from repro.serve.online import Request as JaxRequest
from repro.serve.online import requests_from_workload as jax_requests
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.serve import online
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.online import (OnlineServeEngine, Request,
                                      RequestQueue, requests_from_workload)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

S = 8               # fixed prompt length for the run
MAX_LEN = 64


def _model(arch):
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    pj = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = params_from_reference(jax.tree.map(np.asarray, pj), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, S)).astype(np.int32)
    return cfg_j, cfg, pj, p, prompts


@pytest.fixture(scope="module")
def setup():
    return _model("deepseek_7b")


def _runtimes(years):
    if years is None:
        return None, None
    jr, pr = JaxFleetRuntime(n_devices=1), FleetRuntime(n_devices=1,
                                                         device="cpu")
    jr.set_age(years=years)
    pr.set_age(years=years)
    return jr, pr


def _engines(model, *, years=None, n_slots=3, chunk=4, seed=5,
             max_new_cap=16, max_queue=64, kernel=False):
    cfg_j, cfg, pj, p, _ = model
    jr, pr = _runtimes(years)
    kw = dict(n_slots=n_slots, max_len=MAX_LEN, max_new_cap=max_new_cap,
              chunk_steps=chunk, max_queue=max_queue, seed=seed,
              use_systolic_kernel=kernel)
    return (JaxOnlineServeEngine(cfg_j, pj, runtime=jr, **kw),
            OnlineServeEngine(cfg, p, runtime=pr, device="cpu", **kw), pr)


def _serve_both(model, reqs, serve_kw=None, **eng_kw):
    """The same schedule through both engines; asserts equal results and
    returns the port's."""
    jeng, peng, _ = _engines(model, **eng_kw)
    serve_kw = serve_kw or {}
    want = jeng.serve([JaxRequest(**r) for r in reqs], **serve_kw)
    got = peng.serve([Request(**r) for r in reqs], **serve_kw)
    assert_same(got, want)
    return got


def assert_same(got, want):
    by = lambda res: sorted(res.completed, key=lambda r: r.id)
    assert [r.id for r in by(got)] == [r.id for r in by(want)]
    for g, w in zip(by(got), by(want)):
        assert (g.t_start, g.t_done, g.n_generated, g.lane) == (
            w.t_start, w.t_done, w.n_generated, w.lane), g.id
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    np.testing.assert_array_equal(got.occupancy, np.asarray(want.occupancy))
    assert (got.n_arrived, got.n_dropped, got.total_steps, got.n_tokens) \
        == (want.n_arrived, want.n_dropped, want.total_steps, want.n_tokens)


def _tokens_by_id(res):
    return np.stack([r.tokens for r in sorted(res.completed,
                                              key=lambda r: r.id)])


# --------------------------------------------------------------------------- #
# the no-arrival contract
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("years", [None, 9.0], ids=["clean", "faulted"])
def test_no_arrival_bit_exact(setup, years):
    """All slots filled once at step 0, no EOS: the port's chunked path
    gives the reference online engine's tokens and the port's
    ``ServeEngine.generate``'s, 9 = 1 + 2 chunks of 4 steps."""
    K, n_steps = 3, 9
    prompts = setup[4]
    reqs = [dict(id=i, prompt=prompts[i], max_new=n_steps)
            for i in range(K)]
    got = _serve_both(setup, reqs, dict(greedy=False, temperature=0.7),
                      years=years, n_slots=K)
    _, pr = _runtimes(years)
    ref = ServeEngine(setup[1], setup[3], runtime=pr, max_len=MAX_LEN,
                      seed=5, device="cpu").generate(
        prompts[:K], n_steps, temperature=0.7).tokens
    np.testing.assert_array_equal(_tokens_by_id(got), ref)


# --------------------------------------------------------------------------- #
# slot-refill schedule, EOS, admission
# --------------------------------------------------------------------------- #
def test_refill_schedule_3_requests_2_slots(setup):
    """The reference's hand-made run: the third request waits for a freed
    slot, every budget is honoured, and a greedy prompt gives the same
    tokens whichever slot served it."""
    prompts = setup[4]
    reqs = [dict(id=0, prompt=prompts[0], max_new=5, arrival=0),
            dict(id=1, prompt=prompts[1], max_new=9, arrival=0),
            dict(id=2, prompt=prompts[0], max_new=5, arrival=1)]
    res = _serve_both(setup, reqs, dict(greedy=True), n_slots=2, seed=7)
    assert res.n_completed == 3 and res.n_dropped == 0
    by_id = {r.id: r for r in res.completed}
    assert [by_id[i].n_generated for i in range(3)] == [5, 9, 5]
    assert by_id[2].t_start >= by_id[0].t_done
    assert by_id[2].t_start > 0 and by_id[0].t_start == 0
    np.testing.assert_array_equal(by_id[0].tokens, by_id[2].tokens)
    assert res.occupancy.shape == (res.total_steps, 2)


def test_faulted_kernel_route_mid_decode_arrivals(setup):
    """A 9-year device on the fused route (the reference's Pallas kernel in
    interpret mode), sampled, with arrivals mid-decode and a one-token
    budget that completes at prefill."""
    prompts = setup[4]
    reqs = [dict(id=0, prompt=prompts[0], max_new=5, arrival=0),
            dict(id=1, prompt=prompts[1], max_new=12, arrival=0),
            dict(id=2, prompt=prompts[2], max_new=1, arrival=2),
            dict(id=3, prompt=prompts[3], max_new=7, arrival=3),
            dict(id=4, prompt=prompts[0], max_new=6, arrival=9)]
    res = _serve_both(setup, reqs, dict(greedy=False, temperature=0.8),
                      years=9.0, n_slots=2, seed=7, kernel=True)
    by_id = {r.id: r for r in res.completed}
    assert by_id[2].n_generated == 1 and by_id[2].t_done == by_id[2].t_start


def test_eos_completion_frees_slot(setup):
    """A request whose sampled token is ``eos_id`` retires after it; its
    slot serves the next request."""
    prompts = setup[4]
    _, probe, _ = _engines(setup, n_slots=1, seed=3)
    first = int(probe.serve([Request(id=0, prompt=prompts[0], max_new=6)],
                            greedy=True).completed[0].tokens[0])
    reqs = [dict(id=0, prompt=prompts[0], max_new=6),
            dict(id=1, prompt=prompts[1], max_new=4)]
    res = _serve_both(setup, reqs, dict(greedy=True, eos_id=first),
                      n_slots=1, seed=3)
    by_id = {r.id: r for r in res.completed}
    assert by_id[0].n_generated == 1
    assert by_id[1].n_generated >= 1


def test_admission_control_drops_when_full(setup):
    """More simultaneous arrivals than the queue holds: queue-first
    admission keeps 2, drops 4."""
    prompts = setup[4]
    reqs = [dict(id=i, prompt=prompts[i % 4], max_new=4, arrival=0)
            for i in range(6)]
    res = _serve_both(setup, reqs, dict(greedy=True), n_slots=1,
                      max_queue=2)
    assert (res.n_arrived, res.n_dropped, res.n_completed) == (6, 4, 2)
    assert 0.0 < res.drop_rate < 1.0


def test_request_queue_bounds():
    q = RequestQueue(max_queue=2)
    rs = [Request(id=i, prompt=np.zeros(4, np.int32), max_new=2)
          for i in range(4)]
    assert [q.push(r) for r in rs] == [True, True, False, False]
    assert (q.n_arrived, q.n_admitted, q.n_dropped) == (4, 2, 2)
    assert [r.id for r in q.take(5)] == [0, 1] and len(q) == 0


# --------------------------------------------------------------------------- #
# served shapes, occupancy, workload sizing
# --------------------------------------------------------------------------- #
def test_no_new_served_shape_across_refills(setup):
    """The reference re-traces nothing across slot churn; the port's
    counterpart: a second schedule (other arrivals, budgets, device age)
    adds no served-shape key."""
    _, cfg, _, p, prompts = setup
    rt = FleetRuntime(n_devices=1, device="cpu")
    rt.set_age(years=2.0)
    eng = OnlineServeEngine(cfg, p, runtime=rt, n_slots=2, max_len=MAX_LEN,
                            max_new_cap=16, chunk_steps=4, seed=1,
                            device="cpu")
    eng.serve([Request(id=i, prompt=prompts[i % 4], max_new=5,
                       arrival=2 * i) for i in range(4)], greedy=True)
    keys = lambda: (online.ONLINE_PREFILL.stats()["currsize"],
                    online.ONLINE_CHUNK.stats()["currsize"])
    before = keys()
    rt.set_age(years=8.0)
    res = eng.serve([Request(id=i, prompt=prompts[(i + 1) % 4],
                             max_new=3 + i % 4, arrival=3 * i)
                     for i in range(6)], greedy=True)
    assert keys() == before and res.n_completed == 6
    assert res.timings["n_chunks"] > 0 and res.timings["n_refills"] > 0


def test_occupancy_matches_hand_computed_duty(setup):
    prompts = setup[4]
    reqs = [dict(id=0, prompt=prompts[0], max_new=5),
            dict(id=1, prompt=prompts[1], max_new=9),
            dict(id=2, prompt=prompts[2], max_new=5, arrival=1)]
    res = _serve_both(setup, reqs, dict(greedy=True), n_slots=2, seed=7)
    occ = np.asarray(res.occupancy, np.float64)
    T = occ.shape[0]
    edges = np.linspace(0, T, 5).astype(int)
    want = np.asarray([occ[edges[e]:edges[e + 1]].mean() for e in range(4)])
    got = res.lane_utilization(4)
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert got.shape == (4,) and 0.0 <= got.min() and got.max() <= 1.0
    assert set(res.summary()) >= {"p50", "p99", "tok_per_s", "drop_rate",
                                  "mean_occupancy"}


@pytest.mark.parametrize("name", ["poisson", "diurnal", "bursty"])
def test_requests_from_workload_match_reference(name):
    """The same arrivals, prompts and budgets as the reference's (the
    workload trace is bit for bit, the offsets numpy's)."""
    kw = dict(n_slots=2, steps_per_epoch=16, max_new=6, prompt_len=S,
              vocab=256, n_devices=2, seed=3, n_epochs=5)
    got = requests_from_workload(name, **kw)
    want = jax_requests(name, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.id, g.arrival, g.max_new) == (w.id, w.arrival, w.max_new)
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_requests_from_workload_sizing():
    """Little's-law sizing: the count tracks load * slots * steps /
    max_new, and arrivals land inside their epoch."""
    loads = np.asarray([1.0, 0.0, 2.0], np.float64)
    reqs = requests_from_workload(
        None, loads=loads, n_slots=4, steps_per_epoch=100, max_new=10,
        prompt_len=8, vocab=64, seed=0)
    want = jax_requests(None, loads=loads, n_slots=4, steps_per_epoch=100,
                        max_new=10, prompt_len=8, vocab=64, seed=0)
    assert [r.arrival for r in reqs] == [r.arrival for r in want]
    assert not any(100 <= r.arrival < 200 for r in reqs)
    expect = (1.0 + 2.0) * 4 * 100 / 10
    assert 0.5 * expect < len(reqs) < 1.5 * expect
    assert all(len(r.prompt) == 8 and r.max_new == 10 for r in reqs)


# --------------------------------------------------------------------------- #
# the MoE family
# --------------------------------------------------------------------------- #
def test_moe_mid_decode_arrivals_match_reference():
    """Reduced qwen3_moe_235b, faulted at 9 years, sampled, with arrivals
    mid-decode: idle and retired slots' rows still route through the
    experts and take capacity, as in the reference."""
    model = _model("qwen3_moe_235b")
    prompts = model[4]
    reqs = [dict(id=0, prompt=prompts[0], max_new=5, arrival=0),
            dict(id=1, prompt=prompts[1], max_new=10, arrival=0),
            dict(id=2, prompt=prompts[2], max_new=6, arrival=1),
            dict(id=3, prompt=prompts[3], max_new=8, arrival=6)]
    res = _serve_both(model, reqs, dict(greedy=False, temperature=0.8),
                      years=9.0, n_slots=3, seed=7)
    assert res.n_completed == 4
