"""The online engines on the hybrid and SSM families against the
reference's on the CPU: reduced recurrentgemma_2b (RG-LRU states and a
local-attention ring of 16 slots that 8 + 12 tokens run past) and rwkv6_3b
(WKV states), faulted on the kernel-free route, with mid-decode arrivals;
one device and a 2-lane fleet.  Tokens, lanes, ``t_start`` / ``t_done``
and occupancy exact.  This file runs the hybrid; tests/
test_torch_online_ssm.py runs the same cases on the SSM."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import transformer as jax_tf
from repro.serve.online import OnlineFleetEngine as JaxOnlineFleetEngine
from repro.serve.online import OnlineServeEngine as JaxOnlineServeEngine
from repro.serve.online import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.serve.online import (OnlineFleetEngine, OnlineServeEngine,
                                      Request)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

S = 8


def build(arch):
    """The reference's seed-0 params of reduced ``arch`` in both packages,
    and four prompts from numpy."""
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    pj = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = params_from_reference(jax.tree.map(np.asarray, pj), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, S)).astype(np.int32)
    return cfg_j, cfg, pj, p, prompts


@pytest.fixture(scope="module")
def model():
    return build("recurrentgemma_2b")


def _check(got, want):
    by = lambda res: sorted(res.completed, key=lambda r: r.id)
    assert [r.id for r in by(got)] == [r.id for r in by(want)]
    for g, w in zip(by(got), by(want)):
        assert (g.lane, g.t_start, g.t_done, g.n_generated) == (
            w.lane, w.t_start, w.t_done, w.n_generated), g.id
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    np.testing.assert_array_equal(got.occupancy, np.asarray(want.occupancy))


def test_one_device_mid_decode_arrivals(model):
    cfg_j, cfg, pj, p, prompts = model
    reqs = [dict(id=0, prompt=prompts[0], max_new=5, arrival=0),
            dict(id=1, prompt=prompts[1], max_new=12, arrival=0),
            dict(id=2, prompt=prompts[0], max_new=5, arrival=1),
            dict(id=3, prompt=prompts[2], max_new=12, arrival=6)]
    jr = JaxFleetRuntime(n_devices=1)
    pr = FleetRuntime(n_devices=1, device="cpu")
    jr.set_age(years=9.0)
    pr.set_age(years=9.0)
    kw = dict(n_slots=2, max_len=32, max_new_cap=16, chunk_steps=4, seed=7)
    serve = dict(greedy=False, temperature=0.8)
    want = JaxOnlineServeEngine(cfg_j, pj, runtime=jr, **kw).serve(
        [JaxRequest(**r) for r in reqs], **serve)
    got = OnlineServeEngine(cfg, p, runtime=pr, device="cpu", **kw).serve(
        [Request(**r) for r in reqs], **serve)
    _check(got, want)
    assert got.n_completed == 4


def test_fleet_mid_decode_arrivals(model):
    cfg_j, cfg, pj, p, prompts = model
    jf = JaxFleetRuntime(n_devices=2)
    pf = FleetRuntime(n_devices=2, device="cpu")
    for f in (jf, pf):
        f.set_age(years=8.0, device=0)
    reqs = [dict(id=i, prompt=prompts[i % 4], max_new=6, arrival=i)
            for i in range(7)]
    kw = dict(n_slots=2, max_len=32, max_new_cap=8, chunk_steps=4, seed=4)
    serve = dict(greedy=False, temperature=0.8)
    want = JaxOnlineFleetEngine(cfg_j, pj, jf, **kw).serve(
        [JaxRequest(**r) for r in reqs], **serve)
    got = OnlineFleetEngine(cfg, p, pf, device="cpu", **kw).serve(
        [Request(**r) for r in reqs], **serve)
    _check(got, want)
    assert got.occupancy.shape[1:] == (2, 2)
