"""Shared set-up of the mesh-serving parity tests
(tests/test_torch_mesh_serve.py, tests/test_torch_mesh_families.py): the
reference's single-process oracle of its mesh engine, and the port's
engine on the same params and shard ages.

The oracle at tp > 1 is the reference's unmeshed generation function
(``steps.make_generate_fn``) fed a ``FaultConfig`` of ``(S,)`` BER
vectors from the reference's ``FleetRuntime(n_shards=S)``, with the keys
its ``MeshServeEngine`` derives: by the reference's own contract (the
serve layout shards output dimensions only; its ``shard_map``-wrapped
kernel and kernel-free route draw the same streams) these are the mesh
engine's tokens, which the reference cannot produce on this jax over
several devices.  Both sides serve float32 params: the engine's default
bf16 cast is exact on both, but bf16 generation drifts between the two
packages' float paths (ROADMAP §C), so exact tokens are held in
float32.  The ranks' tests (tests/test_torch_mesh_ranks*.py) share the
oracle and :func:`ranks_beside`."""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.launch.mesh import run_local_ranks

AGES = (1.5, 4.0, 6.5, 9.0)
BER_RTOL = 1e-3


def model(arch: str):
    """(reference cfg, port cfg, reference float32 params, port params)
    of reduced ``arch``, the reference's seed-0 params."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax_init_train_state(jcfg, jax.random.PRNGKey(0)).params
    jp = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    return jcfg, cfg, jp, params_from_reference(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def shard_fleets(tp: int, ages=AGES, cfg=None):
    """The reference's and the port's one-device fleets of ``tp`` shards
    aged ``ages`` (cycled), with the model's operator domains."""
    jf = JaxFleetRuntime.for_model(cfg[0], n_devices=1, n_shards=tp) \
        if cfg else JaxFleetRuntime(n_devices=1, n_shards=tp)
    pf = FleetRuntime.for_model(cfg[1], n_devices=1, n_shards=tp,
                                device="cpu") if cfg else \
        FleetRuntime(n_devices=1, n_shards=tp, device="cpu")
    for s in range(tp):
        age = ages[s % len(ages)]
        jf.set_age(years=age, shard=s)
        pf.set_age(years=age, shard=s)
    return jf, pf


def oracle_tokens(jcfg, jparams, jfleet, prompts, n_steps, *, seed=0,
                  temperature=0.0, top_k=None, max_len=32, extras=()):
    """The reference's mesh-engine tokens for its first generate call:
    ``MeshServeEngine``'s key splits, the fleet's shard-BER vectors."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    key, call_key = jax.random.split(key)
    tab = np.asarray(jfleet.op_ber_shard_array())[0]
    fi = JaxFaultConfig(
        bers={op: jnp.asarray(tab[:, i], jnp.float32)
              for i, op in enumerate(jfleet.operators)},
        key=sub, step=jnp.int32(0), use_systolic_kernel=False, fused=False)
    gen = _generate_fn(jcfg, max_len, n_steps, top_k)
    tokens, _ = gen(jparams, jnp.asarray(prompts, jnp.int32), fi, call_key,
                    jnp.float32(temperature), *extras)
    return np.asarray(tokens)


@functools.lru_cache(maxsize=None)
def _generate_fn(jcfg, max_len, n_steps, top_k):
    """The reference's generation, jitted as its mesh engine jits it, once
    a signature (greedy and sampled calls share it: the temperature is
    traced)."""
    return jax.jit(jax_steps.make_generate_fn(jcfg, max_len, n_steps,
                                              top_k))


def prompts(vocab: int, seed: int, batch: int = 2, length: int = 8):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


def ranks_beside(fn, world: int, *args, beside):
    """``run_local_ranks(fn, world, *args)`` on gloo CPU ranks, in a thread
    while ``beside()`` (the reference's oracle, the one-device engine)
    runs here: -> ``(the ranks' results, beside's result)``.  A failing
    rank raises here."""
    out, errors = [], []

    def spawn():
        try:
            out.append(run_local_ranks(fn, world, *args, backend="gloo",
                                       device="cpu", timeout=300))
        except Exception as e:                      # re-raised below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        here = beside()
    finally:
        thread.join(timeout=600)
    if thread.is_alive():
        raise RuntimeError(f"{world} ranks did not finish")
    if errors:
        raise errors[0]
    return out[0], here
