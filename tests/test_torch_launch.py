"""The port's serving launcher on the CPU against the reference's:
``repro_torch.launch.serve`` (one device and the fleet, greedy and
sampled, static and routed aging) against the reference's ``main(argv)``
at small arguments, with the reference's params (``init_train_state(cfg,
PRNGKey(0))``) carried across by ``repro_torch.convert``;
``configs.shapes``; and the flags that are not ported, which raise naming
their ROADMAP item (``--online`` delegates to the online launcher:
tests/test_torch_online_entry.py).  (The quickstart, which serves through
the same params hook, is in tests/test_torch_bench_entry.py.)"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.launch import serve as jax_serve
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.configs import ARCH_IDS, get_config, shapes
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

SMALL = ["--gen-len", "2", "--prompt-len", "8", "--batch", "1"]
# the admitted BERs: the physics' float32 drift (ROADMAP §C)
BER_RTOL = 1e-3


def reference_served_params(cfg, device):
    """The reference's seed-0 params of ``cfg``, on ``device``."""
    arch = next(a for a in ARCH_IDS if get_config(a).name == cfg.name)
    jp = jax_init_train_state(jax_get_config(arch).reduced(),
                              jax.random.PRNGKey(0)).params
    return params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                 device=device)


@pytest.fixture(autouse=True)
def reference_params(monkeypatch):
    """Both packages serve the reference's seed-0 params."""
    monkeypatch.setattr(serve, "served_params", reference_served_params)


def _run(argv):
    return (serve.main(argv + ["--torch-device", "cpu"]),
            jax_serve.main(argv))


@pytest.mark.parametrize("extra", [
    ["--router", "static"],
    ["--router", "static", "--temperature", "0.8", "--top-k", "8"],
    ["--router", "static", "--n-devices", "3", "--device", "1"],
], ids=["greedy", "sampled", "lane"])
def test_serve_one_device_matches_reference(extra, capsys):
    got, want = _run(SMALL + extra)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert set(got.bers) == set(want.bers)
    for op, v in want.bers.items():
        assert got.bers[op] == pytest.approx(float(v), rel=BER_RTOL)
    assert got.age_years == pytest.approx(want.age_years, rel=1e-6)
    assert "[serve] per-op BER" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--router", "static"],
    ["--router", "static", "--temperature", "0.8"],
    ["--router", "round_robin", "--horizon-years", "1"],
], ids=["greedy", "sampled", "round_robin"])
def test_serve_fleet_matches_reference(extra):
    got, want = _run(SMALL + ["--n-devices", "3"] + extra)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.operators == tuple(want.operators)
    np.testing.assert_allclose(got.bers, np.asarray(want.bers),
                               rtol=BER_RTOL)
    np.testing.assert_allclose(got.ages_years, np.asarray(want.ages_years),
                               rtol=1e-6)


def test_serve_eager_is_single_device_only():
    with pytest.raises(SystemExit):
        serve.main(SMALL + ["--n-devices", "2", "--eager",
                            "--torch-device", "cpu"])
    res = serve.main(SMALL + ["--router", "static", "--eager",
                              "--torch-device", "cpu"])
    assert res.tokens.shape == (1, 2)


@pytest.mark.parametrize("argv,item", [
    (["--mesh"], "A.8"), (["--tp", "2"], "A.8"), (["--no-fused"], "A.8"),
    (["--stats"], "compiles nothing")])
def test_serve_refuses_unported_flags(argv, item):
    """``--stats`` raises.  The A.8 flags, refused until A.8a, now serve:
    ``--mesh`` one device of mesh shards (tests/test_torch_mesh_cli.py
    holds it against the reference); ``--tp`` and ``--no-fused`` without
    ``--mesh`` are ignored, as in the reference."""
    if item == "A.8":
        res = serve.main(SMALL + argv + ["--router", "static",
                                         "--torch-device", "cpu"])
        assert res.tokens.shape == (1, 2)
        assert hasattr(res, "operators") == ("--mesh" in argv)
        return
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        serve.main(SMALL + argv + ["--torch-device", "cpu"])


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_shapes_applicable_matches_reference(arch):
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    assert set(shapes.SHAPES) == set(jax_shapes.SHAPES)
    for name, cell in shapes.SHAPES.items():
        jcell = jax_shapes.SHAPES[name]
        assert (cell.seq_len, cell.global_batch, cell.kind) == (
            jcell.seq_len, jcell.global_batch, jcell.kind)
        assert shapes.applicable(get_config(arch), cell) == \
            jax_shapes.applicable(jax_get_config(arch), jcell)
