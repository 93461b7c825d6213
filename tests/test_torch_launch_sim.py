"""The port's sweep, schedule and train launchers on the CPU against the
reference's ``main(argv)`` at small arguments: ``repro_torch.launch.
sweep``'s savings grid, ``.schedule``'s per-router fleet-max ΔVth and one
``--scenario``, ``.train``'s loss history from the reference's params,
and the serve launcher on a VLM (its prefix embeddings)."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch import schedule as jax_schedule
from repro.launch import sweep as jax_sweep
from repro.launch import train as jax_train
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.convert import params_from_reference
from repro_torch.launch import schedule, sweep, train
from repro_torch.optim import adamw_init
from repro_torch.train.steps import TrainState
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

# the lifetime power savings: float32 simulations in another order
SAVING_ATOL = 1e-4
# the training loss after a few AdamW steps (tests/test_torch_train.py
# holds single steps at 2e-6; three steps carry the drift along)
LOSS_RTOL = 1e-5


def test_sweep_matches_reference():
    got = sweep.main(["--device", "cpu"])
    want = jax_sweep.main([])
    assert got["saving"].shape == np.asarray(want["saving"]).shape == (3, 3)
    np.testing.assert_allclose(got["saving"], want["saving"], rtol=0,
                               atol=SAVING_ATOL)
    np.testing.assert_array_equal(got["v_final"], want["v_final"])


def test_schedule_routers_match_reference(capsys):
    """The router comparison: the co-sim is the reference's bit for bit
    (ROADMAP C.3), so each router's fleet-max ΔVth is equal."""
    argv = ["--epochs", "48", "--n-devices", "4"]
    got = schedule.main(argv + ["--device", "cpu"])
    want = jax_schedule.main(argv)
    assert set(got) == set(want)
    for name in want:
        assert got[name]["fleet_max_dvp_mv"] == pytest.approx(
            float(want[name]["fleet_max_dvp_mv"]), rel=1e-6)
        assert got[name]["p_avg_w"] == pytest.approx(
            float(want[name]["p_avg_w"]), rel=1e-6)
    assert "wear_level vs round_robin" in capsys.readouterr().out


def test_schedule_scenario_matches_reference():
    """``--scenario retirement``: the survivors' wear before and after."""
    argv = ["--epochs", "48", "--n-devices", "4", "--scenario",
            "retirement"]
    got = schedule.main(argv + ["--device", "cpu"])
    want = jax_schedule.main(argv)
    for k in ("fleet_max_dvp_mv", "survivor_pre_max_dvp_mv"):
        assert got["stats"][k] == pytest.approx(float(want["stats"][k]),
                                                rel=1e-6), k
    assert got["stats"]["n_after"] == want["stats"]["n_after"] == 3


def test_train_loss_history_matches_reference(monkeypatch):
    """Three reduced steps from the reference's params: the loss history
    of the port's TrainLoop against the reference's."""
    def reference_state(cfg, seed=0, device="cuda", **kw):
        jst = jax_init_train_state(jax_get_config("llama3_8b").reduced(),
                                   jax.random.PRNGKey(seed))
        params = params_from_reference(jax.tree.map(np.asarray, jst.params),
                                       cfg, device=device)
        return TrainState(params=params, opt=adamw_init(params))
    monkeypatch.setattr(train, "init_train_state", reference_state)
    argv = ["--arch", "llama3_8b", "--steps", "3", "--batch", "4", "--seq",
            "16"]
    got = [h["loss"] for h in train.main(argv + ["--device", "cpu"]).history]
    want = [h["loss"] for h in jax_train.main(argv).history]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_train_refuses_model_parallel():
    with pytest.raises(NotImplementedError, match="A.8"):
        train.main(["--model-parallel", "2", "--device", "cpu"])


def test_serve_vlm_extras_match_reference(monkeypatch):
    """The serve CLI feeds a VLM its zero prefix embeddings, as the
    reference's does: paligemma_3b's tokens."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    from test_torch_launch import reference_served_params
    monkeypatch.setattr(serve, "served_params", reference_served_params)
    argv = ["--arch", "paligemma_3b", "--gen-len", "2", "--prompt-len", "8",
            "--batch", "1", "--router", "static"]
    got = serve.main(argv + ["--torch-device", "cpu"])
    want = jax_serve.main(argv)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
