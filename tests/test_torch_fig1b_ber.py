"""The ported Fig. 1(b) benchmark (repro_torch.benchmarks.fig1b_ber)
against the reference's ``benchmarks/fig1b_ber.py`` on the CPU, from the
same initial params: the trained loss, the NLL at every BER and the
printed report.  Its own file, because the reference's eager BER sweep
alone takes ~30 s."""
import re

import jax
import numpy as np
import pytest
import torch

from benchmarks import fig1b_ber as jax_fig1b_ber
from repro.configs import get_config as jax_get_config
from repro.train import steps as jax_steps
from repro_torch.benchmarks import fig1b_ber
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.train import steps

# the train steps' loss tolerance (tests/test_torch_train.py): float32 sums
# in another order than XLA's, a few ulps a step
LOSS_RTOL = 2e-6

# a bit flipped high in an accumulator scales that value's last-ulp
# differences (XLA's and torch's sums, and the ulps 80 steps leave in the
# params) by up to the flipped power of two: the injected rows' NLL
# within INJECTED_RTOL, the clean row's printed line equal
INJECTED_RTOL = 5e-4
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (the suite runs several workers,
    and a worker's idle pool threads spinning against the others' slow
    the training's many small operations many times over); restored after
    the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fig1b_ber_matches_reference(monkeypatch):
    """From the reference's initial params, the ported Fig. 1(b) trains to
    the reference's loss (within 5 * LOSS_RTOL) and prints the reference
    benchmark's report line for line, but for the numbers taken from the
    injected rows (their NLL and ppl, and the ΔNLL of two checks), which
    agree within INJECTED_RTOL of the NLL and the printed rounding."""
    trained, train_small = {}, jax_fig1b_ber.train_small

    def recorded_train_small(*args, **kwargs):
        out = train_small(*args, **kwargs)
        trained["loss"] = out[3]
        return out

    monkeypatch.setattr(jax_fig1b_ber, "train_small", recorded_train_small)
    want = jax_fig1b_ber.run().splitlines()

    jst = jax_steps.init_train_state(
        jax_get_config("llama3_8b").reduced(), jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jst.params),
                                   get_config("llama3_8b").reduced(),
                                   device="cpu")
    monkeypatch.setattr(fig1b_ber, "init_train_state",
                        lambda cfg, seed, device: steps.TrainState(
                            params, adamw_init(params)))
    res = fig1b_ber.evaluate(device="cpu")
    got = res["text"].splitlines()
    assert all(c["ok"] for c in res["checks"]), res["text"]
    assert res["rows"]["train_loss"] == pytest.approx(trained["loss"],
                                                      rel=5 * LOSS_RTOL)
    assert len(got) == len(want)
    injected = range(4, 3 + len(fig1b_ber.BERS))     # the rows with BER > 0
    nll_tol = INJECTED_RTOL * max(res["rows"]["nll"])
    for i, (g, w) in enumerate(zip(got, want)):
        if i not in injected and "ΔNLL" not in w:
            assert g == w
            continue
        # the same words, BER labels and marks; the numbers within the
        # tolerance plus their printed rounding (4 decimals for an NLL,
        # 1 for a ppl, 3 or 4 for a ΔNLL)
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w)
        gn, wn = (np.array([float(x) for x in _NUMBER.findall(line)])
                  for line in (g, w))
        if i in injected:       # BER, NLL, ppl
            assert gn[0] == wn[0]
            assert gn[1] == pytest.approx(wn[1], rel=INJECTED_RTOL,
                                          abs=1e-4)
            assert gn[2] == pytest.approx(wn[2], rel=2 * INJECTED_RTOL,
                                          abs=0.1)
        else:                   # the ΔNLL of a check
            np.testing.assert_allclose(gn, wn, rtol=0, atol=nll_tol + 1e-3)
