"""The port's online-serving entry points on the CPU against the
reference's ``main(argv)``: ``repro_torch.launch.online`` (one device and
a router-dispatched fleet, ``--quick``), ``launch.serve --online`` (which
hands its other arguments to it, ``--torch-device`` as ``--device``) and
the printed lines.  Both packages serve the reference's seed-0 params
(``init_train_state``) through the launchers' params hook.  Tokens,
times, counts and occupancy exact; the replayed wear within 1e-5
relative (ROADMAP §C)."""
import re

import numpy as np
import pytest
import torch

from repro.launch import online as jax_online
from repro_torch.launch import online, serve

from test_torch_launch import reference_served_params
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

WEAR_RTOL = 1e-5


@pytest.fixture(autouse=True)
def reference_params(monkeypatch):
    monkeypatch.setattr(serve, "served_params", reference_served_params)


def assert_same(got, want):
    by = lambda res: sorted(res.completed, key=lambda r: r.id)
    assert [r.id for r in by(got)] == [r.id for r in by(want)]
    for g, w in zip(by(got), by(want)):
        assert (g.lane, g.arrival, g.t_start, g.t_done, g.n_generated) == (
            w.lane, w.arrival, w.t_start, w.t_done, w.n_generated), g.id
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    np.testing.assert_array_equal(got.occupancy, np.asarray(want.occupancy))
    assert (got.n_arrived, got.n_dropped, got.total_steps, got.n_tokens) \
        == (want.n_arrived, want.n_dropped, want.total_steps, want.n_tokens)


def _lines(text: str):
    """The printed lines without their host-clock numbers (tok/s)."""
    return [re.sub(r"[\d.]+ tok/s", "<tok/s>", l)
            for l in text.splitlines() if l.startswith("[online]")]


def _wear(line: str):
    return [float(x) for x in re.findall(r"([\d.]+) mV", line)]


@pytest.mark.parametrize("extra", [
    [], ["--n-devices", "2", "--router", "least_aged"]],
    ids=["one_device", "fleet"])
def test_online_cli_matches_reference(extra, capsys):
    argv = ["--quick", "--arch", "llama3_8b"] + extra
    got = online.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    want = jax_online.main(argv)
    want_out = capsys.readouterr().out
    assert_same(got, want)
    g, w = _lines(got_out), _lines(want_out)
    assert g[:-1] == w[:-1] and len(g) == 4
    # the replay line: duty exact, the wear within the physics' drift
    assert g[-1].split("->")[0] == w[-1].split("->")[0]
    np.testing.assert_allclose(_wear(g[-1]), _wear(w[-1]), rtol=WEAR_RTOL,
                               atol=0.051)


def test_serve_online_delegates_to_the_online_launcher(capsys):
    """``serve --online`` is ``online.main`` with the other arguments,
    ``--torch-device`` becoming its ``--device``; serve's ``--device`` (a
    fleet lane) is refused."""
    argv = ["--quick", "--arch", "llama3_8b", "--max-new", "4"]
    got = serve.main(["--online"] + argv + ["--torch-device", "cpu"])
    got_out = capsys.readouterr().out
    want = online.main(argv + ["--device", "cpu"])
    assert_same(got, want)
    assert _lines(got_out) == _lines(capsys.readouterr().out)
    with pytest.raises(SystemExit, match="fleet lane"):
        serve.main(["--online", "--device", "1"] + argv)


def test_online_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        online.main(["--quick"])
