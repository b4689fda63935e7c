"""The port's root entry points (``graft_entry``) against ``__graft_entry__.py``.

* ``entry(device="cpu")``: the port's forward on the JAX entry's own
  parameters and running statistics (``args[0]``, ``args[1]``, bridged with
  ``load_jax_variables``) equals the JAX forward (its frontend on the CPU is
  the XLA path) within atol 1e-5, on the example zeros and on a
  numpy-seeded waveform, at the JAX entry's sizes (full-width
  ``Cnn_9layers_Gru_FrameAtt``, 4 clips of 2 s);
* ``dryrun_multichip(n, device="cpu")`` at 2 and 4 gloo ranks: every rank
  holds the data-parallel step to the same step with no mesh at
  ``__graft_entry__.py:203-208``'s tolerances (loss rtol 2e-5, grad-norm
  rtol 1e-4, BatchNorm statistics rtol 1e-4 / atol 1e-5) and runs the
  ragged eval; each launch has a deadline, so a hung rank fails the test;
* with no device both entry points need the card and raise without one.
"""

import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import graft_entry, parallel
from sound_event_detection_dcase2017_task4_torch.models import get_model
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as jax_entry  # noqa: E402

# a hung rank fails its test within this many seconds
DRYRUN_DEADLINE = 300.0


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jax_entry.entry()
    forward, args = graft_entry.entry(device="cpu")
    bridged = load_jax_variables(
        get_model(graft_entry.FLAGSHIP),
        {"params": _numpy_tree(jargs[0]), "batch_stats": _numpy_tree(jargs[1])})
    params = {k: v.detach() for k, v in bridged.named_parameters()}
    buffers = dict(bridged.named_buffers())
    return jax.jit(jfn), jargs, forward, args, params, buffers


def test_entry_example_arguments(both):
    _, jargs, _, args, params, buffers = both
    wave = args[2]
    assert wave.device.type == "cpu" and wave.dtype == torch.float32
    assert tuple(wave.shape) == np.shape(jargs[2]) == (4, 64000)
    assert not wave.any()
    assert set(args[0]) == set(params) and set(args[1]) == set(buffers)
    # the full-width flagship
    assert sum(p.numel() for p in args[0].values()) == 5_886_306


@pytest.mark.parametrize("wave", ["zeros", "seeded"])
def test_entry_matches_the_jax_entry(both, wave):
    jfn, jargs, forward, args, params, buffers = both
    x = (np.zeros((4, 64000), np.float32) if wave == "zeros" else
         (np.random.RandomState(5).randn(4, 64000) * 0.1).astype(np.float32))
    want = [np.asarray(a) for a in jfn(jargs[0], jargs[1], x)]
    got = [t.numpy() for t in forward(params, buffers, torch.from_numpy(x))]
    assert want[0].shape == got[0].shape == (4, 17)
    assert want[1].shape == got[1].shape == (4, 201, 17)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_entry_forward_is_a_function_of_its_arguments(both):
    """The same forward on its own seed-0 arguments and on the bridged
    ones: the outputs follow the parameters it is given."""
    _, _, forward, args, params, buffers = both
    x = torch.from_numpy(
        (np.random.RandomState(6).randn(4, 64000) * 0.1).astype(np.float32))
    own, bridged = forward(args[0], args[1], x), forward(params, buffers, x)
    again = forward(args[0], args[1], x)
    assert torch.equal(own[0], again[0])
    assert not torch.allclose(own[0], bridged[0], atol=1e-3)


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_entry_points_need_the_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "entry":
            graft_entry.entry()
        else:
            graft_entry.dryrun_multichip(1)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    out = graft_entry.dryrun_multichip(n, device="cpu",
                                       timeout=DRYRUN_DEADLINE)
    assert out["n_devices"] == n and out["backend"] == "gloo"
    np.testing.assert_allclose(out["loss"], out["loss_1"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out["grad_norm"], out["grad_norm_1"],
                               rtol=1e-4, atol=1e-6)
    assert np.isfinite(out["loss"]) and out["grad_norm"] > 0
    assert out["eval_shape"] == (2 * n - 1, 17)
    # the plain frontend on the CPU: no rank launched a kernel
    assert out["launches"] == [{"logmel": 0, "logmel_bank": 0}] * n
    assert f"dryrun_multichip({n}): OK" in capsys.readouterr().out


def test_dryrun_multichip_needs_a_rank():
    with pytest.raises(ValueError, match="needs a rank"):
        graft_entry.dryrun_multichip(0, device="cpu")


def test_a_launch_past_its_deadline_raises():
    """The ranks are killed and the call raises when the deadline passes
    (here one that has passed already)."""
    with pytest.raises(TimeoutError):
        graft_entry.dryrun_multichip(2, device="cpu", timeout=-1.0)


def test_a_failing_rank_fails_the_dry_run_at_once(monkeypatch):
    """A rank that exits with an error ends the launch (the other rank,
    which would wait, is killed) and its output is in the error."""
    monkeypatch.setattr(parallel.mesh, "_RANK_CODE", (
        "import os, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    raise SystemExit('rank one fails')\n"
        "time.sleep(120)\n"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 1 exited with 1:\n.*rank one fails"):
        graft_entry.dryrun_multichip(2, device="cpu", timeout=DRYRUN_DEADLINE)
    assert time.monotonic() - t0 < 60


def test_the_cli_runs_the_entry_on_the_cpu(capsys):
    graft_entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry: OK  clipwise (4, 17)  framewise (4, 201, 17)  on cpu" in out


def test_dryrun_multichip_ranks_start_at_the_first_card(monkeypatch):
    """Rank r takes cuda:r, so a card other than cuda:0 is refused rather
    than ignored."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="cuda:0 … cuda:0, not cuda:1"):
        graft_entry.dryrun_multichip(1, device="cuda:1")
