"""The comparison that decides ``correct`` must fail what is not the
program computing the cell: the control (the reference in the program's
place at the precision below the configuration's) and each fault a cell
can have, planted in the port under the harness. These drive the rest of a
run on the CPU (the look for a card skipped) at a small size: 0.5 s clips,
a global batch of 4 from a 40-clip bank (4 gloo ranks of one row each for
the four-chip cell).

    python -m pytest benchmark/tests -q --noconftest
"""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common, train_cell  # noqa: E402
from benchmark.tests import jax_rank  # noqa: E402

SEED = 2 ** 31 + 11


DP = "crnn_train_dp4"


def small(workload):
    c = common.cell(workload)
    c["config"]["frontend"]["clip_samples"] = 16000
    c["config"]["train"].update(batch=4 // c["workload"]["chips"], bank_clips=40)
    return c


def correct(workload, control=None, fault=None):
    c = small(workload)
    result, readings, _ = train_cell.run(c, SEED, 0.3, False, "cpu", time.perf_counter(),
                                         control=control, fault=fault)
    ok, checks = common.judge(readings, c["limits"])
    return ok and result["failed"] == 0, checks


TRAIN = ["crnn_train_bank", "glu_train_bank"]
CELLS = TRAIN + [DP]


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(workload):
    ok, checks = correct(workload)
    assert ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    ok, checks = correct(workload, small(workload)["config"]["train"]["control"])
    assert not ok, checks


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in TRAIN for f in ("state", "half", "answer")] + [
    (DP, f) for f in ("state", "half", "answer", "exchange")])
def test_a_training_fault_is_not_correct(workload, fault):
    ok, checks = correct(workload, fault=fault)
    assert not ok, checks


@pytest.mark.parametrize("stub_rank,found", [("1", ["jax"]), ("", [])])
def test_a_jax_module_in_any_rank_is_found(monkeypatch, stub_rank, found):
    """The ranks of a multi-chip cell are processes of their own: each
    reports the JAX modules it holds once its window has closed, and the
    result carries them for ``run.py`` to refuse (2 gloo ranks here, rank
    1 holding an empty stub named ``jax``)."""
    c = small(DP)
    c["workload"]["chips"], c["config"]["train"]["batch"] = 2, 2
    monkeypatch.setattr(train_cell, "RANK_TARGET", "benchmark.tests.jax_rank:rank_run")
    monkeypatch.setenv(jax_rank.STUB_RANK, stub_rank)
    result, _, _ = train_cell.run(c, SEED, 0.3, False, "cpu", time.perf_counter())
    assert result["forbidden"] == found
