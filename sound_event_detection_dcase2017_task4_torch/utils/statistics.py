"""Run statistics container (reference:
``utils/utilities.py:StatisticsContainer``; SURVEY.md §2/§5).

Appends ``{iteration, at metrics, sed metrics}`` records and pickles them at
every evaluation, plus a timestamped backup — same schema, so plotting
tooling written against the reference's ``statistics.pickle`` keeps working.
A JSONL mirror is written alongside for grep-able observability.

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/utils/statistics.py``, kept as
it is: the port never imports the JAX package, so it carries its own (the
CPU tests hold the two to equal outputs).
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
from typing import Dict, List

import numpy as np

__all__ = ["StatisticsContainer", "best_iteration", "jsonable"]


def best_iteration(statistics_path: str) -> tuple:
    """``(iteration, mAP, n_evals)`` of the highest test-split mAP eval in
    a run's ``statistics.pickle`` — the single model-selection rule behind
    the CLI's ``--iteration best`` and serving's ``iteration="best"``
    (checkpoints are written at every eval, so the argmax iteration always
    has one)."""
    if not os.path.isfile(statistics_path):
        raise FileNotFoundError(
            f"'best' model selection needs {statistics_path} (train first)")
    with open(statistics_path, "rb") as f:
        records = pickle.load(f)
    test = [r for r in records
            if r.get("data_type") == "test" and "at" in r]
    if not test:
        raise ValueError(
            f"'best' model selection: no test-split eval records in "
            f"{statistics_path}")
    best = max(test, key=lambda r: r["at"]["mAP"])
    return int(best["iteration"]), float(best["at"]["mAP"]), len(test)


def jsonable(obj):
    """Spec-valid-JSON conversion: numpy → native, NaN/Inf → null (strict
    JSON has no NaN token; per-class AP is NaN for classes without
    positives). Shared by the JSONL mirror and ``--metrics_out``."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


_jsonable = jsonable           # original private spelling (internal callers)


class StatisticsContainer:
    def __init__(self, statistics_path: str):
        self.statistics_path = statistics_path
        self.backup_path = "{}_{}.pickle".format(
            os.path.splitext(statistics_path)[0],
            datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
        self.statistics_list: List[Dict] = []
        os.makedirs(os.path.dirname(os.path.abspath(statistics_path)),
                    exist_ok=True)

    def append(self, iteration: int, statistics: Dict, data_type: str) -> None:
        self.statistics_list.append(
            {"iteration": iteration, "data_type": data_type, **statistics})

    def dump(self) -> None:
        with open(self.statistics_path, "wb") as f:
            pickle.dump(self.statistics_list, f)
        with open(self.backup_path, "wb") as f:
            pickle.dump(self.statistics_list, f)
        jsonl = os.path.splitext(self.statistics_path)[0] + ".jsonl"
        with open(jsonl, "w") as f:
            for rec in self.statistics_list:
                f.write(json.dumps(_jsonable(rec)) + "\n")

    def load(self, resume_iteration: int | None = None) -> None:
        with open(self.statistics_path, "rb") as f:
            self.statistics_list = pickle.load(f)
        if resume_iteration is not None:
            self.statistics_list = [
                s for s in self.statistics_list
                if s["iteration"] <= resume_iteration]
