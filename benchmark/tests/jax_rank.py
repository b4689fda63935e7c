"""A rank of a multi-chip cell in which the rank named by ``STUB_RANK``
holds an empty module named ``jax``: the test that the harness finds a
JAX module in any rank runs the cell's ranks through it."""

import os
import sys
import types

from benchmark.harness import train_cell

STUB_RANK = "SEDBENCH_JAX_STUB_RANK"


def rank_run(arg, device):
    if os.environ.get(STUB_RANK) == os.environ["RANK"]:
        sys.modules["jax"] = types.ModuleType("jax")
    return train_cell.rank_run(arg, device)
