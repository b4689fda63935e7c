"""Faults planted in the port under the harness, to show that the
comparison deciding ``correct`` fails them. Used by the tests (on the CPU)
and by ``tools/readings.py --fault`` (on the card, at the cell's size).

    with planted("half"):
        ...                 # the port, broken underneath

Training: ``state`` (the optimizer step returns the state unchanged),
``half`` (the loss is the mean over half the batch), ``answer`` (the
state the step produces is altered: one leaf moves double), ``exchange``
(the gradient average and BatchNorm's sums between chips left out: a
multi-chip cell's fault).
"""

from __future__ import annotations

import contextlib


def _state(patch):
    import torch

    patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half(patch):
    from sound_event_detection_dcase2017_task4_torch import losses

    def half(output_dict, target):
        n = target.shape[0] // 2
        return losses._bce(output_dict["clipwise_output"][:n], target[:n]).mean()

    patch(losses, "_LOSSES", dict(losses._LOSSES, clip_bce=half))


def _answer(patch):
    import torch

    step = torch.optim.Adam.step

    def doubled(self, closure=None):             # the first leaf moves double
        p = self.param_groups[0]["params"][0]
        before = p.detach().clone()
        out = step(self, closure)
        with torch.no_grad():
            p.add_(p - before)
        return out

    patch(torch.optim.Adam, "step", doubled)


def _exchange(patch):
    from sound_event_detection_dcase2017_task4_torch import parallel

    patch(parallel, "average_", lambda tensors, mesh: None)
    patch(parallel, "all_reduce_sum", lambda x, mesh: x)


FAULTS = {"state": _state, "half": _half, "answer": _answer, "exchange": _exchange}


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` for the ``with`` body; every attribute it
    replaced is put back after."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
