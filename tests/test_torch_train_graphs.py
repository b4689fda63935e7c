"""The one decision between CUDA graphs and the eager call for the train
step's forward (``models.train_graphs.train_forward``), on the CPU with
stand-ins: an input whose ``is_cuda`` reads true, a mesh, models with and
without the draw/pass split, and ``TrainGraphs`` replaced by a recorder,
so no card is needed.

The eager call is taken on a CPU input, under a mesh, with ``remat`` on,
while a profiler records and for a model without the split; otherwise
the masks are drawn eagerly and the drawn ones go to the graphs stacked,
with the pattern of the rates (no draw at rate 0) put back in the pass.
"""

import types

import pytest
import torch
from torch import nn

from sound_event_detection_dcase2017_task4_torch.models import train_graphs

# two blocks' draws: the first block at rate 0 draws nothing
RATES = (0.0, 0.0, 0.3, 0.3)


class _Plain(nn.Module):
    """A model with no split: its call is all a step can take."""

    remat = False

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.calls = []

    def forward(self, x, train=False, generator=None, mesh=None):
        self.calls.append(("eager", train, generator, mesh))
        return {"eager": x}


class _Split(_Plain):
    """A model that offers ``draw_masks`` and ``train_pass``."""

    def __init__(self, rates=RATES):
        super().__init__()
        self.rates = rates

    def draw_masks(self, batch, generator, mesh=None, device=None):
        self.calls.append(("draw", batch, generator, mesh))
        return [None if r == 0 else torch.rand(batch, generator=generator) < 1 - r
                for r in self.rates]

    def train_pass(self, x, masks):
        self.calls.append(("pass", masks))
        return {"pass": x}


class _Recorder:
    """Stands in for ``TrainGraphs``: records the module, the function and
    each call's inputs."""

    made = []

    def __init__(self, module, fn):
        self.module, self.fn, self.inputs = module, fn, []
        _Recorder.made.append(self)

    def __call__(self, *inputs):
        self.inputs.append(inputs)
        return {"graphs": inputs}

    def release(self):
        self.inputs.append("released")


@pytest.fixture
def recorder(monkeypatch):
    _Recorder.made = []
    monkeypatch.setattr(train_graphs, "TrainGraphs", _Recorder)
    return _Recorder.made


def _card_input(batch=3):
    """An input that reads as on a card."""
    return types.SimpleNamespace(is_cuda=True, shape=(batch, 10, 4),
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("case", ["cpu", "mesh", "remat", "profiler", "no_split"])
def test_the_eager_call_is_chosen(recorder, case):
    model = _Plain() if case == "no_split" else _Split()
    model.remat = case == "remat"
    mesh = types.SimpleNamespace(size=2, rank=0) if case == "mesh" else None
    x = torch.zeros(3, 10, 4) if case == "cpu" else _card_input()
    g = torch.Generator().manual_seed(0)
    forward = train_graphs.train_forward(model, mesh)
    model.calls.clear()
    if case == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = forward(x, generator=g)
    else:
        out = forward(x, generator=g)
    assert out == {"eager": x}
    assert model.calls == [("eager", True, g, mesh)]
    # a split model's eager call first gives its captures' memory back
    assert all(r.inputs == (["released"] if case in ("cpu", "profiler") else [])
               for r in recorder)


def test_graphs_are_chosen_when_nothing_stands_in_the_way(recorder):
    model = _Split()
    forward = train_graphs.train_forward(model)
    (graphs,) = recorder
    assert graphs.module is model
    assert forward.pattern == (False, False, True, True)
    model.calls.clear()
    x = _card_input()
    g = torch.Generator().manual_seed(0)
    out = forward(x, generator=g)
    assert [c[0] for c in model.calls] == ["draw"]
    assert model.calls[0][1:] == (3, g, None)
    # the drawn masks stacked [draws, B], drawn as the eager pass draws them
    (inputs,) = graphs.inputs
    assert out == {"graphs": inputs} and inputs[0] is x
    want = torch.Generator().manual_seed(0)
    torch.testing.assert_close(inputs[1], torch.stack(
        [torch.rand(3, generator=want) < 0.7 for _ in range(2)]), rtol=0, atol=0)
    # the captured pass puts the rate-0 draws back as None
    model.calls.clear()
    assert graphs.fn(x, inputs[1]) == {"pass": x}
    ((_, masks),) = model.calls
    assert masks[:2] == [None, None]
    assert all(torch.equal(a, b) for a, b in zip(masks[2:], inputs[1]))


def test_graphs_take_no_stack_when_nothing_is_drawn(recorder):
    model = _Split(rates=(0.0, 0.0))
    forward = train_graphs.train_forward(model)
    x = _card_input()
    forward(x, generator=torch.Generator())
    assert recorder[0].inputs == [(x,)]
    model.calls.clear()
    assert recorder[0].fn(x) == {"pass": x}
    assert model.calls == [("pass", [None, None])]
