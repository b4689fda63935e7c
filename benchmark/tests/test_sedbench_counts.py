"""The frozen work counts against the port's and against a counter of the
reference's operations.

    python -m pytest benchmark/tests -q --noconftest
"""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.counts import logmel as count_logmel  # noqa: E402
from benchmark.counts import model as count_model  # noqa: E402
from benchmark.harness import common  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402

CONFIGS = ("crnn", "glu")


def conf(name):
    return common.load_json(common.BENCH_DIR, "configs", name + ".json")


@pytest.mark.parametrize("batch,itemsize,rows_read", [
    (16, 4, None), (1, 4, None), (128, 2, 128), (128, 2, 97), (7, 2, 7)])
def test_frozen_flops_and_bytes_equal_the_ports(batch, itemsize, rows_read):
    from sound_event_detection_dcase2017_task4_torch.config import DEFAULT
    from sound_event_detection_dcase2017_task4_torch.ops.logmel_cuda import flops_and_bytes

    fe = conf("crnn")["frontend"]
    assert (count_logmel.flops_and_bytes(fe, batch, fe["clip_samples"], itemsize, rows_read)
            == flops_and_bytes(DEFAULT, batch, DEFAULT.clip_samples, itemsize, rows_read))


def _small(name, samples=16000):
    c = conf(name)
    c["frontend"]["clip_samples"] = samples
    return c


def _weights(arch, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: 0.1 * torch.randn(s, generator=g) + (1.0 if k.endswith("running_var") else 0.0)
            for k, s in ref_model.shapes(arch).items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_count_equals_the_counter(name):
    """The counter sees every convolution and product of the reference's
    forward; the analytic count is the same number."""
    c = _small(name)
    arch, fe = c["model"], c["frontend"]
    frames = count_model.frames(fe, fe["clip_samples"])
    x = torch.randn(2, frames, fe["mel_bins"])
    with FlopCounterMode(display=False) as fc:
        ref_model.forward(_weights(arch), x, arch)
    assert fc.get_total_flops() == 2 * count_model.model_forward_flops(arch, frames, fe["mel_bins"])


@pytest.mark.parametrize("name", CONFIGS)
def test_step_count_within_half_a_percent_of_the_counter(name):
    """Forward and backward counted by the counter against three forwards.
    The counter sees no gradient that the step never needs: the log-mel
    input's (the first convolution's input gradient) and the GRU's zero
    initial state's. So it reads a little lower, by under 0.5%."""
    c = _small(name)
    arch, fe = c["model"], c["frontend"]
    frames = count_model.frames(fe, fe["clip_samples"])
    w = {k: v.requires_grad_(not ref_model.is_statistic(k)) for k, v in _weights(arch).items()}
    x = torch.randn(2, frames, fe["mel_bins"])
    with FlopCounterMode(display=False) as fc:
        out = ref_model.forward(w, x, arch, train=True, generator=torch.Generator().manual_seed(1))
        out["clipwise_output"].sum().backward()
    analytic = 3 * 2 * count_model.model_forward_flops(arch, frames, fe["mel_bins"])
    counted = fc.get_total_flops()
    assert counted <= analytic
    assert (analytic - counted) / analytic < 5e-3


def test_flagship_step_count_near_the_ports_mfu_tool():
    """At batch 128 the count is 10.0555 TFLOP; the port's ``tools/mfu.py``
    counted 10.0459 with the counter over the port's ops (0.1% lower, for
    the reasons above)."""
    c = conf("crnn")
    flops = count_model.train_step_flops(c["model"], c["frontend"], 128,
                                         c["frontend"]["clip_samples"])
    assert flops == 10_055_467_068_672
    assert abs(flops - 10.0459e12) / flops < 2e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_count_is_the_configs(name):
    c = conf(name)
    n = sum(torch.Size(s).numel() for k, s in ref_model.shapes(c["model"]).items()
            if not ref_model.is_statistic(k))
    assert n == c["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_names_are_the_ports_state_dict(name):
    from sound_event_detection_dcase2017_task4_torch.models import get_model

    c = conf(name)
    sd = get_model(c["model_type"]).state_dict()
    shapes = ref_model.shapes(c["model"])
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(s) for k, s in shapes.items()}
