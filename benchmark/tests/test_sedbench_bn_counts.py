"""The least bytes of train-mode BatchNorm (``counts.bn``) and the reader
of ``bn_act_roofline``.

    python -m pytest benchmark/tests -q --noconftest
"""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.counts import bn as count_bn  # noqa: E402
from benchmark.harness import common  # noqa: E402
from benchmark.metrics import bn_act_roofline  # noqa: E402


def conf(name):
    return common.load_json(common.BENCH_DIR, "configs", name + ".json")


def test_crnn_layers_and_elements():
    """Eight BatchNorms; 2 × (524.8 M + 262.1 M + 131.1 M + 65.5 M) conv
    output elements at batch 128."""
    c = conf("crnn")
    fe = c["frontend"]
    got = count_bn.layers(c["model"], fe, 128, fe["clip_samples"])
    assert [a for _, a in got] == ["relu", "relu_pool"] * 4
    assert [s for s, _ in got[::2]] == [(128, 64, 1001, 64), (128, 128, 500, 32),
                                        (128, 256, 250, 16), (128, 512, 125, 8)]
    n = sum(b * ch * t * f for (b, ch, t, f), _ in got)
    assert n == 1_967_128_576


def test_glu_has_four_identity_batchnorms_a_block():
    c = conf("glu")
    fe = c["frontend"]
    got = count_bn.layers(c["model"], fe, 128, fe["clip_samples"])
    assert len(got) == 16 and {a for _, a in got} == {"none"}


@pytest.mark.parametrize("name,want", [
    # relu: 5sN; relu_pool: 3sN + 2s·N_out, s = 2
    ("crnn", 2 * (5 * 983_564_288 + 3 * 983_564_288
                  + 2 * (131_072_000 + 65_536_000 + 32_768_000 + 16_252_928))),
    ("glu", 2 * 5 * 2 * 1_967_128_576),
])
def test_step_bytes(name, want):
    c = conf(name)
    fe = c["frontend"]
    assert count_bn.step_bytes(c["model"], fe, 128, fe["clip_samples"], 2) == want


@pytest.mark.parametrize("name", ["crnn", "glu"])
def test_step_bytes_equal_the_ports_least_bytes(name):
    from sound_event_detection_dcase2017_task4_torch.ops import bn_act

    c = conf(name)
    fe = c["frontend"]
    want = sum(sum(bn_act.least_bytes(s, 2, a))
               for s, a in count_bn.layers(c["model"], fe, 128, fe["clip_samples"]))
    assert count_bn.step_bytes(c["model"], fe, 128, fe["clip_samples"], 2) == want


def _ctx(name, device, steps=3):
    trace = types.SimpleNamespace(device=device, named=lambda p: [d for d in device if p in d[0]])
    return types.SimpleNamespace(trace=trace, conf=conf(name), chips=1,
                                 work={"kind": "train", "steps": steps})


def test_reader_finds_nothing_without_the_kernels():
    assert bn_act_roofline.read(_ctx("crnn", [("elementwise_kernel", 0.0, 0.1)])) is None
    assert bn_act_roofline.read(_ctx("crnn", [("void sedx_bn_stats_kernel<>", 0.0, 0.1)],
                                     steps=0)) is None


def test_reader_is_the_bound_over_the_kernels_time():
    c = conf("crnn")
    fe = c["frontend"]
    bound = count_bn.bound_s(count_bn.step_bytes(c["model"], fe, 128, fe["clip_samples"], 2))
    dev = [("void sedx_bn_apply_kernel<__nv_bfloat16, 1, 8, true>", 0.0, bound),
           ("elementwise_kernel", bound, 5 * bound),
           ("void sedx_bn_grad_x_kernel<__nv_bfloat16, 2, 8, true>", 5 * bound, 8 * bound)]
    assert bn_act_roofline.read(_ctx("crnn", dev, steps=2)) == pytest.approx(50.0)
