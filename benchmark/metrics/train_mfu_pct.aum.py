"""Audio Mamba's training step's share of the card's bf16 peak while the
card works: the analytic FLOPs of a step (``counts.aum``) times the steps
of the traced window, over the window's device-busy seconds (the union of
its device operations) times 989 TFLOP/s. The busy seconds, not the
window's: the traced window's pass is eager (a CUDA graph records no
span), and the profiler's host cost a launch sets part of its pace."""

from ..counts import aum
from ..counts.peaks import PEAKS


def read(ctx):
    conf = ctx.conf
    if (ctx.work["kind"] != "train" or not ctx.work["steps"]
            or conf.get("model_type") != "AudioMamba" or not ctx.trace.device):
        return None
    fe = conf["frontend"]
    flops = aum.train_step_flops(conf["model"], fe, conf["train"]["batch"],
                                 fe["clip_samples"])
    return (100.0 * ctx.work["steps"] * flops
            / (ctx.trace.busy_s() * PEAKS["bf16_flops_per_s"]))
