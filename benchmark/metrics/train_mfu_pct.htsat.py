"""HTS-AT's training step's share of the card's bf16 peak while the card
works: the analytic FLOPs of a step (``counts.htsat``) times the steps of
the traced window, over the window's device-busy seconds (the union of its
device operations) times 989 TFLOP/s. The busy seconds, not the window's:
the profiler's host cost a launch, ~1,600 kernels a step, sets the pace of
a traced window of this cell, and the idle time it makes is not the
program's."""

from ..counts import htsat
from ..counts.peaks import PEAKS


def read(ctx):
    conf = ctx.conf
    if (ctx.work["kind"] != "train" or not ctx.work["steps"]
            or conf.get("model_type") != "HTSAT" or not ctx.trace.device):
        return None
    fe = conf["frontend"]
    flops = htsat.train_step_flops(conf["model"], fe, conf["train"]["batch"],
                                   fe["clip_samples"])
    return (100.0 * ctx.work["steps"] * flops
            / (ctx.trace.busy_s() * PEAKS["bf16_flops_per_s"]))
