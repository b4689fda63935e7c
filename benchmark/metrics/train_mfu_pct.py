"""The training step's share of the card's bf16 peak: the analytic FLOPs
of a step (``counts.model``) times the steps of the traced window, over
the window's seconds times the chips times 989 TFLOP/s."""

from ..counts import model
from ..counts.peaks import PEAKS


def read(ctx):
    if ctx.work["kind"] != "train" or not ctx.work["steps"]:
        return None
    conf, fe = ctx.conf, ctx.conf["frontend"]
    flops = model.train_step_flops(conf["model"], fe, conf["train"]["batch"],
                                   fe["clip_samples"]) * ctx.chips
    return (100.0 * ctx.work["steps"] * flops
            / (ctx.trace.window_s * ctx.chips * PEAKS["bf16_flops_per_s"]))
