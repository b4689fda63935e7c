"""Share of its roofline that the bank entry of the log-mel kernel reaches:
the least time of the log-mel function over each step's gathered rows
(``counts.logmel``, int16 samples, distinct rows read once) over the
device time of the kernels named ``logmel_kernel<short>``."""

from ..counts import logmel

PATTERN = "logmel_kernel<short>"


def read(ctx):
    if ctx.work["kind"] != "train":
        return None
    launches = ctx.trace.named(PATTERN)
    per_chip = ctx.work["rows"]
    if not launches or len(launches) != len(per_chip):
        return None
    fe = ctx.conf["frontend"]
    bound = sum(logmel.bound_s(*logmel.flops_and_bytes(
        fe, ctx.conf["train"]["batch"], fe["clip_samples"], 2, rows)) for rows in per_chip)
    return 100.0 * bound / sum(e - s for _, s, e in launches)
