"""Rank 0's device time in NCCL kernels (BatchNorm's sums, the mixup swap
and the gradient all-reduce) a step, in milliseconds."""

PATTERN = "nccl"


def read(ctx):
    kernels = [d for d in ctx.trace.device if PATTERN in d[0].lower()]
    if ctx.work["kind"] != "train" or ctx.chips < 2 or not kernels or not ctx.work["steps"]:
        return None
    return 1e3 * sum(e - s for _, s, e in kernels) / ctx.work["steps"]
