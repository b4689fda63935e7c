"""Share of its roofline that the port's train-mode BatchNorm reaches: the
least time of the function over the window's steps (``counts.bn``: its
least bytes at the HBM rate, at the cell's batch a chip) over the device
time of the kernels whose name holds ``sedx_bn_``. Nothing to read where
no such kernel ran."""

from ..counts import bn

PATTERN = "sedx_bn_"


def read(ctx):
    if ctx.work["kind"] != "train" or not ctx.work["steps"]:
        return None
    launches = ctx.trace.named(PATTERN)
    if not launches:
        return None
    conf, fe = ctx.conf, ctx.conf["frontend"]
    nbytes = bn.step_bytes(conf["model"], fe, conf["train"]["batch"],
                           fe["clip_samples"],
                           bn.ITEMSIZE[conf["train"]["compute_dtype"]])
    bound = ctx.work["steps"] * bn.bound_s(nbytes)
    return 100.0 * bound / sum(e - s for _, s, e in launches)
