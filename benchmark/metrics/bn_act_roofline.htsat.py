"""Share of its roofline that the port's train-mode BatchNorm reaches in
HTS-AT's step: ``bn_act_roofline`` with ``bn0``'s least bytes
(``counts.htsat.bn0_bytes``) in place of the conv stack's. Nothing to
read where no ``sedx_bn_`` kernel ran."""

from ..counts import htsat
from .bn_act_roofline import PATTERN

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(ctx):
    conf = ctx.conf
    if (ctx.work["kind"] != "train" or not ctx.work["steps"]
            or conf.get("model_type") != "HTSAT"):
        return None
    launches = ctx.trace.named(PATTERN)
    if not launches:
        return None
    fe = conf["frontend"]
    nbytes = htsat.bn0_bytes(conf["model"], fe, conf["train"]["batch"],
                             fe["clip_samples"], ITEMSIZE[conf["train"]["compute_dtype"]])
    return 100.0 * ctx.work["steps"] * htsat.bound_s(nbytes) / sum(e - s for _, s, e in launches)
