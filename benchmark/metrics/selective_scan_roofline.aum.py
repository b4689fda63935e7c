"""Share of its roofline that Audio Mamba's selective scan reaches: its
least bytes over the window's steps (``counts.aum.scan_bytes``: the
function's inputs and outputs of both directions, forward and backward,
at the compute type's size and the HBM rate) over the device time of the
operations launched inside the port's spans ``sedx.ops.selective_scan``
and ``sedx.ops.selective_scan.backward``. Nothing to read without those
spans (a trace without the port's spans, or a port without the scan)."""

from ..counts import aum

SPANS = ("sedx.ops.selective_scan", "sedx.ops.selective_scan.backward")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(ctx):
    if (ctx.work["kind"] != "train" or not ctx.work["steps"]
            or ctx.conf.get("model_type") != "AudioMamba"
            or not hasattr(ctx.trace, "device_s_by_span")):
        return None
    device_s = sum(ctx.trace.device_s_by_span(SPANS).values())
    if not device_s:
        return None
    conf = ctx.conf
    nbytes = aum.scan_bytes(conf["model"], conf["train"]["batch"],
                            ITEMSIZE[conf["train"]["compute_dtype"]])
    return 100.0 * ctx.work["steps"] * aum.bound_s(nbytes) / device_s
