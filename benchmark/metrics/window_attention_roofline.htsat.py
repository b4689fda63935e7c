"""Share of its roofline that HTS-AT's window-attention core reaches: its
least bytes over the window's steps (``counts.htsat``: ``q``, ``k``, ``v``
and ``o`` forward, eight such tensors backward, at the compute type's size
and the HBM rate) over the device time of the operations launched inside
the port's spans ``sedx.ops.window_attention`` and
``sedx.ops.window_attention.backward``. Nothing to read without those
spans (a trace without the port's spans, or a port without the core)."""

from ..counts import htsat

SPANS = ("sedx.ops.window_attention", "sedx.ops.window_attention.backward")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(ctx):
    if (ctx.work["kind"] != "train" or not ctx.work["steps"]
            or not hasattr(ctx.trace, "device_s_by_span")):
        return None
    device_s = sum(ctx.trace.device_s_by_span(SPANS).values())
    if not device_s:
        return None
    conf = ctx.conf
    nbytes = htsat.attention_bytes(conf["model"], conf["train"]["batch"],
                                   ITEMSIZE[conf["train"]["compute_dtype"]])
    return 100.0 * ctx.work["steps"] * htsat.bound_s(nbytes) / device_s
