"""Train-mode BatchNorm with its activation on hand-written kernels
(``csrc/bn_act.cu``), and their plain PyTorch versions.

``models.blocks.BatchNorm`` in train mode on a CUDA tensor takes its batch
statistics from :func:`batch_sums` and applies ``act(x·a + b)`` with
:func:`batch_apply`; the ``[C]`` math between them (the mesh's sum, mean,
variance, ``a``, ``b``, the running statistics) stays in ``BatchNorm``.
``act`` is the block's epilogue: ``"relu"`` (``ConvBlock``'s first conv),
``"relu_pool"`` (its second: only the 2×2 floor average pool of the ReLU is
written) or ``"none"`` (``GLUBlock``'s ``lin`` and ``gate``).

Four passes over each conv output ``x [B, C, T, F]`` (contiguous NCHW or
channels-last, bf16 or float32; f32 arithmetic, each output rounded once):

* forward: K1 ``x → [Σx, Σx²]`` (f32 ``[2C]``), K2 ``x → act(x·a + b)``;
* backward: K3 ``dy, x → [Σg, Σg·x]``, ``g`` the gradient at ``x·a + b``
  (ReLU's mask recomputed from ``x``; ``dy/4`` over each pooled window),
  then K4 ``dy, x → dx = g·a + c₁ + c₂·x`` with ``c₁, c₂`` from the
  gradient of the ``[2C]`` sums.

Two ``torch.autograd.Function``\\ s carry it. The apply's backward (K3)
returns the gradients of ``a`` and ``b`` and none for ``x``; autograd then
takes them back through ``BatchNorm``'s ``[C]`` math and, under a mesh,
through ``parallel.all_reduce_sum``'s one collective, to the sums, whose
backward (K4) writes the whole ``dx``. The two share a :class:`Link`, by
which the apply's backward hands ``dy`` and the saved tensors to the sums'.
Only ``x`` and ``[C]`` vectors are saved: no f32 copy, no pre-pool
activation.

Each layout has kernels of its own, chosen by what ``x``'s strides show
(:func:`channels_last`): the NCHW kernels for an ``x`` contiguous as NCHW
(HTS-AT's ``bn0``), the channels-last ones for an ``x`` contiguous only as
channels-last (the conv stack's). Anything else raises. ``y`` and ``dx``
take ``x``'s layout, and ``dy`` is made contiguous in it.

A CPU tensor goes to the plain versions (same math, written with PyTorch
ops, in float32 or the input's wider type, in any layout, with outputs in
``x``'s); the tests hold them to the stock composite and to
``gradcheck``, and ``chip_smoke.py`` and the card
tests hold the kernels to them: :func:`sums_grad` gives K4 the gradient a
step would, and :func:`grad_x_mismatch` holds ``dx`` to its plain version
region by region, the elements where ``g`` is 0 apart. A CUDA tensor goes
to the kernels, which raise on anything they do not take; nothing falls
back. The library makes the cut of each tensor itself; the wrapper checks
the tensors, tests the pointers' alignment and sizes the scratch of the
partials by asking the library.

Each kernel launch adds to the counter ``ops.bn_act.launches``; the forward
launches run inside the span ``sedx.ops.bn_act``. The library is built with
``nvcc`` at first use (:data:`LIBRARY`, an ``nvcc.Library``); importing this
module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import trace
from . import nvcc

__all__ = ["ACTS", "LIBRARY", "Link", "apply_cuda", "apply_plain", "batch_apply",
           "batch_sums", "channels_last", "grad_stats_cuda", "grad_stats_plain",
           "grad_x_cuda", "grad_x_mismatch", "grad_x_plain", "least_bytes",
           "stats_cuda", "stats_plain", "sums_grad"]

SOURCE = Path(__file__).parent / "csrc" / "bn_act.cu"
ACTS = ("none", "relu", "relu_pool")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the library's code for a tensor too large for its int unit index
_ERR_UNITS = -2

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SHAPE = [_ci] * 4          # B, C, T, F
#: ``csrc/bn_act.cu``, built at first use (:class:`nvcc.Library`).
LIBRARY = nvcc.Library(SOURCE, "bn_act", {
    "sedx_bn_partials": (_ci, [*_SHAPE, _ci, _ci, _ci, _ci]),
    "sedx_bn_stats": (_ci, [_vp, _ci, _ci, _ci, *_SHAPE, _vp, _vp, _vp]),
    "sedx_bn_apply": (_ci, [_vp, _ci, _ci, _ci, _ci, _vp, _vp, *_SHAPE, _vp,
                            _vp]),
    "sedx_bn_grad_stats": (_ci, [_vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp,
                                 *_SHAPE, _vp, _vp, _vp]),
    "sedx_bn_grad_x": (_ci, [_vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp,
                             *_SHAPE, _vp, _vp])},
    "sedx_bn_error_string")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _bc(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _z(x, a, b):
    acc = _acc(x.dtype)
    return x.to(acc) * _bc(a.to(acc)) + _bc(b.to(acc))


def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """``[Σx, Σx²]`` per channel of ``x [B, C, T, F]``: ``[2C]``."""
    xf = x.to(_acc(x.dtype))
    return torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])


def apply_plain(x, a, b, act: str) -> torch.Tensor:
    """``act(x·a + b)`` in x's dtype (``relu_pool``: the 2×2 floor average
    pool of the ReLU)."""
    y = _z(x, a, b)
    if act != "none":
        y = torch.relu(y)
    if act == "relu_pool":
        y = F.avg_pool2d(y, 2)
    return y.to(x.dtype)


def _grad_z(dy, x, a, b, act):
    """The gradient at ``z = x·a + b``, full size and in ``x``'s layout:
    ``dy`` (``none``), ReLU's mask on it (``relu``), ``dy/4`` over each
    pooled window and 0 on what the pool drops, under the mask
    (``relu_pool``)."""
    z = _z(x, a, b)
    if act == "relu_pool":
        to, fo = dy.shape[2:]
        g = torch.zeros_like(z)
        g[:, :, :2 * to, :2 * fo] = 0.25 * dy.to(z.dtype).repeat_interleave(
            2, 2).repeat_interleave(2, 3)
    else:
        g = torch.empty_like(z).copy_(dy)
    if act != "none":
        g = torch.where(z > 0, g, torch.zeros_like(g))
    return g


def grad_stats_plain(dy, x, a, b, act: str) -> torch.Tensor:
    """``[Σg, Σg·x]`` per channel: the gradients of ``b`` and ``a``."""
    g = _grad_z(dy, x, a, b, act)
    return torch.cat([g.sum((0, 2, 3)), (g * x.to(g.dtype)).sum((0, 2, 3))])


def grad_x_plain(dy, x, a, b, gs, act: str) -> torch.Tensor:
    """``dx = g·a + c₁ + c₂·x`` with ``c₁ = gs[:C]``, ``c₂ = 2·gs[C:]``
    (``gs`` the gradient of ``[Σx, Σx²]``), in x's dtype."""
    g = _grad_z(dy, x, a, b, act)
    c = x.shape[1]
    acc = g.dtype
    dx = (g * _bc(a.to(acc)) + _bc(gs[:c].to(acc))
          + _bc(2 * gs[c:].to(acc)) * x.to(acc))
    return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels' yardstick
# ---------------------------------------------------------------------------

def sums_grad(x, dy, weight, bias, act: str, epsilon: float = 1e-5,
              rows: int = 16):
    """``(a, b, gs)``: the ``a`` and ``b`` that train-mode ``BatchNorm``
    gives ``x`` (one process), and ``gs``, the gradient of its ``[Σx, Σx²]``
    under ``dy`` through ``BatchNorm``'s ``[C]`` math (by autograd, in
    float64; float32 out): the ``c₁`` and ``c₂`` a step hands K4. Reads
    ``rows`` batch rows at a time."""
    chunks = range(0, x.shape[0], rows)
    s = sum(stats_plain(x[i:i + rows].double()) for i in chunks)
    s.requires_grad_(True)
    mean, ex2 = (s / (x.numel() // x.shape[1])).chunk(2)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    a = weight.double() * torch.rsqrt(var + epsilon)
    b = bias.double() - mean * a
    ad, bd = a.detach(), b.detach()
    gsum, gxsum = sum(grad_stats_plain(dy[i:i + rows].double(),
                                       x[i:i + rows].double(), ad, bd, act)
                      for i in chunks).chunk(2)
    gs, = torch.autograd.grad((a * gxsum + b * gsum).sum(), s)
    return ad.float(), bd.float(), gs.float()


def grad_x_mismatch(dx, dy, x, a, b, gs, act: str, rtol: float,
                    rows: int = 16) -> dict[str, tuple[float, int]]:
    """``dx`` against :func:`grad_x_plain` in float64, region by region:
    ``"g"`` where the gradient ``g`` at ``x·a + b`` may be non-zero,
    ``"masked"`` where ReLU's mask makes it 0, ``"dropped"`` on the rows
    and columns a floor pool drops. Each region gives its element count and
    its largest ``|dx − ref| / (rtol·|ref| + 2⁻²⁰·(|g·a| + |c₁| + |c₂·x|))``:
    at most 1 passes (``rtol`` for the one rounding to x's dtype, the second
    term for float32 arithmetic). Elements within 1e-4 of ReLU's kink are
    left out. So a ``dx`` that lost ``c₁`` or ``c₂·x``, or wrote 0 where
    ``g`` is 0, fails in ``"masked"`` and ``"dropped"`` whatever the
    gradient's scale. Reads ``rows`` batch rows at a time."""
    c, t, f = x.shape[1:]
    a64, b64, gs64 = a.double(), b.double(), gs.double()
    c1, c2 = _bc(gs64[:c]).abs(), _bc(2 * gs64[c:])
    worst = {k: [0.0, 0] for k in ("g", "masked", "dropped")}
    for i in range(0, x.shape[0], rows):
        x64, dy64 = x[i:i + rows].double(), dy[i:i + rows].double()
        ref = grad_x_plain(dy64, x64, a64, b64, gs64, act)
        mag = ((_grad_z(dy64, x64, a64, b64, act) * _bc(a64)).abs() + c1
               + (c2 * x64).abs())
        err = ((dx[i:i + rows].double() - ref).abs()
               / (rtol * ref.abs() + 2 ** -20 * mag).clamp(min=1e-300))
        z = _z(x64, a64, b64)
        kept = torch.ones_like(z, dtype=torch.bool)
        if act == "relu_pool":
            kept[:, :, 2 * (t // 2):] = False
            kept[:, :, :, 2 * (f // 2):] = False
        on, off = ((kept, torch.zeros_like(kept)) if act == "none"
                   else (kept & (z > 1e-4), kept & (z < -1e-4)))
        for k, m in (("g", on), ("masked", off), ("dropped", ~kept)):
            n = int(m.sum())
            if n:
                worst[k][0] = max(worst[k][0], float(err[m].max()))
                worst[k][1] += n
    return {k: (v[0], v[1]) for k, v in worst.items()}


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def least_bytes(shape, itemsize: int, act: str) -> tuple[int, int]:
    """The least bytes the function moves, forward and backward, whatever
    implements it: read ``x`` and write ``y``; read ``x`` and ``dy`` and
    write ``dx`` (``y`` and ``dy`` pooled for ``relu_pool``)."""
    bsz, c, t, f = shape
    n = bsz * c * t * f
    out = bsz * c * (t // 2) * (f // 2) if act == "relu_pool" else n
    return itemsize * (n + out), itemsize * (2 * n + out)


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the channels-last kernels: contiguous as
    channels-last and not as NCHW. A tensor contiguous in both (one channel,
    or a 1×1 plane) has the same memory order in both and takes the NCHW
    ones."""
    return (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _format(nhwc: bool) -> torch.memory_format:
    return torch.channels_last if nhwc else torch.contiguous_format


def _check_x(x: torch.Tensor, act: str) -> bool:
    """Raises on an ``x`` (and ``act``) the kernels do not take; returns
    :func:`channels_last` of it."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS} (got {act!r})")
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the bn_act kernels take a CUDA x")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the bn_act kernels take float32 or bfloat16 "
                        f"(got {x.dtype})")
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty x [B, C, T, F] (got "
                         f"{tuple(x.shape)})")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("the bn_act kernels take a contiguous NCHW or "
                         "channels-last x")
    if act == "relu_pool" and min(x.shape[2:]) < 2:
        raise ValueError(f"relu_pool of a {tuple(x.shape[2:])} plane is empty")
    return channels_last(x)


def _check_same(t: torch.Tensor, x: torch.Tensor, shape, what: str,
                nhwc: bool) -> None:
    fmt = _format(nhwc)
    if (not isinstance(t, torch.Tensor) or t.device != x.device
            or t.dtype != x.dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous(memory_format=fmt)):
        raise ValueError(f"{what} must be a {x.dtype} {tuple(shape)} on "
                         f"{x.device}, contiguous in x's layout ({fmt})")


def _check_vec(v: torch.Tensor, n: int, x: torch.Tensor, what: str) -> None:
    if (not isinstance(v, torch.Tensor) or v.device != x.device
            or v.dtype != torch.float32 or tuple(v.shape) != (n,)
            or not v.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 [{n}] on "
                         f"{x.device}")


def _out_shape(x, act):
    bsz, c, t, f = x.shape
    return (bsz, c, t // 2, f // 2) if act == "relu_pool" else (bsz, c, t, f)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check(rc: int, x, n: int, entry: str) -> int:
    """``rc`` of ``entry``: raises on a negative code, and on any other
    non-zero one of an entry that launches ``n`` > 0 kernels, which it adds
    to ``ops.bn_act.launches``."""
    if rc == _ERR_UNITS:
        raise ValueError(f"{tuple(x.shape)} is too large for the bn_act "
                         "kernels' int unit index")
    if rc < 0 or n and rc:
        raise LIBRARY.error(rc, f"bn_act {entry}")
    if n:
        trace.count("ops.bn_act.launches", n)
    return rc


def _partials(lib, x, act, aligned, nhwc):
    """Scratch for the per-block partials of K1 (``act`` ``"none"``) or K3."""
    n = _check(lib.sedx_bn_partials(*x.shape, _DTYPES[x.dtype], ACTS.index(act),
                                    aligned, nhwc),
               x, 0, "sedx_bn_partials")
    return torch.empty((x.shape[1], n, 2), dtype=torch.float32,
                       device=x.device)


def stats_cuda(x: torch.Tensor) -> torch.Tensor:
    """K1 and the combine: ``[Σx, Σx²]`` float32 ``[2C]``."""
    nhwc = _check_x(x, "none")
    lib = LIBRARY.load()
    aligned = _aligned(x)
    with trace.span("sedx.ops.bn_act"), torch.cuda.device(x.device):
        part = _partials(lib, x, "none", aligned, nhwc)
        out = torch.empty(2 * x.shape[1], dtype=torch.float32, device=x.device)
        _check(lib.sedx_bn_stats(x.data_ptr(), _DTYPES[x.dtype], aligned, nhwc,
                                 *x.shape, part.data_ptr(), out.data_ptr(),
                                 nvcc.stream(x)),
               x, 2, "sedx_bn_stats")
    return out


def apply_cuda(x, a, b, act: str) -> torch.Tensor:
    """K2: ``act(x·a + b)`` in x's dtype and layout."""
    nhwc = _check_x(x, act)
    _check_vec(a, x.shape[1], x, "a")
    _check_vec(b, x.shape[1], x, "b")
    lib = LIBRARY.load()
    with trace.span("sedx.ops.bn_act"), torch.cuda.device(x.device):
        y = torch.empty(_out_shape(x, act), dtype=x.dtype, device=x.device,
                        memory_format=_format(nhwc))
        _check(lib.sedx_bn_apply(x.data_ptr(), _DTYPES[x.dtype], ACTS.index(act),
                                 _aligned(x, y), nhwc, a.data_ptr(), b.data_ptr(),
                                 *x.shape, y.data_ptr(), nvcc.stream(x)),
               x, 1, "sedx_bn_apply")
    return y


def grad_stats_cuda(dy, x, a, b, act: str) -> torch.Tensor:
    """K3 and the combine: ``[Σg, Σg·x]`` float32 ``[2C]``."""
    nhwc = _check_x(x, act)
    _check_same(dy, x, _out_shape(x, act), "dy", nhwc)
    _check_vec(a, x.shape[1], x, "a")
    _check_vec(b, x.shape[1], x, "b")
    lib = LIBRARY.load()
    aligned = _aligned(x, dy)
    with torch.cuda.device(x.device):
        part = _partials(lib, x, act, aligned, nhwc)
        out = torch.empty(2 * x.shape[1], dtype=torch.float32, device=x.device)
        _check(lib.sedx_bn_grad_stats(dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype],
                                      ACTS.index(act), aligned, nhwc,
                                      a.data_ptr(), b.data_ptr(), *x.shape,
                                      part.data_ptr(), out.data_ptr(),
                                      nvcc.stream(x)),
               x, 2, "sedx_bn_grad_stats")
    return out


def grad_x_cuda(dy, x, a, b, gs, act: str) -> torch.Tensor:
    """K4 (and, for ``relu_pool`` on an odd plane, the dropped rows and
    columns): ``dx = g·a + c₁ + c₂·x`` in x's dtype and layout."""
    nhwc = _check_x(x, act)
    _check_same(dy, x, _out_shape(x, act), "dy", nhwc)
    _check_vec(a, x.shape[1], x, "a")
    _check_vec(b, x.shape[1], x, "b")
    _check_vec(gs, 2 * x.shape[1], x, "gs")
    lib = LIBRARY.load()
    t, f = x.shape[2:]
    tail = act == "relu_pool" and (t % 2 or f % 2)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x, memory_format=_format(nhwc))
        _check(lib.sedx_bn_grad_x(dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype],
                                  ACTS.index(act), _aligned(x, dy, dx), nhwc,
                                  a.data_ptr(), b.data_ptr(), gs.data_ptr(),
                                  *x.shape, dx.data_ptr(), nvcc.stream(x)),
               x, 2 if tail else 1, "sedx_bn_grad_x")
    return dx


# ---------------------------------------------------------------------------
# the autograd functions
# ---------------------------------------------------------------------------

def _stats(x):
    return stats_cuda(x) if x.is_cuda else stats_plain(x)


def _apply(x, a, b, act):
    return apply_cuda(x, a, b, act) if x.is_cuda else apply_plain(x, a, b, act)


def _grad_stats(dy, x, a, b, act):
    return (grad_stats_cuda(dy, x, a, b, act) if x.is_cuda
            else grad_stats_plain(dy, x, a, b, act))


def _grad_x(dy, x, a, b, gs, act):
    return (grad_x_cuda(dy, x, a, b, gs, act) if x.is_cuda
            else grad_x_plain(dy, x, a, b, gs, act))


class Link:
    """One fused BatchNorm call's epilogue, and what its apply's backward
    hands to its sums' backward: ``(dy, x, a, b)``."""

    __slots__ = ("act", "saved")

    def __init__(self, act: str):
        if act not in ACTS:
            raise ValueError(f"act must be one of {ACTS} (got {act!r})")
        self.act = act
        self.saved = None


class _Sums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, link):
        ctx.link = link
        return _stats(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, gs):
        saved, ctx.link.saved = ctx.link.saved, None
        if saved is None:
            raise RuntimeError("bn_act: the sums' gradient arrived before "
                               "the apply's backward ran")
        dy, x, a, b = saved
        return _grad_x(dy, x, a, b, gs.contiguous(), ctx.link.act), None


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, link):
        ctx.save_for_backward(x, a, b)
        ctx.link = link
        return _apply(x, a, b, link.act)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, a, b = ctx.saved_tensors
        dy = dy.contiguous(memory_format=_format(channels_last(x)))
        gsum, gxsum = _grad_stats(dy, x, a, b, ctx.link.act).chunk(2)
        if ctx.needs_input_grad[0]:
            ctx.link.saved = (dy, x, a, b)
        return None, gxsum, gsum, None


def batch_sums(x: torch.Tensor, link: Link) -> torch.Tensor:
    """``[Σx, Σx²]`` per channel of ``x [B, C, T, F]`` (K1; float32 for a
    bf16 or float32 ``x``), with a gradient: ``x``'s whole gradient, written
    by K4 once ``link``'s apply has run its backward."""
    return _Sums.apply(x, link)


def batch_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                link: Link) -> torch.Tensor:
    """``link.act(x·a + b)`` (K2) with the gradients of ``a`` and ``b``
    (K3); ``x``'s gradient goes through :func:`batch_sums`."""
    return _Apply.apply(x, a, b, link)
