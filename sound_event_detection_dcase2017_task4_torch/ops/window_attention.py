"""The core of HTS-AT's shifted-window attention (``models.htsat``) as one
autograd function: hand-written kernels on a CUDA tensor
(``csrc/window_attention.cu``), its plain version in stock PyTorch ops on
the CPU.

    o = window_attention(q, k, v, bias_table, rel_index, mask, scale)

``q, k, v [W, H, N, d]`` are the heads of ``W`` windows of ``N`` tokens,
batch-major (``W = B·nW``), in the compute type; ``bias_table [(2w−1)², H]``
is the learned relative-position bias (float32), ``rel_index [N·N]`` the
table row of each token pair, ``mask [nW, N, N]`` the shifted windows'
cross-region mask (float32) or ``None``. Returns ``o [W, N, H·d]`` (the
heads merged) in the compute type.

Forward: ``S = scale·q kᵀ`` accumulated and kept in float32, plus
``bias_table[rel_index]`` as ``[H, N, N]`` and the window's mask;
``P = softmax(S)`` in float32; ``o = P v`` with ``P`` cast to the compute
type. Backward: ``dP = dO vᵀ`` (float32), ``dS = P∘(dP − Σ_j dP∘P)``,
``dq = scale·dS k``, ``dk = scale·dSᵀ q``, ``dv = Pᵀ dO`` (``dS·scale`` and
``P`` cast to the compute type), and ``dS`` summed over the windows and
scattered into the table's gradient. A float64 call computes in float64
throughout.

A CUDA call goes to the kernels, which keep a window-head's scores, bias,
mask and softmax on chip in both directions and write no ``N×N`` tensor:
the forward reads ``q``, ``k``, ``v`` where they lie (the strided views
``WindowAttention.forward`` makes of the ``qkv`` linear's output) and
writes ``o``; it saves only ``q``, ``k`` and ``v``, and the backward
recomputes ``P``. The table's gradient is summed without atomics, in an
order fixed by the shapes, so two calls give the same bits. Their softmax
is not the plain version's bit for bit: ``exp`` runs on the special-function
unit (``__expf``, a few ulps) and each row is multiplied by one reciprocal
of its sum, where ``torch.softmax`` takes ``expf`` and divides, so ``P``
differs by about 1e-6 relative before its rounding to the compute type
(the float32 kernels stay within :func:`mismatch`'s 2⁻¹⁴ of each
element's magnitude against float64, in the card tests). They take
bf16 and float32 (float32 FMAs, no TF32), ``N ≤ 64``, ``d`` a multiple of 8
up to 64, and unit stride over ``d`` with 16-byte aligned pointers and
strides; anything else raises, and nothing falls back. A CPU call
(float64 included) takes the plain version (:func:`forward_plain`,
:func:`backward_plain`), which the card tests and ``chip_smoke.py`` also
run on the card to hold the kernels to it (:func:`mismatch`).

The forward runs inside the span ``sedx.ops.window_attention``, the
backward inside ``sedx.ops.window_attention.backward`` (on autograd's
thread). Counters: ``ops.window_attention.calls`` (forwards),
``ops.window_attention.windows`` (window-heads, ``W·H``, a forward),
``ops.window_attention.shifted_calls`` (forwards with a mask) and, on a
card only, ``ops.window_attention.launches`` (kernel launches: 1 a forward,
3 a backward). The library is built with ``nvcc`` at first use
(:data:`LIBRARY`, an ``nvcc.Library``), apart from ``bn_act``'s; importing
this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from .. import trace
from . import nvcc

__all__ = ["LIBRARY", "backward_cuda", "backward_plain", "forward_cuda",
           "forward_plain", "mismatch", "relative_index", "shift_mask",
           "window_attention"]

SOURCE = Path(__file__).parent / "csrc" / "window_attention.cu"
MAX_TOKENS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ST = [ctypes.POINTER(ctypes.c_longlong)] * 3      # strides (w, h, n)
_SHAPE = [_ci] * 5                                 # W, H, N, d, nW
#: ``csrc/window_attention.cu``, built at first use (:class:`nvcc.Library`).
LIBRARY = nvcc.Library(SOURCE, "window_attention", {
    "sedx_wa_partials": (_ci, [*_SHAPE, _ci]),
    "sedx_wa_forward": (_ci, [_vp, _vp, _vp, _ci, *_ST, _vp, _vp, _vp, *_SHAPE,
                              _cf, _vp, _vp]),
    "sedx_wa_backward": (_ci, [_vp, _vp, _vp, _vp, _ci, *_ST, _vp, _vp, _vp,
                               *_SHAPE, _ci, _cf, _vp, _vp, _vp, *_ST, _vp, _vp,
                               _vp])},
    "sedx_wa_error_string")


def relative_index(window: int) -> torch.Tensor:
    """``[w²·w²]`` int64: the bias-table row of each token pair ``(i, j)``
    of a ``w × w`` window, tokens row-major,
    ``(Δrow + w − 1)(2w − 1) + (Δcol + w − 1)`` with ``Δ = pos_i − pos_j``."""
    pos = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                     indexing="ij")).flatten(1)        # [2, N]
    rel = pos[:, :, None] - pos[:, None, :] + (window - 1)          # [2, N, N]
    return (rel[0] * (2 * window - 1) + rel[1]).flatten()


def shift_mask(resolution: int, window: int, shift: int) -> torch.Tensor:
    """``[nW, N, N]`` float32: −100 between two tokens of a window of the
    image rolled by ``(−shift, −shift)`` that came from different regions
    (the slices ``0:−w``, ``−w:−s`` and ``−s:`` of each axis), else 0;
    windows row-major."""
    img = torch.zeros(resolution, resolution)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, rows in enumerate(cuts):
        for j, cols in enumerate(cuts):
            img[rows, cols] = 3 * i + j
    n = resolution // window
    win = img.view(n, window, n, window).transpose(1, 2).reshape(n * n, -1)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _bmm_acc(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` (batched) accumulated and returned in ``acc``."""
    if a.dtype == acc:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=acc)
    return torch.bmm(a.to(acc), b.to(acc))


def forward_plain(q, k, v, bias_table, rel_index, mask, scale):
    """The forward in stock ops: ``(o, p)``, ``p [W·H, N, N]`` the softmax
    in float32 (or float64), which :func:`backward_plain` takes."""
    w, h, n, d = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    q, k, v = (t.reshape(w * h, n, d) for t in (q, k, v))
    # bias and mask as one [nW, H, N, N] addend, taken with the scale in one
    # pass over the scores
    add = bias_table[rel_index].to(acc).view(n, n, h).permute(2, 0, 1)[None]
    if mask is not None:
        add = add + mask.to(acc)[:, None]
    s = _bmm_acc(q, k.transpose(1, 2), acc)
    s5 = s.view(-1, add.shape[0], h, n, n)
    torch.add(add, s5, alpha=scale, out=s5)
    p = torch.softmax(s, dim=-1)
    o = torch.bmm(p.to(v.dtype), v).view(w, h, n, d).transpose(1, 2).reshape(w, n, h * d)
    return o, p


def backward_plain(q, k, v, p, rel_index, do, scale, table):
    """The backward in stock ops from :func:`forward_plain`'s ``p`` and
    ``dO [W, N, H·d]``: ``(dq, dk, dv, dtable)``; ``table`` is the bias
    table's ``(shape, dtype)``."""
    w, h, n, d = q.shape
    q, k, v = (t.reshape(w * h, n, d) for t in (q, k, v))
    do = do.reshape(w, n, h, d).transpose(1, 2).reshape(w * h, n, d)
    dv = torch.bmm(p.to(v.dtype).transpose(1, 2), do)
    dp = _bmm_acc(do, v.transpose(1, 2), p.dtype)
    # dS = P∘(dP − Σ_j dP∘P): softmax's own backward
    ds = torch._softmax_backward_data(dp, p, -1, p.dtype)
    shape, dtype = table
    dtable = torch.zeros(shape, dtype=dtype, device=q.device)
    dtable.index_add_(0, rel_index, ds.view(w, h, n * n).sum(0).t().to(dtype))
    ds = (ds * scale).to(q.dtype)
    dq = torch.bmm(ds, k)
    dk = torch.bmm(ds.transpose(1, 2), q)
    return (dq.view(w, h, n, d), dk.view(w, h, n, d), dv.view(w, h, n, d),
            dtable)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned pointer and strides (those of dimensions longer than
    1), unit stride over the last dimension."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def _check(q, k, v, bias_table, rel_index, mask) -> None:
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in (q, k, v)):
        raise ValueError("the window-attention kernels take CUDA q, k, v")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the window-attention kernels take float32 or "
                        f"bfloat16 (got {q.dtype})")
    if q.ndim != 4 or q.numel() == 0:
        raise ValueError(f"expected a non-empty q [W, H, N, d] (got "
                         f"{tuple(q.shape)})")
    w, h, n, d = q.shape
    for t in (k, v):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError("q, k and v must share dtype, shape and device")
    if n > MAX_TOKENS:
        raise ValueError(f"the kernels take windows of at most {MAX_TOKENS} "
                         f"tokens (got {n})")
    if d % 8 or not 8 <= d <= 64:
        raise ValueError(f"the kernels take a head width that is a multiple "
                         f"of 8 up to 64 (got {d})")
    if not all(_aligned(t) for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride over d and 16-byte "
                         "aligned pointers and strides")
    if (bias_table.device != q.device or bias_table.dtype != torch.float32
            or bias_table.ndim != 2 or bias_table.shape[1] != h
            or not bias_table.is_contiguous()):
        raise ValueError(f"bias_table must be a contiguous float32 [R, {h}] on "
                         f"{q.device}")
    if (rel_index.device != q.device or rel_index.dtype != torch.int64
            or tuple(rel_index.shape) != (n * n,) or not rel_index.is_contiguous()):
        raise ValueError(f"rel_index must be a contiguous int64 [{n * n}] on "
                         f"{q.device}")
    if mask is not None and (
            mask.device != q.device or mask.dtype != torch.float32
            or mask.ndim != 3 or tuple(mask.shape[1:]) != (n, n)
            or not mask.is_contiguous() or w % mask.shape[0]):
        raise ValueError(f"mask must be a contiguous float32 [nW, {n}, {n}] on "
                         f"{q.device} with nW dividing {w}")


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


@functools.lru_cache(maxsize=None)
def _partials(w: int, h: int, n: int, d: int, nw: int, dtype: int) -> int:
    """The partials of ``Σ dS`` a head that the backward writes at this
    shape: the library's cut, which follows the card's occupancy, asked
    once a shape."""
    parts = LIBRARY.load().sedx_wa_partials(w, h, n, d, nw, dtype)
    if parts < 0:   # the library's code, or a CUDA error's negated
        raise LIBRARY.error(parts if parts == -1 else -parts,
                            "window attention partials")
    return parts


def forward_cuda(q, k, v, bias_table, rel_index, mask, scale: float) -> torch.Tensor:
    """The forward kernel: ``o [W, N, H·d]`` in q's dtype."""
    _check(q, k, v, bias_table, rel_index, mask)
    w, h, n, d = q.shape
    lib = LIBRARY.load()
    nw = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(q.device):
        o = torch.empty((w, n, h * d), dtype=q.dtype, device=q.device)
        rc = lib.sedx_wa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPES[q.dtype],
            _strides(q), _strides(k), _strides(v), bias_table.data_ptr(),
            rel_index.data_ptr(), None if mask is None else mask.data_ptr(),
            w, h, n, d, nw, scale, o.data_ptr(), nvcc.stream(q))
        if rc:
            raise LIBRARY.error(rc, "window attention forward")
    trace.count("ops.window_attention.launches")
    return o


def backward_cuda(q, k, v, bias_table, rel_index, mask, scale: float, do):
    """The backward kernels from ``dO [W, N, H·d]``: ``(dq, dk, dv,
    dtable)``, ``dtable`` float32 like the table."""
    _check(q, k, v, bias_table, rel_index, mask)
    w, h, n, d = q.shape
    if (do.dtype != q.dtype or tuple(do.shape) != (w, n, h * d)
            or do.device != q.device):
        raise ValueError(f"dO must be {q.dtype} [{w}, {n}, {h * d}] on {q.device}")
    do = do.contiguous()
    if do.data_ptr() % 16:
        raise ValueError("dO needs a 16-byte aligned pointer")
    lib = LIBRARY.load()
    nw = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(q.device):
        parts = _partials(w, h, n, d, nw, _DTYPES[q.dtype])
        scratch = torch.empty(h * (parts + 1) * n * n, dtype=torch.float32,
                              device=q.device)
        dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format)
                      for _ in range(3))
        dtable = torch.empty_like(bias_table)
        rc = lib.sedx_wa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _DTYPES[q.dtype], _strides(q), _strides(k), _strides(v),
            bias_table.data_ptr(), rel_index.data_ptr(),
            None if mask is None else mask.data_ptr(), w, h, n, d, nw,
            bias_table.shape[0], scale, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(dq), _strides(dk), _strides(dv),
            scratch.data_ptr(), dtable.data_ptr(), nvcc.stream(q))
        if rc:
            raise LIBRARY.error(rc, "window attention backward")
    trace.count("ops.window_attention.launches", 3)
    return dq, dk, dv, dtable


# ---------------------------------------------------------------------------
# the kernels' yardstick
# ---------------------------------------------------------------------------

def mismatch(got, q, k, v, bias_table, rel_index, mask, scale: float, do,
             rtol: float, table_rtol: float) -> dict[str, float]:
    """``got = (o, dq, dk, dv, dtable)`` against the function in float64,
    each output's worst ``|got − ref| / (rtol·mag)``, ``mag`` the sum of
    the magnitudes of the terms that make the element: ``|P| |v|`` for
    ``o``, ``Pᵀ |dO|`` for ``dv``, ``scale·|dS|ₘ |k|`` and
    ``scale·|dS|ₘᵀ |q|`` for ``dq`` and ``dk``, with ``|dS|ₘ =
    P∘(|dP| + |Σ_j dP∘P|)``, and ``|dS|ₘ`` summed into the table for
    ``dtable`` (``table_rtol``). At most 1 passes: ``rtol`` covers the
    compute type's roundings of ``P``, ``dS·scale`` and the output, and
    float32 arithmetic besides."""
    w, h, n, d = q.shape
    f = torch.float64
    q64, k64, v64 = (t.to(f).reshape(w * h, n, d) for t in (q, k, v))
    do64 = do.to(f).reshape(w, n, h, d).transpose(1, 2).reshape(w * h, n, d)
    s = scale * q64 @ k64.transpose(1, 2)
    add = bias_table.to(f)[rel_index].view(n, n, h).permute(2, 0, 1)[None]
    if mask is not None:
        add = add + mask.to(f)[:, None]
    s = (s.view(-1, add.shape[0], h, n, n) + add).view(w * h, n, n)
    p = torch.softmax(s, -1)
    del s
    dp = do64 @ v64.transpose(1, 2)
    dsum = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dsm = p * (dp.abs() + dsum.abs())
    del dp, dsum

    def table(x):
        return torch.zeros(bias_table.shape, dtype=f, device=q.device).index_add_(
            0, rel_index, x.view(w, h, n * n).sum(0).t())

    def heads(x):
        return x.view(w, h, n, d)

    refs = {"o": (heads(p @ v64), heads(p @ v64.abs())),
            "dv": (heads(p.transpose(1, 2) @ do64), heads(p.transpose(1, 2) @ do64.abs())),
            "dq": (heads(scale * ds @ k64), heads(scale * dsm @ k64.abs())),
            "dk": (heads(scale * ds.transpose(1, 2) @ q64),
                   heads(scale * dsm.transpose(1, 2) @ q64.abs())),
            "dtable": (table(ds), table(dsm))}
    o, dq, dk, dv, dtable = got
    outs = {"o": o.to(f).view(w, n, h, d).transpose(1, 2),
            "dq": dq.to(f), "dk": dk.to(f), "dv": dv.to(f), "dtable": dtable.to(f)}
    worst = {}
    for name, (ref, mag) in refs.items():
        tol = (table_rtol if name == "dtable" else rtol) * mag
        worst[name] = float(((outs[name] - ref).abs() / tol.clamp(min=1e-300)).max())
    return worst


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_table, rel_index, mask, scale):
        w, h = q.shape[:2]
        with trace.span("sedx.ops.window_attention"):
            if q.is_cuda:
                o = forward_cuda(q, k, v, bias_table, rel_index, mask, scale)
                ctx.save_for_backward(q, k, v, bias_table, rel_index)
            else:
                o, p = forward_plain(q, k, v, bias_table, rel_index, mask, scale)
                ctx.save_for_backward(q, k, v, p, rel_index)
        ctx.mask, ctx.scale = mask, scale
        ctx.table = bias_table.shape, bias_table.dtype
        trace.count("ops.window_attention.calls")
        trace.count("ops.window_attention.windows", w * h)
        if mask is not None:
            trace.count("ops.window_attention.shifted_calls")
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        with trace.span("sedx.ops.window_attention.backward"):
            if do.is_cuda:
                q, k, v, table, index = ctx.saved_tensors
                grads = backward_cuda(q, k, v, table, index, ctx.mask, ctx.scale, do)
            else:
                q, k, v, p, index = ctx.saved_tensors
                grads = backward_plain(q, k, v, p, index, do, ctx.scale, ctx.table)
        return (*grads, None, None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_table: torch.Tensor, rel_index: torch.Tensor,
                     mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Windowed multi-head attention with a relative-position bias and an
    optional shift mask (the module's docstring); differentiable in ``q``,
    ``k``, ``v`` and ``bias_table``."""
    return _WindowAttention.apply(q, k, v, bias_table, rel_index, mask, scale)
