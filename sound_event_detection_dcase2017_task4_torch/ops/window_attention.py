"""The core of HTS-AT's shifted-window attention (``models.htsat``) as one
autograd function, its forward and its backward written in stock PyTorch
ops: the place where a fused kernel goes.

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
``dq = scale·dS k``, ``dk = scale·dSᵀ q``, ``dv = Pᵀ dO`` (``dS`` and ``P``
cast to the compute type), and ``dS`` summed over the windows and scattered
into the table's gradient. A float64 call computes in float64 throughout.

The forward runs inside the span ``sedx.ops.window_attention``, the
backward inside ``sedx.ops.window_attention.backward`` (on autograd's
thread). Counters: ``ops.window_attention.calls`` (forwards),
``ops.window_attention.windows`` (window-heads, ``W·H``, a forward) and
``ops.window_attention.shifted_calls`` (forwards with a mask).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import trace

__all__ = ["window_attention", "relative_index", "shift_mask"]


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


def _bmm_acc(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` (batched) accumulated and returned in ``acc``."""
    if a.dtype == acc:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=acc)
    return torch.bmm(a.to(acc), b.to(acc))


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_table, rel_index, mask, scale):
        w, h, n, d = q.shape
        acc = torch.promote_types(q.dtype, torch.float32)
        with trace.span("sedx.ops.window_attention"):
            q, k, v = (t.reshape(w * h, n, d) for t in (q, k, v))
            # bias and mask as one [nW, H, N, N] addend, taken with the scale
            # in one pass over the scores
            add = bias_table[rel_index].to(acc).view(n, n, h).permute(2, 0, 1)[None]
            if mask is not None:
                add = add + mask.to(acc)[:, None]
            s = _bmm_acc(q, k.transpose(1, 2), acc)
            s5 = s.view(-1, add.shape[0], h, n, n)
            torch.add(add, s5, alpha=scale, out=s5)
            p = torch.softmax(s, dim=-1)
            pc = p.to(v.dtype)
            o = torch.bmm(pc, v).view(w, h, n, d).transpose(1, 2).reshape(w, n, h * d)
        ctx.save_for_backward(q, k, v, p, pc, rel_index)
        ctx.scale, ctx.shape = scale, (w, h, n, d)
        ctx.table = bias_table.shape, bias_table.dtype
        trace.count("ops.window_attention.calls")
        trace.count("ops.window_attention.windows", w * h)
        if mask is not None:
            trace.count("ops.window_attention.shifted_calls")
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, p, pc, rel_index = ctx.saved_tensors
        w, h, n, d = ctx.shape
        with trace.span("sedx.ops.window_attention.backward"):
            do = do.reshape(w, n, h, d).transpose(1, 2).reshape(w * h, n, d)
            dv = torch.bmm(pc.transpose(1, 2), do)
            dp = _bmm_acc(do, v.transpose(1, 2), p.dtype)
            # dS = P∘(dP − Σ_j dP∘P): softmax's own backward
            ds = torch._softmax_backward_data(dp, p, -1, p.dtype)
            shape, dtype = ctx.table
            dtable = torch.zeros(shape, dtype=dtype, device=q.device)
            dtable.index_add_(0, rel_index, ds.view(w, h, n * n).sum(0).t()
                              .to(dtype))
            ds = (ds * ctx.scale).to(q.dtype)
            dq = torch.bmm(ds, k)
            dk = torch.bmm(ds.transpose(1, 2), q)
        return (dq.view(w, h, n, d), dk.view(w, h, n, d), dv.view(w, h, n, d),
                dtable, None, None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_table: torch.Tensor, rel_index: torch.Tensor,
                     mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Windowed multi-head attention with a relative-position bias and an
    optional shift mask (the module's docstring); differentiable in ``q``,
    ``k``, ``v`` and ``bias_table``."""
    return _WindowAttention.apply(q, k, v, bias_table, rel_index, mask, scale)
