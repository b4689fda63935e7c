"""Audio Mamba's bidirectional selective scan (``models.aum``) as one
autograd function: hand-written kernels on a CUDA tensor
(``csrc/selective_scan.cu``), its plain version in stock PyTorch ops on the
CPU.

    out = selective_scan(u_f, u_b, dr_f, dr_b, B_f, C_f, B_b, C_b, z,
                         A_log_f, A_log_b, D_f, D_b, bdt_f, bdt_b)

For each direction ``d`` (``f``: tokens in order, ``b``: reversed; every
tensor is in the original token order), with ``u_d, dr_d, z [B, L, E]`` in
the compute type, ``B_d, C_d [B, L, N]`` (any batch and token strides,
the slices of ``x_proj``'s output), ``A_log_d [E, N]``, ``D_d`` and
``bdt_d [E]`` float32 parameters:

    Δ = softplus(dr_d + bdt_d),  A = −exp(A_log_d)
    h_t = exp(Δ_t A) ⊙ h_{t∓1} + (Δ_t u_t) ⊗ B_t,  y_d,t = h_t · C_t + D_d u_t

(``h`` runs over ``t = 0..L−1`` for ``f`` and ``t = L−1..0`` for ``b``,
from 0), and returns the gated mean ``(y_f + y_b) · silu(z) / 2`` in the
compute type. Differentiable in every input.

A CUDA call goes to the kernels: one forward launch covers both
directions (the backward one read by reversed index, no flipped copy),
keeps each channel's ``[N]`` state in float32 registers and saves, besides
the inputs, ``y_f + y_b`` in float32 for ``dz``; one backward launch (a
block grid a direction) recomputes the states from chunk checkpoints
rather than saving ``[B, L, E, N]``, and the wrapper sums its partials of
``dB``, ``dC``, ``dA_log``, ``dD`` and ``dbdt`` over blocks and rows in a
fixed order, so two calls give the same bits. Arithmetic is float32 with
inputs and outputs in bf16 or float32; ``exp(ΔA)`` is the special-function
unit's ``ex2.approx``, so the result is not the plain version's bit for bit
(:func:`mismatch` holds both to float64). The kernels take ``N = 16`` and
``E`` a multiple of 64, contiguous ``[B, L, E]`` activations, ``B``/``C``
with unit stride over ``N``, and float32 parameters; anything else raises,
and nothing falls back. The launches run on PyTorch's current stream, so a
CUDA graph captures them.

A CPU call (float64 included) takes the plain version (:func:`forward_plain`,
a loop over tokens, in float32 or the inputs' wider type), and its backward
is autograd through it, recomputed (:func:`backward_plain`); the card tests
run it on the card to hold the kernels to it.

The forward runs inside the span ``sedx.ops.selective_scan``, the backward
inside ``sedx.ops.selective_scan.backward`` (on autograd's thread).
Counters: ``ops.selective_scan.calls`` (forwards), ``.tokens`` (rows ×
tokens a forward), ``.plain_calls`` (forwards on the plain version) and,
on a card only, ``.launches`` (kernel launches: 1 a forward, 1 a
backward). The library is built with ``nvcc`` at first use
(:data:`LIBRARY`, an ``nvcc.Library``); importing this module needs
neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import trace
from . import nvcc

__all__ = ["LIBRARY", "STATES", "backward_cuda", "backward_plain", "forward_cuda",
           "forward_plain", "mismatch", "plain_grads", "scan_plain", "selective_scan"]

SOURCE = Path(__file__).parent / "csrc" / "selective_scan.cu"
STATES = 16                 # the kernels' N (d_state)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the pointer table's slots (``Slot`` in the source)
_INPUTS = ("u_f", "u_b", "dr_f", "dr_b", "B_f", "C_f", "B_b", "C_b", "z",
           "A_log_f", "A_log_b", "D_f", "D_b", "bdt_f", "bdt_b")
_ACTS = 9                   # the inputs with a batch axis; the parameters follow
_FWD_SLOTS = len(_INPUTS) + 2           # + ysum, out
_BWD_SLOTS = len(_INPUTS) + 12          # + ysum, dout, du ×2, ddr ×2, dz, 5 scratch

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ENTRY = (_ci, [_ci, ctypes.POINTER(_vp), ctypes.POINTER(ctypes.c_longlong), _ci, _ci, _ci,
                _vp])
#: ``csrc/selective_scan.cu``, built at first use (:class:`nvcc.Library`).
LIBRARY = nvcc.Library(SOURCE, "selective_scan", {
    "sedx_ss_forward": _ENTRY, "sedx_ss_backward": _ENTRY,
    "sedx_ss_chunk_tokens": (_ci, []), "sedx_ss_block_channels": (_ci, [])},
    "sedx_ss_error_string")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def scan_plain(u, dr, B, C, A_log, D, bdt, reverse: bool) -> torch.Tensor:
    """One direction's ``y [B, L, E]`` by a loop over tokens, in float32 or
    the inputs' wider type."""
    acc = torch.promote_types(u.dtype, torch.float32)
    u, dr, B, C = (t.to(acc) for t in (u, dr, B, C))
    delta = F.softplus(dr + bdt.to(acc))
    # a token's slices by unbind: one node whose backward stacks the
    # tokens' gradients (indexing would add a full-size gradient a token)
    a = torch.exp(delta[..., None] * -torch.exp(A_log.to(acc))).unbind(1)   # [B, E, N] each
    bu = ((delta * u)[..., None] * B[:, :, None, :]).unbind(1)
    cs = C[..., None].unbind(1)                                            # [B, N, 1] each
    h = torch.zeros_like(a[0])
    ys = [None] * u.shape[1]
    for t in (range(u.shape[1] - 1, -1, -1) if reverse else range(u.shape[1])):
        h = torch.addcmul(bu[t], a[t], h)
        ys[t] = torch.bmm(h, cs[t])[..., 0]
    return torch.stack(ys, 1) + D.to(acc) * u


def forward_plain(u_f, u_b, dr_f, dr_b, B_f, C_f, B_b, C_b, z, A_log_f, A_log_b,
                  D_f, D_b, bdt_f, bdt_b) -> torch.Tensor:
    """The function in stock ops (the module docstring), in ``u_f``'s dtype."""
    y = (scan_plain(u_f, dr_f, B_f, C_f, A_log_f, D_f, bdt_f, False)
         + scan_plain(u_b, dr_b, B_b, C_b, A_log_b, D_b, bdt_b, True))
    zz = z.to(y.dtype)
    return (y * F.silu(zz) / 2).to(u_f.dtype)


def backward_plain(inputs, dout) -> tuple:
    """Every input's gradient (``None`` for one that is not a floating
    tensor), by autograd through :func:`forward_plain` recomputed."""
    return _plain_both(inputs, dout)[1:]


def _plain_both(inputs, dout) -> tuple:
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = forward_plain(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, dout))


def plain_grads(inputs, dout, rows: int | None = None) -> tuple:
    """``(out, *grads)`` of the plain version, computed ``rows`` rows at a
    time (all at once when ``None``): the rows are independent but for the
    parameters' gradients, which are summed over the blocks in order. At a
    training batch the blocks keep the loop's ``[rows, E, N]`` states per
    token within a card's memory."""
    batch = inputs[0].shape[0]
    rows = rows or batch
    parts = [_plain_both(tuple(t[i:i + rows] for t in inputs[:_ACTS])
                         + tuple(inputs[_ACTS:]), dout[i:i + rows])
             for i in range(0, batch, rows)]
    return tuple(torch.cat(p) if k <= _ACTS else functools.reduce(torch.add, p)
                 for k, p in enumerate(zip(*parts)))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sizes() -> tuple:
    """The library's tokens a chunk and channels a block."""
    lib = LIBRARY.load()
    return lib.sedx_ss_chunk_tokens(), lib.sedx_ss_block_channels()


def _check(args: tuple) -> tuple:
    """``(B, L, E)`` after checking what the kernels take."""
    t = dict(zip(_INPUTS, args))
    u = t["u_f"]
    if not all(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in args):
        raise ValueError("the selective-scan kernels take CUDA tensors")
    if u.dtype not in _DTYPES:
        raise TypeError(f"the selective-scan kernels take float32 or bfloat16 (got "
                        f"{u.dtype})")
    if u.ndim != 3 or u.numel() == 0:
        raise ValueError(f"expected a non-empty u [B, L, E] (got {tuple(u.shape)})")
    b, length, e = u.shape
    if e % 64:
        raise ValueError(f"the kernels take a width that is a multiple of 64 (got {e})")
    for name in ("u_f", "u_b", "dr_f", "dr_b", "z"):
        x = t[name]
        if x.dtype != u.dtype or x.shape != u.shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {u.dtype} {tuple(u.shape)}")
    for name in ("B_f", "C_f", "B_b", "C_b"):
        x = t[name]
        if (x.dtype != u.dtype or tuple(x.shape) != (b, length, STATES)
                or x.stride(2) != 1):
            raise ValueError(f"{name} must be a {u.dtype} [{b}, {length}, {STATES}] "
                             f"with unit stride over the states")
    for name, shape in (("A_log", (e, STATES)), ("D", (e,)), ("bdt", (e,))):
        for d in "fb":
            x = t[f"{name}_{d}"]
            if (x.dtype != torch.float32 or tuple(x.shape) != shape
                    or not x.is_contiguous()):
                raise ValueError(f"{name}_{d} must be a contiguous float32 {shape}")
    if any(x.device != u.device for x in args):
        raise ValueError("the selective scan's tensors must share one device")
    return b, length, e


def _strides(args: tuple):
    t = dict(zip(_INPUTS, args))
    return (ctypes.c_longlong * 8)(*(s for name in ("B_f", "C_f", "B_b", "C_b")
                                     for s in t[name].stride()[:2]))


def _table(tensors) -> ctypes.Array:
    return (_vp * len(tensors))(*(t.data_ptr() for t in tensors))


def forward_cuda(*args) -> tuple:
    """The forward kernel: ``(out, ysum)``, ``out [B, L, E]`` in the
    compute type, ``ysum = y_f + y_b`` in float32 (the backward's)."""
    b, length, e = _check(args)
    lib = LIBRARY.load()
    u = args[0]
    with torch.cuda.device(u.device):
        ysum = torch.empty((b, length, e), dtype=torch.float32, device=u.device)
        out = torch.empty_like(u)
        ptrs = _table((*args, ysum, out))
        assert len(ptrs) == _FWD_SLOTS
        rc = lib.sedx_ss_forward(_DTYPES[u.dtype], ptrs, _strides(args), b, length, e,
                                 nvcc.stream(u))
        if rc:
            raise LIBRARY.error(rc, "selective scan forward")
    trace.count("ops.selective_scan.launches")
    return out, ysum


def backward_cuda(args: tuple, ysum: torch.Tensor, dout: torch.Tensor) -> tuple:
    """The backward kernel from ``dout [B, L, E]``: the inputs' gradients
    in :data:`_INPUTS`' order (the parameters' in float32)."""
    b, length, e = _check(args)
    u = args[0]
    dout = dout.contiguous()
    if dout.dtype != u.dtype or dout.shape != u.shape or dout.device != u.device:
        raise ValueError(f"dout must be a {u.dtype} {tuple(u.shape)} on {u.device}")
    if ysum.dtype != torch.float32 or ysum.shape != u.shape or not ysum.is_contiguous():
        raise ValueError("ysum must be the forward's contiguous float32 y_f + y_b")
    lib = LIBRARY.load()
    chunk, block = _sizes()
    dev, f32 = u.device, torch.float32
    with torch.cuda.device(dev):
        du_f, du_b, ddr_f, ddr_b, dz = (torch.empty_like(u) for _ in range(5))
        ckpt = torch.empty((2, b, -(-length // chunk), STATES, e), dtype=f32, device=dev)
        pbc = torch.empty((2, b, length, e // block, 2 * STATES), dtype=f32, device=dev)
        pa = torch.empty((2, b, STATES, e), dtype=f32, device=dev)
        pd = torch.empty((2, b, e), dtype=f32, device=dev)
        pb = torch.empty((2, b, e), dtype=f32, device=dev)
        ptrs = _table((*args, ysum, dout, du_f, du_b, ddr_f, ddr_b, dz, ckpt, pbc, pa,
                       pd, pb))
        assert len(ptrs) == _BWD_SLOTS
        rc = lib.sedx_ss_backward(_DTYPES[u.dtype], ptrs, _strides(args), b, length, e,
                                  nvcc.stream(u))
        if rc:
            raise LIBRARY.error(rc, "selective scan backward")
        del ckpt
        # the partials in a fixed order: over the channel blocks, then the rows
        bc = pbc.sum(3).to(u.dtype)                      # [2, B, L, 2N]
        d_alog = pa.sum(1).transpose(1, 2).contiguous()  # [2, E, N]
        d_d, d_bdt = pd.sum(1), pb.sum(1)                # [2, E]
    trace.count("ops.selective_scan.launches")
    return (du_f, du_b, ddr_f, ddr_b, bc[0, ..., :STATES], bc[0, ..., STATES:],
            bc[1, ..., :STATES], bc[1, ..., STATES:], dz, d_alog[0], d_alog[1],
            d_d[0], d_d[1], d_bdt[0], d_bdt[1])


# ---------------------------------------------------------------------------
# the kernels' yardstick
# ---------------------------------------------------------------------------

def mismatch(got, args: tuple, dout: torch.Tensor,
             rows: int | None = None) -> dict[str, float]:
    """``got = (out, *grads)`` (the inputs' gradients in the function's
    order) against the function computed in float64 from the same inputs
    (:func:`plain_grads`, ``rows`` rows at a time): each output's relative
    gap in norm, ``‖got − ref‖ / ‖ref‖``."""
    ref = plain_grads(tuple(t.double() for t in args), dout.double(), rows)
    out = {}
    for name, g, r in zip(("out",) + _INPUTS, got, ref):
        out[name] = float((g.double() - r).norm() / r.norm().clamp(min=1e-300))
    return out


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        u = args[0]
        with trace.span("sedx.ops.selective_scan"):
            if u.is_cuda:
                out, ysum = forward_cuda(*args)
                ctx.save_for_backward(*args, ysum)
            else:
                out = forward_plain(*args)
                ctx.save_for_backward(*args)
                trace.count("ops.selective_scan.plain_calls")
        trace.count("ops.selective_scan.calls")
        trace.count("ops.selective_scan.tokens", u.shape[0] * u.shape[1])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        with trace.span("sedx.ops.selective_scan.backward"):
            saved = ctx.saved_tensors
            if dout.is_cuda:
                return backward_cuda(saved[:-1], saved[-1], dout)
            return backward_plain(saved, dout)


def selective_scan(u_f, u_b, dr_f, dr_b, B_f, C_f, B_b, C_b, z, A_log_f, A_log_b,
                   D_f, D_b, bdt_f, bdt_b) -> torch.Tensor:
    """The bidirectional selective scan and its gate (the module
    docstring)."""
    return _SelectiveScan.apply(u_f, u_b, dr_f, dr_b, B_f, C_f, B_b, C_b, z,
                                A_log_f, A_log_b, D_f, D_b, bdt_f, bdt_b)
