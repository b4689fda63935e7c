"""Data-parallel training over processes, one per card.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/parallel/mesh.py``.
The JAX package trains on every visible device through a 1-D ``"data"`` mesh:
under ``jax.jit`` its arrays are global, so XLA takes BatchNorm statistics
over the global batch, draws dropout for the global batch, flips the global
batch for mixup and all-reduces the gradients, and an N-device step is the
1-device step. The port runs one process per card (``torchrun``) and writes
those collectives out:

* a :class:`Mesh` is a ``torch.distributed`` process group with this
  process's rank in it, its size and the rank's device (NCCL on CUDA, gloo
  on the CPU);
* a batch of ``B`` rows is split in rank order: rank ``r`` holds rows
  ``[r·b, (r+1)·b)`` with ``b = B/n`` (:func:`shard_batch`);
* :func:`all_reduce_sum` is a sum over the mesh whose gradient is the same
  sum (the global BatchNorm statistics); :func:`average_` averages the
  gradients in one flat collective; :func:`mirror` hands a rank the rows of
  rank ``n − 1 − r`` (the global mixup partner); :func:`gather_rows`
  concatenates every rank's rows (the eval outputs); :func:`replicate`
  gives every rank rank 0's parameters and buffers (the role of JAX's
  ``replicated_sharding``).

Draws with a batch dimension are made for the global batch on every rank
and sliced, so that the same generator state gives the same bits in one
process and in N.

Every function takes ``mesh=None`` for a process in no group, a mesh of one:
it then returns its input (or nothing) and runs no collective, so one code
path serves both.

:func:`launch` starts a job without ``torchrun``: ``n`` fresh interpreters,
described to :func:`join` as ``torchrun`` describes its ranks, meeting over a
``FileStore`` in a temporary directory (no port to collide with), with a
deadline after which every rank is killed.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["Mesh", "is_initialized", "world_size", "join", "make_mesh",
           "make_mesh_for_batch", "mesh_size", "shard_batch",
           "all_reduce_sum", "average_", "mirror", "gather_rows",
           "replicate", "barrier", "pad_rows", "launch"]

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``group`` holds ranks ``0 … size − 1`` of
    the job (its ranks in the group are its ranks in the job), ``rank`` is
    this process's and ``device`` its card (or the CPU)."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device


def is_initialized() -> bool:
    """Whether this process is in an initialised ``torch.distributed``
    group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The job's process count: the initialised group's size, else the
    ``WORLD_SIZE`` that ``torchrun`` sets, else 1."""
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def join(device=None, init_method=None) -> tuple[torch.device, bool]:
    """This process's device in the job, and whether this call started the
    job's process group (the caller then destroys it).

    An initialised ``torch.distributed`` group is used as it is, on the
    card its caller made current (``torch.cuda.current_device()``) or on the
    CPU. Otherwise, when ``torchrun`` describes more than one process
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), or ``init_method`` names
    where the ranks meet (then also for a job of one), the process takes
    ``cuda:LOCAL_RANK``, makes it current before anything touches the card
    and joins over ``init_method`` (``env://`` by default) with NCCL (gloo
    when ``device`` is the CPU). With neither there is no group:
    ``resolve_device(device)``.
    """
    dev = resolve_device(device)
    if is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, False
    if world_size() == 1 and init_method is None:
        return dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            timeout=TIMEOUT)
    return dev, True


def make_mesh(device) -> Mesh:
    """The mesh over every process of the initialised group, this process
    on ``device``."""
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                torch.device(device))


def make_mesh_for_batch(batch_size: int, device) -> Optional[Mesh]:
    """The largest mesh whose size divides ``batch_size`` (a global batch
    must split evenly), as the JAX ``make_mesh_for_batch``: ranks ``0 … n −
    1`` of the job with ``n ≤ world size``. Every process must call it (a
    new group is made collectively); a rank outside the mesh gets ``None``
    and sits the run out."""
    world = dist.get_world_size()
    n = world
    while n > 1 and batch_size % n != 0:
        n -= 1
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, rank, n, torch.device(device)) if rank < n else None


def mesh_size(mesh: Optional[Mesh]) -> int:
    """The number of ranks in ``mesh`` (1 for ``None``)."""
    return 1 if mesh is None else mesh.size


def shard_batch(batch, mesh: Optional[Mesh], dim: int = 0):
    """This rank's rows ``[r·b, (r+1)·b)`` of a global batch (a tensor or an
    array) along ``dim``; the JAX ``shard_batch`` places the same rows on
    device ``r``."""
    if mesh is None:
        return batch
    b, rest = divmod(batch.shape[dim], mesh.size)
    if rest:
        raise ValueError(f"a batch of {batch.shape[dim]} does not split over "
                         f"{mesh.size} ranks")
    index = [slice(None)] * batch.ndim
    index[dim] = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return batch[tuple(index)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the mesh, with a gradient: the sum's gradient
    reaches every rank's ``x`` as the sum of the ranks' gradients."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def average_(tensors, mesh: Optional[Mesh]) -> None:
    """Replace each tensor (all of one dtype) by its mean over the mesh, in
    one collective over a flat copy of them all."""
    if mesh is None:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def mirror(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The rows that rank ``n − 1 − r`` holds, exchanged point to point; the
    middle rank of an odd mesh (and the only rank of a mesh of one) keeps
    its own."""
    if mesh is None:
        return x
    peer = mesh.size - 1 - mesh.rank
    if peer == mesh.rank:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, peer, mesh.group),
             dist.P2POp(dist.irecv, out, peer, mesh.group)]):
        req.wait()
    return out


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (of one shape), concatenated in rank order."""
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Give every rank rank 0's parameters and buffers, in place."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.detach(), src=0, group=mesh.group)


def barrier(mesh: Optional[Mesh]) -> None:
    """Return when every rank of the mesh has reached this call: a
    one-element all-reduce, read back on the host (on NCCL the collective
    alone would return before it completes)."""
    if mesh is None:
        return
    flag = torch.ones(1, device=mesh.device)
    dist.all_reduce(flag, group=mesh.group)
    flag.item()


def pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    """``x`` with zero rows appended up to a multiple of ``multiple`` rows
    (a zero index on the bank path, a zero clip otherwise)."""
    pad = -len(x) % multiple
    if not pad:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


_RANK_CODE = (
    "import json, sys\n"
    "sys.path[:] = json.loads(sys.argv[1])\n"
    "from sound_event_detection_dcase2017_task4_torch.parallel.mesh import _rank\n"
    "_rank(*sys.argv[2:])\n")


def _rank(target: str, workdir: str, device: str) -> None:
    """A rank of :func:`launch`: join the job, run ``target`` on the
    launch's argument, save what it returns."""
    if torch.device(device).type == "cpu":
        # one thread: n ranks do not oversubscribe the cores, and the CPU
        # conv backward's reduction order follows the rows alone, as in a
        # one-thread process with no group
        torch.set_num_threads(1)
    n, rank = world_size(), int(os.environ["RANK"])
    dev, _ = join(device, init_method=(
        f"file://{os.path.join(workdir, 'store')}?rank={rank}&world_size={n}"))
    try:
        module, fn = target.split(":")
        arg = torch.load(os.path.join(workdir, "arg.pt"), weights_only=False)
        out = getattr(importlib.import_module(module), fn)(arg, dev)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(target: str, n: int, arg=None, device="cpu",
           timeout: float = 600.0) -> list:
    """Run ``target`` (``"module:function"``) as ranks ``0 … n − 1`` of one
    job and return what each returned, in rank order.

    Each rank is a fresh interpreter with the caller's ``sys.path`` (unlike
    ``multiprocessing``'s spawn it does not import the caller's
    ``__main__``) and ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set as
    ``torchrun`` sets them; it joins the group over a ``FileStore`` in a
    temporary directory (:func:`join`: rank ``r`` on ``cuda:r`` under NCCL,
    or on the CPU under gloo with one thread), calls ``function(arg,
    device)`` and sends its return value back by file. When a rank fails,
    every rank is killed and the call raises with the failed rank's output;
    so it does when they have not all ended within ``timeout`` seconds."""
    workdir = tempfile.mkdtemp(prefix="sedx_ranks_")
    procs, logs = [], []
    try:
        torch.save(arg, os.path.join(workdir, "arg.pt"))
        for r in range(n):
            logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w"))
            env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                       LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_CODE, json.dumps(sys.path),
                 target, workdir, str(device)],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    log = f.read()[-4000:]
                raise RuntimeError(f"{target} on {n} ranks: rank {r} exited "
                                   f"with {codes[r]}:\n{log}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{target} on {n} ranks did not end within "
                                   f"{timeout} s")
            time.sleep(0.05)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for f in logs:
            f.close()
        shutil.rmtree(workdir, ignore_errors=True)
