"""Root entry points: the flagship's forward, and a data-parallel dry run.

Counterpart of the repository's ``__graft_entry__.py``:

* :func:`entry` returns ``(forward, args)``: the forward of the flagship
  ``Cnn_9layers_Gru_FrameAtt`` at full width (channels 64-512, BiGRU 256, 17
  classes) on 2 s clips, as a pure function of its parameters, buffers and
  waveform (``torch.func.functional_call``), and example arguments from a
  seeded init. On the card its frontend is the hand-written waveform kernel
  (``ops.logmel_cuda.logmel_cuda``, one launch a call).
* :func:`dryrun_multichip` runs the whole training step (frontend,
  normalisation, mixup α = 1, dropout 0.2, forward, loss, backward, Adam)
  data parallel over ``n`` ranks, one process each (``parallel.launch``;
  on the card rank ``r`` takes ``cuda:r``), and holds it to
  the same step with no mesh from the same state and generators at the JAX
  function's tolerances, then runs a ragged eval over the mesh.

Unlike the JAX file there is no fallback to the CPU: with ``device=None``
both run on the card and raise without one; ``device="cpu"`` is the caller's
explicit choice (the plain frontend, gloo ranks).

    python -m sound_event_detection_dcase2017_task4_torch.graft_entry
    python -m sound_event_detection_dcase2017_task4_torch.graft_entry multichip N [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import parallel, resolve_device, trace, train
from .config import Config
from .models import get_model
from .ops.stft import make_logmel_fn

__all__ = ["FLAGSHIP", "entry", "dryrun_multichip", "main"]

FLAGSHIP = "Cnn_9layers_Gru_FrameAtt"
ENTRY_BATCH = 4


def entry(device=None):
    """``(forward, (params, buffers, waveform))`` on the flagship model.

    ``forward(params, buffers, waveform)`` returns ``(clipwise [B, 17],
    framewise [B, frames, 17])`` in eval mode (running BatchNorm
    statistics); ``params`` and ``buffers`` are the model's tensors by name
    (seed-0 init, detached), ``waveform`` is ``zeros([4, 64000])`` float32
    on the device."""
    dev = resolve_device(device)
    cfg = Config(clip_samples=64000)            # 2 s clips
    model = get_model(FLAGSHIP).to(dev).eval()
    frontend = make_logmel_fn(cfg)

    def forward(params, buffers, waveform):
        out = torch.func.functional_call(model, (params, buffers),
                                         (frontend(waveform),),
                                         {"train": False})
        return out["clipwise_output"], out["framewise_output"]

    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    wave = torch.zeros((ENTRY_BATCH, cfg.clip_samples), dtype=torch.float32,
                       device=dev)
    return forward, (params, buffers, wave)


def _running(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.named_buffers()
            if "running" in k}


def _dryrun_rank(n_devices: int, device: torch.device) -> dict:
    """This rank's part of :func:`dryrun_multichip` (a rank of
    ``parallel.launch``): the step with no mesh and over the mesh, the
    tolerances, the ragged eval."""
    if device.type == "cuda":
        # the two legs are held to float32 tolerances: no TF32, and cuDNN's
        # deterministic algorithms
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    mesh = parallel.make_mesh(device)
    cfg = Config(clip_samples=16000)            # 0.5 s clips
    scalar = (np.zeros(cfg.mel_bins, np.float32),
              np.ones(cfg.mel_bins, np.float32))
    frontend = make_logmel_fn(cfg)
    rng = np.random.RandomState(0)
    bsz = 2 * n_devices
    wave = rng.randn(bsz, cfg.clip_samples).astype(np.float32) * 0.1
    target = (rng.rand(bsz, cfg.classes_num) < 0.2).astype(np.float32)

    def leg(mesh):
        model = get_model(FLAGSHIP)                          # seed 0
        state = train.create_train_state(model, cfg, device=device)
        step = train.make_train_step(model, state, frontend=frontend,
                                     scalar=scalar, mixup_alpha=1.0,
                                     mesh=mesh)
        m = step(parallel.shard_batch(wave, mesh), target)
        return model, float(m["loss"]), float(m["grad_norm"])

    # the reference leg: the same step from the same state and generators
    # on the whole global batch in this process; the data-parallel leg must
    # agree with it, or the collectives are wrong
    ref, loss1, gnorm1 = leg(None)
    model, loss, gnorm = leg(mesh)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    np.testing.assert_allclose(loss, loss1, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(gnorm, gnorm1, rtol=1e-4, atol=1e-6)
    want = _running(ref)
    for k, got in _running(model).items():
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)

    # the ragged eval: 2n − 1 rows padded, split, gathered and trimmed
    evaluate = train.make_eval_step(model, frontend=frontend, scalar=scalar)
    out = train.forward_generator(
        evaluate, iter([(wave[: bsz - 1], target[: bsz - 1])]),
        return_target=False, prefetch=0, mesh=mesh)
    clip = out["clipwise_output"]
    if clip.shape != (bsz - 1, cfg.classes_num) or not np.isfinite(clip).all():
        raise AssertionError(f"ragged eval: {clip.shape}, finite "
                             f"{bool(np.isfinite(clip).all())}")
    return {"rank": mesh.rank, "loss": loss, "loss_1": loss1,
            "grad_norm": gnorm, "grad_norm_1": gnorm1,
            "eval_shape": clip.shape,
            "launches": {k: trace.counters().get(f"ops.{k}.launches", 0)
                         for k in ("logmel", "logmel_bank")}}


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> dict:
    """One data-parallel training step of the flagship on ``n_devices``
    ranks, held to the same step with no mesh (loss rtol 2e-5, grad-norm
    rtol 1e-4, every BatchNorm running statistic rtol 1e-4 / atol 1e-5),
    then a ragged eval over the mesh.

    ``device=None`` (or ``"cuda"``) runs one process per card under NCCL,
    rank ``r`` on ``cuda:r``, and raises when there are fewer than
    ``n_devices`` cards (or for a card other than ``cuda:0``, where rank 0
    would not run); ``device="cpu"`` runs ``n_devices`` gloo ranks of one
    thread each.
    Each rank asserts the tolerances; a rank that fails, or a launch that
    outlives ``timeout`` seconds, raises here. Returns rank 0's losses and
    grad-norms (``loss``/``grad_norm`` over the mesh, ``loss_1``/
    ``grad_norm_1`` with no mesh), the eval's shape and every rank's kernel
    launches."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs a rank (got {n_devices})")
    dev = resolve_device(device)
    if dev.type == "cuda" and (dev.index or 0) != 0:
        raise ValueError(f"dryrun_multichip's ranks take cuda:0 … cuda:"
                         f"{n_devices - 1}, not {dev}; pass device='cuda'")
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                           f"cards; {torch.cuda.device_count()} visible")
    # by the module's own name: under ``python -m`` this one is __main__
    ranks = parallel.launch(f"{__package__}.graft_entry:_dryrun_rank",
                            n_devices, arg=n_devices, device=dev.type,
                            timeout=timeout)
    first = ranks[0]
    for r in ranks[1:]:
        for k in ("loss", "grad_norm", "loss_1", "grad_norm_1"):
            if r[k] != first[k]:
                raise AssertionError(f"rank {r['rank']} {k} {r[k]} != rank 0's "
                                     f"{first[k]}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    print(f"dryrun_multichip({n_devices}): OK  mesh={{'data': {n_devices}}} "
          f"({backend})  eval={first['eval_shape']}  equivalence "
          f"loss {n_devices}dev={first['loss']:.6f} vs "
          f"1dev={first['loss_1']:.6f}  grad_norm {first['grad_norm']:.6f} vs "
          f"{first['grad_norm_1']:.6f}  batch_stats allclose", flush=True)
    return {"n_devices": n_devices, "backend": backend,
            **{k: first[k] for k in ("loss", "loss_1", "grad_norm",
                                     "grad_norm_1", "eval_shape")},
            "launches": [r["launches"] for r in ranks]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m sound_event_detection_dcase2017_task4_torch.graft_entry",
        description="Run entry()'s forward once, or dryrun_multichip(N).")
    ap.add_argument("command", nargs="?", choices=["entry", "multichip"],
                    default="entry")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks for multichip (default 8)")
    ap.add_argument("--device", default=None,
                    help="cpu: the plain frontend, gloo ranks (default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.command == "multichip":
        dryrun_multichip(args.n, device=args.device)
        return
    forward, fargs = entry(device=args.device)
    clip, frame = forward(*fargs)
    print(f"entry: OK  clipwise {tuple(clip.shape)}  framewise "
          f"{tuple(frame.shape)}  on {clip.device}")


if __name__ == "__main__":
    main()
