"""Model FLOP utilisation of the bench train step on the card.

Counterpart of the repository's ``tools/mfu.py``:

    MFU = flops_per_step / step_seconds / peak_flops

for the bench configuration (``bench.py``'s: ``Cnn_9layers_Gru_FrameAtt``
in bf16 at batch 128 over an int16 chunk bank, mixup α = 1, scalar mean
−30 / std 15).

* **FLOPs** are counted on the CPU by ``torch.utils.flop_counter`` over the
  port's ``train.make_train_step`` at a small batch (the count is linear in
  the batch) and scaled to 128: the port's counterpart of the JAX tool's
  lowering on the CPU. It counts on the CPU because on the card the
  counter sees neither the hand-written kernel (a ctypes call) nor cuDNN's
  RNN (``aten._cudnn_rnn`` is not in its table), while on the CPU the GRU
  runs as counted matmuls. The count is of the f32 model: the bf16 step
  does the same operations in another type. The plain frontend's DFT
  (``bmm``) and mel product are taken out of the count and the kernel's own
  count (``ops.logmel_cuda.flops_and_bytes``, the bound ``chip_smoke.py``
  uses) is put in for the step's 128 int16 rows.
* **The step time** is measured on the card with CUDA events over steps of
  the bench configuration through the bank kernel, unless ``--step_ms``
  gives one (then no card is needed).
* **The peak** defaults to 989 TFLOP/s, the H100 SXM's dense bf16 rate.

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.tools.mfu
    python -m sound_event_detection_dcase2017_task4_torch.tools.mfu --step_ms 150
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import resolve_device
from . import device_info

H100_BF16_PEAK = 989e12
# the measured configuration: bench.py's (BATCH, MODEL_TYPE, scalar)
BATCH = 128
MODEL_TYPE = "Cnn_9layers_Gru_FrameAtt"
SCALAR_MEAN, SCALAR_STD = -30.0, 15.0
BANK_CLIPS = 512
WAVE_SCALE = 2.0 ** -15
COUNT_BATCH = 1                     # the FLOPs are counted at this batch
TIMED_STEPS, WARMUP_STEPS = 20, 3


def _scalar(cfg):
    return (np.full(cfg.mel_bins, SCALAR_MEAN, np.float32),
            np.full(cfg.mel_bins, SCALAR_STD, np.float32))


def step_flops(batch: int) -> tuple:
    """``(model_flops, plain_frontend_flops)`` of one f32 bench step at
    ``batch`` on the CPU: the step's count without the plain frontend's,
    and the plain frontend's alone."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import train
    from ..config import DEFAULT as cfg
    from ..models import get_model
    from ..ops import stft

    model = get_model(MODEL_TYPE, generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, cfg, device="cpu")
    frontend = stft.make_logmel_fn(cfg)
    step = train.make_train_step(model, state, frontend=frontend,
                                 scalar=_scalar(cfg), mixup_alpha=1.0)
    wave = np.zeros((batch, cfg.clip_samples), np.float32)
    with FlopCounterMode(display=False) as whole:
        step(wave, np.zeros((batch, 17), np.float32))
    with FlopCounterMode(display=False) as front:
        frontend(torch.from_numpy(wave))
    fe = front.get_total_flops()
    return whole.get_total_flops() - fe, fe


def _int16_bank(torch, cfg, dev, n: int, seed: int = 0):
    """``n`` seeded noise clips, int16, staged as chunk rows on ``dev``."""
    from ..ops import stft

    g = torch.Generator(device=dev).manual_seed(seed)
    wave = torch.randn((n, cfg.clip_samples), generator=g, device=dev)
    q = (wave * (0.1 / WAVE_SCALE)).round_().clamp_(-32768, 32767)
    return stft.prepare_chunks(q, cfg).to(torch.int16)


def measure_step_ms(dev, steps: int = TIMED_STEPS, warmup: int = WARMUP_STEPS) -> float:
    """Mean time of a bench step on the card (CUDA events around
    ``steps`` steps after ``warmup``): bf16, the int16 bank kernel."""
    import torch

    from .. import train
    from ..config import DEFAULT as cfg
    from ..models import get_model
    from ..ops import stft

    model = get_model(MODEL_TYPE, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, cfg, device=dev)
    bank = _int16_bank(torch, cfg, dev, BANK_CLIPS)
    step = train.make_train_step(
        model, state, scalar=_scalar(cfg), mixup_alpha=1.0, bank=bank,
        bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=WAVE_SCALE))
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, BANK_CLIPS, BATCH),
                (rng.random((BATCH, 17)) < 0.2).astype(np.float32))
               for _ in range(warmup + steps)]
    for idx, y in batches[:warmup]:
        step(idx, y)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for idx, y in batches[warmup:]:
        m = step(idx, y)
    stop.record()
    torch.cuda.synchronize(dev)
    if not np.isfinite(float(m["loss"])):
        raise RuntimeError(f"the bench step's loss is {float(m['loss'])}")
    return start.elapsed_time(stop) / steps


def main(argv=None, device=None) -> dict:
    """Print and return the JSON record."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--step_ms", type=float, default=None,
                   help="train-step time (ms) at batch 128; default: "
                        "measured on the card")
    p.add_argument("--peak", type=float, default=H100_BF16_PEAK,
                   help="peak FLOP/s (default: H100 SXM dense bf16)")
    args = p.parse_args(argv)

    from ..config import DEFAULT as cfg
    from ..ops import logmel_cuda

    dev = None
    if args.step_ms is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("the step is timed on the card; on the CPU "
                             "pass --step_ms")
    model_fl, _ = step_flops(COUNT_BATCH)
    model_fl = model_fl * BATCH / COUNT_BATCH
    frontend_fl = float(logmel_cuda.flops_and_bytes(
        cfg, BATCH, cfg.clip_samples)[0])
    fl = model_fl + frontend_fl
    if dev is not None:
        step_ms, info = measure_step_ms(dev), device_info(dev)
    else:
        step_ms = args.step_ms
        info = {"device": "given by --step_ms", "power_limit": None}
    sustained = fl / (step_ms / 1e3)
    rec = {
        "flops_per_step": fl,
        "gflop_per_clip": fl / BATCH / 1e9,
        "step_ms": step_ms,
        "clips_per_sec": BATCH / (step_ms / 1e3),
        "sustained_tflops": sustained / 1e12,
        "peak_tflops": args.peak / 1e12,
        "mfu": sustained / args.peak,
        "device": info["device"],
        "power_limit": info["power_limit"],
        "model_flops": model_fl,
        "frontend_flops": frontend_fl,
    }
    print(json.dumps(rec, indent=1), flush=True)
    return rec


if __name__ == "__main__":
    main()
