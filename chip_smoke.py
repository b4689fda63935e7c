#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths (``sound_event_detection_dcase2017_task4_torch``)
at the full width of ``Cnn_9layers_Gru_FrameAtt`` (channels 64-512, BiGRU 256,
17 classes, 10 s clips at 32 kHz → 1001 frames × 64 mel bins) with seeded
random weights, in phases that each raise on failure:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build the hand-written log-mel kernel (a shared-memory FFT, both
   entries) from ``ops/csrc/logmel.cu`` with nvcc; its registers and
   spills (``-Xptxas -v``) and its dynamic shared memory per block;
3. the waveform kernel against its plain PyTorch version on the card at the
   serving shape (16 clips): 0.1 dB absolute and rtol 2e-3 in the linear
   domain (the JAX package's own bound), TF32 off for both; physics probes
   (silence is exactly −100 dB, a 1 kHz tone peaks in the mel bin holding
   1 kHz, an onset after half a clip of silence stays within the bound
   with its silent frames exactly −100 dB); bad inputs raise; times of the
   kernel, the plain version and a ``torch.stft`` yardstick, against the
   function's least work (an FFT per frame: bound by bytes), with the
   kernel's share of that bound and its ratio to the yardstick;
4. the model's BiGRU at its serving shape in float32 and in bf16: each must
   run cuDNN's RNN cell; its device time and the bf16 error;
5. the serving slice: a ``Predictor`` on the card serves a 16 × 10 s
   request, then ``detect_events``, ``predict_long`` on 35 s and a
   ``StreamingDetector``; every launch counter is zeroed just before and read
   just after, the plain frontend must not run (the guard is first shown to
   see a CPU call), two clips are held against the same weights on the CPU,
   the bf16 model is held against the f32 one on the card, and latency,
   clips/s (f32 and bf16) and peak memory are measured; the bf16 model's p50
   is taken with its BiGRU in bf16 and in float32, alternated;
6. the bank kernel at the training shape: an int16 corpus bank of 512 clips
   staged with ``prepare_chunks`` and 128 sorted host indices with one
   duplicate; the int16 launch must equal the waveform kernel on the decoded
   rows bit for bit, a float32 bank of the same clips must give the same
   result, and the kernel must agree with the plain ``logmel_bank`` within
   the bound above; bad inputs raise; times of the kernel, the wrapper, the
   plain version and a gather + ``torch.stft`` yardstick, the share of the
   bound and the ratio to the yardstick;
7. the training slice: ``create_train_state`` / ``make_train_step`` /
   ``make_eval_step`` over the bank at batch 128 in bf16 (mixup α = 1,
   dropout 0.2, per-bin mean −30 / std 15) for 30 steps without a host read
   inside the loop; the bank launches are counted from zero, the plain bank
   frontend must not run (the guard is first shown to see a CPU call), the
   loss must be finite and fall; an f32 step on 2 clips is held against the
   CPU, and the bf16 first step against the f32 one; p50 step time, clips/s,
   peak memory and one step's device time by kernel are printed;
8. the CLI on the card, in a temporary workspace: ``features.main
   pack_synthetic`` (128/32/32 clips of 10 s; the waveform kernel, its
   features of 8 clips held to the plain version, the int16 waveforms read
   back bit for bit); ``main.main train`` of the flagship in bf16 at batch
   32 over the device cache for 20 steps with evals at 0, 10 and 20 (bank
   kernel launches = steps + bank eval steps, counted from zero; the plain
   frontends never run; checkpoints, sidecars and the statistics schema);
   a resume from iteration 10 in a copy of the workspace (the restored state
   equals the checkpoint, the next batch equals the uninterrupted run's);
   one f32 step from that checkpoint through the bank (B1) and host-fed
   int16 batches (B2), losses within rtol 1e-5; ``inference`` on testing and
   evaluation, ``optimize_at_thresholds``, ``optimize_sed_thresholds`` and
   ``calculate_metrics`` with a metrics JSON; ``sed_fast``'s device scorer
   against the numpy oracle's integer counts for 20 parameter sets; and
   ``Predictor.from_workspace(iteration="best")`` on a 16-clip request
   against the same checkpoint served on the CPU (1e-4). Stage wall times,
   train clips/s, eval and checkpoint times, peak memory and the launches
   of both kernels are printed;
9. the rest of the zoo, ``Cnn_9layers_Glu_AttPooling`` and
   ``Cnn_9layers_Transformer_FrameAtt`` at full width from seed 0, while
   phase 6's bank is still staged: a ``Predictor`` on the card serves
   16 × 10 s requests in f32 and bf16 (the GLU with BatchNorm statistics
   calibrated on the request; waveform kernel launches counted from zero,
   1 per request; the plain frontend never runs; the clipwise outputs
   spread by at least 1e-2 over the clips; two clips held to the CPU at
   1e-4, bf16 to f32 within ``BF16_ATOL``; p50 over 20
   requests, clips/s, peak memory); 10 bf16 steps at batch 128 over the
   bank with SpecAugment and mixup α = 1 (bank kernel launches counted,
   loss finite, p50 by CUDA events, clips/s, ``max_memory_allocated``; the
   GLU model with ``remat`` off and on; one step's device time by kernel);
   one f32 step on 2 clips, every dropout 0, held to the CPU (loss rtol
   2e-5, grad-norm 1e-4, BN statistics 1e-4) and, for GLU, remat on held to
   remat off; then ``main train`` of the Transformer with
   ``--augmentation=mixup_specaugment --remat`` (5 steps, evals at 0 and 5)
   and ``inference`` in phase 8's workspace;
10. ``runme.sh`` stages 1 and 4 (``runme_torch.sh``) at the DEFAULT config:
   ``pack_synthetic`` writes 128/32/32 WAVs of 10 s; the threaded C++ decoder
   (``csrc/sedx_native.cc``, built with g++) is built, and
   ``calculate_feature_for_all_audio_files`` packs each split on the card
   through it and with ``--no_native`` (the Python loader), then
   ``calculate_scalar``: names and targets equal ``pack_synthetic``'s, the
   int16 rows equal the WAVs' PCM bit for bit, both decoders pack the same
   bits, one batch's features are within the bound above of the plain CPU
   frontend on the same decoded rows, the waveform kernel launches
   ⌈clips/32⌉ times a split and the plain frontend never; each split's wall
   time and clips/s for both decoders, with the time of decoding alone, and
   the host's share of one split's pack under the profiler; the testing
   split rewritten at 44.1 kHz packs through both resamplers within 1 LSB
   and 0.1 dB; then ``plot_results --table`` and ``runme.sh``'s plot on the
   workspace of phases 8 and 9;
11. data parallel (``parallel``) under a 1-rank NCCL group on ``cuda:0``
   over a ``FileStore`` (the card's machine has one card; N-rank equality
   is held on the CPU by ``tests/test_torch_parallel.py``), while phase 6's
   bank is still staged: 10 f32 steps of the flagship at batch 128 (mixup
   α = 1, dropout 0.2, TF32 off, cuDNN deterministic) through the
   data-parallel step against the same 10 steps with no group, at the
   train-step tolerances, every all-reduce counted (17 a step: each of the
   8 BatchNorm layers forward and backward, and the gradients); 10 bf16
   steps of the data-parallel step as the main path (bank kernel launches
   counted from zero, the plain frontend never), then the bare step and the
   two again alternated: each one's p50 by CUDA events, their ratio and
   peak memory; a ragged eval (16 + 13 clips) through the data-parallel
   ``forward_generator`` against the plain one (1e-5); ``main train`` under
   the group in phase 8's workspace, host-fed (the waveform kernel), 10 bf16
   steps with SpecAugment and mixup, evals and checkpoints at 0 and 10; the
   written ``.pth`` loaded in a subprocess with no group equals the run's
   state bit for bit and serves through ``Predictor.from_workspace``. A
   failed NCCL init or collective fails the phase; nothing falls back.
12. the tools and examples (``tools/``, ``examples/`` of the port's
   package), each through its ``main`` on the card at a reduced size:
   ``sed_search_bench`` at 488 × 1001 × 17 along both paths (the same
   optimum, the round trips counted); ``mfu`` (its FLOPs counted on the
   CPU, the bf16 bench step over an int16 bank timed by CUDA events);
   ``coldstart_probe``'s four fresh processes; ``scale_soak`` on a packed
   256/64/64-clip workspace for 20 lazy host-fed steps; ``hard_benchmark
   matrix`` on the flagship, one seed and the ``no_normalization`` control
   at 20 steps over a 64/488/488-clip hard corpus (the waveform kernel
   packs the log-mel features; its children, with the JAX tool's argv,
   train and score on them and launch no kernel); ``parity_check`` in dry
   mode; ``minimal_train`` (30 steps) and ``streaming_live`` on the hard
   matrix's workspace. The tools that run the CLI run it in child
   processes, each of which prints its kernel counters and its calls of
   the plain frontends on its last line; every child's and every
   in-process run's launches are held to what it did (steps, eval batches,
   ⌈clips/32⌉ batches of inference, or non-zero where the count depends on
   the data), and the plain frontend runs nowhere but in
   ``coldstart_probe``'s plain cells.
13. the root entry points (``graft_entry``, the counterpart of
   ``__graft_entry__.py``): ``entry()`` on the card (the full-width flagship
   on 4 × 2 s clips, seed 0) through the waveform kernel, its launches
   counted from zero (1; the plain frontend never runs); the same forward
   held to ``entry(device="cpu")`` on the card's parameters at 1e-4 (TF32
   off) on the example zeros and a seeded waveform; the waveform kernel's
   own output held to the plain frontend at the shapes this phase gives
   it (entry's seeded [4, 64000], the dry run's [2, 16000] and [1, 16000]),
   0.1 dB absolute and rtol 2e-3 in the linear domain: the model's outputs
   alone would not show a frontend that is off by a fraction of a dB; its
   p50 over 20 calls by CUDA events; then
   ``dryrun_multichip(torch.cuda.device_count())``,
   one spawned rank a card under NCCL (one on this machine: N > 1 is held
   on the CPU by ``tests/test_torch_graft_entry.py``), each rank holding
   the data-parallel step to the step with no mesh at the JAX file's
   tolerances and reporting its waveform kernel launches (3: two steps and
   the ragged eval).
14. (run right after phase 8, on its corpus) a run the JAX package
   trained, resumed on the card: the script writes the JAX package's
   ``7_iterations.ckpt`` of the full-width flagship itself (the card's
   machine has no JAX: its own flax-msgpack writer and the inverse of the
   port's weight plan, ``msgpack_pack``/``flax_tree``/``jax_ckpt_bytes``;
   seeded weights, BatchNorm statistics and Adam moments, the GRU's r/z
   moments zero, the ``opt_state`` of warmup 20 and clip 1.0), its
   ``.optjson`` and a ``.datastate.pkl`` two batches ahead, as a JAX run's
   prefetch thread leaves it, in a fresh workspace; then ``main train
   --resume_iteration=7`` in bf16 at batch 32 over the device cache for 3
   steps (bank kernel launches counted from zero, the plain frontends
   never) and ``inference`` on its last checkpoint (1 waveform launch).
   After the import every variable, moment and count equals the tree
   written bit for bit and the learning rate is 7/20 of 1e-3; the resumed
   batches equal those of a generator loaded from the same
   ``.datastate.pkl``; the bank kernel on the first resumed batch and the
   waveform kernel on the inference batch are held to their plain
   versions (0.1 dB, rtol 2e-3); the first resumed step in f32 (TF32 off,
   dropout 0, mixup λ from the key-seeded generator, 4 clips) is held card
   against CPU at the train-step tolerances. It prints the import's
   seconds and each resumed step's time.
15. (run after phase 4) the train-mode BatchNorm kernels (``ops.bn_act``,
   ``csrc/bn_act.cu``): their build and registers; at every conv-stack
   block's shape of the crnn and the glu (batch 128, planes 1001×64,
   500×32, 250×16, 125×8), each epilogue and both layouts (the NCHW
   kernels, HTS-AT's ``bn0``'s, and the channels-last ones, the conv
   stack's), bf16, the kernels against the plain versions with the ``a``,
   ``b`` and sums' gradient a step gives (``bn_act.sums_grad``): ``y``,
   the forward and backward sums (repeated bit for bit), and ``dx`` region
   by region (``bn_act.grad_x_mismatch``: where ``g`` may be non-zero,
   where ReLU's mask zeroes it, the rows and columns the pool drops); then
   at the same shapes, epilogues and layouts each kernel's time alone
   (CUDA events over back-to-back calls; K1 the sums, K2 the apply, K3 the
   backward's sums, K4 ``dx``) and their sum against the function's least
   bytes at 3.35 TB/s, and at block 1's shape ``[128, 64, 1001, 64]`` the
   profiler's time of the kernels named ``sedx_bn_`` and the stock
   composite's forward and backward (NCHW) beside the fused path's through
   ``BatchNorm`` in each layout; last the host µs a call of each wrapper and of a
   ``BatchNorm`` call on each path at ``[8, 64, 16, 16]``. It prints the
   ``bn_act`` JSON line.
16. (run after phase 15) HTS-AT's window-attention kernels
   (``ops.window_attention``, ``csrc/window_attention.cu``): their build
   and registers; at each of HTS-AT's four stage shapes at batch 128 in
   bf16 (windows of 64 tokens, heads of 24; 4/8/16/32 heads, 64/16/4/1
   windows a clip; the shifted variant where the stage shifts), ``o``,
   ``dq``, ``dk``, ``dv`` and the table's gradient against float64
   (``window_attention.mismatch``, 2⁻⁷ of each element's magnitude), the
   backward repeated bit for bit; then each stage's forward and backward
   alone by CUDA events, beside the plain version and, as the yardstick
   only, ``scaled_dot_product_attention`` with the bias and mask as a float
   mask (the port never calls it), and a step's sum over HTS-AT's 12
   blocks against the function's least bytes (11 tensors: ``P`` is
   recomputed and ``o`` not read back) and, beside it, the 12 that
   ``benchmark/counts/htsat.py`` counts; a float32 case against float64
   beside the plain version (the kernels' ``__expf`` and reciprocal
   against ``torch.softmax``); last HTS-AT at the published widths in bf16
   through ``train.make_train_step`` at batch 128, host-fed, counters
   zeroed before each reading: 48 kernel launches a step, capturing the
   CUDA graphs and replaying them, 60 under ``remat`` and 12 an eval
   forward. It prints the ``window_attention`` JSON line.
17. (run after phase 16) Audio Mamba's selective-scan kernels
   (``ops.selective_scan``, ``csrc/selective_scan.cu``): their build and
   registers; at the cell's shape ``[128, 253, 1536]`` in bf16, both
   directions, the forward and backward kernels and the plain version on
   the same inputs, each against the function in float64
   (``selective_scan.mismatch``, the yardstick and the plain version in
   blocks of 16 rows: ``selective_scan.plain_grads``): the kernels' gap at
   most twice the plain version's, or 1e-5, on the output and every
   gradient, the backward repeated bit for bit, 3 launches; each kernel's
   time by CUDA events and the plain version's, against the function's
   least bytes a block from ``benchmark/counts/aum.py:scan_bytes`` at 3.35
   TB/s; last AuM-B at the published widths in bf16 through
   ``train.make_train_step`` at batch 128, host-fed, counters zeroed
   before each reading: 48 launches a step capturing the CUDA graphs, 48
   replaying them, 24 an eval forward, no plain call.

It prints the ``kernels`` JSON line (``launches`` of phases 5 and 7,
``launches_cli`` of phase 8, ``launches_zoo`` of phase 9, ``launches_runme``
of phase 10, ``launches_parallel`` of phase 11, ``launches_tools`` of phase
12, ``launches_entry`` of phase 13, ``launches_resume`` of phase 14; a
``window_attention`` entry with phase 16's launches on HTS-AT's path; a
``selective_scan`` entry with phase 17's checks, times, ``bound_ms`` and
launches on AuM-B's path; and a
``bn_act`` entry with the ``ops.bn_act`` counters of each phase after 15
(``channels_last_calls`` among them: 8 a crnn step, 16 a GLU step),
its tools' children included, which fails the run if a train-mode
``BatchNorm`` call on the card took the composite or a training phase ran
no kernel), then as its last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when no CUDA device is available or any phase fails. It imports nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
BATCH = 16
# the training cell: the JAX package's bench step (bench.py:84-126)
MODEL = "Cnn_9layers_Gru_FrameAtt"
BANK_CLIPS = 512
TRAIN_BATCH = 128
TRAIN_STEPS = 30
EVAL_BATCH = 16
# bf16 compute (params f32, f32 accumulation) against f32, on probabilities:
# bf16's 8-bit mantissa gives ~0.4% relative error per rounding, and a few
# percent of a logit moves a sigmoid by well under 0.05.
BF16_ATOL = 0.05
# bf16 against f32 on the first step's loss (a mean of 128 × 17 BCE terms,
# ≈ 0.69 at init): probabilities within BF16_ATOL move it by far less; this
# checks that the bf16 training path runs, not its worst error.
BF16_LOSS_ATOL = 0.01


def _cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profiled_kernel_ms(torch, fn, name, iters=10):
    """Device time per call of the kernels whose name holds ``name``, from
    torch.profiler; ``None`` if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / iters / 1e3 if total_us > 0 else None


def _p50_latency(pred, wave, reps=20):
    """p50 host time of ``pred(wave)`` over ``reps`` calls after 3 warm-ups
    (each call ends in a device→host copy, which synchronises)."""
    for _ in range(3):
        pred(wave)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred(wave)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


class _PlainGuard:
    """Counts calls of ``stft``'s plain frontends while in the ``with``
    body; shown first to see a CPU call of each."""

    def __init__(self, torch, cfg):
        from sound_event_detection_dcase2017_task4_torch.ops import stft

        self.stft, self.cfg, self.torch = stft, cfg, torch
        self.plain = {k: getattr(stft, k) for k in ("logmel", "logmel_bank")}
        self.calls = dict.fromkeys(self.plain, 0)

    def _counting(self, name):
        def fn(*a, **k):
            self.calls[name] += 1
            return self.plain[name](*a, **k)
        return fn

    def __enter__(self):
        stft, cfg, torch = self.stft, self.cfg, self.torch
        for k in self.plain:
            setattr(stft, k, self._counting(k))
        n_rows = stft._geometry(cfg, cfg.clip_samples)[-1]
        stft.make_logmel_fn(cfg)(torch.zeros(1, cfg.clip_samples))
        stft.make_logmel_bank_fn(cfg, wave_scale=2.0 ** -15)(
            torch.zeros((1, n_rows, cfg.hop_size), dtype=torch.int16), [0])
        if not min(self.calls.values()) >= 1:
            raise AssertionError(f"the plain-frontend guard missed a CPU call: "
                                 f"{self.calls}")
        self.calls.update(logmel=0, logmel_bank=0)
        return self

    def __exit__(self, *exc):
        for k, fn in self.plain.items():
            setattr(self.stft, k, fn)
        return False


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"[device] torch: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    return name, card


def phase_build(logmel_cuda, cfg):
    t0 = time.perf_counter()
    lib = logmel_cuda.LIBRARY.load()
    secs = time.perf_counter() - t0
    print(f"[build] ops/csrc/logmel.cu for sm_90a in {secs:.2f} s")
    for line in (logmel_cuda.LIBRARY.log or "").splitlines():
        if any(s in line for s in ("registers", "spill", "error", "smem")):
            print(f"[build] {line.strip()}")
    # dynamic shared memory is not in ptxas's report: the library's layout
    # and the wrapper's copy of it must agree
    sizes = logmel_cuda._launch_sizes(logmel_cuda.plan(cfg), cfg)
    smem = lib.sedx_logmel_shared_bytes(*sizes)
    if smem != logmel_cuda.shared_bytes(cfg):
        raise AssertionError(f"shared memory per block: library {smem}, "
                             f"wrapper {logmel_cuda.shared_bytes(cfg)}")
    per_sm = [lib.sedx_logmel_blocks_per_sm(*sizes, b) for b in (4, 2)]
    if min(per_sm) < 1:
        raise AssertionError(f"blocks per SM (float, int16): {per_sm}")
    print(f"[build] dynamic shared memory per block at the DCASE config: "
          f"{smem} bytes ({logmel_cuda.FRAMES_PER_BLOCK} frames, "
          f"{logmel_cuda.FRAMES_IN_FLIGHT * logmel_cuda.THREADS_PER_FRAME} "
          f"threads; FFT radices {logmel_cuda.plan(cfg).factors}); blocks "
          f"per SM (float, int16): {per_sm[0]}, {per_sm[1]}")
    return secs


def _bound(flops, nbytes):
    """``(bound_ms, bound_by)`` at the published H100 peaks."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _shares(kernel_ms, wrapper_ms, bound_ms, library_ms):
    """The kernel's share of its bound (``bound_ms / kernel_ms``) and its
    time over the ``torch.stft`` yardstick's, from the profiler's kernel
    time (the wrapper's CUDA-event time when the profiler saw none)."""
    t, what = ((kernel_ms, "kernel alone") if kernel_ms is not None
               else (wrapper_ms, "wrapper"))
    return (f"{what} at {100 * bound_ms / t:.2f}% of the bound, "
            f"{t / library_ms:.4f}x the yardstick's time")


def phase_kernel(torch, sedt, card):
    from sound_event_detection_dcase2017_task4_torch.ops import (
        dsp, logmel_cuda, stft)

    cfg = sedt.config.DEFAULT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[kernel] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    rng = np.random.default_rng(0)
    t = np.arange(cfg.clip_samples) / cfg.sample_rate
    wave = 0.05 * rng.standard_normal((BATCH, cfg.clip_samples))
    for i in range(BATCH):                       # a tone per clip
        wave[i] += 0.3 * np.sin(2 * np.pi * (200.0 + 600.0 * i) * t)
    x = torch.from_numpy(wave.astype(np.float32)).cuda()

    got = logmel_cuda.logmel_cuda(x, cfg)
    want = stft.logmel(x, cfg)
    torch.cuda.synchronize()
    if got.shape != (BATCH, cfg.frames_num, cfg.mel_bins):
        raise AssertionError(f"kernel output shape {tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err_db = float((got - want).abs().max())
    lin_g, lin_w = 10.0 ** (got.double() / 10.0), 10.0 ** (want.double() / 10.0)
    lin_ok = bool(((lin_g - lin_w).abs() <= 1e-10 + 2e-3 * lin_w.abs()).all())
    lin_rel = float(((lin_g - lin_w).abs() / lin_w.abs().clamp(min=1e-10)).max())
    print(f"[kernel] vs plain version: max |Δ| {err_db:.3e} dB (limit 0.1), "
          f"max linear rel err {lin_rel:.3e} (limit 2e-3)")
    # both float32 versions against one computed in float64 (torch.stft of
    # the same samples, float64 window and mel bank): which rounds less
    x64 = x.double()
    spec = torch.stft(x64, cfg.window_size, cfg.hop_size,
                      window=torch.from_numpy(dsp.hann_window(
                          cfg.window_size, dtype=np.float64)).cuda(),
                      center=True, pad_mode=cfg.pad_mode, return_complex=True)
    mel64 = (spec.abs() ** 2).transpose(1, 2) @ torch.from_numpy(
        dsp.mel_filterbank(cfg.sample_rate, cfg.window_size, cfg.mel_bins,
                           cfg.fmin, cfg.fmax, dtype=np.float64)).cuda()
    ref64 = 10.0 * torch.log10(mel64.clamp(min=cfg.log_amin))
    print("[kernel] vs a float64 reference: max |Δ| kernel "
          f"{float((got.double() - ref64).abs().max()):.3e} dB, plain float32 "
          f"version {float((want.double() - ref64).abs().max()):.3e} dB")
    del x64, spec, mel64, ref64
    if not err_db <= 0.1 or not lin_ok:
        raise AssertionError("kernel disagrees with the plain version")

    # physics probes
    silence = logmel_cuda.logmel_cuda(
        torch.zeros(2, cfg.clip_samples, device="cuda"), cfg)
    if not bool((silence == -100.0).all()):
        raise AssertionError(f"silence is not exactly -100 dB: "
                             f"[{float(silence.min())}, {float(silence.max())}]")
    tone = torch.from_numpy(
        (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)[None]).cuda()
    peak = int(logmel_cuda.logmel_cuda(tone, cfg).mean(dim=1).argmax())
    mel_w = dsp.mel_filterbank(cfg.sample_rate, cfg.window_size, cfg.mel_bins,
                               cfg.fmin, cfg.fmax)
    k1k = int(round(1000.0 * cfg.window_size / cfg.sample_rate))
    if peak != int(np.argmax(mel_w[k1k])):
        raise AssertionError(f"1 kHz tone peaks in mel bin {peak}, expected "
                             f"{int(np.argmax(mel_w[k1k]))}")
    print(f"[kernel] silence = -100.0 dB exactly; 1 kHz tone peaks in mel bin {peak}")
    # an onset after silence: half a clip of zeros, then noise. The frames
    # wholly inside the silence must be exactly the floor, and the rest
    # within the bound of the plain version (each frame is its own FFT)
    half = cfg.clip_samples // 2
    onset = np.zeros((2, cfg.clip_samples), np.float32)
    onset[:, half:] = 0.1 * rng.standard_normal((2, cfg.clip_samples - half))
    onset = torch.from_numpy(onset).cuda()
    got_on = logmel_cuda.logmel_cuda(onset, cfg)
    want_on = stft.logmel(onset, cfg)
    silent = (half - cfg.window_size // 2) // cfg.hop_size
    err_on = float((got_on - want_on).abs().max())
    lin_g, lin_w = (10.0 ** (got_on.double() / 10.0),
                    10.0 ** (want_on.double() / 10.0))
    if not (bool((got_on[:, :silent] == -100.0).all()) and err_on <= 0.1
            and bool(((lin_g - lin_w).abs()
                      <= 1e-10 + 2e-3 * lin_w.abs()).all())):
        raise AssertionError(f"onset after silence: max |Δ| {err_on} dB, "
                             f"silent frames in [{float(got_on[:, :silent].min())}"
                             f", {float(got_on[:, :silent].max())}] dB")
    print(f"[kernel] onset after silence: frames 0-{silent - 1} exactly -100.0 "
          f"dB; max |Δ| vs plain {err_on:.3e} dB (limit 0.1), linear within "
          "rtol 2e-3")
    for bad, what in ((x.double(), "float64"),
                      (torch.empty(cfg.clip_samples, 2, device="cuda").t(),
                       "non-contiguous")):
        try:
            logmel_cuda.logmel_cuda(bad, cfg)
        except (TypeError, ValueError) as e:
            print(f"[kernel] {what} input raises: {type(e).__name__}")
        else:
            raise AssertionError(f"{what} input did not raise")

    # times at the serving shape
    n_fft = cfg.window_size
    hann = torch.hann_window(n_fft, periodic=True, device="cuda")
    mel_full = torch.from_numpy(mel_w).cuda()

    def library():
        spec = torch.stft(x, n_fft, cfg.hop_size, window=hann, center=True,
                          pad_mode=cfg.pad_mode, return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2              # [B, F, T]
        mel = power.transpose(1, 2) @ mel_full
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.log_amin))

    lib_err = float((library() - want).abs().max())
    ms = _cuda_ms(torch, lambda: logmel_cuda.logmel_cuda(x, cfg))
    plain_ms = _cuda_ms(torch, lambda: stft.logmel(x, cfg))
    library_ms = _cuda_ms(torch, library)
    ms_2 = _cuda_ms(torch, lambda: logmel_cuda.logmel_cuda(x, cfg))
    kernel_ms = _profiled_kernel_ms(
        torch, lambda: logmel_cuda.logmel_cuda(x, cfg), "logmel_kernel")
    flops, nbytes = logmel_cuda.flops_and_bytes(cfg, BATCH, cfg.clip_samples)
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"[kernel] B={BATCH}: wrapper (pad + kernel) {ms:.4f} / {ms_2:.4f} ms, "
          f"kernel alone (profiler) "
          f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'}, "
          f"plain {plain_ms:.4f} ms, torch.stft yardstick {library_ms:.4f} ms "
          f"(max |Δ| {lib_err:.3e} dB); bound of the function {bound_ms:.4f} ms "
          f"by {bound_by} (FFT count {flops / 1e9:.4f} GFLOP at 67 TFLOP/s "
          f"f32 = {flops / PEAK_F32_FLOPS * 1e3:.4f} ms, {nbytes / 1e6:.3f} MB "
          f"at 3.35 TB/s = {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms); "
          f"{_shares(kernel_ms, ms, bound_ms, library_ms)} [{card}]")
    return {"name": "logmel", "route": "cuda",
            "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/logmel.cu",
            "replaces": "sound_event_detection_dcase2017_task4_tpu/ops/"
                        "pallas_logmel.py:208 (logmel_pallas)",
            "launches": None, "max_abs_err": err_db, "ms": ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _device_kernels(torch, fn, by_op=False):
    """``(wall_ms, [(ms, count, name), ...])``: the device kernels and copies
    of one call of ``fn`` under torch.profiler, heaviest first, and the
    call's wall time under the profiler (after one call outside it). With
    ``by_op`` the rows are the PyTorch operators instead, each with the
    device time of the kernels it launched itself."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    side = torch.autograd.DeviceType.CPU if by_op else torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        # one side only: an operator and the kernels it launched report the
        # same device time
        if ev.device_type != side or ev.key.startswith("Activity Buffer"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev / 1e3, ev.count, ev.key))
    return wall_ms, sorted(rows, reverse=True)


def phase_gru(torch, card):
    """The flagship's BiGRU (512 → 2×256) at its serving shape, 16 clips ×
    62 pooled frames, in float32 and in bf16 (f32 parameters cast at use,
    as the bf16 model runs it). Each must run cuDNN's RNN cell kernel;
    prints that kernel, the launches and device time per call, the time per
    call by CUDA events, and the bf16 output's error against float32."""
    from sound_event_detection_dcase2017_task4_torch.models.zoo import BiGRU

    gru = BiGRU(512, 256)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    gru.cuda()
    x = torch.randn(BATCH, 62, 512, generator=torch.Generator().manual_seed(1))
    x = x.cuda()
    with torch.inference_mode():
        err = float((gru(x.to(torch.bfloat16)).float() - gru(x)).abs().max())
        for tag, inp in (("f32", x), ("bf16", x.to(torch.bfloat16))):
            _, rows = _device_kernels(torch, lambda: gru(inp))
            cells = [k for _, _, k in rows if "RNNcell" in k]
            if not cells:
                raise AssertionError(f"the {tag} BiGRU ran no cuDNN RNN cell")
            ms = _cuda_ms(torch, lambda: gru(inp))
            print(f"[gru] {tag}: cuDNN cell {cells[0][:60]}...; "
                  f"{sum(r[1] for r in rows)} launches, device time "
                  f"{sum(r[0] for r in rows):.4f} ms (profiler); {ms:.4f} ms "
                  f"per call (CUDA events) [{card}]")
    print(f"[gru] bf16 vs f32 output: max |Δ| {err:.3e}")


BN_BLOCKS = [(128, 64, 1001, 64), (128, 128, 500, 32), (128, 256, 250, 16),
             (128, 512, 125, 8)]      # the crnn's and the glu's conv outputs
BN_LAYOUTS = ("nchw", "nhwc")         # the kernels' two: bn0's, the stack's


def _bn_case(torch, shape, act, dev, seed, layout="nchw"):
    """``x``, ``dy`` (bf16, in ``layout``: ``"nchw"`` or ``"nhwc"``, the
    channels-last one) and the ``a``, ``b``, ``gs`` a step gives them
    (``bn_act.sums_grad``: batch statistics, the sums' gradient)."""
    from sound_event_detection_dcase2017_task4_torch.ops import bn_act

    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, t, f = shape
    x = (torch.randn(shape, generator=g, device=dev)
         * (0.5 + torch.rand(1, c, 1, 1, generator=g, device=dev))
         + 0.3 * torch.randn(1, c, 1, 1, generator=g, device=dev)).to(torch.bfloat16)
    weight = 0.5 + torch.rand(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    oshape = (b, c, t // 2, f // 2) if act == "relu_pool" else shape
    dy = torch.randn(oshape, generator=g, device=dev).to(torch.bfloat16)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    return (x, dy) + bn_act.sums_grad(x, dy, weight, bias, act)


def _host_us(torch, fn, n=2000):
    """Host µs a call of ``fn``: ``n`` calls back to back, timed until the
    last returns (small shapes, so that the device keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / n * 1e6


def phase_bn_act(torch, card):
    """Phase 15 (see the module docstring): returns the ``bn_act`` line."""
    from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm
    from sound_event_detection_dcase2017_task4_torch.ops import bn_act

    t0 = time.perf_counter()
    bn_act.LIBRARY.load()
    log = bn_act.LIBRARY.log or ""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) > 0 for n in re.findall(r"(\d+) bytes spill stores", log))
    print(f"[bn_act] ops/csrc/bn_act.cu for sm_90a in {time.perf_counter() - t0:.2f} s; "
          f"{len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
          f"{spills} with spills")
    dev = torch.device("cuda")
    out = {"dtype": "bfloat16", "card": card, "checks": {}}

    # the kernels against the plain versions at every block's shape, in both
    # layouts, with a step's gradient of the sums: y and the sums as a whole,
    # dx region by region (where g is 0 at c1 + c2·x's own scale), away from
    # ReLU's kink
    for shape, act, layout in itertools.product(BN_BLOCKS, bn_act.ACTS, BN_LAYOUTS):
        x, dy, a, b, gs = _bn_case(torch, shape, act, dev, 0, layout)
        y1, y0 = bn_act.apply_cuda(x, a, b, act), bn_act.apply_plain(x, a, b, act)
        keep = ((bn_act._z(x, a, b).abs() > 1e-3) | (act == "none")
                if act != "relu_pool" else torch.ones_like(y1, dtype=torch.bool))
        y_err = float(((y1.float() - y0.float()).abs()
                       / (y0.float().abs() + 1e-3))[keep].max())
        del y1, y0, keep
        # the sums within a share of each channel's sum of magnitudes
        g = bn_act._grad_z(dy, x, a, b, act)
        mag = torch.cat([g.abs().sum((0, 2, 3)), (g * x).abs().sum((0, 2, 3))])
        del g
        s0 = bn_act.stats_plain(x)
        g0 = bn_act.grad_stats_plain(dy, x, a, b, act)
        s1, g1 = bn_act.stats_cuda(x), bn_act.grad_stats_cuda(dy, x, a, b, act)
        if not (torch.equal(bn_act.stats_cuda(x), s1)
                and torch.equal(bn_act.grad_stats_cuda(dy, x, a, b, act), g1)):
            raise AssertionError(f"bn_act {shape} {act} {layout}: the sums do not "
                                 "repeat bit for bit")
        sums_err = max(
            float(((s1 - s0).abs()
                   / bn_act.stats_plain(x.abs()).clamp(min=1)).max()),
            float(((g1 - g0).abs() / mag.clamp(min=1e-30)).max()))
        regions = bn_act.grad_x_mismatch(bn_act.grad_x_cuda(dy, x, a, b, gs, act),
                                         dy, x, a, b, gs, act, 2 ** -7)
        want = {"g"} | ({"masked"} if act != "none" else set()) | (
            {"dropped"} if act == "relu_pool" and shape[2] % 2 else set())
        tag = f"{shape[2]}x{shape[3]}x{shape[1]}-{act}-{layout}"
        out["checks"][tag] = {"y": y_err, "sums": sums_err, "dx": regions}
        if (y_err > 2 ** -7 or sums_err > 1e-5
                or {k for k, (_, n) in regions.items() if n} != want
                or any(w > 1 for w, _ in regions.values())):
            raise AssertionError(f"bn_act {tag} disagrees with its plain version: "
                                 f"{out['checks'][tag]}")
        print(f"[bn_act] {tag} bf16 batch 128 against plain: y {y_err:.2e}, sums "
              f"{sums_err:.2e}, dx by region (worst / limit, elements) "
              + ", ".join(f"{k} {w:.3f} ({n})" for k, (w, n) in regions.items()))
        del x, dy, s0, g0, s1, g1, mag

    # each kernel alone at every block's shape in both layouts, and at block
    # 1's the layer through BatchNorm
    out["shapes"] = [list(s) for s in BN_BLOCKS]
    out["timing"] = {}
    for shape, act, layout in itertools.product(BN_BLOCKS, bn_act.ACTS, BN_LAYOUTS):
        x, dy, a, b, gs = _bn_case(torch, shape, act, dev, 1, layout)
        calls = {"K1": lambda: bn_act.stats_cuda(x),
                 "K2": lambda: bn_act.apply_cuda(x, a, b, act),
                 "K3": lambda: bn_act.grad_stats_cuda(dy, x, a, b, act),
                 "K4": lambda: bn_act.grad_x_cuda(dy, x, a, b, gs, act)}
        # CUDA events around back-to-back calls; the profiler's time of the
        # kernels beside them at block 1, for reference only: late in this
        # long process it has dropped kernels (a K4 read at 3.9 TB/s)
        kernels = {k: _cuda_ms(torch, fn) for k, fn in calls.items()}
        first = shape == BN_BLOCKS[0]
        profiled = ({k: _profiled_kernel_ms(torch, fn, "sedx_bn_")
                     for k, fn in calls.items()} if first else {})
        fwd_b, bwd_b = bn_act.least_bytes(shape, 2, act)
        bound_ms = (fwd_b + bwd_b) / PEAK_BYTES_PER_S * 1e3
        total = sum(kernels.values())
        tag = f"{shape[2]}x{shape[3]}x{shape[1]}-{act}-{layout}"
        if bound_ms > 1.05 * total:
            raise AssertionError(f"bn_act {tag}: {total} ms is under the HBM "
                                 f"bound {bound_ms} ms")
        entry = {"kernels_ms": kernels, "total_ms": total, "bound_ms": bound_ms,
                 "roofline_pct": 100 * bound_ms / total}
        line = (f"[bn_act] {tag} {list(shape)} bf16 alone (CUDA events): "
                + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items())
                + f"; sum {total:.4f} ms, bound {bound_ms:.4f} ms "
                f"({(fwd_b + bwd_b) / 1e9:.3f} GB), {100 * bound_ms / total:.2f}% of it")
        if first:
            # the layer through BatchNorm: the composite's passes (NCHW) and
            # the fused ones
            bn = BatchNorm(shape[1], dtype=torch.bfloat16).to(dev)
            xr = x.detach().clone().requires_grad_(True)
            layer = {}
            for fused in ((False, True) if layout == "nchw" else (True,)):
                def fwd():
                    return bn._forward(xr, True, None, act, fused)

                def both():
                    y = fwd()
                    xr.grad = None
                    y.backward(torch.ones_like(y))

                f_ms = _cuda_ms(torch, fwd, iters=5)
                layer["fused" if fused else "stock"] = (
                    f_ms, _cuda_ms(torch, both, iters=5) - f_ms)
            entry.update(profiled_ms=profiled, layer_fwd_bwd_ms=layer)
            line += ("; profiler " + ", ".join(f"{k} {v or 0:.4f}" for k, v in profiled.items())
                     + "; through BatchNorm fwd/bwd ms: " + ", ".join(
                         f"{k} {f:.4f} / {b_:.4f}" for k, (f, b_) in layer.items()))
            del xr, bn
        out["timing"][tag] = entry
        print(f"{line} [{card}]")
        del x, dy

    # host cost: µs a call of each wrapper, and of a BatchNorm call forward
    # and forward + backward on each path, at a shape the device keeps up with
    small = (8, 64, 16, 16)
    host = {}
    for act in bn_act.ACTS:
        x, dy, a, b, gs = _bn_case(torch, small, act, dev, 2)
        host[act] = {"K1": _host_us(torch, lambda: bn_act.stats_cuda(x)),
                     "K2": _host_us(torch, lambda: bn_act.apply_cuda(x, a, b, act)),
                     "K3": _host_us(torch, lambda: bn_act.grad_stats_cuda(dy, x, a, b, act)),
                     "K4": _host_us(torch, lambda: bn_act.grad_x_cuda(dy, x, a, b, gs, act))}
        bn = BatchNorm(small[1], dtype=torch.bfloat16).to(dev)
        xr = x.detach().clone().requires_grad_(True)
        for fused in (False, True):
            def both():
                y = bn._forward(xr, True, None, act, fused)
                y.backward(torch.ones_like(y))

            side = "fused" if fused else "stock"
            host[act][side] = (
                _host_us(torch, lambda: bn._forward(xr, True, None, act, fused), 500),
                _host_us(torch, both, 500))
        print(f"[bn_act] host µs a call, {act} {list(small)}: "
              + ", ".join(f"{k} {host[act][k]:.1f}" for k in ("K1", "K2", "K3", "K4"))
              + f"; a BatchNorm call fwd / fwd+bwd: stock {host[act]['stock'][0]:.1f} / "
              f"{host[act]['stock'][1]:.1f}, fused {host[act]['fused'][0]:.1f} / "
              f"{host[act]['fused'][1]:.1f} [{card}]")
        del x, dy, xr, bn
    out["host_us"] = host
    print(json.dumps({"bn_act": out}))
    return out


# HTS-AT's stages at the published widths: (heads, windows a clip, blocks,
# shifted blocks); windows of 8 × 8 tokens, heads of 24
WA_STAGES = ((4, 64, 2, 1), (8, 16, 2, 1), (16, 4, 6, 3), (32, 1, 2, 0))


def _wa_case(torch, heads, nw, shifted, dev, seed, dtype=None):
    """q, k, v as views of a ``qkv`` output, a bias table, the rel index,
    the mask (or None), dO and the scale, at batch ``TRAIN_BATCH``, in
    ``dtype`` (bf16 when None)."""
    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    w, n, d = TRAIN_BATCH * nw, 64, 24
    c = heads * d
    qkv = torch.randn(w, n, 3 * c, generator=g, device=dev).to(dtype)
    q, k, v = qkv.view(w, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    table = 0.5 * torch.randn(225, heads, generator=g, device=dev)
    mask = wa.shift_mask(8 * int(round(nw ** 0.5)), 8, 4).to(dev) if shifted else None
    do = torch.randn(w, n, c, generator=g, device=dev).to(dtype)
    return q, k, v, table, wa.relative_index(8).to(dev), mask, d ** -0.5, do


def phase_window_attention(torch, card):
    """Phase 16 (see the module docstring): returns the
    ``window_attention`` line."""
    import torch.nn.functional as F

    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    wa.LIBRARY.load()
    log = wa.LIBRARY.log or ""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) > 0 for n in re.findall(r"(\d+) bytes spill stores", log))
    print(f"[window_attention] ops/csrc/window_attention.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s; {len(regs)} kernels, registers "
          f"{min(regs, default=0)}-{max(regs, default=0)}, {spills} with spills")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[window_attention] ptxas {line.strip()}")
    dev = torch.device("cuda")
    out = {"dtype": "bfloat16", "batch": TRAIN_BATCH, "card": card, "checks": {},
           "stages": {}}
    _zero_launches()
    for heads, nw, _, shifts in WA_STAGES:
        for shifted in sorted({False, bool(shifts)}):
            q, k, v, table, index, mask, scale, do = _wa_case(torch, heads, nw, shifted,
                                                              dev, 0)
            o = wa.forward_cuda(q, k, v, table, index, mask, scale)
            grads = wa.backward_cuda(q, k, v, table, index, mask, scale, do)
            worst = wa.mismatch((o, *grads), q, k, v, table, index, mask, scale, do,
                                2 ** -7, 2 ** -12)
            again = wa.backward_cuda(q, k, v, table, index, mask, scale, do)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            tag = f"h{heads}-nw{nw}-{'shifted' if shifted else 'plain'}"
            out["checks"][tag] = dict(worst, repeat_equal=same)
            print(f"[window_attention] {tag} bf16 batch {TRAIN_BATCH} against float64 "
                  "(worst / limit): " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
                  + f"; backward repeats bit for bit: {same}")
            if max(worst.values()) > 1 or not same:
                raise AssertionError(f"window attention {tag}: {out['checks'][tag]}")
            del o, grads, again
    launched = _launches("window_attention")
    if launched != 7 * (1 + 3 + 3):
        raise AssertionError(f"window attention launched {launched} kernels, not 49")

    # float32 at stage 1, shifted: the kernels' softmax (exp on the special
    # function unit, one reciprocal a row) beside torch.softmax's (expf and
    # a division), both against float64 at 2⁻¹⁴ of each element's magnitude
    q, k, v, table, index, mask, scale, do = _wa_case(torch, 4, 64, True, dev, 2,
                                                      torch.float32)
    o0, p0 = wa.forward_plain(q, k, v, table, index, mask, scale)
    plain = wa.mismatch((o0, *wa.backward_plain(q, k, v, p0, index, do, scale,
                                                (table.shape, table.dtype))),
                        q, k, v, table, index, mask, scale, do, 2 ** -14, 2 ** -12)
    del o0, p0
    got = wa.mismatch((wa.forward_cuda(q, k, v, table, index, mask, scale),
                       *wa.backward_cuda(q, k, v, table, index, mask, scale, do)),
                      q, k, v, table, index, mask, scale, do, 2 ** -14, 2 ** -12)
    out["checks"]["f32-h4-nw64-shifted"] = {"kernels": got, "plain": plain}
    print(f"[window_attention] h4-nw64-shifted f32 batch {TRAIN_BATCH} against float64 "
          "(worst / limit at 2⁻¹⁴), kernels | plain version: " + ", ".join(
              f"{k} {got[k]:.3f} | {plain[k]:.3f}" for k in got))
    if max(got.values()) > 1:
        raise AssertionError(f"window attention f32: {got}")
    del q, k, v, do

    # each stage alone: kernels, the plain version, the library yardstick
    step = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    nbytes = counted_bytes = 0
    for heads, nw, blocks, shifts in WA_STAGES:
        stage = {}
        for shifted in sorted({False, bool(shifts)}):
            q, k, v, table, index, mask, scale, do = _wa_case(torch, heads, nw, shifted,
                                                              dev, 1)
            w, n, d = q.shape[0], q.shape[2], q.shape[3]
            plain = {}

            def plain_fwd():
                plain["p"] = wa.forward_plain(q, k, v, table, index, mask, scale)[1]

            plain_fwd()
            add = table[index].view(n, n, heads).permute(2, 0, 1)[None]
            if mask is not None:
                add = add + mask[:, None]
            add = add.to(torch.bfloat16)
            q5, k5, v5 = (t.detach().reshape(TRAIN_BATCH, nw, heads, n, d)
                          .requires_grad_(True) for t in (q, k, v))
            do5 = do.view(TRAIN_BATCH, nw, n, heads, d).transpose(2, 3)

            def sdpa():
                return F.scaled_dot_product_attention(q5, k5, v5, attn_mask=add,
                                                      scale=scale)

            def sdpa_both():
                torch.autograd.grad(sdpa(), (q5, k5, v5), do5)

            times = {
                "kernel_fwd": _cuda_ms(torch, lambda: wa.forward_cuda(
                    q, k, v, table, index, mask, scale)),
                "kernel_bwd": _cuda_ms(torch, lambda: wa.backward_cuda(
                    q, k, v, table, index, mask, scale, do)),
                "plain_fwd": _cuda_ms(torch, plain_fwd, iters=5),
                "plain_bwd": _cuda_ms(torch, lambda: wa.backward_plain(
                    q, k, v, plain["p"], index, do, scale, (table.shape, table.dtype)),
                    iters=5),
                "library_fwd": _cuda_ms(torch, sdpa, iters=5),
                "library_both": _cuda_ms(torch, sdpa_both, iters=5)}
            times["kernel_profiled"] = (
                _profiled_kernel_ms(torch, lambda: wa.forward_cuda(
                    q, k, v, table, index, mask, scale), "sedx_wa_"),
                _profiled_kernel_ms(torch, lambda: wa.backward_cuda(
                    q, k, v, table, index, mask, scale, do), "sedx_wa_"))
            # the function's least bytes of one block, bf16: q, k, v, o
            # forward; q, k, v, dO, dq, dk, dv backward (P is recomputed, o
            # is not read). benchmark/counts/htsat.py counts o in the
            # backward too: 12 tensors, the counts' bound beside it
            least = 11 * 2 * w * n * heads * d
            counted = 12 * 2 * w * n * heads * d
            bound_ms = least / PEAK_BYTES_PER_S * 1e3
            kernel_ms = times["kernel_fwd"] + times["kernel_bwd"]
            times.update(bound_ms=bound_ms, roofline_pct=100 * bound_ms / kernel_ms,
                         counts_roofline_pct=100 * counted / PEAK_BYTES_PER_S * 1e3
                         / kernel_ms)
            tag = "shifted" if shifted else "plain"
            stage[tag] = times
            count = shifts if shifted else blocks - shifts
            step["kernel"] += count * kernel_ms
            step["plain"] += count * (times["plain_fwd"] + times["plain_bwd"])
            step["library"] += count * times["library_both"]
            nbytes += count * least
            counted_bytes += count * counted
            print(f"[window_attention] h{heads} nW {nw} {tag} [{w}, {heads}, {n}, {d}] "
                  f"bf16 ms (CUDA events): kernels fwd {times['kernel_fwd']:.4f} bwd "
                  f"{times['kernel_bwd']:.4f} (profiler {times['kernel_profiled'][0] or 0:.4f} "
                  f"/ {times['kernel_profiled'][1] or 0:.4f}); plain fwd "
                  f"{times['plain_fwd']:.4f} bwd {times['plain_bwd']:.4f}; sdpa fwd "
                  f"{times['library_fwd']:.4f} fwd+bwd {times['library_both']:.4f}; "
                  f"bound {bound_ms:.4f} ms, {times['roofline_pct']:.2f}% of it (the "
                  f"counts' 12 tensors: {times['counts_roofline_pct']:.2f}%) [{card}]")
            del q, k, v, do, q5, k5, v5, plain
        out["stages"][f"h{heads}-nw{nw}"] = stage
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    counts_ms = counted_bytes / PEAK_BYTES_PER_S * 1e3
    out["step"] = dict(step, bound_ms=bound_ms,
                       roofline_pct=100 * bound_ms / step["kernel"],
                       counts_bound_ms=counts_ms,
                       counts_roofline_pct=100 * counts_ms / step["kernel"])
    print(f"[window_attention] a step's 12 blocks, fwd + bwd ms: kernels "
          f"{step['kernel']:.4f}, plain {step['plain']:.4f}, sdpa {step['library']:.4f}; "
          f"least {nbytes / 1e9:.3f} GB → bound {bound_ms:.4f} ms, kernels at "
          f"{out['step']['roofline_pct']:.2f}% (the counts' {counted_bytes / 1e9:.3f} GB: "
          f"{out['step']['counts_roofline_pct']:.2f}%) [{card}]")
    del table, index, mask
    out["main_path"] = _wa_main_path(torch, card)
    print(json.dumps({"window_attention": out}))
    return out


def _wa_main_path(torch, card):
    """HTS-AT at the published widths in bf16 through the port's own
    train step (``train.make_train_step``, host-fed waveforms at batch
    ``TRAIN_BATCH``, mixup on): the core's kernel launches in each of two
    steps (the first captures the CUDA graphs, the second replays them),
    in a step under ``remat`` (eager, the attention recomputed) and in an
    eval forward of ``BATCH`` clips (``train.make_eval_step``, under
    ``no_grad``), each read just after the counters were zeroed."""
    import sound_event_detection_dcase2017_task4_torch as sedt
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
              np.full(cfg.mel_bins, 15.0, np.float32))
    rng = np.random.default_rng(21)
    x = (0.1 * rng.standard_normal((TRAIN_BATCH, cfg.clip_samples))).astype(np.float32)
    y = (rng.random((TRAIN_BATCH, cfg.classes_num)) < 0.07).astype(np.float32)
    frontend = stft.make_logmel_fn(cfg)
    blocks = 12
    want = {"train": [4 * blocks, 4 * blocks], "remat": [5 * blocks], "eval": [blocks]}
    got = {}
    for remat in (False, True):
        model = sedt.get_model("HTSAT", dtype=torch.bfloat16, remat=remat)
        state = train.create_train_state(model, cfg, seed=0)    # device → cuda
        step = train.make_train_step(model, state, frontend=frontend, scalar=scalar,
                                     mixup_alpha=1.0, check_numerics=True)
        key = "remat" if remat else "train"
        got[key] = []
        for _ in want[key]:
            _zero_launches()
            m = step(x, y)
            torch.cuda.synchronize()
            got[key].append(_launches("window_attention"))
            if int(m["nonfinite_count"]) or not np.isfinite(float(m["loss"])):
                raise AssertionError(f"HTS-AT {key} step: loss {float(m['loss'])}, "
                                     f"{int(m['nonfinite_count'])} non-finite")
        if not remat:
            evaluate = train.make_eval_step(model, frontend=frontend, scalar=scalar)
            _zero_launches()
            evaluate(x[:BATCH])
            torch.cuda.synchronize()
            got["eval"] = [_launches("window_attention")]
        del model, state, step
    _zero_launches()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[window_attention] HTS-AT bf16 at the published widths through "
          f"make_train_step, batch {TRAIN_BATCH}: kernel launches a train step "
          f"{got['train']} (capture, replay), under remat {got['remat']}, an eval "
          f"forward of {BATCH} clips {got['eval']} [{card}]")
    if got != want:
        raise AssertionError(f"window attention launches on HTS-AT's path: {got}, "
                             f"not {want}")
    return got


# Audio Mamba's scan at the cell's shape (AuM-B's 253 tokens, E = 1536), and
# the row blocks its float64 yardstick runs in (the loop's states, 0.8 GB a
# tensor over the tokens at 16 rows, not 6.4 GB at 128)
SS_SHAPE = (TRAIN_BATCH, 253, 1536)
SS_ROWS = 16


def _ss_case(torch, shape, dtype, dev, seed):
    """The scan's inputs as ``models.aum``'s mixer makes them (``B`` and
    ``C`` slices of one ``x_proj`` output of width 80, ``Δraw`` around a
    trained Δ's range, ``A_log`` about ``log(1..16)``) and a ``dout``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)     # noqa: E731
    batch, length, width = shape
    dbl_f, dbl_b = r(batch, length, 80).to(dtype), r(batch, length, 80).to(dtype)
    a_log = torch.log(torch.arange(1.0, 17.0, device=dev)).expand(width, -1) + 0.3 * r(width, 16)
    args = (r(*shape).to(dtype), r(*shape).to(dtype), (r(*shape) - 2).to(dtype),
            (r(*shape) - 2).to(dtype), dbl_f[..., 48:64], dbl_f[..., 64:], dbl_b[..., 48:64],
            dbl_b[..., 64:], r(*shape).to(dtype), a_log.contiguous(),
            (a_log + 0.1 * r(width, 16)).contiguous(), r(width), r(width),
            0.5 * r(width) - 3, 0.5 * r(width) - 3)
    return args, r(*shape).to(dtype)


def _aum_counts():
    """``benchmark/counts/aum.py`` and the ``aum`` configuration's
    ``model`` group, the benchmark's frozen count of the scan's bytes."""
    import importlib

    root = str(Path(__file__).resolve().parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    counts = importlib.import_module("benchmark.counts.aum")
    arch = json.loads((Path(root) / "benchmark" / "configs" / "aum.json").read_text())["model"]
    return counts, arch


def phase_selective_scan(torch, card):
    """Phase 17 (see the module docstring): returns the ``kernels`` line's
    ``selective_scan`` entry."""
    from sound_event_detection_dcase2017_task4_torch.ops import selective_scan as ss

    t0 = time.perf_counter()
    ss.LIBRARY.load()
    log = ss.LIBRARY.log or ""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) > 0 for n in re.findall(r"(\d+) bytes spill stores", log))
    print(f"[selective_scan] ops/csrc/selective_scan.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s; {len(regs)} kernels, registers "
          f"{min(regs, default=0)}-{max(regs, default=0)}, {spills} with spills")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[selective_scan] ptxas {line.strip()}")
    dev = torch.device("cuda")
    shape = "x".join(map(str, SS_SHAPE))

    # the kernels and the plain version on the same inputs, both against
    # float64, the plain version and float64 in row blocks
    _zero_launches()
    args, dout = _ss_case(torch, SS_SHAPE, torch.bfloat16, dev, 0)
    out, ysum = ss.forward_cuda(*args)
    grads = ss.backward_cuda(args, ysum, dout)
    again = ss.backward_cuda(args, ysum, dout)
    torch.cuda.synchronize()
    launched = _launches("selective_scan")
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    t0 = time.perf_counter()
    got = ss.mismatch((out, *grads), args, dout, SS_ROWS)
    del out, grads
    plain = ss.mismatch(ss.plain_grads(args, dout, SS_ROWS), args, dout, SS_ROWS)
    limit = {k: max(2 * v, 1e-5) for k, v in plain.items()}
    print(f"[selective_scan] [{shape}] bf16, both directions, against float64 "
          f"({time.perf_counter() - t0:.1f} s), kernels | plain version | limit: "
          + ", ".join(f"{k} {got[k]:.3g} | {plain[k]:.3g} | {limit[k]:.3g}" for k in got)
          + f"; backward repeats bit for bit: {same}; launches {launched}")
    if any(got[k] > limit[k] for k in got) or not same or launched != 3:
        raise AssertionError(f"selective scan at [{shape}]: {got} against {limit}, "
                             f"repeat {same}, launches {launched}")

    # each kernel alone by CUDA events, the plain version beside them, and
    # the function's least bytes (the benchmark's count) as the bound
    counts, arch = _aum_counts()
    dims = counts.dims(arch)
    if (dims["L"], dims["E"]) != SS_SHAPE[1:]:
        raise AssertionError(f"the aum configuration's tokens and width {dims} are not "
                             f"{SS_SHAPE[1:]}")
    bound_ms = counts.bound_s(counts.scan_bytes(arch, SS_SHAPE[0], 2)) / arch["depth"] * 1e3
    fwd_ms = _cuda_ms(torch, lambda: ss.forward_cuda(*args))
    bwd_ms = _cuda_ms(torch, lambda: ss.backward_cuda(args, ysum, dout))
    plain_ms = _cuda_ms(torch, lambda: ss.plain_grads(args, dout, SS_ROWS), iters=1,
                        warmup=1)
    kernel_ms = fwd_ms + bwd_ms
    print(f"[selective_scan] [{shape}] bf16 a block, ms (CUDA events): forward "
          f"{fwd_ms:.4f}, backward {bwd_ms:.4f}, both {kernel_ms:.4f}; the plain version "
          f"forward and backward {plain_ms:.1f}; least bytes {bound_ms:.4f} ms at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s, the kernels at "
          f"{100 * bound_ms / kernel_ms:.2f}%; a step's {arch['depth']} blocks "
          f"{arch['depth'] * kernel_ms:.2f} ms [{card}]")
    del args, dout, ysum
    entry = {"name": "selective_scan", "route": "cuda",
             "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/"
                       "selective_scan.cu",
             "shape": list(SS_SHAPE), "dtype": "bfloat16",
             "checks": {"kernels": got, "plain": plain, "repeat_equal": same},
             "kernel_ms": {"forward": fwd_ms, "backward": bwd_ms}, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "roofline_pct": 100 * bound_ms / kernel_ms}
    entry.update(_ss_main_path(torch, card))
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def _ss_main_path(torch, card):
    """AuM-B at the published widths in bf16 through the port's own train
    step (``train.make_train_step``, host-fed waveforms at batch
    ``TRAIN_BATCH``, mixup on): the scan's launches and plain calls in
    each of two steps (the first captures the CUDA graphs, the second
    replays them) and in an eval forward of ``BATCH`` clips, each read
    just after the counters were zeroed."""
    import sound_event_detection_dcase2017_task4_torch as sedt
    from sound_event_detection_dcase2017_task4_torch import trace, train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
              np.full(cfg.mel_bins, 15.0, np.float32))
    rng = np.random.default_rng(23)
    x = (0.1 * rng.standard_normal((TRAIN_BATCH, cfg.clip_samples))).astype(np.float32)
    y = (rng.random((TRAIN_BATCH, cfg.classes_num)) < 0.07).astype(np.float32)
    model = sedt.get_model("AudioMamba", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, cfg, seed=0)        # device → cuda
    step = train.make_train_step(model, state, frontend=stft.make_logmel_fn(cfg),
                                 scalar=scalar, mixup_alpha=1.0, check_numerics=True)
    blocks = len(model.layers)
    got, plain = {"train": []}, 0
    for _ in range(2):
        _zero_launches()
        m = step(x, y)
        torch.cuda.synchronize()
        got["train"].append(_launches("selective_scan"))
        plain += trace.counters().get("ops.selective_scan.plain_calls", 0)
        if int(m["nonfinite_count"]) or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"AuM-B train step: loss {float(m['loss'])}, "
                                 f"{int(m['nonfinite_count'])} non-finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    evaluate = train.make_eval_step(model, frontend=stft.make_logmel_fn(cfg), scalar=scalar)
    _zero_launches()
    evaluate(x[:BATCH])
    torch.cuda.synchronize()
    got["eval"] = [_launches("selective_scan")]
    plain += trace.counters().get("ops.selective_scan.plain_calls", 0)
    del model, state, step, evaluate
    _zero_launches()
    print(f"[selective_scan] AuM-B bf16 at the published widths through "
          f"make_train_step, batch {TRAIN_BATCH}: kernel launches a train step "
          f"{got['train']} (capture, replay), an eval forward of {BATCH} clips "
          f"{got['eval']}, plain calls {plain}; peak {peak:.2f} GiB so far [{card}]")
    want = {"train": [2 * blocks, 2 * blocks], "eval": [blocks]}
    if got != want or plain:
        raise AssertionError(f"selective scan on AuM-B's path: {got}, not {want}; "
                             f"plain calls {plain}")
    return {"launches": got["train"][0], "launches_replay": got["train"][1],
            "launches_eval": got["eval"][0], "plain_calls": plain}


def _launches(entry):
    """The kernel entry's launches since they were last zeroed (the port's
    counter ``ops.<entry>.launches``)."""
    from sound_event_detection_dcase2017_task4_torch import trace

    return trace.counters().get(f"ops.{entry}.launches", 0)


# the bn_act counters by phase (the ``kernels`` line's ``bn_act`` entry):
# ``calls``, ``plain_calls`` (the CPU's train-mode calls among them: the
# phases' CPU reference steps) and ``launches`` of this process and of the
# tools' children; ``card_plain``, train-mode calls on a CUDA tensor that
# took the composite in this process, which must stay 0
_BN_KEYS = ("calls", "plain_calls", "launches", "channels_last_calls")
_BN_TALLY: dict[str, dict[str, int]] = {}
_BN_PHASE = ["phases_1_to_4_and_15_to_17"]


def _bn_tally(counters=None):
    """Add ``counters`` (the registry's, when ``None``) to the current
    phase's ``bn_act`` tally."""
    from sound_event_detection_dcase2017_task4_torch import trace

    counters = trace.counters() if counters is None else counters
    tally = _BN_TALLY.setdefault(_BN_PHASE[0], dict.fromkeys(
        _BN_KEYS + ("card_plain",), 0))
    for k in _BN_KEYS:
        tally[k] += counters.get(f"ops.bn_act.{k}", 0)
    return tally


def _bn_phase(name):
    """Close the current phase's ``bn_act`` tally and open ``name``'s."""
    _zero_launches()
    _BN_PHASE[0] = name
    _bn_tally({})


def _watch_batchnorm():
    """Count, into ``card_plain``, every train-mode ``BatchNorm`` call on a
    CUDA tensor that takes the composite (phase 15 times the composite on
    purpose, before this is installed)."""
    from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm

    inner = BatchNorm._forward

    def _forward(self, x, train, mesh, act, fused):
        if train and x.is_cuda and not fused:
            _bn_tally({})["card_plain"] += 1
        return inner(self, x, train, mesh, act, fused)

    BatchNorm._forward = _forward


def _zero_launches():
    """Zero the port's counters, the launch counters among them, after
    adding the ``bn_act`` counters to the current phase's tally."""
    from sound_event_detection_dcase2017_task4_torch import trace

    _bn_tally()
    trace.reset_counters()


def _request(cfg, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.clip_samples) / cfg.sample_rate
    x = 0.05 * rng.standard_normal((n, cfg.clip_samples))
    for i in range(n):                           # a few tone bursts per clip
        f = rng.uniform(300.0, 4000.0)
        on = np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t) > 0.3
        x[i] += 0.5 * np.sin(2 * np.pi * f * t) * on
    return x.astype(np.float32)


def _check_outputs(out, n, cfg):
    c, f, a = (out["clipwise_output"], out["framewise_output"],
               out["event_activity"])
    if c.shape != (n, cfg.classes_num) or f.shape != (n, cfg.frames_num,
                                                      cfg.classes_num):
        raise AssertionError(f"output shapes {c.shape}, {f.shape}")
    if a.shape != f.shape or a.dtype != np.uint8 or not np.isin(a, (0, 1)).all():
        raise AssertionError(f"event_activity {a.shape} {a.dtype}")
    for v in (c, f):
        if v.dtype != np.float32 or not np.isfinite(v).all():
            raise AssertionError("non-finite or non-f32 probabilities")
        if v.min() < 0.0 or v.max() > 1.0:
            raise AssertionError("probabilities outside [0, 1]")


def phase_slice(torch, sedt, card):

    cfg = sedt.config.DEFAULT
    rng = np.random.default_rng(1)
    scalar = (rng.normal(-30.0, 5.0, cfg.mel_bins).astype(np.float32),
              rng.normal(15.0, 2.0, cfg.mel_bins).astype(np.float32))
    model = sedt.get_model("Cnn_9layers_Gru_FrameAtt",
                           generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    n_params = sum(p.numel() for p in model.parameters())
    pred = sedt.Predictor(model, cfg, scalar=scalar)        # device → cuda
    if pred.device.type != "cuda":
        raise AssertionError(f"Predictor resolved to {pred.device}")
    wave = _request(cfg, BATCH, 2)
    rec = _request(cfg, 4, 3).reshape(-1)[: int(35.0 * cfg.sample_rate)]

    # ---- the main path: counters zeroed just before, read just after ----
    # (the Predictor's frontend looks the plain version up as
    # ``stft.logmel`` at each call, so the guard's patch sees it)
    with _PlainGuard(torch, cfg) as guard:
        _zero_launches()
        out = pred(wave)
        n_request = _launches("logmel")
        events = pred.detect_events(wave)
        long0 = pred.predict_long(rec)
        # decode band from the random model's own output range, so that the
        # stream has events and early emissions to compare
        fw = long0["framewise_output"]
        pred.sed_params.update(
            sed_high_threshold=float(np.quantile(fw, 0.9)),
            sed_low_threshold=float(np.quantile(fw, 0.6)), n_smooth=3, n_salt=2)
        long_out = pred.predict_long(rec)
        det = sedt.StreamingDetector(pred)
        streamed, pos = [], 0
        for size in [32000, 70000, 3333, 150000, 48000] * 20:
            if pos >= len(rec):
                break
            streamed += det.feed(rec[pos: pos + size])
            pos += size
        streamed += det.flush()
        torch.cuda.synchronize()
    launches = _launches("logmel")
    # ----------------------------------------------------------------------

    _check_outputs(out, BATCH, cfg)
    if n_request != 1 or launches < 4:
        raise AssertionError(f"kernel launches: {n_request} for one request, "
                             f"{launches} on the whole path")
    if any(guard.calls.values()):
        raise AssertionError(f"plain frontend ran on the CUDA path: {guard.calls}")
    if len(events) != BATCH:
        raise AssertionError("detect_events: wrong number of clips")
    n_frames_long = 1 + len(rec) // cfg.hop_size
    if long_out["framewise_output"].shape != (n_frames_long, cfg.classes_num):
        raise AssertionError("predict_long: wrong timeline shape")
    if not long_out["events"] or sorted(streamed) != sorted(long_out["events"]):
        raise AssertionError(f"StreamingDetector: {len(streamed)} events vs "
                             f"predict_long's {len(long_out['events'])}")
    print(f"[slice] Cnn_9layers_Gru_FrameAtt ({n_params} params) on "
          f"{pred.device}: request {BATCH}×10 s OK; {sum(map(len, events))} "
          f"events; predict_long 35 s → {len(long_out['events'])} events == "
          f"StreamingDetector's; kernel launches {launches} "
          f"(1 per request), plain frontend calls 0 (the guard saw 1 CPU "
          f"call in its check)")

    # same weights on the CPU, two clips, f32, TF32 off on the card
    cpu_pred = sedt.Predictor(cpu_model, cfg, scalar=scalar, device="cpu")
    ref = cpu_pred(wave[:2])
    gpu2 = pred(wave[:2])
    d_clip = float(np.abs(ref["clipwise_output"] - gpu2["clipwise_output"]).max())
    d_frame = float(np.abs(ref["framewise_output"]
                           - gpu2["framewise_output"]).max())
    print(f"[slice] card vs CPU, same weights, 2 clips: max |Δ| clipwise "
          f"{d_clip:.3e}, framewise {d_frame:.3e} (limit 1e-4)")
    if not (d_clip <= 1e-4 and d_frame <= 1e-4):
        raise AssertionError("card and CPU disagree")

    # latency / throughput / memory
    def p50_latency(p):
        return _p50_latency(p, wave)

    torch.cuda.reset_peak_memory_stats()
    lat32 = p50_latency(pred)
    mem = torch.cuda.max_memory_allocated()
    bf16_model = sedt.get_model("Cnn_9layers_Gru_FrameAtt", dtype=torch.bfloat16)
    bf16_model.load_state_dict(pred.model.state_dict())
    pred16 = sedt.Predictor(bf16_model, cfg, scalar=scalar)
    out16 = pred16(wave)
    _check_outputs(out16, BATCH, cfg)
    d16 = {k: float(np.abs(out16[k] - out[k]).max())
           for k in ("clipwise_output", "framewise_output")}
    print(f"[slice] bf16 vs f32 on the card, same weights, {BATCH} clips: "
          f"max |Δ| clipwise {d16['clipwise_output']:.3e}, framewise "
          f"{d16['framewise_output']:.3e} (limit {BF16_ATOL})")
    if not max(d16.values()) <= BF16_ATOL:
        raise AssertionError("the bf16 model strays from the f32 one")
    lat16 = p50_latency(pred16)
    # the bf16 model with its BiGRU in bf16 (its own path) and in float32
    # (input cast up, output back), alternated in this run: 4 rounds
    gru = pred16.model.gru
    own = gru.forward
    variants = {"bf16": own,
                "f32": lambda x, train=False: own(x.float(), train).to(x.dtype)}
    ab = {tag: [] for tag in variants}
    for _ in range(4):
        for tag, fwd in variants.items():
            gru.forward = fwd
            ab[tag].append(p50_latency(pred16))
    for tag, fwd in variants.items():
        gru.forward = fwd
        _, rows = _device_kernels(torch, lambda: pred16(wave))
        print(f"[slice] bf16 model, BiGRU in {tag}: p50 "
              f"{' / '.join(f'{v:.3f}' for v in ab[tag])} ms, device time "
              f"{sum(r[0] for r in rows):.4f} ms (profiler) [{card}]")
    del gru.forward
    print(f"[slice] request {BATCH}×10 s p50 latency: f32 {lat32:.3f} ms "
          f"({BATCH / lat32 * 1e3:.2f} clips/s), bf16 {lat16:.3f} ms "
          f"({BATCH / lat16 * 1e3:.2f} clips/s); peak memory (f32) "
          f"{mem / 2**20:.1f} MiB [{card}]")
    _profile_request(torch, pred, wave, "f32")
    _profile_request(torch, pred16, wave, "bf16")
    return launches


def _profile_request(torch, pred, wave, tag):
    """Device time by kernel over one request of ``pred`` (compute type
    ``tag``), printed as a table (the 15 largest rows, names cut to 110
    characters)."""
    wall_ms, rows = _device_kernels(torch, lambda: pred(wave))
    if not rows:
        print("[profile] torch.profiler saw no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    print(f"[profile] one {tag} request of {BATCH} clips: device time "
          f"{busy:.4f} ms in {len(rows)} kernels/copies, {wall_ms:.3f} ms "
          "wall under the profiler")
    for ms, count, key in rows[:15]:
        print(f"[profile] {ms:9.4f} ms {count:5d}x  {key[:110]}")


def _corpus(cfg, n, seed):
    """``n`` int16 clips (noise plus a tone burst each, quantised with the
    port's ``_quantize_int16``), staged as hop-chunk rows with
    ``prepare_chunks``, and weak targets: numpy arrays from ``seed``."""
    from sound_event_detection_dcase2017_task4_torch.data.hdf5 import (
        _quantize_int16)
    from sound_event_detection_dcase2017_task4_torch.ops.stft import (
        prepare_chunks)

    rng = np.random.default_rng(seed)
    t = (np.arange(cfg.clip_samples) / cfg.sample_rate).astype(np.float32)
    wave = 0.05 * rng.standard_normal((n, cfg.clip_samples), np.float32)
    freq = rng.uniform(200.0, 6000.0, n).astype(np.float32)
    for i in range(n):
        on = np.sin(np.float32(2 * np.pi * 0.3) * t + i) > 0.0
        wave[i] += 0.3 * np.sin(np.float32(2 * np.pi) * freq[i] * t) * on
    targets = (rng.random((n, 17)) < 0.2).astype(np.float32)
    return prepare_chunks(_quantize_int16(wave), cfg), targets


def phase_bank_kernel(torch, sedt, card):
    """The bank kernel at the training shape against the waveform kernel
    (bit for bit), a float32 bank and the plain ``logmel_bank``; bad inputs;
    times. Returns its ``kernels`` entry, the int16 bank on the card and
    the corpus targets."""
    from sound_event_detection_dcase2017_task4_torch.data.hdf5 import (
        _WAVE_INT16_SCALE)
    from sound_event_detection_dcase2017_task4_torch.ops import (
        dsp, logmel_cuda, stft)

    cfg = sedt.config.DEFAULT
    scale = float(_WAVE_INT16_SCALE)
    t0 = time.perf_counter()
    staged, targets = _corpus(cfg, BANK_CLIPS, 3)
    bank = torch.from_numpy(staged).cuda()
    print(f"[bank] int16 bank {tuple(bank.shape)} ({bank.numel() * 2 / 1e6:.1f}"
          f" MB) made and staged in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(4)
    idx = np.sort(rng.choice(BANK_CLIPS, TRAIN_BATCH - 1, replace=False))
    idx = np.sort(np.append(idx, idx[len(idx) // 2]))       # one duplicate
    rows = len(np.unique(idx))

    got = logmel_cuda.logmel_cuda_bank(bank, idx, cfg, scale)
    dec = stft.unstage_chunks(bank[torch.from_numpy(idx).cuda()], cfg)
    dec = dec.to(torch.float32) * scale
    wave_out = logmel_cuda.logmel_cuda(dec.contiguous(), cfg)
    fbank = bank.to(torch.float32) * scale
    f32_out = logmel_cuda.logmel_cuda_bank(fbank, idx, cfg)
    want = stft.logmel_bank(bank, idx, cfg, scale)
    torch.cuda.synchronize()
    del fbank, dec
    if got.shape != (TRAIN_BATCH, cfg.frames_num, cfg.mel_bins):
        raise AssertionError(f"bank kernel output shape {tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("bank kernel output is not finite")
    if not torch.equal(got, wave_out):
        raise AssertionError("int16 bank launch differs from the waveform "
                             "kernel on the decoded rows")
    if not torch.equal(got, f32_out):
        raise AssertionError("int16 and float32 banks differ")
    err_db = float((got - want).abs().max())
    lin_g, lin_w = 10.0 ** (got.double() / 10.0), 10.0 ** (want.double() / 10.0)
    lin_ok = bool(((lin_g - lin_w).abs() <= 1e-10 + 2e-3 * lin_w.abs()).all())
    lin_rel = float(((lin_g - lin_w).abs() / lin_w.abs().clamp(min=1e-10)).max())
    print(f"[bank] B={TRAIN_BATCH} from {BANK_CLIPS} clips ({rows} distinct): "
          "int16 launch == waveform kernel on the decoded rows (torch.equal), "
          "== float32 bank; vs plain logmel_bank: max |Δ| "
          f"{err_db:.3e} dB (limit 0.1), max linear rel err {lin_rel:.3e} "
          "(limit 2e-3)")
    if not err_db <= 0.1 or not lin_ok:
        raise AssertionError("bank kernel disagrees with the plain version")
    del wave_out, f32_out, lin_g, lin_w

    bad = [((bank, idx, cfg), ValueError, "int16 bank without wave_scale"),
           ((bank, idx, cfg, 1e-4), ValueError, "scale not a power of two"),
           ((bank[:, :-1].contiguous(), idx, cfg, scale), ValueError,
            "wrong chunk geometry"),
           ((bank, np.array([0, BANK_CLIPS]), cfg, scale), IndexError,
            "index out of range"),
           ((bank, torch.from_numpy(idx).cuda(), cfg, scale), ValueError,
            "CUDA index tensor")]
    for args, err, what in bad:
        try:
            logmel_cuda.logmel_cuda_bank(*args)
        except err as e:
            print(f"[bank] {what} raises {type(e).__name__}")
        else:
            raise AssertionError(f"{what} did not raise")

    n_fft = cfg.window_size
    hann = torch.hann_window(n_fft, periodic=True, device="cuda")
    mel_full = torch.from_numpy(dsp.mel_filterbank(
        cfg.sample_rate, n_fft, cfg.mel_bins, cfg.fmin, cfg.fmax)).cuda()
    dev_idx = torch.from_numpy(idx).cuda()

    def library():
        x = stft.unstage_chunks(bank.index_select(0, dev_idx), cfg)
        spec = torch.stft(x.to(torch.float32) * scale, n_fft, cfg.hop_size,
                          window=hann, center=True, pad_mode=cfg.pad_mode,
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2
        mel = power.transpose(1, 2) @ mel_full
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.log_amin))

    lib_err = float((library() - want).abs().max())
    del want
    kernel = lambda: logmel_cuda.logmel_cuda_bank(bank, idx, cfg, scale)  # noqa: E731
    ms = _cuda_ms(torch, kernel, iters=10)
    plain_ms = _cuda_ms(torch, lambda: stft.logmel_bank(bank, idx, cfg, scale),
                        iters=10)
    library_ms = _cuda_ms(torch, library, iters=10)
    ms_2 = _cuda_ms(torch, kernel, iters=10)
    kernel_ms = _profiled_kernel_ms(torch, kernel, "logmel_kernel", iters=5)
    flops, nbytes = logmel_cuda.flops_and_bytes(cfg, TRAIN_BATCH,
                                                cfg.clip_samples, 2, rows)
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"[bank] B={TRAIN_BATCH}: kernel alone (profiler) "
          f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'}, "
          f"wrapper (index copy + kernel) {ms:.4f} / {ms_2:.4f} ms, plain "
          f"{plain_ms:.4f} ms, gather + torch.stft yardstick {library_ms:.4f} "
          f"ms (max |Δ| {lib_err:.3e} dB); bound of the function "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.4f} GFLOP at 67 "
          f"TFLOP/s f32, {nbytes / 1e6:.3f} MB with int16 samples at 3.35 "
          f"TB/s); {_shares(kernel_ms, ms, bound_ms, library_ms)} [{card}]")
    entry = {"name": "logmel_bank", "route": "cuda",
             "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/logmel.cu",
             "replaces": "sound_event_detection_dcase2017_task4_tpu/ops/"
                         "pallas_logmel.py:295 (logmel_pallas_bank)",
             "launches": None, "max_abs_err": err_db, "ms": ms,
             "kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    return entry, bank, targets, scale


def _train_model(sedt, torch, dtype, dropout):
    """The flagship at full width from seed 0 (the same weights whatever
    ``dtype`` and ``dropout``)."""
    from sound_event_detection_dcase2017_task4_torch.models import (
        MODEL_REGISTRY, SedCnn)

    return SedCnn(dtype=dtype, dropout=dropout,
                  generator=torch.Generator().manual_seed(0),
                  **MODEL_REGISTRY[MODEL])


def _one_step(torch, sedt, cfg, model, device, bank, idx, y, scalar, scale):
    """One step without dropout draws or mixup; ``(loss, grad_norm, running
    statistics)`` on the host."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    state = train.create_train_state(model, cfg, device=device)
    step = train.make_train_step(
        model, state, scalar=scalar, bank=bank, wave_scale=scale,
        bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=scale))
    m = step(idx, y)
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if "running" in k}
    return float(m["loss"]), float(m["grad_norm"]), stats


def phase_train(torch, sedt, card, bank, targets, scale):
    """The training slice at full width; returns the bank launches of its
    main-path run."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
              np.full(cfg.mel_bins, 15.0, np.float32))
    model = _train_model(sedt, torch, torch.bfloat16, 0.2)
    state = train.create_train_state(model, cfg, seed=0)    # device → cuda
    if state.device.type != "cuda":
        raise AssertionError(f"create_train_state resolved to {state.device}")
    bank_fn = stft.make_logmel_bank_fn(cfg, precision="fast", wave_scale=scale)
    step = train.make_train_step(
        model, state, scalar=scalar, mixup_alpha=1.0, check_numerics=True,
        bank=bank, wave_scale=scale, bank_frontend=bank_fn)
    evaluate = train.make_eval_step(model, scalar=scalar, bank=bank,
                                    wave_scale=scale, bank_frontend=bank_fn)
    sampler = np.random.default_rng(5)
    batches = [np.sort(sampler.choice(BANK_CLIPS, TRAIN_BATCH, replace=False))
               for _ in range(TRAIN_STEPS)]
    ys = [targets[b] for b in batches]

    # ---- the main path: counters zeroed just before, read just after ----
    with _PlainGuard(torch, cfg) as guard:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(TRAIN_STEPS + 1)]
        metrics = []
        marks[0].record()
        for i in range(TRAIN_STEPS):
            metrics.append(step(batches[i], ys[i]))
            marks[i + 1].record()
        out = evaluate(batches[0][:EVAL_BATCH])
        torch.cuda.synchronize()
    launches, waveform_launches = _launches("logmel_bank"), _launches("logmel")
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------

    losses = [float(m["loss"]) for m in metrics]
    bad = [int(m["nonfinite_count"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(TRAIN_STEPS)]
    if launches != TRAIN_STEPS + 1 or waveform_launches != 0:
        raise AssertionError(f"bank kernel launches {launches} for "
                             f"{TRAIN_STEPS} steps + 1 eval; waveform kernel "
                             f"{waveform_launches}")
    if any(guard.calls.values()):
        raise AssertionError(f"plain frontend ran on the CUDA path: {guard.calls}")
    if not np.isfinite(losses).all() or any(bad) or not np.isfinite(norms).all():
        raise AssertionError(f"non-finite training: losses {losses}, "
                             f"non-finite counts {bad}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    c, f = out["clipwise_output"], out["framewise_output"]
    if (c.shape != (EVAL_BATCH, cfg.classes_num)
            or f.shape != (EVAL_BATCH, cfg.frames_num, cfg.classes_num)
            or not (torch.isfinite(c).all() and torch.isfinite(f).all())):
        raise AssertionError("eval step: bad outputs")
    p50 = float(np.median(step_ms))
    print(f"[train] {MODEL} bf16 on {state.device}, batch {TRAIN_BATCH} from "
          f"a {BANK_CLIPS}-clip int16 bank, mixup α=1, dropout 0.2: "
          f"{TRAIN_STEPS} steps, loss {losses[0]:.5f} → mean of last 5 "
          f"{np.mean(losses[-5:]):.5f}, non-finite 0; bank kernel launches "
          f"{launches} ({TRAIN_STEPS} steps + 1 eval step), plain frontend "
          "calls 0 (the guard saw 1 CPU call in its check)")
    print(f"[train] losses: {' '.join(f'{v:.4f}' for v in losses)}")
    print(f"[train] step time p50 {p50:.3f} ms (CUDA events; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, first "
          f"{step_ms[0]:.3f}), {TRAIN_BATCH / p50 * 1e3:.2f} clips/s; peak "
          f"memory {peak / 2**20:.1f} MiB [{card}]")

    wall_ms, rows = _device_kernels(torch, lambda: step(batches[1], ys[1]))
    busy = sum(r[0] for r in rows)
    bank_ms = sum(r[0] for r in rows if "logmel_kernel" in r[2])
    print(f"[profile] one bf16 train step of {TRAIN_BATCH} clips: device time "
          f"{busy:.4f} ms in {len(rows)} kernels/copies, {wall_ms:.3f} ms wall "
          f"under the profiler; bank kernel {bank_ms:.4f} ms "
          f"({100 * bank_ms / max(busy, 1e-9):.1f}%); idle ≈ "
          f"{100 * max(0.0, 1 - busy / p50):.1f}% of the p50 step "
          f"({100 * max(0.0, 1 - busy / wall_ms):.1f}% of the profiled wall)")
    for ms, count, key in rows[:15]:
        print(f"[profile] {ms:9.4f} ms {count:5d}x  {key[:110]}")
    rnn = [r for r in rows if any(s in r[2] for s in ("RNN", "rnn", "GRU", "gru"))]
    for ms, count, key in rnn[:6]:
        print(f"[profile] GRU kernel: {ms:9.4f} ms {count:5d}x  {key[:100]}")
    if not rnn:
        print("[profile] GRU kernel: no kernel named RNN/GRU in the step")
    _, ops = _device_kernels(torch, lambda: step(batches[2], ys[2]), by_op=True)
    print(f"[profile] the same by PyTorch operator (device time of the kernels "
          f"each launched itself; {sum(r[0] for r in ops):.4f} ms in all):")
    for ms, count, key in ops[:20]:
        print(f"[profile-op] {ms:9.4f} ms {count:5d}x  {key[:90]}")

    # f32, TF32 off: the card against the CPU, same weights, 2 clips
    idx2 = batches[0][:2]
    gpu = _one_step(torch, sedt, cfg, _train_model(sedt, torch, torch.float32, 0.0),
                    "cuda", bank, idx2, targets[idx2], scalar, scale)
    cpu = _one_step(torch, sedt, cfg, _train_model(sedt, torch, torch.float32, 0.0),
                    "cpu", bank[torch.from_numpy(idx2).cuda()].cpu(),
                    np.arange(2), targets[idx2], scalar, scale)
    d_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    d_norm = abs(gpu[1] - cpu[1]) / abs(cpu[1])
    d_stats = max(float(((gpu[2][k] - cpu[2][k]).abs()
                         / (1e-5 + 1e-4 * cpu[2][k].abs())).max())
                  for k in cpu[2])
    print(f"[train] f32 step, card vs CPU, same weights, 2 clips: loss "
          f"{gpu[0]:.7f} vs {cpu[0]:.7f} (rel {d_loss:.3e}, limit 2e-5), "
          f"grad-norm {gpu[1]:.6f} vs {cpu[1]:.6f} (rel {d_norm:.3e}, limit "
          f"1e-4), BN running statistics at {d_stats:.3f} of rtol 1e-4 / atol "
          "1e-5")
    if not (d_loss <= 2e-5 and d_norm <= 1e-4 and d_stats <= 1.0):
        raise AssertionError("the card's train step disagrees with the CPU's")

    # bf16 against f32 on the card: the first step, same weights and batch
    first = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        first[tag] = _one_step(torch, sedt, cfg, _train_model(sedt, torch, dt, 0.0),
                               "cuda", bank, batches[0], ys[0], scalar, scale)[0]
    d16 = abs(first["bf16"] - first["f32"])
    print(f"[train] first-step loss at batch {TRAIN_BATCH}, dropout 0, no "
          f"mixup: bf16 {first['bf16']:.6f} vs f32 {first['f32']:.6f} "
          f"(|Δ| {d16:.3e}, limit {BF16_LOSS_ATOL})")
    if not d16 <= BF16_LOSS_ATOL:
        raise AssertionError("the bf16 step strays from the f32 one")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the CLI
# ---------------------------------------------------------------------------
CLI_TRAIN, CLI_TEST, CLI_EVAL = 128, 32, 32
CLI_BATCH = 32
CLI_STEPS, CLI_EVAL_INTERVAL, CLI_EVAL_MAX = 20, 10, 2
CLI_RUN = ("loss_type=clip_bce", "augmentation=mixup", f"batch_size={CLI_BATCH}")
CLI_ARGS = [f"--model_type={MODEL}", "--feature_source=waveform",
            "--augmentation=mixup", f"--batch_size={CLI_BATCH}"]


def _db_bound_ok(got, want):
    """0.1 dB absolute and rtol 2e-3 in the linear domain."""
    err = float((got - want).abs().max())
    lin_g, lin_w = 10.0 ** (got.double() / 10.0), 10.0 ** (want.double() / 10.0)
    lin_ok = bool(((lin_g - lin_w).abs() <= 1e-10 + 2e-3 * lin_w.abs()).all())
    return err, err <= 0.1 and lin_ok


def _tensors_equal(a, b, path="state"):
    """Raise unless the nested dicts/lists of tensors and values are equal."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            _tensors_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths {len(a)} vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _tensors_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{path}: tensors differ")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} vs {b!r}")


def _full_size_search(torch, cfg, labels, card, n_clips=488):
    """``optimize_sed_thresholds``'s search at the real testing split's
    size (488 clips × 1001 frames × 17 classes: over the CLI's 2M-element
    rule, so the CLI sends it to the device scorer) on seeded random
    predictions and events; the optimum's score re-checked by the numpy
    oracle."""
    from sound_event_detection_dcase2017_task4_torch import (autoth, scoring,
                                                             sed, sed_fast)

    rng = np.random.default_rng(12)
    fw = rng.random((n_clips, cfg.frames_num, len(labels)), np.float32) ** 3
    names = [f"clip_{i:05d}.wav" for i in range(n_clips)]
    gt = {}
    for name in names:
        events = []
        for _ in range(int(rng.integers(0, 4))):
            on = float(rng.uniform(0.0, 9.0))
            events.append((on, min(10.0, on + float(rng.uniform(0.3, 4.0))),
                           labels[int(rng.integers(len(labels)))]))
        gt[name] = events
    t0 = time.perf_counter()
    scorer = sed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100)
    t_stage = time.perf_counter() - t0
    calls = [0]

    def counts_fn(*a):
        calls[0] += 1
        return scorer.per_class_counts(*a)

    t0 = time.perf_counter()
    best, params = autoth.optimize_sed_params(scorer.score_params, len(labels),
                                              counts_fn=counts_fn)
    t_search = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = sed.frame_prediction_to_event_prediction(fw, params, 100, labels)
    oracle = scoring.segment_based_metrics(
        gt, {names[i]: events[i] for i in range(n_clips)}, 10.0, 1.0,
        labels)["overall"]["f_measure"]["f_measure"]
    t_oracle = time.perf_counter() - t0
    if oracle != best:
        raise AssertionError(f"full-size search: device {best} vs numpy {oracle}")
    print(f"[cli] SED threshold search at {n_clips}×{cfg.frames_num}×"
          f"{len(labels)} (the CLI's device path): staging {t_stage:.3f} s, "
          f"search {t_search:.3f} s over {calls[0]} device count calls "
          f"({1e3 * t_search / calls[0]:.3f} ms each), segment F1 {best:.6f} "
          f"== the numpy oracle's re-score ({t_oracle:.3f} s for one numpy "
          f"score) [{card}]")


def _bare_step_ms(torch, cli, ws, steps=20, warmup=3):
    """p50 of the train step that ``main train`` builds (the flagship in
    bf16 over the device cache at the CLI's batch), called in a plain loop
    on the generator's index batches, by CUDA events."""
    import argparse

    args = argparse.Namespace(
        workspace=ws, device=torch.device("cuda"), model_type=MODEL,
        loss_type="clip_bce", augmentation="mixup", batch_size=CLI_BATCH,
        learning_rate=None, warmup_steps=None, grad_clip=None, seed=1234,
        mini_data=0, holdout_fold=None, feature_source="waveform",
        no_pallas=False, dtype="bf16", remat=False, lazy_data=False,
        device_cache="on", check_numerics=False)
    ctx = cli._build(args, for_train=True)
    if not ctx["use_bank"]:
        raise AssertionError("the bare loop did not stage the device cache")
    stream = ctx["gen"].generate_train(yield_indices=True)
    batches = [next(stream) for _ in range(steps + warmup)]
    for idx, y in batches[:warmup]:
        ctx["step"](idx, y)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    for i, (idx, y) in enumerate(batches[warmup:]):
        ctx["step"](idx, y)
        marks[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([marks[i].elapsed_time(marks[i + 1])
                            for i in range(steps)]))


def phase_cli(torch, sedt, card, root):
    """Phase 8 (see the module docstring), in a workspace under ``root``
    that phase 9 goes on using. Returns the bank and waveform kernel
    launches of the phase and the workspace."""
    from sound_event_detection_dcase2017_task4_torch import (
        checkpoints, features, main as cli, scoring, sed, sed_fast, serving,
        train)
    from sound_event_detection_dcase2017_task4_torch.config import labels
    from sound_event_detection_dcase2017_task4_torch.data import h5
    from sound_event_detection_dcase2017_task4_torch.data.hdf5 import (
        _quantize_int16, read_split)
    from sound_event_detection_dcase2017_task4_torch.data.synth import (
        make_synthetic_dataset)

    cfg = sedt.config.DEFAULT
    ws = os.path.join(root, "ws")
    walls = {}
    launches = {"logmel": 0, "logmel_bank": 0}

    def counted(stage):
        """Zero the kernel counters before ``stage`` and add them after."""
        class _Stage:
            def __enter__(self):
                _zero_launches()
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                torch.cuda.synchronize()
                walls[stage] = time.perf_counter() - self.t0
                self.b2, self.b1 = _launches("logmel"), _launches("logmel_bank")
                launches["logmel"] += self.b2
                launches["logmel_bank"] += self.b1
                return False
        return _Stage()

    # record every train step's batch index (the resume check) and the
    # state right after a checkpoint is loaded
    seen = {"idx": [], "loaded": None}
    make_train_step, load_checkpoint = train.make_train_step, checkpoints.load_checkpoint

    def recording_make_train_step(*a, **k):
        step = make_train_step(*a, **k)

        def rec(x, y):
            seen["idx"].append(torch.as_tensor(x).numpy().copy())
            return step(x, y)
        return rec

    def recording_load(path, state, opt_config=None):
        out = load_checkpoint(path, state, opt_config)
        seen["loaded"] = checkpoints.state_dict(state)
        return out

    train.make_train_step = recording_make_train_step
    checkpoints.load_checkpoint = recording_load
    try:
        # the plain frontends must not run on the card: count their calls
        with _PlainGuard(torch, cfg) as guard:
            calls, plain = guard.calls, guard.plain

            # 1. pack the corpus on the card
            with counted("pack_synthetic") as st:
                features.main(["pack_synthetic", f"--workspace={ws}",
                               f"--num_train={CLI_TRAIN}", f"--num_test={CLI_TEST}",
                               f"--num_eval={CLI_EVAL}", "--metadata_only"])
            packs = (-(-CLI_TRAIN // 32) + -(-CLI_TEST // 32) + -(-CLI_EVAL // 32))
            if st.b2 != packs or st.b1:
                raise AssertionError(f"pack_synthetic launched {st.b2} waveform / "
                                     f"{st.b1} bank kernels, expected {packs} / 0")
            train_h5 = os.path.join(ws, "features", "training.h5")
            packed = h5.open(train_h5)
            clips = make_synthetic_dataset(8, cfg, seed=0)
            wave8 = np.stack([c.waveform for c in clips])
            with torch.no_grad():
                want = plain["logmel"](torch.from_numpy(wave8).cuda(), cfg)
            got = torch.from_numpy(np.array(packed["feature"][:8])).cuda()
            err_pack, ok = _db_bound_ok(got, want)
            if not ok:
                raise AssertionError(f"packed features vs plain: max |Δ| {err_pack} dB")
            stored = np.array(packed["waveform"][:8])
            if not np.array_equal(stored, _quantize_int16(wave8)):
                raise AssertionError("stored int16 waveforms differ from the clips")
            reader = read_split(train_h5, load_waveform=True)
            if reader.waveform.raw.dtype != np.int16 or not np.array_equal(
                    reader.waveform.raw[:8], stored):
                raise AssertionError("the port's reader does not give the int16 back")
            print(f"[cli] pack_synthetic {CLI_TRAIN}/{CLI_TEST}/{CLI_EVAL} × 10 s in "
                  f"{walls['pack_synthetic']:.3f} s: {st.b2} waveform kernel launches; "
                  f"8 clips' features vs plain max |Δ| {err_pack:.3e} dB (limit 0.1, "
                  "linear within rtol 2e-3); int16 waveforms read back bit for bit")

            # 2. train the flagship over the device cache
            torch.cuda.reset_peak_memory_stats()
            with counted("train") as st:
                run = cli.main(["train", f"--workspace={ws}", *CLI_ARGS,
                                "--dtype=bf16", "--device_cache=on",
                                f"--stop_iteration={CLI_STEPS}",
                                f"--eval_interval={CLI_EVAL_INTERVAL}",
                                f"--eval_max_iteration={CLI_EVAL_MAX}"])
            peak = torch.cuda.max_memory_allocated()
            n_evals = CLI_STEPS // CLI_EVAL_INTERVAL + 1
            per_eval = min(CLI_EVAL_MAX, -(-CLI_TRAIN // CLI_BATCH)) + min(
                CLI_EVAL_MAX, -(-CLI_TEST // CLI_BATCH))
            want_b1 = CLI_STEPS + n_evals * per_eval
            if st.b1 != want_b1 or st.b2:
                raise AssertionError(f"train launched {st.b1} bank / {st.b2} waveform "
                                     f"kernels, expected {want_b1} / 0")
            if any(calls.values()):
                raise AssertionError(f"plain frontend ran on the card: {calls}")
            if run["loss"] is None or not np.isfinite(run["loss"]):
                raise AssertionError(f"train loss {run['loss']}")
            first_idx = list(seen["idx"])
            ckpt_dir = os.path.join(ws, "checkpoints", "main", f"model_type={MODEL}",
                                    *CLI_RUN)
            for it in (CLI_EVAL_INTERVAL, CLI_STEPS):
                for ext in (".pth", ".optjson", ".datastate.pkl"):
                    if not os.path.isfile(os.path.join(ckpt_dir, f"{it}_iterations{ext}")):
                        raise AssertionError(f"missing {it}_iterations{ext}")
            stats_path = os.path.join(ws, "statistics", "main", f"model_type={MODEL}",
                                      *CLI_RUN, "statistics.pickle")
            with open(stats_path, "rb") as f:
                records = pickle.load(f)
            at_keys = {"average_precision", "mAP", "auc", "mAUC", "precision",
                       "recall", "f1", "macro_f1", "macro_precision", "macro_recall",
                       "thresholds"}
            sed_keys = {"f_measure", "error_rate", "overall", "class_wise",
                        "class_wise_average"}
            if sorted(r["iteration"] for r in records) != sorted(
                    2 * list(range(0, CLI_STEPS + 1, CLI_EVAL_INTERVAL))):
                raise AssertionError(
                    f"statistics iterations {[r['iteration'] for r in records]}")
            for r in records:
                if set(r["at"]) != at_keys or (r["data_type"] == "test"
                                               and set(r["sed"]) != sed_keys):
                    raise AssertionError(f"statistics schema: {sorted(r)}")
            steady = [e for e in run["evals"] if e["train_clips_per_s"]]
            print(f"[cli] train {MODEL} bf16 batch {CLI_BATCH}, device cache on, "
                  f"{CLI_STEPS} steps, evals at 0/{CLI_EVAL_INTERVAL}/{CLI_STEPS}: "
                  f"{walls['train']:.3f} s wall; loss {run['loss']:.5f}; bank kernel "
                  f"launches {st.b1} ({CLI_STEPS} steps + {n_evals}×{per_eval} bank "
                  f"eval steps), waveform 0, plain frontend calls 0; peak memory "
                  f"{peak / 2**20:.1f} MiB [{card}]")
            for e in run["evals"]:
                cps = e["train_clips_per_s"]
                print(f"[cli] eval at iter {e['iteration']}: train "
                      f"{e['train_time']:.3f} s since the last eval"
                      f"{'' if cps is None else f' ({cps:.2f} clips/s)'}, eval + "
                      f"checkpoint {e['eval_time']:.3f} s (checkpoint "
                      f"{e['checkpoint_time']:.3f} s) [{card}]")

            # the same step in a bare loop at the same batch: what the CLI's own
            # loop (prefetch thread, stream snapshots, λ draws) adds per step
            bare_ms = _bare_step_ms(torch, cli, ws)
            cli_ms = 1e3 * steady[-1]["train_time"] / CLI_EVAL_INTERVAL
            print(f"[cli] the CLI's step (main._build) in a bare loop at batch "
                  f"{CLI_BATCH}: p50 {bare_ms:.3f} ms ({CLI_BATCH / bare_ms * 1e3:.2f} "
                  f"clips/s, CUDA events); the CLI loop between its last two evals "
                  f"{cli_ms:.3f} ms a step ({CLI_BATCH / cli_ms * 1e3:.2f} clips/s, "
                  f"host clock), {cli_ms / bare_ms:.4f}x the bare step [{card}]")

            # 3. resume from iteration 10 in a copy of the workspace
            ws_r = os.path.join(root, "ws_resume")
            shutil.copytree(ws, ws_r)
            seen["idx"].clear()
            with counted("resume"):
                cli.main(["train", f"--workspace={ws_r}", *CLI_ARGS, "--dtype=bf16",
                          "--device_cache=on", f"--resume_iteration={CLI_EVAL_INTERVAL}",
                          f"--stop_iteration={CLI_EVAL_INTERVAL + 1}",
                          "--eval_interval=1000"])
            saved = torch.load(os.path.join(ckpt_dir, f"{CLI_EVAL_INTERVAL}_iterations.pth"),
                               map_location="cpu", weights_only=True)
            _tensors_equal(seen["loaded"], saved)
            if not np.array_equal(seen["idx"][0], first_idx[CLI_EVAL_INTERVAL]):
                raise AssertionError(f"resumed batch {seen['idx'][0]} vs the "
                                     f"uninterrupted run's {first_idx[CLI_EVAL_INTERVAL]}")
            print(f"[cli] resume from {CLI_EVAL_INTERVAL}_iterations.pth in "
                  f"{walls['resume']:.3f} s: parameters, BatchNorm statistics, Adam "
                  "state, dropout and mixup generators and step equal the "
                  "checkpoint's; the next batch equals the uninterrupted run's "
                  f"step {CLI_EVAL_INTERVAL}")

            # 4. one f32 step from that checkpoint through either transport
            losses = {}
            for mode in ("on", "off"):
                ws_t = os.path.join(root, f"ws_{mode}")
                shutil.copytree(ws, ws_t)
                with counted(f"step_cache_{mode}") as st:
                    losses[mode] = cli.main(
                        ["train", f"--workspace={ws_t}", *CLI_ARGS, "--dtype=f32",
                         f"--device_cache={mode}",
                         f"--resume_iteration={CLI_EVAL_INTERVAL}",
                         f"--stop_iteration={CLI_EVAL_INTERVAL + 1}",
                         "--eval_interval=1000"])["loss"]
                want = (1, 0) if mode == "on" else (0, 1)
                if (st.b1, st.b2) != want:
                    raise AssertionError(f"device cache {mode}: {st.b1} bank / "
                                         f"{st.b2} waveform launches, expected {want}")
                shutil.rmtree(ws_t)
            rel = abs(losses["on"] - losses["off"]) / abs(losses["off"])
            print(f"[cli] one f32 step from iteration {CLI_EVAL_INTERVAL}: loss "
                  f"{losses['on']:.7f} through the bank kernel, {losses['off']:.7f} "
                  f"through host-fed int16 batches and the waveform kernel (rel "
                  f"{rel:.3e}, limit 1e-5)")
            if not rel <= 1e-5:
                raise AssertionError("the two transports disagree")

            # 5. inference, threshold searches and metrics
            for data_type in ("testing", "evaluation"):
                with counted(f"inference_{data_type}") as st:
                    cli.main(["inference", f"--workspace={ws}", *CLI_ARGS,
                              "--dtype=bf16", f"--data_type={data_type}"])
                if st.b2 != 1 or st.b1:
                    raise AssertionError(f"inference {data_type}: {st.b2} waveform / "
                                         f"{st.b1} bank launches, expected 1 / 0")
            for stage in ("optimize_at_thresholds", "optimize_sed_thresholds"):
                with counted(stage):
                    cli.main([stage, f"--workspace={ws}", *CLI_ARGS])
            metrics_json = os.path.join(root, "metrics.json")
            with counted("calculate_metrics"):
                cli.main(["calculate_metrics", f"--workspace={ws}", *CLI_ARGS,
                          "--use_optimized_thresholds", f"--metrics_out={metrics_json}"])
            with open(metrics_json) as f:
                metrics = json.load(f)
            sub = os.path.join(ws, "_submissions", "main", f"model_type={MODEL}",
                               *CLI_RUN, "testing_submission.csv")
            if not os.path.isfile(sub) or metrics["n_clips"] != CLI_TEST:
                raise AssertionError("calculate_metrics wrote no submission or "
                                     "the wrong clip count")
            print(f"[cli] inference testing/evaluation {walls['inference_testing']:.3f}"
                  f" / {walls['inference_evaluation']:.3f} s (1 waveform kernel launch "
                  f"each); optimize_at_thresholds {walls['optimize_at_thresholds']:.3f}"
                  f" s; optimize_sed_thresholds {walls['optimize_sed_thresholds']:.3f} s "
                  f"(numpy search: {CLI_TEST}×1001×17 < 2M); calculate_metrics "
                  f"{walls['calculate_metrics']:.3f} s: mAP {metrics['at']['mAP']:.4f}, "
                  f"segment F1 {metrics['sed']['overall']['f_measure']['f_measure']:.4f}")

            # 6. the device segment scorer against the numpy oracle
            pred_dir = os.path.join(ws, "predictions", "main", f"model_type={MODEL}",
                                    *CLI_RUN)
            with open(os.path.join(pred_dir, "testing.pickle"), "rb") as f:
                preds = pickle.load(f)
            fw, names = preds["framewise_output"], preds["audio_name"]
            gt = scoring.read_ground_truth(os.path.join(
                ws, "synth_dataset", "metadata", "groundtruth_strong_label_testing_set.csv"))
            scorer = sed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100)
            if scorer.device.type != "cuda":
                raise AssertionError(f"the scorer resolved to {scorer.device}")
            rng = np.random.default_rng(8)
            lo_q, hi_q = np.quantile(fw, [0.3, 0.99])
            times = []
            for _ in range(20):
                high = rng.uniform(lo_q, hi_q, len(labels))
                low = high * rng.uniform(0.3, 1.0, len(labels))
                n_smooth, n_salt = (int(v) for v in rng.integers(1, 21, 2))
                t0 = time.perf_counter()
                counts = scorer.segment_counts(high, low, n_smooth, n_salt)
                times.append(time.perf_counter() - t0)
                events = sed.events_from_binary(
                    sed.binarize(fw, high, low, n_smooth, n_salt), 100, labels)
                m = scoring.segment_based_metrics(
                    gt, {names[i]: events[i] for i in range(len(names))}, 10.0, 1.0,
                    labels)
                want = tuple(int(sum(cw[k] for cw in m["class_wise"].values()))
                             for k in ("ntp", "nfp", "nfn"))
                if counts != want:
                    raise AssertionError(f"device scorer counts {counts}, numpy {want}")
            print(f"[cli] sed_fast.DeviceSegmentScorer on the card over {len(names)}"
                  f"×1001×17 predictions: 20 random parameter sets, integer counts "
                  f"== the numpy oracle's; {1e3 * np.median(times):.3f} ms per score "
                  f"(median; first {1e3 * times[0]:.3f} ms) [{card}]")
            _full_size_search(torch, cfg, labels, card)

            # 7. serve the best checkpoint
            run_config = "/".join(CLI_RUN)
            wave = _request(cfg, BATCH, 9)
            with counted("from_workspace") as st:
                pred = serving.Predictor.from_workspace(ws, MODEL, run_config,
                                                        iteration="best")
                out = pred(wave)
            if st.b2 != 1 or pred.device.type != "cuda":
                raise AssertionError(f"from_workspace: {st.b2} launches on {pred.device}")
            best_it = int(sedt.utils.statistics.best_iteration(stats_path)[0])
            model_cpu = checkpoints.load_model(
                os.path.join(ckpt_dir, f"{best_it}_iterations.pth"),
                sedt.get_model(MODEL))
    finally:
        train.make_train_step, checkpoints.load_checkpoint = make_train_step, load_checkpoint
    ref = serving.Predictor(model_cpu, cfg, scalar=sedt.data.load_scalar(
        os.path.join(ws, "scalars", "training.h5")), sed_params=pred.sed_params,
        device="cpu")(wave)
    _check_outputs(out, BATCH, cfg)
    d = max(float(np.abs(out[k] - ref[k]).max())
            for k in ("clipwise_output", "framewise_output"))
    print(f"[cli] Predictor.from_workspace(iteration='best' = {best_it}) served "
          f"{BATCH}×10 s on the card in {walls['from_workspace']:.3f} s (load + "
          f"first request); vs the same checkpoint on the CPU max |Δ| {d:.3e} "
          "(limit 1e-4)")
    if not d <= 1e-4:
        raise AssertionError("from_workspace on the card disagrees with the CPU")
    print("[cli] stage wall times (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()) + f" [{card}]")
    print(f"[cli] launches in the phase: bank kernel {launches['logmel_bank']}, "
          f"waveform kernel {launches['logmel']}")
    return launches, ws


# ---------------------------------------------------------------------------
# phase 14: resume a run the JAX package trained (a .ckpt written here)
# ---------------------------------------------------------------------------
RESUME_N = 7                 # the iteration of the JAX-layout checkpoint
RESUME_STEPS = 3             # bf16 steps the resumed run takes
RESUME_RECIPE = {"learning_rate": 1e-3, "warmup_steps": 20, "grad_clip": 1.0}
RESUME_KEY = (0x1234ABCD, 0x9E3779B9)   # the checkpoint's PRNG key
RESUME_LOOKAHEAD = 2         # batches JAX's prefetch thread draws ahead
RESUME_STEP_CLIPS = 4        # the f32 card-vs-CPU step's batch


def msgpack_pack(obj) -> bytes:
    """``obj`` (dicts with str keys, lists, str, bytes, non-negative ints and
    numpy arrays: what a flax checkpoint holds) as msgpack, each array as
    flax's ext type 1, ``(shape, dtype name, C-order bytes)`` packed in its
    turn, and each dict's keys in sorted order, as
    ``flax.serialization.msgpack_serialize`` writes them (arrays under its
    1 GiB chunk size)."""
    import struct

    out = bytearray()

    def header(n, fix, fix_max, codes):
        if fix is not None and n <= fix_max:
            out.append(fix | n)
            return
        for code, fmt in zip(codes, "BHIQ"):
            if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out.extend(struct.pack(">" + fmt, n))
                return
        raise ValueError(f"msgpack: {n} is too large")

    def pack(o):
        if isinstance(o, int) and not isinstance(o, bool) and o >= 0:
            header(o, 0x00, 0x7F, (0xCC, 0xCD, 0xCE, 0xCF))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            out.extend(b)
        elif isinstance(o, bytes):
            header(len(o), None, -1, (0xC4, 0xC5, 0xC6))
            out.extend(o)
        elif isinstance(o, list):
            header(len(o), 0x90, 15, (None, 0xDC, 0xDD))
            for x in o:
                pack(x)
        elif isinstance(o, dict):
            header(len(o), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in sorted(o.items()):       # flax's order
                if not isinstance(k, str):
                    raise TypeError(f"msgpack: key {k!r} is not a str")
                pack(k)
                pack(v)
        elif isinstance(o, np.ndarray):
            payload = msgpack_pack([list(o.shape), o.dtype.name,
                                    np.ascontiguousarray(o).tobytes()])
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if len(payload) in fixext:
                out.append(fixext[len(payload)])
            else:
                header(len(payload), None, -1, (0xC7, 0xC8, 0xC9))
            out.append(1)                                # flax's ndarray
            out.extend(payload)
        else:
            raise TypeError(f"msgpack: {o!r} is not supported")

    pack(obj)
    return bytes(out)


def flax_tree(tensors: dict) -> dict:
    """The flax ``{"params", "batch_stats"}`` tree of a ``SedCnn`` of conv
    blocks with a BiGRU or none and an attention or average head (the
    flagship's family) from ``{port name: array}``: the inverse of the
    port's weight plan (``weights._plan``). An OIHW conv weight becomes an
    HWIO ``kernel``, a ``weight [out, in]`` a ``kernel [in, out]``, each GRU
    gate's kernel and bias a dense of its own (``GRUCell_0`` forward,
    ``GRUCell_1`` backward); ``bias_hh``'s r and z slices, which flax does
    not have, must be zero. Raises on a name it does not know."""
    params, stats = {}, {}

    def put(tree, keys, value):
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        if keys[-1] in tree:
            raise KeyError(f"flax key {'/'.join(keys)} twice")
        tree[keys[-1]] = np.ascontiguousarray(value, dtype=np.float32)

    for name, v in tensors.items():
        v, parts = np.asarray(v, np.float32), name.split(".")
        if parts[0] == "blocks" and len(parts) == 5:
            _, i, kind, j, leaf = parts
            if kind == "convs" and leaf == "weight":
                put(params, (f"block{i}", f"Conv_{j}", "kernel"),
                    v.transpose(2, 3, 1, 0))
                continue
            where = {"weight": (params, "scale"), "bias": (params, "bias"),
                     "running_mean": (stats, "mean"),
                     "running_var": (stats, "var")}
            if kind == "bns" and leaf in where:
                tree, key = where[leaf]
                put(tree, (f"block{i}", f"BatchNorm_{j}", key), v)
                continue
        elif parts[:2] == ["gru", "rnn"] and len(parts) == 3:
            leaf = parts[2]
            reverse = leaf.endswith("_reverse")
            kind = leaf[:-len("_reverse")] if reverse else leaf
            cell = ("BiGRU_0", "GRUCell_1" if reverse else "GRUCell_0")
            if kind in ("weight_ih_l0", "weight_hh_l0"):
                gates = ("ir", "iz", "in") if kind == "weight_ih_l0" else (
                    "hr", "hz", "hn")
                for g, part in zip(gates, np.split(v.T, 3, axis=1)):
                    put(params, cell + (g, "kernel"), part)
                continue
            if kind == "bias_ih_l0":
                for g, part in zip(("ir", "iz", "in"), np.split(v, 3)):
                    put(params, cell + (g, "bias"), part)
                continue
            if kind == "bias_hh_l0":
                r, z, n = np.split(v, 3)
                if r.any() or z.any():
                    raise ValueError(f"{name}: the r/z slices are not zero")
                put(params, cell + ("hn", "bias"), n)
                continue
        elif len(parts) == 3 and parts[0] == "att_block" and parts[1] in (
                "att", "cla"):
            dense = ("AttBlock_0", "Dense_0" if parts[1] == "att" else "Dense_1")
            put(params, dense + ({"weight": "kernel", "bias": "bias"}[parts[2]],),
                v.T if parts[2] == "weight" else v)
            continue
        elif len(parts) == 2 and parts[0] == "dense":
            put(params, ("Dense_0", {"weight": "kernel", "bias": "bias"}[parts[1]]),
                v.T if parts[1] == "weight" else v)
            continue
        raise KeyError(f"no flax key for {name!r}")
    return {"params": params, "batch_stats": stats}


def jax_ckpt_bytes(tensors: dict, mu: dict, nu: dict, *, count: int,
                   step: int, key, warmup: int, clip: float) -> bytes:
    """A JAX package ``<it>_iterations.ckpt`` (flax ``to_bytes`` of its
    ``TrainState``) holding the port model state ``tensors`` and the Adam
    moments ``mu``, ``nu`` (``{parameter name: array}``), in the
    ``opt_state`` layout of the JAX ``default_optimizer`` for ``warmup``
    and ``clip``: ``(adam, schedule)``, behind an empty clip state when
    ``clip``. Both counts are ``count``; ``key`` is the ``uint32[2]`` PRNG
    key."""
    variables = flax_tree(tensors)
    adam = {"count": np.asarray(count, np.int32),
            "mu": flax_tree(mu)["params"], "nu": flax_tree(nu)["params"]}
    opt = {"0": adam, "1": {"count": np.asarray(count, np.int32)} if warmup else {}}
    if clip:
        opt = {"0": {}, "1": opt}
    return msgpack_pack({"step": np.asarray(step, np.int32),
                         "params": variables["params"],
                         "batch_stats": variables["batch_stats"],
                         "opt_state": opt,
                         "rng": np.asarray(key, np.uint32)})


def resume_state(torch, seed: int = 5):
    """The state a JAX run of the flagship holds at ``RESUME_N``, with the
    weights of the port's seeded init: ``(tensors, mu, nu)`` as numpy,
    BatchNorm statistics and moments drawn from ``seed`` (the GRU's r/z
    moments zero, as training leaves them)."""
    from sound_event_detection_dcase2017_task4_torch.models import (
        MODEL_REGISTRY, SedCnn)

    model = SedCnn(generator=torch.Generator().manual_seed(seed),
                   **MODEL_REGISTRY[MODEL])
    rng = np.random.default_rng(seed)
    tensors = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for k, v in tensors.items():
        if k.endswith("running_mean"):
            tensors[k] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            tensors[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mu = {n: rng.normal(0.0, 1e-3, s).astype(np.float32) for n, s in shapes.items()}
    nu = {n: (1e-6 * rng.random(s)).astype(np.float32) for n, s in shapes.items()}
    for moments in (mu, nu):
        for n, m in moments.items():
            if n.startswith("gru.rnn.bias_hh"):
                m[: 2 * m.shape[0] // 3] = 0.0
    return tensors, mu, nu


def phase_jax_resume(torch, sedt, card, root, cli_ws):
    """Phase 14 (see the module docstring), in a fresh workspace on phase
    8's corpus. Returns each kernel's launches on its main path."""
    from sound_event_detection_dcase2017_task4_torch import (
        checkpoints, main as cli, train)
    from sound_event_detection_dcase2017_task4_torch.data import (
        DataGenerator, load_scalar, read_split)
    from sound_event_detection_dcase2017_task4_torch.models import (
        MODEL_REGISTRY, SedCnn)
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

    cfg = sedt.config.DEFAULT
    ws = os.path.join(root, "ws_jax")
    os.makedirs(ws)
    for d in ("features", "scalars", "synth_dataset"):
        os.symlink(os.path.join(cli_ws, d), os.path.join(ws, d))
    ckpt_dir = os.path.join(ws, "checkpoints", "main", f"model_type={MODEL}",
                            *CLI_RUN)
    os.makedirs(ckpt_dir)
    base = os.path.join(ckpt_dir, f"{RESUME_N}_iterations")
    path = base + ".ckpt"

    # what a JAX run of the flagship leaves at RESUME_N: .ckpt, .optjson and
    # the stream position its prefetch thread had drawn to
    t0 = time.perf_counter()
    tensors, mu, nu = resume_state(torch)
    with open(path, "wb") as f:
        f.write(jax_ckpt_bytes(tensors, mu, nu, count=RESUME_N, step=RESUME_N,
                               key=RESUME_KEY, warmup=RESUME_RECIPE["warmup_steps"],
                               clip=RESUME_RECIPE["grad_clip"]))
    t_write = time.perf_counter() - t0
    with open(base + ".optjson", "w") as f:
        json.dump(RESUME_RECIPE, f)
    reader = read_split(os.path.join(ws, "features", "training.h5"),
                        load_waveform=True)

    def generator():
        return DataGenerator(reader, batch_size=CLI_BATCH, seed=1234,
                             feature_source="waveform")

    gen = generator()
    stream = gen.generate_train(yield_indices=True)
    for _ in range(RESUME_N + RESUME_LOOKAHEAD):
        next(stream)
    position = gen.state_dict()
    with open(base + ".datastate.pkl", "wb") as f:
        pickle.dump(position, f)
    print(f"[jax-resume] wrote a JAX-layout {MODEL} checkpoint at iteration "
          f"{RESUME_N} ({os.path.getsize(path)} bytes of flax msgpack, "
          f"{t_write:.3f} s; opt_state clip → (adam, schedule) for "
          f"{RESUME_RECIPE}), its .optjson and a .datastate.pkl "
          f"{RESUME_LOOKAHEAD} batches ahead")

    seen = {"idx": [], "events": [], "imported": None}
    make_train_step = train.make_train_step
    import_state = checkpoints.import_jax_train_state

    def recording_make_train_step(*a, **k):
        step = make_train_step(*a, **k)

        def rec(x, y):
            seen["idx"].append(torch.as_tensor(x).numpy().copy())
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(x, y)
            stop.record()
            seen["events"].append((start, stop))
            return out
        return rec

    def timed_import(p, state, opt_config=None):
        t0 = time.perf_counter()
        out = import_state(p, state, opt_config)
        torch.cuda.synchronize()
        seen["import_s"] = time.perf_counter() - t0
        seen["imported"] = {
            "device": state.device, "step": state.step,
            "lr": state.optimizer.param_groups[0]["lr"],
            "last_epoch": state.scheduler.last_epoch,
            "model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "opt": {n: {k: v.detach().cpu().clone()
                        for k, v in state.optimizer.state[p].items()}
                    for n, p in state.model.named_parameters()}}
        return out

    train.make_train_step = recording_make_train_step
    checkpoints.import_jax_train_state = timed_import
    try:
        with _PlainGuard(torch, cfg) as guard:
            # ---- the main path: counters zeroed just before, read just after
            _zero_launches()
            t0 = time.perf_counter()
            run = cli.main(["train", f"--workspace={ws}", *CLI_ARGS, "--dtype=bf16",
                            "--device_cache=on", f"--resume_iteration={RESUME_N}",
                            f"--stop_iteration={RESUME_N + RESUME_STEPS}",
                            "--eval_interval=1000"])
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            launches = {"logmel": _launches("logmel"),
                        "logmel_bank": _launches("logmel_bank")}
            # ------------------------------------------------------------------
            _zero_launches()
            t0 = time.perf_counter()
            cli.main(["inference", f"--workspace={ws}", *CLI_ARGS, "--dtype=bf16",
                      "--data_type=testing"])
            torch.cuda.synchronize()
            t_inf = time.perf_counter() - t0
            inf_launches = {"logmel": _launches("logmel"),
                            "logmel_bank": _launches("logmel_bank")}
            # ------------------------------------------------------------------
            calls = dict(guard.calls)
    finally:
        train.make_train_step = make_train_step
        checkpoints.import_jax_train_state = import_state
    if launches != {"logmel": 0, "logmel_bank": RESUME_STEPS}:
        raise AssertionError(f"the resumed run launched {launches}, expected "
                             f"{RESUME_STEPS} bank kernels and no waveform one")
    n_inf = -(-CLI_TEST // CLI_BATCH)
    if inf_launches != {"logmel": n_inf, "logmel_bank": 0}:
        raise AssertionError(f"inference launched {inf_launches}")
    if any(calls.values()):
        raise AssertionError(f"plain frontend ran on the card: {calls}")
    if run["iteration"] != RESUME_N + RESUME_STEPS or not np.isfinite(run["loss"]):
        raise AssertionError(f"the resumed run returned {run}")

    # the import against the tree written, bit for bit
    got = seen["imported"]
    if got["device"].type != "cuda" or got["step"] != RESUME_N:
        raise AssertionError(f"imported on {got['device']} at step {got['step']}")
    for k, v in tensors.items():
        if not torch.equal(got["model"][k], torch.from_numpy(v)):
            raise AssertionError(f"imported {k} differs from the checkpoint's")
    for n in mu:
        s = got["opt"][n]
        if not (torch.equal(s["exp_avg"], torch.from_numpy(mu[n]))
                and torch.equal(s["exp_avg_sq"], torch.from_numpy(nu[n]))
                and float(s["step"]) == RESUME_N):
            raise AssertionError(f"imported Adam state of {n} differs")
    want_lr = RESUME_RECIPE["learning_rate"] * RESUME_N / RESUME_RECIPE["warmup_steps"]
    if got["last_epoch"] != RESUME_N or abs(got["lr"] - want_lr) > 1e-12 * want_lr:
        raise AssertionError(f"the schedule resumed at {got['last_epoch']}, "
                             f"lr {got['lr']} (want {want_lr})")
    # the stream: the batches a generator loaded from the .datastate.pkl draws
    gen = generator()
    gen.load_state_dict(position)
    stream = gen.generate_train(yield_indices=True)
    want_idx = [next(stream)[0] for _ in range(RESUME_STEPS)]
    if len(seen["idx"]) != RESUME_STEPS or not all(
            np.array_equal(a, b) for a, b in zip(seen["idx"], want_idx)):
        raise AssertionError(f"resumed batches {seen['idx']} vs the "
                             f"generator's {want_idx}")
    ckpt = torch.load(os.path.join(ckpt_dir, f"{RESUME_N + RESUME_STEPS}_iterations.pth"),
                      map_location="cpu", weights_only=True)
    if {float(s["step"]) for s in ckpt["optimizer"]["state"].values()} != {
            RESUME_N + RESUME_STEPS} or ckpt["step"] != RESUME_N + RESUME_STEPS:
        raise AssertionError("the resumed run's checkpoint has the wrong counts")
    pred_path = os.path.join(ws, "predictions", "main", f"model_type={MODEL}",
                             *CLI_RUN, "testing.pickle")
    with open(pred_path, "rb") as f:
        preds = pickle.load(f)
    c, f = preds["clipwise_output"], preds["framewise_output"]
    if (c.shape != (CLI_TEST, cfg.classes_num)
            or f.shape != (CLI_TEST, cfg.frames_num, cfg.classes_num)
            or not (np.isfinite(c).all() and np.isfinite(f).all())
            or not (0.0 <= c.min() and c.max() <= 1.0)):
        raise AssertionError(f"inference after the resume: {c.shape}, {f.shape}")
    step_ms = [a.elapsed_time(b) for a, b in seen["events"]]
    print(f"[jax-resume] main train --resume_iteration={RESUME_N} on the .ckpt, "
          f"bf16, batch {CLI_BATCH}, device cache on: {RESUME_STEPS} steps in "
          f"{t_train:.3f} s wall, loss {run['loss']:.5f}; bank kernel launches "
          f"{launches['logmel_bank']}, waveform 0, plain frontend calls 0")
    print(f"[jax-resume] import_jax_train_state {seen['import_s']:.3f} s; the "
          f"first resumed step {step_ms[0]:.3f} ms, then "
          + ", ".join(f"{ms:.3f}" for ms in step_ms[1:])
          + f" ms (CUDA events) [{card}]")
    print(f"[jax-resume] after the import: {len(tensors)} variables, "
          f"{len(mu)} × (exp_avg, exp_avg_sq) and the counts equal the tree "
          f"written bit for bit (step {RESUME_N}, lr {got['lr']:.3e} = "
          f"{RESUME_N}/{RESUME_RECIPE['warmup_steps']} of "
          f"{RESUME_RECIPE['learning_rate']}); the first {RESUME_STEPS} batches "
          "equal a generator's loaded from the .datastate.pkl")
    print(f"[jax-resume] inference on {RESUME_N + RESUME_STEPS}_iterations.pth "
          f"in {t_inf:.3f} s: {inf_launches['logmel']} waveform kernel launch(es), "
          f"predictions {preds['clipwise_output'].shape} finite")

    # the kernels against their plain versions at this path's shapes
    scale = float(reader.waveform.scale)
    bank = torch.from_numpy(np.ascontiguousarray(stft.prepare_chunks(
        np.ascontiguousarray(reader.waveform.raw), cfg))).cuda()
    idx = seen["idx"][0]
    got_b = logmel_cuda.logmel_cuda_bank(bank, idx, cfg, wave_scale=scale)
    want_b = stft.logmel_bank(bank, idx, cfg, wave_scale=scale)
    err_b, ok_b = _db_bound_ok(got_b, want_b)
    test_reader = read_split(os.path.join(ws, "features", "testing.h5"),
                             load_waveform=True)
    wave = torch.from_numpy(np.asarray(
        test_reader.waveform[np.arange(min(CLI_BATCH, CLI_TEST))], np.float32))
    err_w, ok_w = _db_bound_ok(logmel_cuda.logmel_cuda(wave.cuda(), cfg),
                               stft.logmel(wave.cuda(), cfg))
    print(f"[jax-resume] bank kernel vs plain on the first resumed batch "
          f"({len(idx)} of {bank.shape[0]} staged clips): max |Δ| {err_b:.3e} "
          f"dB; waveform kernel vs plain on the inference batch "
          f"{list(wave.shape)}: {err_w:.3e} dB (limit 0.1, linear within rtol 2e-3)")
    if not (ok_b and ok_w):
        raise AssertionError("a kernel disagrees with its plain version")

    # the first resumed step in f32, TF32 off: the card against the CPU
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rows = seen["idx"][0][:RESUME_STEP_CLIPS]
    bank4 = np.ascontiguousarray(stft.prepare_chunks(
        np.ascontiguousarray(reader.waveform.raw[rows]), cfg))
    scalar = load_scalar(os.path.join(ws, "scalars", "training.h5"))

    def first_step(device):
        model = SedCnn(dropout=0.0, **MODEL_REGISTRY[MODEL])
        state = train.create_train_state(
            model, cfg, device=device,
            learning_rate=RESUME_RECIPE["learning_rate"],
            warmup_steps=RESUME_RECIPE["warmup_steps"],
            grad_clip=RESUME_RECIPE["grad_clip"])
        checkpoints.import_jax_train_state(path, state, opt_config=RESUME_RECIPE)
        step = train.make_train_step(
            model, state, scalar=scalar, mixup_alpha=1.0,
            bank=torch.from_numpy(bank4).to(device), wave_scale=scale,
            bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=scale))
        m = step(np.arange(len(rows)), reader.target[rows])
        return float(m["loss"]), float(m["grad_norm"]), {
            k: v.detach().cpu() for k, v in model.state_dict().items()
            if "running" in k}

    try:
        gpu, cpu = first_step("cuda"), first_step("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    d_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    d_norm = abs(gpu[1] - cpu[1]) / abs(cpu[1])
    d_stats = max(float(((gpu[2][k] - cpu[2][k]).abs()
                         / (1e-5 + 1e-4 * cpu[2][k].abs())).max()) for k in cpu[2])
    print(f"[jax-resume] the first resumed step in f32 (TF32 off, dropout 0, "
          f"mixup λ from the key-seeded generator), {len(rows)} clips, card vs "
          f"CPU: loss {gpu[0]:.7f} vs {cpu[0]:.7f} (rel {d_loss:.3e}, limit "
          f"2e-5), grad-norm {gpu[1]:.6f} vs {cpu[1]:.6f} (rel {d_norm:.3e}, "
          f"limit 1e-4), BN running statistics at {d_stats:.3f} of rtol 1e-4 / "
          "atol 1e-5")
    if not (d_loss <= 2e-5 and d_norm <= 1e-4 and d_stats <= 1.0):
        raise AssertionError("the resumed step on the card disagrees with the CPU")
    return {"logmel": inf_launches["logmel"], "logmel_bank": launches["logmel_bank"]}


# ---------------------------------------------------------------------------
# phase 9: the rest of the zoo
# ---------------------------------------------------------------------------
ZOO = ("Cnn_9layers_Glu_AttPooling", "Cnn_9layers_Transformer_FrameAtt")
ZOO_STEPS = 10
ZOO_CLI_STEPS = 5


def _zoo_model(torch, name, dtype, dropout=0.2, remat=False):
    """``name`` at full width from seed 0 (the same weights whatever
    ``dtype``, ``dropout`` and ``remat``); ``dropout=0`` also zeroes the
    Transformer layers' own rate."""
    from sound_event_detection_dcase2017_task4_torch.models import (
        MODEL_REGISTRY, SedCnn)

    model = SedCnn(dtype=dtype, dropout=dropout, remat=remat,
                   generator=torch.Generator().manual_seed(0),
                   **MODEL_REGISTRY[name])
    if dropout == 0.0:
        for layer in model.transformer or ():
            layer.dropout = 0.0
    return model


def _calibrate(torch, model, feats):
    """Set every BatchNorm's running statistics to those of ``feats`` (one
    train-mode forward with momentum 0, on the card). At its seed
    statistics (mean 0, var 1) the gated GLU stack shrinks the signal to
    ~1e-5 of the probabilities by the head, so its outputs would hardly
    depend on the input."""
    from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    with torch.no_grad():
        model.cuda()(feats, train=True,
                     generator=torch.Generator(device="cuda").manual_seed(0))
    for bn in bns:
        bn.momentum = 0.9


def _zoo_serve(torch, sedt, card, name, wave, scalar):
    """A Predictor of ``name`` on the card in f32 and bf16; returns the
    waveform kernel launches of its main path. The GLU serves with
    BatchNorm statistics calibrated on the request (:func:`_calibrate`);
    either model's clipwise outputs must spread over the request's clips."""
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    model = _zoo_model(torch, name, torch.float32, 0.0)
    if model.block == "glu":
        mean, std = (torch.from_numpy(a).cuda() for a in scalar)
        _calibrate(torch, model,
                   (stft.logmel(torch.from_numpy(wave).cuda(), cfg) - mean) / std)
    cpu_model = copy.deepcopy(model).cpu()
    n_params = sum(p.numel() for p in model.parameters())
    pred = sedt.Predictor(model, cfg, scalar=scalar)
    model16 = _zoo_model(torch, name, torch.bfloat16, 0.0)
    model16.load_state_dict(model.state_dict())
    pred16 = sedt.Predictor(model16, cfg, scalar=scalar)
    if (pred.device.type, pred16.device.type) != ("cuda", "cuda"):
        raise AssertionError(f"Predictor resolved to {pred.device}")
    calls = 2 + 2 * 23                       # 2 checked + 2 × (3 + 20) timed
    # ---- the main path: counters zeroed just before, read just after ----
    with _PlainGuard(torch, cfg) as guard:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        out = pred(wave)
        lat32 = _p50_latency(pred, wave)
        mem = torch.cuda.max_memory_allocated()
        out16 = pred16(wave)
        lat16 = _p50_latency(pred16, wave)
        torch.cuda.synchronize()
        launches, bank_launches = _launches("logmel"), _launches("logmel_bank")
    # ----------------------------------------------------------------------
    if launches != calls or bank_launches:
        raise AssertionError(f"{name} serving: {launches} waveform / "
                             f"{bank_launches} bank launches for {calls} requests")
    if any(guard.calls.values()):
        raise AssertionError(f"plain frontend ran on the card: {guard.calls}")
    _check_outputs(out, BATCH, cfg)
    _check_outputs(out16, BATCH, cfg)
    ref = sedt.Predictor(cpu_model, cfg, scalar=scalar, device="cpu")(wave[:2])
    d_cpu = max(float(np.abs(ref[k] - out[k][:2]).max())
                for k in ("clipwise_output", "framewise_output"))
    d16 = max(float(np.abs(out16[k] - out[k]).max())
              for k in ("clipwise_output", "framewise_output"))
    clip = out["clipwise_output"]
    spread = float((clip.max(0) - clip.min(0)).max())
    print(f"[zoo] {name} ({n_params} params) serves {BATCH}×10 s on the card: "
          f"{launches} waveform kernel launches for {calls} requests, plain "
          f"frontend calls 0; clipwise spread over the clips {spread:.3e} "
          f"(at least 1e-2); card vs CPU (2 clips, f32) max |Δ| {d_cpu:.3e} "
          f"(limit 1e-4); bf16 vs f32 max |Δ| {d16:.3e} (limit {BF16_ATOL})")
    if not spread >= 1e-2:
        raise AssertionError(f"{name}: the outputs hardly depend on the input")
    if not d_cpu <= 1e-4:
        raise AssertionError(f"{name}: card and CPU disagree")
    if not d16 <= BF16_ATOL:
        raise AssertionError(f"{name}: the bf16 model strays from the f32 one")
    print(f"[zoo] {name} request {BATCH}×10 s p50 latency: f32 {lat32:.3f} ms "
          f"({BATCH / lat32 * 1e3:.2f} clips/s), bf16 {lat16:.3f} ms "
          f"({BATCH / lat16 * 1e3:.2f} clips/s); peak memory (f32) "
          f"{mem / 2**20:.1f} MiB [{card}]")
    return launches


def _zoo_train(torch, sedt, card, name, bank, targets, scale, scalar, remat,
               profile):
    """``ZOO_STEPS`` bf16 steps of ``name`` at batch 128 over the bank with
    SpecAugment and mixup; returns the bank kernel launches, the p50 step
    time and the peak memory."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    model = _zoo_model(torch, name, torch.bfloat16, remat=remat)
    state = train.create_train_state(model, cfg, seed=0)    # device → cuda
    bank_fn = stft.make_logmel_bank_fn(cfg, precision="fast", wave_scale=scale)
    step = train.make_train_step(
        model, state, scalar=scalar, mixup_alpha=1.0, use_spec_augment=True,
        check_numerics=True, bank=bank, wave_scale=scale, bank_frontend=bank_fn)
    sampler = np.random.default_rng(6)
    batches = [np.sort(sampler.choice(BANK_CLIPS, TRAIN_BATCH, replace=False))
               for _ in range(ZOO_STEPS + 2)]
    # ---- the main path: counters zeroed just before, read just after ----
    with _PlainGuard(torch, cfg) as guard:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(ZOO_STEPS + 1)]
        metrics = []
        marks[0].record()
        for i in range(ZOO_STEPS):
            metrics.append(step(batches[i], targets[batches[i]]))
            marks[i + 1].record()
        torch.cuda.synchronize()
        launches, waveform = _launches("logmel_bank"), _launches("logmel")
        peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------
    losses = [float(m["loss"]) for m in metrics]
    bad = sum(int(m["nonfinite_count"]) for m in metrics)
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(ZOO_STEPS)]
    if launches != ZOO_STEPS or waveform:
        raise AssertionError(f"{name} training: {launches} bank / {waveform} "
                             f"waveform launches for {ZOO_STEPS} steps")
    if any(guard.calls.values()):
        raise AssertionError(f"plain frontend ran on the card: {guard.calls}")
    if not np.isfinite(losses).all() or bad:
        raise AssertionError(f"{name}: non-finite training {losses}, {bad}")
    p50 = float(np.median(step_ms))
    tag = "remat on" if remat else "remat off"
    print(f"[zoo] {name} bf16 train, batch {TRAIN_BATCH} over the bank, "
          f"SpecAugment + mixup α=1, {tag}: {ZOO_STEPS} steps, bank kernel "
          f"launches {launches}, plain frontend calls 0, loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}")
    print(f"[zoo] {name} {tag}: step time p50 {p50:.3f} ms (CUDA events; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, first {step_ms[0]:.3f}),"
          f" {TRAIN_BATCH / p50 * 1e3:.2f} clips/s; peak memory "
          f"{peak / 2**20:.1f} MiB [{card}]")
    if profile:
        i = ZOO_STEPS
        wall_ms, rows = _device_kernels(
            torch, lambda: step(batches[i], targets[batches[i]]))
        busy = sum(r[0] for r in rows)
        print(f"[zoo-profile] {name} one bf16 train step: device time "
              f"{busy:.4f} ms in {len(rows)} kernels/copies, {wall_ms:.3f} ms "
              f"wall under the profiler; idle ≈ "
              f"{100 * max(0.0, 1 - busy / p50):.1f}% of the p50 step")
        for ms, count, key in rows[:10]:
            print(f"[zoo-profile] {ms:9.4f} ms {count:5d}x  {key[:110]}")
        _, ops = _device_kernels(
            torch, lambda: step(batches[i + 1], targets[batches[i + 1]]),
            by_op=True)
        for ms, count, key in ops[:12]:
            print(f"[zoo-profile-op] {ms:9.4f} ms {count:5d}x  {key[:90]}")
    del step, state, model
    torch.cuda.empty_cache()
    return launches, p50, peak


def _steps_agree(a, b, what):
    """Raise unless two ``_one_step`` results agree at the ground-rule
    tolerances (loss rtol 2e-5, grad-norm 1e-4, BN statistics rtol 1e-4 /
    atol 1e-5)."""
    d_loss = abs(a[0] - b[0]) / abs(b[0])
    d_norm = abs(a[1] - b[1]) / abs(b[1])
    d_stats = max(float(((a[2][k] - b[2][k]).abs()
                         / (1e-5 + 1e-4 * b[2][k].abs())).max()) for k in b[2])
    print(f"[zoo] {what}: loss {a[0]:.7f} vs {b[0]:.7f} (rel {d_loss:.3e}, limit "
          f"2e-5), grad-norm {a[1]:.6f} vs {b[1]:.6f} (rel {d_norm:.3e}, limit "
          f"1e-4), BN running statistics at {d_stats:.3f} of rtol 1e-4 / atol 1e-5")
    if not (d_loss <= 2e-5 and d_norm <= 1e-4 and d_stats <= 1.0):
        raise AssertionError(f"{what}: the steps disagree")


def _zoo_cli(torch, sedt, card, ws):
    """``main train`` of the Transformer with SpecAugment, mixup and
    ``--remat`` in phase 8's workspace, then ``inference``; returns the
    launches of both kernels."""
    from sound_event_detection_dcase2017_task4_torch import main as cli

    cfg = sedt.config.DEFAULT
    name = ZOO[1]
    args = [f"--model_type={name}", "--feature_source=waveform",
            "--augmentation=mixup_specaugment", f"--batch_size={CLI_BATCH}",
            "--dtype=bf16"]
    run_dir = (f"model_type={name}", "loss_type=clip_bce",
               "augmentation=mixup_specaugment", f"batch_size={CLI_BATCH}")
    per_eval = min(CLI_EVAL_MAX, -(-CLI_TRAIN // CLI_BATCH)) + min(
        CLI_EVAL_MAX, -(-CLI_TEST // CLI_BATCH))
    with _PlainGuard(torch, cfg) as guard:
        _zero_launches()
        t0 = time.perf_counter()
        run = cli.main(["train", f"--workspace={ws}", *args, "--remat",
                        "--device_cache=on", f"--stop_iteration={ZOO_CLI_STEPS}",
                        f"--eval_interval={ZOO_CLI_STEPS}",
                        f"--eval_max_iteration={CLI_EVAL_MAX}"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        train_b1, train_b2 = _launches("logmel_bank"), _launches("logmel")
        _zero_launches()
        t0 = time.perf_counter()
        cli.main(["inference", f"--workspace={ws}", *args, "--data_type=testing"])
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        inf_b1, inf_b2 = _launches("logmel_bank"), _launches("logmel")
    want_b1 = ZOO_CLI_STEPS + 2 * per_eval
    if (train_b1, train_b2, inf_b1, inf_b2) != (want_b1, 0, 0, 1):
        raise AssertionError(f"CLI launches: train {train_b1} bank / {train_b2} "
                             f"waveform (expected {want_b1} / 0), inference "
                             f"{inf_b1} / {inf_b2} (expected 0 / 1)")
    if any(guard.calls.values()):
        raise AssertionError(f"plain frontend ran on the card: {guard.calls}")
    if run["loss"] is None or not np.isfinite(run["loss"]):
        raise AssertionError(f"train loss {run['loss']}")
    ckpt_dir = os.path.join(ws, "checkpoints", "main", *run_dir)
    with open(os.path.join(ckpt_dir, f"{ZOO_CLI_STEPS}_iterations.optjson")) as f:
        recipe = json.load(f)
    if recipe != {"learning_rate": 1e-3, "warmup_steps": 500, "grad_clip": 1.0}:
        raise AssertionError(f"the Transformer's recipe: {recipe}")
    with open(os.path.join(ws, "predictions", "main", *run_dir,
                           "testing.pickle"), "rb") as f:
        preds = pickle.load(f)
    c = preds["clipwise_output"]
    if c.shape != (CLI_TEST, cfg.classes_num) or not np.isfinite(c).all():
        raise AssertionError(f"inference predictions {c.shape}")
    print(f"[zoo] main train {name} --augmentation=mixup_specaugment --remat, "
          f"bf16 batch {CLI_BATCH}, {ZOO_CLI_STEPS} steps with evals at 0 and "
          f"{ZOO_CLI_STEPS}: {t_train:.3f} s, loss {run['loss']:.5f}, recipe "
          f"{recipe}; bank kernel launches {train_b1} ({ZOO_CLI_STEPS} steps + "
          f"2×{per_eval} eval steps); inference testing {t_inf:.3f} s, 1 "
          f"waveform launch; plain frontend calls 0 [{card}]")
    return {"logmel": train_b2 + inf_b2, "logmel_bank": train_b1 + inf_b1}


def phase_zoo(torch, sedt, card, bank, targets, scale, ws):
    """Phase 9 (see the module docstring). Returns the launches of both
    kernels in the phase."""
    cfg = sedt.config.DEFAULT
    rng = np.random.default_rng(1)
    serve_scalar = (rng.normal(-30.0, 5.0, cfg.mel_bins).astype(np.float32),
                    rng.normal(15.0, 2.0, cfg.mel_bins).astype(np.float32))
    train_scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
                    np.full(cfg.mel_bins, 15.0, np.float32))
    wave = _request(cfg, BATCH, 10)
    launches = {"logmel": 0, "logmel_bank": 0}
    summary = []
    for name in ZOO:
        launches["logmel"] += _zoo_serve(torch, sedt, card, name, wave,
                                         serve_scalar)
        for remat in ((False, True) if name == ZOO[0] else (False,)):
            b1, p50, peak = _zoo_train(torch, sedt, card, name, bank, targets,
                                       scale, train_scalar, remat,
                                       profile=not remat)
            launches["logmel_bank"] += b1
            summary.append((name, remat, p50, peak))
        # f32, every dropout 0, 2 clips: the card against the CPU
        idx2 = np.array([5, 77])
        y2 = targets[idx2]
        gpu = _one_step(torch, sedt, cfg, _zoo_model(torch, name, torch.float32, 0.0),
                        "cuda", bank, idx2, y2, train_scalar, scale)
        cpu = _one_step(torch, sedt, cfg, _zoo_model(torch, name, torch.float32, 0.0),
                        "cpu", bank[torch.from_numpy(idx2).cuda()].cpu(),
                        np.arange(2), y2, train_scalar, scale)
        _steps_agree(gpu, cpu, f"{name} f32 step, card vs CPU, 2 clips")
        if name == ZOO[0]:
            rem = _one_step(torch, sedt, cfg,
                            _zoo_model(torch, name, torch.float32, 0.0, remat=True),
                            "cuda", bank, idx2, y2, train_scalar, scale)
            _steps_agree(rem, gpu, f"{name} f32 step on the card, remat on vs off")
    cli = _zoo_cli(torch, sedt, card, ws)
    for k in launches:
        launches[k] += cli[k]
    for name, remat, p50, peak in summary:
        print(f"[zoo] summary {name} remat={'on' if remat else 'off'}: train p50 "
              f"{p50:.3f} ms, {TRAIN_BATCH / p50 * 1e3:.2f} clips/s, peak "
              f"{peak / 2**20:.1f} MiB [{card}]")
    print(f"[zoo] launches in the phase: bank kernel {launches['logmel_bank']}, "
          f"waveform kernel {launches['logmel']}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: runme.sh stages 1 and 4
# ---------------------------------------------------------------------------
RESAMPLED_RATE = 44100
SPLITS = {"training": CLI_TRAIN, "testing": CLI_TEST, "evaluation": CLI_EVAL}
PACK_BATCH = 32                      # the subcommand's default --batch_size


def _pcm16(path):
    import wave

    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _decode_s(decoder, paths, cfg):
    """Host seconds to decode ``paths`` alone, as the subcommand does: the
    native decoder in chunks of 64, or the Python loader file by file."""
    from sound_event_detection_dcase2017_task4_torch import audio_io, native

    t0 = time.perf_counter()
    if decoder == "native":
        for i in range(0, len(paths), 64):
            native.load_wav_batch(paths[i:i + 64], cfg.sample_rate, cfg.clip_samples)
    else:
        for p in paths:
            audio_io.load_wav(p, target_sr=cfg.sample_rate)
    return time.perf_counter() - t0


def _pack_batch_device_ms(torch, logmel_fn, rows, reps=5):
    """The device's time for what a pack does with one batch — the copy of
    ``rows`` to the card, the log-mel kernel, the copy of the features back
    — each between CUDA events; medians over ``reps`` after a warm-up."""
    times = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.from_numpy(rows).to("cuda")
        ev[1].record()
        y = logmel_fn(x)
        ev[2].record()
        y.cpu()
        ev[3].record()
        torch.cuda.synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    return [float(t) for t in np.median(times[1:], axis=0)]


def phase_runme(torch, sedt, card, root, cli_ws):
    """Phase 10 (see the module docstring) in workspaces under ``root``;
    ``cli_ws`` is phase 8's workspace, which stage 4 reads. Returns the
    waveform kernel's launches in the phase."""
    import contextlib
    import io

    from sound_event_detection_dcase2017_task4_torch import (audio_io, features,
                                                             native, plot_results)
    from sound_event_detection_dcase2017_task4_torch.data.hdf5 import (load_scalar,
                                                                       read_split)
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    ws = os.path.join(root, "runme")
    dataset = os.path.join(ws, "synth_dataset")
    t0 = time.perf_counter()
    native.build()
    print(f"[runme] built csrc/sedx_native.cc with g++ "
          f"{' '.join(native.CXX_FLAGS + native.LINK_FLAGS)} in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}

    def counted(tag, argv):
        """Zero the waveform counter, run ``features.main(argv)`` on the
        card, read the counter; returns the wall time."""
        _zero_launches()
        t0 = time.perf_counter()
        features.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[tag] = _launches("logmel")
        if _launches("logmel_bank"):
            raise AssertionError(f"{tag}: {_launches('logmel_bank')} bank launches")
        return wall

    def stage1(split, out_ws, dataset_dir, decoder):
        tag = f"{split}_{decoder}_{os.path.basename(dataset_dir)}"
        wall = counted(tag, [
            "calculate_feature_for_all_audio_files", f"--dataset_dir={dataset_dir}",
            f"--workspace={out_ws}", f"--data_type={split}", "--use_pallas",
            *(["--no_native"] if decoder == "python" else [])])
        want = -(-SPLITS[split] // PACK_BATCH)
        if launches[tag] != want:
            raise AssertionError(f"stage 1 {tag}: {launches[tag]} waveform "
                                 f"launches, expected {want}")
        return wall, read_split(os.path.join(out_ws, "features", f"{split}.h5"),
                                load_waveform=True)

    with _PlainGuard(torch, cfg) as guard:
        # the WAVs (and pack_synthetic's own features, the reference for
        # names and targets)
        wall = counted("pack_synthetic", [
            "pack_synthetic", f"--workspace={ws}", f"--num_train={CLI_TRAIN}",
            f"--num_test={CLI_TEST}", f"--num_eval={CLI_EVAL}"])
        print(f"[runme] pack_synthetic {CLI_TRAIN}/{CLI_TEST}/{CLI_EVAL} × 10 s "
              f"with WAVs in {wall:.3f} s: {launches['pack_synthetic']} waveform "
              "launches")

        # stage 1, each split through both decoders
        packed, walls = {}, {}
        for split, n in SPLITS.items():
            paths = [os.path.join(dataset, "audio", split, name) for name in
                     read_split(os.path.join(ws, "features", f"{split}.h5")).audio_names]
            line = []
            for decoder in ("native", "python"):
                out_ws = os.path.join(root, f"stage1_{decoder}")
                wall, packed[split, decoder] = stage1(split, out_ws, dataset, decoder)
                walls[split, decoder] = wall
                dec = _decode_s(decoder, paths, cfg)
                line.append(f"{'native' if decoder == 'native' else '--no_native'} "
                            f"{wall:.3f} s ({n / wall:.2f} clips/s; decoding alone "
                            f"{dec:.3f} s, {100 * dec / wall:.1f}%)")
            print(f"[runme] stage 1 {split} ({n} × 10 s WAVs at {cfg.sample_rate} "
                  f"Hz, batch {PACK_BATCH}, {launches[f'{split}_native_synth_dataset']}"
                  f" waveform launches each): " + "; ".join(line) + f" [{card}]")

        # what stage 1 wrote: pack_synthetic's names and targets, the WAVs'
        # PCM, features of the card's kernel against the plain CPU frontend
        for split in SPLITS:
            ref = read_split(os.path.join(ws, "features", f"{split}.h5"))
            got, alt = packed[split, "native"], packed[split, "python"]
            if got.audio_names != ref.audio_names or not np.array_equal(
                    got.target, ref.target):
                raise AssertionError(f"{split}: names or targets differ from "
                                     "pack_synthetic's")
            raw = got.waveform.raw
            if raw.dtype != np.int16 or got.waveform.scale != 2.0 ** -15:
                raise AssertionError(f"{split}: waveform {raw.dtype}")
            for name, row in zip(got.audio_names, raw):
                pcm = _pcm16(os.path.join(dataset, "audio", split, name))
                if len(pcm) != cfg.clip_samples or not np.array_equal(row, pcm):
                    raise AssertionError(f"{split}/{name}: int16 row != the WAV's PCM")
            if not (np.array_equal(raw, alt.waveform.raw)
                    and np.array_equal(got.feature, alt.feature)):
                raise AssertionError(f"{split}: --no_native packed other bits")
        train = packed["training", "native"]
        paths = [os.path.join(dataset, "audio", "training", name)
                 for name in train.audio_names[:PACK_BATCH]]
        rows = native.load_wav_batch(paths, cfg.sample_rate, cfg.clip_samples)
        if not np.array_equal(rows, train.waveform.raw[:PACK_BATCH].astype(np.float32)
                              * np.float32(2.0 ** -15)):
            raise AssertionError("the decoded rows are not the stored PCM / 32768")
        with torch.no_grad():
            want = guard.plain["logmel"](torch.from_numpy(rows), cfg)
        err, ok = _db_bound_ok(torch.from_numpy(np.array(train.feature[:PACK_BATCH])),
                               want)
        print(f"[runme] stage 1 checks: names and targets == pack_synthetic's; "
              f"int16 rows == the WAVs' PCM bit for bit ({sum(SPLITS.values())} "
              f"clips); --no_native packed the same bits; one batch of "
              f"{PACK_BATCH} on the card vs the plain CPU frontend on the same "
              f"decoded rows: max |Δ| {err:.3e} dB (limit 0.1, linear within "
              "rtol 2e-3)")
        if not ok:
            raise AssertionError("stage 1 features disagree with the plain frontend")

        # calculate_scalar on stage 1's training split
        scalar_ws = os.path.join(root, "stage1_native")
        wall = counted("calculate_scalar", ["calculate_scalar",
                                            f"--workspace={scalar_ws}"])
        mean, std = load_scalar(os.path.join(scalar_ws, "scalars", "training.h5"))
        ref_mean, ref_std = load_scalar(os.path.join(ws, "scalars", "training.h5"))
        d_scalar = max(float(np.abs(mean - ref_mean).max()),
                       float(np.abs(std - ref_std).max()))
        print(f"[runme] calculate_scalar {wall:.3f} s: mean/std vs pack_synthetic's "
              f"(float clips, not PCM) max |Δ| {d_scalar:.3e} dB (limit 0.1)")
        if mean.shape != (cfg.mel_bins,) or not d_scalar <= 0.1:
            raise AssertionError("stage 1's scalar")

        # the host's share of a pack: the device's work for a batch of 32
        # (copy in, kernel, features out), each part between CUDA events
        parts = _pack_batch_device_ms(torch, stft.make_logmel_fn(cfg), rows)
        dev_ms = sum(parts)
        print(f"[runme] the device's work for a batch of {PACK_BATCH} (CUDA events, "
              f"median of 5): host→device copy {parts[0]:.4f} ms, kernel "
              f"{parts[1]:.4f} ms, features back {parts[2]:.4f} ms; so the host's "
              "share of each split's pack: " + ", ".join(
                  f"{split} {100 * (1 - -(-n // PACK_BATCH) * dev_ms / (1e3 * walls[split, d])):.1f}%"
                  f" ({'native' if d == 'native' else '--no_native'})"
                  for split, n in SPLITS.items() for d in ("native", "python"))
              + f" [{card}]")

        # resampling: the testing split's WAVs rewritten at 44.1 kHz
        ds44 = os.path.join(root, "ds44")
        os.makedirs(os.path.join(ds44, "audio", "testing"))
        os.makedirs(os.path.join(ds44, "metadata"))
        shutil.copy(os.path.join(dataset, "metadata", "testing_set.csv"),
                    os.path.join(ds44, "metadata"))
        for name in packed["testing", "native"].audio_names:
            x, _ = audio_io.load_wav(os.path.join(dataset, "audio", "testing", name))
            audio_io.save_wav(os.path.join(ds44, "audio", "testing", name),
                              audio_io.resample(x, cfg.sample_rate, RESAMPLED_RATE),
                              RESAMPLED_RATE)
        res = {d: stage1("testing", os.path.join(root, f"ds44_{d}"), ds44, d)
               for d in ("native", "python")}
        if any(guard.calls.values()):
            raise AssertionError(f"plain frontend ran on the card: {guard.calls}")
    (w_n, a), (w_p, b) = res["native"], res["python"]
    lsb = int(np.abs(a.waveform.raw.astype(np.int32)
                     - b.waveform.raw.astype(np.int32)).max())
    d_db = float(np.abs(a.feature - b.feature).max())
    print(f"[runme] stage 1 testing from {RESAMPLED_RATE} Hz WAVs: native "
          f"{w_n:.3f} s ({CLI_TEST / w_n:.2f} clips/s), --no_native {w_p:.3f} s "
          f"({CLI_TEST / w_p:.2f} clips/s); int16 rows within {lsb} LSB (limit "
          f"1), features max |Δ| {d_db:.3e} dB (limit 0.1) [{card}]")
    if not (lsb <= 1 and d_db <= 0.1):
        raise AssertionError("the two resamplers disagree")

    # stage 4 on the workspace of phases 8 and 9: the table, then runme.sh's
    # plot (a text listing where matplotlib is missing)
    png = os.path.join(root, "results.png")
    outs = []
    for argv in ([f"--workspace={cli_ws}", "--table"],
                 [f"--workspace={cli_ws}", f"--out={png}"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            plot_results.main(argv)
        outs.append(buf.getvalue())
        for line in outs[-1].splitlines():
            print(f"[runme] {line}")
        print(f"[runme] plot_results {argv[1]}: {time.perf_counter() - t0:.3f} s")
    table = [line for line in outs[0].splitlines() if line.startswith("| Cnn")]
    if sorted(r.split(" | ")[0][2:] for r in table) != sorted((MODEL, ZOO[1])):
        raise AssertionError(f"plot_results --table rows: {table}")
    if ("plot → " in outs[1]) != os.path.isfile(png) or not outs[1].strip():
        raise AssertionError("plot_results wrote neither a plot nor a listing")
    print("[runme] stage 4: " + (f"a PNG of {os.path.getsize(png)} bytes"
                                 if os.path.isfile(png)
                                 else "the text listing (no matplotlib)"))
    print(f"[runme] waveform kernel launches in the phase: "
          f"{sum(launches.values())} ({', '.join(f'{k} {v}' for k, v in launches.items())})")
    return sum(launches.values())


# ---------------------------------------------------------------------------
# phase 11: data parallel under a process group
# ---------------------------------------------------------------------------
DP_STEPS = 10
# the flagship has 8 BatchNorm layers: one [2C] all-reduce each forward and
# backward, then one flat all-reduce of the gradients and the loss
DP_COLLECTIVES_PER_STEP = 2 * 8 + 1


@contextlib.contextmanager
def _counted_all_reduces(dist):
    """Count the ``dist.all_reduce`` calls of the ``with`` body (a list of
    one count)."""
    calls, all_reduce = [0], dist.all_reduce

    def counting(*a, **k):
        calls[0] += 1
        return all_reduce(*a, **k)

    dist.all_reduce = counting
    try:
        yield calls
    finally:
        dist.all_reduce = all_reduce


def _dp_model(torch, sedt, cfg, dtype, bank, scalar, scale, mesh):
    """The flagship from seed 0 (dropout 0.2) and its train step over the
    bank (mixup α = 1, the state's generators from seed 0), data parallel
    over ``mesh`` when it is given."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    model = _train_model(sedt, torch, dtype, 0.2)
    state = train.create_train_state(model, cfg, seed=0)    # device → cuda
    step = train.make_train_step(
        model, state, scalar=scalar, mixup_alpha=1.0, check_numerics=True,
        bank=bank, wave_scale=scale, mesh=mesh,
        bank_frontend=stft.make_logmel_bank_fn(cfg, precision="fast",
                                               wave_scale=scale))
    return model, step


def _timed_steps(torch, step, batches, targets):
    """Run ``step`` over ``batches``; returns the metrics, each step's time by
    CUDA events and the peak memory of the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(batches) + 1)]
    metrics = []
    marks[0].record()
    for i, idx in enumerate(batches):
        metrics.append(step(idx, targets[idx]))
        marks[i + 1].record()
    torch.cuda.synchronize()
    return (metrics, [marks[i].elapsed_time(marks[i + 1]) for i in range(len(batches))],
            torch.cuda.max_memory_allocated())


def phase_parallel(torch, sedt, card, bank, targets, scale, ws):
    """Phase 11 (see the module docstring). Returns the launches of both
    kernels on its main paths."""
    import datetime

    import torch.distributed as dist

    from sound_event_detection_dcase2017_task4_torch import (checkpoints, main as cli,
                                                             parallel, train)
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    cfg = sedt.config.DEFAULT
    scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
              np.full(cfg.mel_bins, 15.0, np.float32))
    sampler = np.random.default_rng(11)
    batches = [np.sort(sampler.choice(BANK_CLIPS, TRAIN_BATCH, replace=False))
               for _ in range(DP_STEPS)]
    store = tempfile.mkdtemp(prefix="sedx_dp_")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120), device_id=dev)
    launches = {}
    try:
        mesh = parallel.make_mesh(dev)
        if dist.get_backend(mesh.group) != "nccl" or mesh.size != 1:
            raise AssertionError(f"the group: {dist.get_backend(mesh.group)}, "
                                 f"{mesh.size} rank(s)")
        print(f"[parallel] a 1-rank NCCL group on {dev} (FileStore), NCCL "
              f"{torch.cuda.nccl.version()}")

        # 1. f32: the same 10 steps from the same state, with the group and
        # without; every collective of the data-parallel step counted
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            runs = {}
            for tag, m in (("bare", None), ("parallel", mesh)):
                model, step = _dp_model(torch, sedt, cfg, torch.float32, bank,
                                        scalar, scale, m)
                with _counted_all_reduces(dist) as calls:
                    metrics, _, _ = _timed_steps(torch, step, batches, targets)
                runs[tag] = ([float(x["loss"]) for x in metrics],
                             [float(x["grad_norm"]) for x in metrics],
                             {k: v.detach().cpu() for k, v in model.state_dict().items()
                              if "running" in k}, calls[0])
                del model, step
        finally:
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic) = tf32
        (l0, g0, s0, c0), (l1, g1, s1, c1) = runs["bare"], runs["parallel"]
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
        d_norm = max(abs(a - b) / abs(b) for a, b in zip(g1, g0))
        d_stats = max(float(((s1[k] - s0[k]).abs() / (1e-5 + 1e-4 * s0[k].abs())).max())
                      for k in s0)
        print(f"[parallel] f32, TF32 off, {DP_STEPS} steps at batch {TRAIN_BATCH} over "
              f"the bank (mixup α=1, dropout 0.2), the 1-rank NCCL step vs the step "
              f"with no group: largest loss gap rel {d_loss:.3e} (limit 2e-5), "
              f"grad-norm rel {d_norm:.3e} (limit 1e-4), BN running statistics after "
              f"{DP_STEPS} steps at {d_stats:.3f} of rtol 1e-4 / atol 1e-5; "
              f"all-reduces {c1} ({DP_COLLECTIVES_PER_STEP} a step) vs {c0}")
        print(f"[parallel] f32 losses: {' '.join(f'{v:.6f}' for v in l1)}")
        if not (d_loss <= 2e-5 and d_norm <= 1e-4 and d_stats <= 1.0):
            raise AssertionError("the data-parallel step disagrees with the bare one")
        if c1 != DP_STEPS * DP_COLLECTIVES_PER_STEP or c0:
            raise AssertionError(f"all-reduces: {c1} with the group, {c0} without")
        torch.cuda.empty_cache()

        # 2. bf16: the main path (counters zeroed just before, read just
        # after), then the bare step and the two again, alternated
        models, steps = {}, {}
        for tag, m in (("parallel", mesh), ("bare", None)):
            models[tag], steps[tag] = _dp_model(torch, sedt, cfg, torch.bfloat16, bank,
                                                scalar, scale, m)
            steps[tag](batches[0], targets[batches[0]])   # cuDNN's first-call setup
        with _PlainGuard(torch, cfg) as guard, _counted_all_reduces(dist) as calls:
            _zero_launches()
            dp_metrics, dp_ms, dp_peak = _timed_steps(torch, steps["parallel"], batches,
                                                      targets)
            launches["logmel_bank"], launches["logmel"] = (_launches("logmel_bank"),
                                                           _launches("logmel"))
        if launches["logmel_bank"] != DP_STEPS or launches["logmel"]:
            raise AssertionError(f"data-parallel steps: {launches['logmel_bank']} bank / "
                                 f"{launches['logmel']} waveform launches")
        if calls[0] != DP_STEPS * DP_COLLECTIVES_PER_STEP:
            raise AssertionError(f"data-parallel bf16 steps: {calls[0]} all-reduces")
        if any(guard.calls.values()):
            raise AssertionError(f"plain frontend ran on the card: {guard.calls}")
        losses = [float(m["loss"]) for m in dp_metrics]
        if not np.isfinite(losses).all() or sum(int(m["nonfinite_count"])
                                                for m in dp_metrics):
            raise AssertionError(f"non-finite data-parallel training: {losses}")
        times, peaks = {"parallel": dp_ms, "bare": []}, {"parallel": dp_peak, "bare": 0}
        for tag in ("bare", "bare", "parallel"):      # parallel, bare, bare, parallel
            _, t, peak = _timed_steps(torch, steps[tag], batches, targets)
            times[tag] += t
            peaks[tag] = max(peaks[tag], peak)
        p_dp, p_bare = (float(np.median(times[k])) for k in ("parallel", "bare"))
        dp_peak, bare_peak = peaks["parallel"], peaks["bare"]
        print(f"[parallel] bf16 main path: {DP_STEPS} data-parallel steps of "
              f"{MODEL} at batch {TRAIN_BATCH} over phase 6's bank, mixup α=1, "
              f"dropout 0.2: bank kernel launches {launches['logmel_bank']}, waveform "
              f"0, plain frontend calls 0, NCCL all-reduces {calls[0]}; loss "
              f"{losses[0]:.4f} → {losses[-1]:.4f}")
        print(f"[parallel] bf16 step p50 (CUDA events, {len(dp_ms)} steps each, "
              f"alternated): data parallel {p_dp:.3f} ms, bare {p_bare:.3f} ms, ratio "
              f"{p_dp / p_bare:.4f}; peak memory {dp_peak / 2**20:.1f} vs "
              f"{bare_peak / 2**20:.1f} MiB ({(dp_peak - bare_peak) / 2**20:+.1f} MiB) "
              f"[{card}]")
        # where the two steps' device time differs, by PyTorch operator
        ops = {tag: dict((key, ms) for ms, _, key in _device_kernels(
            torch, lambda tag=tag: steps[tag](batches[1], targets[batches[1]]),
            by_op=True)[1]) for tag in ("parallel", "bare")}
        total = {tag: sum(v.values()) for tag, v in ops.items()}
        gaps = sorted(set(ops["parallel"]) | set(ops["bare"]), key=lambda k: -abs(
            ops["bare"].get(k, 0.0) - ops["parallel"].get(k, 0.0)))
        print(f"[parallel-profile-op] one bf16 step's device time by operator: data "
              f"parallel {total['parallel']:.4f} ms, bare {total['bare']:.4f} ms; "
              f"the largest differences (bare − data parallel):")
        for key in gaps[:8]:
            b, p = ops["bare"].get(key, 0.0), ops["parallel"].get(key, 0.0)
            print(f"[parallel-profile-op] {b - p:+9.4f} ms  bare {b:9.4f}  data "
                  f"parallel {p:9.4f}  {key[:70]}")

        # 3. ragged eval: the data-parallel forward_generator against the plain
        evaluate = train.make_eval_step(
            models["parallel"], scalar=scalar, bank=bank, wave_scale=scale,
            bank_frontend=stft.make_logmel_bank_fn(cfg, precision="fast",
                                                   wave_scale=scale))
        outs = [train.forward_generator(
            evaluate, ((b, targets[b]) for b in (batches[1][:16], batches[2][:13])),
            prefetch=0, mesh=m) for m in (mesh, None)]
        d_eval = max(float(np.abs(outs[0][k] - outs[1][k]).max())
                     for k in ("clipwise_output", "framewise_output"))
        print(f"[parallel] eval of 16 + 13 clips through the data-parallel "
              f"forward_generator vs the plain one: max |Δ| {d_eval:.3e} (limit 1e-5)")
        if not d_eval <= 1e-5 or outs[0]["clipwise_output"].shape != (29, cfg.classes_num):
            raise AssertionError("the data-parallel eval disagrees")
        del models, steps, evaluate
        torch.cuda.empty_cache()

        # 4. the CLI under the group, host-fed (the waveform kernel)
        saved = {}
        save_checkpoint = checkpoints.save_checkpoint

        def recording_save(directory, state, iteration=None, opt_config=None):
            saved[iteration] = checkpoints.state_dict(state)
            return save_checkpoint(directory, state, iteration, opt_config)

        argv = [f"--model_type={MODEL}", "--feature_source=waveform",
                "--augmentation=mixup_specaugment", f"--batch_size={CLI_BATCH}"]
        checkpoints.save_checkpoint = recording_save
        try:
            with _PlainGuard(torch, cfg) as guard:
                _zero_launches()
                t0 = time.perf_counter()
                run = cli.main(["train", f"--workspace={ws}", *argv, "--dtype=bf16",
                                "--device_cache=off", f"--stop_iteration={DP_STEPS}",
                                f"--eval_interval={DP_STEPS}",
                                f"--eval_max_iteration={CLI_EVAL_MAX}"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                b2, b1 = _launches("logmel"), _launches("logmel_bank")
        finally:
            checkpoints.save_checkpoint = save_checkpoint
        per_eval = min(CLI_EVAL_MAX, -(-CLI_TRAIN // CLI_BATCH)) + min(
            CLI_EVAL_MAX, -(-CLI_TEST // CLI_BATCH))
        if b2 != DP_STEPS + 2 * per_eval or b1 or any(guard.calls.values()):
            raise AssertionError(f"CLI under the group: {b2} waveform / {b1} bank "
                                 f"launches, plain {guard.calls}")
        launches["logmel"] += b2
        if run["iteration"] != DP_STEPS or not np.isfinite(run["loss"]):
            raise AssertionError(f"CLI under the group: {run}")
        run_config = "/".join(("loss_type=clip_bce", "augmentation=mixup_specaugment",
                               f"batch_size={CLI_BATCH}"))
        pth = os.path.join(ws, "checkpoints", "main", f"model_type={MODEL}",
                           *run_config.split("/"), f"{DP_STEPS}_iterations.pth")
        print(f"[parallel] main train under the group, host-fed int16 batches "
              f"(--device_cache=off), bf16, SpecAugment + mixup, batch {CLI_BATCH}: "
              f"{DP_STEPS} steps, evals at 0 and {DP_STEPS} in {wall:.3f} s; waveform "
              f"kernel launches {b2} ({DP_STEPS} steps + 2×{per_eval} eval batches), "
              f"bank 0, plain frontend calls 0; loss {run['loss']:.5f} [{card}]")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store)

    # 5. the checkpoint in a process with no group: the run's state, served
    out = os.path.join(store + "_check.pt")
    code = (
        "import sys, numpy as np, torch\n"
        "from sound_event_detection_dcase2017_task4_torch import checkpoints, serving\n"
        "from sound_event_detection_dcase2017_task4_torch.models import get_model\n"
        "assert not torch.distributed.is_initialized()\n"
        "ws, model_type, run_config, pth, it, out = sys.argv[1:]\n"
        "model = checkpoints.load_model(pth, get_model(model_type))\n"
        "pred = serving.Predictor.from_workspace(ws, model_type, run_config,\n"
        "                                        iteration=int(it), device='cpu')\n"
        "wave = np.random.default_rng(3).standard_normal((2, 320000)).astype('float32')\n"
        "res = pred(0.1 * wave)\n"
        "torch.save({'model': model.state_dict(), 'clipwise': res['clipwise_output']}, out)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code, ws, MODEL, run_config, pth,
                           str(DP_STEPS), out],
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"loading the checkpoint with no group failed:\n"
                             f"{proc.stderr[-2000:]}")
    got = torch.load(out, weights_only=False)
    os.unlink(out)
    _tensors_equal(got["model"], saved[DP_STEPS]["model"], "checkpoint")
    clip = np.asarray(got["clipwise"])
    if clip.shape != (2, cfg.classes_num) or not np.isfinite(clip).all():
        raise AssertionError(f"served from the checkpoint: {clip}")
    print(f"[parallel] {os.path.basename(pth)} loaded in a process with no group "
          f"(CPU): the model state equals the run's bit for bit, keys without a "
          f"'module.' prefix; Predictor.from_workspace served 2 clips there")
    print(f"[parallel] launches on the phase's main paths: bank kernel "
          f"{launches['logmel_bank']}, waveform kernel {launches['logmel']}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the tools and examples
# ---------------------------------------------------------------------------

TOOLS_SOAK = (256, 64, 64)          # scale_soak's workspace: train/test/eval
TOOLS_SOAK_STEPS, TOOLS_SOAK_EVAL, TOOLS_BATCH = 20, 10, 32
TOOLS_HARD_TRAIN, TOOLS_HARD_STEPS = 64, 20
TOOLS_CONTROL = "no_normalization"
MINIMAL_STEPS = 30                  # minimal_train's own step count


def _child_launches(report, what, logmel=0, bank=0):
    """Hold a tool child's counters (``tools.child_report``) to what the
    child did: no plain frontend call, and the waveform (``logmel``) and
    bank (``bank``) launches equal to the given count, or non-zero for
    ``True``, or zero for ``0``."""
    if any(report["plain"].values()):
        raise AssertionError(f"{what}: the plain frontend ran: {report}")
    if "counters" in report:
        _bn_tally(report["counters"])
    for key, want in (("logmel", logmel), ("logmel_bank", bank)):
        got = report[key]
        if want is True and got < 1 or want is not True and got != want:
            raise AssertionError(f"{what}: {key} launches {got}, expected "
                                 f"{'> 0' if want is True else want}")
    return report


def phase_tools(torch, sedt, card, root):
    """Phase 12 (see the module docstring) in workspaces under ``root``.
    Returns the launches of both kernels, in the phase's own process and
    in the tools' children."""
    from sound_event_detection_dcase2017_task4_torch import features
    from sound_event_detection_dcase2017_task4_torch.examples import (
        minimal_train, streaming_live)
    from sound_event_detection_dcase2017_task4_torch.tools import (
        coldstart_probe, hard_benchmark, mfu, parity_check, scale_soak,
        sed_search_bench)

    cfg = sedt.config.DEFAULT
    torch.cuda.empty_cache()              # the children share the card
    launches = {"logmel": 0, "logmel_bank": 0}
    walls = {}

    def counted(tag, fn, logmel=0, bank=0, plain=0):
        """Zero the counters, run ``fn`` in this process, hold the counters
        to ``logmel``/``bank`` (as in :func:`_child_launches`) and the
        plain frontend's calls in this process to ``plain`` (the CPU FLOP
        count of ``mfu`` and ``parity_check``'s comparison make them)."""
        with _PlainGuard(torch, cfg) as guard:
            _zero_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[tag] = time.perf_counter() - t0
            got = {"logmel": _launches("logmel"),
                   "logmel_bank": _launches("logmel_bank")}
        if guard.calls != {"logmel": plain, "logmel_bank": 0}:
            raise AssertionError(f"{tag}: plain frontend calls {guard.calls}, "
                                 f"expected {plain} of logmel")
        _child_launches({**got, "plain": {}}, tag, logmel, bank)
        for k in launches:
            launches[k] += got[k]
        return out

    def add(reports):
        for r in reports:
            for k in launches:
                launches[k] += r[k]

    # sed_search_bench at the testing split's size, both paths
    rec = counted("sed_search_bench", lambda: sed_search_bench.main([]))
    if rec["sequential_dispatches"] <= rec["grid_ascent_dispatches"]:
        raise AssertionError(f"sed_search_bench: {rec}")
    print(f"[tools] sed_search_bench {rec['size']}: grid ascent "
          f"{rec['grid_ascent_s']:.3f} s over {rec['grid_ascent_dispatches']} "
          f"dispatches, sequential {rec['sequential_s']:.3f} s over "
          f"{rec['sequential_dispatches']} ({rec['speedup']:.2f}×), the same "
          f"optimum {rec['best_score']:.6f}; staging {rec['compile_s']:.3f} s "
          f"[{card}]")

    # mfu: the count on the CPU, the bench step timed on the card
    # the CPU count calls the plain frontend twice (the step, and the
    # frontend alone to take out)
    rec = counted("mfu", lambda: mfu.main([]),
                  bank=mfu.TIMED_STEPS + mfu.WARMUP_STEPS, plain=2)
    if not 0 < rec["mfu"] < 1:
        raise AssertionError(f"mfu: {rec}")
    print(f"[tools] mfu: {rec['flops_per_step'] / 1e12:.4f} TFLOP a step "
          f"(model {rec['model_flops'] / 1e12:.4f}, kernel frontend "
          f"{rec['frontend_flops'] / 1e9:.4f} GFLOP), step {rec['step_ms']:.3f} "
          f"ms, {rec['sustained_tflops']:.2f} TFLOP/s, MFU "
          f"{100 * rec['mfu']:.2f}% of {rec['peak_tflops']:.0f} TFLOP/s "
          f"[{card}]")

    # coldstart_probe: four fresh processes
    recs = counted("coldstart_probe", lambda: coldstart_probe.main([]))
    for r in recs:
        kernel = r["cell"].endswith("kernel")
        if kernel:
            _child_launches(r["launches"], r["cell"], logmel=2)
            add([r["launches"]])
        elif (r["launches"]["plain"]["logmel"] != 2
              or r["launches"]["logmel"] or r["launches"]["logmel_bank"]):
            raise AssertionError(f"{r['cell']}: {r['launches']}")
        build = ("-" if r["kernel_build_s"] is None
                 else f"{r['kernel_build_s']:.3f}")
        print(f"[tools] coldstart {r['cell']}: import {r['import_s']:.3f} s, "
              f"device {r['device_s']:.3f} s, kernel build {build} s, build "
              f"{r['build_s']:.3f} s, first step {r['first_step_s']:.3f} s, "
              f"second {r['second_step_s']:.3f} s, process "
              f"{r['process_wall_s']:.3f} s [{card}]")

    # scale_soak on a packed 256/64/64 workspace
    soak_ws = os.path.join(root, "soak")
    n_train, n_test, n_eval = TOOLS_SOAK
    counted("pack soak", lambda: features.main([
        "pack_synthetic", f"--workspace={soak_ws}", f"--num_train={n_train}",
        f"--num_test={n_test}", f"--num_eval={n_eval}", "--metadata_only"]),
        logmel=sum(-(-n // PACK_BATCH) for n in TOOLS_SOAK))
    rec = counted("scale_soak", lambda: scale_soak.main([
        f"--workspace={soak_ws}", f"--iterations={TOOLS_SOAK_STEPS}",
        f"--batch_size={TOOLS_BATCH}", f"--eval_interval={TOOLS_SOAK_EVAL}"]))
    evals = TOOLS_SOAK_STEPS // TOOLS_SOAK_EVAL + 1
    # each eval: 2 batches (--eval_max_iteration=2) of each split
    _child_launches(rec["launches"]["train"], "scale_soak train",
                    logmel=TOOLS_SOAK_STEPS + evals * 4)
    _child_launches(rec["launches"]["inference"], "scale_soak inference",
                    logmel=-(-n_eval // TOOLS_BATCH))
    _child_launches(rec["launches"]["calculate_metrics"],
                    "scale_soak calculate_metrics", logmel=0)
    add(rec["launches"].values())
    if rec["eval_clips"] != n_eval or rec["train_clips_per_sec"] is None:
        raise AssertionError(f"scale_soak: {rec}")
    print(f"[tools] scale_soak {n_train}/{n_test}/{n_eval} clips, "
          f"{TOOLS_SOAK_STEPS} lazy host-fed steps at batch {TOOLS_BATCH}: "
          f"{rec['train_clips_per_sec']:.1f} clips/s, peak RSS train "
          f"{rec['train_peak_rss_gb']:.3f} GiB, inference "
          f"{rec['inference_peak_rss_gb']:.3f} GiB [{card}]")

    # hard_benchmark: one family, one seed, one control, 20 steps
    hard_ws = os.path.join(root, "hard")
    children = counted("hard_benchmark", lambda: hard_benchmark.main([
        "matrix", f"--workspace={hard_ws}", f"--models={MODEL}",
        "--seeds=1234", f"--controls={TOOLS_CONTROL}",
        f"--num_train={TOOLS_HARD_TRAIN}",
        f"--iterations={TOOLS_HARD_STEPS}",
        f"--batch_size={TOOLS_BATCH}"]))
    # the children run the JAX tool's argv: train and score on the packed
    # log-mel features, which the waveform kernel computed at the pack
    want = {"features pack_synthetic": dict(logmel=True),
            "main train": {},
            "tools.hard_benchmark train-control": {},
            "main inference": {},
            "main calculate_metrics": {}}
    for c in children:
        _child_launches(c, f"hard_benchmark {c['run']}", **want[c["run"]])
    if sorted(c["run"] for c in children) != sorted(
            ["features pack_synthetic", "main train",
             "tools.hard_benchmark train-control"]
            + 2 * ["main inference", "main calculate_metrics"]):
        raise AssertionError(f"hard_benchmark children: {children}")
    add(children)
    print(f"[tools] hard_benchmark matrix ({MODEL}, seed 1234, control "
          f"{TOOLS_CONTROL}, {TOOLS_HARD_STEPS} steps): "
          + ", ".join(f"{c['run']} {c['logmel']}+{c['logmel_bank']}"
                      for c in children)
          + " (waveform+bank launches)")

    # parity_check in dry mode (no reference tree, no corpus)
    rc = counted("parity_check", lambda: parity_check.main([
        f"--reference={os.path.join(root, 'no_reference')}",
        f"--survey_patch={os.path.join(root, 'survey_patch.md')}"]),
        logmel=1, plain=1)
    if rc != 0:
        raise AssertionError(f"parity_check exited {rc}")

    # both examples
    events = counted("minimal_train", lambda: minimal_train.main(),
                     logmel=MINIMAL_STEPS + 1)
    if len(events) != 4:
        raise AssertionError(f"minimal_train: {events}")
    lines = counted("streaming_live", lambda: streaming_live.main([
        f"--workspace={os.path.join(hard_ws, 'seed_1234')}",
        f"--model_type={MODEL}",
        f"--run_config=loss_type=clip_bce/augmentation=mixup/"
        f"batch_size={TOOLS_BATCH}"]), logmel=True)
    print(f"[tools] streaming_live: {len(lines)} events from 30 s of live "
          f"audio in 250 ms chunks")
    print("[tools] wall times: " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in walls.items()))
    print(f"[tools] launches in the phase (this process and the tools' "
          f"children): waveform kernel {launches['logmel']}, bank kernel "
          f"{launches['logmel_bank']}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the root entry points
# ---------------------------------------------------------------------------
ENTRY_REPS = 20


def phase_entry(torch, card):
    """Phase 13 (see the module docstring). Returns the waveform kernel's
    launches on its main path: ``entry()``'s forward and the dry run's
    ranks."""
    from sound_event_detection_dcase2017_task4_torch import graft_entry
    from sound_event_detection_dcase2017_task4_torch.config import Config
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = Config(clip_samples=64000)
    # ---- the main path: counters zeroed just before, read just after ----
    with _PlainGuard(torch, cfg) as guard:
        _zero_launches()
        forward, args = graft_entry.entry()
        clip, frame = forward(*args)
        torch.cuda.synchronize()
        launches = {"entry": _launches("logmel"), "bank": _launches("logmel_bank")}
    # ----------------------------------------------------------------------
    if launches != {"entry": 1, "bank": 0} or any(guard.calls.values()):
        raise AssertionError(f"entry(): launches {launches}, plain {guard.calls}")
    if args[2].device.type != "cuda" or clip.device.type != "cuda":
        raise AssertionError(f"entry() ran on {args[2].device} / {clip.device}")
    n_params = sum(p.numel() for p in args[0].values())
    if (tuple(clip.shape) != (4, cfg.classes_num)
            or tuple(frame.shape) != (4, cfg.frames_num, cfg.classes_num)
            or not (torch.isfinite(clip).all() and torch.isfinite(frame).all())):
        raise AssertionError(f"entry(): {tuple(clip.shape)}, {tuple(frame.shape)}")
    print(f"[entry] graft_entry.entry() on {clip.device}: {graft_entry.FLAGSHIP} "
          f"({n_params} params), forward(*args) → clipwise {tuple(clip.shape)}, "
          f"framewise {tuple(frame.shape)}; waveform kernel launches "
          f"{launches['entry']}, bank 0, plain frontend calls 0")

    # the card against entry(device="cpu") with the card's parameters, TF32
    # off: the example zeros and a seeded waveform
    cpu_forward, _ = graft_entry.entry(device="cpu")
    cpu_args = [{k: v.cpu() for k, v in args[i].items()} for i in (0, 1)]
    seeded = torch.from_numpy((np.random.default_rng(13).standard_normal(
        (4, cfg.clip_samples)) * 0.1).astype(np.float32))
    gaps = {}
    for tag, wave in (("zeros", args[2]), ("seeded", seeded.cuda())):
        got = forward(args[0], args[1], wave)
        want = cpu_forward(*cpu_args, wave.cpu())
        gaps[tag] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    print(f"[entry] f32, TF32 off, the card vs entry(device='cpu') on the same "
          f"parameters: max |Δ| zeros {gaps['zeros']:.3e}, seeded "
          f"{gaps['seeded']:.3e} (limit 1e-4)")
    if not max(gaps.values()) <= 1e-4:
        raise AssertionError(f"entry(): the card disagrees with the CPU: {gaps}")

    # the kernel's own output against the plain frontend at the shapes this
    # phase launches it at: the seeded clips above, and the dry run's wave
    # (its legs' global batch of 2 and its ragged eval's row). The model's
    # outputs above barely move under a small frontend error (its random
    # eval-mode network saturates), so the kernel is held here directly
    dry = Config(clip_samples=16000)
    dry_wave = torch.from_numpy(np.random.RandomState(0).randn(
        2, dry.clip_samples).astype(np.float32) * 0.1)
    for tag, c, wave in (("entry's seeded", cfg, seeded),
                         ("the dry run's", dry, dry_wave),
                         ("the dry run's eval", dry, dry_wave[:1])):
        got = logmel_cuda.logmel_cuda(wave.cuda(), c).cpu()
        want = stft.logmel(wave, c)
        err, ok = _db_bound_ok(got, want)
        print(f"[entry] waveform kernel vs plain frontend on {tag} "
              f"{list(wave.shape)} → {list(got.shape)}: max |Δ| {err:.3e} dB "
              f"(limit 0.1, linear within rtol 2e-3)")
        if got.shape != want.shape or not ok:
            raise AssertionError(f"waveform kernel disagrees with the plain "
                                 f"frontend on {tag} {list(wave.shape)}: {err} dB")

    # the forward's p50 by CUDA events
    for _ in range(3):
        forward(*args)
    times = []
    for _ in range(ENTRY_REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        forward(*args)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    p50 = float(np.median(times))
    print(f"[entry] forward(*args) p50 {p50:.4f} ms, min {min(times):.4f} ms "
          f"over {ENTRY_REPS} calls (CUDA events, f32, 4 × 2 s clips) [{card}]")
    # the device's share of the forward: its kernels' time under the profiler
    _, rows = _device_kernels(torch, lambda: forward(*args))
    busy = sum(ms for ms, _, _ in rows)
    print(f"[entry-profile] one forward's device time {busy:.4f} ms in "
          f"{sum(n for _, n, _ in rows)} kernels and copies, {100 * busy / p50:.1f}% "
          f"of the p50; heaviest: " + "; ".join(
              f"{name[:48]} {ms:.4f} ms ×{n}" for ms, n, name in rows[:4]))

    # the dry run over every card: one rank a card under NCCL
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(n, timeout=300)
    wall = time.perf_counter() - t0
    if res["backend"] != "nccl" or res["launches"] != [
            {"logmel": 3, "logmel_bank": 0}] * n:
        raise AssertionError(f"dryrun_multichip({n}): {res}")
    launches["entry"] += sum(r["logmel"] for r in res["launches"])
    print(f"[entry] dryrun_multichip({n}) under NCCL in {wall:.1f} s: loss "
          f"{res['loss']:.6f} vs {res['loss_1']:.6f} with no mesh, grad-norm "
          f"{res['grad_norm']:.6f} vs {res['grad_norm_1']:.6f}, eval "
          f"{res['eval_shape']}; waveform kernel launches a rank 3 (two steps, "
          f"the eval); {n} rank(s) on this machine, N > 1 is held on the CPU "
          f"only (tests/test_torch_graft_entry.py, gloo)")
    print(f"[entry] waveform kernel launches on the phase's main path: "
          f"{launches['entry']}")
    return launches["entry"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import sound_event_detection_dcase2017_task4_torch as sedt
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda

    name, card = phase_device(torch)
    phase_build(logmel_cuda, sedt.config.DEFAULT)
    kernel = phase_kernel(torch, sedt, card)
    phase_gru(torch, card)
    phase_bn_act(torch, card)
    wa = phase_window_attention(torch, card)
    ss_kernel = phase_selective_scan(torch, card)
    _watch_batchnorm()
    _bn_phase("slice")
    kernel["launches"] = phase_slice(torch, sedt, card)
    _bn_phase("bank_kernel")
    bank_kernel, bank, targets, scale = phase_bank_kernel(torch, sedt, card)
    _bn_phase("train")
    bank_kernel["launches"] = phase_train(torch, sedt, card, bank, targets,
                                          scale)
    root = tempfile.mkdtemp(prefix="sedx_cli_")
    try:
        _bn_phase("cli")
        cli, ws = phase_cli(torch, sedt, card, root)
        _bn_phase("resume")
        resume = phase_jax_resume(torch, sedt, card, root, ws)
        _bn_phase("zoo")
        zoo = phase_zoo(torch, sedt, card, bank, targets, scale, ws)
        _bn_phase("runme")
        kernel["launches_runme"] = phase_runme(torch, sedt, card, root, ws)
        _bn_phase("parallel")
        dp = phase_parallel(torch, sedt, card, bank, targets, scale, ws)
        del bank
        _bn_phase("tools")
        tools = phase_tools(torch, sedt, card, root)
    finally:
        shutil.rmtree(root)
    _bn_phase("entry")
    kernel["launches_entry"] = phase_entry(torch, card)
    _bn_phase("end")
    del _BN_TALLY["end"]
    kernel["launches_cli"] = cli["logmel"]
    kernel["launches_resume"] = resume["logmel"]
    bank_kernel["launches_resume"] = resume["logmel_bank"]
    bank_kernel["launches_cli"] = cli["logmel_bank"]
    kernel["launches_zoo"] = zoo["logmel"]
    bank_kernel["launches_zoo"] = zoo["logmel_bank"]
    kernel["launches_parallel"] = dp["logmel"]
    bank_kernel["launches_parallel"] = dp["logmel_bank"]
    kernel["launches_tools"] = tools["logmel"]
    bank_kernel["launches_tools"] = tools["logmel_bank"]
    forbidden = [m for m in ("jax", "flax", "optax", "h5py", "sklearn",
                             "msgpack",
                             "sound_event_detection_dcase2017_task4_tpu")
                 if m in sys.modules]
    if forbidden:
        raise AssertionError(f"the port pulled in {forbidden}")
    bn_kernel = {"name": "bn_act", "route": "cuda",
                 "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/bn_act.cu",
                 "phases": _BN_TALLY}
    for phase, tally in _BN_TALLY.items():
        print(f"[bn_act] {phase}: " + ", ".join(f"{k} {v}" for k, v in tally.items()))
    if any(t["card_plain"] for t in _BN_TALLY.values()):
        raise AssertionError(f"train-mode BatchNorm took the composite on the card: "
                             f"{_BN_TALLY}")
    if not all(_BN_TALLY[p]["calls"] and _BN_TALLY[p]["launches"]
               for p in ("train", "cli", "zoo", "parallel")):
        raise AssertionError(f"a training phase ran no bn_act kernel: {_BN_TALLY}")
    wa_kernel = {"name": "window_attention", "route": "cuda",
                 "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/"
                           "window_attention.cu",
                 "launches": wa["main_path"]["train"][0],
                 "launches_replay": wa["main_path"]["train"][1],
                 "launches_remat": wa["main_path"]["remat"][0],
                 "launches_eval": wa["main_path"]["eval"][0]}
    print(json.dumps({"kernels": [kernel, bank_kernel, bn_kernel, wa_kernel, ss_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
