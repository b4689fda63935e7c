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
   peak memory and one step's device time by kernel are printed.

It prints the ``kernels`` JSON line, then as its last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when no CUDA device is available or any phase fails. It imports nothing of
the JAX package.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

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
    lib = logmel_cuda.build()
    secs = time.perf_counter() - t0
    print(f"[build] ops/csrc/logmel.cu for sm_90a in {secs:.2f} s")
    for line in (logmel_cuda.BUILD_LOG or "").splitlines():
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
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

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
    plain_calls = []
    plain_logmel = stft.logmel

    def counting_plain(*a, **k):
        plain_calls.append(1)
        return plain_logmel(*a, **k)

    # the Predictor's frontend looks the plain version up as ``stft.logmel``
    # at each call, so the patch sees it; shown once on a CPU tensor
    stft.logmel = counting_plain
    try:
        pred._frontend(torch.zeros(1, cfg.clip_samples))
        if len(plain_calls) != 1:
            raise AssertionError("the plain-frontend guard missed a CPU call")
        plain_calls.clear()
        logmel_cuda.LAUNCHES = 0
        out = pred(wave)
        n_request = logmel_cuda.LAUNCHES
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
    finally:
        stft.logmel = plain_logmel
    launches = logmel_cuda.LAUNCHES
    # ----------------------------------------------------------------------

    _check_outputs(out, BATCH, cfg)
    if n_request != 1 or launches < 4:
        raise AssertionError(f"kernel launches: {n_request} for one request, "
                             f"{launches} on the whole path")
    if plain_calls:
        raise AssertionError(f"plain frontend ran {len(plain_calls)}× on the CUDA path")
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
    def p50_latency(p, reps=20):
        for _ in range(3):
            p(wave)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            p(wave)                      # ends in .cpu(): synchronises
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

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
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

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
    calls = {"logmel_bank": 0, "logmel": 0}
    plain = {k: getattr(stft, k) for k in calls}

    def counting(name):
        def fn(*a, **k):
            calls[name] += 1
            return plain[name](*a, **k)
        return fn

    for k in calls:
        setattr(stft, k, counting(k))
    try:
        n_rows = stft._geometry(cfg, cfg.clip_samples)[-1]
        bank_fn(torch.zeros((1, n_rows, cfg.hop_size), dtype=torch.int16), [0])
        if calls["logmel_bank"] != 1:
            raise AssertionError("the plain-bank guard missed a CPU call")
        calls.update(logmel_bank=0, logmel=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logmel_cuda.BANK_LAUNCHES = 0
        logmel_cuda.LAUNCHES = 0
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(TRAIN_STEPS + 1)]
        metrics = []
        marks[0].record()
        for i in range(TRAIN_STEPS):
            metrics.append(step(batches[i], ys[i]))
            marks[i + 1].record()
        out = evaluate(batches[0][:EVAL_BATCH])
        torch.cuda.synchronize()
    finally:
        for k in calls:
            setattr(stft, k, plain[k])
    launches, waveform_launches = logmel_cuda.BANK_LAUNCHES, logmel_cuda.LAUNCHES
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
    if any(calls.values()):
        raise AssertionError(f"plain frontend ran on the CUDA path: {calls}")
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
    kernel["launches"] = phase_slice(torch, sedt, card)
    bank_kernel, bank, targets, scale = phase_bank_kernel(torch, sedt, card)
    bank_kernel["launches"] = phase_train(torch, sedt, card, bank, targets,
                                          scale)
    forbidden = [m for m in ("jax", "flax", "optax",
                             "sound_event_detection_dcase2017_task4_tpu")
                 if m in sys.modules]
    if forbidden:
        raise AssertionError(f"the port pulled in {forbidden}")
    print(json.dumps({"kernels": [kernel, bank_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
