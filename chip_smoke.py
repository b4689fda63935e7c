#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path (``sound_event_detection_dcase2017_task4_torch``)
at the full width of ``Cnn_9layers_Gru_FrameAtt`` (channels 64-512, BiGRU 256,
17 classes, 10 s clips at 32 kHz → 1001 frames × 64 mel bins) with seeded
random weights, in phases that each raise on failure:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build the hand-written log-mel kernel from ``ops/csrc/logmel.cu`` with nvcc;
3. the kernel against its plain PyTorch version on the card at the serving
   shape (16 clips): 0.1 dB absolute and rtol 2e-3 in the linear domain (the
   JAX package's own bound), TF32 off for both; physics probes (silence is
   exactly −100 dB, a 1 kHz tone peaks in the mel bin holding 1 kHz); bad
   inputs raise; times of the kernel, the plain version and a
   ``torch.stft`` yardstick, against the function's least work (an FFT per
   frame: bound by bytes) and, labelled apart, the floor of the kernel's
   DFT-as-GEMM algorithm at the float32 peak;
4. the model's BiGRU at its serving shape in float32 and in bf16: each must
   run cuDNN's RNN cell; its device time and the bf16 error;
5. the slice: a ``Predictor`` on the card serves a 16 × 10 s request, then
   ``detect_events``, ``predict_long`` on 35 s and a ``StreamingDetector``;
   every launch counter is zeroed just before and read just after, the plain
   frontend must not run (the guard is first shown to see a CPU call), two
   clips are held against the same weights on the CPU, the bf16 model is
   held against the f32 one on the card, and latency, clips/s (f32 and bf16)
   and peak memory are measured; the bf16 model's p50 is taken with its
   BiGRU in bf16 and in float32, alternated.

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
# bf16 compute (params f32, f32 accumulation) against f32, on probabilities:
# bf16's 8-bit mantissa gives ~0.4% relative error per rounding, and a few
# percent of a logit moves a sigmoid by well under 0.05.
BF16_ATOL = 0.05


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


def phase_build(logmel_cuda):
    t0 = time.perf_counter()
    logmel_cuda.build()
    secs = time.perf_counter() - t0
    print(f"[build] ops/csrc/logmel.cu for sm_90a in {secs:.2f} s")
    for line in (logmel_cuda.BUILD_LOG or "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")
    return secs


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
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    gemm_flops = logmel_cuda.dft_gemm_flops(cfg, BATCH, cfg.clip_samples)
    gemm_floor_ms = gemm_flops / PEAK_F32_FLOPS * 1e3
    print(f"[kernel] B={BATCH}: wrapper (pad + kernel) {ms:.4f} / {ms_2:.4f} ms, "
          f"kernel alone (profiler) "
          f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'}, "
          f"plain {plain_ms:.4f} ms, torch.stft yardstick {library_ms:.4f} ms "
          f"(max |Δ| {lib_err:.3e} dB); bound of the function {bound_ms:.4f} ms "
          f"by {'operations' if t_ops >= t_bytes else 'bytes'} (FFT count "
          f"{flops / 1e9:.4f} GFLOP at 67 TFLOP/s f32 = {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.3f} MB at 3.35 TB/s = {t_bytes:.4f} ms); floor of "
          f"the DFT-as-GEMM algorithm at f32 FMA {gemm_floor_ms:.4f} ms "
          f"({gemm_flops / 1e9:.3f} GFLOP) [{card}]")
    return {"name": "logmel", "route": "cuda",
            "source": "sound_event_detection_dcase2017_task4_torch/ops/csrc/logmel.cu",
            "replaces": "sound_event_detection_dcase2017_task4_tpu/ops/"
                        "pallas_logmel.py:208 (logmel_pallas)",
            "launches": None, "max_abs_err": err_db, "ms": ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _device_kernels(torch, fn):
    """``(wall_ms, [(ms, count, name), ...])``: the device kernels and copies
    of one call of ``fn`` under torch.profiler, heaviest first, and the
    call's wall time under the profiler (after one call outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the operators that
        # launched them report the same time again
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("Activity Buffer")):
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
    variants = {"bf16": own, "f32": lambda x: own(x.float()).to(x.dtype)}
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import sound_event_detection_dcase2017_task4_torch as sedt
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda

    name, card = phase_device(torch)
    phase_build(logmel_cuda)
    kernel = phase_kernel(torch, sedt, card)
    phase_gru(torch, card)
    kernel["launches"] = phase_slice(torch, sedt, card)
    forbidden = [m for m in ("jax", "flax", "optax",
                             "sound_event_detection_dcase2017_task4_tpu")
                 if m in sys.modules]
    if forbidden:
        raise AssertionError(f"the port pulled in {forbidden}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
