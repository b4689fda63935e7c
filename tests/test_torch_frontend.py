"""Port frontend (plain PyTorch log-mel + kernel plan) vs the JAX package.

The same numpy-seeded waveforms go through the JAX reference (``stft.logmel``
and ``logmel_pallas`` in interpret mode, as the JAX package's own tests run
it) and through the port. Tolerance: 0.1 dB absolute and rtol 2e-3 in the
linear domain — the JAX package's own kernel-vs-XLA bound
(``tests/test_pallas_logmel.py``): float32 sums in another order, amplified
by log10 on near-zero mel bins.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu.ops import stft as jstft
from sound_event_detection_dcase2017_task4_tpu.ops.pallas_logmel import logmel_pallas
from sound_event_detection_dcase2017_task4_torch import config
from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_db_close(out, ref):
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-1, rtol=0)
    np.testing.assert_allclose(10.0 ** (out / 10.0), 10.0 ** (ref / 10.0),
                               rtol=2e-3, atol=1e-10)


def _both_cfgs(**kw):
    return config.Config(**kw), jconfig.Config(**kw)


def _port(x, cfg):
    return stft.logmel(torch.from_numpy(x), cfg).numpy()


def _kernel_formula(x, cfg):
    """The kernel's arithmetic on the CPU from ``logmel_cuda.plan``: per pass
    of BINS_PER_PASS bins, frames @ [cos | sin] → power → partial mel sums;
    then log10. Checks the host constants the CUDA kernel is fed."""
    basis, melw, _ = logmel_cuda.plan(cfg)
    bn = logmel_cuda.BINS_PER_PASS
    pad = cfg.window_size // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (pad, pad)), mode=cfg.pad_mode)
    n_frames = 1 + x.shape[1] // cfg.hop_size
    k_pad = basis.shape[1]
    xp = np.pad(xp, ((0, 0), (0, k_pad)))
    idx = (np.arange(n_frames)[:, None] * cfg.hop_size
           + np.arange(k_pad)[None, :])
    frames = xp[:, idx]                                   # [B, T, k_pad]
    mel = 0.0
    for p in range(basis.shape[0]):
        re = frames @ basis[p, :, :bn]
        im = frames @ basis[p, :, bn:]
        mel = mel + (re * re + im * im) @ melw[p * bn:(p + 1) * bn]
    ref_db = 10.0 * np.log10(max(cfg.log_amin, cfg.log_ref))
    return (10.0 * np.log10(np.maximum(cfg.log_amin, mel)) - ref_db
            ).astype(np.float32)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.RandomState(7)
    t = np.arange(32000) / 32000.0
    clips = [
        0.5 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(32000),
        0.2 * np.sin(2 * np.pi * 2000 * t) * np.sin(2 * np.pi * 3 * t),
        rng.randn(32000) * 0.1,
    ]
    return np.stack(clips).astype(np.float32)


def test_dcase_config_matches_jax(wave):
    """One 10 s clip at the DCASE config against the Pallas kernel in
    interpret mode and the XLA path."""
    cfg, jcfg = config.DEFAULT, jconfig.DEFAULT
    x = np.tile(wave[:1], (1, 10)).astype(np.float32)
    assert x.shape == (1, cfg.clip_samples)
    out = _port(x, cfg)
    assert out.shape == (1, cfg.frames_num, cfg.mel_bins)
    _assert_db_close(out, np.asarray(logmel_pallas(x, jcfg, interpret=True)))
    _assert_db_close(out, np.asarray(jstft.logmel(x, jcfg)))


@pytest.mark.parametrize("win,hop,mel", [(640, 200, 32), (512, 160, 40),
                                         (2048, 640, 128)])
def test_dsp_configs_match_jax(win, hop, mel):
    cfg, jcfg = _both_cfgs(clip_samples=16000, window_size=win, hop_size=hop,
                           mel_bins=mel, fmax=15000)
    x = (np.random.RandomState(0).randn(2, 16000) * 0.2).astype(np.float32)
    out = _port(x, cfg)
    assert out.shape == (2, 1 + 16000 // hop, mel)
    _assert_db_close(out, np.asarray(logmel_pallas(x, jcfg, interpret=True)))
    _assert_db_close(out, np.asarray(jstft.logmel(x, jcfg)))


def test_fmax_nyquist_matches_jax(wave):
    """fmax = Nyquist: 513 bins, the top one has zero mel weight, so the
    kernel's plan uses 512."""
    cfg, jcfg = _both_cfgs(clip_samples=16000, fmax=16000)
    assert logmel_cuda.plan(cfg)[2] == 512
    x = wave[:, :16000]
    out = _port(x, cfg)
    _assert_db_close(out, np.asarray(logmel_pallas(x, jcfg, interpret=True)))
    _assert_db_close(out, np.asarray(jstft.logmel(x, jcfg)))


def test_top_db_matches_jax(wave):
    cfg, jcfg = _both_cfgs(clip_samples=32000, log_top_db=15.0)
    out = _port(wave, cfg)
    _assert_db_close(out, np.asarray(logmel_pallas(wave, jcfg, interpret=True)))
    _assert_db_close(out, np.asarray(jstft.logmel(wave, jcfg)))
    for i in range(out.shape[0]):              # the clamp actually bit
        assert out[i].min() >= out[i].max() - 15.0 - 1e-4
        assert np.isclose(out[i].min(), out[i].max() - 15.0, atol=1.0)


def test_kernel_plan_dcase():
    """The kernel's constants at the DCASE config: 448 bins (the last
    non-zero mel weight is bin 447) in 7 passes of 64, K = 1024."""
    basis, melw, n_used = logmel_cuda.plan(config.DEFAULT)
    assert n_used == 448
    assert basis.shape == (7, 1024, 2 * logmel_cuda.BINS_PER_PASS)
    assert melw.shape == (448, 64)
    gemm = logmel_cuda.dft_gemm_flops(config.DEFAULT, 16, 320000)
    assert gemm == 2 * 16 * 1001 * (1024 * 896 + 448 * 64)
    assert abs(gemm / 1e9 - 30.3) < 0.1
    # the function's least work: an FFT per frame, so far fewer operations
    # than the GEMM algorithm, and bound by bytes at the H100's peaks
    flops, nbytes = logmel_cuda.flops_and_bytes(config.DEFAULT, 16, 320000)
    assert 0.3e9 < flops < 0.4e9
    assert nbytes == 4 * (16 * 320000 + 448 * 64 + 16 * 1001 * 64)
    assert nbytes / 3.35e12 > flops / 67e12


@pytest.mark.parametrize("kw", [
    dict(clip_samples=16000),
    dict(clip_samples=16000, window_size=640, hop_size=200, mel_bins=32,
         fmax=15000),
    dict(clip_samples=16000, window_size=2048, hop_size=640, mel_bins=128,
         fmax=15000),
    dict(clip_samples=16000, fmax=16000),
    dict(clip_samples=16123, window_size=500, hop_size=130, mel_bins=40),
])
def test_kernel_formula_matches_plain(wave, kw):
    """The trimmed, pass-split basis and mel bank the CUDA kernel reads give
    the plain version's log-mel (clip lengths that are not a multiple of
    hop, windows that are not a multiple of the K tile included)."""
    cfg = config.Config(**kw)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, cfg.clip_samples) * 0.2).astype(np.float32)
    _assert_db_close(_kernel_formula(x, cfg), _port(x, cfg))


def test_frontend_takes_plain_version_on_cpu(wave):
    """A CPU tensor goes to the plain version, chosen by its device alone;
    no kernel launch is counted."""
    cfg = config.Config(clip_samples=32000)
    before = logmel_cuda.LAUNCHES
    x = torch.from_numpy(wave)
    for precision in ("highest", "fast"):
        got = stft.make_logmel_fn(cfg, precision=precision)(x)
        torch.testing.assert_close(got, stft.logmel(x, cfg), rtol=0, atol=0)
    assert logmel_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        stft.make_logmel_fn(cfg, precision="bf16")
    with pytest.raises(ValueError, match="CUDA tensor"):
        logmel_cuda.logmel_cuda(x, cfg)


def test_importing_the_kernel_module_needs_no_nvcc_or_gpu(tmp_path):
    """Importing ops/logmel_cuda.py builds nothing: no nvcc on PATH, no GPU
    visible, and the CPU path still serves."""
    code = (
        "import torch\n"
        "from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda\n"
        "from sound_event_detection_dcase2017_task4_torch.config import Config\n"
        "assert logmel_cuda._lib is None and logmel_cuda.BUILD_LOG is None\n"
        "from sound_event_detection_dcase2017_task4_torch.ops.stft import make_logmel_fn\n"
        "y = make_logmel_fn(Config(clip_samples=16000))(torch.zeros(1, 16000))\n"
        "assert y.shape == (1, 51, 64) and logmel_cuda.LAUNCHES == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert not (tmp_path / "_build").exists()
