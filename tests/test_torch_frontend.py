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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu.ops import pallas_logmel as jpl
from sound_event_detection_dcase2017_task4_tpu.ops import stft as jstft
from sound_event_detection_dcase2017_task4_tpu.ops.pallas_logmel import logmel_pallas
from sound_event_detection_dcase2017_task4_torch import config, trace
from sound_event_detection_dcase2017_task4_torch.ops import dsp, logmel_cuda, stft

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches(entry: str) -> int:
    """The kernel entry's launches so far (``ops.<entry>.launches``)."""
    return trace.counters().get(f"ops.{entry}.launches", 0)


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
    """The kernel's arithmetic on the CPU in float32, from
    ``logmel_cuda.plan``'s own tables: the windowed frame's even/odd samples
    packed into M = win/2 complex points, the Stockham stages in the plan's
    factor order (point ``i + r·M/R`` times twiddle ``(r-1)·p + k`` into
    butterfly ``i``, outputs to ``(i-k)·R + k + q·p``), the real split with
    the plan's ``e^{-2πik/win}``, power, the sparse per-band mel sums, then
    log10 in double. Checks the host tables the CUDA kernel is fed and the
    index arithmetic it runs."""
    pl = logmel_cuda.plan(cfg)
    win, hop, m = cfg.window_size, cfg.hop_size, cfg.window_size // 2
    pad = win // 2
    xp = np.pad(x.astype(np.float32), ((0, 0), (pad, pad)), mode=cfg.pad_mode)
    n_frames = 1 + x.shape[1] // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    y = xp[:, idx] * pl.window                            # [B, T, win] f32
    z = (y[..., 0::2] + np.complex64(1j) * y[..., 1::2]).astype(np.complex64)
    tw = (pl.twiddle[:, 0] + 1j * pl.twiddle[:, 1]).astype(np.complex64)
    p = 1
    for radix, p_stage, tw_off, dft_off in pl.stages:
        assert p_stage == p
        nb = m // radix
        i = np.arange(nb)
        k = i % p
        r = np.arange(radix)[:, None]
        u = z[..., i[None, :] + r * nb]                   # [B, T, R, nb]
        u[..., 1:, :] *= tw[tw_off + (r[1:] - 1) * p + k[None, :]]
        if dft_off >= 0:                                  # generic radix
            dtab = tw[dft_off:dft_off + radix]
        else:                                             # written out
            dtab = np.exp(-2j * np.pi * np.arange(radix) / radix).astype(
                np.complex64)
        dmat = dtab[(r * r.T) % radix]                    # [q, r]
        out = np.empty_like(z)
        out[..., ((i - k) * radix + k)[None, :] + r * p] = np.einsum(
            "qr,...rn->...qn", dmat, u)
        z, p = out, p * radix
    assert p == m
    kk = np.arange(pl.n_used)
    a, c = z[..., kk % m], np.conj(z[..., (m - kk) % m])
    split = (pl.split[:, 0] + 1j * pl.split[:, 1]).astype(np.complex64)
    spec = np.float32(0.5) * (a + c) + split * (
        np.complex64(-0.5j) * (a - c))
    power = (spec.real * spec.real + spec.imag * spec.imag).astype(np.float32)
    mel = np.zeros(power.shape[:-1] + (cfg.mel_bins,), np.float32)
    for b, (lo, hi, off, _) in enumerate(pl.bands):
        mel[..., b] = power[..., lo:hi] @ pl.band_w[off:off + hi - lo]
    ref_db = 10.0 * np.log10(max(cfg.log_amin, cfg.log_ref))
    return (10.0 * np.log10(np.maximum(cfg.log_amin, mel.astype(np.float64)))
            - ref_db).astype(np.float32)


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
    assert logmel_cuda.plan(cfg).n_used == 512
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
    """The kernel's tables at the DCASE config: 448 bins (the last non-zero
    mel weight is bin 447), a 512-point FFT in three radix-8 stages, each
    bin in at most two bands, and compact band weights equal to
    ``mel_filterbank``."""
    cfg = config.DEFAULT
    pl = logmel_cuda.plan(cfg)
    assert pl.n_used == 448
    assert pl.factors == (8, 8, 8)
    np.testing.assert_array_equal(pl.stages[:, :2], [[8, 1], [8, 8], [8, 64]])
    assert (pl.stages[:, 3] == -1).all()              # no generic stage
    assert pl.twiddle.shape == (7 * (1 + 8 + 64), 2)
    np.testing.assert_array_equal(pl.window, dsp.hann_window(1024))
    assert pl.split.shape == (448, 2)
    np.testing.assert_allclose(pl.split[1], [np.cos(2 * np.pi / 1024),
                                             -np.sin(2 * np.pi / 1024)])
    mel = dsp.mel_filterbank(cfg.sample_rate, 1024, 64, cfg.fmin, cfg.fmax)
    dense = np.zeros((448, 64), np.float32)
    feeds = np.zeros(448, int)
    for b, (lo, hi, off, _) in enumerate(pl.bands):
        assert 0 <= lo < hi <= 448
        dense[lo:hi, b] = pl.band_w[off:off + hi - lo]
        feeds[lo:hi] += 1
    assert feeds.max() == 2
    np.testing.assert_array_equal(dense, mel[:448])
    assert not mel[448:].any()
    assert len(pl.band_w) == np.count_nonzero(mel)
    # one block: 16 frames of a clip in ≈ 107 KB, so two fit on an SM
    smem = logmel_cuda.shared_bytes(cfg)
    assert 100_000 < smem <= (228 * 1024) // 2 - 1024
    # the function's least work: an FFT per frame, bound by bytes at the
    # H100's peaks for 16 float waveforms
    flops, nbytes = logmel_cuda.flops_and_bytes(cfg, 16, 320000)
    assert 0.3e9 < flops < 0.4e9
    assert nbytes == 4 * (16 * 320000 + 448 * 64 + 16 * 1001 * 64)
    assert nbytes / 3.35e12 > flops / 67e12


@pytest.mark.parametrize("win,factors", [(1024, (8, 8, 8)),
                                         (2048, (8, 8, 8, 2)),
                                         (640, (8, 8, 5)),
                                         (500, (2, 5, 5, 5)),
                                         (1152, (8, 8, 3, 3)),
                                         (1018, (509,))])
def test_kernel_plan_factors(win, factors):
    """Radix 8 first, then 4 and 2, then odd primes (509 is a generic
    radix-509 stage); the stage twiddles are e^{-2πi·r·k/(pR)} and a
    generic stage carries its DFT table."""
    pl = logmel_cuda.plan(config.Config(window_size=win, clip_samples=16000))
    assert pl.factors == factors and int(np.prod(factors)) == win // 2
    tw = pl.twiddle[:, 0] + 1j * pl.twiddle[:, 1]
    p = 1
    for radix, p_stage, tw_off, dft_off in pl.stages:
        assert p_stage == p
        k, r = np.arange(p), np.arange(1, radix)[:, None]
        np.testing.assert_allclose(
            tw[tw_off:tw_off + (radix - 1) * p],
            np.exp(-2j * np.pi * r * k / (p * radix)).ravel(), atol=1e-7)
        assert (dft_off >= 0) == (radix not in (2, 4, 8))
        if dft_off >= 0:
            np.testing.assert_allclose(
                tw[dft_off:dft_off + radix],
                np.exp(-2j * np.pi * np.arange(radix) / radix), atol=1e-7)
        p *= radix


@pytest.mark.parametrize("win", [1023, 501])
def test_odd_window_raises_in_the_kernel_wrappers(win):
    """An odd window raises ``ValueError`` in both CUDA wrappers' host
    checks, before any device is needed (the JAX package's two frontends
    disagree on its frame count); the plain version still serves it."""
    cfg = config.Config(clip_samples=16000, window_size=win)
    x = torch.zeros(1, 16000)
    with pytest.raises(ValueError, match="even window"):
        logmel_cuda.logmel_cuda(x, cfg)
    with pytest.raises(ValueError, match="even window"):
        logmel_cuda.logmel_cuda_bank(torch.zeros(1, 4, 320), [0], cfg)
    with pytest.raises(ValueError, match="even window"):
        logmel_cuda.plan(cfg)
    assert stft.make_logmel_fn(cfg)(x).shape[-1] == cfg.mel_bins


@pytest.mark.parametrize("kw", [
    dict(clip_samples=16000),
    dict(clip_samples=16000, window_size=640, hop_size=200, mel_bins=32,
         fmax=15000),
    dict(clip_samples=16000, window_size=2048, hop_size=640, mel_bins=128,
         fmax=15000),
    dict(clip_samples=16000, fmax=16000),
    dict(clip_samples=16123, window_size=500, hop_size=130, mel_bins=40),
    dict(clip_samples=16000, window_size=1018),          # M = 509: generic
    dict(clip_samples=16257, window_size=1152, hop_size=128,
         fmax=15000),                                    # M = 576: radix 3
])
def test_kernel_formula_matches_plain(wave, kw):
    """The FFT plan the CUDA kernel reads, run through its arithmetic in
    float32, gives the plain version's log-mel (clip lengths that are not
    a multiple of hop, radix-5, radix-3 and prime generic stages, and an
    odd hop included)."""
    cfg = config.Config(**kw)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, cfg.clip_samples) * 0.2).astype(np.float32)
    _assert_db_close(_kernel_formula(x, cfg), _port(x, cfg))


def test_frontend_takes_plain_version_on_cpu(wave):
    """A CPU tensor goes to the plain version, chosen by its device alone;
    no kernel launch is counted."""
    cfg = config.Config(clip_samples=32000)
    before = _launches("logmel")
    x = torch.from_numpy(wave)
    for precision in ("highest", "fast"):
        got = stft.make_logmel_fn(cfg, precision=precision)(x)
        torch.testing.assert_close(got, stft.logmel(x, cfg), rtol=0, atol=0)
    assert _launches("logmel") == before
    with pytest.raises(ValueError):
        stft.make_logmel_fn(cfg, precision="bf16")
    with pytest.raises(ValueError, match="CUDA tensor"):
        logmel_cuda.logmel_cuda(x, cfg)


CHUNK_CFGS = [dict(),                                    # DCASE: [N, 1032, 320]
              dict(clip_samples=16257, window_size=1152, hop_size=128,
                   fmax=15000)]                           # not a hop multiple


@pytest.mark.parametrize("kw", CHUNK_CFGS)
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_chunks_equal_jax_bit_for_bit(kw, dtype):
    """Port ``prepare_chunks`` / ``unstage_chunks`` give the JAX package's
    bytes, for numpy and tensor input, float32 and int16 (kept int16)."""
    cfg, jcfg = _both_cfgs(**kw)
    rng = np.random.RandomState(11)
    x = rng.randn(2, cfg.clip_samples) * 0.2
    x = (np.round(x * 32768).astype(dtype) if dtype == np.int16
         else x.astype(dtype))
    want = np.asarray(jpl.prepare_chunks(x, jcfg))
    n_rows = stft._geometry(cfg, cfg.clip_samples)[-1]
    assert n_rows == jpl._geometry(jcfg, cfg.clip_samples)[-1]
    if not kw:
        assert want.shape == (2, 1032, 320)
    for got in (stft.prepare_chunks(x, cfg),
                stft.prepare_chunks(torch.from_numpy(x), cfg).numpy()):
        assert got.dtype == want.dtype == dtype
        assert got.shape == want.shape == (2, n_rows, cfg.hop_size)
        assert got.tobytes() == want.tobytes()
    back = stft.unstage_chunks(torch.from_numpy(want), cfg).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jpl.unstage_chunks(want, jcfg)))
    with pytest.raises(ValueError, match="prepare_chunks"):
        stft.unstage_chunks(torch.from_numpy(x), cfg)


def _bank_case():
    cfg, jcfg = _both_cfgs(clip_samples=32000)
    rng = np.random.RandomState(12)
    wave = rng.randn(4, cfg.clip_samples) * 0.1
    wave[1] += 0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(32000) / 32000.0)
    q = np.clip(np.round(wave * 32768), -32768, 32767).astype(np.int16)
    idx = np.array([2, 0, 2], np.int32)                  # a duplicate row
    return cfg, jcfg, q, idx


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_bank_frontend_matches_jax(kind):
    """``make_logmel_bank_fn`` on a CPU bank against the TPU bank kernel in
    interpret mode and the JAX package's XLA bank frontend, for an int16
    bank (scale 2⁻¹⁵) and its decoded float32 copy, with a duplicate index."""
    cfg, jcfg, q, idx = _bank_case()
    scale = 1.0 / 32768.0
    src = q if kind == "int16" else q.astype(np.float32) * np.float32(scale)
    ws = scale if kind == "int16" else None
    bank = stft.prepare_chunks(src, cfg)
    before = _launches("logmel_bank")
    got = stft.make_logmel_bank_fn(cfg, wave_scale=ws)(
        torch.from_numpy(bank), idx).numpy()
    assert _launches("logmel_bank") == before
    assert got.shape == (3, cfg.frames_num, cfg.mel_bins)
    np.testing.assert_array_equal(got[0], got[2])
    jbank = jnp.asarray(bank)
    _assert_db_close(got, np.asarray(jpl.logmel_pallas_bank(
        jbank, jnp.asarray(idx), jcfg, wave_scale=ws, interpret=True)))
    _assert_db_close(got, np.asarray(jstft.make_logmel_bank_fn(
        jcfg, use_pallas=False, wave_scale=ws)(jbank, jnp.asarray(idx))))
    # the plain bank version is gather → decode → un-stage → logmel
    dec = q.astype(np.float32) * np.float32(scale)
    np.testing.assert_array_equal(
        got, stft.logmel(torch.from_numpy(dec[idx]), cfg).numpy())


def test_bank_frontend_takes_a_reversed_index_view():
    """A numpy index with negative strides (``idx[::-1]``) gathers the rows
    in that order, as the JAX package's XLA bank frontend does."""
    cfg, jcfg, q, _ = _bank_case()
    scale = 1.0 / 32768.0
    bank = stft.prepare_chunks(q, cfg)
    idx = np.array([0, 1, 3, 2], np.int32)[::-1]
    fn = stft.make_logmel_bank_fn(cfg, wave_scale=scale)
    got = fn(torch.from_numpy(bank), idx).numpy()
    np.testing.assert_array_equal(
        got, fn(torch.from_numpy(bank), idx.copy()).numpy())
    _assert_db_close(got, np.asarray(jstft.make_logmel_bank_fn(
        jcfg, use_pallas=False, wave_scale=scale)(jnp.asarray(bank), idx)))


def test_staged_input_equals_waveform_input():
    """3-D staged rows to ``make_logmel_fn`` give exactly the 2-D result, as
    in the JAX package, whose XLA frontend they match to the usual bound."""
    cfg, jcfg, q, _ = _bank_case()
    x = q.astype(np.float32) / 32768.0
    fn = stft.make_logmel_fn(cfg)
    flat = fn(torch.from_numpy(x))
    staged = fn(torch.from_numpy(stft.prepare_chunks(x, cfg)))
    torch.testing.assert_close(staged, flat, rtol=0, atol=0)
    _assert_db_close(staged.numpy(), np.asarray(jstft.make_logmel_fn(jcfg)(
        jnp.asarray(jpl.prepare_chunks(x, jcfg)))))


def test_bank_frontend_rejects_what_jax_rejects():
    """An integer bank without ``wave_scale``, a scale that is not a power of
    two and the wrong chunk geometry raise, as ``logmel_pallas_bank``
    does; a CUDA index tensor or an index out of range raise in the kernel
    wrapper's host check."""
    cfg, _, q, idx = _bank_case()
    bank = torch.from_numpy(stft.prepare_chunks(q, cfg))
    with pytest.raises(ValueError, match="wave_scale"):
        stft.make_logmel_bank_fn(cfg)(bank, idx)
    with pytest.raises(ValueError, match="power of two"):
        stft.make_logmel_bank_fn(cfg, wave_scale=1e-4)(bank, idx)
    with pytest.raises(ValueError, match="prepare_chunks"):
        stft.make_logmel_bank_fn(cfg, wave_scale=2.0 ** -15)(
            torch.from_numpy(q), idx)
    with pytest.raises(ValueError):
        stft.make_logmel_bank_fn(cfg, precision="bf16")
    with pytest.raises(IndexError):
        logmel_cuda._host_index(np.array([0, 4]), 4)
    with pytest.raises(IndexError):
        logmel_cuda._host_index(np.array([-1]), 4)
    with pytest.raises(ValueError, match="1-D integer"):
        logmel_cuda._host_index(np.array([0.0]), 4)
    assert logmel_cuda._host_index(torch.tensor([3, 1]), 4).dtype == np.int32
    with pytest.raises(ValueError, match="CUDA bank"):
        logmel_cuda.logmel_cuda_bank(bank, idx, cfg, 2.0 ** -15)


def test_bank_bound_counts_int16_bytes():
    """``flops_and_bytes`` counts 2 bytes a sample for an int16 bank: at the
    training batch of 128 clips the function's least work is bound by
    operations, ≈ 0.04 ms at 67 TFLOP/s, beside 82 MB of int16 read."""
    cfg = config.DEFAULT
    flops, nbytes = logmel_cuda.flops_and_bytes(cfg, 128, cfg.clip_samples, 2)
    assert nbytes == 2 * 128 * 320000 + 4 * (448 * 64 + 128 * 1001 * 64)
    assert abs(flops / 1e9 - 2.65) < 0.01
    assert flops / 67e12 > nbytes / 3.35e12
    assert 0.03e-3 < flops / 67e12 < 0.05e-3
    # a gather with a duplicate reads 127 distinct rows and the int32 index
    f2, b2 = logmel_cuda.flops_and_bytes(cfg, 128, cfg.clip_samples, 2,
                                         rows_read=127)
    assert f2 == flops and b2 == nbytes - 2 * 320000 + 4 * 128


def test_importing_the_kernel_module_needs_no_nvcc_or_gpu(tmp_path):
    """Importing ops/logmel_cuda.py builds nothing: no nvcc on PATH, no GPU
    visible, and the CPU path still serves."""
    code = (
        "import torch\n"
        "from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda\n"
        "from sound_event_detection_dcase2017_task4_torch.config import Config\n"
        "assert logmel_cuda.LIBRARY._lib is None and logmel_cuda.LIBRARY.log is None\n"
        "from sound_event_detection_dcase2017_task4_torch.ops.stft import make_logmel_fn\n"
        "y = make_logmel_fn(Config(clip_samples=16000))(torch.zeros(1, 16000))\n"
        "from sound_event_detection_dcase2017_task4_torch import trace\n"
        "assert y.shape == (1, 51, 64)\n"
        "assert trace.counters().get('ops.logmel.launches', 0) == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert not (tmp_path / "_build").exists()
