"""Port tests that need the NVIDIA card (marker ``cuda``; they skip without one).

Run them on the card, where the JAX package need not be installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The hand-written log-mel kernel (both entries: waveform batches and the
int16/float32 corpus bank) is held to its plain PyTorch version on the card
(TF32 off): 0.1 dB absolute and rtol 2e-3 in the linear domain; the int16
bank launch is bit-equal to the waveform launch on the decoded rows.
This file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import config, serving, train
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kw,onset", [
    ({}, False),
    ({}, True),                # zeros, then noise: an onset after silence
    (dict(clip_samples=16000, window_size=640, hop_size=200, mel_bins=32,
          fmax=15000), False),
    (dict(clip_samples=16000, window_size=2048, hop_size=640, mel_bins=128,
          fmax=15000), False),
    (dict(clip_samples=16123, window_size=500, hop_size=130, mel_bins=40,
          log_top_db=15.0), False),
    (dict(clip_samples=16000, window_size=1018), False),   # generic radix 509
])
def test_kernel_matches_plain(cuda, kw, onset):
    cfg = config.Config(**kw)
    x = np.random.RandomState(0).randn(3, cfg.clip_samples) * 0.2
    if onset:
        x[:, : cfg.clip_samples // 2] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    before = logmel_cuda.LAUNCHES
    got = stft.make_logmel_fn(cfg)(x)
    want = stft.logmel(x, cfg)
    torch.cuda.synchronize()
    assert logmel_cuda.LAUNCHES == before + 1
    assert got.shape == want.shape == (3, cfg.frames_num, cfg.mel_bins)
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)
    lin_g, lin_w = 10.0 ** (got.double() / 10), 10.0 ** (want.double() / 10)
    torch.testing.assert_close(lin_g, lin_w, atol=1e-10, rtol=2e-3)
    if onset:   # frames wholly inside the silence are exactly the floor
        silent = (cfg.clip_samples // 2 - cfg.window_size // 2) // cfg.hop_size
        assert silent > 0 and bool((got[:, :silent] == -100.0).all())


def test_kernel_rejects_bad_inputs(cuda):
    cfg = config.Config(clip_samples=16000)
    with pytest.raises(TypeError):
        logmel_cuda.logmel_cuda(torch.zeros(2, 16000, dtype=torch.float64,
                                            device=cuda), cfg)
    with pytest.raises(ValueError):
        logmel_cuda.logmel_cuda(torch.zeros(16000, 2, device=cuda).t(), cfg)
    with pytest.raises(ValueError):
        logmel_cuda.logmel_cuda(torch.zeros(2, 3, 16000, device=cuda), cfg)


def test_predictor_serves_through_the_kernel(cuda):
    cfg = config.Config(clip_samples=16000)
    model = SedCnn(channels=(8, 16), seq="gru", gru_hidden=16)
    pred = serving.Predictor(model, cfg)                     # device → cuda
    wave = (np.random.RandomState(1).randn(2, 16000) * 0.1).astype(np.float32)
    before = logmel_cuda.LAUNCHES
    out = pred(wave)
    assert logmel_cuda.LAUNCHES == before + 1
    cpu = serving.Predictor(SedCnn(channels=(8, 16), seq="gru", gru_hidden=16),
                            cfg, device="cpu")(wave)
    for k in ("clipwise_output", "framewise_output"):
        np.testing.assert_allclose(out[k], cpu[k], atol=1e-4, rtol=0)


def _bank(cfg, n=5, seed=2):
    rng = np.random.RandomState(seed)
    wave = rng.randn(n, cfg.clip_samples) * 0.1
    q = np.clip(np.round(wave * 32768), -32768, 32767).astype(np.int16)
    return q, stft.prepare_chunks(q, cfg)


@pytest.mark.parametrize("kw", [
    {},
    dict(clip_samples=16257, window_size=1152, hop_size=128, fmax=15000),
])
def test_bank_kernel_is_bit_equal_and_matches_plain(cuda, kw):
    cfg = config.Config(**kw)
    scale = 2.0 ** -15
    q, staged = _bank(cfg)
    idx = np.array([4, 0, 2, 2])                        # a duplicate row
    bank = torch.from_numpy(staged).to(cuda)
    before = logmel_cuda.BANK_LAUNCHES
    got = stft.make_logmel_bank_fn(cfg, wave_scale=scale)(bank, idx)
    assert logmel_cuda.BANK_LAUNCHES == before + 1
    dec = torch.from_numpy(q[idx].astype(np.float32) * np.float32(scale))
    assert torch.equal(got, logmel_cuda.logmel_cuda(dec.to(cuda), cfg))
    fbank = torch.from_numpy(staged.astype(np.float32) * np.float32(scale))
    assert torch.equal(got, logmel_cuda.logmel_cuda_bank(fbank.to(cuda), idx,
                                                         cfg))
    want = stft.logmel_bank(bank, idx, cfg, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, cfg.frames_num, cfg.mel_bins)
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)
    lin_g, lin_w = 10.0 ** (got.double() / 10), 10.0 ** (want.double() / 10)
    torch.testing.assert_close(lin_g, lin_w, atol=1e-10, rtol=2e-3)


def test_bank_kernel_rejects_bad_inputs(cuda):
    cfg = config.Config(clip_samples=16000)
    q, staged = _bank(cfg)
    bank = torch.from_numpy(staged).to(cuda)
    for args, err in (((bank, [0], cfg), ValueError),            # no scale
                      ((bank, [0], cfg, 1e-4), ValueError),      # not 2^k
                      ((bank[:, :-1], [0], cfg, 2.0 ** -15), ValueError),
                      ((bank, [5], cfg, 2.0 ** -15), IndexError),
                      ((bank, torch.tensor([0], device=cuda), cfg, 2.0 ** -15),
                       ValueError),
                      ((bank.double(), [0], cfg), TypeError)):
        with pytest.raises(err):
            logmel_cuda.logmel_cuda_bank(*args)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step over an int16 bank, dropout 0 and no mixup, from the
    same weights on the card (bank kernel, cuDNN) and on the CPU (plain
    frontend): the ROADMAP ground-rule tolerances."""
    cfg = config.Config(clip_samples=16000)
    _, staged = _bank(cfg)
    idx = np.array([1, 3, 0, 3])
    y = (np.random.RandomState(3).rand(4, 17) < 0.3).astype(np.float32)
    scale = 2.0 ** -15
    runs = []
    for dev in ("cuda", "cpu"):
        model = SedCnn(channels=(8, 16), seq="gru", gru_hidden=16, dropout=0.0,
                       generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, cfg, device=dev)
        step = train.make_train_step(
            model, state, bank=torch.from_numpy(staged).to(dev),
            wave_scale=scale,
            bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=scale))
        m = step(idx, y)
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     {k: v.cpu() for k, v in model.state_dict().items()
                      if "running" in k}))
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=2e-5)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=1e-4)
    for k in s_cpu:
        torch.testing.assert_close(s_gpu[k], s_cpu[k], rtol=1e-4, atol=1e-5)
