"""Port tests that need the NVIDIA card (marker ``cuda``; they skip without one).

Run them on the card, where the JAX package need not be installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The hand-written log-mel kernel is held to its plain PyTorch version on the
card (TF32 off): 0.1 dB absolute and rtol 2e-3 in the linear domain.
This file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import config, serving
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


@pytest.mark.parametrize("kw", [
    {},
    dict(clip_samples=16000, window_size=640, hop_size=200, mel_bins=32,
         fmax=15000),
    dict(clip_samples=16000, window_size=2048, hop_size=640, mel_bins=128,
         fmax=15000),
    dict(clip_samples=16123, window_size=500, hop_size=130, mel_bins=40,
         log_top_db=15.0),
])
def test_kernel_matches_plain(cuda, kw):
    cfg = config.Config(**kw)
    x = torch.from_numpy((np.random.RandomState(0).randn(3, cfg.clip_samples)
                          * 0.2).astype(np.float32)).to(cuda)
    before = logmel_cuda.LAUNCHES
    got = stft.make_logmel_fn(cfg)(x)
    want = stft.logmel(x, cfg)
    torch.cuda.synchronize()
    assert logmel_cuda.LAUNCHES == before + 1
    assert got.shape == want.shape == (3, cfg.frames_num, cfg.mel_bins)
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)
    lin_g, lin_w = 10.0 ** (got.double() / 10), 10.0 ** (want.double() / 10)
    torch.testing.assert_close(lin_g, lin_w, atol=1e-10, rtol=2e-3)


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
