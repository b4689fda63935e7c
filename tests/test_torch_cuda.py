"""Port tests that need the NVIDIA card (marker ``cuda``; they skip without one).

Run them on the card, where the JAX package need not be installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The hand-written log-mel kernel (both entries: waveform batches and the
int16/float32 corpus bank) is held to its plain PyTorch version on the card
(TF32 off): 0.1 dB absolute and rtol 2e-3 in the linear domain; the int16
bank launch is bit-equal to the waveform launch on the decoded rows. The
CLI trains on the card through the bank kernel (device cache on) and the
waveform kernel (off); the GLU and Transformer steps match the CPU's;
``calculate_feature_for_all_audio_files`` packs WAVs through the waveform
kernel as the CPU does; the data-parallel step under a 1-rank NCCL group
equals the step with no group; ``examples.minimal_train`` with no device
trains through the waveform kernel. This file imports nothing of the JAX
package.
"""

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import (config, features,
                                                         main, serving, trace,
                                                         train)
from sound_event_detection_dcase2017_task4_torch.data import hdf5
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft

pytestmark = pytest.mark.cuda


def _launches(entry: str) -> int:
    """The kernel entry's launches so far (``ops.<entry>.launches``)."""
    return trace.counters().get(f"ops.{entry}.launches", 0)


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
    before = _launches("logmel")
    got = stft.make_logmel_fn(cfg)(x)
    want = stft.logmel(x, cfg)
    torch.cuda.synchronize()
    assert _launches("logmel") == before + 1
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
    before = _launches("logmel")
    out = pred(wave)
    assert _launches("logmel") == before + 1
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
    before = _launches("logmel_bank")
    got = stft.make_logmel_bank_fn(cfg, wave_scale=scale)(bank, idx)
    assert _launches("logmel_bank") == before + 1
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


@pytest.mark.parametrize("kw", [dict(block="glu", remat=True),
                                dict(seq="transformer")],
                         ids=["glu-remat", "transformer"])
def test_glu_and_transformer_steps_on_the_card_match_the_cpu(cuda, kw):
    """One f32 step of the GLU CNN (with ``remat``) and of the
    CNN-Transformer over an int16 bank, every dropout 0, on the card (bank
    kernel, cuDNN, the attention's products) and on the CPU: the ROADMAP
    ground-rule tolerances."""
    cfg = config.Config(clip_samples=16000)
    _, staged = _bank(cfg)
    idx = np.array([1, 3, 0, 3])
    y = (np.random.RandomState(3).rand(4, 17) < 0.3).astype(np.float32)
    scale = 2.0 ** -15
    runs = []
    for dev in ("cuda", "cpu"):
        model = SedCnn(channels=(8, 16), dropout=0.0, **kw,
                       generator=torch.Generator().manual_seed(0))
        for layer in model.transformer or ():
            layer.dropout = 0.0
        state = train.create_train_state(model, cfg, device=dev,
                                         warmup_steps=0, grad_clip=0.0)
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


@pytest.mark.parametrize("mode", ["on", "off"])
def test_cli_trains_through_the_kernels(cuda, tmp_path, mode):
    """``main train`` for 4 steps on the card over a tiny packed workspace
    (evals at 0 and 4, one train and one test batch each): the device cache
    launches the bank kernel once per step and eval step, host-fed int16
    batches the waveform kernel."""
    ws = str(tmp_path / "ws")
    before = _launches("logmel")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=8",
                   "--num_test=4", "--num_eval=4", "--clip_seconds=0.5",
                   "--metadata_only"])                    # device → cuda
    assert _launches("logmel") == before + 3             # one batch a split
    b1, b2 = _launches("logmel_bank"), _launches("logmel")
    run = main.main(["train", f"--workspace={ws}", "--batch_size=4",
                     "--model_type=Cnn_5layers_AvgPooling",
                     "--feature_source=waveform", "--augmentation=mixup",
                     f"--device_cache={mode}", "--stop_iteration=4",
                     "--eval_interval=4", "--eval_max_iteration=1"])
    torch.cuda.synchronize()
    launches = (_launches("logmel_bank") - b1, _launches("logmel") - b2)
    assert launches == ((8, 0) if mode == "on" else (0, 8))
    assert run["iteration"] == 4 and np.isfinite(run["loss"])


def test_wav_packing_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Stage 1 from WAVs (the native decoder) on the card and on the CPU:
    the same names, targets and int16 rows; features within 0.1 dB; one
    waveform kernel launch per batch on the card."""
    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=6",
                   "--num_test=2", "--num_eval=2", "--clip_seconds=0.5"])
    packed = {}
    for dev in ("cuda", "cpu"):
        before = _launches("logmel")
        features.main(["calculate_feature_for_all_audio_files",
                       f"--dataset_dir={ws}/synth_dataset",
                       f"--workspace={tmp_path / dev}", "--data_type=training",
                       "--batch_size=4", "--clip_seconds=0.5"],
                      device=None if dev == "cuda" else "cpu")
        torch.cuda.synchronize()
        assert _launches("logmel") - before == (2 if dev == "cuda" else 0)
        packed[dev] = hdf5.read_split(str(tmp_path / dev / "features" / "training.h5"),
                                      load_waveform=True)
    gpu, cpu = packed["cuda"], packed["cpu"]
    assert gpu.audio_names == cpu.audio_names and len(gpu) == 6
    np.testing.assert_array_equal(gpu.target, cpu.target)
    np.testing.assert_array_equal(gpu.waveform.raw, cpu.waveform.raw)
    np.testing.assert_allclose(gpu.feature, cpu.feature, atol=0.1, rtol=0)


def test_one_rank_nccl_step_equals_the_ungrouped_step(cuda, tmp_path):
    """The data-parallel step under a 1-rank NCCL group (over a
    ``FileStore``) on the card: 3 f32 steps with dropout 0.2, mixup and
    SpecAugment equal the same steps with no group at the train-step
    tolerances, and a step issues one all-reduce per BatchNorm layer each
    way and one for the gradients."""
    import datetime

    import torch.distributed as dist

    from sound_event_detection_dcase2017_task4_torch import parallel

    cfg = config.Config(clip_samples=16000)
    _, staged = _bank(cfg)
    idx = np.array([1, 3, 0, 3])
    y = (np.random.RandomState(3).rand(4, 17) < 0.3).astype(np.float32)
    scale = 2.0 ** -15
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    calls, all_reduce = [0], dist.all_reduce

    def counting(*a, **k):
        calls[0] += 1
        return all_reduce(*a, **k)

    runs = []
    try:
        for mesh in (None, parallel.make_mesh(dev)):
            model = SedCnn(channels=(8, 16), seq="gru", gru_hidden=16, dropout=0.2,
                           generator=torch.Generator().manual_seed(0))
            state = train.create_train_state(model, cfg, device=dev)
            step = train.make_train_step(
                model, state, bank=torch.from_numpy(staged).to(dev), wave_scale=scale,
                mixup_alpha=1.0, use_spec_augment=True, mesh=mesh,
                bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=scale))
            calls[0] = 0
            dist.all_reduce = counting
            try:
                ms = [step(idx, y) for _ in range(3)]
            finally:
                dist.all_reduce = all_reduce
            runs.append(([float(m["loss"]) for m in ms],
                         [float(m["grad_norm"]) for m in ms],
                         {k: v.cpu() for k, v in model.state_dict().items()
                          if "running" in k}, calls[0]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs
    assert (c0, c1) == (0, 3 * (2 * 4 + 1))        # 4 BatchNorm layers
    np.testing.assert_allclose(l1, l0, rtol=2e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-4)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-4, atol=1e-5)


def test_minimal_train_example_runs_through_the_waveform_kernel(cuda, monkeypatch):
    """``examples.minimal_train`` with no device runs on the card: 3 steps
    and one eval batch, one waveform kernel launch each, and the plain
    frontends never run."""
    from sound_event_detection_dcase2017_task4_torch.examples import minimal_train

    plain = []
    for name in ("logmel", "logmel_bank"):
        fn = getattr(stft, name)
        monkeypatch.setattr(stft, name,
                            lambda *a, _fn=fn, _n=name, **k: (plain.append(_n),
                                                              _fn(*a, **k))[1])
    b1, b2 = _launches("logmel_bank"), _launches("logmel")
    events = minimal_train.main(steps=3)
    torch.cuda.synchronize()
    assert (_launches("logmel_bank") - b1, _launches("logmel") - b2) == (0, 4)
    assert plain == []
    assert len(events) == 4 and all(isinstance(e, list) for e in events)
