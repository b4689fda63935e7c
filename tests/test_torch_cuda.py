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
trains through the waveform kernel. The train-mode BatchNorm kernels
(``ops.bn_act``) are held to their plain versions at every block shape of
the flagship and the GLU in both layouts (NCHW and channels-last), refuse
what they do not take, run 8 and 16 times a step in those models with no
composite call, all of them on the channels-last kernels, and keep the
running statistics to one move a step under the GLU's ``remat``; a
profiled step of either model runs cuDNN's NCHW↔NHWC transposes only in
its first conv (one input channel) and copies no activation of the conv
stack; HTS-AT's train
pass through CUDA graphs takes the eager steps. HTS-AT's window-attention
kernels (``ops.window_attention``) are held to float64 beside their plain
version at the model's four stage shapes and smaller ones, repeat their
backward bit for bit, replay in a CUDA graph, count their launches, refuse
what they do not take, and serve ``remat`` and the eval forward. Audio
Mamba's selective-scan kernels (``ops.selective_scan``) are held to
float64 beside their plain version at the published widths and smaller
ones, repeat their backward bit for bit, replay in a CUDA graph, count
their launches and refuse what they do not take; Audio Mamba's train pass
through CUDA graphs takes the eager steps, and at the published widths
runs every scan on the kernels. This file imports nothing of the JAX
package.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import (config, features,
                                                         main, serving, trace,
                                                         train)
from sound_event_detection_dcase2017_task4_torch.data import hdf5
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.models import get_model
from sound_event_detection_dcase2017_task4_torch.ops import bn_act, logmel_cuda, stft

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


# --- train-mode BatchNorm (ops.bn_act) ----------------------------------------

BLOCK_SHAPES = [(8, 64, 1001, 64), (8, 128, 500, 32), (8, 256, 250, 16),
                (8, 512, 125, 8)]


def _bn_inputs(shape, dtype, act, dev, seed=0):
    """``x``, ``a``, ``b``, ``dy`` and ``gs`` as a step gives them: ``a``
    and ``b`` from ``x``'s batch statistics, ``gs`` the gradient of the
    sums under ``dy`` (``bn_act.sums_grad``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, t, f = shape
    x = (torch.randn(shape, generator=g, device=dev)
         * (0.5 + torch.rand(1, c, 1, 1, generator=g, device=dev))
         + 0.3 * torch.randn(1, c, 1, 1, generator=g, device=dev)).to(dtype)
    weight = 0.5 + torch.rand(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    out = (b, c, t // 2, f // 2) if act == "relu_pool" else shape
    dy = torch.randn(out, generator=g, device=dev).to(dtype)
    a, bb, gs = bn_act.sums_grad(x, dy, weight, bias, act)
    return x, a, bb, dy, gs


def _sums_close(got, x64_terms):
    """``got [2C]`` within float32's summation error of the float64 sums:
    1e-5 of each channel's sum of magnitudes."""
    want = torch.cat([t.sum((0, 2, 3)) for t in x64_terms])
    mag = torch.cat([t.abs().sum((0, 2, 3)) for t in x64_terms])
    assert bool(((got.double() - want).abs() <= 1e-5 * mag + 1e-30).all()), \
        float(((got.double() - want).abs() / mag).max())


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: f"{s[2]}x{s[3]}x{s[1]}")
def test_bn_act_kernels_match_plain(cuda, shape, act, dtype, layout):
    """K1-K4 against the plain versions at each conv-stack block's shape
    (batch 8), on the NCHW kernels and on the channels-last ones (``x`` and
    ``dy`` channels-last; ``y`` and ``dx`` come back so). Reductions:
    within 1e-5 of each channel's sum of magnitudes
    of the float64 sums. Elementwise outputs: 2 ulp of bf16, or 1e-5 of
    float32, away from ReLU's kink (the kernels' fused multiply-add and the
    plain version's two roundings may put a point within 1e-4 of it on
    either side); ``dx`` besides region by region against float64
    (``bn_act.grad_x_mismatch``), where ``g`` is 0 at ``c₁ + c₂·x``'s own
    scale. Reductions repeat bit for bit."""
    x, a, b, dy, gs = _bn_inputs(shape, dtype, act, cuda)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    assert bn_act.channels_last(x) == (layout == "nhwc")
    x64, dy64 = x.double(), dy.double()
    a64, b64, gs64 = a.double(), b.double(), gs.double()
    s1 = bn_act.stats_cuda(x)
    _sums_close(s1, [x64, x64 * x64])
    assert torch.equal(bn_act.stats_cuda(x), s1)
    g64 = bn_act._grad_z(dy64, x64, a64, b64, act)
    g1 = bn_act.grad_stats_cuda(dy, x, a, b, act)
    _sums_close(g1, [g64, g64 * x64])
    assert torch.equal(bn_act.grad_stats_cuda(dy, x, a, b, act), g1)

    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    away = (bn_act._z(x64, a64, b64).abs() > 1e-4) | (act == "none")
    y1, y0 = bn_act.apply_cuda(x, a, b, act), bn_act.apply_plain(x, a, b, act)
    assert y1.dtype == dtype and y1.shape == y0.shape
    assert bn_act.channels_last(y1) == (layout == "nhwc")
    keep = away if act != "relu_pool" else torch.ones_like(y1, dtype=torch.bool)
    torch.testing.assert_close(y1.float()[keep], y0.float()[keep], rtol=rtol,
                               atol=1e-5)
    d1 = bn_act.grad_x_cuda(dy, x, a, b, gs, act)
    d0 = bn_act.grad_x_plain(dy, x, a, b, gs, act)
    assert d1.dtype == dtype and d1.stride() == x.stride()
    torch.testing.assert_close(d1.float()[away], d0.float()[away], rtol=rtol,
                               atol=1e-5)
    regions = bn_act.grad_x_mismatch(
        d1, dy, x, a, b, gs, act, 2 ** -7 if dtype == torch.bfloat16 else 2 ** -20)
    want = {"none": {"g"}, "relu": {"g", "masked"},
            "relu_pool": {"g", "masked"} | ({"dropped"} if shape[2] % 2 else set())}
    assert {k for k, (_, n) in regions.items() if n} == want[act], regions
    assert all(w <= 1 for w, _ in regions.values()), regions
    torch.cuda.synchronize()


def test_bn_act_kernels_reject_bad_inputs(cuda):
    x, a, b, dy, gs = _bn_inputs((2, 4, 6, 8), torch.bfloat16, "relu", cuda)
    cl = torch.channels_last
    # channels-last is the conv stack's layout: taken, and y keeps it
    torch.testing.assert_close(bn_act.stats_cuda(x.contiguous(memory_format=cl)),
                               bn_act.stats_cuda(x), rtol=1e-6, atol=1e-6)
    assert bn_act.channels_last(bn_act.apply_cuda(x.contiguous(memory_format=cl),
                                                  a, b, "relu"))
    # [B, T, C, F] in memory: neither NCHW nor channels-last
    btcf = x.transpose(1, 2).contiguous().transpose(1, 2)
    for fn, args, err in (
            (bn_act.stats_cuda, (x.cpu(),), ValueError),
            (bn_act.stats_cuda, (x.transpose(2, 3),), ValueError),
            (bn_act.stats_cuda, (btcf,), ValueError),
            (bn_act.grad_stats_cuda, (dy, x.contiguous(memory_format=cl), a, b, "relu"),
             ValueError),
            (bn_act.stats_cuda, (x.half(),), TypeError),
            (bn_act.stats_cuda, (x.double(),), TypeError),
            (bn_act.stats_cuda, (x[0],), ValueError),
            (bn_act.apply_cuda, (x, a.half(), b, "relu"), ValueError),
            (bn_act.apply_cuda, (x, a[:3], b, "relu"), ValueError),
            (bn_act.apply_cuda, (x, a, b, "gelu"), ValueError),
            (bn_act.apply_cuda, (x[:, :, :1].contiguous(), a, b, "relu_pool"), ValueError),
            (bn_act.grad_stats_cuda, (dy.float(), x, a, b, "relu"), ValueError),
            (bn_act.grad_stats_cuda, (dy[:, :, :3], x, a, b, "relu"), ValueError),
            (bn_act.grad_x_cuda, (dy, x, a, b, gs[:4], "relu"), ValueError)):
        with pytest.raises(err):
            fn(*args)


@pytest.mark.parametrize("model_type,calls", [("Cnn_9layers_Gru_FrameAtt", 8),
                                              ("Cnn_9layers_Glu_AttPooling", 16)])
def test_train_step_runs_every_batchnorm_through_the_kernels(cuda, model_type, calls):
    """A bf16 step of the full-width flagship and GLU: 8 and 16 fused
    BatchNorm calls, no composite one, and their kernel launches."""
    model = get_model(model_type, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, device=cuda)
    step = train.make_train_step(model, state, mixup_alpha=1.0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 101, 64).astype(np.float32))
    y = (rng.rand(4, 17) < 0.2).astype(np.float32)
    step(x, y)                                              # builds
    before = trace.counters()
    m = step(x, y)
    torch.cuda.synchronize()
    got = {k: trace.counters().get(k, 0) - before.get(k, 0)
           for k in ("ops.bn_act.calls", "ops.bn_act.plain_calls",
                     "ops.bn_act.launches", "ops.bn_act.channels_last_calls")}
    # forward: 2 + 1 launches a call; backward: 2 + 1, the pool's tail on an
    # odd plane (101 frames, then 50, 25, 12: the tail in blocks 1 and 3);
    # every call on the channels-last kernels
    tails = 2 if model_type.startswith("Cnn_9layers_Gru") else 0
    assert got == {"ops.bn_act.calls": calls, "ops.bn_act.plain_calls": 0,
                   "ops.bn_act.launches": 6 * calls + tails,
                   "ops.bn_act.channels_last_calls": calls}
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("model_type", ["Cnn_9layers_Gru_FrameAtt",
                                        "Cnn_9layers_Glu_AttPooling"])
def test_conv_stack_step_transposes_only_for_the_first_conv(cuda, model_type):
    """A bf16 train step of the full-width flagship and GLU, profiled: the
    BatchNorm kernels ran, and cuDNN's ``nchwToNhwc`` / ``nhwcToNchw``
    kernels run only in the first conv's forward and weight gradient, whose
    one-channel input cuDNN lays out for its NHWC kernels itself (2 + 1
    launches a first conv at batch 128, 2 + 2 at this batch); no op copies
    an activation of the stack (a
    4-D tensor of the batch's rows and one of the stack's widths): no
    transpose moved elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    model = get_model(model_type, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, device=cuda)
    step = train.make_train_step(model, state, mixup_alpha=1.0)
    rng = np.random.RandomState(0)
    batch = 6
    x = torch.from_numpy(rng.randn(batch, 1001, 64).astype(np.float32))
    y = (rng.rand(batch, 17) < 0.2).astype(np.float32)
    step(x, y)                                              # builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(x, y)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("sedx_bn_" in k for k in kernels), sorted(set(kernels))
    first = [batch, 1, 1001, 64]
    transposes = collections.Counter()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            for k in e.kernels:
                if "nchwToNhwc" in k.name or "nhwcToNchw" in k.name:
                    conv_in = (e.input_shapes[0] if e.name == "aten::cudnn_convolution"
                               else e.input_shapes[1])
                    transposes[e.name, conv_in == first] += 1
    assert set(transposes) <= {("aten::cudnn_convolution", True),
                               ("aten::convolution_backward", True)}, transposes
    first_convs = 2 if model_type.endswith("Glu_AttPooling") else 1  # lin, gate
    assert sum(transposes.values()) <= 4 * first_convs, transposes
    copies = [(e.name, e.input_shapes[0]) for e in events
              if e.name in ("aten::copy_", "aten::clone") and e.input_shapes
              and len(e.input_shapes[0]) == 4 and e.input_shapes[0][0] == batch
              and e.input_shapes[0][1] in model.channels]
    assert copies == [], copies


def test_glu_remat_moves_the_running_statistics_once_a_step(cuda):
    """The GLU with ``remat`` on the card: its recompute runs the fused
    path again (16 calls for 8 BatchNorms) and leaves the running
    statistics where one f32 step without ``remat`` puts them."""
    cfg = config.Config(clip_samples=16000)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, cfg.frames_num, 64).astype(np.float32))
    y = (rng.rand(4, 17) < 0.3).astype(np.float32)
    runs = []
    for remat in (False, True):
        model = SedCnn(channels=(8, 16), block="glu", remat=remat, dropout=0.0,
                       generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, cfg, device=cuda)
        step = train.make_train_step(model, state)
        before = trace.counters().get("ops.bn_act.calls", 0)
        step(x, y)
        torch.cuda.synchronize()
        runs.append((trace.counters()["ops.bn_act.calls"] - before,
                     {k: v.cpu() for k, v in model.state_dict().items()
                      if "running" in k}))
    (c0, s0), (c1, s1) = runs
    assert (c0, c1) == (8, 16)
    for k in s0:
        assert not torch.equal(s0[k], torch.zeros_like(s0[k]) if "mean" in k
                               else torch.ones_like(s0[k])), k
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,steps", [(torch.float32, 3), (torch.bfloat16, 1)],
                         ids=["f32", "bf16"])
def test_htsat_train_graphs_replay_the_eager_steps(cuda, monkeypatch, dtype, steps):
    """A small HTS-AT (mel 16, window 4, drop-path 0.5) takes mixup steps
    through CUDA graphs (the step's forward from
    ``models.train_graphs.train_forward``) and, from the same weights and
    generators, eagerly (a recording profiler keeps that forward eager):
    losses, gradient norms, parameters and bn0's running statistics agree
    to rtol 1e-5, the port's counters move by the same amounts (the
    capture's warm-up taken back; the window-attention kernels' launches
    among them), and a further call of the step's forward agrees. The window-attention kernels sum the bias tables'
    gradients in a fixed order, but the time stretch's bicubic backward
    (``upsample_bicubic2d_backward``, into bn0's parameters) adds with
    atomics in an order of its own on each run, eager runs included; so in
    bf16, where a last-bit change of a parameter can flip a rounding, one
    step is compared (over 3 the third loss was 1.6e-4 apart); in f32, 3."""
    from sound_event_detection_dcase2017_task4_torch.models import HTSAT, train_graphs

    made = []                   # the steps' forwards, as make_train_step got them
    real = train_graphs.train_forward
    monkeypatch.setattr(train_graphs, "train_forward",
                        lambda *a: made.append(real(*a)) or made[-1])
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 250, 16).astype(np.float32))
    y = (rng.rand(4, 5) < 0.3).astype(np.float32)
    runs = []
    for graphs in (False, True):
        model = HTSAT(classes_num=5, spec_size=64, mel_bins=16, window=4, embed=16,
                      depths=(2, 2, 2), heads=(2, 4, 8), drop_path=0.5, dtype=dtype,
                      generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, device=cuda)
        step = train.make_train_step(model, state, mixup_alpha=1.0)
        with (contextlib.nullcontext() if graphs else
              torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])):
            before = trace.counters()
            metrics = [step(x, y) for _ in range(steps)]
            torch.cuda.synchronize()
            moved = {k: v - before.get(k, 0) for k, v in trace.counters().items()
                     if k.startswith("ops.") and v != before.get(k, 0)}
            forward = made[-1]
            out = forward(x.to(cuda),
                          generator=torch.Generator(device=cuda).manual_seed(9))
        runs.append(([(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                     {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     moved, {k: v.detach().float().cpu() for k, v in out.items()},
                     forward.graphs._captured))
    (eager, s0, c0, o0, cap0), (graphed, s1, c1, o1, cap1) = runs
    assert not cap0 and len(cap1) == 1
    np.testing.assert_allclose(graphed, eager, rtol=1e-5)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6, msg=k)
    assert c1 == c0 and c0["ops.window_attention.calls"] == steps * 6
    # 6 blocks: a launch a forward, 3 a backward
    assert c0["ops.window_attention.launches"] == steps * 6 * 4
    for k in o0:
        torch.testing.assert_close(o1[k], o0[k], rtol=1e-5, atol=1e-6, msg=k)


# --- HTS-AT's window-attention core (ops.window_attention) ---------------------

# (batch, heads, windows a clip, shifted, dtype, tokens a window side, head
# width): HTS-AT's four stages at batch 128 in bf16 (the grid 64², 32², 16²,
# 8² in windows of 8, heads of 24), one float32 case, the small HTS-AT of
# the graph test (windows of 4, heads of 8) and windows of 7 (49 tokens
# padded to 64, heads of 40)
WA_CASES = [(128, 4, 64, False, torch.bfloat16, 8, 24),
            (128, 4, 64, True, torch.bfloat16, 8, 24),
            (128, 8, 16, False, torch.bfloat16, 8, 24),
            (128, 8, 16, True, torch.bfloat16, 8, 24),
            (128, 16, 4, False, torch.bfloat16, 8, 24),
            (128, 16, 4, True, torch.bfloat16, 8, 24),
            (128, 32, 1, False, torch.bfloat16, 8, 24),
            (8, 4, 16, True, torch.float32, 8, 24),
            (16, 2, 4, True, torch.bfloat16, 4, 8),
            (16, 2, 4, True, torch.float32, 4, 8),
            (8, 3, 4, True, torch.bfloat16, 7, 40)]
# |got − float64| / (rtol·mag) (wa.mismatch): bf16 rounds P (or dS·scale)
# and the output once each, 2⁻⁸ apiece; float32 leaves the scores' error,
# ~d·2⁻²⁴ of |scale·q·k| a row, which exp turns into P's relative error;
# the table's gradient is a float32 sum over up to 2¹³ windows a head
WA_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -14}
WA_TABLE_RTOL = 2 ** -12


def _wa_inputs(batch, heads, nw, shifted, dtype, win, d, dev, seed=0):
    """q, k, v as ``WindowAttention.forward`` views them in the ``qkv``
    output, a bias table with a trained table's spread, the rel index, the
    shift mask (or None), dO and the scale."""
    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    g = torch.Generator(device=dev).manual_seed(seed)
    w, n, c = batch * nw, win * win, heads * d
    qkv = torch.randn(w, n, 3 * c, generator=g, device=dev).to(dtype)
    q, k, v = qkv.view(w, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    table = 0.5 * torch.randn((2 * win - 1) ** 2, heads, generator=g, device=dev)
    res = win * int(round(nw ** 0.5))
    mask = wa.shift_mask(res, win, win // 2).to(dev) if shifted else None
    do = torch.randn(w, n, c, generator=g, device=dev).to(dtype)
    return q, k, v, table, wa.relative_index(win).to(dev), mask, d ** -0.5, do


@pytest.mark.parametrize("case", WA_CASES, ids=lambda c: "b{}-h{}-nw{}-{}-{}-w{}-d{}".format(
    c[0], c[1], c[2], "shift" if c[3] else "plain", str(c[4])[6:], c[5], c[6]))
def test_window_attention_kernels_match_plain(cuda, case):
    """o, dq, dk, dv and the table's gradient of the kernels and of the
    plain version, both against float64 within ``WA_RTOL`` of each
    element's magnitude (the plain version meets the same tolerance, so it
    is not looser than the kernels' own rounding); a second backward gives
    the same bits."""
    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    q, k, v, table, index, mask, scale, do = _wa_inputs(*case, cuda)
    o = wa.forward_cuda(q, k, v, table, index, mask, scale)
    grads = wa.backward_cuda(q, k, v, table, index, mask, scale, do)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and o.shape == do.shape
    assert grads[3].dtype == torch.float32 and grads[3].shape == table.shape
    rtol = WA_RTOL[q.dtype]
    got = wa.mismatch((o, *grads), q, k, v, table, index, mask, scale, do, rtol,
                      WA_TABLE_RTOL)
    o0, p0 = wa.forward_plain(q, k, v, table, index, mask, scale)
    plain = wa.mismatch((o0, *wa.backward_plain(q, k, v, p0, index, do, scale,
                                                (table.shape, table.dtype))),
                        q, k, v, table, index, mask, scale, do, rtol, WA_TABLE_RTOL)
    del o0, p0
    assert max(plain.values()) <= 1, plain
    assert max(got.values()) <= 1, got
    again = wa.backward_cuda(q, k, v, table, index, mask, scale, do)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


def test_window_attention_graph_replays_eager(cuda):
    """A forward and backward through autograd captured in a CUDA graph:
    replayed on new inputs, the same bits as an eager call on them."""
    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    def step(qkv, table, do, index, mask, scale, heads, d):
        w, n, _ = qkv.shape
        q, k, v = qkv.view(w, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        o = wa.window_attention(q, k, v, table, index, mask, scale)
        return (o, *torch.autograd.grad(o, (qkv, table), do))

    args = []
    for seed in (1, 2):
        q, k, v, table, index, mask, scale, do = _wa_inputs(
            8, 4, 16, True, torch.bfloat16, 8, 24, cuda, seed)
        qkv = q._base.detach().clone()
        args.append((qkv.requires_grad_(True), table.requires_grad_(True), do))
    eager = step(*args[1], index, mask, scale, 4, 24)
    static = [t.detach().clone().requires_grad_(t.requires_grad) for t in args[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*static, index, mask, scale, 4, 24)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(*static, index, mask, scale, 4, 24)
    with torch.no_grad():
        for s, a in zip(static, args[1]):
            s.copy_(a)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_window_attention_counts_its_launches_and_rejects_bad_inputs(cuda):
    """Through autograd: 1 launch a forward and 3 a backward. Float64, a
    window of 81 tokens, a head width of 12, a misaligned stride or pointer
    raise."""
    from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

    q, k, v, table, index, mask, scale, do = _wa_inputs(2, 4, 4, True, torch.bfloat16,
                                                        8, 24, cuda)
    before = _launches("window_attention")
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, table)]
    o = wa.window_attention(*leaves, index, mask, scale)
    assert _launches("window_attention") - before == 1
    o.backward(do)
    assert _launches("window_attention") - before == 4
    assert all(t.grad is not None for t in leaves)

    w = q.shape[0]
    wide = torch.zeros(w, 64, 3 * 96 + 2, device=cuda, dtype=torch.bfloat16)
    skew = [t.permute(2, 0, 3, 1, 4).unbind(0) for t in (
        wide[:, :, :288].view(w, 64, 3, 4, 24),
        torch.zeros(w * 64 * 288 + 1, device=cuda, dtype=torch.bfloat16)[1:]
        .view(w, 64, 3, 4, 24))]
    big = torch.zeros(1, 4, 81, 24, device=cuda, dtype=torch.bfloat16)
    narrow = torch.zeros(w, 4, 64, 12, device=cuda, dtype=torch.bfloat16)
    for args, err in (((q.double(), k.double(), v.double()), TypeError),
                      ((big, big, big), ValueError),
                      ((narrow, narrow, narrow), ValueError),
                      (skew[0], ValueError),
                      (skew[1], ValueError)):
        with pytest.raises(err):
            wa.forward_cuda(*args, table, index, mask if args[0].shape[2] == 64 else None,
                            scale)


def test_htsat_core_serves_remat_and_eval_on_the_card(cuda):
    """A small HTS-AT (windows of 4, heads of 8) in float32 on the card,
    its core on the kernels: a train step with ``remat`` (each block's
    attention recomputed in the backward) gives the gradients of one
    without it, both eager, bit for bit but bn0's, which the time
    stretch's bicubic backward sums with atomics (rtol 1e-6 there); the
    eval forward under ``no_grad`` matches the CPU's plain core (a relative
    norm gap of 5e-5, the CPU tests' bound against the reference)."""
    import torch.nn.functional as F

    from sound_event_detection_dcase2017_task4_torch.models import HTSAT

    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(4, 250, 16).astype(np.float32))
    y = torch.from_numpy((rng.rand(4, 5) < 0.3).astype(np.float32)).to(cuda)

    def build():
        return HTSAT(classes_num=5, spec_size=64, mel_bins=16, window=4, embed=16,
                     depths=(2, 2, 2), heads=(2, 4, 8), drop_path=0.5,
                     generator=torch.Generator().manual_seed(0))

    grads = []
    for remat in (False, True):
        model = build().to(cuda)
        model.remat = remat
        params = dict(model.named_parameters())
        before = _launches("window_attention")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = model(x.to(cuda), train=True,
                        generator=torch.Generator(device=cuda).manual_seed(3))
            loss = F.binary_cross_entropy(out["clipwise_output"], y)
            grads.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        torch.cuda.synchronize()
        # 6 blocks: a forward launch each (twice under remat), 3 backward
        assert _launches("window_attention") - before == 6 * (4 + remat)
    for k, g in grads[0].items():
        if k.startswith("bn0."):
            torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=0, msg=k)
        else:
            assert torch.equal(grads[1][k], g), k
    card, cpu = build().to(cuda).eval(), build().eval()
    with torch.no_grad():
        got, want = card(x.to(cuda)), cpu(x)
    for k in ("clipwise_output", "framewise_output", "embedding"):
        gap = float((got[k].cpu().double() - want[k].double()).norm()
                    / want[k].double().norm())
        assert gap < 5e-5, (k, gap)


# --- Audio Mamba's selective scan (ops.selective_scan) -------------------------

# (batch, tokens, width, dtype): AuM-B's blocks (253 tokens, E = 1536) in
# bf16, a float32 case, and a sequence that ends inside a chunk
SS_CASES = [(2, 253, 1536, torch.bfloat16), (2, 37, 128, torch.float32),
            (3, 37, 128, torch.bfloat16), (1, 5, 64, torch.float32)]


def _ss_inputs(batch, length, width, dtype, dev, seed=0):
    """The function's inputs as ``Mixer.forward`` makes them (``B`` and
    ``C`` slices of one ``x_proj`` output of width 80), ``Δraw`` around a
    trained Δ's range, ``A_log`` about ``log(1..16)``, and ``dout``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)     # noqa: E731
    shape = (batch, length, width)
    dbl_f, dbl_b = r(batch, length, 80).to(dtype), r(batch, length, 80).to(dtype)
    a_log = torch.log(torch.arange(1.0, 17.0, device=dev)).expand(width, -1) + 0.3 * r(width, 16)
    args = (r(*shape).to(dtype), r(*shape).to(dtype), (r(*shape) - 2).to(dtype),
            (r(*shape) - 2).to(dtype), dbl_f[..., 48:64], dbl_f[..., 64:], dbl_b[..., 48:64],
            dbl_b[..., 64:], r(*shape).to(dtype), a_log.contiguous(),
            (a_log + 0.1 * r(width, 16)).contiguous(), r(width), r(width),
            0.5 * r(width) - 3, 0.5 * r(width) - 3)
    return args, r(*shape).to(dtype)


@pytest.mark.parametrize("case", SS_CASES, ids=lambda c: "b{}-l{}-e{}-{}".format(
    c[0], c[1], c[2], str(c[3])[6:]))
def test_selective_scan_kernels_match_plain(cuda, case):
    """The output and every input's gradient (both directions, dz, dA_log,
    dD, dbdt) of the kernels and of the plain version, both against the
    function in float64 (``selective_scan.mismatch``, a relative gap in
    norm): the kernels' gap at most twice the plain version's, or 1e-5 (a
    float32 sum over the rows and tokens in another order); a second
    backward gives the same bits."""
    from sound_event_detection_dcase2017_task4_torch.ops import selective_scan as ss

    args, dout = _ss_inputs(*case, cuda)
    out, ysum = ss.forward_cuda(*args)
    grads = ss.backward_cuda(args, ysum, dout)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert all(g.shape == a.shape and g.dtype == a.dtype for g, a in zip(grads, args))
    got = ss.mismatch((out, *grads), args, dout)
    plain = ss.mismatch((ss.forward_plain(*args), *ss.backward_plain(args, dout)), args, dout)
    assert all(got[k] <= max(2 * plain[k], 1e-5) for k in got), (got, plain)
    again = ss.backward_cuda(args, ysum, dout)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


def test_selective_scan_counts_launches_and_replays_in_a_graph(cuda):
    """Through autograd: 1 launch a forward and 1 a backward, no plain call;
    a forward and backward captured in a CUDA graph, replayed on new
    inputs, give the bits of an eager call on them."""
    from sound_event_detection_dcase2017_task4_torch.ops import selective_scan as ss

    def step(*args):
        leaves, dout = args[:-1], args[-1]
        out = ss.selective_scan(*leaves)
        return (out, *torch.autograd.grad(out, leaves, dout))

    def leaves(seed):
        args, dout = _ss_inputs(2, 37, 128, torch.bfloat16, cuda, seed)
        return [t.detach().clone().requires_grad_(True) for t in args] + [dout]

    before = trace.counters()
    eager = step(*leaves(2))
    moved = {k: v - before.get(k, 0) for k, v in trace.counters().items()
             if k.startswith("ops.selective_scan.") and v != before.get(k, 0)}
    assert moved == {"ops.selective_scan.calls": 1, "ops.selective_scan.tokens": 74,
                     "ops.selective_scan.launches": 2}
    static = leaves(1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(*static)
    with torch.no_grad():
        for s, a in zip(static, leaves(2)):
            s.copy_(a)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_selective_scan_rejects_bad_inputs(cuda):
    """Float64, a width that is not a multiple of 64, a strided ``u`` and a
    ``B`` strided over the states raise."""
    from sound_event_detection_dcase2017_task4_torch.ops import selective_scan as ss

    args, _ = _ss_inputs(1, 9, 128, torch.bfloat16, cuda)
    odd, _ = _ss_inputs(1, 9, 96, torch.bfloat16, cuda)
    strided = list(args)
    strided[0] = torch.zeros(1, 9, 256, device=cuda, dtype=torch.bfloat16)[..., ::2]
    skew = list(args)
    skew[4] = torch.zeros(1, 9, 32, device=cuda, dtype=torch.bfloat16)[..., ::2]
    for bad, err in (([t.double() for t in args], TypeError), (odd, ValueError),
                     (strided, ValueError), (skew, ValueError)):
        with pytest.raises(err):
            ss.forward_cuda(*bad)


def _aum_small(dtype=torch.float32, **kw):
    from sound_event_detection_dcase2017_task4_torch.models import AudioMamba

    return AudioMamba(classes_num=5, mel_bins=32, frames=100, patch=16, embed=32, depth=2,
                      drop_path=0.5, dtype=dtype, generator=torch.Generator().manual_seed(0),
                      **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_aum_train_graphs_replay_the_eager_steps(cuda, monkeypatch, dtype):
    """A small Audio Mamba (width 32, E = 64, 2 blocks, drop-path 0.5) takes
    3 mixup steps through CUDA graphs (the step's forward from
    ``models.train_graphs.train_forward``) and, from the same weights and
    generators, eagerly (a recording profiler keeps that forward eager):
    losses, gradient norms and parameters agree to rtol 1e-5 (the scan
    kernels and the rest of the pass are deterministic: bit for bit in
    practice), the port's counters move by the same amounts (2 scan
    launches a block a step, no plain call), and a further call of the
    step's forward agrees."""
    from sound_event_detection_dcase2017_task4_torch.models import train_graphs

    made = []
    real = train_graphs.train_forward
    monkeypatch.setattr(train_graphs, "train_forward",
                        lambda *a: made.append(real(*a)) or made[-1])
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 100, 32).astype(np.float32))
    y = (rng.rand(4, 5) < 0.3).astype(np.float32)
    runs = []
    for graphs in (False, True):
        model = _aum_small(dtype)
        state = train.create_train_state(model, device=cuda)
        step = train.make_train_step(model, state, mixup_alpha=1.0)
        with (contextlib.nullcontext() if graphs else
              torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])):
            before = trace.counters()
            metrics = [step(x, y) for _ in range(3)]
            torch.cuda.synchronize()
            moved = {k: v - before.get(k, 0) for k, v in trace.counters().items()
                     if k.startswith("ops.") and v != before.get(k, 0)}
            forward = made[-1]
            out = forward(x.to(cuda), generator=torch.Generator(device=cuda).manual_seed(9))
        runs.append(([(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                     {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     moved, {k: v.detach().float().cpu() for k, v in out.items()},
                     forward.graphs._captured))
    (eager, s0, c0, o0, cap0), (graphed, s1, c1, o1, cap1) = runs
    assert not cap0 and len(cap1) == 1
    np.testing.assert_allclose(graphed, eager, rtol=1e-5)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6, msg=k)
    assert c1 == c0
    assert c0["ops.selective_scan.launches"] == 3 * 2 * 2
    assert c0["ops.selective_scan.calls"] == 3 * 2
    assert "ops.selective_scan.plain_calls" not in c0
    for k in o0:
        torch.testing.assert_close(o1[k], o0[k], rtol=1e-5, atol=1e-6, msg=k)


def test_aum_main_path_at_published_widths_runs_the_kernels(cuda):
    """AuM-B at its published widths through ``train.make_train_step`` in
    bf16 (batch 8, 10 s log-mel): the first step captures the CUDA graphs,
    the next replays them; each step counts 24 scan calls, 48 kernel
    launches and no plain call, and its loss is finite; an eval forward
    under ``no_grad`` launches 24."""
    model = get_model("AudioMamba", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, device=cuda)
    step = train.make_train_step(model, state, mixup_alpha=1.0)
    rng = np.random.RandomState(1)
    for _ in range(2):
        x = torch.from_numpy(rng.randn(8, 1001, 64).astype(np.float32))
        before = trace.counters()
        loss = float(step(x, (rng.rand(8, 17) < 0.1).astype(np.float32))["loss"])
        torch.cuda.synchronize()
        moved = {k: v - before.get(k, 0) for k, v in trace.counters().items()
                 if k.startswith("ops.selective_scan.") and v != before.get(k, 0)}
        assert np.isfinite(loss)
        assert moved == {"ops.selective_scan.calls": 24, "ops.selective_scan.launches": 48,
                         "ops.selective_scan.tokens": 24 * 8 * 253}, moved
    model.eval()
    before = _launches("selective_scan")
    with torch.no_grad():
        model(x.to(cuda))
    torch.cuda.synchronize()
    assert _launches("selective_scan") - before == 24
