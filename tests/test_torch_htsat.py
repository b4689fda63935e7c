"""HTS-AT in the port (``models/htsat.py``, ``ops/window_attention.py``,
``blocks.drop_path_mask`` and ``drop_path``) on the CPU, held to the
benchmark's plain reference (``benchmark/reference/htsat.py``, written from
the paper's equations with no import of the port): HTS-AT has no JAX
counterpart.

Weights are the reference's ``init`` drawn from a seeded generator, moved
off their published values (a LayerNorm at 1 / 0 and zero biases would
leave their gradients' paths untested), and loaded into both sides. The
tolerances, float32 against float32 in another order of operations:

* outputs: a relative norm gap of 5e-5 (measured at most 1.6e-5, the
  published model's embedding after the 1001 → 1024 bicubic stretch,
  whose source positions PyTorch computes in float32 and the reference in
  float64; 3.5e-7 without a stretch);
* a train step's loss: rtol 1e-5 (measured 1.7e-7); each parameter's
  gradient: a gap of 1e-4 of the larger of its norm and the median leaf's
  (measured at most 8.2e-6).

The port at ``dtype=bfloat16`` on the same weights misses both train-step
tolerances (loss 6.3e-4, worst gradient 6.0e-2;
``test_small_train_step_matches_the_reference``), so the tolerances tell
the compute type apart.
"""

import os
import statistics

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import htsat as ref
from benchmark.reference import model as ref_model
from sound_event_detection_dcase2017_task4_torch import (features, losses, main,
                                                         serving, trace)
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.models import (
    HTSAT, MODEL_REGISTRY, PORT_REGISTRY, get_model)
from sound_event_detection_dcase2017_task4_torch.models import train_graphs
from sound_event_detection_dcase2017_task4_torch.models.blocks import drop_path, drop_path_mask
from sound_event_detection_dcase2017_task4_torch.models.htsat import fold, unfold
from sound_event_detection_dcase2017_task4_torch.ops import window_attention as wa

import torch_parallel_worker as worker

torch.set_num_threads(2)

OUT_RTOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-4
PUBLISHED = dict(spec_size=256, mel_bins=64, patch=4, window=8, embed=96,
                 depths=(2, 2, 6, 2), heads=(4, 8, 16, 32), mlp_ratio=4,
                 drop_path=0.1, classes=17)
# mel 16 on a 64² image: windows of 4 shifted by 2, 3 stages of 2 blocks
SMALL = dict(spec_size=64, mel_bins=16, patch=4, window=4, embed=16,
             depths=(2, 2, 2), heads=(2, 4, 8), mlp_ratio=4, drop_path=0.5,
             classes=5)


def _port(arch, weights, dtype=torch.float32):
    kw = {k: v for k, v in arch.items() if k != "classes"}
    m = HTSAT(classes_num=arch["classes"], dtype=dtype, **kw)
    m.load_state_dict(weights)
    return m


def _weights(arch, seed=1):
    w = ref.init(arch, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    return {k: v if ref_model.is_statistic(k) else v + 0.05 * torch.randn(
        v.shape, generator=g) for k, v in w.items()}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _grad_gaps(got: dict, want: dict) -> dict:
    med = statistics.median(float(w.norm()) for w in want.values())
    return {k: float((got[k] - w).norm()) / max(float(w.norm()), med)
            for k, w in want.items()}


@pytest.mark.parametrize("frames", [250, 256])
def test_small_forward_matches_the_reference(frames):
    w = _weights(SMALL)
    x = torch.randn(3, frames, SMALL["mel_bins"], generator=torch.Generator().manual_seed(2))
    got = _port(SMALL, w)(x)
    want = ref.forward(w, x, SMALL)
    for k in ("clipwise_output", "framewise_output", "embedding"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < OUT_RTOL, k


def _train_step(forward, params, x, y, generator):
    out = forward(x, generator)
    loss = losses.get_loss_func("clip_bce")(out, y)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def test_small_train_step_matches_the_reference():
    """One train-mode step at drop-path rate up to 0.5 (the masks from
    generators of one seed on both sides): loss and every gradient; the
    port in bf16 misses the gradient tolerance."""
    w = _weights(SMALL)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 250, SMALL["mel_bins"], generator=gen)
    y = (torch.rand(8, SMALL["classes"], generator=gen) < 0.3).float()
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()
         if not ref_model.is_statistic(k)}
    full = dict(w, **p)
    want_loss, want = _train_step(
        lambda x, g: ref.forward(full, x, SMALL, train=True, generator=g), p, x, y,
        torch.Generator().manual_seed(9))
    for dtype, ok in ((torch.float32, True), (torch.bfloat16, False)):
        m = _port(SMALL, w, dtype)
        params = dict(m.named_parameters())
        loss, got = _train_step(
            lambda x, g: m(x, train=True, generator=g), params, x, y,
            torch.Generator().manual_seed(9))
        assert set(got) == set(want)
        gaps = _grad_gaps(got, want)
        close = (abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
                 and max(gaps.values()) <= GRAD_GAP)
        assert close == ok, (dtype, loss, want_loss, max(gaps.items(), key=lambda kv: kv[1]))


def test_remat_recomputes_the_same_step():
    """``remat`` recomputes each branch in the backward and leaves the
    drop-path draws outside it: the same loss and gradients, bit for bit."""
    w = _weights(SMALL)
    x = torch.randn(4, 256, SMALL["mel_bins"], generator=torch.Generator().manual_seed(8))
    y = (torch.rand(4, SMALL["classes"], generator=torch.Generator().manual_seed(8)) < 0.3).float()
    steps = []
    for remat in (False, True):
        m = _port(SMALL, w)
        m.remat = remat
        steps.append(_train_step(lambda x, g: m(x, train=True, generator=g),
                                 dict(m.named_parameters()), x, y,
                                 torch.Generator().manual_seed(9)))
    assert steps[0][0] == steps[1][0]
    for k, g in steps[0][1].items():
        assert torch.equal(g, steps[1][1][k]), k


def test_published_model_matches_the_reference_and_counts_its_calls():
    """The published widths at batch 1 in eval mode: outputs; a forward is
    12 window-attention calls, 5 of them shifted, 1,216 window-heads a clip
    (2·64·4 + 2·16·8 + 6·4·16 + 2·1·32: blocks × windows × heads)."""
    w = _weights(PUBLISHED)
    x = torch.randn(1, 1001, 64, generator=torch.Generator().manual_seed(4))
    m = _port(PUBLISHED, w)
    before = trace.counters()
    got = m(x)
    after = trace.counters()
    want = ref.forward(w, x, PUBLISHED)
    for k in ("clipwise_output", "framewise_output", "embedding"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < OUT_RTOL, k
    added = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("ops.window_attention.")}
    assert added == {"ops.window_attention.calls": 12,
                     "ops.window_attention.shifted_calls": 5,
                     "ops.window_attention.windows": 2 * 256 + 2 * 128 + 6 * 64 + 2 * 32}


def test_registry_builds_the_published_model():
    m = get_model("HTSAT")
    assert isinstance(m, HTSAT) and set(PORT_REGISTRY) == {"HTSAT", "AudioMamba"}
    assert "HTSAT" not in MODEL_REGISTRY
    assert sum(p.numel() for p in m.parameters()) == 27_612_841
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == ref.shapes(PUBLISHED)
    assert get_model("HTSAT", classes_num=5).tscam_conv.out_channels == 5
    with pytest.raises(KeyError, match="HTSAT"):
        get_model("NoSuchModel")


@pytest.mark.parametrize("r,w,s", [(64, 8, 4), (32, 8, 4), (16, 8, 4), (16, 4, 2),
                                   (8, 4, 2)])
def test_shift_mask_and_relative_index_match_the_reference(r, w, s):
    np.testing.assert_array_equal(wa.shift_mask(r, w, s).numpy(),
                                  ref.region_mask(r, w, s).numpy())
    np.testing.assert_array_equal(wa.relative_index(w).numpy(),
                                  ref.rel_index(w).flatten().numpy())


def test_fold_and_unfold():
    """Frame ``t``, bin ``f`` of ``[B, C, T, F]`` lands at row ``(t // L)·F
    + f``, column ``t % L`` (``L = T/r``); ``unfold`` undoes it."""
    b, c, t, f, r = 2, 3, 32, 8, 4
    x = torch.arange(b * c * t * f, dtype=torch.float32).view(b, c, t, f)
    y = fold(x, r)
    assert y.shape == (b, c, r * f, t // r)
    for tt in range(t):
        for ff in range(f):
            assert torch.equal(y[:, :, (tt // (t // r)) * f + ff, tt % (t // r)],
                               x[:, :, tt, ff])
    assert torch.equal(unfold(y, r), x)


def test_cubic_stretch_is_pytorchs_bicubic():
    """The reference's stretch matrix against ``F.interpolate(mode=
    "bicubic", align_corners=True)`` on a time-only resize: atol 5e-5, as
    PyTorch takes the source positions ``i·(T − 1)/(T' − 1)`` in float32
    (off by up to ~1e-5 of a frame at ``i`` = 127, measured 2.0e-5 on unit
    noise), the reference in float64."""
    x = torch.randn(2, 1, 101, 5, generator=torch.Generator().manual_seed(5))
    want = F.interpolate(x, (128, 5), mode="bicubic", align_corners=True)
    got = ref.cubic_stretch(101, 128) @ x
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


def _composite(q, k, v, table, index, mask, scale):
    w, h, n, d = q.shape
    s = scale * q @ k.transpose(-1, -2) + table[index].view(n, n, h).permute(2, 0, 1)
    if mask is not None:
        s = (s.view(-1, mask.shape[0], h, n, n) + mask[None, :, None]).view(w, h, n, n)
    return (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(w, n, h * d)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_backward_matches_autograd_in_float64(shifted):
    """The hand-written backward against autograd of the composite, float64
    (rtol 1e-12: the same arithmetic in another order), and ``gradcheck``."""
    gen = torch.Generator().manual_seed(6)
    r, win, h, d = 8, 4, 2, 3
    nw = (r // win) ** 2
    q, k, v = (torch.randn(2 * nw, h, win * win, d, generator=gen, dtype=torch.float64)
               for _ in range(3))
    table = 0.1 * torch.randn((2 * win - 1) ** 2, h, generator=gen, dtype=torch.float64)
    index = wa.relative_index(win)
    mask = wa.shift_mask(r, win, win // 2).double() if shifted else None
    do = torch.randn(2 * nw, win * win, h * d, generator=gen, dtype=torch.float64)
    grads = []
    for fn in (wa.window_attention, _composite):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, table)]
        out = fn(*leaves, index, mask, d ** -0.5)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    small = [t[:2].clone().requires_grad_(True) if t.dim() == 4 else t.clone().requires_grad_(True)
             for t in (q, k, v, table)]
    m1 = None if mask is None else mask[:1]
    assert torch.autograd.gradcheck(
        lambda *a: wa.window_attention(*a, index, m1, d ** -0.5), small)


def test_window_attention_spans_cover_forward_and_backward():
    from torch.profiler import ProfilerActivity, profile

    m = _port(SMALL, _weights(SMALL))
    x = torch.randn(2, 256, SMALL["mel_bins"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m(x, train=True, generator=torch.Generator().manual_seed(0))[
            "clipwise_output"].sum().backward()
    names = [e.name for e in prof.events() if e.name.startswith("sedx.ops.window")]
    assert names.count("sedx.ops.window_attention") == 6
    assert names.count("sedx.ops.window_attention.backward") == 6


def test_drop_path_follows_the_dropout_rule():
    """One ``[B]`` draw a mask, kept rows divided by the keep probability in
    x's type; rate 0 draws nothing and keeps the branch; a draw without a
    generator raises."""
    x = torch.ones(6, 5, 4)
    g = torch.Generator().manual_seed(7)
    before = g.get_state()
    assert drop_path_mask(6, 0.0, g) is None and drop_path(x, None, 0.0) is x
    assert torch.equal(g.get_state(), before)
    y = drop_path(x, drop_path_mask(6, 0.3, g), 0.3)
    keep = torch.rand(6, generator=torch.Generator().manual_seed(7)) < 45875 / 65536
    torch.testing.assert_close(y, torch.where(keep[:, None, None], x / (45875 / 65536), 0.0))
    with pytest.raises(ValueError, match="Generator"):
        drop_path_mask(6, 0.3, None)


def test_train_pass_draws_two_masks_a_block_and_stays_eager_off_the_card():
    """A train forward draws one ``[B]`` mask for each branch of a block
    with a drop-path rate (none for block 0, at rate 0), in the blocks'
    order, and nothing else from the generator: the model's forward, its
    split (``draw_masks`` then ``train_pass``) and the train step's forward
    (``train_graphs.train_forward``) alike, to the same outputs. Off a card
    the step's forward runs eagerly (no CUDA graph is captured), and
    ``TrainGraphs`` refuses an input that requires a gradient."""
    m = _port(SMALL, _weights(SMALL))
    x = torch.randn(2, 256, SMALL["mel_bins"])
    want = torch.Generator().manual_seed(3)
    rates = [b.rate for stage in m.layers for b in stage.blocks]
    assert rates[0] == 0 and min(rates[1:]) > 0
    for _ in range(2 * (len(rates) - 1)):
        torch.rand(2, generator=want)
    forward = train_graphs.train_forward(m)
    assert forward.pattern == (False, False) + (True, True) * (len(rates) - 1)
    outs = []
    for run in (lambda g: m(x, train=True, generator=g),
                lambda g: m.train_pass(x, m.draw_masks(2, g)),
                lambda g: forward(x, generator=g)):
        g = torch.Generator().manual_seed(3)
        outs.append(run(g))
        assert torch.equal(g.get_state(), want.get_state())
    for out in outs[1:]:
        assert out.keys() == outs[0].keys()
        for k in out:
            assert torch.equal(out[k], outs[0][k]), k
    assert not forward.graphs._captured
    with pytest.raises(ValueError, match="gradient"):
        forward.graphs(x.requires_grad_())


def test_two_ranks_train_as_one_process():
    """bn0's global statistics and the global batch's drop-path masks: 2
    gloo ranks take the 1-process steps (float64 compute, bn0's sums in
    float32: loss rtol 1e-6, gradients within 1e-5 of the leaf scale)."""
    rng = np.random.RandomState(0)
    spec = {"x": [torch.from_numpy(rng.randn(8, 100, 16).astype(np.float32))
                  for _ in range(2)],
            "y": [(rng.rand(8, 5) < 0.3).astype(np.float32) for _ in range(2)]}
    one = worker.htsat_steps(spec, None)
    for rank in worker.launch("htsat", 2, spec):
        assert not rank["forbidden_modules"]
        np.testing.assert_allclose(rank["loss"], one["loss"], rtol=1e-6)
        gaps = _grad_gaps(rank["grads"], one["grads"])
        assert max(gaps.values()) < 1e-5, max(gaps.items(), key=lambda kv: kv[1])
        for k, v in one["running"].items():
            np.testing.assert_allclose(rank["running"][k], v, rtol=1e-6, atol=1e-7)


def test_main_train_and_predictor_run_htsat(tmp_path):
    """``main train --model_type HTSAT`` (the published model) for 2 steps
    on a packed 0.5 s corpus, then ``Predictor.from_workspace`` serves its
    checkpoint."""
    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=4",
                   "--num_test=2", "--num_eval=2", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    main.main(["train", f"--workspace={ws}", "--model_type=HTSAT", "--batch_size=2",
               "--feature_source=waveform", "--augmentation=mixup",
               "--stop_iteration=2", "--eval_interval=2", "--eval_max_iteration=1"],
              device="cpu")
    rc = "loss_type=clip_bce/augmentation=mixup/batch_size=2"
    ckpt = os.path.join(ws, "checkpoints", "main", "model_type=HTSAT", rc,
                        "2_iterations.pth")
    assert os.path.isfile(ckpt)
    cfg = Config(clip_samples=16000)
    pred = serving.Predictor.from_workspace(ws, "HTSAT", rc, cfg=cfg, device="cpu")
    assert isinstance(pred.model, HTSAT)
    wave = np.random.RandomState(0).randn(2, cfg.clip_samples).astype(np.float32)
    out = pred(wave)
    assert out["clipwise_output"].shape == (2, 17)
    assert out["framewise_output"].shape == (2, cfg.frames_num, 17)
    assert np.isfinite(out["framewise_output"]).all()
    assert len(pred.detect_events(wave)) == 2


def _core_inputs(dtype, win, heads, d, batch=2, seed=7):
    """q, k, v as views of a ``qkv`` output, a table, the rel index, a
    shift mask over a grid of 2 × 2 windows, dO and the scale."""
    g = torch.Generator().manual_seed(seed)
    nw, n, c = 4, win * win, heads * d
    qkv = torch.randn(batch * nw, n, 3 * c, generator=g).to(dtype)
    q, k, v = qkv.view(batch * nw, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    table = 0.5 * torch.randn((2 * win - 1) ** 2, heads, generator=g)
    do = torch.randn(batch * nw, n, c, generator=g).to(dtype)
    return (q, k, v, table, wa.relative_index(win), wa.shift_mask(2 * win, win, win // 2),
            d ** -0.5, do)


@pytest.mark.parametrize("dtype,win,heads,d", [(torch.bfloat16, 8, 4, 24),
                                               (torch.float32, 8, 4, 24),
                                               (torch.bfloat16, 4, 2, 8)])
def test_window_attention_yardstick_passes_the_plain_version_and_catches_faults(
        dtype, win, heads, d):
    """``mismatch`` (the card tests' and ``chip_smoke.py``'s yardstick of
    the kernels) at the card tests' tolerances: the plain version within
    them, and a dropped window of ``o``, a ``dq`` without the scale, and a
    table gradient short of one window's share each beyond them."""
    rtol = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -14}[dtype]
    q, k, v, table, index, mask, scale, do = _core_inputs(dtype, win, heads, d)
    o, p = wa.forward_plain(q, k, v, table, index, mask, scale)
    dq, dk, dv, dtable = wa.backward_plain(q, k, v, p, index, do, scale,
                                           (table.shape, table.dtype))
    args = (q, k, v, table, index, mask, scale, do, rtol, 2 ** -12)
    assert max(wa.mismatch((o, dq, dk, dv, dtable), *args).values()) <= 1
    bad_o = o.clone()
    bad_o[0] = 0
    assert wa.mismatch((bad_o, dq, dk, dv, dtable), *args)["o"] > 1
    assert wa.mismatch((o, dq / scale, dk, dv, dtable), *args)["dq"] > 1
    short = dtable * (1 - 1 / q.shape[0])
    assert wa.mismatch((o, dq, dk, dv, short), *args)["dtable"] > 1


def test_window_attention_kernels_refuse_cpu_tensors_and_count_no_launch():
    """The kernels' entries raise on CPU tensors before any build; a CPU
    call takes the plain version and moves no launch counter."""
    q, k, v, table, index, mask, scale, do = _core_inputs(torch.float32, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wa.forward_cuda(q, k, v, table, index, mask, scale)
    with pytest.raises(ValueError, match="CUDA"):
        wa.backward_cuda(q, k, v, table, index, mask, scale, do)
    before = trace.counters().get("ops.window_attention.launches", 0)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, table)]
    wa.window_attention(*leaves, index, mask, scale).backward(do)
    assert trace.counters().get("ops.window_attention.launches", 0) == before
    assert all(t.grad is not None for t in leaves)
