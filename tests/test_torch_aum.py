"""Audio Mamba in the port (``models/aum.py``, ``ops/selective_scan.py``)
on the CPU, held to the benchmark's plain reference
(``benchmark/reference/aum.py``, written from the papers' equations with no
import of the port): AuM has no JAX counterpart.

Weights are the reference's ``init`` drawn from a seeded generator, moved
off their published values (RMSNorm scales at 1, zero biases, ``D`` at 1
and ``A_log`` at ``log(1..N)`` would leave paths untested), and loaded into
both sides. The two compute the backward direction differently (the port:
an anti-causal conv and a scan by reversed index; the reference: Vim's
flip of the tokens and a causal conv), so the tests hold the one to the
other. The tolerances, float32 against float32 in another order of
operations:

* outputs: a relative norm gap of 1e-5 (measured at most 6e-8 at the small
  size, 4e-7 at the published widths);
* a train step's loss: rtol 1e-5 (measured ~1e-7); each parameter's
  gradient: a gap of 1e-4 of the larger of its norm and the median leaf's
  (measured at most ~2e-6).

The port at ``dtype=bfloat16`` on the same weights misses the gradient
tolerance, so the tolerances tell the compute type apart.
"""

import os
import statistics

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import aum as ref
from sound_event_detection_dcase2017_task4_torch import (features, losses, main,
                                                         serving, trace, train)
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.models import (
    AudioMamba, MODEL_REGISTRY, PORT_REGISTRY, get_model)
from sound_event_detection_dcase2017_task4_torch.models import train_graphs
from sound_event_detection_dcase2017_task4_torch.models.aum import Mixer
from sound_event_detection_dcase2017_task4_torch.ops import selective_scan as ss

torch.set_num_threads(2)

OUT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-4
PUBLISHED = dict(mel_bins=64, frames=1001, patch=16, embed=768, depth=24, d_state=16,
                 d_conv=4, expand=2, dt_rank=48, drop_path=0.1, classes=17)
# width 32 (E = 64, dt_rank 2), 2 blocks, mel 32 in patches of 16: a 2 × 7
# grid at 100 frames (112 padded), 14 patches and the class token at 7
SMALL = dict(mel_bins=32, frames=100, patch=16, embed=32, depth=2, d_state=16,
             d_conv=4, expand=2, dt_rank=2, drop_path=0.5, classes=5)


def _port(arch, weights=None, dtype=torch.float32):
    kw = {k: v for k, v in arch.items() if k not in ("classes", "dt_rank")}
    m = AudioMamba(classes_num=arch["classes"], dtype=dtype, **kw)
    if weights is not None:
        m.load_state_dict(weights)
    return m


def _weights(arch, seed=1):
    w = ref.init(arch, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in w.items()}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _grad_gaps(got: dict, want: dict) -> dict:
    med = statistics.median(float(w.norm()) for w in want.values())
    return {k: float((got[k] - w).norm()) / max(float(w.norm()), med)
            for k, w in want.items()}


@pytest.mark.parametrize("frames", [100, 112])
def test_small_forward_matches_the_reference(frames):
    """Eval mode, with the time axis padded (100 → 112 frames) and not."""
    w = _weights(SMALL)
    x = torch.randn(3, frames, SMALL["mel_bins"], generator=torch.Generator().manual_seed(2))
    got = _port(SMALL, w)(x)
    want = ref.forward(w, x, SMALL)
    for k in ("clipwise_output", "framewise_output", "embedding"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < OUT_RTOL, k
    assert got["framewise_output"].shape == (3, frames, SMALL["classes"])


def _train_step(forward, params, x, y, generator):
    out = forward(x, generator)
    loss = losses.get_loss_func("clip_bce")(out, y)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def test_small_train_step_matches_the_reference():
    """One train-mode step at drop-path rate 0.5 (the masks from generators
    of one seed on both sides): loss and every gradient; the port in bf16
    misses the gradient tolerance."""
    w = _weights(SMALL)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(6, 100, SMALL["mel_bins"], generator=gen)
    y = (torch.rand(6, SMALL["classes"], generator=gen) < 0.3).float()
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want_loss, want = _train_step(
        lambda x, g: ref.forward(p, x, SMALL, ref.draw_masks(6, SMALL, g, "cpu")),
        p, x, y, torch.Generator().manual_seed(9))
    for dtype, ok in ((torch.float32, True), (torch.bfloat16, False)):
        m = _port(SMALL, w, dtype)
        params = dict(m.named_parameters())
        loss, got = _train_step(lambda x, g: m(x, train=True, generator=g), params, x, y,
                                torch.Generator().manual_seed(9))
        assert set(got) == set(want)
        gaps = _grad_gaps(got, want)
        close = (abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
                 and max(gaps.values()) <= GRAD_GAP)
        assert close == ok, (dtype, loss, want_loss, max(gaps.items(), key=lambda kv: kv[1]))


def test_remat_recomputes_the_same_step():
    """``remat`` recomputes each block in the backward and leaves the
    drop-path draws outside it: the same loss and gradients, bit for bit."""
    w = _weights(SMALL)
    x = torch.randn(4, 100, SMALL["mel_bins"], generator=torch.Generator().manual_seed(8))
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
    24 scan calls of 253 tokens, all on the plain version on the CPU."""
    w = _weights(PUBLISHED)
    x = torch.randn(1, 1001, 64, generator=torch.Generator().manual_seed(4))
    m = _port(PUBLISHED, w)
    before = trace.counters()
    with torch.no_grad():
        got = m(x)
    after = trace.counters()
    with torch.no_grad():
        want = ref.forward(w, x, PUBLISHED)
    for k in ("clipwise_output", "framewise_output", "embedding"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < OUT_RTOL, k
    added = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("ops.selective_scan.")}
    assert added == {"ops.selective_scan.calls": 24, "ops.selective_scan.plain_calls": 24,
                     "ops.selective_scan.tokens": 24 * 253}


def test_registry_builds_the_published_model():
    """AuM-B: width 768, 24 blocks, d_state 16, expand 2, d_conv 4,
    dt_rank 48, 16 × 16 patches, 253 tokens; 96,492,305 parameters at 17
    classes, the reference's tensors name for name."""
    m = get_model("AudioMamba")
    assert isinstance(m, AudioMamba) and "AudioMamba" in PORT_REGISTRY
    assert "AudioMamba" not in MODEL_REGISTRY
    assert sum(p.numel() for p in m.parameters()) == 96_492_305
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == ref.shapes(PUBLISHED)
    mixer = m.layers[0].mixer
    assert (m.tokens, m.cls_index, len(m.layers)) == (253, 126, 24)
    assert (mixer.inner, mixer.d_state, mixer.d_conv, mixer.dt_rank) == (1536, 16, 4, 48)
    assert [b.rate for b in m.layers][::23] == [0.0, 0.1]
    assert get_model("AudioMamba", classes_num=5).head.out_features == 5


def test_published_init_follows_mamba():
    """``A_log = log(1..16)``, ``D = 1``, ``dt_proj``'s bias the inverse
    softplus of Δ in [1e-3, 1e-1], ``W_out`` at PyTorch's bound over √24."""
    m = get_model("AudioMamba", generator=torch.Generator().manual_seed(3))
    mixer = m.layers[5].mixer
    for a_log in (mixer.A_log, mixer.A_b_log):
        assert torch.allclose(a_log, torch.log(torch.arange(1.0, 17.0)).expand(1536, -1))
    assert bool((mixer.D == 1).all()) and bool((mixer.D_b == 1).all())
    for dt_proj in (mixer.dt_proj, mixer.dt_proj_b):
        dt = F.softplus(dt_proj.bias.detach())
        assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 1.01e-1
        assert float(dt_proj.weight.detach().abs().max()) <= 48 ** -0.5
    bound = 1536 ** -0.5 / 24 ** 0.5
    top = float(mixer.out_proj.weight.detach().abs().max())
    assert 0.9 * bound < top <= bound


def _scan_inputs(b, length, e, dtype=torch.float32, seed=7):
    """The function's inputs as the mixer makes them: ``B`` and ``C`` as
    slices of one ``x_proj`` output, ``Δraw`` around a trained Δ's range."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)     # noqa: E731
    dbl_f, dbl_b = r(b, length, 3 + 32).to(dtype), r(b, length, 3 + 32).to(dtype)
    a_log = torch.log(torch.arange(1.0, 17.0)).expand(e, -1) + 0.3 * r(e, 16)
    return (r(b, length, e).to(dtype), r(b, length, e).to(dtype),
            (r(b, length, e) - 1).to(dtype), (r(b, length, e) - 1).to(dtype),
            dbl_f[..., 3:19], dbl_f[..., 19:], dbl_b[..., 3:19], dbl_b[..., 19:],
            r(b, length, e).to(dtype), a_log.contiguous(), (a_log + 0.1 * r(e, 16)).contiguous(),
            r(e), r(e), 0.5 * r(e) - 3, 0.5 * r(e) - 3)


def _sequential(u, dr, B, C, a_log, D, bdt, reverse):
    """One direction by the recurrence element by element, in float64."""
    u, dr, B, C, a_log, D, bdt = (t.double() for t in (u, dr, B, C, a_log, D, bdt))
    b, length, e = u.shape
    y = torch.zeros(b, length, e, dtype=torch.float64)
    A = -a_log.exp()
    for i in range(b):
        for c in range(e):
            h = torch.zeros(A.shape[1], dtype=torch.float64)
            for t in (range(length - 1, -1, -1) if reverse else range(length)):
                delta = F.softplus(dr[i, t, c] + bdt[c])
                h = torch.exp(delta * A[c]) * h + delta * u[i, t, c] * B[i, t]
                y[i, t, c] = (h * C[i, t]).sum() + D[c] * u[i, t, c]
    return y


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_plain_scan_matches_a_float64_sequential_recurrence(reverse):
    """Each direction of the plain version (float32) against the recurrence
    taken element by element in float64: rtol 1e-5 in norm (float32's
    rounding over 9 tokens)."""
    args = _scan_inputs(2, 9, 6)
    d = 1 if reverse else 0
    pick = (args[d], args[2 + d], args[4 + 2 * d], args[5 + 2 * d], args[9 + d],
            args[11 + d], args[13 + d])
    got = ss.scan_plain(*pick, reverse)
    assert got.dtype == torch.float32
    assert _rel(got, _sequential(*pick, reverse)) < 1e-5


def test_plain_scan_gradients_pass_gradcheck():
    """The function in float64, every input's gradient by autograd through
    the plain version, against finite differences."""
    args = tuple(t.double().requires_grad_(True) for t in _scan_inputs(1, 5, 3))
    assert torch.autograd.gradcheck(ss.selective_scan, args, eps=1e-6, atol=1e-6)


def _mirror(mixer: Mixer) -> Mixer:
    """The mixer with its two directions' weights swapped."""
    other = Mixer(mixer.in_proj.in_features, mixer.d_state, mixer.d_conv,
                  mixer.inner // mixer.in_proj.in_features)
    sd = mixer.state_dict()
    swap = {}
    for k, v in sd.items():
        for a, b in (("conv1d.", "conv1d_b."), ("x_proj.", "x_proj_b."),
                     ("dt_proj.", "dt_proj_b."), ("A_log", "A_b_log")):
            if k.startswith(a):
                k = b + k[len(a):]
            elif k.startswith(b):
                k = a + k[len(b):]
        swap[{"D": "D_b", "D_b": "D"}.get(k, k)] = v
    other.load_state_dict(swap)
    return other


def test_reversed_tokens_and_swapped_directions_mirror_the_mixer():
    """Reversing the tokens and swapping the two directions' weights (convs,
    x_proj, dt_proj, A_log, D) gives the mixer's output reversed: the
    anti-causal conv and the scan by reversed index are the causal
    direction's mirror."""
    mixer = Mixer(16, expand=2)
    mixer.reset_parameters(2, torch.Generator().manual_seed(4))
    with torch.no_grad():
        for p in mixer.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    h = torch.randn(2, 11, 16, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = mixer(h).flip(1)
        got = _mirror(mixer)(h.flip(1))
    assert _rel(got, want) < 1e-6


def test_kernels_refuse_cpu_tensors_and_the_cpu_counts_plain_calls():
    """The kernels' entries raise on CPU tensors before any build; a CPU
    call takes the plain version: a plain call and no launch."""
    args = _scan_inputs(1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ss.forward_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ss.backward_cuda(args, torch.zeros(1, 4, 64), torch.zeros(1, 4, 64))
    before = trace.counters()
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    ss.selective_scan(*leaves).sum().backward()
    after = trace.counters()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("ops.selective_scan.") and after[k] != before.get(k, 0)}
    assert moved == {"ops.selective_scan.calls": 1, "ops.selective_scan.plain_calls": 1,
                     "ops.selective_scan.tokens": 4}
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_yardstick_passes_the_plain_version_and_catches_faults(dtype):
    """``mismatch`` (the card tests' yardstick of the kernels) reads the
    plain version within the card tests' bound of itself, and a lost
    backward direction, an ungated output and a ``dA_log`` summed over one
    row short each beyond it."""
    args = _scan_inputs(3, 12, 64, dtype)
    dout = torch.randn(3, 12, 64, generator=torch.Generator().manual_seed(1)).to(dtype)
    out = ss.forward_plain(*args)
    grads = ss.backward_plain(args, dout)
    plain = ss.mismatch((out, *grads), args, dout)
    bound = {k: max(2 * v, 1e-5) for k, v in plain.items()}
    assert all(v <= bound[k] for k, v in plain.items())
    no_bwd = (ss.scan_plain(args[0], args[2], args[4], args[5], args[9], args[11], args[13],
                            False) * F.silu(args[8].float()) / 2).to(dtype)
    assert ss.mismatch((no_bwd, *grads), args, dout)["out"] > bound["out"]
    ungated = (out.float() / F.silu(args[8].float()).clamp(min=1e-3)).to(dtype)
    assert ss.mismatch((ungated, *grads), args, dout)["out"] > bound["out"]
    short = list(grads)
    short[9] = grads[9] * 2 / 3
    assert ss.mismatch((out, *short), args, dout)["A_log_f"] > bound["A_log_f"]


def test_plain_grads_in_row_blocks_equal_the_whole_batch():
    """``plain_grads`` a few rows at a time (the card's yardstick at the
    cell's batch) gives the whole batch's output and gradients: the rows'
    joined, the parameters' summed over the blocks, in float64 to 1e-12
    (only the order of the parameters' sums differs); ``mismatch`` reads
    the same either way."""
    args = tuple(t.double() for t in _scan_inputs(5, 9, 64, torch.float32))
    dout = torch.randn(5, 9, 64, generator=torch.Generator().manual_seed(2)).double()
    whole = (ss.forward_plain(*args), *ss.backward_plain(args, dout))
    blocked = ss.plain_grads(args, dout, rows=2)
    assert len(blocked) == len(whole) == 16
    for got, want in zip(blocked, whole):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    low = tuple(t.float() for t in args)
    got = (ss.forward_plain(*low), *ss.backward_plain(low, dout.float()))
    a, b = ss.mismatch(got, low, dout.float()), ss.mismatch(got, low, dout.float(), rows=2)
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-9 for k in a)


def test_train_pass_draws_a_mask_a_block_and_stays_eager_off_the_card():
    """A train forward draws one ``[B]`` mask for each block's output with
    a drop-path rate (none for block 0, at rate 0), in order, and nothing
    else from the generator: the model's forward, its split (``draw_masks``
    then ``train_pass``) and the train step's forward
    (``train_graphs.train_forward``) alike, to the same outputs; off a card
    the step's forward runs eagerly."""
    m = _port(SMALL, _weights(SMALL))
    x = torch.randn(2, 100, SMALL["mel_bins"])
    want = torch.Generator().manual_seed(3)
    torch.rand(2, generator=want)            # block 1's draw (block 0 draws none)
    forward = train_graphs.train_forward(m)
    assert forward.pattern == (False, True)
    outs = []
    for run in (lambda g: m(x, train=True, generator=g),
                lambda g: m.train_pass(x, m.draw_masks(2, g)),
                lambda g: forward(x, generator=g)):
        g = torch.Generator().manual_seed(3)
        outs.append(run(g))
        assert torch.equal(g.get_state(), want.get_state())
    for out in outs[1:]:
        for k in out:
            assert torch.equal(out[k], outs[0][k]), k
    assert not forward.graphs._captured


def test_train_step_through_make_train_step():
    """Two mixup steps of the small model through ``train.make_train_step``
    (its forward from ``train_graphs.train_forward``): finite losses, every
    parameter moved, and a scan call a block a step, forward and backward
    on the plain version."""
    m = _port(SMALL, _weights(SMALL))
    start = {k: v.detach().clone() for k, v in m.state_dict().items()}
    state = train.create_train_state(m, device="cpu", seed=1)
    step = train.make_train_step(m, state, mixup_alpha=1.0)
    rng = np.random.RandomState(0)
    before = trace.counters().get("ops.selective_scan.calls", 0)
    for _ in range(2):
        x = torch.from_numpy(rng.randn(4, 100, SMALL["mel_bins"]).astype(np.float32))
        metrics = step(x, (rng.rand(4, SMALL["classes"]) < 0.3).astype(np.float32))
        assert np.isfinite(float(metrics["loss"]))
    assert trace.counters()["ops.selective_scan.calls"] - before == 2 * SMALL["depth"]
    for k, v in m.state_dict().items():
        assert not torch.equal(v, start[k]), k


def test_main_train_and_predictor_run_aum(tmp_path):
    """``main train --model_type AudioMamba`` (the published model) for 2
    steps on a packed 0.5 s corpus (51 frames, padded to the model's 1008),
    then ``Predictor.from_workspace`` serves its checkpoint."""
    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=4",
                   "--num_test=2", "--num_eval=2", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    main.main(["train", f"--workspace={ws}", "--model_type=AudioMamba", "--batch_size=2",
               "--feature_source=waveform", "--augmentation=mixup",
               "--stop_iteration=2", "--eval_interval=2", "--eval_max_iteration=1"],
              device="cpu")
    rc = "loss_type=clip_bce/augmentation=mixup/batch_size=2"
    ckpt = os.path.join(ws, "checkpoints", "main", "model_type=AudioMamba", rc,
                        "2_iterations.pth")
    assert os.path.isfile(ckpt)
    cfg = Config(clip_samples=16000)
    pred = serving.Predictor.from_workspace(ws, "AudioMamba", rc, cfg=cfg, device="cpu")
    assert isinstance(pred.model, AudioMamba)
    wave = np.random.RandomState(0).randn(2, cfg.clip_samples).astype(np.float32)
    out = pred(wave)
    assert out["clipwise_output"].shape == (2, 17)
    assert out["framewise_output"].shape == (2, cfg.frames_num, 17)
    assert np.isfinite(out["framewise_output"]).all()
