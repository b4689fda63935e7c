"""Train-mode BatchNorm with its epilogue (``ops.bn_act``) on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); here
the fused path runs on their plain versions, which have the kernels'
arithmetic and the hand-written backward formulas:

* in float64, the fused path (``BatchNorm._forward(..., fused=True)``)
  against the composite the CPU runs (BatchNorm, ReLU, ``avg_pool2d``, by
  autograd): the output, ``dx``, ``dweight``, ``dbias`` and the running
  statistics, for the three epilogues over planes 1001×64, 125×8, 15×1,
  31×2 and an odd one, C from 64 to 2048 and an odd C, ``recomputing`` on
  and off. The composite's statistics are float32, so the bound is
  float32's;
* ``torch.autograd.gradcheck`` of the fused path in float64;
* 2 gloo ranks (``tests/torch_parallel_worker.py``): one collective of
  the ``[2C]`` sums each way, and the one-process result on the global
  batch;
* the kernels' yardstick: ``sums_grad`` is the gradient the fused path
  hands K4, and ``grad_x_mismatch`` passes the plain ``dx`` rounded to
  bf16 or float32 and fails a ``dx`` that lost ``c₁`` or ``c₂·x`` or wrote
  0 where ``g`` is 0; the least bytes;
* the module imports, and refuses a CPU tensor, without nvcc or a GPU; the
  CPU's train step takes the composite (``ops.bn_act.calls`` stays 0), and
  ``ConvBlock`` on the CPU gives the bits it gave before the epilogues
  moved into ``BatchNorm``;
* the channels-last conv stack: the plain versions and the fused path on a
  channels-last ``x`` give the NCHW results and keep the layout; dropout
  applies the NCHW draw in ``x``'s layout; a crnn and a GLU train step keep
  every activation and gradient of the stack channels-last, count 8 and
  16 ``ops.bn_act.channels_last_calls`` a forward and equal the NCHW
  stack; HTS-AT's ``bn0`` stays NCHW.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sound_event_detection_dcase2017_task4_torch import trace, train
from sound_event_detection_dcase2017_task4_torch.models import SedCnn, get_model
from sound_event_detection_dcase2017_task4_torch.models import blocks
from sound_event_detection_dcase2017_task4_torch.models.blocks import (
    BatchNorm, ConvBlock, conv3x3)
from sound_event_detection_dcase2017_task4_torch.ops import bn_act

import torch_parallel_worker as worker

torch.set_num_threads(2)

ACTS = bn_act.ACTS
# (B, C, T, F): block 1 of the flagship, block 4, the 13-layer stack's last
# planes, an odd plane with an odd C
SHAPES = [(1, 64, 1001, 64), (2, 512, 125, 8), (2, 2048, 15, 1),
          (2, 1024, 31, 2), (3, 5, 9, 7)]


def _bn(c: int, seed: int = 0) -> BatchNorm:
    """A float64 BatchNorm with drawn scales, biases and running stats."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).double()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    return bn


def _inputs(shape, act, bn, seed=1):
    """``x`` and ``dy`` (pooled for ``relu_pool``), float64. ``x`` has
    per-channel offsets and scales, so that the statistics matter, and no
    element within 1e-4 of ReLU's kink at ``bn``'s batch statistics: there
    the two paths' roundings (the composite's are float32's) may take
    either side, and either is right."""
    g = torch.Generator().manual_seed(seed)
    b, c, t, f = shape
    x = (torch.randn(shape, generator=g, dtype=torch.float64)
         * (0.5 + torch.rand(1, c, 1, 1, generator=g, dtype=torch.float64))
         + 0.5 * torch.randn(1, c, 1, 1, generator=g, dtype=torch.float64))
    w, bias = bn.weight.detach(), bn.bias.detach()
    for _ in range(3):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        a = (w * torch.rsqrt(var + bn.epsilon)).view(1, -1, 1, 1)
        z = x * a + (bias.view(1, -1, 1, 1) - mean.view(1, -1, 1, 1) * a)
        near = z.abs() < 2e-3
        if not near.any():
            break
        x = torch.where(near, x + torch.where(z < 0, -4e-3, 4e-3) / a, x)
    assert (z.abs() > 1e-4).all()
    out = (b, c, t // 2, f // 2) if act == "relu_pool" else shape
    return x, torch.randn(out, generator=g, dtype=torch.float64)


def _run(bn, x, dy, act, fused, recomputing=False, mesh=None):
    bn.recomputing = recomputing
    x = x.clone().requires_grad_(True)
    bn.weight.grad = bn.bias.grad = None
    y = bn._forward(x, True, mesh, act, fused)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad.clone(),
            "dbias": bn.bias.grad.clone(),
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _close(got: dict, want: dict, rtol: float):
    """Each tensor within ``rtol`` of the largest magnitude of its want."""
    for k, w in want.items():
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(got[k], w, rtol=0, atol=rtol * scale,
                                   msg=lambda m, k=k: f"{k}: {m}")


CASES = [(s, a, r) for s in SHAPES for a in ACTS for r in (False, True)
         if not (a == "relu_pool" and min(s[2:]) < 2)]


@pytest.mark.parametrize("shape,act,recomputing", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{a}-{'re' if r else 'first'}"
                              for s, a, r in CASES])
def test_fused_path_matches_the_composite(shape, act, recomputing):
    fused, stock = _bn(shape[1]), _bn(shape[1])
    x, dy = _inputs(shape, act, fused)
    before = fused.running_mean.clone(), fused.running_var.clone()
    got = _run(fused, x, dy, act, True, recomputing)
    want = _run(stock, x, dy, act, False, recomputing)
    # the composite takes its statistics in float32
    _close(got, want, 2e-5)
    if recomputing:     # the running statistics are left alone
        assert torch.equal(got["running_mean"], before[0])
        assert torch.equal(got["running_var"], before[1])
    else:
        assert not torch.equal(got["running_mean"], before[0])


def test_fused_path_refuses_an_empty_pool():
    bn = _bn(3)
    x, _ = _inputs((2, 3, 15, 1), "relu", bn)
    with pytest.raises(RuntimeError):   # as the composite's avg_pool2d does
        bn._forward(x, True, None, "relu_pool", False)
    with pytest.raises(ValueError):
        bn_act.Link("gelu")


GRAD_SHAPES = [(2, 3, 6, 5), (3, 2, 5, 4), (2, 3, 7, 1)]
GRAD_CASES = [(s, a) for s in GRAD_SHAPES for a in ACTS
              if not (a == "relu_pool" and min(s[2:]) < 2)]


@pytest.mark.parametrize("shape,act", GRAD_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{a}" for s, a in GRAD_CASES])
def test_fused_path_gradcheck(shape, act):
    bn = _bn(shape[1], seed=3)
    bn.recomputing = True
    x, _ = _inputs(shape, act, bn, seed=4)
    x.requires_grad_(True)

    def f(x, weight, bias):
        return bn._forward(x, True, None, act, True)

    assert torch.autograd.gradcheck(f, (x, bn.weight, bn.bias), eps=1e-6,
                                    atol=1e-6, rtol=1e-4)


def test_the_plain_versions_keep_the_input_dtype():
    x = torch.randn(2, 3, 5, 4).to(torch.bfloat16)
    a, b = torch.rand(3) + 0.5, torch.randn(3)
    for act in ACTS:
        y = bn_act.apply_plain(x, a, b, act)
        assert y.dtype == torch.bfloat16
        dy = torch.randn(y.shape).to(torch.bfloat16)
        assert bn_act.grad_x_plain(dy, x, a, b, torch.randn(6), act).dtype == torch.bfloat16
        assert bn_act.grad_stats_plain(dy, x, a, b, act).dtype == torch.float32
    assert bn_act.stats_plain(x).dtype == torch.float32


# --- 2 gloo ranks ------------------------------------------------------------

MESH_SHAPE = (4, 3, 9, 7)


@pytest.fixture(scope="module")
def mesh_runs():
    """The fused call in 2 ranks and in one process on the global batch."""
    bn = _bn(MESH_SHAPE[1], seed=6)
    x, _ = _inputs(MESH_SHAPE, "relu", bn, seed=5)
    spec = {"x": x, "dy": {act: _inputs(MESH_SHAPE, act, bn, seed=7)[1]
                           for act in ACTS}}
    for k in ("weight", "bias", "running_mean", "running_var"):
        spec[k] = getattr(bn, k).detach().clone()
    ranks = worker.launch("bn_act", 2, spec)
    one = {act: worker.fused_bn(spec, None, act) for act in ACTS}
    return ranks, one


@pytest.mark.parametrize("act", ACTS)
def test_two_ranks_sum_once_each_way_and_equal_one_process(mesh_runs, act):
    ranks, one = mesh_runs
    want = one[act]
    got = [r[act] for r in ranks]
    assert [g["reduces"] for g in got] == [(1, 1), (1, 1)]
    assert want["reduces"] == (0, 0)
    assert all(r["forbidden_modules"] == [] for r in ranks)
    _close({"y": torch.cat([g["y"] for g in got]),
            "dx": torch.cat([g["dx"] for g in got]),
            # each rank's share of the parameters' gradient (the step's
            # average_ sums them over the ranks)
            "dweight": got[0]["dweight"] + got[1]["dweight"],
            "dbias": got[0]["dbias"] + got[1]["dbias"]},
           {k: want[k] for k in ("y", "dx", "dweight", "dbias")}, 1e-12)
    for g in got:
        _close({k: g[k] for k in ("running_mean", "running_var")},
               {k: want[k] for k in ("running_mean", "running_var")}, 1e-12)


# --- the kernels' yardstick ----------------------------------------------------

def _case(shape, act, dtype=torch.float64, seed=2):
    """``x`` and ``dy`` in ``dtype``, a drawn ``BatchNorm``'s scale and
    bias, and :func:`bn_act.sums_grad`'s ``(a, b, gs)`` for them."""
    bn = _bn(shape[1], seed)
    x, dy = _inputs(shape, act, bn, seed)
    x, dy = x.to(dtype), dy.to(dtype)
    return (x, dy, bn) + bn_act.sums_grad(x, dy, bn.weight.detach(),
                                          bn.bias.detach(), act, rows=1)


@pytest.mark.parametrize("act", ACTS)
def test_sums_grad_is_what_the_fused_path_hands_the_last_pass(act):
    """``dx`` of the fused path (float64, autograd through ``BatchNorm``'s
    ``[C]`` math) is ``grad_x_plain`` with ``sums_grad``'s ``a, b, gs``."""
    x, dy, bn, a, b, gs = _case((3, 6, 11, 9), act)
    got = _run(bn, x, dy, act, True)["dx"]
    want = bn_act.grad_x_plain(dy, x, a.double(), b.double(), gs.double(),
                               act)
    _close({"dx": got}, {"dx": want}, 1e-6)
    c = x.shape[1]                  # and the sums' gradient is not nil
    assert 1e-4 < float(gs[:c].abs().max()) / float(a.abs().max()) < 1


RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -20}
REGIONS = {"none": ("g",), "relu": ("g", "masked"),
           "relu_pool": ("g", "masked", "dropped")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("act", ACTS)
def test_grad_x_mismatch_passes_the_rounded_plain_dx(act, dtype):
    x, dy, _, a, b, gs = _case((3, 6, 11, 9), act, dtype)
    got = bn_act.grad_x_mismatch(bn_act.grad_x_plain(dy, x, a, b, gs, act),
                                 dy, x, a, b, gs, act, RTOL[dtype], rows=2)
    assert {k for k, (_, n) in got.items() if n} == set(REGIONS[act]), got
    assert all(w <= 1 for w, _ in got.values()), got


def _no_c1(dy, x, a, b, gs, act):
    c = x.shape[1]
    return bn_act.grad_x_plain(dy, x, a, b, torch.cat([0 * gs[:c], gs[c:]]),
                               act)


def _no_c2(dy, x, a, b, gs, act):
    c = x.shape[1]
    return bn_act.grad_x_plain(dy, x, a, b, torch.cat([gs[:c], 0 * gs[c:]]),
                               act)


def _zero_where_g_is_0(dy, x, a, b, gs, act):
    dx = bn_act.grad_x_plain(dy, x, a, b, gs, act)
    g = bn_act._grad_z(dy, x, a, b, act)
    return torch.where(g == 0, torch.zeros_like(dx), dx)


WRONG = [("relu", torch.bfloat16, f) for f in (_no_c1, _no_c2, _zero_where_g_is_0)] + [
    ("relu_pool", torch.bfloat16, f) for f in (_no_c1, _no_c2, _zero_where_g_is_0)] + [
    ("none", torch.float32, f) for f in (_no_c1, _no_c2)]


@pytest.mark.parametrize("act,dtype,wrong", WRONG,
                         ids=[f"{a}-{str(d)[6:]}-{w.__name__[1:]}" for a, d, w in WRONG])
def test_grad_x_mismatch_fails_a_wrong_dx(act, dtype, wrong):
    """A ``dx`` without ``c₁`` or ``c₂·x``, or with 0 where ``g`` is 0,
    fails where ``g`` is 0 (ReLU's mask, the pool's dropped row and
    column), at the gradient's scale in a step; ``none`` in float32 fails
    everywhere."""
    x, dy, _, a, b, gs = _case((3, 6, 11, 9), act, dtype)
    got = bn_act.grad_x_mismatch(wrong(dy, x, a, b, gs, act), dy, x, a, b,
                                 gs, act, RTOL[dtype], rows=2)
    for region in REGIONS[act][1:] or ("g",):
        assert got[region][0] > 4, (region, got)


@pytest.mark.parametrize("act,want", [
    ("relu", (2 * 2 * 524_812_288, 3 * 2 * 524_812_288)),
    ("none", (2 * 2 * 524_812_288, 3 * 2 * 524_812_288)),
    ("relu_pool", (2 * (524_812_288 + 131_072_000),
                   2 * (2 * 524_812_288 + 131_072_000))),
])
def test_least_bytes(act, want):
    assert bn_act.least_bytes((128, 64, 1001, 64), 2, act) == want


# --- the CPU keeps the composite ----------------------------------------------

def test_the_module_imports_and_refuses_cpu_tensors_without_nvcc():
    code = ("import torch\n"
            "from sound_event_detection_dcase2017_task4_torch.ops import bn_act\n"
            "x = torch.zeros(2, 3, 4, 4)\n"
            "for fn, args in ((bn_act.stats_cuda, (x,)),\n"
            "                 (bn_act.apply_cuda, (x, torch.ones(3), torch.zeros(3), 'relu'))):\n"
            "    try:\n"
            "        fn(*args)\n"
            "        raise SystemExit('a CPU tensor was taken')\n"
            "    except ValueError as e:\n"
            "        assert 'CUDA' in str(e), e\n"
            "assert bn_act.LIBRARY._lib is None\n"
            "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("model_type,n_bn", [("Cnn_5layers_AvgPooling", 4),
                                             ("Cnn_9layers_Glu_AttPooling", 16)])
def test_the_cpu_train_step_takes_the_composite(model_type, n_bn):
    model = get_model(model_type)
    if model.block == "glu":        # the GLU stack at small widths
        model = type(model)(channels=(4, 4, 4, 4), block="glu")
    state = train.create_train_state(model, device="cpu", seed=0)
    step = train.make_train_step(model, state)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 32, 64).astype(np.float32))
    y = (rng.rand(2, 17) < 0.2).astype(np.float32)
    before = trace.counters()
    step(x, y)
    after = trace.counters()
    assert after.get("ops.bn_act.calls", 0) == before.get("ops.bn_act.calls", 0)
    assert after.get("ops.bn_act.launches", 0) == before.get("ops.bn_act.launches", 0)
    assert (after["ops.bn_act.plain_calls"]
            - before.get("ops.bn_act.plain_calls", 0)) == n_bn


@pytest.mark.parametrize("train_mode", [False, True])
def test_conv_block_on_the_cpu_gives_the_bits_of_relu_then_pool(train_mode):
    block = ConvBlock(3, 6)
    block.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 11, 9, generator=torch.Generator().manual_seed(1))
    clone = ConvBlock(3, 6)
    clone.load_state_dict(block.state_dict())
    got = block(x, train_mode)
    # the block as it was written before its BatchNorms took the epilogue,
    # on the block's channels-last convs
    h = x
    for conv, bn in zip(clone.convs, clone.bns):
        h = F.relu(bn(conv3x3(h, conv.weight, torch.float32), train_mode))
    want = F.avg_pool2d(h, (2, 2))
    assert torch.equal(got, want)
    for k, v in block.state_dict().items():
        assert torch.equal(v, clone.state_dict()[k]), k


# --- the channels-last conv stack ------------------------------------------------

CL = torch.channels_last


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=CL)


LAYOUT_CASES = [(s, a) for s in SHAPES for a in ACTS
                if not (a == "relu_pool" and min(s[2:]) < 2)]


@pytest.mark.parametrize("shape,act", LAYOUT_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{a}" for s, a in LAYOUT_CASES])
def test_channels_last_gives_the_nchw_results(shape, act):
    """The plain versions and the fused path on a channels-last ``x`` (and
    ``dy``) give the NCHW results in float64, odd planes and an odd C
    included, and their outputs keep ``x``'s layout."""
    bn, nchw = _bn(shape[1]), _bn(shape[1])
    x, dy = _inputs(shape, act, bn)
    xc, dyc = _cl(x), _cl(dy)
    assert bn_act.channels_last(xc) and not bn_act.channels_last(x)
    a, b, gs = (t.double() for t in bn_act.sums_grad(
        x, dy, bn.weight.detach(), bn.bias.detach(), act, rows=1))
    plain = {"sums": (bn_act.stats_plain(xc), bn_act.stats_plain(x)),
             "y": (bn_act.apply_plain(xc, a, b, act),
                   bn_act.apply_plain(x, a, b, act)),
             "grad_sums": (bn_act.grad_stats_plain(dyc, xc, a, b, act),
                           bn_act.grad_stats_plain(dy, x, a, b, act)),
             "dx": (bn_act.grad_x_plain(dyc, xc, a, b, gs, act),
                    bn_act.grad_x_plain(dy, x, a, b, gs, act))}
    _close({k: g for k, (g, _) in plain.items()},
           {k: w for k, (_, w) in plain.items()}, 1e-12)
    assert plain["y"][0].is_contiguous(memory_format=CL)
    assert plain["dx"][0].is_contiguous(memory_format=CL)
    got, want = _run(bn, xc, dyc, act, True), _run(nchw, x, dy, act, True)
    _close(got, want, 1e-12)
    assert got["y"].is_contiguous(memory_format=CL)
    assert bn_act.channels_last(got["dx"])


@pytest.mark.parametrize("shape", [(2, 8, 9, 5), (3, 16, 4, 4)])
def test_dropout_applies_the_nchw_draw_in_x_layout(shape):
    """Dropout on a channels-last ``x`` applies ``torch.rand(shape) <
    threshold/65536`` element for element, as on NCHW, and keeps the
    layout."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    y0 = blocks.dropout(x, 0.2, True, torch.Generator().manual_seed(7))
    y1 = blocks.dropout(_cl(x), 0.2, True, torch.Generator().manual_seed(7))
    assert bn_act.channels_last(y1)
    assert torch.equal(y1, y0)
    keep = (torch.rand(shape, generator=torch.Generator().manual_seed(7))
            < blocks._threshold(0.2) / 65536.0)
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(y1 != 0, keep)


STACKS = {"crnn": (dict(channels=(8, 16, 16, 8), seq="gru", gru_hidden=8), 8),
          "glu": (dict(channels=(8, 8, 8, 8), block="glu"), 16)}


def _fused_on_the_cpu(monkeypatch):
    """Train-mode BatchNorm on the fused path, whose plain versions run on
    the CPU, as the kernels run on a card."""
    monkeypatch.setattr(BatchNorm, "forward",
                        lambda self, x, train=False, mesh=None, act="none":
                        self._forward(x, train, mesh, act, train))


def _stack_step(model, x):
    """A train forward and backward: the outputs, every parameter's
    gradient, and the layout seen at each point of the conv stack: the
    output of each block, its dropout and each BatchNorm, the input of each
    BatchNorm, and the gradient at each block's and BatchNorm's output."""
    seen, hooks = [], []

    def watch(name, grads=True):
        def hook(mod, args, out):
            seen.append((f"{name} out", out.is_contiguous(memory_format=CL)))
            if isinstance(mod, BatchNorm):
                seen.append((f"{name} in", bn_act.channels_last(args[0])))
            if grads:
                out.register_hook(lambda g: seen.append(
                    (f"{name} grad", bn_act.channels_last(g))))
        return hook

    for i, (block, drop) in enumerate(zip(model.blocks, model.dropouts)):
        hooks.append(block.register_forward_hook(watch(f"block {i}")))
        # the last dropout's gradient is the stack-end mean's broadcast
        hooks.append(drop.register_forward_hook(watch(f"dropout {i}", False)))
        for n, m in block.named_modules():
            if isinstance(m, BatchNorm):
                hooks.append(m.register_forward_hook(watch(f"block {i} {n}")))
    out = model(x, train=True, generator=torch.Generator().manual_seed(5))
    (out["clipwise_output"].sum() + out["framewise_output"].mean()).backward()
    for h in hooks:
        h.remove()
    got = {k: out[k].detach() for k in ("clipwise_output", "framewise_output",
                                        "embedding")}
    got.update({n: p.grad for n, p in model.named_parameters()})
    return got, seen


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composite"])
@pytest.mark.parametrize("family", sorted(STACKS))
def test_the_conv_stack_stays_channels_last_and_equals_nchw(monkeypatch, family,
                                                            fused):
    """A crnn and a GLU ``SedCnn`` train step (forward and backward) keep
    every activation of the conv stack and its gradient channels-last, on
    the fused path (``ops.bn_act.channels_last_calls``: 8 and 16 a
    forward) and on the composite, and equal the NCHW stack (NCHW convs)
    to float32 tolerance."""
    kw, n_bn = STACKS[family]
    if fused:
        _fused_on_the_cpu(monkeypatch)
    model = SedCnn(generator=torch.Generator().manual_seed(0), **kw)
    twin = SedCnn(**kw)
    twin.load_state_dict(model.state_dict())
    x = torch.randn(3, 64, 32, generator=torch.Generator().manual_seed(1))
    before = trace.counters()
    got, seen = _stack_step(model, x)
    after = trace.counters()
    key = "ops.bn_act.channels_last_calls"
    assert after.get(key, 0) - before.get(key, 0) == (n_bn if fused else 0)
    assert len(seen) == 4 * 2 + n_bn * 3 + 4, seen
    assert all(ok for _, ok in seen), [k for k, ok in seen if not ok]
    monkeypatch.setattr(blocks, "conv3x3", lambda x, w, dt: F.conv2d(
        x.to(dt, memory_format=torch.contiguous_format), w.to(dt), padding=1))
    want, seen = _stack_step(twin, x)
    assert not any(ok for k, ok in seen if k.endswith(" in"))
    assert trace.counters().get(key, 0) == after.get(key, 0)
    assert set(got) == set(want)
    # each within 2e-5 of its largest magnitude; a leaf under 1e-3 of the
    # median leaf's (the attention logits' bias, shared by the softmax's
    # time steps, whose gradient is 0 but for rounding) only stays under it
    floor = 1e-3 * float(torch.tensor([w.abs().max() for w in want.values()]).median())
    small = {k for k, w in want.items() if float(w.abs().max()) < floor}
    assert small <= {"att_block.att.bias"}, small
    assert all(float(got[k].abs().max()) < floor for k in small)
    _close({k: got[k] for k in want if k not in small},
           {k: w for k, w in want.items() if k not in small}, 2e-5)


def test_htsat_bn0_keeps_the_nchw_kernels(monkeypatch):
    """HTS-AT's ``bn0`` takes an NCHW ``[B, mel, T, 1]``: a train forward
    makes one fused call and no channels-last one."""
    from sound_event_detection_dcase2017_task4_torch.models.htsat import HTSAT

    _fused_on_the_cpu(monkeypatch)
    model = HTSAT(classes_num=5, spec_size=64, mel_bins=16, patch=4, window=4,
                  embed=16, depths=(2, 2), heads=(2, 4))
    x = torch.randn(2, 250, 16, generator=torch.Generator().manual_seed(1))
    before = trace.counters()
    model(x, train=True, generator=torch.Generator().manual_seed(2))
    after = trace.counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in (
        "ops.bn_act.calls", "ops.bn_act.channels_last_calls")} == {
        "ops.bn_act.calls": 1, "ops.bn_act.channels_last_calls": 0}
