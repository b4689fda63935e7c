"""Worker processes for ``tests/test_torch_parallel.py`` (not a test file).

:func:`launch` starts ``n`` processes with ``torch.multiprocessing``'s spawn
method; each joins a gloo group over a ``FileStore`` (no port to collide
with another test worker), runs one job of :data:`JOBS` and saves what it
returns to ``rank<r>.pt`` for the test to read. The module imports only
torch, numpy and the port, so a child never imports jax: the test module,
which does, is never imported in a child.

Every launch has its deadlines: ``init_process_group`` and each collective
time out after 60 s, and :func:`launch` kills the children and raises when
they have not all ended within ``timeout`` seconds.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from sound_event_detection_dcase2017_task4_torch import main, parallel, train
from sound_event_detection_dcase2017_task4_torch.models import HTSAT, SedCnn
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables

FORBIDDEN = ("jax", "flax", "optax", "sound_event_detection_dcase2017_task4_tpu")
SMALL = dict(classes_num=17, channels=(8, 16), head="att")
# the drawn steps compute in float64 (parameters, gradients and BatchNorm
# statistics stay float32): in float32 the first conv's train-mode gradient
# moves by 1.4e-4 of its scale between 1 and 4 threads of one process (the
# CPU conv backward's reduction order, amplified by BatchNorm's projection),
# as much as the tolerance; in float64 by 3e-7
DRAWN = dict(SMALL, dropout=0.2, dtype=torch.float64)


def launch(job: str, n: int, spec: dict, timeout: float = 240.0):
    """Run ``JOBS[job](spec)`` in ``n`` ranks; returns each rank's result,
    in rank order."""
    return parallel.launch("torch_parallel_worker:run", n, arg=(job, spec),
                           device="cpu", timeout=timeout)


def run(arg, device) -> dict:
    """A rank's body: the job, and the forbidden packages it loaded."""
    job, spec = arg
    out = JOBS[job](spec)
    out["forbidden_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    return out


def _running(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def jax_step(spec, mesh):
    """One step from the JAX package's init (dropout 0, no mixup) on this
    rank's rows: loss, grad-norm, the averaged gradients and the running
    statistics."""
    model = load_jax_variables(SedCnn(dropout=0.0, **SMALL), spec["init"])
    state = train.create_train_state(model, device="cpu")
    step = train.make_train_step(model, state, mesh=mesh)
    m = step(parallel.shard_batch(spec["x"], mesh), spec["y"])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "running": _running(model)}


def drawn_steps(spec, mesh, remat: bool, steps: int = 3):
    """``steps`` steps from seed 0 with dropout 0.2, mixup α = 1 and
    SpecAugment (draws from the state's generators, seed 1), on the
    batches ``spec["batches"]`` of the global ``x``; ``mesh=None`` is the
    1-process run. Returns per-step loss and grad-norm, the first step's
    gradients and running statistics, and the final state."""
    model = SedCnn(remat=remat, generator=torch.Generator().manual_seed(0),
                   **DRAWN)
    state = train.create_train_state(model, device="cpu", seed=1)
    step = train.make_train_step(model, state, mixup_alpha=1.0,
                                 use_spec_augment=True, check_numerics=True,
                                 mesh=mesh)
    out = {"loss": [], "grad_norm": [], "nonfinite": []}
    for k, rows in enumerate(spec["batches"][:steps]):
        x = spec["x"][rows]
        m = step(x if mesh is None else parallel.shard_batch(x, mesh),
                 spec["y"][rows])
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["nonfinite"].append(int(m["nonfinite_count"]))
        if k == 0:
            out["grads"] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            out["running"] = _running(model)
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["generator"] = state.dropout_generator.get_state()
    return out, model


def ragged_eval(model, spec, mesh):
    """Eval over batches of 8 and 4 rows and a ragged one of 3 (which no
    mesh of 2 or more splits)."""
    x, y = spec["x"], spec["y"]

    def gen():
        yield x[:8], y[:8]
        yield x[8:12], y[8:12]
        yield x[:3], y[:3]

    return train.forward_generator(train.make_eval_step(model), gen(),
                                   prefetch=0, mesh=mesh)


def step_job(spec):
    mesh = parallel.make_mesh("cpu")
    out = {"rank": mesh.rank, "size": mesh.size}
    if "init" in spec:
        out["jax"] = jax_step(spec, mesh)
    for remat in (False, True):
        out[f"drawn_remat{int(remat)}"], model = drawn_steps(spec, mesh, remat)
    out["eval"] = ragged_eval(model, spec, mesh)
    # make_mesh_for_batch: the largest mesh dividing the batch; ranks
    # beyond it get None, and the mesh's own collectives run
    out["mesh_for_batch"] = {}
    for batch in spec["mesh_batches"]:
        sub = parallel.make_mesh_for_batch(batch, "cpu")
        if sub is not None:
            flag = torch.ones(1)
            dist.all_reduce(flag, group=sub.group)
            assert int(flag) == sub.size
        out["mesh_for_batch"][batch] = None if sub is None else sub.size
    return out


def _train(ws, *extra):
    return main.main(["train", f"--workspace={ws}", *CLI_TRAIN, *extra],
                     device="cpu")


CLI_TRAIN = ["--model_type=Cnn_5layers_AvgPooling", "--batch_size=4",
             "--feature_source=waveform", "--augmentation=mixup",
             "--eval_interval=2", "--eval_max_iteration=1"]


def cli_job(spec):
    """``main train`` in the group: one step with evals at 0 and 1
    (``ws2``); 4 steps from scratch over the device cache with evals at 0,
    2 and 4 (``ws2_long``), a resume of that run from iteration 2 in a copy
    (``ws2_resumed``) and a resume from iteration 2 of the 1-process run
    the test made (``ws1_resumed``), host-fed; last a run at batch 3, which
    only a mesh of 1 divides (``ws_sit``: rank 1 sits it out); last a
    resume of the JAX package's checkpoint at iteration 2 for one step
    (``ws_jax2``). Every rank returns what ``main.main`` returned."""
    out = {"one_step": _train(spec["ws2"], "--device_cache=on",
                              "--stop_iteration=1", "--eval_interval=1"),
           "scratch": _train(spec["ws2_long"], "--device_cache=on",
                             "--stop_iteration=4")}
    if dist.get_rank() == 0:
        shutil.copytree(spec["ws2_long"], spec["ws2_resumed"], symlinks=True)
    dist.barrier()
    out["resumed"] = _train(spec["ws2_resumed"], "--device_cache=on",
                            "--resume_iteration=2", "--stop_iteration=4")
    out["resumed_from_one"] = _train(spec["ws1_resumed"], "--device_cache=off",
                                     "--resume_iteration=2",
                                     "--stop_iteration=4")
    out["sit_out"] = _train(spec["ws_sit"], "--batch_size=3",
                            "--stop_iteration=1", "--eval_interval=1")
    out["resumed_jax"] = _train(spec["ws_jax2"], "--device_cache=on",
                                "--resume_iteration=2", "--stop_iteration=3")
    return out


def trace_job(spec):
    """One float32 step with dropout and mixup (so ``mirror`` runs) under the
    CPU profiler after a first step: the ``parallel.*`` counters that step
    added, the model's BatchNorm widths and parameter count, this rank's
    rows, and the ``sedx.`` spans the profiler recorded, as ``(name, start
    µs, end µs)``."""
    from torch.profiler import ProfilerActivity, profile

    from sound_event_detection_dcase2017_task4_torch import trace
    from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm

    mesh = parallel.make_mesh("cpu")
    model = SedCnn(dropout=0.2, generator=torch.Generator().manual_seed(0),
                   **SMALL)
    state = train.create_train_state(model, device="cpu", seed=1)
    step = train.make_train_step(model, state, mixup_alpha=1.0, mesh=mesh)
    x, y = parallel.shard_batch(torch.from_numpy(spec["x"]), mesh), spec["y"]
    step(x, y)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x, y)
    after = trace.counters()
    return {"counted": {k: v - before.get(k, 0) for k, v in after.items()
                        if k.startswith("parallel.") and v != before.get(k, 0)},
            "bn_channels": [m.weight.numel() for m in model.modules()
                            if isinstance(m, BatchNorm)],
            "parameters": sum(p.numel() for p in model.parameters()),
            "all_have_grads": all(p.grad is not None for p in model.parameters()),
            "rows_bytes": x.numel() * x.element_size(),
            "spans": [(e.name, e.time_range.start, e.time_range.end)
                      for e in prof.events() if e.name.startswith("sedx.")]}


def exchange_log_job(spec):
    """``main train`` in the group for 2 steps with evals at 0 and 2; the
    eval at 2 logs the steps' collectives and MB a step."""
    return _train(spec["ws"], "--device_cache=off", "--stop_iteration=2",
                  "--eval_interval=2")


def fused_bn(spec, mesh, act):
    """One train-mode BatchNorm call of the fused path (``ops.bn_act``'s
    plain versions on the CPU) in float64 on this rank's rows of
    ``spec["x"]``, and its backward from this rank's rows of
    ``spec["dy"][act]``: the output, the gradients, the running statistics
    and the ``parallel.all_reduce_sum`` collectives of each direction."""
    from sound_event_detection_dcase2017_task4_torch import trace
    from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm

    bn = BatchNorm(spec["x"].shape[1]).double()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(spec[k])
    x = parallel.shard_batch(spec["x"], mesh).clone().requires_grad_(True)

    def reduces():
        return trace.counters().get("parallel.all_reduce_sum.calls", 0)

    n0 = reduces()
    y = bn._forward(x, True, mesh, act, True)
    n1 = reduces()
    y.backward(parallel.shard_batch(spec["dy"][act], mesh))
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "reduces": (n1 - n0, reduces() - n1)}


def bn_act_job(spec):
    mesh = parallel.make_mesh("cpu")
    return {act: fused_bn(spec, mesh, act) for act in spec["dy"]}


# a small HTS-AT in float64 compute (``bn0``'s sums stay float32), with a
# drop-path rate high enough that the masks drop branches
HTSAT_SMALL = dict(classes_num=5, spec_size=64, mel_bins=16, patch=4, window=4,
                   embed=16, depths=(2, 2, 2), heads=(2, 4, 8), drop_path=0.5,
                   dtype=torch.float64)


def htsat_steps(spec, mesh):
    """HTS-AT's train step with mixup α = 1 and drop-path over the global
    log-mel batches ``spec["x"]`` (this rank's rows of each; ``mesh=None``
    is the 1-process run): each step's loss, the first step's gradients and
    ``bn0``'s running statistics, and the final state."""
    model = HTSAT(generator=torch.Generator().manual_seed(0), **HTSAT_SMALL)
    state = train.create_train_state(model, device="cpu", seed=1)
    step = train.make_train_step(model, state, mixup_alpha=1.0, mesh=mesh)
    out = {"loss": []}
    for k, x in enumerate(spec["x"]):
        m = step(x if mesh is None else parallel.shard_batch(x, mesh), spec["y"][k])
        out["loss"].append(float(m["loss"]))
        if k == 0:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
            out["running"] = _running(model)
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def htsat_job(spec):
    return htsat_steps(spec, parallel.make_mesh("cpu"))


JOBS = {"step": step_job, "cli": cli_job, "trace": trace_job,
        "exchange_log": exchange_log_job, "bn_act": bn_act_job, "htsat": htsat_job}
