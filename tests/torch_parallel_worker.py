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
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
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
    only a mesh of 1 divides (``ws_sit``: rank 1 sits it out). Every rank
    returns what ``main.main`` returned."""
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
    return out


JOBS = {"step": step_job, "cli": cli_job}
