"""Training cells: back-to-back steps of the port's train step over an
int16 clip bank on the card.

Set-up makes the weights and the bank from the seed, builds the step
(``train.make_train_step`` with the bank kernel as its frontend) and takes
its first ``checked_steps`` steps through the same call and feed as the
window; they warm up every shape the window uses. The window then runs
steps until ``--seconds`` have passed and ends in a synchronise.

What decides ``correct``: once the window has closed and the program's
state is freed, the reference takes the same first steps from the same
weights on the same clips (made again from the seed), targets, mixup
weights and dropout masks (drawn by the port's documented rule: a device
generator and a host generator both seeded ``seed + 1``). Compared: each
step's loss; each parameter's first gradient, read from Adam's state after
one step; each parameter's change over the checked steps.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time

import numpy as np
import torch

from ..reference import model as ref_model
from ..reference import train as ref_train
from . import common, faults, inputs
from .trace import Tracer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(fe: dict, classes: int):
    from sound_event_detection_dcase2017_task4_torch.config import Config

    return Config(sample_rate=fe["sample_rate"], clip_samples=fe["clip_samples"],
                  window_size=fe["window_size"], hop_size=fe["hop_size"],
                  mel_bins=fe["mel_bins"], fmin=fe["fmin"], fmax=fe["fmax"],
                  classes_num=classes)


def norm_of(conf: dict) -> tuple:
    n = conf["frontend"]["mel_bins"]
    return (np.full(n, conf["norm"]["mean"], np.float32),
            np.full(n, conf["norm"]["std"], np.float32))


class PortTrainer:
    """The system under test: the port's train step over the bank (under a
    data-parallel ``mesh``, this rank's part of it)."""

    def __init__(self, conf: dict, weights: dict, seed: int, device, mesh=None,
                 mark=lambda phase: None):
        from sound_event_detection_dcase2017_task4_torch import models, train
        from sound_event_detection_dcase2017_task4_torch.ops import stft

        mark("port_imported")
        tr = conf["train"]
        cfg = port_config(conf["frontend"], conf["model"]["classes"])
        self.bank = inputs.make_bank(seed, tr["bank_clips"], conf["frontend"],
                                     functools.partial(stft.prepare_chunks, cfg=cfg),
                                     device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        mark("bank")
        model = models.get_model(conf["model_type"], dtype=DTYPES[tr["compute_dtype"]],
                                 remat=tr["remat"])
        model.to(device)
        model.load_state_dict(weights)
        self.params = dict(model.named_parameters())
        self.state = train.create_train_state(model, seed=seed, device=device,
                                              learning_rate=tr["learning_rate"])
        self.step_fn = train.make_train_step(
            model, self.state, scalar=norm_of(conf), mixup_alpha=tr["mixup_alpha"],
            bank=self.bank, wave_scale=inputs.PCM_SCALE,
            bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=inputs.PCM_SCALE),
            mesh=mesh)

    def step(self, idx, y) -> torch.Tensor:
        return self.step_fn(idx, y)["loss"]

    def first_grad(self, names) -> torch.Tensor:
        """Each parameter's gradient norm as Adam got it, from its first
        moment after one step (0 where the optimizer holds none)."""
        state = self.state.optimizer.state
        return torch.stack([state[self.params[k]]["exp_avg"].norm() / (1 - ref_train.BETA1)
                            if "exp_avg" in state[self.params[k]]
                            else self.params[k].new_zeros(()) for k in names])

    def change(self, start: dict, names) -> torch.Tensor:
        return torch.stack([(self.params[k].detach() - start[k]).norm() for k in names])


class ReferenceTrainer:
    """The reference put in the program's place (the control), at the
    operand precision ``quant``; it reads the bank's clips made again from
    the seed, and draws mixup weights and dropout masks by the port's rule."""

    def __init__(self, conf: dict, weights: dict, seed: int, device, quant, dist=None):
        tr = conf["train"]
        self.fe, self.seed, self.device, self.dist = conf["frontend"], seed, device, dist
        self.alpha = tr["mixup_alpha"]
        self.mixup = np.random.default_rng(seed + 1)
        self.tr = ref_train.Trainer(conf["model"], conf["frontend"], norm_of(conf),
                                    weights, seed + 1, tr["learning_rate"], quant, dist=dist)

    def step(self, idx, y) -> torch.Tensor:
        lam = self.mixup.beta(self.alpha, self.alpha, len(idx))
        own, partner = rank_rows(idx, self.dist)
        wave = inputs.bank_waves(self.seed, own, self.fe, self.device)
        other = (None if self.dist is None
                 else inputs.bank_waves(self.seed, partner, self.fe, self.device))
        return self.tr.step(wave, y, lam, other)

    def first_grad(self, names) -> torch.Tensor:
        return self.tr.first_grad()

    def change(self, start: dict, names) -> torch.Tensor:
        return self.tr.change(start)


def rank_rows(idx, dist):
    """This rank's rows of a global index, and those of the rank whose rows
    the global batch reversed puts beside them."""
    if dist is None:
        return idx, idx
    b = len(idx) // dist.world
    r, q = dist.rank, dist.world - 1 - dist.rank
    return idx[r * b:(r + 1) * b], idx[q * b:(q + 1) * b]


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared. Gaps of norms are taken leaf by leaf and
    measured against the larger of the reference leaf's norm and the
    median leaf's; leaves whose reference gradient is under a thousandth
    of the median leaf's are left out (their Adam steps are round-off)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad"].values())))
    c_med = float(np.median(list(ref["change"].values())))
    leaves = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    grad = {k: abs(got["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], g_med)
            for k in leaves}
    change = {k: abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med)
              for k in leaves}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g], "change_gap": change[worst_c],
            "loss1_gap": abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "grad_median_gap": float(np.median(list(grad.values()))),
            "change_median_gap": float(np.median(list(change.values()))),
            "grad_leaf": worst_g, "change_leaf": worst_c,
            "leaves_left_out": sorted(set(ref["grad"]) - set(leaves))}


def run(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, fault=None) -> tuple[dict, dict, object]:
    """One run of the cell. Returns the result (without ``correct``), the
    readings to judge, and the tracer (its trace when on). ``control``
    puts the reference at that operand precision in the program's place;
    ``fault`` plants one of ``faults.FAULTS`` in the port.

    A cell on more than one chip runs as that many ranks, one process a
    card, started by the port's ``parallel.launch`` (the ranks meet over a
    ``FileStore`` in a temporary directory); the result is rank 0's, with
    the highest peak, the ranks' mean device time, and under ``forbidden``
    the JAX modules that any rank held once its window had closed."""
    chips = c["workload"]["chips"]
    if chips == 1:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            return _run(c, seed, seconds, trace, device, t_start, control)
    from sound_event_detection_dcase2017_task4_torch import parallel

    wall = time.time() - (time.perf_counter() - t_start)
    outs = parallel.launch(RANK_TARGET, chips,
                           (c, seed, seconds, trace, wall, control, fault),
                           device=torch.device(device).type, timeout=1800)
    result, readings, trace0, _ = outs[0]
    result["forbidden"] = sorted({name for o in outs for name in o[3]})
    result["peak_bytes"] = max(o[0]["peak_bytes"] for o in outs)
    result["e2e"]["peak_mem_gib"] = result["peak_bytes"] / 2 ** 30
    if trace0 is not None:
        result["busy_s"] = float(np.mean([o[2].busy_s() for o in outs]))
    tracer = Tracer(trace)
    tracer.trace = trace0
    return result, readings, tracer


def rank_run(arg, device):
    """A rank of a multi-chip run (``parallel.launch`` calls it, in a group
    already joined): the cell on this rank's card, its part of every step,
    and the JAX modules this process holds at its end."""
    c, seed, seconds, trace, wall, control, fault = arg
    from sound_event_detection_dcase2017_task4_torch import parallel

    common.steady_host()
    mesh = parallel.make_mesh(device)
    t_start = time.perf_counter() - (time.time() - wall)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        result, readings, tracer = _run(c, seed, seconds, trace, device, t_start, control,
                                        mesh)
    return result, readings, tracer.trace, common.forbidden_loaded()


# what ``parallel.launch`` runs in each rank of a multi-chip cell
RANK_TARGET = "benchmark.harness.train_cell:rank_run"


def _run(c, seed, seconds, trace, device, t_start, control=None, mesh=None):
    import torch.distributed as td

    conf, traffic = c["config"], c["traffic"]
    tr = conf["train"]
    chips = c["workload"]["chips"]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    dist = None if mesh is None else ref_model.Ranks()
    # the ranks stop together: rank 0's clock, sent over a host group
    stop_group = None if mesh is None else td.new_group(backend="gloo")
    phases = {}

    def mark(phase):                 # seconds since run.py began
        phases[phase] = time.perf_counter() - t_start

    mark("cell")
    weights = inputs.make_weights(conf["model"], seed, device)
    sut = (PortTrainer(conf, weights, seed, device, mesh, mark) if control is None
           else ReferenceTrainer(conf, weights, seed, device, control, dist))
    sync()
    mark("step_built")
    names = [k for k in weights if not ref_model.is_statistic(k)]
    feed = inputs.Feed(seed, tr["bank_clips"], tr["batch"] * chips,
                       conf["model"]["classes"], traffic["label_density"])

    checked = [feed.next() for _ in range(traffic["checked_steps"])]
    losses, first = [], None
    for s, (idx, y) in enumerate(checked):
        losses.append(sut.step(idx, y))
        if s == 0:
            first = sut.first_grad(names)
            sync()
            mark("first_step")
    got = {"loss": torch.stack(losses).tolist(),
           "grad": dict(zip(names, first.tolist())),
           "change": dict(zip(names, sut.change(weights, names).tolist()))}
    sync()
    setup_s = time.perf_counter() - t_start
    mark("checked_steps")

    tracer = Tracer(trace)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    steps, rows = 0, []
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            idx, y = feed.next()
            with tracer.span("bench.step"):
                loss = sut.step(idx, y)
            bad += (~torch.isfinite(loss)).long()
            steps += 1
            rows.append(len(np.unique(rank_rows(idx, dist)[0])))
            done = torch.tensor([int(time.perf_counter() - t0 >= seconds)])
            if stop_group is not None:
                td.broadcast(done, 0, group=stop_group)
            if done.item():
                break
        sync()
        window_s = time.perf_counter() - t0
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(device) if sync is torch.cuda.synchronize else 0

    del sut, loss
    gc.collect()
    if sync is torch.cuda.synchronize:
        torch.cuda.empty_cache()
    with common.float32_exact():
        rows_of = [rank_rows(i, dist) for i, _ in checked]
        waves = [inputs.bank_waves(seed, own, conf["frontend"], device) for own, _ in rows_of]
        partners = (None if dist is None else
                    [inputs.bank_waves(seed, q, conf["frontend"], device) for _, q in rows_of])
        mixup = np.random.default_rng(seed + 1)
        lams = [mixup.beta(tr["mixup_alpha"], tr["mixup_alpha"], len(i)) for i, _ in checked]
        ref = ref_train.follow(conf["model"], conf["frontend"], norm_of(conf), weights,
                               waves, [y for _, y in checked], lams, seed + 1,
                               tr["learning_rate"], partners=partners, dist=dist)
    readings = compare(got, ref)
    readings["nonfinite_steps"] = failed

    batch = tr["batch"] * chips
    result = {"attempted": steps, "failed": failed,
              "e2e": {"train_clips_per_s": steps * batch / window_s,
                      "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
              "peak_bytes": peak,
              "work": {"kind": "train", "steps": steps, "batch": batch, "rows": rows,
                       "window_s": window_s},
              "extra": {"setup_phases_s": phases}}
    return result, readings, tracer
