"""What every cell shares: finding a cell's files by name, the process's
environment, the precision guard of the reference, and the result line."""

from __future__ import annotations

import contextlib
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# whole top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax",
                     "sound_event_detection_dcase2017_task4_tpu")


def set_cache_dirs(environ=os.environ) -> None:
    """Keep every kernel and build cache at a fixed path inside the
    checkout (the port's nvcc library already lives in its ``_build/``),
    and keep libraries that could load JAX from doing so."""
    cache = os.path.join(BENCH_DIR, "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        environ[var] = os.path.join(cache, sub)
    environ["USE_FLAX"] = "0"
    environ["USE_JAX"] = "0"


def steady_host() -> None:
    """One process with few threads: the intra-op pool at one thread (the
    timed paths run no CPU operator worth a second one)."""
    import torch

    torch.set_num_threads(1)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration, its
    traffic mix, its limits and the names of the metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(by_name)}")
    w = by_name[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(files(w["config"], w["traffic"], workload, root, conf["file"]),
                workload=w, end_to_end=reported(bench["end_to_end"]),
                per_layer=reported(bench["per_layer"]))


def files(config: str, traffic: str, workload: str, root: str = ROOT,
          config_file: str | None = None) -> dict:
    """A cell's configuration, traffic mix and limits, by their names."""
    return {"config": load_json(root, config_file or f"benchmark/configs/{config}.json"),
            "traffic": load_json(BENCH_DIR, "traffic", traffic + ".json"),
            "limits": load_json(BENCH_DIR, "limits", workload + ".json"),
            "workload": {"name": workload, "config": config, "traffic": traffic, "chips": 1}}


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names present in ``modules`` (by default
    ``sys.modules``), compared whole: the port's name begins with the JAX
    package's, and is no match."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN_MODULES))


@contextlib.contextmanager
def float32_exact():
    """Turn TF32 off for the reference's products and convolutions, and put
    the process's flags back afterwards, so that the timed path keeps the
    defaults it runs with."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct when none is over.
    A reading that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """Print the numbers compared as the last lines of standard error and
    the result as the last line of standard output, ``checks`` last."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(dict(result, checks=checks)), flush=True)
