"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The cell's configuration, traffic mix, limits and per-layer readers are
found by name under ``benchmark/``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
window. The last line of standard output is the result; the numbers
compared to decide ``correct`` are also the last lines of standard error.
Exits non-zero, printing no result, without enough CUDA cards, or when a
JAX module is loaded at the end, in this process or in a rank it started.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402


def read_per_layer(c: dict, result: dict, trace, chips: int) -> dict:
    ctx = types.SimpleNamespace(trace=trace, work=result["work"], conf=c["config"],
                                chips=chips)
    out = {}
    for m in c["per_layer"]:
        path = os.path.join(common.BENCH_DIR, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + m["name"].replace(".", "_"), path)
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_dirs()
    c = common.cell(args.workload)
    chips = c["workload"]["chips"]
    import torch

    t_torch = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    common.steady_host()
    cell = importlib.import_module(f"benchmark.harness.{c['traffic']['kind']}_cell")
    result, readings, tracer = cell.run(c, args.seed, args.seconds, bool(args.trace),
                                        "cuda", T_START)
    ok, checks = common.judge(readings, c["limits"])
    out = {"correct": ok and result["failed"] == 0,
           "attempted": result["attempted"], "failed": result["failed"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result["peak_bytes"]}
    if args.trace:
        tr = tracer.trace
        out["metrics"] = read_per_layer(c, result, tr, chips)
        device.update(busy_s=result.get("busy_s", tr.busy_s()), window_s=tr.window_s)
        out["device"] = device
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in c["end_to_end"]}
        out["metrics"] = {k: {"value": v, "unit": units[k]}
                          for k, v in result["e2e"].items() if k in units}
        out["device"] = device
    print(f"[{args.workload}] seed {args.seed} window {result['work']['window_s']:.3f} s "
          f"torch_imported {t_torch:.3f} s {result.get('extra', {})}", file=sys.stderr)
    bad = sorted(set(common.forbidden_loaded()) | set(result.get("forbidden", ())))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(out, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
