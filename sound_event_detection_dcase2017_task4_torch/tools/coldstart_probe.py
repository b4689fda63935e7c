"""Where a fresh process's time goes before its first train steps.

Counterpart of the repository's ``tools/coldstart_probe.py``. Each cell runs
in a fresh process (a :func:`tools.run_cli` child) and times its phases
apart:

* ``import_s`` — interpreter start to torch and the port imported;
* ``device_s`` — the first CUDA context and allocation;
* ``kernel_build_s`` — the kernel cells' ``ops.logmel_cuda.build()``: nvcc
  and the load in a cold cell, the load of the library an earlier process
  built in a warm one (``None`` in the plain cells);
* ``build_s`` — model, train state and frontend;
* ``first_step_s`` — the first train step, read back (cuDNN's first-call
  setup);
* ``second_step_s`` — the next step, for reference.

Cells: {warm, cold} × {kernel, plain}. The step is the bench step's model
(``Cnn_9layers_Gru_FrameAtt``, bf16, batch 128, mean −30 / std 15) fed
float waveforms from the host: the waveform kernel in the kernel cells,
the plain PyTorch frontend in the plain cells (the route ``--no_pallas``
takes, ``main._frontends``). "Cold" points ``ops.logmel_cuda.BUILD_DIR`` at
a new temporary directory before the first use, so the kernel is built
with nvcc in the cell; "warm" uses the package's build directory, where
the parent built the library first.

Usage (one JSON line per cell, with the card's name and power limit)::

    python -m sound_event_detection_dcase2017_task4_torch.tools.coldstart_probe
    python -m sound_event_detection_dcase2017_task4_torch.tools.coldstart_probe --cell warm_kernel
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from . import check_child, device_info, on_card, run_cli

CELLS = ("warm_kernel", "warm_plain", "cold_kernel", "cold_plain")
MODEL_TYPE = "Cnn_9layers_Gru_FrameAtt"
BATCH = 128


def run_cell(cell: str, device=None, batch: int = BATCH) -> dict:
    """Child body: one fresh-process measurement (in a :func:`run_cli`
    child, whose start time ``import_s`` counts from)."""
    from .. import tools

    t_start = tools.CHILD_T0 if tools.CHILD_T0 is not None else time.perf_counter()
    import torch

    from .. import train
    from ..config import DEFAULT as cfg
    from ..main import _frontends
    from ..models import get_model
    from ..ops import logmel_cuda
    import_s = time.perf_counter() - t_start

    dev = resolve_device(device)
    kernel = cell.endswith("kernel")
    if kernel and dev.type != "cuda":
        raise ValueError(f"{cell} runs the CUDA kernel: it needs the card")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_s = time.perf_counter() - t0

    cold_dir = None
    if cell.startswith("cold"):
        cold_dir = Path(tempfile.mkdtemp(prefix="sedx_coldbuild_"))
        logmel_cuda.BUILD_DIR = cold_dir
    try:
        kernel_build_s = None
        if kernel:
            t0 = time.perf_counter()
            logmel_cuda.build()
            kernel_build_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        model = get_model(MODEL_TYPE, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
        frontend = _frontends(cfg, no_pallas=not kernel, wave_scale=None)[0]
        state = train.create_train_state(model, cfg, device=dev)
        scalar = (np.full(cfg.mel_bins, -30.0, np.float32),
                  np.full(cfg.mel_bins, 15.0, np.float32))
        step = train.make_train_step(model, state, frontend=frontend,
                                     scalar=scalar)
        rng = np.random.RandomState(0)
        xb = torch.from_numpy((rng.randn(batch, cfg.clip_samples) * 0.1
                               ).astype(np.float32)).to(dev)
        yb = torch.from_numpy((rng.rand(batch, 17) < 0.2
                               ).astype(np.float32)).to(dev)
        build_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        float(step(xb, yb)["loss"])
        first_step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(step(xb, yb)["loss"])
        second_step_s = time.perf_counter() - t0
    finally:
        if cold_dir is not None:
            shutil.rmtree(cold_dir, ignore_errors=True)
    return {"cell": cell, **device_info(dev), "import_s": import_s,
            "device_s": device_s, "kernel_build_s": kernel_build_s,
            "build_s": build_s, "first_step_s": first_step_s,
            "second_step_s": second_step_s}


def main(argv=None, device=None) -> list:
    """Run the cells (or, with ``--child``, be one); returns the records."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--cell", choices=CELLS)
    p.add_argument("--child", choices=CELLS, help=argparse.SUPPRESS)
    p.add_argument("--batch", type=int, default=BATCH,
                   help="train batch of the probed step")
    args = p.parse_args(argv)

    if args.child:
        rec = run_cell(args.child, device, args.batch)
        print(json.dumps(rec), flush=True)
        return [rec]

    resolve_device(device)                   # no card: raise here
    cells = [args.cell] if args.cell else list(CELLS)
    if on_card(device) and "warm_kernel" in cells:
        from ..ops import logmel_cuda

        logmel_cuda.build()                  # what "warm" finds built
    records = []
    for cell in cells:
        t0 = time.perf_counter()
        rc, out = run_cli("tools.coldstart_probe",
                          ["--child", cell, f"--batch={args.batch}"],
                          device, echo=False,
                          allow_plain=cell.endswith("plain"))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cell {cell} failed (rc={rc}):\n{out[-2000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith('{"cell"')]
        rec = json.loads(lines[-1])
        rec["process_wall_s"] = wall
        rec["launches"] = launches = check_child(
            out, device, cell, allow_plain=cell.endswith("plain"))
        # two steps: two waveform launches, or two plain frontend calls
        want = ({"logmel": 0, "plain": 2} if cell.endswith("plain")
                else {"logmel": 2, "plain": 0})
        got = {"logmel": launches["logmel"] + launches["logmel_bank"],
               "plain": launches["plain"]["logmel"]}
        if got != want:
            raise RuntimeError(f"cell {cell}: frontend calls {got}, "
                               f"expected {want}")
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
