"""The port's tools: one module for each script of the repository's
``tools/`` (the JAX package's), under the same name.

    python -m sound_event_detection_dcase2017_task4_torch.tools.<name> --help

Each tool's ``main(argv=None, device=None)`` runs on the CUDA card unless
it is given ``device="cpu"``; without a card it raises (``parity_check``
also takes ``--device``, in place of the JAX tool's ``--platform``). Tools that run the CLI run each subcommand in a child process
(:func:`run_cli`): ``python -c`` calls the module's ``main(argv,
device=...)`` there, so the CLI keeps the JAX CLI's flag set. The child
prints, as its last line, ``CHILD_TAG`` and a JSON object with the kernel
launch counters of ``ops.logmel_cuda`` (``logmel``: the waveform entry,
``logmel_bank``: the bank entry), the calls of ``ops.stft``'s plain
frontends (``plain``) and the whole counter registry of the port's
``trace`` module they are read from (``counters``), so that the parent can
count the work done in children and see that nothing fell back.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

__all__ = ["CHILD_TAG", "check_child", "child_command", "child_report",
           "device_info", "on_card", "run_cli", "run_sampled"]

#: Prefix of the last line a :func:`run_cli` child prints.
CHILD_TAG = "SEDX_CHILD "
#: The directory that holds the port's package (a checkout's root).
ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "sound_event_detection_dcase2017_task4_torch"

_CHILD_CODE = (
    "import time; T0 = time.perf_counter()\n"
    f"from {PACKAGE}.tools import _child\n"
    "_child({spec!r}, T0)\n")

#: In a :func:`run_cli` child: ``time.perf_counter()`` before its first
#: import (``coldstart_probe`` times the imports from it).
CHILD_T0: float | None = None


def device_info(device) -> dict:
    """``{"device": name, "power_limit": watts}`` of the card ``device``
    (torch's name, ``nvidia-smi``'s power limit), or the CPU's
    ``{"device": "cpu", "power_limit": None}``: every time a tool prints
    carries the hardware it ran on."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": dev.type, "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    _, limit = smi.stdout.strip().rsplit(",", 1)
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit": limit.strip()}


def child_command(module: str, argv, device=None) -> list:
    """The command line of a child that runs ``module.main(argv,
    device=device)`` (``module`` relative to the package, e.g. ``"main"``
    or ``"tools.hard_benchmark"``)."""
    spec = json.dumps({"module": f"{PACKAGE}.{module}", "argv": list(argv),
                       "device": None if device is None else str(device)})
    return [sys.executable, "-c", _CHILD_CODE.format(spec=spec)]


def run_sampled(cmd, echo: bool = True) -> tuple:
    """Run ``cmd`` from :data:`ROOT` with the package importable; returns
    ``(rc, peak_rss_bytes, output)``, the child's resident set size read
    from ``/proc/<pid>/status`` once a second and its standard output and
    error merged (echoed as they come when ``echo``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    peak = 0
    lines: list = []

    def sample():
        nonlocal peak
        while proc.poll() is None:
            try:
                with open(f"/proc/{proc.pid}/status") as f:
                    for ln in f:
                        if ln.startswith("VmRSS:"):
                            peak = max(peak, int(ln.split()[1]) * 1024)
                            break
            except OSError:
                return
            time.sleep(1.0)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    for ln in proc.stdout:
        lines.append(ln)
        if echo:
            print(ln, end="", flush=True)
    rc = proc.wait()
    sampler.join(timeout=2)
    return rc, peak, "".join(lines)


def on_card(device) -> bool:
    """Whether ``device`` (``None`` is the card) names a CUDA device."""
    return device is None or str(device).startswith("cuda")


def run_cli(module: str, argv, device=None, echo: bool = True,
            allow_plain: bool = False) -> tuple:
    """Run ``module.main(argv, device=device)`` in a child process;
    returns ``(rc, output)``. A child that ends well is held to
    :func:`check_child`."""
    rc, _, out = run_sampled(child_command(module, argv, device), echo=echo)
    if rc == 0:
        check_child(out, device, f"{module} {' '.join(argv)}", allow_plain)
    return rc, out


def child_report(output: str) -> dict:
    """The counters a :func:`run_cli` child printed on its last line:
    ``{"logmel": n, "logmel_bank": n, "plain": {"logmel": n,
    "logmel_bank": n}, "counters": {name: n}}``. Raises when the child
    printed none."""
    for line in reversed(output.splitlines()):
        if line.startswith(CHILD_TAG):
            return json.loads(line[len(CHILD_TAG):])
    raise RuntimeError("the child printed no counters (it died before its "
                       "end?): " + output[-500:])


def check_child(output: str, device, what: str,
                allow_plain: bool = False) -> dict:
    """:func:`child_report` of ``output``; on the card it raises when the
    child ran a plain frontend, unless ``allow_plain``: there the kernels
    do that work and nothing falls back."""
    report = child_report(output)
    if on_card(device) and not allow_plain and any(report["plain"].values()):
        raise RuntimeError(f"the plain frontend ran on the card in {what}: "
                           f"{report['plain']}")
    return report


def _child(spec: str, t0: float) -> None:
    """Body of a :func:`run_cli` child (see the module docstring)."""
    global CHILD_T0
    CHILD_T0 = t0
    import importlib
    import traceback

    from .. import trace

    spec = json.loads(spec)
    rc = 0
    try:
        importlib.import_module(spec["module"]).main(spec["argv"],
                                                     device=spec["device"])
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            rc = e.code or 0
        else:
            print(e.code, file=sys.stderr)
            rc = 1
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    got = trace.counters()
    print(CHILD_TAG + json.dumps({
        "logmel": got.get("ops.logmel.launches", 0),
        "logmel_bank": got.get("ops.logmel_bank.launches", 0),
        "plain": {k: got.get(f"ops.stft.{k}.calls", 0)
                  for k in ("logmel", "logmel_bank")},
        "counters": got}), flush=True)
    sys.exit(rc)
