"""Pytest start-up for the whole tree: build the JAX package's native
library once, before any test process starts.

``sound_event_detection_dcase2017_task4_tpu/native.py`` builds
``libsedx_native.so`` with ``make`` at first use, straight onto its final
path, and a process that fails to load it skips the native tests for good.
Under ``pytest -n N`` every worker imports ``tests/test_native.py`` while it
collects, so all of them would run that build at once, and a worker could
load a library that another worker's compiler is still writing. Here the
controller (or the one process of a run without xdist) builds it first: the
same Makefile, flags and output file, into a temporary name in the package
directory, then moved onto the final path. Every worker then finds the
whole library.

It imports nothing of either package. When the library is there already,
or ``make`` or the compiler fails, it does nothing, and the loader behaves
as it does without this file. A run with ``--noconftest`` skips it.
"""

import os
import subprocess
import tempfile

_REPO = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.join(_REPO, "sound_event_detection_dcase2017_task4_tpu")
_LIB = os.path.join(_PKG, "libsedx_native.so")
_SRC = os.path.join(_REPO, "native")


def pytest_configure(config):
    if (hasattr(config, "workerinput") or os.path.isfile(_LIB)
            or not os.path.isfile(os.path.join(_SRC, "Makefile"))):
        return
    fd, tmp = tempfile.mkstemp(prefix=".libsedx_native.", suffix=".so", dir=_PKG)
    os.close(fd)
    try:
        subprocess.run(["make", "-s", "-B", f"OUT={tmp}"], cwd=_SRC, check=True,
                       capture_output=True, timeout=300)
        os.chmod(tmp, 0o755)             # mkstemp's 0600, as make leaves it
        os.replace(tmp, _LIB)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
