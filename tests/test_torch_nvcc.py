"""The one loader of the port's hand-written CUDA libraries
(``ops/nvcc.py:Library``), on the CPU: ``nvcc.build_library`` is replaced
by a fake library whose entries record their declarations and return
what a test gives them.

Each of ``ops.logmel_cuda``, ``ops.bn_act``, ``ops.window_attention`` and
``ops.selective_scan`` declares every exported entry of its ``.cu`` source with the source's
argument and return types, builds once under concurrent first calls, and
turns a non-zero code into ``RuntimeError`` with the library's own
message; a library whose block constants do not match ``logmel_cuda``'s
is refused, by name.
"""

import ctypes
import hashlib
import importlib
import inspect
import re
import sys
import threading
import time

import pytest
import torch

from sound_event_detection_dcase2017_task4_torch.ops import nvcc

OPS = "sound_event_detection_dcase2017_task4_torch.ops"
MODULES = ("logmel_cuda", "bn_act", "window_attention", "selective_scan")
LOGMEL_CONSTS = {"sedx_logmel_frames_per_block": 16,
                 "sedx_logmel_threads_per_frame": 64,
                 "sedx_logmel_frames_in_flight": 4}


class _Entry:
    def __init__(self, results: dict, name: str):
        self.results, self.name = results, name
        self.argtypes, self.restype, self.calls = None, None, []

    def __call__(self, *args):
        self.calls.append(args)
        result = self.results.get(self.name, 0)
        return result(*args) if callable(result) else result


class _FakeLib:
    """A ``ctypes.CDLL`` stand-in: entry ``name`` returns ``results[name]``
    (called with the arguments when callable), 0 when not given."""

    def __init__(self, results: dict):
        self._name = "/nowhere/libfake_0123.so"
        self.results, self.entries = results, {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name not in self.entries:
            self.entries[name] = _Entry(self.results, name)
        return self.entries[name]


def _kind(t):
    """A ctypes type as a C parameter takes it: pointers as ``"pointer"``
    (an address, ``c_void_p``, or a ctypes array)."""
    return "pointer" if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer) else t


def _ctype(decl: str):
    decl = re.sub(r"\s*\w+$", "", decl.strip())          # drop the name
    if decl == "const char*":
        return ctypes.c_char_p
    if decl.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[decl]


def _exports(source) -> dict:
    """``{entry: (restype, argtypes)}`` of the ``.cu``'s exported functions."""
    return {m.group(2): (_ctype(m.group(1) + " x"),
                         [_ctype(p) for p in m.group(3).split(",") if p.strip()])
            for m in re.finditer(r"^(int|const char\*) (sedx_\w+)\(([^)]*)\)\s*\{",
                                 source.read_text(), re.M)}


@pytest.fixture
def fake(monkeypatch):
    """``fake(module, results)``: the module's library unloaded (restored
    after the test) and built from a :class:`_FakeLib`; returns the
    module, its library, the fake and the list of builds."""
    def make(name, results=None, delay=0.0):
        mod = importlib.import_module(f"{OPS}.{name}")
        lib = _FakeLib({**LOGMEL_CONSTS, **(results or {})})
        builds = []

        def build_library(source, stem):
            builds.append((source, stem))
            time.sleep(delay)
            return lib, f"ptxas info: {stem}"

        monkeypatch.setattr(mod.LIBRARY, "_lib", None)
        monkeypatch.setattr(mod.LIBRARY, "log", None)
        monkeypatch.setattr(nvcc, "build_library", build_library)
        return mod, mod.LIBRARY, lib, builds
    return make


@pytest.mark.parametrize("name", MODULES)
def test_a_library_declares_its_entries_and_builds_once(fake, name):
    mod, library, lib, builds = fake(name, delay=0.05)
    start = threading.Barrier(8)
    got = []

    def first_call():
        start.wait()
        got.append(library.load())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is lib for g in got)
    assert builds == [(mod.SOURCE, library.stem)]
    assert library.log == f"ptxas info: {library.stem}"
    # the table is the source's exports, each declared on the library
    want = _exports(mod.SOURCE)
    assert set(library.entries) == set(want)
    for entry, (restype, argtypes) in want.items():
        declared = lib.entries[entry]
        assert declared.restype == restype, entry
        assert [_kind(t) for t in declared.argtypes] == [_kind(t) for t in argtypes], entry
    # and every entry the wrappers call is in it
    called = set(re.findall(r"\.(sedx_\w+)\(", inspect.getsource(mod)))
    assert called and called <= set(library.entries)
    assert library.load() is lib and len(builds) == 1


@pytest.mark.parametrize("name", MODULES)
def test_a_nonzero_code_raises_with_the_librarys_message(fake, name):
    mod, library, lib, _ = fake(name)
    errors = library.errors
    lib.results[errors] = lambda rc: f"the {name} library's text for {rc}".encode()
    library.load()
    err = library.error(700, "an entry")
    assert isinstance(err, RuntimeError)
    assert str(err) == f"an entry failed: the {name} library's text for 700 (700)"
    x = torch.zeros(2, 3, 4, 4)
    if name == "bn_act":
        with pytest.raises(RuntimeError, match=r"^bn_act sedx_bn_apply failed: "
                           r"the bn_act library's text for 3 \(3\)$"):
            mod._check(3, x, 1, "sedx_bn_apply")
        with pytest.raises(RuntimeError, match="text for -1"):
            mod._check(-1, x, 0, "sedx_bn_partials")
        with pytest.raises(ValueError, match="int unit index"):
            mod._check(mod._ERR_UNITS, x, 1, "sedx_bn_apply")
        assert mod._check(5, x, 0, "sedx_bn_partials") == 5
    elif name == "window_attention":
        lib.results["sedx_wa_partials"] = -700       # a CUDA error, negated
        with pytest.raises(RuntimeError, match=r"^window attention partials "
                           r"failed: the window_attention library's text for "
                           r"700 \(700\)$"):
            mod._partials(3, 5, 7, 11, 13, 1)
    assert lib.entries[errors].calls[0] == (700,)


def test_logmel_refuses_a_library_of_other_block_constants_by_name(fake):
    mod, library, lib, builds = fake(
        "logmel_cuda", {"sedx_logmel_threads_per_frame": 32})
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match=r"^libfake_0123\.so: block constants "
                           r"\(16, 32, 4\) do not match ops/logmel_cuda\.py$"):
            library.load()
        assert library._lib is None and library.log is None
        assert len(builds) == attempt


def test_build_reads_the_one_build_directory_and_flags(monkeypatch, tmp_path):
    """``build_library`` reads ``nvcc.BUILD_DIR`` and ``nvcc.FLAGS`` when it
    runs: a library built before under those is loaded from there."""
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "FLAGS", ("-O3",))
    loaded = []
    monkeypatch.setattr(ctypes, "CDLL", lambda path: loaded.append(path) or path)
    tag = hashlib.sha256(b"// a kernel\n" + b"-O3").hexdigest()[:16]
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / f"libk_{tag}.so").write_bytes(b"")
    lib, log = nvcc.build_library(source, "k")
    assert loaded == [str(tmp_path / "build" / f"libk_{tag}.so")] and lib == loaded[0]
    assert log == "(loaded a library built earlier)"
