"""The port's surface against the JAX package's.

For every module of ``sound_event_detection_dcase2017_task4_tpu`` the port
has a module of the same dotted name, and that module has every public
name of the JAX one: the names in its ``__all__`` and the functions,
classes and assignments at its top level whose names do not start with an
underscore (read from the source, so a name a module imports is not its
own). Only the documented exceptions are allowed (ROADMAP §A):

* ``runtime.py`` gets no counterpart;
* ``parallel.DATA_AXIS``, ``batch_sharding`` and ``replicated_sharding``
  get no counterpart;
* ``ops/pallas_logmel`` → ``ops/logmel_cuda``;
* ``sed.binarize_jax`` → ``sed.binarize_torch``;
* ``blocks.avg_pool_2d``, which is inlined.

Each exception is checked to be one still: a name listed here that the
port gained, or a JAX name it no longer names, fails. The ``main``,
``features`` and ``plot_results`` CLIs of both packages take the same
``add_argument`` flags, subcommand by subcommand.
"""

import argparse
import ast
import importlib
import inspect
import pkgutil

import pytest

JAX = "sound_event_detection_dcase2017_task4_tpu"
PORT = "sound_event_detection_dcase2017_task4_torch"

# modules with no counterpart, and modules ported under another name
NO_MODULE = {"runtime"}
RENAMED = {"ops.pallas_logmel": "ops.logmel_cuda"}
# (module, JAX name) → the port's name, or None for no counterpart
NAMES = {
    ("parallel", "batch_sharding"): None,
    ("parallel", "replicated_sharding"): None,
    ("parallel.mesh", "DATA_AXIS"): None,
    ("parallel.mesh", "batch_sharding"): None,
    ("parallel.mesh", "replicated_sharding"): None,
    ("sed", "binarize_jax"): "binarize_torch",
    ("models.blocks", "avg_pool_2d"): None,        # inlined
}
CLIS = ("main", "features", "plot_results")


def _modules(package: str) -> list:
    """Dotted names (relative to ``package``) of its Python modules."""
    pkg = importlib.import_module(package)
    names = [""]
    for info in pkgutil.walk_packages(pkg.__path__, package + "."):
        spec = importlib.util.find_spec(info.name)
        if spec.origin and spec.origin.endswith(".py"):
            names.append(info.name[len(package) + 1:])
    return sorted(names)


def _module(package: str, name: str):
    return importlib.import_module(f"{package}.{name}" if name else package)


def _public(mod) -> set:
    names = set(getattr(mod, "__all__", ()))
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = _modules(JAX)


def test_the_jax_package_is_walked_whole():
    assert {"", "main", "features", "train", "serving", "models.zoo",
            "ops.pallas_logmel", "parallel.mesh", "runtime"} <= set(JAX_MODULES)
    assert len(JAX_MODULES) >= 30


@pytest.mark.parametrize("name", JAX_MODULES, ids=lambda n: n or "package")
def test_the_port_has_the_module_and_its_public_names(name):
    if name in NO_MODULE:
        assert importlib.util.find_spec(f"{PORT}.{name}") is None
        return
    jmod = _module(JAX, name)
    port = _module(PORT, RENAMED.get(name, name))
    if name in RENAMED:
        assert importlib.util.find_spec(f"{PORT}.{name}") is None
        return
    missing = []
    for public in sorted(_public(jmod)):
        if (name, public) in NAMES:
            other = NAMES[name, public]
            assert not hasattr(port, public), (name, public, "is no exception now")
            assert other is None or hasattr(port, other), (name, other)
            continue
        if not hasattr(port, public):
            missing.append(public)
    assert missing == [], f"{PORT}.{name} lacks {missing}"


def test_every_listed_exception_names_the_jax_package():
    for name in NO_MODULE | set(RENAMED):
        assert name in JAX_MODULES, name
    for name, public in NAMES:
        assert public in _public(_module(JAX, name)), (name, public)


def _flags(module) -> dict:
    """``{subcommand (or ""): sorted option strings}`` of a CLI's parser,
    caught at its ``parse_args``."""
    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as e:
            module.main([])
    parser = e.value.args[0]

    def options(p):
        return sorted(s for a in p._actions for s in a.option_strings)

    out = {"": options(parser)}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            out.update({sub: options(p) for sub, p in action.choices.items()})
    return out


@pytest.mark.parametrize("cli", CLIS)
def test_the_clis_take_the_same_flags(cli):
    want = _flags(_module(JAX, cli))
    got = _flags(_module(PORT, cli))
    assert got == want
    assert sum(map(len, want.values())) > 2
