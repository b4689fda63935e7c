"""Checkpoint save/restore with deterministic resume, and JAX checkpoints.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/checkpoints.py``.
A checkpoint is ``<directory>/<iteration>_iterations.pth`` (the original
reference's name), one ``torch.save`` dict of everything a run carries from
step to step (:class:`train.TrainState`): the model's ``state_dict``
(parameters and BatchNorm running statistics), the optimizer's and the
scheduler's ``state_dict``, the dropout generator's state, the mixup
generator's ``bit_generator.state`` and the step. Restoring it resumes bit
for bit, augmentation streams included. Beside it, the ``.optjson`` sidecar
records the resolved optimizer recipe and ``main`` writes the data-stream
position to ``.datastate.pkl``; every file is written to a temporary name
and moved into place, so a reader never sees a torn file.

:func:`import_jax_checkpoint` reads a JAX package ``.ckpt`` (flax msgpack)
through a small msgpack decoder of the port's own — no ``msgpack`` package —
and carries its ``params`` and ``batch_stats`` into a port model. So a run
directory the JAX CLI trained can be inferred and served:
:func:`find_checkpoint` and :func:`latest_checkpoint` see both suffixes
(``.pth`` wins at equal iterations), :func:`load_model` reads either, and
the ``.optjson`` sidecar of either is ``<iteration>_iterations.optjson``.
:func:`import_jax_train_state` carries the whole training state of a
``.ckpt`` into a port :class:`train.TrainState` — variables, optax's Adam
moments and counts, the warmup schedule's count, the step and a seed for
the generators from the PRNG key — so ``main train --resume_iteration``
continues a run the JAX CLI trained. The port writes no ``.ckpt``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_model",
           "find_checkpoint", "latest_checkpoint", "load_opt_config",
           "check_opt_config", "prune_checkpoints", "state_dict",
           "msgpack_restore", "import_jax_checkpoint",
           "import_jax_train_state"]

_FNAME = "{iteration}_iterations.pth"
_RE = re.compile(r"^(\d+)_iterations\.pth$")
# the port's own suffix first: it wins at equal iterations
_SUFFIXES = (".pth", ".ckpt")
_ANY_RE = re.compile(r"^(\d+)_iterations(\.pth|\.ckpt)$")


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def state_dict(state) -> dict:
    """Everything of ``state`` (a :class:`train.TrainState`) that a resumed
    run needs, every tensor a CPU copy (a snapshot: the run goes on
    updating its own tensors in place)."""
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    return {"model": cpu(state.model.state_dict()),
            "optimizer": cpu(state.optimizer.state_dict()),
            "scheduler": (None if state.scheduler is None
                          else state.scheduler.state_dict()),
            "dropout_generator": state.dropout_generator.get_state(),
            "mixup_rng": state.mixup_rng.bit_generator.state,
            "step": int(state.step)}


def save_checkpoint(directory: str, state, iteration: int | None = None,
                    opt_config: dict | None = None) -> str:
    """Write ``state`` to ``<directory>/<iteration>_iterations.pth``
    (``iteration`` defaults to ``state.step``) and, with ``opt_config`` (the
    resolved optimizer recipe, ``train.resolve_opt_config``), the
    ``.optjson`` sidecar that eval subcommands and serving adopt."""
    if iteration is None:
        iteration = int(state.step)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _FNAME.format(iteration=iteration))
    blob = state_dict(state)
    _atomic_write(path, lambda f: torch.save(blob, f))
    if opt_config is not None:
        _atomic_write(_sidecar_path(path),
                      lambda f: f.write(json.dumps(opt_config).encode()))
    return path


def _sidecar_path(ckpt_path: str) -> str:
    for suffix in _SUFFIXES:
        if ckpt_path.endswith(suffix):
            return ckpt_path[: -len(suffix)] + ".optjson"
    return ckpt_path + ".optjson"


def load_opt_config(ckpt_path: str) -> dict | None:
    """The ``.optjson`` optimizer recipe saved next to ``ckpt_path`` (None
    when there is no sidecar)."""
    side = _sidecar_path(ckpt_path)
    if not os.path.isfile(side):
        return None
    with open(side) as f:
        return json.load(f)


# keys whose value changes the optimizer's structure (a warmup scheduler, a
# clip stage); learning_rate only warns
_STRUCTURAL_KEYS = ("warmup_steps", "grad_clip")


def check_opt_config(ckpt_path: str, expected: dict) -> None:
    """Raise if the checkpoint's recorded optimizer recipe disagrees with
    ``expected`` on a structural key; warn on other differences."""
    saved = load_opt_config(ckpt_path)
    if saved is None:
        return                                  # no sidecar: trust caller
    diffs = {k: (saved.get(k), expected.get(k))
             for k in _STRUCTURAL_KEYS
             if saved.get(k) != expected.get(k)}
    if diffs:
        raise ValueError(
            f"optimizer config mismatch for {ckpt_path}: the checkpoint "
            f"was written with {saved} but this run resolved {expected} "
            f"(differing structural keys: {diffs}). Re-run with matching "
            "--warmup_steps/--grad_clip, or drop the flags to auto-adopt "
            "the checkpoint's recorded recipe.")
    soft = {k: (saved[k], expected[k]) for k in saved
            if k not in _STRUCTURAL_KEYS and k in expected
            and saved[k] != expected[k]}
    if soft:
        logging.getLogger(__name__).warning(
            "optimizer config differs non-structurally for %s: %s "
            "(checkpoint value, this run's value) — proceeding; the "
            "run's value wins", ckpt_path, soft)


def _load(path: str) -> dict:
    # onto the CPU: load_state_dict copies each tensor to its parameter's
    # device, and Adam's step counts stay on the host, as in a fresh
    # optimizer (the step reads them without a device round trip)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state, opt_config: dict | None = None):
    """Restore ``state`` (a :class:`train.TrainState` built with
    ``create_train_state`` on the same model and optimizer recipe) in place
    from ``path`` and return it. Passing the resolved ``opt_config``
    checks it against the checkpoint's sidecar first."""
    if opt_config is not None:
        check_opt_config(path, opt_config)
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if (state.scheduler is None) != (ckpt["scheduler"] is None):
        raise ValueError(f"{path}: the checkpoint's LR scheduler does not "
                         "match this run's (--warmup_steps)")
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.dropout_generator.set_state(ckpt["dropout_generator"])
    state.mixup_rng.bit_generator.state = ckpt["mixup_rng"]
    state.step = int(ckpt["step"])
    return state


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model`` (on any device) from the checkpoint's model state: a
    port ``.pth`` or a JAX package ``.ckpt``."""
    if path.endswith(".ckpt"):
        return import_jax_checkpoint(path, model)
    model.load_state_dict(_load(path)["model"])
    return model


def prune_checkpoints(directory: str, keep: int,
                      protect: tuple = ()) -> list[str]:
    """Delete all but the ``keep`` highest-iteration checkpoints (with their
    ``.optjson`` / ``.datastate.pkl`` sidecars). ``protect`` lists
    iterations never deleted (the best-mAP one, so ``--iteration best``
    keeps working); ``keep <= 0`` keeps everything. Returns the deleted
    checkpoint paths."""
    if keep <= 0 or not os.path.isdir(directory):
        return []
    its = sorted(int(m.group(1)) for name in os.listdir(directory)
                 if (m := _RE.match(name)))
    victims = [i for i in its[:-keep] if i not in set(protect)]
    deleted = []
    for i in victims:
        base = os.path.join(directory, _FNAME.format(iteration=i))
        for path in (base, _sidecar_path(base),
                     base.replace(".pth", ".datastate.pkl")):
            if os.path.isfile(path):
                os.unlink(path)
        deleted.append(base)
    return deleted


def find_checkpoint(directory: str, iteration: int | None = None) -> str | None:
    """The checkpoint of ``iteration`` in ``directory``:
    ``<iteration>_iterations.pth``, else the JAX package's
    ``<iteration>_iterations.ckpt``; with ``iteration=None`` the highest
    iteration over both suffixes (``.pth`` at equal iterations). None when
    there is no such file."""
    if iteration is not None:
        for suffix in _SUFFIXES:
            path = os.path.join(directory, f"{int(iteration)}_iterations{suffix}")
            if os.path.isfile(path):
                return path
        return None
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), -_SUFFIXES.index(m.group(2)), name)
             for name in os.listdir(directory) if (m := _ANY_RE.match(name))]
    return os.path.join(directory, max(found)[2]) if found else None


def latest_checkpoint(directory: str) -> str | None:
    """Highest-iteration checkpoint path in ``directory`` over both
    suffixes, ``.pth`` at equal iterations (or None)."""
    return find_checkpoint(directory)


# ---------------------------------------------------------------------------
# JAX checkpoints: flax msgpack
# ---------------------------------------------------------------------------

class _Unpacker:
    """Decode one msgpack value from ``data`` (maps, arrays, str, bin, ints,
    floats, nil, bool), with flax's ext types 1 (ndarray: ``(shape, dtype
    name, bytes)``) and 3 (numpy scalar, the same payload)."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}           # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}           # str
        if b in sized:
            return self._str(self.unpack(sized[b]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.value()
                    for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack("H" if b == 0xDE else "I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code in (1, 3):                     # ndarray, numpy scalar
            shape, name, buf = _Unpacker(payload).value()
            if name == "bfloat16":
                raise ValueError("bfloat16 arrays in a flax checkpoint are "
                                 "not supported (numpy has no bfloat16)")
            arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
            return arr[()] if code == 3 else arr
        raise ValueError(f"msgpack ext type {code} is not supported")


def msgpack_restore(data: bytes):
    """The tree of a flax ``serialization.to_bytes`` blob: dicts, lists and
    numpy leaves, as ``flax.serialization.msgpack_restore`` gives it."""
    u = _Unpacker(data)
    tree = u.value()
    if u.pos != len(u.data):
        raise ValueError(f"{len(u.data) - u.pos} trailing bytes after the "
                         "msgpack value")

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("chunked flax arrays (leaves over 1 GiB) "
                                 "are not supported")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def import_jax_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model`` from a JAX package checkpoint (``<it>_iterations.ckpt``,
    a flax ``TrainState``): its ``params`` and ``batch_stats`` go through
    ``weights.load_jax_variables``, which raises on any key it does not
    consume. The rest of the training state is read by
    :func:`import_jax_train_state`."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return _import_variables(tree, model)


def _import_variables(tree: dict, model: torch.nn.Module) -> torch.nn.Module:
    from .weights import load_jax_variables

    return load_jax_variables(model, {"params": tree["params"],
                                      "batch_stats": tree.get("batch_stats", {})})


def _adam_layout(opt_state) -> tuple:
    """``(adam state, schedule state, warmup, clip)`` of the ``opt_state``
    of ``train.default_optimizer`` in the JAX package, in flax's
    state-dict form: ``optax.adam`` is ``{'0': adam, '1': schedule}``
    (the schedule ``{count}`` with warmup, ``{}`` without), and with
    clipping ``chain(clip_by_global_norm, adam)`` puts an empty clip state
    in front, ``{'0': {}, '1': <adam>}``."""
    clip = isinstance(opt_state, dict) and opt_state.get("0") == {}
    chain = opt_state.get("1") if clip else opt_state
    pair = isinstance(chain, dict) and set(chain) == {"0", "1"}
    adam, schedule = (chain["0"], chain["1"]) if pair else (None, None)
    if not (pair and isinstance(adam, dict)
            and set(adam) == {"count", "mu", "nu"}
            and isinstance(schedule, dict) and set(schedule) <= {"count"}):
        raise ValueError("the opt_state is not one of the JAX package's "
                         "default_optimizer layouts (adam, with or without a "
                         "warmup schedule, with or without clip_by_global_norm "
                         f"in front): {_outline(opt_state)}")
    return adam, schedule, bool(schedule), clip


def _outline(node):
    if isinstance(node, dict):
        return {k: _outline(v) for k, v in node.items()}
    return type(node).__name__


def _check_layout(path: str, recipe: dict, warmup: bool, clip: bool,
                  what: str) -> None:
    want = {"warmup_steps": bool(recipe.get("warmup_steps")),
            "grad_clip": bool(recipe.get("grad_clip"))}
    found = {"warmup_steps": warmup, "grad_clip": clip}
    if want != found:
        raise ValueError(
            f"optimizer layout mismatch for {path}: {what} {recipe} asks for "
            f"warmup {want['warmup_steps']} and clipping {want['grad_clip']}, "
            f"but the checkpoint's opt_state layout has warmup "
            f"{found['warmup_steps']} and clipping {found['grad_clip']}")


def import_jax_train_state(path: str, state, opt_config: dict | None = None):
    """Fill ``state`` (a :class:`train.TrainState` built by
    ``create_train_state`` for the same model and optimizer recipe) in
    place from a JAX package ``.ckpt`` and return it.

    * ``params`` and ``batch_stats`` as :func:`import_jax_checkpoint`;
    * optax Adam's ``mu`` and ``nu`` through ``weights.load_jax_moments``
      into each parameter's ``exp_avg`` and ``exp_avg_sq``, its ``count``
      into each parameter's ``step``;
    * the warmup schedule's ``count`` into the ``LambdaLR``, so the next
      step takes ``lr·min(count, n)/n`` as ``optax.linear_schedule`` does;
    * ``step`` into ``state.step``;
    * the PRNG key ``uint32[2] = (k0, k1)`` cannot go on as a torch
      stream: the dropout generator is seeded with ``k0·2³² + k1`` and the
      mixup generator is ``numpy.random.default_rng(k0·2³² + k1)``. A key
      ``PRNGKey(s + 1)`` — the key of JAX's ``create_train_state(seed=s)`` —
      so gives the port's ``create_train_state(seed=s)`` generators, and two
      imports of one file draw the same streams (not JAX's).

    The layout of ``opt_state`` (warmup or not, clipping or not) must agree
    with the ``.optjson`` sidecar, with ``opt_config`` (checked against the
    sidecar first, as :func:`load_checkpoint` does) and with ``state``'s
    own optimizer; each disagreement raises, naming both."""
    from .weights import load_jax_moments

    if opt_config is not None:
        check_opt_config(path, opt_config)
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    adam, schedule, warmup, clip = _adam_layout(tree["opt_state"])
    saved = load_opt_config(path)
    if saved is not None:
        _check_layout(path, saved, warmup, clip, "its .optjson recipe")
    _check_layout(path, {"warmup_steps": state.scheduler is not None,
                         "grad_clip": state.grad_clip}, warmup, clip,
                  "this run's optimizer")
    key = np.asarray(tree["rng"])
    if key.dtype != np.uint32 or key.shape != (2,):
        raise ValueError(f"{path}: the PRNG key is {key.dtype}{list(key.shape)}"
                         ", not a raw threefry key uint32[2]")

    model = state.model
    _import_variables(tree, model)
    mu, nu = load_jax_moments(model, adam["mu"]), load_jax_moments(model, adam["nu"])
    count = int(adam["count"])
    opt = state.optimizer
    index = {id(p): i for i, p in enumerate(
        p for group in opt.param_groups for p in group["params"])}
    blob = opt.state_dict()
    # onto the CPU as torch.load gives a .pth: load_state_dict moves each
    # moment to its parameter's device and keeps the step on the host
    blob["state"] = {index[id(p)]: {"step": torch.tensor(float(count)),
                                    "exp_avg": mu[name],
                                    "exp_avg_sq": nu[name]}
                     for name, p in model.named_parameters()}
    opt.load_state_dict(blob)
    if state.scheduler is not None:
        sched, k = state.scheduler, int(schedule["count"])
        sched.last_epoch, sched._step_count = k, k + 1
        lrs = [base * fn(k) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
    seed = (int(key[0]) << 32) | int(key[1])
    state.dropout_generator.manual_seed(seed)
    state.mixup_rng.bit_generator.state = (
        np.random.default_rng(seed).bit_generator.state)
    state.step = int(tree["step"])
    return state
