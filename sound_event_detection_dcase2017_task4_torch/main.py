"""Train / inference / metrics / threshold-optimization CLI (PyTorch port).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/main.py``: the
same subcommands (``train``, ``inference``, ``calculate_metrics``,
``optimize_at_thresholds``, ``optimize_sed_thresholds``), flags, defaults
and run-config-keyed workspace layout::

    $WORKSPACE/checkpoints/main/<run-config>/<iter>_iterations.pth
    $WORKSPACE/statistics/main/<run-config>/statistics.pickle
    $WORKSPACE/predictions/main/<run-config>/<split>.pickle
    $WORKSPACE/opt_thresholds/main/<run-config>/{at,sed}.pickle
    $WORKSPACE/_submissions/main/<run-config>/<split>_submission.csv
    $WORKSPACE/logs/...

where ``<run-config> = model_type=?/loss_type=?/augmentation=?/batch_size=?``.
Checkpoints are ``.pth`` files (``checkpoints.py``); statistics, prediction
and threshold pickles have the JAX package's schema, so either package's
metrics and threshold subcommands read the other's predictions.
``inference`` also reads a run the JAX CLI trained: with no ``.pth`` for
the iteration asked, it loads the JAX ``<iter>_iterations.ckpt`` and adopts
its ``.optjson`` recipe. ``train --resume_iteration`` continues either: a
``.pth`` bit for bit, a JAX ``.ckpt`` from its whole training state
(``checkpoints.import_jax_train_state``: variables, Adam moments and counts,
the warmup count, the step; the generators seeded from its PRNG key) and its
``.datastate.pkl`` as it is, so the stream goes on from where the JAX run's
prefetch thread had drawn to, as a JAX resume does.

Everything runs on the CUDA card unless the caller asks for the CPU:
``main(argv, device="cpu")``, as the tests do. ``--cuda`` is accepted for
the reference CLI's flag set.

Training stages the int16 waveform corpus (or the normalised log-mel
features) in device memory once when it fits (``--device_cache``, cap
``SEDX_DEVICE_CACHE_MAX_BYTES``, by default half the device's free memory
when the run starts), and each step moves only the batch index: with
``--feature_source=waveform`` the bank kernel gathers, decodes and takes the
log-mel of its rows. Otherwise a prefetch thread assembles pinned host
batches, and the waveform kernel runs on int16 batches decoded on the
device. ``--no_pallas`` selects the plain PyTorch frontend
(``ops/stft.logmel`` / ``logmel_bank``) because the user asked for it;
nothing selects it otherwise.

Every model of the registry trains, infers and serves; ``--remat``
recomputes each conv or GLU block in the backward, and
``--augmentation=specaugment|mixup_specaugment`` masks the normalised
log-mel in the step. Not ported: ``runtime.enable_compile_cache`` (JAX's
compilation cache; eager PyTorch compiles nothing ahead of the step).

``train`` runs data parallel where the JAX CLI trains on every visible
device: under ``torchrun`` (one process per card)::

    torchrun --nproc_per_node=8 -m sound_event_detection_dcase2017_task4_torch.main train ...

each process joins the group ``torchrun`` describes (or uses one already
initialised) on ``cuda:LOCAL_RANK``. The mesh is the largest number of
processes that divides ``--batch_size``, as the JAX ``make_mesh_for_batch``
takes (the others sit the run out). Every process runs the same data stream
and takes its rows of each global batch; BatchNorm statistics, mixup,
dropout and SpecAugment draws, the gradients and the loss are the global
batch's (``parallel``, ``train``), so N processes train as one does. Only
rank 0 writes the logs, statistics, checkpoints and data-stream positions;
the others wait for each write. A checkpoint is the model's own state, so
a run of any size resumes in any other. The other subcommands run in one
process, as the JAX CLI's do, and refuse a group of more than one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import pickle
import time

import numpy as np
import torch

from . import (autoth, checkpoints, parallel, resolve_device, scoring, sed,
               trace, train as train_lib)
from .config import DEFAULT, classes_num, labels
from .data import (DataGenerator, holdout_indices, load_scalar,
                   prefetch_to_device, read_split, scale, subset_reader)
from .evaluate import Evaluator, tagging_metrics
from .models import get_model
from .ops import stft
from .utils import StatisticsContainer, create_folder, create_logging
from .utils.statistics import best_iteration, jsonable

__all__ = ["main"]


def _holdout_fold(args) -> int | None:
    """Parse ``--holdout_fold``: None / "none" / "" → disabled, else the
    1-based fold number."""
    v = getattr(args, "holdout_fold", None)
    if v is None or str(v).lower() in ("none", ""):
        return None
    return int(v)


def _run_config(args) -> str:
    segments = [
        f"model_type={args.model_type}",
        f"loss_type={args.loss_type}",
        f"augmentation={args.augmentation}",
        f"batch_size={args.batch_size}",
    ]
    # keyed on the PARSED value so the disabled spellings ("none", "")
    # land in the same workspace path as the omitted default
    holdout = _holdout_fold(args)
    if holdout is not None:
        segments.insert(1, f"holdout_fold={holdout}")
    return os.path.join(*segments)


def _paths(args) -> dict:
    ws, rc = args.workspace, _run_config(args)
    return {
        "checkpoints": os.path.join(ws, "checkpoints", "main", rc),
        "statistics": os.path.join(ws, "statistics", "main", rc,
                                   "statistics.pickle"),
        "predictions": os.path.join(ws, "predictions", "main", rc),
        "opt_thresholds": os.path.join(ws, "opt_thresholds", "main", rc),
        "submissions": os.path.join(ws, "_submissions", "main", rc),
        "logs": os.path.join(ws, "logs", "main", rc),
    }


def _strong_labels(args, data_type: str):
    path = os.path.join(
        args.dataset_dir or os.path.join(args.workspace, "synth_dataset"),
        "metadata", f"groundtruth_strong_label_{data_type}_set.csv")
    return scoring.read_ground_truth(path) if os.path.isfile(path) else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _exchanged() -> tuple[int, int]:
    """The collectives run so far in this process, and the bytes it put
    into them (the ``parallel.*`` counters of the port's ``trace``)."""
    got = trace.counters()
    return (sum(v for k, v in got.items()
                if k.startswith("parallel.") and k.endswith(".calls")),
            sum(v for k, v in got.items()
                if k.startswith("parallel.") and k.endswith(".bytes")))


def _default_cache_cap(device: torch.device) -> int:
    """Half the device's free memory now: the card's for CUDA, the host's
    available memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


def _frontends(cfg, no_pallas: bool, wave_scale):
    """``(frontend, bank_frontend)``: the hand-written kernels on the card
    (their plain versions for CPU tensors), or with ``--no_pallas`` the
    plain PyTorch versions everywhere."""
    if no_pallas:
        return (lambda x: stft.logmel(x, cfg),
                lambda bank, idx: stft.logmel_bank(bank, idx, cfg, wave_scale))
    return (stft.make_logmel_fn(cfg),
            stft.make_logmel_bank_fn(cfg, precision="highest",
                                     wave_scale=wave_scale))


def _build(args, for_train: bool, mesh=None):
    """Shared setup: readers, generator, model, train state and steps (the
    train step data parallel over ``mesh``)."""
    dev = args.device
    ws = args.workspace
    feature_source = args.feature_source
    in_memory = not getattr(args, "lazy_data", False)
    # inference on the testing/evaluation splits never reads the training
    # features (the scalar comes from scalars/training.h5): keep them lazy
    train_data_used = (for_train
                       or getattr(args, "data_type", None) == "training"
                       or _holdout_fold(args) is not None)
    train_reader = read_split(os.path.join(ws, "features", "training.h5"),
                              load_waveform=feature_source == "waveform",
                              in_memory=in_memory and train_data_used)
    test_path = os.path.join(ws, "features", "testing.h5")
    test_reader = (read_split(test_path,
                              load_waveform=feature_source == "waveform",
                              in_memory=in_memory)
                   if os.path.isfile(test_path) else None)

    if getattr(args, "mini_data", 0):
        # a row subset keeps an int16 waveform's .raw/.scale, so the
        # int16 transport and staging survive (a slice would decode it)
        train_reader = subset_reader(
            train_reader, np.arange(min(args.mini_data, len(train_reader))))

    # --holdout_fold=k: fold k of the training split is the validation set
    holdout = _holdout_fold(args)
    if holdout is not None:
        tr_idx, ho_idx = holdout_indices(len(train_reader), holdout)
        test_reader = subset_reader(train_reader, ho_idx)
        train_reader = subset_reader(train_reader, tr_idx)

    scalar = load_scalar(os.path.join(ws, "scalars", "training.h5"))
    gen = DataGenerator(train_reader, test_reader,
                        batch_size=args.batch_size, scalar=scalar,
                        seed=args.seed, feature_source=feature_source)
    gen.mesh = mesh

    dtype = torch.bfloat16 if getattr(args, "dtype", "f32") == "bf16" else torch.float32
    model = get_model(args.model_type, classes_num, dtype=dtype,
                      remat=getattr(args, "remat", False),
                      generator=torch.Generator().manual_seed(args.seed))
    # the frontend describes the corpus's actual clip length (packed
    # corpora may be shorter than 10 s, as in the tests): the bank's chunk
    # geometry is checked against cfg.clip_samples
    fe_cfg = DEFAULT
    if (feature_source == "waveform" and train_reader.waveform is not None
            and train_reader.waveform.shape[1] != DEFAULT.clip_samples):
        fe_cfg = dataclasses.replace(
            DEFAULT, clip_samples=int(train_reader.waveform.shape[1]))
    wave_scale = dev_scalar = frontend = bank_fn = None
    if feature_source == "waveform":
        dev_scalar = scalar              # normalised on the device
        gen.mean = gen.std = None
        # quantised int16 storage: ship the raw samples, decode on device
        if hasattr(train_reader.waveform, "scale"):
            wave_scale = train_reader.waveform.scale
            gen.raw_int16 = True
        frontend, bank_fn = _frontends(fe_cfg, args.no_pallas, wave_scale)

    lr = (args.learning_rate if getattr(args, "learning_rate", None)
          is not None else 1e-3)
    warmup, clip = (getattr(args, "warmup_steps", None),
                    getattr(args, "grad_clip", None))
    state = train_lib.create_train_state(
        model, DEFAULT, learning_rate=lr, seed=args.seed, device=dev,
        warmup_steps=warmup, grad_clip=clip)
    opt_config = train_lib.resolve_opt_config(model, lr, warmup, clip)
    mixup_alpha = 1.0 if "mixup" in args.augmentation else 0.0

    # Device-resident corpus: training re-reads the same clips every epoch
    # and at every eval, so a corpus that fits is staged once and each step
    # moves only its index. The shuffle stream does not depend on the
    # transport, so both train on the same batch sequence.
    use_bank = False
    banks = {}
    bank_eval_steps = {}
    bankable = (feature_source == "logmel"
                or (feature_source == "waveform"
                    and train_reader.waveform is not None))
    mode = getattr(args, "device_cache", "auto")
    if for_train and not in_memory and bankable and mode == "on":
        logging.getLogger().warning(
            "device cache: --device_cache=on is ignored with --lazy_data — "
            "the lazy readers keep the corpus on disk and read each batch, "
            "so nothing is staged on the device")
    if for_train and in_memory and bankable:
        cap = int(os.environ.get("SEDX_DEVICE_CACHE_MAX_BYTES",
                                 _default_cache_cap(dev)))
        if feature_source == "logmel":
            est = sum(int(np.prod(r.feature.shape)) * 4
                      for r in (train_reader, test_reader) if r is not None)
        else:
            # hop-chunk rows (~3% row padding), int16 when quantised
            row = stft.prepare_chunks(np.zeros(
                (1, fe_cfg.clip_samples),
                np.int16 if wave_scale is not None else np.float32), fe_cfg)
            est = sum(len(r) * row.nbytes
                      for r in (train_reader, test_reader) if r is not None)
        use_bank = mode == "on" or (mode == "auto" and est <= cap)
        if mode == "auto" and not use_bank:
            logging.getLogger().info(
                "device cache: auto-off (splits ≈ %.1f GB > cap %.1f GB; "
                "--device_cache=on to force)", est / 1e9, cap / 1e9)
    if use_bank:
        mean, std = scalar
        t0 = time.time()
        for split, reader in (("train", train_reader),
                              ("test", test_reader)):
            if reader is None:
                continue
            if feature_source == "logmel":
                feats = reader.feature
                if not isinstance(feats, np.ndarray):    # holdout subset view
                    feats = feats[np.arange(len(reader))]
                bank = scale(feats, mean, std).astype(np.float32, copy=False)
            else:
                # staged as hop-chunk rows; int16 rows ride undecoded and
                # the bank frontend decodes them
                wav = reader.waveform
                if (wave_scale is not None and hasattr(wav, "raw")
                        and float(wav.scale) == wave_scale):
                    arr = wav.raw
                    if not isinstance(arr, np.ndarray):
                        arr = arr[np.arange(len(reader))]
                elif isinstance(wav, np.ndarray):
                    arr = wav
                else:                    # subset / decode view → f32 rows
                    arr = wav[np.arange(len(reader))]
                bank = stft.prepare_chunks(np.ascontiguousarray(arr), fe_cfg)
            banks[split] = torch.from_numpy(np.ascontiguousarray(bank)).to(dev)
        _sync(dev)
        logging.getLogger().info(
            "device cache: staged %s on %s in %.1f s (%.0f MB)",
            "+".join(f"{split}[{b.shape[0]}]" for split, b in banks.items()),
            dev, time.time() - t0,
            sum(b.numel() * b.element_size() for b in banks.values()) / 1e6)
        bank_eval_steps = {
            split: train_lib.make_eval_step(
                model, frontend=frontend, scalar=dev_scalar,
                wave_scale=wave_scale, bank=b, bank_frontend=bank_fn)
            for split, b in banks.items()}

    step = (train_lib.make_train_step(
        model, state, loss_type=args.loss_type, frontend=frontend,
        scalar=dev_scalar, mixup_alpha=mixup_alpha,
        use_spec_augment="specaugment" in args.augmentation,
        check_numerics=getattr(args, "check_numerics", False),
        bank=banks.get("train"), wave_scale=wave_scale,
        bank_frontend=bank_fn if use_bank else None, mesh=mesh)
        if for_train else None)
    eval_step = train_lib.make_eval_step(model, frontend=frontend,
                                         scalar=dev_scalar,
                                         wave_scale=wave_scale)
    return dict(gen=gen, model=model, state=state, step=step,
                eval_step=eval_step, train_reader=train_reader,
                test_reader=test_reader, opt_config=opt_config,
                use_bank=use_bank, bank_eval_steps=bank_eval_steps)


def _with_stream_state(gen, batches):
    """Pair each train batch with the data-stream position before it was
    drawn: a checkpoint at iteration k stores the position of batch k
    itself, however far the prefetch thread has run ahead, so a resumed
    run draws exactly the batches an uninterrupted one would."""
    while True:
        position = gen.state_dict()
        yield position, next(batches)


def _save_data_state(ckpt_dir: str, position: dict, iteration: int) -> None:
    path = os.path.join(ckpt_dir, f"{iteration}_iterations.datastate.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(position, f)
    os.replace(path + ".tmp", path)


def do_train(args) -> dict:
    """Train; returns ``{"iteration", "loss", "evals"}``: the last
    iteration, the last step's loss and, for each eval point, its iteration
    with the train, eval and checkpoint wall times and the train clips/s
    since the previous one. On a mesh of 2 or more, each eval's log line
    also gives the collectives and the MB this rank put into them per
    train step since the previous eval.

    In a process group (``torchrun``) every process of the mesh returns the
    same; a process outside the mesh returns ``{"iteration": None, "loss":
    None, "evals": []}`` before reading any data."""
    paths = _paths(args)
    mesh = None
    if parallel.is_initialized():
        mesh = parallel.make_mesh_for_batch(args.batch_size, args.device)
        if mesh is None:
            logging.getLogger(__name__).warning(
                "rank %d of %d sits this run out: --batch_size=%d splits "
                "evenly over fewer processes", torch.distributed.get_rank(),
                parallel.world_size(), args.batch_size)
            return {"iteration": None, "loss": None, "evals": []}
    rank0 = mesh is None or mesh.rank == 0       # the one that writes
    if rank0:
        for k in ("checkpoints", "predictions", "submissions", "logs"):
            create_folder(paths[k])
        logger = create_logging(paths["logs"])
    else:
        logger = logging.getLogger(__name__)
    logger.info("train: %s", vars(args))

    if args.resume_iteration > 0:
        ckpt = checkpoints.find_checkpoint(paths["checkpoints"],
                                           args.resume_iteration)
        if ckpt is None:
            raise FileNotFoundError(
                f"no checkpoint for iteration {args.resume_iteration} under "
                f"{paths['checkpoints']}")
        # a run resumes with no optimizer flags re-passed
        _adopt_ckpt_opt_config(args, ckpt)
    ctx = _build(args, for_train=True, mesh=mesh)
    gen, step, state = ctx["gen"], ctx["step"], ctx["state"]
    use_bank, dev = ctx["use_bank"], args.device
    logger.info("device: %s%s", dev, "" if mesh is None else
                f" (rank {mesh.rank} of a data-parallel mesh of {mesh.size})")

    statistics = StatisticsContainer(paths["statistics"]) if rank0 else None
    if args.resume_iteration > 0:
        # every rank loads the same checkpoint (onto the CPU, then into its
        # own device's tensors); a .ckpt was trained by the JAX package's CLI
        load = (checkpoints.import_jax_train_state if ckpt.endswith(".ckpt")
                else checkpoints.load_checkpoint)
        load(ckpt, state, opt_config=ctx["opt_config"])
        logger.info("resumed from %s", ckpt)
        # keep the metric history before the resume point; the resumed run
        # evaluates again at the resume iteration when the cadence aligns
        if rank0 and os.path.isfile(paths["statistics"]):
            statistics.load(args.resume_iteration - 1)
            logger.info("statistics history restored: %d records",
                        len(statistics.statistics_list))
        dstate = os.path.splitext(ckpt)[0] + ".datastate.pkl"
        if os.path.isfile(dstate):
            with open(dstate, "rb") as f:
                gen.load_state_dict(pickle.load(f))
            logger.info("data-stream state restored from %s", dstate)
    evaluator = Evaluator(ctx["eval_step"], labels, DEFAULT.frames_per_second,
                          mesh=mesh)
    # with --holdout_fold the validation set is a fold of the weakly
    # labelled training split: no strong labels, no SED metrics
    test_gt = (None if _holdout_fold(args) is not None
               else _strong_labels(args, "testing"))

    it = state.step
    evals = []
    metrics = None
    profiler = None
    exchanged = _exchanged()
    t0 = time.time()
    batches = prefetch_to_device(
        _with_stream_state(gen, gen.generate_train(yield_indices=use_bank)),
        device=dev)
    for position, (batch_x, batch_y) in batches:
        if it % args.eval_interval == 0:
            _sync(dev)
            train_time = time.time() - t0
            # the train steps' collectives since the last eval
            calls, nbytes = (a - b for a, b in zip(_exchanged(), exchanged))
            for split, reader in (("train", None), ("test", ctx["test_reader"])):
                if split == "test" and reader is None:
                    continue
                src = gen.train if split == "train" else reader
                n_eval = min(len(src),
                             args.eval_max_iteration * args.batch_size)
                if n_eval < len(src):
                    logger.info(
                        "eval [%s] truncated to %d/%d clips "
                        "(--eval_max_iteration=%d; final metrics use the "
                        "full split via the inference subcommand)",
                        split, n_eval, len(src), args.eval_max_iteration)
                g = gen.generate_validate(
                    "train" if split == "train" else "validate",
                    max_iteration=args.eval_max_iteration,
                    yield_indices=use_bank)
                res = evaluator.evaluate(
                    g, audio_names=(reader.audio_names if reader else None),
                    ground_truth_events=test_gt if split == "test" else None,
                    eval_step=(ctx["bank_eval_steps"][split]
                               if use_bank else None))
                at = res["at"]
                msg = (f"iter {it} [{split}] mAP={at['mAP']:.4f} "
                       f"macroF1={at['macro_f1']:.4f}")
                stats = {"at": dict(at)}
                if "sed" in res:
                    ov = res["sed"]["overall"]
                    msg += (f" segF1={ov['f_measure']['f_measure']:.4f} "
                            f"ER={ov['error_rate']['error_rate']:.4f}")
                    stats["sed"] = {
                        "f_measure": ov["f_measure"]["f_measure"],
                        "error_rate": ov["error_rate"]["error_rate"],
                        **{k: res["sed"][k] for k in
                           ("overall", "class_wise", "class_wise_average")}}
                logger.info(msg)
                if rank0:
                    statistics.append(it, stats, split)
            if rank0:
                statistics.dump()
            t_ckpt = time.time()
            if rank0:
                checkpoints.save_checkpoint(paths["checkpoints"], state, it,
                                            opt_config=ctx["opt_config"])
                _save_data_state(paths["checkpoints"], position, it)
            ckpt_time = time.time() - t_ckpt
            if rank0 and getattr(args, "keep_checkpoints", 0) > 0:
                test_recs = [r for r in statistics.statistics_list
                             if r.get("data_type") == "test" and "at" in r]
                best = ((int(max(test_recs,
                                 key=lambda r: r["at"]["mAP"])["iteration"]),)
                        if test_recs else ())
                for victim in checkpoints.prune_checkpoints(
                        paths["checkpoints"], args.keep_checkpoints,
                        protect=best):
                    logger.info("pruned %s", victim)
            parallel.barrier(mesh)          # the others wait for the writes
            eval_time = time.time() - t0 - train_time
            steps = it - evals[-1]["iteration"] if evals else 0
            cps = (steps * args.batch_size / train_time
                   if steps and train_time > 0 else None)
            evals.append({"iteration": it, "train_time": train_time,
                          "eval_time": eval_time, "checkpoint_time": ckpt_time,
                          "train_clips_per_s": cps})
            exchange = ""
            if parallel.mesh_size(mesh) > 1 and steps:
                exchange = (f" exchange {calls / steps:.1f} collectives "
                            f"{nbytes / steps / 1e6:.3f} MB a step")
            logger.info("iter %d train_time %.3f s eval_time %.3f s (of it "
                        "checkpoint %.3f s)%s%s", it, train_time, eval_time,
                        ckpt_time, "" if cps is None else f" ({cps:.1f} clips/s)",
                        exchange)
            exchanged = _exchanged()
            t0 = time.time()

        if it >= args.stop_iteration:
            break
        if rank0 and args.profile_dir and it == args.profile_start:
            profiler = _start_profiler(dev)
            logger.info("profiler trace started → %s", args.profile_dir)
        metrics = step(batch_x, batch_y)
        if profiler is not None and it == args.profile_start + 4:
            _sync(dev)
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            trace_path = os.path.join(args.profile_dir,
                                      f"trace_iter{it - 4}.json")
            profiler.export_chrome_trace(trace_path)
            profiler = None
            logger.info("profiler trace stopped (5 steps) → %s", trace_path)
        if args.check_numerics:
            bad = int(metrics["nonfinite_count"])
            if bad > 0:
                # the update already applied the non-finite gradients: save
                # the poisoned state under a name latest_checkpoint() and
                # --resume_iteration never pick up
                dump = os.path.join(paths["checkpoints"],
                                    f"nonfinite_abort_{it}.pth.debug")
                if rank0:
                    torch.save(checkpoints.state_dict(state), dump)
                raise FloatingPointError(
                    f"--check_numerics: {bad} non-finite loss/grad values "
                    f"at iteration {it}; aborting (poisoned state dumped "
                    f"to {dump}; resume from the last regular checkpoint)")
        if it % 100 == 0:
            logger.info("iter %d loss %.4f", it, float(metrics["loss"]))
        it += 1
    batches.close()                      # stops the prefetch thread

    if rank0:
        checkpoints.save_checkpoint(paths["checkpoints"], state, it,
                                    opt_config=ctx["opt_config"])
        _save_data_state(paths["checkpoints"], position, it)
    parallel.barrier(mesh)
    logger.info("done at iter %d", it)
    return {"iteration": it,
            "loss": None if metrics is None else float(metrics["loss"]),
            "evals": evals}


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _resolve_ckpt(args, paths) -> str:
    it = args.iteration
    if isinstance(it, str):
        if it == "best":
            it, m, n = best_iteration(paths["statistics"])
            print(f"--iteration best → iter {it} "
                  f"(test mAP {m:.4f} over {n} evals)")
        else:
            try:
                it = int(it)        # argparse delivers strings
            except ValueError:
                raise SystemExit(
                    f"--iteration must be an integer or 'best', got {it!r}")
    ckpt = checkpoints.find_checkpoint(paths["checkpoints"], it)
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint under {paths['checkpoints']}"
            + ("" if it is None else f" for iteration {it}"))
    return ckpt


def _adopt_ckpt_opt_config(args, ckpt: str) -> None:
    """Adopt the checkpoint's recorded optimizer recipe for any
    --learning_rate/--warmup_steps/--grad_clip left unset; values passed
    explicitly are kept (a structural mismatch then raises in
    ``checkpoints.check_opt_config``)."""
    saved = checkpoints.load_opt_config(ckpt)
    if saved is None:
        return
    for key in ("learning_rate", "warmup_steps", "grad_clip"):
        if getattr(args, key, None) is None and key in saved:
            setattr(args, key, saved[key])


def do_inference(args) -> None:
    """Forward a split and dump the predictions pickle (read by
    calculate_metrics and optimize_*_thresholds)."""
    paths = _paths(args)
    create_folder(paths["predictions"])
    ckpt = _resolve_ckpt(args, paths)
    _adopt_ckpt_opt_config(args, ckpt)
    ctx = _build(args, for_train=False)
    if ckpt.endswith(".ckpt"):           # trained by the JAX package's CLI
        checkpoints.check_opt_config(ckpt, ctx["opt_config"])
        checkpoints.import_jax_checkpoint(ckpt, ctx["state"].model)
    else:
        checkpoints.load_checkpoint(ckpt, ctx["state"],
                                    opt_config=ctx["opt_config"])
    data_type = args.data_type

    if data_type in ("testing", "validate", "test"):
        reader, gen_split = ctx["test_reader"], "validate"
    elif data_type == "training":
        reader, gen_split = ctx["train_reader"], "train"
    else:  # evaluation
        reader = read_split(
            os.path.join(args.workspace, "features", "evaluation.h5"),
            load_waveform=args.feature_source == "waveform",
            in_memory=not getattr(args, "lazy_data", False))
        ctx["gen"].validate = reader
        gen_split = "validate"

    out = train_lib.forward_generator(
        ctx["eval_step"], ctx["gen"].generate_validate(gen_split))
    out["audio_name"] = reader.audio_names
    dump = os.path.join(paths["predictions"], f"{data_type}.pickle")
    with open(dump, "wb") as f:
        pickle.dump(out, f)
    print(f"checkpoint: {ckpt}")
    print(f"predictions → {dump}  clipwise {out['clipwise_output'].shape}")


def _load_predictions(args, paths, data_type):
    dump = os.path.join(paths["predictions"], f"{data_type}.pickle")
    if not os.path.isfile(dump):
        raise FileNotFoundError(
            f"{dump} missing — run the inference subcommand first")
    with open(dump, "rb") as f:
        return pickle.load(f)


def do_calculate_metrics(args) -> None:
    """AT + SED metrics on dumped predictions; writes the submission TSV."""
    paths = _paths(args)
    create_folder(paths["submissions"])
    preds = _load_predictions(args, paths, args.data_type)

    at_thr, sed_thr = 0.3, None
    if args.use_optimized_thresholds:
        at_p = os.path.join(paths["opt_thresholds"], "at.pickle")
        sed_p = os.path.join(paths["opt_thresholds"], "sed.pickle")
        if os.path.isfile(at_p):
            with open(at_p, "rb") as f:
                at_thr = pickle.load(f)["thresholds"]
        if os.path.isfile(sed_p):
            with open(sed_p, "rb") as f:
                sed_thr = pickle.load(f)["sed_params"]

    metrics_record = {}
    at = tagging_metrics(preds["clipwise_output"], preds["target"], at_thr)
    metrics_record["at"] = at
    print(f"[{args.data_type}] AT: mAP={at['mAP']:.4f} "
          f"macroF1={at['macro_f1']:.4f} "
          f"P={at['macro_precision']:.4f} R={at['macro_recall']:.4f}")
    if args.verbose:
        print(f"{'class':<34} {'AP':>7} {'F1':>7} {'P':>7} {'R':>7}")
        for k, lb in enumerate(labels):
            print(f"{lb:<34} {at['average_precision'][k]:>7.4f} "
                  f"{at['f1'][k]:>7.4f} {at['precision'][k]:>7.4f} "
                  f"{at['recall'][k]:>7.4f}")

    # with --holdout_fold the testing/training predictions are clips of the
    # weakly labelled training split: the strong labels describe other
    # files, so they are not scored against them
    holdout_weak = (_holdout_fold(args) is not None
                    and args.data_type in ("testing", "training"))
    gt = None if holdout_weak else _strong_labels(args, args.data_type)
    if holdout_weak:
        print(f"[{args.data_type}] SED scoring skipped: --holdout_fold "
              "predictions are training-split clips with weak labels only")
    events = sed.frame_prediction_to_event_prediction(
        preds["framewise_output"], sed_thr, DEFAULT.frames_per_second, labels)
    est = {preds["audio_name"][i]: events[i]
           for i in range(len(preds["audio_name"]))}
    sub = os.path.join(paths["submissions"],
                       f"{args.data_type}_submission.csv")
    scoring.write_submission(est, sub)
    print(f"submission → {sub}")
    if gt is not None:
        m = scoring.segment_based_metrics(gt, est, 10.0, 1.0, labels)
        metrics_record["sed"] = m
        ov = m["overall"]
        print(f"[{args.data_type}] SED: segF1="
              f"{ov['f_measure']['f_measure']:.4f} "
              f"ER={ov['error_rate']['error_rate']:.4f} "
              f"(S={ov['error_rate']['substitution_rate']:.3f} "
              f"D={ov['error_rate']['deletion_rate']:.3f} "
              f"I={ov['error_rate']['insertion_rate']:.3f})")
        if args.verbose:
            print(f"{'class':<34} {'segF1':>7} {'ER':>7} {'Nref':>6}")
            for lb in labels:
                cw = m["class_wise"][lb]
                print(f"{lb:<34} {cw['f_measure']:>7.4f} "
                      f"{cw['error_rate']:>7.4f} {cw['nref']:>6.0f}")
    if getattr(args, "metrics_out", None):
        # full-split metrics as spec-valid JSON (NaN/Inf → null)
        with open(args.metrics_out, "w") as f:
            json.dump({"data_type": args.data_type,
                       "n_clips": int(len(preds["audio_name"])),
                       **jsonable(metrics_record)}, f, allow_nan=False)
        print(f"metrics json → {args.metrics_out}")


def do_optimize_at_thresholds(args) -> None:
    """Per-class AT thresholds maximizing macro-F1 on the testing split: the
    exact sorted-sweep optimum (``autoth.exact_f1_thresholds``)."""
    paths = _paths(args)
    create_folder(paths["opt_thresholds"])
    preds = _load_predictions(args, paths, "testing")
    clip, tgt = preds["clipwise_output"], preds["target"]

    def score(thr):
        return tagging_metrics(clip, tgt, thr)["macro_f1"]

    thr = autoth.exact_f1_thresholds(clip, tgt)
    best = score(thr)
    out = os.path.join(paths["opt_thresholds"], "at.pickle")
    with open(out, "wb") as f:
        pickle.dump({"thresholds": thr, "score": best}, f)
    print(f"AT macro-F1 {score(np.full(classes_num, 0.3)):.4f} → {best:.4f}; "
          f"thresholds → {out}")


def do_optimize_sed_thresholds(args) -> None:
    """Full ``sed_params_dict`` search — per-class (high, low) hysteresis
    pairs and the ``n_smooth``/``n_salt`` lengths — maximizing segment F1
    on the testing split."""
    paths = _paths(args)
    create_folder(paths["opt_thresholds"])
    if _holdout_fold(args) is not None:
        raise ValueError(
            "--holdout_fold runs validate on a fold of the weakly-labelled "
            "training split — there are no strong labels to search SED "
            "thresholds against (use the default testing-split validation)")
    preds = _load_predictions(args, paths, "testing")
    gt = _strong_labels(args, "testing")
    if gt is None:
        raise FileNotFoundError("no strong ground truth for testing split")
    fw, names = preds["framewise_output"], preds["audio_name"]

    def numpy_score(params):
        events = sed.frame_prediction_to_event_prediction(
            fw, params, DEFAULT.frames_per_second, labels)
        est = {names[i]: events[i] for i in range(len(names))}
        m = scoring.segment_based_metrics(gt, est, 10.0, 1.0, labels)
        return m["overall"]["f_measure"]["f_measure"]

    # the search's score evaluations run through the device scorer
    # (integer-exact counts: the same scores as the numpy oracle); a tiny
    # split stays on numpy, and the oracle re-scores the shipped optimum
    counts_fn = None
    if getattr(args, "numpy_search", False) or fw.size < 2_000_000:
        score = numpy_score
    else:
        from .sed_fast import DeviceSegmentScorer
        scorer = DeviceSegmentScorer(fw, names, gt, labels,
                                     DEFAULT.frames_per_second,
                                     device=args.device)
        score = scorer.score_params
        counts_fn = scorer.per_class_counts

    t0 = time.time()
    base_score = numpy_score(dict(sed.sed_params_dict))
    best, params = autoth.optimize_sed_params(score, classes_num,
                                              counts_fn=counts_fn)
    best = numpy_score(params)                   # oracle re-score
    if best < base_score:
        # never ship params that score worse than the defaults
        best, params = base_score, dict(sed.sed_params_dict)
    out = os.path.join(paths["opt_thresholds"], "sed.pickle")
    with open(out, "wb") as f:
        pickle.dump({"sed_params": params, "score": best}, f)
    print(f"SED segment-F1 {base_score:.4f} → {best:.4f} "
          f"(n_smooth={params['n_smooth']} n_salt={params['n_salt']}, "
          f"search {time.time() - t0:.1f} s); params → {out}")


def _add_common(sp):
    sp.add_argument("--workspace", required=True)
    sp.add_argument("--dataset_dir", default=None)
    sp.add_argument("--model_type", default="Cnn_9layers_Gru_FrameAtt")
    sp.add_argument("--loss_type", default="clip_bce", choices=["clip_bce"],
                    help="the weak-label training loss")
    sp.add_argument("--augmentation", default="none",
                    choices=["none", "mixup", "specaugment",
                             "mixup_specaugment"])
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--learning_rate", type=float, default=None,
                    help="default 1e-3 (reference recipe); eval subcommands "
                         "auto-adopt the checkpoint's recorded value")
    sp.add_argument("--warmup_steps", type=int, default=None,
                    help="linear LR warmup steps; default 500 for "
                         "transformer variants, 0 otherwise; recorded in "
                         "the checkpoint's .optjson sidecar and auto-adopted")
    sp.add_argument("--grad_clip", type=float, default=None,
                    help="global-norm gradient clip; default 1.0 for "
                         "transformer variants, off otherwise")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--mini_data", type=int, default=0,
                    help="train on only the first N clips")
    sp.add_argument("--holdout_fold", default=None,
                    help="hold fold K (1-4, round-robin clip assignment) of "
                         "the training split out as the validation set")
    sp.add_argument("--feature_source", default="logmel",
                    choices=["logmel", "waveform"])
    sp.add_argument("--no_pallas", action="store_true",
                    help="use the plain PyTorch log-mel frontend instead of "
                         "the hand-written kernel")
    sp.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="model compute dtype (params stay f32)")
    sp.add_argument("--remat", action="store_true",
                    help="recompute each conv/GLU block's activations in "
                         "the backward (torch.utils.checkpoint): less "
                         "activation memory for one more forward of the "
                         "blocks; checkpoints are the same either way")
    sp.add_argument("--lazy_data", action="store_true",
                    help="read batches from the HDF5 files through memmaps "
                         "instead of loading the splits into RAM")
    sp.add_argument("--device_cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="stage the training and testing splits in device "
                         "memory once and gather batches there by index "
                         "(training only; auto = on when they fit under "
                         "SEDX_DEVICE_CACHE_MAX_BYTES, by default half the "
                         "device's free memory). The same batch stream")
    sp.add_argument("--check_numerics", action="store_true",
                    help="count non-finite loss/grad values every step and "
                         "abort when any appear")
    sp.add_argument("--cuda", action="store_true",
                    help="accepted for reference-CLI parity; the CUDA card "
                         "is the default device")


def main(argv=None, device=None):
    """Run one subcommand on ``device`` (``None`` → the CUDA card; raises
    when there is none; ``"cpu"`` runs on the CPU). Returns what the
    subcommand returns (``train``: see :func:`do_train`).

    ``train`` in a process group runs data parallel (``parallel.join``:
    the group ``torchrun`` describes, joined here and left at the end, or
    one the caller initialised, used as it is); every other subcommand
    raises in a group of more than one process."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)

    pt = sub.add_parser("train")
    _add_common(pt)
    pt.add_argument("--stop_iteration", type=int, default=10000)
    pt.add_argument("--resume_iteration", type=int, default=0)
    pt.add_argument("--eval_interval", type=int, default=1000)
    pt.add_argument("--eval_max_iteration", type=int, default=10)
    pt.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of 5 train "
                         "steps here (with the port's sedx.* spans)")
    pt.add_argument("--profile_start", type=int, default=10)
    pt.add_argument("--keep_checkpoints", type=int, default=0,
                    help="keep only the N highest-iteration checkpoints, "
                         "never deleting the best-test-mAP one (0 = keep all)")
    pt.set_defaults(func=do_train)

    pi = sub.add_parser("inference", aliases=["inference_prob"])
    _add_common(pi)
    pi.add_argument("--data_type", default="testing",
                    choices=["training", "testing", "evaluation"])
    pi.add_argument("--iteration", default=None,
                    help="checkpoint iteration to load (default: latest); "
                         "'best' selects the eval iteration with the "
                         "highest test-split mAP of this run's statistics")
    pi.set_defaults(func=do_inference)

    pm = sub.add_parser("calculate_metrics")
    _add_common(pm)
    pm.add_argument("--data_type", default="testing",
                    choices=["training", "testing", "evaluation"])
    pm.add_argument("--use_optimized_thresholds", action="store_true")
    pm.add_argument("--verbose", action="store_true",
                    help="print class-wise AT/SED tables")
    pm.add_argument("--metrics_out", default=None,
                    help="also write the full-split AT/SED metrics as JSON "
                         "to this path")
    pm.set_defaults(func=do_calculate_metrics)

    pa = sub.add_parser("optimize_at_thresholds")
    _add_common(pa)
    pa.set_defaults(func=do_optimize_at_thresholds)

    ps = sub.add_parser("optimize_sed_thresholds")
    _add_common(ps)
    ps.add_argument("--numpy_search", action="store_true",
                    help="run the threshold search through the host numpy "
                         "scorer instead of the device one")
    ps.set_defaults(func=do_optimize_sed_thresholds)

    args = p.parse_args(argv)
    if args.func is not do_train:
        if parallel.world_size() > 1:
            raise RuntimeError(
                f"{args.mode} runs in one process, as the JAX CLI's does; "
                f"only train runs data parallel (this job has "
                f"{parallel.world_size()} processes)")
        args.device = resolve_device(device)
        return args.func(args)
    args.device, started = parallel.join(device)
    try:
        return do_train(args)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
