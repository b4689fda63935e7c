"""The port stands alone: it never imports jax, flax, optax or the JAX
package, nor h5py, scikit-learn or msgpack.

Subprocesses import the port, serve one CPU request and take one CPU train
step over an int16 bank (after checking that ``create_train_state`` with no
device raises without a card), and run the CLI on the CPU (``features
pack_synthetic`` with WAVs, ``calculate_feature_for_all_audio_files``
through the native decoder, ``main train`` → ``inference`` →
``calculate_metrics``, ``plot_results --table``; ``main train
--resume_iteration`` on a JAX package ``.ckpt``) and run one of the port's
tools on the CPU (``tools.sed_search_bench``, with a CLI child of
``tools.run_cli``), then check ``sys.modules``; ``graft_entry``'s forward
and a dry run on 2 spawned gloo ranks run with the forbidden packages
shadowed by ones that raise when imported; a source scan checks every
module of the port (its ``tools`` and ``examples`` too) and
``chip_smoke.py`` for such imports, and for ``bench.py``. The lazy
``sedt.audio_io`` resolves in a fresh process, as ``sedx.audio_io`` does. The port ships its own copy of the
native decoder's source, and ``runme_torch.sh`` is ``runme.sh`` with the
port's package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sound_event_detection_dcase2017_task4_torch"
FORBIDDEN = ("jax", "flax", "optax", "sound_event_detection_dcase2017_task4_tpu",
             "h5py", "sklearn", "msgpack")


def test_serving_a_request_loads_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import sound_event_detection_dcase2017_task4_torch as sedt\n"
        "from sound_event_detection_dcase2017_task4_torch.models import SedCnn\n"
        "cfg = sedt.Config(clip_samples=16000)\n"
        "model = SedCnn(channels=(8, 16), seq='gru', gru_hidden=16)\n"
        "pred = sedt.Predictor(model, cfg, scalar=(np.zeros(64), np.ones(64)),\n"
        "                      device='cpu')\n"
        "out = pred(np.random.RandomState(0).randn(2, 16000).astype('float32'))\n"
        "assert out['event_activity'].shape == (2, 51, 17)\n"
        "assert len(pred.detect_events(np.zeros((1, 16000), 'float32'))) == 1\n"
        "from sound_event_detection_dcase2017_task4_torch import train\n"
        "from sound_event_detection_dcase2017_task4_torch.ops import stft\n"
        "try:\n"
        "    train.create_train_state(model)\n"
        "    raise SystemExit('create_train_state() ran without a card')\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e)\n"
        "state = train.create_train_state(model, cfg, device='cpu')\n"
        "bank = stft.prepare_chunks(np.zeros((3, 16000), np.int16), cfg)\n"
        "step = train.make_train_step(\n"
        "    model, state, bank=torch.from_numpy(bank),\n"
        "    bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=2.0 ** -15),\n"
        "    mixup_alpha=1.0)\n"
        "m = step(np.array([2, 0]), np.ones((2, 17), np.float32))\n"
        "assert np.isfinite(float(m['loss'])) and state.step == 1\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


def test_the_cli_pipeline_loads_no_jax_h5py_sklearn_or_msgpack(tmp_path):
    ws = str(tmp_path / "ws")
    code = (
        "import sys\n"
        "from sound_event_detection_dcase2017_task4_torch import (\n"
        "    features, main, plot_results)\n"
        f"ws = {ws!r}\n"
        "features.main(['pack_synthetic', f'--workspace={ws}', '--num_train=8',\n"
        "               '--num_test=4', '--num_eval=4', '--clip_seconds=0.5'],\n"
        "              device='cpu')\n"
        "features.main(['calculate_feature_for_all_audio_files',\n"
        "               f'--dataset_dir={ws}/synth_dataset', f'--workspace={ws}',\n"
        "               '--data_type=testing', '--clip_seconds=0.5'], device='cpu')\n"
        "c = [f'--workspace={ws}', '--model_type=Cnn_5layers_AvgPooling',\n"
        "     '--batch_size=4', '--feature_source=waveform']\n"
        "main.main(['train', *c, '--stop_iteration=2', '--eval_interval=2',\n"
        "           '--eval_max_iteration=1'], device='cpu')\n"
        "main.main(['inference', *c, '--data_type=testing'], device='cpu')\n"
        "main.main(['calculate_metrics', *c, '--data_type=testing'], device='cpu')\n"
        "plot_results.main([f'--workspace={ws}', '--table'])\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"
    assert "SED: segF1=" in proc.stdout
    assert "| Cnn_5layers_AvgPooling | 2 |" in proc.stdout


def test_resuming_a_jax_checkpoint_loads_no_jax_or_msgpack(tmp_path):
    """``main train --resume_iteration`` on a workspace whose checkpoint is
    the JAX package's ``.ckpt`` (written here by the JAX package, with its
    ``.optjson``): the port imports it with its own msgpack reader."""
    from sound_event_detection_dcase2017_task4_torch import features
    from sound_event_detection_dcase2017_task4_tpu import checkpoints as jckpt
    from sound_event_detection_dcase2017_task4_tpu import config as jconfig
    from sound_event_detection_dcase2017_task4_tpu import train as jtrain
    from sound_event_detection_dcase2017_task4_tpu.models import get_model

    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=8",
                   "--num_test=4", "--num_eval=4", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    jm = get_model("Cnn_5layers_AvgPooling")
    state, _ = jtrain.create_train_state(jm, jconfig.Config(clip_samples=16000),
                                         example_frames=51, seed=3)
    rc = os.path.join("model_type=Cnn_5layers_AvgPooling", "loss_type=clip_bce",
                      "augmentation=none", "batch_size=4")
    jckpt.save_checkpoint(os.path.join(ws, "checkpoints", "main", rc),
                          state.replace(step=2), 2,
                          opt_config=jtrain.resolve_opt_config(jm))
    code = (
        "import sys\n"
        "from sound_event_detection_dcase2017_task4_torch import main\n"
        f"ws = {ws!r}\n"
        "out = main.main(['train', f'--workspace={ws}',\n"
        "                 '--model_type=Cnn_5layers_AvgPooling', '--batch_size=4',\n"
        "                 '--feature_source=waveform', '--resume_iteration=2',\n"
        "                 '--stop_iteration=3', '--eval_interval=100'],\n"
        "                device='cpu')\n"
        "assert out['iteration'] == 3, out\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"
    assert os.path.isfile(os.path.join(ws, "checkpoints", "main", rc,
                                       "3_iterations.pth"))


def test_a_tool_loads_no_jax_h5py_sklearn_or_msgpack():
    code = (
        "import sys\n"
        "from sound_event_detection_dcase2017_task4_torch import tools\n"
        "from sound_event_detection_dcase2017_task4_torch.tools import sed_search_bench\n"
        "rec = sed_search_bench.main(['--clips', '4', '--frames', '101'],\n"
        "                            device='cpu')\n"
        "assert rec['sequential_dispatches'] > rec['grid_ascent_dispatches']\n"
        "rc, out = tools.run_cli('tools.sed_search_bench',\n"
        "                        ['--clips', '2', '--frames', '51',\n"
        "                         '--skip_sequential'], 'cpu', echo=False)\n"
        "assert rc == 0 and tools.child_report(out)['logmel'] == 0, out\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "       or m == 'bench']\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


def test_audio_io_resolves_lazily_in_a_fresh_process():
    code = (
        "import sys\n"
        "import sound_event_detection_dcase2017_task4_torch as sedt\n"
        "import sound_event_detection_dcase2017_task4_tpu as sedx\n"
        "assert sedt.audio_io.__name__ == sedt.__name__ + '.audio_io'\n"
        "assert sedx.audio_io.__name__ == sedx.__name__ + '.audio_io'\n"
        "assert callable(sedt.audio_io.load_wav)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def test_graft_entry_and_its_ranks_load_no_jax(tmp_path):
    """``graft_entry``'s forward on the CPU and ``dryrun_multichip`` on 2
    spawned gloo ranks, with each forbidden package shadowed by one that
    raises when imported: a rank (or the parent) that imported one would
    fail the run, so no ``sys.modules`` there holds one. The shadows are
    first shown to stand in front of the real packages."""
    stubs = tmp_path / "stubs"
    for name in FORBIDDEN:
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text(
            f"raise RuntimeError('{name} imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stubs), str(REPO)]),
               CUDA_VISIBLE_DEVICES="")
    shadowed = subprocess.run([sys.executable, "-c", "import jax"], cwd=tmp_path,
                              env=env, capture_output=True, text=True, timeout=60)
    assert shadowed.returncode != 0 and "jax imported" in shadowed.stderr
    code = (
        "import sys\n"
        "from sound_event_detection_dcase2017_task4_torch import graft_entry\n"
        "forward, args = graft_entry.entry(device='cpu')\n"
        "clip, frame = forward(*args)\n"
        "assert clip.shape == (4, 17) and frame.shape == (4, 201, 17)\n"
        "out = graft_entry.dryrun_multichip(2, device='cpu', timeout=240)\n"
        "assert out['eval_shape'] == (3, 17)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('LOADED', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "dryrun_multichip(2): OK" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {p.relative_to(PORT).as_posix() for p in files if PORT in p.parents}
    assert {"main.py", "features.py", "checkpoints.py", "evaluate.py",
            "sed_fast.py", "scoring.py", "autoth.py", "audio_io.py",
            "data/h5.py", "data/hdf5.py", "data/generator.py", "data/synth.py",
            "utils/statistics.py", "native.py", "plot_results.py",
            "tools/__init__.py", "tools/mfu.py", "tools/coldstart_probe.py",
            "tools/sed_search_bench.py", "tools/scale_soak.py",
            "tools/hard_benchmark.py", "tools/parity_check.py",
            "examples/minimal_train.py", "examples/streaming_live.py",
            "graft_entry.py"} <= names
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
            assert name != "bench", f"{path}: imports the JAX side's bench.py"
        text = path.read_text()
        assert "importlib.import_module(\"jax" not in text, path


def test_kernel_source_ships_with_the_package():
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, nvcc

    assert logmel_cuda.SOURCE.is_file()
    assert logmel_cuda.SOURCE.parent == PORT / "ops" / "csrc"
    src = logmel_cuda.SOURCE.read_text()
    # the block constants the wrapper assumes are the source's
    for name, value in (("TF", logmel_cuda.FRAMES_PER_BLOCK),
                        ("G", logmel_cuda.THREADS_PER_FRAME),
                        ("FI", logmel_cuda.FRAMES_IN_FLIGHT)):
        assert f"constexpr int {name} = {value};" in src
    # twiddles come only from the host plan
    assert "__sinf" not in src and "__cosf" not in src
    assert "fast_math" not in " ".join(nvcc.FLAGS)
    assert "sm_90a" in " ".join(nvcc.FLAGS)
    assert "pallas_logmel.py:logmel_pallas" in src
    assert "pallas_logmel.py:logmel_pallas_bank" in src
    assert "int sedx_logmel_bank_launch(" in src


def _code(path: Path) -> list:
    """The lines of a C++ source with its ``//`` comments and blank lines
    dropped."""
    lines = (line.split("//", 1)[0].rstrip() for line in path.read_text().splitlines())
    return [line for line in lines if line]


def test_native_source_ships_with_the_package():
    from sound_event_detection_dcase2017_task4_torch import native

    assert native.SOURCE == PORT / "csrc" / "sedx_native.cc"
    assert native.SOURCE.is_file()
    assert _code(native.SOURCE) == _code(REPO / "native" / "sedx_native.cc")
    # native/Makefile's flags, so both libraries compute the same bits
    make = (REPO / "native" / "Makefile").read_text()
    assert f"CXXFLAGS ?= {' '.join(native.CXX_FLAGS)}\n" in make
    assert "$< " + " ".join(native.LINK_FLAGS) in make
    assert native.BUILD_DIR == PORT / "_build"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "sound_event_detection_dcase2017_task4_torch/_build/" in ignored


def test_runme_torch_is_runme_with_the_port_package():
    theirs = (REPO / "runme.sh").read_text().splitlines()
    mine = (REPO / "runme_torch.sh").read_text().splitlines()
    assert len(mine) == len(theirs)
    diff = [(a, b) for a, b in zip(theirs, mine) if a != b]
    assert diff == [('PKG="sound_event_detection_dcase2017_task4_tpu"',
                     'PKG="sound_event_detection_dcase2017_task4_torch"')]
    assert os.access(REPO / "runme_torch.sh", os.X_OK)
