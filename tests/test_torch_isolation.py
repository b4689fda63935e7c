"""The port stands alone: it never imports jax, flax, optax or the JAX package.

A subprocess imports the port, serves one CPU request and takes one CPU
train step over an int16 bank (after checking that ``create_train_state``
with no device raises without a card), then checks ``sys.modules``; a source scan checks every module of the port and
``chip_smoke.py`` for such imports.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sound_event_detection_dcase2017_task4_torch"
FORBIDDEN = ("jax", "flax", "optax", "sound_event_detection_dcase2017_task4_tpu")


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
    assert len(files) >= 12
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
        text = path.read_text()
        assert "importlib.import_module(\"jax" not in text, path


def test_kernel_source_ships_with_the_package():
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda

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
    assert "fast_math" not in " ".join(logmel_cuda.NVCC_FLAGS)
    assert "sm_90a" in " ".join(logmel_cuda.NVCC_FLAGS)
    assert "pallas_logmel.py:logmel_pallas" in src
    assert "pallas_logmel.py:logmel_pallas_bank" in src
    assert "int sedx_logmel_bank_launch(" in src
