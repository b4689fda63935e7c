"""sedx on PyTorch and CUDA: the port of ``sound_event_detection_dcase2017_task4_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``config``, ``ops/stft``, ``models``, ``losses``, ``train``, ``sed``,
``sed_fast``, ``serving``, ``checkpoints``, ``evaluate``, ``scoring``,
``autoth``, ``data``, ``features``, ``native``, ``main``,
``plot_results``, ``parallel``, ``audio_io``, and the ``tools`` and
``examples`` of the repository's root) with PyTorch inside, and replaces
each Pallas TPU kernel with a kernel written by hand for Hopper
(``ops/logmel_cuda.py`` + ``ops/csrc/logmel.cu``). It imports ``torch``,
never ``jax``, and nothing of the JAX package; it needs neither ``h5py``
(``data/h5.py`` reads and writes the HDF5 subset of the packed corpus) nor
``scikit-learn`` nor ``msgpack``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); see :func:`resolve_device`.

Import convention::

    import sound_event_detection_dcase2017_task4_torch as sedt
"""

from . import config

__version__ = "0.1.0"


def resolve_device(device=None):
    """``None`` → the CUDA card. Raises when CUDA is asked for (explicitly
    or by default) and ``torch.cuda.is_available()`` is false: an entry
    point never carries on silently on the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def __getattr__(name):
    # Lazy top-level API so `import ..._torch as sedt` stays light (torch is
    # only pulled in when the compute surface is touched).
    import importlib

    lazy = {
        "get_model": ("models", "get_model"),
        "MODEL_REGISTRY": ("models", "MODEL_REGISTRY"),
        "Config": ("config", "Config"),
        "Predictor": ("serving", "Predictor"),
        "StreamingDetector": ("serving", "StreamingDetector"),
        "make_logmel_fn": ("ops.stft", "make_logmel_fn"),
        "make_logmel_bank_fn": ("ops.stft", "make_logmel_bank_fn"),
        "load_jax_variables": ("weights", "load_jax_variables"),
        "create_train_state": ("train", "create_train_state"),
        "make_train_step": ("train", "make_train_step"),
    }
    module_level = {"sed", "models", "serving", "weights", "ops", "train",
                    "losses", "data", "checkpoints", "evaluate", "scoring",
                    "autoth", "sed_fast", "features", "main", "utils",
                    "native", "plot_results", "parallel", "audio_io"}
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    if name in module_level:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
