"""Model zoo (PyTorch): CNN / gated-GLU / CRNN-BiGRU / CNN-Transformer SED
models.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models``;
``get_model(name)`` keeps the string-keyed registry.
"""

from .blocks import (AttBlock, ConvBlock, GLUBlock, interpolate,
                     pad_framewise_output)
from .zoo import MODEL_REGISTRY, BiGRU, SedCnn, get_model

__all__ = [
    "AttBlock", "BiGRU", "ConvBlock", "GLUBlock", "interpolate",
    "pad_framewise_output", "MODEL_REGISTRY", "SedCnn", "get_model",
]
