"""Model zoo (PyTorch): CNN / gated-GLU / CRNN-BiGRU / CNN-Transformer SED
models, and HTS-AT and Audio Mamba, models of the port alone (``PORT_REGISTRY``).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models``;
``get_model(name)`` keeps the string-keyed registry.
"""

from .blocks import (AttBlock, ConvBlock, GLUBlock, interpolate,
                     pad_framewise_output)
from .aum import AudioMamba
from .htsat import HTSAT
from .zoo import MODEL_REGISTRY, PORT_REGISTRY, BiGRU, SedCnn, get_model

__all__ = [
    "AttBlock", "BiGRU", "ConvBlock", "GLUBlock", "interpolate",
    "pad_framewise_output", "AudioMamba", "HTSAT", "MODEL_REGISTRY", "PORT_REGISTRY",
    "SedCnn", "get_model",
]
