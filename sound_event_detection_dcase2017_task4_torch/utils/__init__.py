"""Host utilities: logging and run statistics (reference:
``utils/utilities.py`` infra symbols; SURVEY.md §2 "Logging utils",
"Statistics container").

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/utils/__init__.py``, kept as it
is: the port never imports the JAX package, so it carries its own (the CPU
tests hold the two to equal outputs).
"""

from .logging_utils import create_folder, create_logging, get_filename
from .statistics import StatisticsContainer

__all__ = ["create_folder", "create_logging", "get_filename",
           "StatisticsContainer"]
