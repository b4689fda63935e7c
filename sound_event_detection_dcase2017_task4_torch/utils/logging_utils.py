"""Logging/file utilities (reference: ``utils/utilities.py:{create_folder,
get_filename,create_logging}``; SURVEY.md §2 "Logging utils").

Same observable behavior: numbered log files ``NNNN.log`` under
``$WORKSPACE/logs/<script>/`` plus stdout mirroring.

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/utils/logging_utils.py``, kept
as it is: the port never imports the JAX package, so it carries its own (the
CPU tests hold the two to equal outputs).
"""

from __future__ import annotations

import logging
import os

__all__ = ["create_folder", "get_filename", "create_logging"]


def create_folder(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def get_filename(path: str) -> str:
    """Basename without extension (used to key log/checkpoint dirs)."""
    return os.path.splitext(os.path.basename(path))[0]


def create_logging(log_dir: str, filemode: str = "w") -> logging.Logger:
    """Create ``<log_dir>/NNNN.log`` (first free index) + stdout logging."""
    create_folder(log_dir)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f"{i:04d}.log")):
        i += 1
    log_path = os.path.join(log_dir, f"{i:04d}.log")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s %(message)s",
        datefmt="%a, %d %b %Y %H:%M:%S",
        filename=log_path,
        filemode=filemode,
        force=True,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(name)-12s: %(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
    return logging.getLogger("")
