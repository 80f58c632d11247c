"""Process-aware logging, as ``yanerf_tpu/utils/logging.py`` has it.

The process index is ``torch.distributed.get_rank()`` when a process group
is initialized, else 0: only process 0 attaches a FileHandler and logs at
the requested level; other processes are silenced to ERROR. Logger setup
is deduplicated by name prefix.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch.distributed as dist

logger_initialized: dict = {}


def _process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(
    name: str,
    log_file: Optional[str] = None,
    log_level: int = logging.INFO,
    file_mode: str = "w",
) -> logging.Logger:
    """Get (and initialize once) a named logger.

    Process 0 logs to stream + optional file at ``log_level``; other
    processes only log ERRORs so multi-process runs don't interleave output.
    """
    logger = logging.getLogger(name)
    if name in logger_initialized:
        return logger
    for initialized_name in logger_initialized:
        if name.startswith(initialized_name):
            return logger

    # Avoid double printing via the root logger's handlers.
    for handler in logger.root.handlers:
        if type(handler) is logging.StreamHandler:
            handler.setLevel(logging.ERROR)

    rank = _process_index()

    handlers: list = [logging.StreamHandler()]
    if rank == 0 and log_file is not None:
        handlers.append(logging.FileHandler(log_file, file_mode))

    formatter = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    level = log_level if rank == 0 else logging.ERROR
    for handler in handlers:
        handler.setFormatter(formatter)
        handler.setLevel(level)
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    logger_initialized[name] = True
    return logger


def print_log(msg, logger=None, level: int = logging.INFO) -> None:
    """Print a message through the given logger, or plain print/silence.

    Args:
        msg: the message.
        logger: ``None`` -> ``print``; "silent" -> no-op; a Logger or a
            logger name -> log at ``level``.
    """
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == "silent":
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f"logger must be a Logger, str, 'silent' or None, got {type(logger)}")
