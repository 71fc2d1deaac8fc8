"""history.log setup; the log file doubles as the resume marker (the
port's copy of seq2seq_abcd_vae_tpu/train/logging_utils.py: same file
name, same '{asctime} - {levelname} - {message}' format, single
process)."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("seq2seq_abcd_vae_tpu_torch")


def close_log_handlers() -> None:
    for h in logger.handlers[:]:
        logger.removeHandler(h)
        h.close()


def update_log_handler(file_dir: str) -> tuple[bool, str]:
    """Attach ``file_dir/history.log``; returns (retrieval, path), where
    retrieval is True when the file already existed (a resumed run)."""
    close_log_handlers()
    log_file_path = os.path.join(file_dir, "history.log")
    retrieval = os.path.isfile(log_file_path)
    handler = logging.FileHandler(filename=log_file_path)
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(logging.Formatter(
        "{asctime} - {levelname} - {message}", style="{"))
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.addHandler(handler)
    if retrieval:
        logger.info("LEARNING RETRIEVED.")
    else:
        import torch
        logger.info("Logger set up.")
        logger.info("PyTorch ver.: {ver}".format(ver=torch.__version__))
    return retrieval, log_file_path
