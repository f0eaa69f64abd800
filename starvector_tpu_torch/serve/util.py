"""Serving utilities (a copy of starvector_tpu/serve/util.py; reference:
starvector/serve/util.py:16-127):
file-backed logging with stdout/stderr capture, base64 helpers, a
moderation hook stub."""

from __future__ import annotations

import base64
import io
import logging
import logging.handlers
import os
import sys

handler = None


def build_logger(logger_name: str, logger_filename: str, log_dir: str = "serve_logs"):
    """Rotating file logger that also captures stdout/stderr (reference
    :16-56)."""
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    stdout_logger = logging.getLogger("stdout")
    stdout_logger.setLevel(logging.INFO)
    sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
    stderr_logger = logging.getLogger("stderr")
    stderr_logger.setLevel(logging.ERROR)
    sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(log_dir, exist_ok=True)
        filename = os.path.join(log_dir, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True
        )
        handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    return logger


class StreamToLogger:
    """Redirect a stream into a logger (reference :59-86)."""

    def __init__(self, logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def violates_moderation(text: str) -> bool:
    """Moderation hook (reference :95-112 calls the OpenAI moderation API;
    zero-egress here — hook point kept, default allow)."""
    return False


def encode_image_base64(pil_image) -> str:
    """reference data/util.py:71-77"""
    if pil_image.mode == "RGBA":
        pil_image = pil_image.convert("RGB")
    buffered = io.BytesIO()
    pil_image.save(buffered, format="JPEG")
    return base64.b64encode(buffered.getvalue()).decode("utf-8")


def decode_image_base64(b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64)))
