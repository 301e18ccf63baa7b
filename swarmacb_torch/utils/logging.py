"""Logging: TensorBoard writer with a JSONL fallback.

A copy of ``swarmacb_tpu.utils.logging``: the port imports nothing of the
JAX package. The trainer logs under the ML-Agents tag names
(poca_trainer.py:861-958), so reference learning curves stay comparable.
TensorBoard is used where it is installed; otherwise a JSONL writer with
the same ``add_scalar`` API writes ``scalars.jsonl`` in the log directory.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def print_line(line: str) -> None:
    """``line`` and its newline on standard output in one write, flushed.
    The ranks of a data-parallel run share their parent's standard output;
    where it is unbuffered (PYTHONUNBUFFERED, ``python -u``) ``print``
    writes the text and the newline apart, and another rank's line can
    land between them. One write of a short line to a pipe is atomic."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


class JsonlWriter:
    """Minimal SummaryWriter-compatible scalar logger."""

    def __init__(self, log_dir: str):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "scalars.jsonl", "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall_time": time.time()}) + "\n")

    def add_text(self, tag: str, text: str, step: int = 0):
        self._f.write(json.dumps(
            {"tag": tag, "text": text, "step": int(step)}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def make_writer(log_dir: str):
    """TensorBoard SummaryWriter if importable, else JSONL."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except ImportError:              # no tensorboard package
        return JsonlWriter(log_dir)
