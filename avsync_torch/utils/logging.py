"""Timestamped file/console logger and wall-time formatting (the port's own
copy of `avsync/utils/logging.py`).

Parity with the reference's `Logger` and `format_time`
(`misalignment_detection_train.py:29-60`): timestamped lines to a log file,
optional console echo, and h/m/s humanized durations. Under a process group
only rank 0 writes the file and the console.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional


class Logger:
    """Log to a file and optionally to console."""

    def __init__(self, log_path: Optional[str], console: bool = True):
        from avsync_torch.parallel import multihost

        main = multihost.is_main()
        self.log_path = log_path
        self.console = console and main
        self.file = None
        if log_path and main:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self.file = open(log_path, "w")

    def log(self, message: str) -> None:
        timestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{timestamp}] {message}"
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()
        if self.console:
            print(message)

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def format_time(seconds: float) -> str:
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{int(seconds // 60)}m {seconds % 60:.1f}s"
    hours = int(seconds // 3600)
    mins = int((seconds % 3600) // 60)
    return f"{hours}h {mins}m {seconds % 60:.1f}s"
