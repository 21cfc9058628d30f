"""Conveniences of the reference's ``alisuretool.Tools`` (port of
``basi_tpu/utils/tools.py``): timestamped prints and directory creation."""

from __future__ import annotations

import datetime
import os


class Tools:
    @staticmethod
    def print(*args, **kwargs):
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}]", *args, **kwargs, flush=True)

    @staticmethod
    def new_dir(path: str) -> str:
        os.makedirs(path, exist_ok=True)
        return path
