"""The data path's small C++ libraries, built with ``g++`` on first use.

``load(name, src, before, after)`` compiles ``src`` (one file under
``basi_tpu_torch/csrc/``) with ``CXX_FLAGS`` into
``build/native/<hash of command and source>/lib<name>.so`` under the
checkout and loads it; ``before`` are flags placed before the source (include
paths), ``after`` the ones after the output (libraries). A build that fails
raises with the compiler's output; nothing is written into the package.
The library goes into place with ``os.replace``, so processes building the
same source at once each load a whole file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def command(src: Path, out: Path, before=(), after=()) -> list[str]:
    return ["g++", *CXX_FLAGS, *before, str(src), "-o", str(out), *after]


def load(name: str, src: Path, before=(), after=()
         ) -> tuple[ctypes.CDLL, dict]:
    """(the loaded library, ``{"path", "compiled", "seconds"}``)."""
    digest = hashlib.sha256(
        " ".join(command(src, Path("lib.so"), before, after)).encode())
    digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / f"lib{name}.so"
    info = {"path": str(lib_path), "compiled": False, "seconds": 0.0}
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = command(src, tmp, before, after)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        info.update(compiled=True, seconds=time.perf_counter() - t0)
    return ctypes.CDLL(str(lib_path)), info
