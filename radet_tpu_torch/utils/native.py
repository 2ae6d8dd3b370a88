"""Build one source of the package's ``csrc/`` into a shared library at first
use, for loading with ``ctypes``.

The library goes into ``radet_tpu_torch/_build/`` under a name that carries
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The file is written under a temporary
name and renamed, so a concurrent build never loads half a library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

# one lock per library: loader threads may ask for one library at once,
# while different libraries build in parallel
_locks: Dict[Path, threading.Lock] = {}
_locks_guard = threading.Lock()


def find_tool(names: Sequence[str], fallback: Optional[Path] = None) -> str:
    """The first of ``names`` on PATH, else ``fallback`` when it exists."""
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    if fallback is not None and fallback.exists():
        return str(fallback)
    raise RuntimeError(f"none of {list(names)} found on PATH" + (f" or at {fallback}" if fallback else ""))


def build_library(source: Path, compiler: str, flags: Sequence[str]) -> Tuple[Path, Optional[str]]:
    """Compile ``source`` with ``compiler *flags -o lib source`` unless the
    library of this source and these flags exists.  Returns (library path,
    the compiler's stderr when this call built it, else None)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    with _locks_guard:
        lock = _locks.setdefault(path, threading.Lock())
    with lock:
        if path.exists():
            return path, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: another process never loads half a file
    return path, proc.stderr
