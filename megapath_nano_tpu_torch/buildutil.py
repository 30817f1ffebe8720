"""Shared build-at-first-use plumbing for the port's two compiled libraries:
the CUDA kernels (`kernels/build.py`, nvcc) and the native C++ host layer
(`native/lib.py`, g++).

Both are cached under `megapath_nano_tpu_torch/build/` (listed in
`.gitignore`) by a hash of their sources and flags. A build is safe when
several processes start at once: `build_once` holds an `fcntl.flock` on a
lock file in the build directory, the compile writes to a temporary name,
and `os.replace` puts the finished file in place, so no process ever loads a
half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import tempfile
from collections.abc import Callable, Iterable

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def source_hash(sources: Iterable[str], flags: Iterable[str]) -> str:
    """16 hex digits over the flags and the names and bytes of the sources."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_once(path: str, compile_to: Callable[[str], None]) -> None:
    """Make sure `path` exists: under the build directory's file lock, call
    `compile_to(tmp)` unless another process finished the build meanwhile,
    then rename tmp to `path`. A failing `compile_to` raises and leaves
    nothing behind."""
    build_dir = os.path.dirname(path)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return
            fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(path)[1],
                                       dir=build_dir)
            os.close(fd)
            try:
                compile_to(tmp)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
