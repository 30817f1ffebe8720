"""Make the TPU package's native library whole before any test runs.

The TPU package's loader (megapath_nano_tpu/native/lib.py) runs
`make -C cpp` when cpp/libmpn_native.so is missing, under a thread lock
only. On a fresh tree several pytest-xdist workers start that build at
once; one of them can load a library that another is still writing ("file
too short", or a library without some of its symbols) and keep it for the
rest of its tests.

pytest-xdist has every worker collect every test file before the first test
runs, so this module's body, which runs at collection, comes first: under a
file lock in the port's build directory it checks that the library exists
and resolves every symbol the TPU package's loader declares, and otherwise
compiles it with the Makefile's flags into a temporary file in cpp/ and
renames that into place. The reference's loader then finds a complete
library and never runs make. The check runs in a child process, so that no
test process loads a library that is about to be replaced.
"""

import fcntl
import glob
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(REPO, "cpp")
LIBRARY = os.path.join(CPP, "libmpn_native.so")
LOCK = os.path.join(REPO, "megapath_nano_tpu_torch", "build",
                    ".reference_native.lock")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
LDFLAGS = ("-shared", "-lz")

# exits 0 when the library at argv[1] loads and has every declared symbol
CHECK = ("import ctypes, sys\n"
         f"sys.path.insert(0, {REPO!r})\n"
         "from megapath_nano_tpu.native.lib import _declare\n"
         "_declare(ctypes.CDLL(sys.argv[1]))\n")


def library_is_complete(path: str) -> bool:
    if not os.path.exists(path):
        return False
    res = subprocess.run([sys.executable, "-c", CHECK, path],
                         capture_output=True, text=True, timeout=120)
    return res.returncode == 0


def _build() -> None:
    fd, tmp = tempfile.mkstemp(prefix="libmpn_native.", suffix=".so",
                               dir=CPP)      # cpp/*.so: ignored by git
    os.close(fd)
    try:
        srcs = sorted(glob.glob(os.path.join(CPP, "*.cc")))
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, *srcs,
                        *LDFLAGS, "-o", tmp],
                       check=True, capture_output=True, timeout=600)
        if not library_is_complete(tmp):
            raise RuntimeError(f"{tmp}: built, but a declared symbol is "
                               f"missing")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_reference_library() -> None:
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not library_is_complete(LIBRARY):
                _build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


ensure_reference_library()


def test_reference_library_has_every_declared_symbol():
    from megapath_nano_tpu.native.lib import load_native_lib

    lib = load_native_lib()      # _declare raises on a missing symbol
    assert os.path.samefile(lib._name, LIBRARY)
    assert library_is_complete(LIBRARY)
