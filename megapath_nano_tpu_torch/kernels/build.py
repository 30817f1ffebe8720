"""Build the port's CUDA sources with nvcc and load them with ctypes.

At first use, every `csrc/*.cu` file is compiled for Hopper (`sm_90a`), one
nvcc process per source, all started together, and the objects are linked
into one shared library with a plain C interface under
`megapath_nano_tpu_torch/build/` (listed in `.gitignore`). The library name
carries a hash of the sources and the flags, so a changed source builds anew
and an unchanged one loads the cached library. Nothing but the sources in
this package is compiled. The build is safe when several processes start at
once (see `buildutil.build_once`).

Each C entry point takes every pointer and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launch; `check` raises on a non-zero
code.

Flags: no `--use_fast_math`, and `-fmad=false` so that no multiply-add is
contracted: the kernels are held bit-equal to their plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

from megapath_nano_tpu_torch import buildutil

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = buildutil.BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def library_path() -> str:
    """Path of the cached library for the current sources and flags."""
    tag = buildutil.source_hash(_sources(), NVCC_FLAGS)
    return os.path.join(BUILD_DIR, f"libmpn_torch_kernels-{tag}.so")


def _compile(out: str) -> None:
    """One `nvcc -c` per source, all running at once, then one link. The
    compilers' output (with ptxas' register and spill report) is kept in a
    `.log` beside the library."""
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, os.path.basename(s)[:-3] + ".o")
                for s in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", s, "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cu, objs)]
        failed = []
        for s, proc in zip(cu, procs):
            text, _ = proc.communicate()
            log.append(f"== {os.path.basename(s)}\n{text}")
            if proc.returncode != 0:
                failed.append(os.path.basename(s))
        if not failed:
            res = subprocess.run([nvcc, "-shared", "-o", out, *objs],
                                 capture_output=True, text=True)
            log.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append("link")
    text = "\n".join(log)
    with open(library_path()[:-3] + ".log", "w") as f:
        f.write(text)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text[-4000:]}")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mpn_sw_full.restype = i
    sw_args = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, i]
    lib.mpn_sw_full.argtypes = sw_args
    lib.mpn_sw_scores.restype = i
    lib.mpn_sw_scores.argtypes = sw_args + [ctypes.POINTER(i)]
    lib.mpn_sw_full_max_band.restype = i
    lib.mpn_sw_full_max_band.argtypes = [i, ctypes.POINTER(i)]
    lib.mpn_sw_scores_max_band.restype = i
    lib.mpn_sw_scores_max_band.argtypes = [i, ctypes.POINTER(i)]
    lib.mpn_chain.restype = i
    lib.mpn_chain.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]


def load() -> ctypes.CDLL:
    """The kernels' shared library, compiled first if no cached build
    matches the sources."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                buildutil.build_once(path, _compile)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to `wrapper.launches` (or another count of the wrapper's);
    under a lock, since the map path launches from two worker threads."""
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def launch_args(t) -> tuple[int, ctypes.c_void_p]:
    """(device index, current stream handle) for a CUDA tensor's device."""
    import torch

    stream = torch.cuda.current_stream(t.device)
    return t.device.index, ctypes.c_void_p(stream.cuda_stream)
