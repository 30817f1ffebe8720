"""ctypes loader for the native C++ host layer (the sources in cpp/).

The port's own copy of megapath_nano_tpu/native/lib.py (same structures and
declarations), with a loader of its own: at first use it compiles `cpp/*.cc`
with the flags of `cpp/Makefile` into one shared library under
`megapath_nano_tpu_torch/build/`, cached by a hash of the sources. It never
runs `make -C cpp` and writes nothing into `cpp/`. The build is safe when
several processes start at once (see `buildutil.build_once`); a failed
compile raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading

from megapath_nano_tpu_torch import buildutil

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
BUILD_DIR = buildutil.BUILD_DIR
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
LDFLAGS = ("-shared", "-lz")

_lock = threading.Lock()
_lib = None


class MpnBandedResult(ctypes.Structure):
    """Mirror of MpnBandedResult in cpp/mpn_banded.cc."""

    _fields_ = [
        ("score", ctypes.c_int32),
        ("read_begin", ctypes.c_int32),
        ("read_end", ctypes.c_int32),
        ("ref_begin", ctypes.c_int32),
        ("ref_end", ctypes.c_int32),
        ("n_match", ctypes.c_int32),
        ("n_mismatch", ctypes.c_int32),
        ("n_ins", ctypes.c_int32),
        ("n_del", ctypes.c_int32),
        ("cigar_len", ctypes.c_int32),
    ]


class MpnRealignResult(ctypes.Structure):
    """Mirror of MpnRealignResult in cpp/mpn_realigner.cc."""

    _fields_ = [
        ("hap_index", ctypes.c_int32),
        ("ref_pos", ctypes.c_int32),
        ("score", ctypes.c_int32),
        ("cigar_len", ctypes.c_int32),
    ]


class MpnAlignResult(ctypes.Structure):
    """Mirror of MpnAlignResult in cpp/mpn_ssw.cc."""

    _fields_ = [
        ("score1", ctypes.c_int32),
        ("score2", ctypes.c_int32),
        ("ref_begin1", ctypes.c_int32),
        ("ref_end1", ctypes.c_int32),
        ("read_begin1", ctypes.c_int32),
        ("read_end1", ctypes.c_int32),
        ("ref_end2", ctypes.c_int32),
        ("cigar_len", ctypes.c_int32),
    ]


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i8p, i64p, u32p, u64p = (
        c.POINTER(c.c_int8),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_uint32),
        c.POINTER(c.c_uint64),
    )
    lib.mpn_ssw_align.restype = c.c_int
    lib.mpn_ssw_align.argtypes = [
        i8p, c.c_int32, i8p, c.c_int32, i8p, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(MpnAlignResult), u32p, c.c_int32,
    ]
    lib.mpn_ssw_align_batch.restype = c.c_int
    lib.mpn_ssw_align_batch.argtypes = [
        i8p, i64p, i8p, i64p, c.c_int32, i8p, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(MpnAlignResult), u32p, c.c_int64,
    ]

    lib.mpn_fastq_read.restype = c.c_void_p
    lib.mpn_fastq_read.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64, c.c_int64, c.c_double, c.c_int,
    ]
    for name in ("mpn_batch_num_reads", "mpn_batch_num_records",
                 "mpn_batch_seq_len", "mpn_batch_ids_len"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.mpn_batch_has_qual.restype = c.c_int
    lib.mpn_batch_has_qual.argtypes = [c.c_void_p]
    lib.mpn_batch_copy_seq.argtypes = [c.c_void_p, i8p]
    lib.mpn_batch_copy_qual.argtypes = [c.c_void_p, i8p]
    lib.mpn_batch_copy_offsets.argtypes = [c.c_void_p, i64p]
    lib.mpn_batch_copy_ids.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpn_batch_copy_id_offsets.argtypes = [c.c_void_p, i64p]
    lib.mpn_batch_copy_stats.argtypes = [
        c.c_void_p, i64p, c.POINTER(c.c_double), i64p,
        c.POINTER(c.c_double), i8p,
    ]
    lib.mpn_batch_free.argtypes = [c.c_void_p]

    lib.mpn_banded_align_batch.restype = c.c_int
    lib.mpn_banded_align_batch.argtypes = [
        i8p, i64p, i8p, i64p, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(MpnBandedResult), u32p, i64p,
    ]

    lib.mpn_index_build.restype = c.c_void_p
    lib.mpn_index_build.argtypes = [i8p, i64p, c.c_int32, c.c_int, c.c_int,
                                    c.c_int32]
    lib.mpn_index_size.restype = c.c_int64
    lib.mpn_index_size.argtypes = [c.c_void_p]
    lib.mpn_index_copy.argtypes = [c.c_void_p, u64p, u64p]
    lib.mpn_index_free.argtypes = [c.c_void_p]
    lib.mpn_sketch.restype = c.c_int64
    lib.mpn_sketch.argtypes = [
        i8p, c.c_int64, c.c_int, c.c_int, u64p, i64p, i8p, c.c_int64,
    ]
    lib.mpn_dbg_haplotypes.restype = c.c_int32
    lib.mpn_dbg_haplotypes.argtypes = [
        i8p, c.c_int32, i8p, i64p, i8p, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, i8p, i64p, c.c_int64,
    ]
    lib.mpn_realign_reads.restype = c.c_int
    lib.mpn_realign_reads.argtypes = [
        i8p, i64p, c.c_int32, i8p, c.c_int32, i8p, i64p, c.c_int32,
        c.c_int32, c.POINTER(MpnRealignResult), u32p, i64p,
    ]

    lib.mpn_lookup.restype = None
    lib.mpn_lookup.argtypes = [u64p, c.c_int64, u64p, c.c_int64, i64p, i64p,
                               c.c_int32]
    lib.mpn_lookup_lut.restype = None
    lib.mpn_lookup_lut.argtypes = [u64p, c.c_int64, i64p, c.c_int32, u64p,
                                   c.c_int64, i64p, i64p, c.c_int32]
    lib.mpn_sketch_batch.restype = c.c_int64
    lib.mpn_sketch_batch.argtypes = [
        i8p, i64p, c.c_int32, c.c_int, c.c_int, u64p, i64p, i8p, i64p,
        c.c_int64,
    ]
    i32p = c.POINTER(c.c_int32)
    lib.mpn_anchors_build.restype = c.c_void_p
    lib.mpn_anchors_build.argtypes = [
        i8p, i64p, c.c_int32, c.c_int, c.c_int,
        u64p, c.c_int64, u64p, i64p, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.mpn_anchors_total.restype = c.c_int64
    lib.mpn_anchors_total.argtypes = [c.c_void_p]
    lib.mpn_anchors_export.restype = None
    lib.mpn_anchors_export.argtypes = [
        c.c_void_p, i32p, i64p, i32p, i8p, i64p,
    ]


# Native-layer thread cap (--max_aligner_thread); None = all cores.
DEFAULT_THREADS = None


def default_threads() -> int:
    return DEFAULT_THREADS or max(1, os.cpu_count() or 1)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CPP_DIR, "*.cc")))


def library_path() -> str:
    """Path of the cached library for the current sources and flags."""
    tag = buildutil.source_hash(_sources(), CXXFLAGS + LDFLAGS)
    return os.path.join(BUILD_DIR, f"libmpn_native-{tag}.so")


def _compile(out: str) -> None:
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no C++ sources in {CPP_DIR}")
    cxx = os.environ.get("CXX", "g++")
    res = subprocess.run([cxx, *CXXFLAGS, *srcs, *LDFLAGS, "-o", out],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")


def load_native_lib() -> ctypes.CDLL:
    """Load the native library, building it first if no cached build
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
