"""FASTQ/FASTA ingestion into columnar numeric batches.

Native-backed (cpp/mpn_fastq.cc). Replaces the reference's text-pipeline QC
stage (reference: bin/tools/nanofastq.c:20 and bin/megapath_nano.py:1010
step_read_trimming_and_filter) with a single pass that parses, quality-filters
with the same error-probability-averaged Phred semantics, and emits packed
arrays ready for device transfer.

The port's own copy of megapath_nano_tpu/io/fastq.py.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.native.lib import load_native_lib


@dataclass
class ReadBatch:
    """Columnar batch of reads.

    seq: concatenated base codes (int8, 0..4); offsets: (n+1,) int64.
    qual: concatenated phred values (int8) or empty for FASTA.
    ids: list of read-id strings (one per KEPT read).
    Per-record QC stats cover every input record (pass or fail), matching
    nanofastq's stderr info table (read_id, len, avgQ, len_trimmed,
    avgQ_trimmed, passed).
    """

    seq: np.ndarray
    offsets: np.ndarray
    qual: np.ndarray
    ids: list[str]
    stats: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_reads(self) -> int:
        return len(self.offsets) - 1

    def read(self, i: int) -> np.ndarray:
        return self.seq[self.offsets[i]: self.offsets[i + 1]]

    def read_qual(self, i: int) -> np.ndarray:
        return self.qual[self.offsets[i]: self.offsets[i + 1]]

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def read_fastq(
    path: str,
    *,
    head_crop: int = 0,
    tail_crop: int = 0,
    min_length: int = 0,
    min_quality: float = 0.0,
    keep_failed: bool = False,
) -> ReadBatch:
    """Parse a FASTQ/FASTA(.gz) file with nanofastq-equivalent filtering.

    Quality metric: -10*log10(mean(10^(-q/10))) over the trimmed read
    (reference: bin/tools/nanofastq.c:174-212). Defaults in the reference
    pipeline: min_quality 7.0, head/tail crop 0 (megapath_nano.py:5068).
    """
    lib = load_native_lib()
    h = lib.mpn_fastq_read(path.encode(), head_crop, tail_crop, min_length,
                           float(min_quality), 1 if keep_failed else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        n_reads = lib.mpn_batch_num_reads(h)
        n_records = lib.mpn_batch_num_records(h)
        seq_len = lib.mpn_batch_seq_len(h)
        ids_len = lib.mpn_batch_ids_len(h)

        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)

        seq = np.zeros(seq_len, dtype=np.int8)
        offsets = np.zeros(n_reads + 1, dtype=np.int64)
        if seq_len:
            lib.mpn_batch_copy_seq(h, seq.ctypes.data_as(i8p))
        lib.mpn_batch_copy_offsets(h, offsets.ctypes.data_as(i64p))

        qual = np.zeros(seq_len if lib.mpn_batch_has_qual(h) else 0,
                        dtype=np.int8)
        if qual.size:
            lib.mpn_batch_copy_qual(h, qual.ctypes.data_as(i8p))

        ids_buf = ctypes.create_string_buffer(max(ids_len, 1))
        if ids_len:
            lib.mpn_batch_copy_ids(h, ids_buf)
        ids = (
            ids_buf.raw[: ids_len].decode().split("\0")[:-1] if ids_len else []
        )

        orig_len = np.zeros(n_records, dtype=np.int64)
        avg_q = np.zeros(n_records, dtype=np.float64)
        trimmed_len = np.zeros(n_records, dtype=np.int64)
        avg_q_trimmed = np.zeros(n_records, dtype=np.float64)
        passed = np.zeros(n_records, dtype=np.int8)
        if n_records:
            lib.mpn_batch_copy_stats(
                h, orig_len.ctypes.data_as(i64p), avg_q.ctypes.data_as(f64p),
                trimmed_len.ctypes.data_as(i64p),
                avg_q_trimmed.ctypes.data_as(f64p),
                passed.ctypes.data_as(i8p))
        stats = {
            "orig_len": orig_len,
            "avg_q": avg_q,
            "trimmed_len": trimmed_len,
            "avg_q_trimmed": avg_q_trimmed,
            "passed": passed,
        }
        return ReadBatch(seq=seq, offsets=offsets, qual=qual, ids=ids,
                         stats=stats)
    finally:
        lib.mpn_batch_free(h)


def write_fasta(path: str, names: list[str], seqs: list[np.ndarray]) -> None:
    """Write numeric sequences as FASTA (test/fixture helper)."""
    from megapath_nano_tpu_torch.utils.dna import decode

    with open(path, "w") as f:
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n{decode(np.asarray(seq))}\n")


def write_fastq(path: str, names: list[str], seqs: list[np.ndarray],
                quals: list[np.ndarray] | None = None) -> None:
    """Write numeric sequences as FASTQ (test/fixture helper)."""
    from megapath_nano_tpu_torch.utils.dna import decode

    with open(path, "w") as f:
        for i, (name, seq) in enumerate(zip(names, seqs)):
            q = (
                quals[i]
                if quals is not None
                else np.full(len(seq), 20, dtype=np.int8)
            )
            qstr = (np.asarray(q, dtype=np.uint8) + 33).tobytes().decode()
            f.write(f"@{name}\n{decode(np.asarray(seq))}\n+\n{qstr}\n")
