"""ONT adapter trimming — the framework's step-0 equivalent of porechop.

The reference shells out to porechop for adapter removal (reference:
bin/megapath_nano.py:985-1005 `step_adaptor_trimming`, command
`porechop --require_two_barcodes -i in.fq -o out.fq`). porechop's method is
local alignment of a known adapter set against read ends (trim) and read
middles (split); this module reimplements that method on the framework's own
SSW core instead of an external tool.

Semantics (porechop-equivalent defaults):
- end adapters: align each adapter against the first/last `end_size` bases;
  identity >= `end_threshold` (%) trims through the adapter plus
  `extra_end_trim` bases.
- middle adapters: align against the full read; identity >=
  `middle_threshold` splits the read, discarding `extra_middle_trim` bases
  around the hit; parts shorter than `min_split_size` are dropped.

Identity is 100 * matched_bases / adapter_length (full-length anchored, so a
partial 50% overlap scores ~50%, like porechop's scaled score).

The port's own copy of megapath_nano_tpu/io/adapters.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.native.ssw import build_score_matrix, ssw_align
from megapath_nano_tpu_torch.utils.dna import encode, revcomp


@dataclass(frozen=True)
class Adapter:
    """A named adapter with its start-of-read and end-of-read sequences."""

    name: str
    start_seq: str = ""
    end_seq: str = ""


# Standard ONT chemistry adapters (public kit sequences, as shipped by ONT
# kit documentation / porechop's adapter catalogue).
DEFAULT_ADAPTERS = (
    Adapter("SQK-NSK007/LSK",
            start_seq="AATGTACTTCGTTCAGTTACGTATTGCT",
            end_seq="GCAATACGTAACTGAACGAAGT"),
    Adapter("Rapid",
            start_seq="GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA"),
    Adapter("1D2-part2",
            start_seq="CTTCGTTCAGTTACGTATTGCTGGCGTCTGCTT",
            end_seq="AAGCAGACGCCAGCAATACGTAACTGAACGAAG"),
)


@dataclass
class TrimResult:
    reads: list           # trimmed (possibly split) reads, np.int8 arrays
    names: list           # names; split parts get _1/_2... suffixes
    source: np.ndarray    # index of the input read each output came from
    n_start_trimmed: int = 0
    n_end_trimmed: int = 0
    n_split: int = 0
    n_dropped: int = 0    # parts below min_split_size
    events: list = field(default_factory=list)  # (name, kind, adapter)


def _identity(aln, adapter_len: int) -> float:
    matches = sum(l for l, op in aln.cigar if op == "M")
    # count only true matches: score-based correction for mismatches inside M
    # runs is not available from the CIGAR alone; use score-scaled identity
    # like porechop (score / perfect_score * 100)
    return 100.0 * aln.score1 / (3.0 * adapter_len)


def _best_hit(window: np.ndarray, adapter: np.ndarray, mat) -> tuple:
    if len(window) < 5 or len(adapter) < 5:
        return 0.0, None
    aln = ssw_align(adapter, window, score_matrix=mat, gap_open=5,
                    gap_extend=2, want_cigar=True)
    return _identity(aln, len(adapter)), aln


def trim_adapters(
    reads: list[np.ndarray],
    names: list[str] | None = None,
    adapters: tuple[Adapter, ...] = DEFAULT_ADAPTERS,
    *,
    end_size: int = 150,
    end_threshold: float = 75.0,
    middle_threshold: float = 85.0,
    extra_end_trim: int = 2,
    extra_middle_trim: int = 10,
    min_split_size: int = 300,
    check_middle: bool = True,
) -> TrimResult:
    """Trim/split a read batch. Returns a TrimResult whose reads/names are
    the surviving (sub)reads in input order."""
    names = names or [f"read{i}" for i in range(len(reads))]
    mat = build_score_matrix(3, 6)
    starts, ends, middles = [], [], []
    for a in adapters:
        if a.start_seq:
            s = encode(a.start_seq)
            starts.append((a.name, s))
            middles.append((a.name, s))
            middles.append((a.name + "_rc", revcomp(s)))
        if a.end_seq:
            e = encode(a.end_seq)
            ends.append((a.name, e))
            middles.append((a.name + "_end", e))

    res = TrimResult([], [], None)
    src = []
    for ri, read in enumerate(reads):
        r = np.asarray(read, np.int8)
        # start-of-read adapters
        for name, a in starts:
            ident, aln = _best_hit(r[:end_size], a, mat)
            if ident >= end_threshold:
                cut = aln.ref_end + 1 + extra_end_trim
                r = r[cut:]
                res.n_start_trimmed += 1
                res.events.append((names[ri], "start", name))
                break
        # end-of-read adapters
        for name, a in ends:
            if len(r) == 0:
                break
            w0 = max(len(r) - end_size, 0)
            ident, aln = _best_hit(r[w0:], a, mat)
            if ident >= end_threshold:
                cut = w0 + aln.ref_begin - extra_end_trim
                r = r[: max(cut, 0)]
                res.n_end_trimmed += 1
                res.events.append((names[ri], "end", name))
                break
        # middle adapters → split
        parts = [(r, names[ri])]
        if check_middle and len(r) > 2 * min_split_size:
            for name, a in middles:
                ident, aln = _best_hit(r, a, mat)
                if ident >= middle_threshold:
                    left = r[: max(aln.ref_begin - extra_middle_trim, 0)]
                    right = r[aln.ref_end + 1 + extra_middle_trim:]
                    parts = [(left, names[ri] + "_1"),
                             (right, names[ri] + "_2")]
                    res.n_split += 1
                    res.events.append((names[ri], "middle", name))
                    break
        for part, pname in parts:
            if len(parts) > 1 and len(part) < min_split_size:
                res.n_dropped += 1
                continue
            if len(part) == 0:
                res.n_dropped += 1
                continue
            res.reads.append(part)
            res.names.append(pname)
            src.append(ri)
    res.source = np.array(src, np.int64)
    return res
