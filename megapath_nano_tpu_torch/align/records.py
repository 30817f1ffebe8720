"""align_list records — the canonical inter-stage data schema. The port's own
copy of megapath_nano_tpu/align/records.py.

Mirrors the reference's 18-column align_list DataFrame schema
(reference: bin/megapath_nano.py:110-115) as a numpy structured array, the
framework's equivalent of the pandas frames every reference stage exchanges.
Integer read ids index into the owning ReadBatch; string columns
(sequence/assembly ids) are categorical indices into side tables to stay
device/vectorization-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ALIGN_DTYPE = np.dtype([
    ("read_id", np.int64),
    ("read_length", np.int64),
    ("read_from", np.int64),       # 0-based, inclusive
    ("read_to", np.int64),         # exclusive
    ("strand", np.int8),           # 0 = '+', 1 = '-'
    ("sequence_id", np.int32),     # index into sequence_names
    ("sequence_length", np.int64),
    ("sequence_from", np.int64),
    ("sequence_to", np.int64),
    ("match", np.int64),
    ("mapq", np.int32),
    ("edit_dist", np.int64),
    ("alignment_score", np.int64),
    ("assembly_id", np.int32),     # index into assembly_names
    ("tax_id", np.int64),
    ("species_tax_id", np.int64),
    ("genus_tax_id", np.int64),
    ("alignment_score_tiebreaker", np.float64),
])


@dataclass
class AlignList:
    """Columnar alignment set + the name tables its int columns index.

    cigar_map (optional): {(read_id, sequence_id): (cigar, oriented_read_from,
    strand)} for rows emitted with base-exact CIGARs — the oriented_read_from
    is in the strand-oriented query frame (revcomp'd read for strand 1), as
    needed to replay the alignment for pileup/consensus. With multi-locus
    mapping (minimap2 -N/-p semantics) each locus is additionally keyed
    (read_id, sequence_id, sequence_from); the plain 2-key always points at
    the best-scoring locus for that (read, sequence) pair."""

    data: np.ndarray                      # structured array, ALIGN_DTYPE
    sequence_names: list[str] = field(default_factory=list)
    assembly_names: list[str] = field(default_factory=list)
    read_names: list[str] = field(default_factory=list)
    cigar_map: dict | None = None

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, key):
        return self.data[key]

    def filter(self, mask: np.ndarray) -> "AlignList":
        return AlignList(self.data[mask], self.sequence_names,
                         self.assembly_names, self.read_names, self.cigar_map)

    def sort_by(self, *cols: str) -> "AlignList":
        order = np.lexsort([self.data[c] for c in reversed(cols)])
        return AlignList(self.data[order], self.sequence_names,
                         self.assembly_names, self.read_names, self.cigar_map)

    @staticmethod
    def empty(sequence_names=None, assembly_names=None, read_names=None):
        return AlignList(np.zeros(0, ALIGN_DTYPE), sequence_names or [],
                         assembly_names or [], read_names or [])

    def to_dict(self) -> dict:
        return {name: self.data[name] for name in self.data.dtype.names}
