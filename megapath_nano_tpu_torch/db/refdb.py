"""Reference database: target genomes + assembly/taxonomy metadata + index.

The framework's equivalent of the reference's genomes/ + db/ layout
(reference: bin/lib/assembly_metadata.py:107-222 loads assembly_length,
assembly_path, assembly_tax_id, sequence_summary flat files; db_preparation/
builds them from RefSeq). Here a RefDB bundles:

  - numeric target sequences (concatenated + offsets)
  - per-sequence: name, assembly index
  - per-assembly: name, length, tax_id, species_tax_id, genus_tax_id
  - tax_id -> name table
  - the minimizer index over all sequences

Persistence is a directory of .npz + .json — cheap to build from FASTA with
`RefDB.build`, no SQLite required (name lookups are in-memory dicts).

The port's own copy of megapath_nano_tpu/db/refdb.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import SequenceMeta
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.taxon.abundance import AssemblyInfo


@dataclass
class RefDB:
    index: MinimizerIndex
    seq_assembly: np.ndarray          # (n_seqs,) int32 → assembly idx
    assembly_names: list[str]
    assembly_lengths: np.ndarray      # (n_assemblies,) int64
    assembly_tax: np.ndarray          # (n_assemblies, 3) int64 tax/species/genus
    tax_names: dict[int, str] = field(default_factory=dict)

    @property
    def assembly_info(self) -> AssemblyInfo:
        return AssemblyInfo(
            length=self.assembly_lengths,
            tax_id=self.assembly_tax[:, 0],
            species_tax_id=self.assembly_tax[:, 1],
            genus_tax_id=self.assembly_tax[:, 2],
        )

    @property
    def sequence_meta(self) -> SequenceMeta:
        sa = self.seq_assembly
        return SequenceMeta(
            assembly_idx=sa,
            assembly_names=self.assembly_names,
            tax_id=self.assembly_tax[sa, 0],
            species_tax_id=self.assembly_tax[sa, 1],
            genus_tax_id=self.assembly_tax[sa, 2],
        )

    @staticmethod
    def build(
        sequences: list[np.ndarray],
        seq_names: list[str],
        seq_assembly: list[int],
        assembly_names: list[str],
        assembly_tax: list[tuple[int, int, int]],
        tax_names: dict[int, str] | None = None,
        *,
        k: int = 15,
        w: int = 10,
    ) -> "RefDB":
        index = MinimizerIndex.build(sequences, seq_names, k=k, w=w)
        sa = np.asarray(seq_assembly, np.int32)
        n_asm = len(assembly_names)
        lengths = np.zeros(n_asm, np.int64)
        for i, s in enumerate(sequences):
            lengths[sa[i]] += len(s)
        return RefDB(
            index=index,
            seq_assembly=sa,
            assembly_names=list(assembly_names),
            assembly_lengths=lengths,
            assembly_tax=np.asarray(assembly_tax, np.int64).reshape(n_asm, 3),
            tax_names=tax_names or {},
        )

    def subset(self, assembly_names: list[str]) -> "RefDB":
        """Restrict the DB to a genome set — the reference's config/ genome
        set mechanism (megapath_nano.py:720-729 read_genome_set)."""
        keep = [i for i, n in enumerate(self.assembly_names)
                if n in set(assembly_names)]
        if not keep:
            raise ValueError("genome set matches no assemblies")
        remap = {a: i for i, a in enumerate(keep)}
        idx = self.index
        seqs, names, seq_assembly = [], [], []
        for sid in range(len(idx.seq_names)):
            a = int(self.seq_assembly[sid])
            if a in remap:
                s0, s1 = int(idx.seq_offsets[sid]), int(idx.seq_offsets[sid + 1])
                seqs.append(idx.seq_data[s0:s1])
                names.append(idx.seq_names[sid])
                seq_assembly.append(remap[a])
        return RefDB.build(
            seqs, names, seq_assembly,
            [self.assembly_names[a] for a in keep],
            [tuple(self.assembly_tax[a]) for a in keep],
            self.tax_names, k=idx.k, w=idx.w)

    def data_integrity_check(self) -> list[str]:
        """Cross-validate the bundle (the reference's
        AssemblyMetadata.data_integrity_check, lib/assembly_metadata.py:
        250-320). Returns a list of problem descriptions (empty = clean)."""
        problems = []
        idx = self.index
        n_asm = len(self.assembly_names)
        if len(self.assembly_lengths) != n_asm:
            problems.append("assembly_lengths length mismatch")
        if self.assembly_tax.shape != (n_asm, 3):
            problems.append("assembly_tax shape mismatch")
        if len(self.seq_assembly) != len(idx.seq_names):
            problems.append("seq_assembly length != number of sequences")
        if len(self.seq_assembly) and (
                self.seq_assembly.min() < 0
                or self.seq_assembly.max() >= n_asm):
            problems.append("seq_assembly references unknown assembly")
        # per-assembly sequence lengths must sum to the recorded length
        sums = np.zeros(n_asm, np.int64)
        for sid in range(len(idx.seq_names)):
            sums[self.seq_assembly[sid]] += int(idx.seq_lengths[sid])
        bad = np.flatnonzero(sums != self.assembly_lengths)
        for a in bad:
            problems.append(
                f"assembly {self.assembly_names[a]}: sequence lengths sum "
                f"{sums[a]} != recorded {self.assembly_lengths[a]}")
        if idx.seq_data is not None and idx.seq_offsets is not None:
            if int(idx.seq_offsets[-1]) != len(idx.seq_data):
                problems.append("sequence offsets do not cover seq_data")
        if len(idx.keys) and not bool(np.all(np.diff(idx.keys.astype(
                np.uint64)) >= 0)):
            problems.append("minimizer keys not sorted")
        return problems

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        idx = self.index
        np.savez_compressed(
            os.path.join(path, "refdb.npz"),
            keys=idx.keys, positions=idx.positions,
            seq_lengths=idx.seq_lengths, seq_data=idx.seq_data,
            seq_offsets=idx.seq_offsets, seq_assembly=self.seq_assembly,
            assembly_lengths=self.assembly_lengths,
            assembly_tax=self.assembly_tax,
        )
        with open(os.path.join(path, "refdb.json"), "w") as f:
            json.dump({
                "k": idx.k, "w": idx.w,
                "seq_names": idx.seq_names,
                "assembly_names": self.assembly_names,
                "tax_names": {str(k): v for k, v in self.tax_names.items()},
            }, f)

    @staticmethod
    def load(path: str) -> "RefDB":
        z = np.load(os.path.join(path, "refdb.npz"))
        with open(os.path.join(path, "refdb.json")) as f:
            meta = json.load(f)
        index = MinimizerIndex(
            k=meta["k"], w=meta["w"], keys=z["keys"],
            positions=z["positions"], seq_lengths=z["seq_lengths"],
            seq_names=meta["seq_names"], seq_data=z["seq_data"],
            seq_offsets=z["seq_offsets"])
        return RefDB(
            index=index, seq_assembly=z["seq_assembly"],
            assembly_names=meta["assembly_names"],
            assembly_lengths=z["assembly_lengths"],
            assembly_tax=z["assembly_tax"],
            tax_names={int(k): v for k, v in meta["tax_names"].items()},
        )
