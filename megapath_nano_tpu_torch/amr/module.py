"""AMR module driver: profile result -> consensus -> multi-DB scan -> report.

The reference forks megapath_nano_amr.py on the species-alignment BAM
(reference: bin/lib/aligner.py:250-256 spawn; bin/megapath_nano_amr.py:227
main). Here it's a library call on the profiler's outputs — the same best
alignments, no BAM round-trip.

The port's own copy of megapath_nano_tpu/amr/module.py: `device` (default
"cuda") takes the place of the original's DP `backend` and goes to every
gene-DB scan.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import require_device
from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.amr.consensus import (ConsensusContig,
                                                   consensus_contigs)
from megapath_nano_tpu_torch.amr.db import AMRGeneDB
from megapath_nano_tpu_torch.amr.report import (merge_results,
                                                 write_hydrolytic_profile,
                                                 write_results_csv)
from megapath_nano_tpu_torch.amr.scan import AMRHit, scan_contigs


@dataclass
class AMRResult:
    contigs: list[ConsensusContig]
    hits_by_db: dict[str, list[AMRHit]]
    merged: dict
    protein_hits: list = field(default_factory=list)
    hydrolytic_profiles: list = field(default_factory=list)

    def write(self, out_dir: str, prefix: str = "amr") -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{prefix}.results.csv")
        write_results_csv(path, self.merged, sorted(self.hits_by_db))
        if self.hydrolytic_profiles:
            write_hydrolytic_profile(
                os.path.join(
                    out_dir,
                    f"{prefix}.cbmar_protein_blasted_hydrolytic_profile"
                    ".txt"),
                self.hydrolytic_profiles)
        return path


def run_amr(
    best_align: AlignList,
    reads: list[np.ndarray],
    target_seqs: dict[int, np.ndarray],     # sequence_id -> numeric seq
    dbs: list[AMRGeneDB],
    *,
    min_depth: int = 1,
    min_identity: float = 0.90,
    min_coverage: float = 0.60,
    device="cuda",
    organism: str | None = None,
    protein_db=None,
) -> AMRResult:
    """Build consensus over every aligned target sequence, scan all DBs.

    organism gates taxon-restricted genes (AMRFinder --taxon,
    megapath_nano_amr.py:53-56). protein_db (amr.protein.ProteinDB) enables
    the CBMAR protein path: 6-frame ORFs from the consensus contigs are
    aligned against the protein DB (blastp role, :60-62) and matched
    families' hydrolytic profiles are collected (:211-224)."""
    require_device(device, "run_amr")
    contigs: list[ConsensusContig] = []
    for seq_id in np.unique(best_align.data["sequence_id"]):
        ref = target_seqs.get(int(seq_id))
        if ref is None:
            continue
        contigs.extend(consensus_contigs(best_align, reads, int(seq_id), ref,
                                         min_depth=min_depth))
    hits_by_db = {
        db.name: scan_contigs(contigs, db, min_identity=min_identity,
                              min_coverage=min_coverage, device=device,
                              organism=organism)
        for db in dbs
    }
    protein_hits: list = []
    profiles: list[str] = []
    if protein_db is not None and contigs:
        from megapath_nano_tpu_torch.amr.orf import find_orfs
        from megapath_nano_tpu_torch.amr.protein import (
            hydrolytic_profiles, scan_orfs)
        from megapath_nano_tpu_torch.amr.scan import AMRHit as _Hit

        orfs = []
        for c in contigs:
            orfs.extend(find_orfs(c.seq))
        protein_hits = scan_orfs(orfs, protein_db,
                                 min_identity=100 * min_identity,
                                 min_query_coverage=100 * min_coverage)
        profiles = hydrolytic_profiles(protein_hits)
        # protein hits join the merged table as BETALACTAMASE rows, the
        # reference's CBMAR drug constant (megapath_nano_amr.py:145-148)
        hits_by_db.setdefault(protein_db.name, [])
        hits_by_db[protein_db.name] += [
            _Hit(db=protein_db.name, gene=h.protein, gene_idx=-1,
                 identity=h.identity / 100.0,
                 gene_coverage=h.query_coverage / 100.0, score=h.score,
                 contig_idx=-1, drugs=["BETALACTAMASE"],
                 accession=h.accession)
            for h in protein_hits]
    return AMRResult(contigs, hits_by_db, merge_results(hits_by_db),
                     protein_hits, profiles)
