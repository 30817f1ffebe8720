"""AMR database scan: consensus contigs vs gene DBs.

Reproduces the database-matching core of the reference's 5 AMR tools
(reference: bin/megapath_nano_amr.py:48-70) with the framework's own
alignment engine: each consensus contig is mapped against the gene DB index;
per gene, hits are kept at >= min_identity and gene coverage >= min_coverage
(defaults 90% / 60%, megapath_nano_amr.py:246-247).

The port's own copy of megapath_nano_tpu/amr/scan.py: the aligner maps on
the caller's `device` (the GPU unless the caller asks for "cpu"), where the
original took a DP `backend`. It maps every contig in one CIGAR-mode call,
so the scan runs the chain and the score-only extension kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                    MinimizerAligner,
                                                    require_device)
from megapath_nano_tpu_torch.amr.consensus import ConsensusContig
from megapath_nano_tpu_torch.amr.db import AMRGeneDB


@dataclass
class AMRHit:
    db: str
    gene: str
    gene_idx: int
    identity: float
    gene_coverage: float
    score: int
    contig_idx: int
    drugs: list[str]
    accession: str = ""


def scan_contigs(
    contigs: list[ConsensusContig],
    db: AMRGeneDB,
    *,
    min_identity: float = 0.90,
    min_coverage: float = 0.60,
    device="cuda",
    organism: str | None = None,
) -> list[AMRHit]:
    """organism enables taxon-restricted genes (AMRFinder --taxon gating,
    reference megapath_nano_amr.py:53-56): a gene carrying a taxon
    restriction in db.taxa is reported only when organism matches."""
    require_device(device, "scan_contigs")
    if not contigs:
        return []
    index = db.index()
    # BLAST-like scan keeps every locus above the cutoffs, not just
    # primaries — equivalent of minimap2 -p 0
    params = AlignParams(min_chain_score=20, min_group_anchors=2, band=256,
                         secondary_ratio=0.0)
    aligner = MinimizerAligner(index, params=params, device=device)
    result = aligner.map_reads([c.seq for c in contigs])

    # aggregate per (gene): best identity, total gene coverage
    hits: dict[int, dict] = {}
    gene_lens = index.seq_lengths
    for row in result.data:
        g = int(row["sequence_id"])
        aligned = int(row["sequence_to"] - row["sequence_from"])
        ident = row["match"] / aligned if aligned > 0 else 0.0
        h = hits.setdefault(g, {
            "cov_bp": 0, "ident_num": 0, "ident_den": 0, "score": 0,
            "contig": int(row["read_id"]),
        })
        h["cov_bp"] += aligned
        h["ident_num"] += int(row["match"])
        h["ident_den"] += aligned
        h["score"] = max(h["score"], int(row["alignment_score"]))

    out = []
    for g, h in hits.items():
        glen = int(gene_lens[g])
        cov = min(h["cov_bp"] / glen, 1.0) if glen else 0.0
        ident = h["ident_num"] / h["ident_den"] if h["ident_den"] else 0.0
        if ident >= min_identity and cov >= min_coverage:
            taxon = db.taxa[g] if g < len(db.taxa) else None
            if taxon and (not organism
                          or taxon.lower() not in organism.lower()):
                continue
            out.append(AMRHit(
                db=db.name, gene=db.gene_names[g], gene_idx=g,
                identity=ident, gene_coverage=cov, score=h["score"],
                contig_idx=h["contig"], drugs=db.drugs[g],
                accession=db.accessions[g]
                if g < len(db.accessions) else ""))
    out.sort(key=lambda x: (-x.score, x.gene))
    return out
