"""Protein-level AMR scan — the blastp-vs-CBMAR role (reference:
bin/megapath_nano_amr.py:60-62 prodigal -> blastp; :211-224 hydrolytic
profile extraction from family details by Uniprot ID).

Alignment is Smith-Waterman with BLOSUM62 + affine gaps (gap open 11 /
extend 1, blastp defaults) on the host: consensus ORFs and AMR proteins are
short (~10^2 aa) and few, so the DP is microseconds — the DNA read mapping
is where the GPU belongs.

The port's own copy of megapath_nano_tpu/amr/protein.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.amr.orf import AA_ALPHABET, ORF, aa_from_str

# BLOSUM62 over AA_ALPHABET order (ARNDCQEGHILKMFPSTWYV); public matrix.
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""

BLOSUM62 = np.full((22, 22), -4, np.int32)
_rows = [r.split() for r in _B62.strip().splitlines()]
for i in range(20):
    for j in range(20):
        BLOSUM62[i, j] = int(_rows[i][j])


def sw_protein(a: np.ndarray, b: np.ndarray, *, gap_open: int = 11,
               gap_extend: int = 1):
    """Local affine-gap protein alignment (vectorized over the b axis).
    Returns (score, a_begin, a_end, b_begin, b_end, n_ident, aligned_len)
    with coordinates end-exclusive; identity counted along the optimal path
    via a packed traceback."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return 0, 0, 0, 0, 0, 0, 0
    sub = BLOSUM62[a][:, b]                       # (n, m)
    NEG = -10 ** 6
    H = np.zeros(m + 1, np.int32)
    E = np.full(m + 1, NEG, np.int32)
    tb = np.zeros((n + 1, m + 1), np.uint8)       # 0 stop 1 diag 2 up 3 left
    best = (0, 0, 0)
    for i in range(1, n + 1):
        prev_diag = H.copy()
        E = np.maximum(E - gap_extend, H - gap_open - gap_extend)
        # F (left gaps) needs a sequential scan — do it with a prefix trick
        diag = prev_diag[:-1] + sub[i - 1]
        h_nf = np.maximum(diag, E[1:])
        h_nf = np.maximum(h_nf, 0)
        # F[j] = max over k<j of h[k] - go - ge*(j-k): running max scan
        F = np.full(m + 1, NEG, np.int32)
        run = NEG
        Hn = np.zeros(m + 1, np.int32)
        for j in range(1, m + 1):
            run = max(run - gap_extend, Hn[j - 1] - gap_open - gap_extend)
            F[j] = run
            h = max(h_nf[j - 1], F[j])
            Hn[j] = h
        H = Hn
        d = np.zeros(m + 1, np.uint8)
        d[1:] = np.where(H[1:] == 0, 0,
                         np.where(H[1:] == diag, 1,
                                  np.where(H[1:] == E[1:], 2, 3)))
        tb[i] = d
        jmax = int(np.argmax(H))
        if H[jmax] > best[0]:
            best = (int(H[jmax]), i, jmax)
    score, bi, bj = best
    if score <= 0:
        return 0, 0, 0, 0, 0, 0, 0
    # traceback for identity / spans
    i, j = bi, bj
    ident = alen = 0
    while i > 0 and j > 0:
        t = tb[i][j]
        if t == 0:
            break
        if t == 1:
            ident += int(a[i - 1] == b[j - 1])
            alen += 1
            i -= 1
            j -= 1
        elif t == 2:
            alen += 1
            j -= 1
        else:
            alen += 1
            i -= 1
    return score, i, bi, j, bj, ident, alen


@dataclass
class ProteinDB:
    """AMR protein database (CBMAR role): per-protein Uniprot accession +
    hydrolytic profile from the family-details table."""

    name: str
    protein_names: list[str]
    sequences: list[np.ndarray]            # amino-acid index arrays
    accessions: list[str] = field(default_factory=list)
    profiles: list[str] = field(default_factory=list)   # hydrolytic profile

    @staticmethod
    def from_records(name: str, records: list[tuple]) -> "ProteinDB":
        """records: (protein_name, aa_string, accession, profile)."""
        return ProteinDB(
            name,
            [r[0] for r in records],
            [aa_from_str(r[1]) for r in records],
            [r[2] for r in records],
            [r[3] for r in records])


@dataclass
class ProteinHit:
    db: str
    protein: str
    accession: str
    identity: float        # percent identity over the aligned span
    query_coverage: float  # fraction of the ORF aligned
    score: int
    orf_idx: int
    profile: str = ""


def scan_orfs(orfs: list[ORF], pdb: ProteinDB, *,
              min_identity: float = 90.0,
              min_query_coverage: float = 60.0) -> list[ProteinHit]:
    """blastp-equivalent scan: every ORF vs every DB protein, filtered by
    percent identity and query HSP coverage (blast_perc_identity /
    blast_qcov_hsp_perc, reference megapath_nano_amr.py:246-247)."""
    hits: list[ProteinHit] = []
    for oi, orf in enumerate(orfs):
        for pi, pseq in enumerate(pdb.sequences):
            score, qb, qe, tb_, te, ident, alen = sw_protein(orf.aa, pseq)
            if score <= 0 or alen == 0:
                continue
            pid = 100.0 * ident / alen
            qcov = 100.0 * (qe - qb) / max(len(orf.aa), 1)
            if pid >= min_identity and qcov >= min_query_coverage:
                hits.append(ProteinHit(
                    db=pdb.name, protein=pdb.protein_names[pi],
                    accession=pdb.accessions[pi] if pdb.accessions else "",
                    identity=pid, query_coverage=qcov, score=score,
                    orf_idx=oi,
                    profile=pdb.profiles[pi] if pdb.profiles else ""))
    hits.sort(key=lambda h: (-h.score, h.protein))
    return hits


def hydrolytic_profiles(hits: list[ProteinHit]) -> list[str]:
    """Distinct hydrolytic profiles of matched proteins — the
    cbmar_protein_blasted_hydrolytic_profile.txt content (reference
    megapath_nano_amr.py:211-224: family rows whose Uniprot ID appears in
    the blastp hits contribute their profile)."""
    return sorted({h.profile for h in hits if h.profile})
