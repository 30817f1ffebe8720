"""Six-frame ORF finding on consensus contigs — the prodigal role in the
reference's CBMAR protein path (reference: bin/megapath_nano_amr.py:60-62:
`prodigal -p meta` -> cns.prot.fa -> blastp vs CBMAR proteins). A full gene
model is not needed for database matching; ORFs between start and stop
codons above a minimum length reproduce the discoverable protein set.

The port's own copy of megapath_nano_tpu/amr/orf.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.utils.dna import revcomp

# codon -> amino acid over the 2-bit base codes (A=0 C=1 G=2 T=3).
# 20 residues indexed by AA_ALPHABET position; 20 = stop, 21 = X/unknown.
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYV"
AA_STOP = 20
AA_X = 21

_CODON_TABLE_STR = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}
CODON_AA = np.full(64, AA_X, np.int8)
for codon, aa in _CODON_TABLE_STR.items():
    i = _BASE[codon[0]] * 16 + _BASE[codon[1]] * 4 + _BASE[codon[2]]
    CODON_AA[i] = AA_STOP if aa == "*" else AA_ALPHABET.index(aa)


def translate(codes: np.ndarray) -> np.ndarray:
    """2-bit DNA codes -> amino-acid indices (len//3); codons containing
    N (code > 3) become X."""
    n = len(codes) // 3
    c = codes[: n * 3].reshape(n, 3).astype(np.int64)
    bad = (c > 3).any(axis=1)
    idx = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
    aa = CODON_AA[np.clip(idx, 0, 63)]
    return np.where(bad, np.int8(AA_X), aa).astype(np.int8)


def aa_to_str(aa: np.ndarray) -> str:
    return "".join(AA_ALPHABET[a] if a < 20 else ("*" if a == AA_STOP
                                                  else "X") for a in aa)


def aa_from_str(s: str) -> np.ndarray:
    lut = {c: i for i, c in enumerate(AA_ALPHABET)}
    return np.array([lut.get(c.upper(), AA_X) for c in s], np.int8)


@dataclass
class ORF:
    start: int        # contig coordinates of the coding span (fwd strand)
    end: int
    strand: int       # 0 = forward, 1 = reverse
    frame: int        # 0..2 within the strand
    aa: np.ndarray    # amino-acid indices, stop not included


def find_orfs(seq: np.ndarray, *, min_aa: int = 60) -> list[ORF]:
    """All ORFs >= min_aa residues across 6 frames. An ORF runs from an ATG
    to the next stop; open ends at the contig boundary are kept (partial
    genes on consensus fragments are common)."""
    out: list[ORF] = []
    n = len(seq)
    for strand, codes in ((0, seq), (1, revcomp(seq))):
        for frame in range(3):
            aa = translate(codes[frame:])
            if len(aa) == 0:
                continue
            stops = np.flatnonzero(aa == AA_STOP)
            bounds = np.concatenate([[-1], stops, [len(aa)]])
            for b in range(len(bounds) - 1):
                s_aa, e_aa = int(bounds[b]) + 1, int(bounds[b + 1])
                if e_aa - s_aa < min_aa:
                    continue
                # prefer the first ATG; fall back to the open start
                seg = aa[s_aa:e_aa]
                starts = np.flatnonzero(seg == AA_ALPHABET.index("M"))
                if len(starts) and e_aa - (s_aa + int(starts[0])) >= min_aa:
                    s_aa = s_aa + int(starts[0])
                    seg = aa[s_aa:e_aa]
                lo = frame + 3 * s_aa
                hi = frame + 3 * e_aa
                if strand == 0:
                    start, end = lo, min(hi, n)
                else:
                    start, end = max(n - hi, 0), n - lo
                out.append(ORF(start=start, end=end, strand=strand,
                               frame=frame, aa=seg))
    out.sort(key=lambda o: (-len(o.aa), o.start))
    return out
