"""SAM / PAF writers for alignment outputs.

The reference keeps minimap2's SAM for the species placement and derives a
PAF from it (.species.sam/.bam/.paf outputs, reference: bin/lib/aligner.py:
245-261, megapath_nano.py step_format_output). Here the same records are
emitted directly from the AlignList (+ its CIGAR map). The port's own copy of
megapath_nano_tpu/report/samout.py; the output differs only in the @PG line,
which names this package.
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.utils.dna import decode, revcomp


def write_sam(
    path: str,
    align_list: AlignList,
    reads: list[np.ndarray],
    seq_lengths: np.ndarray,
) -> None:
    """Best-alignment SAM (one record per align_list row with a CIGAR)."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for sid, name in enumerate(align_list.sequence_names):
            f.write(f"@SQ\tSN:{name}\tLN:{int(seq_lengths[sid])}\n")
        f.write("@PG\tID:mpn-torch\tPN:megapath_nano_tpu_torch\n")
        cmap = align_list.cigar_map or {}
        for row in align_list.data:
            rid = int(row["read_id"])
            sid = int(row["sequence_id"])
            entry = cmap.get((rid, sid, int(row["sequence_from"])),
                             cmap.get((rid, sid)))
            read = reads[rid]
            strand = int(row["strand"])
            flag = 16 if strand else 0
            oriented = revcomp(read) if strand else read
            qname = (align_list.read_names[rid]
                     if rid < len(align_list.read_names) else f"read{rid}")
            rname = align_list.sequence_names[sid]
            pos = int(row["sequence_from"]) + 1
            mapq = int(row["mapq"])
            if entry is not None:
                cigar_ops, oriented_from, _ = entry
                lead = oriented_from
                tail = len(read) - lead - sum(
                    l for l, op in cigar_ops if op in "MI")
                cigar = ""
                if lead > 0:
                    cigar += f"{lead}S"
                cigar += "".join(f"{l}{op}" for l, op in cigar_ops)
                if tail > 0:
                    cigar += f"{tail}S"
            else:
                cigar = f"{len(read)}M"
            seq = decode(oriented)
            f.write(f"{qname}\t{flag}\t{rname}\t{pos}\t{mapq}\t{cigar}\t*\t0"
                    f"\t0\t{seq}\t*\tNM:i:{int(row['edit_dist'])}"
                    f"\tAS:i:{int(row['alignment_score'])}\n")


def write_paf(path: str, align_list: AlignList) -> None:
    """PAF records (minimap2's 12 mandatory columns + NM/AS tags)."""
    with open(path, "w") as f:
        for row in align_list.data:
            rid = int(row["read_id"])
            qname = (align_list.read_names[rid]
                     if rid < len(align_list.read_names) else f"read{rid}")
            sid = int(row["sequence_id"])
            strand = "-" if row["strand"] else "+"
            block = int(row["sequence_to"] - row["sequence_from"])
            f.write("\t".join(map(str, [
                qname, int(row["read_length"]), int(row["read_from"]),
                int(row["read_to"]), strand,
                align_list.sequence_names[sid], int(row["sequence_length"]),
                int(row["sequence_from"]), int(row["sequence_to"]),
                int(row["match"]), block, int(row["mapq"]),
                f"NM:i:{int(row['edit_dist'])}",
                f"AS:i:{int(row['alignment_score'])}",
            ])) + "\n")
