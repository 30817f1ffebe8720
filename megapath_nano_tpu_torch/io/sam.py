"""SAM / BAM readers — alignment-file interop.

The reference vendors samtools and passes BAMs between stages
(reference: bin/megapath_nano_amr.py:240-255 takes --query_bam;
bin/lib/get_highestAS_read_match_target.py reads a BAM via pysam). This
framework exchanges alignments in-process, but accepts the reference's
on-disk formats at its boundaries: read_sam/read_bam parse either format
into records, and alignments_from_records rebuilds the framework's
AlignList (+ CIGAR map + reads) so any consumer — AMR consensus, variant
candidates, the amplicon screen — can start from a file produced by the
reference toolchain.

BAM note: BAM is BGZF — a sequence of gzip members — which Python's gzip
module decompresses natively (multi-member streams are supported); the
binary record layout follows the SAM spec v1.6 §4.2.

The port's own copy of megapath_nano_tpu/io/sam.py.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE, AlignList
from megapath_nano_tpu_torch.utils.dna import encode, revcomp

_CIGAR_OPS = "MIDNSHP=X"
# BAM 4-bit base nibbles (SAM spec): =ACMGRSVTWYHKDBN → framework codes
_NIB_CODE = np.full(16, 4, np.int8)
for _i, _b in enumerate("=ACMGRSVTWYHKDBN"):
    _NIB_CODE[_i] = {"A": 0, "C": 1, "G": 2, "T": 3}.get(_b, 4)


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str          # "*" if unmapped
    pos: int            # 0-based leftmost mapping position
    mapq: int
    cigar: list         # [(length, op_char)] — empty if "*"
    seq: np.ndarray     # numeric codes AS STORED (oriented), empty if "*"
    qual: np.ndarray    # phred ints, empty if "*"
    tags: dict = field(default_factory=dict)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4) or self.rname == "*"

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def is_secondary_or_supplementary(self) -> bool:
        return bool(self.flag & (256 | 2048))


def _parse_cigar(s: str) -> list:
    out = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, ch))
            n = 0
    return out


def _parse_tag(field_: str):
    name, typ, val = field_.split(":", 2)
    if typ in ("i", "I"):
        return name, int(val)
    if typ == "f":
        return name, float(val)
    return name, val


def read_sam(path: str):
    """Parse a SAM text file (.sam or .sam.gz).

    Returns (references, records): references = {name: length} from @SQ
    lines; records = list[SamRecord]."""
    op = gzip.open if path.endswith(".gz") else open
    refs: dict[str, int] = {}
    records: list[SamRecord] = []
    with op(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    d = dict(p.split(":", 1) for p in line.split("\t")[1:]
                             if ":" in p)
                    if "SN" in d:
                        refs[d["SN"]] = int(d.get("LN", 0))
                continue
            parts = line.split("\t")
            if len(parts) < 11:
                continue
            seq = (encode(parts[9]) if parts[9] != "*"
                   else np.zeros(0, np.int8))
            qual = (np.frombuffer(parts[10].encode(), np.uint8).astype(
                np.int8) - 33 if parts[10] != "*" else np.zeros(0, np.int8))
            tags = dict(_parse_tag(t) for t in parts[11:] if t.count(":") >= 2)
            records.append(SamRecord(
                qname=parts[0], flag=int(parts[1]), rname=parts[2],
                pos=int(parts[3]) - 1, mapq=int(parts[4]),
                cigar=(_parse_cigar(parts[5]) if parts[5] != "*" else []),
                seq=seq, qual=qual, tags=tags))
    return refs, records


def _bam_tags(buf: bytes) -> dict:
    tags = {}
    i = 0
    n = len(buf)
    sizes = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    fmts = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
            "I": "<I", "f": "<f"}
    while i + 3 <= n:
        name = buf[i: i + 2].decode()
        typ = chr(buf[i + 2])
        i += 3
        if typ in sizes:
            tags[name] = struct.unpack_from(fmts[typ], buf, i)[0]
            i += sizes[typ]
        elif typ in ("Z", "H"):
            j = buf.index(b"\x00", i)
            tags[name] = buf[i:j].decode()
            i = j + 1
        elif typ == "A":
            tags[name] = chr(buf[i])
            i += 1
        elif typ == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<i", buf, i + 1)[0]
            i += 5
            step = sizes.get(sub, 4)
            vals = [struct.unpack_from(fmts[sub], buf, i + k * step)[0]
                    for k in range(cnt)]
            tags[name] = vals
            i += cnt * step
        else:
            break  # unknown tag type: stop parsing this record's tags
    return tags


def read_bam(path: str):
    """Parse a BAM file. Returns (references, records) like read_sam."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file (bad magic)")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names: list[str] = []
    refs: dict[str, int] = {}
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        name = data[off: off + l_name - 1].decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(name)
        refs[name] = l_ref
    records: list[SamRecord] = []
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from(
            "<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p: p + l_read_name - 1].decode()
        p += l_read_name
        cigar = []
        for _ in range(n_cigar):
            (v,) = struct.unpack_from("<I", data, p)
            cigar.append((v >> 4, _CIGAR_OPS[v & 15]))
            p += 4
        nb = (l_seq + 1) // 2
        packed = np.frombuffer(data, np.uint8, nb, p)
        codes = np.empty(nb * 2, np.int8)
        codes[0::2] = _NIB_CODE[packed >> 4]
        codes[1::2] = _NIB_CODE[packed & 15]
        seq = codes[:l_seq]
        p += nb
        qual = np.frombuffer(data, np.int8, l_seq, p).copy()
        if l_seq and qual[0] == -1:       # 0xFF = absent
            qual = np.zeros(0, np.int8)
        p += l_seq
        tags = _bam_tags(data[p:end])
        records.append(SamRecord(
            qname=qname, flag=flag,
            rname=(ref_names[ref_id] if 0 <= ref_id < n_ref else "*"),
            pos=pos, mapq=mapq, cigar=cigar, seq=seq, qual=qual, tags=tags))
        off = end
    return refs, records


def alignments_from_records(refs: dict, records: list,
                            tax_lookup=None) -> tuple:
    """Rebuild (AlignList with cigar_map, reads) from SAM/BAM records.

    Primary mapped records only (secondary/supplementary lack SEQ in most
    producers). match/edit come from the CIGAR + NM tag; alignment_score
    from AS when present. tax_lookup: optional fn(rname) ->
    (tax, species, genus) ids."""
    seq_names = list(refs)
    seq_index = {s: i for i, s in enumerate(seq_names)}
    seq_lengths = np.array([refs[s] for s in seq_names], np.int64)
    read_ids: dict[str, int] = {}
    reads: list[np.ndarray] = []
    read_names: list[str] = []
    rows = []
    cigar_map: dict = {}
    for rec in records:
        if rec.is_unmapped or rec.is_secondary_or_supplementary:
            continue
        if len(rec.seq) == 0 or rec.rname not in seq_index:
            continue
        if rec.qname not in read_ids:
            read_ids[rec.qname] = len(reads)
            reads.append(revcomp(rec.seq) if rec.is_reverse else rec.seq)
            read_names.append(rec.qname)
        rid = read_ids[rec.qname]
        sid = seq_index[rec.rname]
        strand = 1 if rec.is_reverse else 0
        lead = rec.cigar[0][0] if rec.cigar and rec.cigar[0][1] in "SH" else 0
        core = [(ln, op) for ln, op in rec.cigar if op in "MID=X"]
        core = [(ln, "M" if op in "=X" else op) for ln, op in core]
        qspan = sum(ln for ln, op in core if op in "MI")
        tspan = sum(ln for ln, op in core if op in "MD")
        qlen = len(rec.seq)
        nm = int(rec.tags.get("NM", 0))
        n_match = max(sum(ln for ln, op in core if op == "M") - nm, 0)
        score = int(rec.tags.get("AS", n_match))
        ob, oe = lead, lead + qspan - 1
        if strand == 0:
            read_from, read_to = ob, oe + 1
        else:
            read_from, read_to = qlen - (oe + 1), qlen - ob
        tax = tax_lookup(rec.rname) if tax_lookup else (0, 0, 0)
        rows.append((rid, qlen, read_from, read_to, strand, sid,
                     int(seq_lengths[sid]), rec.pos, rec.pos + tspan,
                     n_match, rec.mapq, nm, score, sid,
                     tax[0], tax[1], tax[2], 0.0))
        cigar_map[(rid, sid)] = (core, lead, strand)
    data = np.array(rows, ALIGN_DTYPE)
    order = np.lexsort((data["sequence_id"], data["read_id"]))
    return (AlignList(data[order], seq_names, list(seq_names), read_names,
                      cigar_map), reads)


def _bam_encode_record(rec_qname: str, flag: int, ref_id: int, pos: int,
                       mapq: int, cigar: list, seq: np.ndarray,
                       qual: np.ndarray, tags: bytes) -> bytes:
    name = rec_qname.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
                   for ln, op in cigar)
    l_seq = len(seq)
    # framework codes -> BAM nibbles: A=1 C=2 G=4 T=8 N=15
    nib = np.array([1, 2, 4, 8, 15], np.uint8)[np.clip(seq, 0, 4)]
    if l_seq % 2:
        nib = np.append(nib, 0)
    packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
    q = (qual.astype(np.uint8).tobytes() if len(qual) == l_seq
         else b"\xff" * l_seq)
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name), mapq,
                       4680, len(cigar), flag, l_seq, -1, -1, 0)
    body += name + cig + packed + q + tags
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, align_list: AlignList, reads: list,
              seq_lengths: np.ndarray) -> None:
    """Best-alignment BAM (BGZF container), mirroring report.samout.write_sam
    — the reference's .species.bam output (megapath_nano.py step 27 /
    lib/aligner.py:249-252 samtools view|sort)."""
    from megapath_nano_tpu_torch.io.bgzf import write_bgzf

    names = align_list.sequence_names
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{int(seq_lengths[i])}\n"
        for i, n in enumerate(names))
    out = [b"BAM\x01", struct.pack("<i", len(text)), text.encode(),
           struct.pack("<i", len(names))]
    for i, n in enumerate(names):
        nb = n.encode() + b"\x00"
        out.append(struct.pack("<i", len(nb)) + nb +
                   struct.pack("<i", int(seq_lengths[i])))
    cmap = align_list.cigar_map or {}
    for row in align_list.data:
        rid = int(row["read_id"])
        sid = int(row["sequence_id"])
        read = reads[rid]
        strand = int(row["strand"])
        oriented = revcomp(read) if strand else read
        entry = cmap.get((rid, sid))
        if entry is not None:
            core, lead, _ = entry
            tail = len(read) - lead - sum(ln for ln, op in core
                                          if op in "MI")
            cigar = ([(lead, "S")] if lead > 0 else []) + list(core) + \
                ([(tail, "S")] if tail > 0 else [])
        else:
            cigar = [(len(read), "M")]
        qname = (align_list.read_names[rid]
                 if rid < len(align_list.read_names) else f"read{rid}")
        tags = (b"NMi" + struct.pack("<i", int(row["edit_dist"])) +
                b"ASi" + struct.pack("<i", int(row["alignment_score"])))
        out.append(_bam_encode_record(
            qname, 16 if strand else 0, sid, int(row["sequence_from"]),
            int(row["mapq"]), cigar, oriented, np.zeros(0, np.int8), tags))
    write_bgzf(path, b"".join(out))
