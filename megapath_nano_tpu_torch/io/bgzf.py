"""BGZF (blocked gzip) writer — the container format of BAM files.

The reference ships BAMs produced by samtools (reference:
bin/lib/aligner.py:249-252 samtools view|sort). BGZF is a sequence of gzip
members, each ≤ 64 KiB, carrying a 'BC' extra subfield with the compressed
block size, terminated by a fixed empty EOF block (SAM spec v1.6 §4.1).
Reading needs no special code (gzip handles multi-member streams); writing
is here.

The port's own copy of megapath_nano_tpu/io/bgzf.py.
"""

from __future__ import annotations

import struct
import zlib

_MAX_RAW = 65280          # keep compressed block safely under 64 KiB
_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _block(raw: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(raw) + comp.flush()
    bsize = 18 + len(cdata) + 8          # header + payload + crc + isize
    # magic+CM+FLG(FEXTRA) | MTIME=0 | XFL=0 | OS=0xff | XLEN=6 | BC subfield
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 5 +
              b"\xff\x06\x00BC\x02\x00" + struct.pack("<H", bsize - 1))
    return header + cdata + struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF,
                                        len(raw))


def bgzf_compress(data: bytes) -> bytes:
    """Whole-buffer BGZF encoding (blocks + EOF marker)."""
    out = []
    for i in range(0, len(data), _MAX_RAW):
        out.append(_block(data[i: i + _MAX_RAW]))
    out.append(_EOF)
    return b"".join(out)


def write_bgzf(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(bgzf_compress(data))
