"""Port parity for SAM/BAM I/O (megapath_nano_tpu_torch io/sam.py and
io/bgzf.py against the TPU package's copies), on the worlds of
tests/test_sam_io.py: a SAM or BAM written by either package reads back, in
the other, into equal records; the port's BAM is byte-equal to the TPU
package's (same zlib level, same BGZF blocking, MTIME 0); the alignments
rebuilt from the records, and the AMR pileup over them, are equal field for
field. All values are integers or strings, so the tolerance is 0."""

import dataclasses
import gzip

import numpy as np
import pytest

from megapath_nano_tpu.align.pipeline import AlignParams, MinimizerAligner
from megapath_nano_tpu.amr import consensus as jconsensus
from megapath_nano_tpu.index.minimizer import MinimizerIndex
from megapath_nano_tpu.io import bgzf as jbgzf
from megapath_nano_tpu.io import sam as jsam
from megapath_nano_tpu.report import samout as jsamout
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.align.records import AlignList as TAlignList
from megapath_nano_tpu_torch.amr import consensus as tconsensus
from megapath_nano_tpu_torch.io import bgzf as tbgzf
from megapath_nano_tpu_torch.io import sam as tsam
from megapath_nano_tpu_torch.report import samout as tsamout
from test_torch_profiler import assert_align_lists_equal


@pytest.fixture(scope="module")
def mapped():
    """tests/test_sam_io.py's world: 24 reads of 800 b on two genomes of
    20 kb, a third reverse-complemented, mapped with CIGARs by the TPU
    package; the same AlignList in each package's type."""
    rng = np.random.default_rng(11)
    genomes = [random_sequence(rng, 20000) for _ in range(2)]
    index = MinimizerIndex.build(genomes, ["gA", "gB"])
    aligner = MinimizerAligner(index, params=AlignParams(backend="jnp"))
    reads = []
    for i in range(24):
        g = i % 2
        s = int(rng.integers(0, 19000))
        rd = mutate(rng, genomes[g][s: s + 800], 0.02, 0.01, 0.01)
        if i % 3 == 0:
            rd = revcomp(rd)
        reads.append(rd)
    al = aligner.map_reads(reads, [f"r{i}" for i in range(24)],
                           emit_cigars=True)
    assert len(al.data) and al.cigar_map
    tal = TAlignList(al.data.copy(), list(al.sequence_names),
                     list(al.assembly_names), list(al.read_names),
                     dict(al.cigar_map))
    return al, tal, reads, index.seq_lengths


def _assert_records_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert type(rb).__name__ == "SamRecord"
        for f in dataclasses.fields(ra):
            x, y = getattr(ra, f.name), getattr(rb, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def _read_both(reader, path):
    (jrefs, jrecs), (trefs, trecs) = (getattr(jsam, reader)(path),
                                      getattr(tsam, reader)(path))
    assert jrefs == trefs
    _assert_records_equal(jrecs, trecs)
    return jrefs, jrecs, trecs


def test_sam_written_by_either_reads_equal_in_both(tmp_path, mapped):
    al, tal, reads, seq_lengths = mapped
    jsamout.write_sam(str(tmp_path / "j.sam"), al, reads, seq_lengths)
    tsamout.write_sam(str(tmp_path / "t.sam"), tal, reads, seq_lengths)
    _, jrecs, _ = _read_both("read_sam", str(tmp_path / "j.sam"))
    _, trecs, _ = _read_both("read_sam", str(tmp_path / "t.sam"))
    assert len(jrecs) == len(al.data)
    _assert_records_equal(jrecs, trecs)


def test_bam_byte_equal_and_read_in_both(tmp_path, mapped):
    al, tal, reads, seq_lengths = mapped
    jsam.write_bam(str(tmp_path / "j.bam"), al, reads, seq_lengths)
    tsam.write_bam(str(tmp_path / "t.bam"), tal, reads, seq_lengths)
    jb, tb = ((tmp_path / n).read_bytes() for n in ("j.bam", "t.bam"))
    assert jb == tb and jb.startswith(b"\x1f\x8b\x08\x04")
    _, recs, _ = _read_both("read_bam", str(tmp_path / "t.bam"))
    assert len(recs) == len(al.data)
    # BGZF: several blocks and the EOF marker, as the TPU package blocks
    big = bytes(range(256)) * 700
    assert tbgzf.bgzf_compress(big) == jbgzf.bgzf_compress(big)
    assert gzip.decompress(tbgzf.bgzf_compress(big)) == big


def test_alignments_from_records_equal(tmp_path, mapped):
    """The AlignList and reads rebuilt from a BAM, and the AMR pileup over
    them (the cli.amr --query_bam path)."""
    al, tal, reads, seq_lengths = mapped
    jsam.write_bam(str(tmp_path / "q.bam"), al, reads, seq_lengths)
    refs, jrecs, trecs = _read_both("read_bam", str(tmp_path / "q.bam"))
    jback, jreads = jsam.alignments_from_records(refs, jrecs)
    tback, treads = tsam.alignments_from_records(refs, trecs)
    assert_align_lists_equal(jback, tback, "from_records")
    assert len(jreads) == len(treads) == len(reads)
    for x, y in zip(jreads, treads):
        np.testing.assert_array_equal(x, y)
    for sid in (0, 1):
        jc = jconsensus.pileup_counts(jback, jreads, sid, 20000)
        tc = tconsensus.pileup_counts(tback, treads, sid, 20000)
        assert jc.dtype == tc.dtype and jc.sum() > 0
        np.testing.assert_array_equal(jc, tc)


def test_sam_gz_and_unmapped_equal(tmp_path):
    sam = ("@SQ\tSN:chr1\tLN:100\n"
           "u1\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
           "m1\t0\tchr1\t11\t60\t2S3M1I2M\t*\t0\t0\tAACGTACG\tIIIIIIII"
           "\tNM:i:1\tAS:i:9\n"
           "s1\t272\tchr1\t20\t0\t4M\t*\t0\t0\t*\t*\n"
           "m2\t16\tchr1\t40\t30\t3=1X4M2D1M\t*\t0\t0\tACGTACGTA\t*"
           "\tNM:i:3\n")
    p = tmp_path / "t.sam.gz"
    with gzip.open(p, "wt") as f:
        f.write(sam)
    refs, jrecs, trecs = _read_both("read_sam", str(p))
    assert trecs[0].is_unmapped and trecs[2].is_secondary_or_supplementary
    jal, jr = jsam.alignments_from_records(refs, jrecs)
    tal, tr = tsam.alignments_from_records(refs, trecs)
    assert len(tal.data) == 2
    assert_align_lists_equal(jal, tal, "gz")
    for x, y in zip(jr, tr):
        np.testing.assert_array_equal(x, y)
