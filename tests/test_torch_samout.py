"""Port parity: megapath_nano_tpu_torch.report.samout's SAM and PAF files
against the TPU package's on the same alignments, byte for byte apart from
the @PG header line, which names the writing package."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align import pipeline as jp
from megapath_nano_tpu.index.minimizer import MinimizerIndex
from megapath_nano_tpu.report import samout as jsam
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.report import samout as tsam
from megapath_nano_tpu_torch.state import index_from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mapped():
    rng = np.random.default_rng(31)
    genomes = [random_sequence(rng, 12000) for _ in range(2)]
    reads = []
    for i in range(20):
        g = int(rng.integers(0, 2))
        s = int(rng.integers(0, 12000 - 600))
        read = mutate(rng, genomes[g][s: s + 600], sub_rate=0.03,
                      ins_rate=0.015, del_rate=0.015)
        if i % 5 == 0:    # soft-clipped ends: unrelated flanks
            read = np.concatenate([random_sequence(rng, 40), read,
                                   random_sequence(rng, 25)])
        if rng.integers(0, 2):
            read = revcomp(read)
        reads.append(read)
    reads.append(random_sequence(rng, 300))      # unmapped
    names = [f"read_{i}" for i in range(len(reads) - 3)]  # some unnamed
    jidx = MinimizerIndex.build(genomes, ["chrA", "chrB"])
    ref = jp.MinimizerAligner(jidx, params=jp.AlignParams(
        backend="jnp")).map_reads(reads, read_names=names)
    got = tp.MinimizerAligner(index_from_numpy(jidx), device="cpu").map_reads(
        reads, read_names=names)
    return jidx, reads, ref, got


def _strip_pg(data: bytes):
    lines = data.split(b"\n")
    return [ln for ln in lines if not ln.startswith(b"@PG")], \
        [ln for ln in lines if ln.startswith(b"@PG")]


@pytest.mark.parametrize("with_cigars", [True, False])
def test_sam_bytes_equal(mapped, tmp_path, with_cigars):
    jidx, reads, ref, got = mapped
    if not with_cigars:      # PAF-mode lists fall back to <len>M
        ref = type(ref)(ref.data, ref.sequence_names, ref.assembly_names,
                        ref.read_names, None)
        got = type(got)(got.data, got.sequence_names, got.assembly_names,
                        got.read_names, None)
    jsam.write_sam(str(tmp_path / "j.sam"), ref, reads, jidx.seq_lengths)
    tsam.write_sam(str(tmp_path / "t.sam"), got, reads, jidx.seq_lengths)
    jbody, jpg = _strip_pg((tmp_path / "j.sam").read_bytes())
    tbody, tpg = _strip_pg((tmp_path / "t.sam").read_bytes())
    assert tbody == jbody
    assert len(jpg) == len(tpg) == 1
    assert tpg[0] == b"@PG\tID:mpn-torch\tPN:megapath_nano_tpu_torch"
    records = [ln for ln in tbody if ln and not ln.startswith(b"@")]
    assert len(records) == len(got) >= 18
    if with_cigars:
        assert any(b"S" in ln.split(b"\t")[5] for ln in records)


def test_paf_bytes_equal(mapped, tmp_path):
    _jidx, _reads, ref, got = mapped
    jsam.write_paf(str(tmp_path / "j.paf"), ref)
    tsam.write_paf(str(tmp_path / "t.paf"), got)
    data = (tmp_path / "t.paf").read_bytes()
    assert data == (tmp_path / "j.paf").read_bytes()
    assert data.count(b"\n") == len(got)
