"""Port parity: the device part of the map path (megapath_nano_tpu_torch
align/pipeline.py, kernels' plain versions on the CPU) against the TPU
package's align/pipeline.py with backend="jnp". Every output is an integer:
exact equality of the window gathers, of _fused_tail's rows and counts, and
of one slice's uint16 row matrix from both fused dispatches."""

import functools

import jax
import numpy as np
import pytest
import torch

from megapath_nano_tpu.align import pipeline as jp
from megapath_nano_tpu.align.anchors import collect_anchors
from megapath_nano_tpu.index.minimizer import MinimizerIndex
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.align.device_seed import NO_RID
from megapath_nano_tpu_torch.kernels.sw import banded_sw_full
from megapath_nano_tpu_torch.state import index_from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def _world(seed=5, n_genomes=4, glen=25000, n_reads=96, read_len=700):
    """The TPU package's tests/test_devseed.py world."""
    rng = np.random.default_rng(seed)
    genomes = [random_sequence(rng, glen) for _ in range(n_genomes)]
    index = MinimizerIndex.build(genomes,
                                 [f"g{i}" for i in range(n_genomes)])
    reads = []
    for _ in range(n_reads):
        g = int(rng.integers(0, n_genomes))
        s = int(rng.integers(0, glen - read_len))
        read = mutate(rng, genomes[g][s: s + read_len], sub_rate=0.04,
                      ins_rate=0.02, del_rate=0.02)
        if rng.integers(0, 2):
            read = revcomp(read)
        reads.append(read)
    reads[3][10:14] = 4                       # N bases ride the exceptions
    return index, reads


def _aligners():
    index, reads = _world()
    jal = jp.MinimizerAligner(index, params=jp.AlignParams(backend="jnp"))
    tal = tp.MinimizerAligner(index_from_numpy(index), params=tp.AlignParams(), device="cpu")
    return index, reads, jal, tal


def _jax_band_for(qm):
    return 128 if qm <= 2048 else (256 if qm <= 8192 else 512)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gather_windows_bit_equal():
    index, _ = _world()
    seq4 = jp._pack_seq4(np.concatenate([index.seq_data,
                                         np.full(2 ** 15, 5, np.int8)]))
    n = index.seq_data.size
    # odd and even starts, and starts at the tail of the reference where
    # nb = t_max/2 + 1 bytes overrun the sentinel pad (the slice clamps)
    starts = np.array([0, 1, 2, 777, 778, n - 5, n - 4, n,
                       n + 2 ** 15 - 1281, n + 2 ** 15 - 1280], np.int32)
    for t_max in (256, 1280):
        ref = np.asarray(jp._gather_windows(seq4, starts, t_max=t_max))
        got = tp._gather_windows(_t(seq4), _t(starts), t_max=t_max)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_unpack_and_gather_queries_bit_equal():
    _, reads = _world()
    reads = reads[:16]
    packed2, exc_rid, exc_pos = jp._pack_reads2(reads, 1024, n_rows=16)
    codes_j = jp._unpack_reads(packed2, exc_rid, exc_pos)
    codes_t = tp._unpack_reads(_t(packed2), _t(exc_rid), _t(exc_pos))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    qlens = np.array([len(r) for r in reads], np.int32)
    rng = np.random.default_rng(1)
    rid = rng.integers(0, 16, 40).astype(np.int32)
    qs = rng.integers(0, 300, 40).astype(np.int32)
    wlen = rng.integers(0, 700, 40).astype(np.int32)
    strand = (np.arange(40) % 2).astype(np.int32)       # both strands
    ref = jp._gather_queries(codes_j, rid, qlens, qs, wlen, strand,
                             q_max=1024)
    got = tp._gather_queries(codes_t, _t(rid), _t(qlens), _t(qs), _t(wlen),
                             _t(strand), q_max=1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ext_cap", [None, 16])
def test_fused_tail_bit_equal(ext_cap):
    """The shared tail on device-seeded groups; ext_cap=16 cuts the kept
    rows, so min_affected_rid is a real read id."""
    from megapath_nano_tpu.align.device_seed import build_groups_device

    index, reads, jal, _ = _aligners()
    reads = reads[:32]
    packed2, exc_rid, exc_pos = jp._pack_reads2(reads, 1024, n_rows=32)
    qlens = np.array([len(r) for r in reads], np.int32)
    codes = np.asarray(jp._unpack_reads(packed2, exc_rid, exc_pos))
    planes = jal._device_index_planes()
    groups = jax.jit(functools.partial(
        build_groups_device, k=15, w=10, max_occ=64, min_group_anchors=3,
        gap_break=5000, cap=32, seq_bits=2, lut_bits=planes[5],
        n_bisect=planes[6], wtot_max=8192, a_max=8192, g_max=256))(
            codes, qlens, *planes[:5])
    groups = [np.asarray(x) for x in groups[:7]]
    seq4 = jp._pack_seq4(np.concatenate([index.seq_data,
                                         np.full(2 ** 15, 5, np.int8)]))
    meta = (index.seq_offsets.astype(np.int32),
            index.seq_lengths.astype(np.int32))
    kw = dict(k=15, q_max=1024, t_max=1280, band=128, match=2, mismatch=4,
              gap_open=4, gap_extend=2, min_chain_score=40,
              max_per_read=50, window_pad=64, ext_cap=ext_cap)
    ref = jax.jit(functools.partial(jp._fused_tail, batch_tile=128,
                                    backend="jnp", **kw))(
        codes, qlens, *groups, seq4, *meta)
    got = tp._fused_tail(_t(codes), _t(qlens), *map(_t, groups), _t(seq4),
                         *map(_t, meta), **kw)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(ref[0]).astype(np.int32))
    assert int(got[1]) == int(ref[1]) and int(got[2]) == int(ref[2])
    assert (int(ref[2]) != NO_RID) == (ext_cap is not None)


def test_fused_row_matrices_bit_equal():
    """One slice through both fused dispatches, packing included: the
    device-seeded one and the host-seeded one of the partial redo."""
    index, reads, jal, tal = _aligners()
    slice_n, read_max = 256, 1024
    before = banded_sw_full.launches
    fj, cj = jal._fused_submit_devseed(reads, slice_n, read_max, tp._bucket,
                                       _jax_band_for)
    ft, ct = tal._fused_submit_devseed(reads, slice_n, read_max)
    ref, got = np.asarray(fj), tp._to_host_u16(ft)
    assert got.dtype == np.uint16 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert cj[1] == ct[1]
    assert (got[:-1, tp.F_KEEP] == 1).sum() >= 80

    groups = collect_anchors(index, reads[:40])
    fj, _ = jal._fused_submit(reads[:40], groups, read_max, tp._bucket,
                              _jax_band_for, n_rows=256)
    ft, _ = tal._fused_submit(reads[:40], groups, read_max, n_rows=256)
    np.testing.assert_array_equal(tp._to_host_u16(ft), np.asarray(fj))
    assert banded_sw_full.launches == before       # CPU: plain versions
