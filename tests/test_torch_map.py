"""Port parity for the slice as a whole: megapath_nano_tpu_torch's
MinimizerAligner(device="cpu").map_reads(emit_cigars=False) against the TPU
package's MinimizerAligner(backend="jnp"), all 18 AlignList fields equal,
on the tests/test_devseed.py world: one slice, tiny static caps (partial
redo through the host-seeded dispatch, equal overflow_stats) and with
slice_size set (the wave path). Also the state carry-over: the TPU
aligner's device arrays, carried by device_planes_from_numpy, equal the
port's own planes."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align import pipeline as jp
from megapath_nano_tpu.align.records import ALIGN_DTYPE
from megapath_nano_tpu.index.minimizer import MinimizerIndex
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.state import (device_planes_from_numpy,
                                           index_from_numpy)

TINY = staticmethod(lambda slice_n, read_max, occ=0.0: (64, 64, 64))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _world(seed, n_genomes=4, glen=25000, n_reads=96, read_len=700):
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
    return index, reads


def _assert_same(a, b):
    assert len(a) == len(b) and len(a) > 0
    assert a.data.dtype == b.data.dtype == ALIGN_DTYPE
    for col in ALIGN_DTYPE.names:
        np.testing.assert_array_equal(a.data[col], b.data[col], err_msg=col)
    assert a.sequence_names == b.sequence_names
    assert a.cigar_map is None and b.cigar_map is None


@pytest.mark.parametrize("world", ["single", "tiny_caps", "sliced"])
def test_map_reads_alignlist_equal(world, monkeypatch):
    seed, slice_size = {"single": (5, None), "tiny_caps": (13, 32),
                        "sliced": (9, 48)}[world]
    index, reads = _world(seed)
    if world == "tiny_caps":
        monkeypatch.setattr(jp.MinimizerAligner, "_devseed_caps", TINY)
        monkeypatch.setattr(tp.MinimizerAligner, "_devseed_caps", TINY)
    jal = jp.MinimizerAligner(index, params=jp.AlignParams(backend="jnp"))
    tal = tp.MinimizerAligner(index_from_numpy(index), params=tp.AlignParams(), device="cpu")
    ref = jal.map_reads(reads, emit_cigars=False, slice_size=slice_size)
    got = tal.map_reads(reads, emit_cigars=False, slice_size=slice_size)
    _assert_same(got, ref)
    assert tal.overflow_stats == jal.overflow_stats
    assert tal._cap_scales == jal._cap_scales
    if world == "tiny_caps":
        assert tal.overflow_stats["reads_redone"] >= 1
        # single-slice partial redo as well
        _assert_same(tal.map_reads(reads[:32], emit_cigars=False),
                     jal.map_reads(reads[:32], emit_cigars=False))
    else:
        assert tal.overflow_stats["overflow_slices"] == 0


def test_state_carry_over_equal():
    index, reads = _world(5, n_reads=8)
    jal = jp.MinimizerAligner(index, params=jp.AlignParams(backend="jnp"))
    jal._device_refs(np.zeros(1, np.int32), 256)
    keys32, pos_t, ss16, lut2, runcnt, lut_bits, n_bisect = \
        jal._device_index_planes()
    off, lens = jal._device_index_meta()
    carried = device_planes_from_numpy(
        {"seq4": jal._seq_data_dev, "seq_offsets": off, "seq_lengths": lens,
         "keys32": keys32, "pos_t": pos_t, "ss16": ss16, "lut2": lut2,
         "runcnt": runcnt}, device="cpu")
    tal = tp.MinimizerAligner(index_from_numpy(index), device="cpu")
    tal.map_reads(reads, emit_cigars=False)
    assert set(carried) == set(tal._planes)
    for name, t in carried.items():
        assert t.dtype == tal._planes[name].dtype, name
        assert torch.equal(t, tal._planes[name]), name
    assert tal._lut_meta == (lut_bits, n_bisect)
    assert carried["ss16"].dtype == torch.int32      # widened on device


def test_device_defaults_to_the_card():
    """No `device` argument means the GPU: with no CUDA device the
    constructor raises and names device="cpu"; it never carries on on the
    CPU."""
    index, reads = _world(5, n_reads=4)
    if torch.cuda.is_available():
        assert tp.MinimizerAligner(index_from_numpy(index)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tp.MinimizerAligner(index_from_numpy(index))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tp.MinimizerAligner(index_from_numpy(index), device="cuda:0")
    tal = tp.MinimizerAligner(index_from_numpy(index), device="cpu")
    assert tal.device.type == "cpu"
    # nothing of map_reads is unported: default arguments emit CIGARs
    res = tal.map_reads(reads)
    assert len(res) >= 3 and res.cigar_map
