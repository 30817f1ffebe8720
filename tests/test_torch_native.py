"""The port's own native layer: its loader builds cpp/*.cc into its own
build directory, safely when several processes start at once, and never
writes into cpp/; its copies of the host modules agree with the TPU
package's; an index carries over field for field (index_from_numpy)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from megapath_nano_tpu.align import anchors as janchors
from megapath_nano_tpu.index import minimizer as jmin
from megapath_nano_tpu.native import banded as jbanded
from megapath_nano_tpu.utils import dna as jdna
from megapath_nano_tpu_torch import buildutil
from megapath_nano_tpu_torch.align import anchors as tanchors
from megapath_nano_tpu_torch.index import minimizer as tmin
from megapath_nano_tpu_torch.native import banded as tbanded
from megapath_nano_tpu_torch.native import lib as tlib
from megapath_nano_tpu_torch.state import index_from_numpy
from megapath_nano_tpu_torch.utils import dna as tdna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a fresh interpreter: point the loader at an empty build directory
# and at a private copy of the C++ sources (so that nothing else in a
# parallel test run writes beside them), load, and print one
# banded_align_batch result
CHILD = """
import json, sys
import numpy as np
from megapath_nano_tpu_torch.native import lib
lib.BUILD_DIR, lib.CPP_DIR = sys.argv[1], sys.argv[2]
from megapath_nano_tpu_torch.native.banded import banded_align_batch
rng = np.random.default_rng(4)
ref = rng.integers(0, 4, 300).astype(np.int8)
read = np.concatenate([ref[20:120], ref[123:260]])
a = banded_align_batch([read], [ref], band=64)[0]
print(json.dumps({"path": lib.library_path(), "score": a.score,
                  "cigar": a.cigar_string, "begin": a.ref_begin,
                  "mods": sorted(m for m in sys.modules
                                 if m.split(".")[0] in
                                 ("megapath_nano_tpu", "jax"))}))
"""


def _listing(d):
    return sorted((f, os.path.getmtime(os.path.join(d, f)))
                  for f in os.listdir(d))


def test_two_fresh_processes_build_once_and_agree(tmp_path):
    build_dir = str(tmp_path / "build")
    cpp = str(tmp_path / "cpp")
    os.mkdir(cpp)
    for f in os.listdir(tlib.CPP_DIR):
        if f.endswith(".cc"):
            shutil.copy(os.path.join(tlib.CPP_DIR, f), cpp)
    before = _listing(cpp)
    assert len(before) >= 6
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, build_dir, cpp],
                              cwd=str(tmp_path), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[0]["score"] > 300 and "3D" in outs[0]["cigar"]
    assert outs[0]["mods"] == []          # neither the TPU package nor jax
    assert os.path.dirname(outs[0]["path"]) == build_dir
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert libs == [os.path.basename(outs[0]["path"])]   # no temp left over
    assert _listing(cpp) == before        # the source directory is untouched
    # the same answer as the TPU package's binding of the same sources
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 300).astype(np.int8)
    read = np.concatenate([ref[20:120], ref[123:260]])
    a = jbanded.banded_align_batch([read], [ref], band=64)[0]
    assert (a.score, a.cigar_string, a.ref_begin) == (
        outs[0]["score"], outs[0]["cigar"], outs[0]["begin"])


def test_failed_compile_raises_and_leaves_nothing(tmp_path):
    def boom(out):
        with open(out, "w") as f:
            f.write("half")
        raise RuntimeError("compiler failed")

    target = str(tmp_path / "b" / "libx.so")
    with pytest.raises(RuntimeError, match="compiler failed"):
        buildutil.build_once(target, boom)
    assert os.listdir(tmp_path / "b") == [".lock"]
    buildutil.build_once(target, lambda out: open(out, "w").close())
    assert os.path.exists(target)
    buildutil.build_once(target, boom)    # already built: not compiled again


def _world():
    rng = np.random.default_rng(8)
    genomes = [jdna.random_sequence(rng, 9000) for _ in range(3)]
    reads = []
    for _ in range(12):
        g = int(rng.integers(0, 3))
        s = int(rng.integers(0, 8400))
        r = jdna.mutate(rng, genomes[g][s: s + 600], sub_rate=0.03,
                        ins_rate=0.01, del_rate=0.01)
        reads.append(jdna.revcomp(r) if rng.integers(0, 2) else r)
    return genomes, reads


FIELDS = ("keys", "positions", "seq_lengths", "seq_data", "seq_offsets")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_round_trips(direction):
    genomes, reads = _world()
    names = ["a", "b", "c"]
    jidx = jmin.MinimizerIndex.build(genomes, names, k=13, w=8)
    tidx = tmin.MinimizerIndex.build(genomes, names, k=13, w=8)
    if direction == "jax_to_port":
        carried, own = index_from_numpy(jidx), tidx
        assert isinstance(carried, tmin.MinimizerIndex)
    else:
        carried = jmin.MinimizerIndex(
            k=tidx.k, w=tidx.w, keys=tidx.keys, positions=tidx.positions,
            seq_lengths=tidx.seq_lengths, seq_names=tidx.seq_names,
            seq_data=tidx.seq_data, seq_offsets=tidx.seq_offsets)
        own = jidx
    assert (carried.k, carried.w, carried.seq_names) == (13, 8, names)
    for f in FIELDS:
        a, b = getattr(carried, f), getattr(own, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    ga = janchors.collect_anchors(jidx, reads)
    gb = tanchors.collect_anchors(index_from_numpy(jidx), reads)
    assert ga.n_groups == gb.n_groups > 0
    for f in ("q_end", "t_end", "group_offsets", "group_read", "group_seq",
              "group_strand"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f),
                                      err_msg=f)


def test_index_from_numpy_without_sequences():
    genomes, _ = _world()
    jidx = jmin.MinimizerIndex.build(genomes, None, keep_seq=False)
    tidx = index_from_numpy(jidx)
    assert tidx.seq_data is None and tidx.seq_offsets is None
    np.testing.assert_array_equal(tidx.keys, jidx.keys)
    assert tidx.seq_names == ["seq0", "seq1", "seq2"]


@pytest.mark.parametrize("cap", [32, 8])
def test_pack_groups_copies_equal(cap):
    genomes, reads = _world()
    jidx = jmin.MinimizerIndex.build(genomes, None)
    ga = janchors.collect_anchors(jidx, reads, min_group_anchors=2)
    gb = tanchors.collect_anchors(index_from_numpy(jidx), reads,
                                  min_group_anchors=2)
    for a, b in zip(janchors.pack_groups(ga, max_anchors=cap),
                    tanchors.pack_groups(gb, max_anchors=cap)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(janchors.pack_groups_flat(ga, cap=cap),
                    tanchors.pack_groups_flat(gb, cap=cap)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sketch_and_dna_copies_equal():
    rng = np.random.default_rng(2)
    seq = jdna.random_sequence(rng, 700)
    seq[[5, 300]] = 4
    for a, b in zip(jmin.sketch(seq), tmin.sketch(seq)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jmin.sketch_batch([seq, seq[:90]]),
                    tmin.sketch_batch([seq, seq[:90]])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jdna.revcomp(seq), tdna.revcomp(seq))
    assert jdna.decode(seq) == tdna.decode(seq)
    np.testing.assert_array_equal(jdna.encode("ACGTNacgtu"),
                                  tdna.encode("ACGTNacgtu"))
    np.testing.assert_array_equal(
        jdna.mutate(np.random.default_rng(1), seq, 0.05, 0.02, 0.02),
        tdna.mutate(np.random.default_rng(1), seq, 0.05, 0.02, 0.02))


def test_launch_count_survives_threads():
    """The CIGAR path launches kernels from two worker threads: no update
    of a wrapper's launch count is lost."""
    import threading

    from megapath_nano_tpu_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, n_each = 16, 3000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count_launch(wrapper)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert wrapper.launches == n_threads * n_each


@pytest.mark.parametrize("band", [64, 256])
def test_banded_align_copies_equal(band):
    rng = np.random.default_rng(band)
    refs = [jdna.random_sequence(rng, 500) for _ in range(6)]
    reads = [jdna.mutate(rng, r[30:430], 0.04, 0.02, 0.02) for r in refs]
    reads[2] = np.zeros(0, np.int8)
    ja = jbanded.banded_align_batch(reads, refs, band=band)
    ta = tbanded.banded_align_batch(reads, refs, band=band)
    assert [vars(a) for a in ta] == [vars(a) for a in ja]
    assert ta[0].cigar_string == ja[0].cigar_string and ta[0].edit_dist > 0
    assert tbanded.banded_align_batch([], []) == []
