"""The port's CUDA kernels against their plain PyTorch versions on the card
(bit-equal: every output is an integer). Marked `cuda`: without a CUDA
device these skip. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -n 0
"""

import numpy as np
import pytest
import torch

from megapath_nano_tpu_torch.kernels import chain, sw

pytestmark = pytest.mark.cuda
PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("band", [128, 256, 512])
def test_sw_full_kernel_matches_plain(cuda, band):
    rng = np.random.default_rng(band)
    n, q, t = 64, 700, 900
    ta = rng.integers(0, 4, (n, t)).astype(np.int8)
    ra = ta[:, 10: 10 + q].copy()
    flip = rng.random((n, q)) < 0.06
    ra[flip] = rng.integers(0, 5, int(flip.sum()))
    rl = rng.integers(0, q + 1, n).astype(np.int32)
    tl = rng.integers(0, t + 1, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    before = sw.banded_sw_full.launches
    got = sw.banded_sw_full(*args, band=band, **PARAMS)
    assert sw.banded_sw_full.launches == before + 1
    ref = sw.banded_sw_full_torch(*sw._prepare(*args, band), band=band,
                                  **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("band", [128, 256, 512])
def test_sw_scores_kernel_matches_plain(cuda, band):
    rng = np.random.default_rng(band + 1)
    n, q, t = 67, 700, 900
    ta = rng.integers(0, 4, (n, t)).astype(np.int8)
    ra = ta[:, 10: 10 + q].copy()
    flip = rng.random((n, q)) < 0.06
    ra[flip] = rng.integers(0, 5, int(flip.sum()))
    rl = rng.integers(0, q + 1, n).astype(np.int32)
    tl = rng.integers(0, t + 1, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    before = sw.banded_sw_scores.launches
    got = torch.stack(sw.banded_sw_scores(*args, band=band, **PARAMS))
    assert sw.banded_sw_scores.launches == before + 1
    ref = sw.banded_sw_scores_torch(*sw._prepare(*args, band), band=band,
                                    **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


def _rep(unit, n):
    return np.tile(np.array(unit, np.int8), n // len(unit) + 1)[:n]


def _pad(pairs):
    q_max = max(len(r) for r, _ in pairs)
    t_max = max(len(x) for _, x in pairs)
    ra = np.full((len(pairs), q_max), 4, np.int8)
    ta = np.full((len(pairs), t_max), 5, np.int8)
    for j, (r, x) in enumerate(pairs):
        ra[j, : len(r)] = r
        ta[j, : len(x)] = x
    return (ra, np.array([len(r) for r, _ in pairs], np.int32), ta,
            np.array([len(x) for _, x in pairs], np.int32))


def _random_batch(rng, n, q, t):
    ta = rng.integers(0, 4, (n, t)).astype(np.int8)
    ra = ta[:, 10: 10 + q].copy()
    flip = rng.random((n, q)) < 0.06
    ra[flip] = rng.integers(0, 5, int(flip.sum()))
    return ra, np.full(n, q, np.int32), ta, np.full(n, t, np.int32)


def _batch(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "ragged":
        # N no multiple of the pairs a block holds, lengths 0..max inside
        # one block, columns no multiple of 4 (the wrapper pads them)
        ra, rl, ta, tl = _random_batch(rng, 331, 501, 643)
        rl = rng.integers(0, 502, 331).astype(np.int32)
        tl = rng.integers(0, 644, 331).astype(np.int32)
        rl[:6] = (0, 501, 1, 0, 2, 3)
        return ra, rl, ta, tl
    if case == "mostly_empty":
        # the fused PAF launch: a static cap of pairs, few of them live
        ra, rl, ta, tl = _random_batch(rng, 2048, 512, 640)
        live = np.zeros(2048, bool)
        live[:300] = True
        live[1024:] = rng.random(1024) < 0.1
        return ra, np.where(live, rl, 0).astype(np.int32), ta, \
            np.where(live, tl, 0).astype(np.int32)
    if case == "ties":
        pairs = []
        for unit in ([0], [0, 1], [0, 1, 2]):
            for _ in range(6):
                q, t = (int(x) for x in rng.integers(60, 300, 2))
                cut = int(rng.integers(10, q - 10))
                with_n = _rep(unit, q)
                with_n[cut: cut + 20] = 4
                pairs += [(_rep(unit, q), _rep(unit, t)),
                          (np.delete(_rep(unit, q), slice(cut, cut + 5)),
                           _rep(unit, t)), (with_n, _rep(unit, t))]
        pairs += [(_rep([0], 200), _rep([0], t)) for t in (0, 1, 2, 3, 17, 63)]
        pairs += [(np.full(120, 4, np.int8), _rep([1], 200)),
                  (_rep([1], 120), np.full(200, 4, np.int8))]
        return _pad(pairs)
    raise AssertionError(case)


@pytest.mark.parametrize("form", [sw.FORM_BY_SHAPE, sw.FORM_WARP,
                                  sw.FORM_BLOCK])
@pytest.mark.parametrize("band", [128, 256, 512])
@pytest.mark.parametrize("case", ["ragged", "mostly_empty", "ties"])
def test_sw_kernels_hard_batches_match_plain(cuda, case, band, form):
    args = [torch.from_numpy(x).to(cuda) for x in _batch(case)]
    prepared = sw._prepare(*args, band)
    got = sw._sw_full_cuda(*args, band=band, form=form, **PARAMS)
    ref = sw.banded_sw_full_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())
    got = sw._sw_scores_cuda(*args, band=band, form=form, **PARAMS)
    ref = sw.banded_sw_scores_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


def _edge_pairs(case, rng):
    """(read, ref) pairs of codes 0..4 at the edges of the score-only
    kernel's packed rows (the cases of tests/test_torch_sw_scan.py)."""
    if case == "later_row_equal":   # the best recurs in later rows
        x = rng.integers(0, 4, 80).astype(np.int8)
        dip = x.copy()
        dip[20:22] = (dip[20:22] + 1) % 4
        dip[30:32] = (dip[30:32] + 2) % 4
        return [(dip[:60].copy(), x[:70].copy()),
                (np.concatenate([x[:12], (x[12:14] + 1) % 4, x[14:18],
                                 (x[18:20] + 3) % 4, x[20:24]]), x[:24]),
                (_rep([0, 1], 40), np.concatenate([_rep([0, 1], 20),
                                                  _rep([2], 6),
                                                  _rep([0, 1], 20)]))]
    if case == "equal_lanes":       # equal maxima in one row, other lanes
        seg = rng.integers(0, 4, 24).astype(np.int8)
        return [(seg, np.concatenate([seg, rng.integers(0, 4, gap).astype(
            np.int8), seg])) for gap in (4, 8, 20, 40, 100, 180, 300)]
    if case == "short_windows":     # dead on both sides of the first rows
        read = rng.integers(0, 4, 400).astype(np.int8)
        return [(read, read[:n].copy()) for n in (1, 2, 5, 30, 63, 64, 65,
                                                  100, 127, 128, 129, 255,
                                                  256, 257)]
    if case == "long_indels":       # F and E chains across many lanes
        x = rng.integers(0, 4, 700).astype(np.int8)
        return [(np.concatenate([x[:40], x[40 + g:600]]), x) for g in
                (1, 3, 4, 5, 9, 17, 33, 60, 100, 200)] \
            + [(np.concatenate([x[:40], rng.integers(0, 4, g).astype(
                np.int8), x[40:500]]), x[:520]) for g in (1, 4, 7, 18, 40,
                                                          90, 180)]
    if case == "all_n":
        t = rng.integers(0, 4, 600).astype(np.int8)
        return [(np.full(500, 4, np.int8), t), (t[:500].copy(),
                                                np.full(600, 4, np.int8)),
                (np.full(80, 4, np.int8), np.full(90, 4, np.int8))]
    if case == "all_zero":          # every live H is 0
        return [(_rep([0], 500), _rep([1], 620)),
                (_rep([2, 3], 70), _rep([0, 1], 50)),
                (_rep([1], 3), _rep([2], 700))]
    raise AssertionError(case)


EDGE_CASES = ["later_row_equal", "equal_lanes", "short_windows",
              "long_indels", "all_n", "all_zero"]
# the map's scoring and the native realignment's
SCORINGS = [PARAMS, dict(match=4, mismatch=6, gap_open=8, gap_extend=2)]


@pytest.mark.parametrize("scoring", SCORINGS, ids=["2-4-4-2", "4-6-8-2"])
@pytest.mark.parametrize("band", [128, 256, 512])
@pytest.mark.parametrize("case", EDGE_CASES + ["ties"])
def test_sw_scores_packed_rows_match_plain(cuda, case, band, scoring):
    """The warp form's packed rows at their edges, one launch that the
    wrapper counts as packed."""
    rng = np.random.default_rng(sum(map(ord, case)) + band)
    arrays = _batch("ties") if case == "ties" \
        else _pad(_edge_pairs(case, rng))
    args = [torch.from_numpy(x).to(cuda) for x in arrays]
    before = sw.banded_sw_scores.packed_launches
    got = torch.stack(sw.banded_sw_scores(*args, band=band, **scoring))
    assert sw.banded_sw_scores.packed_launches == before + 1
    ref = sw.banded_sw_scores_torch(*sw._prepare(*args, band), band=band,
                                    **scoring)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("band", [128, 256, 512])
def test_sw_scores_exact_rows_match_plain(cuda, band):
    """A pair whose window holds a code other than 0..4 (a 5 or 6 inside
    its length) walks exact rows beside packed ones in the same launch, and
    a scoring that the packing cannot hold (a match beyond a signed byte, a
    negative gap penalty) sends the whole launch to exact rows, which the
    wrapper does not count as packed."""
    rng = np.random.default_rng(band + 7)
    x = rng.integers(0, 4, 600).astype(np.int8)
    odd5, odd6, odd_end = x[:500].copy(), x[:500].copy(), x[:500].copy()
    odd5[200] = 5
    odd6[50:60] = 6
    odd_end[499] = 127
    odd_read = x[10:450].copy()
    odd_read[100:104] = 9           # a read code matching no base
    pairs = [(x[10:450].copy(), w) for w in (odd5, odd6, odd_end)] \
        + [(odd_read, x[:500].copy()), (x[10:450].copy(), x[:500].copy())]
    args = [torch.from_numpy(a).to(cuda) for a in _pad(pairs)]
    prepared = sw._prepare(*args, band)
    for scoring, packed in ((PARAMS, 1),
                            (dict(PARAMS, match=130), 0),
                            (dict(PARAMS, gap_extend=-1), 0),
                            (dict(PARAMS, gap_open=-2), 0)):
        before = sw.banded_sw_scores.packed_launches
        got = torch.stack(sw.banded_sw_scores(*args, band=band, **scoring))
        assert sw.banded_sw_scores.packed_launches == before + packed
        ref = sw.banded_sw_scores_torch(*prepared, band=band, **scoring)
        assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("band", [384, 1024, 1152, 2048, 4096])
def test_sw_kernels_other_bands_match_plain(cuda, band):
    """Bands without a warp-per-pair instantiation take the block form;
    above 1024 a thread of it owns several slots."""
    args = [torch.from_numpy(x).to(cuda) for x in _batch("ragged")]
    prepared = sw._prepare(*args, band)
    got = sw.banded_sw_full(*args, band=band, **PARAMS)
    ref = sw.banded_sw_full_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())
    got = torch.stack(sw.banded_sw_scores(*args, band=band, **PARAMS))
    ref = sw.banded_sw_scores_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("extra", [128, 1024])
def test_sw_bands_beyond_shared_memory_match_plain(cuda, extra):
    """A band whose block-form planes do not fit in a block's shared memory
    takes the block form with its planes in device memory, bit-equal to the
    plain version; the shared-memory form, asked for by name, refuses it
    (naming the limit)."""
    rng = np.random.default_rng(17)
    args = [torch.from_numpy(x).to(cuda)
            for x in _random_batch(rng, 5, 900, 1400)]
    for entry, wrapper, cuda_form, plain in (
            ("mpn_sw_full", sw.banded_sw_full, sw._sw_full_cuda,
             sw.banded_sw_full_torch),
            ("mpn_sw_scores", sw.banded_sw_scores, sw._sw_scores_cuda,
             sw.banded_sw_scores_torch)):
        limit = sw.block_max_band(entry, cuda.index or 0)
        assert limit >= 4096
        band = limit + extra
        got = wrapper(*args, band=band, **PARAMS)
        if isinstance(got, tuple):
            got = torch.stack(got)
        ref = plain(*sw._prepare(*args, band), band=band, **PARAMS)
        assert torch.equal(got.cpu(), ref.cpu())
        with pytest.raises(ValueError, match=f"bands up to {limit}"):
            cuda_form(*args, band=band, form=sw.FORM_BLOCK, **PARAMS)


@pytest.mark.parametrize("band", [384, 2048])
@pytest.mark.parametrize("case", ["ragged", "ties"])
def test_sw_block_forms_device_planes_match_plain(cuda, case, band):
    """The device-memory block form at bands the shared-memory one also
    takes, in launches of a few blocks (the scratch cut small)."""
    args = [torch.from_numpy(x).to(cuda) for x in _batch(case)]
    prepared = sw._prepare(*args, band)
    keep = sw.SCRATCH_BYTES
    try:
        sw.SCRATCH_BYTES = 7 * 4 * 12 * band
        got = sw._sw_full_cuda(*args, band=band, form=sw.FORM_BLOCK_DEVICE,
                               **PARAMS)
        ref = sw.banded_sw_full_torch(*prepared, band=band, **PARAMS)
        assert torch.equal(got.cpu(), ref.cpu())
        got = sw._sw_scores_cuda(*args, band=band,
                                 form=sw.FORM_BLOCK_DEVICE, **PARAMS)
        ref = sw.banded_sw_scores_torch(*prepared, band=band, **PARAMS)
        assert torch.equal(got.cpu(), ref.cpu())
    finally:
        sw.SCRATCH_BYTES = keep


@pytest.mark.parametrize("form", [sw.FORM_WARP, sw.FORM_BLOCK])
def test_sw_scores_rows_past_2_15(cuda, form):
    """Reads of 40000 bases: end rows beyond the full-stats packing."""
    rng = np.random.default_rng(15)
    ra, rl, ta, tl = _random_batch(rng, 6, 40000, 40960)
    rl[1], rl[2], tl[3] = 33000, 0, 36000
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    got = sw._sw_scores_cuda(*args, band=512, form=form, **PARAMS)
    ref = sw.banded_sw_scores_torch(*sw._prepare(*args, 512), band=512,
                                    **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())
    assert int(got[1].max()) > 2 ** 15


def test_sw_kernels_lengths_out_of_range(cuda):
    """Lengths below 0 and beyond the planes are clamped as the plain
    versions clamp them."""
    rng = np.random.default_rng(16)
    ra, rl, ta, tl = _random_batch(rng, 8, 200, 260)
    rl[:4] = (-3, 250, 256, 1000)
    tl[2:6] = (-1, 261, 5000, 0)
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    prepared = sw._prepare(*args, 128)
    for form in (sw.FORM_WARP, sw.FORM_BLOCK):
        got = sw._sw_full_cuda(*args, band=128, form=form, **PARAMS)
        ref = sw.banded_sw_full_torch(*prepared, band=128, **PARAMS)
        assert torch.equal(got.cpu(), ref.cpu())
        got = sw._sw_scores_cuda(*args, band=128, form=form, **PARAMS)
        ref = sw.banded_sw_scores_torch(*prepared, band=128, **PARAMS)
        assert torch.equal(got.cpu(), ref.cpu())


def _chain_rows(rng, n, a):
    t = np.sort(rng.integers(0, min(3000 * max(a, 32) // 32, 30000),
                             (n, a)), axis=1).astype(np.int32)
    q = (t + rng.integers(-30, 30, (n, a))).clip(0).astype(np.int32)
    # a lattice in every fourth row: many equal candidates, so ties decide
    q[::4] = q[::4] // 40 * 40
    t[::4] = np.sort(t[::4] // 40 * 40, axis=1)
    return q, t


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("window", [32, 1, 7, 31])
@pytest.mark.parametrize("a", [1, 31, 32, 33, 100, 256, 512])
def test_chain_kernel_matches_plain(cuda, a, window, dtype):
    rng = np.random.default_rng(a)
    n = 2000 if a <= 256 else 301
    q, t = _chain_rows(rng, n, a)
    cnt = rng.integers(-3, a + 4, n).astype(np.int32)   # clamped to 0..a
    cnt[:4] = (0, 1, a, a + 50)
    args = [torch.from_numpy(x).to(cuda)
            for x in (q.astype(dtype), t.astype(dtype), cnt)]
    before = chain.chain_and_extents.launches
    got = chain.chain_and_extents(*args, window=window)
    assert chain.chain_and_extents.launches == before + 1
    ref = chain.chain_and_extents_torch(
        *args, chain.beta_tensor(15, 500, cuda), window=window, k=15,
        max_dist=5000, bandwidth=500)
    assert torch.equal(got.cpu(), ref.cpu())
    assert got[:, 0].tolist() == [0, q[0, 0], q[0, 0], t[0, 0], t[0, 0], 1]


def test_chain_kernel_empty_batches(cuda):
    """No group at all, and groups without an anchor."""
    none = torch.zeros((0, 32), dtype=torch.int32, device=cuda)
    before = chain.chain_and_extents.launches
    got = chain.chain_and_extents(none, none, none[:, 0])
    assert got.shape == (6, 0) and got.dtype == torch.int32
    assert chain.chain_and_extents.launches == before   # nothing to launch
    rng = np.random.default_rng(5)
    q, t = (torch.from_numpy(x).to(cuda) for x in _chain_rows(rng, 77, 64))
    got = chain.chain_and_extents(q, t, torch.zeros(77, dtype=torch.int32,
                                                    device=cuda))
    one = torch.ones(77, dtype=torch.int32, device=cuda)
    assert torch.equal(got, torch.stack([0 * one, q[:, 0], q[:, 0], t[:, 0],
                                         t[:, 0], one]))


def test_chain_wrapper_two_threads_one_table(cuda):
    """Two threads call the wrapper at once, as the CIGAR-mode map does:
    one cached gap-cost table per device, equal outputs, every launch
    counted."""
    import threading

    rng = np.random.default_rng(6)
    q, t = _chain_rows(rng, 4096, 64)
    cnt = rng.integers(0, 65, 4096).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, cnt)]
    k, bandwidth = 14, 333            # a table no other test has asked for
    kw = dict(k=k, max_dist=5000, bandwidth=bandwidth)
    assert not [key for key in chain._beta_tensors if key[:2] == (k, bandwidth)]
    outs, tables = [[], []], [[], []]
    gate = threading.Barrier(2)

    def work(slot):
        gate.wait(timeout=60)
        for _ in range(50):
            outs[slot].append(chain.chain_and_extents(*args, **kw))
            tables[slot].append(chain.beta_tensor(k, bandwidth, cuda))
        torch.cuda.synchronize()

    before = chain.chain_and_extents.launches
    threads = [threading.Thread(target=work, args=(s,)) for s in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert chain.chain_and_extents.launches == before + 100
    keys = [key for key in chain._beta_tensors if key[:2] == (k, bandwidth)]
    assert len(keys) == 1 and keys[0][2] == args[0].device
    assert len({tb.data_ptr() for tb in tables[0] + tables[1]}) == 1
    ref = chain.chain_and_extents_torch(
        *args, chain.beta_tensor(k, bandwidth, cuda), window=32, **kw)
    for got in outs[0] + outs[1]:
        assert torch.equal(got, ref)


def mixed_lengths_world():
    """Reads of 300 b to 6 kb (log-uniform) on three 20 kb genomes, one a
    95% copy of another, so most reads get two windows: mapped with
    `extend_batch` 8, the windows span several score-only launches that
    sorting by length reorders. The port's own modules only."""
    from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                                   revcomp)

    rng = np.random.default_rng(29)
    g0, g1 = random_sequence(rng, 20000), random_sequence(rng, 20000)
    genomes = [g0, g1, mutate(rng, g0, 0.03, 0.01, 0.01)]
    lens = np.exp(rng.uniform(np.log(300), np.log(6000), 24)).astype(int)
    reads = []
    for n in lens:
        g = genomes[int(rng.integers(0, 2))]
        s = int(rng.integers(0, len(g) - n))
        read = mutate(rng, g[s: s + n], 0.03, 0.015, 0.015)
        reads.append(revcomp(read) if rng.integers(0, 2) else read)
    return genomes, reads


def test_map_mixed_lengths_card_matches_cpu(cuda):
    """CIGAR-mode map_reads of the mixed-length world on the card and on
    the CPU (plain versions): equal in all 18 fields and cigar_map, and
    the card launches the score-only kernel once for every extend_batch
    windows."""
    from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                        MinimizerAligner)
    from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
    from megapath_nano_tpu_torch.utils import log

    genomes, reads = mixed_lengths_world()
    index = MinimizerIndex.build(genomes, ["g0", "g1", "g2"])
    out = {}
    for device in ("cpu", "cuda"):
        before = sw.banded_sw_scores.launches
        al = MinimizerAligner(index, params=AlignParams(extend_batch=8),
                              device=device)
        res = al.map_reads(reads)
        root = [s for s in log.RECORD.spans()
                if s.name == "map.call" and s.parent is None][-1]
        windows = sum(s.counts.get("windows", 0)
                      for s in log.RECORD.request(root.id))
        out[device] = (res, sw.banded_sw_scores.launches - before, windows)
    (cpu, none, w_cpu), (gpu, launched, w_gpu) = out["cpu"], out["cuda"]
    assert none == 0 and w_cpu == w_gpu >= 30
    assert launched == -(-w_gpu // 8)
    assert len(gpu) > 0 and np.array_equal(gpu.data, cpu.data)
    assert gpu.cigar_map == cpu.cigar_map


def _profile_world():
    """A small world for the taxon profile (the port's own modules only):
    a dominant assembly sharing a segment with a low one of its genus, a
    second genus of two close species, a human genome carrying a piece of
    one assembly, and human reads."""
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.utils.dna import mutate, random_sequence

    rng = np.random.default_rng(12)
    shared = random_sequence(rng, 4000)
    g_a = np.concatenate([random_sequence(rng, 16000), shared])
    g_b = np.concatenate([shared, random_sequence(rng, 12000)])
    g_c = random_sequence(rng, 15000)
    g_d = mutate(rng, g_c, 0.015, 0.0025, 0.0025)
    human = np.concatenate([random_sequence(rng, 10000), g_c[4000:5500]])
    db = RefDB.build([g_a, g_b, g_c, g_d], ["cA", "cB", "cC", "cD"],
                     [0, 1, 2, 3], ["asmA", "asmB", "asmC", "asmD"],
                     [(1, 10, 5), (2, 20, 5), (3, 30, 6), (4, 40, 6)])
    human_db = RefDB.build([human], ["chrH"], [0], ["GRCh38"],
                           [(9606, 9606, 9605)])
    reads = []
    for genome, n in ((g_a, 40), (g_c, 15), (g_d, 5), (human[:10000], 6)):
        for _ in range(n):
            s = int(rng.integers(0, len(genome) - 800))
            reads.append(mutate(rng, genome[s: s + 800], 0.02, 0.01, 0.01))
    return reads, db, human_db


def _same_report_files(dir_a, dir_b):
    import os
    import tarfile

    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for n in names:
        a, b = os.path.join(dir_a, n), os.path.join(dir_b, n)
        if n.endswith(".tar.gz"):
            with tarfile.open(a) as ta, tarfile.open(b) as tb:
                assert ta.getnames() == tb.getnames(), n
                for m in ta.getmembers():
                    if m.isfile():
                        assert ta.extractfile(m).read() == \
                            tb.extractfile(m.name).read(), (n, m.name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("emit_cigars", [True, False])
def test_profile_card_matches_cpu(cuda, emit_cigars, tmp_path):
    """TaxonProfiler on the card and on the CPU (plain versions), with the
    noise stack's gates on: every AlignList of the result equal in all 18
    fields and cigar_map, the same noise sources, marks and projections,
    and the same report files; the maps of the card run launch the
    kernels."""
    from megapath_nano_tpu_torch.taxon.profiler import (ProfileOptions,
                                                         TaxonProfiler)

    reads, db, human_db = _profile_world()
    opts = ProfileOptions(
        emit_cigars=emit_cigars, human_filter=True, spike_filter=True,
        microbe_repetitive_filter=True, similar_species_marker=True,
        noise_projection=True, noise_projection_reads=120,
        unique_alignment=True)
    out = {}
    for device in ("cuda", "cpu"):
        before = (sw.banded_sw_scores.launches, chain.chain_and_extents.launches)
        prof = TaxonProfiler(db, opts, human_db=human_db, device=device)
        res = prof.profile(reads)
        launched = (sw.banded_sw_scores.launches - before[0],
                    chain.chain_and_extents.launches - before[1])
        prof.write_reports(res, str(tmp_path / device), "p",
                           read_lengths=np.array([len(r) for r in reads]),
                           reads=reads)
        out[device] = (res, launched)
    (gpu, launched), (cpu, none) = out["cuda"], out["cpu"]
    assert launched[0] > 0 and launched[1] > 0 and none == (0, 0)
    for name in ("align_list", "best", "human_best", "pre_noise_best"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        assert np.array_equal(a.data, b.data), name
        assert a.cigar_map == b.cigar_map, name
    assert len(gpu.best) > 0 and len(gpu.human_read_ids) >= 5
    assert gpu.noise_sources.keys() == cpu.noise_sources.keys()
    for k in gpu.noise_sources:
        assert np.array_equal(gpu.noise_sources[k], cpu.noise_sources[k])
    assert np.array_equal(gpu.stat, cpu.stat)
    assert gpu.similar_marks == cpu.similar_marks
    assert [vars(p) for p in gpu.noise_projections] == \
        [vars(p) for p in cpu.noise_projections]
    assert "p.preport" in _same_report_files(str(tmp_path / "cuda"),
                                             str(tmp_path / "cpu"))


def _amr_world():
    """Two resistance genes in a 22 kb genome (a third gene only in the
    DB) and 120 reads at 6% error, best alignments from a CPU profile."""
    from megapath_nano_tpu_torch.amr.db import AMRGeneDB
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.taxon.profiler import (ProfileOptions,
                                                         TaxonProfiler)
    from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                                   revcomp)

    rng = np.random.default_rng(0)
    genes = [random_sequence(rng, n) for n in (900, 1100, 800)]
    backbone = random_sequence(rng, 20000)
    genome = np.concatenate([backbone[:6000], genes[0], backbone[6000:14000],
                             genes[1], backbone[14000:]])
    dbs = [AMRGeneDB("resfinder", ["blaTEM-1", "vanA", "mecA"], genes,
                     [["ampicillin"], ["vancomycin"], ["methicillin"]]),
           AMRGeneDB("card", ["TEM-1"], [genes[0]],
                     [["ampicillin", "penicillins"]])]
    reads = []
    for _ in range(120):
        s = int(rng.integers(0, len(genome) - 900))
        r = mutate(rng, genome[s: s + 900], 0.03, 0.015, 0.015)
        reads.append(revcomp(r) if rng.integers(0, 2) else r)
    db = RefDB.build([genome], ["chr1"], [0], ["asm1"], [(1, 1, 1)])
    best = TaxonProfiler(db, ProfileOptions(), device="cpu").profile(
        reads).best
    return genome, reads, dbs, best


def test_run_amr_card_matches_cpu(cuda):
    """run_amr on the card and on the CPU: the same contigs, hits and merged
    table; the gene-DB scans of the card run launch the score-only
    extension and the chain kernel, the CPU run launches nothing."""
    from megapath_nano_tpu_torch.amr.module import run_amr

    genome, reads, dbs, best = _amr_world()
    out = {}
    for device in ("cuda", "cpu"):
        before = (sw.banded_sw_scores.launches,
                  chain.chain_and_extents.launches)
        res = run_amr(best, reads, {0: genome}, dbs, device=device)
        out[device] = (res, (sw.banded_sw_scores.launches - before[0],
                             chain.chain_and_extents.launches - before[1]))
    (gpu, launched), (cpu, none) = out["cuda"], out["cpu"]
    assert launched[0] > 0 and launched[1] > 0 and none == (0, 0)
    assert [(c.sequence_id, c.start, c.seq.tolist()) for c in gpu.contigs] \
        == [(c.sequence_id, c.start, c.seq.tolist()) for c in cpu.contigs]
    assert {k: [vars(h) for h in v] for k, v in gpu.hits_by_db.items()} == \
        {k: [vars(h) for h in v] for k, v in cpu.hits_by_db.items()}
    assert gpu.merged == cpu.merged
    assert {h.gene for h in gpu.hits_by_db["resfinder"]} == {"blaTEM-1",
                                                             "vanA"}


@pytest.mark.parametrize("emit_cigars", [False, True])
def test_sharded_aligner_card_matches_cpu(cuda, emit_cigars):
    """ShardedAligner over 3 shards (4 genomes, one assembly of two
    sequences) on the card and on the CPU: the merged AlignList equal in
    all 18 fields and cigar_map; the card's shards launch the kernels."""
    from megapath_nano_tpu_torch.dist.sharded_aligner import ShardedAligner
    from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                                   revcomp)

    rng = np.random.default_rng(0)
    genomes = [random_sequence(rng, 20000) for _ in range(4)]
    names = [f"g{i}" for i in range(4)]
    reads = []
    for _ in range(96):
        g = genomes[int(rng.integers(0, 4))]
        s = int(rng.integers(0, len(g) - 900))
        r = mutate(rng, g[s: s + 900], 0.03, 0.015, 0.015)
        reads.append(revcomp(r) if rng.integers(0, 2) else r)
    ext = sw.banded_sw_scores if emit_cigars else sw.banded_sw_full
    out = {}
    for device in ("cuda", "cpu"):
        before = (ext.launches, chain.chain_and_extents.launches)
        al = ShardedAligner.build(genomes, names, [0, 1, 2, 2],
                                  ["a0", "a1", "a2"], 3, device=device)
        res = al.map_reads(reads, emit_cigars=emit_cigars)
        out[device] = (res, (ext.launches - before[0],
                             chain.chain_and_extents.launches - before[1]))
    (gpu, launched), (cpu, none) = out["cuda"], out["cpu"]
    assert launched[0] > 0 and launched[1] > 0 and none == (0, 0)
    assert len(gpu.data) > 0 and np.array_equal(gpu.data, cpu.data)
    assert gpu.cigar_map == cpu.cigar_map


@pytest.mark.parametrize("n_data,n_shards,cut", [(1, 2, False),
                                                 (2, 2, False),
                                                 (2, 2, True)])
def test_shard_map_aligner_card_matches_cpu(cuda, n_data, n_shards, cut):
    """ShardMapAligner (one process) over a (n_data, n_shards) mesh on the
    card and on the CPU, and with the rows cap cut to 4 (every cell
    overflows, the cut reads are redone host-seeded): the AlignList equal
    in all 18 fields, the overflow statistics equal, and on the card every
    cell launches both kernels."""
    from megapath_nano_tpu_torch.dist.fused_sharded import (
        ShardedIndexPlanes, ShardMapAligner)
    from megapath_nano_tpu_torch.dist.mesh import make_mesh
    from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                                   revcomp)

    rng = np.random.default_rng(3)
    genomes = [random_sequence(rng, 20000) for _ in range(6)]
    names = [f"g{i}" for i in range(6)]
    reads = []
    for _ in range(96):
        g = genomes[int(rng.integers(0, 6))]
        s = int(rng.integers(0, len(g) - 900))
        r = mutate(rng, g[s: s + 900], 0.03, 0.015, 0.015)
        reads.append(revcomp(r) if rng.integers(0, 2) else r)
    planes = ShardedIndexPlanes.build(genomes, names, n_shards)
    kernels = (sw.banded_sw_full, chain.chain_and_extents)
    out = {}
    for device in ("cuda", "cpu"):
        before = [k.launches for k in kernels]
        al = ShardMapAligner(planes, make_mesh(n_shards, n_data,
                                               devices=[device]),
                             device=device)
        if cut:
            caps = al._caps
            al._caps = lambda n, m: caps(n, m)[:3] + (4,)
        res = al.map_reads(reads, slice_size=64)
        out[device] = (res, dict(al.overflow_stats),
                       [k.launches - b for k, b in zip(kernels, before)])
    (gpu, gpu_stats, launched), (cpu, cpu_stats, none) = \
        out["cuda"], out["cpu"]
    assert gpu_stats == cpu_stats and (gpu_stats["reads_redone"] > 0) == cut
    assert min(launched) >= 2 * n_data * n_shards and none == [0, 0]
    assert len(gpu.data) > 0 and np.array_equal(gpu.data, cpu.data)


@pytest.mark.parametrize("name", ["model-000.pkl", "model-001.pkl",
                                  "model-002.pkl"])
def test_clairnet_card_matches_cpu(cuda, name):
    """A shipped model on the card (float32, cuDNN without TF32) and on
    the CPU, on 256 seeded tensors: every probability within 5e-6, every
    argmax equal."""
    import os

    from megapath_nano_tpu_torch.variant import pretrained
    from megapath_nano_tpu_torch.variant.model import VariantModel

    path = os.path.join(pretrained.default_model_dir(), name)
    x = np.random.default_rng(0).random((256, 33, 8, 4)).astype(np.float32)
    probs = {}
    for dev in ("cuda", "cpu"):
        m = VariantModel(hidden=96, device=dev)
        m.load(path)
        probs[dev] = m.predict(x)
    for task, ref in probs["cpu"].items():
        got = probs["cuda"][task]
        gap = float(np.abs(got - ref).max())
        assert gap <= 5e-6, (task, gap)
        assert np.array_equal(got.argmax(1), ref.argmax(1)), task


def test_train_step_card_matches_cpu(cuda):
    """Two train steps from the same init on the card and on the CPU: the
    losses (the second after an Adam update) within 1e-5 relative."""
    from megapath_nano_tpu_torch import state
    from megapath_nano_tpu_torch.variant.model import VariantModel

    rng = np.random.default_rng(3)
    n = 128
    x = rng.random((n, 33, 8, 4)).astype(np.float32)
    labels = {"gt21": rng.integers(0, 21, n),
              "zygosity": rng.integers(0, 3, n),
              "var_len_1": rng.integers(0, 5, n),
              "var_len_2": rng.integers(0, 5, n)}
    cpu = VariantModel(seed=1, hidden=96, device="cpu")
    card = VariantModel(hidden=96, device="cuda")
    state.load_variant_params(card.net,
                              state.variant_params_to_numpy(cpu.net))
    for _ in range(2):
        a, b = cpu.train_step(x, labels), card.train_step(x, labels)
        assert abs(a - b) <= 1e-5 * abs(a), (a, b)
    for bias in card.net.recurrent_biases():
        assert not bias.any()
