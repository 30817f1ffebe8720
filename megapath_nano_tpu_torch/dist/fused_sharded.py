"""Production multi-device map path: the fused seed -> chain -> extend step
run per index shard, merged with one gather.

This is the port's counterpart of the reference's minimap2 index-batch
streaming (reference: bin/lib/aligner.py:211-217: targets cat'd through a
FIFO in chunks, minimap2 -I batches the index, the host merges per-read
hits across passes). Here:

  - the minimizer index is partitioned by target sequence across S shards
    along the "shard" axis of a mesh (dist/mesh.py); each cell holds its
    shard's sorted hash planes and packed bases on its device (only the
    2-bit packed reads cross the host link)
  - reads are data-parallel over the "data" axis: a slice is split into D
    contiguous blocks, block d going to data row d's S cells; each cell
    runs the same fused dispatch as the single-device device-seeded path
    (`pipeline._fused_map_dispatch_devseed`) on (its read block x its index
    shard)
  - the per-cell row blocks (compacted stats rows of uint16 values) merge
    into one (D, S, out_cap+1, 16) block: in one process a torch.stack on
    the device; across ranks all_gather_into_tensor over the "shard"
    subgroup, then over the "data" subgroup; either way one device-to-host
    fetch a slice
  - the host applies the global per-read top-K chain gate over the union
    (each shard kept its local top-K, a superset of the global top-K) and
    the standard multi-locus selection and collect (fused_collect_np), so
    the output AlignList is field-identical to the single-index mapper's.
    Across ranks every rank runs this merge on the gathered block and
    returns the same AlignList.

Known divergence (shared with the reference's own -I batching): per-shard
max_occ filtering sees per-shard key occupancy, so a minimizer repetitive
globally but rare per shard may seed extra candidates.

The port's copy of megapath_nano_tpu/dist/fused_sharded.py: the shard_map
over a JAX mesh becomes a loop over this process's cells of a torch mesh,
`backend` becomes the device, and ShardedIndexPlanes is the original's,
with the same on-disk format (planes.npz + planes.json), so each package
reads the other's files.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from megapath_nano_tpu_torch.align.anchors import collect_anchors
from megapath_nano_tpu_torch.align.pipeline import (
    F_CHAIN, F_KEEP, F_RID, F_SEQ, FUSED_COLS, AlignList, AlignParams,
    MinimizerAligner, SequenceMeta, _fused_map_dispatch_devseed,
    _lut_bits_for, _pack_reads2, _pack_seq4, _run_counts, _to_host_u16,
    _unpack_counts_row, fused_collect_np, require_device)
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.state import device_planes_from_numpy

_HASH_PAD = np.int32(1 << 30)   # > any 30-bit minimizer hash (k <= 15)


@dataclass
class ShardedIndexPlanes:
    """Host container of per-shard device-index planes, padded to equal
    shapes and stacked on a leading shard axis."""

    keys32: np.ndarray        # (S, K) int32 sorted per shard (pad 2**30)
    pos_t: np.ndarray         # (S, K) int32 within-sequence k-mer end
    pos_ss: np.ndarray        # (S, K) int32 local seq_id << 1 | strand
    seq_data: np.ndarray      # (S, T) int8, pad 5 (+ 2**15 sentinel tail)
    seq_offsets: np.ndarray   # (S, N+1) int32 local concat offsets
    seq_lengths: np.ndarray   # (S, N) int32
    seq_global: np.ndarray    # (S, N) int32 local -> global seq id (pad -1)
    k: int
    w: int
    seq_bits: int             # max local seq-id bit width over shards
    global_seq_names: list[str]
    global_seq_lengths: np.ndarray
    local_indexes: list = field(default_factory=list)  # per-shard host index
    shard_of_seq: np.ndarray | None = None             # (n_global,) int32

    @property
    def n_shards(self) -> int:
        return self.keys32.shape[0]

    def save(self, path: str) -> None:
        """On-disk shard format: one npz of the stacked device planes + a
        json sidecar (names, k/w). Loading restores a mapper-ready object
        without re-sketching the reference."""
        _save_planes(self, path)

    @staticmethod
    def load(path: str) -> "ShardedIndexPlanes":
        return _load_planes(path)

    def local_index(self, sh: int) -> MinimizerIndex:
        """Host MinimizerIndex of shard sh (for the exact overflow
        fallback); rebuilt from the shard planes when the object was
        loaded from disk."""
        if self.local_indexes:
            return self.local_indexes[sh]
        if not hasattr(self, "_rebuilt"):
            self._rebuilt = {}
        if sh not in self._rebuilt:
            gids = self.seq_global[sh]
            seqs, names = [], []
            for li, g in enumerate(gids):
                if g < 0:
                    break
                s0 = int(self.seq_offsets[sh][li])
                s1 = s0 + int(self.seq_lengths[sh][li])
                seqs.append(self.seq_data[sh][s0:s1])
                names.append(self.global_seq_names[int(g)])
            if not seqs:
                seqs, names = [np.zeros(0, np.int8)], ["__empty__"]
            self._rebuilt[sh] = MinimizerIndex.build(seqs, names, k=self.k,
                                                     w=self.w)
        return self._rebuilt[sh]

    @staticmethod
    def build(sequences: list[np.ndarray], seq_names: list[str] | None,
              n_shards: int, *, k: int = 15, w: int = 10,
              assign: np.ndarray | None = None) -> "ShardedIndexPlanes":
        """Partition sequences across shards (default: greedy
        longest-first balance by total bp) and build per-shard planes."""
        if k > 15:
            raise ValueError("device planes need 30-bit hashes (k <= 15)")
        n = len(sequences)
        names = seq_names or [f"seq{i}" for i in range(n)]
        if assign is None:
            order = np.argsort([-len(s) for s in sequences], kind="stable")
            load = np.zeros(n_shards, np.int64)
            assign = np.zeros(n, np.int32)
            for i in order:
                sh = int(np.argmin(load))
                assign[i] = sh
                load[sh] += len(sequences[i])
        assign = np.asarray(assign, np.int32)

        per_shard = [[] for _ in range(n_shards)]
        for i in range(n):
            per_shard[assign[i]].append(i)

        locals_, tabs = [], []
        for sh in range(n_shards):
            gids = per_shard[sh]
            if gids:
                idx = MinimizerIndex.build(
                    [sequences[i] for i in gids],
                    [names[i] for i in gids], k=k, w=w)
            else:
                idx = MinimizerIndex.build(
                    [np.zeros(0, np.int8)], ["__empty__"], k=k, w=w)
                gids = [-1]
            seq_id_l, pos_l, strand_l = idx.unpack(idx.positions)
            keys32 = idx.keys.astype(np.int64)
            if keys32.size and keys32.max() >= 2 ** 30:
                raise ValueError("device planes need hashes < 2**30")
            tabs.append((keys32.astype(np.int32), pos_l.astype(np.int32),
                         ((seq_id_l.astype(np.int32) << 1)
                          | strand_l).astype(np.int32), idx, gids))
            locals_.append(idx)

        K = max(1, max(len(t[0]) for t in tabs))
        K = int(np.ceil(K / 128) * 128)
        T = max(1, max(t[3].seq_data.size for t in tabs))
        T = int(np.ceil(T / 128) * 128) + 2 ** 15   # sentinel window tail
        N = max(len(t[4]) for t in tabs)

        keys = np.full((n_shards, K), _HASH_PAD, np.int32)
        pos_t = np.zeros((n_shards, K), np.int32)
        pos_ss = np.zeros((n_shards, K), np.int32)
        seq_data = np.full((n_shards, T), 5, np.int8)
        seq_off = np.zeros((n_shards, N + 1), np.int32)
        seq_len = np.zeros((n_shards, N), np.int32)
        seq_glob = np.full((n_shards, N), -1, np.int32)
        for sh, (kk, pt, ss, idx, gids) in enumerate(tabs):
            keys[sh, :len(kk)] = kk
            pos_t[sh, :len(pt)] = pt
            pos_ss[sh, :len(ss)] = ss
            seq_data[sh, :idx.seq_data.size] = idx.seq_data
            nl = len(idx.seq_lengths)
            seq_off[sh, :nl + 1] = idx.seq_offsets.astype(np.int32)
            seq_off[sh, nl + 1:] = np.int32(idx.seq_offsets[-1])
            seq_len[sh, :nl] = idx.seq_lengths.astype(np.int32)
            seq_glob[sh, :len(gids)] = gids
        shard_of_seq = assign.copy()
        return ShardedIndexPlanes(
            keys32=keys, pos_t=pos_t, pos_ss=pos_ss, seq_data=seq_data,
            seq_offsets=seq_off, seq_lengths=seq_len, seq_global=seq_glob,
            k=k, w=w,
            seq_bits=max(1, (max(N - 1, 1)).bit_length()),
            global_seq_names=list(names),
            global_seq_lengths=np.array([len(s) for s in sequences],
                                        np.int64),
            local_indexes=locals_, shard_of_seq=shard_of_seq)


def _save_planes(planes: "ShardedIndexPlanes", path: str) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(
        os.path.join(path, "planes.npz"),
        keys32=planes.keys32, pos_t=planes.pos_t, pos_ss=planes.pos_ss,
        seq_data=planes.seq_data, seq_offsets=planes.seq_offsets,
        seq_lengths=planes.seq_lengths, seq_global=planes.seq_global,
        global_seq_lengths=planes.global_seq_lengths,
        shard_of_seq=planes.shard_of_seq)
    with open(os.path.join(path, "planes.json"), "w") as f:
        json.dump({"k": planes.k, "w": planes.w,
                   "seq_bits": planes.seq_bits,
                   "global_seq_names": planes.global_seq_names}, f)


def _load_planes(path: str) -> "ShardedIndexPlanes":
    z = np.load(os.path.join(path, "planes.npz"))
    with open(os.path.join(path, "planes.json")) as f:
        meta = json.load(f)
    return ShardedIndexPlanes(
        keys32=z["keys32"], pos_t=z["pos_t"], pos_ss=z["pos_ss"],
        seq_data=z["seq_data"], seq_offsets=z["seq_offsets"],
        seq_lengths=z["seq_lengths"], seq_global=z["seq_global"],
        k=int(meta["k"]), w=int(meta["w"]),
        seq_bits=int(meta["seq_bits"]),
        global_seq_names=list(meta["global_seq_names"]),
        global_seq_lengths=z["global_seq_lengths"],
        local_indexes=[],            # host fallback indexes not persisted;
        #                              rebuilt lazily from the shard planes
        shard_of_seq=z["shard_of_seq"])


def _gather_blocks(mesh, cell_rows: dict) -> torch.Tensor:
    """Merge the cells' (out_cap+1, FUSED_COLS) row blocks into one
    (D, S, out_cap+1, FUSED_COLS) tensor: in one process by stacking on the
    first cell's device; across ranks by all_gather_into_tensor over the
    "shard" subgroup (the data row's blocks), then over the "data" subgroup
    (every row's, which the TPU package's host fetch of a "data"-sharded
    output assembles)."""
    D, S = mesh.shape["data"], mesh.shape["shard"]
    if not mesh.distributed:
        home = mesh.devices[0][0]
        return torch.stack([torch.stack([cell_rows[(d, s)].to(home)
                                         for s in range(S)])
                            for d in range(D)])
    rows = cell_rows[mesh.coords].contiguous()
    r, c = rows.shape
    # gloo wants the output as the inputs concatenated on dim 0
    row_blk = rows.new_empty((S * r, c))
    dist.all_gather_into_tensor(row_blk, rows, group=mesh.shard_group)
    full = rows.new_empty((D * S * r, c))
    dist.all_gather_into_tensor(full, row_blk, group=mesh.data_group)
    return full.reshape(D, S, r, c)


class ShardMapAligner:
    """Multi-device mapper: same AlignList output as MinimizerAligner, index
    partitioned across a mesh's 'shard' axis. PAF mode only (the taxon
    spine's mode; base-exact CIGAR emit stays a single-device/host
    concern). `device` ("cuda" unless the caller asks for "cpu") is the
    type of device every cell of the mesh must be; the partial redo runs on
    this process's device of that type."""

    def __init__(self, planes: ShardedIndexPlanes, mesh,
                 meta: SequenceMeta | None = None,
                 params: AlignParams | None = None, *, device="cuda"):
        require_device(device, "ShardMapAligner")
        if mesh.shape["shard"] != planes.n_shards:
            raise ValueError(f"mesh has {mesh.shape['shard']} shard "
                             f"columns, the planes {planes.n_shards} shards")
        device = torch.device(device)
        for d, s in mesh.local_cells():
            if mesh.devices[d][s].type != device.type:
                raise ValueError(f"ShardMapAligner(device={str(device)!r}): "
                                 f"cell ({d}, {s}) is on "
                                 f"{mesh.devices[d][s]}")
        self.planes = planes
        self.mesh = mesh
        if mesh.distributed:
            d, s = mesh.coords
            device = mesh.devices[d][s]
        self.device = device
        self.params = params or AlignParams()
        self.meta = meta or SequenceMeta.single_assembly_per_sequence(
            planes.global_seq_names)
        self._dev = {}            # (shard, device) -> its planes (lazy)
        self._fallback = [None] * planes.n_shards
        # per-(data-block, shard) overflow telemetry (partial-redo rate)
        self.overflow_stats = {"blocks": 0, "overflow_blocks": 0,
                               "reads_redone": 0}
        # adaptive cap scales (see MinimizerAligner._devseed_cutoff)
        self._cap_scales = {"w": 1.0, "a": 1.0, "g": 1.0, "out": 1.0}
        self._lut_meta = None     # (lut_bits, n_bisect), with self._luts
        self._n_keys = None       # the largest shard's key count

    def _shard_keys(self) -> int:
        """The largest per-shard key count (pads excluded), counted once:
        the planes do not change, and at 1 Gbp a count takes a few tenths
        of a second of host time, which the reference spends every slice."""
        if self._n_keys is None:
            p = self.planes
            self._n_keys = int(np.count_nonzero(p.keys32 != _HASH_PAD,
                                                axis=1).max()) \
                if p.keys32.size else 0
        return self._n_keys

    def _host_lut_meta(self):
        """(lut_bits, n_bisect) shared by every shard: the LUT sized to the
        largest per-shard key count (pipeline._lut_bits_for policy), the
        bisection depth the largest bucket of any shard needs (extra rounds
        are no-ops once a range is empty)."""
        if self._lut_meta is None:
            p = self.planes
            lut_bits = _lut_bits_for(self._shard_keys(), p.k)
            shift = 2 * p.k - lut_bits
            bounds = (np.arange((1 << lut_bits) + 1, dtype=np.int64)
                      << shift)
            self._luts = [np.searchsorted(p.keys32[s].astype(np.int64),
                                          bounds).astype(np.int32)
                          for s in range(p.n_shards)]
            max_bucket = max(int(np.diff(lut).max()) for lut in self._luts)
            self._lut_meta = (lut_bits, max(1, max_bucket.bit_length()))
        return self._lut_meta

    def _device_arrays(self, s: int, device: torch.device):
        """Shard s's planes on `device` (uploaded once): keys32, pos_t,
        ss16 (int32 on the device, as state.PLANES has it), the paired
        bucket LUT, runcnt, the 4-bit packed reference (halves the largest
        plane), seq_offsets and seq_lengths."""
        key = (s, str(device))
        if key not in self._dev:
            p = self.planes
            self._host_lut_meta()
            lut = self._luts[s]
            planes = device_planes_from_numpy({
                "keys32": p.keys32[s],
                "pos_t": p.pos_t[s].astype(np.int32),
                "ss16": p.pos_ss[s].astype(np.uint16),
                "lut2": np.ascontiguousarray(
                    np.stack([lut[:-1], lut[1:]], axis=1)),
                "runcnt": _run_counts(p.keys32[s].astype(np.int64)),
                "seq4": _pack_seq4(p.seq_data[s]),
                "seq_offsets": p.seq_offsets[s],
                "seq_lengths": p.seq_lengths[s]}, device=device)
            self._dev[key] = tuple(planes[n] for n in (
                "keys32", "pos_t", "ss16", "lut2", "runcnt", "seq4",
                "seq_offsets", "seq_lengths"))
        return self._dev[key]

    def _caps(self, slice_n: int, read_max: int):
        # per-shard hash-space occupancy (spurious hits per query hash);
        # the dense-index anchor sizing lives in _devseed_caps, adaptively
        # scaled on overflow like the single-device mapper
        occ = self._shard_keys() / float(4 ** self.planes.k)
        wtot_max, a_max, g_max = MinimizerAligner._devseed_caps(
            slice_n, read_max, occ)
        sc = self._cap_scales
        if sc["w"] > 1.0:
            wtot_max = _pow2(int(wtot_max * sc["w"]), wtot_max)
        if sc["a"] > 1.0:
            gran = max(wtot_max // 16, 4096)
            a_max = -(-int(a_max * sc["a"]) // gran) * gran
        if sc["g"] > 1.0:
            g_max = _pow2(int(g_max * sc["g"]), g_max)
        out_cap = 2048
        while out_cap < (self.params.devseed_out_per_read * sc["out"]
                         * slice_n):
            out_cap *= 2
        return wtot_max, a_max, g_max, min(out_cap, g_max)

    def _bump_scales(self, counts, caps):
        wtot_max, a_max, g_max, out_cap = caps
        sc = self._cap_scales
        for key, seen, cap in (("w", counts[0], wtot_max),
                               ("a", counts[1], a_max),
                               ("g", counts[2], g_max),
                               ("out", counts[3], out_cap)):
            if seen > cap:
                sc[key] = min(8.0, sc[key] * max(
                    1.25, 1.2 * float(seen) / float(cap)))

    def _shard_fallback_rows(self, sh: int, reads, read_max):
        """Exact host-seeded dispatch against shard sh's local index, run on
        the read-id suffix a cell's device-seeded caps cut. The fallback
        aligner's extension shape (`_ext_shape(read_max)`) is the slice's:
        the same q_max, t_max and band."""
        if self._fallback[sh] is None:
            self._fallback[sh] = MinimizerAligner(
                self.planes.local_index(sh), params=self.params,
                device=self.device)
        al = self._fallback[sh]
        groups = collect_anchors(al.index, reads, max_occ=self.params.max_occ,
                                 min_group_anchors=(
                                     self.params.min_group_anchors),
                                 gap_break=self.params.gap_break)
        if groups.n_groups == 0:
            return np.zeros((0, FUSED_COLS), np.uint16)
        fut, _ctx = al._fused_submit(reads, groups, read_max,
                                     n_rows=_pow2(len(reads)))
        return _to_host_u16(fut)[:-1]

    def map_reads(self, reads: list[np.ndarray],
                  read_names: list[str] | None = None,
                  slice_size: int | None = 2048,
                  emit_cigars: bool = False) -> AlignList:
        if emit_cigars:
            raise ValueError("the mesh path is PAF-mode only "
                             "(emit_cigars=False)")
        if not reads:
            return AlignList.empty(self.planes.global_seq_names,
                                   self.meta.assembly_names, read_names or [])
        step = slice_size or len(reads)
        parts = []
        for s in range(0, len(reads), step):
            parts.append(self._map_slice(reads[s:s + step], s))
        data = np.concatenate(parts) if len(parts) > 1 else parts[0]
        order = np.lexsort((data["sequence_from"], data["sequence_id"],
                            data["read_id"]))
        return AlignList(data[order], list(self.planes.global_seq_names),
                         list(self.meta.assembly_names), read_names or [],
                         None)

    def _map_slice(self, reads, id_base) -> np.ndarray:
        p = self.params
        planes = self.planes
        mesh = self.mesh
        n_data = mesh.shape.get("data", 1)
        # read block per data row (data-parallel axis); every block padded
        # to nd rows, so every cell's dispatch has one shape
        nd = _pow2((len(reads) + n_data - 1) // n_data, 256)
        read_max = _pow2(max(len(r) for r in reads), 256)
        band = p.band if p.band is not None else (
            128 if read_max <= 2048 else (256 if read_max <= 8192 else 512))
        if read_max + band >= 2 ** 15:
            raise ValueError("fused gate: reads too long for the mesh path")
        t_max = -(-(read_max + band) // 256) * 256
        wtot_max, a_max, g_max, out_cap = self._caps(nd, read_max)
        lut_bits, n_bisect = self._host_lut_meta()

        blocks_in = [reads[d * nd: (d + 1) * nd] for d in range(n_data)]
        qlens_a = np.zeros((n_data, nd), np.int32)
        for d, b in enumerate(blocks_in):
            qlens_a[d, :len(b)] = [len(r) for r in b]
        cell_rows, packed = {}, {}
        for d, s in mesh.local_cells():
            dev = mesh.devices[d][s]
            if (d, str(dev)) not in packed:
                packed[(d, str(dev))] = tuple(
                    torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in (*_pack_reads2(blocks_in[d], read_max,
                                            n_rows=nd), qlens_a[d]))
            keys32, pos_t, ss16, lut2, runcnt, seq4, seq_off, seq_len = \
                self._device_arrays(s, dev)
            cell_rows[(d, s)] = _fused_map_dispatch_devseed(
                *packed[(d, str(dev))], keys32, pos_t, ss16, lut2, runcnt,
                seq4, seq_off, seq_len, k=planes.k, w=planes.w,
                max_occ=p.max_occ, min_group_anchors=p.min_group_anchors,
                gap_break=p.gap_break, cap=p.fused_anchor_cap,
                seq_bits=planes.seq_bits, lut_bits=lut_bits,
                n_bisect=n_bisect, wtot_max=wtot_max, a_max=a_max,
                g_max=g_max, out_cap=out_cap, q_max=read_max, t_max=t_max,
                band=band, match=p.match, mismatch=p.mismatch,
                gap_open=p.gap_open, gap_extend=p.gap_extend,
                min_chain_score=p.min_chain_score,
                max_per_read=p.max_alignments_per_read,
                window_pad=p.window_pad)
        # one device-to-host fetch of the whole (D, S, out_cap+1, 16) block
        blocks = _to_host_u16(_gather_blocks(mesh, cell_rows))

        shard_rows = []
        for d in range(n_data):
            for sh in range(planes.n_shards):
                counts = _unpack_counts_row(blocks[d, sh, -1])
                n_real = len(blocks_in[d])
                cutoff = min(int(counts[4]), n_real)
                # keep rows only, with local -> global sequence id remap and
                # block-local -> slice-local read id offset (rows widen to
                # int64 here, after the uint16 mask, so neither wraps)
                r = blocks[d, sh, :-1].astype(np.int64)
                r = r[r[:, F_KEEP] == 1]
                if cutoff < n_real:
                    # partial redo: device rows below the cutoff are exact;
                    # only the truncated read-id suffix re-runs host-seeded
                    # against this shard's local index
                    self.overflow_stats["overflow_blocks"] += 1
                    self.overflow_stats["reads_redone"] += n_real - cutoff
                    self._bump_scales(counts,
                                      (wtot_max, a_max, g_max, out_cap))
                    r = r[r[:, F_RID] < cutoff]
                    fb = self._shard_fallback_rows(
                        sh, blocks_in[d][cutoff:], read_max).astype(np.int64)
                    fb = fb[fb[:, F_KEEP] == 1]
                    fb[:, F_RID] += cutoff
                    r = np.concatenate([r, fb]) if len(fb) else r
                self.overflow_stats["blocks"] += 1
                r[:, F_SEQ] = planes.seq_global[sh][r[:, F_SEQ]]
                r[:, F_RID] += d * nd
                shard_rows.append(r)
        arr = np.concatenate(shard_rows) if shard_rows else \
            np.zeros((0, FUSED_COLS), np.int64)

        # global per-read top-K chain gate over the shard union (each shard
        # kept its local top-K; the union is a superset of the global top-K
        # - same merge rule as the reference's index-batch passes)
        if len(arr):
            order = np.lexsort((np.arange(len(arr)), -arr[:, F_CHAIN],
                                arr[:, F_RID]))
            rid_o = arr[order, F_RID]
            newrun = np.append(True, rid_o[1:] != rid_o[:-1])
            run_start = np.maximum.accumulate(
                np.where(newrun, np.arange(len(order)), 0))
            rank = np.arange(len(order)) - run_start
            arr = arr[np.sort(order[rank < p.max_alignments_per_read])]

        al = fused_collect_np(
            arr, qlens_a.reshape(-1), id_base, None, p,
            self.planes.global_seq_names, self.planes.global_seq_lengths,
            self.meta)
        return al.data


def _pow2(x, lo=256):
    b = lo
    while b < x:
        b *= 2
    return b
