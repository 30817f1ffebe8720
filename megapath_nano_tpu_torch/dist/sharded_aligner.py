"""Host-loop sharded mapping — the EXACT-FALLBACK tier of dist/.

The production multi-chip path is `dist/fused_sharded.ShardMapAligner`
(one shard_map dispatch over the mesh, PAF mode). This module is the
host-loop equivalent: S shard-local MinimizerAligners run in turn on one
device and merge exactly — no mesh needed, and it supports CIGAR-emit
mode, which the shard_map path does not. Used by `cli/main.py
--index_shards` and as the reference semantics for the shard_map tests.

The multi-host execution model mirrors the reference streaming minimap2
index batches with `-I` and merging per-pass results on one host
(SURVEY §2.7; reference: bin/megapath_nano.py:4019-4022,
bin/lib/aligner.py:211-217). The assembly set is partitioned into S shards,
each shard holds its own MinimizerIndex, and per-shard align lists are
merged:

  - alignment of a read against a target sequence depends only on that
    sequence, so per-shard results equal the single-index results restricted
    to the shard's sequences;
  - the global per-read top-N gate and the mapq best-vs-second ratio are
    recomputed at merge over the union (both are functions of the
    per-(read, sequence) best scores, which every shard reports);
  - the deterministic tiebreaker is a hash of global ids, so it is
    shard-layout-invariant.

The one intentional divergence from a monolithic index: the max_occ repeat
mask counts minimizer occurrences per shard, exactly like minimap2's
per-index-batch mid-occurrence filter.

The port's own copy of megapath_nano_tpu/dist/sharded_aligner.py: every
shard's MinimizerAligner maps on the `device` given to `build` (the GPU
unless the caller asks for "cpu"), one shard after another. The mesh path
is `dist/fused_sharded.ShardMapAligner` (one process, or one rank a cell
on torch.distributed; `dist/mesh.py`).
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                    MinimizerAligner,
                                                    SequenceMeta,
                                                    _stable_uniform,
                                                    require_device,
                                                    select_alignments)
from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex


class ShardedAligner:
    """S shard-local aligners + exact merge. On a multi-chip mesh each shard
    maps on its own device; single-process execution runs them in turn."""

    def __init__(self, shard_aligners, seq_id_maps, seq_names, assembly_names,
                 params: AlignParams):
        self.shards = shard_aligners
        self.seq_id_maps = seq_id_maps          # per shard: local -> global
        self.sequence_names = seq_names
        self.assembly_names = assembly_names
        self.params = params

    @staticmethod
    def build(sequences, seq_names, seq_assembly, assembly_names,
              n_shards: int, *, meta: SequenceMeta | None = None,
              params: AlignParams | None = None, k: int = 15, w: int = 10,
              device="cuda"):
        """Partition assemblies round-robin across shards and build each
        shard's index. seq_assembly maps sequence -> assembly index. Every
        shard maps on `device`."""
        require_device(device, "ShardedAligner.build")
        params = params or AlignParams()
        seq_assembly = np.asarray(seq_assembly)
        if meta is None:
            meta = SequenceMeta(
                assembly_idx=seq_assembly.astype(np.int32),
                assembly_names=list(assembly_names),
                tax_id=np.zeros(len(sequences), np.int64),
                species_tax_id=np.zeros(len(sequences), np.int64),
                genus_tax_id=np.zeros(len(sequences), np.int64))
        shard_of_assembly = np.arange(len(assembly_names)) % n_shards
        aligners, maps = [], []
        for sh in range(n_shards):
            sel = np.flatnonzero(shard_of_assembly[seq_assembly] == sh)
            if len(sel) == 0:
                aligners.append(None)
                maps.append(np.zeros(0, np.int64))
                continue
            idx = MinimizerIndex.build([sequences[i] for i in sel],
                                       [seq_names[i] for i in sel], k=k, w=w)
            sub_meta = SequenceMeta(
                assembly_idx=meta.assembly_idx[sel],
                assembly_names=list(assembly_names),
                tax_id=meta.tax_id[sel],
                species_tax_id=meta.species_tax_id[sel],
                genus_tax_id=meta.genus_tax_id[sel])
            aligners.append(MinimizerAligner(idx, sub_meta, params,
                                            device=device))
            maps.append(sel.astype(np.int64))
        return ShardedAligner(aligners, maps, list(seq_names),
                              list(assembly_names), params)

    def map_reads(self, reads, read_names=None, slice_size=None,
                  emit_cigars: bool = False) -> AlignList:
        parts = []
        cigar_map: dict = {} if emit_cigars else None
        for sh, al in enumerate(self.shards):
            if al is None:
                continue
            part = al.map_reads(reads, None, slice_size=slice_size,
                                emit_cigars=emit_cigars)
            if len(part) == 0:
                continue
            remap = self.seq_id_maps[sh]
            data = part.data.copy()
            data["sequence_id"] = remap[data["sequence_id"]]
            parts.append(data)
            if emit_cigars and part.cigar_map:
                cigar_map.update({(k[0], int(remap[k[1]]), *k[2:]): v
                                  for k, v in part.cigar_map.items()})
        if not parts:
            return AlignList.empty(self.sequence_names, self.assembly_names,
                                   read_names or [])
        data = np.concatenate(parts)

        # re-run the minimap2-style -N/-p selection over the cross-shard
        # union: each shard marked primaries/secondaries against its local
        # candidates only, so the merged set must be re-ranked globally —
        # same rule as minimap2 merging its per-index-batch hits
        # (reference lib/aligner.py:211-217 FIFO chunk merge)
        sel, mapq, _is_sec = select_alignments(
            data["read_id"], data["alignment_score"],
            data["read_from"], data["read_to"], data["sequence_id"],
            data["strand"], data["sequence_from"], data["sequence_to"],
            secondary_ratio=self.params.secondary_ratio,
            mask_level=self.params.mask_level,
            max_secondary=self.params.max_alignments_per_read)
        data = data[sel]
        data["mapq"] = mapq
        n_seqs = len(self.sequence_names)
        data["alignment_score_tiebreaker"] = _stable_uniform(
            self.params.tiebreaker_seed, data["read_id"],
            data["sequence_id"].astype(np.int64) * np.int64(n_seqs + 1)
            + data["sequence_from"])
        order = np.lexsort((data["sequence_from"], data["sequence_id"],
                            data["read_id"]))
        return AlignList(data[order], self.sequence_names,
                         self.assembly_names, read_names or [], cigar_map)
