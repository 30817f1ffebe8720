"""Driver: map calls one after another against an index built in set-up.

A request is one call of
`MinimizerAligner(index, device=...).map_reads(reads, slice_size=...,
emit_cigars=...)` on one batch of a pool that set-up made from the seed;
calls cycle through the pool. The index is built from the configuration's
world in every run, by the program's `MinimizerIndex.build`.

After the window: every read of every batch that completed is judged for
its placement, and a sample of primary alignments, drawn from the seed
with the longest read in it, for its score (`reference.map_check`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from core import roofline, sim, trace, worlds
from reference import map_check

READ_STREAM = 3
SAMPLE_STREAM = 4


class MapCell:
    def __init__(self, ctx):
        from megapath_nano_tpu_torch.align import pipeline
        from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex

        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.device = ctx.device
        self.pipeline = pipeline
        score = self.config["scoring"]
        defaults = pipeline.AlignParams()
        for key, val in score.items():
            if getattr(defaults, key) != val:
                raise RuntimeError(
                    f"the program's AlignParams.{key} is "
                    f"{getattr(defaults, key)}, the configuration states "
                    f"{val}")
        world = worlds.build(self.config, self.device)
        self.genome_flat = world.flat.cpu().numpy()
        self.offsets = world.offsets
        self.seq_species = np.array([t[1] for t in world.tax], np.int64)
        genomes = [self.genome_flat[world.offsets[i]: world.offsets[i + 1]]
                   for i in range(len(world.names))]
        self._make_batches(world, ctx.seed)
        world.flat = None
        self.world = world         # its lifts judge placements on strains
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        idx = self.config["index"]
        self.index = MinimizerIndex.build(genomes, None, k=idx["k"],
                                          w=idx["w"])
        self.aligner = pipeline.MinimizerAligner(self.index,
                                                 device=self.device)
        self.results = {}          # batch -> AlignList data of its last call
        self.calls = 0
        self.ext_calls = {"sw_full": [], "sw_scores": []}
        self.host_s = {"collect_anchors": [], "banded_align_batch": []}
        self._orig = {}
        if ctx.trace:
            self._wrap()
        self._call(0)              # warm-up: the window's shapes

    def _make_batches(self, world, seed):
        rng, gen = sim.generators(seed, READ_STREAM, self.device)
        self.batches = [worlds.simulate(world, self.traffic,
                                        self.traffic["reads_per_call"], rng,
                                        gen, part=b)
                        for b in range(self.traffic["pool"])]
        self.bases = [b.bases for b in self.batches]

    def reseed(self, seed):
        """New batches from another seed, on the same index (the control's
        readings over many seeds in one process)."""
        self.ctx.seed = seed
        world = worlds.build(self.config, self.device)
        self._make_batches(world, seed)
        world.flat = None
        self.world = world
        self.results, self.calls = {}, 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _wrap(self):
        """Harness-side wrappers of the program's functions, in traced runs
        only: the extension kernels' shapes, the host seeding's and the
        host traceback's time, a range around device seeding."""
        pl = self.pipeline
        self._orig = {name: getattr(pl, name) for name in (
            "build_groups_device", "banded_sw_full", "banded_sw_scores",
            "collect_anchors", "banded_align_batch")}

        def ranged(name):
            fn = self._orig[name]

            def call(*a, **kw):
                with trace.span(name):
                    return fn(*a, **kw)
            return call

        def shapes(name):
            fn, rec = self._orig["banded_" + name], self.ext_calls[name]

            def call(reads, read_lens, refs, ref_lens, **kw):
                rec.append((reads.shape, refs.shape, read_lens, kw["band"]))
                return fn(reads, read_lens, refs, ref_lens, **kw)
            return call

        def timed(name):
            fn, rec = self._orig[name], self.host_s[name]

            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    with trace.span(name):
                        return fn(*a, **kw)
                finally:
                    rec.append(time.perf_counter() - t)
            return call

        pl.build_groups_device = ranged("build_groups_device")
        pl.banded_sw_full = shapes("sw_full")
        pl.banded_sw_scores = shapes("sw_scores")
        pl.collect_anchors = timed("collect_anchors")
        pl.banded_align_batch = timed("banded_align_batch")

    def _call(self, b):
        reads = self.batches[b].reads
        return self.aligner.map_reads(reads, None,
                                      slice_size=self.traffic["slice_size"],
                                      emit_cigars=self.traffic["emit_cigars"])

    def start_window(self):
        for rec in list(self.ext_calls.values()) + list(self.host_s.values()):
            rec.clear()

    def request(self) -> dict:
        b = self.calls % len(self.batches)
        st = self.aligner.overflow_stats
        redo0, slices0 = st["reads_redone"], st["slices"]
        with trace.span("map_call", self.ctx.trace):
            al = self._call(b)
        self.calls += 1
        self.results[b] = al.data
        n = len(self.batches[b].reads)
        return {"kind": "map_call", "reads": n, "bases": self.bases[b],
                "ok": True,
                "reads_redone": st["reads_redone"] - redo0,
                "slices": st["slices"] - slices0}

    def ext_roofline(self, kernel: str):
        """(least seconds, the bound's side) of the window's recorded calls
        of the extension kernel `kernel` (sw_full or sw_scores)."""
        cols, ops_cell = {
            "sw_full": (roofline.SW_FULL_OUT_COLS,
                        roofline.SW_FULL_OPS_PER_CELL),
            "sw_scores": (roofline.SW_SCORES_OUT_COLS,
                          roofline.SW_SCORES_OPS_PER_CELL)}[kernel]
        total, by = 0.0, {}
        for rshape, tshape, rl, band in self.ext_calls[kernel]:
            nb, ops = roofline.sw_counts(rshape[0], rshape[1], tshape[1],
                                         rl.cpu().numpy(), band,
                                         out_cols=cols, ops_per_cell=ops_cell)
            s, side = roofline.bound(nb, ops)
            total += s
            by[side] = by.get(side, 0.0) + s
        side = max(by, key=by.get) if by else None
        return total, side

    def notes(self, run):
        """The side that bounds each extension kernel's least time, and how
        many calls of it the window made."""
        out = {}
        for kernel, rec in self.ext_calls.items():
            out[kernel + "_calls"] = len(rec)
            if rec:
                out[kernel + "_bound_by"] = self.ext_roofline(kernel)[1]
        return out

    def close_program(self):
        for name, fn in self._orig.items():
            setattr(self.pipeline, name, fn)
        self.aligner = None
        self.index = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self, data_of=None):
        """Readings of every completed batch; data_of(b, data) may stand in
        another program's answers (the control and the faults)."""
        t = self.traffic
        mis, n = 0, 0
        rows = []
        for b in sorted(self.results):
            data = self.results[b] if data_of is None \
                else data_of(b, self.results[b])
            batch = self.batches[b]
            prim = map_check.primary_rows(data, len(batch.reads))
            gspecies = self.seq_species[batch.genome]
            # the source interval carried onto the strain it was placed on
            placed = np.clip(data["sequence_id"][np.maximum(prim, 0)]
                             .astype(np.int64), 0, len(self.seq_species) - 1) \
                if len(data) else batch.genome
            t0 = self.world.lift(batch.start, batch.genome, placed)
            t1 = self.world.lift(batch.end, batch.genome, placed)
            bad = map_check.misplaced(data, prim, gspecies, t0, t1,
                                      self.seq_species)
            mis += int(bad.sum())
            n += len(batch.reads)
            rows.append((b, data, prim))
        rng = np.random.default_rng(sim.stream_seed(self.ctx.seed,
                                                    SAMPLE_STREAM))
        cand = [(b, r) for b, _, prim in rows for r in np.flatnonzero(prim >= 0)]
        out = {"misplaced_pct": 100.0 * mis / max(n, 1) if n else 100.0}
        if not cand:
            out.update(score_over=float(t["check_sample"]),
                       score_short_pct=100.0)
            return out
        lens = np.array([len(self.batches[b].reads[r]) for b, r in cand])
        pick = map_check.sample_reads(rng, lens, np.arange(len(cand)),
                                      t["check_sample"])
        prims = {b: (data, prim) for b, data, prim in rows}
        sel_rows, all_reads = [], []
        for i in pick:
            b, r = cand[i]
            data, prim = prims[b]
            row = data[prim[r]].copy()
            row["read_id"] = len(all_reads)
            all_reads.append(self.batches[b].reads[r])
            sel_rows.append(row)
        sel = np.array(sel_rows, dtype=sel_rows[0].dtype)
        best = map_check.best_scores(sel, all_reads, self.genome_flat,
                                     self.offsets, self.config["scoring"],
                                     self.device)
        over, short = map_check.score_numbers(
            sel["alignment_score"].astype(np.int64), best)
        out.update(score_over=float(over), score_short_pct=short)
        return out

    def check(self) -> dict:
        return self.judged()

    def control_readings(self) -> dict:
        """The numbers of the control (the program with its band fixed at
        the traffic's `control_band`, the step that would tempt a later
        change) and of planted faults on this window's answers: the rows
        of the second half of every batch left out, every score raised
        by one."""
        params = self.pipeline.AlignParams(band=self.traffic["control_band"])
        ctl = self.pipeline.MinimizerAligner(self.index, params=params,
                                             device=self.device)
        ctl_data = {b: ctl.map_reads(
            self.batches[b].reads, None,
            slice_size=self.traffic["slice_size"],
            emit_cigars=self.traffic["emit_cigars"]).data
            for b in self.results}
        del ctl

        def half(b, d):
            return d[d["read_id"] < len(self.batches[b].reads) // 2]

        def bump(b, d):
            d = d.copy()
            d["alignment_score"] += 1
            return d

        return {"control": self.judged(lambda b, d: ctl_data[b]),
                "faults": {"half": self.judged(half),
                           "answer": self.judged(bump)}}

    def cleanup(self):
        pass


def setup(ctx) -> MapCell:
    return MapCell(ctx)
