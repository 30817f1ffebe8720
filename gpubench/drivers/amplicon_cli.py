"""Driver: amplicon samples called one after another by the port's CLI.

A request is one sample: one in-process call of
`megapath_nano_tpu_torch.cli.amplicon.main` on a FASTQ that set-up wrote
from the seed (`core.amplicons`), with `--screen_db`, `--target_assembly`,
`--target_db` and `--device`, everything else at its defaults (the shipped
ensemble, AF 0.125, depth 4, realignment on), into a fresh output folder.
Both RefDBs are built from the configuration's world once per checkout
(cache/<config>/): the screen DB of every genome and the target DB of the
target alone.

Wrappers of the program's functions, in every run, keep references to what
the window's samples produced (they copy nothing): each profile's reads,
names and result (the last of a sample is align_to_target's), each
`stranded_pileup`'s counts, each `ensemble_merge`'s merged probabilities
and rows, each `call_variants`' calls, each `realign_candidates`' counts
with the windows and alignments of its `banded_align_batch` calls, and the
number of `VariantModel.predict` calls, which traced runs also wrap in the
harness range `gpubench.clairnet`; traced runs also record the shapes of
the maps' `banded_sw_scores` calls. After the window
`reference.variant_check`, `reference.clairnet`, `reference.realign_check`
and `reference.map_check` judge them.

The metric readers find a window's program spans under the last
`len(requests)` `cli.amplicon` roots: importing this driver adds the cell's
request kind to `core.spans.ROOTS`.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import inspect
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from core import amplicons, clairnet_roofline, sim, spans, trace, worlds
from core.spec import Spec
from reference import clairnet, map_check, realign_check, variant_check

spans.ROOTS.setdefault("amplicon_sample", "cli.amplicon")

READ_STREAM = 5
SAMPLE_STREAM = 6
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the cached RefDBs are made by: the harness's world, the program's
# RefDB.build / save and its minimizer index
STAMPED = (os.path.join(HERE, "core"), "megapath_nano_tpu_torch/db",
           "megapath_nano_tpu_torch/index")


def _stamp(config: dict) -> str:
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    root = os.path.dirname(HERE)
    for d in STAMPED:
        d = os.path.join(root, d)
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                h.update(name.encode())
                with open(os.path.join(d, name), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def program_widths() -> dict:
    """The variant path's widths and settings as the program has them."""
    from megapath_nano_tpu_torch.cli import amplicon
    from megapath_nano_tpu_torch.variant import caller, candidates
    from megapath_nano_tpu_torch.variant import pretrained

    man = pretrained.manifest() or {}
    args = amplicon.build_parser().parse_args(["--query", "q",
                                               "--target_db", "d"])
    slices = {clairnet.load_params(os.path.join(
        pretrained.default_model_dir(), m))["Dense_0"]["kernel"].shape[1]
        for m in man.get("models", [])}
    return {
        "hidden": man.get("hidden"), "models": len(man.get("models", [])),
        "slice": slices.pop() if len(slices) == 1 else None,
        "flanking": candidates.FLANKING, "rows": candidates.ROWS,
        "channels": candidates.CHANNELS,
        "depth_cap": candidates.MATRIX_DEPTH_CAP, "af": args.af,
        "min_depth": args.min_depth,
        "batch": inspect.signature(caller.call_variants).parameters[
            "batch_size"].default}


class AmpliconCell:
    def __init__(self, ctx):
        from megapath_nano_tpu_torch.align.pipeline import AlignParams

        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.device = ctx.device
        want = self.config["variant"]
        have = program_widths()
        bad = {k: (have.get(k), v) for k, v in want.items()
               if have.get(k) != v}
        if bad:
            raise RuntimeError(f"the program's variant widths differ from "
                               f"the configuration's (program, config): "
                               f"{bad}")
        defaults = AlignParams()
        for key, val in self.config["scoring"].items():
            if getattr(defaults, key) != val:
                raise RuntimeError(
                    f"the program's AlignParams.{key} is "
                    f"{getattr(defaults, key)}, the configuration states "
                    f"{val}")
        self.work = tempfile.mkdtemp(prefix="gpubench-amplicon-")
        world = worlds.build(self.config, self.device)
        self.target = world.flat[: int(world.offsets[1])].cpu().numpy()
        self.target_name = world.names[0]
        self.panel = amplicons.panel(self.config, len(self.target))
        self.screen_db, self.target_db = self._refdbs(world)
        self.samples = []          # (fastq path, names, amplicons.Sample)
        self._make_samples(world, ctx.seed)
        del world
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        from megapath_nano_tpu_torch.cli.amplicon import main
        from megapath_nano_tpu_torch.utils.log import Log

        self.cli_main = main
        self.log_cls = Log
        self._step = Log.step
        self._orig = []
        self.records = []          # per request: what the wrappers kept
        self._memo = {}            # the reference's answers to them
        self._cur = None
        self._batches = None       # the realignment call running, if any
        self.ext_calls = {"sw_scores": []}
        self._wrap()
        if ctx.trace:
            self._wrap_steps()
        # warm-up: one small sample through the same entry
        self._run(self.warmup_path, os.path.join(self.work, "warmup"))
        self.records = []

    # --- set-up -----------------------------------------------------------

    def _refdbs(self, world) -> tuple[str, str]:
        """cache/<config>/{screen,target}, rebuilt when the configuration,
        the harness's generators or the program's DB and index code
        change."""
        stamp = _stamp(self.config)
        base = os.path.join(self.ctx.cache_dir, self.config["name"])
        dirs = os.path.join(base, "screen"), os.path.join(base, "target")
        stamp_path = os.path.join(base, "stamp")
        if os.path.exists(stamp_path) and open(stamp_path).read() == stamp \
                and all(os.path.exists(os.path.join(d, "refdb.npz"))
                        for d in dirs):
            return dirs
        from megapath_nano_tpu_torch.db.refdb import RefDB

        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        genomes = world.genomes_np()
        idx = self.config["index"]
        for d, keep in zip(dirs, (range(len(genomes)), range(1))):
            keep = list(keep)
            db = RefDB.build([genomes[i] for i in keep],
                             [world.names[i] for i in keep],
                             list(range(len(keep))),
                             [f"asm_{world.names[i]}" for i in keep],
                             [world.tax[i] for i in keep], world.tax_names,
                             k=idx["k"], w=idx["w"])
            tmp = d + ".tmp"
            db.save(tmp)
            os.replace(tmp, d)
        with open(stamp_path, "w") as f:
            f.write(stamp)
        return dirs

    def reseed(self, seed):
        """New samples from another seed, on the same RefDBs (the control's
        readings over many seeds in one process)."""
        self.ctx.seed = seed
        world = worlds.build(self.config, self.device)
        self.samples, self.records, self._memo = [], [], {}
        self._make_samples(world, seed)
        del world
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _make_samples(self, world, seed):
        t = self.traffic
        rng, gen = sim.generators(seed, READ_STREAM, self.device)
        sizes = [t["warmup_reads"]] + [t["reads_per_sample"]] * t["pool"]
        for k, n in enumerate(sizes):
            s = amplicons.simulate(world, self.panel, t, n, rng, gen, part=k)
            names = [f"s{k}r{i}" for i in range(n)]
            path = os.path.join(self.work, f"sample{k}.fastq")
            with open(path, "wb") as f:
                f.write(sim.fastq_bytes(names, s.reads, s.quals))
            if k == 0:
                self.warmup_path = path
            else:
                self.samples.append((path, names, s))

    def _wrap(self):
        """The wrappers that keep what the window produced (every run), and
        the harness range around each model call (traced runs)."""
        from megapath_nano_tpu_torch.align import pipeline
        from megapath_nano_tpu_torch.taxon import profiler
        from megapath_nano_tpu_torch.variant import (caller, candidates,
                                                     model, realign)

        traced = self.ctx.trace

        def keep(owner, name, make):
            fn = getattr(owner, name)
            self._orig.append((owner, name, fn))
            setattr(owner, name, make(fn))

        def kept(key):
            return self._cur.setdefault(key, []) if self._cur is not None \
                else []

        def profile(fn):
            def call(prof, reads, read_names=None, *a, **kw):
                res = fn(prof, reads, read_names, *a, **kw)
                kept("profiles").append((reads, read_names, res))
                return res
            return call

        def pileup(fn):
            def call(align_list, reads, sequence_id, seq_len, *a, **kw):
                counts = fn(align_list, reads, sequence_id, seq_len, *a, **kw)
                kept("pileups").append((align_list, reads, sequence_id,
                                        counts))
                return counts
            return call

        def merge(fn):
            def call(per_model, *a, **kw):
                merged = fn(per_model, *a, **kw)
                kept("merged").append((merged,
                                       sum(len(d) for d in per_model)))
                return merged
            return call

        def calls(fn):
            def call(align_list, reads, sequence_id, ref_seq, *a, **kw):
                out = fn(align_list, reads, sequence_id, ref_seq, *a, **kw)
                kept("calls").append((sequence_id, ref_seq, out))
                return out
            return call

        def predict(fn):
            def call(m, batch):
                kept("predict").append(len(batch))
                with trace.span("clairnet", traced):
                    return fn(m, batch)
            return call

        def realigned(fn):
            def call(align_list, reads, sequence_id, ref_seq, positions,
                     *a, **kw):
                self._batches = batches = []
                try:
                    out = fn(align_list, reads, sequence_id, ref_seq,
                             positions, *a, **kw)
                finally:
                    self._batches = None
                kept("realign").append(dict(
                    al=align_list, reads=reads, sid=int(sequence_id),
                    ref_seq=ref_seq, positions=list(positions), out=out,
                    batches=batches))
                return out
            return call

        def aligned(fn):
            def call(reads, refs, *a, **kw):
                alns = fn(reads, refs, *a, **kw)
                if self._batches is not None and len(refs):
                    self._batches.append((reads, refs[0], alns))
                return alns
            return call

        def shapes(fn):
            rec = self.ext_calls["sw_scores"]

            def call(reads, read_lens, refs, ref_lens, **kw):
                rec.append((reads.shape, refs.shape, read_lens, kw["band"]))
                return fn(reads, read_lens, refs, ref_lens, **kw)
            return call

        keep(profiler.TaxonProfiler, "profile", profile)
        keep(candidates, "stranded_pileup", pileup)
        keep(caller, "ensemble_merge", merge)
        keep(caller, "call_variants", calls)
        keep(model.VariantModel, "predict", predict)
        keep(realign, "realign_candidates", realigned)
        keep(realign, "banded_align_batch", aligned)
        if traced:
            keep(pipeline, "banded_sw_scores", shapes)

    def _wrap_steps(self):
        step = self._step

        from contextlib import contextmanager

        @contextmanager
        def traced_step(log, name):
            with trace.span("step." + name):
                with step(log, name):
                    yield

        self.log_cls.step = traced_step

    # --- the window ---------------------------------------------------------

    def _argv(self, path, out):
        return ["--query", path, "--screen_db", self.screen_db,
                "--target_assembly", f"asm_{self.target_name}",
                "--target_db", self.target_db, "--output_folder", out,
                "--device", self.device.type]

    def _run(self, path, out):
        rc = self.cli_main(self._argv(path, out))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rc

    def start_window(self):
        self.records, self._memo = [], {}
        self.ext_calls["sw_scores"].clear()

    def request(self) -> dict:
        k = len(self.records) % len(self.samples)
        path, names, s = self.samples[k]
        out = tempfile.mkdtemp(prefix="s", dir=self.work)
        self._cur = {"k": k, "out": out}
        try:
            with trace.span("sample", self.ctx.trace):
                rc = self._run(path, out)
        finally:
            rec, self._cur = self._cur, None
            self.records.append(rec)
        rec["rc"] = rc
        return {"kind": "amplicon_sample", "reads": len(s.reads),
                "bases": s.bases, "ok": rc == 0}

    def close_program(self):
        for owner, name, fn in reversed(self._orig):
            setattr(owner, name, fn)
        self._orig = []
        self.log_cls.step = self._step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- readers' helpers ---------------------------------------------------

    def model_rows(self) -> tuple[int, int]:
        """(candidate rows the models scored, model calls) in the window."""
        rows = sum(n for r in self.records for _, n in r.get("merged", []))
        return rows, sum(len(r.get("predict", [])) for r in self.records)

    # the map cell's arithmetic over the recorded sw_scores calls
    ext_roofline = Spec.driver("map_reads").MapCell.ext_roofline

    def clairnet_least_s(self) -> tuple[float, str]:
        rows, calls = self.model_rows()
        return clairnet_roofline.least_s(rows, calls,
                                         clairnet_roofline.widths(
                                             self.config["variant"]))

    # --- after the window ---------------------------------------------------

    def judged(self, program=None, band=realign_check.BAND) -> dict:
        """Per completed sample, the program's answers and the reference's
        beside them. `program(rec)` may stand in another program's answers
        (the control and the faults); `band` is the band of the
        realignment's reference (the control's is narrower)."""
        out = []
        dev = self.device
        nets = [clairnet.Net(tree, dev) for tree in clairnet.shipped()]
        ref_t = torch.as_tensor(self.target, device=dev)
        for rec in self.records:
            if rec.get("rc") != 0:
                out.append(None)
                continue
            rec = program(rec) if program is not None else rec
            _, names, s = self.samples[rec["k"]]
            j = {"k": rec["k"], "pileup_wrong": 0, "gaps": [],
                 "differ": 0, "ties": 0, "candidates": 0, "calls": 0}
            for (al, reads, sid, counts), (merged, _), (_, ref_seq, calls) \
                    in zip(rec.get("pileups", []), rec.get("merged", []),
                           rec.get("calls", [])):
                ref_counts = self._reference_pileup(al, reads, int(sid),
                                                    counts.shape[1])
                j["pileup_wrong"] += int(np.count_nonzero(
                    ref_counts.cpu().numpy() != counts))
                rseq = ref_t if len(ref_seq) == len(self.target) else \
                    torch.as_tensor(ref_seq, device=dev)
                pos = variant_check.candidates(ref_counts, rseq)
                x = variant_check.tensors(ref_counts, rseq, pos)
                probs = rec.get("reference", variant_check.ensemble)(nets, x)
                pos = pos.cpu().numpy()
                j["candidates"] += len(pos)
                j["gaps"].append(self._gap(merged, probs, int(sid), pos))
                d, ties = self._differ(calls, probs, ref_seq, pos)
                j["differ"] += d
                j["ties"] += ties
                j["calls"] += len(calls)
            prof = rec.get("profiles", [])
            j["target"] = prof[-1] if prof else None
            kept = set(prof[-1][1] or []) if prof else set()
            off = [nm for nm, g in zip(names, s.genome) if g != 0]
            j["offtarget_kept"] = sum(1 for nm in off if nm in kept)
            j["offtarget"] = len(off)
            vcf = rec.get("vcf") or _read_vcf(os.path.join(rec["out"],
                                                           "amplicon.vcf"))
            found = {(p, a) for p, a, _, _ in vcf}
            # realignment: each call's windows, scores and support against
            # the reference's, and the VCF against the CLI's rule on them
            want = set()
            j["realign_wrong"] = j["realign_pairs"] = 0
            for rr in rec.get("realign", []):
                wrong, pairs, keep = self._realign(rr, rec, band)
                j["realign_wrong"] += wrong
                j["realign_pairs"] += pairs
                want |= keep
            j["vcf_differ"] = len(want ^ set(vcf))
            j["realigned_calls"] = sum(len(rr["positions"])
                                       for rr in rec.get("realign", []))
            called = {(int(c.position), c.alt)
                      for _, _, cs in rec.get("calls", []) for c in cs}
            planted = [(int(p), "ACGT"[a]) for p, a in zip(s.snv_pos,
                                                         s.snv_alt)]
            j["planted"] = len(planted)
            j["missed"] = sum(1 for x in planted if x not in found)
            # where the misses arise: the models, or realignment near an
            # amplicon's ends (the two defects the cell keeps visible)
            near = s.snv_edge < self.traffic["edge_bases"]
            j["by_models"] = sum(1 for x in planted if x in called)
            j["dropped_near_edge"] = sum(
                1 for x, e in zip(planted, near)
                if e and x in called and x not in found)
            j["dropped_inside"] = sum(
                1 for x, e in zip(planted, near)
                if not e and x in called and x not in found)
            j["het_missed"] = sum(1 for x, af in zip(planted, s.snv_af)
                                  if af < 1.0 and x not in found)
            out.append(j)
        return out

    def _realign(self, rr, rec, band) -> tuple[int, int, set]:
        """(the realignment's wrong windows, scores and counts at one
        `realign_candidates` call, the pairs it realigned, the VCF records
        the CLI's rule gives on the reference's recount of its calls)."""
        ref_seq = np.asarray(rr["ref_seq"])
        al, sid = rr["al"], rr["sid"]
        rows = al.data[al.data["sequence_id"] == sid]
        alt = {int(c.position): c.alt for s_, _, cs in rec.get("calls", [])
               if s_ == sid for c in cs}
        batches = list(rr["batches"])
        wrong = pairs = 0
        keep = set()
        for pos, got in zip(rr["positions"], rr["out"]):
            lo, want = realign_check.windows(rows, al.cigar_map, rr["reads"],
                                             sid, pos, len(ref_seq))
            target = ref_seq[lo: min(pos + realign_check.REF_WINDOW + 1,
                                     len(ref_seq))]
            # the program aligns once per call with covering reads, in
            # the calls' order: its next batch is this call's if it holds
            # this call's reference window
            have, alns = [], []
            if batches and np.array_equal(batches[0][1], target):
                have, _, alns = batches.pop(0)
            wrong += realign_check.window_mismatch(have, want)
            pairs += len(have)
            best = self._banded_best(have, target, band)
            wrong += int(np.count_nonzero(
                best != np.array([a.score for a in alns], np.int64)))
            counts, bad = realign_check.recount(
                [(w, a.score, a.cigar, a.read_begin, a.ref_begin)
                 for w, a in zip(have, alns)], target, pos - lo,
                realign_check.SCORES)
            wrong += bad
            ref_base = int(ref_seq[pos]) if ref_seq[pos] < 4 else -1
            depth = int(counts.sum())
            ref_sup = int(counts[ref_base]) if ref_base >= 0 else 0
            wrong += int(np.abs(np.asarray(got.base_counts, np.int64)
                                - counts).sum())
            wrong += abs(int(got.depth) - depth) \
                + abs(int(got.ref_support) - ref_sup) \
                + abs(int(got.alt_support) - (depth - ref_sup))
            rule = realign_check.kept(counts, ref_base,
                                      self.config["variant"]["af"])
            if rule is not None and pos in alt:
                keep.add((int(pos), alt[pos], rule[0], rule[1]))
        wrong += sum(len(b[0]) for b in batches)   # batches of no call
        return wrong, pairs, keep

    def _banded_best(self, windows, target, band) -> np.ndarray:
        """The reference's banded best scores of a call's windows, kept
        while the windows are."""
        key = ("banded", id(windows), band)
        if key not in self._memo:
            self._memo[key] = (windows, realign_check.banded_best(
                windows, target, self.device, band=band,
                **realign_check.SCORES))
        return self._memo[key][1]

    def _reference_pileup(self, al, reads, sid, seq_len):
        """The reference's pileup of one AlignList's rows on a sequence,
        kept while the answers it judges are kept."""
        key = (id(al), sid, seq_len)
        if key not in self._memo:
            rows = al.data[al.data["sequence_id"] == sid]
            self._memo[key] = (al, variant_check.pileup(
                rows["read_id"], rows["sequence_from"], al.cigar_map, reads,
                sid, seq_len, self.device))
        return self._memo[key][1]

    @staticmethod
    def _gap(merged, probs, sid, pos) -> float:
        """Largest gap between the program's merged probabilities and the
        reference's, 1.0 where one of them lacks a candidate."""
        index = {int(p): i for i, p in enumerate(pos)}
        keys = {k[1] for k in merged if k[0] == sid}
        if keys != set(index):
            return 1.0
        gap = 0.0
        for p, i in index.items():
            got = merged[(sid, p)]
            for task in clairnet.HEADS:
                gap = max(gap, float(np.abs(np.asarray(got[task])
                                            - probs[task][i]).max()))
        return gap

    def _differ(self, calls, probs, ref_seq, pos) -> tuple[int, int]:
        """(calls that differ from the reference's decode in position, alt
        or genotype, those of them within tie_margin of a tie)."""
        ref_calls, margin = variant_check.decode(
            probs, np.asarray(ref_seq)[pos].astype(np.int64))
        want = {int(pos[i]): v for i, v in ref_calls.items()}
        have = {int(c.position): (c.alt, c.genotype) for c in calls}
        index = {int(p): i for i, p in enumerate(pos)}
        differ = ties = 0
        for p in set(want) | set(have):
            if want.get(p) == have.get(p):
                continue
            if p in index and margin[index[p]] < self.traffic["tie_margin"]:
                ties += 1
            else:
                differ += 1
        return differ, ties

    def numbers(self, judged) -> dict:
        ok = [j for j in judged if j is not None]
        if not ok:
            return {"pileup_wrong": 1.0, "score_over": 1.0,
                    "score_short_pct": 100.0, "prob_gap": 1.0,
                    "calls_differ": 1.0, "realign_wrong": 1.0,
                    "vcf_differ": 1.0, "missed_pct": 100.0,
                    "offtarget_kept_pct": 100.0}
        over, short = self._scores(ok)
        return {
            "pileup_wrong": float(sum(j["pileup_wrong"] for j in ok)),
            "score_over": float(over), "score_short_pct": short,
            "prob_gap": max((g for j in ok for g in j["gaps"]),
                            default=1.0),
            "calls_differ": float(sum(j["differ"] for j in ok)),
            "realign_wrong": float(sum(j["realign_wrong"] for j in ok)),
            "vcf_differ": float(sum(j["vcf_differ"] for j in ok)),
            "missed_pct": 100.0 * sum(j["missed"] for j in ok)
            / max(sum(j["planted"] for j in ok), 1),
            "offtarget_kept_pct": 100.0 * sum(j["offtarget_kept"]
                                              for j in ok)
            / max(sum(j["offtarget"] for j in ok), 1)}

    def _scores(self, ok) -> tuple[int, float]:
        """score_over and score_short_pct of check_sample target
        alignments drawn from the seed (the longest read among them)."""
        cand = [(i, r) for i, j in enumerate(ok) if j["target"] is not None
                for r in range(len(j["target"][2].best.data))]
        if not cand:
            return self.traffic["check_sample"], 100.0
        rng = np.random.default_rng(sim.stream_seed(self.ctx.seed,
                                                    SAMPLE_STREAM))
        lens = np.array([len(ok[i]["target"][0][int(
            ok[i]["target"][2].best.data[r]["read_id"])]) for i, r in cand])
        pick = map_check.sample_reads(rng, lens, np.arange(len(cand)),
                                      self.traffic["check_sample"])
        sel_rows, all_reads = [], []
        for c in pick:
            i, r = cand[c]
            reads, _, res = ok[i]["target"]
            row = res.best.data[r].copy()
            all_reads.append(reads[int(row["read_id"])])
            row["read_id"] = len(all_reads) - 1
            sel_rows.append(row)
        sel = np.array(sel_rows, dtype=sel_rows[0].dtype)
        # the faults change reported scores only, never which rows
        key = ("scores",) + tuple(cand[c] for c in pick)
        if key not in self._memo:
            self._memo[key] = map_check.best_scores(
                sel, all_reads, self.target,
                np.array([0, len(self.target)], np.int64),
                self.config["scoring"], self.device)
        best = self._memo[key]
        return map_check.score_numbers(
            sel["alignment_score"].astype(np.int64), best)

    def check(self) -> dict:
        judged = self.judged()
        ok = [j for j in judged if j is not None]
        self._notes = {
            "candidates": [j["candidates"] for j in ok],
            "calls": [j["calls"] for j in ok],
            "realigned_calls": [j["realigned_calls"] for j in ok],
            "realign_pairs": [j["realign_pairs"] for j in ok],
            "near_ties": sum(j["ties"] for j in ok),
            "planted_missed": [j["missed"] for j in ok],
            "planted_called_by_models": [j["by_models"] for j in ok],
            "dropped_by_realign_near_edge": [j["dropped_near_edge"]
                                             for j in ok],
            "dropped_by_realign_inside": [j["dropped_inside"] for j in ok],
            "het_missed": [j["het_missed"] for j in ok]}
        return self.numbers(judged)

    def notes(self, run):
        out = dict(getattr(self, "_notes", {}))
        rows, calls = self.model_rows()
        out.update(model_rows=rows, model_calls=calls,
                   clairnet_bound_by=self.clairnet_least_s()[1])
        return out

    def control_readings(self) -> dict:
        """The numbers of the controls (the reference's ClairNet in TF32,
        the precision below the configuration's float32; the reference's
        realignment at half the band, 128) and of planted faults on this
        window's answers: one pileup count off by one, the program's
        models in TF32, every alignment score raised by one and cut by a
        fifth, half or all of the models' calls dropped (and their VCF
        records), every off-target read kept, every realigned window one
        base short at its start, one realigned read a call counted as a
        deletion, every VCF record's DP one higher."""
        from megapath_nano_tpu_torch.variant import candidates, caller
        from megapath_nano_tpu_torch.variant.pretrained import \
            default_ensemble

        def tf32_reference(rec):
            def ens(nets, x):
                return variant_check.ensemble(
                    [clairnet.Net(t, self.device, "tf32")
                     for t in clairnet.shipped()], x)
            return dict(rec, reference=ens)

        def pileup(rec):
            ps = []
            for al, reads, sid, counts in rec.get("pileups", []):
                c = counts.copy()
                c[5, int(np.argmax(c[5].sum(1))), 0] += 1
                ps.append((al, reads, sid, c))
            return dict(rec, pileups=ps)

        models = default_ensemble(self.device)

        def tf32_program(rec):
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                merged = []
                for al, reads, sid, _ in rec.get("pileups", []):
                    ref_seq = next(r for s_, r, _ in rec["calls"]
                                   if s_ == sid)
                    cands = candidates.extract_candidates(al, reads, sid,
                                                          ref_seq)
                    x = np.stack([candidates.candidate_tensor(c, ref_seq)
                                  for c in cands])
                    per = []
                    for m in models:
                        p = m.predict(x)
                        per.append({(sid, c.position): {k: v[i] for k, v
                                                        in p.items()}
                                    for i, c in enumerate(cands)})
                    merged.append((caller.ensemble_merge(per), 0))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            return dict(rec, merged=merged)

        def scores(change):
            def fault(rec):
                prof = list(rec.get("profiles", []))
                if prof:
                    reads, names, res = prof[-1]
                    best = copy.copy(res.best)
                    best.data = best.data.copy()
                    best.data["alignment_score"] = change(
                        best.data["alignment_score"])
                    res2 = copy.copy(res)
                    res2.best = best
                    prof[-1] = (reads, names, res2)
                return dict(rec, profiles=prof)
            return fault

        def calls_cut(keep):
            def fault(rec):
                cs = [(sid, ref, out[:keep(len(out))])
                      for sid, ref, out in rec.get("calls", [])]
                dropped = {c.position for (_, _, out), (_, _, kept) in
                           zip(rec.get("calls", []), cs)
                           for c in out[len(kept):]}
                rows = _read_vcf(os.path.join(rec["out"], "amplicon.vcf"))
                return dict(rec, calls=cs, vcf=[r for r in rows
                                                if r[0] not in dropped]
                            or [(-1, "N", 0, "")])
            return fault

        def realign_window(rec):
            rs = [dict(rr, batches=[([w[1:] for w in ws], t, alns)
                                    for ws, t, alns in rr["batches"]])
                  for rr in rec.get("realign", [])]
            return dict(rec, realign=rs)

        def realign_count(rec):
            rs = []
            for rr in rec.get("realign", []):
                out = []
                for r in rr["out"]:
                    c = np.array(r.base_counts, np.int64)
                    if c[:4].sum():
                        c[int(np.argmax(c[:4]))] -= 1
                        c[4] += 1
                    out.append(dataclasses.replace(r, base_counts=c))
                rs.append(dict(rr, out=out))
            return dict(rec, realign=rs)

        def vcf_depth(rec):
            rows = _read_vcf(os.path.join(rec["out"], "amplicon.vcf"))
            return dict(rec, vcf=[(p, a, d + 1, f) for p, a, d, f in rows]
                        or [(-1, "N", 0, "")])

        def unscreened(rec):
            _, names, _ = self.samples[rec["k"]]
            prof = list(rec.get("profiles", []))
            if prof:
                reads, _, res = prof[-1]
                prof[-1] = (reads, list(names), res)
            return dict(rec, profiles=prof)

        return {
            "control": self.numbers(self.judged(tf32_reference)),
            "control_realign": self.numbers(self.judged(band=128)),
            "faults": {
                "pileup": self.numbers(self.judged(pileup)),
                "tf32": self.numbers(self.judged(tf32_program)),
                "answer": self.numbers(self.judged(scores(lambda a: a + 1))),
                "short": self.numbers(self.judged(
                    scores(lambda a: (a * 4) // 5))),
                "half": self.numbers(self.judged(calls_cut(
                    lambda n: n // 2))),
                "none": self.numbers(self.judged(calls_cut(lambda n: 0))),
                "unscreened": self.numbers(self.judged(unscreened)),
                "realign_window": self.numbers(self.judged(realign_window)),
                "realign_count": self.numbers(self.judged(realign_count)),
                "vcf_depth": self.numbers(self.judged(vcf_depth))}}

    def cleanup(self):
        shutil.rmtree(self.work, ignore_errors=True)


def _read_vcf(path) -> list[tuple[int, str, int, str]]:
    """(0-based position, alt, DP, AF as written) of a VCF's records."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            c = line.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) for kv in c[7].split(";")
                        if "=" in kv)
            out.append((int(c[1]) - 1, c[4], int(info.get("DP", -1)),
                        info.get("AF", "")))
    return out


def setup(ctx) -> AmpliconCell:
    return AmpliconCell(ctx)
