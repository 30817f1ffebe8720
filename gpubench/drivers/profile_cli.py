"""Driver: samples profiled one after another by the port's CLI.

A request is one sample: one in-process call of
`megapath_nano_tpu_torch.cli.main.main` on a FASTQ that set-up wrote from
the seed, with the CLI's default flags and the traffic's `cli_args`, into a
fresh output folder. The RefDB is built from the configuration's world
once per checkout (cache/<config>/) and read by every sample's load_db, as
a user builds a DB once and profiles sample after sample.

After the window: the trim of every completed sample is judged by
`reference.trim`, its placement and `.preport` by `reference.profile_check`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from core import sim, trace, worlds
from reference import profile_check, trim as ref_trim

READ_STREAM = 2
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the cached RefDB is made by: the harness's world, the program's
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


class ProfileCell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.device = ctx.device
        self.samples = []      # (fastq path, names, worlds.Reads)
        self.outputs = []      # (sample index, output folder, exit code)
        self.work = tempfile.mkdtemp(prefix="gpubench-profile-")
        world = worlds.build(self.config, self.device)
        self.species_of_genome = np.array([t[1] for t in world.tax],
                                          np.int64)
        self.genome_len = world.lengths
        self.db_dir = self._refdb(world)
        self._make_samples(world, ctx.seed)
        del world
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        from megapath_nano_tpu_torch.cli.main import main
        from megapath_nano_tpu_torch.utils.log import Log

        self.cli_main = main
        self.log_cls = Log
        self._step = Log.step
        if ctx.trace:
            self._wrap_steps()
        # warm-up: one small sample through the same entry
        self._run(self.warmup_path, os.path.join(self.work, "warmup"))

    # --- set-up -----------------------------------------------------------

    def _refdb(self, world) -> str:
        """cache/<config>/refdb, rebuilt when the configuration, the
        harness's generators or the program's DB and index code change."""
        stamp = _stamp(self.config)
        base = os.path.join(self.ctx.cache_dir, self.config["name"])
        db_dir = os.path.join(base, "refdb")
        stamp_path = os.path.join(base, "stamp")
        if os.path.exists(stamp_path) and open(stamp_path).read() == stamp \
                and os.path.exists(os.path.join(db_dir, "refdb.npz")):
            return db_dir
        from megapath_nano_tpu_torch.db.refdb import RefDB

        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        genomes = world.genomes_np()
        n = len(genomes)
        db = RefDB.build(genomes, world.names, list(range(n)),
                         [f"asm_{nm}" for nm in world.names], world.tax,
                         world.tax_names, k=self.config["index"]["k"],
                         w=self.config["index"]["w"])
        tmp = os.path.join(base, "refdb.tmp")
        db.save(tmp)
        os.replace(tmp, db_dir)
        with open(stamp_path, "w") as f:
            f.write(stamp)
        return db_dir

    def reseed(self, seed):
        """New samples from another seed, on the same RefDB (the control's
        readings over many seeds in one process)."""
        self.ctx.seed = seed
        world = worlds.build(self.config, self.device)
        self.samples, self.outputs = [], []
        self._make_samples(world, seed)
        del world
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _make_samples(self, world, seed):
        t = self.traffic
        rng, gen = sim.generators(seed, READ_STREAM, self.device)
        adapters = self.config["adapters"]
        n = t.get("reads_per_sample", self.config["reads_per_sample"])
        sizes = [t["warmup_reads"]] + [n] * t["pool"]
        for k, n in enumerate(sizes):
            r = worlds.simulate(world, t, n, rng, gen, adapters=adapters,
                                with_quals=True, part=k)
            names = [f"s{k}r{i}" for i in range(n)]
            path = os.path.join(self.work, f"sample{k}.fastq")
            with open(path, "wb") as f:
                f.write(sim.fastq_bytes(names, r.reads, r.quals))
            if k == 0:
                self.warmup_path = path
            else:
                self.samples.append((path, names, r))

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
        return (["--query", path, "--db", self.db_dir, "--output_folder",
                 out, "--output_prefix", "s", "--device",
                 self.device.type] + list(self.traffic["cli_args"]))

    def _run(self, path, out):
        rc = self.cli_main(self._argv(path, out))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rc

    def request(self) -> dict:
        k = len(self.outputs) % len(self.samples)
        path, names, r = self.samples[k]
        reads = r.reads
        out = tempfile.mkdtemp(prefix="s", dir=self.work)
        with trace.span("sample", self.ctx.trace):
            rc = self._run(path, out)
        self.outputs.append((k, out, rc))
        return {"kind": "sample", "reads": len(reads),
                "bases": int(sum(map(len, reads))), "ok": rc == 0}

    def close_program(self):
        self.log_cls.step = self._step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- after the window ------------------------------------------------------

    def timings(self) -> list[dict]:
        out = []
        for _, folder, rc in self.outputs:
            path = os.path.join(folder, "s.timing")
            if rc != 0 or not os.path.exists(path):
                continue
            t = {}
            with open(path) as f:
                for line in f:
                    name, _, sec = line.strip().partition("\t")
                    if sec:
                        t[name] = t.get(name, 0.0) + float(sec)
            out.append(t)
        return out

    def judged(self):
        """Per completed sample: the trim's wrong flags and names that are
        no input's, each profiled read's best species and true species, the
        true and the reported abundances, the trimmed reads."""
        p = dict(self.config["trim"], **self.config["qc"])
        res = []
        for k, folder, rc in self.outputs:
            path, names, r = self.samples[k]
            if rc != 0:
                res.append(None)
                continue
            out_names, out_seqs = sim.read_fastq_plain(
                os.path.join(folder, "s.trimmed_and_filtered.fastq"))
            wrong, extra = ref_trim.judge(names, r.reads, r.quals, out_names,
                                          out_seqs, p,
                                          self.config["adapters"],
                                          self.device)
            index = {nm: i for i, nm in enumerate(names)}
            src = np.array([index.get(nm, index.get(nm[:-2], -1))
                            for nm in out_names], np.int64)
            species = self.species_of_genome[r.genome]
            truth = np.where(src >= 0, species[np.maximum(src, 0)], -2)
            kept = np.unique(src[src >= 0])
            true_ab = profile_check.true_abundance(
                r.genome[kept], [r.inserts[i] for i in kept],
                self.species_of_genome, self.genome_len)
            bam = os.path.join(folder, "s.bam_filter")
            best = profile_check.best_species(bam, len(out_names)) \
                if os.path.exists(bam) else np.full(len(out_names), -1)
            rep = profile_check.preport(os.path.join(folder, "s.preport"))
            res.append(dict(k=k, wrong=wrong, extra=extra, best=best,
                            truth=truth, true_ab=true_ab, preport=rep,
                            out_names=out_names, out_seqs=out_seqs))
        return res

    def numbers(self, judged) -> dict:
        ok = [j for j in judged if j is not None]
        n_wrong = sum(int(j["wrong"].sum()) + j["extra"] for j in ok)
        n_reads = sum(len(j["best"]) for j in ok)
        n_mis = sum(int(profile_check.misplaced(j["best"], j["truth"]).sum())
                    for j in ok)
        gap = max((profile_check.abundance_gap(j["preport"], j["true_ab"])
                   for j in ok), default=100.0)
        return {"trim_wrong": float(n_wrong),
                "misplaced_pct": 100.0 * n_mis / max(n_reads, 1)
                if ok else 100.0,
                "abundance_gap_pp": gap}

    def check(self) -> dict:
        return self.numbers(self.judged())

    def control_readings(self) -> dict:
        """The numbers of the control (the reference's own trim, put in the
        program's place, without the middle-adapter scan) and of planted
        faults on this window's outputs: half the profiled reads left
        out, a base of every trimmed read altered, the top species'
        abundance doubled in the .preport."""
        p = dict(self.config["trim"], **self.config["qc"])
        ads = self.config["adapters"]
        js = [j for j in self.judged() if j is not None]

        def rejudge(j, names_out, seqs_out):
            _, names, r = self.samples[j["k"]]
            wrong, extra = ref_trim.judge(names, r.reads, r.quals,
                                          names_out, seqs_out, p, ads,
                                          self.device)
            return dict(j, wrong=wrong, extra=extra)

        control, token, half, answer = [], [], [], []
        for j in js:
            _, names, r = self.samples[j["k"]]
            out = ref_trim.trim(names, r.reads, r.quals, p, ads,
                                self.device, check_middle=False)
            control.append(rejudge(j, *out))
            token.append(rejudge(j, j["out_names"],
                                 [np.where(np.arange(len(x)) == 0,
                                           (x + 1) % 4, x).astype(np.int8)
                                  for x in j["out_seqs"]]))
            best = j["best"].copy()
            best[len(best) // 2:] = -1
            half.append(dict(j, best=best))
            rep = dict(j["preport"])
            if rep:
                top = max(rep, key=rep.get)
                rep[top] *= 2.0
            answer.append(dict(j, preport=rep))
        return {"control": self.numbers(control),
                "faults": {"token": self.numbers(token),
                           "half": self.numbers(half),
                           "answer": self.numbers(answer)}}

    def cleanup(self):
        shutil.rmtree(self.work, ignore_errors=True)


def setup(ctx) -> ProfileCell:
    return ProfileCell(ctx)
