"""Reference worlds named by a configuration's `world.kind`.

A world is the set of target genomes a configuration deploys, made on the
device from the configuration's `db_seed`, with each genome's taxonomy and
the genomes that reads are drawn from. Two kinds:

- `relatives`: per listed species a genus ancestor of the species' genome
  size; the species and `relatives_per_species` congeneric relatives are
  copies of it, each at a divergence drawn from `divergence` (chip_smoke's
  `taxon_world`). Reads come from the listed species by `read_share`.
- `strains`: per row [n, m] of `layout`, n species ancestors of
  `genome_bp`, each with m strains, every strain a `mutate` copy of its
  ancestor (substitutions and indels) at a divergence drawn log-uniform
  from `strain_divergence`. Strains of one species are tied by a
  coordinate lift through their ancestor. Reads come from every strain
  alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core import sim

DB_STREAM = 1


@dataclass
class World:
    flat: torch.Tensor          # all genomes end to end, int8 codes
    offsets: np.ndarray         # (n + 1,) int64
    names: list[str]
    tax: list[tuple[int, int, int]]   # (tax, species, genus) per genome
    tax_names: dict[int, str]
    read_sources: np.ndarray    # genome index a read may come from
    read_weights: np.ndarray    # its probability
    group: np.ndarray | None = None   # per genome: its ancestor's index
    lifts: list | None = None   # per genome: its position of every
    lift_step: int = 0          # lift_step-th ancestor base

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def lift(self, pos: np.ndarray, src: np.ndarray,
             dst: np.ndarray) -> np.ndarray:
        """Positions on genomes `src` carried to genomes `dst` through
        their common ancestor (to within the indels of one lift step);
        unchanged where the two are one genome or not of one ancestor."""
        pos = np.asarray(pos, np.int64).copy()
        if self.lifts is None:
            return pos
        src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        move = (src != dst) & (self.group[src] == self.group[dst])
        for a, b in set(zip(src[move].tolist(), dst[move].tolist())):
            sel = move & (src == a) & (dst == b)
            la, lb = self.lifts[a], self.lifts[b]
            i = np.clip(np.searchsorted(la, pos[sel], side="right") - 1,
                        0, len(la) - 1)
            pos[sel] += lb[i] - la[i]
        return pos

    def genomes_np(self) -> list[np.ndarray]:
        host = self.flat.cpu().numpy()
        return [host[self.offsets[i]: self.offsets[i + 1]]
                for i in range(len(self.names))]


def build(config: dict, device) -> World:
    kind = config["world"]["kind"]
    if kind == "relatives":
        return _relatives(config, device)
    if kind == "strains":
        return _strains(config, device)
    raise ValueError(f"unknown world kind {kind!r}")


def _relatives(config: dict, device) -> World:
    w = config["world"]
    rng, gen = sim.generators(config["db_seed"], DB_STREAM, device)
    pieces, names, tax, tax_names = [], [], [], {}
    sources, weights = [], []
    k = int(w["relatives_per_species"])
    lo, hi = w["divergence"]
    for si, sp in enumerate(w["species"]):
        ancestor = sim.random_genome(gen, int(sp["genome_bp"]), device)
        for j in range(k + 1):
            g = sim.mutate(gen, ancestor, float(rng.uniform(lo, hi)))
            if j == 0:
                species_id = int(sp["tax_id"])
                label = sp["name"]
                sources.append(len(names))
                weights.append(float(sp["read_share"]))
            else:
                species_id = int(w["relative_tax_base"]) + 10 * si + j
                label = f"{sp['name'].split()[0]} relative {j}"
            pieces.append(g)
            names.append(label.replace(" ", "_"))
            tax.append((species_id, species_id, int(sp["genus_tax_id"])))
            tax_names[species_id] = label
        del ancestor
    return _world(pieces, names, tax, tax_names, sources, weights)


def _strains(config: dict, device) -> World:
    w = config["world"]
    rng, gen = sim.generators(config["db_seed"], DB_STREAM, device)
    layout = [(int(n), int(m)) for n, m in w["layout"]]
    if sum(n for n, _ in layout) != int(config["species"]):
        raise ValueError("the layout's species do not add up to `species`")
    glen, step = int(w["genome_bp"]), int(w["lift_step"])
    lo, hi = np.log(w["strain_divergence"][0]), \
        np.log(w["strain_divergence"][1])
    pieces, names, tax, tax_names, group, lifts = [], [], [], {}, [], []
    s = 0
    for n_sp, per in layout:
        for _ in range(n_sp):
            ancestor = sim.random_genome(gen, glen, device)
            species_id = int(w["species_tax_base"]) + s
            tax_names[species_id] = f"species {s}"
            for j in range(per):
                g, lift = sim.mutate(gen, ancestor,
                                     float(np.exp(rng.uniform(lo, hi))),
                                     lift_step=step)
                pieces.append(g)
                lifts.append(lift)
                group.append(s)
                names.append(f"sp{s}_strain{j}")
                tax.append((species_id * 100 + j, species_id,
                            int(w["genus_tax_base"]) + s // 8))
            del ancestor
            s += 1
    n = len(pieces)
    world = _world(pieces, names, tax, tax_names, list(range(n)),
                   [1.0 / n] * n)
    world.group = np.asarray(group, np.int64)
    world.lifts, world.lift_step = lifts, step
    return world


def _world(pieces, names, tax, tax_names, sources, weights) -> World:
    lens = np.array([int(p.numel()) for p in pieces], np.int64)
    flat = torch.cat(pieces)
    del pieces[:]
    w = np.asarray(weights, np.float64)
    return World(flat=flat, offsets=np.concatenate([[0], np.cumsum(lens)]),
                 names=names, tax=tax, tax_names=tax_names,
                 read_sources=np.asarray(sources, np.int64),
                 read_weights=w / w.sum())


@dataclass
class Reads:
    reads: list[np.ndarray]
    quals: list[np.ndarray] | None
    genome: np.ndarray      # (n,) genome index of the insert
    start: np.ndarray       # insert start in the genome (first insert)
    end: np.ndarray
    strand: np.ndarray
    inserts: list           # per read: [(start, end)] of each insert

    @property
    def bases(self) -> int:
        return int(sum(len(r) for r in self.reads))


def shapes(traffic: dict, n: int, part: int, with_adapters: bool) -> dict:
    """The sizes of one batch of n reads, the same for every seed: read
    lengths and error-rate scales, and which reads carry which adapter,
    drawn from the traffic's `shape_seed` (a seed only reorders them)."""
    p = sim.Profile.from_dict(traffic["profile"])
    rng = np.random.default_rng(sim.stream_seed(traffic["shape_seed"], part))
    out = {"length": sim.draw_lengths(rng, p, n, p.max_length),
           "scale": rng.gamma(p.read_rate_shape, 1.0 / p.read_rate_shape, n)}
    plant = traffic.get("adapters")
    if with_adapters and plant:
        for key in ("start", "end", "middle"):
            flag = np.zeros(n, bool)
            flag[:int(round(plant[key + "_rate"] * n))] = True
            out[key] = rng.permutation(flag)
        out["mid_kind"] = rng.integers(0, 2, n)
    return out


def simulate(world: World, traffic: dict, n: int, rng: np.random.Generator,
             gen: torch.Generator, adapters: list[dict] | None = None,
             with_quals: bool = False, part: int = 0) -> Reads:
    """n reads of the traffic's `profile` from the world's read sources,
    with the sizes of `shapes(traffic, n, part)` in an order drawn from
    rng. With `adapters` (the configuration's sequences; the traffic's
    `adapters` names one and its rates) the template is start adapter +
    insert (+ middle adapter + a second insert of the same genome) + end
    adapter, laid down before the errors, as a molecule is sequenced."""
    p = sim.Profile.from_dict(traffic["profile"])
    dev = world.flat.device
    shp = shapes(traffic, n, part, adapters is not None)
    order = rng.permutation(n)
    g = rng.choice(world.read_sources, size=n, p=world.read_weights)
    glen = world.lengths[g]
    length = np.minimum(shp["length"][order], glen)
    scale = shp["scale"][order]
    start = (rng.random(n) * (glen - length + 1)).astype(np.int64)
    strand = rng.integers(0, 2, n)
    seg_start, seg_len, seg_rc = [], [], []
    plant = traffic.get("adapters") if adapters else None
    ad = None
    if plant:
        ad = next(a for a in adapters if a["name"] == plant["adapter"])
        ad_start = sim.encode(ad["start"])
        ad_end = sim.encode(ad["end"])
        has_start = shp["start"][order]
        has_end = shp["end"][order]
        has_mid = shp["middle"][order]
        mid_kind = shp["mid_kind"][order]     # start adapter or its rc
    # segments index one source: genomes, then the adapter sequences
    extra = []
    if ad is not None:
        extra = [ad_start, sim.revcomp_np(ad_start), ad_end]
    base_off = int(world.offsets[-1])
    extra_off = np.cumsum([0] + [len(e) for e in extra])
    src = world.flat
    if extra:
        src = torch.cat([world.flat] + [torch.as_tensor(e, device=dev)
                                        for e in extra])

    def add(s, l, rc):
        seg_start.append(s)
        seg_len.append(l)
        seg_rc.append(rc)

    tl = np.zeros(n, np.int64)
    inserts = []
    for i in range(n):
        gs = int(world.offsets[g[i]])
        segs0 = len(seg_len)
        if ad is not None and has_start[i]:
            add(base_off + extra_off[0], len(ad_start), 0)
        if ad is not None and has_mid[i] and length[i] >= 2 * 400:
            half = int(length[i]) // 2
            add(gs + int(start[i]), half, int(strand[i]))
            k = int(mid_kind[i])
            add(base_off + extra_off[k], len(extra[k]), 0)
            rest = int(length[i]) - half
            s2 = int(rng.integers(0, int(glen[i]) - rest + 1))
            add(gs + s2, rest, int(strand[i]))
            inserts.append([(int(start[i]), int(start[i]) + half),
                            (s2, s2 + rest)])
        else:
            add(gs + int(start[i]), int(length[i]), int(strand[i]))
            inserts.append([(int(start[i]), int(start[i] + length[i]))])
        if ad is not None and has_end[i]:
            add(base_off + extra_off[2], len(ad_end), 0)
        tl[i] = sum(seg_len[segs0:])
    tmpl = sim.gather_segments(src, np.asarray(seg_start, np.int64),
                               np.asarray(seg_len, np.int64),
                               np.asarray(seg_rc, np.int64))
    flat, lens = sim.apply_errors(rng, gen, tmpl, tl, p, scale)
    reads = sim.split_reads(flat, lens)
    quals = sim.qualities(gen, lens, scale, p, dev) if with_quals else None
    return Reads(reads=reads, quals=quals, genome=g, start=start,
                 end=start + length, strand=strand, inserts=inserts)
