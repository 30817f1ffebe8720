"""Seeded amplicon samples: whole-amplicon ONT reads with planted SNVs.

A configuration with `amplicons` names loci on its first species' genome
(the target) by their centre in kb; `amplicon_bp` bounds their lengths.
A sample is made from three draws:

- its sizes, the same for every seed: each amplicon's length, uniform in
  `amplicon_bp` (the configuration's `amplicon_shape_seed`); from the
  traffic's `shape_seed` and the pool index, each amplicon's yield,
  lognormal across loci with sigma `yield_sigma`, as on-target read counts
  that add up to `on_target_share` of the sample; each read's error-rate
  scale (the R9.4.1 profile's Gamma draw);
- its SNVs, from the seed: `snvs.hom` homozygous and `snvs.het` at an
  allele fraction drawn from `snvs.het_af`, at distinct positions drawn
  uniformly over the amplicons' bases (no region avoided), each alt base
  another than the target's. A SNV at fraction f is carried by round(f n)
  of its amplicon's n reads, drawn from the seed;
- its reads, from the seed: on-target reads are whole amplicons of the
  target on either strand; the rest are the same loci of the other
  genomes of the target's genus (the configuration's relatives of it),
  round robin over them and over the loci. Templates are gathered with
  `sim.gather_segments`, the SNVs written into them, then
  `sim.apply_errors` adds the profile's errors and junk ends and
  `sim.qualities` the phreds. The order of the reads is drawn from the
  seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core import sim


@dataclass
class Panel:
    loci: list[str]
    start: np.ndarray        # (n,) int64, on the target
    length: np.ndarray       # (n,) int64


@dataclass
class Sample:
    reads: list[np.ndarray]
    quals: list[np.ndarray]
    genome: np.ndarray       # (n,) the world genome each read came from
    snv_pos: np.ndarray      # (k,) 0-based on the target
    snv_alt: np.ndarray      # (k,) base codes
    snv_af: np.ndarray       # (k,) 1.0 for homozygous
    snv_edge: np.ndarray     # (k,) bases to the nearer end of its amplicon

    @property
    def bases(self) -> int:
        return int(sum(len(r) for r in self.reads))


def panel(config: dict, target_len: int) -> Panel:
    """The amplicons: lengths from `amplicon_shape_seed`, each centred on
    its locus and kept inside the target."""
    rng = np.random.default_rng(sim.stream_seed(
        config["amplicon_shape_seed"], 0))
    lo, hi = config["amplicon_bp"]
    loci = [a["locus"] for a in config["amplicons"]]
    length = rng.integers(lo, hi + 1, len(loci)).astype(np.int64)
    centre = np.array([round(1000 * a["centre_kb"])
                       for a in config["amplicons"]], np.int64)
    start = np.clip(centre - length // 2, 0, target_len - length)
    return Panel(loci=loci, start=start, length=length)


def shapes(traffic: dict, n_amplicons: int, n: int, part: int) -> dict:
    """Per-amplicon on-target read counts and per-read error scales of a
    sample of n reads, the same for every seed."""
    p = sim.Profile.from_dict(traffic["profile"])
    rng = np.random.default_rng(sim.stream_seed(traffic["shape_seed"],
                                                1000 + part))
    w = rng.lognormal(0.0, traffic["yield_sigma"], n_amplicons)
    n_on = int(round(traffic["on_target_share"] * n))
    exact = n_on * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = n_on - int(counts.sum())
    counts[np.argsort(counts - exact, kind="stable")[:rest]] += 1
    return {"on_target": counts, "off_target": n - n_on,
            "scale": rng.gamma(p.read_rate_shape, 1.0 / p.read_rate_shape,
                               n)}


def plant(rng: np.random.Generator, target: np.ndarray, pan: Panel,
          traffic: dict) -> tuple[np.ndarray, ...]:
    """(positions, alt codes, allele fractions, amplicons) of the sample's
    SNVs."""
    spec = traffic["snvs"]
    k = int(spec["hom"]) + int(spec["het"])
    total = int(pan.length.sum())
    flat = np.sort(rng.choice(total, size=k, replace=False))
    first = np.cumsum(pan.length) - pan.length
    amp = np.searchsorted(first, flat, side="right") - 1
    pos = pan.start[amp] + flat - first[amp]
    order = rng.permutation(k)
    af = np.ones(k)
    het = order[:int(spec["het"])]
    lo, hi = spec["het_af"]
    af[het] = rng.uniform(lo, hi, len(het))
    ref = target[pos].astype(np.int64)
    alt = (np.minimum(ref, 3) + rng.integers(1, 4, k)) % 4
    return pos.astype(np.int64), alt.astype(np.int8), af, amp


def simulate(world, pan: Panel, traffic: dict, n: int,
             rng: np.random.Generator, gen: torch.Generator,
             part: int) -> Sample:
    """One sample of n reads (module docstring). The world's first genome
    is the target; the other genomes of its genus give the off-target
    reads."""
    p = sim.Profile.from_dict(traffic["profile"])
    dev = world.flat.device
    shp = shapes(traffic, len(pan.loci), n, part)
    off = world.offsets
    target = world.flat[off[0]: off[1]].cpu().numpy()
    snv_pos, snv_alt, snv_af, snv_amp = plant(rng, target, pan, traffic)
    on = shp["on_target"]
    amp = np.concatenate([np.repeat(np.arange(len(on)), on),
                          np.arange(shp["off_target"]) % len(on)])
    genus = np.array([t[2] for t in world.tax])
    other = np.flatnonzero(genus == genus[0])[1:]
    genome = np.concatenate([np.zeros(int(on.sum()), np.int64),
                             other[(np.arange(shp["off_target"]) // len(on))
                                   % len(other)]])
    strand = rng.integers(0, 2, n)
    glen = world.lengths[genome]
    length = pan.length[amp]
    start = np.minimum(pan.start[amp], glen - length)
    seg_start = off[genome] + start
    tmpl = sim.gather_segments(world.flat, seg_start, length, strand)
    lens = length.copy()
    # SNVs: on-target reads of the SNV's amplicon, a share af of them
    first = np.cumsum(lens) - lens
    at, base = [], []
    for pos, alt, af, a in zip(snv_pos, snv_alt, snv_af, snv_amp):
        mine = np.flatnonzero((amp == a) & (genome == 0))
        carriers = mine if af >= 1.0 else rng.choice(
            mine, size=int(round(af * len(mine))), replace=False)
        k = pos - pan.start[a]
        rc = strand[carriers] == 1
        at.append(first[carriers] + np.where(rc, lens[carriers] - 1 - k, k))
        base.append(np.where(rc, 3 - alt, alt))
    if at:
        idx = torch.as_tensor(np.concatenate(at), device=dev)
        tmpl[idx] = torch.as_tensor(np.concatenate(base).astype(np.int8),
                                    device=dev)
    order = rng.permutation(n)
    flat, out_lens = sim.apply_errors(rng, gen, tmpl, lens, p, shp["scale"])
    reads = sim.split_reads(flat, out_lens)
    quals = sim.qualities(gen, out_lens, shp["scale"], p, dev)
    off = snv_pos - pan.start[snv_amp]
    return Sample(reads=[reads[i] for i in order],
                  quals=[quals[i] for i in order], genome=genome[order],
                  snv_pos=snv_pos, snv_alt=snv_alt, snv_af=snv_af,
                  snv_edge=np.minimum(off, pan.length[snv_amp] - 1 - off))
