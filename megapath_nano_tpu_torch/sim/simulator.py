"""ONT read simulator — the NanoSim-equivalent used by noise projection.

The reference vendors NanoSim (reference: bin/tools/nanosim/simulator.py,
~712 LoC, with trained error profiles in nanosim_profiles/ produced by its
read_analysis stage) and invokes it from step_noise_projection
(megapath_nano.py:2685-2697) to simulate 10k reads from high-abundance
assemblies. This module reproduces both halves of that capability:

  - simulate_reads: parametric ONT error model — per-read error-rate
    variability (gamma mixture), geometric insertion/deletion RUN lengths,
    homopolymer-biased deletions, lognormal read lengths, unaligned
    head/tail junk, and error-correlated per-base quality emission;
    linear/circular genome modes mirror NanoSim's
    (simulator.py:42-43,649).
  - fit_profile: the read_analysis equivalent — estimates the profile's
    rates and length distribution from real reads aligned to a reference
    (CIGAR walk), so simulation can be driven by measured data instead of
    defaults. Profiles round-trip to JSON like NanoSim's profile files.

The port's own copy of megapath_nano_tpu/sim/simulator.py.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np

from megapath_nano_tpu_torch.utils.dna import revcomp


@dataclass
class ErrorProfile:
    """Parametric ONT error profile (R9.4.1-flavored defaults)."""

    sub_rate: float = 0.03
    ins_rate: float = 0.02
    del_rate: float = 0.03
    homopolymer_del_boost: float = 2.0     # extra deletion odds in homopolymers
    length_log_mean: float = 8.5           # lognormal read length (~5 kb)
    length_log_sigma: float = 0.6
    min_length: int = 200
    # error-run geometry: mean run lengths for ins/del events (NanoSim
    # models error lengths with trained KDEs; geometric runs capture the
    # heavy-tailed behavior parametrically)
    ins_run_mean: float = 1.3
    del_run_mean: float = 1.5
    # per-read error-rate variability: rates scale by Gamma(shape, 1/shape)
    # (ONT per-read accuracy varies widely around the flowcell mean)
    read_rate_shape: float = 8.0
    # unaligned junk appended at read ends (adapter remnants / open pores)
    junk_head_max: int = 40
    junk_tail_max: int = 40

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=1)

    @staticmethod
    def load(path: str) -> "ErrorProfile":
        with open(path) as f:
            return ErrorProfile(**json.load(f))


# flowcell presets
R941 = ErrorProfile()
R104 = ErrorProfile(sub_rate=0.012, ins_rate=0.008, del_rate=0.012,
                    homopolymer_del_boost=1.6)


def simulate_reads(
    genome: np.ndarray,
    n_reads: int,
    profile: ErrorProfile | None = None,
    *,
    seed: int = 0,
    circular: bool = False,
    max_length: int | None = None,
    with_quals: bool = False,
):
    """Returns (reads, truth) with truth entries (start, end, strand);
    with_quals=True returns (reads, truth, quals) with per-base phred
    scores drawn from the read's realized error rate."""
    p = profile or ErrorProfile()
    rng = np.random.default_rng(seed)
    g_len = len(genome)
    reads, truth, quals = [], [], []
    for _ in range(n_reads):
        length = int(np.clip(rng.lognormal(p.length_log_mean,
                                           p.length_log_sigma),
                             p.min_length, max_length or g_len))
        length = min(length, g_len)
        if circular:
            start = int(rng.integers(0, g_len))
            idx = (start + np.arange(length)) % g_len
            frag = genome[idx]
            end = start + length
        else:
            start = int(rng.integers(0, max(g_len - length, 1)))
            frag = genome[start: start + length]
            end = start + length
        scale = float(rng.gamma(p.read_rate_shape, 1.0 / p.read_rate_shape))
        read = _apply_errors(rng, frag, p, scale)
        # unaligned junk at the ends (head/tail adapters, open-pore noise)
        head = rng.integers(0, 4, int(rng.integers(0, p.junk_head_max + 1))
                            ).astype(np.int8)
        tail = rng.integers(0, 4, int(rng.integers(0, p.junk_tail_max + 1))
                            ).astype(np.int8)
        read = np.concatenate([head, read, tail])
        strand = int(rng.integers(0, 2))
        if strand:
            read = revcomp(read)
        reads.append(read)
        truth.append((start, end, strand))
        if with_quals:
            err = min(max((p.sub_rate + p.ins_rate + p.del_rate) * scale,
                          1e-4), 0.5)
            q = -10.0 * np.log10(err)
            quals.append(np.clip(rng.normal(q, 2.0, len(read)), 2, 45)
                         .astype(np.int8))
    if with_quals:
        return reads, truth, quals
    return reads, truth


def _apply_errors(rng: np.random.Generator, frag: np.ndarray,
                  p: ErrorProfile, scale: float = 1.0) -> np.ndarray:
    n = len(frag)
    homo = np.zeros(n, bool)
    homo[1:] = frag[1:] == frag[:-1]
    del_rate = np.where(homo,
                        min(p.del_rate * scale * p.homopolymer_del_boost,
                            0.9), min(p.del_rate * scale, 0.9))
    # events start runs; geometric run lengths
    del_start = rng.random(n) < del_rate / max(p.del_run_mean, 1.0)
    ins_start = rng.random(n) < min(p.ins_rate * scale, 0.9) \
        / max(p.ins_run_mean, 1.0)
    substituted = rng.random(n) < min(p.sub_rate * scale, 0.9)
    del_runs = rng.geometric(1.0 / max(p.del_run_mean, 1.0), n)
    ins_runs = rng.geometric(1.0 / max(p.ins_run_mean, 1.0), n)
    subs = rng.integers(1, 4, n)
    ins_bases = rng.integers(0, 4, 2 * n + 8)

    out = []
    ib = 0
    skip_until = -1
    for i in range(n):
        if ins_start[i]:
            for _ in range(int(ins_runs[i])):
                out.append(int(ins_bases[ib % len(ins_bases)]))
                ib += 1
        if del_start[i]:
            skip_until = i + int(del_runs[i])
        if i < skip_until:
            continue
        if substituted[i] and frag[i] < 4:
            out.append((int(frag[i]) + int(subs[i])) % 4)
        else:
            out.append(int(frag[i]))
    return np.asarray(out, dtype=np.int8)


def fit_profile(align_list, reads: list[np.ndarray],
                ref_of_seq: dict[int, np.ndarray]) -> ErrorProfile:
    """Estimate an ErrorProfile from real reads aligned to a reference —
    the NanoSim read_analysis equivalent (its trained profile files play
    this role). Requires CIGARs (align_list.cigar_map)."""
    assert align_list.cigar_map is not None, "fit_profile needs CIGARs"
    n_match = n_sub = n_ins = n_del = 0
    lengths = []
    for row in align_list.data:
        rid, sid = int(row["read_id"]), int(row["sequence_id"])
        entry = align_list.cigar_map.get(
            (rid, sid, int(row["sequence_from"])),
            align_list.cigar_map.get((rid, sid)))
        if entry is None or sid not in ref_of_seq:
            continue
        cigar, oriented_from, strand = entry
        read = reads[rid]
        oriented = revcomp(read) if strand else read
        ref = ref_of_seq[sid]
        qi, ti = oriented_from, int(row["sequence_from"])
        for length, op in cigar:
            if op == "M":
                a = oriented[qi: qi + length]
                b = ref[ti: ti + length]
                m = int(np.sum(a == b))
                n_match += m
                n_sub += length - m
                qi += length
                ti += length
            elif op == "I":
                n_ins += length
                qi += length
            elif op == "D":
                n_del += length
                ti += length
        lengths.append(len(read))
    aligned = max(n_match + n_sub + n_del, 1)
    logs = np.log(np.maximum(np.asarray(lengths, np.float64), 1.0)) \
        if lengths else np.array([8.5])
    return ErrorProfile(
        sub_rate=n_sub / aligned,
        ins_rate=n_ins / aligned,
        del_rate=n_del / aligned,
        length_log_mean=float(np.mean(logs)),
        length_log_sigma=float(max(np.std(logs), 0.05)),
    )
