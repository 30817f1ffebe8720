"""Seeded generators of the benchmark's worlds: genomes, ONT reads, adapters.

Frozen copies of the port's generators, so that a later change to the port
cannot move the yardstick:

- `mutate` is `chip_smoke.py`'s `mutate_fast` (sub:ins:del = 2:1:1), with
  a coordinate lift from source to copy; `worlds.relatives` is its
  `taxon_world` (species copied from a genus ancestor at a divergence
  drawn per species);
- `simulate` is the R9.4.1 `ErrorProfile` of
  `megapath_nano_tpu_torch/sim/simulator.py` (per-read Gamma rate scale,
  homopolymer-boosted deletions, geometric indel runs, random junk ends,
  lognormal lengths), vectorised over a whole batch: per-read draws on the
  host with numpy, per-base draws on the device with a `torch.Generator`.

Codes: A=0 C=1 G=2 T=3, N=4. Every function takes its randomness from an
explicit generator, so the same seed gives the same world.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one named stream of `seed` (any non-negative int)."""
    ss = np.random.SeedSequence([int(seed)] + [int(t) for t in tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generators(seed: int, tag: int, device) -> tuple:
    """(numpy Generator, torch.Generator on `device`) for stream `tag`."""
    s = stream_seed(seed, tag)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return np.random.default_rng(s), gen


def encode(text: str) -> np.ndarray:
    return _CODE[np.frombuffer(text.encode(), np.uint8)].copy()


def revcomp_np(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes).astype(np.int8)[::-1].copy()


def random_genome(gen: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.randint(0, 4, (n,), generator=gen, device=device,
                         dtype=torch.int8)


def mutate(gen: torch.Generator, src: torch.Tensor, err: float,
           lift_step: int = 0):
    """ONT-style edits at rate err, sub:ins:del = 2:1:1 (mutate_fast).

    With lift_step > 0, returns (copy, lift): lift[i] is the copy's
    position of source base i * lift_step (of the next kept base where that
    one was deleted), int64 on the host."""
    d, i = err / 4, err / 4
    r = torch.rand(src.shape, generator=gen, device=src.device)
    is_del = r < d
    is_ins = (r >= d) & (r < d + i)
    is_sub = (r >= d + i) & (r < d + i + err / 2)
    shift = torch.randint(1, 4, src.shape, generator=gen, device=src.device,
                          dtype=torch.int8)
    base = torch.where(is_sub, (src + shift) % 4, src)
    reps = torch.where(is_del, 0, torch.where(is_ins, 2, 1))
    out = torch.repeat_interleave(base, reps)
    first = torch.cumsum(reps, 0) - reps
    ins_at = first[is_ins]
    out[ins_at] = torch.randint(0, 4, (int(ins_at.numel()),), generator=gen,
                                device=src.device, dtype=torch.int8)
    if lift_step > 0:
        return out, first[::lift_step].cpu().numpy().astype(np.int64)
    return out


@dataclass
class Profile:
    """The R9.4.1 preset of the port's ErrorProfile (its defaults)."""

    sub_rate: float = 0.03
    ins_rate: float = 0.02
    del_rate: float = 0.03
    homopolymer_del_boost: float = 2.0
    length_log_mean: float = 8.5
    length_log_sigma: float = 0.6
    min_length: int = 200
    max_length: int = 20000
    ins_run_mean: float = 1.3
    del_run_mean: float = 1.5
    read_rate_shape: float = 8.0
    junk_head_max: int = 40
    junk_tail_max: int = 40

    @staticmethod
    def from_dict(d: dict) -> "Profile":
        return Profile(**d)


def draw_lengths(rng: np.random.Generator, p: Profile, n: int,
                 cap: np.ndarray | int) -> np.ndarray:
    ln = rng.lognormal(p.length_log_mean, p.length_log_sigma, n)
    ln = np.clip(ln, p.min_length, p.max_length).astype(np.int64)
    return np.minimum(ln, cap)


def apply_errors(rng: np.random.Generator, gen: torch.Generator,
                 tmpl: torch.Tensor, lens: np.ndarray, p: Profile,
                 scale: np.ndarray):
    """The simulator's `_apply_errors` over a batch of templates laid end to
    end (tmpl, with per-read lengths `lens` and error-rate scales `scale`,
    the simulator's per-read Gamma draw), then random junk at both ends.
    Returns (bases, per-read lengths)."""
    dev = tmpl.device
    n = len(lens)
    total = int(lens.sum())
    rid = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.as_tensor(lens, device=dev))
    starts = torch.as_tensor(np.cumsum(lens) - lens, device=dev)
    pos = torch.arange(total, device=dev)
    sc = torch.as_tensor(scale, dtype=torch.float32, device=dev)[rid]
    homo = torch.zeros(total, dtype=torch.bool, device=dev)
    if total > 1:
        homo[1:] = (tmpl[1:] == tmpl[:-1]) & (pos[1:] != starts[rid[1:]])
    del_rate = torch.clamp(
        p.del_rate * sc * torch.where(homo, p.homopolymer_del_boost, 1.0),
        max=0.9)

    def u():
        return torch.rand(total, generator=gen, device=dev)

    del_start = u() < del_rate / max(p.del_run_mean, 1.0)
    ins_start = u() < torch.clamp(p.ins_rate * sc, max=0.9) \
        / max(p.ins_run_mean, 1.0)
    substituted = u() < torch.clamp(p.sub_rate * sc, max=0.9)

    def geometric(mean):
        q = 1.0 - 1.0 / max(mean, 1.0)
        if q <= 0.0:
            return torch.ones(total, dtype=torch.int64, device=dev)
        return (torch.floor(torch.log(u().clamp_min(1e-12)) / np.log(q))
                .to(torch.int64) + 1)

    del_runs = geometric(p.del_run_mean)
    ins_runs = torch.where(ins_start, geometric(p.ins_run_mean), 0)
    # a deletion run started at j covers j .. j + run - 1; a later start
    # replaces the running one (the simulator's skip_until)
    last = torch.where(del_start, pos, -1)
    last = torch.cummax(last, 0).values
    covered = torch.where(last >= 0, last + del_runs[last.clamp_min(0)], -1)
    deleted = (pos < covered) & (last >= starts[rid])
    shift = torch.randint(1, 4, (total,), generator=gen, device=dev,
                          dtype=torch.int8)
    base = torch.where(substituted & (tmpl < 4), (tmpl + shift) % 4, tmpl)
    keep = (~deleted).to(torch.int64)
    per = ins_runs + keep
    # junk: head before the read's first base, tail after its last
    head = rng.integers(0, p.junk_head_max + 1, n)
    tail = rng.integers(0, p.junk_tail_max + 1, n)
    body = torch.zeros(n, dtype=torch.int64, device=dev)
    body.index_add_(0, rid, per)
    body_np = body.cpu().numpy()
    out_lens = head + body_np + tail
    out_starts = np.cumsum(out_lens) - out_lens
    out = torch.randint(0, 4, (int(out_lens.sum()),), generator=gen,
                        device=dev, dtype=torch.int8)
    # position of base j: its read's start + head + the emitted count before
    # it inside the read + its own insertions
    csum = torch.cumsum(per, 0) - per
    first_of_read = csum[starts]
    dest = (torch.as_tensor(out_starts + head, device=dev)[rid]
            + (csum - first_of_read[rid]) + ins_runs)
    out[dest[keep.bool()]] = base[keep.bool()]
    return out, out_lens


def gather_segments(src: torch.Tensor, seg_start: np.ndarray,
                    seg_len: np.ndarray, seg_rc: np.ndarray) -> torch.Tensor:
    """Concatenate src[s:s+l] for each segment, reverse-complemented where
    seg_rc is set."""
    dev = src.device
    lens = torch.as_tensor(seg_len, device=dev)
    sid = torch.repeat_interleave(torch.arange(len(seg_len), device=dev),
                                  lens)
    off = torch.as_tensor(np.cumsum(seg_len) - seg_len, device=dev)
    k = torch.arange(int(seg_len.sum()), device=dev) - off[sid]
    rc = torch.as_tensor(seg_rc.astype(bool), device=dev)[sid]
    idx = torch.where(rc, lens[sid] - 1 - k, k) + \
        torch.as_tensor(seg_start, device=dev)[sid]
    v = src[idx]
    return torch.where(rc & (v < 4), 3 - v, v)


def split_reads(flat: torch.Tensor, lens: np.ndarray) -> list[np.ndarray]:
    host = flat.cpu().numpy()
    return np.split(host, np.cumsum(lens)[:-1]) if len(lens) else []


def qualities(gen: torch.Generator, lens: np.ndarray, scale: np.ndarray,
              p: Profile, device) -> list[np.ndarray]:
    """Per-base phred drawn around the read's realised error rate (the
    simulator's with_quals rule)."""
    err = np.clip((p.sub_rate + p.ins_rate + p.del_rate) * scale, 1e-4, 0.5)
    q = torch.as_tensor(-10.0 * np.log10(err), dtype=torch.float32,
                        device=device)
    rid = torch.repeat_interleave(torch.arange(len(lens), device=device),
                                  torch.as_tensor(lens, device=device))
    noise = torch.randn(int(lens.sum()), generator=gen, device=device)
    flat = torch.clamp(q[rid] + 2.0 * noise, 2, 45).to(torch.int8)
    return split_reads(flat, lens)


def fastq_bytes(names: list[str], reads: list[np.ndarray],
                quals: list[np.ndarray]) -> bytes:
    parts = []
    for name, r, q in zip(names, reads, quals):
        parts.append(b"@" + name.encode() + b"\n")
        parts.append(_ASCII[r].tobytes())
        parts.append(b"\n+\n")
        parts.append((q.astype(np.uint8) + 33).tobytes())
        parts.append(b"\n")
    return b"".join(parts)


def read_fastq_plain(path: str) -> tuple[list[str], list[np.ndarray]]:
    """Names and codes of a FASTQ (4-line records)."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    names, seqs = [], []
    for i in range(0, len(lines) - 3, 4):
        names.append(lines[i][1:].split()[0].decode())
        seqs.append(_CODE[np.frombuffer(lines[i + 1], np.uint8)].copy())
    return names, seqs
