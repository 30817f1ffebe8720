"""Plain PyTorch reference of the amplicon pipeline's variant stages.

From one map's answer (alignment rows and their CIGARs) and the reads, as
the port's `variant/` docstrings describe them:

- `pileup`: (6, L, 2) counts, rows A/C/G/T/deletion/depth, columns forward
  and reverse strand. Each alignment's CIGAR (the one stored for its read
  and sequence) is laid from its row's reference start on its oriented
  read (reverse-complemented on the reverse strand, N staying N): an M base
  counts in its base's row if it is A/C/G/T, and in the depth row; a D
  base in the deletion row and the depth row; I moves along the read, any
  other op moves nothing. Positions outside [0, L) are not counted.
- `candidates`: positions of depth >= 4 whose non-reference support
  (bases other than the reference's, and deletions) is >= 2 reads and
  >= 0.125 of the depth, on an A/C/G/T reference base. The floor of 2
  supporting reads is the port's `extract_candidates` default.
- `tensors`: each candidate's (33, 8, 4) tensor: rows A/C/G/T, deletion,
  reference, depth and non-reference fraction; channels both strands,
  forward, reverse, and a mask of the centre. Counts are capped at 100 and
  scaled by it; the reference row holds (code + 1) / 4 in every channel;
  the non-reference fraction (1 - reference support over depth) is in
  channel 0 only; the centre's channel 3 is 1 in every row; positions off
  the sequence are 0 (their reference row too).
- `ensemble`: each model's softmax (`reference.clairnet`), then the mean
  over the models where a majority voted: every model scores every
  candidate, so the mean over all of them.
- `decode`: no call where zygosity's largest class is hom-ref (0);
  otherwise genotype 0/1 (class 1) or 1/1 (class 2) and the alt from
  gt21's largest class: the base of a two-base pair that is not the
  reference's (the pair's first base if both are), or `<label>` for the
  indel classes. The deciding margin is the smaller of the two heads' gaps
  between their two largest classes.

Departures: everything runs as tensor code (index_add_ for the counts,
gathers for the tensors) where the port loops; the tensors' non-reference
fraction is computed in float32 throughout (the port's may pass through
float64 at the sequence's ends), which the probabilities' tolerance
covers. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import clairnet

FLANKING = 16
POSITIONS = 2 * FLANKING + 1
DEPTH_CAP = 100
GT21_LABELS = [
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "InsIns", "InsDel",
    "ADel", "CDel", "GDel", "TDel",
    "AIns", "CIns", "GIns", "TIns",
]


def _oriented(read: np.ndarray, strand: int) -> np.ndarray:
    if not strand:
        return read
    return np.where(read < 4, 3 - read, read).astype(np.int8)[::-1]


def pileup(read_ids, seq_from, cigar_map: dict, reads: list, sequence_id: int,
           seq_len: int, device) -> torch.Tensor:
    """(6, seq_len, 2) int32 counts (module docstring) of the alignment
    rows (read_ids, seq_from) on one sequence."""
    m_runs, d_runs, oriented, strands = [], [], [], []
    for rid, t in zip(np.asarray(read_ids).tolist(),
                      np.asarray(seq_from).tolist()):
        entry = cigar_map.get((rid, sequence_id))
        if entry is None:
            continue
        cigar, q, strand = entry
        a = len(oriented)
        oriented.append(_oriented(reads[rid], int(strand)))
        strands.append(int(strand))
        for n, op in cigar:
            if op == "M":
                m_runs.append((a, q, t, n))
                q += n
                t += n
            elif op == "I":
                q += n
            elif op == "D":
                d_runs.append((a, q, t, n))
                t += n
    counts = torch.zeros(6 * seq_len * 2, dtype=torch.int32, device=device)
    if not oriented:
        return counts.view(6, seq_len, 2)
    lens = torch.as_tensor([len(o) for o in oriented], device=device)
    base_of = torch.cumsum(lens, 0) - lens
    flat = torch.as_tensor(np.concatenate(oriented), device=device)
    strand_of = torch.as_tensor(strands, device=device)

    def expand(runs):
        r = torch.as_tensor(runs, dtype=torch.int64, device=device)
        n = r[:, 3]
        which = torch.repeat_interleave(torch.arange(len(r), device=device),
                                        n)
        k = torch.arange(int(n.sum()), device=device) \
            - (torch.cumsum(n, 0) - n)[which]
        aln = r[which, 0]
        return aln, r[which, 1] + k, r[which, 2] + k

    def bump(row, pos, strand):
        idx = (row * seq_len + pos) * 2 + strand
        counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))

    if m_runs:
        aln, q, t = expand(m_runs)
        inside = (t >= 0) & (t < seq_len)
        aln, q, t = aln[inside], q[inside], t[inside]
        base = flat[base_of[aln] + q].to(torch.int64)
        s = strand_of[aln]
        acgt = base < 4
        bump(base[acgt], t[acgt], s[acgt])
        bump(torch.full_like(t, 5), t, s)
    if d_runs:
        aln, _, t = expand(d_runs)
        inside = (t >= 0) & (t < seq_len)
        aln, t = aln[inside], t[inside]
        s = strand_of[aln]
        bump(torch.full_like(t, 4), t, s)
        bump(torch.full_like(t, 5), t, s)
    return counts.view(6, seq_len, 2)


def candidates(counts: torch.Tensor, ref: torch.Tensor, min_af=0.125,
               min_depth=4, min_alt=2) -> torch.Tensor:
    """Positions (int64, ascending) of the candidates (module docstring);
    ref is the sequence's codes on the counts' device."""
    total = counts[5].sum(1)
    base_tot = counts[:4].sum(2)
    ref_sup = base_tot.gather(0, ref.clamp(0, 3).long()[None])[0]
    alt = base_tot.sum(0) + counts[4].sum(1) - ref_sup
    af = torch.where(total > 0, alt.double() / total.clamp_min(1).double(),
                     torch.zeros((), dtype=torch.float64,
                                 device=counts.device))
    keep = (total >= min_depth) & (alt >= min_alt) & (af >= min_af) \
        & (ref < 4)
    return torch.nonzero(keep)[:, 0]


def tensors(counts: torch.Tensor, ref: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """(n, 33, 8, 4) float32 input tensors of the candidates."""
    seq_len = counts.shape[1]
    dev = counts.device
    idx = positions[:, None] + torch.arange(-FLANKING, FLANKING + 1,
                                            device=dev)[None]
    valid = (idx >= 0) & (idx < seq_len)
    at = idx.clamp(0, seq_len - 1)
    ctx = counts[:, at, :].permute(1, 2, 0, 3).to(torch.float32)
    ctx = torch.where(valid[:, :, None, None], ctx, torch.zeros_like(ctx))
    both = ctx.sum(-1)                                   # (n, 33, 6)
    cap = float(DEPTH_CAP)
    t = torch.zeros((len(positions), POSITIONS, 8, 4), dtype=torch.float32,
                    device=dev)
    for ch, sel in enumerate((both, ctx[..., 0], ctx[..., 1])):
        t[:, :, 0:5, ch] = sel[:, :, 0:5].clamp(max=cap) / cap
        t[:, :, 6, ch] = sel[:, :, 5].clamp(max=cap) / cap
    rc = ref[at].long()
    on_ref = valid & (rc < 4)
    t[:, :, 5, :] = torch.where(on_ref, (rc + 1).to(torch.float32) / 4.0,
                                torch.zeros((), device=dev))[..., None]
    ref_sup = torch.where(valid, both.gather(-1, rc.clamp(0, 3)[..., None])
                          [..., 0], torch.zeros((), device=dev))
    tot = both[:, :, 5].clamp(min=1.0)
    t[:, :, 7, 0] = 1.0 - (ref_sup / tot).clamp(max=1.0)
    t[:, FLANKING, :, 3] = 1.0
    return t


def ensemble(nets: list, x: torch.Tensor) -> dict:
    """The mean over the models of each head's probabilities (numpy)."""
    if len(x) == 0:
        return {task: np.zeros((0, n), np.float32)
                for task, n in clairnet.HEAD_CLASSES.items()}
    outs = [clairnet.forward_blocks(net, x.cpu().numpy()) for net in nets]
    mean = {}
    for task in clairnet.HEADS:
        s = outs[0][task].copy()
        for o in outs[1:]:
            s += o[task]
        mean[task] = s / len(outs)
    return mean


def _margin(p: np.ndarray) -> np.ndarray:
    top = np.sort(p, axis=-1)
    return top[:, -1] - top[:, -2]


def decode(probs: dict, ref_bases: np.ndarray) -> tuple[dict, np.ndarray]:
    """({candidate index: (alt, genotype)} of the calls, the deciding
    margin of every candidate)."""
    zyg = np.argmax(probs["zygosity"], -1)
    gt = np.argmax(probs["gt21"], -1)
    margin = np.minimum(_margin(probs["zygosity"]), _margin(probs["gt21"]))
    calls = {}
    for i in np.flatnonzero(zyg != 0):
        label = GT21_LABELS[int(gt[i])]
        ref_char = "ACGT"[ref_bases[i]] if ref_bases[i] < 4 else "N"
        if len(label) == 2 and set(label) <= set("ACGT"):
            alts = [c for c in label if c != ref_char]
            alt = alts[0] if alts else label[0]
        else:
            alt = "<" + label + ">"
        calls[int(i)] = (alt, "0/1" if zyg[i] == 1 else "1/1")
    return calls, margin
