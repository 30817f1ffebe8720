"""Reference judgement of adapter trimming (porechop's method).

The configuration states the method: the read passes QC when its mean
error probability, as a phred value, is at least `qc.min_quality`; then,
in this order,

1. start: the first of the start adapters whose best local score in the
   read's first `end_size` bases reaches `end_threshold` percent of a
   perfect score cuts the read after that alignment's end, plus
   `extra_end_trim` bases;
2. end: the same for the end adapters in the last `end_size` bases of what
   is left, cutting `extra_end_trim` bases before the alignment's begin;
3. middle: where more than 2 * `min_split_size` bases are left, the first
   of the middle adapters (each start adapter, its reverse complement, each
   end adapter, adapter by adapter) whose best score over the whole read
   reaches `middle_threshold` percent splits it, `extra_middle_trim` bases
   away from the alignment on both sides; a part shorter than
   `min_split_size` is dropped, as is an empty read.

Scores are exact (`reference.sw`), so every decision is exact. Where
several alignments share the best score the method allows any of them:
a cut is right when it lies at the end (or begin) of an optimal alignment.
`judge` reads the program's output, finds each part in its input read and
counts the input reads whose outcome no optimal choice explains. `trim`
makes outputs by the same rules (the first optimal choice), and with
`check_middle=False` it is the control that leaves out step 3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core import sim
from reference.sw import local_affine, pad_batch, reverse_padded


@dataclass
class Hits:
    passed: np.ndarray          # (n,) bool: an adapter reached the threshold
    ends: list                  # per read: optimal end columns (np array)
    begins: list                # per read: optimal begin columns


def avg_quality(q: np.ndarray) -> float:
    if len(q) == 0:
        return 0.0
    return float(-10.0 * np.log10(np.mean(10.0 ** (-q.astype(np.float64)
                                                   / 10.0))))


def adapter_lists(adapters: list[dict]):
    starts, ends, middles = [], [], []
    for a in adapters:
        if a.get("start"):
            s = sim.encode(a["start"])
            starts.append(s)
            middles.append(s)
            middles.append(sim.revcomp_np(s))
        if a.get("end"):
            e = sim.encode(a["end"])
            ends.append(e)
            middles.append(e)
    return starts, ends, middles


class Scorer:
    """Best score and optimal end / begin columns of adapters in windows."""

    def __init__(self, params: dict, device, batch: int = 512):
        self.p = params
        self.device = device
        self.batch = batch

    def _dp(self, adapter, windows):
        p = self.p
        kw = dict(match=p["match"], mismatch=p["mismatch"],
                  gap_open=p["gap_open"], gap_extend=p["gap_extend"],
                  n_zero=True, want_colmax=True)
        n = len(windows)
        best = np.zeros(n, np.int64)
        ends, begins = [None] * n, [None] * n
        order = np.argsort([len(w) for w in windows], kind="stable")
        for b0 in range(0, n, self.batch):
            idx = order[b0: b0 + self.batch]
            ws = [windows[i] for i in idx]
            t = pad_batch(ws, self.device)
            q = pad_batch([adapter] * len(ws), self.device)
            sc, col = local_affine(q, t, **kw)
            lens = torch.as_tensor([len(w) for w in ws], device=self.device)
            qr = reverse_padded(q, torch.full_like(lens, len(adapter)))
            _, col_r = local_affine(qr, reverse_padded(t, lens), **kw)
            sc, col, col_r = sc.cpu().numpy(), col.cpu().numpy(), \
                col_r.cpu().numpy()
            for j, i in enumerate(idx):
                L = len(windows[i])
                best[i] = sc[j]
                ends[i] = np.flatnonzero(col[j, :L] == sc[j])
                # reversed column c is forward begin L - 1 - c
                begins[i] = np.sort(L - 1 - np.flatnonzero(
                    col_r[j, :L] == sc[j]))
        return best, ends, begins

    def first_hit(self, adapters, windows, threshold) -> Hits:
        """Per window, the first adapter whose identity reaches threshold."""
        n = len(windows)
        passed = np.zeros(n, bool)
        ends, begins = [None] * n, [None] * n
        todo = np.array([len(w) >= 5 for w in windows], bool)
        for a in adapters:
            live = np.flatnonzero(todo & ~passed)
            if len(live) == 0 or len(a) < 5:
                continue
            best, e, b = self._dp(a, [windows[i] for i in live])
            ident = 100.0 * best / (float(self.p["match"]) * len(a))
            for j, i in enumerate(live):
                if ident[j] >= threshold:
                    passed[i] = True
                    ends[i], begins[i] = e[j], b[j]
        return Hits(passed, ends, begins)


@dataclass
class Observed:
    """Where the program's parts of one input read lie in it."""

    whole: tuple | None = None     # (begin, end) of an unsplit part
    left: tuple | None = None      # part _1
    right: tuple | None = None     # part _2
    lost: bool = False             # a part that is no substring of the read


def locate(reads_in: dict, out_names: list[str], out_seqs: list[np.ndarray]
           ) -> dict:
    obs: dict[str, Observed] = {}
    raw = {}
    for name, seq in zip(out_names, out_seqs):
        base, kind = name, "whole"
        if name not in reads_in and name[-2:] in ("_1", "_2") \
                and name[:-2] in reads_in:
            base, kind = name[:-2], ("left" if name[-1] == "1" else "right")
        o = obs.setdefault(base, Observed())
        if base not in reads_in:
            o.lost = True
            continue
        if base not in raw:
            raw[base] = reads_in[base].tobytes()
        at = raw[base].find(seq.astype(np.int8).tobytes()) if len(seq) else -1
        if at < 0:
            o.lost = True
            continue
        setattr(o, kind, (at, at + len(seq)))
    return obs


def _pick(obs_value, valid):
    """The observed choice where it is valid, else the first valid one."""
    if obs_value is not None and obs_value in set(valid.tolist()):
        return obs_value, True
    return int(valid[0]), obs_value is None


def run_rules(names, reads, quals, params, adapters, device, observed=None,
              check_middle=True):
    """Apply the method to the input reads. With `observed` (from
    `locate`), follow the program's choice wherever it is optimal and
    return (wrong flags per input read, outputs); without, return the
    reference's own outputs (names, seqs)."""
    p = params
    starts, ends_ad, middles = adapter_lists(adapters)
    scorer = Scorer(p, device)
    n = len(reads)
    ok_qc = np.array([avg_quality(q) >= p["min_quality"] for q in quals])
    wrong = np.zeros(n, bool)
    obs = [observed.get(nm, Observed()) if observed is not None else None
           for nm in names]
    live = np.flatnonzero(ok_qc)
    for i in np.flatnonzero(~ok_qc):
        if obs[i] is not None and (obs[i].whole or obs[i].left
                                   or obs[i].right or obs[i].lost):
            wrong[i] = True
    for i in live:
        if obs[i] is not None and obs[i].lost:
            wrong[i] = True
    es, xe, xm = p["end_size"], p["extra_end_trim"], p["extra_middle_trim"]
    ms = p["min_split_size"]
    # 1. start adapters
    h = scorer.first_hit(starts, [reads[i][:es] for i in live],
                         p["end_threshold"])
    s = np.zeros(n, np.int64)
    for j, i in enumerate(live):
        o = obs[i]
        seen = None
        if o is not None:
            part = o.whole or o.left
            seen = part[0] if part else None
        if h.passed[j]:
            s[i], good = _pick(seen, h.ends[j] + 1 + xe)
        else:
            s[i], good = 0, seen in (None, 0)
        wrong[i] |= not good
    # 2. end adapters
    win0 = np.array([max(len(reads[i]) - s[i] - es, 0) for i in live],
                    np.int64)
    h = scorer.first_hit(ends_ad, [reads[i][s[i] + w0:]
                                   for i, w0 in zip(live, win0)],
                         p["end_threshold"])
    e = np.zeros(n, np.int64)
    for j, i in enumerate(live):
        o = obs[i]
        seen = None
        if o is not None:
            part = o.whole or o.right
            seen = part[1] if part else None
        if h.passed[j]:
            cuts = s[i] + np.maximum(win0[j] + h.begins[j] - xe, 0)
            e[i], good = _pick(seen, np.unique(cuts))
        else:
            e[i], good = len(reads[i]), seen in (None, len(reads[i]))
        wrong[i] |= not good
        e[i] = max(e[i], s[i])
    # 3. middle adapters
    mid = np.array([check_middle and e[i] - s[i] > 2 * ms for i in live],
                   bool)
    cand = live[mid]
    hm = scorer.first_hit(middles, [reads[i][s[i]:e[i]] for i in cand],
                          p["middle_threshold"])
    split = {int(i): j for j, i in enumerate(cand) if hm.passed[j]}
    out_names, out_seqs = [], []
    for i in live:
        o = obs[i]
        r = reads[i]
        if i not in split:
            if o is not None:
                if o.left or o.right:
                    wrong[i] = True
                elif e[i] > s[i] and o.whole is None:
                    wrong[i] = True
            elif e[i] > s[i]:
                out_names.append(names[i])
                out_seqs.append(r[s[i]:e[i]])
            continue
        j = split[i]
        lefts = np.maximum(hm.begins[j] - xm, 0)       # left part's length
        rights = (e[i] - s[i]) - (hm.ends[j] + 1 + xm)  # right part's
        rights = np.maximum(rights, 0)
        if o is None:
            if lefts[0] >= ms:
                out_names.append(names[i] + "_1")
                out_seqs.append(r[s[i]: s[i] + lefts[0]])
            if rights[0] >= ms:
                out_names.append(names[i] + "_2")
                out_seqs.append(r[e[i] - rights[0]: e[i]])
            continue
        if o.whole is not None:
            wrong[i] = True
            continue
        for part, lens, at_start in ((o.left, lefts, True),
                                     (o.right, rights, False)):
            if part is None:
                wrong[i] |= not (lens < ms).any()
                continue
            ln = part[1] - part[0]
            where_ok = (part[0] == s[i]) if at_start else (part[1] == e[i])
            wrong[i] |= not (where_ok and ln >= ms and (lens == ln).any())
    if observed is not None:
        return wrong, None
    return None, (out_names, out_seqs)


def judge(in_names, in_reads, in_quals, out_names, out_seqs, params,
          adapters, device) -> np.ndarray:
    """Per input read, True where the program's trimming is wrong."""
    reads_in = dict(zip(in_names, in_reads))
    observed = locate(reads_in, out_names, out_seqs)
    wrong, _ = run_rules(in_names, in_reads, in_quals, params, adapters,
                         device, observed=observed)
    extra = set(observed) - set(in_names)
    return wrong, len(extra)


def trim(in_names, in_reads, in_quals, params, adapters, device,
         check_middle=True):
    """The reference's own trimmed outputs (names, seqs)."""
    _, out = run_rules(in_names, in_reads, in_quals, params, adapters,
                       device, check_middle=check_middle)
    return out
