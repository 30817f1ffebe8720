"""Variant calling driver: candidates -> tensors -> model(s) -> VCF.

The callVarBam pipeline equivalent (reference:
bin/Clair-ensemble/.../clair/callVarBam.py:62-120 wires ExtractVariantCandidates
| CreateTensor | call_var as three processes; call_var.py decodes network
outputs to VCF records). Here it is one in-process batched path: tensors run
through the jitted network in batches, multiple models merge via
ensemble_merge, and decisions decode from the task heads.

The port's own copy of megapath_nano_tpu/variant/caller.py: the models run
on their own device (VariantModel's `device`), the rest on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.utils.log import count, span
from megapath_nano_tpu_torch.variant.candidates import (
    Candidate, candidate_tensor, extract_candidates)
from megapath_nano_tpu_torch.variant.ensemble import ensemble_merge
from megapath_nano_tpu_torch.variant.model import GT21_LABELS, VariantModel


@dataclass
class VariantCall:
    sequence_id: int
    position: int               # 0-based
    ref_base: int
    alt: str                    # ACGT or symbolic
    genotype: str               # "0/1" or "1/1"
    quality: float
    depth: int
    alt_fraction: float


def _decode(probs: dict, cand: Candidate) -> VariantCall | None:
    zyg = int(np.argmax(probs["zygosity"]))
    if zyg == 0:                 # hom-ref
        return None
    gt21 = int(np.argmax(probs["gt21"]))
    label = GT21_LABELS[gt21]
    qual = float(-10.0 * np.log10(max(1e-9, 1.0 - probs["zygosity"][zyg])))
    ref_char = "ACGT"[cand.ref_base] if cand.ref_base < 4 else "N"
    # SNV alt: the non-ref base of the genotype pair
    if len(label) == 2 and set(label) <= set("ACGT"):
        alts = [c for c in label if c != ref_char]
        alt = alts[0] if alts else label[0]
    else:
        alt = "<" + label + ">"
    return VariantCall(
        sequence_id=cand.sequence_id, position=cand.position,
        ref_base=cand.ref_base, alt=alt,
        genotype="0/1" if zyg == 1 else "1/1",
        quality=qual, depth=cand.depth, alt_fraction=cand.alt_fraction)


def call_variants(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    ref_seq: np.ndarray,
    models: list[VariantModel],
    *,
    min_af: float = 0.125,
    min_depth: int = 4,
    min_quality: float = 0.0,
    batch_size: int = 256,
) -> list[VariantCall]:
    with span("variant.candidates"):
        cands = extract_candidates(align_list, reads, sequence_id, ref_seq,
                                   min_af=min_af, min_depth=min_depth)
        count("candidates", len(cands))
        if not cands:
            return []
        tensors = np.stack([candidate_tensor(c, ref_seq) for c in cands])
    # pad to fixed batch for stable jit shapes
    per_model = []
    n_batches = -(-len(cands) // batch_size)
    with span("variant.model"):
        for model in models:
            out: dict[tuple, dict[str, np.ndarray]] = {}
            for s in range(0, len(cands), batch_size):
                e = min(s + batch_size, len(cands))
                chunk = tensors[s:e]
                pad = batch_size - (e - s)
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad,) + chunk.shape[1:],
                                         np.float32)])
                probs = model.predict(chunk)
                for i in range(e - s):
                    key = (sequence_id, cands[s + i].position)
                    out[key] = {k: v[i] for k, v in probs.items()}
            per_model.append(out)
        count("model_rows", len(cands) * len(models))
        count("model_rows_launched", n_batches * batch_size * len(models))
        count("model_batches", n_batches * len(models))
    merged = ensemble_merge(per_model)

    calls = []
    for c in cands:
        probs = merged.get((sequence_id, c.position))
        if probs is None:
            continue
        call = _decode(probs, c)
        if call is not None and call.quality >= min_quality:
            calls.append(call)
    return calls


def call_variants_af(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    ref_seq: np.ndarray,
    *,
    min_af: float = 0.125,
    min_depth: int = 4,
    het_af: float = 0.25,
    hom_af: float = 0.75,
) -> list[VariantCall]:
    """Allele-frequency threshold caller (no NN) — the fallback when no
    trained model is available, approximating bcftools `call -mv` majority
    behavior (the reference's AMR consensus path, megapath_nano_amr.py:43)."""
    cands = extract_candidates(align_list, reads, sequence_id, ref_seq,
                               min_af=min_af, min_depth=min_depth)
    calls = []
    for c in cands:
        ctx = c.context[len(c.context) // 2]      # (6, 2) at the position
        base_counts = ctx[:4].sum(axis=1)
        ref_b = c.ref_base
        alt_b = int(np.argmax(
            [cnt if b != ref_b else -1 for b, cnt in enumerate(base_counts)]))
        alt_count = int(base_counts[alt_b])
        depth = max(int(ctx[5].sum()), 1)
        af = alt_count / depth
        if af < het_af:
            continue
        gt = "1/1" if af >= hom_af else "0/1"
        qual = float(min(60.0, 10.0 * alt_count))
        calls.append(VariantCall(
            sequence_id=sequence_id, position=c.position, ref_base=ref_b,
            alt="ACGT"[alt_b], genotype=gt, quality=qual, depth=depth,
            alt_fraction=af))
    return calls


def write_vcf(path: str, calls: list[VariantCall],
              seq_names: list[str]) -> None:
    """Minimal VCF 4.2 writer (the reference emits VCF via call_var.py)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        # the reference's header line: both packages write the same file
        f.write("##source=megapath_nano_tpu.variant\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                "SAMPLE\n")
        for c in sorted(calls, key=lambda x: (x.sequence_id, x.position)):
            chrom = seq_names[c.sequence_id] \
                if c.sequence_id < len(seq_names) else str(c.sequence_id)
            ref = "ACGT"[c.ref_base] if c.ref_base < 4 else "N"
            f.write(f"{chrom}\t{c.position + 1}\t.\t{ref}\t{c.alt}\t"
                    f"{c.quality:.1f}\tPASS\tDP={c.depth};AF={c.alt_fraction:.3f}"
                    f"\tGT\t{c.genotype}\n")
