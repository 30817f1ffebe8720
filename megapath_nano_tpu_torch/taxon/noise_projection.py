"""Noise projection (reference step 20): estimate cross-species noise by
simulating reads from high-abundance assemblies and measuring how much of
them aligns to genus siblings.

Reference: bin/megapath_nano.py:2596-2749 — for the top genera, NanoSim
simulates reads from the most abundant assemblies (length capped at 0.5x the
assembly's average read length, :2675-2685), aligns them against the genus'
assemblies, and reports projected noise bp per (source, target) pair.

The port's own copy of megapath_nano_tpu/taxon/noise_projection.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (
    AlignParams, MinimizerAligner)
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.sim.simulator import ErrorProfile, simulate_reads


@dataclass
class NoiseProjection:
    source_assembly: int
    target_assembly: int
    simulated_reads: int
    projected_noise_bp: int
    projected_noise_reads: int


def project_noise(
    source_assembly: int,
    source_seqs: list[np.ndarray],
    sibling_assemblies: dict[int, list[np.ndarray]],
    *,
    n_reads: int = 1000,
    max_read_length: int | None = None,
    profile: ErrorProfile | None = None,
    device="cuda",
    seed: int = 0,
) -> list[NoiseProjection]:
    """Simulate reads from source, align to each sibling (on `device`),
    count noise."""
    genome = np.concatenate(source_seqs)
    reads, _ = simulate_reads(genome, n_reads, profile, seed=seed,
                              max_length=max_read_length or 2000)
    out = []
    for target, seqs in sibling_assemblies.items():
        if target == source_assembly:
            continue
        index = MinimizerIndex.build(
            seqs, [f"t{target}s{i}" for i in range(len(seqs))])
        aligner = MinimizerAligner(index, params=AlignParams(),
                                   device=device)
        res = aligner.map_reads(reads)
        if len(res):
            d = res.data
            noise_bp = int((d["sequence_to"] - d["sequence_from"]).sum())
            noise_reads = len(np.unique(d["read_id"]))
        else:
            noise_bp = noise_reads = 0
        out.append(NoiseProjection(
            source_assembly=source_assembly, target_assembly=target,
            simulated_reads=n_reads, projected_noise_bp=noise_bp,
            projected_noise_reads=noise_reads))
    return out
