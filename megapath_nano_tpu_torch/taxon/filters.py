"""Noise-detection filters (the reference's step 8-15 noise stack).

Currently implemented:
  - spike filter (step_spike_filter, reference: bin/megapath_nano.py:
    1759-1806): per assembly, expected_max_depth = mean_depth +
    stdev * sqrt(mean_depth); depth segments above it become noise.

Other members of the stack (variable-region, human-repetitive,
microbe-repetitive, closing-spike) build on the same interval primitives and
land with the genome-set machinery.

The port's own copy of megapath_nano_tpu/taxon/filters.py.
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.taxon.abundance import (
    AssemblyInfo, best_per_read_assembly)
from megapath_nano_tpu_torch.taxon.intervals import (
    BED_DTYPE, depth_segments, make_bed, merge_bed)


def spike_filter_bed(align_list: AlignList, info: AssemblyInfo,
                     *, stdev: float = 6.0) -> np.ndarray:
    """Noise bed of depth spikes: segments with depth > mean + stdev*sqrt(mean)."""
    data = best_per_read_assembly(align_list.data)
    if len(data) == 0:
        return np.zeros(0, BED_DTYPE)
    spans = make_bed(data["assembly_id"], data["sequence_id"],
                     data["sequence_from"], data["sequence_to"])
    segs = depth_segments(spans)
    if len(segs) == 0:
        return np.zeros(0, BED_DTYPE)

    # per-assembly mean depth = total_aligned_bp / assembly_length
    aids = np.unique(data["assembly_id"])
    aligned = np.zeros(int(aids.max()) + 1, np.int64)
    np.add.at(aligned, data["assembly_id"],
              data["sequence_to"] - data["sequence_from"])
    mean_depth = np.zeros(int(aids.max()) + 1, np.float64)
    for a in aids:
        length = float(info.length[int(a)])
        mean_depth[a] = aligned[a] / length if length > 0 else 0.0
    threshold = mean_depth + stdev * np.sqrt(mean_depth)

    above = segs["depth"] > threshold[segs["assembly_id"]]
    noise = np.zeros(int(above.sum()), BED_DTYPE)
    for f in BED_DTYPE.names:
        noise[f] = segs[f][above]
    return merge_bed(noise)
