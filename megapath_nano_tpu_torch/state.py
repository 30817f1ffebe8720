"""State carried across from the TPU package: the host index
(`index_from_numpy`), the sharded index planes of the mesh path
(`sharded_planes_from_numpy`), the reference DB of the taxon profile
(`refdb_from_numpy`), an AMR gene DB (`amr_db_from_numpy`), the device
planes (`device_planes_from_numpy`) and the variant model's weights
(`variant_params_from_numpy`, `variant_params_to_numpy`). The map, profile
and AMR paths have no weights: the reference DB (sequences, taxonomy,
minimizer index), the gene DBs and the 4-bit packed reference are their
state.

The variant model's weights travel in the TPU package's flax layout, the
one its pickles hold: {"params": {Dense_0..6: {kernel (in, out), bias},
LSTMCell_0 (forward), LSTMCell_1 (backward): {ii, if, ig, io: {kernel (in,
H)}, hi, hf, hg, ho: {kernel (H, H), bias}}}}, float32 numpy. Onto the
port's ClairNet: a dense kernel is its Linear's weight transposed; an LSTM
cell is one direction of the nn.LSTM with weight_ih = (ii|if|ig|io)^T,
weight_hh = (hi|hf|hg|ho)^T, bias_ih = (hi|hf|hg|ho biases) and bias_hh = 0
(torch's gate order is flax's: input, forget, cell, output).

The TPU package's MinimizerAligner keeps these arrays on its device (built
on the host from the MinimizerIndex):

  seq4         uint8  4-bit packed reference (2 codes/byte, high nibble
                      first) with a 2**15-code sentinel tail of 5
  seq_offsets  int32  per-sequence start in the flat reference
  seq_lengths  int32  per-sequence length
  keys32       int32  sorted minimizer hash table (hashes < 2**30)
  pos_t        int32  per-entry k-mer end position within its sequence
  ss16         uint16 per-entry seq_id << 1 | strand
  lut2         int32  (2**lut_bits, 2) paired bucket bounds into keys32
  runcnt       uint8  equal-key run length at each run start (clipped 255)

`device_planes_from_numpy` carries any of them into the port's tensors on a
given device; the port's MinimizerAligner builds its state through it, and a
caller holding the TPU aligner's arrays can carry them over the same way.
ss16 widens to int32 on the device, since torch's uint16 supports too few
ops for the seed stage's gathers and shifts: that costs 2 more bytes per
index entry (8 bytes of position planes per entry instead of 6).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from megapath_nano_tpu_torch.amr.db import AMRGeneDB
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex

# name -> (dtype the TPU aligner holds, dtype of the port's tensor)
PLANES = {
    "seq4": (np.uint8, torch.uint8),
    "seq_offsets": (np.int32, torch.int32),
    "seq_lengths": (np.int32, torch.int32),
    "keys32": (np.int32, torch.int32),
    "pos_t": (np.int32, torch.int32),
    "ss16": (np.uint16, torch.int32),
    "lut2": (np.int32, torch.int32),
    "runcnt": (np.uint8, torch.uint8),
}


def device_planes_from_numpy(arrays: Mapping[str, np.ndarray], *,
                             device) -> dict[str, torch.Tensor]:
    """Carry numpy planes (any subset of PLANES, in the TPU aligner's
    dtypes) to tensors on `device`, in the port's dtypes."""
    out = {}
    for name, arr in arrays.items():
        if name not in PLANES:
            raise ValueError(f"unknown plane {name!r}; expected one of "
                             f"{sorted(PLANES)}")
        np_dtype, torch_dtype = PLANES[name]
        arr = np.asarray(arr)
        if arr.dtype != np_dtype:
            raise ValueError(f"plane {name!r} must be {np.dtype(np_dtype)}; "
                             f"got {arr.dtype}")
        host = np.ascontiguousarray(
            arr.astype(np.int32) if torch_dtype == torch.int32 else arr)
        if not host.flags.writeable:     # e.g. a view of a JAX array
            host = host.copy()
        out[name] = torch.from_numpy(host).to(device=device,
                                              dtype=torch_dtype)
    return out


def index_from_numpy(src) -> MinimizerIndex:
    """Build the port's MinimizerIndex from the arrays of any object with the
    same fields (the TPU package's MinimizerIndex, or a loaded archive),
    field for field, without rebuilding. The arrays are shared, not
    copied; the lazily built lookup LUT is left to be rebuilt."""
    def arr(x, dtype):
        return None if x is None else np.ascontiguousarray(x, dtype)

    return MinimizerIndex(
        k=int(src.k), w=int(src.w),
        keys=arr(src.keys, np.uint64),
        positions=arr(src.positions, np.uint64),
        seq_lengths=arr(src.seq_lengths, np.int64),
        seq_names=list(src.seq_names),
        seq_data=arr(src.seq_data, np.int8),
        seq_offsets=arr(src.seq_offsets, np.int64))


def sharded_planes_from_numpy(src):
    """Build the port's ShardedIndexPlanes (dist/fused_sharded.py) from any
    object with the same fields (the TPU package's ShardedIndexPlanes, or a
    loaded archive), field for field, without rebuilding: the stacked planes
    in their on-disk dtypes, each shard's host index, when `src` holds
    them, through `index_from_numpy`."""
    # imported here: dist.fused_sharded imports align.pipeline, which
    # imports this
    from megapath_nano_tpu_torch.dist.fused_sharded import ShardedIndexPlanes

    def arr(x, dtype):
        return np.ascontiguousarray(x, dtype)

    shard_of_seq = getattr(src, "shard_of_seq", None)
    return ShardedIndexPlanes(
        keys32=arr(src.keys32, np.int32), pos_t=arr(src.pos_t, np.int32),
        pos_ss=arr(src.pos_ss, np.int32),
        seq_data=arr(src.seq_data, np.int8),
        seq_offsets=arr(src.seq_offsets, np.int32),
        seq_lengths=arr(src.seq_lengths, np.int32),
        seq_global=arr(src.seq_global, np.int32),
        k=int(src.k), w=int(src.w), seq_bits=int(src.seq_bits),
        global_seq_names=list(src.global_seq_names),
        global_seq_lengths=arr(src.global_seq_lengths, np.int64),
        local_indexes=[index_from_numpy(x)
                       for x in getattr(src, "local_indexes", None) or []],
        shard_of_seq=(None if shard_of_seq is None
                      else arr(shard_of_seq, np.int32)))


def refdb_from_numpy(src):
    """Build the port's RefDB from any object with the same fields (the TPU
    package's RefDB), field for field: the index through `index_from_numpy`,
    not rebuilt, and the tables shared, not copied."""
    # imported here: db.refdb imports align.pipeline, which imports this
    from megapath_nano_tpu_torch.db.refdb import RefDB

    return RefDB(
        index=index_from_numpy(src.index),
        seq_assembly=np.asarray(src.seq_assembly),
        assembly_names=list(src.assembly_names),
        assembly_lengths=np.asarray(src.assembly_lengths),
        assembly_tax=np.asarray(src.assembly_tax),
        tax_names=dict(src.tax_names))


def amr_db_from_numpy(src):
    """Build the port's AMRGeneDB from any object with the same fields (the
    TPU package's AMRGeneDB), field for field: the gene index, when `src`
    has built one, through `index_from_numpy`, not rebuilt; the sequences
    shared, not copied."""
    index = getattr(src, "_index", None)
    return AMRGeneDB(
        name=src.name, gene_names=list(src.gene_names),
        sequences=[np.asarray(s) for s in src.sequences],
        drugs=[list(d) for d in src.drugs], classes=list(src.classes),
        accessions=list(src.accessions), taxa=list(src.taxa),
        _index=None if index is None else index_from_numpy(index))


# ClairNet's dense layers in the order flax names them (Dense_0 .. Dense_6)
_DENSE = ("slice_dense", "dense1", "dense2", "heads.gt21", "heads.zygosity",
          "heads.var_len_1", "heads.var_len_2")
_GATES = "ifgo"


def _variant_tensors(params) -> dict[str, np.ndarray]:
    """{ClairNet state_dict name: float32 array} from the flax tree (the
    variables dict {"params": ...} or its "params" entry)."""
    p = params["params"] if "params" in params else params
    out = {}
    for j, name in enumerate(_DENSE):
        d = p[f"Dense_{j}"]
        out[name + ".weight"] = np.asarray(d["kernel"], np.float32).T
        out[name + ".bias"] = np.asarray(d["bias"], np.float32)
    for cell, sfx in (("LSTMCell_0", ""), ("LSTMCell_1", "_reverse")):
        c = p[cell]
        out["lstm.weight_ih_l0" + sfx] = np.concatenate(
            [c["i" + g]["kernel"] for g in _GATES], axis=1).T
        out["lstm.weight_hh_l0" + sfx] = np.concatenate(
            [c["h" + g]["kernel"] for g in _GATES], axis=1).T
        bias = np.concatenate([c["h" + g]["bias"] for g in _GATES])
        out["lstm.bias_ih_l0" + sfx] = bias
        out["lstm.bias_hh_l0" + sfx] = np.zeros_like(bias)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


@torch.no_grad()
def load_variant_params(net, params):
    """Copy the flax tree's weights into `net` in place (its optimizer, if
    any, keeps its hold on the same tensors)."""
    got = _variant_tensors(params)
    state = net.state_dict()
    if set(got) != set(state):
        raise ValueError(f"variant params: {sorted(set(got) ^ set(state))}")
    for name, value in got.items():
        if state[name].shape != value.shape:
            raise ValueError(f"variant params: {name} is {value.shape}, the "
                             f"network's {tuple(state[name].shape)}")
        state[name].copy_(torch.tensor(value))
    return net


def variant_params_from_numpy(params, *, device="cuda"):
    """A ClairNet on `device` (the GPU unless the caller asks for "cpu")
    holding the flax tree's weights (hidden and slice widths read off the
    LSTM kernels)."""
    # imported here: variant.model and align.pipeline import this
    from megapath_nano_tpu_torch.align.pipeline import require_device
    from megapath_nano_tpu_torch.variant.model import ClairNet

    require_device(device, "variant_params_from_numpy")

    cell = (params["params"] if "params" in params else params)["LSTMCell_0"]
    slice_dim, hidden = np.shape(cell["ii"]["kernel"])
    net = ClairNet(hidden=int(hidden), slice_dim=int(slice_dim))
    return load_variant_params(net, params).to(device)


def variant_params_to_numpy(net) -> dict:
    """The flax variables dict {"params": {...}} of `net`'s weights, float32
    numpy on the host: what the TPU package's VariantModel holds and
    pickles. Its bias_hh must be 0 (flax has no second bias)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in net.state_dict().items()}
    p = {}
    for j, name in enumerate(_DENSE):
        p[f"Dense_{j}"] = {
            "kernel": np.ascontiguousarray(sd[name + ".weight"].T),
            "bias": sd[name + ".bias"]}
    h = net.hidden
    for cell, sfx in (("LSTMCell_0", ""), ("LSTMCell_1", "_reverse")):
        if np.any(sd["lstm.bias_hh_l0" + sfx]):
            raise ValueError("ClairNet bias_hh must be 0 to carry over")
        w_ih = sd["lstm.weight_ih_l0" + sfx]
        w_hh = sd["lstm.weight_hh_l0" + sfx]
        b = sd["lstm.bias_ih_l0" + sfx]
        c = {}
        for k, g in enumerate(_GATES):
            rows = slice(k * h, (k + 1) * h)
            c["i" + g] = {"kernel": np.ascontiguousarray(w_ih[rows].T)}
            c["h" + g] = {"kernel": np.ascontiguousarray(w_hh[rows].T),
                          "bias": b[rows].copy()}
        p[cell] = c
    return {"params": p}
