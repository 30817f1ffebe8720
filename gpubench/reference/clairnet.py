"""Plain PyTorch ClairNet forward in float32: the benchmark's reference.

The architecture as the port's `variant/model.py` publishes it
(slice-dense -> bidirectional LSTM -> shared dense -> 4 heads), read off
the weights' own layout (flax's parameter tree, the shipped pickles'):

- the slice dense layer `Dense_0` (32 -> slice width) with ReLU, at each of
  the 33 positions of the (33, 8, 4) tensor flattened to (33, 32);
- a bidirectional LSTM of `hidden` units: `LSTMCell_0` runs over the
  positions forward, `LSTMCell_1` backward (its outputs put back in
  position order). A cell is written out step by step: gates
  i, f, g, o = sigmoid / sigmoid / tanh / sigmoid of (x W_x + h W_h + b),
  c' = f c + i g, h' = o tanh(c'), from h = c = 0. One bias a gate, on
  its recurrent product, as flax's LSTMCell has it;
- the forward and backward outputs side by side (2 hidden), the centre
  position's and the maximum over positions, side by side (4 hidden);
- dense 256 and 128 with ReLU (`Dense_1`, `Dense_2`), and the four heads
  gt21 (21), zygosity (3), var_len_1 and var_len_2 (5 each) (`Dense_3` to
  `Dense_6`) under a softmax.

Departures from the port, none in the mathematics: no `nn.LSTM` (the cell
is a loop of matrix products and pointwise gates), no cuDNN, no batching
or padding (the rows are the caller's), and the weights are read from the
pickles by path with `pickle` and numpy. Matrix products run in float32:
importing this module sets `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False. `precision="tf32"` is the
nearest precision below, for the check's control: TF32 on the card, and
everywhere the matrix products' inputs rounded to TF32's 10-bit mantissa.

It imports nothing of the program.
"""

from __future__ import annotations

import json
import os
import pickle
from contextlib import contextmanager

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POSITIONS = 33
HEAD_CLASSES = {"gt21": 21, "zygosity": 3, "var_len_1": 5, "var_len_2": 5}
HEADS = tuple(HEAD_CLASSES)
GATES = "ifgo"
MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "megapath_nano_tpu", "variant", "models")


def manifest(model_dir: str = MODEL_DIR) -> dict:
    with open(os.path.join(model_dir, "manifest.json")) as f:
        return json.load(f)


def load_params(path: str) -> dict:
    """The flax parameter tree of a pickle ({"params": tree} or the tree)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    params = blob["params"] if isinstance(blob, dict) and "params" in blob \
        else blob
    return params["params"] if "params" in params else params


def shipped(model_dir: str = MODEL_DIR) -> list[dict]:
    """The shipped ensemble's parameter trees, in the manifest's order."""
    return [load_params(os.path.join(model_dir, name))
            for name in manifest(model_dir)["models"]]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away),
    what a TF32 matrix product does to its inputs."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Net:
    """One model's weights as float32 tensors on `device`."""

    def __init__(self, tree: dict, device, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(precision)
        self.precision = precision
        self.device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.dense = [(t(tree[f"Dense_{j}"]["kernel"]),
                       t(tree[f"Dense_{j}"]["bias"])) for j in range(7)]
        self.cells = []
        for name in ("LSTMCell_0", "LSTMCell_1"):
            c = tree[name]
            self.cells.append((
                torch.cat([t(c["i" + g]["kernel"]) for g in GATES], 1),
                torch.cat([t(c["h" + g]["kernel"]) for g in GATES], 1),
                torch.cat([t(c["h" + g]["bias"]) for g in GATES], 0)))
        self.hidden = int(self.cells[0][1].shape[0])

    def mm(self, a, b):
        if self.precision == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def linear(self, x, j):
        w, b = self.dense[j]
        return self.mm(x, w) + b

    def lstm(self, xs, k, reverse):
        """xs (B, T, S) -> (B, T, H), outputs in position order."""
        w_x, w_h, b = self.cells[k]
        n, steps, _ = xs.shape
        hid = self.hidden
        h = torch.zeros((n, hid), device=xs.device)
        c = torch.zeros((n, hid), device=xs.device)
        out = [None] * steps
        for s in (range(steps - 1, -1, -1) if reverse else range(steps)):
            z = self.mm(xs[:, s], w_x) + self.mm(h, w_h) + b
            i = torch.sigmoid(z[:, :hid])
            f = torch.sigmoid(z[:, hid: 2 * hid])
            g = torch.tanh(z[:, 2 * hid: 3 * hid])
            o = torch.sigmoid(z[:, 3 * hid:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            out[s] = h
        return torch.stack(out, 1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> dict:
        """x (B, 33, 8, 4) float32 -> softmax probabilities of each head."""
        n = x.shape[0]
        with _matmul_precision(self.precision):
            h = torch.relu(self.linear(x.reshape(n, POSITIONS, -1), 0))
            h = torch.cat([self.lstm(h, 0, False), self.lstm(h, 1, True)],
                          -1)
            h = torch.cat([h[:, POSITIONS // 2], h.max(1).values], -1)
            h = torch.relu(self.linear(h, 1))
            h = torch.relu(self.linear(h, 2))
            return {task: torch.softmax(self.linear(h, 3 + j), -1)
                    for j, task in enumerate(HEADS)}


@contextmanager
def _matmul_precision(precision):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def forward_blocks(net: Net, x: np.ndarray, block: int = 4096) -> dict:
    """net.forward over rows of x in blocks; float32 numpy per head."""
    parts = {task: [] for task in HEADS}
    for s in range(0, len(x), block):
        xb = torch.as_tensor(np.asarray(x[s: s + block], np.float32),
                             device=net.device)
        for task, p in net.forward(xb).items():
            parts[task].append(p.cpu().numpy())
    return {task: np.concatenate(v) if v else np.zeros((0,), np.float32)
            for task, v in parts.items()}
