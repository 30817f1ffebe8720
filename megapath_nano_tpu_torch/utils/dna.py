"""DNA sequence encoding helpers (host side, numpy). The port's own copy of
megapath_nano_tpu/utils/dna.py.

Canonical numeric encoding across the framework: A=0 C=1 G=2 T=3, N/other=4.
"""

from __future__ import annotations

import numpy as np

_ENCODE = np.full(256, 4, dtype=np.int8)
for i, base in enumerate("ACGT"):
    _ENCODE[ord(base)] = i
    _ENCODE[ord(base.lower())] = i
_ENCODE[ord("U")] = _ENCODE[ord("u")] = 3

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes (0..4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)].copy()


def decode(codes: np.ndarray) -> str:
    """int8 codes -> ASCII string."""
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of numeric codes (N maps to N)."""
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.int8)
    return comp[::-1].copy()


def random_sequence(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int8)


def mutate(
    rng: np.random.Generator,
    seq: np.ndarray,
    sub_rate: float = 0.0,
    ins_rate: float = 0.0,
    del_rate: float = 0.0,
) -> np.ndarray:
    """Apply ONT-style substitutions/indels — used for simulated test reads."""
    out = []
    for base in seq:
        r = rng.random()
        if r < del_rate:
            continue
        if r < del_rate + ins_rate:
            out.append(int(rng.integers(0, 4)))  # inserted base, then original
        if r < del_rate + ins_rate + sub_rate and r >= del_rate + ins_rate:
            out.append((int(base) + int(rng.integers(1, 4))) % 4)
        else:
            out.append(int(base))
    return np.asarray(out, dtype=np.int8)
