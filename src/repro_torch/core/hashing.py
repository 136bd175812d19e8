"""Stable value hashing + XASH-style superkeys (offline index build, numpy).

Cell values (strings / ints / floats) are mapped to u32 via FNV-1a — the TPU
adaptation of BLEND's varchar CellValue column (no string type on device).
Superkeys are 64-bit XASH-style row digests: each cell contributes a single
bit chosen by its hash, rotated by its column position, OR-ed across the row
(MATE's alignment-aware bloom filter, [arXiv:2205.01600]-style adaptation).
"""
from __future__ import annotations

import numpy as np

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)
MISSING = np.uint32(0xFFFFFFFF)    # reserved sentinel (never a real hash)


def fnv1a_bytes(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h if h != 0xFFFFFFFF else 0


def hash_value(v) -> int:
    """Canonical value hash.  Floats that are integral hash like ints so
    joins across int/float columns behave (paper: numeric join keys)."""
    if v is None:
        return int(MISSING)
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if isinstance(v, (bool, np.bool_)):
        v = int(v)
    if isinstance(v, (int, np.integer)):
        return fnv1a_bytes(str(int(v)).encode())
    if isinstance(v, (float, np.floating)):
        return fnv1a_bytes(repr(float(v)).encode())
    return fnv1a_bytes(str(v).encode())


def hash_array(values) -> np.ndarray:
    """Vectorized hash of a 1-D object/str/num array -> u32."""
    out = np.empty(len(values), np.uint32)
    for i, v in enumerate(values):
        out[i] = hash_value(v)
    return out


def rotl64(x: np.ndarray, r) -> np.ndarray:
    x = x.astype(np.uint64)
    r = np.asarray(r, np.uint64) % np.uint64(64)
    left = np.left_shift(x, r)
    right = np.right_shift(x, (np.uint64(64) - r) % np.uint64(64))
    # r == 0: right shift by 64 is UB-ish; mask it out
    return np.where(r == 0, x, left | right).astype(np.uint64)


def cell_bit(h: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Bit pattern a cell contributes to its row superkey."""
    h = h.astype(np.uint64)
    base = np.left_shift(np.uint64(1), h % np.uint64(64))
    return rotl64(base, (col.astype(np.uint64) * np.uint64(11)))


def row_superkey(hashes: np.ndarray, cols: np.ndarray) -> np.uint64:
    """OR of the cell bits of one row (hashes/cols aligned 1-D arrays)."""
    bits = cell_bit(hashes, cols)
    out = np.uint64(0)
    for b in bits:
        out |= b
    return out


def superkeys_for_rows(hashes, cols, row_ids, n_rows) -> np.ndarray:
    """Vectorized per-row OR: returns u64[n_rows]."""
    bits = cell_bit(np.asarray(hashes), np.asarray(cols))
    out = np.zeros(n_rows, np.uint64)
    np.bitwise_or.at(out, np.asarray(row_ids), bits)
    return out


def split_u64(x: np.ndarray):
    """u64 -> (lo u32, hi u32) for TPU-friendly storage."""
    x = x.astype(np.uint64)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32), \
        (x >> np.uint64(32)).astype(np.uint32)
