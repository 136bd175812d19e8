"""The unified BLEND index: one columnar fact table serving all seekers.

The host side (build, bucket layout, planner statistics) is NumPy and builds
exactly the arrays of the JAX package's ``repro.core.index``; only the device
view differs.  torch's uint32 has no ``searchsorted``, ``>>`` or ``max``, so
``device_arrays`` stores 32-bit hashes in an order-preserving signed form:

* ``hash`` (and every probe query) is int32 ``h ^ 0x80000000`` — the map
  ``u -> u - 2^31`` — so sorted order and ``searchsorted`` carry over and the
  MISSING sentinel ``0xFFFFFFFF`` becomes ``INT32_MAX``;
* ``sk_lo`` / ``sk_hi`` are plain int32 bit-views (``&`` and ``==`` do not
  care about the sign);
* the radix-bucket row of a key ``k`` is ``(k + 2^31) >> (32 - bits)``.

``build_index`` also builds every table's sketch (core/sketch.py) from the
same posting arrays, as the JAX package does: the approximate tier's host
summaries.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.lake import DataLake
from repro_torch.core.sketch import SketchConfig, copy_sketches, \
    sketch_tables

SIGN = np.uint32(0x80000000)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without a card the caller must ask for the CPU
    explicitly (``device="cpu"``) — the port never falls back quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def hash_keys(h: np.ndarray) -> np.ndarray:
    """u32 hashes -> order-preserving int32 device keys (``h ^ 2^31``)."""
    return (np.asarray(h, np.uint32) ^ SIGN).view(np.int32)


def _ceil_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def validate_row_stride(n_tables: int, row_stride: int, max_rows: int = 0):
    """Rowkey soundness guard: ``rowkey = table * row_stride + row`` must be
    collision-free and fit int32."""
    if max_rows > row_stride:
        raise ValueError(
            f"row_stride={row_stride} is smaller than the longest table "
            f"({max_rows} rows): rowkeys would alias across tables and "
            f"corrupt MC/correlation joins; widen the stride (build_index "
            f"auto-widens; pass row_stride >= {_ceil_pow2(max_rows)})")
    if n_tables * row_stride >= 2 ** 31:
        raise ValueError(
            f"int32 rowkey overflow: {n_tables} tables * row_stride="
            f"{row_stride} exceeds 2^31; shard the lake")


def _is_numeric_col(values) -> bool:
    seen = False
    for v in values:
        if v is None:
            continue
        if isinstance(v, (bool, str)):
            return False
        if not isinstance(v, (int, float, np.integer, np.floating)):
            return False
        seen = True
    return seen


@dataclass
class UnifiedIndex:
    cell_hash: np.ndarray        # u32 [N] sorted
    table_id: np.ndarray         # i32 [N]
    col_id: np.ndarray           # i32 [N]
    row_id: np.ndarray           # i32 [N]
    superkey_lo: np.ndarray      # u32 [N]
    superkey_hi: np.ndarray      # u32 [N]
    quadrant: np.ndarray         # i8  [N]
    rank_conv: np.ndarray        # i32 [N]
    rank_rand: np.ndarray        # i32 [N]
    # numeric-by-row view (indices into the arrays above)
    num_perm: np.ndarray         # i32 [M] numeric postings by (table,row)
    num_rowkey: np.ndarray       # i32 [M] sorted rowkeys of num_perm
    # metadata
    n_tables: int
    max_cols: int
    bucket_bits: int
    bucket_offsets: np.ndarray   # i64 [2^bits + 1]
    table_rows: np.ndarray       # i32 [n_tables]
    row_stride: int              # rowkey = table * row_stride + row
    # approximate tier: {table_id: core.sketch.TableSketch} built from the
    # same posting arrays (see core/sketch.py for the determinism contract)
    sketches: dict = field(default_factory=dict, compare=False)
    sketch_config: SketchConfig = field(default_factory=SketchConfig,
                                        compare=False)

    @classmethod
    def from_numpy(cls, arrays: dict) -> "UnifiedIndex":
        """Build from another index's fields (for example ``vars()`` of the
        JAX package's ``UnifiedIndex``), so two systems can be handed the very
        same arrays and sketches.  Arrays are copied; each sketch is rebuilt
        field by field (``sketch.copy_sketches``) and the sketch config
        through its ``as_dict``, so the index holds none of the other
        system's objects.  Without ``sketches`` the index has none."""
        names = [f.name for f in fields(cls)
                 if f.name not in ("sketches", "sketch_config")]
        missing = [n for n in names if n not in arrays]
        if missing:
            raise KeyError(f"index fields missing: {missing}")
        vals = {n: arrays[n] for n in names}
        cfg = arrays.get("sketch_config")
        return cls(**{n: v.copy() if isinstance(v, np.ndarray) else v
                      for n, v in vals.items()},
                   sketches=copy_sketches(arrays.get("sketches") or {}),
                   sketch_config=SketchConfig.from_dict(cfg.as_dict())
                   if cfg is not None else SketchConfig())

    @property
    def n_postings(self) -> int:
        return len(self.cell_hash)

    def storage_bytes(self) -> int:
        """Bytes of the host index: the nine posting arrays plus the
        numeric view and the bucket offsets (the device copies, whose key
        forms differ, are not counted)."""
        core = sum(getattr(self, k).nbytes for k in POSTING_KEYS)
        views = self.num_perm.nbytes + self.num_rowkey.nbytes + \
            self.bucket_offsets.nbytes
        return core + views

    def device_arrays(self, device) -> dict:
        """The 15 tensors the seekers consume, on ``device`` (see the module
        docstring for the int32 key forms)."""
        perm = self.num_perm

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return {
            "hash": put(hash_keys(self.cell_hash)),
            "table": put(self.table_id),
            "col": put(self.col_id),
            "row": put(self.row_id),
            "sk_lo": put(self.superkey_lo.view(np.int32)),
            "sk_hi": put(self.superkey_hi.view(np.int32)),
            "quadrant": put(self.quadrant),
            "rank_conv": put(self.rank_conv),
            "rank_rand": put(self.rank_rand),
            "num_rowkey": put(self.num_rowkey),
            "num_table": put(self.table_id[perm]),
            "num_col": put(self.col_id[perm]),
            "num_quadrant": put(self.quadrant[perm]),
            "num_rank_conv": put(self.rank_conv[perm]),
            "num_rank_rand": put(self.rank_rand[perm]),
        }

    def host_counts(self, q_hashes: np.ndarray) -> np.ndarray:
        """Match counts per query hash (planner statistics, O(|Q| log N))."""
        lo = np.searchsorted(self.cell_hash, q_hashes, side="left")
        hi = np.searchsorted(self.cell_hash, q_hashes, side="right")
        return (hi - lo).astype(np.int64)

    def padded_buckets(self, width: int):
        """Padded radix-bucket layout for the probe kernel: returns
        (bucket_hashes u32 [2^bits, width], bucket_payload i32 [...],
        overflow_count).  Pads carry hash MISSING and payload -1."""
        nb = 1 << self.bucket_bits
        bh = np.full((nb, width), hashing.MISSING, np.uint32)
        bp = np.full((nb, width), -1, np.int32)
        shift = 32 - self.bucket_bits
        buckets = (self.cell_hash >> shift).astype(np.int64)
        starts = self.bucket_offsets[:-1]
        pos = np.arange(self.n_postings, dtype=np.int64) - starts[buckets]
        keep = pos < width
        counts = np.diff(self.bucket_offsets)
        overflow = int(np.maximum(counts - width, 0).sum())
        bh[buckets[keep], pos[keep]] = self.cell_hash[keep]
        bp[buckets[keep], pos[keep]] = np.nonzero(keep)[0].astype(np.int32)
        return bh, bp, overflow

    def max_bucket_count(self) -> int:
        """Largest bucket population (the lossless probe-kernel width)."""
        return int(np.diff(self.bucket_offsets).max(initial=0))

    def aos_view(self) -> np.ndarray:
        """Row-store interleave (hash, t, c, r, sk_lo, sk_hi, quadrant) as
        an int32 [N, 7] matrix, the 'PostgreSQL layout' of the paper's
        Fig 5."""
        out = np.empty((self.n_postings, 7), np.int32)
        out[:, 0] = self.cell_hash.view(np.int32)
        out[:, 1] = self.table_id
        out[:, 2] = self.col_id
        out[:, 3] = self.row_id
        out[:, 4] = self.superkey_lo.view(np.int32)
        out[:, 5] = self.superkey_hi.view(np.int32)
        out[:, 6] = self.quadrant
        return out


POSTING_KEYS = ("cell_hash", "table_id", "col_id", "row_id", "superkey_lo",
                "superkey_hi", "quadrant", "rank_conv", "rank_rand")


def table_postings(table, tid: int, *, seed: int = 0,
                   with_quadrants: bool = True) -> dict:
    """Unsorted posting arrays for one table (dict over ``POSTING_KEYS``).
    ``rank_rand`` is seeded per (table name, column), so the shuffle a column
    gets is independent of build order."""
    nr, nc = table.n_rows, table.n_cols
    col_hashes, col_quads, col_rand = [], [], []
    for c, col in enumerate(table.columns):
        col_hashes.append(hashing.hash_array(col))
        if with_quadrants and _is_numeric_col(col):
            vals = np.array([float(v) for v in col])
            col_quads.append((vals >= vals.mean()).astype(np.int8))
        else:
            col_quads.append(np.full(nr, -1, np.int8))
        rng = np.random.default_rng(
            [seed, hashing.fnv1a_bytes(str(table.name).encode()), c])
        col_rand.append(rng.permutation(nr).astype(np.int32))
    # row superkeys: OR of position-independent cell bits (MATE-style
    # bloom; alignment is verified exactly at query time)
    if nc:
        all_h = np.concatenate(col_hashes)
        all_r = np.tile(np.arange(nr), nc)
        sk = hashing.superkeys_for_rows(all_h, np.zeros_like(all_h), all_r, nr)
    else:
        sk = np.zeros(0, np.uint64)
    lo32, hi32 = hashing.split_u64(sk)
    n = nr * nc
    return {
        "cell_hash": np.concatenate(col_hashes) if nc
        else np.zeros(0, np.uint32),
        "table_id": np.full(n, tid, np.int32),
        "col_id": np.repeat(np.arange(nc, dtype=np.int32), nr),
        "row_id": np.tile(np.arange(nr, dtype=np.int32), nc),
        "superkey_lo": np.tile(lo32, nc),
        "superkey_hi": np.tile(hi32, nc),
        "quadrant": np.concatenate(col_quads) if nc else np.zeros(0, np.int8),
        "rank_conv": np.tile(np.arange(nr, dtype=np.int32), nc),
        "rank_rand": np.concatenate(col_rand) if nc else np.zeros(0, np.int32),
    }


_POSTING_DTYPES = {"cell_hash": np.uint32, "quadrant": np.int8,
                   "superkey_lo": np.uint32, "superkey_hi": np.uint32}


def concat_postings(per_table: list) -> dict:
    """Concatenate per-table posting dicts (empty-safe)."""
    return {k: np.concatenate([p[k] for p in per_table]) if per_table
            else np.zeros(0, _POSTING_DTYPES.get(k, np.int32))
            for k in POSTING_KEYS}


def sort_postings(parts: dict) -> dict:
    """Lexsort concatenated posting arrays by (cell_hash, table, col, row)."""
    order = np.lexsort((parts["row_id"], parts["col_id"], parts["table_id"],
                        parts["cell_hash"]))
    return {k: v[order] for k, v in parts.items()}


def bucket_offsets_for(cell_hash: np.ndarray, bucket_bits: int) -> np.ndarray:
    """Offsets of the radix buckets over the top ``bucket_bits`` hash bits."""
    nb = 1 << bucket_bits
    shift = 32 - bucket_bits
    return np.searchsorted(
        (cell_hash >> shift).astype(np.uint32),
        np.arange(nb + 1, dtype=np.uint32), side="left").astype(np.int64)


def numeric_view(parts: dict, row_stride: int):
    """(num_perm, num_rowkey) — numeric postings permuted to (table, row)
    order."""
    numeric = np.nonzero(parts["quadrant"] >= 0)[0]
    rowkey = parts["table_id"][numeric].astype(np.int64) * row_stride + \
        parts["row_id"][numeric].astype(np.int64)
    np_order = np.argsort(rowkey, kind="stable")
    return numeric[np_order].astype(np.int32), \
        rowkey[np_order].astype(np.int32)


def build_index(lake: DataLake, bucket_bits: int = 12, seed: int = 0,
                with_quadrants: bool = True,
                row_stride: int | None = None,
                sketch_config: SketchConfig | None = None) -> UnifiedIndex:
    max_cols = 1
    table_rows = np.zeros(max(lake.n_tables, 1), np.int32)
    per_table = []
    for t, table in enumerate(lake.tables):
        max_cols = max(max_cols, table.n_cols)
        table_rows[t] = table.n_rows
        per_table.append(table_postings(table, t, seed=seed,
                                        with_quadrants=with_quadrants))
    parts = sort_postings(concat_postings(per_table))

    max_rows = int(table_rows.max(initial=1))
    row_stride = max(_ceil_pow2(max_rows), row_stride or 0)
    validate_row_stride(lake.n_tables, row_stride, max_rows)

    num_perm, num_rowkey = numeric_view(parts, row_stride)
    sketch_config = sketch_config or SketchConfig()
    return UnifiedIndex(
        cell_hash=parts["cell_hash"], table_id=parts["table_id"],
        col_id=parts["col_id"], row_id=parts["row_id"],
        superkey_lo=parts["superkey_lo"], superkey_hi=parts["superkey_hi"],
        quadrant=parts["quadrant"], rank_conv=parts["rank_conv"],
        rank_rand=parts["rank_rand"],
        num_perm=num_perm, num_rowkey=num_rowkey,
        n_tables=lake.n_tables, max_cols=max_cols, bucket_bits=bucket_bits,
        bucket_offsets=bucket_offsets_for(parts["cell_hash"], bucket_bits),
        table_rows=table_rows, row_stride=row_stride,
        sketches=sketch_tables(parts, seed=seed, config=sketch_config),
        sketch_config=sketch_config)
