"""repro_torch's unified index against the JAX package's, array for array."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.index import build_index as ref_build_index
from repro.core.lake import synthetic_lake
from repro_torch.core import hashing
from repro_torch.core.index import (UnifiedIndex, build_index, hash_keys,
                                    resolve_device)
from repro_torch.core.lake import synthetic_lake as port_synthetic_lake

ARRAYS = ("cell_hash", "table_id", "col_id", "row_id", "superkey_lo",
          "superkey_hi", "quadrant", "rank_conv", "rank_rand", "num_perm",
          "num_rowkey", "bucket_offsets", "table_rows")
SCALARS = ("n_tables", "max_cols", "bucket_bits", "row_stride")


def _lake(seed):
    return synthetic_lake(n_tables=24, rows=20, cols=4, vocab=150, seed=seed,
                          numeric_cols=1 + seed % 2)


def _assert_same_index(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


def _assert_same_sketches(a, b):
    """The two indexes' sketch tiers agree field for field: config, table
    ids, and every array and count of every ``TableSketch``."""
    assert a.sketch_config.as_dict() == b.sketch_config.as_dict()
    assert set(a.sketches) == set(b.sketches)
    for t, want in b.sketches.items():
        got = a.sketches[t]
        for f in dataclasses.fields(got):
            x, y = getattr(got, f.name), getattr(want, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, (t, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f"{t} {f.name}")
            else:
                assert x == y, (t, f.name)


@pytest.mark.parametrize("seed,bits", [(0, 12), (1, 6), (2, 9)])
def test_build_index_matches_reference(seed, bits):
    lake = _lake(seed)
    ref = ref_build_index(lake, bucket_bits=bits)
    port = build_index(lake, bucket_bits=bits)
    _assert_same_index(port, ref)
    assert len(port.sketches) == lake.n_tables
    _assert_same_sketches(port, ref)
    for width in (port.max_bucket_count(), 7):
        for got, want in zip(port.padded_buckets(width),
                             ref.padded_buckets(width)):
            np.testing.assert_array_equal(got, want)
    q = np.concatenate([ref.cell_hash[::5], [hashing.MISSING, 0]])
    np.testing.assert_array_equal(port.host_counts(q), ref.host_counts(q))


def test_lake_copy_matches_reference():
    a = port_synthetic_lake(n_tables=5, rows=10, seed=3)
    b = synthetic_lake(n_tables=5, rows=10, seed=3)
    assert [t.columns for t in a.tables] == [t.columns for t in b.tables]


def test_from_numpy_round_trip():
    from repro.core.sketch import SketchConfig as RefConfig
    from repro_torch.core.sketch import SketchConfig, TableSketch
    ref = ref_build_index(_lake(3), sketch_config=RefConfig(k=16,
                                                            samples=8))
    port = UnifiedIndex.from_numpy(vars(ref))
    _assert_same_index(port, ref)
    _assert_same_sketches(port, ref)
    assert port.cell_hash is not ref.cell_hash      # arrays are copied
    # the sketch tier holds the port's own objects, arrays copied
    assert type(port.sketch_config) is SketchConfig
    assert port.sketch_config == SketchConfig(k=16, samples=8)
    assert all(type(s) is TableSketch for s in port.sketches.values())
    assert port.sketches[0].kmv is not ref.sketches[0].kmv
    back = UnifiedIndex.from_numpy(vars(port))
    _assert_same_index(back, port)
    _assert_same_sketches(back, port)
    bare = UnifiedIndex.from_numpy({k: v for k, v in vars(ref).items()
                                    if not k.startswith("sketch")})
    assert bare.sketches == {} and bare.sketch_config == SketchConfig()
    with pytest.raises(KeyError, match="num_perm"):
        UnifiedIndex.from_numpy({k: v for k, v in vars(ref).items()
                                 if k != "num_perm"})


def test_device_arrays_int32_forms():
    idx = build_index(_lake(4))
    dev = idx.device_arrays("cpu")
    assert len(dev) == 15
    assert all(t.device.type == "cpu" for t in dev.values())
    h = dev["hash"].numpy()
    assert h.dtype == np.int32
    # order-preserving: the u32 sort order survives the signed form
    assert np.all(np.diff(h.astype(np.int64)) >= 0)
    np.testing.assert_array_equal(
        (h.view(np.uint32) ^ np.uint32(0x80000000)), idx.cell_hash)
    np.testing.assert_array_equal(dev["sk_lo"].numpy().view(np.uint32),
                                  idx.superkey_lo)
    np.testing.assert_array_equal(dev["sk_hi"].numpy().view(np.uint32),
                                  idx.superkey_hi)
    np.testing.assert_array_equal(dev["num_table"].numpy(),
                                  idx.table_id[idx.num_perm])
    np.testing.assert_array_equal(dev["num_rank_rand"].numpy(),
                                  idx.rank_rand[idx.num_perm])


def test_hash_keys_order_and_sentinel():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.integers(0, 2 ** 32, 500, dtype=np.uint32),
                        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                                 np.uint32)])
    k = hash_keys(u)
    np.testing.assert_array_equal(np.argsort(u, kind="stable"),
                                  np.argsort(k, kind="stable"))
    assert hash_keys(np.array([hashing.MISSING]))[0] == np.iinfo(np.int32).max
    # the bucket row of a key is the top bits of its u32 hash
    rows = (torch.from_numpy(k).to(torch.int64) + (1 << 31)) >> (32 - 7)
    np.testing.assert_array_equal(rows.numpy(), u >> 25)


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_index_fields_cover_reference():
    """Every field of the JAX index has a counterpart."""
    from repro.core.index import UnifiedIndex as RefIndex
    ref = {f.name for f in dataclasses.fields(RefIndex)}
    port = {f.name for f in dataclasses.fields(UnifiedIndex)}
    assert ref - port == set()
