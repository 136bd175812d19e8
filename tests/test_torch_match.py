"""repro_torch's MatchEngine against the JAX package's sorted engine.

Both port backends (``sorted`` and ``bucket``) are held to the reference
``sorted`` engine on the same index arrays: ``valid``, ``pidx`` where valid,
and overflow, exactly.  The reference ``bucket`` engine does not trace on
this JAX (``pl.load``), so it is never used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import MISSING, hash_array
from repro.core.index import build_index as ref_build_index
from repro.core.lake import DataLake, Table
from repro.core.match import MatchEngine as RefEngine
from repro.core.match import sorted_member as ref_sorted_member
from repro_torch.core.index import UnifiedIndex, hash_keys
from repro_torch.core.match import MatchEngine, probe_sorted, sorted_member


def random_lake(seed, n_tables=12):
    rng = np.random.default_rng(seed)
    tables = []
    for t in range(n_tables):
        nr = int(rng.integers(4, 14))
        cols = [[f"v{int(x)}" for x in rng.integers(0, 50, nr)]
                for _ in range(int(rng.integers(1, 4)))]
        cols.append([float(x) for x in rng.normal(0, 1, nr)])
        tables.append(Table(f"t{t}", cols))
    return DataLake(tables)


def _indexes(seed, bucket_bits=12):
    ref = ref_build_index(random_lake(seed), bucket_bits=bucket_bits)
    return ref, UnifiedIndex.from_numpy(vars(ref))


@pytest.mark.parametrize("backend", ["sorted", "bucket"])
@pytest.mark.parametrize("seed,bits", [(0, 12), (1, 4), (2, 8)])
def test_probe_matches_reference_sorted(backend, seed, bits):
    ref_idx, idx = _indexes(seed, bits)
    ref = RefEngine.from_index(ref_idx, backend="sorted")
    eng = MatchEngine.from_index(idx, backend=backend, device="cpu")
    rng = np.random.default_rng(seed + 100)
    # mix of hits, misses, duplicates + masked padding
    vals = [f"v{int(x)}" for x in rng.integers(0, 60, 24)]
    h = np.concatenate([hash_array(vals), np.full(8, MISSING, np.uint32)])
    qm = np.arange(len(h)) < 24
    for m_cap in (1, 4, 64):
        p_ref, v_ref, o_ref = ref.probe(jnp.asarray(h), jnp.asarray(qm),
                                        m_cap)
        p, v, o = eng.probe(torch.from_numpy(hash_keys(h)),
                            torch.from_numpy(qm), m_cap)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(
            np.where(v.numpy(), p.numpy(), -1),
            np.where(np.asarray(v_ref), np.asarray(p_ref), -1))
        assert int(o) == int(o_ref)


@pytest.mark.parametrize("backend", ["sorted", "bucket"])
def test_rowjoin_bloom_qcr_match_reference(backend):
    ref_idx, idx = _indexes(3)
    ref = RefEngine.from_index(ref_idx, backend="sorted")
    eng = MatchEngine.from_index(idx, backend=backend, device="cpu")
    rng = np.random.default_rng(3)
    n = idx.n_postings
    rk = np.concatenate([idx.num_rowkey[rng.integers(0, len(idx.num_rowkey),
                                                      20)],
                         [-1, 10 ** 6]]).astype(np.int32)
    mask = rng.random(len(rk)) < 0.8
    n_ref, v_ref = ref.rowjoin(jnp.asarray(rk), jnp.asarray(mask), 4)
    n_got, v_got = eng.rowjoin(torch.from_numpy(rk), torch.from_numpy(mask), 4)
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(np.where(v_got.numpy(), n_got.numpy(), -1),
                                  np.where(np.asarray(v_ref),
                                           np.asarray(n_ref), -1))
    pidx = rng.integers(0, n, (6, 16))
    qk_lo = idx.superkey_lo[pidx[:, 0]] & rng.integers(0, 2 ** 32, 6,
                                                       dtype=np.uint32)
    qk_hi = idx.superkey_hi[pidx[:, 0]]
    want = np.asarray(ref.bloom(jnp.asarray(pidx), jnp.asarray(qk_lo),
                                jnp.asarray(qk_hi)))
    got = eng.bloom(torch.from_numpy(pidx), torch.from_numpy(
        qk_lo.view(np.int32)), torch.from_numpy(qk_hi.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    n_all = rng.integers(0, 9, 300).astype(np.float32)
    n_agree = np.minimum(rng.integers(0, 9, 300), n_all).astype(np.float32)
    np.testing.assert_array_equal(
        eng.qcr(torch.from_numpy(n_agree), torch.from_numpy(n_all)).numpy(),
        np.asarray(ref.qcr(jnp.asarray(n_agree), jnp.asarray(n_all))))


def test_sorted_member_matches_reference():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(-50, 50, (7, 16)), axis=1).astype(np.int32)
    keys[:, -3:] = np.iinfo(np.int32).max              # sentinel padding
    q = rng.integers(-60, 60, (7, 9)).astype(np.int32)
    want = np.asarray(ref_sorted_member(jnp.asarray(keys), jnp.asarray(q)))
    got = sorted_member(torch.from_numpy(keys), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_sorted_masks_padding_overflow():
    """Padded (masked) queries contribute no matches and no overflow."""
    _, idx = _indexes(0)
    keys = torch.from_numpy(hash_keys(idx.cell_hash))
    h = torch.full((8,), np.iinfo(np.int32).max, dtype=torch.int32)
    pidx, valid, ovf = probe_sorted(keys, h, torch.zeros(8, dtype=bool), 4)
    assert not bool(valid.any()) and int(ovf) == 0


def test_bucket_width_lossless_and_warp_padded():
    _, idx = _indexes(1)
    need = idx.max_bucket_count()
    with pytest.raises(ValueError, match="fullest bucket"):
        MatchEngine.from_index(idx, backend="bucket", bucket_width=need - 1,
                               device="cpu")
    with pytest.raises(ValueError, match="backend"):
        MatchEngine.from_index(idx, backend="btree", device="cpu")
    eng = MatchEngine.from_index(idx, backend="bucket", bucket_width=need + 1,
                                 device="cpu")
    assert eng.config.bucket_widths[0] % 32 == 0
    assert eng.config.bucket_widths[0] >= need + 1
    assert eng.bucket_hashes[0].shape == (1 << idx.bucket_bits,
                                          eng.config.bucket_widths[0])
    assert eng.bucket_hashes[0].dtype == eng.bucket_payload[0].dtype == \
        torch.int32
