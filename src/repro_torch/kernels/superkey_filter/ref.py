"""Plain PyTorch versions of the XASH superkey bloom filters."""


def superkey_filter_ref(sk_lo, sk_hi, q_lo, q_hi):
    """sk_lo/hi int32 [N] row digests (u32 bit-views) vs q_lo/hi int32 [T]
    query digests.  Returns bool [T, N]: (row & q) == q on both halves."""
    lo_ok = (sk_lo[None, :] & q_lo[:, None]) == q_lo[:, None]
    hi_ok = (sk_hi[None, :] & q_hi[:, None]) == q_hi[:, None]
    return lo_ok & hi_ok


def superkey_filter_rows_ref(sk_lo, sk_hi, q_lo, q_hi):
    """sk_lo/hi int32 [T, M] candidate digests (u32 bit-views) vs q_lo/hi
    int32 [T] per-row query digests.  Returns bool [T, M]:
    (row & q) == q on both halves."""
    lo_ok = (sk_lo & q_lo[:, None]) == q_lo[:, None]
    hi_ok = (sk_hi & q_hi[:, None]) == q_hi[:, None]
    return lo_ok & hi_ok
