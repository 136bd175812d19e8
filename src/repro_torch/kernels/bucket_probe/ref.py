"""Plain PyTorch version of the bucket probe (the CPU path and the check the
CUDA kernel is held against)."""
import torch


def bucket_probe_ref(bucket_hashes, bucket_payload, queries, bucket_bits):
    """bucket_hashes/payload: int32 [NB, W] (keys in the port's int32 form);
    queries: int32 [M] keys.  Returns payload where hash matches else -1:
    int32 [M, W].  The bucket row is the top ``bucket_bits`` bits of the
    original u32 hash, ``(key + 2^31) >> (32 - bits)``."""
    rows = (queries.to(torch.int64) + (1 << 31)) >> (32 - bucket_bits)
    bp = bucket_payload[rows]
    hit = bucket_hashes[rows] == queries[:, None]
    return torch.where(hit, bp, torch.full_like(bp, -1))
