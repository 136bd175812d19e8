"""Bucket-probe wrapper: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  ``probe.launches`` counts kernel launches."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_probe.ref import bucket_probe_ref


def probe(bucket_hashes, bucket_payload, queries, bucket_bits):
    """bucket_hashes/payload int32 [2^bucket_bits, W], queries int32 [M] ->
    int32 [M, W]: the payload where the bucket hash equals the query key,
    else -1 (``csrc/bucket_probe.cu``)."""
    name = "bucket_probe"
    dev = _build.device_of(name, bucket_hashes, bucket_payload, queries)
    need = _build.require
    need(name, all(t.dtype == torch.int32 for t in
                   (bucket_hashes, bucket_payload, queries)), "int32 inputs")
    need(name, 1 <= bucket_bits <= 31, f"bucket_bits={bucket_bits}")
    need(name, bucket_hashes.dim() == 2
         and bucket_hashes.shape == bucket_payload.shape
         and bucket_hashes.shape[0] == 1 << bucket_bits,
         "bucket tables must both be [2^bucket_bits, W]")
    need(name, queries.dim() == 1, "queries must be 1-D")
    if dev.type == "cpu":
        return bucket_probe_ref(bucket_hashes, bucket_payload, queries,
                                bucket_bits)
    need(name, all(t.is_contiguous() for t in
                   (bucket_hashes, bucket_payload, queries)),
         "contiguous inputs")
    m, width = queries.shape[0], bucket_hashes.shape[1]
    out = torch.empty((m, width), dtype=torch.int32, device=dev)
    _build.launch(name, dev, bucket_hashes.data_ptr(),
                  bucket_payload.data_ptr(), queries.data_ptr(),
                  out.data_ptr(), m, width, bucket_bits)
    probe.launches += 1
    return out


probe.launches = 0
