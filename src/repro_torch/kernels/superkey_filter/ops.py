"""Superkey-filter wrappers: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors.  ``filter_candidates.launches`` and
``filter_rows.launches`` count kernel launches."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.superkey_filter.ref import (superkey_filter_ref,
                                                     superkey_filter_rows_ref)


def filter_rows(sk_lo, sk_hi, q_lo, q_hi):
    """All-pairs bloom containment: sk_lo/hi int32 [N] row digests, q_lo/hi
    int32 [T] query digests -> bool [T, N] (``csrc/superkey_filter.cu``)."""
    name = "superkey_filter"
    dev = _build.device_of(name, sk_lo, sk_hi, q_lo, q_hi)
    need = _build.require
    need(name, all(t.dtype == torch.int32 for t in (sk_lo, sk_hi, q_lo, q_hi)),
         "int32 inputs")
    need(name, sk_lo.dim() == 1 and sk_lo.shape == sk_hi.shape,
         "sk_lo/sk_hi must be one [N] shape")
    need(name, q_lo.dim() == 1 and q_lo.shape == q_hi.shape,
         "q_lo/q_hi must be one [T] shape")
    if dev.type == "cpu":
        return superkey_filter_ref(sk_lo, sk_hi, q_lo, q_hi)
    need(name, all(t.is_contiguous() for t in (sk_lo, sk_hi, q_lo, q_hi)),
         "contiguous inputs")
    t, n = q_lo.shape[0], sk_lo.shape[0]
    out = torch.empty((t, n), dtype=torch.bool, device=dev)
    _build.launch(name, dev, sk_lo.data_ptr(), sk_hi.data_ptr(),
                  q_lo.data_ptr(), q_hi.data_ptr(), out.data_ptr(), t, n)
    filter_rows.launches += 1
    return out


def filter_candidates(sk_lo, sk_hi, q_lo, q_hi):
    """Rowwise bloom prune: sk_lo/hi int32 [T, M] gathered candidate
    digests, q_lo/hi int32 [T] per-row query digests -> bool [T, M]
    containment mask (``csrc/superkey_filter_rows.cu``)."""
    name = "superkey_filter_rows"
    dev = _build.device_of(name, sk_lo, sk_hi, q_lo, q_hi)
    need = _build.require
    need(name, all(t.dtype == torch.int32 for t in (sk_lo, sk_hi, q_lo, q_hi)),
         "int32 inputs")
    need(name, sk_lo.dim() == 2 and sk_lo.shape == sk_hi.shape,
         "sk_lo/sk_hi must be one [T, M] shape")
    need(name, q_lo.shape == q_hi.shape == sk_lo.shape[:1],
         "q_lo/q_hi must be [T]")
    if dev.type == "cpu":
        return superkey_filter_rows_ref(sk_lo, sk_hi, q_lo, q_hi)
    need(name, all(t.is_contiguous() for t in (sk_lo, sk_hi, q_lo, q_hi)),
         "contiguous inputs")
    t, m = sk_lo.shape
    out = torch.empty((t, m), dtype=torch.bool, device=dev)
    _build.launch(name, dev, sk_lo.data_ptr(), sk_hi.data_ptr(),
                  q_lo.data_ptr(), q_hi.data_ptr(), out.data_ptr(), t, m)
    filter_candidates.launches += 1
    return out


filter_candidates.launches = 0
filter_rows.launches = 0
