"""QCR-score wrappers: the CUDA kernels for CUDA tensors, the plain versions
for CPU tensors.  ``score.launches`` and ``score_segments.launches`` count
kernel launches."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qcr_score.ref import qcr_score_ref, qcr_segments_ref


def score(quadrants, qbits, valid):
    """Grouped QCR: quadrants/qbits int8 [G, H], valid bool [G, H] -> f32
    [G] (``csrc/qcr_score.cu``)."""
    name = "qcr_score"
    dev = _build.device_of(name, quadrants, qbits, valid)
    need = _build.require
    need(name, quadrants.dtype == qbits.dtype == torch.int8,
         "int8 quadrants and qbits")
    need(name, valid.dtype == torch.bool, "bool valid")
    need(name, quadrants.dim() == 2
         and quadrants.shape == qbits.shape == valid.shape,
         "quadrants/qbits/valid must be one [G, H] shape")
    if dev.type == "cpu":
        return qcr_score_ref(quadrants, qbits, valid)
    need(name, all(t.is_contiguous() for t in (quadrants, qbits, valid)),
         "contiguous inputs")
    g, h = quadrants.shape
    out = torch.empty(g, dtype=torch.float32, device=dev)
    _build.launch(name, dev, quadrants.data_ptr(), qbits.data_ptr(),
                  valid.data_ptr(), out.data_ptr(), g, h)
    score.launches += 1
    return out


def score_segments(n_agree, n_all, *, min_support=3):
    """QCR epilogue over per-(table, join_col, num_col) f32 segment sums
    [D] -> f32 [D] (``csrc/qcr_segments.cu``)."""
    name = "qcr_segments"
    dev = _build.device_of(name, n_agree, n_all)
    need = _build.require
    need(name, n_agree.dtype == n_all.dtype == torch.float32, "f32 inputs")
    need(name, n_agree.dim() == 1 and n_agree.shape == n_all.shape,
         "n_agree/n_all must be one [D] shape")
    if dev.type == "cpu":
        return qcr_segments_ref(n_agree, n_all, min_support)
    need(name, n_agree.is_contiguous() and n_all.is_contiguous(),
         "contiguous inputs")
    out = torch.empty_like(n_all)
    _build.launch(name, dev, n_agree.data_ptr(), n_all.data_ptr(),
                  out.data_ptr(), n_all.shape[0], float(min_support))
    score_segments.launches += 1
    return out


score_segments.launches = 0
score.launches = 0
