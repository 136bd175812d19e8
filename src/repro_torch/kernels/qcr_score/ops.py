"""QCR-score wrapper: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  ``score_segments.launches`` counts kernel launches."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qcr_score.ref import qcr_segments_ref


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
