"""Plain PyTorch version of the QCR scoring epilogue."""
import torch


def qcr_segments_ref(n_agree, n_all, min_support=3):
    """Epilogue over pre-reduced f32 segment sums: |2a - n| / max(n, 1),
    0 under the support floor."""
    qcr = torch.abs(2.0 * n_agree - n_all) / torch.clamp(n_all, min=1.0)
    return torch.where(n_all >= min_support, qcr, torch.zeros_like(qcr))
