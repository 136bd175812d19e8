"""Plain PyTorch versions of grouped QCR scoring and its epilogue."""
import torch


def qcr_score_ref(quadrants, qbits, valid):
    """quadrants/qbits int8 [G, H], valid bool [G, H] -> f32 [G]: per group
    |2 a - n| / max(n, 1) over the valid entries (a of them agree), 0 where
    n < 3."""
    v = valid.to(torch.float32)
    agree = ((quadrants == qbits) & valid).to(torch.float32)
    n = v.sum(dim=1)
    a = agree.sum(dim=1)
    qcr = torch.abs(2.0 * a - n) / torch.clamp(n, min=1.0)
    return torch.where(n >= 3, qcr, torch.zeros_like(qcr))


def qcr_segments_ref(n_agree, n_all, min_support=3):
    """Epilogue over pre-reduced f32 segment sums: |2a - n| / max(n, 1),
    0 under the support floor."""
    qcr = torch.abs(2.0 * n_agree - n_all) / torch.clamp(n_all, min=1.0)
    return torch.where(n_all >= min_support, qcr, torch.zeros_like(qcr))
