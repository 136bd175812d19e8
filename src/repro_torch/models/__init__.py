"""The LM stack's models: the dense family's layers, chunked attention and
decoder (``models/lm.py``, serving and training) behind the registry's
uniform API."""
from repro_torch.models.registry import (  # noqa: F401
    decode_fn,
    init_cache,
    init_params,
    is_encdec,
    loss_fn,
    make_batch,
    params_from_numpy,
    prefill_fn,
)
