"""The dense LM serving path of repro_torch against the JAX package, on the
CPU, at the ``reduced`` sizes.

The parity rule: parameters are initialised in the JAX package
(``registry.init_params(cfg, PRNGKey(0))``), turned into numpy and handed
to ``repro_torch.models.registry.params_from_numpy``; tokens are drawn with
numpy from a seed.  In f32 the tolerances are the JAX package's own
(``tests/test_models.py``): 1e-5 for attention and the cache, 2e-4 for
logits, ``pos`` exactly, and greedy tokens exactly, after the JAX run's
top-1 / top-2 logit gap has been checked to exceed ten times the logits
tolerance at every step (so a mismatch is the port's, not a near tie).  In
bf16 the logits agree within ``BF16_LOGITS_ATOL``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import registry as ref_registry
from repro.serve.engine import LMEngine as RefLMEngine
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention, layers, lm, registry
from repro_torch.serve.engine import LMEngine
from repro_torch.train.step import make_prefill_step, make_serve_step

DENSE = ("smollm-360m", "yi-6b", "olmo-1b", "minitron-8b")
OTHERS = tuple(a for a in configs.ARCH_IDS if a not in DENSE)
ATTN_ATOL = 1e-5          # tests/test_models.py:106
LOGITS_ATOL = 2e-4        # tests/test_models.py:70
CACHE_ATOL = 1e-5
#: bf16, port against the JAX package on the same bf16 parameters and
#: tokens (reduced smollm-360m, prefill and 4 decode steps, prompt seeds
#: 3-5): logits differed by at most 0.0078 (one bf16 step at their
#: magnitude, about 0.5), and the bound is four such steps; keys and
#: values by at most 0.03125 (two bf16 steps at values in [2, 4), the
#: largest being 3.5; rope mixes two rounded products), and the bound is
#: twice that
BF16_LOGITS_ATOL = 0.03
BF16_CACHE_ATOL = 2 ** -4
S, B, MAX_LEN, DECODE_STEPS = 64, 2, 72, 4
SMALL = ShapeConfig("small", S, B, "train")


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch, dtype="float32"):
    cfg = ref_configs.reduced(ref_configs.get_config(arch))
    port = configs.reduced(configs.get_config(arch))
    return cfg.replace(dtype=dtype), port.replace(dtype=dtype)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The JAX package's parameters for reduced ``arch`` (numpy tree) and
    the port's tree made from them."""
    cfg, port_cfg = _cfgs(arch, dtype)
    tree = jax.tree.map(_np, ref_registry.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
    return tree, registry.params_from_numpy(tree, port_cfg, device="cpu")


def _tokens(seed, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_equals_jax(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for hint in (64, 32):
        assert dataclasses.asdict(configs.reduced(port, seq_hint=hint)) == \
            dataclasses.asdict(ref_configs.reduced(ref, seq_hint=hint))
    assert (port.head_dim, port.vocab_padded, port.d_inner) == \
        (ref.head_dim, ref.vocab_padded, ref.d_inner)


def test_shapes_equal_jax():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert configs.SUBQUADRATIC_FAMILIES == ref_configs.SUBQUADRATIC_FAMILIES
    for arch in configs.ARCH_IDS:
        for name in configs.SHAPES:
            assert configs.shape_applicable(
                configs.get_config(arch), configs.SHAPES[name]) == \
                ref_configs.shape_applicable(ref_configs.get_config(arch),
                                             ref_configs.SHAPES[name])
    with pytest.raises(KeyError):
        configs.get_config("blend-gittables")


# ------------------------------------------------------------------- layers

def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


LAYER_CASES = {
    "rmsnorm": lambda m, x, s, pos: m.rmsnorm(x, s),
    "rmsnorm_no_scale": lambda m, x, s, pos: m.rmsnorm(x, None),
    "nonparam_ln": lambda m, x, s, pos: m.nonparam_ln(x),
    "apply_rope": lambda m, x, s, pos: m.apply_rope(x, pos, 1e4),
    "swiglu": lambda m, x, s, pos: m.swiglu(x, 2.0 * x + s),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_equals_jax(name):
    x, s = _x(0, (2, 24, 4, 16)), 0.1 * _x(1, (16,))
    pos = np.tile(np.arange(3, 27, dtype=np.int32), (2, 1))
    fn = LAYER_CASES[name]
    want = fn(ref_layers, jnp.asarray(x), jnp.asarray(s), jnp.asarray(pos))
    got = fn(layers, _t(x), _t(s), _t(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATTN_ATOL,
                               rtol=0)


# ---------------------------------------------------------------- attention

# (causal, block_skip, Sq, Skv, q_offset, kv_lens)
ATTENTION_CASES = {
    "rect_causal": (True, False, 64, 64, 0, None),
    "rect_causal_offset_lens": (True, False, 32, 64, 32, (64, 40)),
    "rect_noncausal_lens": (False, False, 48, 64, 0, (17, 64)),
    "triangular": (True, True, 64, 64, 0, None),
    "triangular_offset_lens": (True, True, 64, 64, 16, (50, 64)),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_chunked_attention_equals_jax(case):
    """GQA (H=4, K=2) with 16-row chunks, both schedules."""
    causal, skip, sq, skv, off, lens = ATTENTION_CASES[case]
    q, k, v = _x(2, (2, sq, 4, 16)), _x(3, (2, skv, 2, 16)), \
        _x(4, (2, skv, 2, 16))
    kw = dict(q_chunk=16, kv_chunk=16, causal=causal, block_skip=skip,
              q_offset=off)
    want = ref_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32), **kw)
    got = attention.chunked_attention(
        _t(q), _t(k), _t(v),
        kv_lens=None if lens is None else torch.tensor(lens), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATTN_ATOL,
                               rtol=0)


def test_chunked_attention_rejects_ragged_chunks():
    q = torch.zeros(1, 40, 4, 16)
    with pytest.raises(AssertionError, match="divide"):
        attention.chunked_attention(q, q[:, :, :2], q[:, :, :2], q_chunk=16,
                                    kv_chunk=16, causal=True)


def test_attention_block_skip_equivalence():
    """Triangular (block-skip) attention == rectangular masked attention
    (tests/test_models.py:95, on the port)."""
    rng = np.random.default_rng(0)
    q = _t(rng.normal(0, 1, (2, 256, 4, 32)).astype(np.float32))
    k = _t(rng.normal(0, 1, (2, 256, 2, 32)).astype(np.float32))
    v = _t(rng.normal(0, 1, (2, 256, 2, 32)).astype(np.float32))
    a = attention.chunked_attention(q, k, v, q_chunk=64, kv_chunk=64,
                                    causal=True, block_skip=False)
    b = attention.chunked_attention(q, k, v, q_chunk=64, kv_chunk=64,
                                    causal=True, block_skip=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATTN_ATOL)


def test_attention_decode_equals_jax():
    """The per-layer compat decode path: output and the cache it wrote."""
    cfg, port_cfg = _cfgs("yi-6b")
    tree, params = _params("yi-6b")
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    port_p = lm.layer(params["layers"], 0)["attn"]
    x = _x(5, (B, cfg.d_model))
    ck, cv = _x(6, (B, 24, 2, 16)), _x(7, (B, 24, 2, 16))
    pos = np.full((B,), 9, np.int32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=cfg.rope_theta)
    want = ref_attn.attention_decode(ref_p, jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), jnp.asarray(pos), **kw)
    got = attention.attention_decode(port_p, _t(x), _t(ck.copy()),
                                     _t(cv.copy()), _t(pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=CACHE_ATOL, rtol=0)


# ------------------------------------------------------- params_from_numpy

@pytest.mark.parametrize("arch", DENSE)
def test_params_from_numpy_keys_and_shapes(arch):
    tree, params = _params(arch)
    want = {k: np.shape(v) for k, v in registry.leaves(tree).items()}
    got = {k: tuple(v.shape) for k, v in registry.leaves(params).items()}
    assert got == want
    for k, v in registry.leaves(params).items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), registry.leaves(tree)[k])
    _, port_cfg = _cfgs(arch)
    fresh = registry.init_params(port_cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    assert {k: tuple(v.shape)
            for k, v in registry.leaves(fresh).items()} == want


def _drop(tree, key):
    tree = {k: _drop(v, key) if isinstance(v, dict) else v
            for k, v in tree.items()}
    tree.pop(key, None)
    return tree


BAD_TREES = {
    "missing": lambda t: _drop(t, "w_up"),
    "extra": lambda t: {**t, "lm_head_extra": np.zeros((64, 512),
                                                       np.float32)},
    "shape": lambda t: {**t, "final_norm": np.zeros((65,), np.float32)},
}


@pytest.mark.parametrize("how", sorted(BAD_TREES))
def test_params_from_numpy_rejects_a_wrong_tree(how):
    tree, _ = _params("smollm-360m")
    _, port_cfg = _cfgs("smollm-360m")
    with pytest.raises(ValueError, match="w_up|lm_head_extra|final_norm"):
        registry.params_from_numpy(BAD_TREES[how](tree), port_cfg,
                                   device="cpu")


# ------------------------------------------------- prefill and decode parity

@functools.lru_cache(maxsize=None)
def _ref_steps(arch, dtype="float32"):
    cfg, _ = _cfgs(arch, dtype)
    prefill = jax.jit(lambda p, t: ref_lm.prefill(p, cfg, t, MAX_LEN))
    return prefill, jax.jit(ref_registry.decode_fn(cfg))


def _ref_run(arch, tokens, dtype="float32", steps=DECODE_STEPS):
    """The JAX package's prefill then ``steps`` greedy decode steps:
    [(cache, logits)] as numpy, logits in f32."""
    tree, _ = _params(arch, dtype)
    prefill, decode = _ref_steps(arch, dtype)
    p = jax.tree.map(jnp.asarray, tree)
    cache, logits = prefill(p, jnp.asarray(tokens))
    out = [(jax.tree.map(_np, cache), _np(logits.astype(jnp.float32)))]
    for _ in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        cache, logits = decode(p, cache, tok)
        out.append((jax.tree.map(_np, cache),
                    _np(logits.astype(jnp.float32))))
    return out


def _port_run(arch, tokens, want, dtype="float32"):
    """The port's prefill then one decode step per later entry of
    ``want``, each fed the JAX run's greedy token of the step before."""
    _, cfg = _cfgs(arch, dtype)
    _, params = _params(arch, dtype)
    cache, logits = lm.prefill(params, cfg, _t(tokens), MAX_LEN)
    snap = lambda c: {k: v.float().numpy().copy() if k != "pos"
                      else v.numpy().copy() for k, v in c.items()}
    out = [(snap(cache), logits.float().numpy())]
    decode = registry.decode_fn(cfg)
    for _, ref_logits in want[:-1]:
        tok = _t(np.argmax(ref_logits, -1).astype(np.int32))
        cache, logits = decode(params, cache, tok)
        out.append((snap(cache), logits.float().numpy()))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_equal_jax(arch):
    """Prefill logits and cache, then four decode steps' logits, cache and
    ``pos``, each step fed the JAX run's own greedy token."""
    tokens = _tokens(1)
    want = _ref_run(arch, tokens)
    got = _port_run(arch, tokens, want)
    for step, ((wc, wl), (gc, gl)) in enumerate(zip(want, got)):
        assert wl.shape == gl.shape == (B, 512), step
        np.testing.assert_array_equal(np.argmax(gl, -1), np.argmax(wl, -1))
        np.testing.assert_allclose(gl, wl, atol=LOGITS_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(gc[key], wc[key].astype(np.float32),
                                       atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"step {step} {key}")
        assert gc["pos"].dtype == np.int32 and gc["pos"].shape == ()
        assert int(gc["pos"]) == int(wc["pos"]) == S + step


def test_decode_equals_parallel():
    """Greedy decode logits == full-sequence forward logits on the port
    (tests/test_models.py:52, smollm-360m)."""
    s, s0 = 32, 16
    cfg = configs.reduced(configs.get_config("smollm-360m"), seq_hint=s)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, s),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    hidden, _, _ = lm.forward_hidden(params, cfg,
                                     lm.embed_tokens(params, cfg, tokens))
    full = lm.logits_fn(params, cfg, hidden)
    cache, last = lm.prefill(params, cfg, tokens[:, :s0], max_len=s)
    seq = [last]
    dec = registry.decode_fn(cfg)
    for t in range(s0, s - 1):
        cache, lg = dec(params, cache, tokens[:, t])
        seq.append(lg)
    np.testing.assert_allclose(torch.stack(seq, 1).numpy(),
                               full[:, s0 - 1:s - 1].numpy(),
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_smoke(arch):
    """tests/test_models.py:37 on the port."""
    cfg = configs.reduced(configs.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    params = registry.init_params(cfg, gen, device="cpu")
    batch = registry.make_batch(cfg, SMALL, gen, device="cpu")
    assert batch["tokens"].dtype == torch.int32
    cache, tok = make_prefill_step(cfg, max_len=S + 8)(params, batch)
    dec = make_serve_step(cfg)
    for _ in range(2):
        cache, tok, logits = dec(params, cache, tok)
    assert tok.shape == (B,) and tok.dtype == torch.int32
    assert bool(torch.isfinite(logits).all())
    assert int(cache["pos"]) == S + 2
    assert cache["k"].shape == (cfg.n_layers, B, S + 8, cfg.n_kv_heads,
                                cfg.head_dim)


GENERATE_TOKENS = 8


@pytest.mark.parametrize("arch", ("smollm-360m", "yi-6b"))
def test_generate_equals_jax(arch):
    """``LMEngine.generate`` gives the JAX package's greedy tokens exactly;
    the JAX run's logits have a clear top-1 at every step first."""
    tokens = _tokens(2)
    steps = _ref_run(arch, tokens, steps=GENERATE_TOKENS - 1)
    for i, (_, logits) in enumerate(steps):
        top2 = np.sort(logits, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert (gap > 10 * LOGITS_ATOL).all(), (i, gap)
    cfg, port_cfg = _cfgs(arch)
    tree, params = _params(arch)
    want = np.asarray(RefLMEngine(cfg, jax.tree.map(jnp.asarray, tree),
                                  MAX_LEN).generate(
        {"tokens": jnp.asarray(tokens)}, GENERATE_TOKENS))
    np.testing.assert_array_equal(
        want, np.stack([np.argmax(lg, -1) for _, lg in steps], 1))
    got = LMEngine(port_cfg, params, MAX_LEN, device="cpu").generate(
        {"tokens": tokens}, GENERATE_TOKENS)
    assert got.shape == (B, GENERATE_TOKENS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_engine_rejects_parameters_on_another_device():
    _, port_cfg = _cfgs("smollm-360m")
    _, params = _params("smollm-360m")
    with pytest.raises(ValueError, match="parameters lie on"):
        LMEngine(port_cfg, params, MAX_LEN, device="meta")


def test_bf16_logits_within_bound():
    """Reduced smollm-360m in bf16: prefill and four decode steps' logits
    within ``BF16_LOGITS_ATOL`` of the JAX package's, and the cache within
    ``BF16_CACHE_ATOL``."""
    tokens = _tokens(3)
    want = _ref_run("smollm-360m", tokens, dtype="bfloat16")
    got = _port_run("smollm-360m", tokens, want, dtype="bfloat16")
    _, params = _params("smollm-360m", "bfloat16")
    assert params["tok_embed"].dtype == torch.bfloat16
    for step, ((wc, wl), (gc, gl)) in enumerate(zip(want, got)):
        np.testing.assert_allclose(gl, wl, atol=BF16_LOGITS_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        for key in ("k", "v"):
            w = wc[key].astype(np.float32)
            np.testing.assert_allclose(gc[key], w, rtol=0,
                                       atol=BF16_CACHE_ATOL, err_msg=key)


# ------------------------------------------------------- the other families

@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_raise_naming_a8b(arch):
    cfg = configs.reduced(configs.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    calls = (lambda: registry.init_params(cfg, gen, device="cpu"),
             lambda: registry.init_cache(cfg, 2, 8, device="cpu"),
             lambda: registry.prefill_fn(cfg, 8),
             lambda: registry.decode_fn(cfg),
             lambda: registry.make_batch(cfg, SMALL, gen, device="cpu"),
             lambda: registry.params_from_numpy({}, cfg, device="cpu"),
             lambda: make_serve_step(cfg))
    for call in calls:
        with pytest.raises(NotImplementedError, match="A8b"):
            call()
