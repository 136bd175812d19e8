"""The dense LM's training path of repro_torch against the JAX package, on the
CPU, at the ``reduced`` sizes in f32: ``lm_loss`` / ``chunked_ce_loss``,
remat, ``train/optim.py`` and ``train/step.py``.

The parity rule of tests/test_torch_models.py: the JAX package makes the
state (``make_train_state(cfg, PRNGKey(0))``), ``state_from_numpy``
carries it across leaf by leaf, numpy makes the tokens.  Bounds, each
beside what this file measured on the CPU:

* the loss within ``LOSS_ATOL`` 1e-5 of the JAX package's (measured
  4.8e-7 on all four dense configs);
* every gradient leaf within ``GRAD_RTOL`` 1e-5 of that leaf's largest
  magnitude (measured 1.5e-6);
* AdamW on identical numpy parameters, gradients and state: moments and
  the step equal, the factored ``vr`` / ``vc`` within 1e-10 (a mean's
  summation order; measured 3.6e-12), parameters within 1e-7 + 1e-6
  relative (measured 1.2e-7: one rounding of an f32 parameter in [1, 4));
* one whole train step: the loss as above, ``m`` (0.1 x the gradient)
  within ``GRAD_RTOL`` x 0.1 of its largest, and each parameter within the
  error that AdamW's first step forces: there ``mhat / (sqrt(vhat) + eps)``
  is ``g / (|g| + eps)``, about ``sign(g)``, so where the two gradients
  differ by their tolerance around 0 a parameter moves by up to ``2 lr``;
  the test allows ``lr x |u(g_jax) - u(g_port)|`` for each element, from
  the two packages' own gradients, plus 1e-6.

Checkpoints, the loop and the discovery-fed tiny LM are in
tests/test_torch_train_loop.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.models import registry as ref_registry
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import lm, registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     compressed_grads, tree_map)
from repro_torch.train.step import (grads_of, make_train_state,
                                    make_train_step, state_from_numpy,
                                    train_state_specs)

DENSE = ("smollm-360m", "yi-6b", "olmo-1b", "minitron-8b")
OTHERS = tuple(a for a in configs.ARCH_IDS if a not in DENSE)
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
S, B = 64, 2
KEY = jax.random.PRNGKey(0)


def _cfgs(arch, dtype="float32", **kw):
    ref = ref_configs.reduced(ref_configs.get_config(arch))
    port = configs.reduced(configs.get_config(arch))
    return ref.replace(dtype=dtype, **kw), port.replace(dtype=dtype, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_state(arch, dtype="float32"):
    cfg, _ = _cfgs(arch, dtype)
    return _np_tree(ref_step.make_train_state(cfg, KEY))


def _port_state(arch, dtype="float32"):
    _, port_cfg = _cfgs(arch, dtype)
    return state_from_numpy(_ref_state(arch, dtype), port_cfg, device="cpu")


def _tokens(seed, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _torch_dtype(a):
    """A tensor's dtype, or a numpy array's (ml_dtypes' bfloat16 included)
    in torch."""
    return a.dtype if torch.is_tensor(a) else \
        ckpt._BY_NAME[np.asarray(a).dtype.name][0]


def _f32(a):
    return a.float().numpy() if torch.is_tensor(a) else \
        np.asarray(a).astype(np.float32)


def _port_loss_and_grads(port_cfg, params, tokens):
    (loss, _), grads = grads_of(registry.loss_fn(port_cfg), params,
                                {"tokens": torch.from_numpy(tokens)})
    return float(loss), {k: g.numpy()
                         for k, g in registry.leaves(grads).items()}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch, seed):
    cfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _ref_state(arch)["params"])
    (loss, _), grads = jax.jit(jax.value_and_grad(ref_registry.loss_fn(cfg),
                                                  has_aux=True))(
        params, {"tokens": jnp.asarray(_tokens(seed))})
    return float(loss), registry.leaves(_np_tree(grads))


def _assert_grads_close(got, want, rtol=GRAD_RTOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=rtol * scale,
                                   err_msg=k)


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_jax(arch):
    want_loss, want_grads = _ref_loss_and_grads(arch, 0)
    _, port_cfg = _cfgs(arch)
    loss, grads = _port_loss_and_grads(port_cfg, _port_state(arch)["params"],
                                       _tokens(0))
    assert abs(loss - want_loss) <= LOSS_ATOL
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("arch", ("smollm-360m", "olmo-1b"))
def test_remat_on_and_off_agree(arch):
    """Checkpointed layers, attention steps and CE chunks recompute the same
    forward: remat on and off give the same loss and gradients, on both
    attention schedules."""
    tokens = _tokens(4)
    out = {}
    for remat in (True, False):
        for skip in (True, False):
            _, port_cfg = _cfgs(arch, remat=remat, causal_block_skip=skip)
            out[remat, skip] = _port_loss_and_grads(
                port_cfg, _port_state(arch)["params"], tokens)
    for skip in (True, False):
        (l_on, g_on), (l_off, g_off) = out[True, skip], out[False, skip]
        assert l_on == l_off
        for k in g_on:
            np.testing.assert_array_equal(g_on[k], g_off[k], err_msg=k)
    assert abs(out[True, True][0] - out[True, False][0]) <= LOSS_ATOL


def test_chunked_ce_loss_equals_jax_with_a_remainder():
    """A sequence that is not a multiple of the 512-token chunk: two chunks
    and a remainder, loss and gradients against the JAX package."""
    cfg, port_cfg = _cfgs("smollm-360m")
    tree = _ref_state("smollm-360m")["params"]
    rng = np.random.default_rng(6)
    hidden = rng.normal(0, 1, (1, 1100, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (1, 1100), dtype=np.int32)
    mask = (rng.random((1, 1100)) > 0.1).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda h: ref_lm.chunked_ce_loss(jax.tree.map(jnp.asarray, tree),
                                         cfg, h, jnp.asarray(labels),
                                         jnp.asarray(mask))))(
        jnp.asarray(hidden))
    params = registry.params_from_numpy(tree, port_cfg, device="cpu")
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = lm.chunked_ce_loss(params, port_cfg, h, torch.from_numpy(labels),
                             torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, [h])
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    _assert_grads_close({"h": got_g.numpy()}, {"h": np.asarray(want_g)})


def test_forward_hidden_runs_under_autograd():
    """The forward pass keeps its graph (only prefill and decode run under
    ``inference_mode``)."""
    _, port_cfg = _cfgs("smollm-360m")
    params = tree_map(lambda p: p.requires_grad_(True),
                      _port_state("smollm-360m")["params"])
    x = lm.embed_tokens(params, port_cfg, torch.from_numpy(_tokens(1)))
    hidden, aux, caches = lm.forward_hidden(params, port_cfg, x)
    assert hidden.requires_grad and aux == {} and caches is None
    hidden.sum().backward()
    assert params["layers"]["attn"]["wq"].grad.shape == \
        params["layers"]["attn"]["wq"].shape


# ---------------------------------------------------------------- optimizer

def _u(m, cfg):
    """AdamW's first-step direction from the first moment ``m`` after step
    1: ``mhat / (sqrt(vhat) + eps)`` with ``mhat = m / (1 - b1) = g`` and
    ``vhat = g^2``."""
    g = m.astype(np.float64) / (1 - cfg.b1)
    return g / (np.abs(g) + cfg.eps)


@pytest.mark.parametrize("arch,accum", [(a, 1) for a in DENSE] +
                         [("smollm-360m", 2), ("olmo-1b", 2)])
def test_train_step_equals_jax(arch, accum):
    """One whole step (``grad_accum`` 1 and 2): the loss, the first moment
    (0.1 x the gradient) and the step within the gradient bounds; each
    parameter within the error AdamW's first step forces."""
    cfg, port_cfg = _cfgs(arch, grad_accum=accum)
    tokens = _tokens(5, (4, S))
    ref_state = jax.tree.map(jnp.asarray, _ref_state(arch))
    want_state, want_m = jax.jit(ref_step.make_train_step(cfg))(
        ref_state, {"tokens": jnp.asarray(tokens)})
    state = _port_state(arch)
    got_state, got_m = make_train_step(port_cfg)(state, {"tokens": tokens})
    assert got_state["params"] is state["params"]        # updated in place
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= LOSS_ATOL
    want = registry.leaves(_np_tree(want_state))
    got = {k: _f32(v) for k, v in registry.leaves(got_state).items()}
    assert sorted(got) == sorted(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    opt = AdamWConfig()
    for key in registry.leaves(_ref_state(arch)["params"]):
        w_m, g_m = want[f"opt/m/{key}"], got[f"opt/m/{key}"]
        np.testing.assert_allclose(g_m, w_m, rtol=0, atol=GRAD_RTOL * float(
            np.abs(w_m).max()), err_msg=key)
        forced = opt.lr * np.abs(_u(w_m, opt) - _u(g_m, opt))
        err = np.abs(got[f"params/{key}"] - want[f"params/{key}"])
        assert (err <= forced + 1e-6).all(), (key, float(err.max()))


ADAMW_CASES = {
    "f32": ("float32", False, "float32"),
    "factored": ("float32", True, "float32"),
    "bf16_state": ("bfloat16", False, "float32"),
    "bf16_params_factored": ("bfloat16", True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_equals_jax(case):
    """Three AdamW steps on identical numpy parameters and gradients (a
    factored 2-D leaf, a factored stacked leaf, a vector, a small matrix
    left dense, zeros in a row)."""
    state_dtype, factored, param_dtype = ADAMW_CASES[case]
    ref_cfg = ref_optim.AdamWConfig(state_dtype=state_dtype, factored=factored)
    cfg = AdamWConfig(state_dtype=state_dtype, factored=factored)
    rng = np.random.default_rng(0)
    shapes = {"w": (256, 192), "s": (3, 128, 160), "b": (64,), "n": (2, 16)}
    p = {k: jnp.asarray(rng.normal(0, 1, s), param_dtype)
         for k, s in shapes.items()}
    pt = {k: registry.to_tensor(np.asarray(v), getattr(torch, param_dtype),
                                "cpu") for k, v in p.items()}
    ref_s, st = ref_optim.adamw_init(p, ref_cfg), adamw_init(pt, cfg)
    for _ in range(3):
        g = {k: rng.normal(0, 1e-2, s).astype(np.float32)
             for k, s in shapes.items()}
        g["w"][0, :5] = 0.0
        p, ref_s = ref_optim.adamw_update(      # eager: no fused FMAs
            p, {k: jnp.asarray(v) for k, v in g.items()}, ref_s, ref_cfg)
        pt, st = adamw_update(pt, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, st, cfg)
    want = registry.leaves(_np_tree({"p": p, **ref_s}))
    got = registry.leaves({"p": pt, **st})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == _torch_dtype(w), k
        g, w = _f32(got[k]), w.astype(np.float32)
        if k.startswith("p/"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
        elif k.endswith(("/vr", "/vc")):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert int(st["step"]) == 3 and st["step"].dtype == torch.int32


def test_factored_optimizer_matches_adam_direction():
    """tests/test_train.py:84: the factored second moment approximates
    dense Adam on a rank-1 g^2."""
    p = {"w": torch.ones((256, 256)) * 0.5}
    g = {"w": torch.full((256, 256), 0.1)}
    dense_cfg = AdamWConfig(factored=False, weight_decay=0.0)
    fact_cfg = AdamWConfig(factored=True, weight_decay=0.0)
    pd, _ = adamw_update({"w": p["w"].clone()}, g,
                         adamw_init(p, dense_cfg), dense_cfg)
    pf, sf = adamw_update({"w": p["w"].clone()}, g,
                          adamw_init(p, fact_cfg), fact_cfg)
    assert set(sf["v"]["w"]) == {"vr", "vc"}
    np.testing.assert_allclose(pd["w"].numpy(), pf["w"].numpy(), rtol=1e-4)


def test_int8_compression_error_feedback():
    """tests/test_train.py:98: error feedback makes the accumulated
    compressed gradient converge to the true gradient sum; every round
    equals the JAX package's exactly."""
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (64, 64)).astype(np.float32)
    res, ref_res = {"w": torch.zeros((64, 64))}, {"w": jnp.zeros((64, 64))}
    total = torch.zeros((64, 64))
    for _ in range(20):
        deq, res = compressed_grads({"w": torch.from_numpy(g)}, res)
        ref_deq, ref_res = ref_optim.compressed_grads({"w": jnp.asarray(g)},
                                                      ref_res)
        np.testing.assert_array_equal(deq["w"].numpy(),
                                      np.asarray(ref_deq["w"]))
        np.testing.assert_array_equal(res["w"].numpy(),
                                      np.asarray(ref_res["w"]))
        total = total + deq["w"]
    err = float(torch.max(torch.abs(total + res["w"] - 20 * torch.from_numpy(g))))
    assert err < 1e-3


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("arch", DENSE)
def test_train_step_smoke(arch):
    """tests/test_models.py:23 on the port: parameters from a torch
    generator, a random batch, one step."""
    cfg = configs.reduced(configs.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    state = make_train_state(cfg, gen, device="cpu")
    batch = registry.make_batch(cfg, ShapeConfig("small", S, B, "train"), gen,
                                device="cpu")
    before = state["params"]["tok_embed"].clone()
    state2, metrics = make_train_step(cfg)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and 0 < loss < 20
    l0 = state2["params"]["tok_embed"]
    assert bool(torch.isfinite(l0).all()) and not torch.equal(l0, before)
    assert int(state2["opt"]["step"]) == 1


def test_grad_accum_equivalence():
    """tests/test_models.py:124 on the port: accum=2 gives (numerically)
    the same update as accum=1."""
    cfg = configs.reduced(configs.get_config("smollm-360m")).replace(
        remat=False)
    gen = torch.Generator().manual_seed(0)
    batch = registry.make_batch(cfg, ShapeConfig("s", 32, 4, "train"), gen,
                                device="cpu")
    s1 = make_train_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    s2 = tree_map(torch.clone, s1)
    st1, m1 = make_train_step(cfg)(s1, batch)
    st2, m2 = make_train_step(cfg.replace(grad_accum=2))(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    # the JAX test's last parameter leaf in its (sorted) order
    a = list(ckpt._flatten(st1["params"]).values())[-1]
    b = list(ckpt._flatten(st2["params"]).values())[-1]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_raise_naming_a8b(arch):
    cfg = configs.reduced(configs.get_config(arch))
    calls = (lambda: registry.loss_fn(cfg),
             lambda: make_train_step(cfg),
             lambda: make_train_state(cfg, torch.Generator(), device="cpu"),
             lambda: state_from_numpy({}, cfg, device="cpu"))
    for call in calls:
        with pytest.raises(NotImplementedError, match="A8b"):
            call()


@pytest.mark.parametrize("arch", DENSE)
def test_train_state_specs_equal_jax(arch):
    """Full-size state shapes and dtypes, allocated nowhere (``meta``),
    against the JAX package's ``jax.eval_shape``."""
    want = registry.leaves(ref_step.train_state_specs(
        ref_configs.get_config(arch)))
    got = registry.leaves(train_state_specs(configs.get_config(arch)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == ckpt._BY_NAME[str(w.dtype)][0], k


def test_state_from_numpy_rejects_a_wrong_tree():
    _, port_cfg = _cfgs("smollm-360m")
    tree = _ref_state("smollm-360m")
    bad = {"params": tree["params"], "opt": {"m": tree["opt"]["m"],
                                             "step": tree["opt"]["step"]}}
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy(bad, port_cfg, device="cpu")
    extra = {**tree, "ema": tree["params"]}
    with pytest.raises(ValueError, match="extra"):
        state_from_numpy(extra, port_cfg, device="cpu")
    shaped = {"params": {**tree["params"], "final_norm": np.zeros(3,
                                                                   np.float32)},
              "opt": tree["opt"]}
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(shaped, port_cfg, device="cpu")
    factored = ref_step.make_train_state(
        _cfgs("smollm-360m")[0].replace(d_model=256, n_heads=4),
        KEY, ref_optim.AdamWConfig(factored=True))
    with pytest.raises(ValueError, match="vr"):
        state_from_numpy(_np_tree(factored), port_cfg.replace(
            d_model=256, n_heads=4), device="cpu")
