"""The training loop's half of the dense LM's training path on repro_torch
(``train/checkpoint.py``, ``launch/train.py``, and the discovery-fed path of
examples/train_tiny_lm.py) against the JAX package, on the CPU.

Checkpoints are byte for byte: a state the JAX package saved restores in
the port bit for bit (f32 and bf16, factored or not) and the other way
round, the two packages write the same manifest and leaf files for the
same state, and ``checkpoint.packb`` / ``unpackb`` equal ``msgpack``'s.
tests/test_train.py's round trip, GC, restart replay (exact on the CPU)
and straggler cases run on the port, and SIGTERM saves and stops.  The
tiny LM runs in both packages from one initial state that the JAX package
writes as step 0.
"""
import functools
import os
import signal
import time

import msgpack
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.executor import Executor as RefExecutor
from repro.core.index import build_index as ref_build_index
from repro.core.lake import synthetic_lake as ref_synthetic_lake
from repro.core.plan import Combiners as RefCombiners, Plan as RefPlan, \
    Seekers as RefSeekers
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro.train import checkpoint as ref_ckpt
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.core.executor import Executor
from repro_torch.core.index import build_index
from repro_torch.core.lake import synthetic_lake
from repro_torch.core.plan import Combiners, Plan, Seekers
from repro_torch.data import pipeline
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import TrainLoopConfig, train_loop
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import make_train_state

from test_torch_train import LOSS_ATOL, KEY, _np_tree, _torch_dtype


# -------------------------------------------------------------- checkpoints

def _tiny_cfgs(dtype="float32"):
    kw = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
              vocab=128, dtype=dtype)
    return (ref_configs.reduced(ref_configs.get_config("smollm-360m"))
            .replace(**kw),
            configs.reduced(configs.get_config("smollm-360m")).replace(**kw))


def _same_state(got, want):
    got, want = registry.leaves(got), registry.leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert _torch_dtype(g) == _torch_dtype(w), k
        gb = ckpt._to_numpy(g)[1] if torch.is_tensor(g) else np.asarray(g)
        wb = ckpt._to_numpy(w)[1] if torch.is_tensor(w) else np.asarray(w)
        assert gb.tobytes() == wb.tobytes() and gb.shape == wb.shape, k


def test_checkpoint_roundtrip(tmp_path):
    _, cfg = _tiny_cfgs()
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ckpt.save(state, tmp_path, step=7)
    restored, step = ckpt.restore(state, tmp_path, device="cpu")
    assert step == 7
    _same_state(restored, state)


def test_checkpoint_gc_keeps_latest(tmp_path):
    _, cfg = _tiny_cfgs()
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(state, tmp_path, step=s, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert dirs == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, tmp_path / "absent", device="cpu")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("factored", (False, True))
def test_checkpoints_cross_packages(tmp_path, dtype, factored):
    """A state the JAX package saved restores in the port bit for bit, the
    port's save of that state restores in the JAX package bit for bit, and
    the two saves are the same bytes, manifest and leaf files."""
    ref_cfg, cfg = _tiny_cfgs(dtype)
    ref_cfg, cfg = ref_cfg.replace(d_model=128), cfg.replace(d_model=128)
    opt = ref_optim.AdamWConfig(factored=factored)
    ref_state = ref_step.make_train_state(ref_cfg, KEY, opt)
    ref_ckpt.save(ref_state, tmp_path / "jax", step=3)
    template = make_train_state(cfg, torch.Generator().manual_seed(1),
                                AdamWConfig(factored=factored), device="cpu")
    got, step = ckpt.restore(template, tmp_path / "jax", device="cpu")
    assert step == 3
    _same_state(got, _np_tree(ref_state))
    ckpt.save(got, tmp_path / "port", step=3)
    back, step = ref_ckpt.restore(ref_state, tmp_path / "port")
    assert step == 3
    _same_state(_np_tree(back), _np_tree(ref_state))
    a, b = tmp_path / "jax" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


MANIFEST_CASES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, True, False, None, "", "a" * 31, "a" * 32, "é" * 200,
    "b" * 255, "b" * 256, "c" * 65536, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, {"x": i}] for i in range(16)},
    {str(i): i for i in range(70000)},
    {"step": 12, "leaves": {"params/tok_embed": {
        "shape": [49152, 960], "dtype": "bfloat16",
        "file": "params__tok_embed.bin"}, "opt/step": {
        "shape": [], "dtype": "int32", "file": "opt__step.bin"}}},
]


@pytest.mark.parametrize("case", range(len(MANIFEST_CASES)))
def test_manifest_codec_equals_msgpack(case):
    obj = MANIFEST_CASES[case]
    data = msgpack.packb(obj)
    assert ckpt.packb(obj) == data
    assert ckpt.unpackb(data) == msgpack.unpackb(data) == obj


def test_manifest_codec_rejects_what_it_cannot_read():
    with pytest.raises(TypeError):
        ckpt.packb(1.5)
    with pytest.raises(ValueError, match="unsupported"):
        ckpt.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")


# --------------------------------------------------------------- the loop

def _stream(cfg, seed=3, batch=4, seq_len=32):
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, 4096,
                                               dtype=np.int32)
    return TokenStream(tokens, batch=batch, seq_len=seq_len, seed=seed)


def test_restart_replays_same_data(tmp_path):
    """tests/test_train.py:43: a crashed-and-restarted run produces the
    same loss sequence as an uninterrupted run, exactly on the CPU."""
    _, cfg = _tiny_cfgs()
    run = lambda steps, d: train_loop(  # noqa: E731
        cfg, _stream(cfg), TrainLoopConfig(steps=steps, ckpt_every=4,
                                           ckpt_dir=str(tmp_path / d)),
        device="cpu")
    full = run(8, "a")
    part1 = run(4, "b")
    part2 = run(8, "b")
    assert full.resumed_from is None and part1.resumed_from is None
    assert part2.resumed_from == 4 and part2.final_step == 8
    assert full.losses[:4] == part1.losses
    assert full.losses[4:] == part2.losses


def test_straggler_watchdog(tmp_path):
    """tests/test_train.py:116 on the port."""
    _, cfg = _tiny_cfgs()
    stream = TokenStream(np.zeros(4096, np.int32), batch=2, seq_len=16,
                         seed=0)
    events = []
    slow = {"step": 10}

    class SlowStream:
        def batch_at(self, step):
            if step == slow["step"]:
                time.sleep(4.0)     # far above any plausible median, even
                                    # under CI CPU contention
            return stream.batch_at(step)

    rep = train_loop(cfg, SlowStream(),
                     TrainLoopConfig(steps=12, ckpt_every=100,
                                     ckpt_dir=str(tmp_path / "ckpt"),
                                     straggler_factor=3.0),
                     straggler_cb=lambda s, dt, med: events.append(s),
                     device="cpu")
    assert slow["step"] in rep.straggler_steps
    assert events == rep.straggler_steps


def test_sigterm_saves_a_checkpoint_and_stops(tmp_path):
    """Preemption: a SIGTERM during step 2 saves a checkpoint of 3 steps
    and ends the loop; the old handler is back afterwards."""
    _, cfg = _tiny_cfgs()

    def hook(step, state, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    rep = train_loop(cfg, _stream(cfg), TrainLoopConfig(
        steps=10, ckpt_every=100, ckpt_dir=str(tmp_path)), hooks=(hook,),
        device="cpu")
    assert len(rep.losses) == 3 and rep.final_step == 2
    assert ckpt.latest_step(tmp_path) == 3
    assert signal.getsignal(signal.SIGTERM) == before


def test_train_loop_hooks_see_the_state_in_place(tmp_path):
    _, cfg = _tiny_cfgs()
    seen = []
    train_loop(cfg, _stream(cfg), TrainLoopConfig(
        steps=3, ckpt_every=100, ckpt_dir=str(tmp_path)),
        hooks=(lambda s, state, m: seen.append(
            (s, int(state["opt"]["step"]), id(state["params"]))),),
        device="cpu")
    assert [(s, n) for s, n, _ in seen] == [(0, 1), (1, 2), (2, 3)]
    assert len({i for _, _, i in seen}) == 1


def _tiny_lm(ns, ckpt_dir, steps):
    """examples/train_tiny_lm.py with ``steps`` steps, on package ``ns``."""
    lake = ns["lake"](n_tables=120, rows=40, vocab=2000, seed=5)
    ex = ns["executor"](ns["build_index"](lake))
    seed_table = lake.tables[11]
    plan = ns["Plan"]()
    for c in range(2):
        plan.add(f"c{c}", ns["Seekers"].SC(list(seed_table.columns[c]), k=60))
    plan.add("out", ns["Combiners"].Counter(k=30), ["c0", "c1"])
    tables = ns["pipeline"].select_tables(lake, plan, ex)
    cfg = ns["cfg"]
    tokens = ns["pipeline"].tokenize_tables(tables, vocab=cfg.vocab)
    stream = ns["pipeline"].TokenStream(tokens, batch=8, seq_len=64, seed=0)
    report = ns["train_loop"](cfg, stream, ns["loop_cfg"](
        steps=steps, ckpt_every=50, ckpt_dir=str(ckpt_dir)))
    return len(tables), tokens, report


#: the tiny LM's losses after the first, port against JAX: 8 steps of
#: AdamW; measured 2.4e-6 at most
TINY_LM_ATOL = 2e-5


def test_train_tiny_lm_equals_jax(tmp_path):
    """The discovery-fed training path of examples/train_tiny_lm.py, 8
    steps in each package from the same initial state (the JAX package
    writes it as step 0, and both loops resume from it): the selected
    tables and tokens equal, the first loss within ``LOSS_ATOL``, the rest
    within ``TINY_LM_ATOL``."""
    kw = dict(n_layers=4, d_model=128, d_ff=512, vocab=2048)
    ref_cfg = ref_configs.reduced(ref_configs.get_config("smollm-360m")) \
        .replace(**kw)
    cfg = configs.reduced(configs.get_config("smollm-360m")).replace(**kw)
    init = ref_step.make_train_state(ref_cfg, KEY)
    for d in ("jax", "port"):
        ref_ckpt.save(init, tmp_path / d, step=0)
    ref = dict(lake=ref_synthetic_lake, build_index=ref_build_index,
               executor=RefExecutor, Plan=RefPlan, Seekers=RefSeekers,
               Combiners=RefCombiners, pipeline=ref_pipeline, cfg=ref_cfg,
               train_loop=ref_train.train_loop,
               loop_cfg=ref_train.TrainLoopConfig)
    port = dict(lake=synthetic_lake, build_index=build_index,
                executor=lambda idx: Executor(idx, device="cpu"), Plan=Plan,
                Seekers=Seekers, Combiners=Combiners, pipeline=pipeline,
                cfg=cfg, loop_cfg=TrainLoopConfig,
                train_loop=functools.partial(train_loop, device="cpu"))
    n_ref, tok_ref, want = _tiny_lm(ref, tmp_path / "jax", 8)
    n, tokens, got = _tiny_lm(port, tmp_path / "port", 8)
    assert n == n_ref > 0
    np.testing.assert_array_equal(tokens, tok_ref)
    assert got.resumed_from == want.resumed_from == 0
    assert len(got.losses) == len(want.losses) == 8
    assert abs(got.losses[0] - want.losses[0]) <= LOSS_ATOL
    np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                               atol=TINY_LM_ATOL)
    assert got.losses[-1] < got.losses[0]
