"""The slice end to end: repro_torch against tests/oracle.py and the JAX
package's ``sorted`` Executor, exactly — seekers, combiners, optimizer, and
the Session (``query`` / ``sql`` / ``explain``), on both port backends.

The index arrays are handed to both systems (``UnifiedIndex.from_numpy``).
The reference ``bucket`` engine does not trace on this JAX, so the reference
side always runs ``backend="sorted"``.
"""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import blend as ref_blend
import repro_torch as blend
from repro.core.executor import Executor as RefExecutor
from repro.core.index import build_index as ref_build_index
from repro.core.lake import synthetic_lake
from repro_torch.core.executor import Executor
from repro_torch.core.index import UnifiedIndex, build_index
from repro_torch.core.plan import Combiners, Plan, Seekers

from oracle import oracle_ids, oracle_run, oracle_seeker, oracle_topk
from test_oracle import conformance_lake, conformance_plan, random_specs

BACKENDS = ("sorted", "bucket")


@functools.lru_cache(maxsize=None)
def _ref(seed):
    lake = conformance_lake(seed)
    return lake, RefExecutor(ref_build_index(lake))


def _port(seed, backend):
    lake, ref = _ref(seed)
    return Executor(UnifiedIndex.from_numpy(vars(ref.index)), backend=backend,
                    device="cpu")


def _assert_same(rs, ref_rs, msg=""):
    np.testing.assert_array_equal(rs.scores.numpy(), np.asarray(ref_rs.scores),
                                  err_msg=msg)
    np.testing.assert_array_equal(rs.mask.numpy(), np.asarray(ref_rs.mask),
                                  err_msg=msg)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_seekers_match_oracle_and_reference(backend, seed):
    lake, ref = _ref(seed)
    ex = _port(seed, backend)
    specs = random_specs(lake, np.random.default_rng(100 + seed),
                         k=lake.n_tables)
    for spec in specs:
        msg = f"{spec.kind} h={spec.h} {spec.sampling}"
        rs = ex.run_seeker(spec)
        oscores, omask = oracle_topk(oracle_seeker(lake, spec), spec.k)
        np.testing.assert_array_equal(rs.scores.numpy(), oscores, msg)
        np.testing.assert_array_equal(rs.mask.numpy(), omask, msg)
        _assert_same(rs, ref.run_seeker(spec), msg)
        assert int(ex._last_overflow) == int(ref._last_overflow)


@pytest.mark.parametrize("backend", BACKENDS)
def test_seekers_match_oracle_binding_k(backend):
    """With a binding top-k the cut itself (ties included) must match."""
    lake = conformance_lake(3)
    ex = Executor(build_index(lake), backend=backend,
                  device="cpu")
    for spec in random_specs(lake, np.random.default_rng(7), k=4):
        rs = ex.run_seeker(spec)
        oscores, omask = oracle_topk(oracle_seeker(lake, spec), spec.k)
        np.testing.assert_array_equal(rs.scores.numpy(), oscores, spec.kind)
        np.testing.assert_array_equal(rs.mask.numpy(), omask, spec.kind)
        assert [int(t) for t in rs.ids()] == oracle_ids(oscores, omask)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_combiner_plan_matches_reference(backend, optimize, seed):
    """A 4-seeker / 4-combiner DAG end to end: bit-identical to the JAX
    executor with the same ``optimize``; unoptimized it is the oracle."""
    lake, ref = _ref(seed)
    ex = _port(seed, backend)
    plan = conformance_plan(lake, np.random.default_rng(200 + seed), k=8)
    rs, info = ex.run(plan, optimize=optimize)
    ref_rs, ref_info = ref.run(plan, optimize=optimize)
    _assert_same(rs, ref_rs)
    assert info.order == ref_info.order
    assert info.launches == ref_info.launches
    assert info.overflow == ref_info.overflow
    if not optimize:
        oscores, omask = oracle_run(lake, plan)
        np.testing.assert_array_equal(rs.scores.numpy(), oscores)
        assert [int(t) for t in rs.ids()] == oracle_ids(oscores, omask)


def _threaded_plan(lake):
    """Mask threading into every compaction stage: MC and C each in an
    intersection group behind a shared SC, and a C subtrahend restricted to
    its minuend."""
    t, u = lake.tables[2], lake.tables[5]
    plan = Plan()
    plan.add("sc", Seekers.SC(list(t.columns[0][:8]), k=40))
    plan.add("mc", Seekers.MC([(t.columns[0][r], t.columns[1][r])
                               for r in range(6)], k=40))
    plan.add("c", Seekers.Correlation(t.columns[0], list(range(t.n_rows)),
                                      k=40))
    plan.add("and_mc", Combiners.Intersect(k=40), ["sc", "mc"])
    plan.add("and_c", Combiners.Intersect(k=40), ["sc", "c"])
    plan.add("or", Combiners.Union(k=40), ["and_mc", "and_c"])
    plan.add("c2", Seekers.Correlation(u.columns[1], list(range(u.n_rows)),
                                       k=40, h=8, sampling="rand"))
    plan.add("out", Combiners.Difference(k=10), ["or", "c2"])
    return plan


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sync", [True, False])
def test_threaded_plan_matches_reference(backend, sync):
    lake = synthetic_lake(n_tables=40, rows=20, vocab=300, seed=8)
    ref = RefExecutor(ref_build_index(lake))
    ex = Executor(UnifiedIndex.from_numpy(vars(ref.index)), backend=backend,
                  device="cpu")
    plan = _threaded_plan(lake)
    rs, info = ex.run(plan, optimize=True, sync=sync)
    ref_rs, ref_info = ref.run(plan, optimize=True, sync=sync)
    _assert_same(rs, ref_rs)
    assert rs.mask.any()
    assert (info.order, info.launches) == (ref_info.order, ref_info.launches)


# --------------------------------------------------------------- the Session

README_SQL = """
    SELECT TOP 10 TABLES
    WHERE sc('tok_1', 'tok_2', 'tok_3', 'tok_7', k=50) AND kw('tok_9', k=50)
          EXCEPT kw('tok_40', k=50)
"""


@pytest.fixture(scope="module")
def sessions():
    lake = synthetic_lake(n_tables=60, rows=30, cols=4, vocab=120, seed=0)
    ref = ref_blend.connect(lake)
    return lake, ref, {b: blend.connect(lake, backend=b, device="cpu")
                       for b in BACKENDS}


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_query_sql_explain_match_reference(sessions, backend):
    lake, ref, ports = sessions
    port = ports[backend]
    expr = blend.sc(["tok_1", "tok_2", "tok_3"], k=50) & blend.kw(["tok_9"],
                                                                  k=50)
    ref_expr = ref_blend.sc(["tok_1", "tok_2", "tok_3"], k=50) & \
        ref_blend.kw(["tok_9"], k=50)
    got, want = port.query(expr, top=10), ref.query(ref_expr, top=10)
    assert got.ids == want.ids and got.ids
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.applied_rules == want.applied_rules

    got, want = port.sql(README_SQL), ref.sql(README_SQL)
    assert got.ids == want.ids
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))

    ex, ref_ex = port.explain(README_SQL), ref.explain(README_SQL)
    text = str(ex)
    for section in ("== logical plan ==", "== rewrite rules applied ==",
                    "== physical order (ranked execution groups) ==",
                    "== execution =="):
        assert section in text
    assert ex.logical_tree == ref_ex.logical_tree
    assert ex.physical_order == ref_ex.physical_order
    assert ex.exec_order == ref_ex.exec_order
    assert (ex.ids, ex.launches, ex.overflow) == \
        (ref_ex.ids, ref_ex.launches, ref_ex.overflow)


def test_later_slices_answer_like_the_jax_package(sessions):
    """The three entry points of the approximate tier, which raised until
    it was ported (``Session.query(approx=)``, ``DiscoveryEngine.serve
    (approx=)`` and the sharded session's ``query(approx=)``), answer like
    the JAX package's."""
    from repro.serve.engine import DiscoveryEngine as RefEngine
    from repro_torch.serve.engine import DiscoveryEngine
    from test_torch_sketch import assert_same_approx, response_approx
    lake, ref, ports = sessions
    port = ports["sorted"]
    expr, ref_expr = blend.kw(["tok_1"]), ref_blend.kw(["tok_1"])
    assert_same_approx(port.query(expr, approx=True),
                       ref.query(ref_expr, approx=True))
    got = DiscoveryEngine(lake, session=port).serve(
        expr, approx={"epsilon": 0.0})
    want = RefEngine(lake, session=ref).serve(ref_expr,
                                              approx={"epsilon": 0.0})
    assert got.table_ids == want.table_ids and got.table_ids
    assert response_approx(got) == response_approx(want)
    sharded = blend.connect(lake, shards=2, device="cpu")
    ref_sharded = ref_blend.connect(lake, shards=2)
    assert_same_approx(sharded.query(expr, approx=True),
                       ref_sharded.query(ref_expr, approx=True))


# ------------------------------------ the static-index members of the surface

def _same_query():
    expr = blend.sc(["tok_1", "tok_2", "tok_3"], k=50) | blend.kw(["tok_9"],
                                                                  k=50)
    ref_expr = ref_blend.sc(["tok_1", "tok_2", "tok_3"], k=50) | \
        ref_blend.kw(["tok_9"], k=50)
    return expr, ref_expr


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_result_iterates_like_reference(sessions, backend):
    _, ref, ports = sessions
    expr, ref_expr = _same_query()
    got, want = ports[backend].query(expr), ref.query(ref_expr)
    assert list(got) == list(want) and list(got) == got.ids and got.ids


@pytest.mark.parametrize("backend", BACKENDS)
def test_exec_info_total_seconds(sessions, backend):
    _, ref, ports = sessions
    expr, ref_expr = _same_query()
    info = ports[backend].query(expr).info
    ref_info = ref.query(ref_expr).info
    assert info.total_seconds == sum(info.node_seconds.values()) > 0
    assert sorted(info.node_seconds) == sorted(ref_info.node_seconds)


def test_storage_bytes_and_aos_view_match_reference(sessions):
    _, ref, ports = sessions
    port_idx, ref_idx = ports["sorted"].index, ref.executor.index
    assert port_idx.storage_bytes() == ref_idx.storage_bytes() > 0
    got, want = port_idx.aos_view(), ref_idx.aos_view()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_index_shape_and_explain_index_block_match_reference(sessions,
                                                            backend):
    _, ref, ports = sessions
    port = ports[backend]
    assert port.index_shape() == ref.index_shape()
    ex, ref_ex = port.explain(README_SQL), ref.explain(README_SQL)
    assert ex.index_shape == ref_ex.index_shape == ref.index_shape()

    def block(text):
        lines = text.splitlines()
        start = lines.index("== index ==")
        end = next(i for i in range(start + 1, len(lines))
                   if lines[i].startswith("== "))
        return lines[start - 1:end + 1]   # with its neighbouring headers

    got, want = block(str(ex)), block(str(ref_ex))
    assert got == want and len(got) > 3
    assert got[-1] == "== physical order (ranked execution groups) =="


def test_explain_fused_and_server_answer(sessions):
    """Neither raises any more: ``server=`` (a ``DiscoveryServer.stats()``
    dict) renders the ``== server ==`` section, and ``fused=True`` runs and
    gives the unfused ids."""
    from repro_torch.serve.engine import DiscoveryEngine
    from repro_torch.serve.server import DiscoveryServer
    lake, _, ports = sessions
    port = ports["sorted"]
    with DiscoveryServer(DiscoveryEngine(lake, session=port)) as srv:
        srv.serve(README_SQL)
        stats = srv.stats()
    ex = port.explain(README_SQL, server=stats)
    assert ex.server == stats and ex.server["served"] == 1
    lines = str(ex).splitlines()
    at = lines.index("== server ==")
    assert lines[at + 1].startswith("  queue depth: interactive: 0")
    assert "== server ==" not in str(port.explain(README_SQL))
    unfused = port.explain(README_SQL, fused=False, server=None)
    assert unfused.ids and unfused.ids == ex.ids
    assert port.explain(README_SQL, fused=True).ids == unfused.ids


def test_connect_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lake = synthetic_lake(n_tables=3, rows=4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blend.connect(lake)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor(build_index(lake))


PROBE = """
import sys
import repro_torch as blend
from repro_torch.core.lake import synthetic_lake
lake = synthetic_lake(n_tables=10, rows=8, seed=0)
s = blend.connect(lake, backend="bucket", device="cpu")
res = s.query(blend.sc(lake.tables[0].columns[0]) | blend.kw(["tok_3"]))
assert res.ids
sharded = blend.connect(lake, shards=2, live=True, device="cpu")
got = sharded.query(blend.sc(lake.tables[0].columns[0]) | blend.kw(["tok_3"]))
assert got.ids == res.ids
from repro_torch.serve.engine import DiscoveryEngine
eng = DiscoveryEngine(lake, cache=True, backend="bucket", device="cpu")
got = eng.serve_many([blend.kw(["tok_3"]), blend.kw(["tok_3"])])
assert got[0].table_ids == got[1].table_ids and got[1].cache["status"] == "hit"
from repro_torch.serve import client, loadgen
from repro_torch.serve.server import DiscoveryServer
with DiscoveryServer(eng) as srv:
    resp = client.RetryingClient(srv).serve(blend.kw(["tok_3"]))
    assert resp.table_ids == got[0].table_ids and srv.stats()["served"] == 1
assert not srv.stats()["running"]
assert loadgen.make_trace(lake, duration_s=0.1).events
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import registry
from repro_torch.serve.engine import LMEngine
cfg = reduced(get_config("smollm-360m"))
gen = torch.Generator().manual_seed(0)
params = registry.init_params(cfg, gen, device="cpu")
batch = registry.make_batch(cfg, ShapeConfig("s", 32, 2, "prefill"), gen,
                            device="cpu")
toks = LMEngine(cfg, params, 40, device="cpu").generate(batch, 4)
assert toks.shape == (2, 4)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m in ("repro", "blend"))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_of_the_port_imports_jax_or_reference():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|blend)\b",
                     re.MULTILINE)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert len(files) > 20 and offenders == []
