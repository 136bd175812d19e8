#!/usr/bin/env python3
"""Where the host time of a fused query goes, on the card.

Builds ``chip_smoke.py``'s smoke lake and queries, connects the ``bucket``
backend on the CUDA card, warms the fused path (every program captured),
then runs each query ``--runs`` times through ``session.query(q,
fused=True)`` under ``cProfile`` and prints, per query, one JSON line: the
wall ms per query with the profiler off, and the functions with the most
own time per query with it on (the profiler adds to every Python call, so
read the shares, not the sums).  Needs one CUDA card; exits non-zero
without one.

    python3 scripts/fused_host_profile.py [--runs 20] [--top 12]
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_host_profile: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"card": smoke.card_line()}), flush=True)
    lake = smoke.synthetic_lake(**smoke.LAKE)
    session = smoke.blend.connect(lake, backend="bucket")
    queries = smoke.make_queries(lake)
    for q in queries.values():
        session.query(q, fused=True)
    torch.cuda.synchronize()
    for label, q in queries.items():
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            session.query(q, fused=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.runs):
            session.query(q, fused=True)
            torch.cuda.synchronize()
        prof.disable()
        stats = pstats.Stats(prof)
        total = sum(row[2] for row in stats.stats.values())
        rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
        top = [{"function": f"{Path(f).name}:{line} {name}",
                "own_ms": own * 1e3 / args.runs, "share": own / total,
                "calls": n // args.runs}
               for (f, line, name), (_, n, own, _cum, _) in rows[:args.top]]
        print(json.dumps({"query": label, "runs": args.runs,
                          "p50_ms": statistics.median(times),
                          "profiled_ms": total * 1e3 / args.runs,
                          "top_own_time": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
