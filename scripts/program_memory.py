#!/usr/bin/env python3
"""Device memory each fused-path program takes at its capture, on the card.

Builds ``chip_smoke.py``'s smoke lake and queries, connects the ``bucket``
backend on the CUDA card, and runs every query once on the fused path and
then all of them as one ``query_many`` batch, which captures every program
the smoke queries need.  Around each capture it reads
``torch.cuda.memory_allocated()`` and ``memory_reserved()`` (after a
synchronize) and prints one JSON line per program: its kind, its key's
leading part, and the two deltas.  A last line sums them by kind and in
all.  Needs one CUDA card; exits non-zero without one.

    python3 scripts/program_memory.py [--src DIR]

``--src`` reads another checkout's package (its ``src`` directory) with
this same script, so two versions are measured alike: the package and
the ``chip_smoke.py`` beside that directory are imported from there.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("program_memory: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src.parent))
    sys.path.insert(0, str(src))
    import chip_smoke as smoke
    import repro_torch as blend
    from repro_torch.core import programs

    rows = []
    init = programs._Graph.__init__

    def measured(self, fn, flat, layout, dev, device, *rest):
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        init(self, fn, flat, layout, dev, device, *rest)
        torch.cuda.synchronize()
        rows.append({"allocated": torch.cuda.memory_allocated() - a0,
                     "reserved": torch.cuda.memory_reserved() - r0})

    programs._Graph.__init__ = measured
    run = programs.Programs.run

    def keyed(self, key, kind, *rest, **kw):
        n = len(rows)
        out = run(self, key, kind, *rest, **kw)
        if len(rows) > n:
            rows[-1].update(kind=kind, key=[str(p) for p in key[:4]])
            print(json.dumps({"program": rows[-1]}), flush=True)
        return out

    programs.Programs.run = keyed
    smoke._build.library()
    lake = smoke.synthetic_lake(**smoke.LAKE)
    session = blend.connect(lake, backend="bucket")
    queries = smoke.make_queries(lake)
    torch.cuda.synchronize()
    base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    for q in queries.values():
        smoke.run_query(session, q, fused=True)
    session.query_many(list(queries.values()))
    torch.cuda.synchronize()
    by_kind: dict = {}
    for r in rows:
        k = by_kind.setdefault(r["kind"], {"programs": 0, "allocated": 0,
                                           "reserved": 0})
        k["programs"] += 1
        k["allocated"] += r["allocated"]
        k["reserved"] += r["reserved"]
    print(json.dumps({"summary": {
        "src": args.src, "card": smoke.card_line(), "by_kind": by_kind,
        "programs": len(rows),
        "allocated": sum(r["allocated"] for r in rows),
        "reserved": sum(r["reserved"] for r in rows),
        "run_allocated": torch.cuda.memory_allocated() - base[0],
        "run_reserved": torch.cuda.memory_reserved() - base[1],
        "index_allocated": base[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
