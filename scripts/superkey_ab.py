#!/usr/bin/env python3
"""Time two builds of the XASH superkey kernels against each other on one
GPU, in turns within one process.

    python3 scripts/superkey_ab.py --before OTHER/src/repro_torch/kernels/csrc

``--before`` names the ``csrc`` directory of another checkout (for example
a ``git archive`` of the parent commit unpacked into a git-ignored
directory); the checkout's own kernel library is "after".  The other
``csrc`` is built by the port's own ``_build.build`` into a library of its
own and launched through ``_build.launch``.  At the inputs ``chip_smoke.py``
times (``superkey_filter`` at T = 256 query digests against N = 958,623 row
digests; ``superkey_filter_rows`` at [256, 128] and [256, 1024]) both sides
must equal the plain version bit for bit, and are then timed in ROUNDS
rounds of before, after, after, before: CUDA-event ms (L2 flushed before
each call) and profiler device ms.  Each case's line gives the medians, the
bound and a ``fill_`` of the same output bytes as the store yardstick.
The digests are random (seed 0): neither kernel's work depends on them.
The last line is the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402  (timing helpers and the bound)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.superkey_filter.ref import (  # noqa: E402
    superkey_filter_ref, superkey_filter_rows_ref)

ROUNDS = 5
#: (label, C entry point, T, N or M)
CASES = (("superkey_filter", "superkey_filter", 256, 958_623),
         ("superkey_filter_rows", "superkey_filter_rows", 256, 128),
         ("superkey_filter_rows", "superkey_filter_rows", 256, 1024))


def inputs(entry, t, n, rng):
    """int32 digests on the card: rows [N] (or [T, M]) and queries [T],
    each query the bits of one row with some cleared, so some pairs hold."""
    shape = (n,) if entry == "superkey_filter" else (t, n)
    sk = rng.integers(0, 2 ** 32, (2, *shape), dtype=np.uint32)
    rows = sk.reshape(2, -1)[:, rng.integers(0, sk[0].size, t)]
    q = rows & rng.integers(0, 2 ** 32, (2, t), dtype=np.uint32)
    q[:, ::2] &= rng.integers(0, 2 ** 32, (2, (t + 1) // 2), dtype=np.uint32)
    return tuple(torch.from_numpy(a.view(np.int32).copy()).cuda()
                 for a in (*sk, *q))


def run(lib, entry, args, out):
    sk_lo, sk_hi, q_lo, q_hi = args
    size = sk_lo.shape[0] if entry == "superkey_filter" else sk_lo.shape[1]
    _build.launch(entry, out.device, *(a.data_ptr() for a in args),
                  out.data_ptr(), q_lo.shape[0], size, lib=lib)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", type=Path, required=True)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("superkey_ab: no CUDA device", file=sys.stderr)
        return 1
    flush = smoke.l2_flusher(torch.device("cuda"))
    rng = np.random.default_rng(0)
    after = _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        libs = {"before": _build.build(opts.before.resolve(),
                                       Path(tmp) / "before.so"),
                "after": after}
        for label, entry, t, n in CASES:
            args = inputs(entry, t, n, rng)
            plain = superkey_filter_ref if entry == "superkey_filter" \
                else superkey_filter_rows_ref
            want = plain(*args)
            out = torch.empty(want.shape, dtype=torch.bool, device="cuda")
            for side, lib in libs.items():
                out.zero_()
                run(lib, entry, args, out)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{side} {label} {list(want.shape)}"
                                         " disagrees with its plain version")
            times = {side: {"ms": [], "device_ms": []} for side in libs}
            for _ in range(ROUNDS):
                for side in ("before", "after", "after", "before"):
                    call = lambda: run(libs[side], entry, args, out)  # noqa
                    times[side]["ms"].append(smoke.time_ms(call, flush))
                    times[side]["device_ms"].append(smoke.kernel_device_ms(
                        call, f"{entry}_kernel", flush))
            moved = 8 * args[0].numel() + 8 * t + out.numel()
            # a profiled run that saw no kernel reads None and is left out
            med = {side: {k: statistics.median(x for x in v if x is not None)
                          for k, v in d.items()}
                   for side, d in times.items()}
            smoke.emit({
                "kernel": label, "shape": list(out.shape), "bytes": moved,
                "bound_ms": moved / smoke.HBM_BYTES_PER_S * 1e3,
                "rounds": ROUNDS, "median": med, "all": times,
                "speedup_device": med["before"]["device_ms"]
                / med["after"]["device_ms"],
                **smoke.fill_yardstick(out.shape, flush)})
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
