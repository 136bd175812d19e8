"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Every ``.cu`` source is compiled for ``sm_90a`` by its own ``nvcc`` process
(all started together), then linked into one shared library with a plain C
interface that is loaded with ``ctypes``.  The library's file name carries a
hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags, so it is built at first use and rebuilt whenever one changes; it
lives in ``build/kernels/`` at the root of the checkout, beside the
compilers' ``-Xptxas -v`` report of each kernel (``ptxas_usage``).

No ``--use_fast_math``: ``qcr_segments`` and ``qcr_score`` divide, and the
port's scores must equal the reference's bit for bit, which IEEE
``div.rn.f32`` (nvcc's default) gives.

Each C entry point selects the device it is handed, launches on the stream
it is handed and returns ``cudaGetLastError()``; ``launch`` raises when that
is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
F32 = ctypes.c_float
#: C entry point -> argument types (pointers, sizes, then device and stream)
SIGNATURES = {
    "bucket_probe": (P, P, P, P, I64, I64, I32, I32, P),
    "superkey_filter_rows": (P, P, P, P, P, I64, I64, I32, P),
    "qcr_segments": (P, P, P, I64, F32, I32, P),
    "superkey_filter": (P, P, P, P, P, I64, I64, I32, P),
    "qcr_score": (P, P, P, P, I64, I64, I32, P),
    # q, k, v, out, B, Sq, Skv, H, K, D, causal, bf16
    "flash_attention": (P, P, P, P, I64, I64, I64, I64, I64, I32, I32, I32,
                        I32, P),
    # D -> dynamic shared memory of the bf16 / f32 kernel (called directly)
    "flash_attention_tc_smem": (I32,),
    "flash_attention_f32_smem": (I32,),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources(csrc: Path | None = None):
    return sorted((csrc or CSRC).glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = {c for s in sources for c in s.parent.glob("*.cuh")}
    for s in sorted([*sources, *headers]):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, out: Path):
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        bad = [(s.name, log) for s, p, log in zip(sources, procs, logs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in bad))
        out.with_suffix(".log").write_text("".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, out)


def _lib_path() -> Path:
    return BUILD / f"libblend_kernels_{_digest(_sources())}.so"


def build(csrc: Path, lib_path: Path) -> ctypes.CDLL:
    """Every source of ``csrc`` compiled into ``lib_path`` (unless that file
    exists) and loaded, its C entry points bound to ``SIGNATURES``."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    if not lib_path.exists():
        _compile(_sources(csrc), lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    return build(CSRC, _lib_path())


def parse_ptxas(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {mangled kernel: {"registers",
    "stack_bytes", "spill_store_bytes", "spill_load_bytes"}}."""
    usage, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            usage[name] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1) if m.group(1) in usage else None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                      r"spill stores, (\d+) bytes spill loads",
                                      line)):
            usage[name].update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def ptxas_usage(symbol: str) -> dict:
    """Registers and spills of the built kernels whose mangled name holds
    ``symbol``, from the library's ``-Xptxas -v`` report."""
    library()
    log = _lib_path().with_suffix(".log").read_text()
    return {k: v for k, v in parse_ptxas(log).items() if symbol in k}


def device_of(name: str, *tensors) -> torch.device:
    """The one device all ``tensors`` lie on: the CPU selects a kernel's
    plain version, CUDA the kernel itself; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def require(name: str, ok: bool, what: str):
    """Input check of a kernel wrapper: raise ``ValueError`` unless ``ok``."""
    if not ok:
        raise ValueError(f"{name}: {what}")


def launch(name: str, device: torch.device, *args, lib=None):
    """Call C entry point ``name`` of ``lib`` (the port's own library by
    default) on ``device`` and PyTorch's current stream there; raise on a
    non-zero ``cudaError_t``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib or library(), name)(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
