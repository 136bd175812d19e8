"""Checkpointing: the JAX package's ``train/checkpoint.py`` on torch, with
its on-disk layout.

Atomic (tmp + rename) directory checkpoints ``step_%08d``: a msgpack
manifest (``{"step", "leaves": {path: {"shape", "dtype", "file"}}}``, the
paths ``/``-joined dict keys in sorted order, as ``jax.tree_util``
flattens them) + one raw C-order buffer file per leaf.  Either package
reads what the other wrote, bf16 included (``"bfloat16"``, the raw 16-bit
words).  The manifest's small subset of msgpack (maps, arrays, str, int,
bool, nil) is encoded and decoded here, byte for byte as
``msgpack.packb`` writes it, so the port needs neither ``msgpack`` nor
``ml_dtypes``.  Restoring onto another placement (the JAX package's
``shardings=``, elastic rescale) waits for ROADMAP queue A, item A8d.
"""
from __future__ import annotations

import os
import shutil
import struct
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.index import resolve_device

#: torch dtype <-> the manifest's dtype string (numpy's name) and the numpy
#: dtype that holds its raw bytes (bf16 as its 16-bit words)
_DTYPES = {torch.float32: ("float32", np.float32),
           torch.float64: ("float64", np.float64),
           torch.float16: ("float16", np.float16),
           torch.bfloat16: ("bfloat16", np.int16),
           torch.int64: ("int64", np.int64),
           torch.int32: ("int32", np.int32),
           torch.int16: ("int16", np.int16),
           torch.int8: ("int8", np.int8),
           torch.uint8: ("uint8", np.uint8),
           torch.bool: ("bool", np.bool_)}
_BY_NAME = {name: (dt, raw) for dt, (name, raw) in _DTYPES.items()}


# --------------------------------------------------------------------------
# the manifest's msgpack subset
# --------------------------------------------------------------------------

def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, lists, str, int, bool and None."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, (int, np.integer)):
        _pack_int(int(obj), out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xa0, 32, 0xd9, 0xda, 0xdb)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, None, 0xdc, 0xdd)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, None, 0xde, 0xdf)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_len(n, out, fix, fix_max, b8, b16, b32):
    if n < fix_max:
        out.append(fix | n)
    elif b8 is not None and n < 1 << 8:
        out += struct.pack(">BB", b8, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", b16, n)
    else:
        out += struct.pack(">BI", b32, n)


def _pack_int(n, out):
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32),
                               (0xcf, ">BQ", 1 << 64)):
            if n < top:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if n >= low:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)


#: fixed-width codes: code -> (struct format, payload bytes)
_FIXED = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
#: length-prefixed codes: code -> (kind, struct format of the length)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for what ``packb`` writes."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("trailing bytes after the manifest")
    return obj


def _unpack(buf, i):
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xe0:
        return code - 0x100, i
    if code in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[code], i
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0xa0 <= code < 0xc0:
        kind, n = "str", code & 0x1f
    elif 0x90 <= code < 0xa0:
        kind, n = "array", code & 0x0f
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0f
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"unsupported msgpack code {code:#x}")
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _flatten(state, prefix="") -> dict:
    """Leaves by path, in ``jax.tree_util``'s order (dict keys sorted)."""
    out = {}
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


def _to_numpy(t: torch.Tensor):
    """A leaf's manifest dtype string and its raw C-order bytes' array."""
    name, raw = _DTYPES[t.dtype]
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, t.numpy().view(raw)


def save(state, directory, step: int, keep: int = 3):
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_"))
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(state).items():
        dtype, arr = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".bin"
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": dtype, "file": fname}
        with open(tmp / fname, "wb") as f:
            f.write(arr.tobytes())
    with open(tmp / "manifest.msgpack", "wb") as f:
        f.write(packb(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int):
    ckpts = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(d)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.iterdir()
             if d.is_dir() and d.name.startswith("step_")]
    return max(steps) if steps else None


def restore(template, directory, step: int | None = None, *, device=None):
    """Restore into the structure of ``template`` (nested dicts of tensors,
    or of anything at the leaves) on ``device`` (the card unless
    ``device="cpu"``): each leaf gets the manifest's shape and dtype.
    Returns (state, step)."""
    device = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    with open(d / "manifest.msgpack", "rb") as f:
        manifest = unpackb(f.read())

    def load(key):
        meta = manifest["leaves"][key]
        dtype, raw = _BY_NAME[meta["dtype"]]
        with open(d / meta["file"], "rb") as f:
            arr = np.frombuffer(f.read(), dtype=raw).reshape(meta["shape"])
        t = torch.from_numpy(arr.copy())
        return (t.view(dtype) if dtype == torch.bfloat16 else t).to(device)

    def build(node, prefix=""):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else load(prefix + str(k)) for k, v in node.items()}

    return build(template), manifest["step"]
