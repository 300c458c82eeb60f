"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  Each ``.cu``
file is compiled to an object by its own ``nvcc`` process, all started
together, then one link step makes the library.  The build runs at first
use, never at import, and is keyed on a hash of the sources and flags:
``<repo>/build/kernels/<hash>/libkde.so`` (``build/`` is git-ignored).  A
second process finds the finished library and only loads it.

No ``--use_fast_math``: the kernels rely on IEEE ``expf``/``sqrtf``/``powf``
and on IEEE infinities, as the reference's f32 path does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("kde_rowsum.cu", "kde_sampler.cu", "kde_hash.cu",
           "flash_attention.cu", "kde_attention.cu")
HEADERS = ("kde_tile.cuh", "kde_wide.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class KdeDecodeShape(ctypes.Structure):
    """``struct KdeDecodeShape`` of csrc/kde_attention.cu: the static
    arguments of a kde_decode launch (dtype ids: 0 float32, 1 bfloat16;
    mode -1 the plan's kernel, 0 cluster, 1 spread)."""
    _fields_ = [(n, _I) for n in ("b", "hq", "hkv", "S", "dh", "bk",
                                  "stride", "top_p", "q_dtype",
                                  "kv_dtype", "mode")] + \
        [("scale", _F), ("log_stride", _F)] + \
        [(n, _L) for n in ("qsb", "qsh", "ksb", "ksh", "kss", "vsb", "vsh",
                           "vss")]


class KdeDecodePlan(ctypes.Structure):
    """``struct KdeDecodePlan`` of csrc/kde_attention.cu: the kernel a
    kde_decode launch takes (mode 0 cluster, 1 spread), its CTAs per
    (batch, kv-head), key blocks a CTA, shared memory, and the spread
    kernel's scratch (f32 words after the estimates) and counters."""
    _fields_ = [(n, _I) for n in ("mode", "ctas", "blocks", "smem")] + \
        [("work", _L), ("sync", _I)]

class KdeTileShape(ctypes.Structure):
    """``struct KdeTileShape`` of csrc/kde_wide.cuh: the static arguments
    of a rowsum, blocksum, masked-blocksum or sample-block launch."""
    _fields_ = [(n, _I) for n in ("m", "n", "d", "bn", "nb", "own64",
                                  "instance", "group", "kind")] + \
        [(n, _F) for n in ("inv_bw", "inv_bw2", "beta")]


class KdeWeightedShape(ctypes.Structure):
    """``struct KdeWeightedShape`` of csrc/kde_hash.cu: the static
    arguments of a weighted-kv(-sum) launch (``instance`` carries
    ``kde_hash.kernel.BF16_ROWS`` for a bf16 x)."""
    _fields_ = [(n, _I) for n in ("m", "n", "d", "t", "instance", "kind")] + \
        [(n, _F) for n in ("inv_bw", "inv_bw2", "beta")]


# C signatures of every exported function (all return an int: cudaError_t,
# or kde_decode_plan's status).  The KDE launchers take the bf16
# exp table (or null) just before the stream.
SIGNATURES = {
    "kde_rowsum_launch": (_P, _P, _P, _P, _P, _P,
                          ctypes.POINTER(KdeTileShape)),
    "kde_blocksum_launch": (_P, _P, _P, _P, _P, ctypes.POINTER(KdeTileShape)),
    "kde_masked_blocksum_launch": (_P, _P, _P, _P, _P, _P,
                                   ctypes.POINTER(KdeTileShape)),
    "kde_sample_block_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.POINTER(KdeTileShape)),
    "kde_weighted_kv_launch": (_P, _P, _P, _P, _P, _P, _P,
                               ctypes.POINTER(KdeWeightedShape)),
    "kde_weighted_kv_sum_launch": (_P, _P, _P, _P, _P, _P, _P,
                                   ctypes.POINTER(KdeWeightedShape)),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _L, _L, _L, _L, _L, _L, _L,
                               _L, _L, _I, _I, _P),
    "kde_decode_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _P,
                          ctypes.POINTER(KdeDecodeShape)),
    "kde_decode_plan": (ctypes.POINTER(KdeDecodeShape),
                        ctypes.POINTER(KdeDecodePlan)),
}

_LIB = None
#: compiler output of the build this process ran (ptxas register and
#: spill lines), or "" when the library was already built
BUILD_LOG = ""
#: seconds this process spent building (0.0 when it only loaded)
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def source_hash() -> str:
    """Hash of every source, header and flag the library is built from."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on the first
    failure with its compiler output; returns the combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(target: Path) -> None:
    global BUILD_LOG, BUILD_SECONDS
    t0 = time.perf_counter()
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        log = _run_all([[nvcc, *FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                        for s, o in zip(SOURCES, objs)])
        lib = Path(tmp) / target.name
        log += _run_all([[nvcc, "-shared", "-o", str(lib),
                          *map(str, objs)]])
        os.replace(lib, target)        # atomic: readers never see a stub
    BUILD_LOG = log
    BUILD_SECONDS = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _LIB
    if _LIB is None:
        target = BUILD_ROOT / source_hash() / "libkde.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
