"""Roofline analysis: the port of ``repro.roofline.analysis``.

Analytic terms (seconds, per step), against a ``ChipSpec``:
  compute    = FLOPs / (chips * spec.peak_flops)
  memory     = HBM bytes / (chips * spec.hbm_bw)
  collective = per-device collective bytes / spec.link_bw

FLOPs / HBM bytes come from the analytic model (``roofline/flops.py``).
The reference parses its collective bytes from the compiled HLO text; the
port has no HLO.  ``collective_bytes`` reads the collective wrapper's
counts and bytes by kind (``distributed.collectives``) over a traced step
instead: every call is realized, so there is no loop trip count to
resolve (``unresolved_trips`` is 0).

Measured mode (``measured_roofline``) takes a wall time and the modeled
flops / bytes of the program that ran, and reports the achieved fraction
of the spec's roofline: ``max(compute_s, memory_s, collective_s) /
time_s`` -- 1.0 means the run sits ON the roofline for its dominant
resource.

The port's device is the H100 (``H100``, from its data sheet, labelled
with the card's name and power limit as nvidia-smi gives them);
``chip_spec_for_backend("cuda")`` returns it and "cpu" ``HOST_CPU``.  The
reference maps a GPU backend to its TPU spec (ROADMAP.md section 3).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one accelerator chip (or host core) for roofline
    normalization.  ``link_bw`` is the per-link interconnect rate used by
    the collective term; hosts without a fabric reuse memory bandwidth."""
    name: str
    peak_flops: float          # FLOP/s per chip (dense, preferred dtype)
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per link

    def as_dict(self):
        return dataclasses.asdict(self)


# NVIDIA H100 SXM (data sheet): 989 TFLOP/s dense bf16 on the tensor
# cores, 3.35 TB/s HBM3, NVLink 450 GB/s a direction.
H100 = ChipSpec("NVIDIA H100 80GB HBM3, 700.00 W", 989e12, 3.35e12, 450e9)

# Order-of-magnitude single host core (AVX2-class f32 FMA, DRAM stream):
# the spec when the process runs on the CPU, so measured fractions stay
# O(0.1..1).
HOST_CPU = ChipSpec("host_cpu", 5.0e10, 2.0e10, 2.0e10)


def chip_spec_for_backend(backend: Optional[str] = None) -> ChipSpec:
    """Chip spec for a backend name ("cuda" -> ``H100``, "cpu" ->
    ``HOST_CPU``), or for this process's default device when None (the
    card when there is one)."""
    if backend is None:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cpu":
        return HOST_CPU
    if backend in ("cuda", "gpu"):
        return H100
    raise ValueError(f"no chip spec for backend {backend!r}: pass a "
                     f"ChipSpec to roofline_terms / measured_roofline")


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: the wrapper's kinds (the reference's primitive names) -> HLO opcodes
_KIND_OF = {"all_gather": "all-gather", "psum": "all-reduce",
            "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
            "ppermute": "collective-permute"}


def dtype_bytes(dtype) -> int:
    """Bytes per element of an HLO / numpy / torch dtype name ("f32",
    "bf16", "bfloat16", "float32", ``torch.float32``, ...)."""
    alias = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
             "float16": "f16", "int64": "s64", "int32": "s32",
             "int16": "s16", "int8": "s8", "uint64": "u64", "uint32": "u32",
             "uint16": "u16", "uint8": "u8", "bool": "pred"}
    name = str(dtype).replace("torch.", "")
    key = alias.get(name, name)
    if key not in _DTYPE_BYTES:
        raise KeyError(f"unknown dtype {dtype!r}")
    return _DTYPE_BYTES[key]


_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Total bytes of a possibly-tuple HLO type string ("f32[8,16]",
    "(bf16[4], s32[2,2])")."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    total_bytes: float
    unresolved_trips: int = 0


def collective_bytes(counts: Optional[Mapping[str, int]] = None,
                     nbytes: Optional[Mapping[str, float]] = None
                     ) -> CollectiveStats:
    """The collectives one rank realized, by HLO kind: ``counts`` /
    ``nbytes`` keyed by the wrapper's kinds (``COLLECTIVES`` /
    ``COLLECTIVE_BYTES`` of ``distributed.collectives``, their values by
    default; pass the differences over a traced step)."""
    if counts is None or nbytes is None:
        from repro_torch.distributed import collectives as C
        counts = dict(C.COLLECTIVES) if counts is None else counts
        nbytes = dict(C.COLLECTIVE_BYTES) if nbytes is None else nbytes
    bytes_by: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    count_by: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, n in counts.items():
        op = _KIND_OF[kind]
        count_by[op] += int(n)
        bytes_by[op] += float(nbytes.get(kind, 0))
    return CollectiveStats(bytes_by, count_by, sum(bytes_by.values()), 0)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_total: float
    model_flops: float
    useful_ratio: float
    hbm_bytes: float
    collective_bytes_per_device: float
    chips: int
    raw_cost_flops: Optional[float] = None
    raw_cost_bytes: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_total: float, model_flops: float, hbm_bytes: float,
                   coll_bytes_per_device: float, chips: int,
                   raw_cost: Optional[Dict] = None,
                   spec: Optional[ChipSpec] = None) -> Roofline:
    """The three terms against ``spec`` (the H100's when None; the
    reference defaults to its TPU spec)."""
    spec = H100 if spec is None else spec
    compute_s = flops_total / (chips * spec.peak_flops)
    memory_s = hbm_bytes / (chips * spec.hbm_bw)
    collective_s = coll_bytes_per_device / spec.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, flops_total=flops_total, model_flops=model_flops,
        useful_ratio=model_flops / max(flops_total, 1.0),
        hbm_bytes=hbm_bytes, collective_bytes_per_device=coll_bytes_per_device,
        chips=chips,
        raw_cost_flops=(raw_cost or {}).get("flops"),
        raw_cost_bytes=(raw_cost or {}).get("bytes accessed"))


@dataclasses.dataclass
class MeasuredRoofline:
    """One live measurement against a chip spec's roofline.

    ``achieved_fraction = max(compute_s, memory_s, collective_s) / time_s``
    -- the fraction of the roofline bound actually reached (1.0 = the run
    is AT the bound for its dominant resource; > 1 means the byte/flop
    model undercounts, e.g. cache-resident traffic)."""
    time_s: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    achieved_fraction: float
    achieved_flops: float
    achieved_bw: float
    spec: str
    chips: int

    def as_dict(self):
        return dataclasses.asdict(self)


def measured_roofline(time_s: float, flops: float, bytes_moved: float,
                      spec: Optional[ChipSpec] = None, chips: int = 1,
                      coll_bytes_per_device: float = 0.0) -> MeasuredRoofline:
    """Roofline placement of a measured run: modeled flops/bytes of the
    program that ran, observed wall seconds, backend-configurable peaks
    (``chip_spec_for_backend()`` when ``spec`` is None)."""
    if spec is None:
        spec = chip_spec_for_backend()
    compute_s = flops / (chips * spec.peak_flops)
    memory_s = bytes_moved / (chips * spec.hbm_bw)
    collective_s = coll_bytes_per_device / spec.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    t = max(float(time_s), 1e-12)
    return MeasuredRoofline(
        time_s=float(time_s), compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        achieved_fraction=max(compute_s, memory_s, collective_s) / t,
        achieved_flops=flops / t, achieved_bw=bytes_moved / t,
        spec=spec.name, chips=chips)
