"""Positional signatures of the port's public entry points against the
reference's.

A caller may pass the reference's arguments by position, so every entry
point takes the reference's positional parameters in the reference's
order; the port's own additions (``device=``) come only after them.  A
reference parameter the port has no use for yet keeps its position as a
placeholder: a tile size is checked and ignored, an implementation switch
(``use_pallas``, ``interpret``) must be None, and a feature not ported yet
raises ``NotImplementedError`` on a non-default value.

Out of this test's scope, by design (ROADMAP.md section 3): the
explicit-noise parameters of the kernel programs (the reference's ``key``
becomes ``u`` / ``off`` / ``fidx`` / ``noise`` / ``generator``), and the
``params`` -> ``model`` / ``key`` -> ``seed`` swaps of ``init_params``,
``forward`` and ``decode_step``.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.core.kde.base import ExactBlockKDE, ExactKDE
from repro_torch.core.kde.hashed import HashedKDE
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.sampling.edge import (NeighborSampler,
                                            shared_level1_estimator)
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.device import ROADMAP_ITEMS, not_in_slice
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.kde_attention.ops import kde_attention
from repro_torch.kernels.kde_rowsum import kernel as rs_k
from repro_torch.kernels.kde_rowsum.ops import kde_blocksum, kde_rowsum
from repro_torch.kernels.kde_hash.ref import rowwise_kv
from repro_torch.kernels.kde_sampler.ref import (exp_table_on,
                                                 kv_block_sums_bf16)
from repro_torch.models.transformer import forward, init_cache, init_params
from repro_torch.ckpt.checkpoint import restore as ckpt_restore
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.train_step import make_prefill_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]

#: (module under ``repro`` / ``repro_torch``, public name)
ENTRY_POINTS = [
    ("kernels.kde_rowsum.ops", "kde_rowsum"),
    ("kernels.kde_rowsum.ops", "kde_blocksum"),
    ("kernels.flash_attention.ops", "flash_attention"),
    ("kernels.kde_attention.ops", "kde_attention"),
    ("core.kde.base", "ExactKDE"),
    ("core.kde.base", "ExactBlockKDE"),
    ("core.kde.base", "RSKDE"),
    ("core.kde.base", "make_estimator"),
    ("core.kde.hashed", "HashedKDE"),
    ("core.sampling.edge", "NeighborSampler"),
    ("core.sampling.edge", "shared_level1_estimator"),
    ("core.sampling.rownorm", "RowNormSampler"),
    ("core.sparsify", "spectral_sparsify"),
    ("core.sparsify", "incidence_row_norms"),
    ("core.lowrank", "countsketch_lowrank"),
    ("models.transformer", "init_cache"),
    ("models.layers", "moe_block"),
    ("models.layers", "moe_block_dense"),
    ("models.layers", "cross_attention_block"),
    ("models.ssm", "init_rwkv6"),
    ("models.ssm", "_rwkv6_projections"),
    ("models.ssm", "rwkv6_scan"),
    ("models.ssm", "rwkv6_chunked"),
    ("models.ssm", "init_mamba2"),
    ("models.ssm", "_mamba2_projections"),
    ("models.ssm", "mamba2_scan"),
    ("models.ssm", "mamba2_chunked"),
    ("kernels.kde_sampler.ref", "cdf_group"),
    ("kernels.kde_sampler.ref", "degree_precedes"),
    ("kernels.kde_sampler.ref", "laplacian_matvec_ref"),
    ("kernels.kde_sampler.ops", "walk_layout"),
    ("kernels.kde_sampler.ops", "walk_cache_samples"),
    ("kernels.kde_sampler.ops", "laplacian_matvec"),
    ("kernels.kde_sampler.ops", "signed_endpoint_stat"),
    ("core.sampling.walks", "random_walks"),
    ("core.sampling.walks", "endpoint_counts"),
    ("core.cluster.local", "same_cluster_test"),
    ("core.cluster.local", "l2_distance_statistic"),
    ("core.graph.triangles", "estimate_triangle_weight"),
    ("core.graph.triangles", "exact_triangle_weight"),
    ("core.graph.arboricity", "estimate_arboricity"),
    ("core.graph.arboricity", "exact_arboricity"),
    ("core.graph.arboricity", "greedy_densest_subgraph"),
    ("core.laplacian", "project_ones"),
    ("core.laplacian", "cg_laplacian"),
    ("core.laplacian", "solve_kernel_laplacian"),
    ("core.laplacian", "laplacian_dense"),
    ("core.laplacian", "normalized_laplacian_dense"),
    ("core.eigen", "power_method"),
    ("core.eigen", "top_eigenvalue"),
    ("core.eigen", "top_eigenvalue_exact"),
    ("core.spectrum", "estimate_return_moments"),
    ("core.spectrum", "invert_moments"),
    ("core.spectrum", "approximate_spectrum"),
    ("core.spectrum", "exact_spectrum"),
    ("core.spectrum", "emd_1d"),
    ("core.cluster.spectral", "laplacian_eigenvectors"),
    ("core.cluster.spectral", "kmeans"),
    ("core.cluster.spectral", "spectral_cluster"),
    ("core.cluster.spectral", "cluster_accuracy"),
    ("core.serving", "shape_bucket"),
    ("core.serving", "Request"),
    ("core.serving", "ServedTenant"),
    ("core.serving", "KernelGraphServable"),
    ("kernels.kde_hash.ops", "stack_hash_states"),
    ("obs.counters", "counter"),
    ("obs.counters", "fold_status"),
    ("obs.counters", "status_of"),
    ("obs.counters", "is_word"),
    ("obs.metrics", "Histogram"),
    ("obs.metrics", "histogram"),
    ("obs.metrics", "observe"),
    ("obs.metrics", "span"),
    ("obs.metrics", "Timer"),
    ("obs.metrics", "event"),
    ("obs.export", "emit_jsonl"),
    ("obs.export", "telemetry_block"),
    ("obs.export", "validate_metrics_line"),
    ("obs.export", "validate_telemetry_block"),
    ("obs.export", "prometheus_text"),
    ("ft.guards", "raise_per_request"),
    ("ft.guards", "totals_status"),
    ("ft.guards", "checked"),
    ("ft.watchdog", "HostStats"),
    ("ft.watchdog", "Watchdog"),
    ("ft.chaos", "corrupt_hash_state"),
    ("ft.chaos", "silent_hosts"),
    ("ft.chaos", "run_scenario"),
    ("ft.chaos", "run_all"),
    ("launch.serve", "run_graph_stream"),
    ("launch.serve", "run_multi_tenant"),
    ("train.train_step", "cross_entropy"),
    ("train.train_step", "loss_fn"),
    ("train.train_step", "make_train_step"),
    ("train.optimizer", "AdamWConfig"),
    ("train.optimizer", "init_adamw"),
    ("train.optimizer", "adamw_update"),
    ("train.optimizer", "global_norm"),
    ("train.optimizer", "compress"),
    ("train.optimizer", "decompress"),
    ("train.optimizer", "compressed_psum"),
    ("ckpt.checkpoint", "save"),
    ("ckpt.checkpoint", "restore"),
    ("ckpt.checkpoint", "latest_step"),
    ("launch.train", "main"),
]


def _params(fn):
    """(name, kind) of every parameter but ``**kwargs``, in order."""
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()
            if p.kind is not inspect.Parameter.VAR_KEYWORD]


@pytest.mark.parametrize("module,name", ENTRY_POINTS,
                         ids=[n for _, n in ENTRY_POINTS])
def test_reference_parameters_are_a_prefix(module, name):
    """The reference's parameters, names and kinds, open the port's."""
    ref = _params(getattr(importlib.import_module("repro." + module), name))
    port = _params(getattr(importlib.import_module("repro_torch." + module),
                           name))
    assert port[:len(ref)] == ref, (ref, port)
    for pname, kind in port[len(ref):]:
        assert kind in (inspect.Parameter.KEYWORD_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD), pname


#: the kernel programs that take explicit noise where the reference takes a
#: key: their positional noise parameters differ by design (module note),
#: so they are held by their keywords
NOISE_PROGRAMS = [("kernels.kde_sampler.ops", n) for n in (
    "masked_block_sums", "fused_sample", "fused_edge_batch",
    "edge_batch_scan", "walk_scan", "triangle_edge_scan",
    "batched_fused_sample", "batched_walk_scan", "batched_prob_of",
    "batched_kde_query")] + [("kernels.kde_hash.ops", "batched_hashed_query")]
#: the reference's implementation switches, which the noise programs drop:
#: the port chooses the kernel by the tensor's device and sizes its tiles.
#: ``pairwise`` is not one: it is a custom kernel's function, a required
#: keyword of every noise program (ROADMAP.md section 3, F3)
SWITCHES = ("use_pallas", "interpret", "bm")
#: keywords a program reads off its explicit noise instead
NOISE_SHAPED = {"fused_edge_batch": ("batch",)}


@pytest.mark.parametrize("module,name", NOISE_PROGRAMS,
                         ids=[n for _, n in NOISE_PROGRAMS])
def test_noise_programs_take_the_reference_keywords(module, name):
    """Every keyword-only parameter of the reference's program but its
    implementation switches (and a keyword the port reads off its noise,
    ``NOISE_SHAPED``) is a keyword-only parameter of the port's, with the
    same default (``num_far=64`` among them)."""
    ref = inspect.signature(getattr(
        importlib.import_module("repro." + module), name)).parameters
    port = inspect.signature(getattr(
        importlib.import_module("repro_torch." + module), name)).parameters
    for p in ref.values():
        if p.kind is not inspect.Parameter.KEYWORD_ONLY or p.name in \
                SWITCHES + NOISE_SHAPED.get(name, ()):
            continue
        assert p.name in port, p.name
        assert port[p.name].kind is inspect.Parameter.KEYWORD_ONLY, p.name
        assert port[p.name].default == p.default, (p.name, p.default,
                                                   port[p.name].default)


#: (name, port default) pairs allowed to differ from the reference's
#: default: the implementation switches are None in the port
#: (``device.no_switch``: the device chooses), and ``pairwise`` (the
#: reference's jnp pair function, required there) is an optional argument
#: of the port's helper programs (``hashed_query``,
#: ``sample_from_block_sums``, ...); the noise programs require it, as the
#: reference does (``test_noise_programs_take_the_reference_keywords``)
DEFAULT_EXCEPTIONS = {("use_pallas", None), ("interpret", None),
                      ("pairwise", None),
                      # roofline_terms: the port's device spec (the H100)
                      # where the reference defaults to its TPU spec
                      ("spec", None),
                      # sweep_blocks_per_tile: the bf16 sweep's column
                      # budget re-derived for the H100's L2 (4096) where
                      # the reference's is its host's knee (2048)
                      ("target_cols", 4096)}


def _ported_modules():
    """Dotted names (under ``repro`` / ``repro_torch``) of every port
    module that has a reference twin at the same path."""
    src = ROOT / "src"
    out = []
    for path in sorted((src / "repro_torch").rglob("*.py")):
        rel = path.relative_to(src / "repro_torch")
        if (src / "repro" / rel).exists():
            parts = rel.with_suffix("").parts
            out.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                else parts))
    return out


def _same_default(ref, port):
    """Defaults equal, a JAX dtype matching the torch dtype of its name,
    NaN matching NaN (``chaos.nan_rows(value=np.nan)``)."""
    if isinstance(ref, float) and isinstance(port, float) \
            and np.isnan(ref) and np.isnan(port):
        return True
    if isinstance(port, torch.dtype):
        return np.dtype(ref).name == str(port).removeprefix("torch.")
    if dataclasses.is_dataclass(ref) and dataclasses.is_dataclass(port):
        # ``make_train_step(adamw=AdamWConfig())``: each package's class
        return type(ref).__name__ == type(port).__name__ \
            and dataclasses.asdict(ref) == dataclasses.asdict(port)
    try:
        return bool(ref == port)
    except (TypeError, ValueError):
        return ref is port


@pytest.mark.parametrize("module", _ported_modules())
def test_shared_keywords_keep_the_reference_defaults(module):
    """Every public function and class that a ported module and its
    reference twin both define gives every parameter they share the
    reference's default (the F1 fault was a default: ``num_far=1`` where
    the reference has 64), but for ``DEFAULT_EXCEPTIONS``."""
    tm = importlib.import_module("repro_torch" + (module and "." + module))
    rm = importlib.import_module("repro" + (module and "." + module))
    empty = inspect.Parameter.empty
    for name, obj in vars(tm).items():
        ref = getattr(rm, name, None)
        if name.startswith("_") or not callable(obj) or not callable(ref) \
                or getattr(obj, "__module__", None) != tm.__name__:
            continue
        try:
            rs, ts = inspect.signature(ref), inspect.signature(obj)
        except (TypeError, ValueError):
            continue
        for p in rs.parameters.values():
            q = ts.parameters.get(p.name)
            if q is None or (p.default is empty and q.default is empty):
                continue
            if (p.name, q.default) in DEFAULT_EXCEPTIONS:
                continue
            assert p.default is not empty and q.default is not empty \
                and _same_default(p.default, q.default), (
                    f"{module}.{name}({p.name}=): reference {p.default!r}, "
                    f"port {q.default!r}")


#: reference names with no port twin by design: the TPU's Pallas bodies,
#: their specs and switch, and JAX's shard_map shim.  Each maps to (why,
#: the port's counterpart as "module:attr" under ``repro_torch``).
TPU_ONLY = {
    **{f"kernels.{mod}.kernel.{name}_pallas": (
        "a Pallas body; the port launches its CUDA twin by device",
        f"kernels.{mod}.kernel:{cuda}")
       for mod, name, cuda in (
           ("flash_attention", "flash_attention", "flash_attention_cuda"),
           ("kde_attention", "block_lse", "kde_decode_cuda"),
           ("kde_hash", "weighted_kv_sum", "weighted_kv_sum_cuda"),
           ("kde_hash", "weighted_kv", "weighted_kv_cuda"),
           ("kde_rowsum", "rowsum", "rowsum_cuda"),
           ("kde_rowsum", "blocksum", "blocksum_cuda"),
           ("kde_sampler", "masked_blocksum", "masked_blocksum_cuda"),
           ("kde_sampler", "sample_block", "sample_block_cuda"))},
    "kernels.kde_rowsum.kernel.exp_table_spec": (
        "a Pallas BlockSpec of the bf16 exp table; every CUDA launch takes "
        "the table's pointer", "kernels.kde_rowsum.kernel:exp_table_ptr"),
    "kernels.kde_rowsum.kernel.exp_table_operand": (
        "the exp table as a Pallas operand; the table on a device is "
        "cached once", "kernels.kde_sampler.ref:exp_table_on"),
    "kernels.kde_sampler.ops.default_use_pallas": (
        "the use_pallas switch; the port dispatches by the tensor's device "
        "and takes use_pallas=None only", "device:no_switch"),
    "compat.shard_map": (
        "JAX's shard_map shim; the port's mesh programs are explicit SPMD "
        "over torch.distributed", "distributed.collectives:all_reduce"),
    "kernels.tuning.VMEM_BUDGET": (
        "a TPU core's VMEM budget; the port's tiles fit the shared memory "
        "one CTA may opt in to", "kernels.tuning:SMEM_BUDGET"),
}
#: reference names still to port, each under the ROADMAP.md queue 1 item
#: that ports it (none since queue 1 item 11, the last to hold any)
PENDING = {}
#: the last queue 1 item that held ``PENDING`` names
LAST_PENDING_ITEM = 11


def _top_nodes(body):
    """Top-level statements, through ``try`` / ``if`` blocks."""
    for node in body:
        if isinstance(node, ast.Try):
            for part in (node.body, *(h.body for h in node.handlers),
                         node.orelse, node.finalbody):
                yield from _top_nodes(part)
        elif isinstance(node, ast.If):
            yield from _top_nodes(node.body)
            yield from _top_nodes(node.orelse)
        else:
            yield node


def _public_names(module):
    """Public top-level functions and classes of the reference module
    (read from its source) and each class's public methods, as
    ``name`` / ``Class.method``."""
    rel = Path(*module.split(".")) if module else Path()
    path = ROOT / "src" / "repro" / rel.with_suffix(".py")
    if not path.exists():
        path = ROOT / "src" / "repro" / rel / "__init__.py"
    out = []
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    for node in _top_nodes(ast.parse(path.read_text()).body):
        if not isinstance(node, defs) or node.name.startswith("_"):
            continue
        out.append(node.name)
        if isinstance(node, ast.ClassDef):
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, defs[:2]) and not m.name.startswith("_")]
    return list(dict.fromkeys(out))


def _lookup(root: str, dotted: str, name: str):
    """``name`` (``a`` or ``A.b``) of module ``root.dotted``, or None."""
    try:
        obj = importlib.import_module(root + (dotted and "." + dotted))
    except ModuleNotFoundError:
        return None
    for part in name.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


@pytest.mark.parametrize("module", _ported_modules() + ["compat"])
def test_every_public_reference_name_has_its_port(module):
    """Name-by-name parity: every public top-level function and class of a
    reference module, and every public method of its classes, exists in
    the port's twin module (by ``getattr`` after import, so re-exports
    count), unless ``TPU_ONLY`` or ``PENDING`` lists it."""
    names = _public_names(module)
    missing = [n for n in names
               if f"{module}.{n}" not in TPU_ONLY
               and f"{module}.{n}" not in PENDING
               and _lookup("repro_torch", module, n) is None]
    assert not missing, (module, missing)


@pytest.mark.parametrize("entry", sorted(TPU_ONLY))
def test_tpu_only_names_name_their_counterpart(entry):
    """A ``TPU_ONLY`` name is a reference name the port lacks, and the
    counterpart it names exists in the port."""
    module, _, name = entry.rpartition(".")
    assert _lookup("repro", module, name) is not None, entry
    assert _lookup("repro_torch", module, name) is None, \
        f"{entry} is ported now: take it out of TPU_ONLY"
    reason, where = TPU_ONLY[entry]
    mod, attr = where.split(":")
    assert reason and _lookup("repro_torch", mod, attr) is not None, where


@pytest.mark.parametrize("entry", sorted(PENDING) or [None])
def test_pending_names_head_a_roadmap_item(entry):
    """A ``PENDING`` name is a reference name the port lacks, under a
    queue 1 item of ROADMAP.md: its number heads exactly one queue 1 line
    (``N. **``).  With ``PENDING`` empty (the None case, so the test never
    turns into a skip), ``LAST_PENDING_ITEM`` heads exactly one queue 1
    line and it is a "Done in PR" stub."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. Modules to port"):
                 text.index("### 2. TPU kernels to port")]
    if entry is None:
        assert not PENDING
        lines = [ln for ln in queue.splitlines()
                 if ln.startswith(f"{LAST_PENDING_ITEM}. **")]
        assert len(lines) == 1 and lines[0].startswith(
            f"{LAST_PENDING_ITEM}. **Done in PR"), lines
        return
    module, _, name = entry.rpartition(".")
    assert _lookup("repro", module, name) is not None, entry
    assert _lookup("repro_torch", module, name) is None, \
        f"{entry} is ported now: take it out of PENDING"
    item = PENDING[entry]
    assert len([ln for ln in queue.splitlines()
                if ln.startswith(f"{item}. **")]) == 1, item


def test_hashed_level1_read_counts_as_the_reference_by_default():
    """ROADMAP.md's F1 reproduction: the hashed level-1 read of a
    16-vertex frontier with ``num_far`` left at its default (n = 1024, d =
    4, N(0, 1) from ``default_rng(0)``, gaussian(1.0), the hash layout of
    seed 0, blocks of 32, s = 16) counts what the reference counts: 64 FAR
    slots a block, ``evals`` 36,864 and ``far_samples`` 32,768.  The
    port's noise comes from ``draw_sample_noise`` at its default."""
    from repro.core.kernels_fn import gaussian as jgaussian
    from repro.kernels.kde_hash import ops as jhops
    from repro.kernels.kde_sampler import ops as jops
    from repro.obs import counters as jc
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_hash import ops as thops
    from repro_torch.kernels.kde_sampler import ops as tops
    from repro_torch.obs import counters as tc
    import jax
    x = np.random.default_rng(0).normal(size=(1024, 4)).astype(np.float32)
    src = np.arange(0, 1024, 64)
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, pairwise=None,
               block_size=32, num_blocks=32, n=1024, s=16, exact=False,
               level1="hash")
    jstate, _ = jhops.build_hash_state(x, jgaussian(1.0), seed=0)
    _, jword = jops.masked_block_sums(
        jnp.asarray(x), None, jnp.asarray(src.astype(np.int32)),
        jax.random.PRNGKey(0), jstate, **cfg)
    tstate, _ = thops.build_hash_state(x, gaussian(1.0), seed=0,
                                       device="cpu")
    noise, _, _ = tops.draw_sample_noise(
        len(src), 32, torch.Generator().manual_seed(0), "cpu",
        level1="hash", exact=False, block_size=32)
    assert noise.shape == (len(src), 32, 64)
    _, tword = tops.masked_block_sums(
        torch.as_tensor(x), None, torch.as_tensor(src), noise, tstate,
        **cfg)
    want, got = jc.totals(np.asarray(jword)), tc.totals(tword)
    assert (want["evals"], want["far_samples"]) == (36864, 32768), want
    assert got == want


def _x(n=64, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


K = make_kernel("gaussian", 1.0)
#: a reduced dense config in the port's f32 (bf16 configs raise)
CFG = dataclasses.replace(get_reduced("yi_6b"), dtype="float32")


def _t(a):
    return torch.as_tensor(a)


def _qkv_attention():
    q = _t(_x(2 * 4, 16, 1).reshape(1, 4, 2, 16))
    k = _t(_x(2 * 32, 16, 2).reshape(1, 2, 32, 16))
    return q, k, k.clone()


def _forward(**kw):
    """``forward`` of a reduced yi-6b on 8 tokens, with keywords ``kw``."""
    model = init_params(CFG, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (1, 8))
    return forward(model, CFG, {"tokens": toks}, **kw)[0]


#: one call per placeholder with a non-default value, and what it raises
PLACEHOLDERS = {
    "kde_rowsum.bm": (lambda: kde_rowsum(_t(_x()), _t(_x()), K, 0),
                      ValueError),
    "kde_rowsum.bn": (lambda: kde_rowsum(_t(_x()), _t(_x()), K, None, -2),
                      ValueError),
    "kde_rowsum.interpret": (
        lambda: kde_rowsum(_t(_x()), _t(_x()), K, None, None, True),
        ValueError),
    "kde_blocksum.bm": (lambda: kde_blocksum(_t(_x()), _t(_x()), K, 1.5),
                        ValueError),
    "kde_blocksum.interpret": (
        lambda: kde_blocksum(_t(_x()), _t(_x()), K, 128, 256, False),
        ValueError),
    "flash_attention.interpret": (
        lambda: tfa.flash_attention(*_qkv_attention(), True, 128, 128, True),
        ValueError),
    "kde_attention.interpret": (
        lambda: kde_attention(*_qkv_attention()[:1],
                              *[t.reshape(1, 2, 32, 16)
                                for t in _qkv_attention()[1:]],
                              top_p=1, bk=16, stride=2, interpret=True),
        ValueError),
    "ExactKDE.chunk": (lambda: ExactKDE(_x(), K, 0, device="cpu"),
                       ValueError),
    "ExactKDE.use_pallas": (
        lambda: ExactKDE(_x(), K, 4096, True, device="cpu"), ValueError),
    "ExactBlockKDE.use_pallas": (
        lambda: ExactBlockKDE(_x(), K, 16, False, device="cpu"), ValueError),
    "HashedKDE.use_pallas": (
        lambda: HashedKDE(_x(), K, None, 8, 64, 256, 0, True, device="cpu"),
        ValueError),
    "HashedKDE.interpret": (
        lambda: HashedKDE(_x(), K, None, 8, 64, 256, 0, None, True,
                          device="cpu"), ValueError),
    # tree mode is ported: the 7th positional is its tree, which the
    # reference's tree mode requires (ValueError, its assert's message)
    "NeighborSampler.tree": (
        lambda: NeighborSampler(_x(), K, "tree", None, 16, True, None,
                                device="cpu"), ValueError),
    "NeighborSampler.use_pallas": (
        lambda: NeighborSampler(_x(), K, "blocked", None, 16, True, None, 0,
                                True, device="cpu"), ValueError),
    "NeighborSampler.interpret": (
        lambda: NeighborSampler(_x(), K, "blocked", None, 16, True, None, 0,
                                None, True, device="cpu"), ValueError),
    # ported with the LM's sharded state: a ``shardings=`` without the
    # template's structure is refused before any file is read
    "restore.shardings": (
        lambda: ckpt_restore("/nonexistent", None, 1, {}),
        TypeError),
    "kv_block_sums_bf16.blocks_per_tile": (
        lambda: kv_block_sums_bf16(_t(_x()), _t(_x()), "gaussian", 1.0, 1.0,
                                   16, 0), ValueError),
}


#: former placeholders the mesh slice ported: each runs by position on a
#: one-rank gloo group (``torch_mesh_ranks.signature_cases``) and must
#: count the single-device call's kernel evaluations
FORMER_MESH_PLACEHOLDERS = (
    "HashedKDE.data_axes", "NeighborSampler.data_axes",
    "RowNormSampler.data_axes", "same_cluster_test.mesh",
    "estimate_triangle_weight.mesh", "estimate_arboricity.mesh",
    "top_eigenvalue.mesh", "approximate_spectrum.mesh")


@pytest.fixture(scope="module")
def mesh_placeholder_run(tmp_path_factory):
    import torch_mesh_ranks
    return torch_mesh_ranks.spawn("signature_cases", 1,
                                  tmp_path_factory.mktemp("sig"),
                                  dict(x=_x()))[0]


@pytest.mark.parametrize("case", FORMER_MESH_PLACEHOLDERS)
def test_former_mesh_placeholder_runs_on_one_rank(case,
                                                  mesh_placeholder_run):
    """A former mesh placeholder's non-default value no longer refuses: on
    a one-rank gloo group (a mesh with that dim, or ``data_axes`` naming
    the mesh's dims) the call counts exactly the single-device call's
    kernel evaluations."""
    mesh_evals, flat_evals = mesh_placeholder_run[case]
    assert mesh_evals == flat_evals > 0


#: former placeholders the training and families slices ported: (arch,
#: entry point, keywords) of one call each, held to the reference's
FORMER_PLACEHOLDERS = {
    "forward.remat": ("yi_6b", "forward", dict(remat=False)),
    "forward.remat_policy": ("yi_6b", "forward",
                             dict(remat=True, remat_policy="dots")),
    "forward.seq_mixer": ("rwkv6_3b", "forward", dict(seq_mixer="scan")),
    "make_prefill_step.seq_mixer": ("zamba2_7b", "prefill",
                                    dict(seq_mixer="scan")),
    "make_train_step.seq_mixer": ("rwkv6_3b", "train",
                                  dict(seq_mixer="scan", remat=False)),
    "init_cache.enc_len": ("seamless_m4t_medium", "init_cache",
                           dict(enc_len=4)),
}


@pytest.mark.parametrize("case", sorted(FORMER_PLACEHOLDERS))
def test_former_placeholder_matches_the_reference(case):
    """A former placeholder's non-default value no longer refuses: the
    reference's own weights give the reference's result with the same
    keywords -- ``forward(remat=False)``, ``forward(remat_policy="dots")``
    (under ``torch.enable_grad`` so the checkpointed path runs) and
    ``forward(seq_mixer="scan")`` the logits, the prefill step its last
    position, the train step its loss (rtol 1e-5 of the largest logit /
    the loss), ``init_cache(enc_len=4)`` the enc-dec memory's shape and
    dtype."""
    import jax
    from repro.configs.base import get_reduced as jreduced
    from repro.models import transformer as JT
    from repro.train import train_step as JS
    from repro_torch import convert
    from repro_torch.data.pipeline import make_batch
    arch, entry, kw = FORMER_PLACEHOLDERS[case]
    jc = dataclasses.replace(jreduced(arch), dtype="float32")
    tc = dataclasses.replace(get_reduced(arch), dtype="float32")
    if entry == "init_cache":
        got = init_cache(tc, 2, 8, torch.float32, kw["enc_len"],
                         device="cpu")["memory"]
        want = JT.init_cache(jc, 2, 8, jnp.float32, kw["enc_len"])["memory"]
        assert tuple(got.shape) == want.shape == (2, 4, tc.d_model)
        assert got.dtype == torch.float32
        return
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tc, device="cpu")
    batch = make_batch(tc, ShapeConfig("t", 8, 1, "train"), 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if entry == "train":
        want, _ = jax.jit(lambda p: JS.loss_fn(p, jc, jb, **kw))(params)
        _, _, metrics = make_train_step(tc, **kw)(
            model, init_adamw(model), batch)
        np.testing.assert_allclose(float(metrics["loss"] + 0.01 *
                                         metrics["aux"]), float(want),
                                   rtol=1e-5)
        return
    want = np.asarray(jax.jit(lambda p: JT.forward(p, jc, jb, **kw)[0])(
        params))
    if entry == "prefill":
        got = make_prefill_step(tc, **kw)(model, batch)
        want = want[:, -1:]
    else:
        with torch.enable_grad():
            got = forward(model, tc, batch, **kw)[0]
        assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_forward_keeps_the_reference_keywords():
    """``forward``'s parameters after the first (the reference's
    ``params``, the port's ``model``: the module note's swap) are the
    reference's, with its kinds and defaults."""
    from repro.models import transformer as JT
    ref = list(inspect.signature(JT.forward).parameters.values())[1:]
    port = list(inspect.signature(forward).parameters.values())[1:]
    assert [(p.name, p.kind, p.default) for p in port[:len(ref)]] == \
        [(p.name, p.kind, p.default) for p in ref]


@pytest.mark.parametrize("case", sorted(PLACEHOLDERS))
def test_placeholder_refuses_a_non_default_value(case):
    call, exc = PLACEHOLDERS[case]
    param = case.split(".")[1]
    with pytest.raises(exc, match=param):
        call()


def test_placeholders_at_their_defaults_change_nothing():
    """Tile sizes of any positive value and None switches give the same
    answers as the defaults, by position as the reference binds them."""
    q, x = _t(_x(20, 8, 1)), _t(_x(70, 8, 2))
    want = rs_k.rowsum_plain(q, x, "gaussian", 1.0)
    torch.testing.assert_close(kde_rowsum(q, x, K, 7, 33, None, "f32"), want)
    est = ExactKDE(x, K, 13, None, "f32", device="cpu")
    torch.testing.assert_close(est.query(q), want)
    blk = ExactBlockKDE(x, K, 16, None, "f32", device="cpu")
    torch.testing.assert_close(blk.query(q), want, rtol=2e-6, atol=2e-6)
    nbr = NeighborSampler(_x(), K, "blocked", 16, 16, True, None, 3, None,
                          None, None, ("data",), device="cpu")
    assert shared_level1_estimator(nbr, "exact", 5) is nbr.blocks
    cache = init_cache(CFG, 1, 8, torch.float32, 0,
                       device="cpu")
    assert cache["k"].shape[3] == 8
    torch.testing.assert_close(
        _forward(remat=True, seq_mixer="chunked", remat_policy="none"),
        _forward(), rtol=0, atol=0)
    # honoured exactly: a tile of any width sums each block alike, and the
    # reference's exp-table operand is the table the bf16 path reads
    want = kv_block_sums_bf16(q, x, "gaussian", 1.0, 1.0, 16)
    for t in (1, 3, 100):
        torch.testing.assert_close(
            kv_block_sums_bf16(q, x, "gaussian", 1.0, 1.0, 16, t), want,
            rtol=0, atol=0)
    xr = x[:60].reshape(20, 3, 8)
    want = rowwise_kv(q, xr, "gaussian", 1.0, 1.0, None, "bf16")
    torch.testing.assert_close(
        rowwise_kv(q, xr, "gaussian", 1.0, 1.0, None, "bf16",
                   exp_table_on("cpu")), want, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["NeighborSampler", "spectral_sparsify"])
def test_samples_per_block_binds_by_position(entry):
    """A positional 8 in the reference's place of ``samples_per_block``
    sets the stratified read's rows a block: ``kernel_evals`` follows the
    reference's formula at s = 8 and at the default 16 (n = 64: block
    size 16, B = 4; B s evals a level-1 row)."""
    x, n, bs, nb = _x(), 64, 16, 4
    if entry == "NeighborSampler":
        src = np.arange(10)

        def evals(*spb):
            nbr = NeighborSampler(x, K, "blocked", None, *spb, device="cpu")
            nbr.sample(src)
            return nbr.evals

        def want(s):
            return len(src) * (nb * s + bs)
    else:
        t, batch = 64, 32

        def evals(*spb):
            return spectral_sparsify(x, K, t, "stratified", 0, batch, False,
                                     *spb, device="cpu").kernel_evals

        def want(s):
            return n * nb * s + t * (nb * s + bs + 1)
    assert evals(8) == want(8)
    assert evals() == evals(16) == want(16) != want(8)


def test_kde_blocksum_binds_bm_by_position():
    """``kde_blocksum(q, x, k, 128)`` binds ``bm=128``, as the reference
    does: the width stays ceil(n / 256), not ceil(n / 128)."""
    q, x = _t(_x(20, 4, 1)), _t(_x(512, 4, 2))
    got = kde_blocksum(q, x, K, 128)
    assert tuple(got.shape) == (20, 2)
    torch.testing.assert_close(
        got, rs_k.blocksum_plain(q, x, "gaussian", 1.0, 1.0, 256))


def test_flash_attention_binds_interpret_by_position():
    """``flash_attention(q, k, v, True, 128, 128, None)`` returns one
    tensor, equal to the reference's interpret run, not (out, lse)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 64, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 64, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 64, 16)).astype(np.float32)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), True, 128, 128, None)
    assert isinstance(got, torch.Tensor)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), True, 128, 128, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("item", sorted(ROADMAP_ITEMS))
def test_refusals_name_their_roadmap_item_by_title(item):
    """A refusal names its ROADMAP.md queue 1 item by number and title,
    and the queue's item of that number carries that title: a renumbered
    queue fails here instead of leaving stale numbers in the messages."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. Modules to port"):
                 text.index("### 2. TPU kernels to port")]
    heads = [ln for ln in queue.splitlines() if ln.startswith(f"{item}. **")]
    assert len(heads) == 1, heads
    assert ROADMAP_ITEMS[item].lower() in heads[0].lower(), heads
    assert f"queue 1 item {item}, {ROADMAP_ITEMS[item]}" in str(
        not_in_slice("x", item))


def test_every_refusal_names_a_listed_item():
    """No ``not_in_slice(what, item)`` call is left in the port: the
    context-parallel prefill slice ported the last three refusals (queue
    1 item 14: ``activation_sharding(seq_mode=True)``, ``dryrun.
    lower_cell(seq_mode_prefill=True)`` and ``dryrun --seq-mode-prefill``;
    the count fell from 19 after the families slice and 3 after the mesh
    slice).  A refusal added later must still pass a literal item number
    that ``ROADMAP_ITEMS`` lists, and the items the old refusals named
    stay listed (the test above finds each one's title in ROADMAP.md)."""
    calls, items = 0, set()
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "not_in_slice":
                item = node.args[1]
                assert isinstance(item, ast.Constant) \
                    and item.value in ROADMAP_ITEMS, (path, node.lineno)
                calls += 1
                items.add(item.value)
    assert calls == 0 and not items
    assert {6, 7, 8, 9, 10, 12, 14} <= set(ROADMAP_ITEMS)


@pytest.mark.parametrize("flag", [["--robust"], ["--graph-stream", "64"],
                                  ["--serve-tenants", "2"]])
def test_serve_help_names_the_item_its_refusal_names(flag, monkeypatch):
    """serve's help texts name no ROADMAP item: every serve mode is ported.
    The graph-serving modes (queue 1 item 9) run through ``main``;
    ``--robust`` (queue 1 item 12, the families slice) runs in ``run_lm``
    and reports its fallback count (0 on a healthy model; xla serving is
    never screened, as the reference's driver)."""
    from repro_torch.launch import serve
    ap = serve.parser()
    helps = {a.option_strings[0]: a.help for a in ap._actions
             if a.option_strings}
    assert "ROADMAP" not in helps[flag[0]], helps[flag[0]]
    if flag[0] != "--robust":
        mode = {"--graph-stream": "run_graph_stream",
                "--serve-tenants": "run_multi_tenant"}[flag[0]]
        ran = []
        monkeypatch.setattr(serve, mode, lambda args: ran.append(args) or 7)
        assert serve.main(["--device", "cpu", *flag]) == 7 and len(ran) == 1
        return
    base = ["--device", "cpu", "--reduced", "--batch", "1", "--prompt-len",
            "4", "--gen", "2", *flag]
    res = serve.run_lm(ap.parse_args(base + ["--attention", "kde",
                                             "--kde-bk", "8"]))
    assert res["fallbacks"] == 0
    assert serve.run_lm(ap.parse_args(base))["fallbacks"] is None
