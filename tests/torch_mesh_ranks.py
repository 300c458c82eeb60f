"""Rank programs of the mesh tests (``tests/test_torch_mesh*.py``).

The tests spawn the ranks of a gloo group as separate processes
(``start_method="spawn"``, a ``FileStore`` under the test's ``tmp_path``,
one thread a rank, a group timeout); each rank runs one program of this
module on ``"cpu"`` meshes and writes its result for the test process,
which holds it against the JAX reference.  This module imports torch,
numpy and ``repro_torch`` only -- never JAX: the ranks run the port as a
user would.
"""
from __future__ import annotations

import datetime
import os
import sys
import time
import traceback

import numpy as np
import torch

#: seconds a spawned group may take before its test fails
GROUP_TIMEOUT = 120


def spawn(program: str, world: int, tmp_path, payload=None,
          timeout: float = GROUP_TIMEOUT):
    """Run ``program(rank, world, payload)`` on ``world`` spawned gloo ranks
    and return their results, rank by rank.  Fails (AssertionError) when a
    rank raises or the group outlives ``timeout`` seconds; no rank is left
    running."""
    import torch.multiprocessing as mp
    out = os.path.join(str(tmp_path), f"mesh_{program}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    ctx = mp.start_processes(
        _entry, args=(world, store, program, payload, out, timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"mesh group {program!r} of {world} ranks ran past "
                    f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn_async(program: str, world: int, tmp_path, payload=None,
                timeout: float = GROUP_TIMEOUT):
    """``spawn`` started in the background: returns a callable that waits
    for the ranks and returns their results (the test process works on
    its reference side meanwhile)."""
    import threading
    box = {}

    def go():
        try:
            box["res"] = spawn(program, world, tmp_path, payload, timeout)
        except BaseException as e:           # noqa: BLE001 -- re-raised
            box["err"] = e
    th = threading.Thread(target=go, daemon=True)
    th.start()

    def wait():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["res"]
    return wait


def _entry(rank, world, store, program, payload, out, timeout):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        res = globals()[program](rank, world, payload)
    except BaseException:
        traceback.print_exc(file=sys.stderr)
        raise
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #
def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _counts(fn, *args, **kw):
    from repro_torch.kernels.kde_sampler import sharded as sh
    out = {}
    cc = sh.collective_counts(lambda: out.setdefault("r", fn(*args, **kw)))
    return out["r"], cc


# --------------------------------------------------------------------- #
# programs
# --------------------------------------------------------------------- #
def engine(rank, world, pl):
    """Checks 1-3 and 6: the functional API on two 2-D meshes, the block
    sums, ``ShardedBlocks`` at n = 250 on an (8,) mesh fed the oracle's
    uniforms, the counted schedules, the noisy power method and the
    sharded hash table."""
    from repro_torch.core.kde import distributed as D
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_hash.sharded import ShardedHashTable
    from repro_torch.kernels.kde_sampler import ops as sops
    from repro_torch.kernels.kde_sampler import sharded as sh
    ker = gaussian(1.0)
    res = {}
    x, y = torch.as_tensor(pl["x"]), torch.as_tensor(pl["y"])
    dm = _mesh((4, 2), ("data", "model"))
    pd = _mesh((4, 2), ("pod", "data"))
    m8 = _mesh((8,), ("data",))
    xs = D.make_sharded_dataset(dm, x)
    res["kde_query"], res["kde_query_cc"] = _counts(
        D.sharded_kde_query(dm, ker), y, xs)
    res["degrees_dm"] = D.degree_preprocessing(dm, ker)(xs)
    xs2 = D.make_sharded_dataset(pd, x, data_axes=("pod", "data"))
    res["degrees_pd"], res["degrees_pd_cc"] = _counts(
        D.degree_preprocessing(pd, ker, data_axes=("pod", "data")), xs2)
    yb = torch.as_tensor(pl["y_blocks"])
    res["blocks_aligned"] = D.sharded_block_sums(dm, ker, 4)(yb, xs)
    res["blocks_ragged"] = D.sharded_block_sums(dm, ker, 5)(
        torch.as_tensor(pl["y_ragged"]), xs)
    src = torch.as_tensor(pl["own_src"])
    xs8 = D.make_sharded_dataset(m8, x)
    res["blocks_own"] = D.sharded_block_sums(m8, ker, 2)(
        x[src], xs8, own=src // 16)
    res["blocks_own_flat"] = sops.masked_block_sums(
        x, torch.sum(x * x, -1), src, kind="gaussian", inv_bw=1.0, beta=1.0,
        pairwise=None, block_size=16, num_blocks=16, n=256, s=16,
        exact=True)[0]
    # ShardedBlocks at n = 250 (ragged) on the (8,) mesh
    xe = torch.as_tensor(pl["xe"])
    esrc = torch.as_tensor(pl["src"])
    for exact in (True, False):
        eng = sh.ShardedBlocks(m8, xe, ker, block_size=16, exact=exact,
                               samples_per_block=8)
        tag = "exact" if exact else "strat"
        l1 = None if exact else torch.as_tensor(pl[f"l1_{tag}"])
        (nb, prob, sums, cw), cc = _counts(
            eng.fused_sample, esrc, l1, torch.as_tensor(pl[f"u_{tag}"]))
        res[f"fused_{tag}"] = (nb, prob, sh.all_gather(sums, eng.grp, 1),
                               cw, cc)
        res["x_pad"] = eng.x_rep
    eng = sh.ShardedBlocks(m8, xe, ker, block_size=16, exact=True)
    wnoise = [(None, torch.as_tensor(u)[None], None) for u in pl["walk_u"]]
    (end, _, wcw, wfb), res["walk_cc"] = _counts(eng.walk_scan, esrc, wnoise)
    res["walk"] = (end, wcw, wfb)
    res["masked_exact"] = sh.all_gather(eng.masked_block_sums(esrc)[0],
                                        eng.grp, 1)
    res["masked_exact_flat"] = sops.masked_block_sums(
        xe, torch.sum(xe * xe, -1), esrc, kind="gaussian", inv_bw=1.0,
        beta=1.0, pairwise=None, block_size=16, num_blocks=16, n=250, s=16,
        exact=True)[0]
    # the counted schedule of each batched program
    g = torch.Generator().manual_seed(5)
    degs = torch.as_tensor(pl["degs"])
    cdf = torch.as_tensor(pl["cdf"])
    u, v = esrc[:40], (esrc[:40] + 7) % 250
    cc = {}
    for name, fn in [
            ("draw", lambda: eng.fused_sample(esrc, None,
                                              eng.draw_noise(64, g))),
            ("walk_step", lambda: eng.walk_scan(
                esrc, [(None, eng.draw_noise(64, g), None)])),
            ("edge_batch", lambda: eng.edge_batch_scan(
                cdf, degs, 1.0, 1.0 / 300, [(torch.rand(64, generator=g),
                                             None, eng.draw_noise(64, g))],
                batch=64)),
            ("triangle_batch", lambda: eng.triangle_edge_scan(
                u, v, degs, None, eng.draw_noise(40, g, 1))),
            ("prob_of", lambda: eng.prob_of_from_block_sums(
                esrc, (esrc + 1) % 250, eng.masked_block_sums(esrc)[0]))]:
        cc[name] = sh.collective_counts(fn)
    ew = eng.edge_batch_scan(
        cdf, degs, 1.0, 1.0 / 300, [(torch.rand(64, generator=g), None,
                                     eng.draw_noise(64, g))
                                    for _ in range(3)], batch=64)[-1]
    res["edge_word_psums"] = int(ew[7])
    res["schedule"] = cc
    # noisy power: iterations + 1 all-reduces
    ksub = torch.as_tensor(pl["ksub"])
    (lam, vec, nw), res["power_cc"] = _counts(
        sh.sharded_noisy_power, m8, ksub, torch.as_tensor(pl["v0"]),
        torch.as_tensor(pl["power_u"]), num_samples=16)
    res["power"] = (lam, vec, nw)
    # the sharded hash table
    tab = ShardedHashTable(m8, torch.as_tensor(pl["xh"]), ker,
                           max_bucket=64, num_far_samples=8, seed=3)
    (est, cnt, hw), res["hash_cc"] = _counts(
        tab.query, torch.as_tensor(pl["yh"]), torch.as_tensor(pl["fidx"]))
    res["hash"] = (est, cnt, hw)
    res["hash_tables"] = (tab.shard_keys, tab.shard_members,
                          tab.shard_counts, tab.shard_truncated, tab.dims,
                          tab.shift, tab.cell_width, tab.shard_size,
                          tab.x_pad)
    return {k: _tree(v) for k, v in res.items()}


def _tree(v):
    if isinstance(v, (tuple, list)):
        return type(v)(_tree(a) for a in v)
    if isinstance(v, dict):
        return {k: _tree(a) for k, a in v.items()}
    return _np(v)


def pipelines(rank, world, pl):
    """Checks 4 and 5: the KS law of the mesh sampler's draw (n = 512, m =
    4096) beside the flat sampler's, and every mesh pipeline at the
    reference test's sizes on an (8,) mesh; rank 0 also runs the flat
    single-device twins for their counters."""
    from repro_torch.core.cluster.local import same_cluster_test
    from repro_torch.core.eigen import top_eigenvalue
    from repro_torch.core.graph.arboricity import estimate_arboricity
    from repro_torch.core.graph.triangles import estimate_triangle_weight
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.lowrank import fkv_lowrank
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.core.spectrum import approximate_spectrum
    m8 = _mesh((8,), ("data",))
    ker = gaussian(1.0)
    xk = pl["x_ks"]
    src = np.full(4096, pl["u0"], np.int64)
    res = {"ks_mesh": NeighborSampler(xk, ker, exact_blocks=True,
                                      seed=pl["engine_seed"],
                                      mesh=m8).sample(src)[0]}
    if rank == 0:
        res["ks_flat"] = NeighborSampler(xk, ker, exact_blocks=True,
                                         seed=pl["engine_seed"],
                                         device="cpu").sample(src)[0]
    x = pl["x"]
    ker = gaussian(2.0)
    runs = {
        "sparsify": lambda **kw: spectral_sparsify(
            x, ker, 3000, estimator="exact", exact_blocks=True, seed=0,
            **kw),
        "sparsify_strat": lambda **kw: spectral_sparsify(x, ker, 3000,
                                                         seed=0, **kw),
        "arboricity": lambda **kw: estimate_arboricity(
            x, ker, 4000, estimator="exact", seed=0, **kw),
        "triangles": lambda **kw: estimate_triangle_weight(
            x, ker, 300, 16, estimator="exact", seed=0, **kw),
        "lowrank": lambda **kw: fkv_lowrank(x, ker, rank=6, num_rows=120,
                                            seed=0, **kw),
        "eigen": lambda **kw: top_eigenvalue(x, ker, t=150,
                                             method="noisy_power", seed=0,
                                             **kw),
        "spectrum": lambda **kw: approximate_spectrum(
            x, ker, length=5, num_sources=6, walks_per_source=8, seed=0,
            **kw),
        "cluster": lambda **kw: same_cluster_test(
            x, ker, 0, 5, walk_length=4, num_walks=20, seed=0, **kw),
    }

    def summary(name, r):
        out = {"evals": int(r.kernel_evals)}
        if name.startswith("sparsify"):
            out.update(kde_queries=int(r.kde_queries), src=r.src, dst=r.dst,
                       weight=r.weight, status=int(r.status))
        elif name == "arboricity":
            out["density"] = float(r.density)
        elif name == "triangles":
            out["total"] = float(r.total_weight)
        elif name == "lowrank":
            out["u"] = r.u
        elif name == "eigen":
            out["eigenvalue"] = float(r.eigenvalue)
        elif name == "cluster":
            out["statistic"] = float(r.statistic)
        return out

    for name, fn in runs.items():
        res[f"mesh_{name}"] = summary(name, fn(mesh=m8))
        if rank == 0:
            res[f"flat_{name}"] = summary(name, fn(device="cpu"))
    return {k: _tree(v) for k, v in res.items()}


def streaming(rank, world, pl):
    """Checks 7 and 8 on a (4,) mesh: ``patch_rows`` on ``ShardedBlocks``
    and ``ShardedHashTable`` (zero collectives) then reads equal to a
    fresh build on the mutated data; a mesh ``NeighborSampler`` /
    ``DegreeSampler`` pair and ``StreamingKernelGraph`` on a
    ``DynamicDataset``; a mesh serving tenant's groups replayed through
    the engine."""
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.vertex import DegreeSampler
    from repro_torch.core.serving import KernelGraphServable
    from repro_torch.core.streaming import StreamingKernelGraph
    from repro_torch.kernels.kde_hash.sharded import ShardedHashTable
    from repro_torch.kernels.kde_sampler import sharded as sh
    m4 = _mesh((4,), ("data",))
    ker = gaussian(1.0)
    res = {}
    x, xm = torch.as_tensor(pl["x"]), torch.as_tensor(pl["x_mut"])
    slots, y = pl["slots"], torch.as_tensor(pl["y"])
    src = torch.as_tensor(pl["src"])
    g = torch.Generator().manual_seed(1)
    # the block engine
    eng = sh.ShardedBlocks(m4, x, ker, block_size=16, exact=True)
    res["blocks_patch_cc"] = sh.collective_counts(
        eng.patch_rows, slots, xm[slots])
    fresh = sh.ShardedBlocks(m4, xm, ker, block_size=16, exact=True)
    u = fresh.draw_noise(len(src), g)
    res["blocks_patched"] = (eng.kde_query(y)[0],
                             *eng.fused_sample(src, None, u)[:2])
    res["blocks_fresh"] = (fresh.kde_query(y)[0],
                           *fresh.fused_sample(src, None, u)[:2])
    # the hash table
    tab = ShardedHashTable(m4, x, ker, max_bucket=256, num_far_samples=8,
                           seed=5, overflow_cap=16)
    ones = np.ones(len(slots), bool)
    res["hash_patch_cc"] = sh.collective_counts(
        tab.patch_rows, slots, pl["x"][slots], pl["x_mut"][slots], ones,
        ones)
    ftab = ShardedHashTable(m4, xm, ker, max_bucket=256, num_far_samples=8,
                            seed=5, overflow_cap=16)
    noise = ftab.draw_noise(len(y), g)
    res["hash_patched"] = tab.query(y, noise)[:2] + (tab.overflow_fill,)
    res["hash_fresh"] = ftab.query(y, noise)[:2]
    # a streaming mesh sampler and its degrees
    ds = DynamicDataset(pl["x"], capacity=pl["capacity"], device="cpu")
    nbr = NeighborSampler(ds.x_pad, ker, exact_blocks=True, seed=3,
                          mesh=m4, dataset=ds)
    deg = DegreeSampler(nbr.blocks, seed=4, dataset=ds)
    nbr.sample(pl["src"])
    ds.update_rows(slots, pl["x_mut"][slots])
    ds.delete_rows(pl["dead"])
    ins = ds.insert_rows(pl["new_rows"])
    deg._sync()
    live = np.setdiff1d(pl["src"], pl["dead"])[:32]
    dst = (live + 1) % 240
    dst = np.where(np.isin(dst, pl["dead"]), live, dst)
    res["stream_patched"] = (deg.degrees, nbr.prob_of(live, dst), ins)
    nbr2 = NeighborSampler(ds.x_pad, ker, exact_blocks=True, seed=3,
                           mesh=m4, dataset=ds)
    deg2 = DegreeSampler(nbr2.blocks, seed=4, dataset=ds)
    res["stream_fresh"] = (deg2.degrees, nbr2.prob_of(live, dst))
    skg = StreamingKernelGraph(pl["x"], ker, capacity=pl["capacity"],
                               seed=2, mesh=m4)
    skg.insert(pl["new_rows"])
    e = skg.sample_edges(256, batch=128)
    res["skg"] = (e[0], e[1], e[2], skg.nbr.device_counters["psums"],
                  skg.status_report()["flags"])
    # a mesh serving tenant
    srv = KernelGraphServable(device="cpu")
    srv.add_tenant("m", pl["x"], ker, exact_blocks=True, mesh=m4, seed=9)
    reqs = {"sample": [srv.submit("m", "sample", src=pl["src"][i::3],
                                  seed=100 + i) for i in range(3)],
            "prob_of": [srv.submit("m", "prob_of", src=pl["src"][:8],
                                   dst=pl["src"][8:16], seed=7),
                        srv.submit("m", "prob_of", src=pl["src"][16:20],
                                   dst=pl["src"][20:24], seed=8)],
            "query": [srv.submit("m", "query", y=pl["y"][:5], seed=11),
                      srv.submit("m", "query", y=pl["y"][5:], seed=12)],
            "walk": [srv.submit("m", "walk", starts=pl["src"][:6], length=3,
                                seed=13 + i) for i in range(2)]}
    res["serve_cc"] = sh.collective_counts(srv.tick)
    res["serve"] = {op: [r.result for r in rs] for op, rs in reqs.items()}
    res["serve_errors"] = [repr(r.error) for rs in reqs.values() for r in rs
                           if r.error is not None]
    eng = srv.tenant("m").nbr._engine

    def group_gen(seeds):
        return torch.Generator().manual_seed(int(
            np.random.SeedSequence(seeds).generate_state(1)[0]))
    cat = np.concatenate([pl["src"][i::3] for i in range(3)])
    gg = group_gen([100, 101, 102])
    eng.draw_level1_noise(gg)
    nb, prob, _, _ = eng.fused_sample(cat, None, eng.draw_noise(len(cat), gg))
    res["serve_replay"] = (nb, prob)
    return {k: _tree(v) for k, v in res.items()}


def signature_cases(rank, world, pl):
    """The former mesh placeholders of ``tests/test_torch_signatures.py``,
    each called by position as the reference binds it, on a one-rank gloo
    group, beside the single-device call: ``{case: (mesh evals, flat
    evals)}``."""
    from repro_torch.core.cluster.local import same_cluster_test
    from repro_torch.core.eigen import top_eigenvalue
    from repro_torch.core.graph.arboricity import estimate_arboricity
    from repro_torch.core.graph.triangles import estimate_triangle_weight
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import make_kernel
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.rownorm import RowNormSampler
    from repro_torch.core.spectrum import approximate_spectrum
    k = make_kernel("gaussian", 1.0)
    x = pl["x"]
    cpu = dict(device="cpu")
    mx, mm = _mesh((1,), ("x",)), _mesh((1,), ("model",))
    mxy, md = _mesh((1, 1), ("x", "y")), _mesh((1,), ("data",))

    def hashed(*a, **kw):
        est = HashedKDE(x, k, None, 8, 64, 256, 0, None, None, *a, **kw)
        est.query(x[:16])
        return est.evals

    def sampler(*a, **kw):
        nbr = NeighborSampler(x, k, "blocked", None, 16, True, None, 0, None,
                              None, *a, **kw)
        nbr.sample(np.arange(8))
        nbr.prob_of(np.arange(8), np.arange(8, 16))
        return nbr.evals

    def rownorm(*a, **kw):
        s = RowNormSampler(x, k, "exact", 0, *a, **kw)
        s.rows(s.sample(8))
        return s.evals

    cases = {
        "HashedKDE.data_axes": (lambda: hashed(mx, ("x",)),
                                lambda: hashed(**cpu)),
        "NeighborSampler.data_axes": (lambda: sampler(mm, ("model",)),
                                      lambda: sampler(**cpu)),
        "RowNormSampler.data_axes": (lambda: rownorm(mxy, ("x", "y")),
                                     lambda: rownorm(**cpu)),
        "same_cluster_test.mesh": (
            lambda: same_cluster_test(x, k, 0, 1, 2, 4, 0, None, None, md),
            lambda: same_cluster_test(x, k, 0, 1, 2, 4, 0, **cpu)),
        "estimate_triangle_weight.mesh": (
            lambda: estimate_triangle_weight(x, k, 4, 2, "exact", 0, md),
            lambda: estimate_triangle_weight(x, k, 4, 2, "exact", 0, **cpu)),
        "estimate_arboricity.mesh": (
            lambda: estimate_arboricity(x, k, 4, "exact", 0, 512, md),
            lambda: estimate_arboricity(x, k, 4, "exact", 0, 512, **cpu)),
        "top_eigenvalue.mesh": (
            lambda: top_eigenvalue(x, k, 0.25, 0.1, 8, "noisy_power", 0,
                                   md),
            lambda: top_eigenvalue(x, k, 0.25, 0.1, 8, "noisy_power", 0,
                                   **cpu)),
        "approximate_spectrum.mesh": (
            lambda: approximate_spectrum(x, k, 4, 2, 2, 0, None, md),
            lambda: approximate_spectrum(x, k, 4, 2, 2, 0, **cpu)),
    }

    def evals(r):
        return r if isinstance(r, int) else int(r.kernel_evals)
    return {name: (evals(m()), evals(f())) for name, (m, f) in cases.items()}


# --------------------------------------------------------------------- #
# the LM's sharded state (tests/test_torch_lm_mesh*.py)
# --------------------------------------------------------------------- #
def _lm_model(arch, tree, mesh):
    """The reduced f32 config of ``arch`` and the port's model holding the
    reference's ``tree``, sharded onto ``mesh``."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs.base import get_reduced
    from repro_torch.distributed import state as D
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = convert.params_from_reference(tree, cfg, device="cpu")
    return cfg, D.shard_model(model, mesh)


def _whole(model, named=None):
    """Name -> whole numpy array of a sharded model's parameters (or of a
    dict of its moments / gradients)."""
    from repro_torch.distributed import state as D
    named = dict(model.named_parameters()) if named is None else named
    specs = {n: D.spec_of(p) for n, p in model.named_parameters()}
    return {k: _np(v) for k, v in D.full_named(named, specs,
                                                model._mesh).items()}


def lm_mesh(rank, world, pl):
    """Eight ranks: (a) one sharded train step of each reduced config on a
    (2, 2, 2) ("pod", "data", "model") mesh; (b) the shard_map MoE forward
    and gradients on (2, 4); (c) the shard_map KDE decode on (2, 4); (d)
    the model's decode over a sequence-split cache, xla and kde; (e)
    ``compressed_psum`` over "pod"."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import state as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    res = {}
    m222 = make_debug_mesh(2, 2, 2, device_type="cpu")
    m24 = make_debug_mesh(2, 4, device_type="cpu")
    # (a) the sharded train steps
    for arch, tree in pl["trees"].items():
        cfg, model = _lm_model(arch, tree, m222)
        ost = opt.init_adamw(model)
        C.reset_collectives()
        with L.activation_sharding(m222, SH.batch_axes(m222)):
            model, ost, met = make_train_step(
                cfg, opt.AdamWConfig(lr=pl["lr"], warmup_steps=1))(
                model, ost, pl["batches"][arch])
        res[arch] = dict(metrics={k: float(v) for k, v in met.items()},
                         cc=dict(C.COLLECTIVES),
                         bytes=D.state_bytes(model, ost))
        whole = _whole(model)
        if rank == 0:
            res[arch]["params"] = whole
    # (b) the shard_map MoE
    cfg, model = _lm_model("granite_moe_1b_a400m", pl["moe_tree"], m24)
    mlp = model.layers[0].mlp
    dg = C.mesh_group(m24, ("data",))
    with L.activation_sharding(m24, ("data",)):
        L._ACT["batch_sharded"] = True
        x = torch.as_tensor(pl["moe_x"])
        y, aux = L.moe_block(mlp, cfg, T.local_rows(x)[0],
                             capacity_factor=8.0)
        res["moe_y"], res["moe_aux"] = _np(C.all_gather(y, dg, 0)), \
            float(aux.detach())
        x2 = T.local_rows(torch.as_tensor(pl["moe_x2"]))[0]
        y2, aux2 = L.moe_block(mlp, cfg, x2, capacity_factor=8.0)
        obj = torch.sum(y2 ** 2) + 0.01 * aux2 / dg.size
        names = [n for n, _ in mlp.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(
            obj, [p for _, p in mlp.named_parameters()])))
        D.reduce_grads(mlp, grads, m24)
        res["moe_grads"] = {n: _np(D.unshard(g, D.spec_of(p), m24))
                            for (n, p), g in zip(mlp.named_parameters(),
                                                 grads.values())}
    # (c) the shard_map KDE decode, kv heads split or not, and indivisible
    mg = C.mesh_group(m24, ("model",))
    for hkv in (2, 4):
        q, k, v = (torch.as_tensor(pl[f"kde{hkv}"][n]) for n in "qkv")
        if hkv % mg.size == 0:
            hq_l, kv_l = q.shape[1] // mg.size, hkv // mg.size
            q = q[:, mg.index * hq_l:(mg.index + 1) * hq_l]
            k, v = (t[:, mg.index * kv_l:(mg.index + 1) * kv_l] for t in (k, v))
            seq = dg
        else:
            seq = C.mesh_group(m24, ("data", "model"))
        s_l = k.shape[2] // seq.size
        k, v = (t[:, :, seq.index * s_l:(seq.index + 1) * s_l] for t in (k, v))
        cc = {}
        out = C.collective_counts(lambda: cc.setdefault(
            "o", L.kde_decode_attention_shardmap(
                q, k, v, 900, top_p=4, bk=64, stride=4, mesh=m24,
                baxes=("data",), num_kv_heads=hkv)))
        o = cc["o"]
        if hkv % mg.size == 0:
            o = C.all_gather(o, mg, 1)
        res[f"kde{hkv}"] = (_np(o), out)
    q, k, v = (torch.as_tensor(pl["kde_odd"][n]) for n in "qkv")
    seq = C.mesh_group(m24, ("data", "model"))
    res["kde_odd"] = L.kde_decode_attention_shardmap(
        q, k[:, :, :96 // 8], v[:, :, :96 // 8], 90, top_p=2, bk=64,
        stride=4, mesh=m24, baxes=("data",), num_kv_heads=2)
    # (d) the model's decode over a sequence-split cache
    cfg, model = _lm_model("yi_6b", pl["dec_tree"], m24)
    for impl, toks, kw in (("xla", pl["dec_tok"], None),
                           ("kde", pl["dec_tok"][:1], pl["kde_cfg"])):
        with L.activation_sharding(m24, ("data",)), torch.inference_mode():
            cache = T.init_cache(cfg, toks.shape[0], pl["dec_len"],
                                 torch.float32, device="cpu")
            outs = []
            for t in range(toks.shape[1]):
                logits, cache = T.decode_step(model, cfg, toks[:, t:t + 1],
                                              cache, t, impl=impl,
                                              kde_cfg=kw)
                if cache.specs["k"][1] is not None:
                    logits = C.all_gather(logits, dg, 0)
                outs.append(_np(logits))
        res[f"dec_{impl}"] = (np.stack(outs), dict(cache.specs))
    # (e) compressed_psum over "pod"
    g = {k: torch.as_tensor(a[rank]) for k, a in pl["cp_g"].items()}
    r = {k: torch.as_tensor(a[rank]) for k, a in pl["cp_r"].items()}
    cc = {}
    with L.activation_sharding(m222, SH.batch_axes(m222)):
        res["cp_cc"] = C.collective_counts(lambda: cc.setdefault(
            "o", opt.compressed_psum(g, r, "pod")))
    res["cp"] = {k: (_np(cc["o"][0][k]), _np(cc["o"][1][k])) for k in g}
    return res


def lm_state(rank, world, pl):
    """Four ranks: a sharded train step on (2, 2), saved and restored onto
    (4, 1) (elastic restore: bitwise the same state), then ``launch.train
    --data 2 --model 2`` for two steps with checkpoints, resumed by
    ``--data 4 --model 1`` for two more; rank 0's log lines."""
    import contextlib
    import io
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    res = {}
    m22 = make_debug_mesh(2, 2, device_type="cpu")
    m41 = make_debug_mesh(4, 1, device_type="cpu")
    cfg, model = _lm_model("yi_6b", pl["tree"], m22)
    ost = opt.init_adamw(model)
    with L.activation_sharding(m22, ("data",)):
        model, ost, _ = make_train_step(
            cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))(
            model, ost, pl["batch"])
    before = (_whole(model), _whole(model, ost.m), _whole(model, ost.v))
    ckpt.save(pl["dir"], 1, (model, ost))
    cfg, fresh = _lm_model("yi_6b", pl["tree"], m41)
    fo = opt.init_adamw(fresh)
    shd = SH.param_shardings(fresh, m41)
    (fresh, fo), step = ckpt.restore(
        pl["dir"], (fresh, fo),
        shardings=(shd, opt.AdamWState(step=None, m=shd, v=shd)))
    after = (_whole(fresh), _whole(fresh, fo.m), _whole(fresh, fo.v))
    res["restore"] = dict(step=step, opt_step=int(fo.step),
                          local=tuple(fresh.layers[0].attn.wq.shape),
                          same=all(np.array_equal(a[k], b[k])
                                   for a, b in zip(before, after)
                                   for k in a))
    logs = io.StringIO()
    with contextlib.redirect_stdout(logs):
        base = ["--device", "cpu", "--arch", "yi_6b", "--reduced", "--batch",
                "4", "--seq", "16", "--log-every", "1", "--ckpt-every", "1",
                "--ckpt-dir", pl["train_dir"]]
        ttrain.main(base + ["--data", "2", "--model", "2", "--steps", "2"])
        ttrain.main(base + ["--data", "4", "--model", "1", "--steps", "4"])
    res["log"] = logs.getvalue()
    return res


# --------------------------------------------------------------------- #
# context-parallel prefill (tests/test_torch_cp.py)
# --------------------------------------------------------------------- #
def _cp_forward(cfg, model, mesh, batch, impl, seq_mode=True):
    """Rank's ``forward`` under ``activation_sharding(seq_mode=)`` on
    ``mesh``: the whole batch's logits (gathered over "data" when it split
    the rows), aux, the layout taken and the collectives by kind."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    out = {}
    with L.activation_sharding(mesh, SH.batch_axes(mesh), seq_mode=seq_mode), \
            torch.inference_mode():
        cc = C.collective_counts(lambda: out.setdefault(
            "o", T.forward(model, cfg, batch, impl=impl)))
        logits, aux = out["o"]
        if L._ACT["batch_sharded"]:
            logits = C.all_gather(logits, C.mesh_group(mesh, ("data",)), 0)
        layout = L._ACT["seq_layout"]
    return dict(logits=_np(logits), aux=float(aux), layout=layout, cc=cc)


def lm_cp(rank, world, pl):
    """Eight ranks: (a) seq-mode forwards on (2, 4) ("data", "model") and
    (1, 8) meshes, every case of ``pl["fwd"]`` (split and replicated
    layouts); (b) seq-mode gradients and train-step metrics; (c) decode
    steps under seq mode and without it."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import state as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step, step_grads
    meshes = {"2x4": make_debug_mesh(2, 4, device_type="cpu"),
              "1x8": make_debug_mesh(1, 8, device_type="cpu")}
    res = {"fwd": {}, "grads": {}}
    for name, (arch, mesh, seq, impls) in pl["fwd"].items():
        cfg, model = _lm_model(arch, pl["trees"][arch], meshes[mesh])
        batch = pl["batches"][(arch, seq)]
        for impl in impls:
            res["fwd"][(name, impl)] = _cp_forward(cfg, model, meshes[mesh],
                                                   batch, impl)
    m24 = meshes["2x4"]
    for arch, seq in pl["grads"]:
        cfg, model = _lm_model(arch, pl["trees"][arch], m24)
        batch = pl["batches"][(arch, seq)]
        with L.activation_sharding(m24, SH.batch_axes(m24), seq_mode=True):
            cc = {}
            counts = C.collective_counts(lambda: cc.setdefault(
                "g", step_grads(model, cfg, batch, impl="flash")))
            grads, loss, aux = cc["g"]
            layout = L._ACT["seq_layout"]
            whole = _whole(model, grads)
            ost = opt.init_adamw(model)
            _, _, met = make_train_step(
                cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                impl="flash")(model, ost, batch)
        res["grads"][arch] = dict(
            grads=whole if rank == 0 else None, layout=layout, cc=counts,
            metrics={k: float(v) for k, v in met.items()})
    # decode steps: under seq mode exactly as without it
    cfg, model = _lm_model("yi_6b", pl["trees"]["yi_6b"], m24)
    toks = pl["dec_tok"]
    for seq_mode in (False, True):
        with L.activation_sharding(m24, ("data",), seq_mode=seq_mode), \
                torch.inference_mode():
            cache = T.init_cache(cfg, toks.shape[0], pl["dec_len"],
                                 torch.float32, device="cpu")
            outs = []
            for t in range(toks.shape[1]):
                logits, cache = T.decode_step(model, cfg, toks[:, t:t + 1],
                                              cache, t)
                outs.append(_np(logits))
            res[f"dec_{seq_mode}"] = (np.stack(outs), L._ACT["seq_mode"],
                                      L._ACT["seq_layout"])
    return res


def lm_cp_odd(rank, world, pl):
    """A (1, world) mesh whose "model" extent divides neither the padded
    vocab nor the heads: ``pl["cfg"]``'s embedding splits over d_model
    and its head not at all.  The seq-mode forward's logits, layout and
    the parameters' specs, and the seq-mode gradients (whole)."""
    from repro_torch.distributed import state as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import step_grads
    cfg = pl["cfg"]
    mesh = make_debug_mesh(1, world, device_type="cpu")
    model = D.shard_model(T.init_params(cfg, 0, device="cpu"), mesh)
    res = _cp_forward(cfg, model, mesh, pl["batch"], "xla")
    res["specs"] = {n: D.spec_of(p) for n, p in model.named_parameters()
                    if n in ("embed", "lm_head")}
    with L.activation_sharding(mesh, ("data",), seq_mode=True):
        grads, _, _ = step_grads(model, cfg, pl["batch"], impl="flash")
        res["grads"] = _whole(model, grads)
    return res


def lm_moe_grouped(rank, world, pl):
    """A (2, 3) ("data", "model") mesh: reduced granite-moe, whose 4
    experts do not divide "model" = 3, so the MoE takes the grouped
    dispatch under the batch split (no seq mode).  The forward's logits,
    aux and the dispatches its blocks took, the gradients (whole) and one
    train step's metrics."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step, step_grads
    mesh = make_debug_mesh(2, 3, device_type="cpu")
    cfg, model = _lm_model(pl["arch"], pl["tree"], mesh)
    taken = []
    grouped, shardmap = L._moe_block_gspmd, L._moe_block_shardmap
    L._moe_block_gspmd = lambda *a, **k: taken.append("grouped") \
        or grouped(*a, **k)
    L._moe_block_shardmap = lambda *a, **k: taken.append("shardmap") \
        or shardmap(*a, **k)
    try:
        res = _cp_forward(cfg, model, mesh, pl["batch"], "xla",
                          seq_mode=False)
        with L.activation_sharding(mesh, SH.batch_axes(mesh)):
            grads, _, _ = step_grads(model, cfg, pl["batch"], impl="xla")
            res["batch_sharded"] = L._ACT["batch_sharded"]
            res["grads"] = _whole(model, grads)
            _, _, met = make_train_step(
                cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                impl="xla")(model, opt.init_adamw(model), pl["batch"])
    finally:
        L._moe_block_gspmd, L._moe_block_shardmap = grouped, shardmap
    res.update(taken=sorted(set(taken)),
               metrics={k: float(v) for k, v in met.items()})
    return res
