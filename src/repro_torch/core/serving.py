"""Multi-tenant batched serving layer for the kernel-graph primitives
(DESIGN.md §13), on torch.

The paper's value proposition is answering many KDE / sampling queries
cheaply after one sub-quadratic preprocessing pass -- exactly the shape of
a serving workload.  :class:`KernelGraphServable` is the servable on top of
the fused engines: callers :meth:`~KernelGraphServable.submit` ``query`` /
``sample`` / ``walk`` / ``prob_of`` requests against named tenants (each
one ``DynamicDataset`` + estimator state), and every
:meth:`~KernelGraphServable.tick` drains the queue into as few padded
batches as the shapes allow:

* **continuous batching** -- concurrent requests are grouped by
  ``(op, tenant signature, shape bucket)`` and run as ONE pass of the
  ``batched_*`` programs of ``kernels/kde_sampler`` / ``kde_hash``: the
  exact level-1 reads are one launch of the tenant-axis kernels a group,
  the hashed reads one weighted-kv launch, whatever the number of lanes
  and tenants.  Request widths are padded up to a static bucket (powers
  of two by default), so a group's shapes come from a bounded set.
* **tenant lifecycle** -- tenants' level-1 block structures and hash
  states are admitted on first use and evicted least-recently-used when
  more than ``max_resident`` tenants hold device state; the backing
  ``DynamicDataset`` (source of truth) always stays, so a re-admitted
  tenant simply rebuilds its derived state.  Mutating a tenant's dataset
  between ticks is safe: admission syncs through the ``(dataset_id,
  epoch)`` contract, and requests whose frontier rows died get a
  per-request ``EPOCH_STALE`` error without poisoning the rest of the
  batch.
* **guard semantics** -- the per-request status words flow through
  ``guards.raise_per_request``: under ``REPRO_CHECKS=1`` a flagged request
  carries its own ``EstimationError`` in ``Request.error`` while the other
  lanes of the tick complete normally.

Seeding: each request's noise is drawn on the host from a CPU
``torch.Generator`` seeded with the request's seed, at its BUCKET width,
by the ``draw_*_noise`` helpers of the single-request programs; a group's
noise is stacked and copied to the device once.  So a request's draws
depend only on its seed and shape, never on what it is batched with, and
a request whose width equals its bucket IS the single-request program fed
that noise (the reference keys threefry per request instead; ROADMAP.md
section 3).  :meth:`~KernelGraphServable.tick` itself never raises:
admission, grouping, and each group's program are fault-isolated,
attaching failures to exactly the affected requests.

* **mesh tenants** -- a tenant built with ``mesh=`` (a ``DeviceMesh``)
  serves through its sharded engine (``kde_sampler.sharded``): a group's
  ``sample`` / ``prob_of`` / ``query`` requests concatenate into ONE draw
  or query batch (one all-reduce -- the §9 schedule; batching adds no
  collective), walks run per request (each walk step is its own
  collective batch either way).  The group shares one noise stream seeded
  by all its requests' seeds in queue order (each walk: its own seed).
  Every rank of the mesh submits the same requests and ticks (SPMD).

>>> srv = KernelGraphServable(max_resident=2)
>>> srv.add_tenant("a", xa, gaussian(1.0))
>>> r = srv.submit("a", "sample", src=np.arange(8), seed=0)
>>> srv.tick(); nb, prob = r.result
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dataset import DynamicDataset
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.edge import _BENIGN, NeighborSampler
from repro_torch.device import resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler.sharded import mesh_device
from repro_torch.obs import counters as _c
from repro_torch.obs import metrics as _m

#: ops a request may name
REQUEST_OPS = ("query", "sample", "walk", "prob_of")

#: default request-width buckets (powers of two); a request of width w is
#: padded to the smallest bucket >= w
DEFAULT_BUCKETS = (4, 8, 16, 32, 64, 128, 256)


def shape_bucket(w: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest static bucket >= ``w`` (next power of two past the
    table): the padded width a request of width ``w`` is served at."""
    for b in buckets:
        if w <= b:
            return b
    p = 1
    while p < w:
        p <<= 1
    return p


@dataclasses.dataclass
class Request:
    """One submitted serving request and, after its tick, its outcome.

    ``result`` mirrors the sequential API: ``sample`` -> (neighbors,
    probs); ``walk`` -> (endpoints, None); ``prob_of`` -> probs; ``query``
    -> estimates.  ``status`` is the request's own flag word; ``error`` is
    the per-request ``EstimationError`` under ``REPRO_CHECKS=1`` (the tick
    itself never raises)."""

    tenant: str
    op: str
    payload: dict
    seed: int
    rid: int
    submitted: float
    status: int = 0
    result: object = None
    error: Optional[Exception] = None
    finished: Optional[float] = None

    @property
    def done(self) -> bool:
        """True once a tick produced a result or an error."""
        return self.finished is not None

    @property
    def latency(self) -> float:
        """Submit -> completion wall time in seconds (nan until done)."""
        return (self.finished - self.submitted) if self.done else float("nan")


class ServedTenant:
    """One tenant: a mutable ``DynamicDataset`` plus lazily-admitted
    estimator state (``NeighborSampler`` level-1 cache / hash layout).

    ``admit()`` builds or syncs the device state; ``release()`` drops it
    (LRU eviction) -- the dataset is the source of truth, so eviction
    never loses data, it only trades the rebuild cost back in."""

    def __init__(self, name: str, dataset: DynamicDataset, kernel: Kernel,
                 seed: int, opts: dict):
        self.name = name
        self.dataset = dataset
        self.kernel = kernel
        self.seed = int(seed)
        self.opts = dict(opts)
        self.nbr: Optional[NeighborSampler] = None
        self.builds = 0

    @property
    def resident(self) -> bool:
        """True while the tenant's derived device state is admitted."""
        return self.nbr is not None

    @property
    def mesh(self):
        """The tenant's mesh (None for flat single-device tenants)."""
        return self.opts.get("mesh")

    def admit(self) -> NeighborSampler:
        """Build (first use / after eviction) or epoch-sync the sampler."""
        if self.nbr is None:
            self.nbr = NeighborSampler(
                self.dataset.x_pad, self.kernel, dataset=self.dataset,
                seed=self.seed, **self.opts)
            self.builds += 1
        else:
            self.nbr._sync()
        return self.nbr

    def release(self) -> None:
        """Drop the derived device state (level-1 cache, hash layout)."""
        self.nbr = None

    # ------------------------------------------------------------------ #
    def _state_sig(self):
        """Hashable shape signature of the hash state (None when absent);
        part of the group key so only stack-compatible tenants batch.
        Absent fields (None) are left out, as the reference's pytree
        leaves drop them."""
        hs = self.nbr._hstate
        if hs is None:
            return None
        return tuple((tuple(a.shape), str(a.dtype)) for a in hs
                     if a is not None)

    def draw_sig(self):
        """Signature of the tenant's draw programs: equal signatures =>
        the stacked arena serves the whole group in one pass.  Includes
        the padded dataset shape, so tenants agree on ``d`` too."""
        c = self.nbr._cfg
        return (tuple(sorted(c.items())) + (tuple(self.nbr.x.shape),)
                + (self._state_sig(),))

    def query_sig(self):
        """Signature of the tenant's query program (the dense level-1 read,
        or the hashed estimator's config + layout shapes); both carry the
        padded dataset shape so only stack-compatible tenants share a
        group."""
        nbr = self.nbr
        if nbr.level1 == "hash":
            hq = nbr.hash_estimator
            return ("hash-query", tuple(sorted(hq._cfg.items())),
                    tuple(nbr.x.shape), self._state_sig())
        keys = ("kind", "inv_bw", "beta", "pairwise", "block_size",
                "num_blocks", "n", "s", "exact")
        return ("dense-query", tuple((k, nbr._cfg[k]) for k in keys),
                tuple(nbr.x.shape))


def _pad_idx(a, wb: int) -> np.ndarray:
    """Pad a 1-d index payload to its bucket by repeating the first
    element -- padded lanes sample from a real live row (no spurious
    flags) and are sliced off before the result is returned."""
    a = np.ascontiguousarray(np.asarray(a).reshape(-1), np.int64)
    if len(a) == wb:
        return a
    fill = a[0] if len(a) else np.int64(0)
    return np.concatenate([a, np.full(wb - len(a), fill, np.int64)])


def _pad_pts(y, qb: int) -> np.ndarray:
    """Pad a (q, d) query-point payload to its bucket with row 0."""
    y = np.ascontiguousarray(np.asarray(y, np.float32))
    if y.ndim == 1:
        y = y[None, :]
    if len(y) == qb:
        return y
    fill = y[:1] if len(y) else np.zeros((1, y.shape[1]), np.float32)
    return np.concatenate([y, np.repeat(fill, qb - len(y), axis=0)])


def _stack(parts, dev):
    """Stack the requests' noise (equal structures of tensors, tuples,
    lists and None) along a new leading request axis, on ``dev``."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(parts).to(dev)
    out = [_stack([p[i] for p in parts], dev) for i in range(len(first))]
    return tuple(out) if isinstance(first, tuple) else out


def _host_gen(seed: int) -> torch.Generator:
    """The request's own noise stream: a CPU generator seeded with its
    seed."""
    return torch.Generator().manual_seed(int(seed))


class KernelGraphServable:
    """Batched multi-tenant front end over the kernel-graph engines.

    Lifecycle: :meth:`add_tenant` registers datasets; :meth:`submit`
    enqueues requests (non-blocking); :meth:`tick` drains the queue into
    padded batch groups, runs each group as one pass, and scatters
    per-request results / status words / errors back onto the
    :class:`Request` objects.  Cost per tick: one ``batched_*`` program a
    (tenant signature, op, bucket) group plus O(R) host bookkeeping.

    ``max_resident`` bounds how many tenants hold derived device state
    (level-1 blocks + hash layouts) at once; the LRU policy evicts idle
    tenants first and never evicts a tenant needed by the current tick
    (the resident set may transiently overshoot if one tick touches more
    than ``max_resident`` tenants).  ``device=None`` serves on the CUDA
    card.
    """

    def __init__(self, max_resident: int = 4, buckets=DEFAULT_BUCKETS,
                 arena_cache: int = 16, device=None):
        self.device = resolve_device(device)
        self.max_resident = int(max_resident)
        self.buckets = tuple(buckets)
        self._tenants: dict = {}
        self._lru: OrderedDict = OrderedDict()
        self._queue: list = []
        self._arenas: OrderedDict = OrderedDict()
        self._arena_cap = int(arena_cache)
        self._rid = 0
        self.ticks = 0
        self.admissions = 0
        self.evictions = 0
        self.served = 0
        self.failed = 0
        self.status = 0
        self.flag_counts: Counter = Counter()
        # realized device totals folded from every served group's counter
        # words (DESIGN.md §15.1) -- the serving-side eval budget ledger
        self.device_counters = _c.HostTotals()

    # ------------------------------------------------------------------ #
    # tenant lifecycle
    def add_tenant(self, name: str, x, kernel: Kernel, *,
                   capacity: Optional[int] = None, level1: str = "blocked",
                   block_size: Optional[int] = None,
                   samples_per_block: int = 16, exact_blocks: bool = False,
                   hash_opts: Optional[dict] = None, mesh=None,
                   data_axes=("data",), seed: int = 0) -> ServedTenant:
        """Register a tenant: wraps ``x`` in a ``DynamicDataset`` on the
        servable's device (so the caller can mutate it between ticks) and
        records the estimator configuration; device state is built lazily
        at first admission."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if mesh is not None:
            mesh_device(mesh, self.device)      # the servable's device
        ds = DynamicDataset(x, capacity=capacity, device=self.device)
        opts = dict(level1=level1, block_size=block_size,
                    samples_per_block=samples_per_block,
                    exact_blocks=exact_blocks, hash_opts=hash_opts)
        if mesh is not None:
            opts.update(mesh=mesh, data_axes=tuple(data_axes))
        t = ServedTenant(name, ds, kernel, seed, opts)
        self._tenants[name] = t
        return t

    def dataset(self, name: str) -> DynamicDataset:
        """The tenant's mutable dataset (insert/delete/update between
        ticks; consumers re-sync through the epoch contract)."""
        return self._tenants[name].dataset

    def tenant(self, name: str) -> ServedTenant:
        """The registered :class:`ServedTenant` handle."""
        return self._tenants[name]

    def _admit(self, name: str, needed) -> None:
        """LRU-touch ``name`` (building its state if evicted) and evict
        the least-recently-used tenants beyond ``max_resident`` -- but
        never one the current tick needs."""
        t = self._tenants[name]
        was = t.resident
        t.admit()
        if not was:
            self.admissions += 1
        self._lru[name] = True
        self._lru.move_to_end(name)
        while len(self._lru) > self.max_resident:
            victim = next((c for c in self._lru if c not in needed), None)
            if victim is None:
                break
            self._lru.pop(victim)
            self._tenants[victim].release()
            self.evictions += 1

    # ------------------------------------------------------------------ #
    # request intake
    def submit(self, tenant: str, op: str, *, seed: Optional[int] = None,
               **payload) -> Request:
        """Enqueue one request; returns its :class:`Request` handle (the
        next :meth:`tick` fills ``result`` / ``status`` / ``error``).
        ``seed`` pins the request's noise -- equal seeds on equal payloads
        reproduce draws bitwise; default is a running counter."""
        if tenant not in self._tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        if op not in REQUEST_OPS:
            raise ValueError(f"unknown op {op!r}; expected {REQUEST_OPS}")
        if op == "prob_of":
            ns = np.asarray(payload["src"]).reshape(-1).shape[0]
            nd = np.asarray(payload["dst"]).reshape(-1).shape[0]
            if ns != nd:
                raise ValueError(
                    f"prob_of src/dst widths differ ({ns} != {nd}): "
                    "q(dst | src) pairs one destination per source row")
        self._rid += 1
        r = Request(tenant=tenant, op=op, payload=dict(payload),
                    seed=int(self._rid * 7919 if seed is None else seed),
                    rid=self._rid, submitted=time.perf_counter())
        self._queue.append(r)
        return r

    def pending(self) -> int:
        """Requests waiting for the next tick."""
        return len(self._queue)

    # ------------------------------------------------------------------ #
    # the serving tick
    def tick(self) -> dict:
        """Drain the queue into padded batch groups and serve each group
        in one pass.  Returns tick stats (requests, groups, stale,
        admissions/evictions deltas, wall time)."""
        reqs, self._queue = self._queue, []
        t0 = time.perf_counter()
        adm0, ev0 = self.admissions, self.evictions
        evals0 = self.device_counters["evals"]
        stats = dict(requests=len(reqs), groups=0, served=0, failed=0,
                     stale=0)
        if not reqs:
            stats.update(admissions=0, evictions=0, tick_ms=0.0,
                         realized_evals=0)
            return stats
        needed = {r.tenant for r in reqs}
        admit_errors: dict = {}
        for name in sorted(needed):
            try:
                self._admit(name, needed)
            except Exception as e:     # noqa: BLE001 -- per-tenant isolation
                admit_errors[name] = e
        groups: dict = {}
        for r in reqs:
            if r.tenant in admit_errors:
                self._fail(r, admit_errors[r.tenant])
                continue
            t = self._tenants[r.tenant]
            try:
                if not self._gate_stale(r, t, stats):
                    continue
                gkey = self._group_key(r, t)
            except Exception as e:     # noqa: BLE001 -- bad payload
                self._fail(r, e)
                continue
            groups.setdefault(gkey, []).append(r)
        for key, grp in groups.items():
            # per-group fault isolation: one group blowing up (bad payload
            # dims, a failed launch) fails ITS requests only -- the other
            # groups of the tick still serve ("never poisons a batch")
            try:
                if key[0] == "mesh":
                    self._serve_mesh_group(key, grp)
                else:
                    self._serve_flat_group(key, grp)
            except Exception as e:     # noqa: BLE001 -- per-group isolation
                for r in grp:
                    if r.finished is None:
                        self._fail(r, e)
            stats["groups"] += 1
        for r in reqs:
            if r.finished is None:       # defensive: mark unserved as failed
                r.error = r.error or RuntimeError("request not served")
                r.finished = time.perf_counter()
            if r.error is None:
                stats["served"] += 1
            else:
                stats["failed"] += 1
        self.served += stats["served"]
        self.failed += stats["failed"]
        self.ticks += 1
        stats.update(admissions=self.admissions - adm0,
                     evictions=self.evictions - ev0,
                     tick_ms=1e3 * (time.perf_counter() - t0),
                     realized_evals=self.device_counters["evals"] - evals0)
        if _m.enabled():
            self._record_metrics(reqs, stats)
        return stats

    def _record_metrics(self, reqs, stats) -> None:
        """Per-tenant / per-op latency histograms plus tick counters into
        the obs registry (DESIGN.md §15.3); called only while the registry
        is enabled, so the disabled-mode tick cost is one branch."""
        for r in reqs:
            if r.finished is not None:
                _m.observe(f"serve.latency.{r.tenant}.{r.op}.us",
                           (r.finished - r.submitted) * 1e6)
        for k in ("served", "failed", "stale", "admissions", "evictions",
                  "realized_evals"):
            _m.counter_inc(f"serve.{k}", stats[k])
        _m.observe("serve.tick.us", stats["tick_ms"] * 1e3)
        _m.gauge_set("serve.resident", float(len(self._lru)))

    # ------------------------------------------------------------------ #
    @staticmethod
    def _fail(r: Request, e: Exception) -> None:
        """Finish ``r`` with ``e`` -- the tick itself never raises."""
        r.error = e
        r.finished = time.perf_counter()

    def _frontier_rows(self, r: Request) -> Optional[np.ndarray]:
        """Dataset rows the request dereferences (None for point queries)."""
        if r.op == "sample":
            return np.asarray(r.payload["src"])
        if r.op == "walk":
            return np.asarray(r.payload["starts"])
        if r.op == "prob_of":
            return np.concatenate([np.asarray(r.payload["src"]),
                                   np.asarray(r.payload["dst"])])
        return None

    def _gate_stale(self, r: Request, t: ServedTenant, stats: dict) -> bool:
        """Per-request liveness gate (the serving twin of
        ``NeighborSampler._check_frontier``): a frontier referencing dead
        slots gets ``EPOCH_STALE`` on ITS status word only.  Under
        ``REPRO_CHECKS=1`` the request errors out and skips the batch;
        otherwise the flag is advisory and the request is still served
        (dead slots carry exactly zero kernel mass)."""
        rows = self._frontier_rows(r)
        if rows is None or bool(np.all(t.dataset.is_live(rows))):
            return True
        r.status |= _g.EPOCH_STALE
        stats["stale"] += 1
        self.status |= _g.EPOCH_STALE
        self.flag_counts["EPOCH_STALE"] += 1
        if _g.checks_enabled():
            r.error = _g.EstimationError(
                f"serve:{r.op}:{r.tenant}: status flags ['EPOCH_STALE'] "
                f"(frontier references dead slots at epoch "
                f"{int(t.dataset.epoch)})")
            r.finished = time.perf_counter()
            return False
        return True

    def _group_key(self, r: Request, t: ServedTenant):
        """The static batch-group key: requests sharing a key run as one
        padded pass (tenant signature + op + shape bucket); a mesh tenant's
        requests group by (tenant, op[, walk length])."""
        if t.mesh is not None:
            extra = (int(r.payload["length"]),) if r.op == "walk" else ()
            return ("mesh", r.tenant, r.op) + extra
        if r.op == "query":
            qb = shape_bucket(len(np.atleast_2d(r.payload["y"])),
                              self.buckets)
            return ("flat", "query", qb, t.query_sig())
        wb = shape_bucket(len(self._frontier_rows(r)) // (2 if r.op ==
                          "prob_of" else 1), self.buckets)
        extra = (int(r.payload["length"]),) if r.op == "walk" else ()
        return ("flat", r.op, wb) + extra + (t.draw_sig(),)

    # ------------------------------------------------------------------ #
    def _arena(self, tenants):
        """Stacked device arena for a group's tenants, cached by
        ``(name, epoch)`` pairs -- the serving face of the ``(dataset_id,
        epoch)`` invalidation contract.  The stack copies the rows: a
        ``DynamicDataset`` mutates its tensors in place, and the epoch key
        is what retires a stale copy."""
        key = tuple((t.name, int(t.dataset.epoch)) for t in tenants)
        hit = self._arenas.get(key)
        if hit is not None:
            self._arenas.move_to_end(key)
            return hit
        xa = torch.stack([t.nbr.x for t in tenants])
        xa_sq = torch.stack([t.nbr.x_sq for t in tenants])
        hstate = None
        if tenants[0].nbr._hstate is not None:
            # one stack serves draws AND hashed queries: the sampler's
            # _hstate IS hash_estimator.state (one layout per tenant)
            from repro_torch.kernels.kde_hash.ops import stack_hash_states
            hstate = stack_hash_states([t.nbr._hstate for t in tenants])
        self._arenas[key] = (xa, xa_sq, hstate)
        while len(self._arenas) > self._arena_cap:
            self._arenas.popitem(last=False)
        return xa, xa_sq, hstate

    def _scatter(self, grp, results, statuses):
        """Slice each request's lanes out of the padded batch outputs and
        fan the per-request status words through the checks policy."""
        if _c.is_word(statuses):
            # batched (R, WIDTH) counter words, one row per request: fold
            # the realized device work into the serving ledger before the
            # status fan-out (DESIGN.md §15.1)
            self.device_counters.note(statuses)
        ctxs = [f"serve:{r.op}:{r.tenant}" for r in grp]
        words, errors = _g.raise_per_request(statuses, ctxs, allow=_BENIGN)
        now = time.perf_counter()
        for i, r in enumerate(grp):
            r.status |= words[i]
            self.status |= words[i]
            _g.count_flags(self.flag_counts, words[i])
            r.error = errors[i]
            r.result = results[i] if errors[i] is None else None
            r.finished = now

    def _serve_flat_group(self, key, grp) -> None:
        """Serve one (tenant signature, op, bucket) group as ONE padded
        pass over the stacked tenant arena."""
        from repro_torch.kernels.kde_sampler import ops as _ops
        op, wb = key[1], key[2]
        names = sorted({r.tenant for r in grp})
        tenants = [self._tenants[nm] for nm in names]
        tmap = {nm: i for i, nm in enumerate(names)}
        xa, xa_sq, hstate = self._arena(tenants)
        dev = self.device
        tidx = np.asarray([tmap[r.tenant] for r in grp], np.int64)
        nbr0 = tenants[0].nbr
        cfg = nbr0._cfg
        gens = [_host_gen(r.seed) for r in grp]
        noise_kw = dict(level1=cfg["level1"], exact=cfg["exact"],
                        num_far=cfg["num_far"], block_size=cfg["block_size"])
        nblk = cfg["num_blocks"]

        def idx(field):
            return torch.as_tensor(np.stack(
                [_pad_idx(r.payload[field], wb) for r in grp])).to(dev)

        def widths(field):
            return [len(np.asarray(r.payload[field]).reshape(-1))
                    for r in grp]

        if op == "sample":
            noise = _stack([_ops.draw_sample_noise(wb, nblk, g, "cpu",
                                                   **noise_kw)
                            for g in gens], dev)
            nb, prob, _, st = _ops.batched_fused_sample(
                xa, xa_sq, tidx, idx("src"), noise, hstate, **cfg)
            nb, prob = nb.cpu().numpy(), prob.cpu().numpy()
            res = [(nb[i, :w], prob[i, :w])
                   for i, w in enumerate(widths("src"))]
        elif op == "walk":
            length = key[3]
            noise = _stack([_ops.draw_walk_noise(
                length, wb, nblk, g, "cpu", n=cfg["n"], s=cfg["s"],
                rounds=0, **noise_kw) for g in gens], dev)
            end, _, st, _ = _ops.batched_walk_scan(
                xa, xa_sq, tidx, idx("starts"), noise, hstate, rounds=0,
                slack=2.0, record_path=False, **cfg)
            end = end.cpu().numpy()
            res = [(end[i, :w], None)
                   for i, w in enumerate(widths("starts"))]
        elif op == "prob_of":
            noise = _stack([_ops._level1_noise(wb, nblk, g, "cpu",
                                               **noise_kw)
                            for g in gens], dev)
            prob, st = _ops.batched_prob_of(
                xa, xa_sq, tidx, idx("src"), idx("dst"), noise, hstate,
                **cfg)
            prob = prob.cpu().numpy()
            res = [prob[i, :w] for i, w in enumerate(widths("src"))]
        elif op == "query":
            qw = [len(np.atleast_2d(r.payload["y"])) for r in grp]
            y = torch.as_tensor(np.stack(
                [_pad_pts(r.payload["y"], wb) for r in grp])).to(dev)
            if nbr0.level1 == "hash":
                from repro_torch.kernels.kde_hash import ops as _hops
                hq = nbr0.hash_estimator
                noise = _stack([_hops.draw_query_noise(
                    wb, hq._cfg["num_far"], hq._cfg["n"], g, "cpu")
                    for g in gens], dev)
                est, _, st = _hops.batched_hashed_query(
                    xa, tidx, y, hstate, noise, **hq._cfg)
            else:
                noise = None if cfg["exact"] else _stack(
                    [torch.rand((nblk, cfg["block_size"]), generator=g)
                     for g in gens], dev)
                qkeys = ("kind", "inv_bw", "beta", "pairwise", "block_size",
                         "num_blocks", "n", "s", "exact", "precision")
                est, st = _ops.batched_kde_query(
                    xa, xa_sq, tidx, y, noise,
                    **{k: cfg[k] for k in qkeys})
            est = est.cpu().numpy()
            res = [est[i, :w] for i, w in enumerate(qw)]
        else:                                          # pragma: no cover
            raise ValueError(op)
        self._scatter(grp, res, st)

    def _serve_mesh_group(self, key, grp) -> None:
        """Serve a mesh tenant's group through its sharded engine: draws,
        probability reads and queries concatenate the group's rows into
        ONE batch (one all-reduce), walks run per request on their own
        seed's noise.  The group's noise comes from one CPU generator
        seeded by every request's seed in queue order (``SeedSequence``),
        copied to the mesh's device: deterministic in the submitted seeds
        and the co-batch composition, the same on every rank."""
        op = key[2]
        nbr = self._tenants[key[1]].nbr
        eng = nbr._engine
        dev = eng.device
        if op == "walk":
            length = key[3]
            res, words = [], []
            for r in grp:
                g = _host_gen(r.seed)
                starts = np.asarray(r.payload["starts"]).reshape(-1)
                w = len(starts)
                noise = [(eng.draw_level1_noise(g), eng.draw_noise(w, g),
                          None) for _ in range(length)]
                end, _, cw, _ = eng.walk_scan(starts, noise, rounds=0)
                res.append((end.cpu().numpy(), None))
                words.append(cw)
            self._scatter(grp, res, torch.stack([w.cpu() for w in words]))
            return
        seeds = [int(r.seed) % (1 << 32) for r in grp]
        g = torch.Generator().manual_seed(int(
            np.random.SeedSequence(seeds).generate_state(1)[0]))
        rows = [np.atleast_2d(np.asarray(r.payload["y"], np.float32))
                if op == "query" else np.asarray(r.payload["src"])
                .reshape(-1) for r in grp]
        offs = np.cumsum([0] + [len(a) for a in rows])
        cat = np.concatenate(rows)
        l1 = eng.draw_level1_noise(g)
        if op == "sample":
            nb, prob, _, cw = eng.fused_sample(cat, l1,
                                               eng.draw_noise(len(cat), g))
            nb, prob = nb.cpu().numpy(), prob.cpu().numpy()
            res = [(nb[offs[i]:offs[i + 1]], prob[offs[i]:offs[i + 1]])
                   for i in range(len(grp))]
        elif op == "prob_of":
            dst = np.concatenate([np.asarray(r.payload["dst"]).reshape(-1)
                                  for r in grp])
            bs, cw = eng.masked_block_sums(cat, l1)
            prob, cw2 = eng.prob_of_from_block_sums(cat, dst, bs)
            cw = _c.fold(cw, cw2)
            prob = prob.cpu().numpy()
            res = [prob[offs[i]:offs[i + 1]] for i in range(len(grp))]
        elif op == "query":
            est, cw = eng.kde_query(torch.as_tensor(cat).to(dev), l1)
            est = est.cpu().numpy()
            res = [est[offs[i]:offs[i + 1]] for i in range(len(grp))]
        else:                                          # pragma: no cover
            raise ValueError(op)
        # ONE counter word covers the whole concatenated batch: note it
        # once and fan only its status bits out to the group
        st = self.device_counters.note(cw)
        self._scatter(grp, res, np.full(len(grp), st, np.int64))

    # ------------------------------------------------------------------ #
    def report(self) -> dict:
        """Lifetime counters + or-folded flags for ops dashboards."""
        return dict(ticks=self.ticks, served=self.served,
                    failed=self.failed, admissions=self.admissions,
                    evictions=self.evictions,
                    resident=[n for n in self._lru],
                    tenants=len(self._tenants),
                    flags=_g.decode_status(self.status),
                    flag_counts=dict(self.flag_counts),
                    device_counters=self.device_counters.as_dict())
