"""Fault-injection harness for the estimation runtime (DESIGN.md §11).

Each injector corrupts ONE well-defined thing (dataset rows, the kernel
bandwidth, the frozen hash layout, the heartbeat stream) and each scenario
drives a real pipeline of the port over the corrupted input, asking one
question: does the runtime *detect* the fault (status flag /
``EstimationError``) or *survive* it (finite, sane output)?  Silent
garbage is the only failure.  The scenarios, their data and their
outcomes are the reference's; the pipelines run on ``device`` (the CUDA
card by default, ``device="cpu"`` for the plain versions).

>>> from repro_torch.ft import chaos
>>> report = chaos.run_scenario("nan_rows_hashed_query", device="cpu")
>>> report["detected"] or report["survived"]
True
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ft import guards
from repro_torch.obs import metrics as _m

# ------------------------------------------------------------- injectors


def nan_rows(x: np.ndarray, rows, value: float = np.nan) -> np.ndarray:
    """Overwrite whole dataset rows with NaN (or ``value=np.inf``)."""
    out = np.array(x, np.float32, copy=True)
    out[np.asarray(rows)] = np.float32(value)
    return out


def duplicate_points(x: np.ndarray, frac: float, rng) -> np.ndarray:
    """Collapse a ``frac`` fraction of rows onto row 0 (mass pile-up)."""
    out = np.array(x, np.float32, copy=True)
    k = max(int(frac * len(out)), 1)
    idx = rng.choice(len(out), size=k, replace=False)
    out[idx] = out[0]
    return out


def tiny_bandwidth_kernel(make, bandwidth: float = 1e-30):
    """A kernel whose bandwidth underflows every pairwise value to 0 --
    the zero-mass degenerate limit."""
    return make(bandwidth)


def corrupt_hash_state(state, rng, n: int, frac: float = 0.25):
    """Flip a fraction of stored member indices out of ``[0, n)`` -- the
    silent-corruption case: a gather would read plausible numbers from
    the wrong rows without ``guards.STATE_CORRUPT``."""
    members = state.members.cpu().numpy().astype(np.int32, copy=True)
    flat = members.reshape(-1)
    k = max(int(frac * flat.size), 1)
    idx = rng.choice(flat.size, size=k, replace=False)
    flat[idx] = np.int32(n + 1 + rng.integers(0, 7, size=k))
    return state._replace(
        members=torch.as_tensor(members).to(state.members.device))


def adversarial_far_field(n: int, d: int, rng):
    """Dataset + queries engineered so ONE far-field point carries nearly
    all of the row mass: the bulk sits ~100 bandwidths away (kernel value
    underflows to 0), one point sits a couple of grid cells from the
    queries -- outside every NEAR bucket, close enough to dominate
    (``guards.HT_HEAVY``)."""
    x = rng.standard_normal((n, d)).astype(np.float32) + 100.0
    x[0] = 0.0
    x[0, 0] = 2.0                               # the lone heavy point
    y = rng.standard_normal((8, d)).astype(np.float32) * 1e-3
    return x, y


def silent_hosts(hosts: int, silent, timeout_s: float = 10.0,
                 now0: float = 0.0):
    """Watchdog scenario: ``silent`` hosts never heartbeat.  Returns the
    decision dict after the timeout has elapsed for everyone."""
    from repro_torch.ft.watchdog import Watchdog

    wd = Watchdog(hosts=hosts, heartbeat_timeout_s=timeout_s, now=now0)
    silent = set(int(s) for s in silent)
    for h in range(hosts):
        if h not in silent:
            wd.beat(h, 1.0, now=now0 + 2.0 * timeout_s)
    return wd.decide(now=now0 + 2.5 * timeout_s)


# ------------------------------------------------------------- scenarios
# Every scenario returns {"detected": bool, "survived": bool, "detail": str}
# -- detected = a guard fired (flag observed, or EstimationError raised
# under REPRO_CHECKS); survived = the pipeline produced finite sane output.


def _dataset(rng, n: int = 192, d: int = 3) -> np.ndarray:
    return rng.standard_normal((n, d)).astype(np.float32)


def _outcome(fn: Callable[[], tuple]) -> Dict:
    """Run one scenario body (-> (status int, survived bool, detail));
    an ``EstimationError`` counts as detection, any other exception is a
    genuine harness failure and propagates."""
    try:
        status, survived, detail = fn()
    except guards.EstimationError as e:
        return {"detected": True, "survived": False, "detail": str(e)}
    return {"detected": bool(status), "survived": bool(survived),
            "detail": detail or guards.decode_status(status)}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _nan_rows_hashed_query(rng, dev):
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian

    x = nan_rows(_dataset(rng), rows=[3, 17, 40])
    est = HashedKDE(x, gaussian(1.0), seed=0, max_bucket=32,
                    num_far_samples=16, device=dev)
    vals = _host(est.query(torch.as_tensor(x[:16])))
    return est.status, np.all(np.isfinite(vals)), ""


def _inf_rows_sampler(rng, dev):
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler

    x = nan_rows(_dataset(rng), rows=[5], value=np.inf)
    nbr = NeighborSampler(x, gaussian(1.0), mode="blocked", block_size=32,
                          seed=0, device=dev)
    nb, prob = nbr.sample(np.arange(16))
    return nbr.status, np.all(np.isfinite(prob)), ""


def _tiny_bandwidth_zero_mass(rng, dev):
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler

    ker = tiny_bandwidth_kernel(gaussian)     # every k(u, v) underflows
    nbr = NeighborSampler(_dataset(rng), ker, mode="blocked",
                          block_size=32, seed=0, device=dev)
    nb, prob = nbr.sample(np.arange(16))
    return nbr.status, np.all(np.isfinite(prob)), ""


def _duplicate_points_survive(rng, dev):
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler

    x = duplicate_points(_dataset(rng), frac=0.5, rng=rng)
    nbr = NeighborSampler(x, gaussian(1.0), mode="blocked", block_size=32,
                          seed=0, device=dev)
    nb, prob = nbr.sample(np.arange(16))
    ok = (np.all(np.isfinite(prob)) and np.all(prob > 0)
          and np.all(nb != np.arange(16)))
    return int(nbr.status) & guards.FATAL, ok, ""


def _corrupt_hash_state(rng, dev):
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian

    x = _dataset(rng)
    est = HashedKDE(x, gaussian(1.0), seed=0, max_bucket=32,
                    num_far_samples=16, device=dev)
    est.state = corrupt_hash_state(est.state, rng, n=len(x))
    vals = _host(est.query(torch.as_tensor(x[:16])))
    return est.status & guards.STATE_CORRUPT, np.all(np.isfinite(vals)), ""


def _adversarial_far_field(rng, dev):
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian

    x, y = adversarial_far_field(512, 3, rng)
    est = HashedKDE(x, gaussian(0.5), seed=0, max_bucket=16,
                    num_far_samples=16, device=dev)
    seen = 0
    for _ in range(64):                    # the heavy hit is probabilistic
        _host(est.query(torch.as_tensor(y)))
        seen |= est.status
        if seen & guards.HT_HEAVY:
            break
    return seen & guards.HT_HEAVY, True, ""


def _reject_exhaustion(rng, dev):
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler

    import warnings

    # bandwidth 1.0 keeps every row's mass healthy (no ZERO_MASS); the
    # injected fault is ONLY the zero-headroom accept test below
    nbr = NeighborSampler(_dataset(rng, n=256), gaussian(1.0),
                          mode="blocked", block_size=32,
                          samples_per_block=2, seed=0, device=dev)
    # slack ~1 gives the accept test no headroom: all-rounds-reject events
    # are near-certain, the documented fallback path must engage + count
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cur = nbr.sample_exact(np.arange(64), rounds=2, slack=1.0 + 1e-6)
    ok = (np.all(np.isfinite(cur)) and nbr.exact_fallbacks >= 0
          and nbr.exact_draws == 64)
    return nbr.status & guards.REJECT_EXHAUSTED, ok, \
        f"fallbacks={nbr.exact_fallbacks}/{nbr.exact_draws}"


def _robust_escalation(rng, dev):
    from repro_torch.core.kernels_fn import gaussian

    x = _dataset(rng)
    est = guards.RobustEstimator(x, gaussian(1.0), seed=0,
                                 stage_kw={"hash": {"max_bucket": 32,
                                                    "num_far_samples": 16}},
                                 device=dev)
    # poison the first stage AFTER build: its queries go bad, the wrapper
    # must escalate to stratified/exact and still return sane numbers
    hash_stage = est._stage("hash")
    hash_stage.state = corrupt_hash_state(hash_stage.state, rng, n=len(x),
                                          frac=1.0)
    vals = _host(est.query(torch.as_tensor(x[:16])))
    recovered = np.all(np.isfinite(vals)) and np.all(vals > 0)
    escalated = sum(est.escalations.values()) > 0 or est.retries > 0
    return est.status, bool(recovered and escalated), \
        f"escalations={est.escalations} retries={est.retries}"


def _silent_host_watchdog(rng, dev):
    res = silent_hosts(hosts=4, silent=[2], timeout_s=10.0)
    detected = 2 in res["dead"]
    return int(detected), res["dead"] == [2], str(res)


def _overflow_insert_storm(rng, dev):
    """Streaming fault (DESIGN.md §12): an insert storm aimed at ONE grid
    cell.  New rows whose cell is absent from the frozen bucket layout
    land in the overflow region; a storm of them must saturate it and
    surface ``OVERFLOW_SATURATED`` (an ``EstimationError`` under
    ``REPRO_CHECKS=1``, an automatic compaction otherwise) -- never a
    silently-dropped row."""
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian

    x = _dataset(rng)
    ds = DynamicDataset(x, capacity=1024, device=dev)
    est = HashedKDE(x, gaussian(1.0), seed=0, max_bucket=8,
                    num_far_samples=16, dataset=ds, overflow_cap=16)
    target = x[0] + np.float32(50.0)     # one far-away (= unhashed) cell
    seen, vals = 0, np.zeros(1)
    for _ in range(8):                   # 8 * 8 rows >> overflow_cap
        ds.insert_rows(np.tile(target, (8, 1))
                       + rng.normal(scale=1e-3, size=(8, 3)).astype(
                           np.float32))
        vals = _host(est.query(torch.as_tensor(x[:4])))
        seen |= est.status
        if seen & guards.OVERFLOW_SATURATED:
            break
    return (seen & guards.OVERFLOW_SATURATED,
            np.all(np.isfinite(vals)) and est.rebuilds > 0,
            f"rebuilds={est.rebuilds}")


def _delete_query_race(rng, dev):
    """Streaming fault (DESIGN.md §12): deletes racing a fixed query
    frontier toward an empty dataset.  Once a frontier row dies, the
    sampler must surface ``EPOCH_STALE`` (raising under
    ``REPRO_CHECKS=1``) instead of sampling from sentinel coordinates."""
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler

    x = _dataset(rng)
    ds = DynamicDataset(x, capacity=256, device=dev)
    nbr = NeighborSampler(x, gaussian(1.0), mode="blocked", block_size=32,
                          seed=0, dataset=ds)
    src = np.arange(8)
    order = rng.permutation(len(x))
    seen = 0
    for lo in range(0, len(x) - 16, 16):
        ds.delete_rows(order[lo:lo + 16])
        nbr.sample(src)
        seen |= nbr.status
        if seen & guards.EPOCH_STALE:
            break
    return seen & guards.EPOCH_STALE, True, guards.decode_status(seen)


def _serve_eviction_mid_stream(rng, dev):
    """Serving fault (DESIGN.md §13): an LRU capacity of ONE under a
    request stream that alternates tenants, so EVERY tick evicts one
    tenant's device state and rebuilds the other's from its dataset.
    Eviction must be invisible to correctness -- each request completes
    with finite sane output and no fatal flag."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.serving import KernelGraphServable

    srv = KernelGraphServable(max_resident=1, device=dev)
    for name, shift in (("a", 0.0), ("b", 0.5)):
        srv.add_tenant(name, _dataset(rng) + np.float32(shift),
                       gaussian(1.0), block_size=32, seed=0)
    reqs = []
    for t in range(4):
        reqs.append(srv.submit("ab"[t % 2], "sample", src=np.arange(8),
                               seed=11 * t))
        srv.tick()
    ok = all(r.error is None and np.all(np.isfinite(r.result[1]))
             for r in reqs)
    return (srv.status & guards.FATAL, bool(ok and srv.evictions >= 2),
            f"evictions={srv.evictions}")


def _serve_stale_tenant_mutation(rng, dev):
    """Serving fault (DESIGN.md §13): a tenant's dataset mutates between
    ``submit`` and ``tick``, killing the submitted request's frontier
    rows.  The tick must surface ``EPOCH_STALE`` on THAT request's own
    status word (its own ``EstimationError`` under ``REPRO_CHECKS=1``)
    while a clean tenant's request in the SAME tick is served normally."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.serving import KernelGraphServable

    srv = KernelGraphServable(device=dev)
    srv.add_tenant("mut", _dataset(rng), gaussian(1.0), block_size=32,
                   seed=0)
    srv.add_tenant("ok", _dataset(rng) + np.float32(1.0), gaussian(1.0),
                   block_size=32, seed=1)
    bad = srv.submit("mut", "sample", src=np.arange(8), seed=3)
    good = srv.submit("ok", "sample", src=np.arange(8), seed=4)
    srv.dataset("mut").delete_rows(np.arange(8))   # kill the frontier
    srv.tick()
    clean = good.error is None and not (good.status & guards.EPOCH_STALE)
    return (bad.status & guards.EPOCH_STALE, bool(clean),
            guards.decode_status(bad.status or 0) or "no flag")


SCENARIOS: Dict[str, Callable] = {
    "nan_rows_hashed_query": _nan_rows_hashed_query,
    "inf_rows_sampler": _inf_rows_sampler,
    "tiny_bandwidth_zero_mass": _tiny_bandwidth_zero_mass,
    "duplicate_points_survive": _duplicate_points_survive,
    "corrupt_hash_state": _corrupt_hash_state,
    "adversarial_far_field": _adversarial_far_field,
    "reject_exhaustion": _reject_exhaustion,
    "robust_escalation": _robust_escalation,
    "silent_host_watchdog": _silent_host_watchdog,
    "overflow_insert_storm": _overflow_insert_storm,
    "delete_query_race": _delete_query_race,
    "serve_eviction_mid_stream": _serve_eviction_mid_stream,
    "serve_stale_tenant_mutation": _serve_stale_tenant_mutation,
}

#: scenarios whose point is graceful SURVIVAL (no fatal flag expected);
#: everything else must be DETECTED (flag set or EstimationError raised)
SURVIVE_OK = frozenset((
    "duplicate_points_survive", "reject_exhaustion", "robust_escalation",
    "serve_eviction_mid_stream"))


def run_scenario(name: str, seed: int = 0, device=None) -> Dict:
    """Run one registered scenario on ``device``; returns the outcome dict.
    Injection and outcome flow through the obs event ring (DESIGN.md
    §15.2) so a chaos campaign is auditable from the same registry as the
    metrics."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    _m.event("chaos.inject", scenario=name, seed=seed)
    out = _outcome(lambda: SCENARIOS[name](rng, dev))
    _m.event("chaos.outcome", scenario=name, detected=out["detected"],
             survived=out["survived"])
    return out


def run_all(seed: int = 0, device=None) -> Dict[str, Dict]:
    """Run every scenario (the entry point ``tests/test_torch_chaos.py``
    holds against the reference's)."""
    return {name: run_scenario(name, seed=seed, device=device)
            for name in SCENARIOS}
