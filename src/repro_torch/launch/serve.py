"""Batched LM serving driver: prefill a batch of prompts, then decode with
the KV cache -- optionally with the paper's KDE attention for long
contexts.  The port of the LM path of ``repro.launch.serve``.

Example (CPU, reduced config):
  python -m repro_torch.launch.serve --device cpu --reduced --batch 4 \\
      --prompt-len 64 --gen 16
  python -m repro_torch.launch.serve --device cpu --reduced --attention kde

On the card (the default device) without ``--reduced`` it serves the full
configuration with random weights drawn on the card.  Every family serves
(``--arch granite_moe_1b_a400m``, ``rwkv6_3b``, ``zamba2_7b``,
``seamless_m4t_medium``, ``internvl2_1b``, ...).  As in the reference,
the cache is built by replaying the prompt's tokens through the decode
step (teacher-forced), so the "prefill" time is that replay (a frontend's
embeddings are not replayed; the enc-dec encoder runs once over them and
its memory goes into the cache); the model runs in float32 whatever the
config says, as the reference's driver does.  ``--robust`` screens each
decode step's logits and recomputes a step with non-finite logits with
dense xla attention from the pre-step cache (DESIGN.md §11).

``--graph-stream N`` serves the OTHER side of the repo instead: an online
kernel-graph service over a mutating point set (DESIGN.md §12).  Each tick
mutates a fraction of the rows (insert/delete/update), then answers vertex
/ neighbor / edge-batch queries at the new epoch -- the samplers patch
their level-1 / degree / hash state instead of rebuilding.  The final
``[serve] metrics {...}`` line is machine-parsable JSON (per-tick
latencies, epoch, flags); a guard trip under ``REPRO_CHECKS=1`` exits 3:

  python -m repro_torch.launch.serve --device cpu --graph-stream 4096 \
      --ticks 8 --mutate-frac 0.01 --level1 hash

``--serve-tenants S`` runs the multi-tenant batched servable instead
(DESIGN.md §13): S mixed tenants (blocked + hashed level-1), ``--requests
R`` concurrent mixed requests per tick batched into padded groups, with
p50/p99 request latency and throughput in the metrics line:

  python -m repro_torch.launch.serve --device cpu --serve-tenants 4 \
      --requests 16 --ticks 4
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config, get_reduced
from repro_torch.data.pipeline import make_batch, token_split
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import export as _export
from repro_torch.obs import metrics as _metrics
from repro_torch.train.train_step import make_decode_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--attention", choices=["xla", "kde"], default="xla")
    ap.add_argument("--kde-top-p", type=int, default=4)
    ap.add_argument("--kde-bk", type=int, default=32)
    ap.add_argument("--kde-stride", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--robust", action="store_true",
                    help="screen decode logits; recompute flagged steps "
                         "with dense xla attention from the pre-step cache")
    ap.add_argument("--graph-stream", type=int, default=0,
                    help="serve an online kernel graph over N points "
                         "instead of the LLM path (DESIGN.md §12)")
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--mutate-frac", type=float, default=0.01)
    ap.add_argument("--level1", choices=["blocked", "hash"],
                    default="blocked")
    ap.add_argument("--reuse-frontier", action="store_true",
                    help="graph-stream: query the PREVIOUS tick's vertex "
                         "frontier (a scripted delete of those rows then "
                         "trips the EPOCH_STALE consumer check)")
    ap.add_argument("--serve-tenants", type=int, default=0,
                    help="run the multi-tenant batched servable over S "
                         "tenants instead (DESIGN.md §13)")
    ap.add_argument("--requests", type=int, default=16,
                    help="concurrent requests per serving tick")
    ap.add_argument("--max-resident", type=int, default=4,
                    help="LRU bound on tenants holding device state")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the obs metrics registry (latency "
                         "histograms, counters; off by default so the "
                         "serving hot path stays branch-only)")
    ap.add_argument("--metrics-format", choices=["jsonl", "prometheus"],
                    default="jsonl",
                    help="'prometheus' additionally dumps the registry "
                         "in Prometheus text format after the run")
    return ap


def _emit_metrics(payload: dict) -> None:
    """One schema-stamped JSON-lines metrics record (``obs.export``; the
    reference's ``tools/check_metrics_schema.py`` reads it)."""
    _export.emit_jsonl(payload)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_graph_stream(args, trace=None) -> int:
    """Online kernel-graph serving loop (DESIGN.md §12): mutate, then
    answer at the new epoch.  Cost per tick: O(m) mutation bookkeeping +
    one coalesced patch (O(w m) level-1, O(n m) degrees, O(m) hash
    splices) folded into the first query, against the frozen engines'
    full rebuild.

    ``trace`` optionally scripts the mutations: a list of per-tick dicts
    with any of ``insert`` ((m, d) rows), ``delete`` (slot ids, or the
    string ``"frontier"`` to delete rows of the PREVIOUS tick's query
    frontier -- with ``--reuse-frontier`` this forces an ``EPOCH_STALE``
    consumer-side detection), and ``update`` ((slots, rows)).  Exit codes:
    0 clean; 3 when ``REPRO_CHECKS=1`` promoted a status flag to an
    ``EstimationError``."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.streaming import StreamingKernelGraph
    from repro_torch.ft.guards import EstimationError

    dev = resolve_device(getattr(args, "device", None))
    n, d = int(args.graph_stream), 16
    rng = np.random.default_rng(args.seed)
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    g = StreamingKernelGraph(x0, gaussian(1.0), level1=args.level1,
                             seed=args.seed, device=dev)
    m = max(int(n * args.mutate_frac), 1)
    ticks = len(trace) if trace is not None else args.ticks
    reuse = bool(getattr(args, "reuse_frontier", False))
    mut_t = qry_t = 0.0
    ticks_done = 0
    frontier = None
    err = None
    try:
        for tick in range(ticks):
            t0 = time.perf_counter()
            if trace is not None:
                step = trace[tick]
                if step.get("insert") is not None:
                    g.insert(np.asarray(step["insert"], np.float32))
                dele = step.get("delete")
                if dele is not None:
                    if isinstance(dele, str) and dele == "frontier":
                        dele = (frontier if frontier is not None else
                                g.dataset.live_slots()[:m])
                    g.delete(np.asarray(dele))
                if step.get("update") is not None:
                    slots, rows = step["update"]
                    g.update(np.asarray(slots),
                             np.asarray(rows, np.float32))
            else:
                live = g.dataset.live_slots()
                g.insert(rng.normal(size=(m, d)).astype(np.float32))
                g.delete(rng.choice(live, size=m, replace=False))
                upd = rng.choice(g.dataset.live_slots(), size=m,
                                 replace=False)
                g.update(upd, rng.normal(size=(m, d)).astype(np.float32))
            _sync(dev)
            mut_t += time.perf_counter() - t0
            t0 = time.perf_counter()
            u = (frontier if reuse and frontier is not None else
                 g.sample_vertices(min(256, n)))
            v, _ = g.sample_neighbors(u)
            g.sample_edges(min(512, n))
            _sync(dev)
            qry_t += time.perf_counter() - t0
            assert g.dataset.is_live(v), "sampled a dead neighbor"
            frontier = u
            ticks_done += 1
    except EstimationError as e:
        err = str(e)
        print(f"[serve] guard tripped at tick {ticks_done}: {e}")
    rep = g.status_report()
    per = max(ticks_done, 1)
    print(f"[serve] graph-stream n={n} ticks={ticks_done}/{ticks} "
          f"mutate_frac={args.mutate_frac} level1={args.level1} "
          f"device={dev}")
    print(f"[serve] mutation {1e3 * mut_t / per:.1f} ms/tick, "
          f"queries {1e3 * qry_t / per:.1f} ms/tick "
          f"(patch-on-read, no rebuilds in the hot path)")
    _emit_metrics(dict(
        mode="graph-stream", n=n, ticks=ticks_done, ticks_planned=ticks,
        mutation_ms_per_tick=round(1e3 * mut_t / per, 3),
        query_ms_per_tick=round(1e3 * qry_t / per, 3),
        epoch=int(rep["epoch"]), live=int(rep["num_live"]),
        flags=rep["flags"], degree_rebuilds=int(rep["degree_rebuilds"]),
        hash_rebuilds=int(rep["hash_rebuilds"]), error=err))
    return 3 if err is not None else 0


def run_multi_tenant(args) -> int:
    """Multi-tenant batched serving loop (DESIGN.md §13): S tenants with
    mixed estimator configs, ``--requests`` concurrent mixed requests per
    tick drained into padded batch groups.  Reports p50/p99 submit ->
    completion latency and served-requests/s (steady-state: the first
    tick runs every (op, bucket) group shape off-clock).  Exit codes: 0
    clean; 3 when ``REPRO_CHECKS=1`` turned a request's status flags into
    a per-request error."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.serving import KernelGraphServable

    if args.telemetry:
        _metrics.enable()
    S, R = int(args.serve_tenants), int(args.requests)
    n, d = 2048, 8
    rng = np.random.default_rng(args.seed)
    srv = KernelGraphServable(max_resident=int(args.max_resident),
                              device=getattr(args, "device", None))
    for i in range(S):
        x = rng.normal(size=(n, d)).astype(np.float32) + 0.1 * i
        level1 = "hash" if (args.level1 == "hash" and i % 2 == 1) else \
            "blocked"
        # one shared kernel config: tenants with equal static signatures
        # stack into the same batch group (the cross-tenant win)
        srv.add_tenant(f"t{i}", x, gaussian(1.0), level1=level1,
                       seed=args.seed + i)

    def submit_mix(tick):
        reqs = []
        for r in range(R):
            tn = f"t{(r + tick) % S}"
            op = ("sample", "query", "walk", "prob_of")[r % 4]
            seed = args.seed + 1000 * tick + r
            if op == "sample":
                reqs.append(srv.submit(tn, "sample", seed=seed,
                                       src=rng.integers(0, n, size=16)))
            elif op == "query":
                reqs.append(srv.submit(
                    tn, "query", seed=seed,
                    y=rng.normal(size=(8, d)).astype(np.float32)))
            elif op == "walk":
                reqs.append(srv.submit(tn, "walk", seed=seed, length=4,
                                       starts=rng.integers(0, n, size=8)))
            else:
                reqs.append(srv.submit(tn, "prob_of", seed=seed,
                                       src=rng.integers(0, n, size=16),
                                       dst=rng.integers(0, n, size=16)))
        return reqs

    submit_mix(0)
    srv.tick()                       # warmup: every group shape once
    lat = []
    failed = stale = 0
    per_tenant: dict = {}
    t0 = time.perf_counter()
    for tick in range(1, args.ticks + 1):
        reqs = submit_mix(tick)
        stale += srv.tick()["stale"]
        for r in reqs:
            lat.append(r.latency)
            pt = per_tenant.setdefault(
                r.tenant, dict(served=0, failed=0, lat_ms=[]))
            pt["lat_ms"].append(1e3 * r.latency)
            if r.error is None:
                pt["served"] += 1
            else:
                pt["failed"] += 1
                failed += 1
    wall = time.perf_counter() - t0
    lat_ms = 1e3 * np.asarray(lat)
    rep = srv.report()
    served = args.ticks * R - failed
    print(f"[serve] multi-tenant S={S} R={R}/tick ticks={args.ticks} "
          f"max_resident={args.max_resident} device={srv.device}")
    print(f"[serve] p50 {np.percentile(lat_ms, 50):.1f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms, "
          f"{served / max(wall, 1e-9):.1f} req/s "
          f"(admissions={rep['admissions']} evictions={rep['evictions']})")
    _emit_metrics(dict(
        mode="multi-tenant", tenants=S, requests_per_tick=R,
        ticks=args.ticks, served=served, failed=failed, stale=stale,
        p50_ms=round(float(np.percentile(lat_ms, 50)), 3),
        p99_ms=round(float(np.percentile(lat_ms, 99)), 3),
        throughput_rps=round(served / max(wall, 1e-9), 2),
        admissions=rep["admissions"], evictions=rep["evictions"],
        realized_evals=rep["device_counters"]["evals"],
        device_counters=rep["device_counters"],
        per_tenant={
            k: dict(served=v["served"], failed=v["failed"],
                    p50_ms=round(float(np.percentile(v["lat_ms"], 50)), 3))
            for k, v in sorted(per_tenant.items())},
        flags=rep["flags"]))
    if args.metrics_format == "prometheus":
        print(_export.prometheus_text(), end="")
    return 3 if failed else 0


def serve_config(args):
    """The float32 config the driver serves and its cache length (rounded
    up to the KDE block size under ``--attention kde``)."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.attention == "kde":   # cache length must tile into KDE blocks
        max_len = ((max_len + args.kde_bk - 1) // args.kde_bk) * args.kde_bk
    return cfg, max_len


#: cache entries a decode step overwrites in place besides K/V slots: the
#: SSM recurrences' states, which a retried step must start again from
_STATE_KEYS = ("ssm", "shift")


def robust_step(step, dense_step):
    """The reference's staged fallback (DESIGN.md §11) around a decode
    ``step``: a step whose logits are not all finite is recomputed by
    ``dense_step`` (the dense xla twin, built lazily: ``dense_step()``
    returns it) from the pre-step cache.  The port's decode writes the
    cache in place: a K/V slot is simply rewritten by the retry, but the
    SSM / shift states are snapshotted before each step and restored for
    the retry, so the recurrence runs once.  Returns ``guarded(model,
    cache, tokens, pos)`` -> (next, logits, cache) with a ``fallbacks``
    attribute counting the recomputed steps."""
    twin = []

    def guarded(model, cache, cur, pos):
        snap = {k: cache[k].clone() for k in _STATE_KEYS if k in cache}
        nxt, logits, cache = step(model, cache, cur, pos)
        if not bool(torch.isfinite(logits).all()):
            if not twin:
                twin.append(dense_step())
            guarded.fallbacks += 1
            for k, t in snap.items():
                cache[k].copy_(t)
            nxt, logits, cache = twin[0](model, cache, cur, pos)
        return nxt, logits, cache

    guarded.fallbacks = 0
    return guarded


def run_lm(args, model=None) -> dict:
    """Serve one batch.  ``model`` (a ``Transformer``) replaces the random
    init drawn from ``--seed``, and its config (in float32) the ``--arch``
    one (a model cut in depth serves at its own depth).  Returns the generations (b,
    gen) int32, the logits of the last prompt step (the first generated
    token's; (b, V_pad) f32) and of the first decode step, the prefill and
    decode seconds (host clock, each ending in a synchronize on the card),
    the final cache, the config, the cache length, the prompt's token
    count and ``fallbacks`` (the steps ``--robust`` recomputed; None
    without it)."""
    dev = resolve_device(args.device)
    cfg, max_len = serve_config(args)
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    if model is None:
        model = T.init_params(cfg, seed=args.seed, device=dev)
    else:
        cfg = dataclasses.replace(model.cfg, dtype="float32")
    batch = make_batch(cfg, shape, 0, args.seed)
    split = token_split(cfg, shape)
    tokens = torch.as_tensor(batch["tokens"], device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill: replay the prompt's tokens into the cache (teacher-forced,
    # as the reference builds it); the enc-dec memory is the encoder's
    # output over the frontend embeddings
    cache = T.init_cache(cfg, args.batch, max_len, torch.float32,
                         enc_len=split["frontend"] or 1, device=dev)
    if cfg.is_encdec:
        with torch.inference_mode():
            cache["memory"] = T._run_encoder(model, cfg, batch["frontend"],
                                             "xla")
    kde_cfg = {"top_p": args.kde_top_p, "bk": args.kde_bk,
               "stride": args.kde_stride} if args.attention == "kde" else None
    step = make_decode_step(cfg, impl=args.attention, kde_cfg=kde_cfg)
    robust = bool(args.robust) and args.attention != "xla"
    if robust:
        step = robust_step(step, lambda: make_decode_step(cfg, impl="xla"))
    t0 = time.perf_counter()
    for pos in range(split["tokens"]):
        nxt, logits, cache = step(model, cache, tokens[:, pos:pos + 1], pos)
    sync()
    prefill_t = time.perf_counter() - t0
    prompt_logits = logits[:, -1]

    # decode
    out = [nxt]
    first_logits = None
    t0 = time.perf_counter()
    cur = nxt[:, None]
    for i in range(args.gen - 1):
        pos = split["tokens"] + i
        nxt, logits, cache = step(model, cache, cur, pos)
        if first_logits is None:
            first_logits = logits[:, -1]
        cur = nxt[:, None]
        out.append(nxt)
    gen = torch.stack(out, 1)
    sync()
    decode_t = time.perf_counter() - t0
    return dict(tokens=gen.cpu().numpy(), prompt_logits=prompt_logits,
                first_decode_logits=first_logits, prefill_s=prefill_t,
                decode_s=decode_t, cache=cache, cfg=cfg, max_len=max_len,
                prompt_tokens=split["tokens"],
                fallbacks=step.fallbacks if robust else None)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.serve_tenants:
        return run_multi_tenant(args)
    if args.graph_stream:
        return run_graph_stream(args)
    res = run_lm(args)
    gen = res["tokens"]
    print(f"[serve] arch={res['cfg'].name} attention={args.attention} "
          f"batch={args.batch} prompt={res['prompt_tokens']} gen={args.gen}")
    print(f"[serve] prefill {res['prefill_s']:.2f}s, decode "
          f"{res['decode_s']:.2f}s "
          f"({args.gen * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    if res["fallbacks"] is not None:
        print(f"[serve] robust: {res['fallbacks']} step(s) recomputed with "
              f"dense attention")
    print(f"[serve] sample generations: {np.asarray(gen[:2]).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
