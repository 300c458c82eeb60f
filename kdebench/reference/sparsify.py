"""Plain reference of Algorithm 5.1 with exact probabilities, gaussian
kernel exp(-||x - y||^2 / sigma^2).

``sweep`` visits every pair once, in float64, and gives each point's
degree (diagonal left out), its sums of k_ij^2 and k_ij^3, and its mass in
each of 512 runs of consecutive points (the bins).
``graph_numbers`` holds the program's graphs to them:

- ``deg_rel``: the degrees the program drew its sources from, against the
  reference's, as the largest relative gap;
- ``wgt_rel``: every edge's weight against the reference's k(u, v) /
  (t q_e), q_e = p_u q(v | u) + p_v q(u | v) from the reference's kernel
  values and degrees, as the largest relative gap over all edges (a
  self-loop, of kernel value 0 in the graph, reads NaN: no exact sampler
  draws one);
- ``src_z``: the sources' counts in 512 runs of consecutive points against
  their degree mass, a chi-square z score (the vertex law);
- ``nbr_z``: the mean reference kernel value k(u, v) of all the edges
  against its expectation under the exact law of an edge, P(u, v) =
  k(u, v) / sum(deg): sum k^2 / sum(deg), with variance sum k^3 / sum(deg)
  less its square; |z| over the edges of all the graphs (the neighbor
  law, which an exact sampler's constant weights do not show);
- ``blk_z``: the same for the share of its source's mass that lies in the
  neighbor's bin, 512 times over, whose exact expectation is 512 sum_u
  p_u sum_B s_uB^2 (s_uB = the share of deg(u) in bin B): a draw of the
  wrong bin, even among bins of all but equal mass, moves it;
- ``dup_ratio``: pairs of draws that hit the same edge, over all the
  graphs, against the number an exact sampler expects, C(t, 2) * 2 *
  sum_ij k_ij^2 / sum(deg)^2 a graph; held from below and above.

``control_graph`` is the control: the same sampler written plainly with
TF32 products, drawing its own edges.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .precision import chi2_z, round_tf32

BINS = 512


def _blocks(n: int, block: int):
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)


def kernel_rows(x: torch.Tensor, rows: torch.Tensor, inv_bw2: float,
                tf32: bool = False):
    """The kernel values of the points ``rows`` indexes against every point
    (the diagonal at 0): float64
    from float64 coordinates, or float32 with the cross term of TF32
    operands (the squared norms stay float32, as beside a TF32 matmul)."""
    if tf32:
        xf = x.float()
        xr = round_tf32(xf)
        xx = (xf * xf).sum(1)
        d2 = xx[rows][:, None] + xx[None, :] - 2.0 * (xr[rows] @ xr.T)
    else:
        x64 = x.double()
        xx = (x64 * x64).sum(1)
        d2 = xx[rows][:, None] + xx[None, :] - 2.0 * (x64[rows] @ x64.T)
    d2.clamp_(min=0.0)
    k = torch.exp(-d2 * inv_bw2)
    k[torch.arange(rows.numel(), device=x.device), rows] = 0.0
    return k


def sweep(x: torch.Tensor, inv_bw2: float, tf32: bool = False,
          block: int = 256) -> dict:
    """Degrees, sums of k^2 and k^3 and (``bin``, (n, BINS)) the mass in
    each bin of every point, float64 tensors on the points' device
    (accumulated in float32 with ``tf32``)."""
    n = x.shape[0]
    out = {key: torch.empty(n, dtype=torch.float64, device=x.device)
           for key in ("deg", "ksq", "kcube")}
    out["bin"] = torch.zeros((n, BINS), dtype=torch.float64, device=x.device)
    bins = torch.arange(n, device=x.device) * BINS // n
    with torch.no_grad():
        for lo, hi in _blocks(n, block):
            rows = torch.arange(lo, hi, device=x.device)
            k = kernel_rows(x, rows, inv_bw2, tf32)
            out["deg"][lo:hi] = k.sum(1)
            k2 = k * k
            out["ksq"][lo:hi] = k2.sum(1)
            out["kcube"][lo:hi] = (k2 * k).sum(1)
            out["bin"][lo:hi].index_add_(1, bins, k.double())
            del k, k2
    return out


def _worst(old: float, new: float) -> float:
    """The larger of two readings; NaN, a reading that is not one, wins."""
    return new if math.isnan(new) or new > old else old


def graph_numbers(x: torch.Tensor, sw: dict, graphs: list, t: int,
                  inv_bw2: float) -> dict:
    """The numbers above for the program's ``graphs`` (each a dict of
    numpy ``src``, ``dst``, ``weight``, ``degrees``); ``edge_gap`` is the
    largest |edges - t|.  The per-graph numbers are the largest over the
    graphs; ``nbr_z`` and ``dup_ratio`` pool the graphs."""
    dev = x.device
    x64 = x.double()
    deg_ref = sw["deg"]
    total = float(deg_ref.sum())
    k_mean = float(sw["ksq"].sum()) / total
    k_var = float(sw["kcube"].sum()) / total - k_mean ** 2
    pair_sq = 2.0 * float(sw["ksq"].sum()) / total ** 2
    n = x.shape[0]
    bins = torch.arange(n, device=dev) * BINS // n
    share = sw["bin"] / deg_ref[:, None]
    p_src = deg_ref / total
    b_mean = BINS * float((p_src * (share ** 2).sum(1)).sum())
    b_var = BINS ** 2 * float((p_src * (share ** 3).sum(1)).sum()) \
        - b_mean ** 2
    mass = torch.zeros(BINS, dtype=torch.float64, device=dev)
    mass.index_add_(0, bins, deg_ref)
    res = dict(edge_gap=0.0, deg_rel=0.0, wgt_rel=0.0, src_z=-math.inf)
    k_sum, b_sum, edges, hits, expect = 0.0, 0.0, 0, 0.0, 0.0
    with torch.no_grad():
        for g in graphs:
            src = torch.as_tensor(np.asarray(g["src"]), device=dev)
            dst = torch.as_tensor(np.asarray(g["dst"]), device=dev)
            w = torch.as_tensor(np.asarray(g["weight"], np.float64),
                                device=dev)
            m = src.numel()
            res["edge_gap"] = max(res["edge_gap"], abs(m - t))
            deg = torch.as_tensor(np.asarray(g["degrees"], np.float64),
                                  device=dev)
            res["deg_rel"] = _worst(res["deg_rel"], float(
                ((deg - deg_ref).abs() / deg_ref).max()))
            d2 = ((x64[src] - x64[dst]) ** 2).sum(1)
            kuv = torch.where(src == dst, 0.0, torch.exp(-d2 * inv_bw2))
            q_e = (deg_ref[src] * (kuv / deg_ref[src])
                   + deg_ref[dst] * (kuv / deg_ref[dst])) / total
            w_ref = kuv / (t * q_e)
            res["wgt_rel"] = _worst(res["wgt_rel"], float(
                ((w - w_ref).abs() / w_ref).max()))
            k_sum += float(kuv.sum())
            b_sum += BINS * float(share[src, bins[dst]].sum())
            edges += m
            got = torch.bincount(bins[src], minlength=BINS)
            res["src_z"] = _worst(res["src_z"],
                                  chi2_z(got, m * mass / mass.sum()))
            lo_ = torch.minimum(src, dst)
            hi_ = torch.maximum(src, dst)
            _, c = torch.unique(lo_ * n + hi_, return_counts=True)
            hits += float((c * (c - 1) // 2).sum())
            expect += m * (m - 1) / 2.0 * pair_sq
    res["nbr_z"] = abs(k_sum / max(edges, 1) - k_mean) / math.sqrt(
        k_var / max(edges, 1))
    res["blk_z"] = abs(b_sum / max(edges, 1) - b_mean) / math.sqrt(
        b_var / max(edges, 1))
    res["dup_ratio"] = hits / expect if expect > 0 else math.nan
    return res


def control_graph(x: torch.Tensor, inv_bw2: float, t: int, seed: int,
                  sw: dict | None = None, chunk: int = 1024) -> dict:
    """The control: Algorithm 5.1 with exact probabilities, written
    plainly, every kernel value from TF32 products: sources by the TF32
    degrees, each neighbor by inverse CDF over its source's TF32 row, the
    weight k(u, v) / (t q_e).  Returns a graph as ``graph_numbers`` takes
    it (numpy arrays)."""
    dev = x.device
    sw = sweep(x, inv_bw2, tf32=True) if sw is None else sw
    deg = sw["deg"]
    total = float(deg.sum())
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    cdf = torch.cumsum(deg, 0) / total
    u = torch.searchsorted(cdf, torch.rand(t, generator=gen, device=dev,
                                           dtype=torch.float64), right=True)
    u.clamp_(0, x.shape[0] - 1)
    v = torch.empty_like(u)
    kuv = torch.empty(t, dtype=torch.float64, device=dev)
    with torch.no_grad():
        for lo, hi in _blocks(t, chunk):
            k = kernel_rows(x, u[lo:hi], inv_bw2, tf32=True)
            cum = torch.cumsum(k.double(), dim=1)
            r = torch.rand((hi - lo, 1), generator=gen, device=dev,
                           dtype=torch.float64) * cum[:, -1:]
            vv = torch.searchsorted(cum, r, right=True)[:, 0]
            vv.clamp_(0, x.shape[0] - 1)
            v[lo:hi] = vv
            kuv[lo:hi] = k[torch.arange(hi - lo, device=dev), vv].double()
            del k, cum
    q_uv = kuv / deg[u]
    q_e = (deg[u] * q_uv + kuv) / total
    w = kuv / (t * q_e)
    return dict(src=u.cpu().numpy(), dst=v.cpu().numpy(),
                weight=w.cpu().numpy(), degrees=deg.cpu().numpy())
