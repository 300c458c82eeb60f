"""Attention-free sequence mixers, RWKV6 (Finch) and Mamba2 (SSD): the port
of ``repro.models.ssm``.

Both are implemented twice, as in the reference:
  * ``*_scan``    -- the literal per-timestep recurrence (the oracle, and
                     the decode step, where the recurrence is the
                     algorithm); a Python loop over the steps takes the
                     place of the reference's ``lax.scan``;
  * ``*_chunked`` -- the chunkwise-parallel form: intra-chunk masked
                     attention-like products plus an inter-chunk state
                     recurrence (a Python loop over the chunks).  Decay
                     ratios are taken in log space with the reference's
                     per-chunk clamp, ``_LOG_CLAMP`` = -30, in the same
                     places.

Dtypes are the reference's: the projections in x's dtype, the decay and
``dt`` math in f32, the states in f32, the RWKV shift state in x's dtype.
The reference's simplifications hold here too: rwkv6 has full-rank decay
projections and a SwiGLU channel mix; mamba2 has no depthwise conv1d (its
decode state is the SSM state only).  A parameter set is an ``RWKV6`` or
``Mamba2`` module in the reference's ``(in, out)`` layout; the ``init_*``
functions draw one from the ``torch.Generator`` passed as ``key``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _dense_init, _param, silu

_LOG_CLAMP = -30.0


def _check_chunks(s: int, c: int) -> None:
    if s % c:
        raise ValueError(f"sequence length {s} must be a multiple of the "
                         f"chunk size {c}")


# =================================================================== RWKV6
class RWKV6(nn.Module):
    """mu (5, d) token-shift lerps of r, k, v, g, w; wr / wk / wv / wg / ww
    (d, h hd); w0 and u (h hd,); wo (h hd, d)."""

    def __init__(self, mu, wr, wk, wv, wg, ww, w0, u, wo):
        super().__init__()
        for name, t in (("mu", mu), ("wr", wr), ("wk", wk), ("wv", wv),
                        ("wg", wg), ("ww", ww), ("w0", w0), ("u", u),
                        ("wo", wo)):
            setattr(self, name, _param(t))


def init_rwkv6(key: torch.Generator, cfg: ArchConfig) -> RWKV6:
    """The reference's init (its scales and constants) drawn from the
    generator ``key`` on its device."""
    d = cfg.d_model
    dh = cfg.num_heads * cfg.hd
    dev = key.device
    return RWKV6(
        torch.full((5, d), 0.5, device=dev),
        _dense_init(key, (d, dh)), _dense_init(key, (d, dh)),
        _dense_init(key, (d, dh)), _dense_init(key, (d, dh)),
        _dense_init(key, (d, dh), scale=0.01),
        torch.full((dh,), -2.0, device=dev),
        _dense_init(key, (dh,), scale=0.5),
        _dense_init(key, (dh, d)))


def _rwkv6_projections(p: RWKV6, cfg: ArchConfig, x, shift_state):
    """x (b, s, d); shift_state (b, d) = the previous token's x.  Returns
    r, k, v, g (b, s, h, hd) in x's dtype and logw (b, s, h, hd) < 0 in
    f32."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd
    prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]],
                     dim=1)
    mu = p.mu.to(x.dtype)

    def mix(i):
        return x + mu[i] * (prev - x)

    r = (mix(0) @ p.wr.to(x.dtype)).reshape(b, s, h, hd)
    k = (mix(1) @ p.wk.to(x.dtype)).reshape(b, s, h, hd)
    v = (mix(2) @ p.wv.to(x.dtype)).reshape(b, s, h, hd)
    g = (mix(3) @ p.wg.to(x.dtype)).reshape(b, s, h, hd)
    wraw = (mix(4).float() @ p.ww.float() + p.w0).reshape(b, s, h, hd)
    logw = -torch.exp(wraw)                    # log decay, always < 0
    return r, k, v, g, logw


def _rwkv6_out(p: RWKV6, x, y, g):
    """(y (b, s, h, hd) f32 * silu(g)) @ wo in x's dtype."""
    b, s = y.shape[:2]
    y = (y * silu(g.float())).reshape(b, s, -1)
    return y.to(x.dtype) @ p.wo.to(x.dtype)


def rwkv6_scan(p: RWKV6, cfg: ArchConfig, x, state=None, shift_state=None):
    """The recurrence, one step at a time.  state (b, h, hd, hd) f32;
    returns (out (b, s, d), state, shift_state = x[:, -1])."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=x.device)
    if shift_state is None:
        shift_state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _rwkv6_projections(p, cfg, x, shift_state)
    u = p.u.reshape(h, hd)
    ys = []
    for t in range(s):
        rt, kt, vt = (a[:, t].float() for a in (r, k, v))   # (b, h, hd)
        bonus = u[None] * kt
        y = torch.einsum("bhi,bhij->bhj", rt, state) \
            + torch.einsum("bhi,bhi->bh", rt, bonus)[..., None] * vt
        state = torch.exp(logw[:, t])[..., None] * state \
            + kt[..., None] * vt[..., None, :]
        ys.append(y)
    y = torch.stack(ys, dim=1)                 # (b, s, h, hd)
    return _rwkv6_out(p, x, y, g), state, x[:, -1, :]


def rwkv6_chunked(p: RWKV6, cfg: ArchConfig, x, chunk: int = 128):
    """The chunkwise form from a zero state; the sequence must divide into
    chunks of ``min(chunk, s)``.  Returns out (b, s, d)."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd
    c = min(chunk, s)
    _check_chunks(s, c)
    nc = s // c
    shift0 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _rwkv6_projections(p, cfg, x, shift0)
    u = p.u.reshape(h, hd)

    def to_chunks(a):                  # (b, s, h, hd) -> (nc, b, h, c, hd)
        return a.float().reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, logw))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device),
                      diagonal=-1)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        rt, kt, vt, lw = rc[i], kc[i], vc[i], lwc[i]    # (b, h, c, hd)
        lp = torch.cumsum(lw, dim=2) - lw      # exclusive cumsum: P_t
        lp_next = lp + lw                      # P_{t+1}
        lp_end = lp_next[:, :, -1:, :]         # P_C
        q_t = rt * torch.exp(torch.clamp(lp, min=_LOG_CLAMP))
        k_t = kt * torch.exp(torch.clamp(-lp_next, min=_LOG_CLAMP))
        attn = torch.einsum("bhti,bhsi->bhts", q_t, k_t) * mask
        bonus = torch.einsum("bhti,bhti->bht", rt,
                             u[None, :, None, :] * kt)
        y = torch.einsum("bhts,bhsj->bhtj", attn, vt) \
            + torch.einsum("bhti,bhij->bhtj", q_t, state) \
            + bonus[..., None] * vt
        ks = kt * torch.exp(torch.clamp(lp_end - lp_next, min=_LOG_CLAMP))
        state = torch.exp(torch.clamp(lp_end[:, :, 0], min=_LOG_CLAMP))[
            ..., None] * state + torch.einsum("bhsi,bhsj->bhij", ks, vt)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, hd)
    return _rwkv6_out(p, x, y, g)


# =================================================================== Mamba2
class Mamba2(nn.Module):
    """in_proj (d, 4d), bc_proj (d, 2n), dt_proj (d, hm); dt_bias, a_log,
    d_skip (hm,); out_proj (2d, d); hm = 2d / 64 SSD heads of 64."""

    def __init__(self, in_proj, bc_proj, dt_proj, dt_bias, a_log, d_skip,
                 out_proj):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("bc_proj", bc_proj),
                        ("dt_proj", dt_proj), ("dt_bias", dt_bias),
                        ("a_log", a_log), ("d_skip", d_skip),
                        ("out_proj", out_proj)):
            setattr(self, name, _param(t))


def init_mamba2(key: torch.Generator, cfg: ArchConfig) -> Mamba2:
    """The reference's init drawn from the generator ``key``: dt_bias 0,
    a_log = log(linspace(1, max(hm, 2), hm)), d_skip 1."""
    d = cfg.d_model
    di = 2 * d
    n = cfg.ssm_state
    hm = di // 64
    dev = key.device
    return Mamba2(
        _dense_init(key, (d, 2 * di)), _dense_init(key, (d, 2 * n)),
        _dense_init(key, (d, hm)),
        torch.zeros(hm, device=dev),
        torch.log(torch.linspace(1.0, float(max(hm, 2)), hm, device=dev)),
        torch.ones(hm, device=dev),
        _dense_init(key, (di, d)))


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` (torch's
    softplus returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mamba2_projections(p: Mamba2, cfg: ArchConfig, x):
    """Returns xh (b, s, hm, 64) and z (b, s, 2d) in x's dtype; B, C (b, s,
    n), dt and the log decay dt * a (b, s, hm) in f32."""
    b, s, d = x.shape
    n = cfg.ssm_state
    hm = (2 * d) // 64
    xz = x @ p.in_proj.to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)                         # (b, s, di)
    bc = x @ p.bc_proj.to(x.dtype)
    bmat, cmat = bc.float().chunk(2, dim=-1)             # (b, s, n)
    dt = _softplus(x.float() @ p.dt_proj.float() + p.dt_bias)   # (b, s, hm)
    a = -torch.exp(p.a_log)                              # (hm,)
    logdecay = dt * a[None, None, :]                     # (b, s, hm) < 0
    xh = xin.reshape(b, s, hm, 64)
    return xh, z, bmat, cmat, dt, logdecay


def _mamba2_out(p: Mamba2, x, y, z):
    """(y (b, s, 2d) f32 * silu(z)) @ out_proj in x's dtype."""
    y = y * silu(z.float())
    return y.to(x.dtype) @ p.out_proj.to(x.dtype)


def mamba2_scan(p: Mamba2, cfg: ArchConfig, x, state=None):
    """The recurrence, one step at a time.  state (b, hm, n, 64) f32;
    returns (out (b, s, d), state)."""
    b, s, d = x.shape
    n = cfg.ssm_state
    hm = (2 * d) // 64
    if state is None:
        state = torch.zeros((b, hm, n, 64), dtype=torch.float32,
                            device=x.device)
    xh, z, bmat, cmat, dt, logdecay = _mamba2_projections(p, cfg, x)
    ys = []
    for t in range(s):
        xt = xh[:, t].float()                            # (b, hm, 64)
        bt, ct, dtt = bmat[:, t], cmat[:, t], dt[:, t]
        state = torch.exp(logdecay[:, t])[..., None, None] * state \
            + (dtt[..., None] * bt[:, None, :])[..., None] * xt[:, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", ct, state)
                  + p.d_skip[None, :, None] * xt)
    y = torch.stack(ys, dim=1).reshape(b, s, 2 * d)
    return _mamba2_out(p, x, y, z), state


def mamba2_chunked(p: Mamba2, cfg: ArchConfig, x, chunk: int = 128):
    """The chunkwise (SSD) form from a zero state; the sequence must
    divide into chunks of ``min(chunk, s)``.  Returns out (b, s, d)."""
    b, s, d = x.shape
    n = cfg.ssm_state
    hm = (2 * d) // 64
    c = min(chunk, s)
    _check_chunks(s, c)
    nc = s // c
    xh, z, bmat, cmat, dt, logdecay = _mamba2_projections(p, cfg, x)
    xc = xh.float().reshape(b, nc, c, hm, 64).permute(1, 0, 3, 2, 4)
    bc_ = bmat.reshape(b, nc, c, n).permute(1, 0, 2, 3)   # (nc, b, c, n)
    cc_ = cmat.reshape(b, nc, c, n).permute(1, 0, 2, 3)
    dtc = dt.reshape(b, nc, c, hm).permute(1, 0, 3, 2)    # (nc, b, hm, c)
    ldc = logdecay.reshape(b, nc, c, hm).permute(1, 0, 3, 2)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    h = torch.zeros((b, hm, n, 64), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xt, bt, ct, dtt, ld = xc[i], bc_[i], cc_[i], dtc[i], ldc[i]
        la = torch.cumsum(ld, dim=2)                     # inclusive (b, hm, c)
        la_end = la[:, :, -1:]
        # intra: y_t = sum_{s<=t} C_t.B_s exp(la_t - la_s) dt_s x_s, the
        # ratio clamped to [CLAMP, 0] so the masked upper triangle cannot
        # overflow before masking
        scores = torch.einsum("btn,bsn->bts", ct, bt)    # (b, c, c)
        ratio = torch.exp(torch.clamp(la[:, :, :, None] - la[:, :, None, :],
                                      _LOG_CLAMP, 0.0))  # (b, hm, c, c)
        attn = scores[:, None] * ratio * mask
        y = torch.einsum("bhts,bhs,bhsp->bhtp", attn, dtt, xt)
        # inter: exp(la_t) C_t h0
        y = y + torch.exp(torch.clamp(la, min=_LOG_CLAMP))[..., None] * \
            torch.einsum("btn,bhnp->bhtp", ct, h)
        w = dtt * torch.exp(torch.clamp(la_end - la, min=_LOG_CLAMP))
        h = torch.exp(torch.clamp(la_end[:, :, 0], min=_LOG_CLAMP))[
            ..., None, None] * h \
            + torch.einsum("bhs,bsn,bhsp->bhnp", w, bt, xt)
        ys.append(y + p.d_skip[None, :, None, None] * xt)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, 2 * d)
    return _mamba2_out(p, x, y, z)
