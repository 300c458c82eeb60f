"""Model assembly -- decoder-only dense / MoE, the SSM families (RWKV6,
Mamba2), the Mamba2 hybrid with one shared attention block, enc-dec and
the frontend families: the port of ``repro.models.transformer``.

The reference stacks every layer's parameters on a leading L axis and
scans over them; here a ``Transformer`` module holds ``embed`` (V_pad, D),
``layers`` (an ``nn.ModuleList``: ``DenseLayer``, ``RwkvLayer`` or
``MambaLayer``), ``final_norm`` (D,), ``lm_head`` (D, V_pad) (``None`` when
tied), zamba2's ``shared_attn`` (one ``SharedAttn``, not stacked) and the
enc-dec ``encoder`` (``Encoder``: its own stacked ``layers`` and
``final_norm``); Python loops walk the layers.  Decode caches keep the
reference's stacked layout: ``k`` / ``v`` (L, b, hkv, max_len, hd), bf16 by
default as the reference's; the hybrid's ``k`` / ``v`` over its ceil(L / k)
shared-attention applications and its f32 ``ssm`` states; RWKV6's ``ssm``
and ``shift``; the enc-dec ``memory``.  ``init_params`` draws f32 weights
whatever the config's dtype, and ``cast_params`` casts them to the compute
dtype, as the reference does.

Under ``layers.activation_sharding(mesh, batch_axes)`` (a ``DeviceMesh``;
the model's parameters are the rank's shards, ``distributed.state.
shard_model``) ``forward``, ``decode_step`` and ``init_cache`` run as SPMD
programs, one process a rank: each takes the global batch (the same on
every rank), cuts its batch shard's rows (``local_rows``: the rows of
the rank's index over the batch axes when they divide the batch, else
all), and returns those rows; ``init_cache`` returns the rank's slices
under ``distributed.sharding.cache_spec`` (a ``ShardedCache``).  The
embedding and the head are split over "model" (the vocab, or d_model
when the vocab does not divide), the logits come back whole.

Two reference behaviours are mirrored as they are (ROADMAP.md section 3):
the hybrid's forward applies the shared block after layers 0, k, 2k, ...
while its decode applies it before each segment [0, k), [k, 2k), ...; and
the MoE block drops tokens over capacity, which a long forward does and a
one-token decode step never does.
"""
from __future__ import annotations

import math
import types
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def _ffn(p, cfg: ArchConfig, x):
    """The layer's feed-forward: (SwiGLU, 0) or (MoE block, aux)."""
    if cfg.is_moe:
        return L.moe_block(p, cfg, x)
    return L.swiglu(p, x), 0.0


class DenseLayer(nn.Module):
    """ln1 / ln2 gains (D,), the attention and the SwiGLU or MoE weights;
    the enc-dec decoder's layer adds ``ln_x`` and the cross attention
    ``xattn``."""

    def __init__(self, ln1, ln2, attn: L.Attention, mlp, ln_x=None,
                 xattn: Optional[L.Attention] = None):
        super().__init__()
        self.ln1 = L._param(ln1)
        if ln_x is not None:
            self.ln_x = L._param(ln_x)
        self.ln2 = L._param(ln2)
        self.attn = attn
        if xattn is not None:
            self.xattn = xattn
        self.mlp = mlp

    def forward(self, cfg: ArchConfig, x, positions, impl: str = "xla",
                cache: Optional[Tuple] = None, cache_pos=None,
                kde_cfg: Optional[Dict] = None, memory=None):
        """Returns (x, aux): aux the MoE block's loss, else 0."""
        h, _ = L.attention_block(self.attn, cfg,
                                 L.rmsnorm(x, self.ln1, cfg.norm_eps),
                                 positions, impl=impl, cache=cache,
                                 cache_pos=cache_pos, kde_cfg=kde_cfg)
        x = x + h
        if memory is not None:
            x = x + L.cross_attention_block(
                self.xattn, cfg, L.rmsnorm(x, self.ln_x, cfg.norm_eps),
                memory)
        h, aux = _ffn(self.mlp, cfg, L.rmsnorm(x, self.ln2, cfg.norm_eps))
        return x + h, aux


class RwkvLayer(nn.Module):
    """ln1 / ln2, the RWKV6 time mix ``mix`` and the SwiGLU channel mix."""

    def __init__(self, ln1, ln2, mix: S.RWKV6, mlp: L.MLP):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.mix, self.mlp = mix, mlp

    def forward(self, cfg: ArchConfig, x, seq_mixer: str = "chunked",
                state=None, shift_state=None):
        """Returns (x, state, shift_state); the chunked form (any
        ``seq_mixer`` but "chunked" runs the scan) returns no states.  The
        mixer is sequential over the sequence and its chunks start at
        position 0, so a sequence-split forward runs it on the whole
        sequence (``layers.seq_whole``) and keeps its chunk."""
        inner = L.seq_whole(L.rmsnorm(x, self.ln1, cfg.norm_eps))
        mix = L.module_full(self.mix)
        if seq_mixer == "chunked" and state is None:
            h, state, shift = S.rwkv6_chunked(mix, cfg, inner), None, None
        else:
            h, state, shift = S.rwkv6_scan(mix, cfg, inner, state=state,
                                           shift_state=shift_state)
        x = x + L.seq_own(h)
        x = x + L.swiglu(self.mlp, L.rmsnorm(x, self.ln2, cfg.norm_eps))
        return x, state, shift


class MambaLayer(nn.Module):
    """ln1 and the Mamba2 mixer ``mix``; a standalone Mamba2 layer also has
    ln2 and a SwiGLU MLP (the hybrid keeps its MLP in the shared block)."""

    def __init__(self, ln1, mix: S.Mamba2, ln2=None,
                 mlp: Optional[L.MLP] = None):
        super().__init__()
        self.ln1 = L._param(ln1)
        self.mix = mix
        if mlp is not None:
            self.ln2 = L._param(ln2)
            self.mlp = mlp

    def forward(self, cfg: ArchConfig, x, seq_mixer: str = "chunked",
                state=None):
        """Returns (x, state); the chunked form returns no state.  A
        sequence-split forward runs the mixer on the whole sequence and
        keeps its chunk, as ``RwkvLayer``."""
        inner = L.seq_whole(L.rmsnorm(x, self.ln1, cfg.norm_eps))
        mix = L.module_full(self.mix)
        if seq_mixer == "chunked" and state is None:
            h, state = S.mamba2_chunked(mix, cfg, inner), None
        else:
            h, state = S.mamba2_scan(mix, cfg, inner, state=state)
        x = x + L.seq_own(h)
        if hasattr(self, "mlp"):
            x = x + L.swiglu(self.mlp, L.rmsnorm(x, self.ln2, cfg.norm_eps))
        return x, state


class SharedAttn(nn.Module):
    """zamba2's one shared attention block: ``ln``, ``attn``, ``ln2`` and
    a SwiGLU ``mlp`` (not stacked: its gains stay 1-D)."""

    def __init__(self, ln, attn: L.Attention, ln2, mlp: L.MLP):
        super().__init__()
        self.ln = L._param(ln)
        self.attn = attn
        self.ln2 = L._param(ln2)
        self.mlp = mlp

    def forward(self, cfg: ArchConfig, x, positions, impl: str = "xla",
                cache: Optional[Tuple] = None, cache_pos=None,
                kde_cfg: Optional[Dict] = None):
        h, _ = L.attention_block(self.attn, cfg,
                                 L.rmsnorm(x, self.ln, cfg.norm_eps),
                                 positions, impl=impl, cache=cache,
                                 cache_pos=cache_pos, kde_cfg=kde_cfg)
        x = x + h
        return x + L.swiglu(self.mlp, L.rmsnorm(x, self.ln2, cfg.norm_eps))


class Encoder(nn.Module):
    """The enc-dec encoder: dense ``layers`` (stacked in the reference's
    tree) and ``final_norm``."""

    def __init__(self, layers, final_norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = L._param(final_norm)


class Transformer(nn.Module):
    """The LM's parameters, each a trainable ``nn.Parameter``."""

    def __init__(self, cfg: ArchConfig, embed, layers, final_norm,
                 lm_head=None, shared_attn: Optional[SharedAttn] = None,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        for name, given, want in (
                ("lm_head", lm_head is not None, not cfg.tie_embeddings),
                ("shared_attn", shared_attn is not None, _hybrid(cfg)),
                ("encoder", encoder is not None, cfg.is_encdec)):
            if given != want:
                raise ValueError(f"{cfg.name}: {name} must be "
                                 f"{'given' if want else 'None'}")
        self.cfg = cfg
        self.embed = L._param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L._param(final_norm)
        self.register_parameter(
            "lm_head", None if lm_head is None else L._param(lm_head))
        if shared_attn is not None:
            self.shared_attn = shared_attn
        if encoder is not None:
            self.encoder = encoder


def _hybrid(cfg: ArchConfig) -> bool:
    return cfg.ssm_kind == "mamba2" and bool(cfg.hybrid_attn_every)


# ------------------------------------------------------------------ init
def _ones(cfg: ArchConfig, dev) -> torch.Tensor:
    return torch.ones(cfg.d_model, device=dev)


def _init_dense_layer(gen: torch.Generator, cfg: ArchConfig) -> DenseLayer:
    dev = gen.device
    return DenseLayer(_ones(cfg, dev), _ones(cfg, dev),
                      L.init_attention(gen, cfg), L.init_mlp(gen, cfg))


def _init_rwkv_layer(gen: torch.Generator, cfg: ArchConfig) -> RwkvLayer:
    dev = gen.device
    return RwkvLayer(_ones(cfg, dev), _ones(cfg, dev), S.init_rwkv6(gen, cfg),
                     L.init_mlp(gen, cfg))


def _init_mamba_layer(gen: torch.Generator, cfg: ArchConfig) -> MambaLayer:
    dev = gen.device
    mix = S.init_mamba2(gen, cfg)
    if cfg.hybrid_attn_every:   # hybrid: the MLP lives in the shared block
        return MambaLayer(_ones(cfg, dev), mix)
    return MambaLayer(_ones(cfg, dev), mix, _ones(cfg, dev),
                      L.init_mlp(gen, cfg))


def _init_encdec_decoder_layer(gen: torch.Generator,
                               cfg: ArchConfig) -> DenseLayer:
    dev = gen.device
    return DenseLayer(_ones(cfg, dev), _ones(cfg, dev),
                      L.init_attention(gen, cfg), L.init_mlp(gen, cfg),
                      ln_x=_ones(cfg, dev), xattn=L.init_attention(gen, cfg))


def _layer_init_fn(cfg: ArchConfig):
    if cfg.ssm_kind == "rwkv6":
        return _init_rwkv_layer
    if cfg.ssm_kind == "mamba2":
        return _init_mamba_layer
    if cfg.is_encdec:
        return _init_encdec_decoder_layer
    return _init_dense_layer


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random-init model drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``, with the reference's scales
    and constants: embed and lm_head N(0, 0.02^2), weights N(0, 1/fan_in),
    norms 1, biases 0, the SSM constants of ``ssm.init_*`` (its numbers
    differ: JAX and torch streams do not match)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_one = _layer_init_fn(cfg)
    layers = [init_one(gen, cfg) for _ in range(cfg.num_layers)]
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev).mul_(0.02)
    head = None
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen,
                           device=dev).mul_(0.02)
    shared = encoder = None
    if _hybrid(cfg):
        shared = SharedAttn(_ones(cfg, dev), L.init_attention(gen, cfg),
                            _ones(cfg, dev), L.init_mlp(gen, cfg))
    if cfg.is_encdec:
        encoder = Encoder([_init_dense_layer(gen, cfg)
                           for _ in range(cfg.encoder_layers)],
                          _ones(cfg, dev))
    return Transformer(cfg, embed, layers, _ones(cfg, dev), head, shared,
                       encoder)


#: parameter-name prefixes of the layers the reference stacks on a leading
#: axis: the decoder's and the encoder's (zamba2's shared block is one
#: block, not stacked)
STACKED_PREFIXES = ("layers.", "encoder.layers.")


def stacked_ndim(name: str, p: torch.Tensor) -> int:
    """Dims of parameter ``name`` (``model.named_parameters()``) in the
    reference's tree, which stacks every decoder and encoder layer's
    parameters on a leading axis: one more than its own for a stacked
    parameter.  The reference's rules of "two or more dims"
    (``cast_params``, AdamW's weight decay) read this: every stacked
    parameter qualifies (norm gains, QKV biases and the SSM vectors ``w0``,
    ``u``, ``dt_bias``, ``a_log``, ``d_skip`` too), of the rest embed,
    lm_head and the shared block's matrices, never ``final_norm``,
    ``encoder.final_norm`` or the shared block's ``ln`` / ``ln2``."""
    return p.dim() + name.startswith(STACKED_PREFIXES)


def map_params(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A new module of ``module``'s structure whose parameter ``name`` (its
    ``named_parameters()`` name) is ``fn(name, p)``, one tensor at a time;
    other attributes (the config) are shared."""
    new = module.__class__.__new__(module.__class__)
    nn.Module.__init__(new)
    for k, v in vars(module).items():
        if not k.startswith("_"):
            new.__dict__[k] = v
    for name, p in module._parameters.items():
        new.register_parameter(
            name, None if p is None else L._param(fn(prefix + name, p)))
    for name, child in module._modules.items():
        new.add_module(name, map_params(child, fn, f"{prefix}{name}."))
    return new


def cast_params(model: Transformer, dtype: torch.dtype) -> Transformer:
    """The reference's ``cast_params``: a new model whose parameters of two
    or more dims in the reference's tree (``stacked_ndim``) are in
    ``dtype``; the others (``final_norm``, ``encoder.final_norm``, the
    shared block's gains) stay the same f32 tensors.  The casts are made
    one tensor at a time, so a cast from f32 holds the f32 model and the
    new weights, never a second f32 copy."""
    def cast(name, p):
        t = p.detach()
        return t.to(dtype) if stacked_ndim(name, t) >= 2 else t

    return map_params(model, cast)


# ------------------------------------------------------------------ forward
def _tokens(model: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(model.embed.device).long()


def local_rows(t):
    """The rank's rows of a global batch tensor ``t`` (numpy or torch)
    under the active mesh: its batch shard's when the batch axes divide
    the rows, else all of them.  Returns (rows, split)."""
    g = L.group(L._ACT["batch_axes"]) if L._mesh_on() else None
    if g is None or t.shape[0] % g.size:
        return t, False
    n = t.shape[0] // g.size
    return t[g.index * n:(g.index + 1) * n], True


def _local_batch(batch):
    """``batch`` cut to the rank's rows; sets ``layers._ACT
    ["batch_sharded"]`` (the MoE dispatch reads it)."""
    if not L._mesh_on():
        return batch
    out = {}
    for k, v in batch.items():
        out[k], L._ACT["batch_sharded"] = local_rows(v)
    return out


def _embed(model: Transformer, tok):
    """Rows ``tok`` of the embedding: a vocab-split table looks up its own
    rows (zeros elsewhere) and one all-reduce over "model" adds them; a
    d_model-split one gathers the columns."""
    emb = model.embed
    spec = L._spec(emb)
    if spec is None or spec == (None, None):
        return emb[tok]
    mg = L.group(("model",))
    if spec[0] == "model":
        return C.sum_to_replicas(_own_rows(emb, tok, mg), mg)
    gather = C.gather_partial if L.seq_split() else C.gather_replicated
    return gather(emb[tok], mg, -1)


def _own_rows(emb, tok, mg):
    """Rows ``tok`` of a vocab-split table's shard: the rows it holds,
    zeros for the others."""
    v_l = emb.shape[0]
    t = tok - mg.index * v_l
    ok = (t >= 0) & (t < v_l)
    return emb[torch.clamp(t, 0, v_l - 1)] * ok[..., None].to(emb.dtype)


def _n_prefix(cfg: ArchConfig, batch) -> int:
    """Positions of the frontend prefix ``_embed_inputs`` puts before the
    tokens."""
    if cfg.frontend != "none" and "frontend" in batch:
        return int(batch["frontend"].shape[1])
    return 0


def _embed_split(model: Transformer, cfg: ArchConfig, batch):
    """The rank's chunk (b, s / m, d) of ``_embed_inputs``' sequence (the
    frontend prefix and the tokens) in a sequence-split forward.  Every
    rank embeds the whole sequence as its part of a sum -- its own rows
    of a vocab-split table, zeros for the rest; or, from a table split
    over d_model or not at all, everything on the first "model" rank and
    zeros on the others, as the prefix -- and one reduce-scatter over
    "model" adds the parts and cuts the chunks (``sum_scatter``: its
    backward all-gathers the chunks' gradients, so each rank's table rows
    take every position's)."""
    dtype = L.dtype_of(cfg)
    mg = L.group(("model",))
    tok = _tokens(model, batch["tokens"])
    first = float(mg.index == 0)
    spec = L._spec(model.embed)
    if spec is not None and spec[0] == "model":
        e = _own_rows(model.embed, tok, mg)
    else:
        e = _embed(model, tok) * first
    parts = [e.to(dtype)]
    if _n_prefix(cfg, batch):
        fe = torch.as_tensor(batch["frontend"]).to(e.device, dtype)
        parts.insert(0, fe * first)
    return C.sum_scatter(torch.cat(parts, dim=1), mg, 1)


def _embed_inputs(model: Transformer, cfg: ArchConfig,
                  batch) -> Tuple[torch.Tensor, int]:
    """Returns (x (b, s, d), n_prefix) where the first n_prefix positions are
    the frontend embeddings (a frontend config given ``batch["frontend"]``;
    no loss there)."""
    dtype = L.dtype_of(cfg)
    tok = _embed(model, _tokens(model, batch["tokens"])).to(dtype)
    if cfg.frontend != "none" and "frontend" in batch:
        fe = torch.as_tensor(batch["frontend"]).to(tok.device, dtype)
        return torch.cat([fe, tok], dim=1), fe.shape[1]
    return tok, 0


def _run_encoder(model: Transformer, cfg: ArchConfig, enc_embeds, impl):
    """The enc-dec encoder over the frontend embeddings: bidirectional
    (non-causal ``xla_attention``, whatever ``impl``), RoPE on the encoder
    positions, then its final norm."""
    x = torch.as_tensor(enc_embeds).to(model.embed.device, L.dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in model.encoder.layers:
        attn = L.module_full(lp.attn)
        q, k, v = L._qkv(attn, cfg, L.rmsnorm(x, lp.ln1, cfg.norm_eps),
                         positions)
        o = L.xla_attention(q, k, v, causal=False)
        x = x + L._merge_heads(o) @ attn.wo.to(x.dtype)
        x = x + L.swiglu(lp.mlp, L.rmsnorm(x, lp.ln2, cfg.norm_eps))
    return L.rmsnorm(x, model.encoder.final_norm, cfg.norm_eps)


def _dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots"``: the
    reference's ``checkpoint_dots_with_no_batch_dims`` saves the results of
    the dot products without batch dimensions, which in the port are the
    2-D weight products (``aten.mm`` / ``aten.addmm``); the attention
    scores (``aten.bmm``, batched) and everything else are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, x, remat_policy):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, all of them, or all but
    the weight products with ``remat_policy="dots"`` (``_dots_policy``)."""
    from torch.utils import checkpoint as ckpt
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            _dots_policy)
    return ckpt.checkpoint(fn, x, use_reentrant=False, **kw)


def _layer_body(model: Transformer, cfg: ArchConfig, idx: int, positions,
                impl: str, seq_mixer: str, memory):
    """The forward of layer ``idx`` as a function of x -> (x, aux): the
    reference's scanned layer body (the hybrid's shared block after the
    layers whose index is a multiple of k included)."""
    layer = model.layers[idx]

    def body(x):
        if cfg.ssm_kind == "rwkv6":
            return layer(cfg, x, seq_mixer)[0], 0.0
        if cfg.ssm_kind == "mamba2":
            x = layer(cfg, x, seq_mixer)[0]
            if cfg.hybrid_attn_every and idx % cfg.hybrid_attn_every == 0:
                x = model.shared_attn(cfg, x, positions, impl=impl)
            return x, 0.0
        return layer(cfg, x, positions, impl=impl, memory=memory)

    return body


def forward(model: Transformer, cfg: ArchConfig, batch, *,
            impl: str = "xla", remat: bool = True, seq_mixer: str = "chunked",
            remat_policy: Optional[str] = "none"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train / prefill forward.  Returns (logits (b, s_tok, V_pad), aux_loss
    (f32 scalar: the MoE layers' summed load-balance loss, else 0)).

    ``batch`` holds ``tokens`` (b, s) and, for a frontend config,
    ``frontend`` (b, n, d): the decoder's prefix (its positions get no
    logits) and, for enc-dec, the encoder's input.  ``seq_mixer`` selects
    the SSM mixer: "chunked", or any other value for the scan, as the
    reference reads it.  ``remat`` checkpoints each layer when a gradient
    is being taken (the reference's ``jax.checkpoint`` of its scanned layer
    body): ``remat_policy="dots"`` keeps the weight products
    (``_dots_policy``), any other value recomputes the whole layer.  Under
    ``torch.no_grad`` / ``inference_mode`` there is nothing to recompute and
    the layers run as they are.  Under a mesh: the rank's rows (module
    docstring); under ``layers.activation_sharding(seq_mode=True)`` the
    same logits from a forward whose sequence is split over "model"
    (``forward_hidden``)."""
    x, aux = forward_hidden(model, cfg, batch, impl=impl, remat=remat,
                            seq_mixer=seq_mixer, remat_policy=remat_policy)
    with L.f32_accumulation():
        return _logits(model, cfg, x), aux


def forward_hidden(model: Transformer, cfg: ArchConfig, batch, *,
                   impl: str = "xla", remat: bool = True,
                   seq_mixer: str = "chunked",
                   remat_policy: Optional[str] = "none"):
    """``forward`` up to the final norm: (x (b, s_tok, d), aux).

    Under ``layers.activation_sharding(seq_mode=True)`` it records the
    layout it takes (``layers.seq_layout``) in ``layers._ACT
    ["seq_layout"]``.  Split: rank r of "model" embeds and runs global
    positions [r s_l, (r + 1) s_l) of the sequence (the frontend prefix
    included) through every layer -- attention over the gathered keys at
    its query offset, the SSM mixers and the MoE dispatch on the gathered
    sequence -- and the final hidden states are gathered whole, so the
    head, the loss and the logits are those of the unsplit forward;
    every rank's backward carries its chunk's share
    (``distributed.collectives``)."""
    batch = _local_batch(batch)
    n_prefix = _n_prefix(cfg, batch)
    L._ACT["seq_layout"] = L.seq_layout(
        n_prefix + int(torch.as_tensor(batch["tokens"]).shape[1]))
    if L.seq_split():
        x = _embed_split(model, cfg, batch)
        r = L.group(("model",)).index
        positions = r * x.shape[1] + torch.arange(x.shape[1], device=x.device)
    else:
        x, n_prefix = _embed_inputs(model, cfg, batch)
        positions = torch.arange(x.shape[1], device=x.device)
    checkpointed = bool(remat) and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with L.f32_accumulation():
        memory = None
        if cfg.is_encdec:
            memory = _run_encoder(model, cfg, batch["frontend"], impl)
        for idx in range(len(model.layers)):
            body = _layer_body(model, cfg, idx, positions, impl, seq_mixer,
                               memory)
            x, a = _remat(body, x, remat_policy) if checkpointed else body(x)
            aux = aux + a
        x = L.seq_whole(L.rmsnorm(x, model.final_norm, cfg.norm_eps))
        if n_prefix:
            x = x[:, n_prefix:]
        return x, aux


def _head(model: Transformer, cfg: ArchConfig, x):
    """(logits (b, s, V_l) f32, lo): the logits of the vocab columns [lo,
    lo + V_l) this rank holds (all of them without a vocab-split head),
    padded columns masked to -1e30.  A head split over d_model (a tied
    embedding whose vocab does not divide) adds its partial products by
    one all-reduce over "model".  After a sequence-split forward ``x`` is
    already the gathered sequence, whose gather sums the ranks' gradients:
    no further sum, and a head that is not split over "model" shares its
    gradient out (``grad_share``)."""
    tied = model.lm_head is None
    w = model.embed if tied else model.lm_head
    head = w.T if tied else w                      # (d, V)
    spec = L._spec(w)
    spec = spec[::-1] if (spec is not None and tied) else spec
    mg = L.group(("model",))
    split = L.seq_split()
    xin = x if split else C.copy_to_partials(x, mg)
    lo = 0
    if spec is not None and spec[1] == "model":
        logits = xin.float() @ head.float()
        lo = mg.index * head.shape[1]
    elif spec is not None and spec[0] == "model":
        logits = C.sum_to_replicas(
            C.own_chunk(xin, mg, -1).float() @ head.float(), mg)
    else:
        logits = x.float() @ head.float()
        if split:
            logits = C.grad_share(logits, mg)
    if cfg.padded_vocab != cfg.vocab_size:
        cols = lo + torch.arange(logits.shape[-1], device=x.device)
        logits = torch.where((cols < cfg.vocab_size)[None, None, :], logits,
                             -1.0e30)
    return logits, lo


def _logits(model: Transformer, cfg: ArchConfig, x):
    """(b, s, padded_vocab) logits with padded columns masked to -1e30
    (gathered over "model" when the head splits the vocab)."""
    logits, _ = _head(model, cfg, x)
    if logits.shape[-1] != cfg.padded_vocab:
        logits = C.gather_replicated(logits, L.group(("model",)), -1)
    return logits


def next_token_loss(model: Transformer, cfg: ArchConfig, x, tokens):
    """Mean next-token loss of the hidden states ``x`` (b, s, d) against
    ``tokens`` (b, s): logits[:, :-1] against tokens[:, 1:], as
    ``train_step.cross_entropy``.  Over a vocab split across "model" the
    logits are never gathered: logsumexp takes one max and one sum
    all-reduce, the target's logit one sum all-reduce (from the rank that
    holds it)."""
    logits, lo = _head(model, cfg, x)
    logits = logits[:, :-1]
    idx = torch.as_tensor(tokens).to(logits.device).long()[:, 1:]
    if logits.shape[-1] == cfg.padded_vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        return torch.mean(logz - gold)
    mg = L.group(("model",))
    v_l = logits.shape[-1]
    m = C.pmax(torch.amax(logits, dim=-1), mg)
    se = C.sum_to_replicas(torch.exp(logits - m[..., None]).sum(-1), mg)
    logz = m + torch.log(se)
    t = idx - lo
    own = (t >= 0) & (t < v_l)
    gold = torch.gather(logits, -1, torch.clamp(t, 0, v_l - 1)[..., None])
    gold = C.sum_to_replicas(gold[..., 0] * own.float(), mg)
    return torch.mean(logz - gold)


# ------------------------------------------------------------------ decode
class ShardedCache(dict):
    """A decode cache of the rank's slices under a mesh: ``specs`` gives
    each leaf's ``distributed.sharding.cache_spec`` of the global
    layout."""
    specs: Dict[str, tuple]


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int = 0,
               device=None) -> Dict[str, Any]:
    """The zero decode cache in the reference's layout: RWKV6 ``ssm`` (L, b,
    h, hd, hd) f32 and ``shift`` (L, b, d); Mamba2 ``ssm`` (L, b, 2d / 64,
    n, 64) f32, plus the hybrid's ``k`` / ``v`` over its ceil(L / k)
    shared-attention applications; else ``k`` / ``v`` (L, b, hkv, max_len,
    hd) and, for enc-dec, ``memory`` (b, enc_len, d).  K/V, ``shift`` and
    ``memory`` in ``dtype`` (bf16 by default, as the reference's).  Under
    a mesh: the rank's slices (a ``ShardedCache``) on the mesh's
    device."""
    hkv, hd, lcount = cfg.num_kv_heads, cfg.hd, cfg.num_layers
    shapes = {}
    if cfg.ssm_kind == "rwkv6":
        shapes["ssm"] = ((lcount, batch_size, cfg.num_heads, hd, hd),
                         torch.float32)
        shapes["shift"] = ((lcount, batch_size, cfg.d_model), dtype)
    elif cfg.ssm_kind == "mamba2":
        hm = (2 * cfg.d_model) // 64
        shapes["ssm"] = ((lcount, batch_size, hm, cfg.ssm_state, 64),
                         torch.float32)
        if cfg.hybrid_attn_every:
            napp = math.ceil(lcount / cfg.hybrid_attn_every)
            shapes["k"] = shapes["v"] = ((napp, batch_size, hkv, max_len,
                                          hd), dtype)
    else:
        shapes["k"] = shapes["v"] = ((lcount, batch_size, hkv, max_len, hd),
                                     dtype)
        if cfg.is_encdec:
            shapes["memory"] = ((batch_size, enc_len, cfg.d_model), dtype)
    mesh = L._ACT["mesh"]
    if mesh is None:
        dev = resolve_device(device)
        return {k: torch.zeros(shp, dtype=dt, device=dev)
                for k, (shp, dt) in shapes.items()}
    dev = C.mesh_device(mesh, device)
    cache = ShardedCache()
    cache.specs = {}
    for k, (shp, dt) in shapes.items():
        spec = SH.cache_spec(cfg, None, mesh, k,
                             types.SimpleNamespace(shape=shp))
        cache.specs[k] = spec
        cache[k] = torch.zeros(SH.local_shape(shp, spec, mesh), dtype=dt,
                               device=dev)
    return cache


def _decode_layout(cache):
    """Set ``layers._ACT`` for one decode step over ``cache``: whether its
    batch rows are split (the MoE dispatch), whether its kv heads are
    split over "model" and the group its sequence is split over (the
    attention blocks).  Returns a function that cuts the step's tokens
    to the cache's rows."""
    specs = getattr(cache, "specs", None)
    if not L._mesh_on() or specs is None:
        return lambda t: t
    lead = specs.get("k", specs.get("ssm"))
    L._ACT["batch_sharded"] = lead[1] is not None
    if "k" in specs:
        kspec = specs["k"]
        axes = SH.entry_axes(kspec[3])
        L._ACT["decode"] = {"heads_sharded": kspec[2] == "model",
                            "seq_grp": L.group(axes) if axes else None}
    return (lambda t: local_rows(t)[0]) if lead[1] is not None \
        else (lambda t: t)


def _state_heads(cache, key: str, i: int):
    """Layer ``i``'s SSM state with every head (gathered over "model"
    when the cache splits them) and a function that stores a new one
    back into the rank's slice."""
    specs = getattr(cache, "specs", None)
    split = L._mesh_on() and specs is not None and specs[key][2] == "model"
    st = cache[key][i]
    if not split:
        def put(t):
            cache[key][i] = t
        return st, put
    mg = L.group(("model",))

    def put(t):
        cache[key][i] = C.own_chunk(t, mg, 1)
    return C.all_gather(st, mg, 1), put


def decode_step(model: Transformer, cfg: ArchConfig, tokens, cache, pos, *,
                impl: str = "xla", kde_cfg: Optional[Dict] = None):
    """One decode step.  tokens (b, s) ints; pos: int (current write
    offset).  Returns (logits (b, s, V_pad), cache).  The cache is updated
    IN PLACE (the reference returns an updated copy): the new keys and
    values at ``pos``, the SSM and shift states overwritten with the
    step's; the returned cache is the same dict.  The hybrid applies its
    shared block before each segment of k Mamba2 layers (ROADMAP.md
    section 3).  Under a mesh ``tokens`` is the global batch and the
    logits are the rows of the rank's cache slice.  Under seq_mode a
    decode step runs as it does without it."""
    old = dict(L._ACT)
    try:
        L._ACT.update(seq_mode=False, seq_layout=None)
        rows = _decode_layout(cache)
        return _decode_step(model, cfg, rows(tokens), cache, pos, impl,
                            kde_cfg)
    finally:
        L._ACT.update(old)


def _decode_step(model, cfg, tokens, cache, pos, impl, kde_cfg):
    tok = _tokens(model, tokens)
    x = _embed(model, tok).to(L.dtype_of(cfg))
    pos = int(pos)
    positions = pos + torch.arange(tok.shape[1], device=x.device)
    with L.f32_accumulation():
        if cfg.ssm_kind == "rwkv6":
            for i, layer in enumerate(model.layers):
                st, put = _state_heads(cache, "ssm", i)
                x, ssm, shift = layer(cfg, x, state=st,
                                      shift_state=cache["shift"][i])
                put(ssm)
                cache["shift"][i] = shift
        elif cfg.ssm_kind == "mamba2":
            k = cfg.hybrid_attn_every or cfg.num_layers
            for app, lo in enumerate(range(0, cfg.num_layers, k)):
                if cfg.hybrid_attn_every:
                    # the reference's _shared_attn_decode: one position
                    x = model.shared_attn(
                        cfg, x, positions[:1], impl=impl,
                        cache=(cache["k"][app], cache["v"][app]),
                        cache_pos=pos, kde_cfg=kde_cfg)
                for i in range(lo, min(lo + k, cfg.num_layers)):
                    st, put = _state_heads(cache, "ssm", i)
                    x, ssm = model.layers[i](cfg, x, state=st)
                    put(ssm)
        else:
            memory = cache.get("memory") if cfg.is_encdec else None
            for layer, ck, cv in zip(model.layers, cache["k"], cache["v"]):
                x, _ = layer(cfg, x, positions, impl=impl, cache=(ck, cv),
                             cache_pos=pos, kde_cfg=kde_cfg, memory=memory)
        x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
        return _logits(model, cfg, x), cache
