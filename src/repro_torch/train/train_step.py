"""Train / prefill / decode step factories: the port of
``repro.train.train_step``.

``make_train_step`` builds the train step: forward (checkpointed layers
with ``remat``), next-token cross entropy (+ ``aux_weight`` times the
MoE aux loss, 0 for the other families), gradients by autograd (the
flash and rmsnorm backward passes are the reference's custom VJPs), AdamW
in place.  ``microbatch > 1`` accumulates f32 gradients over the split
batch, as the reference's ``lax.scan`` does.  The whole step runs under ``layers.f32_accumulation``:
the backward's bf16 GEMMs and a checkpointed layer's recompute run after
the forward has returned, so the forward's own scope would not cover them.

Under ``layers.activation_sharding(mesh, batch_axes)`` on a sharded model
(``distributed.state.shard_model``; AdamW's moments made from it) the
steps are SPMD programs, every rank called with the same global batch.
The train step differentiates the rank's share of the global loss (its
batch shard's mean over the number of batch shards): the weights'
gathers sum their gradients back into the shards by reduce-scatter,
``distributed.state.reduce_grads`` sums the rest over "data" and the
replicas over "pod", the global norm is one all-reduce, and AdamW updates
the shards.  The metrics are the global batch's.  Under
``activation_sharding(seq_mode=True)`` the forward splits the sequence
over "model" (``transformer.forward_hidden``): each rank's backward then
carries its chunk's share, and ``reduce_grads`` also sums the gradients
of the parameters replicated over "model".

The prefill and decode steps run under ``torch.inference_mode``: no
autograd graph, as the reference's jitted steps keep none.  They run the
config's dtype: a bf16 config with a ``cast_params`` model and a bf16
cache runs bf16 activations, f32 logits.  Nothing a train step reads is
cached by them (an inference tensor cannot be saved for a backward).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import state as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt


def cross_entropy(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean next-token loss; logits (b, s, v), targets (b, s)."""
    logz = torch.logsumexp(logits, dim=-1)
    idx = torch.as_tensor(targets).to(logits.device).long()[..., None]
    gold = torch.gather(logits, -1, idx)[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, cfg: ArchConfig, batch, *, impl="xla", remat=True,
            seq_mixer="chunked", aux_weight=0.01, remat_policy="none"):
    """(loss + aux_weight * aux, (loss, aux)) of the model ``params`` on
    ``batch`` (``tokens`` (b, s), and ``frontend`` for a frontend config):
    the next-token cross entropy of the forward's logits, aux the MoE
    layers' load-balance loss (0 for the other families)."""
    if L._mesh_on():
        x, aux = T.forward_hidden(params, cfg, batch, impl=impl, remat=remat,
                                  seq_mixer=seq_mixer,
                                  remat_policy=remat_policy)
        tokens = T._tokens(params, T.local_rows(batch["tokens"])[0])
        loss = T.next_token_loss(params, cfg, x, tokens)
        return loss + aux_weight * aux, (loss, aux)
    tokens = T._tokens(params, batch["tokens"])
    logits, aux = T.forward(params, cfg, batch, impl=impl, remat=remat,
                            seq_mixer=seq_mixer, remat_policy=remat_policy)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss + aux_weight * aux, (loss, aux)


def make_train_step(cfg: ArchConfig,
                    adamw: opt.AdamWConfig = opt.AdamWConfig(),
                    *, impl: str = "xla", remat: bool = True,
                    seq_mixer: str = "chunked", microbatch: int = 0,
                    remat_policy: str = "none", donate: bool = True):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics), metrics {"loss", "aux", "grad_norm"} as 0-d tensors
    (``grad_norm`` before clipping).  The model's parameters are updated
    in place whatever ``donate`` says: the port keeps one copy of the
    weights, as the reference's donated step does (ROADMAP.md section
    3)."""

    def train_step(model, opt_state, batch):
        with L.f32_accumulation():
            grads, loss, aux = step_grads(
                model, cfg, batch, impl=impl, remat=remat,
                seq_mixer=seq_mixer, microbatch=microbatch,
                remat_policy=remat_policy)
            mesh = L._ACT["mesh"]
            if mesh is None:
                gn = opt.global_norm(grads)
            else:
                world = L._axes_size(mesh, tuple(mesh.mesh_dim_names))
                gn, (loss, aux) = D.global_grad_norm(
                    model, grads, mesh, (loss / world, aux / world))
            model, opt_state = opt.adamw_update(adamw, model, grads,
                                                opt_state, grad_norm=gn)
            metrics = {"loss": loss, "aux": aux, "grad_norm": gn}
        return model, opt_state, metrics

    return train_step


def step_grads(model, cfg: ArchConfig, batch, *, impl: str = "xla",
               remat: bool = True, seq_mixer: str = "chunked",
               microbatch: int = 0, remat_policy: str = "none"):
    """(grads, loss, aux) of one train step before the optimizer: grads
    keyed by parameter name, f32 sums over ``microbatch`` parts when it is
    above 1.  Under a mesh each rank differentiates its share of the
    global objective and the gradients come back as the rank's shards of
    the global ones (``distributed.state.reduce_grads``); loss and aux
    are then the rank's own (``make_train_step`` averages them)."""
    names = [n for n, _ in model.named_parameters()]

    def grads_of(part):
        tot, (loss, aux) = loss_fn(model, cfg, part, impl=impl, remat=remat,
                                   seq_mixer=seq_mixer,
                                   remat_policy=remat_policy)
        if L._mesh_on():   # the rank's share of the global objective
            bg = L.group(L._ACT["batch_axes"])
            tot = tot / (bg.size if bg is not None else 1)
        grads = torch.autograd.grad(tot, [p for _, p in
                                          model.named_parameters()])
        return dict(zip(names, grads)), loss.detach(), aux.detach()

    with L.f32_accumulation():
        if microbatch and microbatch > 1:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            loss = aux = 0.0
            parts = {k: torch.as_tensor(v).chunk(microbatch)
                     for k, v in batch.items()}
            for i in range(microbatch):
                g, l, a = grads_of({k: v[i] for k, v in parts.items()})
                for n in names:
                    grads[n] += g[n]
                loss, aux = loss + l, aux + a
            grads = {n: g / microbatch for n, g in grads.items()}
            loss, aux = loss / microbatch, aux / microbatch
        else:
            grads, loss, aux = grads_of(batch)
        if L._mesh_on():
            D.reduce_grads(model, grads, L._ACT["mesh"],
                           model_partial=L.seq_split())
    return grads, loss, aux


def make_prefill_step(cfg: ArchConfig, *, impl: str = "xla",
                      seq_mixer: str = "chunked"):
    """Prefill: forward pass returning last-position logits (no loss);
    ``seq_mixer`` selects the SSM families' mixer, as ``forward``."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        logits, _ = T.forward(model, cfg, batch, impl=impl, remat=False,
                              seq_mixer=seq_mixer)
        return logits[:, -1:]

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, impl: str = "xla",
                     kde_cfg: Optional[Dict] = None):
    """serve_step: one token in, one token out, the cache updated in
    place.  Returns (next tokens (b,) int32, logits (b, 1, V_pad), cache)."""

    @torch.inference_mode()
    def decode_step(model, cache, tokens, pos):
        logits, cache = T.decode_step(model, cfg, tokens, cache, pos,
                                      impl=impl, kde_cfg=kde_cfg)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), \
            logits, cache

    return decode_step
