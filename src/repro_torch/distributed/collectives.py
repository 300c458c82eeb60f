"""The port's one collective layer on ``torch.distributed``.

Every collective of the mesh engines (``kernels/{kde_sampler,kde_hash}/
sharded.py``, ``core/kde/distributed.py``) and of the LM's sharded state
(``distributed/sharding.py``, the mesh paths of ``models/`` and
``train/``) goes through the functions below.  Each realized call is
counted by kind under the reference's primitive names (``COLLECTIVES``:
``psum``, ``pmax``, ``all_gather``, ``psum_scatter``, ``ppermute``), its
operand bytes are added to ``COLLECTIVE_BYTES`` (the bytes the reference's
``roofline.analysis.collective_bytes`` sums from the HLO: the operand of
each collective, an all-gather's local shard, a reduce-scatter's whole
input), and its wall time to ``COLLECTIVE_SECONDS``.
``collective_counts(fn)`` reads the counts over one call.

A gloo group stages a CUDA tensor through host memory (gloo's send and
recv take CPU tensors only): staging moves bytes, the compute stays on the
card, and a staged call counts once.  A one-rank group runs its
collectives on the backend like any other.  On a ``"fake"`` process group
under ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) the calls move
nothing and are counted all the same.

The autograd forms carry the two conventions of the LM's mesh programs
(``models/layers.py``):
  * over the batch axes ("pod", "data") every rank differentiates its own
    share of the global loss, so a gathered weight's gradient is summed
    back by reduce-scatter (``gather_partial``) and a sum all-reduce is
    its own adjoint (``psum``);
  * over "model" every rank differentiates the whole, replicated loss
    (Megatron's convention): the sum all-reduce after a row-parallel
    product has the identity as its backward (``sum_to_replicas``), the
    identity before a column-parallel product an all-reduce
    (``copy_to_partials``), and a weight gathered for replicated compute
    takes back its own slice of the gradient (``gather_replicated``);
  * except in a context-parallel step (the sequence split over "model"),
    where each rank's backward carries its own chunk's share: the
    weights' and the keys' gathers sum their gradients back by
    reduce-scatter (``gather_partial``), the embedding's reduce-scatter
    over the sequence gathers them (``sum_scatter``), and a value every
    rank computes whole divides its gradient by the ranks
    (``grad_share``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: realized collectives by kind, under the reference's primitive names
COLLECTIVES = {"psum": 0, "pmax": 0, "all_gather": 0, "psum_scatter": 0,
               "ppermute": 0}
#: operand bytes of those calls, by kind (what each rank sends in)
COLLECTIVE_BYTES = {k: 0 for k in COLLECTIVES}
#: wall seconds spent inside the collective wrapper (staging included)
COLLECTIVE_SECONDS = [0.0]


def reset_collectives() -> None:
    """Zero the collective counts, bytes and the time spent in them."""
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_BYTES[k] = 0
    COLLECTIVE_SECONDS[0] = 0.0


def collective_counts(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count the collectives it realized,
    by kind, with the reference's keys (``psum``, ``ppermute``,
    ``all_gather``, ``psum_total``, ``ppermute_total``; ``pmax`` and
    ``psum_scatter`` besides).  The reference counts the binds in a jaxpr,
    where a scan body counts once; this counts every call, so a scanned
    program realizes one all-reduce per step (ROADMAP.md section 3)."""
    before = dict(COLLECTIVES)
    fn(*args, **kwargs)
    acc = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}
    acc["psum_total"] = acc["psum"]
    acc["ppermute_total"] = acc["ppermute"]
    return acc


# --------------------------------------------------------------------- #
# the mesh: flattened groups over some of its dims
# --------------------------------------------------------------------- #
class MeshGroup:
    """The flattened group of one rank over ``axes`` of a mesh: ``size``
    shards, this rank's row-major shard ``index`` (the reference's
    ``_flat_index``), the group's global ``ranks`` in shard order, the
    mesh's ``device`` and whether collectives stage through the host."""

    def __init__(self, mesh, axes):
        names = tuple(mesh.mesh_dim_names or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"data axis {a!r} is not a dim of the mesh "
                                 f"{names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"data axes {axes} repeat a dim")
        self.mesh = mesh
        self.axes = tuple(axes)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        self.size = 1
        for a in axes:
            self.size *= int(mesh.size(names.index(a)))
        # the rank grid read on the host (under the dry run's FakeTensorMode
        # too: the mesh's own tensor is a real one)
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            grid = np.array(mesh.mesh.tolist()).transpose(*rest, *dims)
        rows = grid.reshape(-1, self.size).tolist()
        me = dist.get_rank()
        row = next(r for r in rows if me in r)
        self.ranks = [int(r) for r in row]
        self.index = self.ranks.index(me)
        self.device = mesh_device(mesh)
        # a one-shard group too: its collectives run (and count) on the
        # backend like any other
        self.group = dist.new_group(ranks=self.ranks,
                                    use_local_synchronization=True)
        self.backend = dist.get_backend(self.group)
        self.stage = self.device.type == "cuda" and self.backend == "gloo"


_GROUPS: dict = {}


def mesh_group(mesh, data_axes: Sequence[str] = ("data",)) -> MeshGroup:
    """The rank's ``MeshGroup`` over ``data_axes`` of ``mesh``, made once
    per (mesh, axes): every rank of a group must ask for it (the group is
    created collectively by its members)."""
    axes = tuple(data_axes)
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is None or hit.mesh is not mesh:
        hit = _GROUPS[key] = MeshGroup(mesh, axes)
    return hit


def mesh_device(mesh, device=None) -> torch.device:
    """The device a mesh runs its shards on: the rank's current CUDA
    device for a ``"cuda"`` mesh, the CPU for a ``"cpu"`` mesh.  A
    ``device`` that disagrees with the mesh raises ValueError: nothing
    drops to the CPU on its own."""
    kind = getattr(mesh, "device_type", None)
    if kind is None:
        raise TypeError(f"mesh= takes a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if kind == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported mesh device type {kind!r}")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r} disagrees with the mesh, "
                         f"whose shards run on {dev}")
    return dev


# --------------------------------------------------------------------- #
# the counted collectives
# --------------------------------------------------------------------- #
def _host(t: torch.Tensor, grp: MeshGroup) -> torch.Tensor:
    return t.cpu() if grp.stage else t


def _count(kind: str, t: torch.Tensor) -> float:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()
    return time.perf_counter()


def _done(t0: float) -> None:
    COLLECTIVE_SECONDS[0] += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, grp: MeshGroup,
               op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``, the reference's psum) or maximum (``op="max"``,
    pmax) of ``t`` over the group: one all-reduce, on t's device."""
    t0 = _count("psum" if op == "sum" else "pmax", t)
    buf = _host(t, grp).contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=grp.group)
    out = buf.to(t.device)
    _done(t0)
    return out


def all_gather(t: torch.Tensor, grp: MeshGroup, dim: int = 0):
    """The group's ``t`` concatenated along ``dim`` in shard order (one
    all-gather; every shard's ``t`` has the same shape)."""
    t0 = _count("all_gather", t)
    src = _host(t, grp).contiguous()
    parts = [torch.empty_like(src) for _ in range(grp.size)]
    dist.all_gather(parts, src, group=grp.group)
    out = torch.cat(parts, dim=dim).to(t.device)
    _done(t0)
    return out


def reduce_scatter(t: torch.Tensor, grp: MeshGroup, dim: int = 0):
    """The sum of ``t`` over the group, cut into ``size`` equal chunks
    along ``dim``; this rank's chunk (one reduce-scatter, the reference's
    psum_scatter)."""
    t0 = _count("psum_scatter", t)
    src = _host(t, grp).movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // grp.size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    rs(out, src, group=grp.group)
    out = out.movedim(0, dim).to(t.device)
    _done(t0)
    return out


def ring_exchange(t: torch.Tensor, grp: MeshGroup) -> torch.Tensor:
    """One step of the ring (the reference's ``ppermute`` i -> i + 1):
    send ``t`` to the next shard, return the previous shard's."""
    t0 = _count("ppermute", t)
    src = _host(t, grp).contiguous()
    out = torch.empty_like(src)
    nxt = grp.ranks[(grp.index + 1) % grp.size]
    prv = grp.ranks[(grp.index - 1) % grp.size]
    ops = [dist.P2POp(dist.isend, src, nxt, grp.group),
           dist.P2POp(dist.irecv, out, prv, grp.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = out.to(t.device)
    _done(t0)
    return out


def own_chunk(t: torch.Tensor, grp: MeshGroup, dim: int) -> torch.Tensor:
    """This rank's one of ``size`` equal chunks of ``t`` along ``dim``."""
    n = t.shape[dim] // grp.size
    return t.narrow(dim, grp.index * n, n)


# --------------------------------------------------------------------- #
# autograd forms (the conventions: module docstring)
# --------------------------------------------------------------------- #
class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return all_gather(t, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.grp, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return all_gather(t, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return own_chunk(g, ctx.grp, ctx.dim).contiguous(), None, None


class _SumToReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        return all_reduce(t, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.grp), None


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return reduce_scatter(t, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.grp, ctx.dim), None, None


class _GradShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, size):
        ctx.size = size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return all_reduce(t, grp)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.grp), None


def gather_partial(t, grp: Optional[MeshGroup], dim: int):
    """All-gather whose backward is a reduce-scatter: the consumers'
    gradients differ from rank to rank and are summed back into the
    shard."""
    return t if grp is None else _GatherPartial.apply(t, grp, dim)


def gather_replicated(t, grp: Optional[MeshGroup], dim: int):
    """All-gather for replicated compute: every rank's gradient is the
    same, and each takes back its own slice."""
    return t if grp is None else _GatherReplicated.apply(t, grp, dim)


def sum_to_replicas(t, grp: Optional[MeshGroup]):
    """Sum all-reduce whose backward is the identity on each rank (after a
    row-parallel product)."""
    return t if grp is None else _SumToReplicas.apply(t, grp)


def copy_to_partials(t, grp: Optional[MeshGroup]):
    """Identity whose backward sums the ranks' gradients (before a
    column-parallel product)."""
    return t if grp is None else _CopyToPartials.apply(t, grp)


def sum_scatter(t, grp: Optional[MeshGroup], dim: int):
    """Reduce-scatter whose backward is an all-gather: each rank's chunk of
    the sum gets its whole gradient on that rank, and every rank's part
    of the sum reads every chunk's."""
    return t if grp is None else _SumScatter.apply(t, grp, dim)


def grad_share(t, grp: Optional[MeshGroup]):
    """Identity whose backward divides by the group's size: a value every
    rank of the group computes whole, in a program whose gradients the
    group sums (so the group counts it once)."""
    return t if grp is None else _GradShare.apply(t, grp.size)


def psum(t, grp: Optional[MeshGroup]):
    """Sum all-reduce that is its own adjoint (over the batch axes, where
    every rank's objective is its share of the global one)."""
    return t if grp is None else _Psum.apply(t, grp)


def pmax(t, grp: Optional[MeshGroup]):
    """Maximum over the group (no gradient: a stabilising reference)."""
    return t if grp is None else all_reduce(t.detach(), grp, op="max")
