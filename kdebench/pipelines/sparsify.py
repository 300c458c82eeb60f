"""Algorithm 5.1 through the port's entry,
``repro_torch.core.sparsify.spectral_sparsify``.

A call draws t = ``edges_per_point`` * n edges with the traffic's entry
keywords and its own seed; its output is the edge list, the weights and the
degrees the sources were drawn from, on the host.  Work: the edges and the
kernel evaluations the program reports (``SparseGraph.kernel_evals``).  A
call whose status word carries a fatal ``ft.guards`` bit has failed.
"""
from __future__ import annotations

from kdebench.reference import sparsify as ref


def setup(config: dict, traffic: dict, x, bw: float, device) -> dict:
    """The harness's points ``x`` (n, d) and bandwidth, the kernel, the
    edge budget."""
    from repro_torch.core.kernels_fn import make_kernel
    entry = dict(traffic["entry"])
    t = int(entry.pop("edges_per_point")) * int(x.shape[0])
    return dict(x=x, bw=bw, t=t, entry=entry, device=device,
                kernel=make_kernel(config["kernel"]["kind"], bandwidth=bw))


def call(state: dict, seed: int):
    """One sparsifier: (output, work, failed)."""
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.ft.guards import FATAL
    g = spectral_sparsify(state["x"], state["kernel"], state["t"],
                          seed=seed, device=state["device"], **state["entry"])
    out = dict(src=g.src, dst=g.dst, weight=g.weight, degrees=g.degrees)
    work = dict(edges=g.num_edges, kernel_evals=g.kernel_evals)
    return out, work, bool(g.status & FATAL)


def release(state: dict) -> dict:
    """Drop the program's objects; keep the points the reference reads."""
    return dict(x=state["x"], bw=state["bw"], t=state["t"])


def numbers(inputs: dict, outputs: list, seed: int, params: dict) -> dict:
    """The compared numbers of ``reference.sparsify`` over the outputs."""
    inv_bw2 = 1.0 / inputs["bw"] ** 2
    return ref.graph_numbers(inputs["x"], _sweep(inputs), outputs,
                             inputs["t"], inv_bw2)


def _sweep(inputs: dict) -> dict:
    """The reference's sweep of the points, made once a run."""
    if "sweep" not in inputs:
        inputs["sweep"] = ref.sweep(inputs["x"], 1.0 / inputs["bw"] ** 2)
    return inputs["sweep"]


def control(inputs: dict, seed: int, params: dict) -> dict:
    """The control's numbers: the TF32 sampler's own graph, held as the
    program's are."""
    inv_bw2 = 1.0 / inputs["bw"] ** 2
    g = ref.control_graph(inputs["x"], inv_bw2, inputs["t"], seed)
    return ref.graph_numbers(inputs["x"], _sweep(inputs), [g], inputs["t"],
                             inv_bw2)

