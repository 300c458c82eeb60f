"""Algorithm 5.15 through the port's entry,
``repro_torch.core.lowrank.fkv_lowrank``.

A call samples the traffic's ``num_rows`` rows by their squared norms with
its own seed and returns the rank-``rank`` factor and the sampled indices
on the host.  Work: the kernel evaluations the program reports
(``LowRankResult.kernel_evals``).  A factor that is not finite has failed.
"""
from __future__ import annotations

import numpy as np

from kdebench.reference import lra as ref


def setup(config: dict, traffic: dict, x, bw: float, device) -> dict:
    """The harness's points ``x`` and bandwidth, and the kernel."""
    from repro_torch.core.kernels_fn import make_kernel
    return dict(x=x, bw=bw, entry=dict(traffic["entry"]), device=device,
                kernel=make_kernel(config["kernel"]["kind"], bandwidth=bw))


def call(state: dict, seed: int):
    """One approximation: (output, work, failed)."""
    from repro_torch.core.lowrank import fkv_lowrank
    r = fkv_lowrank(state["x"], state["kernel"], seed=seed,
                    device=state["device"], **state["entry"])
    out = dict(row_indices=r.row_indices, u=r.u)
    work = dict(kernel_evals=r.kernel_evals)
    return out, work, not bool(np.isfinite(r.u).all())


def release(state: dict) -> dict:
    """Drop the program's objects; keep the points the reference reads."""
    return dict(x=state["x"], bw=state["bw"], entry=state["entry"])


def numbers(inputs: dict, outputs: list, seed: int, params: dict) -> dict:
    """The compared numbers of ``reference.lra`` over the outputs."""
    return ref.lra_numbers(inputs["x"], _norms(inputs), outputs,
                           1.0 / inputs["bw"])


def _norms(inputs: dict):
    """The reference's row norms of the points, made once a run."""
    if "norms" not in inputs:
        inputs["norms"] = ref.row_norms(inputs["x"], 1.0 / inputs["bw"])
    return inputs["norms"]


def control(inputs: dict, seed: int, params: dict) -> dict:
    """The control's numbers: the TF32 plain algorithm's own calls, held
    as the program's are."""
    inv_bw = 1.0 / inputs["bw"]
    e = inputs["entry"]
    tf = ref.row_norms(inputs["x"], inv_bw, tf32=True)
    calls = [ref.control_lra(inputs["x"], inv_bw, e["rank"], e["num_rows"],
                             seed + i, norms_tf32=tf)
             for i in range(params["control_calls"])]
    return ref.lra_numbers(inputs["x"], _norms(inputs), calls, inv_bw)

