"""Faults planted in the program underneath a run, to show that the
comparison sees each one (the CPU tests) and to read each number's upper
reading where no lower-precision control moves it (``readings.py
--faults``).  Each is a context manager that patches the port for its
duration:

- ``state_unchanged``: the step's state never advances.  Sparsifier: every
  edge batch redraws the first batch's noise (its generator stands still);
  LRA: every call samples the first call's row indices.
- ``half_batch``: half of the batch left out and the rest standing for it.
  Sparsifier: the second half of each edge batch copies the first half;
  LRA: the sketch's second half of rows copies its first half.
- ``answer_altered``: one answer altered where it is produced.
  Sparsifier: one edge's weight doubled; LRA: one entry of the factor
  moved by 0.1.
- ``uniform_block`` (sparsifier): sample_block draws each level-1 block
  uniformly (Gumbel-max over equal scores) and reports the exact law's
  block probability, so every q and weight stays consistent while the
  neighbor law is wrong.
- ``uniform_neighbor`` (sparsifier): as ``uniform_block``, and the
  in-block draw takes a uniform live column, reporting its exact
  probability: each neighbor uniform over the points, weights exact.

The runs have one chip, so the exchange between chips has no fault here.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _uniform_block(ops):
    def make(orig):
        def sample_block(q, x, own, gumbel_noise, **kw):
            _, _, tot, bs = orig(q, x, own, gumbel_noise, **kw)
            blk = torch.argmax(gumbel_noise, dim=1)
            pb = torch.gather(bs, 1, blk[:, None])[:, 0] / tot
            return blk, pb, tot, bs
        return sample_block
    return _patch(ops, "sample_block", make)


def _uniform_column(ref):
    def make(orig):
        def level2_draw(kv, live, cols_c, u2):
            lv = live.to(kv.dtype)
            c = torch.cumsum(lv, dim=1)
            j = torch.sum((u2 * c[:, -1])[:, None] >= c, dim=1)
            j = j.clamp(0, kv.shape[1] - 1)
            nb = torch.gather(cols_c, 1, j[:, None])[:, 0]
            tot = torch.clamp(kv.sum(dim=1), min=1e-30)
            return nb, torch.gather(kv, 1, j[:, None])[:, 0] / tot
        return level2_draw
    return _patch(ref, "level2_draw", make)


def _sparsify(name):
    from repro_torch.kernels.kde_sampler import ops
    if name == "uniform_block":
        return _uniform_block(ops)
    if name == "uniform_neighbor":
        stack = contextlib.ExitStack()
        stack.enter_context(_uniform_block(ops))
        stack.enter_context(_uniform_column(ops._ref))
        return stack
    if name == "state_unchanged":
        def make(orig):
            held = {}

            def noise(batch, num_blocks, generator, device, **kw):
                if held.get("gen") is not generator:
                    held.update(gen=generator, noise=orig(
                        batch, num_blocks, generator, device, **kw))
                return held["noise"]
            return noise
        return _patch(ops, "draw_edge_noise", make)

    def make(orig):
        def scan(*args, **kw):
            u, v, w, quv, qvu, word = orig(*args, **kw)
            if name == "half_batch":
                h = u.shape[1] // 2
                for a in (u, v, w, quv, qvu):
                    a[:, h:2 * h] = a[:, :h]
            else:
                w[0, 0] *= 2.0
            return u, v, w, quv, qvu, word
        return scan
    return _patch(ops, "edge_batch_scan", make)


def _lra(name):
    from repro_torch.core import lowrank
    from repro_torch.core.sampling.rownorm import RowNormSampler
    if name == "state_unchanged":
        def make(orig):
            held = []

            def sample(self, size):
                if not held:
                    held.append(orig(self, size))
                return held[0].copy()
            return sample
        return _patch(RowNormSampler, "sample", make)
    if name == "half_batch":
        def make(orig):
            def rows(self, idx):
                sk = orig(self, idx)
                h = sk.shape[0] // 2
                sk[h:2 * h] = sk[:h]
                return sk
            return rows
        return _patch(RowNormSampler, "sketch_rows_device", make)

    def make(orig):
        def fkv(*args, **kw):
            r = orig(*args, **kw)
            r.u[0, 0] += 0.1
            return r
        return fkv
    return _patch(lowrank, "fkv_lowrank", make)


COMMON = ("state_unchanged", "half_batch", "answer_altered")
FAULTS = {"sparsify": COMMON + ("uniform_block", "uniform_neighbor"),
          "lra": COMMON}


def planted(pipeline: str, name: str):
    """The context manager that plants fault ``name`` under
    ``pipeline``'s calls."""
    if name not in FAULTS[pipeline]:
        raise ValueError(f"no fault {name!r} for {pipeline!r}")
    return {"sparsify": _sparsify, "lra": _lra}[pipeline](name)
