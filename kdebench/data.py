"""The points of a configuration and the bandwidth both sides are handed.

A configuration's ``data.recipe`` names ``recipes/<recipe>.py``, whose
``make(generator, device, **sizes)`` draws the points on the run's device
with one ``torch.Generator`` in a few large calls, so that set-up never
builds them on the host.  ``kernel.bandwidth`` is a number or the name of
a rule, ``bandwidths/<rule>.py``, whose ``rule(x, generator)`` works it
out from the points.  The same seed gives the same points and bandwidth on
the same device.
"""
from __future__ import annotations

from pathlib import Path

import torch

from kdebench import registry


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_points(config: dict, seed: int, device,
                bench: Path = registry.BENCH) -> torch.Tensor:
    """The configuration's points for ``seed`` on ``device``, float32."""
    sizes = {k: v for k, v in config["data"].items() if k != "recipe"}
    recipe = registry.load("recipes", config["data"]["recipe"], bench)
    return recipe.make(generator(seed, device), device, **sizes).float()


def bandwidth(config: dict, x: torch.Tensor, seed: int,
              bench: Path = registry.BENCH) -> float:
    """The configuration's bandwidth: its number, or its rule's value."""
    bw = config["kernel"]["bandwidth"]
    if isinstance(bw, str):
        rule = registry.load("bandwidths", bw, bench)
        return float(rule.rule(x, generator(seed + 1, x.device)))
    return float(bw)
