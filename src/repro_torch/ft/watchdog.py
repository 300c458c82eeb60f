"""Straggler and failure watchdog.

On a real cluster every host reports a heartbeat with its last step wall
time; the controller keeps per-host EWMAs and flags hosts slower than
``straggler_factor`` x the fleet median (straggler mitigation: reroute data
shards, or checkpoint and evict).  Here hosts are simulated (one process),
but the decision logic is real and unit-tested -- a driver consumes
``decide()`` verbatim.  Pure host code: the reference's, event for event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _m


@dataclasses.dataclass
class HostStats:
    ewma_s: float = 0.0
    last_beat: float = 0.0
    steps: int = 0


class Watchdog:
    def __init__(self, hosts: int, alpha: float = 0.3,
                 straggler_factor: float = 1.5,
                 heartbeat_timeout_s: float = 300.0,
                 now: Optional[float] = None):
        # every host's clock starts at construction: a host that NEVER
        # heartbeats is declared dead after heartbeat_timeout_s, instead
        # of being skipped forever (``now=`` for deterministic tests)
        start = now if now is not None else time.monotonic()
        self.stats: Dict[int, HostStats] = {
            h: HostStats(last_beat=start) for h in range(hosts)}
        self.alpha = alpha
        self.factor = straggler_factor
        self.timeout = heartbeat_timeout_s

    def beat(self, host: int, step_time_s: float,
             now: Optional[float] = None):
        st = self.stats[host]
        st.ewma_s = (step_time_s if st.steps == 0
                     else self.alpha * step_time_s
                     + (1 - self.alpha) * st.ewma_s)
        st.steps += 1
        st.last_beat = now if now is not None else time.monotonic()
        _m.event("watchdog.beat", host=host, step_time_s=step_time_s,
                 ewma_s=st.ewma_s)

    def median_ewma(self) -> float:
        vals = sorted(s.ewma_s for s in self.stats.values() if s.steps > 0)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def decide(self, now: Optional[float] = None) -> Dict[str, List[int]]:
        """-> {"stragglers": [...], "dead": [...]}"""
        now = now if now is not None else time.monotonic()
        med = self.median_ewma()
        stragglers, dead = [], []
        for h, st in self.stats.items():
            if now - st.last_beat > self.timeout:
                dead.append(h)
            elif st.steps > 0 and med > 0 and st.ewma_s > self.factor * med:
                stragglers.append(h)
        _m.event("watchdog.decide", stragglers=stragglers, dead=dead,
                 median_ewma_s=med)
        return {"stragglers": stragglers, "dead": dead}
