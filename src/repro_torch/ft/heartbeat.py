"""Heartbeat-based straggler/failure detection + mitigation policy.

The JAX package's ``repro.ft.heartbeat``, ported (host logic only).

Pure logic (injectable clock) so the policy is unit-testable without a
cluster.  In production each host posts a heartbeat after every step; the
coordinator runs ``observe`` and acts on the returned decisions:

  * ``straggler``  — step time > straggler_factor x rolling median: the
    launcher can re-balance (drop the host from the next elastic re-mesh) or
    just log; repeated stragglers escalate.
  * ``dead``       — no heartbeat for timeout_s: trigger checkpoint-restore
    onto the surviving hosts.

This is intentionally mechanism-only: SCHEDULING reactions (evict/remesh/
continue) belong to the launcher, which the decisions parameterize.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional

from ..core import telemetry

log = telemetry.get_logger("heartbeat")


@dataclasses.dataclass
class Decision:
    host: str
    kind: str  # "ok" | "straggler" | "dead"
    detail: str = ""


class HeartbeatMonitor:
    def __init__(
        self,
        hosts: List[str],
        timeout_s: float = 120.0,
        straggler_factor: float = 2.0,
        window: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.hosts = list(hosts)
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.last_beat: Dict[str, float] = {h: clock() for h in hosts}
        self.step_times: Dict[str, deque] = {h: deque(maxlen=window) for h in hosts}
        self.strikes: Dict[str, int] = defaultdict(int)

    def beat(self, host: str, step_time_s: Optional[float] = None):
        now = self.clock()
        self.last_beat[host] = now
        if step_time_s is not None:
            self.step_times[host].append(step_time_s)

    def observe(self) -> List[Decision]:
        """Evaluate the fleet; non-``ok`` decisions are logged (structured
        key=value lines, ``repro_torch.telemetry.heartbeat`` namespace) and counted
        in the global metrics registry — the policy itself stays pure."""
        out = self._observe()
        for d in out:
            if d.kind == "dead":
                telemetry.metric_count("sz3_heartbeat_dead_total")
                log.error("host_dead", host=d.host, detail=d.detail)
            elif d.kind == "straggler":
                telemetry.metric_count("sz3_heartbeat_straggler_total")
                log.warning("host_straggler", host=d.host, detail=d.detail)
        return out

    def _observe(self) -> List[Decision]:
        now = self.clock()
        out: List[Decision] = []
        all_times = [t for h in self.hosts for t in self.step_times[h]]
        med = statistics.median(all_times) if all_times else None
        for h in self.hosts:
            if now - self.last_beat[h] > self.timeout_s:
                out.append(Decision(h, "dead", f"no heartbeat for {now - self.last_beat[h]:.0f}s"))
                continue
            if med and self.step_times[h]:
                mine = statistics.median(self.step_times[h])
                if mine > self.straggler_factor * med:
                    self.strikes[h] += 1
                    out.append(
                        Decision(
                            h,
                            "straggler",
                            f"median {mine:.2f}s vs fleet {med:.2f}s (strike {self.strikes[h]})",
                        )
                    )
                    continue
                self.strikes[h] = max(0, self.strikes[h] - 1)
            out.append(Decision(h, "ok"))
        return out

    def survivors(self) -> List[str]:
        now = self.clock()
        return [h for h in self.hosts if now - self.last_beat[h] <= self.timeout_s]
