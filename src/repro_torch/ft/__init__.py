"""Fault tolerance: compressed, atomic, async checkpoints of a train state
(:mod:`.checkpoint`) and heartbeat-based straggler and failure detection
(:mod:`.heartbeat`).  Elastic resharding is not ported yet."""
from .checkpoint import CheckpointManager, CheckpointPolicy, LeafPolicy, RestoreReport
from .heartbeat import Decision, HeartbeatMonitor

__all__ = [
    "CheckpointManager", "CheckpointPolicy", "LeafPolicy", "RestoreReport",
    "HeartbeatMonitor", "Decision",
]
