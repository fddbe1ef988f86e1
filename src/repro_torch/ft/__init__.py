"""Fault tolerance: compressed, atomic, async checkpoints of a train state
(:mod:`.checkpoint`), restores onto a changed device set (:mod:`.elastic`)
and heartbeat-based straggler and failure detection (:mod:`.heartbeat`)."""
from .checkpoint import CheckpointManager, CheckpointPolicy, LeafPolicy, RestoreReport
from .elastic import make_elastic_mesh, replan, reshard_state, validate_divisibility
from .heartbeat import Decision, HeartbeatMonitor

__all__ = [
    "CheckpointManager", "CheckpointPolicy", "LeafPolicy", "RestoreReport",
    "make_elastic_mesh", "replan", "reshard_state", "validate_divisibility",
    "HeartbeatMonitor", "Decision",
]
