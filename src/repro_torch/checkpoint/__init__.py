"""Fault-tolerant checkpoint/restart (`manager.CheckpointManager`)."""
