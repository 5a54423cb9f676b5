"""Checkpointing: async save, retention, atomic commit, restore (a copy of
``repro/checkpoint/manager.py``; resharding onto another mesh,
``elastic.py``, waits for the port's mesh, ROADMAP A14)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, restore)
