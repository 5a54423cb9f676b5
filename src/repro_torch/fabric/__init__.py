"""repro_torch.fabric: one function-invocation surface over jams, rieds,
mailboxes and registered collectives, with warm-state leases. Served DAGs
of fabric functions live in ``repro_torch.fabric.graph``."""
from repro_torch.fabric.fabric import Fabric  # noqa: F401
from repro_torch.fabric.leases import Lease, LeasePool  # noqa: F401
