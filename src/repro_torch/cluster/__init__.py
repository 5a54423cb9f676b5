"""repro_torch.cluster — a router over N engine replicas, with live request
migration.

The port of ``repro/cluster/``::

    from repro_torch.cluster import Router, Replica, MigrateOnOversubscription

    router = Router([Replica(engine_a, model="llama"),
                     Replica(engine_b, model="llama")],
                    rebalance=MigrateOnOversubscription())
    handle = router.submit(Request(0, prompt))   # cost-model placement
    router.migrate(0, engine_b.engine_id)        # live handoff (frames)
    for tok in handle.tokens():                  # survives the migration
        ...
    router.metrics()                             # merged cluster surface
"""
from repro_torch.cluster.handoff import (  # noqa: F401
    HANDOFF_SPEC, MIGRATE_FUNC_ID, decode_handoff, encode_handoff)
from repro_torch.cluster.policy import (  # noqa: F401
    MigrateOnOversubscription, MigrationPlan, RebalancePolicy)
from repro_torch.cluster.router import ClusterHandle, Replica, Router  # noqa: F401
from repro_torch.faults import (  # noqa: F401  the chaos and recovery vocabulary
    EngineFailedError, FaultInjector, FaultPlan, MigrationFailedError, RequestFailedError)
