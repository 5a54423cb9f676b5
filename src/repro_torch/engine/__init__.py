"""repro_torch.engine — the serving engine (paged, recurrent and slots
backends) with pluggable schedulers and streaming outputs::

    from repro_torch.engine import Engine, Request

    engine = Engine(cfg, cache="paged", slots=8, max_len=1024,
                    num_blocks=160, block_size=16, chunk=32)
    engine.load_params()
    handle = engine.submit(Request(0, prompt, max_new_tokens=32))
    for tok in handle.tokens():        # streams as ticks produce tokens
        ...
"""
from repro_torch.engine.engine import Engine, Request  # noqa: F401
from repro_torch.engine.scheduler import (  # noqa: F401
    POLICIES, FIFOPolicy, PriorityPolicy, SchedulerPolicy, SchedulerState,
    SJFPolicy, resolve_policy)
from repro_torch.engine.state import (  # noqa: F401
    BlockPool, PagedKVState, RecurrentState, SequenceCapacity, SequenceState, SlotKVState)
from repro_torch.engine.stream import RequestHandle  # noqa: F401
