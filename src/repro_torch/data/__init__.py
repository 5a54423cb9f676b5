"""Data pipeline: deterministic synthetic LM batches + a prefetching loader
(a copy of ``repro/data``)."""
from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import batch_shapes, synthetic_batch  # noqa: F401
