"""Serving plane of the port: the paged-KV decode engine and the HTTP server.

Counterpart of ``horovod_tpu/serving``:

- :mod:`~horovod_tpu_torch.serving.decode`: continuous-batching LLM decode
  over the paged KV cache (``models/decode.py``): slot admit and retire,
  the block allocator, the swap-aware engine behind ``POST /generate``, on
  one card or over a tp process group;
- :mod:`~horovod_tpu_torch.serving.registry`: the served model's RCU
  pointer;
- :mod:`~horovod_tpu_torch.serving.server`: the HTTP frontend with bucketed
  dynamic batching and ``hvd_serving_*`` telemetry.

The publisher, the fleet and the registry's adoption from a store ride on
the checkpoint store and the elastic coordinator, which are not ported
yet (ROADMAP.md, section A).
"""

from .decode import BlockAllocator, DecodeEngine, DecodeRequest  # noqa: F401
from .registry import ModelRegistry, ServedModel                 # noqa: F401
from .server import InferenceServer, pad_to_bucket               # noqa: F401
