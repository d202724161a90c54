"""Serving runtime: paged KV cache, continuous batching and replicated
Byzantine-robust decode (port of ``repro/serve``, DESIGN.md §11)."""
from repro_torch.serve.cache import (BlockAllocator, OutOfBlocks,  # noqa: F401
                                     PagedKVCache, BLOCK_TOKENS)
from repro_torch.serve.engine import (ServeEngine,  # noqa: F401
                                      batched_prefill_supported, generate,
                                      generate_stepwise, make_serve_step)
from repro_torch.serve.robust_decode import (RobustDecoder,  # noqa: F401
                                             corrupt_replica, make_replicas)
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401
