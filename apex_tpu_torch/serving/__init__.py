"""Serving stack of the port (counterpart of ``apex_tpu.serving``).

* ``kv_cache``  — paged K/V tensors + the host page allocator (null page 0)
* ``scheduler`` — continuous batching (fifo / priority) and the seeded
                  synthetic trace
* ``lifecycle`` — request event log, TTFT/TPOT derivation
* ``weights``   — the GPTModel parameter tree: carried over from JAX
                  (``from_jax_params``) or drawn from a torch seed
* ``model``     — packed prefill and greedy decode step over the tree,
                  through the prefill and decode attention kernels
* ``engine``    — ``ServingEngine``: cache, parameters and scheduler in
                  one serial greedy loop
"""

from apex_tpu_torch.serving import lifecycle  # noqa: F401
from apex_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from apex_tpu_torch.serving.kv_cache import (  # noqa: F401
    PageAllocator,
    init_cache,
    pages_needed,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    Request,
    offered_load,
    resolve_policy,
    synthetic_trace,
)
from apex_tpu_torch.serving.weights import (  # noqa: F401
    from_jax_params,
    init_gpt_params,
    to_numpy_tree,
)
