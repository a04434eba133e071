"""Serving stack of the port (counterpart of ``apex_tpu.serving``).

* ``kv_cache``  — paged K/V tensors + the host page allocator (null page 0)
* ``kv_tier``   — the int8 KV tier's codec (quantize at write, per-(page,
                  head) bf16 scales)
* ``quant``     — int8 per-channel weight quantization for the decode
                  matmuls (``weight_quant=`` / ``APEX_SERVE_WEIGHT_QUANT``,
                  default off; K23 on the card)
* ``sampling``  — temperature / top-k / top-p on per-request threefry
                  lanes, JAX's random bits (``APEX_SERVE_SAMPLING``)
* ``scheduler`` — continuous batching (fifo / priority) and the seeded
                  synthetic trace
* ``lifecycle`` — request event log, TTFT/TPOT derivation
* ``weights``   — the GPTModel parameter tree: carried over from JAX
                  (``from_jax_params``) or drawn from a torch seed, and
                  one tensor-parallel rank's slices of it
                  (``shard_param_tree``)
* ``model``     — packed prefill, the decode step and the K-step decode
                  block over the tree, through the prefill and decode
                  attention kernels
* ``engine``    — ``ServingEngine``: cache, parameters and scheduler; one
                  round admits, prefills (eager) and runs one decode
                  program (K steps, greedy or sampled, over bf16 or int8
                  KV pages and full or int8 weights), captured once as a
                  CUDA graph on the card
"""

from apex_tpu_torch.serving import kv_tier, lifecycle, quant  # noqa: F401
from apex_tpu_torch.serving import sampling  # noqa: F401
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
    load_param_tree,
    param_tree,
    shard_param_tree,
    to_numpy_tree,
)
