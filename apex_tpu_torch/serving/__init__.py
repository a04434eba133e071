"""Serving stack of the port (counterpart of ``apex_tpu.serving``).

* ``kv_cache``  — paged K/V tensors + the host page allocator (null page 0)
* ``kv_tier``   — the int8 KV tier's codec (quantize at write, per-(page,
                  head) bf16 scales) and the host swap tier
                  (``SwappedPages``, ``APEX_SERVE_KV_SWAP``)
* ``quant``     — int8 per-channel weight quantization for the decode
                  matmuls (``weight_quant=`` / ``APEX_SERVE_WEIGHT_QUANT``,
                  default off; K23 on the card)
* ``sampling``  — temperature / top-k / top-p on per-request threefry
                  lanes, JAX's random bits (``APEX_SERVE_SAMPLING``)
* ``scheduler`` — continuous batching (fifo / priority), the prefix-cache
                  admission, KV-pressure preemption, and the seeded
                  synthetic trace
* ``speculative`` — n-gram self-drafting: drafts verified in the packed
                  prefill call (``APEX_SPEC_DECODE``)
* ``prefix_cache`` — content-hashed refcounted copy-on-write page sharing
                  (``APEX_SERVE_PREFIX_CACHE``)
* ``resilience`` — admission control (``Rejected``), deadline shedding,
                  preemption, and the dispatch watchdog
                  (``guarded_dispatch``, ``DispatchFailure``) behind round
                  recovery (``APEX_SERVE_ADMIT`` / ``APEX_SERVE_SHED`` /
                  ``APEX_SERVE_PREEMPT`` / ``APEX_SERVE_RECOVER``)
* ``lifecycle`` — request event log (with the rejected / shed /
                  preempted / degraded-round / swap-failed and the fleet's
                  routed / failover / replayed chains), per-round gauges,
                  TTFT/TPOT derivation, the SLO account (``slo_block``)
* ``weights``   — the GPTModel parameter tree: carried over from JAX
                  (``from_jax_params``) or drawn from a torch seed, and
                  one tensor-parallel rank's slices of it
                  (``shard_param_tree``)
* ``model``     — packed prefill, the decode step and the K-step decode
                  block over the tree, through the prefill and decode
                  attention kernels
* ``engine``    — ``ServingEngine``: cache, parameters and scheduler; one
                  round admits (prefix hits, swap-ins), prefills or
                  replays (eager), verifies drafts (eager), grows the
                  tables under preemption, and runs one decode program
                  (K steps, greedy or sampled, over bf16 or int8 KV pages
                  and full or int8 weights), captured once as a CUDA
                  graph on the card; with ``recover`` every dispatch
                  runs under the watchdog and a failed round is
                  recovered; with ``overlap`` the decode fetch is
                  deferred one round
* ``router``    — N engines under one routing policy
                  (``APEX_ROUTE_POLICY``: ``round_robin`` |
                  ``least_loaded`` | ``prefix_affinity``), replica health
                  with a circuit breaker and probes, failover that replays
                  through survivors, fleet and replica admission, and the
                  fleet's account (``router_block``)
"""

from apex_tpu_torch.serving import kv_tier, lifecycle, quant  # noqa: F401
from apex_tpu_torch.serving import prefix_cache, resilience  # noqa: F401
from apex_tpu_torch.serving import sampling, speculative  # noqa: F401
from apex_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine,
    detokenize,
)
from apex_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from apex_tpu_torch.serving.resilience import (  # noqa: F401
    DispatchFailure,
    Rejected,
)
from apex_tpu_torch.serving.sampling import SamplingParams  # noqa: F401
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
from apex_tpu_torch.serving.router import (  # noqa: F401
    AutoscalePolicy,
    Router,
    router_block,
)
