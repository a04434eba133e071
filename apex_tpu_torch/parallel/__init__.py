"""Data parallelism and synced batch norm (counterpart of
``apex_tpu.parallel``) over ``torch.distributed`` process groups:
``allreduce_gradients`` / ``DistributedDataParallel`` / ``Reducer``
(``distributed.py``), ``SyncBatchNorm`` / ``sync_batch_norm`` on K17/K18
(``sync_batchnorm.py``), and the launcher (``multiproc.py``). JAX's
``LARC``, ``collectives`` and ``zero3`` are still to port (ROADMAP)."""

from apex_tpu_torch.parallel.distributed import (DistributedDataParallel,
                                                 Reducer,
                                                 allreduce_gradients,
                                                 broadcast_params)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm, convert_syncbn_model, create_syncbn_process_group,
    sync_batch_norm)

__all__ = [
    "DistributedDataParallel", "Reducer", "allreduce_gradients",
    "broadcast_params", "SyncBatchNorm", "sync_batch_norm",
    "convert_syncbn_model", "create_syncbn_process_group",
]
