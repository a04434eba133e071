"""Data parallelism and synced batch norm (counterpart of
``apex_tpu.parallel``) over ``torch.distributed`` process groups:
``allreduce_gradients`` / ``DistributedDataParallel`` / ``Reducer``
(``distributed.py``), the collectives layer with its int8 codec (K19,
K20) and hierarchical route (``collectives.py``), ``SyncBatchNorm`` /
``sync_batch_norm`` on K17/K18 (``sync_batchnorm.py``), ``LARC`` /
``larc`` (``LARC.py``), and the launcher (``multiproc.py``). JAX's
``zero3`` is not ported yet: its buckets read the (sp, ep, hp) tree of the
minimal pipeline GPT, its only caller, so it comes with that model and
``pipeline_parallel`` (ROADMAP)."""

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.distributed import (DistributedDataParallel,
                                                 Reducer,
                                                 allreduce_gradients,
                                                 broadcast_params)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm, convert_syncbn_model, create_syncbn_process_group,
    sync_batch_norm)
from apex_tpu_torch.parallel.LARC import LARC, larc

__all__ = [
    "DistributedDataParallel", "Reducer", "allreduce_gradients",
    "broadcast_params", "SyncBatchNorm", "sync_batch_norm",
    "convert_syncbn_model", "create_syncbn_process_group", "LARC", "larc",
    "collectives",
]
