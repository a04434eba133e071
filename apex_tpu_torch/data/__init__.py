"""apex_tpu_torch.data — host-side input pipelines (counterpart of
``apex_tpu.data``).

The reference delegates data loading to torchvision's multi-worker
``DataLoader`` (examples/imagenet/main_amp.py builds ImageFolder +
RandomResizedCrop pipelines). Here, as in the JAX package: decode and
augment on the host with a thread pool, prefetch ahead of the device step,
hand the step contiguous NHWC numpy batches. Needs Pillow
(``ImageFolder`` raises ``ImportError`` without it).
"""

from apex_tpu_torch.data.imagefolder import (  # noqa: F401
    ImageFolder,
    eval_transform,
    prefetch,
    train_transform,
)
