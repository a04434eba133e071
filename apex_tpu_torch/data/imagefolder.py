"""ImageFolder dataset + threaded prefetching loader (a copy of
``apex_tpu/data/imagefolder.py``: host code on numpy and Pillow, which the
port keeps for itself; the same seed gives the same batches bit for bit).

Functional port of the reference ImageNet input pipeline
(examples/imagenet/main_amp.py: torchvision ``ImageFolder`` +
``RandomResizedCrop(crop)/RandomHorizontalFlip`` for train,
``Resize(256)/CenterCrop(224)`` for eval, multi-worker ``DataLoader``
with ``shuffle`` and ``drop_last``) without torch: PIL decode, numpy
batches, a thread pool hiding decode latency behind the device step.

Layout convention matches torchvision: ``root/<class_name>/*.jpg`` —
classes are sorted names → contiguous indices.

Batches are float32 NHWC in [0, 1) (the contract of the example's
synthetic loader; per-channel normalization, where a model wants it,
happens on the device).
"""

import os
import random
import threading
import queue as queue_mod
from concurrent.futures import ThreadPoolExecutor

import numpy as np

try:
    from PIL import Image
    HAVE_PIL = True
except Exception:  # pragma: no cover
    Image = None
    HAVE_PIL = False

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """Scan ``root/<class>/<image>`` into (path, class_index) samples."""

    def __init__(self, root):
        if not HAVE_PIL:
            raise ImportError(
                "apex_tpu_torch.data.ImageFolder requires Pillow")
        self.root = os.fspath(root)
        self.classes = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))
        if not self.classes:
            raise FileNotFoundError(
                f"no class directories under {self.root!r} "
                "(expected root/<class_name>/<images>)")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(self.root, c)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(_EXTS):
                    self.samples.append(
                        (os.path.join(cdir, name), self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {self.root!r}")

    def __len__(self):
        return len(self.samples)


def train_transform(crop=224, rng=None):
    """RandomResizedCrop(crop) + horizontal flip → float32 HWC in [0,1).

    The scale/ratio envelope matches torchvision's defaults
    (scale 0.08-1.0 of area, ratio 3/4-4/3). The returned callable takes
    ``(img, rng=None)``; :func:`prefetch` passes a per-sample seeded rng
    so augmentation is deterministic under a fixed seed regardless of
    decode-thread interleaving.
    """
    default_rng = rng or random.Random()

    def f(img, rng=None):
        rng = rng or default_rng
        img = img.convert("RGB")
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = rng.uniform(0.08, 1.0) * area
            ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if 0 < cw <= w and 0 < ch <= h:
                x = rng.randint(0, w - cw)
                y = rng.randint(0, h - ch)
                img = img.resize((crop, crop), Image.BILINEAR,
                                 box=(x, y, x + cw, y + ch))
                break
        else:  # fallback: center crop of the short side
            s = min(w, h)
            x, y = (w - s) // 2, (h - s) // 2
            img = img.resize((crop, crop), Image.BILINEAR,
                             box=(x, y, x + s, y + s))
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(img, np.float32) / 255.0

    return f


def eval_transform(resize=256, crop=224):
    """Resize(short side) + CenterCrop → float32 HWC in [0,1)."""

    def f(img, rng=None):
        img = img.convert("RGB")
        w, h = img.size
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        img = img.resize((nw, nh), Image.BILINEAR)
        x, y = (nw - crop) // 2, (nh - crop) // 2
        img = img.crop((x, y, x + crop, y + crop))
        return np.asarray(img, np.float32) / 255.0

    return f


def prefetch(dataset, batch_size, transform, *, shuffle=True,
             drop_last=True, seed=0, epoch=0, num_workers=8,
             prefetch_batches=4, shard=(0, 1)):
    """Generator of (images [b,h,w,3] float32, labels [b] int32) batches.

    The DataLoader analog: per-epoch deterministic shuffle
    (``seed``+``epoch``), decode/augment on ``num_workers`` threads, up to
    ``prefetch_batches`` batches decoded ahead of the consumer so the
    device step never waits on PIL. ``drop_last`` mirrors the reference's
    training loader (static batch shapes).

    ``shard=(rank, world)``: the DistributedSampler analog — all ranks
    shuffle with the SAME seed, then rank takes every world-th index, so
    an epoch partitions the dataset across processes with no overlap.
    """
    rank, world = shard
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed + epoch).shuffle(order)
    if world > 1:
        # equalize BEFORE sharding (DistributedSampler discipline): every
        # rank must see the same batch count or an SPMD consumer running
        # one collective per batch deadlocks on the longer rank
        order = order[:world * (len(order) // world)][rank::world]
    n_batches = (len(order) // batch_size if drop_last
                 else (len(order) + batch_size - 1) // batch_size)
    if n_batches == 0:
        return

    def load_one(idx):
        path, label = dataset.samples[idx]
        # per-SAMPLE seeded augmentation rng: deterministic for a fixed
        # (seed, epoch) no matter how decode threads interleave
        rng = random.Random((seed * 1_000_003 + epoch) * 2_000_029 + idx)
        with Image.open(path) as img:
            return transform(img, rng=rng), label

    def make_batch(b):
        idxs = order[b * batch_size:(b + 1) * batch_size]
        out = [load_one(i) for i in idxs]
        images = np.stack([x for x, _ in out])
        labels = np.asarray([y for _, y in out], np.int32)
        return images, labels

    # bounded queue of decoded batches; one producer thread farms batch
    # members out to the pool so batch order stays deterministic
    q = queue_mod.Queue(maxsize=prefetch_batches)
    stop = threading.Event()

    def producer():
        # the sentinel/exception put lives in finally: a decode error must
        # surface in the consumer, never leave it blocked on q.get()
        err = None
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                futures = [pool.submit(make_batch, b) for b in
                           range(min(prefetch_batches, n_batches))]
                next_submit = len(futures)
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    q.put(futures[b].result())
                    if next_submit < n_batches:
                        futures.append(pool.submit(make_batch, next_submit))
                        next_submit += 1
        except Exception as e:  # noqa: BLE001 — re-raised in the consumer
            err = e
        finally:
            q.put(err)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the producer's blocked put() can observe the stop flag
        while t.is_alive():
            try:
                q.get_nowait()
            except queue_mod.Empty:
                t.join(timeout=0.1)
