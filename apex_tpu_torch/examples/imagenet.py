"""ImageNet training with amp, data parallelism and SyncBatchNorm
(counterpart of ``examples/imagenet/main_amp.py``), on synthetic data or
an image folder.

    python -m apex_tpu_torch.examples.imagenet --synthetic --steps 20 -b 256 \\
        --opt-level O2
    python -m apex_tpu_torch.examples.imagenet /data/imagenet -b 256 \\
        --epochs 2 --checkpoint ckpt.pt
    python -m apex_tpu_torch.examples.imagenet /data/imagenet -b 256 \\
        --epochs 3 --resume ckpt.pt --checkpoint ckpt.pt
    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \\
        -m apex_tpu_torch.examples.imagenet --synthetic --steps 20 -b 128

The flags are the JAX example's, and ``--num-filters`` (the ResNet's
width, 64) and ``--device``. One process per card: with the launcher
each rank joins the group (``parallel.multiproc.init_distributed``), the
batch norms sync over it, and ``-b`` is the per-rank batch. ``--device
cpu`` runs the plain PyTorch versions on the CPU; the default is the card.

Real data (``data`` without ``--synthetic``): ``root/train/<class>/...``
and ``root/val/<class>/...`` (or a flat ``root/<class>/...``) through
``apex_tpu_torch.data`` (Pillow needed): ``train_transform`` for training,
``eval_transform(max(isize + 32, 256), isize)`` for validation, shuffled
with the common seed, each rank taking its shard of the equalized order;
the class count comes from the train folder and the epoch length from
the dataset, as in JAX. After each epoch rank 0 saves
``{"params", "batch_stats", "amp_state", "epoch"}`` to ``--checkpoint``
(``torch.save`` of the port's own tensors, not JAX's pickle); ``--resume
FILE`` loads it, after checking that every rank sees the file, and
training goes on from its epoch.

The step (:func:`build_train_step`) does what the JAX step does, in
order: the images cast to the policy's compute dtype; forward and
backward on the scaled loss (``amp.value_and_scaled_grad``); the unscale
and the found-inf flag (K12 on the card); ``allreduce_gradients`` over
the group with the flag's MAX; ``AmpOptimizer.apply_gradients(...,
grads_already_unscaled=True)`` (K16, with the master-to-model copy under
O2); the metrics averaged over the group. The running stats update
whether or not the step is skipped, as JAX's ``new_bstats``. The model's
parameters, buffers and the amp state are updated in place, and the step
reads no device value on the host.
"""

import argparse
import itertools
import os
import random
import time

import torch
import torch.distributed as dist

from apex_tpu_torch import amp, default_device
from apex_tpu_torch.amp.frontend import Properties, build_policy, opt_levels
from apex_tpu_torch.models import resnet18, resnet50
from apex_tpu_torch.optimizers.fused_sgd import fused_sgd
from apex_tpu_torch.parallel.distributed import (allreduce_gradients,
                                                 allreduce_max,
                                                 allreduce_mean,
                                                 broadcast_params,
                                                 world_size)
from apex_tpu_torch.parallel.multiproc import init_distributed

ARCHS = {"resnet50": resnet50, "resnet18": resnet18}
IMAGENET_TRAIN_IMAGES = 1281167


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA ImageNet Training (apex main_amp port)")
    p.add_argument("data", nargs="?", default=None,
                   help="path to dataset (omit with --synthetic)")
    p.add_argument("--arch", "-a", default="resnet50", choices=ARCHS)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=256,
                   help="PER-PROCESS batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--print-freq", "-p", type=int, default=10)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--opt-level", type=str, default="O1")
    p.add_argument("--keep-batchnorm-fp32", type=str, default=None)
    p.add_argument("--loss-scale", type=str, default=None)
    p.add_argument("--prof", type=int, default=-1,
                   help="profile the step of this index with torch.profiler")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--evaluate", "-e", action="store_true",
                   help="evaluate on the validation set and exit")
    p.add_argument("--synthetic", action="store_true",
                   help="random data (no input pipeline)")
    p.add_argument("--steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--checkpoint", default="checkpoint.pt")
    p.add_argument("--num-filters", type=int, default=64,
                   help="the ResNet's width (its first stage's channels)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def make_lr_schedule(base_lr, len_epoch):
    """The example's learning rate as a function of the step count (a 0-d
    int tensor), computed on its device: /10 at epochs 30, 60 and 80, a
    linear warm-up over the first 5 epochs. Every division is by a 0-d
    device tensor, as JAX divides."""

    def sched(step):
        step = step.float()

        def c(v):
            return torch.full((), float(v), dtype=torch.float32,
                              device=step.device)

        epoch = step / c(len_epoch)
        factor = torch.floor(epoch / c(30.0)) + (epoch >= 80.0).float()
        lr = base_lr * torch.pow(c(0.1), factor)
        warm = base_lr * (1.0 + step) / c(5.0 * len_epoch)
        return torch.where(epoch < 5.0, torch.minimum(warm, lr), lr)

    return sched


def _loss_and_metrics(logits, labels):
    """Cross entropy on fp32 logits and prec@1 / prec@5 (fractions)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(1, labels[:, None]).squeeze(1).mean()
    preds = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
    top1 = (preds[:, 0] == labels).float().mean()
    top5 = (preds == labels[:, None]).any(dim=-1).float().mean()
    return loss, top1, top5


_COMMON_SEED = None


def _common_seed(args, device):
    """One seed on every rank (the model's init, the shuffle): 0 with
    --deterministic, else rank 0's, drawn once a process."""
    if args.deterministic:
        return 0
    global _COMMON_SEED
    if _COMMON_SEED is None:
        seed = torch.tensor(random.randrange(2 ** 31), device=device)
        if world_size() > 1:
            dist.broadcast(seed, src=0)
        _COMMON_SEED = int(seed.item())
    return _COMMON_SEED


def make_synthetic_loader(args, steps, device, rank=0):
    """Uniform [0, 1) NCHW images and uniform labels drawn on ``device``
    from a generator seeded per rank (the rank with --deterministic)."""
    seed = rank if args.deterministic else random.randrange(2 ** 31)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = args.image_size

    def loader():
        for _ in range(steps):
            images = torch.rand(args.batch_size, 3, h, h, generator=gen,
                                device=device)
            labels = torch.randint(0, args.num_classes, (args.batch_size,),
                                   generator=gen, device=device)
            yield images, labels

    return loader


_DATASETS = {}  # root -> ImageFolder (the folder scan runs once)


def _image_folder(root):
    from apex_tpu_torch import data as apex_data

    if root not in _DATASETS:
        _DATASETS[root] = apex_data.ImageFolder(root)
    return _DATASETS[root]


def _split_root(data, split):
    """torchvision's ``root/<split>/<class>/...``, else a flat
    ``root/<class>/...``."""
    root = os.path.join(data, split)
    return root if os.path.isdir(root) else data


def _real_data(args):
    return bool(args.data) and not args.synthetic


def make_loader(args, steps, device, train=True, epoch=0, rank=0, world=1):
    """``(batches, steps)``: the synthetic loader, or the image folder's
    (JAX's ``make_loader``): NCHW fp32 images in [0, 1) (an NHWC batch's
    channels_last view) and int64 labels on ``device``, this rank's shard
    of the common-seed shuffle, ``steps`` capped at the dataset's per-rank
    batch count."""
    if not _real_data(args):
        return make_synthetic_loader(args, steps, device, rank)(), steps
    from apex_tpu_torch import data as apex_data

    root = _split_root(args.data, "train" if train else "val")
    ds = _image_folder(root)
    if len(ds.classes) != args.num_classes:
        raise ValueError(f"{len(ds.classes)} classes under {root} vs "
                         f"--num-classes {args.num_classes}")
    tf = (apex_data.train_transform(args.image_size) if train
          else apex_data.eval_transform(max(args.image_size + 32, 256),
                                        args.image_size))
    n = len(ds) // (args.batch_size * world)
    if n == 0:
        raise ValueError(f"{len(ds)} images under {root} is fewer than the "
                         f"global batch ({args.batch_size} x {world} "
                         f"processes)")
    tail = len(ds) - n * args.batch_size * world
    if not train and tail and epoch == 0 and rank == 0:
        print(f"NOTE: {tail} tail validation samples are not evaluated "
              f"({len(ds)} images, global batch "
              f"{args.batch_size * world})", flush=True)
    steps = min(steps, n) if steps else n
    gen = apex_data.prefetch(ds, args.batch_size, tf, shuffle=train,
                             drop_last=True, seed=_common_seed(args, device),
                             epoch=epoch, shard=(rank, world))

    def batches():
        for images, labels in itertools.islice(gen, steps):
            yield (torch.from_numpy(images).to(device).permute(0, 3, 1, 2),
                   torch.from_numpy(labels).to(device, torch.int64))

    return batches(), steps


def _resume(args, device, model, amp_state, world):
    """``(amp_state, start_epoch)`` from ``--resume``'s record, the model's
    parameters and running stats loaded in place; every rank must see the
    file (checkpoints are rank 0's: a rank that resumes alone would
    desynchronize the replicas)."""
    have = os.path.isfile(args.resume)
    if world > 1:
        flag = torch.tensor([int(have)], device=device)
        dist.broadcast(flag, src=0)
        if bool(flag.item()) != have:
            raise RuntimeError(
                f"--resume {args.resume} visible on some ranks only; "
                f"checkpoints must live on a shared filesystem")
    if not have:
        print(f"=> no checkpoint found at {args.resume}", flush=True)
        return amp_state, 0
    ckpt = torch.load(args.resume, map_location=device, weights_only=False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ckpt["params"][name])
        for name, b in model.named_buffers():
            b.copy_(ckpt["batch_stats"][name])
    print(f"=> loaded checkpoint (epoch {ckpt['epoch']})", flush=True)
    return ckpt["amp_state"], ckpt["epoch"]


def save_checkpoint(path, model, amp_state, epoch):
    """The record ``--resume`` reads: the parameters and running stats by
    name, the amp state, and the epoch to start from."""
    torch.save({"params": {n: p.detach() for n, p in
                           model.named_parameters()},
                "batch_stats": dict(model.named_buffers()),
                "amp_state": amp_state, "epoch": epoch}, path)


def build_train_step(model, opt, process_group=None,
                     compute_dtype=torch.float32):
    """``step(amp_state, images, labels) -> (amp_state, metrics,
    overflow)``: one training step of ``model`` (its parameters and
    running stats updated in place) under the ``AmpOptimizer`` ``opt``,
    reduced over ``process_group`` (None: the default group when one is
    initialized). ``metrics`` is the device tensor [loss, prec@1,
    prec@5], averaged over the group; ``overflow`` a device bool."""
    params = dict(model.named_parameters())

    def loss_fn(_params, images, labels):
        logits = model(images, train=True)
        return _loss_and_metrics(logits, labels)[0], logits

    grad_fn = amp.value_and_scaled_grad(loss_fn, opt, has_aux=True)

    def step(amp_state, images, labels):
        images = images.to(compute_dtype)
        (loss, logits), grads, found_inf = grad_fn(params, amp_state, images,
                                                   labels)
        grads = allreduce_gradients(grads, process_group)
        found_inf = allreduce_max(found_inf, process_group)
        _, amp_state, info = opt.apply_gradients(
            grads, amp_state, params, grads_already_unscaled=True,
            found_inf=found_inf)
        with torch.no_grad():
            _, top1, top5 = _loss_and_metrics(logits.detach(), labels)
            metrics = allreduce_mean(torch.stack([loss, top1 * 100,
                                                  top5 * 100]),
                                     process_group)
        return amp_state, metrics, info["overflow"]

    return step


def build_eval_step(model, process_group=None, compute_dtype=torch.float32):
    """``step(images, labels) -> metrics``: the eval-mode forward (running
    stats) and [loss, prec@1, prec@5] averaged over the group."""

    @torch.no_grad()
    def step(images, labels):
        logits = model(images.to(compute_dtype), train=False)
        loss, top1, top5 = _loss_and_metrics(logits, labels)
        return allreduce_mean(torch.stack([loss, top1 * 100, top5 * 100]),
                              process_group)

    return step


def validate(args, model, compute_dtype, device, steps=None,
             process_group=None):
    """The eval loop with the JAX example's metering (synthetic: 8
    batches unless --steps; real data: the whole validation set unless
    --steps)."""
    eval_step = build_eval_step(model, process_group, compute_dtype)
    losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
    steps = steps or args.steps
    if not _real_data(args):
        steps = steps or 8
    world = world_size()
    rank = dist.get_rank() if world > 1 else 0
    loader, steps = make_loader(args, steps, device, train=False, rank=rank,
                                world=world)
    for i, (images, labels) in enumerate(loader):
        m = eval_step(images, labels).tolist()
        losses.update(m[0], args.batch_size)
        top1.update(m[1], args.batch_size)
        top5.update(m[2], args.batch_size)
        if i % args.print_freq == 0:
            print(f"Test: [{i}/{steps}]  Loss {losses.val:.4f} "
                  f"({losses.avg:.4f})  Prec@1 {top1.val:.2f} ({top1.avg:.2f})"
                  f"  Prec@5 {top5.val:.2f} ({top5.avg:.2f})", flush=True)
    print(f" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f}", flush=True)
    return losses.avg, top1.avg, top5.avg


def _properties(args):
    loss_scale = args.loss_scale
    if loss_scale is not None and loss_scale != "dynamic":
        loss_scale = float(loss_scale)
    keep_bn = args.keep_batchnorm_fp32
    if isinstance(keep_bn, str):
        keep_bn = {"True": True, "False": False}.get(keep_bn, None)
    properties = opt_levels[args.opt_level](Properties())
    for name, value in (("keep_batchnorm_fp32", keep_bn),
                        ("loss_scale", loss_scale)):
        if value is not None:
            setattr(properties, name, value)
    return properties, keep_bn, loss_scale


def main(argv=None):
    init_distributed()
    args = parse_args(argv)
    if _real_data(args):
        # the class count comes from the train folder, before the model
        troot = _split_root(args.data, "train")
        found = len(_image_folder(troot).classes)
        if found != args.num_classes:
            print(f"NOTE: {found} classes under {troot} (--num-classes "
                  f"{args.num_classes}); using the folder count", flush=True)
            args.num_classes = found
    device = default_device(args.device)
    if args.deterministic:     # the reference's cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    world = world_size()
    rank = dist.get_rank() if world > 1 else 0
    group = dist.group.WORLD if world > 1 else None

    properties, keep_bn, loss_scale = _properties(args)
    policy = build_policy(properties)
    model = ARCHS[args.arch](num_classes=args.num_classes,
                             norm_process_group=group,
                             dtype=policy.compute_dtype, device=device,
                             seed=_common_seed(args, device),
                             num_filters=args.num_filters)
    broadcast_params(model, group)

    # the epoch length the schedule reads: the dataset's, or ImageNet's
    images = (len(_image_folder(_split_root(args.data, "train")))
              if _real_data(args) else IMAGENET_TRAIN_IMAGES)
    full_len = images // (args.batch_size * world)
    steps = min(args.steps, full_len) if args.steps else full_len
    tx = fused_sgd(learning_rate=make_lr_schedule(args.lr, steps),
                   momentum=args.momentum, weight_decay=args.weight_decay)
    model, opt = amp.initialize(model, tx, opt_level=args.opt_level,
                                keep_batchnorm_fp32=keep_bn,
                                loss_scale=loss_scale)
    amp_state = opt.init(dict(model.named_parameters()))
    start_epoch = 0
    if args.resume:
        amp_state, start_epoch = _resume(args, device, model, amp_state,
                                         world)

    if args.evaluate:
        return validate(args, model, policy.compute_dtype, device,
                        process_group=group)[0]

    train_step = build_train_step(model, opt, group, policy.compute_dtype)
    batch_time, losses = AverageMeter(), AverageMeter()
    top1, top5 = AverageMeter(), AverageMeter()
    for epoch in range(start_epoch, args.epochs):
        for meter in (batch_time, losses, top1, top5):
            meter.reset()
        loader, steps = make_loader(args, steps, device, train=True,
                                    epoch=epoch, rank=rank, world=world)
        end = time.perf_counter()
        for i, (images, labels) in enumerate(loader):
            if i == args.prof:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    amp_state, metrics, _ = train_step(amp_state, images,
                                                       labels)
                    metrics.tolist()
                print(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=15))
            else:
                amp_state, metrics, _ = train_step(amp_state, images, labels)
            m = metrics.tolist()           # waits for the step
            if i == 0:                     # the first step's set-up is left out
                end = time.perf_counter()
                continue
            batch_time.update(time.perf_counter() - end)
            end = time.perf_counter()
            losses.update(m[0], args.batch_size)
            top1.update(m[1], args.batch_size)
            top5.update(m[2], args.batch_size)
            if i % args.print_freq == 0:
                ips = args.batch_size * world / batch_time.avg
                print(f"Epoch: [{epoch}][{i}/{steps}]  "
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})  "
                      f"Speed {ips:.1f} img/s  "
                      f"Loss {losses.val:.4f} ({losses.avg:.4f})  "
                      f"Prec@1 {top1.val:.2f} ({top1.avg:.2f})  "
                      f"Prec@5 {top5.val:.2f} ({top5.avg:.2f})", flush=True)
        if rank == 0:        # rank 0 saves, as the reference does
            save_checkpoint(args.checkpoint, model, amp_state, epoch + 1)
    ips = (args.batch_size * world / batch_time.avg) if batch_time.count \
        else 0.0
    print(f"DONE images/sec={ips:.1f} loss={losses.avg:.4f}")
    return losses.avg


if __name__ == "__main__":
    main()
