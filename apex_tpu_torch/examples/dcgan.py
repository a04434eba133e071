"""DCGAN with amp: two models, two optimizers, three losses (counterpart of
``examples/dcgan/main_amp.py``, BASELINE config 5).

    python -m apex_tpu_torch.examples.dcgan --steps 5 -b 64
    python -m apex_tpu_torch.examples.dcgan /path/to/images --steps 20
    python -m apex_tpu_torch.examples.dcgan --steps 2 -b 4 --ngf 8 --ndf 8 \\
        --device cpu

The flags are the JAX example's; ``--device cpu`` runs the plain PyTorch
versions on the CPU, the default is the card. Each model is wrapped by
``amp.initialize(model, fused_adam(lr, betas=(beta1, 0.999)),
num_losses=3)``: the Adam step is K14 on the card, the unscale K12, the
batch norms K17/K18. The images are synthetic (``np.random.RandomState
(0)``: ``rand * 2 - 1`` a batch, then ``randn`` for z, in JAX's order), or
an image folder (``data``: ``root/<class>/<images>``, Pillow needed)
through ``apex_tpu_torch.data``: ``eval_transform(isize, isize)``, epochs
cycled, ``[0, 1)`` mapped to ``[-1, 1)``.

:func:`build_train_step` is JAX's step (``main_amp.py:72-124``) in order:
D on the real batch (loss 0; D's running stats move), G's forward on z
(G's stats move), D on the detached fake (loss 1; D's stats continue from
the real pass), ``gD = g0 + g1``, loss 1's scaler advanced from its own
flag, D stepped on loss 0 with the skip predicate ``inf0 | inf1`` and
loss 0's scaler advanced from ``inf0``; then G (loss 2): G run again from
its stats of the D step (so G's running stats move twice an iteration)
through D in train mode with D's stats left as they are, G stepped.
``bce_logits`` is optax's ``sigmoid_binary_cross_entropy`` in fp32,
averaged.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp, default_device
from apex_tpu_torch.models import Discriminator, Generator
from apex_tpu_torch.optimizers.fused_adam import fused_adam


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DCGAN with amp (PyTorch/CUDA)")
    p.add_argument("data", nargs="?", default=None,
                   help="image-folder root (omit for synthetic data)")
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--opt-level", type=str, default="O1")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def bce_logits(logits, target):
    """optax's ``sigmoid_binary_cross_entropy`` against a constant target,
    in fp32, averaged."""
    x = logits.float()
    return torch.mean(-target * F.logsigmoid(x)
                      - (1.0 - target) * F.logsigmoid(-x))


def build_models(args, device):
    """G and D at the flags' widths, initialized from seed 0, and each
    wrapped by ``amp.initialize`` with its Adam: ``(netG, netD, optG,
    optD)``, the models' parameters cast in place."""
    netG = Generator(nz=args.nz, ngf=args.ngf, device=device, seed=0)
    netD = Discriminator(ndf=args.ndf, device=device, seed=0)
    models, opts = [], []
    for net in (netG, netD):
        tx = fused_adam(args.lr, betas=(args.beta1, 0.999), weight_decay=0.0)
        net, opt = amp.initialize(net, tx, opt_level=args.opt_level,
                                  num_losses=3, verbosity=0)
        models.append(net)
        opts.append(opt)
    return models[0], models[1], opts[0], opts[1]


def build_train_step(netG, netD, optG, optD):
    """``step(stG, stD, real, z) -> (stG, stD, losses)``: one iteration of
    the three-loss step (the module docstring gives its order) on NHWC
    ``real`` images and ``z`` ``[B, 1, 1, nz]``; the models' parameters,
    running stats and the amp states are updated in place, ``losses`` is
    the device tensor ``[loss_D_real + loss_D_fake, loss_G]``. No device
    value is read on the host."""
    pG = dict(netG.named_parameters())
    pD = dict(netD.named_parameters())

    def d_real(_p, real):
        return bce_logits(netD(real, train=True), 1.0)

    def d_fake(_p, fake):
        return bce_logits(netD(fake, train=True), 0.0)

    def g_loss(_p, z):
        fake = netG(z, train=True)
        return bce_logits(netD(fake, train=True, update_stats=False), 1.0)

    f0 = amp.value_and_scaled_grad(d_real, optD, loss_id=0)
    f1 = amp.value_and_scaled_grad(d_fake, optD, loss_id=1)
    f2 = amp.value_and_scaled_grad(g_loss, optG, loss_id=2)

    def step(stG, stD, real, z):
        loss_real, g0, inf0 = f0(pD, stD, real)
        with torch.no_grad():
            fake = netG(z, train=True)
        loss_fake, g1, inf1 = f1(pD, stD, fake)
        gD = {n: g0[n] + g1[n] for n in g0}
        stD = optD.update_scaler(stD, inf1, loss_id=1)
        _, stD, _ = optD.apply_gradients(
            gD, stD, pD, loss_id=0, grads_already_unscaled=True,
            found_inf=inf0 | inf1, scaler_found_inf=inf0)
        loss_g, gG, inf2 = f2(pG, stG, z)
        _, stG, _ = optG.apply_gradients(
            gG, stG, pG, loss_id=2, grads_already_unscaled=True,
            found_inf=inf2)
        return stG, stD, torch.stack([loss_real + loss_fake, loss_g])

    return step


def real_batches(args, rs):
    """NHWC fp32 numpy batches in [-1, 1): synthetic from ``rs``, or the
    image folder's, epochs cycled."""
    b, isize = args.batch_size, args.image_size
    if not args.data:
        while True:
            yield (rs.rand(b, isize, isize, 3) * 2 - 1).astype(np.float32)
    from apex_tpu_torch import data as apex_data

    ds = apex_data.ImageFolder(args.data)
    if len(ds) < b:
        raise ValueError(f"{len(ds)} images under {args.data} is fewer than "
                         f"batch size {b}")
    tf = apex_data.eval_transform(isize, isize)
    epoch = 0
    while True:
        for images, _ in apex_data.prefetch(ds, b, tf, shuffle=True,
                                            drop_last=True, seed=0,
                                            epoch=epoch):
            yield images * 2.0 - 1.0
        epoch += 1


def main(argv=None):
    args = parse_args(argv)
    device = default_device(args.device)
    netG, netD, optG, optD = build_models(args, device)
    stG = optG.init(dict(netG.named_parameters()))
    stD = optD.init(dict(netD.named_parameters()))
    step = build_train_step(netG, netD, optG, optD)
    rs = np.random.RandomState(0)
    reals = real_batches(args, rs)
    t0 = time.perf_counter()
    losses = None
    for i in range(args.steps):
        real = torch.from_numpy(next(reals)).to(device)
        z = torch.from_numpy(rs.randn(args.batch_size, 1, 1, args.nz).astype(
            np.float32)).to(device)
        stG, stD, losses = step(stG, stD, real, z)
        losses = losses.tolist()
        print(f"[{i}/{args.steps}] Loss_D {losses[0]:.4f} "
              f"Loss_G {losses[1]:.4f}", flush=True)
    print(f"DONE {args.steps / (time.perf_counter() - t0):.2f} it/s")
    return losses[0], losses[1]


if __name__ == "__main__":
    main()
