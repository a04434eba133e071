"""Port parity of synced batch norm on the CPU: ``apex_tpu_torch.
parallel.sync_batch_norm`` (the plain versions of K17/K18 behind its
autograd function) against ``apex_tpu.parallel.sync_batch_norm`` on the
same seeded numpy inputs, local (no group: JAX's ``axis_name=None``):
fp32 and bf16, training and eval, both channel axes, with and without
``fuse_relu``, scale and bias; the running stats; the gradients of x,
scale and bias against ``jax.grad``. The module (running stats, eval,
``use_running_average``, no tracked stats), ``convert_syncbn_model`` over
``nn.BatchNorm2d``, and the plain stages against each other's algebra.

Tolerances: fp32 1e-5 (the same fp32 ops, the sums over the rows in
another order) and gradients 1e-4 relative to the largest magnitude (the
closed-form backward against JAX's autodiff through the sums, each in
its own order); bf16 one bf16 ulp (2^-7 relative: both compute in fp32
and round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.parallel.sync_batchnorm import \
    sync_batch_norm as jax_sync_batch_norm
from apex_tpu_torch.ops import batch_norm
from apex_tpu_torch.parallel import (SyncBatchNorm, convert_syncbn_model,
                                     create_syncbn_process_group,
                                     sync_batch_norm)

DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _inputs(shape, axis, seed, affine=True):
    rs = np.random.RandomState(seed)
    c = shape[axis]
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    w = (rs.rand(c) + 0.5).astype(np.float32) if affine else None
    b = rs.randn(c).astype(np.float32) if affine else None
    rm = (rs.randn(c) * 0.1).astype(np.float32)
    rv = (rs.rand(c) + 0.5).astype(np.float32)
    cot = rs.randn(*shape).astype(np.float32)
    return x, w, b, rm, rv, cot


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a.copy()).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape,axis", [((6, 5, 5, 8), -1), ((6, 8, 5, 5), 1),
                                        ((32, 16), -1)])
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_forward_and_running_stats_match_jax(dtype, training, shape, axis,
                                             fuse_relu):
    jdt, tdt, tol = DT[dtype]
    x, w, b, rm, rv, _ = _inputs(shape, axis, seed=len(shape) + axis)
    jy, jrm, jrv = jax_sync_batch_norm(
        _j(x, jdt), _j(w), _j(b), None, eps=1e-5, momentum=0.1,
        running_mean=_j(rm), running_var=_j(rv), training=training,
        channel_axis=axis, fuse_relu=fuse_relu)
    trm, trv = _t(rm), _t(rv)
    ty, orm, orv = sync_batch_norm(
        _t(x, tdt), _t(w), _t(b), None, eps=1e-5, momentum=0.1,
        running_mean=trm, running_var=trv, training=training,
        channel_axis=axis, fuse_relu=fuse_relu)
    assert ty.dtype == tdt and ty.shape == shape
    assert orm is trm and orv is trv
    _close(ty.float().numpy(), np.asarray(jy, np.float32), tol)
    _close(trm.numpy(), np.asarray(jrm), 1e-5)
    _close(trv.numpy(), np.asarray(jrv), 1e-5)


@pytest.mark.parametrize("shape,axis", [((6, 5, 5, 8), -1), ((6, 8, 5, 5), 1),
                                        ((32, 16), -1)])
@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_gradients_match_jax_grad(shape, axis, fuse_relu, affine, training):
    """d/dx, d/dscale, d/dbias of sum(y * cot) against ``jax.grad``."""
    x, w, b, rm, rv, cot = _inputs(shape, axis, seed=7, affine=affine)

    def jloss(x, w, b):
        y, _, _ = jax_sync_batch_norm(
            x, w, b, None, running_mean=_j(rm), running_var=_j(rv),
            training=training, channel_axis=axis, fuse_relu=fuse_relu)
        return jnp.sum(y * cot)

    argnums = (0, 1, 2) if affine else (0,)
    jg = jax.grad(jloss, argnums=argnums)(_j(x), _j(w), _j(b))
    tx = _t(x).requires_grad_()
    tw = None if w is None else _t(w).requires_grad_()
    tb = None if b is None else _t(b).requires_grad_()
    y, _, _ = sync_batch_norm(tx, tw, tb, None, running_mean=_t(rm),
                              running_var=_t(rv), training=training,
                              channel_axis=axis, fuse_relu=fuse_relu)
    (y * _t(cot)).sum().backward()
    got = (tx.grad, tw.grad, tb.grad) if affine else (tx.grad,)
    for g, want in zip(got, jg):
        _close(g.numpy(), np.asarray(want), 1e-4)


def test_bf16_gradients_of_bf16_parameters_are_bf16():
    """Under amp O2 a batch norm's scale and bias may be bf16: their
    gradients come back in bf16 (JAX's transpose of the fp32 upcast), x's
    in x's dtype, within a bf16 ulp of the fp32 result."""
    x, w, b, rm, rv, cot = _inputs((4, 6, 3, 3), 1, seed=3)
    outs = {}
    for tdt in (torch.float32, torch.bfloat16):
        tx = _t(x, tdt).requires_grad_()
        tw = _t(w, tdt).requires_grad_()
        tb = _t(b, tdt).requires_grad_()
        y, _, _ = sync_batch_norm(tx, tw, tb, None, channel_axis=1)
        (y.float() * _t(cot)).sum().backward()
        outs[tdt] = (tx.grad, tw.grad, tb.grad)
    for g16, g32 in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert g16.dtype == torch.bfloat16
        _close(g16.float().numpy(), g32.numpy(), 3e-2)


def test_module_running_stats_eval_and_untracked():
    """The port of ``test_syncbn_module_running_stats_and_eval``: one
    training call moves the running mean by momentum x the batch mean;
    ``use_running_average`` and ``eval()`` normalize with the running
    stats; without tracked stats eval uses batch statistics."""
    x = torch.from_numpy(np.random.RandomState(2).randn(16, 4)
                         .astype(np.float32))
    mod = SyncBatchNorm(4, momentum=0.5, device="cpu")
    y = mod(x)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               0.5 * x.numpy().mean(0), rtol=1e-5)
    rm, rv = mod.running_mean.clone(), mod.running_var.clone()
    y_eval = mod(x, use_running_average=True)
    assert torch.equal(mod.running_mean, rm)
    want = (x - rm) / torch.sqrt(rv + 1e-5)
    torch.testing.assert_close(y_eval, want, rtol=1e-5, atol=1e-5)
    mod.eval()
    torch.testing.assert_close(mod(x), y_eval)
    free = SyncBatchNorm(4, track_running_stats=False, device="cpu").eval()
    assert free.running_mean is None
    torch.testing.assert_close(free(x), y, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="running"):
        sync_batch_norm(x, None, None, training=False)


def test_channels_first_runs_on_a_copy_on_the_cpu():
    """A contiguous NCHW activation with channel axis 1 runs on a
    channels-last copy (the CPU; the card's module raises instead)."""
    x = torch.randn(6, 4, 5, 5)
    y, _, _ = sync_batch_norm(x, None, None, channel_axis=1)
    assert y.shape == x.shape
    assert y.mean(dim=(0, 2, 3)).abs().max() < 1e-5
    mod = SyncBatchNorm(4, channel_last=False, device="cpu")
    torch.testing.assert_close(mod(x), y)


def test_convert_syncbn_model_from_torch_batch_norm():
    """``nn.BatchNorm2d`` children become SyncBatchNorm with their
    parameters and running stats, and compute what they computed."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4))
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1].bias.normal_()
        net[1].running_mean.normal_()
    x = torch.randn(2, 3, 8, 8)
    net.eval()
    want = net(x)
    conv = convert_syncbn_model(net)
    assert isinstance(conv[1], SyncBatchNorm) and not conv[1].training
    torch.testing.assert_close(conv(x), want, rtol=1e-5, atol=1e-5)
    assert create_syncbn_process_group(1) is None
    with pytest.raises(ValueError):
        create_syncbn_process_group(0)


def test_stage_algebra_of_the_plain_versions():
    """The four plain stages compose to autograd through the forward:
    dx of the closed form against ``torch.autograd`` through
    ``fwd_stats_reference`` and ``fwd_apply_reference``."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(40, 6).astype(np.float64)).float()
    w = torch.from_numpy(rs.rand(6).astype(np.float32) + 0.5)
    b = torch.from_numpy(rs.randn(6).astype(np.float32))
    dy = torch.from_numpy(rs.randn(40, 6).astype(np.float32))
    xg = x.clone().requires_grad_()
    stats = batch_norm.fwd_stats_reference(xg)
    y, _, _ = batch_norm.fwd_apply_reference(xg, stats, w, b, None, None,
                                             1e-5, 0.1, True, True)
    (y * dy).sum().backward()
    s = batch_norm.fwd_stats_reference(x)
    _, mean, rstd = batch_norm.fwd_apply_reference(x, s, w, b, None, None,
                                                   1e-5, 0.1, True, True)
    sums = batch_norm.bwd_stats_reference(x, dy, mean, rstd, w, b, True)
    dx = batch_norm.bwd_apply_reference(x, dy, mean, rstd, w, b, sums, s,
                                        True, True)
    _close(dx.numpy(), xg.grad.numpy(), 1e-4)


# ResNet-50's batch-norm rows at b = 256 ([N H W, C]) and edges
PLAN_SHAPES = [(256 * 112 * 112, 64), (256 * 56 * 56, 256),
               (256 * 56 * 56, 128), (256 * 28 * 28, 512),
               (256 * 56 * 56, 64), (256 * 28 * 28, 256),
               (256 * 14 * 14, 1024), (256 * 28 * 28, 128),
               (256 * 14 * 14, 512), (256 * 7 * 7, 2048),
               (256 * 14 * 14, 256), (256 * 7 * 7, 512),
               (1, 16), (1000, 3), (10007, 256), (777, 100), (3, 76800)]


@pytest.mark.parametrize("resident", [132, 264, 528])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_plan_fills_the_card_once(shape, resident):
    """``batch_norm_cuda.plan`` (CPU only: no kernel runs): the grid never
    exceeds the blocks the card holds (a cooperative launch refuses
    more); the tiles cover the channels and the slabs the rows, each
    once, none empty; where the tiles do not outnumber the blocks each
    block takes one item and the items fill the card but for the rounding
    of the rows to slabs."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    rows, c = shape
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for aligned in (True, False):
            vec = bnc.vec_of(c, dtype, aligned)
            want = 16 // torch.empty((), dtype=dtype).element_size()
            assert vec == (want if aligned and c % want == 0 else 1)
            p = bnc.plan(rows, c, vec, resident)
            ty = bnc.THREADS // p.tx
            assert 1 <= p.tx <= 32 and p.tx * ty <= bnc.THREADS
            assert (p.tiles - 1) * p.tx * vec < c <= p.tiles * p.tx * vec
            assert (p.slabs - 1) * p.rows_per_slab < rows \
                <= p.slabs * p.rows_per_slab
            items = p.tiles * p.slabs
            assert p.grid == min(items, resident)
            if p.tiles <= resident:
                # as many slabs as the blocks a tile has, or rows of one
                # pass of TY, short only of the rounding of the slab
                want = min(resident // p.tiles, -(-rows // ty))
                assert items <= resident
                assert p.slabs * p.rows_per_slab > want * (
                    p.rows_per_slab - 1)


def test_one_rank_takes_the_one_launch_forms():
    """Without a group the autograd function runs each direction's two
    stages at once (``batch_norm.fwd`` and ``bwd``: one launch each on
    CUDA), which give the stages' results; a group of ranks would take
    the stages with the all-reduce between them."""
    from unittest import mock

    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(50, 8).astype(np.float32))
    dy = torch.from_numpy(rs.randn(50, 8).astype(np.float32))
    w = torch.from_numpy(rs.rand(8).astype(np.float32) + 0.5)
    b = torch.from_numpy(rs.randn(8).astype(np.float32))
    rm, rv = torch.zeros(8), torch.ones(8)
    rm2, rv2 = rm.clone(), rv.clone()
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    with mock.patch.object(batch_norm, "fwd", wraps=batch_norm.fwd) as f, \
            mock.patch.object(batch_norm, "bwd", wraps=batch_norm.bwd) as g, \
            mock.patch.object(batch_norm, "fwd_stats") as s1, \
            mock.patch.object(batch_norm, "bwd_stats") as s2:
        y = batch_norm.batch_norm_rows(xg, wg, bg, rm, rv, fuse_relu=True)
        y.backward(dy)
    assert (f.call_count, g.call_count, s1.call_count, s2.call_count) == \
        (1, 1, 0, 0)
    stats = batch_norm.fwd_stats_reference(x)
    ry, mean, rstd = batch_norm.fwd_apply_reference(x, stats, w, b, rm2, rv2,
                                                    1e-5, 0.1, True, True)
    sums = batch_norm.bwd_stats_reference(x, dy, mean, rstd, w, b, True)
    rdx = batch_norm.bwd_apply_reference(x, dy, mean, rstd, w, b, sums,
                                         stats, True, True)
    for got, want in ((y, ry), (rm, rm2), (rv, rv2), (xg.grad, rdx),
                      (wg.grad, sums[8:]), (bg.grad, sums[:8])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
