"""Rank workers of the port's data-parallel CPU tests
(``test_torch_ddp.py``).

:func:`run_ranks` runs :func:`ddp_case` in ``world`` processes started
with the ``spawn`` method and joined into a gloo process group through a
``file://`` store, on CPU tensors; the case takes ``(rank, world,
payload)`` (numpy arrays made by the parent) and returns numpy arrays,
which come back through ``torch.save`` files, one list entry per rank.
This module imports only ``torch`` and ``apex_tpu_torch``:
the children import it by name and never import JAX.
"""

import os
import tempfile
import time
from unittest import mock

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import (DistributedDataParallel,
                                     allreduce_gradients, broadcast_params,
                                     sync_batch_norm)
from apex_tpu_torch.parallel.distributed import allreduce_max


def run_ranks(world, payload, timeout=240.0):
    """``[ddp_case(rank, world, payload) for rank in range(world)]``, each
    in its own spawned rank of a gloo group of ``world`` ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_entry, args=(world, tmp, payload),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ddp ranks still running after "
                                   f"{timeout} s")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry(rank, world, tmp, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        torch.save(ddp_case(rank, world, payload),
                   os.path.join(tmp, f"{rank}.pt"))
        # no rank tears the group down while a peer may still be in the
        # last collective on it
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().float().numpy().copy()


def _reduce_modes(rank, payload):
    """allreduce_gradients in its four modes on this rank's gradients."""
    g32 = {"w": torch.from_numpy(payload["grads"][rank])}
    g16 = {"w": torch.from_numpy(payload["grads"][rank]).to(torch.bfloat16)}
    ddp = DistributedDataParallel(allreduce_always_fp32=True,
                                  gradient_predivide_factor=2.0)
    out = {"mean": allreduce_gradients(g32)["w"],
           "sum": allreduce_gradients(g32, gradient_average=False)["w"],
           "predivide": allreduce_gradients(
               g32, gradient_predivide_factor=4.0)["w"],
           "fp32_bf16": ddp.average_gradients(g16)["w"]}
    assert out["fp32_bf16"].dtype == torch.bfloat16
    return {k: _np(v) for k, v in out.items()}


def _syncbn(rank, payload):
    """Synced batch norm on this rank's half of the batch: y, the input
    gradient, the scale and bias gradients, the running stats."""
    x = torch.from_numpy(payload["bn_x"][rank]).requires_grad_()
    w = torch.from_numpy(payload["bn_w"]).requires_grad_()
    b = torch.from_numpy(payload["bn_b"]).requires_grad_()
    rm, rv = torch.zeros(w.shape[0]), torch.ones(w.shape[0])
    y, _, _ = sync_batch_norm(x, w, b, dist.group.WORLD, running_mean=rm,
                              running_var=rv, channel_axis=1,
                              fuse_relu=payload["bn_relu"])
    (y * torch.from_numpy(payload["bn_cot"][rank])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "dw": _np(w.grad),
            "db": _np(b.grad), "rm": _np(rm), "rv": _np(rv)}


def _amp_o2(rank, payload):
    """The port of ``test_amp_o2_master_params_identical_across_ranks``:
    three O2 steps of SGD on rank-different data, the gradients averaged
    over the group; the bf16 model and fp32 master after each step."""
    params = {"w": torch.from_numpy(payload["w"].copy())}
    params, opt = amp.initialize(params, fused_sgd(learning_rate=0.1),
                                 opt_level="O2", verbosity=0)
    params = {k: v.requires_grad_() for k, v in params.items()}
    broadcast_params(params)
    state = opt.init(params)
    x = torch.from_numpy(payload["xs"][rank])

    def loss_fn(p):
        return (((x.to(p["w"].dtype) @ p["w"]).float()) ** 2).sum()

    f = amp.value_and_scaled_grad(loss_fn, opt)
    out = []
    for _ in range(3):
        _, grads, found_inf = f(params, state)
        grads = allreduce_gradients(grads)
        found_inf = allreduce_max(found_inf)
        params, state, _ = opt.apply_gradients(
            grads, state, params, grads_already_unscaled=True,
            found_inf=found_inf)
        out.append((params["w"].detach().clone(),
                    state.master_params["w"].clone()))
    return {"model": [m.view(torch.int16).numpy() for m, _ in out],
            "master": [m.numpy() for _, m in out],
            "model_f32": _np(out[-1][0])}


def _scale_out(rank, payload):
    """The compress route with the residual threaded over three calls
    (``allreduce_gradients`` and ``DistributedDataParallel`` with
    ``init_ef_state``), the collective calls with both knobs off, and the
    requests that raise."""
    grads = [{"w": torch.from_numpy(g[rank]),
              "b": torch.from_numpy(g[rank][0]).to(torch.bfloat16)}
             for g in payload["ef_grads"]]
    ef = torch.zeros(sum(t.numel() for t in grads[0].values()))
    fn_out = []
    for g in grads:
        red, ef = allreduce_gradients(g, compress="int8", ef_state=ef)
        fn_out.append({k: _np(v) for k, v in red.items()})
    ddp = DistributedDataParallel(compress="int8",
                                  gradient_predivide_factor=2.0)
    ef2 = ddp.init_ef_state(grads[0])
    ddp_out = []
    for g in grads:
        red, ef2 = ddp.average_gradients(g, ef2)
        ddp_out.append({k: _np(v) for k, v in red.items()})
    calls = []
    real = dist.all_reduce
    with mock.patch.object(dist, "all_reduce",
                           lambda t, *a, **k: (calls.append(
                               (t.dtype, t.numel())), real(t, *a, **k))[1]):
        off = allreduce_gradients(grads[0])
        ddp_off = DistributedDataParallel().average_gradients(grads[0])
    raises = []
    for make in (lambda: DistributedDataParallel(compress="fp4"),
                 lambda: allreduce_gradients(grads[0], hierarchical=True),
                 lambda: allreduce_gradients(grads[0], compress="fp4")):
        try:
            make()
            raises.append(False)
        except ValueError:
            raises.append(True)
    return {"fn": fn_out, "fn_ef": _np(ef), "ddp": ddp_out,
            "ddp_ef_len": ef2.numel(), "off_calls": calls,
            "off": {k: _np(v) for k, v in off.items()},
            "ddp_off": {k: _np(v) for k, v in ddp_off.items()},
            "raises": raises}


def ddp_case(rank, world, payload):
    return {"reduce": _reduce_modes(rank, payload),
            "scale_out": _scale_out(rank, payload),
            "syncbn": _syncbn(rank, payload),
            "amp_o2": _amp_o2(rank, payload),
            "max": allreduce_max(torch.tensor(rank == 1)).item()}
