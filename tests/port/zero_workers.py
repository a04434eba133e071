"""Rank workers of the port's scale-out CPU tests
(``test_torch_collectives.py``, ``test_torch_distributed_optimizers.py``).

:func:`run_ranks` runs one of the ``*_case`` functions below in
``world`` processes started with the ``spawn`` method and joined into a
gloo process group through a ``file://`` store, on CPU tensors. At world 4
every rank also builds the ``(inner, outer) = (2, 2)`` pair of groups
(``collectives.hierarchical_groups``), JAX's ``Mesh(devices.reshape(2,
2), ("dp_in", "dp_out"))``; at world 2 the axis is the default group.
Each case takes ``(rank, world, payload)`` (numpy arrays made by the
parent) and returns numpy arrays, which come back through ``torch.save``
files, one list entry per rank.

This module imports only ``torch``, ``numpy`` and ``apex_tpu_torch``:
the children import it by name and never import JAX.
"""

import os
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.contrib.optimizers import (DistAdamState,
                                               DistributedFusedAdam,
                                               DistributedFusedLAMB,
                                               distributed_fused_adam,
                                               distributed_fused_lamb)
from apex_tpu_torch.parallel import (DistributedDataParallel,
                                     allreduce_gradients, collectives)

AXIS = {}    # the case's axis: "pair" at world 4


def run_ranks(case, world, payload, timeout=300.0):
    """``[case(rank, world, payload) for rank in range(world)]``, each in
    its own spawned rank of a gloo group of ``world`` ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _entry, args=(world, tmp, case.__name__, payload), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{case.__name__}: ranks still running "
                                   f"after {timeout} s")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry(rank, world, tmp, case_name, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        AXIS["pair"] = (collectives.hierarchical_groups(2, 2)
                        if world == 4 else None)
        out = globals()[case_name](rank, world, payload)
        torch.save(out, os.path.join(tmp, f"{rank}.pt"))
        # no rank tears its groups down while a peer may still be in the
        # last collective on them
        dist.barrier()
    finally:
        # the subgroups go with the default group, here, and not whenever
        # the interpreter drops the last reference to them
        AXIS.clear()
        dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return None if t is None else t.detach().float().numpy().copy()


def _axis(world):
    return AXIS["pair"] if world == 4 else None


def _knobs(compress, hier):
    return dict(compress=compress or False, hierarchical=hier)


def _entry_points(rank, world, payload, compress, hier):
    """allreduce_tree, reduce_scatter_flat and all_gather_flat, three
    calls each with the residual threaded (when compressing)."""
    axis = _axis(world)
    kw = _knobs(compress, hier)
    out = {"tree": [], "rs": [], "ag": []}
    tree_a, tree_b = payload["tree_a"], payload["tree_b"]
    first = {"a": _t(tree_a[0, rank]), "b": _t(tree_b[0, rank])}
    ef = collectives.ef_init(first, axis, **kw)
    out["ef_len"] = -1 if ef is None else ef.numel()
    for c in range(3):
        tree = {"a": _t(tree_a[c, rank]), "b": _t(tree_b[c, rank])}
        red, ef = collectives.allreduce_tree(tree, axis, mean=True,
                                             ef_state=ef, **kw)
        out["tree"].append((_np(red["a"]), _np(red["b"])))
    out["tree_ef"] = _np(ef)
    xs = payload["x"]
    P = xs.shape[-1]
    g_len = P // 2 if hier else P
    res = torch.zeros(g_len) if compress else None
    for c in range(3):
        y, res = collectives.reduce_scatter_flat(_t(xs[c, rank]), axis,
                                                 residual=res, **kw)
        out["rs"].append(_np(y))
    out["rs_res"] = _np(res)
    m = P // world
    res = torch.zeros(m) if compress else None
    for c in range(3):
        full, res = collectives.all_gather_flat(_t(xs[c, rank][:m]), axis,
                                                residual=res, **kw)
        out["ag"].append(_np(full))
    out["ag_res"] = _np(res)
    return out


def collectives_case(rank, world, payload):
    """The entry points under every configuration the world admits; at
    world 2 the error-feedback descent of JAX's
    ``test_error_feedback_converges_where_plain_int8_stalls``; at world 4
    DDP's hierarchical route."""
    out = {}
    for compress, hier in payload["configs"]:
        out[(compress, hier)] = _entry_points(rank, world, payload, compress,
                                              hier)
    if world == 2:
        out["ef_gd"] = {use: _ef_descent(rank, use) for use in (True, False)}
    else:
        out["ddp"] = _ddp_hier(rank, payload)
    return out


def _ef_descent(rank, use_ef):
    """40 steps of w -= 0.05 * allreduce_mean(g) with g = w plus a
    persistent +-200 on coordinate 0 (antisymmetric over the 2 ranks)."""
    w = torch.full((128,), 0.6)
    res = torch.zeros(128) if use_ef else None
    sign = 1.0 - 2.0 * rank
    for _ in range(40):
        g = w.clone()
        g[0] += sign * 200.0
        rg, new = collectives.quantized_allreduce_flat(g, (None,), mean=True,
                                                       residual=res)
        res = new if use_ef else res
        w = w - 0.05 * rg
    return _np(w)


def _ddp_hier(rank, payload):
    """allreduce_gradients over the (2, 2) pair: hierarchical, and
    hierarchical with int8 and the residual threaded (DDP's
    init_ef_state) over three calls."""
    pair = AXIS["pair"]
    grads = [{"w": _t(g[rank])} for g in payload["ddp_grads"]]
    out = {"hier": _np(allreduce_gradients(grads[0], pair,
                                           hierarchical=True)["w"])}
    ddp = DistributedDataParallel(process_group=pair, compress="int8",
                                  hierarchical=True)
    ef = ddp.init_ef_state(grads[0])
    out["ef_len"] = ef.numel()
    steps = []
    for g in grads:
        red, ef = ddp.average_gradients(g, ef)
        steps.append(_np(red["w"]))
    out["hier_int8"] = steps
    try:
        DistributedDataParallel(hierarchical=True)
        out["single_group_raises"] = False
    except ValueError:
        out["single_group_raises"] = True
    return out


# ------------------------------------------------------------- ZeRO cases

def _regression(payload):
    X, y = _t(payload["X"]), _t(payload["y"])

    def loss_grads(params):
        ps = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = torch.mean((X @ ps["w"] + ps["b"][0] - y) ** 2)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in ps.items()}

    return loss_grads


def _trajectory(world, payload, opt, compress, hier, steps=20):
    loss_grads = _regression(payload)
    make = distributed_fused_adam if opt == "adam" else \
        distributed_fused_lamb
    kw = dict(learning_rate=0.05) if opt == "adam" else dict(
        learning_rate=0.05, weight_decay=0.01, max_grad_norm=1.0)
    tx = make(num_shards=world, axis_name=_axis(world),
              grad_compress=compress or "off", hier_allreduce=hier, **kw)
    params = {"b": torch.zeros(1), "w": torch.zeros(40)}
    state = tx.init(params)
    losses = []
    for _ in range(steps):
        loss, grads = loss_grads(params)
        tx.step(grads, state, params)
        losses.append(loss)
    return np.array(losses, np.float64)


def zero_trajectories_case(rank, world, payload):
    """JAX's ZeRO trajectory test: 20 steps of each configuration of
    ``payload["zero_configs"]`` on the regression problem (every rank the
    same batch), the per-step losses."""
    return {cfg: _trajectory(world, payload, *cfg)
            for cfg in payload["zero_configs"]}


def _tree(payload, key):
    return {k: _t(v) for k, v in payload[key].items()}


def zero_case(rank, world, payload):
    """At world 2: the trajectories, JAX's ``test_distributed_optimizers``
    cases (replicated gradients, 3 steps; rank-distinct gradients), the
    pure ``update`` against ``step``, a state loaded from JAX's through
    ``from_numpy``, the class surfaces, a skipped step, and the narrow
    BERT on DistributedFusedLAMB."""
    out = {"traj": zero_trajectories_case(rank, world, payload)}
    for opt, make, kw in (
            ("adam", distributed_fused_adam,
             dict(learning_rate=0.1, weight_decay=0.01)),
            ("lamb", distributed_fused_lamb,
             dict(learning_rate=0.01, weight_decay=0.01,
                  max_grad_norm=1.0))):
        tx = make(num_shards=world, **kw)
        params, grads = _tree(payload, "params"), _tree(payload, "grads")
        state = tx.init(params)
        for _ in range(3):
            tx.step(grads, state, params)
        out[opt] = {n: _np(p) for n, p in params.items()}
        out[opt + "_shard_len"] = state.m.numel()
        # the pure update from a fresh state equals one step
        params = _tree(payload, "params")
        state = tx.init(params)
        updates, new_state = tx.update(grads, state, params)
        assert int(state.count) == 0 and int(new_state.count) == 1
        tx.step(grads, state, params)
        fresh = _tree(payload, "params")
        out[opt + "_update_vs_step"] = max(
            float((fresh[n] + updates[n] - params[n]).abs().max())
            for n in params)
    # rank r's gradient (r + 1) * ones: the mean is 1.5
    tx = distributed_fused_adam(learning_rate=0.1, num_shards=world)
    params = {"w": torch.zeros(16)}
    state = tx.init(params)
    tx.step({"w": torch.full((16,), float(rank + 1))}, state, params)
    out["distinct"] = _np(params["w"])
    out["from_numpy"] = _from_numpy(rank, world, payload)
    out["classes"] = _classes(rank, world, payload)
    out["skip"] = _skip(rank, world, payload)
    out["bert"] = _bert(rank, world, payload)
    return out


def _from_numpy(rank, world, payload):
    """JAX's state after step 1 (this rank's shards) loaded through
    ``from_numpy``, then step 2 in the port."""
    js = payload["jax_state1"][rank]
    tx = distributed_fused_adam(learning_rate=0.1, weight_decay=0.01,
                                num_shards=world)
    state = DistAdamState.from_numpy(js["count"], js["m"], js["v"],
                                     js["master"], device="cpu")
    params = _tree(payload, "jax_params1")
    tx.step(_tree(payload, "grads"), state, params)
    return {n: _np(p) for n, p in params.items()}


def _classes(rank, world, payload):
    """The class surfaces: DistributedFusedAdam (L2 decay) against its
    transform, DistributedFusedLAMB reading ``p.grad``; amsgrad refused."""
    params = _tree(payload, "params")
    opt = DistributedFusedAdam(params, lr=0.1, weight_decay=0.01,
                               num_shards=world, dwu_num_blocks=8)
    assert opt.init_params() is None
    opt.step(_tree(payload, "grads"))
    ref = _tree(payload, "params")
    tx = distributed_fused_adam(learning_rate=0.1, weight_decay=0.01,
                                adam_w_mode=False, num_shards=world)
    tx.step(_tree(payload, "grads"), tx.init(ref), ref)
    same = all(torch.equal(opt.params[n], ref[n]) for n in ref)
    leaves = [p.requires_grad_() for p in _tree(payload, "params").values()]
    lamb = DistributedFusedLAMB(leaves, lr=0.01, num_shards=world)
    for p, g in zip(leaves, _tree(payload, "grads").values()):
        p.grad = g
    lamb.step()
    try:
        DistributedFusedAdam(_tree(payload, "params"), amsgrad=True,
                             num_shards=world)
        refused = False
    except AssertionError:
        refused = True
    return {"adam_class_equals_transform": same, "amsgrad_refused": refused,
            "lamb": [_np(p) for p in leaves]}


def _skip(rank, world, payload):
    """A step with the found-inf flag set, codec on: the collectives run,
    nothing is written (parameters, master, m, v, count, residuals)."""
    out = {}
    for make in (distributed_fused_adam, distributed_fused_lamb):
        tx = make(learning_rate=0.01, num_shards=world, grad_compress="int8")
        params, grads = _tree(payload, "params"), _tree(payload, "grads")
        state = tx.init(params)
        tx.step(grads, state, params)
        before = [t.clone() for t in (state.count, state.m, state.v,
                                      state.master, state.g_residual,
                                      state.u_residual)]
        pbefore = {n: p.clone() for n, p in params.items()}
        tx.step(grads, state, params, found_inf=torch.tensor(True))
        after = (state.count, state.m, state.v, state.master,
                 state.g_residual, state.u_residual)
        out[make.__name__] = all(torch.equal(a, b) for a, b in
                                 zip(before, after)) and all(
            torch.equal(pbefore[n], params[n]) for n in params)
    return out


def _bert(rank, world, payload):
    """The narrow BERT (``payload["bert_kw"]``) trained by
    ``make_one_step`` on DistributedFusedLAMB at world 2, each rank on its
    half of the batch, fp32, three steps: the losses and the parameters."""
    from apex_tpu_torch.serving import weights as tweights
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.testing import BertModel
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**payload["bert_kw"])
    model = BertModel(cfg, device="cpu", seed=3)
    tweights.load_param_tree(model, tweights.from_jax_params(
        payload["bert_tree"], cfg, "cpu", model="bert"))
    tx = distributed_fused_lamb(learning_rate=1e-2, eps=payload["bert_eps"],
                                num_shards=world)
    scaler = GradScaler(group=dist.group.WORLD)
    step = make_one_step(model, scaler, tx)
    params = dict(model.named_parameters())
    state, ss = tx.init(params), scaler.init("cpu")
    b = payload["bert_ids"].shape[0] // world
    ids, mask, labels = (_t(payload[k][rank * b:(rank + 1) * b]).long()
                         for k in ("bert_ids", "bert_mask", "bert_labels"))
    losses = []
    calls = []
    real = dist.reduce_scatter_tensor
    with mock.patch.object(dist, "reduce_scatter_tensor",
                           lambda *a, **k: (calls.append(1), real(*a, **k))[1]):
        for _ in range(3):
            state, ss, loss = step(state, ss, ids, mask, labels)
            losses.append(loss.item())
    return {"losses": losses, "reduce_scatters": len(calls),
            "params": {n: _np(p) for n, p in model.named_parameters()}}
