"""Rank workers of the port's tensor-parallel CPU tests
(``test_torch_tensor_parallel.py``, ``test_torch_xent_sharded.py``).

:func:`run_ranks` runs one of the ``*_case`` functions below in
``world`` processes started with the ``spawn`` method, joined into a
gloo process group through a ``file://`` store and into one
tensor-parallel group (``parallel_state.initialize_model_parallel(world,
backend="gloo")``), on CPU tensors. Each case takes ``(rank, world,
payload)`` (numpy arrays made by the parent) and returns numpy arrays,
which come back to the parent through ``torch.save`` files, one list
entry per rank.

This module imports only ``torch``, ``numpy`` and ``apex_tpu_torch``:
the children import it by name and never import JAX (the test modules
and ``tests/conftest.py`` do).
"""

import os
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.ops import xent
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.serving import weights
from apex_tpu_torch.train_step import make_one_step
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.tensor_parallel import layers, mappings
from apex_tpu_torch.transformer.testing import GPTModel, TransformerConfig
from apex_tpu_torch.transformer.testing import standalone_transformer_lm


def run_ranks(case, world, payload, timeout=240.0):
    """``[case(rank, world, payload) for rank in range(world)]``, each run
    in its own spawned rank of a gloo tp group of ``world`` ranks."""
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
        parallel_state.initialize_model_parallel(world, backend="gloo")
        out = globals()[case_name](rank, world, payload)
        torch.save(out, os.path.join(tmp, f"{rank}.pt"))
        # no rank tears its groups down while a peer is still working: a
        # case whose ranks never meet after the groups are built (the
        # refusal case) otherwise closes one rank's connections under the
        # other
        dist.barrier()
    finally:
        # the tp subgroups go before the default group, here, and not
        # whenever the interpreter drops the last reference to them
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().numpy().copy()


def mappings_case(rank, world, payload):
    """The four mappings' forward on this rank's ``x`` and backward of
    this rank's cotangent for each."""
    out = {}
    for name, g in payload["g"].items():
        x = _t(payload["x"][rank], grad=True)
        y = getattr(mappings, name)(x)
        y.backward(_t(g[rank]))
        out[name] = (_np(y), _np(x.grad))
    return out


def groups_case(rank, world, payload):
    """``parallel_state`` at tp = 2 in a world of four (groups of
    consecutive ranks; a sum over this rank's group, reduced in place
    where the input is not a leaf), then at tp = world (the default group
    itself)."""
    parallel_state.initialize_model_parallel(2, backend="gloo")
    out = {"group": (parallel_state.get_tensor_model_parallel_world_size(),
                     parallel_state.get_tensor_model_parallel_rank(),
                     parallel_state.get_tensor_model_parallel_src_rank())}
    x = torch.tensor([float(rank + 1)], requires_grad=True)
    h = x * 2.0
    y = mappings.reduce_from_tensor_model_parallel_region(h)
    y.backward(torch.ones(1))
    out["sum"] = y.item()
    out["in_place"] = y.data_ptr() == h.data_ptr()
    out["grad"] = x.grad.item()
    parallel_state.initialize_model_parallel(world, backend="gloo")
    out["world_is_tp"] = (parallel_state.get_tensor_model_parallel_group()
                          is dist.group.WORLD)
    return out


def layers_case(rank, world, payload):
    """Column-, row- and vocab-parallel layers on this rank's slices of the
    full weights: outputs, input gradients and parameter gradients."""
    out = {}
    x = payload["x"]
    w_col, b_col = payload["w_col"], payload["b_col"]
    w_row, b_row = payload["w_row"], payload["b_row"]
    n_out, n_in = w_col.shape
    for gather in (True, False):
        m = layers.ColumnParallelLinear(n_in, n_out, gather_output=gather,
                                        device="cpu")
        c = n_out // world
        with torch.no_grad():
            m.weight.copy_(_t(w_col[rank * c:(rank + 1) * c]))
            m.bias.copy_(_t(b_col[rank * c:(rank + 1) * c]))
        xt = _t(x, grad=True)
        y = m(xt)
        y.backward(_t(payload[f"g_col_{gather}"][rank]))
        out[f"col_{gather}"] = (_np(y), _np(xt.grad), _np(m.weight.grad),
                                _np(m.bias.grad))
    r_out, r_in = w_row.shape
    for parallel in (True, False):
        m = layers.RowParallelLinear(r_in, r_out, input_is_parallel=parallel,
                                     device="cpu")
        c = r_in // world
        with torch.no_grad():
            m.weight.copy_(_t(w_row[:, rank * c:(rank + 1) * c]))
            m.bias.copy_(_t(b_row))
        xin = payload["x_row"]
        xt = _t(xin[..., rank * c:(rank + 1) * c] if parallel else xin,
                grad=True)
        y = m(xt)
        y.backward(_t(payload["g_row"]))
        out[f"row_{parallel}"] = (_np(y), _np(xt.grad), _np(m.weight.grad),
                                  _np(m.bias.grad))
    table = payload["table"]
    v = table.shape[0] // world
    emb = layers.VocabParallelEmbedding(table.shape[0], table.shape[1],
                                        device="cpu")
    with torch.no_grad():
        emb.weight.copy_(_t(table[rank * v:(rank + 1) * v]))
    y = emb(_t(payload["ids"]))
    y.backward(_t(payload["g_emb"]))
    out["embedding"] = (_np(y), _np(emb.weight.grad))
    return out


def xent_case(rank, world, payload):
    """``linear_cross_entropy_sharded`` on this rank's shard of E, for each
    smoothing: the loss, dX and this shard's dE."""
    out = {}
    e = payload["e"]
    vs = e.shape[0] // world
    group = parallel_state.get_tensor_model_parallel_group()
    for eps in payload["smoothing"]:
        x = _t(payload["x"], grad=True)
        es = _t(e[rank * vs:(rank + 1) * vs], grad=True)
        loss = xent.linear_cross_entropy_sharded(
            x, es, _t(payload["labels"]), group, eps)
        loss.backward(_t(payload["g"]))
        out[eps] = (_np(loss), _np(x.grad), _np(es.grad))
    return out


def _model(kw, rank, world, tree=None, seed=0):
    cfg = TransformerConfig(**kw)
    model = GPTModel(cfg, device="cpu", seed=seed, tp_size=world)
    if tree is not None:
        weights.load_param_tree(model, weights.shard_param_tree(
            weights.from_jax_params(tree, cfg, "cpu"), cfg, rank, world))
    return model


def _counted(module, attr, calls, tag):
    """Patch ``module.attr`` so that each call appends ``tag`` to
    ``calls``."""
    fn = getattr(module, attr)

    def counted(*args, **kwargs):
        calls.append(tag)
        return fn(*args, **kwargs)

    return mock.patch.object(module, attr, counted)


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()}


def gpt_case(rank, world, payload):
    """For each configuration: the per-token loss and every gradient of
    one step of this rank's ``GPTModel(tp_size=world)`` on its slices of
    the full tree; then ``steps`` training steps of ``make_one_step`` with
    the ``GradScaler`` (losses and this rank's final parameters), and a
    step whose overflow only rank 1 sees (a hook makes its word-table
    gradient infinite), after which every rank must have skipped."""
    ids, pos, labels = (_t(payload[k]).long() for k in ("ids", "pos",
                                                        "labels"))
    out = {}
    for name, kw in payload["configs"].items():
        model = _model(kw, rank, world, payload["tree"])
        calls = []
        with _counted(xent, "linear_cross_entropy_sharded", calls, "fused"), \
                _counted(standalone_transformer_lm,
                         "vocab_parallel_cross_entropy", calls,
                         "materialized"):
            per_tok = model(ids, pos, None, labels)
        per_tok.mean().backward()
        out[name] = {"per_tok": _np(per_tok), "grads": _grads(model),
                     "heads": calls}
    kw = payload["configs"][payload["train"]]
    model = _model(kw, rank, world, payload["tree"])
    scaler, opt = GradScaler(), fused_adam(payload["lr"])
    step = make_one_step(model, scaler, opt)
    state, ss = opt.init(dict(model.named_parameters())), scaler.init("cpu")
    losses = []
    for _ in range(payload["steps"]):
        state, ss, loss = step(state, ss, ids, pos, labels)
        losses.append(loss.item())
    params = {n: _np(p) for n, p in model.named_parameters()}
    hook = None
    if rank == 1:
        hook = model.word_embeddings.register_hook(lambda g: g * np.inf)
    count = state.count.item()
    state, ss2, _ = step(state, ss, ids, pos, labels)
    if hook is not None:
        hook.remove()
    skipped = all(np.array_equal(_np(p), params[n])
                  for n, p in model.named_parameters())
    out["train"] = {"losses": losses, "params": params,
                    "loss_scale": ss.loss_scale.item(),
                    "overflow": ss2.overflow.item(),
                    "scale_after_overflow": ss2.loss_scale.item(),
                    "skipped": skipped and state.count.item() == count}
    return out


def seed_case(rank, world, payload):
    """This rank's ``GPTModel(tp_size=world)`` built from ``seed`` alone:
    its parameters, and the per-token loss and every gradient of one
    step."""
    model = _model(payload["kw"], rank, world, seed=payload["seed"])
    ids, pos, labels = (_t(payload[k]).long() for k in ("ids", "pos",
                                                        "labels"))
    per_tok = model(ids, pos, None, labels)
    per_tok.mean().backward()
    return {"params": {n: _np(p) for n, p in model.named_parameters()},
            "per_tok": _np(per_tok), "grads": _grads(model)}


def refusal_case(rank, world, payload):
    """What the tp > 1 path refuses: a plain ``LossScaler`` in
    ``make_one_step`` and a model whose ``tp_size`` is not the group's."""
    model = _model(payload["kw"], rank, world)
    errors = []
    for fn in (lambda: make_one_step(model, LossScaler(), fused_adam(1e-3)),
               lambda: GPTModel(TransformerConfig(**payload["kw"]),
                                device="cpu", tp_size=1)):
        try:
            fn()
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    return errors
