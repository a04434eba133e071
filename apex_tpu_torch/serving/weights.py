"""The GPT, BERT and ResNet parameter trees on the PyTorch side.

The port keeps the JAX package's GPTModel parameter tree as it is:
nested dicts with the same keys and the same ``[out, in]`` weight layout
(``apex_tpu/serving/model.py`` reads it at ``:125-144``)::

    word_embeddings                                   [vocab, h]
    embedding/position_embeddings                     [positions, h]
    transformer/layer_i/input_layernorm/{weight,bias} [h]
    transformer/layer_i/self_attention/query_key_value/{weight [3h', h], bias}
    transformer/layer_i/self_attention/dense/{weight [h, h'], bias}
    transformer/layer_i/post_attention_layernorm/{weight,bias}
    transformer/layer_i/mlp/dense_h_to_4h/{weight [f, h], bias}
    transformer/layer_i/mlp/dense_4h_to_h/{weight [h, f], bias}
    transformer/final_layernorm/{weight,bias}

with ``h' = heads * head_dim`` and ``f = ffn_size``. The BertModel tree
(``model="bert"``) has the same leaves and, besides them::

    embedding/tokentype_embeddings                    [2, h]
    lm_head/dense/{weight [h, h], bias}
    lm_head/layernorm/{weight,bias}
    lm_head/bias                                      [vocab]
    pooler/dense/{weight [h, h], bias}                (bert_binary_head)
    binary_head/{weight [2, h], bias}                 (bert_binary_head)

The JAX tree holds those three flax ``nn.Dense`` layers' weights as
``kernel [in, out]``; the converter transposes them to the port's
``weight [out, in]`` and back. Leaves are fp32
tensors (the JAX tree's ``params_dtype``); the serving functions cast to
the compute dtype themselves.

* :func:`from_jax_params` carries a tree of numpy arrays across (the
  weights of a JAX run, after ``jax.tree_util.tree_map(np.asarray, ...)``)
  and checks every shape against the config; :func:`to_numpy_tree` is its
  exact inverse.
* :func:`load_param_tree` copies such a tree (torch or numpy leaves)
  into a :class:`~apex_tpu_torch.transformer.testing.GPTModel` or
  :class:`~apex_tpu_torch.transformer.testing.BertModel`, whose
  ``state_dict`` keys are the tree paths with ``/`` → ``.``;
  :func:`param_tree` reads the model's parameters back as the tree. The
  round trip is bit-exact, so one converted tree serves the serving and
  the training slice.
* :func:`shard_param_tree` is the converter's tensor-parallel form (GPT):
  one rank's slices of a full tree, by the rule with which
  :func:`apex_tpu_torch.transformer.tensor_parallel.layers._sharded_init`
  draws a rank's parameters, so that ``load_param_tree(model,
  shard_param_tree(from_jax_params(tree, cfg), cfg, rank, tp))`` feeds
  rank ``rank`` of a ``GPTModel(cfg, tp_size=tp)``.
* :func:`load_resnet_from_jax` copies a flax ResNet's ``params`` and
  ``batch_stats`` (``apex_tpu/models/resnet.py``) into a
  :class:`~apex_tpu_torch.models.ResNet`, whose module names are flax's:
  convolution kernels HWIO → OIHW, the ``fc`` kernel ``[in, out]`` →
  ``[out, in]``, batch-norm ``weight``/``bias`` as they are, the running
  stats into the buffers, each in the parameter's dtype;
  :func:`resnet_to_jax` is its inverse (numpy trees).
* :func:`init_gpt_params` draws the same tree shapes from a
  ``torch.Generator`` — normal(0, ``init_method_std``), the two output
  projections scaled by ``1/sqrt(2 * num_layers)`` as GPTModel does,
  zero biases, unit layer-norm scales. Its numbers differ from the JAX
  init for the same seed; parity tests convert one tree instead.
"""

import math

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch._tree import flatten_tree


# the flax nn.Dense layers of the BERT tree: the port's <path>/weight [out,
# in] is JAX's <path>/kernel [in, out]
_FLAX_DENSE = ("lm_head/dense", "pooler/dense", "binary_head")
_MODELS = ("gpt", "bert")


def param_shapes(cfg, model="gpt"):
    """The nested dict of leaf shapes the config implies for ``model``,
    "gpt" (GPTModel) or "bert" (BertModel), in the port's layout."""
    if model not in _MODELS:
        raise ValueError(f"model {model!r}, want one of {_MODELS}")
    h, f = cfg.hidden_size, cfg.ffn_size
    proj = cfg.num_attention_heads * cfg.head_dim

    def ln():
        return {"weight": (h,), "bias": (h,)}

    def lin(out, inp):
        return {"weight": (out, inp), "bias": (out,)}

    layers = {
        f"layer_{i}": {
            "input_layernorm": ln(),
            "self_attention": {"query_key_value": lin(3 * proj, h),
                               "dense": lin(h, proj)},
            "post_attention_layernorm": ln(),
            "mlp": {"dense_h_to_4h": lin(f, h),
                    "dense_4h_to_h": lin(h, f)},
        }
        for i in range(cfg.num_layers)
    }
    layers["final_layernorm"] = ln()
    tree = {
        "word_embeddings": (cfg.vocab_size, h),
        "embedding": {
            "position_embeddings": (cfg.max_position_embeddings, h)},
        "transformer": layers,
    }
    if model == "bert":
        tree["embedding"]["tokentype_embeddings"] = (2, h)
        tree["lm_head"] = {"dense": lin(h, h), "layernorm": ln(),
                           "bias": (cfg.vocab_size,)}
        if cfg.bert_binary_head:
            tree["pooler"] = {"dense": lin(h, h)}
            tree["binary_head"] = lin(2, h)
    return tree


def _flax_kernel(name):
    """Whether the port's leaf ``name`` is a flax Dense kernel,
    transposed."""
    parent, _, leaf = name.rpartition("/")
    return leaf == "weight" and parent in _FLAX_DENSE


def _build(shapes, leaf, name=""):
    """A nested dict mirroring ``shapes`` with ``leaf(shape, name)`` at
    each leaf (``name`` is the slash-joined key path)."""
    if isinstance(shapes, tuple):
        return leaf(shapes, name)
    return {k: _build(v, leaf, f"{name}/{k}" if name else k)
            for k, v in shapes.items()}


def from_jax_params(tree, cfg, device=None, model="gpt"):
    """The JAX GPTModel (or, with ``model="bert"``, BertModel) tree
    (nested mappings of array-likes) as fp32 torch tensors on ``device``,
    flax Dense kernels transposed to ``weight [out, in]``; raises on a
    missing key or a shape or dtype the config does not imply.
    ``device=None`` means ``cuda``."""
    device = default_device(device)

    def convert(shape, name):
        transpose = _flax_kernel(name)
        jax_name = name[:-len("weight")] + "kernel" if transpose else name
        node = tree
        for key in jax_name.split("/"):
            if key not in node:
                raise KeyError(f"parameter tree lacks {jax_name}")
            node = node[key]
        arr = np.asarray(node)
        want = shape[::-1] if transpose else shape
        if arr.shape != want:
            raise ValueError(f"{jax_name}: shape {arr.shape} != {want} "
                             f"implied by the config")
        if arr.dtype != np.float32:
            raise ValueError(f"{jax_name}: dtype {arr.dtype}, want float32")
        return torch.from_numpy(np.array(arr.T if transpose else arr)).to(
            device)

    return _build(param_shapes(cfg, model), convert)


# the axis along which each sharded leaf is split over the tp group:
# column-parallel weights and biases and the word table along their rows,
# row-parallel weights along their columns; every other leaf (row-parallel
# biases, layer norms, position embeddings) is whole on every rank
_SHARD_AXES = (("word_embeddings", 0),
               ("query_key_value/weight", 0), ("query_key_value/bias", 0),
               ("dense_h_to_4h/weight", 0), ("dense_h_to_4h/bias", 0),
               ("self_attention/dense/weight", 1),
               ("dense_4h_to_h/weight", 1))


def shard_axis(name):
    """The axis leaf ``name`` (slash-joined) is split along at tp > 1, or
    None where every rank holds it whole."""
    for suffix, axis in _SHARD_AXES:
        if name.endswith(suffix):
            return axis
    return None


def shard_param_tree(tree, cfg, rank, tp):
    """Rank ``rank``'s slices of the full parameter tree ``tree`` (torch
    or numpy leaves, the shapes ``cfg`` implies) at tensor-parallel size
    ``tp``; whole leaves are passed through."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a tp group of {tp}")

    def shard(shape, name):
        node = tree
        for key in name.split("/"):
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(node.shape)} != {shape} "
                             f"implied by the config")
        axis = shard_axis(name)
        if axis is None or tp == 1:
            return node
        if shape[axis] % tp:
            raise ValueError(f"{name}: {shape[axis]} rows along axis {axis} "
                             f"do not split over {tp} ranks")
        chunk = shape[axis] // tp
        index = [slice(None)] * len(shape)
        index[axis] = slice(rank * chunk, (rank + 1) * chunk)
        return node[tuple(index)]

    return _build(param_shapes(cfg), shard)


def to_numpy_tree(params):
    """The inverse of :func:`from_jax_params`: the same nested dicts with
    numpy leaves, each flax Dense ``weight`` back as its ``kernel [in,
    out]``."""
    def convert(node, name):
        if isinstance(node, torch.Tensor):
            arr = node.detach().cpu().numpy()
            return np.ascontiguousarray(arr.T) if _flax_kernel(name) else arr
        out = {}
        for k, v in node.items():
            path = f"{name}/{k}" if name else k
            out["kernel" if _flax_kernel(path) else k] = convert(v, path)
        return out

    return convert(params, "")


def init_gpt_params(cfg, seed=0, device=None):
    """A fresh parameter tree drawn from ``torch.Generator(seed)`` on
    ``device`` (see the module docstring for the distributions;
    ``device=None`` means ``cuda``)."""
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    std = cfg.init_method_std
    out_std = std / math.sqrt(2.0 * cfg.num_layers)

    def init(shape, name):
        if name.endswith("layernorm/weight"):
            return torch.ones(shape, device=device)
        if name.endswith("bias"):
            return torch.zeros(shape, device=device)
        scale = out_std if name.endswith(("self_attention/dense/weight",
                                          "dense_4h_to_h/weight")) else std
        return torch.randn(shape, generator=gen, device=device) * scale

    return _build(param_shapes(cfg), init)


def load_param_tree(model, tree):
    """Copy the nested-dict parameter tree (torch or numpy leaves) into
    ``model``'s parameters in place, bit for bit; raises on a missing or
    extra key or a shape or dtype that differs."""
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter tree and model disagree: missing "
                       f"{missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            leaf = flat[name]
            src = leaf if isinstance(leaf, torch.Tensor) else \
                torch.from_numpy(np.array(leaf))
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(f"{name}: {src.dtype} {tuple(src.shape)} "
                                 f"!= the model's {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return model


def param_tree(model):
    """The model's parameters as the nested-dict tree (detached tensors
    sharing the parameters' storage)."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def _resnet_names(model):
    """(dotted name, flax path, kind) of each parameter of a ResNet."""
    out = []
    for name, p in model.named_parameters():
        *mod, leaf = name.split(".")
        kind = ("conv" if p.dim() == 4 else
                "fc" if mod == ["fc"] and leaf == "weight" else "as_is")
        flax_leaf = "kernel" if kind in ("conv", "fc") else leaf
        out.append((name, (*mod, flax_leaf), kind))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def load_resnet_from_jax(model, params, batch_stats=None):
    """Copy a flax ResNet's ``params`` (and ``batch_stats``), nested dicts
    of arrays, into ``model`` in place; every shape is checked."""
    for name, path, kind in _resnet_names(model):
        a = torch.from_numpy(np.array(_at(params, path), dtype=np.float32))
        if kind == "conv":
            a = a.permute(3, 2, 0, 1)
        elif kind == "fc":
            a = a.t()
        p = model.get_parameter(name)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX {tuple(a.shape)} vs port "
                             f"{tuple(p.shape)}")
        p.copy_(a.to(p.dtype))
    if batch_stats is not None:
        for name, buf in model.named_buffers():
            *mod, leaf = name.split(".")
            a = np.array(_at(batch_stats, (*mod, leaf)), dtype=np.float32)
            if tuple(a.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: JAX {a.shape} vs port "
                                 f"{tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(a))
    return model


def resnet_to_jax(model):
    """``(params, batch_stats)`` of a ResNet as flax's nested dicts of fp32
    numpy arrays (the inverse of :func:`load_resnet_from_jax`)."""
    params, stats = {}, {}
    for name, path, kind in _resnet_names(model):
        t = model.get_parameter(name).detach().float().cpu()
        if kind == "conv":
            t = t.permute(2, 3, 1, 0)
        elif kind == "fc":
            t = t.t()
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.contiguous().numpy()
    for name, buf in model.named_buffers():
        *mod, leaf = name.split(".")
        node = stats
        for k in mod:
            node = node.setdefault(k, {})
        node[leaf] = buf.detach().float().cpu().numpy()
    return params, stats


# flax's names of a DCGAN batch norm's leaves, by the port's
_DCGAN_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean",
             "running_var": "var"}


@torch.no_grad()
def load_dcgan_from_jax(model, params, batch_stats=None):
    """Copy a flax DCGAN ``Generator``'s or ``Discriminator``'s ``params``
    (and ``batch_stats``), nested dicts of arrays, into ``model`` in place.
    A transposed convolution's kernel ``[kh, kw, in, out]`` is flipped in
    both spatial axes (flax's ``ConvTranspose`` does not flip it, PyTorch's
    does) and laid out ``[in, out, kh, kw]``; a convolution's becomes
    ``[out, in, kh, kw]``. Every shape is checked."""
    def copy(dst, a, name):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
        if name.startswith("up"):
            a = a.flip(0, 1).permute(2, 3, 0, 1)
        elif a.dim() == 4:
            a = a.permute(3, 2, 0, 1)
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX {tuple(a.shape)} vs port "
                             f"{tuple(dst.shape)}")
        dst.copy_(a.contiguous().to(dst.dtype))

    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        copy(p, params[mod][_DCGAN_BN.get(leaf, "kernel")
                            if mod.startswith("bn") else "kernel"], name)
    if batch_stats is not None:
        for name, buf in model.named_buffers():
            mod, leaf = name.split(".")
            copy(buf, batch_stats[mod][_DCGAN_BN[leaf]], name)
    return model


def dcgan_to_jax(model):
    """``(params, batch_stats)`` of a DCGAN model as flax's nested dicts of
    fp32 numpy arrays (the inverse of :func:`load_dcgan_from_jax`)."""
    params, stats = {}, {}
    for tree, items in ((params, model.named_parameters()),
                        (stats, model.named_buffers())):
        for name, t in items:
            mod, leaf = name.split(".")
            t = t.detach().float().cpu()
            if mod.startswith("up"):
                t = t.permute(2, 3, 0, 1).flip(0, 1)
            elif t.dim() == 4:
                t = t.permute(2, 3, 1, 0)
            key = _DCGAN_BN[leaf] if mod.startswith("bn") else "kernel"
            tree.setdefault(mod, {})[key] = t.contiguous().numpy()
    return params, stats
