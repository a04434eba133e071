"""The GPT parameter tree on the PyTorch side.

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

with ``h' = heads * head_dim`` and ``f = ffn_size``. Leaves are fp32
tensors (the JAX tree's ``params_dtype``); the serving functions cast to
the compute dtype themselves.

* :func:`from_jax_params` carries a tree of numpy arrays across (the
  weights of a JAX run, after ``jax.tree_util.tree_map(np.asarray, ...)``)
  and checks every shape against the config; :func:`to_numpy_tree` is its
  exact inverse.
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


def param_shapes(cfg):
    """The nested dict of leaf shapes the config implies."""
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
    return {
        "word_embeddings": (cfg.vocab_size, h),
        "embedding": {
            "position_embeddings": (cfg.max_position_embeddings, h)},
        "transformer": layers,
    }


def _build(shapes, leaf, name=""):
    """A nested dict mirroring ``shapes`` with ``leaf(shape, name)`` at
    each leaf (``name`` is the slash-joined key path)."""
    if isinstance(shapes, tuple):
        return leaf(shapes, name)
    return {k: _build(v, leaf, f"{name}/{k}" if name else k)
            for k, v in shapes.items()}


def from_jax_params(tree, cfg, device=None):
    """The JAX GPTModel tree (nested mappings of array-likes) as fp32
    torch tensors on ``device``; raises on a missing key or a shape or
    dtype the config does not imply. ``device=None`` means ``cuda``."""
    device = default_device(device)

    def convert(shape, name):
        node = tree
        for key in name.split("/"):
            if key not in node:
                raise KeyError(f"parameter tree lacks {name}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape} "
                             f"implied by the config")
        if arr.dtype != np.float32:
            raise ValueError(f"{name}: dtype {arr.dtype}, want float32")
        return torch.from_numpy(np.array(arr)).to(device)

    return _build(param_shapes(cfg), convert)


def to_numpy_tree(params):
    """The inverse of :func:`from_jax_params`: the same nested dicts with
    numpy leaves."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return {k: to_numpy_tree(v) for k, v in params.items()}


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
