"""Nested-dict parameter trees, the layout the JAX package's pytrees use."""


def flatten_tree(tree, prefix=""):
    """A nested-dict tree as one dict keyed by dotted paths (the
    ``state_dict`` names of its parameters)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, name))
        else:
            out[name] = v
    return out
