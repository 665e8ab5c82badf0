"""Nested dicts and lists of tensors, walked in ``jax.tree.flatten``'s
order: dict keys sorted, lists and tuples in order. Params, gradients,
batches and optimizer states are such trees in the port, as pytrees are
in the JAX package.
"""


def tree_flatten_with_path(tree, prefix=""):
    """``[(path, leaf)]`` in ``jax.tree.flatten`` order. ``path`` is
    written as ``jax.tree_util.keystr`` writes it (``['layers'][0]['wo']``)."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in
                tree_flatten_with_path(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree) for item in
                tree_flatten_with_path(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree):
    """The leaves of ``tree`` in ``jax.tree.flatten`` order; build the
    optimizer over these."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` whose leaves, in ``tree_leaves`` order,
    are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)
