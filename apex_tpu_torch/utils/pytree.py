"""Parameter-tree helpers: walking nested containers of tensors, and the
casts amp applies to a model.

Counterpart of a subset of ``apex_tpu/utils/pytree.py`` (``cast_tree``,
``convert_network``, ``cast_inputs``, ``is_norm_path``,
``master_params_from``, ``master_to_model``, ``tree_cast_like``), plus
the few tree operations the JAX package takes from ``jax.tree_util``.
A tree is a tensor (a leaf), ``None`` (no leaf), or a dict, list, tuple
or named tuple of trees.  Leaves are visited in JAX's
order: dict keys sorted, sequences and named-tuple fields in order, so a
flat buffer packed from a tree has the JAX package's layout.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves",
           "tree_flatten_with_keystr",
           "tree_leaves_with_path", "tree_map", "tree_map_with_path",
           "path_str", "is_norm_path",
           "cast_tree", "convert_network", "cast_inputs",
           "master_params_from", "master_to_model", "tree_cast_like",
           "is_float"]

# Path segments that name normalization parameters, kept fp32 when
# keep_batchnorm_fp32 is set: the JAX package's pattern, copied.  The
# transformer's `ln_g` / `ln1_b` leaves do not match it, so amp O5 casts
# them to bf16 as the JAX package does.
_NORM_PAT = re.compile(
    r"(batch[_]?norm|batch_stats|group[_]?norm|layer[_]?norm"
    r"|(?:^|[/._])(?:bn\d*|norm)(?:[/._]|$))",
    re.IGNORECASE)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(kind, keys, children) of a container, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), [tree[k] for k in keys])
    if _is_namedtuple(tree):
        return (type(tree), tree._fields, list(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(range(len(tree))), list(tree))
    return None


# The walkers recurse through module-level functions, not nested closures:
# a closure that calls itself is a reference cycle, which would keep the
# leaves it reached (a model's gradients, say) alive until the cyclic
# garbage collector happened to run.

def _flatten_into(t, leaves: List[Any]):
    if t is None:
        return None
    node = _children(t)
    if node is None:
        leaves.append(t)
        return "*"
    kind, keys, kids = node
    return (kind, keys, tuple(_flatten_into(c, leaves) for c in kids))


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef): ``treedef`` is a hashable description of the
    structure that :func:`tree_unflatten` rebuilds from."""
    leaves: List[Any] = []
    treedef = _flatten_into(tree, leaves)
    return leaves, treedef


def _build(d, it):
    if d is None:
        return None
    if d == "*":
        return next(it)
    kind, keys, kids = d
    vals = [_build(c, it) for c in kids]
    if kind == "dict":
        return dict(zip(keys, vals))
    if kind in (list, tuple):
        return kind(vals)
    return kind(*vals)          # a named tuple


def tree_unflatten(treedef, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in leaf order; a path is the tuple of keys to it."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    _, keys, kids = node
    out = []
    for key, kid in zip(keys, kids):
        out += tree_leaves_with_path(kid, prefix + (key,))
    return out


def tree_flatten_with_keystr(tree) -> Tuple[List[Any], List[str], Any]:
    """(leaves, key strings, treedef): each leaf's path spelled as
    ``jax.tree_util.keystr`` spells it (``['key']`` for a dict key, ``[i]``
    for a list or tuple index, ``.field`` for a named tuple's field)."""
    leaves: List[Any] = []
    keys: List[str] = []
    _keystr_into(tree, "", leaves, keys)
    return leaves, keys, tree_flatten(tree)[1]


def _keystr_into(t, prefix, leaves, keys):
    if t is None:
        return
    node = _children(t)
    if node is None:
        leaves.append(t)
        keys.append(prefix)
        return
    kind, names, kids = node
    for name, kid in zip(names, kids):
        if kind == "dict":
            part = f"[{name!r}]"
        elif kind in (list, tuple):
            part = f"[{name}]"
        else:
            part = f".{name}"
        _keystr_into(kid, prefix + part, leaves, keys)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef_leaves(treedef, r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(fn: Callable, tree, *,
                       is_leaf: Optional[Callable] = None) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree`` (a path is the tuple
    of keys to the leaf), the structure kept; a node where ``is_leaf(node)``
    is True is handed to ``fn`` whole (``jax.tree_util.tree_map_with_path``
    with its ``is_leaf``).  ``fn`` may return a subtree."""
    return _map_path(fn, tree, (), is_leaf)


def _map_path(fn, t, path, is_leaf):
    if t is None:
        return None
    if is_leaf is not None and is_leaf(t):
        return fn(path, t)
    node = _children(t)
    if node is None:
        return fn(path, t)
    kind, keys, kids = node
    vals = [_map_path(fn, c, path + (k,), is_leaf)
            for k, c in zip(keys, kids)]
    if kind == "dict":
        return dict(zip(keys, vals))
    if kind in (list, tuple):
        return kind(vals)
    return kind(*vals)          # a named tuple


def treedef_leaves(treedef, tree) -> List[Any]:
    """The leaves of ``tree``, which must have the structure ``treedef``."""
    leaves, other = tree_flatten(tree)
    if other != treedef:
        raise ValueError("tree structures differ")
    return leaves


def path_str(path) -> str:
    """'/'-joined key path."""
    return "/".join(str(p) for p in path)


def is_norm_path(path) -> bool:
    return bool(_NORM_PAT.search(path_str(path)))


def is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_tree(tree, dtype, *, predicate: Optional[Callable] = None):
    """Cast all floating leaves to ``dtype``; integer leaves pass through.
    ``predicate(path, leaf)`` True keeps that leaf fp32."""
    if dtype is None:
        return tree
    leaves, treedef = tree_flatten(tree)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    out = []
    for path, x in zip(paths, leaves):
        if not is_float(x):
            out.append(x)
        elif predicate is not None and predicate(path, x):
            out.append(x.to(torch.float32))
        else:
            out.append(x.to(dtype))
    return tree_unflatten(treedef, out)


def convert_network(params, dtype, keep_batchnorm_fp32: bool = True):
    """Whole-model cast that keeps normalization parameters (by path) fp32
    when ``keep_batchnorm_fp32``."""
    pred = (lambda path, x: is_norm_path(path)) if keep_batchnorm_fp32 \
        else None
    return cast_tree(params, dtype, predicate=pred)


def cast_inputs(args, kwargs, dtype):
    """The input cast of amp's model forward: floating tensors among the
    leaves of (args, kwargs) in ``dtype`` (None: unchanged); integer
    tensors, Python scalars and other leaves pass through."""
    if dtype is None:
        return args, kwargs

    def caster(x):
        return x.to(dtype) if is_float(x) else x
    return tree_map(caster, args), tree_map(caster, kwargs)


def master_params_from(params):
    """fp32 master copies of the floating leaves."""
    return tree_map(lambda p: p.to(torch.float32, copy=True)
                    if is_float(p) else p, params)


def master_to_model(master, model_like):
    """fp32 masters -> copies in the model leaves' dtypes."""
    return tree_map(lambda m, p: m.to(p.dtype) if is_float(p) else m,
                    master, model_like)


def tree_cast_like(src, like):
    """Each leaf of ``src`` in the dtype of the matching leaf of ``like``
    where that leaf is floating; other leaves of ``src`` unchanged."""
    return tree_map(lambda s, l: s.to(l.dtype) if is_float(l) else s,
                    src, like)
