"""Declarative partition rules — regex name-pattern -> PartitionSpec (port of
``mmlspark_tpu/parallel/partition.py``).

A model family declares ONE ordered rule table — ``(regex,
PartitionSpec-or-callable)`` pairs matched against each leaf's ``/``-joined
tree path — and placement becomes data.  A checkpoint restored onto a
*different* mesh re-places every leaf through :func:`replace_on_mesh`, so
growing or shrinking the world is a rule lookup, not bespoke re-sharding
code.

Trees are nests of dicts, lists, tuples, named tuples and dataclasses
whose leaves are tensors, arrays or scalars; ``None`` is an empty subtree.
Path names are the reference's letter for letter for the same nest: dict
keys (sorted, as ``jax.tree_util`` flattens them), sequence indices, and
named-tuple / dataclass field names each render as one segment
(``params/Dense_0/kernel``, ``opt_state/0/mu/...``).

Rule semantics (first match wins):

- scalars (0-d or single-element leaves) are never partitioned: ``P()``
  before any rule is consulted;
- a rule value may be a ``PartitionSpec`` or a callable ``(name, leaf) ->
  PartitionSpec`` for shape-dependent policies (the trainer's "shard big
  kernels over ``model``" rule);
- no match raises: silent replication of a tensor the table meant to
  shard is exactly the placement bug declarative rules exist to prevent.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np

from .sharding import NamedSharding, PartitionSpec

__all__ = ["tree_path_names", "match_partition_rules", "replace_on_mesh"]

RuleValue = Union[Any, Callable[[str, Any], Any]]
Rules = Sequence[Tuple[str, RuleValue]]


def _children(node):
    """``[(segment, child), ...]`` of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, PartitionSpec):
        return None
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, _path=()):
    """The same nest with each leaf replaced by ``fn(name, leaf)``, ``name``
    its ``/``-joined path."""
    kids = _children(tree)
    if kids is None:
        return fn("/".join(str(p) for p in _path), tree)
    if tree is None:
        return None
    mapped = {k: tree_map_with_path(fn, v, _path + (k,)) for k, v in kids}
    if isinstance(tree, dict):
        return {k: mapped[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**mapped)
    if isinstance(tree, (list, tuple)):
        return type(tree)(mapped[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **mapped)


def tree_leaves_with_path(tree, _path=()) -> List[Tuple[str, Any]]:
    """``[(name, leaf), ...]`` in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(str(p) for p in _path), tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in kids:
        out.extend(tree_leaves_with_path(v, _path + (k,)))
    return out


def tree_path_names(tree) -> Any:
    """Same-structure nest of each leaf's ``/``-joined path name."""
    return tree_map_with_path(lambda name, _leaf: name, tree)


def _is_scalar(leaf) -> bool:
    shape = tuple(getattr(leaf, "shape", ()))
    return len(shape) == 0 or int(np.prod(shape)) == 1


def match_partition_rules(rules: Rules, tree) -> Any:
    """Nest of ``PartitionSpec`` for ``tree`` under ordered ``rules``.

    Each leaf's ``/``-joined path name is ``re.search``-ed against the
    rule patterns in order; the first hit's spec applies (callable specs
    are invoked with ``(name, leaf)``).  Scalar leaves short-circuit to
    ``P()``; an unmatched non-scalar leaf raises ``ValueError`` naming the
    leaf, so a grown model surface cannot silently fall through the
    table."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(name, leaf):
        if _is_scalar(leaf):
            return PartitionSpec()
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return spec(name, leaf) if callable(spec) else spec
        raise ValueError(
            f"no partition rule matched leaf {name!r} "
            f"(shape {tuple(leaf.shape)}) — add a pattern (a final "
            "('.*', P()) catch-all makes replication explicit)")

    return tree_map_with_path(spec_for, tree)


def replace_on_mesh(tree, rules: Rules, mesh, *,
                    site: str = "parallel.replace_on_mesh",
                    specs: Any = None) -> Any:
    """Re-place every leaf of ``tree`` onto ``mesh`` under ``rules``.

    The elastic-resume primitive: leaves are the whole arrays (a restored
    checkpoint holds full tensors whatever the sharding it was taken
    under); each becomes this rank's block of it on the mesh's device
    through :meth:`NamedSharding.place`, which books the transfer in
    ``mmlspark_device_transfer_bytes_total{site}``.  A caller that already
    matched the rules passes ``specs`` so the tree is walked once."""
    if specs is None:
        specs = match_partition_rules(rules, tree)
    spec_of = dict(tree_leaves_with_path(specs))
    return tree_map_with_path(
        lambda name, leaf: NamedSharding(mesh, spec_of[name]).place(
            leaf, site=site), tree)
