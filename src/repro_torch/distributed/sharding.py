"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Model code never names mesh axes directly.  It tags tensors and params
with *logical* axis names ("batch", "heads", "embed", ...), and a rules
table maps logical names to mesh axes.  Swapping a rules table re-shards
the entire model.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the mesh axes (``launch.mesh.make_host_mesh``,
``make_production_mesh``).  :func:`logical_spec` resolves a logical tuple
to the entries of the JAX ``PartitionSpec``, as a tuple (``None``, one
axis name, or a tuple of names per tensor dimension);
:func:`make_param_shardings` turns those into DTensor placements, one per
mesh dimension (``Shard(d)`` where tensor dimension ``d`` names the mesh
dimension, else ``Replicate()``).  :func:`constrain` is the identity
outside an :func:`active_mesh` and for plain tensors; a ``DTensor`` is
redistributed to the resolved placements.  ``mesh=None`` resolves
against the active mesh (PyTorch has no abstract mesh), else against no
axes at all.

:func:`local_region` is the port's ``shard_map`` for a piece of model
code that DTensor's per-op rules cannot carry (attention's online
softmax, the in-place cache writes): called with DTensors under an
active mesh it runs the function on each rank's shards
(``local_map``), redistributing its inputs to the placements the logical
names give; with plain tensors it is the plain call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.tree import is_axes

AxisName = Optional[Union[str, Tuple[str, ...]]]
AxisRules = Dict[str, AxisName]
Spec = Tuple[AxisName, ...]

# The baseline rules table.  "batch" resolves to every data-parallel axis
# present on the mesh; tensor-parallel dimensions resolve to "model".
DEFAULT_RULES: AxisRules = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,          # activations' hidden dim stays replicated
    "act_heads": "model",
    "act_kv_heads": None,       # kv heads often < model size; replicate
    "act_ff": "model",
    "experts_act": "model",     # (E, C, D) expert buffers: E over model
    "vocab_act": "model",       # logits (B, S, V): V over model
    "kv_seq": None,
    # params — transformer
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",              # MLP hidden (column parallel in, row out)
    "experts": "model",         # expert parallelism
    "expert_ff": None,
    "lora": None,               # MLA latent dims stay replicated
    # gnn
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "feat": None,
    "hidden": "model",
    # recsys
    "table_rows": "model",      # huge embedding tables: row sharded
    "table_dim": None,
    "candidates": ("pod", "data"),
    "fields": None,
    # mining
    "tid_blocks": ("pod", "data"),
    "pairs": "model",
    # optimizer state (ZeRO): shard the largest param axis over data
    "zero": ("data",),
}

# Multi-pod override example: keep TP within a pod, push batch across pods.
MULTI_POD_RULES: AxisRules = dict(DEFAULT_RULES)

_STATE = threading.local()


def current_rules() -> AxisRules:
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    """Temporarily install a rules table (per-arch overrides).

    ``rules`` entries update a copy of the current table, so callers only
    specify the names they want to change."""
    prev = current_rules()
    merged = dict(prev)
    merged.update(rules)
    _STATE.rules = merged
    try:
        yield merged
    finally:
        _STATE.rules = prev


def _mesh_axes(mesh: Optional[DeviceMesh]) -> Tuple[str, ...]:
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None or mesh.mesh_dim_names is None:
        return ()
    return tuple(mesh.mesh_dim_names)


def logical_spec(logical: Sequence[Optional[str]],
                 mesh: Optional[DeviceMesh] = None,
                 rules: Optional[AxisRules] = None) -> Spec:
    """Map a tuple of logical axis names to the JAX ``PartitionSpec``
    entries for ``mesh``, as a tuple.

    Logical names missing from the rules table resolve to None
    (replicated).  Mesh axes that do not exist on the mesh are silently
    dropped (e.g. "pod" on the single-pod mesh), and a mesh axis may be
    used by at most one tensor dimension (first wins)."""
    rules = rules or current_rules()
    avail = set(_mesh_axes(mesh))
    used: set = set()
    out = []
    for name in logical:
        axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = tuple(a for a in axes if a in avail and a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` where tensor dimension ``d`` names it, else
    ``Replicate()``.  A dimension sharded over several mesh axes must
    name them in the mesh's order (DTensor shards it outer axis first)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is sharded over {axes}, not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]],
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Redistribute a ``DTensor`` by logical names; the identity for a
    plain tensor or without a mesh (one card)."""
    if mesh is None:
        mesh = _current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(logical_spec(logical, mesh),
                                           mesh))


def axis_size(logical_name: str, mesh: Optional[DeviceMesh] = None) -> int:
    """The number of shards the rules give ``logical_name`` on ``mesh``
    (the active mesh by default); 1 without a mesh."""
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None:
        return 1
    entry = logical_spec((logical_name,), mesh)[0]
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return int(np.prod([sizes[a] for a in axes]))


def axis_start(logical_name: str, n: int,
               mesh: Optional[DeviceMesh] = None) -> int:
    """The first index of this rank's shard of a dimension of ``n``
    sharded by ``logical_name`` (:func:`shard_start` of its placements);
    0 without a mesh."""
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None:
        return 0
    return shard_start((n,), placements(logical_spec((logical_name,), mesh),
                                        mesh), mesh)


def local_index(ids: torch.Tensor, first: int,
                n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids`` as indices into a shard of ``n`` entries that starts at
    ``first``: the shifted ids, clamped into the shard, and where the
    shard holds them."""
    loc = ids - first
    held = (loc >= 0) & (loc < n)
    return loc.clamp(0, max(n - 1, 0)), held


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh :func:`active_mesh` installed (``None``: one card)."""
    return _current_mesh()


def local_shape(shape: Sequence[int], pls: Sequence[Placement],
                mesh: DeviceMesh) -> Tuple[int, ...]:
    """The shape of the first rank's shard (the largest, as
    ``torch.chunk`` cuts) of a tensor of ``shape`` placed by ``pls``."""
    out = list(shape)
    for md, p in enumerate(pls):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(md))
    return tuple(out)


def dtensor_of(local: torch.Tensor, shape: Sequence[int],
               pls: Sequence[Placement], mesh: DeviceMesh) -> DTensor:
    """A ``DTensor`` of global ``shape`` whose shard on this rank is
    ``local`` (no communication: every rank makes its own)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= int(d)
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def make_like(make, logical_tree, ref):
    """``make(device)``'s dict of tensors, on ``ref``'s device; when
    ``ref`` is a ``DTensor`` under an active mesh (a traced step's own
    buffers) each tensor is instead a ``DTensor`` placed by
    ``logical_tree``, every rank making only its shard (uninitialised):
    ``make`` then runs on the meta device, so the whole never
    exists."""
    mesh = _current_mesh()
    if mesh is None or not isinstance(ref, DTensor):
        return make(ref.device)
    dev = ref._local_tensor.device

    def one(x, names):
        pls = placements(logical_spec(names, mesh), mesh)
        local = torch.empty(local_shape(x.shape, pls, mesh), dtype=x.dtype,
                            device=dev)
        return dtensor_of(local, x.shape, pls, mesh)
    return {k: one(v, logical_tree[k])
            for k, v in make(torch.device("meta")).items()}


def shard_start(shape: Sequence[int], pls: Sequence[Placement],
                mesh: DeviceMesh, dim: int = 0) -> int:
    """The first index along ``dim`` of this rank's shard of a tensor of
    ``shape`` placed by ``pls`` (``torch.chunk`` cuts, the outer mesh
    dimension first, as DTensor shards)."""
    lo, n = 0, int(shape[dim])
    for md, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            step = -(-n // mesh.size(md))
            start = min(mesh.get_local_rank(md) * step, n)
            lo, n = lo + start, min(step, n - start)
    return lo


def grad_placements(in_pls, out_pls):
    """The placements of the inputs' gradients for a function run per
    rank (``local_map``'s ``in_grad_placements``): along a mesh
    dimension where some output is sharded or partial, the ranks use a
    replicated input on different data, so each rank's gradient of it is
    a partial sum; elsewhere a gradient is placed as its input."""
    varies = [any(o is not None and not o[m].is_replicate()
                  for o in out_pls) for m in range(len(
                      next(p for p in in_pls if p is not None)))]
    return tuple(None if p is None else tuple(
        Partial() if v and q.is_replicate() else q
        for q, v in zip(p, varies, strict=True)) for p in in_pls)


def local_region(fn, in_logical, out_logical, partial=None, reduce="sum"):
    """``fn`` run on each rank's shards when any argument is a
    ``DTensor`` and a mesh is active: the inputs are redistributed to
    ``in_logical`` (one logical tuple per positional argument, ``None``
    for a non-tensor) and the outputs wrapped as ``out_logical`` (a
    logical tuple, or a tuple of them for several outputs).  On the mesh
    axes of the logical names ``partial`` gives (a name or a tuple of
    names; with several outputs, one entry per output) the outputs are
    partial results, each rank's ``fn`` reducing its shard of those axes,
    and ``reduce`` ("sum" or "max") combines them.  Under autograd the
    inputs' gradients are placed by :func:`grad_placements`.  Otherwise
    ``fn`` itself."""
    def run(*args):
        mesh = _current_mesh()
        if mesh is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        several = bool(out_logical) and not is_axes(out_logical)
        outs = out_logical if several else (out_logical,)
        parts = partial if several and partial is not None else (
            (partial,) * len(outs))
        names = tuple(mesh.mesh_dim_names)

        def summed(entry) -> set:
            got = set()
            for name in (() if entry is None else (entry,)
                         if isinstance(entry, str) else entry):
                axes = logical_spec((name,), mesh)[0]
                if axes is not None:
                    got |= {axes} if isinstance(axes, str) else set(axes)
            return got

        def pl(logical, over=frozenset()):
            if logical is None:
                return None
            return tuple(Partial(reduce) if names[i] in over else p for i, p in
                         enumerate(placements(logical_spec(logical, mesh),
                                              mesh)))
        return placed_region(fn, tuple(pl(i) for i in in_logical),
                             tuple(pl(o, summed(e)) for o, e in
                                   zip(outs, parts, strict=True)),
                             mesh)(*args)
    return run


def placed_region(fn, in_pls, out_pls, mesh: DeviceMesh, grad_pls=None):
    """``fn`` run on each rank's shards, the inputs redistributed to the
    placements ``in_pls`` and the outputs wrapped as ``out_pls`` (the
    body of :func:`local_region`, for a caller that derives placements
    from its inputs' own); gradients placed by ``grad_pls``, by default
    :func:`grad_placements`."""
    return local_map(fn, out_placements=out_pls, in_placements=in_pls,
                     in_grad_placements=(grad_pls if grad_pls is not None
                                         else grad_placements(in_pls,
                                                              out_pls)),
                     device_mesh=mesh, redistribute_inputs=True)


_ACTIVE_MESH: threading.local = threading.local()


def _current_mesh() -> Optional[DeviceMesh]:
    return getattr(_ACTIVE_MESH, "mesh", None)


@contextlib.contextmanager
def active_mesh(mesh: Optional[DeviceMesh]):
    """Install the mesh used by ``constrain`` inside model code."""
    prev = _current_mesh()
    _ACTIVE_MESH.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.mesh = prev


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)
    with its DTensor placements."""
    mesh: DeviceMesh
    spec: Spec
    placements: Tuple[Placement, ...]


def _map_axes(fn, tree):
    """``fn`` applied to every logical tuple of a tree of dicts and
    lists (the JAX ``is_leaf`` of tuples of names)."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_axes(fn, v) for v in tree)
    raise TypeError(f"not a tree of logical axis tuples: {tree!r}")


def make_param_shardings(mesh: DeviceMesh, logical_tree,
                         rules: Optional[AxisRules] = None):
    """Map a tree of logical-axis tuples to :class:`NamedSharding`\\ s on
    ``mesh``."""
    def one(names):
        spec = logical_spec(names, mesh, rules)
        return NamedSharding(mesh, spec, placements(spec, mesh))
    return _map_axes(one, logical_tree)


def shard_like(tree, shardings):
    """``distribute_tensor`` a tree of tensors according to a parallel
    tree of :class:`NamedSharding`\\ s."""
    if isinstance(shardings, NamedSharding):
        return distribute_tensor(tree, shardings.mesh, shardings.placements)
    if isinstance(shardings, dict):
        return {k: shard_like(tree[k], v) for k, v in shardings.items()}
    return type(shardings)(shard_like(t, s)
                           for t, s in zip(tree, shardings, strict=True))


def _axis_sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Mapping:
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return mesh


def divisibility_report(shape: Tuple[int, ...], spec: Spec,
                        mesh: Union[DeviceMesh, Mapping[str, int]]):
    """Human-readable check that a shape divides its spec on the mesh
    (a ``DeviceMesh``, or its axis sizes by name: the production meshes'
    shapes are checked without their 256 or 512 ranks)."""
    sizes = _axis_sizes(mesh)
    problems = []
    # A spec may omit trailing (unsharded) dims, so it is allowed to be
    # shorter than the shape.
    for dim, axis in zip(shape, spec, strict=False):
        if axis is None:
            continue
        axes = (axis,) if isinstance(axis, str) else axis
        total = int(np.prod([sizes[a] for a in axes]))
        if dim % total:
            problems.append(f"dim {dim} % mesh{axes}={total} != 0")
    return problems
