"""AdamW and Adafactor with the JAX package's math (port of
``repro.train.optimizer``), as ``torch.optim.Optimizer`` subclasses.

``torch.optim.AdamW`` and ``torch.optim.Adafactor`` are not used: their
defaults, where they apply weight decay and their factored second moment
differ from the JAX package's.  Here, as there:

* the gradients are clipped to a global norm first (fp32 sums);
* weight decay applies to leaves with ``ndim >= 2`` only (norm scales and
  biases of a single layer are exempt);
* AdamW's bias correction is computed in fp32;
* Adafactor decays its moments by ``1 - (step + 1)^-0.8``, factors the
  second moment of ``ndim >= 2`` leaves over their last two axes, clips
  each leaf's update to RMS <= 1 and guards with ``1e-30``.

**Leaves.**  The optimizer works on the JAX package's leaves, not on
PyTorch's parameters: a leaf is ``(path, parts, stacked)``.  The JAX
models stack their layers on a leading axis, and the port keeps one
module per layer, so a stacked leaf (``dense_layers/...``) is the list of
its layers' tensors with a virtual leading axis, and the leaf's ``ndim``,
its factored moments and its update RMS are those of the stacked array
(``models.weights.lm_leaves`` lists them).  Each leaf is one param group
(``path``, ``stacked``).  The state is fp32 under the JAX names, stored
stacked — ``mu``/``nu`` (AdamW), ``vr``/``vc`` or ``v`` (Adafactor) —
and the step count is a host integer, so :meth:`state_tree` passes to
numpy and back in the JAX layout.

``opt_init(leaves, cfg)`` builds the optimizer; its ``step()`` is an
update: it returns ``{"lr", "grad_norm"}`` (the norm a device tensor).
The JAX ``opt_init(params, cfg)`` returns the state tree instead; the
port keeps the name for the object the trainers use.  The JAX package's
functional API is here too, as thin wrappers over the classes on trees
of dicts and lists (no stacked leaves): ``adamw_init`` /
``adamw_update``, ``adafactor_init`` / ``adafactor_update`` and
``opt_update(params, grads, state, cfg) -> (params, state, metrics)``,
which leave their inputs unchanged; ``opt_state_logical`` gives the
state's logical axes (``distributed.sharding``).  Clipping
and updates run in place on the device, one leaf at a time, with no host
sync: the temporaries are a leaf's, never a copy of the whole gradient.
Gradients come from each part's ``.grad`` or from ``step(grads=...)``
(one per part, in group order; fp32 accumulators of bf16 parameters come
that way).  With bf16 gradients the clipped gradient stays bf16 (JAX
casts it to fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import flatten_with_paths, is_axes, tree_from_paths

Tensor = torch.Tensor
Leaf = Tuple[str, Sequence[Tensor], bool]      # (path, parts, stacked)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay to ``min_lr_frac * lr``, in fp32 as
    the JAX package computes it."""
    s = np.float32(step)
    warm = cfg.lr * s / max(cfg.warmup_steps, 1)
    prog = np.clip((s - cfg.warmup_steps)
                   / max(cfg.decay_steps - cfg.warmup_steps, 1),
                   np.float32(0), np.float32(1))
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + np.cos(np.float32(np.pi) * prog))
    return float(warm if s < cfg.warmup_steps else cfg.lr * cos)


def global_norm(tensors: Iterable[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (a 0-d device
    tensor: no host sync)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> Tensor:
    """Scale ``grads`` **in place** by ``min(1, max_norm / norm)``;
    returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def _f32(x) -> float:
    """A Python float holding ``x`` rounded to fp32."""
    return float(np.float32(x))


class _LeafOptimizer(torch.optim.Optimizer):
    """The leaves as param groups, the step count and the JAX-layout state
    export shared by both optimizers."""

    _STATE: Tuple[str, ...] = ()

    def __init__(self, leaves: Iterable[Leaf], cfg: OptConfig):
        groups = [{"params": list(parts), "path": path,
                   "stacked": bool(stacked)}
                  for path, parts, stacked in leaves]
        super().__init__(groups, {})
        self.cfg = cfg
        self.step_count = 0
        for g in self.param_groups:
            self.state[g["params"][0]] = self._init_state(g)

    @staticmethod
    def _shape(group) -> Tuple[int, ...]:
        parts = group["params"]
        shape = tuple(parts[0].shape)
        return (len(parts),) + shape if group["stacked"] else shape

    def _init_state(self, group) -> Dict[str, Tensor]:
        raise NotImplementedError

    def _grads(self, grads: Optional[Sequence[Tensor]]) -> List[List[Tensor]]:
        """The gradients per group: ``grads`` (one per part, in group
        order) or each part's ``.grad`` (zeros where it has none)."""
        parts = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in parts]
        elif len(grads) != len(parts):
            raise ValueError(f"{len(grads)} gradients for {len(parts)} "
                             "parameters")
        it = iter(_placed_as(g, p) for g, p in zip(grads, parts, strict=True))
        return [[next(it) for _ in g["params"]] for g in self.param_groups]

    def state_tree(self):
        """The state in the JAX layout: ``{name: {leaf path: tensor}}`` for
        each state name and ``"step"`` (0-d int32)."""
        out = {name: tree_from_paths(
            (g["path"], self.state[g["params"][0]][name])
            for g in self.param_groups) for name in self._STATE}
        out["step"] = torch.tensor(self.step_count, dtype=torch.int32)
        return out

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Copy a :meth:`state_tree`-shaped tree (tensors or numpy arrays)
        into the state."""
        mine = self.state_tree()
        src = dict(flatten_with_paths({n: tree[n] for n in self._STATE}))
        for path, dst in flatten_with_paths({n: mine[n]
                                             for n in self._STATE}):
            dst.copy_(torch.as_tensor(src[path]))
        self.step_count = int(tree["step"])

    def _begin(self, grads):
        """Clip, advance the step; returns (grads per group, lr, norm)."""
        per_group = self._grads(grads)
        norm = clip_by_global_norm([g for gs in per_group for g in gs],
                                   self.cfg.grad_clip)
        self.step_count += 1
        return per_group, lr_at(self.cfg, self.step_count), norm


def _placed_as(g: Tensor, p: Tensor) -> Tensor:
    """A ``DTensor`` gradient placed as its parameter, once, before the
    update reads it: the gradient of a replicated parameter comes out of
    autograd as a partial sum, which each of its uses would otherwise
    reduce again."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) \
            and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _zeros(shape, like: Tensor, drop: Optional[int] = None) -> Tensor:
    """fp32 zeros of ``shape`` on ``like``'s device.  For a ``DTensor``
    parameter (a traced, sharded cell) the state is a ``DTensor`` placed
    as the parameter is, its dimensions aligned from the right; ``drop``
    (-1 or -2) names the trailing dimension of the leaf that a factored
    moment lacks."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    from repro_torch.distributed.sharding import dtensor_of, local_shape
    pls = []
    for p in like.placements:
        e = like.dim() - p.dim if isinstance(p, Shard) else 0
        if e and drop is not None and e == -drop:
            e = 0
        elif e and drop is not None and e > -drop:
            e -= 1
        pls.append(Shard(len(shape) - e) if e else Replicate())
    mesh = like.device_mesh
    local = torch.zeros(local_shape(shape, pls, mesh), dtype=torch.float32,
                        device=like._local_tensor.device)
    return dtensor_of(local, shape, pls, mesh)


class AdamW(_LeafOptimizer):
    _STATE = ("mu", "nu")

    def _init_state(self, group):
        shape = self._shape(group)
        p0 = group["params"][0]
        return {"mu": _zeros(shape, p0), "nu": _zeros(shape, p0)}

    @torch.no_grad()
    def step(self, closure=None, grads=None) -> Dict[str, object]:
        if closure is not None:
            raise ValueError("closures are not supported")
        per_group, lr, norm = self._begin(grads)
        cfg, step = self.cfg, self.step_count
        b1, b2 = cfg.b1, cfg.b2
        bc1 = _f32(1 - np.float32(b1) ** np.float32(step))
        bc2 = _f32(1 - np.float32(b2) ** np.float32(step))
        for group, gs in zip(self.param_groups, per_group, strict=True):
            st = self.state[group["params"][0]]
            decay = len(self._shape(group)) >= 2
            for i, (p, g) in enumerate(zip(group["params"], gs,
                                             strict=True)):
                mu = st["mu"][i] if group["stacked"] else st["mu"]
                nu = st["nu"][i] if group["stacked"] else st["nu"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                den = (nu / bc2).sqrt_().add_(cfg.eps)
                upd = (mu / bc1).div_(den)
                del den
                if decay:
                    upd.add_(p, alpha=cfg.weight_decay)
                p.add_(upd, alpha=-lr)
        return {"lr": lr, "grad_norm": norm}


class Adafactor(_LeafOptimizer):
    """Factored second moment (Shazeer & Stern 2018).  A stacked leaf is
    worked part by part (its gradients are never stacked): a part's
    moments are its slice of the stacked ones, except where the stack
    couples the layers (parts of one dimension: the column moment and the
    row moments' mean span the layers), and the update RMS sums over the
    parts.  So every layer of a stack moves the same bytes, whatever the
    depth."""

    _STATE = ("v",)

    def _init_state(self, group):
        shape = self._shape(group)
        p0 = group["params"][0]
        if len(shape) >= 2:
            return {"v": {"vr": _zeros(shape[:-1], p0, drop=-1),
                          "vc": _zeros(shape[:-2] + shape[-1:], p0,
                                       drop=-2)}}
        return {"v": {"v": _zeros(shape, p0)}}

    @staticmethod
    def _g2(g: Tensor) -> Tensor:
        return g.to(torch.float32).square().add_(1e-30)

    def _deltas(self, group, gs, decay: float) -> List[Tensor]:
        """Each part's ``vr ⊗ vc / mean(vr)`` after the moments' update."""
        v = self.state[group["params"][0]]["v"]
        stacked, ndim = group["stacked"], len(self._shape(group))
        if ndim < 2:                                   # a vector, alone
            v["v"].mul_(decay).add_(self._g2(gs[0]), alpha=1 - decay)
            return [v["v"].clone()]
        if stacked and ndim == 2:                      # layers of vectors
            vr, col = v["vr"], None
            for i, g in enumerate(gs):
                g2 = self._g2(g)
                vr[i].mul_(decay).add_(g2.mean(), alpha=1 - decay)
                col = g2 if col is None else col.add_(g2)
            v["vc"].mul_(decay).add_(col.div_(len(gs)), alpha=1 - decay)
            del col
            den = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            return [(vr[i] * v["vc"]).div_(den) for i in range(len(gs))]
        out = []
        for i, g in enumerate(gs):
            vr = v["vr"][i] if stacked else v["vr"]
            vc = v["vc"][i] if stacked else v["vc"]
            g2 = self._g2(g)
            vr.mul_(decay).add_(g2.mean(-1), alpha=1 - decay)
            vc.mul_(decay).add_(g2.mean(-2), alpha=1 - decay)
            del g2
            d = vr[..., None] * vc[..., None, :]
            out.append(d.div_(torch.clamp(
                vr.mean(-1, keepdim=True)[..., None], min=1e-30)))
        return out

    @torch.no_grad()
    def step(self, closure=None, grads=None) -> Dict[str, object]:
        if closure is not None:
            raise ValueError("closures are not supported")
        per_group, lr, norm = self._begin(grads)
        cfg = self.cfg
        decay = _f32(1 - np.float32(self.step_count + 1) ** np.float32(-0.8))
        for group, gs in zip(self.param_groups, per_group, strict=True):
            deltas = self._deltas(group, gs, decay)
            ssq, numel = 0.0, 0
            for g, d in zip(gs, deltas, strict=True):
                d.add_(cfg.eps).sqrt_()
                torch.div(g, d, out=d)
                ssq = ssq + torch.linalg.vector_norm(d).square()
                numel += d.numel()
            scale = torch.clamp(torch.sqrt(ssq / numel + 1e-30), min=1.0)
            decayed = len(self._shape(group)) >= 2
            for p, d in zip(group["params"], deltas, strict=True):
                d.div_(scale)
                if decayed:
                    d.add_(p, alpha=cfg.weight_decay)
                p.add_(d, alpha=-lr)
        return {"lr": lr, "grad_norm": norm}


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def opt_init(leaves: Iterable[Leaf], cfg: OptConfig) -> _LeafOptimizer:
    """The optimizer ``cfg.kind`` over ``leaves``, its state zeros."""
    return OPTIMIZERS[cfg.kind](leaves, cfg)


# ---------------------------------------------------------------------------
# the JAX package's functional API, over the classes
# ---------------------------------------------------------------------------

def _init(kind: str, params) -> Dict[str, Any]:
    leaves = [(path, [p], False) for path, p in flatten_with_paths(params)]
    return OPTIMIZERS[kind](leaves, OptConfig(kind=kind)).state_tree()


def _update(kind: str, params, grads, state, cfg: OptConfig):
    new = [(path, p.detach().clone())
           for path, p in flatten_with_paths(params)]
    opt = OPTIMIZERS[kind]([(path, [p], False) for path, p in new], cfg)
    opt.load_state_tree(state)
    g = dict(flatten_with_paths(grads))
    metrics = opt.step(grads=[g[path].detach().clone() for path, _ in new])
    return tree_from_paths(new), opt.state_tree(), metrics


def adamw_init(params) -> Dict[str, Any]:
    """``{"mu", "nu"}`` fp32 zeros like ``params`` and ``"step"`` 0."""
    return _init("adamw", params)


def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step: ``(new params, new state, {"lr", "grad_norm"})``."""
    return _update("adamw", params, grads, state, cfg)


def adafactor_init(params) -> Dict[str, Any]:
    """``{"v"}`` (``{"vr", "vc"}`` for ``ndim >= 2``, else ``{"v"}``) and
    ``"step"`` 0."""
    return _init("adafactor", params)


def adafactor_update(params, grads, state, cfg: OptConfig):
    """One Adafactor step: ``(new params, new state, {"lr",
    "grad_norm"})``."""
    return _update("adafactor", params, grads, state, cfg)


def opt_update(params, grads, state, cfg: OptConfig):
    return _update(cfg.kind, params, grads, state, cfg)


def opt_state_logical(logical, cfg: OptConfig):
    """Logical axes for the optimizer state, mirroring param axes."""
    if cfg.kind == "adamw":
        return {"mu": logical, "nu": logical, "step": ()}

    def fac(names):
        if is_axes(names):
            if len(names) >= 2:
                return {"vr": names[:-1], "vc": names[:-2] + names[-1:]}
            return {"v": names}
        if isinstance(names, dict):
            return {k: fac(v) for k, v in names.items()}
        return type(names)(fac(v) for v in names)
    return {"v": fac(logical), "step": ()}
