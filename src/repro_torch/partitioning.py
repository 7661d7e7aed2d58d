"""Logical-axis partitioning with divisibility fallback (the port's twin of
the JAX package's ``partitioning.py``).

The framework annotates every parameter / state tensor with *logical* axis
names (e.g. ``('layers', 'embed', 'mlp')``).  A rule table maps logical
names to mesh axes.  At sharding time each rule is validated against the
actual dimension size: a rule whose dimension is not divisible by the mesh
axis size is dropped (the dim stays replicated), and no mesh axis shards
two dimensions of one tensor.  The same model gets a different, valid
decomposition on every device mesh without per-model hand tuning.

Resolution is pure Python over ``mesh.shape`` (a name-to-size mapping),
so it runs against any mesh object — the port's ``launch/mesh.Mesh``, an
abstract production mesh, or a test's stand-in — and its specs compare
equal to the JAX package's ``PartitionSpec``s as tuples.  A
``NamedSharding`` gives its DTensor placements (``Shard(d)`` or
``Replicate()`` per mesh dimension) as a pure function.

On a mesh of one device every placement and ``constrain`` is the
identity: the tensor itself comes back, with no copy, launch or host read.
The multi-device paths (DTensor placement, a ``DeviceMesh`` from
``torch.distributed``, the sequence-parallel wkv and the expert-parallel
MoE) are not ported yet: on a mesh of more than one device ``constrain``
and ``device_put`` raise rather than silently leaving tensors where they
are.  The JAX package's ``shard_map`` version shim has no twin; the
distributed paths replace its call sites.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch

#: What the multi-device paths wait for (the error ``constrain`` raises).
MULTI_DEVICE = ("a mesh of more than one device is not supported yet: the "
                "distributed paths (DTensor placement, sequence-parallel "
                "wkv, expert-parallel MoE) are ROADMAP Queue 1 item 3")

# ---------------------------------------------------------------------------
# Logical axis names used throughout the framework.
# ---------------------------------------------------------------------------
#   batch     global batch dimension of activations
#   seq       sequence dimension of activations / caches
#   cache_seq sequence dimension of decode KV caches (shardable on model axis)
#   embed     d_model dimension of weights (FSDP axis)
#   mlp       hidden/ffn output dimension of weights (tensor-parallel axis)
#   heads     query-head dimension (tensor-parallel axis)
#   kv_heads  kv-head dimension (tensor-parallel axis)
#   experts   MoE expert dimension (expert-parallel axis)
#   vocab     vocabulary dimension (tensor-parallel axis)
#   layers    stacked-layer leading dim of scanned params (never sharded)
#   state     recurrent state channels (tensor-parallel when divisible)

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_model": ("model",),     # sequence parallelism (cfg.seq_shard)
    "cache_seq": ("model",),
    "embed": ("data",),          # FSDP-style weight sharding over data axis
    "embed_nofsdp": (),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "layers": (),
    "state": ("model",),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product), as JAX's
    ``PartitionSpec``: a one-name tuple is unwrapped to the name and a
    list becomes a tuple; trailing ``None``s are kept (``spec_for`` strips
    them).  ``tuple(spec)`` equals ``tuple(jax.sharding.PartitionSpec(...))``
    of the same entries."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        def norm(p):
            if isinstance(p, (list, tuple)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_size(mesh: Any) -> int:
    """Devices a mesh spans: the product of its axis sizes."""
    return math.prod(mesh.shape.values())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` bound to a mesh."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> list:
        """DTensor placements, one per mesh dimension in the mesh's axis
        order: ``Shard(d)`` where the spec shards tensor dimension ``d``
        over that axis, else ``Replicate()``.  A pure function of the
        mesh's axis names and the spec (no process group)."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name is not None:
                    dim_of[name] = d
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in self.mesh.shape]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """A rule table bound to a mesh; resolves logical names -> PartitionSpec.
    Reads only ``mesh.shape``."""

    rules: Mapping[str, tuple[str, ...]]
    mesh: Any

    def mesh_axis_size(self, names: tuple[str, ...]) -> int:
        size = 1
        for n in names:
            size *= self.mesh.shape.get(n, 1)
        return size

    def spec_for(self, logical_axes: Sequence[str | None], shape: Sequence[int]
                 ) -> PartitionSpec:
        if len(logical_axes) != len(shape):
            raise ValueError(
                f"logical axes {logical_axes} rank != shape {shape} rank")
        used: set[str] = set()
        parts: list[Any] = []
        for name, dim in zip(logical_axes, shape):
            mesh_axes = tuple(a for a in self.rules.get(name, ())
                              if a in self.mesh.shape and a not in used)
            if not mesh_axes:
                parts.append(None)
                continue
            # divisibility fallback: drop trailing mesh axes until divisible
            while mesh_axes and dim % self.mesh_axis_size(mesh_axes) != 0:
                mesh_axes = mesh_axes[:-1]
            if not mesh_axes:
                parts.append(None)
                continue
            used.update(mesh_axes)
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        # strip trailing Nones for a tidy spec
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def sharding_for(self, logical_axes: Sequence[str | None],
                     shape: Sequence[int]) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(logical_axes, shape))


def make_rules(mesh: Any,
               overrides: Mapping[str, tuple[str, ...]] | None = None
               ) -> AxisRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return AxisRules(rules=rules, mesh=mesh)


# ---------------------------------------------------------------------------
# Activation-sharding context.
#
# Model code calls ``constrain(x, logical_axes)`` at layer boundaries; under
# a ``use_rules(rules)`` context (set by the trainer) it checks the
# axes against x's rank and, on a mesh of one device, returns x itself.
# Outside the context it is a no-op, as in the JAX package.
# ---------------------------------------------------------------------------
_ACTIVE_RULES: list[AxisRules] = []


class use_rules:
    def __init__(self, rules: AxisRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


def constrain(x: Any, logical_axes: Sequence[str | None]) -> Any:
    """``x`` itself: outside ``use_rules``, and inside it on a mesh of one
    device, where a sharding constraint is the identity (only the axes'
    rank is checked against ``x.shape``; no copy, no launch, no read of a
    device value, so it is safe inside CUDA-graph capture).  On a larger
    mesh it raises ``NotImplementedError``."""
    if not _ACTIVE_RULES:
        return x
    rules = _ACTIVE_RULES[-1]
    if mesh_size(rules.mesh) > 1:
        raise NotImplementedError(f"constrain: {MULTI_DEVICE}")
    rules.spec_for(logical_axes, x.shape)
    return x


# ---------------------------------------------------------------------------
# Annotated parameter trees.
#
# Model init functions build a tree (dicts and lists) whose leaves are
# ``Annot`` records — a tensor (on the ``meta`` device for an abstract
# tree) plus its logical axes.  ``split`` separates the value tree from the
# axes tree; ``tree_specs`` turns an axes tree + value tree into a
# PartitionSpec tree.  An axes leaf is always a tuple (``()`` for a 0-d
# tensor) and a container never one: the port's trees hold lists where the
# JAX package's hold tuples.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Annot:
    value: Any                       # a tensor (meta for abstract trees)
    axes: tuple[str | None, ...]     # logical axis names, one per dim

    def __post_init__(self):
        shape = getattr(self.value, "shape", None)
        if shape is not None and isinstance(self.axes, tuple) \
                and len(self.axes) != len(shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {tuple(shape)}")


def is_annot(x: Any) -> bool:
    return isinstance(x, Annot)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn: Callable, is_leaf: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping its dicts (in their order) and making its lists and
    non-leaf tuples lists."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, is_leaf, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, is_leaf, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    raise TypeError(f"not a leaf of this tree: {type(tree).__name__}")


def split(tree: Any) -> tuple[Any, Any]:
    """Split an Annot tree into (values, axes) trees of identical structure."""
    values = _map(lambda a: a.value, is_annot, tree)
    axes = _map(lambda a: a.axes, is_annot, tree)
    return values, axes


def tree_specs(axes_tree: Any, value_tree: Any, rules: AxisRules) -> Any:
    """PartitionSpec tree from an axes tree and matching value tree."""
    return _map(lambda ax, v: rules.spec_for(ax, v.shape), _is_axes,
                axes_tree, value_tree)


def tree_shardings(axes_tree: Any, value_tree: Any, rules: AxisRules) -> Any:
    return _map(lambda s: NamedSharding(rules.mesh, s),
                lambda x: isinstance(x, PartitionSpec),
                tree_specs(axes_tree, value_tree, rules))


def device_put(tree: Any, shardings: Any) -> Any:
    """Place each tensor of ``tree`` by its ``NamedSharding``: on a mesh of
    one device the tensor itself (it already lies on that device); a
    larger mesh raises ``NotImplementedError``."""
    def put(t: torch.Tensor, s: NamedSharding) -> torch.Tensor:
        if mesh_size(s.mesh) > 1:
            raise NotImplementedError(f"device_put: {MULTI_DEVICE}")
        return t
    return _map(put, lambda x: isinstance(x, torch.Tensor), tree, shardings)


def stack_axes(axes: tuple[str | None, ...]) -> tuple[str | None, ...]:
    """Axes tuple for a param stacked over layers (scan-over-layers)."""
    return ("layers",) + tuple(axes)


def _tensors(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(out.append, lambda x: isinstance(x, torch.Tensor), tree)
    return out


def param_count(params: Any) -> int:
    return int(sum(p.numel() for p in _tensors(params)))


def bytes_of(tree: Any) -> int:
    return int(sum(p.numel() * p.element_size() for p in _tensors(tree)))


# Convenience initializers ---------------------------------------------------
def is_meta(device: Any) -> bool:
    """Whether ``device`` is the ``meta`` device: an abstract tree, whose
    initialisers allocate and draw nothing (``jax.eval_shape`` never
    draws)."""
    return torch.device(device).type == "meta"


def trunc_normal(gen: torch.Generator | None, shape: Sequence[int],
                 scale: float, dtype: torch.dtype, device="cpu"
                 ) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in f32 from
    ``gen`` (a generator on ``device``) and cast to ``dtype`` (JAX's
    ``truncated_normal(key, -2, 2, shape) * scale``).  On ``meta``, an
    empty tensor and no draw."""
    if is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator | None, shape: Sequence[int],
               axes: tuple, dtype: torch.dtype, device="cpu",
               scale: float | None = None) -> Annot:
    """Fan-in scaled truncated-normal init, annotated."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return Annot(trunc_normal(gen, shape, s, dtype, device), axes)


def zeros_init(shape: Sequence[int], axes: tuple, dtype: torch.dtype,
               device="cpu") -> Annot:
    return Annot(torch.zeros(tuple(shape), dtype=dtype, device=device), axes)


def ones_init(shape: Sequence[int], axes: tuple, dtype: torch.dtype,
              device="cpu") -> Annot:
    return Annot(torch.ones(tuple(shape), dtype=dtype, device=device), axes)
