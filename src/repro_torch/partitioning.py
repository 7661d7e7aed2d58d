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

A mesh of more than one device runs SPMD over a ``torch.distributed``
process group (the mesh's ``DeviceMesh``, launch/mesh.py), the twin of
JAX's single controller over a ``jax.sharding.Mesh``: every rank runs the
same program on its shards.  ``device_put`` makes DTensors, ``constrain``
redistributes a DTensor (``with_sharding_constraint``'s twin) and refuses
a plain tensor, and ``shard_map`` runs a body on rank-local tensors with
the collectives ``axis_index``, ``ppermute``, ``psum`` and ``pmean`` over
a mesh axis (the sequence-parallel time-mix and the expert-parallel MoE),
and ``all_gather`` and ``pmax`` (the cached attention's).  Every model
block runs as such a body, the hand kernels on rank-local tensors.  A
move between placements that gathers or slices (FSDP's all-gather of a
parameter entering a body, its gradient's reduce-scatter) is done by
explicit collectives, staged through host memory where gloo needs it
(CUDA tensors on one card); ``to_placements``/``match_placements`` also
sum a Partial gradient, ``full_tensor`` gathers a whole one.  Each
collective counts its calls and the bytes this rank sends, by JAX's HLO
kind names, in ``COLLECTIVES``; inside ``counting`` so do those a DTensor
op issues by itself (``analysis.count_collectives``).  On ``meta`` tensors
(the dry run, over a ``fake`` group) nothing is sent and only the shapes
and the counts are made.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

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


def active_rules() -> AxisRules | None:
    """The innermost ``use_rules`` rules when their mesh has more than one
    device, else None: the one test by which a model takes its
    multi-device path (on one device every placement is the identity).
    Inside a ``shard_map`` body, where tensors are rank-local, None too."""
    if _ACTIVE_RULES and not _BODIES \
            and mesh_size(_ACTIVE_RULES[-1].mesh) > 1:
        return _ACTIVE_RULES[-1]
    return None


def constrain(x: Any, logical_axes: Sequence[str | None]) -> Any:
    """``x`` itself: outside ``use_rules``, and inside it on a mesh of one
    device, where a sharding constraint is the identity (only the axes'
    rank is checked against ``x.shape``; no copy, no launch, no read of a
    device value, so it is safe inside CUDA-graph capture).  On a larger
    mesh ``x`` must be a DTensor on the mesh's ``DeviceMesh``: it is
    redistributed to the axes' placements (``with_sharding_constraint``'s
    twin); a plain tensor raises ``TypeError`` rather than stay
    replicated.  Inside a ``shard_map`` body (rank-local tensors) ``x``
    itself, as JAX's body sees no sharding."""
    if not _ACTIVE_RULES or _BODIES:
        return x
    rules = _ACTIVE_RULES[-1]
    spec = rules.spec_for(logical_axes, x.shape)
    if mesh_size(rules.mesh) == 1:
        return x
    return _redistribute(_as_dtensor(x, rules.mesh, "constrain"),
                         NamedSharding(rules.mesh, spec).placements())


# ---------------------------------------------------------------------------
# A mesh of more than one device: DTensors, the shard_map twin and its
# collectives.
#
# Every rank runs the same program.  Outside a shard_map body tensors are
# DTensors on the mesh's DeviceMesh; inside one they are this rank's
# shards, and the collectives below talk over one mesh axis's group.  The
# differentiation rules are those of the JAX package's
# ``shard_map(check_rep=False)``: the cotangent of an output that is
# replicated over an axis (its spec does not name it) is divided by the
# axis size on entering the body's backward, a ``psum``'s backward is a
# ``psum`` (so a psum whose result is replicated passes its cotangent
# through unchanged), a ``ppermute``'s the inverse permutation (a rank that
# receives nothing gets zeros), and the gradient of an input that enters
# replicated over an axis is summed over that axis (the copy-to /
# reduce-from pair).  Together they give the single-device gradient of a
# loss every rank computes alike, also for an output the body computes
# alike on every rank (the MoE's aux losses).  A collective's backward is a
# collective, so every rank must build the same autograd graph: a body
# selects with ``torch.where`` on a rank-dependent mask, never with a
# Python branch on ``axis_index``.
# ---------------------------------------------------------------------------
#: calls and bytes this rank sent, by JAX's HLO collective kind
#: ("collective-permute", "all-reduce", "all-gather", "reduce-scatter",
#: "all-to-all"); never reset, read as deltas (``analysis.count_collectives``)
COLLECTIVES: collections.defaultdict[str, list[int]] = \
    collections.defaultdict(lambda: [0, 0])


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind][0] += 1
    COLLECTIVES[kind][1] += nbytes


def _device_mesh(mesh: Any, what: str) -> Any:
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        raise RuntimeError(
            f"{what}: mesh {dict(mesh.shape)} spans {mesh_size(mesh)} "
            "devices but holds no DeviceMesh: build it inside a process "
            "group of that many ranks (launch/mesh.group_mesh)")
    return dm


def _as_dtensor(x: Any, mesh: Any, what: str) -> Any:
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(
            f"{what}: a plain {type(x).__name__} on a mesh of "
            f"{mesh_size(mesh)} devices; place it first (device_put)")
    # equal meshes (the same ranks, shape and names) are one mesh:
    # DTensor's sharding cache may hand an op's output an equal one
    if x.device_mesh != _device_mesh(mesh, what):
        raise ValueError(f"{what}: a DTensor of another DeviceMesh")
    return x


def _mesh_groups(dm: Any) -> list[tuple[Any, int, int]]:
    """(group, size, this rank's index) of each mesh dimension."""
    return [(dm.get_group(i), dm.size(i), dm.get_local_rank(i))
            for i in range(dm.ndim)]


def _host_staged(group: Any, t: torch.Tensor) -> bool:
    """Whether a collective stages ``t`` through host memory: a CUDA
    tensor on a gloo group (gloo sends no CUDA tensor point to point and
    reduces no bf16 one; NCCL takes them as they are)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(collective: Callable, out: torch.Tensor, /, *inputs: torch.Tensor,
         group: Any = None, **kw: Any) -> None:
    """``collective(out, *inputs, group=group, **kw)`` (``out`` alone for
    an in-place one, an all-reduce): nothing on ``meta``, and staged
    through host memory where ``_host_staged``."""
    if out.is_meta:
        return
    if _host_staged(group, out):
        host = out.cpu()
        collective(host, *(t.cpu() for t in inputs), group=group, **kw)
        out.copy_(host)
    else:
        collective(out, *inputs, group=group, **kw)


def _gather_local(t: torch.Tensor, dim: int, group: Any, n: int
                  ) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along ``dim`` in
    rank order (an all-gather; staged through host memory where
    ``_host_staged``); on ``meta`` the shape alone."""
    tt = t.movedim(dim, 0).contiguous()
    out = tt.new_empty((n * tt.shape[0],) + tuple(tt.shape[1:]))
    _run(dist.all_gather_into_tensor, out, tt, group=group)
    return out.movedim(0, dim)


def _scatter_sum_local(t: torch.Tensor, dim: int, group: Any, n: int
                       ) -> torch.Tensor:
    """This rank's ``dim``-chunk of the sum of ``t`` over ``group`` (a
    reduce-scatter, staged as ``_gather_local``)."""
    tt = t.movedim(dim, 0).contiguous()
    out = tt.new_empty((tt.shape[0] // n,) + tuple(tt.shape[1:]))
    _run(dist.reduce_scatter_tensor, out, tt, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather of a rank-local tensor along ``dim`` over one mesh
    dimension's group; its backward is the reduce-scatter of the
    cotangent (each rank keeps the sum of its own chunk).  Counted."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        _count("all-gather", t.numel() * t.element_size())
        return _gather_local(t, dim, group, n)

    @staticmethod
    def backward(ctx, ct):
        _count("reduce-scatter", ct.numel() * ct.element_size())
        return (_scatter_sum_local(ct, ctx.dim, ctx.group, ctx.n), None,
                None, None)


class _Slice(torch.autograd.Function):
    """This rank's chunk of a replicated tensor along ``dim`` (local, no
    traffic); its backward all-gathers the cotangent's chunks."""

    @staticmethod
    def forward(ctx, t, dim, group, n, index):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return t.chunk(n, dim=dim)[index].clone()

    @staticmethod
    def backward(ctx, ct):
        _count("all-gather", ct.numel() * ct.element_size())
        return (_gather_local(ct, ctx.dim, ctx.group, ctx.n), None, None,
                None, None)


def _explicit(src: list, dst: list) -> bool:
    """Whether ``_relocal`` moves ``src`` to ``dst``: every changed mesh
    dimension goes Shard -> Replicate or Replicate -> Shard."""
    return all(a == b or (a.is_shard() and b.is_replicate())
               or (a.is_replicate() and b.is_shard())
               for a, b in zip(src, dst))


def _relocal(local: torch.Tensor, src: list, dst: list, dm: Any
             ) -> torch.Tensor:
    """A rank-local shard under placements ``src`` moved to ``dst``: the
    gathers first, innermost mesh dimension first (two mesh dimensions
    sharding one tensor dimension nest in mesh order), then the slices,
    outermost first; a mesh dimension of one device moves nothing.  Every
    collective is explicit, counted and staged through host memory where
    the group needs it."""
    groups = _mesh_groups(dm)
    for i in reversed(range(len(src))):
        group, n, index = groups[i]
        if src[i].is_shard() and dst[i].is_replicate() and n > 1:
            local = _Gather.apply(local, src[i].dim, group, n)
    for i in range(len(src)):
        group, n, index = groups[i]
        if src[i].is_replicate() and dst[i].is_shard() and n > 1:
            local = _Slice.apply(local, dst[i].dim, group, n, index)
    return local


def _redistribute(x: Any, placements: list) -> Any:
    """``x`` moved to ``placements``: ``x`` itself where nothing changes;
    gathers and slices (``_relocal``) explicitly, each all-gather counted
    with this rank's shard before the move; any other move (a Partial
    source, Shard to another Shard) by DTensor's ``redistribute``, whose
    collectives ``counting`` sees."""
    from torch.distributed.tensor import DTensor

    src = list(x.placements)
    if src == list(placements):
        return x
    if not _explicit(src, placements):
        return x.redistribute(x.device_mesh, placements)
    local = _relocal(x.to_local(), src, list(placements), x.device_mesh)
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False)


# the native functional collectives DTensor issues, by JAX's HLO kind
_FUNCTIONAL_KINDS = (("all_gather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("all_to_all", "all-to-all"))


class _CountFunctional(TorchDispatchMode):
    """Lets DTensor desugar an op (NotImplemented for DTensor arguments)
    and counts each native functional collective it then issues on the
    rank-local tensors, with its input's bytes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._overloadpacket._qualified_op_name
        if name.startswith("_c10d_functional::"):
            for key, kind in _FUNCTIONAL_KINDS:
                if key in name:
                    _count(kind, args[0].numel() * args[0].element_size())
        return func(*args, **(kwargs or {}))


def counting():
    """A context in which the collectives DTensor ops issue by themselves
    (an FSDP all-gather of a DTensor matmul, a partial sum's all-reduce)
    are counted in ``COLLECTIVES`` beside the explicit ones, under JAX's
    kind names with the bytes of this rank's input.  Outside it only the
    explicit collectives (``shard_map``'s, ``_redistribute``'s) count."""
    return _CountFunctional()


@dataclasses.dataclass(frozen=True)
class _Body:
    """The mesh a shard_map body runs over."""
    mesh: Any
    device_mesh: Any


_BODIES: list[_Body] = []


def _body(what: str) -> _Body:
    if not _BODIES:
        raise RuntimeError(f"{what} outside a shard_map body")
    return _BODIES[-1]


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _all_reduce(t: torch.Tensor, axes: tuple[str, ...], body: _Body
                ) -> torch.Tensor:
    """The sum of ``t`` over the mesh axes ``axes``: one all-reduce per
    axis of more than one device, counted.  A new tensor."""
    out = t.clone()
    for a in axes:
        if body.mesh.shape[a] == 1:
            continue
        _count("all-reduce", out.numel() * out.element_size())
        _run(dist.all_reduce, out, group=body.device_mesh.get_group(a))
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, body):
        ctx.axes, ctx.body = axes, body
        return _all_reduce(t, axes, body)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.axes, ctx.body), None, None


def _send_recv(t: torch.Tensor, axis: str, perm: tuple, body: _Body
               ) -> torch.Tensor:
    """This rank's row of a permute over ``axis``: ``t`` sent to the
    index ``perm`` maps this rank's to, the tensor received from the index
    that maps to it, zeros where none does.  Counted on every rank; the
    bytes where this rank sends."""
    group = body.device_mesh.get_group(axis)
    me = body.device_mesh.get_local_rank(axis)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    _count("collective-permute", t.numel() * t.element_size() if dst else 0)
    if t.is_meta:
        return torch.empty_like(t)
    staged = _host_staged(group, t)
    send = t.detach().cpu() if staged else t.detach().contiguous()
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, j),
                      group) for j in dst]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, i),
                       group) for i in src]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(t.device) if staged else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, perm, body):
        ctx.axis, ctx.perm, ctx.body = axis, perm, body
        return _send_recv(t, axis, perm, body)

    @staticmethod
    def backward(ctx, ct):
        inverse = tuple((j, i) for i, j in ctx.perm)
        return _send_recv(ct, ctx.axis, inverse, ctx.body), None, None, None


class _SumGradOver(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over ``axes``: an
    input entering a body replicated over them (copy-to)."""

    @staticmethod
    def forward(ctx, t, axes, body):
        ctx.axes, ctx.body = axes, body
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.axes, ctx.body), None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the cotangent by ``scale``: an
    output leaving a body replicated over axes of that many devices."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.scale, None


def axis_index(axis: str) -> int:
    """This rank's index along mesh axis ``axis`` (``lax.axis_index``),
    inside a shard_map body."""
    return _body("axis_index").device_mesh.get_local_rank(axis)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: index i's ``x`` goes to index j for each (i, j)
    of ``perm`` along ``axis``; an index nothing is sent to gets zeros.
    Point to point over the axis's group."""
    return _PPermute.apply(x, axis, tuple((int(i), int(j)) for i, j in perm),
                           _body("ppermute"))


def psum(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the mesh axis (or axes)."""
    return _PSum.apply(x, _axes(axis), _body("psum"))


def pmean(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """``lax.pmean``: the mean of ``x`` over the mesh axis (or axes)."""
    axes = _axes(axis)
    n = math.prod(_body("pmean").mesh.shape[a] for a in axes)
    return psum(x, axes) / n


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the axis's ranks'
    ``x`` concatenated along ``dim`` in index order; its backward keeps
    this rank's chunk of the summed cotangent."""
    body = _body("all_gather")
    if body.mesh.shape[axis] == 1:
        return x
    return _Gather.apply(x, dim, body.device_mesh.get_group(axis),
                         body.mesh.shape[axis])


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum of ``x`` over the mesh axis,
    outside autograd (a softmax's stabiliser, whose gradient is none)."""
    body = _body("pmax")
    out = x.detach().clone()
    if body.mesh.shape[axis] == 1:
        return out
    _count("all-reduce", out.numel() * out.element_size())
    _run(dist.all_reduce, out, group=body.device_mesh.get_group(axis),
         op=dist.ReduceOp.MAX)
    return out


def _spec_map(fn: Callable, specs: Any, tree: Any) -> Any:
    """``fn(tensor, spec)`` over the tensors of ``tree``, ``specs`` a tree
    of PartitionSpecs of the same structure or a prefix of it (one spec
    for a whole subtree), as JAX's ``in_specs``/``out_specs``."""
    if isinstance(specs, PartitionSpec):
        return _map(lambda t: fn(t, specs),
                    lambda x: isinstance(x, torch.Tensor), tree)
    if isinstance(specs, dict):
        return {k: _spec_map(fn, specs[k], v) for k, v in tree.items()}
    return [_spec_map(fn, s, t) for s, t in zip(specs, tree, strict=True)]


def _unnamed(mesh: Any, spec: PartitionSpec) -> tuple[str, ...]:
    """The mesh axes of more than one device that ``spec`` does not name:
    those its tensor is replicated over."""
    named = {n for e in spec for n in (e if isinstance(e, tuple) else (e,))}
    return tuple(a for a, n in mesh.shape.items() if n > 1 and a not in named)


def shard_map(f: Callable, mesh: Any, in_specs: Any, out_specs: Any
              ) -> Callable:
    """The twin of ``jax.shard_map(f, mesh, in_specs, out_specs,
    check_rep=False)``: called on DTensors (trees of them, as ``in_specs``
    describes), it redistributes each to its spec's placements, runs ``f``
    on the rank-local tensors, where ``axis_index``, ``ppermute``, ``psum``
    and ``pmean`` talk over the mesh's axes, and wraps ``f``'s outputs as
    DTensors by ``out_specs``.  The differentiation rules are the section
    comment's.  Hand kernels see only the local tensors."""
    from torch.distributed.tensor import DTensor

    def enter(t: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        t = _as_dtensor(t, mesh, "shard_map")
        src, dst = list(t.placements), NamedSharding(mesh, spec).placements()
        local = _redistribute(t, dst).to_local()
        if not _explicit(src, dst):
            src = dst
        # an axis gathered on entry sums its gradient in the gather's
        # backward (a reduce-scatter); one the tensor was replicated over
        # already sums it here (an all-reduce)
        axes = tuple(a for i, a in enumerate(mesh.shape)
                     if a in _unnamed(mesh, spec) and not src[i].is_shard())
        return _SumGradOver.apply(local, axes, body) if axes else local

    def leave(t: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        n = math.prod(mesh.shape[a] for a in _unnamed(mesh, spec))
        if n > 1:
            t = _ScaleGrad.apply(t, 1.0 / n)
        return DTensor.from_local(t, dm, NamedSharding(mesh, spec)
                                  .placements(), run_check=False)

    dm = _device_mesh(mesh, "shard_map")
    body = _Body(mesh, dm)

    def call(*args):
        local = _spec_map(enter, tuple(in_specs), list(args))
        _BODIES.append(body)
        try:
            out = f(*local)
        finally:
            _BODIES.pop()
        return _spec_map(leave, out_specs, out)
    return call


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
    one device the tensor itself (it already lies on that device); on a
    larger one the DTensor that ``distribute_tensor(t, device_mesh,
    sharding.placements())`` gives, each rank cutting its shard from its
    own copy of ``t`` (SPMD: every rank holds the same host value, as
    JAX's ``device_put`` slices one host array), so nothing is sent."""
    def put(t: torch.Tensor, s: NamedSharding) -> torch.Tensor:
        if mesh_size(s.mesh) == 1:
            return t
        from torch.distributed.tensor import DTensor
        dm = _device_mesh(s.mesh, "device_put")
        placements = s.placements()
        local = t
        for i, pl in enumerate(placements):
            if pl.is_shard():
                local = local.chunk(dm.size(i), dim=pl.dim)[
                    dm.get_local_rank(i)]
        return DTensor.from_local(local.clone(), dm, placements,
                                  run_check=False)
    return _map(put, lambda x: isinstance(x, torch.Tensor), tree, shardings)


def only_axes(spec: PartitionSpec, axes: Sequence[str] = ("model",)
              ) -> PartitionSpec:
    """``spec`` with every mesh axis but ``axes`` dropped: a parameter's
    spec inside a ``shard_map`` body, gathered over the batch axes (FSDP's
    all-gather on entry, a reduce-scatter of its gradient)."""
    def keep(entry):
        names = tuple(n for n in (entry if isinstance(entry, tuple)
                                  else (entry,)) if n in axes)
        return names if names else None
    return PartitionSpec(*(keep(e) for e in spec))


def sharded_over(spec: PartitionSpec, dim: int, mesh: Any,
                 axis: str = "model") -> bool:
    """Whether ``spec`` splits tensor dimension ``dim`` over ``axis`` of
    ``mesh``: it names the axis there and the axis has more than one
    device."""
    if dim >= len(spec) or spec[dim] is None or mesh.shape.get(axis, 1) == 1:
        return False
    entry = spec[dim]
    return axis in (entry if isinstance(entry, tuple) else (entry,))


def spec_of(t: Any) -> PartitionSpec:
    """The PartitionSpec of a DTensor ``t``'s own placements: each tensor
    dimension the mesh axes that shard it, in mesh order (a Partial or
    Replicate mesh dimension names none), trailing ``None``s stripped as
    ``spec_for`` strips them."""
    parts: list[list[str]] = [[] for _ in range(t.dim())]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            parts[pl.dim].append(name)
    while parts and not parts[-1]:
        parts.pop()
    return PartitionSpec(*(tuple(p) if p else None for p in parts))


def body_specs(tree: dict, keep: Sequence[str] = ("model",)) -> dict:
    """The ``only_axes`` spec of each DTensor of ``tree`` (a dict of
    them), by its own placements: a parameter's spec inside a
    ``shard_map`` body, from where ``device_put`` placed it."""
    return {k: only_axes(spec_of(v), keep) for k, v in tree.items()}


def match_placements(t: Any, like: Any) -> Any:
    """A DTensor ``t`` (a gradient) moved to the placements of ``like``
    (its parameter): ``to_placements``.  A plain ``t`` comes back as it
    is."""
    if not hasattr(t, "placements"):
        return t
    return to_placements(t, list(like.placements))


def to_placements(t: Any, dst: list) -> Any:
    """A DTensor ``t`` moved to placements ``dst``: a Partial dimension
    all-reduced (explicit and counted), then ``_redistribute``."""
    from torch.distributed.tensor import DTensor, Replicate

    src = list(t.placements)
    if not any(pl.is_partial() for pl in src):
        return _redistribute(t, dst)
    dm, local = t.device_mesh, t.to_local()
    for i, pl in enumerate(src):
        if pl.is_partial():
            local = local.clone()
            _count("all-reduce", local.numel() * local.element_size())
            _run(dist.all_reduce, local, group=dm.get_group(i))
            src[i] = Replicate()
    return _redistribute(DTensor.from_local(local, dm, src,
                                            run_check=False), dst)


def full_tensor(t: Any) -> Any:
    """The whole tensor of a DTensor on every rank (its shards gathered by
    explicit, counted all-gathers, staged through host memory where gloo
    needs it), detached; a plain tensor itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return to_placements(t.detach(), [Replicate()] * t.device_mesh.ndim
                             ).to_local()


def replicas(t: Any) -> int:
    """The ranks holding each element of a DTensor ``t`` (the product of
    the mesh dimensions it is replicated over); 1 for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return 1
    return math.prod(t.device_mesh.size(i)
                     for i, pl in enumerate(t.placements)
                     if pl.is_replicate())


def world_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a rank-local tensor over every rank of the process group
    (one all-reduce, counted, staged through host memory where gloo needs
    it); ``t`` itself outside a group or on ``meta``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    out = t.clone()
    _count("all-reduce", out.numel() * out.element_size())
    _run(dist.all_reduce, out)
    return out


def place(x: torch.Tensor, logical_axes: Sequence[str | None]
          ) -> torch.Tensor:
    """A tensor a program makes (a zero state, an accumulator) placed by
    its logical axes under the active rules: ``x`` itself outside
    ``use_rules`` and on a mesh of one device, else ``device_put`` (JAX
    places such a constant by its use; a DTensor program must say so)."""
    rules = active_rules()
    if rules is None:
        return x
    return device_put(x, rules.sharding_for(logical_axes, x.shape))


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
