"""Sharding rules of the port: DP / FSDP (ZeRO) / TP / EP / SP over the
production mesh, and the fleet's cooperative wave sharding.

Mesh axes (fixed by the production layout): single-pod ``('data',
'model')`` = (16, 16); multi-pod ``('pod', 'data', 'model')`` = (2, 16,
16).  Data parallelism runs over ``('pod', 'data')``, tensor parallelism
over ``'model'``.

Parameter layout is 2-D "FSDP + TP": every matrix shards its TP dim over
``model`` per the Megatron pattern (qkv/gate/up column-wise, o/down
row-wise) *and* its other dim over ``data`` (ZeRO-3: parameters,
gradients and Adam moments all sharded over both axes).  MoE experts: the
expert axis over ``model`` when it divides (EP), else TP within each
expert.  Mamba blocks: FSDP only.  Serving caches: batch over DP when it
divides, else the sequence over DP (sequence parallelism).

These are the JAX package's rules, leaf for leaf.  Without jax a sharding
is a plain frozen :class:`NamedSharding`: a mesh and one spec entry per
dim, each ``None``, an axis name or a tuple of axis names, with
:meth:`NamedSharding.shard_shape`.  The rules read the port's own trees
(nested dicts and lists, :class:`~repro_torch.optim.adamw.AdamWState`,
int8 :class:`~repro_torch.core.quant.QTensor`) by their dotted paths
(:func:`repro_torch.core.tree.flatten_with_paths`).

The port has no partitioner: the model runs on one card, and a mesh with
more than one device along ``model`` exists only as an
:class:`AbstractMesh` for the shape-only dry run
(:mod:`repro_torch.launch.dryrun`), which reads these specs to size each
chip's share.  The one place a mesh holds devices is the fleet's
cooperative wave (:func:`shard_wave_rows`): the rows of one wave split
over a one-axis ``("data",)`` mesh of distinct devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch

from repro_torch.core import tree

SpecEntry = Any          # None | str | tuple[str, ...]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mesh:
    """Distinct devices laid out over named axes, the last axis fastest
    (device ``i`` of ``devices`` sits at the row-major index ``i`` of
    ``axis_sizes``).  One axis (``("data",)`` by default) takes every
    device; more axes need their sizes."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    axis_sizes: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) != len(devs):
            raise ValueError(f"mesh devices must be distinct: {devs}")
        names = tuple(self.axis_names)
        sizes = self.axis_sizes
        if sizes is None:
            if len(names) != 1:
                raise ValueError(f"a mesh over the axes {names} needs their "
                                 "sizes (axis_sizes)")
            sizes = (len(devs),)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} with sizes {sizes}")
        if math.prod(sizes) != len(devs):
            raise ValueError(f"axis sizes {sizes} do not cover "
                             f"{len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices: the mesh a shape-only dry run
    shards over (the JAX package's ``jax.sharding.AbstractMesh``)."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        sizes = tuple(int(s) for s in self.axis_sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names) or \
                any(s < 1 for s in sizes):
            raise ValueError(f"axes {names} with sizes {sizes}")
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def devices(self) -> tuple:
        return ()


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def _fsdp(mesh, dim: int, spec: list, shape) -> None:
    """Shard dim over the data axis if divisible (ZeRO)."""
    if spec[dim] is None and shape[dim] % mesh.shape.get("data", 1) == 0 \
            and mesh.shape.get("data", 1) > 1:
        spec[dim] = "data"


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """One leaf's layout on ``mesh``: ``spec`` has one entry per dim,
    ``None`` (whole on every device), an axis name or a tuple of axis
    names (split over their product, the first axis slowest).  A tuple of
    one axis is that axis' name, as jax's ``PartitionSpec`` spells it."""
    mesh: Any
    spec: tuple[SpecEntry, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "spec", tuple(
            ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
            for ax in self.spec))

    def axes(self, dim: int) -> tuple[str, ...]:
        ax = self.spec[dim] if dim < len(self.spec) else None
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """Each device's block of a ``global_shape`` leaf (a dim that
        does not divide rounds up, as jax's ``shard_shape`` would pad)."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} for shape {global_shape}")
        out = []
        for dim, n in enumerate(global_shape):
            parts = math.prod(self.mesh.shape[a] for a in self.axes(dim))
            out.append(-(-n // parts))
        return tuple(out)

    def uses(self, axis: str) -> bool:
        return any(axis in self.axes(d) for d in range(len(self.spec)))


def _names(path) -> list[str]:
    """A dotted path (or a sequence of names) as its list of names."""
    return path.split(".") if isinstance(path, str) else [str(p)
                                                          for p in path]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _param_spec(cfg, mesh, path, shape: tuple[int, ...]) -> tuple:
    tp = tp_size(mesh)
    names = _names(path)
    leaf = names[-1]
    if leaf in ("q", "scale") and len(names) >= 2:
        leaf = names[-2]                   # int8 QTensor: rules of the weight
    stacked = "blocks" in names or ("encoder" in names)
    off = 1 if stacked and len(shape) >= 2 else 0
    spec: list = [None] * len(shape)

    def col(dim):        # TP column-parallel (output dim sharded)
        if shape[dim] % tp == 0 and tp > 1:
            spec[dim] = "model"

    row = col            # TP row-parallel (input dim sharded): same test

    in_moe = "moe" in names
    if leaf == "embed":
        col(0)                                   # vocab over model
        _fsdp(mesh, 1, spec, shape)
    elif leaf in ("head", "frontend"):
        col(1)
        _fsdp(mesh, 0, spec, shape)
    elif leaf == "embed_t":
        # the port's contiguous copy of a tied head (embed.T, (d, V)):
        # laid out as an untied head would be
        col(1)
        _fsdp(mesh, 0, spec, shape)
    elif in_moe and leaf in ("wg", "wu", "wd") and len(shape) - off == 3:
        E = shape[off]
        if E % tp == 0:                          # EP: experts over model
            spec[off] = "model"
            _fsdp(mesh, off + 1, spec, shape)
        else:                                    # TP within expert
            ff_dim = off + 2 if leaf in ("wg", "wu") else off + 1
            col(ff_dim)
            _fsdp(mesh, off + (1 if leaf in ("wg", "wu") else 2),
                  spec, shape)
    elif leaf == "router":
        _fsdp(mesh, off, spec, shape)
    elif leaf in ("wq", "wk", "wv", "wg", "wu", "w1"):
        col(off + 1)
        _fsdp(mesh, off, spec, shape)
    elif leaf in ("wo", "wd", "w2", "out_proj"):
        row(off)
        _fsdp(mesh, off + 1, spec, shape)
    elif leaf == "in_proj":                      # mamba: FSDP only
        _fsdp(mesh, off, spec, shape)
    elif leaf == "w" and len(shape) - off == 2:  # cnn fc etc.
        col(off + 1)
        _fsdp(mesh, off, spec, shape)
    # 1-D leaves (norms, biases, dt_bias, a_log, conv) stay replicated
    return tuple(spec)


def param_shardings(cfg, params, mesh, *, serve: bool = False) -> Any:
    """A tree like ``params`` (tensors, meta tensors or anything with a
    ``shape``) of :class:`NamedSharding`.

    ``serve=True`` drops the FSDP (data-axis) dim when TP-sharded bf16
    weights fit in HBM (otherwise every decode step re-gathers weights
    over the data axis); 405B-class models keep the 2-D layout."""
    rules = mesh
    if serve and cfg.n_params() * 2 / tp_size(mesh) < 12 * 2**30:
        rules = dataclass_mesh_without_fsdp(mesh)
    return _map_with_paths(
        lambda path, leaf: NamedSharding(
            mesh, _param_spec(cfg, rules, path, tuple(leaf.shape))), params)


class dataclass_mesh_without_fsdp:
    """Mesh proxy that reports data-axis size 1 so _fsdp() no-ops."""

    def __init__(self, mesh):
        self._mesh = mesh

    @property
    def shape(self):
        d = dict(self._mesh.shape)
        d["data"] = 1
        d.pop("pod", None)
        return d

    @property
    def axis_names(self):
        return self._mesh.axis_names


def opt_shardings(cfg, opt_state, mesh) -> Any:
    """Adam moments follow the parameters; the step counter replicated.
    ``opt_state`` is an :class:`~repro_torch.optim.adamw.AdamWState` (its
    ``m`` and ``v`` trees hold the parameters' sub-paths)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, ())
        sub = [n for i, n in enumerate(_names(path))
               if not (i == 0 and n in ("m", "v"))]
        return NamedSharding(mesh, _param_spec(cfg, mesh, sub, shape))
    return _map_with_paths(one, opt_state)


# ---------------------------------------------------------------------------
# batches & caches
# ---------------------------------------------------------------------------
def batch_shardings(mesh, batch) -> Any:
    """The leading (batch) dim over the data axes when it divides."""
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % n_dp == 0 and n_dp > 1:
            return NamedSharding(mesh, (dp, *([None] * (len(shape) - 1))))
        return NamedSharding(mesh, (None,) * len(shape))
    return _map_with_paths(one, batch)


def cache_shardings(cfg, mesh, cache) -> Any:
    """Decode-cache shardings.  Leaves are stacked (reps, B, ...):
    * k/v (reps,B,S,h,hd): B over DP if divisible else S over DP (SP);
      h over model if divisible else the sequence over model too;
    * mamba conv (reps,B,cw-1,ch): ch over model; h-state (reps,B,H,hd,N):
      hd over model when divisible.
    """
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    tp = tp_size(mesh)

    def one(path, leaf):
        names = _names(path)
        shape = tuple(leaf.shape)
        off = 1 if "main" in names else 0
        spec: list = [None] * len(shape)
        leafname = names[-1]
        if leafname in ("k", "v", "xk", "xv"):
            bdim, sdim, hdim = off, off + 1, off + 2
            s_axes: list = []
            if shape[bdim] % n_dp == 0 and n_dp > 1:
                spec[bdim] = dp
            elif shape[sdim] % n_dp == 0 and n_dp > 1:
                s_axes.extend(dp)                  # sequence parallelism
            if shape[hdim] % tp == 0 and tp > 1:
                spec[hdim] = "model"
            elif tp > 1 and shape[sdim] % (tp * max(1, len(s_axes)
                                           and n_dp)) == 0:
                s_axes.append("model")             # kv-heads don't divide
            if s_axes:
                spec[sdim] = tuple(s_axes)
        elif leafname == "conv":
            if shape[off] % n_dp == 0 and n_dp > 1:
                spec[off] = dp
            if shape[-1] % tp == 0 and tp > 1:
                spec[-1] = "model"
        elif leafname == "h":
            if shape[off] % n_dp == 0 and n_dp > 1:
                spec[off] = dp
            if shape[off + 2] % tp == 0 and tp > 1:
                spec[off + 2] = "model"
        return NamedSharding(mesh, tuple(spec))
    return _map_with_paths(one, cache)


def replicated(mesh, shapes) -> Any:
    return _map_with_paths(
        lambda path, leaf: NamedSharding(mesh, (None,) * len(leaf.shape)),
        shapes)


def _map_with_paths(fn, t) -> Any:
    """``fn(dotted path, leaf)`` over every leaf of ``t``, as a tree of the
    same structure."""
    return tree.unflatten(t, [fn(path, leaf) for path, leaf
                              in tree.flatten_with_paths(t)])


def shard_bytes(shardings, t) -> int:
    """The bytes one device holds of tree ``t`` laid out as ``shardings``
    (a tree of the same structure): each leaf's shard shape times its
    element size."""
    total = 0
    for sh, leaf in zip(tree.leaves(shardings), tree.leaves(t)):
        total += math.prod(sh.shard_shape(leaf.shape)) * \
            leaf.dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# cooperative wave sharding (the fleet's shard_waves lane)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WaveSharding:
    """The leading (batch) dim over ``axes`` of ``mesh``, everything else
    replicated: device ``i`` holds rows ``[i * r, (i + 1) * r)`` of a
    batch of ``r * dp_size(mesh)`` rows."""
    mesh: Mesh
    axes: tuple[str, ...]

    def blocks(self, rows: int) -> tuple[tuple[torch.device, slice], ...]:
        """Each device with the row slice it holds of a ``rows``-row
        batch; ``rows`` must divide evenly."""
        n = dp_size(self.mesh)
        if rows % n:
            raise ValueError(f"{rows} rows do not divide over {n} devices")
        per = rows // n
        return tuple((d, slice(i * per, (i + 1) * per))
                     for i, d in enumerate(self.mesh.devices))


def wave_sharding(mesh: Mesh) -> WaveSharding:
    """Row sharding for one cooperative wave: leading (batch) dim over
    the mesh's data axes, everything else replicated."""
    if tuple(mesh.axis_names) != ("data",):
        raise ValueError(f"a wave shards over a one-axis ('data',) mesh, "
                         f"not {mesh.axis_names}")
    return WaveSharding(mesh, dp_axes(mesh))


def shard_wave_rows(x, mesh: Mesh) -> tuple[list[torch.Tensor], int]:
    """Place a wave batch ``x`` (rows leading; a tensor or an array) on
    ``mesh``'s data axis.

    Returns ``(shards, rows)``: one row block per device, already on that
    device, and the *real* row count.  When the batch does not divide the
    data degree the tail is padded with zero rows first (rows are
    independent in every kernel, so padding changes no real row's bits;
    the caller keeps the first ``rows`` rows of the output)."""
    x = torch.as_tensor(x)
    rows = int(x.shape[0])
    if rows < 1:
        raise ValueError("shard_wave_rows needs at least one row")
    pad = (-rows) % max(1, dp_size(mesh))
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return [x[s].to(d) for d, s in wave_sharding(mesh).blocks(rows + pad)], \
        rows


# ---------------------------------------------------------------------------
# activation sharding constraints (model-internal)
# ---------------------------------------------------------------------------
# The JAX package pins activation layouts inside the model (GSPMD may lose
# a head sharding across a reshape and replicate attention over the model
# axis).  Model code calls :func:`constrain` at the same sites; 'dp'
# stands for the present data axes, 'tp' for 'model'.  The port has no
# partitioner, so a constraint changes nothing: it returns its input, and
# inside an :func:`activation_mesh` (the dry run's) it checks the spec's
# length and hands the pair to the context's ``on_constrain``, if one was
# given (the dry run's count lays the tensor out as the spec says).
# Outside a mesh context nothing is checked at all.
_MESH_CTX = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh, on_constrain=None):
    """Inside: :func:`active_mesh` is ``mesh``, and every
    :func:`constrain` calls ``on_constrain(x, spec)`` when given."""
    prev = (getattr(_MESH_CTX, "mesh", None),
            getattr(_MESH_CTX, "on_constrain", None))
    _MESH_CTX.mesh, _MESH_CTX.on_constrain = mesh, on_constrain
    try:
        yield
    finally:
        _MESH_CTX.mesh, _MESH_CTX.on_constrain = prev


def active_mesh():
    return getattr(_MESH_CTX, "mesh", None)


def constrain(x: torch.Tensor, spec: tuple[str | None, ...]) -> torch.Tensor:
    """spec entries: 'dp' | 'tp' | None, one per dim.  Returns ``x``
    itself (no partitioner); inside :func:`activation_mesh` a spec of the
    wrong length raises, as the reference asserts."""
    if active_mesh() is not None:
        if len(spec) != x.dim():
            raise ValueError(f"constrain: spec {spec} for shape "
                             f"{tuple(x.shape)}")
        hook = getattr(_MESH_CTX, "on_constrain", None)
        if hook is not None:
            hook(x, spec)
    return x
