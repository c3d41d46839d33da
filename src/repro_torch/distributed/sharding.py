"""Cooperative wave sharding on the port: the rows of one fleet wave split
over a one-axis ``("data",)`` device mesh.

The JAX package commits a wave to a ``jax.sharding.Mesh`` with a
``NamedSharding`` over its data axes.  Without jax, the port's mesh is a
small frozen object: the distinct devices, one ``"data"`` axis.  A
:class:`WaveSharding` splits the leading (row) dimension over the devices
in equal contiguous blocks, device ``i`` taking block ``i`` and every
other dimension whole — the layout ``NamedSharding(mesh, P("data"))``
gives.  Parameter, cache and activation shardings of the production mesh
are not ported.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Distinct devices on one ``"data"`` axis."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) != len(devs):
            raise ValueError(f"mesh devices must be distinct: {devs}")
        if self.axis_names != ("data",):
            raise ValueError(f"the port's mesh has one 'data' axis, not "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    return mesh.size if dp_axes(mesh) else 1


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
