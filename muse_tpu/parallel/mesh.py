"""Device-mesh distribution of the sims axis (and optionally the latent field).

The reference's only parallelism is simulation-level data parallelism via
Julia Distributed worker pools (``pool`` kwarg, src/muse.jl:124; scatter/
gather over TCP, SURVEY §2.2-2.3).  The replacement here is a
``jax.sharding.Mesh``: batched per-sim arrays (keys, warm starts, sampled
data) are placed with a NamedSharding over a ``"sims"`` axis, and every
compiled step partitions automatically under jit — cross-sim reductions
become XLA collectives (NCCL over NVLink on GPUs) rather than TCP
gathers.  Every device reaches every other at the same rate, so the mesh
is a plain reshape of the device list.

Beyond the reference (SURVEY §2.2): a second ``"field"`` axis can shard the
flattened latent z *within* each MAP solve for large-field problems, since
all solver ops on z are elementwise or axis(-1) reductions which XLA turns
into psums over the field axis.

Sims counts need not divide the mesh — GSPMD handles uneven shard sizes
with internal padding, so the ``nsims+1`` lane layout (data + sims) shards
cleanly on any mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["SimsMesh", "make_sims_mesh"]


@dataclasses.dataclass
class SimsMesh:
    """A mesh with a ``sims`` data axis and optional ``field`` model axis."""

    mesh: Mesh
    sims_axis: str = "sims"
    field_axis: Optional[str] = None

    @property
    def n_sims_shards(self) -> int:
        return self.mesh.shape[self.sims_axis]

    def sims_sharding(self, extra_field_dim: bool = False) -> NamedSharding:
        """Sharding for a (B, ...) batched-per-sim array.  If the array's
        trailing axis is the flattened latent field and a field axis exists,
        shard that too."""
        if extra_field_dim and self.field_axis is not None:
            return NamedSharding(self.mesh, P(self.sims_axis, self.field_axis))
        return NamedSharding(self.mesh, P(self.sims_axis))

    def pad_count(self, b: int) -> int:
        """Extra lanes needed to make ``b`` divide the sims axis."""
        return (-b) % self.n_sims_shards

    def pad_lanes(self, arr):
        """Pad the lane axis to a multiple of the mesh (shared last-lane
        repeat rule, utils/fft_check.pad_lanes_to)."""
        from ..utils.fft_check import pad_lanes_to
        arr = jnp.asarray(arr)
        return pad_lanes_to(arr, arr.shape[0] + self.pad_count(arr.shape[0]))

    def shard_sims(self, arr, field: bool = False):
        """Pad the lane axis to the mesh size and place it sharded over
        devices (jax requires divisible lane counts for NamedSharding)."""
        arr = self.pad_lanes(arr)
        return jax.device_put(
            arr, self.sims_sharding(extra_field_dim=field and arr.ndim >= 2))

    def replicate(self, arr):
        return jax.device_put(jnp.asarray(arr),
                              NamedSharding(self.mesh, P()))


def make_sims_mesh(devices=None, *, sims: Optional[int] = None,
                   field: int = 1) -> SimsMesh:
    """Build a SimsMesh over the available devices.

    ``sims × field`` must equal the device count; by default all devices go
    to the sims axis (the reference's one-axis worker-pool model)."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if sims is None:
        sims = n // field
    if sims * field != n:
        raise ValueError(f"sims({sims}) × field({field}) != devices({n})")
    dev_grid = np.asarray(devices).reshape(sims, field)
    if field > 1:
        mesh = Mesh(dev_grid, ("sims", "field"))
        return SimsMesh(mesh, "sims", "field")
    mesh = Mesh(dev_grid.reshape(sims), ("sims",))
    return SimsMesh(mesh, "sims", None)
