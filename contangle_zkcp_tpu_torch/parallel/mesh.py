"""The port's device mesh: a 1-D mesh over the default process group.

Port of `contangle_zkcp_tpu/parallel/mesh.py`, whose mesh is a 1-D
`jax.sharding.Mesh` of the TPU's devices with one named axis ("points":
the MSM's points, the NTT's rows).  Here the mesh is torch.distributed's
default group: one rank a card (NCCL) or a CPU process (gloo), the axis
name kept for the callers' contracts.  `Mesh` adds the three exchanges
the parallel paths need, each one collective:

  * `shard(x)`: this rank's block of rows of a global array (no exchange);
  * `gather(x)`: every rank's block, concatenated along axis 0
    (`all_gather`);
  * `all_to_all(x, split_axis, concat_axis)`: `jax.lax.all_to_all(...,
    tiled=True)`'s exchange — x cut into D blocks along split_axis, block
    d sent to rank d, the D blocks received concatenated along
    concat_axis in rank order (`all_to_all_single` over contiguous
    blocks).

The backend follows the caller's device: NCCL for "cuda", gloo for "cpu".
A process with no group yet gets one at world size 1 from a `file://`
store in a fresh temporary directory (no TCP rendezvous, no network;
NCCL's own bootstrap socket is pinned to the loopback interface unless
NCCL_SOCKET_IFNAME says otherwise).  A process that runs several ranks
initialises the group itself (its address, world size and rank) before
`make_mesh`.  A failed initialisation raises: there is no fallback to
gloo or to the CPU.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

# seconds a collective (and the initialisation) may wait for the other ranks
TIMEOUT_S = 60


def backend_for(device) -> str:
    """The process group's backend for tensors on `device`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """This rank's view of a 1-D mesh: rank, size (D), device, axis."""

    def __init__(self, axis: str, device: torch.device, store_dir: str | None = None):
        self.axis = axis
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()
        self._store_dir = store_dir  # set when this mesh made the group

    def check_axis(self, axis: str) -> None:
        if axis != self.axis:
            raise ValueError(f"the mesh's axis is {self.axis!r}, not {axis!r}")

    def block(self, n: int) -> slice:
        """This rank's rows of n (n divisible by the mesh size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, x):
        """This rank's block of rows of x (a global array), on the mesh's
        device, contiguous."""
        return x[self.block(x.shape[0])].to(self.device).contiguous()

    def gather(self, x):
        """Every rank's x (same shape on all), concatenated along axis 0."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=0)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)."""
        D = self.size
        if x.shape[split_axis] % D:
            raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split over {D} ranks")
        send = torch.stack(x.chunk(D, dim=split_axis)).contiguous()  # (D, block...)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return torch.cat(recv.unbind(0), dim=concat_axis)

    def close(self) -> None:
        """Tear down the group if this mesh made it (world size 1)."""
        if self._store_dir is not None and dist.is_initialized():
            dist.destroy_process_group()
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def _init_world_of_one(backend: str) -> str:
    """Initialise the default group at world size 1 from a file store in a
    new temporary directory; returns the directory."""
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store_dir = tempfile.mkdtemp(prefix="zkcp_mesh_")
    try:
        dist.init_process_group(
            backend,
            init_method=f"file://{os.path.join(store_dir, 'store')}",
            world_size=1,
            rank=0,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return store_dir


def make_mesh(n_devices: int | None = None, axis: str = "points", device="cuda") -> Mesh:
    """The 1-D mesh over the default process group (made at world size 1
    when there is none).  n_devices, when given, must be the world size;
    on "cuda" each rank takes card rank mod the cards it sees, unless the
    device names one."""
    dev = torch.device(device)
    backend = backend_for(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device for an NCCL mesh")
    store_dir = None
    if not dist.is_initialized():
        store_dir = _init_world_of_one(backend)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs {dist.get_backend()}, "
                           f"{dev.type} tensors need {backend}")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {size} ranks")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(axis, dev, store_dir)


@dataclass(frozen=True)
class Placement:
    """Where a global array lives on the mesh: its rows sharded along the
    mesh's axis, or replicated on every rank (the reference's
    NamedSharding(mesh, P(axis)) and NamedSharding(mesh, P()))."""

    mesh: Mesh
    sharded: bool

    def place(self, x):
        """This rank's part of the global array x, on the mesh's device."""
        return self.mesh.shard(x) if self.sharded else x.to(self.mesh.device)


def shard_along(mesh: Mesh, axis: str = "points") -> Placement:
    mesh.check_axis(axis)
    return Placement(mesh, True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, False)
