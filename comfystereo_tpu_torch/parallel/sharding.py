"""Device-mesh sharding for the stereo pipeline.

The JAX package shards frames over a device mesh with `jax.sharding` (pure
data parallelism: each frame is independent), and rows over a second mesh
axis ("seq"), and leaves XLA to split the work, all-reduce the global
reductions and exchange the vertical blur's halo rows. PyTorch does none of
that by itself, so the port does each step explicitly:

- `Mesh` is a named grid of slots, each a `torch.device`, over the axes
  `("data",)` or `("data", "seq")`. A mesh may repeat a device: eight slots
  on the CPU are the counterpart of the JAX tests' eight virtual CPU
  devices, four slots on `cuda:0` check the row path on one card. With
  `device=None` the mesh spans the local CUDA devices (the port's device
  rule: no GPU is an error).
- Under `torch.distributed` (gloo on the CPU, NCCL with one GPU per rank;
  the caller initialises the process group) the slots are dealt to the
  ranks in row-major order, and each process holds the blocks of its own
  slots. `shard_batch` then takes each process's local data, as
  `jax.make_array_from_process_local_data` does.
- `ShardedTensor` holds the blocks of a [B, H, ...] tensor on their slots'
  devices and gathers itself into one tensor.
- `all_slots` exchanges one tensor per block between all the mesh's slots:
  in one process it is the dict itself, across processes a
  `torch.distributed.all_gather`. The sharded pipeline builds its
  all-reduces and halo exchanges on it; a failed collective raises.

`parallel/pipeline.py` runs the stereo pipeline on sharded tensors
(`stereo_pipeline` dispatches there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

Slot = Tuple[int, int]
_AXES = (("data",), ("data", "seq"))


def _dist():
    """torch.distributed when a process group is initialised, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class Mesh:
    """A grid of slots over the axes ("data",) or ("data", "seq").

    `devices` is the numpy object array of the slots' devices in the mesh's
    shape (None for slots another process owns); `owners` holds each
    slot's rank. Slots are addressed as (data index, seq index), with seq
    index 0 on a one-axis mesh."""

    def __init__(self, devices: np.ndarray, axes: Tuple[str, ...], owners: np.ndarray,
                 rank: int = 0, world: int = 1):
        self.devices = devices
        self.axis_names = axes
        self.owners = owners
        self.rank = rank
        self.world = world
        self._grid = owners.reshape(owners.shape[0], -1)
        self._devs = devices.reshape(self._grid.shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def n_data(self) -> int:
        return self._grid.shape[0]

    @property
    def n_seq(self) -> int:
        return self._grid.shape[1]

    @property
    def distributed(self) -> bool:
        return self.world > 1

    def device(self, slot: Slot) -> torch.device:
        dev = self._devs[slot]
        if dev is None:
            raise ValueError(f"slot {slot} belongs to rank {self._grid[slot]}")
        return dev

    def block_slots(self, rows: bool, rank: Optional[int] = None) -> List[Slot]:
        """The slots that hold a block of a tensor sharded over frames and
        rows (rows=True) or over frames alone (rows=False: one block per
        data index, on its first slot), owned by `rank` (default: this
        process), in row-major order."""
        rank = self.rank if rank is None else rank
        out = []
        for d in range(self.n_data):
            for s in range(self.n_seq if rows else 1):
                if self._grid[d, s] == rank:
                    out.append((d, s))
        return out



def make_mesh(n_devices: Optional[int] = None, axes: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh of n_devices slots (default: every local CUDA device, or one
    slot per rank under torch.distributed).

    device: None for the local CUDA devices (one per rank, `cuda:{rank %
    count}`, under torch.distributed); a device (such as "cpu" or "cuda:0")
    that every slot of this process repeats; or a sequence of devices, one
    per slot of this process. shape: the mesh's shape (default (n, 1, ...)).
    """
    axes = tuple(axes)
    if axes not in _AXES:
        raise ValueError(f"axes must be one of {_AXES}, got {axes}")
    dist = _dist()
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist else (1, 0)
    if device is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        local = ([torch.device("cuda", rank % count)] if dist
                 else [torch.device("cuda", i) for i in range(count)])
    elif isinstance(device, (list, tuple)):
        local = [resolve_device(d) for d in device]
    else:
        local = [resolve_device(device)]
    repeat = device is not None and not isinstance(device, (list, tuple))
    if n_devices is None:
        n_devices = world * (1 if repeat else len(local))
    if n_devices % world:
        raise ValueError(f"{n_devices} slots do not divide over {world} processes")
    per_rank = n_devices // world
    if repeat:
        local = local * per_rank
    elif per_rank > len(local):
        raise RuntimeError(f"need {per_rank} devices in this process, have {len(local)}")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != len(axes) or math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} slots on {axes}")
    n_seq = shape[1] if len(shape) > 1 else 1
    if per_rank % n_seq and n_seq % per_rank:
        raise ValueError(f"{per_rank} slots per process do not tile seq axis {n_seq}")
    owners = np.arange(n_devices).reshape(shape) // per_rank
    devices = np.empty(n_devices, dtype=object)
    mine = np.flatnonzero(owners.ravel() == rank)
    for i, k in enumerate(mine):
        devices[k] = local[i]
    return Mesh(devices.reshape(shape), axes, owners, rank, world)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a [B, H, ...] tensor lies on a mesh: `spec` ("data",) shards
    frames (replicated over "seq", where the port keeps one copy, on the
    data row's first slot), ("data", "seq") frames and rows."""

    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def rows(self) -> bool:
        return "seq" in self.spec

    def is_equivalent_to(self, other: "NamedSharding", ndim: int) -> bool:
        del ndim  # every spec shards the leading axes only
        return self.mesh is other.mesh and self.spec == other.spec


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, ...] tensors sharded over frames (batch axis)."""
    return NamedSharding(mesh, ("data",))


def frame_row_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, ...] tensors sharded over frames and rows (needs a 2-axis mesh)."""
    if "seq" not in mesh.axis_names:
        raise ValueError("row sharding needs a ('data', 'seq') mesh")
    return NamedSharding(mesh, ("data", "seq"))


class ShardedTensor:
    """A [B, H, ...] tensor held as blocks on a mesh's slots.

    blocks: {slot: tensor} for this process's slots (`mesh.block_slots`).
    The block of slot (d, s) holds frames d*b .. (d+1)*b - 1 and, sharded
    over rows, rows s*h .. (s+1)*h - 1. `row_groups` > 1 says that the row
    axis is that many stacked parts each sharded over "seq" alike: a
    top-bottom packed output holds its left-eye rows in the first half and
    its right-eye rows in the second, and each block holds its rows of
    both halves, in that order."""

    def __init__(self, blocks: Dict[Slot, torch.Tensor], sharding: NamedSharding,
                 shape: Tuple[int, ...], row_groups: int = 1):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.row_groups = row_groups

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def rows(self) -> bool:
        return self.sharding.rows

    @property
    def device(self) -> torch.device:
        """The device of this process's first block."""
        return self.blocks[min(self.blocks)].device

    def _assemble(self, blocks: Dict[Slot, torch.Tensor], device) -> torch.Tensor:
        datas = sorted({d for d, _ in blocks})
        frames = []
        for d in datas:
            seqs = sorted(s for dd, s in blocks if dd == d)
            parts = [blocks[(d, s)].to(device).chunk(self.row_groups, dim=1) for s in seqs]
            frames.append(torch.cat([torch.cat([p[i] for p in parts], dim=1)
                                     for i in range(self.row_groups)], dim=1))
        return torch.cat(frames, dim=0)

    def local(self) -> torch.Tensor:
        """This process's frames and rows as one tensor, on its first device."""
        return self._assemble(self.blocks, self.device)

    def gather(self) -> torch.Tensor:
        """The whole tensor on this process's first device; across processes
        an all-gather that every process must call."""
        return self._assemble(all_slots(self.mesh, self.rows, self.blocks), self.device)


def all_slots(mesh: Mesh, rows: bool, parts: Dict[Slot, torch.Tensor]
              ) -> Dict[Slot, torch.Tensor]:
    """Every block slot's tensor, from each process's `parts` (one tensor of
    one shape per local block slot, `mesh.block_slots(rows)`). In one
    process that is `parts`; across processes one all_gather on this
    process's first device, after which every process holds every slot's
    tensor."""
    if not mesh.distributed:
        return dict(parts)
    import torch.distributed as dist

    slots = mesh.block_slots(rows)
    dev = parts[slots[0]].device
    local = torch.stack([parts[k].to(dev) for k in slots])
    got = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(got, local)
    out = {}
    for r, stacked in enumerate(got):
        for k, t in zip(mesh.block_slots(rows, r), stacked.unbind(0)):
            out[k] = t
    return out


def _local_box(mesh: Mesh, rows: bool) -> Tuple[List[int], List[int]]:
    slots = mesh.block_slots(rows)
    if not slots:
        raise ValueError(f"this process (rank {mesh.rank}) holds no block of a "
                         f"{'frame and row' if rows else 'frame'}-sharded tensor")
    return sorted({d for d, _ in slots}), sorted({s for _, s in slots})


def shard_tensor(x, sharding: NamedSharding) -> ShardedTensor:
    """Place a [B, H, ...] tensor (or numpy array) on the mesh. In one
    process x is the whole tensor; across processes it is this process's
    frames and rows (its slots' box), as
    `jax.make_array_from_process_local_data` takes them."""
    mesh, rows = sharding.mesh, sharding.rows
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    datas, seqs = _local_box(mesh, rows)
    nd, ns = len(datas), len(seqs)
    if t.shape[0] % nd or (rows and t.shape[1] % ns):
        raise ValueError(f"shape {tuple(t.shape)} does not split into {nd} x "
                         f"{ns if rows else 1} blocks")
    b, h = t.shape[0] // nd, (t.shape[1] // ns if rows else t.shape[1])
    blocks = {}
    for i, d in enumerate(datas):
        for j, s in enumerate(seqs if rows else [0]):
            blk = t[i * b:(i + 1) * b, j * h:(j + 1) * h] if rows else t[i * b:(i + 1) * b]
            blocks[(d, s)] = blk.to(mesh.device((d, s))).contiguous()
    shape = list(t.shape)
    shape[0] = b * mesh.n_data
    if rows:
        shape[1] = h * mesh.n_seq
    return ShardedTensor(blocks, sharding, tuple(shape))


def shard_batch(image, depth, mesh: Mesh, rows: bool = False):
    """Place a frame batch onto the mesh (data parallel over frames;
    optionally rows): ([B,H,W,C], [B,H,W]) -> two ShardedTensors."""
    sh = frame_row_sharding(mesh) if rows else frame_sharding(mesh)
    return shard_tensor(image, sh), shard_tensor(depth, sh)


def like(template: ShardedTensor, blocks: Dict[Slot, torch.Tensor],
         row_groups: int = 1) -> ShardedTensor:
    """A ShardedTensor with `template`'s sharding from new blocks of one
    shape: the global shape scales the blocks' frames (and rows) by the
    mesh."""
    mesh, rows = template.mesh, template.rows
    shape = list(next(iter(blocks.values())).shape)
    shape[0] *= mesh.n_data
    if rows:
        shape[1] *= mesh.n_seq
    return ShardedTensor(blocks, template.sharding, tuple(shape), row_groups)


def replicate(mesh: Mesh, build, slots: Iterable[Slot]):
    """{slot: build(device)} for the given slots of this process, built once
    per distinct device (a model replicated per device)."""
    built: Dict[torch.device, object] = {}
    out = {}
    for slot in slots:
        dev = mesh.device(slot)
        if dev not in built:
            built[dev] = build(dev)
        out[slot] = built[dev]
    return out

