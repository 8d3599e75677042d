"""Meshes: the training meshes and the near-memory serving mesh.

Port of `repro.launch.mesh`.  Functions, not module constants: importing
this module touches no device and no process group.

Training meshes (`make_mesh`, `make_host_mesh`, `make_abstract_mesh`,
`make_production_mesh`) are `Mesh`es: a plain description of axis names,
a shape, and the rank and device at each position (row-major over the
axes, as `jax.make_mesh` lays devices out).  Specs resolve on a mesh with
no process group (`distribution.sharding.logical_to_spec`), which is how
the production meshes' 256 and 512 positions and the abstract meshes are
used.  A rank that trains binds the mesh once (`Mesh.bind`): one process
group per axis through its position, and one for the data-parallel axes
("pod", "data"), every cross-rank move then running on them
(`distribution/collectives.py`).  Rank r trains on `devices[r]`:
`cuda:(r % device_count)` by default.  The process-group backend is NCCL
when every rank has a card of its own; several ranks on one card (NCCL
refuses two ranks on one GPU) and CPU ranks take gloo
(`backend_for`).

Graded meshes (the brief):
  * single-pod:  (16, 16)      axes ("data", "model")   = 256 chips
  * multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 chips

Axis roles (DESIGN.md §5): FSDP/DP over ("pod", "data"), the DSU pool
serving feature data; TP/SP/EP over "model", the VPU pool holding
resident weight shards.

The serving mesh (`MemMesh`, `make_mem_mesh`) is the list of devices the
UniMem arena's banks live on: bank s on `devices[s]`.  The port's serving
is single-controller (one engine, one pool): the host drives every
bank's walk, and only the queries, the new tokens' K/V and the softmax
summaries cross between a bank and the lead device (DESIGN.md §2).
Several banks may share one device: on a one-card machine every bank is
a separate allocation on `cuda:0`, as the reference's tests stack
several virtual devices on one CPU.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

# the near-memory serving axis: the UniMem page arena shards over it
MEM_AXIS = "mem"


@dataclass(frozen=True)
class MemMesh:
    """A 1-D mesh over the `MEM_AXIS`: `devices[s]` holds bank s."""
    devices: tuple

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (MEM_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {MEM_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> dict:
        """shards, axis and the device of each bank (logs, tools)."""
        return {"shards": self.size, "mesh_axis": MEM_AXIS,
                "devices": [str(d) for d in self.devices]}


def make_mem_mesh(shards: int | None = None, devices=None) -> MemMesh:
    """The 1-D serving mesh over `MEM_AXIS` with `shards` banks.

    `devices` names the devices the banks go round-robin over (bank s
    on `devices[s % len(devices)]`; `["cpu"] * n` or `["cpu"]` for the
    CPU).  By default the banks go round-robin over the visible CUDA
    devices, one bank a card where there are as many cards, and
    `shards` defaults to the number of cards.  Without a card and
    without `devices` it raises, as the port's entry points do.  A
    1-shard mesh makes the engine take its single-arena path."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu'] to put the "
                "arena's banks on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mem_mesh needs at least one device")
    shards = len(devices) if shards is None else int(shards)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return MemMesh(tuple(devices[s % len(devices)] for s in range(shards)))


# ------------------------------------------------------ training meshes

DP_AXES = ("pod", "data")


class Mesh:
    """Axis names, a shape, and the device of each position (row-major
    over the axes; position == rank).  `devices` is None for an abstract
    mesh, which only resolves specs.  A mesh returned by `bind` also
    holds this rank's position and its process groups."""

    def __init__(self, shape, axes, devices=None, rank=None, groups=None):
        self.axis_names = tuple(axes)
        self.axis_sizes = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"shape {shape} does not match axes {axes}")
        self.devices = None if devices is None else tuple(
            torch.device(d) for d in devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")
        self.rank = rank
        self._groups = groups

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}"
                + (f", rank={self.rank}" if self.bound else "") + ")")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def bound(self) -> bool:
        return self._groups is not None

    def coords(self, rank: int) -> dict[str, int]:
        """axis name -> index of position `rank`."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}

    def rank_at(self, coords: dict) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            r = r * n + coords.get(name, 0)
        return r

    def lines(self, axes) -> list[list[int]]:
        """Every group of positions that differ only along `axes` (ranks
        ordered with the first axis major)."""
        axes = [a for a in self.axis_names if a in axes]
        rest = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            out.append([self.rank_at({**base, **dict(zip(axes, idx))})
                        for idx in itertools.product(
                            *(range(self.shape[a]) for a in axes))])
        return out

    @property
    def device(self) -> torch.device:
        """This rank's device (a bound mesh)."""
        return self.devices[self.rank]

    @property
    def my_coords(self) -> dict[str, int]:
        return self.coords(self.rank)

    def group(self, axis: str):
        """The `collectives.AxisGroup` of `axis` through this rank ("dp":
        the data-parallel axes together)."""
        if not self.bound:
            raise ValueError(f"{self!r} is not bound to process groups")
        return self._groups[axis]

    def bind(self, rank: int | None = None) -> "Mesh":
        """This mesh bound to process groups, for rank `rank` (default:
        this process's rank in the initialised default group, whose world
        must be the mesh's size).  Every rank must bind the same meshes in
        the same order: group creation is collective."""
        import torch.distributed as dist
        from repro_torch.distribution.collectives import AxisGroup
        if self.devices is None:
            raise ValueError("an abstract mesh cannot be bound")
        rank = dist.get_rank() if rank is None else rank
        if dist.get_world_size() != self.size:
            raise ValueError(f"world of {dist.get_world_size()} ranks for a "
                             f"mesh of {self.size} positions")
        groups = {}
        named = [(a, (a,)) for a in self.axis_names]
        named.append(("dp", tuple(a for a in DP_AXES if a in self.axis_names)))
        for name, axes in named:
            for line in self.lines(axes):
                pg = dist.new_group(line) if len(line) > 1 else None
                if rank in line:
                    groups[name] = AxisGroup(name, pg, tuple(line),
                                             line.index(rank))
        groups["world"] = AxisGroup("world", dist.group.WORLD,
                                    tuple(range(self.size)), rank)
        return Mesh(self.axis_sizes, self.axis_names, self.devices, rank,
                    groups)


def default_devices(n: int, device=None) -> list[torch.device]:
    """Rank r's device: `device` for every rank when given ("cpu",
    "cuda:1"), else (None or "cuda") `cuda:(r % device_count)`; without a
    card it raises, as every entry point of the port does."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return [torch.device(device)] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to train the mesh's ranks on the CPU")
    k = torch.cuda.device_count()
    return [torch.device("cuda", r % k) for r in range(n)]


def backend_for(mesh: Mesh) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    devs = mesh.devices or ()
    if devs and all(d.type == "cuda" for d in devs) \
            and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def make_abstract_mesh(shape, axes) -> Mesh:
    """Device-free mesh for spec resolution (tests, planning tools)."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The graded meshes, abstract: their 256 / 512 positions resolve
    specs; the port trains on bound meshes of the ranks it has."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_mesh(shape, axes, device=None) -> Mesh:
    """Arbitrary mesh (tests, examples, elastic restarts); rank r on
    `default_devices`' device r."""
    shape = tuple(shape)
    return Mesh(shape, tuple(axes), default_devices(math.prod(shape), device))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh."""
    return make_mesh((data, model), ("data", "model"), device)


def dp_width(mesh) -> int:
    """Data-parallel width = product of the DSU axes present."""
    w = 1
    for a in DP_AXES:
        if a in mesh.axis_names:
            w *= mesh.shape[a]
    return w
