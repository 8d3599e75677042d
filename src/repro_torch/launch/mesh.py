"""The near-memory serving mesh: one device per bank of the UniMem arena.

Port of the serving part of `repro.launch.mesh` (`MEM_AXIS`,
`make_mem_mesh`).  The reference's mesh is a `jax.sharding.Mesh` that
a `shard_map`'d step runs over; the port's serving is single-controller
in the same way (one engine, one pool), and its mesh is just the list of
devices the arena's banks live on: bank s on `devices[s]`.  The host
drives every bank's walk, and only the queries, the new tokens' K/V and
the softmax summaries cross between a bank and the lead device
(DESIGN.md §2).  Several banks may share one device: on a one-card
machine every bank is a separate allocation on `cuda:0`, as the
reference's tests stack several virtual devices on one CPU.

The training meshes (`make_production_mesh`, `make_mesh`,
`make_host_mesh`, `make_abstract_mesh`, `dp_width`) wait for sharded
training (ROADMAP.md queue A, A.6 part two).
"""
from __future__ import annotations

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
