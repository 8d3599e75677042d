"""A world of ranks on one host: spawn, initialise, collect, time out.

`run_world(fn, nprocs, args)` starts `nprocs` processes with the "spawn"
method (CUDA cannot fork), initialises the default process group in each
(TCP rendezvous on a free localhost port), runs `fn(rank, *args)` and
returns the ranks' results, index = rank (each must pickle: numpy
arrays, numbers, dicts).  A rank that raises fails the world with its
traceback (the others are stopped); a world that has not finished within
`timeout` seconds is stopped and raises `TimeoutError`.  The process
groups' own timeout is the same, so a collective waiting on a dead rank
raises too.  Nothing is left running.
"""
from __future__ import annotations

import datetime
import socket
import time


def free_port() -> int:
    """A free TCP port on localhost (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, nprocs, port, backend, timeout, threads, args, out):
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=nprocs,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        res = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out.put((rank, res))


def run_world(fn, nprocs: int, args=(), *, timeout: float = 600.0,
              backend: str = "gloo", threads: int = 1) -> list:
    """[fn(0, *args), ..., fn(nprocs - 1, *args)], each in its own
    spawned process of one world (module docstring).  `threads` sets
    each rank's torch threads (0 leaves the default)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    port = free_port()
    procs = mp.start_processes(
        _entry, args=(fn, nprocs, port, backend, timeout, threads, args,
                      out), nprocs=nprocs, join=False,
        start_method="spawn")
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            while not out.empty():
                rank, res = out.get()
                results[rank] = res
            if procs.join(timeout=0.5):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world of {nprocs} ranks did not "
                                   f"finish within {timeout:.0f} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
    while not out.empty():
        rank, res = out.get()
        results[rank] = res
    missing = sorted(set(range(nprocs)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [results[r] for r in range(nprocs)]


def rank_device(mesh):
    """Set this rank's CUDA device (its mesh position's) and return it."""
    import torch
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
