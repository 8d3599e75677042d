"""Which collectives gloo runs on CUDA tensors, on this installation.

    PYTHONPATH=src python -m repro_torch.benchmarks.gloo_cuda_probe

Several ranks on one card cannot use NCCL, so the port's process groups
are gloo there, and `distribution/collectives.py` stages every message
that gloo cannot take on the card through pinned host memory
(`GLOO_CUDA_OK` names the others).  A primitive gloo does not support on
CUDA tensors may abort the process instead of raising (its TCP
transport writes from the device pointer), so each primitive is tried in
a 2-rank world of its own, on a CUDA tensor, and held to the exact
result.  Prints one JSON line: {"torch": ..., "device": ...,
"primitives": {name: "ok" | "wrong" | "raises" | "aborts"}}.
"""
from __future__ import annotations

import json


def _trial(rank: int, prim: str):
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("data",)).bind()
    torch.cuda.set_device(mesh.device)
    g = mesh.group("data")
    n = g.size
    x = torch.full((8 * n,), float(rank), device=mesh.device)
    try:
        if prim == "all_reduce":
            y = x.clone()
            C._raw_all_reduce(y, g, C._sum())
            want = torch.full_like(x, n * (n - 1) / 2)
        elif prim == "all_gather":
            y = torch.cat(C._raw_all_gather(x, g))
            want = torch.arange(n, device=x.device).float() \
                .repeat_interleave(8 * n)
        elif prim == "reduce_scatter":
            y = C._raw_reduce_scatter(x, g)
            want = torch.full((8,), n * (n - 1) / 2, device=x.device)
        else:
            y = C._raw_shift(x, g, 1)
            want = torch.full_like(x, float((rank - 1) % n))
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        return f"raises: {str(e).splitlines()[0][:120]}"
    return "ok" if torch.equal(y.cpu(), want.cpu()) else "wrong"


def probe(timeout: float = 120.0) -> dict:
    from repro_torch.distribution.collectives import PRIMITIVES
    from repro_torch.launch.world import run_world
    out = {}
    for prim in PRIMITIVES:
        try:
            res = run_world(_trial, 2, (prim,), timeout=timeout, threads=0)
            out[prim] = res[0] if res[0] == res[1] else f"{res[0]} / {res[1]}"
        except Exception as e:            # the world died: the rank aborted
            out[prim] = f"aborts: {type(e).__name__}"
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "primitives": probe()}), flush=True)


if __name__ == "__main__":
    main()
