"""The compared sweeps of `serve_throughput`, shared by both packages'
runs in `test_torch_serve_tools.py`.

`sweep_jobs` builds one package's sweeps (its module's `_row` at every
dense and family point of `run`, and the quantized, tier, prefix and
sampling sweeps) as callables; `tapped` runs one and keeps the summary of
every engine it built.  `write_reference_sweeps` runs the reference's
sweeps and pickles them: the test module runs it in a subprocess, which
imports JAX and the reference only.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import jax

from repro.models import registry as jreg
from repro.serve import engine as jax_engine
from repro.serve import serve_step as jss

ROOT = Path(__file__).resolve().parents[1]


def reference_benchmark(name):
    """The reference's `benchmarks/<name>.py`, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_ST = reference_benchmark("serve_throughput")


_TAP = threading.local()


@contextlib.contextmanager
def kept_engines(module):
    """While open, each engine `module` builds is appended to its
    thread's `_TAP.engines`, where the thread keeps one (`tapped`)."""
    base = module.ServingEngine

    class Kept(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if getattr(_TAP, "engines", None) is not None:
                _TAP.engines.append(self)
    module.ServingEngine = Kept
    try:
        yield
    finally:
        module.ServingEngine = base


def tapped(fn):
    """One sweep: its result and the summaries of the engines it built."""
    _TAP.engines = []
    try:
        return fn(), [summary(e) for e in _TAP.engines]
    finally:
        _TAP.engines = None


def summary(eng) -> dict:
    """What both packages' engines must agree on after a sweep."""
    st = eng.stats()
    out = {"tokens": {r.uid: list(r.tokens) for r in eng.results},
           "prefill_tokens": eng.prefill_tokens,
           "peak_kv_bytes": eng.peak_kv_bytes(),
           "preemptions": st["preemptions"],
           "pool": {k: st["pool"][k] for k in (
               "num_pages", "allocated_pages", "peak_allocated_pages",
               "shared_pages", "pinned_pages")}}
    if eng.layout == "paged":
        out["prefill_shapes"] = sorted(eng.prefill_shapes)
    for key in ("prefix_store", "host_tier"):
        if key in st:
            out[key] = st[key]
    return out


_REF_FNS: dict = {}
_REF_FNS_LOCK = threading.Lock()


def shared(make):
    def fns(cfg, *args, **kw):
        key = (make.__name__, cfg, args, tuple(sorted(kw.items())))
        with _REF_FNS_LOCK:
            if key not in _REF_FNS:
                _REF_FNS[key] = make(cfg, *args, **kw)
            return _REF_FNS[key]
    return fns


ROW_NAMES = ["row dense", "row dense 1", "row dense 2"]
FAMILY_ROWS = ["moe", "hybrid", "vlm"]


def sweep_jobs(st, params_for, **kw) -> dict:
    """name -> the compared sweep of one package's module `st`: `run`'s
    dense rows and family rows on their streams, then the quantized,
    tier, prefix and sampling sweeps."""
    jobs = {}
    cfg = st.CFG
    for name, (mb, ms, n, phi, mnew) in zip(ROW_NAMES, st.SWEEP):
        rng = np.random.default_rng(hash((mb, ms)) % 2**32)
        jobs[name] = functools.partial(
            st._row, cfg, params_for(cfg), st._stream(rng, cfg, n, phi, mnew),
            mb, ms, **kw)
    p = st.FAM_POINT
    for fam in FAMILY_ROWS:
        fcfg = st.FAMILY_CFGS[fam]
        rng = np.random.default_rng(1000 + sum(map(ord, fam)))
        jobs[f"row {fam}"] = functools.partial(
            st._row, fcfg, params_for(fcfg),
            st._stream(rng, fcfg, p["n"], p["phi"], p["mnew"]), p["mb"],
            p["ms"], **kw)
    sweep_kw = dict(params_for=params_for, **kw) if kw else {}
    for name, sweep in (("quant", st._quant_sweep), ("tier", st._tier_sweep),
                        ("prefix", st._prefix_sweep)):
        jobs[name] = functools.partial(sweep, **sweep_kw)
    jobs["sampling"] = functools.partial(st._sampling_sweep, cfg,
                                         params_for(cfg), **kw)
    return jobs


@functools.lru_cache(maxsize=None)
def jax_params(cfg):
    """The reference's seeded weights of a config, drawn once per config
    for the module."""
    return jreg.get_family(cfg).init(jax.random.key(0), cfg)


# the reference's sweeps, slowest first (each is bound by XLA's compiles)
REF_ORDER = ["row hybrid", "row dense", "row moe", "row dense 2",
             "row dense 1", "row vlm", "prefix", "quant", "tier", "sampling"]


def write_reference_sweeps(path) -> None:
    """The reference's compared sweeps, four at a time on threads, with
    its step closures shared per config; name -> (result, engine
    summaries) pickled to `path`."""
    jax_engine.make_paged_serve_fns = shared(jss.make_paged_serve_fns)
    jax_engine.make_serve_fns = shared(jss.make_serve_fns)
    with kept_engines(REF_ST), ThreadPoolExecutor(4) as pool:
        jobs = sweep_jobs(REF_ST, jax_params)
        running = {name: pool.submit(tapped, jobs[name])
                   for name in REF_ORDER}
        out = {name: f.result() for name, f in running.items()}
    Path(path).write_bytes(pickle.dumps(out))
