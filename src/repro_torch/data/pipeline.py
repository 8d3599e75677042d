"""Data pipeline: synthetic + memmap token streams, per-host sharding.

Port of `repro.data.pipeline` (numpy only, the same arrays for the same
config and step).  Production shape: each HOST loads only its slice of
the global batch (`host_slice`) and forms (per_host_batch, seq+1) token
windows, so no host ever materializes the global batch.  On one card the
same code runs with num_hosts=1; the tests exercise the slicing logic
with synthetic host counts.

Sources:
  * `SyntheticLM` — deterministic PRNG token stream (benchmarks, smoke).
  * `MemmapTokens` — a flat binary token file (np.memmap), the standard
    pre-tokenized corpus format; windows are drawn by stateless index
    arithmetic so restore-from-checkpoint resumes EXACTLY (step -> window
    offsets, no iterator state to save).

The families with a frontend stub train on batches the reference's
sources do not make (they give tokens only, which its vlm and encoder
losses cannot take), so `make_source` gives them their own:
  * `WithPatches` — a vlm's token batches plus seeded patch rows.
  * `SyntheticFrames` — an encoder's frames, mask and codebook labels.
Both are stateless in `step` too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"        # synthetic | memmap
    path: str = ""                   # memmap token file (int32/uint16)
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    dtype: str = "int32"             # memmap on-disk dtype

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def host_slice(global_batch: int, num_hosts: int, host_id: int) -> slice:
    """Contiguous rows of the global batch owned by `host_id`."""
    assert global_batch % num_hosts == 0, (
        f"global batch {global_batch} % hosts {num_hosts} != 0")
    per = global_batch // num_hosts
    return slice(host_id * per, (host_id + 1) * per)


class SyntheticLM:
    """Deterministic synthetic LM batches: tokens ~ U[0, vocab), labels =
    next-token shift.  Stateless in `step` — resume == replay."""

    def __init__(self, data: DataConfig, cfg: ModelConfig,
                 num_hosts: int = 1, host_id: int = 0):
        self.data, self.cfg = data, cfg
        self.num_hosts, self.host_id = num_hosts, host_id
        self.sl = host_slice(data.global_batch, num_hosts, host_id)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows = self.sl.stop - self.sl.start
        rng = np.random.default_rng(
            (self.data.seed * 1_000_003 + step) * 65_537 + self.host_id)
        toks = rng.integers(0, self.cfg.vocab_size,
                            (rows, self.data.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MarkovLM:
    """Learnable synthetic data: tokens follow a fixed first-order Markov
    chain (seeded), so a model can drive CE from ln(V) down toward the
    chain's conditional entropy — the e2e example's loss-curve source."""

    BRANCH = 4        # successors per token -> H(next|cur) = ln(BRANCH)

    def __init__(self, data: DataConfig, cfg: ModelConfig,
                 num_hosts: int = 1, host_id: int = 0):
        self.data, self.cfg = data, cfg
        self.sl = host_slice(data.global_batch, num_hosts, host_id)
        rng = np.random.default_rng(data.seed + 12345)
        V = cfg.vocab_size
        self.successors = rng.integers(0, V, (V, self.BRANCH), dtype=np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows = self.sl.stop - self.sl.start
        rng = np.random.default_rng(
            (self.data.seed * 1_000_003 + step) * 65_537 + self.sl.start)
        s = self.data.seq_len + 1
        toks = np.empty((rows, s), np.int32)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, rows)
        choices = rng.integers(0, self.BRANCH, (rows, s - 1))
        for t in range(1, s):
            toks[:, t] = self.successors[toks[:, t - 1], choices[:, t - 1]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapTokens:
    """Flat pre-tokenized corpus.  Window w of step s for global row r
    starts at ((s * global_batch + r) * seq_len) mod usable — fully
    deterministic from (step, row): elastic restarts and host remaps
    replay identical data."""

    def __init__(self, data: DataConfig, cfg: ModelConfig,
                 num_hosts: int = 1, host_id: int = 0):
        self.data, self.cfg = data, cfg
        self.tokens = np.memmap(data.path, dtype=np.dtype(data.dtype), mode="r")
        self.usable = len(self.tokens) - (data.seq_len + 1)
        assert self.usable > 0, "token file shorter than one window"
        self.sl = host_slice(data.global_batch, num_hosts, host_id)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows = range(self.sl.start, self.sl.stop)
        out = np.empty((len(rows), self.data.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            start = ((step * self.data.global_batch + r)
                     * self.data.seq_len) % self.usable
            out[i] = self.tokens[start:start + self.data.seq_len + 1]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _step_rng(data: DataConfig, step: int, row0: int, stream: int = 0):
    """The generator of one step's draws for the rows from `row0` on
    (`stream` keeps a source's second draw apart from its first)."""
    return np.random.default_rng(
        [(data.seed * 1_000_003 + step) * 65_537 + row0, stream])


class WithPatches:
    """A vlm's training batches: the token source's, plus
    `patch_embeds` (rows, num_patches, frontend_dim) ~ N(0, 1) in f32
    from the step's own generator (the stub frontend's image rows)."""

    def __init__(self, tokens, data: DataConfig, cfg: ModelConfig,
                 num_hosts: int = 1, host_id: int = 0):
        self.tokens, self.data, self.cfg = tokens, data, cfg
        self.sl = host_slice(data.global_batch, num_hosts, host_id)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        batch = self.tokens.batch_at(step)
        rng = _step_rng(self.data, step, self.sl.start, stream=1)
        batch["patch_embeds"] = rng.standard_normal(
            (self.sl.stop - self.sl.start, self.cfg.num_patches,
             self.cfg.frontend_dim), dtype=np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticFrames:
    """An encoder's training batches (HuBERT's masked prediction, by
    `synthetic_batch`'s rule): frames ~ N(0, 1) (rows, seq_len,
    frontend_dim) f32, a mask over ~40 % of the positions, codebook
    labels ~ U[0, vocab) there and -1 elsewhere.  The labels are random,
    so no held-out loss can fall; a fixed batch's can."""

    MASK_SHARE = 0.4

    def __init__(self, data: DataConfig, cfg: ModelConfig,
                 num_hosts: int = 1, host_id: int = 0):
        self.data, self.cfg = data, cfg
        self.sl = host_slice(data.global_batch, num_hosts, host_id)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows, s = self.sl.stop - self.sl.start, self.data.seq_len
        rng = _step_rng(self.data, step, self.sl.start)
        frames = rng.standard_normal((rows, s, self.cfg.frontend_dim),
                                     dtype=np.float32)
        mask = rng.random((rows, s)) < self.MASK_SHARE
        labels = np.where(mask, rng.integers(0, self.cfg.vocab_size,
                                             (rows, s)), -1)
        return {"frames": frames, "mask": mask,
                "labels": labels.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_source(data: DataConfig, cfg: ModelConfig,
                num_hosts: int = 1, host_id: int = 0):
    """The training source of `data.source` for `cfg`'s family: token
    batches, with patch rows for a vlm (`WithPatches`); an encoder
    trains on `SyntheticFrames` whatever the source."""
    if cfg.family == "encoder":
        return SyntheticFrames(data, cfg, num_hosts, host_id)
    if data.source == "synthetic":
        src = SyntheticLM(data, cfg, num_hosts, host_id)
    elif data.source == "markov":
        src = MarkovLM(data, cfg, num_hosts, host_id)
    elif data.source == "memmap":
        src = MemmapTokens(data, cfg, num_hosts, host_id)
    else:
        raise ValueError(f"unknown data source {data.source!r}")
    if cfg.frontend == "patch":
        return WithPatches(src, data, cfg, num_hosts, host_id)
    return src


# ------------------------------------------------- non-LM synthetic batches

def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """Family-correct synthetic batch (the smoke-test / example feeder)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encoder":
        frames = rng.standard_normal((batch, seq, cfg.frontend_dim)).astype(np.float32)
        mask = rng.random((batch, seq)) < 0.4
        labels = np.where(mask, rng.integers(0, cfg.vocab_size, (batch, seq)), -1)
        return {"frames": frames, "mask": mask, "labels": labels.astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return b
