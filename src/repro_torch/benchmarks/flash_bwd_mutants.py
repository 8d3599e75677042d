"""How tightly the flash backward's check holds its bf16 kernel, by mutants.

    python3 src/repro_torch/benchmarks/flash_bwd_mutants.py

Copies the port's package into a temporary directory once per mutant,
plants one fault in the copy's `kernels/csrc/flash_attention_bwd.cu` by
text substitutions, one in each bf16 design the fault applies to (the
script fails if a substitution no longer matches the source), and runs
each copy in a process of its own (each builds its own library, all at
once) over chip_smoke's backward cases (`TRAIN_FLASH_CASES`) in bf16:
* "kernel": as built;
* "dropped query step": the dK/dV kernels lose a middle query step of
  their walk (the wgmma design: the middle 64-row step of each block's
  share, its P and dS zeroed; the mma.sync design: the middle 32-row
  step, skipped);
* "dropped key tile": the dQ kernels skip the second-last 64-key tile of
  their walk (a late tile for the late query rows);
* "dropped group split": the reduce leaves the last split's f32
  partials of dK and dV out (the wgmma design only: mma.sync does not
  split the group).
For every case and gradient it prints one JSON line: the worst
|kernel - plain| / bound under the check (`tolerance.worst_ratio` with
`grad_floor`, as chip_smoke and tests/test_torch_flash_backward.py hold
it), and under an atol scaled by the head's largest |plain| alone, for
comparison.  It fails unless the kernel passes every case and each
mutant fails the check in every case its fault runs in (`planted`: the
cases' head dims, 128, 160 and 192, all run the wgmma design; the group
split's fault runs only where the group is split).  Needs one CUDA
card.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BWD = Path("repro_torch") / "kernels" / "csrc" / "flash_attention_bwd.cu"
MUTANTS = {
    "kernel": [],
    "dropped query step": [(
        "    const float* Dt = dss + s * kQ;\n",
        "    const float* Dt = dss + s * kQ;\n"
        "    if (j == n_q / 2) continue;\n"), (
        "    uint32_t pa[4][4], sa[4][4];\n",
        "    if (j == (j0 + j1) / 2)\n"
        "      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;\n"
        "    uint32_t pa[4][4], sa[4][4];\n")],
    "dropped key tile": [(
        "    if (kv0 <= warp_lim) {\n",
        "    if (kv0 <= warp_lim && j != n_kv - 2) {\n"), (
        "      if (kv0 <= wg_lim) {\n",
        "      if (kv0 <= wg_lim && j != n_kv - 2) {\n")],
    "dropped group split": [(
        "    for (int c = 0; c < splits; ++c) {\n",
        "    for (int c = 0; c < splits - 1; ++c) {\n")],
}
# the bf16 designs (ops.py `bwd_design`) each mutant plants its fault in
DESIGNS = {"dropped query step": ("wgmma", "mma_sync"),
           "dropped key tile": ("wgmma", "mma_sync"),
           "dropped group split": ("wgmma",)}


def planted(name: str, row: dict) -> bool:
    """Whether mutant `name`'s fault runs in a case's call (a printed
    row): its design carries the fault, and the split's only where the
    group is split."""
    return row["design"] in DESIGNS[name] and (
        name != "dropped group split" or row["splits"] > 1)


def mutate(text: str, name: str) -> str:
    for old, new in MUTANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"flash_bwd_mutants: {name!r}: {old!r} is not "
                             f"once in {BWD.name}")
        text = text.replace(old, new)
    return text


def child(name: str) -> int:
    """One mutant's copy (first on sys.path): every case, bf16."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fk
    from repro_torch.kernels.tolerance import (TOLERANCE, grad_floor,
                                               worst_ratio)

    if ROOT in Path(fk.__file__).resolve().parents:
        raise SystemExit("flash_bwd_mutants: the copy is not first on the "
                         "path")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)    # chip_smoke's inputs
    rtol, atol = TOLERANCE[torch.bfloat16]

    def head(w):
        return atol * w.abs().amax(dim=(1, 3), keepdim=True)
    for b, sq, skv, hq, hkv, d, causal, off, label in cs.TRAIN_FLASH_CASES:
        q, k, v, do = (torch.randn(*s, generator=g, device=dev).bfloat16()
                       for s in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d), (b, sq, hq, d)))
        kw = dict(causal=causal, q_offset=off)
        o, lse = fk.flash_attention_lse(q, k, v, **kw)
        po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
        got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
        want = fk.flash_attention_backward_plain(q, k, v, po, do, plse, **kw)
        for grad, x, y in zip(("dq", "dk", "dv"), got, want):
            err, ratio = worst_ratio(x, y, rtol, atol, floor=grad_floor)
            print(json.dumps({
                "mutant": name, "case": label, "d": d, "grad": grad,
                "design": fk.bwd_design(d), "splits": fk._bwd_splits(q, k),
                "max_abs_err": err, "worst_err_over_bound": ratio,
                "head_scaled_atol_ratio": worst_ratio(x, y, rtol, 0.0,
                                                      floor=head)[1],
                "plain_head_max": float(y.float().abs().max())}),
                flush=True)
        del q, k, v, do, o, lse, po, plse, got, want
    return 0


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    src = (ROOT / "src" / BWD).read_text()
    with tempfile.TemporaryDirectory(prefix="flash_bwd_mutants-") as tmp:
        procs = {}
        for i, name in enumerate(MUTANTS):
            copy = Path(tmp) / f"m{i}" / "src"
            shutil.copytree(ROOT / "src" / "repro_torch", copy / "repro_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            (copy / BWD).write_text(mutate(src, name))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(copy), str(ROOT)]))
            procs[name] = subprocess.Popen(
                [sys.executable, __file__, "--child", name], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        worst = {}       # mutant -> head dim -> worst ratio over its cases
        missed = []      # (mutant, case, d): a planted fault the check passed
        for name, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"flash_bwd_mutants: {name!r} failed:\n{err}")
            rows = [json.loads(line) for line in out.splitlines()]
            for row in rows:
                print(json.dumps(row), flush=True)
            worst[name] = {}
            for r in rows:
                w = worst[name].get(r["d"], 0.0)
                worst[name][r["d"]] = max(w, r["worst_err_over_bound"])
            if name == "kernel":
                continue
            # a planted fault shows in some gradient of every case it runs in
            for case in {r["case"] for r in rows if planted(name, r)}:
                got = [r for r in rows if r["case"] == case]
                if not max(r["worst_err_over_bound"] for r in got) > 1.0:
                    missed.append((name, case, got[0]["d"]))
    print(json.dumps({"worst_err_over_bound": worst}), flush=True)
    if not max(worst["kernel"].values()) <= 1.0:
        raise SystemExit("flash_bwd_mutants: the kernel as built fails")
    if missed:
        raise SystemExit(f"flash_bwd_mutants: the check passes {missed}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main())
