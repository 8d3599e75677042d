"""PyTorch port vs the JAX reference in bf16: the speculating engine, bit
for bit.  At TINY in bf16 the port's speculative engine (dense "chunked"
at k 2 and "preempt" at k 4, moe with grouped dispatch "chunked" at k
2, all with the `self:1` draft) gives the reference speculative
engine's event streams, stats and `stats()["speculative"]`; the
reference runs in one subprocess without excess precision
(`test_torch_bf16_parity.reference_runs`).  In bf16 the verify walk's
logits are not plain decode's (another kernel rounds them), so the
streams are held against the reference's speculative engine, not
against plain decode."""
from __future__ import annotations

import pytest

from test_torch_bf16_parity import ENGINE_CASES, port_run, reference_runs


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs("speculative",
                          tmp_path_factory.mktemp("bf16_speculative"))


@pytest.mark.parametrize("family, scenario", ENGINE_CASES["speculative"])
def test_speculative_engine_matches_reference_in_bf16(reference, family,
                                                      scenario):
    want = reference["runs"][(family, scenario)]
    got = port_run(reference, "speculative", family, scenario)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # incl. "speculative"
    assert got[1]["pool"]["allocated_pages"] == 0
    assert got[1]["speculative"]["verify_calls"] > 0
    if scenario == "preempt":
        assert got[1]["preemptions"] > 0
