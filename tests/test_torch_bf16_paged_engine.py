"""PyTorch port vs the JAX reference in bf16: the paged engine, bit for
bit.  The bf16 twins of `test_engine_streams_and_stats_match_reference`
(`test_torch_serve.py`, `test_torch_moe.py`, `test_torch_hybrid.py`) in
"chunked" and "preempt" at TINY dense, moe (grouped dispatch), hybrid
(the SSD Pallas kernel) and vlm (each request with its seeded image
rows, `test_torch_serve.image_rows`): the same event streams and stats as the
reference engine, which runs in one subprocess without excess precision
(`test_torch_bf16_parity.reference_runs`)."""
from __future__ import annotations

import pytest

from test_torch_bf16_parity import ENGINE_CASES, port_run, reference_runs
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs("paged", tmp_path_factory.mktemp("bf16_paged"))


@pytest.mark.parametrize("family, scenario", ENGINE_CASES["paged"])
def test_engine_streams_and_stats_match_reference_in_bf16(reference, family,
                                                          scenario):
    want = reference["runs"][(family, scenario)]
    got = port_run(reference, "paged", family, scenario)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # incl. peak_kv_bytes
    assert got[1]["pool"]["allocated_pages"] == 0
    if scenario == "preempt":
        assert got[1]["preemptions"] > 0
    if scenario == "chunked" and family == "dense":
        assert got[1]["prefix_store"]["reused_pages"] > 0
