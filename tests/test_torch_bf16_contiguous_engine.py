"""PyTorch port vs the JAX reference in bf16: the contiguous engine,
bit for bit.  The bf16 twins of `test_contiguous_engine_matches_the_reference`
(`test_torch_contiguous_engine.py`) in "mixed" and "idle_past_max_seq"
at TINY dense, moe, hybrid and ssm: the same event streams, stats and
top position, and the same cache bits, as the reference engine, which
runs in one subprocess without excess precision
(`test_torch_bf16_parity.reference_runs`)."""
from __future__ import annotations

import functools

import numpy as np
import pytest

from test_torch_bf16_parity import ENGINE_CASES, port_run, reference_runs
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs("contiguous",
                          tmp_path_factory.mktemp("bf16_contiguous"))


@pytest.fixture(scope="module")
def port_runs(reference):
    """The port's run of a case, made once for both tests."""
    @functools.cache
    def get(family, scenario):
        return port_run(reference, "contiguous", family, scenario)
    return get


@pytest.mark.parametrize("family, scenario", ENGINE_CASES["contiguous"])
def test_contiguous_engine_matches_the_reference_in_bf16(reference, port_runs,
                                                         family, scenario):
    want = reference["runs"][(family, scenario)]
    got = port_runs(family, scenario)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # stats, pool included
    assert got[3] == want[3]
    assert got[1]["pool"]["allocated_pages"] == 0
    if scenario == "mixed":
        assert ("cancel", 1, True) in got[0]
    else:
        assert got[3] > 16                 # an idle row wrote past max_seq


@pytest.mark.parametrize("family, scenario", ENGINE_CASES["contiguous"])
def test_contiguous_engine_cache_bits_match_the_reference_in_bf16(
        reference, port_runs, family, scenario):
    want = reference["runs"][(family, scenario)][2]
    got = port_runs(family, scenario)[2]
    assert sorted(got) == sorted(want)
    for k, w in want.items():                      # the cache, bit for bit
        np.testing.assert_array_equal(got[k], w, err_msg=k)
