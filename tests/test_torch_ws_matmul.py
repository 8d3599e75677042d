"""The port's weight-stationary and output-stationary matmul
(`repro_torch.kernels.ws_matmul`) against the JAX reference, and its
Hopper kernels against their plain version.

On the CPU the wrappers take the plain version; it is held against the
reference's Pallas kernels in interpret mode, as `tests/test_kernels.py`
runs them, at that file's shapes, in f32 and bf16.  Both sides sum the
same exact products in f32 (a bf16 product is exact in f32), in another
order, so they agree per element to rtol 1e-5 plus 1e-5 of the row's
largest |value| (`kernels/tolerance.py`'s rule).

Tests marked `cuda` need the card and skip without one.  JAX is imported
only by the tests that compare with it, so on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_ws_matmul.py
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.tolerance import worst_ratio
from repro_torch.kernels.ws_matmul import ops

JAX_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 512, 256),
              (384, 256, 128)]                     # (m, k, n)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CPU_TOL = (1e-5, 1e-5)


@pytest.fixture(scope="module")
def jax_ref():
    """(jax.numpy, the reference's ws_matmul ops and kernel modules)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ws_matmul import kernel, ops as jops
    return jnp, jops, kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(m, k, n, dtype, seed=0):
    """x (m, k), w (k, n) in `dtype`, from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    return x.to(dtype), w.to(dtype)


def _to_jax(jnp, t):
    """The same values in JAX (bf16 crosses through f32, exactly)."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


# ---------------------------------------------------- against the reference

@pytest.mark.parametrize("dataflow", ["ws", "os"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", JAX_SHAPES)
def test_port_matches_the_tpu_kernel_in_interpret_mode(jax_ref, m, k, n, dtype,
                                                       dataflow):
    jnp, jops, _ = jax_ref
    x, w = _inputs(m, k, n, DTYPES[dtype])
    got = getattr(ops, f"{dataflow}_matmul")(x, w)
    want = getattr(jops, f"{dataflow}_matmul")(_to_jax(jnp, x), _to_jax(jnp, w),
                                               interpret=True)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    err, ratio = worst_ratio(got, torch.from_numpy(np.array(want)), *CPU_TOL)
    assert ratio <= 1.0, (err, ratio)


TRAFFIC_CASES = [
    # (m, n, k, bm, bn, bk, bytes_per): single and many M blocks, the
    # sweep's regimes at both bk, ragged tails, f32 bytes
    (128, 22016, 8192, 128, 128, 128, 2),
    (128, 22016, 8192, 128, 128, 2048, 2),
    (1024, 22016, 8192, 128, 128, 512, 2),
    (2048, 22016, 8192, 128, 128, 2048, 2),
    (65536, 8192, 2048, 128, 128, 128, 2),
    (64, 4096, 4096, 128, 128, 4096, 4),
    (256, 4096, 4096, 128, 128, 4096, 2),
    (65536, 128, 4096, 128, 128, 128, 4),
    (300, 200, 100, 64, 64, 32, 2),
]


@pytest.mark.parametrize("case", TRAFFIC_CASES + [
    (m, n, k, 128, 128, 128, 2)
    for m, n, k in itertools.product((128, 1024), (256, 22016), (512, 8192))],
    ids=str)
def test_traffic_model_equals_the_reference_exactly(jax_ref, case):
    _, _, kernel = jax_ref
    assert ops.hbm_traffic_model(*case) == kernel.hbm_traffic_model(*case)


REFUSED = {
    "k_mismatch": ((128, 256), (128, 128), {}),
    "m_not_divisible": ((200, 128), (128, 128), {}),
    "n_not_divisible": ((128, 128), (128, 200), {}),
    "k_not_divisible": ((128, 200), (200, 128), {"block_k": 128}),
}


@pytest.mark.parametrize("dataflow", ["ws", "os"])
@pytest.mark.parametrize("name", list(REFUSED))
def test_wrappers_refuse_what_the_tpu_kernel_asserts(jax_ref, name, dataflow):
    jnp, _, kernel = jax_ref
    xs, wsh, kw = REFUSED[name]
    x, w = torch.zeros(xs), torch.zeros(wsh)
    with pytest.raises(ValueError):
        getattr(ops, f"{dataflow}_matmul")(x, w, **kw)
    with pytest.raises(AssertionError):
        getattr(kernel, f"{dataflow}_matmul_pallas")(
            jnp.zeros(xs), jnp.zeros(wsh), interpret=True, **kw)


# ------------------------------------------------------- the kernels' limits

@pytest.mark.parametrize("dtype, bk_fits, bk_refused", [
    (torch.bfloat16, 512, 1024), (torch.float32, 256, 512)])
def test_shared_memory_check_refuses_a_weight_tile_that_does_not_fit(
        dtype, bk_fits, bk_refused):
    assert ops.plan((128, 4096), (4096, 256), dtype,
                    block_k=bk_fits).smem <= ops.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        ops.plan((128, 4096), (4096, 256), dtype, block_k=bk_refused)


# the kernels' shared memory, from the layout's stated terms: a ring of
# 3 x slices (128 rows of KS + pad elements) and the weight slots (KS
# rows of 128 + pad), each already a whole number of 128-byte units
BF16_X_SLICE, BF16_W_SLICE = 128 * (64 + 8) * 2, 64 * (128 + 8) * 2
F32_X_SLICE, F32_W_SLICE = 128 * (32 + 4) * 4, 32 * (128 + 4) * 4


@pytest.mark.parametrize("dtype, dataflow, bk, want", [
    # three slots hold a tile of at most three slices, and OS's stream
    (torch.bfloat16, "ws", 128, 3 * BF16_X_SLICE + 3 * BF16_W_SLICE),
    (torch.bfloat16, "os", 128, 3 * BF16_X_SLICE + 3 * BF16_W_SLICE),
    (torch.bfloat16, "os", 2048, 3 * BF16_X_SLICE + 3 * BF16_W_SLICE),
    (torch.bfloat16, "ws", 96, 3 * BF16_X_SLICE + 3 * BF16_W_SLICE),
    (torch.bfloat16, "ws", 512, 3 * BF16_X_SLICE + 8 * BF16_W_SLICE),
    (torch.bfloat16, "ws", 640, 3 * BF16_X_SLICE + 10 * BF16_W_SLICE),
    (torch.float32, "ws", 128, 3 * F32_X_SLICE + 4 * F32_W_SLICE),
    (torch.float32, "ws", 320, 3 * F32_X_SLICE + 10 * F32_W_SLICE),
    (torch.float32, "os", 128, 3 * F32_X_SLICE + 3 * F32_W_SLICE),
], ids=str)
def test_shared_memory_is_the_ring_plus_the_weight_slots(dtype, dataflow, bk,
                                                         want):
    assert ops.plan((128, 4 * bk), (4 * bk, 256), dtype, block_k=bk,
                    dataflow=dataflow).smem == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [128, 1024])        # one M tile, and eight
def test_the_deepest_weight_tile_fits_and_one_slice_more_is_refused(dtype, m):
    ks = ops.GEO[dtype][0]
    deepest = ops.MAX_BK[dtype]
    assert deepest == {torch.bfloat16: 640, torch.float32: 320}[dtype]
    plan = lambda bk: ops.plan((m, 4 * bk), (4 * bk, 256), dtype, block_k=bk)
    assert plan(deepest).smem <= ops.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):   # whatever m is
        plan(deepest + ks)
    if dtype == torch.bfloat16:            # the sweep's deep tile still fits
        assert plan(512).smem <= ops.MAX_SMEM


@pytest.mark.parametrize("dataflow, resident", [
    ("ws", True), ("ws", False), ("os", False)])
def test_two_blocks_share_an_sm_in_bf16_at_bk_128(dataflow, resident):
    # resident: several M tiles share the weight tile; else it streams
    slots = (ops.w_slots(torch.bfloat16, 128, resident) if dataflow == "ws"
             else ops.STAGES)
    smem = ops.smem_bytes(torch.bfloat16, slots)
    assert smem == ops.plan((128, 1024), (1024, 256), torch.bfloat16,
                            dataflow=dataflow).smem
    # two blocks and their reserved shared memory fit the SM's 228 KB ...
    assert 2 * (smem + 1024) <= 228 * 1024 < 3 * (smem + 1024)
    # ... and two run there where the sums stay in registers; WS's
    # read-modify-write kernel is bounded to one by its registers
    assert ops.blocks_per_sm(smem, resident) == (1 if resident else 2)


def test_deep_resident_tiles_leave_one_block_per_sm_by_shared_memory():
    for dtype, bk in ((torch.bfloat16, 256), (torch.bfloat16, 640),
                      (torch.float32, 128)):
        smem = ops.smem_bytes(dtype, ops.w_slots(dtype, bk, resident=True))
        assert 2 * (smem + 1024) > 228 * 1024, (dtype, bk)
        assert ops.blocks_per_sm(smem) == 1, (dtype, bk)
    # a weight tile with one M tile streams: two blocks at any bk
    assert ops.blocks_per_sm(ops.smem_bytes(
        torch.bfloat16, ops.w_slots(torch.bfloat16, 640, resident=False))) == 2


def test_a_2048_deep_bf16_weight_tile_is_refused_on_every_device():
    # the reference sweep's "full-k" tile: 2048 x 128 bf16 is 512 KB, a block
    # has 227 KB; the wrapper raises rather than shrink the block, on
    # the CPU path too, while the output-stationary kernel holds no
    # weight tile and takes it
    x, w = _inputs(128, 2048, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="2048 x 128"):
        ops.ws_matmul(x, w, block_k=2048)
    assert ops.os_matmul(x, w, block_k=2048).shape == (128, 128)
    assert ops.plan((128, 2048), (2048, 128), torch.bfloat16,
                    block_k=2048, dataflow="os").smem <= ops.MAX_SMEM


@pytest.mark.parametrize("blocks", [(256, 128), (128, 256)])
def test_blocks_larger_than_the_register_tile_are_refused(blocks):
    x, w = _inputs(256, 128, 256, torch.float32)
    with pytest.raises(ValueError, match="registers"):
        ops.ws_matmul(x, w, block_m=blocks[0], block_n=blocks[1])


@pytest.mark.parametrize("m_tiles, n_tiles, want", [
    (1, 172, 1),        # decode b=16: one M tile
    (8, 172, 3),        # decode b=128: 516 blocks, 4 waves of 132
    (16, 172, 3),       # prefill chunk
    (512, 64, 2),       # train mlp: 128 blocks, one wave
    (3, 1, 3),          # more SMs than tiles: one M tile per block
    (5, 66, 2),         # 132 blocks of 3 and 2 M tiles
])
def test_ws_splits_fill_the_card_with_disjoint_output_tiles(m_tiles, n_tiles,
                                                            want):
    # one read-modify-write block per SM, 132 SMs
    s = ops.ws_splits(m_tiles, n_tiles, 132)
    assert s == want
    per = -(-m_tiles // s)
    assert (s - 1) * per < m_tiles <= s * per        # no block is empty


@pytest.mark.parametrize("sms", [132, 114])       # H100 SXM, H100 PCIe
@pytest.mark.parametrize("m_tiles, n_tiles", [(8, 172), (16, 172), (512, 64)])
def test_ws_splits_leave_no_partial_last_wave(m_tiles, n_tiles, sms):
    # one read-modify-write block per SM: a wave is `sms` blocks
    def fill(s):                       # the share of the waves' slots used
        blocks = n_tiles * s
        return blocks / (-(-blocks // sms) * sms)

    s = ops.ws_splits(m_tiles, n_tiles, sms)
    launched = [-(-m_tiles // -(-m_tiles // t)) for t in range(1, m_tiles + 1)]
    assert s in launched
    if sms == 132:            # the sweep's regimes leave no partial wave here
        blocks = n_tiles * s
        assert blocks - (-(-blocks // sms) - 1) * sms >= 0.9 * sms, blocks
    # the least S that fills its waves to 90 %, or else the fullest
    full = [t for t in launched if fill(t) >= 0.9]
    assert s == (min(full) if full else
                 min(launched, key=lambda t: (-fill(t), t)))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = (ops.WS.launches, ops.OS.launches)
    x, w = _inputs(128, 256, 128, torch.bfloat16)
    for fn in (ops.ws_matmul, ops.os_matmul):
        out = fn(x, w)
        assert out.dtype == torch.float32
        assert torch.equal(out, ops.matmul_plain(x, w))
    assert (ops.WS.launches, ops.OS.launches) == before


class OtherDevice:
    """A tensor's stand-in on a device the wrappers neither launch on nor
    take the plain version on ("meta" takes the plain version, as the
    dry-run's traces run on it)."""
    device = torch.device("xpu")
    dtype = torch.float32
    shape = (128, 128)


def test_other_devices_are_refused():
    x = OtherDevice()
    for fn in (ops.ws_matmul, ops.os_matmul):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(x, x)


# ------------------------------------------------------------- on the card

CARD_SHAPES = JAX_SHAPES + [
    (100, 36, 60),          # ragged bm, bn, bk: zero-filled, element loads
    (1024, 512, 22016),     # 8 M tiles, 2 blocks per n tile: read-modify-write
]


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["ws", "os"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, m, k, n, dtype, dataflow):
    x, w = (t.to(cuda_device) for t in _inputs(m, k, n, DTYPES[dtype]))
    before = getattr(ops, dataflow.upper()).launches
    got = getattr(ops, f"{dataflow}_matmul")(x, w)
    torch.cuda.synchronize()
    assert getattr(ops, dataflow.upper()).launches == before + 1
    err, ratio = worst_ratio(got, ops.matmul_plain(x, w),
                             *ops.TOLERANCE[DTYPES[dtype]])
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ws_with_a_deep_weight_tile_matches_plain_on_card(cuda_device, dtype):
    bk = 512 if dtype == "bf16" else 256
    x, w = (t.to(cuda_device) for t in _inputs(1024, 2048, 2048, DTYPES[dtype]))
    got = ops.ws_matmul(x, w, block_k=bk)
    err, ratio = worst_ratio(got, ops.matmul_plain(x, w),
                             *ops.TOLERANCE[DTYPES[dtype]])
    assert ratio <= 1.0, (err, ratio)


# (m, k, n, bk) for WS, with OS beside it (it takes no bk).  n 8448 is
# 66 n tiles: 5 M tiles split 3 + 2 over two blocks that share each
# weight tile; n 256 leaves one M tile per block, whose weights stream
RING_CASES = [
    (640, 64, 8448, 64),        # fewer slices than ring stages
    (640, 36, 8448, 36),        # unaligned k (bf16: element copies)
    (128, 64, 256, 64),
    (640, 384, 8448, 96),       # bk no multiple of the bf16 slice
    (640, 256, 8448, 128),      # several M tiles, uneven last split
    (128, 8192, 256, 128),       # one M tile streams the weights
    (128, 8192, 256, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,bk", RING_CASES + [(640, None, 8448, None)],
                         ids=str)
def test_the_ring_matches_plain_on_card(cuda_device, m, k, n, bk, dtype):
    if bk is None:           # the deepest tile WS takes, several M tiles
        bk = ops.MAX_BK[DTYPES[dtype]]
        k = 2 * bk
    x, w = (t.to(cuda_device) for t in _inputs(m, k, n, DTYPES[dtype]))
    want = ops.matmul_plain(x, w)
    for got in (ops.ws_matmul(x, w, block_k=bk), ops.os_matmul(x, w)):
        torch.cuda.synchronize()
        err, ratio = worst_ratio(got, want, *ops.TOLERANCE[DTYPES[dtype]])
        assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(128, 8192, 256), (640, 256, 8448)])
def test_ws_and_os_agree_bit_for_bit_at_one_and_at_several_m_tiles(
        cuda_device, m, k, n, dtype):
    x, w = (t.to(cuda_device) for t in _inputs(m, k, n, DTYPES[dtype]))
    first = ops.ws_matmul(x, w)
    assert torch.equal(first, ops.ws_matmul(x, w))
    assert torch.equal(first, ops.os_matmul(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_tile_past_the_deepest_is_refused_on_card(cuda_device, dtype):
    bk = ops.MAX_BK[DTYPES[dtype]] + ops.GEO[DTYPES[dtype]][0]
    x, w = (t.to(cuda_device) for t in _inputs(128, 2 * bk, 256,
                                                DTYPES[dtype]))
    with pytest.raises(ValueError, match="shared memory"):
        ops.ws_matmul(x, w, block_k=bk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ws_and_os_kernels_agree_bit_for_bit_and_rerun_identically(
        cuda_device, dtype):
    # both walk k in the same slices with the same arithmetic; WS reloads
    # its sums from the output between k-tiles, which loses nothing
    x, w = (t.to(cuda_device) for t in _inputs(1024, 512, 22016, DTYPES[dtype]))
    first = ops.ws_matmul(x, w)
    assert torch.equal(first, ops.ws_matmul(x, w))
    assert torch.equal(first, ops.os_matmul(x, w))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, w = _inputs(128, 128, 128, torch.float32)
    x, w = x.to(cuda_device), w.to(cuda_device)
    for fn in (ops.ws_matmul, ops.os_matmul):
        with pytest.raises(ValueError, match="one dtype"):
            fn(x, w.to(torch.bfloat16))
        with pytest.raises(ValueError, match="one dtype"):
            fn(x.half(), w.half())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, w.t())
