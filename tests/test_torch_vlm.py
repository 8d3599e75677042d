"""The port's vlm family (phi-3-vision) against the JAX reference on the
CPU, at TINY["vlm"] (2 layers, 8 patch rows of 32 features), f32.

Training: the forward's logits and `loss_fn`'s loss (image positions
labelled -1) to 1e-5, every gradient leaf against `jax.value_and_grad`
to atol 1e-5 / rtol 1e-4, under remat "none" and "full".  Serving: one
paged prefill chunk of 8 per row that crosses the patch/text boundary
(logits and arena to 1e-5 against the reference's `vlm.paged_prefill`
under its flash_xla oracles); the engine's greedy event streams and
stats byte-identical with the reference engine's on the paged layout
(chunk 8 with prefix sharing, preemption, fork and cancel) and the
contiguous one, the pool drained; `LLMServer.generate` with
`patch_embeds`; the refusal of a request without its patch rows; and
prompt pages shared under the same image and text, never when only the
image differs.  The bf16 engine is held bit for bit in
`test_torch_bf16_paged_engine.py` (its "vlm" cases).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.models import transformer as JT
from repro.models import vlm as JV
from repro.serve import ServingEngine as JaxEngine
from repro.serve.api import LLMServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.models import registry
from repro_torch.models import transformer as PT
from repro_torch.models import vlm as PV
from repro_torch.serve.api import LLMServer
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_contiguous_engine import _drive as contiguous_drive
from test_torch_serve import (_drive, _prompts, _scenario, image_rows,
                              with_images)
from test_torch_train_families import _port_loss_and_grads
from test_torch_train_parity import (_batch, _port_batch, _ref_loss_and_grads,
                                     _ref_params)
from torch_port_helpers import params_to_numpy, port_cfg, port_params

VLM = TINY["vlm"]
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def vlm():
    params = _ref_params(VLM)
    return params, port_params(params, VLM)


# ---------------------------------------------------------------- weights

def test_params_cross_both_ways_bit_exact(vlm):
    """`img_proj` and every transformer leaf arrive as the reference's
    bits and go back unchanged."""
    jp, pp = vlm
    assert sorted(pp) == sorted(jp) == ["embed", "head", "img_proj",
                                        "layers", "ln_f"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jp)))
    back = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(pp, VLM)))
    assert sorted(back, key=str) == sorted(want, key=str)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))
    seeded = PV.init(0, port_cfg(VLM), "cpu")
    for name in ("w1", "w2"):
        assert seeded["img_proj"][name].shape == pp["img_proj"][name].shape


# --------------------------------------------------------------- training

def test_forward_logits_match_the_reference(vlm):
    jp, pp = vlm
    batch = _batch(VLM)
    want = JV.forward(jp, VLM, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = PV.forward(pp, port_cfg(VLM), _port_batch(batch))
    assert got.shape == (4, VLM.num_patches + 32, VLM.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.fixture(scope="module")
def reference_gradients(vlm):
    """The reference's loss and gradients, once: its remat changes no
    value, so the port's "none" and "full" are held to the same ones."""
    batch = _batch(VLM)
    return (batch,) + _ref_loss_and_grads(VLM, vlm[0], batch)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_the_reference(vlm, reference_gradients,
                                                remat):
    cfg = VLM.replace(remat=remat)
    batch, l_ref, g_ref = reference_gradients
    l_port, g_port = _port_loss_and_grads(cfg, vlm[0], batch)
    assert l_port == pytest.approx(l_ref, abs=1e-5)
    assert sorted(g_port) == sorted(g_ref)
    assert "params/img_proj/w1" in g_port
    for name, want in g_ref.items():
        np.testing.assert_allclose(g_port[name], want, **GRAD, err_msg=name)


# --------------------------------------------------------- paged prefill

def test_paged_chunk_across_the_patch_boundary_matches_the_reference(vlm):
    """Two chunks of 8: the first from position 0 (row 0 stops inside
    the image), the second continuing each row across the boundary at
    position num_patches = 8 (row 2 wholly in the text, row 3 inert)."""
    jp, pp = vlm
    pc = port_cfg(VLM)
    page, P, mp, b, c = 8, 12, 4, 4, 8
    rng = np.random.default_rng(5)
    bt = np.full((b, mp), P, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    for i, n in enumerate((2, 2, 3, 0)):
        bt[i, :n] = perm[3 * i:3 * i + n]
    j_arena = JT.init_paged_cache(VLM, P + 1, page)
    t_arena = PT.init_paged_cache(pc, P + 1, page, device="cpu")
    j_prefill = jax.jit(JV.paged_prefill, static_argnums=1)
    for start, clen in ((np.array([0, 0, 0, 0]), np.array([5, 8, 8, 0])),
                        (np.array([5, 8, 8, 0]), np.array([8, 6, 8, 0]))):
        tokens = rng.integers(0, VLM.vocab_size, (b, c)).astype(np.int32)
        patches = rng.standard_normal(
            (b, c, VLM.frontend_dim)).astype(np.float32)
        j_arena, jl = j_prefill(
            jp, VLM, {"tokens": jnp.asarray(tokens),
                      "patches": jnp.asarray(patches)},
            j_arena, jnp.asarray(bt), jnp.asarray(start, jnp.int32),
            jnp.asarray(clen, jnp.int32))
        t_arena, tl = PV.paged_prefill(
            pp, pc, {"tokens": torch.from_numpy(tokens),
                     "patches": torch.from_numpy(patches)},
            t_arena, torch.from_numpy(bt),
            torch.from_numpy(start.astype(np.int32)),
            torch.from_numpy(clen.astype(np.int32)))
        live = clen > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **F32)
    for name in ("k", "v"):                       # the null slot is garbage
        np.testing.assert_allclose(t_arena[name][:, :P].numpy(),
                                   np.asarray(j_arena[name])[:, :P], **F32)


# ----------------------------------------------------------------- engine

def _vlm_scenario(name):
    """`test_torch_serve._scenario`'s, with "fork_cancel_budget"'s script
    two steps later: the 8 image rows lengthen request 0's prefill, and
    a fork needs its parent decoding."""
    kw, script = _scenario(name, VLM.vocab_size)
    if name == "fork_cancel_budget":
        script = {s + 2 if s else s: acts for s, acts in script.items()}
    return kw, script


@pytest.mark.parametrize("name", ["chunked", "preempt",
                                  "fork_cancel_budget"])
def test_paged_engine_streams_and_stats_match_reference(vlm, name):
    jp, pp = vlm
    kw, script = _vlm_scenario(name)
    want = _drive(JaxEngine(VLM, jp, **kw), JaxRequest, script)
    got = _drive(ServingEngine(port_cfg(VLM), pp, device="cpu", **kw),
                 Request, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]
    assert got[1]["pool"]["allocated_pages"] == 0
    if name == "preempt":
        assert got[1]["preemptions"] > 0
    if name == "chunked":
        # request 4 repeats request 0's image and its first 32 tokens
        assert got[1]["prefix_store"]["reused_pages"] > 0
    if name == "fork_cancel_budget":                  # both forks streamed
        assert {e[1] for e in got[0] if e[0] == "token"} >= {10, 11}


def test_contiguous_engine_streams_and_cache_match_reference(vlm):
    """Three requests (one sampled) in two rows, one cancelled while a
    later one waits."""
    jp, pp = vlm
    ps = _prompts(21, (9, 23, 12), VLM.vocab_size)
    kw = dict(max_batch=2, max_seq=48, layout="contiguous")
    script = {0: [("submit", i, p, 6, i == 1) for i, p in enumerate(ps)],
              3: [("cancel", 0)]}
    want = contiguous_drive(JaxEngine(VLM, jp, **kw),
                            with_images(JaxRequest, VLM), JaxSP, script)
    got = contiguous_drive(ServingEngine(port_cfg(VLM), pp, device="cpu",
                                         **kw),
                           with_images(Request, VLM), SamplingParams, script)
    assert got[0] == want[0]
    assert got[1] == want[1]                       # stats, pool included
    assert got[1]["pool"]["allocated_pages"] == 0
    assert ("cancel", 0, True) in got[0]
    for k, w in want[2].items():
        np.testing.assert_allclose(got[2][k], w, **F32, err_msg=k)


def test_llm_server_generate_with_patch_rows_matches_reference(vlm):
    jp, pp = vlm
    ps = _prompts(8, (19, 6), VLM.vocab_size)

    def serve(server_cls, sp_cls, params, cfg, **kw):
        server = server_cls(cfg, params, max_batch=4, max_seq=64,
                            page_size=8, prefill_chunk=16, **kw)
        streams = [server.generate(p, sp_cls(max_new_tokens=6),
                                   patch_embeds=image_rows(VLM, i))
                   for i, p in enumerate(ps)]
        next(streams[0])
        child = streams[0].fork(sp_cls(max_new_tokens=8))
        server.run()
        return ([s.drain().tokens for s in streams + [child]],
                server.stats["pool"]["allocated_pages"])

    want = serve(JaxServer, JaxSP, jp, VLM)
    got = serve(LLMServer, SamplingParams, pp, port_cfg(VLM), device="cpu")
    assert got == want
    assert got[1] == 0


@pytest.mark.parametrize("rows", [None, 3])
def test_a_request_without_its_patch_rows_is_refused(vlm, rows):
    _, pp = vlm
    eng = ServingEngine(port_cfg(VLM), pp, device="cpu", max_batch=1,
                        max_seq=64, page_size=8)
    pe = (None if rows is None
          else np.zeros((rows, VLM.frontend_dim), np.float32))
    with pytest.raises(ValueError, match="patch_embeds with 8 rows"):
        eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                           patch_embeds=pe))


@pytest.mark.parametrize("same_image", [True, False])
def test_prompt_pages_are_shared_only_under_the_same_image(vlm, same_image):
    """Two requests with one text: under one image their full prompt
    pages (the image's and the text's) are one set; under two images no
    page is shared and the prefix store reuses nothing."""
    _, pp = vlm
    eng = ServingEngine(port_cfg(VLM), pp, device="cpu", max_batch=2,
                        max_seq=64, page_size=8, prefill_chunk=32)
    text = _prompts(9, (20,), VLM.vocab_size)[0]
    images = [image_rows(VLM, 0), image_rows(VLM, 0 if same_image else 1)]
    for uid, img in enumerate(images):
        eng.submit(Request(uid=uid, prompt=text.copy(), patch_embeds=img,
                           max_new_tokens=4))
    eng.step()
    tables = [s.pages.pages for s in eng.slots.values()]
    shared = set(tables[0]) & set(tables[1])
    res = {r.uid: r.tokens for r in eng.run()}
    if same_image:
        # (8 + 20 - 1) // 8 = 3 full prompt pages adopted
        assert len(shared) == 3
        assert res[0] == res[1]
    else:
        assert not shared
        assert eng.stats()["prefix_store"]["reused_pages"] == 0
    assert eng.pool.stats().allocated_pages == 0


def test_registry_resolves_every_family():
    from repro_torch.models import encoder, hybrid, mamba2, moe, transformer
    want = {"dense": transformer, "moe": moe, "ssm": mamba2,
            "hybrid": hybrid, "encoder": encoder, "vlm": PV}
    for family, mod in want.items():
        assert registry.get_family(port_cfg(TINY[family])) is mod
    assert registry.has_paged(port_cfg(VLM))
    assert not registry.has_verify(port_cfg(VLM))
    assert not registry.has_decode(port_cfg(TINY["encoder"]))
