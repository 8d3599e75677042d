"""The port's encoder family (hubert-xlarge) against the JAX reference on
the CPU, at TINY["encoder"] (2 layers, non-causal, no rope, gelu, 48
frame features), f32.

The same numpy batch (frames, mask, labels) goes through the reference
(`jax.value_and_grad` over `repro.models.encoder.loss_fn`, its
flash_xla attention) and the port, with the reference's init carried
across bit-exact: the logits and loss to 1e-5, every gradient leaf to
atol 1e-5 / rtol 1e-4, with the batch's mask and with the mask left to
default to `labels >= 0`, through the port's "flash_xla" path and its
"flash_pallas" one (`FlashAttentionFn`, whose plain version runs here:
the route the card takes through the flash kernels, forward and
backward).  One AdamW step gives the reference's params.  The engine
and `launch.serve` refuse the family as the reference does.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.models import encoder as JE
from repro.serve import ServingEngine as JaxEngine
from repro.train import optimizer as JO
from repro_torch.models import encoder as PE
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import optimizer as PO
from test_torch_train_families import _port_loss_and_grads
from test_torch_train_parity import (_assert_params_equal, _batch, _opt_cfg,
                                     _port_batch, _port_steps,
                                     _ref_loss_and_grads, _ref_params,
                                     _ref_steps)
from torch_port_helpers import params_to_numpy, port_cfg, port_params

ENC = TINY["encoder"]
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def enc():
    params = _ref_params(ENC)
    return params, port_params(params, ENC)


def _masked(batch, explicit: bool):
    """The batch with its mask, or without it (the loss then masks the
    labelled positions)."""
    return dict(batch) if explicit else {k: v for k, v in batch.items()
                                         if k != "mask"}


@functools.lru_cache(maxsize=None)
def _reference(explicit: bool):
    """(batch, loss, gradients) of the reference, once per mask mode."""
    jp = _ref_params(ENC)
    batch = _masked(_batch(ENC), explicit)
    return (batch,) + _ref_loss_and_grads(ENC, jp, batch)


def test_params_cross_both_ways_bit_exact(enc):
    jp, pp = enc
    assert sorted(pp) == sorted(jp) == ["head", "in_proj", "layers", "ln_f",
                                        "mask_emb"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jp)))
    back = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(pp, ENC)))
    assert sorted(back, key=str) == sorted(want, key=str)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))
    seeded = PE.init(0, port_cfg(ENC), "cpu")
    assert {k: tuple(v.shape) for k, v in seeded.items() if k != "layers"} \
        == {k: tuple(v.shape) for k, v in pp.items() if k != "layers"}


@pytest.mark.parametrize("attention_impl", ["flash_xla", "flash_pallas"])
@pytest.mark.parametrize("explicit", [True, False])
def test_logits_match_the_reference(enc, explicit, attention_impl):
    jp, pp = enc
    batch = _masked(_batch(ENC), explicit)
    want = JE.forward(jp, ENC, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = port_cfg(ENC.replace(attention_impl=attention_impl))
    with torch.no_grad():
        got = PE.forward(pp, pcfg, _port_batch(batch))
    assert got.shape == (4, 32, ENC.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("attention_impl", ["flash_xla", "flash_pallas"])
@pytest.mark.parametrize("explicit", [True, False])
def test_loss_and_gradients_match_the_reference(enc, explicit,
                                                attention_impl):
    jp, _ = enc
    batch, l_ref, g_ref = _reference(explicit)
    l_port, g_port = _port_loss_and_grads(
        ENC, jp, batch, port_cfg(ENC.replace(attention_impl=attention_impl)))
    assert l_port == pytest.approx(l_ref, abs=1e-5)
    assert sorted(g_port) == sorted(g_ref)
    for name in ("params/in_proj", "params/mask_emb", "params/head"):
        assert np.abs(g_port[name]).max() > 0, name
    for name, want in g_ref.items():
        np.testing.assert_allclose(g_port[name], want, **GRAD, err_msg=name)


def test_the_default_mask_is_the_labelled_positions(enc):
    """Without a mask the loss masks exactly the positions with a label:
    the same loss as the batch whose mask is `labels >= 0`."""
    _, pp = enc
    batch = _batch(ENC)
    pcfg = port_cfg(ENC)
    with torch.no_grad():
        default = PE.loss_fn(pp, pcfg, _port_batch(_masked(batch, False)))
        labelled = PE.loss_fn(pp, pcfg, _port_batch(
            dict(batch, mask=np.asarray(batch["labels"]) >= 0)))
    assert float(default) == float(labelled)


def test_one_adamw_step_gives_the_reference_params():
    batches = [_batch(ENC)]
    ref_opt = JO.make_optimizer(_opt_cfg("adamw", JO.OptimizerConfig))
    ref_state, ref_losses = _ref_steps(ENC, ref_opt, batches)
    params = _ref_params(ENC)
    port_opt = PO.make_optimizer(_opt_cfg("adamw", PO.OptimizerConfig))
    port_state, port_losses = _port_steps(ENC, port_opt, batches, params)
    np.testing.assert_allclose(port_losses, ref_losses, atol=1e-5)
    _assert_params_equal(port_state, ref_state)


def test_the_engine_refuses_the_family_as_the_reference_does(enc):
    jp, pp = enc
    with pytest.raises(ValueError, match="cannot serve") as ref:
        JaxEngine(ENC, jp)
    with pytest.raises(ValueError, match="cannot serve") as got:
        ServingEngine(port_cfg(ENC), pp, device="cpu")
    assert str(got.value) == str(ref.value)


def test_launch_serve_refuses_the_encoder():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="encoder-only: nothing to serve"):
        main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
