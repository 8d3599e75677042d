"""The port's ResNet-50 (`repro_torch.models.resnet`) against the JAX
package's: layer specs, MACs and parameter counts exactly; logits of the
full-depth forward (all 53 convolutions) with the reference's parameters
carried across (`models/convert.resnet_params_from_jax`).

Logits are held to |port - jax| <= 1e-5 x max |jax logit|: both sides
run f32 convolutions on the CPU, summing the same products in another
order.  The images are 32 x 32 (even: every stride-2 SAME window pads
more after than before, so a symmetric pad shifts the values) and 33 x
33 (odd: SAME pads symmetrically there), at batch 2.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as JR
from repro_torch.models import resnet as PR
from repro_torch.models.convert import resnet_params_from_jax

LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    """(the reference's ResNet-50 params, the same carried to the port)."""
    params = JR.init_resnet50(jax.random.key(0))
    return params, resnet_params_from_jax(jax.tree.map(np.asarray, params),
                                          "cpu")


@pytest.mark.parametrize("image_hw", [224, 32, 33, 64])
def test_layer_specs_macs_and_params_equal_the_reference(image_hw):
    got, want = PR.resnet50_layer_specs(image_hw), JR.resnet50_layer_specs(image_hw)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s)
                                                   for s in want]
    assert [(s.macs, s.in_elems, s.out_elems, s.spatial) for s in got] == [
        (s.macs, s.in_elems, s.out_elems, s.spatial) for s in want]
    assert PR.resnet50_total_macs(image_hw) == JR.resnet50_total_macs(image_hw)
    assert PR.resnet50_total_params() == JR.resnet50_total_params()
    assert PR.STAGES == JR.STAGES


@pytest.mark.parametrize("size", [32, 33, 56, 112, 224, 7, 1])
@pytest.mark.parametrize("window, stride", [(7, 2), (3, 2), (3, 1), (1, 2),
                                            (1, 1)])
def test_same_pads_equal_xla(size, window, stride):
    want = jax.lax.padtype_to_pads((size,), (window,), (stride,), "SAME")
    assert PR.same_pads(size, window, stride) == tuple(want[0])


@pytest.mark.parametrize("image_hw", [32, 33])
def test_full_depth_logits_equal_the_reference(jax_params, image_hw):
    jp, pp = jax_params
    images = np.random.default_rng(image_hw).standard_normal(
        (2, image_hw, image_hw, 3)).astype(np.float32)
    want = np.asarray(JR.resnet50_forward(jp, jnp.asarray(images)))
    with torch.inference_mode():
        got = PR.resnet50_forward(pp, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 1000)
    err = np.abs(got - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), (err, np.abs(want).max())


def test_converter_carries_hwio_to_oihw_exactly(jax_params):
    jp, pp = jax_params
    assert set(pp) == set(jp)
    for name, blk in jp.items():
        convs = {"": blk} if name in ("conv1", "fc") else blk
        for cname, p in convs.items():
            q = pp[name] if not cname else pp[name][cname]
            if name == "fc":
                for k in ("w", "b"):
                    assert np.array_equal(q[k].numpy(), np.asarray(p[k]))
                continue
            assert q["w"].is_contiguous(memory_format=torch.channels_last)
            assert np.array_equal(q["w"].permute(2, 3, 1, 0).numpy(),
                                  np.asarray(p["w"]))
            for k in ("scale", "bias"):
                assert np.array_equal(q[k].numpy(), np.asarray(p[k]))


def test_init_follows_the_reference_distributions(jax_params):
    jp, _ = jax_params
    params = PR.init_resnet50(0, "cpu")
    again = PR.init_resnet50(0, "cpu")
    assert set(params) == set(jp)
    for name, blk in params.items():
        convs = {"": blk} if name in ("conv1", "fc") else blk
        for cname, p in convs.items():
            ref = jp[name] if not cname else jp[name][cname]
            same = again[name] if not cname else again[name][cname]
            for k in p:
                assert torch.equal(p[k], same[k])             # seeded
            if name == "fc":
                assert tuple(p["w"].shape) == ref["w"].shape
                assert abs(p["w"].std().item() - 0.02) < 0.002
                assert not p["b"].any()
                continue
            kh, kw, c_in, c_out = ref["w"].shape
            assert tuple(p["w"].shape) == (c_out, c_in, kh, kw)
            std = (2.0 / (c_in * kh * kw)) ** 0.5
            assert abs(p["w"].std().item() / std - 1) < 0.2
            assert torch.equal(p["scale"], torch.ones(c_out))
            assert not p["bias"].any()


def test_init_wants_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.init_resnet50(0)


def test_bf16_forward_keeps_bf16_and_stays_finite():
    params = PR.init_resnet50(3, "cpu", torch.bfloat16)
    images = torch.randn(1, 40, 40, 3).to(torch.bfloat16)
    with torch.inference_mode():
        logits = PR.resnet50_forward(params, images)
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 1000)
    assert torch.isfinite(logits.float()).all()
