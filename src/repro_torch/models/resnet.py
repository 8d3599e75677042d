"""ResNet-50 — the paper's benchmark workload (1500 img/s on Sunrise).

Port of `repro.models.resnet`.  Two faces:
  * `resnet50_layer_specs()` — exact per-layer shapes/MACs consumed by the
    analytical Sunrise scheduler (`core/simulator.py`), copied.
  * `init_resnet50` / `resnet50_forward` — a runnable PyTorch model
    (inference-style, folded BN) on NHWC images, like the JAX function.

The convolutions run as `conv2d` in `channels_last` and the head as
`x @ fc.w`: the JAX package computes them outside any Pallas kernel.  The
JAX convolutions and max-pool pad "SAME", which for a stride-2 window on
an even input puts more padding after than before (conv1 on 224: 2
before, 3 after; a 3x3 stride-2 conv on 56: 0 before, 1 after); PyTorch's
symmetric `padding=` would give the same shapes and shifted values, so
each layer pads explicitly with `same_pads`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


# ------------------------------------------------------------- layer specs

@dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str              # "conv" | "matmul" | "pool"
    c_in: int
    c_out: int
    kh: int
    kw: int
    stride: int
    h_out: int
    w_out: int

    @property
    def macs(self) -> int:
        return self.c_in * self.c_out * self.kh * self.kw * self.h_out * self.w_out

    @property
    def weight_params(self) -> int:
        return self.c_in * self.c_out * self.kh * self.kw

    @property
    def in_elems(self) -> int:
        # Input activation volume feeding this layer (per image).
        return self.c_in * self.h_out * self.stride * self.w_out * self.stride

    @property
    def out_elems(self) -> int:
        return self.c_out * self.h_out * self.w_out

    @property
    def spatial(self) -> int:
        return self.h_out * self.w_out


STAGES = [  # (num_blocks, bottleneck_width, out_width, stride)
    (3, 64, 256, 1),
    (4, 128, 512, 2),
    (6, 256, 1024, 2),
    (3, 512, 2048, 2),
]


def resnet50_layer_specs(image_hw: int = 224) -> list[LayerSpec]:
    specs: list[LayerSpec] = []
    hw = image_hw // 2
    specs.append(LayerSpec("conv1", "conv", 3, 64, 7, 7, 2, hw, hw))
    hw = hw // 2  # maxpool /2 (no MACs)
    c_in = 64
    for si, (blocks, width, out_width, stride) in enumerate(STAGES):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            hw_out = hw // s
            p = f"s{si + 1}b{bi + 1}"
            if bi == 0:
                specs.append(LayerSpec(f"{p}.proj", "conv", c_in, out_width, 1, 1, s, hw_out, hw_out))
            specs.append(LayerSpec(f"{p}.c1", "conv", c_in, width, 1, 1, 1, hw, hw))
            specs.append(LayerSpec(f"{p}.c2", "conv", width, width, 3, 3, s, hw_out, hw_out))
            specs.append(LayerSpec(f"{p}.c3", "conv", width, out_width, 1, 1, 1, hw_out, hw_out))
            c_in = out_width
            hw = hw_out
    specs.append(LayerSpec("fc", "matmul", 2048, 1000, 1, 1, 1, 1, 1))
    return specs


def resnet50_total_macs(image_hw: int = 224) -> int:
    return sum(s.macs for s in resnet50_layer_specs(image_hw))


def resnet50_total_params() -> int:
    return sum(s.weight_params for s in resnet50_layer_specs())


# --------------------------------------------------------- runnable PyTorch

def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's "SAME" for one spatial dim: the
    output has ceil(size / stride) positions and the extra pad, if odd,
    goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, window: int, stride: int, value: float = 0.0):
    """x (B, C, H, W) padded for a SAME window (XLA's split)."""
    top, bottom = same_pads(x.shape[2], window, stride)
    left, right = same_pads(x.shape[3], window, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv_init(gen, c_in, c_out, kh, kw, device, dtype):
    fan_in = c_in * kh * kw
    w = torch.randn((c_out, c_in, kh, kw), generator=gen) * math.sqrt(2.0 / fan_in)
    return {"w": w.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last),
            "scale": torch.ones((c_out,), dtype=dtype, device=device),
            "bias": torch.zeros((c_out,), dtype=dtype, device=device)}


def _conv_apply(p, x, stride):
    w = p["w"]
    y = F.conv2d(_pad_same(x, w.shape[2], stride), w, stride=stride)
    c = y.shape[1]
    return y * p["scale"].view(1, c, 1, 1) + p["bias"].view(1, c, 1, 1)  # folded batch-norm


def init_resnet50(seed: int = 0, device=None, dtype=torch.float32,
                  num_classes: int = 1000):
    """Seeded random parameters with the reference's distributions
    (He-normal convolutions with unit scale and zero bias, fc weights
    N(0, 0.02^2)), drawn from one `torch.Generator`; conv weights are
    OIHW in `channels_last`.  Runs on CUDA unless `device` says
    otherwise."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params: dict = {"conv1": _conv_init(gen, 3, 64, 7, 7, device, dtype)}
    c_in = 64
    for si, (blocks, width, out_width, _) in enumerate(STAGES):
        for bi in range(blocks):
            blk = {
                "c1": _conv_init(gen, c_in, width, 1, 1, device, dtype),
                "c2": _conv_init(gen, width, width, 3, 3, device, dtype),
                "c3": _conv_init(gen, width, out_width, 1, 1, device, dtype),
            }
            if bi == 0:
                blk["proj"] = _conv_init(gen, c_in, out_width, 1, 1, device, dtype)
            params[f"s{si + 1}b{bi + 1}"] = blk
            c_in = out_width
    params["fc"] = {
        "w": (torch.randn((2048, num_classes), generator=gen) * 0.02).to(
            device=device, dtype=dtype),
        "b": torch.zeros((num_classes,), dtype=dtype, device=device),
    }
    return params


def resnet50_forward(params, images):
    """images: (B, H, W, 3) -> logits (B, num_classes), as the JAX
    function (NHWC in; channels_last inside)."""
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = torch.relu(_conv_apply(params["conv1"], x, 2))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, 2)
    for si, (blocks, _, _, stride) in enumerate(STAGES):
        for bi in range(blocks):
            p = params[f"s{si + 1}b{bi + 1}"]
            s = stride if bi == 0 else 1
            shortcut = _conv_apply(p["proj"], x, s) if "proj" in p else x
            y = torch.relu(_conv_apply(p["c1"], x, 1))
            y = torch.relu(_conv_apply(p["c2"], y, s))
            y = _conv_apply(p["c3"], y, 1)
            x = torch.relu(y + shortcut)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]
