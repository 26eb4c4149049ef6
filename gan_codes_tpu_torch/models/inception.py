"""InceptionV3 inference for IS/FID (the port of
`gan_codes_tpu/models/inception.py`).

torchvision's InceptionV3 (transform_input=False, the aux head unused at
eval), inference only, as plain functions over a parameter dict: every
BasicConv2d is a bias-free conv followed by its batch-norm folded into a
per-channel `scale` and `bias`, then ReLU. Conv weights keep torchvision's
OIHW layout; `fc` is a torch Linear (`w` [1000, 2048], `b` [1000]).
Activations are NHWC at the public functions, as in the JAX package, and
NCHW inside, where cuDNN runs every conv (`F.conv2d`).

`convert_torch_inception_state_dict` folds a torchvision `state_dict()`;
`init_inception` gives seeded random weights, so the IS/FID machinery runs
without the 100 MB pretrained file (point `load_torch_inception` at one
for scores that match the reference's).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]

POOL_DIM = 2048
NUM_CLASSES = 1000


# (name, kh, kw, cin, cout) for every BasicConv2d, in torchvision naming
# (the JAX package's `_conv_specs`, kept here so the port imports nothing
# of it).
def _conv_specs() -> List[Tuple[str, int, int, int, int]]:
    specs: List[Tuple[str, int, int, int, int]] = [
        ("Conv2d_1a_3x3", 3, 3, 3, 32),
        ("Conv2d_2a_3x3", 3, 3, 32, 32),
        ("Conv2d_2b_3x3", 3, 3, 32, 64),
        ("Conv2d_3b_1x1", 1, 1, 64, 80),
        ("Conv2d_4a_3x3", 3, 3, 80, 192),
    ]

    def inception_a(name, cin, pool_features):
        specs.extend([
            (f"{name}.branch1x1", 1, 1, cin, 64),
            (f"{name}.branch5x5_1", 1, 1, cin, 48),
            (f"{name}.branch5x5_2", 5, 5, 48, 64),
            (f"{name}.branch3x3dbl_1", 1, 1, cin, 64),
            (f"{name}.branch3x3dbl_2", 3, 3, 64, 96),
            (f"{name}.branch3x3dbl_3", 3, 3, 96, 96),
            (f"{name}.branch_pool", 1, 1, cin, pool_features),
        ])

    def inception_b(name, cin):
        specs.extend([
            (f"{name}.branch3x3", 3, 3, cin, 384),
            (f"{name}.branch3x3dbl_1", 1, 1, cin, 64),
            (f"{name}.branch3x3dbl_2", 3, 3, 64, 96),
            (f"{name}.branch3x3dbl_3", 3, 3, 96, 96),
        ])

    def inception_c(name, cin, c7):
        specs.extend([
            (f"{name}.branch1x1", 1, 1, cin, 192),
            (f"{name}.branch7x7_1", 1, 1, cin, c7),
            (f"{name}.branch7x7_2", 1, 7, c7, c7),
            (f"{name}.branch7x7_3", 7, 1, c7, 192),
            (f"{name}.branch7x7dbl_1", 1, 1, cin, c7),
            (f"{name}.branch7x7dbl_2", 7, 1, c7, c7),
            (f"{name}.branch7x7dbl_3", 1, 7, c7, c7),
            (f"{name}.branch7x7dbl_4", 7, 1, c7, c7),
            (f"{name}.branch7x7dbl_5", 1, 7, c7, 192),
            (f"{name}.branch_pool", 1, 1, cin, 192),
        ])

    def inception_d(name, cin):
        specs.extend([
            (f"{name}.branch3x3_1", 1, 1, cin, 192),
            (f"{name}.branch3x3_2", 3, 3, 192, 320),
            (f"{name}.branch7x7x3_1", 1, 1, cin, 192),
            (f"{name}.branch7x7x3_2", 1, 7, 192, 192),
            (f"{name}.branch7x7x3_3", 7, 1, 192, 192),
            (f"{name}.branch7x7x3_4", 3, 3, 192, 192),
        ])

    def inception_e(name, cin):
        specs.extend([
            (f"{name}.branch1x1", 1, 1, cin, 320),
            (f"{name}.branch3x3_1", 1, 1, cin, 384),
            (f"{name}.branch3x3_2a", 1, 3, 384, 384),
            (f"{name}.branch3x3_2b", 3, 1, 384, 384),
            (f"{name}.branch3x3dbl_1", 1, 1, cin, 448),
            (f"{name}.branch3x3dbl_2", 3, 3, 448, 384),
            (f"{name}.branch3x3dbl_3a", 1, 3, 384, 384),
            (f"{name}.branch3x3dbl_3b", 3, 1, 384, 384),
            (f"{name}.branch_pool", 1, 1, cin, 192),
        ])

    inception_a("Mixed_5b", 192, 32)
    inception_a("Mixed_5c", 256, 64)
    inception_a("Mixed_5d", 288, 64)
    inception_b("Mixed_6a", 288)
    inception_c("Mixed_6b", 768, 128)
    inception_c("Mixed_6c", 768, 160)
    inception_c("Mixed_6d", 768, 160)
    inception_c("Mixed_6e", 768, 192)
    inception_d("Mixed_7a", 768)
    inception_e("Mixed_7b", 1280)
    inception_e("Mixed_7c", 2048)
    return specs


# ---------------------------------------------------------------------------
# Initialization / conversion
# ---------------------------------------------------------------------------

def init_inception(generator: torch.Generator) -> Params:
    """Seeded random weights (for tests, or when there is no pretrained
    file), drawn on the CPU from `generator`: the JAX package's scheme, He
    normal convs with an identity fold and a uniform fc."""
    params: Params = {}
    for name, kh, kw, cin, cout in _conv_specs():
        std = math.sqrt(2.0 / (kh * kw * cout))
        params[name] = {
            "w": torch.randn((cout, cin, kh, kw), generator=generator) * std,
            "scale": torch.ones(cout),
            "bias": torch.zeros(cout),
        }
    bound = math.sqrt(1.0 / POOL_DIM)
    w = torch.rand((NUM_CLASSES, POOL_DIM), generator=generator)
    params["fc"] = {"w": w * (2 * bound) - bound,
                    "b": torch.zeros(NUM_CLASSES)}
    return params


def random_torchvision_state_dict(generator: torch.Generator
                                  ) -> Dict[str, torch.Tensor]:
    """Seeded random weights in torchvision's InceptionV3 `state_dict`
    layout (the keys `convert_torch_inception_state_dict` reads), drawn on
    the CPU from `generator`: He normal OIHW convs, BN with random running
    stats (so the fold does something), a small normal fc. Saved with
    `torch.save`, it stands in for the pretrained file."""
    sd: Dict[str, torch.Tensor] = {}
    for name, kh, kw, cin, cout in _conv_specs():
        sd[f"{name}.conv.weight"] = torch.randn(
            (cout, cin, kh, kw), generator=generator) * (
                2.0 / (kh * kw * cin)) ** 0.5
        sd[f"{name}.bn.weight"] = torch.rand((cout,), generator=generator) \
            + 0.5
        sd[f"{name}.bn.bias"] = torch.randn((cout,), generator=generator) \
            * 0.1
        sd[f"{name}.bn.running_mean"] = torch.randn(
            (cout,), generator=generator) * 0.1
        sd[f"{name}.bn.running_var"] = torch.rand(
            (cout,), generator=generator) + 0.5
    sd["fc.weight"] = torch.randn((NUM_CLASSES, POOL_DIM),
                                  generator=generator) * 0.02
    sd["fc.bias"] = torch.zeros(NUM_CLASSES)
    return sd


def convert_torch_inception_state_dict(state_dict, bn_eps: float = 1e-3
                                       ) -> Params:
    """Fold torchvision InceptionV3 conv+BN pairs into this inference
    layout (float32 on the CPU; the fold in numpy, as the JAX package
    folds, so both packages carry the same numbers)."""
    def to_np(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v, dtype=np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    params: Params = {}
    for name, *_ in _conv_specs():
        gamma = to_np(state_dict[f"{name}.bn.weight"])
        beta = to_np(state_dict[f"{name}.bn.bias"])
        mean = to_np(state_dict[f"{name}.bn.running_mean"])
        var = to_np(state_dict[f"{name}.bn.running_var"])
        scale = gamma / np.sqrt(var + bn_eps)
        params[name] = {"w": t(to_np(state_dict[f"{name}.conv.weight"])),
                        "scale": t(scale), "bias": t(beta - mean * scale)}
    params["fc"] = {"w": t(to_np(state_dict["fc.weight"])),
                    "b": t(to_np(state_dict["fc.bias"]))}
    return params


def load_torch_inception(path: str) -> Params:
    """A torchvision InceptionV3 `state_dict` file -> folded params on the
    CPU (move them with `inception_to`)."""
    return convert_torch_inception_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


def inception_to(params: Params, device: str | torch.device) -> Params:
    """The params with every tensor on `device`."""
    return {k: {n: v.to(device) for n, v in p.items()}
            for k, p in params.items()}


def params_device(params: Params) -> torch.device:
    return params["fc"]["w"].device


# ---------------------------------------------------------------------------
# Forward (NCHW inside)
# ---------------------------------------------------------------------------

def _conv_bn(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
             padding=0) -> torch.Tensor:
    """conv, the folded BN, ReLU. `padding` is an int or (pad_h, pad_w),
    symmetric; the JAX package's "SAME" occurs only on 1x1 convs (pad 0)
    and its asymmetric-looking 1x7 / 7x1 pads are (0, 3) / (3, 0)."""
    y = F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding)
    y = y * p["scale"].to(x.dtype)[:, None, None] \
        + p["bias"].to(x.dtype)[:, None, None]
    return torch.relu(y)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 2, no padding, floor mode."""
    return F.max_pool2d(x, 3, 2)


def _avg_pool_3_1_1(x: torch.Tensor) -> torch.Tensor:
    """3x3 avg pool, stride 1, pad 1, divided by 9 at the borders too
    (count_include_pad=True, torch's default)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _inception_a(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _conv_bn(p[f"{name}.branch1x1"], x)
    b5 = _conv_bn(p[f"{name}.branch5x5_2"],
                  _conv_bn(p[f"{name}.branch5x5_1"], x), padding=2)
    b3 = _conv_bn(p[f"{name}.branch3x3dbl_1"], x)
    b3 = _conv_bn(p[f"{name}.branch3x3dbl_2"], b3, padding=1)
    b3 = _conv_bn(p[f"{name}.branch3x3dbl_3"], b3, padding=1)
    bp = _conv_bn(p[f"{name}.branch_pool"], _avg_pool_3_1_1(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _conv_bn(p[f"{name}.branch3x3"], x, stride=2)
    bd = _conv_bn(p[f"{name}.branch3x3dbl_1"], x)
    bd = _conv_bn(p[f"{name}.branch3x3dbl_2"], bd, padding=1)
    bd = _conv_bn(p[f"{name}.branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _conv_bn(p[f"{name}.branch1x1"], x)
    b7 = _conv_bn(p[f"{name}.branch7x7_1"], x)
    b7 = _conv_bn(p[f"{name}.branch7x7_2"], b7, padding=(0, 3))
    b7 = _conv_bn(p[f"{name}.branch7x7_3"], b7, padding=(3, 0))
    bd = _conv_bn(p[f"{name}.branch7x7dbl_1"], x)
    bd = _conv_bn(p[f"{name}.branch7x7dbl_2"], bd, padding=(3, 0))
    bd = _conv_bn(p[f"{name}.branch7x7dbl_3"], bd, padding=(0, 3))
    bd = _conv_bn(p[f"{name}.branch7x7dbl_4"], bd, padding=(3, 0))
    bd = _conv_bn(p[f"{name}.branch7x7dbl_5"], bd, padding=(0, 3))
    bp = _conv_bn(p[f"{name}.branch_pool"], _avg_pool_3_1_1(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _conv_bn(p[f"{name}.branch3x3_1"], x)
    b3 = _conv_bn(p[f"{name}.branch3x3_2"], b3, stride=2)
    b7 = _conv_bn(p[f"{name}.branch7x7x3_1"], x)
    b7 = _conv_bn(p[f"{name}.branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _conv_bn(p[f"{name}.branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _conv_bn(p[f"{name}.branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _conv_bn(p[f"{name}.branch1x1"], x)
    b3 = _conv_bn(p[f"{name}.branch3x3_1"], x)
    b3 = torch.cat([
        _conv_bn(p[f"{name}.branch3x3_2a"], b3, padding=(0, 1)),
        _conv_bn(p[f"{name}.branch3x3_2b"], b3, padding=(1, 0)),
    ], dim=1)
    bd = _conv_bn(p[f"{name}.branch3x3dbl_1"], x)
    bd = _conv_bn(p[f"{name}.branch3x3dbl_2"], bd, padding=1)
    bd = torch.cat([
        _conv_bn(p[f"{name}.branch3x3dbl_3a"], bd, padding=(0, 1)),
        _conv_bn(p[f"{name}.branch3x3dbl_3b"], bd, padding=(1, 0)),
    ], dim=1)
    bp = _conv_bn(p[f"{name}.branch_pool"], _avg_pool_3_1_1(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, 299, 299, 3] in [0, 1] -> 2048-d pool features [B, 2048].

    The [0, 1] images go in without ImageNet normalization, as the
    reference feeds them (`evaluation/metrics.py:26-28`)."""
    x = x.permute(0, 3, 1, 2)
    x = _conv_bn(params["Conv2d_1a_3x3"], x, stride=2)
    x = _conv_bn(params["Conv2d_2a_3x3"], x)
    x = _conv_bn(params["Conv2d_2b_3x3"], x, padding=1)
    x = _max_pool(x)
    x = _conv_bn(params["Conv2d_3b_1x1"], x)
    x = _conv_bn(params["Conv2d_4a_3x3"], x)
    x = _max_pool(x)
    x = _inception_a(params, "Mixed_5b", x)
    x = _inception_a(params, "Mixed_5c", x)
    x = _inception_a(params, "Mixed_5d", x)
    x = _inception_b(params, "Mixed_6a", x)
    x = _inception_c(params, "Mixed_6b", x)
    x = _inception_c(params, "Mixed_6c", x)
    x = _inception_c(params, "Mixed_6d", x)
    x = _inception_c(params, "Mixed_6e", x)
    x = _inception_d(params, "Mixed_7a", x)
    x = _inception_e(params, "Mixed_7b", x)
    x = _inception_e(params, "Mixed_7c", x)
    return x.mean(dim=(2, 3))  # global average pool -> [B, 2048]


def inception_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, 299, 299, 3] in [0, 1] -> class logits [B, 1000]."""
    feats = inception_features(params, x)
    return feats @ params["fc"]["w"].to(feats.dtype).t() \
        + params["fc"]["b"].to(feats.dtype)
