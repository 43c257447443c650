"""The detector's weights, made on the device from the run's seed.

One ``torch.randn`` call on a generator of the card draws every random
value; each tensor of the state dict then takes its share: He-normal
convolutions (fan-out) in the backbone and neck as the detector is
initialised, bilinear up-convolutions, He-normal (fan-in) convolutions
in the heads, the heatmaps' prior bias, attentive-norm affines N(1, 0.1)
and N(0, 0.1), and every BatchNorm at its identity. Two departures from
the detector's own initialisation, which starts the heads' convolutions at
N(0, 0.001): the heads' last convolutions give outputs that vary by about 1 from
pixel to pixel (see ``OUTPUT_CONVS``), so that the losses, and the gradients through them, depend on the features the
backbone computes (at 0.001 a step's loss hardly sees them); and the
dimension head's bias is a typical object's (l, h, w) in metres with a
tenth of that spread, so that the dimension loss, which divides by the
predicted dimension, does not start on a division by rounding noise near
0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

PRIOR_BIAS = -math.log((1 - 0.1) / 0.1)
# The heads' last convolutions, N(0, (gain / 5)^2 / fan_in): the
# attentive norm before them scales its output by the sum of ten
# attention weights in (0, 1) times affines near 1, about 5, so that
# their outputs vary by about the gain from pixel to pixel and the losses
# depend on the features; the dimension head's by a tenth of a metre, the
# centre offset's by 0.05 around 0.5 (its bias), so that a detection's
# 2D box centre lies in the heatmap cell it was decoded from; the depth
# head's by 0.2 around a depth of 20 m and a log variance of 0 (its
# bias), and the yaw residual's by 0.2 rad within its 30-degree bin. The
# size head's bias is a box of 8 x 6 cells.
OUTPUT_CONVS = {f"head.{name}.3.weight": 1.0 for name in (
    "heatmap_head", "kpt_heatmap_head", "wh_head",
    "kpt_heatmap_offset_head", "center2kpt_offset_head")}
OUTPUT_CONVS.update({"head.dim_head.3.weight": 0.1,
                     "head.depth_head.3.weight": 0.2,
                     "head.offset_head.3.weight": 0.05,
                     "head.dir_cls.0.weight": 1.0,
                     "head.dir_reg.0.weight": 0.2})
ATTN_SCALE = 5.0
DIM_BIAS = (3.0, 1.6, 1.4)
DEPTH_BIAS = (-math.log(20.0), 0.0)     # 1 / sigmoid(b) - 1 = 20
WH_BIAS = (8.0, 6.0)
HEATMAP_BIASES = ("head.heatmap_head.3.bias", "head.kpt_heatmap_head.3.bias")


def _bilinear(f: int) -> torch.Tensor:
    size = 2 * f
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w1d = 1.0 - torch.abs(torch.arange(size, dtype=torch.float32) / f - c)
    return w1d[:, None] * w1d[None, :]


def _std(key: str, shape) -> float:
    fan_in = math.prod(shape[1:])
    if key.endswith(("weight_", "bias_")):
        return 0.1
    if key in OUTPUT_CONVS:
        return OUTPUT_CONVS[key] / ATTN_SCALE / math.sqrt(fan_in)
    if key.startswith("head."):
        return math.sqrt(2.0 / fan_in)
    return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))


def _random(key: str, value: torch.Tensor) -> bool:
    return (key.endswith(("weight_", "bias_"))
            or (value.dim() == 4 and ".up_" not in key))


def seeded_state_dict(template: Dict[str, torch.Tensor], seed: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Values for every key of ``template`` (a state dict: names, shapes
    and dtypes), on ``device``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 64))
    total = sum(v.numel() for k, v in template.items() if _random(k, v))
    noise = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for key, ref in template.items():
        if _random(key, ref):
            n = ref.numel()
            value = noise[offset:offset + n].view(ref.shape) * _std(key, ref.shape)
            offset += n
            if key.endswith("weight_"):
                value = value + 1.0
        elif ".up_" in key:
            f = ref.shape[-1] // 2
            value = _bilinear(f).to(device).expand(ref.shape).contiguous()
        elif key.endswith("num_batches_tracked"):
            value = torch.zeros((), dtype=ref.dtype, device=device)
        elif key.endswith("running_var") or (
                key.endswith("weight") and ref.dim() == 1):
            value = torch.ones(ref.shape, device=device)
        else:
            value = torch.zeros(ref.shape, device=device)
        out[key] = value.to(ref.dtype)
    for key in HEATMAP_BIASES:
        out[key].fill_(PRIOR_BIAS)
    out["head.dim_head.3.bias"] = torch.tensor(DIM_BIAS, device=device)
    out["head.offset_head.3.bias"].fill_(0.5)
    out["head.depth_head.3.bias"] = torch.tensor(DEPTH_BIAS, device=device)
    out["head.wh_head.3.bias"] = torch.tensor(WH_BIAS, device=device)
    return out
