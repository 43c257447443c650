"""MonoCon detector: DLA backbone -> DLA-Up neck -> dense heads.

Port of ``monocon_tpu/models/detector.py``. The image goes in NHWC
``(B, H, W, 3)`` and predictions come out contiguous NHWC, as in the JAX
package. Inside, the model is NCHW, held in the memory format its builder
names (``create_detector(memory_format=...)``, by default
``channels_last``). :func:`conv_memory_format` gives the one to name, from
the device, the compute dtype and whether cuDNN autotunes; the engine
names it for the process it builds in (``engine.py``):

* float32 on a CUDA device whose convolutions cuDNN autotunes (the train
  CLI's default, ``USE_BENCHMARK``): contiguous NCHW. With TF32 off its
  convolutions run on the CUDA cores, where cuDNN's fastest float32
  engines are NCHW kernels; in channels_last the autotuner picks them
  anyway, with a transpose of the input before each and of the output
  after it. The image is copied once into NCHW, and each head map once
  back into NHWC. The train-mode batch norms of one process run on the
  kernels of ``ops/batch_norm.py`` (``layers.py::BatchNorm2d``): cuDNN's
  NCHW ones are slow on wide maps of few channels.
* otherwise ``channels_last``: bfloat16's tensor-core engines are NHWC;
  without autotuning, cuDNN's heuristics pick slower float32 engines for
  NCHW than for channels_last; on the CPU the model runs as it always
  has. A contiguous NHWC tensor permuted to NCHW already is a
  channels_last tensor, so neither boundary copies.

Compute dtype. The JAX package computes in bfloat16 by giving every flax
module ``dtype=jnp.bfloat16``: convolutions (the neck's depthwise up-convs
too) take bfloat16 inputs and kernels over float32 parameters, elementwise
ops follow their inputs, BatchNorm takes float32 moments and writes
bfloat16, AttnWeights pools in float32, and the heads cast their outputs to
float32 before the post-ops. The port takes the same route through
``torch.autocast(dtype=torch.bfloat16)`` around the forward, on the CPU as
on the card: autocast casts each convolution's input and weight (cached
per forward) and leaves the parameters float32, which flax's per-module
casts also do, so no module needs a copy of its own for bfloat16. The
places where flax stays in float32 under bfloat16 do so here explicitly:
``MomentsBatchNorm`` and ``AttnWeights`` promote to float32
(``layers.py``), ``nn.BatchNorm2d`` keeps float32 statistics for a
bfloat16 input, and the heads end in ``.float()``. The two packages still
round at different places (XLA rounds a fused chain of elementwise ops
once, torch after each op; each convolution library accumulates in its
own order), so bfloat16 parity with the JAX package is held to a multiple
of the JAX package's own bfloat16-to-float32 gap
(``tests/test_torch_bf16.py``), not to float32 tolerances.

The image height split over ranks. Inside ``parallel.spatial_scope``
the forward takes this rank's band of the canvas's rows and returns the
whole-height head maps on every rank of its space group: the
convolutions exchange halo rows, the attentive norms pool over the whole
map, and the heads gather their outputs (``layers.py``, ``neck.py``,
``heads.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .dla import ARCH_SETTINGS, DLA
from .heads import PRIOR_BIAS, MonoConHeads
from .layers import AttnBatchNorm
from .neck import START_LEVEL, DLAUp, bilinear_upsample_kernel


class MonoConDetector(nn.Module):
    """DLA-``num_layers`` backbone, neck and heads. ``compute_dtype``
    float32 or bfloat16: the dtype of the forward's convolutions; the
    parameters stay float32 either way (see the module docstring)."""

    def __init__(self, num_layers: int = 34, num_classes: int = 3,
                 num_kpts: int = 9, num_alpha_bins: int = 12,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                             "bfloat16")
        channels = ARCH_SETTINGS[num_layers][2]
        self.backbone = DLA(num_layers)
        self.neck = DLAUp(channels[START_LEVEL:])
        self.head = MonoConHeads(channels[START_LEVEL], num_classes, num_kpts,
                                 num_alpha_bins)
        self.compute_dtype = compute_dtype
        self.memory_format = torch.channels_last

    def to_memory_format(self, memory_format: torch.memory_format
                         ) -> "MonoConDetector":
        """Hold the weights in ``memory_format`` (``torch.channels_last``
        or ``torch.contiguous_format``) and run the forward in it."""
        self.memory_format = memory_format
        return self.to(memory_format=memory_format)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image: (B, H, W, 3) normalised -> prediction dict at stride 4,
        float32."""
        with torch.autocast(image.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            x = image.permute(0, 3, 1, 2)
            if self.memory_format == torch.contiguous_format:
                x = x.contiguous()
            feats = self.backbone(x)
            return self.head(self.neck(feats))


def conv_memory_format(device: "str | torch.device",
                       compute_dtype: torch.dtype,
                       autotune: bool) -> torch.memory_format:
    """The memory format for a detector on ``device`` computing in
    ``compute_dtype``, where ``autotune`` says whether cuDNN autotunes the
    process's convolutions (``torch.backends.cudnn.benchmark`` as its
    owner sets it): contiguous NCHW for float32 on a CUDA device that
    autotunes, ``channels_last`` otherwise (see the module docstring)."""
    if (torch.device(device).type == "cuda"
            and compute_dtype == torch.float32 and autotune):
        return torch.contiguous_format
    return torch.channels_last


def _he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, sqrt(2 / (kh * kw * out_ch)))."""
    out_ch, _, kh, kw = w.shape
    nn.init.normal_(w, 0.0, math.sqrt(2.0 / (kh * kw * out_ch)),
                    generator=generator)


def _kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``kaiming_normal``: truncated normal on [-2, 2] std, fan-in,
    scale 2."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_detector_(model: MonoConDetector, generator: torch.Generator) -> None:
    """Initialise from the JAX package's distributions: He-normal backbone
    and neck convs, bilinear up-convs, N(0, 0.001) head convs with the
    heatmap prior bias, flax kaiming-normal attention convs, AttnBN
    affines ``weight_`` ~ N(1, 0.1) and ``bias_`` ~ N(0, 0.1)."""
    for part in (model.backbone, model.neck):
        for m in part.modules():
            if isinstance(m, nn.ConvTranspose2d):
                f = m.stride[0]
                m.weight.copy_(bilinear_upsample_kernel(f).expand_as(m.weight))
            elif isinstance(m, nn.Conv2d):
                _he_normal_(m.weight, generator)
    for name, m in model.head.named_modules():
        if isinstance(m, nn.Conv2d):
            if "attn_weights" in name:
                _kaiming_normal_(m.weight, generator)
            else:
                nn.init.normal_(m.weight, 0.0, 0.001, generator=generator)
                nn.init.zeros_(m.bias)
        elif isinstance(m, AttnBatchNorm):
            nn.init.normal_(m.weight_, 1.0, 0.1, generator=generator)
            nn.init.normal_(m.bias_, 0.0, 0.1, generator=generator)
    model.head.heatmap_head[3].bias.fill_(PRIOR_BIAS)
    model.head.kpt_heatmap_head[3].bias.fill_(PRIOR_BIAS)


def create_detector(num_layers: int = 34, num_classes: int = 3,
                    generator: Optional[torch.Generator] = None,
                    device: "str | torch.device | None" = None,
                    compute_dtype: torch.dtype = torch.float32,
                    memory_format: torch.memory_format = torch.channels_last
                    ) -> MonoConDetector:
    """A randomly initialised DLA-``num_layers`` detector (34, 46, 60 or
    102) on ``device`` (``cuda`` unless the caller names another), held in
    ``memory_format`` (see :func:`conv_memory_format`), computing in
    ``compute_dtype``. ``generator`` is a CPU ``torch.Generator``; by
    default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MonoConDetector(num_layers, num_classes,
                            compute_dtype=compute_dtype)
    init_detector_(model, generator)
    return model.to(device=device).to_memory_format(memory_format)
