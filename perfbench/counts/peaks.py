"""Published peaks of the card, by the name ``torch.cuda.get_device_name``
gives (NVIDIA H100 data sheet, SXM part, dense rates, at the full 700 W).
Float32 is the rate outside the tensor cores: TF32 is off in every cell."""

from __future__ import annotations

from typing import Optional

PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_flops(device_name: str, dtype: str) -> Optional[float]:
    return PEAK_FLOPS.get(device_name, {}).get(dtype)


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(device_name)
