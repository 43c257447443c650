"""FLOPs of the bench's forward + 3D decode as two counters see them: the
PyTorch port's ``torch.utils.flop_counter`` (what
``python -m monocon_tpu_torch.bench`` divides by its device time for
``mfu_pct``) and XLA's ``cost_analysis()`` of the JAX package's jitted
forward + decode (what the root ``bench.py`` divides by). Both count the
same DLA-34 (random weights), float32, at one canvas.

The flop counter counts 2 per multiply-add of the convolutions,
transposed convolutions and matrix products, from their shapes; XLA
counts the ops of the program it compiled (the JAX package's own layout
of the stem included), here for its CPU backend. The ratio says how far
the two packages' MFU numerators differ for the same model. The canvas
is cut from 384x1280 so that XLA compiles on a CPU in seconds. Prints one
JSON object. Run from the repo root:

  python scripts/torch_flop_ratio.py [--hw 96 320] [--batch 1]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, nargs=2, default=(96, 320))
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args()
    hw, batch = tuple(args.hw), args.batch

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from monocon_tpu.models.detector import MonoConDetector as JaxDetector
    from monocon_tpu.ops.decode import decode_predictions as jax_decode
    from monocon_tpu.utils.torch_convert import convert_state_dict
    from monocon_tpu_torch.bench import count_flops, make_forward

    model, forward, image, p2 = make_forward(34, "float32", batch,
                                             torch.device("cpu"), hw)
    torch_flops = count_flops(forward, image, p2)

    jax_model = JaxDetector(34)
    variables = convert_state_dict({k: v.numpy()
                                    for k, v in model.state_dict().items()})

    def jax_forward(variables, image, p2):
        pred = jax_model.apply(variables, image, train=False)
        return jax_decode(pred, p2, hw)

    cost = jax.jit(jax_forward).lower(
        variables, jnp.asarray(image.numpy()),
        jnp.asarray(p2.numpy())).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    xla_flops = float(cost["flops"])
    print(json.dumps({"hw": list(hw), "batch": batch,
                      "torch_flop_counter": torch_flops,
                      "xla_cost_analysis": xla_flops,
                      "ratio": torch_flops / xla_flops,
                      "jax": jax.__version__, "torch": torch.__version__,
                      "numpy": np.__version__}))


if __name__ == "__main__":
    main()
