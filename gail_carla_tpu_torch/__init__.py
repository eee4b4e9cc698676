"""gail_carla_tpu_torch — the PyTorch and CUDA port of ``gail_carla_tpu``
for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module
paths (``sim/env.py``, ``ops/bev.py``, ``models/policy.py`` ...) with
batch-native tensor code and hand-written CUDA kernels under ``csrc/``.
It imports torch and numpy only. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
