"""mc_tpu_torch — Monte Carlo option pricing on PyTorch and CUDA (NVIDIA H100).

The port of ``mc_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference.  This package imports ``torch`` and never ``jax`` or ``mc_tpu``.
Its kernels are CUDA C++ in ``csrc/``, built with ``nvcc`` at their first
launch; importing the package builds and loads nothing.

    from mc_tpu_torch import price, price_nmc
    price()                        # 100k-path European call on "cuda"
    price(device="cpu")            # the plain PyTorch versions
"""

from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import price
from mc_tpu_torch.nmc import price_nmc

__all__ = ["price", "price_nmc", "OptionParams", "SimParams", "DEMO_OPTION",
           "DEMO_SIM"]
