"""PyTorch/CUDA port of the MoE-GPS serving stack.

The package mirrors ``src/repro/`` module for module (configs, models,
moe, core, serve, train, obs, kernels, bridge) and imports only ``torch``
and ``numpy``. Entry points take an explicit ``device`` that defaults to
``"cuda"``; without a card they raise unless the caller asks for the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
