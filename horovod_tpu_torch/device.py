"""Device resolution for the port's entry points.

``device=None`` means the CUDA card. Without one it raises: the port
never moves to the CPU on its own. The CPU is used only when a caller
asks for it (``device="cpu"``), as the tests do.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises when no card is present); anything
    else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
