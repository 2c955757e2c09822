"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. With no GPU
and no explicit CPU request they raise: they never carry on silently on
the CPU, where a run would measure and serve something else.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """'cuda' (the default), 'cuda:N' or 'cpu' -> torch.device.

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions:
    the port is float32 end to end like the JAX package, and cuDNN would
    otherwise run the conv banks in TF32 (about three decimal digits)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but CUDA is not available; pass "
                "device='cpu' (--device cpu) to run on the CPU" % str(dev))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % str(dev))
    return dev
