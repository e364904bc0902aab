"""Device selection and float policy of the port.

Importing this module turns TF32 off for matmul and cuDNN: a 10-bit
mantissa would break the exact integer-valued f32 sums that the host's
f64 fold relies on (ops/groupby.py precision contract).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """-> the device an entry point runs on.

    ``None`` means the current CUDA device.  There is no silent host
    fallback: without CUDA the call raises unless the caller asked for
    ``"cpu"`` explicitly (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "query on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
