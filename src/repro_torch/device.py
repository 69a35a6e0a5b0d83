"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU
(as the tests do). Asking for ``cuda`` on a host without a GPU raises:
nothing quietly carries on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for but no CUDA device is "
                "present; pass device='cpu' to run the plain versions")
        # float32 products stay full float32 on the card (TF32 keeps
        # ~3 decimal digits and would break parity with the reference)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
