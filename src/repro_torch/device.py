"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Without a card they
raise instead of carrying on quietly on the CPU; a caller that wants the CPU
(the tests) asks for ``"cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the port on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
