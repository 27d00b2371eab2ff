"""Device choice for the port's entry points.

Entry points (:func:`ops.engine.init_state`, the service) run on
``cuda`` unless the caller asks for the CPU with ``device="cpu"`` —
as the CPU tests do.  When CUDA is absent and the CPU was not asked
for, they raise: the port never drifts onto the CPU by itself.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; anything else is taken as given.  A
    CUDA device without a visible card raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "riak_ensemble_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
