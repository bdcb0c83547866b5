"""Which torch device an entry point runs on.

The port is written for a CUDA card, so that is where its entry points run
unless the caller asks for the CPU: `device=None` means the card and raises
where there is none; "cpu" (or any explicit torch device) is taken as given.
The CLI reads the same choice from GSALIGN_PLATFORM (cli.select_device).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device for `device`: the CUDA card for None (RuntimeError
    without one), else torch.device(device)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device=\"cpu\" (or set "
            "GSALIGN_PLATFORM=cpu for the CLI) to run on the CPU")
    return torch.device("cuda")
