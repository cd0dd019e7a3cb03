"""Device selection for the port's entry points.

`GPT`, `generate` and `ServeEngine` run on the card by default; asking
for "cuda" where no GPU is present raises instead of quietly running on
the CPU, and the message names `device="cpu"` as the way to ask for it.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is available; "
            f"pass device=\"cpu\" to run on the CPU")
    return dev


def check_same_device(what: str, actual: torch.device,
                      wanted: torch.device) -> None:
    """Raise when `what` lives on another device than the one asked for
    (cuda and cuda:0 count as the same card)."""
    if actual.type != wanted.type or (
            wanted.index is not None and actual.index != wanted.index):
        raise ValueError(
            f"{what} lives on {actual} but device {wanted} was asked for")


def wait_for(x) -> None:
    """Block until the device work that produced `x` (a tensor or a nest of
    lists, tuples and dicts of them) is done: the current stream of each
    CUDA tensor's card is synchronised; CPU tensors and other values
    return at once (their work is already done when the call returns)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            wait_for(v)
        return
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
