"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch device an entry point runs on.  "cuda" (every entry
    point's default) needs a card: without one this raises instead of
    carrying on quietly on the CPU."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return d


def synchronize(device) -> None:
    """Wait for all the device's queued work, on every stream (a no-op on
    the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sync_stream(device) -> None:
    """Wait for the work queued on the calling thread's current stream of
    the device (a no-op on the CPU); other threads' streams run on."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
