"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import time

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    The port never moves to the CPU on its own: a run asked for the card
    either gets it or raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def synced_clock(device: torch.device) -> float:
    """The host clock once the device's queued work is done: the end of a
    timed phase."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
