"""Where the port's entry points put their tensors: on the card unless the
caller asks for the CPU, and never on the CPU by fallback."""

from __future__ import annotations

import torch


class NoCardError(RuntimeError):
    """A CUDA device was asked for (or taken by default) on a machine with
    no card."""


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device on a machine
    without a card raises :class:`NoCardError`, which names ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(f'no CUDA device is available for device="{device}": pass '
                          'device="cpu" to run on the CPU')
    return device


def float_dtype(device, dtype=None) -> torch.dtype:
    """``dtype``, or where it is None float32 on a CUDA device (the type the
    kernels take) and float64 on the CPU."""
    if dtype is not None:
        return dtype
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
