"""Device and random-number helpers.

Every function of the port takes an explicit device. A request for a
CUDA device when no card is present raises: nothing falls back to the CPU.
Randomness comes from explicit torch.Generators (Philox on a card) seeded
from the render seed, in place of ppg_tpu's jax.random keys.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was requested but PyTorch "
                           "sees no CUDA device")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"device type {dev.type!r}")
    return dev


def generator(seed, device) -> torch.Generator:
    g = torch.Generator(device=resolve(device))
    g.manual_seed(int(seed))
    return g


def rand(gen: torch.Generator, *shape):
    """Uniform [0, 1) float32 draws on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
