"""Device resolution and card identity.

Every entry point of the port takes a `device` argument. `None` means the
card: the port exists to run there, so an absent GPU is an error, never a
quiet switch to the CPU. The CPU is used only when the caller names it,
and then each kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> "cuda" (raising when CUDA is unavailable); anything else
    -> `torch.device(device)`, checked the same way when it names CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default. "
            "Pass device='cpu' to run the plain PyTorch versions instead.")
    return dev


def card_identity() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card). A number measured on the card is reported
    beside this line, because a card set below its maximum power runs
    slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
