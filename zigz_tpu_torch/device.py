"""Device selection and the card probe.

Every entry point of the port takes an explicit ``device``.  ``"cuda"`` on a
host without a usable CUDA device raises: nothing quietly becomes the CPU.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "synchronize", "card_info"]


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, CPU or CUDA only."""
    if device is None:
        raise ValueError("an explicit device is required ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU).  Host clocks
    read after this time the work, not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nvidia_smi():
    """(output, None) of the name and power-limit query, or (None, why)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return None, f"nvidia-smi could not run: {exc}"
    if res.returncode != 0:
        return None, f"nvidia-smi failed (rc {res.returncode}): {res.stderr.strip()}"
    return res.stdout.strip(), None


def card_info() -> dict:
    """What the port runs on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (None, with the reason in ``nvidia_smi_error``, where it cannot
    run), the torch and CUDA versions, and the nvcc the kernels build with."""
    from .ops._build import find_nvcc

    smi, smi_error = _nvidia_smi()
    return {
        "nvidia_smi": smi,
        "nvidia_smi_error": smi_error,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "nvcc": find_nvcc(),
    }
