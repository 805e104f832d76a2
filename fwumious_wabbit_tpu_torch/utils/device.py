"""Device selection and numeric settings.

The port runs on one CUDA card. The CPU is used only when a caller asks for
it explicitly (``device="cpu"`` in the tests, ``--fwt_platform cpu`` on the
command line): nothing falls back to the CPU because a card is missing.
"""

from __future__ import annotations

import subprocess

import torch


class NoDeviceError(RuntimeError):
    """No CUDA device is visible and the CPU was not asked for."""


def set_full_precision() -> None:
    """Full float32 matrix products and convolutions (TF32 off) — the
    counterpart of ``precision="highest"`` in the JAX model
    (fwumious_wabbit_tpu/models/model.py:195-216)."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``, ``"cuda"``, ``"cuda:0"`` or ``"gpu"`` → ``cuda:0`` (raises
    :class:`NoDeviceError` when there is none); ``"cpu"`` → the CPU. The
    port runs on one card, the first: its kernels launch on the current
    device, so any other card index is refused."""
    if isinstance(device, torch.device):
        name = str(device)
    else:
        name = device or "cuda"
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "cuda:0", "gpu"):
        raise ValueError(f"unknown device {device!r}: expected 'cuda', "
                         "'cuda:0' or 'cpu' (the port runs on one card)")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass --fwt_platform cpu to run on the CPU instead")
    set_full_precision()
    return torch.device("cuda:0")


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
