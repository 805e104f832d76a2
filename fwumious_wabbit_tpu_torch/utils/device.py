"""Device selection and numeric settings.

Each process of the port runs on one CUDA card (a run of several
processes, parallel/distributed.py, gives each rank its own). The CPU is
used only when a caller asks for it explicitly (``device="cpu"`` in the
tests, ``--fwt_platform cpu`` on the command line): nothing falls back to
the CPU because a card is missing.
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


# the card a process group gave this process (resolve_device's ``rank``);
# None until one asks, and then the only index accepted besides "cuda"
_local_index: int | None = None


def resolve_device(device: str | torch.device | None = None,
                   rank: int | None = None) -> torch.device:
    """``None``, ``"cuda"`` or ``"gpu"`` → this process's card (raises
    :class:`NoDeviceError` when there is none); ``"cpu"`` → the CPU.

    A process runs on one card, ``cuda:0`` unless a process group asks for
    another: ``rank`` (a rank of parallel/distributed.py, one process per
    card) takes the card ``rank % torch.cuda.device_count()`` and makes it
    the current device before anything is allocated there, since the
    kernels launch on the current device and stream. After that
    ``"cuda:<that index>"`` is accepted as well; any other index is
    refused."""
    global _local_index
    if isinstance(device, torch.device):
        name = str(device)
    else:
        name = device or "cuda"
    if name == "cpu":
        return torch.device("cpu")
    index = _local_index if _local_index is not None else 0
    if rank is not None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available for the process group's rank "
                f"{rank}; pass --fwt_platform cpu to run on the CPU instead")
        index = rank % torch.cuda.device_count()
    if name not in ("cuda", "gpu", f"cuda:{index}"):
        raise ValueError(f"unknown device {device!r}: expected 'cuda', "
                         f"'cuda:{index}' or 'cpu' (a process runs on one "
                         "card)")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass --fwt_platform cpu to run on the CPU instead")
    if rank is not None:
        torch.cuda.set_device(index)
        _local_index = index
    set_full_precision()
    return torch.device(f"cuda:{index}")


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
