"""The card a run uses: its identity, limits and peak memory."""

from __future__ import annotations

import shutil
import subprocess

SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm"


def smi() -> str:
    """``nvidia-smi``'s name, power limit and SM clocks of every card, or
    ``"unavailable"``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "unavailable"
    try:
        out = subprocess.run([exe, f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip()) or "unavailable"


def identity(device) -> dict:
    """Platform, name and count of the cards (CPU for a rehearsal)."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 0}


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
