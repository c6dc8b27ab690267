"""Device reporting — the ``getDeviceProperty`` equivalent
(``inc/tool.cuh:56-88``): the card's name, memory and power limit beside
every number the port prints."""

from __future__ import annotations

import shutil
import subprocess

import torch

__all__ = ["device_summary", "nvidia_smi_name_power"]


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode:
        return f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}"
    return proc.stdout.strip()


def device_summary(device="cuda") -> str:
    dev = torch.device(device)
    lines = [f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
             f"device: {dev}"]
    if dev.type == "cuda" and torch.cuda.is_available():
        lines.append(f"cuda devices: {torch.cuda.device_count()}")
        for i in range(torch.cuda.device_count()):
            prop = torch.cuda.get_device_properties(i)
            lines.append(f"  [{i}] {prop.name} sm_{prop.major}{prop.minor} "
                         f"{prop.multi_processor_count} SMs "
                         f"{prop.total_memory / 2**30:.1f} GiB")
        lines.append(f"nvidia-smi name, power.limit: {nvidia_smi_name_power()}")
    return "\n".join(lines)
