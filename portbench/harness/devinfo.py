"""The card a run uses: its name, memory peak and ``nvidia-smi``'s power
limit, clocks and temperature, sampled beside the window."""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict

import torch

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm",
              "clocks.max.sm", "clocks.mem", "temperature.gpu")


def smi() -> Dict[str, str]:
    """``nvidia-smi``'s reading of card 0 (empty without the tool)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run(
            [exe, "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    return dict(zip(SMI_FIELDS, (v.strip() for v in out[0].split(","))))


def device_record(device: torch.device, count: int) -> dict:
    """The result line's ``device``: platform, kind, cards used and the
    memory peak of the fullest one."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(count)))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}
