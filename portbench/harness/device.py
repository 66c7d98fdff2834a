"""The device's side of a run: synchronising, the memory peak, the card's
name and power limit, and a profiled stretch reduced by ``trace.py``."""

import gc
import subprocess
import tempfile

import torch

from portbench.harness import trace


def is_cuda(device):
    return torch.device(device).type == "cuda"


def synchronize(device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


def memory_peak(device):
    return int(torch.cuda.max_memory_allocated(device)) if is_cuda(device) else 0


def release(device):
    """Return what the program's freed state held to the device."""
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def info(device, memory_peak_bytes, summary=None):
    """The result's ``device`` entry; with a trace, its busy and window
    seconds."""
    if is_cuda(device):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": memory_peak_bytes, "power_limit": power_limit()}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": memory_peak_bytes}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out


def profiled(fn, units, device):
    """Run ``fn`` (``units`` steps or chunks) under ``torch.profiler`` inside
    the window annotation, which ends in a synchronize; its summary, or None
    where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if is_cuda(device) else [])
    synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            fn()
            synchronize(device)
    return trace.summarize(trace.export_events(prof, tempfile.gettempdir()), units)
