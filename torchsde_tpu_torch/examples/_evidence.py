"""Shared helpers of the example scripts: the ``--log-jsonl`` and
``--artifacts-dir`` records, the device an example runs on, its random
streams, and the optional plot.

Every record is strict JSON: an absent value is written as ``null``, and a
non-finite number raises instead of being written as a bare ``NaN`` that
strict parsers reject. Each JSONL file and acceptance record starts with
the device that made it (for the card, its name and power limit as
``nvidia-smi`` reports them).
"""

import json
import os
import statistics
import subprocess

import torch

from ..brownian import threefry
from ..utils.misc import resolve_device


def example_device(cpu):
    """The CPU when ``cpu`` (the examples' ``--cpu``), else the CUDA card,
    which must exist."""
    return torch.device("cpu") if cpu else resolve_device(None)


def device_name(device):
    """``"cpu"``, or the card's ``name, power.limit`` from nvidia-smi
    (its name from torch where nvidia-smi cannot be run)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        index = torch.device(device).index or 0
        return out[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def stream(device, *path):
    """A ``torch.Generator`` on ``device`` seeded from the Threefry key
    ``fold_in(fold_in(PRNGKey(0), path[0]), path[1]) ...``: the port's
    counterpart of the JAX examples' ``fold_in`` chains of ``PRNGKey(0)``.
    Distinct paths give unrelated seeds, so streams of different purposes
    never collide."""
    hi, lo = 0, 0                      # PRNGKey(0)
    for p in path:
        hi, lo = threefry.fold_in_words((hi, lo), p)
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return gen


def dumps(record):
    """One strict-JSON line (raises on NaN or infinity)."""
    return json.dumps(record, allow_nan=False)


class JsonlLogger:
    """Append-per-record JSONL logger (no-op when path is None). The file
    is truncated on opening (each run owns its trajectory), and its first
    line records ``device``."""

    def __init__(self, path, device="cpu"):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(dumps({"device": device_name(device)}) + "\n")

    def write(self, **record):
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(dumps(record) + "\n")


def artifact_path(artifacts_dir, name):
    os.makedirs(artifacts_dir, exist_ok=True)
    return os.path.join(artifacts_dir, name)


def save_acceptance(artifacts_dir, name, device="cpu", **record):
    """Write the numeric acceptance record, headed by ``device``, and echo
    it to stdout. Returns the record."""
    record = {"device": device_name(device), **record}
    line = dumps(record)
    print("ACCEPTANCE " + line)
    if artifacts_dir:
        with open(artifact_path(artifacts_dir, name), "w") as f:
            f.write(line + "\n")
    return record


def pyplot(artifacts_dir):
    """``matplotlib.pyplot`` (Agg) when a plot is asked for and matplotlib
    imports; else None, saying that the plot is skipped."""
    if not artifacts_dir:
        return None
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def median_ms(times_s):
    """Median of host times in seconds, in ms (None for no times)."""
    return statistics.median(times_s) * 1e3 if times_s else None
