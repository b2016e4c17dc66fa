"""Profiling hooks (counterpart of ``torchsde_tpu/utils/profiling.py``).

Solve-level counters (``nfe``, ``n_accepted``, ``n_rejected``) come from
``sdeint(..., return_stats=True)``. Device-level tracing uses
``torch.profiler``: wrap a region in :func:`trace` and open the Chrome
trace it writes with Perfetto or ``chrome://tracing``::

    from torchsde_tpu_torch.utils.profiling import annotate, trace

    with trace("profile_dir"):
        with annotate("train_step"):
            loss = train_step(model, xs, gen)
        torch.cuda.synchronize()
"""

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed region (CPU activity, and CUDA activity where a
    card is available) and write its Chrome trace to
    ``logdir/trace.json``. Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), TRACE_FILE))


@contextlib.contextmanager
def annotate(name):
    """A named span: a ``torch.profiler.record_function`` on the host
    timeline of a :func:`trace`, and an NVTX range where the card is in
    use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class WallTimer:
    """Host wall-clock timer. CUDA work is asynchronous, so the clock stops
    at the enqueue unless the timed block ends in ``WallTimer.fetch(x)``,
    which synchronises ``x``'s device and reads one value of it."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @staticmethod
    def fetch(x):
        x = torch.as_tensor(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.reshape(-1)[0])
