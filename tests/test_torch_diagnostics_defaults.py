"""The port's ``diagnostics.run_all`` against the JAX package's at the
drivers' defaults (batch 4096, d 3, m 5, float64, dt 2^-1..2^-6 on
[0, 2], dt_true 2^-11), for ``ito_diagonal``, on the CPU.

Both drivers run as users run them, each in a process of its own. Their
slopes and MSEs agree at rtol 1e-9, and ``check_bands`` flags the same
violations in both. At these defaults the JAX package's own Euler weak
order is below its band; ``chip_smoke.py`` holds the card's slope to
that reading (``DIAG_REFERENCE_MISSES``), and this test re-derives it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from diagnostics import run_all as jrun_all
from torchsde_tpu_torch.diagnostics import run_all

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-9


@pytest.mark.heavy
def test_run_all_at_the_defaults_matches_the_jax_package(tmp_path):
    runs = {}
    for name, module in (("jax", "diagnostics.run_all"),
                         ("port", "torchsde_tpu_torch.diagnostics.run_all")):
        path = tmp_path / f"{name}.json"
        runs[name] = (path, subprocess.Popen(
            [sys.executable, "-m", module, "--cpu", "--only", "ito_diagonal",
             "--no-check", "--json", str(path)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    for name, (path, proc) in runs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
        results[name] = json.loads(path.read_text(),
                                   parse_constant=lambda c: 1 / 0)
    want, got = results["jax"], results["port"]
    assert list(got) == list(want) == ["ito_diagonal"]
    assert list(got["ito_diagonal"]) == list(want["ito_diagonal"])
    for label, w in want["ito_diagonal"].items():
        for key in ("mses", "strong_order", "weak_order"):
            np.testing.assert_allclose(got["ito_diagonal"][label][key],
                                       w[key], rtol=RTOL,
                                       err_msg=f"{label} {key}")
    violations = jrun_all.check_bands(want)
    assert run_all.check_bands(got) == violations
    misses = chip_smoke.DIAG_REFERENCE_MISSES
    assert len(violations) == len(misses), violations
    for v, ((combo, label, order), ref) in zip(violations, misses.items()):
        assert v.startswith(f"{combo}/{label}: {order} "), v
        np.testing.assert_allclose(want[combo][label][order], ref,
                                   rtol=chip_smoke.DIAG_REFERENCE_REL)
