"""Strong- and weak-order convergence harness (counterpart of the JAX
package's ``diagnostics/harness.py``).

The empirical strong order is the regression slope of 0.5 log(MSE) against
log(dt) over a ladder of step sizes, every solve on the same Brownian path;
the weak order is the slope of log |E phi(y) - E phi(y_true)|. The shared
path is a :class:`PrecomputedBrownian` on a fine uniform grid (one sampling
pass, O(1) queries). The "true" solution is the problem's
``analytical_sample`` where it has one, else a fine-step solve by Euler
(Itô) or midpoint (Stratonovich). Everything runs on ``y0``'s device,
without recording gradients.
"""

import math

import numpy as np
import torch

from ..brownian.precomputed import PrecomputedBrownian
from ..core.sdeint import sdeint
from ..settings import LEVY_AREA_APPROXIMATIONS, SDE_TYPES


def linregress_slope(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x = x - x.mean()
    return float((x * (y - y.mean())).sum() / (x * x).sum())


def sum_of_squares(x):
    """The default test function phi: sum of squares over the state."""
    return torch.sum(x ** 2, dim=1)


def inspect_orders(sde, y0, t0, t1, dts, methods, options=None, labels=None,
                   noise_size=None, dt_true=None, entropy=0,
                   levy_area_approximation=LEVY_AREA_APPROXIMATIONS.foster,
                   test_func=sum_of_squares):
    """Returns dict label -> {'strong_order': slope, 'weak_order': slope,
    'mses': [...], 'maes': [...]}."""
    if options is None:
        options = (None,) * len(methods)
    if labels is None:
        labels = methods
    if dt_true is None:
        dt_true = min(dts) / 32
    n_fine = int(round((t1 - t0) / dt_true))
    # Every dt must be a whole number of fine cells so all solves share the path.
    assert all(abs((t1 - t0) / dt - round((t1 - t0) / dt)) < 1e-9 for dt in dts)

    size = (y0.shape[0], noise_size)
    bm = PrecomputedBrownian(t0=t0, t1=t1, size=size, n=n_fine,
                             dtype=y0.dtype, entropy=entropy,
                             levy_area_approximation=levy_area_approximation,
                             device=y0.device)
    ts = [t0, t1]

    with torch.no_grad():
        if hasattr(sde, "analytical_sample"):
            true = sde.analytical_sample(y0, ts, bm)[-1]
        else:
            method_for_true = ("euler" if sde.sde_type == SDE_TYPES.ito
                               else "midpoint")
            true = sdeint(sde, y0, ts, bm, method=method_for_true,
                          dt=dt_true)[-1]
        phi_true = torch.mean(test_func(true))

        results = {label: {"mses": [], "maes": []} for label in labels}
        for dt in dts:
            for method, opts, label in zip(methods, options, labels):
                soln = sdeint(sde, y0, ts, bm, method=method, dt=dt,
                              options=opts)[-1]
                mse = torch.mean(torch.sum((soln - true) ** 2, dim=1))
                mae = torch.abs(torch.mean(test_func(soln)) - phi_true)
                results[label]["mses"].append(float(mse))
                results[label]["maes"].append(float(mae))

    log_dts = [math.log(dt) for dt in dts]
    for label in labels:
        r = results[label]
        r["strong_order"] = linregress_slope(log_dts, 0.5 * np.log(r["mses"]))
        r["weak_order"] = linregress_slope(
            log_dts, np.log(np.maximum(r["maes"], 1e-300)))
    return results


def print_orders(name, results, expected=None):
    print(f"== {name} ==")
    for label, r in results.items():
        exp = (f" (expected {expected[label]})"
               if expected and label in expected else "")
        print(f"  {label:24s} strong={r['strong_order']:+.3f}{exp}  "
              f"weak={r['weak_order']:+.3f}")
    return results
