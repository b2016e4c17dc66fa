"""Sample-path inspection (counterpart of the JAX package's
``diagnostics/inspection.py``): solve one SDE with several methods on the
same Brownian path, plus a fine-step "true" solve, and plot one state
dimension of each sample. Writes PNGs where matplotlib imports (and says so
where it does not); always returns the arrays. ``inspect_orders`` is in
``harness.py``.
"""

import os

import numpy as np
import torch

from ..brownian.precomputed import PrecomputedBrownian
from ..core.sdeint import sdeint
from ..settings import LEVY_AREA_APPROXIMATIONS, SDE_TYPES


def inspect_samples(sde, y0, ts, dt, methods, options=None, labels=None,
                    noise_size=None, img_dir=None, vis_dim=0,
                    dt_true=2 ** -10, entropy=0):
    """``{label: (len(ts), B, d) numpy array}`` of every method's solve and
    of the fine-step ``"true"`` one, on one PrecomputedBrownian path."""
    if options is None:
        options = (None,) * len(methods)
    if labels is None:
        labels = list(methods)

    t0, t1 = float(ts[0]), float(ts[-1])
    n_fine = int(round((t1 - t0) / dt_true))
    bm = PrecomputedBrownian(
        t0=t0, t1=t1, size=(y0.shape[0], noise_size), n=n_fine,
        dtype=y0.dtype, entropy=entropy,
        levy_area_approximation=LEVY_AREA_APPROXIMATIONS.foster,
        device=y0.device)

    method_for_true = "euler" if sde.sde_type == SDE_TYPES.ito else "midpoint"
    with torch.no_grad():
        solns = [sdeint(sde, y0, ts, bm, method=m, dt=dt, options=o)
                 for m, o in zip(methods, options)]
        solns.append(sdeint(sde, y0, ts, bm, method=method_for_true,
                            dt=dt_true))
    solns = [s.cpu().numpy() for s in solns]
    labels = list(labels) + ["true"]

    if img_dir is not None:
        try:
            import matplotlib
        except ImportError:
            print("# plotting skipped: matplotlib is not installed")
        else:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            os.makedirs(img_dir, exist_ok=True)
            ts_np = np.asarray(ts, np.float64)
            for i in range(min(y0.shape[0], 8)):
                plt.figure(figsize=(6, 4))
                for soln, label in zip(solns, labels):
                    plt.plot(ts_np, soln[:, i, vis_dim], marker="x",
                             label=label)
                plt.legend()
                plt.tight_layout()
                plt.savefig(os.path.join(img_dir, f"{i}.png"), dpi=100)
                plt.close()

    return dict(zip(labels, solns))
