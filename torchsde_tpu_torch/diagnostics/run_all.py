"""Run every (sde_type x noise_type) strong- and weak-order check
(counterpart of the JAX package's ``diagnostics/run_all.py``).

Problems, method lists, the dt ladder (2^-1 .. 2^-6 on [0, 2]) and the
acceptance bands are the JAX package's; the Ex* problems use their exact
sample solutions, NeuralGeneral a fine-step solve at ``--dt-true``. The
solves run in float64 on the card (``--cpu``: on the CPU). Any slope below
its band exits 1.

Usage:  python -m torchsde_tpu_torch.diagnostics.run_all [--batch 4096] [--cpu]
"""

import argparse
import json
import sys

import torch

from . import problems
from .harness import inspect_orders, print_orders
from ..utils.misc import resolve_device

# Acceptance bands: (strong_order_min, weak_order_min) per (combo, method),
# the JAX package's (diagnostics/run_all.py), unchanged. The slopes alone
# assert nothing; here a regression in either slope fails the run (exit 1).
# The lower bounds sit ~0.3-0.8 below the JAX package's committed slopes at
# batch 1024: wide enough for Monte Carlo noise across batch sizes and
# devices, tight enough that a broken solver (Milstein degrading to Euler's
# 0.5, or a biased weak error) trips them.
ORDER_BANDS = {
    "ito_diagonal": {
        "euler": (0.35, 0.45), "milstein": (0.80, 0.65),
        "milstein_grad_free": (0.80, 0.65), "srk": (1.25, 0.70),
    },
    "ito_scalar": {
        "euler": (0.35, 0.50), "milstein": (0.80, 0.60),
        "milstein_grad_free": (0.80, 0.60), "srk": (1.10, 1.00),
    },
    "ito_additive": {
        "euler": (0.85, 0.60), "milstein": (0.85, 0.60),
        "milstein_grad_free": (0.85, 0.60), "srk": (1.40, 1.20),
    },
    "ito_general": {"euler": (0.45, 0.50)},
    "stratonovich_diagonal": {
        "euler_heun": (0.80, 0.80), "heun": (0.80, 0.70),
        "midpoint": (0.80, 0.70), "reversible_heun": (0.45, 0.70),
        "milstein": (0.80, 0.80), "milstein_grad_free": (0.80, 0.80),
        "log_ode": (0.80, 0.70),
    },
    "stratonovich_scalar": {
        "euler_heun": (0.60, 0.50), "heun": (0.60, 0.50),
        "midpoint": (0.70, 0.50), "reversible_heun": (0.45, 0.50),
        "milstein": (0.80, 0.60), "milstein_grad_free": (0.50, 0.60),
        "log_ode": (0.70, 0.50),
    },
    "stratonovich_additive": {
        "euler_heun": (0.85, 0.60), "heun": (1.40, 1.20),
        "midpoint": (1.40, 1.20), "reversible_heun": (1.20, 1.20),
        "milstein": (0.85, 0.60), "milstein_grad_free": (0.85, 0.60),
        "log_ode": (1.40, 1.20),
    },
    "stratonovich_general": {
        "euler_heun": (0.70, 0.50), "heun": (0.70, 0.80),
        "midpoint": (0.70, 0.80), "reversible_heun": (0.45, 0.80),
        "log_ode": (0.70, 0.80),
    },
}


def check_bands(all_results):
    """Returns a list of human-readable violations against ORDER_BANDS."""
    violations = []
    for combo, methods in all_results.items():
        for label, r in methods.items():
            band = ORDER_BANDS.get(combo, {}).get(label)
            if band is None:
                continue
            strong_min, weak_min = band
            if r["strong_order"] < strong_min:
                violations.append(
                    f"{combo}/{label}: strong_order {r['strong_order']:.3f}"
                    f" < band minimum {strong_min}")
            if r["weak_order"] < weak_min:
                violations.append(
                    f"{combo}/{label}: weak_order {r['weak_order']:.3f}"
                    f" < band minimum {weak_min}")
    return violations


ITO_METHODS = ("euler", "milstein", "milstein_grad_free", "srk")
ITO_OPTIONS = (None, None, dict(grad_free=True), None)
STRAT_METHODS = ("euler_heun", "heun", "midpoint", "reversible_heun",
                 "milstein", "milstein_grad_free", "log_ode")
STRAT_OPTIONS = (None, None, None, None, None, dict(grad_free=True), None)
STRAT_GENERAL_METHODS = ("euler_heun", "heun", "midpoint",
                         "reversible_heun", "log_ode")
COMBOS = tuple(f"{s}_{n}" for s in ("ito", "stratonovich")
               for n in ("diagonal", "scalar", "additive", "general"))


def _methods(ms, opts):
    """Solver names, options and labels: ``milstein_grad_free`` is
    Milstein with ``grad_free=True``."""
    methods = tuple("milstein" if m == "milstein_grad_free" else m
                    for m in ms)
    return methods, tuple(opts), tuple(ms)


def configs(d, m, device):
    """``(name, sde, noise_size, methods, options, labels)`` of the eight
    combinations, in float64 on ``device``."""
    out = []
    kw = dict(device=device)
    for sde_type in ("ito", "stratonovich"):
        if sde_type == "ito":
            ms = _methods(ITO_METHODS, ITO_OPTIONS)
            ms_gen = _methods(("euler",), (None,))
        else:
            ms = _methods(STRAT_METHODS, STRAT_OPTIONS)
            ms_gen = _methods(STRAT_GENERAL_METHODS,
                              (None,) * len(STRAT_GENERAL_METHODS))
        out += [
            (f"{sde_type}_diagonal",
             problems.ExDiagonal(d=d, sde_type=sde_type, **kw), d, *ms),
            (f"{sde_type}_scalar",
             problems.ExScalar(d=d, sde_type=sde_type, **kw), 1, *ms),
            (f"{sde_type}_additive",
             problems.ExAdditive(d=d, m=m, sde_type=sde_type, **kw), m,
             *ms),
            (f"{sde_type}_general",
             problems.NeuralGeneral(d=d, m=m, sde_type=sde_type, **kw), m,
             *ms_gen),
        ]
    return out


def run_orders(batch, d, m, dt_true, device, only=None, t0=0.0, t1=2.0,
               dts=tuple(2.0 ** -i for i in range(1, 7))):
    """Every combination's (or ``only``'s) slopes and MSEs, printed as they
    come: ``{combo: {label: {strong_order, weak_order, mses}}}``."""
    all_results = {}
    for name, sde, noise_size, methods, options, labels in configs(
            d, m, device):
        if only is not None and name != only:
            continue
        y0 = torch.full((batch, d), 0.1, dtype=torch.float64, device=device)
        results = inspect_orders(sde, y0, t0, t1, dts, methods, options,
                                 labels, noise_size=noise_size,
                                 dt_true=dt_true)
        print_orders(name, results)
        all_results[name] = {k: {"strong_order": v["strong_order"],
                                 "weak_order": v["weak_order"],
                                 "mses": v["mses"]}
                             for k, v in results.items()}
    return all_results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--d", type=int, default=3)
    parser.add_argument("--m", type=int, default=5)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--dt-true", type=float, default=2 ** -11)
    parser.add_argument("--json", type=str, default=None)
    parser.add_argument("--only", type=str, default=None, choices=COMBOS,
                        help="run a single sde_type_noise combination")
    parser.add_argument("--no-check", action="store_true",
                        help="skip the ORDER_BANDS acceptance check")
    args = parser.parse_args(argv)

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    all_results = run_orders(args.batch, args.d, args.m, args.dt_true,
                             device, only=args.only)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(all_results, f, indent=2, allow_nan=False)

    if not args.no_check:
        violations = check_bands(all_results)
        if violations:
            print("ORDER-BAND VIOLATIONS:")
            for v in violations:
                print("  " + v)
            sys.exit(1)
        n = sum(len(m) for m in all_results.values())
        print(f"order bands: {n} method slopes within acceptance bands")
    return all_results


if __name__ == "__main__":
    main()
