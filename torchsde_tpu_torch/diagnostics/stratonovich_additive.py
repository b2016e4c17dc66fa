"""Strong- and weak-order check of Stratonovich SDEs with additive noise: ``run_all`` on
``stratonovich_additive`` alone.

Usage:  python -m torchsde_tpu_torch.diagnostics.stratonovich_additive [--batch 4096] [--cpu]
"""

import sys

from . import run_all


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return run_all.main(argv + ["--only", "stratonovich_additive"])


if __name__ == "__main__":
    main()
