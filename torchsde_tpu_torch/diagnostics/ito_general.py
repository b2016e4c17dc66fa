"""Strong- and weak-order check of Itô SDEs with general noise: ``run_all`` on
``ito_general`` alone.

Usage:  python -m torchsde_tpu_torch.diagnostics.ito_general [--batch 4096] [--cpu]
"""

import sys

from . import run_all


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return run_all.main(argv + ["--only", "ito_general"])


if __name__ == "__main__":
    main()
