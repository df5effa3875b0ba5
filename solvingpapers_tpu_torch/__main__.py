"""``python -m solvingpapers_tpu_torch <cmd>``: the port's command line
(`cli`)."""

import sys

from solvingpapers_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
