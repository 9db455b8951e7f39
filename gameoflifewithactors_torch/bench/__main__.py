"""``python -m gameoflifewithactors_torch.bench``: see :mod:`.run`."""

import sys

from .run import main

if __name__ == "__main__":
    sys.exit(main())
