"""``python -m fdreadoutlibs_tpu_torch.bench`` (see the package's
docstring)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
