import time

_T_START = time.monotonic()

import sys  # noqa: E402

from tpgbench.harness import main  # noqa: E402

sys.exit(main(t_start=_T_START))
