"""``python -m tpu_p2p_torch`` — the port's entry point."""

import sys

from tpu_p2p_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
