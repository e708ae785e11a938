"""Command-line dispatch of the port: ``python -m tpu_p2p_torch serve
...`` runs the serving engine, ``python -m tpu_p2p_torch train ...`` the
training loop; every other subcommand of the reference CLI is not
ported yet and exits non-zero."""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from tpu_p2p_torch.serve.engine import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "train":
        from tpu_p2p_torch.train import main as train_main

        return train_main(argv[1:])
    what = argv[0] if argv else "the default benchmark"
    print(f"python -m tpu_p2p_torch: {what} is not ported yet; "
          "available: serve, train", file=sys.stderr)
    return 2
