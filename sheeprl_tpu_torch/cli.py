"""Command line of the port's trainer::

    python -m sheeprl_tpu_torch exp=dreamer_v3_100k_ms_pacman env=dummy [key=value ...] [device=cpu]

It runs on ``cuda`` unless ``device=cpu`` is given, and raises without a
card. It raises on an ``exp`` or ``env`` the port does not have yet (it has
``exp=dreamer_v3_100k_ms_pacman`` and ``env=dummy``) and on an unknown key.
Keys are those of :mod:`sheeprl_tpu_torch.config`, e.g.
``algo.learning_starts=128 algo.total_steps=136 buffer.size=4096``.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Sequence

from sheeprl_tpu_torch.config import compose


def run(args: Optional[Sequence[str]] = None, callback=None) -> Dict[str, Any]:
    """Compose the config from ``args`` (``sys.argv[1:]`` by default) and
    train; returns what :func:`sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.main`
    returns."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main

    argv = list(args) if args is not None else sys.argv[1:]
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return {}
    return main(compose(argv), callback=callback)
