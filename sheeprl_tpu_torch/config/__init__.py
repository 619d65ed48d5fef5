"""The port's configs: composed from its own YAML tree,
``sheeprl_tpu_torch/configs/``, as the JAX package composes its
``configs/`` (counterpart of sheeprl_tpu/config/).

- :mod:`.reader` reads the YAML subset the tree is written in, to the values
  PyYAML gives the JAX package (the card's host has no PyYAML);
- :mod:`.loader` composes (``defaults`` lists, groups, overrides,
  packages, interpolation): :func:`compose` takes ``exp=...``, ``env=...``
  and ``key=value`` arguments as the JAX package's command line does;
- :mod:`.instantiate` builds the objects ``_target_`` nodes name.

The tree holds every file the port's exps reach: ``ppo``, ``ppo_atari``,
``dreamer_v3_100k_ms_pacman`` and ``dreamer_v3_dmc_walker_walk`` (and the
``dreamer_v3`` both Dreamer exps include), each the JAX package's file with
``_target_`` naming the port's class where the port has one. Four keys are
the port's own: ``device`` (``cuda`` unless ``device=cpu``), ``env_group``
(the option the ``env`` group resolved to), ``env.wrapper.action_dim`` (the
dummy env's action count) and ``buffer.memmap_mode`` (the mode the buffer's
files open in). Any exp of the tree composes; the command line then refuses
an algorithm or an env the port does not run yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from sheeprl_tpu_torch.config.instantiate import instantiate, locate
from sheeprl_tpu_torch.config.loader import Composer, ConfigError, MandatoryValueError, compose, parse_value
from sheeprl_tpu_torch.utils.utils import get_by_path, set_by_path

__all__ = [
    "Composer", "ConfigError", "MandatoryValueError", "compose", "instantiate", "locate", "parse_list",
    "parse_overrides", "parse_value", "set_overrides",
]  # fmt: skip


def parse_overrides(overrides: Sequence[str]) -> Dict[str, str]:
    """``key=value`` arguments -> {key: value} (a leading ``+`` is dropped)."""
    out: Dict[str, str] = {}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"arguments are key=value pairs, got {ov!r}")
        key, value = ov.split("=", 1)
        out[key.lstrip("+")] = value
    return out


def parse_list(value: str) -> List[str]:
    """``[a,b]``, ``["a", "b"]`` or a bare ``a`` as a list of strings."""
    parsed = parse_value(value.strip())
    if parsed is None:
        return []
    items = parsed if isinstance(parsed, list) else [value.strip()]
    return [str(v) for v in items if str(v)]


def set_overrides(cfg: Dict[str, Any], kv: Dict[str, str]) -> None:
    """Set each existing ``key`` of ``cfg`` in place to its text read by
    :func:`parse_value`, as the JAX package's evaluation sets a run's
    config. Raises on an unknown key."""
    missing = object()
    for key, text in kv.items():
        old = get_by_path(cfg, key, missing)
        if old is missing or isinstance(old, dict):
            raise ValueError(f"Unknown config key {key!r}")
        set_by_path(cfg, key, parse_value(text))
