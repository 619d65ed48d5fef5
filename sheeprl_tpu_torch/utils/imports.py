"""Optional-dependency flags (counterpart of sheeprl_tpu/utils/imports.py).

Each env family imports its simulator only where it is built; the flags are
checked without importing, so the port imports on a host that has none of
them (the card's host has no gymnasium, dm_control or mujoco) and a missing
simulator fails with :func:`require`'s message. The JAX package depends on
gymnasium outright; the port gates it like any simulator
(``_IS_GYMNASIUM_AVAILABLE``), and gymnasium's MuJoCo group on ``mujoco``.
"""

from __future__ import annotations

import importlib.util


def module_available(name: str) -> bool:
    """True when ``name`` can be imported (checked without importing it)."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_IS_ALE_AVAILABLE = module_available("ale_py")
_IS_CRAFTER_AVAILABLE = module_available("crafter")
_IS_DIAMBRA_AVAILABLE = module_available("diambra")
_IS_DIAMBRA_ARENA_AVAILABLE = module_available("diambra.arena")
_IS_DMC_AVAILABLE = module_available("dm_control")
_IS_GYMNASIUM_AVAILABLE = module_available("gymnasium")
_IS_MINEDOJO_AVAILABLE = module_available("minedojo")
_IS_MINERL_AVAILABLE = module_available("minerl")
_IS_MLFLOW_AVAILABLE = module_available("mlflow")
_IS_MUJOCO_AVAILABLE = module_available("mujoco")
_IS_SUPER_MARIO_BROS_AVAILABLE = module_available("gym_super_mario_bros")


_DMC_RUNTIME_REASON: "str | None | type[Ellipsis]" = ...


def dmc_runtime_unusable_reason() -> "str | None":
    """``None`` when a dm_control env can be built in this process, else why
    not: dm_control can be installed yet unusable (a headless host where
    ``MUJOCO_GL=egl`` finds no EGL library). Probed once per process on the
    cheapest vector-only task, with the port's own
    :class:`~sheeprl_tpu_torch.envs.dmc.DMCWrapper`."""
    global _DMC_RUNTIME_REASON
    if not _IS_DMC_AVAILABLE:
        return "dm_control not installed"
    if _DMC_RUNTIME_REASON is ...:
        try:
            from sheeprl_tpu_torch.envs.dmc import DMCWrapper

            env = DMCWrapper("cartpole", "balance", from_pixels=False, from_vectors=True, seed=0)
            env.reset(seed=0)
            env.close()
            _DMC_RUNTIME_REASON = None
        except Exception as e:  # noqa: BLE001 - a capability probe: any failure means unusable
            _DMC_RUNTIME_REASON = f"dm_control unusable here: {type(e).__name__}: {e}"
    return _DMC_RUNTIME_REASON


def require(flag: bool, package: str, extra: str) -> None:
    """Raise the gate's error for a missing optional dependency."""
    if not flag:
        raise ModuleNotFoundError(
            f"The '{package}' package is required for this feature but is not installed. Install it (e.g. `pip install {extra}`) to use it."
        )
