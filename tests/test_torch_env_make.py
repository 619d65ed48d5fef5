"""The port's env factory against the JAX package's env stack
(sheeprl_tpu_torch/utils/env.py, envs/gym_env.py, envs/dmc.py and
envs/wrappers.py against sheeprl_tpu/utils/env.py, envs/dmc.py and
envs/wrappers.py).

- ``make_vector_env`` of both packages on the same seeds and the same
  injected actions, over a few dozen steps across episode boundaries:
  observations, rewards, terminated, truncated, the final observations and
  the episode statistics, exactly. CartPole as a vector, with its
  velocities masked, from pixels (rendered, resized to 64, also gray and
  stacked with a dilation), Pendulum through ``RescaleAction``, and MuJoCo's
  Walker2d. The port's vectors step in worker processes where the case says
  so, the JAX ones in-process.
- The numpy ``INTER_AREA`` resize against ``cv2.resize``: 400x600x3
  (CartPole's render), 210x160x3 (Atari's), 84x84x1 to 64, and 32 to 64
  (cv2's bilinear fallback), exactly; the gray conversion against cv2's at
  64x64 (ROADMAP C6).
- ``DMCWrapper`` against the JAX one: walker-walk from pixels and vectors at
  32 px, and the error when both are off.
- ``RestartOnException`` against the JAX wrapper with ``wait=0``: the
  window, ``maxfails`` and the flag.
- The env groups' gates: without its package a group raises with
  ``require``'s message. ``dmc_runtime_unusable_reason`` (which the JAX
  package's tests use to tell a usable dm_control from an installed one)
  answers as the JAX one does, and names the missing package without it.
"""

import os

os.environ.setdefault("MUJOCO_GL", "egl")

import cv2
import gymnasium as gym
import numpy as np
import pytest

import sheeprl_tpu
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.envs import wrappers as jax_wrappers
from sheeprl_tpu.utils.env import make_vector_env as jax_make_vector_env
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import wrappers
from sheeprl_tpu_torch.utils import imports
from sheeprl_tpu_torch.utils.env import check_env_group, make_vector_env

CARTPOLE = ["exp=ppo", "env=gym", "env.num_envs=2", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]"]
PIXELS = ["exp=ppo", "env=gym", "env.num_envs=2", "algo.mlp_keys.encoder=[]", "algo.cnn_keys.encoder=[rgb]"]
CASES = {
    "cartpole": (CARTPOLE, 60, "True"),
    "cartpole_masked": ([*CARTPOLE, "env.mask_velocities=True"], 40, "False"),
    "cartpole_pixels": (PIXELS, 25, "True"),
    "cartpole_pixels_gray_stack": ([*PIXELS, "env.grayscale=True", "env.frame_stack=3", "env.frame_stack_dilation=2"], 25, "False"),
    "pendulum_rescaled": (["exp=sac", "env=gym", "env.id=Pendulum-v1", "env.num_envs=2", "algo.mlp_keys.encoder=[state]"], 30, "True"),
    "walker2d": (["exp=ppo_mujoco", "env.id=Walker2d-v4", "env.num_envs=2"], 40, "False"),
}


def _compare_vectors(args, steps, sync_env, seed=3):
    """Both packages' vectors from the same composed config, stepped with the
    same actions; returns the episode ends and the observation shapes."""
    sheeprl_tpu.register_all()
    jenvs = jax_make_vector_env(jax_compose("config", [*args, "env.capture_video=False", "env.sync_env=True"]), 0, None)
    penvs = make_vector_env(compose([*args, "env.capture_video=False", f"env.sync_env={sync_env}", "device=cpu"]))
    try:
        space = jenvs.single_action_space
        space.seed(seed)
        jobs, _ = jenvs.reset(seed=7)
        pobs, _ = penvs.reset(seed=7)
        ends = 0
        for t in range(steps):
            assert set(pobs) == set(jobs)
            for k in jobs:
                np.testing.assert_array_equal(pobs[k], jobs[k], err_msg=f"step {t} {k}")
            actions = np.stack([space.sample() for _ in range(jenvs.num_envs)])
            jobs, jr, jterm, jtrunc, jinfo = jenvs.step(actions)
            pobs, pr, pterm, ptrunc, pinfo = penvs.step(actions)
            np.testing.assert_array_equal(pr, np.asarray(jr, np.float32), err_msg=f"step {t}")
            np.testing.assert_array_equal(pterm, jterm)
            np.testing.assert_array_equal(ptrunc, jtrunc)
            for i in np.nonzero(np.logical_or(jterm, jtrunc))[0]:
                ends += 1
                for k in jobs:
                    np.testing.assert_array_equal(pinfo["final_obs"][i][k], jinfo["final_obs"][i][k])
                episode = jinfo["final_info"]["episode"]
                assert [e[1:] for e in pinfo["episode"] if e[0] == i] == [(float(episode["r"][i]), int(episode["l"][i]))]
        return ends, {k: v.shape for k, v in pobs.items()}
    finally:
        penvs.close()
        jenvs.close()


@pytest.mark.parametrize("case", list(CASES))
def test_make_vector_env_matches_the_jax_one(case):
    args, steps, sync_env = CASES[case]
    ends, shapes = _compare_vectors(args, steps, sync_env)
    assert ends >= (1 if case.startswith("cartpole") else 0)  # Pendulum's episodes are 200 steps
    expected = {
        "cartpole_pixels": {"rgb": (2, 64, 64, 3)}, "cartpole_pixels_gray_stack": {"rgb": (2, 64, 64, 3)},
        "walker2d": {"state": (2, 17)}, "pendulum_rescaled": {"state": (2, 3)},
    }.get(case, {"state": (2, 4)})  # fmt: skip
    assert shapes == expected


@pytest.mark.parametrize("shape", [(400, 600, 3), (210, 160, 3), (84, 84, 1), (32, 32, 3), (32, 32, 1)])
def test_resize_area_is_cv2(shape):
    """The numpy INTER_AREA resize equals cv2's on random frames and on a
    rendered-looking one (flat fields with edges): no value differs."""
    rng = np.random.default_rng(sum(shape))
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)]
    flat = np.full(shape, 255, np.uint8)
    flat[shape[0] // 3 : shape[0] // 2, shape[1] // 4 : shape[1] // 3] = rng.integers(0, 256, (1, 1, shape[2]), dtype=np.uint8)
    frames.append(flat)
    for frame in frames:
        expected = cv2.resize(frame, (64, 64), interpolation=cv2.INTER_AREA)
        got = wrappers.resize_area(frame, (64, 64))
        assert got.shape == expected.shape
        np.testing.assert_array_equal(got, expected)


def test_rgb_to_gray_is_cv2_on_whole_frames():
    """ROADMAP C6: at 64x64 (and on 10^5 pixels) every gray value is cv2's;
    the 14-bit coefficients the port used before missed 9 of 4096 here."""
    rng = np.random.default_rng(0)
    for shape in [(64, 64, 3), (1, 100_000, 3)]:
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(wrappers.rgb_to_gray(frame)[..., 0], cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("views", [(True, True), (True, False), (False, True)], ids=["both", "pixels", "vectors"])
def test_dmc_wrapper_matches_the_jax_one(views):
    from sheeprl_tpu.envs.dmc import DMCWrapper as JaxDMC
    from sheeprl_tpu_torch.envs.dmc import DMCWrapper

    pixels, vectors = views
    kwargs = dict(domain_name="walker", task_name="walk", from_pixels=pixels, from_vectors=vectors, height=32, width=32, seed=11)
    jenv, penv = JaxDMC(**kwargs), DMCWrapper(**kwargs)
    assert set(penv.observation_space.spaces) == set(jenv.observation_space.spaces)
    for k, space in jenv.observation_space.spaces.items():
        assert penv.observation_space[k].shape == space.shape and penv.observation_space[k].dtype == np.dtype(space.dtype).name
    assert (penv.action_space.shape, penv.reward_range) == (jenv.action_space.shape, jenv.reward_range)
    jobs, _ = jenv.reset()
    pobs, _ = penv.reset()
    rng = np.random.default_rng(0)
    for t in range(6):
        for k in jobs:
            np.testing.assert_array_equal(pobs[k], jobs[k], err_msg=f"step {t} {k}")
        action = rng.uniform(-1, 1, jenv.action_space.shape).astype(np.float32)
        jobs, jr, jterm, jtrunc, jinfo = jenv.step(action)
        pobs, pr, pterm, ptrunc, pinfo = penv.step(action)
        assert (pr, pterm, ptrunc) == (jr, jterm, jtrunc)
        assert pinfo["discount"] == jinfo["discount"]
        np.testing.assert_array_equal(pinfo["internal_state"], jinfo["internal_state"])
    jenv.close()
    penv.close()
    with pytest.raises(ValueError, match="'from_vectors' and 'from_pixels' must not be both False"):
        DMCWrapper("walker", "walk", from_pixels=False, from_vectors=False)


class _Crashy(gym.Env):
    """An env whose steps raise while ``plan`` says so."""

    observation_space = gym.spaces.Box(-1, 1, (2,))
    action_space = gym.spaces.Discrete(2)

    def __init__(self, plan):
        self.plan = plan

    def reset(self, seed=None, options=None):
        return np.zeros(2, np.float32), {}

    def step(self, action):
        if self.plan.pop(0):
            raise RuntimeError("simulator fault")
        return np.ones(2, np.float32), 1.0, False, False, {}


@pytest.mark.parametrize("window", [300.0, 0.0], ids=["within_window", "window_elapsed"])
def test_restart_on_exception_matches_the_jax_wrapper(window):
    """Two faults are rebuilt and flagged; a third within the window raises
    (``maxfails`` 2), unless the window ran out between them."""
    results = []
    for make in (jax_wrappers.RestartOnException, wrappers.RestartOnException):
        plan = [False, True, False, True, True, False]
        built = []

        def env_fn(plan=plan, built=built):
            built.append(1)
            return _Crashy(plan)

        env = make(env_fn, window=window, maxfails=2, wait=0)
        steps = []
        for _ in range(5):
            try:
                obs, reward, term, trunc, info = env.step(0)
                steps.append((obs.tolist(), reward, term, trunc, bool(info.get("restart_on_exception", False))))
            except RuntimeError as exc:
                steps.append(str(exc))
                break
        results.append((steps, len(built)))
    assert results[0] == results[1]
    steps, built = results[1]
    assert steps[1] == ([0.0, 0.0], 0.0, False, False, True) and steps[0][-1] is False
    if window:
        assert steps[-1].startswith("giving up on this env: 3 failures") and built == 3
    else:
        assert steps[3] == steps[4] == ([0.0, 0.0], 0.0, False, False, True) and built == 4


def test_mask_velocity_table_and_unknown_id():
    assert set(wrappers.MaskVelocityWrapper.velocity_indices) == set(jax_wrappers.MaskVelocityWrapper.velocity_indices)
    for k, v in jax_wrappers.MaskVelocityWrapper.velocity_indices.items():
        np.testing.assert_array_equal(wrappers.MaskVelocityWrapper.velocity_indices[k], v)
    with pytest.raises(NotImplementedError, match="Velocity masking not implemented for Acrobot-v1"):
        wrappers.MaskVelocityWrapper(_Crashy([]), "Acrobot-v1")


@pytest.mark.parametrize(
    "group, flag, package",
    [("gym", "_IS_GYMNASIUM_AVAILABLE", "gymnasium"), ("mujoco", "_IS_MUJOCO_AVAILABLE", "mujoco"), ("dmc", "_IS_DMC_AVAILABLE", "dm_control"),
     ("atari", "_IS_ALE_AVAILABLE", "ale_py")],
)  # fmt: skip
def test_env_groups_are_gated_on_their_package(monkeypatch, group, flag, package):
    """A group whose package is missing raises with require's message (the
    card's host has none of them; Atari's ale_py is on neither host), and
    passes where it is importable."""
    cfg = compose(["exp=ppo", f"env={group}", "device=cpu"])
    if getattr(imports, flag):
        check_env_group(cfg)
    monkeypatch.setattr(imports, flag, False)
    with pytest.raises(ModuleNotFoundError, match=f"The '{package}' package is required for this feature but is not installed"):
        check_env_group(cfg)


def test_dmc_runtime_probe_answers_as_the_jax_one(monkeypatch):
    from sheeprl_tpu.utils.imports import dmc_runtime_unusable_reason as jax_reason

    reason = imports.dmc_runtime_unusable_reason()
    assert (reason is None) == (jax_reason() is None), (reason, jax_reason())
    assert imports.dmc_runtime_unusable_reason() is reason  # probed once per process
    monkeypatch.setattr(imports, "_IS_DMC_AVAILABLE", False)
    assert imports.dmc_runtime_unusable_reason() == "dm_control not installed"
