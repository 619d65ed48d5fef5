"""The env keys of the JAX package's ``make_env`` in the port's env factory
(sheeprl_tpu_torch/envs/make.py and envs/wrappers.py against
sheeprl_tpu/utils/env.py:make_env).

``env.grayscale``, ``env.frame_stack`` (with its dilation),
``env.actions_as_observation``, ``env.reward_as_observation`` and
``env.max_episode_steps``, each alone and all together:

- ``env=dummy``: the port's test env and the JAX ``make_env`` env of the
  same composed config step the same actions; every observation key,
  reward and episode end are equal (exactly: the frames are uint8 and the
  grayscale is cv2's fixed-point RGB-to-gray, written in numpy);
- the gridworld's host lane (``env=jax_gridworld``): the observation space
  of the JAX ``make_env``, and each key's transform of the port's own frames
  (cv2 for the gray, the stack of the last frames), the truncation at
  ``max_episode_steps``;
- the Anakin fused lane raises on each key it cannot honour, naming it.
"""

import cv2
import numpy as np
import pytest

import sheeprl_tpu
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.utils.env import make_env as jax_make_env
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils.env import check_fused_env_keys, make_test_env, make_vector_env
from sheeprl_tpu_torch.envs.wrappers import rgb_to_gray

KEYS = {
    "grayscale": ["env.grayscale=True"],
    "frame_stack": ["env.frame_stack=3", "env.frame_stack_dilation=2"],
    "max_episode_steps": ["env.max_episode_steps=3"],
    "reward_as_observation": ["env.reward_as_observation=True"],
    "actions_as_observation": ["env.actions_as_observation.num_stack=2", "env.actions_as_observation.noop=0", "env.actions_as_observation.dilation=2"],
}
KEYS["all"] = [o for v in KEYS.values() for o in v]
DUMMY = ["exp=dreamer_v3", "env=dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "env.screen_size=16", "env.capture_video=False"]


def _pair(args):
    sheeprl_tpu.register_all()
    return jax_make_env(jax_compose("config", args), 0, 0, None, "test")(), make_test_env(compose([*args, "device=cpu"]))


def test_rgb_to_gray_is_cv2():
    frame = np.random.default_rng(0).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_gray(frame)[..., 0], cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY))
    edges = np.array([[[255, 255, 255], [0, 0, 0], [1, 2, 3], [128, 64, 32], [255, 0, 0], [0, 255, 0], [0, 0, 255]]], np.uint8)
    np.testing.assert_array_equal(rgb_to_gray(edges)[..., 0], cv2.cvtColor(edges, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy"])
@pytest.mark.parametrize("key", list(KEYS))
def test_dummy_env_matches_jax_make_env(key, env_id):
    overrides = list(KEYS[key])
    if env_id == "continuous_dummy":
        overrides = [o.replace("noop=0", "noop=0.5") for o in overrides]
    jenv, penv = _pair([*DUMMY, f"env.id={env_id}", *overrides])
    assert set(penv.observation_space.spaces) == set(jenv.observation_space.spaces)
    for k, space in jenv.observation_space.spaces.items():
        assert tuple(penv.observation_space[k].shape) == tuple(space.shape), k
    rng = np.random.default_rng(3)
    jobs, pobs = jenv.reset(seed=0)[0], penv.reset(seed=0)[0]
    ends = []
    for t in range(14):
        assert set(pobs) == set(jobs)
        for k in jobs:
            np.testing.assert_array_equal(pobs[k], np.asarray(jobs[k]), err_msg=f"step {t} {k}")
        action = rng.uniform(-1, 1, (6,)).astype(np.float32) if env_id == "continuous_dummy" else np.int64(rng.integers(0, jenv.action_space.n))
        jobs, jr, jterm, jtrunc, _ = jenv.step(action)
        pobs, pr, pterm, ptrunc, _ = penv.step(action)
        assert (float(pr), bool(pterm), bool(ptrunc)) == (float(jr), bool(jterm), bool(jtrunc)), t
        if jterm or jtrunc:
            ends.append((t, bool(jterm), bool(jtrunc)))
            jobs, pobs = jenv.reset()[0], penv.reset()[0]
    if key in ("max_episode_steps", "all"):
        assert ends[0] == (2, False, True)
    elif env_id == "discrete_dummy":  # its episodes end after 5 steps, the continuous one's after 129
        assert ends and not ends[0][2]


def test_vector_env_and_sliced_vector_take_the_keys():
    cfg = compose([*DUMMY, "device=cpu", "env.num_envs=3", "env.pipeline_slices=2", *KEYS["all"]])
    envs = make_vector_env(cfg)
    obs, _ = envs.reset(seed=0)
    assert obs["rgb"].shape == (3, 16, 16, 3) and obs["action_stack"].shape == (3, 4) and obs["reward"].shape == (3, 1)
    for _ in range(2):
        obs, _, term, trunc, _ = envs.step(np.zeros(3, np.int64))
        assert not (term.any() or trunc.any())
    obs, _, term, trunc, infos = envs.step(np.zeros(3, np.int64))
    assert trunc.all() and not term.any() and len(infos["episode"]) == 3


GRID = ["exp=dreamer_v3", "env=jax_gridworld", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]", "env.screen_size=64", "algo.fused_rollout=False"]


@pytest.mark.parametrize("key", list(KEYS))
def test_gridworld_host_lane_takes_the_keys(key):
    sheeprl_tpu.register_all()
    jenv = jax_make_env(jax_compose("config", [*GRID, *KEYS[key]]), 0, 0, None, "test")()
    plain = make_test_env(compose([*GRID, "device=cpu"]))
    keyed = make_test_env(compose([*GRID, "device=cpu", *KEYS[key]]))
    assert set(keyed.observation_space.spaces) == set(jenv.observation_space.spaces)
    for k, space in jenv.observation_space.spaces.items():
        assert tuple(keyed.observation_space[k].shape) == tuple(space.shape), k
    frames = [plain.reset(seed=1)[0]["rgb"]]
    obs = keyed.reset(seed=1)[0]
    gray = key in ("grayscale", "all")
    stack = 3 if key in ("frame_stack", "all") else 1
    for t in range(6):
        want = [rgb_to_gray(f) if gray else f for f in frames]
        want = [want[max(0, len(want) - 1 - 2 * i)] for i in reversed(range(stack))] if stack > 1 else want[-1:]
        np.testing.assert_array_equal(obs["rgb"], np.concatenate(want, -1), err_msg=f"step {t}")
        if gray:
            np.testing.assert_array_equal(obs["rgb"][..., -1], cv2.cvtColor(frames[-1], cv2.COLOR_RGB2GRAY))
        p, _, pterm, ptrunc, _ = plain.step(t % 4)
        obs, _, term, trunc, _ = keyed.step(t % 4)
        frames.append(p["rgb"])
        if key in ("max_episode_steps", "all") and t == 2:
            assert trunc or term
            break
        assert (term, trunc) == (pterm, ptrunc)
        if term or trunc:
            break


@pytest.mark.parametrize("key", ["grayscale", "frame_stack", "reward_as_observation", "actions_as_observation"])
def test_the_fused_lane_raises_on_a_key_it_cannot_honour(key, tmp_path):
    from sheeprl_tpu_torch.cli import run

    cfg = compose(["exp=dreamer_v3_anakin", "device=cpu", *KEYS[key]])
    with pytest.raises(ValueError, match=f"env.{key}"):
        check_fused_env_keys(cfg)
    with pytest.raises(ValueError, match=f"env.{key}"):
        run(["exp=ppo_anakin", "device=cpu", f"log_root={tmp_path}", *KEYS[key]])
    check_fused_env_keys(compose(["exp=dreamer_v3_anakin", "device=cpu", "env.max_episode_steps=7"]))
