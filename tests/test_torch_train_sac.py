"""SAC's and DroQ's command lines on the CPU at tiny widths: training on the
host path and on the ring path (``buffer.device=True``, eager on the CPU),
the JAX package's tags, checkpoints and a resume that ends on the
uninterrupted run's parameters bit for bit, ``eval`` replaying the
trainer's test episode, and SAC's export served through the engine.

- Counters: 2 envs, ``learning_starts`` 16 (8 iterations of random
  actions), 48 policy steps, a checkpoint at 32. The JAX ``Ratio`` over
  ``policy_step - prefill + num_envs`` gives 11 gradient steps at the first
  train call and 2 a call after (SAC; DroQ 20 times as many critic steps).
- Resume: the checkpoint holds the agent, the three Adam states, the
  ``Ratio``, the envs, both noise sources, the pending observation and the
  buffer; the resumed run trains at once (the JAX package would wait
  ``learning_starts`` again, ROADMAP C-r5) and ends bit for bit where the
  uninterrupted run ends.
- Serving: a greedy request gives the test episode's action bit for bit; a
  sampled one repeats for its seed.
"""

import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.sac import utils as sac_utils
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.serve import cli as serve_cli
from sheeprl_tpu_torch.serve.artifact import load_artifact
from sheeprl_tpu_torch.serve.engine import InferenceEngine
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = [
    "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.hidden_size=16", "algo.per_rank_batch_size=8",
    "env.num_envs=2", "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=48", "metric.log_every=16",
]  # fmt: skip
FIRST_CALL, PER_CALL = 11, 2  # gradient steps at ratio 1, see the module's docstring
CASES = {
    "sac": ["exp=sac"],
    "sac-ring": ["exp=sac", "buffer.device=True", "algo.fused_train_steps=4"],
    "droq": ["exp=droq"],
    "droq-ring": ["exp=droq", "buffer.device=True", "algo.fused_train_steps=64", "buffer.memmap=False"],
}


def _recording(make, actions):
    def wrapped(*args, **kwargs):
        env = make(*args, **kwargs)
        step = env.step
        env.step = lambda action: (actions.append(np.array(action)), step(action))[1]
        return env

    return wrapped


@pytest.mark.parametrize("case", list(CASES))
def test_trains_resumes_bit_for_bit_and_evaluates(case, tmp_path, monkeypatch):
    actions = []
    monkeypatch.setattr(sac_utils, "make_test_env", _recording(sac_utils.make_test_env, actions))
    args = [*CASES[case], *TINY, f"log_root={tmp_path}", "checkpoint.every=32"]
    out = run(args)
    ratio = 20 if case.startswith("droq") else 1
    calls = 48 // 2 - 16 // 2 + 1
    assert out["policy_steps"] == 48 and out["gradient_steps"] == ratio * (FIRST_CALL + PER_CALL * (calls - 1))
    if case.endswith("ring"):
        assert out["device_buffer"]["active"] and out["fused"]["gradient_steps"] == out["gradient_steps"]
        assert out["fused"]["warmup_steps"] == 0 and out["fused"]["graph"] is None  # eager on the CPU
    else:
        assert out["fused"] is None
    scalars = read_scalars(out["log_dir"])
    steps = {tag: [s for s, _ in values] for tag, values in scalars.items()}
    for tag in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Time/sps_train"):
        assert steps[tag] == [16, 32, 48], (tag, steps[tag])
    assert steps["Params/replay_ratio"] == steps["Time/sps_env_interaction"] == [16, 32, 48] and steps["Test/cumulative_reward"] == [0]
    assert all(np.isfinite(v) for values in scalars.values() for _, v in values)
    assert scalars["Params/replay_ratio"][-1][1] == np.float32(out["gradient_steps"] / 48)

    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_32_0.ckpt")
    state = load_checkpoint(ckpt)
    assert (state["iter_num"], state["batch_size"], state["last_log"], state["last_checkpoint"]) == (16, 8, 32, 32)
    assert {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "ratio", "rb", "envs", "obs"} <= set(state)
    again = run([*args, f"checkpoint.resume_from={ckpt}"])
    assert again["policy_steps"] == 48 and again["gradient_steps"] == out["gradient_steps"]
    whole, part = out["agent"].state_dict(), again["agent"].state_dict()
    assert all(torch.equal(whole[k], part[k]) for k in whole), [k for k in whole if not torch.equal(whole[k], part[k])]
    for name, opt in out["optimizers"].items():
        for p, q in zip(opt.param_groups[0]["params"], again["optimizers"][name].param_groups[0]["params"]):
            assert all(torch.equal(opt.state[p][k], again["optimizers"][name].state[q][k]) for k in opt.state[p])

    trained = list(actions)
    actions.clear()
    reward = evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"])
    assert len(trained) == 2 * len(actions) == 2 * 129 and all(np.array_equal(a, b) for a, b in zip(actions, trained))
    eval_dir = os.path.join(out["log_dir"], "evaluation", "version_0")
    assert read_scalars(eval_dir) == {"Test/cumulative_reward": [(0, np.float32(out["test_reward"]))]} and reward == out["test_reward"]


def test_sac_export_served_through_the_engine(tmp_path, monkeypatch):
    actions = []
    monkeypatch.setattr(sac_utils, "make_test_env", _recording(sac_utils.make_test_env, actions))
    out = run(["exp=sac", *TINY, f"log_root={tmp_path}", "checkpoint.every=0", "metric.log_level=0"])
    path = str(tmp_path / "sac.policy")
    serve_cli.main(["export", f"checkpoint_path={out['checkpoints'][-1]}", "name=sac", f"output_path={path}"])
    art = load_artifact(path, verify_digest=True)
    actor = {k[len("actor.") :]: v for k, v in out["agent"].state_dict().items() if k.startswith("actor.")}
    assert set(art.params) == {"actor"} and art.params["actor"].keys() == actor.keys()
    assert all(torch.equal(art.params["actor"][k], v) for k, v in actor.items())
    assert art.spec["action_space"]["type"] == "box" and art.spec["policy_step"] == 48

    engine = InferenceEngine(device="cpu", max_batch=4)
    try:
        engine.load("sac", path)
        # The dummy env's observation at step t is `state` filled with t.
        for t in range(3):
            obs = {"state": np.full(10, float(t), np.float32).tolist()}
            greedy = engine.act("sac", obs)
            assert greedy.shape == (2,) and np.array_equal(greedy, actions[t]) and np.array_equal(engine.act("sac", obs), greedy)
        obs = {"state": np.linspace(-1, 1, 10).tolist()}
        sampled = [engine.act("sac", obs, mode="sample", seed=s) for s in (3, 3, 4)]
        assert np.array_equal(sampled[0], sampled[1]) and not np.array_equal(sampled[0], sampled[2])
        assert all(((-1 <= a) & (a <= 1)).all() for a in sampled)
    finally:
        engine.close()
