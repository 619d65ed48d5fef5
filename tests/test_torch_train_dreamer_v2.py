"""DreamerV2's and DreamerV1's command lines on the CPU at tiny widths:
training through ``python -m sheeprl_tpu_torch``'s ``run``, the JAX
package's tags, checkpoints, a resume that ends on the uninterrupted run's
parameters and Adam states bit for bit, and ``eval`` replaying the trainer's
test episode; the entry points raise without a card unless asked for the
CPU; the trainers' ``Time/train_time`` waits for the card once per train
call.

- ``exp=dreamer_v2_ms_pacman`` keeps its episodic, memory-mapped buffer with
  ``prioritize_ends``; the dummy env's episodes are cut to 9 steps
  (``+env.wrapper.n_steps=8``), so each saved episode has 10 rows, more than
  the 8 of a sampled window. ``exp=dreamer_v2`` and ``exp=dreamer_v1`` run
  on the sequential buffer from the ``state`` vector.
- Counters: 2 envs, ``learning_starts`` 24 (12 iterations of random
  actions), 48 policy steps, a checkpoint at 32, replay ratio 0.5.
"""

import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3 import utils as dv3_utils
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer
from sheeprl_tpu_torch.utils import timer as timer_module
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = [
    "env=dummy", "device=cpu", "env.num_envs=2", "buffer.size=256", "algo.learning_starts=24", "algo.total_steps=48",
    "metric.log_every=16", "checkpoint.every=32", "algo.replay_ratio=0.5", "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=8", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=24", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
]  # fmt: skip
CASES = {
    "dreamer_v2-episode": ["exp=dreamer_v2_ms_pacman", "algo.world_model.discrete_size=4",
                           "algo.world_model.encoder.cnn_channels_multiplier=2", "+env.wrapper.n_steps=8"],
    "dreamer_v2-sequential": ["exp=dreamer_v2", "algo.world_model.discrete_size=4"],
    "dreamer_v1": ["exp=dreamer_v1"],
}  # fmt: skip
LOSSES = ("Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "State/kl", "Grads/world_model")


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
    monkeypatch.setattr(dv3_utils, "make_test_env", _recording(dv3_utils.make_test_env, actions))
    args = [*CASES[case], *TINY, f"log_root={tmp_path}"]
    steps = []
    out = run(args, callback=lambda agent, step, metrics: steps.append(step))
    assert out["policy_steps"] == 48 and out["gradient_steps"] == len(steps) > 4 and steps == list(range(1, len(steps) + 1))
    rb = out["buffer"]
    if case == "dreamer_v2-episode":
        assert isinstance(rb, EpisodeBuffer) and rb.prioritize_ends and rb.is_memmap
        assert {len(ep["terminated"]) for ep in rb.buffer} == {10} and len(rb.buffer) == 4
        files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(out["log_dir"], "memmap_buffer")) for f in fs]
        assert len(files) == 4 * 6 and sum(os.path.getsize(f) for f in files) < 10 * 4 * (64 * 64 * 3 + 64)
    else:
        assert isinstance(rb, EnvIndependentReplayBuffer)
    scalars = read_scalars(out["log_dir"])
    logged = {tag: [s for s, _ in values] for tag, values in scalars.items()}
    for tag in LOSSES:
        assert logged[tag] == [32, 48], (tag, logged[tag])
    assert logged["Params/replay_ratio"] == logged["Time/sps_env_interaction"] == [16, 32, 48] and logged["Test/cumulative_reward"] == [0]
    if case == "dreamer_v1":
        assert logged["Params/exploration_amount"] == [32, 48] and scalars["Params/exploration_amount"][0][1] == np.float32(0.3)
    assert all(np.isfinite(v) for values in scalars.values() for _, v in values)

    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_32_0.ckpt")
    state = load_checkpoint(ckpt)
    modules = {"world_model", "actor", "critic"} | ({"target_critic"} if case != "dreamer_v1" else set())
    assert modules | {"world_optimizer", "actor_optimizer", "critic_optimizer", "ratio", "rb", "envs", "obs", "step_data"} <= set(state)
    assert (state["iter_num"], state["batch_size"], state["last_log"], state["last_checkpoint"]) == (16, 2, 32, 32)
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
    assert len(trained) == 2 * len(actions) and all(np.array_equal(a, b) for a, b in zip(actions, trained))
    eval_dir = os.path.join(out["log_dir"], "evaluation", "version_0")
    assert read_scalars(eval_dir) == {"Test/cumulative_reward": [(0, np.float32(out["test_reward"]))]} and reward == out["test_reward"]


@pytest.mark.parametrize("exp", ["dreamer_v2_ms_pacman", "dreamer_v1"])
def test_runs_on_cuda_by_default_and_raises_without_it(exp):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([f"exp={exp}", "env=dummy"])


@pytest.mark.parametrize("device,disabled,calls", [("cuda", False, 1), ("cpu", False, 0), ("cuda", True, 0)])
def test_train_timer_waits_for_the_card_once_per_call(monkeypatch, device, disabled, calls):
    """``train_timer`` synchronises a CUDA device once, at the end of the
    timed train call, and never for the CPU or with the timers off."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    monkeypatch.setattr(timer_module.timer, "disabled", disabled)
    timer_module.timer.reset()
    with timer_module.train_timer(torch.device(device)):
        assert not synced
    assert len(synced) == calls
    assert ("Time/train_time" in timer_module.timer.compute()) == (not disabled)
    timer_module.timer.reset()


@pytest.mark.parametrize("module", ["dreamer_v3.dreamer_v3", "ppo.ppo", "sac.sac", "droq.droq", "dreamer_v2.dreamer_v2"])
def test_every_trainer_times_its_train_calls_with_train_timer(module):
    import importlib
    import inspect

    mod = importlib.import_module(f"sheeprl_tpu_torch.algos.{module}")
    assert mod.train_timer is timer_module.train_timer
    assert 'timer("Time/train_time")' not in inspect.getsource(mod)


def test_dreamer_v2_train_calls_are_each_timed_once(monkeypatch, tmp_path):
    """A run's train calls each enter ``train_timer`` once."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2

    entered = []
    real = dreamer_v2.train_timer

    def counting(device, watchdog=None):
        entered.append(device)
        return real(device, watchdog)

    monkeypatch.setattr(dreamer_v2, "train_timer", counting)
    out = run([*CASES["dreamer_v2-sequential"], *TINY, f"log_root={tmp_path}", "checkpoint.every=0", "algo.run_test=False"])
    assert len(entered) == 48 // 2 - 24 // 2 + 1 and out["gradient_steps"] > 0
