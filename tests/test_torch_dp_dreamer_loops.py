"""The command line at ``fabric.devices=2`` against ``fabric.devices=1`` on
the CPU for DreamerV2, DreamerV1 and the P2E-DV2 chain (exploration, then
finetuning), and P2E-DV2 exploration checkpoints finetuned across world
sizes (saved at 1 rank, finetuned at 2; saved at 2, finetuned at 1).

The bound is tests/test_torch_dp_train.py's ``check_close_runs`` at
DreamerV3's 5e-2: every parameter leaf's change since the reference run's
first checkpoint, d, within 5e-2 of the reference's, ``||d_got - d_want|| <=
5e-2 ||d_want||``, and the losses logged at the end within 1e-3 relative.
Each checkpoint's manifest records the run's world size. The target critics
are hard-copied every 2 gradient steps so that they move within the runs.
"""

import os

import pytest
import torch
from test_torch_dp_train import check_close_runs, first_ckpt, flat_params

from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, read_manifest

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = [
    "env=dummy", "device=cpu", "env.num_envs=2", "env.sync_env=True", "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=32",
    "metric.log_every=16", "checkpoint.every=16", "algo.replay_ratio=0.25", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
    "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.run_test=False",
]  # fmt: skip
DV2 = ["algo.world_model.discrete_size=4", "algo.critic.per_rank_target_network_update_freq=2"]
P2E = [*DV2, "algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1"]
EXPS = {
    "dreamer_v2": ["exp=dreamer_v2", *TINY, *DV2],
    "dreamer_v1": ["exp=dreamer_v1", *TINY],
    "p2e_dv2_exploration": ["exp=p2e_dv2_exploration", *TINY, *P2E],
}
FINETUNE = ["exp=p2e_dv2_finetuning", *TINY, *P2E]


# A P2E checkpoint's keys for the task side's modules (the JAX trainer's).
P2E_KEYS = {"actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task"}


def summary(out):
    return {"params": flat_params(dict(out["agent"].named_children())), "log": out["log"]}


def start_of(out, p2e):
    """The run's parameters at its first checkpoint, by the agent's names."""
    state = load_checkpoint(first_ckpt(out))
    keys = P2E_KEYS if p2e else {}
    return {f"{name}.{k}": v.numpy() for name, _ in out["agent"].named_children() for k, v in state[keys.get(name, name)].items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every exp at fabric.devices=1 and =2, and the finetunings of the
    exploration checkpoints: (saved, finetuned at) = (1, 1), (1, 2), (2, 1)."""
    root = tmp_path_factory.mktemp("dp_dreamer_loops")
    out = {(exp, n): run([*args, f"fabric.devices={n}", f"log_root={root / exp / str(n)}"]) for exp, args in EXPS.items() for n in (1, 2)}
    for saved, at in ((1, 1), (1, 2), (2, 1)):
        ckpt = out[("p2e_dv2_exploration", saved)]["checkpoints"][-1]
        out[("finetune", saved, at)] = run(
            [*FINETUNE, f"fabric.devices={at}", f"log_root={root / f'finetune_{saved}_{at}'}", f"checkpoint.exploration_ckpt_path={ckpt}"]
        )
    return out


@pytest.mark.parametrize("exp", list(EXPS))
def test_two_ranks_train_as_one(exp, runs):
    """fabric.devices=2 runs two ranks (the run and its manifests say so),
    takes the one-rank run's gradient steps and ends within the bound."""
    outs = {n: runs[(exp, n)] for n in (1, 2)}
    for n, out in outs.items():
        assert out["world_size"] == n and out["checkpoints"]
        assert {read_manifest(c)["world_size"] for c in out["checkpoints"]} == {n}
    assert outs[2]["gradient_steps"] == outs[1]["gradient_steps"] > 0
    check_close_runs(summary(outs[2]), summary(outs[1]), start_of(outs[1], exp.startswith("p2e")), f"{exp}: devices=2 against devices=1")


@pytest.mark.parametrize("saved, at", [(1, 2), (2, 1)], ids=["saved-at-1-finetuned-at-2", "saved-at-2-finetuned-at-1"])
def test_an_exploration_checkpoint_finetunes_across_world_sizes(runs, saved, at):
    """The finetuning of an exploration checkpoint saved at ``saved`` ranks
    runs at ``at`` ranks (rank 0 reads the checkpoint, the other ranks take
    its state by broadcast) and ends within the bound of the one-rank
    finetuning of the one-rank exploration."""
    got, want = runs[("finetune", saved, at)], runs[("finetune", 1, 1)]
    assert got["world_size"] == at and got["gradient_steps"] == want["gradient_steps"] > 0
    assert {read_manifest(c)["world_size"] for c in got["checkpoints"]} == {at}
    check_close_runs(summary(got), summary(want), start_of(want, True), f"finetuning saved at {saved}, run at {at}")
