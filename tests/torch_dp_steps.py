"""Ranks of the data-parallel train-step tests of DreamerV2, DreamerV1, the
three Plan2Explore explorations, DroQ, SAC-AE, A2C and recurrent PPO
(tests/test_torch_dp_dreamer_steps.py, test_torch_dp_p2e_steps.py,
test_torch_dp_p2e_dv3_steps.py, test_torch_dp_offpolicy_steps.py,
test_torch_dp_onpolicy_steps.py).

Each ``*_rank`` function runs one trainer's port step on ``runtime``'s data
axis (``runtime`` None: one process, no group) from numpy states, rank 0
holding the batch, and returns numpy results. Like tests/torch_dp_helpers.py
it imports torch and the port only: a spawned rank imports this module, not
the test files, which import JAX. A ``plan`` lists the runs of one call,
each from the same start, each naming its draws or inputs and a planted
fault (:data:`FAULTS`) or None; the result holds one entry per run.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch_dp_helpers import numpy_tree

from sheeprl_tpu_torch.core.mesh import SINGLE
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.utils import dotdict


class ConstantDraws(BatchGenerator):
    """Every uniform ``uniform`` and every standard normal ``normal``: a
    Gumbel-max draw takes the mode, as the JAX side's argmax does."""

    def __init__(self, uniform: float = 0.5, normal: float = 0.0):
        self.uniform_value, self.normal_value = float(uniform), float(normal)

    def rand(self, shape):
        return torch.full(tuple(shape), self.uniform_value)

    def randn(self, shape):
        return torch.full(tuple(shape), self.normal_value)


def draws(noise: Dict[str, Any]) -> BatchGenerator:
    """``{"seed": s}`` -> a generator from ``s``; ``{"uniform", "normal"}``
    -> :class:`ConstantDraws`."""
    if "seed" in noise:
        return BatchGenerator.from_seed(int(noise["seed"]), "cpu")
    return ConstantDraws(noise.get("uniform", 0.5), noise.get("normal", 0.0))


def axis_of(runtime) -> Any:
    return runtime.axis if runtime is not None else SINGLE


def keep_local_on_rank0(real):
    """all_mean_grads whose all_reduce runs (the other rank's matches it)
    but whose result rank 0 drops: rank 0 steps on its own rows."""

    def fault(params, axis, op="mean"):
        params = list(params)
        local = [None if p.grad is None else p.grad.clone() for p in params]
        real(params, axis, op)
        if axis.index == 0:
            for p, g in zip(params, local):
                if g is not None:
                    p.grad.copy_(g)

    return fault


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def planted(fault: Optional[str]):
    """The context that plants ``fault`` in this process (:data:`FAULTS`)."""
    if fault is None:
        return contextlib.nullcontext()
    return FAULTS[fault]()


def _rank0_unreduced():
    """Rank 0's gradients left unreduced, in every trainer's modules."""
    from sheeprl_tpu_torch.algos.a2c import a2c
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.algos.p2e_dv3 import agent as p2e_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae

    stack = contextlib.ExitStack()
    for module in (a2c, dreamer_v1, dreamer_v2, dreamer_v3, p2e_agent, ppo_recurrent, sac, sac_ae):
        stack.enter_context(patched(module, "all_mean_grads", keep_local_on_rank0(module.all_mean_grads)))
    return stack


def _a2c_meaned():
    """A2C's ranks meaned where ``loss_reduction=sum`` sums them."""
    from sheeprl_tpu_torch.algos.a2c import a2c

    real_grads, real_metrics = a2c.all_mean_grads, a2c.all_mean_metrics
    stack = contextlib.ExitStack()
    stack.enter_context(patched(a2c, "all_mean_grads", lambda params, axis, op="mean": real_grads(params, axis, "mean")))
    stack.enter_context(patched(a2c, "all_mean_metrics", lambda metrics, axis, op="mean": real_metrics(metrics, axis, "mean")))
    return stack


def _local_moments():
    """P2E-DV3's intrinsic exploration critic's Moments from this rank's
    λ-returns only: ``update_moments`` without its gather on the second of
    every step's three calls (the critics in name order, then the task)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    real, calls = dreamer_v3.update_moments, [0]

    def fault(*args, gather=None, **kwargs):
        calls[0] += 1
        return real(*args, gather=None if calls[0] % 3 == 2 else gather, **kwargs)

    return patched(dreamer_v3, "update_moments", fault)


def _masks_per_rank():
    """DroQ's keep-masks drawn for this rank's rows alone."""
    from sheeprl_tpu_torch.algos.droq import droq

    real = droq._masks

    def fault(agent, rng, batch_size, rows=slice(None)):
        return real(agent, rng, len(range(batch_size)[rows]))

    return patched(droq, "_masks", fault)


FAULTS = {
    "rank0_unreduced": _rank0_unreduced,
    "a2c_meaned": _a2c_meaned,
    "local_moments": _local_moments,
    "masks_per_rank": _masks_per_rank,
}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _adam_moments(agent: torch.nn.Module, optimizers: Dict[str, torch.optim.Optimizer]) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """{optimizer: {state key: {parameter name: array}}}: every state
    tensor but the step count."""
    names = {id(p): n for n, p in agent.named_parameters()}
    out: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for name, opt in optimizers.items():
        for group in opt.param_groups:
            for p in group["params"]:
                for k, v in opt.state.get(p, {}).items():
                    if isinstance(v, torch.Tensor) and k != "step":
                        out.setdefault(name, {}).setdefault(k, {})[names[id(p)]] = v.detach().numpy().copy()
    return out


# ---------------------------------------------------------------- Dreamers
def _dreamer_agent(family: str, cfg, actions_dim, continuous: bool, space, states):
    """(agent, optimizers, step) of a Dreamer ``family`` over ``axis``."""
    if family == "dv2":
        from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as module
        from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    elif family == "dv1":
        from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as module
        from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
    else:
        module, build_agent = None, None
    if module is not None:
        from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers

        agent = build_agent(actions_dim, continuous, cfg, space, device="cpu", **{f"{k}_state": _torch(v) for k, v in states.items()})
        return agent, make_optimizers(agent, cfg), module.make_train_step
    if family == "p2e_dv2":
        from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as module
        from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent
    elif family == "p2e_dv1":
        from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as module
        from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent
    else:
        from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as module
        from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    agent = build_agent(actions_dim, continuous, cfg, space, device="cpu", states={k: _torch(v) for k, v in states.items()})
    return agent, module.make_optimizers(agent, cfg), module.make_train_step


def dreamer_step_rank(
    runtime, family: str, cfg: Dict[str, Any], states: Dict[str, Dict[str, np.ndarray]], data: Optional[Dict[str, np.ndarray]],
    actions_dim, continuous: bool, obs_shape, plan: Sequence[tuple], tau: float = 0.0,
) -> List[Dict[str, Any]]:  # fmt: skip
    """One gradient step of the port's Dreamer ``family`` (``dv2``, ``dv1``,
    ``p2e_dv2``, ``p2e_dv1``, ``p2e_dv3``) over the runtime's data axis from
    the modules' ``states``, on a vector observation of ``obs_shape``, for
    each ``(noise, fault)`` of ``plan`` (:func:`draws`); rank 0 holds
    ``data``. Returns, per run, the metrics, every module's parameters by
    name and (P2E-DV3) the moments."""
    cfg = dotdict(cfg)
    axis = axis_of(runtime)
    space = DictSpace({"state": Box(tuple(obs_shape), "float32", -20.0, 20.0)})

    def one(noise, fault):
        agent, optimizers, make_step = _dreamer_agent(family, cfg, tuple(actions_dim), continuous, space, states)
        batch = _torch(data) if data is not None and axis.index == 0 else None
        with planted(fault):
            step = make_step(agent, optimizers, cfg, axis)
            if family == "p2e_dv3":
                from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import init_p2e_moments

                moments, metrics = step(init_p2e_moments(agent.critics_cfg, "cpu"), batch, draws(noise), tau)
                moments = {k: {n: {q: float(t) for q, t in m.items()} for n, m in v.items()} if k == "exploration" else {q: float(t) for q, t in v.items()}
                           for k, v in moments.items()}  # fmt: skip
            else:
                metrics, moments = step(batch, draws(noise)), None
        params = {name: numpy_tree(module.state_dict()) for name, module in agent.named_children()}
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": params, "moments": moments}

    return [one(*run) for run in plan]


# ------------------------------------------------------------- off-policy
class GivenSamples:
    """A replay buffer whose ``sample`` calls return the given samples in
    order."""

    def __init__(self, samples: Sequence[Dict[str, np.ndarray]]):
        self.samples, self.calls = list(samples), 0

    def sample(self, n, sample_next_obs=False):
        out = self.samples[self.calls]
        self.calls += 1
        assert len(next(iter(out.values()))[0]) == n
        return out


def _off_policy_agent(algo: str, cfg, obs_space, action_space, state):
    if algo == "droq":
        from sheeprl_tpu_torch.algos.droq import droq as module
        from sheeprl_tpu_torch.algos.droq.agent import build_agent
        from sheeprl_tpu_torch.algos.sac.sac import make_optimizers

        agent = build_agent(cfg, obs_space, action_space, agent_state=_torch(state), device="cpu")
        return module, agent, make_optimizers(agent, cfg), module.DroQTrainer
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae as module
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent

    agent = build_agent(cfg, obs_space, action_space, agent_state=_torch(state), device="cpu")
    return module, agent, module.make_optimizers(agent, cfg), module.SACAETrainer


def off_policy_rank(
    runtime, algo: str, cfg: Dict[str, Any], spaces: Dict[str, Any], state: Dict[str, np.ndarray], plan: Sequence[tuple],
) -> List[Dict[str, Any]]:  # fmt: skip
    """DroQ's or SAC-AE's (``algo``) train call over the runtime's data
    axis from ``state``, for each ``(mode, payload, fault)`` of ``plan``.
    ``mode`` ``step``: the train step with the whole batch's draws given
    (``payload``: the batch and draws; each rank keeps its rows of both).
    ``mode`` ``trainer``: the trainer's host call on rank 0's given samples
    (``payload``: ``samples``, ``steps``, ``first_step``, ``seed`` of the
    draws' generator). Returns, per run, the metrics (each call's, in
    order), the parameters and the optimizers' moments."""
    cfg = dotdict(cfg)
    axis = axis_of(runtime)
    obs_space = DictSpace({k: Box(tuple(shape), dtype, lo, hi) for k, (shape, dtype, lo, hi) in spaces["observations"].items()})
    action_space = Box(tuple(spaces["actions"][0]), "float32", spaces["actions"][1], spaces["actions"][2])

    def rows_of(n):
        return axis.rows(n) if axis.joined else slice(None)

    def one(mode, payload, fault):
        module, agent, optimizers, trainer_cls = _off_policy_agent(algo, cfg, obs_space, action_space, state)
        with planted(fault):
            if mode == "trainer":
                trainer = trainer_cls(agent, optimizers, cfg, BatchGenerator.from_seed(int(payload["seed"]), "cpu"), axis=axis)
                rb = GivenSamples(payload["samples"]) if axis.index == 0 else None
                metrics = trainer.host(rb, int(payload["steps"]), 0.0, int(payload["first_step"]))
            elif algo == "droq":
                B = payload["actor_obs"].shape[0]
                r = rows_of(B)
                critic = {k: torch.from_numpy(np.ascontiguousarray(v[:, r])) for k, v in payload["critic_data"].items()}
                local = {
                    "critic": [{"target_noise": torch.from_numpy(d["target_noise"][r]), "target_masks": [torch.from_numpy(m[:, r]) for m in d["target_masks"]],
                                "masks": [torch.from_numpy(m[:, r]) for m in d["masks"]]} for d in payload["draws"]["critic"]],
                    "actor": {"noise": torch.from_numpy(payload["draws"]["actor"]["noise"][r]),
                              "masks": [torch.from_numpy(m[:, r]) for m in payload["draws"]["actor"]["masks"]]},
                }  # fmt: skip
                metrics = [module.make_train_step(agent, optimizers, cfg, axis)(critic, torch.from_numpy(payload["actor_obs"][r]), local)]
            else:
                B = payload["batch"]["actions"].shape[0]
                r = rows_of(B)
                batch = {k: torch.from_numpy(np.ascontiguousarray(v[r])) for k, v in payload["batch"].items()}
                normals = torch.from_numpy(np.ascontiguousarray(payload["normals"][:, r]))
                uniforms = {k: torch.from_numpy(np.ascontiguousarray(v[r])) for k, v in payload["uniforms"].items()} if payload["flags"][2] else None
                metrics = [module.make_train_step(agent, optimizers, cfg, axis)(batch, normals, uniforms, *payload["flags"])]
        return {
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics], "params": numpy_tree(agent.state_dict()),
            "moments": _adam_moments(agent, optimizers),
        }  # fmt: skip

    return [one(*run) for run in plan]


# -------------------------------------------------------------- on-policy
def on_policy_rank(
    runtime, algo: str, exp_args: List[str], actions_dim, continuous: bool, state: Dict[str, np.ndarray], data: Dict[str, np.ndarray],
    next_obs: Optional[Dict[str, np.ndarray]], indices: np.ndarray, coefs: Sequence[float] = (), plan: Sequence[Optional[str]] = (None,),
) -> List[Dict[str, Any]]:  # fmt: skip
    """One A2C or recurrent PPO (``algo``) update over the runtime's data
    axis from ``state`` for each planted fault (or None) of ``plan``; rank
    0 holds the rollout (A2C: with ``next_obs``) or the sequences (recurrent
    PPO) and the minibatch indices. Returns, per run, the metrics, the
    parameters and the optimizer's moments."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core.onpolicy import make_optimizer

    if algo == "a2c":
        from sheeprl_tpu_torch.algos.a2c import a2c as module
        from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    else:
        from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as module
        from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    cfg = compose([*exp_args, "device=cpu"])
    axis = axis_of(runtime)
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    boxes = {"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0), "state": Box((10,), "float32", -20.0, 20.0)}
    space = DictSpace({k: boxes[k] for k in keys})
    lead = axis.index == 0

    def one(fault):
        agent = build_agent(tuple(actions_dim), continuous, cfg, space, device="cpu", agent_state=_torch(state))
        optimizer, _ = make_optimizer(agent, cfg)
        with planted(fault):
            step = module.make_train_step(agent, optimizer, cfg, axis)
            inputs = [_torch(data) if lead else None]
            if algo == "a2c":
                inputs.append(_torch(next_obs) if lead else None)
            inputs.append(torch.from_numpy(indices) if lead else None)
            metrics = step(*inputs, *[torch.tensor(float(c)) for c in coefs])
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": numpy_tree(agent.state_dict()), "moments": _adam_moments(agent, {"optimizer": optimizer})}

    return [one(fault) for fault in plan]
