"""Ranks for the port's data-parallel tests (tests/test_torch_distributed.py,
tests/test_torch_dp_train.py).

:func:`run_ranks` runs a function of this module in N spawned processes
joined by a gloo process group whose file store lives in the test's
``tmp_path``, each on one torch thread, and returns what each returned, in
rank order. It waits at most ``timeout`` seconds and fails, naming the
rank, when a rank raises or dies. The rank functions import torch and the
port only (a spawned rank imports this module, not the test file, which
imports JAX). They take plain data (numpy arrays, dicts) and return numpy
arrays.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.core.mesh import (
    all_gather,
    all_mean_grads,
    broadcast_object,
    global_mean_std,
    replicate,
    replicate_generator,
    shard_batch,
)
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.utils.ops import init_moments, update_moments
from sheeprl_tpu_torch.utils.utils import dotdict


def run_ranks(fn: Callable[..., Any], world: int, store_dir, *args: Any, timeout: float = 120.0) -> List[Any]:
    """``fn(runtime, *args)`` in ``world`` spawned gloo ranks; their
    results in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    path = os.path.join(str(store_dir), f"store_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank, args=(world, rank, path, fn, args, results_q)) for rank in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} gave no result within {timeout} s")
            try:
                rank, ok, payload = results_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died with exit codes {[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    return [results[r] for r in range(world)]


def _rank(world: int, rank: int, path: str, fn: Callable[..., Any], args: tuple, results_q) -> None:
    torch.set_num_threads(1)
    runtime = Runtime(world_size=world, accelerator="cpu")
    try:
        runtime.join(path, rank)
        results_q.put((rank, True, fn(runtime, *args)))
    except BaseException:  # noqa: BLE001 - the parent reports the rank's traceback
        results_q.put((rank, False, traceback.format_exc()))
    finally:
        runtime.leave()


def numpy_tree(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------- mesh helpers
def dying_follower(runtime: Runtime) -> None:
    """A follower that dies before its first collective."""
    os._exit(3)


def small_net(state: Optional[Dict[str, np.ndarray]] = None) -> torch.nn.Module:
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1))
    if state is not None:
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net


def grads_of(net: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: p.grad.detach().numpy().copy() for k, p in net.named_parameters()}


def grad_mean_rank(runtime: Runtime, x: np.ndarray, y: np.ndarray, state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The mean-square loss of this rank's rows, its gradient meaned over
    the ranks."""
    axis = runtime.axis
    net = small_net(state)
    rows = axis.rows(len(x))
    loss = ((net(torch.from_numpy(x[rows])) - torch.from_numpy(y[rows])) ** 2).mean()
    loss.backward()
    all_mean_grads(net.parameters(), axis)
    return grads_of(net)


def mesh_round_trip_rank(runtime: Runtime, tree: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """shard_batch of rank 0's tree, replicate of a per-rank tensor and
    generator, broadcast_object, all_gather and global_mean_std."""
    axis = runtime.axis
    mine = shard_batch({k: torch.from_numpy(v) for k, v in tree.items()} if axis.index == 0 else None, axis, dim=1)
    t = torch.full((3, 2), float(axis.index + 7))
    replicate([t], axis)
    gen = torch.Generator().manual_seed(100 + axis.index)
    replicate_generator(gen, axis)
    obj = broadcast_object({"from": axis.index} if axis.index == 0 else None, axis)
    gathered = all_gather(torch.arange(3.0) + 10 * axis.index, axis)
    x = torch.from_numpy(tree["x"]).reshape(-1)[axis.rows(tree["x"].size)]
    mean, std = global_mean_std(x, axis)
    return {
        "shard": numpy_tree(mine), "replicated": t.numpy(), "draw": torch.rand(4, generator=gen).numpy(), "object": obj,
        "gathered": gathered.numpy(), "mean": float(mean), "std": float(std),
    }  # fmt: skip


def moments_rank(runtime: Runtime, x: np.ndarray) -> Dict[str, float]:
    """This rank's block of the returns through update_moments, gathered
    (the port's rule) and per shard (the planted fault)."""
    axis = runtime.axis
    local = torch.from_numpy(x[axis.rows(len(x))])
    gathered, _ = update_moments(init_moments(), local, decay=0.0, gather=lambda v: all_gather(v, axis))
    shard, _ = update_moments(init_moments(), local, decay=0.0)
    return {"low": gathered["low"].item(), "high": gathered["high"].item(), "shard_low": shard["low"].item(), "shard_high": shard["high"].item()}


def metric_rank(runtime: Runtime, values: List[List[float]], log_root: str) -> Optional[Dict[str, float]]:
    """Rank 0: its values into an aggregator of synced Mean, Sum, Max, Min
    and Last and an unsynced Mean, computed after rank 1 has left. Every
    rank opens a data-parallel run's telemetry (rank 0 at a log dir)."""
    import torch.distributed as dist

    from sheeprl_tpu_torch.telemetry import Telemetry
    from sheeprl_tpu_torch.utils import metric as pm

    rank = runtime.global_rank
    log_dir = os.path.join(log_root, "rank0") if rank == 0 else None
    tele = Telemetry(enabled=True).open(log_dir, rank_zero=rank == 0, data_parallel=True)
    tele.close()
    dist.barrier()
    if rank != 0:
        return None
    runtime.leave()
    names = ("MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "LastMetric")
    agg = pm.MetricAggregator({**{n: getattr(pm, n)(sync_on_compute=True) for n in names}, "local": pm.MeanMetric()})
    for v in values[rank]:
        for name in agg:
            agg.update(name, torch.tensor(v) if name == "MeanMetric" else v)
    return agg.compute()


def optimizer_state_rank(runtime: Runtime) -> Dict[str, np.ndarray]:
    """Rank 0: Adam stepped twice on a small net (the state a resume loads);
    the other ranks: a fresh net and Adam. Then replicate_training; returns
    the parameters and Adam's states by name."""
    from sheeprl_tpu_torch.core.mesh import replicate_training

    net = small_net()
    opt = torch.optim.Adam(net.parameters(), lr=0.1)
    if runtime.is_global_zero:
        for _ in range(2):
            opt.zero_grad()
            net(torch.ones(3, 4)).sum().backward()
            opt.step()
    replicate_training(runtime.axis, [net], [opt])
    out = {f"param.{k}": v.detach().numpy().copy() for k, v in net.state_dict().items()}
    for i, p in enumerate(net.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{i}.{k}"] = opt.state[p][k].numpy().copy()
        out[f"{i}.step"] = np.asarray(opt.state[p]["step"])
    return out


# ---------------------------------------------------------------- train steps
def dv3_step_rank(
    runtime: Optional[Runtime], cfg: Dict[str, Any], states: Dict[str, Dict[str, np.ndarray]], data: Optional[Dict[str, np.ndarray]], noise: str,
    tau: float, n_actions: int, screen: int, steps: int = 1,
):
    """``steps`` DreamerV3 gradient steps of the port's ``make_train_step``
    over the runtime's data axis, from the modules' ``states``; rank 0 holds
    ``data``. ``noise`` is ``constant`` (every uniform 0.5: Gumbel-max
    takes the mode, as the JAX side's argmax does) or ``seeded`` (a
    generator from seed 3). Returns the metrics, moments, the pre-clip
    gradients of the first step and the updated parameters."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    class ConstantNoise(BatchGenerator):
        def __init__(self):
            pass

        def rand(self, shape):
            return torch.full(tuple(shape), 0.5)

    cfg = dotdict(cfg)
    t = {k: {n: torch.from_numpy(v) for n, v in s.items()} for k, s in states.items()}
    agent = build_agent(
        (n_actions,), False, cfg, DictSpace({"rgb": Box((screen, screen, 3), "uint8", 0.0, 255.0)}), precision="32-true", device="cpu", training=True,
        world_model_state=t["world_model"], actor_state=t["actor"], critic_state=t["critic"], target_critic_state=t["target_critic"],
    )  # fmt: skip
    optimizers = port_dv3.make_optimizers(agent, cfg)
    grads: Dict[str, Dict[str, np.ndarray]] = {}
    names = {id(agent.world_model): "world_model", id(agent.actor): "actor", id(agent.critic): "critic"}
    clip = port_dv3._clip

    def capture_clip(module, max_norm):
        grads.setdefault(names[id(module)], {k: p.grad.detach().numpy().copy() for k, p in module.named_parameters() if p.grad is not None})
        return clip(module, max_norm)

    port_dv3._clip = capture_clip
    try:
        step = port_dv3.make_train_step(agent, optimizers, cfg, runtime.axis if runtime is not None else port_dv3.SINGLE)
        rng = ConstantNoise() if noise == "constant" else BatchGenerator.from_seed(3, "cpu")
        moments = init_moments()
        lead = data is not None and (runtime is None or runtime.is_global_zero)
        batch = {k: torch.from_numpy(v) for k, v in data.items()} if lead else None
        for _ in range(steps):
            moments, metrics = step(moments, batch, rng, tau)
    finally:
        port_dv3._clip = clip
    params = {name: numpy_tree(getattr(agent, name).state_dict()) for name in ("world_model", "actor", "critic", "target_critic")}
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "moments": {k: v.item() for k, v in moments.items()}, "grads": grads, "params": params}


def ppo_update_rank(runtime: Optional[Runtime], exp_args: List[str], actions_dim, continuous: bool, state: Dict[str, np.ndarray], data, next_obs, indices, clip, ent):
    """One PPO ``make_train_step`` call over the data axis from ``state``;
    rank 0 holds the rollout, the observation and the indices. Returns the
    metrics, the parameters and Adam's moments by parameter name."""
    from sheeprl_tpu_torch.algos.ppo import ppo as port_ppo
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

    cfg = compose([*exp_args, "device=cpu"])
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    boxes = {"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0), "state": Box((10,), "float32", -20.0, 20.0)}
    agent = build_agent(tuple(actions_dim), continuous, cfg, DictSpace({k: boxes[k] for k in keys}), device="cpu",
                        agent_state={k: torch.from_numpy(v) for k, v in state.items()})  # fmt: skip
    optimizer, _ = port_ppo.make_optimizer(agent, cfg)
    axis = runtime.axis if runtime is not None else port_ppo.SINGLE
    step = port_ppo.make_train_step(agent, optimizer, cfg, axis)
    lead = runtime is None or runtime.is_global_zero
    metrics = step(
        {k: torch.from_numpy(v) for k, v in data.items()} if lead else None, {k: torch.from_numpy(v) for k, v in next_obs.items()} if lead else None,
        torch.from_numpy(indices) if lead else None, torch.tensor(clip), torch.tensor(ent),
    )  # fmt: skip
    names = [n for n, _ in agent.named_parameters()]
    moments = {key: {n: optimizer.state[p][key].numpy().copy() for n, p in zip(names, agent.parameters())} for key in ("exp_avg", "exp_avg_sq")}
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "params": numpy_tree(agent.state_dict()), "moments": moments}


def sac_step_rank(runtime: Optional[Runtime], exp_args: List[str], state: Dict[str, np.ndarray], data, noise, tau: float):
    """One SAC ``make_train_step`` call (G steps) over the data axis from
    ``state``; each rank takes its block of the batch's rows and of the
    noise. Returns the metrics, the parameters and Adam's moments."""
    from sheeprl_tpu_torch.algos.sac import sac as port_sac
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

    cfg = compose([*exp_args, "device=cpu"])
    obs_dim, act_dim = data["observations"].shape[-1], data["actions"].shape[-1]
    spaces = DictSpace({"state": Box((obs_dim,), "float32", -20.0, 20.0)}), Box((act_dim,), "float32", -2.0, 1.0)
    agent = build_agent(cfg, *spaces, agent_state={k: torch.from_numpy(v) for k, v in state.items()}, device="cpu")
    optimizers = port_sac.make_optimizers(agent, cfg)
    axis = runtime.axis if runtime is not None else port_sac.SINGLE
    rows = axis.rows(data["rewards"].shape[1]) if axis.joined else slice(None)
    local = {k: torch.from_numpy(np.ascontiguousarray(v[:, rows])) for k, v in data.items()}
    metrics = port_sac.make_train_step(agent, optimizers, cfg, axis)(local, torch.from_numpy(np.ascontiguousarray(noise[:, :, rows])), torch.tensor(tau))
    named = dict(agent.named_parameters())
    moments = {}
    for opt in optimizers.values():
        for p, st in opt.state.items():
            name = next(n for n, q in named.items() if q is p)
            moments[name] = {k: st[k].numpy().copy() for k in ("exp_avg", "exp_avg_sq")}
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "params": numpy_tree(agent.state_dict()), "moments": moments}
