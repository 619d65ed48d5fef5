"""SAC's actor replica (counterpart of sheeprl_tpu/algos/sac/fleet_actor.py).

It runs inside a :class:`~sheeprl_tpu_torch.core.fleet.FleetSupervisor`
replica process: it steps its vector env and ships one ``rows`` message per
vector step (the shipment is its heartbeat), acting at random until the
learner's first broadcast (the prefill's counterpart) and with the newest
actor weights after it, its normals drawn from a ``torch.Generator`` seeded
with the replica's seed. Transitions stand alone, so the learner mixes
shipments of any replicas and generations, and a restarted replica ships
fresh trajectories from its reseed.
"""

from __future__ import annotations

import torch


def actor_loop(ctx) -> None:
    """The replica's loop (``sheeprl_tpu_torch.algos.sac.fleet_actor:actor_loop``)."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import VectorObservations, step_rows
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    cfg = ctx.cfg
    # Every draw of the replica (env seeds, random actions, the policy's
    # normals) keys off its seed: restart k explores a fresh stream.
    cfg.seed = ctx.seed
    num_envs = int(cfg.env.num_envs)
    layout = VectorObservations(tuple(cfg.algo.mlp_keys.encoder))  # the learner's row layout (sac.py:step_rows)
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    device = torch.device(ctx.device)

    envs = make_vector_env(cfg, ctx.replica)
    action_shape = tuple(envs.single_action_space.shape)
    agent = build_agent(cfg, envs.single_observation_space, envs.single_action_space, device=device, seed=ctx.seed)
    rng = BatchGenerator.from_seed(ctx.seed, device)
    obs = envs.reset(seed=cfg.seed)[0]
    version = 0
    try:
        while not ctx.should_stop():
            got = ctx.poll_params()
            if got is not None and got[0] != version:
                version = got[0]
                agent.load_state_dict({k: torch.from_numpy(v) for k, v in got[1].items()}, strict=False)
            if version == 0:
                actions = envs.sample_actions()  # no broadcast yet: the learner still prefills
            else:
                actions = agent.get_actions(layout.player(obs, num_envs, device), rng).cpu().numpy()
            next_obs, rewards, terminated, truncated, infos = envs.step(actions.reshape((num_envs, *action_shape)))
            episodes = [(float(r), float(n)) for _, r, n in infos["episode"]]
            row = step_rows(layout, obs, next_obs, actions, rewards, terminated, truncated, infos, num_envs, sample_next_obs)
            # A drop_shipment injector may swallow it: the env steps still happened.
            ctx.ship(row, env_steps=num_envs, episodes=episodes, meta={"cuda_initialized": torch.cuda.is_initialized()})
            obs = next_obs
    finally:
        if hasattr(envs, "close"):
            envs.close()
