"""SAC-AE training (counterpart of sheeprl_tpu/algos/sac_ae/sac_ae.py; SAC
from pixels with a regularised autoencoder, https://arxiv.org/abs/1910.01741).

:func:`make_train_step` is the JAX ``make_train_step`` (``sac_ae.py:52-171``)
in its order, each stage on its own cadence flag:

1. the critic: the soft target from the ONLINE encoder's next features (the
   actor's next actions) and the TARGET encoder's (the target critics), then
   one Adam over the encoder and the critics on the sum of the critics' MSEs;
2. with ``update_ema``: the target critics' EMA at ``algo.tau`` and the
   target encoder's at ``algo.encoder.tau``;
3. with ``update_actor``: the actor's Adam step on the updated encoder's
   features, detached (:func:`actor_features`), against the updated
   critics' MIN with alpha held, then alpha's on the actor's log-probs;
4. with ``update_decoder``: the autoencoder, the encoder's own Adam and the
   decoder's (weight decay folded into the gradient), on the mean squared
   error of each decoder key's reconstruction against its target (pixels
   reduced to 5 bits and dequantised, :func:`preprocess_obs`), plus
   ``l2_lambda * 0.5 * mean(sum(h^2))`` of the features once, as the JAX
   package does (``sac_ae.py:150-154``).

Every backward names the parameters it differentiates and every optimizer
clears its gradients before it, so no stage's gradient reaches another's
step: the encoder has two Adam states (the critic's and its own). The step
takes its draws as tensors: the standard normals ``[2, B, A]`` (the
target's, then the actor's) and, with ``update_decoder``, a uniform per
pixel decoder key; the trainer draws them, a parity test passes the JAX
function's. The stages run under ``record_function`` spans
(``sac_ae/critic``, ``sac_ae/actor``, ``sac_ae/decoder``). No kernel of the
port runs on this path: the convolutions are cuDNN's, its deterministic
algorithms (an H100 picks weight-gradient algorithms that sum in an unfixed
order otherwise, and a resumed run then leaves the uninterrupted one).

:func:`main` is SAC's :func:`run_off_policy` with SAC-AE's agent, the pixel
and vector keys stored as they are (pixels uint8) with their ``next_<key>``
rows, and the cadences read from the gradient steps taken before each call
(``actor.per_rank_update_freq``,
``critic.per_rank_target_network_update_freq``,
``decoder.per_rank_update_freq``). SAC-AE has no ring path
(``buffer.device``), no fused step and no serve module, as in the JAX
package. Over a data axis (``fabric.devices`` > 1) each rank takes its block
of every batch's rows and of the whole batch's draws, every stage means its
gradients over the ranks (the encoder's under both of its Adams), and the
EMAs and cadences are the same on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import Metrics, OffPolicyAlgo, _float_batch, draw_noise, run_off_policy
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import normalize_pixels, prepare_obs, preprocess_obs, test
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_grads, all_mean_metrics, shard_batch
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.serve.spaces import DictSpace
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.timer import train_timer

OPTIMIZER_KEYS = {
    "qf": "qf_optimizer", "actor": "actor_optimizer", "alpha": "alpha_optimizer", "encoder": "encoder_optimizer",
    "decoder": "decoder_optimizer",
}  # fmt: skip
RECONSTRUCTION_BITS = 5  # the pixels' target is reduced to this many bits (sac_ae.py:139)


def make_optimizers(agent: SACAEAgent, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One Adam each for the encoder with the critics (the critic's
    settings), the actor, ``log_alpha``, the encoder alone and the decoder."""
    return {
        "qf": build_optimizer([*agent.encoder.parameters(), *agent.qfs.parameters()], cfg.algo.critic.optimizer),
        "actor": build_optimizer(agent.actor.parameters(), cfg.algo.actor.optimizer),
        "alpha": build_optimizer([agent.log_alpha], cfg.algo.alpha.optimizer),
        "encoder": build_optimizer(agent.encoder.parameters(), cfg.algo.encoder.optimizer),
        "decoder": build_optimizer(agent.decoder.parameters(), cfg.algo.decoder.optimizer),
    }


def _step(optimizers: List[torch.optim.Optimizer], loss: torch.Tensor, axis: DataAxis = SINGLE) -> None:
    """``loss``'s gradient into the parameters of ``optimizers`` only,
    meaned over the data ``axis``'s ranks, and their steps."""
    params = [p for opt in optimizers for group in opt.param_groups for p in group["params"]]
    for opt in optimizers:
        opt.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    all_mean_grads(params, axis)
    for opt in optimizers:
        opt.step()


def actor_features(agent: SACAEAgent, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The actor's and alpha's input: the encoder's features, detached."""
    return agent.encoder(obs).detach()


def make_train_step(agent: SACAEAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, axis: DataAxis = SINGLE) -> Callable[..., Metrics]:
    """-> ``step(batch, normals, uniforms, update_actor, update_ema,
    update_decoder) -> metrics``: one gradient step on ``batch`` (the
    encoder's keys and their ``next_<key>``, pixels uint8, ``actions``,
    ``rewards``, ``terminated``, each ``[B, ...]``) with ``normals`` ``[2, B,
    A]`` and ``uniforms`` {pixel decoder key: ``[B, H, W, C]`` in [0, 1)}
    (read with ``update_decoder`` only); the metrics are the losses of the
    stages that ran (``value_loss``, ``policy_loss``, ``alpha_loss``,
    ``reconstruction_loss``). Over a data ``axis`` B is this rank's rows,
    and the metrics are averaged over the ranks."""
    algo = cfg.algo
    gamma, l2_lambda = float(algo.gamma), float(algo.decoder.l2_lambda)
    cnn_keys, keys = list(algo.cnn_keys.encoder), list(algo.cnn_keys.encoder) + list(algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = list(algo.cnn_keys.decoder), list(algo.mlp_keys.decoder)
    device = agent.log_alpha.device
    tau, encoder_tau = torch.tensor(agent.tau, device=device), torch.tensor(agent.encoder_tau, device=device)

    def q_min(features: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return agent.qfs(features, actions).min(-1, keepdim=True).values

    def step(batch: Dict[str, torch.Tensor], normals: torch.Tensor, uniforms: Optional[Dict[str, torch.Tensor]], update_actor: bool,
             update_ema: bool, update_decoder: bool) -> Metrics:  # fmt: skip
        # cuDNN's deterministic convolutions (TF32 off): the default weight-gradient
        # algorithms at these widths accumulate in an unfixed order, which would break a bit-for-bit resume.
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            return all_mean_metrics(stages(batch, normals, uniforms, update_actor, update_ema, update_decoder), axis)

    def stages(batch, normals, uniforms, update_actor, update_ema, update_decoder) -> Metrics:
        obs = normalize_pixels({k: batch[k] for k in keys}, cnn_keys)
        with record_function("sac_ae/critic"):
            next_obs = normalize_pixels({k: batch[f"next_{k}"] for k in keys}, cnn_keys)
            target = agent.next_target_q_values(next_obs, batch["rewards"], batch["terminated"], gamma, normals[0])
            qf_loss = critic_loss(agent.qfs(agent.encoder(obs), batch["actions"]), target, agent.num_critics)
            _step([optimizers["qf"]], qf_loss, axis)
            metrics = {"value_loss": qf_loss.detach()}
            if update_ema:
                agent.targets_ema_(tau, encoder_tau)
        if update_actor:
            with record_function("sac_ae/actor"):
                features = actor_features(agent, obs)
                alpha = agent.log_alpha.exp().detach()
                actions, logprobs = agent.actions_and_log_probs(features, normals[1])
                actor_loss = policy_loss(alpha, logprobs, q_min(features, actions))
                _step([optimizers["actor"]], actor_loss, axis)
                alpha_loss = entropy_loss(agent.log_alpha, logprobs, agent.target_entropy)
                _step([optimizers["alpha"]], alpha_loss, axis)
                metrics.update(policy_loss=actor_loss.detach(), alpha_loss=alpha_loss.detach())
        if update_decoder:
            with record_function("sac_ae/decoder"):
                hidden = agent.encoder(obs)
                reconstruction = agent.decoder(hidden)
                loss = 0.0
                for k in cnn_dec + mlp_dec:
                    rec = reconstruction[k]
                    target = preprocess_obs(batch[k], uniforms[k], RECONSTRUCTION_BITS) if k in cnn_dec else batch[k].reshape(rec.shape)
                    loss = loss + ((target - rec) ** 2).mean()
                loss = loss + l2_lambda * 0.5 * (hidden**2).sum(-1).mean()
                _step([optimizers["encoder"], optimizers["decoder"]], loss, axis)
                metrics["reconstruction_loss"] = loss.detach()
        return metrics

    return step


def _freqs(cfg) -> Tuple[int, int, int]:
    algo = cfg.algo
    return tuple(int(f) for f in (algo.actor.per_rank_update_freq, algo.critic.per_rank_target_network_update_freq, algo.decoder.per_rank_update_freq))


def cadence(cfg, gradient_step: int) -> Tuple[bool, bool, bool]:
    """(update_actor, update_ema, update_decoder) of the gradient step after
    ``gradient_step`` taken ones (``sac_ae.py:453-462``)."""
    return tuple(gradient_step % f == 0 for f in _freqs(cfg))


def draw(rng: BatchGenerator, batch: Dict[str, torch.Tensor], action_dim: int, cfg, update_decoder: bool, axis: DataAxis = SINGLE):
    """One step's draws from ``rng``: the normals, then (with
    ``update_decoder``) a uniform per pixel decoder key. Over a data
    ``axis`` they are drawn for every rank's rows, and this rank's
    ``batch`` rows kept."""
    n = batch["actions"].shape[0]
    rows = axis.rows(n * axis.size) if axis.joined else slice(None)
    normals = draw_noise(rng, n * axis.size, action_dim)[:, rows]
    uniforms = {k: rng.rand((n * axis.size, *batch[k].shape[1:]))[rows] for k in cfg.algo.cnn_keys.decoder} if update_decoder else None
    return normals, uniforms


class SACAETrainer:
    """SAC-AE's train calls for :func:`run_off_policy`: the host path only
    (the loop's tau is SAC's; SAC-AE's EMAs follow their own cadence);
    ``watchdog`` is the run's, armed around each call's wait."""

    watchdog = None

    def __init__(self, agent: SACAEAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, rng: BatchGenerator, axis: DataAxis = SINGLE):
        self.agent, self.cfg, self.rng, self.axis = agent, cfg, rng, axis
        self.batch_size = int(cfg.algo.per_rank_batch_size)
        self.sample_next_obs = bool(cfg.buffer.sample_next_obs)
        self.pixels = [*cfg.algo.cnn_keys.encoder, *(f"next_{k}" for k in cfg.algo.cnn_keys.encoder)]
        self.step = make_train_step(agent, optimizers, cfg, axis)

    def host(self, rb: Optional[ReplayBuffer], steps: int, tau: float, first_step: int = 0) -> List[Metrics]:
        """``steps`` gradient steps on one sample of ``steps`` x B rows, the
        cadences from ``first_step``, the steps taken before. Over a data
        axis rank 0 samples (the other ranks pass no ``rb``) and every rank
        keeps its block of each step's B rows."""
        device = self.agent.log_alpha.device
        data = None
        if rb is not None:
            sample = rb.sample(steps * self.batch_size, sample_next_obs=self.sample_next_obs)
            data = _float_batch(sample, steps, self.batch_size, device, keep=self.pixels)
        out = []
        with train_timer(device, self.watchdog):
            if self.axis.joined:
                data = shard_batch(data, self.axis, dim=1, device=device)
            for i in range(steps):
                batch = {k: v[i] for k, v in data.items()}
                flags = cadence(self.cfg, first_step + i)
                normals, uniforms = draw(self.rng, batch, self.agent.action_dim, self.cfg, flags[2], self.axis)
                out.append(self.step(batch, normals, uniforms, *flags))
        return out

    def work_key(self, steps: int, first_step: int) -> str:
        """What a host call's work depends on beyond its step count: its
        steps' cadence flags, set by ``first_step``'s place in the cadences'
        common period."""
        period = math.lcm(*_freqs(self.cfg))
        return f"_c{first_step % period}of{period}"

    def fused_info(self) -> None:
        return None


@dataclass(frozen=True)
class PixelObservations:
    """SAC-AE's observations: the encoder's pixel keys (uint8) and vector
    keys (f32, flat), each stored under its own key and ``next_<key>``."""

    cnn_keys: Tuple[str, ...]
    mlp_keys: Tuple[str, ...]

    @classmethod
    def from_config(cls, cfg, observation_space: DictSpace, algo: str) -> "PixelObservations":
        enc = (set(cfg.algo.cnn_keys.encoder), set(cfg.algo.mlp_keys.encoder))
        dec = (set(cfg.algo.cnn_keys.decoder), set(cfg.algo.mlp_keys.decoder))
        if not (enc[0] & dec[0]) and not (enc[1] & dec[1]):
            raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjoint")
        for kind, e, d in (("CNN", enc[0], dec[0]), ("MLP", enc[1], dec[1])):
            if d - e:
                raise RuntimeError(
                    f"The {kind} keys of the decoder must be contained in the encoder ones, got: decoder = {sorted(d)}, encoder = {sorted(e)}"
                )
        if cfg.metric.log_level > 0:
            print("Encoder CNN keys:", list(cfg.algo.cnn_keys.encoder), flush=True)
            print("Encoder MLP keys:", list(cfg.algo.mlp_keys.encoder), flush=True)
        return cls(tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder))

    @property
    def buffer_keys(self) -> Tuple[str, ...]:
        return self.cnn_keys + self.mlp_keys

    env_keys = buffer_keys

    def rows(self, obs: Dict[str, np.ndarray], num_envs: int, prefix: str = "") -> Dict[str, np.ndarray]:
        prepared = prepare_obs(obs, cnn_keys=self.cnn_keys, mlp_keys=self.mlp_keys, num_envs=num_envs)
        return {f"{prefix}{k}": v[np.newaxis] for k, v in prepared.items()}

    def player(self, obs: Dict[str, np.ndarray], num_envs: int, device: torch.device) -> Dict[str, torch.Tensor]:
        prepared = prepare_obs(obs, cnn_keys=self.cnn_keys, mlp_keys=self.mlp_keys, num_envs=num_envs)
        return normalize_pixels({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, self.cnn_keys)


SAC_AE = OffPolicyAlgo(
    "SAC-AE", build_agent, SACAETrainer, PixelObservations.from_config, make_optimizers, OPTIMIZER_KEYS, test,
    player_state=("encoder.", "actor."), overlap_train=False,
)  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[SACAEAgent, int, List[Metrics]], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train SAC-AE on ``cfg`` on ``cfg.device`` (:func:`run_off_policy`, over ``runtime``'s ranks)."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "")).lower():
        raise ValueError(
            "MineDojo is not currently supported by SAC-AE agent, since it does not take into consideration the action masks provided by "
            "the environment, but needed in order to play correctly the game. As an alternative you can use one of the Dreamers' agents."
        )
    if cfg.buffer.get("device", False):
        raise ValueError("SAC-AE has no ring path: set buffer.device=False (the JAX package's SAC-AE has no device buffer either)")
    cfg.env.screen_size = 64  # cannot be changed (sac_ae.py:193)
    return run_off_policy(cfg, callback, SAC_AE, runtime)
