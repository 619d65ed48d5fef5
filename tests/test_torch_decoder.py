"""The training slice's modules, JAX package against port, in 32-true:
``DeCNN`` and the bridge's transposed-convolution kernel flip against flax,
and the world model's decoders, reward and continue heads, the critic and
the RSSM's ``dynamic`` and ``imagination`` steps, with weights carried by
sheeprl_tpu_torch/bridge.py. Categorical draws are made deterministic on
both sides: ``jax.random.categorical`` is monkeypatched to the argmax, the
port draws from a constant noise source (Gumbel-max then picks the mode).

Tolerances: atol 1e-5 for one transposed-conv stack, 1e-4 through a world
model (f32 sums in another order through up to four stages, LayerNorms and
the GRU); equality for one-hot states.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.models.models import DeCNN as FlaxDeCNN
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.models.models import DeCNN
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.utils import dotdict


class ConstantNoise(BatchGenerator):
    def __init__(self):
        pass

    def rand(self, shape):
        return torch.full(tuple(shape), 0.5)


def _flax_decnn(channels, kernel, stride, pad, norm):
    n = len(channels)
    return FlaxDeCNN(
        hidden_channels=channels,
        layer_args=[{"kernel_size": kernel, "stride": stride, "padding": pad, "bias": True}] * n,
        activation=["silu"] * (n - 1) + [None],
        norm_layer=[("layer_norm" if norm else None)] * (n - 1) + [None],
        norm_args=[{"eps": 1e-3}] * (n - 1) + [None],
    )


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("channels,kernel,stride,pad,size", [([8, 3], 4, 2, 1, 4), ([6, 5, 3], 3, 1, 1, 5), ([4], 5, 2, 2, 3)])
def test_decnn_matches_flax(channels, kernel, stride, pad, size):
    """Output sizes follow ConvTranspose2d's (in - 1) * stride - 2 * pad + kernel."""
    x = np.random.default_rng(0).standard_normal((2, size, size, 7)).astype(np.float32)
    flax = _flax_decnn(channels, kernel, stride, pad, norm=True)
    params = _perturbed(flax.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(flax.apply({"params": params}, jnp.asarray(x)))
    layers = [(c, kernel, stride, pad, True, 1e-3 if i < len(channels) - 1 else None, "silu" if i < len(channels) - 1 else None) for i, c in enumerate(channels)]
    port = DeCNN(7, layers)
    port.load_state_dict(bridge.decnn_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    out = (size - 1) * stride - 2 * pad + kernel
    for _ in channels[1:]:
        out = (out - 1) * stride - 2 * pad + kernel
    assert got.shape == want.shape == (2, out, out, channels[-1])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_the_bridge_must_flip_the_transposed_kernel():
    """flax's ConvTranspose (transpose_kernel=False) runs its kernel as a
    plain convolution over the dilated input; torch's transposed
    convolution flips it. Without the flip of H and W the port disagrees."""
    x = np.random.default_rng(2).standard_normal((1, 4, 4, 3)).astype(np.float32)
    flax = _flax_decnn([2], 4, 2, 1, norm=False)
    params = _perturbed(flax.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
    want = np.asarray(flax.apply({"params": params}, jnp.asarray(x)))
    flipped = bridge.decnn_state_dict(params)
    kernel = np.asarray(params["deconv_0"]["kernel"])  # HWIO
    np.testing.assert_array_equal(flipped["deconvs.0.weight"].numpy(), kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    port = DeCNN(3, [(2, 4, 2, 1, True, None, None)])
    for state, agree in ((flipped, True), ({**flipped, "deconvs.0.weight": torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())}, False)):
        port.load_state_dict(state)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert np.allclose(got, want, atol=1e-5) == agree


SMALL = [
    "algo.dense_units=16", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.world_model.reward_model.bins=15", "algo.critic.bins=15", "env.screen_size=16",
]  # fmt: skip


@pytest.mark.parametrize("mlp_keys", [False, True])
def test_world_model_heads_and_rssm_steps_match_jax(monkeypatch, mlp_keys):
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    sheeprl_tpu.register_all()
    extra = ["algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]"] if mlp_keys else []
    cfg = jax_compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *SMALL, *extra])
    shapes = {"rgb": (16, 16, 3), **({"state": (5,)} if mlp_keys else {})}
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jagent, state = jax_agent.build_agent(rt, (9,), False, cfg, {k: types.SimpleNamespace(shape=s) for k, s in shapes.items()})
    params = {k: _perturbed(state[k], i) for i, k in enumerate(("world_model", "actor", "critic"))}
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    space = DictSpace({k: Box(s, "uint8" if k == "rgb" else "float32") for k, s in shapes.items()})
    port = build_agent(
        (9,), False, pcfg, space, precision="32-true", device="cpu", training=True,
        world_model_state=bridge.world_model_state_dict(params["world_model"], heads=True),
        actor_state=bridge.actor_state_dict(params["actor"]), critic_state=bridge.mlp_state_dict(params["critic"]),
    )  # fmt: skip
    wm, wm_p = port.world_model, params["world_model"]
    rng = np.random.default_rng(5)
    n, stoch, rec = 6, 16, 32
    latent = rng.standard_normal((2, 3, stoch + rec)).astype(np.float32)

    def jwm(method, *args):
        return jagent.wm(wm_p, *args, method=method)

    with torch.no_grad():
        lt = torch.from_numpy(latent)
        decoded = wm.decode(lt)
        for k, v in jwm("decode", jnp.asarray(latent)).items():
            np.testing.assert_allclose(decoded[k].numpy(), np.asarray(v), atol=1e-4, err_msg=k)
        np.testing.assert_allclose(wm.reward_logits(lt).numpy(), np.asarray(jwm("reward_logits", jnp.asarray(latent))), atol=1e-4)
        np.testing.assert_allclose(wm.continue_logits(lt).numpy(), np.asarray(jwm("continue_logits", jnp.asarray(latent))), atol=1e-4)
        np.testing.assert_allclose(port.critic(lt).numpy(), np.asarray(jagent.critic_logits(params["critic"], jnp.asarray(latent))), atol=1e-4)
        np.testing.assert_allclose(port.target_critic(lt).numpy(), port.critic(lt).numpy(), atol=0)

        z = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, 4))].reshape(n, stoch)
        h = rng.standard_normal((n, rec)).astype(np.float32)
        a = np.eye(9, dtype=np.float32)[rng.integers(0, 9, n)]
        emb = rng.standard_normal((n, wm.representation_model.dense[0].weight.shape[1] - rec)).astype(np.float32)
        first = (np.arange(n) % 3 == 0).astype(np.float32)[:, None]
        want = jwm("dynamic", jnp.asarray(z), jnp.asarray(h), jnp.asarray(a), jnp.asarray(emb), jnp.asarray(first), jax.random.PRNGKey(0))
        got = wm.dynamic(*(torch.from_numpy(x) for x in (z, h, a, emb, first)), ConstantNoise())
        for name, g, w in zip(("recurrent_state", "posterior", "prior", "posterior_logits", "prior_logits"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 if "state" in name or "logits" in name else 0, err_msg=name)
        want = jwm("imagination", jnp.asarray(z), jnp.asarray(h), jnp.asarray(a), jax.random.PRNGKey(1))
        got = wm.imagination(*(torch.from_numpy(x) for x in (z, h, a)), ConstantNoise())
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)


def test_player_weights_do_not_depend_on_building_for_training():
    """The training modules are initialised after the player's, from the same
    generator: a seed gives the player the same weights either way (so
    export-random's artifacts are unchanged by the training build)."""
    from sheeprl_tpu_torch.config import compose

    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *SMALL, "device=cpu"])
    space = DictSpace({"rgb": Box((16, 16, 3), "uint8", 0.0, 255.0)})
    player = build_agent((9,), False, cfg, space, device="cpu", seed=3)
    trainer = build_agent((9,), False, cfg, space, device="cpu", seed=3, training=True)
    for name in ("world_model", "actor"):
        mine = getattr(trainer, name).state_dict()
        for k, v in getattr(player, name).state_dict().items():
            assert torch.equal(v, mine[k]), f"{name}.{k}"
    assert torch.count_nonzero(trainer.world_model.reward_model.output.weight) == 0
    assert torch.count_nonzero(trainer.critic.output.weight) == 0
    assert trainer.world_model.cnn_decoder is not None and player.world_model.cnn_decoder is None
