"""The port's building blocks against the flax ones, with weights carried by
sheeprl_tpu_torch/bridge.py: LayerNorm, MLP, CNN and the DreamerV3 CNN/MLP
encoders; plus the bridge's refusals and the distributions' sampling rules.
All f32 with numpy inputs from a seed. Tolerance atol 1e-5 (rtol 1e-5): the
same f32 products summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import CNNEncoder as FlaxCNNEncoder
from sheeprl_tpu.algos.dreamer_v3.agent import MLPEncoder as FlaxMLPEncoder
from sheeprl_tpu.models.models import CNN as FlaxCNN
from sheeprl_tpu.models.models import MLP as FlaxMLP
from sheeprl_tpu.models.models import LayerNorm as FlaxLayerNorm
from sheeprl_tpu.utils.distribution import uniform_mix as jax_uniform_mix
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v3.agent import CNNEncoder, MLPEncoder
from sheeprl_tpu_torch.models.models import CNN, MLP, LayerNorm
from sheeprl_tpu_torch.utils.distribution import OneHotCategorical, RowGenerators, uniform_mix

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(params, seed):
    """Non-trivial LayerNorm affines and biases (flax initialises them to 1/0)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), _np(params))


def test_layer_norm_matches_flax():
    x = np.random.default_rng(0).standard_normal((3, 5, 24)).astype(np.float32)
    params = _perturb(FlaxLayerNorm(epsilon=1e-3).init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(FlaxLayerNorm(epsilon=1e-3).apply(params, jnp.asarray(x)))
    ln = LayerNorm(24, eps=1e-3)
    sd = {}
    bridge._layer_norm(params["params"], "ln", "", sd)
    ln.load_state_dict(sd)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), ref, **TOL)
    assert ln(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("norm", [True, False])
def test_mlp_matches_flax(norm):
    x = np.random.default_rng(2).standard_normal((4, 12)).astype(np.float32)
    flax_mlp = FlaxMLP(
        hidden_sizes=(16, 8),
        output_dim=5,
        activation="silu",
        norm_layer="layer_norm" if norm else None,
        norm_args={"eps": 1e-3},
        layer_args={"bias": not norm},
    )
    params = _perturb(flax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    ref = np.asarray(flax_mlp.apply(params, jnp.asarray(x)))
    mlp = MLP(12, (16, 8), 5, activation="silu", norm_eps=1e-3 if norm else None, bias=not norm)
    mlp.load_state_dict(bridge.mlp_state_dict(params))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), ref, **TOL)


def test_cnn_matches_flax_in_nhwc():
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(np.float32)
    flax_cnn = FlaxCNN(
        hidden_channels=(4, 8),
        layer_args={"kernel_size": 4, "stride": 2, "padding": 1, "bias": False},
        activation="silu",
        norm_layer="layer_norm",
        norm_args={"eps": 1e-3},
    )
    params = _perturb(flax_cnn.init(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    ref = np.asarray(flax_cnn.apply(params, jnp.asarray(x)))
    cnn = CNN(3, (4, 8), kernel_size=4, stride=2, padding=1, activation="silu", norm_eps=1e-3, bias=False)
    cnn.load_state_dict(bridge.cnn_state_dict(params))
    out = cnn(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 4, 4, 8)
    np.testing.assert_allclose(out, ref, **TOL)


def test_cnn_encoder_flattens_hwc_like_flax():
    rng = np.random.default_rng(6)
    obs = {"rgb": rng.standard_normal((3, 16, 16, 3)).astype(np.float32), "depth": rng.standard_normal((3, 16, 16, 1)).astype(np.float32)}
    flax_enc = FlaxCNNEncoder(keys=("rgb", "depth"), channels_multiplier=2, stages=2)
    params = _perturb(flax_enc.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in obs.items()}), 7)
    ref = np.asarray(flax_enc.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}))
    enc = CNNEncoder(("rgb", "depth"), (3, 1), 2, stages=2)
    enc.model.load_state_dict(bridge.cnn_state_dict(params["params"]["model"]))
    out = enc({k: torch.from_numpy(v) for k, v in obs.items()}).detach().numpy()
    assert out.shape == ref.shape == (3, 4 * 4 * 4)
    np.testing.assert_allclose(out, ref, **TOL)


def test_mlp_encoder_symlogs_inputs_like_flax():
    rng = np.random.default_rng(8)
    obs = {"state": 10 * rng.standard_normal((4, 6)).astype(np.float32), "extra": rng.standard_normal((4, 2)).astype(np.float32)}
    flax_enc = FlaxMLPEncoder(keys=("state", "extra"), mlp_layers=2, dense_units=16)
    params = _perturb(flax_enc.init(jax.random.PRNGKey(4), {k: jnp.asarray(v) for k, v in obs.items()}), 9)
    ref = np.asarray(flax_enc.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}))
    enc = MLPEncoder(("state", "extra"), (6, 2), mlp_layers=2, dense_units=16)
    enc.model.load_state_dict(bridge.mlp_state_dict(params["params"]["model"]))
    np.testing.assert_allclose(enc({k: torch.from_numpy(v) for k, v in obs.items()}).detach().numpy(), ref, **TOL)


def test_bridge_rejects_unknown_and_malformed_subtrees():
    dense = {"kernel": np.zeros((3, 2), np.float32)}
    with pytest.raises(ValueError, match="unexpected keys"):
        bridge.mlp_state_dict({"dense_0": dense, "surprise": dense})
    with pytest.raises(ValueError, match="expected \\[in, out\\]"):
        bridge.mlp_state_dict({"dense_0": {"kernel": np.zeros((3,), np.float32)}})
    minimal_wm = {
        "recurrent_model": {
            "mlp": {"dense_0": dense},
            "rnn": {"linear": {"kernel": np.zeros((4, 6), np.float32)}, "norm": {"LayerNorm_0": {"scale": np.ones(6, np.float32), "bias": np.zeros(6, np.float32)}}},
        },
        "representation_model": {"output": dense},
        "transition_model": {"output": dense},
        "initial_recurrent_state": np.zeros(2, np.float32),
    }
    sd = bridge.world_model_state_dict({"params": {**minimal_wm, "reward_model": {"output": dense}}})
    assert "recurrent_model.rnn.weight" in sd and not any(k.startswith("reward") for k in sd)
    with pytest.raises(ValueError, match="reward_model"):
        bridge.world_model_state_dict({**minimal_wm, "reward_model": {"output": {"kernel": "not an array"}}})
    with pytest.raises(ValueError, match="unexpected keys"):
        bridge.world_model_state_dict({**minimal_wm, "critic": {"output": dense}})


def test_uniform_mix_matches_jax():
    logits = np.random.default_rng(10).standard_normal((5, 4, 7)).astype(np.float32)
    np.testing.assert_allclose(
        uniform_mix(torch.from_numpy(logits), 0.01).numpy(), np.asarray(jax_uniform_mix(jnp.asarray(logits), 0.01)), **TOL
    )


def test_categorical_sample_is_per_row_and_follows_probs():
    """Each row draws from its own generator (a row's sample does not depend
    on its neighbours), and sample frequencies follow the probs: over 4000
    draws each frequency lies within 5 binomial standard deviations."""
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]))
    dist = OneHotCategorical(logits)
    alone = OneHotCategorical(logits[1:]).sample(RowGenerators.from_seeds([7], "cpu"))
    together = dist.sample(RowGenerators.from_seeds([3, 7], "cpu"))
    assert torch.equal(together[1:], alone)
    gens = RowGenerators.from_seeds([11, 12], "cpu")
    counts = sum(dist.sample(gens) for _ in range(4000))
    freq = counts / 4000
    sd = torch.sqrt(dist.probs * (1 - dist.probs) / 4000)
    assert torch.all((freq - dist.probs).abs() < 5 * sd)
