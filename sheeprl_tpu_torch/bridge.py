"""Carry DreamerV3, PPO, A2C, recurrent PPO, SAC, DroQ, SAC-AE, DreamerV2, DreamerV1 and P2E weights from the JAX package's param trees into the port.

Also :func:`anakin_env_state`, a JAX env state as a batched env's.

Input: the ``world_model``, ``actor`` and ``critic`` trees of the JAX
DreamerV3 train state, or the JAX PPO agent's params, as nested dicts of
numpy arrays (with or without the top ``params`` level), the JAX PPO agent's
params, the JAX SAC or DroQ train state (``actor``, ``qfs``,
``qfs_target``, ``log_alpha``), or the JAX DreamerV2 or DreamerV1 train
state (``world_model``, ``actor``, ``critic`` and DreamerV2's
``target_critic``), the JAX P2E-DV3, P2E-DV2 or P2E-DV1 train state, the
JAX SAC-AE train state, or the JAX recurrent PPO agent's params. Output: state
dicts for the port's ``WorldModel``, ``Actor`` and critic ``MLP``, its
``PPOAgent`` (also A2C's), its ``RecurrentPPOAgent``, its
``SACAgent``/``DROQAgent``, or one per module of its ``DV2Agent`` or
``DV1Agent``, or one per module of its ``P2EDV3Agent``, ``P2EDV2Agent`` or
``P2EDV1Agent``, or its ``SACAEAgent``.

- A Dense ``[in, out]`` kernel becomes a Linear ``[out, in]`` weight.
- A conv HWIO kernel becomes OIHW.
- A transposed-conv kernel (flax ``nn.ConvTranspose``, HWIO, with the default
  ``transpose_kernel=False``) becomes torch's ``[in, out, kh, kw]`` with H and
  W flipped: flax runs it as a plain convolution over the dilated input,
  torch's transposed convolution flips its kernel.
- ``LayerNorm_i/LayerNorm_0/{scale, bias}`` becomes ``norms.i.{weight, bias}``;
  flax's bare ``nn.LayerNorm`` (SAC-AE's encoder ``ln``) ``ln.{weight, bias}``.
- The GRU's ``linear/kernel`` [D, 3H] is kept as it is: its rows are in
  ``[h, x]`` order and the port's cell and kernel read that layout.
  DreamerV1's flax ``GRUCell`` (``ir``, ``iz``, ``in``, ``hr``, ``hz``,
  ``hn``) becomes the port's ``FlaxGRUCell``: the three input kernels and
  biases stacked as one Linear (gates r, z, n), the three recurrent kernels
  as another, and ``hn``'s bias as ``hidden_bias``.
- flax's ``OptimizedLSTMCell`` (``ii``, ``if``, ``ig``, ``io`` without
  bias; ``hi``, ``hf``, ``hg``, ``ho`` with one) becomes the port's
  ``ResetLSTMCell``: the input kernels stacked in gate order as one
  Linear, the recurrent kernels and biases as another.
- The CNN embedding stays flattened in HWC order: the port flattens NHWC,
  so the next Dense's rows need no permutation.
- A critic ensemble under ``nn.vmap`` (SAC, DroQ) keeps its stacked
  ``[n, in, out]`` kernels and ``[n, out]`` biases as they are: the port's
  ``EnsembleLinear`` holds that layout. Its LayerNorms' ``[n, H]`` scale and
  bias become ``norms.i.{weight, bias}``. P2E's ensemble (``ensembles``) is
  such a stack without the ``qfs/model`` wrapper, and without hidden biases
  when LayerNorms follow its layers.
- With ``heads=False`` (the player), the world-model subtrees that acting
  does not use (decoders, reward and continue heads) are skipped by name
  after a check that they are well formed; with ``heads=True`` (training)
  they are carried too. Any other key, missing or left over, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
_UNUSED_WORLD_MODEL_KEYS = ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model")


def _tensor(x: Any) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind != "f":
        raise ValueError(f"expected a float array, got dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _take(tree: Mapping[str, Any], path: str) -> Dict[str, Any]:
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a mapping, got {type(tree).__name__}")
    return dict(tree)


def _done(rest: Dict[str, Any], path: str) -> None:
    if rest:
        raise ValueError(f"{path}: unexpected keys {sorted(rest)}")


def _check_well_formed(tree: Any, path: str) -> None:
    """A skipped subtree must still be nested mappings of float arrays."""
    if isinstance(tree, Mapping):
        if not tree:
            raise ValueError(f"{path}: empty subtree")
        for key, sub in tree.items():
            _check_well_formed(sub, f"{path}/{key}")
        return
    try:
        _tensor(tree)
    except (TypeError, ValueError) as err:
        raise ValueError(f"{path}: malformed leaf ({err})") from None


def _dense(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    rest = _take(tree, path)
    kernel = _tensor(rest.pop("kernel"))
    if kernel.dim() != 2:
        raise ValueError(f"{path}/kernel: expected [in, out], got {tuple(kernel.shape)}")
    out[f"{prefix}weight"] = kernel.t().contiguous()
    if "bias" in rest:
        out[f"{prefix}bias"] = _tensor(rest.pop("bias"))
    _done(rest, path)


def _conv(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    rest = _take(tree, path)
    kernel = _tensor(rest.pop("kernel"))
    if kernel.dim() != 4:
        raise ValueError(f"{path}/kernel: expected HWIO, got {tuple(kernel.shape)}")
    out[f"{prefix}weight"] = kernel.permute(3, 2, 0, 1).contiguous()
    if "bias" in rest:
        out[f"{prefix}bias"] = _tensor(rest.pop("bias"))
    _done(rest, path)


def _deconv(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    rest = _take(tree, path)
    kernel = _tensor(rest.pop("kernel"))
    if kernel.dim() != 4:
        raise ValueError(f"{path}/kernel: expected HWIO, got {tuple(kernel.shape)}")
    out[f"{prefix}weight"] = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    if "bias" in rest:
        out[f"{prefix}bias"] = _tensor(rest.pop("bias"))
    _done(rest, path)


def _layer_norm(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    rest = _take(tree, path)
    inner = _take(rest.pop("LayerNorm_0"), f"{path}/LayerNorm_0")
    out[f"{prefix}weight"] = _tensor(inner.pop("scale"))
    out[f"{prefix}bias"] = _tensor(inner.pop("bias"))
    _done(inner, f"{path}/LayerNorm_0")
    _done(rest, path)


def _stack(tree: Any, path: str, prefix: str, out: StateDict, layer: str, port_layer: str, convert) -> None:
    """An MLP (``layer="dense"``) or CNN (``layer="conv"``): ``{layer}_i``,
    ``LayerNorm_i`` and, for an MLP, ``output``."""
    rest = _take(tree, path)
    for key in sorted(rest):
        name, _, idx = key.rpartition("_")
        if name == layer and idx.isdigit():
            convert(rest.pop(key), f"{path}/{key}", f"{prefix}{port_layer}.{idx}.", out)
        elif name == "LayerNorm" and idx.isdigit():
            _layer_norm(rest.pop(key), f"{path}/{key}", f"{prefix}norms.{idx}.", out)
    if layer == "dense" and "output" in rest:
        _dense(rest.pop("output"), f"{path}/output", f"{prefix}output.", out)
    _done(rest, path)


def _mlp(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    _stack(tree, path, prefix, out, "dense", "dense", _dense)


def _gru(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    rest = _take(tree, path)
    linear = _take(rest.pop("linear"), f"{path}/linear")
    out[f"{prefix}weight"] = _tensor(linear.pop("kernel"))  # [D, 3H], rows [h, x]
    if "bias" in linear:
        out[f"{prefix}bias"] = _tensor(linear.pop("bias"))
    _done(linear, f"{path}/linear")
    if "norm" in rest:
        _layer_norm(rest.pop("norm"), f"{path}/norm", f"{prefix}norm.", out)
    _done(rest, path)


def _params(tree: Mapping[str, Any]) -> Dict[str, Any]:
    tree = _take(tree, "<root>")
    if set(tree) == {"params"}:
        tree = _take(tree["params"], "params")
    return tree


def mlp_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """A port ``MLP``'s state dict from a flax ``MLP``'s params (the critic
    and the target critic are such MLPs)."""
    out: StateDict = {}
    _mlp(_params(tree), "mlp", "", out)
    return out


def cnn_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """A port ``CNN``'s state dict from a flax ``CNN``'s params."""
    out: StateDict = {}
    _stack(_params(tree), "cnn", "", out, "conv", "convs", _conv)
    return out


def _heads(rest: Dict[str, Any], out: StateDict) -> None:
    """The decoders and the reward and continue heads."""
    if "cnn_decoder" in rest:
        dec = _take(rest.pop("cnn_decoder"), "cnn_decoder")
        _dense(dec.pop("fc"), "cnn_decoder/fc", "cnn_decoder.fc.", out)
        _stack(dec.pop("model"), "cnn_decoder/model", "cnn_decoder.model.", out, "deconv", "deconvs", _deconv)
        _done(dec, "cnn_decoder")
    if "mlp_decoder" in rest:
        dec = _take(rest.pop("mlp_decoder"), "mlp_decoder")
        _mlp(dec.pop("model"), "mlp_decoder/model", "mlp_decoder.model.", out)
        for key in sorted(dec):
            name, _, idx = key.rpartition("_")
            if name == "head" and idx.isdigit():
                _dense(dec.pop(key), f"mlp_decoder/{key}", f"mlp_decoder.heads.{idx}.", out)
        _done(dec, "mlp_decoder")
    _mlp(rest.pop("reward_model"), "reward_model", "reward_model.", out)
    if "continue_model" in rest:  # DreamerV2 and DreamerV1 have one only with use_continues
        _mlp(rest.pop("continue_model"), "continue_model", "continue_model.", out)


def decnn_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """A port ``DeCNN``'s state dict from a flax ``DeCNN``'s params."""
    out: StateDict = {}
    _stack(_params(tree), "decnn", "", out, "deconv", "deconvs", _deconv)
    return out


def world_model_state_dict(tree: Mapping[str, Any], heads: bool = False) -> StateDict:
    """The port's ``WorldModel`` state dict from the JAX world-model params;
    ``heads`` carries the decoders and heads (a world model built for
    training) instead of skipping them."""
    rest = _params(tree)
    out: StateDict = {}
    if heads:
        _heads(rest, out)
    for key in _UNUSED_WORLD_MODEL_KEYS:
        if key in rest:
            _check_well_formed(rest.pop(key), key)
    _rssm(rest, out, _gru)
    out["initial_recurrent_state"] = _tensor(rest.pop("initial_recurrent_state"))
    _done(rest, "world_model")
    return out


def _rssm(rest: Dict[str, Any], out: StateDict, rnn) -> None:
    """The encoders, the recurrent model (its cell converted by ``rnn``), and
    the representation and transition models."""
    if "cnn_encoder" in rest:
        enc = _take(rest.pop("cnn_encoder"), "cnn_encoder")
        _stack(enc.pop("model"), "cnn_encoder/model", "cnn_encoder.model.", out, "conv", "convs", _conv)
        _done(enc, "cnn_encoder")
    if "mlp_encoder" in rest:
        enc = _take(rest.pop("mlp_encoder"), "mlp_encoder")
        _mlp(enc.pop("model"), "mlp_encoder/model", "mlp_encoder.model.", out)
        _done(enc, "mlp_encoder")
    rec = _take(rest.pop("recurrent_model"), "recurrent_model")
    _mlp(rec.pop("mlp"), "recurrent_model/mlp", "recurrent_model.mlp.", out)
    rnn(rec.pop("rnn"), "recurrent_model/rnn", "recurrent_model.rnn.", out)
    _done(rec, "recurrent_model")
    _mlp(rest.pop("representation_model"), "representation_model", "representation_model.", out)
    _mlp(rest.pop("transition_model"), "transition_model", "transition_model.", out)


def _flax_gru(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    """flax ``nn.GRUCell`` -> the port's ``FlaxGRUCell``."""
    rest = _take(tree, path)
    gates = {}
    for name in ("ir", "iz", "in", "hr", "hz", "hn"):
        gates[name] = _take(rest.pop(name), f"{path}/{name}")
    out[f"{prefix}input.weight"] = torch.cat([_tensor(gates[g].pop("kernel")) for g in ("ir", "iz", "in")], 1).t().contiguous()
    out[f"{prefix}input.bias"] = torch.cat([_tensor(gates[g].pop("bias")) for g in ("ir", "iz", "in")])
    out[f"{prefix}hidden.weight"] = torch.cat([_tensor(gates[g].pop("kernel")) for g in ("hr", "hz", "hn")], 1).t().contiguous()
    out[f"{prefix}hidden_bias"] = _tensor(gates["hn"].pop("bias"))
    for name, gate in gates.items():
        _done(gate, f"{path}/{name}")
    _done(rest, path)


def _dreamer_state_dict(state: Mapping[str, Any], rnn) -> Dict[str, StateDict]:
    rest = _take(state, "<root>")
    out: Dict[str, StateDict] = {}
    wm = _params(rest.pop("world_model"))
    out["world_model"] = {}
    _heads(wm, out["world_model"])
    _rssm(wm, out["world_model"], rnn)
    _done(wm, "world_model")
    out["actor"] = actor_state_dict(rest.pop("actor"))
    for name in ("critic", "target_critic"):
        if name in rest:
            out[name] = mlp_state_dict(rest.pop(name))
    _done(rest, "<root>")
    return out


def dreamer_v2_state_dict(state: Mapping[str, Any]) -> Dict[str, StateDict]:
    """The port's ``DV2Agent`` modules' state dicts from the JAX DreamerV2
    train state (``world_model``, ``actor``, and ``critic`` and
    ``target_critic`` where given): {module name: state dict}."""
    return _dreamer_state_dict(state, _gru)


def dreamer_v1_state_dict(state: Mapping[str, Any]) -> Dict[str, StateDict]:
    """The port's ``DV1Agent`` modules' state dicts from the JAX DreamerV1
    train state (``world_model``, ``actor``, and ``critic`` where given)."""
    return _dreamer_state_dict(state, _flax_gru)


def actor_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """The port's ``Actor`` state dict from the JAX actor params."""
    rest = _params(tree)
    out: StateDict = {}
    _mlp(rest.pop("model"), "model", "model.", out)
    for key in sorted(rest):
        name, _, idx = key.rpartition("_")
        if name == "head" and idx.isdigit():
            _dense(rest.pop(key), key, f"heads.{idx}.", out)
    _done(rest, "actor")
    return out



def _ppo_modules(rest: Dict[str, Any], out: StateDict) -> None:
    """PPO's encoders (at the flax tree's top level; under
    ``feature_extractor`` in the port), actor and critic, popped from ``rest``."""
    if "cnn_encoder" in rest:
        enc = _take(rest.pop("cnn_encoder"), "cnn_encoder")
        model = _take(enc.pop("model"), "cnn_encoder/model")
        prefix = "feature_extractor.cnn_encoder.model."
        _stack(model.pop("cnn"), "cnn_encoder/model/cnn", out=out, prefix=f"{prefix}cnn.", layer="conv", port_layer="convs", convert=_conv)
        _dense(model.pop("fc"), "cnn_encoder/model/fc", f"{prefix}fc.", out)
        _done(model, "cnn_encoder/model")
        _done(enc, "cnn_encoder")
    if "mlp_encoder" in rest:
        enc = _take(rest.pop("mlp_encoder"), "mlp_encoder")
        if "model" in enc:
            _mlp(enc.pop("model"), "mlp_encoder/model", "feature_extractor.mlp_encoder.model.", out)
        _done(enc, "mlp_encoder")
    actor = _take(rest.pop("actor"), "actor")
    if "backbone" in actor:
        _mlp(actor.pop("backbone"), "actor/backbone", "actor.backbone.", out)
    for key in sorted(actor):
        name, _, idx = key.rpartition("_")
        if name == "head" and idx.isdigit():
            _dense(actor.pop(key), f"actor/{key}", f"actor.heads.{idx}.", out)
    _done(actor, "actor")
    _mlp(rest.pop("critic"), "critic", "critic.", out)


def ppo_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """The port's ``PPOAgent`` state dict from the JAX PPO agent's params:
    the NatureCNN's convolutions and ``fc``, the MLP encoder, the actor's
    backbone and heads, and the critic."""
    rest = _params(tree)
    out: StateDict = {}
    _ppo_modules(rest, out)
    _done(rest, "ppo")
    return out


a2c_state_dict = ppo_state_dict  # A2C's agent is PPO's


def ppo_recurrent_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """The port's ``RecurrentPPOAgent`` state dict from the JAX recurrent PPO
    agent's params: PPO's modules, the optional ``pre_rnn_mlp`` and
    ``post_rnn_mlp``, and flax's ``OptimizedLSTMCell`` (``lstm/cell``): its
    input kernels ``ii``, ``if``, ``ig``, ``io`` stacked in that gate order
    as ``lstm.input``, its recurrent kernels and biases ``hi`` ... ``ho`` as
    ``lstm.hidden``."""
    rest = _params(tree)
    out: StateDict = {}
    _ppo_modules(rest, out)
    for name in ("pre_rnn_mlp", "post_rnn_mlp"):
        if name in rest:
            _mlp(rest.pop(name), name, f"{name}.", out)
    lstm = _take(rest.pop("lstm"), "lstm")
    out.update({f"lstm.{k}": v for k, v in lstm_cell_state_dict(lstm).items()})
    _done(rest, "ppo_recurrent")
    return out


def lstm_cell_state_dict(tree: Mapping[str, Any]) -> StateDict:
    """The port's ``ResetLSTMCell`` state dict from the params of the JAX
    ``_ResetLSTMCell`` (``{"cell": {ii, if, ig, io, hi, hf, hg, ho}}``, with
    or without the top ``params`` level)."""
    rest = _params(tree)
    cell = _take(rest.pop("cell"), "cell")
    _done(rest, "lstm")
    out: StateDict = {}
    for side, port in (("i", "input"), ("h", "hidden")):
        gates = [_take(cell.pop(f"{side}{g}"), f"cell/{side}{g}") for g in "ifgo"]
        out[f"{port}.weight"] = torch.cat([_tensor(gate.pop("kernel")) for gate in gates], 1).t().contiguous()
        if side == "h":
            out["hidden.bias"] = torch.cat([_tensor(gate.pop("bias")) for gate in gates])
        for g, gate in zip("ifgo", gates):
            _done(gate, f"cell/{side}{g}")
    _done(cell, "cell")
    return out


def _ensemble(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    """A vmapped critic ensemble ``{qfs: {model: MLP}}`` with its leading
    member axis kept."""
    rest = _params(tree)
    model = _take(rest.pop("qfs"), f"{path}/qfs").pop("model")
    _done(rest, path)
    _ensemble_mlp(model, f"{path}/qfs/model", prefix, out)


def _ensemble_mlp(tree: Any, path: str, prefix: str, out: StateDict) -> None:
    """An MLP's params stacked over a leading member axis: ``[n, in, out]``
    kernels, ``[n, out]`` biases (a hidden layer may have none) and ``[n,
    dim]`` LayerNorms, kept as they are (``EnsembleLinear``'s layout)."""
    model = _take(tree, path)
    for key in sorted(model):
        name, _, idx = key.rpartition("_")
        if (name == "dense" and idx.isdigit()) or key == "output":
            layer = _take(model.pop(key), f"{path}/{key}")
            kernel = _tensor(layer.pop("kernel"))
            bias = _tensor(layer.pop("bias")) if "bias" in layer or key == "output" else None
            if kernel.dim() != 3 or (bias is not None and bias.dim() != 2):
                raise ValueError(f"{path}/{key}: expected [n, in, out] and [n, out], got {tuple(kernel.shape)} and {None if bias is None else tuple(bias.shape)}")
            _done(layer, f"{path}/{key}")
            where = "output." if key == "output" else f"dense.{idx}."
            out[f"{prefix}{where}weight"] = kernel
            if bias is not None:
                out[f"{prefix}{where}bias"] = bias
        elif name == "LayerNorm" and idx.isdigit():
            _layer_norm(model.pop(key), f"{path}/{key}", f"{prefix}norms.{idx}.", out)
    _done(model, path)


def sac_state_dict(state: Mapping[str, Any]) -> StateDict:
    """The port's ``SACAgent`` (or ``DROQAgent``) state dict from the JAX
    SAC/DroQ train state: the actor's MLP trunk and heads, the critics and
    their targets (with DroQ's LayerNorms), and ``log_alpha``."""
    rest = _take(state, "<root>")
    out: StateDict = {}
    actor = _params(rest.pop("actor"))
    _mlp(actor.pop("model"), "actor/model", "actor.model.", out)
    for head in ("fc_mean", "fc_logstd"):
        _dense(actor.pop(head), f"actor/{head}", f"actor.{head}.", out)
    _done(actor, "actor")
    for name in ("qfs", "qfs_target"):
        _ensemble(rest.pop(name), name, f"{name}.model.", out)
    out["log_alpha"] = _tensor(rest.pop("log_alpha")).reshape(1)
    _done(rest, "sac")
    return out


droq_state_dict = sac_state_dict


def _p2e_dreamer(state: Mapping[str, Any], dv3: bool, rnn=_gru) -> tuple:
    """The task side of a JAX P2E train state (``world_model``,
    ``actor_task``, ``critic_task`` and, but for DreamerV1,
    ``target_critic_task``) as the DreamerV3 (``dv3``), DreamerV2 or
    DreamerV1 (``rnn``: its cell's converter) agent's modules, the
    exploration actor, and the ensemble stacked over its members; returns
    (their state dicts, what is left of ``state``)."""
    rest = _take(state, "<root>")
    task = {"world_model": rest.pop("world_model"), "actor": rest.pop("actor_task")}
    for name in ("critic", "target_critic"):
        if f"{name}_task" in rest:
            task[name] = rest.pop(f"{name}_task")
    if dv3:
        out = {"world_model": world_model_state_dict(task.pop("world_model"), heads=True), "actor": actor_state_dict(task.pop("actor"))}
        out.update({name: mlp_state_dict(tree) for name, tree in task.items()})
    else:
        out = _dreamer_state_dict(task, rnn)
    out["actor_exploration"] = actor_state_dict(rest.pop("actor_exploration"))
    out["ensembles"] = {}
    _ensemble_mlp(_params(rest.pop("ensembles")), "ensembles", "", out["ensembles"])
    return out, rest


def p2e_dv3_state_dict(state: Mapping[str, Any]) -> Dict[str, StateDict]:
    """The port's ``P2EDV3Agent`` modules' state dicts from the JAX P2E-DV3
    train state: ``world_model``, ``actor`` (the task actor), ``critic``,
    ``target_critic``, ``actor_exploration``, ``critics_exploration`` (the
    JAX ``{name: {module, target_module}}`` as ``<name>.module.*`` and
    ``<name>.target_module.*``) and ``ensembles`` (``EnsembleMLP``, no
    hidden bias where a LayerNorm follows)."""
    out, rest = _p2e_dreamer(state, True)
    critics = _take(rest.pop("critics_exploration"), "critics_exploration")
    out["critics_exploration"] = {}
    for name in sorted(critics):
        pair = _take(critics.pop(name), f"critics_exploration/{name}")
        for which in ("module", "target_module"):
            out["critics_exploration"].update({f"{name}.{which}.{k}": v for k, v in mlp_state_dict(pair.pop(which)).items()})
        _done(pair, f"critics_exploration/{name}")
    _done(rest, "p2e_dv3")
    return out


def p2e_dv2_state_dict(state: Mapping[str, Any]) -> Dict[str, StateDict]:
    """The port's ``P2EDV2Agent`` modules' state dicts from the JAX P2E-DV2
    train state: ``world_model``, ``actor``, ``critic``, ``target_critic``,
    ``actor_exploration``, ``critic_exploration``,
    ``target_critic_exploration`` and ``ensembles``."""
    out, rest = _p2e_dreamer(state, False)
    for name in ("critic_exploration", "target_critic_exploration"):
        out[name] = mlp_state_dict(rest.pop(name))
    _done(rest, "p2e_dv2")
    return out


def p2e_dv1_state_dict(state: Mapping[str, Any]) -> Dict[str, StateDict]:
    """The port's ``P2EDV1Agent`` modules' state dicts from the JAX P2E-DV1
    train state: ``world_model``, ``actor``, ``critic``,
    ``actor_exploration``, ``critic_exploration`` and ``ensembles`` (the
    embedding's predictors, with their hidden biases)."""
    out, rest = _p2e_dreamer(state, False, _flax_gru)
    out["critic_exploration"] = mlp_state_dict(rest.pop("critic_exploration"))
    _done(rest, "p2e_dv1")
    return out


def sac_ae_state_dict(state: Mapping[str, Any]) -> StateDict:
    """The port's ``SACAEAgent`` state dict from the JAX SAC-AE train state:
    the encoder and its target (the pixel branch's convolutions, ``fc`` and
    flax's bare ``ln``; the vector branch's MLP), the decoder (``fc``, the
    transposed convolutions of ``model`` and ``to_obs`` flipped to torch's
    layout; the vector branch's MLP and its ``head_<key>`` Dense layers),
    the actor, the critics and their targets, and ``log_alpha``."""
    rest = _take(state, "<root>")
    out: StateDict = {}
    for name in ("encoder", "encoder_target"):
        enc = _params(rest.pop(name))
        if "cnn_encoder" in enc:
            cnn = _take(enc.pop("cnn_encoder"), f"{name}/cnn_encoder")
            prefix = f"{name}.cnn_encoder."
            _stack(cnn.pop("model"), f"{name}/cnn_encoder/model", f"{prefix}model.", out, "conv", "convs", _conv)
            _dense(cnn.pop("fc"), f"{name}/cnn_encoder/fc", f"{prefix}fc.", out)
            ln = _take(cnn.pop("ln"), f"{name}/cnn_encoder/ln")
            out[f"{prefix}ln.weight"], out[f"{prefix}ln.bias"] = _tensor(ln.pop("scale")), _tensor(ln.pop("bias"))
            _done(ln, f"{name}/cnn_encoder/ln")
            _done(cnn, f"{name}/cnn_encoder")
        if "mlp_encoder" in enc:
            mlp = _take(enc.pop("mlp_encoder"), f"{name}/mlp_encoder")
            _mlp(mlp.pop("model"), f"{name}/mlp_encoder/model", f"{name}.mlp_encoder.model.", out)
            _done(mlp, f"{name}/mlp_encoder")
        _done(enc, name)
    dec = _params(rest.pop("decoder"))
    if "cnn_decoder" in dec:
        cnn = _take(dec.pop("cnn_decoder"), "decoder/cnn_decoder")
        _dense(cnn.pop("fc"), "decoder/cnn_decoder/fc", "decoder.cnn_decoder.fc.", out)
        for part in ("model", "to_obs"):
            _stack(cnn.pop(part), f"decoder/cnn_decoder/{part}", f"decoder.cnn_decoder.{part}.", out, "deconv", "deconvs", _deconv)
        _done(cnn, "decoder/cnn_decoder")
    if "mlp_decoder" in dec:
        mlp = _take(dec.pop("mlp_decoder"), "decoder/mlp_decoder")
        _mlp(mlp.pop("model"), "decoder/mlp_decoder/model", "decoder.mlp_decoder.model.", out)
        for key in sorted(mlp):
            if not key.startswith("head_"):
                continue
            _dense(mlp.pop(key), f"decoder/mlp_decoder/{key}", f"decoder.mlp_decoder.heads.{key[len('head_'):]}.", out)
        _done(mlp, "decoder/mlp_decoder")
    _done(dec, "decoder")
    actor = _params(rest.pop("actor"))
    _mlp(actor.pop("model"), "actor/model", "actor.model.", out)
    for head in ("fc_mean", "fc_logstd"):
        _dense(actor.pop(head), f"actor/{head}", f"actor.{head}.", out)
    _done(actor, "actor")
    for name in ("qfs", "qfs_target"):
        _ensemble(rest.pop(name), name, f"{name}.model.", out)
    out["log_alpha"] = _tensor(rest.pop("log_alpha")).reshape(1)
    _done(rest, "sac_ae")
    return out


def anakin_env_state(state: Mapping[str, Any], device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """A JAX env's state pytree (``sheeprl_tpu/envs/jax``: ``{"s", "t"}``
    or the gridworld's ``{"agent", "goal", "t"}``, as numpy arrays) as the
    batched port env's state dict: the same keys and dtypes, a leading
    batch axis added to a single env's state (a ``vmap``-ed one keeps its)."""
    single = np.ndim(state["t"]) == 0
    return {k: torch.from_numpy(np.array(v)[None] if single else np.array(v)).to(device) for k, v in state.items()}
