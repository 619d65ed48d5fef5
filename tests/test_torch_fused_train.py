"""The fused train step (``make_fused_train_step``) and the trainer's device
ring and prefetch paths, on the CPU.

The port's fused step takes K = 2 gradient steps (taus 1.0 then 0, a hard
copy then no target update) from a fixed batch, and is held to the JAX
package's ``make_fused_train_step`` fed the same batch by its ``sample_fn``,
with test_torch_train.py's harness: the same weights, the argmax samplers
and its one-step tolerances (parameters within 2.5 * lr, moments 1e-5,
metrics rtol 1e-4 + atol 1e-5), here on the parameters after both steps and
on the bucket's mean metrics. On the CPU the step runs eagerly; on CUDA it
is captured as a CUDA graph, which chip_smoke.py holds to the eager step on
the card. The target critic's EMA reads its tau from a device scalar: a tau
of 0 leaves the target bit for bit and a tau of 1 copies the critic bit for
bit. The trainer with ``buffer.device=True`` (the ring and the fused step)
and with ``buffer.prefetch=True`` takes the host path's gradient steps and
logs its tags, and a ``buffer.device=True`` run resumed from its checkpoint
ends bit for bit on the uninterrupted one.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_checkpoint import _assert_same, _final_state
from test_torch_continuous import TINY_WALKER
from test_torch_train import SMALL, TINY, TREES, ConstantNoise, _capture, _close, _data, _state_dict, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_fused_train_step as jax_make_fused_train_step
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.ops import init_moments
from sheeprl_tpu_torch.utils.utils import dotdict


def test_two_fused_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *SMALL])
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    screen, n_actions, T, B = 16, 9, 5, 3
    jagent, state = jax_agent.build_agent(rt, (n_actions,), False, cfg, {"rgb": types.SimpleNamespace(shape=(screen, screen, 3))})
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    params0 = {k: jax.tree_util.tree_map(np.array, v) for k, v in state.items()}
    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in ("world_model", "actor", "critic")
    }
    opt_states = {name: txs[name].init(state[name]) for name in txs}
    data = _data(np.random.default_rng(1), T, B, screen, n_actions)
    taus = np.asarray([1.0, 0.0], np.float32)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jfused = jax_make_fused_train_step(jagent, txs, cfg, runtime.mesh, lambda ring_state, key: jdata)
    jstate, _, jmoments, jmetrics, _ = jfused(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, jax_init_moments(), {"ring": jnp.zeros(1)}, jax.random.PRNGKey(3), jnp.asarray(taus)
    )  # fmt: skip

    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in ("world_model", "actor", "critic"):
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    port = build_agent(
        (n_actions,), False, pcfg, DictSpace({"rgb": Box((screen, screen, 3), "uint8", 0.0, 255.0)}),
        precision="32-true", device="cpu", training=True,
        world_model_state=_state_dict("world_model", params0["world_model"]), actor_state=_state_dict("actor", params0["actor"]),
        critic_state=_state_dict("critic", params0["critic"]), target_critic_state=_state_dict("critic", params0["target_critic"]),
    )  # fmt: skip
    pdata = {k: torch.from_numpy(v) for k, v in data.items()}
    seen = []
    fused = port_dv3.make_fused_train_step(port, port_dv3.make_optimizers(port, pcfg), pcfg, lambda ring_state, rng: pdata, ConstantNoise())
    pmoments, pmetrics = fused(init_moments(), {"pos": None, "added": None, "data": {}}, taus, lambda i, m: seen.append((i, m)))

    assert [i for i, _ in seen] == [0, 1] and set(seen[0][1]) == set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(pmetrics[k].item(), np.asarray(jmetrics[k]), 1e-5, 1e-4, k)
        _close((seen[0][1][k] + seen[1][1][k]).item() / 2, np.asarray(jmetrics[k]), 1e-5, 1e-4, f"{k} (steps)")
    for k in ("low", "high"):
        _close(pmoments[k].item(), np.asarray(jmoments[k]), 1e-5, 0, f"moments/{k}")
    for name in TREES:
        lr = float(cfg.algo["critic" if name == "target_critic" else name].optimizer.lr)
        want = _state_dict(name, jax.tree_util.tree_map(np.asarray, jstate[name]))
        got = getattr(port, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 2.5 * lr + 1e-6, 0, f"param {name}.{k}")
    assert fused.captured.warmup_calls == fused.captured.replays == 0  # no graph on the CPU
    with pytest.raises(ValueError, match="the ring it was built with"):
        fused(pmoments, {"pos": torch.zeros(1), "added": torch.zeros(1), "data": {}}, taus[:1])


def test_target_ema_is_bit_for_bit_at_tau_0_and_1():
    rng = np.random.default_rng(0)
    target = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)) for _ in range(3)]
    source = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)) for _ in range(3)]
    target[0][0, :3] = -0.0  # a blend would write +0.0 here
    source[1][1, :3] = -0.0
    before = [t.clone() for t in target]
    port_dv3.target_ema_(target, source, torch.tensor(0.0))
    assert all(torch.equal(t.view(torch.int32), b.view(torch.int32)) for t, b in zip(target, before))
    port_dv3.target_ema_(target, source, torch.tensor(1.0))
    assert all(torch.equal(t.view(torch.int32), s.view(torch.int32)) for t, s in zip(target, source))
    tau = torch.tensor(np.float32(0.02))
    mixed = [t * (1 - tau) + s * tau for t, s in zip(before, source)]
    port_dv3.target_ema_(before, source, tau)
    assert all(torch.equal(t, m) for t, m in zip(before, mixed))


TINY_QUIET = [*TINY, "algo.run_test=False"]


@pytest.mark.parametrize(
    "base,extra",
    [(TINY_QUIET, ["buffer.device=True"]), (TINY_QUIET, ["buffer.prefetch=True"]),
     ([*TINY_WALKER, "algo.run_test=False"], ["buffer.device=True", "algo.fused_train_steps=2"])],
    ids=["ms_pacman-device", "ms_pacman-prefetch", "walker-device-fused2"],
)  # fmt: skip
def test_device_ring_and_prefetch_paths_take_the_host_paths_steps(monkeypatch, tmp_path, base, extra):
    monkeypatch.chdir(tmp_path)
    host = run(base)
    steps = []
    out = run([*base, *extra], callback=lambda agent, step, tau, metrics: steps.append((step, tau, sorted(metrics))))
    assert out["gradient_steps"] == host["gradient_steps"] > 0 and [s for s, _, _ in steps] == list(range(1, out["gradient_steps"] + 1))
    assert [sorted(row) for row in out["log"]] == [sorted(row) for row in host["log"]]
    assert all(np.isfinite(v) for row in out["log"] for v in row.values())
    assert steps[0][1] == 1.0 and all(names == steps[0][2] for _, _, names in steps)
    if "buffer.device=True" in extra:
        assert out["device_buffer"]["active"] and out["fused"]["gradient_steps"] == out["gradient_steps"]
        assert out["infeed"] == {"hits": 0, "misses": 0}
    else:
        assert out["fused"] is None and out["infeed"]["hits"] > 0 and out["infeed"]["misses"] == 1  # the first call has nothing staged


def test_device_ring_resume_is_bit_identical(tmp_path):
    """The walker with the ring and 2 fused steps per bucket: 88 policy steps
    in one run against 72, a save, a resume (the ring loaded from the
    checkpointed buffer) and 16 more."""
    base = [*TINY_WALKER, "metric.log_level=0", "buffer.device=True", "algo.fused_train_steps=2", "algo.run_test=False"]
    whole = run([*base, f"log_root={tmp_path / 'whole'}", "algo.total_steps=88"])
    first = run([*base, f"log_root={tmp_path / 'first'}", "algo.total_steps=72"])
    resumed = run([*base, f"log_root={tmp_path / 'resumed'}", "algo.total_steps=88", f"checkpoint.resume_from={first['checkpoints'][-1]}"])
    assert first["gradient_steps"] < whole["gradient_steps"] == resumed["gradient_steps"]
    assert resumed["fused"]["gradient_steps"] == resumed["gradient_steps"] - first["gradient_steps"]
    _assert_same(_final_state(whole), _final_state(resumed))


def test_optimizer_state_loads_with_the_optimizers_own_capturable():
    """A state saved by a card's optimizer (capturable, its step count on
    the card) loads into a CPU optimizer with a host step count, and the
    moments as saved."""
    cfg = compose(TINY)
    agent = build_agent((9,), False, cfg, DictSpace({"rgb": Box((16, 16, 3), "uint8", 0.0, 255.0)}), device="cpu", seed=0, training=True)
    optimizers = port_dv3.make_optimizers(agent, cfg)
    for p in agent.parameters():
        p.grad = torch.ones_like(p)
    for opt in optimizers.values():
        opt.step()
    state = port_dv3.training_state(agent, optimizers, init_moments())
    for key in port_dv3.OPTIMIZER_KEYS.values():
        for group in state[key]["param_groups"]:
            group["capturable"] = True
    fresh = port_dv3.make_optimizers(agent, cfg)
    port_dv3.load_training_state(agent, fresh, state, torch.device("cpu"))
    for opt in fresh.values():
        assert all(not g["capturable"] for g in opt.param_groups)
        for entry in opt.state.values():
            assert entry["step"].device.type == "cpu" and float(entry["step"]) == 1.0
