"""The port stands alone: importing every module of sheeprl_tpu_torch loads
no JAX, no module of sheeprl_tpu, and none of gymnasium, cv2, dm_control,
mujoco, yaml, flax, orbax, tensorboardX or tensorboard (which the machine
with the card does not have). Checked in a subprocess,
since tests/conftest.py imports JAX into this one. Its entry points run on
CUDA unless asked for the CPU, so on this CUDA-less host they raise."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gymnasium", "yaml", "sheeprl_tpu", "tensorboardX", "tensorboard", "cv2", "dm_control",
             "mujoco")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import sheeprl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_import_every_module_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    training = ["algos.dreamer_v3.dreamer_v3", "algos.dreamer_v3.loss", "data.buffers", "envs.dummy", "optim", "config", "cli", "__main__",
                "utils.checkpoint", "data.memmap", "utils.metric", "utils.timer", "utils.logger", "registry", "eval",
                "algos.dreamer_v3.evaluate", "data.device_buffer", "data.infeed", "core.graphs", "config.reader", "config.loader",
                "config.instantiate", "algos.ppo.agent", "algos.ppo.loss", "algos.ppo.utils", "algos.ppo.ppo", "algos.ppo.evaluate",
                "algos.ppo.serve", "core.rollout", "envs.wrappers", "models.models", "utils.ops",
                "algos.sac.agent", "algos.sac.loss", "algos.sac.utils", "algos.sac.sac", "algos.sac.evaluate", "algos.sac.serve",
                "algos.droq.agent", "algos.droq.utils", "algos.droq.droq", "algos.droq.evaluate",
                "algos.dreamer_v2.agent", "algos.dreamer_v2.loss", "algos.dreamer_v2.utils", "algos.dreamer_v2.dreamer_v2",
                "algos.dreamer_v2.evaluate", "algos.dreamer_v1.agent", "algos.dreamer_v1.loss", "algos.dreamer_v1.utils",
                "algos.dreamer_v1.dreamer_v1", "algos.dreamer_v1.evaluate", "utils.distribution", "algos.a2c.a2c", "algos.a2c.loss",
                "algos.a2c.utils", "algos.a2c.evaluate", "algos.ppo_recurrent.agent", "algos.ppo_recurrent.ppo_recurrent",
                "algos.ppo_recurrent.utils", "algos.ppo_recurrent.evaluate", "algos.p2e_dv3.agent", "algos.p2e_dv3.utils",
                "algos.p2e_dv3.p2e_dv3_exploration", "algos.p2e_dv3.p2e_dv3_finetuning", "algos.p2e_dv3.evaluate",
                "algos.p2e_dv2.agent", "algos.p2e_dv2.utils", "algos.p2e_dv2.p2e_dv2_exploration",
                "algos.p2e_dv2.p2e_dv2_finetuning", "algos.p2e_dv2.evaluate", "algos.p2e_dv1.agent", "algos.p2e_dv1.utils",
                "algos.p2e_dv1.p2e_dv1_exploration", "algos.p2e_dv1.p2e_dv1_finetuning", "algos.p2e_dv1.evaluate", "algos.sac_ae.agent",
                "algos.sac_ae.utils", "algos.sac_ae.sac_ae", "algos.sac_ae.evaluate", "envs.anakin", "envs.anakin.base", "envs.anakin.cartpole",
                "envs.anakin.pendulum", "envs.anakin.gridworld", "envs.anakin.adapter", "envs.anakin.host", "core.fused_loop",
                "core.interact", "core.player", "core.mesh", "algos.ppo.ppo_decoupled", "algos.sac.sac_decoupled", "telemetry",
                "telemetry.trace_context", "telemetry.tracer", "telemetry.histogram", "telemetry.registry", "telemetry.step_timer",
                "telemetry.cuda_events", "telemetry.profiling", "telemetry.perf", "telemetry.bench_db", "telemetry.flight",
                "telemetry.telemetry", "telemetry.__main__", "core.chaos", "core.resilience", "telemetry.health", "utils.env", "utils.imports",
                "envs.gym_env", "envs.dmc", "envs.vector"]
    for name in ["serve.engine", "bridge", *training]:
        assert f"sheeprl_tpu_torch.{name}" in report["modules"], name
    assert not [m for m in report["loaded"] if m in FORBIDDEN]


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.serve import dreamer_v3_s_ms_pacman_config
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.utils import dotdict

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(autostart=False)
    obs_space = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_agent((9,), False, dotdict(dreamer_v3_s_ms_pacman_config()), obs_space)
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["exp=dreamer_v3_100k_ms_pacman", "env=dummy"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["exp=ppo_atari", "env=dummy"])
    for exp in ("sac", "droq", "sac_ae"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run([f"exp={exp}", "env=dummy", "env.id=continuous_dummy"])
    for exp in ("dreamer_v2_ms_pacman", "dreamer_v2", "dreamer_v1", "a2c", "ppo_recurrent", "p2e_dv3_exploration", "p2e_dv2_exploration",
                "p2e_dv1_exploration"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run([f"exp={exp}", "env=dummy"])
    for exp in ("ppo_anakin", "sac_anakin", "dreamer_v3_anakin"):  # both lanes
        for lane in ("True", "False"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                run([f"exp={exp}", f"algo.fused_rollout={lane}"])


@pytest.mark.parametrize("version", ["dv3", "dv2", "dv1"])
def test_p2e_registers_both_phases_and_finetuning_defaults_to_cuda(tmp_path, version):
    """Both P2E phases train and evaluate through the registries, and only
    the finetuning ones continue an exploration run; a finetuning run reads its exploration run's config and then, without a
    card, raises before it trains."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.registry import algorithm_registry, evaluation_registry, register_all

    register_all()
    for phase in ("exploration", "finetuning"):
        name = f"p2e_{version}_{phase}"
        assert algorithm_registry[name].module == f"sheeprl_tpu_torch.algos.p2e_{version}.{name}"
        assert evaluation_registry[name].module == f"sheeprl_tpu_torch.algos.p2e_{version}.evaluate"
        assert algorithm_registry[name].after_exploration == (phase == "finetuning")
    assert {n for n, e in algorithm_registry.items() if e.after_exploration} == {"p2e_dv3_finetuning", "p2e_dv2_finetuning", "p2e_dv1_finetuning"}
    run_dir = tmp_path / "exploration" / "version_0"
    (run_dir / "checkpoint").mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps(compose([f"exp=p2e_{version}_exploration", "env=dummy"])))
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([f"exp=p2e_{version}_finetuning", "env=dummy", f"checkpoint.exploration_ckpt_path={ckpt}", f"log_root={tmp_path}"])


def test_evaluation_defaults_to_cuda_and_raises_without_it(tmp_path):
    """The evaluation runs on CUDA whatever device the trained run used,
    unless the command line asks for another; it raises before it writes."""
    from sheeprl_tpu_torch.cli import evaluation

    run_dir = tmp_path / "run" / "version_0"
    (run_dir / "checkpoint").mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps({"device": "cpu", "env": {"num_envs": 4}, "checkpoint": {"resume_from": None}}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluation([f"checkpoint_path={run_dir / 'checkpoint' / 'ckpt_8_0.ckpt'}"])
    assert sorted(os.listdir(run_dir)) == ["checkpoint", "config.json"]
    with pytest.raises(ValueError, match="checkpoint_path"):
        evaluation(["device=cpu"])


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
