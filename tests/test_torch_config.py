"""The port's config layer against the JAX package's: the YAML reader
against PyYAML with the JAX loader's resolver, the port's exps composed from
the port's own tree against the JAX composition, the composition's rules,
and ``instantiate``/``locate``."""

import glob
import math
import os
import sys

import pytest
import yaml
from test_torch_train import check_against_jax

import sheeprl_tpu
from sheeprl_tpu.config.loader import _YamlLoader
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu_torch.config import ConfigError, MandatoryValueError, compose, instantiate, locate, parse_value, reader
from sheeprl_tpu_torch.config.loader import default_config_dir

TREE = default_config_dir()
FILES = sorted(os.path.relpath(p, TREE) for p in glob.glob(os.path.join(TREE, "**", "*.yaml"), recursive=True))
EXPS = ("ppo", "ppo_atari", "dreamer_v3_100k_ms_pacman", "dreamer_v3_dmc_walker_walk", "sac", "droq", "dreamer_v2", "dreamer_v2_ms_pacman", "dreamer_v1", "a2c",
        "ppo_recurrent", "p2e_dv3_exploration", "p2e_dv3_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning", "p2e_dv1_exploration",
        "p2e_dv1_finetuning", "sac_ae", "ppo_anakin", "sac_anakin", "dreamer_v3_anakin", "ppo_decoupled", "sac_decoupled")
# The JAX package's own overrides for SAC and DroQ (tests/test_algos/test_fused_train.py),
# and the width each exp's interpolation spreads.
EXP_ARGS = {exp: ["env.id=continuous_dummy", "env.wrapper.id=continuous_dummy"] for exp in ("sac", "droq", "sac_ae", "sac_decoupled")}
WIDTH = {"sac": "algo.hidden_size", "droq": "algo.hidden_size", "sac_ae": "algo.hidden_size", "sac_anakin": "algo.hidden_size", "sac_decoupled": "algo.hidden_size"}
# The Anakin exps choose their own env group (jax_cartpole, jax_pendulum, jax_gridworld).
ANAKIN = {"ppo_anakin": "jax_cartpole", "sac_anakin": "jax_pendulum", "dreamer_v3_anakin": "jax_gridworld"}
# Values the tests and the recipes give on the command line, and YAML's edge cases.
VALUES = [
    "1e-4", "1.0e-6", "2.5e-4", "1e3", "-1e-3", "10_000_000", "0", "010", "0x1f", "0b101", "1:30", "-1", "+3", ".5", "1.",
    ".inf", "-.inf", "True", "False", "true", "yes", "off", "null", "Null", "~", "", "???", "'x'", '"y"', "'it''s'",
    '"a\\tb"', "[state]", "[]", "{}", "[rgb, state]", "[0.9, 0.999]", "[[1, 2], [3]]", "{a: 1, b: [x]}", "[a,b,]",
    "${algo.dense_units}", "${now:%Y-%m-%d_%H-%M-%S}", "/tmp/a/ckpt_8_0.ckpt", "continuous_dummy", "MsPacmanNoFrameskip-v4",
    "32-true", "a b c", "a#b", "x # c", "a:b", "http://x:80/y", "a: b", "- a",
]  # fmt: skip


def _same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("name", FILES)
def test_reader_reads_every_file_of_the_tree_as_pyyaml_does(name):
    text = open(os.path.join(TREE, name)).read()
    want = yaml.load(text, Loader=_YamlLoader)
    assert _same(reader.load(text, name), want)
    assert reader.package_header(text) == ("_global_" if name == "config.yaml" or name.startswith("exp/") else None)


def test_reader_reads_values_as_pyyaml_does():
    for text in VALUES:
        assert _same(reader.load(text), yaml.load(text, Loader=_YamlLoader)), text
        assert _same(parse_value(text), yaml.load(text, Loader=_YamlLoader)), text
    # Text PyYAML refuses stays text on the command line, as in the JAX loader.
    for text in ("a: b: c", "[a", "'open"):
        with pytest.raises(yaml.YAMLError):
            yaml.load(text, Loader=_YamlLoader)
        assert parse_value(text) == text


@pytest.mark.parametrize(
    "text,line,what",
    [
        ("a: 1\nb: &x 2\n", 2, "anchors"),
        ("a: 1\nb: *x\n", 2, "anchors and aliases"),
        ("a: !!str 1\n", 1, "tags"),
        ("a: |\n  text\n", 1, "block scalars"),
        ("---\na: 1\n", 1, "document markers"),
        ("a: [1,\n  2]\n", 1, "over several lines"),
        ("a: plain\n  more\n", 2, "over several lines"),
        ("d: 2024-01-02\n", 1, "timestamp"),
        ("<<: {a: 1}\n", 1, "merge"),
        ("? a\n: b\n", 1, "complex mapping keys"),
    ],
)  # fmt: skip
def test_reader_raises_outside_its_subset_with_file_and_line(text, line, what):
    with pytest.raises(reader.UnsupportedYaml, match=f"conf.yaml:{line}: .*{what}"):
        reader.load(text, "conf.yaml")


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("interpolated", [False, True], ids=["default", "interpolated"])
def test_exp_composes_to_the_jax_composition(exp, interpolated):
    """Key for key in both directions, up to the ``_target_`` map, the port's
    own keys and the run name's time; ``algo.dense_units`` (SAC's and DroQ's
    ``algo.hidden_size``) spreads to every width that interpolates it, and
    ``seed`` to the run name."""
    sheeprl_tpu.register_all()
    width = WIDTH.get(exp, "algo.dense_units")
    overrides = [f"{width}=24", "seed=7"] if interpolated else []
    args = [f"exp={exp}", *([] if exp in ANAKIN else ["env=dummy"]), *EXP_ARGS.get(exp, []), *overrides]
    port, ref = compose(args), jax_compose("config", args).as_dict()
    check_against_jax(port, ref)
    assert port.device == "cuda" and port.env_group == ANAKIN.get(exp, "dummy") and port.buffer.memmap_mode == "r+"
    if exp in ANAKIN:
        assert port.env.jax_native is True and port.algo.fused_rollout is True and port.env.id == ANAKIN[exp]
        assert port.env.wrapper._target_ == "sheeprl_tpu_torch.envs.anakin.AnakinToHost"
    else:
        assert port.env.wrapper.action_dim == {"dreamer_v3_100k_ms_pacman": 9, "dreamer_v3_dmc_walker_walk": 6, "dreamer_v2_ms_pacman": 9}.get(exp, 2)
    if exp in ("sac", "droq"):
        assert port.env.id == "continuous_dummy" and port.algo.name == exp and port.algo.critic.n == 2
        assert port.algo.replay_ratio == (20.0 if exp == "droq" else 1.0) and port.algo.critic.get("dropout") == (0.01 if exp == "droq" else None)
    if exp.endswith("_finetuning"):  # mandatory on the command line, as in the JAX composition
        assert port.checkpoint.exploration_ckpt_path == ref["checkpoint"]["exploration_ckpt_path"] == "???"
    if interpolated:
        wide = (port.algo.actor.hidden_size, port.algo.critic.hidden_size) if exp in WIDTH else (port.algo.actor.dense_units,)
        assert port.run_name.endswith("_7") and set(wide) == {24}


def test_composition_rules(tmp_path, monkeypatch):
    """``override``, ``@pkg`` targets, ``+key=``, the mandatory exp, an
    unknown key, the resolvers and the search path."""
    cfg_ppo = compose(["exp=ppo", "env=dummy"])
    assert cfg_ppo.algo.optimizer == {"_target_": "sheeprl_tpu_torch.optim.adam", "lr": 1e-3, "eps": 1e-4, "weight_decay": 0, "betas": [0.9, 0.999]}
    cfg = compose(["exp=ppo_atari", "env=dummy"])
    assert cfg.algo.optimizer == {"_target_": "sheeprl_tpu_torch.optim.adam", "lr": 2.5e-4, "eps": 1e-6, "weight_decay": 0, "betas": [0.9, 0.999]}
    assert (cfg.algo.name, cfg.env.id, cfg.env.screen_size, cfg.algo.total_steps) == ("ppo", "discrete_dummy", 84, 10_000_000)
    assert cfg.buffer.size == cfg.algo.rollout_steps == 1024 and cfg.metric.logger.run_name == cfg.run_name
    assert compose(["exp=ppo_atari"]).env_group == "atari"  # the exp's own "override /env: atari"
    assert compose(["exp=ppo", "env=dummy", "+algo.extra=[1, 2]"]).algo.extra == [1, 2]
    with pytest.raises(MandatoryValueError, match="You must specify 'exp'"):
        compose(["env=dummy"])
    with pytest.raises(ConfigError, match="no such key"):
        compose(["exp=ppo", "env=dummy", "algo.extra=1"])
    with pytest.raises(ConfigError, match="env=mujoco is not in the port's config tree"):
        compose(["exp=ppo", "env=mujoco"])
    (tmp_path / "exp").mkdir()
    (tmp_path / "optim").mkdir()
    (tmp_path / "optim" / "slow.yaml").write_text("_target_: sheeprl_tpu_torch.optim.adam\nbetas: [0.5, 0.9]\n")
    (tmp_path / "exp" / "mine.yaml").write_text(
        "# @package _global_\ndefaults:\n  - ppo\n  - override /optim@algo.optimizer: slow\n  - _self_\n"
        "log_root: ${oc.env:MY_LOGS,elsewhere}\nalgo:\n  total_steps: 128  # a comment\n"
    )  # fmt: skip
    monkeypatch.setenv("SHEEPRL_SEARCH_PATH", f"file://{tmp_path}")
    monkeypatch.setenv("MY_LOGS", "/tmp/my_logs")
    mine = compose(["exp=mine", "env=dummy"])
    assert mine.algo.total_steps == 128 and mine.log_root == "/tmp/my_logs" and mine.algo.mlp_keys.encoder == ["state"]
    # The override reaches algo/ppo.yaml's "/optim@optimizer" entry; the algo's own keys still win.
    assert mine.algo.optimizer == {"_target_": "sheeprl_tpu_torch.optim.adam", "betas": [0.5, 0.9], "lr": 1e-3, "eps": 1e-4}
    assert compose(["exp=mine", "env=dummy", "optim@algo.optimizer=adam"]).algo.optimizer == cfg_ppo.algo.optimizer
    monkeypatch.delenv("MY_LOGS")
    assert compose(["exp=mine", "env=dummy"]).log_root == "elsewhere"


def test_instantiate_and_locate(tmp_path, monkeypatch):
    import torch

    from sheeprl_tpu_torch.utils.metric import MeanMetric, MetricAggregator

    cfg = compose(["exp=ppo", "env=dummy"])
    aggregator = instantiate(cfg.metric.aggregator)
    assert isinstance(aggregator, MetricAggregator) and all(isinstance(m, MeanMetric) for m in aggregator.metrics.values())
    assert set(aggregator.metrics) == {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss"}
    param = torch.nn.Parameter(torch.zeros(3))
    opt = instantiate(cfg.algo.optimizer, [param])
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == 1e-3 and opt.defaults["eps"] == 1e-4
    partial = instantiate({"_target_": "sheeprl_tpu_torch.optim.adam", "_partial_": True, "lr": 0.5})
    assert partial([param]).defaults["lr"] == 0.5
    assert instantiate({"a": 1}) == {"a": 1}
    with pytest.raises(ValueError, match="non-_target_"):
        instantiate({"a": 1}, 2)
    assert locate("sheeprl_tpu_torch.utils.metric.MeanMetric") is MeanMetric and locate("os.path.join") is os.path.join
    with pytest.raises(ImportError, match="Cannot locate"):
        locate("sheeprl_tpu_torch.no_such_module.Thing")
    # An ImportError inside a module that exists is the user's to see.
    (tmp_path / "needs_extra.py").write_text("raise ImportError('install the extra')\n")
    (tmp_path / "missing_dep.py").write_text("import no_such_dependency_xyz\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ImportError, match="install the extra"):
        locate("needs_extra.Thing")
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_xyz"):
        locate("missing_dep.Thing")
    for mod in ("needs_extra", "missing_dep"):
        sys.modules.pop(mod, None)


@pytest.mark.parametrize("groups", [["health=on"], ["health=strict"], ["resilience=on"], ["health=on", "resilience=on"]], ids="+".join)
@pytest.mark.parametrize("exp", ["dreamer_v3_100k_ms_pacman", "sac", "ppo"])
def test_health_and_resilience_groups_compose_to_the_jax_composition(exp, groups):
    """The ``health`` and ``resilience`` options the port's tree copies
    (``on``, ``strict``; ``resilience/on``) compose key for key as the JAX
    package's, on top of an exp."""
    sheeprl_tpu.register_all()
    args = [f"exp={exp}", "env=dummy", *EXP_ARGS.get(exp, []), *groups]
    port, ref = compose(args), jax_compose("config", args).as_dict()
    check_against_jax(port, ref)
    assert port.health == ref["health"] and port.resilience == ref["resilience"]
    assert port.health.enabled is ("health=on" in groups or "health=strict" in groups)
    assert port.resilience.supervisor.enabled is port.resilience.watchdog.enabled is ("resilience=on" in groups)
