"""The port's optimizers against the JAX package's optax transformations
(``sheeprl_tpu/optim/__init__.py``, ``sheeprl_tpu/optim/rmsprop_tf.py``),
with the same hyperparameter names, on the CPU.

Each case runs 5 steps from the same random parameters with the same random
gradients (numpy, from a seed) given to both, and holds the parameters and
the optimizer state after every step within rtol 1e-5 (+ atol 1e-7, f32
arithmetic in another order; ``rsqrt`` against ``1 / sqrt``). Where a case
changes the learning rate after the second step, the JAX side runs under
``optax.inject_hyperparams``, as the A2C and recurrent PPO trainers anneal
it: RMSprop's momentum trace follows the learning rate in optax's
``rmsprop`` and precedes it in ``rmsprop_tf``.

``torch.optim.RMSprop`` puts eps outside the root: at A2C's eps = 1e-4 and
gradients of 1e-3, its first step is about 50 times the JAX one (ROADMAP
C-r7). A case guards that trap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu import optim as jax_optim
from sheeprl_tpu.optim.rmsprop_tf import RmspropTFState
from sheeprl_tpu_torch import optim as port_optim

SHAPES = {"w": (5, 3), "b": (3,)}
# name: (factory, kwargs, learning rate from step 3 on or None)
CASES = {
    "rmsprop": ("rmsprop", {"lr": 1e-3, "eps": 1e-4}, None),
    "rmsprop-centered": ("rmsprop", {"lr": 1e-3, "alpha": 0.9, "eps": 1e-5, "centered": True}, None),
    "rmsprop-momentum": ("rmsprop", {"lr": 1e-3, "eps": 1e-5, "momentum": 0.9}, 4e-4),
    "rmsprop-centered-momentum": ("rmsprop", {"lr": 1e-3, "eps": 1e-5, "momentum": 0.5, "centered": True}, 4e-4),
    "rmsprop-weight-decay": ("rmsprop", {"lr": 1e-3, "eps": 1e-4, "weight_decay": 0.1}, 5e-4),
    "rmsprop_tf": ("rmsprop_tf", {"lr": 1e-3, "eps": 1e-5}, None),
    "rmsprop_tf-centered-momentum": ("rmsprop_tf", {"lr": 1e-3, "eps": 1e-5, "momentum": 0.9, "centered": True, "weight_decay": 0.01}, 4e-4),
    "adamw": ("adamw", {"lr": 3e-4, "eps": 1e-4, "weight_decay": 0}, None),
    "adamw-decay": ("adamw", {"lr": 3e-4, "eps": 1e-8, "weight_decay": 0.05, "betas": [0.8, 0.99]}, 1e-4),
    "sgd": ("sgd", {"lr": 1e-2}, None),
    "sgd-momentum": ("sgd", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.01}, 5e-3),
    "sgd-nesterov": ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "dampening": 0}, None),
}  # fmt: skip
RTOL, ATOL = 1e-5, 1e-7


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL, err_msg=what)


def _states(tree, cls):
    return [s for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(s, cls)]


def _jax_state(name, kwargs, opt_state):
    """The JAX optimizer's state, in the port's names: {state key: {leaf: array}}."""
    out = {}
    if name.startswith("rmsprop_tf"):
        [s] = _states(opt_state, RmspropTFState)
        out["square_avg"] = s.ms
        if kwargs.get("centered"):
            out["grad_avg"] = s.mg
        if kwargs.get("momentum"):
            out["momentum_buffer"] = s.mom
    elif name.startswith("rmsprop"):
        if kwargs.get("centered"):
            [s] = _states(opt_state, optax.ScaleByRStdDevState)
            out["square_avg"], out["grad_avg"] = s.nu, s.mu
        else:
            [s] = _states(opt_state, optax.ScaleByRmsState)
            out["square_avg"] = s.nu
        if kwargs.get("momentum"):
            out["momentum_buffer"] = _states(opt_state, optax.TraceState)[0].trace
    elif name.startswith("adamw"):
        [s] = _states(opt_state, optax.ScaleByAdamState)
        out["exp_avg"], out["exp_avg_sq"] = s.mu, s.nu
    elif kwargs.get("momentum"):
        out["momentum_buffer"] = _states(opt_state, optax.TraceState)[0].trace
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_the_jax_packages(case):
    name, kwargs, later_lr = CASES[case]
    rng = np.random.default_rng(0)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 0, size=s)).astype(np.float32) for k, s in SHAPES.items()} for _ in range(5)]

    jax_kwargs = {k: v for k, v in kwargs.items() if k != "lr"}
    tx = optax.inject_hyperparams(lambda lr: getattr(jax_optim, name)(lr=lr, **jax_kwargs))(lr=kwargs["lr"])
    params = {k: jnp.asarray(v) for k, v in start.items()}
    opt_state = tx.init(params)

    port_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    opt = getattr(port_optim, name)(port_params.values(), **kwargs)
    if name.startswith("adamw"):
        assert isinstance(opt, torch.optim.AdamW)
    for step, g in enumerate(grads):
        if later_lr is not None and step == 2:
            opt_state.hyperparams["lr"] = jnp.asarray(later_lr, jnp.float32)
            for group in opt.param_groups:
                group["lr"] = later_lr
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in port_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in SHAPES:
            _close(port_params[k].detach().numpy(), params[k], f"step {step} param {k}")
        for key, tree in _jax_state(name, kwargs, opt_state).items():
            for k in SHAPES:
                _close(opt.state[port_params[k]][key].numpy(), tree[k], f"step {step} {key} {k}")
    assert all(not np.allclose(port_params[k].detach().numpy(), start[k]) for k in SHAPES)


def test_torch_rmsprop_misses_the_jax_update():
    """The trap: ``torch.optim.RMSprop`` at A2C's eps = 1e-4 moves a
    parameter whose gradient is 1e-3 about 50 times as far as the JAX
    ``rmsprop`` on the first step; the port's ``rmsprop`` moves it as far."""
    start, g = np.zeros(4, np.float32), np.full(4, 1e-3, np.float32)
    tx = jax_optim.rmsprop(lr=1e-3, eps=1e-4)
    updates, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(start)), jnp.asarray(start))
    want = np.asarray(updates)
    moved = {}
    for name, make in (("torch", lambda p: torch.optim.RMSprop(p, lr=1e-3, alpha=0.99, eps=1e-4)), ("port", lambda p: port_optim.rmsprop(p, lr=1e-3, eps=1e-4))):
        p = torch.nn.Parameter(torch.from_numpy(start.copy()))
        opt = make([p])
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        moved[name] = p.detach().numpy() - start
    _close(moved["port"], want, "port rmsprop")
    ratio = moved["torch"] / want
    assert np.all((ratio > 40) & (ratio < 60)), ratio


def test_build_optimizer_names_the_new_targets_and_state_loads_across_them():
    """``build_optimizer`` takes each target, and a saved state loads into a
    fresh optimizer of the same kind (``load_optimizer_state`` keeps the
    optimizer's own ``capturable``, which SGD and RMSprop have none of)."""
    for name in ("rmsprop", "rmsprop_tf", "adamw", "sgd"):
        lin = torch.nn.Linear(3, 2)
        opt = port_optim.build_optimizer(lin.parameters(), {"_target_": f"sheeprl_tpu_torch.optim.{name}", "lr": 0.1, "momentum": 0.5} if name.startswith(("sgd", "rmsprop"))
                                         else {"_target_": f"sheeprl_tpu_torch.optim.{name}", "lr": 0.1})  # fmt: skip
        lin(torch.ones(4, 3)).sum().backward()
        opt.step()
        fresh = port_optim.build_optimizer(lin.parameters(), {"_target_": f"sheeprl_tpu_torch.optim.{name}", "lr": 0.5})
        port_optim.load_optimizer_state(fresh, opt.state_dict())
        assert fresh.param_groups[0]["lr"] == 0.1
        for p in lin.parameters():
            assert opt.state[p].keys() == fresh.state[p].keys()
            assert all(torch.equal(opt.state[p][k], fresh.state[p][k]) for k in opt.state[p])
