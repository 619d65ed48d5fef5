"""The LN-GRU step's gradient, port against JAX package.

``LNGRUFunction`` (what ``LayerNormGRUCell`` runs; on the CPU its forward and
backward are ``ln_gru_plain`` and ``ln_gru_backward_plain``) against
``jax.grad`` of ``fused_ln_gru`` (whose custom VJP is the TPU kernel's
``_bwd``), on the cases of tests/test_models/test_pallas_gru.py:49-61: loss
``(out ** 2).sum()``, gradients of all six arguments. Inputs are made with
numpy from a seed and given to both sides.

Tolerances: atol 1e-5 on every gradient in f32 (the same f32 math, summed
in another order); ``ln_gru_backward_plain`` against torch autograd through
``ln_gru_plain`` and against ``jax.vjp`` of ``_gates_from_z`` within 1e-5; in
bf16, gradients within 2e-2 relative of the f32 gradients of the same
(bf16-valued) inputs, the rounding of bf16 outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models.models import LayerNormGRUCell as FlaxCell
from sheeprl_tpu.models.pallas_gru import _gates_from_z, fused_ln_gru
from sheeprl_tpu_torch.models.ln_gru import (
    LNGRUFunction,
    backward_plan,
    ln_gru_backward,
    ln_gru_backward_plain,
    ln_gru_forward,
    ln_gru_plain,
)
from sheeprl_tpu_torch.models.models import LayerNormGRUCell

# (batch, d, hidden): the pallas test's gradient case first, then aligned, unaligned, wide.
CASES = [(8, 256, 128), (16, 384, 128), (5, 200, 128), (3, 40, 16), (8, 512, 512)]


def _case(seed, batch, d, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(batch, d), f(d, 3 * hidden) * 0.1, f(3 * hidden) * 0.1, 1.0 + 0.1 * f(3 * hidden), 0.1 * f(3 * hidden), f(batch, hidden))


def _torch_grads(args, dtype=torch.float32):
    ts = [torch.from_numpy(a) for a in args]
    ts = [t.to(dtype) if i in (0, 1, 5) else t for i, t in enumerate(ts)]
    ts = [t.requires_grad_() for t in ts]
    (LNGRUFunction.apply(*ts).float() ** 2).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("batch,d,hidden", CASES)
def test_function_gradients_match_jax_grad_of_fused_ln_gru(batch, d, hidden):
    args = _case(3, batch, d, hidden)
    want = jax.grad(lambda *a: (fused_ln_gru(*a) ** 2).sum(), argnums=(0, 1, 2, 3, 4, 5))(*map(jnp.asarray, args))
    got = _torch_grads(args)
    for name, g, w in zip(("inp", "w", "b", "scale", "ln_bias", "h"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("batch,d,hidden", CASES)
def test_backward_plain_matches_autograd_and_the_jax_tail_vjp(batch, d, hidden):
    inp, w, b, scale, ln_bias, h = (torch.from_numpy(a) for a in _case(4, batch, d, hidden))
    _, z = ln_gru_plain(inp, w, b, scale, ln_bias, h)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((batch, hidden)).astype(np.float32))
    dz, dscale, dln_bias, dh = ln_gru_backward_plain(g, z, scale, ln_bias, h)
    # torch autograd of the same tail: inp = z through an identity projection (exact in f32)
    zt, st, lt, ht = (t.clone().requires_grad_() for t in (z, scale, ln_bias, h))
    out, _ = ln_gru_plain(zt, torch.eye(3 * hidden), torch.zeros(3 * hidden), st, lt, ht)
    auto = torch.autograd.grad(out, (zt, st, lt, ht), g)
    _, vjp = jax.vjp(_gates_from_z, *(jnp.asarray(t.numpy()) for t in (z, scale, ln_bias, h)))
    ref = vjp(jnp.asarray(g.numpy()))
    for name, got, a, r in zip(("dz", "dscale", "dln_bias", "dh_tail"), (dz, dscale, dln_bias, dh), auto, ref):
        np.testing.assert_allclose(got.numpy(), a.numpy(), atol=1e-5, err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-5, err_msg=f"{name} vs jax.vjp")


@pytest.mark.parametrize("batch,d,hidden", CASES[:3])
def test_function_bf16_gradients_keep_dtypes_and_track_f32(batch, d, hidden):
    """bf16 inp, W and h: gradients come back in the inputs' dtypes (f32 for
    b, scale, ln_bias) and within bf16 rounding of the f32 gradients of the
    same values."""
    args = _case(6, batch, d, hidden)
    bf = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() if i in (0, 1, 5) else a for i, a in enumerate(args)]
    got = _torch_grads(bf, torch.bfloat16)
    want = _torch_grads(bf)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.bfloat16 if i in (0, 1, 5) else torch.float32)
        scale = w.abs().max().item()
        assert (g.float() - w).abs().max().item() <= 2e-2 * scale, i


def test_needless_gradients_are_none_and_the_cpu_launches_nothing():
    inp, w, b, scale, ln_bias, h = (torch.from_numpy(a) for a in _case(7, 4, 24, 8))
    w.requires_grad_()
    before = (ln_gru_forward.launches, ln_gru_backward.launches)
    out = LNGRUFunction.apply(inp, w, b, scale, ln_bias, h)
    (gw,) = torch.autograd.grad(out.sum(), (w,))
    assert gw.shape == w.shape and inp.grad is None and b.grad is None
    assert (ln_gru_forward.launches, ln_gru_backward.launches) == before


@pytest.mark.parametrize("hidden,in_dim,bias", [(128, 96, True), (16, 8, False)])
def test_cell_gradients_match_the_flax_cell(hidden, in_dim, bias):
    """The port's cell against jax.grad through the flax LayerNormGRUCell
    (unfused path, which differentiates the same math): weight, bias,
    LayerNorm and both inputs, atol 1e-5."""
    rng = np.random.default_rng(8)
    h = rng.standard_normal((4, hidden)).astype(np.float32)
    x = rng.standard_normal((4, in_dim)).astype(np.float32)
    flax_cell = FlaxCell(hidden_size=hidden, bias=bias, fused=False)
    p = jax.tree_util.tree_map(np.asarray, flax_cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)))["params"]
    p["norm"]["LayerNorm_0"]["scale"] = 1 + 0.1 * rng.standard_normal(3 * hidden).astype(np.float32)
    p["norm"]["LayerNorm_0"]["bias"] = 0.1 * rng.standard_normal(3 * hidden).astype(np.float32)
    if bias:
        p["linear"]["bias"] = 0.1 * rng.standard_normal(3 * hidden).astype(np.float32)

    def loss(params, h, x):
        return (flax_cell.apply({"params": params}, h, x) ** 2).sum()

    gp, gh, gx = jax.grad(loss, argnums=(0, 1, 2))(p, jnp.asarray(h), jnp.asarray(x))
    cell = LayerNormGRUCell(in_dim, hidden, bias=bias)
    state = {"weight": p["linear"]["kernel"], "norm.weight": p["norm"]["LayerNorm_0"]["scale"], "norm.bias": p["norm"]["LayerNorm_0"]["bias"]}
    if bias:
        state["bias"] = p["linear"]["bias"]
    cell.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    ht, xt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(x).requires_grad_()
    (cell(ht, xt) ** 2).sum().backward()
    pairs = [(cell.weight.grad, gp["linear"]["kernel"]), (cell.norm.weight.grad, gp["norm"]["LayerNorm_0"]["scale"]),
             (cell.norm.bias.grad, gp["norm"]["LayerNorm_0"]["bias"]), (ht.grad, gh), (xt.grad, gx)]  # fmt: skip
    if bias:
        pairs.append((cell.bias.grad, gp["linear"]["bias"]))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: (a[0][:, :-1].contiguous(), *a[1:]), ValueError),  # g narrower than h
        (lambda a: (a[0], a[1][:, :-1].contiguous(), *a[2:]), ValueError),  # z not 3H wide
        (lambda a: (a[0], a[1].to(torch.float64), *a[2:]), TypeError),  # z must be f32
        (lambda a: (a[0].to(torch.bfloat16), *a[1:]), TypeError),  # g and h must share a dtype
        (lambda a: (*a[:2], a[2].to(torch.bfloat16), *a[3:]), TypeError),  # scale must be f32
        (lambda a: (a[0].t().contiguous().t(), *a[1:]), ValueError),  # non-contiguous g
    ],
)
def test_backward_checks_its_inputs(mutate, error):
    inp, w, b, scale, ln_bias, h = (torch.from_numpy(a) for a in _case(9, 4, 24, 8))
    _, z = ln_gru_plain(inp, w, b, scale, ln_bias, h)
    g = torch.ones_like(h)
    with pytest.raises(error):
        ln_gru_backward(*mutate((g, z, scale, ln_bias, h)))


@pytest.mark.parametrize("batch,sms,rows", [(16, 132, 1), (1024, 132, 8), (1, 132, 1), (133, 132, 2)])
def test_backward_rows_give_about_one_block_per_sm(batch, sms, rows):
    plan = backward_plan(batch, 512, sms)
    assert plan.rows == rows
    assert -(-batch // rows) <= sms


@pytest.mark.parametrize("batch,hidden,sms", [(16, 512, 132), (1024, 512, 132), (3, 100, 132), (8, 4096, 132), (300, 16, 4), (4, 5000, 132)])
def test_backward_plan_covers_rows_and_gates(batch, hidden, sms):
    plan = backward_plan(batch, hidden, sms)
    assert plan.blocks * plan.rows >= batch > (plan.blocks - plan.cluster) * plan.rows  # only the last cluster has idle blocks
    assert plan.blocks == plan.cluster * plan.clusters and 1 <= plan.cluster <= 16
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.threads >= hidden or plan.threads == 256  # gate indices per thread: one, or a few kept in registers
    assert plan.tickets == plan.cluster  # one per column slice
    assert plan.scratch_floats == (plan.blocks + plan.clusters) * 2 * 3 * hidden


def test_backward_plan_puts_the_dynamic_scan_in_one_cluster():
    plan = backward_plan(16, 512, 132)
    assert (plan.rows, plan.blocks, plan.cluster, plan.clusters) == (1, 16, 16, 1)


@pytest.mark.parametrize("batch,hidden,sms", [(16, 128, 132), (40, 16, 4), (5, 128, 132), (700, 16, 4)])
def test_backward_plan_sum_order_matches_the_plain_backward(batch, hidden, sms):
    """dscale and dln_bias as the kernel adds them: each block's rows in
    order, the blocks of a cluster in order, then the clusters in order;
    held to ln_gru_backward_plain over the whole batch (atol 1e-5)."""
    inp, w, b, scale, ln_bias, h = (torch.from_numpy(a) for a in _case(10, batch, 24, hidden))
    _, z = ln_gru_plain(inp, w, b, scale, ln_bias, h)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((batch, hidden)).astype(np.float32))
    plan = backward_plan(batch, hidden, sms)
    per_row = [ln_gru_backward_plain(g[r : r + 1], z[r : r + 1], scale, ln_bias, h[r : r + 1]) for r in range(batch)]
    blocks = []
    for k in range(plan.blocks):
        acc = torch.zeros(2, 3 * hidden)
        for r in range(k * plan.rows, min((k + 1) * plan.rows, batch)):
            acc = acc + torch.stack([per_row[r][1], per_row[r][2]])
        blocks.append(acc)
    total = torch.zeros(2, 3 * hidden)
    for cl in range(plan.clusters):
        part = torch.zeros(2, 3 * hidden)
        for acc in blocks[cl * plan.cluster : (cl + 1) * plan.cluster]:
            part = part + acc
        total = total + part
    _, dscale, dln_bias, _ = ln_gru_backward_plain(g, z, scale, ln_bias, h)
    np.testing.assert_allclose(total[0].numpy(), dscale.numpy(), atol=1e-5)
    np.testing.assert_allclose(total[1].numpy(), dln_bias.numpy(), atol=1e-5)
