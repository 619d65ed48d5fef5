"""The port's LN-GRU step against the JAX package's: ``ln_gru_plain`` (what
``ln_gru_forward`` runs for CPU tensors) against ``_plain_ln_gru`` and the
Pallas kernel in interpret mode, on the cases of
tests/test_models/test_pallas_gru.py, and the port's ``LayerNormGRUCell``
against the flax cell on its fused path. Inputs are made with numpy from a
seed and given to both sides.

Tolerances: atol 1e-5 on h' and z for one D tile, 1e-4 (with rtol 1e-4)
where the TPU kernel sums over several D tiles, since the sum order differs.
bf16 is held against the interpret-mode kernel, which sums in f32 as the
port does (``_plain_ln_gru`` would round z to bf16 first): z at 1e-4 and h'
within one bf16 ulp (the rounding of the final cast)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models.models import LayerNormGRUCell as FlaxCell
from sheeprl_tpu.models.pallas_gru import _pallas_ln_gru, _plain_ln_gru
from sheeprl_tpu_torch.models import ln_gru
from sheeprl_tpu_torch.models.ln_gru import ln_gru_forward, ln_gru_plain, split_plan
from sheeprl_tpu_torch.models.models import LayerNormGRUCell

# (batch, d, hidden, atol): aligned; unaligned B and D; several D tiles; wide H
CASES = [(16, 384, 128, 1e-5), (5, 200, 128, 1e-5), (8, 1024, 128, 1e-4), (8, 512, 512, 1e-4)]


def bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _, e = np.frexp(np.maximum(x, 2.0**-126))
    return np.ldexp(1.0, e - 8)


def _case(seed, batch, d, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(batch, d), f(d, 3 * hidden) * 0.1, f(3 * hidden) * 0.1, 1.0 + 0.1 * f(3 * hidden), 0.1 * f(3 * hidden), f(batch, hidden))


def _port(args, dtype=torch.float32):
    inp, w, b, scale, ln_bias, h = (torch.from_numpy(a) for a in args)
    return inp.to(dtype), w.to(dtype), b, scale, ln_bias, h.to(dtype)


@pytest.mark.parametrize("batch,d,hidden,atol", CASES)
def test_plain_matches_jax_plain_and_interpret_kernel(batch, d, hidden, atol):
    args = _case(0, batch, d, hidden)
    h_port, z_port = ln_gru_plain(*_port(args))
    for h_ref, z_ref in (_plain_ln_gru(*map(jnp.asarray, args)), _pallas_ln_gru(*map(jnp.asarray, args), interpret=True)):
        np.testing.assert_allclose(h_port.numpy(), np.asarray(h_ref), atol=atol, rtol=atol if atol > 1e-5 else 0)
        np.testing.assert_allclose(z_port.numpy(), np.asarray(z_ref), atol=atol, rtol=atol if atol > 1e-5 else 0)


@pytest.mark.parametrize("batch,d,hidden,atol", CASES)
def test_plain_bf16_matches_interpret_kernel(batch, d, hidden, atol):
    args = _case(1, batch, d, hidden)
    inp, w, b, scale, ln_bias, h = _port(args, torch.bfloat16)
    h_port, z_port = ln_gru_plain(inp, w, b, scale, ln_bias, h)
    assert h_port.dtype == torch.bfloat16 and z_port.dtype == torch.float32
    # the same bf16 values on both sides
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (inp, w)]
    jargs = [*jargs, jnp.asarray(args[2]), jnp.asarray(args[3]), jnp.asarray(args[4]), jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)]
    h_ref, z_ref = _pallas_ln_gru(*jargs, interpret=True)
    np.testing.assert_allclose(z_port.numpy(), np.asarray(z_ref), atol=1e-4, rtol=1e-4)
    ref = np.asarray(h_ref.astype(jnp.float32))
    got = h_port.float().numpy()
    assert np.all(np.abs(got - ref) <= bf16_ulp(np.maximum(np.abs(got), np.abs(ref))))


def test_forward_on_cpu_runs_the_plain_version_and_counts_no_launch():
    args = _port(_case(2, 3, 40, 16))
    before = ln_gru_forward.launches
    h_new, z = ln_gru_forward(*args)
    h_ref, z_ref = ln_gru_plain(*args)
    assert torch.equal(h_new, h_ref) and torch.equal(z, z_ref)
    assert ln_gru_forward.launches == before


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: (a[0], a[1].t(), *a[2:]), ValueError),  # W transposed: wrong shape
        (lambda a: (a[0], a[1].to(torch.float64), *a[2:]), TypeError),
        (lambda a: (*a[:2], a[2].to(torch.bfloat16), *a[3:]), TypeError),  # b must be f32
        (lambda a: (a[0][:, ::2], *a[1:]), ValueError),  # wrong D
        (lambda a: (*a[:5], a[5][:1]), ValueError),  # h batch differs
        (lambda a: (a[0].t().contiguous().t(), *a[1:]), ValueError),  # non-contiguous inp
    ],
)
def test_forward_checks_its_inputs(mutate, error):
    args = _port(_case(3, 4, 24, 8))
    with pytest.raises(error):
        ln_gru_forward(*mutate(args))


@pytest.mark.parametrize(
    "batch,depth,width,elem,sms",
    [(1, 1024, 1536, 2, 132), (8, 1024, 1536, 4, 132), (64, 1024, 1536, 2, 132), (8, 5120, 12288, 2, 132), (3, 200, 300, 2, 132), (1, 1, 3, 4, 132), (5, 33, 99, 4, 4)],
)
def test_split_plan_covers_depth_with_no_empty_split(batch, depth, width, elem, sms):
    ksplit, per = split_plan(batch, depth, width, elem, sms)
    assert per % ln_gru._GROUP_D == 0
    assert ksplit * per >= depth and (ksplit - 1) * per < depth
    vec = 16 // elem if width % (16 // elem) == 0 else 1
    blocks = -(-width // (32 * vec)) * -(-batch // ln_gru._TILE_B)
    assert ksplit == 1 or blocks * (ksplit - 1) < ln_gru._BLOCKS_PER_SM * sms


@pytest.mark.parametrize("hidden,in_dim", [(128, 96), (16, 8)])
def test_cell_matches_flax_fused_cell(monkeypatch, hidden, in_dim):
    """Same weights through the bridge layout: the flax kernel [D, 3H] is the
    port's weight as it is. atol 1e-5 (one f32 product of width D)."""
    import jax

    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", "1")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((4, hidden)).astype(np.float32)
    x = rng.standard_normal((4, in_dim)).astype(np.float32)
    flax_cell = FlaxCell(hidden_size=hidden, bias=True)
    params = flax_cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    p["linear"]["bias"] = rng.standard_normal(3 * hidden).astype(np.float32) * 0.1
    p["norm"]["LayerNorm_0"]["scale"] = 1 + 0.1 * rng.standard_normal(3 * hidden).astype(np.float32)
    ref = np.asarray(flax_cell.apply({"params": p}, jnp.asarray(h), jnp.asarray(x)))

    cell = LayerNormGRUCell(in_dim, hidden, bias=True)
    cell.load_state_dict(
        {
            "weight": torch.from_numpy(p["linear"]["kernel"]),
            "bias": torch.from_numpy(p["linear"]["bias"]),
            "norm.weight": torch.from_numpy(p["norm"]["LayerNorm_0"]["scale"]),
            "norm.bias": torch.from_numpy(p["norm"]["LayerNorm_0"]["bias"]),
        }
    )
    with torch.no_grad():
        out = cell(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
