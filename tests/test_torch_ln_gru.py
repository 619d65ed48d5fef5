"""The port's LN-GRU step against the JAX package's: ``ln_gru_plain`` (what
``ln_gru_forward`` runs for CPU tensors) against ``_plain_ln_gru`` and the
Pallas kernel in interpret mode, on the cases of
tests/test_models/test_pallas_gru.py, and the port's ``LayerNormGRUCell``
against the flax cell on its fused path. Inputs are made with numpy from a
seed and given to both sides.

The kernels' plans (which kernel takes a shape, which CTA owns which gate
indices and columns) are pure functions, tested here; their ownership maps
are applied in plain torch (W's strips gathered per CTA, split partials and
row statistics combined in the kernels' fixed orders) and held to
``ln_gru_plain`` and the interpret-mode Pallas kernel.

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
from sheeprl_tpu_torch.models.ln_gru import (
    SMEM_LIMIT,
    TENSOR_CORE_MIN_BATCH,
    forward_plan,
    ln_gru_forward,
    ln_gru_forward_streaming,
    ln_gru_forward_tensor_core,
    ln_gru_plain,
    split_plan,
    streaming_plan,
    tensor_core_plan,
)
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
    assert ksplit <= ln_gru._MAX_SPLIT


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


# Shapes for the plan tests: DV3-S at the imagination's and the dynamic scan's
# batch, a ragged batch, the smallest gate chunk, XS-wide H.
TC_SHAPES = [(1024, 1024, 512), (64, 1024, 512), (100, 200, 128), (1, 8, 64), (1024, 1024, 256)]


@pytest.mark.parametrize("batch,depth,hidden", TC_SHAPES)
def test_tensor_core_plan_owns_every_gate_and_column_once(batch, depth, hidden):
    plan = tensor_core_plan(batch, depth, hidden)
    assert plan.kernel == "tensor_core" and plan.cluster == plan.grid[0] <= 8 and plan.grid[2] == 1
    owner = {}
    for x in range(plan.grid[0]):
        cols = plan.columns(x, hidden)
        assert len(cols) == 3 * plan.gates
        for s in range(3):  # the CTA holds reset, candidate and update columns of the same gates
            gates = [c - s * hidden for c in cols[s * plan.gates : (s + 1) * plan.gates]]
            assert gates == cols[: plan.gates]
        for c in cols:
            assert c not in owner
            owner[c] = x
    assert sorted(owner) == list(range(3 * hidden))  # the cluster's columns tile 3H
    for g in range(hidden):
        assert owner[g] == owner[hidden + g] == owner[2 * hidden + g]
    rows = [r for y in range(plan.grid[1]) for r in plan.rows(y, batch)]
    assert rows == list(range(batch))
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize(
    "batch,depth,hidden,dtype,aligned,kernel",
    [
        (1024, 1024, 512, torch.bfloat16, True, "tensor_core"),  # DV3-S imagination
        (TENSOR_CORE_MIN_BATCH, 1024, 512, torch.bfloat16, True, "tensor_core"),
        (TENSOR_CORE_MIN_BATCH - 1, 1024, 512, torch.bfloat16, True, "streaming"),
        (16, 1024, 512, torch.bfloat16, True, "streaming"),  # DV3-S dynamic scan
        (8, 1024, 512, torch.bfloat16, True, "streaming"),  # serving bucket
        (1024, 1024, 512, torch.float32, True, "streaming"),  # f32 would need TF32 on the tensor cores
        (16, 1024, 512, torch.float32, True, "streaming"),
        (1024, 1024, 512, torch.bfloat16, False, "streaming"),  # inputs not on 16-byte boundaries
        (3, 200, 100, torch.bfloat16, True, "streaming"),  # unaligned H
        (1024, 200, 100, torch.bfloat16, True, "streaming"),
        (1024, 5120, 4096, torch.bfloat16, True, "streaming"),  # XL: H / 64 exceeds a cluster
        (8, 5120, 4096, torch.bfloat16, True, "streaming"),
    ],
)
def test_forward_plan_routes_each_shape_to_one_kernel(batch, depth, hidden, dtype, aligned, kernel):
    plan = forward_plan(batch, depth, hidden, dtype, 132, aligned)
    assert plan.kernel == kernel
    assert plan.smem_bytes <= SMEM_LIMIT
    assert forward_plan(batch, depth, hidden, dtype, 132, aligned) == plan  # pure: same shape, same plan


@pytest.mark.parametrize("batch,depth,hidden,elem", [(16, 1024, 512, 2), (1024, 1024, 512, 4), (3, 200, 100, 2), (8, 5120, 4096, 2)])
def test_streaming_plan_tiles_columns_rows_and_depth(batch, depth, hidden, elem):
    plan = streaming_plan(batch, depth, hidden, elem, 132)
    nx, ksplit, tiles = plan.grid
    cols = [c for x in range(nx) for c in plan.columns(x, hidden)]
    assert cols == list(range(3 * hidden))
    assert [r for t in range(tiles) for r in plan.rows(t, batch)] == list(range(batch))
    assert (ksplit, plan.depth_per_split) == split_plan(batch, depth, 3 * hidden, elem, 132)
    assert plan.scratch_floats == 2 * batch * nx
    assert plan.tickets == batch and plan.cluster == ksplit <= 16
    assert plan.smem_bytes <= SMEM_LIMIT


def _gates(zn, h):
    hidden = h.shape[-1]
    r = torch.sigmoid(zn[:, :hidden])
    c = torch.tanh(r * zn[:, hidden : 2 * hidden])
    u = torch.sigmoid(zn[:, 2 * hidden :] - 1)
    return u * c + (1 - u) * h


def _emulate_tensor_core(plan, inp, w, b, scale, ln_bias, h):
    """The tensor-core kernel's ownership in plain torch: per CTA, W's three
    strips gathered and multiplied; row sums and squared deviations from
    per-CTA partials added in rank order; the gates of each CTA's own gate
    indices from its own columns."""
    batch, hidden = h.shape
    width = 3 * hidden
    z = torch.zeros(batch, width)
    h_out = torch.zeros(batch, hidden)
    for y in range(plan.grid[1]):
        rows = list(plan.rows(y, batch))
        ctas = []
        for x in range(plan.grid[0]):
            cols = plan.columns(x, hidden)
            ctas.append((cols, inp[rows] @ w[:, cols] + b[cols]))
        total = torch.zeros(len(rows))
        for _, zc in ctas:
            total = total + zc.sum(1)
        mean = (total / width)[:, None]
        total = torch.zeros(len(rows))
        for _, zc in ctas:
            total = total + ((zc - mean) ** 2).sum(1)
        rstd = torch.rsqrt(total / width + 1e-5)[:, None]
        for cols, zc in ctas:
            z[rows[0] : rows[-1] + 1, cols] = zc
            gates = cols[: plan.gates]
            zn = (zc - mean) * rstd * scale[cols] + ln_bias[cols]
            h_out[rows[0] : rows[-1] + 1, gates[0] : gates[-1] + 1] = _gates(zn, h[rows][:, gates])
    return h_out, z


def _emulate_streaming(plan, inp, w, b, scale, ln_bias, h):
    """The streaming kernel's order in plain torch: per (column block, batch
    tile), the split partials added in split order, then + b; per column
    block, each row's sum and squared deviation about its own mean; the row
    statistics combined over the column blocks in order
    (M2 = sum M2_c + n_c (mean_c - mean)^2); then the gates."""
    batch, depth = inp.shape
    hidden = h.shape[1]
    width = 3 * hidden
    nx, ksplit, tiles = plan.grid
    z = torch.zeros(batch, width)
    h_out = torch.zeros(batch, hidden)
    for t in range(tiles):
        rows = list(plan.rows(t, batch))
        r0, r1 = rows[0], rows[-1] + 1
        stats = []
        for x in range(nx):
            cols = plan.columns(x, hidden)
            acc = torch.zeros(len(rows), len(cols))
            for s in range(ksplit):
                d0, d1 = s * plan.depth_per_split, min((s + 1) * plan.depth_per_split, depth)
                acc = acc + inp[r0:r1, d0:d1] @ w[d0:d1, cols[0] : cols[-1] + 1]
            zc = acc + b[cols[0] : cols[-1] + 1]
            z[r0:r1, cols[0] : cols[-1] + 1] = zc
            total = zc.sum(1)
            stats.append((len(cols), total, ((zc - (total / len(cols))[:, None]) ** 2).sum(1)))
        total = torch.zeros(len(rows))
        for _, s_c, _ in stats:
            total = total + s_c
        mean = total / width
        m2 = torch.zeros(len(rows))
        for n_c, s_c, m2_c in stats:
            m2 = m2 + m2_c + n_c * (s_c / n_c - mean) ** 2
        zn = (z[r0:r1] - mean[:, None]) * torch.rsqrt(m2 / width + 1e-5)[:, None] * scale + ln_bias
        h_out[r0:r1] = _gates(zn, h[r0:r1])
    return h_out, z


@pytest.mark.parametrize("kernel", ["tensor_core", "streaming"])
@pytest.mark.parametrize("batch,d,hidden,atol", CASES)
def test_plan_ownership_in_plain_torch_matches_plain_and_interpret_kernel(kernel, batch, d, hidden, atol):
    args = _case(5, batch, d, hidden)
    ts = _port(args)
    if kernel == "tensor_core":
        h_emu, z_emu = _emulate_tensor_core(tensor_core_plan(batch, d, hidden), *ts)
    else:
        h_emu, z_emu = _emulate_streaming(streaming_plan(batch, d, hidden, 4, 132), *ts)
    h_ref, z_ref = ln_gru_plain(*ts)
    np.testing.assert_allclose(z_emu.numpy(), z_ref.numpy(), atol=atol, rtol=atol if atol > 1e-5 else 0)
    np.testing.assert_allclose(h_emu.numpy(), h_ref.numpy(), atol=atol, rtol=atol if atol > 1e-5 else 0)
    h_jax, z_jax = _pallas_ln_gru(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(z_emu.numpy(), np.asarray(z_jax), atol=atol, rtol=atol if atol > 1e-5 else 0)
    np.testing.assert_allclose(h_emu.numpy(), np.asarray(h_jax), atol=atol, rtol=atol if atol > 1e-5 else 0)


@pytest.mark.parametrize("launcher", [ln_gru_forward_streaming, ln_gru_forward_tensor_core])
def test_kernel_launchers_on_cpu_run_the_plain_version_and_count_no_launch(launcher):
    args = _port(_case(6, 4, 64, 64))
    before = launcher.launches
    h_new, z = launcher(*args)
    h_ref, z_ref = ln_gru_plain(*args)
    assert torch.equal(h_new, h_ref) and torch.equal(z, z_ref)
    assert launcher.launches == before


@pytest.mark.parametrize("batch,depth,hidden", [(8, 100, 64), (8, 64, 100), (8, 64, 576)])
def test_tensor_core_plan_refuses_shapes_outside_its_tiles(batch, depth, hidden):
    with pytest.raises(ValueError):
        tensor_core_plan(batch, depth, hidden)
