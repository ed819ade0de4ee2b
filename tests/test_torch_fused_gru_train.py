"""Port: the fused GRU training scan (ops/fused_gru_train) against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernel pair in interpret mode, as its own tests
do; the port runs the plain versions of its CUDA kernels. Both get the same
numpy inputs. Tolerances:

* states ``ys`` / ``mhs``: both sides round the same f32 values to bf16, but
  sum the recurrent product in different orders and use different sigmoid /
  tanh routines, so a value may land on the neighbouring bf16 number (one
  step is 2**-8 relative, 4e-3 at |h| <= 1, 1.6e-2 at |mh| <= 4) and such a
  flip feeds the following steps: 2e-2 absolute, as the JAX tests hold the
  kernel to its scan.
* gradients against the JAX custom VJP: the same flips, through the same
  formulas: 2e-2 of the largest entry.
* gradients against autograd of an f32 plain loop: 3e-2 of the largest entry,
  the JAX tests' bound for bf16 compute against an f32 oracle.
* the hand-derived backward against autograd of the same forward in f64,
  where nothing is rounded: 1e-9 relative, so that a wrong formula cannot
  hide behind bf16 noise.
* at ``compute_dtype=float32`` nothing is rounded to bf16 on either side,
  so only the f32 sums' orders and the sigmoid / tanh routines differ:
  states within 1e-6 absolute of the JAX kernel's and gradients within 2e-6
  of their largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.ops.fused_gru_train import fused_gru_scan as jax_scan
from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
from ggml_experiments_tpu_torch.ops.gru import gru_combine

E, U = 8, 16
SHAPES = [(6, 4), (12, 2), (5, 6)]      # (T, B)
STATE_ATOL = 2e-2
VJP_REL = 2e-2
ORACLE_REL = 3e-2
# at f32 (see the module docstring)
F32_STATE_ATOL = 1e-6
F32_VJP_REL = 2e-6
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, STATE_ATOL, VJP_REL),
          "f32": (torch.float32, jnp.float32, F32_STATE_ATOL, F32_VJP_REL)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_inputs(t, b, u=U, seed=7, h0_scale=0.2):
    """mxs (as the bf16 input projection gives it), h0, wr, brec, and a
    cotangent dys, all float32 numpy holding what both sides are handed."""
    rng = np.random.default_rng(seed + 100 * t + b)
    kernel = rng.standard_normal((E, 3 * u)) * 0.3
    xs = rng.standard_normal((t, b, E))
    b_in = rng.standard_normal(3 * u) * 0.3
    mxs = np.asarray(jnp.asarray(xs @ kernel + b_in, jnp.bfloat16).astype(jnp.float32))
    return dict(
        mxs=mxs.astype(np.float32),
        h0=(rng.standard_normal((b, u)) * h0_scale).astype(np.float32),
        wr=(rng.standard_normal((u, 3 * u)) * 0.3).astype(np.float32),
        brec=(rng.standard_normal(3 * u) * 0.3).astype(np.float32),
        dys=rng.standard_normal((t, b, u)).astype(np.float32),
    )


def jax_run(a, cd=jnp.bfloat16):
    """ys, mhs and the four gradients of sum(ys * dys) through the JAX
    kernel pair at compute dtype ``cd`` (interpret mode)."""
    from ggml_experiments_tpu.ops.fused_gru_train import _fwd

    args = [jnp.asarray(a[k]) for k in ("mxs", "h0", "wr", "brec")]
    args[0] = args[0].astype(cd)
    dys = jnp.asarray(a["dys"]).astype(cd)
    ys, res = _fwd(*args, cd, None)
    grads = jax.grad(lambda *p: jnp.sum(jax_scan(*p, cd).astype(jnp.float32)
                                        * dys.astype(jnp.float32)), argnums=(0, 1, 2, 3))(*args)
    return (np.asarray(ys.astype(jnp.float32)), np.asarray(res[1].astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def torch_run(a, scan=ft.fused_gru_scan, cd=torch.bfloat16):
    dt = torch.float64 if cd == torch.float64 else torch.float32
    args = [torch.tensor(a[k], dtype=dt, requires_grad=True) for k in ("mxs", "h0", "wr", "brec")]
    mxs = args[0].to(cd) if cd == torch.bfloat16 else args[0]
    dys = torch.tensor(a["dys"], dtype=dt).to(cd)
    ys = scan(mxs, *args[1:])
    (ys.to(dt) * dys.to(dt)).sum().backward()
    return ys.detach().float().numpy(), [x.grad.double().numpy() for x in args]


def port_scan(cd):
    """The port's fused_gru_scan at compute dtype ``cd``."""
    return functools.partial(ft.fused_gru_scan, compute_dtype=cd)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("t,b", SHAPES)
def test_states_match_jax_kernel(t, b, dtype):
    cd, jcd, atol, _ = DTYPES[dtype]
    a = make_inputs(t, b)
    jys, jmhs, _ = jax_run(a, jcd)
    ops = (torch.tensor(a["mxs"]).to(cd), torch.tensor(a["h0"]).to(cd),
           torch.tensor(a["wr"]).to(cd), torch.tensor(a["brec"]))
    ys, mhs = ft.gru_train_fwd_plain(*ops)
    assert ys.dtype == mhs.dtype == cd
    assert ys.shape == (t, b, U) and mhs.shape == (t, b, 3 * U)
    np.testing.assert_allclose(ys.float().numpy(), jys, atol=atol, rtol=0)
    np.testing.assert_allclose(mhs.float().numpy(), jmhs, atol=atol, rtol=0)
    # and through the differentiable wrapper, which counts a plain-version run
    before = dict(ft.PLAIN_CALLS)
    ys2, _ = torch_run(a, scan=port_scan(cd), cd=cd)
    np.testing.assert_array_equal(ys2, ys.float().numpy())
    assert ft.PLAIN_CALLS["fused_gru_train_fwd"] == before["fused_gru_train_fwd"] + 1
    assert ft.PLAIN_CALLS["fused_gru_train_bwd"] == before["fused_gru_train_bwd"] + 1


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name,i", [("dmxs", 0), ("dh0", 1), ("dwr", 2), ("dbrec", 3)])
@pytest.mark.parametrize("t,b", SHAPES)
def test_gradients_match_jax_custom_vjp(t, b, name, i, dtype):
    cd, jcd, _, rel = DTYPES[dtype]
    a = make_inputs(t, b)
    _, _, jgrads = jax_run(a, jcd)
    _, tgrads = torch_run(a, scan=port_scan(cd), cd=cd)
    assert tgrads[i].shape == jgrads[i].shape
    assert rel_err(tgrads[i], jgrads[i]) < rel, name


@pytest.mark.parametrize("cd", [torch.float16, torch.float64])
def test_scan_refuses_other_compute_dtypes(cd):
    """The kernels take bf16 and f32; the plain versions' f64 is for checks
    (``fused_gru_scan_plain``), not a compute dtype of the scan."""
    a = make_inputs(3, 2)
    args = [torch.tensor(a[k]) for k in ("mxs", "h0", "wr", "brec")]
    with pytest.raises(ValueError, match="compute_dtype must be torch.bfloat16 or torch.float32"):
        ft.fused_gru_scan(*args, compute_dtype=cd)


def f32_loop(mxs, h0, wr, brec):
    """The plain time loop in f32, for autograd."""
    h, ys = h0, []
    for t in range(mxs.shape[0]):
        h = gru_combine(mxs[t], torch.matmul(h, wr) + brec, h)
        ys.append(h)
    return torch.stack(ys)


@pytest.mark.parametrize("t,b", SHAPES)
def test_gradients_match_f32_autograd_oracle(t, b):
    a = make_inputs(t, b)
    ys, got = torch_run(a)
    oys, want = torch_run(a, scan=f32_loop, cd=torch.float32)
    np.testing.assert_allclose(ys, oys, atol=STATE_ATOL, rtol=0)
    for g, w, name in zip(got, want, ("dmxs", "dh0", "dwr", "dbrec")):
        assert rel_err(g, w) < ORACLE_REL, name


@pytest.mark.parametrize("t,b", SHAPES)
def test_hand_derived_backward_equals_autograd_in_f64(t, b):
    """No rounding anywhere: the formulas themselves."""
    a = make_inputs(t, b)

    def plain64(mxs, h0, wr, brec):
        return ft.fused_gru_scan_plain(mxs, h0, wr, brec, compute_dtype=torch.float64)

    ys, got = torch_run(a, scan=plain64, cd=torch.float64)
    oys, want = torch_run(a, scan=f32_loop, cd=torch.float64)
    np.testing.assert_allclose(ys, oys, atol=1e-6, rtol=0)   # compared as f32
    for g, w, name in zip(got, want, ("dmxs", "dh0", "dwr", "dbrec")):
        assert rel_err(g, w) < 1e-9, name


def test_batch_tiling_contract():
    """Running the batch in tiles (carry restarted per tile, dwr and dbrec
    summed over tiles) gives the whole batch's result: no row depends on
    another, and the weight gradients are sums over rows."""
    a = make_inputs(5, 6, seed=5, h0_scale=0.0)
    _, whole = torch_run(a)
    parts = [torch_run({k: (v[:, i:i + 1] if k in ("mxs", "dys") else
                            v[i:i + 1] if k == "h0" else v) for k, v in a.items()})[1]
             for i in range(6)]
    # a product of one row sums in another order than a product of six, so
    # the f32 values differ in the last bits and a bf16 dmx may land one step off
    np.testing.assert_allclose(np.concatenate([p[0] for p in parts], axis=1), whole[0],
                               rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([p[1] for p in parts], axis=0), whole[1],
                               rtol=1e-4, atol=1e-5)
    for i in (2, 3):
        np.testing.assert_allclose(sum(p[i] for p in parts), whole[i], rtol=1e-4, atol=1e-5)
    # the JAX kernel pair under its own tiling holds the same weight gradient
    _, _, jgrads = jax_run(a)
    assert rel_err(whole[2], jgrads[2]) < VJP_REL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gradient_dtypes_follow_the_inputs(dtype):
    cd = DTYPES[dtype][0]
    a = make_inputs(3, 2)
    mxs = torch.tensor(a["mxs"]).bfloat16().requires_grad_()
    h0 = torch.tensor(a["h0"]).bfloat16().requires_grad_()
    wr = torch.tensor(a["wr"], requires_grad=True)
    brec = torch.tensor(a["brec"], requires_grad=True)
    ys = ft.fused_gru_scan(mxs, h0, wr, brec, compute_dtype=cd)
    assert ys.dtype == cd
    ys.float().square().mean().backward()
    assert mxs.grad.dtype == h0.grad.dtype == torch.bfloat16
    assert wr.grad.dtype == brec.grad.dtype == torch.float32 and brec.grad.shape == (3 * U,)


def test_empty_sequence_and_cuda_wrapper_checks():
    ys, mhs = ft.gru_train_fwd_plain(torch.zeros(0, 2, 3 * U).bfloat16(),
                                     torch.zeros(2, U).bfloat16(),
                                     torch.zeros(U, 3 * U).bfloat16(), torch.zeros(3 * U))
    assert ys.shape == (0, 2, U) and mhs.shape == (0, 2, 3 * U)
    # the kernel wrappers refuse what is not on a GPU instead of computing it
    with pytest.raises(ValueError, match="CUDA tensor"):
        ft.gru_train_fwd_cuda(torch.zeros(1, 2, 3 * U).bfloat16(), torch.zeros(2, U).bfloat16(),
                              torch.zeros(U, 3 * U).bfloat16(), torch.zeros(3 * U))
    with pytest.raises(ValueError, match="CUDA tensor"):
        z = torch.zeros(1, 2, 3 * U).bfloat16()
        y = torch.zeros(1, 2, U).bfloat16()
        ft.gru_train_bwd_cuda(z, z, y, y, torch.zeros(2, U).bfloat16(),
                              torch.zeros(U, 3 * U).bfloat16())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("u", [16, 96, 1024])
@pytest.mark.parametrize("b", [1, 31, 64, 1024, 1761, 3000, 16384])
def test_train_plans_cover_the_batch_and_fit(b, u, dtype):
    """Every plan's row tiles cover the batch with none empty and its blocks
    are co-resident (one a multiprocessor). bf16: ``ub`` divides U and both
    passes fit the H100's shared memory with a ring of at least two stages.
    f32: each recurrence's own cuts, whose ``units`` divide U, with a ring
    of at least two stages."""
    cd = DTYPES[dtype][0]
    plans = ft.train_plans(b, u, dtype=cd)
    assert plans and ft.train_plan(b, u, dtype=cd) in plans
    if cd == torch.float32:
        for part, cuts, smem in (("fwd", ft.F32_FWD_CUTS, ft.f32_fwd_smem_bytes),
                                 ("bwd", ft.F32_BWD_CUTS, ft.f32_bwd_smem_bytes)):
            got = ft.train_plans(b, u, dtype=cd, part=part)
            assert got and ft.train_plan(b, u, dtype=cd, part=part) in got
            for plan in got:
                assert (plan.rows, plan.units) in cuts and u % plan.units == 0
                assert plan.row_tiles * (u // plan.units) <= ft.SMS
                rows = ft.f32_tile_rows(b, plan.row_tiles, plan.rows)
                assert rows % plan.rows == 0 and rows * plan.row_tiles >= b
                assert (plan.row_tiles - 1) * rows < b      # the last tile holds a row
                stages, need = smem(plan.rows, plan.units)
                assert 2 <= stages <= ft.F32_MAX_STAGES and need <= ft.SMEM_LIMIT
        return
    for plan in plans:
        assert plan.ub in ft.UNIT_GROUPS
        assert u % plan.ub == 0
        assert plan.row_tiles * (u // plan.ub) <= ft.SMS
        rows = ft.tile_rows(b, plan.row_tiles)
        assert rows % 64 == 0 and rows * plan.row_tiles >= b
        assert (plan.row_tiles - 1) * rows < b      # the last tile holds a row
        assert rows % ft.CHUNK_ROWS == 0 or (rows == 64 and b <= 64)
        for part in ("fwd", "bwd"):
            stages = ft.ring_stages(part, plan.ub, u)
            assert 2 <= stages <= ft.MAX_STAGES
            assert ft.smem_bytes(part, plan.ub, u, stages) <= ft.SMEM_LIMIT
            assert ft.smem_bytes(part, plan.ub, u, stages + 1) > ft.SMEM_LIMIT \
                or stages == ft.MAX_STAGES


def test_train_plan_at_the_training_width():
    """The Wr slice of 32 units takes 192 KB in both passes (two ring stages
    beside it); any width the kernels took before this plan (a multiple of 8
    up to 8 units a multiprocessor) still has a plan."""
    assert ft.wr_bytes("fwd", 32, 1024) == ft.wr_bytes("bwd", 32, 1024) == 196608
    assert ft.ring_stages("fwd", 32, 1024) == ft.ring_stages("bwd", 32, 1024) == 2
    assert ft.ring_stages("fwd", 16, 1024) == ft.MAX_STAGES
    assert [tuple(p) for p in ft.train_plans(1024, 1024)] == [
        (8, 1), (16, 1), (16, 2), (32, 1), (32, 2), (32, 3), (32, 4)]
    assert ft.train_plans(64, 1024) == [(8, 1), (16, 1), (32, 1)]
    # the defaults the sweep on an H100 chose: the most blocks, then the fewest rows a block
    assert [tuple(ft.train_plan(b, 1024)) for b in (1, 64, 256, 1024, 2048, 3000, 4096)] == [
        (8, 1), (8, 1), (16, 2), (32, 4), (32, 4), (32, 4), (32, 4)]
    assert all(ft.kernels_take(u) for u in range(8, 8 * ft.SMS + 1, 8))
    assert not any(ft.kernels_take(u) for u in (4, 100, 8 * ft.SMS + 8))
    with pytest.raises(ValueError, match=r"\(64, 100\)"):
        ft.train_plan(64, 100)


def test_f32_train_plans_at_the_training_width():
    """Neither f32 recurrence keeps a Wr slice (the forward's of 16 units
    took 199680 bytes, so 32 did not fit at U = 1024): each streams a Wr
    operand split once a call, so its shared memory does not depend on U,
    and each has cuts (rows, units, R) of its own. The forward's default:
    the most blocks, then a cut whose warpgroups each own their rows, then
    the widest unit group, then the fewest bytes a block streams a step:
    128 rows x 64 units at B = 1024, 128 x 32 at B = 512, 64 x 8 at B = 64.
    The backward's: the most blocks, then the
    widest unit group, then the fewest bytes a block streams a step: 64
    rows x 128 units at B = 1024, 64 x 8 at B = 64. Every width the bf16
    pair takes, the f32 pair takes."""
    f32 = torch.float32
    assert ft.f32_fwd_smem_bytes(128, 32) == (5, 1024 + 5 * ((128 + 3 * 32 * 2) * 128 + 16))
    assert ft.f32_fwd_smem_bytes(128, 32)[1] > 199680
    assert [tuple(p) for p in ft.train_plans(64, 1024, dtype=f32)] == [
        (128, 64, 1), (256, 32, 1), (128, 32, 1), (64, 64, 1), (64, 32, 1), (64, 16, 1),
        (64, 8, 1)]
    full = [tuple(p) for p in ft.train_plans(1024, 1024, dtype=f32)
            if p.row_tiles * (1024 // p.units) == ft.SMS - 4]
    assert full == [(128, 64, 8), (256, 32, 4), (128, 32, 4), (64, 64, 8), (64, 32, 4),
                    (64, 16, 2), (64, 8, 1)]
    assert [tuple(ft.train_plan(b, 1024, dtype=f32)) for b in (1, 64, 256, 512, 1024, 4096)] == [
        (64, 8, 1), (64, 8, 1), (64, 32, 4), (128, 32, 4), (128, 64, 8), (128, 64, 8)]
    assert [tuple(ft.train_plan(b, 1024, dtype=f32, part="bwd"))
            for b in (1, 64, 65, 512, 1024, 2048, 4096)] == [
        (64, 8, 1), (64, 8, 1), (64, 16, 2), (64, 64, 8), (64, 128, 16), (64, 128, 16),
        (64, 128, 16)]
    # U = 96 on the cuts whose unit groups divide it, one row tile of B = 64
    assert [tuple(p) for p in ft.train_plans(64, 96, dtype=f32)] == [
        (256, 32, 1), (128, 32, 1), (64, 32, 1), (64, 16, 1), (64, 8, 1)]
    assert [tuple(p) for p in ft.train_plans(64, 96, dtype=f32, part="bwd")] == [
        (256, 32, 1), (64, 32, 1), (64, 16, 1), (64, 8, 1)]
    assert all(ft.kernels_take(u, dtype=f32) for u in range(8, 8 * ft.SMS + 1, 8))
    assert not any(ft.kernels_take(u, dtype=f32) for u in (4, 100, 8 * ft.SMS + 8))


# (rows, units) -> (ring stages, bytes) of an f32 forward block, reckoned from
# the kernel's layout: 1024 bytes of alignment slack; a stage of the chunk's h
# rows and the block's 3 units rows of Wr^T hi and lo, 128 bytes each, and its
# full / empty barriers (16 bytes); at 64 rows the second warpgroup's sums
# (128 threads x 3 units / 2 floats); as many stages as fit 232448 bytes
F32_FWD_SMEM = {(128, 64): (3, 1024 + 3 * (512 * 128 + 16)),
                (256, 32): (4, 1024 + 4 * (448 * 128 + 16)),
                (128, 32): (5, 1024 + 5 * (320 * 128 + 16)),
                (64, 64): (3, 1024 + 3 * (448 * 128 + 16) + 128 * 96 * 4),
                (64, 32): (6, 1024 + 6 * (256 * 128 + 16) + 128 * 48 * 4),
                (64, 16): (10, 1024 + 10 * (160 * 128 + 16) + 128 * 24 * 4),
                (64, 8): (15, 1024 + 15 * (112 * 128 + 16) + 128 * 12 * 4)}


@pytest.mark.parametrize("u", [1024, 96, 104, 200])
def test_f32_forward_smem_follows_the_kernel_layout(u):
    """Each forward cut's ring and bytes as the kernel lays them out,
    whatever U: h and Wr^T stream through the ring, so no width changes a
    block's memory. Each fits an H100 block with a ring of at least three
    stages."""
    assert set(F32_FWD_SMEM) == set(ft.F32_FWD_CUTS)
    plans = ft.train_plans(1024, u, dtype=torch.float32)
    assert plans
    for plan in plans:
        stages, need = ft.f32_fwd_smem_bytes(plan.rows, plan.units)
        assert (stages, need) == F32_FWD_SMEM[(plan.rows, plan.units)]
        assert 3 <= stages and need <= ft.SMEM_LIMIT


@pytest.mark.parametrize("u", [16, 24, 96])
def test_f32_forward_weight_is_wr_transposed_split_in_tf32_in_gate_order(u):
    """The f32 forward's B operand: hi and lo exact in tf32 (the low 13
    mantissa bits zero), hi + lo = Wr^T within 2^-22 relative, row 24 J + 8
    gate + c holding column gate * U + 8 J + c of Wr (the three gates of
    each 8 units together, the order a lane's accumulators take), K = U
    contiguous, zeros from U to KP (a whole 32-wide stage)."""
    w = torch.tensor(np.random.default_rng(u).normal(0, 1, (u, 3 * u)), dtype=torch.float32)
    op = ft.f32_fwd_weight(w)
    kp = ft.f32_fwd_kp(u)
    assert kp % 32 == 0 and kp - 32 < u <= kp
    assert op.shape == (2, 3 * u, kp) and op.dtype == torch.float32
    hi, lo = op[0], op[1]
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
        assert not part[:, u:].any()
    order = [gate * u + 8 * j + c for j in range(u // 8) for gate in range(3) for c in range(8)]
    want = w.t()[order]
    back = (hi + lo)[:, :u]
    assert float(((back.double() - want.double()).abs() / want.double().abs()).max()) <= 2.0 ** -22
    assert float((hi[:, :u] - want).abs().max()) <= 2.0 ** -10 * float(w.abs().max())


@pytest.mark.parametrize("plan", [(96, 64, 1), (256, 64, 1), (64, 128, 1), (64, 8, 2),
                                  (128, 64, 3)])
def test_f32_forward_plans_refuse_what_the_kernel_does_not_take(plan):
    """At (B, U) = (64, 1024): a cut that is not one of the forward's (96
    rows; 256 rows of 64 units and the backward's 64 x 128, whose f32
    totals would take 192 registers a thread), an empty row tile: none is
    offered, so a forced ``config`` is refused."""
    assert ft.FwdPlan(*plan) not in ft.train_plans(64, 1024, dtype=torch.float32)


# (rows, units) -> (ring stages, bytes) of an f32 backward block, reckoned from
# the kernel's layout: 1024 bytes of alignment slack; a stage of the chunk's
# dmh rows and the block's Wr hi and lo rows, 128 bytes each, and its full /
# empty barriers (16 bytes); at 64 rows the second warpgroup's sums (128
# threads x units / 2 floats); as many stages as fit 232448 bytes, at most 16
F32_BWD_SMEM = {(128, 64): (7, 1024 + 7 * (256 * 128 + 16)),
                (256, 32): (5, 1024 + 5 * (320 * 128 + 16)),
                (64, 128): (4, 1024 + 4 * (320 * 128 + 16) + 128 * 64 * 4),
                (64, 64): (8, 1024 + 8 * (192 * 128 + 16) + 128 * 32 * 4),
                (64, 32): (13, 1024 + 13 * (128 * 128 + 16) + 128 * 16 * 4),
                (64, 16): (16, 1024 + 16 * (96 * 128 + 16) + 128 * 8 * 4),
                (64, 8): (16, 1024 + 16 * (80 * 128 + 16) + 128 * 4 * 4)}


@pytest.mark.parametrize("u", [1024, 96, 104, 200])
def test_f32_backward_smem_follows_the_kernel_layout(u):
    """Each cut's ring and bytes as the kernel lays them out, whatever U:
    Wr streams through the ring, so no width changes a block's memory. Each
    fits an H100 block and leaves room for the db_rec sums (256 threads x 24
    floats) in the ring after the loop."""
    assert set(F32_BWD_SMEM) == set(ft.F32_BWD_CUTS)
    for plan in ft.train_plans(1024, u, dtype=torch.float32, part="bwd"):
        stages, need = ft.f32_bwd_smem_bytes(plan.rows, plan.units)
        assert (stages, need) == F32_BWD_SMEM[(plan.rows, plan.units)]
        assert need <= ft.SMEM_LIMIT
        assert stages * (plan.rows + 2 * plan.units) * 128 >= ft.F32_THREADS * 24 * 4


@pytest.mark.parametrize("u", [16, 24, 96])
def test_f32_backward_weight_is_wr_split_in_tf32_in_k_order(u):
    """The f32 backward's B operand: hi and lo exact in tf32 (the low 13
    mantissa bits zero), hi + lo = Wr within 2^-22 relative, each row in the
    carry product's K order (dmx's 2U columns, zeros to KA, the plane's U
    columns, zeros to KP)."""
    w = torch.tensor(np.random.default_rng(u).normal(0, 1, (u, 3 * u)), dtype=torch.float32)
    op = ft.f32_bwd_weight(w)
    ka, kp = ft.f32_bwd_ka(u), ft.f32_bwd_kp(u)
    assert ka % 32 == 0 and ka - 32 < 2 * u <= ka and kp % 32 == 0 and kp - 32 < ka + u <= kp
    assert op.shape == (2, u, kp) and op.dtype == torch.float32
    hi, lo = op[0], op[1]
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    back = torch.cat([(hi + lo)[:, :2 * u], (hi + lo)[:, ka:ka + u]], dim=1)
    assert float(((back.double() - w.double()).abs() / w.double().abs()).max()) <= 2.0 ** -22
    assert float((hi[:, :2 * u] - w[:, :2 * u]).abs().max()) <= 2.0 ** -10 * float(w.abs().max())
    for part in (hi, lo):
        assert not part[:, 2 * u:ka].any() and not part[:, ka + u:].any()


@pytest.mark.parametrize("t,b,parts", [(100, 1024, 11), (100, 64, 11), (5, 6, 5), (3, 1000, 7),
                                       (1, 1, 1), (7, 65, 16)])
def test_dwr_partitions_hold_every_row_once_in_order(t, b, parts):
    """A model of the f32 dWr GEMM's K walk: stage st holds rows 32 (st %
    nb).. of step st // nb (nb = ceil(B / 32)); partition p takes stages
    [p NS / P, (p + 1) NS / P). Every (t, b) row falls in exactly one
    partition, and the partitions follow each other in (t, b) order."""
    nb = -(-b // ft.DWR_STAGE_ROWS)
    ns = ft.dwr_stages(t, b)
    assert ns == t * nb
    seen = []
    for start, stop in ((ns * p // parts, ns * (p + 1) // parts) for p in range(parts)):
        rows = [(st // nb, r) for st in range(start, stop)
                for r in range(ft.DWR_STAGE_ROWS * (st % nb),
                               min(b, ft.DWR_STAGE_ROWS * (st % nb + 1)))]
        seen.append(rows)
    flat = [x for rows in seen for x in rows]
    assert flat == [(i, j) for i in range(t) for j in range(b)]
    assert len(seen) == parts and all(seen) == (parts <= ft.dwr_stages(t, b))


def test_dwr_partitions_fill_whole_waves():
    """192 tiles of dWr at U = 1024 on 132 multiprocessors: 11 partitions
    make 2112 blocks, 16 full waves; the count never passes the stages or
    DWR_MAX_PARTS, and one stage takes one partition."""
    assert ft.dwr_tiles(1024) == 8 * 24 == 192
    assert ft.dwr_tiles(96) == 3 and ft.dwr_tiles(200) == 2 * 6
    assert ft.dwr_partitions(100, 1024, 1024) == ft.dwr_partitions(100, 64, 1024) == 11
    assert ft.dwr_partitions(1, 1, 1024) == 1 and ft.dwr_partitions(2, 40, 96) == 4
    for t, b, u in ((5, 6, 96), (100, 512, 1024), (3, 3000, 200)):
        assert 1 <= ft.dwr_partitions(t, b, u) <= min(ft.DWR_MAX_PARTS, ft.dwr_stages(t, b))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("entry", ["fwd", "bwd_rec", "dwr"])
def test_the_cuda_wrappers_refuse_a_dtype_before_the_device(entry, dtype):
    """A dtype neither kernel form takes is refused, named, before the
    wrapper looks at the device: the CPU sees the same refusal the card
    would."""
    z3, z = torch.zeros(1, 2, 3 * U, dtype=dtype), torch.zeros(2, U, dtype=dtype)
    y, w = torch.zeros(1, 2, U, dtype=dtype), torch.zeros(U, 3 * U, dtype=dtype)
    call = {"fwd": lambda: ft.gru_train_fwd_cuda(z3, z, w, torch.zeros(3 * U)),
            "bwd_rec": lambda: ft.gru_train_bwd_rec_cuda(z3, z3, y, y, z, w),
            "dwr": lambda: ft.gru_train_dwr_cuda(z, y, z3, y)}[entry]
    with pytest.raises(ValueError, match=f"bfloat16 or float32 operands, got {dtype}"):
        call()


@pytest.mark.parametrize("plan", [(96, 64, 1), (128, 32, 1), (64, 8, 2), (64, 12, 1),
                                  (128, 64, 9)])
def test_f32_backward_plans_refuse_what_the_kernel_does_not_take(plan):
    """At (B, U) = (64, 1024): a cut that is not one of the kernel's, an
    empty row tile, a unit group that does not divide U, more blocks than
    multiprocessors: none is offered, so a forced ``config`` is refused."""
    assert ft.BwdPlan(*plan) not in ft.train_plans(64, 1024, dtype=torch.float32, part="bwd")


@pytest.mark.parametrize("plan", [(32, 2), (64, 1), (12, 1)])
def test_train_plans_refuse_what_the_kernels_do_not_take(plan):
    """An empty row tile at B=64, a unit group past 32, one that does not
    divide U: none is offered, so a forced ``config`` of it is refused."""
    assert ft.TrainPlan(*plan) not in ft.train_plans(64, 1024)


@pytest.mark.parametrize("cd", [torch.float64, torch.float32, torch.bfloat16])
def test_recurrence_and_dwr_plain_equal_the_plain_backward(cd):
    """The backward's two kernels, plain: the time loop (dmx, the plane of
    round(da * r), dbrec, dh0) and the dWr GEMM from the stored operands
    give the plain backward's bits."""
    t, b = 5, 6
    a = make_inputs(t, b, seed=3)
    mxs, h0, wr = (torch.tensor(a[k]).to(cd) for k in ("mxs", "h0", "wr"))
    brec = torch.tensor(a["brec"]).to(ft._acc_dtype(cd))
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    dys = torch.tensor(a["dys"]).to(cd)
    whole = ft.gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr)
    dmxs, plane, dbrec, dh0 = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    assert plane.dtype == cd and plane.shape == (t, b, U)
    # dmh's z and r columns are dmx's; its third column is the plane
    dwr = ft.gru_train_dwr_plain(h0, ys, dmxs, plane)
    for name, got, want in zip(("dmxs", "dwr", "dbrec", "dh0"), (dmxs, dwr, dbrec, dh0), whole):
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("t,b", SHAPES)
def test_dwr_plain_equals_jax_custom_vjp(t, b):
    """dWr from the stored [dmx[..., :2U] | plane] and [h0; ys] against the
    JAX kernel pair's custom VJP on the same inputs."""
    a = make_inputs(t, b)
    _, _, jgrads = jax_run(a)
    mxs, h0, wr = (torch.tensor(a[k]).bfloat16() for k in ("mxs", "h0", "wr"))
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, torch.tensor(a["brec"]))
    dys = torch.tensor(a["dys"]).bfloat16()
    dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    dwr = ft.gru_train_dwr_plain(h0, ys, dmxs, plane)
    assert dwr.dtype == torch.float32 and dwr.shape == (U, 3 * U)
    assert rel_err(dwr.double().numpy(), jgrads[2]) < VJP_REL


@pytest.mark.parametrize("row_tiles", [1, 2, 3])
@pytest.mark.parametrize("cd", [torch.float64, torch.float32, torch.bfloat16])
def test_dbrec_over_row_tiles_in_order_equals_one_sum(cd, row_tiles):
    """The backward sums db_rec per row tile, then over the tiles in order:
    rows are independent recurrences, so each tile's time loop on its own
    rows gives that tile's share, and the ordered sum equals the one sum over
    the batch within f32 rounding (f64 rounding at float64)."""
    t, b = 4, 70
    a = make_inputs(t, b, seed=11)
    mxs, h0, wr = (torch.tensor(a[k]).to(cd) for k in ("mxs", "h0", "wr"))
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, torch.tensor(a["brec"]).to(ft._acc_dtype(cd)))
    dys = torch.tensor(a["dys"]).to(cd)
    whole = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    rows = -(-b // row_tiles)
    total = None
    for s in range(0, b, rows):
        part = ft.gru_train_bwd_rec_plain(*(x[:, s:s + rows] for x in (mxs, mhs, ys, dys)),
                                          h0[s:s + rows], wr)
        total = part[2] if total is None else total + part[2]
    tol = 1e-12 if cd == torch.float64 else 1e-5
    np.testing.assert_allclose(total.double().numpy(), whole[2].double().numpy(), rtol=tol,
                               atol=tol * float(whole[2].abs().max()))


def test_the_f32_kernel_symbols_are_their_launch_counters():
    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.utils.trace_report import kernel_name

    anon = "(anonymous namespace)::"
    symbols = {
        f"void {anon}gru_train_fwd_f32_kernel<128, 64>({anon}FwdArgs)": "fused_gru_train_fwd_f32",
        f"void {anon}gru_train_bwd_f32_kernel<128, 64>({anon}BwdArgs)": "fused_gru_train_bwd_f32",
        f"void {anon}gru_train_dwr_f32_kernel({anon}DwrArgs)": "fused_gru_train_dwr_f32",
        f"{anon}gru_train_dwr_f32_reduce(const float4*, float4*, int, int)":
            "fused_gru_train_dwr_f32",
        f"void {anon}gru_train_fwd_kernel<32>({anon}FwdArgs)": "fused_gru_train_fwd"}
    for sym, name in symbols.items():
        assert kernel_name(sym) == name, sym
    assert set(symbols.values()) <= set(port.kernel_launches())


def test_the_f32_cuda_wrappers_refuse_cpu_tensors_and_other_dtypes():
    """On CPU tensors the f32 wrappers raise instead of computing; a dtype
    neither kernel takes is named."""
    z3, z = torch.zeros(1, 2, 3 * U), torch.zeros(2, U)
    y = torch.zeros(1, 2, U)
    w = torch.zeros(U, 3 * U)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ft.gru_train_fwd_cuda(z3, z, w, torch.zeros(3 * U))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ft.gru_train_bwd_cuda(z3, z3, y, y, z, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ft.gru_train_dwr_cuda(z, y, z3, y)
    with pytest.raises(ValueError, match="bfloat16 or float32 operands, got torch.float16"):
        ft.gru_train_fwd_cuda(z3.half(), z.half(), w.half(), torch.zeros(3 * U))
