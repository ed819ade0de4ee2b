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
"""

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


def jax_run(a):
    """ys, mhs and the four gradients of sum(ys * dys) through the JAX
    kernel pair (interpret mode)."""
    from ggml_experiments_tpu.ops.fused_gru_train import _fwd

    args = [jnp.asarray(a[k]) for k in ("mxs", "h0", "wr", "brec")]
    args[0] = args[0].astype(jnp.bfloat16)
    dys = jnp.asarray(a["dys"]).astype(jnp.bfloat16)
    ys, res = _fwd(*args, jnp.bfloat16, None)
    grads = jax.grad(lambda *p: jnp.sum(jax_scan(*p).astype(jnp.float32)
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


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)


@pytest.mark.parametrize("t,b", SHAPES)
def test_states_match_jax_kernel(t, b):
    a = make_inputs(t, b)
    jys, jmhs, _ = jax_run(a)
    ops = (torch.tensor(a["mxs"]).bfloat16(), torch.tensor(a["h0"]).bfloat16(),
           torch.tensor(a["wr"]).bfloat16(), torch.tensor(a["brec"]))
    ys, mhs = ft.gru_train_fwd_plain(*ops)
    assert ys.dtype == mhs.dtype == torch.bfloat16
    assert ys.shape == (t, b, U) and mhs.shape == (t, b, 3 * U)
    np.testing.assert_allclose(ys.float().numpy(), jys, atol=STATE_ATOL, rtol=0)
    np.testing.assert_allclose(mhs.float().numpy(), jmhs, atol=STATE_ATOL, rtol=0)
    # and through the differentiable wrapper, which counts a plain-version run
    before = dict(ft.PLAIN_CALLS)
    ys2, _ = torch_run(a)
    np.testing.assert_array_equal(ys2, ys.float().numpy())
    assert ft.PLAIN_CALLS["fused_gru_train_fwd"] == before["fused_gru_train_fwd"] + 1
    assert ft.PLAIN_CALLS["fused_gru_train_bwd"] == before["fused_gru_train_bwd"] + 1


@pytest.mark.parametrize("name,i", [("dmxs", 0), ("dh0", 1), ("dwr", 2), ("dbrec", 3)])
@pytest.mark.parametrize("t,b", SHAPES)
def test_gradients_match_jax_custom_vjp(t, b, name, i):
    a = make_inputs(t, b)
    _, _, jgrads = jax_run(a)
    _, tgrads = torch_run(a)
    assert tgrads[i].shape == jgrads[i].shape
    assert rel_err(tgrads[i], jgrads[i]) < VJP_REL, name


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


def test_gradient_dtypes_follow_the_inputs():
    a = make_inputs(3, 2)
    mxs = torch.tensor(a["mxs"]).bfloat16().requires_grad_()
    h0 = torch.tensor(a["h0"]).bfloat16().requires_grad_()
    wr = torch.tensor(a["wr"], requires_grad=True)
    brec = torch.tensor(a["brec"], requires_grad=True)
    ys = ft.fused_gru_scan(mxs, h0, wr, brec)
    assert ys.dtype == torch.bfloat16
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
