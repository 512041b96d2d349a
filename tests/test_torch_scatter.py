"""Port scatter-add (gradient_sdf_tpu_torch/ops/kernels/scatter_add.py)
against numpy and against the JAX package's Pallas kernels.

The Pallas kernels run as the JAX package's own tests run them on the CPU
(interpret mode), and their lane-packed output goes through `unpack_multi`.
On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is checked by the `gpu`-marked test (skipped without a card)
and by `chip_smoke.py`.

Tolerance: atol 1e-4 on sums of N(0,1) values, ~3-10 per destination —
float32 sums taken in another order (index_add_ vs the kernel's serial
loop vs numpy's add.at) differ by a few ulps of the partial sums.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.ops.pallas import scatter_add as jsa
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu_torch.ops.kernels import scatter_add as tsa

ATOL = 1e-4


def _case(seed, n, v, f, lo=-5, hi_extra=5):
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, v + hi_extra, size=n).astype(np.int32)
    vals = rng.standard_normal((n, f)).astype(np.float32)
    return idx, vals


def _numpy_scatter(idx, vals, v, acc=None):
    out = np.zeros((v, vals.shape[1]), np.float32) if acc is None else acc.copy()
    ok = (idx >= 0) & (idx < v)
    np.add.at(out, idx[ok], vals[ok])
    return out


@pytest.mark.parametrize("f", [1, 2, 3, 4, 5])
def test_multi_matches_numpy_with_carry_in(f):
    V = 1600
    idx, vals = _case(0, 5000, V, f)
    idx2, vals2 = _case(1, 3000, V, f)
    got = tsa.scatter_add_multi(torch.from_numpy(idx), torch.from_numpy(vals), V)
    want = _numpy_scatter(idx, vals, V)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # carry-in: the accumulator passed as acc is updated in place
    got2 = tsa.scatter_add_multi(torch.from_numpy(idx2), torch.from_numpy(vals2),
                                 V, acc=got)
    assert got2.data_ptr() == got.data_ptr()
    np.testing.assert_allclose(got2.numpy(), _numpy_scatter(idx2, vals2, V, want),
                               atol=ATOL)


def test_multi_matches_jax_pallas_with_carry_in():
    V = 1600
    idx, vals = _case(3, 5000, V, 5)
    idx2, vals2 = _case(4, 5000, V, 5)
    packed = jsa.scatter_add_multi(jnp.asarray(idx), jnp.asarray(vals), V,
                                   interpret=True)
    packed2 = jsa.scatter_add_multi(jnp.asarray(idx2), jnp.asarray(vals2), V,
                                    acc=packed, interpret=True)
    got = tsa.scatter_add_multi(torch.from_numpy(idx), torch.from_numpy(vals), V)
    np.testing.assert_allclose(
        tsa.unpack_multi(got, V, 5).numpy(),
        np.asarray(jsa.unpack_multi(packed, V, 5)), atol=ATOL)
    got2 = tsa.scatter_add_multi(torch.from_numpy(idx2), torch.from_numpy(vals2),
                                 V, acc=got.clone())
    np.testing.assert_allclose(
        got2.numpy(), np.asarray(jsa.unpack_multi(packed2, V, 5)), atol=ATOL)


def test_rows_matches_jax_pallas_and_numpy():
    V = 700
    idx, vals = _case(5, 5000, V, 1)
    val = vals[:, 0].copy()
    want_jax = np.asarray(jsa.scatter_add_rows(
        jnp.asarray(idx), jnp.asarray(val), V, chunk=512, interpret=True))
    got = tsa.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(val), V)
    assert got.shape == (V,)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _numpy_scatter(idx, vals, V)[:, 0],
                               atol=ATOL)
    ref = tsa.scatter_add_rows_reference(torch.from_numpy(idx),
                                         torch.from_numpy(val), V)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_empty_and_all_dropped_inputs():
    V = 300
    empty_i = torch.zeros(0, dtype=torch.int32)
    out = tsa.scatter_add_multi(empty_i, torch.zeros((0, 5)), V)
    assert out.shape == (V, 5) and not out.any()
    rows = tsa.scatter_add_rows(empty_i, torch.zeros(0), V)
    assert rows.shape == (V,) and not rows.any()
    # every index out of range on both sides: nothing lands
    idx = torch.tensor([-1, -7, V, V + 3], dtype=torch.int32)
    out = tsa.scatter_add_multi(idx, torch.ones((4, 5)), V)
    assert not out.any()
    jout = jsa.scatter_add_rows(jnp.asarray(np.full(100, -1, np.int32)),
                                jnp.ones(100), V, chunk=64, interpret=True)
    assert float(jnp.abs(jout).sum()) == 0.0


def test_cpu_path_does_not_count_launches():
    tsa.reset_launch_count()
    tsa.scatter_add_multi(torch.tensor([0, 1], dtype=torch.int32),
                          torch.ones((2, 5)), 4)
    assert tsa.launch_count == 0


@pytest.mark.parametrize("bad", ["idx_dtype", "vals_dtype", "shape", "stride",
                                 "acc_shape", "six_fields"])
def test_wrapper_rejects_bad_inputs(bad):
    idx = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros((8, 5))
    acc = None
    if bad == "six_fields":
        vals = torch.zeros((8, 6))
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "vals_dtype":
        vals = vals.double()
    elif bad == "shape":
        vals = torch.zeros((7, 5))
    elif bad == "stride":
        vals = torch.zeros((5, 8)).T
    elif bad == "acc_shape":
        acc = torch.zeros((10, 4))
    with pytest.raises((TypeError, ValueError)):
        tsa.scatter_add_multi(idx, vals, 10, acc=acc)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU takes the kernel or raises; the meta device has
    no kernel, so the wrapper must raise rather than use the plain path."""
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.zeros((4, 5), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsa.scatter_add_multi(idx, vals, 8)


@pytest.mark.gpu
def test_cuda_kernel_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    V = 16384 * 512
    rng = np.random.default_rng(7)
    idx = rng.integers(-1000, V + 1000, size=600_000).astype(np.int32)
    vals = rng.standard_normal((600_000, 5)).astype(np.float32)
    i_d, v_d = torch.from_numpy(idx).cuda(), torch.from_numpy(vals).cuda()
    tsa.reset_launch_count()
    got = tsa.scatter_add_multi(i_d, v_d, V)
    got = tsa.scatter_add_multi(i_d, v_d, V, acc=got)
    torch.cuda.synchronize()
    assert tsa.launch_count == 2
    want = tsa.scatter_add_multi_reference(i_d, v_d, V)
    want = tsa.scatter_add_multi_reference(i_d, v_d, V, acc=want)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)
