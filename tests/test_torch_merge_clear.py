"""Port merge_clear (gradient_sdf_tpu_torch/ops/kernels/merge_clear.py)
against the JAX package's dense `_merge_accumulators` and against its own
dense form.

The same seeded numpy state goes through both packages: a grid whose first
slots are allocated (some voxels observed before, some never), the rest
unallocated, and a frame accumulator that touches a part of the allocated
voxels. On the CPU the port's wrapper takes its plain version; the CUDA
kernel is checked by the `gpu`-marked test (skipped without a card) and by
`chip_smoke.py`.

Tolerances, with their reasons:
  * port (allocated slots only) vs port (every slot): bit equality — the
    same elementwise operations, and on an unallocated slot (W = 0, zero
    accumulator row) they are the identity.
  * port vs JAX: atol 1e-6 on values of magnitude <= ~30 — XLA may fuse
    d*W + wd into one multiply-add, which rounds once instead of twice.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import GridConfig
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
from gradient_sdf_tpu_torch.ops.kernels import scatter_add as tsa
from gradient_sdf_tpu_torch.utils import interop

GCFG = GridConfig(voxel_size=0.02, num_blocks=24, dir_dim=16)
ACTIVE = 9
FIELDS = ("weight", "dist", "grad_x", "grad_y", "grad_z")


def _state(seed):
    """numpy grid fields + accumulator [nvox, 8]: slots [0, ACTIVE) hold
    observed (W > 0) and never-observed (W = 0) voxels; the accumulator
    touches about a third of the allocated voxels, observed or not."""
    rng = np.random.default_rng(seed)
    nb, vpb = GCFG.num_blocks, GCFG.voxels_per_block
    f = {k: np.zeros((nb, vpb), np.float32) for k in FIELDS}
    seen = rng.random((ACTIVE, vpb)) < 0.5
    f["weight"][:ACTIVE] = np.where(seen, rng.uniform(0.2, 30.0, seen.shape), 0.0)
    f["dist"][:ACTIVE] = np.where(seen, rng.uniform(-0.1, 0.1, seen.shape), 0.0)
    for k in FIELDS[2:]:
        f[k][:ACTIVE] = np.where(seen, rng.standard_normal(seen.shape) * 5.0, 0.0)
    acc = np.zeros((nb * vpb, tsa.ACC_ROW), np.float32)
    hit = np.flatnonzero(rng.random(ACTIVE * vpb) < 0.35)
    w = rng.uniform(0.05, 12.0, hit.size).astype(np.float32)
    acc[hit, 0] = w
    acc[hit, 1] = w * rng.uniform(-0.1, 0.1, hit.size)
    acc[hit, 2:5] = w[:, None] * rng.standard_normal((hit.size, 3))
    return f, acc


def _torch_state(f, acc):
    return (torch.from_numpy(acc.copy()),
            [torch.from_numpy(f[k].copy()) for k in FIELDS],
            torch.tensor(ACTIVE, dtype=torch.int32))


@pytest.mark.parametrize("with_grad", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_clear_matches_jax_dense_merge(seed, with_grad):
    f, acc = _state(seed)
    jg = jvg.create(GCFG)._replace(
        num_active=jnp.int32(ACTIVE), **{k: jnp.asarray(v) for k, v in f.items()})
    accs = tuple(jnp.asarray(acc[:, i]) for i in range(5))
    want = jfu._merge_accumulators(jg, accs, with_grad)
    t_acc, fields, na = _torch_state(f, acc)
    mc.merge_clear(t_acc, *fields, na, with_grad=with_grad)
    for k, got in zip(FIELDS, fields):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert not t_acc.any(), "the accumulator must read zero afterwards"
    assert float(fields[0].sum()) > float(f["weight"].sum())
    if not with_grad:
        for k, got in zip(FIELDS[2:], fields[2:]):
            np.testing.assert_array_equal(got.numpy(), f[k])


@pytest.mark.parametrize("with_grad", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_over_allocated_slots_equals_dense_bit_for_bit(seed, with_grad):
    f, acc = _state(seed)
    a1, f1, na = _torch_state(f, acc)
    a2, f2, _ = _torch_state(f, acc)
    mc.merge_clear_reference(a1, *f1, na, with_grad=with_grad)
    mc.merge_clear_reference(a2, *f2, na, with_grad=with_grad, dense=True)
    for k, x, y in zip(FIELDS, f1, f2):
        assert torch.equal(x, y), k
        # the state has all three kinds of voxel
        assert torch.equal(x[ACTIVE:], torch.zeros_like(x[ACTIVE:]))
    assert not a1.any() and not a2.any()
    w0 = torch.from_numpy(f["weight"])
    touched = torch.from_numpy(acc[:, 0]).reshape(w0.shape) > 0
    assert bool((touched & (w0 > 0)).any()), "observed voxels touched"
    assert bool((~touched & (w0 > 0)).any()), "observed voxels left alone"
    assert bool((touched & (w0 == 0)).any()), "new voxels"
    # a voxel the frame did not touch keeps its weight bit for bit
    assert torch.equal(f1[0][~touched], w0[~touched])


def test_wrapper_on_cpu_is_the_reference_and_counts_no_launch():
    f, acc = _state(3)
    a1, f1, na = _torch_state(f, acc)
    a2, f2, _ = _torch_state(f, acc)
    mc.reset_launch_count()
    mc.merge_clear(a1, *f1, na)
    mc.merge_clear_reference(a2, *f2, na)
    assert mc.launch_count == 0
    for x, y in zip(f1, f2):
        assert torch.equal(x, y)


def test_zero_active_slots_changes_nothing():
    f, acc = _state(4)
    a, fields, _ = _torch_state(f, acc)
    mc.merge_clear(a, *fields, torch.tensor(0, dtype=torch.int32))
    for k, got in zip(FIELDS, fields):
        np.testing.assert_array_equal(got.numpy(), f[k])
    np.testing.assert_array_equal(a.numpy(), acc)


@pytest.mark.parametrize("bad", ["acc_width", "acc_rows", "acc_dtype",
                                 "num_active_dtype", "field_shape",
                                 "field_stride"])
def test_wrapper_rejects_bad_inputs(bad):
    f, acc = _state(5)
    a, fields, na = _torch_state(f, acc)
    if bad == "acc_width":
        a = a[:, :5].contiguous()
    elif bad == "acc_rows":
        a = a[:-1]
    elif bad == "acc_dtype":
        a = a.double()
    elif bad == "num_active_dtype":
        na = na.long()
    elif bad == "field_shape":
        fields[2] = fields[2][:-1]
    elif bad == "field_stride":
        fields[1] = fields[1].T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        mc.merge_clear(a, *fields, na)


def test_non_cpu_tensor_never_falls_back():
    nb, vpb = 2, 8
    a = torch.zeros((nb * vpb, tsa.ACC_ROW), device="meta")
    fields = [torch.zeros((nb, vpb), device="meta") for _ in FIELDS]
    na = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        mc.merge_clear(a, *fields, na)


def test_interop_roundtrip_keeps_a_merged_grid():
    """The accumulator is scratch: a grid merged in place still converts to
    the checkpoint's arrays and back unchanged."""
    f, acc = _state(6)
    tg = tvg.create(GCFG, "cpu")
    a, fields, na = _torch_state(f, acc)
    tg = tg._replace(num_active=na, **dict(zip(FIELDS, fields)))
    mc.merge_clear(a, tg.weight, tg.dist, tg.grad_x, tg.grad_y, tg.grad_z,
                   tg.num_active)
    arrays = interop.grid_to_numpy(tg)
    assert "acc" not in arrays
    back = interop.grid_from_numpy(arrays)
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(tg, k))


@pytest.mark.gpu
def test_cuda_kernel_matches_reference_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    f, acc = _state(7)
    a1, f1, na = _torch_state(f, acc)
    a2, f2, _ = _torch_state(f, acc)
    a1, na_d = a1.cuda(), na.cuda()
    f1 = [x.cuda() for x in f1]
    mc.reset_launch_count()
    mc.merge_clear(a1, *f1, na_d)
    torch.cuda.synchronize()
    assert mc.launch_count == 1
    mc.merge_clear_reference(a2, *f2, na)
    for x, y in zip(f1, f2):
        assert torch.equal(x.cpu(), y)
    assert not a1.any()
