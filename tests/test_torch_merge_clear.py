"""Port merge_clear (gradient_sdf_tpu_torch/ops/kernels/merge_clear.py)
against the JAX package's dense `_merge_accumulators` and against its own
dense form; its touched-block mode, `merge_touched` (the mesh's merge),
against the JAX package's compact mesh path and against the step it
replaced.

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
  * merge_touched vs the replaced step (`keep_owned_rows` + merge_clear
    over the shard's allocated slots): bit equality on the touched blocks
    the rank owns, and every other block keeps its bits. The replaced
    step's dense merge computed (d W) / W on the untouched allocated
    blocks, which moves d by at most 2 ulps (two roundings): those voxels
    are held to that bound, and their weights and gradients to equality.
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
from gradient_sdf_tpu_torch.tools import fusion_bench as fb
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


# ---------------------------------------------------------------------------
# merge_touched: a rank's shard of 16 slots of a 48-slot grid whose slots
# [0, 40) are allocated, and the frame's touched blocks in the world-summed
# compact rows (block i of the list at rows [i B^3, (i + 1) B^3))
# ---------------------------------------------------------------------------

MESH_NB, MESH_M, MESH_ACTIVE = 48, 16, 40
# case: (lo, touched blocks, full path, with gradients)
TOUCHED_CASES = {
    "every touched block owned": (32, [32, 34, 35, 39], False, True),
    "none owned": (32, [1, 5, 16, 30], False, True),
    "straddling lo and lo + m": (16, [3, 15, 16, 17, 20, 31, 32, 39], False,
                                 True),
    "full path's indexing": (16, [3, 15, 16, 17, 20, 31, 32, 39], True, True),
    "no gradients": (16, [3, 15, 16, 17, 20, 31, 32, 39], False, False),
    "empty list": (16, [], False, True),
}
VPB = GCFG.voxels_per_block


def _touched_state(seed, lo, touched, full):
    """numpy (shard fields, red, tidx): the shard's allocated slots hold
    observed and never-observed voxels; each touched block's summed rows
    hit about half its voxels. `red` is [cap * B^3, 5] with cap = the list
    plus 2 spare blocks (zero rows), or [nb * B^3, 5] with the rows at the
    blocks' slots for the full path."""
    rng = np.random.default_rng(seed)
    m = MESH_M
    na = int(np.clip(MESH_ACTIVE - lo, 0, m))
    f = {k: np.zeros((m, VPB), np.float32) for k in FIELDS}
    seen = rng.random((na, VPB)) < 0.6
    f["weight"][:na] = np.where(seen, rng.uniform(0.2, 30.0, seen.shape), 0.0)
    f["dist"][:na] = np.where(seen, rng.uniform(-0.1, 0.1, seen.shape), 0.0)
    for k in FIELDS[2:]:
        f[k][:na] = np.where(seen, rng.standard_normal(seen.shape) * 5.0, 0.0)
    n = len(touched)
    blocks = np.zeros((n, VPB, 5), np.float32)
    hit = rng.random((n, VPB)) < 0.5
    w = np.where(hit, rng.uniform(0.05, 12.0, hit.shape), 0.0).astype(np.float32)
    blocks[..., 0] = w
    blocks[..., 1] = w * rng.uniform(-0.1, 0.1, hit.shape)
    blocks[..., 2:] = w[..., None] * rng.standard_normal(hit.shape + (3,))
    if full:
        red = np.zeros((MESH_NB, VPB, 5), np.float32)
        red[touched] = blocks
    else:
        red = np.concatenate([blocks, np.zeros((2, VPB, 5), np.float32)])
    return f, red.reshape(-1, 5), np.asarray(touched, np.int64), blocks


def _touched_torch(f, red, tidx):
    return ([torch.from_numpy(f[k].copy()) for k in FIELDS],
            torch.from_numpy(red.copy()), torch.from_numpy(tidx.copy()))


def _ulps(a, b):
    """|a - b| in units in the last place of float32 (same-sign values)."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return (ia - ib).abs()


@pytest.mark.parametrize("case", list(TOUCHED_CASES))
def test_merge_touched_matches_jax_compact_path(case):
    """The JAX compact path's arithmetic: the summed rows scattered into a
    dense [nb_local, B^3] buffer through `dest_row`
    (gradient_sdf_tpu/parallel/sharding.py:278-285), then the dense
    `_merge_accumulators`."""
    lo, touched, full, with_grad = TOUCHED_CASES[case]
    f, red, tidx, blocks = _touched_state(10, lo, touched, full)
    jg = jvg.create(GridConfig(voxel_size=0.02, num_blocks=MESH_M,
                               dir_dim=16))._replace(
        **{k: jnp.asarray(v) for k, v in f.items()})
    owned = (tidx >= lo) & (tidx < lo + MESH_M)
    dest_row = jnp.asarray(np.where(owned, tidx - lo, MESH_M))
    accs = tuple(
        jnp.zeros((MESH_M, VPB), jnp.float32).at[dest_row].add(
            jnp.asarray(blocks[..., c]).reshape(-1, VPB), mode="drop"
        ).reshape(-1) for c in range(5))
    want = jfu._merge_accumulators(jg, accs, with_grad)
    fields, t_red, t_tidx = _touched_torch(f, red, tidx)
    mc.merge_touched(t_red, t_tidx, lo, *fields, full=full,
                     with_grad=with_grad)
    for k, got in zip(FIELDS, fields):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_array_equal(t_red.numpy(), red)   # read only


@pytest.mark.parametrize("case", list(TOUCHED_CASES))
def test_merge_touched_equals_the_replaced_step(case):
    """Bit for bit the step it replaced on the blocks it merges
    (module note): `keep_owned_rows` into a persistent [m * B^3, 8]
    accumulator, then `merge_clear_reference` over the shard's allocated
    slots (the full path copied red[lo B^3 : (lo + m) B^3] instead)."""
    lo, touched, full, with_grad = TOUCHED_CASES[case]
    f, red, tidx, blocks = _touched_state(11, lo, touched, full)
    fields, t_red, t_tidx = _touched_torch(f, red, tidx)
    mc.merge_touched(t_red, t_tidx, lo, *fields, full=full,
                     with_grad=with_grad)
    old, o_red, o_tidx = _touched_torch(f, red, tidx)
    acc = tsa.new_accumulator(MESH_M * VPB, "cpu")
    if full:
        acc[:, :5] = o_red[lo * VPB:(lo + MESH_M) * VPB]
    else:
        fb.keep_owned_rows(acc, o_red, o_tidx, lo, MESH_M, VPB)
    na = fb.shard_active(torch.tensor(MESH_ACTIVE, dtype=torch.int32), lo,
                         MESH_M)
    mc.merge_clear_reference(acc, *old, na, with_grad=with_grad)
    assert not acc.any()
    owned = [b - lo for b in touched if lo <= b < lo + MESH_M]
    rest = [b for b in range(MESH_M) if b not in owned]
    for k, new, was in zip(FIELDS, fields, old):
        before = torch.from_numpy(f[k])
        assert torch.equal(new[owned].view(torch.int32),
                           was[owned].view(torch.int32)), k
        assert torch.equal(new[rest].view(torch.int32),
                           before[rest].view(torch.int32)), k
        if k != "dist":
            assert torch.equal(was[rest], before[rest]), k
        else:
            assert int(_ulps(was[rest], before[rest]).max()) <= 2
    if owned:
        assert not torch.equal(fields[0][owned], torch.from_numpy(
            f["weight"])[owned]), "the owned touched blocks were merged"
    if not with_grad:
        for k, new in zip(FIELDS[2:], fields[2:]):
            assert torch.equal(new, torch.from_numpy(f[k]))


def test_bench_check_runs_on_the_cpu():
    """`fusion_bench.mesh_merge_check`, which the card's smoke runs on every
    rank's real inputs, passes on the straddling case's state here (the
    wrappers take their plain versions)."""
    lo, touched, _, _ = TOUCHED_CASES["straddling lo and lo + m"]
    f, red, tidx, _ = _touched_state(12, lo, touched, False)
    fields, t_red, t_tidx = _touched_torch(f, red, tidx)
    got = fb.mesh_merge_check({
        "red": t_red, "tidx": t_tidx, "lo": lo, "fields": fields,
        "num_blocks": MESH_NB,
        "num_active": torch.tensor(MESH_ACTIVE, dtype=torch.int32)})
    assert (got["owned"], got["n_list"]) == (4, 8)
    assert got["dense_drift_voxels"] > 0


def test_merge_touched_wrapper_on_cpu_counts_no_launch():
    lo, touched, full, _ = TOUCHED_CASES["straddling lo and lo + m"]
    f, red, tidx, _ = _touched_state(13, lo, touched, full)
    a, r1, t1 = _touched_torch(f, red, tidx)
    b, r2, t2 = _touched_torch(f, red, tidx)
    mc.reset_launch_count()
    mc.merge_touched(r1, t1, lo, *a)
    mc.merge_touched_reference(r2, t2, lo, *b)
    assert mc.launch_count == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["red_width", "red_rows", "red_rows_full",
                                 "red_dtype", "tidx_dtype", "tidx_shape",
                                 "field_shape"])
def test_merge_touched_rejects_bad_inputs(bad):
    lo, touched, _, _ = TOUCHED_CASES["straddling lo and lo + m"]
    f, red, tidx, _ = _touched_state(14, lo, touched, False)
    fields, r, t = _touched_torch(f, red, tidx)
    full = False
    if bad == "red_width":
        r = torch.cat([r, r[:, :1]], dim=1)
    elif bad == "red_rows":
        r = r[:len(touched) * VPB - 1]
    elif bad == "red_rows_full":
        full = True   # the compact rows do not cover the shard's slots
    elif bad == "red_dtype":
        r = r.double()
    elif bad == "tidx_dtype":
        t = t.to(torch.int32)
    elif bad == "tidx_shape":
        t = t[None]
    elif bad == "field_shape":
        fields[3] = fields[3][:-1]
    with pytest.raises((TypeError, ValueError)):
        mc.merge_touched(r, t, lo, *fields, full=full)


def test_merge_touched_never_falls_back():
    fields = [torch.zeros((2, 8), device="meta") for _ in FIELDS]
    red = torch.zeros((16, 5), device="meta")
    tidx = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        mc.merge_touched(red, tidx, 0, *fields)


@pytest.mark.parametrize("switch", list(fb.MERGE_SWITCHES))
def test_bench_switches_match_the_kernel_source(switch):
    """Each one-switch build of `fusion_bench --mesh-merge` finds every
    anchor of its edits in csrc/merge_clear.cu exactly once (as
    `build_switched` requires), in order, and changes the source."""
    import os

    path = os.path.join(os.path.dirname(mc.__file__), "..", "..", "csrc",
                        "merge_clear.cu")
    with open(path) as f:
        text = f.read()
    edited = text
    for old, new in fb.MERGE_SWITCHES[switch]:
        assert edited.count(old) == 1, old
        edited = edited.replace(old, new)
    assert edited != text


@pytest.mark.gpu
def test_cuda_merge_touched_matches_reference_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    mc.reset_launch_count()
    launched = 0
    for case, (lo, touched, full, with_grad) in TOUCHED_CASES.items():
        f, red, tidx, _ = _touched_state(15, lo, touched, full)
        got, r, t = _touched_torch(f, red, tidx)
        want, r2, t2 = _touched_torch(f, red, tidx)
        got, r, t = [x.cuda() for x in got], r.cuda(), t.cuda()
        mc.merge_touched(r, t, lo, *got, full=full, with_grad=with_grad)
        torch.cuda.synchronize()
        launched += bool(touched)
        mc.merge_touched_reference(r2, t2, lo, *want, full=full,
                                   with_grad=with_grad)
        for k, x, y in zip(FIELDS, got, want):
            assert torch.equal(x.cpu().view(torch.int32),
                               y.view(torch.int32)), (case, k)
    assert mc.launch_count == launched
