"""The FALS normals kernel's wrapper (gradient_sdf_tpu_torch/ops/kernels/
fals_normals.py) against the JAX package's `ops/normals.compute_normals`.

Inputs are made with numpy from a seed at 48x40 (a width that no 32-pixel
tile divides): a tilted bumpy surface with scattered zero-depth holes, a
hole larger than the window (its centre's windows see no depth: NaN) and
depth on every border row and column (reflect-101 at the edges).

On the CPU the wrapper runs the plain version, `ops/normals.compute_normals`
and its float64 window sums `window_sums`; the CUDA kernel has no CPU mode,
and the `gpu`-marked tests hold it to that plain version on a card.

Tolerances, with their reasons:
  * port vs JAX: the same non-finite pixels; finite normals atol 2e-3
    (test_torch_core.py's bound: the JAX package's banded-matmul box sums
    and the port's float64 sums differ by ~1e-6 of a window sum, which the
    nearly singular 3x3 FALS systems, cond ~1e3, amplify);
  * kernel vs plain on the card: bit for bit (the float64 window sums of
    float32 terms are exact in any order, and the kernel repeats the plain
    version's float32 operations without fused multiply-adds).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu_torch.config import FusionConfig
from gradient_sdf_tpu_torch.ops import fusion as tfu
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops.kernels import fals_normals as fn

W, H = 48, 40
K = np.array([[40.0, 0, 23.5], [0, 40.0, 19.5], [0, 0, 1]], dtype=np.float32)
ATOL = 2e-3


def _depth(seed=3, width=W, height=H):
    """A tilted, bumpy surface with 5% zero-depth holes and one 13 x 13
    hole, larger than the largest window tested."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    d = 1.1 + 0.012 * xx - 0.006 * yy + 0.03 * np.sin(xx / 4.0 + yy / 7.0)
    d += 0.002 * rng.standard_normal((height, width))
    d[rng.random((height, width)) < 0.05] = 0.0
    d[8:21, 20:33] = 0.0
    return d.astype(np.float32)


def _caches(window, width=W, height=H):
    return (jnorm.build_cache(width, height, K, window=window),
            tnorm.build_cache(width, height, K, window=window, device="cpu"))


@pytest.mark.parametrize("window", [5, 11])
def test_plain_path_matches_jax(window):
    """The wrapper's CPU path = JAX compute_normals within ATOL, the same
    pixels non-finite (the big hole's centre), the borders included."""
    depth = _depth()
    jc, tc = _caches(window)
    want = np.asarray(jnorm.compute_normals(jc, jnp.asarray(depth)))
    got = fn.fals_normals(tc, torch.from_numpy(depth)).numpy()
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert not fin[14, 26].any()          # the hole's centre: no depth
    assert fin[0].all() and fin[-1].all() and fin[:, 0].all()
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)
    norms = np.linalg.norm(got[fin.all(-1)], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


@pytest.mark.parametrize("window", [5, 11])
def test_window_sums_match_jax_box_filter(window):
    """b = the reflect-101 box sums of (x0, y0, 1) / |h|^2 / z: the plain
    float64 sums against the JAX package's box filter on the same float32
    products (its banded matrix products round each sum: rtol 1e-5)."""
    depth = _depth()
    jc, tc = _caches(window)
    _, b = fn.fals_normals(tc, torch.from_numpy(depth), with_sums=True)
    with np.errstate(divide="ignore"):
        z_inv = np.where(depth != 0.0, 1.0 / depth, 0.0).astype(np.float32)
    for c, ray in enumerate((jc.x0_n_sq_inv, jc.y0_n_sq_inv, jc.n_sq_inv)):
        want = np.asarray(jnorm.box_filter(ray * jnp.asarray(z_inv), window,
                                           jc.Sh, jc.Sw))
        np.testing.assert_allclose(b[c].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_with_sums_is_the_plain_version_bit_for_bit():
    depth = torch.from_numpy(_depth(5))
    _, tc = _caches(11)
    n, b = fn.fals_normals(tc, depth, with_sums=True)
    n_ref, b_ref = fn.fals_normals_reference(tc, depth)
    assert torch.equal(b, b_ref) and torch.equal(b, tnorm.window_sums(tc, depth))
    assert torch.equal(n.nan_to_num(7.0), n_ref.nan_to_num(7.0))
    assert torch.equal(n.nan_to_num(7.0),
                       tnorm.compute_normals(tc, depth).nan_to_num(7.0))


def test_cpu_path_launches_nothing_and_fusion_takes_it():
    """fuse_frame's normals come from the wrapper: a CPU map runs the plain
    version and counts no launch."""
    _, tc = _caches(5)
    fn.reset_launch_count()
    fn.fals_normals(tc, torch.from_numpy(_depth()))
    assert fn.launch_count == 0
    assert tfu.fals_normals is fn.fals_normals


@pytest.mark.parametrize("bad", ["even", "wide", "dtype", "shape"])
def test_rejects_what_the_kernel_does_not_take(bad):
    depth = torch.from_numpy(_depth())
    _, tc = _caches(5)
    if bad == "even":
        tc = tc._replace(window=4)
    elif bad == "wide":
        tc = tc._replace(window=2 * H + 1)
    elif bad == "dtype":
        depth = depth.double()
    else:
        depth = depth[:, :-1]
    with pytest.raises(ValueError):
        fn.fals_normals(tc, depth)


def _kernel_order_box_sums(img, window, tile_y=16, strip=16):
    """The window sums of the float32 images `img` [C, H, W] in the order
    the kernel (csrc/fals_normals.cu) takes them, in float64: for each tile
    of `tile_y` output rows, down each column of the reflect-101 padded
    image a running sum, ((s + entering) - leaving) after a first sum of
    `window` terms; then along each output row, for each strip of `strip`
    outputs, the same over those column sums; rounded to float32."""
    r = window // 2
    _, H, W = img.shape
    a = np.pad(img.astype(np.float64), ((0, 0), (r, r), (r, r)),
               mode="reflect")
    col = np.empty((img.shape[0], H, W + 2 * r))
    for y0 in range(0, H, tile_y):
        s = np.zeros(col.shape[::2])
        for k in range(window):
            s = s + a[:, y0 + k]
        col[:, y0] = s
        for y in range(y0 + 1, min(y0 + tile_y, H)):
            s = s + a[:, y + 2 * r]
            s = s - a[:, y - 1]
            col[:, y] = s
    out = np.empty(img.shape, np.float32)
    for x0 in range(0, W, strip):
        s = np.zeros(col.shape[:2])
        for k in range(window):
            s = s + col[:, :, x0 + k]
        out[:, :, x0] = s
        for x in range(x0 + 1, min(x0 + strip, W)):
            s = s + col[:, :, x + 2 * r]
            s = s - col[:, :, x - 1]
            out[:, :, x] = s
    return out


@pytest.mark.parametrize("window", [5, 11, 21])
def test_kernel_running_sums_are_box_filter_bit_for_bit(window):
    """The kernel's add-and-subtract order, emulated in numpy on a frame
    with holes, gives `box_filter`'s float32 sums bit for bit: every partial
    sum of the frame's float32 products is exact in float64."""
    depth = torch.from_numpy(_depth(9))
    _, tc = _caches(window)
    z_inv = torch.where(depth != 0.0, 1.0 / depth, torch.zeros_like(depth))
    img = torch.stack([tc.x0_n_sq_inv * z_inv, tc.y0_n_sq_inv * z_inv,
                       tc.n_sq_inv * z_inv])
    want = tnorm.box_filter(img, window).numpy()
    got = _kernel_order_box_sums(img.numpy(), window)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _gates(depth, normals, cache):
    return tfu._pixel_rays(depth, normals, cache, FusionConfig()).valid


@pytest.mark.gpu
@pytest.mark.parametrize("window,size", [(5, (W, H)), (11, (W, H)),
                                         (11, (640, 480)), (3, (37, 13)),
                                         (21, (W, H)), (21, (640, 480)),
                                         (11, (130, 35)), (5, (67, 17)),
                                         (11, (641, 481))])
def test_cuda_kernel_matches_plain_bit_for_bit(window, size):
    """On a card: the kernel's b, normals (NaN where the plain version's
    are) and fusion's gated pixels equal the plain version's on the card,
    bit for bit; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    width, height = size
    tc = tnorm.build_cache(width, height, K, window=window, device="cuda")
    depth = torch.from_numpy(_depth(11, width, height)).cuda()
    fn.reset_launch_count()
    n, b = fn.fals_normals(tc, depth, with_sums=True)
    n2 = fn.fals_normals(tc, depth)
    torch.cuda.synchronize()
    assert fn.launch_count == 2
    n_ref, b_ref = fn.fals_normals_reference(tc, depth)
    assert torch.equal(b, b_ref)
    assert torch.equal(torch.isnan(n), torch.isnan(n_ref))
    assert torch.equal(n.nan_to_num(7.0), n_ref.nan_to_num(7.0))
    assert torch.equal(n.nan_to_num(7.0), n2.nan_to_num(7.0))
    assert torch.equal(_gates(depth, n, tc), _gates(depth, n_ref, tc))


@pytest.mark.gpu
def test_cuda_kernel_on_every_card_at_window_21():
    """Window 21 needs more than the 48 KB of shared memory a launch gets
    by default: the kernel raises its limit on each card it runs on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    depth = _depth(13, 160, 120)
    for d in range(torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        tc = tnorm.build_cache(160, 120, K, window=21, device=dev)
        n, b = fn.fals_normals(tc, torch.from_numpy(depth).to(dev),
                               with_sums=True)
        n_ref, b_ref = fn.fals_normals_reference(tc, torch.from_numpy(
            depth).to(dev))
        torch.cuda.synchronize(dev)
        assert torch.equal(b, b_ref)
        assert torch.equal(n.nan_to_num(7.0), n_ref.nan_to_num(7.0))


@pytest.mark.gpu
def test_cuda_fuse_frame_launches_the_kernel_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA map's path)")
    from gradient_sdf_tpu_torch.config import GridConfig
    from gradient_sdf_tpu_torch.ops import voxel_grid as tvg

    gcfg = GridConfig(voxel_size=0.02, num_blocks=2048)
    fcfg = dataclasses.replace(FusionConfig(), trunc_voxels=5.0)
    tc = tnorm.build_cache(W, H, K, window=5, device="cuda")
    grid = tvg.create(gcfg, "cuda")
    fn.reset_launch_count()
    tfu.fuse_frame(grid, torch.from_numpy(_depth()).cuda(), tc,
                   torch.eye(3, device="cuda"), torch.zeros(3, device="cuda"),
                   gcfg, fcfg)
    torch.cuda.synchronize()
    assert fn.launch_count == 1


def test_bench_switches_match_the_kernel_source():
    """`tools/fusion_bench.py` takes the kernel apart by one-switch builds of a
    copy of its source: the source is one of the designs its table knows,
    and every switch's anchor is in it exactly once."""
    import os

    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.tools import fusion_bench

    with open(os.path.join(_build.CSRC, "fals_normals.cu")) as f:
        text = f.read()
    table = fusion_bench.NORMALS_SWITCHES
    designs = [d for d, (mark, _) in table.items() if mark in text]
    assert len(designs) == 1
    for name, edits in table[designs[0]][1].items():
        for old, _ in edits:
            assert text.count(old) == 1, name
