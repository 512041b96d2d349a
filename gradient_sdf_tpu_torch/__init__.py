"""gradient_sdf_tpu_torch — the PyTorch/CUDA port of gradient_sdf_tpu.

Same module layout and public names as the JAX package beside it, which
stays the reference: each module here is the counterpart of the file of
the same path under `gradient_sdf_tpu/`. Tensors carry an explicit device;
everything runs in float32. The hand-written CUDA kernels live in
`csrc/` behind `ops/kernels/`: the multi-field scatter-add that replaces
the Pallas kernel of `gradient_sdf_tpu/ops/pallas/` (`scatter_add`), one
card's fusion of a frame in two launches (`fuse_integrate`), the mesh's
merge (`merge_clear`), the renderer's march (`raycast_march`) and the
Gauss-Newton tracking loop (`gn_track`).

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
