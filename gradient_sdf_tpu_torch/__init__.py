"""gradient_sdf_tpu_torch — the PyTorch/CUDA port of gradient_sdf_tpu.

Same module layout and public names as the JAX package beside it, which
stays the reference: each module here is the counterpart of the file of
the same path under `gradient_sdf_tpu/`. Tensors carry an explicit device;
everything runs in float32. The hand-written kernels so far are the
multi-field scatter-add (`ops/kernels/scatter_add.py`, `csrc/scatter_add.cu`)
that replaces the Pallas kernel of `gradient_sdf_tpu/ops/pallas/`, and
`merge_clear` (`ops/kernels/merge_clear.py`, `csrc/merge_clear.cu`), which
folds fusion's accumulator into the grid over the allocated blocks.

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
