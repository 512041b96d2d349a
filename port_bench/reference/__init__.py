"""Plain PyTorch reference of the benchmarked passes.

Written for the benchmark and kept under its folder: it imports nothing of
the program (`gradient_sdf_tpu_torch`) nor of the JAX package, and takes no
array the program made except the program's outputs it judges and, where a
check follows the program step by step, the program's state before that
step (PERF.md says which). The formulas follow the upstream C++ and the
JAX package's semantics, written out elementwise so that they round as the
program's kernels do (float32, no fused multiply-adds, IEEE divisions);
only the order of the sums differs.

Every function takes the working float type from its inputs: the control
of `correct` runs the same code in bfloat16.
"""
