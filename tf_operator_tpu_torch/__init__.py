"""PyTorch / CUDA port of the tf_operator_tpu workload plane.

The JAX package `tf_operator_tpu` is the reference this package is
held against; nothing here imports it or JAX. The layout mirrors the
reference's sub-packages (`ops/`, `models/`, `train/`) so each module's
counterpart is found under the same name.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(see `_device.resolve_device`). The kernels are hand-written CUDA C++
for Hopper: flash attention (`csrc/flash_attention.cu`) and the 3x3
conv with its weight gradient (`csrc/conv_bn.cu`), built with nvcc at
first use into `build/kernels/`.
"""
