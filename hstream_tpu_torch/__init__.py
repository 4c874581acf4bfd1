"""hstream_tpu_torch: the PyTorch + CUDA port of hstream_tpu's engine.

The package mirrors hstream_tpu's module layout, so each module's
counterpart is found under the same path. It imports torch and numpy,
never jax and nothing of hstream_tpu. Device work runs in kernels
written by hand for Hopper (engine/kernels/csrc), built on first CUDA
use; every kernel has a plain PyTorch version beside its wrapper, which
runs only for tensors that lie on the CPU.

Entry points run on the card unless the caller passes device="cpu".
"""
