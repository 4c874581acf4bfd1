"""The port's hand-written Hopper kernels (CUDA C++ for sm_90a).

csrc/decode.cu   wire decode        (transport.decode_batch)
csrc/expr.cu     expression interp. (expr.eval_programs)
csrc/scatter.cu  scatter-aggregate  (lattice.scatter_step)
csrc/topk.cu     top-k fold         (lattice.topk_step)
csrc/close.cu    fused close        (lattice.close_slots)
csrc/touched.cu  changelog extract  (lattice.extract_touched)
csrc/rebase.cu   rebase             (lattice.rebase)

build.py compiles them with nvcc on first CUDA use; binding.py binds
their C interface with ctypes. The wrappers, their plain PyTorch
versions and their launch counters live beside the code that calls
them (engine/transport.py, engine/lattice.py).
"""
