"""The port's hand-written Hopper kernels (CUDA C++ for sm_90a).

csrc/decode.cu           wire decode        (transport.decode_batch)
csrc/unpack.cu           packed unpack      (lattice.unpack)
csrc/expr.cu             expression interp. (expr.eval_programs)
csrc/scatter.cu          scatter-aggregate  (lattice.scatter_step)
csrc/topk.cu             top-k fold         (lattice.topk_step)
csrc/close.cu            fused close        (lattice.close_slots,
                                             lattice.reset_slots) and
                         per-slot close     (lattice.extract_slot,
                                             lattice.reset_slot)
csrc/touched.cu          changelog extract  (lattice.extract_touched)
csrc/rebase.cu           rebase             (lattice.rebase), and an empty
                         kernel (hs_empty), the floor a launch is timed against
csrc/session_step.cu     session step       (session_lattice.session_step)
csrc/session_merge.cu    session merge      (session_lattice.session_merge)
csrc/session_extract.cu  session extract    (session_lattice.session_extract)
csrc/session_remap.cu    session code remap (session_lattice.session_remap;
                         with its sentinel flag, the join's code remap)
csrc/join_probe.cu       join probe         (join_lattice.join_probe_insert,
                                             join_probe_only,
                                             join_probe_insert_step)
csrc/join_insert.cu      join merge-insert  (the same three but probe_only)
csrc/join_evict.cu       join eviction      (join_lattice.join_evict)

session_chain.cuh is the sort + segmented scan + fold core the session
step and merge share; join_core.cuh the join's binary searches and tiled
scans; record.cuh and finalize.cuh hold the input reads,
atomics and estimates the window and session kernels share.

build.py compiles them with nvcc on first CUDA use; binding.py binds
their C interface with ctypes. The wrappers, their plain PyTorch
versions and their launch counters live beside the code that calls
them (engine/transport.py, engine/lattice.py, engine/expr.py,
engine/session_lattice.py, engine/join_lattice.py).
"""
