# Hand-written Hopper kernels of the port (csrc/*.cu) with their wrappers and
# plain PyTorch versions; build.py compiles and loads them, ops.py holds the
# attn_impl resolution and the launch counters.
#   flash_attention — flash forward (prefill, training) and backward (dQ and
#                     dK/dV passes, training), replaces the Pallas _fwd_kernel,
#                     _dq_kernel and _dkv_kernel
#   paged_attention — paged decode attention, replaces the Pallas _kernel
