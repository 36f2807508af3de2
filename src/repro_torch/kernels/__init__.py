"""Hand-written CUDA kernels for Hopper (sm_90a), the port of the JAX
package's Pallas kernels.

Each kernel subpackage ships three modules:
  <name>.py -- the ctypes wrapper: checks operands, launches the kernel on
               CUDA tensors, counts launches, runs the plain version on CPU
  ops.py    -- host planning + the op registered on the registry (api.py)
  ref.py    -- plain PyTorch versions, the oracle on the card and the path
               the CPU takes

Shared surface:
  api.py    -- tunable-op registry: axes + defaults + clamp + ref per op,
               one dispatch (`api.call`)
  tuned.py  -- persisted tuned-point cache (experiments/tuned_torch/, JSON,
               keyed op|shape_key with a device-kind guard)
  build.py  -- nvcc build of csrc/*.cu into build/kernels/, loaded by ctypes

Kernels:
  compact_pack -- chunk-aligned token-run compaction (the AutoComp rewrite
                  inner loop) + fused filter+pack (rewrite-deletes)
"""
