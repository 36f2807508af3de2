"""repro_torch: the PyTorch/CUDA port of the AutoComp compaction stack.

The JAX package ``repro`` beside it is the reference; this package imports
none of it. Ported layers:
  repro_torch.lst      -- log-structured table substrate (Iceberg-semantics)
  repro_torch.core     -- AutoComp: the paper's OODA compaction loop
  repro_torch.data     -- token shards and the compaction merge
  repro_torch.kernels  -- hand-written CUDA kernels for Hopper (sm_90a),
                          each with a plain PyTorch version
"""

__version__ = "0.1.0"
