"""repro_torch: the PyTorch/CUDA port of the AutoComp compaction stack.

The JAX package ``repro`` beside it is the reference; this package imports
none of it. Ported layers:
  repro_torch.lst      -- log-structured table substrate (Iceberg-semantics)
  repro_torch.core     -- AutoComp: the paper's OODA compaction loop
  repro_torch.data     -- token shards and the compaction merge
  repro_torch.kernels  -- hand-written CUDA kernels for Hopper (sm_90a),
                          each with a plain PyTorch version
  repro_torch.configs  -- the architecture configs (copies of the reference's)
                          and the assigned input shapes
  repro_torch.dist     -- sharding rules on a DeviceMesh, the two-stage int8
                          gradient exchange across ranks, the serve
                          quantizers, the f8 cast and the fan-in arbiter
  repro_torch.models   -- all seven families, training and serving, the
                          decode-state stores, and the weights' and caches'
                          carry-over
  repro_torch.train    -- AdamW, the train and serve steps, checkpoints, the
                          Trainer
  repro_torch.launch   -- meshes, the training launcher (one process or
                          several ranks) and the serving launcher (one
                          device)
"""

__version__ = "0.1.0"
