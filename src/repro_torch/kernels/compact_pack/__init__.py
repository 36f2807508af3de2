from repro_torch.kernels.compact_pack.ops import compact_chunks, plan_compaction  # noqa
