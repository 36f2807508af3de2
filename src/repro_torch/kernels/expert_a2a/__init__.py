from repro_torch.kernels.expert_a2a.ops import EP_AXES, expert_a2a

__all__ = ["EP_AXES", "expert_a2a"]
