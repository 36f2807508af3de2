from repro_torch.kernels.paged_attn.ops import paged_attention, tuned_page_size
from repro_torch.kernels.paged_attn.ref import (
    gather_pages,
    pack_pages,
    paged_attention_ref,
)

__all__ = ["paged_attention", "paged_attention_ref", "pack_pages",
           "gather_pages", "tuned_page_size"]
