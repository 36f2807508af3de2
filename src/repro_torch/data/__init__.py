from repro_torch.data.shards import (  # noqa
    decode_shard, encode_shard, TokenShardWriter,
)
from repro_torch.data.packing import merge_shards_fn, pack_tokens  # noqa
