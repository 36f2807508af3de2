"""Token shards: the data files of the training corpus LST.

A shard is an int32 token array padded to CHUNK_TOKENS (1024) alignment —
the alignment contract that turns compaction into the chunk-permutation DMA
kernel (repro_torch.kernels.compact_pack). The header records the true
(pre-padding) length.

Writers model the paper's §2 causes of small files:
  * TrickleWriter — CDC/streaming ingestion: many small appends;
  * BulkWriter   — well-tuned batch ingestion: near-target files.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.kernels.compact_pack.compact_pack import CHUNK_TOKENS
from repro_torch.lst.files import DataFile
from repro_torch.lst.table import LogStructuredTable

_MAGIC = b"TOKS"


def zipf_tokens(rng: np.random.RandomState, vocab: int, n: int) -> np.ndarray:
    """Zipf-distributed synthetic tokens (learnable unigram structure; a
    uniform stream would already sit at the entropy floor ln(V))."""
    vals = rng.zipf(1.5, size=n)
    return ((vals - 1) % vocab).astype(np.int32)


def encode_shard(tokens: np.ndarray) -> bytes:
    """The shard's bytes; recorded as a ``shards.encode`` span
    (:mod:`repro_torch.obs`, when on)."""
    with obs.span("shards.encode"):
        tokens = np.asarray(tokens, dtype=np.int32)
        n = tokens.shape[0]
        pad = (-n) % CHUNK_TOKENS
        padded = np.concatenate([tokens, np.zeros(pad, np.int32)]) \
            if pad else tokens
        return _MAGIC + struct.pack("<q", n) + padded.tobytes()


def decode_shard(raw: bytes) -> np.ndarray:
    assert raw[:4] == _MAGIC, "not a token shard"
    (n,) = struct.unpack("<q", raw[4:12])
    arr = np.frombuffer(raw[12:], dtype=np.int32)
    return arr[:n]


def decode_shard_padded(raw: bytes) -> np.ndarray:
    """Full chunk-aligned payload including padding (kernel input)."""
    assert raw[:4] == _MAGIC
    return np.frombuffer(raw[12:], dtype=np.int32)


@dataclasses.dataclass
class TokenShardWriter:
    table: LogStructuredTable
    vocab: int = 32000
    seed: int = 0
    _counter: int = 0

    def _write(self, tokens: np.ndarray, partition: Optional[str]) -> DataFile:
        self._counter += 1
        path = f"{self.table.table_id}/data/shard-{self._counter:08d}.toks"
        raw = encode_shard(tokens)
        self.table.store.put(path, raw)
        return DataFile(path=path, size_bytes=len(raw),
                        num_rows=int(tokens.shape[0]), partition=partition,
                        created_at=self.table.now_fn())

    def trickle_append(self, n_files: int, tokens_per_file: int,
                       partition: Optional[str] = None,
                       rng: Optional[np.random.RandomState] = None
                       ) -> List[DataFile]:
        """CDC-style: many small shards in one commit."""
        rng = rng or np.random.RandomState(self.seed + self._counter)
        files = [self._write(zipf_tokens(rng, self.vocab, tokens_per_file),
                             partition) for _ in range(n_files)]
        self.table.append(files)
        return files

    def bulk_append(self, total_tokens: int, target_file_tokens: int,
                    partition: Optional[str] = None,
                    rng: Optional[np.random.RandomState] = None
                    ) -> List[DataFile]:
        rng = rng or np.random.RandomState(self.seed + self._counter)
        files = []
        left = total_tokens
        while left > 0:
            n = min(target_file_tokens, left)
            files.append(self._write(zipf_tokens(rng, self.vocab, n),
                                     partition))
            left -= n
        self.table.append(files)
        return files
