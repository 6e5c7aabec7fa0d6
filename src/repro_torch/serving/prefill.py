"""Bucketed, multi-request batch prefill (PyTorch counterpart of
``repro.serving.prefill``).

Each engine step pads its suffix chunks to one of a few power-of-two bucket
lengths and runs every admitted row in ONE row-masked ``extend`` call, with
per-row ``adapter_ids`` batching heterogeneous LoRAs through ``fused_sgmv``.
Pad positions neither write the cache nor advance ``len``, and each row's
next-token logits come from its own last real position.

PyTorch runs eagerly, so there is no per-bucket compile; ``compile_count``
counts the distinct buckets dispatched, which keeps the meaning of
``ServingReport.prefill_compiles`` (the number of distinct shapes a run
needed, at most ``len(buckets)``).

Adapter-id contract: ``adapter_ids`` is per ROW per dispatch. A NEGATIVE id
marks a base-model row (the LoRA delta is masked to zero), which is how the
engine computes a request's declared adapter-independent shared prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch


def make_buckets(min_bucket: int, chunk: int) -> tuple[int, ...]:
    """Power-of-two bucket lengths from ``min_bucket`` up to ``chunk``
    (``chunk`` itself is always the last bucket)."""
    if min_bucket < 1 or chunk < 1:
        raise ValueError("min_bucket and chunk must be >= 1")
    if min_bucket > chunk:
        min_bucket = chunk
    buckets = []
    b = max(1, min_bucket)
    while b < chunk:
        buckets.append(b)
        b *= 2
    buckets.append(chunk)
    return tuple(sorted(set(buckets)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (n <= 0 maps to the smallest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"suffix chunk of {n} tokens exceeds the largest "
                     f"bucket {buckets[-1]} — chunk before bucketing")


def assemble_batch(
    n_slots: int,
    bucket: int,
    prefill_chunks: Mapping[int, Sequence[int]],
    decode_tokens: Mapping[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble one (possibly mixed) row-masked batch.

    ``prefill_chunks`` maps slot -> that row's suffix token slice for this
    step; ``decode_tokens`` maps slot -> the row's last generated token —
    decode rows ride in the same batch as 1-token rows (``true_lens == 1``),
    which is what makes Sarathi-style mixed scheduling a pure batch-assembly
    concern: the row-masked ``extend`` already handles heterogeneous per-row
    lengths. Returns (tokens (B, bucket) int32, true_lens (B,), row_mask (B,)).
    """
    tokens = np.zeros((n_slots, bucket), np.int32)
    true_lens = np.zeros((n_slots,), np.int32)
    row_mask = np.zeros((n_slots,), bool)
    for slot, toks in prefill_chunks.items():
        c = len(toks)
        if c > bucket:
            raise ValueError(f"chunk of {c} tokens exceeds bucket {bucket}")
        tokens[slot, :c] = toks
        true_lens[slot] = c
        row_mask[slot] = True
    for slot, tok in (decode_tokens or {}).items():
        if row_mask[slot]:
            raise ValueError(f"slot {slot} is both prefilling and decoding")
        tokens[slot, 0] = tok
        true_lens[slot] = 1
        row_mask[slot] = True
    return tokens, true_lens, row_mask


@dataclasses.dataclass
class PrefillStats:
    calls: int = 0          # batched prefill dispatches
    rows: int = 0           # request-chunks processed across all calls
    tokens: int = 0         # real (unpadded) suffix tokens processed
    pad_tokens: int = 0     # bucket-padding overhead tokens

    @property
    def mean_batch(self) -> float:
        return self.rows / self.calls if self.calls else 0.0


class BatchPrefill:
    """Row-masked ``model.extend`` over bucket-padded chunks.

    One call serves every (suffix-length, active-row-set) combination:
    tokens are padded to the bucket, rows not prefilling this step are
    masked out and keep their cache contents, and only each row's last real
    position is unembedded (gathered before the vocabulary projection, so a
    256-token bucket never builds (B, 256, vocab) logits).
    """

    def __init__(self, model, buckets: Sequence[int]):
        self.model = model
        self.buckets = tuple(sorted(buckets))
        self._dispatched: set[int] = set()
        self.stats = PrefillStats()

    # ------------------------------------------------------------- bucketing
    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    @property
    def compile_count(self) -> int:
        """Distinct buckets dispatched so far (<= ``len(buckets)``)."""
        return len(self._dispatched)

    # ------------------------------------------------------------- execution
    def __call__(self, params, lora, cache, tokens, start, true_lens,
                 row_mask, adapter_ids, stat_mask=None):
        """Run one coalesced (possibly mixed) chunk.

        tokens: (B, bucket) int32 — pad with any token id beyond true_lens
        start: (B,) current cache lengths; true_lens: (B,) real chunk tokens
        (0 for rows riding along); row_mask: (B,) bool participating rows.
        All four are host-side (numpy or CPU tensors). ``stat_mask`` (B,)
        bool restricts PrefillStats accounting to the actual prefill chunk
        rows (mixed batches carry decode rider rows). Defaults to
        ``row_mask``. Updates ``cache`` in place and returns per-row
        last-real-token logits (B, V) and the cache.
        """
        bucket = int(tokens.shape[1])
        if bucket not in self.buckets:
            raise ValueError(f"tokens padded to {bucket}, not a "
                             f"configured bucket {self.buckets}")
        self._dispatched.add(bucket)
        true_lens = np.asarray(true_lens)
        sm = row_mask if stat_mask is None else stat_mask
        sm = np.asarray(sm)
        real = int(true_lens[sm].sum())
        nrows = int(sm.sum())
        self.stats.calls += 1
        self.stats.rows += nrows
        self.stats.tokens += real
        self.stats.pad_tokens += nrows * bucket - real
        # each row's next-token logits live at its own last real position
        last = np.maximum(true_lens.astype(np.int64) - 1, 0)[:, None]
        logits, cache = self.model.extend(
            params, cache, torch.as_tensor(tokens), start, lora=lora,
            adapter_ids=adapter_ids, true_lens=torch.as_tensor(true_lens),
            keep_rows=torch.as_tensor(np.asarray(row_mask)),
            logit_positions=torch.as_tensor(last))
        return logits[:, 0, :], cache
