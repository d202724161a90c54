"""Paged KV cache: a global pool of fixed-size blocks + per-request block
tables (port of ``repro/serve/cache.py``, DESIGN.md §11).

The device side is the model's paged cache tree (one ``(num_blocks,
block_tokens, Kv, hd)`` pool per layer, built by ``model.init_paged_cache``
on the engine's device); the host side is this module: a free-list
:class:`BlockAllocator` and the ``(max_slots, max_blocks)`` int32 block
tables the paged decode step gathers through.  Valid positions land at the
same (position -> k/v) mapping through the table indirection as in the dense
ring cache, and masked positions get exactly zero attention weight; the two
paths still differ in summation order (ROADMAP queue 3), so they are held to
each other within a tolerance.

Block 0 is the reserved null/trash block: it is never allocated, inactive
batch slots keep all-zero table rows that scatter their writes there, and any
unused table-tail entries gather it — always beyond the per-request validity
mask, so its (finite) garbage is weighted exactly 0.

``BLOCK_TOKENS`` is the default block size, the value of the reference's
``DEFAULT_BLOCK_TOKENS`` (a TPU layout cap there, owned by its module), so
both packages allocate the same block tables for the same request trace.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

# Tokens per KV block: small enough that short prompts waste <1 block per
# request, large enough that the gather's block count stays modest at
# max_seq_len ~ few hundred.
BLOCK_TOKENS = 16


class OutOfBlocks(RuntimeError):
    """The pool cannot cover an allocation; admission control should have
    prevented the request from entering the batch."""


class BlockAllocator:
    """Host-side free list over the global block pool.

    Block 0 is reserved (the null/trash block) and is never handed out;
    :meth:`free` refuses to take it back.  Allocation order is LIFO over a
    deterministic initial order, so identical request traces produce
    identical block tables — what makes the paged-vs-dense equivalence
    tests reproducible.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is reserved), "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(
                f"requested {n} blocks, {len(self._free)} free "
                f"(pool size {self.num_blocks})")
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"cannot free block {b} (0 is reserved, "
                                 f"pool size {self.num_blocks})")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)


class PagedKVCache:
    """The serving engine's cache façade: device pool + host block tables.

    ``max_slots`` is the engine's concurrent-request capacity — one table
    row per slot.  ``num_blocks`` defaults to exactly covering every slot at
    ``max_seq_len`` (+ the reserved block 0), i.e. no oversubscription; pass
    a smaller pool to exercise admission control.  The pools live on
    ``device``.
    """

    def __init__(self, model, *, max_slots: int, max_seq_len: int,
                 block_tokens: int = BLOCK_TOKENS,
                 num_blocks: Optional[int] = None, replicas: int = 1,
                 device=None):
        self.block_tokens = block_tokens
        self.max_blocks = -(-max_seq_len // block_tokens)
        if num_blocks is None:
            num_blocks = 1 + max_slots * self.max_blocks
        self.num_blocks = num_blocks
        if replicas > 1:
            # Replicated robust decode: each replica attends over its own
            # pool (its params differ, so its k/v differ); the block tables
            # are shared — one logical allocation per request.  A tuple of
            # independent pools, matching make_replicas' tuple layout.
            self.pool = tuple(model.init_paged_cache(num_blocks,
                                                     block_tokens, device)
                              for _ in range(replicas))
        else:
            self.pool = model.init_paged_cache(num_blocks, block_tokens,
                                               device)
        self.device = device
        self.allocator = BlockAllocator(num_blocks)
        self.tables = np.zeros((max_slots, self.max_blocks), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(max_slots)]

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_tokens)

    def can_cover(self, tokens: int) -> bool:
        """Admission-control check: can a fresh request of ``tokens`` total
        length (prompt + max new tokens) be covered right now?"""
        return self.allocator.free_blocks >= self.blocks_for(tokens)

    def ensure(self, slot: int, tokens: int) -> None:
        """Grow ``slot``'s table to cover ``tokens`` positions (no-op when
        already covered).  Raises :class:`OutOfBlocks` when the pool can't."""
        need = self.blocks_for(tokens) - len(self._owned[slot])
        if need <= 0:
            return
        if self.blocks_for(tokens) > self.max_blocks:
            raise OutOfBlocks(
                f"request needs {self.blocks_for(tokens)} blocks but tables "
                f"hold max_blocks={self.max_blocks} (raise max_seq_len)")
        blocks = self.allocator.alloc(need)
        start = len(self._owned[slot])
        self._owned[slot].extend(blocks)
        self.tables[slot, start:start + need] = blocks

    def release(self, slot: int) -> None:
        """Free every block a finished request owned; the slot's table row
        returns to all-zeros (the null block) for the next occupant."""
        if self._owned[slot]:
            self.allocator.free(self._owned[slot])
            self._owned[slot] = []
        self.tables[slot, :] = 0

    def owned_blocks(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def device_tables(self) -> torch.Tensor:
        """The full (max_slots, max_blocks) table as a tensor on the pool's
        device — the decode step's gather operand (fixed shape every step)."""
        return torch.as_tensor(self.tables, device=self.device)
