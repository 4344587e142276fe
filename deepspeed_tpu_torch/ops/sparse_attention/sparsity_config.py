"""Block-sparse attention sparsity layouts.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (numpy only, so the port keeps it instead of
importing the JAX package). The classes, their checks and the seeded numpy
RNG of the random patterns (``seed=0``) are the JAX package's, so every
layout is bit-identical to its own (the CPU tests hold this).

A layout is a numpy array of shape [num_heads, num_blocks, num_blocks]
with 1 where a query block attends to a key block. It is host-side
metadata: ``blocksparse.make_lut`` compiles it into the table of active
key blocks per (head, query-block row) that the kernel walks.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base class holding properties shared by all block-sparse patterns."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def propagate_first_head(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks active — for comparison/debug (ref :63)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _check_attention(attention: str, horizontal_global_attention: bool):
    if attention not in ("unidirectional", "bidirectional"):
        raise NotImplementedError(
            "only uni/bi-directional attention is supported")
    if attention != "bidirectional" and horizontal_global_attention:
        raise ValueError(
            "horizontal global attention requires bidirectional attention")


class FixedSparsityConfig(SparsityConfig):
    """'Fixed' pattern from Sparse Transformers (Child et al. 2019):
    local windows plus fixed global representative blocks (ref :94).
    """

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks ({num_local_blocks}) must be divisible by "
                f"num_global_blocks ({num_global_blocks})")
        _check_attention(attention, horizontal_global_attention)
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                "num_different_global_patterns cannot exceed "
                "num_local_blocks // num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        rows = np.arange(nb)[:, None]
        cols = np.arange(nb)[None, :]
        # local windows: same window, and col<=row if unidirectional
        local = (rows // L) == (cols // L)
        if self.attention == "unidirectional":
            local &= cols <= rows
        for h in range(self.num_layout_heads):
            layout[h][local] = 1
            # global representative blocks: last G blocks of each window,
            # shifted back by the head's pattern index
            first = L - (1 + h % self.num_different_global_patterns) * G
            end = nb - nb % L
            starts = list(range(first, end, L))
            if end < nb:  # short trailing window
                starts.append(min(end + first, nb - G))
            for i in starts:
                first_row = 0 if self.attention == "bidirectional" else i
                layout[h, first_row:, i:i + G] = 1
                if self.horizontal_global_attention:
                    layout[h, i:i + G, :] = 1
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed-pattern generalization: random blocks + per-window sizes +
    user-chosen global block indices/ranges (ref :243)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        local_window_blocks = local_window_blocks or [4]
        global_block_indices = (global_block_indices
                                if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global block start/end index lists must be same length")
            for s, e in zip(global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        _check_attention(attention, horizontal_global_attention)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def _set_random(self, h: int, layout: np.ndarray, rng) -> None:
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks ({self.num_random_blocks}) must be <= "
                f"number of block rows ({nb})")
        for row in range(nb):
            cols = rng.choice(nb, size=self.num_random_blocks, replace=False)
            layout[h, row, cols] = 1

    def _set_local(self, h: int, layout: np.ndarray) -> None:
        nb = layout.shape[1]
        # explicit windows first, then repeat the last size for the remainder
        start, idx = 0, 0
        while start < nb:
            size = self.local_window_blocks[
                min(idx, len(self.local_window_blocks) - 1)]
            idx += 1
            if size <= 0:
                raise ValueError("local window sizes must be positive")
            end = min(start + size, nb)
            blk = layout[h, start:end, start:end]
            if self.attention == "unidirectional":
                blk |= np.tril(np.ones_like(blk))
            else:
                blk[:] = 1
            start += size

    def _set_global(self, h: int, layout: np.ndarray) -> None:
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            if s >= nb:
                continue
            e = min(e, nb)
            first_row = 0 if self.attention == "bidirectional" else s
            layout[h, first_row:, s:e] = 1
            if self.horizontal_global_attention:
                layout[h, s:e, :] = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            self._set_random(h, layout, rng)
            self._set_local(h, layout)
            self._set_global(h, layout)
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (Zaheer et al. 2020): random + sliding window + global
    first blocks (ITC mode) (ref :421)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError("num_random_blocks must be <= block rows")
        if nb < self.num_sliding_window_blocks:
            raise ValueError("num_sliding_window_blocks must be <= block rows")
        if nb < self.num_global_blocks:
            raise ValueError("num_global_blocks must be <= block rows")
        rng = np.random.default_rng(self.seed)
        rows = np.arange(nb)[:, None]
        cols = np.arange(nb)[None, :]
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(rows - cols) <= w
        for h in range(self.num_layout_heads):
            for row in range(nb):
                rnd = rng.choice(nb, size=self.num_random_blocks,
                                 replace=False)
                layout[h, row, rnd] = 1
            layout[h][sliding] = 1
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (Beltagy et al. 2020): sliding window +
    global blocks at chosen indices (ref :544)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        global_block_indices = (global_block_indices
                                if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global block start/end index lists must be same length")
            for s, e in zip(global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError("num_sliding_window_blocks must be <= block rows")
        rows = np.arange(nb)[:, None]
        cols = np.arange(nb)[None, :]
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(rows - cols) <= w
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for h in range(self.num_layout_heads):
            layout[h][sliding] = 1
            for s, e in spans:
                if s >= nb:
                    continue
                e = min(e, nb)
                layout[h, s:e, :] = 1
                layout[h, :, s:e] = 1
        return self.propagate_first_head(layout)
