"""Data loading: the loaders and document packing.

Port of ``deepspeed_tpu/runtime/dataloader.py``. :class:`DeepSpeedDataLoader`
batches an indexable dataset into stacked numpy arrays in the JAX
package's order (its shuffle is ``np.random.default_rng(seed)``'s, so the
two packages draw the same batches), :class:`RepeatingLoader` restarts an
exhausted loader, and :class:`PrefetchLoader` places batch N+1 on the card
while step N runs. ``pack_documents`` packs documents into rows (numpy in,
numpy out), ``zigzag_batch`` lays a next-token batch out for the zigzag
ring layout. The engine moves a batch to its device when a step starts,
and passes tensors already there through untouched.
"""

import collections
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.tree import tree_leaves, tree_map


class DeepSpeedDataLoader:
    """Batches an indexable dataset of dicts, tuples or arrays into
    stacked numpy arrays (``collate_fn`` overrides the stacking). With
    ``shuffle`` every pass draws a new order from one
    ``np.random.default_rng(seed)``; ``drop_last`` drops a short last
    batch."""

    def __init__(self, dataset: Sequence, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.len = len(dataset) // batch_size if drop_last else \
            (len(dataset) + batch_size - 1) // batch_size

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator[Any]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(self.len):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(j)] for j in idx])


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([it[i] for it in items])
                           for i in range(len(first)))
    return np.stack(items)


class RepeatingLoader:
    """Wraps an iterable and restarts it when it is exhausted."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class PrefetchLoader:
    """Places the next ``depth`` batches (dicts of arrays) on the engine's
    device ahead of the step that consumes them.

    On the card each batch is copied into pinned host memory and from
    there to the card on a side CUDA stream, so the copy of batch N+1
    runs while step N computes; the consuming stream waits on the copy's
    event before it reads the batch. On the host placement is nothing to
    overlap: the batches pass through as the loader yields them, and the
    engine converts them when a step starts.

    Usage::

        for batch in PrefetchLoader(loader, engine):
            engine.train_batch(batch)
    """

    def __init__(self, loader: Iterable, engine, depth: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.loader = loader
        self.engine = engine
        self.depth = depth

    def __iter__(self):
        device = self.engine.device
        if device.type != "cuda":
            yield from self.loader
            return
        stream = torch.cuda.Stream(device)
        queue = collections.deque()

        def place(batch):
            host = tree_map(lambda x: torch.as_tensor(x).pin_memory(), batch)
            with torch.cuda.stream(stream):
                dev = tree_map(lambda t: t.to(device, non_blocking=True),
                               host)
                done = torch.cuda.Event()
                done.record(stream)
            return dev, done

        it = iter(self.loader)
        for batch in it:
            queue.append(place(batch))
            if len(queue) == self.depth:
                break
        while queue:
            nxt = next(it, None)
            if nxt is not None:
                queue.append(place(nxt))
            dev, done = queue.popleft()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in tree_leaves(dev):
                # allocated on the side stream, freed after the consumer's
                # use: the allocator must wait for the consumer's stream
                t.record_stream(consumer)
            yield dev


def pack_documents(docs, seq_len: int, pad_token: int = 0):
    """Greedy first-fit packing of token sequences into fixed-length rows.

    Produces the packed-batch dict the GPT loss understands:
    ``{"tokens", "segment_ids", "positions", "loss_mask"}``: attention
    stays block-diagonal per document (the flash kernels' segment ids),
    positions restart at each document, and the loss mask zeroes both
    padding and each document's last token (whose next-token target would
    cross into the following document).

    docs: iterable of 1-D int sequences (at least 2 tokens each; longer
    than seq_len gets split). Returns numpy arrays with leading dimension
    the number of packed rows.
    """
    rows = []          # all rows: list of [(doc, len), ...]
    open_rows = []     # [used, row] candidates with remaining space
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        while len(doc) > seq_len:
            head, doc = doc[:seq_len], doc[seq_len:]
            rows.append([(head, len(head))])   # full: never a candidate
            if len(doc) < 2:
                break
        if len(doc) < 2:
            continue
        for slot in open_rows:
            if slot[0] + len(doc) <= seq_len:
                slot[1].append((doc, len(doc)))
                slot[0] += len(doc)
                if slot[0] > seq_len - 2:      # nothing (len >= 2) fits now
                    open_rows.remove(slot)
                break
        else:
            row = [(doc, len(doc))]
            rows.append(row)
            if len(doc) <= seq_len - 2:
                open_rows.append([len(doc), row])

    n = len(rows)
    tokens = np.full((n, seq_len), pad_token, np.int32)
    segs = np.full((n, seq_len), -1, np.int32)   # -1 = padding segment
    poss = np.zeros((n, seq_len), np.int32)
    mask = np.zeros((n, seq_len - 1), np.float32)
    for i, row in enumerate(rows):
        off = 0
        for sid, (doc, ln) in enumerate(row):
            tokens[i, off:off + ln] = doc
            segs[i, off:off + ln] = sid
            poss[i, off:off + ln] = np.arange(ln)
            # predictable targets: positions off..off+ln-2, within the doc
            mask[i, off:off + ln - 1] = 1.0
            off += ln
    return {"tokens": tokens, "segment_ids": segs, "positions": poss,
            "loss_mask": mask}


def zigzag_batch(batch, n_seq: int):
    """A next-token batch laid out for the zigzag ring layout
    (``ops/attention/ring.py zigzag_perm``): the (inputs, targets) pair is
    derived first, then the same permutation is applied to inputs,
    targets and every per-token array (permuting the raw [B, S+1] row
    would not commute with the next-token slice).

    batch: {"tokens": [B, S+1]}, optionally "segment_ids"/"positions"
    [B, S+1] and "loss_mask" [B, S] (``pack_documents``'s layout). Returns
    the explicit-targets dict the GPT loss takes, numpy arrays, with
    "positions" always present (the positional encodings follow their
    tokens; for an unpacked batch they are the permutation itself)."""
    from deepspeed_tpu_torch.ops.attention.ring import zigzag_perm
    toks = np.asarray(batch["tokens"])
    B, S = toks.shape[0], toks.shape[1] - 1
    p = zigzag_perm(S, n_seq)
    out = {"tokens": toks[:, :-1][:, p], "targets": toks[:, 1:][:, p]}
    poss = batch.get("positions")
    out["positions"] = (np.asarray(poss)[:, :-1][:, p]
                        if poss is not None
                        else np.broadcast_to(p.astype(np.int32), (B, S)))
    segs = batch.get("segment_ids")
    if segs is not None:
        out["segment_ids"] = np.asarray(segs)[:, :-1][:, p]
    mask = batch.get("loss_mask")
    if mask is not None:
        if mask.shape[-1] != S:
            raise ValueError(f"loss_mask width {mask.shape[-1]} != {S}")
        out["loss_mask"] = np.asarray(mask)[:, p]
    return out
