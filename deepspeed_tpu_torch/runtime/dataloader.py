"""Packing of documents into fixed-length rows. Port of ``pack_documents``
of ``deepspeed_tpu/runtime/dataloader.py`` (numpy in, numpy out: the engine
moves the batch to the device); the loaders wait for their slice."""

import numpy as np


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
