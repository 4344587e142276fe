"""The host side of the tensor-core K5 (``blocksparse.KernelPlan``): the
union table of each 64-row group, the work list that splits long unions,
and the split-and-combine arithmetic, checked on the CPU.

The union table must say, for every (head, query block), exactly the set
of active key blocks that ``make_lut`` lists; the work list must cover
every union slot exactly once. ``_union_walk`` is the kernel's walk in
plain torch (steps of ``BS_KT`` union keys through the online softmax,
p = 0 on masked keys, pieces merged in piece order) and must equal the
gather version in float32.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse

# layout families: (config class, its keyword arguments)
FAMILIES = {
    "fixed": (sa.FixedSparsityConfig, dict(num_local_blocks=4)),
    "fixed-uni": (sa.FixedSparsityConfig, dict(num_local_blocks=4,
                                               attention="unidirectional")),
    "bigbird": (sa.BigBirdSparsityConfig, dict(num_random_blocks=2)),
    "bslongformer": (sa.BSLongformerSparsityConfig,
                     dict(global_block_indices=[0, 5])),
    "variable": (sa.VariableSparsityConfig, dict(
        num_random_blocks=1, local_window_blocks=[2, 4],
        global_block_indices=[1], attention="unidirectional",
        different_layout_per_head=True)),
    "dense": (sa.DenseSparsityConfig, {}),
}
BS_KT = 64          # keys per step of the kernel's walk (blocksparse_fwd.cu)


def _layout(family, block, S, H=2):
    cls, kw = FAMILIES[family]
    config = cls(num_heads=H, block=block, **kw)
    return config.make_layout(S), \
        getattr(config, "attention", "") == "unidirectional"


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_union_table_and_work_list(family, block):
    S = 1024 if block < 128 else 2048
    layout, _ = _layout(family, block, S)
    lut, valid = sa.make_lut(layout)
    plan = blocksparse.block_table(lut, valid).plan(block)
    H, nb, _ = lut.shape
    G = -(-S // 64)
    assert plan.ulut.shape[:2] == plan.umask.shape[:2] == (H, G)
    assert plan.unnz.shape == (H, G)
    for h in range(H):
        for g in range(G):
            n = plan.unnz[h, g]
            u = plan.ulut[h, g, :n]
            assert np.all(np.diff(u) > 0)         # ascending, no repeats
            assert not plan.ulut[h, g, n:].any()
            assert not plan.umask[h, g, n:].any()
            members = set()
            for w in range(4):
                qb = (g * 64 + 16 * w) // block
                used = set(u[(plan.umask[h, g, :n] >> w) & 1 == 1].tolist())
                want = set(lut[h, qb][valid[h, qb]].tolist())
                assert used == want, (h, g, w)
                members |= want
            assert set(u.tolist()) == members
    # the work list: every union slot of every group exactly once, pieces
    # in order; split groups alone have partial indices, numbered by the
    # combine table
    med = max(1, int(np.ceil(np.median(plan.unnz))))
    seen = {}
    for h, g, first, end, part in plan.work.tolist():
        seen.setdefault((h, g), []).append((first, end, part))
    assert sorted(seen) == [(h, g) for h in range(H) for g in range(G)]
    assert [tuple(r[:2]) for r in plan.work.tolist()] == sorted(
        tuple(r[:2]) for r in plan.work.tolist())
    split = {(h, g): (p0, n) for h, g, p0, n in plan.combine.tolist()}
    n_part = 0
    for (h, g), pieces in seen.items():
        n = plan.unnz[h, g]
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        if len(pieces) == 1 and (h, g) not in split:
            assert pieces[0][2] == -1 and n <= 2 * med
            continue
        assert n > 2 * med and split[h, g] == (pieces[0][2], len(pieces))
        assert [p[2] for p in pieces] == list(
            range(pieces[0][2], pieces[0][2] + len(pieces)))
        assert all(0 < e - f <= med for f, e, _ in pieces)
        n_part += len(pieces)
    assert plan.n_part == n_part == sum(n for _, n in split.values())


def _union_walk(q, k, v, plan, block, causal, scale):
    """The tensor-core K5 in plain torch: per work item, the piece's union
    keys in steps of ``BS_KT`` through the online softmax (p = 0 where a
    warp's query block does not use the slot, on the causal diagonal and
    past the piece; p rounded to v's dtype before P V), then each split
    group's pieces merged in piece order."""
    B, S, H, D = q.shape
    o = torch.zeros_like(q)
    parts = {}
    rows_of = torch.arange(64)
    for h, g, first, end, part in plan.work.tolist():
        rows = g * 64 + rows_of
        live = rows < S
        rows = rows[live]
        qh = q[:, rows, h].float()                      # [B, r, D]
        m = torch.full((B, len(rows)), -1e30)
        l = torch.zeros((B, len(rows)))
        acc = torch.zeros((B, len(rows), D))
        slots = plan.ulut[h, g]
        bits = plan.umask[h, g]
        keys = torch.tensor([slots[o // block] * block + o % block
                             for o in range(first * block, end * block)],
                            dtype=torch.long)
        kbits = torch.tensor([bits[o // block]
                              for o in range(first * block, end * block)],
                             dtype=torch.long)
        warp = (rows - g * 64) // 16
        for s0 in range(0, len(keys), BS_KT):
            kk, kb = keys[s0:s0 + BS_KT], kbits[s0:s0 + BS_KT]
            x = torch.einsum("brd,bkd->brk", qh, k[:, kk, h].float()) * scale
            ok = ((kb[None, :] >> warp[:, None]) & 1) == 1
            if causal:
                ok &= kk[None, :] <= rows[:, None]
            x = torch.where(ok[None], x, -1e30)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.where(ok[None], torch.exp(x - mx[..., None]), 0.0)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "brk,bkd->brd", p.to(v.dtype).float(), v[:, kk, h].float())
            m = mx
        if part < 0:
            o[:, rows, h] = (acc / torch.where(l == 0, 1.0, l)[..., None]
                             ).to(q.dtype)
        else:
            parts[part] = (m, l, acc, rows)
    for h, g, p0, n in plan.combine.tolist():
        ms, ls, accs, rows = zip(*(parts[p0 + i] for i in range(n)))
        mx = torch.stack(ms).amax(0)
        wgt = [torch.exp(mi - mx) for mi in ms]
        den = sum(w * li for w, li in zip(wgt, ls))
        num = sum(w[..., None] * a for w, a in zip(wgt, accs))
        o[:, rows[0], h] = (num / torch.where(den == 0, 1.0, den)[..., None]
                            ).to(q.dtype)
    return o


@pytest.mark.parametrize("family,block,causal", [
    ("bigbird", 16, False), ("bigbird", 16, True),
    ("bslongformer", 32, False), ("fixed-uni", 128, True)])
def test_split_and_combine_matches_gather(family, block, causal):
    """The walk over union pieces, merged in piece order, against the
    gather version in float32; the BigBird and BSLongformer layouts have
    global rows whose unions are split."""
    S, H, D = 1024, 2, 40
    layout, _ = _layout(family, block, S, H)
    lut, valid = sa.make_lut(layout)
    plan = blocksparse.block_table(lut, valid).plan(block)
    if family != "fixed-uni":
        assert plan.split_groups > 0
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, H, D),
                                                    np.float32))
               for _ in range(3))
    scale = D ** -0.5
    got = _union_walk(q, k, v, plan, block, causal, scale)
    want = sa.blocksparse_attention_gather(q, k, v, lut, valid, block,
                                           causal=causal, scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fully_masked_causal_rows_walk_to_zero():
    """The causal layout whose first query block sees only a block above
    the diagonal: its rows end the walk with l = 0 and are exact zeros."""
    nb, block, D = 4, 32, 16
    layout = np.zeros((1, nb, nb), np.int64)
    layout[0, 0, 2] = 1
    layout[0, 1:, 0] = 1
    np.fill_diagonal(layout[0][1:, 1:], 1)
    lut, valid = sa.make_lut(layout)
    plan = blocksparse.block_table(lut, valid).plan(block)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, nb * block, 1, D),
                                                    np.float32))
               for _ in range(3))
    got = _union_walk(q, k, v, plan, block, True, D ** -0.5)
    assert got[0, :block].abs().max().item() == 0.0
    want = sa.blocksparse_attention_gather(q, k, v, lut, valid, block,
                                           causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
