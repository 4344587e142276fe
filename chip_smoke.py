#!/usr/bin/env python3
"""Chip smoke of the deepspeed_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_CHECKOUT

Run from the root of a checkout. ``--ab`` times only the kernels at the
main paths' shapes (K1-fwd, K2, K3 and K3-int8 at the llama-7b decode
shape, K4 at M = 8, 1 and 256 with the two layer sums, K5), on the kernels
of another checkout (A) and of this one (B) in turns, A B B A, through
this script's cases and timers on both sides, and prints both sides'
times per row. Without arguments, each
phase prints one JSON line:

1. ``env``: the card's name and power limit, torch and CUDA versions, the
   nvcc build of every kernel (seconds; registers, shared memory and
   spills from ``-Xptxas -v``).
2. ``kernel``: each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes and a few variants (max-abs error, and
   the error relative to the output's own scale: per query row for
   K1-fwd, per slot for K3, so that rows or slots with small outputs
   are held as tightly as the rest), with its time
   (CUDA events over many launches after warm-up), the plain version's
   time, the time of one PyTorch library call computing the same function
   (``scaled_dot_product_attention``, and its backward through autograd
   for the backward kernels; ``torch.matmul`` on the weight already
   dequantized to bf16 for K4; SDPA with a boolean mask for K5; a
   yardstick only, never called by the port)
   and the least time the card could take (bound). K1-fwd, K2 and K5 rows
   also name the design that ran (``mma``: tensor cores, bf16 and fp16;
   ``fma``: CUDA cores, float32), the achieved TFLOP/s and ``vs_library``
   (kernel ms / library ms); a call that may be shorter than ~50 us is
   timed by CUDA graph replay (``device_ms``), the kernel and SDPA alike,
   and the row says which (``timed_by``): K3's rows (kernel and SDPA)
   and K4's (over rotating weights) are always graph replay. K5's
   tensor-core rows also give the work list
   (CTAs per batch row, row groups whose union was split over CTAs). The
   env line fails the run if ptxas reports a spill in the tensor-core
   K2-dq or K5 at head dims 64 and 128, or in any instance of K3's split
   and combine kernels or K4's tensor-core kernels; it lists the kernels
   where ptxas serialized ``wgmma`` (``wgmma_serialized``). K2-dq and
   K2-dkv are
   held against the plain backward formulas on the forward kernel's own
   ``o`` and ``lse``, each gradient by its largest error and relative to
   each row's own scale, and two launches must give the same bits.
3. ``serve``: the main path at full width. llama-7b (32 layers, random
   bf16 weights from seed 0): ``generate`` on 4 prompts of 512 tokens,
   then a ``ServingEngine`` draining 16 seeded requests (prompts of 64 to
   1024 tokens, 64 new tokens each) through 8 slots with chunked prefill.
   Each of the two paths is driven with both launch counters set to 0
   just before it and read just after: ``generate`` must launch K1-fwd
   (its static prefill) and the serving drain must launch K3 (its
   decode steps; its paged prefill is plain PyTorch, as in the JAX
   package). Each served stream is compared with a solo ``generate``.
   ``trace``: a steady 8-slot decode step under ``torch.profiler``
   (device busy and idle share, top device kernels and host ops).
   ``agreement``: the same comparison for 4 of the requests with the
   float32 version of the same weights, where rounding cannot flip a
   near-tie the way bf16 does; every stream must agree in full.
   ``serve_int8``: the int8 serving path at full width: the same llama-7b
   weights through ``init_inference(dtype=torch.int8)`` (weight-only int8,
   bf16 activations), the same ``generate`` and the same 16 requests
   through a ``ServingEngine(kv_quant="int8")`` (int8 KV blocks with
   per-(block, kv head) scales). ``generate`` must launch K1-fwd and K4
   and neither K3 mode; the drain must launch K4 and K3-int8 and float K3
   never. Its greedy agreement with the same int8 weights served over a
   bf16 cache is reported; ``trace`` repeats for its decode step.
4. ``parity``: llama-7b width at 2 layers in float32, the same weights on
   the card and on the host: teacher-forced prefill and 8 decode steps
   through the paged path, and the static prefill, logits compared.
   ``parity_int8``: the same with int8 weights and int8 KV blocks (K4 and
   K3-int8 on the card, their plain versions on the host); the int8 pools
   are compared code by code as well.
5. ``train``: the training path at full width and depth. gpt2-1.5b (48
   layers, d_model 1600, random weights from seed 0) through
   ``deepspeed_tpu_torch.initialize`` and ``engine.train_batch``: bf16 with
   bf16 masters and moments (``bf16.memory_efficient``), AdamW, full
   activation checkpointing, the chunked loss, batch 16 of 1024 tokens, one
   warm-up and five timed steps; then fp32 masters with the selective
   policy and a warm-up schedule on batch 8 of documents packed by
   ``pack_documents``, five steps. Per step: ms, tokens/s, MFU against
   989 TFLOP/s, peak memory, the loss (finite, and lower at the last step than at the first on the
   repeated batch), and the launch counts of this path alone: K1-fwd,
   K2-dq and K2-dkv above zero, K3 zero, K1-fwd ``L * steps`` under the
   selective policy and ``2 * L * steps`` under the full one.
   ``train_trace``: one step under ``torch.profiler``.
   ``remat``: what the forward leaves allocated for the backward, and the
   peak memory of one step, without checkpointing and under the three
   policies (each strictly decreasing in that order), and their losses and
   gradient norms equal at 2 layers in float32.
   ``train_parity``: gpt2-1.5b width, 2 layers, float32, the same weights
   on the card (kernels) and on the host (plain versions): the loss and
   every gradient leaf of a plain and a packed batch, then two
   ``train_batch`` steps with each of AdamW, SGD (momentum 0.9, Nesterov)
   and Adagrad, parameters compared.
6. ``sparse``: the block-sparse attention path at bert-large's attention
   width (16 heads of 64, B = 4, S = 4096, bf16): a ``sparse_attention``
   config section (the default fixed layout, block 16) through
   ``DeepSpeedConfig``, ``build_sparsity_config`` and
   ``SparseSelfAttention``, a forward and backward through 24 calls, for
   bidirectional and then unidirectional attention, each pass with the
   launch counters at 0: K5 once per call (the backward recomputes
   through the gather version, as the JAX package's does). The K5
   ``kernel`` lines hold it against the gather version for every layout
   family, blocks 16 and 64, head dims 32 to 128, bf16 and float32, and
   time SDPA with the layout as a boolean mask beside it.
   ``bert``: BERT-large pretraining at full width and depth (24 layers,
   d_model 1024, random weights from seed 0), the JAX package's
   ``tools/bert_bench.py`` headline: seq 512, batch 32, bf16, AdamW, ZeRO
   stage 1, full checkpointing, the chunked MLM loss, NSP labels, token
   types and a quarter of the rows padded (K1-fwd and K2 run non-causal
   with the padding mask as their key mask); then LAMB, fp32 masters, the
   selective policy and dropout 0.1 (attention takes the masked softmax,
   no flash launch), batch 16, and one SQuAD step. Per run: ms per step,
   samples/s, MFU against 989 TFLOP/s, peak memory, the loss (finite, and
   falling on the repeated batch) and the launch counts. ``bert_trace``:
   one step of the first run under ``torch.profiler``. ``bert_parity``:
   bert-large width, 2 layers, float32, card vs host loss and every
   gradient leaf, unpadded and padded.
   ``bf16_parity``: gpt2-1.5b and bert-large width at 2 layers in bf16 on
   the card (the tensor-core designs) against float32 on the host, on the
   same bf16-rounded weights: the loss and every gradient leaf, each held
   to twice the host's own bf16 distance from float32 on that leaf plus
   0.01; the worst leaf and the worst attention leaf are reported.

7. ``resume``: gpt2-1.5b at full width and depth in the first ``train``
   configuration: four uninterrupted steps against two steps,
   ``save_checkpoint``, a fresh engine from other random weights,
   ``load_checkpoint`` and two more steps; the four losses and every
   parameter and moment leaf must be equal bit for bit. The checkpoint's
   bytes, the seconds and GB/s of the save (write, CRC32, fsync), of a
   CRC32 pass alone and of the load (validate, read). Then the resumed
   engine saves again (``latest`` moves to it), ``save_16bit_model``
   (read back bit for bit) and
   ``init_inference(config=, checkpoint=)``: ``generate`` (K1-fwd) on 4
   prompts of 256 tokens for 32 tokens and a serving drain of the same
   prompts (K3) must give the streams of the same weights handed over as
   ``(cfg, params)``. ``train_features``: gpt2-1.5b at full width and
   depth through ``initialize(training_data=)``, ``RepeatingLoader`` and
   ``PrefetchLoader``, six steps with a fixed_linear seqlen curriculum
   (lengths 568 to 816, off the 64 grid but one), progressive layer drop
   at theta 0.5, the CSV/JSONL monitor, the timers and the flops profiler
   at step 3. Per step: the length, ms, the kept layers (the step's draws
   replayed from the generator's state), and the launch counts, which
   must be K1-fwd twice and K2-dq and K2-dkv once per kept layer (full
   checkpointing), K3 none; the monitor, flushed every third step, must
   have one header and one row per step, and the profiler's report its
   MFU line and the analytic FLOPs of the layers that ran at step 3.
   ``host_sync``: gpt2-small, batch 8 of 512, runs of 20 free-running
   steps with the throughput meter reporting every 1000 steps against
   every step (a wait for the device at each), 10 pairs: ms per step.

The two lines before the last are the kernel summary and the card as
``nvidia-smi --query-gpu=name,power.limit`` reports it; the last line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
nonzero exit code and without that line. Without a CUDA card, or outside
a checkout of the repository, it exits nonzero at once.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # CUDA cores, no tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# a port kernel's name inside a mangled symbol (after its length digits)
KERNEL = r"(?<=\d)((?:flash|paged|i8mm|blocksparse)_\w*?_kernel)"
_TYPE_NAMES = {"__nv_bfloat16": "bf16", "__half": "f16", "f": "f32",
               "a": "int8"}
# a bool template argument that is true, by kernel family
_FLAGS = {"paged": "int8", "blocksparse": "causal", "flash": "segs"}


def template_args(s):
    """The template arguments of a mangled ``I...E`` list (``s`` starts
    after the ``I``): types as bf16/f16/f32/int8, integers as digits, a
    true bool as ``b1``, a repeated type (``S.._``) as the type before."""
    out, i = [], 0
    while i < len(s) and s[i] != "E":
        if s[i] == "L":
            j = s.index("E", i)
            out.append(("b" if s[i + 1] == "b" else "") + s[i + 2:j])
            i = j + 1
        elif s[i].isdigit():
            n = re.match(r"\d+", s[i:]).group()
            name = s[i + len(n):i + len(n) + int(n)]
            out.append(_TYPE_NAMES.get(name, name))
            i += len(n) + int(n)
        elif s[i] == "S":
            i = s.index("_", i) + 1
            out.append(out[-1] if out else "?")
        else:
            out.append(_TYPE_NAMES.get(s[i], s[i]))
            i += 1
    return out


def ptxas_summary(log):
    """{kernel template: {registers, smem_bytes, spill_bytes}}, and under
    ``"wgmma_serialized"`` the kernels ptxas says it serialized wgmma in."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            km = re.search(KERNEL + r"(I)?", name)
            if km:
                args = template_args(name[km.end():]) if km.group(2) else []
                family = km.group(1).split("_")[0]
                args = [_FLAGS[family] if a == "b1" else a for a in args
                        if a != "b0"]
                name = km.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
        m = re.search(r"wgmma.mma_async instructions are serialized.*"
                      r"function '(\w+)'", line)
        if m:
            km = re.search(KERNEL + r"I", m.group(1))
            out.setdefault("wgmma_serialized", []).append(
                km.group(1) + "<" + ",".join(template_args(
                    m.group(1)[km.end():])) + ">" if km else m.group(1))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters):
    """Mean ms of ``fn()`` over ``iters`` launches after a warm-up, by CUDA
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


_CAPTURE_STREAM = []


def graph_ms(torch, fn, iters):
    """Mean device ms of ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed, so that the host's cost of each call (the Python
    wrapper, the allocator) stays out of a launch of a few tens of
    microseconds, which ``time_ms`` would measure instead. Warm-up and
    capture share one side stream for the whole run, so cuBLAS sets up
    its workspace for that stream once, outside any capture."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


SHORT_MS = 0.05


def device_ms(torch, fn, iters):
    """(ms, how) of ``fn()`` on the device: ``time_ms``, the mean of one
    run of CUDA events over eager calls, or, where a call may be shorter
    than ~50 us and the host's cost of each call would be timed instead,
    ``graph_ms`` when it reads below that."""
    ms = time_ms(torch, fn, iters)
    if ms < 2 * SHORT_MS:
        replay = graph_ms(torch, fn, max(iters, 20))
        if replay < SHORT_MS:
            return replay, "graph"
    return ms, "events"


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


class Rotor:
    """Cycles through copies of a call's inputs, enough of them to exceed
    the 50 MB L2 cache, so that each timed launch reads its weight from
    device memory as a decode step's layer-by-layer walk does."""

    def __init__(self, make, nbytes, total=200 * 2**20):
        self.copies = [make() for _ in range(max(1, -(-total // nbytes)))]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


def packed_segments(torch, B, S, n_seg, dev):
    """[B, S] int32 segment ids: every row cut into ``n_seg`` documents at
    seeded places, as ``pack_documents`` would pack them."""
    rng = np.random.default_rng(2)
    segs = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        segs[b] = np.searchsorted(cuts, np.arange(S), side="right")
    return torch.from_numpy(segs).to(dev)


def attention_problem(torch, B, S, H, Hkv, D, dtype, window, pad, n_seg,
                      causal=True, lengths=None):
    """Seeded q, k, v, the mask arguments, and the boolean [B, S, S] map of
    the (query, key) pairs that attend. ``pad``: left-padded keys per row
    (generation); ``lengths``: valid keys per row, the rest a padded tail
    (BERT batches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    mask = segs = None
    rows = torch.arange(S, device=dev)
    allowed = (rows[None, :] <= rows[:, None]) if causal else \
        torch.ones((S, S), dtype=torch.bool, device=dev)
    allowed = allowed[None].expand(B, S, S)
    if window is not None:
        allowed = allowed & (rows[:, None] - rows[None, :] < window)[None]
    if pad is not None:
        pads = torch.tensor(pad, device=dev)
        mask = (rows[None] >= pads[:, None]).float()
        allowed = allowed & (mask[:, None, :] > 0)
    if lengths is not None:
        lens = torch.tensor(lengths, device=dev)
        mask = (rows[None] < lens[:, None]).to(torch.int32)
        allowed = allowed & (mask[:, None, :] > 0)
    if n_seg:
        segs = packed_segments(torch, B, S, n_seg, dev)
        allowed = allowed & (segs[:, :, None] == segs[:, None, :])
    kw = dict(causal=causal, kv_mask=mask, window=window, segment_ids=segs)
    return q, k, v, kw, allowed


def sdpa_mask_of(allowed, kw):
    """SDPA's arguments for the same problem: the boolean map when a mask
    argument is set, else the causal flag."""
    if kw["kv_mask"] is not None or kw["window"] or \
            kw["segment_ids"] is not None:
        return dict(attn_mask=allowed[:, None], is_causal=False)
    return dict(attn_mask=None, is_causal=kw["causal"])


def padded_tails(lengths, S):
    """How many rows of a ``lengths`` problem end in padding."""
    return 0 if lengths is None else sum(int(n) < S for n in lengths)


def design_of(module, key):
    """The design a kernel runs, from its module's ``DESIGN`` table
    (``flash``: by (kernel, dtype); ``blocksparse``: by dtype); a checkout
    from before the tensor-core designs (``--ab``) has no table and runs
    the module's kernels on the CUDA cores."""
    table = getattr(module, "DESIGN", None)
    return "fma" if table is None else table[key]


def flash_case(torch, F, flash, name, B, S, H, Hkv, D, dtype, window=None,
               pad=None, n_seg=0, iters=20, causal=True, lengths=None):
    q, k, v, kw, allowed = attention_problem(torch, B, S, H, Hkv, D, dtype,
                                             window, pad, n_seg, causal,
                                             lengths)
    mask = kw["kv_mask"]
    o, lse = flash.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = flash.mha_reference(q.float(), k.float(), v.float(), **kw)
    valid = allowed.any(-1)                   # rows with a valid key
    diff = (o.float() - o_ref).abs()[valid]   # [rows, H, D]
    err = diff.max().item()
    rel = (diff.amax(-1) / o_ref.abs()[valid].amax(-1)).max().item()
    lse_err = (lse - lse_ref).abs().transpose(1, 2)[valid].max().item()
    dn = str(dtype).split(".")[-1]
    check(err <= TOL[dn] and rel <= TOL[dn] and lse_err <= LSE_TOL,
          f"flash {name}: max |o - plain| {err}, per row relative {rel} "
          f"(tol {TOL[dn]}), max |lse - plain| {lse_err} (tol {LSE_TOL})")
    ms, ms_by = device_ms(torch, lambda: flash.flash_attention(q, k, v, **kw),
                          iters)
    plain_ms = time_ms(torch, lambda: flash.mha_reference(q, k, v, **kw),
                       max(2, iters // 4))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_by = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_mask_of(allowed, kw), enable_gqa=H != Hkv), iters)
    pairs = int(allowed.sum().item()) * H     # (row, col) pairs computed
    flops = 4.0 * D * pairs
    # q read and o written, k and v read once, lse written, mask and
    # segment ids read
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + B * H * S * 4 + (mask.numel() * 4 if mask is not None else 0) \
        + (B * S * 4 if n_seg else 0)
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel="K1-fwd", case=name, dtype=dn,
               shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window,
                          pad=pad, segments=n_seg, causal=causal,
                          padded_tails=padded_tails(lengths, S)),
               max_abs_err=err, max_rel_err_per_row=rel,
               lse_max_abs_err=lse_err, tol=TOL[dn],
               design=design_of(flash, ("K1-fwd", dtype)),
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               timed_by=ms_by, library_timed_by=lib_by,
               tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


def grad_errors(torch, got, ref, valid):
    """(max-abs error, the bound it is held to, the largest error relative
    to a row's own scale) of one gradient [B, S, heads, D] on the rows of
    ``valid`` [B, S]. A gradient is a sum over up to S terms, so the
    max-abs error is held relative to the largest entry; the row scale is
    floored at 1e-3 of it (dq of a row that sees one key is zero but for
    rounding noise)."""
    top = ref.abs().max().item()
    diff = (got.float() - ref).abs()[valid]
    scale = ref.abs()[valid].amax(-1).clamp_min(1e-3 * top)
    return diff.max().item(), max(1.0, top), \
        (diff.amax(-1) / scale).max().item()


def flash_bwd_case(torch, F, flash, name, B, S, H, Hkv, D, dtype, window=None,
                   pad=None, n_seg=0, iters=10, causal=True, lengths=None):
    """K2-dq and K2-dkv against the plain backward formulas on the same q,
    k, v, do and the forward kernel's o and lse. Returns the two rows."""
    q, k, v, kw, allowed = attention_problem(torch, B, S, H, Hkv, D, dtype,
                                             window, pad, n_seg, causal,
                                             lengths)
    g = torch.Generator(device=q.device).manual_seed(3)
    do = torch.randn(q.shape, generator=g, device=q.device).to(dtype)
    valid = allowed.any(-1)                   # rows with a valid key
    do = do * valid[:, :, None, None]         # the loss masks the others
    mask = kw["kv_mask"]
    o, lse = flash.flash_attention(q, k, v, **kw)
    delta = flash.attention_delta(o, do)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = (flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    ref = flash.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    dn = str(dtype).split(".")[-1]
    errs = {}
    for gname, got, got2, r in zip(("dq", "dk", "dv"), (dq, dk, dv), again,
                                   ref):
        check(torch.equal(got, got2),
              f"flash bwd {name}: {gname} differs between two launches")
        err, top, rel = grad_errors(torch, got, r, valid)
        check(err <= TOL[dn] * top and rel <= TOL[dn],
              f"flash bwd {name}: max |{gname} - plain| {err} (held to "
              f"{TOL[dn]} x {top}), per row relative {rel} (tol {TOL[dn]})")
        errs[gname] = (err, rel)
    del ref, again
    dq_ms, dq_by = device_ms(torch, lambda: flash.flash_bwd_dq(
        q, k, v, do, lse, delta, **kw), iters)
    dkv_ms, dkv_by = device_ms(torch, lambda: flash.flash_bwd_dkv(
        q, k, v, do, lse, delta, **kw), iters)
    # the plain formulas give all three gradients in one call: its time
    # stands beside both kernels
    plain_ms = time_ms(torch, lambda: flash.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), 2)
    # library yardstick: the backward of SDPA through autograd (dq, dk and
    # dv in one call), timed only
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_mask_of(allowed, kw), enable_gqa=H != Hkv)
    dot = do.transpose(1, 2)
    lib_ms, lib_by = device_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    pairs = int(allowed.sum().item()) * H     # (row, col) pairs computed
    esz = q.element_size()
    # both read q, k, v, do, lse, delta, the mask and the segment ids once
    # (the dk/dv kernel sums each group's heads in registers, so there is
    # no buffer of partials); dq writes dq, dkv writes dk and dv
    read = (2 * q.numel() + k.numel() + v.numel()) * esz + 2 * B * H * S * 4 \
        + (mask.numel() * 4 if mask is not None else 0) \
        + (B * S * 4 if n_seg else 0)
    rows = []
    for kernel, ms, ms_by, products, written, keys in (
            ("K2-dq", dq_ms, dq_by, 3, q.numel() * esz, ("dq",)),
            ("K2-dkv", dkv_ms, dkv_by, 4, 2 * k.numel() * esz,
             ("dk", "dv"))):
        flops = 2.0 * products * D * pairs
        bound_ms, by = bound(flops, read + written, dn)
        row = dict(phase="kernel", kernel=kernel, case=name, dtype=dn,
                   shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window,
                              pad=pad, segments=n_seg, causal=causal,
                              padded_tails=padded_tails(lengths, S)),
                   max_abs_err=max(errs[x][0] for x in keys),
                   max_rel_err_per_row=max(errs[x][1] for x in keys),
                   tol=TOL[dn], design=design_of(flash, (kernel, dtype)),
                   kernel_ms=ms,
                   plain_ms=plain_ms, plain_is="dq, dk and dv together",
                   library_ms=lib_ms,
                   library_is="SDPA backward (dq, dk, dv) through autograd",
                   timed_by=ms_by, library_timed_by=lib_by,
                   tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
                   bound_us=bound_ms * 1e3, bound_by=by)
        emit(row)
        rows.append(row)
    return rows


def flash_main_cases(torch, F, flash):
    """K1-fwd and K2 in bf16 at the main paths' shapes, each held to its
    plain version and timed: the llama-7b prefill, the gpt2-1.5b training
    step, and the BERT path's mode (non-causal, with the padding mask of
    its batch, a quarter of the rows ending in padding, as the key mask, at
    bert-large's attention, 16 heads of 64, seq 512, batch 32). The main
    run and ``--ab`` both time these rows."""
    bf16 = torch.bfloat16
    bert_lengths = mlm_batch(np.random.default_rng(0), 30522, 32, 512)[
        "attention_mask"].sum(-1).tolist()
    return {
        "llama": flash_case(torch, F, flash, "llama-7b prefill", 4, 512, 32,
                            32, 128, bf16),
        "gpt2": flash_case(torch, F, flash, "gpt2-1.5b train", 16, 1024, 25,
                           25, 64, bf16, iters=10),
        "gpt2 bwd": flash_bwd_case(torch, F, flash, "gpt2-1.5b train", 16,
                                   1024, 25, 25, 64, bf16),
        "bert": flash_case(torch, F, flash, "bert-large train, padded tails",
                           32, 512, 16, 16, 64, bf16, iters=10, causal=False,
                           lengths=bert_lengths),
        "bert bwd": flash_bwd_case(torch, F, flash, "bert-large train, "
                                   "padded tails", 32, 512, 16, 16, 64, bf16,
                                   causal=False, lengths=bert_lengths)}


def plan_of(int8mm, M, N, K, dtype):
    """K4's plan for this shape on this card, where the checkout's wrapper
    has one (``--ab`` may time one that has not)."""
    if not hasattr(int8mm, "plan"):
        return None
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int8mm.plan(M, N, K, 0 if dtype == torch.float32 else 1,
                       sms)._asdict()


def int8mm_case(torch, int8mm, name, M, K, N, dtype, iters=50):
    """K4 on x [M, K] and a weight quantized from normal(0, 0.02) as
    ``quantize_weights_int8`` does, against its plain version in float32;
    timed over rotating weight copies (cold in L2, as in a decode step),
    by ``graph_ms`` (a decode launch takes less time on the card than its
    wrapper takes on the host); ``kernel_ms_eager`` is ``time_ms``'s
    reading of the same launches, host included."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)

    def make():
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        scale = w.abs().amax(0, keepdim=True) / 127.0 + 1e-12
        q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
        return q, scale, (q.to(dtype) * scale.to(dtype))
    weights = Rotor(make, K * N * (1 + dtype.itemsize))
    q, scale, _ = weights.copies[0]
    out = int8mm.int8_matmul(x, q, scale)
    again = int8mm.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"int8_matmul {name}: two launches give different bits")
    ref = int8mm.int8_matmul_reference(x.float(), q, scale)
    diff = (out.float() - ref).abs()
    err, top = diff.max().item(), ref.abs().max().item()
    rel = (diff.amax(1) / ref.abs().amax(1)).max().item()
    dn = str(dtype).split(".")[-1]
    # a sum over K products: the largest error is held relative to the
    # largest output, as for the gradients of K2
    check(err <= TOL[dn] * max(1.0, top) and rel <= TOL[dn],
          f"int8_matmul {name}: max |out - plain| {err} (held to {TOL[dn]} x "
          f"{max(1.0, top)}), per row relative {rel} (tol {TOL[dn]})")

    def kern():
        qq, ss, _ = weights.next()
        return int8mm.int8_matmul(x, qq, ss)

    def plain():
        qq, ss, _ = weights.next()
        return int8mm.int8_matmul_reference(x, qq, ss)

    def library():
        return torch.matmul(x, weights.next()[2])
    eager_ms = time_ms(torch, kern, iters)
    ms = graph_ms(torch, kern, iters)
    plain_ms = graph_ms(torch, plain, max(2, iters // 5))
    lib_ms = graph_ms(torch, library, iters)
    torch.cuda.empty_cache()
    esz = x.element_size()
    # x read, the int8 weight and its scales read, out written, once each
    nbytes = M * K * esz + K * N + N * 4 + M * N * esz
    bound_ms, by = bound(2.0 * M * N * K, nbytes, dn)
    row = dict(phase="kernel", kernel="K4", case=name, dtype=dn,
               shape=dict(M=M, K=K, N=N), max_abs_err=err,
               max_rel_err_per_row=rel, largest_output=top, tol=TOL[dn],
               kernel_ms=ms, kernel_ms_eager=eager_ms, plain_ms=plain_ms,
               library_ms=lib_ms, timed_by="graph", library_timed_by="graph",
               tflops=2.0 * M * N * K / ms / 1e9, vs_library=ms / lib_ms,
               plan=plan_of(int8mm, M, N, K, dtype),
               library_is="torch.matmul on the weight dequantized to "
                          f"{dn}", weight_copies=len(weights.copies),
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


def bs_case(torch, F, sa, name, section, B, S, H, D, dtype, iters=10):
    """K5 against the gather version (float32, on the same inputs) for the
    layout that an engine config's ``sparse_attention`` section builds:
    the largest error and the error per query row relative to its own
    scale; two launches must give the same bits. Timed against the gather
    version in the input dtype and against SDPA with the layout expanded
    to a boolean [H, S, S] mask (what ``blocksparse_reference`` computes),
    the kernel and SDPA by ``device_ms`` alike; the bound counts the
    (query, key) pairs the layout keeps. The tensor-core design's row also
    gives its work list: CTAs per batch row and the row groups whose
    union was split over CTAs."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        blocksparse_attention_gather
    from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig
    cfg = sa.build_sparsity_config(SparseAttentionConfig.from_dict(section),
                                   num_heads=H)
    causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
    layout = cfg.make_layout(S)
    block = cfg.block
    lut, valid = sa.make_lut(layout)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
               for _ in range(3))

    def kern():
        return sa.blocksparse_attention_kernel(q, k, v, lut, valid, block,
                                               causal=causal)
    o, again = kern(), kern()
    torch.cuda.synchronize()
    check(torch.equal(o, again),
          f"blocksparse {name}: two launches give different bits")
    ref = blocksparse_attention_gather(q.float(), k.float(), v.float(),
                                       lut, valid, block, causal=causal)
    diff = (o.float() - ref).abs()
    err = diff.max().item()
    rel = (diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)).max().item()
    dn = str(dtype).split(".")[-1]
    check(err <= TOL[dn] and rel <= TOL[dn],
          f"blocksparse {name}: max |o - plain| {err}, per row relative "
          f"{rel} (tol {TOL[dn]})")
    del ref, diff, again
    ms, ms_by = device_ms(torch, kern, iters)
    plain_ms = time_ms(torch, lambda: blocksparse_attention_gather(
        q, k, v, lut, valid, block, causal=causal), 2)
    lay = torch.from_numpy(layout).to(dev).bool()
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    pairs = int(mask.sum().item()) * B        # (row, col) pairs kept
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_by = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None]), iters)
    del mask
    design = design_of(sa.blocksparse, dtype)
    work = {}
    if design == "mma":
        plan = sa.blocksparse.block_table(lut, valid).plan(block)
        work = dict(ctas_per_batch_row=len(plan.work),
                    split_groups=plan.split_groups,
                    row_groups=int(plan.unnz.size),
                    median_union_blocks=float(np.median(plan.unnz)))
    # q, k, v read and o written once, the table and the counts read
    nbytes = 4 * q.numel() * q.element_size() + lut.nbytes \
        + lut.shape[0] * lut.shape[1] * 4
    flops = 4.0 * D * pairs
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel="K5", case=name, dtype=dn,
               shape=dict(B=B, S=S, H=H, D=D, block=block, causal=causal,
                          L=int(lut.shape[-1]),
                          mean_active_blocks_per_row=float(
                              valid.sum(-1).mean())),
               section=section, density=float(sa.sparse_density(layout)),
               max_abs_err=err, max_rel_err_per_row=rel, tol=TOL[dn],
               design=design, **work,
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_is="SDPA with the layout as a boolean [H, S, S] mask",
               timed_by=ms_by, library_timed_by=lib_by,
               tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by, gflop=flops / 1e9)
    emit(row)
    return row


def paged_case(torch, F, paged, gpt, name, B, Hkv, group, D, bs, lengths,
               dtype, q_len=1, window=None, NB=128, iters=50, int8=False):
    """K3 against its plain version; ``int8``: int8 pools with random
    positive per-(block, head) scales (the int8-pool mode). The kernel and
    SDPA are timed by CUDA graph replay (``graph_ms``): a decode-step
    launch is about as short on the card as its wrapper on the host, so
    events over eager calls would time the host (``device_ms`` flips
    between the two timers at these lengths); the row names the timer."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N = B * NB + 1
    kp = torch.randn((N, bs, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, bs, Hkv, D), generator=g, device=dev).to(dtype)
    q = torch.randn((B, q_len, Hkv, group, D), generator=g,
                    device=dev).to(dtype)
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = perm.reshape(B, NB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    kw = dict(scale=scale, window=window)
    if int8:
        kp, vp = (torch.randint(-127, 128, (N, bs, Hkv, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        kw.update(k_scale=(0.5 + torch.rand((N, Hkv), generator=g,
                                            device=dev)) / 127.0,
                  v_scale=(0.5 + torch.rand((N, Hkv), generator=g,
                                            device=dev)) / 127.0)
    f32 = (lambda t: t) if int8 else (lambda t: t.float())
    if q_len == 1:
        def kern():
            return paged.paged_decode_attention(q[:, 0], kp, vp, tables, lens,
                                                **kw)

        def plain(qq=q, kk=kp, vv=vp):
            return paged.paged_decode_reference(qq[:, 0], kk, vv, tables,
                                                lens, **kw)
    else:
        def kern():
            return paged.paged_verify_attention(q, kp, vp, tables, lens, **kw)

        def plain(qq=q, kk=kp, vv=vp):
            return paged.paged_verify_reference(qq, kk, vv, tables, lens,
                                                **kw)
    out = kern()
    ref = plain(q.float(), f32(kp), f32(vp))

    def slot_rel(x):          # per slot, relative to that slot's scale
        d = (x.float() - ref).abs().reshape(B, -1).amax(1)
        return (d / ref.abs().reshape(B, -1).amax(1)).max().item()
    err = (out.float() - ref).abs().max().item()
    rel = slot_rel(out)
    # the plain version in the kernel's dtype, against the same fp32
    # reading: the rounding a bf16 path shows anyway (information)
    plain_rel = slot_rel(plain())
    dn = str(dtype).split(".")[-1]
    kname = "K3-int8" if int8 else "K3"
    check(err <= TOL[dn] and rel <= TOL[dn],
          f"paged {kname} {name}: max |out - plain| {err}, per slot relative "
          f"{rel} (tol {TOL[dn]}; the plain version in {dn}: {plain_rel})")
    ms = graph_ms(torch, kern, iters)
    plain_ms = time_ms(torch, plain, max(2, iters // 10))
    # library yardstick: SDPA over the cache gathered through the tables
    # (and dequantized to q's dtype), gathered before the timing
    H = Hkv * group

    def gathered(pool, spool):
        c = pool[tables.long()]
        if int8:
            c = c.float() * spool[tables.long()][:, :, None, :, None]
        return c.to(dtype).reshape(B, NB * bs, Hkv, D).transpose(1, 2)
    kc = gathered(kp, kw.get("k_scale"))
    vc = gathered(vp, kw.get("v_scale"))
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, H, q_len, D)
    col = torch.arange(NB * bs, device=dev)
    qpos = lens[:, None].long() + torch.arange(q_len, device=dev)[None]
    allowed = col[None, None] <= qpos[:, :, None]
    if window is not None:
        allowed = allowed & (col[None, None] > qpos[:, :, None] - window)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=allowed[:, None], scale=scale,
        enable_gqa=group > 1), iters)
    # work this run's data needs: blocks lo..hi of every slot
    blocks = tokens = 0
    for L in lengths:
        hi = min((L + q_len - 1) // bs, NB - 1)
        lo = 0 if window is None else min(max((L - window + 1) // bs, 0),
                                          NB - 1)
        blocks += hi - lo + 1
        tokens += (hi - lo + 1) * bs
    # one layer of this geometry: K+V of the occupied blocks, read once,
    # then q read and out written, the table entries and lengths read
    layer = gpt.GPTConfig(n_layers=1, n_heads=Hkv * group, n_kv_heads=Hkv,
                          d_model=Hkv * group * D)
    nbytes = paged.paged_hbm_bytes_per_token(
        layer, 1, tokens, kp.dtype, block_size=bs,
        scale_bytes_per_block=2 * Hkv * 4 if int8 else 0) \
        + 2 * q.numel() * q.element_size() + blocks * 4 + B * 4
    flops = 4.0 * tokens * Hkv * group * q_len * D
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel=kname, case=name, dtype=dn,
               shape=dict(B=B, Hkv=Hkv, group=group, D=D, block=bs, NB=NB,
                          q_len=q_len, window=window, lengths=list(lengths)),
               max_abs_err=err, max_rel_err_per_slot=rel,
               plain_max_rel_err_per_slot=plain_rel, tol=TOL[dn],
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               timed_by="graph", library_timed_by="graph",
               gb_per_s=nbytes / ms / 1e6, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def serve_phase(torch, flash, paged, gpt, init_inference, serving):
    cfg = gpt.preset("llama-7b")
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng = init_inference(model=(cfg, params), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()

    def launches():
        return kernel_launches(flash, paged)

    # generate: 4 prompts of 512 tokens, 32 new
    prompts = rng.integers(1, cfg.vocab_size, (4, 512)).astype(np.int32)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = launches()
    check(gen.shape == (4, 544), f"generate returned {gen.shape}")
    check(gen_launches["K1-fwd"] > 0 and gen_launches["K3"] == 0,
          f"generate should launch K1-fwd and not K3: {gen_launches}")

    # serving: 16 requests through 8 slots, chunked prefill
    lens = rng.integers(64, 1025, 16)
    reqs = [serving.ServeRequest(
        rid=i, prompt=rng.integers(1, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=64, logprobs=True) for i, n in enumerate(lens)]
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256)
    reset_launches(flash, paged)
    t_submit = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    step_end = []                  # wall instant each scheduler step ended
    while srv.busy:
        srv.step()                 # tokens are stamped with the step index
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
    serve_s = step_end[-1] - t_submit
    serve_launches = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    done = {r.rid: r for r in srv.finished}
    check(len(done) == 16, f"{len(done)} of 16 requests finished")
    short = [r.rid for r in reqs if len(r.out) != 64]
    check(not short, f"requests {short} did not produce 64 tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), "non-finite logprobs (logits) in serving")
    check(serve_launches["K3"] > 0,
          f"the serving drain never launched K3: {serve_launches}")
    with torch.inference_mode():
        logits, _ = eng._prefill_fn(torch.as_tensor(prompts[:1].astype(
            np.int64), device=eng.device))
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    ttft = [step_end[int(r.first_token_at)] - t_submit for r in reqs]
    tpot = [step_end[int(b)] - step_end[int(a)] for r in reqs
            for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)

    # greedy agreement of each served stream with a solo generate
    agree = []
    for r in reqs:
        ref = eng.generate(r.prompt[None], max_new_tokens=64)[0, len(r.prompt):]
        same = np.asarray(r.out) == ref
        agree.append(int(np.argmin(same)) if not same.all() else 64)
    row = dict(phase="serve", model="llama-7b", layers=cfg.n_layers,
               dtype="bfloat16", params=gpt.num_params(cfg),
               init_s=init_s, generate=dict(batch=4, prompt=512, new=32,
                                            seconds=gen_s,
                                            tokens_per_s=4 * 32 / gen_s,
                                            launches=gen_launches),
               requests=16, prompt_lens=[int(x) for x in lens],
               new_tokens=n_tok, seconds=serve_s,
               tokens_per_s=n_tok / serve_s,
               ttft_s_p50=float(np.percentile(ttft, 50)),
               ttft_s_p99=float(np.percentile(ttft, 99)),
               tpot_s_p50=float(np.percentile(tpot, 50)),
               tpot_s_p99=float(np.percentile(tpot, 99)),
               peak_mem_gib=peak_gb, launches=serve_launches,
               stats=dict(srv.stats), cache=srv.cache.stats(),
               greedy_prefix_agreement=agree,
               greedy_full_agreement=sum(a == 64 for a in agree))
    emit(row)
    del srv
    trace_phase(torch, eng, serving, rng)
    del eng, params
    torch.cuda.empty_cache()
    # each kernel's count from the path that runs it
    return {"K1-fwd": gen_launches["K1-fwd"], "K3": serve_launches["K3"]}


def trace_phase(torch, eng, serving, rng, steps=4, kv_quant="off",
                what="llama-7b bf16"):
    """Where a steady decode step's time goes: 8 slots decoding at ~520
    tokens each, ``steps`` scheduler steps under torch.profiler; device
    busy time is the sum of the device events' own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    V = eng.cfg.vocab_size
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, kv_quant=kv_quant)
    for i in range(8):
        srv.submit(serving.ServeRequest(
            rid=i, prompt=rng.integers(1, V, 512).astype(np.int32),
            max_new_tokens=4 + steps + 4))
    while not all(r is not None and r.state == "decode" for r in srv.slots):
        srv.step()
    srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:   # host ops: own CPU time
            if e.key.startswith("aten::"):
                host.append((e.self_cpu_time_total, e.count, e.key))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:                             # kernels and copies
            rows.append((us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time in decode steps")
    rows.sort(reverse=True)
    host.sort(reverse=True)
    emit(dict(phase="trace", what="steady decode step, 8 slots, ~520 "
                                  f"tokens each, {what}",
              steps=steps, wall_ms_per_step=wall * 1e3 / steps,
              device_busy_ms_per_step=busy_ms / steps,
              device_idle_share=1.0 - busy_ms / (wall * 1e3),
              device_events_per_step=sum(r[1] for r in rows) / steps,
              aten_calls_per_step=sum(r[1] for r in host) / steps,
              top_device=[dict(name=k[:80], ms_per_step=us / 1e3 / steps,
                               calls_per_step=n / steps)
                          for us, n, k in rows[:10]],
              top_host=[dict(op=k, self_cpu_ms_per_step=us / 1e3 / steps,
                             calls_per_step=n / steps)
                        for us, n, k in host[:10]]))
    del srv


def agreement_phase(torch, gpt, init_inference, serving):
    """The same model in float32 (the bf16 weights are its rounding):
    served streams against solo generate, where rounding noise is ~1e-7
    instead of bf16's ~4e-3, to tell numeric divergence from a bug."""
    cfg = gpt.preset("llama-7b")
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    eng = init_inference(model=(cfg, params), dtype=torch.float32)
    rng = np.random.default_rng(0)
    rng.integers(1, cfg.vocab_size, (4, 512))      # the phase-3 draws, in order
    lens = rng.integers(64, 1025, 16)[:4]
    reqs = [serving.ServeRequest(
        rid=i, prompt=rng.integers(1, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=32) for i, n in enumerate(lens)]
    srv = serving.ServingEngine(eng, num_slots=4, block_size=16,
                                prefill_chunk=256)
    srv.run(reqs)
    agree = []
    for r in reqs:
        ref = eng.generate(r.prompt[None], max_new_tokens=32)[0, len(r.prompt):]
        same = np.asarray(r.out) == ref
        agree.append(int(np.argmin(same)) if not same.all() else 32)
    check(all(len(r.out) == 32 for r in reqs), "fp32 serving lost tokens")
    check(all(a == 32 for a in agree),
          f"fp32 served streams differ from solo generate after "
          f"{agree} of 32 tokens")
    emit(dict(phase="agreement", model="llama-7b", dtype="float32",
              requests=4, new_tokens=32, greedy_prefix_agreement=agree,
              greedy_full_agreement=sum(a == 32 for a in agree)))
    del eng, params, srv
    torch.cuda.empty_cache()


def drain(torch, srv, reqs):
    """Submit ``reqs`` and step ``srv`` until idle, synchronising after
    each step; returns (wall instant of each step's end, submit instant)."""
    t_submit = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    step_end = []
    while srv.busy:
        srv.step()                 # tokens are stamped with the step index
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
    return step_end, t_submit


def serve_int8_phase(torch, flash, paged, gpt, init_inference, serving):
    """The int8 serving path: weight-only int8 (K4 in every block
    projection) and int8 KV blocks (K3-int8 in every decode step) on the
    serve phase's model, prompts and requests."""
    cfg = gpt.preset("llama-7b")
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng = init_inference(model=(cfg, params), dtype=torch.int8)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    check(eng.quantized and eng.dtype == torch.bfloat16,
          f"init_inference(dtype=int8) gave {eng.dtype}")
    weights_gib = torch.cuda.memory_allocated() / 2**30
    int8_gib = sum(t.numel() for t in (eng.params["lm_head"]["q"],
                                       *(v["q"] for v in
                                         eng.params["block"].values()
                                         if "q" in v))) / 2**30
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (4, 512)).astype(np.int32)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = kernel_launches(flash, paged)
    check(gen.shape == (4, 544), f"int8 generate returned {gen.shape}")
    check(gen_launches["K1-fwd"] > 0 and gen_launches["K4"] > 0
          and gen_launches["K3"] == 0 and gen_launches["K3-int8"] == 0,
          f"int8 generate should launch K1-fwd and K4 and neither K3 mode: "
          f"{gen_launches}")

    lens = rng.integers(64, 1025, 16)
    prompt_of = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                 for n in lens]

    def requests():
        return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=64,
                                     logprobs=True)
                for i, p in enumerate(prompt_of)]
    reqs = requests()
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, kv_quant="int8")
    cache = srv.cache
    pool_gib = sum(t.numel() * t.element_size() for t in
                   (cache.k, cache.v, cache.k_scale, cache.v_scale)) / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launches(flash, paged)
    step_end, t_submit = drain(torch, srv, reqs)
    serve_launches = kernel_launches(flash, paged)
    serve_s = step_end[-1] - t_submit
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(len(srv.finished) == 16 and all(len(r.out) == 64 for r in reqs),
          "int8 serving lost requests or tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), "non-finite logprobs in int8 serving")
    check(serve_launches["K4"] > 0 and serve_launches["K3-int8"] > 0
          and serve_launches["K3"] == 0,
          f"the int8 drain should launch K4 and K3-int8 and never float K3: "
          f"{serve_launches}")
    stats = cache.stats()
    ttft = [step_end[int(r.first_token_at)] - t_submit for r in reqs]
    tpot = [step_end[int(b)] - step_end[int(a)] for r in reqs
            for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)
    del srv

    # the same int8 weights over a bf16 cache: agreement is reported, not
    # asserted (random weights give near-tied bf16 logits)
    ref_reqs = requests()
    ref_end, ref_submit = drain(torch, serving.ServingEngine(
        eng, num_slots=8, block_size=16, prefill_chunk=256), ref_reqs)
    ref_tpot = [ref_end[int(b)] - ref_end[int(a)] for r in ref_reqs
                for a, b in zip(r.token_times, r.token_times[1:])]
    agree = []
    for r, f in zip(reqs, ref_reqs):
        same = np.asarray(r.out) == np.asarray(f.out)
        agree.append(int(np.argmin(same)) if not same.all() else 64)
    emit(dict(phase="serve_int8", model="llama-7b", layers=cfg.n_layers,
              weights="int8 (weight-only), bf16 activations",
              kv_cache="int8 blocks, fp32 scale per (block, kv head)",
              init_s=init_s, weights_gib_after_init=weights_gib,
              int8_weight_gib=int8_gib,
              generate=dict(batch=4, prompt=512, new=32, seconds=gen_s,
                            tokens_per_s=4 * 32 / gen_s,
                            launches=gen_launches),
              requests=16, new_tokens=n_tok, seconds=serve_s,
              tokens_per_s=n_tok / serve_s,
              ttft_s_p50=float(np.percentile(ttft, 50)),
              ttft_s_p99=float(np.percentile(ttft, 99)),
              tpot_s_p50=float(np.percentile(tpot, 50)),
              tpot_s_p99=float(np.percentile(tpot, 99)),
              peak_mem_gib=peak_gb, kv_pool_gib=pool_gib,
              kv_bytes_per_token=stats["kv_bytes_per_token"],
              kv_bytes_per_token_bf16=gpt.kv_bytes_per_token(cfg),
              launches=serve_launches, cache=stats,
              bf16_cache_drain=dict(
                  seconds=ref_end[-1] - ref_submit,
                  tokens_per_s=sum(len(r.out) for r in ref_reqs)
                  / (ref_end[-1] - ref_submit),
                  tpot_s_p50=float(np.percentile(ref_tpot, 50))),
              greedy_prefix_agreement_vs_bf16_cache=agree,
              greedy_full_agreement_vs_bf16_cache=sum(a == 64 for a in agree)))
    trace_phase(torch, eng, serving, rng, kv_quant="int8",
                what="llama-7b int8 weights, int8 KV")
    del eng
    torch.cuda.empty_cache()
    return {"K4": serve_launches["K4"], "K3-int8": serve_launches["K3-int8"],
            "K4-generate": gen_launches["K4"]}


# ---------------------------------------------------------------------------
# phase 4: the card against the host, float32
# ---------------------------------------------------------------------------

def parity_phase(torch, gpt, InferenceEngine):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.preset("llama-7b", n_layers=2)
    params = gpt.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    cpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cpu")
    gpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(1)
    bs, C = 16, 32
    NB = gpt.decode_geometry(cfg, bs)[0]
    shape = (cfg.n_layers, 2 * NB + 1, bs, cfg.kv_heads, cfg.head_dim)
    pools = {e: (torch.zeros(shape, device=e.device),
                 torch.zeros(shape, device=e.device)) for e in (cpu, gpu)}
    tables = np.arange(1, 2 * NB + 1, dtype=np.int32).reshape(2, NB)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (45, 70)]
    worst = 0.0

    def compare(a, b):
        nonlocal worst
        a, b = a.float().cpu(), b.float().cpu()
        check(bool(torch.isfinite(a).all()), "non-finite card logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= 1e-3, f"card vs host logits: relative max-abs {rel}")

    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            out = {e: e.prefill_into_slot(*pools[e], tables[slot], chunk,
                                          start, n)[0] for e in (cpu, gpu)}
            compare(out[gpu], out[cpu])
    lengths = np.array([len(p) for p in prompts], np.int32)
    forced = rng.integers(1, cfg.vocab_size, (8, 2)).astype(np.int32)
    for step in range(8):
        out = {e: e.decode_slots(*pools[e], tables, lengths, forced[step],
                                 np.array([True, True]))[0]
               for e in (cpu, gpu)}
        compare(out[gpu], out[cpu])
        lengths = lengths + 1
    static = rng.integers(1, cfg.vocab_size, (2, 96)).astype(np.int64)
    out = {e: e._prefill_fn(torch.as_tensor(static, device=e.device))[0]
           for e in (cpu, gpu)}
    compare(out[gpu], out[cpu])
    row = dict(phase="parity", model="llama-7b width, 2 layers",
               dtype="float32", prefill_chunks=sum(-(-len(p) // C)
                                                   for p in prompts),
               decode_steps=8, static_prefill=list(static.shape),
               worst_relative_max_abs=worst, tol=1e-3)
    emit(row)


def parity_int8_phase(torch, gpt, InferenceEngine):
    """int8 weights and int8 KV blocks, float32 activations: the host
    quantizes llama-7b width at 2 layers, and the same int8 tree runs on
    the card (K4, K3-int8) and on the host (plain versions) through a
    teacher-forced prefill and 8 decode steps.

    A float32 difference of ~1e-6 between the two sums can move a K/V
    value that sits on a rounding edge to the next code when its block is
    requantized. The logits are held to 1/127 relative: one code step is
    1/127 of its block's largest value, the most a single flipped code
    moves the K or V row it sits in (the float32 kernels alone agree to
    ~6e-6, ``parity``). The pools may differ in at most 1% of their entries
    (block 0, the trash block, is left out): by one step in layer 0, whose
    K/V come from the same embeddings through one projection; by two in
    the layers above, whose inputs already carry the flipped codes below
    them: a value off by the 1/127 relative of the logits' tolerance is off
    by up to 127 / 127 = 1 step before its own rounding edge adds one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt.preset("llama-7b", n_layers=2)
    params = gpt.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    cpu = InferenceEngine((cfg, params), dtype=torch.int8, device="cpu")
    gpu = InferenceEngine((cfg, cpu.params), dtype=torch.float32,
                          device="cuda")
    rng = np.random.default_rng(1)
    bs, C = 16, 32
    NB = gpt.decode_geometry(cfg, bs)[0]
    N = 2 * NB + 1
    shape = (cfg.n_layers, N, bs, cfg.kv_heads, cfg.head_dim)
    sshape = (cfg.n_layers, N, cfg.kv_heads)
    pools = {e: [torch.zeros(shape, dtype=torch.int8, device=e.device),
                 torch.zeros(shape, dtype=torch.int8, device=e.device),
                 torch.zeros(sshape, device=e.device),
                 torch.zeros(sshape, device=e.device)] for e in (cpu, gpu)}
    tables = np.arange(1, N, dtype=np.int32).reshape(2, NB)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (45, 70)]
    tol = 1.0 / 127
    worst = 0.0

    def compare(a, b):
        nonlocal worst
        a, b = a.float().cpu(), b.float().cpu()
        check(bool(torch.isfinite(a).all()), "non-finite card logits (int8)")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= tol, f"int8 card vs host logits: relative max-abs {rel}")

    def run(e, fn, *args):
        p = pools[e]
        out = fn(p[0], p[1], *args, k_scale=p[2], v_scale=p[3])
        pools[e] = list(out[1:])
        return out[0]

    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            out = {e: run(e, e.prefill_into_slot, tables[slot], chunk, start,
                          n) for e in (cpu, gpu)}
            compare(out[gpu], out[cpu])
    lengths = np.array([len(p) for p in prompts], np.int32)
    forced = rng.integers(1, cfg.vocab_size, (8, 2)).astype(np.int32)
    for step in range(8):
        out = {e: run(e, e.decode_slots, tables, lengths, forced[step],
                      np.array([True, True])) for e in (cpu, gpu)}
        compare(out[gpu], out[cpu])
        lengths = lengths + 1
    codes = {}
    for i, name in enumerate(("k", "v")):
        d = (pools[gpu][i].cpu()[:, 1:].int() - pools[cpu][i][:, 1:].int()).abs()
        sc, sh = pools[gpu][i + 2].cpu()[:, 1:], pools[cpu][i + 2][:, 1:]
        codes[name] = [dict(max_step=int(d[l].max()),
                            differing=int((d[l] > 0).sum()),
                            entries=d[l].numel(),
                            scale_relative_max_abs=(
                                (sc[l] - sh[l]).abs().max()
                                / sh[l].abs().max()).item())
                       for l in range(cfg.n_layers)]
    emit(dict(phase="parity_int8", model="llama-7b width, 2 layers",
              weights="int8", kv_cache="int8", activations="float32",
              prefill_chunks=sum(-(-len(p) // C) for p in prompts),
              decode_steps=8, worst_relative_max_abs=worst, tol=tol,
              pools_per_layer=codes))
    for name, layers in codes.items():
        for l, c in enumerate(layers):
            check(c["max_step"] <= (1 if l == 0 else 2)
                  and c["differing"] <= 0.01 * c["entries"]
                  and c["scale_relative_max_abs"] <= tol,
                  f"int8 {name} pool of layer {l}, card vs host: {c}")


# ---------------------------------------------------------------------------
# phase 5: the training path at full width and depth
# ---------------------------------------------------------------------------

def kernel_launches(flash, paged):
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul
    from deepspeed_tpu_torch.ops.sparse_attention import (
        blocksparse_attention_kernel)
    return {"K1-fwd": flash.flash_attention.launches,
            "K2-dq": flash.flash_attention.bwd_dq_launches,
            "K2-dkv": flash.flash_attention.bwd_dkv_launches,
            "K3": paged.paged_attention.launches,
            "K3-int8": paged.paged_attention.int8_launches,
            "K4": int8_matmul.launches,
            "K5": blocksparse_attention_kernel.launches}


def reset_launches(flash, paged):
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul
    from deepspeed_tpu_torch.ops.sparse_attention import (
        blocksparse_attention_kernel)
    blocksparse_attention_kernel.launches = 0
    flash.flash_attention.launches = 0
    flash.flash_attention.bwd_dq_launches = 0
    flash.flash_attention.bwd_dkv_launches = 0
    paged.paged_attention.launches = 0
    paged.paged_attention.int8_launches = 0
    int8_matmul.launches = 0


def seeded_documents(rng, vocab, n_rows, seq_len, lo=64, hi=1024):
    """Documents of lo..hi seeded tokens, enough to pack n_rows rows."""
    docs, total = [], 0
    while total < 2 * n_rows * seq_len:
        docs.append(rng.integers(1, vocab, int(rng.integers(lo, hi + 1))))
        total += len(docs[-1])
    return docs


def run_steps(torch, eng, batch, steps, warmup):
    """(ms per timed step, loss of every step incl. warm-up)."""
    ms, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"train step {i}: loss {losses[-1]}, grad norm "
              f"{float(m['grad_norm'])}")
    return ms, losses


def train_phase(torch, flash, paged, gpt, initialize, pack_documents):
    """gpt2-1.5b through initialize -> train_batch, twice: the
    memory-efficient bf16 configuration under full checkpointing, then
    fp32 masters under the selective policy on packed documents. Returns
    the launch counts of the first run (the main path)."""
    S, L = 1024, 48
    adamw = {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}}
    runs = (
        dict(name="bf16 memory-efficient, full remat, chunked loss",
             policy="full", batch=16, steps=5, warmup=1, packed=False,
             config={"bf16": {"enabled": True, "memory_efficient": True}}),
        # a log warm-up over 10 steps, as such a run is really started:
        # Adam's first full-rate steps from random weights overshoot
        dict(name="bf16 compute, fp32 masters, selective remat, packed, "
                  "WarmupLR", policy="selective", batch=8, steps=5, warmup=0,
             packed=True,
             config={"bf16": {"enabled": True},
                     "scheduler": {"type": "WarmupLR", "params": {
                         "warmup_max_lr": 1e-4, "warmup_num_steps": 10}}}),
    )
    main_launches = None
    for run in runs:
        cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                         remat_policy=run["policy"], loss_chunk=2048)
        check(cfg.n_layers == L and cfg.d_model == 1600,
              "gpt2-1.5b preset changed")
        rng = np.random.default_rng(0)
        if run["packed"]:
            packed = pack_documents(
                seeded_documents(rng, cfg.vocab_size, run["batch"], S + 1),
                S + 1)
            batch = {k: v[:run["batch"]] for k, v in packed.items()}
            tokens = int(batch["loss_mask"].sum())
        else:
            batch = {"tokens": rng.integers(
                1, cfg.vocab_size, (run["batch"], S + 1)).astype(np.int32)}
            tokens = run["batch"] * S
        t0 = time.perf_counter()
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": run["batch"], "optimizer": adamw,
                    "steps_per_print": 1000, **run["config"]})
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = eng._to_device(batch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        ms, losses = run_steps(torch, eng, batch, run["steps"], run["warmup"])
        counts = kernel_launches(flash, paged)
        n = run["steps"] + run["warmup"]
        k1_want = (2 if run["policy"] == "full" else 1) * L * n
        check(counts["K1-fwd"] == k1_want and counts["K2-dq"] == L * n
              and counts["K2-dkv"] == L * n and counts["K3"] == 0,
              f"train ({run['name']}): launches {counts}, expected K1-fwd "
              f"{k1_want}, K2-dq and K2-dkv {L * n}, K3 0")
        check(losses[-1] < losses[0],
              f"train ({run['name']}): the loss did not fall on the "
              f"repeated batch: {losses}")
        step_ms = float(np.median(ms))
        flops = gpt.train_flops_per_token(cfg, S) * run["batch"] * S
        emit(dict(phase="train", model="gpt2-1.5b", layers=L,
                  params=eng.num_parameters, run=run["name"],
                  batch=run["batch"], seq_len=S, loss_tokens=tokens,
                  init_s=init_s, step_ms=ms, step_ms_median=step_ms,
                  tokens_per_s=run["batch"] * S / step_ms * 1e3,
                  mfu_vs_989_tflops=flops / (step_ms / 1e3) / 989e12,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=losses, launches=counts,
                  launches_per_step={k: v / n for k, v in counts.items()}))
        if main_launches is None:
            main_launches = counts
            train_trace(torch, eng, batch, "one training step, gpt2-1.5b, "
                        "bf16 memory-efficient, full remat, batch 16 x 1024")
        del eng, batch
        torch.cuda.empty_cache()
    return main_launches


def train_trace(torch, eng, batch, what, phase="train_trace"):
    """One training step under torch.profiler: the device's busy share and
    its top operations, and the share of the flash kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time in a training step")
    rows.sort(reverse=True)

    def share(word):
        return sum(us for us, _, key in rows if word in key) / 1e3 / busy_ms
    emit(dict(phase=phase, what=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
              device_events=sum(r[1] for r in rows),
              share_flash_fwd=share("flash_fwd_"),     # both designs
              share_flash_bwd_dq=share("flash_bwd_dq_"),
              share_flash_bwd_dkv=share("flash_bwd_dkv_"),
              top_device=[dict(name=k[:80], ms=us / 1e3, calls=n,
                               share=us / 1e3 / busy_ms)
                          for us, n, k in rows[:12]]))


def remat_phase(torch, gpt, initialize, tree):
    """What each checkpointing policy costs in memory at full depth, and
    that none changes the result. Two readings per policy: what the
    forward leaves allocated for the backward (the policy's contract), and
    the peak of a whole ``train_batch`` step. Batch 12, not the training
    run's 16: without checkpointing 16 rows do not fit the card."""
    S, B = 1024, 12
    settings = (("none", dict(remat=False)),
                ("selective", dict(remat=True, remat_policy="selective")),
                ("flash_only", dict(remat=True, remat_policy="flash_only")),
                ("full", dict(remat=True, remat_policy="full")))
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 50304, (B, S + 1)).astype(np.int32)
    kept, peaks, ms = {}, {}, {}
    for name, fields in settings:
        cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, loss_chunk=2048,
                         **fields)
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": B, "steps_per_print": 1000,
                    "bf16": {"enabled": True, "memory_efficient": True},
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
        del params
        batch = eng._to_device({"tokens": tokens})
        leaves = tree.tree_map(lambda t: t.detach().requires_grad_(),
                               eng.params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = gpt.loss_fn(leaves, batch, None, cfg, deterministic=True)
        torch.cuda.synchronize()
        kept[name] = (torch.cuda.memory_allocated() - before) / 2**30
        del loss, leaves
        eng.train_batch(batch)                  # warm-up, allocator settled
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        check(np.isfinite(float(m["loss"])), f"remat {name}: loss not finite")
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        del eng, batch
        torch.cuda.empty_cache()
    for what, got in (("kept between forward and backward", kept),
                      ("peak memory of a step", peaks)):
        order = [got[n] for n, _ in settings]
        check(all(a > b for a, b in zip(order, order[1:])),
              f"{what} should fall from no checkpointing through selective "
              f"and flash_only to full: {got}")

    # the same loss and gradient under every policy: 2 layers, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {}
    for name, fields in settings:
        cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=256,
                         dtype=torch.float32, **fields)
        params = gpt.init_params(cfg, seed=2, dtype=torch.float32)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2, "steps_per_print": 1000,
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
        m = eng.train_batch({"tokens": tokens[:2, :257]})
        small[name] = (float(m["loss"]), float(m["grad_norm"]))
        del eng, params
    base = small["none"]
    for name, (loss, gnorm) in small.items():
        check(abs(loss - base[0]) <= 1e-6 * abs(base[0])
              and abs(gnorm - base[1]) <= 1e-5 * abs(base[1]),
              f"remat {name}: loss, grad norm {loss, gnorm} against "
              f"{base} without checkpointing")
    torch.cuda.empty_cache()
    emit(dict(phase="remat", model="gpt2-1.5b", layers=48, batch=B,
              seq_len=S, config="bf16 memory-efficient, chunked loss",
              kept_after_forward_gib=kept, peak_mem_gib=peaks, step_ms=ms,
              fp32_2_layers_loss_and_grad_norm=small))


def train_parity_phase(torch, gpt, initialize, pack_documents, tree):
    """The card (kernels) against the host (plain versions), float32,
    gpt2-1.5b width at 2 layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    S, B = 256, 2
    rng = np.random.default_rng(3)
    plain = {"tokens": rng.integers(1, 50304, (B, S + 1)).astype(np.int32)}
    packed = pack_documents(seeded_documents(rng, 50304, B, S + 1, 16, 120),
                            S + 1)
    packed = {k: v[:B] for k, v in packed.items()}
    worst = {}
    for name, batch, chunk in (("plain", plain, 0), ("packed", packed, 200)):
        cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=S + 1,
                         dtype=torch.float32, loss_chunk=chunk)
        host = gpt.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
        grads = {}
        for dev in ("cpu", "cuda"):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in tree.tree_leaves(host)]
            params = tree.tree_unflatten(host, leaves)
            loss = gpt.loss_fn(params, {k: torch.as_tensor(v).to(dev)
                                        for k, v in batch.items()}, None, cfg)
            grads[dev] = (loss.item(), [g.cpu() for g in
                                        torch.autograd.grad(loss, leaves)])
        (lh, gh), (lc, gc) = grads["cpu"], grads["cuda"]
        rel = max([abs(lc - lh) / abs(lh)]
                  + [((c - h).abs().max() / h.abs().max()).item()
                     for c, h in zip(gc, gh)])
        check(np.isfinite(lc) and rel <= 1e-3,
              f"train parity ({name}): card vs host loss {lc} vs {lh}, "
              f"worst relative gradient error {rel}")
        worst[name] = rel

    # two train_batch steps on both devices, for each optimizer. Adam's and
    # Adagrad's eps are raised to 1e-3: with the default 1e-8 an entry
    # whose gradient is rounding noise (the key bias, whose gradient is
    # zero in exact arithmetic) is normalised to a full +-lr step, and the
    # two devices' noise differs
    cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=S + 1,
                     dtype=torch.float32)
    host = gpt.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    optimizers = {
        "adamw": {"type": "AdamW", "params": {
            "lr": 1e-3, "weight_decay": 0.1, "eps": 1e-3}},
        "sgd-nesterov": {"type": "sgd", "params": {
            "lr": 1e-2, "momentum": 0.9, "nesterov": True}},
        "adagrad": {"type": "adagrad", "params": {
            "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-3}}}
    steps = {}
    for name, opt in optimizers.items():
        engines = [initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=host, device=dev,
            config={"train_batch_size": B, "gradient_clipping": 1.0,
                    "steps_per_print": 1000, "optimizer": opt})[0]
            for dev in ("cpu", "cuda")]
        for _ in range(2):
            losses = [float(e.train_batch(packed)["loss"]) for e in engines]
        prel = max(((c.cpu() - h).abs().max() / h.abs().max()).item()
                   for h, c in zip(*(tree.tree_leaves(e.params)
                                     for e in engines)))
        check(prel <= 1e-4 and abs(losses[0] - losses[1])
              <= 1e-4 * losses[0],
              f"train parity ({name}): parameters after two steps differ "
              f"by {prel} relative, losses {losses}")
        steps[name] = dict(worst_relative_parameter=prel,
                           loss_host_card=losses)
        del engines
    emit(dict(phase="train_parity", model="gpt2-1.5b width, 2 layers",
              dtype="float32", batch=B, seq_len=S,
              worst_relative_loss_or_gradient=worst, tol=1e-3,
              two_steps=steps, param_tol=1e-4,
              seconds=time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# slice 5: checkpoints and resume, the loaders and the engine's features
# ---------------------------------------------------------------------------

def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def serve_streams(serving, eng, prompts, new):
    """Greedy streams of ``prompts`` drained through a ServingEngine."""
    srv = serving.ServingEngine(eng, num_slots=len(prompts), block_size=16,
                                prefill_chunk=256)
    reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    while srv.busy:
        srv.step()
    return np.array([r.out for r in reqs])


def resume_phase(torch, flash, paged, gpt, initialize, init_inference,
                 serving, tree, ckpt):
    """gpt2-1.5b at full width and depth in the ``train`` phase's first
    configuration: four uninterrupted steps against two steps, a save, a
    fresh engine from other weights, the load and two more steps, which
    must agree bit for bit (the bf16 stochastic rounding makes this a
    test of the saved generator state). The resumed engine saves again
    (``latest`` moves to it); then the 16-bit model file, and serving from
    the checkpoint: ``generate`` (K1-fwd) and a serving drain (K3) from
    ``init_inference(config=, checkpoint=)`` must give the streams of the
    resumed engine's weights handed over directly."""
    import tempfile
    t_phase = time.perf_counter()
    S, B = 1024, 16
    cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                     remat_policy="full", loss_chunk=2048)
    L = cfg.n_layers
    config = {"train_batch_size": B, "steps_per_print": 1000,
              "bf16": {"enabled": True, "memory_efficient": True},
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 1e-4, "weight_decay": 0.1}}}
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (B, S + 1))
                .astype(np.int32)} for _ in range(4)]

    def engine(seed):
        params = gpt.init_params(cfg, seed=seed, dtype=torch.bfloat16)
        return initialize(model=gpt.make_loss_fn(cfg),
                          model_parameters=params, config=config)[0]

    def steps(eng, todo):
        out = []
        for b in todo:
            out.append(float(eng.train_batch(b)["loss"]))
            check(np.isfinite(out[-1]), f"resume: loss {out[-1]}")
        return out

    whole = engine(0)
    want = steps(whole, batches)
    work = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        first = engine(0)
        got = steps(first, batches[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save_checkpoint(work, tag="step2")
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(os.path.join(work, "step2"))
        t0 = time.perf_counter()
        check(ckpt.validate_tag(work, "step2"), "resume: tag not valid")
        crc_s = time.perf_counter() - t0
        del first
        torch.cuda.empty_cache()
        resumed = engine(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, _ = resumed.load_checkpoint(work, strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(path is not None and resumed.global_steps == 2,
              f"resume: load gave {path}, step {resumed.global_steps}")
        got += steps(resumed, batches[2:])
        check(got == want, f"resume: losses {got}, uninterrupted {want}")
        differ = [name for name, a, b in (
            [("params", a, b) for a, b in zip(
                tree.tree_leaves(resumed.params),
                tree.tree_leaves(whole.params))]
            + [(f"opt {k}", a, b) for k in ("mu", "nu") for a, b in zip(
                tree.tree_leaves(resumed.opt_state[k]),
                tree.tree_leaves(whole.opt_state[k]))])
            if not torch.equal(a, b)]
        check(not differ and resumed.opt_state["count"]
              == whole.opt_state["count"] == 4,
              f"resume: {len(differ)} leaves differ from the uninterrupted "
              f"run ({differ[:4]})")
        check(torch.equal(resumed.rng.get_state(), whole.rng.get_state()),
              "resume: generator states differ")
        del whole
        torch.cuda.empty_cache()
        # the resumed engine's own checkpoint, which `latest` now names:
        # the weights served below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.save_checkpoint(work, tag="step4")
        save2_s = time.perf_counter() - t0
        check(ckpt.get_latest_tag(work) == "step4", "resume: latest moved "
              "to " + str(ckpt.get_latest_tag(work)))

        t0 = time.perf_counter()
        resumed.save_16bit_model(work, "model_16bit.npz")
        save16_s = time.perf_counter() - t0
        npz = os.path.join(work, "model_16bit.npz")
        back = ckpt.load_16bit_model(npz)
        check(all(torch.equal(a, b.cpu()) for a, b in zip(
            tree.tree_leaves(back), tree.tree_leaves(resumed.params))),
            "resume: the 16-bit model file does not hold the parameters")
        del back

        icfg = gpt.preset("gpt2-1.5b", max_seq_len=S)
        prompts = rng.integers(1, cfg.vocab_size, (4, 256)).astype(np.int32)
        t0 = time.perf_counter()
        from_ckpt = init_inference(config=icfg, checkpoint=work,
                                   dtype=torch.bfloat16)
        torch.cuda.synchronize()
        serve_init_s = time.perf_counter() - t0
        direct = init_inference(model=(icfg, resumed.params),
                                dtype=torch.bfloat16)
        reset_launches(flash, paged)
        streams = from_ckpt.generate(prompts, max_new_tokens=32)
        drained = serve_streams(serving, from_ckpt, list(prompts), 32)
        counts = kernel_launches(flash, paged)
        check(counts["K1-fwd"] > 0 and counts["K3"] > 0,
              f"resume: serving from the checkpoint launched {counts}")
        check(np.array_equal(streams, direct.generate(prompts, 32)),
              "resume: generate from the checkpoint differs from generate "
              "on the engine's parameters")
        check(np.array_equal(drained, serve_streams(
            serving, direct, list(prompts), 32)),
            "resume: the serving drain from the checkpoint differs")
        emit(dict(phase="resume", model="gpt2-1.5b", layers=L, batch=B,
                  seq_len=S, config="bf16 memory-efficient, AdamW, full "
                  "remat, chunked loss", losses=got, bit_identical=True,
                  checkpoint_bytes=nbytes, save_s=save_s,
                  save_gb_per_s=nbytes / save_s / 1e9,
                  crc32_pass_s=crc_s, crc32_gb_per_s=nbytes / crc_s / 1e9,
                  load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
                  resumed_save_s=save2_s,
                  resumed_save_gb_per_s=nbytes / save2_s / 1e9,
                  model_16bit_bytes=os.path.getsize(npz),
                  save_16bit_s=save16_s, serve_init_from_checkpoint_s=
                  serve_init_s, generate_identical=True,
                  drain_identical=True, serving_launches=counts,
                  seconds=time.perf_counter() - t_phase))
        del from_ckpt, direct, resumed
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def train_features_phase(torch, flash, paged, gpt, initialize, dataloader,
                         pld_lib):
    """gpt2-1.5b at full width and depth fed by ``initialize(
    training_data=)`` through RepeatingLoader and PrefetchLoader, six
    steps with a fixed_linear seqlen curriculum (lengths off the 64 grid),
    progressive layer drop at theta 0.5, the monitor, the timers and the
    flops profiler at step 3. Under full remat each step launches K1-fwd
    twice and K2-dq and K2-dkv once per kept layer, K3 never."""
    import tempfile
    t_phase = time.perf_counter()
    S, B, n_steps = 1024, 16, 6
    cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                     remat_policy="full", loss_chunk=2048)
    L = cfg.n_layers
    pld = {"enabled": True, "theta": 0.5, "gamma": 1.0}
    rng = np.random.default_rng(6)
    rows = rng.integers(1, cfg.vocab_size, (B * n_steps, S + 1)).astype(
        np.int32)
    data = [{"tokens": r[:S], "targets": r[1:]} for r in rows]
    work = tempfile.mkdtemp(prefix="chip_smoke_features_")
    try:
        profile = os.path.join(work, "flops_profile.txt")
        # the monitor's buffer and the throughput meter flush every third
        # step: one write carries three steps
        config = {
            "train_batch_size": B, "steps_per_print": 3,
            "bf16": {"enabled": True, "memory_efficient": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "wall_clock_breakdown": True,
            "tensorboard": {"enabled": True, "output_path": work,
                            "job_name": "train_features"},
            "flops_profiler": {"enabled": True, "profile_step": 3,
                               "output_file": profile},
            "progressive_layer_drop": pld,
            "curriculum_learning": {
                "enabled": True, "curriculum_type": "seqlen",
                "min_difficulty": 520, "max_difficulty": S,
                "schedule_type": "fixed_linear",
                "schedule_config": {"total_curriculum_step": 10,
                                    "difficulty_step": 8}}}
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, loader, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            training_data=data, config=config)
        del params
        batches = iter(dataloader.PrefetchLoader(
            dataloader.RepeatingLoader(loader), eng))
        per_step = []
        reset_launches(flash, paged)
        before = kernel_launches(flash, paged)
        for _ in range(n_steps):
            # the step's layer-drop draws, replayed from the generator's
            # state: the model draws them first thing in its forward
            gen = torch.Generator(device=eng.device)
            gen.set_state(eng.rng.get_state())
            theta = pld_lib.theta_schedule(eng.step_count, pld["theta"],
                                           pld["gamma"])
            kept = sum(gpt.pld_keep(theta, L, gen))
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = eng.train_batch(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = kernel_launches(flash, paged)
            step = {k: after[k] - before[k] for k in after}
            before = after
            seq = eng.curriculum_scheduler.get_current_difficulty()
            loss = float(m["loss"])
            per_step.append(dict(seq_len=seq, ms=ms, kept_layers=kept,
                                 theta=theta, loss=loss, launches=step))
            check(np.isfinite(loss), f"train_features: loss {loss}")
            check(step["K1-fwd"] == 2 * kept and step["K2-dq"] == kept
                  and step["K2-dkv"] == kept and step["K3"] == 0,
                  f"train_features: step at S={seq} kept {kept} layers "
                  f"and launched {step}")
        counts = kernel_launches(flash, paged)
        seqs = [r["seq_len"] for r in per_step]
        check(sum(x % 64 != 0 for x in seqs) >= 2,
              f"train_features: lengths {seqs} stay on the 64 grid")
        check(min(r["kept_layers"] for r in per_step) < L,
              "train_features: layer drop dropped no layer")
        eng.destroy()
        with open(os.path.join(work, "train_features", "scalars.csv")) as f:
            lines = f.read().splitlines()
        csv_rows = lines[1:]
        check(lines[0].startswith("step,")
              and [int(r.split(",")[0]) for r in csv_rows]
              == [B * (i + 1) for i in range(n_steps)],
              f"train_features: the monitor's CSV is not one header and "
              f"one row per step: {lines}")
        with open(profile) as f:
            report = f.read()
        mfu = [line for line in report.splitlines()
               if line.startswith("MFU:")]
        check(mfu, f"train_features: no MFU line in the profile: {report}")
        # the profile counts the layers that ran at step 3, not all L
        third = per_step[2]
        want = gpt.train_flops_per_token(
            gpt.preset("gpt2-1.5b", n_layers=third["kept_layers"]),
            third["seq_len"]) * B * third["seq_len"]
        counted = float(report.split("step flops:")[1].split("(")[1]
                        .split(")")[0])
        check(f"micro step ran: [{third['kept_layers']}]" in report
              and abs(counted - want) <= 1e-9 * want,
              f"train_features: profile counted {counted} FLOPs, the "
              f"{third['kept_layers']} layers that ran make {want}: "
              f"{report}")
        step_timer = eng.timers("train_batch").elapsed_records
        check(len(step_timer) == n_steps,
              f"train_features: {len(step_timer)} train_batch timings")
        emit(dict(phase="train_features", model="gpt2-1.5b", layers=L,
                  batch=B, steps=per_step, launches=counts,
                  monitor_rows=len(csv_rows),
                  profile=[line for line in report.splitlines()
                           if ":" in line],
                  train_batch_timer_ms=[t * 1e3 for t in step_timer],
                  seconds=time.perf_counter() - t_phase))
        del eng, batches, loader
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def host_sync_phase(torch, gpt, initialize, timer):
    """What a wait for the device in every step costs where the host can
    run ahead: gpt2-small (124 M parameters), bf16, batch 8 of 512 tokens,
    runs of 20 free-running steps (one wait at the end of each run), the
    engine's throughput meter reporting every 1000 steps (no wait inside
    the run) against every step (a wait at each step's end, what a meter
    that times each step costs), in 10 pairs, alternating which side runs
    first."""
    t_phase = time.perf_counter()
    S, B, steps = 512, 8, 20
    cfg = gpt.preset("gpt2-small", max_seq_len=S)
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng, _, _, _ = initialize(
        model=gpt.make_loss_fn(cfg), model_parameters=params,
        config={"train_batch_size": B, "steps_per_print": 1000,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
    del params
    batch = eng._to_device({"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S + 1)).astype(np.int32)})
    for _ in range(3):                  # warm-up
        eng.train_batch(batch)

    def run(every):
        eng.tput_timer = timer.ThroughputTimer(
            B, steps_per_output=every, logging_fn=lambda msg: None,
            device=eng.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = eng.train_batch(batch)
        torch.cuda.synchronize()
        check(np.isfinite(float(m["loss"])), f"host_sync: loss {m['loss']}")
        return (time.perf_counter() - t0) * 1e3 / steps
    ms = {1000: [], 1: []}
    for pair in range(10):
        for every in ((1000, 1) if pair % 2 == 0 else (1, 1000)):
            ms[every].append(run(every))
    cost = [w - f for w, f in zip(ms[1], ms[1000])]
    emit(dict(phase="host_sync", model="gpt2-small", batch=B, seq_len=S,
              steps_per_run=steps, ms_per_step_meter_every_1000=ms[1000],
              ms_per_step_meter_every_step=ms[1],
              median_ms_meter_every_1000=float(np.median(ms[1000])),
              median_ms_meter_every_step=float(np.median(ms[1])),
              quartile_spread_ms_meter_every_1000=float(
                  np.subtract(*np.percentile(ms[1000], [75, 25]))),
              pairs_waiting_slower=sum(c > 0 for c in cost),
              wait_cost_ms_per_step_median=float(np.median(cost)),
              seconds=time.perf_counter() - t_phase))
    del eng, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 4: block-sparse attention and BERT-large pretraining
# ---------------------------------------------------------------------------

def sparse_phase(torch, flash, paged, sa, DeepSpeedConfig):
    """The ``sparse_attention`` path at bert-large's attention width (16
    heads of 64; B = 4, S = 4096, bf16): the config section -> the engine
    config -> ``build_sparsity_config`` -> ``SparseSelfAttention``, then a
    forward and backward through 24 calls (bert-large's depth), for
    bidirectional and unidirectional attention. Each pass is run with the
    launch counters at 0 and read just after: K5 launches once per call.
    Returns the launch counts of the two passes together."""
    B, S, H, D, depth = 4, 4096, 16, 64, 24
    dev = torch.device("cuda")
    total = {}
    for attention in ("bidirectional", "unidirectional"):
        section = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
                   "num_global_blocks": 1, "attention": attention}
        ds = DeepSpeedConfig({"train_batch_size": B,
                              "sparse_attention": section})
        attn = sa.SparseSelfAttention(
            sa.build_sparsity_config(ds.sparse_attention, num_heads=H),
            max_seq_length=S)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        t0 = time.perf_counter()
        h = x
        for _ in range(depth):         # a residual stack kept at unit scale
            h = 0.5 * (h + attn(h, h, h))
        loss = h.float().square().mean()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        counts_fwd = kernel_launches(flash, paged)
        t0 = time.perf_counter()
        (gx,) = torch.autograd.grad(loss, (x,))
        torch.cuda.synchronize()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_launches(flash, paged)
        check(counts["K5"] == depth and counts_fwd["K5"] == depth
              and counts["K1-fwd"] == 0,
              f"sparse ({attention}): launches {counts}, expected K5 "
              f"{depth} (once per call, none in the gather backward)")
        check(tuple(h.shape) == (B, S, H, D)
              and bool(torch.isfinite(loss)) and
              bool(torch.isfinite(gx).all()) and gx.abs().max().item() > 0,
              f"sparse ({attention}): loss {loss.item()}, gradient finite "
              f"{bool(torch.isfinite(gx).all())}")
        _, lut, valid = attn.layout_for(S)
        emit(dict(phase="sparse", attention=attention, section=section,
                  shape=dict(B=B, S=S, H=H, D=D, calls=depth),
                  lut_slots=int(lut.shape[-1]),
                  mean_active_blocks_per_row=float(valid.sum(-1).mean()),
                  forward_ms=fwd_ms, backward_ms=bwd_ms,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=loss.item(), launches=counts))
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        del attn, x, h, loss, gx
        torch.cuda.empty_cache()
    return total


def mlm_batch(rng, vocab, B, S):
    """Seeded MLM pretraining rows: 15% of the tokens labelled, NSP labels,
    token types (segment B from a seeded split), and a quarter of the rows
    with a padded tail in ``attention_mask`` (their tail unlabelled)."""
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    types = (np.arange(S)[None] >= rng.integers(S // 4, 3 * S // 4,
                                                (B, 1))).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(0, B, 4):
        mask[b, rng.integers(S // 2, S):] = 0
    labels = np.where((rng.random((B, S)) < 0.15) & (mask > 0), tokens, -1)
    return {"tokens": tokens, "mlm_labels": labels.astype(np.int32),
            "token_type_ids": types, "attention_mask": mask,
            "nsp_labels": rng.integers(0, 2, B).astype(np.int32)}


def bert_phase(torch, flash, paged, bert, initialize):
    """BERT-large pretraining at full width and depth (24 layers, d_model
    1024, 16 heads of 64, vocab 30522, random weights from seed 0), the
    JAX package's ``tools/bert_bench.py`` headline: seq 512, batch 32,
    bf16, AdamW lr 1e-4, ZeRO stage 1, full checkpointing, the chunked
    loss; 1 warm-up and 5 steps on one repeated batch. Then LAMB with fp32
    masters, the selective policy and dropout 0.1 (attention takes the
    masked softmax, as the layer routes it), batch 16, and one SQuAD step.
    Returns the launch counts of the first run."""
    S, L = 512, 24
    runs = (
        dict(name="bf16, AdamW, ZeRO stage 1, full remat, chunked loss",
             batch=32, policy="full", dropout=0.0,
             optimizer={"type": "AdamW", "params": {"lr": 1e-4}},
             config={"zero_optimization": {"stage": 1}}),
        dict(name="bf16, LAMB, fp32 masters, selective remat, dropout 0.1",
             batch=16, policy="selective", dropout=0.1,
             optimizer={"type": "LAMB", "params": {"lr": 1e-4,
                                                   "weight_decay": 0.01}},
             config={}),
    )
    main_launches = None
    for run in runs:
        cfg = bert.preset("bert-large", max_seq_len=S, dropout=run["dropout"],
                          dtype=torch.bfloat16, remat=True,
                          remat_policy=run["policy"], loss_chunk=2048)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) ==
              (L, 1024, 16, 30522), "bert-large preset changed")
        B = run["batch"]
        batch = mlm_batch(np.random.default_rng(0), cfg.vocab_size, B, S)
        config = {"train_batch_size": B, "bf16": {"enabled": True},
                  "optimizer": run["optimizer"], "steps_per_print": 1000,
                  **run["config"]}
        t0 = time.perf_counter()
        params = bert.init_params(cfg, seed=0)
        eng, _, _, _ = initialize(model=bert.make_loss_fn(cfg),
                                  model_parameters=params, config=config)
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = eng._to_device(batch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        ms, losses = run_steps(torch, eng, batch, 5, 1)
        counts = kernel_launches(flash, paged)
        n = 6
        if run["dropout"] == 0.0:
            want = {"K1-fwd": 2 * L * n, "K2-dq": L * n, "K2-dkv": L * n}
        else:
            want = {"K1-fwd": 0, "K2-dq": 0, "K2-dkv": 0}
        check(all(counts[k] == v for k, v in want.items())
              and counts["K3"] == counts["K5"] == 0,
              f"bert ({run['name']}): launches {counts}, expected {want} "
              f"and no K3, K5")
        check(losses[-1] < losses[0],
              f"bert ({run['name']}): the loss did not fall on the "
              f"repeated batch: {losses}")
        step_ms = float(np.median(ms))
        flops = bert.train_flops_per_sample(cfg, S) * B
        emit(dict(phase="bert", model="bert-large", layers=L,
                  params=eng.num_parameters, run=run["name"], batch=B,
                  seq_len=S, padded_rows=int((batch["attention_mask"]
                                              .min(-1).values == 0).sum()),
                  init_s=init_s, step_ms=ms, step_ms_median=step_ms,
                  samples_per_s=B / step_ms * 1e3,
                  mfu_vs_989_tflops=flops / (step_ms / 1e3) / 989e12,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=losses, launches=counts))
        if main_launches is None:
            main_launches = counts
            train_trace(torch, eng, batch, "one training step, bert-large, "
                        "bf16, AdamW, full remat, batch 32 x 512, a quarter "
                        "of the rows padded", phase="bert_trace")
        del eng, batch
        torch.cuda.empty_cache()

    # one SQuAD fine-tuning step on the second run's configuration
    params = bert.init_params(cfg, seed=0)
    params["qa"] = bert.init_squad_head(cfg, seed=1)
    eng, _, _, _ = initialize(model=bert.make_squad_loss_fn(cfg),
                              model_parameters=params, config=config)
    del params
    rng = np.random.default_rng(1)
    squad = {k: v for k, v in mlm_batch(rng, cfg.vocab_size, B, S).items()
             if k in ("tokens", "token_type_ids", "attention_mask")}
    squad["start_positions"] = rng.integers(0, S // 2, B).astype(np.int32)
    squad["end_positions"] = squad["start_positions"] + rng.integers(
        0, 30, B).astype(np.int32)
    m = eng.train_batch(squad)
    loss = float(m["loss"])
    check(np.isfinite(loss) and np.isfinite(float(m["grad_norm"])),
          f"bert squad step: loss {loss}")
    emit(dict(phase="bert_squad", model="bert-large", batch=B, seq_len=S,
              optimizer="LAMB", loss=loss, grad_norm=float(m["grad_norm"])))
    del eng
    torch.cuda.empty_cache()
    return main_launches


def bert_parity_phase(torch, bert, tree):
    """The card (the flash kernels, non-causal with the padding mask as
    their key mask) against the host (their plain versions), float32,
    bert-large width at 2 layers: the MLM+NSP loss and every gradient leaf
    of an unpadded and a padded batch, dense and chunked loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S, B = 256, 2
    worst = {}
    for name, chunk, pad in (("unpadded, dense loss", 0, False),
                             ("padded, chunked loss", 200, True)):
        cfg = bert.preset("bert-large", n_layers=2, max_seq_len=S,
                          dropout=0.0, dtype=torch.float32, loss_chunk=chunk)
        batch = mlm_batch(np.random.default_rng(5), cfg.vocab_size, B, S)
        if not pad:
            batch["attention_mask"][:] = 1
        host = bert.init_params(cfg, seed=4, device="cpu")
        grads = {}
        for dev in ("cpu", "cuda"):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in tree.tree_leaves(host)]
            params = tree.tree_unflatten(host, leaves)
            loss = bert.loss_fn(params, {k: torch.as_tensor(v).to(dev)
                                         for k, v in batch.items()},
                                None, cfg)
            grads[dev] = (loss.item(), [g.cpu() for g in
                                        torch.autograd.grad(loss, leaves)])
        (lh, gh), (lc, gc) = grads["cpu"], grads["cuda"]
        rel = max([abs(lc - lh) / abs(lh)]
                  + [((c - h).abs().max() / h.abs().max()).item()
                     for c, h in zip(gc, gh)])
        check(np.isfinite(lc) and rel <= 1e-3,
              f"bert parity ({name}): card vs host loss {lc} vs {lh}, "
              f"worst relative gradient error {rel}")
        worst[name] = rel
    emit(dict(phase="bert_parity", model="bert-large width, 2 layers",
              dtype="float32", batch=B, seq_len=S,
              worst_relative_loss_or_gradient=worst, tol=1e-3))


# bf16 training check, leaf by leaf: on the loss and on every gradient
# leaf, the card's distance from float32 (relative for the loss, max-abs
# relative to the leaf's largest entry for a gradient) is held to
# BF16_FACTOR times the host's own bf16 distance on that same leaf, plus
# BF16_FLOOR (~5 bf16 roundings of the leaf's largest entry) for leaves
# that bf16 happens to leave almost exact. The host's bf16 distance is
# what rounding costs: it differs by leaf by two orders (bert-large's
# token-type embedding gradient, a sum over every position that mostly
# cancels, reaches ~0.12), so one limit over all leaves would be as loose
# as the worst of them.
BF16_FACTOR = 2.0
BF16_FLOOR = 0.01
# the leaves whose gradients pass through K2 (q/k/v projection) and
# through K1-fwd's output alone (the attention's output projection)
ATTENTION_LEAVES = ("block/qkv/", "block/attn_out/")


def leaf_paths(tree):
    """'/'-joined key paths of a nested dict, in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [""]
    return [f"{k}/{p}".rstrip("/") for k in sorted(tree)
            for p in leaf_paths(tree[k])]


def loss_and_grads(torch, tree, loss_of, host, dev):
    """(loss, every gradient leaf as float32 on the host) of
    ``loss_of(params, dev)`` at ``host``'s parameters moved to ``dev``."""
    leaves = [t.detach().to(dev).requires_grad_()
              for t in tree.tree_leaves(host)]
    loss = loss_of(tree.tree_unflatten(host, leaves), dev)
    return loss.item(), [g.float().cpu() for g in
                         torch.autograd.grad(loss, leaves)]


def distances(got, ref):
    """[the loss's relative error] + each gradient leaf's max-abs error
    relative to that leaf's largest entry."""
    (lg, gg), (lr, gr) = got, ref
    return [abs(lg - lr) / abs(lr)] + [
        ((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gg, gr)]


def bf16_parity_phase(torch, flash, paged, gpt, bert, tree):
    """The tensor-core designs inside the training models: gpt2-1.5b
    and bert-large width at 2 layers, the loss and every gradient leaf in
    bf16 on the card (K1-fwd, K2-dq and K2-dkv on the tensor cores) against
    float32 on the host (plain versions) at the same weights. The host
    also runs the same bf16 model: its distance from float32 on each leaf
    is what bf16 rounding itself costs there (weights, activations, p and
    ds rounded at the same places), and the card's distance on that leaf
    is held to BF16_FACTOR times it (the kernels sum in another order:
    noise of the same size) plus BF16_FLOOR. The present ``train_parity``
    and ``bert_parity`` run in float32, which takes the CUDA-core
    designs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S, B = 256, 2
    gpt_batch = {"tokens": np.random.default_rng(6).integers(
        1, 50304, (B, S + 1)).astype(np.int32)}
    bert_batch = mlm_batch(np.random.default_rng(7), 30522, B, S)
    out = {}
    for name in ("gpt2-1.5b", "bert-large"):
        def loss_of(dtype, name=name):
            def fn(params, dev):
                if name == "gpt2-1.5b":
                    cfg = gpt.preset(name, n_layers=2, max_seq_len=S + 1,
                                     dtype=dtype)
                    return gpt.loss_fn(params, {
                        k: torch.as_tensor(v).to(dev)
                        for k, v in gpt_batch.items()}, None, cfg)
                cfg = bert.preset(name, n_layers=2, max_seq_len=S,
                                  dropout=0.0, dtype=dtype)
                return bert.loss_fn(params, {
                    k: torch.as_tensor(v).to(dev)
                    for k, v in bert_batch.items()}, None, cfg)
            return fn
        if name == "gpt2-1.5b":
            host = gpt.init_params(gpt.preset(name, n_layers=2,
                                              max_seq_len=S + 1),
                                   seed=4, device="cpu", dtype=torch.float32)
        else:
            host = bert.init_params(bert.preset(name, n_layers=2,
                                                max_seq_len=S),
                                    seed=4, device="cpu")
        # the weights rounded to bf16 once; float32 computes on the same
        # values
        rounded = [t.to(torch.bfloat16) for t in tree.tree_leaves(host)]
        w16 = tree.tree_unflatten(host, rounded)
        w32 = tree.tree_unflatten(host, [t.float() for t in rounded])
        truth = loss_and_grads(torch, tree, loss_of(torch.float32), w32,
                               "cpu")
        host_bf16 = loss_and_grads(torch, tree, loss_of(torch.bfloat16),
                                   w16, "cpu")
        reset_launches(flash, paged)
        card = loss_and_grads(torch, tree, loss_of(torch.bfloat16), w16,
                              "cuda")
        counts = kernel_launches(flash, paged)
        names = ["loss"] + leaf_paths(host)
        d_card, d_host = distances(card, truth), distances(host_bf16, truth)
        ratio = [c / (BF16_FACTOR * h + BF16_FLOOR)
                 for c, h in zip(d_card, d_host)]
        worst = int(np.argmax(ratio))
        attn = max((i for i, n in enumerate(names)
                    if n.startswith(ATTENTION_LEAVES)), key=lambda i: ratio[i])
        out[name] = dict(
            loss_host_fp32=truth[0], loss_card_bf16=card[0],
            loss_host_bf16=host_bf16[0],
            card_bf16_vs_host_fp32=max(d_card),
            host_bf16_vs_host_fp32=max(d_host),
            worst_leaf=dict(name=names[worst], card=d_card[worst],
                            host=d_host[worst], of_limit=ratio[worst]),
            worst_attention_leaf=dict(name=names[attn], card=d_card[attn],
                                      host=d_host[attn], of_limit=ratio[attn]),
            leaves={n: [c, h] for n, c, h in zip(names, d_card, d_host)},
            launches={k: counts[k] for k in ("K1-fwd", "K2-dq", "K2-dkv")})
    emit(dict(phase="bf16_parity", models="gpt2-1.5b and bert-large width, "
              "2 layers", batch=B, seq_len=S,
              design={k: flash.DESIGN[(k, torch.bfloat16)]
                      for k in ("K1-fwd", "K2-dq", "K2-dkv")},
              factor=BF16_FACTOR, floor=BF16_FLOOR,
              leaves_are="[card bf16, host bf16] distance from host float32",
              **out))
    for name, r in out.items():
        check(all(n > 0 for n in r["launches"].values()),
              f"bf16 parity ({name}): the card run did not launch every "
              f"flash kernel: {r['launches']}")
        w = r["worst_leaf"]
        check(np.isfinite(r["loss_card_bf16"]) and w["of_limit"] <= 1.0,
              f"bf16 parity ({name}): {w['name']}: card bf16 vs host "
              f"float32 {w['card']}, above {BF16_FACTOR} x the host's own "
              f"bf16 distance {w['host']} + {BF16_FLOOR}")


# ---------------------------------------------------------------------------
# --ab: the kernels of two checkouts, timed the same way
# ---------------------------------------------------------------------------

def bs_ab_cases(torch, F, sa):
    """K5 at the sparse path's shape (the fixed layout, bidirectional and
    unidirectional) and at BigBird's (S = 2048, global rows), bf16: the
    rows ``--ab`` times."""
    bf16 = torch.bfloat16
    fixed = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
             "num_global_blocks": 1, "attention": "bidirectional"}
    return [
        bs_case(torch, F, sa, "bert-large sparse, fixed bidirectional",
                fixed, 4, 4096, 16, 64, bf16),
        bs_case(torch, F, sa, "fixed unidirectional",
                dict(fixed, attention="unidirectional"), 4, 4096, 16, 64,
                bf16),
        bs_case(torch, F, sa, "bigbird", {"mode": "bigbird", "block": 16,
                                          "num_random_blocks": 1}, 2, 2048,
                16, 64, bf16)]


SPREAD = [5, 16, 100, 511, 1024, 1535, 1600, 2047]   # partial/mid/full
# K4's llama-7b projections (qkv, attn_out, mlp_in = mlp_gate, mlp_out)
PROJ = (("qkv", 4096, 12288), ("attn_out", 4096, 4096),
        ("mlp_in", 4096, 11008), ("mlp_out", 11008, 4096))
LAYER = ("qkv", "attn_out", "mlp_in", "mlp_in", "mlp_out")


def k4_layer_row(k4, M):
    """One llama-7b layer of K4 at M rows: the five launches of a block
    (mlp_gate has mlp_in's shape), summed, as a ``kernel`` row."""
    layer = [k4[M, n] for n in LAYER]
    row = dict(phase="kernel", kernel="K4",
               case=f"llama-7b layer (qkv, attn_out, mlp_in, mlp_gate, "
                    f"mlp_out), M={M}", dtype="bfloat16",
               bound_by=layer[0]["bound_by"], timed_by="graph",
               library_timed_by="graph",
               **{k: sum(r[k] for r in layer) for k in (
                   "kernel_ms", "plain_ms", "library_ms", "bound_us")})
    row["max_abs_err"] = max(r["max_abs_err"] for r in layer)
    flops = sum(2.0 * M * r["shape"]["K"] * r["shape"]["N"] for r in layer)
    row.update(tflops=flops / row["kernel_ms"] / 1e9,
               vs_library=row["kernel_ms"] / row["library_ms"])
    emit(row)
    return row


def decode_ab_cases(torch, F, paged, gpt, int8mm):
    """K3 and K3-int8 at the llama-7b decode shape (8 slots of lengths
    5-2047, 32 heads of 128, block 16, bf16), then K4 at the llama-7b
    projections at M = 8 (decode slots), 1 and 256 (a prefill chunk), and
    the M = 8 and M = 256 layers summed: the rows the main run and
    ``--ab`` both time, in this order."""
    bf16 = torch.bfloat16
    k3 = paged_case(torch, F, paged, gpt, "llama-7b decode", 8, 32, 1, 128,
                    16, SPREAD, bf16)
    k3_int8 = paged_case(torch, F, paged, gpt, "llama-7b decode", 8, 32, 1,
                         128, 16, SPREAD, bf16, int8=True)
    k4 = {}
    for M in (8, 1, 256):
        for pname, K, N in PROJ:
            k4[M, pname] = int8mm_case(torch, int8mm,
                                       f"llama-7b {pname}, M={M}", M, K, N,
                                       bf16)
    return k3, k3_int8, k4, k4_layer_row(k4, 8), k4_layer_row(k4, 256)


def ab_run(tree):
    """One side of ``--ab``: ``flash_main_cases``, ``decode_ab_cases`` and
    ``bs_ab_cases`` of this script (its cases, checks and timers) on the
    kernels of the checkout at ``tree``, built into that checkout's own
    ``build/``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import int8_matmul as int8mm
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.attention import flash, paged
    for mod in (flash, sa, paged, int8mm):
        check(mod.__file__.startswith(tree + os.sep),
              f"--ab: imported {mod.__file__}, not the checkout at {tree}")
    info = _build.build(["flash_fwd", "flash_bwd", "blocksparse_fwd",
                         "paged_decode", "int8_matmul"])
    emit(dict(phase="env", tree=tree, gpu=gpu_line(),
              build={n: ptxas_summary(i["ptxas"]) for n, i in info.items()}))
    flash_main_cases(torch, F, flash)
    decode_ab_cases(torch, F, paged, gpt, int8mm)
    bs_ab_cases(torch, F, sa)
    return 0


def ab_main(other):
    """Times K1-fwd, K2, K3, K3-int8, K4 and K5 at the main paths' shapes
    on the kernels of the checkout at ``other`` (A) and of this one (B), in
    turns A B B A, each in a process of its own, all through this script's
    cases and timers, so that the two sides differ only in their kernels.
    Prints each run's lines, then one line per row: both sides' times, the
    timer of each run and B / A."""
    runs = []
    for tree in (other, REPO, REPO, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-run", tree], capture_output=True,
                             text=True, timeout=1200)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append([json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{"phase": "kernel"')])
    for a1, b1, b2, a2 in zip(*runs):
        a_ms = [a1["kernel_ms"], a2["kernel_ms"]]
        b_ms = [b1["kernel_ms"], b2["kernel_ms"]]
        emit(dict(phase="ab", kernel=a1["kernel"], case=a1["case"],
                  a=os.path.abspath(other), a_design=a1.get("design"),
                  b_design=b1.get("design"), a_ms=a_ms, b_ms=b_ms,
                  timed_by=[r.get("timed_by") for r in (a1, b1, b2, a2)],
                  library_ms=[r["library_ms"] for r in (a1, b1, b2, a2)],
                  b_over_a=sum(b_ms) / sum(a_ms)))
    print(gpu_line(), flush=True)
    return 0


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from deepspeed_tpu_torch import init_inference, initialize, tree
    from deepspeed_tpu_torch.inference import serving
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import int8_matmul as int8mm
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.attention import flash, paged
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    from deepspeed_tpu_torch.runtime import dataloader
    from deepspeed_tpu_torch.runtime import progressive_layer_drop as pld_lib
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.dataloader import pack_documents
    from deepspeed_tpu_torch.utils import timer

    t_start = time.perf_counter()
    card = gpu_line()
    info = _build.build()
    emit(dict(phase="env", gpu=card, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              device_count=torch.cuda.device_count(),
              build={n: dict(seconds=i["seconds"],
                             kernels=ptxas_summary(i["ptxas"]))
                     for n, i in info.items()}))
    # the tensor-core K2-dq and K5 keep their registers: no spill at head
    # dims 64 and 128 (a cached build has no report to read)
    for lib, kernel in (("flash_bwd", "flash_bwd_dq_mma_kernel"),
                        ("blocksparse_fwd", "blocksparse_fwd_mma_kernel")):
        if info[lib]["ptxas"] == "(cached)":
            continue
        report = ptxas_summary(info[lib]["ptxas"])
        for d in (64, 128):
            found = {n: r for n, r in report.items()
                     if n.startswith(f"{kernel}<bf16,{d}")}
            check(found and all(r.get("spill_bytes", 0) == 0
                                for r in found.values()),
                  f"{kernel} at head dim {d}: ptxas reports {found}")
    # K3 and K4 likewise, every instance they build: K3
    # by q dtype, pool type, head dim and row capacity, K4's wgmma kernel
    # by rows of x per CTA
    want = {"paged_decode": [
        f"paged_split_kernel<{t},{k or t},{d},{rt}>" for t in ("f32", "bf16")
        for k in ("", "int8") for d in (64, 128) for rt in (1, 4, 16)] + [
        f"paged_combine_kernel<{t},{d}>" for t in ("f32", "bf16")
        for d in (64, 128)],
        "int8_matmul": ["i8mm_dec_kernel", "i8mm_wg_kernel<128>",
                        "i8mm_wg_kernel<256>"]}
    for lib, names in want.items():
        if info[lib]["ptxas"] == "(cached)":
            continue
        report = ptxas_summary(info[lib]["ptxas"])
        bad = {n: report.get(n) for n in names
               if n not in report or report[n].get("spill_bytes", 0) != 0}
        check(not bad, f"{lib}: missing or spilling in ptxas's report: {bad}")

    bf16, f32 = torch.bfloat16, torch.float32
    main_rows = flash_main_cases(torch, F, flash)
    k1, k1_train, k1_bert = (main_rows[k] for k in ("llama", "gpt2", "bert"))
    k2_dq, k2_dkv = main_rows["gpt2 bwd"]
    k2_bert = main_rows["bert bwd"]
    flash_case(torch, F, flash, "llama-7b prefill, 2 segments", 4, 512, 32, 32,
               128, bf16, n_seg=2)
    flash_case(torch, F, flash, "gqa", 4, 512, 32, 8, 128, bf16)
    flash_case(torch, F, flash, "left-pad kv_mask", 4, 512, 32, 32, 128,
               bf16, pad=[0, 17, 200, 511])
    flash_case(torch, F, flash, "window", 2, 1024, 32, 32, 128, bf16,
               window=256)
    flash_case(torch, F, flash, "head_dim 64", 4, 512, 16, 16, 64, bf16)
    flash_case(torch, F, flash, "float32", 1, 512, 32, 32, 128, f32, iters=5)
    flash_case(torch, F, flash, "gpt2-1.5b train, 4 segments", 16, 1024, 25,
               25, 64, bf16, n_seg=4, iters=10)
    flash_case(torch, F, flash, "segments, GQA, window, float32", 2, 300, 8,
               2, 64, f32, window=100, n_seg=3, iters=5)
    flash_bwd_case(torch, F, flash, "gpt2-1.5b train, 4 segments", 16, 1024,
                   25, 25, 64, bf16, n_seg=4)
    flash_bwd_case(torch, F, flash, "llama-7b width", 2, 2048, 32, 32, 128,
                   bf16)
    flash_bwd_case(torch, F, flash, "gqa", 2, 2048, 32, 8, 128, bf16)
    flash_bwd_case(torch, F, flash, "window", 2, 2048, 32, 32, 128, bf16,
                   window=256)
    flash_bwd_case(torch, F, flash, "left-pad kv_mask", 4, 512, 32, 32, 128,
                   bf16, pad=[0, 17, 200, 511])
    flash_bwd_case(torch, F, flash, "float32, ragged S, segments", 2, 500, 8,
                   4, 64, f32, n_seg=3, iters=5)
    k3, k3_int8, k4, k4_layer, k4_prefill = decode_ab_cases(
        torch, F, paged, gpt, int8mm)
    spread = SPREAD
    paged_case(torch, F, paged, gpt, "gqa", 8, 8, 4, 128, 16, spread, bf16)
    paged_case(torch, F, paged, gpt, "window", 8, 32, 1, 128, 16, spread,
               bf16, window=300)
    paged_case(torch, F, paged, gpt, "verify q_len=4", 8, 8, 4, 128, 16,
               [x - 4 for x in spread[1:]] + [2044], bf16, q_len=4)
    paged_case(torch, F, paged, gpt, "float32 head_dim 64", 4, 8, 2, 64, 16,
               [3, 700, 1500, 2047], f32)
    paged_case(torch, F, paged, gpt, "gqa", 8, 8, 4, 128, 16, spread, bf16,
               int8=True)
    paged_case(torch, F, paged, gpt, "window", 8, 32, 1, 128, 16, spread,
               bf16, window=300, int8=True)
    paged_case(torch, F, paged, gpt, "verify q_len=4", 8, 8, 4, 128, 16,
               [x - 4 for x in spread[1:]] + [2044], bf16, q_len=4, int8=True)
    paged_case(torch, F, paged, gpt, "float32 head_dim 64", 4, 8, 2, 64, 16,
               [3, 700, 1500, 2047], f32, int8=True)
    int8mm_case(torch, int8mm, "llama-7b qkv, M=8, float32", 8, 4096, 12288,
                f32, iters=10)
    int8mm_case(torch, int8mm, "ragged M=37 K=1000 N=1000", 37, 1000, 1000,
                bf16)
    int8mm_case(torch, int8mm, "generate prompt, qkv M=2048", 2048, 4096,
                12288, bf16, iters=10)
    # K5 at the sparse path's shape (bert-large attention, the JAX and
    # reference default fixed layout, S = 4096), its causal mode, the other
    # layout families (at S <= 2048: BigBird's and BSLongformer's global
    # rows attend every block, and the gather version's temporaries grow
    # with the longest row), blocks 16 and 64, head dims 32, 64 and 128,
    # bf16 and float32
    fixed = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
             "num_global_blocks": 1, "attention": "bidirectional"}
    k5, k5_uni, k5_bigbird = bs_ab_cases(torch, F, sa)
    bs_case(torch, F, sa, "bslongformer", {"mode": "bslongformer",
                                           "block": 16}, 2, 2048, 16, 64,
            bf16)
    bs_case(torch, F, sa, "variable", {
        "mode": "variable", "block": 16, "num_random_blocks": 2,
        "local_window_blocks": [4], "global_block_indices": [0]}, 2, 2048,
        16, 64, bf16)
    bs_case(torch, F, sa, "fixed, block 64, head dim 128",
            dict(fixed, block=64), 2, 2048, 8, 128, bf16)
    bs_case(torch, F, sa, "fixed unidirectional, head dim 32, float32",
            dict(fixed, attention="unidirectional"), 2, 1024, 8, 32, f32)
    bs_case(torch, F, sa, "variable unidirectional, block 64, float32", {
        "mode": "variable", "block": 64, "num_random_blocks": 1,
        "attention": "unidirectional"}, 1, 1024, 4, 64, f32)

    launches = serve_phase(torch, flash, paged, gpt, init_inference, serving)
    agreement_phase(torch, gpt, init_inference, serving)
    int8_launches = serve_int8_phase(torch, flash, paged, gpt, init_inference,
                                     serving)
    parity_phase(torch, gpt, InferenceEngine)
    parity_int8_phase(torch, gpt, InferenceEngine)
    train_launches = train_phase(torch, flash, paged, gpt, initialize,
                                 pack_documents)
    remat_phase(torch, gpt, initialize, tree)
    train_parity_phase(torch, gpt, initialize, pack_documents, tree)
    resume_launches = resume_phase(torch, flash, paged, gpt, initialize,
                                   init_inference, serving, tree, ckpt)
    features_launches = train_features_phase(
        torch, flash, paged, gpt, initialize, dataloader, pld_lib)
    host_sync_phase(torch, gpt, initialize, timer)
    sparse_launches = sparse_phase(torch, flash, paged, sa, DeepSpeedConfig)
    bert_launches = bert_phase(torch, flash, paged, bert, initialize)
    bert_parity_phase(torch, bert, tree)
    bf16_parity_phase(torch, flash, paged, gpt, bert, tree)

    # every kernel at the shape of the path that drives it: K1-fwd and K2
    # at the gpt2-1.5b training shape with the training run's launch
    # counts (their BERT shape and count ride along), K3 at the llama-7b
    # decode shape with the serving drain's, K4 (one decode layer; the
    # prefill chunk's layer rides along) and K3-int8 with the int8
    # drain's, K5 at the sparse path's shape with its two passes' count;
    # K1-fwd's serving shape and its count in generate ride along
    fwd_src = "deepspeed_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "deepspeed_tpu_torch/csrc/flash_bwd.cu"
    jflash = "deepspeed_tpu/ops/attention/flash.py"
    kernels = []
    for row, src, rep, n in (
            (k1_train, fwd_src, f"{jflash}:142", train_launches["K1-fwd"]),
            (k2_dq, bwd_src, f"{jflash}:380", train_launches["K2-dq"]),
            (k2_dkv, bwd_src, f"{jflash}:317", train_launches["K2-dkv"]),
            (k3, "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139", launches["K3"]),
            (k4_layer, "deepspeed_tpu_torch/csrc/int8_matmul.cu",
             "deepspeed_tpu/ops/int8_matmul.py:33", int8_launches["K4"]),
            (k3_int8, "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139",
             int8_launches["K3-int8"]),
            (k5, "deepspeed_tpu_torch/csrc/blocksparse_fwd.cu",
             "deepspeed_tpu/ops/sparse_attention/blocksparse.py:148",
             sparse_launches["K5"])):
        check(n > 0, f"{row['kernel']} was never launched on its path")
        kernels.append(dict(
            name=row["kernel"], route="cuda", source=src, replaces=rep,
            launches=n, max_abs_err=row["max_abs_err"],
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_us"] / 1e3, bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["case"]))
        kernels[-1].update(timed_by=row["timed_by"],
                           vs_library=row["vs_library"])
        if "design" in row:     # K1-fwd, K2 and K5: the design that ran
            kernels[-1].update(design=row["design"], tflops=row["tflops"])
        if "gb_per_s" in row:   # K3 and K3-int8
            kernels[-1].update(gb_per_s=row["gb_per_s"])
    # the slice-5 paths: training with the curriculum and layer drop, and
    # serving from the resumed checkpoint
    for i, name in enumerate(("K1-fwd", "K2-dq", "K2-dkv")):
        kernels[i].update(launches_in_train_features=features_launches[name])
    kernels[0].update(launches_serving_from_checkpoint=resume_launches[
        "K1-fwd"])
    kernels[3].update(launches_serving_from_checkpoint=resume_launches["K3"])
    kernels[0].update(launches_in_generate=launches["K1-fwd"],
                      serving_shape=k1["case"], serving_ms=k1["kernel_ms"],
                      serving_bound_ms=k1["bound_us"] / 1e3,
                      serving_plain_ms=k1["plain_ms"],
                      serving_library_ms=k1["library_ms"],
                      serving_tflops=k1["tflops"],
                      serving_vs_library=k1["vs_library"],
                      serving_timed_by=k1["timed_by"])
    for i, (name, row) in enumerate(zip(("K1-fwd", "K2-dq", "K2-dkv"),
                                        (k1_bert, *k2_bert))):
        check(bert_launches[name] > 0, f"{name} was never launched on the "
              f"BERT path")
        kernels[i].update(launches_in_bert=bert_launches[name],
                          bert_shape=row["case"],
                          bert_max_abs_err=row["max_abs_err"],
                          bert_ms=row["kernel_ms"],
                          bert_bound_ms=row["bound_us"] / 1e3,
                          bert_bound_by=row["bound_by"],
                          bert_plain_ms=row["plain_ms"],
                          bert_library_ms=row["library_ms"],
                          bert_tflops=row["tflops"],
                          bert_vs_library=row["vs_library"])
    # K4: the prefill chunk's layer (M = 256) beside the decode layer
    kernels[4].update(launches_in_generate=int8_launches["K4-generate"],
                      tflops=k4_layer["tflops"],
                      prefill_shape=k4_prefill["case"],
                      prefill_max_abs_err=k4_prefill["max_abs_err"],
                      prefill_ms=k4_prefill["kernel_ms"],
                      prefill_plain_ms=k4_prefill["plain_ms"],
                      prefill_library_ms=k4_prefill["library_ms"],
                      prefill_bound_ms=k4_prefill["bound_us"] / 1e3,
                      prefill_bound_by=k4_prefill["bound_by"],
                      prefill_tflops=k4_prefill["tflops"],
                      prefill_vs_library=k4_prefill["vs_library"])
    # K5: the work list of its main shape, and its causal and BigBird
    # shapes beside it
    kernels[6].update(split_groups=k5.get("split_groups"),
                      ctas_per_batch_row=k5.get("ctas_per_batch_row"))
    for tag, row in (("unidirectional", k5_uni), ("bigbird", k5_bigbird)):
        kernels[6].update({
            f"{tag}_shape": row["case"], f"{tag}_ms": row["kernel_ms"],
            f"{tag}_library_ms": row["library_ms"],
            f"{tag}_bound_ms": row["bound_us"] / 1e3,
            f"{tag}_tflops": row["tflops"],
            f"{tag}_vs_library": row["vs_library"],
            f"{tag}_split_groups": row.get("split_groups")})
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-run"] and len(sys.argv) == 3:
        sys.exit(ab_run(sys.argv[2]))
    if len(sys.argv) > 1:
        sys.exit("usage: python3 chip_smoke.py [--ab OTHER_CHECKOUT]")
    sys.exit(main())
