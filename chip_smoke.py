#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``netsdb_tpu_torch``) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py
(``--paged-only``: phases 1 and 7 alone, without the contract's last
line, to compare the paged path of two trees; ``--models-only``: phases
1 and 8 alone, the same way; ``--train-la-only``: phases 1, 9 and 10;
``--relational-only``: phases 1 and 11.)

Phases (any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``netsdb_tpu_torch/csrc``, one ``nvcc`` per source,
   all started together, each with its ptxas report (registers, shared
   memory, spills) and its count of tensor-core instructions (``HMMA``
   in ``cuobjdump -sass``), which must not be 0 for any kernel;
2. each kernel against its plain PyTorch version on the card, with its
   time, the plain version's, the library call's and the bounds (f32
   on the CUDA cores, and as three-pass TF32 on the tensor cores): B1
   (``flash_attention``) at the transformer layer's shape and edge
   shapes (d 64, d 40, d 18, a gcd block), B2 (``flash_attention_step``) as
   the ring's chained fold (bh 16, four chunks of 4096, D 128) and edge
   cases. Every f32 case is also held against an f64 attention over its
   first two (b, h) slices: the kernel's error there may be at most
   ``F64_RATIO`` times the plain version's;
3. FF inference through ``Client.execute_computations`` at bench.py's
   size (16384 x 1024 -> 4096 -> 1024, 512 x 512 blocks, f32), three
   requests, each checked against an f64 recomputation;
4. the transformer layer through the same path (embed 1024, 8 heads,
   batch 2, seq 4096, f32), three ``serve_forward`` requests, each
   checked against the layer run with the plain attention;
5. the sequence-parallel transformer layer through placed sets (embed
   1024, 8 heads, batch 2, seq 16384 sharded over ("sp", 4) virtual
   positions on card 0): three ``serve_forward`` requests, each
   launching B2 4 x 4 = 16 times and B1 never, checked against the
   single-device forward from unplaced sets, and the ring's attention
   core against the naive ring fold;
6. one more request of each model under ``torch.profiler``: the device
   time by kernel and the device's busy share;
7. the paged path: FF (w1 and wo paged) and the staged transformer layer
   (all four weights paged) at the sizes of phases 3 and 4, their
   weights streamed from a spilling page arena through pinned buffers
   and a copy stream. Per model a first, a cold (device cache cleared),
   three warm and one resident request: the paged outputs are held to
   the resident one, warm requests must read no page and stage no byte,
   and the staged layer must launch B1. Then a 12-page matrix through
   the pinned ring, bit for bit, and one cold request of each model under
   the profiler: the uploads' streams and source memory (pinned, or the
   phase fails), their rate and how much of their time kernels ran;
8. the other model families through ``Client()`` at the reference's
   benchmark widths (``MODEL_SIZES``), data made on the card from the
   seed: logistic regression (3 requests), word2vec (gather,
   ``lookup_sparse`` mean and the one-hot DAG, 3 each), the text
   classifier (the DAG and bag of words, 3 each), the LSTM (one ``step``
   through the store and 3 ``run_sequence`` of 16 steps, in f32 and in
   bf16) and conv2d in both modes (``CONV_REQUESTS`` VALID requests with
   bias and relu, the batch latency p50, and one SAME request at stride
   2). Each request prints its ms and rate and its max abs error against
   an f64 recomputation on the card, and fails above ``MODEL_TOLS``; one
   request of each model runs under the profiler (busy share, top three
   kernels). No hand-written kernel lies on this path;
9. training through the database (``TRAIN_SIZES``, f32): three chained
   ``train_step`` s each of FF (after an ``inference()``, on params read
   back from the store), the transformer layer and logistic regression,
   each step held to the same step recomputed in f64 on the card
   (``check_step``: every updated param within ``TRAIN_GRAD_TOL`` x lr x
   the f64 gradient's max |value| plus one f32 rounding, the loss within
   ``TRAIN_LOSS_RTOL``), with its ms, peak memory and errors; the layer's
   steps must launch B1 once each and move ``w_qkv``. Then
   ``graft_entry.dryrun_multichip(1)`` and one profiled step of each
   model, with B1's share of the layer's step;
10. the LA tasks at the reference's scale (X 200 000 x 1000, blocks
   1000, f32): ``LA_REQUESTS`` requests of each PDML program through
   ``compile_pdml``, each held to f64 at rtol = atol = 2e-4, their p50
   beside the reference's cluster seconds; the linreg program through
   ``LAInterpreter(client=Client())`` read back with
   ``get_set_iterator``; ``run_all``'s CUDA-event times; one profiled
   request of each task;
11. the columnar relational engine at TPC-H SF ``TPCH_SF`` (10: lineitem
   60 M rows, orders 15 M, partsupp 8 M, customer 1.5 M, part 2 M,
   supplier 100 k; about 3.3 GB of columns resident on the card): the
   engine's crossovers measured on the card (``tuning.autotune(persist=
   False)``, printed), the tables drawn from the seed on the host
   (``relational.bench.generate_host``) and sent with ``send_table`` to
   a card client and a CPU client. Per query, ``TPCH_REQUESTS`` requests
   of ``suite_sink_for`` through ``run_query`` for each of the ten, then
   of ``q01_sink``, ``q06_sink`` and ``q03_sink_for``; each request held
   to the CPU client's same sink (integers, keys, counts, minima and
   masks exactly; floats within ``TPCH_RTOL``; Q03's top 10 by key set
   wherever its 10th and 11th revenues differ by more than that), and
   Q01 and Q06 also to a float64 numpy oracle. Per query the p50 ms,
   lineitem rows/s, the bytes of the columns it reads over the card's
   memory rate (its bound), the CPU's ms, and for Q01, Q02 and Q04 the
   reference's cluster seconds beside them; one profiled request of
   each (busy share, top three kernels). No hand-written kernel lies on
   this path.

The kernels' launch counters are set to 0 just before phase 3 and read
just after phase 4 (the main path of FF and the layer), set to 0 again
just before phase 5's requests and read just after them, again
around each model's paged requests in phase 7, around phase 8, where
both must read 0, around phase 9 (B1 once a layer step, B2 never) and
around phase 10 and around phase 11 (both 0). The last line is the
contract's device record.
Without a CUDA card, or without the package beside it, it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

SEED = 0
F32_TOL = 1e-4    # kernel vs plain, f32: summation order differs over 4096 keys
# kernel vs plain, bf16: each row's largest error over that row's largest
# |value|. Both round the output to bf16 (one ulp is at most 2**-7 of the
# value) and round P to bf16 against a running maximum that differs with
# the tiling; two ulps allow for both. A dropped or doubled key tile moves
# a late row by several times this.
BF16_ROW_TOL = 2.0 ** -6
BF16_TOL = 2e-2   # and, as for f32, an absolute limit
FF_TOL = 1e-4     # FF probabilities vs the f64 recomputation
LAYER_TOL = 1e-3  # transformer layer: kernel vs plain attention inside it
SP_TOL = 1e-3     # sequence-parallel layer vs the single-device layer
SP_POSITIONS = 4  # ring positions of phase 5, all on card 0
# phase 7: 3 MiB pages make every weight's row block a multiple of 64 rows
# (w1 768, wo 192, w_qkv 256, ...); a 24 MiB arena holds less than either
# model's weights (32 and 48 MiB), so it spills
PAGE_BYTES = 3 << 20
POOL_BYTES = 24 << 20
PAGED_FF_TOL = FF_TOL        # paged FF vs the resident request
PAGED_LAYER_TOL = LAYER_TOL  # staged paged layer vs the resident layer
PCIE_GBPS = 64.0  # PCIe Gen5 x16, nominal per direction
# f32 cases, against an f64 attention: the kernel's max abs error over at
# most this many times the plain version's. Three-pass TF32 is about as
# accurate as f32 (PERF.md); one pass would read about 1000 times.
F64_RATIO = 4.0

# data-sheet peaks (dense) and memory rates; the PCIe card is chosen by name
# (float32 on the CUDA cores, tf32 and bfloat16 on the tensor cores)
PEAKS = {"sxm": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                 "bytes": 3.35e12},
         "pcie": {"float32": 51e12, "tf32": 378e12, "bfloat16": 756e12,
                  "bytes": 2.0e12}}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds_ms(flops, nbytes, dtype_name, pk) -> tuple:
    """(bound ms, what bounds it, three-pass TF32 bound ms or None): the
    larger of the bytes over the memory rate and the operations over the
    peak of their type; for f32 once on the CUDA cores and once as three
    TF32 products on the tensor cores, the route the kernels take."""
    t_bytes = nbytes / pk["bytes"] * 1e3
    t_ops = flops / pk[dtype_name] * 1e3
    bound = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    tf32 = (max(3 * flops / pk["tf32"] * 1e3, t_bytes)
            if dtype_name == "float32" else None)
    return bound + (tf32,)


def attention_bound_ms(b, h, s, d, causal, dtype_name, pk) -> tuple:
    """The least time for one attention forward: q, k, v read once and o
    written once, against the score and P.V products over the (q, k)
    pairs this mask keeps."""
    elem = 2 if dtype_name == "bfloat16" else 4
    pairs = s * (s + 1) // 2 if causal else s * s
    return bounds_ms(4.0 * b * h * pairs * d, 4.0 * b * h * s * d * elem,
                     dtype_name, pk)


def attention_f64(q, k, v, q_pos, k_pos, causal, scale):
    """Exact attention in float64: q (n, s_q, d) at global positions
    ``q_pos``, k and v (n, s_k, d) at ``k_pos``."""
    import torch

    logits = (q.double() @ k.double().transpose(1, 2)) * scale
    if causal:
        logits = logits.masked_fill(k_pos[None, :] > q_pos[:, None],
                                    float("-inf"))
    return torch.softmax(logits, dim=-1) @ v.double()


def check_f64(name, out, plain, exact) -> dict:
    """An f32 kernel and its plain version against the f64 attention on
    the same slices: the kernel's error may be at most F64_RATIO times
    the plain version's."""
    err = (out.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    print(f"[kernel] {name} vs f64: kernel {err:.3e}, plain {plain_err:.3e}, "
          f"ratio {err / max(plain_err, 1e-300):.3f}")
    if not err <= F64_RATIO * plain_err:
        raise RuntimeError(f"{name}: error against f64 {err} is over "
                           f"{F64_RATIO} x the plain version's {plain_err}")
    return {"f64_err": err, "plain_f64_err": plain_err}


# --- phase 1 -------------------------------------------------------------
def phase_build() -> dict:
    from netsdb_tpu_torch.ops import cuda_build

    names = sorted(src.stem for src in cuda_build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(cuda_build.build, names)))
    print(f"[build] {', '.join(names)} built in "
          f"{time.perf_counter() - t0:.2f} s")
    tool = cuobjdump_path()
    for name, path in built.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "smem" in line):
                print(f"[build]   {name}: {line.strip()}")
        hmma = hmma_counts(tool, path)
        for func, count in hmma.items():
            print(f"[build]   {name}: {count} HMMA in {func}")
        if not hmma or min(hmma.values()) == 0:
            raise RuntimeError(f"{name}: a kernel without tensor-core "
                               f"instructions ({hmma})")
    return built


def cuobjdump_path() -> str:
    """``cuobjdump`` from the CUDA toolkit beside ``nvcc``, else from
    Triton's package (``triton/backends/nvidia/bin``)."""
    import importlib.util
    import os
    import shutil

    from netsdb_tpu_torch.ops import cuda_build

    candidates = [shutil.which("cuobjdump") or "",
                  os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                               "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    for root in (spec.submodule_search_locations or []) if spec else []:
        candidates.append(os.path.join(root, "backends", "nvidia", "bin",
                                       "cuobjdump"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump is in neither the CUDA toolkit nor "
                       "Triton's backends/nvidia/bin")


def hmma_counts(tool: str, library) -> dict:
    """Tensor-core instructions (``HMMA``) in each kernel of a built
    library, from its SASS."""
    import re

    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func = found.group(1)
            counts[func] = 0
        elif func and re.search(r"\bHMMA\.", line):
            counts[func] += 1
    return counts


# --- phase 2 -------------------------------------------------------------
def phase_kernels(pk: dict) -> dict:
    """Kernel vs plain at the main path's shape and the edge shapes.
    Returns the timings at the path's shape (causal f32 (2,8,4096,128))."""
    import torch
    import torch.nn.functional as F

    from netsdb_tpu_torch.ops.attention import attention, attention_dispatch
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_plain,
                                                   resolve_blocks)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((2, 8, 4096, 128), True, torch.float32, None),
             ((2, 8, 4096, 128), True, torch.bfloat16, None),
             ((2, 8, 4096, 128), False, torch.float32, None),
             ((1, 3, 96, 32), True, torch.float32, 64),   # gcd -> 32
             ((2, 8, 4096, 64), True, torch.float32, None),
             # d 40 is no multiple of bf16's mma depth (16), S no
             # multiple of the 64-row tiles
             ((1, 4, 1000, 40), True, torch.float32, None),
             ((1, 4, 1000, 40), True, torch.bfloat16, None),
             # rows of 72 and 36 bytes: no 16-byte copies, plain loads
             ((1, 2, 300, 18), True, torch.float32, None),
             ((1, 2, 300, 18), True, torch.bfloat16, None)]
    path_row = None
    for shape, causal, dtype, blk in cases:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the gcd fallback warns
            bq, bk = resolve_blocks(s, blk, blk)
            out = flash_attention(q, k, v, causal=causal, block_q=blk,
                                  block_k=blk)
        ref = flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                    block_k=bk)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"flash_attention {shape}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        row_err = (diff.amax(-1) / ref.float().abs().amax(-1)
                   .clamp_min(1e-30)).max().item()
        bf16 = dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else F32_TOL
        dname = str(dtype).replace("torch.", "")
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             block_q=bq, block_k=bk))
        plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, block_q=bq, block_k=bk), iters=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        bound, bound_by, bound3 = attention_bound_ms(b, h, s, d, causal,
                                                     dname, pk)
        row = {"shape": list(shape), "causal": causal, "dtype": dname,
               "max_abs_err": err, "max_row_rel_err": row_err,
               "tol": tol, "row_rel_tol": BF16_ROW_TOL if bf16 else None,
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
               "bound_3xtf32_ms": bound3}
        if not bf16:
            pos = torch.arange(s, device="cuda")
            row.update(check_f64(
                f"flash_attention {shape} causal={causal}",
                out.reshape(b * h, s, d)[:2], ref.reshape(b * h, s, d)[:2],
                attention_f64(*(t.reshape(b * h, s, d)[:2] for t in (q, k, v)),
                              pos, pos, causal, d ** -0.5)))
        print(f"[kernel] flash_attention {json.dumps(row)}")
        if not err <= tol or (bf16 and not row_err <= BF16_ROW_TOL):
            raise RuntimeError(f"flash_attention {shape} {dname} "
                               f"causal={causal}: max abs err {err} "
                               f"(limit {tol}), max row-relative err "
                               f"{row_err}")
        if path_row is None:
            path_row = row
    # the dispatcher sends CUDA tensors to the kernel at any sequence
    # length, here one that is no whole number of 256-blocks
    q, k, v = (torch.randn((1, 2, 1000, 64), generator=gen, device="cuda")
               for _ in range(3))
    before = flash_attention.launches
    out = attention_dispatch(q, k, v)
    err = (out - attention(q, k, v)).abs().max().item()
    print(f"[kernel] attention_dispatch (1, 2, 1000, 64): "
          f"{flash_attention.launches - before} launch, max abs err {err:.3e}")
    if flash_attention.launches != before + 1 or not err <= F32_TOL:
        raise RuntimeError("attention_dispatch did not run the kernel "
                           f"correctly at seq 1000 (err {err})")
    return path_row


def step_chain_bound_ms(bh, s_q, chunks, d, causal, dtype_name, pk) -> tuple:
    """The least time for a chain of ring steps (one kernel launch per
    chunk): q read once, each k/v chunk read once, and the f32 carry
    (acc, l, m) read and written by every step, against the score and
    P.V products over the (q, k) pairs these chunks' positions keep.
    ``chunks`` holds (s_k, q_offset, k_offset) per step."""
    import numpy as np

    elem = 2 if dtype_name == "bfloat16" else 4
    pairs = 0
    for s_k, q_off, k_off in chunks:
        if causal:
            q_pos = np.arange(q_off, q_off + s_q, dtype=np.int64)
            pairs += int(np.clip(q_pos - k_off + 1, 0, s_k).sum())
        else:
            pairs += s_q * s_k
    nbytes = (bh * s_q * d * elem
              + sum(2.0 * bh * s_k * d * elem for s_k, _, _ in chunks)
              + len(chunks) * 2.0 * bh * s_q * (d + 2) * 4)
    return bounds_ms(4.0 * bh * pairs * d, nbytes, dtype_name, pk)


def fold_chain(step, q, chunks, causal):
    """Fold (k, v, q_offset, k_offset) chunks into a fresh carry with
    ``step`` and finish: (output in q's dtype, (acc, l, m))."""
    import torch

    from netsdb_tpu_torch.ops.cuda_kernels import NEG_INF

    bh, s_q, d = q.shape
    acc = torch.zeros((bh, s_q, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s_q, 1), dtype=torch.float32, device=q.device)
    m = torch.full((bh, s_q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    for k, v, q_off, k_off in chunks:
        acc, l, m = step(q, k, v, acc, l, m, q_off, k_off, causal)
    return (acc / l.clamp_min(1e-30)).to(q.dtype), (acc, l, m)


def phase_step_kernel(pk: dict) -> dict:
    """B2 against its plain version on the card: the ring's chained fold
    at the SP path's shape (f32 and bf16, causal and not), a chunk
    wholly in the future (the carry must come back bit-identical), and
    a ragged chain with unaligned offsets and s_q != s_k. The library
    yardstick of a chain is one SDPA call of q against the chain's
    concatenated k/v under the chain's mask (timed only: the port never
    calls it). Returns the timings of the f32 causal chain (the path's
    case)."""
    import torch
    import torch.nn.functional as F

    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention_step,
                                                   flash_attention_step_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bh, s, d, n = 16, 4096, 128, SP_POSITIONS
    # (label, dtype, causal, s_q, q_offset, [(s_k, k_offset), ...]):
    # the chain of bench_ring_fold (q at the last position, chunks in
    # order), and a ragged chain in ring order (its diagonal chunk first)
    cases = [("chain", torch.float32, True, s, (n - 1) * s,
              [(s, i * s) for i in range(n)]),
             ("chain", torch.bfloat16, True, s, (n - 1) * s,
              [(s, i * s) for i in range(n)]),
             ("chain", torch.float32, False, s, (n - 1) * s,
              [(s, i * s) for i in range(n)]),
             ("ragged", torch.float32, True, 1000, 2600,
              [(900, o) for o in (2700, 1800, 900, 0)])]
    path_row = None
    for label, dtype, causal, s_q, q_off, spec in cases:
        q = randn(bh, s_q, d, dtype=dtype)
        chunks = [(randn(bh, s_k, d, dtype=dtype),
                   randn(bh, s_k, d, dtype=dtype), q_off, k_off)
                  for s_k, k_off in spec]
        out, _ = fold_chain(flash_attention_step, q, chunks, causal)
        ref, _ = fold_chain(flash_attention_step_plain, q, chunks, causal)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"flash_attention_step {label}: non-finite")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        row_err = (diff.amax(-1) / ref.float().abs().amax(-1)
                   .clamp_min(1e-30)).max().item()
        bf16 = dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else F32_TOL
        dname = str(dtype).replace("torch.", "")
        ms = time_ms(lambda: fold_chain(flash_attention_step, q, chunks,
                                        causal))
        plain_ms = time_ms(lambda: fold_chain(flash_attention_step_plain, q,
                                              chunks, causal),
                           iters=1 if label == "ragged" else 3,
                           warmup=0 if label == "ragged" else 1)
        bound, bound_by, bound3 = step_chain_bound_ms(
            bh, s_q, [(s_k, q_off, k_off) for s_k, k_off in spec], d,
            causal, dname, pk)
        # the chain as one attention: q against the concatenated chunks
        q_pos = q_off + torch.arange(s_q, device="cuda")
        k_pos = torch.cat([k_off + torch.arange(s_k, device="cuda")
                           for s_k, k_off in spec])
        k_cat = torch.cat([c[0] for c in chunks], dim=1)
        v_cat = torch.cat([c[1] for c in chunks], dim=1)
        mask = (k_pos[None, :] <= q_pos[:, None]) if causal else None
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k_cat[None], v_cat[None], attn_mask=mask))
        row = {"case": label, "bh": bh, "s_q": s_q, "d": d,
               "chunks": [[s_k, q_off, k_off] for s_k, k_off in spec],
               "causal": causal, "dtype": dname, "max_abs_err": err,
               "max_row_rel_err": row_err, "tol": tol,
               "row_rel_tol": BF16_ROW_TOL if bf16 else None,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_3xtf32_ms": bound3}
        if not bf16:
            row.update(check_f64(
                f"flash_attention_step {label} causal={causal}", out[:2],
                ref[:2], attention_f64(q[:2], k_cat[:2], v_cat[:2], q_pos,
                                       k_pos, causal, d ** -0.5)))
        del k_cat, v_cat, mask
        print(f"[kernel] flash_attention_step {json.dumps(row)}")
        if not err <= tol or (bf16 and not row_err <= BF16_ROW_TOL):
            raise RuntimeError(f"flash_attention_step {label} {dname} "
                               f"causal={causal}: max abs err {err} "
                               f"(limit {tol}), max row-relative err "
                               f"{row_err}")
        if path_row is None:
            path_row = row

    # a chunk wholly in the queries' future leaves a live carry exactly
    # as it was, in the kernel and in the plain version
    q, k, v = randn(bh, s, d), randn(bh, s, d), randn(bh, s, d)
    _, carry = fold_chain(flash_attention_step, q, [(k, v, s, s)], True)
    before = [t.clone() for t in carry]
    before_launches = flash_attention_step.launches
    flash_attention_step(q, k, v, *carry, q_offset=s, k_offset=2 * s,
                         causal=True)
    plain = flash_attention_step_plain(q, k, v, *before, q_offset=s,
                                       k_offset=2 * s, causal=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(carry, before))
    same_plain = all(torch.equal(a, b) for a, b in zip(plain, before))
    print(f"[kernel] flash_attention_step future chunk: "
          f"{flash_attention_step.launches - before_launches} launch, "
          f"carry bit-identical {same} (plain {same_plain})")
    if not (same and same_plain) or \
            flash_attention_step.launches != before_launches + 1:
        raise RuntimeError("a chunk wholly in the future changed the carry")
    return path_row


# --- phase 3 -------------------------------------------------------------
def phase_ff(client) -> dict:
    """FFModel.inference at bench.py's size, three requests; the last
    has a ragged batch so the output carries a padded margin."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.ff import FFModel

    features, hidden, labels = 1024, 4096, 1024
    model = FFModel(block=(512, 512))
    model.setup(client)
    model.load_random_weights(client, features, hidden, labels, seed=SEED)
    p = model.params_from_store(client)
    w1, b1, wo, bo = (t.to_dense().double() for t in (p.w1, p.b1, p.wo, p.bo))
    rng = np.random.default_rng(SEED + 1)
    rates, errs = [], []
    for batch in (16384, 16384, 16000):
        x = rng.standard_normal((batch, features), dtype=np.float32)
        model.load_inputs(client, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.inference(client)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if out.shape != (labels, batch) or out.device.type != "cuda":
            raise RuntimeError(f"FF output {out!r}")
        xd = torch.as_tensor(x, device="cuda").double()
        ref = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1) + bo, dim=0)
        dense = out.to_dense()
        if not torch.isfinite(dense).all():
            raise RuntimeError("FF output has non-finite values")
        err = (dense.double() - ref).abs().max().item()
        margin = (out.data * (1 - out.mask(out.dtype))).abs().max().item()
        if not err <= FF_TOL or margin != 0.0:
            raise RuntimeError(f"FF batch {batch}: max abs err {err} "
                               f"(tol {FF_TOL}), padded margin max {margin}")
        rates.append(batch / dt)
        errs.append(err)
        print(f"[ff] batch {batch} padded={out.is_padded} {dt * 1e3:.3f} ms "
              f"{batch / dt:.1f} rows/s max_abs_err {err:.3e}")
    return {"rows_per_s": rates, "max_abs_err": max(errs), "ms": dt * 1e3}


# --- phase 4 -------------------------------------------------------------
def phase_transformer(client) -> dict:
    """Three serve_forward requests at transformer_bench.py's size; each
    must launch the flash kernel exactly once."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.attention import merge_project, qkv_project
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_plain)

    embed, heads, batch, seq = 1024, 8, 2, 4096
    model = TransformerLayerModel(num_heads=heads)
    model.setup(client)
    model.load_random_weights(client, embed=embed, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    rates, errs = [], []
    for _ in range(3):
        x = rng.standard_normal((batch, seq, embed), dtype=np.float32)
        model.load_inputs(client, x)
        before = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = model.serve_forward(client)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if flash_attention.launches != before + 1:
            raise RuntimeError(f"serve_forward launched the flash kernel "
                               f"{flash_attention.launches - before} times")
        if tuple(y.shape) != (batch, seq, embed) or y.device.type != "cuda" \
                or not torch.isfinite(y).all():
            raise RuntimeError(f"transformer output {tuple(y.shape)} on "
                               f"{y.device} is wrong or non-finite")
        # the same layer with the plain attention in place of the kernel
        with torch.inference_mode():
            p = model.params_from_store(client)
            xt = torch.as_tensor(x, device="cuda")
            q, k, v = (t.contiguous() for t in
                       qkv_project(model._ln(xt), p.w_qkv, heads))
            x1 = xt + merge_project(flash_attention_plain(q, k, v), p.w_out)
            ref = x1 + model._mlp(model._ln(x1), p)
        err = (y - ref).abs().max().item()
        if not err <= LAYER_TOL:
            raise RuntimeError(f"transformer layer: max abs err {err} "
                               f"> {LAYER_TOL}")
        rates.append(batch * seq / dt)
        errs.append(err)
        print(f"[transformer] {dt * 1e3:.3f} ms {batch * seq / dt:.1f} "
              f"tokens/s max_abs_err {err:.3e}")
    return {"tokens_per_s": rates, "max_abs_err": max(errs),
            "ms": dt * 1e3}


# --- phase 5 -------------------------------------------------------------
def sp_model(client):
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.parallel.placement import Placement

    model = TransformerLayerModel(db="transformer_sp", num_heads=8)
    axes = (("sp", SP_POSITIONS),)
    return model, Placement(axes, (None, None)), Placement(
        axes, (None, "sp", None))


def phase_sp(client) -> dict:
    """Three serve_forward requests of the layer over placed sets: the
    weights replicated over ("sp", 4), x (2, 16384, 1024) sharded on the
    sequence. Run inside ``virtual_devices(4, "cuda:0")``. The launch
    counters are set to 0 just before the requests and read just after;
    the checks against the single-device forward and the naive ring run
    after that read."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.attention import qkv_project
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor, visible_devices
    from netsdb_tpu_torch.parallel.ring import ring_attention

    embed, heads, batch, seq = 1024, 8, 2, 16384
    model, replicated, seq_sharded = sp_model(client)
    model.setup(client, placements={s: replicated
                                    for s in TransformerLayerModel.SETS})
    model.load_random_weights(client, embed=embed, seed=SEED)
    rng = np.random.default_rng(SEED + 4)
    xs = [rng.standard_normal((batch, seq, embed), dtype=np.float32)
          for _ in range(3)]
    per_request = SP_POSITIONS * SP_POSITIONS
    outs, rates = [], []
    flash_attention.launches = flash_attention_step.launches = 0
    for x in xs:
        model.load_inputs(client, x, placement=seq_sharded)
        before = flash_attention_step.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = model.serve_forward(client)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = flash_attention_step.launches - before
        if got != per_request or flash_attention.launches != 0:
            raise RuntimeError(
                f"SP serve_forward launched flash_attention_step {got} "
                f"times (want {per_request}) and flash_attention "
                f"{flash_attention.launches} times (want 0)")
        if not isinstance(y, ShardedTensor) or y.shape != (
                batch, seq, embed) or y.mesh.shape != {"sp": SP_POSITIONS}:
            raise RuntimeError(f"SP output {y!r} is not sharded over the "
                               f"ring")
        outs.append(y)
        rates.append(batch * seq / dt)
        print(f"[sp] {dt * 1e3:.3f} ms {batch * seq / dt:.1f} tokens/s "
              f"{got} flash_attention_step launches")
    launches = flash_attention_step.launches

    # the same x and weights through unplaced sets: the single-device
    # forward, B1 at S = 16384
    ref_model = TransformerLayerModel(db="transformer_sp_ref",
                                      num_heads=heads)
    ref_model.setup(client)
    ref_model.load_random_weights(client, embed=embed, seed=SEED)
    errs = []
    for x, y in zip(xs, outs):
        ref_model.load_inputs(client, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ref_model.serve_forward(client)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dense = y.to_dense()
        if dense.device.type != "cuda" or not torch.isfinite(dense).all():
            raise RuntimeError("SP output is off the card or non-finite")
        err = (dense - ref).abs().max().item()
        errs.append(err)
        print(f"[sp] vs single-device forward ({dt * 1e3:.3f} ms, "
              f"{batch * seq / dt:.1f} tokens/s): max abs err {err:.3e}")
        if not err <= SP_TOL:
            raise RuntimeError(f"SP layer: max abs err {err} > {SP_TOL}")

    # the ring's attention core, B2's fold against the naive fold
    with torch.inference_mode():
        w_qkv = ref_model.params_from_store(client).w_qkv
        xt = torch.as_tensor(xs[0], device="cuda")
        q, k, v = qkv_project(ref_model._ln(xt), w_qkv, heads)
        mesh = seq_sharded.mesh(visible_devices("cuda"))
        flash = ring_attention(q, k, v, mesh, "sp", impl="flash")
        naive = ring_attention(q, k, v, mesh, "sp", impl="naive")
        ring_err = (flash.to_dense() - naive.to_dense()).abs().max().item()
    print(f"[sp] ring attention core, flash vs naive fold: max abs err "
          f"{ring_err:.3e}")
    if not ring_err <= F32_TOL:
        raise RuntimeError(f"ring attention: flash vs naive {ring_err}")
    return {"tokens_per_s": rates, "max_abs_err": max(errs),
            "ring_err": ring_err, "ms": batch * seq / rates[-1] * 1e3,
            "launches": launches}


# --- phase 6 -------------------------------------------------------------
def phase_profile(requests: dict, top: int = 8) -> dict:
    """Where one request's device time goes: each of ``requests`` (name
    → (run, unprofiled request ms)) once under torch.profiler, after the
    counts of the main paths were read. Prints the kernels by device
    time and the device's busy share of the last unprofiled request of
    the same kind, since the profiler itself slows the host. ``top``:
    the kernels printed per request. Returns each request's (device ms,
    kernel name) rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (run, request_ms) in requests.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: an aten op's entry repeats its kernels' device
        # time, and CUPTI's own buffer requests are no work of the path
        rows = sorted(((e.self_device_time_total / 1e3, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and not e.key.startswith("Activity Buffer")),
                      reverse=True)
        busy_ms = sum(ms for ms, _ in rows)
        out[name] = rows
        if not rows:
            print(f"[profile] {name}: device time not measured (the "
                  f"profiler saw no CUDA activity)")
            continue
        print(f"[profile] {name}: device busy {busy_ms:.3f} ms; request "
              f"{request_ms:.3f} ms unprofiled ({wall_ms:.3f} ms "
              f"profiled); busy share "
              f"{100 * busy_ms / request_ms:.1f}%")
        for ms, key in rows[:top]:
            print(f"[profile]   {ms:9.3f} ms  {key[:90]}")
    return out


# --- phase 7 -------------------------------------------------------------
def staged_request(client, run) -> tuple:
    """Run one request and read what it staged: (output, record) with the
    request's ms, the staging counters' deltas (bytes and copies to the
    card, chunks handed to the consumer, streams served wholly from the
    device cache), the pages read out of the arena and the cache's hits."""
    import torch

    from netsdb_tpu_torch.plan import staging

    ps, cache = client.store.page_store(), client.store.device_cache()
    p0, hits0 = ps.stats(), cache.stats()["hits"]
    c0 = staging.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c1, p1 = staging.counters(), ps.stats()
    rec = {"ms": ms, "staged_bytes": c1["bytes"] - c0["bytes"],
           "copies": c1["copies"] - c0["copies"],
           "chunks": c1["chunks"] - c0["chunks"],
           "cached_runs": c1["cached_runs"] - c0["cached_runs"],
           "wait_ms": (c1["wait_s"] - c0["wait_s"]) * 1e3,
           "place_ms": (c1["place_s"] - c0["place_s"]) * 1e3,
           "pin_ms": (c1["pin_s"] - c0["pin_s"]) * 1e3,
           "page_reads": p1["page_reads"] - p0["page_reads"],
           "page_read_ms": (p1["page_read_s"] - p0["page_read_s"]) * 1e3,
           "arena_loads": p1["loads"] - p0["loads"],
           "cache_hits": cache.stats()["hits"] - hits0}
    return out, rec


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(intervals, union) -> float:
    total = 0.0
    for s, e in intervals:
        for us, ue in union:
            total += max(0.0, min(e, ue) - max(s, us))
    return total


def profile_staged(name: str, run, request_ms: float) -> dict:
    """One cold staged request under torch.profiler, read from its trace:
    where the host-to-device copies ran (their streams, pinned or
    pageable source), how long they took, how much of that time kernels
    ran on other streams, the device's busy share of the unprofiled
    request and the kernels by device time. Raises if a copy came from
    pageable memory or ran on a stream that also ran kernels."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print(f"[paged] {name} profile: device time not measured (the "
              f"profiler saw no CUDA activity)")
        return {"measured": False}
    copies = [e for e in dev if e["cat"] == "gpu_memcpy"
              and "HtoD" in e["name"]]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    copy_streams = {e.get("args", {}).get("stream") for e in copies}
    kernel_streams = {e.get("args", {}).get("stream") for e in kernels}
    pageable = [e["name"] for e in copies if "Pinned" not in e["name"]]
    copy_iv = [(e["ts"], e["ts"] + e["dur"]) for e in copies]
    copy_us = sum(e - s for s, e in copy_iv)
    copy_bytes = sum(int(e.get("args", {}).get("bytes", 0)) for e in copies)
    overlap_us = _overlap(copy_iv, _union(
        (e["ts"], e["ts"] + e["dur"]) for e in kernels))
    busy_us = sum(e - s for s, e in _union(
        (e["ts"], e["ts"] + e["dur"]) for e in dev))
    by_kernel = {}
    for e in kernels:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
    rec = {"measured": True, "copies": len(copies),
           "copy_ms": copy_us / 1e3, "copy_bytes": copy_bytes,
           "copy_gbps": copy_bytes / (copy_us * 1e3) if copy_us else None,
           "overlap_share": overlap_us / copy_us if copy_us else None,
           "copy_streams": sorted(map(str, copy_streams)),
           "kernel_streams": sorted(map(str, kernel_streams)),
           "pinned": not pageable, "busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e3 / request_ms,
           "profiled_ms": wall_ms}
    print(f"[paged] {name} cold profile: {json.dumps(rec)}")
    for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[paged]   {us / 1e3:9.3f} ms  {key[:100]}")
    if pageable:
        raise RuntimeError(f"{name}: host-to-device copies from pageable "
                           f"memory: {sorted(set(pageable))}")
    if copies and copy_streams & kernel_streams:
        raise RuntimeError(f"{name}: the uploads ran on a stream that also "
                           f"ran kernels ({copy_streams & kernel_streams})")
    return rec


def phase_paged() -> dict:
    """The paged path on the card: FF at bench.py's width with w1 and wo
    paged, and the staged transformer layer at transformer_bench.py's
    width with all four weights paged, in an arena of POOL_BYTES pages of
    PAGE_BYTES (smaller than either model's weights, so it spills). Per
    model: a first request, one cold request (device cache cleared),
    three warm requests (0 pages read, 0 bytes staged) and the resident
    request on the same weights, which the paged output is held to.
    Then one cold request of each under the profiler, and a ring check:
    a matrix of 12 pages streamed through the 3 pinned buffers of a
    stage depth of 2, against its own bytes."""
    import tempfile

    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention

    out = {}
    with tempfile.TemporaryDirectory(prefix="netsdb_paged_") as root:
        client = Client(Configuration(root_dir=root,
                                      page_size_bytes=PAGE_BYTES,
                                      page_pool_bytes=POOL_BYTES))
        store = client.store
        rng = np.random.default_rng(SEED + 5)

        # FF: 16384 x 1024 -> 4096 -> 1024, f32
        features, hidden, labels, batch = 1024, 4096, 1024, 16384
        paged = FFModel(db="ff_paged", block=(512, 512))
        paged.setup(client, storages={"w1": "paged", "wo": "paged"})
        resident = FFModel(db="ff_resident", block=(512, 512))
        resident.setup(client)
        x = rng.standard_normal((batch, features), dtype=np.float32)
        for m in (paged, resident):
            m.load_random_weights(client, features, hidden, labels,
                                  seed=SEED)
            m.load_inputs(client, x)

        def ff_paged():
            return paged.inference(client).to_dense()

        def ff_resident():
            return resident.inference(client).to_dense()

        out["ff"] = drive_paged(client, "ff", ff_paged, ff_resident,
                                PAGED_FF_TOL, batch, "rows/s")

        # the staged transformer layer: embed 1024, 8 heads, 2 x 4096
        embed, heads, tb, seq = 1024, 8, 2, 4096
        tpaged = TransformerLayerModel(db="tf_paged", num_heads=heads)
        tpaged.setup(client, storages={w: "paged" for w in
                                       TransformerLayerModel.SETS})
        tres = TransformerLayerModel(db="tf_resident", num_heads=heads)
        tres.setup(client)
        xt = rng.standard_normal((tb, seq, embed), dtype=np.float32)
        for m in (tpaged, tres):
            m.load_random_weights(client, embed=embed, seed=SEED)
            m.load_inputs(client, xt)
        dag = tpaged.build_forward_dag_staged()

        def tf_paged():
            res = client.execute_computations(dag, job_name="tf-paged")
            return next(iter(res.values()))

        out["transformer"] = drive_paged(
            client, "transformer", tf_paged, lambda: tres.serve_forward(
                client), PAGED_LAYER_TOL, tb * seq, "tokens/s")
        launches = out["transformer"]["launches"]
        if launches < out["transformer"]["requests"]:
            raise RuntimeError(f"the staged transformer path launched "
                               f"flash_attention {launches} times in "
                               f"{out['transformer']['requests']} requests")

        arena = store.page_store().stats()
        print(f"[paged] arena after both models: {json.dumps(arena)}")
        if not arena["spills"] > 0:
            raise RuntimeError(f"the arena never spilled: {arena}")
        out["arena"] = arena
        print(f"[paged] device cache: "
              f"{json.dumps(store.device_cache().stats())}")

        # the pinned ring: 12 pages through 3 buffers, bit for bit
        client.create_database("ring")
        client.create_set("ring", "m", storage="paged")
        rows = 12 * (PAGE_BYTES // (4 * 1024))
        mat = rng.standard_normal((rows, 1024), dtype=np.float32)
        client.send_matrix("ring", "m", mat, (512, 512))
        eye = torch.eye(1024, device="cuda")
        want = torch.as_tensor(mat, device="cuda")
        store.device_cache().clear()
        same = [torch.equal(client.paged_matmul("ring", "m", eye), want)
                for _ in range(2)]  # cold (through the ring), then warm
        print(f"[paged] pinned ring: {rows} rows in 12 pages through "
              f"{store.config.stage_depth + 1} pinned buffers; cold "
              f"bit-identical {same[0]}, warm bit-identical {same[1]}")
        if not all(same):
            raise RuntimeError("a page streamed through the pinned ring "
                               "came back changed")

        out["ff"]["profile"] = profile_staged(
            "ff", cold(client, ff_paged), out["ff"]["cold_ms"])
        out["transformer"]["profile"] = profile_staged(
            "transformer", cold(client, tf_paged),
            out["transformer"]["cold_ms"])
        store.page_store().close()
    return out


def cold(client, run):
    """``run`` with the device cache cleared first."""
    def go():
        client.store.device_cache().clear()
        return run()
    return go


def drive_paged(client, name, run_paged, run_resident, tol, units,
                unit) -> dict:
    """First, cold, three warm and one resident request of one model;
    prints each and holds the paged outputs to the resident one. The
    flash kernel's launch count is set to 0 just before the paged
    requests and read just after them."""
    import torch

    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention

    cache = client.store.device_cache()
    run_resident()  # warms the libraries' handles for both shapes
    cache.clear()
    reqs = []
    flash_attention.launches = 0
    for kind in ("first", "cold", "warm", "warm", "warm"):
        if kind == "cold":
            cache.clear()
        got, rec = staged_request(client, run_paged)
        rec["kind"] = kind
        reqs.append((got, rec))
    launches = flash_attention.launches
    print(f"[paged] {name}: flash_attention launched {launches} times in "
          f"{len(reqs)} paged requests")
    ref, res = staged_request(client, run_resident)
    res["kind"] = "resident"
    errs = []
    for got, rec in reqs:
        if tuple(got.shape) != tuple(ref.shape) or \
                not torch.isfinite(got).all():
            raise RuntimeError(f"{name} paged output {tuple(got.shape)} is "
                               f"wrong or non-finite")
        rec["max_abs_err"] = (got.float() - ref.float()).abs().max().item()
        errs.append(rec["max_abs_err"])
    for _, rec in reqs + [(ref, res)]:
        rate = units / rec["ms"] * 1e3
        print(f"[paged] {name} {rec['kind']:8s} {rec['ms']:.3f} ms "
              f"{rate:.1f} {unit} {json.dumps(rec)}")
    cold_rec = reqs[1][1]
    gbps = cold_rec["staged_bytes"] / (cold_rec["ms"] * 1e6)
    print(f"[paged] {name} cold: {cold_rec['staged_bytes']} bytes in "
          f"{cold_rec['copies']} copies, {gbps:.2f} GB/s over the request "
          f"(PCIe Gen5 x16 nominal {PCIE_GBPS:.0f} GB/s); max abs err vs "
          f"resident {max(errs):.3e} (limit {tol})")
    if not max(errs) <= tol:
        raise RuntimeError(f"{name}: paged vs resident max abs err "
                           f"{max(errs)} > {tol}")
    if not cold_rec["staged_bytes"] > 0 or not cold_rec["page_reads"] > 0:
        raise RuntimeError(f"{name}: the cold request staged nothing")
    for _, rec in reqs[2:]:
        if rec["page_reads"] or rec["staged_bytes"] or not rec["cache_hits"]:
            raise RuntimeError(f"{name}: a warm request read "
                               f"{rec['page_reads']} pages and staged "
                               f"{rec['staged_bytes']} bytes with "
                               f"{rec['cache_hits']} cache hits")
    return {"requests": len(reqs), "launches": launches,
            "cold_ms": cold_rec["ms"],
            "first_ms": reqs[0][1]["ms"],
            "warm_ms": [r["ms"] for _, r in reqs[2:]],
            "resident_ms": res["ms"], "cold_gbps": gbps,
            "staged_bytes": cold_rec["staged_bytes"],
            "chunks": cold_rec["chunks"], "max_abs_err": max(errs)}


# --- phase 8 -------------------------------------------------------------
# each model's request output against its f64 recomputation: a one-hot
# product with TF32 off and a gather pick table rows exactly; conv
# outputs are about 12 in magnitude (unit-scale images and filters)
MODEL_TOLS = {"word2vec": 0.0, "word2vec_sparse": 1e-5, "logreg": 1e-5,
              "text_classifier": 1e-4, "lstm": 1e-4, "lstm_bf16": 5e-2,
              "conv2d": 2e-3}
CONV_REQUESTS = 10
# the reference's benchmark widths: logreg at bench.py's FF input width
# and batch (the reference publishes none); word2vec, the text classifier
# and the LSTM at netsdb_tpu/workloads/model_bench.py's defaults, the
# one-hot DAGs cut to 4096 rows (65536 would be 26 GB of f32); conv at
# conv_bench.py's (the reference README's 112 x 112 x 3, 64 7 x 7 filters)
MODEL_SIZES = {"logreg": dict(features=1024, rows=16384),
               "word2vec": dict(vocab=100_000, dim=512, ids=65_536,
                                segments=4096, dag_rows=4096),
               "text_classifier": dict(vocab=50_000, labels=16,
                                       docs=16_384),
               "lstm": dict(hidden=1024, inp=1024, batch=1024, steps=16,
                            block=512),
               "conv2d": dict(n=64, c=3, hw=112, o=64, k=7)}


def request(run) -> tuple:
    """(output, ms) of one request, the card synchronised around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive_model(name, run, error, tol, count, units, n=3) -> dict:
    """``n`` requests of ``run``; ``error(output)`` is the output's max abs
    error against the f64 recomputation, and the phase fails above
    ``tol``, on a non-finite output or on one that left the card."""
    import torch

    rows = []
    for i in range(n):
        out, ms = request(run)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            t = getattr(t, "data", t)
            if t.device.type != "cuda" or (t.is_floating_point()
                                           and not torch.isfinite(t).all()):
                raise RuntimeError(f"{name}: output on {t.device} or "
                                   f"non-finite")
        err = error(out)
        print(f"[models] {name} request {i}: {ms:.3f} ms "
              f"{count / ms * 1e3:.1f} {units} max_abs_err {err:.3e}")
        if not err <= tol:
            raise RuntimeError(f"{name}: max abs err {err} > {tol}")
        rows.append((ms, err))
    ms = [r[0] for r in rows]
    p50 = sorted(ms)[len(ms) // 2]
    return {"ms": ms, "p50_ms": p50, "rate": count / p50 * 1e3,
            "units": units, "max_abs_err": max(r[1] for r in rows)}


def err_of(out, ref) -> float:
    """Max abs difference of a tensor or a BlockedTensor's logical part."""
    out = out.to_dense() if hasattr(out, "meta") else out
    return (out.double() - ref).abs().max().item()


def lstm_f64(w, h, c, xs):
    """The LSTM recurrence in float64 over the steps of ``xs``."""
    import torch

    w = {k: v.double() for k, v in w.items()}
    h, c = h.double(), c.double()
    for x in xs:
        x = x.double()

        def gate(g, act):
            return act(w[f"w_{g}"] @ x + w[f"u_{g}"] @ h
                       + w[f"b_{g}"][:, None])

        i, f, o = (gate(g, torch.sigmoid) for g in "ifo")
        c = f * c + i * gate("c", torch.tanh)
        h = o * torch.tanh(c)
    return h, c


def conv_f64(images, kernels, bias, stride, padding):
    """relu(conv + bias) in float64 as patches times filters, with the
    SAME pads worked out from their definition (ceil(in / stride)
    outputs, the odd pixel after)."""
    import torch
    import torch.nn.functional as F

    k = kernels.shape[2]
    pads = []
    for size, s in zip(images.shape[2:], stride):
        total = (max((-(-size // s) - 1) * s + k - size, 0)
                 if padding == "SAME" else 0)
        pads.append((total // 2, total - total // 2))
    x = F.pad(images.double(), (*pads[1], *pads[0]))
    oh, ow = ((x.shape[2] - k) // stride[0] + 1,
              (x.shape[3] - k) // stride[1] + 1)
    cols = F.unfold(x, (k, k), stride=stride)
    out = kernels.double().reshape(kernels.shape[0], -1) @ cols
    out = torch.relu(out + bias.double()[None, :, None])
    return out.reshape(images.shape[0], kernels.shape[0], oh, ow)


def phase_models() -> dict:
    """Logistic regression, word2vec, the text classifier, the LSTM and
    conv2d through ``Client()`` on the card, at ``MODEL_SIZES``, f32 (and
    the LSTM once more in bf16). Every request is held to an f64
    recomputation of the same seeded data, made on the card; one request
    of each model then runs under the profiler."""
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.models import (Conv2DModel, LogRegModel,
                                         LSTMModel, TextClassifierModel,
                                         Word2VecModel)
    from netsdb_tpu_torch.ops.embedding import embedding_lookup_sparse

    client = Client()
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=g, device="cuda")

    out, profiled = {}, {}

    # logistic regression
    features, rows = MODEL_SIZES["logreg"].values()
    lr = LogRegModel(block=(512, 512))
    lr.setup(client)
    w, x = randn(features, scale=features ** -0.5), randn(rows, features)
    lr.load_weights(client, w, 0.1)
    lr.load_inputs(client, x)
    ref = torch.sigmoid(x.double() @ w.double() + 0.1)[None, :]
    out["logreg"] = drive_model(
        "logreg", lambda: lr.inference(client), lambda o: err_of(o, ref),
        MODEL_TOLS["logreg"], rows, "rows/s")
    profiled["logreg"] = (lambda: lr.inference(client),
                          out["logreg"]["p50_ms"])

    # word2vec: gather, sparse mean, the one-hot DAG
    vocab, dim, n_ids, segs, dag_rows = MODEL_SIZES["word2vec"].values()
    w2v = Word2VecModel(block=(512, 512))
    w2v.setup(client)
    table = randn(vocab, dim)
    w2v.load_embeddings(client, table)
    ids = randint(vocab, n_ids)
    seg = torch.sort(randint(segs, n_ids)).values
    rows64 = table.double()[ids]
    counts = torch.zeros(segs, dtype=torch.float64, device="cuda").index_add_(
        0, seg, torch.ones(n_ids, dtype=torch.float64, device="cuda"))
    mean = torch.zeros(segs, dim, dtype=torch.float64,
                       device="cuda").index_add_(0, seg, rows64)
    mean /= counts.clamp(min=1.0)[:, None]
    out["word2vec_lookup"] = drive_model(
        "word2vec lookup", lambda: w2v.lookup(client, ids),
        lambda o: err_of(o, rows64), MODEL_TOLS["word2vec"], n_ids, "ids/s")
    out["word2vec_sparse"] = drive_model(
        "word2vec lookup_sparse(mean)",
        lambda: w2v.lookup_sparse(client, ids, seg, segs),
        lambda o: err_of(o, mean), MODEL_TOLS["word2vec_sparse"], n_ids,
        "ids/s")
    w2v.load_onehot_inputs(client, ids[:dag_rows], vocab)
    out["word2vec_dag"] = drive_model(
        "word2vec one-hot DAG", lambda: w2v.inference(client),
        lambda o: err_of(o, rows64[:dag_rows]), MODEL_TOLS["word2vec"],
        dag_rows, "ids/s")
    profiled["word2vec one-hot DAG"] = (lambda: w2v.inference(client),
                                        out["word2vec_dag"]["p50_ms"])
    del rows64

    # text classifier: the DAG, and bag of words over word2vec's count of
    # tokens
    vocab, labels, docs = MODEL_SIZES["text_classifier"].values()
    tc = TextClassifierModel(block=(512, 512))
    tc.setup(client)
    emb, fc_w, fc_b = (randn(vocab, dim), randn(labels, dim, scale=dim ** -0.5),
                       randn(labels, scale=0.1))
    tc.load_weights(client, emb, fc_w, fc_b)
    tok = randint(vocab, n_ids)
    doc = torch.sort(randint(docs, n_ids)).values

    def probs_f64(feats):
        return torch.softmax(fc_w.double() @ feats.T + fc_b.double()[:, None],
                             dim=0)

    tc.load_onehot_inputs(client, tok[:dag_rows], vocab)
    ref = probs_f64(emb.double()[tok[:dag_rows]])
    out["text_classifier_dag"] = drive_model(
        "text classifier DAG", lambda: tc.inference(client),
        lambda o: err_of(o, ref), MODEL_TOLS["text_classifier"], dag_rows,
        "docs/s")
    counts = torch.zeros(docs, dtype=torch.float64, device="cuda").index_add_(
        0, doc, torch.ones(n_ids, dtype=torch.float64, device="cuda"))
    feats = torch.zeros(docs, dim, dtype=torch.float64,
                        device="cuda").index_add_(0, doc, emb.double()[tok])
    ref = probs_f64(feats / counts.clamp(min=1.0)[:, None])
    top2 = ref.topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > 1e-4  # labels f32 must not flip

    def bow_error(pred):
        wrong = int(((pred != ref.argmax(0)) & clear).sum())
        if wrong:
            raise RuntimeError(f"bag of words: {wrong} documents with a "
                               f"clear f64 label were labelled otherwise")
        # the probabilities behind the labels, by the request's own pieces
        feats = embedding_lookup_sparse(
            client.get_tensor(tc.db, "embeddings"), tok, doc, docs, "mean")
        probs = tc.semantic_classifier(
            BlockedTensor.from_dense(feats, tc.block),
            client.get_tensor(tc.db, "fc_w"),
            client.get_tensor(tc.db, "fc_b"))
        return err_of(probs, ref)

    out["text_classifier_bow"] = drive_model(
        "text classifier bag of words",
        lambda: tc.classify_bag_of_words(client, tok, doc, docs), bow_error,
        MODEL_TOLS["text_classifier"], docs, "docs/s")
    profiled["text classifier DAG"] = (lambda: tc.inference(client),
                                       out["text_classifier_dag"]["p50_ms"])

    # LSTM: one step through the store, then run_sequence; again in bf16
    hidden, inp, batch, steps, lblock = MODEL_SIZES["lstm"].values()
    lw = {}
    for gate in "ifco":
        lw[f"w_{gate}"] = randn(hidden, inp, scale=inp ** -0.5)
        lw[f"u_{gate}"] = randn(hidden, hidden, scale=hidden ** -0.5)
        lw[f"b_{gate}"] = randn(hidden, scale=0.1)
    h0, c0 = randn(hidden, batch, scale=0.5), randn(hidden, batch, scale=0.5)
    xs = randn(steps, inp, batch)
    ref1 = lstm_f64(lw, h0, c0, xs[:1])
    ref_t = lstm_f64(lw, h0, c0, xs)
    for cd, tol in ((None, MODEL_TOLS["lstm"]),
                    ("bfloat16", MODEL_TOLS["lstm_bf16"])):
        key = "lstm" if cd is None else "lstm_bf16"
        m = LSTMModel(db=key, block=(lblock, lblock), compute_dtype=cd)
        m.setup(client)
        m.load_weights(client, lw)
        m.load_state(client, h0, c0)
        out[f"{key}_step"] = drive_model(
            f"{key} step", lambda m=m: m.step(client, xs[0]),
            lambda o: max(err_of(o[0], ref1[0]), err_of(o[1], ref1[1])),
            tol, batch, "cell rows/s", n=1)
        out[f"{key}_sequence"] = drive_model(
            f"{key} run_sequence x{steps}",
            lambda m=m: m.run_sequence(client, xs),
            lambda o: max(err_of(o[0], ref_t[0]), err_of(o[1], ref_t[1])),
            tol, batch * steps, "cell rows/s")
    for key in ("lstm", "lstm_bf16"):
        m = LSTMModel(db=key, block=(lblock, lblock),
                      compute_dtype=None if key == "lstm" else "bfloat16")
        profiled[f"{key} run_sequence"] = (
            lambda m=m: m.run_sequence(client, xs),
            out[f"{key}_sequence"]["p50_ms"])

    # conv2d: VALID with bias and relu, both modes; then SAME at stride 2
    n, c, hw, o, k = MODEL_SIZES["conv2d"].values()
    images, kernels, bias = randn(n, c, hw, hw), randn(o, c, k, k), randn(o)
    for stride, padding, n in (((1, 1), "VALID", CONV_REQUESTS),
                               ((2, 2), "SAME", 1)):
        ref = conv_f64(images, kernels, bias, stride, padding)
        for mode in ("direct", "im2col"):
            m = Conv2DModel(db=f"conv_{mode}_{padding}", mode=mode,
                            stride=stride, padding=padding,
                            activation="relu")
            m.setup(client)
            m.load(client, images, kernels, bias)

            def conv_error(o, ref=ref):
                if len(o) != 1 or tuple(o[0].shape) != tuple(ref.shape):
                    raise RuntimeError(f"conv output {[t.shape for t in o]}")
                return err_of(o[0], ref)

            key = f"conv2d_{mode}" + ("" if padding == "VALID" else "_same_s2")
            out[key] = drive_model(
                f"conv2d {mode} {padding} stride {stride}",
                lambda m=m: m.inference(client), conv_error,
                MODEL_TOLS["conv2d"], images.shape[0], "images/s", n=n)
            if padding == "VALID":
                print(f"[models] conv2d {mode}: batch latency p50 "
                      f"{out[key]['p50_ms']:.3f} ms over {n} requests")
                profiled[f"conv2d {mode}"] = (lambda m=m: m.inference(client),
                                              out[key]["p50_ms"])
    phase_profile(profiled, top=3)
    return out


def models_path() -> dict:
    """Phase 8 between launch counts set to 0 and read: neither kernel
    lies on the model families' path."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out = phase_models()
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[models] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the model families launched an attention "
                           f"kernel: {launches}")
    return out


# --- phase 9 -------------------------------------------------------------
# each step against the same step recomputed in float64 from the same
# params, on the card, through the plain path: every updated param within
# TRAIN_GRAD_TOL x lr x the f64 gradient's max |value| plus one f32
# rounding of the param (2**-23 x its max |value|); the loss within
# TRAIN_LOSS_RTOL of the f64 loss
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_STEPS = 3
# FF at bench.py's size, the layer at transformer_bench.py's, logreg at
# phase 8's (the reference publishes no training sizes)
TRAIN_SIZES = {"ff": dict(batch=16384, features=1024, hidden=4096,
                          labels=1024),
               "transformer": dict(embed=1024, heads=8, batch=2, seq=4096),
               "logreg": dict(features=1024, rows=16384)}


def ln64(z):
    import torch

    mu = z.mean(-1, keepdim=True)
    return (z - mu) * torch.rsqrt(z.var(-1, keepdim=True, unbiased=False)
                                  + 1e-5)


def ff_loss64(p, x, y):
    """The FF loss in float64 on logical tensors (bo is not read). relu's
    derivative jumps at 0, and a pre-activation within f32 rounding of 0
    may take the other sign in f64, which moves a gradient row by
    |dh · x|, about 1e-5 here, an error of neither. So relu's activation
    pattern is the f32 one, from the same params by plain ``torch.matmul``
    (TF32 off); the pre-activations whose sign differs in f64 are
    counted and printed."""
    import torch

    z = p["w1"] @ x.T + p["b1"]
    z32 = (p["w1"].detach().float() @ x.float().T
           + p["b1"].detach().float())
    flips = int(((z32 > 0) != (z > 0)).sum())
    print(f"[train] ff: {flips} of {z.numel()} pre-activations change sign "
          f"between f32 and f64")
    h = torch.where(z32 > 0, z, torch.zeros((), dtype=z.dtype,
                                            device=z.device))
    return -(y * torch.log_softmax(p["wo"] @ h, dim=0)).sum() / x.shape[0]


def logreg_loss64(p, x, y):
    import torch

    z = (x @ p["w"].T).reshape(-1) + p["b"][0, 0]
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


def layer_loss64(p, x, t, heads):
    """The layer's MSE in float64 with plain causal attention."""
    import torch
    import torch.nn.functional as F

    b, s, e = x.shape
    d = e // heads
    q, k, v = (u.reshape(b, s, heads, d).transpose(1, 2)
               for u in (ln64(x) @ p["w_qkv"]).chunk(3, -1))
    logits = (q @ k.transpose(-1, -2)) * d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    o = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1) @ v
    x1 = x + o.transpose(1, 2).reshape(b, s, e) @ p["w_out"]
    y = x1 + F.gelu(ln64(x1) @ p["w_up"], approximate="tanh") @ p["w_down"]
    return ((y - t) ** 2).mean()


def logical_params(params) -> dict:
    """A params dataclass as {name: logical tensor}."""
    import dataclasses

    return {f.name: (v.to_dense() if hasattr(v, "meta") else v)
            for f in dataclasses.fields(params)
            for v in [getattr(params, f.name)]}


def check_step(name, step, ms, params, new, loss, lr, loss64, *args64):
    """One training step against its f64 recomputation from the same
    params; raises above the limits, or on a padded margin that is not
    zero. Returns the step's errors."""
    import torch

    leaves = {n: t.double().requires_grad_()
              for n, t in logical_params(params).items()}
    with torch.enable_grad():
        l64 = loss64(leaves, *args64)
        grads = torch.autograd.grad(l64, list(leaves.values()),
                                    allow_unused=True)
    loss_err = abs(float(loss) - l64.item())
    if not loss_err <= TRAIN_LOSS_RTOL * abs(l64.item()):
        raise RuntimeError(f"{name} step {step}: loss {float(loss)} vs f64 "
                           f"{l64.item()}")
    out = {"ms": ms, "loss": float(loss), "loss_err": loss_err}
    got = logical_params(new)
    for (n, p64), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p64) if g is None else g
        want = p64.detach() - lr * g
        err = (got[n].double() - want).abs().max().item()
        limit = (TRAIN_GRAD_TOL * lr * g.abs().max().item()
                 + 2.0 ** -23 * p64.abs().max().item())
        out[n] = {"err": err, "limit": limit,
                  "max_grad": g.abs().max().item()}
        if not err <= limit:
            raise RuntimeError(f"{name} step {step}: {n} max abs err {err} "
                               f"> {limit}")
        full = getattr(new, n)
        if hasattr(full, "meta") and torch.count_nonzero(
                full.data * (1 - full.mask(full.dtype))):
            raise RuntimeError(f"{name} step {step}: {n}'s padded margin "
                               f"is not zero")
    print(f"[train] {name} step {step}: {ms:.3f} ms loss {float(loss):.6f} "
          f"(f64 err {loss_err:.3e}); max abs err / limit: "
          + ", ".join(f"{n} {out[n]['err']:.3e}/{out[n]['limit']:.3e}"
                      for n in leaves))
    return out


def train_steps(name, model, params, lr, args, loss64, *args64) -> tuple:
    """TRAIN_STEPS chained ``train_step`` calls, each checked; returns
    (the last params, the per-step records)."""
    import torch

    steps = []
    for step in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        (new, loss), ms = request(lambda: model.train_step(params, *args,
                                                           lr=lr))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps.append(check_step(name, step, ms, params, new, loss, lr,
                                loss64, *args64))
        steps[-1]["peak_gib"] = peak
        print(f"[train] {name} step {step}: peak device memory {peak:.3f} "
              f"GiB")
        params = new
    return params, steps


def phase_train() -> tuple:
    """Training through the database on the card, f32: FF, the layer and
    logreg, each after its inference path ran, on params read back from
    the store; B1's launches are counted around the layer's steps (one
    launch a step). Then ``graft_entry.dryrun_multichip(1)``. Returns the
    results and one step of each model to profile."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.graft_entry import dryrun_multichip
    from netsdb_tpu_torch.models import (FFModel, LogRegModel,
                                         TransformerLayerModel)
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    client = Client()
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    out = {}

    # FF: inference, the one-hot labels sent, three steps at lr 0.1
    batch, features, hidden, labels = TRAIN_SIZES["ff"].values()
    ff = FFModel(db="ff_train", block=(512, 512))
    ff.setup(client)
    ff.load_random_weights(client, features, hidden, labels, seed=SEED)
    x = torch.randn(batch, features, generator=g, device="cuda")
    ff.load_inputs(client, x)
    ff.inference(client)
    onehot = F.one_hot(torch.randint(0, labels, (batch,), generator=g,
                                     device="cuda"), labels).T.float()
    client.create_set(ff.db, "labels")
    client.send_matrix(ff.db, "labels", onehot, (512, 512))
    ff_args = (client.get_tensor(ff.db, "inputs"),
               client.get_tensor(ff.db, "labels"))
    _, out["ff"] = train_steps("ff", ff, ff.params_from_store(client), 0.1,
                               ff_args, ff_loss64, x.double(),
                               onehot.double())

    # the layer: serve_forward, then three steps at lr 1e-2, B1 counted
    embed, heads, batch, seq = TRAIN_SIZES["transformer"].values()
    layer = TransformerLayerModel(db="transformer_train", num_heads=heads)
    layer.setup(client)
    layer.load_random_weights(client, embed=embed, seed=SEED)
    rng = np.random.default_rng(SEED + 21)
    xn = rng.standard_normal((batch, seq, embed), dtype=np.float32)
    layer.load_inputs(client, xn)
    layer.serve_forward(client)
    xl = torch.as_tensor(xn, device="cuda")
    tl = torch.randn(batch, seq, embed, generator=g, device="cuda")
    p0 = layer.params_from_store(client)
    flash_attention.launches = flash_attention_step.launches = 0
    p3, out["transformer"] = train_steps(
        "transformer", layer, p0, 1e-2, (xl, tl),
        lambda p, a, b: layer_loss64(p, a, b, heads), xl.double(),
        tl.double())
    launches = (flash_attention.launches, flash_attention_step.launches)
    moved = (p3.w_qkv - p0.w_qkv).abs().max().item()
    print(f"[train] transformer: flash_attention {launches[0]} launches in "
          f"{TRAIN_STEPS} steps, flash_attention_step {launches[1]}; w_qkv "
          f"moved by up to {moved:.3e}")
    if launches != (TRAIN_STEPS, 0):
        raise RuntimeError(f"the layer's training steps launched "
                           f"(B1, B2) = {launches}, want ({TRAIN_STEPS}, 0)")
    if not moved > 0:
        raise RuntimeError("w_qkv got no gradient through B1")
    out["transformer_b1_launches"] = launches[0]

    # logreg: inference, then three steps at lr 0.5
    features, rows = TRAIN_SIZES["logreg"].values()
    lr_model = LogRegModel(db="logreg_train", block=(512, 512))
    lr_model.setup(client)
    w = torch.randn(features, generator=g, device="cuda") * features ** -0.5
    x = torch.randn(rows, features, generator=g, device="cuda")
    y = (torch.rand(rows, generator=g, device="cuda") < 0.5).float()
    lr_model.load_weights(client, w, 0.1)
    lr_model.load_inputs(client, x)
    lr_model.inference(client)
    lr_params = lr_model.params_from_store(client)
    lr_args = (client.get_tensor(lr_model.db, "inputs"), y)
    _, out["logreg"] = train_steps("logreg", lr_model, lr_params, 0.5,
                                   lr_args, logreg_loss64, x.double(),
                                   y.double())

    # the port's entry point for the reference's dry run
    loss, ms = request(lambda: dryrun_multichip(1))
    print(f"[train] graft_entry.dryrun_multichip(1): loss {loss:.6f} in "
          f"{ms:.3f} ms")
    out["dryrun_loss"] = loss

    def p50(name):
        return sorted(s["ms"] for s in out[name])[1]

    ff_params = ff.params_from_store(client)
    profiled = {
        "ff train_step": (lambda: ff.train_step(ff_params, *ff_args),
                          p50("ff")),
        "transformer train_step": (lambda: layer.train_step(p0, xl, tl),
                                   p50("transformer")),
        "logreg train_step": (lambda: lr_model.train_step(lr_params,
                                                          *lr_args),
                              p50("logreg"))}
    return out, profiled


def train_path() -> dict:
    """Phase 9 between launch counts set to 0 and read: the layer's three
    steps launch B1 three times and B2 never; FF, logreg and the dry run
    launch neither. One step of each model is profiled after the read,
    with B1's share of the layer's step."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled = phase_train()
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[train] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (TRAIN_STEPS, 0):
        raise RuntimeError(f"the training path launched (B1, B2) = "
                           f"{launches}, want ({TRAIN_STEPS}, 0)")
    rows = phase_profile(profiled, top=5)["transformer train_step"]
    busy = sum(ms for ms, _ in rows)
    b1 = sum(ms for ms, key in rows if "fold_kernel" in key)
    if busy:
        print(f"[train] B1 in the profiled layer step: {b1:.3f} ms of "
              f"{busy:.3f} ms device time ({100 * b1 / busy:.1f}%)")
    return out


# --- phase 10 ------------------------------------------------------------
LA_ROWS, LA_COLS, LA_BLOCK, LA_LAM = 200_000, 1000, 1000, 1.0
LA_RTOL = LA_ATOL = 2e-4  # tests/test_la_tasks.py's, against f64
LA_REQUESTS = 3


def la_f64(task, env):
    """The task's result in float64 on the card."""
    import torch

    x = env["X"].to_dense().double()
    if task == "gram":
        return x.T @ x
    if task == "matmul":
        return x @ env["W"].to_dense().double()
    eye = torch.eye(x.shape[1], dtype=torch.float64, device=x.device)
    return torch.linalg.solve(x.T @ x + LA_LAM * eye,
                              x.T @ env["y"].to_dense().double())


def la_violations(got, want) -> tuple:
    """(entries outside rtol/atol, max abs err) of ``got`` against f64."""
    err = (got.to_dense().double() - want).abs()
    bad = int((err > LA_ATOL + LA_RTOL * want.abs()).sum())
    return bad, err.max().item()


def phase_la() -> tuple:
    """The headline LA tasks at the reference's scale, f32: each task's
    PDML program through ``compile_pdml`` over ``make_inputs`` on the
    card, LA_REQUESTS requests each held to f64; then the linreg program
    through ``LAInterpreter(client=Client())``, its statement materialised
    as a set and read back with ``get_set_iterator``; then ``run_all``
    times the tasks by CUDA events. Returns the results and one request
    of each task to profile."""
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.dsl import LAInterpreter, parse_program
    from netsdb_tpu_torch.workloads import la_tasks

    out, profiled = {}, {}
    for task in la_tasks.TASKS:
        env = la_tasks.make_inputs(task, LA_ROWS, LA_COLS, LA_BLOCK, LA_LAM,
                                   seed=SEED + 30)
        fn = la_tasks.compile_pdml(la_tasks.PROGRAMS[task])
        want = la_f64(task, env)
        target = parse_program(la_tasks.PROGRAMS[task])[-1].target
        rows = []
        for i in range(LA_REQUESTS):
            res, ms = request(lambda: fn(env))
            got = res[target]
            if got.device.type != "cuda" or got.dtype != torch.float32:
                raise RuntimeError(f"{task}: result {got!r}")
            bad, err = la_violations(got, want)
            print(f"[la] {task} request {i}: {ms:.3f} ms, max abs err "
                  f"{err:.3e}, entries outside rtol=atol={LA_RTOL}: {bad} "
                  f"of {want.numel()}")
            if bad:
                raise RuntimeError(f"{task}: {bad} entries outside "
                                   f"rtol = atol = {LA_RTOL} of f64")
            rows.append((ms, err))
        ms = sorted(r[0] for r in rows)
        ref = la_tasks.REFERENCE_SECONDS[task]
        print(f"[la] {task}: p50 {ms[len(ms) // 2]:.3f} ms on this card; "
              f"the reference's C++ cluster (selfLearning/documentation.md): "
              f"{ref['plain']} s plain, {ref['best']} s best")
        out[task] = {"ms": [r[0] for r in rows], "p50_ms": ms[len(ms) // 2],
                     "max_abs_err": max(r[1] for r in rows),
                     "reference_cluster_seconds": ref}
        profiled[task] = (lambda fn=fn, env=env: fn(env), ms[len(ms) // 2])
        if task == "linreg":
            client = Client()
            interp = LAInterpreter(client=client)
            interp.env.update(env)
            _, ms = request(lambda: interp.run(la_tasks.PROGRAMS["linreg"]))
            (stored,) = list(client.get_set_iterator("la", target))
            bad, err = la_violations(stored, want)
            print(f"[la] linreg through LAInterpreter(client=Client()): "
                  f"{ms:.3f} ms, set la:{target} read back, max abs err "
                  f"{err:.3e}, {bad} entries outside")
            if bad or not client.set_exists("la", target):
                raise RuntimeError("linreg through the client's sets failed")
            out["linreg_client_ms"] = ms
        del want
    # the same tasks through run_all, the workload's own timer (CUDA
    # events around each request)
    for task, res in la_tasks.run_all(LA_ROWS, LA_COLS, LA_BLOCK,
                                      iters=LA_REQUESTS).items():
        print(f"[la] run_task({task!r}): first {res['first_ms']:.3f} ms, "
              f"p50 {res['ms_p50']:.3f} ms by {res['timer']} on "
              f"{res['device']}")
        out[task]["run_task_p50_ms"] = res["ms_p50"]
    return out, profiled


def la_path() -> dict:
    """Phase 10 between launch counts set to 0 and read: no attention
    kernel lies on the LA path."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled = phase_la()
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[la] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the LA path launched an attention kernel: "
                           f"{launches}")
    phase_profile(profiled, top=4)
    return out


# --- phase 11 ------------------------------------------------------------
TPCH_SF = 10           # lineitem 60 M rows, orders 15 M, partsupp 8 M
TPCH_REQUESTS = 3
TPCH_RTOL = 1e-3       # float aggregates: card vs CPU, card vs f64
TPCH_SINKS = ("q01_sink", "q06_sink", "q03_sink_for")
# the suite queries whose joins the planner plans: each gets one more
# request with the default LUT factor beside the measured crossover's
TPCH_LUT_AB = ("q02", "q03", "q04", "q12", "q14", "q17", "q22")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(run, device) -> tuple:
    """(output, ms) of one request, the device synchronised around it."""
    _sync(device)
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _leaves(out) -> list:
    """A sink's result as named host arrays: a table's columns and mask,
    or a core's raw tensors."""
    if isinstance(out, tuple):
        return [(f"out{i}", t.detach().cpu().numpy())
                for i, t in enumerate(out)]
    return ([(n, c.detach().cpu().numpy()) for n, c in sorted(out.cols.items())]
            + [("valid", out.mask().detach().cpu().numpy())])


def _rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin) or not np.array_equal(
            got[~fin], want[~fin]):
        return float("inf")
    if not fin.any():
        return 0.0
    return float((np.abs(got[fin] - want[fin])
                  / np.maximum(np.abs(want[fin]), 1e-30)).max())


def _top10(name, keys, ok, rev, dates, ref_keys, ref_ok, ref_rev,
           ref_dates) -> float:
    """Q03's top 10 against the CPU's top 11: revenues within TPCH_RTOL
    in order, the key set equal wherever the 10th and 11th revenues
    differ by more than that (below it, only keys above the band must
    agree), and each shared key's order date exactly. Returns the
    largest relative revenue error."""
    import numpy as np

    got = sorted(zip(rev[ok], keys[ok]), key=lambda x: -x[0])
    want = sorted(zip(ref_rev[ref_ok], ref_keys[ref_ok]),
                  key=lambda x: -x[0])
    d_got = dict(zip(keys[ok], dates[ok]))
    d_ref = dict(zip(ref_keys[ref_ok], ref_dates[ref_ok]))
    if any(d_got[k] != d_ref[k] for k in set(d_got) & set(d_ref)):
        raise RuntimeError(f"{name}: order dates differ from the CPU")
    if len(got) != min(len(want), 10):
        raise RuntimeError(f"{name}: {len(got)} rows, the CPU has "
                           f"{len(want)} of 11")
    err = _rel_err([r for r, _ in got], [r for r, _ in want[:len(got)]])
    if err > TPCH_RTOL:
        raise RuntimeError(f"{name}: top revenues off by {err:.3e}")
    cut = want[10][0] if len(want) > 10 else -np.inf
    sure = {k for r, k in want[:10] if r > cut * (1 + TPCH_RTOL)}
    if not sure <= {k for _, k in got}:
        raise RuntimeError(f"{name}: top-10 keys {sorted(k for _, k in got)}"
                           f" miss {sorted(sure)}")
    return err


def _q03_parts(q, out) -> tuple:
    """(keys, valid, revenue, order date) of a Q03 result as host arrays:
    the suite core's raw tensors or ``q03_sink``'s relation."""
    if q == "q03":
        ints, rev = out
        parts = (ints[0], ints[1] > 0, rev, ints[2])
    else:
        parts = (out["okey"], out.mask(), out["revenue"], out["odate"])
    return tuple(t.detach().cpu().numpy() for t in parts)


def _hold(name, got, ref) -> float:
    """A card result against the CPU's: integer and bool outputs (keys,
    counts, histograms, minima, join indices, masks) exactly, floats
    within TPCH_RTOL. Returns the largest relative float error."""
    import numpy as np

    worst = 0.0
    for (label, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        if a.shape != b.shape:
            raise RuntimeError(f"{name}.{label}: shape {a.shape} vs {b.shape}")
        if b.dtype.kind in "biu":
            if not np.array_equal(a, b):
                bad = int((a != b).sum())
                raise RuntimeError(f"{name}.{label}: {bad} integer entries "
                                   f"differ from the CPU")
            continue
        err = _rel_err(a, b)
        if err > TPCH_RTOL:
            raise RuntimeError(f"{name}.{label}: relative error {err:.3e} "
                               f"against the CPU")
        worst = max(worst, err)
    return worst


def tpch_oracle_f64(host, delta=19980902, d0=19940101, d1=19950101,
                    disc=0.06, qty=24) -> dict:
    """Q01's group sums and counts and Q06's revenue in float64 numpy
    over the host columns (the plain oracle)."""
    import numpy as np

    li = host["lineitem"][0]
    seg = li["l_returnflag"].astype(np.int64) * 2 + li["l_linestatus"]
    m = li["l_shipdate"] <= delta
    price = li["l_extendedprice"].astype(np.float64)
    d = li["l_discount"].astype(np.float64)
    dp = price * (1 - d)
    vals = (li["l_quantity"].astype(np.float64), price, dp,
            dp * (1 + li["l_tax"].astype(np.float64)), d)
    sums = np.stack([np.bincount(seg[m], weights=v[m], minlength=6)
                     for v in vals])
    counts = np.bincount(seg[m], minlength=6)
    lo = np.float32(disc) - np.float32(0.011)
    hi = np.float32(disc) + np.float32(0.011)
    dd = li["l_discount"]
    q6 = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1) & (dd >= lo)
          & (dd <= hi) & (li["l_quantity"] < qty))
    return {"q01_sums": sums, "q01_counts": counts,
            "q06": float((price[q6] * d[q6]).sum())}


def _hold_f64(name, got, oracle) -> float:
    """Q01 / Q06 on the card against the f64 oracle: counts exactly,
    sums within TPCH_RTOL."""
    import numpy as np

    if name.startswith("q01"):
        if isinstance(got, tuple):
            sums, counts = (t.cpu().numpy() for t in got)
        else:
            sums = np.stack([got[c].cpu().numpy() for c in (
                "sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
                "sum_disc")])
            counts = got["count"].cpu().numpy()
        if not np.array_equal(counts, oracle["q01_counts"]):
            raise RuntimeError(f"{name}: counts differ from f64")
        err = _rel_err(sums, oracle["q01_sums"])
    else:
        val = got[0] if isinstance(got, tuple) else got["revenue"]
        err = _rel_err(float(val.reshape(-1)[0]), oracle["q06"])
    if err > TPCH_RTOL:
        raise RuntimeError(f"{name}: relative error {err:.3e} against f64")
    return err


def phase_relational(pk: dict, device="cuda", sf=TPCH_SF,
                     requests=TPCH_REQUESTS) -> tuple:
    """The columnar relational engine at TPC-H SF ``sf``: the crossovers
    measured on the card (``tuning.autotune(persist=False)``), the eight
    tables drawn from the seed on the host and sent to a card client and
    a CPU client with ``send_table``; per query ``requests`` requests of
    ``suite_sink_for`` through ``run_query``, then the same of the three
    hand-built sinks, each held to the CPU client's same sink (and Q01,
    Q06 to an f64 oracle). Returns the results and one request of each
    to profile."""
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.relational import dag, tuning
    from netsdb_tpu_torch.relational.bench import PUBLISHED, generate_host
    from netsdb_tpu_torch.relational.queries import suite_args_split
    from netsdb_tpu_torch.relational.table import ColumnTable

    t0 = time.perf_counter()
    crossovers = tuning.autotune(device, persist=False)
    print(f"[tpch] crossovers measured on {tuning.device_kind(device)} "
          f"({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} {v:g}" for k, v in crossovers.items()))
    t0 = time.perf_counter()
    host = generate_host(sf, SEED)
    cpu_tables = {n: ColumnTable.from_columns(cols, dicts, device="cpu")
                  for n, (cols, dicts) in host.items()}
    gen_s = time.perf_counter() - t0
    card, cpu = Client(device=device), Client(device="cpu")
    for c in (card, cpu):
        c.create_database("tpch")
        for n, table in cpu_tables.items():
            c.create_set("tpch", n, type_name="table")
    _, up_ms = _timed(lambda: [card.send_table("tpch", n, t)
                               for n, t in cpu_tables.items()], device)
    for n, t in cpu_tables.items():
        cpu.send_table("tpch", n, t)
    tables = {n: card.get_table("tpch", n) for n in cpu_tables}
    resident = sum(c.numel() * c.element_size()
                   for t in tables.values() for c in t.cols.values())
    n_li = tables["lineitem"].num_rows
    if tables["lineitem"].device.type != torch.device(device).type:
        raise RuntimeError("lineitem did not reach the card")
    print(f"[tpch] SF {sf}: " + ", ".join(f"{n} {t.num_rows}"
                                          for n, t in tables.items())
          + f"; drawn and analysed on the host in {gen_s:.1f} s, sent in "
          f"{up_ms:.0f} ms, {resident / 2**30:.3f} GiB resident")
    oracle = tpch_oracle_f64(host)
    _, arrays = suite_args_split(tables)

    def sink_of(client, q):
        if q in TPCH_SINKS:
            if q == "q03_sink_for":
                return dag.q03_sink_for(client, "tpch")
            return getattr(dag, q)("tpch")
        return dag.suite_sink_for(client, "tpch", q)

    out, profiled = {}, {}
    for q in sorted(dag._QUERY_TABLES) + list(TPCH_SINKS):
        sink = sink_of(card, q)
        if q in ("q03", "q03_sink_for"):
            ref_sink = (dag.q03_sink_for(cpu, "tpch", k=11) if q != "q03"
                        else dag.suite_sink_for(cpu, "tpch", "q03", k=11))
        else:
            ref_sink = sink_of(cpu, q)
        ref, cpu_ms = _timed(lambda: dag.run_query(cpu, ref_sink), "cpu")
        times, worst = [], 0.0
        for i in range(requests):
            got, ms = _timed(lambda: dag.run_query(card, sink), device)
            leaves = _leaves(got)
            if any(torch.is_tensor(v) and v.device.type != torch.device(
                    device).type for v in (got if isinstance(got, tuple)
                                           else got.cols.values())):
                raise RuntimeError(f"{q}: the result left the card")
            if q in ("q03", "q03_sink_for"):
                err = _top10(q, *_q03_parts(q, got), *_q03_parts(q, ref))
            else:
                err = _hold(q, got, ref)
            if q.startswith(("q01", "q06")):
                err = max(err, _hold_f64(q, got, oracle))
            worst = max(worst, err)
            times.append(ms)
            print(f"[tpch] {q} request {i}: {ms:.3f} ms, {len(leaves)} "
                  f"outputs held to the CPU (rel err {err:.3e})")
        p50 = sorted(times)[len(times) // 2]
        row = {"ms": times, "p50_ms": p50, "cpu_ms": cpu_ms,
               "max_rel_err": worst,
               "lineitem_rows_per_s": n_li / (p50 / 1e3)}
        core = {"q01_sink": "q01", "q06_sink": "q06",
                "q03_sink_for": "q03"}.get(q, q)
        if core in arrays:
            nbytes = sum(a.numel() * a.element_size() for a in arrays[core])
            row["bytes_read"] = nbytes
            row["bound_ms"] = nbytes / pk["bytes"] * 1e3
        line = (f"[tpch] {q}: p50 {p50:.3f} ms, SF-{sf} lineitem rows/s "
                f"{row['lineitem_rows_per_s']:.4g}")
        line += (f", columns read {row['bytes_read'] / 2**20:.1f} MiB, "
                 f"bound {row['bound_ms']:.3f} ms (bytes)")
        line += f"; CPU {cpu_ms:.0f} ms"
        if q in PUBLISHED:
            row["reference_cluster_s"] = PUBLISHED[q]
            line += (f"; the reference's cluster {PUBLISHED[q]} s "
                     f"(BASELINE.md, its scale unrecorded)")
        if q in TPCH_LUT_AB:
            # the measured crossover against the default LUT joins, one
            # request each, held to the CPU like the others
            kind = tuning.device_kind(device)
            measured = tuning.get("join_lut_factor", kind)
            tuning.set_override("join_lut_factor",
                                tuning._DEFAULTS["join_lut_factor"], kind)
            try:
                got, row["lut_ms"] = _timed(
                    lambda: dag.run_query(card, sink), device)
            finally:
                tuning.set_override("join_lut_factor", measured, kind)
            _hold(q, got, ref) if q != "q03" else _top10(
                q, *_q03_parts(q, got), *_q03_parts(q, ref))
            line += (f"; with LUT joins (join_lut_factor "
                     f"{tuning._DEFAULTS['join_lut_factor']:g}) "
                     f"{row['lut_ms']:.3f} ms")
        print(line)
        out[q] = row
        profiled[f"tpch {q}"] = (lambda s=sink: dag.run_query(card, s), p50)
    out["crossovers"] = crossovers
    out["resident_gib"] = resident / 2**30
    out["sf"] = sf
    return out, profiled


def relational_path(pk: dict) -> dict:
    """Phase 11 between launch counts set to 0 and read: neither
    attention kernel lies on the relational path."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled = phase_relational(pk)
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[tpch] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the relational path launched an attention "
                           f"kernel: {launches}")
    rows = phase_profile(profiled, top=3)
    out["profile_top3"] = {k: [(ms, key[:60]) for ms, key in v[:3]]
                           for k, v in rows.items()}
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        import netsdb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the netsdb_tpu_torch package is missing ({e}); "
              f"run from the repository root", file=sys.stderr)
        return 2
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)
    from netsdb_tpu_torch.parallel.mesh import virtual_devices

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    pk = peaks(name)

    phase_build()
    if "--paged-only" in sys.argv[1:]:
        # phase 7 alone (for comparing trees); prints no contract line
        print(json.dumps({"paged": phase_paged(), "card": smi}))
        return 0
    if "--models-only" in sys.argv[1:]:
        # phase 8 alone, the same way
        print(json.dumps({"models": models_path(), "card": smi}))
        return 0
    if "--train-la-only" in sys.argv[1:]:
        # phases 9 and 10 alone, the same way
        print(json.dumps({"train": train_path(), "la": la_path(),
                          "card": smi}))
        return 0
    if "--relational-only" in sys.argv[1:]:
        # phase 11 alone, the same way
        print(json.dumps({"relational": relational_path(pk), "card": smi}))
        return 0
    b1 = phase_kernels(pk)
    b2 = phase_step_kernel(pk)

    client = Client()
    flash_attention.launches = flash_attention_step.launches = 0
    ff = phase_ff(client)
    tf = phase_transformer(client)
    b1_launches = flash_attention.launches
    if b1_launches == 0:
        raise RuntimeError("the main path never launched flash_attention")

    with virtual_devices(SP_POSITIONS, "cuda:0"):
        sp_client = Client()
        sp = phase_sp(sp_client)
        if sp["launches"] == 0:
            raise RuntimeError("the SP path never launched "
                               "flash_attention_step")
        phase_profile({
            "ff": (lambda: FFModel(block=(512, 512)).inference(client),
                   ff["ms"]),
            "transformer": (lambda: TransformerLayerModel(
                num_heads=8).serve_forward(client), tf["ms"]),
            "sp": (lambda: sp_model(sp_client)[0].serve_forward(sp_client),
                   sp["ms"])})

    paged = phase_paged()
    models = models_path()
    train = train_path()
    la = la_path()
    relational = relational_path(pk)

    print(json.dumps({"ff_rows_per_s": ff["rows_per_s"],
                      "transformer_tokens_per_s": tf["tokens_per_s"],
                      "sp_tokens_per_s": sp["tokens_per_s"],
                      "sp_max_abs_err": sp["max_abs_err"],
                      "paged": paged, "models": models, "train": train,
                      "la": la, "relational": relational, "card": smi}))

    def kernel_row(kname, source, replaces, by_path, row):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bound_3xtf32_ms": row["bound_3xtf32_ms"],
                "library_ms": row["library_ms"]}

    print(json.dumps({"kernels": [
        kernel_row("flash_attention",
                   "netsdb_tpu_torch/csrc/flash_attention.cu",
                   "netsdb_tpu/ops/pallas_kernels.py:135",
                   {"inference": b1_launches,
                    "training": train["transformer_b1_launches"]}, b1),
        kernel_row("flash_attention_step",
                   "netsdb_tpu_torch/csrc/flash_attention_step.cu",
                   "netsdb_tpu/ops/pallas_kernels.py:286",
                   {"sequence_parallel": sp["launches"]}, b2)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
