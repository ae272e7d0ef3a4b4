#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``netsdb_tpu_torch``) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py
(``--paged-only``: phases 1 and 7 alone, without the contract's last
line, to compare the paged path of two trees; ``--models-only``: phases
1 and 8 alone, the same way; ``--train-la-only``: phases 1, 9 and 10;
``--relational-only``: phases 1 and 11; ``--paged-relations-only``:
phase 1, the SF 10 tables made resident on a card client, and phase
12; ``--rows-only``: phases 1 and 13; ``--compiled-only``: phases 1 and
14, TPC-H at ``COMPILED_ONLY_SF``; ``--workloads-only``: phases 1 and
15; ``--serve-only``: phases 1 and 16; ``--pool-only``: phases 1 and
17; ``--mesh-only``: phase 1, the SF 10 tables made resident on a card
client, and phase 18; ``--multichip-only``: phases 1 and 19;
``--obs-only``: phases 1 and 20; ``--ha-only``: phases 1 and 21.)

Every phase runs with the compiled-program cache in use and
``plan_fusion`` on, the port's defaults: a resident job is one CUDA
graph, captured on its first request and replayed after that.

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
   this path;
12. paged relations at the same SF: lineitem, orders and partsupp sent
   with ``storage="paged"`` into an arena of ``PAGED_REL_POOL_BYTES`` in
   pages of ``PAGED_REL_PAGE_BYTES`` (it spills), the other tables
   resident. Per suite query a cold request (device cache resized to
   0), one that installs the blocks and two warm ones, each held to the
   same sink on phase 11's resident card client (``_hold``, Q03's
   top-10 rule); each prints its ms, pages read, spills and loads,
   staged bytes and copy GB/s, chunks, host syncs (sync debug mode),
   graphs captured and peak memory above what was allocated (a fold's
   step captures from its second request on, so a cold request holds no
   graph's copies). Warm requests must read no
   page and stage no byte, except Q12, whose one-pass grace hash over
   the paged orders must read lineitem's pages exactly once a request;
   a cold request's peak must stay under half of lineitem's bytes. Then
   Q03 through ``q03_build_sink`` into a paged set and
   ``q03_probe_sink``; one cold request under the profiler (uploads
   pinned, on a stream the fold's kernels do not use) and one warm
   request of each query (busy share, top three kernels).

13. the host-record relational path (``ROWS_SIZES``): the ten row TPC-H
   DAGs (``workloads.tpch``, micro scale 20, about 9 000 lineitems) on a
   card client, each held to a CPU client's same DAG (ints and strings
   exactly, floats within ``ROWS_FLOAT_RTOL``, in order), allocating
   nothing on the card; the same generator at scale 200 written as dbgen
   ``.tbl`` files and loaded by ``load_tbl_dir`` and
   ``load_tbl_dir_columnar`` (the native parser must build), their MB/s;
   lineitem's records in a paged set (64 KiB pages, a 256 KiB pool, so
   it spills) through Q01 and Q06, equal to the memory sets' results;
   reddit's 200 000 comments sent to ``type_name="objects"`` sets and
   joined three ways by ``Join(on=...)`` on the card, held to the CPU
   client and, row for row, to the host hash join over the same
   records; reddit's columnar bench (1 M comments, 50 000 authors,
   ``send_table``): ``three_way_sink_for``, ``propagate_labels``,
   ``author_comment_counts`` and ``label_partition_counts``, 3 requests
   each, held exactly to the CPU client; tpch-bench's host DAGs at 20 000
   customers held to ``queries_on_sets`` over ``columnarize`` of the same
   customers on the card, then its bench size (100 000 customers x 2048
   parts, k 10) held to the CPU client (the same top list, scores within
   ``JACCARD_RTOL``). Per request kind the p50 ms, rows/s, the bound by
   bytes, the CPU's ms; one profiled request of each device kind (busy
   share, top three kernels). No hand-written kernel lies on this path.

14. compiled plans (``plan/executor.py``'s program cache, one CUDA graph
   per program and input signature): the cache cleared, then per
   resident request — FF, the layer, logistic regression, word2vec's and
   the text classifier's DAGs, the LSTM (f32, bf16), conv2d, the three LA
   tasks through ``compile_pdml`` and the ten TPC-H suite queries on
   phase 11's client — one cold request (the capture) and
   ``COMPILED_WARM`` warm ones, each held to the same request run node by
   node (``node_by_node``: the executor's eager evaluator) within the
   path's tolerance, with ms, busy share, captures, replays, the bytes
   captured and every fallback with its reason. Warm requests must build
   no program; ``MUST_CAPTURE`` requests must capture with no fallback;
   the layer launches B1 once a request and the sequence-parallel layer
   (phase 5's size) B2 16 times, counted through the replays and by the
   profiler on the card. Then the stale-graph cases (``_compiled_stale``:
   a new FF batch, an earlier result re-read, a second FF of other
   shapes in the same db and job, a small and a large set rewritten with
   the same shape and in place, a set evicted and reloaded, the same
   labels with another constant, two threads building at once), each
   held to node by node. Then warm paged Q01, Q03 and Q12 on phase 12's
   client, the mixed spine plan and the graft chain of
   ``_region_plans`` (which must form regions) and a paged FF (also
   node by node), with ``plan_fusion`` on and off (ms, chunks, host ms
   per chunk, regions formed, captures, replays), the two settings'
   results equal and no measured request capturing.

15. the single-device workloads, MoE and dedup (``WL_SIZES``), each
   through the port's ``Client`` on the card: ``kmeans_on_set`` (4 M x
   128 points around 100 planted centres at least 10 sigma apart, k 100,
   10 rounds) and ``kmeans(init="sample")``, ``gmm_on_set`` (1 M x 32, k
   16, 20 rounds), ``lda_on_set`` (50 000 x 20 000 counts, k 50, 50
   rounds), ``pagerank_on_table_set`` and ``pagerank`` at
   soc-LiveJournal1's 4 847 571 nodes and 68 993 773 edges (a power-law
   graph drawn from the seed), ``pagerank_on_set`` over 1 M edge objects,
   ``top_k_on_table_set`` over 60 M scores with planted ties and
   ``top_k_on_set`` over 100 000 objects, ``ConvFusionPipeline.run`` (8
   images 3 x 112 x 112, 64 filters 7 x 7, its host ms a job),
   ``moe_forward`` at Switch-Base-128's widths (4096 tokens, 128
   experts), ``dedup_resident`` over two FF models at bench.py's widths
   (one block in 8 changed) and ``bench_lsh_zoo()``. Each request
   ``WL_REQUESTS`` times (ms, p50, its bound by bytes or operations, peak
   memory) and once under the profiler (busy share, top five kernels);
   each held to the same function in float64 on the card from the same
   seed and initial state (``WL_TOLS``): k-means assignments equal
   (a point whose two best f64 scores lie within f32 rounding is counted
   as a tie and printed), top-k equal to numpy's stable order, conv to
   ``F.conv2d``, the conv job compiled equal to node by node, the dedup
   report equal to the planted counts and both FF models bit-equal to
   before pooling, node by node and compiled, and again after
   ``drop_pool_caches`` (which must capture anew). Every workload also
   runs at a small size on the card and on a CPU client from the same
   inputs.

16. one serving daemon on the card (``SERVE_SIZES``), in its own
   process (``serve.server.run_daemon`` on a ``Configuration`` with
   ``model_dedup`` and ``SERVE_PAGE_BYTES`` pages, ``port=0``), this
   script its client over localhost TCP: FF at bench.py's shape with
   weights and inputs sent out of band and three EXECUTE_COMPUTATIONS,
   each held to f64 (1e-4) and to the in-process client on the card
   (request p50 remote and in-process, ingest MB/s, the daemon's busy
   share over the requests); the transformer layer (embed 1024, 8
   heads, batch 2, seq 4096) executed by the daemon, held to the layer
   with plain attention (1e-3), B1 launched in the daemon at least once
   a request (read through COLLECT_STATS); Q01 over a paged lineitem
   (SF 0.2) by two clients at once through one captured fold-step graph,
   in six pairs after a cold, a capturing and a warm request, every
   result held to the plan run node by node in this process; decode sessions
   through ``SessionHandle``: an LSTM (hidden 1024) and the layer (embed
   1024, 8 heads, kv_max 64), 12 concurrent sessions of 128 steps each
   per model, one session re-run solo and bit-equal to its batched run,
   every output within ``SERVE_DECODE_TOLS`` of an f64 oracle written in
   this script, two step programs (one per kind, shape and bucket) and
   no arena read; two fine-tuned layer variants of one base
   (``finetune_frac`` 0.25) pooled by ``model_dedup``, each one's step
   held to the oracle with its own weights, the residency report's
   unique page bytes equal to the tiles planted and its charges summing
   to them. Every line carries
   the card's name and power limit; the daemon is stopped (SHUTDOWN,
   then killed if it lingers) whatever happens.

17. the shard pool on the card (``POOL_SIZES``): a leader and 3 workers
   (the reference's ``daemons=4``) and a solo daemon, each in its own
   process on card 0 (``serve.server.run_daemon``, the leader with
   ``workers=``), this script their client. The reference's serving
   gate (batch 8192, 256 -> 512 -> 64, blocks 128, integer-valued
   weights in [-3, 3), 6 frames through ``models.serving.ff_serving``):
   every frame byte-equal to the solo daemon, every shard's EXPLAIN one
   program, no daemon holding more than ceil(B/4) input rows. FF at
   bench.py's width (16384 x 1024 -> 4096 -> 1024, 512 blocks, 4096 rows
   a slot), three frames each held to f64 within ``FF_TOL``, with the
   pool's and the solo daemon's rows/s on this one card. The scale-out
   bench's configuration: 6 000 000 rows range-placed in 65 536-row
   pages (routed ingest MB/s against one daemon's), six cold integer
   Q01 scatters byte-equal to solo, ``relational.dag.q01_sink`` over a
   float table of the same placement (ints exact, floats within rtol
   1e-5), the shuffle join (2048 orders, 400 000 lineitems, hash-placed)
   byte-equal to solo with its 24 buckets counted; the last Q01
   scatter's GET_TRACE profile at the leader must carry every worker's
   profiles under the same query id (``shards``). Then a worker is
   stopped, a scatter started and the worker killed: the client gets the
   typed retryable refusal and the output set keeps its rows; an append
   buffers for the dead slot; the worker restarts on its port, reloads
   its flushed slot and is readmitted (SHARD_RESYNC, the handoff drain),
   and the query equals solo again. Last, a leader, a worker and a solo
   daemon in this process on the card with the same set names run the
   Q01 scatter and the shuffle join at 200 000 rows four times, every
   result equal to solo, with graph captures and replays counted. Each
   daemon's busy seconds and peak reserved memory and the card's used
   memory are printed, every line with the card's name and power limit;
   every process is killed whatever happens.
18. the in-process mesh on the card: 4 virtual positions of card 0 (the
   reference's ``mesh4``). The four collectives at bench.py's first FF
   layer (integer-valued A 16384 x 1024, B 1024 x 4096), each byte-equal
   to one ``torch.matmul`` (or the unsharded tensor); Ulysses at phase
   5's shape (batch 2, seq 16384, 8 heads, head dim 128, causal) in f32
   and bf16, B1 launched once per position a call, held to one B1 call
   over the whole tensor and (f32) to f64 head by head within
   ``SP_TOL``, timed beside the ring (B2); SUMMA at micro_bench's gate
   (65 536 x 512 paged, rhs 512 x 256, integer-valued) 1-d and 2x2, each
   byte-equal to the single-position stream, a position's staged bytes
   about 1/4 of the replicated arm's, a warm rerun reading no page; FF
   at bench.py's width with paged weights and ``distributed_matmul``
   (every paged node through SUMMA, held to f64 and to one position);
   ``reshard_set`` of a warm 200 000-row placed table and
   ``reshard_summa_layout`` of FF's w1 (1-d → 2x2 → 1-d), no page read;
   the ten suite queries over placed SF 10 sets (lineitem and orders
   row-sharded, the rest replicated) against the one-position resident
   client (integers exactly, floats within rtol 1e-5, atol 1e-3), a paged
   and placed lineitem's Q01 and Q06 cold and warm; ``shuffle_q03`` and
   ``q03_row_sink_for`` against the resident Q03, ``Partition`` over the
   placed orders, ``distributed_top_k`` over 60 M scores against
   ``torch.topk``; the peak reserved memory, the card's used memory, the
   programs captured and replayed, and every fallback with its reason
   (a placed request's fails the phase);
19. the rest of the mesh in one process, on 4 virtual positions of card
   0, each request held to the same request on one position (sets
   unplaced, on the same card) and its ms printed beside that one's:
   the pipeline (``MC_PIPELINE``: 4 stages of tanh(x W + b) at d 4096,
   8 microbatches of 2048 rows), byte-equal to the stages run in turn
   and within ``MC_PP_ATOL`` of f64; expert-parallel MoE at phase 15's
   widths (32 experts a position) within ``MC_MOE_RTOL`` of ``mesh=None``
   and ``moe_atol`` of f64, with the dropped tokens; logistic regression,
   word2vec (the reference test's row-sharded table, and replicated)
   and the LSTM at phase 8's widths with the reference tests'
   placements, against f64 at ``MODEL_TOLS``; three data-parallel FF
   training steps at phase 9's size (``check_step`` against f64, the
   replicas bit-identical, loss and params against the one-position
   steps); k-means (from the planted centres), GMM and LDA (from one
   start), ``pagerank_on_table_set``, ``top_k_on_table_set`` and the
   conv pipeline at phase 15's sizes over row-sharded sets, at
   ``WL_TOLS``; ``dryrun_multichip(4)``, its scalars against the same
   sections on one position, then ``dryrun_multichip`` at 2 and 8
   positions (B2 at head dim 8 and seq 16 and 64). Every gather of a placed tensor is printed
   with its reason, and a data-parallel request that gathers fails the
   phase; then the peak reserved memory, the card's used memory and the
   programs captured and replayed;
20. the daemon's observability (``OBS_SIZES``): one daemon in its own
   process with per-query ``torch.profiler`` sessions
   (``obs_device_profile_dir``), a slow-query threshold under a layer
   request, a 0.5 s telemetry history, the scheduler's feedback (every
   ``OBS_FEEDBACK_EVERY`` admissions) and SLO shedding. Two clients with
   their own identities ship their traces: one runs phase 3's FF (3
   requests), paged Q01 at SF 0.2 (cold, capturing, warm) and phase 4's
   layer (3 requests, B1 once each in the daemon), the other a 128-step
   LSTM decode session traced 1 in 8 steps; every output held to its
   phase-16 limit. Each traced request's GET_TRACE profile must hold a
   ``server.decode`` span first, the dispatch and the executor (or the
   decode batch), the merged client section whose top-level spans are
   within 20% of the request's wall time, and the host/device split, with
   no profiler or device-time error; the paged Q01 must show staging or
   device-cache counters. Each layer request's device profile (its
   Chrome trace under the query id) must show B1 exactly once; its B1
   time is printed beside the trace's ``device.est_s``. The OpenMetrics
   scrape must parse, carry both clients' labels and count exactly the
   workload frames this process sent; HEALTH the default objectives with
   burn rates; the slow-query log every layer request within its bound;
   the scheduler at least one reseed (its lane weights printed). Then
   the same warm FF and layer requests against a daemon with tracing on
   and one with it off, in turns: both p50s and their ratio, printed,
   not gated.
21. replication and failover (``HA_SIZES``): daemons A, B and C, each
   in its own process on card 0 (``run_daemon`` with ``ha_mutlog``, HA
   armed over [A, B, C] with a ``HA_ELECTION_S`` election window and the
   ``HA_LINKS`` heartbeats), A mirroring to B and C. Phase 3's FF and
   phase 4's layer, three requests each through A: every output read
   from A, B and C directly is byte-equal, FF within ``FF_TOL`` of f64
   and the layer within ``LAYER_TOL`` of plain attention, B1 once a
   layer request in each daemon (A's COLLECT_STATS with its followers'
   sections); the mirrored p50s beside phase 16's solo ones (printed,
   not gated: the three daemons share the card). Hedged reads of FF's
   output from a client with replicas [B, C], warm and with A's
   STREAM_ITEM replies delayed by its injector: byte-equal to the
   unhedged read, a hedge won, the p50s and ``hedge_delay_s()``
   printed. C SIGKILLed while numbered batches stream through A (a
   typed ``FollowerDegraded`` retried by ``send_data``), restarted on
   its root (its store rebuilt from its base snapshot and a bounded tail
   of its applied log) and readmitted by log replay,
   then SIGKILLed and restarted on an empty root and readmitted by a
   snapshot; after each, every set of C hashes equal to A's. A
   SIGKILLed while a failover client streams batches: B leads at term 2,
   every acknowledged batch is in B and C exactly once (counts and a
   checksum), a layer EXECUTE on B launches B1 once in B and in C and
   equals the output before the kill. A restarted on its root refuses a
   write with a typed ``NotLeader`` naming B and term 2. Every daemon is
   stopped and every process joined whatever happens.

The kernels' launch counters are set to 0 just before phase 3 and read
just after phase 4 (the main path of FF and the layer), set to 0 again
just before phase 5's requests and read just after them, again
around each model's paged requests in phase 7, around phase 8, where
both must read 0, around phase 9 (B1 once a layer step and once in the
one-position dry run, B2 never) and
around phases 10, 11, 12 and 13 (both 0), around phase 14 (B1 once a
layer request, B2 16 times an SP request) and around phase 15 (both 0);
phase 16's launches are the daemon's own counters, read before and
after through COLLECT_STATS (B1 at least once a served layer request,
B2 never), and phase 17's the pool daemons' and the solo's summed the
same way, and this process's around the in-process pool (both 0); around
phase 18 (B1 4 times a Ulysses call, B2 never; the comparisons' launches
are taken back out); and around phase 19's ``dryrun_multichip(4)`` (B2
at least once, its ring; B1 never); phase 20's are the observed
daemon's own counters (B1 once a layer request, B2 never), and phase
21's the daemons' own counters around the mirrored layer requests (B1
once a request in each of A, B and C) and around the layer request on
the promoted leader (once in B, once in its follower C). The last
line is the contract's device record.
Without a CUDA card, or without the package beside it, it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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


def profile_staged(name: str, run, request_ms: float,
                   compute_kernel: Optional[str] = None) -> dict:
    """One cold staged request under torch.profiler, read from its trace:
    where the host-to-device copies ran (their streams, pinned or
    pageable source), how long they took, how much of that time kernels
    ran on other streams, the device's busy share of the unprofiled
    request and the kernels by device time. Raises if a copy came from
    pageable memory or ran on a stream that also ran kernels — or, with
    ``compute_kernel``, on a stream that ran a kernel of that name (the
    staged relation chunks are padded and transposed on the copy stream
    itself, so there only the request's compute must stay off it)."""
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
    kernel_streams = {e.get("args", {}).get("stream") for e in kernels
                      if compute_kernel is None
                      or compute_kernel in e["name"]}
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
    dry, ms = request(lambda: dryrun_multichip(1))
    loss = dry["loss"]
    print(f"[train] graft_entry.dryrun_multichip(1): loss {loss:.6f} in "
          f"{ms:.3f} ms; sections {dry}")
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
    steps launch B1 three times and B2 never; FF and logreg launch
    neither, and the dry run at one position launches B1 once (its
    sequence-parallel section over a one-position mesh is the layer's
    single-device forward). One step of each model is profiled after the
    read, with B1's share of the layer's step."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled = phase_train()
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[train] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (TRAIN_STEPS + 1, 0):
        raise RuntimeError(f"the training path launched (B1, B2) = "
                           f"{launches}, want ({TRAIN_STEPS + 1}, 0)")
    out["path_b1_launches"] = launches[0]
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
    return out, profiled, {"card": card, "host": host}


def relational_path(pk: dict) -> tuple:
    """Phase 11 between launch counts set to 0 and read: neither
    attention kernel lies on the relational path. Returns the results and
    phase 11's card client and host tables, which phase 12 reuses."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled, state = phase_relational(pk)
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[tpch] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the relational path launched an attention "
                           f"kernel: {launches}")
    rows = phase_profile(profiled, top=3)
    out["profile_top3"] = {k: [(ms, key[:60]) for ms, key in v[:3]]
                           for k, v in rows.items()}
    return out, state


# --- phase 12 ------------------------------------------------------------
# netsDB's page size (the reference's default) and bench_paged_set_api's
# pool: lineitem's 2.9 GB of columns do not fit, so ingest and cold reads
# spill; the cache of the install and warm requests holds every chunk
PAGED_REL_PAGE_BYTES = 64 << 20
PAGED_REL_POOL_BYTES = 1 << 30
PAGED_REL_CACHE_BYTES = 8 << 30
PAGED_REL_FACTS = ("lineitem", "orders", "partsupp")  # tests/test_paged_sets.py


def _rel_request(client, run) -> tuple:
    """``staged_request`` plus the arena's spills and loads, the peak
    device memory above what was allocated before the request, and the
    host synchronisations counted by the sync debug mode while ``run``
    ran (every thread's)."""
    import torch

    from netsdb_tpu_torch.plan import programs

    arena0 = client.store.page_store().stats()
    captures0 = programs.program_stats()["captures"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out, rec = staged_request(client, counted)
    arena1 = client.store.page_store().stats()
    rec["spills"] = arena1["spills"] - arena0["spills"]
    rec["loads"] = arena1["loads"] - arena0["loads"]
    rec["peak_above_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    rec["captures"] = programs.program_stats()["captures"] - captures0
    rec["syncs"] = sum("synchroniz" in str(w.message).lower()
                       for w in caught)
    rec["copy_gbps"] = rec["staged_bytes"] / (rec["ms"] * 1e6)
    return out, rec


def _resident_card(sf, device="cuda") -> dict:
    """Phase 11's state without phase 11: the host tables and a card
    client holding them resident (``--paged-relations-only``)."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.relational.bench import generate_host
    from netsdb_tpu_torch.relational.table import ColumnTable

    host = generate_host(sf, SEED)
    card = Client(device=device)
    card.create_database("tpch")
    for n, (cols, dicts) in host.items():
        card.create_set("tpch", n, type_name="table")
        card.send_table("tpch", n, ColumnTable.from_columns(cols, dicts,
                                                            device="cpu"))
    return {"card": card, "host": host}


def phase_paged_relations(pk: dict, state: dict, sf=TPCH_SF,
                          device="cuda") -> dict:
    """The ten TPC-H folds streamed page by page at SF ``sf``: lineitem,
    orders and partsupp paged (pages of PAGED_REL_PAGE_BYTES in an arena
    capped at PAGED_REL_POOL_BYTES), the other tables resident, all
    through ``send_table`` into one card client. Per query one cold
    request (device cache resized to 0), one that installs the blocks
    (cache resized to PAGED_REL_CACHE_BYTES) and two warm ones, each held
    to the same sink on phase 11's resident card client (``_hold``, and
    Q03's top-10 rule); warm requests must read no page and stage no
    byte, except Q12, which takes the one-pass grace hash over the paged
    orders on every request (``probe_passes`` 1.0 over lineitem's
    pages). Then Q03 through ``q03_build_sink`` into a paged build set
    and ``q03_probe_sink``. One cold request under the profiler (copy
    streams, pinned source, rate) and, right after its warm requests, one
    warm request of each query (busy share, top three kernels)."""
    import tempfile

    import numpy as np
    import torch

    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.storage.store import SetIdentifier

    t_phase = time.perf_counter()
    resident, host = state["card"], state["host"]
    out = {}
    root = tempfile.mkdtemp(prefix="netsdb_paged_rel_")
    try:
        client, ingest_s = _paged_card(host, root, device)
        store, cache = client.store, client.store.device_cache()
        rels = {n: store.paged_relation(SetIdentifier("tpch", n))
                for n in PAGED_REL_FACTS}
        li = rels["lineitem"]
        li_bytes = li.num_rows * (len(li.int_names) + len(li.float_names)) * 4
        chunk_mib = li.pad_rows() * (len(li.int_names)
                                     + len(li.float_names) + 2) * 4 / 2**20
        arena = store.page_store().stats()
        print(f"[tpch-paged] SF {sf}: "
              + ", ".join(f"{n} {r.num_rows} rows in {r.num_pages()} pages"
                          for n, r in rels.items())
              + f"; ingest {ingest_s:.1f} s; lineitem {li_bytes / 2**30:.3f}"
              f" GiB, chunk {chunk_mib:.1f} MiB ({li.pad_rows()} rows); "
              f"arena {PAGED_REL_POOL_BYTES >> 20} MiB of "
              f"{PAGED_REL_PAGE_BYTES >> 20} MiB pages, {arena['spills']} "
              f"spills at ingest")
        if not arena["spills"] > 0:
            raise RuntimeError(f"the arena never spilled at ingest: {arena}")

        def check(q, got, ref) -> float:
            if q == "q03":
                return _top10(q, *_q03_parts(q, got), *_q03_parts(q, ref))
            if q == "q03_probe":
                return _top10(q, *_q03_parts(q, got), *_q03_parts(
                    "q03_sink_for", ref))
            return _hold(q, got, ref)

        def drive(q, sink, ref, grace=False) -> dict:
            recs = []
            for kind in ("cold", "install", "warm", "warm"):
                if kind == "cold":
                    cache.resize(0)
                elif kind == "install":
                    cache.resize(PAGED_REL_CACHE_BYTES)
                before = li.pages_streamed
                got, rec = _rel_request(client,
                                        lambda: dag.run_query(client, sink))
                rec["kind"] = kind
                rec["max_rel_err"] = check(q, got, ref)
                rec["lineitem_passes"] = ((li.pages_streamed - before)
                                          / li.num_pages())
                recs.append(rec)
                print(f"[tpch-paged] {q} {kind:7s} {rec['ms']:.3f} ms, "
                      f"{rec['page_reads']} pages read, {rec['spills']} "
                      f"spills, {rec['loads']} loads, {rec['staged_bytes']} "
                      f"bytes staged ({rec['copy_gbps']:.2f} GB/s over the "
                      f"request), {rec['chunks']} chunks, "
                      f"{rec['cached_runs']} cached runs, {rec['syncs']} "
                      f"host syncs, {rec['captures']} captures, peak "
                      f"{rec['peak_above_mib']:.1f} MiB "
                      f"above the resident tables, lineitem pages read "
                      f"{rec['lineitem_passes']:.2f} times, rel err "
                      f"{rec['max_rel_err']:.3e}")
            cold, warm = recs[0], recs[2:]
            if not cold["page_reads"] > 0 or not cold["staged_bytes"] > 0:
                raise RuntimeError(f"{q}: the cold request read no page")
            if not cold["peak_above_mib"] * 2**20 < li_bytes / 2:
                raise RuntimeError(
                    f"{q}: the cold request's peak {cold['peak_above_mib']:.0f}"
                    f" MiB is not bounded by chunks (lineitem "
                    f"{li_bytes / 2**20:.0f} MiB)")
            for rec in recs if grace else warm:
                if grace:
                    # the probe is lineitem, read once by the partitioning
                    if rec["lineitem_passes"] != 1.0:
                        raise RuntimeError(
                            f"{q}: the grace hash read the probe's pages "
                            f"{rec['lineitem_passes']} times")
                elif rec["page_reads"] or rec["staged_bytes"]:
                    raise RuntimeError(
                        f"{q}: a warm request read {rec['page_reads']} pages "
                        f"and staged {rec['staged_bytes']} bytes")
            return {"requests": recs, "cold_ms": cold["ms"],
                    "install_ms": recs[1]["ms"],
                    "warm_ms": [r["ms"] for r in warm],
                    "cold_peak_above_mib": cold["peak_above_mib"],
                    "cold_captures": cold["captures"],
                    "max_rel_err": max(r["max_rel_err"] for r in recs)}

        profile_done = False
        for q in sorted(dag._QUERY_TABLES):
            k = {"k": 11} if q == "q03" else {}
            ref = dag.run_query(resident, dag.suite_sink_for(
                resident, "tpch", q, **k))
            sink = dag.suite_sink_for(client, "tpch", q)
            grace = q == "q12"
            out[q] = drive(q, sink, ref, grace=grace)
            if grace:
                print(f"[tpch-paged] q12 took the one-pass grace hash over "
                      f"orders' {rels['orders'].num_pages()} pages: probe "
                      f"passes {[r['lineitem_passes'] for r in out[q]['requests']]}")
            rows = phase_profile({f"tpch-paged {q} warm": (
                lambda s=sink: dag.run_query(client, s),
                out[q]["warm_ms"][-1])}, top=3)
            out[q]["profile_top3"] = [(ms, key[:60]) for ms, key in
                                      next(iter(rows.values()), [])[:3]]
            if not profile_done:
                # one cold request under the profiler: where the uploads
                # ran, from what memory, at what rate
                cache.resize(0)
                out[q]["cold_profile"] = profile_staged(
                    f"tpch-paged {q}", lambda s=sink: dag.run_query(
                        client, s), out[q]["cold_ms"],
                    compute_kernel="reduce_kernel")
                cache.resize(PAGED_REL_CACHE_BYTES)
                dag.run_query(client, sink)
                profile_done = True

        # Q03 through a paged build set, then the probe sink
        cinfo = client.analyze_set("tpch", "customer")
        oinfo = client.analyze_set("tpch", "orders")
        client.create_set("tpch", "q03_build", type_name="table",
                          storage="paged")
        _, build_ms = _timed(lambda: client.execute_computations(
            dag.q03_build_sink(
                "tpch", n_customers=cinfo["stats"]["c_custkey"].key_space,
                segment_code=cinfo["dicts"]["c_mktsegment"].index(
                    "BUILDING"))), device)
        bpc = store.paged_relation(SetIdentifier("tpch", "q03_build"))
        print(f"[tpch-paged] q03_build_sink: {build_ms:.3f} ms, "
              f"{bpc.num_rows} qualifying orders in {bpc.num_pages()} "
              f"pages")
        ref = dag.run_query(resident, dag.q03_sink_for(resident, "tpch",
                                                       k=11))
        out["q03_probe"] = drive(
            "q03_probe", dag.q03_probe_sink(
                "tpch", n_orders=oinfo["stats"]["o_orderkey"].key_space),
            ref, grace=bpc.num_pages() > 1)
        out["q03_probe"]["build_ms"] = build_ms
        out["q03_probe"]["build_pages"] = bpc.num_pages()

        out["arena"] = store.page_store().stats()
        out["device_cache"] = cache.stats()
        print(f"[tpch-paged] arena: {json.dumps(out['arena'])}")
        print(f"[tpch-paged] device cache: {json.dumps(out['device_cache'])}")
    except BaseException:
        _close_paged({"client": locals().get("client"), "root": root})
        raise
    # phase 14 reads the same paged client; it closes it
    state["paged"] = {"client": client, "root": root}
    out["sf"] = sf
    out["lineitem_gib"] = li_bytes / 2**30
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[tpch-paged] phase 12 wall time {out['wall_s']:.1f} s")
    return out


def _paged_card(host, root, device="cuda") -> tuple:
    """A card client over ``root`` with lineitem, orders and partsupp paged
    (PAGED_REL_PAGE_BYTES pages in a PAGED_REL_POOL_BYTES arena, a
    PAGED_REL_CACHE_BYTES device cache) and the other tables resident;
    returns it and the ingest seconds."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.table import ColumnTable

    client = Client(Configuration(
        root_dir=root, page_size_bytes=PAGED_REL_PAGE_BYTES,
        page_pool_bytes=PAGED_REL_POOL_BYTES,
        device_cache_bytes=PAGED_REL_CACHE_BYTES), device=device)
    client.create_database("tpch")
    t0 = time.perf_counter()
    for n, (cols, dicts) in host.items():
        client.create_set("tpch", n, type_name="table",
                          storage="paged" if n in PAGED_REL_FACTS
                          else "memory")
        client.send_table("tpch", n, ColumnTable.from_columns(
            cols, dicts, device="cpu"))
    return client, time.perf_counter() - t0


def _close_paged(paged: Optional[dict]) -> None:
    """Close a paged client's arena and remove its directory."""
    import shutil

    if not paged:
        return
    if paged.get("client") is not None:
        paged["client"].store.page_store().close()
    shutil.rmtree(paged["root"], ignore_errors=True)


def paged_relations_path(pk: dict, state: Optional[dict] = None) -> dict:
    """Phase 12 between launch counts set to 0 and read: neither
    attention kernel lies on this path. Without phase 11's ``state``
    (``--paged-relations-only``) the resident card client is made
    here."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    if state is None:
        state = _resident_card(TPCH_SF)
    flash_attention.launches = flash_attention_step.launches = 0
    out = phase_paged_relations(pk, state)
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[tpch-paged] launches on this path: flash_attention "
          f"{launches[0]}, flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the paged relational path launched an "
                           f"attention kernel: {launches}")
    return out


# --- phase 13 ------------------------------------------------------------
# the sizes of phase 13 (PERF.md §4): row TPC-H at micro scale 20 (about
# 9 000 lineitems), its .tbl files at scale 200, paged records in 64 KiB
# pages under a 256 KiB pool (it spills), reddit's objects at 200 000
# comments, reddit's columnar bench (1 M comments, 50 000 authors), the
# tpch-bench host DAGs at 20 000 customers and its bench at 100 000
# customers x 2048 parts
ROWS_SIZES = {"tpch_scale": 20, "tbl_scale": 200,
              "page_bytes": 64 << 10, "pool_bytes": 256 << 10,
              "reddit_objects": (200_000, 10_000, 500),
              "reddit_bench": (1_000_000, 50_000, 500),
              "tb_host_customers": 20_000,
              "tb_bench": (100_000, 2048, 10)}
ROWS_REQUESTS = 3
ROWS_FLOAT_RTOL = 1e-9  # row TPC-H: Python floats on both clients
JACCARD_RTOL = 1e-6


def _same_rows(name, got, want, path="") -> float:
    """A host result against the CPU client's, in order: ints, strings
    and bools exactly, floats within ROWS_FLOAT_RTOL. Returns the largest
    relative float error."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            raise RuntimeError(f"{name}{path}: keys {list(got)[:5]} vs "
                               f"{list(want)[:5]}")
        return max([_same_rows(name, got[k], want[k], f"{path}[{k!r}]")
                    for k in want], default=0.0)
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise RuntimeError(f"{name}{path}: length {len(got)} vs "
                               f"{len(want)}")
        return max([_same_rows(name, g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    if isinstance(want, float):
        err = abs(got - want) / max(abs(want), 1e-300)
        if not err <= ROWS_FLOAT_RTOL:
            raise RuntimeError(f"{name}{path}: {got!r} vs {want!r}")
        return err
    if type(got) is not type(want) or got != want:
        raise RuntimeError(f"{name}{path}: {got!r} vs {want!r}")
    return 0.0


def _same_table(name, got, want) -> None:
    """Two column tables (card and CPU) equal column for column, mask
    included; every column here is an integer or a passthrough float."""
    import numpy as np

    if list(got.cols) != list(want.cols) or got.dicts != want.dicts:
        raise RuntimeError(f"{name}: schema differs from the CPU")
    pairs = [("valid", got.mask(), want.mask())] + [
        (n, got[n], want[n]) for n in want.cols]
    for col, a, b in pairs:
        if not np.array_equal(a.cpu().numpy(), b.cpu().numpy()):
            raise RuntimeError(f"{name}.{col}: differs from the CPU")


def _requests(run, device, n) -> tuple:
    """``n`` requests of ``run``: (last output, each ms)."""
    out, ms = None, []
    for _ in range(n):
        out, t = _timed(run, device)
        ms.append(t)
    return out, ms


def _row(name, ms, cpu_ms, rows, nbytes, pk, extra="") -> dict:
    """Print and return one request kind's line: p50 ms, rows/s, the
    bound by bytes (the columns the request reads and writes on the card
    over its memory rate; None on the host path, which moves none) and
    the CPU client's ms."""
    p50 = sorted(ms)[len(ms) // 2]
    bound = nbytes / pk["bytes"] * 1e3 if nbytes else None
    shown = (f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)" if nbytes
             else "no device bytes")
    print(f"[rows] {name}: p50 {p50:.3f} ms of {[round(m, 3) for m in ms]}, "
          f"{rows / p50 * 1e3:.4g} rows/s, {shown}, cpu {cpu_ms:.3f} ms "
          f"{extra}")
    return {"ms": ms, "p50_ms": p50, "rows_per_s": rows / p50 * 1e3,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
            "cpu_ms": cpu_ms}


def _tbl_column_differs(table, name, col) -> bool:
    """The columnar loader's column ``name`` against the generated values
    ``col``: integers, dates (yyyymmdd) and dictionary strings exactly,
    floats within one f32 rounding."""
    import numpy as np

    from netsdb_tpu_torch.relational.table import date_to_int

    got = table[name].cpu().numpy()
    if name in table.dicts:
        return [table.dicts[name][c] for c in got.tolist()] != col
    if isinstance(col[0], str):
        return got.tolist() != [date_to_int(v) for v in col]
    if isinstance(col[0], float):
        want = np.asarray(col, np.float64)
        return not bool(np.all(np.abs(got.astype(np.float64) - want)
                               <= np.finfo(np.float32).eps * np.abs(want)))
    return got.tolist() != col


def _rows_tpch(out, profiled, sizes, device, pk) -> None:
    """Parts 1-3: the ten row DAGs on a card client and a CPU client, the
    .tbl loaders (native parser), paged records under a spilling pool
    held to part 1's results."""
    import os
    import tempfile

    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.native import tblparse
    from netsdb_tpu_torch.workloads import tpch

    data = tpch.generate(scale=sizes["tpch_scale"], seed=SEED)
    n_li = len(data["lineitem"])
    card, cpu = Client(device=device), Client(device="cpu")
    for c in (card, cpu):
        tpch.load_tables(c, "tpch", data)
    cuda = torch.device(device).type == "cuda"
    alloc0 = torch.cuda.memory_allocated() if cuda else 0
    want = {}
    for q in tpch.QUERIES:
        got, ms = _requests(lambda q=q: tpch.run_query(card, q), device,
                            ROWS_REQUESTS)
        want[q], cpu_ms = _timed(lambda q=q: tpch.run_query(cpu, q), "cpu")
        err = _same_rows(f"tpch {q}", got, want[q])
        out[f"tpch {q}"] = _row(f"tpch {q}", ms, cpu_ms, n_li, 0, pk,
                                f"(host path; float err {err:.1e})")
    grown = (torch.cuda.memory_allocated() if cuda else 0) - alloc0
    print(f"[rows] tpch row DAGs: {n_li} lineitems, card memory allocated "
          f"by the host path {grown} bytes")
    if grown:
        raise RuntimeError(f"the host path allocated {grown} bytes on the "
                           f"card")

    with tempfile.TemporaryDirectory(prefix="netsdb_rows_") as root:
        big = tpch.generate(scale=sizes["tbl_scale"], seed=SEED)
        paths = tpch.write_tbl_dir(big, os.path.join(root, "tbl"))
        mb = sum(os.path.getsize(p) for p in paths.values()) / 1e6
        if not tblparse.available():
            raise RuntimeError(f"the native .tbl parser did not build: "
                               f"{tblparse._lib_err}")
        t0 = time.perf_counter()
        counts = tpch.load_tbl_dir(card, os.path.join(root, "tbl"), db="tbl")
        row_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ccounts = tpch.load_tbl_dir_columnar(card, os.path.join(root, "tbl"),
                                             db="tbl")
        col_s = time.perf_counter() - t0
        want_counts = {t: len(r) for t, r in big.items()}
        if counts != want_counts or ccounts != want_counts:
            raise RuntimeError(f".tbl row counts {counts} / {ccounts} vs "
                               f"{want_counts}")
        for t, rows in big.items():
            got = list(card.get_set_iterator("tbl", t))
            [table] = list(card.get_set_iterator("tbl", f"{t}_columnar"))
            names = [n for n, _ in tpch._TBL_SCHEMAS[t]]
            if list(table.cols) != names or table.device.type != \
                    torch.device(device).type:
                raise RuntimeError(f".tbl {t}: columns {list(table.cols)}")
            for name in rows[0]:
                col = [r[name] for r in got]
                if col != [r[name] for r in rows]:
                    raise RuntimeError(f".tbl {t}.{name}: rows differ from "
                                       f"the generated records")
                if _tbl_column_differs(table, name, col):
                    raise RuntimeError(f".tbl {t}.{name}: the columnar "
                                       f"loader's column differs")
        out["tbl"] = {"mb": mb, "row_s": row_s, "columnar_s": col_s,
                      "row_mb_per_s": mb / row_s, "columnar_mb_per_s":
                      mb / col_s, "rows": sum(counts.values())}
        print(f"[rows] .tbl ingest of {mb:.1f} MB ({sum(counts.values())} "
              f"rows, native parser): rows {row_s:.3f} s "
              f"({mb / row_s:.1f} MB/s), columnar {col_s:.3f} s "
              f"({mb / col_s:.1f} MB/s)")

        paged = Client(Configuration(root_dir=root,
                                     page_size_bytes=sizes["page_bytes"],
                                     page_pool_bytes=sizes["pool_bytes"]),
                       device=device)
        paged.create_database("tpch")
        for name, rows in data.items():
            paged.create_set("tpch", name, type_name="object",
                             storage="paged" if name == "lineitem"
                             else "memory")
            paged.send_data("tpch", name, rows)
        for q in ("q01", "q06"):
            got, ms = _timed(lambda q=q: tpch.run_query(paged, q), device)
            _same_rows(f"paged {q}", got, want[q])
            out[f"paged {q}"] = {"ms": ms}
        stats = paged.store.page_store().stats()
        print(f"[rows] paged lineitem records: Q01 {out['paged q01']['ms']:.3f}"
              f" ms, Q06 {out['paged q06']['ms']:.3f} ms, spills "
              f"{stats['spills']}, page reads {stats['page_reads']}")
        if stats["spills"] <= 0:
            raise RuntimeError("the paged record set did not spill")
        out["paged_spills"] = stats["spills"]
        paged.store.page_store().close()


def _rows_reddit(out, profiled, sizes, device, pk) -> None:
    """Parts 4 and 5: reddit's objects through ``Join(on=)`` held to the
    host join, and the columnar bench's four requests held to the CPU."""
    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.workloads import reddit
    from netsdb_tpu_torch.workloads import reddit_columnar as RC

    n_c, n_a, n_s = sizes["reddit_objects"]
    data = reddit.generate(num_comments=n_c, num_authors=n_a, num_subs=n_s,
                           seed=SEED)
    card, cpu = Client(device=device), Client(device="cpu")
    for c in (card, cpu):
        c.create_database("reddit")
        for name, items in zip(("comments", "authors", "subs"), data):
            c.create_set("reddit", name, type_name="objects")
            c.send_data("reddit", name, items)
    card.create_database("reddit_host")
    for name, items in zip(("comments", "authors", "subs"), data):
        card.create_set("reddit_host", name, type_name="object")
        card.send_data("reddit_host", name, items)

    def device_join(c):
        return next(iter(c.execute_computations(
            reddit.build_three_way_join_device("reddit")).values()))

    got, ms = _requests(lambda: device_join(card), device, ROWS_REQUESTS)
    if got.device.type != torch.device(device).type:
        raise RuntimeError(f"Join(on=) ran on {got.device}")
    ref, cpu_ms = _timed(lambda: device_join(cpu), "cpu")
    _same_table("reddit Join(on=)", got, ref)
    host, host_ms = _timed(lambda: next(iter(card.execute_computations(
        reddit.build_three_way_join("reddit_host")).values())), "cpu")
    karma = {a.author_id: a.karma for a in data[1]}
    subscribers = {s.id: s.subscribers for s in data[2]}
    rows = got.to_rows()
    want = [(f.index, f.author_id, karma[f.author_id], subscribers[f.sub_id])
            for f in host]
    if [(r["index"], r["author_id"], r["karma"], r["subscribers"])
            for r in rows] != want:
        raise RuntimeError("reddit Join(on=) rows differ from the host join")
    nbytes = 4 * (2 * n_c + 3 * n_c) + n_c + 4 * 2 * (n_a + n_s)
    out["reddit join_on"] = _row(
        "reddit Join(on=)", ms, cpu_ms, n_c, nbytes, pk,
        f"(host hash join {host_ms:.1f} ms, {len(want)} rows equal)")
    profiled["reddit Join(on=)"] = (lambda: device_join(card),
                                    out["reddit join_on"]["p50_ms"])

    rows_n, n_auth, n_sub = sizes["reddit_bench"]
    host_cols = RC.bench_columns(rows_n, n_auth, n_sub, seed=SEED)
    for c in (card, cpu):
        c.create_database("redditc")
        for name, (cols, dicts) in host_cols.items():
            c.create_set("redditc", name, type_name="table")
            c.send_table("redditc", name, ColumnTable.from_columns(
                cols, dicts, device="cpu"))
    n_hash = sum(n.startswith("body_h") for n in host_cols["comments"][0])
    ops = {
        "three_way_sink": (
            lambda c: next(iter(c.execute_computations(
                RC.three_way_sink_for(c, "redditc")).values())),
            4 * rows_n * (2 + 2 + 11 + n_hash + 64) + rows_n),
        "propagate_labels": (
            lambda c: RC.propagate_labels(c.get_table("redditc",
                                                      "comments"), n_auth),
            4 * rows_n * 3),
        "author_comment_counts": (
            lambda c: RC.author_comment_counts(
                c.get_table("redditc", "comments"), n_auth),
            4 * rows_n + 4 * n_auth),
        "label_partition_counts": (
            lambda c: RC.label_partition_counts(
                c.get_table("redditc", "comments")),
            4 * rows_n * 2)}
    for name, (run, nbytes) in ops.items():
        got, ms = _requests(lambda run=run: run(card), device, ROWS_REQUESTS)
        ref, cpu_ms = _timed(lambda run=run: run(cpu), "cpu")
        if hasattr(ref, "cols"):
            _same_table(f"reddit {name}", got, ref)
        elif not np.array_equal(got.cpu().numpy(), ref.numpy()):
            raise RuntimeError(f"reddit {name}: differs from the CPU")
        out[f"reddit {name}"] = _row(f"reddit {name}", ms, cpu_ms, rows_n,
                                     nbytes, pk)
        profiled[f"reddit {name}"] = (lambda run=run: run(card),
                                      out[f"reddit {name}"]["p50_ms"])


def _rows_tpch_bench(out, profiled, sizes, device, pk) -> None:
    """Part 6: the tpch-bench host DAGs held to ``queries_on_sets`` over
    ``columnarize`` of the same customers on the card, then the bench's
    size against the CPU client."""
    import numpy as np

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.workloads import tpch_bench as TB
    from netsdb_tpu_torch.workloads import tpch_bench_columnar as TBC

    n = sizes["tb_host_customers"]
    customers = TB.generate(num_customers=n, num_parts=60, seed=SEED)
    card, cpu = Client(device=device), Client(device="cpu")
    TB.load(card, customers)
    thr, seg, query, k = n // 2, "BUILDING", [1, 3, 5, 7, 11, 13, 17], 10
    t0 = time.perf_counter()
    res = card.execute_computations(
        TB.customer_int_selection(threshold=thr),
        TB.customer_string_selection(segment=seg), TB.count_customers(),
        TB.flatten_triples(), TB.top_jaccard(query_parts=query, k=k))
    host = {ident.set: v for ident, v in res.items()}
    host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    info = next(iter(card.execute_computations(
        TB.group_by_supplier()).values()))
    group_ms = (time.perf_counter() - t0) * 1e3
    card.create_database("tpchbc")
    for name, t in TBC.columnarize(customers, device=device).items():
        card.create_set("tpchbc", name, type_name="table")
        card.send_table("tpchbc", name, t)
    col, col_ms = _timed(lambda: TBC.queries_on_sets(
        card, "tpchbc", thr, seg, query, k), device)
    sel_int, _, sel_str, _ = (m.cpu().numpy() for m in col["selections"])
    keys = [c.custKey for c in customers]
    if [keys[i] for i in np.nonzero(sel_int)[0]] != \
            [c.custKey for c in host["selected_int"]] or \
            [keys[i] for i in np.nonzero(sel_str)[0]] != \
            [c.custKey for c in host["selected_str"]] or \
            col["count"] != host["customer_count"][0]:
        raise RuntimeError("tpch-bench selections or count differ from the "
                           "host DAGs")
    # the pair counts (triples per supplier and customer) must equal the
    # group-by's part lists
    sup_names = card.get_table("tpchbc", "triples").dicts["supplier"]
    pair = col["pair_counts"].cpu().numpy()
    if sum(map(len, (p for pc in info.values() for p in pc.values()))) != \
            int(pair.sum()):
        raise RuntimeError("tpch-bench group-by total differs")
    for sname, per_cust in info.items():
        s = sup_names.index(sname)
        if any(pair[s, int(cn[len("Customer"):])] != len(p)
               for cn, p in per_cust.items()):
            raise RuntimeError(f"tpch-bench group-by {sname} differs")
    heap, top = host["top_jaccard"][0], col["top_jaccard"]
    kth = top[-1][0]
    if _rel_err([s for s, _ in top], [s for s, _, _ in heap]) > JACCARD_RTOL \
            or {c for s, c in top if s > kth} != {c for s, c, _ in heap
                                                 if s > kth}:
        raise RuntimeError("tpch-bench top_jaccard differs from the host "
                           "heap")
    print(f"[rows] tpch-bench {n} customers: host DAGs {host_ms:.1f} ms "
          f"(group-by {group_ms:.1f} ms), queries_on_sets "
          f"{col_ms:.3f} ms, agree")
    out["tpch-bench host"] = {"host_ms": host_ms, "group_ms": group_ms,
                              "columnar_ms": col_ms}

    n_cust, n_parts, kb = sizes["tb_bench"]
    host_cols = TBC.bench_columns(n_customers=n_cust, n_parts=n_parts,
                                  seed=SEED)
    for c in (card, cpu):
        c.create_database("tpchbb")
        for name, (cols, dicts) in host_cols.items():
            c.create_set("tpchbb", name, type_name="table")
            c.send_table("tpchbb", name, ColumnTable.from_columns(
                cols, dicts, device="cpu"))
    rng = np.random.default_rng(SEED + 13)
    qparts = np.nonzero(rng.random(n_parts) < 0.05)[0].tolist()

    def run(c):
        return TBC.queries_on_sets(c, "tpchbb", n_cust // 2, "BUILDING",
                                   qparts, kb)

    got, ms = _requests(lambda: run(card), device, ROWS_REQUESTS)
    ref, cpu_ms = _timed(lambda: run(cpu), "cpu")
    for a, b in zip(got["selections"] + (got["pair_counts"],
                                         got["per_supplier"]),
                    ref["selections"] + (ref["pair_counts"],
                                         ref["per_supplier"])):
        if not np.array_equal(a.cpu().numpy(), b.numpy()):
            raise RuntimeError("tpch-bench bench: masks or counts differ "
                               "from the CPU")
    err = _rel_err([s for s, _ in got["top_jaccard"]],
                   [s for s, _ in ref["top_jaccard"]])
    if [c for _, c in got["top_jaccard"]] != \
            [c for _, c in ref["top_jaccard"]] or err > JACCARD_RTOL:
        raise RuntimeError(f"tpch-bench top_jaccard {got['top_jaccard']} vs "
                           f"the CPU's {ref['top_jaccard']}")
    n_trip = len(host_cols["triples"][0]["custKey"])
    nbytes = 4 * 3 * n_trip + 4 * 4 * n_cust
    out["tpch-bench bench"] = _row(
        "tpch-bench queries_on_sets", ms, cpu_ms, n_trip, nbytes, pk,
        f"({n_cust} x {n_parts} membership, {n_cust * n_parts * 4 / 1e9:.2f}"
        f" GB; top {kb} {got['top_jaccard'][:3]}...)")
    profiled["tpch-bench queries_on_sets"] = (lambda: run(card),
                                              out["tpch-bench bench"][
                                                  "p50_ms"])


def phase_rows(pk: dict, device="cuda", sizes=None) -> tuple:
    """Phase 13: the host-record relational path and its workloads
    (``ROWS_SIZES``). Returns the results and the requests to profile."""
    from netsdb_tpu_torch.relational import tuning

    sizes = dict(ROWS_SIZES, **(sizes or {}))
    t0 = time.perf_counter()
    # the planner's crossovers measured here, so that this phase plans
    # the same way alone (--rows-only) and after phase 11
    crossovers = tuning.autotune(device, persist=False)
    print(f"[rows] crossovers measured on {tuning.device_kind(device)} "
          f"({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} {v:g}" for k, v in crossovers.items()))
    out, profiled = {"crossovers": crossovers}, {}
    for part in (_rows_tpch, _rows_reddit, _rows_tpch_bench):
        part(out, profiled, sizes, device, pk)
        print(f"[rows] {part.__name__} done at "
              f"{time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[rows] phase 13 wall {out['wall_s']:.1f} s")
    return out, profiled


def rows_path(pk: dict) -> dict:
    """Phase 13 between launch counts set to 0 and read: neither attention
    kernel lies on the host-record path. One request of each device kind
    runs under the profiler."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, profiled = phase_rows(pk)
    launches = (flash_attention.launches, flash_attention_step.launches)
    print(f"[rows] launches on this path: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if launches != (0, 0):
        raise RuntimeError(f"the host-record path launched an attention "
                           f"kernel: {launches}")
    rows = phase_profile(profiled, top=3)
    out["profile_top3"] = {k: [(ms, key[:60]) for ms, key in v[:3]]
                           for k, v in rows.items()}
    # None where the profiler saw no device time: not measured
    out["busy_share"] = {k: (sum(ms for ms, _ in v) / profiled[k][1]
                             if v else None)
                         for k, v in rows.items()}
    return out


# --- phase 14 ------------------------------------------------------------
# warm requests of each compiled request; the resident requests that must
# be captured whole, with no fallback; TPC-H's scale under --compiled-only
# (the full run reuses phase 11's and phase 12's clients at TPCH_SF); the
# paged queries run with plan_fusion on and off
COMPILED_WARM = 3
MUST_CAPTURE = ("ff", "transformer", "logreg", "la gram", "la linreg",
                "la matmul")
COMPILED_ONLY_SF = 1
COMPILED_PAGED = ("q01", "q03", "q12")


def _program_counts() -> dict:
    from netsdb_tpu_torch.plan import executor, programs

    return {"traces": executor.compile_stats()["traces"],
            **programs.program_stats()}


def _device_profile(run) -> tuple:
    """(device busy ms, {kernel: launches}) of one request under the
    profiler; kernels replayed from a CUDA graph count as launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            {e.key: e.count for e in rows})


def node_by_node(client, sink):
    """``sink``'s value from the executor's eager evaluator: the plan run
    node by node, no program involved."""
    import torch

    from netsdb_tpu_torch.plan import executor
    from netsdb_tpu_torch.plan.planner import plan_from_sinks

    plan = plan_from_sinks([sink])
    with torch.inference_mode():
        values = executor._evaluate(
            plan, executor.scan_values(client, plan), client.device)
    return values[sink.inputs[0].node_id]


def _new_fallbacks(before: dict) -> list:
    from netsdb_tpu_torch.plan import programs

    return [(f["key"], f["reason"]) for f in programs.fallback_log()
            if f["runs"] > before.get(f["key"], 0)]


_COMPILED_FAILURES: list = []


def compiled_request(name, run, nbn, hold, kernel=None) -> dict:
    """:func:`_compiled_request`, a failure recorded (phase 14 raises at
    its end, after every request ran)."""
    try:
        return _compiled_request(name, run, nbn, hold, kernel)
    except Exception as e:  # noqa: BLE001 — raised at the phase's end
        print(f"[compiled] {name}: FAILED: {type(e).__name__}: {e}")
        _COMPILED_FAILURES.append(f"{name}: {type(e).__name__}: {e}")
        return {"failed": f"{type(e).__name__}: {e}"}


def _compiled_request(name, run, nbn, hold, kernel=None) -> dict:
    """One cold request of ``run`` (the capture) and COMPILED_WARM warm
    ones through the compiled-program cache, then ``nbn`` (the same
    request node by node); ``hold(got, ref)`` holds each compiled output
    to the node-by-node one within the path's tolerance and returns the
    error. Prints ms, busy share, captures, replays, the bytes captured
    and the fallbacks with their reasons. Warm requests must build no
    program; MUST_CAPTURE requests must capture with no fallback. With
    ``kernel`` = (wrapper, launches a request, "false" for B1 or "true"
    for B2) every request launches that kernel so many times, counted
    through the replays by the wrapper's counter and on the card by the
    profiler (``fold_kernel<..., carry>``)."""
    import torch

    from netsdb_tpu_torch.plan import programs

    fb0 = {f["key"]: f["runs"] for f in programs.fallback_log()}
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    c0 = _program_counts()
    k0 = kernel[0].launches if kernel else 0
    cold_out, cold_ms = request(run)
    c1 = _program_counts()
    warm, outs = [], []
    for _ in range(COMPILED_WARM):
        got, ms = request(run)
        warm.append(ms)
        outs.append(got)
    c2 = _program_counts()
    counted = kernel[0].launches - k0 if kernel else 0
    ref, nbn_ms = request(nbn)
    err = max(hold(o, ref) for o in [cold_out] + outs)
    del outs
    graph_ms, kernels = _device_profile(run)
    nbn_busy_ms, _ = _device_profile(nbn)
    # the profiler may not see the kernels a graph replays (CUPTI traces
    # them only in some sessions): then the same kernels, launched one
    # by one in the node-by-node run, give the device time
    traced = graph_ms >= 0.5 * nbn_busy_ms
    busy_ms = graph_ms if traced else nbn_busy_ms
    fallbacks = _new_fallbacks(fb0)
    p50 = sorted(warm)[len(warm) // 2]
    row = {"cold_ms": cold_ms, "warm_ms": warm, "warm_p50_ms": p50,
           "node_by_node_ms": nbn_ms, "device_busy_ms": busy_ms,
           "graph_profile_ms": graph_ms,
           "node_by_node_busy_ms": nbn_busy_ms,
           "busy_share": busy_ms / p50 if busy_ms else None,
           "captures": c1["captures"] - c0["captures"],
           "replays": c2["replays"] - c1["replays"],
           "warm_traces": c2["traces"] - c1["traces"],
           "capture_bytes": c1["capture_bytes"] - c0["capture_bytes"],
           "reserved_bytes": torch.cuda.memory_reserved() - reserved0,
           "fallbacks": fallbacks, "max_err": err}
    busy = (f"{100 * row['busy_share']:.1f}%" if busy_ms
            else "not measured (the profiler saw no CUDA activity)")
    source = ("the replay's kernels" if traced else
              f"the node-by-node run's kernels (the profiler saw "
              f"{graph_ms:.3f} ms of the replay)")
    print(f"[compiled] {name}: cold {cold_ms:.3f} ms, warm "
          f"{', '.join(f'{m:.3f}' for m in warm)} ms, node by node "
          f"{nbn_ms:.3f} ms; busy {busy_ms:.3f} ms ({source}) = {busy} of "
          f"the warm p50; {row['captures']} captures, {row['replays']} "
          f"replays, "
          f"{row['warm_traces']} builds in warm requests; captured "
          f"{row['capture_bytes'] / 2**20:.1f} MiB, reserved "
          f"{row['reserved_bytes'] / 2**20:+.1f} MiB; max err vs node by "
          f"node {err:.3e}; {len(fallbacks)} fallbacks")
    for key, reason in fallbacks:
        print(f"[compiled]   fallback {key[:110]}: {reason}")
    if row["warm_traces"]:
        raise RuntimeError(f"{name}: warm requests built "
                           f"{row['warm_traces']} new programs")
    if name in MUST_CAPTURE and (fallbacks or not row["captures"]):
        raise RuntimeError(f"{name}: {row['captures']} captures, "
                           f"fallbacks {fallbacks}")
    if kernel:
        wrapper, per_request, carry = kernel
        kname = wrapper.__name__
        # the launches recorded into the graph the cold request captured
        # (what each replay launches on the card), and the kernels the
        # profiler saw in one replay when it traced the graph's kernels
        in_graph = (c1["captured_launches"].get(kname, 0)
                    - c0["captured_launches"].get(kname, 0))
        profiled = sum(n for k, n in kernels.items()
                       if "fold_kernel" in k and f", {carry}>" in k)
        row["kernel_launches"] = {kname: counted}
        row["kernel_launches_in_graph"] = in_graph
        row["kernel_profiled_in_replay"] = profiled if traced else None
        print(f"[compiled] {name}: {kname} {counted} launches in "
              f"{1 + COMPILED_WARM} requests through the program cache; "
              f"{in_graph} recorded into the captured graph; "
              + (f"{profiled} on the card in the profiled replay" if traced
                 else "the profiler did not trace the replay's kernels"))
        if counted != per_request * (1 + COMPILED_WARM) \
                or in_graph != per_request or row["captures"] != 1 \
                or (traced and profiled != per_request):
            raise RuntimeError(f"{name}: {kname} launched {counted} times "
                               f"in {1 + COMPILED_WARM} requests, "
                               f"{in_graph} in {row['captures']} captured "
                               f"graph(s), {profiled} profiled (want "
                               f"{per_request} a request, in one graph)")
    return row


def _tol_hold(tol):
    def hold(got, ref):
        got = got.to_dense() if hasattr(got, "to_dense") else got
        ref = ref.to_dense() if hasattr(ref, "to_dense") else ref
        err = (got.double() - ref.double()).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"compiled vs node by node: {err} > {tol}")
        return err
    return hold


def _seq_hold(tol):
    def hold(got, ref):
        return max(_tol_hold(tol)(a, b) for a, b in zip(got, ref))
    return hold


def _compiled_models(client, out) -> None:
    """FF, the layer, logreg, word2vec's and the text classifier's DAGs,
    the LSTM in f32 and bf16, conv2d (direct, VALID) and the LA tasks."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.dsl import LAInterpreter, parse_program
    from netsdb_tpu_torch.models import (Conv2DModel, FFModel, LogRegModel,
                                         LSTMModel, TextClassifierModel,
                                         TransformerLayerModel,
                                         Word2VecModel)
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention
    from netsdb_tpu_torch.ops.lstm import lstm_unroll
    from netsdb_tpu_torch.workloads import la_tasks

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    ff = FFModel(db="ff14", block=(512, 512))
    ff.setup(client)
    ff.load_random_weights(client, 1024, 4096, 1024, seed=SEED)
    ff.load_inputs(client, np.random.default_rng(SEED + 41).standard_normal(
        (16384, 1024), dtype=np.float32))
    out["ff"] = compiled_request(
        "ff", lambda: ff.inference(client),
        lambda: node_by_node(client, ff.build_inference_dag()),
        _tol_hold(FF_TOL))

    tf = TransformerLayerModel(db="tf14", num_heads=8)
    tf.setup(client)
    tf.load_random_weights(client, embed=1024, seed=SEED)
    tf.load_inputs(client, np.random.default_rng(SEED + 42).standard_normal(
        (2, 4096, 1024), dtype=np.float32))
    out["transformer"] = compiled_request(
        "transformer", lambda: tf.serve_forward(client),
        lambda: node_by_node(client, tf.build_forward_dag(client)),
        _tol_hold(LAYER_TOL), kernel=(flash_attention, 1, "false"))

    features, rows = MODEL_SIZES["logreg"].values()
    lr = LogRegModel(db="lr14", block=(512, 512))
    lr.setup(client)
    lr.load_weights(client, randn(features, scale=features ** -0.5), 0.1)
    lr.load_inputs(client, randn(rows, features))
    out["logreg"] = compiled_request(
        "logreg", lambda: lr.inference(client),
        lambda: node_by_node(client, lr.build_inference_dag()),
        _tol_hold(MODEL_TOLS["logreg"]))

    vocab, dim, _, _, dag_rows = MODEL_SIZES["word2vec"].values()
    w2v = Word2VecModel(db="w2v14", block=(512, 512))
    w2v.setup(client)
    w2v.load_embeddings(client, randn(vocab, dim))
    w2v.load_onehot_inputs(client, torch.randint(
        0, vocab, (dag_rows,), generator=g, device="cuda"), vocab)
    out["word2vec_dag"] = compiled_request(
        "word2vec one-hot DAG", lambda: w2v.inference(client),
        lambda: node_by_node(client, w2v.build_inference_dag()),
        _tol_hold(MODEL_TOLS["word2vec"]))
    tvocab, labels, _ = MODEL_SIZES["text_classifier"].values()
    tc = TextClassifierModel(db="tc14", block=(512, 512))
    tc.setup(client)
    tc.load_weights(client, randn(tvocab, dim),
                    randn(labels, dim, scale=dim ** -0.5),
                    randn(labels, scale=0.1))
    tc.load_onehot_inputs(client, torch.randint(
        0, tvocab, (dag_rows,), generator=g, device="cuda"), tvocab)
    out["text_classifier_dag"] = compiled_request(
        "text classifier DAG", lambda: tc.inference(client),
        lambda: node_by_node(client, tc.build_inference_dag()),
        _tol_hold(MODEL_TOLS["text_classifier"]))

    hidden, inp, batch, steps, lblock = MODEL_SIZES["lstm"].values()
    lw = {}
    for gate in "ifco":
        lw[f"w_{gate}"] = randn(hidden, inp, scale=inp ** -0.5)
        lw[f"u_{gate}"] = randn(hidden, hidden, scale=hidden ** -0.5)
        lw[f"b_{gate}"] = randn(hidden, scale=0.1)
    h0, c0 = randn(hidden, batch, scale=0.5), randn(hidden, batch, scale=0.5)
    xs = randn(steps, inp, batch)
    for cd, key in ((None, "lstm"), ("bfloat16", "lstm_bf16")):
        m = LSTMModel(db=f"{key}14", block=(lblock, lblock),
                      compute_dtype=cd)
        m.setup(client)
        m.load_weights(client, lw)
        m.load_state(client, h0, c0)

        def eager(m=m):
            xp = torch.stack([BlockedTensor.from_dense(
                xs[t], (lblock, lblock), dtype=torch.float32,
                device="cuda").data for t in range(steps)])
            with torch.inference_mode():
                return lstm_unroll(m.params_from_store(client), xp,
                                   client.get_tensor(m.db, "h"),
                                   client.get_tensor(m.db, "c"),
                                   m.compute_dtype)

        out[key] = compiled_request(
            f"{key} run_sequence x{steps}",
            lambda m=m: m.run_sequence(client, xs), eager,
            _seq_hold(MODEL_TOLS[key]))

    n, c, hw, o, k = MODEL_SIZES["conv2d"].values()
    conv = Conv2DModel(db="conv14", mode="direct", stride=(1, 1),
                       padding="VALID", activation="relu")
    conv.setup(client)
    conv.load(client, randn(n, c, hw, hw), randn(o, c, k, k), randn(o))
    out["conv2d"] = compiled_request(
        "conv2d direct", lambda: conv.inference(client),
        lambda: node_by_node(client, conv.build_inference_dag()),
        _seq_hold(MODEL_TOLS["conv2d"]))

    for task in la_tasks.TASKS:
        env = la_tasks.make_inputs(task, LA_ROWS, LA_COLS, LA_BLOCK, LA_LAM,
                                   seed=SEED + 43)
        fn = la_tasks.compile_pdml(la_tasks.PROGRAMS[task])
        target = parse_program(la_tasks.PROGRAMS[task])[-1].target

        def eager(task=task, env=env):
            interp = LAInterpreter(device="cuda")
            interp.env.update(env)
            return interp.run(la_tasks.PROGRAMS[task])

        def hold(got, ref, target=target):
            bad, err = la_violations(got[target],
                                     ref[target].to_dense().double())
            if bad:
                raise RuntimeError(f"{bad} entries outside rtol = atol = "
                                   f"{LA_RTOL} of the node-by-node run")
            return err

        out[f"la_{task}"] = compiled_request(
            f"la {task}", lambda fn=fn, env=env: fn(env), eager, hold)
        del env


STALE_SMALL = 256         # a 256 x 256 f32 set (256 KiB)
STALE_LARGE = 8192        # an 8192 x 8192 f32 set (256 MiB)


def _scale_dag(db, factor, label="scale", out_set="out"):
    """One Apply over set ``db``:m scaling it by the closure's ``factor``."""
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    return WriteSet(Apply(ScanSet(db, "m"), lambda t: t.with_data(
        t.data * factor), label=label), db, out_set)


def _compiled_stale(out) -> None:
    """The ways a graph could go stale, each request held on the card to
    the same plan run node by node (and to its known value where there is
    one): FF after a new batch, an earlier result re-read after later
    requests, a second FF model of other shapes in the same db and job,
    a small and a large set rewritten with the same shape (by a new
    tensor, and in place by ``update_set``), a set evicted and reloaded,
    the same labels with another closure constant, and two threads
    building programs at once. A written set drops the variants that
    read it, so its next request captures again (``captures`` 1); a
    replay captures nothing."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models import FFModel
    from netsdb_tpu_torch.plan import executor
    from netsdb_tpu_torch.storage.store import SetIdentifier

    rows = out.setdefault("stale", {})

    def held(name, run, nbn, want=None, tol=0.0, captures=None):
        c0 = _program_counts()
        got = run()
        torch.cuda.synchronize()
        c1 = _program_counts()
        err = _tol_hold(tol)(got, nbn())
        if want is not None:
            err = max(err, _tol_hold(tol)(got, want))
        n = c1["captures"] - c0["captures"]
        rows[name] = {"max_err": err, "captures": n,
                      "replays": c1["replays"] - c0["replays"]}
        print(f"[compiled] stale {name}: max err {err:.3e} vs node by node"
              f"{' and the known value' if want is not None else ''}; "
              f"{n} captures, {rows[name]['replays']} replays")
        if captures is not None and n != captures:
            raise RuntimeError(f"stale {name}: {n} captures, want "
                               f"{captures}")
        return got

    def case(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — raised at the phase's end
            print(f"[compiled] stale {name}: FAILED: "
                  f"{type(e).__name__}: {e}")
            _COMPILED_FAILURES.append(f"stale {name}: {e}")

    client = Client()
    rng = np.random.default_rng(SEED + 47)

    def ff_cases():
        ff = FFModel(db="ff_stale", block=(512, 512))
        ff.setup(client)
        ff.load_random_weights(client, 1024, 4096, 1024, seed=SEED)
        ff.load_inputs(client, rng.standard_normal((16384, 1024),
                                                   dtype=np.float32))

        def nbn():
            return node_by_node(client, ff.build_inference_dag())

        first = held("ff cold", lambda: ff.inference(client), nbn,
                     tol=FF_TOL, captures=1)
        kept = first.to_dense().clone()
        held("ff warm", lambda: ff.inference(client), nbn, tol=FF_TOL,
             captures=0)
        ff.load_inputs(client, rng.standard_normal((16384, 1024),
                                                   dtype=np.float32))
        held("ff new batch", lambda: ff.inference(client), nbn,
             tol=FF_TOL, captures=1)
        held("ff new batch warm", lambda: ff.inference(client), nbn,
             tol=FF_TOL, captures=0)
        prog = [p for p in executor.cached_programs()
                if p.key.startswith("ff_stale-inference::")]
        if len(prog) != 1 or prog[0].variants() != 1:
            raise RuntimeError(f"ff new batch: {len(prog)} programs, "
                               f"{[p.variants() for p in prog]} variants "
                               f"(the old batch's variant must be dropped)")
        diff = (first.to_dense() - kept).abs().max().item()
        print(f"[compiled] stale earlier result after 3 later requests: "
              f"max change {diff:.3e}")
        rows["earlier result"] = {"max_change": diff}
        if diff != 0.0:
            raise RuntimeError(f"an earlier result changed by {diff}")
        ff2 = FFModel(db="ff_stale", block=(512, 512))  # same db and job
        ff2.setup(client)
        ff2.load_random_weights(client, 512, 2048, 256, seed=SEED + 1)
        ff2.load_inputs(client, rng.standard_normal((4096, 512),
                                                    dtype=np.float32))
        held("second ff of other shapes", lambda: ff2.inference(client),
             lambda: node_by_node(client, ff2.build_inference_dag()),
             tol=FF_TOL, captures=1)

    case("ff", ff_cases)

    def rewritten(n):
        db = f"stale{n}"
        client.create_database(db)
        client.create_set(db, "m")
        x = rng.standard_normal((n, n), dtype=np.float32)
        client.send_matrix(db, "m", x, (512, 512) if n >= 512 else (64, 64))
        sink = _scale_dag(db, 2.0)
        want = torch.from_numpy(2 * x).cuda()
        run = lambda: client.execute_computations(  # noqa: E731
            sink, job_name=db)[SetIdentifier(db, "out")]
        nbn = lambda: node_by_node(client, sink)  # noqa: E731
        held(f"{n} x {n} cold", run, nbn, want, captures=1)
        held(f"{n} x {n} warm", run, nbn, want, captures=0)
        client.send_matrix(db, "m", 5 * x, (512, 512) if n >= 512
                           else (64, 64))
        held(f"{n} x {n} rewritten", run, nbn, 5 * want, captures=1)

        def in_place(items):
            items[0].data.mul_(3)
            return items
        client.store.update_set(SetIdentifier(db, "m"), in_place)
        # the set now holds (5 x) * 3, rounded twice as on the card
        want = torch.from_numpy(5 * x * np.float32(3) * 2).cuda()
        held(f"{n} x {n} rewritten in place", run, nbn, want, captures=1)
        held(f"{n} x {n} in place warm", run, nbn, want, captures=0)
        for name in ("m", "out"):  # the large set's 256 MiB twice
            client.remove_set(db, name)

    case("small set", lambda: rewritten(STALE_SMALL))
    case("large set", lambda: rewritten(STALE_LARGE))

    def constants():
        client.create_database("stalek")
        client.create_set("stalek", "m")
        x = rng.standard_normal((1024, 1024), dtype=np.float32)
        client.send_matrix("stalek", "m", x, (512, 512))
        want = torch.from_numpy(x).cuda()
        for factor in (2.0, 3.0, 2.0):
            sink = _scale_dag("stalek", factor)
            held(f"same labels, factor {factor}",
                 lambda: client.execute_computations(
                     sink, job_name="stalek")[SetIdentifier("stalek", "out")],
                 lambda: node_by_node(client, sink), factor * want)

    case("closure constants", constants)

    def evicted():
        with tempfile.TemporaryDirectory(prefix="netsdb_evict_") as root:
            ec = Client(Configuration(root_dir=root))
            ec.create_database("ev")
            x = rng.standard_normal((4096, 4096), dtype=np.float32)
            for name in ("m", "other"):
                ec.create_set("ev", name)
            ec.send_matrix("ev", "m", x, (512, 512))
            # m and the output fit; "other", twice m, evicts them both
            ec.store.max_host_bytes = 2 * x.nbytes + (1 << 20)
            sink = _scale_dag("ev", 2.0)
            want = torch.from_numpy(2 * x).cuda()
            run = lambda: ec.execute_computations(  # noqa: E731
                sink, job_name="ev")[SetIdentifier("ev", "out")]
            nbn = lambda: node_by_node(ec, sink)  # noqa: E731
            held("evicted: before", run, nbn, want, captures=1)
            ec.send_matrix("ev", "other", np.concatenate([x, x]),
                           (512, 512))
            st = ec.store.set_stats(SetIdentifier("ev", "m"))
            if ec.store.stats.evictions < 1 or st["in_memory"]:
                raise RuntimeError(f"set m was not evicted: "
                                   f"{ec.store.stats.evictions} evictions, "
                                   f"{st}")
            held("evicted and reloaded", run, nbn, want, captures=1)

    case("eviction", evicted)

    def two_threads():
        mode0, show0 = torch.cuda.get_sync_debug_mode(), warnings.showwarning
        xs = {}
        for db in ("thr_a", "thr_b"):
            client.create_database(db)
            client.create_set(db, "m")
            xs[db] = rng.standard_normal((2048, 2048), dtype=np.float32)
            client.send_matrix(db, "m", xs[db], (512, 512))
        c0 = _program_counts()
        barrier, got, errs = threading.Barrier(2), {}, []

        def go(db, factor):
            try:
                with torch.inference_mode():
                    barrier.wait()
                    got[db] = client.execute_computations(
                        _scale_dag(db, factor), job_name=db)[
                            SetIdentifier(db, "out")]
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=go, args=(db, f))
              for db, f in (("thr_a", 2.0), ("thr_b", 3.0))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        c1 = _program_counts()
        if errs:
            raise errs[0]
        for db, f in (("thr_a", 2.0), ("thr_b", 3.0)):
            _tol_hold(0.0)(got[db], torch.from_numpy(f * xs[db]).cuda())
        n = c1["captures"] - c0["captures"]
        restored = (torch.cuda.get_sync_debug_mode() == mode0
                    and warnings.showwarning is show0)
        rows["two threads"] = {"captures": n, "restored": restored}
        print(f"[compiled] stale two threads building at once: {n} "
              f"captures, results exact, sync debug mode and warning hook "
              f"{'restored' if restored else 'NOT restored'}")
        if n != 2 or not restored:
            raise RuntimeError(f"two threads: {n} captures, restored "
                               f"{restored}")

    case("two threads", two_threads)


def _compiled_sp(out) -> None:
    """The sequence-parallel layer (phase 5's size) over SP_POSITIONS
    virtual positions of card 0: B2 16 times a request through the
    replays."""
    import numpy as np

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_step
    from netsdb_tpu_torch.parallel.mesh import virtual_devices

    with virtual_devices(SP_POSITIONS, "cuda:0"):
        client = Client()
        model, replicated, seq_sharded = sp_model(client)
        model.db = "transformer_sp14"
        model.setup(client, placements={s: replicated
                                        for s in TransformerLayerModel.SETS})
        model.load_random_weights(client, embed=1024, seed=SEED)
        model.load_inputs(client, np.random.default_rng(SEED + 45)
                          .standard_normal((2, 16384, 1024),
                                           dtype=np.float32),
                          placement=seq_sharded)
        out["sp"] = compiled_request(
            "sp", lambda: model.serve_forward(client),
            lambda: node_by_node(client, model.build_forward_dag(client)),
            _tol_hold(SP_TOL), kernel=(flash_attention_step,
                                       SP_POSITIONS * SP_POSITIONS, "true"))


def _compiled_tpch(card, out) -> None:
    """The ten suite queries on the resident card client."""
    from netsdb_tpu_torch.relational import dag

    for q in sorted(dag._QUERY_TABLES):
        sink = dag.suite_sink_for(card, "tpch", q)

        def hold(got, ref, q=q):
            if q == "q03":
                return _top10(q, *_q03_parts(q, got), *_q03_parts(q, ref))
            return _hold(q, got, ref)

        out[f"tpch_{q}"] = compiled_request(
            f"tpch {q}", lambda s=sink: dag.run_query(card, s),
            lambda s=sink: node_by_node(card, s), hold)


REGION_DIM_ROWS = 1 << 20   # the spine's resident table
REGION_KEYS = 8             # l_shipmode's 7 codes, padded


def _region_plans(client, host) -> dict:
    """tests/test_torch_fusion.py's mixed plan (Q06's fold over the paged
    lineitem joined to a four-Apply spine over a resident table, one
    spine region) and graft chain (a rowwise pre-chain, a segment-sum
    fold over lineitem's chunks and a two-Apply epilogue, one graft
    region) on the paged SF client: {name: (sink, hold(got, ref))}. The
    graft sums in f64, so fused and unfused agree to 1e-12 and both
    agree with numpy over the host columns."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.plan.computations import (Apply, Join, ScanSet,
                                                    WriteSet)
    from netsdb_tpu_torch.plan.fold import single_pass
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.table import ColumnTable

    rng = np.random.default_rng(SEED + 46)
    if not client.set_exists("tpch", "dim14"):
        client.create_set("tpch", "dim14", type_name="table")
    client.send_table("tpch", "dim14", ColumnTable.from_columns(
        {"x": rng.standard_normal(REGION_DIM_ROWS, dtype=np.float32)}, {},
        device="cpu"))
    node = ScanSet("tpch", "dim14")
    for i in range(4):
        node = Apply(node, lambda t, _i=i: ColumnTable(
            {"x": t["x"] * (1.0 + 1e-6 * _i)}, t.dicts, t.valid),
            label=f"sp{i}")
    z = Apply(node, lambda t: torch.sum(t["x"]) * 1e-9, label="zsum")
    q06 = dag.q06_sink("tpch")
    mixed = WriteSet(Join(q06.inputs[0], z, fn=lambda rev, v: ColumnTable(
        {"revenue": rev["revenue"] + v}, rev.dicts, rev.valid),
        label="combine"), "tpch", "mixed14")

    def hold_mixed(got, ref):
        a, b = got["revenue"].double(), ref["revenue"].double()
        err = ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
        if not err <= 1e-6:
            raise RuntimeError(f"mixed: fused vs unfused rel err {err}")
        return err

    nk = REGION_KEYS
    device = client.device
    pre = Apply(ScanSet("tpch", "lineitem"), lambda t: ColumnTable(
        {"k": t["l_shipmode"], "v": t["l_extendedprice"] * 1.5}, {},
        t.valid), label="pre", rowwise=True)

    def seg(st, ch):
        m = ch.mask()
        return st.index_add_(0, torch.where(m, ch["k"], 0).long(),
                             torch.where(m, ch["v"], 0.0).double())

    fold = single_pass(
        lambda prev, src: torch.zeros(nk, dtype=torch.float64,
                                      device=device),
        seg, lambda st, src: st)
    agg = Apply(pre, fold=fold, label="seg")
    e1 = Apply(agg, lambda v: v + 1.0, label="e1")
    graft = WriteSet(Apply(e1, lambda v: v * 0.5, label="e2"), "tpch",
                     "graft14")
    li = host["lineitem"][0]
    oracle = (np.bincount(li["l_shipmode"], minlength=nk, weights=(
        li["l_extendedprice"] * np.float32(1.5)).astype(np.float64))
        + 1.0) * 0.5

    def hold_graft(got, ref):
        err = ((got - ref).abs() / ref.abs()).max().item()
        want = torch.from_numpy(oracle).to(got.device)
        err_np = ((got - want).abs() / want.abs()).max().item()
        if not (err <= 1e-12 and err_np <= 1e-9):
            raise RuntimeError(f"graft: fused vs unfused rel err {err}, "
                               f"vs numpy {err_np}")
        return max(err, err_np)

    return {"mixed": (mixed, hold_mixed), "graft": (graft, hold_graft)}


def _compiled_paged(paged, resident, host, out) -> None:
    """Warm paged Q01, Q03 and Q12, the two region plans of
    :func:`_region_plans` and the paged FF, each with plan_fusion on and
    off: ms, chunks, host ms per chunk (the request's ms less the
    device's busy ms, over its chunks), regions formed, captures and
    replays; the two settings' results must be equal, the region plans
    must form regions with fusion on only, and no measured request may
    capture."""
    import numpy as np
    import tempfile

    from netsdb_tpu_torch import Client, obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models import FFModel
    from netsdb_tpu_torch.plan import programs
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.storage.store import SetIdentifier

    def both(name, client, run, hold, regions_needed=False) -> dict:
        rows, outs = {}, {}
        for fusion in (True, False):
            client.store.config.plan_fusion = fusion
            # this setting's programs are built by the first request and
            # its stream steps captured by the second
            fb0 = {f["key"]: f["runs"] for f in programs.fallback_log()}
            c0 = _program_counts()
            run()
            run()
            c1 = _program_counts()
            regions0 = obs.REGISTRY.counter("fusion.regions_formed").value
            got, rec = staged_request(client, run)
            regions = (obs.REGISTRY.counter("fusion.regions_formed").value
                       - regions0)
            c2 = _program_counts()
            fallbacks = _new_fallbacks(fb0)
            # a request of seconds (Q12's host partition pass) is not
            # profiled: its device share is small and known (PERF.md)
            busy_ms = (_device_profile(run)[0] if rec["ms"] < 1000.0
                       else None) or None  # 0: the replays were not traced
            chunks = rec["chunks"]
            host = ((rec["ms"] - busy_ms) / chunks
                    if chunks and busy_ms is not None else None)
            outs[fusion] = got
            rows["on" if fusion else "off"] = {
                "warm_ms": rec["ms"], "chunks": chunks,
                "device_busy_ms": busy_ms, "host_ms_per_chunk": host,
                "regions": regions,
                "warmup_captures": c1["captures"] - c0["captures"],
                "captures": c2["captures"] - c1["captures"],
                "replays": c2["replays"] - c1["replays"],
                "fallbacks": fallbacks}
            print(f"[compiled] paged {name} plan_fusion={fusion}: warm "
                  f"{rec['ms']:.3f} ms, {chunks} chunks, "
                  + (f"device busy {busy_ms:.3f} ms, host {host:.3f} ms "
                     f"per chunk" if host is not None else
                     "device busy not measured (a request of seconds, "
                     "or replays the profiler did not trace)")
                  + f", {regions} regions formed; "
                  f"{rows['on' if fusion else 'off']['warmup_captures']} "
                  f"captures in its first two requests, "
                  f"{c2['captures'] - c1['captures']} in this one, "
                  f"{c2['replays'] - c1['replays']} replays, "
                  f"{len(fallbacks)} fallbacks")
            for key, reason in fallbacks:
                print(f"[compiled]   fallback {key[:110]}: {reason}")
            if c2["captures"] != c1["captures"]:
                raise RuntimeError(f"paged {name}: a warm request captured "
                                   f"{c2['captures'] - c1['captures']}")
            if regions_needed and (regions > 0) != fusion:
                raise RuntimeError(f"paged {name} plan_fusion={fusion}: "
                                   f"{regions} regions formed")
        client.store.config.plan_fusion = True
        rows["max_err"] = hold(outs[True], outs[False])
        return rows

    client = paged["client"]
    for q in COMPILED_PAGED:
        sink = dag.suite_sink_for(client, "tpch", q)

        def hold(got, ref, q=q):
            if q == "q03":
                return _top10(q, *_q03_parts(q, got), *_q03_parts(q, ref))
            return _hold(q, got, ref)

        try:
            out[f"paged_{q}"] = both(q, client, lambda s=sink: dag.run_query(
                client, s), hold)
            k = {"k": 11} if q == "q03" else {}
            ref = dag.run_query(resident, dag.suite_sink_for(
                resident, "tpch", q, **k))
            hold(dag.run_query(client, sink), ref)
        except Exception as e:  # noqa: BLE001 — raised at the phase's end
            print(f"[compiled] paged {q}: FAILED: {type(e).__name__}: {e}")
            _COMPILED_FAILURES.append(f"paged {q}: {e}")

    for name, (sink, hold) in _region_plans(client, host).items():
        try:
            out[f"paged_{name}"] = both(
                name, client, lambda s=sink: client.execute_computations(
                    s, job_name=f"{name}14")[SetIdentifier(
                        "tpch", s.set_name)], hold, regions_needed=True)
        except Exception as e:  # noqa: BLE001 — raised at the phase's end
            print(f"[compiled] paged {name}: FAILED: "
                  f"{type(e).__name__}: {e}")
            _COMPILED_FAILURES.append(f"paged {name}: {e}")

    with tempfile.TemporaryDirectory(prefix="netsdb_paged_ff_") as root:
        fc = Client(Configuration(root_dir=root, page_size_bytes=PAGE_BYTES,
                                  page_pool_bytes=POOL_BYTES))
        ff = FFModel(db="ff_paged14", block=(512, 512))
        ff.setup(fc, storages={"w1": "paged", "wo": "paged"})
        ff.load_random_weights(fc, 1024, 4096, 1024, seed=SEED)
        ff.load_inputs(fc, np.random.default_rng(SEED + 44).standard_normal(
            (16384, 1024), dtype=np.float32))
        try:
            out["paged_ff"] = both("ff", fc, lambda: ff.inference(fc),
                                   _tol_hold(PAGED_FF_TOL))
            # the same warm request with every block step run as it comes
            nbn = [request(lambda: node_by_node(
                fc, ff.build_inference_dag()))[1] for _ in range(3)]
            out["paged_ff"]["node_by_node_ms"] = nbn
            print(f"[compiled] paged ff node by node (no program): warm "
                  f"{', '.join(f'{m:.3f}' for m in nbn)} ms")
        except Exception as e:  # noqa: BLE001 — raised at the phase's end
            print(f"[compiled] paged ff: FAILED: {type(e).__name__}: {e}")
            _COMPILED_FAILURES.append(f"paged ff: {e}")
        fc.store.page_store().close()


def compiled_path(state: Optional[dict] = None) -> dict:
    """Phase 14 between launch counts set to 0 and read, the compiled
    cache cleared first so every cold request captures. ``state`` holds
    phase 11's resident card client and phase 12's paged client; without
    it (``--compiled-only``) both are made here at COMPILED_ONLY_SF."""
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)
    from netsdb_tpu_torch.plan import executor, programs

    t0 = time.perf_counter()
    own = state is None
    if own:
        import tempfile

        state = _resident_card(COMPILED_ONLY_SF)
        root = tempfile.mkdtemp(prefix="netsdb_paged_rel_")
        state["paged"] = {"client": None, "root": root}
        state["paged"]["client"], _ = _paged_card(state["host"], root)
    executor.clear_compiled_cache()
    programs.reset_program_stats()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    flash_attention.launches = flash_attention_step.launches = 0
    out = {"graph_pool_bytes": {}}

    def section(name, run):
        run()
        torch.cuda.synchronize()
        out["graph_pool_bytes"][name] = programs.graph_pool_bytes()
        print(f"[compiled] {name}: the cache's graphs hold "
              f"{programs.graph_pool_bytes() / 2**20:.1f} MiB of pools, "
              f"{len(executor.compiled_cache_keys())} programs; reserved "
              f"{(torch.cuda.memory_reserved() - reserved0) / 2**30:+.3f} "
              f"GiB over the phase")
        executor.clear_compiled_cache()
        torch.cuda.empty_cache()

    try:
        section("models", lambda: _compiled_models(Client(), out))
        section("stale", lambda: _compiled_stale(out))
        section("sp", lambda: _compiled_sp(out))
        section("tpch", lambda: _compiled_tpch(state["card"], out))
        section("paged", lambda: _compiled_paged(state["paged"],
                                                 state["card"],
                                                 state["host"], out))
    finally:
        _close_paged(state.get("paged"))
    launches = (flash_attention.launches, flash_attention_step.launches)
    stats = programs.program_stats()
    torch.cuda.synchronize()
    out["program_stats"] = stats
    out["fallbacks"] = programs.fallback_log()
    out["cache_reserved_bytes"] = torch.cuda.memory_reserved() - reserved0
    out["launches"] = {"flash_attention": launches[0],
                       "flash_attention_step": launches[1]}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[compiled] phase 14: {json.dumps(stats)}; "
          f"{len(executor.compiled_cache_keys())} programs cached, memory "
          f"reserved {out['cache_reserved_bytes'] / 2**30:+.3f} GiB over "
          f"the phase; flash_attention {launches[0]} launches, "
          f"flash_attention_step {launches[1]}; {out['wall_s']:.1f} s")
    print(f"[compiled] open fallbacks: {len(out['fallbacks'])}")
    for f in out["fallbacks"]:
        print(f"[compiled]   {f['key'][:110]}: {f['reason']} "
              f"({f['runs']} eager runs)")
    if _COMPILED_FAILURES:
        raise RuntimeError("phase 14: " + " | ".join(_COMPILED_FAILURES))
    return out


# --- phase 15 ------------------------------------------------------------
# the sizes of phase 15 (PERF.md §4; this script's choice where no source is
# named): k-means 4 M x 128 around 100 centres, GMM 1 M x 32 (k 16), LDA
# 50 000 docs x 20 000 words (k 50), PageRank at soc-LiveJournal1's node
# and edge counts, top-k over lineitem's rows at SF 10, conv fusion at
# phase 8's widths with the batch cut to 8, MoE at Switch-Base-128's
# widths (google/switch-base-128), dedup at bench.py's FF widths
WL_SIZES = {"kmeans": dict(n=4_000_000, d=128, k=100, iters=10,
                           block=(8192, 128)),
            "gmm": dict(n=1_000_000, d=32, k=16, iters=20, block=(8192, 32)),
            "lda": dict(docs=50_000, vocab=20_000, k=50, iters=50,
                        doc_len=256, block=(2048, 2048)),
            "pagerank": dict(nodes=4_847_571, edges=68_993_773, iters=20),
            "pagerank_objects": dict(edges=1_000_000, nodes=100_000),
            "topk_table": dict(rows=60_000_000, k=10),
            "topk_objects": dict(items=100_000, k=10),
            "conv": dict(n=8, c=3, h=112, w=112, o=64, ksize=7,
                         block=(64, 64)),
            "moe": dict(d=768, hidden=3072, experts=128, tokens=4096,
                        capacity_factor=2.0, oracle_tokens=256),
            "dedup": dict(features=1024, hidden=4096, labels=1024,
                          block=(512, 512), batch=16384, every=8),
            "small": dict(n=2000, d=16, k=8, docs=64, vocab=96, nodes=300,
                          edges=3000, images=2, hw=20)}
WL_REQUESTS = 3
# the workload clients' store budget (``shared_mem_bytes``): the 3.7 GiB
# LDA counts and its outputs pass the 4 GiB default, which would flush
# and reload the counts on every request
WL_STORE_BYTES = 48 << 30
WL_TOLS = {"kmeans_cent_rtol": 1e-4, "gmm_rtol": 1e-3, "gmm_ll_rtol": 1e-5,
           "lda_perp_rtol": 1e-4, "lda_atol": 1e-4, "pagerank_rtol": 1e-5,
           "pagerank_sum": 1e-5, "conv_atol": 1e-3, "moe_atol": 1e-4,
           "small_rtol": 1e-4}
_WL_FAILURES: list = []


def _wl_gen(device, seed):
    import torch

    return torch.Generator(device=device).manual_seed(SEED + seed)


def _wl_free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _wl_request(out, profiled, name, run, device, bound, n=WL_REQUESTS):
    """``n`` requests of ``run`` (synchronised wall ms each, their p50),
    the peak memory above what was allocated before them, and ``run``
    kept to be profiled once. ``bound`` is (bound ms, by). Returns the
    last request's output."""
    import torch

    cuda = torch.device(device).type == "cuda"
    _wl_free(device)
    if cuda:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ms = []
    res = None
    for _ in range(n):
        res = None
        res, t = _timed(run, device)
        ms.append(t)
    p50 = sorted(ms)[len(ms) // 2]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
        else None
    row = {"ms": ms, "p50_ms": p50, "bound_ms": bound[0],
           "bound_by": bound[1], "peak_mib": peak}
    out[name] = row
    print(f"[workloads] {name}: {', '.join(f'{m:.3f}' for m in ms)} ms, "
          f"p50 {p50:.3f} ms; bound {bound[0]:.3f} ms by {bound[1]}; peak "
          + (f"{peak:.1f} MiB above the start" if peak is not None
             else "not measured (CPU)"))
    if cuda:  # one more request under the profiler, while its data lives
        rows = phase_profile({name: (run, p50)}, top=5)[name]
        row["device_busy_ms"] = sum(m for m, _ in rows) if rows else None
        row["top_kernels"] = rows[:5]
    profiled[name] = p50
    return res


def _wl_bound(flops, nbytes, pk, dtype="float32") -> tuple:
    b = bounds_ms(flops, nbytes, dtype, pk)
    return b[0], b[1]


def _wl_check(name, ok, detail, out=None) -> None:
    """Record a failed check (raised at the phase's end) and print it."""
    print(f"[workloads] {name}: {detail}" + ("" if ok else "  FAILED"))
    if out is not None:
        out.setdefault("checks", {})[name] = detail
    if not ok:
        _WL_FAILURES.append(f"{name}: {detail}")


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def _wl_client(device, root=None):
    import tempfile

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration

    root = root or tempfile.mkdtemp(prefix="netsdb_wl_")
    return Client(Configuration(root_dir=root,
                                shared_mem_bytes=WL_STORE_BYTES),
                  device=device)


def _row_rel(got, want) -> float:
    """Largest row-wise ‖got − want‖ / ‖want‖ (a centroid's error over its
    norm)."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=1)
            / want.norm(dim=1).clamp_min(1e-30)).max().item()


def _inertia(points64, cents, assign) -> float:
    """Sum of squared distances of the points to their centroids, in f64."""
    total = 0.0
    step = 1 << 20
    for r in range(0, points64.shape[0], step):
        d = points64[r:r + step] - cents.double().index_select(
            0, assign[r:r + step])
        total += (d * d).sum().item()
    return total


def _wl_blobs(n, d, k, device, seed, spread=1.0):
    """``n`` points around ``k`` planted centres (unit-variance noise,
    centres N(0, spread²) per dimension), made on ``device``."""
    import torch

    g = _wl_gen(device, seed)
    centres = torch.randn(k, d, generator=g, device=device) * spread
    labels = torch.randint(0, k, (n,), generator=g, device=device)
    pts = centres.index_select(0, labels)
    pts += torch.randn(n, d, generator=g, device=device)
    return pts, labels, centres


def _wl_kmeans(out, profiled, s, device, pk) -> None:
    import torch

    kmod = __import__("netsdb_tpu_torch.workloads.kmeans",
                      fromlist=["x"])
    n, d, k, iters = s["n"], s["d"], s["k"], s["iters"]
    pts, _, centres = _wl_blobs(n, d, k, device, 1, spread=1.5)
    gap = torch.cdist(centres, centres) + torch.eye(k, device=device) * 1e9
    _wl_check("kmeans centres", gap.min().item() >= 10.0,
              f"min centre distance {gap.min().item():.3f} sigma (>= 10)",
              out)
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "points")
    c.send_matrix("wl", "points", pts, s["block"])
    del pts
    bound = _wl_bound(iters * 2.0 * n * d * k, iters * 4.0 * n * d, pk)
    cents, assign = _wl_request(
        out, profiled, "kmeans_on_set",
        lambda: kmod.kmeans_on_set(c, "wl", "points", k, iters, seed=SEED),
        device, bound)
    # the profiled request wrote the set last: one more, read back at once
    cents, assign = kmod.kmeans_on_set(c, "wl", "points", k, iters,
                                       seed=SEED)
    points = c.get_tensor("wl", "points").to_dense()
    stored = c.get_tensor("wl", "kmeans_centroids").to_dense()
    _wl_check("kmeans_on_set stored", torch.equal(stored, cents),
              f"the centroid set ({tuple(stored.shape)}) holds the "
              f"returned centroids", out)
    # from its random start, two initial centroids in one cluster split
    # it, and the split's direction is free: f32 and f64 drift apart
    # there, so this run is held by its objective and counted
    init = kmod.random_init(points, k, SEED)
    p64 = points.double()
    c64, a64 = kmod.kmeans(p64, k, iters, init_centroids=init.double())
    diff = int((assign != a64).sum())
    obj, obj64 = _inertia(p64, cents, assign), _inertia(p64, c64, a64)
    obj_err = abs(obj - obj64) / obj64
    out["kmeans_on_set"].update(mismatched=diff, inertia=obj,
                                inertia_rel_err=obj_err,
                                cent_rel_err=_row_rel(cents, c64))
    _wl_check("kmeans_on_set vs f64", obj_err <= WL_TOLS["kmeans_cent_rtol"],
              f"inertia {obj:.6e} rel err {obj_err:.3e}; {diff} of {n} "
              f"assignments differ (split clusters), centroids row rel "
              f"err {out['kmeans_on_set']['cent_rel_err']:.3e}", out)
    del c64, a64
    # from the planted centres every point's nearest centroid is clear:
    # the assignments must equal f64's exactly
    planted = _wl_request(
        out, profiled, "kmeans (planted start)",
        lambda: kmod.kmeans(points, k, iters, init_centroids=centres),
        device, bound)
    c64, a64 = kmod.kmeans(p64, k, iters, init_centroids=centres.double())
    diff = int((planted[1] != a64).sum())
    rel = _row_rel(planted[0], c64)
    out["kmeans (planted start)"].update(mismatched=diff, cent_rel_err=rel)
    _wl_check("kmeans (planted start) vs f64", diff == 0
              and rel <= WL_TOLS["kmeans_cent_rtol"],
              f"{diff} of {n} assignments differ; centroids row rel err "
              f"{rel:.3e}", out)
    del p64, c64, a64, planted
    # the sampled init: the reference's numpy draws, so the CPU client's
    # start bit for bit
    t0 = time.perf_counter()
    start = kmod.sample_init(points, k, SEED)
    host_ms = (time.perf_counter() - t0) * 1e3
    cpu = _wl_client("cpu")
    cpu.create_database("wl")
    cpu.create_set("wl", "points")
    cpu.send_matrix("wl", "points", points.cpu(), s["block"])
    cpu_start = kmod.sample_init(cpu.get_tensor("wl", "points").to_dense(),
                                 k, SEED)
    same = torch.equal(start.cpu(), cpu_start)
    _wl_check("kmeans init=sample", same,
              f"{start.shape[0]} initial centroids, equal to the CPU "
              f"client's bit for bit: {same} (host {host_ms:.1f} ms)", out)
    del cpu
    _wl_request(out, profiled, "kmeans init=sample",
                lambda: kmod.kmeans(points, k, iters, seed=SEED,
                                    init="sample"),
                device, bound, n=1)
    del points, c


def _wl_gmm(out, profiled, s, device, pk) -> None:
    gm = __import__("netsdb_tpu_torch.workloads.gmm", fromlist=["x"])
    n, d, k, iters = s["n"], s["d"], s["k"], s["iters"]
    pts, _, _ = _wl_blobs(n, d, k, device, 2, spread=3.0)
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "points")
    c.send_matrix("wl", "points", pts, s["block"])
    del pts
    # per round: the (n, k, d) differences, squares, scaling and sums, and
    # the two moment products
    bound = _wl_bound(iters * 8.0 * n * k * d, (iters + 1) * 4.0 * n * d,
                      pk)
    state, _ = _wl_request(
        out, profiled, "gmm_on_set",
        lambda: gm.gmm_on_set(c, "wl", "points", k, iters, seed=SEED),
        device, bound)
    points = c.get_tensor("wl", "points").to_dense()
    init = gm.gmm_init(points, k, SEED)
    p64 = points.double()
    s64, _ = gm.gmm_em(p64, k, iters, init=init)
    errs = {f: _rel(getattr(state, f), getattr(s64, f))
            for f in ("means", "variances", "weights")}
    ll = gm.gmm_log_likelihood(points, state).item()
    ll64 = gm.gmm_log_likelihood(p64, s64).item()
    ll_err = abs(ll - ll64) / abs(ll64)
    out["gmm_on_set"].update(rel_err=errs, ll=ll, ll_rel_err=ll_err)
    _wl_check("gmm vs f64", max(errs.values()) <= WL_TOLS["gmm_rtol"]
              and ll_err <= WL_TOLS["gmm_ll_rtol"],
              "rel err " + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
              + f"; log-likelihood {ll:.6f} rel err {ll_err:.3e}", out)
    del p64, s64, points, c


def _wl_lda(out, profiled, s, device, pk) -> None:
    import torch

    ld = __import__("netsdb_tpu_torch.workloads.lda", fromlist=["x"])
    docs, vocab, k, iters = s["docs"], s["vocab"], s["k"], s["iters"]
    g = _wl_gen(device, 3)
    # 50 planted topics over the vocabulary, Dirichlet-like mixtures per
    # document, Poisson counts of about doc_len words a document
    topics = torch.rand(k, vocab, generator=g, device=device) ** 8
    topics /= topics.sum(1, keepdim=True)
    mix = torch.rand(docs, k, generator=g, device=device) ** 4
    mix /= mix.sum(1, keepdim=True)
    rates = (mix @ topics).mul_(s["doc_len"])
    counts = torch.poisson(rates, generator=g)
    del rates, mix, topics
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "counts")
    c.send_matrix("wl", "counts", counts, s["block"])
    del counts
    bound = _wl_bound(iters * 6.0 * docs * k * vocab,
                      iters * 4.0 * docs * vocab, pk)
    state = _wl_request(
        out, profiled, "lda_on_set",
        lambda: ld.lda_on_set(c, "wl", "counts", k, iters, seed=SEED),
        device, bound)
    counts = c.get_tensor("wl", "counts").to_dense()
    perp = ld.lda_perplexity(counts, state).item()
    init = ld.lda_init(counts, k, SEED)
    c64 = counts.double()
    s64 = ld.lda_em(c64, k, iters, init=init)
    perp64 = ld.lda_perplexity(c64, s64).item()
    del c64
    p_err = abs(perp - perp64) / perp64
    th = (state.doc_topic.double() - s64.doc_topic).abs().max().item()
    ph = (state.topic_word.double() - s64.topic_word).abs().max().item()
    out["lda_on_set"].update(perplexity=perp, perplexity_rel_err=p_err,
                             theta_abs_err=th, phi_abs_err=ph)
    _wl_check("lda vs f64", p_err <= WL_TOLS["lda_perp_rtol"]
              and max(th, ph) <= WL_TOLS["lda_atol"],
              f"perplexity {perp:.4f} rel err {p_err:.3e}; theta abs err "
              f"{th:.3e}, phi abs err {ph:.3e}", out)
    del s64, state, counts, c


def _wl_edges(nodes, edges, device, seed):
    """A power-law graph drawn on ``device``: sources and targets skewed
    toward a random set of hot nodes (inverse-transform draws u**2 and
    u**1.5 over a random relabelling), int32."""
    import torch

    g = _wl_gen(device, seed)
    perm = torch.randperm(nodes, generator=g, device=device)
    u = torch.rand(edges, generator=g, device=device, dtype=torch.float64)
    src = perm.index_select(0, (u.pow_(2) * nodes).long().clamp_(
        max=nodes - 1))
    u = torch.rand(edges, generator=g, device=device, dtype=torch.float64)
    dst = perm.index_select(0, (u.pow_(1.5) * nodes).long().clamp_(
        max=nodes - 1))
    return src.to(torch.int32), dst.to(torch.int32)


def _pagerank_f64(src, dst, n, iters, damping=0.85, dangling=True):
    import torch

    src, dst = src.long(), dst.long()
    deg = torch.bincount(src, minlength=n).double()
    safe = deg.clamp_min(1.0)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float64, device=src.device)
    for _ in range(iters):
        inc = torch.zeros_like(rank).index_add_(
            0, dst, (rank / safe).index_select(0, src))
        dm = rank[deg == 0].sum() if dangling else 0.0
        rank = (1 - damping) / n + damping * (inc + dm / n)
    return rank


def _wl_pagerank(out, profiled, s, device, pk) -> None:
    import numpy as np
    import torch

    pr = __import__("netsdb_tpu_torch.workloads.pagerank", fromlist=["x"])
    from netsdb_tpu_torch.relational.table import ColumnTable

    n, e, iters = s["nodes"], s["edges"], s["iters"]
    src, dst = _wl_edges(n, e, device, 4)
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "links", type_name="table")
    c.send_table("wl", "links", ColumnTable({"src": src, "dst": dst}))
    # each round reads both endpoints of every edge once (int32)
    bound = _wl_bound(iters * 2.0 * e, iters * 8.0 * e, pk)
    ranks_t = _wl_request(
        out, profiled, "pagerank_on_table_set",
        lambda: pr.pagerank_on_table_set(c, "wl", "links", n, iters=iters),
        device, bound)
    ranks = _wl_request(out, profiled, "pagerank",
                        lambda: pr.pagerank(src, dst, n, iters=iters),
                        device, bound)
    r64 = _pagerank_f64(src, dst, n, iters)
    r64t = _pagerank_f64(src, dst, n, iters, dangling=False)
    e1 = _rel(ranks, r64)
    e2 = _rel(torch.from_numpy(ranks_t).to(device), r64t)
    total = ranks.double().sum().item()
    out["pagerank"].update(rel_err=e1, sum=total)
    out["pagerank_on_table_set"].update(rel_err=e2)
    _wl_check("pagerank vs f64", e1 <= WL_TOLS["pagerank_rtol"]
              and e2 <= WL_TOLS["pagerank_rtol"]
              and abs(total - 1.0) <= WL_TOLS["pagerank_sum"],
              f"pagerank rel err {e1:.3e}, ranks sum to {total:.9f}; "
              f"pagerank_on_table_set rel err {e2:.3e}", out)
    stored = len(list(c.get_set_iterator("wl", "ranks")))
    _wl_check("pagerank ranks set", stored == n,
              f"{stored} (url, rank) pairs written", out)
    del src, dst, r64, r64t, ranks, c
    _wl_free(device)
    # the object driver: a Python object per edge (cut to 1 M edges)
    no, eo = s["objects_nodes"], s["objects_edges"]
    so, do = _wl_edges(no, eo, device, 5)
    pairs = list(zip(so.cpu().numpy().tolist(), do.cpu().numpy().tolist()))
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "links", type_name="object")
    c.send_data("wl", "links", pairs)
    bound = _wl_bound(iters * 2.0 * eo, iters * 8.0 * eo, pk)
    got = _wl_request(
        out, profiled, "pagerank_on_set",
        lambda: pr.pagerank_on_set(c, "wl", "links", no, iters=iters),
        device, bound)
    want = pr.pagerank(so, do, no, iters=iters).cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    _wl_check("pagerank_on_set", err <= 1e-6,
              f"equal to pagerank on the same edges within {err:.3e}", out)
    del c, pairs


def _wl_topk(out, profiled, s, device, pk) -> None:
    import numpy as np
    import torch

    tk = __import__("netsdb_tpu_torch.workloads.topk", fromlist=["x"])
    from netsdb_tpu_torch.relational.table import ColumnTable

    rows, k = s["rows"], s["k"]
    g = _wl_gen(device, 6)
    # 1000 distinct values: every value is shared by about 60 000 rows
    scores = torch.randint(0, 1000, (rows,), generator=g,
                           device=device).to(torch.float32) / 10
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "lineitem", type_name="table")
    c.send_table("wl", "lineitem", ColumnTable({"score": scores}))
    res = _wl_request(
        out, profiled, "top_k_on_table_set",
        lambda: tk.top_k_on_table_set(c, "wl", "lineitem", "score", k),
        device, _wl_bound(0.0, 4.0 * rows, pk))
    host = scores.cpu().numpy()
    kth = np.partition(-host, k - 1)[k - 1]
    cand = np.nonzero(-host <= kth)[0]
    want = cand[np.argsort(-host[cand], kind="stable")][:k]
    got = res["row"].cpu().numpy()
    _wl_check("top_k_on_table_set", np.array_equal(got, want),
              f"rows {got.tolist()} (numpy's stable order "
              f"{want.tolist()}), scores {res['score'].cpu().tolist()}", out)
    del c, scores
    items = s["objects"]
    vals = np.random.default_rng(SEED + 6).integers(0, 50, items).tolist()
    objs = [{"id": i, "score": v} for i, v in enumerate(vals)]
    c = _wl_client(device)
    c.create_database("wl")
    c.create_set("wl", "objs", type_name="object")
    c.send_data("wl", "objs", objs)
    winners = _wl_request(
        out, profiled, "top_k_on_set",
        lambda: tk.top_k_on_set(c, "wl", "objs", k,
                                score=lambda o: o["score"]),
        device, _wl_bound(0.0, 4.0 * items, pk))
    want = np.argsort(-np.asarray(vals), kind="stable")[:k].tolist()
    _wl_check("top_k_on_set", [w["id"] for w in winners] == want,
              f"ids {[w['id'] for w in winners]}", out)
    del c, objs


def _conv_f64(images, kernels, bias, device):
    import torch
    import torch.nn.functional as F

    return F.conv2d(torch.from_numpy(images).to(device).double(),
                    torch.from_numpy(kernels).to(device).double(),
                    torch.from_numpy(bias).to(device).double())


def _wl_conv(out, profiled, s, device, pk) -> None:
    import numpy as np
    import torch

    cf = __import__("netsdb_tpu_torch.workloads.conv_fusion",
                    fromlist=["x"])
    from netsdb_tpu_torch.plan import executor

    rng = np.random.default_rng(SEED + 7)
    n, ch, h, w, o, ks = (s[x] for x in ("n", "c", "h", "w", "o", "ksize"))
    images = rng.standard_normal((n, ch, h, w), dtype=np.float32)
    kernels = rng.standard_normal((o, ch, ks, ks), dtype=np.float32) * 0.1
    bias = rng.standard_normal(o, dtype=np.float32)
    c = _wl_client(device)
    jobs: dict = {}
    run_jobs = c.execute_computations

    def timed_jobs(*a, **kw):
        t0 = time.perf_counter()
        res = run_jobs(*a, **kw)
        _sync(device)
        jobs.setdefault(kw.get("job_name", "job"), []).append(
            (time.perf_counter() - t0) * 1e3)
        return res

    c.execute_computations = timed_jobs
    pipe = cf.ConvFusionPipeline(db="convfuse", kernel_size=ks,
                                 block=s["block"])
    oh, ow = h - ks + 1, w - ks + 1
    flops = 2.0 * n * o * oh * ow * (ch * ks * ks + 1)
    nbytes = 4.0 * (images.size + kernels.size + n * o * oh * ow)
    res = _wl_request(out, profiled, "ConvFusionPipeline.run",
                      lambda: pipe.run(c, images, kernels, bias), device,
                      _wl_bound(flops, nbytes, pk))
    for job, ms in jobs.items():
        print(f"[workloads]   job {job}: host+device ms "
              f"{', '.join(f'{m:.1f}' for m in ms)}")
    out["ConvFusionPipeline.run"]["job_ms"] = jobs
    ref = _conv_f64(images, kernels, bias, device)
    got = torch.from_numpy(np.stack([im.data for im in res])).to(device)
    err = (got.double() - ref).abs().max().item()
    out["ConvFusionPipeline.run"]["max_abs_err"] = err
    _wl_check("conv fusion vs F.conv2d f64", err <= WL_TOLS["conv_atol"]
              and len(res) == n, f"{len(res)} images, max abs err "
              f"{err:.3e}", out)
    # the conv job alone, replayed: compiled equals node by node
    c.execute_computations = run_jobs
    counts0 = _program_counts()
    for _ in range(2):
        compiled = c.execute_computations(pipe.build_conv(),
                                          job_name="convfuse-conv2d")
    counts1 = _program_counts()
    from netsdb_tpu_torch.storage.store import SetIdentifier

    compiled = compiled[SetIdentifier("convfuse", "result")].to_dense()
    nbn = node_by_node(c, pipe.build_conv()).to_dense()
    same = torch.equal(compiled, nbn)
    replays = counts1.get("replays", 0) - counts0.get("replays", 0)
    _wl_check("conv job compiled vs node by node", same,
              f"bit-equal {same}; {replays} replays, "
              f"{counts1['traces'] - counts0['traces']} traces", out)
    executor.clear_compiled_cache()
    del c, res


def _wl_moe(out, profiled, s, device, pk) -> None:
    import torch

    moe = __import__("netsdb_tpu_torch.models.moe", fromlist=["x"])
    d, hd, ne, t = s["d"], s["hidden"], s["experts"], s["tokens"]
    g = _wl_gen(device, 8)
    params = moe.MoEParams(
        w_gate=torch.randn(d, ne, generator=g, device=device) * d ** -0.5,
        w_up=torch.randn(ne, d, hd, generator=g, device=device) * d ** -0.5,
        w_down=torch.randn(ne, hd, d, generator=g, device=device)
        * hd ** -0.5)
    x = torch.randn(t, d, generator=g, device=device)
    cf = s["capacity_factor"]
    cap = moe.capacity_of(t, ne, cf)
    slots = ne * cap
    flops = (2.0 * t * d * ne + 2 * 2.0 * t * slots * d
             + 2 * 2.0 * slots * d * hd)
    nbytes = 4.0 * (params.w_gate.numel() + params.w_up.numel()
                    + params.w_down.numel() + 2 * x.numel())
    y = _wl_request(out, profiled, "moe_forward",
                    lambda: moe.moe_forward(params, x, cf), device,
                    _wl_bound(flops, nbytes, pk))
    dropped = int((~moe.route(params, x, cf).keep).sum())
    p64 = moe.MoEParams(*(p.double() for p in (params.w_gate, params.w_up,
                                               params.w_down)))
    y64 = moe.moe_forward(p64, x.double(), cf)
    err = (y.double() - y64).abs().max().item()
    del p64, y64
    few = s["oracle_tokens"]
    oracle = moe.moe_forward_dense_oracle(params, x[:few], cf)
    err_o = (moe.moe_forward(params, x[:few], cf) - oracle).abs().max().item()
    out["moe_forward"].update(max_abs_err=err, dropped_tokens=dropped,
                              capacity=cap, oracle_err=err_o)
    _wl_check("moe vs f64", err <= WL_TOLS["moe_atol"]
              and err_o <= WL_TOLS["moe_atol"],
              f"max abs err {err:.3e}; {dropped} of {t} tokens dropped "
              f"(capacity {cap}); dense oracle at {few} tokens "
              f"{err_o:.3e}", out)


def _ff_pair(c, s, device):
    """Two FF models at ``s``'s widths; the second a fine-tuned copy of the
    first in which one of every ``every`` blocks of w1 and of wo moved."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models import FFModel

    a = FFModel(db="ffa", block=s["block"])
    b = FFModel(db="ffb", block=s["block"])
    for m in (a, b):
        m.setup(c)
    a.load_random_weights(c, s["features"], s["hidden"], s["labels"],
                          seed=SEED)
    changed = 0
    dense = {}
    for name in ("w1", "b1", "wo", "bo"):
        t = c.get_tensor("ffa", name)
        arr = t.to_dense().cpu().numpy().copy()
        if name in ("w1", "wo"):
            for i, idx in enumerate(np.ndindex(*t.meta.grid)):
                if i % s["every"] == 0:
                    arr[t.meta.block_slice(idx)] += 0.01
                    changed += 1
        dense[name] = arr
    b.load_weights(c, *(dense[n] for n in ("w1", "b1", "wo", "bo")))
    x = torch.randn(s["batch"], s["features"],
                    generator=_wl_gen(device, 9), device=device)
    for m in (a, b):
        m.load_inputs(c, x)
    return a, b, changed


def _wl_dedup(out, profiled, s, device, pk) -> None:
    import torch

    from netsdb_tpu_torch.plan import executor
    from netsdb_tpu_torch.storage.store import SetIdentifier

    executor.clear_compiled_cache()
    c = _wl_client(device)
    a, b, changed = _ff_pair(c, s, device)
    sets = [(m.db, w) for m in (a, b) for w in ("w1", "wo")]

    def infer(m, job):
        return c.execute_computations(m.build_inference_dag(),
                                      job_name=job)[SetIdentifier(
                                          m.db, "output")].to_dense().clone()

    def both_ways():
        res = {}
        for m in (a, b):
            c0 = _program_counts()
            comp = [infer(m, f"dedup-{m.db}") for _ in range(2)]
            c1 = _program_counts()
            res[m.db] = {"compiled": comp,
                         "nbn": node_by_node(c, m.build_inference_dag())
                         .to_dense().clone(),
                         "captures": c1.get("captures", 0)
                         - c0.get("captures", 0),
                         "replays": c1.get("replays", 0)
                         - c0.get("replays", 0)}
        return res

    before = both_ways()
    blocks = sum(c.get_tensor(*st).meta.num_blocks for st in sets)
    block_bytes = 4 * s["block"][0] * s["block"][1]
    want_unique = blocks // 2 + changed
    # every set read once, the pool written once; a request after the
    # first pools the assembled sets again, to the same pool
    report = _wl_request(out, profiled, "dedup_resident",
                         lambda: c.dedup_resident(sets), device,
                         _wl_bound(0.0, (blocks + want_unique)
                                   * block_bytes, pk))
    ok = (report["unique_blocks"] == want_unique
          and report["hbm_bytes_pooled"] == want_unique * block_bytes
          and c.store.live_pool_bytes() == want_unique * block_bytes)
    out["dedup_resident"].update(report=report,
                                 planted_unique_blocks=want_unique)
    _wl_check("dedup_resident report", ok,
              f"{report['total_blocks']} blocks, {report['unique_blocks']} "
              f"unique (planted {want_unique}), pooled "
              f"{report['hbm_bytes_pooled']} bytes of "
              f"{report['hbm_bytes_before']}", out)
    pooled = both_ways()
    dropped = c.store.drop_pool_caches()
    after = both_ways()
    for stage, res in (("pooled", pooled), ("after drop_pool_caches",
                                            after)):
        for db in res:
            same = all(torch.equal(x, y) for x, y in zip(
                res[db]["compiled"], before[db]["compiled"])) and \
                torch.equal(res[db]["nbn"], before[db]["nbn"])
            _wl_check(f"dedup inference {db} {stage}", same and (
                device == "cpu" or res[db]["captures"] >= 1),
                f"bit-equal to before pooling: {same}; "
                f"{res[db]['captures']} captures, {res[db]['replays']} "
                f"replays" + (f"; {dropped} cache bytes dropped"
                              if stage != "pooled" else ""), out)
    diff = max((x["compiled"][-1] - x["nbn"]).abs().max().item()
               for x in before.values())
    _wl_check("dedup compiled vs node by node", diff <= FF_TOL,
              f"max abs diff {diff:.3e}", out)
    executor.clear_compiled_cache()
    del c


def _wl_lsh(out, profiled, device, pk) -> None:
    from netsdb_tpu_torch.dedup.lsh import bench_lsh_zoo

    res = _wl_request(out, profiled, "bench_lsh_zoo",
                      lambda: bench_lsh_zoo(device=device), device,
                      _wl_bound(100 * 2.0 * 8 * 65536 * 128,
                                4.0 * 100 * 8 * 65536, pk), n=1)
    cpu = bench_lsh_zoo(device="cpu")
    keys = ("models", "blocks", "groups", "groups_family_pure",
            "verified_pairs", "all_pairs", "index_stats")
    same = all(res[k] == cpu[k] for k in keys)
    out["bench_lsh_zoo"]["result"] = res
    _wl_check("bench_lsh_zoo vs the CPU client", same,
              f"{res['groups']} groups, pure {res['groups_family_pure']}, "
              f"{res['verified_pairs']} verified pairs; build "
              f"{res['build_s']} s, probe {res['probe_s']} s", out)


def _wl_small_vs_cpu(out, s, device) -> None:
    """Each workload at a small size on the card and on a CPU client, from
    the same numpy inputs and initial states."""
    import numpy as np
    import torch

    km = __import__("netsdb_tpu_torch.workloads.kmeans", fromlist=["x"])
    gm = __import__("netsdb_tpu_torch.workloads.gmm", fromlist=["x"])
    ld = __import__("netsdb_tpu_torch.workloads.lda", fromlist=["x"])
    pr = __import__("netsdb_tpu_torch.workloads.pagerank", fromlist=["x"])
    tk = __import__("netsdb_tpu_torch.workloads.topk", fromlist=["x"])
    cf = __import__("netsdb_tpu_torch.workloads.conv_fusion",
                    fromlist=["x"])
    moe = __import__("netsdb_tpu_torch.models.moe", fromlist=["x"])
    from netsdb_tpu_torch.relational.table import ColumnTable

    rng = np.random.default_rng(SEED + 10)
    tol = WL_TOLS["small_rtol"]
    n, d, k = s["n"], s["d"], s["k"]
    centres = rng.standard_normal((k, d)).astype(np.float32) * 6
    pts = (centres[rng.integers(0, k, n)]
           + rng.standard_normal((n, d)).astype(np.float32))
    counts = rng.poisson(2.0, (s["docs"], s["vocab"])).astype(np.float32)
    src = rng.integers(0, s["nodes"], s["edges"]).astype(np.int32)
    dst = rng.integers(0, s["nodes"], s["edges"]).astype(np.int32)
    scores = rng.integers(0, 30, 5000).astype(np.float32)
    images = rng.standard_normal((s["images"], 3, s["hw"], s["hw"]),
                                 dtype=np.float32)
    kernels = rng.standard_normal((8, 3, 5, 5), dtype=np.float32) * 0.1
    bias = rng.standard_normal(8, dtype=np.float32)
    gmm_init = gm.GMMState(torch.from_numpy(centres[:k].copy()),
                           torch.ones(k, d) * 2.0, torch.full((k,), 1 / k))
    lda_init = ld.lda_init(torch.from_numpy(counts), 6, SEED)
    mp = moe.init_moe_params(32, 64, 8, seed=SEED, device="cpu")
    xm = rng.standard_normal((128, 32)).astype(np.float32)
    res = {}
    for dev in (device, "cpu"):
        def put(a, dev=dev):
            return torch.from_numpy(np.asarray(a)).to(dev)

        c = _wl_client(dev)
        c.create_database("wl")
        c.create_set("wl", "links", type_name="object")
        c.send_data("wl", "links", list(zip(src.tolist(), dst.tolist())))
        c.create_set("wl", "lt", type_name="table")
        c.send_table("wl", "lt", ColumnTable({"src": put(src),
                                              "dst": put(dst)}))
        c.create_set("wl", "s", type_name="table")
        c.send_table("wl", "s", ColumnTable({"score": put(scores)}))
        c.create_set("wl", "o", type_name="object")
        c.send_data("wl", "o", [{"i": i, "v": float(v)}
                                for i, v in enumerate(scores[:500])])
        p = put(pts)
        r = {"kmeans": km.kmeans(p, k, 5, init_centroids=put(pts[:k])),
             "kmeans_sample": km.sample_init(p, k, SEED),
             "gmm": gm.gmm_em(p, k, 5, init=gmm_init)[0],
             "lda": ld.lda_em(put(counts), 6, 10, init=lda_init),
             "pagerank": pr.pagerank(put(src), put(dst), s["nodes"]),
             "pagerank_on_set": pr.pagerank_on_set(c, "wl", "links",
                                                   s["nodes"]),
             "pagerank_on_table_set": pr.pagerank_on_table_set(
                 c, "wl", "lt", s["nodes"]),
             "top_k_on_table_set": tk.top_k_on_table_set(c, "wl", "s",
                                                         "score", 25),
             "top_k_on_set": [o["i"] for o in tk.top_k_on_set(
                 c, "wl", "o", 25, score=lambda o: o["v"])],
             "conv": np.stack([im.data for im in cf.ConvFusionPipeline(
                 db="cf", kernel_size=5, block=(32, 32)).run(
                 c, images, kernels, bias)]),
             "moe": moe.moe_forward(moe.MoEParams(
                 put(mp.w_gate), put(mp.w_up), put(mp.w_down)), put(xm))}
        res[dev] = r
    g, w = res[device], res["cpu"]

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    errs = {
        "kmeans": max(float(np.abs(host(g["kmeans"][0])
                                   - host(w["kmeans"][0])).max()),
                      float((host(g["kmeans"][1])
                             != host(w["kmeans"][1])).sum())),
        "kmeans_sample": float(not np.array_equal(
            host(g["kmeans_sample"]), host(w["kmeans_sample"]))),
        "gmm": max(_rel(a.cpu(), b) for a, b in zip(g["gmm"], w["gmm"])),
        "lda": max(float(np.abs(host(a) - host(b)).max())
                   for a, b in zip(g["lda"], w["lda"])),
        "pagerank": _rel(g["pagerank"].cpu(), w["pagerank"]),
        "pagerank_on_set": float(np.abs(g["pagerank_on_set"]
                                        - w["pagerank_on_set"]).max()
                                 / w["pagerank_on_set"].max()),
        "pagerank_on_table_set": float(
            np.abs(g["pagerank_on_table_set"]
                   - w["pagerank_on_table_set"]).max()
            / w["pagerank_on_table_set"].max()),
        "top_k_on_table_set": float(not np.array_equal(
            host(g["top_k_on_table_set"]["row"]),
            host(w["top_k_on_table_set"]["row"]))),
        "top_k_on_set": float(g["top_k_on_set"] != w["top_k_on_set"]),
        "conv": float(np.abs(g["conv"] - w["conv"]).max()),
        "moe": float(np.abs(host(g["moe"]) - host(w["moe"])).max())}
    out["small_vs_cpu"] = errs
    bad = [name for name, e in errs.items() if not e <= tol]
    _wl_check("small sizes vs the CPU client", not bad,
              ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + (f" (over {tol}: {bad})" if bad else ""), out)


def phase_workloads(pk: dict, device="cuda", sizes=None) -> tuple:
    """Phase 15: the single-device workloads, MoE and dedup (``WL_SIZES``),
    each request through the port's ``Client`` held to the same function
    in float64 on the same device, and at small sizes to a CPU client.
    Returns the results and the requests to profile."""
    sizes = {k: dict(v, **((sizes or {}).get(k, {})))
             for k, v in WL_SIZES.items()}
    sizes["pagerank"].update(objects_nodes=sizes["pagerank_objects"]["nodes"],
                             objects_edges=sizes["pagerank_objects"]["edges"])
    sizes["topk_table"]["objects"] = sizes["topk_objects"]["items"]
    del _WL_FAILURES[:]
    t0 = time.perf_counter()
    out, profiled = {}, {}
    parts = [("small", lambda: _wl_small_vs_cpu(out, sizes["small"],
                                                device)),
             ("kmeans", lambda: _wl_kmeans(out, profiled, sizes["kmeans"],
                                           device, pk)),
             ("gmm", lambda: _wl_gmm(out, profiled, sizes["gmm"], device,
                                     pk)),
             ("lda", lambda: _wl_lda(out, profiled, sizes["lda"], device,
                                     pk)),
             ("pagerank", lambda: _wl_pagerank(out, profiled,
                                               sizes["pagerank"], device,
                                               pk)),
             ("topk", lambda: _wl_topk(out, profiled, sizes["topk_table"],
                                       device, pk)),
             ("conv", lambda: _wl_conv(out, profiled, sizes["conv"], device,
                                       pk)),
             ("moe", lambda: _wl_moe(out, profiled, sizes["moe"], device,
                                     pk)),
             ("dedup", lambda: _wl_dedup(out, profiled, sizes["dedup"],
                                         device, pk)),
             ("lsh", lambda: _wl_lsh(out, profiled, device, pk))]
    for name, part in parts:
        try:
            part()
        except Exception as e:  # noqa: BLE001 — raised at the phase's end
            import traceback

            traceback.print_exc()
            print(f"[workloads] {name}: FAILED: {type(e).__name__}: {e}")
            _WL_FAILURES.append(f"{name}: {type(e).__name__}: {e}")
        _wl_free(device)
        print(f"[workloads] {name} done at {time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[workloads] phase 15 wall {out['wall_s']:.1f} s")
    return out, profiled


def workloads_path(pk: dict) -> dict:
    """Phase 15 between launch counts set to 0 and read: neither attention
    kernel lies on these paths."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, _ = phase_workloads(pk)
    launches = (flash_attention.launches, flash_attention_step.launches)
    out["launches"] = {"flash_attention": launches[0],
                       "flash_attention_step": launches[1]}
    print(f"[workloads] launches: flash_attention {launches[0]}, "
          f"flash_attention_step {launches[1]}")
    if any(launches):
        _WL_FAILURES.append(f"attention kernels launched {launches}")
    if _WL_FAILURES:
        raise RuntimeError("phase 15: " + " | ".join(_WL_FAILURES))
    return out


# --- phase 16: one serving daemon on the card ----------------------------
# sizes of the repo's own: bench.py's FF, transformer_bench.py's layer,
# PERF.md's LSTM width; kv_max is the daemon's DecodeRuntime default; 12
# sessions of 128 steps each wrap a 64-entry ring twice and, at
# decode_batch_max 8, put every batch on bucket 8
SERVE_SIZES = {"ff": dict(batch=16384, features=1024, hidden=4096,
                          labels=1024, block=512, requests=3),
               "layer": dict(embed=1024, heads=8, batch=2, seq=4096,
                             requests=3),
               "decode": dict(hidden=1024, heads=8, kv_max=64, sessions=12,
                              steps=128),
               "paged": dict(sf=0.2, pairs=6),
               "residency": dict(finetune_frac=0.25, block=32)}
SERVE_DECODE_TOLS = {"lstm": 1e-4, "transformer_layer": 1e-3}
SERVE_BUDGET_S = 90.0
# the daemon's page size: SF 0.2's lineitem streams in about 40 chunks
SERVE_PAGE_BYTES = 2 << 20
SERVE_TIMEOUT_S = 120.0  # bounds every request to the daemon


# the daemon's process: run_daemon on the phase's Configuration
_SERVE_MAIN = (
    "import sys\n"
    "from netsdb_tpu_torch.config import Configuration\n"
    "from netsdb_tpu_torch.serve.server import run_daemon\n"
    "sys.exit(run_daemon(Configuration(root_dir=sys.argv[1], "
    "model_dedup=True, page_size_bytes=int(sys.argv[3])), port=0, "
    "device=sys.argv[2]))\n")


def _daemon_popen(main: str, args: list, log_path: str):
    """``python -c main *args`` from the repository root, stderr to
    ``log_path`` (a daemon's process)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", main] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=log, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    log.close()
    return proc


def _daemon_addr(proc, log_path: str) -> str:
    """The address a daemon printed once it listens (``run_daemon``'s
    ``serving on HOST:PORT``); kills it and raises if it did not."""
    import threading

    line = []
    reader = threading.Thread(target=lambda: line.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(120)
    if not line or not line[0].startswith("serving on "):
        proc.kill()
        proc.wait(30)
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"a daemon did not start: {line!r}\n{tail}")
    return line[0].split()[-1]


def _serve_start(device: str, root: str, log_path: str):
    """The daemon in its own process (``serve.server.run_daemon``);
    returns (process, address) once it printed the address it listens
    on."""
    proc = _daemon_popen(_SERVE_MAIN, [root, device, SERVE_PAGE_BYTES],
                         log_path)
    return proc, _daemon_addr(proc, log_path)


def _serve_stop(proc, client) -> None:
    try:
        if client is not None:
            client.shutdown_server()
        proc.wait(30)
    except Exception:  # noqa: BLE001 — the kill below stops it anyway
        pass
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)


def _p50(xs) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), 50))


def _serve_ff(remote, local, s, device, card) -> dict:
    """FF at bench.py's shape: weights and inputs over the wire, three
    EXECUTE_COMPUTATIONS, each held to f64 and to the in-process client on
    the same card."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.ff import FFModel

    blk = (s["block"], s["block"])
    rm, lm = FFModel(block=blk), FFModel(block=blk)
    rm.setup(remote)
    lm.setup(local)
    # the draws of FFModel.load_random_weights, made once on the host
    rng = np.random.default_rng(SEED)
    f, h, lab = s["features"], s["hidden"], s["labels"]
    weights = (rng.standard_normal((h, f), dtype=np.float32)
               * np.sqrt(2.0 / f),
               rng.standard_normal((h,), dtype=np.float32) * 0.01,
               rng.standard_normal((lab, h), dtype=np.float32)
               * np.sqrt(2.0 / h),
               rng.standard_normal((lab,), dtype=np.float32) * 0.01)
    t0 = time.perf_counter()
    rm.load_weights(remote, *weights)
    t_w = time.perf_counter() - t0
    w_bytes = sum(w.nbytes for w in weights)
    lm.load_weights(local, *weights)
    p = lm.params_from_store(local)
    w1, b1, wo, bo = (t.to_dense().double() for t in (p.w1, p.b1, p.wo,
                                                      p.bo))
    rng = np.random.default_rng(SEED + 1)
    sink = rm.build_inference_dag()
    ms, local_ms, errs, diffs, ingest = [], [], [], [], []
    busy = wall = 0.0
    for _ in range(s["requests"]):
        x = rng.standard_normal((s["batch"], s["features"]),
                                dtype=np.float32)
        t0 = time.perf_counter()
        rm.load_inputs(remote, x)
        ingest.append(x.nbytes / (time.perf_counter() - t0) / 1e6)
        busy0 = remote.collect_stats()["serve"]["busy_s"]
        t0 = time.perf_counter()
        res = remote.execute_computations(sink, job_name="served-ff")
        dt = time.perf_counter() - t0
        busy += remote.collect_stats()["serve"]["busy_s"] - busy0
        wall += dt
        got = next(iter(res.values())).to_dense()
        lm.load_inputs(local, x)
        _sync(device)
        t1 = time.perf_counter()
        lout = lm.inference(local)
        _sync(device)
        local_ms.append((time.perf_counter() - t1) * 1e3)
        xd = torch.as_tensor(x, device=device).double()
        ref = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1) + bo, dim=0)
        if got.shape != (s["labels"], s["batch"]) \
                or not np.isfinite(got).all():
            raise RuntimeError(f"served FF output {got.shape} is wrong or "
                               f"non-finite")
        err = float((torch.as_tensor(got, device=device).double()
                     - ref).abs().max())
        diff = float(np.abs(got - lout.to_dense().cpu().numpy()).max())
        if not err <= FF_TOL:
            raise RuntimeError(f"served FF: max abs err {err} > {FF_TOL}")
        ms.append(dt * 1e3)
        errs.append(err)
        diffs.append(diff)
        print(f"[serve] ff request {dt * 1e3:.3f} ms (in-process "
              f"{local_ms[-1]:.3f} ms) max_abs_err {err:.3e} vs in-process "
              f"{diff:.3e} inputs {ingest[-1]:.1f} MB/s ({card})")
    out = {"ms": ms, "p50_ms": _p50(ms), "local_ms": local_ms,
           "local_p50_ms": _p50(local_ms), "max_abs_err": max(errs),
           "max_diff_vs_in_process": max(diffs),
           "weights_mb_per_s": w_bytes / t_w / 1e6,
           "inputs_mb_per_s": ingest, "busy_share": busy / wall,
           "rows_per_s": [s["batch"] / (m / 1e3) for m in ms]}
    print(f"[serve] ff p50 {out['p50_ms']:.3f} ms remote vs "
          f"{out['local_p50_ms']:.3f} ms in-process; weights "
          f"{out['weights_mb_per_s']:.1f} MB/s; daemon busy share "
          f"{out['busy_share']:.3f} ({card})")
    return out


def _serve_layer(remote, local, s, device, card) -> dict:
    """The transformer layer executed by the daemon (B1 in its process,
    read through COLLECT_STATS), held to the layer with plain attention."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.attention import merge_project, qkv_project
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_plain

    heads = s["heads"]
    rm, lm = (TransformerLayerModel(db="served_layer", num_heads=heads),
              TransformerLayerModel(db="served_layer", num_heads=heads))
    rm.setup(remote)
    lm.setup(local)
    rm.load_random_weights(remote, embed=s["embed"], seed=SEED)
    lm.load_random_weights(local, embed=s["embed"], seed=SEED)
    p = lm.params_from_store(local)
    rng = np.random.default_rng(SEED + 2)
    ms, errs, launches = [], [], []
    for _ in range(s["requests"]):
        x = rng.standard_normal((s["batch"], s["seq"], s["embed"]),
                                dtype=np.float32)
        rm.load_inputs(remote, x)
        k0 = remote.collect_stats()["metrics"]["kernels"]
        t0 = time.perf_counter()
        (y,) = rm.serve_forward(remote)
        dt = time.perf_counter() - t0
        k1 = remote.collect_stats()["metrics"]["kernels"]
        n = k1["flash_attention"] - k0["flash_attention"]
        n_step = k1["flash_attention_step"] - k0["flash_attention_step"]
        if device == "cuda" and not n >= 1:
            raise RuntimeError(f"the served layer launched "
                               f"flash_attention {n} times")
        if n_step:
            raise RuntimeError(f"the served layer launched "
                               f"flash_attention_step {n_step} times")
        with torch.inference_mode():
            xt = torch.as_tensor(x, device=device)
            q, k, v = (t.contiguous() for t in
                       qkv_project(lm._ln(xt), p.w_qkv, heads))
            x1 = xt + merge_project(flash_attention_plain(q, k, v),
                                    p.w_out)
            ref = x1 + lm._mlp(lm._ln(x1), p)
        y = torch.as_tensor(y).to(device)
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise RuntimeError(f"served layer output {tuple(y.shape)} is "
                               f"wrong or non-finite")
        err = float((y - ref).abs().max())
        if not err <= LAYER_TOL:
            raise RuntimeError(f"served layer: max abs err {err} > "
                               f"{LAYER_TOL}")
        ms.append(dt * 1e3)
        errs.append(err)
        launches.append(n)
        print(f"[serve] layer request {dt * 1e3:.3f} ms "
              f"{s['batch'] * s['seq'] / dt:.1f} tokens/s max_abs_err "
              f"{err:.3e} flash_attention launches in the daemon {n} "
              f"({card})")
    return {"ms": ms, "p50_ms": _p50(ms), "max_abs_err": max(errs),
            "b1_launches": launches,
            "tokens_per_s": [s["batch"] * s["seq"] / (m / 1e3) for m in ms]}


def _decode_oracle(kind, dense, xs, heads, kv_max, device):
    """Every session's outputs in float64 on the card, written here from
    the models' definitions and independent of ``models/decode.py``: the
    LSTM cell, and the layer attending over a sliding window of its last
    ``kv_max`` keys and values (the sessions step in lockstep)."""
    import numpy as np
    import torch

    p = {k: torch.as_tensor(v, device=device).double() for k, v in
         dense.items()}
    n, steps, hidden = xs.shape
    out = np.zeros(xs.shape, np.float64)
    sig = torch.sigmoid
    with torch.inference_mode():
        if kind == "lstm":
            h = torch.zeros(n, hidden, device=device, dtype=torch.float64)
            c = torch.zeros_like(h)
            for s in range(steps):
                x = torch.as_tensor(xs[:, s], device=device).double()
                z = {g: x @ p["w_" + g].T + h @ p["u_" + g].T
                     + p["b_" + g][:, 0] for g in "ifco"}
                c = sig(z["f"]) * c + sig(z["i"]) * torch.tanh(z["c"])
                h = sig(z["o"]) * torch.tanh(c)
                out[:, s] = h.cpu().numpy()
            return out
        dh = hidden // heads
        keys, vals = [], []
        for s in range(steps):
            x = torch.as_tensor(xs[:, s], device=device).double()
            keys = (keys + [(x @ p["wk"].T).reshape(n, heads, dh)])[-kv_max:]
            vals = (vals + [(x @ p["wv"].T).reshape(n, heads, dh)])[-kv_max:]
            q = (x @ p["wq"].T).reshape(n, heads, 1, dh)
            k, v = torch.stack(keys, 2), torch.stack(vals, 2)  # n,h,T,dh
            w = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5, dim=-1)
            y = x + (w @ v).reshape(n, hidden) @ p["wo"].T
            out[:, s] = (y + torch.relu(y @ p["w1"].T)
                         @ p["w2"].T).cpu().numpy()
    return out


def _serve_decode(addr, remote, s, device, card) -> dict:
    """12 concurrent sessions per model through SessionHandle, 128 steps
    each; one session re-run solo; every output held to f64."""
    import threading

    import numpy as np

    from netsdb_tpu_torch.models import decode as dec
    from netsdb_tpu_torch.serve.client import RemoteClient

    out = {}
    n, steps, hidden, heads = (s["sessions"], s["steps"], s["hidden"],
                               s["heads"])
    rng = np.random.default_rng(SEED + 16)
    for kind, db, seed in (("lstm", "dec_lstm", SEED + 3),
                           ("transformer_layer", "dec_layer", SEED + 4)):
        dec.deploy_decode_model(remote, db, kind=kind, hidden=hidden,
                                heads=heads, seed=seed)
        dense = dec.decode_weights(kind, hidden, heads, seed)
        xs = rng.standard_normal((n, steps, hidden)).astype(np.float32)
        clients = [RemoteClient(addr, timeout=SERVE_TIMEOUT_S,
                                connect_timeout=30.0) for _ in range(n)]
        try:
            handles = [c.open_session(db, kind=kind, heads=heads)
                       for c in clients]
            got = np.zeros(xs.shape, np.float32)
            lat = [[] for _ in range(n)]
            errors = []
            barrier = threading.Barrier(n)

            def drive(i):
                try:
                    barrier.wait(60)
                    for t in range(steps):
                        t0 = time.perf_counter()
                        got[i, t] = handles[i].generate(xs[i, t],
                                                        deadline_s=120.0)
                        lat[i].append((time.perf_counter() - t0) * 1e3)
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append((i, repr(e)))

            threads = [threading.Thread(target=drive, args=(i,))
                       for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"{kind} sessions failed: {errors[:3]}")
            if any(h.steps != steps for h in handles):
                raise RuntimeError(f"{kind}: steps "
                                   f"{[h.steps for h in handles]}")
            solo = clients[0].open_session(db, kind=kind, heads=heads)
            solo_out = np.stack([solo.generate(xs[0, t], deadline_s=120.0)
                                 for t in range(steps)])
            for h in handles + [solo]:
                h.close()
        finally:
            for c in clients:
                c.close()
        if solo_out.tobytes() != got[0].tobytes():
            raise RuntimeError(f"{kind}: the solo run differs from the "
                               f"batched one by "
                               f"{np.abs(solo_out - got[0]).max():.3e}")
        oracle = _decode_oracle(kind, dense, xs, heads, s["kv_max"], device)
        err = float(np.abs(got.astype(np.float64) - oracle).max())
        tol = SERVE_DECODE_TOLS[kind]
        if not err <= tol or not np.isfinite(got).all():
            raise RuntimeError(f"{kind} decode: max abs err {err} vs f64 "
                               f"> {tol}")
        flat = [x for row in lat for x in row]
        out[kind] = {"steps_per_s": n * steps / wall,
                     "generate_p50_ms": _p50(flat),
                     "generate_p99_ms": float(np.percentile(flat, 99)),
                     "max_abs_err": err, "solo_bit_equal": True,
                     "wall_s": wall}
        print(f"[serve] decode {kind}: {n} sessions x {steps} steps "
              f"{n * steps / wall:.1f} steps/s, GENERATE p50 "
              f"{_p50(flat):.3f} ms p99 {out[kind]['generate_p99_ms']:.3f} "
              f"ms, max_abs_err vs f64 {err:.3e}, solo bit-equal ({card})")
    return out


def _serve_paged_pair(addr, remote, local, s, device, card) -> dict:
    """Q01 over a paged lineitem through the daemon: a cold request (its
    fold steps eager), one that captures the step's graph, a warm one
    (which captures the signatures the second saw first, the ragged last
    chunk's), then ``pairs`` pairs of requests from two clients at once,
    which replay those graphs from two handler threads (a chunk shape a
    pair meets first is captured by the next request that meets it, as
    in any request). Each request's DAG is built anew, so the scheduler
    cannot coalesce the two. The two of a pair write one output set,
    whose clear and add are two store calls (as in the reference), so a
    client reading it back during the other's write may find it empty,
    and the two writes may leave both tables: the set is read once the
    pair is done, and every table in it is held to the plan run node by
    node in this process."""
    import threading

    from netsdb_tpu_torch.relational import bench as rbench
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.serve.client import RemoteClient

    db = "srv_tpch"
    cols, dicts = rbench.generate_host(sf=s["sf"], seed=SEED)["lineitem"]
    for c, storage in ((remote, "paged"), (local, "memory")):
        c.create_database(db)
        c.create_set(db, "lineitem", type_name="table", storage=storage)
        c.send_table(db, "lineitem", ColumnTable.from_columns(
            cols, dicts, device="cpu"))
    ref = node_by_node(local, dag.q01_sink(db))
    job = "served-q01"

    def request(client):
        t0 = time.perf_counter()
        client.execute_computations(dag.q01_sink(db), job_name=job,
                                    fetch_results=False)
        return (time.perf_counter() - t0) * 1e3

    def hold_written(name):
        tables = list(remote.get_set_iterator(db, "q01_out"))
        if not tables:
            raise RuntimeError(f"{name}: no table written")
        return max(_hold(name, t, ref) for t in tables)

    def programs_now():
        return remote.collect_stats()["metrics"]["programs"]

    errs, ms = [], []
    for kind in ("cold", "capture", "warm"):
        ms.append(request(remote))
        errs.append(hold_written(f"served q01 {kind}"))
    p0 = programs_now()
    clients = [RemoteClient(addr, timeout=SERVE_TIMEOUT_S,
                            connect_timeout=30.0) for _ in range(2)]
    pair_ms = []
    try:
        for n in range(s["pairs"]):
            got, errors = [None, None], []
            barrier = threading.Barrier(2)

            def one(i):
                try:
                    barrier.wait(60)
                    got[i] = request(clients[i])
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(repr(e))

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"served q01 pair {n}: {errors[:2]}")
            pair_ms.extend(got)
            errs.append(hold_written(f"served q01 pair {n}"))
    finally:
        for c in clients:
            c.close()
    p1 = programs_now()
    replays = p1["replays"] - p0["replays"]
    captures = p1["captures"] - p0["captures"]
    if device == "cuda" and replays < 2 * s["pairs"]:
        raise RuntimeError(f"the pairs made {replays} replays and "
                           f"{captures} captures: they did not share one "
                           f"captured graph")
    remote.remove_set(db, "lineitem")
    out = {"cold_ms": ms[0], "capture_ms": ms[1], "warm_ms": ms[2],
           "pair_ms": pair_ms, "pair_p50_ms": _p50(pair_ms),
           "replays": replays, "captures": captures,
           "max_rel_err": max(errs)}
    print(f"[serve] paged q01: cold {ms[0]:.3f} ms, capturing {ms[1]:.3f} "
          f"ms, warm {ms[2]:.3f} ms, {s['pairs']} concurrent pairs p50 "
          f"{out['pair_p50_ms']:.3f} ms over {replays} step replays and "
          f"{captures} captures, every result held to node by node (max "
          f"rel err {max(errs):.3e}) ({card})")
    return out


def _planted_unique_bytes(models, block) -> tuple:
    """(unique page bytes, total page bytes) of the registered models'
    weights tiled by ``block`` (a bias by ``(block, 1)``), counted on the
    host from the tiles' bytes: the pages distinct over all models, and
    the sum over models of each model's distinct pages."""
    import hashlib

    seen, total = {}, 0
    for dense in models:
        mine = {}
        for w in dense.values():
            bw = 1 if w.shape[1] == 1 else block
            for i in range(0, w.shape[0], block):
                for j in range(0, w.shape[1], bw):
                    key = hashlib.sha256(
                        w[i:i + block, j:j + bw].tobytes()).hexdigest()
                    mine[key] = block * bw * 4
        seen.update(mine)
        total += sum(mine.values())
    return sum(seen.values()), total


def _serve_sync_beside_capture(root: str, device: str, card) -> dict:
    """A handler's reply wait (``ServeController._sync_results``) while
    another handler thread of the daemon is inside a graph capture: the
    capture is held open until the wait has returned, so the two always
    overlap (a device-wide wait fails there; the served pairs met it by
    chance). The wait must return and the program must still capture."""
    import threading

    import torch

    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.plan import programs
    from netsdb_tpu_torch.serve.server import ServeController

    if device != "cuda":
        return {}
    ctl = ServeController(Configuration(root_dir=root), port=0,
                          device=device)
    x = torch.arange(1 << 20, dtype=torch.float32, device=ctl.device)
    capturing, waited = threading.Event(), threading.Event()

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            waited.wait(30)
        return t * 2 + 1

    prog = programs.Program("smoke::sync-beside-capture",
                            on_trace=lambda: None)
    got = {}

    def capture():
        try:
            got["out"] = prog(fn, x)
        except Exception as e:  # noqa: BLE001 — raised below
            got["err"] = repr(e)
        capturing.set()

    c0 = programs.program_stats()["captures"]
    th = threading.Thread(target=capture)
    th.start()
    try:
        if not capturing.wait(30):
            raise RuntimeError("the capture never began")
        (x + 1).sum()
        ctl._sync_results({})
    finally:
        waited.set()
        th.join(30)
        ctl.shutdown()
    if "err" in got or th.is_alive():
        raise RuntimeError(f"capture beside a reply wait: {got.get('err')}")
    captures = programs.program_stats()["captures"] - c0
    if captures != 1 or prog(fn, x).ne(x * 2 + 1).any():
        raise RuntimeError(f"{captures} captures beside a reply wait, or "
                           f"a wrong replay")
    print(f"[serve] a reply wait beside another thread's capture returned; "
          f"the graph captured and replays right ({card})")
    return {"captures": captures}


def _serve_residency(remote, s, r, device, card) -> dict:
    """Two fine-tuned layer variants of one base under model_dedup: each
    one's step through the daemon's one layer program held to the f64
    oracle with its own weights; the daemon's residency report and its
    pool against the planted page count; the charges sum to the pool."""
    import numpy as np

    from netsdb_tpu_torch.models import decode as dec

    hidden, heads = s["hidden"], s["heads"]
    x = np.random.default_rng(SEED + 17).standard_normal(
        hidden).astype(np.float32)
    ys = []
    tol = SERVE_DECODE_TOLS["transformer_layer"]
    for db, seed in (("dec_va", SEED + 21), ("dec_vb", SEED + 22)):
        dec.deploy_decode_model(remote, db, kind="transformer_layer",
                                hidden=hidden, heads=heads, seed=seed,
                                base_seed=SEED + 77,
                                finetune_frac=r["finetune_frac"])
        h = remote.open_session(db, kind="transformer_layer", heads=heads)
        ys.append(h.generate(x))
        h.close()
        want = _decode_oracle(
            "transformer_layer", dec.decode_weights(
                "transformer_layer", hidden, heads, seed,
                base_seed=SEED + 77, finetune_frac=r["finetune_frac"]),
            x[None, None], heads, s["kv_max"], device)[0, 0]
        err = float(np.abs(ys[-1] - want).max())
        if not err <= tol:
            raise RuntimeError(f"variant {db}: max abs err {err} vs its "
                               f"own weights in f64 > {tol}")
    if ys[0].tobytes() == ys[1].tobytes():
        raise RuntimeError("the two fine-tuned variants decode alike")
    rep = remote.collect_stats()["sessions"]["residency"]
    models = [dec.decode_weights("lstm", hidden, heads, SEED + 3),
              dec.decode_weights("transformer_layer", hidden, heads,
                                 SEED + 4)]
    models += [dec.decode_weights("transformer_layer", hidden, heads, seed,
                                  base_seed=SEED + 77,
                                  finetune_frac=r["finetune_frac"])
               for seed in (SEED + 21, SEED + 22)]
    planted, total = _planted_unique_bytes(models, r["block"])
    charged = sum(rep["charged_by_model"].values())
    pooled = (rep.get("pool") or {}).get("hbm_bytes_pooled")
    if rep["models"] != 4 or rep["unique_page_bytes"] != planted \
            or rep["total_page_bytes"] != total or pooled != planted \
            or abs(charged - rep["unique_page_bytes"]) > rep["models"]:
        raise RuntimeError(f"residency: {rep} against planted unique "
                           f"{planted} of {total} bytes")
    print(f"[serve] residency: 4 models, unique pages {planted} B of "
          f"{total} B planted and reported; charges sum {charged} B; pool "
          f"{pooled} B ({card})")
    return {"unique_page_bytes": planted, "total_page_bytes": total,
            "charged_sum": charged, "pool": rep.get("pool")}


def phase_serve(pk: dict, smi: str, device: str = "cuda",
                sizes: Optional[dict] = None) -> dict:
    """Phase 16: the daemon in its own process on the card, this script
    its client (``SERVE_SIZES``): served FF, the served transformer layer
    (B1 in the daemon), decode sessions and multi-model residency."""
    import os
    import shutil
    import tempfile

    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.serve.client import RemoteClient

    s = {k: dict(v, **((sizes or {}).get(k, {})))
         for k, v in SERVE_SIZES.items()}
    card = smi
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="netsdb_serve_")
    proc, remote = None, None
    try:
        proc, addr = _serve_start(device, os.path.join(root, "daemon"),
                                  os.path.join(root, "daemon.log"))
        print(f"[serve] daemon pid {proc.pid} on {addr} "
              f"({time.perf_counter() - t0:.1f} s to listen) ({card})")
        remote = RemoteClient(addr, timeout=SERVE_TIMEOUT_S,
                              connect_timeout=30.0)
        if not remote.pickle_ok:
            raise RuntimeError("the daemon refused this interpreter's "
                               "pickle codec")
        k_start = remote.collect_stats()["metrics"]["kernels"]
        local = Client(device=device)
        out = {"sync_beside_capture": _serve_sync_beside_capture(
                   os.path.join(root, "capture"), device, card),
               "ff": _serve_ff(remote, local, s["ff"], device, card),
               "layer": _serve_layer(remote, local, s["layer"], device,
                                     card),
               "paged": _serve_paged_pair(addr, remote, local, s["paged"],
                                          device, card)}
        del local
        if device == "cuda":
            torch.cuda.empty_cache()
        out["decode"] = _serve_decode(addr, remote, s["decode"], device,
                                      card)
        out["residency"] = _serve_residency(remote, s["decode"],
                                            s["residency"], device, card)
        stats = remote.collect_stats()
        dstats = stats["sessions"]["decode"]
        if dstats["traces"] != 2:
            raise RuntimeError(f"decode traces {dstats} != 2 (one per "
                               f"kind, shape and bucket)")
        if stats["sessions"]["arena"]["reads"] != 0:
            raise RuntimeError(f"warm steps read the arena: "
                               f"{stats['sessions']['arena']}")
        k_end = stats["metrics"]["kernels"]
        out["launches"] = {k: k_end[k] - k_start[k] for k in k_end}
        out["decode_stats"] = dstats
        out["pid"] = stats["serve"]["pid"]
        if out["pid"] == os.getpid() or out["pid"] != proc.pid:
            raise RuntimeError("the daemon did not run in its own process")
        out["wall_s"] = time.perf_counter() - t0
        print(f"[serve] decode traces {dstats['traces']}, batches "
              f"{dstats['batches']}, pad rows {dstats['pad_rows']}, arena "
              f"reads 0; daemon launches {out['launches']}; phase 16 wall "
              f"{out['wall_s']:.1f} s ({card})")
        if out["wall_s"] > SERVE_BUDGET_S:
            print(f"[serve] WARNING: phase 16 took {out['wall_s']:.1f} s, "
                  f"over its {SERVE_BUDGET_S} s budget")
        return out
    except BaseException:
        # the daemon's thread stacks (SIGUSR1: faulthandler) and its log
        if proc is not None and proc.poll() is None:
            import signal

            proc.send_signal(signal.SIGUSR1)
            time.sleep(1.0)
        try:
            with open(os.path.join(root, "daemon.log")) as f:
                print("[serve] daemon log:\n" + f.read()[-12000:])
        except OSError:
            pass
        raise
    finally:
        if proc is not None:
            _serve_stop(proc, remote)
        if remote is not None:
            remote.close()
        shutil.rmtree(root, ignore_errors=True)


# --- phase 17: the shard pool on the card --------------------------------
# the reference's serving and scale-out benches (serve_bench.py:1073-1076
# and :794-797), a pool of a leader and 3 workers (daemons=4), and FF at
# bench.py's width with 4096 rows a slot; in-process, two daemons of this
# process with the same set names at 200 000 rows
POOL_SIZES = {"serving": dict(batch=8192, features=256, hidden=512,
                              labels=64, block=128, frames=6),
              "bench_ff": dict(rows_per_slot=4096, features=1024,
                               hidden=4096, labels=1024, block=512,
                               frames=3),
              "scaleout": dict(rows=6_000_000, page_rows=65_536, queries=6,
                               join_orders=2048, join_rows=400_000),
              "failure": dict(rows=600_000, append_rows=60_000),
              "inproc": dict(rows=200_000, requests=4)}
POOL_DAEMONS = 4
POOL_BUDGET_S = 120.0
POOL_TIMEOUT_S = 300.0     # bounds every request to a pool daemon
POOL_READMIT_S = 90.0      # bounds the wait for a restarted worker


# a pool daemon's process: run_daemon on the phase's Configuration; argv is
# root, device, page bytes, workers ("" for none), port
_POOL_MAIN = (
    "import sys\n"
    "from netsdb_tpu_torch.config import Configuration\n"
    "from netsdb_tpu_torch.serve.server import run_daemon\n"
    "w = [a for a in sys.argv[4].split(',') if a]\n"
    "kw = dict(heartbeat_interval_s=1.0, heartbeat_timeout_s=10.0) if w "
    "else {}\n"
    "sys.exit(run_daemon(Configuration(root_dir=sys.argv[1], "
    "page_size_bytes=int(sys.argv[3]), device_cache_bytes=0), "
    "port=int(sys.argv[5]), device=sys.argv[2], workers=w or None, "
    "mirror_ack_timeout_s=300.0, **kw))\n")


def _pool_popen(root: str, device: str, page_bytes: int, workers: list,
                port: int, log_path: str):
    return _daemon_popen(_POOL_MAIN, [root, device, page_bytes,
                                      ",".join(workers), port], log_path)


def _card_memory() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _pool_ints(rng, shape):
    """Integer-valued f32 in [-3, 3) (serve_bench.py:1107): every sum of
    the serving gate stays an exact integer."""
    import numpy as np
    return rng.integers(-3, 3, size=shape).astype(np.float32)


def _pool_serving(pool_addr, solo, s, card) -> dict:
    """The reference's serving gate: ff_serving deploy, then frames whose
    scores equal the solo daemon's byte for byte, one program per shard,
    at most ceil(B/4) input rows on any daemon."""
    import numpy as np
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.serving import ff_serving
    from netsdb_tpu_torch.serve.client import RemoteClient

    rng = np.random.default_rng(SEED)
    f, h, lab, b = s["features"], s["hidden"], s["labels"], s["batch"]
    weights = (_pool_ints(rng, (h, f)), _pool_ints(rng, (h,)),
               _pool_ints(rng, (lab, h)), _pool_ints(rng, (lab,)))
    batches = [_pool_ints(rng, (b, f)) for _ in range(s["frames"])]
    blk = (s["block"], s["block"])
    sm = FFModel(db="ffsolo", block=blk)
    sm.setup(solo)
    sm.load_weights(solo, *weights)
    sink = sm.build_inference_dag()
    oracle, solo_s = [], []
    for x in batches:
        t0 = time.perf_counter()
        sm.load_inputs(solo, x)
        res = solo.execute_computations(sink, job_name="ffsolo")
        oracle.append(np.asarray(next(iter(res.values())).to_dense()))
        solo_s.append(time.perf_counter() - t0)
    model = FFModel(db="ffserving", block=blk)

    def load(c):
        model.setup(c)
        model.load_weights(c, *weights)

    srv = ff_serving(model, pool_addr, block=blk, timeout=POOL_TIMEOUT_S)
    try:
        addrs = srv.deploy(load)
        if len(addrs) != POOL_DAEMONS:
            raise RuntimeError(f"the pool has {len(addrs)} slots, not "
                               f"{POOL_DAEMONS}")
        frame_s = []
        for i, x in enumerate(batches):
            t0 = time.perf_counter()
            if i == 0:
                out, forest = srv.score(x, explain=True)
            else:
                out = srv.score(x)
            frame_s.append(time.perf_counter() - t0)
            got = np.asarray(out.to_dense())
            if got.tobytes() != oracle[i].tobytes():
                raise RuntimeError(
                    f"serving frame {i}: the pool's scores differ from the "
                    f"solo daemon's (max |d| "
                    f"{float(np.abs(got - oracle[i]).max())})")
        for addr, tree in forest.items():
            nodes = [n for n in tree["nodes"]
                     if n.get("kind") != "WholePlanJit"]
            if tree["mode"] != "whole_plan_jit" or not all(
                    n.get("fused") for n in nodes):
                raise RuntimeError(f"shard {addr} did not run the chain as "
                                   f"one program: {tree['mode']}")
        if sorted(forest) != sorted(addrs):
            raise RuntimeError(f"EXPLAIN forest {sorted(forest)} != slots")
        bound = -(-b // POOL_DAEMONS)
        held = {}
        for addr in addrs:
            c = RemoteClient(addr, timeout=POOL_TIMEOUT_S)
            try:
                held[addr] = int(c.get_tensor("ffserving",
                                              "inputs").shape[0])
            finally:
                c.close()
        if max(held.values()) > bound or sum(held.values()) != b:
            raise RuntimeError(f"input rows by daemon {held}: over "
                               f"ceil(B/4) = {bound} or not the batch")
    finally:
        srv.close()
    warm = frame_s[1:]
    out = {"frames": len(batches), "byte_equal": True,
           "one_program_per_shard": True, "rows_by_daemon": held,
           "frame_ms": [round(t * 1e3, 3) for t in frame_s],
           "pool_rows_per_s": b * len(warm) / sum(warm),
           "solo_rows_per_s": b * len(solo_s[1:]) / sum(solo_s[1:])}
    print(f"[pool] serving gate: batch {b} x {f} -> {h} -> {lab}, blocks "
          f"{blk}, {len(batches)} frames byte-equal to the solo daemon, "
          f"one program per shard, input rows by daemon "
          f"{sorted(held.values())} (bound {bound}); warm frames "
          f"{out['pool_rows_per_s']:.0f} rows/s pool, "
          f"{out['solo_rows_per_s']:.0f} rows/s solo ({card})")
    return out


def _pool_bench_ff(pool_addr, solo, s, device, card) -> dict:
    """FF at bench.py's width, 4096 rows a slot: three frames each held to
    f64 at FF_TOL; the pool's and the solo daemon's rows/s on one card."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.serving import ff_serving

    f, h, lab = s["features"], s["hidden"], s["labels"]
    b = s["rows_per_slot"] * POOL_DAEMONS
    blk = (s["block"], s["block"])
    rng = np.random.default_rng(SEED + 17)
    weights = (rng.standard_normal((h, f), dtype=np.float32)
               * np.sqrt(2.0 / f),
               rng.standard_normal((h,), dtype=np.float32) * 0.01,
               rng.standard_normal((lab, h), dtype=np.float32)
               * np.sqrt(2.0 / h),
               rng.standard_normal((lab,), dtype=np.float32) * 0.01)
    w1, b1, wo, bo = (torch.as_tensor(w, device=device).double()
                      for w in weights)
    model = FFModel(db="ffbench", block=blk)

    def load(c):
        model.setup(c)
        model.load_weights(c, *weights)

    load(solo)
    solo_sink = model.build_inference_dag()
    srv = ff_serving(model, pool_addr, block=blk, timeout=POOL_TIMEOUT_S)
    pool_s, solo_s, errs = [], [], []
    try:
        srv.deploy(load)
        for i in range(s["frames"]):
            x = rng.standard_normal((b, f), dtype=np.float32)
            xd = torch.as_tensor(x, device=device).double()
            ref = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1[:, None])
                                + bo[:, None], dim=0)
            t0 = time.perf_counter()
            got = np.asarray(srv.score(x).to_dense())
            pool_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            model.load_inputs(solo, x)
            sres = solo.execute_computations(solo_sink, job_name="ffbench")
            sgot = np.asarray(next(iter(sres.values())).to_dense())
            solo_s.append(time.perf_counter() - t0)
            for name, g in (("pool", got), ("solo", sgot)):
                if g.shape != (lab, b) or not np.isfinite(g).all():
                    raise RuntimeError(f"{name} FF frame {i}: shape "
                                       f"{g.shape} or non-finite")
            err = float((torch.as_tensor(got, device=device).double()
                         - ref).abs().max())
            errs.append(err)
            if err > FF_TOL:
                raise RuntimeError(f"pool FF frame {i}: max abs error {err} "
                                   f"> {FF_TOL} against f64")
    finally:
        srv.close()
    out = {"batch": b, "frames": s["frames"], "max_abs_err": max(errs),
           "pool_ms": [round(t * 1e3, 3) for t in pool_s],
           "solo_ms": [round(t * 1e3, 3) for t in solo_s],
           "pool_rows_per_s": b * len(pool_s[1:]) / sum(pool_s[1:]),
           "solo_rows_per_s": b * len(solo_s[1:]) / sum(solo_s[1:])}
    print(f"[pool] FF {b} x {f} -> {h} -> {lab} (blocks {blk}, "
          f"{s['rows_per_slot']} rows a slot): max abs err vs f64 "
          f"{out['max_abs_err']:.3g} (limit {FF_TOL}); frames ms pool "
          f"{out['pool_ms']}, solo {out['solo_ms']}; rows/s after the first "
          f"frame: pool {out['pool_rows_per_s']:.0f}, solo "
          f"{out['solo_rows_per_s']:.0f}, both on one card ({card})")
    return out


def _pool_float_table(rows: int, seed: int):
    """The columns of tests/test_scaleout.py:258-270 (the float Q01)."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.relational.table import ColumnTable

    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19920101, 19981231, rows, dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows,
                                   dtype=np.int32).astype(np.float32),
        "l_extendedprice": rng.uniform(1000, 100000, rows).astype(np.float32),
        "l_discount": rng.uniform(0, 0.1, rows).astype(np.float32),
        "l_tax": rng.uniform(0, 0.08, rows).astype(np.float32)}
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                       {"l_returnflag": ["A", "N", "R"],
                        "l_linestatus": ["F", "O"]})


def _q01_float_rows(client, out_set):
    """The float Q01's valid rows by column, on the host."""
    import numpy as np

    t = client.get_table("d", out_set)
    ok = t.valid.numpy() if t.valid is not None else np.ones(
        t.num_rows, bool)
    return {k: v.numpy()[ok] for k, v in t.cols.items()}


def _pool_counter(clients, name) -> int:
    """A registry counter summed over daemons (their COLLECT_STATS)."""
    total = 0
    for c in clients:
        total += int(c.collect_stats()["metrics"].get("counters", {})
                     .get(name, 0))
    return total


def _pool_scaleout(pool_c, solo, daemon_clients, s, card) -> dict:
    """run_scaleout_bench's configuration: routed ingest, six cold Q01
    scatters byte-equal to solo, the float Q01 within TPCH-style limits
    and the shuffle join byte-equal to solo."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.workloads.serve_bench import (_scale_rows,
                                                        scaleout_join_sink,
                                                        scaleout_q01_sink,
                                                        scaleout_table)

    table = scaleout_table(s["rows"])
    payload_mb = sum(int(v.nbytes) for v in table.cols.values()) / 2 ** 20
    out = {"rows": s["rows"], "payload_mb": payload_mb}
    for name, c, kw in (("pool", pool_c, {"placement": "range"}),
                        ("solo", solo, {})):
        c.create_database("d")
        c.create_set("d", "warm", type_name="table", storage="paged", **kw)
        c.send_table("d", "warm", scaleout_table(4096, seed=9))
        c.create_set("d", "lineitem", type_name="table", storage="paged",
                     **kw)
        t0 = time.perf_counter()
        c.send_table("d", "lineitem", table)
        out[f"{name}_ingest_mb_per_s"] = payload_mb / (time.perf_counter()
                                                       - t0)
    sink = scaleout_q01_sink("d")
    rows = {}
    from netsdb_tpu_torch import obs

    seen = {p["qid"] for p in obs.DEFAULT_RING.last()}
    pool_qid = None
    for name, c in (("pool", pool_c), ("solo", solo)):
        ms = []
        for q in range(s["queries"] + 1):  # the first builds the programs
            t0 = time.perf_counter()
            c.execute_computations(sink, job_name="scale-q01",
                                   fetch_results=False)
            ms.append((time.perf_counter() - t0) * 1e3)
            qid = _obs_new_qid(seen)
            if name == "pool":
                pool_qid = qid
            got = _scale_rows(c, "d", "scale_q01_out")
            if q and got != rows.setdefault(name, got):
                raise RuntimeError(f"{name} Q01 request {q} changed its rows")
            rows[name] = got
        out[f"{name}_q01_ms"] = [round(m, 3) for m in ms]
    if rows["pool"] != rows["solo"] or len(rows["pool"]) != 6:
        raise RuntimeError(f"scatter Q01 {rows['pool']} != solo "
                           f"{rows['solo']}")
    # the last scatter's trace: every worker's subplan under its qid
    workers = [c.current_address for c in daemon_clients[1:]]
    (prof,) = [p for p in pool_c.get_trace(qid=pool_qid)["profiles"]
               if p["origin"] == "server"]
    sections = prof.get("shards") or {}
    if any(not sections.get(w) or any(sp["qid"] != pool_qid
                                      for sp in sections[w])
           for w in workers):
        raise RuntimeError(f"scatter Q01 {pool_qid}: the leader's trace "
                           f"lacks a worker's section: {sorted(sections)} "
                           f"of {workers}")
    out["trace_shards"] = {w: [round(sp["total_s"] * 1e3, 3)
                               for sp in sections[w]] for w in workers}
    print(f"[pool] scatter Q01 trace {pool_qid}: leader {prof['total_s'] * 1e3:.3f}"
          f" ms; worker sections under the same qid (ms) "
          f"{out['trace_shards']} ({card})")
    # the real relational/dag.q01_sink over the same placement
    ftable = _pool_float_table(s["rows"], SEED + 3)
    f_rows = {}
    for name, c, kw in (("pool", pool_c, {"placement": "range"}),
                        ("solo", solo, {})):
        c.create_set("d", "lineitem_f", type_name="table", storage="paged",
                     **kw)
        c.send_table("d", "lineitem_f", ftable)
        t0 = time.perf_counter()
        c.execute_computations(dag.q01_sink("d", lineitem_set="lineitem_f"),
                               job_name="q01f", fetch_results=False)
        out[f"{name}_real_q01_ms"] = (time.perf_counter() - t0) * 1e3
        f_rows[name] = _q01_float_rows(c, "q01_out")
    worst = 0.0
    for k, want in f_rows["solo"].items():
        got = f_rows["pool"][k]
        if got.dtype.kind in "iu":
            if not np.array_equal(got, want):
                raise RuntimeError(f"real Q01 column {k}: ints differ")
        else:
            rel = float(np.max(np.abs(got - want)
                               / np.maximum(np.abs(want), 1e-30)))
            worst = max(worst, rel)
            if not np.allclose(got, want, rtol=1e-5, atol=0):
                raise RuntimeError(f"real Q01 column {k}: rel err {rel}")
    out["real_q01_max_rel"] = worst
    # the shuffle join, hash-placed
    rng = np.random.default_rng(7)
    jli = ColumnTable({
        "l_orderkey": torch.from_numpy(rng.integers(
            0, s["join_orders"], s["join_rows"], dtype=np.int32)),
        "l_price": torch.from_numpy(rng.integers(
            1, 1000, s["join_rows"], dtype=np.int32))}, {}, None)
    jord = ColumnTable({"o_orderkey": torch.arange(s["join_orders"],
                                                   dtype=torch.int32)},
                       {}, None)
    jsink = scaleout_join_sink("d", s["join_orders"], lineitem_set="jli",
                               orders_set="jorders")
    parts0 = _pool_counter(daemon_clients, "shard.shuffle_parts")
    j_rows = {}
    for name, c, kw in (("pool", pool_c, {"placement": "hash"}),
                        ("solo", solo, {})):
        c.create_set("d", "jli", type_name="table", **kw)
        c.create_set("d", "jorders", type_name="table", **kw)
        c.send_table("d", "jli", jli)
        c.send_table("d", "jorders", jord)
        t0 = time.perf_counter()
        c.execute_computations(jsink, job_name="scale-join",
                               fetch_results=False)
        out[f"{name}_join_ms"] = (time.perf_counter() - t0) * 1e3
        j_rows[name] = _scale_rows(c, "d", "scale_join_out")
    parts = _pool_counter(daemon_clients, "shard.shuffle_parts") - parts0
    want_parts = POOL_DAEMONS * 2 * (POOL_DAEMONS - 1)
    if j_rows["pool"] != j_rows["solo"] \
            or len(j_rows["pool"]) != s["join_orders"]:
        raise RuntimeError("the shuffle join differs from the solo daemon")
    if parts != want_parts:
        raise RuntimeError(f"shard.shuffle_parts moved {parts}, not "
                           f"{want_parts}")
    out["shuffle_parts"] = parts
    print(f"[pool] scale-out: {s['rows']} rows ({payload_mb:.1f} MiB) "
          f"range-placed in {s['page_rows']}-row pages, ingest MB/s routed "
          f"{out['pool_ingest_mb_per_s']:.1f} vs one daemon "
          f"{out['solo_ingest_mb_per_s']:.1f}; cold Q01 ms pool "
          f"{out['pool_q01_ms']}, solo {out['solo_q01_ms']} (byte-equal); "
          f"real Q01 ms pool {out['pool_real_q01_ms']:.1f}, solo "
          f"{out['solo_real_q01_ms']:.1f} (ints exact, floats max rel "
          f"{worst:.3g}); shuffle join {s['join_orders']} x "
          f"{s['join_rows']} ms pool {out['pool_join_ms']:.1f}, solo "
          f"{out['solo_join_ms']:.1f} (byte-equal, {parts} buckets) "
          f"({card})")
    return out


def _pool_failure(pool_c, solo, procs, victim, roots, ports, device, logs,
                  s, card) -> dict:
    """Worker ``victim`` killed during a scatter: the typed retryable
    error and the output set unchanged; an append lands in the leader's
    handoff; the worker restarts on its port (``procs[victim]`` becomes
    the new process, for the caller to stop), reloads its flushed slot, is
    readmitted (SHARD_RESYNC, then the handoff drain) and the query
    equals solo."""
    import signal
    import threading

    from netsdb_tpu_torch.serve.client import (PlacementStaleError,
                                               RemoteClient, RetryPolicy,
                                               ShardUnavailableError)
    from netsdb_tpu_torch.workloads.serve_bench import (_scale_rows,
                                                        scaleout_q01_sink,
                                                        scaleout_table)

    t0 = time.perf_counter()
    table = scaleout_table(s["rows"], seed=21)
    extra = scaleout_table(s["append_rows"], seed=22)
    sink = scaleout_q01_sink("d", lineitem_set="fail_li",
                             output_set="fail_out")
    for c, kw in ((pool_c, {"placement": "range"}), (solo, {})):
        c.create_set("d", "fail_li", type_name="table", storage="paged",
                     persistence="persistent", **kw)
        c.send_table("d", "fail_li", table)
    pool_c.execute_computations(sink, job_name="fail", fetch_results=False)
    before = _scale_rows(pool_c, "d", "fail_out")
    vaddr = f"127.0.0.1:{ports[victim]}"
    vc = RemoteClient(vaddr, timeout=POOL_TIMEOUT_S)
    vc.flush_data()  # the worker's slot on its disk, for the restart
    vc.close()
    one = RemoteClient(pool_c.current_address, timeout=POOL_TIMEOUT_S,
                       retry=RetryPolicy(max_attempts=1))
    caught = []

    def query():
        try:
            one.execute_computations(sink, job_name="fail-mid",
                                     fetch_results=False)
            caught.append(None)
        except Exception as e:  # noqa: BLE001 — judged below
            caught.append(e)

    procs[victim].send_signal(signal.SIGSTOP)
    th = threading.Thread(target=query, daemon=True)
    th.start()
    time.sleep(0.5)
    procs[victim].kill()
    procs[victim].wait(30)
    th.join(POOL_TIMEOUT_S)
    one.close()
    if th.is_alive() or not caught:
        raise RuntimeError("the query over a killed worker did not return")
    err = caught[0]
    if not isinstance(err, (ShardUnavailableError, PlacementStaleError)) \
            or not err.retryable:
        raise RuntimeError(f"killed worker: expected the typed retryable "
                           f"refusal, got {type(err).__name__}: {err}")
    if _scale_rows(pool_c, "d", "fail_out") != before:
        raise RuntimeError("a partial result replaced the output set")
    # an append while the worker is away: its slot's share buffers
    pool_c.send_table("d", "fail_li", extra, append=True)
    solo.send_table("d", "fail_li", extra, append=True)
    pending = pool_c.health()["pool"]["degraded"]
    if vaddr not in pending:
        raise RuntimeError(f"the killed worker is not degraded: {pending}")
    procs[victim] = _pool_popen(roots[victim], device,
                                s["page_bytes"], [], ports[victim],
                                logs[victim])
    _daemon_addr(procs[victim], logs[victim])
    vc = RemoteClient(vaddr, timeout=POOL_TIMEOUT_S)
    vc.create_database("d")
    vc.load_set("d", "fail_li")
    vc.close()
    deadline = time.perf_counter() + POOL_READMIT_S
    while vaddr in pool_c.health()["pool"]["degraded"]:
        if time.perf_counter() > deadline:
            raise RuntimeError(f"worker {vaddr} was not readmitted in "
                               f"{POOL_READMIT_S} s")
        time.sleep(0.5)
    pool_c.execute_computations(sink, job_name="fail-after",
                                fetch_results=False)
    solo.execute_computations(sink, job_name="fail-solo",
                              fetch_results=False)
    got = _scale_rows(pool_c, "d", "fail_out")
    want = _scale_rows(solo, "d", "fail_out")
    if got != want:
        raise RuntimeError(f"after readmission {got} != solo {want}")
    out = {"error": type(err).__name__, "retryable": True,
           "partial_result": False, "readmitted": True,
           "equal_after": True, "wall_s": time.perf_counter() - t0}
    print(f"[pool] worker {vaddr} killed mid-scatter: "
          f"{type(err).__name__} (retryable), the output unchanged; an "
          f"append buffered, the worker restarted, reloaded and readmitted; "
          f"the query equals solo again ({out['wall_s']:.1f} s) ({card})")
    return out


def _pool_inprocess(s, device, card) -> dict:
    """A leader and one worker in this process on the card, plus a solo
    daemon, all with the same set names: the scale-out Q01 and the
    shuffle join at ``rows`` rows, each request held to the solo's, the
    graph captures and replays counted."""
    import numpy as np
    import tempfile

    import torch

    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)
    from netsdb_tpu_torch.plan import programs
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.server import ServeController
    from netsdb_tpu_torch.workloads.serve_bench import (_scale_rows,
                                                        scaleout_join_sink,
                                                        scaleout_q01_sink,
                                                        scaleout_table)

    root = tempfile.mkdtemp(prefix="netsdb_inproc_pool_")
    cfg = dict(page_size_bytes=65_536 * 4)
    daemons = []
    clients = []
    k0 = (flash_attention.launches, flash_attention_step.launches)
    try:
        w = ServeController(Configuration(root_dir=f"{root}/w", **cfg),
                            port=0, device=device)
        w.start()
        daemons.append(w)
        lead = ServeController(Configuration(root_dir=f"{root}/l", **cfg),
                               port=0, device=device,
                               workers=[w.advertise_addr],
                               heartbeat_interval_s=60.0)
        lead.start()
        daemons.append(lead)
        solo = ServeController(Configuration(root_dir=f"{root}/s", **cfg),
                               port=0, device=device)
        solo.start()
        daemons.append(solo)
        pc = RemoteClient(lead.advertise_addr, timeout=POOL_TIMEOUT_S)
        sc = RemoteClient(solo.advertise_addr, timeout=POOL_TIMEOUT_S)
        clients += [pc, sc]
        table = scaleout_table(s["rows"], seed=31)
        rng = np.random.default_rng(32)
        jli = ColumnTable({
            "l_orderkey": torch.from_numpy(rng.integers(
                0, 2048, s["rows"], dtype=np.int32)),
            "l_price": torch.from_numpy(rng.integers(
                1, 1000, s["rows"], dtype=np.int32))}, {}, None)
        jord = ColumnTable({"o_orderkey": torch.arange(2048,
                                                       dtype=torch.int32)},
                           {}, None)
        for c, rk, hk in ((pc, {"placement": "range"},
                           {"placement": "hash"}), (sc, {}, {})):
            c.create_database("d")
            c.create_set("d", "lineitem", type_name="table",
                         storage="paged", **rk)
            c.send_table("d", "lineitem", table)
            c.create_set("d", "jli", type_name="table", **hk)
            c.create_set("d", "jorders", type_name="table", **hk)
            c.send_table("d", "jli", jli)
            c.send_table("d", "jorders", jord)
        p0 = programs.program_stats()
        for i in range(s["requests"]):
            for sink, out_set in ((scaleout_q01_sink("d"), "scale_q01_out"),
                                  (scaleout_join_sink(
                                      "d", 2048, lineitem_set="jli",
                                      orders_set="jorders"),
                                   "scale_join_out")):
                rows = []
                for c in (pc, sc):
                    c.execute_computations(sink, job_name=f"ip-{out_set}",
                                           fetch_results=False)
                    rows.append(_scale_rows(c, "d", out_set))
                if rows[0] != rows[1]:
                    raise RuntimeError(f"in-process pool request {i} "
                                       f"{out_set} differs from solo")
        p1 = programs.program_stats()
        launches = (flash_attention.launches - k0[0],
                    flash_attention_step.launches - k0[1])
        out = {"rows": s["rows"], "requests": s["requests"],
               "captures": p1["captures"] - p0["captures"],
               "replays": p1["replays"] - p0["replays"],
               "launches": launches}
        if device == "cuda" and out["replays"] == 0:
            raise RuntimeError("the in-process pool replayed no graph")
        if any(launches):
            raise RuntimeError(f"the in-process pool launched a "
                               f"hand-written kernel: {launches}")
        print(f"[pool] in-process leader + worker + solo on {device} with "
              f"the same set names: Q01 and the shuffle join at "
              f"{s['rows']} rows, {s['requests']} requests each equal to "
              f"solo; captures {out['captures']}, replays {out['replays']}; "
              f"B1/B2 launches {launches} ({card})")
        return out
    finally:
        for c in clients:
            c.close()
        for d in daemons:
            d.shutdown()


def phase_pool(pk: dict, smi: str, device: str = "cuda",
               sizes: Optional[dict] = None) -> dict:
    """Phase 17: a pool of a leader and 3 workers, each in its own process
    on the card, and a solo daemon, this script their client
    (``POOL_SIZES``): the serving gate, FF at bench.py's width, routed
    ingest and scatter-gather with the shuffle join, a killed and
    readmitted worker, then an in-process pool."""
    import os
    import shutil
    import tempfile

    import torch

    from netsdb_tpu_torch.serve.client import RemoteClient

    del pk
    s = {k: dict(v, **((sizes or {}).get(k, {})))
         for k, v in POOL_SIZES.items()}
    # 65 536-row pages of the scale-out table's five int32 columns (the
    # port packs a row's columns into one page; serve_bench.py:836 sizes
    # its pages by one column)
    page_bytes = s["scaleout"]["page_rows"] * 4 * 5
    s["failure"]["page_bytes"] = page_bytes
    card = smi
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="netsdb_pool_")
    n = POOL_DAEMONS
    roots = [os.path.join(root, f"d{i}") for i in range(n + 1)]
    logs = [os.path.join(root, f"d{i}.log") for i in range(n + 1)]
    # slot 0 is the leader, 1..3 the workers, n the solo daemon
    procs = [None] * (n + 1)
    clients = []
    try:
        for i in range(1, n + 1):
            procs[i] = _pool_popen(roots[i], device, page_bytes, [], 0,
                                   logs[i])
        addrs = {i: _daemon_addr(procs[i], logs[i])
                 for i in range(1, n + 1)}
        workers = [addrs[i] for i in range(1, n)]
        procs[0] = _pool_popen(roots[0], device, page_bytes, workers, 0,
                               logs[0])
        addrs[0] = _daemon_addr(procs[0], logs[0])
        ports = [int(addrs[i].rpartition(":")[2]) for i in range(n + 1)]
        print(f"[pool] leader {addrs[0]}, workers {workers}, solo "
              f"{addrs[n]}: {time.perf_counter() - t0:.1f} s to listen "
              f"({card})")
        pool_c = RemoteClient(addrs[0], timeout=POOL_TIMEOUT_S,
                              connect_timeout=30.0)
        solo = RemoteClient(addrs[n], timeout=POOL_TIMEOUT_S,
                            connect_timeout=30.0)
        clients += [pool_c, solo]
        daemon_clients = [RemoteClient(addrs[i], timeout=POOL_TIMEOUT_S)
                          for i in range(n)]
        clients += daemon_clients
        k_start = [c.collect_stats()["metrics"]["kernels"]
                   for c in daemon_clients + [solo]]
        out = {"serving": _pool_serving(addrs[0], solo, s["serving"], card),
               "bench_ff": _pool_bench_ff(addrs[0], solo, s["bench_ff"],
                                          device, card),
               "scaleout": _pool_scaleout(pool_c, solo, daemon_clients,
                                          s["scaleout"], card)}
        stats = [c.collect_stats() for c in daemon_clients + [solo]]
        launches = {}
        for st, k0 in zip(stats, k_start):
            for k, v in st["metrics"]["kernels"].items():
                launches[k] = launches.get(k, 0) + v - k0.get(k, 0)
        out["launches"] = launches
        out["daemons"] = [{
            "role": ("leader" if i == 0 else "solo" if i == n
                     else f"worker {i}"),
            "pid": st["serve"]["pid"], "busy_s": st["serve"]["busy_s"],
            "max_memory_reserved_mib":
                st["serve"].get("max_memory_reserved", 0) / 2 ** 20}
            for i, st in enumerate(stats)]
        out["card_memory"] = (_card_memory() if device == "cuda"
                              else "not measured")
        if len({d["pid"] for d in out["daemons"]} | {os.getpid()}) \
                != n + 2:
            raise RuntimeError("the pool's daemons did not run in their "
                               "own processes")
        for d in out["daemons"]:
            print(f"[pool] {d['role']} pid {d['pid']}: busy "
                  f"{d['busy_s']:.2f} s, peak reserved "
                  f"{d['max_memory_reserved_mib']:.0f} MiB ({card})")
        print(f"[pool] card memory used, total: {out['card_memory']}; "
              f"daemon kernel launches {launches} ({card})")
        if any(launches.values()):
            raise RuntimeError(f"the pool paths launched a hand-written "
                               f"kernel: {launches}")
        for c in daemon_clients:
            c.close()
        out["failure"] = _pool_failure(pool_c, solo, procs, n - 1, roots,
                                       ports, device, logs, s["failure"],
                                       card)
        out["inproc"] = _pool_inprocess(s["inproc"], device, card)
        out["wall_s"] = time.perf_counter() - t0
        print(f"[pool] phase 17 wall {out['wall_s']:.1f} s ({card})")
        if out["wall_s"] > POOL_BUDGET_S:
            print(f"[pool] WARNING: phase 17 took {out['wall_s']:.1f} s, "
                  f"over its {POOL_BUDGET_S} s budget")
        return out
    except BaseException:
        import signal

        for i, proc in enumerate(procs):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGUSR1)
        time.sleep(1.0)
        for i, log in enumerate(logs):
            try:
                with open(log) as f:
                    print(f"[pool] daemon {i} log:\n" + f.read()[-6000:])
            except OSError:
                pass
        raise
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — the kills below stop them
                pass
        for proc in procs:
            if proc is None:
                continue
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
        shutil.rmtree(root, ignore_errors=True)


# --- phase 18 ------------------------------------------------------------
MESH_POSITIONS = 4       # the reference's mesh4, virtual positions of card 0
MESH_COLL = dict(m=16384, k=1024, n=4096)   # bench.py's first FF layer
MESH_ULYSSES = dict(batch=2, seq=16384, heads=8, dim=128)  # phase 5's shape
MESH_ULYSSES_CALLS = 3
MESH_SUMMA = dict(rows=65_536, k=512, cols=256, row_block=4096,
                  table_rows=200_000)       # micro_bench.bench_summa
MESH_TOPK = dict(n=60_000_000, k=10)        # phase 15's top-k scores
MESH_REL_RTOL, MESH_REL_ATOL = 1e-5, 1e-3   # tests/test_placement_api.py
MESH_FF_RTOL = 1e-5      # distributed FF vs the one-position request ...
MESH_FF_ATOL = 1e-7      # ... with this floor for probabilities near 0
MESH_SUMMA_HEADROOM = 1.35  # tests/test_summa.py: padding over 1/N


def _mesh_ints(gen, shape, device="cuda"):
    """Integer-valued f32 in [-8, 8): every product and partial sum here
    is exact in f32, so any summation order gives the same bytes."""
    import torch

    return torch.randint(-8, 8, shape, generator=gen, device=device,
                         dtype=torch.int32).to(torch.float32)


def _mesh_collectives(mesh, gen, card) -> dict:
    """The four collectives at bench.py's first FF layer, each byte-equal
    to one product (or the unsharded tensor) on one position."""
    import torch

    from netsdb_tpu_torch.ops.common import full_f32_precision
    from netsdb_tpu_torch.parallel import collectives as C

    s = MESH_COLL
    a = _mesh_ints(gen, (s["m"], s["k"]))
    b = _mesh_ints(gen, (s["k"], s["n"]))
    full_f32_precision()
    want = torch.matmul(a, b)
    one_ms = time_ms(lambda: torch.matmul(a, b), iters=5, warmup=1)
    out = {"one_position_ms": one_ms}
    runs = {
        "matmul_psum": (lambda: C.matmul_psum(a, b, mesh, "data"), want),
        "matmul_psum_scatter": (
            lambda: C.matmul_psum_scatter(a, b, mesh, "data"), want),
        "matmul_allgather": (
            lambda: C.matmul_allgather(a, b, mesh, "data"), want),
        "all_to_all_resharding": (
            lambda: C.all_to_all_resharding(a, mesh, "data", 0, 1), a)}
    for name, (run, ref) in runs.items():
        got = run().to_dense()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise RuntimeError(f"[mesh] {name}: {bad} entries differ from "
                               f"one position")
        ms = time_ms(run, iters=5, warmup=1)
        out[name] = ms
        print(f"[mesh] {name} {s['m']}x{s['k']}x{s['n']}: byte-equal, "
              f"{ms:.3f} ms (one torch.matmul {one_ms:.3f} ms) | {card}")
    return out


def _mesh_ulysses(mesh, card, pk) -> tuple:
    """Ulysses at phase 5's SP shape in f32 and bf16: the main path's
    calls (B1 launched once per position), then held to one B1 call over
    the whole (B, H, S, D), f32 to f64 head by head, and timed beside the
    ring (B2) at the same shape. Returns the results and the two
    kernels' launches on the main path."""
    import torch

    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)
    from netsdb_tpu_torch.parallel.ring import (ring_attention,
                                                ulysses_attention)

    s = MESH_ULYSSES
    b, h, sq, d = s["batch"], s["heads"], s["seq"], s["dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    out, launches = {}, [0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v = (torch.randn((b, h, sq, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
        # the main path: counted launches
        b1, b2 = flash_attention.launches, flash_attention_step.launches
        ys, times = [], []
        for _ in range(MESH_ULYSSES_CALLS):
            y, ms = _timed(lambda: ulysses_attention(q, k, v, mesh, "data"),
                           "cuda")
            ys.append(y)
            times.append(ms)
        got_b1 = flash_attention.launches - b1
        got_b2 = flash_attention_step.launches - b2
        launches[0] += got_b1
        launches[1] += got_b2
        if got_b1 != MESH_POSITIONS * MESH_ULYSSES_CALLS or got_b2:
            raise RuntimeError(
                f"[mesh] Ulysses {dname}: B1 {got_b1} launches (want "
                f"{MESH_POSITIONS} a call), B2 {got_b2}")
        saved = (flash_attention.launches, flash_attention_step.launches)
        dense = ys[-1].to_dense()
        one = flash_attention(q, k, v, causal=True)
        one_ms = time_ms(lambda: flash_attention(q, k, v, causal=True),
                         iters=3, warmup=1)
        diff = (dense.float() - one.float()).abs().max().item()
        equal = torch.equal(dense, one)
        row = {"ms": min(times), "one_call_ms": one_ms,
               "byte_equal_one_call": equal, "max_abs_vs_one_call": diff,
               "bound_ms": attention_bound_ms(b, h, sq, d, True, dname,
                                              pk)[0]}
        if not torch.isfinite(dense).all():
            raise RuntimeError(f"[mesh] Ulysses {dname}: non-finite output")
        if dtype == torch.float32:
            if not diff <= F32_TOL:
                raise RuntimeError(f"[mesh] Ulysses f32 vs one B1 call: "
                                   f"{diff}")
            pos = torch.arange(sq, device="cuda")
            worst = 0.0
            for bi in range(b):
                for hi in range(h):
                    for r0 in range(0, sq, 4096):
                        ex = attention_f64(
                            q[bi, hi][None, r0:r0 + 4096], k[bi, hi][None],
                            v[bi, hi][None], pos[r0:r0 + 4096], pos, True,
                            d ** -0.5)[0]
                        worst = max(worst, (dense[bi, hi, r0:r0 + 4096]
                                            .double() - ex).abs().max()
                                    .item())
            row["f64_err"] = worst
            if not worst <= SP_TOL:
                raise RuntimeError(f"[mesh] Ulysses f32 vs f64: {worst} > "
                                   f"{SP_TOL}")
            ring_ms = time_ms(lambda: ring_attention(
                q, k, v, mesh, "data", impl="flash"), iters=2, warmup=1)
            row["ring_ms"] = ring_ms
        elif not diff <= BF16_TOL:
            raise RuntimeError(f"[mesh] Ulysses bf16 vs one B1 call: {diff}")
        flash_attention.launches, flash_attention_step.launches = saved
        out[dname] = row
        print(f"[mesh] Ulysses {dname} ({b}, {h}, {sq}, {d}) causal: "
              f"{row['ms']:.3f} ms, {MESH_POSITIONS} B1 launches a call; one "
              f"B1 call {one_ms:.3f} ms, byte-equal {equal} (max abs "
              f"{diff:.3e}); f64 err {row.get('f64_err', 'n/a')}; ring (B2) "
              f"{row.get('ring_ms', 'n/a')} ms; bound "
              f"{row['bound_ms']:.3f} ms | {card}")
        del q, k, v, ys, dense, one
    return out, tuple(launches)


def _mesh_summa(root, devices, card) -> dict:
    """(a) micro_bench.bench_summa's gate: M 65 536 x 512 paged, rhs 512 x
    256, integer-valued; 1-d over the positions and the 2x2 grid, each
    byte-equal to the single-position stream, staged bytes a position
    about 1/4 of the replicated arm's, a warm rerun reading no page."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel import summa as S
    from netsdb_tpu_torch.storage.devcache import DeviceBlockCache
    from netsdb_tpu_torch.storage.paged import PagedTensorStore

    s = MESH_SUMMA
    rng = np.random.default_rng(SEED + 19)
    m = rng.integers(-8, 8, (s["rows"], s["k"])).astype(np.float32)
    rhs = torch.from_numpy(rng.integers(-8, 8, (s["k"], s["cols"])).astype(
        np.float32)).cuda()
    pts = PagedTensorStore(Configuration(root_dir=root,
                                         page_size_bytes=16 << 20))
    try:
        pts.put("m", m, row_block=s["row_block"])
        base, base_ms = _timed(lambda: pts.matmul_streamed("m", rhs), "cuda")
        replicated = m.nbytes + rhs.numel() * 4  # every position stages all
        out = {"stream_ms": base_ms, "replicated_bytes": replicated}
        cache = DeviceBlockCache(1 << 30, partial=True)
        for label, run in (
                ("1d", lambda **kw: S.summa_matmul_streamed(
                    pts, "m", rhs, devices=devices, **kw)),
                ("2x2", lambda **kw: S.summa_grid_matmul_streamed(
                    pts, "m", rhs, devices=devices, grid=(2, 2), **kw))):
            stats = {}
            got, ms = _timed(lambda: run(stats_out=stats), "cuda")
            if not torch.equal(got, base):
                raise RuntimeError(f"[mesh] SUMMA {label} is not byte-equal "
                                   f"to the single-position stream")
            per = stats["staged_bytes_per_participant"]
            frac = max(per.values()) / replicated
            if frac > MESH_SUMMA_HEADROOM / MESH_POSITIONS:
                raise RuntimeError(f"[mesh] SUMMA {label}: a position "
                                   f"staged {frac:.3f} of the replicated arm")
            run(cache=cache, cache_scope=f"summa-{label}")  # cold: installs
            reads0 = pts.stats()["page_reads"]
            warm, warm_ms = _timed(lambda: run(
                cache=cache, cache_scope=f"summa-{label}"), "cuda")
            reads = pts.stats()["page_reads"] - reads0
            if reads or not torch.equal(warm, base):
                raise RuntimeError(f"[mesh] SUMMA {label} warm: {reads} "
                                   f"pages read")
            out[label] = {"ms": ms, "warm_ms": warm_ms, "rounds":
                          stats["rounds"], "staged_fraction": frac,
                          "warm_page_reads": reads}
            print(f"[mesh] SUMMA {label} {s['rows']}x{s['k']}x{s['cols']}: "
                  f"byte-equal, {ms:.3f} ms cold, {warm_ms:.3f} ms warm "
                  f"({reads} pages), stream {base_ms:.3f} ms, a position "
                  f"staged {frac:.4f} of the replicated arm's {replicated} "
                  f"B | {card}")
        return out
    finally:
        pts.close()


def _mesh_ff(root, card) -> dict:
    """(b) FF at bench.py's width with w1 and wo paged in phase 7's pages,
    ``distributed_matmul=True``: every paged node through SUMMA (the
    rounds counted), held to f64 and to the same request on one
    position."""
    import math

    import numpy as np
    import torch

    from netsdb_tpu_torch import Client, obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel

    features, hidden, labels, batch = 1024, 4096, 1024, 16384
    x = np.random.default_rng(SEED + 20).standard_normal(
        (batch, features), dtype=np.float32)
    clients = {}
    for tag, kw in (("dist", dict(distributed_matmul=True,
                                  summa_participants=MESH_POSITIONS)),
                    ("one", {})):
        c = Client(Configuration(root_dir=f"{root}/{tag}",
                                 page_size_bytes=PAGE_BYTES,
                                 page_pool_bytes=POOL_BYTES, **kw))
        m = FFModel(db="ff_mesh", block=(512, 512))
        m.setup(c, storages={"w1": "paged", "wo": "paged"})
        m.load_random_weights(c, features, hidden, labels, seed=SEED)
        m.load_inputs(c, x)
        clients[tag] = (c, m)
    ref = FFModel(db="ff_mesh_ref", block=(512, 512))
    c_one = clients["one"][0]
    ref.setup(c_one)
    ref.load_random_weights(c_one, features, hidden, labels, seed=SEED)
    p = ref.params_from_store(c_one)
    w1, b1, wo, bo = (t.to_dense().double() for t in (p.w1, p.b1, p.wo,
                                                      p.bo))
    xd = torch.as_tensor(x, device="cuda").double()
    exact = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1) + bo, dim=0)
    c, m = clients["dist"]
    ps = c.store.page_store()
    from netsdb_tpu_torch.storage.store import SetIdentifier

    want_rounds = 0
    for s in ("w1", "wo"):
        pm = next(i for i in c.store.get_items(SetIdentifier("ff_mesh", s))
                  if type(i).__name__ == "_PagedMatrix")
        want_rounds += math.ceil(ps.num_blocks(pm.name) / MESH_POSITIONS)
    out = {}
    for tag in ("dist", "one"):
        cc, mm = clients[tag]
        r0 = obs.REGISTRY.counter("summa.rounds").value
        first, _ = _timed(lambda: mm.inference(cc).to_dense(), "cuda")
        got, ms = _timed(lambda: mm.inference(cc).to_dense(), "cuda")
        rounds = obs.REGISTRY.counter("summa.rounds").value - r0
        if tag == "dist" and rounds != 2 * want_rounds:
            raise RuntimeError(f"[mesh] distributed FF: {rounds} SUMMA "
                               f"rounds over two requests, want "
                               f"{2 * want_rounds} (every paged node)")
        err = (got.double() - exact).abs().max().item()
        if not err <= FF_TOL:
            raise RuntimeError(f"[mesh] FF {tag}: {err} against f64")
        out[tag] = {"ms": ms, "f64_err": err, "rounds": rounds,
                    "out": got}
    rel = ((out["dist"]["out"] - out["one"]["out"]).abs()
           - MESH_FF_RTOL * out["one"]["out"].abs()).max().item()
    if not rel <= MESH_FF_ATOL:
        raise RuntimeError(f"[mesh] distributed FF vs one position: "
                           f"{rel} over rtol {MESH_FF_RTOL}")
    for tag in out:
        del out[tag]["out"]
    print(f"[mesh] FF paged 16384x1024->4096->1024 with distributed_matmul: "
          f"{out['dist']['ms']:.3f} ms ({out['dist']['rounds']} SUMMA "
          f"rounds in 2 requests, f64 err {out['dist']['f64_err']:.3e}); "
          f"one position {out['one']['ms']:.3f} ms | {card}")
    out["clients"] = clients
    return out


def _mesh_reshard(root, ff, devices, card) -> dict:
    """(4) A warm placed two-column table (200 000 rows, paged) sharded →
    replicated through ``reshard_set`` against dropping its cache and
    re-staging it; the FF weight set 1-d → 2x2 → 1-d through
    ``reshard_summa_layout``. Each move reads no arena page and keeps the
    values."""
    import contextlib

    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement, gather_table
    from netsdb_tpu_torch.parallel.reshard import (reshard_set,
                                                   reshard_summa_layout)
    from netsdb_tpu_torch.parallel.summa import (summa_grid_matmul_streamed,
                                                 summa_matmul_streamed)
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.storage.store import SetIdentifier

    src = Placement.data_parallel(ndim=1, n_devices=MESH_POSITIONS)
    dst = Placement.replicated(ndim=1, n_devices=MESH_POSITIONS)
    rng = np.random.default_rng(SEED + 21)
    n = MESH_SUMMA["table_rows"]
    cols = {"k": rng.integers(0, 1000, n).astype(np.int32),
            "v": rng.integers(-8, 8, n).astype(np.float32)}
    c = Client(Configuration(root_dir=f"{root}/table",
                             page_size_bytes=64 << 10))
    c.create_database("d")
    c.create_set("d", "t", type_name="table", storage="paged",
                 placement=src)
    c.send_table("d", "t", ColumnTable.from_columns(cols, device="cpu"))
    ident = SetIdentifier("d", "t")
    pc = next(i for i in c.store.get_items(ident)
              if isinstance(i, PagedColumns))

    def consume(placement):
        total = None
        with contextlib.closing(pc.stream_tables(placement=placement)) as st:
            for t in st:
                g = gather_table(t)
                s = torch.where(g.mask(), g["v"], 0.0).sum()
                total = s if total is None else total + s
        return float(total)

    before = consume(src)  # cold: installs the sharded layout's blocks
    pages0 = pc.pages_streamed
    rep, ms = _timed(lambda: reshard_set(c.store, ident, dst), "cuda")
    after = consume(dst)
    moved_pages = pc.pages_streamed - pages0
    if moved_pages or after != before or after != float(cols["v"].sum()):
        raise RuntimeError(f"[mesh] reshard_set: {moved_pages} pages read, "
                           f"sum {after} vs {before}")
    c.store.device_cache().invalidate(pc.cache_scope)
    restage, restage_ms = _timed(lambda: consume(dst), "cuda")
    out = {"table": {"steps": rep.labels(), "blocks": rep.blocks_moved,
                     "bytes": rep.bytes_moved, "ms": ms,
                     "restage_ms": restage_ms, "page_reads": moved_pages}}
    print(f"[mesh] reshard_set {n} rows sharded -> replicated: "
          f"{rep.labels()} {rep.blocks_moved} blocks {rep.bytes_moved} B in "
          f"{ms:.3f} ms, 0 pages read; re-staging instead "
          f"{restage_ms:.3f} ms | {card}")

    fc, fm = ff["clients"]["dist"]
    ident = SetIdentifier("ff_mesh", "w1")
    ps = fc.store.page_store()
    pm = next(i for i in fc.store.get_items(ident)
              if type(i).__name__ == "_PagedMatrix")
    x = fc.get_tensor("ff_mesh", "inputs").to_dense().t().contiguous()
    cache = fc.store.device_cache()
    base = fm.inference(fc).to_dense()
    reads0 = ps.stats()["page_reads"]
    pre = summa_matmul_streamed(ps, pm.name, x, devices=devices, cache=cache,
                                cache_scope=str(ident))
    rep1, ms1 = _timed(lambda: reshard_summa_layout(
        fc.store, ident, devices, devices, dst_grid=(2, 2)), "cuda")
    grid = summa_grid_matmul_streamed(ps, pm.name, x, devices=devices,
                                      grid=(2, 2), cache=cache,
                                      cache_scope=str(ident))
    rep2, ms2 = _timed(lambda: reshard_summa_layout(
        fc.store, ident, devices, devices, src_grid=(2, 2)), "cuda")
    back = fm.inference(fc).to_dense()
    reads = ps.stats()["page_reads"] - reads0
    # the grid sums the same kp-slices in the same order as the 1-d run,
    # over half the columns a product (cuBLAS may tile those otherwise)
    grid_err = (grid - pre).abs().max().item()
    if reads or not torch.equal(back, base) or not torch.allclose(
            grid, pre, rtol=1e-5, atol=1e-4):
        raise RuntimeError(f"[mesh] reshard_summa_layout: {reads} pages "
                           f"read, grid vs 1-d {grid_err}, or FF moved")
    out["summa_layout"] = {"to_grid": {"blocks": rep1.blocks_moved,
                                       "bytes": rep1.bytes_moved,
                                       "ms": ms1},
                           "to_1d": {"blocks": rep2.blocks_moved,
                                     "bytes": rep2.bytes_moved, "ms": ms2},
                           "page_reads": reads, "grid_vs_1d": grid_err}
    c.store.page_store().close()
    print(f"[mesh] reshard_summa_layout FF w1 1d -> 2x2 -> 1d: "
          f"{rep1.blocks_moved} + {rep2.blocks_moved} blocks, "
          f"{rep1.bytes_moved + rep2.bytes_moved} B, {ms1:.3f} + {ms2:.3f} "
          f"ms, 0 pages read, FF output unchanged, 2x2 product within "
          f"{grid_err:.3e} of the 1-d one | {card}")
    return out


def _mesh_placed_client(host, placement_of, device="cuda", cfg=None,
                        paged=()):
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.table import ColumnTable

    c = Client(cfg or Configuration(), device=device)
    c.create_database("tpch")
    for n, (cols, dicts) in host.items():
        if placement_of(n) is None:
            continue
        c.create_set("tpch", n, type_name="table", placement=placement_of(n),
                     storage="paged" if n in paged else "memory")
        c.send_table("tpch", n, ColumnTable.from_columns(cols, dicts,
                                                         device="cpu"))
    return c


def _mesh_hold(name, got, want) -> float:
    """Integers exactly, floats within rtol 1e-5 / atol 1e-3."""
    import numpy as np

    worst = 0.0
    for (label, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if a.shape != b.shape:
            raise RuntimeError(f"[mesh] {name}.{label}: {a.shape} vs "
                               f"{b.shape}")
        if b.dtype.kind in "biu":
            if not np.array_equal(a, b):
                raise RuntimeError(f"[mesh] {name}.{label}: integers differ")
            continue
        if not np.allclose(a, b, rtol=MESH_REL_RTOL, atol=MESH_REL_ATOL):
            raise RuntimeError(f"[mesh] {name}.{label}: beyond rtol "
                               f"{MESH_REL_RTOL} atol {MESH_REL_ATOL}")
        worst = max(worst, _rel_err(a, b))
    return worst


def _mesh_tpch(state, root, card) -> dict:
    """(5) The ten suite queries over placed SF 10 sets (lineitem, orders
    row-sharded over the positions, the rest replicated) against the
    one-position resident client; then a paged and placed lineitem (64 MiB
    pages, 1 GiB pool): Q01 and Q06 cold and warm."""
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.dag import FACT_TABLES
    from netsdb_tpu_torch.storage.store import SetIdentifier

    host, one = state["host"], state["card"]

    def placement_of(n):
        return (Placement.data_parallel(ndim=1, n_devices=MESH_POSITIONS)
                if n in FACT_TABLES
                else Placement.replicated(ndim=1, n_devices=MESH_POSITIONS))

    placed, ingest_ms = _timed(lambda: _mesh_placed_client(host,
                                                           placement_of),
                               "cuda")
    print(f"[mesh] placed SF {TPCH_SF} sets ingested in {ingest_ms:.1f} ms "
          f"| {card}")
    out = {"ingest_ms": ingest_ms, "queries": {}}
    for q in sorted(dag._QUERY_TABLES):
        want, one_ms = _timed(lambda: dag.run_query(
            one, dag.suite_sink_for(one, "tpch", q), job_name=f"m1-{q}"),
            "cuda")
        _, one_ms = _timed(lambda: dag.run_query(
            one, dag.suite_sink_for(one, "tpch", q), job_name=f"m1-{q}"),
            "cuda")
        sink = dag.suite_sink_for(placed, "tpch", q)
        _, first_ms = _timed(lambda: dag.run_query(placed, sink,
                                                   job_name=f"m4-{q}"),
                             "cuda")
        got, ms = _timed(lambda: dag.run_query(placed, sink,
                                               job_name=f"m4-{q}"), "cuda")
        err = _mesh_hold(q, got, want)
        out["queries"][q] = {"ms": ms, "first_ms": first_ms,
                             "one_position_ms": one_ms, "rel_err": err}
        print(f"[mesh] placed {q}: {ms:.3f} ms ({first_ms:.3f} first), one "
              f"position {one_ms:.3f} ms, max rel err {err:.3e} | {card}")

    cfg = Configuration(root_dir=f"{root}/paged",
                        page_size_bytes=PAGED_REL_PAGE_BYTES,
                        page_pool_bytes=PAGED_REL_POOL_BYTES,
                        device_cache_bytes=PAGED_REL_CACHE_BYTES)
    paged, pms = _timed(lambda: _mesh_placed_client(
        host, lambda n: placement_of(n) if n == "lineitem" else None,
        cfg=cfg, paged=("lineitem",)), "cuda")
    pc = paged.store.paged_relation(SetIdentifier("tpch", "lineitem"))
    out["paged"] = {"ingest_ms": pms}
    try:
        for q in ("q01", "q06"):
            sink = dag.suite_sink_for(paged, "tpch", q)
            want = dag.run_query(one, dag.suite_sink_for(one, "tpch", q),
                                 job_name=f"m1-{q}")
            rec = {}
            for kind in ("cold", "warm"):
                if kind == "cold":
                    paged.store.device_cache().invalidate(pc.cache_scope)
                p0 = pc.pages_streamed
                got, ms = _timed(lambda: dag.run_query(
                    paged, sink, job_name=f"mp-{q}"), "cuda")
                rec[kind] = {"ms": ms, "pages": pc.pages_streamed - p0,
                             "rel_err": _mesh_hold(f"paged {q}", got, want)}
            if rec["warm"]["pages"]:
                raise RuntimeError(f"[mesh] paged placed {q} warm read "
                                   f"{rec['warm']['pages']} pages")
            out["paged"][q] = rec
            print(f"[mesh] paged+placed {q}: cold {rec['cold']['ms']:.3f} ms "
                  f"({rec['cold']['pages']} pages), warm "
                  f"{rec['warm']['ms']:.3f} ms (0 pages), chunks sharded "
                  f"over {MESH_POSITIONS} | {card}")
    finally:
        paged.store.page_store().close()
        paged.store.device_cache().resize(0)  # its placed chunks
    return out, placed


def _mesh_shuffle(state, placed, mesh, card) -> dict:
    """(6) The row shuffle at SF 10: ``shuffle_q03`` and
    ``q03_row_sink_for`` against the resident Q03, ``Partition`` over the
    placed orders, ``distributed_top_k`` over 60 M scores against
    ``torch.topk``."""
    import torch

    from netsdb_tpu_torch.parallel.mesh import ShardedTensor
    from netsdb_tpu_torch.plan import computations as C
    from netsdb_tpu_torch.plan.executor import execute_computations
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational import shuffle as S
    from netsdb_tpu_torch.relational.queries import cq03

    one = state["card"]
    tables = {n: one.get_table("tpch", n)
              for n in ("customer", "orders", "lineitem")}
    want, one_ms = _timed(lambda: cq03(tables), "cuda")

    def same(name, got):
        if [r["okey"] for r in got] != [r["okey"] for r in want] or \
                [r["odate"] for r in got] != [r["odate"] for r in want]:
            raise RuntimeError(f"[mesh] {name}: rows differ from the "
                               f"resident Q03")
        err = max(abs(g["revenue"] - w["revenue"]) / abs(w["revenue"])
                  for g, w in zip(got, want))
        if not err <= MESH_REL_RTOL:
            raise RuntimeError(f"[mesh] {name}: revenues off by {err}")
        return err

    got, ms = _timed(lambda: S.shuffle_q03(tables, mesh), "cuda")
    out = {"shuffle_q03": {"ms": ms, "rel_err": same("shuffle_q03", got)},
           "resident_q03_ms": one_ms}
    sink = S.q03_row_sink_for(placed, "tpch")
    got, ms = _timed(lambda: dag.run_query(placed, sink), "cuda")
    out["q03_row_sink"] = {"ms": ms, "rel_err": same("q03_row_sink", got)}
    print(f"[mesh] shuffle_q03 {out['shuffle_q03']['ms']:.3f} ms, "
          f"q03_row_sink_for {ms:.3f} ms, resident Q03 {one_ms:.3f} ms: "
          f"same rows | {card}")

    part = C.WriteSet(C.Partition(C.ScanSet("tpch", "orders"), "o_orderkey",
                                  MESH_POSITIONS), "tpch", "orders_parts")
    rows, ms = _timed(lambda: next(iter(execute_computations(
        placed, [part], materialize=False).values())), "cuda")
    n = MESH_POSITIONS
    per = rows.rows_per_shard
    bad = 0
    for i in range(n):
        cols, valid = rows.local(i)
        bad += int(((torch.remainder(cols["o_orderkey"], n) != i)
                    & valid).sum())
    live = int(rows.valid.to_dense().sum())
    if int(rows.overflow) or bad or live != len(state["host"]["orders"][0][
            "o_orderkey"]):
        raise RuntimeError(f"[mesh] Partition: overflow {int(rows.overflow)}"
                           f", {bad} misplaced, {live} rows")
    out["partition"] = {"ms": ms, "overflow": 0, "rows_per_shard": per}
    print(f"[mesh] Partition(o_orderkey, {n}) over the placed orders: "
          f"{ms:.3f} ms, overflow 0, every key on shard key % {n} | {card}")

    s = MESH_TOPK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    # normal scores: the top ten of 60 M lie far apart (uniform f32 ones
    # would tie, and torch.topk orders ties as it likes)
    scores = torch.randn(s["n"], generator=gen, device="cuda")
    sharded = ShardedTensor.from_dense(scores, mesh, ("data",))
    (vals, keys, ok), ms = _timed(lambda: S.distributed_top_k(
        mesh, "data", sharded, s["k"]), "cuda")
    ref, ref_ms = _timed(lambda: torch.topk(scores, s["k"]), "cuda")
    per = s["n"] // n
    pos = torch.remainder(keys, n).long() * per + torch.div(
        keys, n, rounding_mode="floor").long()
    if not (torch.equal(vals, ref.values) and torch.equal(pos, ref.indices)
            and bool(ok.all())):
        raise RuntimeError("[mesh] distributed_top_k differs from "
                           "torch.topk")
    out["top_k"] = {"ms": ms, "torch_topk_ms": ref_ms}
    print(f"[mesh] distributed_top_k {s['n']} scores k {s['k']}: {ms:.3f} "
          f"ms, torch.topk {ref_ms:.3f} ms: same values and indices | "
          f"{card}")
    return out


def phase_mesh(pk: dict, smi: str, state: dict) -> tuple:
    """Phase 18: the in-process mesh on the card, inside
    ``virtual_devices(4, "cuda:0")``. Returns the results and the two
    kernels' launches on its main path (the comparisons' launches are not
    counted)."""
    import tempfile

    import torch

    from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from netsdb_tpu_torch.plan import programs
    from netsdb_tpu_torch.relational import sharded

    t0 = time.perf_counter()
    out = {}
    progs0 = programs.program_stats()
    fallbacks0 = len(programs.fallback_log())
    torch.cuda.reset_peak_memory_stats()
    with virtual_devices(MESH_POSITIONS, "cuda:0") as devs, \
            tempfile.TemporaryDirectory(prefix="netsdb_mesh_") as root:
        devices = list(devs)
        mesh = make_mesh((MESH_POSITIONS,), ("data",))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
        out["collectives"] = _mesh_collectives(mesh, gen, smi)
        _wl_free("cuda")
        out["ulysses"], launches = _mesh_ulysses(mesh, smi, pk)
        _wl_free("cuda")
        out["summa"] = _mesh_summa(f"{root}/summa", devices, smi)
        ff = _mesh_ff(f"{root}/ff", smi)
        out["reshard"] = _mesh_reshard(root, ff, devices, smi)
        for c, _m in ff.pop("clients").values():
            c.store.page_store().close()
        out["ff"] = ff
        _wl_free("cuda")
        out["tpch"], placed = _mesh_tpch(state, root, smi)
        _wl_free("cuda")
        out["shuffle"] = _mesh_shuffle(state, placed, mesh, smi)
        del placed
        _wl_free("cuda")
    progs = programs.program_stats()
    fallbacks = programs.fallback_log()[fallbacks0:]
    mesh_fallbacks = sharded.fallback_log()
    out["memory"] = {
        "peak_reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
        "card_used": subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "captures": progs["captures"] - progs0["captures"],
        "replays": progs["replays"] - progs0["replays"]}
    out["fallbacks"] = {"programs": fallbacks, "placed": mesh_fallbacks}
    print(f"[mesh] peak reserved {out['memory']['peak_reserved_mib']:.0f} "
          f"MiB, card used {out['memory']['card_used']}, programs captured "
          f"{out['memory']['captures']} replayed {out['memory']['replays']}"
          f" | {smi}")
    for f in fallbacks:
        print(f"[mesh] program fallback: {f}")
    for f in mesh_fallbacks:
        print(f"[mesh] placed-relation fallback: {f}")
    if mesh_fallbacks:
        raise RuntimeError(f"[mesh] placed requests fell back: "
                           f"{mesh_fallbacks}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[mesh] phase 18 took {out['seconds']:.1f} s | {smi}")
    return out, launches


def mesh_path(pk: dict, smi: str, state: dict) -> dict:
    """Phase 18 between launch counts set to 0 and read: Ulysses launches
    B1 once per position a call, B2 never."""
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    flash_attention.launches = flash_attention_step.launches = 0
    out, launches = phase_mesh(pk, smi, state)
    got = (flash_attention.launches, flash_attention_step.launches)
    print(f"[mesh] launches on this path: flash_attention {got[0]}, "
          f"flash_attention_step {got[1]}")
    if got != launches or got[0] == 0 or got[1] != 0:
        raise RuntimeError(f"[mesh] launches {got}: Ulysses must launch B1 "
                           f"and nothing B2 (counted {launches})")
    out["launches"] = {"flash_attention": got[0],
                       "flash_attention_step": got[1]}
    return out


# --- phase 19 ------------------------------------------------------------
# the rest of the mesh in one process, on 4 virtual positions of card 0:
# the pipeline at bench.py's FF hidden width (4 stages of d 4096, its
# 16384-row batch as 8 microbatches of 2048), expert-parallel MoE at phase
# 15's Switch-Base-128 widths (32 experts a position), the model families
# at phase 8's widths with the reference tests' placements, FF training at
# phase 9's size, the workloads at phase 15's sizes over row-sharded sets,
# and dryrun_multichip(4). Every request also runs on one position (sets
# unplaced, on the same card) and is held to it.
MC_POSITIONS = 4
MC_PIPELINE = dict(stages=4, d=4096, micro=8, rows=2048)
MC_PP_ATOL = 1e-4       # the pipeline against f64
MC_MOE_RTOL = 1e-5      # expert-parallel MoE against mesh=None
MC_DRYRUN_RTOL = 1e-5   # the dry run's sums against its one-position run
MC_DRYRUN_SP_RTOL = 1e-4  # ... the ring (B2) against one B1 call
_MC_GATHERS: dict = {}


def _mc_timed(run, device) -> tuple:
    """(output, ms) of a request after one untimed run of it: the first
    call of a shape pays for the library's and the allocator's first
    use (and the placed request runs before the one it is held to)."""
    run()
    return _timed(run, device)


def _mc_gathers(name, data_parallel: bool) -> list:
    """The gathers ``name`` logged (then the log is cleared); a
    data-parallel request must log none."""
    from netsdb_tpu_torch.parallel.mesh import clear_gather_log, gather_log

    log = gather_log()
    clear_gather_log()
    _MC_GATHERS[name] = log
    for e in log:
        print(f"[multichip] {name}: gather {e['op']} x{e['gathers']} "
              f"({e['bytes']} B): {e['reason']}")
    if data_parallel and log:
        raise RuntimeError(f"[multichip] the data-parallel request {name} "
                           f"gathered: {log}")
    return log


def _mc_row(out, name, ms, ms1, card, **extra) -> dict:
    row = {"ms": ms, "one_position_ms": ms1, **extra}
    out[name] = row
    more = "".join(f", {k} {v:.3e}" if isinstance(v, float) else
                   f", {k} {v}" for k, v in extra.items())
    print(f"[multichip] {name}: {ms:.3f} ms on {MC_POSITIONS} positions, "
          f"{ms1:.3f} ms on one{more} | {card}")
    return row


def _mc_hold(name, ok, detail) -> None:
    if not ok:
        raise RuntimeError(f"[multichip] {name}: {detail}")


def _mc_pipeline(out, root, card, pk, device) -> None:
    import torch

    from netsdb_tpu_torch.ops.common import full_f32_precision
    from netsdb_tpu_torch.parallel.mesh import make_mesh
    from netsdb_tpu_torch.parallel.pipeline import pipeline_apply

    s = MC_PIPELINE
    g = _wl_gen(device, 30)
    d = s["d"]
    params = {"w": torch.randn(s["stages"], d, d, generator=g,
                               device=device) * d ** -0.5,
              "b": torch.randn(s["stages"], d, generator=g,
                               device=device) * 0.1}
    xs = torch.randn(s["micro"], s["rows"], d, generator=g, device=device)

    def stage(p, x):
        full_f32_precision()
        return torch.tanh(torch.addmm(p["b"], x, p["w"]))

    def sequential():
        ys = xs
        for i in range(s["stages"]):
            p = {k: v[i] for k, v in params.items()}
            ys = torch.stack([stage(p, x) for x in ys])
        return ys

    mesh = make_mesh((MC_POSITIONS,), ("pp",))
    got, ms = _mc_timed(
        lambda: pipeline_apply(stage, params, xs, mesh, "pp"), device)
    want, ms1 = _mc_timed(sequential, device)
    same = all(torch.equal(t, want) for t in got.shards.flat)
    y64 = xs.double()
    for i in range(s["stages"]):
        y64 = torch.tanh(y64 @ params["w"][i].double()
                         + params["b"][i].double())
    err = (got.first().double() - y64).abs().max().item()
    flops = 2.0 * s["micro"] * s["rows"] * d * d * s["stages"]
    nbytes = 4.0 * (params["w"].numel() + 2 * xs.numel())
    bound = bounds_ms(flops, nbytes, "float32", pk)
    _mc_row(out, "pipeline", ms, ms1, card, byte_equal=same, f64_err=err,
            bound_ms=bound[0], bound_by=bound[1])
    _mc_hold("pipeline", same and err <= MC_PP_ATOL,
             f"byte-equal to the sequential loop {same}, f64 err {err}")
    _mc_gathers("pipeline", True)


def _mc_moe(out, root, card, pk, device) -> None:
    import torch

    moe = __import__("netsdb_tpu_torch.models.moe", fromlist=["x"])
    from netsdb_tpu_torch.parallel.mesh import make_mesh

    s = WL_SIZES["moe"]
    d, hd, ne, t = s["d"], s["hidden"], s["experts"], s["tokens"]
    g = _wl_gen(device, 8)
    params = moe.MoEParams(
        w_gate=torch.randn(d, ne, generator=g, device=device) * d ** -0.5,
        w_up=torch.randn(ne, d, hd, generator=g, device=device) * d ** -0.5,
        w_down=torch.randn(ne, hd, d, generator=g, device=device)
        * hd ** -0.5)
    x = torch.randn(t, d, generator=g, device=device)
    cf = s["capacity_factor"]
    mesh = make_mesh((MC_POSITIONS,), ("model",))
    ep, ms = _mc_timed(
        lambda: moe.moe_forward(params, x, cf, mesh, "model"), device)
    base, ms1 = _mc_timed(lambda: moe.moe_forward(params, x, cf), device)
    same = torch.equal(ep, base)
    rel = _rel(ep, base) if not same else 0.0
    p64 = moe.MoEParams(*(p.double() for p in (params.w_gate, params.w_up,
                                               params.w_down)))
    err = (ep.double() - moe.moe_forward(p64, x.double(), cf)).abs().max()
    dropped = int((~moe.route(params, x, cf).keep).sum())
    _mc_row(out, "moe expert-parallel", ms, ms1, card, byte_equal=same,
            rel_err=rel, f64_err=err.item(), dropped_tokens=dropped,
            experts_a_position=ne // MC_POSITIONS)
    _mc_hold("moe", rel <= MC_MOE_RTOL and err.item() <= WL_TOLS["moe_atol"],
             f"rel err to mesh=None {rel}, f64 err {err.item()}")
    _mc_gathers("moe", True)


def _mc_each(root, name, layouts, device):
    """(client, layout) for the placed request, then for the one-position
    one: each client made when its turn comes and held by the caller
    alone, so ``del`` frees it."""
    for tag, layout in zip(("placed", "one"), layouts):
        yield _wl_client(device, f"{root}/{name}-{tag}"), layout


def _mc_families(out, root, card, pk, device) -> None:
    import torch

    from netsdb_tpu_torch.models import LogRegModel, LSTMModel, Word2VecModel
    from netsdb_tpu_torch.parallel.placed_ops import dense
    from netsdb_tpu_torch.parallel.placement import Placement

    g = torch.Generator(device=device).manual_seed(SEED + 31)
    dp, rep = Placement.data_parallel(ndim=2), Placement.replicated()
    features, rows = MODEL_SIZES["logreg"].values()
    w = torch.randn(features, generator=g, device=device) * features ** -0.5
    x = torch.randn(rows, features, generator=g, device=device)
    ref = torch.sigmoid(x.double() @ w.double() + 0.1)[None, :]
    res = []
    for c, pl in _mc_each(root, "logreg", ({"inputs": dp}, None), device):
        m = LogRegModel(block=(512, 512))
        m.setup(c, placements=pl)
        m.load_weights(c, w, 0.1)
        m.load_inputs(c, x)
        res.append(_mc_timed(lambda m=m, c=c: m.inference(c), device))
    _mc_gathers("logreg", True)
    got, one = (dense(r[0]) for r in res)
    err = (got.double() - ref).abs().max().item()
    _mc_row(out, "logreg inputs data-parallel", res[0][1], res[1][1], card,
            f64_err=err, diff_to_one=(got - one).abs().max().item())
    _mc_hold("logreg", err <= MODEL_TOLS["logreg"], f"f64 err {err}")
    del x, res, got, one

    vocab, dim, n_ids, _segs, dag_rows = MODEL_SIZES["word2vec"].values()
    table = torch.randn(vocab, dim, generator=g, device=device)
    ids = torch.randint(0, vocab, (n_ids,), generator=g, device=device)
    rows64 = table.double()[ids]
    placed, one = (_wl_client(device, f"{root}/word2vec-{tag}")
                   for tag in ("placed", "one"))
    layouts = {"reference": {"weights": dp, "inputs": dp},
               "data-parallel": {"weights": rep, "inputs": dp}}
    solo = Word2VecModel(block=(512, 512))
    solo.setup(one)
    solo.load_embeddings(one, table)
    solo.load_onehot_inputs(one, ids[:dag_rows], vocab)
    want, ms1 = _mc_timed(lambda: solo.inference(one), device)
    for tag, pls in layouts.items():
        m = Word2VecModel(db=f"w2v_{tag[:3]}", block=(512, 512))
        m.setup(placed, placements=pls)
        m.load_embeddings(placed, table)
        m.load_onehot_inputs(placed, ids[:dag_rows], vocab)
        got, ms = _mc_timed(lambda m=m: m.inference(placed), device)
        _mc_gathers(f"word2vec one-hot DAG ({tag})", tag == "data-parallel")
        got = dense(got)
        err = (got.double() - rows64[:dag_rows]).abs().max().item()
        _mc_row(out, f"word2vec one-hot DAG ({tag})", ms, ms1, card,
                f64_err=err, equal_to_one=torch.equal(got, dense(want)))
        _mc_hold("word2vec", err <= MODEL_TOLS["word2vec"], f"f64 err {err}")
        if tag == "reference":
            look, ms = _mc_timed(lambda m=m: m.lookup(placed, ids), device)
            _mc_gathers("word2vec lookup (rows sharded)", True)
            _, ms1l = _mc_timed(lambda: solo.lookup(one, ids), device)
            err = (look.double() - rows64).abs().max().item()
            _mc_row(out, "word2vec lookup (rows sharded)", ms, ms1l, card,
                    f64_err=err)
            _mc_hold("word2vec lookup", err == 0.0, f"f64 err {err}")
    del placed, one, table, rows64, want

    hidden, inp, batch, _steps, lblock = MODEL_SIZES["lstm"].values()
    lw = {}
    for gate in "ifco":
        lw[f"w_{gate}"] = torch.randn(hidden, inp, generator=g,
                                      device=device) * inp ** -0.5
        lw[f"u_{gate}"] = torch.randn(hidden, hidden, generator=g,
                                      device=device) * hidden ** -0.5
        lw[f"b_{gate}"] = torch.randn(hidden, generator=g,
                                      device=device) * 0.1
    h0 = torch.randn(hidden, batch, generator=g, device=device) * 0.5
    c0 = torch.randn(hidden, batch, generator=g, device=device) * 0.5
    x0 = torch.randn(inp, batch, generator=g, device=device)
    ref = lstm_f64(lw, h0, c0, x0[None])
    cols = Placement((("data", 0),), (None, "data"))
    pls = {f"w_{gate}": dp for gate in "ifco"}
    pls.update({"h": cols, "c": cols})
    res = []
    for c, pl in _mc_each(root, "lstm", (pls, None), device):
        m = LSTMModel(block=(lblock, lblock))
        m.setup(c, placements=pl)
        m.load_weights(c, lw)
        m.load_state(c, h0, c0)
        res.append(_mc_timed(lambda m=m, c=c: m.step(c, x0), device))
        if pl is not None:
            _mc_gathers("lstm step (reference placements)", False)
    (hp, cp), (hs, cs) = ([dense(t) for t in r[0]] for r in res)
    err = max((hp.double() - ref[0]).abs().max().item(),
              (cp.double() - ref[1]).abs().max().item())
    diff = max((hp - hs).abs().max().item(), (cp - cs).abs().max().item())
    _mc_row(out, "lstm step (reference placements)", res[0][1], res[1][1],
            card, f64_err=err, diff_to_one=diff)
    _mc_hold("lstm", err <= MODEL_TOLS["lstm"] and diff <= MODEL_TOLS["lstm"],
             f"f64 err {err}, diff to one position {diff}")


def _mc_whole(params):
    """Placed params as plain BlockedTensors (a replicated value's first
    shard: nothing moves)."""
    import dataclasses

    from netsdb_tpu_torch.parallel import placed_ops

    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).with_data(placed_ops.whole(
            getattr(params, f.name).data, "check"))
        for f in dataclasses.fields(params)})


def _mc_train(out, root, card, pk, device) -> None:
    import torch
    import torch.nn.functional as F

    from netsdb_tpu_torch.models import FFModel
    from netsdb_tpu_torch.parallel.placement import Placement

    batch, features, hidden, labels = TRAIN_SIZES["ff"].values()
    g = torch.Generator(device=device).manual_seed(SEED + 32)
    x = torch.randn(batch, features, generator=g, device=device)
    onehot = F.one_hot(torch.randint(0, labels, (batch,), generator=g,
                                     device=device), labels).T.float()
    rep = Placement.replicated()
    cols = Placement((("data", 0),), (None, "data"))
    layouts = ({"inputs": Placement.data_parallel(ndim=2), "w1": rep,
                "b1": rep, "wo": rep, "bo": rep, "labels": cols}, None)
    runs = []
    for c, pls in _mc_each(root, "train", layouts, device):
        m = FFModel(db="ff_mc", block=(512, 512))
        m.setup(c, placements=pls)
        m.load_random_weights(c, features, hidden, labels, seed=SEED)
        m.load_inputs(c, x)
        c.create_set(m.db, "labels", placement=(pls or {}).get("labels"))
        c.send_matrix(m.db, "labels", onehot, (512, 512))
        p = m.params_from_store(c)
        args = (c.get_tensor(m.db, "inputs"), c.get_tensor(m.db, "labels"))
        steps = []
        for step in range(TRAIN_STEPS):
            (new, loss), ms = _mc_timed(
                lambda p=p: m.train_step(p, *args, lr=0.1), device)
            rec = check_step(f"ff {'placed' if pls else 'one position'}",
                             step, ms, _mc_whole(p), _mc_whole(new), loss,
                             0.1, ff_loss64, x.double(), onehot.double())
            if pls:
                for f in ("w1", "b1", "wo", "bo"):
                    d = getattr(new, f).data
                    _mc_hold("ff training replicas", all(
                        torch.equal(t, d.first()) for t in d.shards.flat),
                        f"{f}'s replicas differ after step {step}")
            steps.append((rec, _mc_whole(new)))
            p = new
        if pls:
            _mc_gathers("ff train_step (data-parallel)", True)
        runs.append(steps)
    for step, ((a, pa), (b, pb)) in enumerate(zip(*runs)):
        loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        diff = max((getattr(pa, f).data - getattr(pb, f).data).abs().max()
                   .item() for f in ("w1", "b1", "wo", "bo"))
        limit = max(a[f]["limit"] for f in ("w1", "b1", "wo", "bo"))
        _mc_row(out, f"ff train_step {step} (data-parallel)", a["ms"],
                b["ms"], card, loss_rel_to_one=loss_rel,
                param_diff_to_one=diff, limit=limit)
        _mc_hold("ff training", loss_rel <= TRAIN_LOSS_RTOL
                 and diff <= 2 * limit,
                 f"step {step}: loss rel {loss_rel}, params diff {diff}")


def _mc_matrix(c, name, data, block, placement):
    c.create_database("wl")
    c.create_set("wl", name, placement=placement)
    c.send_matrix("wl", name, data, block)


def _mc_workloads(out, root, card, pk, device) -> None:
    import numpy as np
    import torch

    wl = {m: __import__(f"netsdb_tpu_torch.workloads.{m}", fromlist=["x"])
          for m in ("kmeans", "gmm", "lda", "pagerank", "topk",
                    "conv_fusion")}
    from netsdb_tpu_torch.parallel.placed_ops import row_blocks
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.relational.table import ColumnTable

    dp = Placement.data_parallel(ndim=2)
    s = WL_SIZES["kmeans"]
    pts, _, centres = _wl_blobs(s["n"], s["d"], s["k"], device, 1,
                                spread=1.5)
    res, planted = [], []
    for c, pl in _mc_each(root, "kmeans", (dp, None), device):
        _mc_matrix(c, "points", pts, s["block"], pl)
        res.append(_mc_timed(lambda c=c: wl["kmeans"].kmeans_on_set(
            c, "wl", "points", s["k"], s["iters"], seed=SEED), device))
        # what the driver runs, over the same row blocks, from the
        # planted centres
        blocks = row_blocks(c.get_tensor("wl", "points"), "kmeans")
        planted.append(_mc_timed(lambda b=blocks: wl["kmeans"].kmeans_blocks(
            b, s["k"], s["iters"], init_centroids=centres), device))
        if pl is not None:
            _mc_gathers("kmeans_on_set", True)
        del blocks
    p64 = pts.double()
    del pts
    # both drivers draw the same random start, whose split clusters
    # drift apart with the partial sums' last bits (as f32 and f64 do in
    # phase 15): held by the objective, the differences counted
    (cp, ap), (cs, as_) = (r[0] for r in res)
    moved, rel = int((ap != as_).sum()), _row_rel(cp, cs)
    obj, obj1 = _inertia(p64, cp, ap), _inertia(p64, cs, as_)
    obj_rel = abs(obj - obj1) / obj1
    del p64
    _mc_row(out, "kmeans_on_set", res[0][1], res[1][1], card,
            inertia_rel_to_one=obj_rel, cent_row_rel=rel,
            assignments_differ=moved)
    _mc_hold("kmeans_on_set", obj_rel <= WL_TOLS["kmeans_cent_rtol"],
             f"inertia rel {obj_rel}; {moved} assignments differ, "
             f"centroids row rel {rel}")
    # from the planted centres every point's nearest centroid is clear:
    # the assignments must be equal
    (cp, ap), (cs, as_) = (r[0] for r in planted)
    moved, rel = int((ap != as_).sum()), _row_rel(cp, cs)
    _mc_row(out, "kmeans_blocks (planted start)", planted[0][1],
            planted[1][1], card, cent_row_rel=rel, assignments_differ=moved)
    _mc_hold("kmeans (planted start)", moved == 0
             and rel <= WL_TOLS["kmeans_cent_rtol"],
             f"{moved} assignments differ, centroids row rel {rel}")
    del res, planted, cp, ap, cs, as_
    _wl_free(device)

    s = WL_SIZES["gmm"]
    pts, _, _ = _wl_blobs(s["n"], s["d"], s["k"], device, 2, spread=3.0)
    res = []
    for c, pl in _mc_each(root, "gmm", (dp, None), device):
        _mc_matrix(c, "points", pts, s["block"], pl)
        res.append(_mc_timed(lambda c=c: wl["gmm"].gmm_on_set(
            c, "wl", "points", s["k"], s["iters"], seed=SEED), device))
        if pl is not None:
            _mc_gathers("gmm_on_set", True)
    (sp, rp), (ss, rs) = (r[0] for r in res)
    errs = {f: _rel(getattr(sp, f), getattr(ss, f))
            for f in ("means", "variances", "weights")}
    ll = wl["gmm"].gmm_log_likelihood(pts, sp).item()
    ll1 = wl["gmm"].gmm_log_likelihood(pts, ss).item()
    ll_rel = abs(ll - ll1) / abs(ll1)
    _mc_row(out, "gmm_on_set", res[0][1], res[1][1], card,
            max_rel_to_one=max(errs.values()), ll_rel_to_one=ll_rel)
    _mc_hold("gmm", max(errs.values()) <= WL_TOLS["gmm_rtol"]
             and ll_rel <= WL_TOLS["gmm_ll_rtol"], f"{errs}, ll {ll_rel}")
    del pts, res, rp, rs
    _wl_free(device)

    s = WL_SIZES["lda"]
    g = _wl_gen(device, 3)
    topics = torch.rand(s["k"], s["vocab"], generator=g, device=device) ** 8
    topics /= topics.sum(1, keepdim=True)
    mix = torch.rand(s["docs"], s["k"], generator=g, device=device) ** 4
    mix /= mix.sum(1, keepdim=True)
    counts = torch.poisson((mix @ topics).mul_(s["doc_len"]), generator=g)
    del topics, mix
    res = []
    for c, pl in _mc_each(root, "lda", (dp, None), device):
        _mc_matrix(c, "counts", counts, s["block"], pl)
        res.append(_mc_timed(lambda c=c: wl["lda"].lda_on_set(
            c, "wl", "counts", s["k"], s["iters"], seed=SEED), device))
        if pl is not None:
            _mc_gathers("lda_on_set", True)
        del c
        _wl_free(device)
    sp, ss = res[0][0], res[1][0]
    perp = wl["lda"].lda_perplexity(counts, sp).item()
    perp1 = wl["lda"].lda_perplexity(counts, ss).item()
    p_rel = abs(perp - perp1) / perp1
    th = (sp.doc_topic - ss.doc_topic).abs().max().item()
    ph = (sp.topic_word - ss.topic_word).abs().max().item()
    _mc_row(out, "lda_on_set", res[0][1], res[1][1], card,
            perplexity_rel_to_one=p_rel, theta_abs=th, phi_abs=ph)
    _mc_hold("lda", p_rel <= WL_TOLS["lda_perp_rtol"]
             and max(th, ph) <= WL_TOLS["lda_atol"],
             f"perplexity rel {p_rel}, theta {th}, phi {ph}")
    del counts, res, sp, ss
    _wl_free(device)

    s = WL_SIZES["pagerank"]
    src, dst = _wl_edges(s["nodes"], s["edges"], device, 4)
    res = []
    for c, pl in _mc_each(root, "pagerank",
                          (Placement.data_parallel(ndim=1), None), device):
        c.create_database("wl")
        c.create_set("wl", "links", type_name="table", placement=pl)
        c.send_table("wl", "links", ColumnTable({"src": src, "dst": dst}))
        res.append(_mc_timed(lambda c=c: wl["pagerank"].pagerank_on_table_set(
            c, "wl", "links", s["nodes"], iters=s["iters"]), device))
        if pl is not None:
            _mc_gathers("pagerank_on_table_set", True)
        del c
    rel = float(np.abs(res[0][0] - res[1][0]).max()
                / np.abs(res[1][0]).max())
    _mc_row(out, "pagerank_on_table_set", res[0][1], res[1][1], card,
            rel_to_one=rel)
    _mc_hold("pagerank", rel <= WL_TOLS["pagerank_rtol"], f"rel {rel}")
    del src, dst, res
    _wl_free(device)

    s = WL_SIZES["topk_table"]
    g = _wl_gen(device, 6)
    scores = torch.randint(0, 1000, (s["rows"],), generator=g,
                           device=device).to(torch.float32) / 10
    res = []
    for c, pl in _mc_each(root, "topk",
                          (Placement.data_parallel(ndim=1), None), device):
        c.create_database("wl")
        c.create_set("wl", "lineitem", type_name="table", placement=pl)
        c.send_table("wl", "lineitem", ColumnTable({"score": scores}))
        res.append(_mc_timed(lambda c=c: wl["topk"].top_k_on_table_set(
            c, "wl", "lineitem", "score", s["k"]), device))
        if pl is not None:
            _mc_gathers("top_k_on_table_set", True)
        del c
    (tp, _), (ts, _) = res
    same = all(torch.equal(tp[f].cpu(), ts[f].cpu()) for f in ("row",
                                                               "score"))
    _mc_row(out, "top_k_on_table_set", res[0][1], res[1][1], card,
            equal_to_one=same, rows=tp["row"].cpu().tolist())
    _mc_hold("top-k", same, "the winners differ from one position's")
    del scores, res
    _wl_free(device)

    s = WL_SIZES["conv"]
    rng = np.random.default_rng(SEED + 7)
    images = rng.standard_normal((s["n"], s["c"], s["h"], s["w"]),
                                 dtype=np.float32)
    kernels = rng.standard_normal((s["o"], s["c"], s["ksize"], s["ksize"]),
                                  dtype=np.float32) * 0.1
    bias = rng.standard_normal(s["o"], dtype=np.float32)
    res = []
    for c, pl in _mc_each(root, "conv", ({"image_flat": dp,
                       "kernel_flat": Placement.replicated()}, None), device):
        pipe = wl["conv_fusion"].ConvFusionPipeline(
            db="convfuse", kernel_size=s["ksize"], block=s["block"])
        pipe.setup(c, placements=pl)
        res.append(_mc_timed(lambda pipe=pipe, c=c: pipe.run(
            c, images, kernels, bias), device))
        if pl is not None:
            _mc_gathers("ConvFusionPipeline.run", True)
        del c
    got = np.stack([im.data for im in res[0][0]])
    one = np.stack([im.data for im in res[1][0]])
    ref = _conv_f64(images, kernels, bias, device).cpu().numpy()
    err = float(np.abs(got - ref).max())
    diff = float(np.abs(got - one).max())
    _mc_row(out, "ConvFusionPipeline.run", res[0][1], res[1][1], card,
            f64_err=err, diff_to_one=diff)
    _mc_hold("conv", err <= WL_TOLS["conv_atol"]
             and diff <= WL_TOLS["conv_atol"], f"f64 {err}, one {diff}")


def _mc_dryrun(out, card, device) -> tuple:
    """``dryrun_multichip(4)`` between B1's and B2's counts set to 0 and
    read; its scalars held to the same calls on one position. Returns
    (B1's launches, B2's): on the card B2 runs the sequence-parallel
    section's ring, B1 nothing."""
    import torch

    from netsdb_tpu_torch.graft_entry import (dryrun_multichip,
                                              dryrun_sections)
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                                   flash_attention_step)

    dryrun_multichip(MC_POSITIONS, device)  # warm, uncounted
    flash_attention.launches = flash_attention_step.launches = 0
    got, ms = _timed(lambda: dryrun_multichip(MC_POSITIONS, device), device)
    b1, b2 = flash_attention.launches, flash_attention_step.launches
    _mc_gathers("dryrun_multichip(4)", False)
    one, ms1 = _mc_timed(lambda: dryrun_sections(MC_POSITIONS, device,
                                               placed=False), device)
    rel = {k: abs(got[k] - one[k]) / max(abs(one[k]), 1e-30)
           for k in ("ff", "loss", "pp", "q06_revenue", "ep", "paged_ff",
                     "sp")}
    _mc_row(out, "dryrun_multichip(4)", ms, ms1, card, b1_launches=b1,
            b2_launches=b2, q01_count=got["q01_count"],
            q03_rows=got["q03_rows"], max_rel_to_one=max(rel.values()))
    out["dryrun_multichip(4)"]["scalars"] = got
    if torch.device(device).type == "cuda":
        _mc_hold("dry run", b2 > 0 and b1 == 0,
                 f"B1 {b1} and B2 {b2} launches (B2 must run, B1 never)")
    _mc_hold("dry run", got["q01_count"] == one["q01_count"]
             and got["q03_rows"] == one["q03_rows"]
             and all(v <= (MC_DRYRUN_SP_RTOL if k == "sp"
                           else MC_DRYRUN_RTOL) for k, v in rel.items()),
             f"placed {got} against one position {one}")
    # B2 at the dry run's head dim 8 and seq 8·n for the other n
    for n in (2, 8):
        flash_attention.launches = flash_attention_step.launches = 0
        dryrun_multichip(n, device)
        other = (flash_attention.launches, flash_attention_step.launches)
        _mc_gathers(f"dryrun_multichip({n})", False)
        print(f"[multichip] dryrun_multichip({n}): B1 {other[0]}, B2 "
              f"{other[1]} launches | {card}")
        out[f"dryrun_multichip({n}) launches"] = other
        if torch.device(device).type == "cuda":
            _mc_hold("dry run", other[1] > 0 and other[0] == 0,
                     f"n = {n}: B1 {other[0]} and B2 {other[1]} launches")
    return b1, b2


def _mc_ring_steps(out, card, device) -> None:
    """B2 held to its plain version elementwise at the dry run's ring
    shapes, which phase 2 does not reach: bh 4 (4 heads), head dim 8
    (B2 pads it to 64), chunks of 8 rows, each of n positions folding
    the ring's chunks in its order (its own first, then from position
    p - 1, p - 2, ...) at the ring's offsets, n = 2, 4 and 8, causal
    and not; each chain also against an f64 attention. These launches
    are comparisons and come after the dry run's counted window."""
    import torch

    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention_step,
                                                   flash_attention_step_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    bh, s_local, d = 4, 8, 8
    worst = {"max_abs_err": 0.0, "f64_err": 0.0, "plain_f64_err": 0.0}
    for n in (2, 4, 8):
        q, k, v = (torch.randn(bh, n * s_local, d, generator=gen,
                               device=device) for _ in range(3))
        pos = torch.arange(n * s_local, device=device)
        for causal in (True, False):
            exact = attention_f64(q, k, v, pos, pos, causal, d ** -0.5)
            for p in range(n):
                rows = slice(p * s_local, (p + 1) * s_local)
                chunks = [(k[:, src * s_local:(src + 1) * s_local],
                           v[:, src * s_local:(src + 1) * s_local],
                           p * s_local, src * s_local)
                          for src in ((p - i) % n for i in range(n))]
                qp = q[:, rows].contiguous()
                chunks = [(a.contiguous(), b.contiguous(), qo, ko)
                          for a, b, qo, ko in chunks]
                got, _ = fold_chain(flash_attention_step, qp, chunks, causal)
                ref, _ = fold_chain(flash_attention_step_plain, qp, chunks,
                                    causal)
                if not torch.isfinite(got).all():
                    raise RuntimeError(f"[multichip] B2 at the dry run's "
                                       f"shapes, n = {n}: non-finite")
                err = (got - ref).abs().max().item()
                f64 = (got.double() - exact[:, rows]).abs().max().item()
                plain64 = (ref.double() - exact[:, rows]).abs().max().item()
                worst = {"max_abs_err": max(worst["max_abs_err"], err),
                         "f64_err": max(worst["f64_err"], f64),
                         "plain_f64_err": max(worst["plain_f64_err"],
                                              plain64)}
                _mc_hold("B2 at the dry run's shapes", err <= F32_TOL
                         and f64 <= max(F64_RATIO * plain64, F32_TOL),
                         f"n = {n}, position {p}, causal {causal}: max abs "
                         f"err {err} (limit {F32_TOL}), against f64 {f64} "
                         f"(plain {plain64})")
    out["ring steps at the dry run's shapes"] = worst
    print(f"[multichip] B2 at the dry run's shapes (bh {bh}, d {d}, chunks "
          f"of {s_local}, n = 2, 4, 8, causal and not): {json.dumps(worst)}"
          f" (limit {F32_TOL}) | {card}")


def phase_multichip(pk: dict, smi: str, device="cuda") -> dict:
    """Phase 19: pipeline parallelism, expert-parallel MoE, the placed
    model families, placed training, the workloads over placed sets and
    the dry run, inside ``virtual_devices(4, device)`` (card 0 unless
    the caller asks for another device, as a rehearsal on the CPU at
    small sizes does), each request held to the same request on one
    position. Returns the results and the dry run's launches."""
    import tempfile

    import torch

    from netsdb_tpu_torch.parallel.mesh import (clear_gather_log,
                                                gather_log, virtual_devices)
    from netsdb_tpu_torch.plan import programs

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    out: dict = {}
    _MC_GATHERS.clear()
    clear_gather_log()
    progs0 = programs.program_stats()
    _wl_free(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with virtual_devices(MC_POSITIONS, "cuda:0" if cuda else device), \
            tempfile.TemporaryDirectory(prefix="netsdb_mc_") as root:
        for section in (_mc_pipeline, _mc_moe, _mc_families, _mc_train,
                        _mc_workloads):
            section(out, root, smi, pk, device)
            _wl_free(device)
        b1, b2 = _mc_dryrun(out, smi, device)
        _mc_ring_steps(out, smi, device)
    progs = programs.program_stats()
    out["memory"] = {
        "peak_reserved_mib": (torch.cuda.max_memory_reserved() / 2**20
                              if cuda else "not measured (CPU)"),
        "card_used": _card_memory() if cuda else "not measured (CPU)",
        "captures": progs["captures"] - progs0["captures"],
        "replays": progs["replays"] - progs0["replays"]}
    out["gathers"] = {k: v for k, v in _MC_GATHERS.items() if v}
    out["launches"] = {"flash_attention": b1, "flash_attention_step": b2}
    print(f"[multichip] peak reserved {out['memory']['peak_reserved_mib']}"
          f" MiB, card used {out['memory']['card_used']}, programs "
          f"captured {out['memory']['captures']} replayed "
          f"{out['memory']['replays']} | {smi}")
    print(f"[multichip] requests that gathered: {sorted(out['gathers'])}; "
          f"left in the log: {gather_log()}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[multichip] phase 19 took {out['seconds']:.1f} s | {smi}")
    return out


# --- phase 20: the daemon's observability on the card ---------------------
# phase 16's sizes (phase 3's FF, phase 4's layer, phase 16's LSTM decode
# width and paged Q01 at SF 0.2); the decode session's client traces 1 in
# ``sample`` steps (the others pay no trace), the other client every request
OBS_SIZES = {"ff": dict(batch=16384, features=1024, hidden=4096,
                        labels=1024, block=512, requests=3),
             "layer": dict(embed=1024, heads=8, batch=2, seq=4096,
                           requests=3),
             "decode": dict(hidden=1024, heads=8, kv_max=64, steps=128,
                            sample=8),
             "paged": dict(sf=0.2, requests=3),
             "onoff": dict(warmup=2, requests=5)}
OBS_SLOW_QUERY_S = 0.005   # under a served layer request: each is logged
OBS_SLOWLOG_ENTRIES = 16
OBS_HISTORY_S = 0.5
OBS_FEEDBACK_EVERY = 4     # admissions between two lane reseeds
OBS_SPAN_TOL = 0.2         # tests/test_obs_serve.py:63-107
OBS_BUDGET_S = 60.0
OBS_TIMEOUT_S = 120.0      # bounds every request to a daemon

# a daemon of the phase: run_daemon on Configuration(root_dir, **json)
_OBS_MAIN = (
    "import json, sys\n"
    "from netsdb_tpu_torch.config import Configuration\n"
    "from netsdb_tpu_torch.serve.server import run_daemon\n"
    "sys.exit(run_daemon(Configuration(root_dir=sys.argv[1], "
    "**json.loads(sys.argv[3])), port=0, device=sys.argv[2]))\n")

#: frames a daemon does not count as workload: the introspection frames
#: and the ones that never reach its dispatch (the handshake, bulk
#: ingest's conversation, shutdown)
_OBS_UNCOUNTED = ("PING", "COLLECT_STATS", "GET_TRACE", "PUT_TRACE",
                  "HEALTH", "GET_METRICS", "HELLO", "BULK_BEGIN",
                  "BULK_CHUNK", "BULK_COMMIT", "SHUTDOWN")


class _FrameCounter:
    """Counts the frames this process sends to one daemon by type (a
    wrapper around the wire client's ``send_frame``; restored by
    ``close``)."""

    def __init__(self, addr: str):
        import threading

        from netsdb_tpu_torch.serve import client as wire

        self._wire = wire
        self._orig = wire.send_frame
        self._port = int(addr.rpartition(":")[2])
        self._mu = threading.Lock()
        self.by_type: dict = {}

        def counted(sock, typ, *a, **kw):
            try:
                mine = sock.getpeername()[1] == self._port
            except OSError:
                mine = False
            if mine:
                with self._mu:
                    name = getattr(typ, "name", str(typ))
                    self.by_type[name] = self.by_type.get(name, 0) + 1
            return self._orig(sock, typ, *a, **kw)

        wire.send_frame = counted

    def workload(self) -> int:
        with self._mu:
            return sum(n for t, n in self.by_type.items()
                       if t not in _OBS_UNCOUNTED)

    def close(self) -> None:
        self._wire.send_frame = self._orig


def _obs_new_qid(seen: set):
    """The query id of the client trace just finished, if the last
    request was traced (the wire client pushes every trace it opens to
    this process's ring)."""
    from netsdb_tpu_torch import obs

    for p in reversed(obs.DEFAULT_RING.last()):
        if p["origin"] == "client" and p["qid"] not in seen:
            seen.add(p["qid"])
            return p["qid"]
    return None


def _obs_profile_kernels(path: str) -> dict:
    """The kernels of one query's ``torch.profiler`` Chrome trace: every
    kernel event's name and µs, and B1's (``fold_kernel<..., false>``
    of ``csrc/flash_fold_mma.cuh``, launched by ``flash_attention.cu``)
    and B2's (``..., true>``) launches and device ms."""
    import json
    import os

    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e.get("name", ""), float(e.get("dur", 0.0)))
               for e in events if e.get("cat") == "kernel"]
    b1 = [d for n, d in kernels if "fold_kernel<" in n and "false>" in n]
    b2 = [d for n, d in kernels if "fold_kernel<" in n and "true>" in n]
    return {"kernels": len(kernels),
            "device_ms": sum(d for _, d in kernels) / 1e3,
            "b1_launches": len(b1), "b1_ms": sum(b1) / 1e3,
            "b2_launches": len(b2)}


def _obs_check(client, qid: str, wall_s: float, kind: str,
               executor: bool) -> dict:
    """One traced request's GET_TRACE profile, after the client's spans
    shipped: spans from client send to the executor (``executor``) or the
    decode batch, the client's top-level spans within OBS_SPAN_TOL of the
    request's wall time, the merged client section and the host/device
    split. Returns what the phase prints."""
    reply = client.get_trace(qid=qid)
    if "followers" in reply:
        raise RuntimeError("GET_TRACE answered a followers section")
    profs = [p for p in reply["profiles"] if p["origin"] == "server"]
    if len(profs) != 1:
        raise RuntimeError(f"{kind} {qid}: {len(profs)} server profiles")
    sp = profs[0]
    names = [s["name"] for s in sp["spans"]]
    frame = "GENERATE" if kind == "decode" else "EXECUTE_COMPUTATIONS"
    first = sp["spans"][0] if sp["spans"] else {}
    if first.get("name") != "server.decode" or first.get("start_s") != 0:
        raise RuntimeError(f"{kind} {qid}: no server.decode span first: "
                           f"{names}")
    want = [f"server.dispatch:{frame}"]
    want.append("executor." if executor else "session.")
    for w in want:
        if not any(n.startswith(w) for n in names):
            raise RuntimeError(f"{kind} {qid}: no {w} span in {names}")
    cs = sp.get("client")
    if not cs or {"client.send", "client.wait"} - {
            s["name"] for s in cs["spans"]}:
        raise RuntimeError(f"{kind} {qid}: no merged client section")
    span_sum = sum(s["duration_s"] for s in cs["spans"] if s["depth"] == 0)
    if abs(span_sum - wall_s) > OBS_SPAN_TOL * wall_s:
        raise RuntimeError(f"{kind} {qid}: client spans {span_sum:.4f} s "
                           f"against a wall of {wall_s:.4f} s")
    hd = sp.get("host_device")
    if not hd or abs(hd["device_est_s"] + hd["host_s"] - sp["total_s"]) \
            > 1e-9 + 1e-9 * sp["total_s"]:
        raise RuntimeError(f"{kind} {qid}: host/device split {hd}")
    meta = sp.get("meta") or {}
    for key in ("device_profile_error", "device_time_error"):
        if key in meta:
            raise RuntimeError(f"{kind} {qid}: {key}: {meta[key]}")
    return {"qid": qid, "wall_ms": wall_s * 1e3,
            "client_span_ms": span_sum * 1e3,
            "server_ms": sp["total_s"] * 1e3,
            "device_est_ms": sp["counters"].get("device.est_s", 0.0) * 1e3,
            "host_ms": hd["host_s"] * 1e3,
            "counters": sp["counters"],
            "spans": [(s["name"], round(s["duration_s"] * 1e3, 3))
                      for s in sp["spans"]],
            "device_profile": meta.get("device_profile"),
            "client": meta.get("client")}


def _obs_ff(c, s, device, seen, card) -> list:
    """FF at phase 3's size through the observed daemon: each request
    timed around its EXECUTE alone, its output then fetched and held to
    f64 (FF_TOL)."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.models.ff import FFModel

    blk = (s["block"], s["block"])
    m = FFModel(db="obs_ff", block=blk)
    m.setup(c)
    rng = np.random.default_rng(SEED)
    f, h, lab = s["features"], s["hidden"], s["labels"]
    weights = (rng.standard_normal((h, f), dtype=np.float32)
               * np.sqrt(2.0 / f),
               rng.standard_normal((h,), dtype=np.float32) * 0.01,
               rng.standard_normal((lab, h), dtype=np.float32)
               * np.sqrt(2.0 / h),
               rng.standard_normal((lab,), dtype=np.float32) * 0.01)
    m.load_weights(c, *weights)
    w1, b1, wo, bo = (torch.as_tensor(w, device=device).double()
                      for w in weights)
    sink = m.build_inference_dag()
    out = []
    for _ in range(s["requests"]):
        x = rng.standard_normal((s["batch"], f), dtype=np.float32)
        m.load_inputs(c, x)
        t0 = time.perf_counter()
        c.execute_computations(sink, job_name="obs-ff", fetch_results=False)
        wall = time.perf_counter() - t0
        qid = _obs_new_qid(seen)
        t0 = time.perf_counter()
        got = c.get_tensor("obs_ff", "output").to_dense()
        fetch = time.perf_counter() - t0
        xd = torch.as_tensor(x, device=device).double()
        ref = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1[:, None])
                            + bo[:, None], dim=0)
        if got.shape != (lab, s["batch"]) or not np.isfinite(got).all():
            raise RuntimeError(f"observed FF output {got.shape} wrong or "
                               f"non-finite")
        err = float((torch.as_tensor(got, device=device).double()
                     - ref).abs().max())
        if not err <= FF_TOL:
            raise RuntimeError(f"observed FF: max abs err {err} > {FF_TOL}")
        out.append({"qid": qid, "wall_s": wall, "max_abs_err": err,
                    "fetch_ms": fetch * 1e3})
        print(f"[obs] ff request {wall * 1e3:.3f} ms (its {got.nbytes / 2 ** 20:.1f}"
              f" MiB result fetched after in {fetch * 1e3:.3f} ms), qid "
              f"{qid}, max abs err {err:.3e} vs f64 ({card})")
    return out


def _obs_layer(c, s, device, seen, card) -> list:
    """The layer at phase 4's size through the observed daemon (B1 once a
    request in its process), each output held to the layer with the plain
    attention (LAYER_TOL)."""
    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.attention import merge_project, qkv_project
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_plain

    heads = s["heads"]
    rm = TransformerLayerModel(db="obs_layer", num_heads=heads)
    lm = TransformerLayerModel(db="obs_layer", num_heads=heads)
    local = Client(device=device)
    rm.setup(c)
    lm.setup(local)
    rm.load_random_weights(c, embed=s["embed"], seed=SEED)
    lm.load_random_weights(local, embed=s["embed"], seed=SEED)
    p = lm.params_from_store(local)
    rng = np.random.default_rng(SEED + 2)
    sink = rm.build_forward_dag(c)
    out = []
    for _ in range(s["requests"]):
        x = rng.standard_normal((s["batch"], s["seq"], s["embed"]),
                                dtype=np.float32)
        rm.load_inputs(c, x)
        k0 = c.collect_stats()["metrics"]["kernels"]
        t0 = time.perf_counter()
        c.execute_computations(sink, job_name="obs-layer",
                               fetch_results=False)
        wall = time.perf_counter() - t0
        qid = _obs_new_qid(seen)
        k1 = c.collect_stats()["metrics"]["kernels"]
        n = k1["flash_attention"] - k0["flash_attention"]
        if device == "cuda" and n != 1:
            raise RuntimeError(f"the observed layer request launched "
                               f"flash_attention {n} times, not once")
        t0 = time.perf_counter()
        (y,) = list(c.get_set_iterator("obs_layer", "y"))
        fetch = time.perf_counter() - t0
        with torch.inference_mode():
            xt = torch.as_tensor(x, device=device)
            q, k, v = (t.contiguous() for t in
                       qkv_project(lm._ln(xt), p.w_qkv, heads))
            x1 = xt + merge_project(flash_attention_plain(q, k, v),
                                    p.w_out)
            ref = x1 + lm._mlp(lm._ln(x1), p)
        y = torch.as_tensor(y).to(device)
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise RuntimeError(f"observed layer output {tuple(y.shape)} "
                               f"wrong or non-finite")
        err = float((y - ref).abs().max())
        if not err <= LAYER_TOL:
            raise RuntimeError(f"observed layer: max abs err {err} > "
                               f"{LAYER_TOL}")
        out.append({"qid": qid, "wall_s": wall, "max_abs_err": err,
                    "b1_launches": n, "fetch_ms": fetch * 1e3})
        print(f"[obs] layer request {wall * 1e3:.3f} ms (its result fetched "
              f"after in {fetch * 1e3:.3f} ms), qid {qid}, max abs err "
              f"{err:.3e}, B1 launches in the daemon {n} ({card})")
    del local
    return out


def _obs_decode(c, s, device, seen, card) -> list:
    """One decode session of ``steps`` LSTM steps through a
    SessionHandle (its client traces 1 in ``sample``), the outputs held
    to the f64 oracle; returns the traced steps."""
    import numpy as np

    from netsdb_tpu_torch.models import decode as dec

    hidden, heads = s["hidden"], s["heads"]
    dec.deploy_decode_model(c, "obs_dec", kind="lstm", hidden=hidden,
                            heads=heads, seed=SEED + 3)
    xs = np.random.default_rng(SEED + 16).standard_normal(
        (1, s["steps"], hidden)).astype(np.float32)
    got = np.zeros(xs.shape, np.float32)
    traced = []
    h = c.open_session("obs_dec", kind="lstm", heads=heads)
    try:
        for t in range(s["steps"]):
            t0 = time.perf_counter()
            got[0, t] = h.generate(xs[0, t], deadline_s=OBS_TIMEOUT_S)
            wall = time.perf_counter() - t0
            qid = _obs_new_qid(seen)
            if qid is not None:
                traced.append({"qid": qid, "wall_s": wall, "step": t})
    finally:
        h.close()
    oracle = _decode_oracle("lstm", dec.decode_weights(
        "lstm", hidden, heads, SEED + 3), xs, heads, s["kv_max"], device)
    err = float(np.abs(got.astype(np.float64) - oracle).max())
    if not err <= SERVE_DECODE_TOLS["lstm"] or not np.isfinite(got).all():
        raise RuntimeError(f"observed decode: max abs err {err} vs f64")
    want = s["steps"] // s["sample"]
    if len(traced) != want:
        raise RuntimeError(f"{len(traced)} of {s['steps']} steps traced, "
                           f"not 1 in {s['sample']} ({want})")
    print(f"[obs] decode: 1 session x {s['steps']} steps, {len(traced)} "
          f"traced (1 in {s['sample']}), max abs err {err:.3e} vs f64 "
          f"({card})")
    for row in traced:
        row["max_abs_err"] = err
    return traced


def _obs_q01(c, s, device, seen, card) -> list:
    """Paged Q01 at SF 0.2 as phase 16 runs it (cold, capturing, warm),
    each result held to the plan run node by node in this process."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.relational import bench as rbench
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.table import ColumnTable

    db = "obs_tpch"
    cols, dicts = rbench.generate_host(sf=s["sf"], seed=SEED)["lineitem"]
    local = Client(device=device)
    for cl, storage in ((c, "paged"), (local, "memory")):
        cl.create_database(db)
        cl.create_set(db, "lineitem", type_name="table", storage=storage)
        cl.send_table(db, "lineitem", ColumnTable.from_columns(
            cols, dicts, device="cpu"))
    ref = node_by_node(local, dag.q01_sink(db))
    del local
    out = []
    for i in range(s["requests"]):
        t0 = time.perf_counter()
        c.execute_computations(dag.q01_sink(db), job_name="obs-q01",
                               fetch_results=False)
        wall = time.perf_counter() - t0
        qid = _obs_new_qid(seen)
        (table,) = list(c.get_set_iterator(db, "q01_out"))
        err = _hold(f"observed q01 {i}", table, ref)
        out.append({"qid": qid, "wall_s": wall, "max_rel_err": err})
        print(f"[obs] paged q01 request {wall * 1e3:.3f} ms, qid {qid}, max "
              f"rel err {err:.3e} vs node by node ({card})")
    return out


def _obs_onoff(addr_on: str, addr_off: str, s: dict, sizes: dict, device,
               card) -> dict:
    """The same warm FF and layer requests against a daemon with
    ``obs_enabled`` on (this client tracing and shipping every request)
    and one with it off (the client's tracing off too), in turns: the
    p50 of each and their ratio. Printed, not gated: host times vary
    between calls."""
    import numpy as np

    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.serve.client import RemoteClient

    fs, ls = sizes["ff"], sizes["layer"]
    rng = np.random.default_rng(SEED + 5)
    x_ff = rng.standard_normal((fs["batch"], fs["features"]),
                               dtype=np.float32)
    x_layer = rng.standard_normal((ls["batch"], ls["seq"], ls["embed"]),
                                  dtype=np.float32)
    clients, sinks = {}, {}
    try:
        for mode, addr in (("on", addr_on), ("off", addr_off)):
            cl = RemoteClient(addr, timeout=OBS_TIMEOUT_S,
                              connect_timeout=30.0, client_id=f"obs-{mode}",
                              ship_traces=True)
            clients[mode] = cl
            fm = FFModel(db="onoff_ff", block=(fs["block"], fs["block"]))
            fm.setup(cl)
            fm.load_random_weights(cl, features=fs["features"],
                                   hidden=fs["hidden"], labels=fs["labels"],
                                   seed=SEED)
            fm.load_inputs(cl, x_ff)
            lm = TransformerLayerModel(db="onoff_layer",
                                       num_heads=ls["heads"])
            lm.setup(cl)
            lm.load_random_weights(cl, embed=ls["embed"], seed=SEED)
            lm.load_inputs(cl, x_layer)
            sinks[mode] = {"ff": fm.build_inference_dag(),
                           "layer": lm.build_forward_dag(cl)}
        ms = {(m, k): [] for m in ("on", "off") for k in ("ff", "layer")}
        for i in range(s["warmup"] + s["requests"]):
            for kind in ("ff", "layer"):
                for mode in (("on", "off") if i % 2 else ("off", "on")):
                    obs.set_enabled(mode == "on")
                    try:
                        t0 = time.perf_counter()
                        clients[mode].execute_computations(
                            sinks[mode][kind], job_name=f"onoff-{kind}",
                            fetch_results=False)
                        dt = (time.perf_counter() - t0) * 1e3
                    finally:
                        obs.set_enabled(True)
                    if i >= s["warmup"]:
                        ms[(mode, kind)].append(dt)
        clients["on"].flush_traces(30.0)
    finally:
        for cl in clients.values():
            cl.close()
    out = {}
    for kind in ("ff", "layer"):
        on, off = _p50(ms[("on", kind)]), _p50(ms[("off", kind)])
        out[kind] = {"on_ms": ms[("on", kind)], "off_ms": ms[("off", kind)],
                     "on_p50_ms": on, "off_p50_ms": off, "ratio": on / off}
        print(f"[obs] tracing on/off, warm {kind}: p50 {on:.3f} ms on, "
              f"{off:.3f} ms off, ratio {on / off:.3f} over "
              f"{s['requests']} requests each, in turns ({card})")
    return out


def phase_obs(pk: dict, smi: str, device: str = "cuda",
              sizes: Optional[dict] = None) -> dict:
    """Phase 20: the daemon's observability. One daemon in its own
    process (``OBS_SIZES``) with per-query device profiles, a low
    slow-query threshold, a 0.5 s telemetry history, the scheduler's
    feedback and SLO shedding; two clients with their own identities
    and shipped traces run warm FF, paged Q01 and three layer requests
    (one client) and a 128-step decode session (the other). Every
    request is held to its phase-16 limit and its GET_TRACE profile is
    checked (``_obs_check``); the layer's device profiles must show B1
    once; the OpenMetrics scrape, HEALTH, the slow-query log and the
    lanes' reseed are checked; then tracing on against off on two more
    daemons."""
    import json
    import os
    import shutil
    import tempfile

    import torch

    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.obs.export import parse_openmetrics
    from netsdb_tpu_torch.serve.client import RemoteClient

    del pk
    s = {k: dict(v, **((sizes or {}).get(k, {})))
         for k, v in OBS_SIZES.items()}
    card = smi
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="netsdb_obs_")
    prof_dir = os.path.join(root, "profiles")
    page = {"page_size_bytes": SERVE_PAGE_BYTES}
    configs = {
        "observed": dict(page, obs_device_profile_dir=prof_dir,
                         obs_slow_query_s=OBS_SLOW_QUERY_S,
                         obs_slowlog_entries=OBS_SLOWLOG_ENTRIES,
                         obs_history_interval_s=OBS_HISTORY_S,
                         sched_feedback=True,
                         sched_feedback_every=OBS_FEEDBACK_EVERY,
                         sched_slo_shed=True),
        "on": dict(page), "off": dict(page, obs_enabled=False)}
    procs, logs, addrs, clients = {}, {}, {}, []
    counter = None
    try:
        for name, cfg in configs.items():  # all three start together
            logs[name] = os.path.join(root, f"{name}.log")
            procs[name] = _daemon_popen(
                _OBS_MAIN, [os.path.join(root, name), device,
                            json.dumps(cfg)], logs[name])
        for name in configs:
            addrs[name] = _daemon_addr(procs[name], logs[name])
        addr = addrs["observed"]
        print(f"[obs] daemons observed {addr}, on {addrs['on']}, off "
              f"{addrs['off']}: {time.perf_counter() - t0:.1f} s to listen "
              f"({card})")
        counter = _FrameCounter(addr)
        a = RemoteClient(addr, timeout=OBS_TIMEOUT_S, connect_timeout=30.0,
                         client_id="obs-a", ship_traces=True)
        b = RemoteClient(addr, timeout=OBS_TIMEOUT_S, connect_timeout=30.0,
                         client_id="obs-b", ship_traces=True,
                         trace_sample=s["decode"]["sample"])
        clients += [a, b]
        k_start = a.collect_stats()["metrics"]["kernels"]
        seen = {p["qid"] for p in obs.DEFAULT_RING.last()}
        runs = {"ff": _obs_ff(a, s["ff"], device, seen, card),
                "decode": _obs_decode(b, s["decode"], device, seen, card),
                "q01": _obs_q01(a, s["paged"], device, seen, card),
                "layer": _obs_layer(a, s["layer"], device, seen, card)}
        for cl in (a, b):
            if not cl.flush_traces(60.0):
                raise RuntimeError("the client traces did not ship")
        out: dict = {"requests": {}}
        for kind, rows in runs.items():
            for row in rows:
                if row["qid"] is None:
                    raise RuntimeError(f"{kind}: a request was not traced")
                chk = _obs_check(b if kind == "decode" else a, row["qid"],
                                 row["wall_s"], kind, kind != "decode")
                if kind == "q01" and not any(
                        k.startswith(("stage.", "devcache."))
                        for k in chk["counters"]):
                    raise RuntimeError(f"paged q01 {row['qid']}: no staging "
                                       f"or device-cache counter: "
                                       f"{chk['counters']}")
                row.update(chk)
            out["requests"][kind] = rows
            r = rows[-1]
            print(f"[obs] {kind}: wall {r['wall_ms']:.3f} ms, client spans "
                  f"{r['client_span_ms']:.3f} ms, server {r['server_ms']:.3f}"
                  f" ms (device est {r['device_est_ms']:.3f}, host "
                  f"{r['host_ms']:.3f}); spans (ms) {r['spans']} ({card})")
        # the layer's device profiles: B1 exactly once, beside device.est_s
        prof_rows = []
        for row in runs["layer"]:
            path = row["device_profile"]
            if not path or not os.path.isdir(path):
                raise RuntimeError(f"layer {row['qid']}: no device profile "
                                   f"({path})")
            if os.path.basename(path) != row["qid"]:
                raise RuntimeError(f"device profile {path} not under qid")
            k = _obs_profile_kernels(path)
            if device == "cuda" and (k["b1_launches"] != 1
                                     or k["b2_launches"]):
                raise RuntimeError(f"layer {row['qid']}: the device profile "
                                   f"shows B1 {k['b1_launches']} times and "
                                   f"B2 {k['b2_launches']}, not 1 and 0")
            row["profile"] = k
            prof_rows.append(k)
            print(f"[obs] layer {row['qid']} device profile: {k['kernels']} "
                  f"kernels, {k['device_ms']:.3f} ms of kernels, B1 "
                  f"{k['b1_launches']} launch {k['b1_ms']:.3f} ms; the "
                  f"trace's device.est_s {row['device_est_ms']:.3f} ms "
                  f"({card})")
        out["ff_profiles"] = []
        for row in runs["ff"]:
            k = _obs_profile_kernels(row["device_profile"])
            out["ff_profiles"].append(k)
            print(f"[obs] ff {row['qid']} device profile: {k['kernels']} "
                  f"kernels, {k['device_ms']:.3f} ms; device.est_s "
                  f"{row['device_est_ms']:.3f} ms ({card})")
        # GET_METRICS as OpenMetrics: both clients, no OBS frame counted
        deadline = time.perf_counter() + 10.0
        while True:  # the request counters tick after each reply
            text = a.get_metrics(format="openmetrics")["text"]
            fams = parse_openmetrics(text)
            served = fams["netsdb_serve_requests_total"]["samples"][0][2]
            if served >= counter.workload() \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        if int(served) != counter.workload():
            raise RuntimeError(f"serve.requests {served} != {counter.workload()}"
                               f" workload frames sent {counter.by_type}")
        labels = {lab.get("client") for _n, lab, _v in
                  fams["netsdb_attrib_requests_total"]["samples"]}
        if not {"obs-a", "obs-b"} <= labels:
            raise RuntimeError(f"attribution labels {labels}")
        structured = a.get_metrics(window_s=60.0)
        out["metrics"] = {"families": len(fams), "serve_requests": served,
                          "frames_sent": dict(counter.by_type),
                          "history": structured["history"],
                          "derived": structured["deltas"].get("derived")}
        print(f"[obs] OpenMetrics: {len(fams)} families parse; "
              f"serve.requests {int(served)} = workload frames sent "
              f"{counter.workload()}; clients {sorted(labels)}; history "
              f"{structured['history']}; rates "
              f"{structured['deltas'].get('derived')} ({card})")
        # HEALTH: the default objectives with burn rates
        h = a.health()
        objs = {o["name"]: o for o in h["objectives"]}
        if {"availability", "request_p99_s", "devcache_hit_rate",
                "staging_wait_fraction"} - set(objs):
            raise RuntimeError(f"HEALTH objectives {sorted(objs)}")
        for o in objs.values():
            if not o["windows"] or any("burn_rate" not in w
                                       for w in o["windows"].values()):
                raise RuntimeError(f"objective {o['name']}: {o['windows']}")
        out["health"] = {n: {"value": o["value"],
                             "worst_burn_rate": o["worst_burn_rate"],
                             "breached": o["breached"]}
                         for n, o in objs.items()}
        out["health_events"] = h["events"]
        print(f"[obs] HEALTH: {out['health']}; events {h['events']} "
              f"({card})")
        # the slow-query log: the layer requests, within its bound
        slow = a.get_trace(slow=True)
        slow_qids = [p["qid"] for p in slow["profiles"]]
        missing = [r["qid"] for r in runs["layer"]
                   if r["qid"] not in slow_qids]
        if missing or len(slow_qids) > OBS_SLOWLOG_ENTRIES \
                or slow["slowlog"]["entries"] > OBS_SLOWLOG_ENTRIES:
            raise RuntimeError(f"slowlog {slow['slowlog']} lacks the layer "
                               f"requests {missing} or holds too many")
        out["slowlog"] = slow["slowlog"]
        print(f"[obs] slowlog: {slow['slowlog']['entries']} entries (bound "
              f"{OBS_SLOWLOG_ENTRIES}), every layer request among them "
              f"({card})")
        # the scheduler reseeded its lanes from the ledger
        st = a.collect_stats()
        reseeds = st["metrics"]["counters"].get("sched.feedback_reseeds", 0)
        weights = {n: ln.get("weight") for n, ln in
                   st["metrics"]["sched"]["lanes"].items()}
        if reseeds < 1:
            raise RuntimeError(f"the scheduler never reseeded: {weights}")
        out["sched"] = {"reseeds": reseeds, "weights": weights,
                        "shed_events": st["metrics"]["counters"].get(
                            "sched.shed_events", 0)}
        print(f"[obs] scheduler: {reseeds} reseeds, lane weights {weights}, "
              f"shed events {out['sched']['shed_events']} ({card})")
        k_end = st["metrics"]["kernels"]
        out["launches"] = {k: k_end[k] - k_start[k] for k in k_end}
        want_b1 = s["layer"]["requests"] if device == "cuda" else 0
        if out["launches"].get("flash_attention", 0) != want_b1 \
                or out["launches"].get("flash_attention_step", 0):
            raise RuntimeError(f"observed daemon launches "
                               f"{out['launches']}: B1 once a layer "
                               f"request, B2 never")
        counter.close()
        counter = None
        out["onoff"] = _obs_onoff(addrs["on"], addrs["off"], s["onoff"], s,
                                  device, card)
        out["seconds"] = time.perf_counter() - t0
        print(f"[obs] daemon launches {out['launches']}; phase 20 took "
              f"{out['seconds']:.1f} s ({card})")
        if out["seconds"] > OBS_BUDGET_S:
            print(f"[obs] WARNING: phase 20 took {out['seconds']:.1f} s, "
                  f"over its {OBS_BUDGET_S} s budget")
        return out
    except BaseException:
        for name, proc in procs.items():
            if proc.poll() is None:
                import signal

                proc.send_signal(signal.SIGUSR1)
        time.sleep(1.0)
        for name, log in logs.items():
            try:
                with open(log) as f:
                    print(f"[obs] daemon {name} log:\n" + f.read()[-6000:])
            except OSError:
                pass
        raise
    finally:
        if counter is not None:
            counter.close()
        for cl in clients:
            cl.close()
        for name, proc in procs.items():
            stopper = None
            try:
                if name in addrs:
                    stopper = RemoteClient(addrs[name], timeout=30.0,
                                           connect_timeout=10.0)
            except Exception:  # noqa: BLE001 — the kill below stops it
                stopper = None
            _serve_stop(proc, stopper)
            if stopper is not None:
                stopper.close()
        shutil.rmtree(root, ignore_errors=True)


# --- phase 21: replication and failover on the card ----------------------
# three daemons A, B, C on card 0, each in its own process, HA armed over
# [A, B, C], A mirroring to B and C, the mutation log on; the widths of
# phases 3 and 4
HA_SIZES = {"ff": dict(batch=16384, features=1024, hidden=4096,
                       labels=1024, block=512, requests=3),
            "layer": dict(embed=1024, heads=8, batch=2, seq=4096,
                          requests=3),
            "hedge": dict(warm=8, plain=5, delayed=3, delay_s=2.0),
            "batches": dict(rows=64, before_kill=8, total=24),
            "failover": dict(rows=64, before_kill=8, total=24)}
# shrunk windows (the reference's tests shrink them too): probes every
# 0.2 s, a follower evicted after 2 misses, a leader replaced after 1.5 s
HA_LINKS = dict(heartbeat_interval_s=0.2, heartbeat_timeout_s=2.0,
                heartbeat_misses=2, mirror_ack_timeout_s=120.0,
                resync_grace_s=60.0, resync_timeout_s=120.0)
HA_ELECTION_S = 1.5
HA_TIMEOUT_S = 120.0      # bounds every request to a daemon
HA_WAIT_S = 120.0         # bounds every wait for a readmission or election
HA_BUDGET_S = 150.0

# a daemon of phase 21: run_daemon with the mutation log and the shrunk
# windows; argv is root, device, a JSON of run_daemon's keywords. With
# "chaos" the daemon carries an injector that a file <root>/arm.json arms
# with {"n", "delay_s"}: n scripted delays of its STREAM_ITEM replies
_HA_MAIN = (
    "import json, os, sys, threading, time\n"
    "from netsdb_tpu_torch.config import Configuration\n"
    "from netsdb_tpu_torch.serve.chaos import ChaosInjector\n"
    "from netsdb_tpu_torch.serve.protocol import MsgType\n"
    "from netsdb_tpu_torch.serve.server import run_daemon\n"
    "kw = json.loads(sys.argv[3])\n"
    "cfg = Configuration(root_dir=sys.argv[1], ha_mutlog=True, "
    "ha_election_timeout_s=kw.pop('election_s'))\n"
    "chaos = ChaosInjector() if kw.pop('chaos') else None\n"
    "arm = os.path.join(sys.argv[1], 'arm.json')\n"
    "def watch():\n"
    "    while True:\n"
    "        if os.path.exists(arm):\n"
    "            with open(arm) as f:\n"
    "                a = json.load(f)\n"
    "            for _ in range(a['n']):\n"
    "                chaos.arm('delay', types=[MsgType.STREAM_ITEM], "
    "delay_s=a['delay_s'])\n"
    "            os.remove(arm)\n"
    "        time.sleep(0.02)\n"
    "if chaos is not None:\n"
    "    threading.Thread(target=watch, daemon=True).start()\n"
    "sys.exit(run_daemon(cfg, device=sys.argv[2], chaos=chaos, **kw))\n")


def _ha_free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _ha_start(name, root, port, device, peers, followers, logs, procs,
              chaos=False):
    """Start one daemon of the phase (``procs[name]``); returns its
    process."""
    import os

    kw = dict(HA_LINKS, port=port, ha_peers=peers, followers=followers,
              election_s=HA_ELECTION_S, chaos=chaos)
    logs[name] = os.path.join(os.path.dirname(root), f"{name}.log")
    procs[name] = _daemon_popen(_HA_MAIN, [root, device, json.dumps(kw)],
                                logs[name])
    return procs[name]


def _ha_canon(v):
    """A host value in a canonical, comparable form (tensors and arrays
    by dtype, shape and bytes)."""
    import numpy as np
    import torch

    from netsdb_tpu_torch.parallel.mesh import ShardedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    if isinstance(v, ShardedTensor):
        return ("st", repr(v.spec), _ha_canon(v.to_dense()))
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return ("t", str(v.dtype), tuple(v.shape),
                v.contiguous().view(torch.uint8).numpy().tobytes())
    if isinstance(v, np.ndarray):
        return ("a", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, ColumnTable):
        return ("ct", {k: _ha_canon(c) for k, c in v.cols.items()},
                {k: list(d) for k, d in v.dicts.items()})
    if isinstance(v, dict):
        return ("d", sorted((repr(k), _ha_canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("l", [_ha_canon(x) for x in v])
    return ("v", repr(v))


def _ha_digest(client) -> dict:
    """Every set of a daemon: its sha256 over the canonical form of what
    it holds (a tensor set's dense matrix, else its items)."""
    import hashlib
    import pickle

    from netsdb_tpu_torch.serve.client import RemoteError

    out = {}
    for db, s in sorted(client.list_sets()):
        try:
            val = ("tensor", _ha_canon(client.get_tensor(db, s).to_dense()))
        except RemoteError:
            val = ("items", _ha_canon(list(client.get_set_iterator(db, s))))
        out[f"{db}:{s}"] = hashlib.sha256(
            pickle.dumps(val, protocol=4)).hexdigest()
    return out


def _ha_same_store(name, a, c, card) -> int:
    da, dc = _ha_digest(a), _ha_digest(c)
    if da != dc:
        diff = sorted(k for k in set(da) | set(dc)
                      if da.get(k) != dc.get(k))
        raise RuntimeError(f"{name}: C's store differs from A's in {diff}")
    print(f"[ha] {name}: C holds A's {len(da)} sets byte for byte ({card})")
    return len(da)


def _ha_mirror_state(client) -> dict:
    return client.collect_stats().get("mirror") or {}


def _ha_wait(what, pred, timeout_s=HA_WAIT_S):
    deadline = time.perf_counter() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise RuntimeError(f"phase 21: {what} within {timeout_s} s")
        time.sleep(0.1)


def _ha_mirrored(a, direct, names, s, device, card) -> dict:
    """Step 1: FF and the layer through A, mirrored to B and C. Each
    output read from the three daemons directly is byte-equal, FF is held
    to f64 and the layer to plain attention (phase 16's limits); B1
    launches once a layer request in every daemon (read through A's
    COLLECT_STATS, which carries its followers')."""
    import numpy as np
    import torch

    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.ops.attention import merge_project, qkv_project
    from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_plain

    out = {}
    f = s["ff"]
    blk = (f["block"], f["block"])
    ff = FFModel(db="ha_ff", block=blk)
    ff.setup(a)
    rng = np.random.default_rng(SEED)
    fe, hi, lab = f["features"], f["hidden"], f["labels"]
    weights = (rng.standard_normal((hi, fe), dtype=np.float32)
               * np.sqrt(2.0 / fe),
               rng.standard_normal((hi,), dtype=np.float32) * 0.01,
               rng.standard_normal((lab, hi), dtype=np.float32)
               * np.sqrt(2.0 / hi),
               rng.standard_normal((lab,), dtype=np.float32) * 0.01)
    ff.load_weights(a, *weights)
    w1, b1, wo, bo = (torch.as_tensor(w, device=device).double()
                      for w in weights)
    b1, bo = b1[:, None], bo[:, None]
    sink = ff.build_inference_dag()
    rng = np.random.default_rng(SEED + 1)
    ms, errs = [], []
    for _ in range(f["requests"]):
        x = rng.standard_normal((f["batch"], fe), dtype=np.float32)
        ff.load_inputs(a, x)
        t0 = time.perf_counter()
        (ident, _), = a.execute_computations(sink, job_name="ha-ff",
                                             fetch_results=False).items()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs = {n: c.get_tensor(*ident).to_dense()
                for n, c in direct.items()}
        if len({o.tobytes() for o in outs.values()}) != 1:
            raise RuntimeError("mirrored FF: the outputs of A, B and C "
                               "differ")
        got = outs["A"]
        xd = torch.as_tensor(x, device=device).double()
        ref = torch.softmax(wo @ torch.relu(w1 @ xd.T + b1) + bo, dim=0)
        if got.shape != (lab, f["batch"]) or not np.isfinite(got).all():
            raise RuntimeError(f"mirrored FF output {got.shape} is wrong")
        err = float((torch.as_tensor(got, device=device).double()
                     - ref).abs().max())
        if not err <= FF_TOL:
            raise RuntimeError(f"mirrored FF: max abs err {err} > {FF_TOL}")
        errs.append(err)
        print(f"[ha] mirrored ff request {ms[-1]:.3f} ms, A = B = C byte "
              f"for byte, max_abs_err {err:.3e} ({card})")
    out["ff"] = {"ms": ms, "p50_ms": _p50(ms), "max_abs_err": max(errs),
                 "output": list(ident)}

    la = s["layer"]
    heads = la["heads"]
    lm = TransformerLayerModel(db="ha_layer", num_heads=heads)
    lm.setup(a)
    lm.load_random_weights(a, embed=la["embed"], seed=SEED)
    local = Client(device=device)
    ref_model = TransformerLayerModel(db="ha_layer", num_heads=heads)
    ref_model.setup(local)
    ref_model.load_random_weights(local, embed=la["embed"], seed=SEED)
    p = ref_model.params_from_store(local)
    k0 = _ha_kernels(a, names)
    rng = np.random.default_rng(SEED + 2)
    ms, errs, y_last = [], [], None
    for _ in range(la["requests"]):
        x = rng.standard_normal((la["batch"], la["seq"], la["embed"]),
                                dtype=np.float32)
        lm.load_inputs(a, x)
        t0 = time.perf_counter()
        a.execute_computations(lm.build_forward_dag(a), job_name="ha-layer",
                               fetch_results=False)
        ms.append((time.perf_counter() - t0) * 1e3)
        ys = {n: list(c.get_set_iterator("ha_layer", "y"))[0]
              for n, c in direct.items()}
        if len({_ha_canon(y)[3] for y in ys.values()}) != 1:
            raise RuntimeError("mirrored layer: the outputs of A, B and C "
                               "differ")
        with torch.inference_mode():
            xt = torch.as_tensor(x, device=device)
            q, k, v = (t.contiguous() for t in
                       qkv_project(ref_model._ln(xt), p.w_qkv, heads))
            x1 = xt + merge_project(flash_attention_plain(q, k, v), p.w_out)
            ref = x1 + ref_model._mlp(ref_model._ln(x1), p)
        y = torch.as_tensor(ys["A"]).to(device)
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise RuntimeError(f"mirrored layer output {tuple(y.shape)} is "
                               f"wrong or non-finite")
        err = float((y - ref).abs().max())
        if not err <= LAYER_TOL:
            raise RuntimeError(f"mirrored layer: max abs err {err} > "
                               f"{LAYER_TOL}")
        errs.append(err)
        y_last = ys["A"]
        print(f"[ha] mirrored layer request {ms[-1]:.3f} ms, A = B = C "
              f"byte for byte, max_abs_err {err:.3e} ({card})")
    del local
    k1 = _ha_kernels(a, names)
    b1 = {n: k1[n]["flash_attention"] - k0[n]["flash_attention"]
          for n in k1}
    b2 = {n: k1[n]["flash_attention_step"] - k0[n]["flash_attention_step"]
          for n in k1}
    want = la["requests"] if device == "cuda" else 0
    if any(v != want for v in b1.values()) or any(b2.values()):
        raise RuntimeError(f"mirrored layer: B1 launches {b1} (want {want} "
                           f"in each daemon), B2 {b2}")
    print(f"[ha] B1 launches in A, B, C over the layer requests: {b1} "
          f"({card})")
    out["applied_log"] = {}
    for n in ("B", "C"):
        lg = direct[n].collect_stats()["applied_log"]
        comp = lg["compaction"]
        out["applied_log"][n] = lg
        print(f"[ha] {n}'s applied log: {lg['frames']} frames, "
              f"{lg['bytes']} bytes on its base; "
              + (f"last compaction {comp['frames']} frames, "
                 f"{comp['log_bytes']} logged bytes into a "
                 f"{comp['snapshot_bytes']} byte snapshot in "
                 f"{comp['seconds'] * 1e3:.1f} ms" if comp
                 else "no compaction yet")
              + f" ({card})")
    out["layer"] = {"ms": ms, "p50_ms": _p50(ms), "max_abs_err": max(errs),
                    "b1_launches": b1, "b2_launches": b2}
    out["y_last"] = y_last
    return out


def _ha_kernels(a, names: dict) -> dict:
    """The kernel counters of A and of each follower, by daemon name
    (``names``: address → name), through A's COLLECT_STATS, which
    carries its followers' sections."""
    st = a.collect_stats()
    out = {"A": st["metrics"]["kernels"]}
    for addr, fst in (st.get("followers") or {}).items():
        if "error" in fst:
            raise RuntimeError(f"follower {addr} did not answer: {fst}")
        out[names[addr]] = fst["metrics"]["kernels"]
    if sorted(out) != ["A", "B", "C"]:
        raise RuntimeError(f"A's COLLECT_STATS lacks a follower: "
                           f"{sorted(out)}")
    return out


def _ha_hedged(addrs, roots, mirrored, s, card) -> dict:
    """Step 2: hedged reads of FF's output. Unhedged reads of A set the
    baseline; a client with replicas [B, C] reads it warm, then while A's
    STREAM_ITEM replies are delayed (its injector armed through its
    root); every reply byte-equal to the unhedged one."""
    import json as _json
    import os

    from netsdb_tpu_torch.serve.client import RemoteClient

    h = s["hedge"]
    ident = mirrored["ff"]["output"]
    plain = RemoteClient(addrs["A"], timeout=HA_TIMEOUT_S)
    hedged = RemoteClient(addrs["A"], replicas=[addrs["B"], addrs["C"]],
                          timeout=HA_TIMEOUT_S)
    try:
        def read(c):
            t0 = time.perf_counter()
            t = c.get_tensor_chunked(*ident)
            return (time.perf_counter() - t0) * 1e3, t.to_dense().tobytes()

        base = [read(plain) for _ in range(h["plain"])]
        want = base[0][1]
        mib = len(want) / (1 << 20)
        warm = [read(hedged) for _ in range(h["warm"])]
        trigger = hedged.hedge_delay_s()
        won0 = hedged.hedges_won
        arm = os.path.join(roots["A"], "arm.json")
        with open(arm + ".tmp", "w") as f:
            _json.dump({"n": h["delayed"], "delay_s": h["delay_s"]}, f)
        os.replace(arm + ".tmp", arm)
        _ha_wait("A's injector armed", lambda: not os.path.exists(arm), 30)
        delayed = [read(hedged) for _ in range(h["delayed"])]
        for _ms, got in warm + delayed:
            if got != want:
                raise RuntimeError("a hedged read differs from the "
                                   "unhedged one")
        won = hedged.hedges_won - won0
        if won < 1:
            raise RuntimeError(f"no hedge won while A's replies were "
                               f"delayed {h['delay_s']} s")
        out = {"plain_p50_ms": _p50([m for m, _ in base]),
               "hedged_p50_ms": _p50([m for m, _ in warm]),
               "delayed_p50_ms": _p50([m for m, _ in delayed]),
               "hedge_delay_s": trigger, "hedges_issued":
                   hedged.hedges_issued, "hedges_won": hedged.hedges_won,
               "won_while_delayed": won,
               "read_latency": hedged.read_latency_stats()}
        print(f"[ha] hedged reads of FF's output ({mib:.1f} MiB): "
              f"unhedged p50 "
              f"{out['plain_p50_ms']:.3f} ms, hedged p50 "
              f"{out['hedged_p50_ms']:.3f} ms, with A delayed "
              f"{h['delay_s']} s p50 {out['delayed_p50_ms']:.3f} ms; "
              f"hedge_delay_s() {trigger:.4f} s; hedges won {won} of "
              f"{h['delayed']} delayed reads, every reply byte-equal "
              f"({card})")
        return out
    finally:
        plain.close()
        hedged.close()


def _ha_batches_ok(client, db, set_name, acked, rows) -> dict:
    """Each acknowledged batch exactly once: row counts and the sum of
    the rows' values."""
    items = list(client.get_set_iterator(db, set_name))
    per = {}
    for it in items:
        per[it["b"]] = per.get(it["b"], 0) + 1
    want = {b: rows for b in acked}
    total = sum(it["v"] for it in items)
    want_total = sum(b * 1000 * rows + rows * (rows - 1) // 2
                     for b in acked)
    if per != want or total != want_total:
        raise RuntimeError(f"{set_name}: batches {per} (want {rows} rows "
                           f"of each of {sorted(acked)}), checksum {total} "
                           f"(want {want_total})")
    return {"batches": len(per), "rows": len(items), "checksum": total}


def _ha_follower_killed(addrs, ports, roots, root, device, peers, procs,
                        logs, direct, s, card) -> dict:
    """Step 3: C SIGKILLed while numbered batches stream through A (a
    typed FollowerDegraded is retried by ``send_data``'s own policy),
    restarted on its root (rebuilt from its base snapshot and a bounded
    tail of its applied log) and readmitted by log replay; then
    SIGKILLed again, restarted on an empty root and readmitted by a
    snapshot. After each readmission every set of C holds A's bytes."""
    import os
    import threading

    from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
    from netsdb_tpu_torch.serve.server import ServeController

    b = s["batches"]
    a = direct["A"]
    a.create_set("ha", "batches", type_name="object")
    writer = RemoteClient(addrs["A"], timeout=HA_TIMEOUT_S,
                          retry=RetryPolicy(max_attempts=400,
                                            base_delay_s=0.05,
                                            max_delay_s=0.25,
                                            deadline_s=HA_WAIT_S))
    acked = []
    killed = threading.Event()
    errors = []

    def stream():
        try:
            for i in range(b["total"]):
                if i == b["before_kill"]:
                    killed.wait(HA_WAIT_S)
                writer.send_data("ha", "batches",
                                 [{"b": i, "r": r, "v": i * 1000 + r}
                                  for r in range(b["rows"])])
                acked.append(i)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    last = (_ha_mirror_state(a).get("last_resync") or {}).get("seq", 0)
    t = threading.Thread(target=stream, daemon=True)
    t.start()
    _ha_wait("the first batches", lambda: len(acked) >= b["before_kill"])
    procs["C"].kill()
    procs["C"].wait(30)
    killed.set()
    t.join(HA_WAIT_S)
    writer.close()
    counts = dict(writer.retries_by_error)
    if errors or t.is_alive():
        raise RuntimeError(f"batches stalled with C dead: {errors}")
    if counts.get("FollowerDegradedError", 0) < 1:
        raise RuntimeError(f"no FollowerDegraded was seen when C died: "
                           f"{counts}")
    print(f"[ha] C killed after {b['before_kill']} batches: all "
          f"{len(acked)} acknowledged, refusals retried {counts} ({card})")
    out = {"refusals": counts}
    _ha_batches_ok(a, "ha", "batches", acked, b["rows"])
    for name, croot in (("log", roots["C"]),
                        ("snapshot", os.path.join(root, "C-empty"))):
        if name == "snapshot":
            procs["C"].kill()
            procs["C"].wait(30)
        t0 = time.perf_counter()
        _ha_start("C", croot, ports["C"], device, peers, None, logs, procs)
        _daemon_addr(procs["C"], logs["C"])
        started = time.perf_counter() - t0

        def readmitted():
            m = _ha_mirror_state(a)
            r = m.get("last_resync") or {}
            return (r if addrs["C"] in m.get("active", ())
                    and r.get("seq", 0) > last
                    and r.get("addr") == addrs["C"] else None)

        r = _ha_wait(f"C readmitted by {name}", readmitted)
        last = r["seq"]
        if r["mode"] != name:
            raise RuntimeError(f"C was readmitted by {r['mode']}, not by "
                               f"{name}: {r}")
        wall = time.perf_counter() - t0
        if direct.get("C") is not None:
            direct["C"].close()
        direct["C"] = RemoteClient(addrs["C"], timeout=HA_TIMEOUT_S)
        nsets = _ha_same_store(f"readmitted by {name}", a, direct["C"],
                               card)
        row = dict(r, start_s=started, readmit_wall_s=wall, sets=nsets)
        if name == "snapshot":
            row["mb_per_s"] = r["bytes"] / r["stream_s"] / 1e6
            print(f"[ha] C on an empty root: started in {started:.1f} s, "
                  f"snapshot of {r['bytes']} bytes in "
                  f"{r['total_s'] * 1e3:.1f} ms, A's writes held that long "
                  f"(streamed {r['stream_s'] * 1e3:.1f} ms, "
                  f"{row['mb_per_s']:.1f} MB/s), readmitted {wall:.1f} s "
                  f"after its start ({card})")
        else:
            rebuilt = direct["C"].collect_stats()["applied_log"]["restore"]
            if rebuilt is None or rebuilt["frames"] \
                    >= ServeController.applied_log_max_frames:
                raise RuntimeError(f"C on its root replayed no bounded "
                                   f"tail of its applied log: {rebuilt}")
            row["applied_restore"] = rebuilt
            print(f"[ha] C on its root: started in {started:.1f} s, its "
                  f"store rebuilt in {rebuilt['seconds'] * 1e3:.1f} ms (a "
                  f"{rebuilt['snapshot_bytes']} byte base and "
                  f"{rebuilt['frames']} logged frames, "
                  f"{rebuilt['log_bytes']} bytes), then {r['frames']} "
                  f"frames ({r['bytes']} bytes) replayed from its applied "
                  f"offset in {r['total_s'] * 1e3:.1f} ms, A's writes held "
                  f"that long ({card})")
        out[name] = row
    return out


def _ha_leader_killed(addrs, procs, direct, mirrored, s, device,
                      card) -> dict:
    """Step 4: A SIGKILLed while a failover client streams numbered
    batches: B promotes (term 2) within the election window; every
    acknowledged batch is in B and C exactly once; a layer EXECUTE on B
    launches B1 once (and once on its follower C) and equals the output
    before the kill byte for byte."""
    import threading

    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

    f = s["failover"]
    a = direct["A"]
    a.create_set("ha", "failover", type_name="object")
    client = RemoteClient(addrs["A"], failover=[addrs["B"], addrs["C"]],
                          timeout=HA_TIMEOUT_S,
                          retry=RetryPolicy(max_attempts=400,
                                            base_delay_s=0.05,
                                            max_delay_s=0.25))
    acked, ack_t, errors = [], {}, []
    killed = threading.Event()

    def stream():
        try:
            for i in range(f["total"]):
                if i == f["before_kill"]:
                    killed.wait(HA_WAIT_S)
                client.send_data("ha", "failover",
                                 [{"b": i, "r": r, "v": i * 1000 + r}
                                  for r in range(f["rows"])])
                ack_t[i] = time.perf_counter()
                acked.append(i)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    _ha_wait("the batches before the kill",
             lambda: len(acked) >= f["before_kill"])
    t_kill = time.perf_counter()
    procs["A"].kill()
    procs["A"].wait(30)
    killed.set()
    t.join(HA_WAIT_S)
    if errors or t.is_alive():
        raise RuntimeError(f"the failover stream stalled: {errors}")
    direct["A"].close()
    direct["A"] = None
    b = direct["B"]
    ha = b.ping().get("ha") or {}
    if ha.get("role") != "leader" or ha.get("term") != 2:
        raise RuntimeError(f"B did not lead at term 2 after the kill: {ha}")
    first = ack_t[f["before_kill"]] - t_kill
    checks = {n: _ha_batches_ok(direct[n], "ha", "failover", acked,
                                f["rows"]) for n in ("B", "C")}
    k0 = {n: direct[n].collect_stats()["metrics"]["kernels"]
          for n in ("B", "C")}
    lm = TransformerLayerModel(db="ha_layer", num_heads=s["layer"]["heads"])
    t0 = time.perf_counter()
    b.execute_computations(lm.build_forward_dag(b), job_name="ha-layer-b",
                           fetch_results=False)
    layer_ms = (time.perf_counter() - t0) * 1e3
    k1 = {n: direct[n].collect_stats()["metrics"]["kernels"]
          for n in ("B", "C")}
    launches = {n: k1[n]["flash_attention"] - k0[n]["flash_attention"]
                for n in k1}
    b2 = {n: k1[n]["flash_attention_step"] - k0[n]["flash_attention_step"]
          for n in k1}
    want = 1 if device == "cuda" else 0
    if launches != {"B": want, "C": want} or any(b2.values()):
        raise RuntimeError(f"the layer on the promoted leader launched B1 "
                           f"{launches} (want {want} in B and C), B2 {b2}")
    want_y = _ha_canon(mirrored["y_last"])
    for n in ("B", "C"):
        y = list(direct[n].get_set_iterator("ha_layer", "y"))[0]
        if _ha_canon(y) != want_y:
            raise RuntimeError(f"the layer on the promoted leader: {n}'s "
                               f"output differs from the one before the "
                               f"kill")
    out = {"term": ha["term"], "kill_to_first_ack_s": first,
           "failovers": client.failovers, "batches": checks,
           "layer_ms": layer_ms, "b1_launches": launches,
           "b2_launches": b2}
    client.close()
    print(f"[ha] A killed after {f['before_kill']} batches: B leads at term "
          f"2, the first write acknowledged {first * 1e3:.1f} ms after the "
          f"kill (election window {HA_ELECTION_S} s); all {len(acked)} "
          f"acknowledged batches once in B and in C {checks['B']}; the "
          f"layer on B {layer_ms:.3f} ms, B1 {launches}, output equal to "
          f"the one before the kill ({card})")
    return out


def _ha_deposed(addrs, ports, roots, device, peers, procs, logs,
                card) -> dict:
    """Step 5: A restarted on its root: its first write is fenced by its
    followers, it steps down, and the client gets a typed NotLeader
    naming B and term 2 (twice: the second refused before it applies)."""
    from netsdb_tpu_torch.serve.client import (NotLeaderError, RemoteClient,
                                               RetryPolicy)

    _ha_start("A", roots["A"], ports["A"], device, peers,
              [addrs["B"], addrs["C"]], logs, procs)
    _daemon_addr(procs["A"], logs["A"])
    c = RemoteClient(addrs["A"], timeout=HA_TIMEOUT_S,
                     retry=RetryPolicy(max_attempts=1))
    try:
        seen = []
        for _ in range(2):
            try:
                c.create_database("ha_stale")
            except NotLeaderError as e:
                seen.append((e.leader_addr, e.term))
                continue
            raise RuntimeError("the restarted deposed leader took a write")
        if seen != [(addrs["B"], 2)] * 2:
            raise RuntimeError(f"the refusals named {seen}, not "
                               f"({addrs['B']}, 2)")
        ha = c.ping().get("ha") or {}
        if ha.get("role") != "follower" or ha.get("term") != 2:
            raise RuntimeError(f"the restarted A did not step down: {ha}")
    finally:
        c.close()
    print(f"[ha] A restarted on its root: a write refused with NotLeader "
          f"naming {addrs['B']} and term 2, A stepped down to follower "
          f"({card})")
    return {"refusals": seen, "role": ha["role"]}


def phase_ha(pk: dict, smi: str, device: str = "cuda",
             sizes: Optional[dict] = None,
             solo: Optional[dict] = None) -> dict:
    """Phase 21: replication and failover. Daemons A, B and C in their
    own processes on card 0, HA armed over [A, B, C] (election
    ``HA_ELECTION_S``, ``HA_LINKS``), A mirroring to B and C, the mutation
    log on in all three: mirrored FF and layer requests (``_ha_mirrored``),
    hedged reads (``_ha_hedged``), a follower killed and readmitted twice
    (``_ha_follower_killed``), the leader killed (``_ha_leader_killed``)
    and the deposed leader restarted (``_ha_deposed``). ``solo`` is phase
    16's result, whose p50s are printed beside the mirrored ones. The
    three daemons share one card: a mirrored request's wall holds the
    followers' work on the same SMs, not a replica's on its own card."""
    import os
    import shutil
    import tempfile

    import torch

    from netsdb_tpu_torch.serve.client import RemoteClient

    del pk
    s = {k: dict(v, **((sizes or {}).get(k, {})))
         for k, v in HA_SIZES.items()}
    card = smi
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="netsdb_ha_")
    names = ("A", "B", "C")
    ports = dict(zip(names, _ha_free_ports(3)))
    addrs = {n: f"127.0.0.1:{ports[n]}" for n in names}
    roots = {n: os.path.join(root, n) for n in names}
    peers = [addrs[n] for n in names]
    procs, logs, direct = {}, {}, {}
    try:
        for n in names:  # all three start together
            _ha_start(n, roots[n], ports[n], device, peers,
                      [addrs["B"], addrs["C"]] if n == "A" else None,
                      logs, procs, chaos=n == "A")
        for n in names:
            _daemon_addr(procs[n], logs[n])
            direct[n] = RemoteClient(addrs[n], timeout=HA_TIMEOUT_S,
                                     connect_timeout=30.0)
        print(f"[ha] daemons A {addrs['A']} (leader, followers B and C), "
              f"B {addrs['B']}, C {addrs['C']}, HA over [A, B, C]: "
              f"{time.perf_counter() - t0:.1f} s to listen; three processes "
              f"on one card ({card})")
        a = direct["A"]
        a.create_database("ha")
        out = {"mirrored": _ha_mirrored(
            a, direct, {addrs[n]: n for n in names}, s, device, card)}
        y_last = out["mirrored"].pop("y_last")
        for key in ("ff", "layer"):
            solo_p50 = ((solo or {}).get(key) or {}).get("p50_ms")
            print(f"[ha] {key}: mirrored EXECUTE p50 "
                  f"{out['mirrored'][key]['p50_ms']:.3f} ms (A with B and "
                  f"C on the same card, no result fetched) beside phase "
                  f"16's solo p50 "
                  + (f"{solo_p50:.3f} ms (its requests fetch their result)"
                     if solo_p50 is not None
                     else "(phase 16 not run in this call)")
                  + f" ({card})")
        out["hedged"] = _ha_hedged(addrs, roots, out["mirrored"], s, card)
        out["follower_killed"] = _ha_follower_killed(
            addrs, ports, roots, root, device, peers, procs, logs, direct,
            s, card)
        out["leader_killed"] = _ha_leader_killed(
            addrs, procs, direct, {"y_last": y_last}, s, device, card)
        out["deposed"] = _ha_deposed(addrs, ports, roots, device, peers,
                                     procs, logs, card)
        b1, b2 = (sum(out["mirrored"]["layer"][key].values())
                  + sum(out["leader_killed"][key].values())
                  for key in ("b1_launches", "b2_launches"))
        out["launches"] = {"flash_attention": b1, "flash_attention_step": b2}
        out["seconds"] = time.perf_counter() - t0
        print(f"[ha] B1 launched {b1} times, B2 {b2} times in the daemons' "
              f"counted windows; phase 21 took {out['seconds']:.1f} s ({card})")
        if out["seconds"] > HA_BUDGET_S:
            print(f"[ha] WARNING: phase 21 took {out['seconds']:.1f} s, "
                  f"over its {HA_BUDGET_S} s budget")
        return out
    except BaseException:
        for n, proc in procs.items():
            if proc.poll() is None:
                import signal

                proc.send_signal(signal.SIGUSR1)
        time.sleep(1.0)
        for n, log in logs.items():
            try:
                with open(log) as f:
                    print(f"[ha] daemon {n} log:\n" + f.read()[-6000:])
            except OSError:
                pass
        raise
    finally:
        for c in direct.values():
            if c is not None:
                c.close()
        for n, proc in procs.items():
            stopper = None
            if proc.poll() is None:
                try:
                    stopper = RemoteClient(addrs[n], timeout=30.0,
                                           connect_timeout=10.0)
                except Exception:  # noqa: BLE001 — the kill below stops it
                    stopper = None
            _serve_stop(proc, stopper)
            if stopper is not None:
                stopper.close()
        shutil.rmtree(root, ignore_errors=True)


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
        print(json.dumps({"relational": relational_path(pk)[0],
                          "card": smi}))
        return 0
    if "--paged-relations-only" in sys.argv[1:]:
        # phase 12 alone, the same way
        state = _resident_card(TPCH_SF)
        try:
            res = paged_relations_path(pk, state)
        finally:
            _close_paged(state.get("paged"))
        print(json.dumps({"paged_relations": res, "card": smi},
                         default=str))
        return 0
    if "--compiled-only" in sys.argv[1:]:
        # phase 14 alone, the same way (TPC-H at COMPILED_ONLY_SF)
        print(json.dumps({"compiled": compiled_path(), "card": smi},
                         default=str))
        return 0
    if "--rows-only" in sys.argv[1:]:
        # phase 13 alone, the same way
        print(json.dumps({"rows": rows_path(pk), "card": smi},
                         default=str))
        return 0
    if "--workloads-only" in sys.argv[1:]:
        # phase 15 alone, the same way
        print(json.dumps({"workloads": workloads_path(pk), "card": smi},
                         default=str))
        return 0
    if "--serve-only" in sys.argv[1:]:
        # phase 16 alone, the same way
        print(json.dumps({"serve": phase_serve(pk, smi), "card": smi},
                         default=str))
        return 0
    if "--pool-only" in sys.argv[1:]:
        # phase 17 alone, the same way
        print(json.dumps({"pool": phase_pool(pk, smi), "card": smi},
                         default=str))
        return 0
    if "--obs-only" in sys.argv[1:]:
        # phase 20 alone, the same way
        print(json.dumps({"obs": phase_obs(pk, smi), "card": smi},
                         default=str))
        return 0
    if "--ha-only" in sys.argv[1:]:
        # phase 21 alone, the same way
        print(json.dumps({"ha": phase_ha(pk, smi), "card": smi},
                         default=str))
        return 0
    if "--multichip-only" in sys.argv[1:]:
        # phase 19 alone, the same way
        print(json.dumps({"multichip": phase_multichip(pk, smi),
                          "card": smi}, default=str))
        return 0
    if "--mesh-only" in sys.argv[1:]:
        # phase 18 alone, the same way, over its own SF 10 tables
        state = _resident_card(TPCH_SF)
        print(json.dumps({"mesh": mesh_path(pk, smi, state), "card": smi},
                         default=str))
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
    relational, rel_state = relational_path(pk)
    try:
        paged_relations = paged_relations_path(pk, rel_state)
        rows = rows_path(pk)
        compiled = compiled_path(rel_state)
        _close_paged(rel_state.pop("paged", None))
        _wl_free("cuda")
        mesh = mesh_path(pk, smi, rel_state)
    finally:
        _close_paged(rel_state.get("paged"))
    del rel_state
    multichip = phase_multichip(pk, smi)
    workloads = workloads_path(pk)
    serve = phase_serve(pk, smi)
    pool = phase_pool(pk, smi)
    observed = phase_obs(pk, smi)
    replicated = phase_ha(pk, smi, solo=serve)
    pool_launches = {
        k: pool["launches"].get(k, 0) + pool["inproc"]["launches"][i]
        for i, k in enumerate(("flash_attention", "flash_attention_step"))}

    print(json.dumps({"ff_rows_per_s": ff["rows_per_s"],
                      "transformer_tokens_per_s": tf["tokens_per_s"],
                      "sp_tokens_per_s": sp["tokens_per_s"],
                      "sp_max_abs_err": sp["max_abs_err"],
                      "paged": paged, "models": models, "train": train,
                      "la": la, "relational": relational,
                      "paged_relations": paged_relations, "rows": rows,
                      "compiled": compiled, "workloads": workloads,
                      "serve": serve, "pool": pool, "mesh": mesh,
                      "multichip": multichip, "obs": observed,
                      "ha": replicated, "card": smi},
                     default=str))

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
                   "netsdb_tpu/ops/pallas_kernels.py:211",
                   {"inference": b1_launches,
                    "training": train["path_b1_launches"],
                    "compiled": compiled["launches"]["flash_attention"],
                    "workloads": workloads["launches"]["flash_attention"],
                    "served": serve["launches"]["flash_attention"],
                    "pool": pool_launches["flash_attention"],
                    "mesh": mesh["launches"]["flash_attention"],
                    "multichip": multichip["launches"]["flash_attention"],
                    "observability":
                        observed["launches"]["flash_attention"],
                    "replication":
                        replicated["launches"]["flash_attention"]},
                   b1),
        kernel_row("flash_attention_step",
                   "netsdb_tpu_torch/csrc/flash_attention_step.cu",
                   "netsdb_tpu/ops/pallas_kernels.py:333",
                   {"sequence_parallel": sp["launches"],
                    "compiled": compiled["launches"]["flash_attention_step"],
                    "workloads":
                        workloads["launches"]["flash_attention_step"],
                    "served": serve["launches"]["flash_attention_step"],
                    "pool": pool_launches["flash_attention_step"],
                    "mesh": mesh["launches"]["flash_attention_step"],
                    "multichip":
                        multichip["launches"]["flash_attention_step"],
                    "observability":
                        observed["launches"]["flash_attention_step"],
                    "replication":
                        replicated["launches"]["flash_attention_step"]},
                   b2)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
