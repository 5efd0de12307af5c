"""Card smoke test of the PyTorch port (deeprec_tpu_torch): its serving
path, its host-index training path, its tiered storage, the CTR zoo, the
sequence models DIN and DIEN, the modelzoo entry points (the training
CLI, the sparse optimizers, the bf16 towers and the server's command
line), the device-index training engine, the variant tables
(multi-hash, adaptive, dynamic dimension, hash table), the migration of
DeepRec checkpoints and the multi-device engines (the device-index and
host-sharded ShardedTrainer, multi-shard saves, ShardedPredictor,
TieredShardedTrainer, DistributedHashTable and the server's --mesh), and
the long-run checks (the soak on both one-card engines and the DIN/DIEN
fidelity bisect), and that a training step is a function of its inputs
(two runs of one step bit-equal on every one-card path).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no JAX. Float32 throughout, but for the bf16 checks: TF32 is
switched off for matrix products and convolutions, so both sides of every
comparison compute in full f32. Phases (any failure exits non-zero):

1. builds the hand-written CUDA kernels from deeprec_tpu_torch/csrc/ (nvcc,
   sm_90a, one process per source) and prints the build time;
2. runs each kernel's wrapper against its plain PyTorch version at the
   shapes the main paths give it (a B=4096 Criteo batch), and times the
   kernel, the plain version and one PyTorch library call computing the
   same function with CUDA events, beside the kernel's HBM-bytes bound:
   K1 and K2 at the serving shape; K2 (both directions), K1's unique-row
   fetch and optimizer read and K3a (lookup_meta, and the three-plane
   meta_scatter, held to lookup_meta's planes) at the training shape of
   one resolved batch; K3a's scatter_set and K3b at the JAX benchmark's
   own shape (CAP 2^21, U 17,664). K1 at every shape it is checked at,
   K2 at the serving shape, K2's backward, K3a at the training shape, K4
   and K5 are also timed on path, behind a one-element PyTorch add (its
   time subtracted); the K1 -> K2 pair of the serving path is held
   bit-equal to the plain versions and timed the same way. K2's
   backward, at every shape it is checked at, runs twice bit-equal, is
   held bit-equal on every row to the order reference
   (tests/torch_k2_order.py: the kernel's lane order and run tree in
   plain PyTorch) and to its plain version run on the CPU (every row of
   at most 32 valid lanes bit-equal, longer rows within BWD_TOL of the
   magnitudes), and is timed beside zeros + index_add_ and the
   deterministic zeros + index_put_(accumulate=True). K2 at bf16 (both
   directions, at the serving and the training shape) is checked against
   its plain version (both sum in f32 and round once: one bf16 step of the
   value apart at most, beside the f32 order term) and timed beside
   embedding_bag / index_add_ at bf16, its bound at 2 bytes a value. K4
   and K5, the hash index's lookup and lookup_or_insert_ (in place; the
   functional lookup_or_insert too, which must leave its input table as
   it was), are held bit-equal to their plain versions
   (hashtable.lookup_plain, lookup_or_insert_plain) on the same card
   tensors, K5's arbitration words all zero after every call and K5 held
   again after its timing, and timed back to back (an insert that
   changes the table: a call at a time on a fresh copy), beside the plain
   versions, the functional form's clone of the table and their bound (no
   PyTorch call computes either): K5 at the device-index shape (26,625
   lanes into 2^21 slots, first step and steady), at growth's rebuild
   (2^16 -> 2^17), at the variants' flat
   dedup and at the mesh4 owner's lanes, K4 at the serving dedup and at
   the mesh4 owner's 53,248 read-only lanes. DLRM's dot interaction,
   forward and backward, at the benchmark cell's shape [65,536, 27, 16]
   is held to its plain versions, each kernel bit-equal across two
   calls, and timed beside the plain path (bmm + gather, autograd's index
   backward and batched GEMMs, by kernel) and its HBM bound; its launches
   are counted on the paths that train a DLRM. DIEN's GRU and AUGRU
   recurrence kernels at the benchmark cell's shape [16,384, 100, 36]
   (its traffic's lengths) are held to the modules' loop (output, input,
   attention and parameter gradients), the backward bit-equal across two
   calls, and timed alone, on the path and beside the loop, with their
   bytes and FLOP bounds; their launches are counted on the paths that
   may train a DIEN (seq, cli). DIN's attention unit at the same shape
   (DIEN's unscaled scores and DIN's scaled ones, hidden 80-40) is held
   to the module's plain code (the weights and every gradient), the
   backward bit-equal across two calls, and timed alike; its two kernels'
   launches are counted on the paths that train a DIN or a DIEN;
3. writes a full-width DLRM serving checkpoint (13 dense + 26 categorical
   columns, emb dim 16, fused adagrad columns, a 2^21-slot table holding the
   keys of 20 synthetic Criteo batches; weights and rows from seed 0);
4. serves 5 held-out B=4096 batches with Predictor(device="cuda") and with
   Predictor(device="cpu") (the plain versions) and holds the card's
   probabilities to the CPU's; the kernels' launch counts over this run
   (K1, K2, K4) must be above 0; prints the p50 predict latency; no host
   sync of one predict may come from the hash table's modules;
5. serves HTTP over the card's predictor (predict, healthz, a dynamically
   batched pair), writes an incremental save, /refresh-es and checks the
   changed predictions against a CPU predictor refreshed the same way;
6. trains bench.py's --metadata configuration at full width (the DLRM
   above on a host-index table of 2^21 rows with the native resolver,
   CounterFilter(1) + GlobalStepEvict, fused Adagrad, optax-style dense
   Adagrad) on SyntheticCriteo(4096, seed=7): 5 steps in lockstep with a
   CPU Trainer (own resolver, same weights) holding wires and metadata
   planes bit-equal and losses and rows within tolerance, then 3 timed
   runs of 10 steps with the host half staged ahead (bench.py's default
   method) and 3 with it inline, and a torch.profiler breakdown of 3
   steps; K1, K2, K2's backward and K3a (lookup_meta) must have launched;
7. the light layout (bench.py's default, lazy init): 3 steps in lockstep
   with a CPU Trainer, then 3 timed runs of 10 steps; then a bf16 table
   (value_dtype="bfloat16", --metadata, 2^17 rows): 3 steps in lockstep
   with a CPU Trainer (losses within BF16_LOSS_ATOL, rows within
   BF16_ROW_ATOL + BF16_ROW_RTOL |row|), K1, K2 (bf16), K2's backward
   (bf16) and K3a launched;
8. the production loop (``loop``): the --metadata DLRM from a 2^16-row
   table, 30 steps through HostStepPipeline(depth=3) on the card (pinned
   wires copied on a side stream) with a fence every 10 steps: growth
   (maybe_grow), a full save at the first fence and incremental saves
   after it (CheckpointManager). An unpipelined CPU trainer runs the same
   loop: wires bit-equal every step, losses within LOSS_ATOL, metadata
   planes bit-equal and rows within ROW_ATOL at each fence (after which
   the CPU trainer takes the card's rows and weights, so each window of
   steps starts from one state), the same growths and the same key set in
   every save, at least one growth. A
   card Predictor serves the card's full save, then refresh()-es onto the
   incrementals, each time within PROB_ATOL of a CPU Predictor over the
   same directory. K1, K2, K2's backward and K3a must have launched; then
   3 timed runs of 10 pipelined steps and 10 inline steps on the same
   table, each stage on the host clock;
9. tiered storage (``tier``): the --metadata DLRM on a 2^17-row host-index
   table with StorageOption(HBM_DRAM, hbm_capacity=32768) and
   GlobalStepEvict(8), 30 steps through HostStepPipeline(depth=3) with
   fences after steps 12, 22 and 30 (maybe_demote, maybe_grow, a full save,
   then incremental saves) in lockstep with an unpipelined CPU trainer: wires
   and promo planes bit-equal every step, losses within LOSS_ATOL; at each
   fence resolver keys, tier keys and the payloads' integer columns
   bit-equal, rows and payload values within ROW_ATOL, rows demoted at
   every fence and rows promoted in the run. A card TieredPredictor
   (device_row_budget 32768) serves the saves within PROB_ATOL of a CPU
   one and of a card Predictor, before and after refresh(); the last save
   restores into fresh card and CPU trainers alike; two runs of 10
   pipelined steps give examples/s and the demotion fences' times; an
   HBM_DRAM_SSD run (dram_row_budget 4096) spills to its file store and
   its save carries every tier row. The tier store must be the C++ one.
   K1, K2, K2's backward and K3a must have launched;
10. the rest of the CTR zoo (``zoo``): DCN, WDL, DeepFM and DSSM built
   through deeprec_tpu_torch/modelzoo/<M>/train.py build() and
   train.cli.make_trainer under --host_index at full width (emb dim 16;
   Criteo tables of 2^21 rows, DSSM's of 2^19 over SyntheticBehavior(4096)
   with a mean-pooled hist_item of 32; WDL and DeepFM add a dim-1 "wide"
   table trained with sparse_ftrl; DCN, WDL and DeepFM train "emb" with
   sparse_adagrad and the towers with Adagrad, DSSM with sparse_adam and
   Adam, as their --optimizer defaults say; weights drawn from --seed
   0), each: 5 steps in lockstep with a CPU
   Trainer (wires bit-equal, losses within LOSS_ATOL, rows, slot leaves
   and dense parameters within ROW_ATOL), 3 timed runs of 10 staged steps,
   K1, K2 and K2's backward launched, and a save served by a card and a
   CPU Predictor within PROB_ATOL, both holding the trained dense
   parameters. Phase 2 also holds K1, K2 and K2's backward at the
   zoo's new shapes against their plain versions and times them: the wide
   tables' D = 1 and DSSM's [4096, 32] mean (through its int32 inverse
   wire);
11. the sequence models (``seq``): DIN and DIEN built through
   deeprec_tpu_torch/modelzoo/DIN/train.py and DIEN/train.py build() under
   --host_index at the CLI's defaults (emb dim 16; item, cate and uid
   plus the 32-long hist_item and hist_cate sharing item_space and
   cate_space; a 2^19-row table, max_unique 0.75 of the flat ids; DIN's
   MLP (200, 80) with Dice and attention (80, 40); DIEN's gru_units 32 and
   its auxiliary loss through dien_forward; sparse_adam + Adam, 0.002) on
   SyntheticBehavior(4096), each: 5 steps in lockstep with a CPU Trainer
   (wires bit-equal, losses within LOSS_ATOL, rows, slot leaves,
   parameters and the Dice running statistics within ROW_ATOL), 3 timed
   runs of 10 staged steps, a torch.profiler breakdown of 3 steps, K1, K2
   and K2's backward launched (the histories are expanded through K2 as
   one-id bags, and their gradient through K2's backward), the null row
   still zero, and a save served by a card and a CPU Predictor within
   PROB_ATOL, both holding the trained parameters and statistics (one
   function, check_models, runs phases 10 and 11). Phase 2 also
   holds K2 and K2's backward at the expansion shape ([2*4096*32, 1] sum
   over the int32 inverse of one resolved DIN batch) and K1 at DIN's
   205,825 lanes against their plain versions and times them;
12. the entry points: the eight sparse optimizers ported last (adam_async
   also in its RMSProp form) and group_lasso(adagrad) (``optim``), each
   with the dense optimizer the CLI pairs with it (SGD, SGD with
   momentum, Adagrad, Adam) on bench.py's DLRM (the entry point's
   weights) for 5 steps in lockstep with a CPU trainer (losses within
   LOSS_ATOL; rows, float slot leaves and dense parameters within
   ROW_ATOL; the int32 and 0-d slot leaves compared too; for the Adam
   family each step starts the CPU trainer from the card's state, and
   elements whose gradient is sign noise, at most ADAM_NOISE_SHARE of
   them, are left out), then one sparse and one dense apply card vs CPU
   from identical inputs within OPTIM_APPLY_RTOL; the --bf16 DLRM
   forward, card against CPU within
   BF16_FWD_TOL of the largest logit and closer to the CPU's bf16 logits
   than to its f32 ones;
   then the ``cli`` runs: every model through its entry point
   (cli.run(build(args), args), --host_index, B 4096, emb 16, 2^21 rows,
   the towers' full widths, 20 steps with a fence at 10), the ten
   --optimizer choices among ten runs, --bf16 on DLRM and DCN,
   admission and eviction (--ev_filter_freq 2 --ev_evict_steps 10) on DCN,
   and WDL over Criteo files written from SyntheticCriteo through a
   WorkQueue (6 steps), and four runs on the device-index engine (no
   --host_index): DLRM, DIN, DLRM with --micro_batch 2 and DLRM with
   --ev_storage hbm_dram under a row budget of CLI_TIER_HBM (demotion at
   both fences): each run's JSON line finite, its examples/s printed, K1,
   K2 and K2's backward launched (and K3a in the metadata layout); the
   DLRM run with --checkpoint and incremental saves is then served by
   server.build_server over HTTP within PROB_ATOL of a CPU Predictor over
   the same directory;
13. the device-index engine (``device``): the DLRM built through
   deeprec_tpu_torch/modelzoo/DLRM/train.py build() and cli.make_trainer
   without --host_index (B 4096, emb 16, 2^21 rows, --optimizer adagrad
   made fused Adagrad columns, --max_unique_ratio 0.25 so 26,625 lanes,
   --ev_filter_freq 2 --ev_evict_steps 20) on SyntheticCriteo(4096,
   seed=7): DEVICE_STEPS steps in lockstep with a CPU trainer (key
   planes bit-equal every step; metadata planes bit-equal, losses, rows
   and parameters within LOSS_ATOL and ROW_ATOL), 3 timed runs of 10
   staged steps, an eval step, a torch.profiler breakdown (at most 425
   device kernels and copies a step) and the host
   syncs of 3 steps (torch's sync debug mode, by source line; none may
   come from the hash table's modules); K1, K2, K2's backward, K3a, K4
   and K5 must have launched. Then the card's full save (save-time eviction)
   and an incremental save served by card and CPU Predictors within
   PROB_ATOL, before and after refresh(); growth from 2^16 rows
   (maybe_grow after each step: the same capacities and key planes card
   and CPU, at least one growth); --micro_batch 4 in lockstep; and a
   TieredTrainer (--ev_storage hbm_dram, 2^18 slots, hbm_capacity 32,768
   below the live rows, a demotion fence every 3 steps) in lockstep: the
   tiers' keys and integer columns bit-equal, their rows within ROW_ATOL,
   rows demoted and promoted. Phase 2 also holds K1, K2, K2's backward and
   K3a at this engine's shape (one unique_cols dedup and lookup_or_insert
   of a B=4096 batch: int64 inverse and slots) and times them. The host
   syncs it counts no longer include the metrics' histograms or
   normalize_dense (both stay on the device);
14. the variant tables (``variants``): bench.py's DLRM (seeded weights)
   over feature_column_variants' MultiHashCollection (the JAX default
   sub-tables 2^16 and 2^12, add), AdaptiveCollection (2^14 buckets,
   CounterFilter(2), 2^20 rows), DynamicDimCollection (2 blocks of 8, the
   second from 20 lookups, 2^20 rows) and HashTableCollection (CBF(2)
   admission, 2^20 rows), sparse Adagrad(0.5, initial accumulator 0.01)
   and dense Adagrad(0.05), on SyntheticCriteo(4096, seed=7): each 5 steps
   in lockstep with a CPU trainer that starts each step from the card's
   float state (integer state bit-equal every step: index
   keys, id planes, next_id, freqs, versions, CBF; losses, rows, slot
   leaves and parameters within LOSS_ATOL and ROW_ATOL), 3 timed runs of
   10 staged steps, a card save restored by a CPU trainer (the same saved
   arrays) and an eval step on both (AUC and loss within EVAL_ATOL);
   multi-hash mult and
   concat 3 lockstep steps each. K1, K2 and K2's backward launch on every
   run, K3a on adaptive and dynamic dimension, K5 and K4 on the tables
   with an index; no host sync of a staged step may come from the metrics,
   the dynamic-dimension mask or the hash table. Phase 2 also holds K1 at
   the multi-hash sub-table fetch, K2 (both ways) at the multi-hash
   pooling (one row per flat id), and K1, K2 (both ways) and K3a at the
   flat dedup of the tables with an index (26*4096 lanes) and times them;
15. DeepRec checkpoint migration (``migrate``): the committed bundle of
   tests/torch_fixtures/deeprec_bundle through checkpoint.migrate's scan,
   import_tables into a card and a CPU device-index DLRM trainer (2^21
   rows, CounterFilter(2), sparse Adagrad, whose acc slot the bundle's
   Adagrad EV fills) and import_dense of the bottom MLP: imported rows
   bit-equal card and CPU and equal to the fixture script's arrays; the
   offline CLI run as ``python -m deeprec_tpu_torch.checkpoint.migrate``
   writes what _main writes; then 3 steps in lockstep over batches that
   reuse the imported keys and 3 timed runs of 10 staged steps. K1, K2,
   K2's backward and K3a launch;
16. the mesh engine on one rank (``mesh1``): the device phase's DLRM
   through cli.make_trainer with --mesh 1, a ShardedTrainer on a world-1
   NCCL group, 30 steps in lockstep with a CPU twin on a gloo group of
   the same process (every step's loss within LOSS_ATOL and key planes
   bit-equal; metadata planes bit-equal and rows, slot leaves and
   parameters within ROW_ATOL at every 10-step fence, after which the
   twin takes the card's float state) and an eval step; K1, K2, K2's
   backward, K3a, K5 and K4 launched; 5 steps with exact dedup against
   the one-device trainer (the same key -> row map); 3 timed runs of 10
   staged steps, the all_to_all time in the step (CUDA events) and alone
   at the step's widths; the host syncs of one staged step (none from
   the hash table's modules);
17. the mesh engine on four ranks (``mesh4``): this script started 4
   times (``--mesh4-rank R JOB``), every rank on the one card (NCCL takes
   one rank a card) over gloo (over NCCL, rank r on card r, where torch
   sees four cards), 1,024 examples a rank of each B=4096
   batch, each rank in lockstep with a CPU twin on a second gloo group
   for 20 steps, K1, K2, K2's backward, K3a and K5 launched on every rank
   (K4 in the 4-rank ShardedPredictor's predicts),
   3 timed runs of 5 staged steps and the gloo all_to_all's time; then a
   full save of the 4 shards (one part file each) served by the
   one-device Predictor on the card, a 4-rank ShardedPredictor and a
   2-rank one (a reshard), all within PROB_ATOL on 5 held batches. Then,
   on the same ranks, the host-sharded engine (the --metadata DLRM of
   phase 18 with --mesh 4): each rank resolves its slice, the buckets
   cross the host exchange (TCP), HSMESH4_STEPS steps in lockstep with
   CPU twins (wires bit-equal every step, rows at fences), K1, K2, K2's
   backward and K3a launched on every rank, 3 timed runs of 5 staged
   steps with the host exchange's ms a step and exchange_late_steps; its
   4-part save served by the one-device device-index Predictor and a
   2-rank ShardedPredictor within PROB_ATOL. A rank that fails, or a
   phase past MESH4_TIMEOUT_S, fails the smoke. Phase 2 also holds K1 and
   K3a at the owner's shapes of this phase (the S*C received lanes, the
   owner's unique width with the summed multiplicities as counts), and K1,
   K2, K2's backward and K3a at the host-sharded owner's and requester's
   shapes, and times them;
18. the host-sharded engine on one rank (``hsmesh1``): bench.py's DLRM
   (fused Adagrad columns, 2^21 rows, the 0.25 dedup cap) through
   cli.make_trainer with --mesh 1 --host_index on a world-1 NCCL group,
   HS_STEPS --metadata steps (CounterFilter(2), GlobalStepEvict(20)) and
   HS_LIGHT_STEPS light steps in lockstep with a gloo CPU twin (wires
   bit-equal every step; the resolver's keys, metadata planes, rows, slot
   rows and parameters at every 10-step fence, after which the twin takes
   the card's float state); K1, K2, K2's backward and K3a launched;
   HS_EXACT_STEPS exact-dedup steps against the one-device host-index
   Trainer (the same key -> slot map and rows); staged examples/s beside
   the one-device engine's in the same call;
19. TieredShardedTrainer (``tiermesh``), this script started twice
   (``--mesh2-rank R JOB``, gloo on the card): the device phase's DLRM
   with --mesh 2 --ev_storage hbm_dram (2^18 slots a shard,
   hbm_capacity 32,768 over the mesh) in lockstep with CPU twins for
   TIERMESH_STEPS steps, demotion every TIERMESH_FENCE (tiers bit-equal in
   their integer columns, rows within ROW_ATOL, each shard within its
   share), promotion inside the steps; the 2-rank save restores into a
   one-device TieredTrainer on the card, every saved key in one tier;
20. DistributedHashTable (``dht``) on the same two ranks: DHT_STEPS steps
   of gen_ids and apply_cotangent over each rank's half of a batch's 26
   columns beside CPU twins (ids bit-equal, rows within ROW_ATOL), K1
   launched (phase 2 times it at this shape);
21. the server's --mesh 2 (``servemesh``) on the same two ranks over the
   mesh4 phase's save: rank 0 answers SERVE_BATCHES HTTP predicts of
   B rows within PROB_ATOL of the one-device Predictor, refuses a request
   without a column (400, nothing broadcast) and refreshes; closing its
   server stops rank 1. A rank that fails, or phases past
   MESH2_TIMEOUT_S, fail the smoke.

22. the soak (``soak``): deeprec_tpu_torch/harness/soak.py's run at its
   full widths (DCN with cross layers 3 and deep (512, 256, 64), B 4096,
   emb 16, a table from 2^17 rows with CounterFilter(2),
   GlobalStepEvict(SOAK_STEPS_TO_LIVE) and an HBM_DRAM tier, 26*B/6
   dedup lanes), SOAK_FENCES fences of SOAK_FENCE_EVERY steps, a save at
   every fence (the first full; --full-secs 1e9 --incr-secs 0), demotion
   every SOAK_DEMOTE_EVERY fences, the failover at half-time, the held-out
   eval: on the device-index engine (TieredTrainer) and on the host-index
   engine (--host_index: HostStepPipeline(depth=3), the C++ resolver).
   Each engine: at least one growth, the failover losing no step, finite
   losses at every fence, tier rows on the device-index engine; K1, K2,
   K2's backward and K3a launched, and K5 and K4 (the eval) on the
   device-index engine. Each engine runs twice with the same seeds, and
   the two final full saves must be bit-equal in every column: the
   integer ones (keys, freqs, versions, create steps, the tier's keys and
   its payloads' integer columns, the step) and the float ones (value
   rows, slot rows, tier payload values, dense leaves), whose largest
   difference, 0, is printed (ROADMAP C3).
   Prints ms per step (p50, p90, p99, the last 10 fences over the first
   10), growths, saves, the final capacity and tier rows and the eval AUC.
   Phase 2 also holds K1, K2 (both ways), K3a, K5 (first and steady step)
   and K4 at the device-index soak's shape (17,750 lanes into 2^17 slots)
   and times them;
23. the fidelity bisect (``fidelity``):
   deeprec_tpu_torch/harness/sequence_fidelity.py's two arms (planted
   latent item vectors against a random init) of DIN and of DIEN, B
   FIDELITY_B, FIDELITY_STEPS steps, eval every 250 steps on 20 held-out
   batches, beside harness/behavior_oracle.py's ceilings() of the stream:
   each planted arm above bias_repeat and above its random arm. Its
   tables are read by plain indexing: no hand-written kernel is on it;
24. determinism (``determinism``): one step of each one-card training
   path (bench.py's --metadata DLRM on the host-index engine, staged and
   through a HostStepPipeline's copies; the device-index DLRM; the four
   variant tables; DIN and DIEN; the device-index DLRM as --mesh 1 on a
   world-1 NCCL group), each after DETERMINISM_WARM steps at full width,
   run twice from one state and one batch by
   deeprec_tpu_torch/probes/step_bisect.py: every tensor the step makes
   (pooled embeddings, each module's output, the rows' cotangents, every
   gradient, the updated tables, slot states, parameters, buffers, dense
   optimizer state and metrics) bit-equal between the two runs.

The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON, the line before that the training numbers.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B = 4096
CAPACITY = 1 << 21
EMB_DIM = 16
PROB_ATOL = 1e-4   # card vs CPU probabilities: f32 sums in another order
POOL_RTOL = 1e-5   # kernel K2 vs plain: f32 sums in another order
# K2 backward vs plain: a row of more than 32 lanes adds contiguous runs of
# its lanes, then the runs, where the plain version adds in index order; a
# sum of k terms errs by at most ~k*eps of the sum of their magnitudes
BWD_TOL = 1e-4
LOSS_ATOL = 1e-4   # card vs CPU trainer per-step loss (f32, other orders)
ROW_ATOL = 1e-4    # card vs CPU trainer table rows after the lockstep
MAX_UNIQUE = 26 * B // 6  # bench.py's dedup width: U = 17,750 lanes
LOOP_CAPACITY = 1 << 16  # the loop's first table: ~0.9 load by step 10
LOOP_STEPS = 30          # the loop's lockstep run: fences after 12, 22, 30
K3B_U = 17664      # benchmarks/pallas_meta_bench.py's own U (and CAP 2^21)
# bf16 kernels vs plain: both sum in f32 and round once, so the f32 sums'
# order can move that rounding by one bf16 step: at most 2^-7 of the
# value (8 significant bits)
BF16_STEP = 2.0 ** -7
BF16_LOSS_ATOL = 1e-3  # bf16 table, card vs CPU per-step loss
# bf16 table rows: a gradient rounded one step apart on the two sides
# moves an updated row by about one step: allow four steps, and 1e-3
BF16_ROW_RTOL, BF16_ROW_ATOL = 2.0 ** -6, 1e-3
TIER_CAPACITY = 1 << 17  # the tier phase's table
TIER_HBM = 32768         # its hbm_capacity, and TieredPredictor's budget
TIER_LIVE = 8            # GlobalStepEvict(steps_to_live) of the tier phase
TIER_STEPS = 30          # lockstep steps; a fence every 10
SSD_DRAM_ROWS = 4096     # the SSD run's dram_row_budget
ZOO_MODELS = ("dcn", "wdl", "deepfm", "dssm")
ZOO_STEPS = 5            # each zoo model's lockstep steps
ZOO_DSSM_CAPACITY = 1 << 19  # the CLI's --capacity default
SEQ_MODELS = ("din", "dien")
SEQ_STEPS = 5            # each sequence model's lockstep steps
SEQ_HIST = 32            # modelzoo/DIN and DIEN's MAX_LEN
OPTIM_STEPS = 5          # each new sparse optimizer's lockstep steps
# The Adam family in lockstep: Adam steps an element by about
# lr*m/(sqrt(v) + eps) whatever the gradient's scale, so an element whose
# gradient is near zero may step by up to lr one way on the card and the
# other way on the CPU, which sum in other orders (cuBLAS against the
# CPU's GEMMs, K2-bwd's atomics against index order), and the difference
# then spreads through the model. So each step starts the CPU trainer
# from the card's state, and rows and dense parameters are held within
# ROW_ATOL except where the first moment m (the step's direction) differs
# between card and CPU by more than ADAM_M_RTOL of the CPU's: there the
# gradient is sign noise. At most ADAM_NOISE_SHARE of the elements Adam
# stepped may be left out, so a wrong moment fails too. Measured (NVIDIA
# H100 80GB HBM3, 700.00 W): the elements over 1e-4 had |g| <= 1.7e-6
# against a largest |g| of 0.07; kept elements within 3.5e-5; at most
# 0.38 % left out (one dense step of adam_async).
ADAM_M_RTOL = 0.03
ADAM_NOISE_SHARE = 0.01
# one optimizer apply (sparse or dense), card vs CPU from identical
# inputs: f32 arithmetic (rsqrt, pow, sqrt) that may differ by an ulp or
# two, relative to the largest magnitude of each array
OPTIM_APPLY_RTOL = 1e-6
CLI_STEPS = 20           # each cli run's steps ...
CLI_FENCE = 10           # ... with a fence at every 10
CLI_CRITEO_STEPS = 6     # the run over Criteo files (Python reader)
CLI_TIER_HBM = 65536     # the device-index hbm_dram run's row budget
# phase 13, the device-index engine: the DLRM's flags beside B, emb dim,
# capacity and seed (fused Adagrad, the 0.25 dedup cap, CounterFilter(2)
# and GlobalStepEvict(20): the metadata layout, so K3a on the path)
DEVICE_FLAGS = ["--optimizer", "adagrad", "--max_unique_ratio", "0.25",
                "--ev_filter_freq", "2", "--ev_evict_steps", "20"]
DEVICE_STEPS = 5         # the main run's lockstep steps
DEVICE_GROW_CAPACITY = 1 << 16  # the growth run's first table ...
DEVICE_GROW_STEPS = 6    # ... grown at a fence after every step
DEVICE_MB_STEPS = 3      # --micro_batch 4 lockstep steps
DEVICE_TIER_CAPACITY = 1 << 18  # the TieredTrainer's table,
DEVICE_TIER_HBM = 32768  # its hbm_capacity (below the live rows),
DEVICE_TIER_STEPS = 9    # its lockstep steps,
DEVICE_TIER_FENCE = 3    # a demotion fence every 3
VARIANT_CAPACITY = 1 << 20  # phase 14: the variant tables with an index
VARIANT_STEPS = 5        # each variant's lockstep steps ...
VARIANT_MODE_STEPS = 3   # ... multi-hash mult and concat's
MIGRATE_STEPS = 3        # phase 15: lockstep steps after the import
MESH_STEPS = 30          # phase 16 (mesh1): lockstep steps ...
MESH_FENCE = 10          # ... the CPU twin re-anchored every 10
MESH4_RANKS = 4          # phase 17 (mesh4): rank processes on the card,
MESH4_STEPS = 20         # their lockstep steps,
MESH4_TIMEOUT_S = 300    # and the phase's limit
HS_STEPS = 30            # phase 18 (hsmesh1): --metadata lockstep steps,
HS_LIGHT_STEPS = 10      # the light layout's,
HS_EXACT_STEPS = 5       # and the exact-dedup steps beside one device
HSMESH4_STEPS = 10       # phase 17's host-sharded lockstep steps a rank
MESH2_RANKS = 2          # phases 19-21 (tiermesh, dht, servemesh): ranks
MESH2_TIMEOUT_S = 300    # on the card, and their limit
TIERMESH_CAPACITY = 1 << 18  # tiermesh: each shard's slots,
TIERMESH_HBM = 32768     # the table's hbm_capacity (half a shard),
TIERMESH_STEPS = 9       # lockstep steps,
TIERMESH_FENCE = 3       # a demotion fence every 3
DHT_CAPACITY = 1 << 19   # dht: each partition's ids,
DHT_STEPS = 5            # its training steps
SERVE_BATCHES = 3        # servemesh: HTTP predicts of B rows
# phase 22 (soak): harness.soak at its defaults (DCN, B 4096, emb 16, a
# 2^17-row table, CounterFilter(2), HBM_DRAM, 26*B/6 dedup lanes), driven
# by fences, a save at every fence (the first full), twice per engine
SOAK_FENCES = 20         # fences a run (the failover at the 10th) ...
SOAK_FENCE_EVERY = 10    # ... of 10 steps,
SOAK_STEPS_TO_LIVE = 20  # GlobalStepEvict(20),
SOAK_DEMOTE_EVERY = 2    # a demotion sweep every 2 fences
# phase 23 (fidelity): harness.sequence_fidelity, both arms of DIN and
# DIEN at the JAX script's B and eval cadence, for FIDELITY_STEPS steps
DETERMINISM_WARM = 2     # phase 24: steps before the step run twice
FIDELITY_STEPS = 500
FIDELITY_B = 2048
# an eval step's AUC and loss, card vs CPU: the AUC is a histogram of 1024
# bins, and a probability within rounding of a bin edge lands on the other
# side on the other device, each such example moving the AUC by about
# 1e-6 at B 4096 (one did so, 1.4e-6, in a card run of phase 14)
EVAL_ATOL = 1e-5
# bf16 towers, card vs CPU: cuBLAS and the CPU sum a product's terms in
# another order, so a bf16 rounding may land one step apart (2^-8 to 2^-7
# of the value: the logits leave the bf16 head rounded) and carry through
# the towers' six layers: within 2^-7 of the largest logit; and the card
# computes the bf16 function: its mean distance from the CPU's bf16
# logits is under half their mean distance from the f32 model's
BF16_FWD_TOL = 2.0 ** -7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak (the card's power limit printed)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, samples=21, per_sample=20, warmup=5):
    """Device ms per call of ``fn``: the median over ``samples`` of the
    CUDA-event time around ``per_sample`` back-to-back calls, divided by
    ``per_sample``. A sleep kernel queued first holds the stream while the
    host enqueues the calls, so the host's launch overhead is not in the
    reading (L2 not flushed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of cycles
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return statistics.median(times)


def behind_ms(fn, samples=21, alone=None):
    """Device ms per call of ``fn`` behind a one-element PyTorch add, as on
    the training path, where a PyTorch kernel (which never lets a
    programmatic dependent start early) precedes each kernel: the time of
    the pair less the add's own (``alone``, when the caller has it).
    Back to back, a kernel launched as a programmatic dependent also
    overlaps its own previous call."""
    tiny = torch.zeros(1, device="cuda")
    if alone is None:
        alone = time_ms(lambda: tiny.add_(1), samples)

    def pair():
        tiny.add_(1)
        fn()
    return time_ms(pair, samples) - alone


def call_ms(fn, reset, samples=21, behind=False):
    """Device ms of one call of ``fn`` (the median over ``samples``), each
    sample timed alone between CUDA events after ``reset()`` (outside the
    events) and a sleep kernel that holds the stream while the host
    enqueues: for a call that changes its inputs (an insert into a table),
    which ``reset`` restores. ``behind``: behind a one-element add, the
    add's own time (timed the same way) subtracted."""
    tiny = torch.zeros(1, device="cuda")

    def one(f):
        times = []
        for _ in range(samples + 2):  # the first two warm up
            reset()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            if behind:
                tiny.add_(1)
            f()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[2:])
    alone = one(lambda: None) if behind else 0.0
    return one(fn) - alone


def wall_ms(fn, calls=100):
    """Host-clock ms per call over ``calls`` back-to-back calls, including
    the host's launch overhead (what a caller on the serving path pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def bound(nbytes):
    """(bound_ms, bytes): the least time to move ``nbytes`` at peak HBM
    rate. The kernels here do a few operations per byte, far below the
    card's compute peaks, so bytes bound them all."""
    return nbytes / HBM_BYTES_PER_S * 1e3, int(nbytes)


def entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes,
          **extra):
    bound_ms, nbytes = bound(nbytes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "bytes": nbytes, **extra}


def log_times(what, ms, plain_ms, library_ms, nbytes, extra=""):
    bms, _ = bound(nbytes)
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib} ms, bound {bms:.4f} ms ({nbytes} bytes at 3.35 TB/s){extra}")


def criteo_parts():
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.criteo import CAT_NAMES, DENSE_NAMES
    from deeprec_tpu_torch.models.ctr import DLRM
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
            for n in CAT_NAMES]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=CAPACITY,
        initializer=cfg.Initializer("normal", scale=0.05))
    model = DLRM(CAT_NAMES, EMB_DIM, bottom_units=(512, 256),
                 top_units=(1024, 1024, 512, 256), dense_dim=len(DENSE_NAMES))
    return numeric, coll, model


# -- phase 2 -----------------------------------------------------------------
def check_kernels(dev):
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import (
        COMBINERS, fused_pooled_lookup, fused_pooled_lookup_plain)
    from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from deeprec_tpu_torch.ops.unique import unique

    g = torch.Generator(device="cpu").manual_seed(SEED)
    # the serving path's shapes: the unique keys of one B=4096 batch
    _, coll, _ = criteo_parts()
    batch = next(SyntheticCriteo(batch_size=B, seed=11))
    uniq = unique(coll.pack_ids(batch, dev).reshape(-1))
    n_slots = uniq.ukeys.shape[0]
    table = torch.randn(CAPACITY + 1, 2 * EMB_DIM, generator=g).to(dev)
    slots = torch.randint(0, CAPACITY, (n_slots,), generator=g).to(dev)
    # EMPTY padding lanes read the null row, as on the serving path
    slots = torch.where(uniq.ukeys == -1, CAPACITY, slots)
    log(f"K1 shape: values {tuple(table.shape)} f32, slots [{n_slots}] "
        f"({int(uniq.n_unique)} unique keys), d_out {EMB_DIM}")
    got = gather_rows(table, slots, EMB_DIM)
    ref = gather_rows_plain(table, slots, EMB_DIM)
    k1_err = (got - ref).abs().max().item()
    if k1_err != 0:
        fail(f"K1 differs from its plain version by {k1_err}")
    k1_ms = time_ms(lambda: gather_rows(table, slots, EMB_DIM))
    k1_path = behind_ms(lambda: gather_rows(table, slots, EMB_DIM))
    k1_plain = time_ms(lambda: gather_rows_plain(table, slots, EMB_DIM))
    log(f"K1 gather_rows: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms "
        f"(device); host clock per call: kernel "
        f"{wall_ms(lambda: gather_rows(table, slots, EMB_DIM)):.4f} ms, plain "
        f"{wall_ms(lambda: gather_rows_plain(table, slots, EMB_DIM)):.4f} ms;"
        f" max_abs_err {k1_err}")

    # K2 on the path: 26 width-1 columns pooled in one [26*B, 1] launch
    urows = got
    inv = uniq.inverse.view(-1, 1)
    valid = (uniq.ukeys != -1)[uniq.inverse].view(-1, 1)
    cases = [("criteo 26 x width-1", urows, inv, valid, "sum")]
    for d in (16, 128):
        vals = torch.randn(n_slots, d, generator=g).to(dev)
        ms = torch.randint(-1, n_slots + 1, (B, 8), generator=g).to(dev)
        mv = (torch.rand(B, 8, generator=g) < 0.7).to(dev)
        mv[0] = False
        cases += [(f"multi-hot [B, 8] D={d}", vals, ms, mv, c)
                  for c in COMBINERS]
    k2_err, times = 0.0, {}
    for name, v, s, m, comb in cases:
        got2 = fused_pooled_lookup(v, s, m, comb)
        ref2 = fused_pooled_lookup_plain(v, s, m, comb)
        torch.testing.assert_close(got2, ref2, rtol=POOL_RTOL, atol=1e-6)
        err = (got2 - ref2).abs().max().item()
        k2_err = max(k2_err, err)
        kt = time_ms(lambda: fused_pooled_lookup(v, s, m, comb))
        pt = time_ms(lambda: fused_pooled_lookup_plain(v, s, m, comb))
        times[name, comb] = (kt, pt)
        log(f"K2 fused_pooled_lookup {name} {comb} "
            f"(bags {tuple(s.shape)}, D {v.shape[1]}): kernel {kt:.4f} ms, "
            f"plain {pt:.4f} ms (device); host clock per call: kernel "
            f"{wall_ms(lambda: fused_pooled_lookup(v, s, m, comb)):.4f} ms, "
            f"plain "
            f"{wall_ms(lambda: fused_pooled_lookup_plain(v, s, m, comb)):.4f}"
            f" ms; max_abs_err {err:.3g}")
    k2_ms, k2_plain = times["criteo 26 x width-1", "sum"]

    # one PyTorch call computing the same function, as the yardstick
    k1_lib = time_ms(lambda: torch.index_select(table[:, :EMB_DIM], 0, slots))
    k1_bytes = (slots.numel() * slots.element_size()
                + torch.unique(slots).numel() * EMB_DIM * 4
                + n_slots * EMB_DIM * 4)
    log_times("K1 gather_rows (serving shape)", k1_ms, k1_plain, k1_lib,
              k1_bytes, f"; library: torch.index_select; on path "
              f"{k1_path:.4f} ms")
    valid_f = valid.float()
    k2_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        inv, urows, per_sample_weights=valid_f, mode="sum"))
    k2_bytes = (inv.numel() * inv.element_size() + valid.numel()
                + int(uniq.n_unique) * EMB_DIM * 4 + inv.shape[0] * EMB_DIM * 4)
    k2_path = behind_ms(lambda: fused_pooled_lookup(urows, inv, valid, "sum"))
    log_times("K2 fused_pooled_lookup (serving shape, [26*4096, 1] sum)",
              k2_ms, k2_plain, k2_lib, k2_bytes,
              f"; library: embedding_bag(mode='sum', per_sample_weights); "
              f"on path {k2_path:.4f} ms")

    # the serving path's order: K1, then K2 on K1's rows
    def pair():
        return fused_pooled_lookup(gather_rows(table, slots, EMB_DIM), inv,
                                   valid, "sum")
    if not torch.equal(bits(pair()), bits(fused_pooled_lookup_plain(
            gather_rows_plain(table, slots, EMB_DIM), inv, valid, "sum"))):
        fail("the K1 -> K2 pair differs from its plain versions")
    pair_ms, pair_path = time_ms(pair), behind_ms(pair)
    log(f"K1 -> K2 pair (serving shape, [26*4096, 1] sum): {pair_ms:.4f} ms "
        f"back to back, on path {pair_path:.4f} ms")

    # K2 on a bf16 table: the same bags over bf16 rows (one row a bag: the
    # rows' bits), and a multi-hot mean summed in f32 and rounded once
    u16 = urows.to(torch.bfloat16)
    got16 = fused_pooled_lookup(u16, inv, valid, "sum")
    if not torch.equal(got16.view(torch.int16),
                       fused_pooled_lookup_plain(u16, inv, valid,
                                                 "sum").view(torch.int16)):
        fail("K2 at bf16 (width 1) differs from its plain version")
    v16 = cases[1][1].to(torch.bfloat16)
    ms_, mv_ = cases[1][2], cases[1][3]
    got_mh = fused_pooled_lookup(v16, ms_, mv_, "mean").float()
    ref_mh = fused_pooled_lookup_plain(v16, ms_, mv_, "mean").float()
    mag = fused_pooled_lookup_plain(v16.float().abs(), ms_, mv_, "mean")
    k2b_err = (got_mh - ref_mh).abs().max().item()
    if not bool(((got_mh - ref_mh).abs() <= BF16_STEP * ref_mh.abs()
                 + POOL_RTOL * mag).all()):
        fail(f"K2 at bf16 (multi-hot mean) differs from its plain version "
             f"by {k2b_err}")
    k2b_ms = time_ms(lambda: fused_pooled_lookup(u16, inv, valid, "sum"))
    k2b_plain = time_ms(lambda: fused_pooled_lookup_plain(u16, inv, valid,
                                                          "sum"))
    valid16 = valid.to(torch.bfloat16)
    k2b_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        inv, u16, per_sample_weights=valid16, mode="sum"))
    k2b_bytes = (inv.numel() * inv.element_size() + valid.numel()
                 + int(uniq.n_unique) * EMB_DIM * 2
                 + inv.shape[0] * EMB_DIM * 2)
    log_times("K2 fused_pooled_lookup at bf16 (serving shape, [26*4096, 1] "
              "sum)", k2b_ms, k2b_plain, k2b_lib, k2b_bytes,
              f"; library: embedding_bag at bf16; multi-hot mean max_abs_err "
              f"{k2b_err:.3g}")
    return [
        entry("gather_rows", "deeprec_tpu_torch/csrc/gather_rows.cu",
              "deeprec_tpu/ops/pallas_gather.py:78", k1_err, k1_ms,
              k1_plain, k1_lib, k1_bytes, on_path_ms=k1_path,
              k1_k2_pair_ms=pair_ms, k1_k2_pair_on_path_ms=pair_path),
        entry("fused_pooled_lookup",
              "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
              "deeprec_tpu/ops/pallas_fused_lookup.py:80", k2_err, k2_ms,
              k2_plain, k2_lib, k2_bytes, on_path_ms=k2_path),
        entry("fused_pooled_lookup_bf16",
              "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
              "deeprec_tpu/ops/pallas_fused_lookup.py:80", k2b_err, k2b_ms,
              k2b_plain, k2b_lib, k2b_bytes),
    ]


# -- phase 2: DLRM's dot interaction -------------------------------------------
INTER_B, INTER_F = 65536, 27  # the benchmark cell's batch; bottom + 26 columns
INTER_RTOL = 1e-5  # kernel vs plain, of the magnitudes a sum adds: f32 order


def check_interaction_kernels(dev):
    """DLRM's dot interaction at the benchmark cell's shape [INTER_B,
    INTER_F, EMB_DIM]: both kernels held to the plain forward and its
    autograd backward (a bmm, a tril_indices gather, the index backward and
    batched GEMMs) on the same card tensors (within INTER_RTOL of the
    magnitudes each sum adds), each bit-equal across two calls, and timed
    back to back and behind a one-element add, beside the plain path
    (device time by kernel from torch.profiler) and the HBM bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeprec_tpu_torch.ops.interaction import (
        dot_interaction, dot_interaction_backward, dot_interaction_plain)

    g = torch.Generator(device="cpu").manual_seed(SEED)
    b, f, d = INTER_B, INTER_F, EMB_DIM
    pairs = f * (f - 1) // 2
    feats = torch.randn(b, f, d, generator=g).to(dev)
    grad = torch.randn(b, pairs, generator=g).to(dev)

    def plain_backward(x, gr):  # autograd through the plain forward
        x = x.detach().requires_grad_(True)
        dot_interaction_plain(x).backward(gr)
        return x.grad

    errs = {}
    for what, kernel, plain, args in (
            ("forward", dot_interaction, dot_interaction_plain, (feats,)),
            ("backward", dot_interaction_backward, plain_backward,
             (feats, grad))):
        got = kernel(*args)
        if not torch.equal(got.view(torch.int32),
                           kernel(*args).view(torch.int32)):
            fail(f"dot interaction {what}: two calls differ")
        ref = plain(*args)
        mag = plain(*(a.abs() for a in args))
        errs[what] = (got - ref).abs().max().item()
        if not bool(((got - ref).abs() <= INTER_RTOL * mag).all()):
            fail(f"dot interaction {what} differs from its plain version by "
                 f"{errs[what]}")

    x = feats.clone().requires_grad_(True)

    def plain_path():  # the step's interaction before the kernels
        dot_interaction_plain(x).backward(grad)
        x.grad = None

    ms = {"forward": time_ms(lambda: dot_interaction(feats)),
          "backward": time_ms(lambda: dot_interaction_backward(feats, grad))}
    alone = time_ms(lambda: torch.zeros(1, device=dev).add_(1))
    on_path = {"forward": behind_ms(lambda: dot_interaction(feats),
                                    alone=alone),
               "backward": behind_ms(
                   lambda: dot_interaction_backward(feats, grad),
                   alone=alone)}
    plain = {"forward": time_ms(lambda: dot_interaction_plain(feats)),
             "path": time_ms(plain_path)}
    plain["backward"] = plain["path"] - plain["forward"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            plain_path()
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_kernel = sorted(((e.key[:90], getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        / 1e3 / 5, e.count / 5) for e in ka), key=lambda t: -t[1])
    log(f"dot interaction's plain path (forward + autograd backward) at "
        f"[{b}, {f}, {d}]: {plain['path']:.4f} ms; by kernel (ms, calls):")
    for key, kms, calls in by_kernel:
        log(f"  {kms:8.4f} ms {calls:4.1f}  {key}")
    size = 4 * b * f * d
    nbytes = {"forward": size + 4 * b * pairs,
              "backward": 4 * b * pairs + 2 * size}
    out = []
    for what, name in (("forward", "dot_interaction"),
                       ("backward", "dot_interaction_backward")):
        # plain backward: the plain path less its forward
        log_times(f"dot interaction {what} [{b}, {f}, {d}]", ms[what],
                  plain[what], None, nbytes[what],
                  f"; on path {on_path[what]:.4f} ms; max_abs_err "
                  f"{errs[what]:.3g}")
        out.append(entry(name, "deeprec_tpu_torch/csrc/dot_interaction.cu",
                         None, errs[what], ms[what], plain[what], None,
                         nbytes[what], on_path_ms=on_path[what],
                         plain_path_ms=plain["path"],
                         plain_by_kernel=by_kernel if what == "forward"
                         else None))
    total = sum(bound(n)[0] for n in nbytes.values())
    log(f"dot interaction forward + backward: kernels {sum(ms.values()):.4f}"
        f" ms, on path {sum(on_path.values()):.4f} ms, plain path "
        f"{plain['path']:.4f} ms, bound {total:.4f} ms")
    return out


# -- phase 2: DIEN's GRU and AUGRU recurrences --------------------------------
# the benchmark cell's batch and history; emb 18 (item + category: d 36),
# GRU and AUGRU 36
REC_B, REC_L, REC_D, REC_G = 16384, 100, 36, 36
# kernels vs the loop, of each tensor's largest magnitude: f32 sums in
# another order over 72 terms a step, 100 steps and B L positions
REC_RTOL = 1e-4
F32_FLOPS = 67e12  # H100 SXM f32 FMA peak


def check_recurrence_kernels(dev):
    """DIEN's two recurrences at the benchmark cell's shape [REC_B, REC_L,
    REC_D], the lengths drawn as the cell's traffic draws them: the modules
    on the card (the kernels) held to their loop on the same card tensors
    (the output, the input, attention and parameter gradients, within
    REC_RTOL of each tensor's largest magnitude), the backward bit-equal
    across two calls, and timed: each kernel alone, the path (the forward
    with its sort; the backward with the weight gradients' product), the
    loop, and the bound (bytes at 3.35 TB/s against the valid positions'
    FLOPs at the f32 peak)."""
    from perfbench.generators.behavior import lengths

    from deeprec_tpu_torch.models.layers import AUGRU, GRU
    from deeprec_tpu_torch.ops.recurrence import (act_width, gru_scan,
                                                  gru_scan_backward)

    with open(os.path.join(REPO, "perfbench", "traffic",
                           "amazon_books_behavior.json")) as f:
        mix = json.load(f)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    lens = lengths(mix, torch.rand(REC_B, generator=g, dtype=torch.float64))
    mask = (torch.arange(REC_L)[None, :] < lens[:, None]).to(dev)
    n_valid = int(mask.sum())
    xs = (torch.randn(REC_B, REC_L, REC_D, generator=g) * 0.5).to(dev)
    att = torch.rand(REC_B, REC_L, generator=g).to(dev) * mask
    att = att / att.sum(1, keepdim=True).clamp_min(1e-6)
    log(f"recurrences at [{REC_B}, {REC_L}, {REC_D}], g {REC_G}: "
        f"{n_valid} valid positions of {REC_B * REC_L} "
        f"({100 * n_valid / (REC_B * REC_L):.1f} %), lengths "
        f"{int(lens.min())}-{int(lens.max())}")
    out = []
    for kind in ("gru", "augru"):
        torch.manual_seed(SEED)
        m = (GRU if kind == "gru" else AUGRU)(REC_D, REC_G).to(dev)
        a = att if kind == "augru" else None
        weights = tuple(w.detach() for w in m.cell.weights())
        x = xs.clone().requires_grad_(True)
        at = att.clone().requires_grad_(kind == "augru")

        def call(run):
            return run(x, mask) if kind == "gru" else run(x, at, mask)

        def step(run, up=None):
            m.zero_grad(set_to_none=True)
            x.grad = at.grad = None
            y = call(run)
            if up is None:
                up = torch.randn(y.shape, generator=torch.Generator(
                    device="cpu").manual_seed(SEED + 1)).to(dev)
            y.backward(up)
            grads = [x.grad] + ([at.grad] if kind == "augru" else [])
            return ([y.detach()] + grads
                    + [p.grad.clone() for p in m.parameters()]), up

        want, up = step(m._scan)
        got, _ = step(m, up)
        again, _ = step(m, up)
        names = ["output", "d_xs"] + (["d_att"] if kind == "augru" else []) \
            + [n for n, _ in m.named_parameters()]
        errs = {}
        for name, w_, g_, a_ in zip(names, want, got, again):
            if not torch.equal(g_, a_):
                fail(f"{kind} recurrence: two calls differ in {name}")
            errs[name] = ((g_ - w_).abs().max() / w_.abs().max()).item()
            if not errs[name] <= REC_RTOL:
                fail(f"{kind} recurrence: {name} differs from the loop by "
                     f"{errs[name]:.3g} of its largest magnitude")

        # timings: the kernels alone, the path, the loop
        y, hs, gates, span, order = gru_scan(xs, mask, weights, a, save=True)
        d_out = up.contiguous()
        ms = {"forward": time_ms(lambda: gru_scan(xs, mask, weights, a,
                                                  save=True)),
              "backward": time_ms(lambda: gru_scan_backward(
                  d_out, xs, mask, weights[0], weights[2], a, hs, gates,
                  span, order))}
        with torch.no_grad():
            ms["eval"] = time_ms(lambda: call(m))

        def path(run, backward=True):
            y_ = call(run)
            if backward:
                y_.backward(d_out)
            m.zero_grad(set_to_none=True)
            x.grad = at.grad = None

        on_path = {"forward": time_ms(lambda: path(m, False))}
        on_path["backward"] = time_ms(lambda: path(m)) - on_path["forward"]
        plain = {"forward": time_ms(lambda: path(m._scan, False), samples=5,
                                    per_sample=2, warmup=1)}
        plain["backward"] = time_ms(lambda: path(m._scan), samples=5,
                                    per_sample=2, warmup=1) - plain["forward"]
        # bytes each direction needs at these inputs, read or written once
        b_, l_, d_, g_ = REC_B, REC_L, REC_D, REC_G
        a_bytes = 4 * b_ * l_ if kind == "augru" else 0
        out_bytes = 4 * b_ * (l_ if kind == "gru" else 1) * g_
        nbytes = {
            "forward": (4 * n_valid * d_ + b_ * l_ + a_bytes + out_bytes
                        + (4 * n_valid * g_ if kind == "augru" else 0)
                        + 4 * n_valid * 3 * g_),
            "backward": (out_bytes + b_ * l_ + a_bytes
                         + 4 * n_valid * (d_ + 4 * g_)
                         + 4 * b_ * l_ * (d_ + 3 * g_ + act_width(d_, g_))
                         + a_bytes)}
        flops = 2 * n_valid * (d_ + g_) * 3 * g_  # each direction
        for what in ("forward", "backward"):
            fbound = flops / F32_FLOPS * 1e3
            name = "gru_scan" if what == "forward" else "gru_scan_backward"
            log_times(f"{kind} recurrence {what} [{b_}, {l_}, {d_}]",
                      ms[what], plain[what], None, nbytes[what],
                      f"; FLOP bound {fbound:.4f} ms ({flops} FLOPs of the "
                      f"valid positions at 67 TFLOP/s); on path "
                      f"{on_path[what]:.4f} ms"
                      + (f"; no-grad forward {ms['eval']:.4f} ms"
                         if what == "forward" else ""))
            out.append(entry(f"{name}_{kind}",
                             "deeprec_tpu_torch/csrc/gru_scan.cu", None,
                             max(errs.values()), ms[what], plain[what], None,
                             nbytes[what], on_path_ms=on_path[what],
                             flops=flops, flop_bound_ms=fbound,
                             eval_ms=ms["eval"] if what == "forward"
                             else None, rel_errs=errs, counter=name,
                             path="seq_dien"))
        log(f"{kind} recurrence forward + backward: kernels "
            f"{ms['forward'] + ms['backward']:.4f} ms, on path "
            f"{on_path['forward'] + on_path['backward']:.4f} ms, loop "
            f"{plain['forward'] + plain['backward']:.4f} ms; worst error "
            f"against the loop {errs}")
        del want, got, again, y, hs, gates
    return out


# -- phase 2: DIN's attention unit (DIEN's attention scores) -----------------
# the DIEN cell's attention: [REC_B, REC_L] positions, keys and query of
# REC_G, hidden layers 80 and 40
ATT_HIDDEN = (80, 40)
# kernels vs the plain code, of each tensor's largest magnitude: f32 sums
# in another order (the first layer regrouped, the parameter gradients
# over 225,000 positions); att_out's bias gradient, zero but for
# round-off, against the sum of its terms' magnitudes
ATT_RTOL, ATT_DB3_SHARE = 1e-4, 1e-5


def check_attention_kernels(dev):
    """DIN's attention unit at the DIEN cell's shape [REC_B, REC_L,
    REC_G], the lengths drawn as the cell's traffic draws them, for DIEN's
    unscaled scores and DIN's scaled ones: the module on the card (the
    kernels) held to its plain code on the same card tensors (the weights,
    the query's, the keys' and the six parameters' gradients, within
    ATT_RTOL of each tensor's largest magnitude), the backward bit-equal
    across two calls, and timed: each kernel alone, the path (the module's
    forward; its backward through autograd), the plain code, and the
    bound (bytes at 3.35 TB/s against the FLOPs of the regrouped layer at
    the f32 peak: 2g h1 + h1 h2 + h2 multiply-adds a valid position and
    the query's share, g h1, an example; twice those for the backward)."""
    from perfbench.generators.behavior import lengths

    from deeprec_tpu_torch.models.layers import DINAttention
    from deeprec_tpu_torch.models.sequence import DINAttentionScores
    from deeprec_tpu_torch.ops.din_attention import (din_attention,
                                                     din_attention_backward)

    with open(os.path.join(REPO, "perfbench", "traffic",
                           "amazon_books_behavior.json")) as f:
        mix = json.load(f)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    lens = lengths(mix, torch.rand(REC_B, generator=g, dtype=torch.float64))
    mask = (torch.arange(REC_L)[None, :] < lens[:, None]).to(dev)
    n_valid = int(mask.sum())
    keys = torch.tanh(torch.randn(REC_B, REC_L, REC_G, generator=g)).to(dev)
    query = torch.randn(REC_B, REC_G, generator=g).to(dev)
    up = torch.randn(REC_B, REC_L, generator=g).to(dev)
    h1, h2 = ATT_HIDDEN
    log(f"attention at [{REC_B}, {REC_L}, {REC_G}], hidden {h1}-{h2}: "
        f"{n_valid} valid positions of {REC_B * REC_L} "
        f"({100 * n_valid / (REC_B * REC_L):.1f} %)")
    out = []
    for kind in ("dien", "din"):
        torch.manual_seed(SEED)
        m = (DINAttentionScores if kind == "dien" else DINAttention)(
            REC_G, ATT_HIDDEN).to(dev)
        params = tuple(p.detach() for p in (
            m.att[0].weight, m.att[0].bias, m.att[1].weight, m.att[1].bias,
            m.att_out.weight, m.att_out.bias))
        scale = 1.0 / math.sqrt(REC_G) if m.scaled else 1.0
        q = query.clone().requires_grad_(True)
        k = keys.clone().requires_grad_(True)

        def step(run):
            m.zero_grad(set_to_none=True)
            q.grad = k.grad = None
            w = run(q, k, mask)
            w.backward(up)
            return [w.detach(), q.grad, k.grad] + [
                p.grad.clone() for p in m.parameters()]

        want, got, again = step(m._plain), step(m.weights), step(m.weights)
        names = ["weights", "d_query", "d_keys"] + [
            n for n, _ in m.named_parameters()]
        w = want[0]
        ds_sum = (w * (up - (w * up).sum(1, keepdim=True))).abs().sum() \
            * scale
        errs = {}
        for name, w_, g_, a_ in zip(names, want, got, again):
            if not torch.equal(g_, a_):
                fail(f"{kind} attention: two calls differ in {name}")
            if name == "att_out.bias":
                errs[name] = ((g_ - w_).abs().max() / ds_sum).item()
                limit = ATT_DB3_SHARE
            else:
                errs[name] = ((g_ - w_).abs().max() / w_.abs().max()).item()
                limit = ATT_RTOL
            if not errs[name] <= limit:
                fail(f"{kind} attention: {name} differs from the plain "
                     f"code by {errs[name]:.3g} of its scale")
        if got[0][~mask].any() or got[2][~mask].any():
            fail(f"{kind} attention: a padded position has a weight or a "
                 f"key gradient")

        # timings: the kernels alone, the path, the plain code
        wts = din_attention(query, keys, mask, params, scale)
        ms = {"forward": time_ms(lambda: din_attention(
                  query, keys, mask, params, scale)),
              "backward": time_ms(lambda: din_attention_backward(
                  up, query, keys, mask, params, wts, scale))}
        with torch.no_grad():
            ms["eval"] = time_ms(lambda: m.weights(query, keys, mask))

        def path(run, backward=True):
            w_ = run(q, k, mask)
            if backward:
                w_.backward(up)
            m.zero_grad(set_to_none=True)
            q.grad = k.grad = None

        on_path = {"forward": time_ms(lambda: path(m.weights, False))}
        on_path["backward"] = time_ms(lambda: path(m.weights)) - \
            on_path["forward"]
        plain = {"forward": time_ms(lambda: path(m._plain, False),
                                    samples=5, per_sample=2, warmup=1)}
        plain["backward"] = time_ms(lambda: path(m._plain), samples=5,
                                    per_sample=2, warmup=1) - \
            plain["forward"]
        # bytes each direction needs at these inputs, read or written once:
        # the mask, the valid keys, the query, the weights (and their
        # gradient); the backward writes every key gradient and d_query
        b_, l_, g_ = REC_B, REC_L, REC_G
        nbytes = {
            "forward": (b_ * l_ + 4 * n_valid * g_ + 4 * b_ * g_
                        + 4 * b_ * l_),
            "backward": (b_ * l_ + 4 * n_valid * g_ + 4 * b_ * g_
                         + 2 * 4 * b_ * l_
                         + 4 * b_ * l_ * g_ + 4 * b_ * g_)}
        # the regrouped layer's multiply-adds: a valid position's, then the
        # query's share an example; the backward takes two products of each
        macs = n_valid * (2 * g_ * h1 + h1 * h2 + h2) + b_ * g_ * h1
        flops = {"forward": 2 * macs, "backward": 4 * macs}
        for what in ("forward", "backward"):
            fbound = flops[what] / F32_FLOPS * 1e3
            name = ("din_attention" if what == "forward"
                    else "din_attention_backward")
            log_times(f"{kind} attention {what} [{b_}, {l_}, {g_}]",
                      ms[what], plain[what], None, nbytes[what],
                      f"; FLOP bound {fbound:.4f} ms ({flops[what]} FLOPs "
                      f"of the regrouped layer at 67 TFLOP/s); on path "
                      f"{on_path[what]:.4f} ms"
                      + (f"; no-grad forward {ms['eval']:.4f} ms"
                         if what == "forward" else ""))
            out.append(entry(f"{name}_{kind}",
                             "deeprec_tpu_torch/csrc/din_attention.cu", None,
                             max(errs.values()), ms[what], plain[what], None,
                             nbytes[what], on_path_ms=on_path[what],
                             flops=flops[what], flop_bound_ms=fbound,
                             eval_ms=ms["eval"] if what == "forward"
                             else None, rel_errs=errs, counter=name,
                             path="seq_dien" if kind == "dien"
                             else "seq_din"))
        log(f"{kind} attention forward + backward: kernels "
            f"{ms['forward'] + ms['backward']:.4f} ms, on path "
            f"{on_path['forward'] + on_path['backward']:.4f} ms, plain "
            f"{plain['forward'] + plain['backward']:.4f} ms; worst error "
            f"against the plain code {errs}")
        del want, got, again, wts
    return out


# -- phase 3 -----------------------------------------------------------------
def write_checkpoint(path):
    """A full save of the DLRM at full width, made without JAX."""
    from deeprec_tpu_torch.checkpoint import format as F
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.models.ctr import flax_leaves
    from deeprec_tpu_torch.sparse.embedding_var import init_rows

    _, coll, _ = criteo_parts()
    g = torch.Generator().manual_seed(SEED)
    model = seeded_model(g)
    keys = np.unique(np.concatenate([
        coll.pack_ids_np(b).reshape(-1)
        for b in SyntheticCriteo(batch_size=B, seed=7).take(20)]))
    keys = keys[keys != -1]
    rows = init_rows(coll.config, torch.from_numpy(keys))
    rows = rows + 0.3 * torch.randn(rows.shape, generator=g)
    values = torch.cat([rows, torch.full_like(rows, 0.1)], 1)  # fused acc
    n = keys.shape[0]
    table = {"keys": keys, "values": values.numpy(),
             "freqs": np.ones(n, np.int32),
             "versions": np.zeros(n, np.int32),
             "create_steps": np.zeros(n, np.int32)}
    F.write_save(os.path.join(path, F.step_dirname("full", 1)),
                 {"kind": "full", "step": 1, "tables": {"emb": n}},
                 flax_leaves(model) + [np.asarray(1, np.int32)],
                 {"emb": table})
    return table


def write_incremental(path, table, touched):
    """An incremental save moving the rows of ``touched`` saved keys."""
    from deeprec_tpu_torch.checkpoint import format as F
    base, _ = F.restore_plan(path)
    sel = np.nonzero(np.isin(table["keys"], touched))[0]
    incr = {k: v[sel] for k, v in table.items()}
    incr["values"] = incr["values"].copy()
    incr["values"][:, :EMB_DIM] += 0.5
    leaves = F.read_dense(base["path"])
    leaves[-1] = np.asarray(2, np.int32)
    F.write_save(os.path.join(path, F.step_dirname("incr", 2)),
                 {"kind": "incr", "step": 2, "since": 1,
                  "tables": {"emb": int(sel.shape[0])}}, leaves,
                 {"emb": incr})
    return int(sel.shape[0])


def predictor(path, device):
    from deeprec_tpu_torch.serving import Predictor
    numeric, coll, model = criteo_parts()
    return Predictor(model, numeric, {"emb": coll}, path, device=device)


# -- phase 5 -----------------------------------------------------------------
def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _cols(batch, lo, hi):
    return {k: np.asarray(v)[lo:hi].tolist() for k, v in batch.items()
            if k != "label"}


def check_http(path, gpu, cpu, table, batch):
    from deeprec_tpu_torch.serving.server import make_server
    srv = make_server(gpu, host="127.0.0.1", port=0, dynamic_batch_ms=50.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        expect = gpu.predict(batch)
        h = _get(base + "/healthz")
        if h["status"] != "ok" or h["tables"]["emb"] != table["keys"].shape[0]:
            fail(f"/healthz answered {h}")
        got = np.asarray(_post(base + "/v1/predict",
                               {"inputs": _cols(batch, 0, 64)})["predictions"])
        np.testing.assert_allclose(got, expect[:64], rtol=0, atol=1e-6)
        res = {}

        def hit(lo, hi):
            res[lo] = _post(base + "/v1/predict",
                            {"inputs": _cols(batch, lo, hi)})
        pair = [threading.Thread(target=hit, args=a)
                for a in ((0, 40), (40, 100))]
        [t.start() for t in pair]
        [t.join(timeout=120) for t in pair]
        if any(t.is_alive() for t in pair) or len(res) != 2:
            fail("dynamically batched pair did not both answer")
        np.testing.assert_allclose(res[0]["predictions"], expect[:40],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[40]["predictions"], expect[40:100],
                                   rtol=0, atol=1e-6)
        batches = srv.service.batcher.batches
        log(f"HTTP: /healthz {h['tables']}, predict round-trip ok, "
            f"dynamic pair ok ({batches} predict calls for 3 requests)")

        # live refresh of an incremental save touching the request's keys
        coll = gpu.collections["emb"]
        touched = np.unique(coll.pack_ids_np(
            {k: v[:100] for k, v in batch.items()}))[:3000]
        n = write_incremental(path, table, touched)
        r = _post(base + "/refresh", {})
        if r != {"changed": True, "step": 2}:
            fail(f"/refresh answered {r}")
        after = np.asarray(_post(base + "/v1/predict",
                                 {"inputs": _cols(batch, 0, 100)}
                                 )["predictions"])
        if np.allclose(after, expect[:100], rtol=0, atol=1e-6):
            fail("predictions did not move after the refresh")
        if not cpu.refresh():
            fail("CPU predictor saw no new save")
        ref = cpu.predict({k: v[:100] for k, v in batch.items()})
        err = float(np.abs(after - ref).max())
        if not err <= PROB_ATOL:
            fail(f"refreshed card vs CPU probabilities differ by {err}")
        moved = float(np.abs(after - expect[:100]).max())
        log(f"HTTP refresh: {n} rows moved, predictions moved by up to "
            f"{moved:.4f}, card vs CPU after refresh max |dp| {err:.3g}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.batcher.stop()
        thread.join(timeout=30)


# -- phases 2 and 6: the training path ----------------------------------------
def host_collection(metadata, capacity=CAPACITY, **overrides):
    """bench.py's table: host index over 2^21 rows (or ``capacity``), with
    ``overrides`` of its configuration. ``use_native=True`` raises when the
    C++ resolver cannot be built: no Python fallback."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.criteo import CAT_NAMES
    from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
    kw = dict(fused_slot_columns=EMB_DIM, fused_slot_init=0.1)
    if metadata:  # bench.py --metadata
        kw.update(counter_filter=cfg.CounterFilter(filter_freq=1),
                  evict=cfg.GlobalStepEvict(steps_to_live=1 << 30))
    return HostIndexEmbeddingCollection(
        [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
         for n in CAT_NAMES],
        name="emb", capacity=capacity,
        initializer=cfg.Initializer("normal", scale=0.05),
        max_unique=MAX_UNIQUE, use_native=True, **{**kw, **overrides})


def check_training_kernels(dev):
    """K2 (both directions), K1's optimizer read and K3a at the training
    shape of one resolved B=4096 batch; scatter_set and K3b at the JAX
    benchmark's shape. Returns the kernels' JSON entries."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import (fused_pooled_lookup,
                                                    fused_pooled_lookup_plain)
    from deeprec_tpu_torch.ops.meta_scatter import (
        blocked_rmw_set, blocked_rmw_set_plain, lookup_meta, meta_scatter,
        meta_scatter_plain, scatter_set)

    g = torch.Generator().manual_seed(SEED + 1)
    coll = host_collection(metadata=True)
    r = coll.pack_ids(next(SyntheticCriteo(batch_size=B, seed=7)),
                      dev).decode()
    u = r.uslots.shape[0]
    n_real = int(r.n_unique)
    log(f"training shape: {r.inverse.shape[0]} ids, {n_real} unique keys in "
        f"{u} lanes")

    # K2 backward: [26*4096, 1] bags (one id each) into the U unique lanes
    slots = r.inverse.view(-1, 1)
    valid = (r.uslots != CAPACITY)[r.inverse].view(-1, 1)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    bwd = k2_bwd_case(f"([26*{B}, 1] sum, D {EMB_DIM})", "", d_pooled,
                      slots, valid, "sum", u)

    # K2's forward at the same training shape
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    fwd = fused_pooled_lookup(urows, slots, valid, "sum")
    torch.testing.assert_close(
        fwd, fused_pooled_lookup_plain(urows, slots, valid, "sum"),
        rtol=POOL_RTOL, atol=1e-6)
    fwd_ms = time_ms(lambda: fused_pooled_lookup(urows, slots, valid, "sum"))
    fwd_plain = time_ms(lambda: fused_pooled_lookup_plain(urows, slots, valid,
                                                          "sum"))
    fwd_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        slots, urows, per_sample_weights=valid.float(), mode="sum"))
    log_times("K2 fused_pooled_lookup (training shape, [26*4096, 1] sum)",
              fwd_ms, fwd_plain, fwd_lib,
              slots.numel() * 4 + valid.numel() + n_real * EMB_DIM * 4
              + slots.shape[0] * EMB_DIM * 4,
              "; library: embedding_bag(mode='sum', per_sample_weights)")

    # K2 at bf16, both directions at the training shape: the gradient
    # widened to f32, each row summed in f32 and rounded once to bf16
    d16, u16 = d_pooled.to(torch.bfloat16), urows.to(torch.bfloat16)
    bwd16 = k2_bwd_case(f"at bf16 ([26*{B}, 1] sum, D {EMB_DIM})", "bf16",
                        d16, slots, valid, "sum", u)
    if not torch.equal(
            fused_pooled_lookup(u16, slots, valid, "sum").view(torch.int16),
            fused_pooled_lookup_plain(u16, slots, valid,
                                      "sum").view(torch.int16)):
        fail("K2 at bf16 (training shape) differs from its plain version")
    fwd16_ms = time_ms(lambda: fused_pooled_lookup(u16, slots, valid, "sum"))
    fwd16_plain = time_ms(lambda: fused_pooled_lookup_plain(u16, slots, valid,
                                                            "sum"))
    fwd16_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        slots, u16, per_sample_weights=valid.to(torch.bfloat16), mode="sum"))
    log_times("K2 fused_pooled_lookup at bf16 (training shape, [26*4096, 1] "
              "sum)", fwd16_ms, fwd16_plain, fwd16_lib,
              slots.numel() * 4 + valid.numel() + n_real * EMB_DIM * 2
              + slots.shape[0] * EMB_DIM * 2,
              "; library: embedding_bag at bf16")

    # K1 at the training shape: the unique-row fetch and the optimizer's
    # read of whole fused rows (value + accumulator)
    table = torch.randn(CAPACITY + 1, 2 * EMB_DIM, generator=g).to(dev)
    k1_entries = [k1_case(f"(training {what})", table, r.uslots, suffix, d)
                  for what, suffix, d in (
                      ("unique-row fetch", "train_fetch", EMB_DIM),
                      ("optimizer row read", "optim_read", 2 * EMB_DIM))]

    # K3a on the path: lookup_or_create's metadata step (--metadata:
    # create steps, versions, freqs, CounterFilter(1)) in one launch; the
    # three-plane kernel, off the path, held to its planes
    cap, ff = CAPACITY, 1
    dest = torch.where(r.created & ~r.readonly, r.uslots, cap + 1)
    live = (r.counts > 0) & (r.uslots != cap) & ~r.readonly
    mdest = torch.where(live, r.uslots, cap + 1)
    k3a = k3a_case(f"(training shape, planes of {cap + 1})", "", r.uslots,
                   r.counts, r.readonly, dest, cap, ff, on_path=True)
    op, pp = [[torch.full((cap + 1,), v, dtype=torch.int32, device=dev)
               for v in (-1, -1, 0)] for _ in range(2)]

    def old_kernel():
        meta_scatter(op[0], dest, op[1], op[2], mdest, r.counts, 3)
    old_kernel()
    lookup_meta(r.uslots, r.counts, r.readonly, dest, 3, cap, *pp, True, ff)
    if not all(torch.equal(a, b) for a, b in zip(op, pp)):
        fail("K3a meta_scatter differs from the fused kernel's planes")
    old_ms, m_in = time_ms(old_kernel), mdest < cap
    n_d, n_m = int((dest < cap).sum()), int(m_in.sum())
    gs = torch.tensor(3, dtype=torch.int32, device=dev)
    # the three-plane kernel alone, with its own yardstick (pre-filtered
    # lanes) and bytes
    d_keep, m_keep = dest[dest < cap].long(), mdest[m_in].long()
    c_keep = r.counts[m_in]

    def three_calls():
        pp[0].index_put_((d_keep,), gs)
        pp[1].index_put_((m_keep,), gs)
        pp[2].index_add_(0, m_keep, c_keep)
    ms_lib = time_ms(three_calls)
    ms_plain = time_ms(lambda: meta_scatter_plain(
        pp[0], dest, pp[1], pp[2], mdest, r.counts, 3, cap))
    ms_bytes = 3 * u * 4 + (n_d + 3 * n_m) * 4
    log_times("K3a meta_scatter, the three-plane kernel (off the path now)",
              old_ms, ms_plain, ms_lib, ms_bytes,
              "; library: index_put_ x2 + index_add_ on pre-filtered lanes")

    # the JAX benchmark's question, on this card: CAP 2^21, U 17,664
    bslots = torch.randperm(cap, generator=g)[:K3B_U].to(torch.int32).to(dev)
    bvals = torch.randint(-9, 9, (K3B_U,), generator=g,
                          dtype=torch.int32).to(dev)
    plane = torch.randint(-1, 9, (cap + 1,), generator=g,
                          dtype=torch.int32).to(dev)
    one, ref1 = plane.clone(), plane.clone()
    scatter_set(one, bslots, 7)
    ref1[bslots.long()] = 7
    if not torch.equal(one, ref1):
        fail("K3a scatter_set differs from index_put_")
    b64 = bslots.long()
    seven = torch.tensor(7, dtype=torch.int32, device=dev)
    ss_ms = time_ms(lambda: scatter_set(one, bslots, 7))
    ss_plain = time_ms(lambda: meta_scatter_plain(None, bslots, one, None,
                                                  bslots, None, 7, cap))
    ss_lib = time_ms(lambda: one.index_put_((b64,), seven))
    log_times(f"K3a scatter_set (benchmark shape: plane {cap + 1}, U "
              f"{K3B_U})", ss_ms, ss_plain, ss_lib, K3B_U * 8,
              "; library: index_put_")
    got = blocked_rmw_set(plane, bslots, bvals, cap)
    if not torch.equal(got, blocked_rmw_set_plain(plane, bslots, bvals, cap)):
        fail("K3b blocked_rmw_set differs from its plain version")
    k3b_ms = time_ms(lambda: blocked_rmw_set(plane, bslots, bvals, cap))
    k3b_plain = time_ms(lambda: blocked_rmw_set_plain(plane, bslots, bvals,
                                                      cap))
    # the library call computing K3b's own function, out of place: it
    # copies plane[:cap] and scatters into the copy
    k3b_lib = time_ms(lambda: torch.index_put(plane[:cap], (b64,), bvals))
    inplace = plane.clone()
    k3b_inplace = time_ms(lambda: inplace.index_put_((b64,), bvals))
    k3b_bytes = 2 * cap * 4 + 2 * K3B_U * 4
    log_times(f"K3b blocked_rmw_set (benchmark shape: CAP {cap}, U {K3B_U})",
              k3b_ms, k3b_plain, k3b_lib, k3b_bytes,
              f"; library: torch.index_put out of place; the in-place "
              f"index_put_ (no copy of the plane, another function) "
              f"{k3b_inplace:.4f} ms")
    bwd.pop("counter")  # the entries' names are the counters' own
    bwd16.pop("counter")
    return k1_entries + [
        bwd, bwd16, k3a,
        entry("meta_scatter", "deeprec_tpu_torch/csrc/meta_scatter.cu",
              "benchmarks/pallas_meta_bench.py:108", 0.0, old_ms, ms_plain,
              ms_lib, ms_bytes),
        entry("blocked_rmw_set", "deeprec_tpu_torch/csrc/meta_scatter.cu",
              "benchmarks/pallas_meta_bench.py:151", 0.0, k3b_ms, k3b_plain,
              k3b_lib, k3b_bytes),
    ]


def seeded_model(g):
    """bench.py's DLRM with He-scaled random weights drawn from ``g``."""
    _, _, model = criteo_parts()
    with torch.no_grad():  # He-scaled weights keep the logits spread out
        for p in model.parameters():
            std = (2.0 / p.shape[1]) ** 0.5 if p.dim() == 2 else 0.01
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


def trainer(dev, metadata, capacity=CAPACITY, **overrides):
    from deeprec_tpu_torch.optim.dense import Adagrad
    from deeprec_tpu_torch.optim.sparse import sparse_adagrad_fused
    from deeprec_tpu_torch.train.trainer import Trainer
    numeric, _, _ = criteo_parts()
    model = seeded_model(torch.Generator().manual_seed(SEED))
    return Trainer(model, numeric,
                   {"emb": host_collection(metadata, capacity, **overrides)},
                   {"emb": sparse_adagrad_fused(0.05)}, Adagrad(0.05),
                   device=dev)


def path_counters(index=False, dlrm=False, seq=False):
    """The launch counters of the kernels on the training paths; ``index``
    adds the hash index's K4 and K5 (the paths that key a table on the
    card), ``dlrm`` the dot interaction's two kernels (the paths that train
    a DLRM), ``seq`` the GRU/AUGRU recurrence's two and the attention
    unit's two (the paths that may train a DIN or a DIEN)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_pooled_lookup, fused_pooled_lookup_backward)
    from deeprec_tpu_torch.ops.gather import gather_rows
    from deeprec_tpu_torch.ops.hash_probe import (hash_lookup,
                                                  hash_lookup_or_insert_)
    from deeprec_tpu_torch.ops.interaction import (dot_interaction,
                                                   dot_interaction_backward)
    from deeprec_tpu_torch.ops.meta_scatter import lookup_meta
    out = {"gather_rows": gather_rows,
           "fused_pooled_lookup": fused_pooled_lookup,
           "fused_pooled_lookup_backward": fused_pooled_lookup_backward,
           "lookup_meta": lookup_meta}
    if index:
        out.update(hash_lookup=hash_lookup,
                   hash_lookup_or_insert=hash_lookup_or_insert_)
    if dlrm:
        out.update(dot_interaction=dot_interaction,
                   dot_interaction_backward=dot_interaction_backward)
    if seq:
        from deeprec_tpu_torch.ops.din_attention import (
            din_attention, din_attention_backward)
        from deeprec_tpu_torch.ops.recurrence import (gru_scan,
                                                      gru_scan_backward)
        out.update(gru_scan=gru_scan, gru_scan_backward=gru_scan_backward,
                   din_attention=din_attention,
                   din_attention_backward=din_attention_backward)
    return out


def lockstep(tg, tc, batches, what, loss_atol=LOSS_ATOL, row_atol=ROW_ATOL,
             row_rtol=0.0):
    """Train the card and CPU trainers on ``batches``; hold every
    collection's wires (so slots, keys and inverse) and metadata planes
    bit-equal, the losses within ``loss_atol``, the rows and float slot
    leaves (any tree of them) within ``row_atol + row_rtol * |row|`` and
    integer slot leaves bit-equal. Returns the card's and the CPU's states
    and the largest loss and row differences."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    worst = 0.0
    for i, b in enumerate(batches):
        dg, cg, lg = tg.prepare_batch(b)
        dc, cc, lc = tc.prepare_batch(b)
        for name in cc:
            if not torch.equal(cg[name].buf.cpu(), cc[name].buf):
                fail(f"{what}: card and CPU {name} resolves differ at step "
                     f"{i}")
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg = tg._train_step(sg, dg, cg, lg)
        sc = tc._train_step(sc, dc, cc, lc)
        lg_, lc_ = ((sg.metrics.loss_sum.item() - g0) / B,
                    (sc.metrics.loss_sum.item() - c0) / B)
        if not (np.isfinite(lg_) and abs(lg_ - lc_) <= loss_atol):
            fail(f"{what}: step {i} loss {lg_} on the card vs {lc_} on CPU")
        worst = max(worst, abs(lg_ - lc_))
    rows = 0.0
    for name in tc.collections:
        eg, ec = sg.tables[name], sc.tables[name]
        for f in ("freqs", "versions", "create_steps"):
            if not torch.equal(getattr(eg.ev, f).cpu(), getattr(ec.ev, f)):
                fail(f"{what}: {name} {f} planes differ between card and "
                     f"CPU")
        slots = [(f"slot {p}", a, c) for (p, a), (_, c) in zip(
            leaves_with_paths(eg.slot), leaves_with_paths(ec.slot))]
        for leaf, a, c in [("rows", eg.ev.values, ec.ev.values)] + slots:
            if not c.dtype.is_floating_point:
                if not torch.equal(a.cpu(), c):
                    fail(f"{what}: {name} {leaf} differ between card and "
                         f"CPU")
                continue
            diff = (a.cpu().float() - c.float()).abs()
            rows = max(rows, diff.max().item())
            if not bool((diff <= row_atol + row_rtol * c.float().abs()).all()):
                fail(f"{what}: {name} {leaf} differ by {diff.max().item()} "
                     f"between card and CPU")
    log(f"{what}: {len(batches)} steps in lockstep with a CPU trainer: wires "
        f"and metadata planes of {sorted(tc.collections)} bit-equal, max "
        f"|dloss| {worst:.3g} (limit {loss_atol}), max |drow| and |dslot| "
        f"{rows:.3g} (limit {row_atol} + {row_rtol} |row|); "
        f"{int((sc.tables['emb'].ev.freqs > 0).sum())} emb rows with "
        f"freq > 0")
    return sg, sc, worst, rows


def timed_runs(tg, state, batches, runs=3, steps=10, inline=False):
    """examples/s of ``runs`` runs of ``steps`` steps (host clock around
    work ending in a synchronize). Staged: every batch's host half
    (packing, the resolve in step order, the copies) is done before the
    clock starts, as bench.py's default does; inline: train_step does it
    inside the clock."""
    rates = []
    for k in range(runs):
        chunk = batches[k * steps:(k + 1) * steps]
        items = chunk if inline else [tg.prepare_batch(b) for b in chunk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in items:
            state = (tg.train_step(state, it) if inline
                     else tg._train_step(state, *it))
        torch.cuda.synchronize()
        rates.append(steps * B / (time.perf_counter() - t0))
    return state, rates


def profile_steps(tg, state, batches, step_ms, what="metadata",
                  max_launches=None):
    """Device time by kernel over len(batches) staged steps
    (torch.profiler; only the device-side kernel and copy events are
    summed, so nothing is counted twice). Fails where ``max_launches`` is
    given and the device kernels and copies a step exceed it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    items = [tg.prepare_batch(b) for b in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in items:
            state = tg._train_step(state, *it)
        torch.cuda.synchronize()
    n = len(items)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    ka = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in ka) / 1e3 / n
    launches = sum(e.count for e in ka) / n
    log(f"profile of {n} staged {what} steps: {launches:.0f} device "
        f"kernels and copies per step, busy {total_ms:.3f} ms per step = "
        f"{100 * total_ms / step_ms:.1f} % of the unprofiled median step "
        f"({step_ms:.3f} ms); idle {100 - 100 * total_ms / step_ms:.1f} %")
    for e in ka[:20]:
        log(f"  {dev_us(e) / 1e3 / n:8.4f} ms/step {e.count / n:6.1f} "
            f"calls/step  {e.key[:100]}")
    if max_launches is not None and launches > max_launches:
        fail(f"{what}: {launches:.0f} device kernels and copies a step, "
             f"above {max_launches}")
    return state, total_ms


def check_training(dev, smi):
    """Phases 6 and 7. Returns (launches by path, training summary)."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.train import metrics
    counters = path_counters(dlrm=True)
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(68))
    out = {}

    # --metadata: the slice's main path
    t0 = time.perf_counter()
    tg, tc = trainer(dev, True), trainer("cpu", True)
    log(f"metadata trainers built in {time.perf_counter() - t0:.1f} s")
    for fn in counters.values():
        fn.launches = 0
    sg, _, dloss, drow = lockstep(tg, tc, batches[:5], "metadata layout")
    del tc
    sg, staged = timed_runs(tg, sg, batches[5:35])
    sg, inline = timed_runs(tg, sg, batches[35:65], inline=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"training main path (metadata layout, {sg.step} steps) launches: "
        f"{launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the training path")
    med = statistics.median(staged)
    sg, dev_ms = profile_steps(tg, sg, batches[65:68], B / med * 1e3)
    summ = metrics.summarize(sg.metrics)
    if not (summ["examples"] == sg.step * B and np.isfinite(summ["loss"])
            and 0.0 <= summ["auc"] <= 1.0):
        fail(f"metadata metrics are off: {summ}")
    for name, rates in (("staged", staged), ("inline", inline)):
        log(f"metadata layout examples/s at B={B}, {name} host half: median "
            f"{statistics.median(rates):.1f}, min {min(rates):.1f}, max "
            f"{max(rates):.1f} over 3 runs of 10 steps, on {smi}")
    log(f"metadata layout after {sg.step} steps: {summ}")
    out["metadata"] = {"staged_eps": staged, "inline_eps": inline,
                       "device_ms_per_step": dev_ms, "max_dloss": dloss,
                       "max_drow": drow, "summary": summ}
    del tg, sg

    # the light layout: bench.py's default, lazy init, no metadata writes
    tg, tc = trainer(dev, False), trainer("cpu", False)
    for fn in counters.values():
        fn.launches = 0
    sg, _, dloss, drow = lockstep(tg, tc, batches[:3], "light layout")
    del tc
    sg, staged = timed_runs(tg, sg, batches[3:33])
    light = {k: fn.launches for k, fn in counters.items()}
    log(f"light layout ({sg.step} steps) launches: {light}")
    for k in ("gather_rows", "fused_pooled_lookup",
              "fused_pooled_lookup_backward", "dot_interaction",
              "dot_interaction_backward"):
        if light[k] <= 0:
            fail(f"{k} was not launched on the light training path")
    if light["lookup_meta"]:
        fail("the light layout wrote metadata")
    log(f"light layout examples/s at B={B}, staged host half: median "
        f"{statistics.median(staged):.1f}, min {min(staged):.1f}, max "
        f"{max(staged):.1f} over 3 runs of 10 steps, on {smi}")
    out["light"] = {"staged_eps": staged, "max_dloss": dloss,
                    "max_drow": drow,
                    "summary": metrics.summarize(sg.metrics)}
    del tg, sg

    # a bf16 table (value_dtype="bfloat16"), --metadata: K2 pools bf16 rows
    tg = trainer(dev, True, TIER_CAPACITY, value_dtype="bfloat16")
    tc = trainer("cpu", True, TIER_CAPACITY, value_dtype="bfloat16")
    for fn in counters.values():
        fn.launches = 0
    sg, _, dloss, drow = lockstep(tg, tc, batches[:3], "bf16 table",
                                  loss_atol=BF16_LOSS_ATOL,
                                  row_atol=BF16_ROW_ATOL,
                                  row_rtol=BF16_ROW_RTOL)
    bf16 = {k: fn.launches for k, fn in counters.items()}
    log(f"bf16 table ({sg.step} steps) launches: {bf16}")
    for k, v in bf16.items():
        if v <= 0:
            fail(f"{k} was not launched on the bf16 training path")
    out["bf16"] = {"max_dloss": dloss, "max_drow": drow,
                   "summary": metrics.summarize(sg.metrics)}
    return {"train_metadata": launches, "train_light": light,
            "train_bf16": bf16}, out


# -- phase 8: the production loop ----------------------------------------------
def _save_keys(path):
    from deeprec_tpu_torch.checkpoint import format as F
    return np.sort(F.read_table(path, "emb")["keys"])


def _serve_pair(path, coll, held, dev, what):
    """Card and CPU predictors over ``path`` (given the training
    collection: they serve its device view); returns them and the worst
    |dp| over ``held``."""
    from deeprec_tpu_torch.serving import Predictor
    numeric, _, _ = criteo_parts()
    out = []
    for d in (dev, "cpu"):
        _, _, model = criteo_parts()
        out.append(Predictor(model, numeric, {"emb": coll}, path, device=d))
    return out + [_compare_predictors(*out, held, what)]


def _compare_predictors(gpu, cpu, held, what):
    worst = 0.0
    for b in held:
        p = gpu.predict(b)
        if p.shape != (B,) or not np.isfinite(p).all():
            fail(f"{what}: card probabilities are not finite of shape ({B},)")
        worst = max(worst, float(np.abs(p - cpu.predict(b)).max()))
    if not worst <= PROB_ATOL:
        fail(f"{what}: card vs CPU probabilities differ by {worst}")
    return worst


def inline_stages(tg, box, batches, dev, smi):
    """The loop's batches stepped inline on the same (grown) table, each
    stage on the host clock: ``prepare_host``, the copies (pageable, so
    they also wait for the device to finish the step before), the step's
    launch."""
    from deeprec_tpu_torch.train.pipeline import to_device
    t = {"prepare_host": 0.0, "copies": 0.0, "step": 0.0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        ta = time.perf_counter()
        host = tg.prepare_host(b)
        tb = time.perf_counter()
        args = to_device(host, dev)
        tc = time.perf_counter()
        box["g"] = tg._train_step(box["g"], *args)
        t["prepare_host"] += tb - ta
        t["copies"] += tc - tb
        t["step"] += time.perf_counter() - tc
    torch.cuda.synchronize()
    eps = len(batches) * B / (time.perf_counter() - t0)
    ms = {k: v * 1e3 / len(batches) for k, v in t.items()}
    log(f"loop inline on the same table: {eps:.1f} examples/s over "
        f"{len(batches)} steps on {smi}; host ms per step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return {"eps": eps, "stage_ms": ms}


def check_loop(dev, smi, tmp):
    """Phase 8: the --metadata DLRM from a 2^16-row table through
    HostStepPipeline(depth=3) with fences every 10 steps (growth, a full
    save, then incrementals), in lockstep with an unpipelined CPU trainer;
    card and CPU predictors over the card's saves, before and after a
    refresh; then examples/s of the pipelined loop. Returns the loop's
    launches and its summary."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.train import metrics
    from deeprec_tpu_torch.train.pipeline import HostStepPipeline
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
        LOOP_STEPS + 4 * 10))
    held = list(SyntheticCriteo(batch_size=B, seed=11).take(2))
    tg = trainer(dev, True, LOOP_CAPACITY)
    tc = trainer("cpu", True, LOOP_CAPACITY)
    cg, cc = tg.collections["emb"], tc.collections["emb"]
    box = {"g": tg.init(batches[0]), "c": tc.init(batches[0]), "i": 0,
           "dloss": 0.0, "serve": None}
    mg = CheckpointManager(os.path.join(tmp, "card"))
    mc = CheckpointManager(os.path.join(tmp, "cpu"))
    caps, saves, drows = [], [], []

    def step(args):
        i = box["i"]
        dc, catc, lc = tc.prepare_batch(batches[i])
        if not torch.equal(args[1]["emb"].buf.cpu(), catc["emb"].buf):
            fail(f"loop: card and CPU wires differ at step {i}")
        g0, c0 = box["g"].metrics.loss_sum.item(), \
            box["c"].metrics.loss_sum.item()
        box["g"] = tg._train_step(box["g"], *args)
        box["c"] = tc._train_step(box["c"], dc, catc, lc)
        lg = (box["g"].metrics.loss_sum.item() - g0) / B
        lc_ = (box["c"].metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg) and abs(lg - lc_) <= LOSS_ATOL):
            fail(f"loop: step {i} loss {lg} on the card vs {lc_} on CPU")
        box["dloss"] = max(box["dloss"], abs(lg - lc_))
        box["i"] += 1

    def fence(done):
        if len(pipe) or box["g"].step != done or box["c"].step != done:
            fail(f"loop: fence at {done} on an undrained pipeline")
        eg, ec = box["g"].tables["emb"].ev, box["c"].tables["emb"].ev
        for f in ("freqs", "versions", "create_steps"):
            if not torch.equal(getattr(eg, f).cpu(), getattr(ec, f)):
                fail(f"loop: {f} planes differ at step {done}")
        drows.append((eg.values.cpu() - ec.values).abs().max().item())
        if not drows[-1] <= ROW_ATOL:
            fail(f"loop: rows differ by {drows[-1]} at step {done}")
        # the next window starts from the card's state: f32 sums in
        # another order drift ~1e-5 in 5 steps and compound (the rows of
        # an unanchored run reached 1.06e-4 by step 30)
        with torch.no_grad():
            ec.values.copy_(eg.values)
            for pc, pg in zip(tc.model.parameters(), tg.model.parameters()):
                pc.copy_(pg)
            for ac, ag in zip(box["c"].opt_state, box["g"].opt_state):
                ac.copy_(ag)
        box["g"], box["c"] = tg.maybe_grow(box["g"]), tc.maybe_grow(box["c"])
        caps.append((done, cg.config.capacity, cc.config.capacity))
        if caps[-1][1] != caps[-1][2]:
            fail(f"loop: capacities differ after the fence: {caps[-1]}")
        save = (CheckpointManager.save if not saves
                else CheckpointManager.save_incremental)
        pg, pc = save(mg, tg, box["g"]), save(mc, tc, box["c"])
        kg = _save_keys(pg)
        if not np.array_equal(kg, _save_keys(pc)):
            fail(f"loop: the key sets of {os.path.basename(pg)} differ")
        saves.append((os.path.basename(pg), int(kg.shape[0])))
        if box["serve"] is None:  # serve the full save
            box["serve"] = _serve_pair(mg.directory, cg, held, dev,
                                       f"loop serving {saves[-1][0]}")

    counters = path_counters(dlrm=True)
    for fn in counters.values():
        fn.launches = 0
    stage_s = {"resolve": 0.0, "step": 0.0}

    def resolve(b):  # the resolve stage, timed on its own thread
        t = time.perf_counter()
        out = tg.prepare_host(b, pin=True)
        stage_s["resolve"] += time.perf_counter() - t
        return out
    pipe = HostStepPipeline(resolve, depth=3, device=dev)
    t0 = time.perf_counter()
    n = pipe.run(batches[:LOOP_STEPS], step, fence_every=10, on_fence=fence)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"loop: {n} pipelined steps in lockstep with a CPU trainer in "
        f"{wall:.1f} s; launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the loop's path")
    if not (n == LOOP_STEPS and len(saves) == LOOP_STEPS // 10
            and caps[-1][1] > LOOP_CAPACITY):
        fail(f"loop: {n} steps, saves {saves}, capacities {caps}")

    gpu, cpu, before = box["serve"]
    if not (gpu.refresh() and cpu.refresh()) or gpu.step != LOOP_STEPS:
        fail("loop: the predictors did not refresh onto the incrementals")
    after = _compare_predictors(gpu, cpu, held, "loop serving, refreshed")
    log(f"loop: capacities at the fences {caps}; saves {saves} (keys, card "
        f"= CPU); max |dloss| {box['dloss']:.3g}, |drow| at the fences "
        f"{', '.join(f'{d:.3g}' for d in drows)} (each window of 10 steps "
        f"from the card's state); card vs CPU predictor max |dp| {before:.3g} "
        f"on the full save, {after:.3g} after refresh() to step "
        f"{gpu.step}")
    del tc, cpu, gpu

    # examples/s of the pipelined loop alone (no lockstep, no fences), with
    # the host time of each stage: the resolve thread's prepare_host and
    # the main thread's launch of the step
    def fast(args):
        t = time.perf_counter()
        box["g"] = tg._train_step(box["g"], *args)
        stage_s["step"] += time.perf_counter() - t
    rates = []
    stage_s["resolve"] = 0.0
    for k in range(3):
        chunk = batches[LOOP_STEPS + 10 * k:LOOP_STEPS + 10 * (k + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(chunk, fast)
        torch.cuda.synchronize()
        rates.append(10 * B / (time.perf_counter() - t0))
    pipe.close()
    stage_ms = {k: v * 1e3 / 30 for k, v in stage_s.items()}
    stage_ms["wall"] = sum(10 * B / r for r in rates) * 1e3 / 30
    summ = metrics.summarize(box["g"].metrics)
    if not (summ["examples"] == box["g"].step * B
            and np.isfinite(summ["loss"])):
        fail(f"loop metrics are off: {summ}")
    log(f"loop (metadata layout) examples/s at B={B}, pipelined "
        f"(depth 3): median {statistics.median(rates):.1f}, min "
        f"{min(rates):.1f}, max {max(rates):.1f} over 3 runs of 10 steps, "
        f"on {smi}; host ms per step: resolve stage "
        f"{stage_ms['resolve']:.2f} (its own thread), step launch "
        f"{stage_ms['step']:.2f}, wall {stage_ms['wall']:.2f}; health "
        f"{tg.table_health(box['g'])['emb']}")
    inline = inline_stages(tg, box, batches[LOOP_STEPS + 30:], dev, smi)
    return launches, {"pipelined_eps": rates, "stage_ms": stage_ms,
                      "inline": inline, "capacities": caps,
                      "saves": saves, "max_dloss": box["dloss"],
                      "drow_at_fences": drows, "serve_dp": before,
                      "serve_dp_refreshed": after,
                      "lockstep_wall_s": wall, "summary": summ}


# -- phase 9: tiered storage ---------------------------------------------------
def tier_trainer(dev, storage="HBM_DRAM", ssd_path="", dram_rows=0):
    """The --metadata DLRM on a host-index table of TIER_CAPACITY rows with
    a host tier: hbm_capacity TIER_HBM, GlobalStepEvict(TIER_LIVE)."""
    from deeprec_tpu_torch import config as cfg
    return trainer(dev, True, TIER_CAPACITY,
                   evict=cfg.GlobalStepEvict(steps_to_live=TIER_LIVE),
                   storage=cfg.StorageOption(
                       getattr(cfg.StorageType, storage),
                       hbm_capacity=TIER_HBM, dram_row_budget=dram_rows,
                       ssd_path=ssd_path))


def _tier_rows(coll):
    """The host tier's (keys, payload rows), sorted by key; the store must
    be the C++ one."""
    st = coll.tier_store
    if st is None:
        return np.zeros((0,), np.int64), np.zeros((0, 2 * EMB_DIM + 3),
                                                  np.float32)
    parts = (st.dram, st.ssd) if hasattr(st, "ssd") else (st,)
    if any(p._h is None for p in parts):
        fail("the host tier took the dict fallback")
    k, r = st.export()
    o = np.argsort(k)
    return k[o], r[o]


def _same_tier(cg, cc, what):
    """The card's and the CPU's tiers: the same keys, bit-equal integer
    columns (freq, version, create step), values within ROW_ATOL. Returns
    (rows, max |dvalue|)."""
    (kg, rg), (kc, rc) = _tier_rows(cg), _tier_rows(cc)
    w = 2 * EMB_DIM  # the values block: embedding and fused accumulator
    if not (np.array_equal(kg, kc) and np.array_equal(
            rg[:, w:].view(np.int32), rc[:, w:].view(np.int32))):
        fail(f"{what}: the card's and the CPU's tiers differ")
    d = float(np.abs(rg[:, :w] - rc[:, :w]).max()) if len(kg) else 0.0
    if not d <= ROW_ATOL:
        fail(f"{what}: tier payloads differ by {d}")
    return int(kg.shape[0]), d


def _same_tables(tg, tc, sg, sc, what):
    """Resolver keys (slot order) and metadata planes bit-equal, rows within
    ROW_ATOL; returns max |drow|."""
    cg, cc = tg.collections["emb"], tc.collections["emb"]
    if not np.array_equal(cg._resolver.export_keys(),
                          cc._resolver.export_keys()):
        fail(f"{what}: the resolvers' keys differ")
    eg, ec = sg.tables["emb"].ev, sc.tables["emb"].ev
    for f in ("freqs", "versions", "create_steps"):
        if not torch.equal(getattr(eg, f).cpu(), getattr(ec, f)):
            fail(f"{what}: {f} planes differ")
    d = (eg.values.cpu() - ec.values).abs().max().item()
    if not d <= ROW_ATOL:
        fail(f"{what}: rows differ by {d}")
    return d


def _serve_tiers(path, coll, held, dev):
    """A card and a CPU TieredPredictor (device_row_budget TIER_HBM) and a
    card Predictor over ``path``; checks them against each other and
    returns them with the worst |dp| of each pair."""
    from deeprec_tpu_torch.serving import Predictor, TieredPredictor
    numeric, _, _ = criteo_parts()
    preds = [TieredPredictor(criteo_parts()[2], numeric, {"emb": coll}, path,
                             device_row_budget=TIER_HBM, device=d)
             for d in (dev, "cpu")]
    preds.append(Predictor(criteo_parts()[2], numeric, {"emb": coll}, path,
                           device=dev))
    if preds[0].host_rows("emb") <= 0:
        fail("tier serving: the TieredPredictor keeps no rows on the host")
    return preds, _compare_tiers(preds, held)


def _compare_tiers(preds, held):
    return (_compare_predictors(preds[0], preds[1], held,
                                "tier serving, card vs CPU TieredPredictor"),
            _compare_predictors(preds[0], preds[2], held,
                                "tier serving, TieredPredictor vs Predictor"))


def check_tier(dev, smi, tmp):
    """Phase 9: the --metadata DLRM on a tiered table through
    HostStepPipeline(depth=3), a fence every 10 steps (demotion, growth, a
    full save, then incrementals), in lockstep with an unpipelined CPU
    trainer; restore, tiered serving, an HBM_DRAM_SSD run; then examples/s
    of the pipelined loop and the fences' times. Returns the path's
    launches and its summary."""
    from deeprec_tpu_torch.checkpoint import format as F
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.train import metrics
    from deeprec_tpu_torch.train.pipeline import HostStepPipeline
    from deeprec_tpu_torch.utils.native import get_lib
    if get_lib() is None:
        fail("tier: the native library did not build (dict-fallback tier)")
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
        TIER_STEPS + 20))
    held = list(SyntheticCriteo(batch_size=B, seed=11).take(2))
    tg, tc = tier_trainer(dev), tier_trainer("cpu")
    cg, cc = tg.collections["emb"], tc.collections["emb"]
    box = {"g": tg.init(batches[0]), "c": tc.init(batches[0]), "i": 0,
           "dloss": 0.0, "promoted": 0, "serve": None}
    mg = CheckpointManager(os.path.join(tmp, "card"))
    mc = CheckpointManager(os.path.join(tmp, "cpu"))
    width = 2 * EMB_DIM
    fences = []

    def step(args):
        i = box["i"]
        dc, catc, lc = tc.prepare_batch(batches[i])
        wg, wc = args[1]["emb"], catc["emb"]
        if not torch.equal(wg.buf.cpu(), wc.buf):
            fail(f"tier: card and CPU wires differ at step {i}")
        if (wg.promo is None) != (wc.promo is None):
            fail(f"tier: only one side promoted at step {i}")
        if wg.promo is not None:
            lanes, pay = (t.cpu() for t in wg.promo)
            if not (torch.equal(lanes, wc.promo[0]) and torch.equal(
                    pay[:, width:].view(torch.int32),
                    wc.promo[1][:, width:].view(torch.int32))
                    and (pay - wc.promo[1]).abs().max().item() <= ROW_ATOL):
                fail(f"tier: the promo planes differ at step {i}")
            box["promoted"] += int(lanes.shape[0])
        g0, c0 = box["g"].metrics.loss_sum.item(), \
            box["c"].metrics.loss_sum.item()
        box["g"] = tg._train_step(box["g"], *args)
        box["c"] = tc._train_step(box["c"], dc, catc, lc)
        lg = (box["g"].metrics.loss_sum.item() - g0) / B
        lc_ = (box["c"].metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg) and abs(lg - lc_) <= LOSS_ATOL):
            fail(f"tier: step {i} loss {lg} on the card vs {lc_} on CPU")
        box["dloss"] = max(box["dloss"], abs(lg - lc_))
        box["i"] += 1

    def fence(done):
        if len(pipe) or box["g"].step != done or box["c"].step != done:
            fail(f"tier: fence at {done} on an undrained pipeline")
        drow = _same_tables(tg, tc, box["g"], box["c"], f"tier step {done}")
        with torch.no_grad():  # the next window starts from the card's state
            box["c"].tables["emb"].ev.values.copy_(
                box["g"].tables["emb"].ev.values)
            for pc, pg in zip(tc.model.parameters(), tg.model.parameters()):
                pc.copy_(pg)
            for ac, ag in zip(box["c"].opt_state, box["g"].opt_state):
                ac.copy_(ag)
        n_g, n_c = cg._resolver.size, cc._resolver.size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["g"] = tg.maybe_demote(box["g"])
        torch.cuda.synchronize()
        demote_ms = (time.perf_counter() - t0) * 1e3
        box["c"] = tc.maybe_demote(box["c"])
        demoted = n_g - cg._resolver.size
        if demoted <= 0 or demoted != n_c - cc._resolver.size:
            fail(f"tier: {demoted} rows demoted on the card at step {done}, "
                 f"{n_c - cc._resolver.size} on CPU")
        _same_tables(tg, tc, box["g"], box["c"], f"tier step {done}, demoted")
        tier_rows, dpay = _same_tier(cg, cc, f"tier step {done}")
        box["g"], box["c"] = tg.maybe_grow(box["g"]), tc.maybe_grow(box["c"])
        if cg.config.capacity != cc.config.capacity:
            fail(f"tier: capacities differ after the fence at {done}")
        save = (CheckpointManager.save if not fences
                else CheckpointManager.save_incremental)
        t0 = time.perf_counter()
        pg = save(mg, tg, box["g"])
        save_ms = (time.perf_counter() - t0) * 1e3
        pc = save(mc, tc, box["c"])
        for t in ("emb", "__tier__emb"):
            kg = np.sort(F.read_table(pg, t)["keys"]) if t == "emb" or \
                os.path.exists(os.path.join(pg, f"table-{t}.npz")) else None
            kc = np.sort(F.read_table(pc, t)["keys"]) if t == "emb" or \
                os.path.exists(os.path.join(pc, f"table-{t}.npz")) else None
            if (kg is None) != (kc is None) or (
                    kg is not None and not np.array_equal(kg, kc)):
                fail(f"tier: the {t} keys of {os.path.basename(pg)} differ")
        fences.append({"step": done, "demoted": demoted,
                       "tier_rows": tier_rows, "resident": cg._resolver.size,
                       "capacity": cg.config.capacity, "max_drow": drow,
                       "max_dpayload": dpay, "demote_ms": demote_ms,
                       "save_ms": save_ms, "save": os.path.basename(pg)})
        log(f"tier fence at step {done}: {demoted} rows demoted "
            f"({demote_ms:.1f} ms on the card's host clock), {tier_rows} in "
            f"the tier, {cg._resolver.size} resident, capacity "
            f"{cg.config.capacity}; {os.path.basename(pg)} written in "
            f"{save_ms:.1f} ms; card = CPU (max |drow| {drow:.3g}, "
            f"|dpayload| {dpay:.3g})")
        if box["serve"] is None:
            box["serve"] = _serve_tiers(mg.directory, cg, held, dev)

    counters = path_counters()
    for fn in counters.values():
        fn.launches = 0
    pipe = HostStepPipeline(lambda b: tg.prepare_host(b, pin=True), depth=3,
                            device=dev)
    t0 = time.perf_counter()
    n = pipe.run(batches[:TIER_STEPS], step, fence_every=10, on_fence=fence)
    wall = time.perf_counter() - t0
    preds, before = box["serve"]
    if not all(p.refresh() for p in preds) or preds[0].step != TIER_STEPS:
        fail("tier: the predictors did not refresh onto the incrementals")
    after = _compare_tiers(preds, held)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"tier: {n} pipelined steps in lockstep with a CPU trainer in "
        f"{wall:.1f} s, {box['promoted']} rows promoted through the wire; "
        f"launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the tier path")
    if not (n == TIER_STEPS and len(fences) == TIER_STEPS // 10
            and box["promoted"] > 0):
        fail(f"tier: {n} steps, {len(fences)} fences, {box['promoted']} "
             f"promotions")
    log(f"tier serving (card TieredPredictor, device_row_budget {TIER_HBM}, "
        f"{preds[0].host_rows('emb')} rows on the host after refresh): "
        f"max |dp| vs CPU TieredPredictor {before[0]:.3g} on the full save, "
        f"{after[0]:.3g} refreshed; vs card Predictor {before[1]:.3g}, "
        f"{after[1]:.3g}")
    del preds, box["serve"]

    # restore the last save into fresh card and CPU trainers
    rg, rc = tier_trainer(dev), tier_trainer("cpu")
    sg, ok_g = CheckpointManager(mg.directory).restore(rg, rg.init(
        batches[0]))
    sc, ok_c = CheckpointManager(mg.directory).restore(rc, rc.init(
        batches[0]))
    rcg = rg.collections["emb"]
    if not (ok_g and ok_c and sg.step == sc.step == TIER_STEPS):
        fail("tier: the restores did not take the last save")
    _same_tables(rg, rc, sg, sc, "tier restore")
    _same_tier(rcg, rc.collections["emb"], "tier restore")
    # every key of the live trainer, once: a row demoted unchanged since a
    # save that held it on the device restores there (equal versions: the
    # device row wins, as in the JAX package)
    dev_keys, tier_keys = rcg._resolver.export_keys(), _tier_rows(rcg)[0]
    live = np.union1d(cg._resolver.export_keys(), _tier_rows(cg)[0])
    if np.intersect1d(dev_keys, tier_keys).size or not np.array_equal(
            np.union1d(dev_keys, tier_keys), live):
        fail("tier: the restored keys are not the live trainer's, once each")
    del rg, rc, sg, sc

    # examples/s of the pipelined loop (no lockstep), each run followed by
    # a demotion fence on the drained pipeline
    def fast(args):
        box["g"] = tg._train_step(box["g"], *args)
    rates, demote_ms = [], []
    for k in range(2):
        chunk = batches[TIER_STEPS + 10 * k:TIER_STEPS + 10 * (k + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(chunk, fast)
        torch.cuda.synchronize()
        rates.append(10 * B / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        box["g"] = tg.maybe_demote(box["g"])
        torch.cuda.synchronize()
        demote_ms.append((time.perf_counter() - t0) * 1e3)
    pipe.close()
    summ = metrics.summarize(box["g"].metrics)
    if not (summ["examples"] == box["g"].step * B
            and np.isfinite(summ["loss"])):
        fail(f"tier metrics are off: {summ}")
    log(f"tier (metadata layout, tiered) examples/s at B={B}, pipelined "
        f"(depth 3): {', '.join(f'{r:.1f}' for r in rates)} over 2 runs of "
        f"10 steps, then demotion fences of "
        f"{', '.join(f'{t:.1f}' for t in demote_ms)} ms, on {smi}")
    del tc, box["c"]

    # HBM_DRAM_SSD: a small DRAM budget spills to the file store
    ssd_path = os.path.join(tmp, "ssd", "tier.arena")
    ts = tier_trainer(dev, "HBM_DRAM_SSD", ssd_path, SSD_DRAM_ROWS)
    st = ts.init(batches[0])
    for i, b in enumerate(batches[:8]):
        st = ts.train_step(st, b)
        if i % 4 == 3:
            st = ts.maybe_demote(st)
    stack = ts.collections["emb"].tier_store
    keys, _ = _tier_rows(ts.collections["emb"])
    path = CheckpointManager(os.path.join(tmp, "ssd_ckpt")).save(ts, st)
    saved = np.sort(F.read_table(path, "__tier__emb")["keys"])
    if not (stack is not None and len(stack.ssd) > 0 and stack.ssd.path ==
            ssd_path and os.path.exists(ssd_path)
            and np.array_equal(saved, keys)):
        fail("tier: the SSD run did not spill or its save lost tier rows")
    log(f"HBM_DRAM_SSD (dram_row_budget {SSD_DRAM_ROWS}): {len(stack.dram)} "
        f"tier rows in DRAM, {len(stack.ssd)} spilled to {ssd_path}; the "
        f"save carries all {saved.shape[0]}")
    return launches, {"fences": fences, "promoted": box["promoted"],
                      "max_dloss": box["dloss"], "lockstep_wall_s": wall,
                      "serve_dp": before, "serve_dp_refreshed": after,
                      "pipelined_eps": rates, "demote_ms": demote_ms,
                      "ssd": {"dram": len(stack.dram),
                              "ssd": len(stack.ssd)},
                      "summary": summ}


# -- phase 10: the rest of the CTR zoo -------------------------------------------
ZOO_ENTRY = {"dcn": "DCN", "wdl": "WDL", "deepfm": "DeepFM", "dssm": "DSSM",
             "din": "DIN", "dien": "DIEN", "dlrm": "DLRM"}


def zoo_entry(kind, dev, extra=(), host_index=True):
    """``deeprec_tpu_torch/modelzoo/<M>/train.py`` as a user runs it:
    its module and its parser's arguments (the model's own defaults: DSSM,
    DIN and DIEN train with adam at 0.002 and max_unique 0.75 of the flat
    ids) under --host_index (unless ``host_index`` is false: the
    device-index engine) at emb dim 16 and B 4096, the Criteo models on
    2^21 rows and the behaviour models on the CLI's default 2^19, weights
    from seed SEED, on ``dev``, with ``extra`` flags."""
    import importlib
    from deeprec_tpu_torch.train import cli
    name = ZOO_ENTRY[kind]
    mod = importlib.import_module(f"deeprec_tpu_torch.modelzoo.{name}.train")
    parser = mod.parser() if hasattr(mod, "parser") else \
        cli.base_parser(name)
    cap = CAPACITY if kind in ("dlrm", "dcn", "wdl", "deepfm") \
        else ZOO_DSSM_CAPACITY
    args = parser.parse_args(
        ["--host_index"] * host_index + [
         "--batch_size", str(B), "--emb_dim", str(EMB_DIM),
         "--capacity", str(cap), "--seed", str(SEED), "--device", str(dev),
         *extra])
    return mod, args


def need_native(collections, what):
    """Fail unless every collection resolves with the C++ resolver (the
    CLI takes the Python fallback when it cannot be built)."""
    for name, coll in collections.items():
        if coll._resolver._h is None:
            fail(f"{what}: collection {name} has no C++ resolver")


def zoo_trainer(kind, dev):
    """The zoo model's Trainer as the CLI makes it (``cli.make_trainer``:
    the dedup cap, the weights drawn from --seed, the sparse and dense
    optimizers --optimizer names: sparse_adagrad(0.05) + Adagrad(0.05),
    sparse_ftrl(0.05) on the wide tables; DSSM, DIN, DIEN sparse_adam(0.002)
    + Adam(0.002))."""
    from deeprec_tpu_torch.train import cli
    mod, args = zoo_entry(kind, dev)
    tr = cli.make_trainer(mod.build(args), args)
    need_native(tr.collections, f"zoo {kind}")
    return tr


def zoo_spec(kind, dev="cpu"):
    mod, args = zoo_entry(kind, dev)
    return mod.build(args)


def zoo_batches(kind, seed, n):
    from deeprec_tpu_torch.data.behavior import SyntheticBehavior
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    gen = (SyntheticBehavior(batch_size=B, max_len=SEQ_HIST, seed=seed)
           if kind in ("dssm", "din", "dien")
           else SyntheticCriteo(batch_size=B, seed=seed))
    return list(gen.take(n))


def tests_module(name, *subdir):
    """``tests/<subdir>/<name>.py``, loaded by its path (a ``tests``
    package installed elsewhere would shadow the repo's directory)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", *subdir, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bits(t):
    """A float tensor's bits (NaN and -0.0 compared as such)."""
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def k2_bwd_case(what, suffix, d_pooled, slots, valid, combiner, u):
    """K2's backward at one shape: two launches bit-equal; bit-equal on
    every row to the order reference (tests/torch_k2_order.py: the
    kernel's lane order and run tree in plain PyTorch); held to its plain
    version run on the CPU (every row of at most 32 valid lanes bit-equal,
    as both add them in lane order; a longer row within BWD_TOL of the
    magnitudes, a bf16 one within a bf16 step more); timed back to back
    and behind a one-element add, beside its plain version on the card,
    zeros + index_add_ (``library_ms``) and the deterministic zeros +
    index_put_(accumulate=True) over the same lane terms, and its
    HBM-bytes bound (this data's: the gradient rows of the bags that hold
    a valid lane, the valid lanes' slots, every flag, the output written
    once). Returns the kernel's entry."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_pooled_lookup_backward, fused_pooled_lookup_backward_plain)

    def kernel():
        return fused_pooled_lookup_backward(d_pooled, slots, valid, combiner,
                                            u)
    got, again = kernel(), kernel()
    if not torch.equal(bits(got), bits(again)):
        fail(f"K2 backward {what}: two launches differ")
    dc, sc, vc = d_pooled.cpu(), slots.cpu(), valid.cpu()
    got = got.cpu()
    order = tests_module("torch_k2_order").k2_backward_in_order
    if not torch.equal(bits(got), bits(order(dc, sc, vc, combiner, u))):
        fail(f"K2 backward {what} differs from the order reference's bits")
    ref = fused_pooled_lookup_backward_plain(dc, sc, vc, combiner, u)
    mag = fused_pooled_lookup_backward_plain(dc.float().abs(), sc, vc,
                                             combiner, u)
    lanes = torch.bincount(sc.clamp(0, u - 1)[vc].long(), minlength=u)
    short = lanes <= 32
    if not torch.equal(bits(got)[short], bits(ref)[short]):
        fail(f"K2 backward {what}: a row of at most 32 lanes differs from "
             f"the plain version's bits")
    bf16 = d_pooled.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs()
    limit = (BF16_STEP if bf16 else 0.0) * ref.float().abs() \
        + BWD_TOL * mag + 1e-7
    if not bool((err <= limit).all()):
        fail(f"K2 backward {what} differs from its plain version by "
             f"{err.max().item()}")
    # the library calls' lane terms, as the plain version makes them
    n = valid.sum(1, keepdim=True).clamp_min(1).float()
    g = d_pooled.float() if combiner == "sum" else \
        d_pooled.float() / (n if combiner == "mean" else n.sqrt())
    d = d_pooled.shape[1]
    src = torch.where(valid[..., None], g[:, None, :], 0.0).reshape(-1, d)
    src = src.to(d_pooled.dtype)
    idx = slots.clamp(0, u - 1).reshape(-1).long()

    def lib_add():
        return torch.zeros(u, d, dtype=d_pooled.dtype,
                           device=d_pooled.device).index_add_(0, idx, src)

    def lib_put():
        return torch.zeros(u, d, dtype=d_pooled.dtype,
                           device=d_pooled.device).index_put_(
            (idx,), src, accumulate=True)
    for call in (lib_add, lib_put) if not bf16 else ():  # bf16: per-add
        if not bool(((call().cpu() - ref).abs() <= limit).all()):  # rounding
            fail(f"K2 backward {what}: a library yardstick computes "
                 f"another function")
    ms, on_path = time_ms(kernel, samples=7), behind_ms(kernel, samples=7)
    plain_ms = time_ms(lambda: fused_pooled_lookup_backward_plain(
        d_pooled, slots, valid, combiner, u))
    # index_put_ takes 0.1-27 ms a call here: a few long samples do
    add_ms = time_ms(lib_add)
    put_ms = time_ms(lib_put, samples=5, per_sample=2, warmup=1)
    n_ids, n_valid = slots.numel(), int(valid.sum())
    nbytes = (int(valid.any(1).sum()) * d * d_pooled.element_size()
              + n_valid * slots.element_size() + n_ids
              + u * d * d_pooled.element_size())
    log_times(f"K2 fused_pooled_lookup_backward {what}", ms, plain_ms, add_ms,
              nbytes,
              f"; on path {on_path:.4f} ms; library: zeros + index_add_, "
              f"zeros + index_put_(accumulate=True) {put_ms:.4f} ms; "
              f"max_abs_err {err.max().item():.3g}; {n_valid} valid lanes, "
              f"{int((lanes > 0).sum())} rows touched, the hottest takes "
              f"{int(lanes.max())}, {int((lanes > 32).sum())} rows of more "
              f"than 32")
    return entry(f"fused_pooled_lookup_backward_{suffix}".rstrip("_"),
                 "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
                 "deeprec_tpu/ops/pallas_fused_lookup.py:80",
                 err.max().item(), ms, plain_ms, add_ms, nbytes,
                 on_path_ms=on_path, deterministic_library_ms=put_ms,
                 counter="fused_pooled_lookup_backward")


def k2_pair(what, urows, slots, valid, combiner, d_pooled, lib_fwd, suffix):
    """K2 and K2's backward at one shape against their plain versions,
    timed beside one PyTorch call each (``lib_fwd``: checked to compute
    the same function; the backward's: :func:`k2_bwd_case`) and their
    HBM-bytes bound. Returns the two kernels' entries."""
    from deeprec_tpu_torch.ops.fused_lookup import (fused_pooled_lookup,
                                                    fused_pooled_lookup_plain)
    u, d = urows.shape
    ref = fused_pooled_lookup_plain(urows, slots, valid, combiner)
    got = fused_pooled_lookup(urows, slots, valid, combiner)
    torch.testing.assert_close(got, ref, rtol=POOL_RTOL, atol=1e-6)
    torch.testing.assert_close(lib_fwd(), ref, rtol=POOL_RTOL, atol=1e-6)
    fwd_err = (got - ref).abs().max().item()
    # what the function needs from this run's data: every id's flag, the
    # slot of each valid id, each distinct row read once, every bag written
    n_ids, n_valid = slots.numel(), int(valid.sum())
    rows_read = int(torch.unique(slots[valid]).numel())
    fwd_bytes = (n_valid * slots.element_size() + n_ids + rows_read * d * 4
                 + slots.shape[0] * d * 4)
    times = (time_ms(lambda: fused_pooled_lookup(urows, slots, valid,
                                                 combiner)),
             time_ms(lambda: fused_pooled_lookup_plain(urows, slots, valid,
                                                       combiner)),
             time_ms(lib_fwd))
    log_times(f"K2 fused_pooled_lookup {what}", *times, fwd_bytes,
              f"; max_abs_err {fwd_err:.3g}; {rows_read} rows read")
    return [entry(f"fused_pooled_lookup_{suffix}",
                  "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
                  "deeprec_tpu/ops/pallas_fused_lookup.py:80", fwd_err,
                  *times, fwd_bytes, counter="fused_pooled_lookup"),
            k2_bwd_case(what, suffix, d_pooled, slots, valid, combiner, u)]


def k1_case(what, table, slots, suffix, d=None):
    """K1 at one shape (``d``: the columns read, all by default):
    bit-equal to its plain version, timed back to back and behind a
    one-element add, beside ``index_select`` and its bound. Returns its
    entry."""
    from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    d = d or table.shape[1]
    if not torch.equal(gather_rows(table, slots, d),
                       gather_rows_plain(table, slots, d)):
        fail(f"K1 {what} differs from its plain version")
    kt = time_ms(lambda: gather_rows(table, slots, d), samples=11)
    on_path = behind_ms(lambda: gather_rows(table, slots, d), samples=11)
    pt = time_ms(lambda: gather_rows_plain(table, slots, d))
    lt = time_ms(lambda: torch.index_select(table[:, :d], 0, slots))
    # the slots, each distinct row read once, every lane's row written
    u = slots.shape[0]
    nbytes = (u * slots.element_size()
              + (torch.unique(slots).numel() + u) * d * 4)
    log_times(f"K1 gather_rows {what} ([{u}] x {d})", kt, pt, lt, nbytes,
              f"; library: torch.index_select; on path {on_path:.4f} ms")
    return entry(f"gather_rows_{suffix}", "deeprec_tpu_torch/csrc/"
                 "gather_rows.cu", "deeprec_tpu/ops/pallas_gather.py:78", 0.0,
                 kt, pt, lt, nbytes, counter="gather_rows",
                 on_path_ms=on_path)


def k3a_case(what, suffix, uslots, counts, readonly, dest, cap, ff,
             planes=("create", "version", "freq"), on_path=False):
    """K3a (lookup_meta) at one shape with the planes its path passes
    (``planes``, of the create-step, version and freq planes; the freqs
    always, for the admission test at ``ff``): bit-equal to its plain
    version, its library yardstick checked to compute the same function,
    both timed beside it (with ``on_path``, the kernel behind a one-element
    add too), and its bound from the bytes this run's lanes need. Returns
    its entry."""
    from deeprec_tpu_torch.ops.meta_scatter import (lookup_meta,
                                                    lookup_meta_plain)
    dev = uslots.device
    fills = [(k in planes, v) for k, v in (("create", -1), ("version", -1),
                                           ("freq", 0))]

    def make():
        return [torch.full((cap + 1,), v, dtype=torch.int32, device=dev)
                if on else None for on, v in fills]

    def same(a, b):
        return all(x is None or torch.equal(x, y) for x, y in zip(a, b))

    def fused(p, fn=lookup_meta):
        return fn(uslots, counts, readonly, dest, 3, cap, *p, True, ff)
    kp, pp, lp = make(), make(), make()
    adm, adm_ref = fused(kp), fused(pp, lookup_meta_plain)
    if not (same(kp, pp) and torch.equal(adm, adm_ref)):
        fail(f"K3a lookup_meta {what} differs from its plain version")
    gs = torch.tensor(3, dtype=torch.int32, device=dev)

    def torch_chain():
        """The same function in PyTorch calls, none of which syncs: lanes
        that do not write go to the null row, which is then reset."""
        live = (counts > 0) & (uslots != cap) & ~readonly
        m = torch.where(live, uslots, cap).long()
        if lp[0] is not None:
            lp[0].index_put_((torch.where(dest < cap, dest, cap).long(),),
                             gs)
        if lp[1] is not None:
            lp[1].index_put_((m,), gs)
        lp[2].index_add_(0, m, torch.where(live, counts, 0))
        for plane, (_, fill) in zip(lp, fills):  # fill_: no host copy
            if plane is not None:
                plane.narrow(0, cap, 1).fill_(fill)
        return (uslots != cap) & (lp[2][uslots] >= ff)
    if not (torch.equal(torch_chain(), adm_ref) and same(lp, pp)):
        fail(f"K3a's library yardstick {what} computes another function")
    ms = time_ms(lambda: fused(kp))
    extra = {"on_path_ms": behind_ms(lambda: fused(kp))} if on_path else {}
    plain_ms = time_ms(lambda: fused(pp, lookup_meta_plain))
    lib_ms = time_ms(torch_chain)
    # what this run's lanes need: each lane's slot and count read and its
    # admitted flag written, its dest read only where the create-step
    # plane is passed (the kernel loads it nowhere else); the readonly
    # flag; a create step written per created row, a version written per
    # live row where versions are kept, a freq read and written per live
    # row, a freq read per other real row (the admission test)
    u, creates, versions = uslots.shape[0], kp[0] is not None, \
        kp[1] is not None
    live = (counts > 0) & (uslots != cap) & ~readonly
    n_m = int(live.sum())
    n_read = int((uslots < cap).sum()) - n_m
    n_d = int((dest < cap).sum()) if creates else 0
    lane = (uslots.element_size() + 4 + 1
            + (dest.element_size() if creates else 0))
    nbytes = (lane * u + 1 + 4 * n_d + (4 * n_m if versions else 0)
              + 8 * n_m + 4 * n_read)
    log_times(f"K3a lookup_meta {what} ({u} {uslots.dtype} lanes, planes "
              f"{', '.join(k for k in ('create', 'version', 'freq') if k in planes)}"
              f" + CounterFilter({ff}): {n_d} created, {n_m} live)", ms,
              plain_ms, lib_ms, nbytes, "; library: the same function in "
              "torch calls (live, masked indices, index_put_ per written "
              "plane, index_add_, null-row resets, the admission test)"
              + (f"; on path {extra['on_path_ms']:.4f} ms" if on_path
                 else ""))
    return entry(f"lookup_meta{suffix}", "deeprec_tpu_torch/csrc/"
                 "meta_scatter.cu", "benchmarks/pallas_meta_bench.py:108",
                 0.0, ms, plain_ms, lib_ms, nbytes, counter="lookup_meta",
                 **extra)


def hash_buckets(table, keys, max_probes, slots=None):
    """Distinct buckets a probe of ``keys`` must read in this run's data:
    for a lookup (``slots`` None) each valid key's buckets up to a match or
    a bucket with an empty lane; for an insert (``slots``: its result) up
    to the bucket of the slot it found or claimed, and for a failed key
    its home bucket alone (a lower bound)."""
    from deeprec_tpu_torch.sparse import hashtable as ht
    cap = table.capacity
    w, bmask, home, step = ht._geometry(keys, cap)
    planes = table.keys.view(-1, w)
    done = keys == -1
    final = None if slots is None else torch.where(slots != cap, slots // w,
                                                   -1)
    seen = []
    for o in range(max_probes):
        if bool(done.all()):
            break
        b = (home + o * step) & bmask
        seen.append(b[~done])
        if final is None:
            kw = planes[b]
            done = done | (kw == keys[:, None]).any(-1) | (kw == -1).any(-1)
        else:
            done = done | (b == final) | (final < 0)
    return int(torch.unique(torch.cat(seen)).numel()) if seen else 0, w


def hash_case(kind, what, table, keys, suffix, max_probes=32):
    """K4 (``kind`` "lookup") or K5 ("insert") at one shape: bit-equal to
    its plain version on the same card tensors (K5 in place and in its
    functional form, which must leave ``table`` as it was, its arbitration
    words all zero after every call, and in place again after the
    timing); timed back to back, or for an insert that changes the table
    a call at a time on a fresh copy, and behind a one-element add, beside
    the plain version and its bound from the bytes this run's keys need.
    K5's functional form's clone of the table gets a line of its own. No
    one PyTorch call computes either. Returns its entry."""
    from deeprec_tpu_torch.ops.hash_probe import arbitration_words
    from deeprec_tpu_torch.sparse import hashtable as ht
    name = "K4" if kind == "lookup" else "K5"
    steady = True  # the call leaves the table as it was
    if kind == "lookup":
        ref = ht.lookup_plain(table, keys, max_probes)
        got = ht.lookup(table, keys, max_probes)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"K4 {what} differs from its plain version")

        def port():
            return ht.lookup(table, keys, max_probes)
    else:
        ref = ht.lookup_or_insert_plain(table, keys, max_probes)
        steady = all(torch.equal(a, b) for a, b in zip(ref[0], table))
        before, work = ht.clone(table), ht.clone(table)
        arb = arbitration_words(keys.device, table.capacity)

        def reset():
            for a, b in zip(work, table):
                a.copy_(b)

        def port():
            return ht.lookup_or_insert_(work, keys, max_probes)

        def check(form, got_t, got_slots, got_created):
            if not (all(torch.equal(a, b) for a, b in zip(got_t, ref[0]))
                    and torch.equal(got_slots, ref[1])
                    and torch.equal(got_created, ref[2])):
                fail(f"K5 {form} {what} differs from its plain version")
            if bool(arb.any()):
                fail(f"K5 {form} {what} left arbitration words set")
        check("in place", *port())
        check("in its functional form",
              *ht.lookup_or_insert(table, keys, max_probes))
        if not all(torch.equal(a, b) for a, b in zip(table, before)):
            fail(f"K5's functional form wrote its input {what}")
    if steady:
        ms, on_path = time_ms(port), behind_ms(port)
    else:
        ms, on_path = call_ms(port, reset), call_ms(port, reset, behind=True)
    if kind == "insert":
        reset()
        check("after the timing", *port())
    if kind == "lookup":
        def plain():
            return ht.lookup_plain(table, keys, max_probes)
    else:
        def plain():
            return ht.lookup_or_insert_plain(table, keys, max_probes)
    plain_ms = time_ms(plain, samples=5, per_sample=5, warmup=2)
    n, cap = keys.shape[0], table.capacity
    slots = ref[0] if kind == "lookup" else ref[1]
    buckets, w = hash_buckets(table, keys, max_probes,
                              None if kind == "lookup" else slots)
    # the keys read, the buckets probed, the slots and flags written; an
    # insert also writes each created key, and size and overflow
    nbytes = 8 * n + 8 * w * buckets + 9 * n
    extra = {"lanes": n, "capacity": cap, "buckets_read": buckets,
             "on_path_ms": on_path}
    if kind == "lookup":
        counter, loop = "hash_lookup", 147
        found = int(ref[1].sum())
        note = f"{found} found"
        extra.update(found=found)
    else:
        created = int(ref[2].sum())
        nbytes += 8 * created + 32
        counter, loop = "hash_lookup_or_insert", 231
        failed = int(ref[0].overflow) - int(table.overflow)
        note = f"{created} created, {failed} failed"
        extra.update(created=created, steady=steady,
                     clone_ms=time_ms(lambda: ht.clone(table)))
    timing = ("back to back" if steady
              else "a call at a time on a fresh table")
    log_times(f"{name} {counter} {what} ({n} lanes, {cap} slots: {note}; "
              f"{buckets} buckets read)", ms, plain_ms, None, nbytes,
              f"; {timing}; on path {on_path:.4f} ms")
    if kind == "insert":
        log(f"K5 {what}: the functional form's clone of the {cap}-slot "
            f"table {extra['clone_ms']:.4f} ms (back to back), beside the "
            f"in-place kernel's {ms:.4f} ms")
    entry_name = "hash_lookup" if kind == "lookup" else "hash_lookup_or_insert"
    return entry(f"{entry_name}_{suffix}",
                 "deeprec_tpu_torch/csrc/hash_table.cu",
                 f"deeprec_tpu/sparse/hashtable.py:{loop}", 0.0, ms,
                 plain_ms, None, nbytes, counter=counter, **extra)


def check_zoo_kernels(dev):
    """K1, K2 and K2's backward at the zoo's new shapes, from one resolved
    batch each: the wide tables' D = 1 ([26*4096, 1] bags of one f32; WDL,
    DeepFM) and DSSM's hist_item ([4096, 32] mean, -1 padding, through its
    int32 inverse wire; its unique-row fetch over 107,521 lanes)."""
    import torch.nn.functional as Fn
    g = torch.Generator().manual_seed(SEED + 2)
    entries = []

    # the wide table: one [26*B, 1] group of width-1 bags at D = 1
    wide = zoo_trainer("wdl", dev).collections["wide"]
    cap = wide.config.capacity
    r = wide.pack_ids(zoo_batches("wdl", 7, 1)[0], dev).decode()
    u, n_real = r.uslots.shape[0], int(r.n_unique)
    slots = r.inverse.view(-1, 1)
    valid = (r.uslots != cap)[r.inverse].view(-1, 1)
    urows = torch.randn(u, 1, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], 1, generator=g).to(dev)
    log(f"wide shape: {slots.shape[0]} ids, {n_real} unique keys in {u} "
        f"lanes, D 1")
    entries += k2_pair(
        f"(wide, [26*{B}, 1] sum, D 1)", urows, slots, valid, "sum",
        d_pooled,
        lambda: Fn.embedding_bag(slots, urows, per_sample_weights=valid.float(),
                                 mode="sum"),
        "d1")
    table = torch.randn(cap + 1, 1, generator=g).to(dev)
    entries.append(k1_case("(wide unique-row fetch, D 1)", table, r.uslots,
                           "d1"))
    for e in entries:
        e["path"] = "zoo_wdl"

    # DSSM: hist_item, [B, 32] mean over the wire's int32 inverse
    coll = zoo_trainer("dssm", dev).collections["emb"]
    cap = coll.config.capacity
    wire = coll.pack_ids(zoo_batches("dssm", 7, 1)[0], dev)
    r = wire.decode()
    u, n_real = r.uslots.shape[0], int(r.n_unique)
    if wire.inv16 or u <= 32767:
        fail(f"DSSM's wire has {u} lanes and an int16 inverse")
    o, w, comb, names = next(grp for grp in coll._pool_groups
                             if grp[3] == ["hist_item"])
    tw = coll.total_width
    slots = r.inverse.view(tw, B)[o:o + w].T      # [B, 32], strided
    valid = (r.uslots != cap)[r.inverse].view(tw, B)[o:o + w].T
    pad = int((~valid).sum())
    log(f"DSSM shape: {r.inverse.shape[0]} ids, {n_real} unique keys in {u} "
        f"lanes (int32 inverse); hist_item [{B}, {w}] {comb}, {pad} padded "
        f"lanes")
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(B, EMB_DIM, generator=g).to(dev)
    # the library's mean: invalid lanes point at an extra padding row
    ext = torch.cat([urows, torch.zeros(1, EMB_DIM, device=dev)])
    lidx = torch.where(valid, slots, u).long()
    pair = k2_pair(
        f"(DSSM hist_item, [{B}, {w}] {comb}, D {EMB_DIM})", urows, slots,
        valid, comb, d_pooled,
        lambda: Fn.embedding_bag(lidx, ext, mode="mean", padding_idx=u),
        "w32_mean")
    table = torch.randn(cap + 1, EMB_DIM, generator=g).to(dev)
    pair.append(k1_case("(DSSM unique-row fetch)", table, r.uslots, "dssm"))
    for e in pair:
        e["path"] = "zoo_dssm"
    return entries + pair


# -- phase 11: the sequence models --------------------------------------------
def model_kind(kind):
    """How the zoo and seq phases build and feed one model: its trainer
    (given the device), a fresh model for a Predictor, its numeric
    columns, forward hook, batch maker (seed, count) and lockstep steps,
    all from its modelzoo entry point. ``seq``: a sequence model, whose
    phase also holds the null row at zero (K2 zeroes a padded history lane
    where JAX reads that row) and profiles 3 staged steps."""
    spec, seq = zoo_spec(kind), kind in SEQ_MODELS
    return dict(trainer=lambda d: zoo_trainer(kind, d),
                model=lambda: zoo_spec(kind).model,
                numeric=spec.numeric_columns, forward=spec.forward,
                batches=lambda s_, n: zoo_batches(kind, s_, n),
                steps=SEQ_STEPS if seq else ZOO_STEPS, seq=seq)


def check_models(dev, smi, tmp, phase, kinds):
    """Phases 10 (``zoo``) and 11 (``seq``): each model of ``kinds`` as its
    zoo trainer builds it: its lockstep steps with a CPU trainer, after
    which its dense parameters and running statistics (which must have
    moved) are within ROW_ATOL of the CPU's; 3 timed runs of 10 staged
    steps; K1, K2 and K2's backward launched on its path; a save served by
    a card and a CPU Predictor, both holding the trained dense leaves.
    Returns the launches by path and the summary."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.models.ctr import flax_leaf_count, flax_leaves
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.train import metrics
    counters = path_counters(seq=phase == "seq")
    paths, out = {}, {}
    for kind in kinds:
        spec, what = model_kind(kind), f"{phase} {kind}"
        t0, steps = time.perf_counter(), spec["steps"]
        batches = spec["batches"](7, steps + 30 + 3 * spec["seq"])
        held = spec["batches"](11, 2)
        tg, tc = spec["trainer"](dev), spec["trainer"]("cpu")
        for fn in counters.values():
            fn.launches = 0
        sg, _, dloss, drow = lockstep(tg, tc, batches[:steps], what)
        trained = flax_leaves(tg.model)
        ddense = max(float(np.abs(a - c).max())
                     for a, c in zip(trained, flax_leaves(tc.model)))
        n_stats = flax_leaf_count(tg.model) - len(list(tg.model.parameters()))
        if not ddense <= ROW_ATOL:
            fail(f"{what}: dense parameters and running statistics differ "
                 f"by {ddense} between card and CPU")
        if n_stats and np.allclose(trained[0], 0.0):
            fail(f"{what}: the running statistics did not move")
        del tc
        if spec["seq"]:
            coll = tg.collections["emb"]
            if bool(sg.tables["emb"].ev.values[coll.config.capacity].any()):
                fail(f"{what}: the null row moved in training")
        sg, staged = timed_runs(tg, sg, batches[steps:steps + 30])
        launches = {k: fn.launches for k, fn in counters.items()}
        paths[f"{phase}_{kind}"] = launches
        for k in ("gather_rows", "fused_pooled_lookup",
                  "fused_pooled_lookup_backward") + (
                      ("gru_scan", "gru_scan_backward") if kind == "dien"
                      else ()) + (
                      ("din_attention", "din_attention_backward")
                      if kind in SEQ_MODELS else ()):
            if launches[k] <= 0:
                fail(f"{k} was not launched on the {what} path")
        med, dev_ms = statistics.median(staged), None
        if spec["seq"]:
            sg, dev_ms = profile_steps(tg, sg, batches[steps + 30:],
                                       B / med * 1e3, what)
        summ = metrics.summarize(sg.metrics)
        if not (summ["examples"] == sg.step * B
                and np.isfinite(summ["loss"])):
            fail(f"{what} metrics are off: {summ}")

        path = os.path.join(tmp, kind)
        CheckpointManager(path).save(tg, sg)
        gpu, cpu = (Predictor(spec["model"](), spec["numeric"],
                              tg.collections, path, device=d,
                              forward=spec["forward"])
                    for d in (dev, "cpu"))
        trained = flax_leaves(tg.model)
        for p in (gpu, cpu):
            if not all(np.array_equal(a, b) for a, b in zip(
                    flax_leaves(p.model), trained)):
                fail(f"{what}: a Predictor's dense leaves are not the "
                     "trained ones")
        dp = _compare_predictors(gpu, cpu, held, f"{what} serving")
        inv32 = {n: not w.inv16 for n, w in tg.prepare_batch(
            held[0], train=False)[1].items()}
        health = {n: (h["size"], h["max_n_unique"], h["max_unique"])
                  for n, h in tg.table_health(sg).items()}
        log(f"{what} ({sg.step} steps) launches: {launches}; examples/s at "
            f"B={B}, staged host half: median {med:.1f}, min "
            f"{min(staged):.1f}, max {max(staged):.1f} over 3 runs of 10 "
            f"steps, on {smi}; max |dparam| and |dstat| after the lockstep "
            f"{ddense:.3g} ({n_stats} statistics); card vs CPU Predictor "
            f"over its save: max |dp| {dp:.3g}; tables (size, max unique, "
            f"max_unique): {health}; int32 inverse wire: {inv32}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        out[kind] = {"staged_eps": staged, "max_dloss": dloss,
                     "max_drow": drow, "max_ddense": ddense, "serve_dp": dp,
                     "tables": health, "inverse_int32": inv32,
                     "summary": summ}
        if dev_ms is not None:
            out[kind]["device_ms_per_step"] = dev_ms
        del tg, sg, gpu, cpu
    return paths, out


def check_seq_kernels(dev):
    """K2 and K2's backward at the history expansion of one resolved DIN
    batch ([2*4096*32, 1] one-id sum bags over its int32 inverse, the
    padded ids not valid), and K1 at its 205,825 lanes. K2 is timed beside
    ``embedding_bag`` (the one library call) and ``index_select`` +
    ``where`` (the JAX package's gather, then the mask)."""
    import torch.nn.functional as Fn
    from deeprec_tpu_torch.ops.fused_lookup import fused_pooled_lookup_plain
    g = torch.Generator().manual_seed(SEED + 3)
    coll = zoo_trainer("din", dev).collections["emb"]
    cap = coll.config.capacity
    wire = coll.pack_ids(zoo_batches("din", 7, 1)[0], dev)
    r = wire.decode()
    u, n_real = r.uslots.shape[0], int(r.n_unique)
    if wire.inv16:
        fail(f"DIN's wire has {u} lanes and an int16 inverse")
    (o, w, _, names), = coll._seq_groups
    n, tw = len(names), coll.total_width
    # the collection's own layout: ids ordered [column, B, L]
    slots = r.inverse.view(tw, B)[o:o + n * w].view(n, w, B).transpose(
        1, 2).reshape(-1, 1)
    valid = (r.uslots != cap)[r.inverse].view(tw, B)[o:o + n * w].view(
        n, w, B).transpose(1, 2).reshape(-1, 1)
    pad = int((~valid).sum())
    log(f"DIN shape: {r.inverse.shape[0]} ids, {n_real} unique keys in {u} "
        f"lanes (int32 inverse); {names} expanded as [{n}*{B}*{w}, 1] sum "
        f"bags, {pad} padded lanes")
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    pair = k2_pair(
        f"(DIN histories, [{n}*{B}*{w}, 1] sum, D {EMB_DIM})", urows, slots,
        valid, "sum", d_pooled,
        lambda: Fn.embedding_bag(slots, urows,
                                 per_sample_weights=valid.float(),
                                 mode="sum"),
        "seq")
    # the JAX package's way, two calls: gather every id, zero the padding
    def gather_where():
        return torch.where(valid, torch.index_select(urows, 0, slots[:, 0]),
                           0.0)
    if not torch.equal(gather_where(), fused_pooled_lookup_plain(
            urows, slots, valid, "sum")):
        fail("index_select + where computes another function")
    pair[0]["gather_where_ms"] = time_ms(gather_where)
    log(f"K2 at the DIN histories beside index_select + where: "
        f"{pair[0]['ms']:.4f} vs {pair[0]['gather_where_ms']:.4f} ms")
    table = torch.randn(cap + 1, EMB_DIM, generator=g).to(dev)
    pair.append(k1_case("(DIN unique-row fetch)", table, r.uslots, "din"))
    for e in pair:
        e["path"] = "seq_din"
    return pair


# -- phase 12: the entry points: the other optimizers, bf16, the CLI ---------
def optim_cases():
    """The sparse optimizers ported last and group_lasso, each with the
    dense optimizer the CLI pairs with it (``cli.make_dense_opt``) and
    its fused slot columns: (label, sparse, dense, fused columns). The
    decays run a period every 2 steps, so rows catch up lazily."""
    from deeprec_tpu_torch.optim import dense as D
    from deeprec_tpu_torch.optim import sparse as S
    lr = 0.05
    return [
        ("sgd", S.sparse_sgd(lr), D.SGD(lr), 0),
        ("adagrad_decay", S.sparse_adagrad_decay(
            lr, accumulator_decay_step=2), D.Adagrad(lr), 0),
        ("adagrad_decay_v2", S.sparse_adagrad_decay_v2(
            lr, accumulator_decay_step=2), D.Adagrad(lr), 0),
        ("adam_fused", S.sparse_adam_fused(0.002), D.Adam(0.002),
         2 * EMB_DIM),
        ("adam_async", S.sparse_adam_async(0.002), D.Adam(0.002), 0),
        ("adam_async_rmsprop", S.sparse_adam_async(
            0.002, apply_sparse_rmsprop=True), D.Adam(0.002), 0),
        ("momentum", S.sparse_momentum(lr), D.SGD(lr, momentum=0.9), 0),
        ("proximal_gd", S.sparse_proximal_gradient_descent(
            lr, l1_regularization_strength=1e-3,
            l2_regularization_strength=1e-2), D.SGD(lr), 0),
        ("proximal_adagrad", S.sparse_proximal_adagrad(
            lr, l1_regularization_strength=1e-3,
            l2_regularization_strength=1e-2), D.Adagrad(lr), 0),
        ("group_lasso(adagrad)", S.group_lasso(S.sparse_adagrad(lr), 0.01),
         D.Adagrad(lr), 0),
    ]


def optim_apply_pair(sparse, tc, sc, batch, dev):
    """One apply of ``sparse`` on the card and on the CPU from the same
    inputs: the CPU trainer's rows and slot leaves (copied to the card),
    the lanes of one resolved batch (created, masked and null-row lanes
    among them) and a gradient from a fixed generator; the current rows
    are read through K1 on the card. Returns the largest difference of the
    rows and float slot leaves relative to their largest magnitude;
    integer and 0-d leaves must agree (the powers within OPTIM_APPLY_RTOL
    too)."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths, map_leaves
    st = sc.tables["emb"]
    r = tc.prepare_batch(batch)[1]["emb"].decode()
    cap = st.ev.capacity
    g = torch.Generator().manual_seed(SEED + 5)
    grads = 1e-3 * torch.randn(r.uslots.shape[0], EMB_DIM, generator=g)
    mask = r.uslots != cap
    outs = []
    for d in ("cpu", dev):
        values = st.ev.values.clone().to(d)
        slot = map_leaves(lambda _, x: x.clone().to(d), st.slot)
        outs.append(sparse.apply(values, slot, r.uslots.to(d), grads.to(d),
                                 mask.to(d), int(sc.step),
                                 created=r.created.to(d)))
    (vc, sc_), (vg, sg_) = outs
    worst = 0.0
    for (path, a), (_, c) in zip([("values", vg)] + leaves_with_paths(sg_),
                                 [("values", vc)] + leaves_with_paths(sc_)):
        a = a.cpu()
        if not c.dtype.is_floating_point:
            if not torch.equal(a, c):
                fail(f"optim apply: {path} differs between card and CPU")
            continue
        err = ((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        if not err <= OPTIM_APPLY_RTOL:
            fail(f"optim apply: {path} differs by {err} of its magnitude "
                 f"between card and CPU")
    return worst


def adam_lockstep(tg, tc, batches, what):
    """:func:`lockstep` for the Adam family (dense Adam under the DLRM):
    wires and metadata planes bit-equal, losses within LOSS_ATOL, slot
    leaves within ROW_ATOL (integer and 0-d leaves too), but each step
    starts the CPU trainer from the card's float state
    (:func:`float_leaves`: rows, slot leaves, dense parameters and
    moments), and the rows and dense parameters are held
    within ROW_ATOL at every element whose first moment agrees between
    card and CPU within ADAM_M_RTOL; at most ADAM_NOISE_SHARE of the
    elements Adam stepped (a nonzero moment on either side) may be left
    out. Returns the states, the largest |dloss|, the largest difference
    of a kept element and the largest share left out at a step."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths

    def moved(sg, sc):
        """The rows and the dense parameters: lists of (card, CPU, card m,
        CPU m)."""
        eg, ec = sg.tables["emb"], sc.tables["emb"]
        vg, vc = eg.ev.values, ec.ev.values
        if vc.shape[1] > EMB_DIM:   # adam_fused: [value | m | v]
            mg, mc = vg[:, EMB_DIM:2 * EMB_DIM], vc[:, EMB_DIM:2 * EMB_DIM]
        else:
            mg, mc = eg.slot["m"], ec.slot["m"]
        return {"rows": [(vg[:, :EMB_DIM], vc[:, :EMB_DIM], mg, mc)],
                "dense parameters": list(zip(
                    tg.model.parameters(), tc.model.parameters(),
                    sg.opt_state.mu, sc.opt_state.mu))}

    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    dloss = dkept = share = 0.0
    for i, b in enumerate(batches):
        if i:
            with torch.no_grad():   # the CPU starts from the card's state
                for a, c in zip(float_leaves(tg, sg), float_leaves(tc, sc)):
                    c.copy_(a)
        dg, cg, lg = tg.prepare_batch(b)
        dc, cc, lc = tc.prepare_batch(b)
        for name in cc:
            if not torch.equal(cg[name].buf.cpu(), cc[name].buf):
                fail(f"{what}: card and CPU {name} resolves differ at step "
                     f"{i}")
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg = tg._train_step(sg, dg, cg, lg)
        sc = tc._train_step(sc, dc, cc, lc)
        lg_, lc_ = ((sg.metrics.loss_sum.item() - g0) / B,
                    (sc.metrics.loss_sum.item() - c0) / B)
        if not (np.isfinite(lg_) and abs(lg_ - lc_) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg_} on the card vs {lc_} on CPU")
        dloss = max(dloss, abs(lg_ - lc_))
        for group, arrays in moved(sg, sc).items():
            left = stepped = 0
            for a, c, ma, mc in arrays:
                a, ma = a.detach().cpu(), ma.cpu()
                c = c.detach()
                noise = (ma - mc).abs() > ADAM_M_RTOL * mc.abs()
                d = torch.where(noise, 0.0, (a - c).abs()).max().item()
                dkept = max(dkept, d)
                if not d <= ROW_ATOL:
                    fail(f"{what}: step {i}: {group} whose first moment "
                         f"agrees differ by {d} between card and CPU")
                left += int(noise.sum())
                stepped += int(((ma != 0) | (mc != 0)).sum())
            share = max(share, left / max(stepped, 1))
            if not left <= ADAM_NOISE_SHARE * stepped:
                fail(f"{what}: step {i}: the first moments of {left} of "
                     f"the {stepped} stepped elements of the {group} differ "
                     f"by more than {ADAM_M_RTOL} between card and CPU")
    for name in tc.collections:
        eg, ec = sg.tables[name], sc.tables[name]
        for f in ("freqs", "versions", "create_steps"):
            if not torch.equal(getattr(eg.ev, f).cpu(), getattr(ec.ev, f)):
                fail(f"{what}: {name} {f} planes differ between card and "
                     f"CPU")
        for (p, a), (_, c) in zip(leaves_with_paths(eg.slot),
                                  leaves_with_paths(ec.slot)):
            ok = (torch.equal(a.cpu(), c) if not c.dtype.is_floating_point
                  else (a.cpu() - c).abs().max().item() <= ROW_ATOL)
            if not ok:
                fail(f"{what}: {name} slot {p} differs between card and CPU")
    log(f"{what}: {len(batches)} steps in lockstep with a CPU trainer that "
        f"starts each step from the card's state: wires and metadata planes "
        f"bit-equal, max |dloss| {dloss:.3g} (limit {LOSS_ATOL}), max |d| "
        f"of rows and dense parameters {dkept:.3g} (limit {ROW_ATOL}) with "
        f"at most {share:.3g} of the stepped elements left out (first "
        f"moments apart by more than {ADAM_M_RTOL}; limit "
        f"{ADAM_NOISE_SHARE}); slot leaves within {ROW_ATOL}")
    return sg, sc, dloss, dkept, share


def dense_apply_pair(dense, tc, sc, dev):
    """One step of the dense optimizer ``dense`` on the card and on the
    CPU from the same inputs: the CPU trainer's parameters and optimizer
    state (copied to the card) and gradients from a fixed generator.
    Returns the largest difference of the parameters and float state
    leaves relative to their largest magnitude; integer leaves (Adam's
    count) must agree."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths, map_leaves
    g = torch.Generator().manual_seed(SEED + 6)
    grads = [1e-2 * torch.randn(p.shape, generator=g)
             for p in tc.model.parameters()]
    outs = []
    for d in ("cpu", dev):
        params = [p.detach().clone().to(d) for p in tc.model.parameters()]
        for p, gr in zip(params, grads):
            p.grad = gr.to(d)
        state = map_leaves(lambda _, x: x.clone().to(d), sc.opt_state)
        dense.step(params, state)
        outs.append((params, state))
    worst = 0.0
    for (path, a), (_, c) in zip(leaves_with_paths(outs[1]),
                                 leaves_with_paths(outs[0])):
        a = a.cpu()
        if not c.dtype.is_floating_point:
            if not torch.equal(a, c):
                fail(f"dense apply: {path} differs between card and CPU")
            continue
        err = ((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        if not err <= OPTIM_APPLY_RTOL:
            fail(f"dense apply: {path} differs by {err} of its magnitude "
                 f"between card and CPU")
    return worst


def check_optimizers(dev, smi):
    """Each case of :func:`optim_cases` on bench.py's DLRM (a 2^21-row
    host-index table, light layout; the weights the entry point draws,
    ``cli.init_params`` from SEED) for OPTIM_STEPS steps in lockstep with
    a CPU trainer (:func:`lockstep`: wires bit-equal, losses within
    LOSS_ATOL, rows, float slot leaves and dense parameters within
    ROW_ATOL; adagrad_decay's int32 last_period and the beta powers' 0-d
    leaves compared too; the Adam family through :func:`adam_lockstep`),
    then one apply of the sparse optimizer (:func:`optim_apply_pair`) and
    one of the dense optimizer (:func:`dense_apply_pair`) on the card and
    on the CPU from the same inputs within OPTIM_APPLY_RTOL; K1, K2 and
    K2's backward launched. Returns the launches and the summary."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.models.ctr import flax_leaves
    from deeprec_tpu_torch.train import cli
    from deeprec_tpu_torch.train.trainer import Trainer
    numeric, _, _ = criteo_parts()
    counters = path_counters()
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
        OPTIM_STEPS + 1))
    for fn in counters.values():
        fn.launches = 0
    out, t0 = {}, time.perf_counter()
    for label, sparse, dense, fused in optim_cases():
        tg, tc = (Trainer(cli.init_params(criteo_parts()[2], SEED),
                          numeric, {"emb": host_collection(
                              False, fused_slot_columns=fused,
                              fused_slot_init=0.0)},
                          {"emb": sparse}, dense, device=d)
                  for d in (dev, "cpu"))
        if "adam" in label:
            sg, sc, dloss, drow, left = adam_lockstep(
                tg, tc, batches[:OPTIM_STEPS], f"optim {label}")
            ddense = drow   # one maximum over rows and dense parameters
        else:
            sg, sc, dloss, drow = lockstep(tg, tc, batches[:OPTIM_STEPS],
                                           f"optim {label}")
            ddense, left = max(float(np.abs(a - c).max()) for a, c in zip(
                flax_leaves(tg.model), flax_leaves(tc.model))), 0.0
            if not ddense <= ROW_ATOL:
                fail(f"optim {label}: dense parameters differ by {ddense}")
        del tg, sg
        dapply = optim_apply_pair(sparse, tc, sc, batches[OPTIM_STEPS], dev)
        ddapply = dense_apply_pair(dense, tc, sc, dev)
        out[label] = {"max_dloss": dloss, "max_drow": drow,
                      "max_ddense": ddense, "left_out": left,
                      "apply_rel_err": dapply, "dense_apply_rel_err": ddapply}
        del tc, sc
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in ("gather_rows", "fused_pooled_lookup",
              "fused_pooled_lookup_backward"):
        if launches[k] <= 0:
            fail(f"{k} was not launched on the optimizers' path")
    log(f"optim: {len(out)} sparse optimizers, each {OPTIM_STEPS} steps of "
        f"bench.py's DLRM in lockstep with a CPU trainer, then one sparse "
        f"and one dense apply card vs CPU from the same inputs: "
        + "; ".join(f"{k} |dloss| {v['max_dloss']:.3g} |drow| "
                    f"{v['max_drow']:.3g} |dparam| {v['max_ddense']:.3g} "
                    f"left out {v['left_out']:.3g} apply "
                    f"{v['apply_rel_err']:.3g} dense apply "
                    f"{v['dense_apply_rel_err']:.3g}"
                    for k, v in out.items())
        + f" (limits: loss {LOSS_ATOL}, rows and parameters {ROW_ATOL}, "
        f"left out {ADAM_NOISE_SHARE}, apply {OPTIM_APPLY_RTOL} of the "
        f"magnitude); launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    return launches, out


def check_bf16_forward(dev):
    """The --bf16 DLRM (towers in bf16, float32 parameters) built by its
    entry point on the card and on the CPU from one seed: the logits of
    one batch of inputs agree within BF16_FWD_TOL of their largest
    magnitude, and on average by less than half their distance from the
    float32 model's (so the card computes the bf16 function)."""
    from deeprec_tpu_torch.train import cli
    g = torch.Generator().manual_seed(SEED + 4)
    dense = torch.randn(B, 13, generator=g)
    emb = {f"C{i}": 0.05 * torch.randn(B, EMB_DIM, generator=g)
           for i in range(1, 27)}
    logits = {}
    for d, extra in ((dev, ["--bf16"]), ("cpu", ["--bf16"]), ("cpu", [])):
        mod, args = zoo_entry("dlrm", d, extra)
        model = cli.init_params(mod.build(args).model, SEED).to(d)
        with torch.no_grad():
            logits[(str(d), bool(extra))] = model(
                dense.to(d), {k: v.to(d) for k, v in emb.items()}).cpu()
    card, cpu = logits[(str(dev), True)], logits[("cpu", True)]
    f32 = logits[("cpu", False)]
    err = (card - cpu).abs().max().item()
    mean_err = (card - cpu).abs().mean().item()
    scale = cpu.abs().max().item()
    gap = (cpu - f32).abs().mean().item()
    if not (torch.isfinite(card).all() and err <= BF16_FWD_TOL * scale
            and mean_err < 0.5 * gap):
        fail(f"bf16 DLRM forward: card vs CPU logits differ by {err} "
             f"(mean {mean_err}; max |logit| {scale}, mean bf16 vs f32 "
             f"{gap})")
    log(f"bf16 DLRM forward at B={B}: card vs CPU max |dlogit| {err:.3g} "
        f"(limit {BF16_FWD_TOL} x max |logit| {scale:.3g}), mean "
        f"{mean_err:.3g}; mean |bf16 - f32| towers on the CPU {gap:.3g}")
    return {"max_dlogit": err, "mean_dlogit": mean_err, "max_logit": scale,
            "mean_bf16_vs_f32": gap}


def write_criteo_files(d, n_files, rows, seed=0):
    """Criteo TSV files made from SyntheticCriteo: label, 13 integer
    columns, 26 hex tokens (nothing downloaded)."""
    from deeprec_tpu_torch.data.criteo import (CAT_NAMES, DENSE_NAMES,
                                               SyntheticCriteo)
    paths = []
    for f in range(n_files):
        b = next(iter(SyntheticCriteo(batch_size=rows, seed=seed + f)))
        cols = [b["label"].astype(np.int64).astype(str)]
        cols += [np.round(b[n] * 100).astype(np.int64).astype(str)
                 for n in DENSE_NAMES]
        cols += [np.char.mod("%08x", b[n] & 0xFFFFFFFF) for n in CAT_NAMES]
        path = os.path.join(d, f"day_{f}.tsv")
        with open(path, "w") as fh:
            fh.write("\n".join("\t".join(r) for r in zip(*cols)) + "\n")
        paths.append(path)
    return paths


def cli_runs(tmp):
    """The cli phase's runs: (kind, --optimizer, extra flags, host-index?).
    On the host-index engine: each of the ten --optimizer choices once,
    each model at least once; --bf16 on DLRM and DCN; the metadata layout
    (K3a) by admission and eviction on DCN and by incremental saves on the
    DLRM that is then served; WDL from Criteo files through a WorkQueue.
    On the device-index engine (no --host_index): DLRM and DIN, DLRM with
    --micro_batch 2, and DLRM with --ev_storage hbm_dram under a device row
    budget below its live rows (demotion at every fence: K3a by the
    version stamps tiering needs)."""
    files = write_criteo_files(tmp, 3, 2 * B)
    host = [
        ("dlrm", "adagrad", ["--bf16"]),
        ("dlrm", "sgd", ["--checkpoint", os.path.join(tmp, "ck"),
                         "--incr_save_secs", "1e-9"]),
        ("dcn", "adagrad_decay", ["--bf16"]),
        ("dcn", "proximal_gd", ["--ev_filter_freq", "2",
                                "--ev_evict_steps", str(CLI_STEPS // 2)]),
        ("wdl", "momentum", []),
        ("deepfm", "ftrl", []),
        ("dssm", "adagrad_decay_v2", []),
        ("din", "adam", []),
        ("dien", "adam_async", []),
        ("wdl", "proximal_adagrad", [
            "--data_location", ",".join(files), "--workqueue",
            os.path.join(tmp, "queue"), "--steps", str(CLI_CRITEO_STEPS),
            "--log_steps", str(CLI_CRITEO_STEPS // 2)]),
    ]
    device = [
        ("dlrm", "adagrad", []),
        ("din", "adam", []),
        ("dlrm", "adagrad", ["--micro_batch", "2"]),
        ("dlrm", "adagrad", ["--ev_storage", "hbm_dram", "--ev_hbm_capacity",
                             str(CLI_TIER_HBM), "--demote_steps",
                             str(CLI_FENCE)]),
    ]
    return [r + (True,) for r in host] + [r + (False,) for r in device]


def check_cli(dev, smi, tmp):
    """Phase 12's ``cli`` runs: every model through its entry point
    (``cli.run(build(args), args)``, B 4096, emb 16, 2^21 rows, the
    towers' full widths, CLI_STEPS steps with a fence at every CLI_FENCE)
    on the host-index engine and four runs on the device-index engine, as
    :func:`cli_runs` lists them: each run's JSON line finite and its step
    count right, the C++ resolver on the host-index runs, K1, K2 and K2's
    backward launched in every run and K3a in the metadata-layout ones,
    and the tiered run demoting rows at its fences.
    Then the served DLRM: the server's builder over the run's checkpoint
    (a full and an incremental save) answers HTTP predicts within
    PROB_ATOL of a CPU Predictor over the same directory. Returns the
    phase's launches and its summary."""
    import threading as th
    from deeprec_tpu_torch.checkpoint import format as F
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.serving.server import build_server
    from deeprec_tpu_torch.train import cli
    counters = path_counters(dlrm=True, seq=True)
    total = dict.fromkeys(counters, 0)
    out, t_phase = [], time.perf_counter()
    for kind, opt, own, host_index in cli_runs(tmp):
        mod, args = zoo_entry(kind, dev, [
            "--optimizer", opt, "--steps", str(CLI_STEPS), "--log_steps",
            str(CLI_FENCE), "--eval_steps", "2", "--capacity", str(CAPACITY),
            *own], host_index=host_index)
        spec = mod.build(args)
        if host_index:
            need_native(spec.collections, f"cli {kind}")
        meta = any(c.config.version_tracked or c.config.freq_tracked
                   for c in spec.collections.values())
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = cli.run(spec, args)
        wall = time.perf_counter() - t0
        sys.stdout.write(printed.getvalue())
        tier = [ln for ln in printed.getvalue().splitlines()
                if ln.startswith("host tier rows: ")]
        if "--ev_storage" in own and len(tier) != CLI_STEPS // CLI_FENCE:
            fail(f"cli {kind} {' '.join(own)}: demoted at {len(tier)} of "
                 f"{CLI_STEPS // CLI_FENCE} fences")
        launches = {k: fn.launches for k, fn in counters.items()}
        nums = [v for v in res.values() if isinstance(v, (int, float))]
        if not (res["steps"] == args.steps and np.isfinite(nums).all()
                and res["examples_per_sec"] > 0
                and 0.0 <= res["eval_auc"] <= 1.0):
            fail(f"cli {kind} {opt}: {res}")
        need = ["gather_rows", "fused_pooled_lookup",
                "fused_pooled_lookup_backward"] + (["lookup_meta"]
                                                   if meta else [])
        if kind == "dlrm":
            need += ["dot_interaction", "dot_interaction_backward"]
        if kind == "dien":
            need += ["gru_scan", "gru_scan_backward"]
        if kind in SEQ_MODELS:
            need += ["din_attention", "din_attention_backward"]
        for k in need:
            if launches[k] <= 0:
                fail(f"cli {kind} {opt}: {k} was not launched")
        for k, v in launches.items():
            total[k] += v
        flags = " ".join(["--host_index" if host_index else
                          "(device-index)"]
                         + [a for a in own if a.startswith("--")])
        log(f"cli {ZOO_ENTRY[kind]} --optimizer {opt} {flags}: "
            f"{res['steps']} steps, examples/s {res['examples_per_sec']} at "
            f"B={B} (the CLI's own count: host clock over the loop, fences "
            f"included), train loss {res['train_loss']}, eval auc "
            f"{res['eval_auc']}; run {wall:.1f} s; launches {launches}; "
            f"on {smi}")
        out.append({"model": ZOO_ENTRY[kind], "optimizer": opt,
                    "flags": flags, "result": res, "launches": launches,
                    "wall_s": wall})
        torch.cuda.empty_cache()
    q = os.path.join(tmp, "queue", "claims")
    if len(os.listdir(q)) < 2:
        fail(f"cli: the WorkQueue claimed {os.listdir(q)}")

    # train -> save -> serve: the DLRM run's checkpoint through the server
    ck = os.path.join(tmp, "ck")
    kinds = [m["kind"] for m in F.list_saves(ck)]
    if "incr" not in kinds or "full" not in kinds:
        fail(f"cli: the DLRM run saved {kinds}, not a full and an "
             "incremental save")
    srv, _ = build_server(["--model", "DLRM", "--ckpt_dir", ck, "--host",
                           "127.0.0.1", "--port", "0", "--", "--host_index",
                           "--emb_dim", str(EMB_DIM), "--capacity",
                           str(CAPACITY)])
    thread = th.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    spec = zoo_spec("dlrm")
    cpu = Predictor(spec.model, spec.numeric_columns, spec.collections, ck,
                    device="cpu")
    worst, url = 0.0, f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for b in zoo_batches("dlrm", 11, 2):
            got = _post(f"{url}/v1/predict", {"inputs": _cols(b, 0, 1024)})
            if got["step"] != CLI_STEPS:
                fail(f"cli serving: the server is at step {got['step']}")
            ref = cpu.predict({k: v[:1024] for k, v in b.items()})
            p = np.asarray(got["predictions"], np.float32)
            if p.shape != ref.shape or not np.isfinite(p).all():
                fail("cli serving: predictions of the wrong shape")
            worst = max(worst, float(np.abs(p - ref).max()))
        health = _get(f"{url}/healthz")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if not worst <= PROB_ATOL:
        fail(f"cli serving: HTTP vs CPU Predictor differ by {worst}")
    log(f"cli serving: the server's builder over the DLRM run's saves "
        f"{kinds} answered 2 HTTP predicts of 1024 rows within {worst:.3g} "
        f"of a CPU Predictor (limit {PROB_ATOL}); healthz {health}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, {"runs": out, "serve_dp": worst}


# -- phase 13: the device-index engine ---------------------------------------
def device_entry(dev, extra=()):
    """``deeprec_tpu_torch/modelzoo/DLRM/train.py`` without --host_index,
    as the issue's device phase runs it: B 4096, emb dim 16, 2^21 rows,
    --optimizer adagrad (the CLI makes it fused Adagrad columns),
    --max_unique_ratio 0.25, --ev_filter_freq 2 --ev_evict_steps 20 (the
    metadata layout, so kernel K3a on the path), weights from --seed, on
    ``dev``, with ``extra`` flags."""
    import importlib
    from deeprec_tpu_torch.train import cli
    mod = importlib.import_module("deeprec_tpu_torch.modelzoo.DLRM.train")
    args = cli.base_parser("DLRM").parse_args(
        ["--batch_size", str(B), "--emb_dim", str(EMB_DIM), "--capacity",
         str(CAPACITY), "--seed", str(SEED), "--device", str(dev),
         *DEVICE_FLAGS, *extra])
    return mod, args


def device_trainer(dev, extra=()):
    """The device-index DLRM's trainer as the CLI makes it
    (``cli.make_trainer``: the dedup cap, the fused Adagrad columns, a
    TieredTrainer for --ev_storage hbm_dram, --micro_batch, the weights)."""
    from deeprec_tpu_torch.train import cli
    mod, args = device_entry(dev, extra)
    tr = cli.make_trainer(mod.build(args), args)
    if type(tr.collections["emb"]).__name__ != "EmbeddingCollection":
        fail("the device phase did not get a device-index collection")
    return tr


def device_same_tables(tg, sg, tc, sc, what, compare_rows=True):
    """Key planes, metadata planes and CBF counters bit-equal between the
    card's and the CPU's state; rows, slot leaves and dense parameters
    within ROW_ATOL. Returns the largest row or parameter difference."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    worst = 0.0
    for name in tc.collections:
        eg, ec = sg.tables[name].ev, sc.tables[name].ev
        planes = [("keys", eg.index.keys, ec.index.keys)] + [
            (f, getattr(eg, f), getattr(ec, f))
            for f in ("freqs", "versions", "create_steps")]
        if ec.cbf is not None:
            planes.append(("cbf", eg.cbf, ec.cbf))
        for f, a, c in planes:
            if not torch.equal(a.cpu(), c):
                fail(f"{what}: {name} {f} differ between card and CPU")
        if not compare_rows:
            continue
        leaves = [("rows", eg.values, ec.values)] + [
            (f"slot {p}", a, c) for (p, a), (_, c) in zip(
                leaves_with_paths(sg.tables[name].slot),
                leaves_with_paths(sc.tables[name].slot))]
        for leaf, a, c in leaves:
            d = (a.cpu().float() - c.float()).abs().max().item()
            worst = max(worst, d)
            if not d <= ROW_ATOL:
                fail(f"{what}: {name} {leaf} differ by {d} between card "
                     f"and CPU")
    if compare_rows:
        for (n, a), b in zip(tg.model.named_parameters(),
                             tc.model.parameters()):
            d = (a.detach().cpu() - b.detach()).abs().max().item()
            worst = max(worst, d)
            if not d <= ROW_ATOL:
                fail(f"{what}: parameter {n} differs by {d} between card "
                     f"and CPU")
    return worst


def device_lockstep(tg, tc, batches, what, fence=None):
    """Train the card and CPU trainers on ``batches`` through
    ``train_step`` (a TieredTrainer promotes first), the per-step loss
    within LOSS_ATOL and the key planes bit-equal after every step;
    ``fence(i, sg, sc)`` runs after step ``i`` on both states. Then the
    tables and parameters (:func:`device_same_tables`). Returns the
    states, the largest loss and row differences."""
    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    worst = 0.0
    for i, b in enumerate(batches):
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg, sc = tg.train_step(sg, b), tc.train_step(sc, b)
        lg = (sg.metrics.loss_sum.item() - g0) / B
        lc = (sc.metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg) and abs(lg - lc) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg} on the card vs {lc} on CPU")
        worst = max(worst, abs(lg - lc))
        if not torch.equal(sg.tables["emb"].ev.index.keys.cpu(),
                           sc.tables["emb"].ev.index.keys):
            fail(f"{what}: card and CPU key planes differ after step {i}")
        if fence is not None:
            sg, sc = fence(i, sg, sc)
    drow = device_same_tables(tg, sg, tc, sc, what)
    ev = sc.tables["emb"].ev
    log(f"{what}: {len(batches)} steps in lockstep with a CPU trainer: key "
        f"and metadata planes bit-equal every step, max |dloss| {worst:.3g} "
        f"(limit {LOSS_ATOL}), max |drow|, |dslot| and |dparam| {drow:.3g} "
        f"(limit {ROW_ATOL}); {int(ev.index.size)} keys in "
        f"{ev.capacity} slots, {int((ev.freqs >= 2).sum())} admitted")
    return sg, sc, worst, drow


def count_syncs(fn):
    """Run ``fn`` with torch's sync debug mode on; returns the synchronising
    calls it made, by the line that made them. A sync raised in torch's
    own Python code is counted as ``torch's line < the innermost line of
    this repository on the stack``, the caller that reached it. The one
    that turning the mode on raises itself, the first time a process does
    (torch 2.11: ``torch/cuda/__init__.py:1270``), is not ``fn``'s and is
    left out."""
    import collections
    import traceback
    import warnings
    where = collections.Counter()
    ours = REPO + os.sep

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = f"{os.path.relpath(filename, REPO)}:{lineno}"
        if not os.path.abspath(filename).startswith(ours):
            for fr in reversed(traceback.extract_stack()[:-1]):
                if os.path.abspath(fr.filename).startswith(ours):
                    if "set_sync_debug_mode" in (fr.line or ""):
                        return  # the switch below, not fn
                    site += (f" < {os.path.relpath(fr.filename, REPO)}:"
                             f"{fr.lineno}")
                    break
        where[site] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show  # called where the warning is raised
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return where


HASH_MODULES = ("deeprec_tpu_torch/sparse/hashtable.py",
                "deeprec_tpu_torch/ops/hash_probe.py")


def no_hash_syncs(syncs, what):
    """Fail if any of ``syncs`` (:func:`count_syncs`) was made in, or
    reached from, the hash table's modules."""
    bad = {k: v for k, v in syncs.items()
           if any(m in k for m in HASH_MODULES)}
    if bad:
        fail(f"{what}: the hash table syncs with the host: {bad}")


def check_device_kernels(dev):
    """K1, K2, K2's backward and K3a at the device-index engine's shapes,
    from one B=4096 batch of the device phase's DLRM: ``unique_cols`` over
    the [26, 4096] ids (U = 26,625 lanes at --max_unique_ratio 0.25, int64
    inverse and slots) and ``lookup_or_insert`` into its 2^21-slot index;
    K5 at that insert, first step and steady, and at growth's rebuild of a
    2^16-slot index at 0.7 load into 2^17 slots. Returns the entries (path
    ``device``)."""
    import torch.nn.functional as Fn
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.unique import unique_cols
    from deeprec_tpu_torch.sparse import hashtable as ht
    g = torch.Generator().manual_seed(SEED + 4)
    tr = device_trainer(dev)
    coll = tr.collections["emb"]
    cfg, cap = coll.config, coll.config.capacity
    ids = torch.from_numpy(coll.pack_ids_np(
        next(SyntheticCriteo(batch_size=B, seed=7)))).to(dev)
    uniq = unique_cols(ids, cfg.max_unique)
    index, uslots, created = ht.lookup_or_insert(ht.create(cap, dev),
                                                 uniq.ukeys, cfg.max_probes)
    u, n_real = uslots.shape[0], int(uniq.n_unique)
    slots = uniq.inverse.view(-1, 1)
    valid = (uslots != cap)[uniq.inverse].view(-1, 1)
    log(f"device-index shape: {uniq.inverse.shape[0]} ids, {n_real} unique "
        f"keys ({int(uniq.n_overflow)} past the cap) in {u} lanes, int64 "
        f"inverse and slots")
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    entries = k2_pair(
        f"(device-index, [26*{B}, 1] sum, D {EMB_DIM}, int64 inverse)",
        urows, slots, valid, "sum", d_pooled,
        lambda: Fn.embedding_bag(slots, urows,
                                 per_sample_weights=valid.float(),
                                 mode="sum"),
        "device")
    table = torch.randn(cap + 1, 2 * EMB_DIM, generator=g).to(dev)
    entries.append(k1_case("(device-index unique-row fetch, int64 slots)",
                           table, uslots, "device", d=EMB_DIM))

    # K3a: the metadata step of lookup_or_create_unique (CounterFilter(2),
    # GlobalStepEvict: create steps, versions, freqs, the admission test)
    entries.append(k3a_case(
        f"(device-index shape, planes of {cap + 1})", "_device", uslots,
        uniq.counts.to(torch.int32),
        torch.zeros((1,), dtype=torch.bool, device=dev),
        torch.where(created, uslots, cap + 1), cap,
        cfg.counter_filter.filter_freq))

    # K5: the step's lookup_or_insert, first (every key created) and
    # steady (every key found in the first round); growth's rebuild of a
    # 2^16-slot table at the 0.7 load that triggers it into 2^17 slots
    entries.append(hash_case("insert", "(device-index first step)",
                             ht.create(cap, dev), uniq.ukeys, "device_first",
                             cfg.max_probes))
    entries.append(hash_case("insert", "(device-index steady step)", index,
                             uniq.ukeys, "device_steady", cfg.max_probes))
    small = ht.create(DEVICE_GROW_CAPACITY, dev)
    for b in SyntheticCriteo(batch_size=B, seed=7):
        bu = unique_cols(torch.from_numpy(coll.pack_ids_np(b)).to(dev),
                         cfg.max_unique)
        small, _, _ = ht.lookup_or_insert(small, bu.ukeys, cfg.max_probes)
        if int(small.size) >= 0.7 * DEVICE_GROW_CAPACITY:
            break
    entries.append(hash_case(
        "insert", f"(growth rebuild: {int(small.size)} keys of a "
        f"{DEVICE_GROW_CAPACITY}-slot plane)",
        ht.create(2 * DEVICE_GROW_CAPACITY, dev), small.keys, "growth",
        cfg.max_probes))
    for e in entries:
        e["path"] = "device"
    return entries


def device_tiers(tr):
    """The tier's rows sorted by key: (keys, payload)."""
    kv = tr.tiers["emb"]
    if kv is None or not len(kv):
        return np.zeros((0,), np.int64), None
    keys, rows = kv.export()
    order = np.argsort(keys)
    return keys[order], rows[order]


def check_device(dev, smi, tmp):
    """Phase 13, the device-index engine at full width (the DLRM of
    :func:`device_entry` on SyntheticCriteo(4096, seed=7)): DEVICE_STEPS
    steps in lockstep with a CPU trainer, 3 timed runs of 10 staged steps,
    an eval step, a torch.profiler breakdown and the host syncs of 3 steps
    (none from the hash table); K1, K2, K2's backward, K3a, K4 and K5
    launched. Then growth from 2^16 rows, a full and an
    incremental save served by card and CPU Predictors, --micro_batch 4
    and a TieredTrainer (HBM_DRAM, hbm_capacity below the live rows) in
    lockstep. Returns the main run's launches and the phase's summary."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.train import metrics
    counters = path_counters(index=True, dlrm=True)
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
        DEVICE_STEPS + 33))
    held = list(SyntheticCriteo(batch_size=B, seed=11).take(2))
    out, t_phase = {}, time.perf_counter()

    # the main run: lockstep, timing, one eval step, profile
    tg, tc = device_trainer(dev), device_trainer("cpu")
    for fn in counters.values():
        fn.launches = 0
    sg, sc, dloss, drow = device_lockstep(tg, tc, batches[:DEVICE_STEPS],
                                          "device-index")
    k = DEVICE_STEPS
    sg, staged = timed_runs(tg, sg, batches[k:k + 30])
    # eval: the read-only lookup (K4), as a held-out evaluation runs it
    ev = metrics.summarize(tg.eval_step(sg, metrics.create(device=dev),
                                        held[0]))
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"device-index main path ({sg.step} steps) launches: {launches}")
    for n, v in launches.items():
        if v <= 0:
            fail(f"{n} was not launched on the device-index path")
    med = statistics.median(staged)
    # the step's kernels and copies: 425 before the in-place insert
    sg, dev_ms = profile_steps(tg, sg, batches[k + 30:k + 33], B / med * 1e3,
                               what="device-index", max_launches=425)
    items = [tg.prepare_batch(b) for b in batches[k + 30:k + 33]]
    torch.cuda.synchronize()
    box = {"s": sg}

    def three():
        for it in items:
            box["s"] = tg._train_step(box["s"], *it)
    syncs = count_syncs(three)
    sg = box["s"]
    per_step = sum(syncs.values()) / len(items)
    log(f"device-index host syncs: {per_step:.1f} per step over "
        f"{len(items)} staged steps, by line: {dict(syncs.most_common(8))}")
    no_hash_syncs(syncs, "device-index step")
    summ = metrics.summarize(sg.metrics)
    if not (summ["examples"] == sg.step * B and np.isfinite(summ["loss"])
            and 0.0 <= summ["auc"] <= 1.0):
        fail(f"device-index metrics are off: {summ}")
    log(f"device-index examples/s at B={B}, staged host half: median "
        f"{med:.1f}, min {min(staged):.1f}, max {max(staged):.1f} over 3 "
        f"runs of 10 steps, on {smi}")
    health = tg.table_health(sg)["emb"]
    log(f"device-index after {sg.step} steps: {summ}; health {health}; "
        f"an eval step on a held batch: {ev}")
    if not 0.0 < ev["auc"] < 1.0:
        fail(f"device-index eval step: {ev}")
    out["main"] = {"staged_eps": staged, "device_ms_per_step": dev_ms,
                   "host_syncs_per_step": per_step,
                   "host_syncs_by_line": dict(syncs), "max_dloss": dloss,
                   "max_drow": drow, "summary": summ, "health": health,
                   "eval": ev}

    # serving: the card trainer's full save (save-time eviction of rows
    # untouched for 20 steps), two more steps, an incremental save; card
    # and CPU Predictors over the directory, before and after refresh()
    path = os.path.join(tmp, "device_ck")
    mgr = CheckpointManager(path)
    mgr.save(tg, sg)
    full_step = sg.step
    gpu, cpu, worst_full = _serve_pair(path, tg.collections["emb"], held,
                                       dev, "device-index full save")
    for b in batches[:2]:
        sg = tg.train_step(sg, b)
    mgr.save_incremental(tg, sg)
    if not (gpu.refresh() and cpu.refresh()):
        fail("device-index: the predictors did not refresh onto the "
             "incremental save")
    worst_incr = _compare_predictors(gpu, cpu, held,
                                     "device-index incremental save")
    log(f"device-index serving: the card's full save (step {full_step}) "
        f"and incremental save (step {sg.step}) served by card and CPU "
        f"Predictors: max |dp| {worst_full:.3g} and {worst_incr:.3g} (limit "
        f"{PROB_ATOL})")
    out["serve_dp"] = [worst_full, worst_incr]
    del tg, tc, sg, sc, gpu, cpu
    torch.cuda.empty_cache()

    # growth from 2^16 rows, maybe_grow after every step on both
    tg = device_trainer(dev, ["--capacity", str(DEVICE_GROW_CAPACITY)])
    tc = device_trainer("cpu", ["--capacity", str(DEVICE_GROW_CAPACITY)])
    caps = []

    def grow(i, sg, sc):
        sg, sc = tg.maybe_grow(sg), tc.maybe_grow(sc)
        caps.append((sg.tables["emb"].ev.capacity,
                     sc.tables["emb"].ev.capacity))
        if caps[-1][0] != caps[-1][1]:
            fail(f"device-index growth: card {caps[-1][0]} vs CPU "
                 f"{caps[-1][1]} rows after step {i}")
        device_same_tables(tg, sg, tc, sc, "device-index growth",
                           compare_rows=False)
        return sg, sc
    sg, sc, gloss, grow_drow = device_lockstep(
        tg, tc, batches[:DEVICE_GROW_STEPS], "device-index growth from "
        f"{DEVICE_GROW_CAPACITY} rows", fence=grow)
    if caps[-1][0] <= DEVICE_GROW_CAPACITY:
        fail(f"device-index growth: no growth from {DEVICE_GROW_CAPACITY} "
             f"rows ({caps})")
    log(f"device-index growth: capacities after each step {caps}; key sets "
        f"bit-equal at every fence")
    out["growth"] = {"capacities": caps, "max_dloss": gloss,
                     "max_drow": grow_drow}
    del tg, tc, sg, sc

    # --micro_batch 4
    tg = device_trainer(dev, ["--micro_batch", "4"])
    tc = device_trainer("cpu", ["--micro_batch", "4"])
    _, _, mloss, mrow = device_lockstep(tg, tc, batches[:DEVICE_MB_STEPS],
                                        "device-index --micro_batch 4")
    out["micro_batch"] = {"max_dloss": mloss, "max_drow": mrow}
    del tg, tc
    torch.cuda.empty_cache()

    # a TieredTrainer: HBM_DRAM with hbm_capacity below the live rows,
    # demotion at a fence every DEVICE_TIER_FENCE steps, promotion before
    # each step; the tiers bit-equal (integers) and within ROW_ATOL
    flags = ["--capacity", str(DEVICE_TIER_CAPACITY), "--ev_storage",
             "hbm_dram", "--ev_hbm_capacity", str(DEVICE_TIER_HBM)]
    tg, tc = device_trainer(dev, flags), device_trainer("cpu", flags)
    if type(tg).__name__ != "TieredTrainer":
        fail("--ev_storage hbm_dram did not give a TieredTrainer")
    moves = {"demoted": 0, "promoted": 0}
    last = {"rows": 0}
    width = 2 * EMB_DIM

    def tier_fence(i, sg, sc):
        moves["promoted"] += max(0, last["rows"] - tg.host_tier_rows("emb"))
        if i % DEVICE_TIER_FENCE != DEVICE_TIER_FENCE - 1:
            last["rows"] = tg.host_tier_rows("emb")
            return sg, sc
        before = tg.host_tier_rows("emb")
        sg, sc = tg.maybe_demote(sg), tc.maybe_demote(sc)
        moves["demoted"] += tg.host_tier_rows("emb") - before
        (kg, rg), (kc, rc) = device_tiers(tg), device_tiers(tc)
        if not np.array_equal(kg, kc) or (rg is None) != (rc is None):
            fail(f"device-index tier: card and CPU tier keys differ after "
                 f"step {i}")
        if rg is not None:
            ig = rg[:, width:width + 3].copy().view(np.int32)
            ic = rc[:, width:width + 3].copy().view(np.int32)
            d = float(np.abs(rg[:, :width] - rc[:, :width]).max())
            if not (np.array_equal(ig, ic) and d <= ROW_ATOL):
                fail(f"device-index tier: payloads differ after step {i} "
                     f"(rows by {d})")
        live = int(sg.tables["emb"].ev.index.size)
        if live > DEVICE_TIER_HBM:
            fail(f"device-index tier: {live} rows stayed on the card, over "
                 f"the budget of {DEVICE_TIER_HBM}")
        last["rows"] = tg.host_tier_rows("emb")
        return sg, sc
    sg, sc, tloss, trow = device_lockstep(
        tg, tc, batches[:DEVICE_TIER_STEPS], "device-index TieredTrainer",
        fence=tier_fence)
    if not (moves["demoted"] > 0 and moves["promoted"] > 0):
        fail(f"device-index tier: rows demoted {moves['demoted']}, promoted "
             f"{moves['promoted']}: both must move")
    log(f"device-index TieredTrainer (HBM_DRAM, hbm_capacity "
        f"{DEVICE_TIER_HBM}, {DEVICE_TIER_CAPACITY} slots): {moves} rows, "
        f"{tg.host_tier_rows('emb')} in the tier at the end, card and CPU "
        f"tiers equal at every fence; phase {time.perf_counter() - t_phase:.1f}"
        f" s")
    out["tier"] = {"moves": moves, "max_dloss": tloss, "max_drow": trow}
    return launches, out


# -- phase 14: the variant collections ---------------------------------------
VARIANT_KINDS = ("multihash", "adaptive", "dyndim", "hashtable")


def variant_collection(kind, combiner="add"):
    """The phase's table of ``kind`` over the 26 Criteo columns at emb dim
    16: multi-hash at the JAX default sizes (2^16, 2^12), adaptive (2^14
    buckets, CounterFilter(2)), dynamic dimension (2 blocks of 8, the second
    from 20 lookups), hash table (CBF(2) admission); 2^20 rows where a
    table has an index."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch import feature_column_variants as fv
    from deeprec_tpu_torch.data.criteo import CAT_NAMES
    from deeprec_tpu_torch.sparse.dynamicdim import DynamicDimConfig
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
            for n in CAT_NAMES]
    init = cfg.Initializer("normal", scale=0.05)
    if kind == "multihash":
        return fv.MultiHashCollection(cols, name="emb",
                                      table_sizes=(1 << 16, 1 << 12),
                                      combiner_op=combiner)
    if kind == "adaptive":
        return fv.AdaptiveCollection(cols, name="emb", buckets=1 << 14,
                                     counter_filter=cfg.CounterFilter(2),
                                     capacity=VARIANT_CAPACITY,
                                     initializer=init)
    if kind == "dyndim":
        return fv.DynamicDimCollection(
            cols, name="emb", dynamic_dim=DynamicDimConfig(2, 8, (0, 20)),
            capacity=VARIANT_CAPACITY, initializer=init)
    return fv.HashTableCollection(
        cols, name="emb", capacity=VARIANT_CAPACITY, initializer=init,
        admit=cfg.CBFFilter(filter_freq=2, max_element_size=1 << 20))


def variant_trainer(kind, dev, combiner="add"):
    """bench.py's DLRM (seeded weights) over a variant table, sparse
    Adagrad(0.5, initial accumulator 0.01) and dense Adagrad(0.05). (Dense
    Adam, as the JAX package's small variant tests use, is not held here:
    its first step moves every parameter by its rate times the sign of the
    gradient, and gradients at rounding level take other signs on the card
    and the CPU.)"""
    from deeprec_tpu_torch.optim.dense import Adagrad
    from deeprec_tpu_torch.optim.sparse import sparse_adagrad
    from deeprec_tpu_torch.train.trainer import Trainer
    numeric, _, _ = criteo_parts()
    model = seeded_model(torch.Generator().manual_seed(SEED))
    return Trainer(model, numeric, {"emb": variant_collection(kind,
                                                              combiner)},
                   {"emb": sparse_adagrad(0.5,
                                          initial_accumulator_value=0.01)},
                   Adagrad(0.05), device=dev)


def state_same(tg, sg, tc, sc, what, floats=True):
    """Every integer leaf of the tables' states and slot states bit-equal
    between the card and the CPU (index keys, id planes, counters, freqs,
    versions, CBF); with ``floats``, every float leaf and the dense
    parameters within ROW_ATOL. Returns the largest float difference."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    worst = 0.0
    for name in tc.collections:
        bg, bc = sg.tables[name], sc.tables[name]
        for (p, a), (_, c) in zip(leaves_with_paths((bg.ev, bg.slot)),
                                  leaves_with_paths((bc.ev, bc.slot))):
            if not c.dtype.is_floating_point:
                if not torch.equal(a.cpu(), c):
                    fail(f"{what}: {name}{p} differ between card and CPU")
            elif floats:
                d = (a.cpu().float() - c.float()).abs().max().item()
                worst = max(worst, d)
                if not d <= ROW_ATOL:
                    fail(f"{what}: {name}{p} differ by {d} between card "
                         "and CPU")
    if floats:
        for (n, a), b in zip(tg.model.named_parameters(),
                             tc.model.parameters()):
            d = (a.detach().cpu() - b.detach()).abs().max().item()
            worst = max(worst, d)
            if not d <= ROW_ATOL:
                fail(f"{what}: parameter {n} differs by {d} between card "
                     "and CPU")
    return worst


def float_leaves(tr, st):
    """The float state a step updates: table and slot leaves, parameters,
    the dense optimizer's state."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    leaves = [x for b in st.tables.values()
              for _, x in leaves_with_paths((b.ev, b.slot))]
    leaves += list(tr.model.parameters())
    leaves += [x for _, x in leaves_with_paths(st.opt_state)]
    return [x for x in leaves if x.dtype.is_floating_point]


def state_lockstep(tg, tc, batches, what, sg=None, sc=None):
    """Train the card and CPU trainers on ``batches`` through
    ``train_step``, the CPU trainer starting each step from the card's
    float state (rows, slot leaves, parameters, dense optimizer state): a
    table trained by sparse Adagrad at rate 0.5 over an initial
    accumulator of 0.01 multiplies the rounding of a gradient by up to
    0.5 / sqrt(0.01) = 5 a step, so states running free part step by step.
    After every step: the loss within LOSS_ATOL, the integer state (never
    copied) bit-equal, the float state within ROW_ATOL
    (:func:`state_same`). Returns the states, the largest loss and row
    differences."""
    sg = tg.init(batches[0]) if sg is None else sg
    sc = tc.init(batches[0]) if sc is None else sc
    worst = drow = 0.0
    for i, b in enumerate(batches):
        with torch.no_grad():
            for a, c in zip(float_leaves(tg, sg), float_leaves(tc, sc)):
                c.copy_(a)
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg, sc = tg.train_step(sg, b), tc.train_step(sc, b)
        lg = (sg.metrics.loss_sum.item() - g0) / B
        lc = (sc.metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg) and abs(lg - lc) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg} on the card vs {lc} on CPU")
        worst = max(worst, abs(lg - lc))
        drow = max(drow, state_same(tg, sg, tc, sc, f"{what} step {i}"))
    log(f"{what}: {len(batches)} steps in lockstep with a CPU trainer that "
        f"starts each step from the card's float state: integer state "
        f"bit-equal every step, max |dloss| {worst:.3g} (limit "
        f"{LOSS_ATOL}), max |drow|, |dslot| and |dparam| after a step "
        f"{drow:.3g} (limit {ROW_ATOL})")
    return sg, sc, worst, drow


def saved_arrays(coll, bundle, step):
    """A table's checkpoint arrays as numpy, rows ordered by key."""
    arrays = coll.ckpt_arrays(bundle, 1, None, False, step)
    if "keys" not in arrays:
        return arrays
    n, order = arrays["keys"].shape[0], np.argsort(arrays["keys"])
    return {k: (np.asarray(v)[order] if np.ndim(v) and len(v) == n
                and not k.startswith(("cbf", "static__")) else np.asarray(v))
            for k, v in arrays.items()}


def check_variant_kernels(dev):
    """K1, K2, K2's backward and K3a at the variant tables' shapes, from one
    B=4096 batch: the multi-hash sub-table fetch ([26*4096] int64 rows of
    the 2^16-row table 0) and pooling (K2 both ways over arange(26*4096):
    one row per flat id) and, for the tables with an index, the flat dedup
    (``unique`` without a cap, so U = 26*4096 lanes): K2 both ways over its
    int64 inverse, K1 at its slots from a 2^20-row table, K3a
    (lookup_meta, CounterFilter(2)) at its lanes, K5 inserting them into a
    fresh 2^20-slot index. Returns the entries (path ``variants``)."""
    import torch.nn.functional as Fn
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.unique import unique
    from deeprec_tpu_torch.sparse import hashtable as ht
    from deeprec_tpu_torch.sparse import multihash as mh
    g = torch.Generator().manual_seed(SEED + 5)
    coll = variant_collection("multihash")
    ids = torch.from_numpy(coll.pack_ids_np(
        next(SyntheticCriteo(batch_size=B, seed=7)))).to(dev).reshape(-1)
    sub0 = mh.sub_indices(coll.mh_config, ids)[0]
    t0 = torch.randn(coll.mh_config.table_sizes[0] + 1, EMB_DIM,
                     generator=g).to(dev)
    entries = [k1_case("(multi-hash sub-table 0 of 65,537 rows, int64)", t0,
                       sub0, "multihash")]
    # multi-hash pooling: its rows are per flat id, so K2 reads them
    # through arange(n) (every row once) and its backward adds one
    # gradient row to each
    n = ids.shape[0]
    mslots = torch.arange(n, device=dev).view(-1, 1)
    mvalid = (ids != -1).view(-1, 1)
    murows = torch.randn(n, EMB_DIM, generator=g).to(dev)
    md = torch.randn(n, EMB_DIM, generator=g).to(dev)
    entries += k2_pair(
        f"(multi-hash, [26*{B}, 1] sum over arange({n}))", murows, mslots,
        mvalid, "sum", md,
        lambda: Fn.embedding_bag(mslots, murows,
                                 per_sample_weights=mvalid.float(),
                                 mode="sum"),
        "multihash")
    cap = VARIANT_CAPACITY
    uniq = unique(ids)
    _, uslots, created = ht.lookup_or_insert(ht.create(cap, dev), uniq.ukeys)
    entries.append(hash_case("insert", "(variants' flat dedup, first step)",
                             ht.create(cap, dev), uniq.ukeys, "variants"))
    u, n_real = uslots.shape[0], int(uniq.n_unique)
    log(f"variant flat-dedup shape: {ids.shape[0]} ids, {n_real} unique keys "
        f"in {u} lanes, int64 inverse and slots")
    slots = uniq.inverse.view(-1, 1)
    valid = (uslots != cap)[uniq.inverse].view(-1, 1)
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    entries += k2_pair(
        f"(variants, [26*{B}, 1] sum over a flat dedup of {u} lanes)",
        urows, slots, valid, "sum", d_pooled,
        lambda: Fn.embedding_bag(slots, urows,
                                 per_sample_weights=valid.float(),
                                 mode="sum"),
        "variants")
    table = torch.randn(cap + 1, EMB_DIM, generator=g).to(dev)
    entries.append(k1_case(f"(variant row fetch, {u} int64 lanes of a 2^20 "
                           "table)", table, uslots, "variants"))
    # the adaptive and dynamic-dimension tables' metadata step: no
    # eviction, so no create steps or versions; freqs and the admission
    # test
    entries.append(k3a_case(
        f"(variant shape, the freq plane of {cap + 1})", "_variants", uslots,
        uniq.counts.to(torch.int32),
        torch.zeros((1,), dtype=torch.bool, device=dev),
        torch.where(created, uslots, cap + 1), cap, 2, planes=("freq",)))
    for e in entries:
        e["path"] = "variants"
    return entries


def check_variants(dev, smi, tmp):
    """Phase 14, the variant collections at full width (bench.py's DLRM,
    B 4096, 26 Criteo columns at emb dim 16, sparse Adagrad(0.5, initial
    accumulator 0.01), dense Adagrad(0.05), SyntheticCriteo(4096, seed=7)):
    multi-hash (add; then mult and concat), adaptive, dynamic dimension and
    hash table, each VARIANT_STEPS steps in lockstep with a CPU trainer, 3
    timed runs of 10 staged steps, the host syncs of one more step, a card
    save restored by a CPU trainer
    (tables equal) and one eval step on both (AUC and loss within
    EVAL_ATOL). K1, K2 and
    K2's backward launch on every run, K3a on adaptive and dynamic
    dimension. Returns the launches summed over the runs and the phase's
    numbers."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.train import metrics
    counters = path_counters(index=True)
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
        VARIANT_STEPS + 31))
    held = next(SyntheticCriteo(batch_size=B, seed=11))
    total = {n: 0 for n in counters}
    out, t_phase = {}, time.perf_counter()
    runs = [(k, "add", VARIANT_STEPS, True) for k in VARIANT_KINDS]
    runs += [("multihash", c, VARIANT_MODE_STEPS, False)
             for c in ("mult", "concat")]
    for kind, combiner, steps, full in runs:
        what = f"variants {kind}" + (f" {combiner}" if kind == "multihash"
                                     else "")
        tg = variant_trainer(kind, dev, combiner)
        tc = variant_trainer(kind, "cpu", combiner)
        for fn in counters.values():
            fn.launches = 0
        sg, sc, dloss, drow = state_lockstep(tg, tc, batches[:steps], what)
        res = {"max_dloss": dloss, "max_drow": drow}
        if full:
            sg, staged = timed_runs(tg, sg, batches[steps:steps + 30])
            res["staged_eps"] = staged
            log(f"{what} examples/s at B={B}, staged host half: median "
                f"{statistics.median(staged):.1f}, min {min(staged):.1f}, "
                f"max {max(staged):.1f} over 3 runs of 10 steps, on {smi}")
            # the host syncs of one staged step: neither the metrics, nor
            # the dynamic-dimension mask, nor the hash table may sync
            item = tg.prepare_batch(batches[steps + 30])
            torch.cuda.synchronize()
            box = {"s": sg}

            def one():
                box["s"] = tg._train_step(box["s"], *item)
            syncs = count_syncs(one)
            sg = box["s"]
            res["host_syncs_by_line"] = dict(syncs)
            log(f"{what} host syncs in one staged step: "
                f"{sum(syncs.values())}, by line: {dict(syncs)}")
            for line in syncs:
                if any(m in line for m in (
                        "deeprec_tpu_torch/train/metrics.py",
                        "deeprec_tpu_torch/sparse/dynamicdim")):
                    fail(f"{what}: {line} syncs with the host")
            no_hash_syncs(syncs, what)
        if full:
            # a card save restored by a fresh CPU trainer: the same tables;
            # one eval step on both
            path = os.path.join(tmp, f"variant_{kind}")
            CheckpointManager(path).save(tg, sg)
            tr2 = variant_trainer(kind, "cpu")
            sr, ok = CheckpointManager(path).restore(tr2, tr2.init(held))
            if not ok or sr.step != sg.step:
                fail(f"{what}: the card's save did not restore on the CPU")
            a = saved_arrays(tg.collections["emb"], sg.tables["emb"],
                             sg.step)
            c = saved_arrays(tr2.collections["emb"], sr.tables["emb"],
                             sr.step)
            if sorted(a) != sorted(c) or not all(
                    np.array_equal(np.asarray(a[k]), np.asarray(c[k]))
                    for k in a):
                fail(f"{what}: the CPU restore of the card's save holds "
                     "other tables")
            mg = metrics.summarize(tg.eval_step(
                sg, metrics.create(device=dev), held))
            mc = metrics.summarize(tr2.eval_step(
                sr, metrics.create(device="cpu"), held))
            if not (abs(mg["auc"] - mc["auc"]) <= EVAL_ATOL
                    and abs(mg["loss"] - mc["loss"]) <= EVAL_ATOL
                    and 0.0 < mg["auc"] < 1.0):
                fail(f"{what}: eval AUC {mg['auc']} and loss {mg['loss']} "
                     f"on the card vs {mc['auc']} and {mc['loss']} on a "
                     "CPU restore of its save")
            res["eval"] = {"card": mg, "cpu_restore": mc}
            res["health"] = tg.table_health(sg).get("emb")
            log(f"{what}: a card save restored by a CPU trainer (tables "
                f"equal: {sorted(a)[:6]}...), eval AUC {mg['auc']!r} and "
                f"loss {mg['loss']!r} on the card, {mc['auc']!r} and "
                f"{mc['loss']!r} on the CPU (limit {EVAL_ATOL}); health "
                f"{res['health']}")
        # the run's launches: its steps, and its save and eval step
        launches = {n: fn.launches for n, fn in counters.items()}
        need = ["gather_rows", "fused_pooled_lookup",
                "fused_pooled_lookup_backward"]
        if kind in ("adaptive", "dyndim"):
            need.append("lookup_meta")
        if kind != "multihash":  # the tables with an index
            need += ["hash_lookup_or_insert", "hash_lookup"]
        for n in need:
            if launches[n] <= 0:
                fail(f"{n} was not launched on the {what} path")
        for n, v in launches.items():
            total[n] += v
        res["launches"] = launches
        log(f"{what} launches ({sg.step} steps): {launches}")
        out[what] = res
        del tg, tc, sg, sc
        torch.cuda.empty_cache()
    log(f"variants: launches over the phase {total}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, out


def migrate_trainer(dev):
    """bench.py's DLRM (seeded weights) on a device-index table of 2^21
    rows (CounterFilter(2), so kernel K3a on the path), sparse
    Adagrad(0.05, initial accumulator 0.1), whose ``acc`` slot the bundle's
    Adagrad EV fills, and dense Adagrad(0.05)."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.criteo import CAT_NAMES
    from deeprec_tpu_torch.optim.dense import Adagrad
    from deeprec_tpu_torch.optim.sparse import sparse_adagrad
    from deeprec_tpu_torch.train.trainer import Trainer
    numeric, _, _ = criteo_parts()
    coll = fc.EmbeddingCollection(
        [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
         for n in CAT_NAMES], name="emb", capacity=CAPACITY,
        initializer=cfg.Initializer("normal", scale=0.05),
        counter_filter=cfg.CounterFilter(2))
    return Trainer(seeded_model(torch.Generator().manual_seed(SEED)),
                   numeric, {"emb": coll},
                   {"emb": sparse_adagrad(0.05,
                                          initial_accumulator_value=0.1)},
                   Adagrad(0.05), device=dev)


def check_migrate(dev, smi, tmp):
    """Phase 15, DeepRec checkpoint migration: the committed DeepRec-shaped
    bundle (tests/torch_fixtures/deeprec_bundle: 26 per-column EV quads of
    128 keys at dim 16, C1 partitioned and with an Adagrad slot EV missing
    keys, the DLRM's bottom MLP, global_step, a string) through ``scan``,
    ``import_tables`` into a card and a CPU device-index trainer and
    ``import_dense`` onto the DLRM: the imported keys, values, versions,
    freqs and slot rows bit-equal card and CPU and equal to the arrays the
    fixture's script draws; the offline CLI (``python -m
    deeprec_tpu_torch.checkpoint.migrate``) writes what ``_main`` writes;
    then MIGRATE_STEPS steps in lockstep over batches that reuse the
    imported keys, and 3 timed runs of 10 staged steps. K1, K2, K2's
    backward and K3a launch."""
    from deeprec_tpu_torch.checkpoint import migrate
    from deeprec_tpu_torch.checkpoint.saver import table_snapshot_host
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    mb = tests_module("make_bundle", "torch_fixtures")
    t_phase = time.perf_counter()
    prefix = mb.PREFIX
    fx = mb.fixture_arrays()
    cat = migrate.scan(migrate.BundleReader(prefix))
    if not (len(cat.evs) == mb.N_COLUMNS and cat.skipped == ["ckpt/path"]
            and sorted(cat.evs[mb.ev_name(1)].slots) == ["Adagrad"]
            and len(cat.evs[mb.ev_name(1)].parts) == 2):
        fail(f"migrate: scan catalogued {len(cat.evs)} EVs, skipped "
             f"{cat.skipped}")
    name_map = {"emb": {f"C{c}": mb.ev_name(c)
                        for c in range(1, mb.N_COLUMNS + 1)}}
    pairs = []  # (trainer, state, report): the card's, then the CPU's
    for d in (dev, "cpu"):
        tr = migrate_trainer(d)
        st = tr.init(next(SyntheticCriteo(batch_size=B, seed=7)))
        st, rep = migrate.import_tables(tr, st, prefix, name_map,
                                        validate=True)
        _, missing = migrate.import_dense(tr.model, prefix,
                                          dict(mb.bottom_names()))
        if missing:
            fail(f"migrate: import_dense missed {missing}")
        pairs.append((tr, st, rep))
    (tg, sg, rep), (tc, sc, rep_cpu) = pairs
    if rep != rep_cpu or rep["imported"]["emb"]["rows"] != \
            mb.N_COLUMNS * mb.N_KEYS or rep["slots"]["emb"] != \
            ["Adagrad->acc"] or rep["unmatched_evs"]:
        fail(f"migrate: import reports {rep} (card) vs {rep_cpu}")
    coll = tc.collections["emb"]
    snaps = [table_snapshot_host(coll.config, s.tables["emb"].ev,
                                 s.tables["emb"].slot, evict=False)
             for s in (sg, sc)]
    for k in snaps[1]:
        if not np.array_equal(np.asarray(snaps[0][k]),
                              np.asarray(snaps[1][k])):
            fail(f"migrate: imported {k} differ between card and CPU")
    # every imported row holds the fixture's arrays (keys in the table's
    # salted space; the acc slot from C1's Adagrad EV, else its fill)
    snap = snaps[1]
    row_of = {int(k): i for i, k in enumerate(snap["keys"])}
    slot_by_key = dict(zip(fx["slot"]["keys"].tolist(),
                           fx["slot"]["values"]))
    for c, ev in fx["evs"].items():
        keys = coll.transform_raw_keys(f"C{c}", ev["keys"])
        idx = np.array([row_of[int(k)] for k in keys])
        acc = np.stack([slot_by_key.get(int(r), np.full(EMB_DIM, 0.1,
                                                        np.float32))
                        if c == 1 else np.full(EMB_DIM, 0.1, np.float32)
                        for r in ev["keys"]])
        if not (np.array_equal(snap["values"][idx], ev["values"])
                and np.array_equal(snap["versions"][idx], ev["versions"])
                and np.array_equal(snap["freqs"][idx], ev["freqs"])
                and np.array_equal(snap["create_steps"][idx],
                                   ev["versions"])
                and np.array_equal(snap["slot__['acc']"][idx], acc)):
            fail(f"migrate: column C{c}'s imported rows are not the "
                 "fixture's")
    w = {n: p.detach().cpu() for n, p in tg.model.bottom.named_parameters()}
    want = fx["dense"]["dlrm/bottom_mlp/dense_0/kernel"]
    if not (np.array_equal(w["hidden.0.weight"].numpy().T, want)
            and all(torch.equal(w[n], p.detach()) for n, p in
                    tc.model.bottom.named_parameters())):
        fail("migrate: the bottom MLP is not the bundle's")
    # the offline CLI, in a process of its own, writes what _main writes
    outs = [os.path.join(tmp, "migrated_cli"), os.path.join(tmp, "migrated")]
    subprocess.run([sys.executable, "-m",
                    "deeprec_tpu_torch.checkpoint.migrate", "--prefix",
                    prefix, "--out", outs[0], "--validate"], check=True,
                   cwd=REPO, capture_output=True, timeout=300)
    with contextlib.redirect_stdout(io.StringIO()):
        migrate._main(["--prefix", prefix, "--out", outs[1]])
    files = sorted(os.listdir(outs[1]))
    if sorted(os.listdir(outs[0])) != files or len(files) != \
            mb.N_COLUMNS + 2:
        fail(f"migrate: the offline CLI wrote {files}")
    for f in files:
        a, b = (os.path.join(o, f) for o in outs)
        if f.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                same = json.load(fa) == json.load(fb)
        else:
            with np.load(a) as za, np.load(b) as zb:
                same = sorted(za.files) == sorted(zb.files) and all(
                    np.array_equal(za[k], zb[k]) for k in za.files)
        if not same:
            fail(f"migrate: the offline CLI's {f} differs from _main's")

    # training from the imported state: half of each column's ids are
    # imported keys
    rng = np.random.default_rng(SEED)
    batches = []
    for b in SyntheticCriteo(batch_size=B, seed=7).take(MIGRATE_STEPS + 30):
        b = dict(b)
        for c, ev in fx["evs"].items():
            col = np.array(b[f"C{c}"], np.int64)
            pick = rng.random(B) < 0.5
            col[pick] = rng.choice(ev["keys"], int(pick.sum()))
            b[f"C{c}"] = col
        batches.append(b)
    counters = path_counters()
    for fn in counters.values():
        fn.launches = 0
    sg, sc, dloss, drow = state_lockstep(tg, tc, batches[:MIGRATE_STEPS],
                                         "migrate", sg, sc)
    sg, staged = timed_runs(tg, sg, batches[MIGRATE_STEPS:])
    launches = {n: fn.launches for n, fn in counters.items()}
    for n, v in launches.items():
        if v <= 0:
            fail(f"{n} was not launched on the migrate path")
    log(f"migrate: {rep['imported']['emb']['rows']} rows of "
        f"{len(rep['imported']['emb']['evs'])} EVs imported, slots "
        f"{rep['slots']['emb']}, card = CPU = fixture; launches {launches}; "
        f"examples/s at B={B}, staged: median "
        f"{statistics.median(staged):.1f}, min {min(staged):.1f}, max "
        f"{max(staged):.1f} over 3 runs of 10 steps, on {smi}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, {"report": rep, "max_dloss": dloss, "max_drow": drow,
                      "staged_eps": staged}


# -- phases 16 and 17: the mesh engine ----------------------------------------
def mesh_trainer(dev, axis, extra=()):
    """The device phase's DLRM (:func:`device_entry`) as ``--mesh S``
    makes it: ``cli.make_trainer`` over ``axis`` (``S`` its ranks), so a
    ``ShardedTrainer`` with this rank's shard of the 2^21-row table."""
    from deeprec_tpu_torch.train import cli
    mod, args = device_entry(dev, ["--mesh", str(axis.size), *extra])
    tr = cli.make_trainer(mod.build(args), args, mesh=axis)
    if type(tr).__name__ != "ShardedTrainer":
        fail("--mesh did not give a ShardedTrainer")
    return tr


def anchor(tg, sg, tc, sc):
    """The CPU twin takes the card's float state (rows, slot leaves,
    parameters, buffers, the dense optimizer's state), so the next window
    of steps starts from one state."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    pairs = [(sc.tables[n].ev.values, sg.tables[n].ev.values)
             for n in tc.collections]
    for n in tc.collections:
        pairs += [(c, g) for (_, c), (_, g) in zip(
            leaves_with_paths(sc.tables[n].slot),
            leaves_with_paths(sg.tables[n].slot))]
    pairs += list(zip(tc.model.parameters(), tg.model.parameters()))
    pairs += list(zip(tc.model.buffers(), tg.model.buffers()))
    pairs += [(c, g) for (_, c), (_, g) in zip(
        leaves_with_paths(sc.opt_state), leaves_with_paths(sg.opt_state))]
    with torch.no_grad():
        for c, g in pairs:
            c.copy_(g)


def mesh_lockstep(tg, tc, batches, what):
    """Train the card's and the CPU twin's mesh trainers on ``batches``
    (global batches of B; each rank keeps its slice): every step's loss
    within LOSS_ATOL and this rank's key planes bit-equal; at every
    MESH_FENCE steps the metadata planes bit-equal and rows, slot leaves
    and parameters within ROW_ATOL (:func:`device_same_tables`), after
    which the twin takes the card's float state (:func:`anchor`; the card
    adds K2's backward atomics in another order, ROADMAP C3). Returns the
    states, the largest loss and row differences."""
    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    dloss = drow = 0.0
    for i, b in enumerate(batches):
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg, sc = tg.train_step(sg, b), tc.train_step(sc, b)
        lg = (sg.metrics.loss_sum.item() - g0) / B
        lc = (sc.metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg) and abs(lg - lc) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg} on the card vs {lc} on CPU")
        dloss = max(dloss, abs(lg - lc))
        if not torch.equal(sg.tables["emb"].ev.index.keys.cpu(),
                           sc.tables["emb"].ev.index.keys):
            fail(f"{what}: card and CPU key planes differ after step {i}")
        if (i + 1) % MESH_FENCE == 0 or i + 1 == len(batches):
            drow = max(drow, device_same_tables(tg, sg, tc, sc, what))
            anchor(tg, sg, tc, sc)
    return sg, sc, dloss, drow


class A2ATimer:
    """Wraps ``axis.all_to_all`` (an instance attribute shadows the
    method): each call's host time, and its time on the card's current
    stream between CUDA events (the collective's wait joins that
    stream)."""

    def __init__(self, axis):
        self.axis, self.host_s, self.events = axis, [], []

    def __enter__(self):
        orig = type(self.axis).all_to_all

        def timed(x):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            a.record()
            out = orig(self.axis, x)
            b.record()
            self.host_s.append(time.perf_counter() - t)
            self.events.append((a, b))
            return out
        self.axis.all_to_all = timed
        return self

    def __exit__(self, *exc):
        del self.axis.all_to_all
        torch.cuda.synchronize()

    def per_step_ms(self, steps):
        """(card ms, host ms) of the exchanges per step."""
        card = sum(a.elapsed_time(b) for a, b in self.events)
        return card / steps, sum(self.host_s) * 1e3 / steps


def timed_mesh_steps(tg, state, batches, axis, runs=3, steps=10):
    """examples/s (global B a step) of ``runs`` runs of ``steps`` staged
    steps (:func:`timed_runs`), then the all_to_all time of ``steps`` more
    steps (:class:`A2ATimer`). Returns the state, the rates, the a2a card
    ms and host ms per step and the number of exchanges a step."""
    state, rates = timed_runs(tg, state, batches[:runs * steps], runs, steps)
    items = [tg.prepare_batch(b) for b in
             batches[runs * steps:(runs + 1) * steps]]
    torch.cuda.synchronize()
    with A2ATimer(axis) as t:
        for it in items:
            state = tg._train_step(state, *it)
    card_ms, host_ms = t.per_step_ms(len(items))
    return state, rates, card_ms, host_ms, len(t.events) / len(items)


def key_rows(state):
    """``key -> row`` of table emb on this rank (numpy)."""
    ev = state.tables["emb"].ev
    keys = ev.index.keys.cpu().numpy()
    live = keys != -1
    return dict(zip(keys[live].tolist(),
                    ev.values[:-1][torch.from_numpy(live).to(
                        ev.values.device)].cpu().numpy()))


def check_mesh_kernels(dev):
    """K1 and K3a at the owner's shapes of the mesh4 phase (4 ranks, 1,024
    examples each, the device phase's DLRM): the exchange of one B=4096
    batch is built here as the ranks build it, for owner rank 0 — each
    requester's unique_cols dedup, its buckets of C lanes (slack 2), the
    S*C lanes owner 0 receives. K3a (lookup_meta, CounterFilter(2)) and
    K1's unique-row fetch at the owner's unique width, with the summed
    multiplicities (``freq_counts``) as counts; K1's read-only fetch at
    the S*C received lanes (the eval and serving exchange); K5 inserting
    the owner's unique lanes into a fresh index, and K4 looking the S*C
    received lanes up in it."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.segment import segment_sum
    from deeprec_tpu_torch.ops.unique import unique, unique_cols
    from deeprec_tpu_torch.parallel import sharded
    from deeprec_tpu_torch.sparse import hashtable as ht
    S = MESH4_RANKS
    g = torch.Generator().manual_seed(SEED + 5)
    coll = device_trainer("cpu").collections["emb"]
    cfg, cap = coll.config, coll.config.capacity
    ids = torch.from_numpy(coll.pack_ids_np(
        next(SyntheticCriteo(batch_size=B, seed=7)))).to(dev)
    b = B // S
    n_local = ids.shape[0] * b
    C = max(int(np.ceil(min(n_local, cfg.max_unique + 1) * 2.0 / S / 8.0)
                * 8), 8)  # ShardedTrainer._bucket_cap at slack 2
    recv, rcounts = [], []
    for r in range(S):
        uniq = unique_cols(ids[:, r * b:(r + 1) * b].contiguous(),
                           cfg.max_unique)
        _, _, _, dest = sharded._route(uniq, S, C)
        recv.append(sharded._send(uniq.ukeys, dest, S * C, -1)[:C])
        rcounts.append(sharded._send(uniq.counts.to(torch.int32), dest,
                                     S * C, 0)[:C])
    recv, rcounts = torch.cat(recv), torch.cat(rcounts)
    ru = unique(recv, cfg.max_unique)
    freq = segment_sum(rcounts, ru.inverse, ru.ukeys.shape[0])
    index, uslots, created = ht.lookup_or_insert(ht.create(cap, dev),
                                                 ru.ukeys, cfg.max_probes)
    rslots, _ = ht.lookup(index, recv, cfg.max_probes)
    hash_entries = [
        hash_case("insert", "(mesh4 owner, first step)", ht.create(cap, dev),
                  ru.ukeys, "mesh4_owner", cfg.max_probes),
        hash_case("lookup", "(mesh4 owner's read-only S*C received lanes)",
                  index, recv, "mesh4_readonly", cfg.max_probes)]
    log(f"mesh4 owner shape: {S} requesters x C {C} lanes = {S * C} "
        f"received ids, {int(ru.n_unique)} unique ({int(ru.n_overflow)} "
        f"past the cap) in {ru.ukeys.shape[0]} lanes, counts summed over "
        f"requesters up to {int(freq.max())}")
    table = torch.randn(cap + 1, 2 * EMB_DIM, generator=g).to(dev)
    entries = [
        k1_case("(mesh4 owner unique-row fetch, int64 slots)", table,
                uslots, "mesh4_owner", d=EMB_DIM),
        k1_case("(mesh4 owner read-only fetch of the S*C received lanes)",
                table, rslots, "mesh4_readonly", d=EMB_DIM),
        k3a_case(f"(mesh4 owner shape, freq_counts, planes of {cap + 1})",
                 "_mesh4_owner", uslots, freq,
                 torch.zeros((1,), dtype=torch.bool, device=dev),
                 torch.where(created, uslots, cap + 1), cap,
                 cfg.counter_filter.filter_freq)] + hash_entries
    for e in entries:
        e["path"] = "mesh4"
    return entries


def check_mesh1(dev, smi):
    """Phase 16: a world-1 NCCL ShardedTrainer on the card (the device
    phase's DLRM through ``cli.make_trainer`` with ``--mesh 1``), MESH_STEPS
    steps in lockstep with a CPU twin on a gloo group of the same process
    (:func:`mesh_lockstep`) and an eval step; K1, K2, K2's backward, K3a,
    K5 and K4 launched; after 5 more steps the same key -> row map as the
    one-device device-index Trainer (both with exact dedup); 3 timed runs
    of 10 staged steps, the NCCL all_to_all time a step and the host syncs
    of one staged step (none from the hash table). Returns the launches
    and the phase's summary."""
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    from deeprec_tpu_torch.train import metrics
    t_phase = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        nccl = make_mesh(1, device=dev)
        gloo = make_mesh(1, group=dist.new_group([0], backend="gloo"),
                         device="cpu")
        batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
            MESH_STEPS + 40))
        tg, tc = mesh_trainer(dev, nccl), mesh_trainer("cpu", gloo)
        counters = path_counters(index=True, dlrm=True)
        for fn in counters.values():
            fn.launches = 0
        sg, sc, dloss, drow = mesh_lockstep(tg, tc, batches[:MESH_STEPS],
                                            "mesh1")
        # an eval step: the owner's read-only lookup (K4)
        ev = metrics.summarize(tg.eval_step(sg, metrics.create(device=dev),
                                            batches[-1]))
        launches = {n: fn.launches for n, fn in counters.items()}
        log(f"mesh1 (NCCL, 1 rank) main path ({MESH_STEPS} steps and an "
            f"eval step: {ev}) launches: {launches}")
        for n, v in launches.items():
            if v <= 0:
                fail(f"{n} was not launched on the mesh1 path")
        del tc, sc
        # the one-device engine's key -> row map after the same 5 steps,
        # with exact dedup: under a binding max_unique the owner's dedup
        # of the S*C received lanes also holds the EMPTY group, so it
        # keeps one key fewer than one device (the JAX engine does too)
        exact = ["--max_unique_ratio", "0"]
        tm, t1 = mesh_trainer(dev, nccl, exact), device_trainer(dev, exact)
        sm, s1 = tm.init(batches[0]), t1.init(batches[0])
        dloss1 = 0.0
        for b in batches[:5]:
            m0, o0 = sm.metrics.loss_sum.item(), s1.metrics.loss_sum.item()
            sm, s1 = tm.train_step(sm, b), t1.train_step(s1, b)
            dloss1 = max(dloss1, abs(sm.metrics.loss_sum.item() - m0
                                     - s1.metrics.loss_sum.item() + o0) / B)
        mesh, one = key_rows(sm), key_rows(s1)
        if sorted(one) != sorted(mesh):
            fail("mesh1: the key set differs from the one-device trainer's")
        drow1 = max(float(np.abs(mesh[k] - one[k]).max()) for k in one)
        if not (drow1 <= ROW_ATOL and dloss1 <= LOSS_ATOL):
            fail(f"mesh1: rows differ from the one-device trainer's by "
                 f"{drow1}, losses by {dloss1}")
        del tm, sm, t1, s1
        torch.cuda.empty_cache()
        sg, rates, a2a_ms, a2a_host, n_a2a = timed_mesh_steps(
            tg, sg, batches[MESH_STEPS:], nccl)
        # the host syncs of one staged owner step
        item = tg.prepare_batch(batches[-2])
        torch.cuda.synchronize()
        box = {"s": sg}

        def owner_step():
            box["s"] = tg._train_step(box["s"], *item)
        syncs = count_syncs(owner_step)
        sg = box["s"]
        log(f"mesh1 host syncs in one staged step: {sum(syncs.values())}, "
            f"by line: {dict(syncs)}")
        no_hash_syncs(syncs, "mesh1 step")
        # the collective alone, back to back at the step's widths: the
        # ids of one step's buckets and its rows (the events above also
        # hold the host's launch gaps, the device idling between)
        C = tg._bucket_cap(tg.collections["emb"], 26 * B)
        alone = {}
        for what, buf in (("ids", torch.zeros((1, C), dtype=torch.int64,
                                              device=dev)),
                          ("rows", torch.zeros((1, C, EMB_DIM),
                                               device=dev))):
            nbytes = 2 * buf.numel() * buf.element_size()
            alone[what] = {"ms": time_ms(lambda: nccl.all_to_all(buf)),
                           "bytes": nbytes, "bound_ms": bound(nbytes)[0]}
        summ = _metrics_summary(sg)
        log(f"mesh1: {MESH_STEPS} steps in lockstep with a gloo CPU twin: "
            f"max |dloss| {dloss:.3g}, max |drow| {drow:.3g} at the fences "
            f"(each window of {MESH_FENCE} from the card's state); after 5 "
            f"exact-dedup steps {len(one)} keys as on one device, rows "
            f"within {drow1:.3g}, losses within {dloss1:.3g}; staged "
            f"examples/s at B={B}: median "
            f"{statistics.median(rates):.1f}, min {min(rates):.1f}, max "
            f"{max(rates):.1f} over 3 runs of 10 steps; NCCL all_to_all "
            f"{a2a_ms:.4f} ms a step between CUDA events in the step "
            f"({n_a2a:.0f} calls, host {a2a_host:.4f} ms); alone, back to "
            f"back at the step's {C}-lane buckets: " + ", ".join(
                f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                f"{v['bytes']} bytes in and out)" for k, v in alone.items())
            + f"; phase {time.perf_counter() - t_phase:.1f} s, on {smi}")
        return launches, {"staged_eps": rates, "a2a_ms_per_step": a2a_ms,
                          "host_syncs_by_line": dict(syncs), "eval": ev,
                          "a2a_host_ms_per_step": a2a_host,
                          "a2a_calls_per_step": n_a2a, "a2a_alone": alone,
                          "max_dloss": dloss,
                          "max_drow": drow, "one_device_drow": drow1,
                          "one_device_dloss": dloss1,
                          "summary": summ,
                          "health": tg.table_health(sg)["emb"]}
    finally:
        dist.destroy_process_group()


def _metrics_summary(state):
    from deeprec_tpu_torch.train import metrics
    summ = metrics.summarize(state.metrics)
    if not (summ["examples"] == state.step * B and np.isfinite(summ["loss"])
            and 0.0 <= summ["auc"] <= 1.0):
        fail(f"mesh metrics are off: {summ}")
    return summ


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh4_rank(job_path, rank):
    """One of phase 17's ranks (``python3 chip_smoke.py --mesh4-rank R
    JOB``): joins a gloo group of MESH4_RANKS processes, all on cuda:0
    (NCCL takes one rank a card), and a second gloo group for its CPU
    twin; trains MESH4_STEPS steps in lockstep (:func:`mesh_lockstep`),
    times staged steps and the gloo all_to_all, writes a full save of the
    4 shards, serves it with a 4-rank ShardedPredictor and, on ranks 0
    and 1, a 2-rank one (a reshard); pickles its numbers for the
    parent."""
    import pickle
    import torch.distributed as dist
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops import _build
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    from deeprec_tpu_torch.serving import ShardedPredictor
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.library()  # the parent built it
    # the host's cores shared out: the ranks' CPU twins and gloo run there
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // MESH4_RANKS))
    multihost.initialize(job["addr"], MESH4_RANKS, rank,
                         backend=job["backend"], timeout_s=MESH4_TIMEOUT_S)
    try:
        card = make_mesh(MESH4_RANKS, device=dev)
        twin = make_mesh(MESH4_RANKS, group=dist.new_group(backend="gloo"),
                         device="cpu")
        pair = dist.new_group([0, 1], backend=job["backend"])
        batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
            max(MESH4_STEPS, HSMESH4_STEPS) + 20))
        tg, tc = mesh_trainer(dev, card), mesh_trainer("cpu", twin)
        counters = path_counters(index=True, dlrm=True)
        for fn in counters.values():
            fn.launches = 0
        sg, sc, dloss, drow = mesh_lockstep(tg, tc, batches[:MESH4_STEPS],
                                            f"mesh4 rank {rank}")
        # K4's count is the 4-rank ShardedPredictor's (below)
        out = {"launches": {n: fn.launches for n, fn in counters.items()
                            if n != "hash_lookup"},
               "max_dloss": dloss, "max_drow": drow,
               "health": tg.table_health(sg)["emb"]}
        del tc, sc
        sg, out["staged_eps"], out["a2a_ms_per_step"], \
            out["a2a_host_ms_per_step"], out["a2a_calls_per_step"] = \
            timed_mesh_steps(tg, sg, batches[MESH4_STEPS:], card, runs=3,
                             steps=5)
        out["summary"] = _metrics_summary(sg)
        CheckpointManager(job["ckpt"]).save(tg, sg)
        del tg, sg
        torch.cuda.empty_cache()
        held = list(SyntheticCriteo(batch_size=B, seed=11).take(5))
        numeric, coll, model = criteo_parts()
        p4 = ShardedPredictor(model, numeric, {"emb": coll}, job["ckpt"],
                              mesh=card)
        counters["hash_lookup"].launches = 0
        out["probs4"] = [p4.predict(b) for b in held]
        out["launches"]["hash_lookup"] = counters["hash_lookup"].launches
        del p4
        if rank < 2:
            numeric, coll, model = criteo_parts()
            p2 = ShardedPredictor(model, numeric, {"emb": coll},
                                  job["ckpt"], mesh=make_mesh(
                                      2, group=pair, device=dev))
            out["probs2"] = [p2.predict(b) for b in held]
            del p2
        torch.cuda.empty_cache()
        # the host-sharded engine on the same ranks: each rank resolves its
        # slice, the buckets cross the host exchange, every rank against
        # its CPU twin (whose exchange is a second TCP mesh)
        hg, hc = hs_trainer(dev, card), hs_trainer("cpu", twin)
        counters = path_counters(dlrm=True)  # no hash index on the card
        for fn in counters.values():
            fn.launches = 0
        shg, shc, hloss, hrow = hs_lockstep(
            hg, hc, batches[:HSMESH4_STEPS],
            f"mesh4 host-sharded rank {rank}", fence=5)
        hs = {"launches": {n: fn.launches for n, fn in counters.items()},
              "max_dloss": hloss, "max_drow": hrow}
        del hc, shc
        with HXTimer(hg.collections["emb"]) as hx:
            shg, hs["staged_eps"] = timed_runs(
                hg, shg, batches[HSMESH4_STEPS:HSMESH4_STEPS + 15], runs=3,
                steps=5)
        hs["exchange_ms"] = hx.ms()
        hs["health"] = hg.table_health(shg)["emb"]
        hs["summary"] = _metrics_summary(shg)
        CheckpointManager(job["hs_ckpt"]).save(hg, shg)
        del hg, shg
        torch.cuda.empty_cache()
        if rank < 2:  # the host-sharded save at 2 ranks (a reshard)
            numeric, coll, model = criteo_parts()
            p2 = ShardedPredictor(model, numeric, {"emb": coll},
                                  job["hs_ckpt"], mesh=make_mesh(
                                      2, group=pair, device=dev))
            hs["probs2"] = [p2.predict(b) for b in held]
        out["hs"] = hs
        card.barrier()
        with open(f"{job_path}.out{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_mesh4(dev, smi, tmp):
    """Phase 17: MESH4_RANKS rank processes (:func:`mesh4_rank`), each in
    lockstep with its CPU twin: on one card over gloo (NCCL takes one
    rank a card), or over NCCL with rank r on card r where torch sees
    MESH4_RANKS cards; a child that fails or outlives MESH4_TIMEOUT_S
    fails the smoke. Their save is
    served by the one-device Predictor on the card, and the ranks'
    4-rank and 2-rank ShardedPredictors agree with it within PROB_ATOL on
    5 held batches. Then the host-sharded engine on the same ranks, its
    save served by the one-device Predictor and at 2 ranks. Returns the
    launches by path (``mesh4``, ``mesh4_hs``), summed over the ranks
    (each rank's must be above 0), and the phase's summary."""
    import pickle
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    t_phase = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= MESH4_RANKS else "gloo"
    job = os.path.join(tmp, "mesh4.pkl")
    ckpt = os.path.join(tmp, "mesh4_ck")
    with open(job, "wb") as f:
        pickle.dump({"addr": f"127.0.0.1:{free_port()}", "ckpt": ckpt,
                     "hs_ckpt": os.path.join(tmp, "mesh4_hs_ck"),
                     "backend": backend,  # NCCL takes one rank a card
                     "devices": [f"cuda:{r if backend == 'nccl' else 0}"
                                 if dev.type == "cuda" else "cpu"
                                 for r in range(MESH4_RANKS)]}, f)
    outs = spawn_ranks("--mesh4-rank", MESH4_RANKS, job, tmp,
                       MESH4_TIMEOUT_S, "mesh4")
    launches = {}
    for r, o in enumerate(outs):
        for n, v in o["launches"].items():
            if v <= 0:
                fail(f"{n} was not launched on mesh4 rank {r}'s path")
            launches[n] = launches.get(n, 0) + v
    cards = MESH4_RANKS if backend == "nccl" else 1
    log(f"mesh4 ({backend}, {MESH4_RANKS} ranks on {cards} card(s)) main path "
        f"({MESH4_STEPS} steps) launches summed over the ranks: {launches}")
    held = list(SyntheticCriteo(batch_size=B, seed=11).take(5))
    one = predictor(ckpt, dev)
    worst = {"4 ranks": 0.0, "2 ranks": 0.0}
    for i, b in enumerate(held):
        p1 = one.predict(b)
        for what, key in (("4 ranks", "probs4"), ("2 ranks", "probs2")):
            p = outs[0][key][i]
            if p.shape != (B,) or not np.isfinite(p).all():
                fail(f"mesh4 {what} ShardedPredictor: probabilities are not "
                     f"finite of shape ({B},)")
            worst[what] = max(worst[what], float(np.abs(p - p1).max()))
        for o in outs[1:]:  # every rank returns the whole batch
            if not np.array_equal(o["probs4"][i], outs[0]["probs4"][i]):
                fail("mesh4: the ranks' ShardedPredictors disagree")
    if not max(worst.values()) <= PROB_ATOL:
        fail(f"mesh4: sharded vs one-device probabilities differ: {worst}")
    # the host-sharded engine: launches on every rank, and its 4-part save
    # served by the one-device device-index Predictor and a 2-rank
    # ShardedPredictor alike (the cross-engine contract)
    hs_launches = {}
    for r, o in enumerate(outs):
        for n, v in o["hs"]["launches"].items():
            if v <= 0:
                fail(f"{n} was not launched on mesh4 rank {r}'s "
                     f"host-sharded path")
            hs_launches[n] = hs_launches.get(n, 0) + v
    one = predictor(os.path.join(tmp, "mesh4_hs_ck"), dev)
    hs_dp = 0.0
    for i, b in enumerate(held):
        p = outs[0]["hs"]["probs2"][i]
        if p.shape != (B,) or not np.isfinite(p).all():
            fail("mesh4 host-sharded save: 2-rank probabilities are not "
                 f"finite of shape ({B},)")
        hs_dp = max(hs_dp, float(np.abs(p - one.predict(b)).max()))
    del one
    if not hs_dp <= PROB_ATOL:
        fail(f"mesh4: the host-sharded save served at 2 ranks differs from "
             f"the one-device Predictor by {hs_dp}")
    h = outs[0]["hs"]
    log(f"mesh4 host-sharded ({backend}, {MESH4_RANKS} ranks): launches "
        f"summed over the ranks {hs_launches}; {HSMESH4_STEPS} steps in "
        f"lockstep with gloo CPU twins (wires bit-equal every step): max "
        f"|dloss| {max(x['hs']['max_dloss'] for x in outs):.3g}, max |drow| "
        f"{max(x['hs']['max_drow'] for x in outs):.3g}; staged examples/s "
        f"median {statistics.median(h['staged_eps']):.1f} (min "
        f"{min(h['staged_eps']):.1f}, max {max(h['staged_eps']):.1f}) over "
        f"3 runs of 5 steps; host exchange "
        f"{max(x['hs']['exchange_ms'] for x in outs):.3f} ms a step (the "
        f"slowest rank, host clock, in the staged resolves), "
        f"exchange_late_steps {h['health']['exchange_late_steps']}; its "
        f"4-part save served at 2 ranks within {hs_dp:.3g} of the "
        f"one-device device-index Predictor")
    o = outs[0]
    rates = o["staged_eps"]
    log(f"mesh4: {MESH4_STEPS} steps in lockstep with gloo CPU twins: max "
        f"|dloss| {max(x['max_dloss'] for x in outs):.3g}, max |drow| "
        f"{max(x['max_drow'] for x in outs):.3g}; staged examples/s at "
        f"B={B} ({B // MESH4_RANKS} a rank): median "
        f"{statistics.median(rates):.1f}, min {min(rates):.1f}, max "
        f"{max(rates):.1f} over 3 runs of 5 steps; "
        f"{backend} all_to_all {o['a2a_host_ms_per_step']:.3f} ms a step on "
        f"rank 0's clock ({o['a2a_ms_per_step']:.3f} ms between its "
        f"stream's events, {o['a2a_calls_per_step']:.0f} calls); the "
        f"4-shard save served by the one-device Predictor, a 4-rank and a "
        f"2-rank ShardedPredictor: max |dp| {worst} (limit {PROB_ATOL}); "
        f"health {o['health']}; phase {time.perf_counter() - t_phase:.1f} s,"
        f" on {smi}")
    return {"mesh4": launches, "mesh4_hs": hs_launches}, {
        "host_sharded": {
            "staged_eps": h["staged_eps"],
            "exchange_ms": max(x["hs"]["exchange_ms"] for x in outs),
            "late_steps": h["health"]["exchange_late_steps"],
            "max_dloss": max(x["hs"]["max_dloss"] for x in outs),
            "max_drow": max(x["hs"]["max_drow"] for x in outs),
            "serve_dp": hs_dp, "health": h["health"]},
        "staged_eps": rates, "a2a_ms_per_step": o["a2a_ms_per_step"],
        "a2a_host_ms_per_step": o["a2a_host_ms_per_step"],
        "a2a_calls_per_step": o["a2a_calls_per_step"],
        "max_dloss": max(x["max_dloss"] for x in outs),
        "max_drow": max(x["max_drow"] for x in outs), "serve_dp": worst,
        "backend": backend,
        "summary": o["summary"], "health": o["health"]}


# -- phase 18 and the host-sharded half of 17: the host-sharded engine --------
def hs_trainer(dev, axis=None, metadata=True, extra=()):
    """bench.py's DLRM on the host-index engine as the CLI builds it:
    ``deeprec_tpu_torch/modelzoo/DLRM/train.py`` with --host_index (B 4096,
    emb dim 16, 2^21 rows, --max_unique_ratio 0.25; --metadata adds
    --ev_filter_freq 2 --ev_evict_steps 20), its table in fused Adagrad
    columns trained by ``sparse_adagrad_fused`` (bench.py's optimizer),
    through ``cli.make_trainer``: with ``--mesh S`` over ``axis`` a
    ``ShardedTrainer`` over a ``HostShardedCollection``, else the
    one-device ``Trainer``."""
    import dataclasses
    import importlib
    from deeprec_tpu_torch.optim.sparse import sparse_adagrad_fused
    from deeprec_tpu_torch.train import cli
    mod = importlib.import_module("deeprec_tpu_torch.modelzoo.DLRM.train")
    flags = ["--batch_size", str(B), "--emb_dim", str(EMB_DIM), "--capacity",
             str(CAPACITY), "--seed", str(SEED), "--device", str(dev),
             "--optimizer", "adagrad", "--max_unique_ratio", "0.25",
             "--host_index"]
    if metadata:
        flags += ["--ev_filter_freq", "2", "--ev_evict_steps", "20"]
    if axis is not None:
        flags += ["--mesh", str(axis.size)]
    args = cli.base_parser("DLRM").parse_args(flags + list(extra))
    spec = mod.build(args)
    coll = spec.collections["emb"]
    coll.config = dataclasses.replace(coll.config, fused_slot_columns=EMB_DIM,
                                      fused_slot_init=0.1)
    spec.sparse_optimizers["emb"] = sparse_adagrad_fused(
        args.learning_rate, initial_accumulator_value=0.1)
    need_native(spec.collections, "the host-sharded phase")
    tr = cli.make_trainer(spec, args, mesh=axis)
    want = "HostShardedCollection" if axis is not None else \
        "HostIndexEmbeddingCollection"
    if type(tr.collections["emb"]).__name__ != want:
        fail(f"--host_index{' --mesh' if axis is not None else ''} did not "
             f"give a {want}")
    return tr


def hs_same_tables(tg, sg, tc, sc, what):
    """This rank's shard, card against CPU: the resolver's keys (slot
    order), the metadata planes bit-equal; rows, slot rows and parameters
    within ROW_ATOL. Returns the largest float difference."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    cg, cc = tg.collections["emb"], tc.collections["emb"]
    kg, kc = cg._resolver.export_keys(), cc._resolver.export_keys()
    if not np.array_equal(kg, kc):
        fail(f"{what}: card and CPU resolvers hold other keys")
    n = kg.shape[0]
    eg, ec = sg.tables["emb"].ev, sc.tables["emb"].ev
    for f in ("freqs", "versions", "create_steps"):
        if not torch.equal(getattr(eg, f)[:n].cpu(), getattr(ec, f)[:n]):
            fail(f"{what}: {f} planes differ between card and CPU")
    worst = 0.0
    pairs = [("rows", eg.values[:n], ec.values[:n])] + [
        (f"slot {p}", a[:n] if a.dim() else a, c[:n] if c.dim() else c)
        for (p, a), (_, c) in zip(leaves_with_paths(sg.tables["emb"].slot),
                                  leaves_with_paths(sc.tables["emb"].slot))]
    pairs += [(f"parameter {k}", a.detach(), b.detach()) for (k, a), b in
              zip(tg.model.named_parameters(), tc.model.parameters())]
    for leaf, a, c in pairs:
        d = (a.cpu().float() - c.float()).abs().max().item() if a.numel() \
            else 0.0
        worst = max(worst, d)
        if not d <= ROW_ATOL:
            fail(f"{what}: {leaf} differ by {d} between card and CPU")
    return worst


def hs_lockstep(tg, tc, batches, what, fence=MESH_FENCE):
    """Train the card's and the CPU twin's host-sharded trainers on
    ``batches``: every step's wires (this rank's resolved exchange)
    bit-equal and loss within LOSS_ATOL; at every ``fence`` steps the
    shards as :func:`hs_same_tables` says, after which the twin takes the
    card's float state (:func:`anchor`). Returns the states and the
    largest loss and row differences."""
    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    dloss = drow = 0.0
    for i, b in enumerate(batches):
        dg, cg, lg = tg.prepare_batch(b)
        dc, cc, lc = tc.prepare_batch(b)
        if not torch.equal(cg["emb"].buf.cpu(), cc["emb"].buf):
            fail(f"{what}: card and CPU wires differ at step {i}")
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg, sc = tg._train_step(sg, dg, cg, lg), tc._train_step(sc, dc, cc,
                                                                lc)
        lg_ = (sg.metrics.loss_sum.item() - g0) / B
        lc_ = (sc.metrics.loss_sum.item() - c0) / B
        if not (np.isfinite(lg_) and abs(lg_ - lc_) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg_} on the card vs {lc_} on CPU")
        dloss = max(dloss, abs(lg_ - lc_))
        if (i + 1) % fence == 0 or i + 1 == len(batches):
            drow = max(drow, hs_same_tables(tg, sg, tc, sc, what))
            anchor(tg, sg, tc, sc)
    return sg, sc, dloss, drow


class HXTimer:
    """Wraps a host-sharded collection's host exchange: each step's
    exchange time on the host clock (the resolve's wait for its peers'
    frames included)."""

    def __init__(self, coll):
        self.hx, self.secs = coll._hx, []

    def __enter__(self):
        orig = type(self.hx).all_to_all

        def timed(blobs):
            t = time.perf_counter()
            out = orig(self.hx, blobs)
            self.secs.append(time.perf_counter() - t)
            return out
        self.hx.all_to_all = timed
        return self

    def __exit__(self, *exc):
        del self.hx.all_to_all

    def ms(self):
        return sum(self.secs) * 1e3 / max(len(self.secs), 1)


def hs_owner_shape(coll, S):
    """The host-sharded exchange of one B=4096 batch over ``S`` ranks, as
    the ranks resolve it, for requester and owner rank 0: each rank's
    requester dedup and buckets (slack 2), the S*C lanes owner 0 receives
    and its resolve into a fresh 2^21-row shard. Returns rank 0's
    ``(inv_local, u_idx, owner keys, owner slots, owner created, owner
    counts, C)``."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.parallel.sharded import (_bucket_positions,
                                                    owner_of_np)
    from deeprec_tpu_torch.utils.native import HostIndexResolver
    cfg = coll.config
    ids = coll.pack_ids_np(next(SyntheticCriteo(batch_size=B, seed=7)))
    b = B // S
    nl = ids.shape[0] * b
    uc = cfg.max_unique + 1
    C = max(int(np.ceil(min(nl, uc) * 2.0 / S / 8.0) * 8), 8)
    recv_k, recv_c = [], []
    for r in range(S):
        dedup = HostIndexResolver(use_native=True)
        uk, _, inv, _, ct, _, _ = dedup.resolve(
            ids[:, r * b:(r + 1) * b].reshape(-1), uc, 0, 0)
        own = owner_of_np(uk, S)
        pos = _bucket_positions(torch.from_numpy(own)).numpy()
        routed = (uk != -1) & (own < S) & (pos < C)
        keys = np.full((S, C), -1, np.int64)
        counts = np.zeros((S, C), np.int32)
        keys[own[routed], pos[routed]] = uk[routed]
        counts[own[routed], pos[routed]] = ct[routed]
        recv_k.append(keys[0])
        recv_c.append(counts[0])
        if r == 0:
            inv0 = inv
            uidx0 = np.where(routed, own * C + pos, -1)
    owner = HostIndexResolver(use_native=True)
    rk, rs, rinv, rcr, _, _, _ = owner.resolve(
        np.concatenate(recv_k), uc, cfg.capacity, cfg.capacity)
    freq = np.bincount(rinv, weights=np.concatenate(recv_c),
                       minlength=uc)[:uc].astype(np.int32)
    return inv0, uidx0, rk, rs, rcr.astype(bool), freq, C


def check_hs_kernels(dev):
    """K1, K2, K2's backward and K3a at the host-sharded engine's owner
    shapes of phase 17 (4 ranks, 1,024 examples each, the --metadata DLRM
    of :func:`hs_trainer`), from one B=4096 batch resolved here as the
    ranks resolve it (:func:`hs_owner_shape`): K3a (lookup_meta,
    CounterFilter(2)) at owner 0's lanes with the summed multiplicities,
    K1's fetch of its rows at the host-assigned slots (int32), K2 and its
    backward pooling rank 0's unbucketed rows through its int32 inverse;
    then K1 at the DHT phase's shape (a partition's rows at the owner's
    ids of one rank's half of a batch). Returns the entries (paths
    ``mesh4_hs`` and ``dht``)."""
    import torch.nn.functional as Fn
    S = MESH4_RANKS
    g = torch.Generator().manual_seed(SEED + 6)
    coll = hs_trainer("cpu").collections["emb"]
    cap = coll.config.capacity
    inv, uidx, rk, rs, created, freq, C = hs_owner_shape(coll, S)
    u = uidx.shape[0]
    log(f"host-sharded owner shape: {S} requesters x C {C} lanes, owner 0 "
        f"holds {int((rk != -1).sum())} unique keys in {rk.shape[0]} lanes "
        f"({int(created.sum())} created), counts up to {int(freq.max())}; "
        f"requester 0: {inv.shape[0]} ids over {u} lanes, "
        f"{int((uidx >= 0).sum())} routed")
    uslots = torch.from_numpy(rs).to(dev)
    counts = torch.from_numpy(freq).to(dev)
    cr = torch.from_numpy(created).to(dev)
    entries = [k3a_case(
        f"(host-sharded owner, planes of {cap + 1})", "_mesh4_hs", uslots,
        counts, torch.zeros((1,), dtype=torch.bool, device=dev),
        torch.where(cr, uslots, cap + 1), cap, 2)]
    table = torch.randn(cap + 1, 2 * EMB_DIM, generator=g).to(dev)
    entries.append(k1_case("(host-sharded owner rows at host slots, int32)",
                           table, uslots, "mesh4_hs", d=EMB_DIM))
    slots = torch.from_numpy(inv).to(dev).view(-1, 1)
    routed = torch.from_numpy(uidx >= 0).to(dev)
    valid = routed[slots.view(-1).long()].view(-1, 1)
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    entries += k2_pair(
        f"(host-sharded requester, [26*{B // S}, 1] sum, D {EMB_DIM}, int32 "
        f"inverse)", urows, slots, valid, "sum", d_pooled,
        lambda: Fn.embedding_bag(slots.long(), urows,
                                 per_sample_weights=valid.float(),
                                 mode="sum"),
        "mesh4_hs")
    for e in entries:
        e["path"] = "mesh4_hs"
    # the DHT phase: owner 0's ids for its received keys of one batch
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    ids = coll.pack_ids_np(next(SyntheticCriteo(batch_size=B, seed=7)))
    keys = np.unique(ids[:, :B // MESH2_RANKS])
    from deeprec_tpu_torch.parallel.sharded import owner_of_np
    mine = keys[owner_of_np(keys, MESH2_RANKS) == 0]
    uids = torch.arange(mine.shape[0], dtype=torch.int32, device=dev)
    rows = torch.randn(DHT_CAPACITY + 1, EMB_DIM, generator=g).to(dev)
    e = k1_case(f"(DHT partition rows at {mine.shape[0]} owner ids)", rows,
                uids, "dht")
    e["path"] = "dht"
    return entries + [e]


def check_hsmesh1(dev, smi):
    """Phase 18: the host-sharded engine as one NCCL rank, built through
    ``cli.make_trainer`` with ``--mesh 1 --host_index``
    (:func:`hs_trainer`): HS_STEPS --metadata steps and HS_LIGHT_STEPS
    light steps in lockstep with a CPU twin on a gloo group of the same
    process (:func:`hs_lockstep`); K1, K2, K2's backward and K3a launched;
    HS_EXACT_STEPS exact-dedup steps against the one-device host-index
    Trainer (the same key -> slot map, rows and losses); staged examples/s
    beside the one-device host-index engine's in the same call. Returns
    the launches and the phase's summary."""
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    t_phase = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        nccl = make_mesh(1, device=dev)
        gloo = make_mesh(1, group=dist.new_group([0], backend="gloo"),
                         device="cpu")
        batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
            HS_STEPS + 60))
        tg, tc = hs_trainer(dev, nccl), hs_trainer("cpu", gloo)
        counters = path_counters(dlrm=True)
        for fn in counters.values():
            fn.launches = 0
        sg, sc, dloss, drow = hs_lockstep(tg, tc, batches[:HS_STEPS],
                                          "hsmesh1 --metadata")
        launches = {n: fn.launches for n, fn in counters.items()}
        log(f"hsmesh1 (NCCL, 1 rank) main path ({HS_STEPS} --metadata "
            f"steps) launches: {launches}")
        for n, v in launches.items():
            if v <= 0:
                fail(f"{n} was not launched on the hsmesh1 path")
        summ = _metrics_summary(sg)
        health = tg.table_health(sg)["emb"]
        del tc, sc
        lg, lc = (hs_trainer(dev, nccl, metadata=False),
                  hs_trainer("cpu", gloo, metadata=False))
        _, _, lloss, lrow = hs_lockstep(lg, lc, batches[:HS_LIGHT_STEPS],
                                        "hsmesh1 light")
        del lg, lc
        # the one-device host-index engine with exact dedup: the same key
        # -> slot map (the resolver's keys in slot order) and rows
        exact = ["--max_unique_ratio", "0"]
        tm, t1 = hs_trainer(dev, nccl, extra=exact), hs_trainer(dev,
                                                               extra=exact)
        sm, s1 = tm.init(batches[0]), t1.init(batches[0])
        dloss1 = 0.0
        for b in batches[:HS_EXACT_STEPS]:
            m0, o0 = sm.metrics.loss_sum.item(), s1.metrics.loss_sum.item()
            sm, s1 = tm.train_step(sm, b), t1.train_step(s1, b)
            dloss1 = max(dloss1, abs(sm.metrics.loss_sum.item() - m0
                                     - s1.metrics.loss_sum.item() + o0) / B)
        km = tm.collections["emb"]._resolver.export_keys()
        k1 = t1.collections["emb"]._resolver.export_keys()
        if not np.array_equal(km, k1):
            fail("hsmesh1: the key -> slot map differs from the one-device "
                 "host-index trainer's")
        n = k1.shape[0]
        drow1 = (sm.tables["emb"].ev.values[:n]
                 - s1.tables["emb"].ev.values[:n]).abs().max().item()
        if not (drow1 <= ROW_ATOL and dloss1 <= LOSS_ATOL):
            fail(f"hsmesh1: rows differ from the one-device trainer's by "
                 f"{drow1}, losses by {dloss1}")
        del tm, sm
        torch.cuda.empty_cache()
        # staged rates, the mesh and one device in turns in this call
        rest = batches[HS_STEPS:]
        sg, rates = timed_runs(tg, sg, rest[:30])
        s1, rates1 = timed_runs(t1, s1, rest[30:60])
        log(f"hsmesh1: {HS_STEPS} --metadata steps in lockstep with a gloo "
            f"CPU twin (wires bit-equal every step): max |dloss| "
            f"{dloss:.3g}, max |drow| {drow:.3g} at the fences (each window "
            f"of {MESH_FENCE} from the card's state); light layout "
            f"{HS_LIGHT_STEPS} steps: max |dloss| {lloss:.3g}, |drow| "
            f"{lrow:.3g}; after {HS_EXACT_STEPS} exact-dedup steps {n} keys "
            f"in the one-device trainer's slots, rows within {drow1:.3g}, "
            f"losses within {dloss1:.3g}; staged examples/s at B={B}: mesh "
            f"median {statistics.median(rates):.1f} (min {min(rates):.1f}, "
            f"max {max(rates):.1f}), one-device host-index median "
            f"{statistics.median(rates1):.1f} (min {min(rates1):.1f}, max "
            f"{max(rates1):.1f}) over 3 runs of 10 steps each; health "
            f"{health}; phase {time.perf_counter() - t_phase:.1f} s, on "
            f"{smi}")
        return launches, {"staged_eps": rates, "one_device_staged_eps":
                          rates1, "max_dloss": dloss, "max_drow": drow,
                          "light_max_dloss": lloss, "light_max_drow": lrow,
                          "one_device_drow": drow1,
                          "one_device_dloss": dloss1, "summary": summ,
                          "health": health}
    finally:
        dist.destroy_process_group()


# -- phases 19-21: tiermesh, dht and servemesh on two ranks -------------------
def tiermesh_trainer(dev, axis):
    """The device phase's DLRM as ``--mesh 2 --ev_storage hbm_dram
    --ev_hbm_capacity TIERMESH_HBM --capacity TIERMESH_CAPACITY`` makes it
    through ``cli.make_trainer``: a TieredShardedTrainer."""
    from deeprec_tpu_torch.train import cli
    mod, args = device_entry(dev, [
        "--mesh", str(axis.size), "--capacity", str(TIERMESH_CAPACITY),
        "--ev_storage", "hbm_dram", "--ev_hbm_capacity", str(TIERMESH_HBM)])
    tr = cli.make_trainer(mod.build(args), args, mesh=axis)
    if type(tr).__name__ != "TieredShardedTrainer":
        fail("--mesh with --ev_storage hbm_dram did not give a "
             "TieredShardedTrainer")
    return tr


def mesh2_tiermesh(dev, card, twin, batches, ckpt):
    """Phase 19 on this rank: TIERMESH_STEPS steps of the card's and the
    CPU twin's TieredShardedTrainers in lockstep (:func:`device_lockstep`,
    promotion inside each step), demotion every TIERMESH_FENCE steps: the
    tiers' keys and integer payload columns bit-equal, their rows within
    ROW_ATOL, this shard within its share of the budget; then a full save
    of both shards (and tiers) to ``ckpt``."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    tg, tc = tiermesh_trainer(dev, card), tiermesh_trainer("cpu", twin)
    share = TIERMESH_HBM // card.size
    moves = {"demoted": 0, "promoted": 0}
    last = {"rows": 0}
    width = 2 * EMB_DIM

    def fence(i, sg, sc):
        moves["promoted"] += max(0, last["rows"] - tg.host_tier_rows("emb"))
        if i % TIERMESH_FENCE == TIERMESH_FENCE - 1:
            before = tg.host_tier_rows("emb")
            sg, sc = tg.maybe_demote(sg), tc.maybe_demote(sc)
            moves["demoted"] += tg.host_tier_rows("emb") - before
            (kg, rg), (kc, rc) = device_tiers(tg), device_tiers(tc)
            if not np.array_equal(kg, kc) or (rg is None) != (rc is None):
                fail(f"tiermesh: card and CPU tier keys differ after step {i}")
            if rg is not None:
                ig = rg[:, width:width + 3].copy().view(np.int32)
                ic = rc[:, width:width + 3].copy().view(np.int32)
                d = float(np.abs(rg[:, :width] - rc[:, :width]).max())
                if not (np.array_equal(ig, ic) and d <= ROW_ATOL):
                    fail(f"tiermesh: payloads differ after step {i} (rows "
                         f"by {d})")
            live = int(sg.tables["emb"].ev.index.size)
            if live > share:
                fail(f"tiermesh: {live} rows stayed in a shard, over its "
                     f"share {share} of the budget")
        last["rows"] = tg.host_tier_rows("emb")
        return sg, sc
    counters = path_counters()
    for fn in counters.values():
        fn.launches = 0
    sg, sc, dloss, drow = device_lockstep(
        tg, tc, batches[:TIERMESH_STEPS], f"tiermesh rank {card.rank}",
        fence=fence)
    launches = {n: fn.launches for n, fn in counters.items()}
    del tc, sc
    CheckpointManager(ckpt).save(tg, sg, evict=False)
    keys = sg.tables["emb"].ev.index.keys.cpu().numpy()
    tier_keys, _ = device_tiers(tg)
    return launches, {"moves": moves, "max_dloss": dloss, "max_drow": drow,
                      "tier_rows": tg.host_tier_rows("emb"),
                      "device_keys": keys[keys != -1], "tier_keys": tier_keys}


def mesh2_dht(dev, card, twin, batches):
    """Phase 20 on this rank: DistributedHashTable steps at 2 ranks on the
    card beside a CPU twin on the second gloo group: each step's keys
    (this rank's half of a B=4096 batch's 26 columns) get their global
    ids, rows and a seeded cotangent's sparse Adagrad update
    (``apply_cotangent``): ids and validity bit-equal to the twin's, rows
    within ROW_ATOL; the health, a growth check and a save's key set."""
    from deeprec_tpu_torch.optim import sparse as sopt
    from deeprec_tpu_torch.parallel import DistributedHashTable
    from deeprec_tpu_torch.sparse import keys as K
    coll = criteo_parts()[1]
    tables = {}
    for where, axis in ((dev, card), ("cpu", twin)):
        dht = DistributedHashTable(axis, capacity_per_shard=DHT_CAPACITY,
                                   dim=EMB_DIM, bucket_cap=26 * B // 2)
        opt = sopt.sparse_adagrad(0.05)
        st = dht.init()
        tables[where] = [dht, opt, st, dht.init_slot(opt, st)]
    g = torch.Generator().manual_seed(SEED + 7 + card.rank)
    counters = path_counters()
    for fn in counters.values():
        fn.launches = 0
    drow, t_card = 0.0, []
    for i, b in enumerate(batches[:DHT_STEPS]):
        ids = coll.pack_ids_np(b)
        half = B // card.size
        keys = torch.from_numpy(np.ascontiguousarray(
            ids[:, card.rank * half:(card.rank + 1) * half]).reshape(-1))
        ct = torch.randn(keys.shape[0], EMB_DIM, generator=g)
        out = {}
        for where, box in tables.items():
            dht, opt, st, slot = box
            if where == dev:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            st, gid = dht.gen_ids(st, keys)
            st, slot, rows, valid = dht.apply_cotangent(
                st, opt, slot, keys, ct, i)
            if where == dev:
                torch.cuda.synchronize()
                t_card.append(time.perf_counter() - t0)
            box[2:] = [st, slot]
            out[where] = (gid.cpu(), rows.cpu(), valid.cpu())
        (gg, rg, vg), (gc, rc, vc) = out[dev], out["cpu"]
        if not (torch.equal(gg, gc) and torch.equal(vg, vc)):
            fail(f"dht rank {card.rank}: card and CPU ids differ at step {i}")
        if not bool((gg[~K.is_empty(keys)] >= 0).all()):
            fail(f"dht rank {card.rank}: a key got no id at step {i}")
        drow = max(drow, (rg - rc).abs().max().item())
    launches = {n: fn.launches for n, fn in counters.items()}
    dht, _, st, _ = tables[dev]
    dc, _, sc, _ = tables["cpu"]
    d = (st.table.rows.cpu() - sc.table.rows).abs().max().item()
    drow = max(drow, d)
    if not drow <= ROW_ATOL:
        fail(f"dht rank {card.rank}: rows differ by {drow} card vs CPU")
    health = dht.health(st)
    if health != dc.health(sc):
        fail("dht: card and CPU health differ")
    grown = dht.maybe_grow(st)
    saved = dht.checkpoint_arrays(st)
    return launches, {"max_drow": drow, "health": health,
                      "grew": grown is not st,
                      "step_ms": [1e3 * t for t in t_card],
                      "saved_keys": int(saved["keys"].shape[0])}


def mesh2_servemesh(dev, ckpt, held):
    """Phase 21 on this rank: ``serving.server --mesh 2`` over the mesh4
    phase's save (every rank builds it; rank 0 serves HTTP): SERVE_BATCHES
    predicts of B rows, one request without a column the model reads (a
    400 on rank 0, nothing broadcast), a refresh; closing rank 0's server
    stops rank 1. Returns this rank's launches and rank 0's replies."""
    from deeprec_tpu_torch.serving.server import RankLoop, build_server
    counters = path_counters()
    for fn in counters.values():
        fn.launches = 0
    srv, _ = build_server([
        "--model", "DLRM", "--ckpt_dir", ckpt, "--host", "127.0.0.1",
        "--port", "0", "--mesh", str(MESH2_RANKS), "--", "--emb_dim",
        str(EMB_DIM), "--capacity", str(CAPACITY), "--device", str(dev)])
    if isinstance(srv, RankLoop):
        srv.serve_forever()
        return {n: fn.launches for n, fn in counters.items()}, \
            {"calls": srv.calls}
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    replies, lat = [], []
    try:
        for b in held[:SERVE_BATCHES]:
            body = {"inputs": {k: v.tolist() for k, v in b.items()
                               if k != "label"}}
            t0 = time.perf_counter()
            replies.append(_post(f"{url}/v1/predict", body))
            lat.append((time.perf_counter() - t0) * 1e3)
        bad = {"inputs": {k: v.tolist() for k, v in held[0].items()
                          if k not in ("label", "C7")}}
        req = urllib.request.Request(
            f"{url}/v1/predict", data=json.dumps(bad).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            fail("servemesh: a request without column C7 was answered")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"servemesh: the malformed request got {e.code}")
        refreshed = _post(f"{url}/refresh", {})
    finally:
        srv.shutdown()
        srv.server_close()
    return ({n: fn.launches for n, fn in counters.items()},
            {"predictions": [np.asarray(r["predictions"]) for r in replies],
             "steps": [r["step"] for r in replies], "refresh": refreshed,
             "latency_ms": lat})


def mesh2_rank(job_path, rank):
    """One rank of phases 19-21 (``python3 chip_smoke.py --mesh2-rank R
    JOB``): joins a gloo group of MESH2_RANKS processes on cuda:0 and a
    second gloo group for the CPU twins, runs tiermesh, dht and servemesh
    in turn and pickles their numbers for the parent."""
    import pickle
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops import _build
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.library()  # the parent built it
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // MESH2_RANKS))
    multihost.initialize(job["addr"], MESH2_RANKS, rank, backend="gloo",
                         timeout_s=MESH2_TIMEOUT_S)
    try:
        card = make_mesh(MESH2_RANKS, device=dev)
        twin = make_mesh(MESH2_RANKS, group=dist.new_group(backend="gloo"),
                         device="cpu")
        batches = list(SyntheticCriteo(batch_size=B, seed=7).take(
            TIERMESH_STEPS))
        out = {}
        t0 = time.perf_counter()
        out["tiermesh"] = mesh2_tiermesh(dev, card, twin, batches,
                                         job["tier_ckpt"])
        out["tiermesh_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["dht"] = mesh2_dht(dev, card, twin, batches)
        out["dht_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        held = list(SyntheticCriteo(batch_size=B, seed=11).take(
            SERVE_BATCHES))
        t0 = time.perf_counter()
        out["servemesh"] = mesh2_servemesh(dev, job["serve_ckpt"], held)
        out["servemesh_s"] = time.perf_counter() - t0
        card.barrier()
        with open(f"{job_path}.out{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(flag, n, job, tmp, timeout_s, what):
    """Start this script ``n`` times as ``flag R job``; wait at most
    ``timeout_s``; a rank that fails (or outlives it) fails the smoke.
    Returns the ranks' pickled results."""
    import pickle
    procs = []
    for r in range(n):
        log_f = open(os.path.join(tmp, f"{what}_rank{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), job],
            cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT), log_f))
    deadline = time.monotonic() + timeout_s
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, log_f) in enumerate(procs):
        log_f.seek(0)
        text = log_f.read()
        log_f.close()
        if p.returncode != 0:
            fail(f"{what} rank {r} exited {p.returncode}:\n{text[-6000:]}")
        with open(f"{job}.out{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def check_mesh2(dev, smi, tmp, serve_ckpt):
    """Phases 19-21 in MESH2_RANKS rank processes (:func:`mesh2_rank`) on
    the card over gloo. tiermesh: each rank's lockstep held; rows demoted
    and promoted; the 2-rank save (device rows and tiers) restores into a
    one-device TieredTrainer on the card with every saved key in one tier.
    dht: ids bit-equal and rows within ROW_ATOL card vs CPU on each rank.
    servemesh: rank 0's HTTP answers within PROB_ATOL of the one-device
    Predictor over the same save, the malformed request refused, rank 1
    served every call. K1, K2, K2's backward and K3a launch on tiermesh,
    K1 on dht, K1 and K2 on servemesh. Returns the launches by path
    (summed over the ranks) and the phases' summaries."""
    import pickle
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    t_phase = time.perf_counter()
    job = os.path.join(tmp, "mesh2.pkl")
    tier_ckpt = os.path.join(tmp, "tiermesh_ck")
    with open(job, "wb") as f:
        pickle.dump({"addr": f"127.0.0.1:{free_port()}",
                     "device": "cuda:0" if dev.type == "cuda" else "cpu",
                     "tier_ckpt": tier_ckpt, "serve_ckpt": serve_ckpt}, f)
    outs = spawn_ranks("--mesh2-rank", MESH2_RANKS, job, tmp,
                       MESH2_TIMEOUT_S, "mesh2")
    need = {"tiermesh": ("gather_rows", "fused_pooled_lookup",
                         "fused_pooled_lookup_backward", "lookup_meta"),
            "dht": ("gather_rows",),
            "servemesh": ("gather_rows", "fused_pooled_lookup")}
    paths = {}
    for phase, names in need.items():
        paths[phase] = {}
        for r, o in enumerate(outs):
            for n, v in o[phase][0].items():
                if n in names and v <= 0:
                    fail(f"{n} was not launched on rank {r}'s {phase} path")
                paths[phase][n] = paths[phase].get(n, 0) + v
        log(f"{phase} (gloo, {MESH2_RANKS} ranks on the card) main path "
            f"launches summed over the ranks: {paths[phase]}")
    # tiermesh: both ranks moved rows; the save restores at 1 rank
    tiers = [o["tiermesh"][1] for o in outs]
    moves = {k: sum(t["moves"][k] for t in tiers)
             for k in ("demoted", "promoted")}
    if not (moves["demoted"] > 0 and moves["promoted"] > 0):
        fail(f"tiermesh: rows demoted {moves['demoted']}, promoted "
             f"{moves['promoted']}: both must move")
    saved_dev = np.concatenate([t["device_keys"] for t in tiers])
    saved_tier = np.concatenate([t["tier_keys"] for t in tiers])
    tr = device_trainer(dev, ["--capacity", str(TIERMESH_CAPACITY),
                              "--ev_storage", "hbm_dram", "--ev_hbm_capacity",
                              str(TIERMESH_HBM)])
    batch = next(SyntheticCriteo(batch_size=B, seed=7))
    st, ok = CheckpointManager(tier_ckpt).restore(tr, tr.init(batch))
    if not ok or st.step != TIERMESH_STEPS:
        fail("tiermesh: the 2-rank save did not restore at 1 rank")
    keys = st.tables["emb"].ev.index.keys.cpu().numpy()
    keys = keys[keys != -1]
    tier_keys, _ = device_tiers(tr)
    if np.intersect1d(keys, tier_keys).size:
        fail("tiermesh: a restored key lives in both tiers")
    if not np.array_equal(np.sort(np.concatenate([keys, tier_keys])),
                          np.sort(np.concatenate([saved_dev, saved_tier]))):
        fail("tiermesh: the restore at 1 rank lost or added keys")
    del tr, st
    torch.cuda.empty_cache()
    # dht: every rank in lockstep with its twin; the health is global
    dhts = [o["dht"][1] for o in outs]
    if any(d["health"] != dhts[0]["health"] for d in dhts):
        fail("dht: the ranks report other health")
    # servemesh: rank 0's answers against the one-device Predictor
    serve = outs[0]["servemesh"][1]
    if outs[1]["servemesh"][1]["calls"] != SERVE_BATCHES + 1:
        fail(f"servemesh: rank 1 served {outs[1]['servemesh'][1]['calls']} "
             f"calls, not {SERVE_BATCHES} predicts and a refresh")
    one = predictor(serve_ckpt, dev)
    held = list(SyntheticCriteo(batch_size=B, seed=11).take(SERVE_BATCHES))
    worst = 0.0
    for b, p in zip(held, serve["predictions"]):
        if p.shape != (B,) or not np.isfinite(p).all():
            fail("servemesh: predictions are not finite of shape (B,)")
        worst = max(worst, float(np.abs(p - one.predict(b)).max()))
    if not worst <= PROB_ATOL:
        fail(f"servemesh: HTTP answers differ from the one-device Predictor "
             f"by {worst}")
    del one
    t = [o["tiermesh"][1] for o in outs]
    log(f"tiermesh: {TIERMESH_STEPS} steps in lockstep with gloo CPU twins "
        f"on {MESH2_RANKS} ranks: max |dloss| "
        f"{max(x['max_dloss'] for x in t):.3g}, max |drow| "
        f"{max(x['max_drow'] for x in t):.3g}; rows {moves}, "
        f"{sum(x['tier_rows'] for x in t)} in the tiers at the save; the "
        f"save restored at 1 rank with {keys.size} device and "
        f"{tier_keys.size} tier keys, each in one tier; "
        f"{max(o['tiermesh_s'] for o in outs):.1f} s")
    log(f"dht: {DHT_STEPS} steps of gen_ids + apply_cotangent (sparse "
        f"Adagrad) at {MESH2_RANKS} ranks, {26 * B // MESH2_RANKS} keys a "
        f"rank: ids bit-equal to the CPU twins', max |drow| "
        f"{max(d['max_drow'] for d in dhts):.3g}; health {dhts[0]['health']}"
        f"; step ms on rank 0's clock (2 all_to_alls of keys, 1 of ids, the "
        f"rows and their reverse, the twin's excluded) "
        f"{[round(x, 2) for x in dhts[0]['step_ms']]}; "
        f"{max(o['dht_s'] for o in outs):.1f} s")
    log(f"servemesh: --mesh {MESH2_RANKS} answered {SERVE_BATCHES} predicts "
        f"of B={B} within {worst:.3g} of the one-device Predictor (limit "
        f"{PROB_ATOL}), a request without C7 refused (400) before any "
        f"broadcast, refresh {serve['refresh']}; request ms (host clock, "
        f"JSON both ways) {[round(x, 1) for x in serve['latency_ms']]}; "
        f"{max(o['servemesh_s'] for o in outs):.1f} s; phases 19-21 "
        f"{time.perf_counter() - t_phase:.1f} s, on {smi}")
    return paths, {
        "tiermesh": {"moves": moves,
                     "max_dloss": max(x["max_dloss"] for x in t),
                     "max_drow": max(x["max_drow"] for x in t)},
        "dht": {"max_drow": max(d["max_drow"] for d in dhts),
                "health": dhts[0]["health"], "step_ms": dhts[0]["step_ms"]},
        "servemesh": {"max_dp": worst, "latency_ms": serve["latency_ms"]}}


# -- phase 22: the soak -------------------------------------------------------
def check_soak_kernels(dev):
    """K1, K2 (both ways), K3a, K5 and K4 at the device-index soak's shape:
    one B=4096 batch of the soak's stream (SyntheticCriteo(4096, seed=11))
    through ``unique_cols`` at its 26*B/6 = 17,750 lanes (int64 inverse
    and slots) into the 2^17-slot index of harness.soak's table, K5 first
    (every key created) and steady (every key found), K4 the held-out
    eval's read-only lookup of a seed-999 batch's keys in that index.
    Returns the entries (path ``soak_device``)."""
    import torch.nn.functional as Fn
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.harness import soak
    from deeprec_tpu_torch.ops.unique import unique_cols
    from deeprec_tpu_torch.sparse import hashtable as ht
    g = torch.Generator().manual_seed(SEED + 22)
    coll = soak.build_trainer(soak.parse_args(
        ["--device", str(dev)])).collections["emb"]
    cfg, cap = coll.config, coll.config.capacity

    def batch_keys(seed):
        ids = torch.from_numpy(coll.pack_ids_np(
            next(SyntheticCriteo(batch_size=B, seed=seed)))).to(dev)
        return unique_cols(ids, cfg.max_unique)
    uniq = batch_keys(11)
    index, uslots, created = ht.lookup_or_insert(ht.create(cap, dev),
                                                 uniq.ukeys, cfg.max_probes)
    u, n_real = uslots.shape[0], int(uniq.n_unique)
    slots = uniq.inverse.view(-1, 1)
    valid = (uslots != cap)[uniq.inverse].view(-1, 1)
    log(f"device-index soak shape: {uniq.inverse.shape[0]} ids, {n_real} "
        f"unique keys ({int(uniq.n_overflow)} past the cap) in {u} lanes, "
        f"a {cap}-slot index")
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    entries = k2_pair(
        f"(device-index soak, [26*{B}, 1] sum, D {EMB_DIM}, int64 inverse)",
        urows, slots, valid, "sum", d_pooled,
        lambda: Fn.embedding_bag(slots, urows,
                                 per_sample_weights=valid.float(),
                                 mode="sum"),
        "soak")
    table = torch.randn(cap + 1, EMB_DIM, generator=g).to(dev)
    entries.append(k1_case("(device-index soak unique-row fetch, int64 "
                           "slots)", table, uslots, "soak"))
    entries.append(k3a_case(
        f"(device-index soak shape, planes of {cap + 1})", "_soak", uslots,
        uniq.counts.to(torch.int32),
        torch.zeros((1,), dtype=torch.bool, device=dev),
        torch.where(created, uslots, cap + 1), cap,
        cfg.counter_filter.filter_freq))
    entries.append(hash_case("insert", "(device-index soak first step)",
                             ht.create(cap, dev), uniq.ukeys, "soak_first",
                             cfg.max_probes))
    entries.append(hash_case("insert", "(device-index soak steady step)",
                             index, uniq.ukeys, "soak_steady",
                             cfg.max_probes))
    entries.append(hash_case("lookup", "(device-index soak eval: a seed-999 "
                             "batch's keys)", index, batch_keys(999).ukeys,
                             "soak_eval", cfg.max_probes))
    for e in entries:
        e["path"] = "soak_device"
    return entries


def soak_args(dev, ckpt, engine):
    """harness.soak's arguments for one phase-22 run: its defaults (the
    full widths) driven by SOAK_FENCES fences, a save at every fence."""
    from deeprec_tpu_torch.harness import soak
    return soak.parse_args(
        ["--device", str(dev), "--max-fences", str(SOAK_FENCES),
         "--fence-every", str(SOAK_FENCE_EVERY),
         "--steps-to-live", str(SOAK_STEPS_TO_LIVE),
         "--demote-every", str(SOAK_DEMOTE_EVERY), "--full-secs", "1e9",
         "--incr-secs", "0", "--ckpt-dir", ckpt, "--out", ckpt + ".json"]
        + (["--host_index"] if engine == "host" else []))


def _final_full(ckpt):
    from deeprec_tpu_torch.checkpoint import format as F
    save = [m for m in F.list_saves(ckpt) if m["kind"] == "full"][-1]
    with open(os.path.join(save["path"], "manifest.json")) as f:
        return save, sorted(json.load(f)["tables"])


def soak_drift(ck_a, ck_b, what):
    """Two runs' final full saves, key by key: every integer column
    (keys, freqs, versions, create steps, the tier's keys and its
    payloads' freq, version and create-step columns, the step) must be
    bit-equal; returns the largest |difference| of each float column
    (value rows, slot rows, tier payload values, dense leaves) and the
    float columns whose bits differ."""
    from deeprec_tpu_torch.checkpoint import format as F
    (a, ta), (b, tb) = _final_full(ck_a), _final_full(ck_b)
    if a["step"] != b["step"] or ta != tb:
        fail(f"{what}: the two runs' final saves differ in step or tables: "
             f"{a['step']} {ta} against {b['step']} {tb}")
    drift, differ = {}, []
    for t in ta:
        xa, xb = (F.read_table(s["path"], t) for s in (a, b))
        oa, ob = np.argsort(xa["keys"]), np.argsort(xb["keys"])
        if sorted(xa) != sorted(xb) or not np.array_equal(
                xa["keys"][oa], xb["keys"][ob]):
            fail(f"{what}: table {t}'s keys differ between the runs")
        for col in sorted(xa):
            x, y = np.asarray(xa[col])[oa], np.asarray(xb[col])[ob]
            if x.shape != y.shape or x.dtype != y.dtype:
                fail(f"{what}: {t} {col} differs in shape or dtype")
            if t.startswith("__tier__") and col == "rows":
                # the payload: values | freq | version | create | slots
                ints = slice(EMB_DIM, EMB_DIM + 3)
                if not np.array_equal(x[:, ints].view(np.int32),
                                      y[:, ints].view(np.int32)):
                    fail(f"{what}: {t}'s integer payload columns differ")
                x, y = (np.delete(v, np.r_[ints], axis=1) for v in (x, y))
            if x.dtype.kind in "iu":
                if not np.array_equal(x, y):
                    fail(f"{what}: {t} {col} differs between the runs")
            elif x.size:
                drift[f"{t}/{col}"] = float(np.abs(x - y).max())
                if not np.array_equal(_float_bits(x), _float_bits(y)):
                    differ.append(f"{t}/{col}")
    da, db = F.read_dense(a["path"]), F.read_dense(b["path"])
    dense = 0.0
    for i, (x, y) in enumerate(zip(da, db)):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind in "iu":
            if not np.array_equal(x, y):
                fail(f"{what}: an integer dense leaf differs")
        elif x.size:
            dense = max(dense, float(np.abs(x - y).max()))
            if not np.array_equal(_float_bits(x), _float_bits(y)):
                differ.append(f"dense leaf {i}")
    drift["dense"] = dense
    return drift, differ


def _float_bits(x):
    return np.ascontiguousarray(x).view(f"u{x.dtype.itemsize}")


def check_soak(dev, smi, tmp):
    """Phase 22: harness.soak on the device-index and the host-index
    engine, each twice with the same seeds. Each run: at least one growth,
    the failover losing no step, finite losses at every fence, tier rows
    on the device-index engine, and its first run's launches (K1, K2,
    K2's backward and K3a; K5 and K4 on the device-index engine). The two
    runs: the same integer trajectory and final saves bit-equal in every
    column, integer and float (:func:`soak_drift`; the float drift, 0, is
    printed).
    Returns the first runs' launches by path and the phase's numbers."""
    from deeprec_tpu_torch.harness import soak
    from deeprec_tpu_torch.utils import native
    if native.get_lib() is None:
        fail("soak: the C++ resolver cannot be built")
    counters = path_counters(index=True)
    need = {"device": ["gather_rows", "fused_pooled_lookup",
                       "fused_pooled_lookup_backward", "lookup_meta",
                       "hash_lookup_or_insert", "hash_lookup"],
            "host": ["gather_rows", "fused_pooled_lookup",
                     "fused_pooled_lookup_backward", "lookup_meta"]}
    ints = ("step", "capacity", "hbm_rows", "tier_rows", "saves", "event",
            "resumed_step", "steps_lost")
    paths, out, t_phase = {}, {}, time.perf_counter()
    for engine in ("device", "host"):
        runs = []
        for run in range(2):
            args = soak_args(dev, os.path.join(tmp, f"{engine}{run}"),
                             engine)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            summary, traj = soak.run(args)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            what = f"soak {engine}-index run {run}"
            losses = [r["loss"] for r in traj if "loss" in r]
            if not (summary["growth_events"] >= 1
                    and summary["failover_steps_lost"] == 0
                    and len(losses) == SOAK_FENCES
                    and np.isfinite(losses).all()
                    and np.isfinite([summary["train_auc"],
                                     summary["eval_auc"]]).all()
                    and (engine == "host"
                         or summary["tier_rows_final"] > 0)):
                fail(f"{what}: {summary}")
            for k in need[engine]:
                if launches[k] <= 0:
                    fail(f"{what}: {k} was not launched")
            log(f"{what}: {summary['steps']} steps of DCN at B={B}, ms per "
                f"step p50 {summary['ms_per_step_p50']} p90 "
                f"{summary['ms_per_step_p90']} p99 "
                f"{summary['ms_per_step_p99']} (host clock over each fence "
                f"window, card synchronized), last 10 / first 10 fences "
                f"{summary['ms_per_step_last10_over_first10']}, growths "
                f"{summary['growth_events']}, saves {summary['saves']}, "
                f"capacity {traj[0]['capacity']} -> "
                f"{summary['capacity_final']}, tier rows "
                f"{summary['tier_rows_final']}, failover steps lost "
                f"{summary['failover_steps_lost']}, health alarms "
                f"{summary['health_alarms']}, train auc "
                f"{summary['train_auc']}, eval auc {summary['eval_auc']}; "
                f"run {wall:.1f} s; launches {launches}; on {smi}")
            runs.append((args.ckpt_dir, summary, traj, launches, wall))
            torch.cuda.empty_cache()
            log(f"{what}: {torch.cuda.memory_allocated(dev) / 2**20:.1f} "
                f"MiB allocated on the card after the run (the failover "
                f"released the first trainer's memory, the run its last)")
        (ck0, s0, t0_, l0, w0), (ck1, s1, t1_, _, w1) = runs
        if [{k: r[k] for k in ints if k in r} for r in t0_] != \
                [{k: r[k] for k in ints if k in r} for r in t1_]:
            fail(f"soak {engine}-index: the two runs' integer trajectories "
                 "differ")
        drift, differ = soak_drift(ck0, ck1, f"soak {engine}-index")
        log(f"soak {engine}-index, two runs of one stream (ROADMAP C3): "
            f"final saves bit-equal in every integer column; largest float "
            f"|difference| {drift}; float columns whose bits differ: "
            f"{differ or 'none'}; on {smi}")
        if differ:
            fail(f"soak {engine}-index: the two runs' final saves differ in "
                 f"the float columns {differ}: a training step on the card "
                 f"must be a function of its inputs")
        paths[f"soak_{engine}"] = l0
        out[engine] = {"summary": s0, "repeat": s1, "launches": l0,
                       "wall_s": [w0, w1], "drift": drift,
                       "trajectory": t0_}
    log(f"soak phase {time.perf_counter() - t_phase:.1f} s")
    return paths, out


# -- phase 23: the fidelity bisect --------------------------------------------
def check_fidelity(dev, smi):
    """Phase 23: harness.sequence_fidelity's planted and random arms of
    DIN and DIEN (FIDELITY_B, FIDELITY_STEPS steps) beside
    harness.behavior_oracle's ceilings(): each planted arm's last eval AUC
    above bias_repeat and above its random arm's. Returns the curves and
    the ceilings."""
    from deeprec_tpu_torch.harness import sequence_fidelity as sf
    from deeprec_tpu_torch.harness.behavior_oracle import ceilings
    t0 = time.perf_counter()
    c = ceilings()
    log(f"fidelity: the behaviour stream's ceilings (50 batches of 4096, "
        f"numpy) {json.dumps({k: round(v, 4) for k, v in c.items()})} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"ceilings": c}
    for kind in ("din", "dien"):
        args = sf.parser().parse_args(
            ["--model", kind, "--steps", str(FIDELITY_STEPS), "--batch_size",
             str(FIDELITY_B), "--device", str(dev)])
        t0 = time.perf_counter()
        curves = sf.run(args, log=lambda line: None)["curves"]
        wall = time.perf_counter() - t0
        planted, random = curves["planted"][-1][1], curves["random"][-1][1]
        if not (np.isfinite([planted, random]).all()
                and planted > c["bias_repeat"] and planted > random):
            fail(f"fidelity {kind}: planted {curves['planted']} random "
                 f"{curves['random']} against bias_repeat "
                 f"{c['bias_repeat']:.4f}")
        log(f"fidelity {kind.upper()} at B={FIDELITY_B}: eval AUC (step, "
            f"auc) planted {curves['planted']}, random {curves['random']}; "
            f"ceilings bias_only {c['bias_only']:.4f}, bias_repeat "
            f"{c['bias_repeat']:.4f}, observable {c['observable']:.4f}, "
            f"bayes {c['bayes']:.4f}; both arms {wall:.1f} s "
            f"({wall / (2 * FIDELITY_STEPS) * 1e3:.1f} ms a step with the "
            f"evals, host clock); on {smi}")
        out[kind] = {"curves": curves, "wall_s": wall}
    return out


# -- phase 24: determinism --------------------------------------------------
def determinism_paths(dev):
    """``(name, trainer, state, args())`` of each one-card training path at
    full width, after DETERMINISM_WARM steps: bench.py's --metadata DLRM on
    the host-index engine, staged (one resolve, its wire reused) and
    pipelined (the pinned host wire through a HostStepPipeline's side-stream
    copy at each call); the device-index DLRM; the four variant tables;
    DIN and DIEN; the device-index DLRM as ``--mesh 1`` on a world-1 NCCL
    group (torn down after)."""
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    from deeprec_tpu_torch.train.pipeline import HostStepPipeline
    crit = list(SyntheticCriteo(batch_size=B, seed=7).take(
        DETERMINISM_WARM + 1))

    def trained(tr, batches):
        st = tr.init(batches[0])
        for b in batches[:-1]:
            st = tr.train_step(st, b)
        return st

    def warm(tr, batches):
        st = trained(tr, batches)
        args = tr.prepare_batch(batches[-1])  # one resolve
        return tr, st, lambda: args

    yield ("host-index staged", *warm(trainer(dev, True), crit))
    tr = trainer(dev, True)
    st = trained(tr, crit)
    host = tr.prepare_host(crit[-1], pin=True)
    with HostStepPipeline(lambda h: h, depth=3, device=dev) as pipe:
        def piped():
            pipe.feed(host)
            return pipe.take()
        yield "host-index pipelined", tr, st, piped
    yield ("device-index", *warm(device_trainer(dev), crit))
    for kind in VARIANT_KINDS:
        yield (f"variant {kind}", *warm(variant_trainer(kind, dev), crit))
    for kind in SEQ_MODELS:
        yield (kind, *warm(zoo_trainer(kind, dev),
                           zoo_batches(kind, 3, DETERMINISM_WARM + 1)))
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        yield ("mesh1", *warm(mesh_trainer(dev, make_mesh(1, device=dev)),
                              crit))
    finally:
        dist.destroy_process_group()


def check_determinism(dev, smi):
    """Phase 24: one step of each path of :func:`determinism_paths` run
    twice from one state and one batch (probes.step_bisect.bisect): every
    tensor the step makes (the pooled embeddings, each module's output,
    the rows' cotangents, every parameter's gradient, the updated tables,
    slot states, parameters, buffers, dense optimizer state and metrics)
    must be bit-equal between the two runs. Returns the tensors compared
    by path."""
    from deeprec_tpu_torch.probes.step_bisect import bisect
    t0, out = time.perf_counter(), {}
    for name, tr, state, args in determinism_paths(dev):
        diff, n, _ = bisect(tr, state, args)
        if diff is not None:
            fail(f"determinism: two runs of one {name} step first differ at "
                 f"{diff[0]} (max |d| {diff[1]:.3g})")
        out[name] = n
        log(f"determinism, {name}: two runs of one step from one state and "
            f"batch bit-equal in all {n} tensors it makes")
    log(f"determinism phase {time.perf_counter() - t0:.1f} s on {smi}")
    return out


def find_nondeterminism(dev):
    """``--find-nondeterminism``: on each path of :func:`determinism_paths`,
    the nondeterministic torch ops one step reaches
    (probes.step_bisect.finder, a finder only) and the first tensor whose
    bits differ between two runs of that step, one line each."""
    from deeprec_tpu_torch.probes.step_bisect import bisect, finder
    for name, tr, state, args in determinism_paths(dev):
        found = finder(tr, state, args())
        log(f"{name}: nondeterministic torch ops on the step: "
            f"{found or 'none'}")
        diff, n, _ = bisect(tr, state, args)
        log(f"{name}: two runs of one step, {n} tensors: "
            f"{'bit-equal' if diff is None else f'first differ at {diff}'}")


def run(dev, smi):
    """Phases 2-24 on ``dev``; returns the kernels' JSON entries and the
    training numbers."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import fused_pooled_lookup
    from deeprec_tpu_torch.ops.gather import gather_rows
    from deeprec_tpu_torch.ops.hash_probe import hash_lookup
    from deeprec_tpu_torch.ops import _build

    took = {}  # host seconds of each phase, printed at the end

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    kernels = []
    for check in (check_kernels, check_training_kernels, check_zoo_kernels,
                  check_seq_kernels, check_device_kernels,
                  check_variant_kernels, check_mesh_kernels,
                  check_hs_kernels, check_soak_kernels,
                  check_interaction_kernels, check_recurrence_kernels,
                  check_attention_kernels):
        kernels += timed(check.__name__, check, dev)

    _build.BUILD.mkdir(parents=True, exist_ok=True)  # git-ignored
    t_serving = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
        t0 = time.perf_counter()
        table = write_checkpoint(path)
        log(f"checkpoint: {table['keys'].shape[0]} keys x "
            f"{table['values'].shape[1]} f32 in a {CAPACITY}-slot table, "
            f"written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gpu = predictor(path, dev)
        log(f"{dev} predictor restored in {time.perf_counter() - t0:.1f} s")
        cpu = predictor(path, "cpu")

        held = list(SyntheticCriteo(batch_size=B, seed=11).take(5))
        serving = (gather_rows, fused_pooled_lookup, hash_lookup)
        for fn in serving:
            fn.launches = 0
        probs = [gpu.predict(b) for b in held]
        launches = {fn.__name__: fn.launches for fn in serving}
        log(f"serving path (5 predicts at B={B}) launches: {launches}")
        for k, v in launches.items():
            if v <= 0:
                fail(f"{k} was not launched on the serving path")
        coll = gpu.collections["emb"]
        aux, _ = coll.readonly_rows(gpu.tables["emb"],
                                    coll.pack_ids(held[0], dev))
        real = aux.ev_aux.uniq.ukeys != -1
        unseen = int((real & ~aux.ev_aux.admitted).sum())
        log(f"batch 0: {int(real.sum())} unique keys, {unseen} not in the "
            f"table (served their default rows)")
        if unseen == 0:
            fail("no unseen keys: the default-row path did not run")
        # K4 at the serving dedup, against the served table's index
        k4 = hash_case("lookup", "(serving dedup of a B=4096 batch)",
                       gpu.tables["emb"].index, aux.ev_aux.uniq.ukeys,
                       "serving", coll.config.max_probes)
        k4["path"] = "serving"
        kernels.append(k4)
        worst = 0.0
        for b, p in zip(held, probs):
            if p.shape != (B,) or not np.isfinite(p).all() or \
                    not ((p > 0) & (p < 1)).all():
                fail("card probabilities are not finite values in (0, 1)")
            worst = max(worst, float(np.abs(p - cpu.predict(b)).max()))
        if not worst <= PROB_ATOL:
            fail(f"card vs CPU probabilities differ by {worst}")
        log(f"card vs CPU predictor over 5 batches: max |dp| {worst:.3g} "
            f"(limit {PROB_ATOL}), p spread {float(np.std(probs)):.4f}")

        lat = []
        for _ in range(25):
            t0 = time.perf_counter()
            gpu.predict(held[0])  # ends in the D2H copy of the result
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(lat[5:])
        log(f"predict latency at B={B}: p50 {p50:.3f} ms (20 calls after 5 "
            f"warm-up, host clock) on {smi}")
        syncs = count_syncs(lambda: gpu.predict(held[0]))
        log(f"host syncs of one predict (device-index readonly_rows): "
            f"{dict(syncs)}")
        no_hash_syncs(syncs, "device-index predict")

        check_http(path, gpu, cpu, table, held[1])
        del gpu, cpu
    took["serving"] = round(time.perf_counter() - t_serving, 1)

    paths, training = timed("train", check_training, dev, smi)
    paths["serving"] = launches
    for name, check in (("loop", check_loop), ("tier", check_tier)):
        with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
            paths[name], training[name] = timed(name, check, dev, smi, path)
    for phase, kinds in (("zoo", ZOO_MODELS), ("seq", SEQ_MODELS)):
        with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
            phase_paths, training[phase] = timed(phase, check_models, dev,
                                                 smi, path, phase, kinds)
        paths.update(phase_paths)
    paths["optim"], training["optim"] = timed("optim", check_optimizers, dev,
                                              smi)
    training["bf16_forward"] = timed("bf16_forward", check_bf16_forward, dev)
    for name, check in (("cli", check_cli), ("device", check_device),
                        ("variants", check_variants),
                        ("migrate", check_migrate)):
        with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
            paths[name], training[name] = timed(name, check, dev, smi, path)
    paths["mesh1"], training["mesh1"] = timed("mesh1", check_mesh1, dev, smi)
    paths["hsmesh1"], training["hsmesh1"] = timed("hsmesh1", check_hsmesh1,
                                                  dev, smi)
    with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
        p, training["mesh4"] = timed("mesh4", check_mesh4, dev, smi, path)
        paths.update(p)
        p, mesh2 = timed("mesh2", check_mesh2, dev, smi, path,
                         os.path.join(path, "mesh4_ck"))
        paths.update(p)
        training.update(mesh2)
    with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
        p, training["soak"] = timed("soak", check_soak, dev, smi, path)
        paths.update(p)
    training["fidelity"] = timed("fidelity", check_fidelity, dev, smi)
    training["determinism"] = timed("determinism", check_determinism, dev,
                                    smi)
    log(f"host seconds by phase: {took}; {sum(took.values()):.1f} s in "
        f"all")
    for k in kernels:
        # launches on the slice's main path, --metadata (the bf16 rows: on
        # the bf16 table's, where every K2 launch is a bf16 one; a zoo or
        # sequence shape's: on the path of the model that gives it)
        name, main = k.pop("counter", k["name"]), k.pop("path",
                                                         "train_metadata")
        if name.endswith("_bf16"):
            name, main = name[:-len("_bf16")], "train_bf16"
        k["launches"] = paths[main].get(name, 0)
        k["launches_by_path"] = {p: c.get(name, 0)
                                 for p, c in paths.items()}
    return kernels, training


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs on "
                         "the card only")
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--mesh4-rank"]:  # one of phase 17's ranks
        mesh4_rank(sys.argv[3], int(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--mesh2-rank"]:  # one of phases 19-21's ranks
        mesh2_rank(sys.argv[3], int(sys.argv[2]))
        return
    # full f32 products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--find-nondeterminism"]:
        find_nondeterminism(torch.device("cuda"))
        return
    from deeprec_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built (nvcc sm_90a) and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    kernels, training = run(torch.device("cuda"), smi)
    log(json.dumps({"training": training, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
