#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --k6-times DIR   # only K6's times, K6 built from DIR
  python3 chip_smoke.py --k3bwd-times DIR   # K3-bwd from DIR and from here: bits, times
  python3 chip_smoke.py --scan-times DIR   # only phases 13 and 17, K4 built from DIR
  python3 chip_smoke.py --scan-bwd-times DIR   # K4-bwd from DIR and from here, in turns

It drives the port's paths, each with every kernel launch count set to 0
just before it and read just after: the Hemingway loop on the local SDCA
kernel (K1); the algorithm menu at the paper's workload (CoCoA and CoCoA+
on K1, local SGD on the local-SGD kernel K6, mini-batch SGD, GD and
L-BFGS); the §6 chaos loop (``python -m repro_torch.chaos_train``), its
SSP executor on K6; the kernel autotuner (``python -m repro_torch.kernels.tune``
and ``ensure`` at qwen3-14b's shapes), which times every kernel and is the
only caller of the contiguous flash decode kernel (K5); serving qwen3-14b at
full width through the continuous-batching engine on the flash forward (K3)
and paged decode (K2) kernels, its capacity planner seeded and K2 blocked
from the tuner's cache, then with chunked prefill (K3 over the page row from
a chunk's offset) and speculative decode (K2 over a folded verify batch),
each bit-identical to the one-token engine; serving falcon-mamba-7b at full
width through the same engine on the selective scan kernel (K4); and serving deepseek-v2-236b
(MLA attention, MoE FFNs) at full width and a cut depth through the same
engine on K3 with a value dim of 128 against a key dim of 192 (prefill) and
K2's MLA latent form (decode).  The deepseek-v2 path runs 6 of its 60 layers
(one dense head layer and five MoE layers, 21.25 B parameters, 42.5 GB of
bf16): at full depth its 471 GB of weights fit no single card, and at this
depth the card holds it alone once falcon-mamba-7b is freed.  Training runs
stablelm-1.6b, falcon-mamba-7b, deepseek-moe-16b, deepseek-v2-236b and
musicgen-medium (all 48 layers, after its 64 conditioning frames) at full
width; internvl2-76b serves at full width and 16 of its 80 layers, every
request with 256 patch embeddings; jamba's smoke period serves and trains;
qwen3-14b and falcon-mamba-7b serve at full width through the
prefix-affinity router over two replicas, one handed off to a fresh engine
mid-run, every span traced, and the telemetry CLI reads the run's log;
qwen3-14b serves tensor-parallel (``--tp 2``: two ranks on the one card,
each holding half of every layer's heads and channels) at full width, and
falcon-mamba-7b so at a cut depth; stablelm-1.6b trains with each gradient
compression scheme, and 2-way on a data mesh (FSDP over "data", two ranks
sharing the card) at full width and depth, its checkpoint moving between
data 2 and data 1, and the LM chaos loop drives the smoke trainer.
Phases, each of which exits non-zero on failure:

   1. device: requires a CUDA card and prints its name and power limit;
   2. build: compiles every kernel from the sources here, one nvcc each, all
      started together, and prints each library's nvcc seconds and what
      -Xptxas -v reports (registers, spills); fails if ptxas serialised any
      wgmma;
   3. K1 against its plain PyTorch version on the card, at the Hemingway
      loop's shapes (m = 16 and 7, both losses, H = 2 nl with repeats, and a
      whole m = 1 round of 60000 steps), within the stated tolerances; 3b.
      the plain version on the CPU against itself on the card where a
      step's sums are long (d 12224) or lam n small (0.06), printed;
   4. small-input check of the loop: CoCoA rounds on the card against the
      plain version on the CPU, with the same coordinate orders;
   5. K1's time per launch at m = 1, 16 and 128 against its bytes bound and
      its chain floor (H times one step's least dependent latency, timed on
      the library's chain probe: the step without its memory traffic), and
      its plain version's time;
   6. the Hemingway loop (repro_torch.quickstart) on the paper's workload,
      60000 x 784, m = 1..128, K1's launches checked against its rounds;
   7. device busy share of CoCoA rounds at m = 1, 16 and 128;
   7a. K6 against its plain version on the card: the paper's shapes (60000
      x 784, hinge, one local epoch at m 16 and 128 and a whole m = 1 round
      of 60000 steps) and the chaos run's (n 512, d 32, m 1 to 4, H 1 and 2,
      stale start vectors, t > 0, all three losses); the hinge bit for bit,
      or each differing worker explained by a gate tie, the others within
      the stated tolerance;
   7b. K6's plan at the paper's d (ring depth, shared memory; the library's
      ``local_sgd_plan`` equal to ``ops.kernel_plan``) and its copy route,
      its time per launch at m = 1, 16 and 128 against its bytes bound and
      its chain floor (the library's ``local_sgd_chain_launch``), its plain
      version's time at m = 16, its time per launch at the chaos run's
      shapes (eager and from a CUDA graph), and its step at m = 16 in parts
      (the library's ``local_sgd_probe_launch``: the ring refilled but never
      awaited, and pre-filled and never refilled);
   7c. the algorithm menu: ``BSPCluster.simulate`` at m = 16, 40 rounds, for
      CoCoA, CoCoA+, local SGD and mini-batch SGD on the hinge problem (Fig
      1c's set) and GD and L-BFGS on the smooth hinge at the same size, each
      algorithm's measured round, t_iter and final gap printed; K6's
      launches equal to local SGD's rounds and K1's to CoCoA's (warm-up and
      dispatch-floor rounds included);
   7d. a small-input check of the chaos loop (60 steps on the card against
      the CPU with the same draws), then ``python -m repro_torch.chaos_train
      --seed 0`` in process on the card: run and replay identical, K6's
      launches equal to the executor's outer steps;
   8. K3 and K2 against their plain versions on the card, in bf16, at
      qwen3-14b's shapes, within the stated tolerances: K3 at block_k 16
      (the engine's) and 64, with K and V NaN past kv_len in one case; K2
      also with NaN at every pool position past the rows' lengths, which must
      leave its output unchanged;
   8b. K3 at chunked prefill's shapes (query offsets 300, 517, 1000, none a
      multiple of 16, 256, 8 and 88 rows, over a gathered row of 1088
      positions stale past kv_len) against its plain version and bit for bit
      against the same rows of the monolithic call over 2048 rows; K2 over a
      verify fold of 32 rows (8 slots, k = 3, draft index major, padded rows
      of length 0 on the scratch page) against its plain version, each block
      of 8 rows bit for bit a decode-shaped call, at ppp 4, 8 and 16; K3's
      time at the chunked long run's last chunk, and K2's over the fold and
      over its first 8 rows alone (CUDA graph, L2 flushed);
   9. small-input check of the LM: the smoke qwen3-14b on the card against
      the plain versions on the CPU, with the same weights;
   9b. the autotuner, needing no model weights: (a) K3, K5 and K2 against
      their plain versions at every shape and config the tuner path times
      them at (the smoke preset's and qwen3-14b's), ``decode_attention_auto``
      equal to the direct K5 call bit for bit, and K5 also at qwen3-14b's
      grouped decode shape (G 5) and at lengths 0, 1, S and S not a multiple
      of block_k; (b) ``python -m repro_torch.kernels.tune --preset smoke
      --telemetry`` in process: all six families on the card, every kernel's
      launches equal to the sweep's calls, sdca picking the kernel, and K4
      bit-identical across every d_block (the tuner's knob) and chunk; (c) ``ensure`` at qwen3-14b's
      shapes into two cache files, the serve CLI's (paged decode at b 1, 2, 4)
      and the long run's, each winner with its wall-clock and device time;
  10. the serve path at full width: ``python -m repro_torch.launch.serve
      --arch qwen3-14b --continuous --tune-cache <the CLI's file>`` in process
      (all 40 layers, d_model 5120): 3 kernel rows seed the planner, K2 runs
      at the tuned pages_per_program, K3 launches = 40 x prefills and K2
      launches = 40 x decode steps;
  10b. the same CLI with ``--prefill-chunk 8 --speculate 3`` in process on
      phase 10's model: ``bit_identical=yes`` against its one-token replay,
      chunk steps and verify steps with accepted drafts (the document
      extension), K3 launches = 40 x (prefills + chunk steps), K2 launches
      = 40 x (decode steps + verify steps), verify steps at the tuned
      pages_per_program; chunk, decode and verify step times;
  11. a longer serve run at full width: 8 requests of 1024-token prompts
      arriving together, 64 tokens each, max_batch 8, paged decode at the
      long run's tuned pages_per_program (time to first token, decode step
      time, tokens/s, peak memory, a window of decode steps profiled for
      device activity only);
  11c. the chunked long run: the long run's prompts, 16 tokens each,
      through a plain engine and one at ``--prefill-chunk 256``: equal token
      streams, each engine's launches, TTFT p50, join to first token p50 and
      p99 in steps, the decode step while chunks stream, a chunk step
      against a monolithic block's prefill;
  11b. prefill over row blocks at full width: a short prompt's prefill
      padded to one block of 256, 512, 1024 rows and max_seq, against no
      padding; a 1024-token prompt in blocks of each size; and a two-block prompt
      that reuses a one-block prompt's pages, bit for bit against a cold
      engine;
  12. K3's, K2's and K5's times per launch against their bounds, their plain
      versions' times, and one PyTorch call's time for the same function (K3
      at block_k 16 and 64; K2 at pages_per_program 4, 8 and the tuned value,
      K5 at the tuner's shape and at qwen3-14b's grouped one, both and their
      PyTorch calls replayed from a CUDA graph with the L2 flushed before
      each call, since their eager calls are bound by the host's launch time
      and their K/V fits the L2; eager and warm-L2 times printed beside),
      with each launch's grid and shared memory; qwen3-14b is freed before
      this phase;
  13. K4 against its plain version on the card at falcon-mamba-7b's shapes:
      prefills (B 1, S 1024 with a padded tail and a nonzero initial state;
      S 1088, two tiles, padded; S 300, not a multiple of the tile; every
      state size 4, 8, 16, 32) and decode steps (B 8 and 1, S 1, the state
      updated in place), within the stated tolerances;
  14. small-input check of the Mamba LM: the smoke falcon-mamba-7b on the
      card against the plain versions on the CPU, with the same weights;
  15. the serve path at full width: ``python -m repro_torch.launch.serve
      --arch falcon-mamba-7b --continuous`` in process (all 64 layers,
      d_model 4096), with K4 launches = 64 x (prefills + decode steps);
  16. the longer serve run of phase 11 on falcon-mamba-7b;
  17. K4's time per launch at the prefill and the decode shape against its
      bound and its plain version's time (no single PyTorch call computes a
      selective scan), each body's device time from the profiler (over the
      launches it recorded) and from a CUDA graph; both rows in the kernels
      line;
  18. K2's latent form and K3 at (dk 192, dv 128) against their plain
      versions on the card, in bf16: K2 at deepseek-v2's decode shape (B 8,
      128 heads, r 512, dr 64, page 16, 68 pages) with ragged lengths, at
      lengths 0, 1, a full row and lengths that are no multiple of the
      blocking, and at its 192-position split boundaries and one past them,
      at every pages_per_program the tuner keeps (the kernel's bits the same
      at each: its tile is 64 positions whatever the value), the others
      refused by the wrapper as by the roofline; then at pages of 32 and of 8
      positions at the default pages_per_program; K3 at B 1, 128 heads,
      S 1024, causal, with kv_lens;
  18b. phase 8b's cases for K3 at (192, 128) and 128 heads and for
      K2-latent over a 32-row verify fold at deepseek-v2's widths;
  19. small-input check of the MLA + MoE LM: the smoke deepseek-v2 on the
      card (K3 at (24, 16), K2's latent form at (16, 8)) against the plain
      versions on the CPU, with the same weights;
  20. the serve path at full width and cut depth: the serve CLI's
      ``--continuous`` path in process with ``deepseek-v2-236b`` at 6 layers
      (d_model 5120, 128 heads, 160 experts top-6), with K3 launches = 6 x
      prefills and K2-latent launches = 6 x decode steps, the weights' bytes
      and the peak memory;
  20b. phase 10b on the cut deepseek-v2: ``bit_identical=yes``, K3 = 6 x
      (prefills + chunk steps), K2-latent = 6 x (decode steps + verify
      steps);
  21. the longer serve run of phase 11 on the cut deepseek-v2, its profiled
      decode steps split into K2's latent form, the MoE's expert products,
      the other GEMMs and the device's busy share;
  22. K2-latent's and K3 (192, 128)'s times per launch against their bounds,
      their plain versions' times and one PyTorch call's time
      (``scaled_dot_product_attention``): K2-latent at phase 18's ragged
      lengths and at full rows (8 x 1088, what the long run's steps see),
      both and their PyTorch calls replayed from a CUDA graph with the L2
      flushed before each call (eager and warm-L2 times printed beside), its
      split and merge kernels' device times from the profiler;
  10c. (slice 12) the serve CLI's static mode, ``Server.generate``, at full
      width on phase 10's qwen3-14b, batch 4, prompts of 16, 16 generated:
      prefill ms and decode tokens/s, K3 = 40 x prefills, K2 = 40 x decode
      steps;
  23a. K3 with the rows' log-sum-exp against its plain version at
      stablelm-1.6b's training shape (B 8, 32 heads, S 128, D 64) and
      qwen3-14b's (40 over 8 heads, S 2048, D 128), full and ragged kv_lens,
      and deepseek-moe-16b's (B 8, 16 heads, S 128, D 128): the output the
      same bits as without the lse;
  23b. K3-bwd (the flash backward's dq and dk/dv passes) against its plain
      version at the same shapes (G 1 and 5, ragged kv_lens), within the
      stated tolerance, two runs the same bits; the library's schedule
      (grids, the dk/dv pass's cut) against ops.bwd_grid, the CPU mirror;
      ptxas's registers and spills for both passes; each pass's time beside
      its bound, the plain backward's and SDPA's flash backward's, timed in
      turns with the kernel;
  23c. the training path: ``Trainer`` on stablelm-1.6b at full width (24
      layers), seq 128, global batch 8, AdamW at lr 1e-3, remat "full", 8
      steps: loss per step, median step ms, tokens/s, peak memory; K3
      launches = 2 x 24 x 8, each K3-bwd pass 24 x 8;
  23d. the smoke trainer 8 steps through the kernels on the card against the
      plain versions on the CPU, the same weights: losses within the stated
      tolerance;
  23e. a checkpoint round trip of the smoke trainer on the card: saved at step
      4, restored into a fresh ``Trainer``, steps 5-8 bit for bit;
  24a. (slice 14) K4 with its tile states (y and h the same bits as without,
      y, h and the states within phase 13's tolerance of the plain
      version's) and K4-bwd, the selective scan's backward, against its
      plain version at falcon-mamba-7b's training shape (B 8, S 128, Dn
      8192, N 16, bf16) and across tiles (B 1, S 1000), within the stated
      tolerance, two launches the same bits; its reduction alone against its
      plain version, bit for bit;
  24b. K4-bwd's time a call beside its bound and its plain version's, its
      plan (lanes, channels a block, clusters) and the card's occupancy
      (blocks an SM, registers), and its reduction's alone;
  24c. main path 7: ``Trainer`` on falcon-mamba-7b at full width, 8 of its 64
      layers, the settings of 23c: losses and grad norms finite, K4 = 2 x 8 x
      steps (full remat), K4-bwd's scan pass and its reduction 8 x steps
      each, no other kernel; peak memory and a profiled window;
  24d. main path 8: ``Trainer`` on deepseek-moe-16b at full width, its dense
      head layer and 2 MoE layers (64 routed experts top-6 at the training
      capacity, 2 shared): losses, aux (> 0) and grad norms finite, K3 = 2 x 3
      x steps, each K3-bwd pass 3 x steps, no other kernel; then one step's
      loss, aux and gradients taken twice, the same bits;
  24e. the smoke falcon-mamba and deepseek-moe trainers 8 steps on the card
      against the plain versions on the CPU, as 23d;
  26a. (slice 16) phase 23a also at deepseek-v2-236b's training shape (B 8,
      128 heads, S 128, DK 192, DV 128), full and ragged, and at the smoke
      deepseek-v2's (24, 16);
  26b. phase 23b at the same shapes and at a key side cut in 4 at DK 192 (B
      1, 4 heads, S 2048): K3-bwd at (192, 128) is the dq pass, the dv pass
      and the dk pass, at (24, 16) the dq and the dk/dv pass, each launch
      counted; ptxas's lines and the card's occupancy for every pair and
      launch; each launch's time (CUDA events; CUDA graph) beside its bound
      and the whole backward's, the plain backward's and SDPA's backward in
      turns, with the backends SDPA can take at dk != dv and the kernels its
      dispatch launches;
  26c. main path 9: ``Trainer`` on deepseek-v2-236b at full width, its dense
      head layer alone (1 of 60: MLA at 128 heads of (192, 128), the dense FFN
      of 12,288), the settings of 23c: losses and grad norms finite, aux 0 (no
      MoE layer runs), K3 = 2 x 1 x steps, K3-bwd's dq, dv and dk passes 1 x
      steps each, no other kernel, peak memory; then one step's loss and
      gradients taken twice, the same bits;
  26d. the smoke deepseek-v2 trainer (MLA at (24, 16), MoE layers) 8 steps on
      the card against the plain versions on the CPU, as 23d;
  27a. (slice 17, every arch of the catalog) phase 9 for qwen1.5-110b,
      qwen3-32b, jamba (its bf16 top-2 routing can flip at near ties between
      the card and the CPU: the CPU's MoE takes the card's experts where they
      differ, each such row a near tie or the phase fails, the count
      printed; float32 is no option, K3 takes bf16 only), internvl2-76b and
      musicgen-medium (their prompts after 8 frontend embeddings); phase 8's
      K3 and K2 cases at internvl2-76b's heads (64 over 8, D 128) and
      musicgen-medium's (24 of MHA, D 64); 23a and 23b also at
      musicgen-medium's training rows (B 8, 24 heads, S 192 = 64 frames +
      128 tokens), timed;
  27b. the contiguous cache's ``decode_step`` teacher-forced on the card
      through every smoke arch (the frontend's positions first, through
      ``frontend_embed``) against one prefill of the row, within the
      reference test's atol 0.1, rtol 0.05, the MoE at capacity_factor 100;
      then musicgen-medium at full width, 64 frames + 8 tokens;
  27c. main path 10: ``Trainer`` on musicgen-medium at full width and depth
      (48 layers, d_model 1536, 24 heads), seq 128 after 64 conditioning
      frames (the pipeline's synthetic embeddings), the settings of 23c:
      losses and grad norms finite, aux 0, K3 = 2 x 48 x steps, K3-bwd's dq
      and dk/dv passes 48 x steps each, no other kernel; peak memory and a
      profiled window; then the 8 steps again from the same seed with K3 and
      K3-bwd swapped for their plain versions on the card, each loss within
      1% of the kernels';
  27d. main path 11: internvl2-76b at full width, 16 of its 80 layers, every
      request with 256 patch embeddings: ``ServeEngine`` over the CLI's
      8-request trace (max_batch 4, max_seq 1024: patches and prompt in one
      1024-row prefill block), 8/8, K3 = 16 x prefills, K2 = 16 x decode
      steps; the trace again on a cold engine sharing the weights, the same
      tokens; ``Server.generate`` at batch 4, 16 tokens, 16 generated; TTFT,
      decode step, tokens/s, peak memory; then K3 at its prefill block and
      K2 at its decode step timed beside their bounds, plain versions and
      SDPA;
  27e. jamba's smoke period on the card: the serve CLI's ``--continuous``
      path (8/8, ``bit_identical=yes``; K3 and K2 once an attention layer a
      prefill or decode step, K4 once a Mamba layer), the smoke trainer card
      vs CPU through K3, K3-bwd, K4 and K4-bwd (each counted by the layers of
      its mixer's kind), one step's gradient twice the same bits;
  27f. the smoke internvl2-76b and musicgen-medium trainers card vs CPU, as
      23d, and a checkpoint round trip of musicgen-medium's, as 23e;
  28a. (slice 18) main path 12, on phase 10's qwen3-14b before it is freed:
      ``python -m repro_torch.launch.serve --arch qwen3-14b --continuous
      --router --replicas 2 --migrate-at 3 --trace F --router-log G
      --tune-cache <the CLI's file>`` in process: 8/8 served by the single
      engine and the fleet, ``routed fleet vs single engine:
      bit_identical=yes``, a handoff with requests in flight, the trace
      file's schema valid, the spans' decode time within 5% of the engines'
      step times, prefix reuse ``bit_identical=yes``, K3 = 40 x prefills and
      K2 = 40 x decode steps of the five engines the run built (the single
      and cold engines, two replicas, the replaced one and its destination),
      no other kernel; each replica's decode step median and tokens/s, the
      handoff's ms (and its parts) and MB, the span count, the attribution
      table, the peak memory; then the same CLI without ``--trace`` and with
      ``--trace --trace-clock steps`` in turns (off, on, on, off), each run
      gated as above, the decode step's median printed for each, the two
      step-clock trace files byte for byte the same;
  28b. the same router CLI on phase 15's falcon-mamba-7b (K4 = 64 x
      (prefills + decode steps), its decode body 64 x decode steps, of the
      five engines); then an engine-level handoff on the card with a
      request in flight: the Mamba layers' slot-major state and the
      full-prompt entry's state the same bits on the destination, the page
      tables mirrored, the stored prompt served again from its entry on
      both with the same tokens, restore launching no kernel;
  28c. ``python -m repro_torch.telemetry summarize G --strict`` (exit 0,
      per-replica lines) and ``trace G --perfetto OUT --flame --tune-cache
      <the CLI's file> --n-layers 40`` (exit 0, ``kernel/flash_decode_paged@b``
      rows) in process on 28a's log; ``monitor_serve_events`` over its
      serve_step rows with the per-token objective at 1.5 x their median
      per-token latency: the alert count as they are, and at least one
      alert, kept by ``CapacityPlanner.ingest``, with every step time
      doubled from the midpoint;
  29a. (slice 19) on phase 10's qwen3-14b before it is freed: the CLI's
      trace through one unsharded engine, every step's logits kept;
  29b. a one-rank NCCL group and a (1, 1) mesh in this process: the trace
      through ``ServeEngine(lm=..., mesh=...)``, phase 10's model itself,
      every token and every step's logits bit for bit 29a's, K3 and K2 once
      a layer a prefill and a decode step;
  29c. the model freed, main path 13: ``python -m repro_torch.launch.serve
      --arch qwen3-14b --continuous --tp 2 --router --replicas 2
      --tune-cache <the CLI's file>`` in process: two ranks spawned on the
      card (gloo: they share it), each drawing its half of phase 10's
      weights from seed 0, the CLI returning every rank's report; the CLI's
      gates (``bit_identical=yes`` for the fleet against a single 2-way
      engine and for the prefix reuse, the ranks' streams the same), the
      ranks' tokens and logits the same bits, and on each rank K3 = 40 x
      prefills and K2 = 40 x decode steps of its 4 engines, no other kernel
      (none in this process); each request's logits at every step up to and
      with its first token that differs from 29a's within phase 9's bf16
      bounds of 29a's, the count of equal token streams printed (a bf16 near
      tie may flip one), each rank's decode step median and peak memory;
  29d. main path 13b, after phase 16's model is freed: falcon-mamba-7b at 8
      of its 64 layers from seed 0 through one unsharded engine on the card
      (29a's trace), freed, then the same CLI on that config (K4 = 8 x
      (prefills + decode steps) on each rank, its decode body 8 x decode
      steps), held against that engine as 29c against 29a.
  29e. K3 and K2 against their plain versions at a rank's heads (phases 8
      and 8b at qwen3-14b's local config, 20 query heads over 4 KV heads)
      and K4 at a rank's channels (phase 13 at Dn 4096), the local configs
      ``ShardingPlan.local_config``'s, the errors folded into the kernels
      line; then each timed once there (half the heads or channels of
      phases 12 and 17's shapes), beside its bound: the kernels unchanged,
      their rows in the kernels line gain the numbers ``..._at main path
      13``.
  30a. (slice 20) main path 14a: ``python -m repro_torch.launch.train --arch
      stablelm-1.6b --steps 4 --seq-len 128 --global-batch 8 --compression S``
      in process for S in int8, topk and powersgd, at full width and depth:
      losses and grad norms finite, K3 = 2 x 24 x 4 and each K3-bwd pass
      24 x 4, nothing else; step times and peak memory printed;
  30b. the smoke trainer with each scheme on the card against the plain
      versions on the CPU, each step's loss within 1%;
  30c. main path 14: stablelm-1.6b at full width and depth, 4 steps on one
      card (freed), then on a world-size-1 NCCL group's (1, 1) mesh in this
      process, bit for bit (losses, grad norms, the final state's bits), then
      on a (2, 1) data mesh: two ranks on the one card over gloo
      (``run_data_parallel``), each holding half of every float32 master and
      AdamW leaf (FSDP over "data") and training on its 4 rows of the global
      batch of 8: each step's loss within 0.5% of the single card's, K3 =
      2 x 24 x 4 and each K3-bwd pass 24 x 4 on each rank, none in this
      process, a rank's float32 state 49-52% of the single card's; each
      rank's step times and peak memory printed;
  30d. the elastic leg at full width and 4 of 24 layers: a checkpoint at
      data 2 (whole leaves, gathered), restored at data 1 (``restore``,
      ``rescale_training_state`` on a (1, 1) NCCL mesh) and again at data 2
      (``restore_sharded`` on two new ranks): the placed state the saved bits
      each time (``Trainer.state_digest``), the next step's loss within 0.5%
      of the unresized run's, the save's and restores' wall times printed;
  30e. the LM chaos loop on the smoke stablelm-1.6b: ``python -m
      repro_torch.launch.train --chaos TRACE --steps 30`` on a generated
      trace, and ``run_chaos_lm`` on the reference test's crafted 70-step
      trace with its gates (a resize, a mitigation, a restore, the last loss
      below the first by 0.5); K3 and K3-bwd once a layer an executed step.
The last lines are one JSON object with every kernel's summary (its
``timed_by`` says how ``ms`` and ``library_ms`` were timed; K3's, K2's,
K2-latent's and K4's ``launches`` sum their paths', ``launches_by_path``
(``serve_router``: main path 12's run, or 28b's for K4; ``serve_tp``: main
path 13's, or 13b's for K4, summed over its two ranks); K6's row,
``local_sgd``, replaces the reference's compiled ``lax.scan``, no Pallas
kernel, and counts its launches on the menu and chaos paths; K4's decode body
has a row of its own, ``selective_scan_step``, K3 at (192, 128) one,
``flash_fwd_mla``, and K2-latent at full rows one,
``paged_latent_decode_full``; K3-bwd's launches, ``flash_bwd_dq``,
``flash_bwd_dkdv`` and, at MLA's (192, 128), ``flash_bwd_dv`` and
``flash_bwd_dk``, replace the reference's custom-VJP backward, no Pallas
kernel, and count their launches on the training paths; K4-bwd's scan
pass, ``selective_scan_bwd``, and its reduction,
``selective_scan_bwd_reduce``, replace the reference's autodiff of its
chunked scan, no Pallas kernel, and count their launches on the Mamba
training path), the card's ``nvidia-smi`` line,
and ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM3 rate, float32 rate outside the tensor
# cores, and the dense bf16 tensor-core rate, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# Quickstart's rounds (repro_torch.quickstart.SIM_ITERS / REF_ITERS) as run here.
SIM_ITERS = 40
REF_ITERS = 150

# Kernel vs plain, for one call from the same inputs.  The two differ only in
# the order of each step's two float32 sums, and thousands of dependent steps
# compound that.  On an H100 the difference measured about 1e-6 in both a and
# dw (max |dw| about 1); the limits leave ten times that.
DW_RTOL_OF_MAX = 1e-5   # max |dw_kernel - dw_plain| <= 1e-5 * max |dw_plain|
A_ATOL = 1e-5           # max |a_kernel - a_plain|
PRIMAL_RTOL = 1e-5      # P(w + combined dw), kernel vs plain
CURVE_RTOL = 1e-4       # objective curves of the small-input check

# K2 and K3 against their plain versions on the card, which run float32
# arithmetic on bf16 inputs.  K2 does the same in another order and merges a
# long row's splits in float32; K3 multiplies on the tensor cores, where a
# product of two bf16 values is exact and the sums are float32, and carries p
# as two bf16 values (p_hi + p_lo, within 2^-17 of p) into float32 sums.
# Both round the output to bf16 once.  The float32 difference can move that
# rounding by one step (one bf16 ulp of the output), and it is itself an
# absolute error of the order of float32's epsilon times the summands, which
# are p_j v_j with the p_j summing to 1: for n keys about sqrt(n) * 1.2e-7 *
# max|v| (3.8e-6 max|v| at n = 1024), and the p split adds at most 2^-17
# max|v| (7.6e-6).  Where a row's output is near 0 by cancellation, that is
# several ulps of the output itself (5 measured at Sq = 1024 on an H100).  So
# the limit is one bf16 ulp of the output plus 2^-14 (6.1e-5) of max|v|, over
# five times the estimate; a fault of the kernel shows as errors of order
# max|v|.
MAX_BF16_ULPS = 1
V_ATOL_OF_MAX = 2.0 ** -14
# The smoke LM on the card against the plain versions on the CPU, same
# weights: both round every activation to bf16, cuBLAS and the CPU's library
# sum the products in other orders, so single activations differ by bf16
# steps (2^-8 relative) that the residual stream carries on.  The port against
# the JAX package on the CPU measured max 1.0% and mean 0.2% of the largest
# logit (tests/test_torch_lm.py); the same limits as there: 3% and 0.5%.
LM_MAX_OF_SCALE = 3e-2
LM_MEAN_OF_SCALE = 5e-3

# K4 against its plain version on the card: the same float32 operations in
# the same order, except that the two exp functions may differ in the last
# bit or two.  Such a difference enters the state once per step and decays
# with it, so over a channel whose decay is close to 1 (dt |A| of 1e-3
# remembers about 1000 steps) it adds up like a random walk, to about
# sqrt(1000) float32 epsilons, 4e-6 of the state's magnitude.  So the state
# within 2^-13 (1.2e-4) of its largest magnitude, thirty times that, and the
# bf16 outputs within one bf16 ulp (one rounding of a float32 value that
# moved) plus 2^-13 of the largest output; a fault of the kernel shows as
# errors of the order of the values.
SCAN_RTOL_OF_MAX = 2.0 ** -13
# Exponentials: the special-function units return 16 a clock per SM (132 SMs
# at the H100 SXM's 1.98 GHz boost clock), the rate one expf costs.
EXP_PER_S = 132 * 16 * 1.98e9

# The serve paths: the arch, and each kernel's launches per layer for one
# prefill and for one decode step
QWEN = "qwen3-14b"
MAMBA = "falcon-mamba-7b"
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_LAYERS = 6  # one dense head layer and five MoE layers of the 60
PATH_KERNELS = {QWEN: {"flash_fwd": (1, 0), "paged_decode": (0, 1)},
                MAMBA: {"selective_scan": (1, 1)},
                DEEPSEEK: {"flash_fwd": (1, 0), "paged_latent_decode": (0, 1)},
                "internvl2-76b": {"flash_fwd": (1, 0), "paged_decode": (0, 1)}}
LONG_PROMPT, LONG_GEN, LONG_BATCH = 1024, 64, 8

# The autotuner: timed calls per candidate (one warm-up is added), and the
# qwen3-14b shapes it is asked for.  The serve CLI runs max_batch 4 and
# max_seq 96 (6 pages of 16); the long run max_batch 8 and 1088 positions.
TUNE_ITERS = 5
CLI_DECODE_BATCHES = (1, 2, 4)
CLI_PAGES, LONG_PAGES = 6, (LONG_PROMPT + LONG_GEN) // 16
# The families whose kernels phase 9b (a) holds against their plain versions
# at the tuner's shapes, each kernel's by name
TUNED_KERNELS = {"flash_attention": "flash_fwd", "flash_decode": "flash_decode",
                 "flash_decode_paged": "paged_decode"}
# K2's row of the kernels line is timed at the reference's default blocking,
# a fixed yardstick (the tuned value, which host noise can pick, is printed
# beside it)
K2_ROW_PAGES_PER_PROGRAM = 4
# Also timed in phase 12: groups of 128 positions, one a split, one staged
K2_ONE_TILE_PAGES_PER_PROGRAM = 8


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def kernel_wrappers():
    """Every kernel's wrapper, by kernel name; each counts its launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.local_sgd import ops as local_sgd_ops
    from repro_torch.kernels.sdca import ops as sdca_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    return {"local_sdca": sdca_ops.local_sdca, "flash_fwd": fa_ops.flash_fwd,
            "paged_decode": fd_ops.paged_decode, "selective_scan": ss_ops.selective_scan,
            "flash_decode": fd_ops.flash_decode,
            "paged_latent_decode": fd_ops.paged_latent_decode,
            "local_sgd": local_sgd_ops.local_sgd, "flash_bwd_dq": fa_ops.flash_bwd_dq,
            "flash_bwd_dkdv": fa_ops.flash_bwd_dkdv, "flash_bwd_dv": fa_ops.flash_bwd_dv,
            "flash_bwd_dk": fa_ops.flash_bwd_dk,
            "selective_scan_bwd": ss_ops.selective_scan_bwd,
            "selective_scan_bwd_reduce": ss_ops.selective_scan_bwd_reduce}


def reset_launches() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    kernel_wrappers()["selective_scan"].step_launches = 0  # K4's decode body


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}


def check_path_launches(arch: str, counts: dict, n_layers: int, prefills: int,
                        steps: int, what: str) -> None:
    """Each of the path's kernels launched once a layer per prefill and/or
    decode step, as ``PATH_KERNELS`` says, and no other kernel at all."""
    expected = {name: 0 for name in counts}
    for name, (per_prefill, per_step) in PATH_KERNELS[arch].items():
        expected[name] = n_layers * (per_prefill * prefills + per_step * steps)
    if counts != expected or not all(counts[k] for k in PATH_KERNELS[arch]):
        fail(f"{what}: launches {counts}, expected {expected}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sdca_bytes_and_flops(m, nl, d, idx):
    """Least traffic of one local_sdca call: every X row the orders touch,
    y, a, w and idx read once; a and dw written once.  Operations: each step
    two length-d dot products and a length-d axpy with a division."""
    rows = sum(int(row.unique().numel()) for row in idx)
    h = idx.shape[1]
    nbytes = 4 * (rows * d + 3 * m * nl + d + m * h + m * d)
    flops = m * h * 7 * d
    return nbytes, flops


def step_floor_us(kernel: str, d: int, launch, h: int = 60000) -> float:
    """A chain kernel's floor a step, in us: its library's chain probe (the
    register path's step at width d without its memory traffic) over h
    steps, timed by CUDA events.  ``launch(h, out_ptr, stream)`` launches
    the probe and returns its error code."""
    import torch

    out = torch.empty(1, device="cuda")

    def run():
        err = launch(h, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"{kernel}'s chain probe failed with error {err}")

    ms = cuda_ms(run, reps=3, warmup=1)
    if not bool(torch.isfinite(out).all()):
        fail(f"{kernel}'s chain probe's result is not finite")
    print(f"chain floor: {kernel}'s dependent chain at d {d} without memory traffic "
          f"{1e3 * ms / h:.4f} us a step (one warp, {h} steps, CUDA events)")
    return 1e3 * ms / h


def bf16_ulps(got, want, atol: float = 0.0) -> float:
    """Largest difference, less ``atol``, in units of the bf16 spacing at the
    larger of the two magnitudes, 2 ** (floor(log2 |x|) - 7)."""
    import torch

    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((((got - want).abs() - atol).clamp_min(0) / ulp).max())


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# How a kernels-line row was timed ("timed_by"): K2's, K2-latent's and K5's
# rows and their PyTorch calls by GRAPH_COLD_L2, every other row by EAGER.
EAGER = "CUDA events over calls back to back"
GRAPH_COLD_L2 = ("CUDA graph of the calls, the L2 flushed before each by a read of "
                 "256 MB, the reads' own graph time taken off")
FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def graph_ms(fn, reps: int, warmup: int = 3, flush=None) -> float:
    """Mean ms per call of ``fn`` replayed from one CUDA graph of ``reps``
    calls, timed by CUDA events: the device's time for the calls' kernels and
    the gaps between them, without the host's time to launch them.  A decode
    kernel's wrapper takes longer on the host than its kernels on the device,
    so back-to-back eager calls time the host.  Calls back to back find their
    inputs in the L2 when these fit there (K2's 36 MB pool does), so with
    ``flush``, a float32 tensor of FLUSH_BYTES, each call follows a read of
    all of it, as in the engine, where each layer reads its own pool; a graph
    of the reads alone is replayed in turn with it, and the medians' gap over
    three replays each is the calls' time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def capture(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()  # warm-up
        return graph

    def replay_ms(graph):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    if flush is None:
        return replay_ms(capture(fn)) / reps
    both = capture(lambda: (flush.sum(), fn()))
    reads = capture(flush.sum)
    pairs = [(replay_ms(both), replay_ms(reads)) for _ in range(3)]
    return (sorted(b for b, _ in pairs)[1] - sorted(r for _, r in pairs)[1]) / reps


def build_all(libraries) -> dict:
    """One nvcc per source, all started together.  Returns each library's
    build (``KernelLibrary.build``) by its stem."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        results = list(pool.map(lambda lib: lib.build(), libraries))
    print(f"built {len(libraries)} libraries in {time.perf_counter() - t0:.1f} s (in parallel)")
    for lib, built in zip(libraries, results):
        print(f"{lib.source.name}: nvcc {built['seconds']:.1f} s -> {built['path']}")
        entry = ""
        for line in built["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  ptxas: {entry[:60]}: {line.strip()}")
        if "Performance Loss: wgmma" in built["log"]:
            fail(f"{lib.source.name}: ptxas serialised wgmma instructions (C7520): a branch "
                 "the compiler cannot prove warpgroup-uniform encloses a wgmma")
        lib.load()
    return {lib.stem: built for lib, built in zip(libraries, results)}


def plain_across_devices(dev, lam, gen) -> None:
    """Phase 3b: how far the plain version on the CPU is from itself on the
    card after one round where a step's sums are long or lam n is small, the
    cases the card tests run at a larger lam n (tests/test_torch_sdca_gpu.py);
    beside it the kernel's distance from the plain version on the card."""
    import torch

    from repro_torch.kernels.sdca import ops
    from repro_torch.kernels.sdca.ref import local_sdca_ref
    from repro_torch.optim.cocoa import draw_indices, partition
    from repro_torch.optim.problems import synthetic_mnist

    phase("K1: the plain version on the CPU against itself on the card, long sums")
    for m, n, d in ((2, 600, 2048), (1, 8000, ops.MAX_D)):
        X, y = synthetic_mnist(n, d, 16, 0.09, 0.35, m)
        Xs, ys = partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)
        a = torch.rand((m, Xs.shape[1]), generator=gen, device=dev)
        w = 0.01 * torch.randn(d, generator=gen, device=dev)
        idx = draw_indices(m, Xs.shape[1], Xs.shape[1], gen)
        _, dwk = ops.local_sdca(Xs, ys, a, w, idx, 1.0, lam, float(n))
        _, dwp = local_sdca_ref(Xs, ys, a, w, idx, 1.0, lam, float(n))
        _, dwc = local_sdca_ref(*(t.cpu() for t in (Xs, ys, a, w, idx)), 1.0, lam, float(n))
        scale = float(dwp.abs().max())
        print(f"m={m} n={n} d={d} lam n={lam * n:g}: max|dw| {scale:.3e}; max|ddw| / max|dw|: "
              f"plain (cpu) vs plain (card) {float((dwc - dwp.cpu()).abs().max()) / scale:.2e}, "
              f"kernel vs plain (card) {float((dwk - dwp).abs().max()) / scale:.2e}")


def hemingway_path(dev):
    """Phases 3-7: K1 and the Hemingway loop.  Returns K1's summary, the
    paper's problem on the card and its P*."""
    import torch

    from repro_torch import quickstart
    from repro_torch.convert import problem_from_numpy
    from repro_torch.kernels.sdca import build, ops
    from repro_torch.kernels.sdca.ref import local_sdca_ref
    from repro_torch.optim import CocoaConfig, make_mnist_svm, run_cocoa
    from repro_torch.optim.cocoa import draw_indices, partition
    from repro_torch.optim.problems import synthetic_mnist

    phase("K1 kernel vs plain (60000 x 784 shards)")
    problem = make_mnist_svm(device=dev)
    lam, n = problem.lam, float(problem.n)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # name, m, loss, plus, H as a multiple of nl
        ("hinge m=16", 16, "hinge", False, 1),
        ("smooth_hinge m=16 cocoa+", 16, "smooth_hinge", True, 1),
        ("hinge m=7 padded tail", 7, "hinge", False, 1),
        ("hinge m=16 H=2nl repeats", 16, "hinge", False, 2),
        ("hinge m=1 whole round", 1, "hinge", False, 1),
    ]
    max_err = 0.0
    inputs_16 = None
    for name, m, loss, plus, hf in cases:
        Xs, ys = partition(problem.X, problem.y, m)
        nl = Xs.shape[1]
        a = torch.zeros((m, nl), device=dev)
        w = torch.zeros(problem.d, device=dev)
        idx = draw_indices(m, nl, hf * nl, gen)
        sp = float(m) if plus else 1.0
        ak, dwk = ops.local_sdca(Xs, ys, a, w, idx, sp, lam, n, loss)
        torch.cuda.synchronize()
        ap, dwp = local_sdca_ref(Xs, ys, a, w, idx, sp, lam, n, loss)
        err_a = float((ak - ap).abs().max())
        err_dw = float((dwk - dwp).abs().max())
        scale_dw = float(dwp.abs().max())
        combine = (lambda dw: dw.sum(0)) if plus else (lambda dw: dw.mean(0))
        pk, pp = float(problem.primal(w + combine(dwk))), float(problem.primal(w + combine(dwp)))
        print(f"{name:28s} nl={nl} H={idx.shape[1]}: max|da|={err_a:.3e} "
              f"max|ddw|={err_dw:.3e} (max|dw|={scale_dw:.3e}) "
              f"primal {pk:.7f} vs {pp:.7f}")
        if not (torch.isfinite(ak).all() and torch.isfinite(dwk).all()):
            fail(f"{name}: kernel output is not finite")
        if m * nl > problem.n and not torch.equal(ak.reshape(-1)[problem.n:],
                                                   a.reshape(-1)[problem.n:]):
            fail(f"{name}: padded rows changed")
        if err_a > A_ATOL or err_dw > DW_RTOL_OF_MAX * scale_dw:
            fail(f"{name}: kernel disagrees with the plain version")
        if abs(pk - pp) > PRIMAL_RTOL * abs(pp):
            fail(f"{name}: primal after the call disagrees ({pk} vs {pp})")
        max_err = max(max_err, err_a, err_dw)
        if inputs_16 is None:
            inputs_16 = (Xs, ys, a, w, idx, sp, loss)
    print(f"tolerances: |da| <= {A_ATOL}, |ddw| <= {DW_RTOL_OF_MAX} max|dw|, "
          f"primal rtol {PRIMAL_RTOL}")
    plain_across_devices(dev, lam, gen)

    phase("small-input check: CoCoA on the card vs the plain version on the CPU")
    X, y = synthetic_mnist(2048, 64, 16, 0.09, 0.35, 0)
    for plus in (False, True):
        cfg = CocoaConfig(4, 5, plus=plus)
        orders = [draw_indices(4, 512, 512, torch.Generator().manual_seed(r)) for r in range(5)]
        recs = [run_cocoa(problem_from_numpy(X, y, 1e-3, device=d), cfg,
                          indices=lambda it: orders[it]) for d in ("cuda", "cpu")]
        for key in ("primal", "dual"):
            got, want = getattr(recs[0], key), getattr(recs[1], key)
            if got.shape != (5,) or not abs(got - want).max() <= CURVE_RTOL * abs(want).max():
                fail(f"small-input {key} curve (plus={plus}): card {got} vs cpu {want}")
        print(f"plus={plus}: primal {recs[0].primal[-1]:.7f} (card) vs "
              f"{recs[1].primal[-1]:.7f} (cpu), gap {recs[0].gap[-1]:.3e}")

    phase("K1 timings (m = 1, 16 and 128, CUDA events, after warm-up)")
    Xs, ys, a, w, idx, sp, loss = inputs_16
    m, nl, d = Xs.shape
    t0 = time.perf_counter()
    local_sdca_ref(Xs, ys, a, w, idx, sp, lam, n, loss)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    floor_us = step_floor_us("K1", problem.d, lambda h, out, stream: build.load(
        ).sdca_chain_launch(problem.d, h, lam * n, out, stream))
    by_m = {}
    for mm in (1, 16, 128):
        Xm, ym = partition(problem.X, problem.y, mm)
        nlm = Xm.shape[1]
        am, wm = torch.zeros((mm, nlm), device=dev), torch.zeros(problem.d, device=dev)
        idm = draw_indices(mm, nlm, nlm, gen)
        ms = cuda_ms(lambda: ops.local_sdca(Xm, ym, am, wm, idm, 1.0, lam, n, "hinge"),
                     reps=max(5, mm // 4), warmup=2)
        nbytes, flops = sdca_bytes_and_flops(mm, nlm, problem.d, idm)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        chain_ms = nlm * floor_us / 1e3
        by_m[mm] = {"ms": ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "chain_floor_ms": chain_ms, "h": nlm}
        print(f"local_sdca m={mm} nl={nlm} d={problem.d} H={nlm}: kernel {ms:.3f} ms/launch "
              f"({1e3 * ms / nlm:.4f} us a step), bound {by_m[mm]['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
              f"{ops_ms:.4f} ms), kernel at {100 * by_m[mm]['bound_ms'] / ms:.2f}% of bound; "
              f"chain floor {chain_ms:.3f} ms (H x {floor_us:.4f} us), kernel at "
              f"{100 * chain_ms / ms:.1f}% of it")
    kernel_ms, bound_ms = by_m[16]["ms"], by_m[16]["bound_ms"]
    print(f"plain version at m=16: {plain_ms:.1f} ms/call; no single PyTorch call computes this")

    phase("main path 1: Hemingway loop, 60000 x 784, m = 1..128")
    ms = (1, 2, 4, 8, 16, 32, 64, 128)
    for name, ours, default in (("CoCoA rounds per m", SIM_ITERS, quickstart.SIM_ITERS),
                                ("P* rounds", REF_ITERS, quickstart.REF_ITERS)):
        if ours != default:
            print(f"cut: {name} {default} -> {ours} (n, d and m are not cut)")
    reset_launches()
    result = quickstart.run(ms=ms, iters=SIM_ITERS, ref_iters=REF_ITERS, device=dev)
    counts = read_launches()
    launches = counts.pop("local_sdca")
    if any(counts.values()):
        fail(f"the Hemingway loop launched a serve kernel: {counts}")
    # P*, then per m a warm-up round, the timed rounds, and the dispatch
    # floor's warm-up and three timed rounds
    rounds = REF_ITERS + sum(1 + SIM_ITERS + 1 + 3 for _ in ms)
    print(f"local_sdca launches {launches}, CoCoA rounds run {rounds}")
    if launches != rounds:
        fail(f"launch count {launches} != rounds run {rounds}")
    for m in ms:
        t, r, g = result["t_iter"][m], result["round_s"][m], result["final_gap"][m]
        if not (t > 0 and r > 0 and abs(g) < float("inf")):
            fail(f"m={m}: t_iter={t}, round={r}, gap={g}")
    print(json.dumps({"main_path": {k: result[k] for k in
                                    ("p_star", "round_s", "t_iter", "final_gap", "f_m", "r2",
                                     "fastest_to_epsilon", "best_within_budget", "seconds")}}))

    phase("device busy share (torch.profiler over 5 CoCoA rounds with their recording)")
    from torch.profiler import ProfilerActivity, profile
    for m in (1, 16, 128):
        run_cocoa(problem, CocoaConfig(m, 1))  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rec = run_cocoa(problem, CocoaConfig(m, 5))
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        sdca_ms = sum(e.self_device_time_total for e in events if "sdca_kernel" in e.key) / 1e3
        print(f"m={m}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"(share {busy_ms / wall_ms:.4f}), of it sdca_kernel {sdca_ms:.2f} ms; "
              f"timed rounds {rec.compute_seconds * 1e3:.2f} ms")
        if busy_ms <= 0:
            fail("the profiler saw no device time")

    return {
        "name": "local_sdca",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdca/csrc/sdca.cu",
        "replaces": "src/repro/kernels/sdca/kernel.py:68",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by_m[16]["bound_by"],
        "library_ms": None,
        "timed_by": EAGER,
        "shape": "m=16 nl=3750 d=784 H=nl",
        "by_m": by_m,
        "chain_floor_us_a_step": floor_us,
    }, problem, result["p_star"]


# K6 against its plain version at the chaos run's shapes: the smooth hinge
# and the logistic loss carry the dot's last-bit difference (its order of
# summation, the only operation the two do differently) through a
# continuous slope, and at those step sizes (lr0 0.01, lambda 1e-2) each step
# is a contraction, so W stays within 1e-5 of max |W| (tests/
# test_torch_local_sgd_gpu.py).  The hinge's slope is -1 or 0, so there the
# two give the same bits, or differ from a step whose margin lies within the
# dot's rounding bound of the gate at 1 (``first_gate_ties``), the kernel's
# chain bit for bit the plain version's up to it.
LOCAL_SGD_RTOL_OF_MAX = 1e-5
LOCAL_SGD_PAPER = dict(lr0=1.0, t0=100.0)   # LocalSGDConfig's defaults
LOCAL_SGD_CHAOS = dict(lr0=0.01, t0=100.0, lam=1e-2)  # run_chaos_sim's executor
MENU_M = 16
MENU_ITERS = 40
MENU_HINGE = ("cocoa", "cocoa+", "local_sgd", "minibatch_sgd")  # Fig 1c's set
MENU_SMOOTH = ("gd", "lbfgs")  # need a smooth loss (L-BFGS refuses the hinge)


def check_hinge_chain(W0, Xs, ys, idx, t, lr0, t0, lam, what) -> list:
    """K6 against its plain version for the hinge: bit for bit, or each
    differing worker explained by a gate tie.  Returns the workers that
    differ (each explained)."""
    import torch

    from repro_torch.kernels.local_sgd import ops
    from repro_torch.kernels.local_sgd.ref import first_gate_ties, local_sgd_ref

    h = idx.shape[1]
    got = ops.local_sgd(W0, Xs, ys, idx, t, h, lr0, t0, lam, "hinge")
    torch.cuda.synchronize()
    want = local_sgd_ref(W0, Xs, ys, idx, t, h, lr0, t0, lam, "hinge")
    if not bool(torch.isfinite(got).all()):
        fail(f"local_sgd {what}: kernel output is not finite")
    differ = (got != want).any(1).nonzero().flatten().tolist()
    if differ:
        ties = first_gate_ties(W0, Xs, ys, idx, t, h, lr0, t0, lam)
        for k in differ:
            tie = int(ties[k])
            head = idx[:, :tie].contiguous()
            if tie >= h or not torch.equal(
                    ops.local_sgd(W0, Xs, ys, head, t, h, lr0, t0, lam, "hinge")[k],
                    local_sgd_ref(W0, Xs, ys, head, t, h, lr0, t0, lam, "hinge")[k]):
                fail(f"local_sgd {what}: worker {k} differs from the plain version, and not "
                     f"from a gate tie (first tie at step {tie} of {h})")
        print(f"  {what}: workers {differ} differ from a gate tie each (first ties at steps "
              f"{[int(ties[k]) for k in differ]}), bit for bit before it")
    return differ


def local_sgd_vs_plain(dev, problem) -> float:
    """Phase 7a.  K6 against its plain version: the paper's shapes (hinge,
    one local epoch at m 16 and 128, a whole m = 1 round of 60000 steps) and
    the chaos run's (n 512, d 32, m 1 to 4, H 1 and 2, stale start vectors,
    t > 0, all three losses).  Returns the largest absolute error of the
    continuous losses (the hinge's cases are bit for bit, or explained)."""
    import torch

    from repro_torch.kernels.local_sgd import ops
    from repro_torch.kernels.local_sgd.ref import local_sgd_ref
    from repro_torch.optim.cocoa import draw_indices, partition
    from repro_torch.optim.problems import synthetic_mnist

    phase("K6 (local SGD) kernel vs plain (60000 x 784 hinge; the chaos run's shapes)")
    gen = torch.Generator(device=dev).manual_seed(11)
    for m in (16, 128, 1):
        Xs, ys = partition(problem.X, problem.y, m)
        nl = Xs.shape[1]
        idx = draw_indices(m, nl, nl, gen)
        W0 = torch.zeros((m, problem.d), device=dev)
        differ = check_hinge_chain(W0, Xs, ys, idx, 0, LOCAL_SGD_PAPER["lr0"],
                                   LOCAL_SGD_PAPER["t0"], problem.lam, f"hinge m={m} H={nl}")
        print(f"hinge m={m} nl={nl} H={nl} lam={problem.lam}: {m - len(differ)} of {m} workers "
              "bit for bit")
    X, y = synthetic_mnist(512, 32, 16, 0.09, 0.35, 0)
    max_err = 0.0
    for m, h in ((1, 1), (2, 2), (4, 1), (4, 2)):
        Xs, ys = partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)
        nl = Xs.shape[1]
        W0 = 0.1 * torch.randn((m, 32), generator=gen, device=dev)  # stale copies
        for t in (0, 37, 159):
            idx = torch.randint(0, nl, (m, h), generator=gen, device=dev)
            check_hinge_chain(W0, Xs, ys, idx, t, **LOCAL_SGD_CHAOS, what=f"chaos m={m} h={h}")
            for loss in ("smooth_hinge", "logistic"):
                args = (W0, Xs, ys, idx, t, h, *LOCAL_SGD_CHAOS.values(), loss)
                got = ops.local_sgd(*args)
                torch.cuda.synchronize()
                want = local_sgd_ref(*args)
                err = float((got - want).abs().max())
                if not err <= LOCAL_SGD_RTOL_OF_MAX * float(want.abs().max()):
                    fail(f"local_sgd {loss} m={m} h={h} t={t}: max|dW| {err:.3e}")
                max_err = max(max_err, err)
    print(f"chaos shapes (n 512, d 32, m 1-4, h 1-2, t 0/37/159): hinge bit for bit or "
          f"explained; smooth hinge and logistic max|dW| {max_err:.3e} (limit "
          f"{LOCAL_SGD_RTOL_OF_MAX} max|W|)")
    return max_err


# The chaos run's K6 launches (run_chaos_sim's SSP executor): m workers of
# the 512 x 32 problem, h local steps each
CHAOS_SHAPES = ((1, 1), (2, 2), (4, 1), (4, 2))


def k6_times(dev, problem) -> tuple:
    """K6's times, through its wrapper and its chain probe only, which every
    version of K6 has (so ``--k6-times`` runs it on another checkout): the
    chain floor at the paper's d; ms a launch at m = 1, 16 and 128 (one local
    epoch each, hinge); us a launch at the chaos run's shapes, eager (the
    wrapper's host time in it) and from a CUDA graph of the calls (the
    device's).  Returns the times and the paper-shape inputs by m."""
    import torch

    from repro_torch.kernels.local_sgd import build, ops
    from repro_torch.optim.cocoa import draw_indices, partition
    from repro_torch.optim.problems import synthetic_mnist

    lam, d = problem.lam, problem.d
    lr0, t0 = LOCAL_SGD_PAPER["lr0"], LOCAL_SGD_PAPER["t0"]
    floor_us = step_floor_us("K6", d, lambda h, out, stream: build.load(
        ).local_sgd_chain_launch(d, h, lr0, t0, lam, out, stream))
    gen = torch.Generator(device=dev).manual_seed(12)
    by_m, inputs = {}, {}
    for m in (1, 16, 128):
        Xs, ys = partition(problem.X, problem.y, m)
        nl = Xs.shape[1]
        W0 = torch.zeros((m, d), device=dev)
        idx = draw_indices(m, nl, nl, gen)
        ms = cuda_ms(lambda: ops.local_sgd(W0, Xs, ys, idx, 0, nl, lr0, t0, lam),
                     reps=3 if m == 1 else 10, warmup=1)
        by_m[m] = {"ms": ms, "us_a_step": 1e3 * ms / nl, "h": nl}
        inputs[m] = (W0, Xs, ys, idx)
    X, y = synthetic_mnist(512, 32, 16, 0.09, 0.35, 0)
    chaos = {}
    for m, h in CHAOS_SHAPES:
        Xs, ys = partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)
        W0 = 0.1 * torch.randn((m, 32), generator=gen, device=dev)
        idx = torch.randint(0, Xs.shape[1], (m, h), generator=gen, device=dev)

        def call():
            return ops.local_sgd(W0, Xs, ys, idx, 37, h, *LOCAL_SGD_CHAOS.values(),
                                 "smooth_hinge")

        chaos[f"m={m} h={h}"] = {"eager_us": 1e3 * cuda_ms(call, reps=200),
                                 "graph_us": 1e3 * graph_ms(call, reps=200)}
    return {"chain_floor_us_a_step": floor_us, "by_m": by_m, "chaos": chaos}, inputs


def local_sgd_timings(dev, problem) -> dict:
    """Phase 7b.  K6's plan and copy route at the paper's d, its ms a launch
    at m = 1, 16 and 128 (one local epoch each, hinge) against its bytes
    bound and chain floor, its plain version's ms at m = 16, its us a launch
    at the chaos run's shapes, and its step at m = 16 in parts."""
    import ctypes

    import torch

    from repro_torch.kernels.local_sgd import build, ops
    from repro_torch.kernels.local_sgd.ref import local_sgd_ref

    phase("K6 timings (m = 1, 16 and 128, the chaos shapes; CUDA events, after warm-up)")
    lam, d = problem.lam, problem.d
    lr0, t0 = LOCAL_SGD_PAPER["lr0"], LOCAL_SGD_PAPER["t0"]
    plan = (ctypes.c_int * 4)()
    build.LIBRARY.check(build.load().local_sgd_plan(d, plan), "local_sgd_plan")
    if tuple(plan[i] for i in (0, 1, 3)) != ops.kernel_plan(d):
        fail(f"K6's plan at d {d}: the library's {list(plan)}, ops.kernel_plan's "
             f"{ops.kernel_plan(d)}")
    times, inputs = k6_times(dev, problem)
    floor_us = times["chain_floor_us_a_step"]
    route = ops.copy_route(inputs[16][1])
    print(f"K6 plan at d {d}: {plan[0]} entries a lane in registers, a ring of {plan[1]} rows "
          f"({plan[2]} staged together), {plan[3]} B of shared memory; copies: {route}")
    by_m = {}
    for m, t in times["by_m"].items():
        W0, Xs, ys, idx = inputs[m]
        nl, ms = t["h"], t["ms"]
        # the rows the orders touch and their labels, the orders, W0 read
        # once, W written once; a step a dot product and an axpy of 5 d
        rows = sum(int(row.unique().numel()) for row in idx)
        nbytes = 4 * (rows * (d + 1) + m * nl + 2 * m * d)
        flops = 7 * d * m * nl
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        chain_ms = nl * floor_us / 1e3
        by_m[m] = {"ms": ms, "us_a_step": t["us_a_step"], "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "chain_floor_ms": chain_ms, "h": nl}
        print(f"local_sgd m={m} nl={nl} d={d} H={nl}: kernel {ms:.3f} ms/launch "
              f"({t['us_a_step']:.4f} us a step), bound {by_m[m]['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
              f"{ops_ms:.4f} ms), kernel at {100 * by_m[m]['bound_ms'] / ms:.2f}% of bound; "
              f"chain floor {chain_ms:.3f} ms (H x {floor_us:.4f} us), kernel at "
              f"{100 * chain_ms / ms:.1f}% of it")
    for shape, t in times["chaos"].items():
        print(f"local_sgd chaos shape {shape} (n 512, d 32): {t['eager_us']:.2f} us a launch "
              f"eager, {t['graph_us']:.2f} us from a CUDA graph")
    parts = k6_ring_parts(inputs[16], lam)
    print(f"K6's step at m=16 in parts (the library's local_sgd_probe_launch, us a step): the "
          f"kernel {by_m[16]['us_a_step']:.4f}; its ring refilled but never awaited "
          f"{parts['no_wait']:.4f}; pre-filled, never refilled or awaited "
          f"{parts['prefilled']:.4f}; chain floor {floor_us:.4f}.  So the waits "
          f"{by_m[16]['us_a_step'] - parts['no_wait']:.4f}, the copies' issue "
          f"{parts['no_wait'] - parts['prefilled']:.4f}, the ring's reads and the order "
          f"{parts['prefilled'] - floor_us:.4f}")
    W0, Xs, ys, idx = inputs[16]
    nl = Xs.shape[1]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    local_sgd_ref(W0, Xs, ys, idx, 0, nl, lr0, t0, lam)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_start) * 1e3
    print(f"plain version at m=16: {plain_ms:.1f} ms/call (H eager steps of about ten "
          "launches); no single PyTorch call computes the chain")
    return {"ms": by_m[16]["ms"], "plain_ms": plain_ms, "bound_ms": by_m[16]["bound_ms"],
            "bound_by": by_m[16]["bound_by"], "by_m": by_m, "chain_floor_us_a_step": floor_us,
            "ring_rows": plan[1], "copy_route": route, "chaos_us_a_launch": times["chaos"],
            "ring_parts_us_a_step": parts}


def k6_ring_parts(inputs, lam) -> dict:
    """Phase 7b: K6's register path at m = 16 in the probe's two modes (the
    library's ``local_sgd_probe_launch``, timing only): its ring refilled
    but never awaited, and pre-filled, never refilled or awaited; us a
    step, CUDA events."""
    import torch

    from repro_torch.kernels.local_sgd import build

    W0, Xs, ys, idx = inputs
    m, nl, d = Xs.shape
    idx32 = idx.to(torch.int32).contiguous()
    W = torch.empty_like(W0)
    lib = build.load()
    parts = {}
    for mode, name in ((1, "prefilled"), (2, "no_wait")):
        def probe():
            build.LIBRARY.check(lib.local_sgd_probe_launch(
                W0.data_ptr(), Xs.data_ptr(), ys.data_ptr(), idx32.data_ptr(), W.data_ptr(),
                m, nl, d, nl, 0.0, nl, LOCAL_SGD_PAPER["lr0"], LOCAL_SGD_PAPER["t0"], lam, mode,
                torch.cuda.current_stream().cuda_stream), "local_sgd_probe")

        parts[name] = 1e3 * cuda_ms(probe, reps=10, warmup=1) / nl
        if not bool(torch.isfinite(W).all()):
            fail(f"K6's probe ({name}) wrote values that are not finite")
    return parts


def k6_times_main(checkout: Path) -> None:
    """``python3 chip_smoke.py --k6-times DIR``: ``k6_times`` on the checkout
    at DIR (its kernel built from its own sources), printed as one JSON
    line, so that two versions of K6 compare within one call."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.optim import make_mnist_svm

    print(f"card: {nvidia_smi_line()}; K6 from {checkout}")
    times, _ = k6_times(torch.device("cuda"), make_mnist_svm(device="cuda"))
    print(json.dumps({"k6_times": str(checkout), **times}))


def menu_path(dev, problem, p_star) -> int:
    """Phase 7c.  Main path: the algorithm menu at the paper's workload,
    ``BSPCluster.simulate`` at m = 16 for Fig 1c's set on the hinge problem
    and for GD and L-BFGS on the smooth hinge at the same size.  Returns
    K6's launches on it."""
    from repro_torch.optim import ALGORITHMS, BSPCluster
    from repro_torch.optim.simcluster import solve_reference

    phase(f"main path 1b: the algorithm menu, 60000 x 784, m = {MENU_M}, {MENU_ITERS} rounds "
          "each (BSPCluster.simulate)")
    if set(MENU_HINGE + MENU_SMOOTH) != set(ALGORITHMS):
        fail(f"the menu path runs {MENU_HINGE + MENU_SMOOTH}, the port has {ALGORITHMS}")
    smooth = dataclasses.replace(problem, loss="smooth_hinge")
    p_smooth, _ = solve_reference(smooth, iters=REF_ITERS)  # set-up, before the counts
    print(f"P* hinge {p_star:.6f} (main path 1), smooth hinge {p_smooth:.6f} ({REF_ITERS} "
          "SDCA rounds at m = 1)")
    cluster = BSPCluster()
    reset_launches()
    t_path = time.perf_counter()
    rows = {}
    for name, prob, ref in ([(a, problem, p_star) for a in MENU_HINGE]
                            + [(a, smooth, p_smooth) for a in MENU_SMOOTH]):
        t0 = time.perf_counter()
        sim = cluster.simulate(prob, name, MENU_M, MENU_ITERS)
        seconds = time.perf_counter() - t0
        rec = sim.record
        rows[name] = {"loss": prob.loss, "round_ms": 1e3 * rec.compute_seconds / MENU_ITERS,
                      "t_iter_ms": 1e3 * sim.t_iter, "final_gap": float(rec.primal.min() - ref),
                      "seconds": seconds}
        r = rows[name]
        print(f"{name:14s} ({prob.loss:12s}): measured round {r['round_ms']:8.3f} ms, t_iter "
              f"{r['t_iter_ms']:8.2f} ms, final gap {r['final_gap']:.3e}, {seconds:.2f} s")
        if not (r["round_ms"] > 0 and r["t_iter_ms"] > 0 and abs(r["final_gap"]) < 1e30):
            fail(f"{name}: {r}")
    counts = read_launches()
    # per algorithm: a warm-up round, the timed rounds, and the dispatch
    # floor's warm-up and three timed rounds
    rounds = 1 + MENU_ITERS + 1 + 3
    expected = {name: 0 for name in counts}
    expected.update(local_sgd=rounds, local_sdca=2 * rounds)
    print(f"launches {counts}; local SGD rounds run {rounds}, CoCoA and CoCoA+ rounds "
          f"{2 * rounds}; {time.perf_counter() - t_path:.1f} s")
    if counts != expected:
        fail(f"menu path launches {counts} != the rounds run {expected}")
    print(json.dumps({"menu_path": rows}))
    return counts["local_sgd"]


def chaos_path(dev) -> int:
    """Phase 7d.  A small-input check of the chaos loop (the card against
    the CPU on the same draws), then the main path: ``python -m
    repro_torch.chaos_train --seed 0`` in process on the card, run and
    replay.  Returns K6's launches on it."""
    import torch

    from repro_torch import chaos_train
    from repro_torch.optim.simcluster import step_seed
    from repro_torch.runtime.chaos import run_chaos_sim

    phase("small-input check: the chaos loop on the card vs the CPU, 60 steps, the same draws")

    def cpu_draws(t, m, h, nl):
        return torch.randint(0, nl, (m, h), generator=torch.Generator().manual_seed(
            step_seed(0, t)))

    card, cpu = (run_chaos_sim(0, steps=60, device=d, indices=cpu_draws) for d in (dev, "cpu"))
    for got, want in zip(card.rows, cpu.rows):
        if any(got.get(k) != want.get(k) for k in ("m", "events", "mitigation", "decision",
                                                      "restore")) or \
                abs(got["objective"] - want["objective"]) > 1e-5 * abs(want["objective"]):
            fail(f"chaos step {got['step']}: card {got} vs cpu {want}")
    print(f"60 steps: the same control sequence, objectives within rtol 1e-5 (final "
          f"{card.rows[-1]['objective']:.7f} card, {cpu.rows[-1]['objective']:.7f} cpu)")

    phase("main path 1c: python -m repro_torch.chaos_train --seed 0 (run and replay)")
    reset_launches()
    t0 = time.perf_counter()
    log = chaos_train.main(["--seed", "0"])  # raises if the replay diverges
    seconds = time.perf_counter() - t0
    counts = read_launches()
    outer_steps = sum(1 for r in log.rows if not r.get("restore"))
    expected = {name: 0 for name in counts}
    expected["local_sgd"] = 2 * outer_steps  # the run and its replay
    objs = [r["objective"] for r in log.rows]
    summary = {"steps": len(log.rows), "outer_steps": outer_steps,
               "mitigations": log.n_mitigations(), "resizes": log.n_resizes(),
               "final_m": log.meta["final_m"], "final_objective": log.meta["final_objective"],
               "seconds_run_and_replay": seconds}
    print(f"launches {counts}, expected 2 x {outer_steps} outer steps; {json.dumps(summary)}")
    if counts != expected:
        fail(f"chaos path launches {counts} != {expected}")
    if not (all(abs(o) < 1e30 for o in objs) and objs[-1] < 0.8 * objs[0]
            and log.n_mitigations() >= 1):
        fail(f"the chaos run did not adapt and converge: {summary}")
    return counts["local_sgd"]


def check_against_plain(torch, name, got, want, v, what) -> float:
    """Fails unless ``got`` is finite and within MAX_BF16_ULPS of ``want``
    beyond V_ATOL_OF_MAX max|v|; returns the largest absolute error."""
    atol = V_ATOL_OF_MAX * float(v.float().abs().max())
    ulps, err = bf16_ulps(got, want, atol), float((got.float() - want.float()).abs().max())
    print(f"{name} {what}: max|d|={err:.3e}, {bf16_ulps(got, want):.0f} bf16 ulp, "
          f"{ulps:.0f} bf16 ulp beyond {atol:.2e}")
    if not torch.isfinite(got.float()).all() or ulps > MAX_BF16_ULPS:
        fail(f"{name} disagrees with its plain version at {what}")
    return err


def random_pages(torch, gen, dev, b, npp, n_pages):
    """Page tables drawing distinct pages 1.. in a shuffled order."""
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    return perm[: b * npp].reshape(b, npp).to(torch.int32).contiguous()


def serve_kernels_vs_plain(dev, cfg):
    """Phases 8 and 27a (internvl2-76b's and musicgen-medium's heads).
    Returns the largest absolute error of each kernel."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import paged_decode_stream

    phase(f"K3 and K2 vs plain (bf16, {cfg.name}: Hk {cfg.n_kv_heads}, "
          f"G {cfg.n_heads // cfg.n_kv_heads}, head_dim {cfg.head_dim})")
    hk, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errs = {"flash_fwd": 0.0, "paged_decode": 0.0}
    # the last case's K and V hold NaN at and past each row's kv_len: the
    # kernel must never multiply them in
    for sq, skv, lens, q_offset, block_k in ((1, 1, None, 0, 16), (17, 17, None, 0, 16),
                                             (1024, 1024, None, 0, 16),
                                             (1024, 1024, None, 0, 64),
                                             (48, 160, [150, 97], 112, 16),
                                             (200, 300, [290, 170], 100, 64)):
        b = 1 if lens is None else len(lens)
        q, k, v = bf16(b, hk * g, sq, d), bf16(b, hk, skv, d), bf16(b, hk, skv, d)
        kv_lens = torch.tensor(lens or [skv] * b, dtype=torch.int32, device=dev)
        if block_k == 64 and lens is not None:
            for i, n in enumerate(lens):
                k[i, :, n:] = float("nan")
                v[i, :, n:] = float("nan")
        got = fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=d ** -0.5, q_offset=q_offset,
                               block_k=block_k)
        torch.cuda.synchronize()
        want = flash_fwd_ref(q, k.nan_to_num(0.0), v.nan_to_num(0.0), kv_lens, causal=True,
                             sm_scale=d ** -0.5, q_offset=q_offset, block_q=16,
                             block_k=block_k)
        errs["flash_fwd"] = max(errs["flash_fwd"], check_against_plain(
            torch, "flash_fwd", got, want, v.nan_to_num(0.0),
            f"B={b} Sq={sq} Skv={skv} kv_lens={lens} q_offset={q_offset} block_k={block_k}"))

    lengths = [1, 1, 5, 16, 17, 333, 1088, 1120]  # two scratch rows, ragged, page-unaligned
    b, page, npp = len(lengths), 16, 70  # npp = 70 is not a multiple of ppp = 4
    n_pages = 1 + b * npp
    kp, vp = bf16(n_pages, hk, page, d), bf16(n_pages, hk, page, d)
    tables = random_pages(torch, gen, dev, b, npp, n_pages)  # out of order
    tables[:2] = 0  # idle slots: every entry the scratch page
    q = bf16(b, hk, g, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=d ** -0.5, pages_per_program=4)
    torch.cuda.synchronize()
    want = paged_decode_stream(q, kp, vp, lens, tables, scale=d ** -0.5, pages_per_program=4)
    errs["paged_decode"] = check_against_plain(torch, "paged_decode", got, want, vp,
                                               f"B={b} lengths={lengths} npp={npp} ppp=4")
    # NaN in every pool position past each row's length (the scratch page
    # included): the kernel never reads them
    kp_nan, vp_nan = kp.clone(), vp.clone()
    live = torch.zeros(n_pages, page, dtype=torch.bool, device=dev)
    for i, n in enumerate(lengths):
        pos = torch.arange(n, device=dev)
        live[tables[i].long()[pos // page], pos % page] = True
    kp_nan.masked_fill_(~live[:, None, :, None], float("nan"))
    vp_nan.masked_fill_(~live[:, None, :, None], float("nan"))
    got_nan = fd_ops.paged_decode(q, kp_nan, vp_nan, lens, tables, scale=d ** -0.5,
                                  pages_per_program=4)
    torch.cuda.synchronize()
    if not torch.equal(got_nan, got):
        fail("paged_decode: NaN past the rows' lengths changed the output")
    print("paged_decode with NaN at every position past the rows' lengths: output unchanged")
    print(f"tolerance: at most {MAX_BF16_ULPS} bf16 ulp of the output beyond "
          f"{V_ATOL_OF_MAX:.2e} max|v|")
    return errs


# The chunked-prefill cases of K3 (phases 8b, 18b): a monolithic prefill's
# call over 2048 rows with a prompt of 1088, and chunks of it at their
# (q_offset, rows): 300 (not a multiple of 16) and 256 rows; 517 and 8 rows,
# the CLI's chunk; 1000 and 88 rows across the 1024-row block edge.  The
# gathered page row is 1088 positions, stale past each chunk's kv_len.
CHUNK_MONO_S, CHUNK_PROMPT = 2048, LONG_PROMPT + LONG_GEN
CHUNK_CASES = ((300, 256), (517, 8), (1000, 88))
# The verify cases of K2 and K2-latent: max_batch 8 slots, k = 3 drafts,
# the fold's 32 rows draft index major (row t * 8 + s); slot 0 idle, slot 3
# with one draft (its rows t >= 2 padded), every other slot with three.
VERIFY_DRAFTS = 3
VERIFY_SLOT_LENGTHS = [0, 1, 5, 16, 17, 333, 1000, 1084]
VERIFY_SLOT_DRAFTS = [-1, 3, 3, 1, 3, 3, 3, 3]


def chunk_kernel_vs_monolithic(torch, gen, hq, hk, dk, dv, scale) -> float:
    """K3 at each chunk's shape (``CHUNK_CASES``) against its plain version,
    and bit for bit against the same rows of the monolithic call.  Returns
    the largest absolute error against the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    dev = gen.device

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = bf16(1, hq, CHUNK_MONO_S, dk), bf16(1, hk, CHUNK_MONO_S, dk), bf16(1, hk,
                                                                                  CHUNK_MONO_S, dv)
    lens = torch.tensor([CHUNK_PROMPT], dtype=torch.int32, device=dev)
    mono = fa_ops.flash_fwd(q, k, v, lens, sm_scale=scale, block_k=16)
    err = 0.0
    for s0, c in CHUNK_CASES:
        kv_len = s0 + c
        k_row, v_row = k[:, :, :CHUNK_PROMPT].clone(), v[:, :, :CHUNK_PROMPT].clone()
        k_row[:, :, kv_len:] = bf16(1, hk, CHUNK_PROMPT - kv_len, dk)  # stale pages
        v_row[:, :, kv_len:] = bf16(1, hk, CHUNK_PROMPT - kv_len, dv)
        qc = q[:, :, s0:s0 + c].contiguous()
        kv_lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        got = fa_ops.flash_fwd(qc, k_row, v_row, kv_lens, sm_scale=scale, q_offset=s0,
                               block_k=16)
        torch.cuda.synchronize()
        what = (f"a chunk: Hq={hq} Hk={hk} dk={dk} dv={dv} q_offset={s0} Sq={c} "
                f"Skv={CHUNK_PROMPT} kv_len={kv_len}")
        if not torch.equal(got, mono[:, :, s0:s0 + c]):
            fail(f"flash_fwd at {what} differs from the monolithic call's rows")
        want = flash_fwd_ref(qc, k_row, v_row, kv_lens, causal=True, sm_scale=scale,
                             q_offset=s0, block_q=16, block_k=16)
        err = max(err, check_against_plain(torch, "flash_fwd", got, want, v_row, what))
    s0, c = 3 * 256, 256  # the chunked long run's last chunk of a prompt
    qc = q[:, :, s0:s0 + c].contiguous()
    k_row, v_row = k[:, :, :CHUNK_PROMPT].contiguous(), v[:, :, :CHUNK_PROMPT].contiguous()
    kv_lens = torch.tensor([s0 + c], dtype=torch.int32, device=dev)
    chunk_ms = cuda_ms(lambda: fa_ops.flash_fwd(qc, k_row, v_row, kv_lens, sm_scale=scale,
                                                q_offset=s0, block_k=16), reps=10)
    print(f"flash_fwd at every chunk: bit for bit the rows of the monolithic call over "
          f"{CHUNK_MONO_S} rows, kv_len {CHUNK_PROMPT}; a chunk of {c} rows at q_offset {s0} "
          f"over {CHUNK_PROMPT} keys {chunk_ms:.4f} ms (CUDA events)")
    return err


def verify_fold(torch, dev, page, npp, n_pages, gen):
    """The fold's lengths (attended positions), page tables and the slots'
    own tables, draft index major (``VERIFY_*``); padded rows length 0 and
    all-scratch tables."""
    b, t_rows = len(VERIFY_SLOT_LENGTHS), VERIFY_DRAFTS + 1
    slot_tables = random_pages(torch, gen, dev, b, npp, n_pages)
    lens = torch.zeros(b * t_rows, dtype=torch.int32, device=dev)
    tables = torch.zeros((b * t_rows, npp), dtype=torch.int32, device=dev)
    for s, (length, drafts) in enumerate(zip(VERIFY_SLOT_LENGTHS, VERIFY_SLOT_DRAFTS)):
        for t in range(drafts + 1):
            lens[t * b + s] = length + t + 1
            tables[t * b + s] = slot_tables[s]
    return lens, tables


def verify_kernel_vs_decode(torch, name, call, plain, args, lens, tables, v, ppps) -> float:
    """``call(*args, lens, tables, ppp)`` over the fold against ``plain`` at
    the same arguments, and each block of the fold bit for bit a
    decode-shaped call (``len(VERIFY_SLOT_LENGTHS)`` rows) over it, at each
    pages_per_program of ``ppps``.  Returns the largest error."""
    b = len(VERIFY_SLOT_LENGTHS)
    err = 0.0
    for ppp in ppps:
        got = call(*args, lens, tables, ppp)
        torch.cuda.synchronize()
        for t in range(VERIFY_DRAFTS + 1):
            rows = slice(t * b, (t + 1) * b)
            alone = call(*(a[rows] for a in args), lens[rows].contiguous(),
                         tables[rows].contiguous(), ppp)
            if not torch.equal(alone, got[rows]):
                fail(f"{name}: the fold's rows {t * b}..{(t + 1) * b - 1} differ from a "
                     f"decode-shaped call at ppp={ppp}")
        err = max(err, check_against_plain(
            torch, name, got, plain(*args, lens, tables, ppp), v,
            f"a verify fold of {len(lens)} rows (k={VERIFY_DRAFTS}, slot lengths "
            f"{VERIFY_SLOT_LENGTHS}) ppp={ppp}"))
    flush = torch.zeros(FLUSH_BYTES // 4, device=lens.device)
    fold_ms = graph_ms(lambda: call(*args, lens, tables, ppps[0]), reps=20, flush=flush)
    block_ms = graph_ms(lambda: call(*(a[:b] for a in args), lens[:b].contiguous(),
                                     tables[:b].contiguous(), ppps[0]), reps=20, flush=flush)
    print(f"{name} over the fold: each block of {b} rows bit for bit a decode-shaped call; "
          f"the fold of {len(lens)} rows {fold_ms:.4f} ms, its first block's {b} rows alone "
          f"{block_ms:.4f} ms at ppp={ppps[0]} (CUDA graph, L2 flushed)")
    return err


def chunk_verify_kernels_vs_plain(dev, cfg) -> dict:
    """Phase 8b: K3 at chunked prefill's shapes and K2 over a verify fold at
    qwen3-14b's widths.  Returns the largest absolute error of each."""
    import torch

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import paged_decode_stream

    hk, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    phase(f"K3 at chunked prefill's shapes and K2 over a verify fold (bf16, {cfg.name}: "
          f"Hk {hk}, G {g})")
    gen = torch.Generator(device=dev).manual_seed(10)
    errs = {"flash_fwd": chunk_kernel_vs_monolithic(torch, gen, hk * g, hk, d, d, d ** -0.5)}
    page, npp = 16, LONG_PAGES
    n_pages = 1 + len(VERIFY_SLOT_LENGTHS) * npp
    lens, tables = verify_fold(torch, dev, page, npp, n_pages, gen)
    kp = torch.randn((n_pages, hk, page, d), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pages, hk, page, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((len(lens), hk, g, d), generator=gen, device=dev).to(torch.bfloat16)
    errs["paged_decode"] = verify_kernel_vs_decode(
        torch, "paged_decode",
        lambda q_, lens_, tables_, ppp: fd_ops.paged_decode(
            q_, kp, vp, lens_, tables_, scale=d ** -0.5, pages_per_program=ppp),
        lambda q_, lens_, tables_, ppp: paged_decode_stream(
            q_, kp, vp, lens_, tables_, scale=d ** -0.5, pages_per_program=ppp),
        (q,), lens, tables, vp, (K2_ROW_PAGES_PER_PROGRAM, K2_ONE_TILE_PAGES_PER_PROGRAM, 16))
    return errs


def mla_chunk_verify_kernels_vs_plain(dev, cfg) -> dict:
    """Phase 18b: K3 at (192, 128) at chunked prefill's shapes and K2's
    latent form over a verify fold at deepseek-v2's widths.  Returns the
    largest absolute error of each."""
    import torch

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models.mla import sm_scale

    m, h = cfg.mla, cfg.n_heads
    scale = sm_scale(cfg)
    phase(f"K3 (192, 128) at chunked prefill's shapes and K2-latent over a verify fold "
          f"(bf16, {DEEPSEEK})")
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {"flash_fwd": chunk_kernel_vs_monolithic(
        torch, gen, h, h, m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim, scale)}
    page, npp = 16, LONG_PAGES
    n_pages = 1 + len(VERIFY_SLOT_LENGTHS) * npp
    lens, tables = verify_fold(torch, dev, page, npp, n_pages, gen)
    q_lat, q_pe, ckv, kpe, _, _ = latent_inputs(torch, gen, cfg, len(lens), npp)
    ckv, kpe = ckv[:n_pages].contiguous(), kpe[:n_pages].contiguous()
    errs["paged_latent_decode"] = verify_kernel_vs_decode(
        torch, "paged_latent_decode",
        lambda ql, qp, lens_, tables_, ppp: fd_ops.paged_latent_decode(
            ql, qp, ckv, kpe, lens_, tables_, scale=scale, pages_per_program=ppp),
        lambda ql, qp, lens_, tables_, ppp: fd_ops.paged_latent_decode_attention(
            ql, qp, ckv, kpe, lens_, tables_, sm_scale=scale, impl="stream",
            pages_per_program=ppp),
        (q_lat, q_pe), lens, tables, ckv, (fd_ops.DEFAULT_PAGES_PER_PROGRAM,))
    return errs


def small_lm_check(dev, arch, pin_routing=False):
    """Phases 9, 14, 19 and 27a: the smoke LM on the card against the plain
    versions on the CPU, same weights: prefill logits, then 8 teacher-forced
    decode steps; a frontend arch's prompts after their embeddings (8
    frontend positions, synthetic as the reference draws them).  With
    ``pin_routing`` the CPU's MoE takes the card's top-k experts where the
    two differ, each such row a near tie (``pinned_routing``)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    from repro_torch.serve.cache import init_paged_cache, write_prefill

    phase(f"small-input check: smoke {arch} on the card vs the plain versions on the CPU"
          + (", the CPU's MoE on the card's experts where they differ" if pin_routing else ""))
    cfg = get_smoke_config(arch)
    cpu = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 37)))
    forced = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 2)))
    tables = torch.tensor([[3, 7, 1, 10], [5, 2, 11, 8]], dtype=torch.int32)
    f = cfg.n_frontend_tokens
    fe = torch.from_numpy((0.02 * rng.randn(1, f, cfg.d_model)).astype(np.float32)) if f else None
    worst = [0.0, 0.0]

    def compare(got, want, what):
        want = want.float()
        scale = float(want.abs().max())
        err = (got.float().cpu() - want).abs()
        worst[0] = max(worst[0], float(err.max()) / scale)
        worst[1] = max(worst[1], float(err.mean()) / scale)
        if not torch.isfinite(got.float()).all() or float(err.max()) > LM_MAX_OF_SCALE * scale \
                or float(err.mean()) > LM_MEAN_OF_SCALE * scale:
            fail(f"small LM {what}: max |d| {float(err.max())}, mean {float(err.mean())}, "
                 f"max |logit| {scale}")

    with pinned_routing(arch) if pin_routing else contextlib.nullcontext():
        caches = []
        for model in (card, cpu):
            cache = init_paged_cache(model, num_pages=12, page_size=16, max_batch=2)
            for slot, n in enumerate((37, 21)):
                _, pre = model.prefill(prompt[:, :n], fe)
                write_prefill(cache, pre, slot=slot,
                              page_ids=list(tables[slot, :-(-(f + n) // 16)]), page_size=16)
            caches.append(cache)
        compare(card.prefill(prompt, fe)[0], cpu.prefill(prompt, fe)[0], "prefill")
        lengths = torch.tensor([f + 37, f + 21], dtype=torch.int32)
        for step in range(8):
            got, _ = card.decode_step_paged(forced[step], lengths.to(dev), caches[0],
                                            tables.to(dev))
            want, _ = cpu.decode_step_paged(forced[step], lengths, caches[1], tables)
            compare(got, want, f"decode step {step}")
            lengths += 1
    print(f"prefill + 8 decode steps: max |d| {worst[0]:.4f}, mean |d| {worst[1]:.5f} of the "
          f"largest logit (limits {LM_MAX_OF_SCALE}, {LM_MEAN_OF_SCALE})")


@contextlib.contextmanager
def pinned_routing(arch):
    """The MoE's ``route`` patched for a card-vs-CPU comparison of one model
    run on both, the card first at each call: the card's top-k expert ids
    are kept in order of the calls, and the CPU's call of the same place
    takes them where its own top-k set differs.  A difference must be a
    near tie: the CPU's router logits of its k-th and (k+1)-th experts
    within LM_MAX_OF_SCALE of the row's largest |logit|, else the check
    fails (a fault routes far from a tie).  The probabilities are the CPU's
    own for the experts taken.  Prints how many rows differed."""
    import torch

    from repro_torch.models import moe as moe_mod

    route, queue, seen = moe_mod.route, [], {"rows": 0, "flipped": 0, "gap": 0.0}

    def pinned(p, x, cfg, train=False):
        out = route(p, x, cfg, train)
        if train:
            return out
        ids, probs = out
        if x.device.type != "cpu":
            queue.append(ids.detach().cpu())
            return out
        card = queue.pop(0)
        k = cfg.moe.top_k
        logits = x.float() @ p["router"].float()
        differ = (card.sort(dim=-1).values != ids.sort(dim=-1).values).any(dim=-1)
        seen["rows"] += ids.shape[0]
        if bool(differ.any()):
            top = logits.sort(dim=-1, descending=True).values
            gap = ((top[:, k - 1] - top[:, k]) / top.abs().amax(dim=-1))[differ]
            seen["flipped"] += int(differ.sum())
            seen["gap"] = max(seen["gap"], float(gap.max()))
            if float(gap.max()) > LM_MAX_OF_SCALE:
                fail(f"{arch}: the card's experts differ from the CPU's at a router gap of "
                     f"{float(gap.max()):.3g} of the largest logit: not a near tie")
            ids = torch.where(differ[:, None], card, ids)
            probs = torch.softmax(logits, dim=-1).gather(-1, ids)
            if cfg.moe.norm_topk:
                probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
        return ids, probs

    moe_mod.route = pinned
    try:
        yield
    finally:
        moe_mod.route = route
        print(f"{arch}: the card's and the CPU's top-k expert sets differ in {seen['flipped']} "
              f"of {seen['rows']} routed rows, each a near tie (largest gap "
              f"{seen['gap']:.3g} of the row's largest |router logit|, limit "
              f"{LM_MAX_OF_SCALE}); the CPU took the card's experts there")


def k5_inputs(torch, gen, b, hq, hk, s, d, lengths=None):
    """bf16 q (B, Hq, D), K and V (B, Hk, S, D), int32 lengths
    (``ragged_lengths(b, s)`` unless given)."""
    from repro_torch.kernels.tune import ragged_lengths

    dev = gen.device

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    lens = ragged_lengths(b, s) if lengths is None else lengths
    return (bf16(b, hq, d), bf16(b, hk, s, d), bf16(b, hk, s, d),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def tune_asks(cfg) -> dict:
    """The (family, shape) pairs ``ensure`` is asked for at qwen3-14b's
    shapes, by cache file: the planner counts every ``flash_decode_paged``
    entry of the file it is given, so the CLI's holds only its own."""
    hk, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    paged = dict(hk=hk, g=g, d=dh, page=16)
    return {"cli": [("flash_decode_paged", dict(b=b, **paged, npp=CLI_PAGES))
                    for b in CLI_DECODE_BATCHES],
            "long": [("flash_decode_paged", dict(b=LONG_BATCH, **paged, npp=LONG_PAGES)),
                     ("flash_decode", dict(b=LONG_BATCH, h=cfg.n_heads, s=LONG_PROMPT + LONG_GEN,
                                           d=dh)),
                     ("flash_attention", dict(b=1, h=cfg.n_heads, s=LONG_PROMPT, d=dh))]}


def plain_call(family, config, args):
    """The plain PyTorch version of the call ``measured_call`` gives for
    ``config``, on the same tensors."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    if family == "flash_attention":
        q, k, v = args
        lens = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32, device=q.device)
        return flash_fwd_ref(q, k, v, lens, causal=True, sm_scale=1.0 / (q.shape[3] ** 0.5),
                             q_offset=0, block_q=16, block_k=config["block_k"])
    if family == "flash_decode":
        q, k, v, lens = args
        return flash_decode_ref(q, k, v, lens, sm_scale=1.0 / (q.shape[2] ** 0.5),
                                block_k=config["block_k"])
    return fd_ops.paged_decode_attention(*args, impl="stream",
                                         pages_per_program=config["pages_per_program"])


def tuned_kernels_vs_plain(dev, cfg) -> dict:
    """Phase 9b (a): each kernel the tuner path times, at every shape and
    config it times it at, against its plain version; K5 also at qwen3-14b's
    grouped decode shape and edge lengths.  Returns each kernel's largest
    absolute error."""
    import torch

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.tune import SWEEP_SHAPES, candidates_for, measured_call
    from repro_torch.kernels.tune.roofline import prune

    phase("the tuner's kernels vs plain (bf16) at every shape and config the tuner path "
          "times them at")
    asks = [(family, SWEEP_SHAPES["smoke"][family]) for family in TUNED_KERNELS]
    for pairs in tune_asks(cfg).values():
        asks += pairs
    errs = {name: 0.0 for name in TUNED_KERNELS.values()}
    for family, shape in asks:
        name = TUNED_KERNELS[family]
        kept, _ = prune(family, shape, candidates_for(family, shape), "bfloat16")
        for est in kept:
            fn, args = measured_call(family, shape, "bfloat16", dev, est.config)
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain_call(family, est.config, args)
            errs[name] = max(errs[name], check_against_plain(
                torch, name, got, want, args[2], f"{family} {shape} {est.config}"))
            if family == "flash_decode":  # measured_call's fn is decode_attention_auto
                q, k, v, lens = args
                direct = fd_ops.flash_decode(q, k, v, lens, sm_scale=1.0 / (q.shape[2] ** 0.5),
                                             block_k=est.config["block_k"])
                if not torch.equal(direct, got):
                    fail("decode_attention_auto(use_kernel=True) differs from the direct K5 "
                         f"call at {shape} {est.config}")

    gen = torch.Generator(device=dev).manual_seed(5)
    gqa = dict(b=LONG_BATCH, hq=cfg.n_heads, hk=cfg.n_kv_heads, s=LONG_PROMPT + LONG_GEN,
               d=cfg.head_dim)
    # qwen3-14b's grouped decode shape, and lengths 0, 1, S, and S = 100 not a
    # multiple of block_k 64
    for shape, lengths, block_k in ((gqa, None, fd_ops.DEFAULT_DECODE_BLOCK_K),
                                    (dict(gqa, b=4, s=100), [0, 1, 100, 77], 64)):
        q, k, v, lens = k5_inputs(torch, gen, **shape, lengths=lengths)
        scale = shape["d"] ** -0.5
        got = fd_ops.flash_decode(q, k, v, lens, sm_scale=scale, block_k=block_k)
        torch.cuda.synchronize()
        want = flash_decode_ref(q, k, v, lens, sm_scale=scale, block_k=block_k)
        errs["flash_decode"] = max(errs["flash_decode"], check_against_plain(
            torch, "flash_decode", got, want, v, f"{shape} lengths={lens.tolist()} "
            f"block_k={block_k}"))
        if any(got[i].float().abs().any() for i, n in enumerate(lens.tolist()) if n == 0):
            fail("flash_decode: a row of length 0 is not zeros")
    print(f"tolerance: at most {MAX_BF16_ULPS} bf16 ulp of the output beyond "
          f"{V_ATOL_OF_MAX:.2e} max|v|; an empty row exactly 0; decode_attention_auto "
          "bit-identical to the direct K5 call")
    return errs


def tune_rows(cache) -> None:
    from repro_torch.kernels.tune import bench_rows

    for name, us, derived in bench_rows(cache):
        print(f"  {name},{us:.1f},{derived}")


def expected_sweep_launches(entries) -> dict:
    """Each kernel's launches for sweeping ``entries`` afresh: one warm-up
    and TUNE_ITERS timed calls per candidate the roofline keeps, each call
    one launch (``prefill_chunk``: one K3 launch per chunk of the prompt;
    ``sdca``: K1 only for its ``use_pallas: 1`` candidate)."""
    from repro_torch.kernels.tune import candidates_for
    from repro_torch.kernels.tune.roofline import prune

    kernel_of = {"flash_attention": "flash_fwd", "prefill_chunk": "flash_fwd",
                 "flash_decode": "flash_decode", "flash_decode_paged": "paged_decode",
                 "ssm_scan": "selective_scan", "sdca": "local_sdca"}
    out = {name: 0 for name in kernel_wrappers()}
    for e in entries:
        family, shape = e["family"], e["shape"]
        kept, _ = prune(family, shape, candidates_for(family, shape), e["dtype"])
        if len(kept) != e["candidates_swept"]:
            fail(f"{family}: swept {e['candidates_swept']}, the roofline keeps {len(kept)}")
        per_candidate = [-(-shape["p"] // est.config["chunk"]) if family == "prefill_chunk"
                         else int(est.config.get("use_pallas", 1)) for est in kept]
        out[kernel_of[family]] += (TUNE_ITERS + 1) * sum(per_candidate)
    return out


def tuner_path(dev, cfg, workdir: Path):
    """Phase 9b (b, c): the autotuner on the card.  Returns the kernels'
    launches over the whole path (the sweeps' calls, not the timings after
    them) and the two cache files."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.tune import ConfigCache, ensure, measured_call
    from repro_torch.kernels.tune import __main__ as tune_cli

    phase("main path 2: python -m repro_torch.kernels.tune --preset smoke --telemetry")
    smoke_file = workdir / "tune_smoke.json"
    reset_launches()
    entries = tune_cli.main(["--preset", "smoke", "--telemetry", "--iters", str(TUNE_ITERS),
                             "--cache", str(smoke_file)])
    counts = read_launches()
    expected = expected_sweep_launches(entries)
    print(f"launches {counts}, expected from the sweep's calls {expected}")
    if len(entries) != 6 or any(e["backend"] != "cuda" for e in entries):
        fail(f"the smoke sweep did not run all six families on the card: {entries}")
    if counts != expected or not counts["flash_decode"] or not counts["local_sdca"]:
        fail(f"smoke sweep launches {counts} != the sweep's calls {expected}")
    sdca = next(e for e in entries if e["family"] == "sdca")
    if sdca["config"] != {"use_pallas": 1}:
        fail(f"the sdca sweep picked {sdca['config']}, not the kernel")
    launches = dict(counts)

    gen = torch.Generator(device=dev).manual_seed(6)
    x, dt, a, b_ssm, c_ssm, d, h0 = scan_inputs(torch, gen, get_config(MAMBA), **PREFILL_SCAN)
    n = a.shape[1]
    chunks = (1, 32, 128, 4096)
    ref = None
    for d_block in ss_ops.KERNEL_D_BLOCKS:
        for chunk in chunks:
            h = h0.clone()
            y, _ = ss_ops.selective_scan(x, dt, a, b_ssm, c_ssm, d, h, chunk=chunk,
                                         d_block=d_block)
            torch.cuda.synchronize()
            if ref is None:
                ref = (y, h)
            if not (torch.equal(y, ref[0]) and torch.equal(h, ref[1])):
                fail(f"selective_scan at d_block {d_block}, chunk {chunk} differs from "
                     f"d_block {ss_ops.KERNEL_D_BLOCKS[0]}, chunk {chunks[0]}")
    print(f"selective_scan B=1 S={LONG_PROMPT} Dn={x.shape[2]} N={n}: y and state bit-identical "
          f"at every d_block {ss_ops.KERNEL_D_BLOCKS} (the tuner's candidates) and chunk "
          f"{chunks}")

    phase("autotuner: ensure at qwen3-14b's shapes (two cache files)")
    files = {"cli": workdir / "tune_qwen3_cli.json", "long": workdir / "tune_qwen3_long.json"}
    asks = tune_asks(cfg)
    caches = {which: ConfigCache(str(path)) for which, path in files.items()}
    reset_launches()
    t0 = time.perf_counter()
    for which, cache in caches.items():
        for family, shape in asks[which]:
            ensure(family, shape, device=dev, cache=cache, iters=TUNE_ITERS)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    ensured = [cache.entries[k] for cache in caches.values() for k in sorted(cache.entries)]
    expected = expected_sweep_launches(ensured)
    print(f"{len(ensured)} sweeps in {seconds:.1f} s; launches {counts}, expected from the "
          f"sweeps' calls {expected}")
    if counts != expected or not counts["flash_decode"]:
        fail(f"ensure launches {counts} != the sweeps' calls {expected}")
    for name in launches:
        launches[name] += counts[name]
    for which, cache in caches.items():
        print(f"{which} file {files[which].name}: {len(cache.entries)} entries")
        for key in sorted(cache.entries):
            e = cache.entries[key]
            fn, args = measured_call(e["family"], e["shape"], e["dtype"], dev, e["config"])
            dev_us = cuda_ms(lambda: fn(*args), reps=20) * 1e3
            print(f"  {e['family']} {e['shape']}: {e['config']} {e['us_per_call']:.1f} us wall "
                  f"clock, {dev_us:.1f} us by CUDA events over 20 calls back to back")
        tune_rows(cache)
    return {"launches": launches, "files": files}


def serve_cli_path(arch, n_layers, d_model, path_no, tune_cache=None, cfg=None):
    """Phases 10, 15 and 20: the CLI's --continuous path at full width, with
    ``--tune-cache`` when ``tune_cache`` is given, on ``cfg`` (the function
    behind the CLI takes a cut config from its caller) when given.  Returns
    the model and the kernels' launches."""
    import torch

    from repro_torch.launch import serve

    argv = ["--arch", arch, "--continuous"]
    if tune_cache is not None:
        argv += ["--tune-cache", str(tune_cache)]
    depth = "all layers" if cfg is None else f"cut to {cfg.n_layers} layers"
    phase(f"main path {path_no}: python -m repro_torch.launch.serve {' '.join(argv)} "
          f"(full width, {depth})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = serve.main(argv, cfg=cfg)
    except SystemExit as e:
        fail(f"the serve CLI exited with {e.code}")
    seconds = time.perf_counter() - t0
    counts = read_launches()
    warm, cold = result["engines"]
    cfg = warm.cfg
    prefills = sum(e.prefills_run for e in (warm, cold))
    steps = sum(e.stats()["decode_steps"] for e in (warm, cold))
    params = list(warm.lm.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in params) / 1e9:.3f} B parameters, weights "
          f"{sum(p.numel() * p.element_size() for p in params) / 1e9:.3f} GB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; CLI ran in {seconds:.1f} s; "
          f"{prefills} prefills, {steps} decode steps")
    for name, (per_prefill, per_step) in PATH_KERNELS[arch].items():
        terms = " + ".join(t for t, on in (("prefills", per_prefill), ("decode steps", per_step))
                           if on)
        print(f"{name} launches {counts[name]} = {cfg.n_layers} x ({terms})")
    if result["served"] != result["requests"] or result["served"] != 8:
        fail(f"served {result['served']}/{result['requests']}")
    if cfg.d_model != d_model or cfg.n_layers != n_layers:
        fail(f"the serve path did not run {arch} at full width")
    if prefills == 0 or steps == 0:
        fail("the serve path ran no prefill or no decode step")
    check_path_launches(arch, counts, cfg.n_layers, prefills, steps, f"{arch} CLI")
    if arch == MAMBA:  # K4's decode body runs the decode steps, its tile body the prefills
        step_launches = kernel_wrappers()["selective_scan"].step_launches
        print(f"selective_scan launches at S = 1 (the decode body) {step_launches} = "
              f"{cfg.n_layers} x decode steps; at S > 1 (the tile body) "
              f"{counts['selective_scan'] - step_launches} = {cfg.n_layers} x prefills")
        if step_launches != cfg.n_layers * steps:
            fail(f"{step_launches} decode-body launches, not {cfg.n_layers} x {steps}")
        counts = {**counts, "selective_scan_step": step_launches}
    if result["plan"] is None:
        fail("no capacity plan")
    if tune_cache is not None:
        from repro_torch.kernels.tune import ConfigCache

        entries = ConfigCache(str(tune_cache)).entries.values()
        tuned = next(e["config"]["pages_per_program"] for e in entries
                     if e["family"] == "flash_decode_paged" and e["shape"]["b"] == warm.max_batch)
        print(f"planner seeded with {result['tune_rows']} tuned kernel rows; paged decode ran "
              f"at pages_per_program={result['pages_per_program']} (the cache's b="
              f"{warm.max_batch} entry: {tuned})")
        if result["tune_rows"] != len(CLI_DECODE_BATCHES):
            fail(f"seeded with {result['tune_rows']} kernel rows, not {len(CLI_DECODE_BATCHES)}")
        if result["pages_per_program"] != tuned:
            fail(f"paged decode ran at {result['pages_per_program']}, not the tuned {tuned}")
    return warm.lm, counts


# The serve CLI's chunked + speculative run (phases 10b, 20b)
CLI_KNOBS = ["--prefill-chunk", "8", "--speculate", "3"]


def serve_cli_knobs_path(arch, lm, path_no, tune_cache=None) -> dict:
    """Phases 10b and 20b: the CLI's --continuous path with ``CLI_KNOBS``
    (and ``--tune-cache``) on ``lm``, the model the plain CLI run built: it
    must print bit_identical=yes against its one-token replay, run chunk
    steps and verify steps with accepted drafts, launch K3 once a layer per
    prefill and chunk step and K2 (or K2-latent) once a layer per decode and
    verify step, and, with a tuner cache, run the verify steps at the tuned
    pages_per_program.  Returns the kernels' launches and the run's
    numbers."""
    import numpy as np

    from repro_torch.launch import serve

    argv = ["--arch", arch, "--continuous"] + CLI_KNOBS
    if tune_cache is not None:
        argv += ["--tune-cache", str(tune_cache)]
    phase(f"main path {path_no}: python -m repro_torch.launch.serve {' '.join(argv)} "
          f"(full width, {lm.cfg.n_layers} layers, the model of the plain run)")
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = serve.main(argv, lm=lm)
    except SystemExit as e:
        fail(f"the serve CLI with {' '.join(CLI_KNOBS)} exited with {e.code}")
    seconds = time.perf_counter() - t0
    counts = read_launches()
    warm, cold = result["engines"]
    engines = (warm, cold, result["baseline"])
    prefills = sum(e.prefills_run for e in engines)
    chunks = sum(e.stats().get("prefill_chunks", 0) for e in engines)
    steps = sum(e.stats()["decode_steps"] for e in engines)
    stats = warm.stats()
    evs = warm.events("serve_step")

    def median_ms(op):
        times = [e.step_s for e in evs if e.op == op]
        return float(np.median(times)) * 1e3 if times else None

    out = {"arch": arch, "bit_identical": result["bit_identical"], "cli_s": seconds,
           "prefills": prefills, "chunk_steps": chunks, "decode_and_verify_steps": steps,
           "verify_steps": stats["verify_steps"], "draft_proposed": stats["draft_proposed"],
           "draft_accepted": stats["draft_accepted"],
           "spec_accept_rate": stats["spec_accept_rate"],
           "chunk_step_ms_median": median_ms("prefill"),
           "decode_step_ms_median": median_ms("decode"),
           "verify_step_ms_median": median_ms("verify"),
           "verify_pages_per_program": warm.verify_pages_per_program,
           **{f"{name}_launches": counts[name] for name in PATH_KERNELS[arch]}}
    print(json.dumps({"cli_chunked_speculative": out}))
    for name, (per_prefill, per_step) in PATH_KERNELS[arch].items():
        terms = ("prefills + chunk steps" if per_prefill else "decode steps + verify steps")
        print(f"{name} launches {counts[name]} = {lm.cfg.n_layers} x ({terms})")
    if result["bit_identical"] is not True:
        fail("the chunked + speculative CLI run is not bit-identical to its replay")
    if chunks == 0 or stats["verify_steps"] == 0 or stats["draft_accepted"] == 0:
        fail(f"{chunks} chunk steps, {stats['verify_steps']} verify steps, "
             f"{stats['draft_accepted']} drafts accepted: each must be at least 1")
    check_path_launches(arch, counts, lm.cfg.n_layers, prefills + chunks, steps,
                        f"{arch} CLI {' '.join(CLI_KNOBS)}")
    if tune_cache is not None:
        from repro_torch.kernels.tune import ConfigCache

        tuned = next(e["config"]["pages_per_program"]
                     for e in ConfigCache(str(tune_cache)).entries.values()
                     if e["family"] == "flash_decode_paged" and e["shape"]["b"] == warm.max_batch)
        print(f"verify steps ran paged decode at pages_per_program="
              f"{warm.verify_pages_per_program} (the cache's b={warm.max_batch} entry: {tuned})")
        if warm.verify_pages_per_program != tuned:
            fail(f"verify steps ran at {warm.verify_pages_per_program}, not the tuned {tuned}")
    return {"launches": counts, **out}


def chunked_long_run(lm) -> dict:
    """Phase 11c: ``LONG_BATCH`` prompts of ``LONG_PROMPT`` tokens arriving
    together, 16 tokens each, through a plain engine and through one at
    --prefill-chunk 256, the same prompts: equal token streams, each
    engine's launches, the first tokens' times (end of the step that
    emitted them), join-to-first-token in steps, decode steps while chunks
    stream, and a chunk step against a monolithic block's prefill."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeEngine

    chunk, gen_tokens = 256, 16
    phase(f"chunked long run ({QWEN}): {LONG_BATCH} x {LONG_PROMPT}-token prompts together, "
          f"{gen_tokens} tokens each, --prefill-chunk {chunk} against the plain engine")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, lm.cfg.vocab_size, LONG_PROMPT) for _ in range(LONG_BATCH)]

    def serve(prefill_chunk):
        eng = ServeEngine("", lm=lm, max_batch=LONG_BATCH, max_seq=LONG_PROMPT + LONG_GEN,
                          prefill_chunk=prefill_chunk)
        reqs = [eng.submit(p, gen_tokens) for p in prompts]
        reset_launches()
        torch.cuda.synchronize()
        t0, ends = time.perf_counter(), []
        while not eng.scheduler.drained:
            eng.step()  # every step that runs work reads its logits back
            ends.append(time.perf_counter())
        counts = read_launches()
        stats = eng.stats()
        prefills = eng.prefills_run + stats.get("prefill_chunks", 0)
        check_path_launches(QWEN, counts, lm.cfg.n_layers, prefills, stats["decode_steps"],
                            f"chunked long run, prefill_chunk={prefill_chunk}")
        ttft = [(ends[r.first_token_step] - t0) * 1e3 for r in reqs]
        return eng, reqs, stats, counts, ttft, ends[-1] - t0

    plain, plain_reqs, plain_stats, plain_counts, plain_ttft, plain_wall = serve(None)
    eng, reqs, stats, counts, ttft, wall = serve(chunk)
    if [r.generated for r in reqs] != [r.generated for r in plain_reqs]:
        fail("the chunked long run's token streams differ from the plain engine's")
    evs = eng.events("serve_step")
    chunk_steps = {e.step for e in evs if e.op == "prefill"}
    streaming = [e.step_s for e in evs if e.op == "decode" and e.step in chunk_steps]
    decode_alone = [e.step_s for e in evs if e.op == "decode" and e.step not in chunk_steps]
    chunk_ms = [e.step_s * 1e3 for e in evs if e.op == "prefill"]
    block_ms = [r.prefill_s * 1e3 for r in plain_reqs]
    out = {
        "prompts": LONG_BATCH, "prompt_tokens": LONG_PROMPT, "gen_tokens": gen_tokens,
        "prefill_chunk": chunk, "bit_identical": True,
        "ttft_ms_p50": float(np.median(ttft)), "ttft_ms_max": float(max(ttft)),
        "plain_ttft_ms_p50": float(np.median(plain_ttft)),
        "join_to_first_token_p50": stats["join_to_first_token_p50"],
        "join_to_first_token_p99": stats["join_to_first_token_p99"],
        "plain_join_to_first_token_p99": plain_stats["join_to_first_token_p99"],
        "chunk_steps": stats["prefill_chunks"],
        "chunk_step_ms_median": float(np.median(chunk_ms)),
        "monolithic_block_prefill_ms_median": float(np.median(block_ms)),
        "decode_steps_while_chunks_stream": len(streaming),
        "decode_step_ms_median_while_chunks_stream":
            float(np.median(streaming)) * 1e3 if streaming else None,
        "decode_step_ms_median_alone": float(np.median(decode_alone)) * 1e3,
        # what the decode batch waits between tokens: the step's chunk and
        # its decode step together
        "step_ms_median_while_chunks_stream": float(np.median(
            [sum(e.step_s for e in evs if e.step == step) for step in chunk_steps
             if any(e.op == "decode" and e.step == step for e in evs)])) * 1e3
        if streaming else None,
        "plain_decode_step_ms_median": float(np.median(
            [e.step_s for e in plain.events("serve_step") if e.op == "decode"])) * 1e3,
        "wall_s": wall, "plain_wall_s": plain_wall,
        "flash_fwd_launches": counts["flash_fwd"],
        "paged_decode_launches": counts["paged_decode"],
        "plain_flash_fwd_launches": plain_counts["flash_fwd"],
    }
    print(json.dumps({"chunked_long_run": out}))
    print(f"a chunk of {chunk} tokens runs one {eng.rt.prefill_rows}-row block: "
          f"{out['chunk_step_ms_median']:.2f} ms a chunk step against "
          f"{out['monolithic_block_prefill_ms_median']:.2f} ms for a whole prompt's block")
    return out


def long_serve_run(arch, lm, tune_cache=None):
    """Phases 11 and 16: 8 requests of 1024-token prompts arriving together,
    64 generated tokens each, max_batch 8, at full width; with ``tune_cache``
    the process's tuner cache points at it, so paged decode runs at its
    tuned pages_per_program."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    phase(f"long serve run ({arch}): {LONG_BATCH} x {LONG_PROMPT}-token prompts, {LONG_GEN} "
          f"tokens each, max_batch {LONG_BATCH}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine("", lm=lm, max_batch=LONG_BATCH, max_seq=LONG_PROMPT + LONG_GEN)
    ppp = None
    if tune_cache is not None:
        from repro_torch.kernels import tune
        from repro_torch.kernels.flash_decode.ops import pages_per_program_for

        tune.set_default_cache(str(tune_cache))
        cfg = lm.cfg
        ppp = pages_per_program_for(LONG_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                    eng.page_size, eng.pages_per_seq, lm.dtype, "cuda")
        shape = {"b": LONG_BATCH, "hk": cfg.n_kv_heads, "g": cfg.n_heads // cfg.n_kv_heads,
                 "d": cfg.head_dim, "page": eng.page_size, "npp": eng.pages_per_seq}
        entry = tune.lookup("flash_decode_paged", shape, lm.dtype, "cuda")
        print(f"paged decode: pages_per_program={ppp} from {tune_cache.name} at {shape}")
        if entry is None or entry["pages_per_program"] != ppp:
            fail(f"the long run's decode shape {shape} has no tuned entry in {tune_cache}")
    rng = np.random.RandomState(1)
    reqs = [eng.submit(rng.randint(0, lm.cfg.vocab_size, LONG_PROMPT), LONG_GEN)
            for _ in range(LONG_BATCH)]
    reset_launches()
    profiled_steps = range(48, 52)
    # a MoE's expert products are batched products like the attention's
    # absorbed einsums; a second window traces the host's operators with
    # their shapes to tell them apart, at the cost of a slower host there
    split_steps = range(54, 56) if lm.cfg.uses_moe else range(0)
    t0 = time.perf_counter()
    prof = split = None
    while not eng.scheduler.drained:
        if eng.step_count == profiled_steps.start:
            # device activity only: tracing the host's operators as well
            # slows the host, which sets this step's time
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        if split_steps and eng.step_count == split_steps.start:
            split = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=True)
            split.__enter__()
        eng.step()
        if eng.step_count == profiled_steps.stop:
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t_prof) * 1e3
            prof.__exit__(None, None, None)
        if split_steps and eng.step_count == split_steps.stop:
            torch.cuda.synchronize()
            split.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_launches()
    if any(len(r.generated) != LONG_GEN for r in reqs):
        fail("the long run did not generate every token")
    ttft = np.cumsum([r.prefill_s for r in sorted(reqs, key=lambda r: r.rid)])
    steps = [e for e in eng.events("serve_step") if e.batch > 0]
    timed = [e.step_s for e in steps if e.batch == LONG_BATCH and e.step not in profiled_steps
             and e.step not in split_steps]
    stats = eng.stats()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = {name: sum(e.self_device_time_total for e in events if name in e.key) / 1e3
                 for name in PATH_KERNELS[arch]}
    gemm_ms = sum(e.self_device_time_total for e in events if is_gemm(e.key)) / 1e3
    out = {
        "arch": arch,
        "ttft_ms_p50": float(np.median(ttft)) * 1e3,
        "ttft_ms_max": float(ttft.max()) * 1e3,
        "prefill_ms_mean": float(np.mean([r.prefill_s for r in reqs])) * 1e3,
        "decode_step_ms_b8_median": float(np.median(timed)) * 1e3,
        "decode_step_ms_b8_mean": float(np.mean(timed)) * 1e3,
        "decode_tok_per_s": stats["decode_tok_per_s"],
        "tokens_per_s_end_to_end": LONG_BATCH * LONG_GEN / wall,
        "wall_s": wall,
        "peak_memory_gb": peak / 1e9,
        **{f"{name}_launches": counts[name] for name in PATH_KERNELS[arch]},
        "pages_per_program": ppp,
        "profiled_decode_steps": len(profiled_steps),
        "profiled_wall_ms": prof_wall_ms,
        "profiled_device_busy_ms": busy_ms,
        "profiled_device_busy_share": busy_ms / prof_wall_ms,
        # the profiled steps' device time over the unprofiled steps' time
        "device_busy_share_of_median_step": busy_ms / len(profiled_steps)
        / (float(np.median(timed)) * 1e3),
        **{f"profiled_{name}_ms": ms for name, ms in kernel_ms.items()},
        "profiled_gemm_ms": gemm_ms,
    }
    if split is not None:
        out["moe_split"] = moe_split(split, lm.cfg, len(split_steps))
    print(json.dumps({"long_run": out}))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  device {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:5d}  {e.key[:90]}")
    check_path_launches(arch, counts, lm.cfg.n_layers, LONG_BATCH, stats["decode_steps"],
                        f"{arch} long run")
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    return out


def is_gemm(kernel: str) -> bool:
    name = kernel.lower()
    return any(part in name for part in ("gemm", "gemv", "cutlass", "nvjet"))


def moe_split(prof, cfg, n_steps: int) -> dict:
    """Device ms a decode step in ``prof`` (host operators traced with their
    shapes): the MoE's expert products (``aten::bmm`` over the E experts),
    the other matrix products, K2's latent form, and all kernels."""
    from torch.autograd import DeviceType

    shaped = prof.key_averages(group_by_input_shape=True)
    moe_ms = sum(e.device_time_total for e in shaped if e.key == "aten::bmm"
                 and e.input_shapes and list(e.input_shapes[0][:1]) ==
                 [cfg.moe.n_routed_experts]) / 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    gemm_ms = sum(e.self_device_time_total for e in kernels if is_gemm(e.key)) / 1e3
    latent_ms = sum(e.self_device_time_total for e in kernels
                    if "paged_latent_decode" in e.key) / 1e3
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"steps": n_steps, "moe_products_ms_per_step": moe_ms / n_steps,
            "other_gemm_ms_per_step": (gemm_ms - moe_ms) / n_steps,
            "paged_latent_decode_ms_per_step": latent_ms / n_steps,
            "device_ms_per_step": device_ms / n_steps}


def prefill_row_blocks(lm):
    """Phase 11b: what the engine's prefill row blocks cost and keep."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.serve import ServeEngine

    max_seq = LONG_PROMPT + LONG_GEN
    phase(f"prefill over row blocks at full width (max_seq {max_seq})")
    eng = ServeEngine("", lm=lm, max_batch=2, max_seq=max_seq, collect_logits=True)
    rows = eng.rt.prefill_rows
    rng = np.random.RandomState(2)
    vocab = lm.cfg.vocab_size

    def prefill_ms(n_prompt, n_rows, block):
        tokens = torch.zeros((1, n_rows), dtype=torch.int64)
        tokens[0, :n_prompt] = torch.from_numpy(rng.randint(0, vocab, n_prompt))
        tokens = tokens.to(lm.device)
        rt = dataclasses.replace(eng.rt, prefill_rows=block)
        times = []
        for _ in range(4):  # the first is warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.prefill(tokens, n_valid=n_prompt, rt=rt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    short, blocks = 32, (256, 512, 1024)
    out = {
        "engine_block_rows": rows,
        f"prefill_ms_{short}_tokens": {
            "unpadded": prefill_ms(short, short, short),
            **{f"block_{b}": prefill_ms(short, b, b) for b in blocks + (max_seq,)}},
        f"prefill_ms_{LONG_PROMPT}_tokens": {
            f"block_{b}": prefill_ms(LONG_PROMPT, LONG_PROMPT, b) for b in blocks},
    }
    print(json.dumps({"prefill_row_blocks": out}))

    head = rng.randint(0, vocab, 2 * eng.page_size)
    prompt_a = np.concatenate([head, rng.randint(0, vocab, 5)])
    prompt_b = np.concatenate([head, rng.randint(0, vocab, rows + 12)])
    eng.submit(prompt_a, 4)
    eng.run()
    r_warm = eng.submit(prompt_b, 4)
    eng.run()
    cold = ServeEngine("", lm=lm, max_batch=2, max_seq=max_seq, collect_logits=True)
    r_cold = cold.submit(prompt_b, 4)
    cold.run()
    exact = len(r_warm.logits_trace) == len(r_cold.logits_trace) == 4 and all(
        np.array_equal(a, b) for a, b in zip(r_warm.logits_trace, r_cold.logits_trace))
    print(f"prefix reuse across row blocks: prompts of {len(prompt_a)} and {len(prompt_b)} "
          f"tokens ({rows}-row blocks), shared_pages={r_warm.n_shared_pages} "
          f"bit_identical={'yes' if exact else 'NO'}")
    if r_warm.n_shared_pages != 2 or not exact:
        fail("prefix reuse across prefill row blocks is not bit-identical")
    return out


def serve_kernel_timings(dev, cfg, tuned_ppp):
    """Phase 12.  Returns {kernel: (ms, plain_ms, library_ms, bound_ms,
    bound_by, shape)} for K2 at the long run's decode shape and
    K2_ROW_PAGES_PER_PROGRAM (the tuned value printed too), K3 at Sq = Skv =
    2048 (1024 printed too) and K5 at the tuner's qwen3-14b decode shape
    (the grouped one printed too)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import paged_decode_stream

    phase("K3, K2 and K5 timings (CUDA events, after warm-up)")
    hk, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    hq = hk * g
    gen = torch.Generator(device=dev).manual_seed(1)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    lib3 = fa_ops.LIBRARY.load()
    timings = {}
    for s in (1024, 2048):
        q, k, v = bf16(1, hq, s, d), bf16(1, hk, s, d), bf16(1, hk, s, d)
        lens = torch.tensor([s], dtype=torch.int32, device=dev)
        ms64 = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, lens, sm_scale=d ** -0.5, block_k=64),
                       reps=10)
        ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, lens, sm_scale=d ** -0.5), reps=10)
        plain = cuda_ms(lambda: flash_fwd_ref(q, k, v, lens, causal=True, sm_scale=d ** -0.5,
                                              q_offset=0, block_q=16, block_k=16),
                        reps=2, warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True), reps=20)
        nbytes = (2 * hq + 2 * hk) * s * d * 2  # q, k, v read once, out written once
        flops = 4 * hq * d * s * (s + 1) // 2  # the causal pairs this input needs
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"flash_fwd Sq=Skv={s} Hq={hq} Hk={hk} D={d}: kernel {ms:.3f} ms at block_k 16 "
              f"({ms64:.3f} ms at block_k 64), plain {plain:.3f} ms, SDPA {lib:.3f} ms, bound "
              f"{bound:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s = {ops_ms:.4f} ms; "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms:.4f} ms), kernel at "
              f"{100 * bound / ms:.2f}% of bound; grid {-(-s // 128)} x {hq} x 1 blocks of 256 "
              f"threads, {lib3.flash_fwd_smem_bytes(g, d, d, 16)} bytes of shared memory a "
              f"block; the p split doubles P V: {2 * flops / 1e9:.2f} GFLOP on the tensor cores")
        timings["flash_fwd"] = (ms, plain, lib, bound, by, f"Sq=Skv={s}")

    b, ctx, page = LONG_BATCH, LONG_PROMPT + LONG_GEN, 16
    npp = ctx // page
    n_pages = 1 + b * npp
    kp, vp = bf16(n_pages, hk, page, d), bf16(n_pages, hk, page, d)
    tables = random_pages(torch, gen, dev, b, npp, n_pages)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = bf16(b, hk, g, d)
    idx = tables.long()
    k_dense = kp[idx].movedim(2, 1).reshape(b, hk, ctx, d).contiguous()
    v_dense = vp[idx].movedim(2, 1).reshape(b, hk, ctx, d).contiguous()
    q_sdpa = q.reshape(b, hq, 1, d)

    def sdpa():
        return F.scaled_dot_product_attention(q_sdpa, k_dense, v_dense, enable_gqa=True)

    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    lib = graph_ms(sdpa, reps=50, flush=flush)
    lib_warm = graph_ms(sdpa, reps=50)
    lib_eager = cuda_ms(sdpa, reps=50)
    nbytes = 2 * b * hk * ctx * d * 2 + 2 * b * hq * d * 2 + b * npp * 4 + b * 4
    flops = 4 * b * hq * ctx * d
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib2 = fd_ops.LIBRARY.load()
    for ppp in dict.fromkeys((K2_ROW_PAGES_PER_PROGRAM, K2_ONE_TILE_PAGES_PER_PROGRAM,
                              tuned_ppp)):
        def call():
            return fd_ops.paged_decode(q, kp, vp, lens, tables, scale=d ** -0.5,
                                       pages_per_program=ppp)

        ms = graph_ms(call, reps=50, flush=flush)
        warm = graph_ms(call, reps=50)
        eager = cuda_ms(call, reps=50)
        plain = cuda_ms(lambda: paged_decode_stream(q, kp, vp, lens, tables, scale=d ** -0.5,
                                                    pages_per_program=ppp), reps=5, warmup=1)
        splits = lib2.paged_decode_splits(ctx, ppp * page)
        print(f"paged_decode B={b} context={ctx} Hk={hk} G={g} D={d} ppp={ppp}: kernel "
              f"{ms:.4f} ms (CUDA graph, L2 flushed; {warm:.4f} ms with the pool in the L2; "
              f"eager calls back to back {eager:.4f} ms, the host's launch time), plain "
              f"{plain:.3f} ms, SDPA on the gathered dense KV {lib:.4f} ms (CUDA graph, L2 "
              f"flushed; {lib_warm:.4f} ms warm; eager {lib_eager:.4f} ms), bound {bound:.4f} "
              f"ms ({by}: "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s), kernel at {100 * bound / ms:.2f}% of bound; "
              f"grid {splits} splits x {hk} x {b} = {splits * hk * b} blocks of 256 threads on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
              f"{lib2.paged_decode_smem_bytes(g, d, ppp * page)} bytes of shared memory a "
              f"block, then the combine's {hk * b} blocks"
              f"{' (the tuned value)' if ppp == tuned_ppp else ''}")
        if ppp == K2_ROW_PAGES_PER_PROGRAM:
            timings["paged_decode"] = (ms, plain, lib, bound, by,
                                       f"B={b} context={ctx} ppp={ppp}",
                                       {"timed_by": GRAPH_COLD_L2, "eager_ms": eager,
                                        "warm_l2_ms": warm, "library_warm_l2_ms": lib_warm})
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fd_ops.paged_decode(q, kp, vp, lens, tables, scale=d ** -0.5,
                                pages_per_program=K2_ROW_PAGES_PER_PROGRAM)
        torch.cuda.synchronize()
    split_us = {"combine" if "combine" in e.key else "split": e.self_device_time_total / e.count
                for e in prof.key_averages() if "paged_decode" in e.key}
    print(f"paged_decode ppp={K2_ROW_PAGES_PER_PROGRAM}, device time a call (profiler, 20 calls): "
          f"split kernel {split_us.get('split', 0.0):.2f} us, combine kernel "
          f"{split_us.get('combine', 0.0):.2f} us")
    timings["flash_decode"] = decode_kernel_timings(dev, cfg, flush)
    return timings


def decode_kernel_timings(dev, cfg, flush):
    """K5 at the wrapper's default tile against its bound, with ragged
    lengths: the valid K and V read once per KV head, q and lengths read and
    the output written once; 4 D operations per valid position and query
    head.  Timed at qwen3-14b's grouped decode shape (Hk 8) and at the
    tuner's (one KV head per query head, as the path runs it), whose times
    are returned; kernel and SDPA timed from a CUDA graph with the L2
    flushed by reads of ``flush`` (``graph_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    block_k = fd_ops.DEFAULT_DECODE_BLOCK_K
    b, hq, s, d = LONG_BATCH, cfg.n_heads, LONG_PROMPT + LONG_GEN, cfg.head_dim
    for hk in (cfg.n_kv_heads, hq):  # the row's is the tuner's, one KV head a query head
        q, k, v, lens = k5_inputs(torch, gen, b, hq, hk, s, d)
        scale = d ** -0.5
        valid = int(lens.sum())
        nbytes = 2 * valid * hk * d * 2 + 2 * b * hq * d * 2 + b * 4
        flops = 4 * valid * hq * d
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        q_sdpa = q.reshape(b, hq, 1, d)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q_sdpa, k, v, attn_mask=mask,
                                                              enable_gqa=True), reps=50,
                       flush=flush)
        plain = cuda_ms(lambda: flash_decode_ref(q, k, v, lens, sm_scale=scale, block_k=block_k),
                        reps=5, warmup=1)

        def call():
            return fd_ops.flash_decode(q, k, v, lens, sm_scale=scale, block_k=block_k)

        ms = graph_ms(call, reps=100, flush=flush)
        warm = graph_ms(call, reps=100)
        eager = cuda_ms(call, reps=100)
        lib5 = fd_ops.DECODE_LIBRARY.load()
        splits = lib5.flash_decode_splits(s, block_k)
        print(f"flash_decode B={b} Hq={hq} Hk={hk} S={s} D={d} lengths {lens.tolist()} "
              f"(sum {valid}) block_k={block_k}: kernel {ms:.4f} ms (CUDA graph, L2 flushed; "
              f"{warm:.4f} ms warm; eager calls back to back {eager:.4f} ms), plain "
              f"{plain:.3f} ms, SDPA with a length mask {lib:.4f} ms (CUDA graph, L2 flushed), "
              f"bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB at 3.35 TB/s; "
              f"{flops / 1e6:.1f} MFLOP), kernel at {100 * bound / ms:.2f}% of bound; grid "
              f"{splits} x {hk} x {b} blocks, {lib5.flash_decode_smem_bytes(hq // hk, d, block_k)} "
              f"bytes of shared memory a block")
    return (ms, plain, lib, bound, by, f"B={b} Hq={hq} Hk={hk} S={s} block_k={block_k}",
            {"timed_by": GRAPH_COLD_L2, "eager_ms": eager, "warm_l2_ms": warm})


def scan_inputs(torch, gen, cfg, bt, s, n_valid=None):
    """K4's inputs at ``cfg``'s widths, as the model makes them: x and
    x_proj's output in bf16 with B and C strided views of the latter, dt
    log-uniform in [1e-3, 1e-1] (the range dt's bias is drawn from),
    A = -exp(A_log) = -(1..N), D = 1, a nonzero float32 state; dt and x zero
    from ``n_valid`` on, as the engine pads."""
    import math

    mc = cfg.mamba
    dn, n, dtr = mc.resolved_d_inner(cfg.d_model), mc.d_state, mc.resolved_dt_rank(cfg.d_model)
    dev = gen.device
    x = torch.randn((bt, s, dn), generator=gen, device=dev).to(torch.bfloat16)
    u = torch.rand((bt, s, dn), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    if n_valid is not None:
        x[:, n_valid:] = 0
        dt[:, n_valid:] = 0
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(dn, n).contiguous()
    xdb = torch.randn((bt, s, dtr + 2 * n), generator=gen, device=dev).to(torch.bfloat16)
    _, b_ssm, c_ssm = xdb.split([dtr, n, n], dim=-1)
    d = torch.ones(dn, device=dev)
    h0 = 0.1 * torch.randn((bt, dn, n), generator=gen, device=dev)
    return x, dt, a, b_ssm, c_ssm, d, h0


def scan_bound(bt, s, dn, n, n_valid=None):
    """(bound ms, by what, MB, exponentials) of one selective scan: x and y
    (bf16), dt (float32) and B, C (bf16) read or written once, A, D and the
    state's read and write; one exponential and about 7 float32 operations
    per (t, d, n) of the steps this input needs (a padded step with dt = 0
    needs none)."""
    steps = bt * (s if n_valid is None else n_valid)
    nbytes = (2 + 2 + 4) * bt * s * dn + 2 * 2 * bt * s * n + 4 * (dn * n + dn) \
        + 2 * 4 * bt * dn * n
    n_exp = steps * dn * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n_exp / EXP_PER_S, 7 * n_exp / F32_FLOPS_PER_S) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes / 1e6, n_exp


PREFILL_SCAN = dict(bt=1, s=LONG_PROMPT, n_valid=LONG_PROMPT - 24)
DECODE_SCAN = dict(bt=LONG_BATCH, s=1, n_valid=None)
# Phase 13's further cases: the long run's max_seq, 1088 positions (four
# tiles of 256 and 64 positions of a fifth), padded from 1000; S not a
# multiple of the tile; one sequence's decode step; and every other state
# size the kernel takes, at the model's widths, across a tile boundary
SCAN_CASES = (PREFILL_SCAN, DECODE_SCAN,
              dict(bt=1, s=LONG_PROMPT + LONG_GEN, n_valid=1000),
              dict(bt=2, s=300, n_valid=None),
              dict(bt=1, s=1, n_valid=None))
SCAN_STATE_SIZES = (4, 8, 16, 32)


def scan_kernel_vs_plain(dev, cfg):
    """Phase 13.  Returns K4's largest absolute errors (state or output) of
    its tile body (S > 1) and its decode body (S = 1)."""
    import torch

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    mc = cfg.mamba
    phase(f"K4 vs plain ({cfg.name}: Dn {mc.resolved_d_inner(cfg.d_model)}, N {mc.d_state}, "
          f"bf16 x)")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"tile": 0.0, "step": 0.0}
    cases = [(cfg, shape) for shape in SCAN_CASES]
    cases += [(dataclasses.replace(cfg, mamba=dataclasses.replace(mc, d_state=n)),
               dict(bt=2, s=300, n_valid=290)) for n in SCAN_STATE_SIZES if n != mc.d_state]
    for case_cfg, shape in cases:
        x, dt, a, b_ssm, c_ssm, d, h0 = scan_inputs(torch, gen, case_cfg, **shape)
        h = h0.clone()
        y, h_out = ops.selective_scan(x, dt, a, b_ssm, c_ssm, d, h)
        torch.cuda.synchronize()
        want_y, want_h = selective_scan_ref(x, dt, a, b_ssm, c_ssm, d, h0)
        err_h = float((h - want_h).abs().max())
        scale_h = float(want_h.abs().max())
        atol = SCAN_RTOL_OF_MAX * float(want_y.float().abs().max())
        ulps = bf16_ulps(y, want_y, atol)
        err_y = float((y.float() - want_y.float()).abs().max())
        print(f"selective_scan B={shape['bt']} S={shape['s']} N={a.shape[1]} "
              f"n_valid={shape['n_valid']} B/C strides {tuple(b_ssm.stride())}: "
              f"max|dh|={err_h:.3e} (max|h|={scale_h:.3e}, {err_h / scale_h:.2e} of it), "
              f"max|dy|={err_y:.3e}, {bf16_ulps(y, want_y):.0f} bf16 ulp, {ulps:.0f} bf16 ulp "
              f"beyond {atol:.2e}; state updated in place: {h_out is h}")
        if not (torch.isfinite(y.float()).all() and torch.isfinite(h).all()):
            fail("selective_scan output is not finite")
        if h_out is not h or err_h > SCAN_RTOL_OF_MAX * scale_h or ulps > MAX_BF16_ULPS:
            fail(f"selective_scan disagrees with its plain version at {shape}, "
                 f"N {a.shape[1]}")
        body = "step" if shape["s"] == 1 else "tile"
        worst[body] = max(worst[body], err_h, err_y)
    print(f"tolerance: |dh| <= {SCAN_RTOL_OF_MAX:.2e} max|h|; y within {MAX_BF16_ULPS} bf16 ulp "
          f"beyond {SCAN_RTOL_OF_MAX:.2e} max|y|")
    return worst["tile"], worst["step"]


def scan_kernel_timings(dev, cfg):
    """Phase 17.  Returns {"prefill": row, "decode": row}, each (ms,
    plain_ms, library_ms, bound_ms, bound_by, shape, extra) for K4 at the
    prefill shape (its tile body) and the decode shape (its decode body).
    Back-to-back calls at the decode shape are bound by the host (the
    wrapper's checks and the ctypes call), so each body's own device time is
    also read from a profiler window, by kernel name (its total over the
    launches the window recorded, each kernel's name and launches in the
    window printed), and from a CUDA graph of 20 calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    phase("K4 timings (CUDA events, after warm-up)")
    mc = cfg.mamba
    dn, n = mc.expand * cfg.d_model, mc.d_state
    gen = torch.Generator(device=dev).manual_seed(4)
    timings = {}
    for label, shape, reps, body in (("prefill", PREFILL_SCAN, 20, "selective_scan_tile_kernel"),
                                     ("decode", DECODE_SCAN, 200, "selective_scan_step_kernel")):
        x, dt, a, b_ssm, c_ssm, d, h0 = scan_inputs(torch, gen, cfg, **shape)
        h = h0.clone()
        ms = cuda_ms(lambda: ops.selective_scan(x, dt, a, b_ssm, c_ssm, d, h), reps=reps)
        plain = cuda_ms(lambda: selective_scan_ref(x, dt, a, b_ssm, c_ssm, d, h0),
                        reps=2 if shape["s"] > 1 else 20, warmup=1)
        bound, by, mb, n_exp = scan_bound(shape["bt"], shape["s"], dn, n, shape["n_valid"])
        device_ms = 0.0
        for _ in range(3):  # a profiler window now and then records no kernel: take another
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    ops.selective_scan(x, dt, a, b_ssm, c_ssm, d, h)
                torch.cuda.synchronize()
            seen = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            recorded = sum(e.count for e in seen if body in e.key)
            if recorded:
                device_ms = sum(e.self_device_time_total for e in seen
                                if body in e.key) / 1e3 / recorded
                break
        if device_ms <= 0:
            fail(f"three profiler windows saw no {body}")
        in_graph = graph_ms(lambda: ops.selective_scan(x, dt, a, b_ssm, c_ssm, d, h), reps=20)
        print("  profiler window of 20 calls: " + "; ".join(
            f"{e.key[:90]} x {e.count}, {e.self_device_time_total / 1e3:.4f} ms" for e in seen))
        print(f"selective_scan {label} B={shape['bt']} S={shape['s']} Dn={dn} N={n}: kernel "
              f"{ms:.4f} ms a call by CUDA events, {device_ms:.4f} ms of device time a launch "
              f"({body}, profiler, over {recorded} recorded launches), {in_graph:.4f} ms a call "
              f"from a CUDA graph, plain {plain:.3f} ms, bound {bound:.4f} ms ({by}: "
              f"{mb:.2f} MB at 3.35 TB/s; {n_exp / 1e6:.1f} M exponentials at "
              f"{EXP_PER_S / 1e12:.2f} T/s), kernel at {100 * bound / ms:.2f}% of bound "
              f"({100 * bound / device_ms:.2f}% by device time); no single PyTorch call "
              "computes a selective scan")
        timings[label] = (ms, plain, None, bound, by, f"B={shape['bt']} S={shape['s']}",
                          {"timed_by": EAGER, "device_ms": device_ms, "graph_ms": in_graph,
                           "body": body})
    return timings


def scan_times_main(checkout: Path) -> None:
    """``python3 chip_smoke.py --scan-times DIR``: phases 13 and 17 (K4
    against its plain version, then its times: CUDA events, profiler device
    time by kernel name, CUDA graph) with K4 built from the checkout at DIR,
    the times printed as one JSON line, so that two versions of K4 compare
    within one call."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.configs import get_config

    print(f"card: {nvidia_smi_line()}; K4 from {checkout}")
    dev, cfg = torch.device("cuda"), get_config(MAMBA)
    scan_kernel_vs_plain(dev, cfg)
    times = scan_kernel_timings(dev, cfg)
    print(json.dumps({"scan_times": str(checkout), **{
        label: {"ms": row[0], **row[6]} for label, row in times.items()}}))


def latent_inputs(torch, gen, cfg, b, npp, lengths=None, page=16):
    """K2-latent's bf16 inputs at ``cfg``'s widths: q_lat (B, H, r), q_pe
    (B, H, dr), pools (n_pages, page, r) and (n_pages, page, dr) with page 0
    the scratch page, shuffled page tables and int32 lengths
    (``ragged_lengths(b, npp * page)`` unless given)."""
    from repro_torch.kernels.tune import ragged_lengths

    m, h = cfg.mla, cfg.n_heads
    dev = gen.device
    n_pages = 1 + b * npp

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    lens = ragged_lengths(b, npp * page) if lengths is None else lengths
    return (bf16(b, h, m.kv_lora_rank), bf16(b, h, m.qk_rope_head_dim),
            bf16(n_pages, page, m.kv_lora_rank), bf16(n_pages, page, m.qk_rope_head_dim),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            random_pages(torch, gen, dev, b, npp, n_pages))


def mla_kernels_vs_plain(dev, cfg) -> dict:
    """Phase 18.  Returns the largest absolute error of each kernel."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.tune import candidates_for
    from repro_torch.kernels.tune.roofline import estimate
    from repro_torch.models.mla import sm_scale

    m = cfg.mla
    phase(f"K2's latent form and K3 (dk {m.qk_nope_head_dim + m.qk_rope_head_dim}, dv "
          f"{m.v_head_dim}) vs plain (bf16, {DEEPSEEK}: {cfg.n_heads} heads, r "
          f"{m.kv_lora_rank}, dr {m.qk_rope_head_dim})")
    gen = torch.Generator(device=dev).manual_seed(8)
    scale = sm_scale(cfg)
    errs = {"paged_latent_decode": 0.0, "flash_fwd": 0.0}

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    b, s = LONG_BATCH, LONG_PAGES * 16
    # pages of 16: ragged lengths; then 0, 1, a full row, and lengths that
    # are no multiple of any blocking; then the latent kernel's split
    # boundaries (192 positions from position 0) and one past them; each at
    # every pages_per_program the roofline keeps.  Then pages of 32 and of 8
    # at the default pages_per_program (the kernel's 64-position tile cuts a
    # page of 32 in none and spans eight of 8)
    cases = [(16, lengths, None) for lengths in (
        None, [0, 1, s, 1000, 65, 17, 555, 129], [192, 193, 384, 385, 576, 577, 960, 961])]
    cases += [(page, None, fd_ops.DEFAULT_PAGES_PER_PROGRAM) for page in (32, 8)]
    for page, lengths, ppp_only in cases:
        npp = s // page
        shape = fd_ops.latent_shape(b, cfg.n_heads, m.kv_lora_rank, m.qk_rope_head_dim, page,
                                    npp)
        args = latent_inputs(torch, gen, cfg, b, npp, lengths, page=page)
        configs = (candidates_for("flash_decode_paged", shape) if ppp_only is None
                   else [{"pages_per_program": ppp_only}])
        first = None
        for config in configs:
            ppp = config["pages_per_program"]
            if not estimate("flash_decode_paged", shape, config, "bfloat16").fits:
                try:
                    fd_ops.paged_latent_decode(*args, scale=scale, pages_per_program=ppp)
                except ValueError:
                    continue
                fail(f"paged_latent_decode took pages_per_program={ppp}, which the "
                     "roofline refuses")
            got = fd_ops.paged_latent_decode(*args, scale=scale, pages_per_program=ppp)
            torch.cuda.synchronize()
            want = fd_ops.paged_latent_decode_attention(*args, sm_scale=scale, impl="stream",
                                                        pages_per_program=ppp)
            errs["paged_latent_decode"] = max(errs["paged_latent_decode"], check_against_plain(
                torch, "paged_latent_decode", got, want, args[2],
                f"B={b} lengths={args[4].tolist()} page={page} npp={npp} ppp={ppp}"))
            if any(got[i].float().abs().any() for i, n in enumerate(args[4].tolist()) if n == 0):
                fail("paged_latent_decode: a row of length 0 is not zeros")
            # the kernel's tile is 64 positions whatever pages_per_program is
            first = got if first is None else first
            if not torch.equal(got, first):
                fail(f"paged_latent_decode: pages_per_program={ppp} changed the kernel's bits")
    dk, dv, h = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim, cfg.n_heads
    for s_len, kv_len in ((LONG_PROMPT, LONG_PROMPT - 24), (96, 37)):
        q, k, v = bf16(1, h, s_len, dk), bf16(1, h, s_len, dk), bf16(1, h, s_len, dv)
        kv_lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        got = fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=scale)
        torch.cuda.synchronize()
        want = flash_fwd_ref(q, k, v, kv_lens, causal=True, sm_scale=scale, q_offset=0,
                             block_q=16, block_k=16)
        errs["flash_fwd"] = max(errs["flash_fwd"], check_against_plain(
            torch, "flash_fwd", got, want, v,
            f"B=1 H={h} S={s_len} dk={dk} dv={dv} kv_lens=[{kv_len}]"))
    print(f"tolerance: at most {MAX_BF16_ULPS} bf16 ulp of the output beyond "
          f"{V_ATOL_OF_MAX:.2e} max|v| (v the latent pool for K2's latent form); an empty "
          "row exactly 0; pages_per_program the roofline refuses refused by the wrapper, "
          "the others the same bits")
    return errs


def mla_kernel_timings(dev, cfg, errs):
    """Phase 22.  Returns {kernel: (ms, plain_ms, library_ms, bound_ms,
    bound_by, shape, how)} for K2's latent form at phase 18's shape with
    ragged lengths (``paged_latent_decode``) and at full rows
    (``paged_latent_decode_full``, the rows the long run's decode steps
    see), both and their SDPA yardsticks replayed from a CUDA graph with the
    L2 flushed (``graph_ms``), each row's kernel output held against the
    plain version's (its error into ``errs``); and (ms, plain_ms,
    library_ms, bound_ms, bound_by, shape) for K3 at (S 1024, 128 heads, dk
    192, dv 128), causal (``flash_fwd_mla``, a row of the kernels line
    beside K3's at qwen3-14b's shape)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.tune.roofline import latent_splits
    from repro_torch.models.mla import sm_scale

    phase("K2-latent and K3 (192, 128) timings (K2-latent from a CUDA graph, L2 flushed; "
          "K3 by CUDA events, after warm-up)")
    m, h = cfg.mla, cfg.n_heads
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    gen = torch.Generator(device=dev).manual_seed(9)
    scale = sm_scale(cfg)
    timings = {}
    b, npp, page, ppp = LONG_BATCH, LONG_PAGES, 16, K2_ROW_PAGES_PER_PROGRAM
    s = npp * page
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    groups = -(-h // fd_ops.LATENT_HEADS)
    smem = fd_ops.LATENT_LIBRARY.load().paged_latent_decode_smem_bytes(r, dr)
    for name, lengths in (("paged_latent_decode", None),
                          ("paged_latent_decode_full", [s] * b)):
        q_lat, q_pe, ckv, kpe, lens, tables = latent_inputs(torch, gen, cfg, b, npp, lengths)
        valid = int(lens.sum())

        def call():
            return fd_ops.paged_latent_decode(q_lat, q_pe, ckv, kpe, lens, tables, scale=scale,
                                              pages_per_program=ppp)

        ms = graph_ms(call, reps=50, flush=flush)
        warm = graph_ms(call, reps=50)
        eager = cuda_ms(call, reps=50)

        def plain_call():
            return fd_ops.paged_latent_decode_attention(
                q_lat, q_pe, ckv, kpe, lens, tables, sm_scale=scale, impl="stream",
                pages_per_program=ppp)

        errs[name] = max(errs.get(name, 0.0), check_against_plain(
            torch, name, call(), plain_call(), ckv, f"B={b} lengths={lens.tolist()} ppp={ppp}"))
        plain = cuda_ms(plain_call, reps=3, warmup=1)
        values = fd_ops.gather_pages(ckv, tables)[:, None]  # (B, 1, S, r)
        keys = torch.cat([values, fd_ops.gather_pages(kpe, tables)[:, None]], dim=-1)
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        q_sdpa = torch.cat([q_lat, q_pe], dim=-1)[:, :, None]

        def sdpa():
            return F.scaled_dot_product_attention(q_sdpa, keys, values, attn_mask=mask,
                                                  scale=scale, enable_gqa=True)

        lib = graph_ms(sdpa, reps=20, flush=flush)
        lib_warm = graph_ms(sdpa, reps=20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        device_us = {"merge" if "merge" in e.key else "split":
                     e.self_device_time_total / e.count
                     for e in prof.key_averages() if "paged_latent_decode" in e.key}
        # the valid positions' latent and rope rows, the queries and lengths
        # and page tables read once, the output written once; 2 H (2 r + dr)
        # FLOPs a valid position
        nbytes = valid * (r + dr) * 2 + b * h * (2 * r + dr) * 2 + b * 4 + b * npp * 4
        flops = 2 * valid * h * (2 * r + dr)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        splits = latent_splits(s)
        live = sum(latent_splits(n) for n in lens.tolist()) * groups
        print(f"{name} B={b} H={h} r={r} dr={dr} context {s} lengths {lens.tolist()} (sum "
              f"{valid}) ppp={ppp}: kernel {ms:.4f} ms (CUDA graph, L2 flushed; {warm:.4f} ms "
              f"with the pool in the L2; eager calls back to back {eager:.4f} ms), split "
              f"kernel {device_us.get('split', 0.0):.2f} us and merge kernel "
              f"{device_us.get('merge', 0.0):.2f} us of device time a call (profiler, 20 "
              f"calls), plain {plain:.3f} ms, SDPA over the gathered [ckv | kpe] keys and ckv "
              f"values with a length mask {lib:.4f} ms (CUDA graph, L2 flushed; {lib_warm:.4f} "
              f"ms warm), bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB at 3.35 TB/s = "
              f"{bytes_ms:.4f} ms; {flops / 1e9:.3f} GFLOP at 989 TFLOP/s = {ops_ms:.4f} ms), "
              f"kernel at {100 * bound / ms:.2f}% of bound; grid {splits} splits x {groups} "
              f"head groups x {b} = {splits * groups * b} blocks of 256 threads ({live} hold "
              f"positions), {smem} bytes of shared memory a block, then the merge's {h} x {b} "
              "blocks")
        timings[name] = (ms, plain, lib, bound, by,
                         f"B={b} context={s} lengths={'ragged' if lengths is None else 'full'} "
                         f"ppp={ppp}",
                         {"timed_by": GRAPH_COLD_L2, "eager_ms": eager, "warm_l2_ms": warm,
                          "library_warm_l2_ms": lib_warm,
                          "split_device_us": device_us.get("split", 0.0),
                          "merge_device_us": device_us.get("merge", 0.0)})
        del keys, values
    dk, dv, sq = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim, LONG_PROMPT

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = bf16(1, h, sq, dk), bf16(1, h, sq, dk), bf16(1, h, sq, dv)
    kv_lens = torch.tensor([sq], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=scale), reps=10)
    plain = cuda_ms(lambda: flash_fwd_ref(q, k, v, kv_lens, causal=True, sm_scale=scale,
                                          q_offset=0, block_q=16, block_k=16),
                    reps=2, warmup=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale),
                  reps=20)
    nbytes = h * sq * (2 * dk + 2 * dv) * 2  # q, k, v read once, out written once
    flops = 2 * h * (dk + dv) * sq * (sq + 1) // 2  # the causal pairs this input needs
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"flash_fwd (MLA prefill) Sq=Skv={sq} H={h} dk={dk} dv={dv}: kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, SDPA {lib:.3f} ms, bound {bound:.4f} ms ({by}: "
          f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s = {ops_ms:.4f} ms; {nbytes / 1e6:.1f} MB "
          f"at 3.35 TB/s = {bytes_ms:.4f} ms), kernel at {100 * bound / ms:.2f}% of bound")
    timings["flash_fwd_mla"] = (ms, plain, lib, bound, by, f"Sq=Skv={sq} H={h} dk={dk} dv={dv}")
    return timings


# ---------------------------------------------------------------- training (PR 22)

# K3-bwd against its plain version on the card.  The plain version runs
# float32 arithmetic on the bf16 inputs and rounds dq, dk and dv to bf16 once;
# the kernel multiplies on the tensor cores (exact bf16 products, float32
# sums in another order) with p and ds carried as hi + lo bf16 pairs (within
# 2^-17 of each) and rounds once.  The float32 difference can move the
# rounding by one bf16 step, and is itself about sqrt(n) float32 epsilons of
# the n summands' magnitude (n up to G x Sq rows for dk and dv), several ulps
# of an element near 0 by cancellation; so one bf16 ulp of the element plus
# 2^-12 of the tensor's max |value| (tests/test_torch_flash_bwd_gpu.py states
# the same).  A fault (a wrong mask, tile or fragment) shows as errors of the
# order of the values.  K3's lse: its own sums of p = 2^(x - m) by
# ex2.approx, within 1e-5 (1 + |lse|) of the plain version's.
BWD_ATOL_OF_MAX = 2.0 ** -12
LSE_TOL = 1e-5
# The shapes K3 with lse and K3-bwd are held at: (name, B, Hq, Hk, S, DK, DV, kv_lens)
RAGGED_8 = (128, 100, 77, 64, 63, 17, 1, 128)
BWD_SHAPES = (("stablelm-1.6b", 8, 32, 32, 128, 64, 64, None),
              ("stablelm-1.6b ragged", 8, 32, 32, 128, 64, 64, RAGGED_8),
              ("qwen3-14b S 2048", 1, 40, 8, 2048, 128, 128, None),
              ("qwen3-14b ragged", 2, 40, 8, 1024, 128, 128, (1024, 611)),
              ("deepseek-moe-16b", 8, 16, 16, 128, 128, 128, None),
              # musicgen-medium's training rows: 64 conditioning frames + 128
              # tokens, 24 heads of MHA at D 64
              ("musicgen-medium", 8, 24, 24, 192, 64, 64, None),
              ("musicgen-medium ragged", 8, 24, 24, 192, 64, 64,
               (192, 150, 129, 128, 65, 64, 1, 192)),
              # MLA: deepseek-v2-236b's training shape (K and V re-expanded to
              # its 128 heads) and a cut key side (split 4) at DK 192; the
              # smoke deepseek-v2's (24, 16)
              ("deepseek-v2-236b", 8, 128, 128, 128, 192, 128, None),
              ("deepseek-v2-236b ragged", 8, 128, 128, 128, 192, 128, RAGGED_8),
              ("deepseek-v2 cut, S 2048", 1, 4, 4, 2048, 192, 128, None),
              ("smoke deepseek-v2", 8, 4, 4, 128, 24, 16, RAGGED_8),
              ("smoke deepseek-v2 cut", 1, 8, 1, 512, 24, 16, None))
# the kernels line's rows: the first; the rest are printed beside it.  The
# equal-dim ones are also those ``--k3bwd-times`` compares with a parent
BWD_TIMED = ("stablelm-1.6b", "qwen3-14b S 2048", "musicgen-medium")
MLA_BWD_TIMED = ("deepseek-v2-236b", "deepseek-v2 cut, S 2048")
# K3-bwd's launches by the wrapper's name (ops.py: BWD_DQ .. BWD_DK)
BWD_PASS_NAMES = ("flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dv", "flash_bwd_dk")
# The training path: the reference CLI's defaults (launch/train.py:309-311)
# at full width, all layers, AdamW at lr 1e-3, remat "full"; then a window
# of steps profiled for device activity only
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = "stablelm-1.6b", 8, 128, 8
TRAIN_PROFILED_STEPS = 2
# Phase (d): the smoke trainer through the kernels on the card against the
# plain versions on the CPU, from the same weights.  Both run bf16
# activations, rounded where cuBLAS and the CPU's library differ, so a
# step's loss differs by bf16 steps of the logits (the smoke LM on the card
# against the CPU: within 1% of the largest logit, phase 9); Adam's steps at
# warm-up lr (1e-3 x step / 20) keep the weights within a few lr of each
# other.  So each step's loss within 1% of the CPU's, about a hundred times
# the difference measured on an H100 (1.1e-4); a wrong gradient shows as a
# loss curve that parts.
TRAIN_LOSS_RTOL = 1e-2
# Phase (f): the static serve mode at full width (repro/launch/serve.py:439-456)
STATIC_ARGV = ["--arch", QWEN, "--batch", "4", "--prompt-len", "16", "--gen", "16"]


def bwd_inputs(torch, dev, gen, b, hq, hk, s, d, dv, lens):
    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kv_lens = torch.tensor(lens if lens else [s] * b, dtype=torch.int32, device=dev)
    return bf16(b, hq, s, d), bf16(b, hk, s, d), bf16(b, hk, s, dv), bf16(b, hq, s, dv), kv_lens


def bwd_flops_bytes(b, hq, hk, s, d, dv, lens, pass_no):
    """The operations and bytes of one K3-bwd launch over these inputs: the
    causal pairs each row sees (key < kv_len), 2 DK or 2 DV FLOPs a pair for
    each product (the dq pass: S, dP, dS K; the dk/dv pass: S, dP, P^T dO,
    dS^T Q; the dv pass: S, P^T dO; the dk pass: S, dP, dS^T Q); each input
    read once, each output written once.  Pass None: the whole backward, the
    function and not the design (q, k, v, out, dout read; dq, dk, dv
    written; its 5 products S, dP, P^T dO, dS K and dS^T Q, where the passes
    recompute S and dP: 6 DK + 4 DV FLOPs a pair)."""
    lens = lens or (s,) * b
    pairs = sum(sum(min(length, r + 1) for r in range(s)) for length in lens) * hq
    q_b, o_b = b * hq * s * d * 2, b * hq * s * dv * 2  # q or dq; out or dout
    k_b, v_b = b * hk * s * d * 2, b * hk * s * dv * 2  # k or dk; v or dv
    rows = b * hq * s * 4  # lse or delta
    flops_by_pass = {0: 4 * d + 2 * dv, 1: 4 * d + 4 * dv, 2: 2 * d + 2 * dv,
                     3: 4 * d + 2 * dv, None: 6 * d + 4 * dv}
    bytes_by_pass = {0: 2 * q_b + k_b + v_b + 2 * o_b + 2 * rows,  # q k v out dout lse; dq delta
                     1: q_b + 2 * k_b + 2 * v_b + o_b + 2 * rows,  # q k v dout lse delta; dk dv
                     2: q_b + k_b + v_b + o_b + rows,              # q k dout lse; dv
                     3: q_b + 2 * k_b + v_b + o_b + 2 * rows,      # q k v dout lse delta; dk
                     None: 2 * q_b + 2 * k_b + 2 * v_b + 2 * o_b}
    return flops_by_pass[pass_no] * pairs, bytes_by_pass[pass_no]


def bwd_bound(b, hq, hk, s, d, dv, lens, pass_no) -> tuple:
    """(bound ms, "operations" or "bytes", the text of the reckoning)."""
    flops, nbytes = bwd_flops_bytes(b, hq, hk, s, d, dv, lens, pass_no)
    ops_ms, bytes_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    text = (f"{flops / 1e9:.3f} GFLOP at 989 TFLOP/s = {ops_ms:.4f} ms; "
            f"{nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms:.4f} ms")
    return max(ops_ms, bytes_ms), by, text


def bwd_launches(fa_ops, d, dv) -> list:
    """(name, wrapper) of each K3-bwd launch at (d, dv) in launch order: the
    dq pass, then the key side's pass or passes.  A checkout from before the
    key side could be split (no ``bwd_key_passes``) runs the dk/dv pass."""
    key = fa_ops.bwd_key_passes(d, dv) if hasattr(fa_ops, "bwd_key_passes") else (1,)
    return [(BWD_PASS_NAMES[p], getattr(fa_ops, BWD_PASS_NAMES[p])) for p in (0, *key)]


def sdpa_backward(torch, q, k, v, do):
    """One call of PyTorch's fused attention backward (dq, dk and dv together),
    causal, under the backend its dispatch takes at these shapes."""
    import torch.nn.functional as F

    hq, hk = q.shape[1], k.shape[1]
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=hq != hk)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)


def sdpa_backend(torch, q, k, v) -> str:
    """The backends that compute the causal forward and backward at these
    shapes when each is the only one allowed, and the kernels PyTorch's
    dispatch (every backend allowed) launches for a backward, by device
    time a call (profiler over 5 calls; a window that records no kernel is
    taken again)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    do = torch.ones(*q.shape[:3], v.shape[3], dtype=q.dtype, device=q.device)
    able = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # why each refused backend refuses
                sdpa_backward(torch, q, k, v, do)()
            able.append(backend.name)
        except RuntimeError:
            pass
    call = sdpa_backward(torch, q, k, v, do)
    call()
    torch.cuda.synchronize()
    kernels = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)
        if kernels:
            break
    return (f"runs alone: {', '.join(able) or 'none'}; the dispatch's kernels, by device "
            "time a call: " + ("; ".join(
                f"{e.key[:80]} x{e.count} {e.self_device_time_total / 1e3 / e.count:.4f} ms"
                for e in kernels[:4]) or "none recorded"))


def k3bwd_times(dev, versions: dict, shapes) -> dict:
    """K3-bwd's times at ``shapes`` (names of BWD_SHAPES) through the
    wrappers alone (``flash_fwd`` with the lse, then each launch's wrapper),
    which every version of K3-bwd has, so that ``--k3bwd-times`` runs a
    parent's beside this tree's: each launch's ms by CUDA events (20 calls
    each, after warm-up), the versions in turns (parent, change, change,
    parent; one version: twice), with SDPA's backward (dq, dk and dv
    together) after each; then each launch replayed from a CUDA
    graph of 20 calls, the device's time without the wrapper's host time
    (warm L2).  Returns {shape: {version: {launch: [ms, ms], launch + "
    graph": ms}, "sdpa": [..]}}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(23)
    times = {}
    order = list(versions) + list(reversed(versions))
    for name, b, hq, hk, s, d, dv, lens in BWD_SHAPES:
        if name not in shapes:
            continue
        q, k, v, do, kv_lens = bwd_inputs(torch, dev, gen, b, hq, hk, s, d, dv, lens)
        kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=0)
        fa_ops = versions[order[0]]
        out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
        delta = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        sdpa_call = sdpa_backward(torch, q, k, v, do)
        row = {label: {} for label in versions} | {"sdpa": []}
        for label in order:
            for kernel, wrapper in bwd_launches(versions[label], d, dv):
                row[label].setdefault(kernel, []).append(cuda_ms(lambda: wrapper(
                    q, k, v, kv_lens, out, lse, do, delta, grads, **kw), reps=20))
            row["sdpa"].append(cuda_ms(sdpa_call, reps=20))
        for label, fa in versions.items():  # the device's time, without the host's
            for kernel, wrapper in bwd_launches(fa, d, dv):
                row[label][kernel + " graph"] = graph_ms(lambda: wrapper(
                    q, k, v, kv_lens, out, lse, do, delta, grads, **kw), reps=20)
        times[name] = row
        del sdpa_call
    return times


def k3bwd_times_main(checkout: Path) -> None:
    """``python3 chip_smoke.py --k3bwd-times DIR``: K3 and K3-bwd built from
    the checkout at DIR (the parent) and from this tree, in one process.  At
    every equal-dim shape of BWD_SHAPES both backwards from the same inputs,
    forward and lse, dq, dk and dv the same bits (the equal-dim instances
    keep their code and bits); then ``k3bwd_times`` at BWD_TIMED's shapes,
    parent, change, change, parent, printed as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import ops as fa_ops

    parent = load_ops_from(checkout, "parent_flash_attention_ops", "flash_attention")
    print(f"card: {nvidia_smi_line()}; parent K3 and K3-bwd from {checkout}")
    build_all([fa_ops.LIBRARY, fa_ops.BWD_LIBRARY, parent.LIBRARY, parent.BWD_LIBRARY])
    dev = torch.device("cuda")
    versions = {"parent": parent, "change": fa_ops}
    gen = torch.Generator(device=dev).manual_seed(24)
    bits = {}
    for name, b, hq, hk, s, d, dv, lens in BWD_SHAPES:
        if d != dv:
            continue
        q, k, v, do, kv_lens = bwd_inputs(torch, dev, gen, b, hq, hk, s, d, dv, lens)
        kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=0)
        runs = {}
        for label, m in versions.items():
            out, lse = m.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
            runs[label] = (out, lse, *m.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw))
        same = all(torch.equal(x, y) for x, y in zip(runs["parent"], runs["change"]))
        bits[name] = same
        print(f"{name} (B {b}, Hq {hq}, Hk {hk}, S {s}, D {d}): K3's output and lse and "
              f"K3-bwd's dq, dk, dv, parent and change: "
              f"{'the same bits' if same else 'DIFFERENT'}")
        if not same:
            fail(f"K3-bwd's equal-dim instance moved at {name}")
    times = k3bwd_times(dev, versions, BWD_TIMED)
    for name, row in times.items():
        for kernel in ("flash_bwd_dq", "flash_bwd_dkdv"):
            p, c = row["parent"][kernel], row["change"][kernel]
            print(f"  {name} {kernel}: parent {p[0]:.4f}, change {c[0]:.4f}, change {c[1]:.4f}, "
                  f"parent {p[1]:.4f} ms (graph: parent {row['parent'][kernel + ' graph']:.4f}, "
                  f"change {row['change'][kernel + ' graph']:.4f}); SDPA {row['sdpa']}")
    print(json.dumps({"k3bwd_times": str(checkout), "same_bits": bits, **times}))


def bwd_ptxas(log: str) -> None:
    """Phases 23b and 26b: ptxas's registers and spills of every launch at
    each (DK, DV) pair (the key side's kernel by its pass: 1 dk/dv, 2 dv,
    3 dk), from the library's build log."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        for kernel in ("flash_bwd_dq_kernel", "flash_bwd_key_kernel"):
            if kernel in entry and ("registers" in line or "spill" in line):
                args = [int(x) for x in entry.split(kernel + "I")[1].split("EEv")[0]
                        .replace("Li", " ").replace("E", " ").split()]
                what = (f"flash_bwd_dq (DK {args[0]}, DV {args[1]})" if len(args) == 2 else
                        f"{BWD_PASS_NAMES[args[2]]} (DK {args[0]}, DV {args[1]})")
                text = line.split("ptxas info", 1)[-1].lstrip(" :").strip()
                print(f"  ptxas: {what}: {text}")


def flash_bwd_vs_plain(dev, build_log: str) -> dict:
    """Phases 23a/23b and 26a/26b: K3 with the rows' lse, and K3-bwd,
    against their plain versions on the card at the training shapes of
    BWD_SHAPES (equal dims; MLA's (192, 128) and the smoke pair (24, 16)),
    MHA and G 5, full and ragged kv_lens, key sides cut and not; two runs of
    the backward the same bits; the library's schedule against the CPU
    mirror; ptxas's registers and spills and the card's occupancy for every
    launch; each launch's time (CUDA events, after warm-up; from a CUDA
    graph) beside its bound, the plain backward's and SDPA's backward's,
    SDPA in turns with the kernel.  Returns the kernels line's rows'
    numbers."""
    import ctypes

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

    phase("K3 with lse and K3-bwd vs plain (bf16; stablelm-1.6b, qwen3-14b, deepseek-moe-16b, "
          "musicgen-medium and deepseek-v2-236b training shapes, the smoke deepseek-v2's "
          "(24, 16))")
    bwd_ptxas(build_log)
    gen = torch.Generator(device=dev).manual_seed(22)
    worst = {"flash_fwd_lse": 0.0, **{name: 0.0 for name in BWD_PASS_NAMES}}
    lib = fa_ops.BWD_LIBRARY.load()
    occupancy = {}
    for d, dv in fa_ops.BWD_HEAD_DIMS:
        for pass_no in (fa_ops.BWD_DQ, *fa_ops.bwd_key_passes(d, dv)):
            blocks = ctypes.c_int()
            fa_ops.BWD_LIBRARY.check(lib.flash_bwd_occupancy(pass_no, d, dv, ctypes.byref(blocks)),
                                     "flash_bwd_occupancy")
            occupancy[f"{BWD_PASS_NAMES[pass_no]} ({d}, {dv})"] = (
                blocks.value, lib.flash_bwd_smem_bytes(pass_no, d, dv))
    print("  blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and shared "
          f"memory a block: {occupancy}")
    for name, b, hq, hk, s, d, dv, lens in BWD_SHAPES:
        q, k, v, do, kv_lens = bwd_inputs(torch, dev, gen, b, hq, hk, s, d, dv, lens)
        kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=0)
        plain_kw = dict(kw, block_q=64, block_k=64)
        passes = (fa_ops.BWD_DQ, *fa_ops.bwd_key_passes(d, dv))
        plan = []
        for pass_no in passes:
            got = (ctypes.c_int * 4)()
            fa_ops.BWD_LIBRARY.check(lib.flash_bwd_plan(pass_no, b, hk, hq // hk, s, s, 0, 1, got),
                                     "flash_bwd_plan")
            want = fa_ops.bwd_grid(pass_no, b, hk, hq // hk, s, s, 0, True)
            if tuple(got) != want:
                fail(f"K3-bwd's plan at {name}, pass {pass_no}: the library's {tuple(got)}, "
                     f"ops.bwd_grid's {want}")
            plan.append(want)
        if "cut" in name and plan[1][3] < 2:
            fail(f"{name}: the key side is not cut ({plan[1]})")
        units = fa_ops.bwd_plan(b, hk, hq // hk, s, s, kv_lens.tolist(), 0, True)
        steps = [len(u.visits) for u in units]
        out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
        bare = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, **kw)
        if not torch.equal(out, bare):
            fail(f"K3's output at {name} moved with the lse buffer")
        want_out, want_lse = flash_fwd_ref(q, k, v, kv_lens, return_lse=True, **plain_kw)
        out_ulps = bf16_ulps(out.float(), want_out.float(),
                             V_ATOL_OF_MAX * float(v.float().abs().max()))
        lse_err = float(((lse - want_lse).abs() / (1 + want_lse.abs())).max())
        worst["flash_fwd_lse"] = max(worst["flash_fwd_lse"], lse_err)
        if out_ulps > MAX_BF16_ULPS or lse_err > LSE_TOL or not bool(torch.isfinite(lse).all()):
            fail(f"K3 with lse at {name}: output {out_ulps:.2f} ulps, lse {lse_err:.3g} relative")
        before = read_launches()
        got = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
        ran = {n: read_launches()[n] - before[n] for n in BWD_PASS_NAMES}
        if ran != {n: int(i in passes) for i, n in enumerate(BWD_PASS_NAMES)}:
            fail(f"K3-bwd at {name} ran {ran}, expected passes {passes}")
        again = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"K3-bwd at {name}: two runs gave different bits")
        want = flash_bwd_ref(q, k, v, kv_lens, out, lse, do, **plain_kw)
        errs = []
        key = [BWD_PASS_NAMES[p] for p in passes[1:]]
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = float(w.float().abs().max())
            ulps = bf16_ulps(g.float(), w.float(), BWD_ATOL_OF_MAX * scale)
            err = float((g.float() - w.float()).abs().max())
            errs.append(f"{grad} {err:.3g} (max |{grad}| {scale:.3g}, {ulps:.2f} ulps past the "
                        "atol)")
            by = ["flash_bwd_dq"] if grad == "dq" else [
                n for n in key if n == "flash_bwd_dkdv" or n == f"flash_bwd_{grad}"]
            for kernel in by:
                worst[kernel] = max(worst[kernel], err)
            if ulps > MAX_BF16_ULPS or not bool(torch.isfinite(g).all()):
                fail(f"K3-bwd at {name}: {grad} off by {ulps:.2f} bf16 ulps past "
                     f"{BWD_ATOL_OF_MAX} x max|{grad}|")
        ran_names = ", ".join(BWD_PASS_NAMES[p] for p in passes)
        print(f"{name} (B {b}, Hq {hq}, Hk {hk}, S {s}, DK {d}, DV {dv}, kv_lens "
              f"{'full' if lens is None else list(lens)}): K3 output with lse = without, bit for "
              f"bit; lse within {lse_err:.3g} of plain; K3-bwd ({ran_names}) two runs bitwise; "
              f"max |kernel - plain|: {', '.join(errs)}")
        print(f"  schedule = ops.bwd_grid: dq grid {plan[0][:3]}, key side grid {plan[1][:3]} in "
              f"clusters of {plan[1][3]} ({len(passes) - 1} launch(es)); key blocks {len(steps)}, "
              f"steps {sum(steps)} (longest block {max(steps)}, mean over {fa_ops.BWD_SLOTS} "
              f"slots {sum(steps) / fa_ops.BWD_SLOTS:.2f}); dq blocks "
              f"{plan[0][0] * plan[0][1] * b} against {fa_ops.BWD_SLOTS} slots")
    rows = {}
    timed = k3bwd_times(dev, {"change": fa_ops}, BWD_TIMED + MLA_BWD_TIMED)
    for name, b, hq, hk, s, d, dv, lens in BWD_SHAPES:
        if name not in timed:
            continue
        q, k, v, do, kv_lens = bwd_inputs(torch, dev, gen, b, hq, hk, s, d, dv, lens)
        kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=0)
        plain_kw = dict(kw, block_q=64, block_k=64)
        out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
        fwd_ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, **kw), reps=20)
        lse_ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True,
                                                  **kw), reps=20)
        plain = cuda_ms(lambda: flash_bwd_ref(q, k, v, kv_lens, out, lse, do, **plain_kw),
                        reps=2, warmup=1)
        t, lib_ms = timed[name]["change"], sum(timed[name]["sdpa"]) / 2
        launches = bwd_launches(fa_ops, d, dv)
        total = sum(sum(t[kernel]) / 2 for kernel, _ in launches)
        whole, whole_by, whole_text = bwd_bound(b, hq, hk, s, d, dv, lens, None)
        print(f"  {name} (DK {d}, DV {dv}): K3 at block_k 64 {fwd_ms:.4f} ms, with lse "
              f"{lse_ms:.4f} ms; plain backward {plain:.3f} ms; SDPA's backward (causal"
              f"{', GQA' if hq != hk else ''}) {timed[name]['sdpa'][0]:.4f} and "
              f"{timed[name]['sdpa'][1]:.4f} ms for dq, dk and dv together, in turns with the "
              f"kernel's {total:.4f} ({len(launches)} launches); the whole backward's bound "
              f"{whole:.4f} ms ({whole_by}: {whole_text})")
        if d != dv:
            print(f"  SDPA at (DK {d}, DV {dv}): {sdpa_backend(torch, q, k, v)}")
        for kernel, _ in launches:
            pass_no = BWD_PASS_NAMES.index(kernel)
            ms = sum(t[kernel]) / 2
            bound, by, text = bwd_bound(b, hq, hk, s, d, dv, lens, pass_no)
            doubled = {0: 1, 1: 2, 2: 1, 3: 1}[pass_no]
            print(f"  {kernel}: {t[kernel][0]:.4f} and {t[kernel][1]:.4f} ms "
                  f"({t[kernel + ' graph']:.4f} from a CUDA graph), bound {bound:.4f} ms ({by}: "
                  f"{text}), {100 * bound / ms:.2f}% of bound; the hi/lo split of p and ds "
                  f"doubles {doubled} of its products on the tensor cores")
            at = {"ms": ms, "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bound,
                  "bound_by": by, "graph_ms": t[kernel + " graph"],
                  "shape": f"B {b}, Hq {hq}, Hk {hk}, S {s}, DK {d}, DV {dv}",
                  "plain_and_library_cover": "dq, dk and dv together"}
            if kernel not in rows:
                rows[kernel] = at
            else:
                rows[kernel].update({f"ms_at {name}": ms, f"bound_ms_at {name}": bound,
                                     f"library_ms_at {name}": lib_ms,
                                     f"graph_ms_at {name}": t[kernel + " graph"]})
        if name in (BWD_TIMED[0], MLA_BWD_TIMED[0]):
            rows["flash_fwd_lse" if d == dv else "flash_fwd_mla_lse"] = {
                "ms": lse_ms, "ms_without_lse": fwd_ms}
    for key, err in worst.items():
        rows.setdefault(key, {})["max_abs_err"] = err
    return rows


def training_path(dev) -> dict:
    """Phase 23c, the training path: ``Trainer`` on stablelm-1.6b at full
    width (24 layers, d_model 2048, vocab 100352), the reference CLI's
    defaults: seq 128, global batch 8, AdamW at lr 1e-3, remat "full", 8
    steps.  Gates: loss and grad norm finite; K3 launches = 2 x 24 x steps
    (full remat runs each layer's forward again in the backward), each
    K3-bwd pass 24 x steps, no other kernel.  Returns the launches."""
    import statistics

    import torch

    from repro_torch.launch.train import Trainer, TrainerOptions

    phase(f"main path 6: LM training, Trainer on {TRAIN_ARCH} at full width, seq {TRAIN_SEQ}, "
          f"global batch {TRAIN_BATCH}, AdamW lr 1e-3, remat full, {TRAIN_STEPS} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(TrainerOptions(arch=TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
                                     seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, log_every=0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = trainer.cfg
    n_params = sum(p.numel() for p in trainer.lm.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B parameters; remat {trainer.rt.remat}; state built in "
          f"{build_s:.1f} s (bf16 weights, float32 master, AdamW mu and nu)")
    if cfg.n_layers != 24 or cfg.d_model != 2048 or trainer.rt.remat != "full":
        fail("the training path did not run stablelm-1.6b at full width with full remat")
    reset_launches()
    trainer.run()
    counts = read_launches()
    records = trainer.records
    times = [r["step_time"] for r in records[1:]]
    med = statistics.median(times)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    peak = torch.cuda.max_memory_allocated() / 1e9
    print("losses: " + ", ".join(f"{r['loss']:.4f}" for r in records))
    print("grad norms: " + ", ".join(f"{r['grad_norm']:.4f}" for r in records))
    print(f"step ms: first {1e3 * records[0]['step_time']:.1f}, then median {1e3 * med:.1f} "
          f"(min {1e3 * min(times):.1f}, max {1e3 * max(times):.1f}); {tokens / med:.0f} tokens/s; "
          f"peak device memory {peak:.3f} GB (host clock around each step, synchronised)")
    if len(records) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        fail(f"training: {len(records)} steps, losses or grad norms not finite")
    layers, steps = cfg.n_layers, TRAIN_STEPS
    expected = {name: 0 for name in counts}
    expected.update(flash_fwd=2 * layers * steps, flash_bwd_dq=layers * steps,
                    flash_bwd_dkdv=layers * steps)
    print(f"launches: flash_fwd {counts['flash_fwd']} = 2 x {layers} x {steps}, flash_bwd_dq "
          f"{counts['flash_bwd_dq']} and flash_bwd_dkdv {counts['flash_bwd_dkdv']} = {layers} x "
          f"{steps}")
    if counts != expected:
        fail(f"training launches {counts}, expected {expected}")
    training_step_split(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def training_step_split(trainer) -> None:
    """Where a training step's device time goes: a window of
    TRAIN_PROFILED_STEPS more steps, device activity only (tracing the
    host's operators too would slow the host, which sets part of the step),
    split into the matrix products (cuBLAS), the port's kernels (K3, K3-bwd,
    K4, K4-bwd) and the rest (elementwise passes of the optimizer, the master copy and
    the gradients' gather, reductions, the loss), beside the steps' wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = TRAIN_PROFILED_STEPS
    ours = ("flash_", "selective_scan")  # the port's kernels on the training paths
    events = None
    for _ in range(3):  # a profiler window now and then records no kernel: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_some(n)
        torch.cuda.synchronize()
        events = prof.key_averages()
        if sum(e.self_device_time_total for e in events) > 0:
            break
    wall_ms = 1e3 * sum(r["step_time"] for r in trainer.records[-n:]) / n
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    gemm_ms = sum(e.self_device_time_total for e in events if is_gemm(e.key)) / 1e3 / n
    flash_ms = sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in ours)) / 1e3 / n
    print(f"a profiled step ({n} steps): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(share {busy_ms / wall_ms:.3f}): matrix products {gemm_ms:.1f} ms, the port's "
          f"kernels (flash, selective scan) {flash_ms:.2f} ms, the rest (elementwise, "
          f"reductions, copies) {busy_ms - gemm_ms - flash_ms:.1f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3 / n:8.3f} ms a step  "
              f"x{e.count // n:5d}  {e.key[:90]}")
    mine = sorted((e for e in events if any(k in e.key for k in ours)),
                  key=lambda e: -e.self_device_time_total)
    print("the port's kernels a step: " + "; ".join(
        f"{e.key.split('<')[0].split('::')[-1]} {e.self_device_time_total / 1e3 / n:.3f} ms x "
        f"{e.count // n} ({e.self_device_time_total / 1e3 / max(e.count, 1):.4f} ms each)"
        for e in mine))
    if busy_ms <= 0:
        fail("the profiler saw no device time in the training steps")


def smoke_trainer(device, arch=TRAIN_ARCH, **kw):
    from repro_torch.launch.train import Trainer, TrainerOptions

    return Trainer(TrainerOptions(arch=arch, smoke=True, steps=8, seq_len=32,
                                  global_batch=4, log_every=0, device=device, **kw))


def training_kernels_vs_plain(dev, arch=TRAIN_ARCH,
                              kernels=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")) -> None:
    """Phases 23d, 24e, 26d, 27e and 27f: the smoke trainer (bf16, remat
    none) for 8 steps through the kernels on the card and through the plain
    versions on the CPU, from the card's initial weights and state; each of
    ``kernels`` launched once a step a layer whose mixer runs it (attention:
    K3, K3-bwd; Mamba: K4, K4-bwd), no other kernel."""
    phase(f"small-input check: the smoke {arch} trainer, 8 steps on the card "
          f"({', '.join(kernels)}) vs the plain versions on the CPU, the same weights")
    card = smoke_trainer(dev, arch)
    cpu = smoke_trainer("cpu", arch)
    cpu.set_state(card.params, card.opt_state)
    reset_launches()
    card.train_some(8)
    counts = read_launches()
    cpu.train_some(8)
    kinds = layers_by_mixer(card.cfg)  # each kernel once a layer of its mixer's kind a step
    want = {name: 8 * kinds["mamba" if name.startswith("selective_scan") else "attn"]
            if name in kernels else 0 for name in counts}
    if counts != want:
        fail(f"smoke training launches {counts}, expected {want}")
    want = {name: want[name] for name in kernels}
    worst = 0.0
    for (step, got), (_, ref) in zip(card.history, cpu.history):
        worst = max(worst, abs(got - ref) / abs(ref))
    print("card losses: " + ", ".join(f"{loss:.5f}" for _, loss in card.history))
    print("CPU losses:  " + ", ".join(f"{loss:.5f}" for _, loss in cpu.history))
    print(f"largest relative difference {worst:.3g} (limit {TRAIN_LOSS_RTOL}); launches {want}")
    if worst > TRAIN_LOSS_RTOL or len(card.history) != 8:
        fail(f"the smoke trainer's losses on the card part from the CPU's: {worst:.3g}")


def checkpoint_round_trip(dev, workdir: Path, arch=TRAIN_ARCH) -> None:
    """Phases 23e and 27f: the smoke trainer on the card saves at step 4
    (and 8); a fresh trainer restores step 4 and runs steps 5-8: losses,
    parameters and optimizer state bit for bit those of the run that never
    stopped."""
    import torch

    from repro_torch.training.tree import tree_leaves

    phase(f"checkpoint round trip on the card ({arch}): save at step 4, restore into a fresh "
          "Trainer, steps 5-8 bit for bit")
    ckpt = workdir / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    a = smoke_trainer(dev, arch, ckpt_dir=str(ckpt), ckpt_every=4)
    a.train_some(8)
    a.ckpt.wait()
    b = smoke_trainer(dev, arch, ckpt_dir=str(ckpt), ckpt_every=100)
    if not b.restore(4) or b.step != 4:
        fail("the fresh trainer did not restore step 4")
    b.train_some(4)
    same = b.history == a.history[4:] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(b.params) + tree_leaves(b.opt_state),
                                          tree_leaves(a.params) + tree_leaves(a.opt_state)))
    timing = b.ckpt.last_timing("restore")
    print(f"steps 5-8: restored {[round(x, 6) for _, x in b.history]}, unstopped "
          f"{[round(x, 6) for _, x in a.history[4:]]}; bit_identical={'yes' if same else 'NO'} "
          f"(losses, parameters, optimizer state); save {a.ckpt.last_timing('save')['wall_s']:.3f} "
          f"s, restore {timing['wall_s']:.3f} s, {timing['bytes'] / 1e6:.2f} MB")
    if not same:
        fail("the restored trainer's steps 5-8 differ from the unstopped run's")


# ------------------------------------------------- Mamba and MoE training

# K4-bwd against its plain version on the card.  The kernel recomputes the
# states with K4's tile scan (ex2.approx, a tree over the lanes) and scans
# the adjoint as a tree too, where the plain version runs both serially with
# the true exp; their sums over n, channels, time and sequences are in the
# same order, but the kernel fuses a product into each.  As for K4's forward
# (SCAN_RTOL_OF_MAX: float32 roundings a step that decay with the state),
# twice its limit for the two scans: each gradient within 2^-12 of its
# largest magnitude, a bf16 gradient within that plus one bf16 ulp
# (tests/test_torch_ssm_scan_bwd_gpu.py states the same).  A fault (a wrong
# tile, lane or carry) shows as errors of the order of the values.
SCAN_BWD_RTOL_OF_MAX = 2.0 ** -12
# falcon-mamba-7b's training shape (the trainer's B 8, S 128) and one that
# crosses tiles (four, the last ragged) at its widths
SCAN_BWD_SHAPES = (("training", 8, 128), ("tiles", 1, 1000))
# The two training paths, at full width and a cut depth: falcon-mamba-7b's
# first 8 of its 64 layers (1.37 B parameters; the 64 layers' 7.27 B fit no
# card with float32 master weights and AdamW's moments), deepseek-moe-16b's
# dense head layer and its first 2 MoE layers of 27 (1.68 B; a fourth layer
# would add 0.59 B and pass 70 GB at the 31 bytes a parameter stablelm-1.6b's
# training path measured, PERF.md)
MOE = "deepseek-moe-16b"
MAMBA_TRAIN_LAYERS, MOE_TRAIN_LAYERS = 8, 3
# Main path 9 (phase 26c): deepseek-v2-236b at full width, its dense head
# layer alone, 1 of 60: MLA at 128 heads of (192, 128), K3-bwd's dv and dk
# passes, and the dense FFN of 12,288.  With the embedding and the head (2 x
# 102,400 x 5,120) that is 1.387 B parameters, ~43 GB at the ~31 bytes a
# parameter stablelm-1.6b's path measured; one MoE layer (160 routed experts
# and 2 shared, each 3 x 5,120 x 1,536, with its MLA) adds ~3.97 B, ~123 GB,
# so no MoE layer of deepseek-v2 fits one card: the smoke deepseek-v2 holds
# MLA and MoE together (phase 26d)
MLA_TRAIN_LAYERS = 1


def scan_bwd_bound(bt, s, dn, n, d_block):
    """(bound ms, by what, MB, exponentials, the design's own MB) of the
    gradient K4-bwd computes: x, dy and dx (bf16), dt and ddt (float32), B,
    C, dB and dC (bf16), A, D, dA and dD, each read or written once; per (b,
    t, d, n) one exponential (the states' recomputation) and 16 float32
    operations (the state's step 3, the adjoint's 3, the terms of dx, ddt,
    dA, dB and dC 10).  What this design adds is no part of the function's
    bytes and is returned beside the bound: the tile states it reads (B x
    ceil(S / 256) x Dn N float32) and the partials of dB and dC it writes
    and reads again (one a cluster of channel blocks, ``ref.bwd_cluster``,
    of B S N float32 each, twice)."""
    from repro_torch.kernels.ssm_scan.ref import bwd_cluster

    tiles = 4 * bt * (-(-s // 256)) * dn * n
    partials = 2 * 2 * 4 * bwd_cluster(dn, d_block)[1] * bt * s * n
    nbytes = (3 * 2 + 2 * 4) * bt * s * dn + 4 * 2 * bt * s * n + 4 * 2 * (dn * n + dn)
    n_exp = bt * s * dn * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n_exp / EXP_PER_S, 16 * n_exp / F32_FLOPS_PER_S) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes / 1e6, n_exp, {"tile_states_mb": tiles / 1e6,
                                                             "partials_mb": partials / 1e6}


def reduce_parts(torch, gen, dev, bt, s, dn, n, d_block):
    """Partials of K4-bwd's reduction at (Bt, S, Dn, N, d_block), random:
    the reduction's inputs (dB's and dC's one a cluster of channel blocks),
    its outputs (bf16 dB and dC) and its bytes."""
    from repro_torch.kernels.ssm_scan.ref import bwd_cluster

    n_blocks = bwd_cluster(dn, d_block)[1]
    parts = tuple(torch.randn(shape, generator=gen, device=dev) for shape in (
        (n_blocks, bt, s, n), (n_blocks, bt, s, n), (bt, dn, n), (bt, dn)))
    outs = (torch.empty((bt, s, n), dtype=torch.bfloat16, device=dev),
            torch.empty((bt, s, n), dtype=torch.bfloat16, device=dev),
            torch.empty((dn, n), dtype=torch.float32, device=dev),
            torch.empty((dn,), dtype=torch.float32, device=dev))
    nbytes = sum(4 * p.numel() for p in parts) + sum(o.element_size() * o.numel() for o in outs)
    return parts, outs, nbytes


def scan_bwd_inputs(torch, gen, cfg, bt, s):
    x, dt, a, b_ssm, c_ssm, d, _ = scan_inputs(torch, gen, cfg, bt, s)
    d = torch.randn(d.shape, generator=gen, device=d.device)
    dy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    return (x, dt, a, b_ssm, c_ssm, d), dy


def scan_bwd_vs_plain(dev, cfg) -> tuple:
    """Phase 24a: K4 with its tile states against the plain version at
    SCAN_BWD_SHAPES (y and h the same bits as without them; y, h and the
    states within phase 13's tolerance of the plain version's), then K4-bwd
    against its plain version there, two launches the same bits, and its
    reduction alone against its plain version, on partials of the training
    shape.  Returns the largest absolute error of any gradient, and the
    reduction's."""
    import torch

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import (
        selective_scan_bwd_ref,
        selective_scan_ref,
        sum_partials_ref,
    )

    mc = cfg.mamba
    dn, n = mc.expand * cfg.d_model, mc.d_state
    phase(f"K4-bwd vs plain ({MAMBA}: Dn {dn}, N {n}, bf16 x and dy)")
    gen = torch.Generator(device=dev).manual_seed(24)
    worst = 0.0
    for label, bt, s in SCAN_BWD_SHAPES:
        d_block = ops.default_bwd_d_block(n, bt, s, dn)
        print(f"{label}: {scan_bwd_plan(ops, n, bt, s, dn)}")
        args, dy = scan_bwd_inputs(torch, gen, cfg, bt, s)
        y0, h0 = ops.selective_scan(*args)
        y, h, tiles = ops.selective_scan(*args, return_tile_states=True)
        want_y, want_h, want_tiles = selective_scan_ref(*args, return_tile_states=True)
        tile_err = float((tiles - want_tiles).abs().max())
        err_h = float((h - want_h).abs().max())
        ulps = bf16_ulps(y, want_y, SCAN_RTOL_OF_MAX * float(want_y.float().abs().max()))
        if not (torch.equal(y, y0) and torch.equal(h, h0)):
            fail(f"K4 at {label}: y or h moved with the tile states")
        if tile_err > SCAN_RTOL_OF_MAX * float(want_tiles.abs().max()) or \
                err_h > SCAN_RTOL_OF_MAX * float(want_h.abs().max()) or ulps > MAX_BF16_ULPS:
            fail(f"K4 with tile states at {label}: states off by {tile_err:.3g}, h by {err_h:.3g}, "
                 f"y {ulps:.0f} bf16 ulp past the atol")
        got = ops.selective_scan_bwd(*args, dy, tiles)
        again = ops.selective_scan_bwd(*args, dy, tiles)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"K4-bwd at {label}: two launches gave different bits")
        want = selective_scan_bwd_ref(*args, dy, d_block=d_block)
        errs = []
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            worst = max(worst, err)
            atol = SCAN_BWD_RTOL_OF_MAX * scale
            bad = (bf16_ulps(g.float(), w.float(), atol) > MAX_BF16_ULPS
                   if g.dtype == torch.bfloat16 else err > atol)
            if bad or not bool(torch.isfinite(g.float()).all()):
                fail(f"K4-bwd at {label}: {name} off by {err:.3g} (max |{name}| {scale:.3g})")
            errs.append(f"{name} {err:.3g} ({err / scale:.2e} of max {scale:.3g})")
        print(f"{label} (B {bt}, S {s}, {-(-s // 256)} tiles): K4's y and h the same bits with "
              f"tile states; against the plain version max|dh| {err_h:.3g} (max|h| "
              f"{float(want_h.abs().max()):.3g}), y within {ulps:.0f} bf16 ulp past "
              f"{SCAN_RTOL_OF_MAX:.2e} max|y|, states within {tile_err:.3g}; K4-bwd two launches "
              f"bitwise; max |kernel - plain|: {', '.join(errs)}")
    print(f"tolerance: K4's y, h and states as phase 13's; each gradient within "
          f"{SCAN_BWD_RTOL_OF_MAX:.2e} of its max |value|, bf16 ones plus {MAX_BF16_ULPS} bf16 ulp")
    bt, s = SCAN_BWD_SHAPES[0][1:]
    d_block = ops.default_bwd_d_block(n, bt, s, dn)
    parts, outs, _ = reduce_parts(torch, gen, dev, bt, s, dn, n, d_block)
    ops.selective_scan_bwd_reduce(parts, outs)
    torch.cuda.synchronize()
    reduce_err = 0.0
    for name, part, out in zip(("dB", "dC", "dA", "dD"), parts, outs):
        want = sum_partials_ref(part, out.dtype)
        reduce_err = max(reduce_err, float((out.float() - want.float()).abs().max()))
        if not torch.equal(out, want):
            fail(f"K4-bwd's reduction: {name} differs from its plain version")
    print(f"selective_scan_bwd_reduce on random partials of the training shape ({parts[0].shape[0]} "
          f"clusters of channel blocks, B {bt}): each output the plain version's bits (the same "
          f"additions in the same order, one rounding to bf16)")
    return worst, reduce_err


def scan_bwd_timings(dev, cfg) -> dict:
    """Phase 24b: K4-bwd's time a call (its two launches) at SCAN_BWD_SHAPES
    by CUDA events after warm-up, beside its bound and its plain version's
    time; no single PyTorch call computes it; then its reduction's alone at
    the training shape, beside the reduction's bound, its plain version's
    and the four ``torch.sum`` calls that compute it.  Returns the kernels
    line's rows of both."""
    import torch

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref, sum_partials_ref

    phase("K4-bwd timings (CUDA events, after warm-up)")
    mc = cfg.mamba
    dn, n = mc.expand * cfg.d_model, mc.d_state
    gen = torch.Generator(device=dev).manual_seed(25)
    row = {}
    for label, bt, s in SCAN_BWD_SHAPES:
        d_block = ops.default_bwd_d_block(n, bt, s, dn)
        occ = ops.bwd_occupancy(n, bt, s, dn, torch.bfloat16)
        args, dy = scan_bwd_inputs(torch, gen, cfg, bt, s)
        _, _, tiles = ops.selective_scan(*args, return_tile_states=True)
        ms = cuda_ms(lambda: ops.selective_scan_bwd(*args, dy, tiles), reps=20)
        in_graph = graph_ms(lambda: ops.selective_scan_bwd(*args, dy, tiles), reps=20)
        fwd_ms = cuda_ms(lambda: ops.selective_scan(*args, return_tile_states=True), reps=20)
        plain = cuda_ms(lambda: selective_scan_bwd_ref(*args, dy, d_block=d_block), reps=2,
                        warmup=1)
        bound, by, mb, n_exp, own = scan_bwd_bound(bt, s, dn, n, d_block)
        own_mb = own["tile_states_mb"] + own["partials_mb"]
        print(f"selective_scan_bwd {label} B={bt} S={s} Dn={dn} N={n}: {ms:.4f} ms a call (scan "
              f"pass and reduction; {in_graph:.4f} from a CUDA graph), plain {plain:.3f} ms, bound "
              f"{bound:.4f} ms ({by}: {mb:.2f} MB "
              f"at 3.35 TB/s; {n_exp / 1e6:.1f} M exponentials at {EXP_PER_S / 1e12:.2f} T/s), "
              f"{100 * bound / ms:.2f}% of bound; the design's own traffic, {own_mb:.2f} MB more "
              f"({own_mb / 3.35e3:.4f} ms at 3.35 TB/s): the tile states read "
              f"{own['tile_states_mb']:.2f} MB, the partials of dB and dC written and read again "
              f"{own['partials_mb']:.2f} MB; K4 forward with tile states {fwd_ms:.4f} ms; no "
              f"single PyTorch call computes it; {scan_bwd_plan(ops, n, bt, s, dn)}")
        if label == SCAN_BWD_SHAPES[0][0]:
            row = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bound,
                   "bound_by": by, "shape": f"B {bt}, S {s}, Dn {dn}, N {n}, bf16, d_block "
                   f"{d_block}", "ms_covers": "the scan pass and the reduction it calls", **own,
                   "graph_ms": in_graph, "forward_with_tile_states_ms": fwd_ms, "plan": occ}
        else:
            row.update({f"ms_at B {bt} S {s}": ms, f"bound_ms_at B {bt} S {s}": bound,
                        f"plain_ms_at B {bt} S {s}": plain, f"graph_ms_at B {bt} S {s}": in_graph,
                        f"plan_at B {bt} S {s}": occ,
                        f"partials_mb_at B {bt} S {s}": own["partials_mb"]})
    bt, s = SCAN_BWD_SHAPES[0][1:]
    d_block = ops.default_bwd_d_block(n, bt, s, dn)
    parts, outs, nbytes = reduce_parts(torch, gen, dev, bt, s, dn, n, d_block)
    ms = cuda_ms(lambda: ops.selective_scan_bwd_reduce(parts, outs), reps=20)
    in_graph = graph_ms(lambda: ops.selective_scan_bwd_reduce(parts, outs), reps=20)
    plain = cuda_ms(lambda: [sum_partials_ref(p, o.dtype) for p, o in zip(parts, outs)], reps=5)
    sums = cuda_ms(lambda: [torch.sum(p, 0, dtype=torch.float32).to(o.dtype)
                            for p, o in zip(parts, outs)], reps=20)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"selective_scan_bwd_reduce at the training shape ({parts[0].shape[0]} clusters): "
          f"{ms:.4f} ms a launch by events (the wrapper's host time), {in_graph:.4f} from a CUDA "
          f"graph, plain {plain:.4f} ms, bound {bound:.4f} ms (bytes: {nbytes / 1e6:.2f} MB at "
          f"3.35 TB/s), {100 * bound / in_graph:.2f}% of bound from the graph; four torch.sum "
          f"calls over the first axis {sums:.4f} ms (no single call)")
    reduce_row = {"ms": ms, "graph_ms": in_graph, "plain_ms": plain, "library_ms": None,
                  "bound_ms": bound, "bound_by": "bytes", "torch_sum_calls_ms": sums,
                  "shape": f"{parts[0].shape[0]} blocks x B {bt}, S {s}, N {n} (dB, dC, bf16); "
                  f"B {bt} x Dn {dn}, N {n} (dA, dD)"}
    return row, reduce_row


def scan_bwd_plan(ops, n, bt, s, dn) -> str:
    """K4-bwd's plan at (Bt, S, Dn, N) and what the card's occupancy
    calculator makes of it, as text."""
    import torch

    o = ops.bwd_occupancy(n, bt, s, dn, torch.bfloat16)
    return (f"plan: {o['lanes']} lanes a channel's tile, d_block {o['d_block']}, clusters of "
            f"{o['cluster']} blocks ({o['clusters']} a sequence), {o['smem_bytes']} bytes of "
            f"shared memory a block; the card: {o['blocks_per_sm']} blocks an SM, "
            f"{o['active_clusters']} clusters at once, {o['registers']} registers a thread")


def load_ops_from(checkout: Path, name: str, family: str = "ssm_scan"):
    """The ``ops`` module of a kernel family (``ssm_scan``,
    ``flash_attention``) of the checkout at DIR, loaded beside this tree's
    under another name: its kernels build from DIR's sources into DIR's
    build directory; the rest it imports (``kernels/_build.py``, the plain
    versions) is this tree's."""
    import importlib.util

    path = checkout / "src" / "repro_torch" / "kernels" / family / "ops.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scan_bwd_times_main(checkout: Path) -> None:
    """``python3 chip_smoke.py --scan-bwd-times DIR``: K4 and K4-bwd built
    from the checkout at DIR (the parent) and from this tree, in one
    process.  At SCAN_BWD_SHAPES: K4's y, h and tile states from both, bit
    for bit; each K4-bwd against the plain version (this tree's within the
    stated tolerance, the parent's error printed) and two launches bitwise;
    then each K4-bwd's time a call (its scan pass and reduction, CUDA
    events, 20 calls after warm-up) in turns: parent, this tree, this
    tree, parent; printed as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref

    parent = load_ops_from(checkout, "parent_ssm_scan_ops")
    print(f"card: {nvidia_smi_line()}; parent K4 and K4-bwd from {checkout}")
    build_all([ops.LIBRARY, ops.BWD_LIBRARY, parent.LIBRARY, parent.BWD_LIBRARY])
    dev, cfg = torch.device("cuda"), get_config(MAMBA)
    mc = cfg.mamba
    dn, n = mc.expand * cfg.d_model, mc.d_state
    gen = torch.Generator(device=dev).manual_seed(26)
    versions = {"parent": parent, "change": ops}
    result = {"scan_bwd_times": str(checkout)}
    for label, bt, s in SCAN_BWD_SHAPES:
        args, dy = scan_bwd_inputs(torch, gen, cfg, bt, s)
        fwd = {k: m.selective_scan(*args, return_tile_states=True) for k, m in versions.items()}
        same = all(torch.equal(a, b) for a, b in zip(fwd["parent"], fwd["change"]))
        print(f"{label} (B {bt}, S {s}): K4's y, h and tile states, parent and change: "
              f"{'the same bits' if same else 'DIFFERENT'}")
        if not same:
            fail(f"K4's forward moved at {label}")
        tiles = fwd["change"][2]
        want = selective_scan_bwd_ref(*args, dy, d_block=ops.default_bwd_d_block(n, bt, s, dn))
        row = {"plan": ops.bwd_occupancy(n, bt, s, dn, torch.bfloat16)}
        for k, m in versions.items():
            got = m.selective_scan_bwd(*args, dy, tiles)
            again = m.selective_scan_bwd(*args, dy, tiles)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
            errs = {}
            for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
                scale = float(w.float().abs().max())
                err = float((g.float() - w.float()).abs().max())
                atol = SCAN_BWD_RTOL_OF_MAX * scale
                bad = (bf16_ulps(g.float(), w.float(), atol) > MAX_BF16_ULPS
                       if g.dtype == torch.bfloat16 else err > atol)
                errs[name] = err / scale
                if k == "change" and (bad or not bitwise):
                    fail(f"K4-bwd at {label}: {name} off by {err:.3g} (max {scale:.3g}) or two "
                         "launches differ")
            row[f"{k}_rel_err"] = errs
            print(f"  {k}: two launches {'bitwise' if bitwise else 'DIFFERENT'}; max |kernel - "
                  "plain| / max |plain|: " + ", ".join(f"{a} {e:.2e}" for a, e in errs.items()))
        for k in ("parent", "change", "change", "parent"):
            m = versions[k]
            row.setdefault(k, []).append(cuda_ms(lambda: m.selective_scan_bwd(*args, dy, tiles),
                                                 reps=20))
        for k, m in versions.items():  # the device's time, without the wrappers' host time
            row[f"{k} graph"] = graph_ms(lambda: m.selective_scan_bwd(*args, dy, tiles), reps=20)
        bound, by, mb, _, own = scan_bwd_bound(bt, s, dn, n, ops.default_bwd_d_block(n, bt, s, dn))
        row.update(bound_ms=bound, bound_by=by, mb=mb, **own)
        print(f"  ms a call in turns: parent {row['parent'][0]:.4f}, change "
              f"{row['change'][0]:.4f}, change {row['change'][1]:.4f}, parent "
              f"{row['parent'][1]:.4f} (from a CUDA graph: "
              f"parent {row['parent graph']:.4f}, change {row['change graph']:.4f}); bound "
              f"{bound:.4f} ({by}); {scan_bwd_plan(ops, n, bt, s, dn)}")
        result[label] = row
    print(json.dumps(result))


def mamba_moe_training_path(arch, n_layers, path_no, per_layer) -> dict:
    """Phases 24c, 24d and 26c: ``Trainer`` on ``arch`` at full width and
    ``n_layers`` layers (``TrainerOptions.cfg``), the stablelm path's
    settings: seq 128, global batch 8, AdamW at lr 1e-3, remat "full",
    TRAIN_STEPS steps.  Gates: losses, aux and grad norms finite (aux > 0
    where a MoE layer runs, else 0); each kernel of ``per_layer`` launched
    that many times a layer a step, no other kernel.  Returns the launches
    and the trainer."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerOptions

    full = get_config(arch)
    phase(f"main path {path_no}: LM training, Trainer on {arch} at full width, {n_layers} of "
          f"{full.n_layers} layers, seq {TRAIN_SEQ}, global batch {TRAIN_BATCH}, AdamW lr 1e-3, "
          f"remat full, {TRAIN_STEPS} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(TrainerOptions(arch=arch, smoke=False, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH, log_every=0,
                                     cfg=dataclasses.replace(full, n_layers=n_layers)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = trainer.cfg
    n_params = sum(p.numel() for p in trainer.lm.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B parameters; remat {trainer.rt.remat}; state built in "
          f"{build_s:.1f} s")
    if (cfg.d_model, cfg.vocab_size) != (full.d_model, full.vocab_size) or \
            cfg.n_layers != n_layers or trainer.rt.remat != "full":
        fail(f"the training path did not run {arch} at full width with full remat")
    reset_launches()
    trainer.run()
    counts = read_launches()
    records = trainer.records
    times = [r["step_time"] for r in records[1:]]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print("losses: " + ", ".join(f"{r['loss']:.4f}" for r in records))
    print("aux: " + ", ".join(f"{r['aux']:.6f}" for r in records))
    print("grad norms: " + ", ".join(f"{r['grad_norm']:.4f}" for r in records))
    print(f"step ms: first {1e3 * records[0]['step_time']:.1f}, then median {1e3 * med:.1f} "
          f"(min {1e3 * min(times):.1f}, max {1e3 * max(times):.1f}); "
          f"{TRAIN_SEQ * TRAIN_BATCH / med:.0f} tokens/s; peak device memory {peak:.3f} GB "
          "(host clock around each step, synchronised)")
    moe = any(spec.ffn == "moe" for spec in cfg.layer_specs())  # a MoE layer runs
    if len(records) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and math.isfinite(r["aux"])
            and (r["aux"] > 0) == moe for r in records):
        fail(f"training {arch}: {len(records)} steps, losses, aux or grad norms wrong")
    expected = {name: per_layer.get(name, 0) * n_layers * TRAIN_STEPS for name in counts}
    print("launches: " + ", ".join(f"{name} {counts[name]} = {per_layer[name]} x {n_layers} x "
                                   f"{TRAIN_STEPS}" for name in per_layer))
    if counts != expected:
        fail(f"training {arch}: launches {counts}, expected {expected}")
    training_step_split(trainer)
    return counts, trainer


def moe_gradient_bits(trainer) -> None:
    """Phases 24d and 26c, continued: the loss, aux and every gradient of
    one step of the trainer's LM, taken twice from the same weights and
    batch, the same bits."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokens

    lm = trainer.lm
    batch = SyntheticTokens(lm.cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0).next_batch()
    batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
    runs = []
    for _ in range(2):
        for p in lm.parameters():
            p.grad = None
        loss, extra = lm.loss_fn(batch, trainer.rt)
        loss.backward()
        runs.append((loss.detach(), extra["aux"].detach(),
                     [p.grad.clone() for p in lm.parameters()]))
    for p in lm.parameters():
        p.grad = None
    (l1, a1, g1), (l2, a2, g2) = runs
    same = torch.equal(l1, l2) and torch.equal(a1, a2) and all(
        torch.equal(x, y) for x, y in zip(g1, g2))
    print(f"one step's gradient twice from the same weights and batch: loss {float(l1):.6f}, aux "
          f"{float(a1):.6f}, {len(g1)} gradient tensors; bit_identical={'yes' if same else 'NO'}")
    if not same:
        fail(f"the {lm.cfg.name} training step's gradients differ between two runs")


def static_serve_path(lm) -> dict:
    """Phase 10c: the serve CLI's static mode, ``Server.generate``, at full
    width on phase 10's qwen3-14b: batch 4, prompts of 16 tokens, 16
    generated each.  K3 launches = 40 x prefills, K2 = 40 x decode steps."""
    import numpy as np

    from repro_torch.launch import serve

    phase(f"main path 3c: python -m repro_torch.launch.serve {' '.join(STATIC_ARGV)} "
          "(Server.generate, full width, phase 10's weights)")
    reset_launches()
    t0 = time.perf_counter()
    res = serve.main(STATIC_ARGV, lm=lm)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    eng = res["server"]._engine
    prefills, steps = eng.prefills_run, eng.stats()["decode_steps"]
    print(f"Server.generate: tokens {res['tokens'].shape}, prefill {1e3 * res['prefill_s']:.1f} "
          f"ms (4 prompts), decode {res['decode_tok_per_s']:.1f} tok/s over "
          f"{1e3 * res['decode_s']:.1f} ms; {prefills} prefills, {steps} decode steps; "
          f"{seconds:.1f} s in all")
    if res["tokens"].shape != (4, 16) or not np.all((res["tokens"] >= 0) &
                                                   (res["tokens"] < lm.cfg.vocab_size)):
        fail(f"Server.generate returned tokens {res['tokens'].shape}")
    check_path_launches(QWEN, counts, lm.cfg.n_layers, prefills, steps, "static serve")
    return counts


# ------------------------------------------- the rest of the catalog (slice 17)

JAMBA = "jamba-1.5-large-398b"
INTERNVL = "internvl2-76b"
MUSICGEN = "musicgen-medium"
# 27a: the smoke archs no earlier phase holds on the card against the CPU
CATALOG_SMOKE = ("qwen1.5-110b", "qwen3-32b", JAMBA, INTERNVL, MUSICGEN)
# main path 10: musicgen-medium trained at full width and all 48 layers
MUSICGEN_LAYERS = 48
# main path 11: internvl2-76b served at full width, 16 of its 80 layers
# (15.79 B parameters, 31.6 GB of bf16; depth only), max_seq 1024, so that a
# request's 256 patches and prompt prefill in one 1024-row block
INTERNVL_LAYERS, INTERNVL_MAX_SEQ = 16, 1024
INTERNVL_STATIC = dict(batch=4, prompt_len=16, gen=16)
# 27b: the tokens after the frontend positions (the reference test's 8)
DECODE_TOKENS = 8
# 27b's bound: the reference's test_decode_matches_prefill_logits
DECODE_ATOL, DECODE_RTOL = 0.1, 0.05


def layers_by_mixer(cfg) -> dict:
    """{"attn": n, "mamba": n}: the layers each mixer kind runs."""
    specs = cfg.layer_specs()
    return {kind: sum(spec.mixer == kind for spec in specs) for kind in ("attn", "mamba")}


def contiguous_decode_check(dev) -> None:
    """Phase 27b: the contiguous cache's ``decode_step`` teacher-forced
    through every smoke arch on the card (the frontend's positions first,
    through ``frontend_embed``, then 8 tokens, from ``init_cache``) against
    one ``prefill`` of the whole row, within the reference test's atol 0.1,
    rtol 0.05, the MoE at its capacity_factor 100; then musicgen-medium at
    full width (48 layers, 64 frames + 8 tokens)."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.models.model import LM

    phase("27b: teacher-forced decode_step (the contiguous cache) vs prefill on the card, every "
          f"smoke arch, then {MUSICGEN} at full width")

    def check(cfg):
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=100.0))
        lm = LM(cfg, dev).init_params(torch.Generator(device=dev).manual_seed(1))
        rng = np.random.RandomState(1)
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, DECODE_TOKENS))).to(dev)
        f = cfg.n_frontend_tokens
        fe = torch.from_numpy((0.02 * rng.randn(2, f, cfg.d_model)).astype(np.float32)).to(dev)
        reset_launches()
        want, _ = lm.prefill(tokens, fe if f else None)
        cache = lm.init_cache(2, f + DECODE_TOKENS + 1)
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        for t in range(f + DECODE_TOKENS):
            if t < f:
                got, cache = lm.decode_step(tokens[:, 0], lengths, cache, frontend_embed=fe[:, t])
            else:
                got, cache = lm.decode_step(tokens[:, t - f], lengths, cache)
            lengths += 1
        counts = {k: v for k, v in read_launches().items() if v}
        got, want = got.float(), want.float()
        err = (got - want).abs()
        worst = float((err / (DECODE_ATOL + DECODE_RTOL * want.abs())).max())
        print(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {f} frontend "
              f"positions + {DECODE_TOKENS} tokens): max |decode - prefill| {float(err.max()):.4f}"
              f" (max |logit| {float(want.abs().max()):.3f}), {worst:.3f} of the bound; "
              f"launches {counts}")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{cfg.name}: teacher-forced decode_step does not reproduce prefill's logits")

    for arch in ARCH_IDS:
        check(get_smoke_config(arch))
    check(get_config(MUSICGEN))
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_flash():
    """K3 and K3-bwd's wrappers swapped for their plain versions
    (``flash_fwd_ref``, ``flash_bwd_ref`` at 64 x 64 tiles), which run on the
    card's tensors: a reference path for a whole training run."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    kernels = fa_ops.flash_fwd, fa_ops.flash_bwd

    def fwd(q, k, v, kv_lens, *, causal=True, sm_scale, q_offset=0, block_q=16, block_k=16,
            return_lse=False):
        return fa_ref.flash_fwd_ref(q, k, v, kv_lens, causal=causal, sm_scale=sm_scale,
                                    q_offset=q_offset, block_q=64, block_k=64,
                                    return_lse=return_lse)

    def bwd(q, k, v, kv_lens, out, lse, dout, *, causal=True, sm_scale, q_offset=0,
            block_q=16, block_k=16):
        return fa_ref.flash_bwd_ref(q, k, v, kv_lens, out, lse, dout, causal=causal,
                                    sm_scale=sm_scale, q_offset=q_offset, block_q=64,
                                    block_k=64)

    fa_ops.flash_fwd, fa_ops.flash_bwd = fwd, bwd
    try:
        yield
    finally:
        fa_ops.flash_fwd, fa_ops.flash_bwd = kernels


def training_vs_plain_flash(losses, opts) -> None:
    """Phase 27c, continued: main path 10's 8 steps again from the same seed
    with K3 and K3-bwd swapped for their plain versions on the card; each
    step's loss within TRAIN_LOSS_RTOL of the kernels' (the two differ by
    the bf16 rounding of attention's outputs and gradients, whose effect
    the Adam steps carry on).  ``losses`` are the kernels' run's, ``opts``
    its ``TrainerOptions``; the caller has freed its trainer."""
    import torch

    from repro_torch.launch.train import Trainer

    with plain_flash():
        plain = Trainer(opts)
        plain.run()
    want = [r["loss"] for r in plain.records]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print("the same 8 steps, K3 and K3-bwd swapped for their plain versions on the card: "
          "losses " + ", ".join(f"{x:.4f}" for x in want) + f"; the kernels' within "
          f"{worst:.3g} of them (limit {TRAIN_LOSS_RTOL})")
    if len(want) != len(losses) or worst > TRAIN_LOSS_RTOL:
        fail(f"main path 10's losses part from the plain flash path's: {worst:.3g}")
    del plain
    gc.collect()
    torch.cuda.empty_cache()


def frontend_kernel_timings(dev) -> dict:
    """Phase 27d, continued: K3 at main path 11's prefill block (B 1, 64
    query heads over 8, D 128, 1024 rows of which the first 290 are real:
    256 patches and a 34-token prompt; CUDA events) and K2 at its decode
    step (B 4, lengths 300-330 over 64 pages of 16; a CUDA graph, L2
    flushed), each beside its bound for what this input needs, its plain
    version's time and one PyTorch call's (SDPA over the real rows; over
    the gathered dense KV)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import paged_decode_stream

    hk, g, d = 8, 8, 128
    hq = hk * g
    gen = torch.Generator(device=dev).manual_seed(27)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = {}
    s, n = INTERNVL_MAX_SEQ, 290
    q, k, v = bf16(1, hq, s, d), bf16(1, hk, s, d), bf16(1, hk, s, d)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, lens, sm_scale=d ** -0.5), reps=10)
    plain = cuda_ms(lambda: flash_fwd_ref(q, k, v, lens, causal=True, sm_scale=d ** -0.5,
                                          q_offset=0, block_q=16, block_k=16), reps=2, warmup=1)
    qr, kr, vr = q[:, :, :n], k[:, :, :n], v[:, :, :n]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                                         enable_gqa=True), reps=20)
    pairs = sum(min(i + 1, n) for i in range(s))  # each row's keys, the padding rows' too
    nbytes = 2 * hq * s * d * 2 + 2 * hk * n * d * 2  # q, out; the real rows of k, v
    flops = 4 * hq * d * pairs
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    bound, by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"flash_fwd at main path 11's prefill block (Sq=Skv={s}, kv_len {n}, Hq {hq}, Hk {hk}, "
          f"D {d}, block_k 16): kernel {ms:.4f} ms, plain {plain:.3f} ms, SDPA over the {n} real "
          f"rows {lib:.4f} ms, bound {bound:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB), kernel at {100 * bound / ms:.2f}% of bound")
    rows["flash_fwd"] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                         "bound_by": by, "shape": f"B 1, Hq {hq}, Hk {hk}, S {s}, kv_len {n}"}

    b, page, npp = 4, 16, INTERNVL_MAX_SEQ // 16
    lengths = [300, 310, 320, 330]
    n_pages = 1 + b * npp
    kp, vp = bf16(n_pages, hk, page, d), bf16(n_pages, hk, page, d)
    tables = random_pages(torch, gen, dev, b, npp, n_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qd = bf16(b, hk, g, d)
    ctx = npp * page
    idx = tables.long()
    k_dense = kp[idx].movedim(2, 1).reshape(b, hk, ctx, d).contiguous()
    v_dense = vp[idx].movedim(2, 1).reshape(b, hk, ctx, d).contiguous()
    mask = (torch.arange(ctx, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q_sdpa = qd.reshape(b, hq, 1, d)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)

    def call():
        return fd_ops.paged_decode(qd, kp, vp, lens, tables, scale=d ** -0.5,
                                   pages_per_program=K2_ROW_PAGES_PER_PROGRAM)

    ms = graph_ms(call, reps=50, flush=flush)
    eager = cuda_ms(call, reps=50)
    plain = cuda_ms(lambda: paged_decode_stream(qd, kp, vp, lens, tables, scale=d ** -0.5,
                                                pages_per_program=K2_ROW_PAGES_PER_PROGRAM),
                    reps=5, warmup=1)
    lib = graph_ms(lambda: F.scaled_dot_product_attention(q_sdpa, k_dense, v_dense,
                                                          attn_mask=mask, enable_gqa=True),
                   reps=50, flush=flush)
    valid = sum(lengths)
    nbytes = 2 * valid * hk * d * 2 + 2 * b * hq * d * 2 + b * npp * 4 + b * 4
    flops = 4 * valid * hq * d
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    bound, by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"paged_decode at main path 11's decode step (B {b}, lengths {lengths}, Hk {hk}, G {g}, "
          f"D {d}, ppp {K2_ROW_PAGES_PER_PROGRAM}): kernel {ms:.4f} ms (CUDA graph, L2 flushed; "
          f"eager {eager:.4f}), plain {plain:.3f} ms, SDPA with a length mask on the gathered "
          f"dense KV {lib:.4f} ms (CUDA graph, L2 flushed), bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB), kernel at {100 * bound / ms:.2f}% of bound")
    rows["paged_decode"] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                            "bound_by": by, "eager_ms": eager, "timed_by": GRAPH_COLD_L2,
                            "shape": f"B {b}, Hk {hk}, G {g}, D {d}, lengths {lengths}"}
    return rows


def frontend_serve_path(dev) -> dict:
    """Phase 27d, main path 11: internvl2-76b at full width, 16 of its 80
    layers, every request with 256 patch embeddings: ``ServeEngine`` over the
    serve CLI's 8-request mixed trace (max_batch 4, page 16, max_seq 1024),
    8/8 served, K3 = 16 x prefills and K2 = 16 x decode steps; the same trace
    on a cold engine sharing the weights, the same tokens; ``Server.generate``
    at batch 4, 16 tokens and their embeddings, 16 generated; TTFT, decode
    step, tokens/s, peak memory.  Returns the path's launches."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import random_lm

    full = get_config(INTERNVL)
    cfg = dataclasses.replace(full, n_layers=INTERNVL_LAYERS)
    phase(f"main path 11: serving {INTERNVL} at full width, {INTERNVL_LAYERS} of "
          f"{full.n_layers} layers, {cfg.n_frontend_tokens} patch embeddings a request "
          f"(ServeEngine, the CLI's mixed trace; a cold engine; Server.generate)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = random_lm(cfg, dev, 0)
    torch.cuda.synchronize()
    params = list(lm.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads}, {sum(p.numel() for p in params) / 1e9:.3f} B parameters, weights "
          f"{sum(p.numel() * p.element_size() for p in params) / 1e9:.3f} GB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    if (cfg.d_model, cfg.n_heads, cfg.d_ff) != (full.d_model, full.n_heads, full.d_ff):
        fail("main path 11 is not internvl2-76b at full width")
    specs = serve._mixed_trace_specs(cfg, 16, 8, 0)
    geometry = dict(max_batch=4, page_size=16, max_seq=INTERNVL_MAX_SEQ)
    runs, total = [], {name: 0 for name in kernel_wrappers()}
    for which in ("warm", "cold"):
        eng = ServeEngine("", lm=lm, **geometry)
        reset_launches()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen, arrival_step=arr, frontend_embeds=fe)
                for p, gen, arr, fe in specs]
        stats = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        prefills, steps = eng.prefills_run, stats["decode_steps"]
        decode_ms = [1e3 * e.step_s for e in eng.events("serve_step") if e.op == "decode"]
        ttft = [1e3 * r.prefill_s for r in reqs]
        print(f"{which} engine: served {stats['requests_finished']}/8 in {eng.step_count} steps, "
              f"{seconds:.1f} s; {prefills} prefills (TTFT p50 {statistics.median(ttft):.1f} ms, "
              f"max {max(ttft):.1f}; prefill rows a block {eng.rt.prefill_rows}), {steps} "
              f"decode steps (median {statistics.median(decode_ms):.1f} ms, mean batch "
              f"{stats['mean_batch']:.2f}, {stats['decode_tok_per_s']:.1f} tok/s); "
              f"flash_fwd {counts['flash_fwd']} = {cfg.n_layers} x {prefills}, paged_decode "
              f"{counts['paged_decode']} = {cfg.n_layers} x {steps}")
        if stats["requests_finished"] != 8 or stats["prefix_hits"]:
            fail(f"main path 11 ({which}): served {stats['requests_finished']}/8, "
                 f"{stats['prefix_hits']} prefix hits")
        check_path_launches(INTERNVL, counts, cfg.n_layers, prefills, steps,
                            f"main path 11 ({which})")
        runs.append([list(r.generated) for r in reqs])
        total = {name: total[name] + counts[name] for name in total}
        del eng
    if runs[0] != runs[1]:
        fail("main path 11: the cold engine's tokens differ from the warm engine's")
    print("the cold engine sharing the weights: the same tokens, every request")
    rng = np.random.RandomState(0)
    st = INTERNVL_STATIC
    prompts = rng.randint(0, cfg.vocab_size, (st["batch"], st["prompt_len"])).astype(np.int32)
    fe = (0.02 * rng.randn(st["batch"], cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    server = serve.Server("", lm=lm, max_seq=st["prompt_len"] + cfg.n_frontend_tokens
                          + st["gen"] + 8)
    reset_launches()
    res = server.generate(prompts, st["gen"], fe)
    torch.cuda.synchronize()
    counts = read_launches()
    eng = server._engine
    prefills, steps = eng.prefills_run, eng.stats()["decode_steps"]
    print(f"Server.generate: tokens {res['tokens'].shape}, prefill {1e3 * res['prefill_s']:.1f} "
          f"ms ({st['batch']} requests of {cfg.n_frontend_tokens} + {st['prompt_len']} "
          f"positions), decode {res['decode_tok_per_s']:.1f} tok/s over "
          f"{1e3 * res['decode_s']:.1f} ms; {prefills} prefills, {steps} decode steps")
    if res["tokens"].shape != (st["batch"], st["gen"]) or not np.all(
            (res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)):
        fail(f"main path 11: Server.generate returned tokens {res['tokens'].shape}")
    check_path_launches(INTERNVL, counts, cfg.n_layers, prefills, steps,
                        "main path 11 (Server.generate)")
    total = {name: total[name] + counts[name] for name in total}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del server, eng, lm, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def jamba_smoke_paths(dev) -> None:
    """Phase 27e: jamba's smoke period on the card (7 Mamba layers,
    attention at position 4, top-2 MoE on the odd layers): the serve CLI's
    ``--continuous`` path (8/8, prefix reuse ``bit_identical=yes``; K3 and K2
    once an attention layer a prefill or decode step, K4 once a Mamba
    layer), the smoke trainer card vs CPU through K3, K3-bwd, K4 and K4-bwd,
    and one step's gradient twice, the same bits."""
    import torch

    from repro_torch.launch import serve

    phase(f"27e: python -m repro_torch.launch.serve --arch {JAMBA} --smoke --continuous "
          "(on the card)")
    reset_launches()
    try:
        result = serve.main(["--arch", JAMBA, "--smoke", "--continuous"])
    except SystemExit as e:
        fail(f"the jamba serve CLI exited with {e.code}")
    counts = read_launches()
    warm, cold = result["engines"]
    prefills = sum(e.prefills_run for e in (warm, cold))
    steps = sum(e.stats()["decode_steps"] for e in (warm, cold))
    kinds = layers_by_mixer(warm.cfg)
    expected = {name: 0 for name in counts}
    expected.update(flash_fwd=kinds["attn"] * prefills, paged_decode=kinds["attn"] * steps,
                    selective_scan=kinds["mamba"] * (prefills + steps))
    step_launches = kernel_wrappers()["selective_scan"].step_launches
    print(f"{warm.cfg.name}: {kinds['attn']} attention and {kinds['mamba']} Mamba layers; "
          f"{prefills} prefills, {steps} decode steps; launches {counts} (K4's decode body "
          f"{step_launches})")
    if result["served"] != 8 or counts != expected or step_launches != kinds["mamba"] * steps:
        fail(f"jamba serve CLI: served {result['served']}, launches {counts}, expected "
             f"{expected}")
    del warm, cold, result
    training_kernels_vs_plain(dev, JAMBA, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                                           "selective_scan", "selective_scan_bwd",
                                           "selective_scan_bwd_reduce"))
    trainer = smoke_trainer(dev, JAMBA)
    moe_gradient_bits(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()



# ------------------------------ the router, migration and tracing (slice 18)

# Main path 12 (phase 28a): the serve CLI's routed fleet with a mid-run
# handoff and span tracing on phase 10's qwen3-14b (28b: on phase 15's
# falcon-mamba-7b)
ROUTER_ARGV = ["--router", "--replicas", "2", "--migrate-at", "3"]
# 28c's SLO: the per-token objective at this multiple of the run's median
# per-token latency
SLO_TARGET_OF_MEDIAN = 1.5


def router_engines(result) -> list:
    """Every engine the router CLI built: the single engine and the prefix
    check's cold one, the fleet's replicas and the engine the handoff
    replaced."""
    routed = result["routed"]
    return [*result["engines"], *routed["router"].engines, *routed["replaced"]]


def run_router_cli(argv, lm, what) -> tuple:
    """``serve.main(argv, lm=lm)`` with every kernel's count set to 0 just
    before; returns the result, the counts and the seconds it took."""
    from repro_torch.launch import serve

    reset_launches()
    t0 = time.perf_counter()
    try:
        result = serve.main(argv, lm=lm)
    except SystemExit as e:
        fail(f"{what}: the serve CLI exited with {e.code}")
    return result, read_launches(), time.perf_counter() - t0


def decode_step_ms(engines) -> list:
    """The decode steps' times (ms) of ``engines``' serve_step events."""
    return [1e3 * e.step_s for eng in engines for e in eng.events("serve_step")
            if e.op == "decode"]


def check_router_run(arch, result, counts, what) -> dict:
    """The gates every router CLI run passes: 8/8 served by the single
    engine and the fleet, ``bit_identical=yes``, a handoff with requests in
    flight, and the path's kernels launched once a layer for each prefill
    and decode step of every engine the run built, no other kernel.
    Returns the prefills and decode steps."""
    routed = result["routed"]
    engines = router_engines(result)
    prefills = sum(e.prefills_run for e in engines)
    steps = sum(e.stats()["decode_steps"] for e in engines)
    n_layers = engines[0].cfg.n_layers
    if result["served"] != 8 or routed["stats"]["requests_finished"] != 8:
        fail(f"{what}: served {result['served']}/8, the fleet finished "
             f"{routed['stats']['requests_finished']}/8")
    if routed["bit_identical"] is not True:
        fail(f"{what}: the routed fleet's tokens are not the single engine's")
    migration = routed["migration"]
    if migration is None or migration["in_flight"] < 1:
        fail(f"{what}: no handoff with a request in flight ({migration})")
    check_path_launches(arch, counts, n_layers, prefills, steps, what)
    if arch == MAMBA:
        step_launches = kernel_wrappers()["selective_scan"].step_launches
        if step_launches != n_layers * steps:
            fail(f"{what}: {step_launches} decode-body launches, not {n_layers} x {steps}")
    return {"prefills": prefills, "decode_steps": steps}


def router_path(arch, lm, path_no, workdir: Path, tune_cache=None) -> dict:
    """Phases 28a and 28b: ``python -m repro_torch.launch.serve --arch ARCH
    --continuous --router --replicas 2 --migrate-at 3 --trace F --router-log
    G`` in process on ``lm`` (and ``--tune-cache``): the gates of
    ``check_router_run``, the trace file's schema and the spans reconciled
    with the step times within 5% (the CLI exits 1 otherwise; checked again
    here), each replica's decode step and tokens/s, the handoff's ms and MB.
    Returns the kernels' launches, the files and the numbers."""
    import numpy as np
    import torch

    from repro_torch.telemetry.trace import load_perfetto, validate_perfetto

    trace, log = workdir / f"trace_{arch}.json", workdir / f"router_{arch}.jsonl"
    argv = ["--arch", arch, "--continuous", *ROUTER_ARGV, "--trace", str(trace),
            "--router-log", str(log)]
    if tune_cache is not None:
        argv += ["--tune-cache", str(tune_cache)]
    phase(f"main path {path_no}: python -m repro_torch.launch.serve {' '.join(argv)} "
          f"(full width, {lm.cfg.n_layers} layers, the model of the plain run)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result, counts, seconds = run_router_cli(argv, lm, f"{arch} router")
    ran = check_router_run(arch, result, counts, f"{arch} router CLI")
    routed, info = result["routed"], result["routed"]["migration"]
    errs = validate_perfetto(load_perfetto(trace))
    rel = result["trace"]["reconcile"]
    if errs or rel is None or rel > 0.05:
        fail(f"{arch} trace: schema {errs[:3]}, reconciliation {rel}")
    per_replica = {}
    for r in range(len(routed["router"].engines)):
        mine = [e for eng in [*routed["router"].engines, *routed["replaced"]]
                for e in eng.events("serve_step") if e.replica == r and e.op == "decode"]
        busy = sum(e.step_s for e in mine)
        per_replica[r] = {"decode_steps": len(mine),
                          "decode_step_ms_median": float(np.median([1e3 * e.step_s
                                                                    for e in mine])),
                          "tok_per_s": sum(e.committed for e in mine) / busy if busy else 0.0}
    if arch == MAMBA:  # K4's decode body runs the decode steps, its tile body the prefills
        ran["selective_scan_step_launches"] = kernel_wrappers()["selective_scan"].step_launches
    out = {"arch": arch, "cli_s": seconds, **ran, "per_replica": per_replica,
           "dispatch_per_replica": routed["stats"]["dispatch_per_replica"],
           "affinity_hits": routed["stats"]["affinity_hits"],
           "handoff_ms": 1e3 * info["wall_s"], "handoff_mb": info["nbytes"] / 1e6,
           **{f"handoff_{part}_ms": 1e3 * info[f"{part}_s"]
              for part in ("snapshot", "build", "restore")},
           "handoff_in_flight": info["in_flight"], "handoff_pages": info["pages_in_use"],
           "handoff_leaves": info["n_shards"], "spans": result["trace"]["spans"],
           "span_reconciliation": rel,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **{f"{name}_launches": counts[name] for name in PATH_KERNELS[arch]}}
    print(json.dumps({"router_path": out}))
    for name, (per_prefill, per_step) in PATH_KERNELS[arch].items():
        terms = " + ".join(t for t, on in (("prefills", per_prefill), ("decode steps", per_step))
                           if on)
        print(f"{name} launches {counts[name]} = {lm.cfg.n_layers} x ({terms}) of the "
              f"{len(router_engines(result))} engines the CLI built")
    return {"launches": counts, "trace": trace, "log": log, **out}


def trace_cost_and_replay(lm, workdir: Path, tune_cache) -> dict:
    """Phase 28a's tail: the router CLI again without ``--trace`` and with
    it, in turns (off, on, on, off; the traced runs on the step clock),
    every run's gates checked, the decode step's median over each run's
    engines printed; the two step-clock runs' trace files byte for byte the
    same."""
    import numpy as np

    base = ["--arch", QWEN, "--continuous", *ROUTER_ARGV, "--tune-cache", str(tune_cache)]
    phase(f"28a: the router CLI without --trace and with --trace --trace-clock steps, in "
          f"turns (off, on, on, off); the two traced runs' files byte for byte")
    medians, files = {"off": [], "on": []}, []
    for turn, traced in enumerate((False, True, True, False)):
        argv = list(base)
        if traced:
            files.append(workdir / f"trace_steps_{turn}.json")
            argv += ["--trace", str(files[-1]), "--trace-clock", "steps"]
        result, counts, _ = run_router_cli(argv, lm, f"router turn {turn}")
        check_router_run(QWEN, result, counts, f"router turn {turn}")
        times = decode_step_ms(router_engines(result))
        key = "on" if traced else "off"
        medians[key].append(float(np.median(times)))
        print(f"turn {turn} (--trace {key}): decode step median {medians[key][-1]:.3f} ms over "
              f"{len(times)} steps")
    same = files[0].read_bytes() == files[1].read_bytes()
    out = {"decode_step_ms_median_traced": medians["on"],
           "decode_step_ms_median_untraced": medians["off"],
           "steps_clock_files_identical": same, "steps_clock_file_bytes": files[0].stat().st_size}
    print(json.dumps({"trace_cost": out}))
    if not same:
        fail("two runs at --trace-clock steps wrote different trace files")
    return out


def mamba_handoff_state(lm) -> None:
    """Phase 28b's state check on the card: an engine on ``lm`` serves a
    page-aligned prompt (stored whole, the Mamba layers' state after it
    with it) and a second request; at a step boundary with that request in
    flight it is snapshotted and restored onto a fresh engine: the slot-major
    state and the full-prompt entries' states the same bits, the page tables
    mirrored on the card, and both engines' next tokens (the stored prompt
    served again from its entry) the same."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeEngine, restore_engine, snapshot_engine
    from repro_torch.serve.migrate import snapshot_nbytes

    phase(f"28b: {MAMBA}'s slot-major state and full-prompt entries across a handoff "
          "(ServeEngine, snapshot_engine / restore_engine on the card)")
    rng = np.random.RandomState(28)
    aligned = rng.randint(0, lm.cfg.vocab_size, 32).astype(np.int32)
    make = lambda: ServeEngine("", lm=lm, max_batch=4, page_size=16, max_seq=96)  # noqa: E731
    src = make()
    src.submit(aligned, 2)
    src.run()
    src.submit(rng.randint(0, lm.cfg.vocab_size, 21).astype(np.int32), 8)
    for _ in range(3):
        src.step()
    in_flight = [r.rid for r in src.scheduler.slots if r is not None]
    reset_launches()
    snap = snapshot_engine(src)
    dst = make()
    restore_engine(dst, snap)
    launched = read_launches()
    full = list(src.prefix._full.items())
    same_state = all(torch.equal(dst.cache[i][n], src.cache[i][n])
                     for i in range(len(src.cache)) for n in src.cache[i])
    same_entries = [k for k, _ in full] == list(dst.prefix._full) and all(
        torch.equal(a[n], b[n]) for k, e in full
        for a, b in zip(dst.prefix._full[k].state, e.state) for n in a if a[n] is not None)
    tables = torch.equal(dst.page_tables_dev.cpu(), torch.from_numpy(src.page_tables))
    again = [eng.submit(aligned.copy(), 4) for eng in (src, dst)]
    src.run()
    dst.run()
    print(f"snapshot {snapshot_nbytes(snap) / 1e6:.2f} MB of state in {len(snap['cache'])} "
          f"layers; {len(full)} full-prompt entries; requests in flight {in_flight}; state the "
          f"same bits {same_state}, entries "
          f"{same_entries}, page tables {tables}; the stored prompt again: skipped "
          f"{[r.prefill_skipped for r in again]}, tokens equal "
          f"{again[0].generated == again[1].generated}; restore launched {launched}")
    if not (same_state and same_entries and tables and full and in_flight
            and all(r.prefill_skipped for r in again)
            and again[0].generated == again[1].generated and not any(launched.values())):
        fail(f"{MAMBA}: the handoff did not carry the state")


def telemetry_paths(path, tune_cache, n_layers) -> dict:
    """Phase 28c on phase 28a's router log: ``python -m repro_torch.telemetry
    summarize LOG --strict`` (exit 0, per-replica lines) and ``trace LOG
    --perfetto OUT --flame --tune-cache CACHE --n-layers 40`` (exit 0, the
    ``kernel/flash_decode_paged@b`` rows) in process; then the SLO monitor
    over the log's serve_step rows, the per-token objective at 1.5 x the
    run's median per-token latency, on the stream as it is and with every
    step time doubled from its midpoint (at least one alert must fire
    there, and ``CapacityPlanner.ingest`` keep it); and, since the default
    cooldown of 16 observations can hide the second half of a short stream
    behind an alert in its first, both streams again with no cooldown, the
    alerts at or after the midpoint counted (at least one on the doubled
    stream).  A step at batch 1 costs its whole time a token, several times
    a batch of 4's, so the healthy stream alerts too at 1.5 x the median."""
    import contextlib
    import dataclasses as dc
    import io

    import numpy as np

    from repro_torch.serve import CapacityPlanner
    from repro_torch.telemetry import read_events
    from repro_torch.telemetry.__main__ import main as telemetry
    from repro_torch.telemetry.trace import SloConfig, monitor_serve_events

    def cli(argv):
        print(f"$ python -m repro_torch.telemetry {' '.join(argv)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = telemetry(argv)
        print(buf.getvalue(), end="")
        return rc, buf.getvalue()

    phase("28c: python -m repro_torch.telemetry summarize|trace on main path 12's router log; "
          "the SLO monitor over its serve_step rows")
    rc, text = cli(["summarize", str(path), "--strict"])
    if rc != 0 or "per-replica:" not in text or "replica 1:" not in text:
        fail(f"telemetry summarize exited {rc} or printed no per-replica lines")
    perfetto = path.with_suffix(".perfetto.json")
    rc, text = cli(["trace", str(path), "--perfetto", str(perfetto), "--flame",
                    "--tune-cache", str(tune_cache), "--n-layers", str(n_layers)])
    kernel_rows = [line for line in text.splitlines()
                   if line.startswith("kernel/flash_decode_paged@b")]
    if rc != 0 or not kernel_rows:
        fail(f"telemetry trace exited {rc}, kernel rows {kernel_rows}")
    steps = sorted((e for e in read_events(path) if e.kind == "serve_step"
                    and e.op in ("decode", "verify")), key=lambda e: e.step)
    per_token = [e.step_s / max(e.committed, 1) for e in steps]
    target = SLO_TARGET_OF_MEDIAN * float(np.median(per_token))
    half = len(steps) // 2
    slowed = steps[:half] + [dc.replace(e, step_s=2.0 * e.step_s) for e in steps[half:]]
    healthy_alerts = monitor_serve_events(steps, per_token=SloConfig(target=target))
    slowed_alerts = monitor_serve_events(slowed, per_token=SloConfig(target=target))
    late = {name: sum(a.step >= steps[half].step for a in monitor_serve_events(
                stream, per_token=SloConfig(target=target, cooldown=0)))
            for name, stream in (("healthy", steps), ("2x", slowed))}
    planner = CapacityPlanner()
    planner.ingest(slowed_alerts)
    out = {"per_token_target_ms": 1e3 * target, "serve_steps": len(steps),
           "alerts_healthy": len(healthy_alerts), "alerts_2x_from_midpoint": len(slowed_alerts),
           "first_alert_step": slowed_alerts[0].step if slowed_alerts else None,
           "midpoint_step": steps[half].step, "planner_slo_alerts": len(planner.slo_alerts),
           "alerts_from_midpoint_no_cooldown": late, "kernel_rows": kernel_rows}
    print(json.dumps({"slo": out}))
    if not slowed_alerts or len(planner.slo_alerts) != len(slowed_alerts) or not late["2x"]:
        fail(f"no SLO alert on the 2x stream ({len(slowed_alerts)}; {late['2x']} from its "
             f"midpoint without cooldown), or the planner kept {len(planner.slo_alerts)}")
    return out


# ------------------------------------ tensor-parallel serving (slice 19)

# Main path 13 (phase 29c): the serve CLI with --tp 2 on qwen3-14b at full
# width and all 40 layers, two ranks sharing the card (gloo), the routed fleet
# of two 2-way replicas against a single 2-way engine; 29d: falcon-mamba-7b
# the same way at 8 of its 64 layers
TP_ARGV = ["--continuous", "--tp", "2", "--router", "--replicas", "2"]
TP_WORLD = 2
TP_MAMBA_LAYERS = 8
# the CLI's trace geometry (launch/serve.py: max_batch 4, pages of 16,
# max_seq 64 + 2 pages, seed 0, 8 requests)
TP_GEOMETRY = dict(max_batch=4, page_size=16, max_seq=96, seed=0)


def single_card_trace(lm, name="29a") -> dict:
    """Phase 29a, on phase 10's qwen3-14b before it is freed (and 29d's, on
    falcon-mamba-7b at main path 13b's depth): the CLI's 8-request trace
    through one unsharded engine, each request's tokens and every step's
    logits kept on the host (29b's and main path 13's yardstick)."""
    import numpy as np

    from repro_torch.launch.serve import _mixed_trace_specs
    from repro_torch.serve import ServeEngine

    phase(f"{name}: the CLI's trace through one unsharded engine on {lm.cfg.name} at "
          f"{lm.cfg.n_layers} layers, every step's logits kept")
    eng = ServeEngine("", lm=lm, collect_logits=True, **TP_GEOMETRY)
    reqs = [eng.submit(p, gen, arrival_step=arr)
            for p, gen, arr, _ in _mixed_trace_specs(lm.cfg, 16, 8, 0)]
    eng.run()
    return {"tokens": [list(r.generated) for r in reqs],
            "logits": [np.stack(r.logits_trace) for r in reqs]}


def nccl_world_one(lm, reference: dict, workdir: Path) -> None:
    """Phase 29b, on phase 10's qwen3-14b before it is freed: a one-rank
    NCCL group and a (1, 1) mesh in this process, the CLI's trace through
    ``ServeEngine(lm=lm, mesh=mesh)``: the model served is phase 10's itself,
    every request's tokens and every step's logits bit for bit the unsharded
    engine's (``single_card_trace``), K3 and K2 once a layer a prefill and a
    decode step."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh, mesh_shape
    from repro_torch.launch.serve import _mixed_trace_specs
    from repro_torch.serve import ServeEngine

    phase("29b: a world-size-1 NCCL group, (1, 1) mesh, at full width: bit for bit the "
          "unsharded engine")
    _, backend = init_distributed(0, 1, str(workdir / "nccl_world_one"))
    try:
        mesh = make_debug_mesh(1, 1)
        reset_launches()
        eng = ServeEngine("", lm=lm, mesh=mesh, collect_logits=True, **TP_GEOMETRY)
        reqs = [eng.submit(p, gen, arrival_step=arr)
                for p, gen, arr, _ in _mixed_trace_specs(lm.cfg, 16, 8, 0)]
        eng.run()
        counts = read_launches()
    finally:
        dist.destroy_process_group()
    same = [r.generated == want and len(r.logits_trace) == len(logits) and all(
        np.array_equal(a, b) for a, b in zip(r.logits_trace, logits))
        for r, want, logits in zip(reqs, reference["tokens"], reference["logits"])]
    print(f"backend {backend}, mesh {mesh_shape(mesh)}, the model phase 10's itself "
          f"{eng.lm is lm}; requests bit for bit the unsharded engine's: {sum(same)}/8")
    if backend != "nccl" or eng.lm is not lm or not all(same):
        fail("the (1, 1) mesh is not bit for bit the unsharded engine")
    check_path_launches(QWEN, counts, lm.cfg.n_layers, eng.prefills_run,
                        eng.stats()["decode_steps"], "the (1, 1) mesh")


def tp_path(arch, path_no, workdir: Path, tune_cache=None, cfg=None, reference=None) -> dict:
    """Phases 29c and 29d: ``python -m repro_torch.launch.serve --arch ARCH
    --continuous --tp 2 --router --replicas 2`` (and ``--tune-cache``) in
    process, on ``cfg`` (a cut depth) when given: the CLI spawns the two
    ranks, which build their halves of the model from seed 0, each matrix
    the single card's, sliced, and returns every rank's report.  Gates: the
    CLI's own (``bit_identical=yes`` for the fleet and the prefix reuse, the
    ranks' streams the same; it exits 1 otherwise), the ranks' token streams
    and logits equal, and on each rank the path's kernels once a layer a
    prefill and a decode step of the engines it built, no other kernel,
    none in this process.  Against ``reference`` (``single_card_trace`` on
    the same weights): every request's logits at every step up to and with
    its first token that differs from the single card's (the steps whose
    inputs are the same tokens) within the bf16 bounds of phase 9, and the
    count of token streams equal to the single card's printed (a bf16 near
    tie may flip one; the first divergence printed).  Prints each rank's
    decode step median and peak memory.  Returns the launches summed over
    the ranks."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    argv = ["--arch", arch, *TP_ARGV]
    if tune_cache is not None:
        argv += ["--tune-cache", str(tune_cache)]
    depth = "all layers" if cfg is None else f"{cfg.n_layers} layers"
    phase(f"main path {path_no}: python -m repro_torch.launch.serve {' '.join(argv)} "
          f"(full width, {depth}; {TP_WORLD} ranks on the one card)")
    reset_launches()
    t0 = time.perf_counter()
    try:
        summary = serve.main(argv, cfg=cfg)
    except SystemExit as e:
        fail(f"{arch} --tp {TP_WORLD}: the serve CLI exited with {e.code}")
    seconds = time.perf_counter() - t0
    if any(read_launches().values()):
        fail(f"{arch} --tp: this process launched {read_launches()}; the ranks launch")
    reports = summary["reports"]
    ranks_logits_same = all(
        len(rep["logits"]) == len(reports[0]["logits"]) and all(
            np.array_equal(a, b) for a, b in zip(rep["logits"], reports[0]["logits"]))
        for rep in reports)
    if summary["routed_bit_identical"] is not True or not summary["ranks_same"] \
            or [rep["rank"] for rep in reports] != list(range(TP_WORLD)) \
            or any(rep["tokens"] != reports[0]["tokens"] for rep in reports) \
            or not ranks_logits_same:
        fail(f"{arch} --tp: fleet {summary['routed_bit_identical']}, ranks the same "
             f"{summary['ranks_same']}, their logits the same bits {ranks_logits_same}")
    per_rank = []
    for rep in reports:
        n = rep["n_layers"]
        counts = {k: v for k, v in rep["launches"].items() if k != "selective_scan_step"}
        steps = rep["decode_steps"] + rep["verify_steps"]
        check_path_launches(arch, counts, n, rep["prefills"], steps,
                            f"{arch} --tp rank {rep['rank']}")
        if arch == MAMBA and rep["launches"]["selective_scan_step"] != n * rep["decode_steps"]:
            fail(f"rank {rep['rank']}: {rep['launches']['selective_scan_step']} decode-body "
                 f"launches, not {n} x {rep['decode_steps']}")
        per_rank.append({"rank": rep["rank"], "device": rep["device"],
                         "backend": rep["backend"], "prefills": rep["prefills"],
                         "decode_steps": rep["decode_steps"], "engines": rep["n_engines"],
                         "decode_step_ms_median": 1e3 * float(np.median(rep["decode_step_s"])),
                         "peak_memory_gb": rep["peak_memory_gb"],
                         **{f"{k}_launches": v for k, v in rep["launches"].items() if v}})
    out = {"arch": arch, "cli_s": seconds, "world": TP_WORLD, "mesh": summary["mesh"],
           "backend": summary["backend"], "per_rank": per_rank}
    if reference is not None:
        out.update(against_single_card(arch, reports[0], reference))
    print(json.dumps({"tp_path": out}))
    launches = {}
    for rep in reports:
        for k, v in rep["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, **out}


def against_single_card(arch, got: dict, reference: dict) -> dict:
    """Main path 13's rank 0 report ``got`` against ``single_card_trace``'s
    ``reference``: for each request, its logits at every step up to and with
    the first token that differs from the single card's (the steps whose
    inputs are the same tokens), each within LM_MAX_OF_SCALE (max) and
    LM_MEAN_OF_SCALE (mean) of that step's largest single-card logit, and
    finite.  Prints the worst of the first steps and of all steps held, and
    the count of equal token streams with the first divergence."""
    import numpy as np

    worst = {"first": [0.0, 0.0], "all": [0.0, 0.0]}
    held = 0
    for i, (logits, want, toks, want_toks) in enumerate(zip(
            got["logits"], reference["logits"], got["tokens"], reference["tokens"])):
        if not (len(logits) == len(toks) == len(want) == len(want_toks)):
            fail(f"{arch} --tp: request {i} has {len(logits)} logits for {len(toks)} tokens, "
                 f"the single card {len(want)} for {len(want_toks)}")
        n = next((j for j, (x, y) in enumerate(zip(toks, want_toks)) if x != y),
                 len(toks) - 1) + 1
        for t in range(n):
            ref = want[t].astype(np.float64)
            scale = float(np.abs(ref).max())
            err = np.abs(logits[t].astype(np.float64) - ref)
            rel = [float(err.max()) / scale, float(err.mean()) / scale]
            for key in ("first", "all")[t > 0:]:
                worst[key] = [max(w, r) for w, r in zip(worst[key], rel)]
            if not np.isfinite(logits[t]).all() or rel[0] > LM_MAX_OF_SCALE \
                    or rel[1] > LM_MEAN_OF_SCALE:
                fail(f"{arch} --tp: request {i}'s logits at step {t} off the single card's: "
                     f"max |d| {float(err.max())}, mean {float(err.mean())}, max |logit| "
                     f"{scale}")
        held += n
    equal = [a == b for a, b in zip(got["tokens"], reference["tokens"])]
    first = next(((i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
                  for i, (a, b) in enumerate(zip(got["tokens"], reference["tokens"]))
                  if a != b), None)
    print(f"against the single card: first-step logits within {worst['first'][0]:.2e} (max) "
          f"and {worst['first'][1]:.2e} (mean) of the largest logit, all {held} steps held "
          f"within {worst['all'][0]:.2e} and {worst['all'][1]:.2e} (limits "
          f"{LM_MAX_OF_SCALE}, {LM_MEAN_OF_SCALE}); token streams equal "
          f"{sum(equal)}/{len(equal)}"
          + (f", the first divergence at request {first[0]}, token {first[1]}" if first else ""))
    return {"first_logits_max_of_scale": worst["first"][0],
            "first_logits_mean_of_scale": worst["first"][1],
            "steps_held": held, "logits_max_of_scale": worst["all"][0],
            "logits_mean_of_scale": worst["all"][1],
            "streams_equal_to_single_card": sum(equal), "first_divergence": first}


def tp_local_config(cfg):
    """A rank's config under ``--tp 2``: ``ShardingPlan.local_config`` on a
    stand-in (1, 2) mesh, as rank 0 of the CLI's mesh resolves it."""
    import types

    import numpy as np

    from repro_torch.dist.partitioning import Rules
    from repro_torch.serve.sharding import ShardingPlan

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, TP_WORLD), dtype=object))
    return ShardingPlan(mesh=mesh, rules=Rules.for_serving(mesh), rank=0).local_config(cfg)


def tp_kernels_vs_plain(dev) -> dict:
    """Phase 29e's checks: K3 and K2 against their plain versions at a
    rank's heads (phases 8 and 8b on qwen3-14b's local config: 20 query
    heads over 4 KV heads, G 5), and K4's tile and decode bodies at a rank's
    channels (phase 13 on falcon-mamba-7b's: Dn 4096), at those phases'
    tolerances.  Returns the largest absolute error of each kernel."""
    from repro_torch.configs import get_config

    qwen = tp_local_config(get_config(QWEN))
    errs = serve_kernels_vs_plain(dev, qwen)
    for name, err in chunk_verify_kernels_vs_plain(dev, qwen).items():
        errs[name] = max(errs[name], err)
    mamba = tp_local_config(get_config(MAMBA))
    errs["selective_scan"], errs["selective_scan_step"] = scan_kernel_vs_plain(dev, mamba)
    return errs


def tp_kernel_timings(dev) -> dict:
    """Phase 29e: K3, K2 and K4 once at a rank's widths under ``--tp 2``,
    the kernels line's shapes with half the heads (K3: 20 over 4 at Sq =
    Skv = 2048; K2: B 8, context 1088, 4 KV heads of G 5, ppp 4, from a
    CUDA graph with the L2 flushed) or half the channels (K4: B 1, S 1024,
    Dn 4096), each beside its bound at that shape.  Returns {kernel: {ms,
    bound_ms, bound_by, shape}}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    phase(f"29e: K3, K2 and K4 timed at a rank's widths under --tp {TP_WORLD}")
    gen = torch.Generator(device=dev).manual_seed(29)
    out = {}

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def row(name, ms, nbytes, flops, shape, rate=BF16_FLOPS_PER_S):
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        bound = max(bytes_ms, ops_ms)
        print(f"{name} at {shape}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
              f"{100 * bound / ms:.2f}% of bound")
        out[name] = {"ms": ms, "bound_ms": bound, "bound_by": by, "shape": shape}

    cfg = tp_local_config(get_config(QWEN))
    hk, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    hq, s = hk * g, 2048
    q, k, v = bf16(1, hq, s, d), bf16(1, hk, s, d), bf16(1, hk, s, d)
    lens = torch.tensor([s], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: fa_ops.flash_fwd(q, k, v, lens, sm_scale=d ** -0.5), reps=10)
    row("flash_fwd", ms, (2 * hq + 2 * hk) * s * d * 2, 4 * hq * d * s * (s + 1) // 2,
        f"Sq=Skv={s} Hq={hq} Hk={hk}")

    b, ctx, page, ppp = LONG_BATCH, LONG_PROMPT + LONG_GEN, 16, K2_ROW_PAGES_PER_PROGRAM
    npp = ctx // page
    n_pages = 1 + b * npp
    kp, vp = bf16(n_pages, hk, page, d), bf16(n_pages, hk, page, d)
    tables = random_pages(torch, gen, dev, b, npp, n_pages)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = bf16(b, hk, g, d)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    ms = graph_ms(lambda: fd_ops.paged_decode(q, kp, vp, lens, tables, scale=d ** -0.5,
                                              pages_per_program=ppp), reps=50, flush=flush)
    row("paged_decode", ms, 2 * b * hk * ctx * d * 2 + 2 * b * hq * d * 2 + b * npp * 4 + b * 4,
        4 * b * hq * ctx * d, f"B={b} context={ctx} Hk={hk} G={g} ppp={ppp}")

    mcfg = tp_local_config(get_config(MAMBA))
    dn, n = mcfg.mamba.resolved_d_inner(mcfg.d_model), mcfg.mamba.d_state
    x, dt, a, b_ssm, c_ssm, dd, h = scan_inputs(torch, gen, mcfg, **PREFILL_SCAN)
    ms = cuda_ms(lambda: ss_ops.selective_scan(x, dt, a, b_ssm, c_ssm, dd, h), reps=20)
    bound, by, _, _ = scan_bound(PREFILL_SCAN["bt"], PREFILL_SCAN["s"], dn, n,
                                 PREFILL_SCAN["n_valid"])
    print(f"selective_scan at B=1 S={PREFILL_SCAN['s']} Dn={dn}: kernel {ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), kernel at {100 * bound / ms:.2f}% of bound")
    out["selective_scan"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                             "shape": f"B=1 S={PREFILL_SCAN['s']} Dn={dn}"}
    print(json.dumps({"tp_kernel_timings": out}))
    return out


# ---------------------------------------- slice 20: elastic LM training

# Main path 14 (phases 30a-30e): stablelm-1.6b at full width and depth, the
# training path's settings (seq 128, global batch 8, AdamW lr 1e-3, remat
# full), 4 steps a run: with each compression scheme on one card, then on a
# data mesh of 2 ranks sharing the card over gloo (FSDP over "data", 4 rows a
# rank).  The ranks sum their loss shares, gradients and norms in another
# order than one card, and each rank's matrix products see 4 rows, not 8, so
# cuBLAS may sum them otherwise and bf16 round them otherwise: each step's
# loss within 0.5% of the single card's (PERF.md's prediction for PR 30,
# written before the first run), five times the spread a bf16 rounding of
# the logits gives the smoke losses (phase 23d measured 1.1e-4 relative);
# the float32 state a rank holds within 49-52% of the single card's (the
# replicated norm scales and biases are the rest).
DP_WORLD, DP_STEPS = 2, 4
DP_TIMEOUT_S = 600  # a group of ranks still running after this is killed
DP_LOSS_RTOL = 5e-3
DP_STATE_SHARE = (0.49, 0.52)
COMPRESSION_SCHEMES = ("int8", "topk", "powersgd")
# Phase 30d, the elastic leg: 4 of the 24 layers at full width (the
# checkpoint of params and both moments is 7.4 GB, not 19.7), a checkpoint
# at data 2 after the first of two steps; the second is the unresized run's
# next step
ELASTIC_LAYERS, ELASTIC_STEPS = 4, 2
# Phase 30e: the trainer CLI's --chaos on a generated trace, and the reference
# test's crafted 70-step trace (tests/test_chaos.py::test_chaos_lm_loop_end_to_end)
CHAOS_CLI_STEPS = 30


def dp_opts(**kw) -> dict:
    return dict(arch=TRAIN_ARCH, smoke=False, steps=DP_STEPS, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, log_every=0, **kw)


def training_launches_expected(counts: dict, layers: int, steps: int, remat: str,
                               what: str) -> None:
    """K3 once a layer a step (twice under full remat) and each K3-bwd pass
    once, no other kernel."""
    expected = {name: 0 for name in counts}
    expected.update(flash_fwd=(2 if remat == "full" else 1) * layers * steps,
                    flash_bwd_dq=layers * steps, flash_bwd_dkdv=layers * steps)
    if counts != expected:
        fail(f"{what}: launches {counts}, expected {expected}")


def step_summary(records) -> str:
    import statistics

    times = [r["step_time"] for r in records[1:]] or [records[0]["step_time"]]
    losses = ", ".join("%.5f" % r["loss"] for r in records)
    norms = ", ".join("%.4f" % r["grad_norm"] for r in records)
    return (f"losses {losses}; grad norms {norms}; step ms first "
            f"{1e3 * records[0]['step_time']:.1f}, then median {1e3 * statistics.median(times):.1f}")


def state_bytes(trainer) -> int:
    """The float32 master and optimizer state a trainer (or a rank) holds."""
    from repro_torch.training.tree import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(trainer.params) + tree_leaves(trainer.opt_state))


def compression_path() -> dict:
    """Phase 30a, main path 14a: ``python -m repro_torch.launch.train --arch
    stablelm-1.6b --steps 4 --seq-len 128 --global-batch 8 --compression S``
    in process for each scheme, at full width and depth.  Gates: losses and
    grad norms finite, K3 = 2 x 24 x 4 and each K3-bwd pass 24 x 4, nothing
    else launched.  Prints the step times and the peak memory.  Returns the
    launches summed over the schemes."""
    import torch

    from repro_torch.launch import train as train_cli

    total = {}
    for scheme in COMPRESSION_SCHEMES:
        argv = ["--arch", TRAIN_ARCH, "--steps", str(DP_STEPS), "--seq-len", str(TRAIN_SEQ),
                "--global-batch", str(TRAIN_BATCH), "--compression", scheme]
        phase(f"main path 14a: python -m repro_torch.launch.train {' '.join(argv)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = train_cli.run(argv)
        counts = read_launches()
        records = trainer.records
        print(f"{scheme}: {step_summary(records)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if len(records) != DP_STEPS or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
            fail(f"--compression {scheme}: {len(records)} steps, losses or grad norms not finite")
        training_launches_expected(counts, trainer.cfg.n_layers, DP_STEPS, trainer.rt.remat,
                                   f"--compression {scheme}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return total


def compression_small_check(dev) -> None:
    """Phase 30b: the smoke trainer with each scheme, 8 steps on the card
    (K3, K3-bwd) against the plain versions on the CPU from the card's
    weights, each step's loss within TRAIN_LOSS_RTOL."""
    for scheme in COMPRESSION_SCHEMES:
        phase(f"30b: small-input check, the smoke {TRAIN_ARCH} trainer with --compression "
              f"{scheme}, card vs CPU")
        card = smoke_trainer(dev, compression=scheme)
        cpu = smoke_trainer("cpu", compression=scheme)
        cpu.set_state(card.params, card.opt_state)
        card.train_some(8)
        cpu.train_some(8)
        worst = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(card.history, cpu.history))
        print(f"{scheme}: card {[round(x, 5) for _, x in card.history]}, CPU "
              f"{[round(x, 5) for _, x in cpu.history]}; largest relative difference "
              f"{worst:.3g} (limit {TRAIN_LOSS_RTOL})")
        if worst > TRAIN_LOSS_RTOL or len(card.history) != 8:
            fail(f"--compression {scheme}: the card's losses part from the CPU's ({worst:.3g})")


def fsdp_path(workdir: Path) -> dict:
    """Phase 30c, main path 14: stablelm-1.6b at full width and depth on
    one card for DP_STEPS steps (freed), then the same from the same seed on
    a world-size-1 NCCL group's (1, 1) mesh in this process, bit for bit
    (every loss and grad norm, and the final state's bits by
    ``Trainer.state_digest``), then on a (2, 1) data mesh: two ranks spawned
    on the one card over gloo (``run_data_parallel``), each drawing the
    whole model from seed 0 and keeping its blocks.  Gates: each rank's
    losses within DP_LOSS_RTOL of the single card's, the ranks' the same,
    K3 = 2 x 24 x steps and each K3-bwd pass 24 x steps on each rank at its
    4 rows, none in this process, each rank's float32 state within
    DP_STATE_SHARE of the single card's.  Returns the launches by run."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh, mesh_shape
    from repro_torch.launch.train import Trainer, TrainerOptions, run_data_parallel

    phase(f"30c: {TRAIN_ARCH} at full width, {DP_STEPS} steps on one card (the yardstick)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    single = Trainer(TrainerOptions(**dp_opts()))
    single.train_some(DP_STEPS)
    counts = {"single": read_launches()}
    ref = {"records": single.records, "digest": single.state_digest(),
           "state_bytes": state_bytes(single)}
    layers, remat = single.cfg.n_layers, single.rt.remat
    print(f"one card: {step_summary(ref['records'])}; float32 state "
          f"{ref['state_bytes'] / 1e9:.3f} GB; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    training_launches_expected(counts["single"], layers, DP_STEPS, remat, "one card")
    del single
    gc.collect()
    torch.cuda.empty_cache()

    phase("30c: a world-size-1 NCCL group, (1, 1) mesh, at full width: bit for bit one card")
    _, backend = init_distributed(0, 1, str(workdir / "nccl_train_world_one"))
    try:
        mesh = make_debug_mesh(1, 1)
        reset_launches()
        one = Trainer(TrainerOptions(**dp_opts(), mesh=mesh))
        one.train_some(DP_STEPS)
        counts["mesh_1x1"] = read_launches()
        same = ([(r["loss"], r["grad_norm"]) for r in one.records] ==
                [(r["loss"], r["grad_norm"]) for r in ref["records"]])
        same_state = one.state_digest() == ref["digest"]
        del one
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"backend {backend}, mesh {mesh_shape(mesh)}: losses and grad norms the same bits "
          f"{same}, the final state the same bits {same_state}")
    if backend != "nccl" or not same or not same_state:
        fail("the (1, 1) mesh trainer is not bit for bit the single card's")
    training_launches_expected(counts["mesh_1x1"], layers, DP_STEPS, remat, "the (1, 1) mesh")

    phase(f"main path 14: {TRAIN_ARCH} at full width and depth on a ({DP_WORLD}, 1) data mesh, "
          f"{DP_WORLD} ranks on the one card, global batch {TRAIN_BATCH}, {DP_STEPS} steps")
    reset_launches()
    t0 = time.perf_counter()
    reports = run_data_parallel(DP_WORLD, {"opts": dp_opts(), "steps": DP_STEPS},
                                timeout_s=DP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if any(read_launches().values()):
        fail(f"the data mesh: this process launched {read_launches()}; the ranks launch")
    worst = 0.0
    per_rank = []
    for rep in reports:
        print(f"rank {rep['rank']} ({rep['device']}, {rep['backend']}): "
              f"{step_summary(rep['records'])}; float32 state {rep['state_bytes'] / 1e9:.3f} GB "
              f"({rep['state_bytes'] / ref['state_bytes']:.4f} of one card's); peak "
              f"{rep['peak_memory_gb']:.3f} GB")
        for got, want in zip(rep["records"], ref["records"]):
            worst = max(worst, abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        share = rep["state_bytes"] / ref["state_bytes"]
        if len(rep["records"]) != DP_STEPS or not DP_STATE_SHARE[0] <= share <= DP_STATE_SHARE[1]:
            fail(f"rank {rep['rank']}: {len(rep['records'])} steps, state share {share:.4f}")
        training_launches_expected(rep["launches"], rep["n_layers"], DP_STEPS, rep["remat"],
                                   f"the data mesh's rank {rep['rank']}")
        per_rank.append({"rank": rep["rank"], "backend": rep["backend"],
                         "device": rep["device"], "peak_memory_gb": rep["peak_memory_gb"],
                         "state_share": share,
                         "step_ms": [1e3 * r["step_time"] for r in rep["records"]],
                         "losses": [r["loss"] for r in rep["records"]]})
    if [r["loss"] for r in reports[0]["records"]] != [r["loss"] for r in reports[1]["records"]]:
        fail("the ranks report different losses")
    print(f"the ranks' losses within {worst:.3g} of one card's (limit {DP_LOSS_RTOL}); "
          f"{seconds:.1f} s for the spawn, the builds and the steps")
    if worst > DP_LOSS_RTOL:
        fail(f"the data mesh's losses part from one card's: {worst:.3g}")
    print(json.dumps({"fsdp_path": {"world": DP_WORLD, "cli_s": seconds, "loss_rel_diff": worst,
                                    "per_rank": per_rank,
                                    "one_card_step_ms": [1e3 * r["step_time"]
                                                         for r in ref["records"]]}}))
    counts["data_mesh"] = {}
    for rep in reports:
        for k, v in rep["launches"].items():
            counts["data_mesh"][k] = counts["data_mesh"].get(k, 0) + v
    return counts



def elastic_path(workdir: Path) -> dict:
    """Phase 30d, the elastic leg, at full width and ELASTIC_LAYERS layers
    (``reduced: depth only``): two ranks at data 2 take a step, write a
    checkpoint (whole leaves, gathered, by rank 0) and take the next step
    (the unresized run's); the checkpoint restored at data 1 (a world-size-1
    NCCL group's (1, 1) mesh in this process, through ``CheckpointManager.
    restore`` and ``rescale_training_state``, as ``TrainerExecutor`` places
    it) and again at data 2 (two new ranks, through ``restore_sharded``).
    Gates: the placed state gathered back the same bits as the saved one
    (``Trainer.state_digest``) after each placement; the next step's loss
    within DP_LOSS_RTOL of the unresized run's; K3 and K3-bwd as the
    training path's.  Prints the save's and the restores' wall times
    (``last_timing``; the reads are warm: the file cache is not dropped).
    Returns the launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.launch.train import Trainer, TrainerOptions, run_data_parallel
    from repro_torch.runtime.elastic import rescale_training_state

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=ELASTIC_LAYERS)
    ckpt = workdir / "elastic_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    opts = dict(dp_opts(cfg=cfg, ckpt_dir=str(ckpt), ckpt_every=10 ** 9),
                steps=ELASTIC_STEPS)
    phase(f"30d: the elastic leg, {TRAIN_ARCH} at full width and {ELASTIC_LAYERS} of 24 layers: "
          f"data {DP_WORLD}, a checkpoint after step 1, then step 2")
    counts = {}
    first = run_data_parallel(DP_WORLD, {"opts": opts, "steps": ELASTIC_STEPS, "save_after": 1},
                              timeout_s=DP_TIMEOUT_S)
    saved = first[0]["saved_digest"]
    unresized = first[0]["records"][1]["loss"]
    save = first[0]["save_timing"]
    print(f"data {DP_WORLD}: {step_summary(first[0]['records'])}; saved step "
          f"{first[0]['saved_step']}: {save['bytes'] / 1e9:.3f} GB in {save['wall_s']:.3f} s")
    if any(rep["saved_digest"] != saved for rep in first) or first[0]["saved_step"] != 1:
        fail("the ranks' gathered states at the checkpoint differ")
    for rep in first:
        training_launches_expected(rep["launches"], ELASTIC_LAYERS, ELASTIC_STEPS, rep["remat"],
                                   f"30d data {DP_WORLD} rank {rep['rank']}")
        for k, v in rep["launches"].items():
            counts[k] = counts.get(k, 0) + v

    phase("30d: the checkpoint placed at data 1 (restore, rescale_training_state), one step")
    init_distributed(0, 1, str(workdir / "nccl_elastic_world_one"))
    try:
        mesh = make_debug_mesh(1, 1)
        t = Trainer(TrainerOptions(**opts, mesh=mesh))
        tree, meta = t.ckpt.restore(1)
        placed = rescale_training_state(tree, mesh, t.rules, t.param_axes, t.opt, t.device)
        del tree
        t.params, t.opt_state = placed["params"], placed["opt_state"]
        t.data.load_state_dict(meta["data_state"])
        t.step = int(meta["step"])
        del placed
        same = t.state_digest() == saved
        restore_one = t.ckpt.last_timing("restore")
        reset_launches()
        t.train_some(1)
        launches = read_launches()
        loss_one = t.records[-1]["loss"]
        del t
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"data 1: the placed state the saved bits {same}; restore {restore_one['wall_s']:.3f} s "
          f"({restore_one['bytes'] / 1e9:.3f} GB); next loss {loss_one:.6f}, unresized "
          f"{unresized:.6f}")
    training_launches_expected(launches, ELASTIC_LAYERS, 1, "full", "30d data 1")
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v
    if not same or abs(loss_one - unresized) > DP_LOSS_RTOL * abs(unresized):
        fail("the state placed at data 1 differs, or its next loss parts from the unresized run's")

    phase(f"30d: the checkpoint placed at data {DP_WORLD} again (restore_sharded), one step")
    again = run_data_parallel(DP_WORLD, {"opts": opts, "steps": 1, "restore": 1},
                              timeout_s=DP_TIMEOUT_S)
    for rep in again:
        loss = rep["records"][-1]["loss"]
        print(f"rank {rep['rank']}: the placed state the saved bits "
              f"{rep['placed_digest'] == saved}; restore {rep['restore_timing']['wall_s']:.3f} s "
              f"(placed in {rep['restore_s']:.3f} s); next loss {loss:.6f}")
        training_launches_expected(rep["launches"], ELASTIC_LAYERS, 1, rep["remat"],
                                   f"30d data {DP_WORLD} again, rank {rep['rank']}")
        for k, v in rep["launches"].items():
            counts[k] = counts.get(k, 0) + v
        if rep["placed_digest"] != saved or abs(loss - unresized) > DP_LOSS_RTOL * abs(unresized):
            fail(f"rank {rep['rank']}: the state placed at data {DP_WORLD} differs, or its next "
                 "loss parts from the unresized run's")
    print(json.dumps({"elastic_path": {
        "layers": ELASTIC_LAYERS, "checkpoint_gb": save["bytes"] / 1e9, "save_s": save["wall_s"],
        "restore_s_data_1": restore_one["wall_s"],
        "restore_s_data_2": [rep["restore_timing"]["wall_s"] for rep in again],
        "next_loss_unresized": unresized, "next_loss_data_1": loss_one,
        "next_loss_data_2": [rep["records"][-1]["loss"] for rep in again]}}))
    shutil.rmtree(ckpt, ignore_errors=True)
    return counts


def chaos_lm_path(workdir: Path) -> dict:
    """Phase 30e: the LM chaos loop on the smoke stablelm-1.6b (the
    executor's config, as the reference's is), on the card: ``python -m
    repro_torch.launch.train --chaos TRACE --steps 30`` in process on a
    trace it generates, then ``run_chaos_lm`` on the reference test's crafted
    70-step trace with that test's gates (a resize, a mitigation, a restore,
    the last loss below the first by 0.5).  Each run: losses finite, and K3
    and K3-bwd once a layer an executed step (remat none; the step of a
    preemption restores and runs none), no other kernel.
    Returns the launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.chaos import ChaosEvent, ChaosTrace

    smoke_layers = get_smoke_config(TRAIN_ARCH).n_layers
    trace = workdir / "chaos_trace.json"
    trace.unlink(missing_ok=True)
    argv = ["--chaos", str(trace), "--steps", str(CHAOS_CLI_STEPS),
            "--ckpt-dir", str(workdir / "chaos_ckpt")]
    phase(f"30e: python -m repro_torch.launch.train {' '.join(argv)}")
    counts = {}
    reset_launches()
    t0 = time.perf_counter()
    log = train_cli.run(argv)
    runs = [("--chaos", log, time.perf_counter() - t0, read_launches())]
    phase("30e: run_chaos_lm on the crafted 70-step trace (a straggler at 30, a preemption at 50)")
    crafted = ChaosTrace(seed=0, n_hosts=4, steps=70, events=[
        ChaosEvent(step=30, kind="straggler_on", host=0, magnitude=3.0, duration=8),
        ChaosEvent(step=50, kind="preempt", host=0)])
    reset_launches()
    t0 = time.perf_counter()
    log = train_cli.run_chaos_lm(TRAIN_ARCH, crafted, str(workdir / "chaos_ckpt_crafted"))
    runs.append(("crafted", log, time.perf_counter() - t0, read_launches()))
    for name, log, seconds, launches in runs:
        losses = [r["objective"] for r in log.rows]
        print(f"{name}: {len(log.rows)} steps in {seconds:.1f} s, resizes {log.n_resizes()}, "
              f"mitigations {log.n_mitigations()}, restores "
              f"{sum(1 for r in log.rows if r.get('restore'))}, final m {log.meta['final_m']}, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"the chaos loop ({name}): a loss not finite")
        executed = sum(1 for r in log.rows if not r.get("restore"))  # a failure's step is lost
        training_launches_expected(launches, smoke_layers, executed, "none",
                                   f"the chaos loop ({name})")
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
    log = runs[1][1]
    losses = [r["objective"] for r in log.rows]
    if len(log.rows) != 70 or log.n_resizes() < 1 or log.n_mitigations() < 1 or not any(
            r.get("restore") for r in log.rows) or not losses[-1] < losses[0] - 0.5:
        fail("the chaos loop on the crafted trace misses the reference test's gates")
    if len(runs[0][1].rows) != CHAOS_CLI_STEPS:
        fail(f"--chaos ran {len(runs[0][1].rows)} steps, not {CHAOS_CLI_STEPS}")
    return counts

def main() -> None:
    import torch

    if sys.argv[1:2] == ["--k6-times"] and len(sys.argv) == 3:
        return k6_times_main(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--k3bwd-times"] and len(sys.argv) == 3:
        return k3bwd_times_main(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--scan-times"] and len(sys.argv) == 3:
        return scan_times_main(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--scan-bwd-times"] and len(sys.argv) == 3:
        return scan_bwd_times_main(Path(sys.argv[2]).resolve())
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.local_sgd import build as local_sgd_build
    from repro_torch.kernels.sdca import build as sdca_build
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.serve.engine import random_lm

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    dev = torch.device("cuda")

    phase("build")
    builds = build_all([sdca_build.LIBRARY, fa_ops.LIBRARY, fa_ops.BWD_LIBRARY, fd_ops.LIBRARY,
                        fd_ops.DECODE_LIBRARY, fd_ops.LATENT_LIBRARY, ss_ops.LIBRARY,
                        ss_ops.BWD_LIBRARY, local_sgd_build.LIBRARY])

    k1, problem, p_star = hemingway_path(dev)
    k6_err = local_sgd_vs_plain(dev, problem)
    k6 = local_sgd_timings(dev, problem)
    k6_launches = {"menu": menu_path(dev, problem, p_star), "chaos": chaos_path(dev)}
    k6 = {"name": "local_sgd", "route": "cuda",
          "source": "src/repro_torch/kernels/local_sgd/csrc/local_sgd.cu",
          "replaces": "src/repro/optim/sgd.py:129", "status": "redesigned: a ring of rows "
          "staged by bulk copies", "launches": sum(k6_launches.values()),
          "max_abs_err": k6_err, "library_ms": None, "timed_by": EAGER,
          "shape": "m=16 nl=3750 d=784 H=nl", "launches_by_path": k6_launches, **k6}
    del problem
    torch.cuda.empty_cache()

    cfg = get_config(QWEN)
    errs = serve_kernels_vs_plain(dev, cfg)
    for name, err in chunk_verify_kernels_vs_plain(dev, cfg).items():
        errs[name] = max(errs[name], err)
    small_lm_check(dev, QWEN)
    for name, err in tuned_kernels_vs_plain(dev, cfg).items():
        errs[name] = max(errs.get(name, 0.0), err)
    workdir = ROOT / "results" / "chip_smoke"  # the tuner's cache files, made anew
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    tuner = tuner_path(dev, cfg, workdir)
    lm, launches = serve_cli_path(QWEN, n_layers=40, d_model=5120, path_no=3,
                                  tune_cache=tuner["files"]["cli"])
    launches["flash_decode"] = tuner["launches"]["flash_decode"]
    knobs = serve_cli_knobs_path(QWEN, lm, "3b", tune_cache=tuner["files"]["cli"])
    tuned_ppp = long_serve_run(QWEN, lm, tune_cache=tuner["files"]["long"])["pages_per_program"]
    chunked = chunked_long_run(lm)
    by_path = {name: {"cli": launches[name], "cli_chunked_speculative": knobs["launches"][name],
                      "chunked_long_run": chunked[f"{name}_launches"]}
               for name in ("flash_fwd", "paged_decode")}
    prefill_row_blocks(lm)
    static_counts = static_serve_path(lm)
    for name in ("flash_fwd", "paged_decode"):
        by_path[name]["static_serve"] = static_counts[name]
    routed = router_path(QWEN, lm, 12, workdir, tune_cache=tuner["files"]["cli"])
    for name in ("flash_fwd", "paged_decode"):
        by_path[name]["serve_router"] = routed["launches"][name]
    trace_cost_and_replay(lm, workdir, tuner["files"]["cli"])
    telemetry_paths(routed["log"], tuner["files"]["cli"], lm.cfg.n_layers)
    single_card = single_card_trace(lm)
    nccl_world_one(lm, single_card, workdir)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    tp = tp_path(QWEN, 13, workdir, tune_cache=tuner["files"]["cli"], reference=single_card)
    for name in ("flash_fwd", "paged_decode"):
        by_path[name]["serve_tp"] = tp["launches"][name]
    timings = serve_kernel_timings(dev, cfg, tuned_ppp)

    cfg = get_config(MAMBA)
    errs["selective_scan"], errs["selective_scan_step"] = scan_kernel_vs_plain(dev, cfg)
    small_lm_check(dev, MAMBA)
    lm, mamba_launches = serve_cli_path(MAMBA, n_layers=64, d_model=4096, path_no=4)
    launches["selective_scan_step"] = mamba_launches["selective_scan_step"]
    launches["selective_scan"] = mamba_launches["selective_scan"] - launches["selective_scan_step"]
    long_serve_run(MAMBA, lm)
    mamba_routed = router_path(MAMBA, lm, "12b", workdir)
    mamba_handoff_state(lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    mamba_cut = dataclasses.replace(get_config(MAMBA), n_layers=TP_MAMBA_LAYERS)
    lm = random_lm(mamba_cut, dev, 0)
    mamba_single = single_card_trace(lm, "29d (the single card)")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    mamba_tp = tp_path(MAMBA, "13b", workdir, cfg=mamba_cut, reference=mamba_single)
    scan = scan_kernel_timings(dev, cfg)
    timings["selective_scan"], timings["selective_scan_step"] = scan["prefill"], scan["decode"]
    for name, err in tp_kernels_vs_plain(dev).items():
        errs[name] = max(errs[name], err)
    tp_rows = tp_kernel_timings(dev)

    cfg = dataclasses.replace(get_config(DEEPSEEK), n_layers=DEEPSEEK_LAYERS)
    mla_errs = mla_kernels_vs_plain(dev, cfg)
    for name, err in mla_chunk_verify_kernels_vs_plain(dev, cfg).items():
        mla_errs[name] = max(mla_errs[name], err)
    errs["paged_latent_decode"] = mla_errs["paged_latent_decode"]
    errs["flash_fwd_mla"] = mla_errs["flash_fwd"]
    small_lm_check(dev, DEEPSEEK)
    lm, mla_launches = serve_cli_path(DEEPSEEK, n_layers=DEEPSEEK_LAYERS, d_model=5120,
                                      path_no=5, cfg=cfg)
    mla_knobs = serve_cli_knobs_path(DEEPSEEK, lm, "5b")
    by_path["paged_latent_decode"] = {
        "cli": mla_launches["paged_latent_decode"],
        "cli_chunked_speculative": mla_knobs["launches"]["paged_latent_decode"]}
    by_path["flash_fwd_mla"] = {"cli": mla_launches["flash_fwd"],
                                "cli_chunked_speculative": mla_knobs["launches"]["flash_fwd"]}
    for name, paths in by_path.items():
        launches[name] = sum(paths.values())
    # the full-rows row's launches: the long run's, whose decode steps see
    # rows of 1025 to 1088 positions
    launches["paged_latent_decode_full"] = \
        long_serve_run(DEEPSEEK, lm)["paged_latent_decode_launches"]
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    timings.update(mla_kernel_timings(dev, cfg, errs))

    bwd = flash_bwd_vs_plain(dev, builds["flash_bwd"]["log"])
    train_counts = training_path(dev)
    training_kernels_vs_plain(dev)
    checkpoint_round_trip(dev, workdir)

    cfg = get_config(MAMBA)
    errs["selective_scan_bwd"], errs["selective_scan_bwd_reduce"] = scan_bwd_vs_plain(dev, cfg)
    scan_bwd, scan_reduce = scan_bwd_timings(dev, cfg)
    mamba_counts, trainer = mamba_moe_training_path(
        MAMBA, MAMBA_TRAIN_LAYERS, 7,
        {"selective_scan": 2, "selective_scan_bwd": 1, "selective_scan_bwd_reduce": 1})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    moe_counts, trainer = mamba_moe_training_path(
        MOE, MOE_TRAIN_LAYERS, 8, {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1})
    moe_gradient_bits(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    mla_counts, trainer = mamba_moe_training_path(
        DEEPSEEK, MLA_TRAIN_LAYERS, 9,
        {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dv": 1, "flash_bwd_dk": 1})
    moe_gradient_bits(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    training_kernels_vs_plain(dev, MAMBA, ("selective_scan", "selective_scan_bwd",
                                           "selective_scan_bwd_reduce"))
    training_kernels_vs_plain(dev, MOE)
    training_kernels_vs_plain(dev, DEEPSEEK)  # MLA at (24, 16): the dk/dv pass, and MoE

    # slice 17: the rest of the catalog (phases 27a-27f)
    for arch in CATALOG_SMOKE:
        small_lm_check(dev, arch, pin_routing=arch == JAMBA)
    for arch in (INTERNVL, MUSICGEN):
        for name, err in serve_kernels_vs_plain(dev, get_config(arch)).items():
            errs[name] = max(errs[name], err)
    contiguous_decode_check(dev)
    musicgen_counts, trainer = mamba_moe_training_path(
        MUSICGEN, MUSICGEN_LAYERS, 10, {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1})
    losses, opts = [r["loss"] for r in trainer.records[:TRAIN_STEPS]], trainer.opts
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    training_vs_plain_flash(losses, opts)
    internvl_counts = frontend_serve_path(dev)
    frontend_rows = frontend_kernel_timings(dev)
    jamba_smoke_paths(dev)
    training_kernels_vs_plain(dev, INTERNVL)
    training_kernels_vs_plain(dev, MUSICGEN)
    checkpoint_round_trip(dev, workdir, MUSICGEN)

    # slice 20: elastic LM training (phases 30a-30e, main path 14)
    slice20 = {"training_compression": compression_path()}
    compression_small_check(dev)
    fsdp = fsdp_path(workdir)
    slice20.update(training_fsdp=fsdp["data_mesh"],
                   training_fsdp_one_card={k: fsdp["single"][k] + fsdp["mesh_1x1"][k]
                                           for k in fsdp["single"]},
                   training_elastic=elastic_path(workdir), chaos_lm=chaos_lm_path(workdir))

    by_path["flash_fwd"].update(training=train_counts["flash_fwd"],
                                training_moe=moe_counts["flash_fwd"],
                                training_musicgen=musicgen_counts["flash_fwd"],
                                serve_internvl2=internvl_counts["flash_fwd"],
                                **{path: c["flash_fwd"] for path, c in slice20.items()})
    launches["flash_fwd"] = sum(by_path["flash_fwd"].values())
    by_path["paged_decode"]["serve_internvl2"] = internvl_counts["paged_decode"]
    launches["paged_decode"] = sum(by_path["paged_decode"].values())
    by_path["flash_fwd_mla"]["training_mla"] = mla_counts["flash_fwd"]
    launches["flash_fwd_mla"] = sum(by_path["flash_fwd_mla"].values())
    router_step = mamba_routed["selective_scan_step_launches"]
    tp_step = mamba_tp["launches"]["selective_scan_step"]
    by_path["selective_scan"] = {
        "cli": launches["selective_scan"], "training_mamba": mamba_counts["selective_scan"],
        "serve_router": mamba_routed["launches"]["selective_scan"] - router_step,
        "serve_tp": mamba_tp["launches"]["selective_scan"] - tp_step}
    launches["selective_scan"] = sum(by_path["selective_scan"].values())
    by_path["selective_scan_step"] = {"cli": launches["selective_scan_step"],
                                      "serve_router": router_step, "serve_tp": tp_step}
    launches["selective_scan_step"] = sum(by_path["selective_scan_step"].values())

    kernels = [k1, k6]
    for name, source, replaces in (
            ("flash_fwd", "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:92"),
            ("flash_fwd_mla", "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:92"),
            ("paged_decode", "src/repro_torch/kernels/flash_decode/csrc/paged_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:214"),
            ("selective_scan", "src/repro_torch/kernels/ssm_scan/csrc/selective_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:65"),
            ("selective_scan_step", "src/repro_torch/kernels/ssm_scan/csrc/selective_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:65"),
            ("flash_decode", "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:89"),
            ("paged_latent_decode",
             "src/repro_torch/kernels/flash_decode/csrc/paged_latent_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:189"),
            ("paged_latent_decode_full",
             "src/repro_torch/kernels/flash_decode/csrc/paged_latent_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:189")):
        ms, plain, lib, bound, by, shape, *how = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib, "shape": shape,
                        **({"launches_by_path": by_path[name]} if name in by_path else {}),
                        **(how[0] if how else {"timed_by": EAGER})})
        if name in frontend_rows:
            kernels[-1].update({f"{key}_at main path 11": value
                                for key, value in frontend_rows[name].items()})
        if name in tp_rows:
            kernels[-1].update({f"{key}_at main path 13": value
                                for key, value in tp_rows[name].items()})
        if name == "flash_fwd":
            kernels[-1].update(lse_ms=bwd["flash_fwd_lse"]["ms"],
                               lse_shape=bwd["flash_bwd_dq"]["shape"] + ", block_k 64",
                               ms_without_lse_there=bwd["flash_fwd_lse"]["ms_without_lse"],
                               lse_max_rel_err=bwd["flash_fwd_lse"]["max_abs_err"])
        if name == "flash_fwd_mla":
            kernels[-1].update(lse_ms=bwd["flash_fwd_mla_lse"]["ms"],
                               lse_shape=bwd["flash_bwd_dv"]["shape"] + ", block_k 64",
                               ms_without_lse_there=bwd["flash_fwd_mla_lse"]["ms_without_lse"])
    bwd_status = ("redesigned for Hopper: wgmma on TMA-staged 128-byte-swizzled tiles, the key "
                  "side cut in chunks summed in a cluster (the port's own kernel, a custom-VJP "
                  "backward, no Pallas kernel)")
    for name, status in (
            ("flash_bwd_dq", bwd_status + "; templated on (DK, DV)"),
            ("flash_bwd_dkdv", bwd_status),
            ("flash_bwd_dv", "the key side's dv at MLA's (192, 128), where dk and dv "
             "would not fit one walk's registers; the dk/dv pass's schedule"),
            ("flash_bwd_dk", "the key side's dk at MLA's (192, 128), after the dv "
             "pass; the dk/dv pass's schedule")):
        paths = {"training": train_counts[name], "training_moe": moe_counts[name],
                 "training_mla": mla_counts[name], "training_musicgen": musicgen_counts[name],
                 **{path: c[name] for path, c in slice20.items()}}
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
                        "replaces": "src/repro/kernels/flash_attention/ops.py:118",
                        "status": status, "launches": sum(paths.values()),
                        "launches_by_path": paths, "timed_by": EAGER, **bwd[name]})
    kernels.append({"name": "selective_scan_bwd", "route": "cuda",
                    "source": "src/repro_torch/kernels/ssm_scan/csrc/selective_scan_bwd.cu",
                    "replaces": "src/repro/kernels/ssm_scan/ops.py:30",
                    "status": "redesigned for Hopper: half-warp half tiles at S <= 128, "
                    "dB and dC summed over a warp's terms in registers and over the warps once a "
                    "pair of states, two blocks an SM, then over clusters of 2 channel blocks "
                    "through distributed shared memory (the gradient the reference takes by JAX "
                    "autodiff of its chunked scan, no Pallas kernel); no atomics",
                    "launches": mamba_counts["selective_scan_bwd"],
                    "launches_by_path": {"training_mamba": mamba_counts["selective_scan_bwd"]},
                    "max_abs_err": errs["selective_scan_bwd"], "timed_by": EAGER, **scan_bwd})
    kernels.append({"name": "selective_scan_bwd_reduce", "route": "cuda",
                    "source": "src/repro_torch/kernels/ssm_scan/csrc/selective_scan_bwd.cu",
                    "replaces": "src/repro/kernels/ssm_scan/ops.py:30",
                    "status": "K4-bwd's second launch, the partials of dB and dC (one a "
                    "cluster of channel blocks), dA and dD summed in a fixed order",
                    "launches": mamba_counts["selective_scan_bwd_reduce"],
                    "launches_by_path": {
                        "training_mamba": mamba_counts["selective_scan_bwd_reduce"]},
                    "max_abs_err": errs["selective_scan_bwd_reduce"], "timed_by": EAGER,
                    **scan_reduce})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
