#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

``--profile`` adds torch.profiler windows over three paper-scale rounds
after phase 5, on the identity and on the int8 wire (device time by
kernel; the ``fl.uplink`` and ``fl.aa_step`` scopes' host ms and device
span per round; the round's device busy time and its share of the wall),
and the same over three replays of the engine's CUDA graph of 5 rounds.

Needs one CUDA card of compute capability 9.x (H100) and ``nvcc``; it
builds the port's CUDA kernels from the eight sources in
``src/repro_torch/csrc`` (one ``nvcc`` each, all started together, then a
link) and exits non-zero, printing no result, where there is no card or no
port beside it. Every phase raises on failure; none is caught.

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the kernels' build time.
2. The launch floor first: an empty kernel (``<<<1, 32>>>``, no memory
   traffic) launched through the kernels' own path and timed as they are;
   it is printed beside every kernel's time and bound. Then each kernel
   against its plain PyTorch version on the card. The wire's ``quantize``
   and ``dequantize`` must equal theirs bit for bit (codes, scales and
   output, from the same uniforms) at the main path's shape (the K=100
   clients' d=54 float64 uploads, chunk grid [100, 1, 256]) and at a
   streaming shape (K=16, d=2^20 float32, [16, 4096, 256], 67 MB of x,
   more than the 50 MB L2 cache). The fused int8 uplink
   (``int8_uplink``: the uplink's anchor, reference and error-feedback
   arithmetic around both, one launch) at the same two shapes with the
   gradient uplink's buffers (ref + ef), the delta uplink's (anchor + ef)
   and the Newton direction's (the "dir" uplink: ef alone, no anchor, no
   reference), one client's upload all zeros: its three outputs must equal the
   plain version's bit for bit, a rerun must be bit-identical, and one
   call must launch it once and neither ``quantize`` nor ``dequantize``;
   it is timed beside the two-launch composition it replaced
   (``Codec.uplink``'s arithmetic around the standalone pair, the same
   uniforms: the draw is in neither). The same with its ``post`` operand
   (the DP noise added to the decoded value, robust/faults.py) on the
   gradient's and the delta's buffers, one upload holding a NaN and one
   an Inf: bit for bit its plain version's, NaN where NaN, timed beside
   the call without it. The slice-A kernels at the main
   path's shapes (K=100 clients x 5810 rows, d=54, 11 local steps, m=10
   history columns), in float64 and float32: the largest difference relative
   to the plain result's largest magnitude must stay within 1e-12 (float64)
   and 1e-5 (float32) -- the two differ only in summation order, no solve
   is involved. Where a result may cancel (Y g, the update), the difference
   is taken relative to the sum of the absolute values of its terms. The
   standalone update (``flat_update``, on no main path) is held twice: with
   the AA solve's coefficients (large, from an ill-conditioned Gram) and
   with coefficients of order 1, where every term, the -eta g term
   included, weighs on the result. The fused AA step (``aa_step``:
   screen, Jacobi eigen-solve, stats and update in one launch) at the main
   path's shape in both dtypes, on the Gram pass's output for those
   histories, and at K=16, m=10, d=2^20 in float32: against its plain
   version (``aa_step_ref``, the same Jacobi op for op) w+ within the same
   limits of its terms, gamma, |gamma| and cond of their largest
   magnitude, theta^2 absolutely (its terms are at most 1), used and
   clipped equal; a rerun bit-identical; one launch a call and no other.
   It is timed beside the launch floor, its bound, its plain version and
   the composition it replaced (the tree solve ``_screened_solve`` with its
   batched ``torch.linalg.eigh``, ``_theta``, the norm and
   ``flat_update``), whose device kernels a call, and eigh's own device
   time, come from torch.profiler.
   ``trajectory`` runs the design ``ops.plan_trajectory`` picks from the
   shape: at the main path's full-batch shape the resident one (one
   thread-block cluster per client, its rows in shared memory for all the
   steps; the plan -- cluster size, rows per block, shared bytes, clusters
   resident at once -- is printed), and, held the same way, the streaming
   one at a per-step shape (S=11 blocks of 528 of each paper-scale
   client's rows); both bit-identical when run again. Both designs again
   with ``anchor_scale=0`` (SCAFFOLD's and the AVG family's trajectory: no
   anchor term), in float64 and float32, against ``trajectory_ref``, each
   timed beside its bound. The Gram pass and the fused AA step also at the
   trajectory family's variants: a per-client g [K, d] (FedOSAA-AVG's,
   read at a client stride of d) and m=15 history columns (carried history
   5 + L 10, from a trajectory of 16 steps), each against its plain
   version, timed beside its bound.
   The LM kernels at the served shapes: ``ssd`` at Zamba2-7B's width (B=4,
   S=2048: 32 chunks, nh=112, Q=256, hd=st=64) and at Mamba-2-2.7B's
   (st=128, nh=80), ``flash_attention`` at B*H=128, S=2048, d=112 in
   bf16 (the tensor-core kernel), at granite-moe-3b-a800m's B=4, S=2048,
   H=24 on KV=8, d=64 in bf16, in f32 with a window and a ragged S (the
   CUDA-core kernel), and in bf16 with GQA (H=8 on KV=2), window 256, S=1000
   and d=128, at phase 6f's ranks' shapes (llama4-scout's 10 heads on 2 KV
   heads at d=128, Zamba2-7B's shared block's 16 heads at d=112, ``ssd``
   on 56 of its 112 heads; B=2, S=2048), and at phase 6e's three served
   shapes in bf16 (B=4, S=2048):
   musicgen-medium's MHA H=KV=24, d=64; its padded(16) gather mode's
   H=KV=32, d=64; internvl2-76b's H=64 on KV=8, d=128; within 1e-5 (f32)
   and 2^-7 (bf16 output) of the plain result's largest magnitude, and
   bit-identical when run again. Flash is
   also timed against ``scaled_dot_product_attention(is_causal=True)``
   (``enable_gqa`` where KV < H), whose backend is named. The Gram kernel's and ``torch.bmm``'s own
   device durations come from torch.profiler beside their CUDA-event
   times, and its reruns must be bit-identical and its Gram matrix exactly
   symmetric. ``ssd`` reruns must be bit-identical too; its bound counts
   its split-TF32 products at the TF32 tensor-core rate (the bound at the
   f32 rate, as PR 14 counted it, is printed beside it). The flash, Gram
   and SSD kernels' blocks per SM are printed.
   Times come from CUDA events (median of repeats).
3. The acceptance configuration (synthetic covtype n=10,000, K=10 iid,
   gamma=1e-3, eta=1, L=10, float64, FedOSAA-SVRG, at most 20 rounds),
   by the per-round loop and then by the engine (``run_federated(chunk=8)``,
   ``core/engine.py``: one CUDA graph of 8 rounds replayed a chunk): every
   slice-A kernel launches once per round of the loop and once per slot
   the engine replayed (``trajectory`` in its resident design every
   time; the engine's warm-up round is counted apart), rel-error 1e-6
   within 18 rounds, final loss within rel 1e-12 of the JAX reference's
   0.3031490665062957; the engine stops on the loop's round with its rows
   and final params; ms per round of each.
4. Paper scale (covtype-sized synthetic data N=581,012, d=54, K=100 iid,
   10 rounds): float64 and float32 on the identity wire, and float64 on
   the int8 wire, each by the per-round loop and then by the engine (10
   rounds in chunks of 5 through ``run_rounds``). ms per round, the
   rel-error reached, peak memory. These are the main path's runs: the
   launch counters are set to 0 just before each run and read just after
   it; ``trajectory`` (in its resident design), ``gram`` and ``aa_step``
   must have launched once per round of every loop run and once per slot
   replayed of every engine run, the standalone ``update`` never,
   ``int8_uplink`` twice per round (slot) of the int8 runs (the gradient
   and the delta uplink) and never on the identity wire, and ``quantize``
   and ``dequantize`` never (the fused launch computes both). Each engine
   run must equal its loop run in every telemetry row and in the final
   params, bit for bit, and make exactly one host read in each chunk after
   the first (counted under ``set_sync_debug_mode("warn")``); it prints
   its ms per round over its replayed chunks (its second chunk and 4 more
   replays, host clock, each ending in its read) beside the loop's, its
   warm-up and capture ms apart. The kernels line reports, as
   ``launches``, the float64 identity loop run's counts for the slice-A
   kernels and the int8 loop run's for the wire's, and every loop run's in
   ``launches_by_run``. Then the no-host-read gate: one warmed-up f64
   round on the identity wire and one on the int8 wire under
   ``torch.cuda.set_sync_debug_mode("error")``, where any synchronizing
   CUDA call raises and the raise fails the run.
4b. The trajectory family at paper scale (float64, 10 rounds): SCAFFOLD,
   FedOSAA-SCAFFOLD, FedAvg, FedOSAA-AVG and one-step L-BFGS on the
   identity wire, FedOSAA-SVRG with minibatches of 64 rows a step and with
   5 carried AA columns, and FedOSAA-SCAFFOLD on int8 (``FAMILY_RUNS``),
   each by the loop and by the engine (chunks of 5), read on its own
   launch counts: ``trajectory`` once a round (slot), resident at full
   batch and streaming in minibatch mode; ``gram`` and ``aa_step`` once a
   round only for the FedOSAA algorithms; ``int8_uplink`` once per upload
   (two a round for SCAFFOLD). The engine equals the loop in every row and
   in the final state (params, c, c_k, the carried columns, the comm
   buffers) and reads the card once a chunk; a warmed-up round of each
   makes no host read (``set_sync_debug_mode("error")``); ms per round,
   engine against loop.
4c. The Newton family at paper scale (float64, 10 rounds): GIANT, GIANT
   with the line search, Newton-GMRES, DANE at fig6_walltime's 10 Newton
   steps of 50 CG iterations (2 rounds, ``NEWTON_DEPTH``), and GIANT on
   int8 (``NEWTON_RUNS``), each by
   the loop and by the engine (chunks of 5; DANE's of 1, its round is ~500
   Hessian-vector products), read on its own launch counts: no
   ``trajectory``, ``gram`` or ``aa_step``, and on int8 two
   ``int8_uplink`` a round (the gradient's and the direction's). The
   engine equals the loop in every row and in the final state (params and
   comm) and reads the card once a chunk; one warmed-up round of each
   algorithm but DANE on the identity and on the int8 wire makes no host
   read (DANE's engine run captures its rounds, and phase 4e's DANE run
   checks its sync-debug round). ms
   per round (loop and engine), the capture ms and the rel-error after 10
   rounds, printed beside FedOSAA-SVRG's from phase 4 (the paper's Fig. 6
   comparison on this card).
4d. Cohorts: the paper-scale data at participation 0.1 (C=10 of K=100
   clients a round, drawn on the card, ``COHORT_RUNS``): FedOSAA-SVRG on
   the identity and the int8 wire, FedOSAA-SCAFFOLD (c_k rows), FedOSAA-SVRG
   with 5 carried AA columns (history rows) and GIANT, each 10 rounds by the
   loop and by the engine (chunks of 5), gated as 4b: launches a round as
   the dense run's (each kernel takes the cohort's clients in one launch),
   the engine equal to the loop in every row and in the whole K-sized store,
   one read a chunk, no host read in a warmed-up round (the cohort draw
   included); and the store rows of the clients no round drew bit-equal to
   their initial values. Each printed beside its dense run (ms a round,
   loop and engine; rel-error), with its capture ms and peak memory; then
   ``trajectory`` at the cohort's shape (10 clients' rows) against its
   plain version, its plan and time beside phase 2's K=100. Then the
   reference's ext_cohort point (benchmarks/ext_cohort.py: synthetic_small,
   8 rows a client, float32, eta=0.5, L=2, FedOSAA-SVRG by the engine in
   chunks of 4, 8 rounds) at K = 32, 512 and 4096, a cohort of 16 against
   the dense round: ms a round, capture ms, peak memory and the global loss;
   gate: at K=4096 the cohort run's global (all-K, data-weighted) loss ends
   below 0.7 of its initial value; ``trajectory`` at that cohort's shape
   (16 clients of 8 rows) against its plain version.
4e. The robustness layer (``repro_torch/robust``: faults and the deadline
   gate). The reference's ext_robustness quick matrix by the engine
   (chunks of 5): the acceptance data, FedOSAA-SVRG, seven plans (clean,
   dropout 0.2, stale 0.2, sign-flip and noise byzantine uplinks at 5,
   one byzantine history client at 1e24, DP 1e-3) on the identity and the
   int8 wire, clip_rtol off and 1e-3, at most 40 rounds; each row's rounds
   to 1e-6 beside the committed one. Gates: the clean run bit-identical
   with the screen on and off; the defended history run within 1.5x the
   port's own clean rounds; the undefended float64 history run finite and
   reaching 1e-4 and 1e-6 within one round of the reference's rounds 10
   and 15 with f64 accumulation (a contract finding: the reference's run
   dies of its f32 Gram accumulation; scripts/reference_history_f64.py,
   ROADMAP §3),
   and in float32 the undefended run non-finite while the defended one
   stays finite and falls; two runs of the determinism plan (drop 0.2,
   stale 0.2, history 1e24, DP 1e-4) bit-identical. The reference's
   ext_async quick configuration (lognormal latencies, deadline 2,
   min_arrivals 5, alpha 0.5, at most 60 rounds): the gated run within 2x
   the barriered run's rounds to 1e-6 and its simulated wall to target
   below the barriered run's, replayed on the host from the round's own
   latency draws; AsyncConfig() bit-identical to none; two latency and
   dropout runs bit-identical; the history guard on and off recorded.
   Then at paper scale (``ROBUST_RUNS``, 10 rounds, by the loop and the
   engine): FedOSAA-SVRG with dropout and stale anchors, with 10 history
   clients at 1e24 and clip_rtol, and on int8 with DP; FedOSAA-SCAFFOLD
   with dropout; DANE (2 Newton steps of 10 CG) under the gate; a C=10
   cohort with dropout and the gate. Gated as 4b (launches as the clean
   round's, engine = loop in every row and the whole state with the
   anchor rows, buffer rows and ages, one read a chunk, no host read in a
   warmed-up round), the cohort's never-drawn rows frozen; engine ms a
   round, capture ms and peak memory beside the clean run's.
4f. Checkpoint and resume (``repro_torch/checkpoint``). The reference
   test's adversarial case at paper scale (FedOSAA-SVRG on int8, float64,
   eta=1, L=10, 2 carried AA columns, its latency plan (seed 5, lognormal
   scale 1, sigma 1.5) and gate (deadline 2, min_arrivals 2, alpha 0.5), 10
   rounds, engine chunks of 2, a save every 2 rounds, keep all). (a) A run
   whose save 2 dies after its first write (``FaultyFs``): only round 2
   committed, a ``.tmp-*`` remnant left; ``resume="auto"`` by the engine
   then gives rows 2..9 equal to the never-killed run's (loss, grad_norm,
   rel_error, every row field), its launches a clean run's for its slots,
   and its last checkpoint (round 10) equal to the straight run's final
   state in every tensor (params, both comm tags, history, buffer rows,
   int32 ages) and ``t``: saved by the engine (``async``) and by the loop
   (``sync``). (b) The same at C=10 of K=100 (``async``), the never-drawn
   clients' store rows bit-equal to their start. (c) A real death: a child
   process (``--checkpoint-child``) whose save 2 ends it with
   ``os._exit(43)`` from the writer thread must exit with 43; a second
   child resumes with ``"auto"``; their rows join into the straight run's
   bit for bit; their output is captured and summarized. (d) ``async`` with
   a save every chunk: each committed checkpoint equals the loop's state
   after its round, although the next replay overwrote the runner's
   buffers; ``maybe_save`` runs under ``set_sync_debug_mode("error")``; one
   ``_fetch`` and one host read a chunk; launches as without checkpointing.
   (e) The reference's ext_checkpoint quick setup (covtype n=20,000, K=32,
   float32, int8, L=10, carry 2, 42 rounds in chunks of 6, a save every
   chunk) in the modes none, ``async``, ``sync`` and ``sync_gather``, each
   best of 2: the median chunk wall after the first chunk, boundary to
   boundary (the save included) and by the History (the reference's
   measure, which leaves the save out), ``checkpoint_save_ms``, bytes,
   stalls; gates: identical loss curves, 7 commits in ``async`` and
   ``sync``, no failure; the async overhead printed beside the reference's
   10% budget (not held), and one save's parts alone in host ms (snapshot,
   wait, serialization, sha256, one fsync'd file, one directory fsync, the
   whole write), best of 5.
5. The wire: the JAX reference's ext_compression configuration (synthetic
   covtype n=20,000, K=20 iid, gamma=1e-3, eta=1, L=10, float64,
   FedOSAA-SVRG) on the fp32, bf16 and int8 wires, by the loop and by the
   engine (chunk=8), each to rel-error 1e-6 within 26 rounds (cap 40):
   bytes exactly 432, 216 and 116 per round, final loss within rel 1e-10
   of the reference's 0.3128270332955105, and per round (slot) one launch
   each of ``trajectory`` (resident), ``gram`` and ``aa_step`` (none of
   ``update``) and, under int8, two of ``int8_uplink`` (and none of
   ``quantize`` or ``dequantize``); the engine's rows and final params
   equal the loop's. Then SCAFFOLD's 200 rounds on the same three wires,
   by the loop and by the engine, held to the reference's committed rows:
   final rel-error within rel 1e-6 of 0.0026693003 / 0.0026693545 (fp32,
   bf16) and 1e-3 of 0.0026693075 (int8, the port's own draws), bytes
   exactly 86,400 / 43,200 / 23,200, loss within rel 1e-10; and
   FedOSAA-SCAFFOLD's 200 fp32 rounds, printed, not held. Then GIANT,
   Newton-GMRES and DANE at their defaults (L=10; DANE 20 Newton steps of
   100 CG iterations) on the three wires, by the loop and by the engine
   (chunk 8; DANE by the engine alone, one round a graph: its loop is
   host-bound at ~17 s a round), each to rel-error 1e-6 with a cap of 40
   rounds:
   at most one round more than the committed rows (6/6/6 fp32 and bf16,
   9/8/9 int8), bytes exactly 432, 216 and 116 per round, final loss
   within rel 1e-9 of 0.3128270332955105; each curve printed beside its
   committed row, with the largest |log10| ratio of the two.
6. Serving Zamba2-7B (configs/zamba2_7b.py) at full width, with weights
   from the port's seeded init. In f32 (the weights before their bf16
   rounding), a prefill's last-position logits within 1e-4 of the largest
   |logit| of the same prefill through the plain versions on the card,
   and each block's output within 1e-5 of the largest magnitude of its
   plain output from the same input (the worst block is printed, with its
   error when only ``ssd`` or only ``flash_attention`` runs its kernel).
   In bf16, the config's dtype: a prefill of 4 prompts of 2048 tokens
   (make_lm_tokens, seed 0; cache_len 2080), read on its own launch
   counts (68 ``ssd``, 13 ``flash_attention``, nothing else); each block
   within 2^-6 of the plain versions' output from the same input; 32
   greedy decode steps that launch neither kernel; ms per prefill and per
   decode step, peak memory; then the slot server (8 requests, 4 slots,
   16-token prompts, 12 new tokens): every request finishes with 12
   tokens; tokens/s.
6b. Federated training (core/lm.py, models/mlp.py, launch/), its start
   second printed like every phase's, at most ~150 s: (a) FedOSAA-SVRG and
   FedSVRG over smollm-135m at full width in f32 (d = 162,826,560; 4
   clients of 4 documents of 128 tokens, L=3, 3 rounds by the loop) at
   fl_train's step 0.3 (printed: FedSVRG diverges there) and at 0.05
   (gated: the loss finite and falling); every round launches the Gram
   pass (its split design) and the fused AA step once in FedOSAA-SVRG,
   nothing in FedSVRG, never ``trajectory``, ``flash_attention`` or
   ``ssd``; ms a round, tokens/s, peak memory, the AA step's used/clipped
   columns and Gram conditioning, and one warm FedOSAA-SVRG round under
   torch.profiler (its kernels, their device time, the top ones); (b) the Gram pass and the fused AA step
   at that shape against their plain versions (Gram within 1e-5 of the
   sum of its terms' magnitudes, reruns bit-identical), timed beside their
   bounds, and the one-block-per-client Gram design at d=2^24 beside the
   split one; (c) the engine on the reduced smollm (4 rounds in chunks of
   2, identity and int8): the loop's rows and params bit for bit, one
   read a chunk, the loop's launches a slot, no host read in a warmed-up
   loop round; (d) one round each of the
   reduced mamba2 and a 5-layer zamba2: finite, no ``ssd`` launch; (e)
   ``fl_train.main`` (reduced, FedSVRG baseline) writes the reference's
   keys, ``train.main`` trains smollm-135m at full width in f32 (AdamW +
   WSD, 4 x 256, 10 steps) with a falling loss; (f) Fig. 8 quick (MLP1,
   MLP3 x FedSVRG, FedOSAA-SVRG from a numpy He init): MLP1 against the
   reference's pinned numbers (scripts/reference_fig8_mlp.py).
6c. Serving granite-moe-3b-a800m (configs/granite_moe_3b_a800m.py: 32
   layers, 40 experts, top 8) at full width as phase 6 serves Zamba2-7B,
   with the same gates: f32 logits within 1e-4 and each f32 block within
   1e-5 of the plain versions; the bf16 prefill of 4 x 2048 launching 32
   ``flash_attention`` and nothing else, each bf16 block within 2^-6, 32
   decode steps (dropless routing) and the slot server launching nothing.
   Routing is discrete: a last-ulp change of a router's input may move a
   near-tied token to another expert, which no kernel's bound covers, so
   a plain run that routes otherwise than its kernel run is rerun with the
   kernel run's top-k experts replayed (``routing``, ``plain_pinned``),
   and the token-layers routed differently are printed. The prefill's and
   a decode step's device time by kind of kernel (flash, products,
   dispatch, elementwise; torch.profiler), and one layer's expert
   products alone.
6d. Training the MoE family: (a) FedOSAA-SVRG and FedSVRG over granite at
   full width with its depth cut to 1 of 32 layers (d = 251,733,504), f32,
   2 clients of 4 documents of 128 tokens, L=3, 3 rounds by the loop at
   eta 0.05, gated as phase 6b (a): the loss finite and falling, the Gram
   pass (split) and the fused AA step once a FedOSAA-SVRG round, nothing
   in FedSVRG; ms a round, tokens/s, peak memory; (b) two ``vmap(grad)``
   evaluations of the clients' gradients at its initial point bit-identical
   (the dispatch's backward is a sorted ``index_put_``, no atomics); (c)
   the engine on the reduced granite (phase 6b (c)'s gates, and one
   warmed-up loop round of each wire under ``set_sync_debug_mode("error")``,
   as for the reduced smollm there); (d) ``train.main`` on the reduced
   granite and the reduced llama4-scout-17b-a16e: the loss falls.
6e. The last single-card model features: (a) musicgen-medium
   (configs/musicgen_medium.py, the audio family: 48 layers, d 1536, 24
   heads MHA, hd 64, vocab 2048) at full width as phase 6 serves Zamba2-7B,
   each prompt's first 512 positions replaced by frame embeddings [4, 512,
   1536] (numpy, seed 0): f32 logits within 1e-4 and f32 blocks within
   1e-5 of the plain versions, bf16 blocks within 2^-6, 48
   ``flash_attention`` a prefill and nothing else, 32 decode steps and the
   slot server launching nothing; (b) the same weights with ``kv_quant``:
   a prefill's caches stay bf16, ``init_caches`` gives int8 codes and f32
   scales (their bytes against the bf16 cache's: (64 + 4)/128 a head and
   slot), 32 teacher-forced decode steps from int8 and from bf16 caches
   (ms a step both ways, the share of equal argmaxes), and the slot server
   on int8 caches (the share of its greedy tokens equal to (a)'s,
   recorded); (c) musicgen-medium.padded(16), in the ``gather`` GQA mode
   (24 -> 32 heads on 24 -> 32), as (a) with 48 ``flash_attention`` a
   prefill at H=KV=32 and 8 decode steps, and its f32 logits within 1e-6
   of the same weights with the padded heads' ``wq`` columns zeroed
   (padded heads are no-ops); (d)
   internvl2-76b (the vlm family: d 8192, 64 heads on 8, hd 128, vocab
   128,256) at full width with its depth cut to 4 of 80 layers and 1024
   patch embeddings, as (a) with 4 launches a prefill and 8 decode steps.
6f. Tensor-parallel serving (sharding/specs.py's plan, launch/mesh.py,
   the Sharder, ``moe_sharded``): (a) an NCCL world of one in this
   process (``make_host_mesh("nccl")``, mesh (1, 1)) serving
   granite-moe-3b-a800m at full width and depth through ``moe_sharded``:
   the bf16 prefill's logits and 8 greedy decode steps bit for bit phase
   6c's unsharded ``moe`` run on the same weights, 32 ``flash_attention``
   a prefill and none a decode step, the slot server's tokens phase 6c's;
   (b) llama4-scout-17b-a16e (configs/llama4_scout_17b_a16e.py: d 5120,
   40 heads on 8 KV, hd 128, 16 experts top 1, vocab padded to 202,240) at
   full width with 4 of its 48 layers, over a gloo world of 4 child
   processes of this script on the card (``--tp-child <dir>``), each rank
   drawing its shard from the seed of an unsharded twin built here first:
   per rank, the embedding and each MoE layer (output, aux, routing) on
   the twin's inputs bit for bit the twin's, each block from the twin's
   input within 2^-6 (held to the twin's routing where a near-tied token
   moves), one ``flash_attention`` a layer a prefill of 2 x 2048 and none
   in 8 decode steps, the collectives and their bytes, peak memory; and in
   f32 with 1 layer, the logits within 1e-4 and the block within 1e-5 of
   the twin's; (c) zamba2-7b at full width with 12 of 81 layers (two
   groups of five Mamba-2 layers and the shared block) over a gloo world
   of 2, as (b) in bf16 with 10 ``ssd`` and 2 ``flash_attention`` a prefill.
   A rank that fails fails the phase.
6g. Training under a sharding plan (launch/steps.py's train step and AA
   step of a plan; the fsdp regime over "data"; launch/dryrun.py): (a)
   granite-moe-3b-a800m at full width with 1 of 32 layers, f32, its
   vocabulary padded for 2 model ranks, in an NCCL world of one (mesh (1,
   1)): 4 train steps of 2 x 512 tokens and the AA step (m = 3) bit for bit
   the unsharded port's, the AA step launching ``gram`` and ``aa_step``
   once each; (b) the same model on a (2, 2) mesh of 4 gloo child
   processes on the card (``--plan-child``; replica regime, one row a data
   rank): per rank the train step's loss within rel 1e-5 and its r shards
   within 1e-4 in norm of (a)'s unsharded steps on each row alone (the MoE
   layer routes each data rank's tokens), and the AA step on (a)'s
   trajectory cut to the rank (its counted prefix through the Gram kernel,
   one all-reduce of the Gram matrix, Yᵀg and ‖g‖², the AA-step kernel
   given that ‖g‖²) within 1e-5 of (a)'s w+ and 1e-6 of its theta, one
   launch of each kernel a rank; (c) internvl2-76b at full width with 1 of
   80 layers, bf16, 1024 patch embeddings in 2 x 2048 positions, the fsdp
   regime on that mesh: the loss and each rank's r shards within 2^-6 of
   an unsharded twin's (built, stepped and freed first), the bytes each
   rank all-gathers and reduce-scatters over "data" beside the specs'
   count; rows 2 and 3 at (b)'s rank shape (the Gram pass over a counted
   prefix; the AA step with a given ‖g‖² and without) against their plain
   versions, timed beside their bounds; (d) ``dryrun_one`` of granite
   train_4k on the fake world of 256 (a subprocess): argument bytes
   1,040,324,608, the reference's committed row's; ``--fl-round
   fedosaa_svrg`` (2 rounds, float64) over 2 gloo children on the card with
   CUDA tensors (``--dryrun-fl-child``) within 1e-6 (loss) and 1e-5 (rel
   error) of the reference's rerun in float64 with float64 helpers
   (scripts/reference_dryrun_fl_f64.py; the float32 run is roundoff-bound,
   ROADMAP.md section 3), its 640 bytes equal. (d)'s processes run beside
   (a)-(c).
7. The kernels line, then ``{"ok": true, "device": {...}}`` as the last line.
   Every row carries ``launch_floor_ms``. The rows of ``update``,
   ``quantize`` and ``dequantize`` report what computes them on the main
   path (``launched_as``): ``update``'s the fused ``aa_step`` (its launches,
   its readings at the main shape in float64, every shape in ``aa_step``
   with the composition's time and eigh's), the wire's the fused
   ``int8_uplink`` (its launches, and its readings at the main shape on
   the gradient uplink's buffers, every shape and buffer set in
   ``uplink``); each with the standalone kernel's phase-2 readings in
   ``standalone``.
   Beyond the contract's keys, every FL row's ``launches_by_run`` holds
   each loop run of phases 4, 4b, 4c, 4d and 4e and phase 4f's resumed
   engine runs and its snapshot run (launches per slot replayed), and the
   LM runs of phases 6b and 6d; ``flash_attention``'s also phase 6c's
   and 6e's prefills, decode steps and slot servers, and phase 6f's
   prefills and decode steps (each rank's); ``gram``'s and ``update``'s
   phase 6g's AA steps ((a)'s and each rank's of (b)) and ``plan_rank``
   (their readings at (b)'s rank shape);
   ``trajectory``'s row carries
   ``plan`` (the resident plan at the main path's shape in f64), ``cohort``
   (its checks at phase 4d's two cohort shapes),
   ``launches_by_design`` (each run's resident and streaming launches),
   ``rerun_equal``, ``per_step_shape`` (the streaming design's check) and
   ``anchor_scale_0``; ``gram``'s and ``update``'s carry ``variants`` (g
   [K, d] and m=15), ``gram``'s also ``lm_width`` (phase 6b (b));
   ``ssd``'s carries ``blocks_per_sm``, ``rerun_equal``, ``bound_split``
   and ``bound_ms_f32_count`` (the bound with every operation at the f32
   rate).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: HBM rate, and the peak rate of each type's
#: fastest unit (float32 outside the tensor cores; float64 on the FP64
#: tensor cores; bfloat16 products, accumulated in float32, on the dense
#: tensor cores; "tf32": TF32 products, accumulated in float32, on the
#: dense tensor cores, 495 TFLOP/s) -- the least time the card could take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12,
                  torch.bfloat16: 989e12, "tf32": 495e12}
#: kernel vs plain: max |kernel - plain| over the result's (or its terms')
#: largest magnitude; the two differ in summation order only
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
#: the JAX reference's converged loss on the acceptance configuration
#: (benchmarks/results/ext_robustness.json, identity/clean/off)
REFERENCE_LOSS = 0.3031490665062957
#: main-path shapes
K_MAIN, N_PAPER, D, L_EPOCHS = 100, 581_012, 54, 10
ETA, GAMMA = 1.0, 1e-3

KERNELS = {
    "trajectory": ("src/repro_torch/csrc/trajectory.cu",
                   "src/repro/kernels/local_update/local_update.py:128"),
    "gram": ("src/repro_torch/csrc/gram.cu",
             "src/repro/kernels/anderson/anderson.py:52"),
    "update": ("src/repro_torch/csrc/update.cu",
               "src/repro/kernels/anderson/anderson.py:101"),
    "quantize": ("src/repro_torch/csrc/quant.cu",
                 "src/repro/kernels/quant/quant.py:50"),
    "dequantize": ("src/repro_torch/csrc/quant.cu",
                   "src/repro/kernels/quant/quant.py:76"),
    # bf16 (the main path) on the tensor cores; f32 in flash_attention.cu
    "flash_attention": ("src/repro_torch/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:83"),
    "ssd": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd/ssd.py:69"),
}
#: the launches of every round on every wire: the trajectory, the Gram
#: pass and the fused AA step
ROUND_KERNELS = ("trajectory", "gram", "aa_step")
#: TPU kernels -> the launch that computes them on the main path: the
#: update in the fused AA step (one a round), the wire's pair in the fused
#: int8 uplink (one per uplink, two a round). The standalone kernels are
#: held in phase 2 and never launched on the main path.
FUSED_KERNELS = {"update": "aa_step", "quantize": "int8_uplink",
                 "dequantize": "int8_uplink"}
#: the engine's chunks (core/engine.py; one CUDA graph a chunk): the
#: acceptance and ext_compression runs through run_federated(chunk=8), the
#: paper-scale runs' 10 rounds in two chunks of 5, each runner then replayed
#: PAPER_REPLAYS more times for its ms per round
ACCEPT_CHUNK, PAPER_CHUNK, PAPER_REPLAYS = 8, 5, 4
#: the fused AA step's streaming shape (phase 2): few clients, a wide model
K_WIDE, D_WIDE = 16, 1 << 20
#: the kernels of the LM serving path (prefill only; decode runs neither)
LM_KERNELS = ("flash_attention", "ssd")
#: the served configuration: Zamba2-7B at full width (configs/zamba2_7b.py),
#: 4 prompts of 2048 tokens, 32 greedy decode steps after them
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "zamba2-7b", 4, 2048, 32
#: launches of one Zamba2-7B prefill: one SSD step per Mamba-2 layer (13
#: groups of 5, then 3), one attention per application of the shared block
LM_PREFILL_LAUNCHES = {"ssd": 68, "flash_attention": 13}
#: kernel vs plain on the LM kernels, over the plain result's largest
#: magnitude: f32 (summation order only); bf16 output (both round one f32
#: value to bf16, which may land one bf16 step, 2^-8 of it, apart)
LM_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: bf16 flash output, also element by element: |o - o_p| <= 2^-7 |o_p| (one
#: bf16 step of o_p's binade, as both round one f32 value) + this share of
#: the RMS of o_p's row (the f32 sums' own error where a row's terms cancel
#: toward 0). A global max would let a late row, a few hundredths in size,
#: be wrong by as much as itself.
LM_BF16_ROW_FLOOR = 2.0 ** -9
#: the Zamba2-7B prefill through the kernels vs through the plain versions
#: on the card. In f32 (the same weights before their bf16 rounding), the
#: last-position logits over the largest |logit|: the two differ in
#: summation order only, carried through 81 layers. In bf16, each block's
#: output from the same input over its largest magnitude: the two round
#: one f32 attention output to bf16, which may land one bf16 step apart,
#: and the residual sum carries that as a step of h (2^-8 of the top
#: binade); 2^-6 allows four. (The two bf16 streams taken to the end part
#: by much more: random layers amplify those steps; it is printed, not held.)
LM_LOGITS_TOLERANCE_F32 = 1e-4
LM_BLOCK_TOLERANCE_BF16 = 2.0 ** -6
#: each f32 block's output from the same input, over its largest magnitude:
#: one block's summation-order difference, before 81 layers amplify it (the
#: f32 limit each LM kernel is held to)
LM_BLOCK_TOLERANCE_F32 = LM_TOLERANCE[torch.float32]
#: the reference serve.py's defaults
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 8, 4, 16, 12
#: phase 6c: granite-moe-3b-a800m (configs/granite_moe_3b_a800m.py) served
#: at full width as phase 6 serves Zamba2-7B; its prefill launches one
#: flash attention a layer and nothing else (the MoE layer is plain torch,
#: as the reference's is jnp)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_PREFILL_LAUNCHES = {"flash_attention": 32}
#: phase 6d (a): granite at full width with its depth cut to MOE_FL_LAYERS
#: of 32 (d counts every parameter, the norm scales included), in f32,
#: MOE_FL_CLIENTS clients; (d) train.main on the reduced MoE configs
MOE_FL_LAYERS, MOE_FL_CLIENTS, MOE_FL_D = 1, 2, 251_733_504
MOE_TRAIN_ARCHS = (MOE_ARCH, "llama4-scout-17b-a16e")
#: phase 6e: (a) musicgen-medium (configs/musicgen_medium.py, audio) served
#: at full width with its 512 frame embeddings; (b) the same with the int8
#: KV cache; (c) its padded(GATHER_SHARDS) variant, in the gather GQA mode;
#: (d) internvl2-76b (configs/internvl2_76b.py, vlm) at full width with its
#: depth cut to VLM_LAYERS of 80, with its 1024 patch embeddings. Each
#: prefill launches one flash attention a layer and nothing else.
AUDIO_ARCH, VLM_ARCH = "musicgen-medium", "internvl2-76b"
AUDIO_PREFILL_LAUNCHES = {"flash_attention": 48}
GATHER_SHARDS, GATHER_DECODE = 16, 8
VLM_LAYERS, VLM_DECODE = 4, 8
VLM_PREFILL_LAUNCHES = {"flash_attention": VLM_LAYERS}
#: (c): the padded model against its twin with the padded heads' wq
#: columns zeroed, over the largest |logit| (the padded heads' outputs meet
#: zero wo rows: the reference's test_padded_heads_are_noops)
NOOP_TOLERANCE = 1e-6
#: the JAX reference's ext_compression rows of FedOSAA-SVRG
#: (benchmarks/results/ext_compression.json): rounds to rel-error 1e-6 and
#: cumulative bytes; and its int8 row's final loss
COMPRESSION_REF = {"fp32": (20, 8640.0), "bf16": (17, 3672.0),
                   "int8": (19, 2204.0)}
COMPRESSION_BYTES_PER_ROUND = {"fp32": 432.0, "bf16": 216.0, "int8": 116.0}
COMPRESSION_LOSS = 0.3128270332955105
#: the reference's committed Newton-family rows of ext_compression
#: (default hyperparameters: L=10 CG/GMRES iterations; DANE 20 Newton
#: steps of 100 CG iterations): rounds to rel-error 1e-6 on each wire, in
#: the order of the port's NEWTON_ALGOS. The port must take at most one
#: more, with the wire's bytes a round exactly and the final loss within
#: rel 1e-9 of COMPRESSION_LOSS. The curves are read from
#: benchmarks/results/ext_compression.json to be printed beside the port's.
COMPRESSION_NEWTON_ROUNDS = {"fp32": (6, 6, 6), "bf16": (6, 6, 6),
                             "int8": (9, 8, 9)}
COMPRESSION_NEWTON_LOSS_RTOL = 1e-9
#: the paths of each run on the ext_compression config: (path, chunk).
#: DANE's default round is ~2,000 Hessian-vector products, host-bound in
#: the loop (~8-9 ms of torch.func dispatch a product on the H100 machine's
#: host, ~17 s a round), so it runs by the engine alone, one round a graph;
#: its engine is held equal to its loop at paper scale in phase 4c
COMPRESSION_NEWTON_PATHS = {
    "giant": (("loop", None), ("engine", ACCEPT_CHUNK)),
    "newton_gmres": (("loop", None), ("engine", ACCEPT_CHUNK)),
    "dane": (("engine", 1),)}
#: the reference's committed SCAFFOLD rows of ext_compression, 200 rounds:
#: final rel-error, cumulative bytes, final loss
SCAFFOLD_ROUNDS = 200
COMPRESSION_SCAFFOLD = {
    "fp32": (0.0026693003254825657, 86400.0, 0.31282822767293494),
    "bf16": (0.0026693545469324937, 43200.0, 0.3128282277231577),
    "int8": (0.002669307486806141, 23200.0, 0.31282822766549306)}
#: phase 4e, the robustness layer (repro_torch/robust). The reference's
#: ext_robustness quick matrix (benchmarks/ext_robustness.py): the
#: acceptance data (covtype n=10,000, K=10 iid, float64, eta=1, L=10),
#: FedOSAA-SVRG, each plan x {identity, int8} x clip_rtol {0, 1e-3}, at
#: most 40 rounds, stopping at rel-error 1e-8, by the engine in chunks of
#: 5; rounds to rel-error 1e-6 printed beside the committed rows
#: (benchmarks/results/ext_robustness.json)
ROBUST_CAP, ROBUST_CHUNK, ROBUST_STOP = 40, 5, 1e-8
ROBUST_TARGET, ROBUST_FAIL, ROBUST_CLIP = 1e-6, 1e-4, 1e-3
BYZ_HISTORY_SCALE = 1e24
ROBUST_PLANS = (
    ("clean", None),
    ("drop0.2", dict(drop_rate=0.2)),
    ("stale0.2", dict(stale_rate=0.2)),
    ("sign_flip", dict(byz_clients=1, byz_mode="sign_flip", byz_scale=5.0)),
    ("noise", dict(byz_clients=1, byz_mode="noise", byz_scale=5.0)),
    ("history", dict(byz_clients=1, byz_mode="history",
                     byz_scale=BYZ_HISTORY_SCALE)),
    ("dp1e-3", dict(dp_sigma=1e-3)),
)
#: its gates: the defended history run within this multiple of the port's
#: own clean rounds; two runs of this plan (clip on, 6 rounds) bit-identical
ROBUST_DEFENDED_RATIO = 1.5
ROBUST_DET_PLAN = dict(drop_rate=0.2, stale_rate=0.2, byz_clients=1,
                       byz_mode="history", byz_scale=BYZ_HISTORY_SCALE,
                       dp_sigma=1e-4)
#: the undefended history run is a contract finding in float64: the
#: reference's run dies of its f32 Gram accumulation overflowing at 1e24;
#: rerun with f64 accumulation on this configuration
#: (scripts/reference_history_f64.py; ROADMAP §3) it stays finite and
#: reaches rel-error 1e-4 and 1e-6 in rounds 10 and 15. The port
#: accumulates in f64: its run must stay finite and reach both within one
#: round of those; the attack landing (a non-finite loss) is gated in
#: float32 instead, on the same data, over ROBUST_F32_ROUNDS rounds, where
#: the defended run stays finite and falls
REFERENCE_F64_HISTORY = (10, 15)
ROBUST_F32_ROUNDS = 10
#: the reference's ext_async quick configuration (benchmarks/ext_async.py):
#: the same data, lognormal latencies (scale 1, sigma 1.5, plan seed 0),
#: deadline 2.0, min_arrivals max(2, K/2) = 5, alpha 0.5, at most 60
#: rounds; the gated run within this multiple of the barriered run's rounds
ASYNC_CAP, ASYNC_ROUND_MULTIPLE = 60, 2.0
ASYNC_LATENCY = dict(latency_dist="lognormal", latency_scale=1.0,
                     latency_shape=1.5)
ASYNC_GATE = dict(deadline=2.0, min_arrivals=5, staleness_alpha=0.5)
ASYNC_DET_PLAN = dict(seed=3, drop_rate=0.15, **ASYNC_LATENCY)
#: phase 4e at paper scale (float64, 10 rounds, loop and engine, chunks of
#: PAPER_CHUNK): (run name, algorithm, AlgoHParams knobs, channel, plan,
#: gate, the clean run printed beside it: a run of phases 4-4d, or, where
#: none has its knobs, a clean run made here). DANE takes 2 Newton steps
#: of 10 CG iterations (phase 4c runs fig6's 10 x 50: its captures take
#: 11-14 s)
ROBUST_RUNS = (
    ("robust_svrg_drop_stale", "fedosaa_svrg", {}, None,
     dict(seed=1, drop_rate=0.2, stale_rate=0.2), None, "float64"),
    ("robust_svrg_history_clip", "fedosaa_svrg",
     {"aa_clip_rtol": ROBUST_CLIP}, None,
     dict(byz_clients=10, byz_mode="history", byz_scale=BYZ_HISTORY_SCALE),
     None, "float64"),
    ("robust_svrg_int8_dp", "fedosaa_svrg", {}, "int8",
     dict(seed=2, dp_sigma=1e-4), None, "float64_int8"),
    ("robust_scaffold_drop", "fedosaa_scaffold", {}, None,
     dict(seed=3, drop_rate=0.2), None, "fedosaa_scaffold"),
    ("robust_dane_gate", "dane", {"dane_newton_iters": 2, "dane_cg_iters": 10},
     None, dict(seed=4, **ASYNC_LATENCY), ASYNC_GATE, "dane_2x10"),
    ("robust_cohort_drop_gate", "fedosaa_svrg", {"participation": 0.1}, None,
     dict(seed=5, drop_rate=0.2, **ASYNC_LATENCY), ASYNC_GATE,
     "cohort_fedosaa_svrg"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, device, n: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``n`` back-to-back
    calls of ``fn``, from CUDA events. A sleep kernel ahead of the timed
    calls lets the host enqueue them all before the card reaches them, so
    host overhead between calls is not timed."""
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)   # ~0.1 s at the H100's clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def kernel_us(fn, device, n: int = 20) -> tuple[float | None, list[str], float]:
    """The device kernels' own time per call of ``fn`` in µs, from
    torch.profiler over ``n`` calls (the gaps between launches, which
    ``device_ms`` includes, are not in it), the kernels' names, and the
    device kernels a call; None where the profiler shows no device time
    in three windows (a window now and then records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize(device)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("Memset", "Memcpy"))]
        if events:
            break
    key = ("self_device_time_total" if events and
           hasattr(events[0], "self_device_time_total") else "self_cuda_time_total")
    total = sum(getattr(e, key) for e in events)
    return ((total / n if total > 0 else None), sorted(e.key[:80] for e in events),
            sum(e.count for e in events) / n)


@contextlib.contextmanager
def sync_warnings():
    """Record the warnings issued inside while
    ``torch.cuda.set_sync_debug_mode("warn")`` reports every synchronizing
    CUDA call (device→host read); ``n_reads`` counts those in the list."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(0)


def n_reads(caught) -> int:
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def host_reads(fn) -> int:
    """The synchronizing CUDA calls (device→host reads) one call of ``fn``
    makes, as ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    with sync_warnings() as caught:
        fn()
    return n_reads(caught)


class ChunkReads:
    """A MetricsSink (repro_torch/obs) that notes the host reads made so far
    (``caught``, from ``sync_warnings``) when the run opens and at each
    chunk's emit: ``per_chunk`` is each chunk's reads, the first chunk's
    warm-up and capture included."""

    def __init__(self, caught):
        self.caught = caught
        self.marks = []

    def open(self, header):
        self.marks.append(n_reads(self.caught))

    def emit(self, rows):
        self.marks.append(n_reads(self.caught))

    def close(self, footer):
        pass

    @property
    def per_chunk(self) -> list[int]:
        return np.diff(self.marks).tolist()


def bound_ms(nbytes: float, ops: dict) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the operations'
    time, each type's count (``ops``: {dtype: operations}) at its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_diff(a: torch.Tensor, b: torch.Tensor,
             scale: torch.Tensor | None = None) -> tuple[float, float]:
    """(max |a - b| / max scale, max |a - b|). The scale is the sum of the
    absolute values of the terms summed where the result may cancel (a
    sum's rounding error grows with those, not with the result), else |b|."""
    err = float((a - b).abs().max())
    scale = b.abs() if scale is None else scale
    return err / max(float(scale.max()), 1e-300), err


def bf16_steps(o: torch.Tensor, o_p: torch.Tensor) -> float:
    """max over elements of |o - o_p| / (2^-7 |o_p| + LM_BF16_ROW_FLOOR *
    RMS of o_p's row over the last dim); at most 1 where every element is
    within one bf16 step of the plain version."""
    o, o_p = o.float(), o_p.float()
    rms = o_p.pow(2).mean(-1, keepdim=True).sqrt()
    limit = LM_TOLERANCE[torch.bfloat16] * o_p.abs() + LM_BF16_ROW_FLOOR * rms
    return float(((o - o_p).abs() / limit.clamp_min(torch.finfo(torch.float32).tiny)).max())


def free_memory() -> None:
    """Collect a finished run's runner (its graph sits in reference
    cycles) and return the allocator's cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def memory_mark(device) -> int:
    """Reset the peak-memory counter and return the bytes allocated now: a
    run's peak above this mark is what the run itself allocated."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def launch_floor(device) -> float:
    """Phase 2's first reading: the empty kernel (one warp, no memory
    traffic) launched through the kernels' own path (``_build.noop``: ctypes
    and the current stream, counted nowhere), timed as ``device_ms`` times
    every kernel. No kernel's time can go below it."""
    from repro_torch.kernels import _build

    floor = device_ms(_build.noop, device)
    print(f"  launch floor (empty kernel <<<1, 32>>>, 20 back-to-back calls "
          f"between CUDA events, median of 5): {floor:.4f} ms", flush=True)
    return floor


def check_kernels(clients, dtype, device, floor: float) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes and on its data (the paper-scale clients, a trajectory from a
    random anchor, the AA solve's coefficients). ``floor``: the launch
    floor, printed beside each time."""
    from repro_torch.core.anderson import AAConfig, _solve_gram, trajectory_to_sy
    from repro_torch.kernels import _build
    from repro_torch.kernels.anderson import flat_gram, flat_update
    from repro_torch.kernels.anderson.ref import gram_ref, update_ref
    from repro_torch.kernels.local_update import fused_trajectory
    from repro_torch.kernels.local_update.ops import (inverse_count,
                                                      plan_trajectory,
                                                      resident_occupancy)
    from repro_torch.kernels.local_update.ref import trajectory_ref

    gen = torch.Generator(device=device).manual_seed(0)
    x = clients.x.to(dtype)[:, None]           # [K, 1, n, d], resident design
    y = clients.y.to(dtype)[:, None]
    mask = clients.mask.to(dtype)[:, None]
    K, _, n, d = x.shape
    steps = L_EPOCHS + 1
    w0 = 0.1 * torch.randn(K, d, generator=gen, device=device, dtype=dtype)
    u = 0.01 * torch.randn(K, d, generator=gen, device=device, dtype=dtype)
    invn = inverse_count(mask, dtype)
    kw = dict(link="logistic", reg=GAMMA, eta=ETA, anchor_scale=1.0, steps=steps)

    def kernel_traj():
        return fused_trajectory(x, y, mask, w0, u, **kw)

    def plain_traj():
        return trajectory_ref(x, y, mask, w0, u, invn, **kw)

    results = {}
    _build.reset_launches()
    wk, rk = kernel_traj()
    designs = dict(_build.DESIGN_LAUNCHES["trajectory"])
    wp, rp = plain_traj()
    errs = [rel_diff(wk, wp), rel_diff(rk, rp)]
    plan = plan_trajectory(K, 1, n, d, dtype)
    occ = resident_occupancy(dtype, kw["link"], True, n, d, plan.cluster)
    results["trajectory"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(kernel_traj, device), plain_ms=device_ms(plain_traj, device),
        library_ms=None,
        bound=bound_ms(nbytes(x, y, mask, w0, u, invn, wk, rk),
                       # live logits and X^T c every step, anchor logits once
                       {dtype: K * n * d * (4 * steps + 2)}),
        rerun_equal=all(map(torch.equal, kernel_traj(), (wk, rk))),
        plan=dict(design=plan.design, cluster=plan.cluster,
                  rows_per_block=plan.rows_per_block,
                  shared_bytes=occ["shared_bytes"],
                  active_clusters=occ["active_clusters"],
                  registers=occ["registers"], threads=occ["threads"]),
        designs=designs)
    # the streaming design at a per-step shape: S = steps blocks of m of
    # each client's rows (per-step minibatch rows)
    m = n // steps
    xps, yps, mps = (t[:, 0, :steps * m].reshape(K, steps, m, *t.shape[3:])
                     .contiguous() for t in (x, y, mask))
    invn_ps = inverse_count(mps, dtype)

    def kernel_ps():
        return fused_trajectory(xps, yps, mps, w0, u, **kw)

    def plain_ps():
        return trajectory_ref(xps, yps, mps, w0, u, invn_ps, **kw)
    _build.reset_launches()
    wk_ps, rk_ps = kernel_ps()
    ps_designs = dict(_build.DESIGN_LAUNCHES["trajectory"])
    wp_ps, rp_ps = plain_ps()
    errs = [rel_diff(wk_ps, wp_ps), rel_diff(rk_ps, rp_ps)]
    per_step = dict(
        shape=f"K={K} S={steps} n={m} d={d} {str(dtype)[6:]}",
        design=plan_trajectory(K, steps, m, d, dtype).design, designs=ps_designs,
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(kernel_ps, device), plain_ms=device_ms(plain_ps, device),
        # live and anchor logits and X^T c every step, each step other rows
        bound=bound_ms(nbytes(xps, yps, mps, w0, u, invn_ps, wk_ps, rk_ps),
                       {dtype: K * m * d * 6 * steps}),
        rerun_equal=all(map(torch.equal, kernel_ps(), (wk_ps, rk_ps))))
    results["trajectory"]["per_step"] = per_step
    t = results["trajectory"]
    print(f"  trajectory {str(dtype)[6:]:7s} plan {t['plan']}, launches by design "
          f"{designs}, rerun bit-identical {t['rerun_equal']}; per-step shape "
          f"[{per_step['shape']}] design {per_step['design']} ({ps_designs}): rel "
          f"{per_step['rel']:.3e} abs {per_step['abs']:.3e}  kernel "
          f"{per_step['ms']:.4f} ms  plain {per_step['plain_ms']:.4f} ms  bound "
          f"{per_step['bound'][0]:.4f} ms ({per_step['bound'][1]})  launch floor "
          f"{floor:.4f} ms, rerun "
          f"bit-identical {per_step['rerun_equal']}", flush=True)
    if designs != {"resident": 1, "streaming": 0} or ps_designs != {
            "resident": 0, "streaming": 1}:
        raise AssertionError(f"trajectory: the full-batch shape ran {designs}, "
                             f"the per-step shape {ps_designs}")
    if not (t["rerun_equal"] and per_step["rerun_equal"]):
        raise AssertionError("trajectory kernel: a rerun differs")
    if not per_step["rel"] <= TOLERANCE[dtype]:
        raise AssertionError(
            f"trajectory (streaming, per-step shape) disagrees with its plain "
            f"version in {dtype}: {per_step['rel']:.3e} > {TOLERANCE[dtype]:.0e}")
    # anchor_scale = 0 (SCAFFOLD, the AVG family): no anchor term, in both
    # designs at the same two shapes, u the per-client correction c - c_k
    anchor0 = {}
    for design, (xa, ya_, ma) in (("resident", (x, y, mask)),
                                  ("streaming", (xps, yps, mps))):
        kw0 = dict(kw, anchor_scale=0.0)
        inv0 = inverse_count(ma, dtype)

        def kernel_a0():
            return fused_trajectory(xa, ya_, ma, w0, u, **kw0)

        def plain_a0():
            return trajectory_ref(xa, ya_, ma, w0, u, inv0, **kw0)
        _build.reset_launches()
        wk0, rk0 = kernel_a0()
        ran = dict(_build.DESIGN_LAUNCHES["trajectory"])
        wp0, rp0 = plain_a0()
        errs = [rel_diff(wk0, wp0), rel_diff(rk0, rp0)]
        nb = xa.shape[2]
        anchor0[design] = dict(
            shape=f"K={K} S={xa.shape[1]} n={nb} d={d} {str(dtype)[6:]} a=0",
            designs=ran, rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
            ms=device_ms(kernel_a0, device), plain_ms=device_ms(plain_a0, device),
            library_ms=None,
            # live logits and X^T c every step, no anchor logits
            bound=bound_ms(nbytes(xa, ya_, ma, w0, u, inv0, wk0, rk0),
                           {dtype: K * nb * d * 4 * steps}),
            rerun_equal=all(map(torch.equal, kernel_a0(), (wk0, rk0))))
        a0 = anchor0[design]
        print(f"  trajectory {str(dtype)[6:]:7s} anchor_scale=0 {design} "
              f"[{a0['shape']}] ran {ran}: rel {a0['rel']:.3e} abs "
              f"{a0['abs']:.3e}  kernel {a0['ms']:.4f} ms  plain "
              f"{a0['plain_ms']:.4f} ms  bound {a0['bound'][0]:.4f} ms "
              f"({a0['bound'][1]})  launch floor {floor:.4f} ms, rerun "
              f"bit-identical {a0['rerun_equal']}", flush=True)
        if ran != {"resident": int(design == "resident"),
                   "streaming": int(design == "streaming")}:
            raise AssertionError(f"trajectory anchor_scale=0 at the {design} "
                                 f"shape ran {ran}")
        if not (a0["rerun_equal"] and a0["rel"] <= TOLERANCE[dtype]):
            raise AssertionError(
                f"trajectory anchor_scale=0 ({design}) in {dtype}: rel "
                f"{a0['rel']:.3e} (limit {TOLERANCE[dtype]:.0e}), rerun "
                f"bit-identical {a0['rerun_equal']}")
    results["trajectory"]["anchor0"] = anchor0

    s, ys = trajectory_to_sy(wp, rp)               # [K, m, d] each
    g = 0.01 * torch.randn(d, generator=gen, device=device, dtype=dtype)
    m = ys.shape[1]

    gk, ygk = flat_gram(ys, g)
    gp, ygp = gram_ref(ys, g)
    ya = ys.abs()
    errs = [rel_diff(gk, gp),
            rel_diff(ygk, ygp, (ya @ g.abs().unsqueeze(-1)).squeeze(-1))]
    # one torch call for both outputs: Y_k [Y_k^T | g] per client
    rhs = torch.cat([ys, g.expand(K, 1, d)], 1).transpose(1, 2).contiguous()
    results["gram"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(lambda: flat_gram(ys, g), device),
        plain_ms=device_ms(lambda: gram_ref(ys, g), device),
        library_ms=device_ms(lambda: torch.bmm(ys, rhs), device),
        bound=bound_ms(nbytes(ys, g, gk, ygk),
                       {dtype: K * d * 2 * (m * (m + 1) // 2 + m)}),
        rerun_equal=all(map(torch.equal, flat_gram(ys, g), (gk, ygk))),
        symmetric=torch.equal(gk, gk.transpose(1, 2)),
        occupancy=_build.occupancy("repro_gram_occupancy",
                                   _build.DTYPE_CODE[dtype], m, d))
    # each kernel's own duration (torch.profiler), launch gaps excluded
    results["gram"]["kernel_us"] = kernel_us(lambda: flat_gram(ys, g), device)[0]
    results["gram"]["library_kernel_us"], names, _ = kernel_us(
        lambda: torch.bmm(ys, rhs), device)
    print(f"  gram       {str(dtype)[6:]:7s} own device time (torch.profiler, "
          f"20 calls): kernel {results['gram']['kernel_us']} us, torch.bmm "
          f"{results['gram']['library_kernel_us']} us ({'; '.join(names)}); "
          f"rerun bit-identical {results['gram']['rerun_equal']}, exactly "
          f"symmetric {results['gram']['symmetric']}; "
          f"{results['gram']['occupancy']}", flush=True)
    if not (results["gram"]["rerun_equal"] and results["gram"]["symmetric"]):
        raise AssertionError("gram kernel: a rerun differs or the Gram matrix "
                             "is not exactly symmetric")

    gamma = _solve_gram(gp, ygp, AAConfig())[0]
    w = 0.1 * torch.randn(d, generator=gen, device=device, dtype=dtype)
    errs = []
    # the solve's coefficients, then coefficients of order 1: with the
    # former (|gamma| ~ 1e4) the S^T gamma and Y^T gamma terms dwarf eta g
    for coef in (gamma, torch.randn(K, m, generator=gen, device=device,
                                    dtype=dtype)):
        ok = flat_update(w, g, s, ys, coef, ETA, 1.0)
        op = update_ref(w, g, s, ys, coef, ETA, 1.0)
        ga = coef.abs().unsqueeze(-2)
        errs.append(rel_diff(ok, op, w.abs() + ETA * g.abs() + (
            ga @ s.abs() + ETA * (ga @ ya)).squeeze(-2)))
    results["update"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(lambda: flat_update(w, g, s, ys, gamma, ETA, 1.0), device),
        plain_ms=device_ms(lambda: update_ref(w, g, s, ys, gamma, ETA, 1.0),
                           device),
        library_ms=None,
        bound=bound_ms(nbytes(w, g, s, ys, gamma, ok),
                       {dtype: K * d * (4 * m + 4)}))
    results["aa_step"] = check_aa_step(f"main {str(dtype)[6:]}", w, g, s, ys,
                                       device, floor)
    # the AA kernels' slice-B variants: FedOSAA-AVG's per-client g [K, d]
    # (client stride d), and m = 15 columns (carry_history 5 + L 10, from a
    # trajectory of 16 steps)
    g_k = 0.01 * torch.randn(K, d, generator=gen, device=device, dtype=dtype)
    w16, r16 = trajectory_ref(x, y, mask, w0, u, invn, **dict(kw, steps=16))
    s15, y15 = trajectory_to_sy(w16, r16)
    for label, gv, sv, yv in (("g[K,d]", g_k, s, ys), ("m=15", g, s15, y15)):
        results[f"gram {label}"] = check_gram_variant(label, yv, gv, device)
        results[f"aa_step {label}"] = check_aa_step(
            f"{label} {str(dtype)[6:]}", w, gv, sv, yv, device, floor)

    for name, r in results.items():
        print(f"  {name:10s} {str(dtype)[6:]:7s} rel {r['rel']:.3e} "
              f"abs {r['abs']:.3e}  kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})  launch floor "
              f"{floor:.4f} ms", flush=True)
        if not r["rel"] <= TOLERANCE[dtype]:
            raise AssertionError(
                f"{name} kernel disagrees with its plain version in {dtype}: "
                f"{r['rel']:.3e} > {TOLERANCE[dtype]:.0e}")
    return results


def check_gram_variant(label: str, y: torch.Tensor, g: torch.Tensor,
                       device) -> dict:
    """Phase 2, the Gram pass at a slice-B variant (g per client [K, d], or
    m = 15 columns): against ``gram_ref`` (Y g relative to the sum of its
    terms' magnitudes), a rerun bit-identical and the Gram matrix exactly
    symmetric, one launch; timed beside its bound and plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.anderson import flat_gram
    from repro_torch.kernels.anderson.ref import gram_ref

    K, m, d = y.shape
    _build.reset_launches()
    gk, ygk = flat_gram(y, g)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    gp, ygp = gram_ref(y, g)
    terms = (y.abs() @ g.abs().expand(K, d).unsqueeze(-1)).squeeze(-1)
    errs = [rel_diff(gk, gp), rel_diff(ygk, ygp, terms)]
    out = dict(
        shape=f"K={K} m={m} d={d} g {list(g.shape)} {str(y.dtype)[6:]}",
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(lambda: flat_gram(y, g), device),
        plain_ms=device_ms(lambda: gram_ref(y, g), device), library_ms=None,
        bound=bound_ms(nbytes(y, g, gk, ygk),
                       {y.dtype: K * d * 2 * (m * (m + 1) // 2 + m)}),
        rerun_equal=all(map(torch.equal, flat_gram(y, g), (gk, ygk))),
        symmetric=torch.equal(gk, gk.transpose(1, 2)), launches=launches)
    print(f"  gram       {label} [{out['shape']}]: launches {launches}, rerun "
          f"bit-identical {out['rerun_equal']}, exactly symmetric "
          f"{out['symmetric']}", flush=True)
    if not (out["rerun_equal"] and out["symmetric"]) or launches != {"gram": 1}:
        raise AssertionError(f"gram {label}: rerun {out['rerun_equal']}, "
                             f"symmetric {out['symmetric']}, launches {launches}")
    return out


def jacobi_ops(sweeps: torch.Tensor, m: int) -> float:
    """Operations of the Jacobi sweeps that ``sweeps`` (one count a
    client) record, at n = m + (m & 1): per sweep the convergence test (3
    a pair) and n - 1 rounds of h = n / 2 rotations (~20 for the angle and
    the pair's own block), h (h - 1) / 2 blocks of pairs of pairs (24) and
    n h rows of V (6)."""
    n = m + (m & 1)
    h = n // 2
    per_sweep = 3 * n * (n - 1) / 2 + (n - 1) * (20 * h + 12 * h * (h - 1)
                                                 + 6 * n * h)
    return float(sweeps.sum()) * per_sweep


def check_aa_step(label: str, w, g, s, y, device, floor: float) -> dict:
    """Phase 2, the fused AA step (``aa_step``) on the Gram pass's output
    for histories s, y [K, m, d] (AAConfig's defaults: Tikhonov 1e-10, no
    filter, no screen): against ``aa_step_ref`` (the same Jacobi and sums
    op for op; only |g|^2, for theta, is summed in another order), a rerun,
    and its launches; timed beside the launch floor, its bound, the plain
    version and the composition it replaced (after the same Gram pass:
    ``_screened_solve``'s batched eigh, ``_theta``, the norm of gamma and
    ``flat_update``); the composition's and the kernel's own device time
    and kernels a call, and eigh's alone, from torch.profiler. Bound: S,
    Y, w, g, the Gram matrix and Y g read once, w+, gamma and the stats
    written once; the update's operations over the kept columns and the
    Jacobi sweeps this data needs."""
    from repro_torch.core.anderson import AAConfig, _screened_solve, _theta
    from repro_torch.kernels import _build
    from repro_torch.kernels.anderson import aa_step, flat_gram, flat_update
    from repro_torch.kernels.anderson.ops import aa_step_blocks
    from repro_torch.kernels.anderson.ref import (aa_step_ref, clip_keep_ref,
                                                  jacobi_eigh_ref)
    from repro_torch.utils import tree_math as tm

    cfg = AAConfig()
    K, m, d = s.shape
    dtype = s.dtype
    gram, yg = flat_gram(y, g)
    kw = dict(damping=cfg.damping, tikhonov=cfg.tikhonov,
              filter_rtol=cfg.filter_rtol, clip_rtol=cfg.clip_rtol)

    def fused():
        return aa_step(w, g, s, y, gram, yg, ETA, **kw)

    def plain():
        return aa_step_ref(w, g, s, y, gram, yg, ETA, **kw)

    def composed():
        gamma, cond, used, clipped, keep = _screened_solve(gram, yg, cfg)
        rhs = yg if keep is None else torch.where(keep, yg, 0.0)
        theta = _theta(rhs, gamma, tm.tree_dot(g, g))
        new_w = flat_update(w, g, s, y, gamma, ETA, cfg.damping)
        return (new_w, gamma, theta, torch.linalg.vector_norm(gamma, dim=-1),
                cond, used, clipped)

    _build.reset_launches()
    got = fused()
    torch.cuda.synchronize(device)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = plain()
    rerun_equal = all(torch.equal(a, b) for a, b in zip(fused(), got))
    plain_equal = {name: torch.equal(a, b) for name, a, b in zip(
        ("w", "gamma", "theta", "gamma_norm", "cond", "used", "clipped"),
        got, want)}
    keep = clip_keep_ref(gram, cfg.clip_rtol)
    ga = torch.where(keep, want[1].abs(), 0.0).unsqueeze(-2)
    scale = w.abs() + ETA * g.abs() + cfg.damping * (
        ga @ s.abs() + ETA * (ga @ y.abs())).squeeze(-2)
    errs = {"w": rel_diff(got[0], want[0], scale),
            "gamma": rel_diff(got[1], want[1]),
            "theta^2": (float((got[2] ** 2 - want[2] ** 2).abs().max()),) * 2,
            "gamma_norm": rel_diff(got[3], want[3]),
            "cond": rel_diff(got[4], want[4])}
    counts_equal = torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])
    comp = composed()
    comp_rel = rel_diff(comp[0], got[0], scale)[0]
    # the system the composition's eigh solves (AAConfig: no screen)
    system = gram + (cfg.tikhonov * torch.diagonal(gram, dim1=1, dim2=2).sum(-1)
                     / m)[:, None, None] * torch.eye(m, dtype=dtype, device=device)
    sweeps = jacobi_eigh_ref(system)[2]
    kept = keep.sum(-1)
    bound = bound_ms(nbytes(s, y, w, g, gram, yg, got[0], got[1]) + K * (
        3 * got[2].element_size() + 2 * 8),
                     {dtype: float((4 * kept + 4).sum()) * d + jacobi_ops(sweeps, m)})
    out = dict(
        shape=f"K={K} m={m} d={d} {str(dtype)[6:]}",
        blocks_per_client=aa_step_blocks(
            K, d, torch.cuda.get_device_properties(device).multi_processor_count),
        rel=max(e[0] for e in errs.values()), abs=max(errs["w"][1], errs["gamma"][1]),
        errors={k: e[0] for k, e in errs.items()}, counts_equal=counts_equal,
        plain_equal=plain_equal, rerun_equal=rerun_equal, launches=launches,
        sweeps=dict(min=int(sweeps.min()), median=float(sweeps.float().median()),
                    max=int(sweeps.max())),
        composition_vs_kernel_rel=comp_rel,
        ms=device_ms(fused, device), composed_ms=device_ms(composed, device),
        plain_ms=device_ms(plain, device, n=3, repeats=3), library_ms=None,
        bound=bound, launch_floor_ms=floor)
    out["kernel_us"], _, out["kernel_kernels"] = kernel_us(fused, device)
    out["composed_us"], _, out["composed_kernels"] = kernel_us(composed, device)
    out["eigh_us"], eigh_names, out["eigh_kernels"] = kernel_us(
        lambda: torch.linalg.eigh(system), device)
    out["eigh_ms"] = device_ms(lambda: torch.linalg.eigh(system), device)
    out["host_reads"] = host_reads(fused)
    out["composed_host_reads"] = host_reads(composed)
    print(f"  aa_step    {label} [{out['shape']}, {out['blocks_per_client']} "
          f"block(s) a client]: rel {out['rel']:.3e} ({ {k: float(f'{v:.3e}') for k, v in out['errors'].items()} }), "
          f"used/clipped equal {counts_equal}, bit-identical to plain "
          f"{plain_equal}, rerun bit-identical {rerun_equal}, launches "
          f"{launches}; Jacobi sweeps {out['sweeps']}; kernel "
          f"{out['ms']:.4f} ms (own device time {out['kernel_us']} us, "
          f"{out['kernel_kernels']:.0f} kernel a call)  composition "
          f"{out['composed_ms']:.4f} ms (own device time "
          f"{out['composed_us']} us, {out['composed_kernels']:.1f} kernels a "
          f"call; its w+ vs the kernel's, rel to the terms, {comp_rel:.3e})  "
          f"eigh alone {out['eigh_ms']:.4f} ms (own device time "
          f"{out['eigh_us']} us, {out['eigh_kernels']:.1f} kernels: "
          f"{'; '.join(n[:40] for n in eigh_names)}); host reads a call: "
          f"kernel {out['host_reads']}, composition "
          f"{out['composed_host_reads']}  plain "
          f"{out['plain_ms']:.4f} ms  bound {bound[0]:.5f} ms ({bound[1]})  "
          f"launch floor {floor:.4f} ms", flush=True)
    if not (rerun_equal and counts_equal):
        raise AssertionError(f"aa_step {label}: rerun bit-identical "
                             f"{rerun_equal}, used/clipped equal {counts_equal}")
    if launches != {"aa_step": 1} or out["host_reads"]:
        raise AssertionError(f"aa_step {label}: one call launched {launches} "
                             f"and read the host {out['host_reads']} times")
    return out


def check_aa_step_wide(device, floor: float) -> dict:
    """Phase 2, the fused AA step at K=16, m=10, d=2^20 in float32 (random
    histories; w and g shared): a wide update after the solve, where a
    design that serialised the solve ahead of the update would show it."""
    gen = torch.Generator(device=device).manual_seed(7)
    m = L_EPOCHS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)
    s, y = 0.01 * randn(K_WIDE, m, D_WIDE), 0.01 * randn(K_WIDE, m, D_WIDE)
    w, g = randn(D_WIDE), 0.01 * randn(D_WIDE)
    out = check_aa_step("wide", w, g, s, y, device, floor)
    if not out["rel"] <= TOLERANCE[torch.float32]:
        raise AssertionError(f"aa_step (wide) disagrees with its plain version: "
                             f"{out['rel']:.3e} > {TOLERANCE[torch.float32]:.0e}")
    del s, y
    torch.cuda.empty_cache()
    return out


def check_quant(device, floor: float) -> dict:
    """Phase 2, the wire's kernels: encode and decode of every client's
    upload against the plain versions on the same uniforms, bit for bit,
    at the main path's shape and at a streaming shape. Returns, per shape,
    each kernel's error, times and bound."""
    from repro_torch.kernels.quant import (DEFAULT_CHUNK, chunk_rows,
                                           int8_dequantize, int8_sr_encode)
    from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref

    C = DEFAULT_CHUNK
    out = {}
    for label, K, d, dtype in (("main", K_MAIN, D, torch.float64),
                               ("streaming", 16, 1 << 20, torch.float32)):
        gen = torch.Generator(device=device).manual_seed(d)
        x = torch.randn(K, d, generator=gen, device=device, dtype=dtype)
        x[0] = 0.0                                  # an all-zero client
        nc = chunk_rows(d, C)
        u = torch.rand((K, nc, C), generator=gen, device=device)

        def plain_encode():
            xp = torch.nn.functional.pad(x.to(torch.float32), (0, nc * C - d))
            return quantize_ref(xp.reshape(K, nc, C), u)

        def plain_decode(q, s):
            return dequantize_ref(q, s).reshape(K, -1)[:, :d].to(dtype)

        q, s = int8_sr_encode(x, u)
        qp, sp = plain_encode()
        dec = int8_dequantize(qp, sp, d, dtype)
        dp = plain_decode(qp, sp)
        torch.cuda.synchronize(device)
        q_err = int((q.to(torch.int32) - qp.to(torch.int32)).abs().max())
        s_err = float((s - sp).abs().max())
        d_err = float((dec - dp).abs().max())
        print(f"  quant {label:9s} [{K}, {nc}, {C}] x {str(dtype)[6:]}: "
              f"codes equal {torch.equal(q, qp)}, scales equal "
              f"{torch.equal(s, sp)}, output equal {torch.equal(dec, dp)}",
              flush=True)
        if not (torch.equal(q, qp) and torch.equal(s, sp)
                and torch.equal(dec, dp)):
            raise AssertionError(
                f"quant kernels at the {label} shape differ from their plain "
                f"versions: codes by {q_err}, scales by {s_err:.3e}, output "
                f"by {d_err:.3e}")
        # only the d values of each client carry data (the codes of the
        # ragged chunk's zero padding are 0 whatever their draws): per
        # value x, its draw, its code (quantize) or its code and decoded
        # value (dequantize), and one 4 B scale per chunk
        values, scale_bytes = K * d, K * nc * 4
        out[label] = {
            "quantize": dict(
                abs=max(float(q_err), s_err),
                ms=device_ms(lambda: int8_sr_encode(x, u), device),
                plain_ms=device_ms(plain_encode, device), library_ms=None,
                # abs, max, divide, add, floor, clip: ~7 operations a value
                bound=bound_ms(values * (x.element_size() + 4 + 1) + scale_bytes,
                               {torch.float32: 7 * values})),
            "dequantize": dict(
                abs=d_err,
                ms=device_ms(lambda: int8_dequantize(qp, sp, d, dtype), device),
                plain_ms=device_ms(lambda: plain_decode(qp, sp), device),
                library_ms=device_ms(lambda: torch.mul(qp, sp), device),
                bound=bound_ms(values * (1 + dec.element_size()) + scale_bytes,
                               {torch.float32: values})),
        }
        for name, r in out[label].items():
            print(f"  {name:10s} {label:9s} abs {r['abs']:.3e}  kernel "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]})  launch floor {floor:.4f} ms", flush=True)
    return out


def same_bits(a, b) -> bool:
    """Equal element for element, NaN where NaN (a NaN's payload aside)."""
    if a is None or b is None:
        return a is None and b is None
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


def check_uplink(device, floor: float) -> dict:
    """Phase 2, the fused int8 uplink (``int8_uplink``) at the main path's
    shape (K=100, d=54, float64) and at the streaming shape (K=16, d=2^20,
    float32), with the gradient uplink's buffers (ref + ef), the delta
    uplink's (anchor + ef) and the Newton direction's (the "dir" uplink: ef
    alone, no anchor, no reference); client 0's upload is all zeros. Then
    the ``post`` variant (the DP noise added to the decoded value before
    the residual, robust/faults.py) on the gradient's and the delta's
    buffers, with client 1's upload holding a NaN and client 2's an Inf
    (a NaN's code is 0, an Inf's chunk decodes to NaN, as the reference's
    codec gives them). Its outputs (dec, new_e, new_h) must equal the
    plain version's bit for bit (NaN where NaN), and so must a rerun's and
    the two-launch composition's (``Codec.uplink``'s arithmetic around the
    standalone pair); one call launches it once and neither standalone
    kernel. Times: the fused launch, the composition, the plain version,
    all from the same uniforms (the draw is in none of them); a post
    variant's beside its variant without ``post``. Bound: each input read
    once (x, the buffers, the anchor once for all clients, the draws of
    the n live values) and each output written once."""
    from repro_torch.comm.codecs import Codec, Int8SRCodec
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant import (DEFAULT_CHUNK, chunk_rows,
                                           int8_sr_uplink, int8_sr_uplink_ref)

    codec = Int8SRCodec(chunk=DEFAULT_CHUNK)
    want_launches = {k: 0 for k in _build.LAUNCHES} | {"int8_uplink": 1}
    out = {}
    for label, K, d, dtype in (("main", K_MAIN, D, torch.float64),
                               ("streaming", 16, 1 << 20, torch.float32)):
        gen = torch.Generator(device=device).manual_seed(d + 1)

        def randn(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=device,
                                       dtype=dtype)
        x, anchor = randn(K, d), randn(d)
        ref, ef = randn(K, d, scale=0.1), randn(K, d, scale=1e-3)
        post = randn(K, d, scale=1e-3)
        ref[0], ef[0] = 0.0, 0.0
        u = torch.rand((K, chunk_rows(d, DEFAULT_CHUNK), DEFAULT_CHUNK),
                       generator=gen, device=device)
        for spec, bufs in (("grad", dict(ref=ref, ef=ef)),
                           ("delta", dict(anchor=anchor, ef=ef)),
                           ("dir", dict(ef=ef)),
                           ("grad+post", dict(ref=ref, ef=ef, post=post)),
                           ("delta+post", dict(anchor=anchor, ef=ef,
                                               post=post))):
            xs = x.clone()
            xs[0] = anchor if "anchor" in bufs else 0.0   # an all-zero upload
            if "post" in bufs:
                xs[1, 3], xs[2, 5] = float("nan"), float("inf")

            def fused():
                return int8_sr_uplink(xs, u, **bufs)

            def composed():
                return Codec.uplink(codec, xs, u, **bufs)

            def plain():
                return int8_sr_uplink_ref(xs, u, **bufs)
            _build.reset_launches()
            got = fused()
            launches = dict(_build.LAUNCHES)
            want = plain()

            def same(a, b):
                return all(same_bits(p, q) for p, q in zip(a, b))
            equal, rerun_equal = same(got, want), same(fused(), got)
            composed_equal = same(composed(), got)
            errs = [float(torch.nan_to_num((p - q).abs(), nan=0.0).max())
                    for p, q in zip(got, want) if p is not None]
            # the outputs it writes: dec and new_e; new_h apart only with an
            # anchor after the reference (with ref alone it is dec)
            written = {id(t): t for t in got if t is not None}.values()
            values = K * d
            key = f"{label}/{spec}"
            # the codec in f32: |v|, max, divide, add u, floor, clip, product
            ops = {torch.float32: 8.0 * values}
            # the buffers' arithmetic in T: one op each in, one back out
            ops[dtype] = ops.get(dtype, 0.0) + 2.0 * len(bufs) * values
            out[key] = dict(
                shape=f"K={K} d={d} {str(dtype)[6:]} {spec} ({' + '.join(bufs)})",
                abs=max(errs), equal=equal, rerun_equal=rerun_equal,
                composed_equal=composed_equal, launches=launches,
                ms=device_ms(fused, device), composed_ms=device_ms(composed, device),
                plain_ms=device_ms(plain, device), library_ms=None,
                # the draws of the ragged chunk's padding are not read
                bound=bound_ms(nbytes(xs, *bufs.values(), *written) + 4 * values,
                               ops),
                launch_floor_ms=floor)
            r = out[key]
            if "post" in bufs:
                r["without_post_ms"] = out[f"{label}/{spec[:-5]}"]["ms"]
                r["nan_outputs"] = int(torch.isnan(got[0]).sum())
            print(f"  int8_uplink {key:15s} [{r['shape']}]: outputs equal "
                  f"{equal}, rerun bit-identical {rerun_equal}, composition "
                  f"equal {composed_equal}, launches "
                  f"{ {k: v for k, v in launches.items() if v} }  kernel "
                  f"{r['ms']:.4f} ms  composition (two launches and the "
                  f"torch glue) {r['composed_ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]})  launch floor {floor:.4f} ms"
                  + (f"  without post {r['without_post_ms']:.4f} ms, "
                     f"{r['nan_outputs']} NaN outputs (the NaN and Inf "
                     f"chunks')" if "post" in bufs else ""), flush=True)
            if not (equal and rerun_equal and composed_equal):
                raise AssertionError(
                    f"int8_uplink at {key}: outputs equal {equal}, rerun "
                    f"{rerun_equal}, composition {composed_equal} (abs "
                    f"{max(errs):.3e})")
            if launches != want_launches:
                raise AssertionError(f"int8_uplink at {key}: one call launched "
                                     f"{launches}, expected {want_launches}")
        del x, anchor, ref, ef, post, u, xs
    torch.cuda.empty_cache()
    return out


def check_resident(what: str, rounds: int, design: str = "resident") -> dict:
    """The trajectory launches of a run since the last reset, by design:
    every one must have run ``design`` (a full-batch round the resident
    one, a minibatch round, whose rows differ each step, the streaming
    one)."""
    from repro_torch.kernels import _build

    designs = dict(_build.DESIGN_LAUNCHES["trajectory"])
    want = {"resident": 0, "streaming": 0, design: rounds}
    if designs != want:
        raise AssertionError(f"{what}: trajectory ran {designs} over {rounds} "
                             f"rounds; every round runs the {design} design")
    return designs


def expected_launches(rounds: int, int8: bool,
                      algo: str = "fedosaa_svrg") -> dict:
    """Launches of a run of ``rounds`` rounds of ``algo``: the trajectory
    once a round of the trajectory family (TRAJECTORY_ALGOS) and never in
    a Newton round (GIANT, Newton-GMRES and DANE take Hessian-vector
    products, torch ops); the Gram pass and the fused AA step once a round
    of the FedOSAA algorithms and never else; on the int8 wire the fused
    int8 uplink once a round per upload of the algorithm's schema (two for
    the SVRG family, L-BFGS, SCAFFOLD and the Newton family, one for the
    AVG family) and never on another wire; the standalone update and quant
    pair and the LM kernels never."""
    from repro_torch.core import TRAJECTORY_ALGOS, UPLINK_SCHEMAS

    aa = algo.startswith("fedosaa_")
    traj = algo in TRAJECTORY_ALGOS
    return {"trajectory": rounds if traj else 0, "gram": rounds if aa else 0,
            "aa_step": rounds if aa else 0,
            **{k: 0 for k in FUSED_KERNELS},
            "int8_uplink": len(UPLINK_SCHEMAS[algo]) * rounds if int8 else 0,
            **{k: 0 for k in LM_KERNELS}}


def slots_replayed(rounds_run: int, chunk: int) -> int:
    """Slots an engine run replayed: every chunk replays all of its slots,
    a stop inside it or a short last chunk included."""
    return chunk * math.ceil(rounds_run / chunk)


def same_as_loop(what: str, s_loop, s_eng, w_loop, w_eng) -> None:
    """Raise unless an engine run equals its per-round-loop run: every
    telemetry row (the sinks' MemorySink rows) in every field but the wall
    times, equal values with nan where nan, and the final params bit for
    bit."""
    from repro_torch.obs import ROW_FIELDS

    fields = ("round",) + tuple(f for f in ROW_FIELDS
                                if f not in ("round_wall_s", "wall_time_s"))
    a, b = (np.array([[r[f] for f in fields] for r in sink.rows],
                     dtype=np.float64) for sink in (s_loop, s_eng))
    if a.shape != b.shape:
        raise AssertionError(f"{what}: the engine ran {len(b)} rounds, the "
                             f"loop {len(a)}")
    bad = [f for j, f in enumerate(fields)
           if not np.array_equal(a[:, j], b[:, j], equal_nan=True)]
    if bad or not torch.equal(w_loop, w_eng):
        raise AssertionError(f"{what}: the engine's rows differ from the "
                             f"loop's in {bad}; final params equal: "
                             f"{torch.equal(w_loop, w_eng)}")


def per_round_ms(wall_time: np.ndarray) -> np.ndarray:
    """Each round's ms from a History's cumulative wall time."""
    return np.diff(np.concatenate([[0.0], wall_time])) * 1e3


def engine_launches(what: str, rounds_run: int, chunk: int, int8: bool,
                    algo: str = "fedosaa_svrg",
                    design: str = "resident") -> dict:
    """Gate an engine run's launch counts (read just after it): each kernel
    of the round once per slot replayed, every trajectory in ``design``
    (none in a Newton round); the warm-up round before the capture is
    counted apart, not here."""
    from repro_torch.kernels import _build

    from repro_torch.core import TRAJECTORY_ALGOS

    launches = dict(_build.LAUNCHES)
    slots = slots_replayed(rounds_run, chunk)
    designs = check_resident(what, slots if algo in TRAJECTORY_ALGOS else 0,
                             design)
    want = expected_launches(slots, int8=int8, algo=algo)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {slots} slots "
                             f"replayed, expected {want}")
    return dict(slots=slots, launches=launches, designs=designs)


def acceptance(device) -> dict:
    """Phase 3: the acceptance configuration through the kernels, by the
    per-round loop and then by the engine (run_federated(chunk=8), one CUDA
    graph a chunk), which must stop on the loop's round with its rows and
    final params."""
    from repro_torch.core import AlgoHParams, run_federated, solve_reference
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink

    prob = acceptance_problem(device)
    w_star = solve_reference(prob, iters=100)
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    runs = {}
    for path, chunk in (("loop", None), ("engine", ACCEPT_CHUNK)):
        sink = MemorySink()
        _build.reset_launches()
        h = run_federated(prob, "fedosaa_svrg", hp, 20, w_star=w_star,
                          stop_rel_error=1e-8, device=device, chunk=chunk,
                          sinks=[sink])
        rounds = len(h.rounds)
        if chunk is None:
            launches = dict(_build.LAUNCHES)
            designs = check_resident("acceptance", rounds)
            if launches != expected_launches(rounds, int8=False):
                raise AssertionError(f"each slice-A kernel must launch once per "
                                     f"round: {launches} over {rounds} rounds")
            counted = dict(launches=launches, designs=designs)
        else:
            counted = engine_launches("acceptance engine", rounds, chunk,
                                      int8=False)
        hit = np.nonzero(h.rel_error < 1e-6)[0]
        to_target = int(hit[0]) + 1 if len(hit) else None
        loss_rel = abs(h.loss[-1] - REFERENCE_LOSS) / REFERENCE_LOSS
        ms = per_round_ms(h.wall_time)
        # the loop's round 0, the engine's first chunk: warm-up and capture
        skip = 1 if chunk is None else chunk
        runs[path] = dict(h=h, sink=sink, rounds=rounds, to_target=to_target,
                          loss=float(h.loss[-1]),
                          ms_per_round=float(np.median(ms[skip:])))
        print(f"  {path}{'' if chunk is None else f' (chunk={chunk})'}: "
              f"rounds run {rounds}, rounds to rel-error 1e-6: {to_target}, "
              f"final loss {h.loss[-1]!r} (rel {loss_rel:.2e} from the "
              f"reference), {counted}", flush=True)
        print(f"  {path}: median {runs[path]['ms_per_round']:.3f} ms/round over "
              f"rounds {skip}..{rounds - 1} (before them: "
              f"{h.wall_time[skip - 1] * 1e3:.1f} ms)", flush=True)
        if to_target is None or to_target > 18:
            raise AssertionError(f"{path}: rel-error 1e-6 not reached within "
                                 f"18 rounds ({to_target})")
        if not loss_rel <= 1e-12:
            raise AssertionError(f"{path}: final loss {h.loss[-1]!r} is "
                                 f"{loss_rel:.2e} from {REFERENCE_LOSS!r}")
    print("  rel-error curve " + json.dumps(
        [float(v) for v in runs["loop"]["h"].rel_error]), flush=True)
    same_as_loop("acceptance", runs["loop"]["sink"], runs["engine"]["sink"],
                 runs["loop"]["h"].final_params, runs["engine"]["h"].final_params)
    print("  engine = loop: the same rounds, rows and final params", flush=True)
    return {**{path: {k: v for k, v in r.items() if k not in ("h", "sink")}
               for path, r in runs.items()}, "w_star": w_star}


def paper_scale(clients, w_star, device) -> dict:
    """Phase 4: the main path at the paper's covtype size, both dtypes on
    the identity wire and float64 on the int8 wire, each by the per-round
    loop and then by the engine (10 rounds in chunks of 5, one CUDA graph
    a chunk). Each run is read on its own launch counts: they are set to 0
    just before it and read just after. The engine run must equal the loop
    run in every row and in the final params, and make one host read in
    each chunk after the first; its runner is then replayed PAPER_REPLAYS
    more times for its ms per round."""
    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  make_round_fn, run_federated, run_rounds)
    from repro_torch.core.engine import _map_state
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import MemorySink

    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    out = {}
    for name, dtype, channel in (("float64", torch.float64, None),
                                 ("float32", torch.float32, None),
                                 ("float64_int8", torch.float64, "int8")):
        prob = make_logreg_problem(clients, GAMMA, dtype=dtype, device=device)
        ws = w_star.to(dtype)
        s_loop = MemorySink()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        h = run_federated(prob, "fedosaa_svrg", hp, 10, w_star=ws,
                          device=device, channel=channel, sinks=[s_loop])
        launches = dict(_build.LAUNCHES)
        peak_loop = torch.cuda.max_memory_allocated(device)
        rounds = len(h.rounds)
        designs = check_resident(f"paper-scale {name} run", rounds)
        per_round = np.diff(h.wall_time) * 1e3      # round 0 excluded
        out[name] = dict(ms_per_round=float(np.median(per_round)),
                         rel_error=float(h.rel_error[-1]), rounds=rounds,
                         launches=launches, designs=designs,
                         comm_bytes=float(h.comm_bytes[-1]),
                         peak_mib=peak_loop / 2 ** 20)
        print(f"  {name} [{h.channel}] loop: {rounds} rounds, median "
              f"{out[name]['ms_per_round']:.3f} ms/round (round 0: "
              f"{h.wall_time[0] * 1e3:.1f} ms), rel-error "
              f"{h.rel_error[-1]:.3e}, loss {h.loss[-1]!r}, bytes "
              f"{h.comm_bytes[-1]:.0f}, launches {launches}, trajectory by "
              f"design {designs}, peak {peak_loop / 2 ** 20:.1f} MiB",
              flush=True)
        want = expected_launches(rounds, int8=channel == "int8")
        if launches != want:
            raise AssertionError(f"paper-scale {name} run: launches "
                                 f"{launches} over {rounds} rounds, expected "
                                 f"{want}")
        if not (np.all(np.isfinite(h.loss)) and h.rel_error[-1] < h.rel_error[0]):
            raise AssertionError(f"paper-scale {name} run did not converge: "
                                 f"{h.rel_error.tolist()}")

        round_fn = make_round_fn("fedosaa_svrg", prob, hp, channel,
                                 device=device)
        state = init_state(prob, device=device, channel=channel,
                           algo="fedosaa_svrg")
        runner = make_chunk_runner(round_fn, PAPER_CHUNK, w_star=ws)
        s_eng = MemorySink()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        with sync_warnings() as caught:
            reads = ChunkReads(caught)
            state, trace = run_rounds(round_fn, state, 10, chunk=PAPER_CHUNK,
                                      w_star=ws, runner=runner,
                                      sinks=[s_eng, reads])
        peak = torch.cuda.max_memory_allocated(device)
        counted = engine_launches(f"paper-scale {name} engine run",
                                  trace.num_rounds, PAPER_CHUNK,
                                  int8=channel == "int8")
        per_chunk = reads.per_chunk
        if any(n != 1 for n in per_chunk[1:]):
            raise AssertionError(f"paper-scale {name} engine run: host reads "
                                 f"per chunk {per_chunk}; one in each after "
                                 f"the first")
        same_as_loop(f"paper-scale {name}", s_loop, s_eng, h.final_params,
                     state.params)
        if name != "float32":
            # phase 4g's reference: the loop's rows and params, the
            # engine's whole state before the replays below overwrite it
            out[name]["vmap"] = dict(sink=s_loop, params=h.final_params,
                                     state=_map_state(torch.clone, state))
        # the gated run's second chunk, then more replays, each ending in
        # its one read
        walls = [float(trace.round_wall[PAPER_CHUNK:].sum())]
        for _ in range(PAPER_REPLAYS):
            t0 = time.perf_counter()
            state, *_ = runner(state, PAPER_CHUNK)
            walls.append(time.perf_counter() - t0)
        ms = float(np.median(walls)) / PAPER_CHUNK * 1e3
        out[name]["engine"] = dict(
            ms_per_round=ms, chunk_ms=[w * 1e3 for w in walls],
            warmup_ms=runner.warmup_ms, capture_ms=runner.capture_ms,
            reads_per_chunk=per_chunk, peak_mib=peak / 2 ** 20,
            warmup_launches=runner.warmup_launches.launches, **counted)
        print(f"  {name} [{h.channel}] engine (chunk={PAPER_CHUNK}): "
              f"{trace.num_rounds} rounds = the loop's rows and final params; "
              f"{ms:.3f} ms/round over {len(walls)} replayed chunks (chunk ms "
              f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}), the loop "
              f"{out[name]['ms_per_round']:.3f}; warm-up "
              f"{runner.warmup_ms:.1f} ms, capture {runner.capture_ms:.1f} "
              f"ms; host reads per chunk {per_chunk}; peak "
              f"{peak / 2 ** 20:.1f} MiB; launches {counted['launches']} over "
              f"{counted['slots']} slots, trajectory by design "
              f"{counted['designs']}; warm-up launches (apart) "
              f"{runner.warmup_launches.launches}", flush=True)
        # the runner's graph pool and buffers stay allocated while it
        # lives: free them before the next config's peaks are read
        del runner, state, round_fn, h
        torch.cuda.empty_cache()
    return out


def no_host_read(clients, device) -> None:
    """Phase 4's gate: one paper-scale float64 round, after two warm-up
    rounds, on the identity and on the int8 wire under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing CUDA call
    inside ``round_fn`` raises, and the raise fails the run. The round
    still launches each of its kernels as often as every round does."""
    from repro_torch.core import AlgoHParams, init_state, make_round_fn
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    for channel in (None, "int8"):
        round_fn = make_round_fn("fedosaa_svrg", prob,
                                 AlgoHParams(eta=ETA, local_epochs=L_EPOCHS),
                                 channel, device=device)
        state = init_state(prob, device=device, channel=channel,
                           algo="fedosaa_svrg")
        for _ in range(2):
            state, _ = round_fn(state)
        torch.cuda.synchronize(device)
        _build.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = round_fn(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = dict(_build.LAUNCHES)
        loss = float(metrics.loss)
        print(f"  no host read in a round [{channel or 'identity'}]: the round "
              f"ran under set_sync_debug_mode('error'), launches "
              f"{ {k: v for k, v in launches.items() if v} }, loss {loss!r}",
              flush=True)
        want = expected_launches(1, int8=channel == "int8")
        if launches != want or not np.isfinite(loss):
            raise AssertionError(f"no-host-read round [{channel}]: launches "
                                 f"{launches} (expected {want}), loss {loss}")


#: phase 4b: the trajectory family at paper scale (f64, 10 rounds, by the
#: loop and by the engine in chunks of PAPER_CHUNK): (run name, algorithm,
#: AlgoHParams knobs, channel). Minibatch B=64 is the reference's
#: fig1_batch_sweep's; carry_history=5 its ext_carry_history's L10_carry5.
FAMILY_RUNS = (
    ("scaffold", "scaffold", {}, None),
    ("fedosaa_scaffold", "fedosaa_scaffold", {}, None),
    ("fedavg", "fedavg", {}, None),
    ("fedosaa_avg", "fedosaa_avg", {}, None),
    ("lbfgs", "lbfgs", {}, None),
    ("fedosaa_svrg_b64", "fedosaa_svrg", {"batch_size": 64}, None),
    ("fedosaa_svrg_carry5", "fedosaa_svrg", {"carry_history": 5}, None),
    ("fedosaa_scaffold_int8", "fedosaa_scaffold", {}, "int8"),
)


def comm_rows(state) -> list:
    """(name, tensor) of every per-client tensor of the state's comm: each
    uplink's buffers, and the robustness layer's reserved keys (the stale
    anchors, the gate's buffer rows and int32 ages), by sorted key."""
    out = []
    for tag in sorted(state.comm or {}):
        sub = state.comm[tag]
        if isinstance(sub, torch.Tensor):
            out.append((f"comm[{tag}]", sub))
        else:
            out.extend((f"comm[{tag}][{b}]", sub[b]) for b in sorted(sub))
    return out


def same_state(what: str, s_loop, s_eng) -> None:
    """Raise unless two ServerStates hold the same tensors bit for bit: the
    params, SCAFFOLD's c and c_k, the carried AA columns and the comm
    buffers, each where the state has it."""
    bad = []
    for f in ("params", "c", "c_k", "hist_s", "hist_y"):
        a, b = getattr(s_loop, f), getattr(s_eng, f)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            bad.append(f)
    comm_a, comm_b = s_loop.comm or {}, s_eng.comm or {}
    if sorted(comm_a) != sorted(comm_b):
        bad.append("comm")
    for (key, buf), (_, other) in zip(comm_rows(s_loop), comm_rows(s_eng)):
        if buf.dtype != other.dtype or not torch.equal(buf, other):
            bad.append(key)
    if bad:
        raise AssertionError(f"{what}: the engine's final state differs from "
                             f"the loop's in {bad}")


def trajectory_family(clients, w_star, device) -> dict:
    """Phase 4b: every FAMILY_RUNS run at paper scale in float64, by the
    per-round loop and then by the engine (10 rounds in chunks of
    PAPER_CHUNK), each read on its own launch counts. Gates per run: the
    trajectory once a round (slot), resident at full batch and streaming in
    minibatch mode; gram and aa_step once only for the FedOSAA algorithms;
    int8_uplink once per upload; the engine equals the loop in every row
    and in the final state (params, c, c_k, hist_s, hist_y, comm) and reads
    the card once a chunk after the first; one warmed-up round makes no
    host read (``set_sync_debug_mode("error")``). Prints ms per round,
    engine against loop."""
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    return {name: loop_and_engine_run(prob, name, algo, knobs, channel, w_star,
                                      device)
            for name, algo, knobs, channel in FAMILY_RUNS}


def start_state(prob, algo: str, hp, channel, device, robust=None):
    """The run's initial state, with the rows a fault plan with stale
    anchors and an active deadline gate carry (``robust``: the
    run_federated keywords ``faults``/``async_cfg``), as run_federated
    attaches them."""
    from repro_torch.core import init_state
    from repro_torch.robust import init_async_comm, init_fault_comm

    st = init_state(prob, device=device, channel=channel, algo=algo, hp=hp)
    faults, gate = (robust or {}).get("faults"), (robust or {}).get("async_cfg")
    K = prob.clients.num_clients
    if faults is not None and faults.active and faults.stale_rate > 0.0:
        st = st._replace(comm=init_fault_comm(st.comm, st.params, K))
    if gate is not None and gate.active:
        st = st._replace(comm=init_async_comm(st.comm, st.params, K))
    return st


def no_host_read_round(prob, name: str, algo: str, hp, channel, device,
                       design: str = "resident", robust=None) -> dict:
    """One round of ``algo`` after two warm-up rounds under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing CUDA
    call raises and fails the run), launching what a round launches; with
    ``robust``, the fault plan's and the gate's round. Returns its
    launches."""
    from repro_torch.core import TRAJECTORY_ALGOS, make_round_fn
    from repro_torch.kernels import _build

    int8 = channel == "int8"
    round_fn = make_round_fn(algo, prob, hp, channel, device=device,
                             **(robust or {}))
    st = start_state(prob, algo, hp, channel, device, robust)
    for _ in range(2):
        st, _ = round_fn(st)
    torch.cuda.synchronize(device)
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = round_fn(st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    one = dict(_build.LAUNCHES)
    check_resident(f"{name} no-host-read round",
                   1 if algo in TRAJECTORY_ALGOS else 0, design)
    if one != expected_launches(1, int8=int8, algo=algo) or not np.isfinite(
            float(m.loss)):
        raise AssertionError(f"{name} no-host-read round [{channel}]: "
                             f"launches {one}, loss {float(m.loss)}")
    return {k: v for k, v in one.items() if v}


def hp_knobs(knobs: dict) -> dict:
    """AlgoHParams keywords from a run's knobs: ``aa_clip_rtol`` names the
    AA step's clip_rtol screen (AAConfig), the others are AlgoHParams
    fields."""
    from repro_torch.core import AAConfig

    out = {k: v for k, v in knobs.items() if k != "aa_clip_rtol"}
    if "aa_clip_rtol" in knobs:
        out["aa"] = AAConfig(clip_rtol=knobs["aa_clip_rtol"])
    return out


def loop_and_engine_run(prob, name: str, algo: str, knobs: dict, channel,
                        w_star, device, chunk: int = PAPER_CHUNK,
                        sync_wires=None, state_gate=None, robust=None,
                        keep: bool = False, n_rounds: int = 10) -> dict:
    """One run of phases 4b, 4c and 4d: ``n_rounds`` rounds of ``algo`` (AlgoHParams
    with ``knobs``) on ``channel`` by the per-round loop, then by the
    engine in chunks of ``chunk`` (then PAPER_REPLAYS more replays for its
    ms per round), each read on its own launch counts and its peak memory;
    the engine must equal the loop in every row and in the final state and
    read the card once a chunk after the first; ``state_gate(round_fn,
    initial state, engine state)`` then holds the engine's final state
    (before the extra replays) to more. Then one warmed-up round on each of
    ``sync_wires`` (None: the run's own wire; () none) under the sync
    debug mode. ``robust`` (run_federated's ``faults``/``async_cfg``) runs it
    under a fault plan and the deadline gate. Prints and returns the run's
    readings; with ``keep``, also the loop's rows and final params and the
    engine's final state (``"vmap"``), phase 4g's reference."""
    from repro_torch.core import (TRAJECTORY_ALGOS, AlgoHParams,
                                  make_chunk_runner, make_round_fn,
                                  run_federated, run_rounds)
    from repro_torch.core.engine import _map_state
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink

    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS, **hp_knobs(knobs))
    design = "streaming" if knobs.get("batch_size") else "resident"
    int8 = channel == "int8"
    s_loop = MemorySink()
    _build.reset_launches()
    base_loop = memory_mark(device)
    h = run_federated(prob, algo, hp, n_rounds, w_star=w_star, device=device,
                      channel=channel, sinks=[s_loop], **(robust or {}))
    launches = dict(_build.LAUNCHES)
    peak_loop = torch.cuda.max_memory_allocated(device) - base_loop
    rounds = len(h.rounds)
    designs = check_resident(f"{name} loop",
                             rounds if algo in TRAJECTORY_ALGOS else 0, design)
    want = expected_launches(rounds, int8=int8, algo=algo)
    if launches != want:
        raise AssertionError(f"{name} loop: launches {launches} over "
                             f"{rounds} rounds, expected {want}")
    if not np.all(np.isfinite(h.loss)):
        raise AssertionError(f"{name} loop: a non-finite loss {h.loss}")
    loop_ms = float(np.median(np.diff(h.wall_time) * 1e3))

    round_fn = make_round_fn(algo, prob, hp, channel, device=device,
                             **(robust or {}))
    s_ref = start_state(prob, algo, hp, channel, device, robust)
    for _ in range(rounds):
        s_ref, _ = round_fn(s_ref)
    s0 = start_state(prob, algo, hp, channel, device, robust)
    runner = make_chunk_runner(round_fn, chunk, w_star=w_star)
    s_eng = MemorySink()
    _build.reset_launches()
    base = memory_mark(device)
    with sync_warnings() as caught:
        reads = ChunkReads(caught)
        state, trace = run_rounds(round_fn, s0, n_rounds, chunk=chunk,
                                  w_star=w_star, runner=runner,
                                  sinks=[s_eng, reads])
    peak = torch.cuda.max_memory_allocated(device) - base
    counted = engine_launches(f"{name} engine", trace.num_rounds, chunk, int8,
                              algo, design)
    if any(n != 1 for n in reads.per_chunk[1:]):
        raise AssertionError(f"{name} engine: host reads per chunk "
                             f"{reads.per_chunk}; one in each after the first")
    same_as_loop(name, s_loop, s_eng, h.final_params, state.params)
    same_state(name, s_ref, state)
    gated = state_gate(round_fn, s0, state) if state_gate else None
    # before the replays below overwrite the runner's buffers
    kept = (dict(sink=s_loop, params=h.final_params,
                 state=_map_state(torch.clone, state)) if keep else None)
    # the gated run's second chunk, then more replays
    walls = [float(trace.round_wall[chunk:2 * chunk].sum())]
    for _ in range(PAPER_REPLAYS):
        t0 = time.perf_counter()
        state, *_ = runner(state, chunk)
        walls.append(time.perf_counter() - t0)
    eng_ms = float(np.median(walls)) / chunk * 1e3
    no_read = {wire or "identity": no_host_read_round(
        prob, name, algo, hp, wire, device, design, robust)
        for wire in ((channel,) if sync_wires is None else sync_wires)}
    out = dict(algo=algo, knobs=knobs, channel=channel or "identity",
               rounds=rounds, rel_error=float(h.rel_error[-1]),
               loss=float(h.loss[-1]), launches=launches, designs=designs,
               ms_per_round=loop_ms, peak_above_mib=peak_loop / 2 ** 20,
               base_mib=base_loop / 2 ** 20,
               engine=dict(ms_per_round=eng_ms, chunk=chunk,
                           chunk_ms=[w * 1e3 for w in walls],
                           reads_per_chunk=reads.per_chunk,
                           warmup_ms=runner.warmup_ms,
                           capture_ms=runner.capture_ms,
                           peak_above_mib=peak / 2 ** 20, **counted),
               no_host_read_launches=no_read, gated=gated)
    if kept is not None:
        out["vmap"] = kept
    print(f"  {name:22s} [{channel or 'identity'}] loop {loop_ms:.3f} ms/round, "
          f"engine (chunk={chunk}) {eng_ms:.3f} ms/round (capture "
          f"{runner.capture_ms:.1f} ms); rel-error {h.rel_error[-1]:.3e}, loss "
          f"{h.loss[-1]!r}; launches "
          f"{ {k: v for k, v in launches.items() if v} } over {rounds} "
          f"rounds, trajectory {designs}; engine = loop (rows, final "
          f"state), {counted['slots']} slots replayed, launches "
          f"{ {k: v for k, v in counted['launches'].items() if v} }, host "
          f"reads per chunk {reads.per_chunk}; no host read in a round "
          f"{no_read}; peak above the {base_loop / 2 ** 20:.1f} MiB held "
          f"before: loop {peak_loop / 2 ** 20:.1f} MiB, engine "
          f"{peak / 2 ** 20:.1f} MiB{'' if gated is None else f'; {gated}'}",
          flush=True)
    del runner, state, round_fn, h, s_ref, s0
    free_memory()
    return out


#: phase 4c: the Newton family at paper scale (f64, 10 rounds, by the loop
#: and by the engine): (run name, algorithm, AlgoHParams knobs, channel,
#: engine chunk). DANE takes fig6_walltime's 10 Newton steps of 50 CG
#: iterations (benchmarks/fig6_walltime.py), ~500 Hessian-vector products a
#: round, so its graph holds one round.
NEWTON_RUNS = (
    ("giant", "giant", {}, None, PAPER_CHUNK),
    ("giant_line_search", "giant", {"line_search": True}, None, PAPER_CHUNK),
    ("newton_gmres", "newton_gmres", {}, None, PAPER_CHUNK),
    ("dane_fig6", "dane", {"dane_newton_iters": 10, "dane_cg_iters": 50},
     None, 1),
    ("giant_int8", "giant", {}, "int8", PAPER_CHUNK),
)
#: the runs whose depth is cut: (rounds, sync-debug wires). DANE keeps
#: fig6's 10 x 50 a round for 2 rounds (two chunks of 1) and no
#: sync-debug round: its engine run captures its rounds (a host read in
#: one fails the capture), and phase 4e's DANE run has its sync-debug
#: round. At 10 rounds (the loop and the reference state each run them)
#: and two sync-debug wires (three rounds each) it took 158.6 s of a
#: 175.5-s phase on an H100 host, and the whole call passed 1200 s on a
#: slow host once phase 6f was added (ROADMAP item 0b)
NEWTON_DEPTH = {"dane_fig6": (2, ())}


def newton_family(clients, w_star, device, paper: dict) -> dict:
    """Phase 4c: every NEWTON_RUNS run at paper scale in float64, by the
    per-round loop and then by the engine, each read on its own launch
    counts (no ``trajectory``, ``gram`` or ``aa_step``; on int8 two
    ``int8_uplink`` a round, the gradient's and the direction's); the
    engine equals the loop in every row and in the final state (params and
    the comm buffers) and reads the card once a chunk after the first; one
    warmed-up round of each algorithm on the identity and on the int8 wire
    makes no host read. Prints ms per round (loop and engine), the
    engine's capture ms and the rel-error after 10 rounds beside
    FedOSAA-SVRG's from phase 4 (the paper's Fig. 6 comparison on this
    card)."""
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    out = {}
    for name, algo, knobs, channel, chunk in NEWTON_RUNS:
        n_rounds, sync = NEWTON_DEPTH.get(
            name, (10, (None, "int8") if channel is None else None))
        out[name] = loop_and_engine_run(prob, name, algo, knobs, channel, w_star,
                                        device, chunk, sync_wires=sync,
                                        n_rounds=n_rounds)
    svrg = paper["float64"]
    print(f"  Fig. 6 on this card (10 rounds, float64, identity wire; "
          f"{', '.join(f'{k} {v[0]}' for k, v in NEWTON_DEPTH.items())}): "
          f"fedosaa_svrg rel-error {svrg['rel_error']:.3e}, loop "
          f"{svrg['ms_per_round']:.3f} ms/round, engine "
          f"{svrg['engine']['ms_per_round']:.3f} ms/round; " + "; ".join(
              f"{name} {r['rel_error']:.3e}, loop {r['ms_per_round']:.3f}, "
              f"engine {r['engine']['ms_per_round']:.3f} ms/round "
              f"(capture {r['engine']['capture_ms']:.0f} ms)"
              for name, r in out.items() if r["channel"] == "identity"),
          flush=True)
    return out


#: phase 4d: cohorts at paper scale, participation 0.1 (C = 10 of K = 100,
#: a usual cross-device rate): (run name, algorithm, AlgoHParams knobs,
#: channel), each by the loop and by the engine in chunks of PAPER_CHUNK
COHORT_PARTICIPATION = 0.1
COHORT_RUNS = (
    ("cohort_fedosaa_svrg", "fedosaa_svrg", {}, None),
    ("cohort_fedosaa_svrg_int8", "fedosaa_svrg", {}, "int8"),
    ("cohort_fedosaa_scaffold", "fedosaa_scaffold", {}, None),
    ("cohort_fedosaa_svrg_carry5", "fedosaa_svrg", {"carry_history": 5}, None),
    ("cohort_giant", "giant", {}, None),
)
#: the phase-4/4b/4c dense run each cohort run is printed beside
COHORT_DENSE = {"cohort_fedosaa_svrg": "float64",
                "cohort_fedosaa_svrg_int8": "float64_int8",
                "cohort_fedosaa_scaffold": "fedosaa_scaffold",
                "cohort_fedosaa_svrg_carry5": "fedosaa_svrg_carry5",
                "cohort_giant": "giant"}
#: the reference's ext_cohort point (benchmarks/ext_cohort.py):
#: synthetic_small, max(2048, 8K) rows over K iid clients (8 a client from
#: K=256 up), float32, FedOSAA-SVRG, eta=0.5, L=2, by the engine in chunks
#: of 4, 8 rounds; a cohort of 16 against the dense round at each K
EXT_COHORT_KS, EXT_COHORT_C = (32, 512, 4096), 16
EXT_COHORT_ROUNDS, EXT_COHORT_CHUNK, EXT_COHORT_REPLAYS = 8, 4, 5
#: its gate (the reference's test_k4096_engine_run_converges): the global
#: loss of the K=4096, C=16 run ends below this share of its initial value
EXT_COHORT_LOSS_SHARE = 0.7


def frozen_rows(round_fn, s0, state) -> dict:
    """Phase 4d's state gate: the store rows (c_k, the carried columns, the
    comm buffers) of the clients no round of the run drew are bit-equal to
    their initial values. Returns the counts of clients drawn and not."""
    from repro_torch.core import ClientStateStore
    from repro_torch.core.algorithms import COHORT

    dev = s0.params.device
    bufs = {COHORT: torch.empty((state.t - s0.t,
                                 *round_fn.draw_specs[COHORT][0]),
                                dtype=torch.int64, device=dev)}
    round_fn.fill_draws(bufs, s0.t)
    drawn = set(torch.unique(bufs[COHORT]).tolist())
    fields = [(f, getattr(s0, f), getattr(state, f))
              for f in ("c_k", "hist_s", "hist_y") if getattr(s0, f) is not None]
    fields += [(key, x, y) for (key, x), (_, y) in zip(comm_rows(s0),
                                                       comm_rows(state))]
    if not fields:
        return dict(drawn=len(drawn), store_fields=0)
    n = ClientStateStore.from_state(s0).num_clients
    never = torch.tensor(sorted(set(range(n)) - drawn), dtype=torch.int64,
                         device=dev)
    bad = [f for f, a, b in fields
           if not torch.equal(a.index_select(0, never), b.index_select(0, never))]
    if bad or len(never) == 0:
        raise AssertionError(f"cohort run: rows of the {len(never)} clients "
                             f"never drawn changed in {bad}")
    return dict(drawn=len(drawn), never_drawn=len(never),
                store_fields=len(fields))


def trajectory_at(label: str, x, y, mask, dtype, device, floor: float,
                  steps: int, eta: float) -> dict:
    """Phase 4d: ``trajectory`` at a cohort's shape (x [C, n, d] of the
    cohort's clients, full batch) against its plain version, from a random
    anchor: one launch of the design ``plan_trajectory`` picks (resident),
    within TOLERANCE of the plain result, a rerun bit-identical; its plan,
    time, plain time and bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.local_update import fused_trajectory
    from repro_torch.kernels.local_update.ops import (inverse_count,
                                                      plan_trajectory,
                                                      resident_occupancy)
    from repro_torch.kernels.local_update.ref import trajectory_ref

    x, y, mask = (t.to(dtype)[:, None].contiguous() for t in (x, y, mask))
    C, _, n, d = x.shape
    gen = torch.Generator(device=device).manual_seed(0)
    w0 = 0.1 * torch.randn(C, d, generator=gen, device=device, dtype=dtype)
    u = 0.01 * torch.randn(C, d, generator=gen, device=device, dtype=dtype)
    invn = inverse_count(mask, dtype)
    kw = dict(link="logistic", reg=GAMMA, eta=eta, anchor_scale=1.0,
              steps=steps)

    def kernel():
        return fused_trajectory(x, y, mask, w0, u, **kw)

    def plain():
        return trajectory_ref(x, y, mask, w0, u, invn, **kw)

    _build.reset_launches()
    wk, rk = kernel()
    designs = dict(_build.DESIGN_LAUNCHES["trajectory"])
    wp, rp = plain()
    errs = [rel_diff(wk, wp), rel_diff(rk, rp)]
    plan = plan_trajectory(C, 1, n, d, dtype)
    occ = resident_occupancy(dtype, "logistic", True, n, d, plan.cluster)
    out = dict(
        shape=f"C={C} n={n} d={d} steps={steps} {str(dtype)[6:]}",
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(kernel, device), plain_ms=device_ms(plain, device),
        bound=bound_ms(nbytes(x, y, mask, w0, u, invn, wk, rk),
                       {dtype: C * n * d * (4 * steps + 2)}),
        rerun_equal=all(map(torch.equal, kernel(), (wk, rk))),
        plan=dict(design=plan.design, cluster=plan.cluster,
                  rows_per_block=plan.rows_per_block,
                  shared_bytes=occ["shared_bytes"],
                  active_clusters=occ["active_clusters"]),
        designs=designs)
    print(f"  trajectory at {label} [{out['shape']}]: plan {out['plan']}, "
          f"launches by design {designs}; rel {out['rel']:.3e} abs "
          f"{out['abs']:.3e}  kernel {out['ms']:.4f} ms  plain "
          f"{out['plain_ms']:.4f} ms  bound {out['bound'][0]:.5f} ms "
          f"({out['bound'][1]})  launch floor {floor:.4f} ms, rerun "
          f"bit-identical {out['rerun_equal']}", flush=True)
    if designs != {"resident": 1, "streaming": 0} or not out["rerun_equal"]:
        raise AssertionError(f"trajectory at {label}: designs {designs}, "
                             f"rerun equal {out['rerun_equal']}")
    if not out["rel"] <= TOLERANCE[dtype]:
        raise AssertionError(f"trajectory at {label} disagrees with its plain "
                             f"version: {out['rel']:.3e} > {TOLERANCE[dtype]:.0e}")
    return out


def ext_cohort(device, floor: float) -> dict:
    """Phase 4d: the reference's ext_cohort point by the engine, a cohort
    of EXT_COHORT_C against the dense round at each of EXT_COHORT_KS: ms a
    round over EXT_COHORT_REPLAYS replayed chunks after the 8-round run
    (host clock, each ending in its read), the run's peak memory
    (``max_memory_allocated``, the data included; capture included), the
    launches a slot, and the global (all-K, data-weighted) loss after the
    run. Gate: at the largest K the cohort run's global loss ends below
    EXT_COHORT_LOSS_SHARE of its initial value. ``trajectory`` at the
    cohort's shape is held against its plain version."""
    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  make_round_fn, run_rounds)
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    rows = {}
    for K in EXT_COHORT_KS:
        X, y = make_binary_classification("synthetic_small",
                                          n=max(2048, 8 * K), seed=0)
        clients = partition(X, y, K, "iid", seed=0, device=device)
        prob = make_logreg_problem(clients, 1e-3, device=device)
        data_mib = nbytes(clients.x, clients.y, clients.mask) / 2 ** 20
        for mode, csize in (("cohort", EXT_COHORT_C), ("dense", None)):
            hp = AlgoHParams(eta=0.5, local_epochs=2, cohort_size=csize)
            round_fn = make_round_fn("fedosaa_svrg", prob, hp, device=device)
            state = init_state(prob, device=device)
            loss0 = float(prob.global_loss(state.params))
            runner = make_chunk_runner(round_fn, EXT_COHORT_CHUNK)
            base = memory_mark(device)
            _build.reset_launches()
            state, trace = run_rounds(round_fn, state, EXT_COHORT_ROUNDS,
                                      chunk=EXT_COHORT_CHUNK, runner=runner)
            peak = torch.cuda.max_memory_allocated(device) - base
            counted = engine_launches(f"ext_cohort K={K} {mode}",
                                      trace.num_rounds, EXT_COHORT_CHUNK,
                                      int8=False)
            loss = float(prob.global_loss(state.params))
            walls = []
            for _ in range(EXT_COHORT_REPLAYS):
                t0 = time.perf_counter()
                runner(state, EXT_COHORT_CHUNK)
                walls.append(time.perf_counter() - t0)
            ms = float(np.median(walls)) / EXT_COHORT_CHUNK * 1e3
            # one round by the loop, after a warm-up round: its own
            # temporaries, with no capture stream of its own
            st, _ = round_fn(init_state(prob, device=device))
            base_round = memory_mark(device)
            round_fn(st)
            round_peak = torch.cuda.max_memory_allocated(device) - base_round
            rows[f"K={K}/{mode}"] = r = dict(
                num_clients=K, cohort=csize, rows_per_client=clients.x.shape[1],
                ms_per_round=ms, chunk_ms=[w * 1e3 for w in walls],
                capture_ms=runner.capture_ms, peak_above_mib=peak / 2 ** 20,
                base_mib=base / 2 ** 20, data_mib=data_mib, loss0=loss0,
                loss=loss, round_peak_above_mib=round_peak / 2 ** 20,
                launches=counted["launches"],
                trace_loss_finite=bool(np.all(np.isfinite(trace.loss))))
            print(f"  ext_cohort K={K:5d} {mode:6s} (C="
                  f"{csize or K}, {r['rows_per_client']} rows a client): "
                  f"{ms:.3f} ms/round (chunk ms "
                  f"{', '.join(f'{w:.2f}' for w in r['chunk_ms'])}), capture "
                  f"{runner.capture_ms:.1f} ms, peak {r['peak_above_mib']:.2f} "
                  f"MiB above the {r['base_mib']:.1f} MiB held before (its data "
                  f"{data_mib:.2f} MiB; one loop round's peak "
                  f"{r['round_peak_above_mib']:.3f} MiB above its start), "
                  f"global loss {loss0:.6f} -> "
                  f"{loss:.6f} after {trace.num_rounds} rounds, launches "
                  f"{ {k: v for k, v in counted['launches'].items() if v} }",
                  flush=True)
            if not r["trace_loss_finite"]:
                raise AssertionError(f"ext_cohort K={K} {mode}: a non-finite "
                                     f"round loss")
            del runner, state, round_fn, st
            free_memory()
        del prob, clients
        free_memory()
    top = rows[f"K={EXT_COHORT_KS[-1]}/cohort"]
    if not top["loss"] < EXT_COHORT_LOSS_SHARE * top["loss0"]:
        raise AssertionError(f"ext_cohort K={EXT_COHORT_KS[-1]}, C="
                             f"{EXT_COHORT_C}: global loss {top['loss']} not "
                             f"below {EXT_COHORT_LOSS_SHARE} x {top['loss0']}")
    X, y = make_binary_classification("synthetic_small",
                                      n=8 * EXT_COHORT_KS[-1], seed=0)
    clients = partition(X, y, EXT_COHORT_KS[-1], "iid", seed=0, device=device)
    idx = torch.arange(EXT_COHORT_C, device=device)
    traj = trajectory_at(
        f"the ext_cohort point (K={EXT_COHORT_KS[-1]}, C={EXT_COHORT_C})",
        *(t.index_select(0, idx) for t in (clients.x, clients.y,
                                           clients.mask)),
        torch.float32, device, floor, steps=3, eta=0.5)
    return dict(rows=rows, trajectory=traj)


def cohorts(clients, w_star, device, floor: float, dense: dict,
            traj_dense: dict) -> dict:
    """Phase 4d: cohorts. Each COHORT_RUNS run at paper scale in float64 at
    participation COHORT_PARTICIPATION, by the loop and by the engine
    (``loop_and_engine_run``: launches a round as the dense run's, since
    each kernel takes the cohort's clients in one launch; engine = loop in
    every row and the whole K-sized store; one host read a chunk; a
    warmed-up round, the cohort draw included, makes no host read), and
    the rows of clients never drawn bit-equal to their initial values
    (``frozen_rows``); each printed beside its dense run of phases 4, 4b
    and 4c (``dense``). Then ``trajectory`` at a cohort's shape beside the
    dense shape's time (``traj_dense``), and the ext_cohort point."""
    from repro_torch.core import AlgoHParams, resolve_cohort_size
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    C = resolve_cohort_size(AlgoHParams(participation=COHORT_PARTICIPATION),
                            K_MAIN)
    runs = {name: loop_and_engine_run(
        prob, name, algo, {**knobs, "participation": COHORT_PARTICIPATION},
        channel, w_star, device, state_gate=frozen_rows,
        keep=name in SHARD_COHORT_RUNS)
        for name, algo, knobs, channel in COHORT_RUNS}
    for name, r in runs.items():
        d = dense[COHORT_DENSE[name]]
        print(f"  {name} (C={C} of K={K_MAIN}) against its dense run "
              f"{COHORT_DENSE[name]}: loop {r['ms_per_round']:.3f} / "
              f"{d['ms_per_round']:.3f} ms a round, engine "
              f"{r['engine']['ms_per_round']:.3f} / "
              f"{d['engine']['ms_per_round']:.3f}, rel-error after 10 rounds "
              f"{r['rel_error']:.3e} / {d['rel_error']:.3e}, engine peak above "
              f"its start {r['engine']['peak_above_mib']:.1f} / "
              f"{d['engine'].get('peak_above_mib', float('nan')):.1f} MiB",
              flush=True)
    idx = torch.arange(C, device=device) * (K_MAIN // C)
    traj = trajectory_at(f"paper scale, C={C}",
                         *(t.index_select(0, idx) for t in (
                             clients.x, clients.y, clients.mask)),
                         torch.float64, device, floor, steps=L_EPOCHS + 1,
                         eta=ETA)
    print(f"  trajectory at C={C}: {traj['ms']:.4f} ms against "
          f"{traj_dense['ms']:.4f} ms at K={K_MAIN} (plan "
          f"{traj_dense['plan']})", flush=True)
    return dict(cohort_size=C, runs=runs, trajectory=traj,
                ext_cohort=ext_cohort(device, floor))


def rounds_to(curve, target: float):
    """The first round (counted from 1) whose rel-error is below target."""
    hit = np.nonzero(np.asarray(curve) < target)[0]
    return int(hit[0]) + 1 if len(hit) else None


def acceptance_problem(device, dtype=torch.float64):
    """The acceptance configuration's data (covtype n=10,000, K=10 iid,
    gamma=1e-3) as a logistic problem in ``dtype``."""
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem

    X, y = make_binary_classification("covtype", n=10_000, seed=0)
    clients = partition(X, y, 10, "iid", seed=0, device=device)
    return make_logreg_problem(clients, GAMMA, dtype=dtype, device=device)


def robust_run(prob, w_star, hp, cap: int, device, channel=None,
               chunk: int = ROBUST_CHUNK, **robust) -> dict:
    """One FedOSAA-SVRG run of phase 4e by the engine (stopping at
    rel-error ROBUST_STOP): its curves, rounds to ROBUST_TARGET and
    ROBUST_FAIL, finiteness and median ms a round after its first chunk."""
    from repro_torch.core import run_federated

    h = run_federated(prob, "fedosaa_svrg", hp, cap, w_star=w_star,
                      stop_rel_error=ROBUST_STOP, device=device,
                      channel=channel, chunk=chunk, **robust)
    ms = per_round_ms(h.wall_time)
    return dict(rounds=len(h.rounds), to_target=rounds_to(h.rel_error,
                                                          ROBUST_TARGET),
                to_fail=rounds_to(h.rel_error, ROBUST_FAIL),
                finite=bool(np.isfinite(h.loss).all()),
                loss=[float(v) for v in h.loss],
                rel=[float(v) for v in h.rel_error],
                arrivals=[float(v) for v in h.arrivals],
                ms_per_round=(float(np.median(ms[chunk:])) if len(ms) > chunk
                              else None))


def ext_robustness(device) -> dict:
    """Phase 4e: the reference's ext_robustness quick matrix by the engine
    (ROBUST_PLANS x {identity, int8} x clip_rtol {0, 1e-3}), each row's
    rounds to 1e-6 printed beside the committed one. Gates: clean runs
    bit-identical with the screen on and off (each wire); the defended
    history run within ROBUST_DEFENDED_RATIO x the port's own clean rounds;
    the undefended float64 history run finite (the contract finding, see
    ROBUST_F32_ROUNDS) and, in float32 on the same data, the undefended run
    non-finite while the defended one stays finite and falls; two runs of
    ROBUST_DET_PLAN bit-identical."""
    from repro_torch.core import AAConfig, AlgoHParams, solve_reference
    from repro_torch.robust import FaultPlan

    prob = acceptance_problem(device)
    w_star = solve_reference(prob, iters=100)
    committed = {r["name"]: r for r in json.loads(
        (ROOT / "benchmarks/results/ext_robustness.json").read_text())}
    hps = {d: AlgoHParams(eta=ETA, local_epochs=L_EPOCHS,
                          aa=AAConfig(clip_rtol=c))
           for d, c in (("off", 0.0), ("on", ROBUST_CLIP))}
    rows = {}
    t0 = time.perf_counter()
    for cname, channel in (("identity", None), ("int8", "int8")):
        for fname, kw in ROBUST_PLANS:
            for dname, hp in hps.items():
                name = f"ext_robustness/{cname}/{fname}/{dname}"
                r = rows[name] = robust_run(
                    prob, w_star, hp, ROBUST_CAP, device, channel,
                    faults=FaultPlan(**kw) if kw else None)
                r["committed_to_target"] = committed[name]["rounds_to_target"]
                print(f"  {name:38s} rounds to 1e-6: {r['to_target']} "
                      f"(committed {r['committed_to_target']}), to 1e-4: "
                      f"{r['to_fail']}, rounds run {r['rounds']}, finite "
                      f"{r['finite']}, final rel-error {r['rel'][-1]:.3e}, "
                      f"{r['ms_per_round'] or float('nan'):.3f} ms/round",
                      flush=True)
    matrix_s = time.perf_counter() - t0
    for cname in ("identity", "int8"):
        a, b = (rows[f"ext_robustness/{cname}/clean/{d}"]["loss"]
                for d in ("off", "on"))
        if a != b:
            raise AssertionError(f"{cname}: the clean run differs with the "
                                 f"clip_rtol screen on: {a} / {b}")
    clean = rows["ext_robustness/identity/clean/off"]["to_target"]
    dfd = rows["ext_robustness/identity/history/on"]
    und = rows["ext_robustness/identity/history/off"]
    ratio = (dfd["to_target"] / clean if dfd["to_target"] and clean
             else None)
    if ratio is None or ratio > ROBUST_DEFENDED_RATIO:
        raise AssertionError(f"defended history: {dfd['to_target']} rounds "
                             f"to 1e-6 against the clean {clean} (ratio "
                             f"{ratio}, limit {ROBUST_DEFENDED_RATIO})")
    to_fail, to_target = REFERENCE_F64_HISTORY
    if not (und["finite"] and und["to_fail"] is not None
            and abs(und["to_fail"] - to_fail) <= 1
            and und["to_target"] is not None
            and abs(und["to_target"] - to_target) <= 1):
        raise AssertionError(
            f"the undefended float64 history run: finite {und['finite']}, "
            f"rounds to 1e-4 / 1e-6 {und['to_fail']} / {und['to_target']}, "
            f"against the f64-accumulating reference's {to_fail} / "
            f"{to_target} (within one)")
    # the attack landing: float32, as the reference's f32 accumulation
    p32 = acceptance_problem(device, torch.float32)
    f32 = {d: robust_run(p32, w_star.to(torch.float32), hp, ROBUST_F32_ROUNDS,
                         device, faults=FaultPlan(**dict(ROBUST_PLANS)["history"]))
           for d, hp in hps.items()}
    if f32["off"]["finite"] or not (f32["on"]["finite"] and
                                    f32["on"]["loss"][-1] < f32["on"]["loss"][0]):
        raise AssertionError(f"float32 history pair: undefended finite "
                             f"{f32['off']['finite']} (must not be), "
                             f"defended {f32['on']['loss']}")
    det = [robust_run(prob, w_star, hps["on"], 6, device,
                      faults=FaultPlan(**ROBUST_DET_PLAN)) for _ in range(2)]
    if det[0]["loss"] != det[1]["loss"]:
        raise AssertionError(f"determinism plan: two runs differ: "
                             f"{det[0]['loss']} / {det[1]['loss']}")
    summary = dict(
        clean_defense_parity_bitwise=True, clean_rounds_to_target=clean,
        defended_rounds_to_target=dfd["to_target"],
        defended_rounds_vs_clean=ratio,
        undefended_f64_finite=und["finite"],
        undefended_f64_rounds_to_1e4=und["to_fail"],
        undefended_f32_finite=f32["off"]["finite"],
        defended_f32_loss=f32["on"]["loss"],
        fault_determinism_bit_identical=True, matrix_s=matrix_s)
    print("  ext_robustness summary " + json.dumps(summary), flush=True)
    return dict(rows={k: {f: v for f, v in r.items() if f not in ("loss",)}
                      for k, r in rows.items()}, summary=summary)


def ext_async(device) -> dict:
    """Phase 4e: the reference's ext_async quick configuration by the
    engine: barriered without and with the latency plan, deadline-gated
    with the history guard on and off. Gates: the gated run reaches 1e-6
    within ASYNC_ROUND_MULTIPLE x the barriered run's rounds, and its
    simulated wall to target (each round's effective deadline) is strictly
    below the barriered run's (each round's slowest latency), replayed on
    the host from the port's own latency draws (the round's
    ``fill_draws``, the same generator calls); AsyncConfig() bit-identical
    to no config; two gated runs of ASYNC_DET_PLAN (latency and dropout)
    bit-identical."""
    from repro_torch.core import AlgoHParams, make_round_fn, solve_reference
    from repro_torch.robust import AsyncConfig, FaultPlan, plan_async, realize
    from repro_torch.robust.faults import LATENCY

    prob = acceptance_problem(device)
    w_star = solve_reference(prob, iters=100)
    K = prob.clients.num_clients
    committed = {r["name"]: r for r in json.loads(
        (ROOT / "benchmarks/results/ext_async.json").read_text())}
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    plan = FaultPlan(seed=0, **ASYNC_LATENCY)
    gate = AsyncConfig(**ASYNC_GATE)
    noguard = dataclasses.replace(gate, guard_history=False)
    runs = {}
    for name, robust in (("sync/clean", {}), ("sync/latency", dict(faults=plan)),
                         ("gated/guard", dict(faults=plan, async_cfg=gate)),
                         ("gated/noguard", dict(faults=plan,
                                                async_cfg=noguard))):
        r = runs[name] = robust_run(prob, w_star, hp, ASYNC_CAP, device,
                                    **robust)
        r["committed_to_target"] = committed[f"ext_async/{name}"][
            "rounds_to_target"]
        print(f"  ext_async/{name:14s} rounds to 1e-6: {r['to_target']} "
              f"(committed {r['committed_to_target']}), rounds run "
              f"{r['rounds']}, arrivals {r['arrivals'][:8]}..., "
              f"{r['ms_per_round'] or float('nan'):.3f} ms/round", flush=True)
    r_sync = runs["sync/latency"]["to_target"]
    r_gated = runs["gated/guard"]["to_target"]
    if not (r_sync and r_gated and r_gated <= ASYNC_ROUND_MULTIPLE * r_sync):
        raise AssertionError(f"gated {r_gated} rounds against barriered "
                             f"{r_sync} (limit x{ASYNC_ROUND_MULTIPLE})")
    # the wall-clock replay from the round's own latency draws
    horizon = max(r_sync, r_gated)
    rf = make_round_fn("fedosaa_svrg", prob, hp, device=device, faults=plan,
                       async_cfg=gate)
    bufs = {LATENCY: torch.empty((horizon, K), device=device)}
    rf.fill_draws(bufs, 0)
    ids = torch.arange(K)
    barrier, gated = [], []
    for z in bufs[LATENCY].cpu():
        lat = realize(plan, {LATENCY: z}, ids).latency
        barrier.append(float(lat.max()))
        gated.append(float(plan_async(gate, lat, torch.zeros(K, dtype=torch.int32),
                                      torch.full((K,), 1.0 / K)).deadline))
    wall_sync, wall_gated = sum(barrier[:r_sync]), sum(gated[:r_gated])
    if not wall_gated < wall_sync:
        raise AssertionError(f"gated simulated wall {wall_gated} is not below "
                             f"the barriered {wall_sync}")
    base, off = (robust_run(prob, w_star, hp, 6, device, **kw)
                 for kw in ({}, dict(async_cfg=AsyncConfig())))
    det = [robust_run(prob, w_star, hp, 6, device,
                      faults=FaultPlan(**ASYNC_DET_PLAN), async_cfg=gate)
           for _ in range(2)]
    if base["loss"] != off["loss"]:
        raise AssertionError("AsyncConfig() differs from no config")
    if det[0]["loss"] != det[1]["loss"] or det[0]["arrivals"] != det[1]["arrivals"]:
        raise AssertionError("two gated runs of the latency+dropout plan differ")
    summary = dict(
        gated_rounds_vs_barriered=r_gated / r_sync,
        barriered_rounds_to_target=r_sync, gated_rounds_to_target=r_gated,
        noguard_rounds_to_target=runs["gated/noguard"]["to_target"],
        barriered_sim_wall_to_target=wall_sync,
        gated_sim_wall_to_target=wall_gated,
        gated_wall_below_barriered=True, inactive_parity_bitwise=True,
        repeat_bit_identical=True)
    print("  ext_async summary " + json.dumps(summary), flush=True)
    return dict(runs=runs, summary=summary)


def robust_paper(clients, w_star, device, dense: dict) -> dict:
    """Phase 4e at paper scale: each ROBUST_RUNS run by the loop and by the
    engine (``loop_and_engine_run``: launches a round as the clean run's,
    the faults adding only torch ops; engine = loop in every row and the
    whole state, the anchor rows, buffer rows and ages included; one host
    read a chunk; a warmed-up round, its fault draws included, makes no
    host read), the cohort run's never-drawn rows frozen; each printed
    beside its clean run of phases 4-4d (``dense``; one with the run's
    knobs is made here where none has them): engine ms a round, capture
    ms, peak memory."""
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.robust import AsyncConfig, FaultPlan

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    out = {}
    for name, algo, knobs, channel, plan, gate, clean in ROBUST_RUNS:
        robust = dict(faults=FaultPlan(**plan),
                      async_cfg=AsyncConfig(**gate) if gate else None)
        r = out[name] = loop_and_engine_run(
            prob, name, algo, knobs, channel, w_star, device,
            state_gate=frozen_rows if "participation" in knobs else None,
            robust=robust)
        d = dense.get(clean) or out.get(clean)
        if d is None:
            d = out[clean] = loop_and_engine_run(
                prob, clean, algo, knobs, channel, w_star, device,
                state_gate=frozen_rows if "participation" in knobs else None)
        # phase 4's runs record the engine's absolute peak, the others the
        # peak above the run's start
        peak = (f"{d['engine']['peak_above_mib']:.1f} MiB"
                if "peak_above_mib" in d["engine"] else
                f"(phase 4: {d['engine']['peak_mib']:.1f} MiB absolute)")
        print(f"  {name} against its clean run {clean}: engine "
              f"{r['engine']['ms_per_round']:.3f} / "
              f"{d['engine']['ms_per_round']:.3f} ms a round, loop "
              f"{r['ms_per_round']:.3f} / {d['ms_per_round']:.3f}, capture "
              f"{r['engine']['capture_ms']:.1f} / "
              f"{d['engine']['capture_ms']:.1f} ms, engine peak above its "
              f"start {r['engine']['peak_above_mib']:.1f} MiB / {peak}, "
              f"rel-error after 10 rounds {r['rel_error']:.3e} / "
              f"{d['rel_error']:.3e}", flush=True)
        r["clean_run"] = clean
    return out


#: phase 4f, checkpoint and resume (repro_torch/checkpoint): the reference
#: test's adversarial case (tests/test_checkpoint_preempt.py: int8, two
#: carried AA columns, its LATENCY_PLAN and GATE) at paper scale (float64,
#: FedOSAA-SVRG, eta=1, L=10), 10 rounds, engine chunks of 2, a save every 2
#: rounds (keep all); the kill lands in save 2 (round 4) after its first
#: write, so only round 2 commits
CKPT_ROUNDS, CKPT_CHUNK = 10, 2
CKPT_LATENCY = dict(seed=5, latency_scale=1.0, latency_shape=1.5)
CKPT_GATE = dict(deadline=2.0, min_arrivals=2, staleness_alpha=0.5)
CKPT_KILL = dict(kill_at_save=2, kill_after_writes=1)
#: the reference's ext_checkpoint quick setup (benchmarks/ext_checkpoint.py):
#: synthetic covtype n=20,000, K=32 iid, gamma=1e-3, float32, FedOSAA-SVRG
#: on int8, eta=1, L=10, carry 2, AAConfig(tikhonov=1e-6, damping=0.7), 42
#: rounds in chunks of 6, a save at every chunk (keep all); each mode best
#: of 2 by its median chunk wall; its async overhead budget
EXT_CKPT_N, EXT_CKPT_K, EXT_CKPT_ROUNDS, EXT_CKPT_CHUNK = 20_000, 32, 42, 6
EXT_CKPT_MODES, EXT_CKPT_REPS, OVERHEAD_BUDGET = (
    (None, "async", "sync", "sync_gather"), 2, 0.10)


def strict_saves(policy):
    """A CheckpointManager of ``policy`` whose ``maybe_save`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing CUDA call
    in it raises and fails the run. ``dispatched`` counts its saves."""
    from repro_torch.checkpoint import CheckpointManager

    class StrictSaves(CheckpointManager):
        dispatched = 0

        def maybe_save(self, state, round_idx, chunk_wall=None):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                saved = super().maybe_save(state, round_idx, chunk_wall)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.dispatched += saved
            return saved

    return StrictSaves(policy)


class EmitClock:
    """A MetricsSink that stamps the host clock at each chunk's emit (right
    after the chunk's read): the gaps are the chunk walls from boundary to
    boundary, the previous boundary's save included."""

    def __init__(self):
        self.stamps = []

    def open(self, header):
        pass

    def emit(self, rows):
        self.stamps.append(time.perf_counter())

    def close(self, footer):
        pass


def same_rows(what: str, rows, want) -> None:
    """Raise unless two lists of telemetry rows hold the same values in
    every field but the wall times and the cumulative bytes (a resumed run
    counts its own), nan (or a JSON null) where nan."""
    from repro_torch.obs import ROW_FIELDS

    fields = ("round",) + tuple(
        f for f in ROW_FIELDS
        if f not in ("round_wall_s", "wall_time_s", "comm_bytes_total"))
    a, b = (np.array([[np.nan if r[f] is None else r[f] for f in fields]
                      for r in rs], dtype=np.float64) for rs in (rows, want))
    if a.shape != b.shape:
        raise AssertionError(f"{what}: {len(a)} rows against {len(b)}")
    bad = [f for j, f in enumerate(fields)
           if not np.array_equal(a[:, j], b[:, j], equal_nan=True)]
    if bad:
        raise AssertionError(f"{what}: the rows differ in {bad}")


def ckpt_config(prob, cohort: bool) -> dict:
    """run_federated's keywords of a phase-4f run (less the problem's)."""
    from repro_torch.core import AlgoHParams
    from repro_torch.robust import AsyncConfig, FaultPlan

    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS, carry_history=2,
                     participation=COHORT_PARTICIPATION if cohort else 1.0)
    return dict(problem=prob, algo="fedosaa_svrg", hp=hp,
                num_rounds=CKPT_ROUNDS, channel="int8",
                faults=FaultPlan(**CKPT_LATENCY),
                async_cfg=AsyncConfig(**CKPT_GATE))


def straight_run(kw: dict, w_star, device) -> dict:
    """The run never killed: its History and rows by the engine, and its
    final state by ``run_rounds`` from the same start (the state the resumed
    run must end in), with the round function and that start."""
    from repro_torch.core import make_round_fn, run_federated, run_rounds
    from repro_torch.obs import MemorySink

    sink = MemorySink()
    h = run_federated(**kw, w_star=w_star, device=device, chunk=CKPT_CHUNK,
                      sinks=[sink])
    round_fn = make_round_fn(kw["algo"], kw["problem"], kw["hp"],
                             kw["channel"], device=device, faults=kw["faults"],
                             async_cfg=kw["async_cfg"])
    robust = dict(faults=kw["faults"], async_cfg=kw["async_cfg"])
    s0 = start_state(kw["problem"], kw["algo"], kw["hp"], kw["channel"],
                     device, robust)
    state, _ = run_rounds(round_fn, s0, CKPT_ROUNDS, chunk=CKPT_CHUNK,
                          w_star=w_star)
    return dict(h=h, sink=sink, state=state, round_fn=round_fn, s0=s0,
                robust=robust)


def kill_and_resume(name: str, kw: dict, straight: dict, w_star, device,
                    save_chunk, mode: str, state_gate=None) -> dict:
    """Phase 4f (a)/(b): a run whose save 2 dies after its first write (on
    ``save_chunk``'s path, in ``mode``), then ``resume="auto"`` by the
    engine. Gates: only round 2 committed beside a ``.tmp-*`` remnant; the
    resumed run starts at 2, its rows 2..9 and History equal the straight
    run's, its launches are a clean run's for its slots; its last
    checkpoint (round 10) equals the straight run's final state in every
    tensor (``same_state``) and ``t``; ``state_gate(round_fn, start,
    final)`` holds it to more."""
    import tempfile

    from repro_torch.checkpoint import (CheckpointPolicy, list_checkpoints,
                                        load_checkpoint)
    from repro_torch.core import run_federated
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink
    from repro_torch.robust import FaultyFs, FSFaultPlan

    d = tempfile.mkdtemp(prefix=f"ckpt_{name}_")
    pol = CheckpointPolicy(directory=d, every=CKPT_CHUNK, keep=0, mode=mode)
    t0 = time.perf_counter()
    run_federated(**kw, w_star=w_star, device=device, chunk=save_chunk,
                  checkpoint=pol, checkpoint_fs=FaultyFs(FSFaultPlan(**CKPT_KILL)))
    committed = [r for r, _ in list_checkpoints(d)]
    remnants = [n for n in os.listdir(d) if n.startswith(".tmp-")]
    if committed != [CKPT_CHUNK] or not remnants:
        raise AssertionError(f"{name}: after the kill {committed} committed, "
                             f"remnants {remnants}; expected [2] and a .tmp-*")
    killed_s = time.perf_counter() - t0
    sink = MemorySink()
    _build.reset_launches()
    t0 = time.perf_counter()
    h = run_federated(**kw, w_star=w_star, device=device, chunk=CKPT_CHUNK,
                      checkpoint=pol, resume="auto", sinks=[sink])
    resumed_s = time.perf_counter() - t0
    counted = engine_launches(f"{name} resumed", len(h.rounds), CKPT_CHUNK,
                              int8=True)
    rounds = list(range(CKPT_CHUNK, CKPT_ROUNDS))
    if (sink.header["start_round"] != CKPT_CHUNK
            or [r["round"] for r in sink.rows] != rounds
            or not np.array_equal(h.rounds, rounds)):
        raise AssertionError(f"{name}: resumed at {sink.header['start_round']}"
                             f", rows {[r['round'] for r in sink.rows]}")
    same_rows(f"{name} resumed", sink.rows, straight["sink"].rows[CKPT_CHUNK:])
    s = straight["h"]
    for f in ("loss", "grad_norm", "rel_error", "arrivals", "staleness_mean",
              "staleness_max"):
        if not np.array_equal(getattr(h, f), getattr(s, f)[CKPT_CHUNK:],
                              equal_nan=True):
            raise AssertionError(f"{name}: resumed {f} differs")
    final, manifest = load_checkpoint(
        os.path.join(d, f"ckpt_{CKPT_ROUNDS:08d}"), straight["s0"])
    same_state(f"{name} resumed final state", straight["state"], final)
    if final.t != CKPT_ROUNDS or not torch.equal(h.final_params,
                                                 straight["state"].params):
        raise AssertionError(f"{name}: final t {final.t}, params equal "
                             f"{torch.equal(h.final_params, straight['state'].params)}")
    gated = (state_gate(straight["round_fn"], straight["s0"], final)
             if state_gate else None)
    out = dict(committed_after_kill=committed, remnants=len(remnants),
               resumed_rows=len(sink.rows), footer={
                   k: v for k, v in sink.footer.items()
                   if k.startswith("checkpoint")},
               inventory=manifest["inventory"], killed_run_s=killed_s,
               resumed_run_s=resumed_s, gated=gated, **counted)
    print(f"  {name}: killed in save 2 ({mode}, "
          f"{'loop' if save_chunk is None else f'engine chunk={save_chunk}'}"
          f"): committed {committed}, {len(remnants)} .tmp-* remnant; "
          f"resume='auto' by the engine from round {sink.header['start_round']}"
          f": rows {rounds[0]}..{rounds[-1]}, loss, grad_norm, rel_error and "
          f"the final state (params, comm {sorted(final.comm)}, history, "
          f"t={final.t}) equal the straight run bit for bit; launches "
          f"{ {k: v for k, v in counted['launches'].items() if v} } over "
          f"{counted['slots']} slots; footer {out['footer']}"
          f"{'' if gated is None else f'; {gated}'}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return out


def checkpoint_child(argv: list) -> int:
    """Phase 4f (c)'s child process: ``--checkpoint-child kill|resume <dir>
    <rows.jsonl> <w_star.npy> <device>``. The paper-scale data, the dense phase-4f
    run by the engine in ``async`` mode saving into <dir>, its rows streamed
    to <rows.jsonl>; ``kill``: save 2 ends the process with
    os._exit(KILL_EXIT_CODE) from the writer thread; ``resume``:
    ``resume="auto"`` from <dir>."""
    from repro_torch.checkpoint import CheckpointPolicy
    from repro_torch.core import run_federated
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import JsonlSink
    from repro_torch.robust import FaultyFs, FSFaultPlan

    what, d, rows_path, w_path, device = argv
    device = torch.device(device)
    _build.library()
    X, y = make_binary_classification("covtype", n=N_PAPER, seed=0)
    clients = partition(X, y, K_MAIN, "iid", seed=0, device=device)
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64,
                               device=device)
    w_star = torch.from_numpy(np.load(w_path)).to(device)
    pol = CheckpointPolicy(directory=d, every=CKPT_CHUNK, keep=0, mode="async")
    extra = (dict(checkpoint_fs=FaultyFs(FSFaultPlan(**CKPT_KILL,
                                                     kill_hard=True)))
             if what == "kill" else dict(resume="auto"))
    run_federated(**ckpt_config(prob, cohort=False), w_star=w_star,
                  device=device, chunk=CKPT_CHUNK, checkpoint=pol,
                  sinks=[JsonlSink(rows_path)], **extra)
    return 0


def read_rows(path: str) -> tuple[dict, list]:
    """(header, round rows) of a JsonlSink file; a torn last line (the
    process may die while it writes) is dropped."""
    with open(path) as f:
        lines = [line for line in f if line.strip()]
    objs = []
    for i, line in enumerate(lines):
        try:
            objs.append(json.loads(line))
        except ValueError:
            if i != len(lines) - 1:
                raise
    return objs[0], [o for o in objs if o.get("kind") == "round"]


def real_death(straight: dict, w_star, device) -> dict:
    """Phase 4f (c): a child process on the card, killed by the fault
    harness's hard kill inside save 2 (``os._exit`` from the writer thread
    while the next chunk runs), must exit with KILL_EXIT_CODE; a second
    child resumes with ``"auto"``; the first's rows before the resume round
    and the second's join into the straight run's rows bit for bit (the
    first's rows past the resume round, where it got that far, equal them
    too). The children's output is captured and summarized."""
    import tempfile

    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.robust import KILL_EXIT_CODE

    tmp = tempfile.mkdtemp(prefix="ckpt_death_")
    d = os.path.join(tmp, "ckpt")
    w_path = os.path.join(tmp, "w_star.npy")
    np.save(w_path, w_star.cpu().numpy())
    out = {}
    for what, want_rc in (("kill", KILL_EXIT_CODE), ("resume", 0)):
        rows_path = os.path.join(tmp, f"{what}.jsonl")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--checkpoint-child", what, d, rows_path,
                              w_path, str(device)], capture_output=True,
                             text=True,
                             timeout=300, cwd=str(ROOT))
        secs = time.perf_counter() - t0
        tail = (res.stdout + res.stderr).strip().splitlines()[-3:]
        header, rows = read_rows(rows_path)
        out[what] = dict(rc=res.returncode, seconds=secs, rows=len(rows),
                         start_round=header["start_round"],
                         committed=[r for r, _ in list_checkpoints(d)])
        print(f"  child {what}: exit {res.returncode} in {secs:.1f} s, "
              f"{len(rows)} rows from round {header['start_round']}, "
              f"committed {out[what]['committed']}; its output's last lines: "
              f"{tail}", flush=True)
        if res.returncode != want_rc:
            raise AssertionError(f"child {what} exited {res.returncode}, "
                                 f"expected {want_rc}: {tail}")
        out[what]["rows_list"] = rows
    first, second = out["kill"].pop("rows_list"), out["resume"].pop("rows_list")
    want = straight["sink"].rows
    if out["kill"]["committed"] != [CKPT_CHUNK]:
        raise AssertionError(f"the killed child committed "
                             f"{out['kill']['committed']}, expected [2]")
    if out["resume"]["start_round"] != CKPT_CHUNK:
        raise AssertionError("the resumed child did not start at round 2")
    joined = [r for r in first if r["round"] < CKPT_CHUNK] + second
    same_rows("the killed and the resumed child's rows", joined, want)
    same_rows("the killed child's rows", first, want[:len(first)])
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  the two segments' rows (rounds 0..{CKPT_CHUNK - 1} of the "
          f"killed child, {CKPT_CHUNK}..{CKPT_ROUNDS - 1} of the resumed one) "
          f"equal the straight run's bit for bit", flush=True)
    return out


def snapshot_gate(prob, w_star, device) -> dict:
    """Phase 4f (d): the dense run by the engine in ``async`` mode with a
    save at every chunk. Gates: every committed checkpoint equals the
    loop's state after its round in every tensor and ``t``, although the
    next replay overwrote the runner's buffers after the snapshot;
    ``maybe_save`` runs under ``set_sync_debug_mode("error")``; one
    ``_fetch`` and one host read a chunk (after the first); the launches of
    a run without checkpointing, no failure."""
    import tempfile

    from repro_torch.checkpoint import (CheckpointPolicy, list_checkpoints,
                                        load_checkpoint)
    from repro_torch.core import engine, make_round_fn, run_rounds
    from repro_torch.core.engine import _map_state
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink

    kw = ckpt_config(prob, cohort=False)
    robust = dict(faults=kw["faults"], async_cfg=kw["async_cfg"])
    round_fn = make_round_fn("fedosaa_svrg", prob, kw["hp"], "int8",
                             device=device, **robust)
    st = start_state(prob, "fedosaa_svrg", kw["hp"], "int8", device, robust)
    want = {}
    for r in range(1, CKPT_ROUNDS + 1):
        st, _ = round_fn(st)
        if r % CKPT_CHUNK == 0:
            want[r] = _map_state(torch.clone, st)
    d = tempfile.mkdtemp(prefix="ckpt_snap_")
    mgr = strict_saves(CheckpointPolicy(directory=d, every=CKPT_CHUNK, keep=0,
                                        mode="async"))
    fetch, fetches = engine._fetch, []
    engine._fetch = lambda r: (fetches.append(1), fetch(r))[1]
    s0 = start_state(prob, "fedosaa_svrg", kw["hp"], "int8", device, robust)
    sink = MemorySink()
    _build.reset_launches()
    try:
        with sync_warnings() as caught:
            reads = ChunkReads(caught)
            _, trace = run_rounds(round_fn, s0, CKPT_ROUNDS, chunk=CKPT_CHUNK,
                                  w_star=w_star, sinks=[sink, reads],
                                  checkpoint=mgr)
    finally:
        engine._fetch = fetch
    counted = engine_launches("checkpointed engine run", trace.num_rounds,
                              CKPT_CHUNK, int8=True)
    chunks = CKPT_ROUNDS // CKPT_CHUNK
    if len(fetches) != chunks or any(n != 1 for n in reads.per_chunk[1:]):
        raise AssertionError(f"checkpointed engine run: {len(fetches)} "
                             f"_fetch over {chunks} chunks, host reads per "
                             f"chunk {reads.per_chunk}")
    committed = [r for r, _ in list_checkpoints(d)]
    if (sorted(committed) != sorted(want) or mgr.dispatched != chunks
            or mgr.saves_completed != chunks
            or sink.footer["checkpoint_failures"]):
        raise AssertionError(f"checkpointed engine run: committed {committed}"
                             f", dispatched {mgr.dispatched}, completed "
                             f"{mgr.saves_completed}, footer {sink.footer}")
    for r, path in list_checkpoints(d):
        got, _ = load_checkpoint(path, s0)
        same_state(f"checkpoint of round {r}", want[r], got)
        if got.t != r:
            raise AssertionError(f"checkpoint of round {r} holds t={got.t}")
    shutil.rmtree(d, ignore_errors=True)
    stalls = sum(a["rule"] == "checkpoint_stalled"
                 for a in sink.footer["alarms"])
    print(f"  snapshots: {len(committed)} checkpoints (async, a save every "
          f"chunk of {CKPT_CHUNK}) equal the loop's states after rounds "
          f"{sorted(committed)} bit for bit; maybe_save ran {mgr.dispatched} "
          f"saves under set_sync_debug_mode('error'); _fetch {len(fetches)} "
          f"times over {chunks} chunks, host reads per chunk "
          f"{reads.per_chunk}; launches "
          f"{ {k: v for k, v in counted['launches'].items() if v} } over "
          f"{counted['slots']} slots (a run without checkpointing's); "
          f"{stalls} stalls; footer "
          f"{ {k: v for k, v in sink.footer.items() if k.startswith('checkpoint')} }",
          flush=True)
    return dict(committed=committed, fetches=len(fetches),
                reads_per_chunk=reads.per_chunk, stalls=stalls, **counted)


def save_breakdown(state) -> dict:
    """Host ms of one save's parts, alone (no chunk beside it), on one
    snapshot of ``state`` with its pinned buffers already allocated: the
    snapshot (copies enqueued), its wait, the npz serialization, the sha256
    digests, one fsync'd file write of the payload, one directory fsync,
    and the whole ``write_checkpoint`` (both of those parts, two fsync'd
    files, three directory fsyncs, two renames)."""
    import hashlib
    import io
    import tempfile

    from repro_torch.checkpoint import LOCAL_FS, snapshot_shards, write_checkpoint

    pool = {}
    snapshot_shards(state, pool).wait()
    d = tempfile.mkdtemp(prefix="ckpt_parts_")
    t = [time.perf_counter()]
    snap = snapshot_shards(state, pool)
    t.append(time.perf_counter())
    snap.wait()
    t.append(time.perf_counter())
    arrays = {f"{k}::0": rec["shards"][0][1] for k, rec in snap.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    t.append(time.perf_counter())
    for arr in arrays.values():
        hashlib.sha256(arr.tobytes()).hexdigest()
    t.append(time.perf_counter())
    LOCAL_FS.write_bytes(os.path.join(d, "payload.npz"), payload)
    t.append(time.perf_counter())
    LOCAL_FS.fsync_dir(d)
    t.append(time.perf_counter())
    write_checkpoint(d, snap, 1)
    t.append(time.perf_counter())
    shutil.rmtree(d, ignore_errors=True)
    ms = np.diff(t) * 1e3
    return dict(zip(("snapshot", "wait", "serialize", "sha256", "file_fsync",
                     "dir_fsync", "write_checkpoint"), (float(v) for v in ms)),
                payload_bytes=len(payload))


def ext_checkpoint(device) -> dict:
    """Phase 4f (e): the reference's ext_checkpoint quick setup (without
    w*: no rel-error is read) by the engine, each mode (no checkpointing,
    ``async``, ``sync``, ``sync_gather``) best of EXT_CKPT_REPS by its
    median chunk wall without the first chunk. Two walls: the History's
    (the reference's measure: the runner's call to its read, which leaves
    the boundary's save out) and the boundary-to-boundary one (EmitClock:
    the chunk and the save before it). Gates: the loss curves identical
    across the modes, 7 commits in ``async`` and ``sync``, no failure. The
    async overhead (boundary to boundary, over no checkpointing) is printed
    beside OVERHEAD_BUDGET, not held; then one save's parts."""
    import tempfile

    from repro_torch.checkpoint import CheckpointPolicy, list_checkpoints
    from repro_torch.core import (AAConfig, AlgoHParams, init_state,
                                  run_federated)
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import MemorySink

    X, y = make_binary_classification("covtype", n=EXT_CKPT_N, seed=0)
    clients = partition(X, y, EXT_CKPT_K, "iid", seed=0, device=device)
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float32,
                               device=device)
    hp = AlgoHParams(eta=1.0, local_epochs=10, carry_history=2,
                     aa=AAConfig(tikhonov=1e-6, damping=0.7))
    c = EXT_CKPT_CHUNK

    def one(mode):
        sink, clock = MemorySink(), EmitClock()
        d = tempfile.mkdtemp(prefix="ext_ckpt_") if mode else None
        pol = (CheckpointPolicy(directory=d, every=c, keep=0, mode=mode)
               if mode else None)
        h = run_federated(prob, "fedosaa_svrg", hp, EXT_CKPT_ROUNDS,
                          device=device, channel="int8", chunk=c,
                          sinks=[sink, clock], checkpoint=pol)
        bounds = np.asarray(h.wall_time)[c - 1::c]
        hist_walls = np.diff(np.concatenate([[0.0], bounds]))[1:]
        walls = np.diff(clock.stamps)
        committed = (len(list_checkpoints(d))
                     if mode in ("async", "sync") else None)
        if d:
            shutil.rmtree(d, ignore_errors=True)
        return dict(mode=mode or "none",
                    chunk_wall_ms=float(np.median(walls)) * 1e3,
                    chunk_walls_ms=[float(w) * 1e3 for w in walls],
                    history_chunk_wall_ms=float(np.median(hist_walls)) * 1e3,
                    loss=[float(v) for v in h.loss], committed=committed,
                    stalls=sum(a["rule"] == "checkpoint_stalled"
                               for a in sink.footer["alarms"]),
                    **{k: v for k, v in sink.footer.items()
                       if k.startswith("checkpoint")})

    by = {}
    for mode in EXT_CKPT_MODES:
        runs = [one(mode) for _ in range(EXT_CKPT_REPS)]
        by[mode or "none"] = min(runs, key=lambda r: r["chunk_wall_ms"])
    base = by["none"]
    for r in by.values():
        r["overhead"] = (r["chunk_wall_ms"] - base["chunk_wall_ms"]) \
            / base["chunk_wall_ms"]
        r["history_overhead"] = ((r["history_chunk_wall_ms"]
                                  - base["history_chunk_wall_ms"])
                                 / base["history_chunk_wall_ms"])
        print(f"  ext_checkpoint {r['mode']:11s}: chunk wall (median of "
              f"chunks 2..{EXT_CKPT_ROUNDS // c}) {r['chunk_wall_ms']:.3f} ms "
              f"boundary to boundary, {r['history_chunk_wall_ms']:.3f} ms by "
              f"the History (its save left out); overhead "
              f"{100 * r['overhead']:+.1f}% ({100 * r['history_overhead']:+.1f}"
              f"%); checkpoint_save_ms {r['checkpoint_save_ms']}, bytes "
              f"{r['checkpoint_bytes']}, failures "
              f"{r['checkpoint_failures']}, stalls {r['stalls']}, committed "
              f"{r['committed']}", flush=True)
    bad = [m for m, r in by.items() if r["loss"] != base["loss"]]
    if bad or any(by[m]["committed"] != EXT_CKPT_ROUNDS // c
                  for m in ("async", "sync")) or any(
                      r["checkpoint_failures"] for r in by.values()):
        raise AssertionError(f"ext_checkpoint: loss curves differ in {bad}, "
                             f"commits {[by[m]['committed'] for m in by]}, "
                             f"failures "
                             f"{[r['checkpoint_failures'] for r in by.values()]}")
    state = init_state(prob, device=device, channel="int8",
                       algo="fedosaa_svrg", hp=hp)
    parts = min((save_breakdown(state) for _ in range(5)),
                key=lambda p: p["write_checkpoint"])
    print(f"  async overhead {100 * by['async']['overhead']:+.1f}% against the "
          f"reference's budget {100 * OVERHEAD_BUDGET:.0f}% (recorded, not "
          f"held); loss curves identical across the four modes; one save's "
          f"parts (host ms, best of 5): "
          f"{ {k: round(v, 4) for k, v in parts.items()} }", flush=True)
    return dict(modes={m: {k: v for k, v in r.items() if k != "loss"}
                       for m, r in by.items()}, save_parts=parts)


def checkpoint_resume(clients, w_star, device) -> dict:
    """Phase 4f: checkpoint and resume (see the module docstring): (a) kill
    and resume at paper scale, saved by the engine and by the loop; (b) the
    same in a C=10-of-100 cohort, its never-drawn rows frozen; (c) a real
    process death; (d) the snapshot's safety, its sync-freedom, one read a
    chunk and the launches; (e) ext_checkpoint's overhead."""
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64,
                               device=device)
    out = {}
    dense = straight_run(ckpt_config(prob, cohort=False), w_star, device)
    kw = ckpt_config(prob, cohort=False)
    out["ckpt_engine"] = kill_and_resume("ckpt_engine", kw, dense, w_star,
                                         device, CKPT_CHUNK, "async")
    out["ckpt_loop_engine"] = kill_and_resume("ckpt_loop_engine", kw, dense,
                                              w_star, device, None, "sync")
    cohort = straight_run(ckpt_config(prob, cohort=True), w_star, device)
    out["ckpt_cohort"] = kill_and_resume(
        "ckpt_cohort", ckpt_config(prob, cohort=True), cohort, w_star, device,
        CKPT_CHUNK, "async", state_gate=frozen_rows)
    del cohort
    free_memory()
    out["death"] = real_death(dense, w_star, device)
    out["ckpt_snapshots"] = snapshot_gate(prob, w_star, device)
    del dense
    free_memory()
    out["ext_checkpoint"] = ext_checkpoint(device)
    return out


#: phase 4g, the distributed runtime (core/sharded.py) on the one card: (a)
#: an NCCL world of one in this process at paper scale; (b) a gloo world of
#: SHARD_WORLD child processes, whose acceptance run saves every
#: SHARD_CKPT_EVERY rounds (sync) and is resumed from its second save
SHARD_WORLD, SHARD_CKPT_EVERY = 2, 4
SHARD_RESUME_ROUND = 2 * SHARD_CKPT_EVERY
SHARD_CHILD_TIMEOUT = 240.0
#: the metrics the sharded round reduces in another order than the vmap
#: round (its nanmean: an all-reduced sum and count), held to rel 1e-12
SHARD_NANMEAN_FIELDS = ("theta_mean", "gram_cond_mean")
#: phase 4d's cohort runs (C=10 of K=100) that (a) repeats on the sharded
#: runtime, bit for bit, and whose int8 round (b) holds at W = 2
SHARD_COHORT_RUNS = ("cohort_fedosaa_svrg", "cohort_fedosaa_svrg_int8")


def same_rows_sharded(what: str, want, got, w_want, w_got) -> None:
    """Raise unless a sharded run's telemetry rows are a vmap run's: every
    field but the wall times equal (nan where nan), the nanmean metrics
    within rel 1e-12, and the final params bit for bit."""
    from repro_torch.obs import ROW_FIELDS

    fields = ("round",) + tuple(f for f in ROW_FIELDS
                                if f not in ("round_wall_s", "wall_time_s"))
    a, b = (np.array([[r[f] for f in fields] for r in sink.rows],
                     dtype=np.float64) for sink in (want, got))
    if a.shape != b.shape:
        raise AssertionError(f"{what}: {len(b)} rounds, expected {len(a)}")
    bad = []
    for j, f in enumerate(fields):
        if f in SHARD_NANMEAN_FIELDS:
            ok = np.allclose(b[:, j], a[:, j], rtol=1e-12, atol=0.0,
                             equal_nan=True)
        else:
            ok = np.array_equal(a[:, j], b[:, j], equal_nan=True)
        if not ok:
            bad.append(f)
    if bad or not torch.equal(w_want, w_got):
        raise AssertionError(f"{what}: rows differ in {bad}; final params "
                             f"equal: {torch.equal(w_want, w_got)}")


def rank_rows(state, sl):
    """A rank's state: its rows ``sl`` of every per-client tensor."""
    def cut(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[sl].contiguous()
    return state._replace(c_k=cut(state.c_k), hist_s=cut(state.hist_s),
                          hist_y=cut(state.hist_y), comm=cut(state.comm))


def sharded_world_of_one(clients, w_star, device, paper: dict,
                         cohort: dict) -> dict:
    """Phase 4g (a): an NCCL group of one process (this one, on a
    HashStore), FedOSAA-SVRG at paper scale (f64, 10 rounds) on the
    identity and int8 wires. The loop through run_federated(runtime=
    "sharded") gives phase 4's vmap loop rows (the nanmean metrics within
    rel 1e-12) and final params bit for bit, with its launches; the engine
    (chunks of PAPER_CHUNK, its all-reduces captured in the graph) leaves
    every state tensor equal to phase 4's vmap engine run, makes one host
    read a chunk after the first and launches each kernel once a slot;
    then PAPER_REPLAYS more replays for its ms a round; a warmed-up round
    under set_sync_debug_mode("error") reads nothing back. Then the same
    for phase 4d's cohort runs (``sharded_cohorts_of_one``)."""
    import torch.distributed as dist

    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  run_federated, run_rounds)
    from repro_torch.core.sharded import make_sharded_round_fn
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import MemorySink

    torch.cuda.set_device(device)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64,
                               device=device)
    out = {}
    try:
        for name, channel in (("float64", None), ("float64_int8", "int8")):
            vmap = paper[name]
            int8 = channel == "int8"
            s_loop = MemorySink()
            _build.reset_launches()
            h = run_federated(prob, "fedosaa_svrg", hp, 10, w_star=w_star,
                              device=device, channel=channel, sinks=[s_loop],
                              runtime="sharded")
            launches = dict(_build.LAUNCHES)
            rounds = len(h.rounds)
            designs = check_resident(f"sharded {name} loop", rounds)
            want = expected_launches(rounds, int8=int8)
            if launches != want:
                raise AssertionError(f"sharded {name} loop: launches "
                                     f"{launches}, expected {want}")
            same_rows_sharded(f"sharded W=1 {name} loop", vmap["vmap"]["sink"],
                              s_loop, vmap["vmap"]["params"], h.final_params)
            loop_ms = float(np.median(np.diff(h.wall_time) * 1e3))

            rf = make_sharded_round_fn("fedosaa_svrg", prob, hp,
                                       channel=channel, device=device)
            state = init_state(rf.rank_problem, device=device,
                               channel=channel, algo="fedosaa_svrg")
            runner = make_chunk_runner(rf, PAPER_CHUNK, w_star=w_star)
            s_eng = MemorySink()
            _build.reset_launches()
            with sync_warnings() as caught:
                reads = ChunkReads(caught)
                state, trace = run_rounds(rf, state, 10, chunk=PAPER_CHUNK,
                                          w_star=w_star, runner=runner,
                                          sinks=[s_eng, reads])
            counted = engine_launches(f"sharded {name} engine",
                                      trace.num_rounds, PAPER_CHUNK, int8)
            if any(n != 1 for n in reads.per_chunk[1:]):
                raise AssertionError(f"sharded {name} engine: host reads per "
                                     f"chunk {reads.per_chunk}")
            same_state(f"sharded W=1 {name} engine against phase 4's vmap "
                       "engine", vmap["vmap"]["state"], state)
            same_rows_sharded(f"sharded W=1 {name} engine",
                              vmap["vmap"]["sink"], s_eng,
                              vmap["vmap"]["params"], state.params)
            walls = [float(trace.round_wall[PAPER_CHUNK:].sum())]
            for _ in range(PAPER_REPLAYS):
                t0 = time.perf_counter()
                state, *_ = runner(state, PAPER_CHUNK)
                walls.append(time.perf_counter() - t0)
            eng_ms = float(np.median(walls)) / PAPER_CHUNK * 1e3

            rf1 = make_sharded_round_fn("fedosaa_svrg", prob, hp,
                                        channel=channel, device=device)
            st = init_state(rf1.rank_problem, device=device, channel=channel,
                            algo="fedosaa_svrg")
            for _ in range(2):
                st, _ = rf1(st)
            torch.cuda.synchronize(device)
            _build.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, m = rf1(st)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            one = dict(_build.LAUNCHES)
            if one != expected_launches(1, int8=int8) or \
                    not np.isfinite(float(m.loss)):
                raise AssertionError(f"sharded {name} no-host-read round: "
                                     f"launches {one}, loss {float(m.loss)}")
            out[f"sharded_w1_{name}"] = dict(
                launches=launches, designs=designs, ms_per_round=loop_ms,
                vmap_ms_per_round=vmap["ms_per_round"],
                engine=dict(ms_per_round=eng_ms,
                            chunk_ms=[w * 1e3 for w in walls],
                            warmup_ms=runner.warmup_ms,
                            capture_ms=runner.capture_ms,
                            reads_per_chunk=reads.per_chunk,
                            vmap_ms_per_round=vmap["engine"]["ms_per_round"],
                            **counted))
            print(f"  (a) NCCL W=1 {name} [{h.channel}]: loop {rounds} rounds "
                  f"= phase 4's vmap loop (rows, final params), "
                  f"{loop_ms:.3f} ms/round (vmap {vmap['ms_per_round']:.3f}), "
                  f"launches {launches}; engine (chunk={PAPER_CHUNK}, "
                  f"captured) every state tensor = phase 4's vmap engine, "
                  f"{eng_ms:.3f} ms/round (vmap "
                  f"{vmap['engine']['ms_per_round']:.3f}; chunk ms "
                  f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}), warm-up "
                  f"{runner.warmup_ms:.1f} ms, capture {runner.capture_ms:.1f}"
                  f" ms, host reads per chunk {reads.per_chunk}, launches "
                  f"{counted['launches']} over {counted['slots']} slots; a "
                  f"warmed-up round under set_sync_debug_mode('error'): "
                  f"launches { {k: v for k, v in one.items() if v} }",
                  flush=True)
            del runner, state, rf, rf1, st, h
            torch.cuda.empty_cache()
        out.update(sharded_cohorts_of_one(prob, w_star, device, cohort))
    finally:
        dist.destroy_process_group()
    return out


def sharded_cohorts_of_one(prob, w_star, device, cohort: dict) -> dict:
    """Phase 4g (a), cohorts, in the NCCL world of one: each
    SHARD_COHORT_RUNS run of phase 4d (FedOSAA-SVRG, C=10 of K=100, f64,
    identity and int8) through run_federated(runtime="sharded") by the
    loop, and by the engine (chunks of PAPER_CHUNK, its row exchange's
    all-to-all and all-gather captured in the graph): phase 4d's vmap
    loop rows (the nanmean metrics within rel 1e-12) and final params bit
    for bit, its launches, the engine's every state tensor (the whole
    K-sized store) equal to phase 4d's vmap engine run, one host read a
    chunk after the first; then PAPER_REPLAYS more replays for its ms a
    round, and a warmed-up round under set_sync_debug_mode("error") that
    reads nothing back. Then the ext_cohort point (K=4096, C=16, float32)
    by the sharded engine: its global loss bit-equal to phase 4d's and
    below EXT_COHORT_LOSS_SHARE of its initial value."""
    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  run_federated, run_rounds)
    from repro_torch.core.sharded import make_sharded_round_fn
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import MemorySink

    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS,
                     participation=COHORT_PARTICIPATION)
    out = {}
    for name in SHARD_COHORT_RUNS:
        vmap = cohort["runs"][name]
        channel = None if vmap["channel"] == "identity" else vmap["channel"]
        int8 = channel == "int8"
        s_loop = MemorySink()
        _build.reset_launches()
        h = run_federated(prob, "fedosaa_svrg", hp, 10, w_star=w_star,
                          device=device, channel=channel, sinks=[s_loop],
                          runtime="sharded")
        launches = dict(_build.LAUNCHES)
        designs = check_resident(f"sharded {name} loop", len(h.rounds))
        if launches != vmap["launches"]:
            raise AssertionError(f"sharded {name} loop: launches {launches}, "
                                 f"phase 4d's {vmap['launches']}")
        same_rows_sharded(f"sharded W=1 {name} loop", vmap["vmap"]["sink"],
                          s_loop, vmap["vmap"]["params"], h.final_params)
        loop_ms = float(np.median(np.diff(h.wall_time) * 1e3))

        rf = make_sharded_round_fn("fedosaa_svrg", prob, hp, channel=channel,
                                   device=device)
        state = init_state(rf.rank_problem, device=device, channel=channel,
                           algo="fedosaa_svrg")
        runner = make_chunk_runner(rf, PAPER_CHUNK, w_star=w_star)
        s_eng = MemorySink()
        _build.reset_launches()
        with sync_warnings() as caught:
            reads = ChunkReads(caught)
            state, trace = run_rounds(rf, state, 10, chunk=PAPER_CHUNK,
                                      w_star=w_star, runner=runner,
                                      sinks=[s_eng, reads])
        counted = engine_launches(f"sharded {name} engine", trace.num_rounds,
                                  PAPER_CHUNK, int8)
        if counted["launches"] != vmap["engine"]["launches"]:
            raise AssertionError(f"sharded {name} engine: launches "
                                 f"{counted['launches']}, phase 4d's "
                                 f"{vmap['engine']['launches']}")
        if any(n != 1 for n in reads.per_chunk[1:]):
            raise AssertionError(f"sharded {name} engine: host reads per "
                                 f"chunk {reads.per_chunk}")
        same_state(f"sharded W=1 {name} engine against phase 4d's vmap "
                   "engine", vmap["vmap"]["state"], state)
        same_rows_sharded(f"sharded W=1 {name} engine", vmap["vmap"]["sink"],
                          s_eng, vmap["vmap"]["params"], state.params)
        walls = [float(trace.round_wall[PAPER_CHUNK:].sum())]
        for _ in range(PAPER_REPLAYS):
            t0 = time.perf_counter()
            state, *_ = runner(state, PAPER_CHUNK)
            walls.append(time.perf_counter() - t0)
        eng_ms = float(np.median(walls)) / PAPER_CHUNK * 1e3
        row_bytes = dict(rf.exchange.row_bytes)

        st = init_state(rf.rank_problem, device=device, channel=channel,
                        algo="fedosaa_svrg")
        for _ in range(2):
            st, _ = rf(st)
        torch.cuda.synchronize(device)
        _build.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, m = rf(st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        one = dict(_build.LAUNCHES)
        if one != expected_launches(1, int8=int8) or \
                not np.isfinite(float(m.loss)):
            raise AssertionError(f"sharded {name} no-host-read round: "
                                 f"launches {one}, loss {float(m.loss)}")
        out[f"sharded_w1_{name}"] = dict(
            launches=launches, designs=designs, ms_per_round=loop_ms,
            vmap_ms_per_round=vmap["ms_per_round"], row_bytes=row_bytes,
            engine=dict(ms_per_round=eng_ms,
                        chunk_ms=[w * 1e3 for w in walls],
                        warmup_ms=runner.warmup_ms,
                        capture_ms=runner.capture_ms,
                        reads_per_chunk=reads.per_chunk,
                        vmap_ms_per_round=vmap["engine"]["ms_per_round"],
                        **counted))
        print(f"  (a) NCCL W=1 {name} [{h.channel}]: loop {len(h.rounds)} "
              f"rounds = phase 4d's vmap loop (rows, final params), "
              f"{loop_ms:.3f} ms/round (vmap {vmap['ms_per_round']:.3f}), "
              f"launches { {k: v for k, v in launches.items() if v} }; "
              f"engine (chunk={PAPER_CHUNK}, the row exchange captured) "
              f"every state tensor = phase 4d's vmap engine, {eng_ms:.3f} "
              f"ms/round (vmap {vmap['engine']['ms_per_round']:.3f}; chunk "
              f"ms {', '.join(f'{w * 1e3:.2f}' for w in walls)}), warm-up "
              f"{runner.warmup_ms:.1f} ms, capture {runner.capture_ms:.1f} "
              f"ms, host reads per chunk {reads.per_chunk}; a warmed-up "
              f"round under set_sync_debug_mode('error'): launches "
              f"{ {k: v for k, v in one.items() if v} }; exchange row bytes "
              f"{row_bytes}", flush=True)
        del runner, state, rf, st, h
        torch.cuda.empty_cache()

    # the ext_cohort point by the sharded engine
    K = EXT_COHORT_KS[-1]
    X, y = make_binary_classification("synthetic_small", n=8 * K, seed=0)
    p4k = make_logreg_problem(partition(X, y, K, "iid", seed=0,
                                        device=device), 1e-3, device=device)
    rf = make_sharded_round_fn("fedosaa_svrg", p4k,
                               AlgoHParams(eta=0.5, local_epochs=2,
                                           cohort_size=EXT_COHORT_C),
                               device=device)
    state = init_state(rf.rank_problem, device=device)
    loss0 = float(p4k.global_loss(state.params))
    runner = make_chunk_runner(rf, EXT_COHORT_CHUNK)
    _build.reset_launches()
    with sync_warnings() as caught:
        reads = ChunkReads(caught)
        state, trace = run_rounds(rf, state, EXT_COHORT_ROUNDS,
                                  chunk=EXT_COHORT_CHUNK, runner=runner,
                                  sinks=[reads])
    counted = engine_launches(f"sharded ext_cohort K={K}", trace.num_rounds,
                              EXT_COHORT_CHUNK, int8=False)
    loss = float(p4k.global_loss(state.params))
    walls = []
    for _ in range(EXT_COHORT_REPLAYS):
        t0 = time.perf_counter()
        runner(state, EXT_COHORT_CHUNK)
        walls.append(time.perf_counter() - t0)
    ms = float(np.median(walls)) / EXT_COHORT_CHUNK * 1e3
    want = cohort["ext_cohort"]["rows"][f"K={K}/cohort"]
    print(f"  (a) NCCL W=1 ext_cohort K={K}, C={EXT_COHORT_C} by the sharded "
          f"engine: global loss {loss0:.6f} -> {loss!r} after "
          f"{trace.num_rounds} rounds (phase 4d's vmap run {want['loss']!r}),"
          f" {ms:.3f} ms/round (vmap {want['ms_per_round']:.3f}; chunk ms "
          f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}), capture "
          f"{runner.capture_ms:.1f} ms, host reads per chunk "
          f"{reads.per_chunk}, launches "
          f"{ {k: v for k, v in counted['launches'].items() if v} }",
          flush=True)
    if not (loss < EXT_COHORT_LOSS_SHARE * loss0 and loss == want["loss"]
            and all(n == 1 for n in reads.per_chunk[1:])):
        raise AssertionError(f"sharded ext_cohort K={K}: global loss {loss} "
                             f"(from {loss0}; phase 4d's {want['loss']}), "
                             f"reads per chunk {reads.per_chunk}")
    out["sharded_w1_ext_cohort"] = dict(
        loss0=loss0, loss=loss, ms_per_round=ms,
        chunk_ms=[w * 1e3 for w in walls], capture_ms=runner.capture_ms,
        reads_per_chunk=reads.per_chunk, **counted)
    del runner, state, rf, p4k
    free_memory()
    return out


def sharded_gloo_world(w_star_acc, clients, device, floor: float,
                       cohort: dict) -> dict:
    """Phase 4g (b): a gloo group of SHARD_WORLD child processes of this
    script on the one card (``--sharded-child <dir>``, spawn_world on a
    FileStore), five clients of the acceptance configuration's ten each,
    K=100's paper rows split 50/50. Gates: the acceptance run to rel-error
    1e-6 within 18 rounds with its final loss within rel 1e-12 of the
    reference's, saved every SHARD_CKPT_EVERY rounds (sync) with both
    ranks' shard files in each manifest, and a run resumed from the second
    save that ends on the straight run's rows and params bit for bit; one
    paper-scale int8 round from the vmap runtime's round-5 state (phase
    4's configuration) within 1e-7 of the vmap round on every state
    tensor; the ranks' params bit-equal; each rank's launches those of the
    vmap runtime's rounds (at K/W clients). And one paper-scale int8 cohort
    round (C=10 of 100, 5 slots a rank) from the vmap cohort run's round-5
    state within 1e-7 of the vmap cohort round on every state tensor, each
    rank's launches one of each kernel (phase 4d's a round), its ms, and
    the row exchange's bytes a rank beside the least the moves need;
    ``trajectory`` at that shape (5 clients' rows) against its plain
    version."""
    import tempfile

    from repro_torch.core import AlgoHParams, init_state, make_round_fn
    from repro_torch.core.engine import _map_state
    from repro_torch.core.sharded import spawn_world
    from repro_torch.models.logreg import make_logreg_problem

    tmp = tempfile.mkdtemp(prefix="sharded_")
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64,
                               device=device)
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    rf = make_round_fn("fedosaa_svrg", prob, hp, "int8", device=device)
    state = init_state(prob, device=device, channel="int8",
                       algo="fedosaa_svrg")
    for _ in range(5):
        state, _ = rf(state)
    want, _ = rf(state)
    hpc = dataclasses.replace(hp, participation=COHORT_PARTICIPATION)
    rfc = make_round_fn("fedosaa_svrg", prob, hpc, "int8", device=device)
    sc = init_state(prob, device=device, channel="int8", algo="fedosaa_svrg")
    for _ in range(5):
        sc, _ = rfc(sc)
    want_c, _ = rfc(sc)
    torch.save(dict(start=_map_state(lambda t: t.cpu(), state),
                    cohort_start=_map_state(lambda t: t.cpu(), sc),
                    w_star=w_star_acc.cpu()), os.path.join(tmp, "inputs.pt"))
    del rf, rfc, prob
    t0 = time.perf_counter()
    results = spawn_world([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--sharded-child", tmp], SHARD_WORLD,
                          os.path.join(tmp, "store"),
                          timeout_s=SHARD_CHILD_TIMEOUT, cwd=str(ROOT))
    secs = time.perf_counter() - t0
    for r, res in enumerate(results):
        tail = res.stdout.strip().splitlines()[-3:]
        print(f"  (b) gloo rank {r}: exit {res.returncode} in {secs:.1f} s; "
              f"its output's last lines: {tail}", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {res.returncode}: "
                                 f"{res.stdout[-3000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARD_WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for r, got in enumerate(ranks):
        acc = got["straight"]
        to_target = rounds_to(acc["rel_error"], 1e-6)
        loss_rel = abs(acc["loss"][-1] - REFERENCE_LOSS) / REFERENCE_LOSS
        if to_target is None or to_target > 18 or not loss_rel <= 1e-12:
            raise AssertionError(f"gloo rank {r}: rounds to 1e-6 {to_target}, "
                                 f"final loss rel {loss_rel:.2e}")
        want_l = expected_launches(len(acc["loss"]), int8=False)
        if got["launches"] != want_l:
            raise AssertionError(f"gloo rank {r} acceptance: launches "
                                 f"{got['launches']}, expected {want_l}")
        if got["int8_launches"] != expected_launches(1, int8=True):
            raise AssertionError(f"gloo rank {r} int8 round: launches "
                                 f"{got['int8_launches']}")
        if got["files"] != [f"shards_p{i:04d}.npz"
                            for i in range(SHARD_WORLD)]:
            raise AssertionError(f"gloo rank {r}: manifest files "
                                 f"{got['files']}")
        if not (got["resume_equal"] and got["params_equal"]
                and got["int8_params_equal"]):
            raise AssertionError(f"gloo rank {r}: resume bit for bit "
                                 f"{got['resume_equal']}, ranks' params "
                                 f"equal {got['params_equal']} / "
                                 f"{got['int8_params_equal']}")
        out[f"sharded_w2_acceptance_rank{r}"] = dict(
            launches=got["launches"], designs=got["designs"],
            to_target=to_target, loss=float(acc["loss"][-1]),
            ms_per_round=float(np.median(np.diff(acc["wall_time"]) * 1e3)))
    sl = [slice(r * K_MAIN // SHARD_WORLD, (r + 1) * K_MAIN // SHARD_WORLD)
          for r in range(SHARD_WORLD)]
    got = ranks[0]["int8_state"]
    w_norm = float(torch.linalg.vector_norm(want.params))
    errs = {"params": float(torch.linalg.vector_norm(
        got.params - want.params.cpu())) / w_norm}
    for tag, bufs in want.comm.items():
        for n, buf in bufs.items():
            joined = torch.cat([ranks[r]["int8_state"].comm[tag][n]
                                for r in range(SHARD_WORLD)])
            want_rows = torch.cat([buf[s].cpu() for s in sl])
            scale = max(w_norm, float(want_rows.abs().max()))
            errs[f"{tag}/{n}"] = float((joined - want_rows).abs().max()) / scale
    if max(errs.values()) > 1e-7 or got.t != want.t:
        raise AssertionError(f"gloo int8 round against the vmap round: {errs}")
    out["cohort_w2"] = gloo_cohort_round(ranks, want_c, clients, device, floor,
                                         cohort)
    acc0 = ranks[0]["straight"]
    print(f"  (b) gloo W={SHARD_WORLD} on the card: the acceptance run "
          f"reaches 1e-6 in {out['sharded_w2_acceptance_rank0']['to_target']}"
          f" rounds, final loss {acc0['loss'][-1]!r}, "
          f"{out['sharded_w2_acceptance_rank0']['ms_per_round']:.3f} ms/round "
          f"(rank 0's loop), launches per rank {ranks[0]['launches']}; "
          f"saved every {SHARD_CKPT_EVERY} rounds, manifests name "
          f"{ranks[0]['files']}, the run resumed from round "
          f"{SHARD_RESUME_ROUND} = the straight run bit for bit; the "
          f"paper-scale int8 round from round 5 against the vmap round: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }, launches per rank "
          f"{ {k: v for k, v in ranks[0]['int8_launches'].items() if v} }; "
          f"ranks' params bit-equal", flush=True)
    out["int8_round_errors"] = errs
    out["child_seconds"] = secs
    return out


def gloo_cohort_round(ranks: list, want, clients, device, floor: float,
                      cohort: dict) -> dict:
    """Phase 4g (b), the cohort: the ranks' int8 cohort round against the
    vmap cohort round ``want`` (every state tensor within 1e-7 of its
    scale, the params bit-equal across ranks, each rank one launch of
    each kernel, phase 4d's a round), the exchange's bytes a rank a round
    from the round's row widths beside the least, and ``trajectory`` at
    the rank's shape (C/W clients)."""
    from repro_torch.core import AlgoHParams, resolve_cohort_size

    W = len(ranks)
    C = resolve_cohort_size(AlgoHParams(participation=COHORT_PARTICIPATION),
                            K_MAIN)
    Q = C // W
    sl = [slice(r * K_MAIN // W, (r + 1) * K_MAIN // W) for r in range(W)]
    got = ranks[0]["cohort_state"]
    w_norm = float(torch.linalg.vector_norm(want.params))
    errs = {"params": float(torch.linalg.vector_norm(
        got.params - want.params.cpu())) / w_norm}
    for tag, bufs in want.comm.items():
        for n, buf in bufs.items():
            joined = torch.cat([ranks[r]["cohort_state"].comm[tag][n]
                                for r in range(W)])
            want_rows = torch.cat([buf[s].cpu() for s in sl])
            scale = max(w_norm, float(want_rows.abs().max()))
            errs[f"{tag}/{n}"] = float((joined - want_rows).abs().max()) / scale
    for r, rk in enumerate(ranks):
        if rk["cohort_launches"] != expected_launches(1, int8=True):
            raise AssertionError(f"gloo rank {r} cohort round: launches "
                                 f"{rk['cohort_launches']}")
        if not rk["cohort_params_equal"]:
            raise AssertionError(f"gloo rank {r} cohort round: the ranks' "
                                 "params differ")
    if max(errs.values()) > 1e-7 or got.t != want.t:
        raise AssertionError(f"gloo int8 cohort round against the vmap "
                             f"cohort round: {errs}")
    rb = ranks[0]["row_bytes"]
    wire = dict(
        in_buffer=C * rb["in"], in_to_others=C * (W - 1) / W * rb["in"],
        in_least=Q * (W - 1) / W * rb["in"],
        back_to_others=Q * (W - 1) * rb["back"],
        back_least=Q * (W - 1) / W * rb["back"])
    ms = [rk["cohort_ms"] for rk in ranks]
    idx = torch.arange(Q, device=device) * (K_MAIN // Q)
    traj = trajectory_at(f"paper scale, C/W={Q} (C={C}, W={W})",
                         *(t.index_select(0, idx) for t in (
                             clients.x, clients.y, clients.mask)),
                         torch.float64, device, floor, steps=L_EPOCHS + 1,
                         eta=ETA)
    print(f"  (b) gloo W={W} int8 cohort round (C={C} of {K_MAIN}, {Q} slots "
          f"a rank) from the vmap cohort run's round 5 against the vmap "
          f"cohort round: { {k: f'{v:.2e}' for k, v in errs.items()} }, "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms by rank, launches per "
          f"rank { {k: v for k, v in ranks[0]['cohort_launches'].items() if v} }"
          f"; the exchange a rank a round: row bytes {rb}, in "
          f"{wire['in_buffer']:.0f} B through all_to_all_single of which "
          f"{wire['in_to_others']:.0f} B to other ranks (least "
          f"{wire['in_least']:.0f} B), back {wire['back_to_others']:.0f} B "
          f"through the all-gather (least {wire['back_least']:.0f} B); "
          f"trajectory at {Q} clients {traj['ms']:.4f} ms against "
          f"{cohort['trajectory']['ms']:.4f} ms at phase 4d's C={C}",
          flush=True)
    return dict(errors=errs, ms_by_rank=ms, row_bytes=rb, bytes=wire,
                trajectory=traj)


def sharded_child(argv: list) -> int:
    """Phase 4g (b)'s child: ``--sharded-child <dir>``, one rank of a gloo
    world (spawn_world's environment: RANK, WORLD_SIZE, the FileStore) on
    the card. Runs the acceptance configuration by the sharded loop, saving
    into <dir>/ckpt, and again resumed from the second save; then one
    paper-scale int8 round from <dir>/inputs.pt's state. Writes what it saw
    to <dir>/rank<r>.pt."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointPolicy, ckpt_name
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.core.engine import _map_state
    from repro_torch.core.sharded import (client_shard, init_file_world,
                                          make_sharded_round_fn)
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    (d,) = argv
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    init_file_world(backend="gloo", timeout_s=60.0)
    rank, world = dist.get_rank(), dist.get_world_size()
    _build.library()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)

    def same_everywhere(t: torch.Tensor) -> bool:
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(torch.equal(p, t) for p in parts)

    def history(h) -> dict:
        return {f: np.asarray(getattr(h, f)) for f in
                ("rounds", "loss", "rel_error", "grad_norm", "theta_mean",
                 "wall_time")}

    prob = acceptance_problem(device)
    ck = os.path.join(d, "ckpt")
    kw = dict(w_star=inp["w_star"].to(device), stop_rel_error=1e-8,
              device=device, runtime="sharded")
    _build.reset_launches()
    h = run_federated(prob, "fedosaa_svrg", hp, 20,
                      checkpoint=CheckpointPolicy(directory=ck,
                                                  every=SHARD_CKPT_EVERY,
                                                  keep=0, mode="sync"), **kw)
    out = dict(launches=dict(_build.LAUNCHES),
               designs=dict(_build.DESIGN_LAUNCHES["trajectory"]),
               straight=history(h), params_equal=same_everywhere(h.final_params))
    resumed = run_federated(prob, "fedosaa_svrg", hp, 20,
                            resume=os.path.join(ck, ckpt_name(SHARD_RESUME_ROUND)),
                            **kw)
    r, s = history(resumed), out["straight"]
    out["resume_equal"] = bool(
        torch.equal(resumed.final_params, h.final_params)
        and all(np.array_equal(r[f], s[f][SHARD_RESUME_ROUND:], equal_nan=True)
                for f in ("rounds", "loss", "rel_error", "grad_norm",
                          "theta_mean")))
    with open(os.path.join(ck, ckpt_name(SHARD_RESUME_ROUND),
                           "manifest.json")) as f:
        out["files"] = json.load(f)["files"]
    X, y = make_binary_classification("covtype", n=N_PAPER, seed=0)
    clients = partition(X, y, K_MAIN, "iid", seed=0, device=device)
    pp = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    rf = make_sharded_round_fn("fedosaa_svrg", pp, hp, channel="int8",
                               device=device)
    start = _map_state(lambda t: t.to(device), inp["start"])
    start = rank_rows(start, client_shard(K_MAIN).rows)
    _build.reset_launches()
    new, _ = rf(start)
    torch.cuda.synchronize(device)
    out["int8_launches"] = dict(_build.LAUNCHES)
    out["int8_params_equal"] = same_everywhere(new.params)
    out["int8_state"] = _map_state(lambda t: t.cpu(), new)
    # the int8 cohort round (C/W slots a rank), warmed up once, then timed
    rfc = make_sharded_round_fn(
        "fedosaa_svrg", pp, dataclasses.replace(
            hp, participation=COHORT_PARTICIPATION),
        channel="int8", device=device)
    start = rank_rows(_map_state(lambda t: t.to(device), inp["cohort_start"]),
                      client_shard(K_MAIN).rows)
    rfc(start)
    torch.cuda.synchronize(device)
    dist.barrier()
    _build.reset_launches()
    t0 = time.perf_counter()
    new, _ = rfc(start)
    torch.cuda.synchronize(device)
    out["cohort_ms"] = (time.perf_counter() - t0) * 1e3
    out["cohort_launches"] = dict(_build.LAUNCHES)
    out["cohort_params_equal"] = same_everywhere(new.params)
    out["cohort_state"] = _map_state(lambda t: t.cpu(), new)
    out["row_bytes"] = dict(rfc.exchange.row_bytes)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    print(f"rank {rank}: acceptance {len(h.rounds)} rounds, resumed "
          f"{len(resumed.rounds)}, int8 round done", flush=True)
    dist.destroy_process_group()
    return 0


def compression(device) -> dict:
    """Phase 5: the reference's ext_compression configuration on the fp32,
    bf16 and int8 wires, each by the per-round loop and then by the engine
    (run_federated(chunk=8)), each run read on its own launch counts; the
    engine's must equal the loop's rounds, rows and final params."""
    from repro_torch.core import AlgoHParams, run_federated, solve_reference
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.obs import MemorySink

    X, y = make_binary_classification("covtype", n=20_000, seed=0)
    clients = partition(X, y, 20, "iid", seed=0, device=device)
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    w_star = solve_reference(prob, iters=100)
    out = {}
    for spec, per_round in COMPRESSION_BYTES_PER_ROUND.items():
        runs = {}
        for path, chunk in (("loop", None), ("engine", ACCEPT_CHUNK)):
            sink = MemorySink()
            _build.reset_launches()
            h = run_federated(prob, "fedosaa_svrg",
                              AlgoHParams(eta=ETA, local_epochs=L_EPOCHS), 40,
                              w_star=w_star, stop_rel_error=1e-6,
                              device=device, channel=spec, chunk=chunk,
                              sinks=[sink])
            rounds = len(h.rounds)
            if chunk is None:
                launches = dict(_build.LAUNCHES)
                designs = check_resident(spec, rounds)
                want = expected_launches(rounds, int8=spec == "int8")
                if launches != want:
                    raise AssertionError(f"{spec}: launches {launches} over "
                                         f"{rounds} rounds, expected {want}")
                counted = dict(launches=launches, designs=designs)
            else:
                counted = engine_launches(f"{spec} engine", rounds, chunk,
                                          int8=spec == "int8")
            skip = 1 if chunk is None else chunk
            ms = float(np.median(per_round_ms(h.wall_time)[skip:]))
            loss_rel = abs(h.loss[-1] - COMPRESSION_LOSS) / COMPRESSION_LOSS
            ref_rounds, ref_bytes = COMPRESSION_REF[spec]
            runs[path] = dict(h=h, sink=sink, rounds=rounds,
                              comm_bytes=float(h.comm_bytes[-1]),
                              loss=float(h.loss[-1]), ms_per_round=ms,
                              **counted)
            print(f"  {h.channel:9s} {path}: rounds to 1e-6: {rounds} "
                  f"(reference {ref_rounds}), bytes {h.comm_bytes[-1]:.0f} "
                  f"(reference {ref_bytes:.0f}), final loss {h.loss[-1]!r} "
                  f"(rel {loss_rel:.2e}), median {ms:.3f} ms/round after "
                  f"{'round 0' if chunk is None else 'the first chunk'}, "
                  f"{counted}", flush=True)
            if not (h.rel_error[-1] < 1e-6 and rounds <= 26):
                raise AssertionError(f"{spec} {path}: rel-error 1e-6 not "
                                     f"reached within 26 rounds ({rounds}, "
                                     f"{h.rel_error[-1]:.3e})")
            if not np.array_equal(h.comm_bytes,
                                  per_round * np.arange(1, rounds + 1)):
                raise AssertionError(f"{spec} {path}: bytes "
                                     f"{h.comm_bytes.tolist()} are not "
                                     f"{per_round:.0f} per round")
            if not loss_rel <= 1e-10:
                raise AssertionError(f"{spec} {path}: final loss "
                                     f"{h.loss[-1]!r} is {loss_rel:.2e} from "
                                     f"{COMPRESSION_LOSS!r}")
        print("  rel-error curve " + json.dumps(
            [float(v) for v in runs["loop"]["h"].rel_error]), flush=True)
        same_as_loop(spec, runs["loop"]["sink"], runs["engine"]["sink"],
                     runs["loop"]["h"].final_params,
                     runs["engine"]["h"].final_params)
        out[spec] = {path: {k: v for k, v in r.items() if k not in ("h", "sink")}
                     for path, r in runs.items()}
    out["scaffold"] = scaffold_compression(prob, w_star, device)
    out["newton"] = newton_compression(prob, w_star, device)
    return out


def newton_compression(prob, w_star, device) -> dict:
    """Phase 5, the Newton family: GIANT, Newton-GMRES and DANE (default
    hyperparameters) on the fp32, bf16 and int8 wires, by the paths of
    COMPRESSION_NEWTON_PATHS, each to rel-error 1e-6 with a cap of 40
    rounds, against the reference's committed rows: at most one
    round more than COMPRESSION_NEWTON_ROUNDS, the bytes exactly the
    wire's per round, the final loss within rel 1e-9 of COMPRESSION_LOSS;
    per round (slot) no ``trajectory``, ``gram`` or ``aa_step`` and under
    int8 two ``int8_uplink``; where both paths run, the engine's rows and
    final params equal the loop's. Prints each curve beside its committed
    row and the largest |log10| ratio of the two over their common
    rounds."""
    from repro_torch.core import NEWTON_ALGOS, AlgoHParams, run_federated
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink

    committed = {r["name"]: r.get("rel_error_curve") for r in json.loads(
        (ROOT / "benchmarks/results/ext_compression.json").read_text())}
    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    out = {}
    for spec, ref_rounds in COMPRESSION_NEWTON_ROUNDS.items():
        per_round = COMPRESSION_BYTES_PER_ROUND[spec]
        for algo, want_rounds in zip(NEWTON_ALGOS, ref_rounds):
            ref_curve = np.asarray(committed[f"ext_compression/{spec}/{algo}"])
            runs = {}
            for path, chunk in COMPRESSION_NEWTON_PATHS[algo]:
                sink = MemorySink()
                _build.reset_launches()
                h = run_federated(prob, algo, hp, 40, w_star=w_star,
                                  stop_rel_error=1e-6, device=device,
                                  channel=spec, chunk=chunk, sinks=[sink])
                rounds = len(h.rounds)
                if chunk is None:
                    launches = dict(_build.LAUNCHES)
                    want = expected_launches(rounds, spec == "int8", algo)
                    if launches != want:
                        raise AssertionError(f"{algo} {spec}: launches "
                                             f"{launches} over {rounds} "
                                             f"rounds, expected {want}")
                    counted = dict(launches=launches)
                else:
                    counted = engine_launches(f"{algo} {spec} engine", rounds,
                                              chunk, spec == "int8", algo)
                loss_rel = abs(h.loss[-1] - COMPRESSION_LOSS) / COMPRESSION_LOSS
                n = min(rounds, len(ref_curve))
                apart = float(np.max(np.abs(np.log10(
                    h.rel_error[:n] / ref_curve[:n]))))
                skip = 1 if chunk is None else chunk
                ms = float(np.median(per_round_ms(h.wall_time)[skip:])) \
                    if rounds > skip else float("nan")
                runs[path] = dict(h=h, sink=sink, rounds=rounds,
                                  committed_rounds=want_rounds,
                                  comm_bytes=float(h.comm_bytes[-1]),
                                  loss=float(h.loss[-1]),
                                  loss_vs_reference=loss_rel,
                                  max_log10_apart=apart, ms_per_round=ms,
                                  chunk=chunk, **counted)
                print(f"  {algo:12s} {spec:5s} {path}: rounds to 1e-6: "
                      f"{rounds} (reference {want_rounds}), bytes "
                      f"{h.comm_bytes[-1]:.0f}, final loss {h.loss[-1]!r} "
                      f"(rel {loss_rel:.2e}), curve apart from the "
                      f"reference's by at most {apart:.3f} decades, median "
                      f"{ms:.3f} ms/round, "
                      f"{ {k: v for k, v in counted['launches'].items() if v} }",
                      flush=True)
                if not (h.rel_error[-1] < 1e-6 and rounds <= want_rounds + 1):
                    raise AssertionError(f"{algo} {spec} {path}: rel-error "
                                         f"1e-6 not reached within "
                                         f"{want_rounds + 1} rounds ({rounds}, "
                                         f"{h.rel_error[-1]:.3e})")
                if not np.array_equal(h.comm_bytes,
                                      per_round * np.arange(1, rounds + 1)):
                    raise AssertionError(f"{algo} {spec} {path}: bytes "
                                         f"{h.comm_bytes.tolist()} are not "
                                         f"{per_round:.0f} per round")
                if not loss_rel <= COMPRESSION_NEWTON_LOSS_RTOL:
                    raise AssertionError(f"{algo} {spec} {path}: final loss "
                                         f"{h.loss[-1]!r} is {loss_rel:.2e} "
                                         f"from {COMPRESSION_LOSS!r}")
            first = runs[COMPRESSION_NEWTON_PATHS[algo][0][0]]
            print(f"  {algo} {spec} rel-error curve " + json.dumps(
                [float(v) for v in first["h"].rel_error])
                + " committed " + json.dumps([float(v) for v in ref_curve]),
                flush=True)
            if len(runs) == 2:
                same_as_loop(f"{algo} {spec}", runs["loop"]["sink"],
                             runs["engine"]["sink"],
                             runs["loop"]["h"].final_params,
                             runs["engine"]["h"].final_params)
            out[f"{spec}/{algo}"] = {
                path: {k: v for k, v in r.items() if k not in ("h", "sink")}
                for path, r in runs.items()}
    return out


def scaffold_compression(prob, w_star, device) -> dict:
    """Phase 5, SCAFFOLD: the ext_compression config's 200 rounds on the
    fp32, bf16 and int8 wires, by the loop and by the engine (chunk=8),
    against the reference's committed rows (COMPRESSION_SCAFFOLD): the
    final rel-error within rel 1e-6 (fp32, bf16) or 1e-3 (int8: the port's
    own draws), the bytes exactly, the final loss within rel 1e-10; the
    engine's rows and final params equal the loop's; per round (slot) one
    ``trajectory`` (resident), no ``gram`` or ``aa_step``, and under int8
    two ``int8_uplink``. Then FedOSAA-SCAFFOLD's 200 fp32 rounds by the
    loop, printed and not held (the reference's committed row stalls at
    0.163; PERF.md)."""
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.kernels import _build
    from repro_torch.obs import MemorySink

    hp = AlgoHParams(eta=ETA, local_epochs=L_EPOCHS)
    out = {}
    for spec, (ref_rel, ref_bytes, ref_loss) in COMPRESSION_SCAFFOLD.items():
        runs = {}
        for path, chunk in (("loop", None), ("engine", ACCEPT_CHUNK)):
            sink = MemorySink()
            _build.reset_launches()
            h = run_federated(prob, "scaffold", hp, SCAFFOLD_ROUNDS,
                              w_star=w_star, device=device, channel=spec,
                              chunk=chunk, sinks=[sink])
            rounds = len(h.rounds)
            if chunk is None:
                launches = dict(_build.LAUNCHES)
                designs = check_resident(f"scaffold {spec}", rounds)
                want = expected_launches(rounds, spec == "int8", "scaffold")
                if launches != want:
                    raise AssertionError(f"scaffold {spec}: launches {launches}"
                                         f" over {rounds} rounds, expected {want}")
                counted = dict(launches=launches, designs=designs)
            else:
                counted = engine_launches(f"scaffold {spec} engine", rounds,
                                          chunk, spec == "int8", "scaffold")
            rel_rel = abs(h.rel_error[-1] - ref_rel) / ref_rel
            loss_rel = abs(h.loss[-1] - ref_loss) / ref_loss
            skip = 1 if chunk is None else chunk
            ms = float(np.median(per_round_ms(h.wall_time)[skip:]))
            runs[path] = dict(h=h, sink=sink, rounds=rounds,
                              rel_error=float(h.rel_error[-1]),
                              rel_error_vs_reference=rel_rel,
                              comm_bytes=float(h.comm_bytes[-1]),
                              loss=float(h.loss[-1]), loss_vs_reference=loss_rel,
                              ms_per_round=ms, **counted)
            print(f"  scaffold {spec:5s} {path}: {rounds} rounds, rel-error "
                  f"{h.rel_error[-1]!r} (reference {ref_rel!r}, rel "
                  f"{rel_rel:.2e}), bytes {h.comm_bytes[-1]:.0f} (reference "
                  f"{ref_bytes:.0f}), final loss {h.loss[-1]!r} (rel "
                  f"{loss_rel:.2e}), median {ms:.3f} ms/round, "
                  f"{ {k: v for k, v in counted['launches'].items() if v} }",
                  flush=True)
            if not (rounds == SCAFFOLD_ROUNDS and h.comm_bytes[-1] == ref_bytes
                    and rel_rel <= (1e-3 if spec == "int8" else 1e-6)
                    and loss_rel <= 1e-10):
                raise AssertionError(
                    f"scaffold {spec} {path}: {rounds} rounds, rel-error "
                    f"{h.rel_error[-1]!r} ({rel_rel:.2e} from {ref_rel!r}), "
                    f"bytes {h.comm_bytes[-1]}, loss {h.loss[-1]!r} "
                    f"({loss_rel:.2e} from {ref_loss!r})")
        same_as_loop(f"scaffold {spec}", runs["loop"]["sink"],
                     runs["engine"]["sink"], runs["loop"]["h"].final_params,
                     runs["engine"]["h"].final_params)
        out[spec] = {path: {k: v for k, v in r.items() if k not in ("h", "sink")}
                     for path, r in runs.items()}
    h = run_federated(prob, "fedosaa_scaffold", hp, SCAFFOLD_ROUNDS,
                      w_star=w_star, device=device, channel="fp32")
    out["fedosaa_scaffold_fp32"] = dict(
        rounds=len(h.rounds), rel_error=float(h.rel_error[-1]),
        min_rel_error=float(h.rel_error.min()), loss=float(h.loss[-1]))
    print(f"  fedosaa_scaffold fp32 (recorded, not held): "
          f"{out['fedosaa_scaffold_fp32']} (the reference's committed row: "
          f"0.16330192310428826 after 200 rounds)", flush=True)
    return out


def sdpa_backend(fn) -> str:
    """The device kernel(s) a torch call ran, by name, from torch.profiler
    (the SDPA backend PyTorch picked); "not traced" where the profiler
    shows no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith(("Memset", "Memcpy"))})
    return "; ".join(n[:80] for n in names) or "not traced"


def ssd_inputs(B, nc, Q, nh, hd, st, device):
    """The SSD step's inputs at a served shape, as the model makes them:
    dt > 0 (softplus'd), A < 0, da the within-chunk cumsum of dt A."""
    gen = torch.Generator(device=device).manual_seed(nh * st)
    xc = torch.randn(B, nc, Q, nh, hd, generator=gen, device=device)
    dtc = 0.01 + 0.29 * torch.rand(B, nc, Q, nh, generator=gen, device=device)
    A = -(0.5 + 3.5 * torch.rand(nh, generator=gen, device=device))
    da = torch.cumsum(dtc * A, dim=2)
    Bc = torch.randn(B, nc, Q, st, generator=gen, device=device)
    Cc = torch.randn(B, nc, Q, st, generator=gen, device=device)
    return xc, dtc, da, Bc, Cc


def check_lm_kernels(device, floor: float) -> dict:
    """Phase 2, the LM kernels at the served shapes against their plain
    versions on the card: SSD at Zamba2-7B's width (B=4, S=2048: G=32
    chunks, nh=112, Q=256, hd=st=64) and at Mamba-2-2.7B's (st=128,
    nh=80); flash attention at B*H=128, S=2048, d=112 in bf16 (Zamba2-7B's
    shared block), at granite-moe-3b-a800m's B=4, S=2048, H=24 on KV=8,
    d=64 in bf16, in f32 with a window and a ragged S, and in bf16 with
    GQA, a window and a ragged S at d=128 (Qwen3's and Llama-4's head
    width), and at phase 6e's served shapes in bf16: musicgen-medium's MHA
    (H=KV=24, d=64), its padded(16) gather mode's MHA (H=KV=32, d=64) and
    internvl2-76b's GQA (H=64 on KV=8, d=128). Bounds count each input and output byte once at 3.35 TB/s, and
    the operations of the causal work (C B^T once per chunk) at their
    type's peak: SSD's all at the f32 rate. Flash's q k^T counts 2d per
    visible pair and p v 2d, both at the rate of q's type; for bf16 inputs
    p v counts twice (4d), since the kernel splits the f32 p into bf16 hi
    and lo parts and runs one tensor-core product for each against the same
    V (bf16 products accumulated in f32 are exact, so that is what the f32
    contract costs on the bf16 tensor cores). The softmax counts 4 per pair
    at the f32 rate. The split is printed, and the blocks per SM that each
    flash kernel reaches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_ref

    out = {}
    for label, (B, nc, Q, nh, hd, st) in (
            ("zamba2-7b", (4, 8, 256, 112, 64, 64)),
            ("mamba2-2.7b", (4, 8, 256, 80, 64, 128)),
            # phase 6f (c)'s rank: its 56 of Zamba2-7B's 112 heads
            (f"zamba2-7b/{TP_ZAMBA_WORLD} ranks",
             (TP_BATCH, LM_PROMPT // 256, 256, 112 // TP_ZAMBA_WORLD, 64, 64))):
        args = ssd_inputs(B, nc, Q, nh, hd, st, device)
        y, state = ssd_chunk(*args)
        y_p, state_p = ssd_chunk_ref(*args)
        errs = [rel_diff(y, y_p), rel_diff(state, state_p)]
        G, pairs = B * nc, Q * (Q + 1) // 2
        # the products, each three TF32 passes on the tensor cores: per
        # chunk C B^T once; per head y = M (x dt) and the state (x w)^T B
        products = 3 * G * (2 * pairs * st + nh * (2 * pairs * hd + 2 * Q * hd * st))
        # elementwise, f32: per head M = CB exp(da_i - da_j) (3 ops a pair),
        # x dt, and w = dt exp(da_last - da) applied to x (3 ops a key)
        elementwise = G * nh * (3 * pairs + Q * hd + Q * (hd + 3))
        io = nbytes(*args, y, state)
        out[f"ssd/{label}"] = dict(
            rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
            tol=LM_TOLERANCE[torch.float32],
            shape=f"G={G} nh={nh} Q={Q} hd={hd} st={st} f32",
            ms=device_ms(lambda: ssd_chunk(*args), device, n=10),
            plain_ms=device_ms(lambda: ssd_chunk_ref(*args), device, n=3),
            library_ms=None, library=None,
            bound=bound_ms(io, {"tf32": products, torch.float32: elementwise}),
            # PR 14's count: every operation (one pass of each product) at
            # the f32 CUDA-core rate
            bound_f32_count=bound_ms(io, {torch.float32: products / 3 + elementwise}),
            bound_split={"products (tf32, 3 passes)": products / PEAK_OPS_PER_S["tf32"] * 1e3,
                         "elementwise (f32)": elementwise / PEAK_OPS_PER_S[torch.float32] * 1e3,
                         "bytes": io / HBM_BYTES_PER_S * 1e3},
            rerun_equal=all(map(torch.equal, ssd_chunk(*args), (y, state))),
            occupancy=_build.occupancy("repro_ssd_occupancy", Q, hd, st))
        del args, y, state, y_p, state_p

    for label, (B, S, H, KV, d, window, dtype) in (
            ("zamba2-7b", (4, 2048, 32, 32, 112, 0, torch.bfloat16)),
            (MOE_ARCH, (4, 2048, 24, 8, 64, 0, torch.bfloat16)),
            ("window-ragged", (2, 1000, 8, 2, 112, 256, torch.float32)),
            ("gqa-window-ragged-d128", (2, 1000, 8, 2, 128, 256, torch.bfloat16)),
            (AUDIO_ARCH, (4, 2048, 24, 24, 64, 0, torch.bfloat16)),
            (f"{AUDIO_ARCH}.padded({GATHER_SHARDS})",
             (4, 2048, 32, 32, 64, 0, torch.bfloat16)),
            (VLM_ARCH, (4, 2048, 64, 8, 128, 0, torch.bfloat16)),
            # phase 6f's ranks: llama4-scout's 10 of 40 heads on 2 of 8 KV
            # heads (4 ranks), Zamba2-7B's shared block's 16 of 32 (2 ranks)
            (f"{TP_ARCH}/{TP_SCOUT_WORLD} ranks",
             (TP_BATCH, LM_PROMPT, 40 // TP_SCOUT_WORLD, 8 // TP_SCOUT_WORLD, 128, 0,
              torch.bfloat16)),
            (f"zamba2-7b/{TP_ZAMBA_WORLD} ranks",
             (TP_BATCH, LM_PROMPT, 32 // TP_ZAMBA_WORLD, 32 // TP_ZAMBA_WORLD, 112, 0,
              torch.bfloat16))):
        gen = torch.Generator(device=device).manual_seed(S)
        q = torch.randn(B, S, H, d, generator=gen, device=device).to(dtype)
        k = torch.randn(B, S, KV, d, generator=gen, device=device).to(dtype)
        v = torch.randn(B, S, KV, d, generator=gen, device=device).to(dtype)
        o = flash_attention(q, k, v, window=window)
        o_p = flash_attention_ref(q, k, v, window=window)
        rel, err = rel_diff(o.float(), o_p.float())
        steps = bf16_steps(o, o_p) if dtype == torch.bfloat16 else None
        rows = torch.arange(S, dtype=torch.float64)
        visible = float((torch.minimum(rows + 1, torch.tensor(float(window)))
                         if window else rows + 1).sum())
        # per visible pair: q k^T (2 d) and p v (2 d; 4 d for bf16, split
        # into hi and lo) in q's type, and scale, max, exp, sum (f32)
        pairs = B * H * visible
        terms = {"q k^T": (dtype, pairs * 2 * d),
                 "p v": (dtype, pairs * 2 * d * (2 if dtype == torch.bfloat16 else 1)),
                 "softmax": (torch.float32, pairs * 4)}
        ops = {}
        for dt, n in terms.values():
            ops[dt] = ops.get(dt, 0.0) + n
        lib, lib_ms = None, None
        if window == 0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            gqa = KV != H

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa)
            lib_ms = device_ms(sdpa, device)
            lib = ("torch.nn.functional.scaled_dot_product_attention("
                   f"is_causal=True, enable_gqa={gqa}) -> {sdpa_backend(sdpa)}")
            lib_err = float((sdpa().transpose(1, 2).float() - o_p.float()).abs().max())
            print(f"  sdpa vs plain: abs {lib_err:.3e} (the library's own "
                  "numerics, not held to a tolerance)", flush=True)
        out[f"flash_attention/{label}"] = dict(
            rel=rel, abs=err, tol=LM_TOLERANCE[dtype], bf16_steps=steps,
            shape=f"B={B} S={S} H={H} KV={KV} d={d} window={window} "
                  f"{str(dtype)[6:]}",
            ms=device_ms(lambda: flash_attention(q, k, v, window=window), device,
                         n=10),
            plain_ms=device_ms(lambda: flash_attention_ref(q, k, v, window=window),
                               device, n=3),
            library_ms=lib_ms, library=lib,
            bound=bound_ms(nbytes(q, k, v, o), ops),
            bound_split={f"{name} ({str(dt)[6:]})": n / PEAK_OPS_PER_S[dt] * 1e3
                         for name, (dt, n) in terms.items()}
            | {"bytes": nbytes(q, k, v, o) / HBM_BYTES_PER_S * 1e3},
            rerun_equal=torch.equal(o, flash_attention(q, k, v, window=window)),
            occupancy=_build.occupancy("repro_flash_occupancy",
                                       _build.DTYPE_CODE[dtype], d))
        del q, k, v, o, o_p

    for name, r in out.items():
        print(f"  {name:28s} [{r['shape']}] rel {r['rel']:.3e} (tol "
              f"{r['tol']:.1e}) abs {r['abs']:.3e}  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  launch floor "
              f"{floor:.4f} ms", flush=True)
        if r.get("bound_split"):
            print("    bound split (ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["bound_split"].items()), flush=True)
            if r.get("bound_f32_count"):
                print(f"    bound with every operation at the f32 rate (PR 14's "
                      f"count): {r['bound_f32_count'][0]:.4f} ms "
                      f"({r['bound_f32_count'][1]})", flush=True)
            print(f"    rerun bit-identical {r['rerun_equal']}; kernel "
                  f"{r['occupancy']}", flush=True)
            if not r["rerun_equal"]:
                raise AssertionError(f"{name}: a rerun of the kernel differs")
        if r["library"]:
            print(f"    library: {r['library']}", flush=True)
        if not r["rel"] <= r["tol"]:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version: {r['rel']:.3e} > {r['tol']:.1e}")
        if r.get("bf16_steps") is not None:
            print(f"    element by element: max |o - o_p| / (2^-7 |o_p| + "
                  f"2^-9 row RMS) = {r['bf16_steps']:.3f} (limit 1)", flush=True)
            if not r["bf16_steps"] <= 1.0:
                raise AssertionError(f"{name}: an element is more than one bf16 "
                                     f"step from the plain version "
                                     f"({r['bf16_steps']:.3f} > 1)")
    torch.cuda.empty_cache()
    return out


class plain_lm_kernels:
    """Within the block, the model's layers call the plain versions of the
    LM kernels (the reference point of the prefill check), or of those in
    ``names`` only; the kernels' wrappers are put back on exit."""

    def __init__(self, names=("flash_attention", "ssd_chunk")):
        self.names = names

    def __enter__(self):
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref
        from repro_torch.kernels.ssd.ref import ssd_chunk_ref
        from repro_torch.models import layers

        plain = {"flash_attention": flash_attention_ref, "ssd_chunk": ssd_chunk_ref}
        self.layers = layers
        self.saved = {name: getattr(layers, name) for name in self.names}
        for name in self.names:
            setattr(layers, name, plain[name])

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.layers, name, fn)


def host_ms(fn, device, repeats: int = 3) -> list[float]:
    """Wall times (ms) of ``repeats`` calls, each ended by a synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


#: kernel names, lower-cased, by the part of an LM step they belong to
KERNEL_KINDS = (("flash_attention", ("flash_",)),
                ("products (GEMM)", ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                                     "gemv")),
                ("dispatch (sort, scan, index)", ("sort", "scan", "index", "scatter",
                                                  "gather")))


def kernel_split(fn) -> dict:
    """Device time (ms) of one ``fn()`` by kind of kernel (KERNEL_KINDS, the
    rest "elementwise and other"), its kernel count and the device time in
    all, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    key = ("self_device_time_total" if events and
           hasattr(events[0], "self_device_time_total") else "self_cuda_time_total")
    out = {name: 0.0 for name, _ in KERNEL_KINDS} | {"elementwise and other": 0.0}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, marks in KERNEL_KINDS
                     if any(m in name for m in marks)), "elementwise and other")
        out[kind] += getattr(e, key) / 1e3
    out["kernels"] = sum(e.count for e in events)
    out["device_ms"] = sum(getattr(e, key) for e in events) / 1e3
    out["top"] = [(e.key[:60], round(getattr(e, key) / 1e3, 3), e.count)
                  for e in sorted(events, key=lambda e: -getattr(e, key))[:6]]
    return out


def expert_products_ms(model, device) -> float:
    """Device time (ms) of one MoE layer's expert products at the prefill's
    shape (layer 0's weights; [E, C, d] inputs at C = capacity for
    LM_BATCH x LM_PROMPT tokens): silu(x wi_gate) * (x wi_up), then wo."""
    import torch.nn.functional as F

    cfg, p = model.cfg, model.blocks[0].moe
    T, E, k = LM_BATCH * LM_PROMPT, cfg.eff_experts, cfg.experts_per_token
    C = max(int(cfg.capacity_factor * T * k / E), 1)
    buf = torch.randn((E, C, cfg.d_model), device=device).to(model.dtype)
    return device_ms(lambda: torch.bmm(F.silu(torch.bmm(buf, p["wi_gate"]))
                                       * torch.bmm(buf, p["wi_up"]), p["wo"]),
                     device, n=5)


class routing:
    """Within the block, each MoE layer's top-k choice
    (models/layers.py::moe_top_k) is recorded (``"record"``), held against
    a record, counting the tokens whose experts differ (``"compare"``), or
    replayed from a record (``"replay"``: the recorded experts, their gate
    weights from the call's own probabilities), call by call in order.
    Routing is discrete: a last-ulp change of the router's input may move a
    near-tied token to another expert and shift every later slot of both
    experts, which no kernel's error bound covers. So the MoE model's
    kernel-against-plain gates replay the kernel run's routing in the plain
    run when the two route differently, and print how many tokens did.
    Models without experts make no call."""

    def __init__(self, mode: str = "record", record: list | None = None):
        self.mode = mode
        self.record = [] if record is None else record
        self.calls = self.differ = self.tokens = 0

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.saved = layers, layers.moe_top_k

        def top_k(probs, k):
            i, self.calls = self.calls, self.calls + 1
            if self.mode == "replay":
                gate_i = self.record[i]
                w = probs.gather(1, gate_i)
                return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), gate_i
            gate_w, gate_i = self.saved(probs, k)
            if self.mode == "record":
                self.record.append(gate_i)
            else:
                self.differ += int((gate_i != self.record[i]).any(-1).sum())
                self.tokens += gate_i.shape[0]
            return gate_w, gate_i

        layers.moe_top_k = top_k
        return self

    def __exit__(self, *exc):
        self.layers.moe_top_k = self.saved


def plain_pinned(fn, record: list) -> tuple:
    """``fn()`` through the plain versions of the LM kernels, held to the
    routing ``record`` of the kernel run: (its result, the token-layers it
    routes differently on its own, the token-layers routed). Without
    experts, or when the plain run routes as the kernel run did, that run's
    result; else the rerun with the kernel run's routing replayed."""
    with plain_lm_kernels(), routing("compare", record) as cmp:
        out = fn()
    if cmp.differ:
        with plain_lm_kernels(), routing("replay", record):
            out = fn()
    return out, cmp.differ, cmp.tokens


def blockwise_prefill(model, tokens, kernels, embeds=None) -> dict:
    """The prefill one block at a time: each block's output through the
    kernels and through the plain versions from the same input (the kernel
    stream's; an MoE block's plain run held to the kernel run's routing,
    ``plain_pinned``), and a plain stream carried to the end. Returns each
    block's relative difference (``local``), that of the two streams'
    last-position logits (``stream``), the token-layers routed differently
    from the same input (``rerouted``, of ``routed``), and, where the model
    runs more than one LM kernel (``kernels``), the worst block's
    difference with only one of them run by its kernel (``by_kernel``):
    which kernel its error comes from. ``embeds``: a vlm/audio model's
    frontend embeddings."""
    cfg = model.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    window = cfg.sliding_window
    hk = hp = model.embed_tokens(tokens, embeds)
    local, worst, rerouted, routed = [], None, 0, 0
    for block, _, _ in model.schedule():
        with routing("record") as rec:
            out_k = block(hk, cfg, positions, window)[0]
        out_p, differ, n = plain_pinned(
            lambda: block(hk, cfg, positions, window)[0], rec.record)
        rerouted, routed = rerouted + differ, routed + n
        with plain_lm_kernels():
            hp = block(hp, cfg, positions, window)[0]
        local.append(rel_diff(out_k.float(), out_p.float())[0])
        if local[-1] == max(local):
            worst = (block, hk, out_p, rec.record)
        hk = out_k
    block, h_in, out_p, record = worst
    wrappers = {"ssd": "ssd_chunk", "flash_attention": "flash_attention"}
    by_kernel = {}
    for kernel in kernels if len(kernels) > 1 else ():
        plain = tuple(wrappers[k] for k in kernels if k != kernel)
        with plain_lm_kernels(plain), routing("replay", record):
            out_one = block(h_in, cfg, positions, window)[0]
        by_kernel[kernel] = rel_diff(out_one.float(), out_p.float())[0]
    return dict(local=local, stream=rel_diff(model.unembed_last(hk).float(),
                                             model.unembed_last(hp).float())[0],
                by_kernel=by_kernel, rerouted=rerouted, routed=routed)


def describe(cfg, n_params: int, of_layers: int | None = None) -> str:
    """The served model's layers and size, for phase 6's, 6c's and 6e's
    lines (``of_layers``: the published depth, where it was cut)."""
    from repro_torch.models.layers import gqa_mode

    depth = f"{cfg.num_layers}" + (f" of {of_layers}" if of_layers else "")
    if cfg.family == "hybrid":
        n_groups, group, trailing = cfg.hybrid_counts
        layers = (f"{depth} layers ({n_groups} groups of {group} Mamba-2 "
                  f"+ the shared block, {trailing} trailing)")
    elif cfg.family == "moe":
        layers = (f"{depth} layers ({cfg.num_experts} experts, top "
                  f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor})")
    else:
        layers = (f"{depth} layers ({cfg.family}: {cfg.eff_heads} heads on "
                  f"{cfg.eff_kv_heads} KV heads of {cfg.resolved_head_dim}, GQA mode "
                  f"{gqa_mode(cfg)}, {cfg.frontend_tokens} frontend positions)")
    return (f"{cfg.name}: {layers}, d_model {cfg.d_model}, vocab {cfg.eff_vocab}, "
            f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}")


def frontend_embeds(cfg, device):
    """A vlm/audio config's [LM_BATCH, frontend_tokens, d] patch or frame
    embeddings, f32 normals from numpy (seed 0), on the card; None for the
    other families."""
    if not cfg.frontend_tokens:
        return None
    e = np.random.default_rng(0).standard_normal(
        (LM_BATCH, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(e).to(device)


@torch.inference_mode()
def serving(device, arch: str = LM_ARCH,
            prefill_launches: dict = LM_PREFILL_LAUNCHES, layers: int | None = None,
            decode_steps: int = LM_DECODE, padded: int | None = None,
            keep: int = 0) -> dict:
    """Phase 6 (Zamba2-7B), 6c (granite-moe-3b-a800m) and 6e (a), (c) and
    (d) (musicgen-medium; its ``padded`` variant; internvl2-76b with its
    depth cut to ``layers``): ``arch`` at full width, weights from the
    port's seeded init, a vlm or
    audio config's prompts with their frontend embeddings in the first
    positions (``frontend_embeds``; the slot server's prompts are tokens,
    as the reference's). In f32: the prefill's
    last-position logits through the kernels against the plain versions,
    and each block against them from the same input. In bf16 (the served
    dtype): the prefill of 4 prompts of 2048 tokens (make_lm_tokens, seed
    0) with cache_len 2048 + 32, read on its own launch counts
    (``prefill_launches``); each block against the plain versions;
    ``decode_steps`` greedy decode steps from the caches, read on their own
    counts; then the slot server with the reference serve.py's defaults
    (its requests' tokens are returned). An MoE model's plain runs are held
    to the kernel runs' routing (``plain_pinned``). ``keep``: the bf16
    prefill's logits and the first ``keep`` decode steps' are kept on the
    host (``out["kept"]``, for phase 6f (a))."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.decoder import build_model

    cfg = get_arch(arch)
    if padded:
        cfg = cfg.padded(padded)
    of_layers = None
    if layers:
        cfg, of_layers = dataclasses.replace(cfg, num_layers=layers), cfg.num_layers
    kernels = tuple(prefill_launches)
    tokens = torch.from_numpy(make_lm_tokens(LM_BATCH, LM_PROMPT, cfg.vocab_size,
                                             seed=0)).to(device)
    embeds = frontend_embeds(cfg, device)
    cache_len = LM_PROMPT + decode_steps

    model = build_model(dataclasses.replace(cfg, dtype="float32"), device=device,
                        seed=0)
    prefill = make_prefill_step(model, cache_len)
    with routing("record") as rec:
        logits = prefill(tokens, embeds)[0]
    logits_p, rerouted32, routed32 = plain_pinned(lambda: prefill(tokens, embeds)[0],
                                                  rec.record)
    rel32, err32 = rel_diff(logits, logits_p)
    print(f"  float32 prefill logits, kernels vs plain: rel {rel32:.3e} (tol "
          f"{LM_LOGITS_TOLERANCE_F32:.0e}) abs {err32:.3e}, largest |logit| "
          f"{float(logits_p.abs().max()):.3f}, same argmax in "
          f"{int((logits.argmax(-1) == logits_p.argmax(-1)).sum())}/{LM_BATCH}; "
          f"token-layers routed differently {rerouted32} of {routed32}"
          + (" (the plain run replays the kernel run's routing)" if rerouted32 else ""),
          flush=True)
    if not rel32 <= LM_LOGITS_TOLERANCE_F32:
        raise AssertionError(f"float32 prefill logits through the kernels are "
                             f"{rel32:.3e} from the plain versions' (> "
                             f"{LM_LOGITS_TOLERANCE_F32})")
    del prefill, logits, logits_p
    blocks32 = blockwise_prefill(model, tokens, kernels, embeds)
    local32 = blocks32["local"]
    worst32 = int(np.argmax(local32))
    print(f"  float32 blocks, kernels vs plain from the same input: largest rel "
          f"{local32[worst32]:.3e} (block {worst32}; tol "
          f"{LM_BLOCK_TOLERANCE_F32:.0e}); that block with only one kernel "
          f"run by its kernel: {blocks32['by_kernel']}; token-layers routed "
          f"differently {blocks32['rerouted']} of {blocks32['routed']}; the two "
          f"streams' last logits part by rel {blocks32['stream']:.3e}", flush=True)
    if not local32[worst32] <= LM_BLOCK_TOLERANCE_F32:
        raise AssertionError(f"float32 block {worst32} through the kernels is "
                             f"{local32[worst32]:.3e} from the plain versions' "
                             f"(> {LM_BLOCK_TOLERANCE_F32:.0e}); with one "
                             f"kernel at a time: {blocks32['by_kernel']}")
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=0)
    torch.cuda.synchronize(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {describe(cfg, n_params, of_layers)} "
          f"({torch.cuda.memory_allocated(device) / 2**30:.2f} GiB), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prefill = make_prefill_step(model, cache_len)
    serve_step = make_serve_step(model)

    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    logits, caches = prefill(tokens, embeds)
    torch.cuda.synchronize(device)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    want = {k: prefill_launches.get(k, 0) for k in launches}
    print(f"  prefill launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"prefill launches {launches}, expected {want}")
    if logits.shape != (LM_BATCH, cfg.eff_vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(logits.isfinite().all())}")
    del caches, logits
    prefill_ms = host_ms(lambda: prefill(tokens, embeds), device)
    with plain_lm_kernels():
        plain_prefill_ms = host_ms(lambda: prefill(tokens, embeds), device, repeats=1)
    split = None
    if cfg.family == "moe":
        split = dict(prefill=kernel_split(lambda: prefill(tokens)),
                     expert_products_ms_a_layer=expert_products_ms(model, device))
        print(f"  prefill device time by kind (ms, torch.profiler): {split['prefill']}; "
              f"one layer's expert products alone {split['expert_products_ms_a_layer']:.3f} "
              f"ms (x {cfg.num_layers} layers)", flush=True)

    _build.reset_launches()
    blocks = blockwise_prefill(model, tokens, kernels, embeds)
    local = blocks["local"]
    worst = int(np.argmax(local))
    print(f"  bf16 blocks, kernels vs plain from the same input: largest rel "
          f"{local[worst]:.3e} (block {worst}; tol {LM_BLOCK_TOLERANCE_BF16:.2e}; "
          f"with only one kernel run by its kernel: {blocks['by_kernel']}); "
          f"token-layers routed differently {blocks['rerouted']} of "
          f"{blocks['routed']}; the two streams' last logits part by rel "
          f"{blocks['stream']:.3e} (not held: random layers amplify bf16 steps)",
          flush=True)
    if not local[worst] <= LM_BLOCK_TOLERANCE_BF16:
        raise AssertionError(f"block {worst} through the kernels is "
                             f"{local[worst]:.3e} from the plain versions' (> "
                             f"{LM_BLOCK_TOLERANCE_BF16:.2e})")
    torch.cuda.empty_cache()

    logits, caches = prefill(tokens, embeds)
    kept = {"prefill": logits.cpu(), "decode": []}
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
    # peak memory: the kernel prefill's (above) and the decode steps',
    # not the plain versions' in between
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    step_ms, generated = [], [tok]
    for i in range(decode_steps):
        pos = torch.full((LM_BATCH, 1), LM_PROMPT + i, dtype=torch.int32,
                         device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, caches = serve_step(caches, tok, pos)
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
        tok.cpu()
        if i < keep:
            kept["decode"].append(logits.cpu())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(tok)
        if not bool(logits.isfinite().all()):
            raise AssertionError(f"decode step {i}: logits not finite")
    decode_launches = dict(_build.LAUNCHES)
    peak = max(peak, torch.cuda.max_memory_allocated(device))
    if split is not None:
        pos = torch.full((LM_BATCH, 1), LM_PROMPT + decode_steps, dtype=torch.int32,
                         device=device)
        split["decode_step"] = kernel_split(lambda: serve_step(caches, tok, pos))
        print(f"  one decode step's device time by kind (ms): {split['decode_step']}",
              flush=True)
    print(f"  decode launches over {decode_steps} steps {decode_launches}; first "
          f"prompt's tokens {torch.cat(generated, 1)[0, :12].tolist()}", flush=True)
    if any(decode_launches.values()):
        raise AssertionError(f"decode launched {decode_launches}; it runs "
                             "neither kernel")
    out = dict(launches=launches, decode_launches=decode_launches,
               prefill_ms=prefill_ms,
               plain_prefill_ms=plain_prefill_ms, decode_ms=step_ms,
               peak_gib=peak / 2**30, f32_logits_rel=rel32,
               f32_block_rel_max=local32[worst32], f32_worst_block=worst32,
               f32_worst_block_by_kernel=blocks32["by_kernel"],
               f32_rerouted=(rerouted32, routed32),
               f32_block_rerouted=(blocks32["rerouted"], blocks32["routed"]),
               bf16_block_rel_max=local[worst], bf16_stream_logits_rel=blocks["stream"],
               bf16_block_rerouted=(blocks["rerouted"], blocks["routed"]),
               device_split=split)
    print(f"  prefill {LM_BATCH}x{LM_PROMPT}: {np.median(prefill_ms):.1f} ms "
          f"(runs {[round(t, 1) for t in prefill_ms]}; plain versions "
          f"{plain_prefill_ms[0]:.1f} ms), "
          f"{LM_BATCH * LM_PROMPT / np.median(prefill_ms) * 1e3:.0f} tokens/s; "
          f"decode step (batch {LM_BATCH}, host clock, ends in the argmax read) "
          f"median {np.median(step_ms[1:]):.2f} ms (first {step_ms[0]:.1f} ms); "
          f"peak memory {out['peak_gib']:.2f} GiB", flush=True)
    del caches, logits
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
                    SERVE_NEW) for i in range(SERVE_REQUESTS)]
    _build.reset_launches()
    srv = SlotServer(model, batch_slots=SERVE_SLOTS,
                     cache_len=SERVE_PROMPT + SERVE_NEW + 1, device=device)
    stats = srv.run(reqs)
    server_launches = dict(_build.LAUNCHES)
    print(f"  slot server: {len(reqs)} requests, {SERVE_SLOTS} slots, "
          f"{SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens: "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f} s over "
          f"{stats['steps']} steps ({stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.1f} ms/step), launches "
          f"{server_launches}; request 0: {reqs[0].out}", flush=True)
    if not all(r.done and len(r.out) == SERVE_NEW for r in reqs):
        raise AssertionError("slot server: unfinished requests "
                             f"{[(r.rid, r.done, len(r.out)) for r in reqs]}")
    if any(server_launches.values()):
        raise AssertionError(f"the slot server launched {server_launches}")
    out["server"] = stats
    out["server_launches"] = server_launches
    out["server_tokens"] = [r.out for r in reqs]
    if keep:
        out["kept"] = kept
    del model, srv
    torch.cuda.empty_cache()
    return out


def cache_bytes(caches) -> int:
    """Bytes of a KV group's k, v and (int8 cache) scales: pos and idx are
    the same both ways."""
    return nbytes(*(t for name, t in caches.tree.items() if name not in ("pos", "idx")))


def teacher_forced_decode(model, caches, tokens, device) -> tuple[list, list]:
    """LM_DECODE decode steps from ``caches`` feeding the prompts' first
    tokens (teacher forcing, positions 0..): (ms a step on the host clock,
    each ending in the argmax read; the argmaxes [B] of each step)."""
    step_ms, argmax = [], []
    for i in range(LM_DECODE):
        pos = torch.full((LM_BATCH, 1), i, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits = model.decode_step(caches, tokens[:, i:i + 1], pos)[0]
        top = logits[:, :model.cfg.vocab_size].argmax(-1).cpu()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        argmax.append(top)
        if not bool(logits.isfinite().all()):
            raise AssertionError(f"decode step {i}: logits not finite")
    return step_ms, argmax


@torch.inference_mode()
def kv_quant_serving(device, served: dict) -> dict:
    """Phase 6e (b): musicgen-medium at full width in bf16 with the int8 KV
    cache (``kv_quant``; the same seeded weights as (a)). A prefill's caches
    stay bf16 (the reference's pad_kv); ``init_caches`` gives int8 k, v and
    f32 scales, whose bytes are printed against the bf16 cache's; LM_DECODE
    teacher-forced decode steps from int8 and from bf16 caches of cache_len
    2048 + 32 (ms a step both ways, the share of equal argmaxes); then the
    slot server on int8 caches: every request finishes, nothing launches,
    and the share of its greedy tokens equal to (a)'s server's is recorded
    (not held: int8 rounding may move an argmax)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.decoder import build_model

    cfg = dataclasses.replace(get_arch(AUDIO_ARCH), kv_quant=True)
    model = build_model(cfg, device=device, seed=0)
    tokens = torch.from_numpy(make_lm_tokens(LM_BATCH, LM_PROMPT, cfg.vocab_size,
                                             seed=0)).to(device)
    embeds = frontend_embeds(cfg, device)
    cache_len = LM_PROMPT + LM_DECODE
    _build.reset_launches()
    logits, caches = model.prefill(tokens, embeds, cache_len=cache_len)
    prefill_dtypes = {name: str(t.dtype)[6:] for name, t in caches.tree.items()}
    if set(caches.tree) != {"k", "v", "pos", "idx"} or caches.tree["k"].dtype != model.dtype:
        raise AssertionError(f"a kv_quant prefill's caches: {prefill_dtypes}; "
                             "expected model-dtype k and v, no scales")
    if dict(_build.LAUNCHES) != {k: AUDIO_PREFILL_LAUNCHES.get(k, 0)
                                 for k in _build.LAUNCHES}:
        raise AssertionError(f"kv_quant prefill launches {dict(_build.LAUNCHES)}")
    del logits, caches

    int8 = model.init_caches(LM_BATCH, cache_len, device)
    tree = int8.tree
    if not (tree["k"].dtype == tree["v"].dtype == torch.int8
            and tree["k_scale"].dtype == tree["v_scale"].dtype == torch.float32):
        raise AssertionError("kv_quant init_caches: "
                             f"{ {n: t.dtype for n, t in tree.items()} }")
    bf16 = model._caches(LM_BATCH, cache_len, quant=False)
    ratio = cache_bytes(int8) / cache_bytes(bf16)
    # a head and slot: hd int8 codes and one f32 scale against hd values
    hd, size = cfg.resolved_head_dim, bf16.tree["k"].element_size()
    print(f"  kv_quant: a prefill's caches stay {prefill_dtypes}; init_caches int8 "
          f"k, v + f32 scales {cache_bytes(int8) / 2**20:.1f} MiB against "
          f"{str(model.dtype)[6:]} k, v {cache_bytes(bf16) / 2**20:.1f} MiB "
          f"({ratio:.4f}; by the shapes ({hd} + 4)/{size * hd} = "
          f"{(hd + 4) / (size * hd):.4f})", flush=True)
    if abs(ratio - (hd + 4) / (size * hd)) > 1e-9:
        raise AssertionError(f"int8 cache bytes ratio {ratio}")

    _build.reset_launches()
    q_ms, q_top = teacher_forced_decode(model, int8, tokens, device)
    b_ms, b_top = teacher_forced_decode(model, bf16, tokens, device)
    decode_launches = dict(_build.LAUNCHES)
    if any(decode_launches.values()):
        raise AssertionError(f"decode launched {decode_launches}")
    same = float(torch.stack(q_top).eq(torch.stack(b_top)).float().mean())
    print(f"  {LM_DECODE} teacher-forced decode steps (batch {LM_BATCH}, cache_len "
          f"{cache_len}, host clock): int8 median {np.median(q_ms[1:]):.2f} ms, bf16 "
          f"median {np.median(b_ms[1:]):.2f} ms a step (first {q_ms[0]:.1f} / "
          f"{b_ms[0]:.1f} ms); equal argmaxes {same:.3f} (recorded)", flush=True)
    del int8, bf16

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
                    SERVE_NEW) for i in range(SERVE_REQUESTS)]
    _build.reset_launches()
    srv = SlotServer(model, batch_slots=SERVE_SLOTS,
                     cache_len=SERVE_PROMPT + SERVE_NEW + 1, device=device)
    if srv.caches.tree["k"].dtype != torch.int8:
        raise AssertionError("the kv_quant slot server's caches are not int8")
    stats = srv.run(reqs)
    server_launches = dict(_build.LAUNCHES)
    want = served["server_tokens"]
    agree = float(np.mean([a == b for r, w in zip(reqs, want) for a, b in zip(r.out, w)]))
    print(f"  slot server on int8 caches: {stats['tokens']} tokens in "
          f"{stats['wall_s']:.2f} s over {stats['steps']} steps "
          f"({stats['wall_s'] / stats['steps'] * 1e3:.1f} ms/step, bf16 "
          f"{served['server']['wall_s'] / served['server']['steps'] * 1e3:.1f}); "
          f"greedy tokens equal to (a)'s {agree:.3f} (recorded); launches "
          f"{server_launches}", flush=True)
    if not all(r.done and len(r.out) == SERVE_NEW for r in reqs):
        raise AssertionError("kv_quant slot server: unfinished requests")
    if any(server_launches.values()):
        raise AssertionError(f"the kv_quant slot server launched {server_launches}")
    del model, srv
    torch.cuda.empty_cache()
    return dict(prefill_cache_dtypes=prefill_dtypes, cache_bytes_ratio=ratio,
                decode_ms_int8=q_ms, decode_ms_bf16=b_ms, equal_argmax=same,
                decode_launches=decode_launches, server=stats,
                server_launches=server_launches, server_tokens_equal=agree)


@torch.inference_mode()
def padded_heads_are_noops(device) -> dict:
    """Phase 6e (c): musicgen-medium.padded(GATHER_SHARDS) in f32 at full
    width, in the gather GQA mode: the prefill's last logits through the
    kernels against the same weights with the padded query heads' ``wq``
    columns zeroed, within NOOP_TOLERANCE of the largest |logit| (their
    outputs meet zero ``wo`` rows: the reference's
    test_padded_heads_are_noops at full width)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.decoder import build_model
    from repro_torch.models.layers import gqa_mode

    cfg = dataclasses.replace(get_arch(AUDIO_ARCH).padded(GATHER_SHARDS),
                              dtype="float32")
    if gqa_mode(cfg) != "gather":
        raise AssertionError(f"{cfg.name}.padded({GATHER_SHARDS}): GQA mode "
                             f"{gqa_mode(cfg)}, expected gather")
    tokens = torch.from_numpy(make_lm_tokens(LM_BATCH, LM_PROMPT, cfg.vocab_size,
                                             seed=0)).to(device)
    embeds = frontend_embeds(cfg, device)
    model = build_model(cfg, device=device, seed=0)
    prefill = make_prefill_step(model, LM_PROMPT)
    logits = prefill(tokens, embeds)[0]
    hd, Ht = cfg.resolved_head_dim, cfg.num_heads
    for block in model.blocks:
        block.attn["wq"][:, Ht * hd:] = 0
    rel, err = rel_diff(logits, prefill(tokens, embeds)[0])
    print(f"  float32 prefill logits against the padded heads' wq columns zeroed: "
          f"rel {rel:.3e} (tol {NOOP_TOLERANCE:.0e}) abs {err:.3e}", flush=True)
    if not rel <= NOOP_TOLERANCE:
        raise AssertionError(f"padded heads are no no-op: {rel:.3e}")
    del model, prefill, logits
    torch.cuda.empty_cache()
    return dict(rel=rel, abs=err)


def phase_6e_launches(features: dict, name: str) -> dict:
    """A kernel's launches in each run of phase 6e, for its kernels row."""
    a, q, g, v = (features[k] for k in ("audio", "kv_quant", "gather", "vlm"))
    pad = f"{AUDIO_ARCH}.padded({GATHER_SHARDS})"
    return {f"{AUDIO_ARCH} prefill": a["launches"][name],
            f"{AUDIO_ARCH} decode ({LM_DECODE} steps)": a["decode_launches"][name],
            f"{AUDIO_ARCH} slot server": a["server_launches"][name],
            f"{AUDIO_ARCH} kv_quant decode ({LM_DECODE} steps, int8 and bf16)":
                q["decode_launches"][name],
            f"{AUDIO_ARCH} kv_quant slot server": q["server_launches"][name],
            f"{pad} prefill": g["launches"][name],
            f"{pad} decode ({GATHER_DECODE} steps)": g["decode_launches"][name],
            f"{pad} slot server": g["server_launches"][name],
            f"{VLM_ARCH} ({VLM_LAYERS} layers) prefill": v["launches"][name],
            f"{VLM_ARCH} decode ({VLM_DECODE} steps)": v["decode_launches"][name],
            f"{VLM_ARCH} slot server": v["server_launches"][name]}


def last_features(device) -> dict:
    """Phase 6e: (a) musicgen-medium with its frame embeddings, (b) with the
    int8 KV cache, (c) padded(16) in the gather GQA mode, (d) internvl2-76b
    with 4 of 80 layers and its patch embeddings."""
    out, t0 = {}, time.perf_counter()
    print(f"  (a) {AUDIO_ARCH} at full width, {LM_BATCH} prompts of {LM_PROMPT} "
          "tokens, the first 512 positions frame embeddings", flush=True)
    out["audio"] = serving(device, AUDIO_ARCH, AUDIO_PREFILL_LAUNCHES)
    free_memory()
    print(f"  (b) {AUDIO_ARCH} with kv_quant (int8 KV cache)", flush=True)
    out["kv_quant"] = kv_quant_serving(device, out["audio"])
    free_memory()
    print(f"  (c) {AUDIO_ARCH}.padded({GATHER_SHARDS}) in the gather GQA mode",
          flush=True)
    out["gather"] = serving(device, AUDIO_ARCH, AUDIO_PREFILL_LAUNCHES,
                            decode_steps=GATHER_DECODE, padded=GATHER_SHARDS)
    free_memory()
    out["gather"]["noop"] = padded_heads_are_noops(device)
    free_memory()
    print(f"  (d) {VLM_ARCH} at full width, {VLM_LAYERS} of 80 layers, "
          "the first 1024 positions patch embeddings", flush=True)
    out["vlm"] = serving(device, VLM_ARCH, VLM_PREFILL_LAUNCHES, layers=VLM_LAYERS,
                         decode_steps=VLM_DECODE)
    free_memory()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6e took {out['seconds']:.1f} s", flush=True)
    return out


def profile_rounds(clients, device, channel=None, rounds: int = 3) -> None:
    """``--profile``: torch.profiler over a few paper-scale f64 rounds after
    two warm-up rounds on ``channel``; prints device time by kernel (and the
    ``fl.uplink`` scope) and the device's busy share of the wall time (a
    diagnostic, not a phase of the smoke run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AlgoHParams, init_state, make_round_fn
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    round_fn = make_round_fn("fedosaa_svrg", prob,
                             AlgoHParams(eta=ETA, local_epochs=L_EPOCHS),
                             channel, device=device)
    state = init_state(prob, device=device, channel=channel,
                       algo="fedosaa_svrg")
    for _ in range(2):
        state, m = round_fn(state)
    torch.cuda.synchronize(device)
    # the card's activity only: the host's ~100k op events would take the
    # profiler tens of seconds to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, m = round_fn(state)
            float(m.loss)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # kernels only: an operator's row repeats its kernels' time, and a
    # record_function scope's device row ("fl.uplink") spans its kernels
    # and the gaps between them
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not e.key.startswith("fl.")]
    busy_us = sum(getattr(e, key) for e in kernels)
    launched = sum(e.count for e in kernels)
    print(events.table(sort_by=key, row_limit=25), flush=True)
    for e in events:
        if e.key.startswith("fl."):
            where, us = (("device clock, first to last kernel, gaps included",
                          getattr(e, key)) if e.device_type == cuda else
                         ("host", e.cpu_time_total))
            print(f"  {e.key} ({where}): {us / 1e3 / rounds:.3f} ms/round",
                  flush=True)
    # the device operations inside each fl.* scope's span on the device
    # clock (a kernel launched through ctypes belongs to no torch op)
    on_device = [e for e in prof.events() if e.device_type == cuda]
    for scope in sorted({e.name for e in on_device if e.name.startswith("fl.")}):
        spans = [e.time_range for e in on_device if e.name == scope]
        inside = [e for e in on_device if not e.name.startswith("fl.")
                  and any(r.start <= e.time_range.start and e.time_range.end <= r.end
                          for r in spans)]
        print(f"  {scope}: {len(inside) / rounds:.1f} device kernels/round "
              f"inside it, {sum(e.time_range.elapsed_us() for e in inside) / 1e3 / rounds:.4f} "
              f"ms/round of their device time", flush=True)
    print(f"  profile [{channel or 'identity'}]: {rounds} rounds, wall "
          f"{wall * 1e3 / rounds:.3f} ms/round, device busy "
          f"{busy_us / 1e3 / rounds:.3f} ms/round "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the wall), "
          f"{launched / rounds:.1f} device kernels/round", flush=True)


def profile_engine(clients, device, channel=None, chunks: int = 3) -> None:
    """``--profile``: torch.profiler over ``chunks`` replays of a warm
    paper-scale f64 engine runner (chunks of PAPER_CHUNK rounds, each
    replay ending in its one read) on ``channel``: device time by kernel,
    the device's busy time a round and its share of the wall (a
    diagnostic, not a phase of the smoke run). A replayed graph shows its
    kernels under ``cudaGraphLaunch``, without the ``fl.*`` scopes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  make_round_fn)
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    round_fn = make_round_fn("fedosaa_svrg", prob,
                             AlgoHParams(eta=ETA, local_epochs=L_EPOCHS),
                             channel, device=device)
    state = init_state(prob, device=device, channel=channel,
                       algo="fedosaa_svrg")
    runner = make_chunk_runner(round_fn, PAPER_CHUNK)
    for _ in range(2):
        state, *_ = runner(state, PAPER_CHUNK)
    # the card's activity only: the host's ~100k op events would take the
    # profiler tens of seconds to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, *_ = runner(state, PAPER_CHUNK)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not e.key.startswith("fl.")]
    busy_us = sum(getattr(e, key) for e in kernels)
    launched = sum(e.count for e in kernels)
    rounds = chunks * PAPER_CHUNK
    print(events.table(sort_by=key, row_limit=25), flush=True)
    print(f"  profile engine [{channel or 'identity'}]: {chunks} replays of "
          f"{PAPER_CHUNK} rounds, wall {wall * 1e3 / rounds:.3f} ms/round, "
          f"device busy {busy_us / 1e3 / rounds:.3f} ms/round "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the wall), "
          f"{launched / rounds:.1f} device kernels/round", flush=True)


# ---------------------------------------------------------------------------
# phase 6b: federated training (core/lm.py, models/mlp.py, launch/)
# ---------------------------------------------------------------------------

#: (a) FL at full width: smollm-135m in float32 (its config is bf16, which
#: the AA kernels do not read yet), 4 clients of 4 documents of 128 tokens
#: (make_lm_tokens, seed 0), L=3, 3 rounds by the loop
FL_LM_ARCH, FL_LM_CLIENTS, FL_LM_DOCS, FL_LM_SEQ = "smollm-135m", 4, 4, 128
FL_LM_L, FL_LM_ROUNDS, FL_LM_D = 3, 3, 162_826_560
#: fl_train's step; it is the reduced config's, and at full width FedSVRG's
#: local steps diverge on it (the loss rises in round 2): those runs are
#: printed, and the gated runs take FL_LM_ETA_GATED
FL_LM_ETA, FL_LM_ETA_GATED = 0.3, 0.05
#: (b) the old one-block-per-client Gram design beside the split one here
GRAM_BLOCK_D = 1 << 24
#: (c) the engine on the reduced config: rounds, chunk
FL_ENGINE_ROUNDS, FL_ENGINE_CHUNK = 4, 2
#: (e) launch/train.py at full width: steps, batch, sequence length
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 4, 256
#: the keys of each algorithm's entry in the reference fl_train's --out
FL_TRAIN_KEYS = {"loss_curve", "grad_norm_curve", "gram_cond_curve",
                 "comm_bytes", "channel", "wall_s", "faults", "async"}
#: (f) Fig. 8's quick configuration (benchmarks/fig8_nn.py), from the numpy
#: He init of ``fig8_init``, and the JAX reference's final loss and
#: training accuracy from the same init on the CPU
#: (scripts/reference_fig8_mlp.py)
FIG8_N, FIG8_K, FIG8_ETA, FIG8_L, FIG8_ROUNDS = 4_000, 10, 0.1, 10, 15
FIG8_REFERENCE = {
    ("mlp1", "fedsvrg"): (0.0039002588018774986, 1.0),
    ("mlp1", "fedosaa_svrg"): (5.769904964836314e-05, 1.0),
    ("mlp3", "fedsvrg"): (0.0013435884611681104, 1.0),
    ("mlp3", "fedosaa_svrg"): (3.457676211837679e-05, 1.0)}
#: MLP1's gates: FedSVRG's final loss within this relative distance of the
#: reference's, FedOSAA-SVRG's within this factor of it either way (its
#: f32 AA solve at Gram conditioning 1e3-1e5 makes the curve chaotic past
#: round 3: on the CPU the port's own tree and kernel paths end 13% apart),
#: both accuracies within this share of the reference's
FIG8_SVRG_RTOL, FIG8_OSAA_FACTOR, FIG8_ACC_TOL = 1e-2, 2.0, 0.01


class LaunchRows:
    """A MetricsSink that notes the launch counters at the run's open and at
    each emit, and keeps the rows: ``per_round`` is each round's launches
    in the per-round loop (each emit is one round there)."""

    def __init__(self):
        self.marks, self.rows = [], []

    def _mark(self):
        from repro_torch.kernels import _build

        self.marks.append(dict(_build.LAUNCHES))

    def open(self, header):
        self._mark()

    def emit(self, rows):
        self.rows.extend(rows)
        self._mark()

    def close(self, footer):
        pass

    @property
    def per_round(self) -> list[dict]:
        return [{k: b[k] - a[k] for k in a if b[k] - a[k]}
                for a, b in zip(self.marks, self.marks[1:])]


def lm_round_launches(algo: str, int8: bool) -> dict:
    """One LM round's launches: the Gram pass and the fused AA step once in
    a FedOSAA round; two fused uplinks on the int8 wire; never the
    trajectory (the LM has no linear design: autodiff) nor the serving
    kernels (training runs the reference's jnp attention and SSD paths)."""
    want = {k: v for k, v in expected_launches(1, int8, algo).items() if v}
    want.pop("trajectory", None)
    return want


def profile_lm_round(prob, hp, device) -> dict:
    """Phase 6b (a): one warm FedOSAA-SVRG round at full width under
    torch.profiler: its kernels, their own device time (the ``fl.*``
    scopes' ranges left out) and the top kernels by it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import init_state, make_round_fn

    rf = make_round_fn("fedosaa_svrg", prob, hp, device=device)
    state, m = rf(init_state(prob, device=device, algo="fedosaa_svrg"))
    float(m.loss)
    # the card's activity only: the host's ~100k op events would take the
    # profiler tens of seconds to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = rf(state)
        float(m.loss)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("fl.")]
    key = ("self_device_time_total" if events and
           hasattr(events[0], "self_device_time_total") else "self_cuda_time_total")
    top = sorted(events, key=lambda e: -getattr(e, key))[:8]
    out = dict(profiled_wall_ms=wall * 1e3,
               kernel_ms=sum(getattr(e, key) for e in events) / 1e3,
               kernels=sum(e.count for e in events),
               top=[(e.key[:70], getattr(e, key) / 1e3, e.count) for e in top])
    print(f"  profiled warm FedOSAA-SVRG round: {out['kernels']} kernels, "
          f"{out['kernel_ms']:.1f} ms of kernel time in {out['profiled_wall_ms']:.1f} ms "
          f"of profiled wall; top: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in out["top"]), flush=True)
    del state, rf
    return out


def lm_full_width(device, arch: str = FL_LM_ARCH, layers: int | None = None,
                  clients: int = FL_LM_CLIENTS, d_want: int = FL_LM_D,
                  etas: tuple = (FL_LM_ETA_GATED, FL_LM_ETA), prefix: str = "lm_",
                  profile: bool = True) -> tuple[dict, object]:
    """Phase 6b (a) and 6d (a): FedOSAA-SVRG and FedSVRG over ``arch`` at
    full width in f32 (its depth cut to ``layers``), ``clients`` of
    FL_LM_DOCS documents of FL_LM_SEQ tokens, L=FL_LM_L, FL_LM_ROUNDS rounds
    by the loop, at each step of ``etas`` (FL_LM_ETA_GATED's runs gated):
    per round its launches, ms, the AA step's used/clipped columns and Gram
    conditioning; tokens a second and peak memory. Returns the runs and the
    problem."""
    from repro_torch.configs import get_arch
    from repro_torch.core import AAConfig, AlgoHParams, run_federated
    from repro_torch.core.lm import make_lm_clients, make_lm_problem
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.models.decoder import build_model

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, device=device, seed=0)
    toks = make_lm_tokens(clients * FL_LM_DOCS, FL_LM_SEQ, cfg.vocab_size, seed=0)
    prob = make_lm_problem(model, make_lm_clients(toks, clients, device=device))
    d = sum(p.numel() for p in model.parameters())
    if d != d_want:
        raise AssertionError(f"{cfg.name} ({cfg.num_layers} layers) has {d} "
                             f"parameters, expected {d_want}")
    tokens_per_round = clients * FL_LM_DOCS * FL_LM_SEQ * (FL_LM_L + 1)
    out = {}
    for eta in etas:
        hp = AlgoHParams(eta=eta, local_epochs=FL_LM_L,
                         aa=AAConfig(tikhonov=1e-8, damping=1.0))
        for algo in ("fedosaa_svrg", "fedsvrg"):
            gated = eta == FL_LM_ETA_GATED
            name = f"{prefix}{algo}" + ("" if gated else f"_eta{eta}")
            sink = LaunchRows()
            free_memory()
            mark = memory_mark(device)
            _build.reset_launches()
            h = run_federated(prob, algo, hp, FL_LM_ROUNDS, device=device, sinks=[sink])
            launches = dict(_build.LAUNCHES)
            designs = {k: dict(v) for k, v in _build.DESIGN_LAUNCHES.items()}
            peak = torch.cuda.max_memory_allocated(device) - mark
            ms = per_round_ms(h.wall_time)
            steady = float(np.median(ms[1:]))
            out[name] = dict(
                eta=eta, loss=h.loss.tolist(), ms_per_round=ms.tolist(),
                steady_ms=steady, tokens_per_s=tokens_per_round / steady * 1e3,
                peak_gib=peak / 2 ** 30, launches=launches,
                designs=designs["trajectory"], gram_designs=designs["gram"],
                per_round=sink.per_round,
                aa_used=[r["aa_used_min"] for r in sink.rows],
                aa_clipped=[r["aa_clipped_max"] for r in sink.rows],
                gram_cond=[r["gram_cond_max"] for r in sink.rows])
            r = out[name]
            print(f"  {name} (eta {eta}, d={d}): loss {[f'{v:.4f}' for v in r['loss']]}; ms a "
                  f"round {[f'{v:.1f}' for v in ms]} (the first warms the card up), "
                  f"{r['tokens_per_s']:.0f} tokens/s at the median of the others "
                  f"({tokens_per_round} tokens a round through forward and backward); "
                  f"peak {r['peak_gib']:.2f} GiB above the model and data; launches a "
                  f"round {r['per_round']}, Gram by design {r['gram_designs']}; AA "
                  f"used {r['aa_used']} clipped {r['aa_clipped']} Gram cond "
                  f"{[f'{v:.3e}' for v in r['gram_cond']]}", flush=True)
            want = lm_round_launches(algo, int8=False)
            if any(pr != want for pr in r["per_round"]) or len(r["per_round"]) != FL_LM_ROUNDS:
                raise AssertionError(f"{name}: launches a round {r['per_round']}, "
                                     f"expected {want} in each of {FL_LM_ROUNDS}")
            if algo.startswith("fedosaa") and r["gram_designs"]["split"] != FL_LM_ROUNDS:
                raise AssertionError(f"{name}: the Gram pass ran {r['gram_designs']}; "
                                     "the split design every round at this width")
            if not np.all(np.isfinite(h.loss)):
                raise AssertionError(f"{name}: non-finite loss {h.loss.tolist()}")
            if gated and not h.loss[-1] < h.loss[0]:
                raise AssertionError(f"{name}: the loss did not fall: {h.loss.tolist()}")
            del h
            if profile and gated and algo == "fedosaa_svrg":
                free_memory()
                prof = profile_lm_round(prob, hp, device)
                prof["busy_share"] = prof["kernel_ms"] / r["steady_ms"]
                r["profile"] = prof
                print(f"  kernel time over the unprofiled warm round's "
                      f"{r['steady_ms']:.1f} ms: {prof['busy_share']:.1%}", flush=True)
    del model
    free_memory()
    return out, prob


def check_gram_wide(device, floor: float) -> dict:
    """Phase 6b (b): the Gram pass at (a)'s shape (K=4, m=3, d=162,826,560,
    f32; random Y and g, seeded) in the split design against ``gram_ref``
    (each output over the sum of its terms' magnitudes), a rerun
    bit-identical, the Gram matrix exactly symmetric; timed beside its
    bound (Y and g read once), the plain version and one torch.bmm; the
    one-block-per-client design at d=2^24 timed beside the split one
    there, the two within the tolerance of each other."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.anderson import flat_gram
    from repro_torch.kernels.anderson.ops import gram_parts
    from repro_torch.kernels.anderson.ref import gram_ref

    gen = torch.Generator(device=device).manual_seed(11)
    K, m = FL_LM_CLIENTS, FL_LM_L
    out = {}
    for label, d in (("lm", FL_LM_D), ("block_vs_split", GRAM_BLOCK_D)):
        y = torch.randn((K, m, d), generator=gen, device=device)
        g = torch.randn((d,), generator=gen, device=device)
        _build.reset_launches()
        gk, ygk = flat_gram(y, g)
        designs = dict(_build.DESIGN_LAUNCHES["gram"])
        gp, ygp = gram_ref(y, g)
        ya = y.abs()
        errs = [rel_diff(gk, gp, ya @ ya.transpose(1, 2)),
                rel_diff(ygk, ygp, (ya @ g.abs().unsqueeze(-1)).squeeze(-1))]
        del ya
        r = dict(shape=f"K={K} m={m} d={d} float32",
                 parts=gram_parts(K, m, d, torch.cuda.get_device_properties(device)
                                  .multi_processor_count),
                 rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
                 designs=designs,
                 rerun_equal=all(map(torch.equal, flat_gram(y, g), (gk, ygk))),
                 symmetric=torch.equal(gk, gk.transpose(1, 2)),
                 ms=device_ms(lambda: flat_gram(y, g), device),
                 bound=bound_ms(nbytes(y, g, gk, ygk),
                                {torch.float32: K * d * 2 * (m * (m + 1) // 2 + m)}),
                 launch_floor_ms=floor)
        if label == "lm":
            r["plain_ms"] = device_ms(lambda: gram_ref(y, g), device, n=1, repeats=3)
            rhs = torch.cat([y, g.expand(K, 1, d)], 1).transpose(1, 2).contiguous()
            # ~5 s a call at this shape: one timed call
            r["library_ms"] = device_ms(lambda: torch.bmm(y, rhs), device, n=1, repeats=1)
            del rhs
        else:
            gb, ygb = flat_gram(y, g, design="block")
            r["block"] = dict(
                ms=device_ms(lambda: flat_gram(y, g, design="block"), device, n=2,
                             repeats=3),
                rel_to_split=max(rel_diff(gb, gk, gk.abs().max())[0],
                                 rel_diff(ygb, ygk, ygk.abs().max())[0]),
                rerun_equal=all(map(torch.equal, flat_gram(y, g, design="block"),
                                    (gb, ygb))))
        out[label] = r
        print(f"  gram {label} [{r['shape']}, {r['parts']} parts a client]: rel "
              f"{r['rel']:.3e} (limit {TOLERANCE[torch.float32]:.0e}), designs "
              f"{designs}, rerun bit-identical {r['rerun_equal']}, exactly symmetric "
              f"{r['symmetric']}; {r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), plain {r.get('plain_ms')}, torch.bmm "
              f"{r.get('library_ms')}, one block a client {r.get('block')}, launch "
              f"floor {floor:.4f} ms", flush=True)
        if not (r["rel"] <= TOLERANCE[torch.float32] and r["rerun_equal"]
                and r["symmetric"] and designs == {"block": 0, "split": 1}):
            raise AssertionError(f"gram {label}: {r}")
        if "block" in r and not (r["block"]["rerun_equal"]
                                 and r["block"]["rel_to_split"] <= TOLERANCE[torch.float32]):
            raise AssertionError(f"gram {label}: the block design {r['block']}")
        del y, g, gk, gp
        free_memory()
    return out


def check_aa_step_lm(device, floor: float) -> dict:
    """Phase 6b (b): the fused AA step at (a)'s shape (K=4, m=3,
    d=162,826,560, f32; random histories, seeded), as phase 2 holds it."""
    gen = torch.Generator(device=device).manual_seed(12)
    K, m, d = FL_LM_CLIENTS, FL_LM_L, FL_LM_D

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    s, y = 0.01 * randn(K, m, d), 0.01 * randn(K, m, d)
    w, g = randn(d), 0.01 * randn(d)
    out = check_aa_step("lm", w, g, s, y, device, floor)
    if not out["rel"] <= TOLERANCE[torch.float32]:
        raise AssertionError(f"aa_step (lm) disagrees with its plain version: "
                             f"{out['rel']:.3e} > {TOLERANCE[torch.float32]:.0e}")
    del s, y, w, g
    free_memory()
    return out


def lm_engine(device, arch: str = FL_LM_ARCH, prefix: str = "lm_reduced_engine"
              ) -> dict:
    """Phase 6b (c) and 6d (c): the reduced ``arch`` (K=4), FedOSAA-SVRG, 4
    rounds by the loop and by the engine in chunks of 2, on the identity and
    the int8 wire: the engine's rows and final params equal the loop's bit
    for bit, one host read a chunk after the first, the loop's launches a
    round once per slot replayed; then one warmed-up loop round of each
    wire under ``set_sync_debug_mode("error")``: no host read."""
    from repro_torch.configs import get_arch
    from repro_torch.core import AAConfig, AlgoHParams, run_federated
    from repro_torch.core.lm import make_lm_clients, make_lm_problem
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.models.decoder import build_model
    from repro_torch.obs import MemorySink

    cfg = get_arch(arch).reduced()
    toks = make_lm_tokens(FL_LM_CLIENTS * FL_LM_DOCS, FL_LM_SEQ, cfg.vocab_size, seed=0)
    prob = make_lm_problem(build_model(cfg, device=device, seed=0),
                           make_lm_clients(toks, FL_LM_CLIENTS, device=device))
    hp = AlgoHParams(eta=FL_LM_ETA, local_epochs=FL_LM_L,
                     aa=AAConfig(tikhonov=1e-8, damping=1.0))
    out = {}
    for channel in (None, "int8"):
        name = prefix + ("_int8" if channel else "")
        s_loop = MemorySink()
        _build.reset_launches()
        h = run_federated(prob, "fedosaa_svrg", hp, FL_ENGINE_ROUNDS, device=device,
                          channel=channel, sinks=[s_loop])
        loop_launches = dict(_build.LAUNCHES)
        s_eng = MemorySink()
        _build.reset_launches()
        with sync_warnings() as caught:
            reads = ChunkReads(caught)
            he = run_federated(prob, "fedosaa_svrg", hp, FL_ENGINE_ROUNDS,
                               device=device, channel=channel, chunk=FL_ENGINE_CHUNK,
                               sinks=[s_eng, reads])
        launches = dict(_build.LAUNCHES)
        same_as_loop(name, s_loop, s_eng, h.final_params, he.final_params)
        per_round = lm_round_launches("fedosaa_svrg", int8=channel == "int8")
        slots = slots_replayed(len(he.rounds), FL_ENGINE_CHUNK)
        want = {k: v * slots for k, v in per_round.items()}
        out[name] = dict(loss=h.loss.tolist(), loop_launches=loop_launches,
                         launches=launches, reads_per_chunk=reads.per_chunk,
                         loop_ms=per_round_ms(h.wall_time).tolist(),
                         engine_ms=per_round_ms(he.wall_time).tolist(),
                         designs=dict(_build.DESIGN_LAUNCHES["trajectory"]))
        print(f"  {name}: loss {[f'{v:.4f}' for v in h.loss]}; engine = loop in "
              f"every row and the final params; host reads per chunk "
              f"{reads.per_chunk}; launches loop {loop_launches}, engine "
              f"{launches} over {slots} slots", flush=True)
        if {k: v for k, v in launches.items() if v} != want or \
                {k: v for k, v in loop_launches.items() if v} != \
                {k: v * FL_ENGINE_ROUNDS for k, v in per_round.items()}:
            raise AssertionError(f"{name}: launches loop {loop_launches}, engine "
                                 f"{launches}; expected {per_round} a round")
        if any(n != 1 for n in reads.per_chunk[1:]):
            raise AssertionError(f"{name}: host reads per chunk {reads.per_chunk}")
        out[name]["no_host_read_round"] = lm_no_host_read_round(prob, hp, channel,
                                                                device)
    return out


def lm_no_host_read_round(prob, hp, channel, device) -> dict:
    """One FedOSAA-SVRG round on the LM after two warm-up rounds under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing CUDA
    call raises and fails the run), launching what an LM round launches."""
    from repro_torch.core import make_round_fn
    from repro_torch.kernels import _build

    round_fn = make_round_fn("fedosaa_svrg", prob, hp, channel, device=device)
    st = start_state(prob, "fedosaa_svrg", hp, channel, device)
    for _ in range(2):
        st, _ = round_fn(st)
    torch.cuda.synchronize(device)
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = round_fn(st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    one = {k: v for k, v in _build.LAUNCHES.items() if v}
    if one != lm_round_launches("fedosaa_svrg", int8=channel == "int8") or \
            not np.isfinite(float(m.loss)):
        raise AssertionError(f"no-host-read LM round [{channel}]: launches {one}, "
                             f"loss {float(m.loss)}")
    return one


def lm_families(device) -> dict:
    """Phase 6b (d): one loop round of FedOSAA-SVRG on the reduced mamba2
    (ssm) and on a 5-layer zamba2 (hybrid: two groups, a trailing Mamba-2
    layer): finite, the Gram pass and the AA step once, the SSD and
    flash-attention kernels never."""
    from repro_torch.configs import get_arch
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.core.lm import make_lm_clients, make_lm_problem
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.models.decoder import build_model

    out = {}
    for name, arch, layers in (("lm_ssm", "mamba2-2.7b", None),
                               ("lm_hybrid", "zamba2-7b", 5)):
        cfg = get_arch(arch).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        toks = make_lm_tokens(FL_LM_CLIENTS * FL_LM_DOCS, FL_LM_SEQ, cfg.vocab_size,
                              seed=0)
        prob = make_lm_problem(build_model(cfg, device=device, seed=0),
                               make_lm_clients(toks, FL_LM_CLIENTS, device=device))
        _build.reset_launches()
        h = run_federated(prob, "fedosaa_svrg",
                          AlgoHParams(eta=FL_LM_ETA, local_epochs=FL_LM_L), 1,
                          device=device)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[name] = dict(loss=h.loss.tolist(), launches=dict(_build.LAUNCHES),
                         designs=dict(_build.DESIGN_LAUNCHES["trajectory"]),
                         ms=per_round_ms(h.wall_time).tolist(),
                         finite=bool(torch.isfinite(h.final_params).all()))
        print(f"  {name} ({cfg.name}, {cfg.num_layers} layers): loss "
              f"{h.loss.tolist()}, params finite {out[name]['finite']}, launches "
              f"{launches}", flush=True)
        if not (out[name]["finite"] and np.isfinite(h.loss).all()) or \
                launches != lm_round_launches("fedosaa_svrg", int8=False):
            raise AssertionError(f"{name}: {out[name]}")
    return out


def launchers(device) -> dict:
    """Phase 6b (e): ``fl_train.main`` on the reduced smollm (3 rounds,
    FedSVRG as the baseline) writes the reference's keys; ``train.main``
    on smollm-135m at full width in f32 (AdamW, WSD, batch 4 x 256, 10
    steps): the loss falls; ms a step."""
    import tempfile

    from repro_torch.launch import fl_train, train

    tmp = tempfile.mkdtemp(prefix="fl_train_")
    try:
        path = os.path.join(tmp, "out.json")
        res = fl_train.main(["--arch", FL_LM_ARCH, "--reduced", "--rounds", "3",
                             "--baseline", "fedsvrg", "--out", path])
        with open(path) as f:
            written = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys_ok = set(written) == {"fedosaa_svrg", "fedsvrg"} and all(
        set(v) == FL_TRAIN_KEYS for v in written.values())
    print(f"  fl_train --reduced: the reference's keys {keys_ok}; "
          + "; ".join(f"{a} loss {[f'{x:.4f}' for x in v['loss_curve']]} in "
                      f"{v['wall_s']:.1f} s" for a, v in res.items()), flush=True)
    if not keys_ok or not all(np.isfinite(v["loss_curve"]).all() for v in res.values()):
        raise AssertionError(f"fl_train: keys {written.keys()}, results {res}")
    free_memory()
    mark = memory_mark(device)
    tr = train.main(["--arch", FL_LM_ARCH, "--dtype", "float32", "--steps",
                     str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq-len",
                     str(TRAIN_SEQ), "--schedule", "wsd", "--log-every", "5"])
    peak = torch.cuda.max_memory_allocated(device) - mark
    out = dict(fl_train={a: v["loss_curve"] for a, v in res.items()},
               train=dict(loss=tr["loss"], ms_per_step=tr["ms_per_step"],
                          first_step_ms=tr["first_step_ms"], peak_gib=peak / 2 ** 30,
                          tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / tr["ms_per_step"] * 1e3))
    print(f"  train smollm-135m f32 (AdamW + WSD, {TRAIN_BATCH}x{TRAIN_SEQ}): loss "
          f"{[f'{v:.4f}' for v in tr['loss']]}; {tr['ms_per_step']:.1f} ms a step "
          f"after the first ({tr['first_step_ms']:.0f} ms), "
          f"{out['train']['tokens_per_s']:.0f} tokens/s, peak {peak / 2 ** 30:.2f} GiB",
          flush=True)
    if not (np.isfinite(tr["loss"]).all() and tr["loss"][-1] < tr["loss"][0]):
        raise AssertionError(f"train: the loss did not fall: {tr['loss']}")
    del tr
    free_memory()
    return out


def fig8_init(depth: int, seed: int = 0) -> np.ndarray:
    """The flat He init of scripts/reference_fig8_mlp.py::he_init: for each
    layer normal(din, dout) * sqrt(2/din) in f32 (numpy, ``seed``), then a
    zero bias."""
    rng = np.random.default_rng(seed)
    dims = [784] + [256] * depth + [10]
    out = []
    for din, dout in zip(dims[:-1], dims[1:]):
        out += [(rng.standard_normal((din, dout), dtype=np.float32)
                 * np.float32(np.sqrt(2.0 / din))).reshape(-1),
                np.zeros(dout, np.float32)]
    return np.concatenate(out)


def fig8(device) -> dict:
    """Phase 6b (f): Fig. 8 quick (make_mnist_like(4000), K=10 iid, eta
    0.1, L=10, 15 rounds), MLP1 and MLP3 by FedSVRG and FedOSAA-SVRG from
    the numpy He init: MLP1 gated on the reference's pinned final loss and
    accuracy (FIG8_REFERENCE), MLP3 recorded."""
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.data import make_mnist_like, partition
    from repro_torch.kernels import _build
    from repro_torch.models.mlp import make_mlp_problem, mlp_accuracy

    X, y = make_mnist_like(FIG8_N, seed=0)
    clients = partition(X, y.astype(np.float32), FIG8_K, "iid", device=device)
    out = {}
    for depth in (1, 3):
        prob = make_mlp_problem(clients, hidden_layers=depth, device=device)
        w0 = torch.from_numpy(fig8_init(depth)).to(device)
        for algo in ("fedsvrg", "fedosaa_svrg"):
            tag = f"mlp{depth}"
            _build.reset_launches()
            h = run_federated(prob, algo, AlgoHParams(eta=FIG8_ETA, local_epochs=FIG8_L),
                              FIG8_ROUNDS, w0=w0, device=device)
            launches = dict(_build.LAUNCHES)
            acc = mlp_accuracy(prob, h.final_params, X, y)
            ref_loss, ref_acc = FIG8_REFERENCE[(tag, algo)]
            loss = float(h.loss[-1])
            out[f"{tag}_{algo}"] = r = dict(
                loss=loss, accuracy=acc, reference=(ref_loss, ref_acc),
                rel_to_reference=abs(loss - ref_loss) / ref_loss,
                loss_curve=h.loss.tolist(), launches=launches,
                designs=dict(_build.DESIGN_LAUNCHES["trajectory"]),
                ms_per_round=float(np.median(per_round_ms(h.wall_time)[1:])))
            print(f"  fig8 {tag} {algo}: final loss {loss!r} (the reference "
                  f"{ref_loss!r}, rel {r['rel_to_reference']:.3e}), accuracy {acc} "
                  f"(the reference {ref_acc}), {r['ms_per_round']:.2f} ms a round, "
                  f"launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}",
                  flush=True)
            want = {k: v for k, v in lm_round_launches(algo, False).items()}
            got = {k: v // FIG8_ROUNDS for k, v in launches.items() if v}
            if got != want or any(v % FIG8_ROUNDS for v in launches.values()):
                raise AssertionError(f"fig8 {tag} {algo}: launches {launches}")
            if tag == "mlp1":
                ok = (r["rel_to_reference"] <= FIG8_SVRG_RTOL if algo == "fedsvrg"
                      else 1 / FIG8_OSAA_FACTOR <= loss / ref_loss <= FIG8_OSAA_FACTOR)
                if not (ok and abs(acc - ref_acc) <= FIG8_ACC_TOL):
                    raise AssertionError(f"fig8 {tag} {algo}: loss {loss} accuracy "
                                         f"{acc} against the reference's {ref_loss}, "
                                         f"{ref_acc}")
    return out


def federated_training(device, floor: float) -> dict:
    """Phase 6b: (a)-(f) above."""
    t0 = time.perf_counter()
    full, prob = lm_full_width(device)
    del prob
    free_memory()
    out = dict(full_width=full)
    out["gram"] = check_gram_wide(device, floor)
    out["aa_step"] = check_aa_step_lm(device, floor)
    out["engine"] = lm_engine(device)
    out["families"] = lm_families(device)
    out["launchers"] = launchers(device)
    out["fig8"] = fig8(device)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6b took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6d: training the MoE family (granite-moe-3b-a800m, llama4-scout)
# ---------------------------------------------------------------------------

def moe_same_gradients(prob, device) -> dict:
    """Phase 6d (b): two evaluations of the clients' gradients at the
    problem's initial point, by ``vmap`` of ``grad`` over the clients with
    one point each (as the local trajectory takes them), equal bit for bit:
    the MoE dispatch's backward (indexing's sorted ``index_put_``) adds no
    float atomics."""
    from torch.func import vmap

    from repro_torch.core.problem import ClientBatch

    c = prob.clients
    w = prob.init()
    points = w.expand(c.num_clients, -1)
    batch = ClientBatch(c.x, c.y, c.mask)
    g1 = vmap(prob.grad)(points, batch)
    g2 = vmap(prob.grad)(points, batch)
    out = dict(equal=torch.equal(g1, g2), finite=bool(torch.isfinite(g1).all()),
               norms=[float(v) for v in torch.linalg.vector_norm(g1, dim=1)])
    print(f"  two vmap(grad) evaluations at the initial point bit-identical "
          f"{out['equal']}, finite {out['finite']}, per-client norms "
          f"{[f'{v:.4f}' for v in out['norms']]}", flush=True)
    if not (out["equal"] and out["finite"]):
        raise AssertionError(f"MoE gradients: {out}")
    del g1, g2, w
    return out


def moe_train_main(device) -> dict:
    """Phase 6d (d): ``train.main`` (AdamW + WSD) on the reduced
    granite-moe-3b-a800m and the reduced llama4-scout-17b-a16e: the loss
    falls; ms a step."""
    from repro_torch.launch import train

    out = {}
    for arch in MOE_TRAIN_ARCHS:
        tr = train.main(["--arch", arch, "--reduced", "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                         "--schedule", "wsd", "--log-every", str(TRAIN_STEPS),
                         "--device", str(device)])
        out[arch] = dict(loss=tr["loss"], ms_per_step=tr["ms_per_step"],
                         first_step_ms=tr["first_step_ms"])
        print(f"  train {arch} --reduced (AdamW + WSD, {TRAIN_BATCH}x{TRAIN_SEQ}): "
              f"loss {[f'{v:.4f}' for v in tr['loss']]}; {tr['ms_per_step']:.1f} ms "
              f"a step after the first ({tr['first_step_ms']:.0f} ms)", flush=True)
        if not (np.isfinite(tr["loss"]).all() and tr["loss"][-1] < tr["loss"][0]):
            raise AssertionError(f"train {arch}: the loss did not fall: {tr['loss']}")
        del tr
    free_memory()
    return out


def moe_training(device) -> dict:
    """Phase 6d: (a) FedOSAA-SVRG and FedSVRG over granite-moe-3b-a800m at
    full width with its depth cut to MOE_FL_LAYERS, f32, MOE_FL_CLIENTS
    clients, gated as phase 6b (a) at FL_LM_ETA_GATED; (b) two gradients at
    its initial point bit-identical; (c) the engine on the reduced granite
    (phase 6b (c)'s gates); (d) ``train.main`` on the reduced granite and
    Scout."""
    t0 = time.perf_counter()
    runs, prob = lm_full_width(device, MOE_ARCH, layers=MOE_FL_LAYERS,
                               clients=MOE_FL_CLIENTS, d_want=MOE_FL_D,
                               etas=(FL_LM_ETA_GATED,), prefix="lm_moe_",
                               profile=False)
    out = dict(full_width=runs, same_gradients=moe_same_gradients(prob, device))
    del prob
    free_memory()
    out["engine"] = lm_engine(device, MOE_ARCH, prefix="lm_moe_reduced_engine")
    out["train"] = moe_train_main(device)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6d took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6f: tensor-parallel serving (sharding/specs.py, launch/mesh.py,
# the Sharder, moe_sharded)
# ---------------------------------------------------------------------------

#: (b): llama4-scout-17b-a16e (configs/llama4_scout_17b_a16e.py) at full
#: width with TP_SCOUT_LAYERS of its 48 layers, over a gloo world of
#: TP_SCOUT_WORLD child processes on the card; the f32 check on
#: TP_SCOUT_F32_LAYERS layer. (c): zamba2-7b at full width with
#: TP_ZAMBA_LAYERS of its 81 layers (two groups of five Mamba-2 layers and
#: the shared block) over a gloo world of TP_ZAMBA_WORLD. Each serves
#: TP_BATCH prompts of LM_PROMPT tokens and TP_DECODE decode steps.
TP_ARCH = "llama4-scout-17b-a16e"
TP_SCOUT_WORLD, TP_SCOUT_LAYERS, TP_SCOUT_F32_LAYERS = 4, 4, 1
TP_ZAMBA_WORLD, TP_ZAMBA_LAYERS = 2, 12
TP_BATCH, TP_DECODE = 2, 8
#: a child's deadline (s): start, build, every run
TP_CHILD_TIMEOUT = 240.0


class capture_moe:
    """Within the block, each call of the MoE layer (models/layers.py::moe)
    records its input, output and aux on the host, call by call in order."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.saved = layers, layers.moe
        self.calls = []

        def moe(p, x, cfg, dropless=False):
            y, aux = self.saved(p, x, cfg, dropless)
            self.calls.append(dict(x=x.cpu(), y=y.cpu(), aux=aux.cpu()))
            return y, aux

        layers.moe = moe
        return self

    def __exit__(self, *exc):
        self.layers.moe = self.saved


def tp_twin(cfg, device, decode_steps: int = TP_DECODE) -> dict:
    """The unsharded model of ``cfg`` (a plan's padded config), from the
    seed the ranks draw from: its embedding, each block's input, output and
    routing (``routing`` records, one a MoE layer) through the kernels, each
    MoE layer's input, output and aux, the prefill's last logits and
    ``decode_steps`` greedy decode steps (the tokens fed and the logits).
    All on the host."""
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.models.decoder import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=0)
    torch.cuda.synchronize(device)
    built = time.perf_counter() - t0
    tokens = torch.from_numpy(make_lm_tokens(TP_BATCH, LM_PROMPT, cfg.vocab_size,
                                             seed=0)).to(device)
    B, S = tokens.shape
    positions = torch.arange(S, device=device).expand(B, S)
    out = {"tokens": tokens.cpu(), "blocks": [], "built_s": built}
    with torch.inference_mode():
        h = model.embed_tokens(tokens)
        out["embed"] = h.cpu()
        with capture_moe() as cap:
            for block, _, _ in model.schedule():
                with routing("record") as rec:
                    o = block(h, cfg, positions, cfg.sliding_window)[0]
                out["blocks"].append((h.cpu(), o.cpu(), [g.cpu() for g in rec.record]))
                h = o
        out["moe"] = cap.calls
        out["prefill_ms"] = host_ms(lambda: model.prefill(tokens, cache_len=S + decode_steps),
                                    device, repeats=2)
        logits, caches = model.prefill(tokens, cache_len=S + decode_steps)
        out["logits"] = logits.float().cpu()
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
        feed, steps = [], []
        for i in range(decode_steps):
            pos = torch.full((B, 1), S + i, dtype=torch.int32, device=device)
            feed.append((tok.cpu(), pos.cpu()))
            logits, caches = model.decode_step(caches, tok, pos)
            steps.append(logits.float().cpu())
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
    out["decode_feed"], out["decode_logits"] = feed, steps
    out["n_params"] = sum(p.numel() for p in model.parameters())
    del model, caches
    free_memory()
    return out


def tp_config(arch: str, world: int, layers: int, dtype: str | None = None):
    """The served config: ``arch`` with ``layers`` layers (and ``dtype``),
    padded for ``world`` model ranks, as make_plan pads it."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, cfg.padded(world)


def tp_spawn(tmp: str, world: int) -> tuple[list, float]:
    """The gloo world of ``world`` children of this script on the card
    (``--tp-child <dir>``), each rank's results; a rank that fails fails
    the phase."""
    from repro_torch.core.sharded import spawn_world

    t0 = time.perf_counter()
    results = spawn_world([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--tp-child", tmp], world, os.path.join(tmp, "store"),
                          timeout_s=TP_CHILD_TIMEOUT, cwd=str(ROOT))
    secs = time.perf_counter() - t0
    for r, res in enumerate(results):
        if res.returncode != 0:
            raise AssertionError(f"tensor-parallel rank {r} of {world} exited "
                                 f"{res.returncode}: {res.stdout[-3000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], secs


def tp_runs(spec: dict, device) -> dict:
    """One rank's side of a run of phase 6f (b)/(c): build the plan's model
    (each rank its shard, drawn from the twin's seed); its embedding and
    each MoE layer (output, aux, routing) against the twin's on the twin's
    inputs; each block from the twin's input, an MoE block held to the
    twin's routing where it routes otherwise (``routing``: the block's
    attention output, summed over the ranks, may move a near-tied token);
    then the prefill (launches, collectives, ms) and the teacher-forced
    decode steps against the twin's logits (printed, not held: random
    layers amplify bf16 steps)."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import layers
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    twin = torch.load(spec["twin"], weights_only=False)
    cfg_full = spec["cfg"]
    mesh = make_mesh(1, dist.get_world_size())
    plan = make_plan(cfg_full, mesh)
    if plan.cfg != spec["padded"]:
        raise AssertionError(f"the plan's config {plan.cfg} is not the twin's")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    model = build_model(plan.cfg, device=device, seed=0, sh=plan.sharder())
    torch.cuda.synchronize(device)
    out = {"built_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    sh, cfg = model.sh, plan.cfg
    tokens = twin["tokens"].to(device)
    B, S = tokens.shape
    positions = torch.arange(S, device=device).expand(B, S)
    with torch.inference_mode():
        out["embed_equal"] = torch.equal(model.embed_tokens(tokens).cpu(), twin["embed"])
        # each block from the twin's input; each MoE layer on the twin's
        # MoE input, its routing and output bit for bit the twin's
        block_rel, moe, rerouted = [], [], 0
        for (block, _, _), (h_in, h_out, route) in zip(model.schedule(), twin["blocks"]):
            route = [g.to(device) for g in route]
            with routing("compare", route) as cmp:
                o = block(h_in.to(device), cfg, positions, cfg.sliding_window)[0]
            if cmp.differ:
                rerouted += cmp.differ
                with routing("replay", route):
                    o = block(h_in.to(device), cfg, positions, cfg.sliding_window)[0]
            block_rel.append(rel_diff(o.float().cpu(), h_out.float())[0])
        moe_blocks = [b for b, _, _ in model.schedule() if hasattr(b, "moe")]
        for block, call, (_, _, route) in zip(moe_blocks, twin["moe"], twin["blocks"]):
            x = call["x"].to(device)
            y, aux = layers.moe_sharded(block.moe, x, cfg, sh)
            gate_i = layers.moe_route(block.moe, x.reshape(-1, x.shape[-1]), cfg)[1]
            moe.append(dict(y=torch.equal(y.cpu(), call["y"]),
                            aux=torch.equal(aux.cpu(), call["aux"]),
                            routing=torch.equal(gate_i.cpu(), route[0]),
                            rel=rel_diff(y.float().cpu(), call["y"].float())[0]))
        out.update(block_rel=block_rel, moe=moe, block_rerouted=rerouted)
        # the served path: prefill, then the twin's decode feed
        prefill = make_prefill_step(model, S + len(twin["decode_feed"]))
        serve_step = make_serve_step(model)
        prefill(tokens)                                    # warm-up
        torch.cuda.synchronize(device)
        dist.barrier()
        sh.counts.clear()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        logits, caches = prefill(tokens)
        torch.cuda.synchronize(device)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = dict(_build.LAUNCHES)
        out["prefill_counts"] = {k: dict(v) for k, v in sh.counts.items()}
        out["logits_rel"] = rel_diff(logits.float().cpu(), twin["logits"])[0]
        out["logits_finite"] = bool(logits.isfinite().all())
        out["logits_shape"] = tuple(logits.shape)
        sh.counts.clear()
        _build.reset_launches()
        step_ms, rel, agree = [], [], 0
        for (tok, pos), want in zip(twin["decode_feed"], twin["decode_logits"]):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits, caches = serve_step(caches, tok.to(device), pos.to(device))
            torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rel.append(rel_diff(logits.float().cpu(), want)[0])
            agree += int((logits.float().cpu().argmax(-1) == want.argmax(-1)).sum())
            out["logits_finite"] &= bool(logits.isfinite().all())
        out["decode_launches"] = dict(_build.LAUNCHES)
        out["decode_counts"] = {k: dict(v) for k, v in sh.counts.items()}
        out.update(decode_ms=step_ms, decode_rel=rel, decode_argmax_agree=agree,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        # one all-reduce of a layer's output alone: what the prefill's sums
        # cost over this world (gloo stages the card's tensors through the
        # host)
        x = torch.ones((B, S, cfg.d_model), dtype=model.dtype, device=device)
        out["all_reduce_ms"] = host_ms(
            lambda: dist.all_reduce(x, group=mesh.group("model")), device)
    del model, caches
    free_memory()
    return out


def tp_child(argv: list) -> int:
    """Phase 6f's child: ``--tp-child <dir>``, one rank of a gloo world
    (spawn_world's environment) on the card; runs each spec of
    <dir>/specs.pt (``tp_runs``) and writes <dir>/rank<r>.pt."""
    import torch.distributed as dist

    from repro_torch.core.sharded import init_file_world
    from repro_torch.kernels import _build

    (d,) = argv
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    init_file_world(backend="gloo", timeout_s=120.0)
    rank = dist.get_rank()
    _build.library()
    out = {name: tp_runs(spec, device)
           for name, spec in torch.load(os.path.join(d, "specs.pt"),
                                        weights_only=False).items()}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def tp_world_of_one(device, served_moe: dict) -> dict:
    """Phase 6f (a): an NCCL world of one (launch/mesh.py::make_host_mesh,
    mesh (1, 1)) serving granite-moe-3b-a800m at full width and depth in
    bf16 through ``moe_sharded``: the prefill's logits and TP_DECODE greedy
    decode steps bit for bit phase 6c's unsharded ``moe`` run on the same
    weights, its prefill launches phase 6c's, decode none, and the slot
    server's tokens phase 6c's."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    kept = served_moe.pop("kept")
    mesh = make_host_mesh("nccl")
    try:
        plan = make_plan(get_arch(MOE_ARCH), mesh)
        model = build_model(plan.cfg, device=device, seed=0, sh=plan.sharder())
        cfg = plan.cfg
        tokens = torch.from_numpy(make_lm_tokens(LM_BATCH, LM_PROMPT, cfg.vocab_size,
                                                 seed=0)).to(device)
        prefill = make_prefill_step(model, LM_PROMPT + LM_DECODE)
        serve_step = make_serve_step(model)
        with torch.inference_mode():
            _build.reset_launches()
            logits, caches = prefill(tokens)
            torch.cuda.synchronize(device)
            launches = dict(_build.LAUNCHES)
            same = {"prefill": torch.equal(logits.cpu(), kept["prefill"])}
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
            _build.reset_launches()
            steps = []
            for i in range(TP_DECODE):
                pos = torch.full((LM_BATCH, 1), LM_PROMPT + i, dtype=torch.int32,
                                 device=device)
                logits, caches = serve_step(caches, tok, pos)
                steps.append(torch.equal(logits.cpu(), kept["decode"][i]))
                tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
            decode_launches = dict(_build.LAUNCHES)
        same["decode"] = steps
        del caches, logits
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
                        SERVE_NEW) for i in range(SERVE_REQUESTS)]
        SlotServer(model, batch_slots=SERVE_SLOTS, cache_len=SERVE_PROMPT + SERVE_NEW + 1,
                   device=device).run(reqs)
        same["server_tokens"] = [r.out for r in reqs] == served_moe["server_tokens"]
        counts = {k: dict(v) for k, v in model.sh.counts.items()}
    finally:
        dist.destroy_process_group()
    del model
    free_memory()
    want = {k: MOE_PREFILL_LAUNCHES.get(k, 0) for k in launches}
    print(f"  (a) NCCL world of one, mesh (1, 1), {MOE_ARCH} at full width through "
          f"moe_sharded: prefill logits bit for bit phase 6c's {same['prefill']}, "
          f"{TP_DECODE} decode steps {same['decode']}, slot server tokens "
          f"{same['server_tokens']}; prefill launches {launches}, decode "
          f"{decode_launches}; collectives {counts}", flush=True)
    if not (same["prefill"] and all(same["decode"]) and same["server_tokens"]):
        raise AssertionError(f"6f (a): the world of one is not phase 6c's run: {same}")
    if launches != want or any(decode_launches.values()):
        raise AssertionError(f"6f (a): launches {launches} / {decode_launches}")
    return dict(same=same, launches=launches, decode_launches=decode_launches,
                collectives=counts)


def tp_launches(cfg) -> dict:
    """A prefill's launches on each rank: one SSD step a Mamba-2 layer and
    one flash attention an attention layer (each rank runs its heads)."""
    if cfg.family == "hybrid":
        n_groups, group, trailing = cfg.hybrid_counts
        return {"ssd": n_groups * group + trailing, "flash_attention": n_groups}
    return {"flash_attention": cfg.num_layers}


def tp_gloo(device, arch: str, world: int, layers: int,
            f32_layers: int | None = None) -> dict:
    """Phase 6f (b)/(c): ``arch`` at full width with ``layers`` layers over a
    gloo world of ``world`` children on the card, against its unsharded
    twin from the same seed (``tp_twin``), in bf16 (and with ``f32_layers``
    an f32 check: prefill logits within LM_LOGITS_TOLERANCE_F32, each block
    within LM_BLOCK_TOLERANCE_F32 of the twin's). Gates per rank: the
    embedding and each MoE layer (output, aux, routing) bit for bit the
    twin's on the twin's inputs, each block within LM_BLOCK_TOLERANCE_BF16
    from the twin's input, the prefill's launches ``tp_launches``, decode
    none, logits finite of shape [TP_BATCH, V]."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tp_")
    specs = {}
    runs = {"bf16": (None, layers)} | ({"f32": ("float32", f32_layers)} if f32_layers else {})
    twins = {}
    for name, (dtype, n) in runs.items():
        cfg, padded = tp_config(arch, world, n, dtype)
        twin = tp_twin(padded, device)
        path = os.path.join(tmp, f"twin_{name}.pt")
        torch.save(twin, path)
        twins[name] = twin
        specs[name] = dict(cfg=cfg, padded=padded, twin=path)
        print(f"  twin {name}: {describe(padded, twin['n_params'], get_arch_layers(arch))}, "
              f"built in {twin['built_s']:.1f} s, prefill {TP_BATCH}x{LM_PROMPT} "
              f"{[round(t, 1) for t in twin['prefill_ms']]} ms on one card", flush=True)
    torch.save(specs, os.path.join(tmp, "specs.pt"))
    ranks, secs = tp_spawn(tmp, world)
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"child_seconds": secs, "ranks": {}}
    for name in runs:
        f32 = name == "f32"
        block_tol = LM_BLOCK_TOLERANCE_F32 if f32 else LM_BLOCK_TOLERANCE_BF16
        for r, got in enumerate(ranks):
            g = got[name]
            per_prefill = tp_launches(specs[name]["padded"])
            want_l = {k: per_prefill.get(k, 0) for k in g["launches"]}
            summary = dict(
                embed_equal=g["embed_equal"], block_rel_max=max(g["block_rel"]),
                moe=[(m["y"], m["aux"], m["routing"]) for m in g["moe"]],
                launches=g["launches"], decode_launches=g["decode_launches"],
                prefill_ms=g["prefill_ms"], decode_ms=g["decode_ms"],
                logits_rel=g["logits_rel"], decode_rel_max=max(g["decode_rel"]),
                decode_argmax_agree=g["decode_argmax_agree"],
                block_rerouted=g["block_rerouted"],
                prefill_counts=g["prefill_counts"], decode_counts=g["decode_counts"],
                peak_gib=g["peak_gib"], param_gib=g["param_bytes"] / 2**30,
                built_s=g["built_s"], all_reduce_ms=g["all_reduce_ms"])
            out["ranks"][f"{name}/rank{r}"] = summary
            n = specs[name]["padded"].num_layers
            per_layer = {k: {"calls": v["calls"] / n, "bytes": v["bytes"] / n}
                         for k, v in g["prefill_counts"].items()}
            print(f"  {name} rank {r}: {summary['param_gib']:.2f} GiB of weights "
                  f"(built in {g['built_s']:.1f} s), peak {g['peak_gib']:.2f} GiB; "
                  f"embedding bit for bit {g['embed_equal']}; blocks from the twin's "
                  f"input: largest rel {summary['block_rel_max']:.3e} (tol "
                  f"{block_tol:.1e}; token-layers routed otherwise than the twin, "
                  f"held to its routing: {g['block_rerouted']}); MoE layers on the "
                  f"twin's input (output, aux, routing) bit for bit "
                  f"{summary['moe']}; prefill {g['prefill_ms']:.1f} ms, launches "
                  f"{g['launches']}, collectives {g['prefill_counts']} "
                  f"({per_layer} a layer; one all-reduce of [{TP_BATCH}, {LM_PROMPT}, "
                  f"d] alone {[round(t, 1) for t in g['all_reduce_ms']]} ms); "
                  f"logits vs the twin's rel "
                  f"{g['logits_rel']:.3e}; decode {len(g['decode_ms'])} steps median "
                  f"{np.median(g['decode_ms']):.1f} ms, launches {g['decode_launches']}, "
                  f"collectives a step "
                  f"{ {k: v['calls'] / len(g['decode_ms']) for k, v in g['decode_counts'].items()} }, "
                  f"logits vs the twin's rel up to {summary['decode_rel_max']:.3e}, "
                  f"argmax agrees {g['decode_argmax_agree']}/{TP_BATCH * TP_DECODE}",
                  flush=True)
            bad = []
            if not g["embed_equal"]:
                bad.append("embedding")
            if not all(all(m) for m in summary["moe"]):
                bad.append(f"MoE layers {summary['moe']}")
            if not summary["block_rel_max"] <= block_tol:
                bad.append(f"blocks {g['block_rel']}")
            if f32 and not g["logits_rel"] <= LM_LOGITS_TOLERANCE_F32:
                bad.append(f"f32 logits {g['logits_rel']:.3e}")
            if g["launches"] != want_l or any(g["decode_launches"].values()):
                bad.append(f"launches {g['launches']} / {g['decode_launches']}")
            if not g["logits_finite"] or g["logits_shape"] != (TP_BATCH, specs[name]["padded"].eff_vocab):
                bad.append(f"logits {g['logits_shape']}, finite {g['logits_finite']}")
            if bad:
                raise AssertionError(f"6f {arch} {name} rank {r}: " + "; ".join(bad))
    out["twin_prefill_ms"] = {name: t["prefill_ms"] for name, t in twins.items()}
    print(f"  the {world} children took {secs:.1f} s", flush=True)
    return out


def tp_launches_by_run(tp: dict, name: str) -> dict:
    """A kernel's launches in each run of phase 6f, for its kernels row:
    (a)'s prefill and each rank's prefill and decode steps of (b), (c)."""
    out = {f"6f (a) {MOE_ARCH} world of one prefill":
           tp["world_of_one"]["launches"][name],
           f"6f (a) {MOE_ARCH} world of one decode ({TP_DECODE} steps)":
           tp["world_of_one"]["decode_launches"][name]}
    for run, arch in (("scout", TP_ARCH), ("zamba", LM_ARCH)):
        for key, r in tp[run]["ranks"].items():
            out[f"6f {arch} {key} prefill"] = r["launches"][name]
            out[f"6f {arch} {key} decode ({TP_DECODE} steps)"] = r["decode_launches"][name]
    return out


def get_arch_layers(arch: str) -> int:
    from repro_torch.configs import get_arch
    return get_arch(arch).num_layers


def tensor_parallel(device, served_moe: dict) -> dict:
    """Phase 6f: (a) the NCCL world of one (``tp_world_of_one``); (b)
    llama4-scout-17b-a16e over a gloo world of 4 on the card; (c) zamba2-7b
    over a gloo world of 2."""
    t0 = time.perf_counter()
    out = {"world_of_one": tp_world_of_one(device, served_moe)}
    print(f"  (b) {TP_ARCH} at full width, {TP_SCOUT_LAYERS} of 48 layers, bf16 "
          f"(and {TP_SCOUT_F32_LAYERS} layer in f32), over a gloo world of "
          f"{TP_SCOUT_WORLD} on the card", flush=True)
    out["scout"] = tp_gloo(device, TP_ARCH, TP_SCOUT_WORLD, TP_SCOUT_LAYERS,
                           f32_layers=TP_SCOUT_F32_LAYERS)
    print(f"  (c) {LM_ARCH} at full width, {TP_ZAMBA_LAYERS} of 81 layers, bf16, "
          f"over a gloo world of {TP_ZAMBA_WORLD} on the card", flush=True)
    out["zamba"] = tp_gloo(device, LM_ARCH, TP_ZAMBA_WORLD, TP_ZAMBA_LAYERS)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6f took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6g: training under a sharding plan (launch/steps.py's train step and
# AA step of a plan, the fsdp regime over "data") and the plan tooling
# (launch/dryrun.py)
# ---------------------------------------------------------------------------

#: (a), (b): granite-moe-3b-a800m at full width with PLAN_LAYERS of its 32
#: layers, f32, PLAN_BATCH documents of PLAN_SEQ tokens, PLAN_HISTORY + 1
#: train steps at PLAN_ETA, then the AA step (m = PLAN_HISTORY); (b) on a
#: (2, 2) mesh of PLAN_WORLD gloo ranks on the card (replica regime, one
#: row a data rank). (c): internvl2-76b at full width with PLAN_VLM_LAYERS
#: of its 80 layers, bf16, its 1024 patch embeddings in PLAN_VLM_SEQ
#: positions, the fsdp regime on the same (2, 2) mesh
PLAN_LAYERS, PLAN_BATCH, PLAN_SEQ, PLAN_ETA, PLAN_HISTORY = 1, 2, 512, 0.05, 3
PLAN_WORLD, PLAN_MESH = 4, (2, 2)
PLAN_VLM_LAYERS, PLAN_VLM_SEQ = 1, 2048
#: (b)'s gates against (a): the loss, rel; each rank's r shard in norm; the
#: AA step's w+ over the largest |w+|; theta. (c)'s against its unsharded
#: bf16 twin: the loss and each rank's r shard in norm
PLAN_LOSS_RTOL, PLAN_GRAD_RTOL, PLAN_W_TOL, PLAN_THETA_TOL = 1e-5, 1e-4, 1e-5, 1e-6
PLAN_BF16_RTOL = 2.0 ** -6
#: a child's deadline (s): start, build, every run
PLAN_CHILD_TIMEOUT = 300.0
#: (d): memory.argument_bytes of the reference's committed dry-run row
#: (benchmarks/results/dryrun/granite-moe-3b-a800m__train_4k__16x16.json)
DRYRUN_GRANITE_BYTES = 1_040_324_608
#: the reference's FL-round dry-run of FedOSAA-SVRG, 2 rounds, in float64
#: with float64 helpers (scripts/reference_dryrun_fl_f64.py). Its float32
#: run, the committed row, is roundoff-bound (ROADMAP.md section 3) and its
#: w* there takes all 50 Newton steps (57-78 s of host-bound products on
#: the card's hosts), so the card runs float64 only
DRYRUN_FL_WORLD, DRYRUN_FL_ROUNDS, DRYRUN_FL_DTYPE = 2, 2, "float64"
DRYRUN_FL = dict(loss=[0.6931471805599453, 0.3813096985425632],
                 rel_error=[0.848635427919707, 0.5358360890821897], comm_bytes=640.0)
DRYRUN_FL_LOSS_RTOL, DRYRUN_FL_REL_RTOL = 1e-6, 1e-5


def plan_config(arch: str, layers: int, dtype: str | None = None):
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def plan_batch(cfg, device, seq: int) -> dict:
    """PLAN_BATCH documents of ``seq`` tokens (seed 0); a vlm config's
    patch embeddings (f32 normals, seed 0, in the model dtype)."""
    from repro_torch.data import make_lm_tokens

    out = {"tokens": torch.from_numpy(make_lm_tokens(PLAN_BATCH, seq, cfg.vocab_size,
                                                     seed=0)).to(device)}
    if cfg.frontend_tokens:
        e = np.random.default_rng(0).standard_normal(
            (PLAN_BATCH, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
        out["embeds"] = torch.from_numpy(e).to(device, getattr(torch, cfg.dtype))
    return out


def flat_of(d: dict, layout) -> torch.Tensor:
    return torch.cat([d[n].reshape(-1) for n, _ in layout])


def train_trajectory(model, batch: dict, layout, steps: int, cut=None) -> dict:
    """``steps`` train steps (launch/steps.py) from the model's parameters
    with a zero correction: the points w_0 .. w_{steps-1} and the residuals
    r_i at w_i, as flat vectors in ``layout`` (each first cut by ``cut``,
    name -> tensor -> tensor, where given), and the losses."""
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(model, eta=PLAN_ETA)
    p = {n: t.detach().clone() for n, t in model.named_parameters()}
    corr = {n: torch.zeros_like(t) for n, t in p.items()}
    cut = cut or (lambda n, t: t)
    ws, rs, losses = [], [], []
    for _ in range(steps):
        ws.append(flat_of({n: cut(n, t) for n, t in p.items()}, layout))
        p, r, loss = step(p, batch, corr)
        rs.append(flat_of({n: cut(n, t) for n, t in r.items()}, layout))
        losses.append(loss.detach())
    return dict(ws=ws, rs=rs, losses=losses)


def aa_inputs(traj: dict) -> tuple:
    """(w, g, S [m, d], Y [m, d]) of a trajectory of m + 1 points: the AA
    step at its last point."""
    ws, rs = traj["ws"], traj["rs"]
    s = torch.stack([ws[i + 1] - ws[i] for i in range(len(ws) - 1)])
    y = torch.stack([rs[i + 1] - rs[i] for i in range(len(rs) - 1)])
    return ws[-1], rs[-1], s, y


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def plan_world_of_one(device, tmp: str) -> dict:
    """Phase 6g (a): an NCCL world of one (mesh (1, 1)), granite at full
    width with PLAN_LAYERS layer(s), f32, its vocabulary padded as (b)'s
    plan pads it: the plan's PLAN_HISTORY + 1 train
    steps (loss, parameters, r) and its AA step bit for bit the unsharded
    port's, the AA step launching the Gram kernel and the AA-step kernel
    once each and nothing else on that path. Saves for (b) the AA step's
    w+ and theta, and the unsharded steps on each data rank's row alone
    from the initial parameters (their mean loss and r: what the (2, 2)
    mesh, whose MoE layer routes each data rank's tokens, computes)."""
    import torch.distributed as dist

    from repro_torch.core.convert import plan_flat_layout
    from repro_torch.core.lm import param_layout
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_aa_step, make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    # the config (b)'s mesh plans (its vocabulary padded for 2 model
    # ranks), so that both draw the same parameters from the seed
    cfg = plan_config(MOE_ARCH, PLAN_LAYERS, "float32").padded(PLAN_MESH[1])
    mesh = make_host_mesh("nccl")
    try:
        plan = make_plan(cfg, mesh)
        if plan.cfg != cfg:
            raise AssertionError("6g (a): the (1, 1) plan pads the config")
        plain = build_model(cfg, device=device, seed=0)
        model = build_model(plan.cfg, device=device, seed=0, sh=plan.sharder())
        batch = plan_batch(cfg, device, PLAN_SEQ)
        layout = param_layout(plain)
        lay, counted = plan_flat_layout(dict(model.named_parameters()), plan, 0)
        d = sum(s.numel() for _, s in layout)
        if lay != layout or counted != d:
            raise AssertionError("6g (a): the plan's flat layout is not the port's")
        torch.cuda.synchronize(device)
        model.sh.counts.clear()
        _build.reset_launches()
        t0 = time.perf_counter()
        traj = train_trajectory(model, batch, layout, PLAN_HISTORY + 1)
        train_launches = dict(_build.LAUNCHES)
        w_p, th_p = make_aa_step(PLAN_ETA, PLAN_HISTORY, plan, counted)(*aa_inputs(traj))
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        counts = {k: dict(v) for k, v in model.sh.counts.items()}
        want = train_trajectory(plain, batch, layout, PLAN_HISTORY + 1)
        w_u, th_u = make_aa_step(PLAN_ETA, PLAN_HISTORY)(*aa_inputs(want))
        same = dict(
            loss=all(torch.equal(a, b) for a, b in zip(traj["losses"], want["losses"])),
            params=all(torch.equal(a, b) for a, b in zip(traj["ws"], want["ws"])),
            r=all(torch.equal(a, b) for a, b in zip(traj["rs"], want["rs"])),
            aa_w=torch.equal(w_p, w_u), aa_theta=torch.equal(th_p, th_u))
        checks = dict(w=float(want["ws"][-1].double().sum()),
                      g=float(want["rs"][-1].double().sum()))
        losses = [float(v) for v in traj["losses"]]
        del traj, want, w_p
        # (b)'s baseline: the unsharded step on each data rank's row alone
        step = make_train_step(plain, eta=PLAN_ETA)
        p0 = {n: t.detach().clone() for n, t in plain.named_parameters()}
        corr = {n: torch.zeros_like(t) for n, t in p0.items()}
        rows = [step(p0, {k: v[i:i + 1] for k, v in batch.items()}, corr)
                for i in range(PLAN_BATCH)]
        r_base = sum(flat_of(r[1], layout) for r in rows) / PLAN_BATCH
        loss_base = float(sum(float(r[2]) for r in rows) / PLAN_BATCH)
        torch.save(dict(w_plus=w_u.cpu(), theta=float(th_u), r_base=r_base.cpu(),
                        layout=layout), os.path.join(tmp, "world_of_one.pt"))
        del rows, r_base, p0, corr, plain, model, w_u
    finally:
        dist.destroy_process_group()
    free_memory()
    aa_launches = {k: launches[k] - train_launches.get(k, 0) for k in launches}
    print(f"  (a) NCCL world of one, mesh (1, 1), {MOE_ARCH} at full width, "
          f"{PLAN_LAYERS} of 32 layers, f32, d = {d:,}, {PLAN_BATCH}x{PLAN_SEQ} "
          f"tokens: {PLAN_HISTORY + 1} train steps and the AA step (m = "
          f"{PLAN_HISTORY}) bit for bit the unsharded port's {same}; losses "
          f"{[f'{v:.6f}' for v in losses]}, theta {float(th_p):.6f}; launches: "
          f"train steps {nonzero(train_launches)}, AA step "
          f"{nonzero(aa_launches)}; collectives {counts}; {secs:.2f} s", flush=True)
    if not all(same.values()):
        raise AssertionError(f"6g (a): the plan's steps are not the unsharded port's: {same}")
    if nonzero(aa_launches) != {"gram": 1, "aa_step": 1} or any(train_launches.values()):
        raise AssertionError(f"6g (a): launches {train_launches} / {aa_launches}")
    return dict(same=same, losses=losses, theta=float(th_p), d=d, checks=checks,
                launches=launches, aa_launches=aa_launches, collectives=counts,
                seconds=secs, loss_base=loss_base)


def vlm_twin(device, tmp: str) -> dict:
    """Phase 6g (c)'s twin: internvl2-76b's padded config for the (2, 2)
    mesh, unsharded, one train step from the seed (zero correction) on
    the card; saves each rank's cut of its r (sharding/specs.py, the fsdp
    plan) and frees it. Also the bytes the specs predict a rank all-gathers
    and reduce-scatters over "data" in a step: each fsdp-split weight's
    shard in, and its whole gradient over "data" in."""
    from repro_torch.core.lm import param_layout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import (make_plan, param_spec_for_path,
                                            rank_coords, shard_param)

    cfg = plan_config(VLM_ARCH, PLAN_VLM_LAYERS)
    D, M = PLAN_MESH
    plan = make_plan(cfg, Mesh({"data": D, "model": M}, {}, 0))
    if plan.regime != "fsdp":
        raise AssertionError(f"6g (c): {VLM_ARCH}'s plan is {plan.regime}")
    t0 = time.perf_counter()
    twin = build_model(plan.cfg, device=device, seed=0)
    batch = plan_batch(plan.cfg, device, PLAN_VLM_SEQ)
    p = {n: t.detach() for n, t in twin.named_parameters()}
    corr = {n: torch.zeros_like(t) for n, t in p.items()}
    torch.cuda.reset_peak_memory_stats(device)
    new, r, loss = make_train_step(twin, eta=PLAN_ETA)(p, batch, corr)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    del new, corr
    ag = rs = 0
    for n, t in r.items():
        spec = param_spec_for_path(n, t.ndim, plan)
        if "data" in spec:
            ag += t.numel() * t.element_size() // (D * M if "model" in spec else D)
            rs += t.numel() * t.element_size() // (M if "model" in spec else 1)
    for rank in range(D * M):
        coords = rank_coords(plan, rank)
        torch.save({n: shard_param(n, t, plan, coords).cpu() for n, t in r.items()},
                   os.path.join(tmp, f"vlm_r{rank}.pt"))
    out = dict(loss=float(loss), n_params=sum(t.numel() for _, t in param_layout(twin)),
               peak_gib=peak, seconds=time.perf_counter() - t0,
               predict=dict(all_gather=ag, reduce_scatter=rs))
    del twin, p, r, batch
    free_memory()
    print(f"  (c) twin: {VLM_ARCH} padded for {M} model ranks, "
          f"{describe(plan.cfg, out['n_params'], 80)}, bf16, {PLAN_BATCH}x"
          f"{PLAN_VLM_SEQ} tokens with {plan.cfg.frontend_tokens} patch embeddings: "
          f"one train step, loss {out['loss']:.6f}, peak {peak:.1f} GiB, "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def plan_child(argv: list) -> int:
    """Phase 6g's child: ``--plan-child <dir>``, one rank of a gloo world of
    PLAN_WORLD on the card: (b) and (c) (``plan_mesh_runs``); writes
    <dir>/rank<r>.pt."""
    import torch.distributed as dist

    from repro_torch.core.sharded import init_file_world
    from repro_torch.kernels import _build

    (d,) = argv
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    init_file_world(backend="gloo", timeout_s=120.0)
    rank = dist.get_rank()
    _build.library()
    out = plan_mesh_runs(d, rank, device)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)),
                                                       1e-300))


def plan_mesh_runs(d: str, rank: int, device) -> dict:
    """One rank's side of phase 6g (b) and (c), on the (2, 2) mesh."""
    from repro_torch.core.convert import plan_flat_layout
    from repro_torch.core.lm import unflatten
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_aa_step, make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan, rank_coords, shard_param

    D, M = PLAN_MESH
    mesh = make_mesh(D, M)
    out = {}
    # (b) granite, replica regime, one row a data rank
    a = torch.load(os.path.join(d, "world_of_one.pt"), weights_only=False, mmap=True)
    cfg = plan_config(MOE_ARCH, PLAN_LAYERS, "float32")
    plan = make_plan(cfg, mesh)
    coords = rank_coords(plan, rank)
    model = build_model(plan.cfg, device=device, seed=0, sh=plan.sharder())
    sh = model.sh
    batch = plan_batch(cfg, device, PLAN_SEQ)
    layout, counted = plan_flat_layout(dict(model.named_parameters()), plan, rank)
    p0 = {n: t.detach().clone() for n, t in model.named_parameters()}
    zero = {n: torch.zeros_like(t) for n, t in p0.items()}
    torch.cuda.synchronize(device)
    sh.counts.clear()
    _build.reset_launches()
    t0 = time.perf_counter()
    _, r, loss = make_train_step(model, eta=PLAN_ETA)(p0, batch, zero)
    torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    step_counts = {k: dict(v) for k, v in sh.counts.items()}
    base = unflatten(a["r_base"], a["layout"])
    grad_rel = max(_rel_norm(r[n], shard_param(n, base[n], plan, coords).to(device))
                   for n in r)
    out["b"] = dict(loss=float(loss), grad_rel=grad_rel, step_s=step_s,
                    step_counts=step_counts, counted=counted,
                    d=sum(s.numel() for _, s in layout))
    del r, base, p0, zero
    # the AA step's inputs: the unsharded port's trajectory, (a)'s, cut to
    # this rank's layout
    plain = build_model(plan.cfg, device=device, seed=0)
    traj = train_trajectory(plain, batch, layout, PLAN_HISTORY + 1,
                            cut=lambda n, t: shard_param(n, t, plan, coords))
    del plain
    free_memory()
    w, g, s, y = aa_inputs(traj)
    aa = make_aa_step(PLAN_ETA, PLAN_HISTORY, plan, counted)
    torch.cuda.synchronize(device)
    _build.reset_launches()
    w_new, theta = aa(w, g, s, y)
    torch.cuda.synchronize(device)
    aa_launches = dict(_build.LAUNCHES)
    want = flat_of({n: shard_param(n, t, plan, coords)
                    for n, t in unflatten(a["w_plus"], a["layout"]).items()}, layout)
    out["b"].update(
        w_err=float((w_new.cpu() - want).abs().max()) / float(want.abs().max()),
        theta=float(theta), theta_err=abs(float(theta) - a["theta"]),
        aa_launches=aa_launches, aa_counts=dict(aa.counts),
        losses=[float(v) for v in traj["losses"]])
    del traj, w, g, s, y, w_new, want, model, a
    free_memory()
    # (c) internvl2-76b, the fsdp regime over "data"
    cfg = plan_config(VLM_ARCH, PLAN_VLM_LAYERS)
    plan = make_plan(cfg, mesh)
    model = build_model(plan.cfg, device=device, seed=0, sh=plan.sharder())
    sh = model.sh
    batch = plan_batch(plan.cfg, device, PLAN_VLM_SEQ)
    p0 = {n: t.detach() for n, t in model.named_parameters()}
    zero = {n: torch.zeros_like(t) for n, t in p0.items()}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    sh.counts.clear()
    t0 = time.perf_counter()
    _, r, loss = make_train_step(model, eta=PLAN_ETA)(p0, batch, zero)
    torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    want = torch.load(os.path.join(d, f"vlm_r{rank}.pt"), weights_only=False)
    out["c"] = dict(loss=float(loss), step_s=step_s,
                    grad_rel=max(_rel_norm(r[n], want[n].to(device)) for n in r),
                    counts={k: dict(v) for k, v in sh.counts.items()},
                    peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                    param_gib=sum(t.numel() * t.element_size()
                                  for t in p0.values()) / 2**30)
    del model, p0, zero, r, want
    free_memory()
    return out


def plan_spawn(tmp: str) -> tuple[list, float]:
    """The gloo world of PLAN_WORLD children of this script on the card
    (``--plan-child <dir>``); a rank that fails fails the phase."""
    from repro_torch.core.sharded import spawn_world

    t0 = time.perf_counter()
    results = spawn_world([sys.executable, str(ROOT / "chip_smoke.py"), "--plan-child",
                           tmp], PLAN_WORLD, os.path.join(tmp, "store"),
                          timeout_s=PLAN_CHILD_TIMEOUT, cwd=str(ROOT))
    secs = time.perf_counter() - t0
    for r, res in enumerate(results):
        if res.returncode != 0:
            raise AssertionError(f"6g rank {r} of {PLAN_WORLD} exited "
                                 f"{res.returncode}: {res.stdout[-3000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(PLAN_WORLD)], secs


def plan_kernels(device, floor: float, d_rank: int, counted: int) -> dict:
    """Rows 2 and 3 at (b)'s rank shape: the Gram pass over a rank's counted
    prefix and the AA step (m = PLAN_HISTORY, f32) on its whole shard, with
    the ‖g‖² the plan step gives and without; each against its plain
    version, timed beside its bound, the plain version's and (the Gram
    pass) torch.bmm's time. Random histories (seed 11)."""
    from repro_torch.core.anderson import AAConfig
    from repro_torch.kernels.anderson import aa_step, flat_gram
    from repro_torch.kernels.anderson.ref import aa_step_ref, gram_ref

    gen = torch.Generator(device=device).manual_seed(11)
    m = PLAN_HISTORY

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
    s, y = 0.01 * randn(1, m, d_rank), 0.01 * randn(1, m, d_rank)
    w, g = randn(d_rank), 0.01 * randn(d_rank)
    yc, gc = y[:, :, :counted].contiguous(), g[:counted]
    gram, yg = flat_gram(yc, gc)
    gp, ygp = gram_ref(yc, gc)
    gn2 = torch.linalg.vector_norm(gc, dtype=torch.float64).square().to(torch.float32).reshape(1)
    cfg = AAConfig(tikhonov=1e-8)
    kw = dict(damping=cfg.damping, tikhonov=cfg.tikhonov, filter_rtol=cfg.filter_rtol,
              clip_rtol=cfg.clip_rtol)
    out = {}
    terms = (yc.abs() @ gc.abs().unsqueeze(-1)).squeeze(-1)
    out["gram"] = dict(
        shape=f"K=1 m={m} d={counted} float32 (a rank's counted prefix)",
        abs=max(float((gram - gp).abs().max()), float((yg - ygp).abs().max())),
        rel=max(rel_diff(gram, gp)[0], rel_diff(yg, ygp, terms)[0]),
        ms=device_ms(lambda: flat_gram(yc, gc), device),
        plain_ms=device_ms(lambda: gram_ref(yc, gc), device),
        library_ms=device_ms(lambda: torch.bmm(yc, yc.transpose(1, 2)), device),
        bound=bound_ms(nbytes(yc, gc, gram, yg),
                       {torch.float32: counted * 2 * (m * (m + 1) // 2 + m)}))
    for label, given in (("given |g|^2", gn2), ("own |g|^2", None)):
        got = aa_step(w, g, s, y, gram, yg, PLAN_ETA, **kw, g_norm2=given)
        want = aa_step_ref(w, g, s, y, gram, yg, PLAN_ETA, **kw, g_norm2=given)
        out[f"aa_step {label}"] = dict(
            shape=f"K=1 m={m} d={d_rank} float32 (a rank's shard)",
            abs=float((got[0] - want[0]).abs().max()),
            theta_equal=torch.equal(got[2], want[2]) if given is not None else None,
            ms=device_ms(lambda: aa_step(w, g, s, y, gram, yg, PLAN_ETA, **kw,
                                         g_norm2=given), device),
            plain_ms=device_ms(lambda: aa_step_ref(w, g, s, y, gram, yg, PLAN_ETA,
                                                   **kw, g_norm2=given), device,
                               n=3, repeats=3),
            library_ms=None,
            bound=bound_ms(nbytes(s, y, w, g, gram, yg, got[0], got[1]),
                           {torch.float32: 4.0 * (m + 1) * d_rank}))
    for k, v in out.items():
        print(f"  {k:22s} [{v['shape']}]: max abs err vs plain {v['abs']:.3e}"
              + (f" (rel {v['rel']:.2e})" if "rel" in v else "") + ", "
              f"{v['ms']:.4f} ms (plain {v['plain_ms']:.4f}"
              + (f", torch.bmm {v['library_ms']:.4f}" if v["library_ms"] else "")
              + f"), bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), launch floor "
              f"{floor:.4f} ms", flush=True)
    del s, y, w, g, yc
    free_memory()
    return out


def dryrun_fl_child(argv: list) -> int:
    """Phase 6g (d)'s child: ``--dryrun-fl-child <dir>``, one rank of a
    gloo world of DRYRUN_FL_WORLD on the card: launch/dryrun.py's FL round
    of FedOSAA-SVRG in DRYRUN_FL_DTYPE on CUDA tensors; writes
    <dir>/rank<r>.json."""
    import torch.distributed as dist

    from repro_torch.core.sharded import init_file_world
    from repro_torch.launch.dryrun import dryrun_fl_round

    (d,) = argv
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    init_file_world(backend="gloo", timeout_s=120.0)
    out = dryrun_fl_round("fedosaa_svrg", rounds=DRYRUN_FL_ROUNDS, device=device,
                          dtype=DRYRUN_FL_DTYPE)
    with open(os.path.join(d, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


class DryrunStart:
    """Phase 6g (d)'s processes, started at the phase's start and running
    beside (a)-(c): ``dryrun_one`` in a subprocess (the fake world of 256,
    meta tensors: no card) and the FL round's gloo world of
    DRYRUN_FL_WORLD children on the card (host-bound: w* by Newton-CG)."""

    def __init__(self, tmp: str):
        import threading

        from repro_torch.core.sharded import spawn_world

        self.tmp, self.fl_dir = tmp, os.path.join(tmp, "fl")
        os.makedirs(self.fl_dir)
        self.t0 = time.perf_counter()
        self.meta = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", MOE_ARCH,
             "--shape", "train_4k", "--out-dir", tmp], cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.fl = {}

        def run():
            self.fl["results"] = spawn_world(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-fl-child",
                 self.fl_dir], DRYRUN_FL_WORLD, os.path.join(self.fl_dir, "store"),
                timeout_s=PLAN_CHILD_TIMEOUT, cwd=str(ROOT))
            self.fl["seconds"] = time.perf_counter() - self.t0

        self.thread = threading.Thread(target=run)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.meta.poll() is None:
            self.meta.wait(timeout=PLAN_CHILD_TIMEOUT)

    def stop(self):
        if self.meta.poll() is None:
            self.meta.kill()
        self.thread.join()


def plan_dryrun(start: DryrunStart) -> dict:
    """Phase 6g (d): launch/dryrun.py (``DryrunStart``'s runs, joined).
    ``dryrun_one`` of granite-moe-3b-a800m train_4k on the fake world of
    256: argument bytes the committed reference row's. ``--fl-round
    fedosaa_svrg --fl-rounds 2 --fl-dtype float64`` on a gloo world of
    DRYRUN_FL_WORLD with CUDA tensors: the loss curve within
    DRYRUN_FL_LOSS_RTOL and the rel-error curve within DRYRUN_FL_REL_RTOL
    of the reference's (DRYRUN_FL), the bytes equal."""
    start.join()
    tmp, fl_dir, meta, results = start.tmp, start.fl_dir, start.meta, start.fl["results"]
    fl_s = start.fl["seconds"]
    for r, res in enumerate(results):
        if res.returncode != 0:
            raise AssertionError(f"6g (d) FL rank {r} exited {res.returncode}: "
                                 f"{res.stdout[-3000:]}")
    fl = [json.load(open(os.path.join(fl_dir, f"rank{r}.json")))
          for r in range(DRYRUN_FL_WORLD)]
    text = meta.stdout.read()
    if meta.returncode != 0:
        raise AssertionError(f"6g (d) dryrun_one exited {meta.returncode}: {text[-3000:]}")
    one = json.load(open(os.path.join(tmp, "granite-moe-3b-a800m__train_4k__16x16.json")))
    print(f"  (d) dryrun_one {MOE_ARCH} train_4k on the fake world of 256 (rank 0 "
          f"on meta tensors, torch {torch.__version__}'s fake backend, "
          f"{one['trace_s']} s): argument_bytes "
          f"{one['memory']['argument_bytes']:,} (the reference's committed row: "
          f"{DRYRUN_GRANITE_BYTES:,}), output_bytes {one['memory']['output_bytes']:,}, "
          f"flops {one['flops']:.4e} (FlopCounterMode), collectives "
          f"{ {k: v for k, v in one['collectives'].items() if k != 'by_axis'} }, "
          f"AA step {one['aa_step']}", flush=True)
    bad = []
    if one["memory"]["argument_bytes"] != DRYRUN_GRANITE_BYTES:
        bad.append(f"argument_bytes {one['memory']['argument_bytes']}")
    want = DRYRUN_FL
    for r, g in enumerate(fl):
        print(f"  (d) --fl-round fedosaa_svrg rank {r} of {DRYRUN_FL_WORLD} "
              f"({g['backend']}, {g['device']}, {g['dtype']}; {g['client_shards']} "
              f"client shards standing for the {g['mesh']} mesh; w* and set-up "
              f"{g['setup_s']} s, {g['run_s']} s a round): loss curve "
              f"{g['loss_curve']} (reference {want['loss']}), rel-error curve "
              f"{g['rel_error_curve']} (reference {want['rel_error']}), bytes "
              f"{g['comm_bytes']} ({want['comm_bytes']}), Gram cond "
              f"{g['gram_cond_curve']}", flush=True)
        if not np.allclose(g["loss_curve"], want["loss"], rtol=DRYRUN_FL_LOSS_RTOL, atol=0):
            bad.append(f"rank {r} loss {g['loss_curve']}")
        if not np.allclose(g["rel_error_curve"], want["rel_error"],
                           rtol=DRYRUN_FL_REL_RTOL, atol=0):
            bad.append(f"rank {r} rel error {g['rel_error_curve']}")
        if g["comm_bytes"] != want["comm_bytes"] or g["client_shards"] != DRYRUN_FL_WORLD:
            bad.append(f"rank {r} bytes {g['comm_bytes']}")
    print(f"  (d) the FL world took {fl_s:.1f} s from the phase's start", flush=True)
    if bad:
        raise AssertionError("6g (d): " + "; ".join(bad))
    return dict(dryrun_one=one, fl=fl, fl_seconds=fl_s)


def plan_training(device, floor: float) -> dict:
    """Phase 6g: (a) the plan's train and AA steps in an NCCL world of one,
    bit for bit the unsharded port's; (b) granite on the (2, 2) mesh of
    PLAN_WORLD gloo ranks on the card against (a); (c) internvl2-76b in
    the fsdp regime on that mesh against its unsharded twin; rows 2 and 3
    at (b)'s rank shapes; (d) the dry-run."""
    import tempfile

    from repro_torch.core.convert import plan_flat_layout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="plan_")
    dryrun = DryrunStart(tmp)
    try:
        out = {"a": plan_world_of_one(device, tmp)}
        out["twin"] = vlm_twin(device, tmp)
        ranks, secs = plan_spawn(tmp)
        out["children_seconds"] = secs
        a, twin = out["a"], out["twin"]
        bad = []
        for r, got in enumerate(ranks):
            b, c = got["b"], got["c"]
            loss_rel = abs(b["loss"] - a["loss_base"]) / abs(a["loss_base"])
            print(f"  (b) rank {r} of the (2, 2) mesh (replica, one row a data rank): "
                  f"d {b['d']:,}, counted {b['counted']:,}; train step loss "
                  f"{b['loss']:.7f} vs (a)'s rows {a['loss_base']:.7f} (rel "
                  f"{loss_rel:.2e}), r shards vs (a)'s cut, largest rel in norm "
                  f"{b['grad_rel']:.2e}; {b['step_s']:.2f} s, collectives "
                  f"{b['step_counts']}; the AA step on (a)'s trajectory cut to the "
                  f"rank: w+ vs (a)'s {b['w_err']:.2e}, theta {b['theta']:.7f} (err "
                  f"{b['theta_err']:.1e}), launches {nonzero(b['aa_launches'])}, "
                  f"collectives {b['aa_counts']}", flush=True)
            if not (loss_rel <= PLAN_LOSS_RTOL and b["grad_rel"] <= PLAN_GRAD_RTOL
                    and b["w_err"] <= PLAN_W_TOL and b["theta_err"] <= PLAN_THETA_TOL):
                bad.append(f"(b) rank {r}: loss {loss_rel:.2e}, grad {b['grad_rel']:.2e}, "
                           f"w+ {b['w_err']:.2e}, theta {b['theta_err']:.2e}")
            if nonzero(b["aa_launches"]) != {"gram": 1, "aa_step": 1}:
                bad.append(f"(b) rank {r}: AA step launches {b['aa_launches']}")
            if b["losses"] != a["losses"]:
                bad.append(f"(b) rank {r}: the unsharded trajectory's losses "
                           f"{b['losses']} are not (a)'s {a['losses']}")
            data = {k: v["by_axis"].get("data", {"calls": 0, "bytes": 0})
                    for k, v in c["counts"].items()}
            loss_rel = abs(c["loss"] - twin["loss"]) / abs(twin["loss"])
            print(f"  (c) rank {r} (fsdp, {c['param_gib']:.2f} GiB of weights, peak "
                  f"{c['peak_gib']:.1f} GiB): loss {c['loss']:.6f} vs the twin's "
                  f"{twin['loss']:.6f} (rel {loss_rel:.2e}), r shards vs the twin's cut, "
                  f"largest rel in norm {c['grad_rel']:.2e}; {c['step_s']:.2f} s; over "
                  f"\"data\": all-gathered {data.get('all_gather', {}).get('bytes', 0):,} B "
                  f"(the specs predict {twin['predict']['all_gather']:,}), "
                  f"reduce-scattered {data.get('reduce_scatter', {}).get('bytes', 0):,} B "
                  f"({twin['predict']['reduce_scatter']:,}); collectives {c['counts']}",
                  flush=True)
            if not (loss_rel <= PLAN_BF16_RTOL and c["grad_rel"] <= PLAN_BF16_RTOL):
                bad.append(f"(c) rank {r}: loss {loss_rel:.2e}, grad {c['grad_rel']:.2e}")
        if bad:
            raise AssertionError("6g: " + "; ".join(bad))
        out["ranks"] = ranks
        D, M = PLAN_MESH
        plan = make_plan(plan_config(MOE_ARCH, PLAN_LAYERS, "float32"),
                         Mesh({"data": D, "model": M}, {}, 0))
        shards = dict(build_model(plan.cfg, device="meta", sh=plan.sharder())
                      .named_parameters())
        layout, counted = plan_flat_layout(shards, plan, 0)
        out["d"] = plan_dryrun(dryrun)
        # timed with the card to itself: after (d)'s world is done
        out["kernels"] = plan_kernels(device, floor, sum(s.numel() for _, s in layout),
                                      counted)
    finally:
        dryrun.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6g took {out['seconds']:.1f} s (the {PLAN_WORLD} children "
          f"{out['children_seconds']:.1f} s)", flush=True)
    return out


def plan_launches_by_run(plan: dict, name: str) -> dict:
    """A kernel's launches in each run of phase 6g, for its kernels row:
    (a)'s AA step and each rank's of (b)."""
    launched = FUSED_KERNELS.get(name, name)
    out = {"6g (a) plan train steps + AA step, world of one":
           plan["a"]["launches"].get(launched, 0)}
    for r, got in enumerate(plan["ranks"]):
        out[f"6g (b) rank {r} AA step"] = got["b"]["aa_launches"].get(launched, 0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--checkpoint-child"]:
        return checkpoint_child(sys.argv[2:])
    if sys.argv[1:2] == ["--sharded-child"]:
        return sharded_child(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-child"]:
        return tp_child(sys.argv[2:])
    if sys.argv[1:2] == ["--plan-child"]:
        return plan_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dryrun-fl-child"]:
        return dryrun_fl_child(sys.argv[2:])
    from repro_torch.core import solve_reference
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    device = torch.device("cuda", 0)
    start = time.perf_counter()

    def clock() -> str:
        """Seconds since the card was found, before each phase's line."""
        return f"[{time.perf_counter() - start:.1f} s]"
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, sm_"
          f"{''.join(map(str, torch.cuda.get_device_capability(0)))}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"{clock()} phase 1: kernels built in {_build.build_seconds or 0.0:.1f} s "
          f"(nvcc), loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    X, y = make_binary_classification("covtype", n=N_PAPER, seed=0)
    clients = partition(X, y, K_MAIN, "iid", seed=0, device=device)
    print(f"  paper-scale data: N={N_PAPER}, K={K_MAIN}, n_k="
          f"{clients.x.shape[1]}, d={clients.x.shape[2]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    print(f"{clock()} phase 2: kernels against their plain versions", flush=True)
    floor = launch_floor(device)
    quant = check_quant(device, floor)
    uplink = check_uplink(device, floor)
    checks = {dt: check_kernels(clients, dt, device, floor)
              for dt in (torch.float64, torch.float32)}
    aa_wide = check_aa_step_wide(device, floor)
    lm_checks = check_lm_kernels(device, floor)

    print(f"{clock()} phase 3: acceptance configuration (n=10,000, K=10, float64)",
          flush=True)
    accept = acceptance(device)

    print(f"{clock()} phase 4: paper scale (N=581,012, K=100)", flush=True)
    t0 = time.perf_counter()
    w_star = solve_reference(
        make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device),
        iters=100)
    print(f"  w* by Newton-CG in {time.perf_counter() - t0:.1f} s", flush=True)
    paper = paper_scale(clients, w_star, device)
    no_host_read(clients, device)
    print(f"{clock()} phase 4b: the trajectory family at paper scale (float64, 10 "
          "rounds)", flush=True)
    family = trajectory_family(clients, w_star, device)
    print(f"{clock()} phase 4c: the Newton family at paper scale (float64, 10 rounds)",
          flush=True)
    newton = newton_family(clients, w_star, device, paper)
    print(f"{clock()} phase 4d: cohorts (participation {COHORT_PARTICIPATION} at paper "
          f"scale; the ext_cohort point)", flush=True)
    t0 = time.perf_counter()
    cohort = cohorts(clients, w_star, device, floor,
                     {**paper, **family, **newton},
                     checks[torch.float64]["trajectory"])
    print(f"  phase 4d took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{clock()} phase 4e: the robustness layer (faults and the deadline gate: "
          "ext_robustness, ext_async, paper scale)", flush=True)
    t0 = time.perf_counter()
    robust = dict(ext_robustness=ext_robustness(device),
                  ext_async=ext_async(device),
                  paper=robust_paper(clients, w_star, device,
                                     {**paper, **family, **newton,
                                      **cohort["runs"]}))
    print(f"  phase 4e took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{clock()} phase 4f: checkpoint and resume (kill and resume at paper "
          "scale, dense and cohort; a real process death; the snapshot; "
          "ext_checkpoint)", flush=True)
    t0 = time.perf_counter()
    ckpt = checkpoint_resume(clients, w_star, device)
    print(f"  phase 4f took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{clock()} phase 4g: the distributed runtime (an NCCL world of one "
          f"at paper scale; a gloo world of {SHARD_WORLD} on the card)",
          flush=True)
    t0 = time.perf_counter()
    sharded = {**sharded_world_of_one(clients, w_star, device, paper, cohort),
               **sharded_gloo_world(accept["w_star"], clients, device, floor,
                                    cohort)}
    print(f"  phase 4g took {time.perf_counter() - t0:.1f} s", flush=True)
    fl_runs = {**paper, **family, **newton, **cohort["runs"],
               **robust["paper"],
               **{k: v for k, v in ckpt.items() if k.startswith("ckpt_")},
               **{k: v for k, v in sharded.items()
                  if k.startswith("sharded_")}}

    print(f"{clock()} phase 5: the wire on the ext_compression config (n=20,000, K=20, "
          "float64)", flush=True)
    compression(device)
    if "--profile" in sys.argv[1:]:
        for channel in (None, "int8"):
            profile_rounds(clients, device, channel)
            profile_engine(clients, device, channel)
    del clients
    torch.cuda.empty_cache()

    print(f"{clock()} phase 6: serving {LM_ARCH} at full width (prefill {LM_BATCH}x"
          f"{LM_PROMPT}, {LM_DECODE} decode steps, the slot server)", flush=True)
    served = serving(device)
    free_memory()

    print(f"{clock()} phase 6b: federated training ({FL_LM_ARCH} at full width, "
          "the Gram pass and the AA step at its width, the engine, the ssm and "
          "hybrid families, the launchers, Fig. 8)", flush=True)
    trained = federated_training(device, floor)
    fl_runs.update({k: v for k, v in trained["full_width"].items()})
    fl_runs.update(trained["engine"])
    fl_runs.update(trained["families"])
    fl_runs.update({f"fig8_{k}": v for k, v in trained["fig8"].items()})

    print(f"{clock()} phase 6c: serving {MOE_ARCH} at full width (prefill "
          f"{LM_BATCH}x{LM_PROMPT}, {LM_DECODE} decode steps, the slot server)",
          flush=True)
    t0 = time.perf_counter()
    served_moe = serving(device, MOE_ARCH, MOE_PREFILL_LAUNCHES, keep=TP_DECODE)
    free_memory()
    print(f"  phase 6c took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{clock()} phase 6d: training the MoE family ({MOE_ARCH} at full width, "
          f"{MOE_FL_LAYERS} of 32 layers; the engine and train.main on the reduced "
          "configs)", flush=True)
    moe_trained = moe_training(device)
    fl_runs.update(moe_trained["full_width"])
    fl_runs.update(moe_trained["engine"])
    print(f"{clock()} phase 6e: frontend embeddings, the int8 KV cache and the "
          f"gather GQA mode ({AUDIO_ARCH} at full width; {VLM_ARCH} at full width, "
          f"{VLM_LAYERS} of 80 layers)", flush=True)
    features = last_features(device)
    print(f"{clock()} phase 6f: tensor-parallel serving ((a) {MOE_ARCH} over an "
          f"NCCL world of one; (b) {TP_ARCH} at full width, {TP_SCOUT_LAYERS} of 48 "
          f"layers, over a gloo world of {TP_SCOUT_WORLD} on the card; (c) {LM_ARCH}, "
          f"{TP_ZAMBA_LAYERS} of 81 layers, over a gloo world of {TP_ZAMBA_WORLD})",
          flush=True)
    tp = tensor_parallel(device, served_moe)
    print(f"{clock()} phase 6g: training under a sharding plan ((a) {MOE_ARCH}, "
          f"{PLAN_LAYERS} of 32 layers, f32, an NCCL world of one; (b) the same on "
          f"a {PLAN_MESH} mesh of {PLAN_WORLD} gloo ranks on the card; (c) "
          f"{VLM_ARCH}, {PLAN_VLM_LAYERS} of 80 layers, bf16, the fsdp regime on "
          f"that mesh; (d) the dry-run)", flush=True)
    plan = plan_training(device, floor)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name in LM_KERNELS:
            r = lm_checks[f"{name}/zamba2-7b"]
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=served["launches"][name],
                launches_by_run={"prefill": served["launches"][name],
                                 f"decode ({LM_DECODE} steps)":
                                     served["decode_launches"][name],
                                 "slot server": served["server_launches"][name],
                                 f"{MOE_ARCH} prefill": served_moe["launches"][name],
                                 f"{MOE_ARCH} decode ({LM_DECODE} steps)":
                                     served_moe["decode_launches"][name],
                                 f"{MOE_ARCH} slot server":
                                     served_moe["server_launches"][name],
                                 **phase_6e_launches(features, name),
                                 **tp_launches_by_run(tp, name),
                                 # phase 6b's training runs launch neither
                                 **{run: r_["launches"][name]
                                    for run, r_ in fl_runs.items()
                                    if run.startswith("lm_")}},
                max_abs_err=r["abs"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"][0], bound_by=r["bound"][1],
                library_ms=r["library_ms"], launch_floor_ms=floor,
                library=r["library"],
                shape=r["shape"], bf16_steps=r.get("bf16_steps"),
                blocks_per_sm=r.get("occupancy", {}).get("blocks_per_sm"),
                rerun_equal=r.get("rerun_equal"), bound_split=r.get("bound_split"),
                bound_ms_f32_count=(r["bound_f32_count"][0]
                                    if r.get("bound_f32_count") else None),
                other_shapes=[dict(
                    shape=o["shape"], max_abs_err=o["abs"],
                    bf16_steps=o.get("bf16_steps"), ms=o["ms"],
                    plain_ms=o["plain_ms"], bound_ms=o["bound"][0],
                    bound_by=o["bound"][1], library_ms=o["library_ms"],
                    blocks_per_sm=o.get("occupancy", {}).get("blocks_per_sm"))
                    for k, o in lm_checks.items()
                    if k.startswith(name + "/") and o is not r]))
            continue
        wire = name in ("quantize", "dequantize")
        # a TPU kernel computed on the main path by a fused launch reports
        # that launch's count and its readings at the main shape (float64;
        # the wire's: the gradient uplink)
        launched = FUSED_KERNELS.get(name, name)
        r = (uplink["main/grad"] if wire else checks[torch.float64]["aa_step"]
             if name == "update" else checks[torch.float64][name])
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paper["float64_int8" if wire else "float64"]["launches"][launched],
            launches_by_run={run: r_["launches"][launched]
                             for run, r_ in fl_runs.items()},
            max_abs_err=r["abs"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            launch_floor_ms=floor)
        if name in ("gram", "update"):
            row["launches_by_run"].update(plan_launches_by_run(plan, name))
            row["plan_rank"] = {k: dict(
                shape=v["shape"], max_abs_err=v["abs"], ms=v["ms"],
                plain_ms=v["plain_ms"], library_ms=v["library_ms"],
                bound_ms=v["bound"][0], bound_by=v["bound"][1])
                for k, v in plan["kernels"].items()
                if k.startswith("gram" if name == "gram" else "aa_step")}
        if name == "trajectory":
            ps = r["per_step"]
            row["anchor_scale_0"] = {f"{design}/{str(dt)[6:]}": dict(
                shape=a["shape"], max_abs_err=a["abs"], ms=a["ms"],
                plain_ms=a["plain_ms"], bound_ms=a["bound"][0],
                bound_by=a["bound"][1], rerun_equal=a["rerun_equal"])
                for dt in checks for design, a in
                checks[dt]["trajectory"]["anchor0"].items()}
            row["launches_by_design"] = {
                run: r_["designs"] for run, r_ in fl_runs.items()}
            row["cohort"] = {
                "paper_scale": cohort["trajectory"],
                "ext_cohort": cohort["ext_cohort"]["trajectory"],
                "sharded_w2_slots": sharded["cohort_w2"]["trajectory"]}
            row.update(plan=r["plan"], rerun_equal=r["rerun_equal"],
                       per_step_shape=dict(
                           shape=ps["shape"], design=ps["design"],
                           max_abs_err=ps["abs"], ms=ps["ms"],
                           plain_ms=ps["plain_ms"], bound_ms=ps["bound"][0],
                           bound_by=ps["bound"][1], rerun_equal=ps["rerun_equal"]))
        if name == "gram":
            row["lm_width"] = {label: dict(
                shape=g_["shape"], parts=g_["parts"], max_abs_err=g_["abs"],
                rel=g_["rel"], ms=g_["ms"], plain_ms=g_.get("plain_ms"),
                library_ms=g_.get("library_ms"), bound_ms=g_["bound"][0],
                bound_by=g_["bound"][1], rerun_equal=g_["rerun_equal"],
                block_design=g_.get("block"))
                for label, g_ in trained["gram"].items()}
        if name in ("gram", "update"):
            kind = "gram" if name == "gram" else "aa_step"
            row["variants"] = {f"{label}/{str(dt)[6:]}": dict(
                shape=v["shape"], max_abs_err=v["abs"], rel=v["rel"],
                ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                bound_by=v["bound"][1], rerun_equal=v["rerun_equal"])
                for dt in checks for label in ("g[K,d]", "m=15")
                for v in (checks[dt][f"{kind} {label}"],)}
        if name == "gram":
            row.update(kernel_us=r["kernel_us"],
                       library_kernel_us=r["library_kernel_us"],
                       blocks_per_sm=r["occupancy"]["blocks_per_sm"])
        if name == "update":
            upd = checks[torch.float64]["update"]
            row["launched_as"] = launched
            row["aa_step"] = {key: dict(
                shape=a["shape"], blocks_per_client=a["blocks_per_client"],
                max_abs_err=a["abs"], rel=a["rel"], ms=a["ms"],
                kernel_us=a["kernel_us"], composed_ms=a["composed_ms"],
                composed_us=a["composed_us"],
                composed_kernels=a["composed_kernels"], eigh_ms=a["eigh_ms"],
                eigh_us=a["eigh_us"], plain_ms=a["plain_ms"],
                bound_ms=a["bound"][0], bound_by=a["bound"][1],
                sweeps=a["sweeps"], plain_equal=a["plain_equal"],
                rerun_equal=a["rerun_equal"])
                for key, a in (("main/float64", r),
                               ("main/float32", checks[torch.float32]["aa_step"]),
                               ("wide/float32", aa_wide),
                               ("lm/float32", trained["aa_step"]))}
            row["standalone"] = dict(
                max_abs_err=upd["abs"], ms=upd["ms"], plain_ms=upd["plain_ms"],
                bound_ms=upd["bound"][0], bound_by=upd["bound"][1],
                library_ms=upd["library_ms"],
                launches={run: r_["launches"]["update"]
                          for run, r_ in fl_runs.items()})
        if wire:
            row["launched_as"] = launched
            row["uplink"] = {key: dict(
                shape=u["shape"], max_abs_err=u["abs"], ms=u["ms"],
                composed_ms=u["composed_ms"], plain_ms=u["plain_ms"],
                bound_ms=u["bound"][0], bound_by=u["bound"][1],
                **({"without_post_ms": u["without_post_ms"]}
                   if "without_post_ms" in u else {}))
                for key, u in uplink.items()}
            row["standalone"] = {shape: dict(
                max_abs_err=q[name]["abs"], ms=q[name]["ms"],
                plain_ms=q[name]["plain_ms"], bound_ms=q[name]["bound"][0],
                bound_by=q[name]["bound"][1], library_ms=q[name]["library_ms"],
                launches={run: r_["launches"][name]
                          for run, r_ in fl_runs.items()})
                for shape, q in quant.items()}
        rows.append(row)
    f32 = {name: {k: v for k, v in r.items()}
           for name, r in checks[torch.float32].items()}
    print("float32 kernels " + json.dumps(f32), flush=True)
    print("serving " + json.dumps(served), flush=True)
    print(f"serving {MOE_ARCH} " + json.dumps(served_moe), flush=True)
    print("training the MoE family " + json.dumps(moe_trained), flush=True)
    print("phase 6e " + json.dumps(features), flush=True)
    print("phase 6f " + json.dumps(tp), flush=True)
    print("phase 6g " + json.dumps({k: v for k, v in plan.items() if k != "d"}
                                   | {"d": {"dryrun_one": plan["d"]["dryrun_one"],
                                            "fl": plan["d"]["fl"]}}), flush=True)
    print("federated training " + json.dumps(
        {k: v for k, v in trained.items() if k not in ("gram", "aa_step")}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
