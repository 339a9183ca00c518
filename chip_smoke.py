#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root)

Phases, one line each, any failure exits non-zero:

1. device   — a CUDA card is present; its name and power limit.
2. build    — the CUDA kernels built from ``src/repro_torch/kernels/csrc``;
              ptxas's registers, shared memory and spills of every
              instantiation of the implicit GEMM (the integer conv and
              shift conv), the float implicit GEMM (the float conv and
              every add conv mode), the float shift conv, the depthwise
              conv, the float matmul, the integer matmul (every tile, int8
              and W4), the int8 and float pools' vector kernels and the
              causal conv1d's vector kernel (bf16, K = 4).
3. kernels  — each of the eighteen kernel entry points (six int8, five
              W4, six float32 / bfloat16 and the float causal_conv1d) held
              bitwise against its plain PyTorch version at every
              shape of the dws, standard, shift and add plans at B=256, a
              groups=2 conv, odd and even-HK shapes, shift tables with
              |shift| up to 2 and with every channel on one shift, add
              pre-shifts (0,0), (0,3), (2,0) and one that wraps int32, and
              requant shifts {-2, 0, 1, 7} with relu and bias on and off;
              the W4 modes with random packed nibbles (-8 and +7 included),
              group shifts in [0, 4] (all 4 in some cases), odd Cx (a pad
              nibble) and depthwise HK 1, 2, 3, 5 and 7; the staged-row
              depthwise kernel also at C = 7 and 19, x at an odd address and
              a 300-wide row (runs of columns), in every mode; the integer
              add on the float implicit GEMM's body also at pre-shifts
              (31,0) and (0,31), HK 1, 2, 5 and 7, Cy = 20 and 24, x at an
              odd address and the tuner's Table-2 int8 add job (timed, not
              summed), W4 with odd Cx and every group shift at 4; the int8
              pool also at C = 19 (its scalar path), x at an odd address,
              windows 3/2 and 2/1; the
              redesigned rows (the integer matmul, the int8 pool) printed
              beside their earlier times; the LM's matmul_q8 and
              matmul_w4 at Qwen2-0.5B's decode shapes (8x896x4864,
              8x4864x896), prefill shapes (16, 32, 64 and 128 x896x4864,
              64x4864x896), granite-3-2b's decode shapes (8x2048x8192,
              8x8192x2048; summed over its step's 120 launches on a line
              of their own) and prefill shapes (16, 32, 64 and 128
              x2048x8192 and x8192x2048) and ragged ones
              (K = 45, 33 and 4864 with N = 37 and 100, M = 1, 5, 13, 17
              and 70), operands at an odd address, requant shifts -2 to
              16, W4 nibbles -8 and +7 with every group shift at 4; the
              integer conv's implicit GEMM also at the
              tuner's Table-2 int8 jobs (Cx = 128 at 10^2, g = 1 and 4;
              16->16 at 32^2, n = 1 and 8; timed with the standard plan's
              conv1 and conv2, not summed), HK 5 and 7, groups of 3, odd
              Cx/g in W4, Cy = 20 and x at an odd address; the integer
              shift conv on the same implicit GEMM at |shift| up to 3, C =
              9 and 19, C = 130 (K chunks), Cy = 20 with x at an odd
              address, W4 with every group shift at 4 and the tuner's
              Table-2 int8 shift jobs (n = 1 and 8, timed, not summed); the
              launch arithmetic of the integer conv, the float conv and
              the add conv, the shift conv (integer and float), the
              depthwise conv, the float matmul (every tile), the integer
              matmul (every tile and cluster size) and the int8 pool
              (vector or scalar) equal to their sources'; causal_conv1d at Falcon-Mamba's
              prefill shapes (1 x L x 8192 bf16 for L = 16, 33, 96 and 256, and
              8 x 64 x 8192), in float32, at D = 100 with K 1, 2 and 4 and
              relu on and off, with (K,1,D) weights, and its backward (dx
              bitwise against flip-plain-flip, dw against the plain
              reduction, both within 1e-5 of autograd through the plain
              version); the float modes of conv2d, depthwise2d,
              maxpool2d, shift_conv2d, add_conv2d and matmul in float32
              and bfloat16 at the tuner's Table-2 jobs, at every layer
              shape of the four CNN plans at B=256 and at edges (HK 1, 2
              and 5, groups, C = 19, the pool at C = 4, 8, 12 and 64
              with windows 2/2, 3/2 and 4/3, NaN taps of three bit
              patterns (compared bit for bit) and x at an odd address,
              each timed pool beside its scalar path on the same values,
              shifts up to 3 at C = 5, C = 130 with
              x at an unaligned address, the add at HK = 5, Cx = 19, Cy =
              20 and the conv at ci = 130, g = 2, both with x at an
              unaligned address, M = 1, K = 33 and 45, matmuls of
              37x45x33 and 257x513x255 and with operands at unaligned
              addresses, relu and bias on and off); every config of the
              tuner's space of every
              entry point, at one shape each, bitwise equal to the default
              config's output; per main-path shape the kernel's time, its
              bound, the plain version's time and one PyTorch call's time
              as a yardstick (device times from torch.profiler, TF32 off),
              and the time of back-to-back wrapper calls.
check      — the static checks (repro_torch.check), after phase 3:
              phase 4's plans lowered and built here, each build verified
              by validate_plan (dataflow and int32 accumulator /
              requant-shift safety from the weight codes); for each plan
              its least accumulator headroom in bits, its weight bytes and
              the ms validate_plan adds to its build; a copy of the int8
              dws plan with a broken scale chain refused by CompiledPlan
              (CheckError) before any kernel wrapper's count moves, and
              built with validate=False; the lint (repro_torch.check.
              astlint) over the port's tree, 0 findings. After phase 9,
              the Hopper verdict (check_schedule) of every config phases
              4, 5, 8 and 9 resolved, with this build's ptxas registers:
              all ok, the count with a warning (a spill) and the largest
              registers x threads; then the audit of phase 8's cache.
4. plan     — CNNConfig(primitive=...) for "dws", "standard", "shift" and
              "add" at full width with seeded random weights, lowered with
              a 256-image calibration batch on the card (in the check
              phase), with int8 weights
              and with W4 weights (weight_bits=4, group_size=32; and one
              standard plan at group_size=8): method="cuda" trunk bitwise
              equal to method="torch" and to a host run, logits within
              1e-5; a W4 forward launches no int8 conv kernel. Every plan
              is served captured (jit=True, one CUDA graph per batch
              size): this phase warms and captures each plan at every
              bucket phase 5 serves (256, and 64 for the ragged round of
              37) before phase 5 sets the counts to 0, holds each
              bucket's captured trunk (its capture call and a replay)
              bitwise against the same plan with jit=False, a replay's
              launches equal to an eager forward's, and at each bucket
              the launches its capture recorded (which every replay adds
              to the counts) equal to the port's kernels that
              torch.profiler sees one replay run on the card.
5. serve    — CNNEngine(max_batch=256) over 2,085 images of the int8 dws
              plan (8 full rounds and a ragged round of 37) and 549 images
              each of the int8 shift and add plans and the W4 dws, shift
              and add plans (2 full rounds and a ragged round of 37),
              launch counts set to 0 before each run: every status ok, no
              error or retry, each plan's kernels launched exactly as often
              as its forwards need and no other kernel, all nine kernels
              launched across the six runs (each round one replay of a
              graph phase 4 captured), logits equal to the plan's
              forward_batch; then a breakdown of one 256-image round of
              each plan: the captured plan and the same plan with
              jit=False in one run, each with its device-resident
              forward ms, device busy ms and idle share and throughput
              images/s, beside the card's name and power limit.
6. lm       — Qwen2-0.5B at full width and depth (24 layers, d_model 896,
              d_ff 4864, vocab 151,936), seeded random weights made on the
              card, served by Engine(max_batch=8, max_len=256): 24 requests,
              prompts of 16-96 tokens, 32 new tokens each, greedy, captured
              (jit=True: one decode graph, one prefill graph per bucket),
              in the precisions "int8", "int8-torch", "w4a8"
              (group_size=32), "w4a8-torch" and "float", and "int8",
              "int8-torch" and "float" over the int8 KV cache; each engine
              warmed up with one request into every prefill bucket the
              timed run serves (16, 32, 64, 128), each graph's first call
              (eager pass + capture) printed, so that the timed run only
              replays; every status ok, the kernel precisions' token
              streams equal to their plain versions' (the int8-KV ones
              too), matmul_q8 (int8) or matmul_w4 (w4a8) launched exactly
              72 times per prefill and per decode step and no other kernel;
              "float" and "int8" again with jit=False on the first 8
              requests, their token streams equal to the captured
              engines'; the float engine's token agreement over the int8
              KV cache printed; tokens/s, decode-step ms and TTFT per
              engine. The same model's other serve paths, each run
              printing its tokens/s, decode_tok_s, step ms, TTFT, graphs,
              pool gauges and launch counts, its pool audited empty after
              the drain: (a) the paged KV cache (16-position pages,
              prefix cache off) in "float", "int8" and "int8" over the
              int8 KV cache, streams equal to the contiguous engine's;
              (b) prefix traffic (24 requests sharing a 64-token system
              prompt, each with its own 8-40-token suffix: every prompt
              in bucket 128), and mixed-bucket prefix traffic (24
              requests sharing a 48-token prompt, every other one with a
              1-16-token suffix, in bucket 64, the rest with a 17-72-token
              one, in bucket 128), each paged with the prefix cache and
              contiguous, in "float" and in "int8" over the int8 KV
              cache: streams equal, hit rate above 0, the mixed traffic
              with hits in both buckets and hits that cross buckets (the
              first prefill of a bucket hitting pages a prefill of the
              other bucket wrote: page digests are unsalted, and a paged
              engine with the prefix cache prefills through
              api.shared_prefill_fn, GEMMs in row blocks of one shape;
              the contiguous engine it is held to takes the same prefill
              function); the
              prefix exactness measured (the prefix rows' K/V at buckets
              64, 128 and 256, prefill_suffix against the whole prompt),
              each run with its miss's and hits' prefill latency;
              (c) a tight pool (kv_num_blocks=41) in "float", streams
              equal to the contiguous engine's (with the shared-page
              prefill, as in (b)), with at least one
              preemption (an engine.block_free span with preempt=True);
              (d) the static scheduler in "float", "int8" and
              "int8-torch" (one decode graph for batch 8), "float" and
              "int8" equal to jit=False on the first 8 requests and
              "int8" to "int8-torch"; (e) attn_impl="flash_tri" on the
              contiguous engine, its agreement with "flash" printed. Then
              one decode step's
              device breakdown (its count of device operations, kernels
              and memsets) captured and with jit=False for float, int8,
              w4a8, int8 over the int8 KV cache and float and int8 over
              the paged cache, and the captured prefill against the eager
              one at buckets 32 and 128.
chaos      — the chaos harness (repro_torch.faults.chaos) at full size,
              after phase 6, on its Qwen2-0.5B weights and phase 4's int8
              dws plan: each schedule a clean and a faulted drain on fresh
              engines, every request in a terminal status, survivors
              bitwise the clean run's, the paged pool audited empty, spans
              balanced, no stream left capturing, no entry point run as
              its plain version, degraded 0. LM: Engine(max_batch=8,
              max_len=256, precision="int8") over 12 of phase 6's prompts,
              32 new tokens each, greedy, under tests/test_faults.py's
              matrix (a prefill raise absorbed; prefill retries
              exhausted; decode retries exhausted with the arena rebuilt;
              a corrupt round contained; a deadline of 0.5 s against a
              0.2 s stall of every decode round; shedding by reject and
              drop; the paged pool's blockpool.alloc fault; a paged
              decode error; the static scheduler's prefill raise, decode
              raise and corrupt round; the probability matrix at seed 0)
              and one kernels.dispatch raise, contiguous (in the eager pass
              of the first prefill's capture) and paged (inside that
              capture). CNN: CNNEngine(max_batch=256) over 293 images (a
              full round and a ragged one of 37): a round raise absorbed,
              a round's retries exhausted (error, the next round ok), a
              corrupt round contained, and kernels.dispatch raising on a
              fresh plan in its first capture's eager pass, inside the
              capture, and on every attempt (every round error). One
              line a schedule (fired, statuses, survivors, poisoned,
              retries, arena rebuilds or degraded, pool violations, entry
              point calls by method, seconds). Then one engine of each,
              warm, drains its traffic four times, tracing off, on, off,
              on: the last traced drain exported to build/ as Chrome
              trace-event JSON (its events, request lanes, span balance)
              and each drain's tokens/s or images/s.
7. ssm      — Falcon-Mamba-7B at full width and depth (64 layers, d_model
              4096, d_inner 8192, d_state 16, d_conv 4, dt_rank 256, vocab
              65,024; 7.27 B parameters), seeded random weights made on the
              card after phase 6's model is freed, served by
              Engine(max_batch=8, max_len=256) in "float", its decode step
              captured (each prompt prefilled eagerly at its exact length):
              16 requests, prompts of 16-96 tokens, 32 new tokens each,
              greedy, after a two-request warm-up; every status ok,
              causal_conv1d launched exactly 64 times per prefill and never
              in a decode step, no other kernel; the first 4 requests again
              with jit=False, token streams equal; mamba_forward with the
              kernel bitwise equal to the plain version on three layers at
              a served prompt; tokens/s, decode-step ms, TTFT p50/p99 and
              one decode step's device breakdown, captured and with
              jit=False; one 96-token prefill's breakdown (its time,
              device busy and idle, device operations, the 64
              causal_conv1d launches' time and the copy kernels), and the
              same prefill with x_in copied before each conv taking
              exactly 64 device operations more.
8. tune     — the autotuner: ``python -m repro_torch.tune``'s main over
              the paper's Table-2 jobs and the four CNN primitives' int8
              and W4 plans at B=256, plus the tuner's float32 and bfloat16
              pool jobs, every candidate ranked by device time (each
              candidate's time printed); the cache
              written under build/repro_torch/, reloaded and installed; the
              int8 dws and W4 shift plans of phase 4 served through
              CompiledPlan with it, trunks bitwise equal to phase 4's,
              configs read from the cache, throughput in images/s tuned
              and on the analytic configs; every kernel but matmul_w4
              (which no job runs) launched; the host time of a memo-hit
              config lookup. The tuned plans are new CompiledPlans, so
              each captures its graphs after the cache is installed, and
              node_configs shows the configs it captured with.
9. cnn-flow — the paper's deployment flow (examples/train_cnn_torch.py)
              for each of the five primitives: CNNConfig(widths=(16, 32,
              64)) at 32x32 trained from seeded weights for 100 AdamW
              steps (lr 2e-3, warmup 20, cosine) at batch 64 on
              IndexedDataset(kind="image", seed=7), TF32 off and cuDNN
              deterministic, launching no int8 kernel; the mean loss of
              the last 10 steps below the first 10's; a checkpoint at step
              50 restored into fresh state reproduces the uninterrupted
              run's losses within 1e-4; then calibrate_bn, quantize_cnn(
              method="cuda"), its first forward launching exactly one
              eager forward and one replay, its captured trunk bitwise
              equal to method="torch"'s on 256 test images; profile of the
              int8 plan at B=256 (a line per row: measured us, MACs, the
              MCU latency and energy model); steps/s, training images/s
              and the float / int8 top-1 agreement (printed, not gated).
10. families — the moe, vlm and further dense configs, seeded random
              weights made on the card after phase 7's model is freed,
              each model freed before the next is made, all served by
              Engine(max_batch=8, max_len=256) on phase 6's prompts taken
              into each model's vocabulary:
              granite-moe-1b-a400m at full width and depth (24 layers, 32
              experts top-8, 1.33 B parameters) in "float", captured, over
              the contiguous, paged and int8 KV caches (every status ok;
              the paged and int8 streams' agreement with contiguous
              printed), its first 8 requests again with jit=False
              (streams equal; the (token, expert) pairs a decode step
              drops at capacity printed), precision="int8" refused with
              JAX's message and one decode step's breakdown;
              internvl2-1b at full width (0.49 B), served text-only in
              "float", "int8", "int8-torch", "w4a8" and "w4a8-torch",
              captured (kernel streams equal to the -torch ones,
              matmul_q8 / matmul_w4 exactly 72 times a prefill and a
              decode step), one prefill_fn call with 256 patch embeddings
              ahead of a prompt then 16 decode steps, and the gate: a
              prefill whose embeds are the embeddings of a prompt's first
              tokens, then its other tokens, bitwise equal (logits and
              cache) to the prefill of the whole prompt; granite-3-2b at
              full width (2.53 B) in the same five precisions (kernel
              streams equal to the -torch ones, 120 launches a prefill
              and a step); granite-34b (33.96 B) and qwen1.5-32b (35.20
              B) with bf16 weights in "float", each after its reckoned
              peak (weights, the float32 copy of the unembedding that
              unembed makes, held by the eager allocator and the graph
              pool, the KV cache) is printed, at full depth where 4 GB of
              the card stays free under it, else at the most layers that
              leave it (the cut printed): 8 requests of 16 new tokens,
              captured, the first 2 again with jit=False (streams
              equal), the peak memory printed.
11. encdec-hybrid — the last two families, each model freed before the
              next is made: seamless-m4t-large-v2 at full size (24
              encoder and 24 decoder layers, d_model 1024, vocab
              256,206; its parameter count printed), seeded weights made
              on the card, the matrices cast to bf16 once, one batch of
              8 requests (seeded stub frames (8, 256, 1024) bf16, the
              speech frontend a stub as in JAX; 16-token prompts; 32 new
              tokens, greedy) through api.prefill_fn / api.decode_fn, the
              decode step captured once with graph.capture over a cache
              it updates in place, then the same batch eager: streams
              equal, no kernel of the port launched; TTFT of the batch,
              decode-step ms (CUDA events), the captured step's device
              busy and idle (torch.profiler) beside its byte bound.
              jamba-v0.1-52b at full width with bf16 weights, cut in
              whole super-blocks of 8 layers to the most whose reckoned
              peak (weights, the float32 unembedding copies, the K/V of
              its attention sublayers and its Mamba state, counted
              directly, the static prefill's scan) leaves 4 GB free (the
              cut printed; the measured peak must stay under it), served by
              Engine(max_batch=8, max_len=256) to 8 of phase 6's prompts,
              16 new tokens, captured, causal_conv1d launched exactly 7
              times a super-block per prefill and never in a decode step;
              the first 2 again with jit=False (streams equal; the
              (token, expert) pairs a decode step drops printed); the
              static scheduler on the same 8 requests, captured and again
              with jit=False (streams equal; its agreement with the
              continuous engine printed: the left pads run through the
              recurrence); one decode step's breakdown, the byte
              bound of its weights at 3.35 TB/s, the peak memory.

12. train   — LM training, after phase 11's model is freed. (a) Qwen2-0.5B
              at full size (24 layers, d_model 896, vocab 151,936, tied),
              seeded float32 params made on the card, bf16 compute,
              TrainConfig(remat="full", attn_impl="flash"), AdamW (warmup
              2 of 8 steps), IndexedDataset(kind="lm", seq_len=512,
              global_batch=8, seed=11): 8 steps through Trainer (in-place
              updates), a checkpoint every 4 steps under build/; every
              loss and gradient norm finite, nothing skipped, the last loss
              below the first plus 0.5; a new Trainer resumed from the
              step-4 checkpoint to step 8, its losses within 1e-4 of the
              straight run's; step 0 with attn_impl="full" within 2e-3
              (loss) and 1e-2 (gradient norm) of flash's; step ms (CUDA
              events, median of steps 2-8, each begun with no checkpoint
              write in flight), tokens/s, model TFLOP/s
              (estimate_model_flops) and its share of the bf16 peak, one
              step's device busy and idle (torch.profiler), the peak
              memory beside its reckoning; the step-8 checkpoint restored
              into bf16 and served by Engine(max_batch=8, max_len=256),
              captured, to 8 of phase 6's prompts (16 new tokens, every
              status ok), the first 2 again with jit=False, streams
              equal. (b) Falcon-Mamba-7B at full width (d_model 4096,
              d_inner 8192, d_state 16, vocab 65,024), cut in whole layers
              to the most whose reckoned training peak leaves 8 GB free
              (the cut and the reckoning printed), float32 params, bf16
              compute, remat "full", 2 x 256 tokens: one loss and gradient
              through api.loss_fn launching causal_conv1d exactly 3 times
              a layer (forward, recompute, dx) and its plain version
              never, the loss and every gradient leaf bitwise equal to a
              loss built here layer by layer from ssm_layer(...,
              conv_method="torch"); then 4 timed in-place train steps
              and up to 4 profiled ones after them, each launching
              causal_conv1d 3 times a layer by the wrapper's count and
              nothing else of the port's; torch.profiler's count by kernel
              name the same in one profiled step's session and above it
              in none (a session in a long run now and then drops a few
              device records, so the steps stop at the first whole one);
              every loss finite, the peak
              memory under the reckoning; step ms, tokens/s, the conv
              launches' device time a step (forward and recompute apart
              from dx) and the selective scan's share of the step.

13. launch  — the port's dry run and roofline count, after phase 12's
              models are freed. (a) ``python -m repro_torch.launch.dryrun
              --all --jobs 6``, started before phase 10 at nice 19 (CPU
              work only, beside phases 10-12) and waited for here, in a
              subprocess that sees no card
              (torch.distributed's fake backend, meta tensors): 80 records
              under JAX's cell names, 64 ok and 16 skipped (long_500k on
              the eight full-attention archs), none an error, every ok
              record with its ``collectives`` (rank 0's step at its local
              shapes inside the cell's mesh: train cells under their own
              rules, serve cells under spmd_rules), none across pods at
              16x16, some across pods in every 2x16x16 train cell whose
              FSDP axes include "pod" (``dryrun.record_faults``); its wall
              time, each ok cell's first-device argument GB at 16x16
              beside the card's memory, and each ok cell's collective GB
              in pod and across pods beside its argument GB. (b) ``roofline.count`` on the card
              for three steps: Qwen2-0.5B's int8 decode step at 8 slots
              (counted eager, timed over replays of its captured graph;
              72 matmul_q8 calls), a 96-token Falcon-Mamba-7B prefill at
              full width cut to 8 layers (one causal_conv1d call a layer)
              and Qwen2-0.5B's train step at 8 x 512: FLOPs by kind, the
              bytes floor, the device ms (tune.device_kernels), the
              roofline terms at the card model's peaks and the binding
              share, which must be at most 1; each counted kernel's calls
              equal to its wrapper's launches and to torch.profiler's
              launches of its device kernel; the decode step's work the
              same with every kernel call run as its plain version
              (``kernels.ops.force_method("torch")``).

14. shard   — the sharded serve paths, after phase 13: a world of 2 ranks
              as threads of this process on the one card
              (``launch.world.run_world``, torch's threaded process group;
              its backend, rank count and torch.cuda.device_count()
              printed), a (1, 2) ("data", "model") mesh. (a) SP decode:
              granite-3-2b at full size (40 layers, d_model 2048, 32 / 8
              heads), seeded weights, 2 prompts of 512 tokens prefilled
              outside the mesh into 4,096 positions, each rank holding
              2,048 (cache_specs under spmd_rules(make_rules(...,
              sp=True))), 32 greedy lockstep steps through
              api.decode_fn(cfg, sp_axis="model") in float32 compute over
              a float32 cache: tokens equal to the unsharded decode's,
              logits within 1e-4, each rank's K/V half the whole cache's;
              then 8 steps in the config's bf16, fed the unsharded
              decode's tokens (SP rounds the softmax otherwise: a near
              tie may part the greedy streams), logits within 0.2, token
              agreement printed, and beside it the unsharded bf16 decode
              against the unsharded float32 one on float32's tokens; step
              ms of both. (b) EP MoE: granite-moe-1b-a400m at full
              size with capacity_factor E / top_k = 4 (printed as a
              change of the config), 16 experts a rank: layer 0's
              moe_ffn_sharded on an (8, 64, 1024) input against
              moe_ffn_local within atol 2^-5, rtol 2^-6 (its ms beside
              the local path's), then 16 greedy decode steps of 8 slots
              inside the mesh, every layer's FFN on the EP path: tokens
              equal to the same decode outside the mesh. (c) a kernel
              under the mesh: a 96-token Falcon-Mamba-7B prefill at full
              width cut to 8 layers on each rank inside the mesh:
              causal_conv1d launched 8 times a rank on the "cuda" route
              (no kernels.fallback.causal_conv1d.mesh), logits and state
              bitwise the prefill outside the mesh. The phase must end
              within 60 s.
15. train-shard — the sharded training step (FSDP + TP, ZeRO-3), after
              phase 14, on worlds of threads on the one card as phase 14's.
              (a) Qwen2-0.5B at full size (24 layers, d_model 896, 14 / 2
              heads, d_ff 4,864, vocab 151,936, tied), float32 params and
              compute (printed as a change of the config), remat full,
              flash attention: 8 ranks on a (2, 2, 2) ("pod", "data",
              "model") mesh under make_rules(..., "train", fsdp=True), 2
              steps on IndexedDataset(kind="lm", seq_len=512,
              global_batch=8) batches, each rank on its blocks and its 2
              rows, against the unsharded step on the same batches: loss
              and grad norm within 1e-4 relative, the params gathered back
              to global within 1e-3 of the update in norm and 2 lr a step
              elementwise (TSHARD_UPDATE_REL), each rank's param + m + v bytes
              equal to local_bytes under tree_shardings(param_specs)
              (printed beside the unsharded bytes); step ms of both (a
              reading: the threads share the interpreter lock). (d) on
              (a)'s world, allreduce_compressed over the 8 ranks of each
              rank's step-0 gradients (before the sum over ranks that hold
              copies): within 0.08 of the mean per leaf, residuals not
              zero, its ms beside the plain psum's. (b) the sharded
              Trainer on that world, (a)'s model at full width cut to 4
              layers (its checkpoints' writes), 4 steps with a checkpoint
              at step 2
              (gathered, written by the mesh's first rank); a new world of
              2 ranks on a (1, 2) ("data", "model") mesh restores step 2,
              each block bitwise the slice of the stored global array,
              and takes 2 more steps, losses within 1e-4 of the straight
              run's. (c) Falcon-Mamba-7B at full width (d_model 4,096,
              d_inner 8,192, vocab 65,024) cut to 4 layers, float32
              compute, on a (2, 2) ("data", "model") world of 4 ranks: one
              sharded step of 2 x 256 tokens against the unsharded one
              (the bounds of (a));
              causal_conv1d launched on the "cuda" route exactly 3 times a
              layer a rank (forward, recompute, dx) on 4,096 channels, its
              plain version never. (e) seamless-m4t-large-v2 at full width
              (d_model 1,024, 16 / 16 heads, d_ff 8,192, vocab 256,206,
              tied) cut to 4 encoder and 4 decoder layers (the run's time),
              float32, on (a)'s world: two sharded steps of 8 rows (128
              frames, 128 + 1 tokens) against the unsharded ones, (a)'s
              gates (the params gathered back and compared on rank 0). (f)
              jamba-v0.1-52b at full width (d_model 4,096, d_inner 8,192,
              32 / 8 heads) cut to one super-block (7 Mamba sublayers, 1
              attention, 4 MoE FFNs), its experts cut to 2 (top-2, nothing
              dropped) and its FFN width to 1,024 (the reckoning printed:
              at d_ff 14,336 the world's state and its ranks' FSDP gathers
              pass the card's memory), float32, on (a)'s world: the
              unsharded step first, its params and result then on the host,
              one sharded step of 8 x 32 tokens, (a)'s gates (params
              compared on rank 0);
              causal_conv1d launched on the "cuda" route exactly 3 times a
              Mamba sublayer a rank (21) on 4,096 channels, its plain
              version never; the world's collectives (roofline.count)
              include EP's all-to-all. The phase must end within 150 s.

The phases run in the order 1-3, check, 4, 5, 8, 9, the check of their
configs, 6, chaos, 7, 10, 11, 12, 13, 14, 15; each one's wall time is printed
as it ends ([time]). The second-to-last
line is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 256
N_SERVE = 8 * BATCH + 37
N_SHORT = 2 * BATCH + 37
#: images served per plan: the int8 dws plan's run is the long one
SERVED = {"dws": N_SERVE, "shift": N_SHORT, "add": N_SHORT,
          "dws-w4": N_SHORT, "shift-w4": N_SHORT, "add-w4": N_SHORT}
#: kernel launches per forward of each served plan (widths 16/32/64)
PER_FORWARD = {
    "dws": {"conv2d_q8": 3, "depthwise2d_q8": 2, "maxpool2d_s8": 3},
    "shift": {"conv2d_q8": 1, "shift_conv2d_q8": 2, "maxpool2d_s8": 3},
    "add": {"add_conv2d_q8": 3, "maxpool2d_s8": 3},
    "dws-w4": {"conv2d_w4": 3, "depthwise2d_w4": 2, "maxpool2d_s8": 3},
    "shift-w4": {"conv2d_w4": 1, "shift_conv2d_w4": 2, "maxpool2d_s8": 3},
    "add-w4": {"add_conv2d_w4": 3, "maxpool2d_s8": 3},
}
#: plans lowered in phase 4: (primitive, weight_bits, group_size). The
#: group_size=8 plan's weights fall by an octave from one group of 8 input
#: channels to the next, so its layers carry several distinct group shifts.
PLANS = {"dws": ("dws", 8, 32), "standard": ("standard", 8, 32),
         "shift": ("shift", 8, 32), "add": ("add", 8, 32),
         "dws-w4": ("dws", 4, 32), "standard-w4": ("standard", 4, 32),
         "shift-w4": ("shift", 4, 32), "add-w4": ("add", 4, 32),
         "standard-w4-g8": ("standard", 4, 8)}
#: phase 4 captures each served plan at the buckets phase 5 serves: full
#: rounds of 256 and the ragged round of 37, padded to 64
CAPTURED_BUCKETS = (BATCH, 1 << (N_SHORT % BATCH - 1).bit_length())
#: the device kernel (a part of its name in a torch.profiler record) that
#: each CNN wrapper launches once per call; wrappers that share one kernel
#: are summed
DEVICE_KERNEL = {"conv2d_q8": "igemm_kernel", "conv2d_w4": "igemm_kernel",
                 "shift_conv2d_q8": "igemm_kernel",
                 "shift_conv2d_w4": "igemm_kernel",
                 "add_conv2d_q8": "fgemm_kernel",
                 "add_conv2d_w4": "fgemm_kernel",
                 "depthwise2d_q8": "depthwise2d_kernel",
                 "depthwise2d_w4": "depthwise2d_kernel",
                 "maxpool2d_s8": "maxpool2d_s8"}
#: the plan whose B=256 forward each kernel's times are summed over
TIMED_PLAN = {"conv2d": "dws", "depthwise2d": "dws", "maxpool2d": "dws",
              "shift_conv2d": "shift", "add_conv2d": "add"}
#: the W4 mode's pre-shifts (x, w) and requant shift of each add layer
W4_ADD_PRESHIFTS = ((0, 3, 9), (2, 0, 9), (28, 20, 24))
#: phase 6: the served model and its traffic
LM_ARCH = "qwen2-0.5b"
#: (precision, KV cache) of the captured engines; LM_EAGER again with
#: jit=False on the first LM_EAGER_REQUESTS requests
LM_RUNS = (("int8", "float"), ("int8-torch", "float"), ("w4a8", "float"),
           ("w4a8-torch", "float"), ("float", "float"), ("int8", "int8"),
           ("int8-torch", "int8"), ("float", "int8"))
LM_EAGER, LM_EAGER_REQUESTS = ("float", "int8"), 8
#: the served engines whose decode step is broken down
LM_BREAKDOWN = ("float", "int8", "w4a8", "int8 kv=int8", "float paged",
                "int8 paged")
#: the prefill buckets whose captured and eager times are printed
LM_PREFILL_TIMED = (32, 128)
LM_BATCH, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 8, 256, 24, 32
LM_PROMPT = (16, 96)
#: phase 6's other serve paths on the same model and prompts: the paged
#: layout (pages of LM_BLOCK positions) without the prefix cache, per
#: (precision, KV cache), held against the contiguous engine's streams
LM_BLOCK = 16
LM_PAGED = (("float", "float"), ("int8", "float"), ("int8", "int8"))
#: prefix traffic: a LM_SHARED-token system prompt (4 pages) shared by
#: every request, each with its own suffix of LM_SUFFIX tokens, served
#: paged (prefix cache on) and contiguous, per (precision, KV cache)
LM_SHARED, LM_SUFFIX = 64, (8, 40)
#: mixed-bucket prefix traffic: a LM_MIXED_SHARED-token prompt (3 pages),
#: every other request's suffix of LM_MIXED_SUFFIX[0] tokens (bucket 64),
#: the rest's of LM_MIXED_SUFFIX[1] (bucket 128)
LM_MIXED_SHARED, LM_MIXED_SUFFIX = 48, ((1, 16), (17, 72))
LM_PREFIX = (("float", "float"), ("int8", "int8"))
#: the tight pool: 40 usable pages for 8 slots of up to 8 pages each
LM_TIGHT_BLOCKS = 41
#: the static scheduler's precisions; LM_EAGER again with jit=False on
#: the first LM_EAGER_REQUESTS requests
LM_STATIC = ("float", "int8", "int8-torch")
#: each kernel precision's matmul entry point; 3 FFN matmuls per layer
LM_KERNEL = {"int8": "matmul_q8", "w4a8": "matmul_w4"}
#: phase 7: the served ssm model and its traffic (prompts as in phase 6)
SSM_ARCH = "falcon-mamba-7b"
SSM_REQUESTS = 16
#: of them served again with jit=False
SSM_EAGER_REQUESTS = 4
#: mamba_forward layers held kernel against plain version at full width
SSM_CHECK_LAYERS = 3
#: the prompt length of phase 7's prefill breakdown (the longest served)
SSM_BREAKDOWN_LEN = 96
#: phase 3: causal_conv1d at Falcon-Mamba's prefill shapes (B, L), bf16,
#: d_inner 8192, K=4; the L=96 row (the longest served prompt) is summed
#: over one prefill's 64 launches into the kernel's JSON row
C1D_SHAPES = ((1, 16), (1, 33), (1, 96), (1, 256), (8, 64))
C1D_WIDTH, C1D_TAPS, C1D_SUMMED = 8192, 4, (1, 96)
C1D_PER_PREFILL = 64           # Falcon-Mamba-7B's layers


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_model():
    """The card's peaks: ``repro_torch.core.energy``'s H100 model of the
    card torch sees (the PCIe card's where its name says PCIe)."""
    import torch
    from repro_torch.core.energy import h100_for
    return h100_for(torch.cuda.get_device_name(0))


def sms_and_clock(torch) -> tuple:
    """(SMs, maximum SM clock in MHz as nvidia-smi reports it)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return sms, float(out.stdout.strip().splitlines()[0])


def int32_rate(torch) -> tuple:
    """(ops/s, text): the CUDA cores' int32 rate, SMs x 64 lanes (the
    card model's) x the maximum SM clock (nvidia-smi), the ceiling of
    add-conv, which has no tensor-core form."""
    sms, mhz = sms_and_clock(torch)
    lanes = card_model().int32_lanes_per_sm
    rate = sms * lanes * mhz * 1e6
    return rate, (f"{sms} SMs x {lanes} int32 lanes x "
                  f"{mhz:.0f} MHz = {rate / 1e12:.2f} T ops/s")


def time_ms(torch, fn, reps=20, trials=7) -> float:
    """Median over trials of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_kernels(torch, fn, reps):
    """The device activity of one call of ``fn`` (``repro_torch.tune.
    runner.device_kernels``: one row per kernel with its launches and
    device microseconds per call, from two torch.profiler sessions of
    ``reps`` calls, the records a session lost filled in; on the card's
    machine a session now and then records none or only part of its
    device activity); fails if too few sessions recorded anything."""
    from repro_torch.tune.runner import device_kernels as per_call
    try:
        return per_call(fn, calls=reps)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e


def device_ms(torch, fn, reps=20) -> float:
    """Device time of one call: the summed time of every kernel the call
    launches (torch.profiler), without the host time between launches.
    Fails if no profiler session sees device time."""
    ms = sum(r.us for r in device_kernels(torch, fn, reps)) / 1e3
    check(ms > 0, "torch.profiler saw no device time")
    return ms


def work_ms(work, bw, rates) -> tuple:
    """(bytes ms, operations ms) of ``roofline.count.kernel_work``'s
    ``work``: its bytes at ``bw`` bytes/s, and the slowest of its kinds of
    operations at ``rates[kind]``."""
    return (1e3 * work.nbytes / bw,
            max(1e3 * n / rates[kind] for kind, n in work.ops.items()))


# ---------------------------------------------------------------- phase 3 --

#: the tuner's Table-2 int8 conv jobs (repro_torch.tune.__main__
#: shapes_table2): (n, h, w, cx, cy, hk, groups)
T2_INT8_CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
                (1, 32, 32, 16, 16, 3, 1), (8, 32, 32, 16, 16, 3, 1))


def offset_view(torch, t, offset: int):
    """A contiguous tensor equal to ``t`` whose data starts ``offset``
    elements into a larger buffer: an operand at an unaligned address."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view

def main_path_shapes(primitive: str):
    """(kernel, label, args) of every launch of one plan's forward at
    B=256 (32x32x3 images, widths 16/32/64)."""
    shapes, hw, cin = [], 32, 3
    for i, cout in enumerate((16, 32, 64)):
        if primitive == "add":
            shapes.append(("add_conv2d", f"add{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=3)))
        elif primitive == "shift" and cin >= 4:
            shapes.append(("shift_conv2d", f"shift{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, c=cin, cy=cout, d=1)))
        elif primitive == "dws" and cin >= 4:
            shapes.append(("depthwise2d", f"dw{i} {cin}ch {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, c=cin, hk=3)))
            shapes.append(("conv2d", f"pw{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=1,
                                g=1)))
        else:
            shapes.append(("conv2d", f"conv{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=3,
                                g=1)))
        shapes.append(("maxpool2d", f"pool{i} {cout}ch {hw}^2",
                       dict(n=BATCH, h=hw, w=hw, c=cout)))
        hw, cin = hw // 2, cout
    return shapes


def grid_table(c: int, d: int):
    """The paper's shift assignment (the JAX package's ``init``): channels
    in order round the (2d+1) x (2d+1) displacement grid, int32 (C, 2)."""
    grid = [(a, b) for a in range(-d, d + 1) for b in range(-d, d + 1)]
    return np.array([grid[i % len(grid)] for i in range(c)], np.int32)


def kernel_cases(torch, K, dev, rng):
    """Yield (kernel, label, on_main_path, run_kernel, run_plain, run_lib,
    work) for every comparison of phase 3. ``work`` is the call's
    ``roofline.count.kernel_work``: bytes, and operations by kind (int8
    tensor-core operations; add-conv's |x - w| accumulates and the pool's
    compares on the int32 lanes)."""
    import torch.nn.functional as F
    from repro_torch.core.primitives import shift_channels
    from repro_torch.core.quantize import expand_w4, pack_w4
    from repro_torch.roofline.count import kernel_work

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype("int8")).to(dev)

    def i32(shape):
        return torch.from_numpy(rng.integers(-4096, 4096, shape)
                                .astype("int32")).to(dev)

    def w4(shape, axis, all_max=False):
        """Random int4 codes (-8 and +7 included) packed along ``axis``,
        group shifts in [0, 4] (all 4 with ``all_max``), and the int8 codes
        they expand to (for the yardstick only)."""
        q = rng.integers(-8, 8, shape).astype("int8")
        q.flat[0], q.flat[-1] = -8, 7
        n = shape[axis]
        ws = (np.full(n, 4) if all_max else rng.integers(0, 5, n)) \
            .astype("int8")
        wp = pack_w4(torch.from_numpy(q), axis).contiguous().to(dev)
        ws = torch.from_numpy(ws).to(dev)
        return wp, ws, expand_w4(wp, ws, n, axis)

    def conv(label, n, h, w, cx, cy, hk, g, bias=True, act="relu", shift=7,
             main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, cx))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wp, ws, wt = w4((hk, hk, cx // g, cy), 2, all_max)
        else:
            wt = i8((hk, hk, cx // g, cy))
        b = i32((cy,)) if bias else None
        kw = dict(groups=g, requant_shift=shift, act=act)
        # yardstick: cuDNN float32 convolution of the same (expanded) codes
        # (contraction only), NCHW copies made before timing
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = wt.permute(3, 2, 0, 1).float().contiguous()
        pad = (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)
        xf = F.pad(xf, pad)
        lib = lambda: F.conv2d(xf, wf, groups=g)       # noqa: E731
        if w4_mode:
            return ("conv2d_w4", label, main,
                    lambda: K.conv2d_w4(x, wp, ws, b, **kw),
                    lambda: K.conv2d_w4_plain(x, wp, ws, b, **kw),
                    lib, kernel_work("conv2d_w4", x, wp, b, groups=g,
                                     w_shifts=ws))
        return ("conv2d", label, main,
                lambda: K.conv2d_q8(x, wt, b, **kw),
                lambda: K.conv2d_q8_plain(x, wt, b, **kw),
                lib, kernel_work("conv2d_q8", x, wt, b, groups=g))

    def dw(label, n, h, w, c, hk, act=None, shift=7, layout4=True,
           main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        shape = (hk, hk, c, 1) if layout4 else (hk, hk, c)
        if w4_mode:                      # packed along the tap rows
            wp, ws, wt = w4(shape, 0, all_max)
        else:
            wt = i8(shape)
        kw = dict(requant_shift=shift, act=act)
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        xf = F.pad(xf, (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2))
        wf = wt.reshape(hk, hk, c).permute(2, 0, 1)[:, None].float() \
            .contiguous()
        lib = lambda: F.conv2d(xf, wf, groups=c)       # noqa: E731
        if w4_mode:
            return ("depthwise2d_w4", label, main,
                    lambda: K.depthwise2d_w4(x, wp, ws, **kw),
                    lambda: K.depthwise2d_w4_plain(x, wp, ws, **kw),
                    lib, kernel_work("depthwise2d_w4", x, wp, w_shifts=ws))
        return ("depthwise2d", label, main,
                lambda: K.depthwise2d_q8(x, wt, **kw),
                lambda: K.depthwise2d_q8_plain(x, wt, **kw),
                lib, kernel_work("depthwise2d_q8", x, wt))

    def pool(label, n, h, w, c, win=2, stride=2, main=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        lib = None
        if win == stride and h % win == 0 and w % win == 0:
            # yardstick: one reduction over a free view of the same int8s
            v = x.view(n, h // win, win, w // win, win, c)
            lib = lambda: v.amax(dim=(2, 4))          # noqa: E731
        return ("maxpool2d", label, main,
                lambda: K.maxpool2d_s8(x, window=win, stride=stride),
                lambda: K.maxpool2d_plain(x, window=win, stride=stride),
                lib, kernel_work("maxpool2d_s8", x, window=win,
                                 stride=stride))

    def shift_conv(label, n, h, w, c, cy, table, bias=True, act="relu", rs=7,
                   main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wp, ws, wt = w4((c, cy), 0, all_max)
        else:
            wt = i8((c, cy))
        s = torch.from_numpy(table).to(dev)
        d = int(np.abs(table).max())
        b = i32((cy,)) if bias else None
        kw = dict(requant_shift=rs, act=act, max_shift=max(1, d))
        # yardstick: cuDNN float32 1x1 convolution of the already shifted
        # codes (contraction only), made before timing
        xs = shift_channels(x, s).permute(0, 3, 1, 2).float().contiguous()
        wf = wt.t().float()[:, :, None, None].contiguous()
        lib = lambda: F.conv2d(xs, wf)                 # noqa: E731
        if w4_mode:
            return ("shift_conv2d_w4", label, main,
                    lambda: K.shift_conv2d_w4(x, s, wp, ws, b, **kw),
                    lambda: K.shift_conv2d_w4_plain(x, s, wp, ws, b, **kw),
                    lib, kernel_work("shift_conv2d_w4", x, s, wp, b,
                                     w_shifts=ws))
        return ("shift_conv2d", label, main,
                lambda: K.shift_conv2d_q8(x, s, wt, b, **kw),
                lambda: K.shift_conv2d_q8_plain(x, s, wt, b, **kw),
                lib, kernel_work("shift_conv2d_q8", x, s, wt, b))

    def mm(label, m, k, n, shift=9, act=None, weight=None, w4_mode=False,
           all_max=False, offset=0):
        """One matmul case; ``weight`` is how often the shape runs per
        Qwen2-0.5B decode step (0: timed, not summed; None: bitwise only;
        (model, n): n times per decode step of that model, summed apart);
        ``offset``: every operand that many bytes past an aligned address
        (the kernel's bytewise staging)."""
        a = i8((m, k))
        if w4_mode:
            wp, ws, wt = w4((k, n), 0, all_max)
        else:
            wt = i8((k, n))
        if offset:
            a = offset_view(torch, a, offset)
            if w4_mode:
                wp, ws = (offset_view(torch, t, offset) for t in (wp, ws))
            else:
                wt = offset_view(torch, wt, offset)
        kw = dict(requant_shift=shift, act=act)
        lib = None
        if k % 8 == 0 and n % 8 == 0:
            # yardstick: torch._int_mm on the same (expanded) codes, its a
            # padded with zero rows to 32 where M <= 16 (its shape rule),
            # made before timing; the int32 product only
            ap = a if m > 16 else torch.cat(
                [a, a.new_zeros((32 - m, k))]).contiguous()
            lib = lambda: torch._int_mm(ap, wt)        # noqa: E731
        if w4_mode:
            return ("matmul_w4", label, weight,
                    lambda: K.matmul_w4(a, wp, ws, **kw),
                    lambda: K.matmul_w4_plain(a, wp, ws, **kw),
                    lib, kernel_work("matmul_w4", a, wp, w_shifts=ws))
        return ("matmul", label, weight,
                lambda: K.matmul_q8(a, wt, **kw),
                lambda: K.matmul_q8_plain(a, wt, **kw),
                lib, kernel_work("matmul_q8", a, wt))

    def add_conv(label, n, h, w, cx, cy, hk, xp=2, wp=0, bias=True, act=None,
                 rs=9, main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, cx))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wpk, ws, wt = w4((hk, hk, cx, cy), 2, all_max)
        else:
            wt = i8((hk, hk, cx, cy))
        b = i32((cy,)) if bias else None
        kw = dict(requant_shift=rs, x_preshift=xp, w_preshift=wp, act=act)
        # yardstick: torch.cdist(p=1) between float32 patches extracted
        # beforehand (feature order (c, i, j), as F.unfold gives it) and
        # the filters
        pad = (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pad)
        patches = F.unfold(xf, hk).transpose(1, 2) \
            .reshape(n * h * w, cx * hk * hk).contiguous()
        wf = wt.permute(3, 2, 0, 1).reshape(cy, cx * hk * hk).float() \
            .contiguous()
        lib = lambda: torch.cdist(patches, wf, p=1)    # noqa: E731
        if w4_mode:
            return ("add_conv2d_w4", label, main,
                    lambda: K.add_conv2d_w4(x, wpk, ws, b, **kw),
                    lambda: K.add_conv2d_w4_plain(x, wpk, ws, b, **kw),
                    lib, kernel_work("add_conv2d_w4", x, wpk, b,
                                     w_shifts=ws))
        return ("add_conv2d", label, main,
                lambda: K.add_conv2d_q8(x, wt, b, **kw),
                lambda: K.add_conv2d_q8_plain(x, wt, b, **kw),
                lib, kernel_work("add_conv2d_q8", x, wt, b))

    seen = set()
    for prim in ("dws", "standard", "shift", "add"):
        for kernel, label, a in main_path_shapes(prim):
            key = (kernel, tuple(sorted(a.items())))
            main = prim == TIMED_PLAN[kernel]
            if kernel == "conv2d" and prim == "standard" and not main:
                main = 0                      # timed, not summed
            if key in seen and not main:
                continue
            seen.add(key)
            tag = f"{prim} {label}"
            if kernel == "conv2d":
                yield conv(tag, a["n"], a["h"], a["w"], a["cx"], a["cy"],
                           a["hk"], a["g"], main=main)
            elif kernel == "depthwise2d":
                yield dw(tag, a["n"], a["h"], a["w"], a["c"], a["hk"],
                         main=main)
            elif kernel == "shift_conv2d":
                yield shift_conv(tag, a["n"], a["h"], a["w"], a["c"],
                                 a["cy"], grid_table(a["c"], a["d"]),
                                 main=main)
            elif kernel == "add_conv2d":
                yield add_conv(tag, a["n"], a["h"], a["w"], a["cx"],
                               a["cy"], a["hk"], main=main)
            else:
                yield pool(tag, a["n"], a["h"], a["w"], a["c"], main=main)
    yield conv("grouped g=2 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 2)
    yield conv("odd 2x15x13x3->8 hk3", 2, 15, 13, 3, 8, 3, 1)
    yield conv("even hk2 2x6x7x4->8", 2, 6, 7, 4, 8, 2, 1)
    # the tuner's Table-2 int8 conv jobs (timed, not summed) and the
    # implicit GEMM's edges: K chunks (K words > 32), HK 5 and 7, groups
    # of 3, Cy off a multiple of the thread's 4-16 channels, x at an odd
    # address (the bytewise window)
    for shape in T2_INT8_CONV:
        yield conv(f"table2 {shape}", *shape, main=0)
    yield conv("hk5 2x15x13x19->37", 2, 15, 13, 19, 37, 5, 1)
    yield conv("hk7 g=2 1x12x11x8->12", 1, 12, 11, 8, 12, 7, 2)
    yield conv("grouped g=3 2x9x9x6->9", 2, 9, 9, 6, 9, 3, 3)
    yield conv("Cy=20 3x5x40x8->20", 3, 5, 40, 8, 20, 3, 1)
    yield conv("x offset by 1 byte 2x16x16x16->32", 2, 16, 16, 16, 32, 3, 1,
               x_offset=1)
    yield dw("odd 2x15x13x8 hk3 (HK,HK,C)", 2, 15, 13, 8, 3, layout4=False)
    # the staged-row depthwise kernel's edges: C off a multiple of 4, even
    # HK, HK 5 and 7 (weights read from shared memory a tap), x at an odd
    # address (element loads), a row cut into runs of columns
    yield dw("C=19 hk5 2x15x13", 2, 15, 13, 19, 5, act="relu")
    yield dw("C=7 even hk2 2x5x13", 2, 5, 13, 7, 2, shift=1)
    yield dw("hk7 1x12x11x8", 1, 12, 11, 8, 7, act="relu", shift=9)
    yield dw("x offset by 1 byte 4x12x10x16", 4, 12, 10, 16, 3, x_offset=1)
    yield dw("wide row 1x3x300x8", 1, 3, 300, 8, 3)
    yield pool("odd 2x15x13x8 3/2", 2, 15, 13, 8, win=3, stride=2)
    # the vector path (C a multiple of 16, x aligned) and the scalar one
    # (C = 19, x at an odd address), windows 3/2 and 2/1
    for c in (16, 32, 64, 19):
        for win, st in ((3, 2), (2, 1)):
            yield pool(f"C={c} {win}/{st} 3x11x10", 3, 11, 10, c, win=win,
                       stride=st)
    yield pool("x offset by 1 byte 8x16x16x32 2/2", 8, 16, 16, 32,
               x_offset=1)
    for shift in (-2, 0, 1, 7):
        for act in (None, "relu"):
            for bias in (False, True):
                yield conv(f"shift={shift} act={act} bias={bias}", 8, 16,
                           16, 16, 32, 3, 1, bias=bias, act=act, shift=shift)
            yield dw(f"shift={shift} act={act}", 8, 16, 16, 16, 3, act=act,
                     shift=shift)
    yield shift_conv("odd 2x15x13x16->8 grid3", 2, 15, 13, 16, 8,
                     grid_table(16, 1))
    yield shift_conv("|shift|<=2 4x16x16x32->16 grid5", 4, 16, 16, 32, 16,
                     grid_table(32, 2))
    yield shift_conv("one shift (1,-1) 4x16x16x16->32", 4, 16, 16, 16, 32,
                     np.tile(np.array([[1, -1]], np.int32), (16, 1)))
    # the shift conv's implicit GEMM at its edges: d = 3 (a 7-wide window),
    # C off a multiple of 4 (the bytewise window), K chunks (C = 130: 33
    # words), Cy off a multiple of q, x at an odd address
    yield shift_conv("|shift|<=3 2x12x11x9->24 grid7", 2, 12, 11, 9, 24,
                     grid_table(9, 3))
    yield shift_conv("|shift|<=2 C=19 2x15x13->8 grid5", 2, 15, 13, 19, 8,
                     grid_table(19, 2), bias=False, act=None, rs=0)
    yield shift_conv("K chunks C=130 1x10x10->16 grid3", 1, 10, 10, 130, 16,
                     grid_table(130, 1))
    yield shift_conv("Cy=20 x offset by 1 byte 2x9x7x12", 2, 9, 7, 12, 20,
                     grid_table(12, 2), x_offset=1)
    # the tuner's Table-2 int8 shift jobs (timed, not summed)
    for n in (1, 8):
        yield shift_conv(f"table2 {n}x32x32x64->64", n, 32, 32, 64, 64,
                         grid_table(64, 1), main=0)
    yield add_conv("odd 2x15x13x3->8", 2, 15, 13, 3, 8, 3)
    for xp, wp in ((0, 0), (0, 3), (2, 0)):
        yield add_conv(f"preshift ({xp},{wp}) 4x16x16x16->32", 4, 16, 16,
                       16, 32, 3, xp=xp, wp=wp)
    # 127 << 28 leaves int32: the sum wraps, as JAX's int32 does
    yield add_conv("preshift (28,20) wraps 2x8x8x16->16", 2, 8, 8, 16, 16,
                   3, xp=28, wp=20, rs=24)
    # the integer add's implicit GEMM at its edges: differences that wrap
    # from either operand, HK 1, 2, 5 and 7, Cx off a multiple of 4, Cy off
    # q, x at an odd address; and the tuner's Table-2 int8 add job (timed,
    # not summed)
    yield add_conv("preshift (31,0) hk1 2x8x8x19->8", 2, 8, 8, 19, 8, 1,
                   xp=31, wp=0, rs=24)
    yield add_conv("preshift (0,31) even hk2 2x6x7x4->8", 2, 6, 7, 4, 8, 2,
                   xp=0, wp=31, rs=24, act="relu")
    yield add_conv("hk5 Cy=20 2x9x9x7->20", 2, 9, 9, 7, 20, 5, xp=0, wp=3)
    yield add_conv("hk7 1x12x11x5->12", 1, 12, 11, 5, 12, 7, bias=False)
    yield add_conv("Cy=24 x offset by 1 byte 4x12x10x16", 4, 12, 10, 16, 24,
                   3, x_offset=1)
    yield add_conv("table2 1x10x10x16->16", 1, 10, 10, 16, 16, 3, main=0)
    for rs in (-2, 0, 1, 7):
        for act in (None, "relu"):
            for bias in (False, True):
                tag = f"requant={rs} act={act} bias={bias}"
                yield shift_conv(tag, 8, 16, 16, 16, 32, grid_table(16, 1),
                                 bias=bias, act=act, rs=rs)
                yield add_conv(tag, 8, 16, 16, 16, 32, 3, bias=bias, act=act,
                               rs=rs)
    yield from w4_cases(conv, dw, shift_conv, add_conv)
    yield from matmul_cases(mm)


def w4_cases(conv, dw, shift_conv, add_conv):
    """The W4 mode of the four weight-carrying kernels: every W4 launch of
    the dws, shift and add plans' forwards at B=256 (timed), then odd
    shapes, a pad nibble, every group shift at 4 and depthwise HK 1 and 5
    (bitwise only)."""
    packed = dict(w4_mode=True)
    yield conv("W4 dws conv0 3->16 32^2", BATCH, 32, 32, 3, 16, 3, 1,
               main=True, **packed)
    yield dw("W4 dws dw1 16ch 16^2", BATCH, 16, 16, 16, 3, main=True, **packed)
    yield conv("W4 dws pw1 16->32 16^2", BATCH, 16, 16, 16, 32, 1, 1,
               main=True, **packed)
    yield dw("W4 dws dw2 32ch 8^2", BATCH, 8, 8, 32, 3, main=True, **packed)
    yield conv("W4 dws pw2 32->64 8^2", BATCH, 8, 8, 32, 64, 1, 1, main=True,
               **packed)
    yield shift_conv("W4 shift shift1 16->32 16^2", BATCH, 16, 16, 16, 32,
                     grid_table(16, 1), main=True, **packed)
    yield shift_conv("W4 shift shift2 32->64 8^2", BATCH, 8, 8, 32, 64,
                     grid_table(32, 1), main=True, **packed)
    hw, cin = 32, 3
    for i, cout in enumerate((16, 32, 64)):
        xp, wp, rs = W4_ADD_PRESHIFTS[i]
        yield add_conv(f"W4 add add{i} {cin}->{cout} {hw}^2 ({xp},{wp})",
                       BATCH, hw, hw, cin, cout, 3, xp=xp, wp=wp, rs=rs,
                       main=True, **packed)
        hw, cin = hw // 2, cout
    yield conv("W4 standard conv1 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 1,
               main=0, **packed)
    yield conv("W4 standard conv2 32->64 8^2", BATCH, 8, 8, 32, 64, 3, 1,
               main=0, **packed)
    for shape in T2_INT8_CONV:
        yield conv(f"W4 table2 {shape}", *shape, main=0, **packed)
    yield conv("W4 standard conv1 16->32 16^2 all shifts 4", BATCH, 16, 16,
               16, 32, 3, 1, all_max=True, **packed)
    yield conv("W4 odd Cx/g=5 g=2 2x9x9x10->8 hk5", 2, 9, 9, 10, 8, 5, 2,
               **packed)
    yield conv("W4 hk7 odd Cx/g=3 1x12x11x3->20", 1, 12, 11, 3, 20, 7, 1,
               **packed)
    yield conv("W4 grouped g=2 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 2,
               **packed)
    yield conv("W4 odd 2x15x13x5->8 hk3 g=1", 2, 15, 13, 5, 8, 3, 1,
               bias=False, act=None, shift=0, **packed)
    yield conv("W4 even hk2 2x6x7x12->8 g=2", 2, 6, 7, 12, 8, 2, 2,
               shift=-2, **packed)
    for hk in (1, 5):
        yield dw(f"W4 hk{hk} 4x16x16x16 (HK,HK,C)", 4, 16, 16, 16, hk,
                 act="relu", layout4=False, all_max=hk == 5, **packed)
    yield shift_conv("W4 odd 2x15x13x7->8 grid5 all shifts 4", 2, 15, 13, 7,
                     8, grid_table(7, 2), all_max=True, **packed)
    yield shift_conv("W4 |shift|<=3 odd C=9 1x12x11->24 all shifts 4", 1, 12,
                     11, 9, 24, grid_table(9, 3), all_max=True, **packed)
    yield shift_conv("W4 shift1 16->32 16^2 all shifts 4", BATCH, 16, 16, 16,
                     32, grid_table(16, 1), all_max=True, **packed)
    yield add_conv("W4 odd 2x15x13x3->8 all shifts 4", 2, 15, 13, 3, 8, 3,
                   xp=0, wp=3, all_max=True, **packed)
    yield add_conv("W4 preshift (28,20) 2x8x8x5->16 relu", 2, 8, 8, 5, 16, 3,
                   xp=28, wp=20, rs=24, act="relu", **packed)
    yield add_conv("W4 preshift (31,0) odd Cx=7 hk5 2x9x9->20 all shifts 4",
                   2, 9, 9, 7, 20, 5, xp=31, wp=0, rs=24, all_max=True,
                   **packed)
    yield add_conv("W4 preshift (0,31) hk1 x offset by 3 2x8x8x19->8", 2, 8,
                   8, 19, 8, 1, xp=0, wp=31, rs=24, x_offset=3, **packed)
    yield add_conv("W4 table2 1x10x10x16->16", 1, 10, 10, 16, 16, 3, main=0,
                   **packed)
    yield dw("W4 hk2 C=7 2x5x13 all shifts 4", 2, 5, 13, 7, 2, act="relu",
             layout4=False, all_max=True, **packed)
    yield dw("W4 hk7 x offset by 1 byte 1x12x11x8", 1, 12, 11, 8, 7,
             x_offset=1, **packed)


#: phase 10's granite-3-2b: its FFN's layers, d_model and d_ff; its decode
#: step's matmuls are summed apart from Qwen2-0.5B's into their own line
GRANITE_FFN = ("granite-3-2b", 40, 2048, 8192)


def matmul_cases(mm):
    """The LM FFN's matmuls at Qwen2-0.5B's widths: the decode shapes
    (timed and summed over one decode step's 72 launches), prefill shapes
    of 16, 32, 64 and 128 tokens (timed), and ragged, odd-K and shift
    cases (bitwise only), in both modes; then at granite-3-2b's widths the
    decode shapes (timed and summed over its step's 120 launches, on a
    line of their own) and the prefill shapes (timed)."""
    layers, d, ff = 24, 896, 4864
    g_name, g_layers, g_d, g_ff = GRANITE_FFN
    for w4_mode in (False, True):
        tag = "W4 " if w4_mode else ""
        yield mm(f"{tag}decode gate/up 8x{d}x{ff}", 8, d, ff, shift=14,
                 weight=2 * layers, w4_mode=w4_mode)
        yield mm(f"{tag}decode down 8x{ff}x{d}", 8, ff, d, shift=16,
                 weight=layers, w4_mode=w4_mode)
        for m in (16, 32, 64, 128):    # phase 6's prefill buckets
            yield mm(f"{tag}prefill gate/up {m}x{d}x{ff}", m, d, ff,
                     shift=14, act="relu", weight=0, w4_mode=w4_mode)
        yield mm(f"{tag}prefill down 64x{ff}x{d}", 64, ff, d, shift=16,
                 weight=0, w4_mode=w4_mode)
        yield mm(f"{tag}{g_name} decode gate/up 8x{g_d}x{g_ff}", 8, g_d,
                 g_ff, shift=14, weight=(g_name, 2 * g_layers),
                 w4_mode=w4_mode)
        yield mm(f"{tag}{g_name} decode down 8x{g_ff}x{g_d}", 8, g_ff, g_d,
                 shift=16, weight=(g_name, g_layers), w4_mode=w4_mode)
        for m in (16, 32, 64, 128):
            yield mm(f"{tag}{g_name} prefill gate/up {m}x{g_d}x{g_ff}", m,
                     g_d, g_ff, shift=14, act="relu", weight=0,
                     w4_mode=w4_mode)
            yield mm(f"{tag}{g_name} prefill down {m}x{g_ff}x{g_d}", m,
                     g_ff, g_d, shift=16, weight=0, w4_mode=w4_mode)
        yield mm(f"{tag}ragged 5x45x37 shift -2 relu", 5, 45, 37, shift=-2,
                 act="relu", w4_mode=w4_mode)
        yield mm(f"{tag}odd K 13x33x37 shift 0", 13, 33, 37, shift=0,
                 w4_mode=w4_mode)
        yield mm(f"{tag}ragged 70x{ff}x37 relu", 70, ff, 37, shift=16,
                 act="relu", w4_mode=w4_mode)
        yield mm(f"{tag}ragged 17x{d}x100", 17, d, 100, shift=13,
                 w4_mode=w4_mode)
        yield mm(f"{tag}M=1 1x{d}x{ff}", 1, d, ff, shift=12, act="relu",
                 w4_mode=w4_mode)
        yield mm(f"{tag}operands offset by 1 byte 8x{ff}x{d}", 8, ff, d,
                 shift=16, w4_mode=w4_mode, offset=1)
        yield mm(f"{tag}operands offset by 3 bytes 20x100x48", 20, 100, 48,
                 shift=10, act="relu", w4_mode=w4_mode, offset=3)
    yield mm(f"W4 all shifts 4 8x{d}x{ff}", 8, d, ff, shift=16,
             w4_mode=True, all_max=True)
    yield mm(f"W4 all shifts 4 odd K 16x45x{ff}", 16, 45, ff, shift=4,
             w4_mode=True, all_max=True)


#: the shift conv's launch arithmetic checked against its source: (n, h,
#: w, c, cy, d) of the shift plan's rows, Table-2's job at d = 1, 2 and 3,
#: an odd C and a C of K chunks
SHIFT_PLAN_SHAPES = ((BATCH, 16, 16, 16, 32, 1), (BATCH, 8, 8, 32, 64, 1),
                     (1, 32, 32, 64, 64, 1), (1, 32, 32, 64, 64, 2),
                     (1, 32, 32, 64, 64, 3), (2, 15, 13, 19, 8, 2),
                     (1, 10, 10, 130, 16, 1))
#: the float implicit GEMM's launch arithmetic checked against its
#: sources: (n, h, w, cx, cy, hk, groups) of Table-2's float convs, the
#: B=256 layers (the add plan's are the standard plan's shapes), a
#: pointwise layer, edges (odd sizes, ci = 130 with g = 2, HK = 7) and a
#: window too large for the larger tiles
F_PLAN_SHAPES = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
                 (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
                 (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1),
                 (1, 10, 10, 16, 16, 3, 1), (BATCH, 32, 32, 3, 16, 3, 1),
                 (BATCH, 16, 16, 16, 32, 3, 1), (BATCH, 8, 8, 32, 64, 3, 1),
                 (BATCH, 16, 16, 16, 32, 1, 1), (2, 15, 13, 19, 37, 5, 1),
                 (1, 10, 10, 130, 20, 3, 2), (1, 12, 11, 8, 12, 7, 2),
                 (1, 64, 64, 512, 64, 3, 1))
#: the depthwise conv's launch arithmetic checked against its source, at
#: every tile and element size: (n, h, w, c, hk) of the dws rows, Table-2's
#: job, C off 4, HK 1, 2, 5 and 7, a row cut into runs, a window too large
DW_PLAN_SHAPES = ((BATCH, 16, 16, 16, 3), (BATCH, 8, 8, 32, 3),
                  (1, 32, 32, 64, 3), (2, 15, 13, 19, 5), (2, 5, 13, 7, 2),
                  (2, 8, 8, 12, 1), (1, 12, 11, 8, 7), (1, 3, 300, 8, 3),
                  (1, 4, 4, 4, 181))
#: the integer matmul's launch arithmetic checked against its source at
#: every tile and cluster size: (m, k, n) of Qwen2-0.5B's decode and
#: prefill shapes and a ragged one
MM_PLAN_SHAPES = ((8, 896, 4864), (8, 4864, 896), (32, 896, 4864),
                  (128, 896, 4864), (64, 4864, 896), (5, 45, 37))
#: the int8 and float pools' vector or scalar launches checked against
#: their source: (n, hout, wout, c) of the dws plan's pools, the tuner's
#: float pool job, C = 4, 8 and 12 and C off 16
POOL_PLAN_SHAPES = ((BATCH, 16, 16, 16), (BATCH, 8, 8, 32), (BATCH, 4, 4, 64),
                    (2, 7, 6, 19), (3, 5, 4, 33), (8, 16, 16, 64),
                    (3, 5, 4, 4), (3, 5, 4, 8), (3, 5, 4, 12))
#: the causal conv1d's launch arithmetic checked at every run and block
#: size: Falcon-Mamba's prefill shapes, D = 100, 8196, 320 and L < K
C1D_PLAN_SHAPES = ((1, 16, 8192), (1, 33, 8192), (1, 96, 8192),
                   (1, 256, 8192), (8, 64, 8192), (3, 45, 100),
                   (1, 20, 8196), (2, 70, 320), (2, 2, 100))
#: the kernels whose shared-memory tiles this repository sizes itself, and
#: the int8 pool's vector kernel: each instantiation's ptxas report is
#: printed at a fresh build (igemm_kernel: the integer conv's and the
#: integer shift conv's implicit GEMM; fgemm_kernel: the float conv's and
#: every add conv mode's; depthwise2d_kernel: every depthwise mode's staged
#: rows; matmul_q_kernel: the integer matmul's tiles, int8 and W4; the
#: pools' vector kernels; the causal conv1d's vector kernel at bf16 K=4,
#: every run and block size), as regular expressions of the name
TILED_KERNELS = ("igemm_kernel", "fgemm_kernel", "matmul_f_kernel",
                 "shift_conv2d_f_kernel", "depthwise2d_kernel",
                 "matmul_q_kernel", "maxpool2d_s8_vec_kernel",
                 "maxpool2d_f_vec_kernel",
                 "causal_conv1d_vec_kernel(?=<__nv_bfloat16, 4,)")


def check_plans(K):
    """The Python launch arithmetic of the tiled kernels (the tuner's
    footprint check reads it) equal to their sources' own, at every tile
    of the dws plan's convs, the Table-2 int8 convs and Table-2 matmuls,
    of the shift conv's rows, Table-2 job and edges, of the float conv
    and the add conv (every mode) at F_PLAN_SHAPES, of the depthwise conv
    at DW_PLAN_SHAPES, and the pools' and the causal conv1d's vector or
    scalar launches."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    ci = importlib.import_module("repro_torch.kernels.conv_im2col")
    mq = importlib.import_module("repro_torch.kernels.matmul_q8")
    lib = _build.library()
    shapes = [(BATCH, 32, 32, 3, 16, 3, 1), (BATCH, 16, 16, 16, 32, 1, 1),
              (BATCH, 8, 8, 32, 64, 1, 1), (2, 15, 13, 19, 37, 5, 1),
              *T2_INT8_CONV]
    n = 0
    for s in shapes:
        for bp in ci.CONV_BP:
            for q in ci.CONV_Q:
                c = (ctypes.c_int * 6)()
                lib.repro_conv2d_i8_plan(c, *s, bp, q)
                p = ci.conv_plan(*s, bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                  p["k_words"], p["window"]],
                      f"conv2d plan {s} bp={bp} q={q}: source {list(c)} vs "
                      f"Python {p}")
                n += 1
    cs = importlib.import_module("repro_torch.kernels.conv_shift")
    for s in SHIFT_PLAN_SHAPES:
        for bp in ci.CONV_BP:
            for q in ci.CONV_Q:
                c = (ctypes.c_int * 6)()
                rc = lib.repro_shift_conv2d_i8_plan(c, *s, bp, q)
                p = cs.shift_plan(*s, bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                  p["k_words"], p["window"]]
                      and (rc == 0) == (not ci.tile_errors(p)),
                      f"shift_conv2d plan {s} bp={bp} q={q}: source "
                      f"{list(c)} (rc {rc}) vs Python {p}")
                c = (ctypes.c_int * 4)()
                rc = lib.repro_shift_conv2d_f_plan(c, *s[:5], bp, q)
                p = cs.shift_f_plan(*s[:5], bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"]]
                      and (rc == 0) == (not ci.tile_errors(p)),
                      f"shift_conv2d_f plan {s[:5]} bp={bp} q={q}: source "
                      f"{list(c)} (rc {rc}) vs Python {p}")
                n += 2
    ca = importlib.import_module("repro_torch.kernels.conv_add")
    tiles = [(bp, q) for bp in (*ci.CONV_BP, 96) for q in ci.CONV_Q]
    for s in F_PLAN_SHAPES:
        for bp, q in tiles:
            c = (ctypes.c_int * 5)()
            rc = lib.repro_conv2d_f_plan(c, *s, bp, q)
            p = ci.conv_f_plan(*s, bp, q)
            check(list(c) == [*p["grid"], p["threads"], p["smem"],
                              p["window"]]
                  and (rc == 0) == (not ci.tile_errors(p)),
                  f"conv2d_f plan {s} bp={bp} q={q}: source {list(c)} (rc "
                  f"{rc}) vs Python {p}")
            n += 1
            if s[6] != 1:
                continue
            c = (ctypes.c_int * 5)()
            rc = lib.repro_add_conv2d_f_plan(c, *s[:6], bp, q)
            p = ca.add_f_plan(*s[:6], bp, q)
            check(list(c) == [*p["grid"], p["threads"], p["smem"],
                              p["window"]]
                  and (rc == 0) == (not ci.tile_errors(p)),
                  f"add_conv2d_f plan {s[:6]} bp={bp} q={q}: source "
                  f"{list(c)} (rc {rc}) vs Python {p}")
            n += 1
    cd = importlib.import_module("repro_torch.kernels.conv_dw")
    for s in DW_PLAN_SHAPES:
        for es in (1, 2, 4):
            for pt in cd.DW_PT:
                for rows in cd.DW_ROWS:
                    c = (ctypes.c_int * 5)()
                    rc = lib.repro_depthwise2d_plan(c, *s, es, pt, rows)
                    p = cd.dw_plan(*s, es, pt, rows)
                    check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                      p["window"]]
                          and (rc == 0) == (not cd.dw_tile_errors(p)),
                          f"depthwise2d plan {s} esize {es} pt={pt} "
                          f"rows={rows}: source {list(c)} (rc {rc}) vs "
                          f"Python {p}")
                    n += 1
    for m, _, nn in T2_MATMUL:
        for tile in mq.MMF_TILES:
            for code, es in ((0, 4), (1, 2)):
                c = (ctypes.c_int * 4)()
                check(lib.repro_matmul_f_plan(c, m, nn, *tile, code) == 0,
                      f"matmul_f tile {tile} not instantiated")
                p = mq.mmf_plan(m, nn, tile, es)
                check(list(c) == [*p["grid"], p["threads"], p["smem"]],
                      f"matmul_f plan {tile}: source {list(c)} vs {p}")
                n += 1
    for shape in MM_PLAN_SHAPES:
        for bn, bm in mq.MMQ_TILES:
            for cs in mq.MMQ_CLUSTERS:
                for w4 in (0, 1):
                    c = (ctypes.c_int * 7)()
                    rc = lib.repro_matmul_q8_plan(c, *shape, bn, bm, cs, w4)
                    p = mq.mmq_plan(*shape, bn, bm, cs, bool(w4))
                    check(rc == 0 and list(c) == [
                        *p["grid"], p["cluster"], p["threads"], p["smem"],
                        p["stages"], p["ring"]],
                          f"matmul plan {shape} {(bn, bm, cs)} w4={w4}: "
                          f"source {list(c)} (rc {rc}) vs Python {p}")
                    n += 1
    pl = importlib.import_module("repro_torch.kernels.pool")
    for shape in POOL_PLAN_SHAPES:
        for aligned in (0, 1):
            for threads in (64, 256, 1024):
                c = (ctypes.c_int * 3)()
                rc = lib.repro_maxpool2d_s8_plan(c, *shape, aligned, threads)
                p = pl.pool_plan(*shape, aligned, threads)
                check(rc == 0 and list(c) == [p["blocks"], p["threads"],
                                              int(p["vector"])],
                      f"maxpool2d_s8 plan {shape} aligned={aligned} "
                      f"threads={threads}: source {list(c)} vs Python {p}")
                n += 1
                for es in (2, 4):
                    c = (ctypes.c_int * 3)()
                    rc = lib.repro_maxpool2d_f_plan(c, *shape, es, aligned,
                                                    threads)
                    p = pl.pool_f_plan(*shape, es, aligned, threads)
                    check(rc == 0 and list(c) == [p["blocks"], p["threads"],
                                                  int(p["vector"])],
                          f"maxpool2d_f plan {shape} esize {es} aligned="
                          f"{aligned} threads={threads}: source {list(c)} "
                          f"vs Python {p}")
                    n += 1
    c1 = importlib.import_module("repro_torch.kernels.conv1d_causal")
    for shape in C1D_PLAN_SHAPES:
        for es in (2, 4):
            for aligned in (0, 1):
                for run in c1.RUNS:
                    for threads in c1.THREADS:
                        c = (ctypes.c_int * 6)()
                        rc = lib.repro_causal_conv1d_plan(
                            c, *shape, es, aligned, run, threads)
                        p = c1.c1d_plan(*shape, es, aligned, run, threads)
                        check(rc == 0 and list(c) == [
                            *p["grid"], p["threads"], p["run"],
                            int(p["vector"])],
                              f"causal_conv1d plan {shape} esize {es} "
                              f"aligned={aligned} run={run} threads="
                              f"{threads}: source {list(c)} vs Python {p}")
                        n += 1
    print(f"[kernels] launch arithmetic: {n} plans of the integer conv, the "
          "float conv and the add conv, the shift conv (integer and "
          "float), the depthwise conv, the float matmul, the integer "
          "matmul, the int8 and float pools and the causal conv1d equal "
          "to their sources'")


#: the redesigned kernels' rows before their design (PERF.md §6: run 8 on
#: an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's: a
#: Qwen2-0.5B decode step's 72 launches (matmul, matmul_w4), the dws
#: plan's three pools (maxpool2d), a 96-token Falcon-Mamba-7B prefill's 64
#: launches (causal_conv1d), the tuner's float32 pool job (maxpool2d_f)
EARLIER_MS = {"matmul": 0.7678, "matmul_w4": 0.8064, "maxpool2d": 0.0178,
              "causal_conv1d": 0.2345, "maxpool2d_f": 0.0027}
#: causal_conv1d's launch before its vector design at each timed (B, L)
#: (PERF.md §6 row 7, run 8), printed beside each timed line
EARLIER_C1D_MS = {(1, 16): 0.0029, (1, 33): 0.0032, (1, 96): 0.0037,
                  (1, 256): 0.0053, (8, 64): 0.0093}


def phase_kernels(torch, K, dev, name, rng):
    from repro_torch.core.energy import h100_for
    from repro_torch.device import exact_float32
    card = h100_for(name)
    bw = card.hbm_bps
    i32_rate, i32_text = int32_rate(torch)
    print(f"[kernels] bounds: bytes / {bw / 1e12:.2f} TB/s; int8 ops / "
          f"{card.int8_tc_ops / 1e12:.0f} T ops/s (tensor cores); add-conv's "
          f"|x - w| accumulates and the pool's compares / {i32_text}")
    rates = {"int8": card.int8_tc_ops, "int32": i32_rate}
    f32_rate = card.f32_fma_flops
    check_plans(K)
    with exact_float32():      # the float32 yardsticks run without TF32
        per_kernel = _phase_kernels(torch, K, dev, rng, bw, rates)
        per_kernel["causal_conv1d"] = phase_conv1d(torch, K, dev, rng, bw,
                                                   f32_rate)
        per_kernel.update(phase_float(torch, K, dev, rng, bw))
    for kernel, before in EARLIER_MS.items():
        r = per_kernel[kernel]
        lib = r["library_ms"]
        print(f"[kernels] {kernel} row: {r['ms']:.4f} ms (before this "
              f"design {before:.4f} ms, {before / r['ms']:.2f}x); bound "
              f"{r['bound_ms']:.5f} ms; library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    phase_candidates(torch, K, dev, rng)
    return per_kernel


def _phase_kernels(torch, K, dev, rng, bw, rates):
    per_kernel = {}
    for (kernel, label, main, run_k, run_p, run_lib,
         work) in kernel_cases(torch, K, dev, rng):
        got = run_k()
        want = run_p()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == torch.int8
              and got.shape == want.shape,
              f"{kernel} {label}: kernel {got.dtype}{tuple(got.shape)} vs "
              f"plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        check(err == 0, f"{kernel} {label}: kernel differs from its plain "
                        f"version, max |diff| = {err}")
        row = per_kernel.setdefault(kernel, dict(
            max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            bytes_ms=0.0, ops_ms=0.0, shapes=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        if main is None or main is False:
            continue
        # launches per summed unit; a (model, n) pair sums into that
        # model's own line instead of the kernel's row
        step, weight = main if isinstance(main, tuple) else \
            (None, 1 if main is True else main)
        bytes_ms, ops_ms = work_ms(work, bw, rates)
        t_k = device_ms(torch, run_k)
        t_p = device_ms(torch, run_p, reps=5)
        t_l = device_ms(torch, run_lib) if run_lib is not None else None
        call = time_ms(torch, run_k)
        bound = max(bytes_ms, ops_ms)
        print(f"[kernels] {kernel:12s} {label:26s} bitwise ok  "
              f"kernel {t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  "
              f"plain {t_p:.4f} ms  library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}  "
              f"(device times; back-to-back wrapper calls {call:.4f} ms "
              f"each)")
        summed = row if step is None else row.setdefault(
            "steps", {}).setdefault(step, dict(
                ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0, launches=0))
        summed["ms"] += weight * t_k
        summed["plain_ms"] += weight * t_p
        summed["bound_ms"] += weight * bound
        summed["bytes_ms"] += weight * bytes_ms
        summed["ops_ms"] += weight * ops_ms
        if step is not None:
            summed["launches"] += weight
        if not weight:
            continue
        if t_l is None or summed["library_ms"] is None:
            summed["library_ms"] = None
        else:
            summed["library_ms"] += weight * t_l
    for kernel, row in per_kernel.items():
        print(f"[kernels] {kernel}: {row['shapes']} shapes bitwise equal to "
              f"the plain version")
        for step, r in row.pop("steps", {}).items():
            lib = r["library_ms"]
            by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            print(f"[kernels] {kernel} over one {step} decode step of 8 "
                  f"slots ({r['launches']} launches): kernel {r['ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.5f} ms ({by}), plain "
                  f"{r['plain_ms']:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    return per_kernel


def _bits(torch, t):
    """A float tensor's bit pattern, for bitwise comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


#: quiet NaNs of several bit patterns (+NaN, a payload, -NaN) as int16
#: (bfloat16) and int32 (float32) words
NAN_BITS = {2: (0x7FC0, 0x7FC5, 0xFFC0 - 0x10000),
            4: (0x7FC00000, 0x7FC00005, 0xFFC00000 - 2 ** 32)}


def plant_nans(torch, t, rng, share=0.15):
    """Set about ``share`` of float tensor ``t``'s elements, in place, to
    NaNs drawn from NAN_BITS: windows with several NaN taps of different
    bits, compared bit for bit."""
    flat = _bits(torch, t).view(-1)
    hit = torch.from_numpy(rng.random(t.numel()) < share).to(t.device)
    pick = torch.from_numpy(rng.integers(0, 3, t.numel())).to(t.device)
    bits = torch.tensor(NAN_BITS[t.element_size()], dtype=flat.dtype,
                        device=t.device)[pick]
    flat[hit] = bits[hit]


def conv1d_cases(torch, dev, rng):
    """(label, timed, x, w, act) of every causal_conv1d comparison: the
    model's prefill shapes in bfloat16, x the x half of a (B, L, 2D)
    in_proj product read in place as the model reads it (timed), then
    float32, D=100 with K in {1, 2, 4, 8} and relu on and off, the in_proj
    view, x at an odd address and bf16 D = 8196 (the scalar path), K = 8
    and L < K in both dtypes, (K,1,D) weights (bitwise only)."""
    def f(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def in_proj(b, l, d, dtype=torch.bfloat16):
        return f((b, l, 2 * d), dtype).chunk(2, dim=-1)[0]
    bf16, f32 = torch.bfloat16, torch.float32
    for b, l in C1D_SHAPES:
        yield (f"bf16 {b}x{l}x{C1D_WIDTH} K={C1D_TAPS} in_proj view",
               (b, l), in_proj(b, l, C1D_WIDTH),
               f((C1D_TAPS, C1D_WIDTH)), None)
    yield (f"f32 1x96x{C1D_WIDTH} K=4", False,
           f((1, 96, C1D_WIDTH), f32), f((4, C1D_WIDTH), f32), None)
    yield (f"f32 2x37x{C1D_WIDTH} K=4 in_proj view relu", False,
           in_proj(2, 37, C1D_WIDTH, f32), f((4, C1D_WIDTH), f32), "relu")
    for dtype in (f32, bf16):
        tag = str(dtype)[6:]
        yield (f"{tag} 1x96x{C1D_WIDTH} K=4 offset by 1 (scalar path)",
               False, offset_view(torch, f((1, 96, C1D_WIDTH), dtype), 1),
               f((4, C1D_WIDTH), dtype), "relu")
        for k in (1, 2, 4, 8):
            for act in (None, "relu"):
                yield (f"{tag} 3x45x100 K={k} act={act}", False,
                       f((3, 45, 100), dtype), f((k, 100), dtype), act)
            yield (f"{tag} 2x37x256 K={k} in_proj view", False,
                   in_proj(2, 37, 256, dtype), f((k, 256), dtype), None)
            yield (f"{tag} 2x3x64 K={k} (L < K for K = 4, 8)", False,
                   f((2, 3, 64), dtype), f((k, 64), dtype), "relu")
    yield ("bf16 1x20x8196 K=4 (D * 2 off 16 bytes: scalar path)", False,
           f((1, 20, 8196)), f((4, 8196)), None)
    yield ("bf16 2x2x100 K=4 (L < K)", False, f((2, 2, 100)), f((4, 100)),
           None)
    yield ("bf16 2x70x96 (K,1,D) weights relu", False, f((2, 70, 96)),
           f((4, 1, 96)), "relu")


def phase_conv1d(torch, K, dev, rng, bw, f32_rate):
    """Phase 3 for causal_conv1d: bitwise against its plain version at
    every case, times at the model's shapes (each beside the first design's
    launch in PERF.md and the same values through this run's scalar path,
    the first design's kernel, at an odd address), then the backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d_causal import c1d_plan, row_stride
    from repro_torch.roofline.count import kernel_work
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, shapes=0)
    paths = {True: 0, False: 0}
    for label, timed, x, w, act in conv1d_cases(torch, dev, rng):
        got = K.causal_conv1d(x, w, act=act)
        want = K.causal_conv1d_plain(x, w, act=act)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == x.dtype and got.shape == x.shape
              and got.is_contiguous(),
              f"causal_conv1d {label}: kernel {got.dtype}{tuple(got.shape)} "
              f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(_bits(torch, got), _bits(torch, want)),
              f"causal_conv1d {label}: kernel differs from its plain "
              f"version, max |diff| = {err}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        es = x.element_size()
        paths[c1d_plan(*x.shape, es, x.data_ptr() % 16 == 0
                       and w.data_ptr() % 16 == 0
                       and row_stride("c1d", x) * es % 16 == 0, 1,
                       64)["vector"]] += 1
        if not timed:
            continue
        b, l, d = x.shape
        k = w.shape[0]
        bytes_ms, ops_ms = work_ms(kernel_work("causal_conv1d", x, w), bw,
                                   {"f32": f32_rate})
        # yardstick: cuDNN's depthwise conv1d (groups=D) on channel-major
        # copies left-padded by K-1, made before timing
        xt = F.pad(x.transpose(1, 2).contiguous(), (k - 1, 0))
        wt = w.t().contiguous()[:, None, :]
        lib = lambda: F.conv1d(xt, wt, groups=d)      # noqa: E731
        lib_err = float((lib().transpose(1, 2).float() - want.float())
                        .abs().max())
        check(lib_err <= 0.05, f"causal_conv1d {label}: the library call "
                               f"computes another function ({lib_err})")
        xo = offset_view(torch, x.contiguous(), 1)    # the scalar path
        check(torch.equal(_bits(torch, K.causal_conv1d(xo, w, act=act)),
                          _bits(torch, want)),
              f"causal_conv1d {label}: the scalar path differs")
        t_k = device_ms(torch, lambda: K.causal_conv1d(x, w, act=act))
        t_s = device_ms(torch, lambda: K.causal_conv1d(xo, w, act=act))
        t_p = device_ms(torch, lambda: K.causal_conv1d_plain(x, w, act=act),
                        reps=5)
        t_l = device_ms(torch, lib)
        call = time_ms(torch, lambda: K.causal_conv1d(x, w, act=act))
        bound = max(bytes_ms, ops_ms)
        before = EARLIER_C1D_MS[timed]
        print(f"[kernels] causal_conv1d {label:34s} bitwise ok  kernel "
              f"{t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  plain "
              f"{t_p:.4f} ms  library {t_l:.4f} ms  before this design "
              f"{before:.4f} ms ({before / t_k:.2f}x; the scalar path, its "
              f"kernel, on these values {t_s:.4f} ms) (device times; "
              f"back-to-back wrapper calls {call:.4f} ms each)")
        if timed == C1D_SUMMED:        # one prefill: a launch per layer
            n = C1D_PER_PREFILL
            row["ms"], row["plain_ms"] = n * t_k, n * t_p
            row["bound_ms"], row["library_ms"] = n * bound, n * t_l
            row["bytes_ms"], row["ops_ms"] = n * bytes_ms, n * ops_ms
    check(paths[True] and paths[False],
          f"causal_conv1d: the cases took the vector path {paths[True]} and "
          f"the scalar path {paths[False]} times; both must run")
    conv1d_backward(torch, K, dev, rng)
    print(f"[kernels] causal_conv1d: {row['shapes']} shapes bitwise equal to "
          f"the plain version ({paths[True]} on the vector path, "
          f"{paths[False]} on the scalar path)")
    return row


def conv1d_backward(torch, K, dev, rng, shape=(2, 96, C1D_WIDTH)):
    """The differentiable entry point's backward on the card: dx bitwise
    equal to flip-plain-flip, dw to the plain reduction (the ``"torch"``
    method's), and in float32 both within 1e-5 (relative to the largest
    magnitude) of autograd through the plain version."""
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        def f(s):
            return torch.from_numpy(rng.standard_normal(s).astype("float32")
                                    ).to(dev).to(dtype)
        x = f(shape).requires_grad_()
        w = f((C1D_TAPS, shape[2])).requires_grad_()
        g = f(shape)
        gx, gw = torch.autograd.grad(ops.causal_conv1d(x, w), (x, w), g)
        flip = torch.flip(K.causal_conv1d_plain(torch.flip(g, [1]),
                                                w.detach()), [1])
        _, pw = torch.autograd.grad(ops.causal_conv1d(x, w, method="torch"),
                                    (x, w), g)
        torch.cuda.synchronize()
        name = str(dtype)[6:]
        check(torch.equal(_bits(torch, gx), _bits(torch, flip)),
              f"causal_conv1d backward {name}: dx differs from "
              "flip-plain-flip")
        check(torch.equal(_bits(torch, gw), _bits(torch, pw)),
              f"causal_conv1d backward {name}: dw differs from the plain "
              "reduction")
        worst = 0.0
        if dtype == torch.float32:
            ax, aw = torch.autograd.grad(K.causal_conv1d_plain(x, w), (x, w),
                                         g)
            for got, want in ((gx, ax), (gw, aw)):
                scale = max(1.0, float(want.abs().max()))
                worst = max(worst, float((got - want).abs().max()) / scale)
            check(worst <= 1e-5, f"causal_conv1d backward: {worst:.2e} from "
                                 "autograd through the plain version")
        print(f"[kernels] causal_conv1d backward {name} {tuple(shape)}: dx "
              "bitwise == flip-plain-flip, dw == plain reduction"
              + (f", within {worst:.1e} of autograd through the plain "
                 "version" if dtype == torch.float32 else ""))


# ------------------------------------------------- phase 3: float modes --

#: the float jobs of the tuner's Table-2 plan (repro_torch.tune.__main__
#: shapes_table2), plus the tuner's float pool job: each float kernel's
#: JSON row sums its times over these
T2_CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
           (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
           (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1))
T2_DW, T2_SHIFT, T2_ADD = (1, 32, 32, 64, 3), (1, 32, 32, 64, 64), \
    (1, 10, 10, 16, 16, 3)
T2_MATMUL = ((256, 512, 256), (512, 512, 512))
T2_POOL = (8, 32, 32, 64, 2, 2)


def f32_rates(torch) -> tuple:
    """(FMA flop/s, non-FMA op/s, text): float32 on the CUDA cores, SMs x
    128 lanes (the card model's) x the maximum SM clock (nvidia-smi), x 2
    for an FMA."""
    sms, mhz = sms_and_clock(torch)
    lanes = card_model().f32_lanes_per_sm
    ops = sms * lanes * mhz * 1e6
    return 2 * ops, ops, (f"{sms} SMs x {lanes} float32 lanes x {mhz:.0f} MHz "
                          f"= {ops / 1e12:.2f} T ops/s, {2 * ops / 1e12:.2f} "
                          "TFLOP/s as FMAs")


def float_cases(torch, K, dev, rng, earlier):
    """Yield (kernel, label, timed, run_kernel, run_plain, run_lib, work)
    for every float-mode comparison of phase 3: the tuner's
    Table-2 float jobs and the CNN plans' layer shapes at B=256 (float32,
    timed; the Table-2 ones summed into the JSON row, ``timed == "t2"``),
    the same in bfloat16, then HK=1, even HK, grouped, C off a multiple of
    32, M=1, K off a multiple of 32, relu and bias on and off (bitwise
    only). ``work`` is the call's ``roofline.count.kernel_work``: its
    operations "f32" (float32 FLOPs, 2 a multiply-add) or "f32_op"
    (float32 operations with no FMA form). Each timed pool case puts
    into ``earlier``, under its label, a call of the first design's kernel
    (the scalar path) on the same values at an odd address."""
    import torch.nn.functional as F
    from repro_torch.core.primitives import shift_channels
    from repro_torch.roofline.count import kernel_work

    def f(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def pads(hk):
        return (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)

    def conv(label, shape, dtype, timed=False, bias=True, act="relu",
             off=0):
        n, h, w, cx, cy, hk, g = shape
        x, wt = f((n, h, w, cx), dtype), f((hk, hk, cx // g, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        b = f((cy,), dtype) if bias else None
        kw = dict(groups=g, act=act)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk)).contiguous()
        wf = wt.permute(3, 2, 0, 1).float().contiguous()
        return ("conv2d_f", label, timed,
                lambda: K.conv2d_f(x, wt, b, **kw),
                lambda: K.conv2d_f_plain(x, wt, b, **kw),
                lambda: F.conv2d(xf, wf, groups=g),
                kernel_work("conv2d_f", x, wt, b, groups=g))

    def dw(label, shape, dtype, timed=False, act="relu", off=0):
        n, h, w, c, hk = shape
        x, wt = f((n, h, w, c), dtype), f((hk, hk, c), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk)).contiguous()
        wf = wt.permute(2, 0, 1)[:, None].float().contiguous()
        return ("depthwise2d_f", label, timed,
                lambda: K.depthwise2d_f(x, wt, act=act),
                lambda: K.depthwise2d_f_plain(x, wt, act=act),
                lambda: F.conv2d(xf, wf, groups=c),
                kernel_work("depthwise2d_f", x, wt))

    def pool(label, shape, dtype, timed=False, off=0, nans=False):
        n, h, w, c, win, st = shape
        x = f((n, h, w, c), dtype)
        if nans:                     # NaN taps of several bit patterns
            plant_nans(torch, x, rng)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        if timed:
            xo = offset_view(torch, x, 1)
            earlier[label] = lambda: K.maxpool2d_f(xo, window=win,
                                                   stride=st)
        lib = None
        if win == st and h % win == 0 and w % win == 0 and not off:
            v = x.view(n, h // win, win, w // win, win, c)
            lib = lambda: v.amax(dim=(2, 4))          # noqa: E731
        return ("maxpool2d_f", label, timed,
                lambda: K.maxpool2d_f(x, window=win, stride=st),
                lambda: K.maxpool2d_plain(x, window=win, stride=st), lib,
                kernel_work("maxpool2d_f", x, window=win, stride=st))

    def shift(label, shape, dtype, d=1, timed=False, act="relu", off=0):
        n, h, w, c, cy = shape
        x, wt = f((n, h, w, c), dtype), f((c, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        table = torch.from_numpy(grid_table(c, d)).to(dev)
        xs = shift_channels(x.float(), table).permute(0, 3, 1, 2) \
            .contiguous()
        wf = wt.t().float()[:, :, None, None].contiguous()
        return ("shift_conv2d_f", label, timed,
                lambda: K.shift_conv2d_f(x, table, wt, max_shift=d, act=act),
                lambda: K.shift_conv2d_f_plain(x, table, wt, max_shift=d,
                                               act=act),
                lambda: F.conv2d(xs, wf),
                kernel_work("shift_conv2d_f", x, table, wt))

    def add(label, shape, dtype, timed=False, act=None, off=0):
        n, h, w, cx, cy, hk = shape
        x, wt = f((n, h, w, cx), dtype), f((hk, hk, cx, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk))
        patches = F.unfold(xf, hk).transpose(1, 2) \
            .reshape(n * h * w, cx * hk * hk).contiguous()
        wf = wt.permute(3, 2, 0, 1).reshape(cy, cx * hk * hk).float() \
            .contiguous()
        return ("add_conv2d_f", label, timed,
                lambda: K.add_conv2d_f(x, wt, act=act),
                lambda: K.add_conv2d_f_plain(x, wt, act=act),
                lambda: torch.cdist(patches, wf, p=1),
                kernel_work("add_conv2d_f", x, wt))

    def mm(label, shape, dtype, timed=False, act=None, off=0):
        m, k, n = shape
        a, b = f((m, k), dtype), f((k, n), dtype)
        if off:                      # operands at unaligned addresses
            a, b = offset_view(torch, a, off), offset_view(torch, b, off)
        af, bf = a.float(), b.float()
        return ("matmul_f", label, timed,
                lambda: K.matmul_f(a, b, act=act),
                lambda: K.matmul_f_plain(a, b, act=act),
                lambda: torch.matmul(af, bf),
                kernel_work("matmul_f", a, b))

    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        tag = "f32" if dtype == f32 else "bf16"
        t2 = "t2" if dtype == f32 else True       # bf16: timed, not summed
        timed = dtype == f32
        for shape in T2_CONV:
            yield conv(f"{tag} table2 {shape}", shape, dtype, t2)
        yield dw(f"{tag} table2 {T2_DW}", T2_DW, dtype, t2)
        yield shift(f"{tag} table2 {T2_SHIFT}", T2_SHIFT, dtype, timed=t2)
        yield add(f"{tag} table2 {T2_ADD}", T2_ADD, dtype, t2)
        for shape in T2_MATMUL:
            yield mm(f"{tag} table2 {shape}", shape, dtype, t2)
        yield pool(f"{tag} tuner pool {T2_POOL}", T2_POOL, dtype, t2)
        seen = set()
        for prim in ("dws", "standard", "shift", "add"):
            for kernel, label, a in main_path_shapes(prim):
                key = (kernel, tuple(sorted(a.items())))
                if key in seen:
                    continue
                seen.add(key)
                lab = f"{tag} {prim} {label} B={BATCH}"
                if kernel == "conv2d":
                    yield conv(lab, (a["n"], a["h"], a["w"], a["cx"],
                                     a["cy"], a["hk"], a["g"]), dtype, timed)
                elif kernel == "depthwise2d":
                    yield dw(lab, (a["n"], a["h"], a["w"], a["c"], a["hk"]),
                             dtype, timed)
                elif kernel == "shift_conv2d":
                    yield shift(lab, (a["n"], a["h"], a["w"], a["c"],
                                      a["cy"]), dtype, a["d"], timed)
                elif kernel == "add_conv2d":
                    yield add(lab, (a["n"], a["h"], a["w"], a["cx"], a["cy"],
                                    a["hk"]), dtype, timed)
                else:
                    yield pool(lab, (a["n"], a["h"], a["w"], a["c"], 2, 2),
                               dtype, timed)
        # edges: bitwise only
        yield conv(f"{tag} HK=1 2x8x8x5->7", (2, 8, 8, 5, 7, 1, 1), dtype)
        yield conv(f"{tag} even HK=2 2x6x7x4->8 no bias", (2, 6, 7, 4, 8, 2,
                                                           1), dtype,
                   bias=False, act=None)
        yield conv(f"{tag} grouped g=3 2x9x9x6->9", (2, 9, 9, 6, 9, 3, 3),
                   dtype)
        yield conv(f"{tag} C=19 2x15x13x19->37 HK=5", (2, 15, 13, 19, 37, 5,
                                                       1), dtype, act=None)
        yield dw(f"{tag} C=19 HK=5 2x15x13", (2, 15, 13, 19, 5), dtype)
        yield dw(f"{tag} HK=1 2x8x8x7", (2, 8, 8, 7, 1), dtype, act=None)
        yield dw(f"{tag} even HK=2 C=7 2x5x13", (2, 5, 13, 7, 2), dtype)
        yield dw(f"{tag} HK=7 offset by 1 1x12x11x8", (1, 12, 11, 8, 7),
                 dtype, off=1)
        yield dw(f"{tag} wide row 1x3x300x8", (1, 3, 300, 8, 3), dtype,
                 act=None)
        yield pool(f"{tag} 3/2 2x15x13x19", (2, 15, 13, 19, 3, 2), dtype)
        yield pool(f"{tag} 3/1 2x9x8x33", (2, 9, 8, 33, 3, 1), dtype)
        for c in (4, 8, 12, 64):
            for win, st in ((2, 2), (3, 2), (4, 3)):
                yield pool(f"{tag} C={c} {win}/{st} NaN taps 3x11x10",
                           (3, 11, 10, c, win, st), dtype, nans=True)
            yield pool(f"{tag} C={c} offset by 1 NaN taps 3x11x10",
                       (3, 11, 10, c, 2, 2), dtype, off=1, nans=True)
        yield shift(f"{tag} |shift|<=2 C=19 2x15x13->8", (2, 15, 13, 19, 8),
                    dtype, d=2)
        yield shift(f"{tag} no relu 4x16x16x16->32", (4, 16, 16, 16, 32),
                    dtype, act=None)
        yield shift(f"{tag} |shift|<=3 C=5 2x9x7->37", (2, 9, 7, 5, 37), dtype,
                    d=3, act=None)
        yield shift(f"{tag} C=130 (chunks) offset by 1 2x8x8->12",
                    (2, 8, 8, 130, 12), dtype, off=1)
        yield add(f"{tag} 2x15x13x3->8 relu", (2, 15, 13, 3, 8, 3), dtype,
                  act="relu")
        yield add(f"{tag} HK=1 C=19 2x8x8->8", (2, 8, 8, 19, 8, 1), dtype)
        yield add(f"{tag} HK=5 C=19->20 offset by 3 2x9x11", (2, 9, 11, 19,
                                                             20, 5), dtype,
                  act="relu", off=3)
        yield conv(f"{tag} ci=130 g=2 (K chunks) offset by 1 2x10x10->20",
                   (2, 10, 10, 130, 20, 3, 2), dtype, off=1)
        for shape in ((1, 896, 37), (1, 45, 37), (13, 33, 300),
                      (70, 4864, 37), (17, 64, 100), (37, 45, 33),
                      (257, 513, 255)):
            yield mm(f"{tag} {shape}", shape, dtype, act="relu" if
                     shape[0] % 2 else None)
        # M, N, K off every tile; the bytewise staging of misaligned rows
        for off in (1, 3):
            yield mm(f"{tag} (70, 33, 100) offset by {off}", (70, 33, 100),
                     dtype, act="relu", off=off)


def phase_float(torch, K, dev, rng, bw):
    """Phase 3 for the six float modes: bitwise against the plain versions
    at every case, device times at the timed ones."""
    fma_rate, op_rate, text = f32_rates(torch)
    print(f"[kernels] float bounds: bytes / {bw / 1e12:.2f} TB/s; float32 "
          f"multiply-adds and |x - w| / max operations against {text}")
    rates = {"f32": fma_rate, "f32_op": op_rate}
    rows, earlier = {}, {}
    for (kernel, label, timed, run_k, run_p, run_lib,
         work) in float_cases(torch, K, dev, rng, earlier):
        got = run_k()
        want = run_p()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{kernel} {label}: kernel {got.dtype}{tuple(got.shape)} vs "
              f"plain {want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(_bits(torch, got), _bits(torch, want)),
              f"{kernel} {label}: kernel differs from its plain version, "
              f"max |diff| = {err}")
        row = rows.setdefault(kernel, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, shapes=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        if not timed:
            continue
        bytes_ms, ops_ms = work_ms(work, bw, rates)
        t_k = device_ms(torch, run_k)
        t_p = device_ms(torch, run_p, reps=3)
        t_l = device_ms(torch, run_lib) if run_lib is not None else None
        bound = max(bytes_ms, ops_ms)
        before = ""
        if label in earlier:         # the pool's first design, this run
            t_e = device_ms(torch, earlier[label])
            was = (f"{EARLIER_MS[kernel]:.4f} ms, " if timed == "t2"
                   else "")
            before = (f"  before this design {was}the scalar path, its "
                      f"kernel, on these values {t_e:.4f} ms "
                      f"({t_e / t_k:.2f}x)")
        print(f"[kernels] {kernel:14s} {label:44s} bitwise ok  kernel "
              f"{t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  plain "
              f"{t_p:.4f} ms  library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}{before}")
        if timed != "t2":
            continue
        row["ms"] += t_k
        row["plain_ms"] += t_p
        row["bound_ms"] += bound
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
        if t_l is None or row["library_ms"] is None:
            row["library_ms"] = None
        else:
            row["library_ms"] += t_l
    for kernel, row in rows.items():
        print(f"[kernels] {kernel}: {row['shapes']} cases (float32 and "
              "bfloat16) bitwise equal to the plain version")
    return rows


def entry_points(torch, K, dev, rng):
    """(name, sig, dtype, call(**config)) of every kernel entry point at
    one shape, for the candidate-invariance check."""
    from repro_torch import tune
    from repro_torch.core.quantize import pack_w4

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype("int8")).to(dev)

    def f(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def w4(shape, axis):
        q = torch.from_numpy(rng.integers(-8, 8, shape).astype("int8"))
        ws = torch.from_numpy(rng.integers(0, 5, shape[axis])
                              .astype("int8")).to(dev)
        return pack_w4(q, axis).contiguous().to(dev), ws

    n, h, w, c, cy = 8, 16, 16, 16, 32
    x8, xf = i8((n, h, w, c)), f((n, h, w, c))
    b = torch.from_numpy(rng.integers(-4000, 4000, cy).astype("int32")) \
        .to(dev)
    table = torch.from_numpy(grid_table(c, 1)).to(dev)
    q = dict(requant_shift=7, act="relu")
    conv_sig = tune.sig_conv2d(n, h, w, c, cy, 3, 1)
    dw_sig = tune.sig_depthwise2d(n, h, w, c, 3)
    pool_sig = tune.sig_maxpool2d(n, h, w, c, 2, 2)
    shift_sig = tune.sig_shift_conv2d(n, h, w, c, cy)
    add_sig = tune.sig_add_conv2d(n, h, w, c, cy, 3)
    mm_sig = tune.sig_matmul(8, 896, 4864)
    wc, wd, ws_, wa = (i8((3, 3, c, cy)), i8((3, 3, c)), i8((c, cy)),
                       i8((3, 3, c, cy)))
    pc, pd, pshift, pa = (w4((3, 3, c, cy), 2), w4((3, 3, c), 0),
                          w4((c, cy), 0), w4((3, 3, c, cy), 2))
    a8, bm8 = i8((8, 896)), i8((896, 4864))
    pm = w4((896, 4864), 0)
    fc, fd, fs, fa = (f((3, 3, c, cy)), f((3, 3, c)), f((c, cy)),
                      f((3, 3, c, cy)))
    fa_, fb_ = f((40, 300)), f((300, 520))
    xc, wcv = f((2, 70, 320), torch.bfloat16), f((4, 320), torch.bfloat16)
    akw = dict(requant_shift=9, x_preshift=2, w_preshift=0)
    return [
        ("conv2d_q8", conv_sig, "int8",
         lambda **k: K.conv2d_q8(x8, wc, b, **q, **k)),
        ("depthwise2d_q8", dw_sig, "int8",
         lambda **k: K.depthwise2d_q8(x8, wd, **q, **k)),
        ("maxpool2d_s8", pool_sig, "int8",
         lambda **k: K.maxpool2d_s8(x8, **k)),
        ("shift_conv2d_q8", shift_sig, "int8",
         lambda **k: K.shift_conv2d_q8(x8, table, ws_, b, max_shift=1, **q,
                                       **k)),
        ("add_conv2d_q8", add_sig, "int8",
         lambda **k: K.add_conv2d_q8(x8, wa, b, **akw, **k)),
        ("conv2d_w4", conv_sig, "w4a8",
         lambda **k: K.conv2d_w4(x8, *pc, b, **q, **k)),
        ("depthwise2d_w4", dw_sig, "w4a8",
         lambda **k: K.depthwise2d_w4(x8, *pd, **q, **k)),
        ("shift_conv2d_w4", shift_sig, "w4a8",
         lambda **k: K.shift_conv2d_w4(x8, table, *pshift, b, max_shift=1,
                                       **q, **k)),
        ("add_conv2d_w4", add_sig, "w4a8",
         lambda **k: K.add_conv2d_w4(x8, *pa, b, **akw, **k)),
        ("matmul_q8", mm_sig, "int8",
         lambda **k: K.matmul_q8(a8, bm8, requant_shift=14, **k)),
        ("matmul_w4", mm_sig, "w4a8",
         lambda **k: K.matmul_w4(a8, *pm, requant_shift=14, **k)),
        ("causal_conv1d", tune.sig_causal_conv1d(2, 70, 320, 4), "bfloat16",
         lambda **k: K.causal_conv1d(xc, wcv, **k)),
        ("conv2d_f", conv_sig, "float32",
         lambda **k: K.conv2d_f(xf, fc, act="relu", **k)),
        ("depthwise2d_f", dw_sig, "float32",
         lambda **k: K.depthwise2d_f(xf, fd, **k)),
        ("maxpool2d_f", pool_sig, "float32",
         lambda **k: K.maxpool2d_f(xf, **k)),
        ("shift_conv2d_f", shift_sig, "float32",
         lambda **k: K.shift_conv2d_f(xf, table, fs, max_shift=1, **k)),
        ("add_conv2d_f", add_sig, "float32",
         lambda **k: K.add_conv2d_f(xf, fa, **k)),
        ("matmul_f", tune.sig_matmul(40, 300, 520), "float32",
         lambda **k: K.matmul_f(fa_, fb_, **k)),
    ]


def phase_candidates(torch, K, dev, rng):
    """Every config in the tuner's space of every entry point, at one shape
    each, bitwise equal to the default config's output."""
    from repro_torch import tune
    total = 0
    for name, sig, dtype, call in entry_points(torch, K, dev, rng):
        cands = list(tune.candidates(sig, dtype))
        check(len(cands) >= 2, f"{name}: a space of {len(cands)}")
        want = call(**tune.default_config(sig.kernel, sig, dtype))
        for cfg in cands:
            got = call(**cfg)
            torch.cuda.synchronize()
            check(torch.equal(_bits(torch, got) if got.is_floating_point()
                              else got,
                              _bits(torch, want) if want.is_floating_point()
                              else want),
                  f"{name} {sig.key()} {cfg}: output differs from the "
                  "default config's")
        total += len(cands)
        print(f"[kernels] {name} {sig.key()} [{dtype}]: all "
              f"{len(cands)} candidates {cands} bitwise equal to the "
              "default")
    print(f"[kernels] tuner candidates: {total} configs of 18 entry points "
          "bitwise equal to their defaults")


# ---------------------------------------------------------------- phase 4 --

def numpy_params(cfg, rng, group_spread=None):
    """CNN parameters in the JAX package's layout, He-normal from ``rng``.
    With ``group_spread=g``, each conv weight's input channels are scaled
    by 2^-((c // g) % 4): one octave down per group of ``g``."""
    from repro_torch.models.convnet import _specs
    blocks = []
    for s in _specs(cfg):
        hk, cx, cy = s.kernel_size, s.in_channels, s.out_channels

        def he(shape, fan_in):
            return (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5) \
                .astype("float32")
        if s.primitive == "dws":
            conv = {"w_dw": he((hk, hk, cx, 1), hk * hk),
                    "w_pw": he((1, 1, cx, cy), cx)}
        elif s.primitive == "shift":
            conv = {"shifts": grid_table(cx, hk // 2),
                    "w_pw": he((1, 1, cx, cy), cx)}
        else:
            conv = {"w": he((hk, hk, cx // s.groups, cy),
                            hk * hk * cx // s.groups)}
        if group_spread:
            for k in ("w", "w_pw"):
                if k in conv:
                    c = conv[k].shape[2]
                    octave = (np.arange(c) // group_spread) % 4
                    conv[k] *= (2.0 ** -octave)[:, None].astype("float32")
        conv["b"] = (rng.standard_normal(cy) * 0.1).astype("float32")
        # mean/var are re-estimated by the calibration sweep
        bn = {"gamma": (1.0 + 0.1 * rng.standard_normal(cy)).astype("float32"),
              "beta": (0.1 * rng.standard_normal(cy)).astype("float32"),
              "mean": np.zeros(cy, "float32"), "var": np.ones(cy, "float32")}
        blocks.append({"conv": conv, "bn": bn})
    head = (rng.standard_normal((cfg.widths[-1], cfg.num_classes))
            * cfg.widths[-1] ** -0.5).astype("float32")
    return {"blocks": blocks, "head": head}


def plan_to_host(plan):
    """A copy of ``plan`` with every tensor on the host."""
    from repro_torch.core.quantize import QTensor, QTensorW4

    def host(v):
        if isinstance(v, QTensor):
            return QTensor(v.q.cpu(), v.frac_bits)
        if isinstance(v, QTensorW4):
            return dataclasses.replace(v, q=v.q.cpu(), shifts=v.shifts.cpu())
        return v.cpu() if hasattr(v, "cpu") else v
    nodes = tuple(dataclasses.replace(
        n, qparams=None if n.qparams is None
        else {k: host(v) for k, v in n.qparams.items()}) for n in plan.nodes)
    return dataclasses.replace(plan, nodes=nodes)


def build_plan(torch, name, rng, dev="cuda") -> dict:
    """Lower one plan of ``PLANS`` on ``dev`` from seeded weights and build
    its CompiledPlan, which verifies it at build
    (``repro_torch.check.validate_plan``; a plan that fails raises). Returns
    ``{"plan", "x", "cfg", "t_lower"}``: the CompiledPlan, its 256 input
    images, its CNNConfig and the seconds lowering and build took."""
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    from repro_torch.models import CNNConfig, quantize_cnn
    from repro_torch.weights import params_from_numpy
    primitive, bits, group = PLANS[name]
    cfg = CNNConfig(primitive=primitive)
    spread = group if bits == 4 and group < 32 else None
    params = params_from_numpy(numpy_params(cfg, rng, spread), device=dev)
    calib = (rng.standard_normal((BATCH, 32, 32, 3)) * 0.5).astype("float32")
    x = (rng.standard_normal((BATCH, 32, 32, 3)) * 0.5).astype("float32")
    t0 = time.perf_counter()
    if bits == 8:
        cuda_plan = quantize_cnn(params, cfg, calib, method="cuda",
                                 device=dev)
    else:        # W4A8: JAX's quantize_cnn has no weight_bits, nor the port's
        plan = lower(build_cnn_graph(cfg), params,
                     torch.as_tensor(calib, device=dev), weight_bits=bits,
                     group_size=group)
        cuda_plan = CompiledPlan(plan, method="cuda", device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return {"plan": cuda_plan, "x": x, "cfg": cfg,
            "t_lower": time.perf_counter() - t0}


def phase_plan(torch, K, name, built, dev="cuda"):
    """Hold one built plan of ``PLANS`` (``build_plan``, in the check
    phase): its cuda trunk against the torch trunk and a host run; returns
    ``(plan, x, trunk)``, the CompiledPlan, its 256 input images and its
    cuda trunk."""
    from repro_torch.core.quantize import QTensorW4
    from repro_torch.graph import CompiledPlan
    primitive, bits, group = PLANS[name]
    spread = group if bits == 4 and group < 32 else None
    cuda_plan, x, cfg = built["plan"], built["x"], built["cfg"]
    t_lower = built["t_lower"]
    weights = [v for n in cuda_plan.plan.nodes if n.op == "qconv"
               for k, v in n.qparams.items() if k in ("w", "w_dw", "w_pw")]
    check(all(isinstance(v, QTensorW4) == (bits == 4) for v in weights),
          f"{name}: not every conv weight is {'W4' if bits == 4 else 'int8'}")
    torch_plan = CompiledPlan(cuda_plan.plan, method="torch", device=dev)
    host_plan = CompiledPlan(plan_to_host(cuda_plan.plan), method="torch",
                             device="cpu")
    captured = ""
    if torch.device(dev).type == "cuda":
        captured = check_captured(torch, K, name, cuda_plan, x)
    K.reset_launches()
    tc = cuda_plan.trunk(x)
    used = sorted(k.__name__ for k in K.KERNELS if k.launches)
    suffix = "_w4" if bits == 4 else "_q8"
    check(all(u.endswith(suffix) or u == "maxpool2d_s8" for u in used),
          f"{name}: a {bits}-bit forward launched {used}")
    tt = torch_plan.trunk(x)
    check(tc.q.dtype == torch.int8 and tc.frac_bits == tt.frac_bits,
          f"{name}: trunk dtype/scale mismatch")
    diff = int((tc.q.int() - tt.q.int()).abs().max())
    check(diff == 0, f"{name}: cuda trunk differs from torch trunk by "
                     f"{diff}")
    th = host_plan.trunk(x[:8])
    check(torch.equal(tc.q[:8].cpu(), th.q),
          f"{name}: card trunk differs from the host run")
    lc, lt = cuda_plan(x), torch_plan(x)
    check(tuple(lc.shape) == (BATCH, cfg.num_classes)
          and bool(torch.isfinite(lc).all()),
          f"{name}: logits not finite of shape (256, 10)")
    err = float((lc - lt).abs().max())
    check(err <= 1e-5, f"{name}: logits differ by {err} > 1e-5")
    nz = float((tc.q != 0).float().mean())
    groups = ""
    if bits == 4:
        n_groups = [len(set(v.shifts.tolist())) for v in weights]
        check(not spread or max(n_groups) > 1,
              f"{name}: no layer carries more than one group shift")
        groups = (f", W4 group_size={group}, distinct group shifts per "
                  f"weight {n_groups}, kernels {used}")
    print(f"[plan] {name}: lowered in {t_lower:.2f} s, in_fb="
          f"{cuda_plan.plan.in_fb}, cuda trunk == torch trunk bitwise "
          f"({tuple(tc.q.shape)}, {nz:.3f} nonzero) == host trunk, "
          f"logits max |diff| {err:.2e}{groups}{captured}")
    return cuda_plan, x, tc


# ------------------------------------------------------------- phase check --

def plan_weight_bytes(plan) -> tuple:
    """(bytes, leaves) of a plan's quantized parameters: every tensor leaf
    of its qconv and qbn nodes (codes, W4 shifts, biases, qbn affines)."""
    n_bytes = n_leaves = 0
    for node in plan.nodes:
        if node.op not in ("qconv", "qbn"):
            continue
        for v in node.qparams.values():
            for t in (getattr(v, "q", None), getattr(v, "shifts", None),
                      v if hasattr(v, "element_size") else None):
                if t is not None:
                    n_bytes += t.numel() * t.element_size()
                    n_leaves += 1
    return n_bytes, n_leaves


def phase_check(torch, K, card, rng, dev="cuda") -> dict:
    """The static checks on the card (``repro_torch.check``): every plan of
    ``PLANS`` lowered at full size and built, each build verified by
    ``validate_plan`` (a plan that fails raises: a finding, never
    bypassed); for the served plans their least accumulator headroom in
    bits, their weight bytes and the seconds ``validate_plan`` adds to a
    build; a copy of the int8 dws plan whose first conv reads its input 3
    frac bits off the producer's scale refused by ``CompiledPlan`` with
    ``CheckError`` before any kernel wrapper's count moves; the lint over
    the port's tree. Returns the built plans, for phase 4."""
    from repro_torch.check import (CheckError, check_plan_overflow,
                                   validate_plan)
    from repro_torch.check.astlint import lint_paths, port_paths
    from repro_torch.graph import CompiledPlan
    built = {}
    for name in PLANS:
        b = built[name] = build_plan(torch, name, rng, dev)
        plan = b["plan"].plan
        t0 = time.perf_counter()
        validate_plan(plan)
        validate_s = time.perf_counter() - t0
        bounds = check_plan_overflow(plan)
        check(bounds and all(x.ok for x in bounds),
              f"check {name}: bounds {bounds}")
        worst = min(bounds, key=lambda x: x.headroom_bits)
        n_bytes, n_leaves = plan_weight_bytes(plan)
        served = "served" if name in SERVED else "phase 4 only"
        print(f"[check] {name} ({served}): validate_plan "
              f"{1e3 * validate_s:.3f} ms of a {b['t_lower']:.3f} s "
              "lowering and build; "
              f"{len(bounds)} bounds, least headroom "
              f"{worst.headroom_bits:.2f} bits ({worst.node}/{worst.stage}, "
              f"|acc| <= {worst.acc_max}, requant shift "
              f"{worst.requant_shift}); weights {n_bytes} B in {n_leaves} "
              f"tensors on {card}")

    base = built["dws"]["plan"].plan
    first = next(i for i, n in enumerate(base.nodes) if n.op == "qconv")
    nodes = list(base.nodes)
    nodes[first] = dataclasses.replace(nodes[first],
                                       in_fb=nodes[first].in_fb + 3)
    tampered = dataclasses.replace(base, nodes=tuple(nodes))
    K.reset_launches()
    try:
        CompiledPlan(tampered, method="cuda", device=dev)
        refused = None
    except CheckError as e:
        refused = e
    launched = {k.__name__: k.launches for k in K.KERNELS if k.launches}
    check(refused is not None and not launched,
          f"check: the tampered dws plan built (refused: {refused}), "
          f"launches {launched}")
    CompiledPlan(tampered, method="cuda", device=dev, validate=False)
    print(f"[check] the int8 dws plan with {base.nodes[first].name}'s in_fb "
          f"moved by 3: CompiledPlan raised CheckError with "
          f"{len(refused.messages)} message(s) {list(refused.messages)}, "
          "no kernel launched; validate=False builds it")

    t0 = time.perf_counter()
    paths = port_paths(ROOT)
    findings = lint_paths(paths)
    check(not findings, "check: the lint found "
          + "; ".join(str(f) for f in findings))
    print(f"[check] astlint over src/repro_torch, chip_smoke.py and "
          f"scripts/torch_*.py ({len(paths)} paths): 0 findings in "
          f"{time.perf_counter() - t0:.2f} s")
    return built


@contextlib.contextmanager
def recording_configs(resolved: dict):
    """Record every config ``tune.get_config`` returns inside the block
    (the executor's and ``kernels.ops``' lookups), keyed (sig, dtype,
    config items)."""
    from repro_torch import tune
    inner = tune.get_config

    def get_config(sig, dtype, device=None):
        cfg = inner(sig, dtype, device)
        dt = dtype if type(dtype) is str else tune.dtype_key(dtype)
        resolved[sig, dt, tuple(sorted(cfg.items()))] = cfg
        return cfg
    tune.get_config = get_config
    try:
        yield
    finally:
        tune.get_config = inner


def phase_check_configs(torch, card, resolved: dict):
    """The Hopper verdict (``repro_torch.check.check_schedule``) of every
    config phases 4, 5, 8 and 9 resolved, each with this build's
    registers (``ptxas``'s report of the loaded library); the phase fails
    on an error or on a config whose registers the report lacks. Then the
    audit of the cache phase 8 wrote."""
    from repro_torch.check import (audit_cache, check_schedule,
                                   summarize_audit)
    verdicts = [(sig, dt, check_schedule(sig, cfg, dt))
                for (sig, dt, _), cfg in resolved.items()]
    bad = [v.message() for _, _, v in verdicts if not v.ok]
    unknown = [v.message() for _, _, v in verdicts if v.registers is None]
    check(not bad, f"check: configs the verdict refuses: {bad}")
    check(verdicts and not unknown,
          f"check: configs without this build's registers: {unknown}")
    warned = [v for _, _, v in verdicts if v.warnings]
    top = max(verdicts,
              key=lambda t: t[2].registers * t[2].footprint.threads)
    v = top[2]
    per_kernel = {}
    for sig, dt, x in verdicts:
        per_kernel[f"{sig.kernel}/{dt}"] = per_kernel.get(
            f"{sig.kernel}/{dt}", 0) + 1
    print(f"[check] {len(verdicts)} configs resolved in phases 4, 5, 8 and "
          f"9 ({dict(sorted(per_kernel.items()))}): {len(verdicts)} ok, "
          f"{len(warned)} with a warning "
          f"({'; '.join(sorted({w for x in warned for w in x.warnings}))}"
          f"), 0 errors; largest registers x threads {v.registers} x "
          f"{v.footprint.threads} = {v.registers * v.footprint.threads} of "
          f"65536 ({v.footprint.instance}, {top[0].kernel}/{top[0].key()} "
          f"[{top[1]}]); largest shared bytes "
          f"{max(x.footprint.total_bytes for _, _, x in verdicts)} of "
          f"{v.budget}; registers from this build's ptxas report, on "
          f"{card}")
    rows = audit_cache(str(TUNE_CACHE))
    summ = summarize_audit(rows)
    check(summ["entries"] > 0 and not summ["infeasible"]
          and all(r["registers"] is not None for r in rows),
          f"check: the audit of {TUNE_CACHE}: {summ}")
    print(f"[check] audit of {TUNE_CACHE.relative_to(ROOT)}: "
          f"{summ['entries']} entries, {summ['feasible']} feasible, "
          f"{summ['warnings']} with a warning, registers of every entry "
          f"known; largest registers x threads "
          f"{max(r['registers'] * r['threads'] for r in rows)}")


def check_captured(torch, K, name, plan, x):
    """Capture ``plan`` (jit=True) at every bucket phase 5 serves and hold
    each captured trunk bitwise against the same plan run node by node
    from Python (jit=False): the capture's first call and a replay. A
    replay then counts exactly the launches an eager forward counts, and
    at each bucket the launches its capture recorded (what every replay
    adds to the wrappers' counts) equal the port's kernels that
    torch.profiler sees one replay run on the card. Returns a note for
    the [plan] line."""
    from repro_torch.graph import CompiledPlan
    check(plan.jit and plan.traces == 0,
          f"{name}: the served plan is not a fresh jit=True plan")
    eager = CompiledPlan(plan.plan, method=plan.method, device=plan.device,
                         jit=False)
    first_ms = []
    for b in CAPTURED_BUCKETS:
        want = eager.trunk(x[:b])
        for call in ("capture", "replay"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = plan.trunk(x[:b])
            torch.cuda.synchronize()
            if call == "capture":
                first_ms.append(1e3 * (time.perf_counter() - t0))
            check(torch.equal(got.q, want.q)
                  and got.frac_bits == want.frac_bits,
                  f"{name}: the captured trunk at batch {b} ({call}) "
                  "differs from jit=False")
        err = float((plan(x[:b]) - eager(x[:b])).abs().max())
        check(err <= 1e-5, f"{name}: captured logits at batch {b} differ "
                           f"from jit=False by {err}")
    check(plan.traces == len(CAPTURED_BUCKETS),
          f"{name}: {plan.traces} captures for buckets {CAPTURED_BUCKETS}")
    K.reset_launches()
    eager.trunk(x)
    want = {k.__name__: k.launches for k in K.KERNELS}
    K.reset_launches()
    plan.trunk(x)
    got = {k.__name__: k.launches for k in K.KERNELS}
    check(got == want and any(got.values()),
          f"{name}: a replay launched {got}, an eager forward {want}")
    seen = []
    for b in CAPTURED_BUCKETS:
        recorded = {}
        for k, n in plan._graphs[b].launches.items():
            sym = DEVICE_KERNEL[k.__name__]
            recorded[sym] = recorded.get(sym, 0) + n
        x_dev = torch.from_numpy(x[:b]).cuda()
        rows = device_kernels(torch, lambda: plan.forward_batch(x_dev), 5)
        ran = {sym: sum(r.launches for r in rows if sym in r.key)
               for sym in set(DEVICE_KERNEL.values())}
        ran = {sym: n for sym, n in ran.items() if n}
        check(ran == recorded,
              f"{name}: one replay at batch {b} ran {ran} on the card "
              f"(torch.profiler), its capture recorded {recorded}")
        seen.append(f"{b}: {dict(sorted(ran.items()))}")
    return (f"; captured at batches {CAPTURED_BUCKETS} ({plan.traces} "
            "graphs; first call, warm-up + capture + replay, "
            + " and ".join(f"{ms:.1f}" for ms in first_ms) + " ms), each "
            "trunk == jit=False bitwise, a replay's launches == an eager "
            "forward's == the kernels torch.profiler saw one replay run ("
            + "; ".join(seen) + ")")


# ---------------------------------------------------------------- phase 5 --

def phase_serve(torch, K, name, plan, card, rng):
    """Serve one plan's images through CNNEngine; returns the launch count
    of every kernel in that run."""
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    n_img = SERVED[name]
    images = (rng.standard_normal((n_img, 32, 32, 3)) * 0.5) \
        .astype("float32")
    eng = CNNEngine(plan, CNNServeConfig(max_batch=BATCH))
    for i in range(n_img):
        eng.submit(ImageRequest(uid=i, image=images[i]))
    K.reset_launches()
    done = eng.run_until_drained()
    launches = {k.__name__: k.launches for k in K.KERNELS}
    st = eng.stats
    statuses = {r.status for r in done}
    check(len(done) == n_img and statuses == {"ok"},
          f"serve {name}: {len(done)} requests, statuses {statuses}")
    check(st["errors"] == 0 and st["retries"] == 0,
          f"serve {name}: errors={st['errors']} "
          f"retries={st['retries']}")
    rounds = -(-n_img // BATCH)
    check(st["batch_rounds"] == rounds,
          f"serve {name}: {st['batch_rounds']} rounds, not {rounds}")
    want_launches = {k: rounds * PER_FORWARD[name].get(k, 0)
                     for k in launches}
    check(launches == want_launches,
          f"serve {name}: launches {launches}, a plan of "
          f"{rounds} forwards needs {want_launches}")
    by_uid = {r.uid: r for r in done}
    worst = 0.0
    for start in range(0, n_img, BATCH):
        chunk = images[start:start + BATCH]
        want = plan.forward_batch(chunk).cpu().numpy()
        got = [by_uid[start + j].logits for j in range(len(chunk))]
        worst = max(worst, float(np.abs(np.stack(got) - want).max()))
    check(worst <= 1e-5, f"serve {name}: logits differ from "
                         f"forward_batch by {worst}")
    round_ms = 1e3 * eng.metrics.counter("serve.cnn.batch_time_s").value \
        / st["batch_rounds"]
    print(f"[serve] {name}: {n_img} images in {st['batch_rounds']} "
          f"rounds, all ok; images_per_s={st['images_per_s']:.1f} "
          f"latency_p50_s={st['latency_p50_s']:.5f} "
          f"latency_p99_s={st['latency_p99_s']:.5f} on {card}; "
          f"launches {launches}; logits vs forward_batch max |diff| "
          f"{worst:.1e}")
    serve_breakdown(torch, name, plan, images[:BATCH], round_ms, card)
    return launches


def serve_breakdown(torch, name, plan, x_host, round_ms, card):
    """Where one full 256-image round goes: the engine's round (host images
    in, host logits out), forward_batch on host input, and, for the plan
    as served (its captured graph) and the same plan run node by node from
    Python (jit=False), in one run: forward_batch on device-resident input
    (CUDA events), the device time of its kernels (torch.profiler), the
    device's idle share and throughput images/s."""
    from repro_torch.graph import CompiledPlan
    x_dev = torch.from_numpy(x_host).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        plan.forward_batch(x_host).cpu()
    fwd_host_ms = 1e3 * (time.perf_counter() - t0) / 10
    eager = CompiledPlan(plan.plan, method=plan.method, device=plan.device,
                         jit=False)
    parts, rows = [], None
    for label, ex in (("captured", plan), ("jit=False", eager)):
        fwd_ms = time_ms(torch, lambda: ex.forward_batch(x_dev), reps=10,
                         trials=5)
        kernels = device_kernels(torch, lambda: ex.forward_batch(x_dev), 5)
        dev_ms = sum(r.us for r in kernels) / 1e3
        n_kern = sum(r.launches for r in kernels)
        check(dev_ms > 0, f"torch.profiler saw no device time ({label})")
        ips = ex.throughput(x_dev, reps=10, warmup=3)["images_per_s"]
        parts.append(f"{label}: forward_batch device-resident {fwd_ms:.4f} "
                     f"ms, device busy {dev_ms:.4f} ms in {n_kern:.0f} "
                     f"kernels, idle {1 - dev_ms / fwd_ms:.3f}, throughput "
                     f"{ips:.1f} images/s")
        rows = rows or kernels
    print(f"[breakdown] {name}: one 256-image round: engine round "
          f"{round_ms:.4f} ms; forward_batch host in/out {fwd_host_ms:.4f} "
          f"ms; {'; '.join(parts)}; on {card}")
    for r in sorted(rows, key=lambda r: -r.us):
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[breakdown] {name}   {r.us:9.1f} us x{r.launches:3.0f}  "
              f"{kernel[:110]}")


# ---------------------------------------------------------------- phase 6 --

def phase_lm(torch, K, card, rng, dev="cuda", cfg=None, n_req=LM_REQUESTS,
             new_tokens=LM_NEW, prompt=LM_PROMPT, n_eager=LM_EAGER_REQUESTS):
    """Serve Qwen2-0.5B in every (precision, KV cache) of ``LM_RUNS``,
    captured, and ``LM_EAGER`` again with jit=False on the first
    ``n_eager`` requests; then the other serve paths (:func:`lm_paths`);
    returns the launch count of every kernel over the runs, the prompts
    and the model's parameters."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(LM_ARCH)
    params, made = make_lm_params(torch, cfg, dev, "lm")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {made}")
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(prompt[0], prompt[1] + 1, n_req)]
    runner = LMRunner(torch, K, card, cfg, params, dev, new_tokens)
    streams, engines = runner.streams, runner.engines
    for prec, kv in LM_RUNS:
        runner.run("lm", lm_label(prec, kv), prompts, precision=prec,
                   kv_cache=kv)
    for prec in LM_EAGER:
        runner.run("lm", prec + " jit=False", prompts[:n_eager], jit=False,
                   precision=prec)
    for prec in LM_KERNEL:
        check(streams[prec] == streams[prec + "-torch"],
              f"lm {prec}: the kernel's token streams differ from the "
              "plain version's")
        agree = agreement(streams[prec], streams["float"])
        print(f"[lm] {prec}: token streams equal to {prec}-torch's "
              f"({n_req} x {new_tokens} tokens); {agree:.3f} of tokens "
              "equal to the float engine's")
    for prec in LM_EAGER:
        check(streams[prec + " jit=False"] == streams[prec][:n_eager],
              f"lm {prec}: jit=False token streams differ from the "
              "captured engine's")
        print(f"[lm] {prec}: captured token streams equal to jit=False's "
              f"({n_eager} x {new_tokens} tokens)")
    check(streams["int8 kv=int8"] == streams["int8-torch kv=int8"],
          "lm int8 kv=int8: the kernel's token streams differ from the "
          "plain version's")
    print(f"[lm] kv=int8: int8 token streams equal to int8-torch's "
          f"({n_req} x {new_tokens} tokens); token agreement with the float "
          f"KV cache: float "
          f"{agreement(streams['float kv=int8'], streams['float']):.3f}, "
          f"int8 {agreement(streams['int8 kv=int8'], streams['int8']):.3f}")
    lm_paths(runner, prompts, n_eager)
    for label, eng in engines.items():
        lm_breakdown(torch, label, eng, cfg, dev)
    return runner.launches, prompts, params


def make_lm_params(torch, cfg, dev, tag):
    """Seeded random parameters of ``cfg`` made on ``dev``, their count
    checked against the config's; returns them and a line's text of their
    count and time."""
    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    sync(torch, dev)
    n_params = sum(v.numel() for v in _leaves(params))
    # the config's analytic count leaves out the final norm's d_model
    check(n_params == cfg.param_count() + cfg.d_model,
          f"{tag}: {n_params} parameters, the config counts "
          f"{cfg.param_count()} + {cfg.d_model}")
    return params, (f"{n_params:,} parameters ({cfg.param_dtype}) made on "
                    f"the card in {time.perf_counter() - t0:.2f} s")


def lm_label(prec, kv="float", layout=""):
    return " ".join([prec] + (["kv=int8"] if kv == "int8" else [])
                    + ([layout] if layout else []))


class LMRunner:
    """Phase 6's engines on one model: :meth:`run` builds one, serves it
    (:func:`serve_lm`), checks its kernel launches and its pool, prints
    its line and keeps its streams under its label."""

    def __init__(self, torch, K, card, cfg, params, dev, new_tokens):
        self.torch, self.K, self.card, self.cfg = torch, K, card, cfg
        self.params, self.dev, self.new_tokens = params, dev, new_tokens
        self.launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
        self.streams, self.engines, self.done = {}, {}, {}

    def run(self, tag, label, served, jit=True, warm=None, graphs=None,
            trace=False, shared=False, **scfg_kw):
        """Serve ``served`` on a new engine of ``scfg_kw``; ``shared``
        gives a contiguous engine the prefill a paged engine with the
        prefix cache takes (``api.shared_prefill_fn``), so that the two
        differ in the layout and the sharing only."""
        from repro_torch.models import api
        from repro_torch.serve import Engine, ServeConfig
        torch, dev, cfg = self.torch, self.dev, self.cfg
        t0 = time.perf_counter()
        eng = Engine(cfg, self.params, ServeConfig(
            max_batch=LM_BATCH, max_len=LM_MAX_LEN, **scfg_kw), jit=jit)
        if shared:
            eng.prefill = api.shared_prefill_fn(
                cfg, LM_MAX_LEN, attn_impl=eng.scfg.attn_impl,
                precision=eng.scfg.precision)
        sync(torch, dev)
        t_init = time.perf_counter() - t0
        got, done, wall, events = serve_lm(torch, self.K, eng, served,
                                           self.new_tokens, label, dev,
                                           warm=warm, graphs=graphs,
                                           trace=trace)
        st = eng.stats
        calls = 3 * cfg.n_layers * (st["prefills"] + st["decode_steps"])
        want = dict.fromkeys(got, 0)
        prec = eng.scfg.precision
        if prec in LM_KERNEL and torch.device(dev).type == "cuda":
            want[LM_KERNEL[prec]] = calls     # a host run launches nothing
        if cfg.mamba is not None and torch.device(dev).type == "cuda":
            want["causal_conv1d"] = conv_per_prefill(cfg) * st["prefills"]
        check(got == want, f"{tag} {label}: launches {got}, "
                           f"{st['prefills']} prefills and "
                           f"{st['decode_steps']} decode steps need {want}")
        if eng.pool is not None:
            bad = eng.pool.audit(expect_drained=True)
            check(bad == [], f"{tag} {label}: the pool audits {bad}")
        for k, v in got.items():
            self.launches[k] += v
        self.streams[label] = [r.out_tokens for r in done]
        self.done[label] = done
        ttft = np.percentile([r.ttft_s for r in done], [50, 99])
        step_ms = 1e3 * eng.metrics.counter("serve.decode_time_s").value \
            / st["decode_steps"]
        pool = ""
        if eng.paged:
            pool = (f"; blocks_in_use {st['blocks_in_use']}, blocks_free "
                    f"{st['blocks_free']}, prefix_hit_rate "
                    f"{st['prefix_hit_rate']:.4f}")
        print(f"[{tag}] {label}: {len(served)} requests ok, "
              f"{st['tokens_out']} tokens in {wall:.2f} s "
              f"({st['tokens_out'] / wall:.1f} tokens/s end to end; "
              f"decode_tok_s={st['decode_tok_s']:.1f}), {st['prefills']} "
              f"prefills, {st['decode_steps']} decode steps at "
              f"{step_ms:.3f} ms, occupancy {st['occupancy']:.3f}, TTFT p50 "
              f"{ttft[0]:.4f} s p99 {ttft[1]:.4f} s (over the {len(served)} "
              f"requests), engine init {t_init:.2f} s, {eng.traces} graphs"
              f"{pool}; launches { {k: v for k, v in got.items() if v} } "
              f"on {self.card}")
        if jit and label in LM_BREAKDOWN:
            self.engines[label] = eng
        return eng, events


def lm_paths(runner, prompts, n_eager):
    """Phase 6's other serve paths on the same model: (a) the paged
    layout without the prefix cache, per ``LM_PAGED``, streams equal to
    the contiguous engine's; (b) prefix traffic (``LM_SHARED`` shared
    tokens, own suffixes) and mixed-bucket prefix traffic
    (``LM_MIXED_SHARED`` tokens, suffixes in two buckets), each paged and
    contiguous per ``LM_PREFIX``, streams equal, hit rate above 0, the
    mixed traffic with hits in both buckets; (c) the tight pool,
    streams equal to the contiguous engine's (with the shared-page
    prefill, as in (b)) with at least one preemption
    (an ``engine.block_free`` span with ``preempt=True``); (d) the static
    scheduler per ``LM_STATIC``, captured equal to jit=False on the first
    ``n_eager`` requests and int8 to int8-torch; (e) ``attn_impl=
    "flash_tri"``, its agreement with ``"flash"`` printed."""
    streams, cfg = runner.streams, runner.cfg
    n_req, new = len(prompts), runner.new_tokens
    for prec, kv in LM_PAGED:
        label = lm_label(prec, kv, "paged")
        runner.run("paged", label, prompts, precision=prec, kv_cache=kv,
                   kv_layout="paged", kv_block_size=LM_BLOCK,
                   prefix_cache=False)
        check(streams[label] == streams[lm_label(prec, kv)],
              f"paged {label}: token streams differ from the contiguous "
              "engine's")
        print(f"[paged] {label}: token streams equal to the contiguous "
              f"engine's ({n_req} x {new} tokens)")
    # (b) a system prompt shared by every request of a chat service
    prng = np.random.default_rng([SEED, 6])
    shared = prng.integers(0, cfg.vocab, (LM_SHARED,)).astype(np.int32)
    chat = [np.concatenate([shared, prng.integers(0, cfg.vocab, (int(n),))])
            .astype(np.int32) for n in prng.integers(
                LM_SUFFIX[0], LM_SUFFIX[1] + 1, n_req)]
    # ... and one whose requests' prefills fall in two buckets
    shared = prng.integers(0, cfg.vocab, (LM_MIXED_SHARED,)).astype(np.int32)
    mixed = [np.concatenate([shared, prng.integers(0, cfg.vocab, (int(
        prng.integers(lo, hi + 1)),))]).astype(np.int32)
        for lo, hi in LM_MIXED_SUFFIX * (n_req // 2)]
    for traffic, served in (("prefix", chat), ("mixed prefix", mixed)):
        for prec, kv in LM_PREFIX:
            prefix_run(runner, traffic, served, prec, kv,
                       cross=traffic == "mixed prefix")
    prefix_exactness(runner, chat[0])
    label, ref = "float tight paged", "float shared-prefill contiguous"
    runner.run("paged", ref, prompts, shared=True)
    _, events = runner.run("paged", label, prompts, trace=True,
                           kv_layout="paged", kv_block_size=LM_BLOCK,
                           kv_num_blocks=LM_TIGHT_BLOCKS)
    preempts = sum(1 for e in events if e["name"] == "engine.block_free"
                   and e["ph"] == "B" and e.get("args", {}).get("preempt"))
    check(preempts > 0, f"paged {label}: no preemption in the run")
    check(streams[label] == streams[ref],
          f"paged {label}: token streams differ from the contiguous "
          "engine's")
    print(f"[paged] {label}: kv_num_blocks={LM_TIGHT_BLOCKS}, {preempts} "
          "preemptions (engine.block_free spans with preempt=True); token "
          f"streams equal to the contiguous engine's ({n_req} x {new} "
          "tokens)")
    static_warm = prompts[:LM_BATCH]
    for prec in LM_STATIC:
        runner.run("static", prec + " static", prompts, warm=static_warm,
                   graphs=1, precision=prec, scheduler="static")
    for prec in LM_EAGER:
        runner.run("static", prec + " static jit=False", prompts[:n_eager],
                   jit=False, precision=prec, scheduler="static")
        check(streams[prec + " static jit=False"]
              == streams[prec + " static"][:n_eager],
              f"static {prec}: jit=False token streams differ from the "
              "captured engine's")
    check(streams["int8 static"] == streams["int8-torch static"],
          "static int8: the kernel's token streams differ from the plain "
          "version's")
    agree = {p: agreement(streams[p + " static"], streams[p])
             for p in ("float", "int8")}
    print(f"[static] captured float and int8 token streams equal to "
          f"jit=False's ({n_eager} x {new} tokens), int8 equal to "
          f"int8-torch's ({n_req} x {new}); agreement with the continuous "
          f"engine: float {agree['float']:.3f}, int8 {agree['int8']:.3f} "
          "(left-padded prompts: not gated)")
    runner.run("lm", "float flash_tri", prompts, attn_impl="flash_tri")
    print(f"[lm] float flash_tri: "
          f"{agreement(streams['float flash_tri'], streams['float']):.4f} "
          "of tokens equal to attn_impl='flash''s")


def prefix_run(runner, traffic, served, prec, kv, cross=False):
    """Serve ``served`` contiguous (with the paged engine's prefill,
    ``api.shared_prefill_fn``) and paged with the prefix cache: streams
    equal, hit rate above 0, and a hit in every prefill bucket the
    prompts fall in (the ``engine.prefill`` spans' ``prefix_hit``); with
    ``cross``, a hit across buckets: the first prefill of some bucket
    hits, so its pages came from a prefill of another bucket."""
    streams, n_req, new = runner.streams, len(served), runner.new_tokens
    ref = lm_label(prec, kv, traffic + " contiguous")
    runner.run("paged", ref, served, precision=prec, kv_cache=kv,
               shared=True)
    label = lm_label(prec, kv, traffic + " paged")
    eng, events = runner.run("paged", label, served, precision=prec,
                             kv_cache=kv, kv_layout="paged",
                             kv_block_size=LM_BLOCK, trace=True)
    check(streams[label] == streams[ref],
          f"paged {label}: token streams differ from the contiguous "
          "engine's on the same prompts")
    check(eng.stats["prefix_hit_rate"] > 0, f"paged {label}: no prefix hit")
    hits = {}
    for e in events:
        if e["name"] == "engine.prefill" and e["ph"] == "B":
            a = e["args"]
            hits.setdefault(a["bucket"], []).append(a["prefix_hit"] > 0)
    check(all(any(h) for h in hits.values()),
          f"paged {label}: a prefill bucket has no hit ({hits})")
    crossed = sorted(b for b, h in hits.items() if h[0])
    check(not cross or crossed,
          f"paged {label}: no hit crosses buckets ({hits})")
    print(f"[paged] {label}: token streams equal to the contiguous "
          f"engine's on the same prompts ({n_req} x {new} tokens); hits "
          "share storage and recompute their prompt; hits / prefills by "
          "bucket " + ", ".join(f"{b}: {sum(h)} / {len(h)}"
                                for b, h in sorted(hits.items()))
          + f"; buckets whose first prefill hit pages of another bucket: "
          f"{crossed}"
          + "; " + prefill_latency(runner.done[label], runner.done[ref]))


def prefix_exactness(runner, prompt):
    """What a prefix hit's exactness rests on, measured on one prefix
    prompt (float, the paged engine's prefill, ``api.shared_prefill_fn``,
    and ``api.prefill_fn`` beside it): the max |diff| of the prefix
    rows' K/V between a prefill of the prefix alone at each bucket and of
    the whole prompt at its bucket, and of the logits and suffix K/V of
    ``prefill_suffix`` over the whole prompt's prefix K/V against the
    whole prompt's."""
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    torch, dev, cfg = runner.torch, runner.dev, runner.cfg
    params = T.cast_params(runner.params, cfg)

    def prefill(toks, n, bucket, make=api.shared_prefill_fn):
        t = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        t[0, :n] = torch.from_numpy(toks[:n]).to(dev)
        return make(cfg, LM_MAX_LEN)(params, {
            "tokens": t, "prompt_lens": torch.tensor(
                [n], dtype=torch.int32, device=dev)})
    plen, n = len(prompt), LM_SHARED
    full = 1 << (plen - 1).bit_length()
    diffs = {}
    for make in (api.prefill_fn, api.shared_prefill_fn):
        logits, cache = prefill(prompt, plen, full, make)
        diffs[make.__name__] = " / ".join(str(max(
            (c[k][:, :, :n].float() - cache[k][:, :, :n].float())
            .abs().max().item() for k in ("k", "v")))
            for c in (prefill(prompt, n, b, make)[1] for b in (64, 128, 256)))
    check(diffs["shared_prefill_fn"] == "0.0 / 0.0 / 0.0",
          f"paged prefix exactness: shared_prefill_fn's prefix rows differ "
          f"across buckets ({diffs['shared_prefill_fn']})")
    s = plen - n
    sb = max(16, 1 << (s - 1).bit_length())
    t = torch.zeros((1, sb), dtype=torch.long, device=dev)
    t[0, :s] = torch.from_numpy(prompt[n:]).to(dev)
    lg, ks, _ = api.prefill_suffix_fn(cfg)(params, {
        "tokens": t, "prefix_k": cache["k"][:, :, :n],
        "prefix_v": cache["v"][:, :, :n],
        "suffix_lens": torch.tensor([s], dtype=torch.int32, device=dev)})
    dk = (ks[:, :, :s].to(cache["k"].dtype).float()
          - cache["k"][:, :, n:plen].float()).abs().max().item()
    print(f"[paged] prefix exactness (float, one {plen}-token prompt, "
          f"{n}-token prefix): max |diff| of the prefix rows' K/V, prefix "
          f"alone at bucket 64 / 128 / 256 against the whole prompt at "
          f"{full}: shared_prefill_fn {diffs['shared_prefill_fn']}, "
          f"prefill_fn {diffs['prefill_fn']}; prefill_suffix "
          f"({s} rows at bucket {sb}) against the whole prompt: logits "
          f"{(lg - logits).abs().max().item()}, suffix K {dk}")


def prefill_latency(done, ref) -> str:
    """Admission to first token (the prefill, no queue wait), p50, of a
    run's first-admitted request (the prefix's miss) and of the rest (its
    hits), beside the contiguous run's on the same prompts."""
    def split(rs):
        rs = sorted(rs, key=lambda r: r.admit_t)
        lat = [r.first_token_t - r.admit_t for r in rs]
        return lat[0], float(np.median(lat[1:]))
    (miss, hit), (c_miss, c_hit) = split(done), split(ref)
    return (f"prefill (admission to first token) of the miss "
            f"{1e3 * miss:.3f} ms, p50 of the {len(done) - 1} hits "
            f"{1e3 * hit:.3f} ms; contiguous {1e3 * c_miss:.3f} / "
            f"{1e3 * c_hit:.3f} ms")


def agreement(a, b) -> float:
    """The share of equal tokens of two sets of token streams."""
    return float(np.mean([x == y for s, t in zip(a, b)
                          for x, y in zip(s, t)]))


def serve_lm(torch, K, eng, prompts, new_tokens, label, dev, warm=None,
             graphs=None, trace=False):
    """Warm ``eng`` up with one request into each prefill bucket the
    prompts fall into, or with the prompts ``warm`` after which a captured
    engine holds ``graphs`` graphs (each graph's capture, whose first-call
    ms is printed; their count checked), zero
    its stats and the launch counts, then serve ``prompts``: every status
    ok, streams of ``new_tokens`` ids in the vocabulary, no error or
    retry, and no capture in the timed run. Returns (launches, requests by
    uid, wall seconds, the tracer's events of the timed run if
    ``trace``)."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import Request
    vocab = eng.cfg.vocab
    from repro_torch.models.transformer import NOT_DENSE_KV
    buckets = sorted({eng._bucket_len(len(p)) for p in prompts})
    want = graphs
    if warm is None:
        if eng.cfg.family not in NOT_DENSE_KV:
            warm = [np.resize(prompts[0], b) for b in buckets]
            want = 1 + len(buckets)
        else:                   # exact lengths, an eager prefill each
            warm = [p[:LM_PROMPT[0]] for p in prompts[:2]]
            want = 1
    for i, p in enumerate(warm):
        eng.submit(Request(uid=-1 - i, prompt=p, max_new_tokens=2))
    eng.run_until_drained()
    eng.reset_stats()
    if eng._captures():
        check(eng.traces == want,
              f"lm {label}: {eng.traces} graphs after the warm-up, not "
              f"{want}")
        for key, cap in eng._graphs.items():
            what = {"decode": "batch", "static": "batch",
                    "prefill": "bucket"}
            print(f"[lm] {label}: graph {key[0]} {what[key[0]]} "
                  f"{', '.join(map(str, key[1:]))}"
                  f": first call (eager pass + capture) "
                  f"{1e3 * cap.seconds:.1f} ms, "
                  f"{sum(cap.launches.values())} kernel launches a replay")
    traces = eng.traces
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    K.reset_launches()
    if trace:
        obs_trace.clear()
        obs_trace.enable()
    try:
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        events = obs_trace.TRACER.events() if trace else []
        if trace:
            obs_trace.disable()
            obs_trace.clear()
    got = {k.__name__: k.launches for k in K.KERNELS}
    st = eng.stats
    statuses = {r.status for r in done}
    check(len(done) == len(prompts) and statuses == {"ok"},
          f"lm {label}: {len(done)} requests, statuses {statuses}"
          + "".join(f"; uid {r.uid}: {r.error}" for r in done[:1]
                    if r.error))
    done = sorted(done, key=lambda r: r.uid)
    check(all(len(r.out_tokens) == new_tokens
              and all(0 <= t < vocab for t in r.out_tokens)
              for r in done),
          f"lm {label}: a stream is short or holds an id outside the "
          "vocabulary")
    check(st["errors"] == st["retries"] == 0,
          f"lm {label}: errors={st['errors']} retries={st['retries']}")
    check(eng.traces == traces, f"lm {label}: the timed run captured "
                                f"{eng.traces - traces} graphs")
    return got, done, wall, events


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def lm_breakdown(torch, label, eng, cfg, dev, pos=128, reps=5,
                 port=("matmul_q_kernel",), what="the port's matmul kernel"):
    """One decode step of all ``LM_BATCH`` slots at position ``pos`` over a
    cache of the engine's KV dtype, captured (``graph.capture``, as the
    engine captures its step) and run op by op from Python (jit=False):
    each one's time (CUDA events), the device time of its device
    operations (kernels and memsets, torch.profiler) and their count,
    split into those whose names contain one of ``port`` and everything
    else, and the idle share. For an attention-family engine on the
    contiguous cache also the captured prefill (the engine's own graph)
    against the eager one at the buckets ``LM_PREFILL_TIMED``."""
    from repro_torch.check.config import paged_num_blocks
    from repro_torch.graph.capture import capture
    from repro_torch.models import api
    from repro_torch.models.transformer import NOT_DENSE_KV
    if eng.paged:
        # each slot's pages, in an order that interleaves the slots
        bs = eng.scfg.kv_block_size
        cache = api.init_paged_cache(cfg, LM_BATCH,
                                     paged_num_blocks(eng.scfg), bs,
                                     LM_MAX_LEN, kv=eng.scfg.kv_cache,
                                     device=dev)
        n = pos // bs + 1
        ids = 1 + torch.arange(LM_BATCH * n, device=dev).reshape(n, -1).t()
        cache["block_table"][:, :n] = ids
    else:
        cache = api.init_slot_cache(cfg, LM_BATCH, LM_MAX_LEN,
                                    kv=eng.scfg.kv_cache, device=dev)
    cache["len"].fill_(pos)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=dev)
    step = lambda: eng.decode(eng.params, tok, cache)     # noqa: E731
    cap, _ = capture(lambda t: eng.decode(eng.params, t, cache)[0], (tok,),
                     key="lm.breakdown")
    rows = None
    for variant, fn in (("captured", cap.replay), ("jit=False", step)):
        step_ms = time_ms(torch, fn, reps=reps, trials=3)
        kernels = device_kernels(torch, fn, reps)
        dev_ms = sum(r.us for r in kernels) / 1e3
        check(dev_ms > 0, "torch.profiler saw no device time")
        mine = [r for r in kernels if any(t in r.key for t in port)]
        mm_ms = sum(r.us for r in mine) / 1e3
        n_ops = sum(r.launches for r in kernels)
        n_mine = sum(r.launches for r in mine)
        n_memset = sum(r.launches for r in kernels if "Memset" in r.key)
        print(f"[lm-breakdown] {label}: one decode step {variant}, "
              f"{LM_BATCH} slots at position {pos}: {step_ms:.4f} ms (CUDA "
              f"events), device busy {dev_ms:.4f} ms in {n_ops:.0f} device "
              f"operations ({n_memset:.0f} of them memsets), of which "
              f"{what} {mm_ms:.4f} ms in {n_mine:.0f} launches and the rest "
              f"{dev_ms - mm_ms:.4f} ms; device idle "
              f"{1 - dev_ms / step_ms:.3f}")
        rows = rows or kernels
    for r in sorted(rows, key=lambda r: -r.us)[:8]:
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[lm-breakdown] {label}   {r.us:9.1f} us x{r.launches:4.0f}  "
              f"{kernel[:100]}")
    # the round's host work after the step, as the engine does it: the
    # logits to the host, then each slot's greedy pick there
    logits = cap.replay()
    sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        host = logits.cpu().numpy()
    copy_ms = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        picks = [int(np.argmax(host[i, -1])) for i in range(LM_BATCH)]
    pick_ms = 1e3 * (time.perf_counter() - t0) / reps
    check(len(picks) == LM_BATCH, "lm-breakdown: a slot has no pick")
    print(f"[lm-breakdown] {label}: a decode round's host work (host "
          f"clock, mean of {reps}): the {tuple(logits.shape)} float32 "
          f"logits ({logits.numel() * 4 / 1e6:.2f} MB) to the host "
          f"{copy_ms:.4f} ms, the greedy pick of its {LM_BATCH} rows "
          f"{pick_ms:.4f} ms")
    if cfg.family in NOT_DENSE_KV or eng.paged:
        return
    for b in LM_PREFILL_TIMED:
        graph = eng._graphs[("prefill", b)]
        toks, plen = graph.inputs
        eager = lambda: eng.prefill(eng.params, {    # noqa: E731
            "tokens": toks, "prompt_lens": plen})
        ms = {v: time_ms(torch, fn, reps=reps, trials=3)
              for v, fn in (("captured", graph.replay), ("eager", eager))}
        print(f"[lm-breakdown] {label}: one prefill at bucket {b} (batch 1): "
              f"captured {ms['captured']:.4f} ms, eager {ms['eager']:.4f} ms "
              f"(CUDA events)")


# ---------------------------------------------------------------- chaos --

#: the chaos phase's LM traffic: the first CHAOS_REQUESTS of phase 6's
#: prompts (16-96 tokens), LM_NEW new tokens each, greedy, Qwen2-0.5B in
#: "int8" at full size, Engine(max_batch=LM_BATCH, max_len=LM_MAX_LEN)
CHAOS_REQUESTS = 12
CHAOS_PAGED = dict(kv_layout="paged", kv_block_size=LM_BLOCK)
CHAOS_STATIC = dict(scheduler="static")
#: the chaos phase's CNN traffic through the int8 dws plan: one full
#: round of BATCH images and a ragged round of 37 (bucket 64)
CHAOS_IMAGES = BATCH + 37
#: the deadline schedule: every decode round stalls CHAOS_STALL_S against
#: a CHAOS_DEADLINE_S deadline
CHAOS_STALL_S, CHAOS_DEADLINE_S = 0.2, 0.5


def chaos_lm_schedules(per_prefill: int):
    """(name, fault specs, serve config, harness keywords, the outcome
    check on (report, status counts)) of the LM schedules: the matrix of
    tests/test_faults.py at full size, and one kernels.dispatch raise,
    contiguous (in the eager pass of the first prefill's capture) and
    paged (inside that capture, after the pages were taken)."""
    n, b = CHAOS_REQUESTS, LM_BATCH
    rest = n - b

    def only(*ok):
        return lambda rep, by: set(by) <= set(ok)
    return [
        ("prefill raise absorbed",
         [dict(site="engine.prefill", kind="raise", nth=2)], {}, {},
         lambda rep, by: by == {"ok": n} and rep.stats["retries"] >= 1),
        ("prefill retries exhausted",
         [dict(site="engine.prefill", kind="raise", nth=1, times=3)], {},
         {}, lambda rep, by: by == {"error": 1, "ok": n - 1}),
        ("decode retries exhausted, arena rebuilt",
         [dict(site="engine.decode_round", kind="raise", nth=2, times=3)],
         {}, {}, lambda rep, by: by == {"error": b, "ok": rest}
         and rep.stats["arena_rebuilds"] == 1),
        ("corrupt round contained",
         [dict(site="engine.decode_round", kind="corrupt", nth=2)], {}, {},
         lambda rep, by: by == {"ok": n} and len(rep.poisoned) == b
         and len(rep.survivors) == rest),
        ("deadline by delay",
         [dict(site="engine.decode_round", kind="delay", nth=1,
               times=10 ** 6, delay_s=CHAOS_STALL_S)],
         dict(deadline_s=CHAOS_DEADLINE_S), {},
         lambda rep, by: set(by) <= {"ok", "timeout"}
         and rep.stats["timeouts"] >= 1),
        ("shed reject", [], dict(max_queue=b, shed_policy="reject"),
         dict(expect_fired=False),
         lambda rep, by: by == {"ok": b, "shed": rest}),
        ("shed drop", [], dict(max_queue=b, shed_policy="drop"),
         dict(expect_fired=False),
         lambda rep, by: by == {"ok": b, "shed": rest}
         and rep.stats["shed"] == rest),
        ("paged blockpool.alloc",
         [dict(site="blockpool.alloc", kind="raise", nth=2, times=2)],
         CHAOS_PAGED, {}, lambda rep, by: by == {"ok": n}),
        ("paged decode error",
         [dict(site="engine.decode_round", kind="raise", nth=3, times=3)],
         CHAOS_PAGED, {}, lambda rep, by: by == {"error": b, "ok": rest}
         and rep.stats["arena_rebuilds"] == 1),
        ("static prefill raise",
         [dict(site="engine.prefill", kind="raise", nth=1)], CHAOS_STATIC,
         {}, lambda rep, by: by == {"ok": n}),
        ("static decode raise",
         [dict(site="engine.decode_round", kind="raise", nth=1, times=3)],
         CHAOS_STATIC, {}, lambda rep, by: by == {"error": b, "ok": rest}),
        ("static decode corrupt",
         [dict(site="engine.decode_round", kind="corrupt", nth=2)],
         CHAOS_STATIC, {}, lambda rep, by: by == {"ok": n}
         and len(rep.poisoned) == b),
        ("probability matrix, seed 0",
         [dict(site="engine.decode_round", kind="raise", probability=0.2,
               times=2),
          dict(site="engine.prefill", kind="raise", probability=0.2,
               times=2)], {}, dict(expect_fired=False),
         only("ok", "error")),
        ("kernels.dispatch raise, contiguous",
         [dict(site="kernels.dispatch", kind="raise", nth=1)], {}, {},
         lambda rep, by: by == {"ok": n} and rep.stats["retries"] == 1),
        ("kernels.dispatch raise in a capture, paged",
         [dict(site="kernels.dispatch", kind="raise", nth=per_prefill + 1)],
         CHAOS_PAGED, {},
         lambda rep, by: by == {"ok": n} and rep.stats["retries"] == 1),
    ]


def chaos_cnn_schedules(per_forward: int):
    """(name, fault specs, a fresh plan per engine, the outcome check) of
    the CNN schedules; the kernels.dispatch ones fire while a fresh
    plan's first graph is captured (its eager pass, then inside the
    capture), once or on every attempt."""
    n, b = CHAOS_IMAGES, BATCH
    return [
        ("round raise absorbed",
         [dict(site="cnn.batch_round", kind="raise", nth=1, times=2)],
         False, lambda rep, by: by == {"ok": n}
         and rep.stats["retries"] == 2),
        ("round retries exhausted",
         [dict(site="cnn.batch_round", kind="raise", nth=1, times=3)],
         False, lambda rep, by: by == {"error": b, "ok": n - b}),
        ("corrupt round contained",
         [dict(site="cnn.batch_round", kind="corrupt", nth=1)], False,
         lambda rep, by: by == {"ok": n} and len(rep.poisoned) == b
         and len(rep.survivors) == n - b),
        ("kernels.dispatch raise in the first capture's eager pass",
         [dict(site="kernels.dispatch", kind="raise", nth=1)], True,
         lambda rep, by: by == {"ok": n} and rep.stats["retries"] == 1),
        ("kernels.dispatch raise inside the first capture",
         [dict(site="kernels.dispatch", kind="raise", nth=per_forward + 1)],
         True, lambda rep, by: by == {"ok": n}
         and rep.stats["retries"] == 1),
        ("kernels.dispatch persistent",
         [dict(site="kernels.dispatch", kind="raise", nth=1,
               times=10 ** 6)], True,
         lambda rep, by: by == {"error": n}),
    ]


def _dispatch_counts() -> dict:
    """The process counters of kernel entry-point calls, by method."""
    from repro_torch.obs import metrics
    out = {"cuda": 0, "torch": 0}
    for name, m in metrics.snapshot().items():
        if name.startswith("kernels.dispatch."):
            out[name.rsplit(".", 1)[1]] += int(m["value"])
    return out


def run_schedule(torch, card, tag, name, run, specs, check_outcome):
    """One paired schedule through ``run(plan)`` (a chaos harness call):
    every invariant held, the outcome ``check_outcome(report, status
    counts)``, no stream left capturing; prints its line and returns
    the report."""
    import collections
    from repro_torch.faults import inject
    plan = inject.FaultPlan([inject.FaultSpec(**s) for s in specs], SEED)
    calls = _dispatch_counts()
    t0 = time.perf_counter()
    rep = run(plan)
    secs = time.perf_counter() - t0
    calls = {k: v - calls[k] for k, v in _dispatch_counts().items()}
    by = dict(collections.Counter(rep.statuses.values()))
    check(rep.ok, f"chaos {tag} {name}: {rep.summary()}")
    check(check_outcome(rep, by),
          f"chaos {tag} {name}: unexpected outcome {rep.summary()}; "
          f"stats {rep.stats}")
    check(not torch.cuda.is_current_stream_capturing(),
          f"chaos {tag} {name}: a stream was left capturing")
    check(calls["torch"] == 0 and rep.stats.get("degraded", 0) == 0,
          f"chaos {tag} {name}: {calls['torch']} entry-point calls ran "
          f"the plain version, degraded {rep.stats.get('degraded')}")
    statuses = ",".join(f"{k}:{v}" for k, v in sorted(by.items()))
    extra = (f"arena rebuilds {rep.stats['arena_rebuilds']}, "
             if "arena_rebuilds" in rep.stats
             else f"degraded {rep.stats['degraded']}, ")
    print(f"[chaos] {tag} {name}: fired {rep.fired}, statuses {statuses}, "
          f"survivors {len(rep.survivors)}, poisoned {len(rep.poisoned)}, "
          f"retries {rep.stats['retries']}, {extra}pool violations "
          f"{len(rep.pool_violations)}, entry-point calls cuda "
          f"{calls['cuda']} torch {calls['torch']}, {secs:.2f} s; all "
          f"invariants held; {card}")
    return rep


def phase_chaos(torch, K, card, lm_params, prompts, dws_plan):
    """The chaos harness (``repro_torch.faults.chaos``) at full size on the
    card: Qwen2-0.5B "int8" (phase 6's weights and prompts) under every LM
    schedule, the int8 dws plan (phase 4's, captured) through
    CNNEngine(max_batch=BATCH) under every CNN schedule, each a clean and
    a faulted drain on fresh engines; then one traced drain of each engine
    exported under build/ and the cost of tracing. Returns the launch
    count of every kernel over the phase."""
    from repro_torch.configs import get_config
    from repro_torch.faults import chaos
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import (CNNEngine, CNNServeConfig, Engine,
                                   ImageRequest, Request, ServeConfig)
    cfg = get_config(LM_ARCH)
    served = prompts[:CHAOS_REQUESTS]
    K.reset_launches()

    def lm_requests():
        return [Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
                for i, p in enumerate(served)]

    def lm_engine(**kw):
        return Engine(cfg, lm_params, ServeConfig(
            max_batch=LM_BATCH, max_len=LM_MAX_LEN, precision="int8", **kw))
    for name, specs, kw, harness_kw, ok in chaos_lm_schedules(
            3 * cfg.n_layers):
        def run(plan, kw=kw, hk=harness_kw):
            return chaos.run_lm_chaos(lambda: lm_engine(**kw), lm_requests,
                                      plan, **hk)
        run_schedule(torch, card, "lm", name, run, specs, ok)
    images = (np.random.default_rng(SEED).standard_normal(
        (CHAOS_IMAGES, 32, 32, 3)) * 0.5).astype("float32")

    def cnn_requests():
        return [ImageRequest(uid=i, image=images[i])
                for i in range(CHAOS_IMAGES)]

    def cnn_engine(fresh):
        plan = (CompiledPlan(dws_plan.plan, method=dws_plan.method,
                             device=dws_plan.device) if fresh else dws_plan)
        return CNNEngine(plan, CNNServeConfig(max_batch=BATCH))
    per_forward = sum(PER_FORWARD["dws"].values())
    for name, specs, fresh, ok in chaos_cnn_schedules(per_forward):
        run_schedule(torch, card, "cnn", name, lambda plan, f=fresh:
                     chaos.run_cnn_chaos(lambda: cnn_engine(f),
                                         cnn_requests, plan), specs, ok)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    used = ("matmul_q8", "conv2d_q8", "depthwise2d_q8", "maxpool2d_s8")
    check(all(launches[k] > 0 for k in used),
          f"chaos: a kernel of the served paths was never launched: "
          f"{launches}")
    chaos_trace(torch, card, "lm", lm_engine(), lm_requests,
                lambda done: sum(len(r.out_tokens) for r in done), "tokens")
    chaos_trace(torch, card, "cnn", cnn_engine(False), cnn_requests,
                len, "images")
    return launches


def chaos_trace(torch, card, tag, eng, make_requests, count, unit):
    """Drain the same traffic through one warm engine four times, tracing
    off, on, off, on; export the last traced drain under build/ (Chrome
    trace-event JSON) and print its events, request lanes and span
    balance, and each drain's rate."""
    import collections
    import threading
    from repro_torch.obs import trace as obs_trace

    def drain():
        reqs = make_requests()
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        wall = time.perf_counter() - t0
        check(len(done) == len(reqs) and {r.status for r in done} == {"ok"},
              f"chaos trace {tag}: statuses {({r.status for r in done})}")
        return count(done) / wall
    drain()                             # the captures
    path = ROOT / "build" / f"chaos_trace_{tag}.json"
    rates = {False: [], True: []}
    for on in (False, True, False, True):
        obs_trace.clear()
        if on:
            obs_trace.enable()
        try:
            rates[on].append(drain())
            if on:
                obs_trace.export(str(path))
        finally:
            obs_trace.disable()
            obs_trace.clear()
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    me = threading.get_ident()
    lanes = {e["tid"] for e in events if e["tid"] != me}
    balance = collections.Counter()
    for e in events:
        balance[(e["tid"], e["name"])] += {"B": 1, "E": -1}[e["ph"]]
    unbalanced = {k: v for k, v in balance.items() if v}
    check(events and not unbalanced,
          f"chaos trace {tag}: unbalanced spans {unbalanced}")
    check(len(lanes) == len(make_requests()),
          f"chaos trace {tag}: {len(lanes)} request lanes")
    off, on = (statistics.mean(rates[k]) for k in (False, True))
    print(f"[chaos] {tag} traced drain: {len(events)} events, {len(lanes)} "
          f"request lanes, every span balanced, exported to "
          f"{path.relative_to(ROOT)} ({path.stat().st_size} bytes); "
          f"{unit}/s tracing off / on / off / on: "
          + " / ".join(f"{r:.1f}" for r in
                       (rates[False][0], rates[True][0], rates[False][1],
                        rates[True][1]))
          + f" (on / off {on / off:.4f}); {card}")


# ---------------------------------------------------------------- phase 7 --

def phase_ssm(torch, K, card, rng, dev="cuda", cfg=None, n_req=SSM_REQUESTS,
              new_tokens=LM_NEW, prompt=LM_PROMPT,
              check_layers=SSM_CHECK_LAYERS, n_eager=SSM_EAGER_REQUESTS):
    """Serve Falcon-Mamba-7B in "float", captured, and its first
    ``n_eager`` requests again with jit=False; returns the launch count of
    every kernel in the captured run."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import rmsnorm
    from repro_torch.serve import Engine, ServeConfig
    cfg = cfg or get_config(SSM_ARCH)
    params, made = make_lm_params(torch, cfg, dev, "ssm")
    m = cfg.mamba
    print(f"[ssm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {m.expand * cfg.d_model}, d_state {m.d_state}, d_conv "
          f"{m.d_conv}, dt_rank {m.rank(cfg.d_model)}, vocab {cfg.vocab}, "
          f"{made}")
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(prompt[0], prompt[1] + 1, n_req)]
    scfg = ServeConfig(max_batch=LM_BATCH, max_len=LM_MAX_LEN)
    t0 = time.perf_counter()
    eng = Engine(cfg, params, scfg)
    del params                  # the engine holds the cast copy it serves
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    got, done, wall, _ = serve_lm(torch, K, eng, prompts, new_tokens,
                                  "ssm", dev)
    st = eng.stats
    check(st["prefills"] == n_req, f"ssm: {st['prefills']} prefills")
    want = dict.fromkeys(got, 0)
    if torch.device(dev).type == "cuda":   # a host run launches nothing
        want["causal_conv1d"] = cfg.n_layers * st["prefills"]
    check(got == want, f"ssm: launches {got}, {st['prefills']} prefills "
                       f"and {st['decode_steps']} decode steps need {want}")
    ttft = np.percentile([r.ttft_s for r in done], [50, 99])
    step_ms = 1e3 * eng.metrics.counter("serve.decode_time_s").value \
        / st["decode_steps"]
    print(f"[ssm] float: {n_req} requests ok, {st['tokens_out']} tokens in "
          f"{wall:.2f} s ({st['tokens_out'] / wall:.1f} tokens/s end to "
          f"end; decode_tok_s={st['decode_tok_s']:.1f}), {st['prefills']} "
          f"prefills at their exact lengths ({min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens), {st['decode_steps']} decode "
          f"steps at {step_ms:.3f} ms, occupancy {st['occupancy']:.3f}, "
          f"TTFT p50 {ttft[0]:.4f} s p99 {ttft[1]:.4f} s (over the {n_req} "
          f"requests), engine init {t_init:.2f} s, {eng.traces} graph; "
          f"launches { {k: v for k, v in got.items() if v} } ({cfg.n_layers} "
          f"per prefill, 0 per decode step) on {card}")
    # the same engine op by op (it shares the cast weights) on the first
    # requests: the captured step changes no token
    eager = Engine(cfg, eng.params, scfg, jit=False)
    _, done_e, wall_e, _ = serve_lm(torch, K, eager, prompts[:n_eager],
                                    new_tokens, "ssm jit=False", dev)
    check([r.out_tokens for r in done_e]
          == [r.out_tokens for r in done[:n_eager]],
          "ssm: jit=False token streams differ from the captured engine's")
    st_e = eager.stats
    step_e = 1e3 * eager.metrics.counter("serve.decode_time_s").value \
        / st_e["decode_steps"]
    print(f"[ssm] float jit=False: {n_eager} requests ok, captured token "
          f"streams equal to jit=False's ({n_eager} x {new_tokens} tokens); "
          f"decode_tok_s={st_e['decode_tok_s']:.1f}, "
          f"{st_e['decode_steps']} decode steps at {step_e:.3f} ms, "
          f"{st_e['tokens_out'] / wall_e:.1f} tokens/s end to end")
    del eager
    # the block with the kernel against the block with its plain version,
    # on the first layers of the served (cast) weights at a served prompt
    cdt = T._cdt(cfg)
    tok = torch.as_tensor(prompts[0][None].astype(np.int64), device=dev)
    h = T.embed_tokens(eng.params, tok, cfg, cdt)
    for layer in range(check_layers):
        lp = T._take(eng.params["layers"], layer)
        x = rmsnorm(h, lp["ln"], cfg.norm_eps)
        y = mamba.mamba_forward(lp["mamba"], x, m, cdt, conv_method="cuda")
        y_plain = mamba.mamba_forward(lp["mamba"], x, m, cdt,
                                      conv_method="torch")
        sync(torch, dev)
        check(bool(torch.isfinite(y).all()) and torch.equal(y, y_plain),
              f"ssm: layer {layer}'s block with the kernel differs from "
              "the block with the plain version (or is not finite)")
        h = h + y
    logits, _ = eng.prefill(eng.params, {
        "tokens": tok, "prompt_lens": torch.tensor(
            [tok.shape[1]], dtype=torch.int32, device=dev)})
    check(tuple(logits.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"ssm: prefill logits {tuple(logits.shape)} not finite of shape "
          f"(1, 1, {cfg.vocab})")
    print(f"[ssm] mamba_forward with the kernel == with the plain version "
          f"bitwise on layers 0-{check_layers - 1} at a "
          f"{tok.shape[1]}-token prompt; prefill logits finite, "
          f"{tuple(logits.shape)}")
    lm_breakdown(torch, "ssm float", eng, cfg, dev,
                 port=("causal_conv1d",),
                 what="the port's causal_conv1d kernel")
    ssm_breakdown(torch, eng, cfg, dev, rng)
    return got


def ssm_breakdown(torch, eng, cfg, dev, rng, length=SSM_BREAKDOWN_LEN,
                  reps=3, tries=3):
    """One prefill of a ``length``-token prompt, as the engine runs it: its
    time (CUDA events), the device time of its device operations and their
    count, the causal_conv1d launches' share and the copy kernels; then
    the same prefill with each layer's x_in copied before the conv (the
    layout before the conv read the in_proj view in place), which must
    take exactly one device operation a layer more. Each pair is measured
    again, up to ``tries`` times, where a profiler session lost records."""
    from repro_torch.models import mamba
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (1, length)),
                          device=dev)
    batch = {"tokens": tok, "prompt_lens": torch.tensor(
        [length], dtype=torch.int32, device=dev)}
    prefill = lambda: eng.prefill(eng.params, batch)      # noqa: E731
    real = mamba.K.causal_conv1d

    def copied(x, w, **kw):
        return real(x.contiguous(), w, **kw)

    def measure():
        ms = time_ms(torch, prefill, reps=reps, trials=3)
        rows = device_kernels(torch, prefill, reps)
        return ms, rows
    for _ in range(tries):
        wall, rows = measure()
        mamba.K.causal_conv1d = copied
        try:
            wall_c, rows_c = measure()
        finally:
            mamba.K.causal_conv1d = real
        n_ops = sum(r.launches for r in rows)
        n_ops_c = sum(r.launches for r in rows_c)
        if n_ops_c - n_ops == cfg.n_layers:
            break
    busy = sum(r.us for r in rows) / 1e3
    conv = [r for r in rows if "causal_conv1d" in r.key]
    conv_ms = sum(r.us for r in conv) / 1e3
    n_conv = sum(r.launches for r in conv)

    def copies(rs):
        return sum(r.launches for r in rs if "copy" in r.key.lower())
    check(busy > 0, "torch.profiler saw no device time")
    check(n_conv == cfg.n_layers, f"ssm-breakdown: {n_conv} causal_conv1d "
                                  f"launches a prefill, not {cfg.n_layers}")
    check(n_ops_c - n_ops == cfg.n_layers,
          f"ssm-breakdown: the prefill takes {n_ops} device operations, "
          f"with x_in copied {n_ops_c}: not {cfg.n_layers} fewer")
    print(f"[ssm-breakdown] float: one {length}-token prefill: {wall:.4f} "
          f"ms (CUDA events), device busy {busy:.4f} ms in {n_ops:.0f} "
          f"device operations, of which the {n_conv:.0f} causal_conv1d "
          f"launches {conv_ms:.4f} ms ({conv_ms / busy:.4f} of busy) and "
          f"{copies(rows):.0f} copy kernels; device idle "
          f"{1 - busy / wall:.3f}. With x_in copied before each conv (the "
          f"earlier layout): {wall_c:.4f} ms, busy "
          f"{sum(r.us for r in rows_c) / 1e3:.4f} ms in {n_ops_c:.0f} device "
          f"operations ({n_ops_c - n_ops:.0f} more), {copies(rows_c):.0f} "
          "copy kernels")
    for r in sorted(rows, key=lambda r: -r.us)[:8]:
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[ssm-breakdown]   {r.us:9.1f} us x{r.launches:4.0f}  "
              f"{kernel[:100]}")


# --------------------------------------------------------------- phase 10 --

#: phase 10: the moe model's (precision, KV cache, layout) runs, captured;
#: its first LM_EAGER_REQUESTS requests again with jit=False
MOE_ARCH = "granite-moe-1b-a400m"
MOE_RUNS = (("float", "float", ""), ("float", "float", "paged"),
            ("float", "int8", ""))
#: the JAX engine's message for an integer FFN precision on a moe model
MOE_INT8_MESSAGE = ("ServeConfig.precision='int8' quantizes dense FFN "
                    "matmuls; moe/ssm/hybrid/encdec configs are unsupported")
#: the vlm model (served text-only) and the dense granite-3-2b, captured
#: in every precision
VLM_ARCH = "internvl2-1b"
ALL_PRECISIONS = ("float", "int8", "int8-torch", "w4a8", "w4a8-torch")
#: decode steps after the vlm model's prefill of its patch embeddings
VLM_PATCH_DECODE = 16
#: the two largest dense configs, bf16 weights made on the card: requests,
#: new tokens, of them again with jit=False
BIG_ARCHS = ("granite-34b", "qwen1.5-32b")
BIG_REQUESTS, BIG_NEW, BIG_EAGER = 8, 16, 2
#: card memory that must stay free under the reckoned peak for a model to
#: be served at full depth
BIG_HEADROOM = 4e9


def phase_families(torch, K, card, prompts, dev="cuda"):
    """The moe, vlm and further dense configs (module docstring, 10), each
    model freed before the next is made; ``prompts`` are phase 6's, taken
    into each model's vocabulary. Returns the launch count of every
    kernel over the runs."""
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
    runs = [lambda: family_moe(torch, K, card, prompts, dev),
            lambda: family_vlm(torch, K, card, prompts, dev),
            lambda: family_granite(torch, K, card, prompts, dev)]
    runs += [lambda a=a: family_big(torch, K, card, prompts, a, dev)
             for a in BIG_ARCHS]
    for run in runs:
        for k, v in run().items():
            launches[k] += v
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()    # the model is gone
    return launches


def family_runner(torch, K, card, cfg, prompts, dev, new_tokens=LM_NEW,
                  **cfg_kw):
    """An LMRunner over seeded parameters of ``cfg`` (``cfg_kw`` replaced
    in it) made on ``dev``, and ``prompts`` in its vocabulary."""
    cfg = dataclasses.replace(cfg, **cfg_kw)
    params, made = make_lm_params(torch, cfg, dev, cfg.name)
    moe = cfg.moe
    print(f"[families] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads} / {cfg.n_kv_heads} "
          f"KV, d_ff {cfg.d_ff}, {cfg.act}, vocab {cfg.vocab}"
          + (f", {moe.num_experts} experts top-{moe.top_k} d_ff {moe.d_ff}"
             f" capacity factor {moe.capacity_factor}" if moe else "")
          + f"; {made}")
    runner = LMRunner(torch, K, card, cfg, params, dev, new_tokens)
    return runner, [(p % cfg.vocab).astype(np.int32) for p in prompts]


def family_moe(torch, K, card, prompts, dev):
    """granite-moe-1b-a400m at full width and depth in "float": captured
    over the contiguous, paged and int8 KV caches (every status ok; the
    paged and int8 streams' agreement printed: a free slot's K/V and so
    its routing differ between the layouts), the first requests again with
    jit=False (streams equal; the (token, expert) pairs each decode step
    dropped counted there), an integer precision refused with JAX's
    message, and one decode step's breakdown."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.serve import Engine, ServeConfig
    runner, served = family_runner(torch, K, card, get_config(MOE_ARCH),
                                   prompts, dev)
    cfg, streams = runner.cfg, runner.streams
    for prec, kv, layout in MOE_RUNS:
        kw = dict(kv_layout="paged", kv_block_size=LM_BLOCK) if layout \
            else {}
        runner.run("moe", lm_label(prec, kv, layout), served, precision=prec,
                   kv_cache=kv, **kw)
    print(f"[moe] token agreement with the contiguous float cache: paged "
          f"{agreement(streams['float paged'], streams['float']):.4f}, int8 "
          f"KV {agreement(streams['float kv=int8'], streams['float']):.4f}")
    drops, real = [], M._dispatch_combine

    def counted(x2d, probs, ids, fn, e, cap):
        over = torch.bincount(ids.reshape(-1), minlength=e) - cap
        drops.append((x2d.shape[0], over.clamp(min=0).sum()))
        return real(x2d, probs, ids, fn, e, cap)
    n = LM_EAGER_REQUESTS
    M._dispatch_combine = counted
    try:
        runner.run("moe", "float jit=False", served[:n], jit=False)
    finally:
        M._dispatch_combine = real
    check(streams["float jit=False"] == streams["float"][:n],
          "moe: jit=False token streams differ from the captured engine's")
    # a decode step routes LM_BATCH tokens a layer (every slot, free ones
    # too); a prefill routes its bucket of 16 or more
    step = [int(d) for t, d in drops if t == LM_BATCH]
    per_step = np.add.reduceat(step, range(0, len(step), cfg.n_layers))
    pairs = LM_BATCH * cfg.moe.top_k
    cap = M._capacity(LM_BATCH, cfg.moe)
    print(f"[moe] captured token streams equal to jit=False's ({n} x "
          f"{LM_NEW} tokens); dropped (token, expert) pairs in a decode "
          f"step of {LM_BATCH} slots (capacity {cap} an expert, {pairs} pairs "
          f"a layer, {cfg.n_layers} layers): mean {np.mean(per_step):.1f} "
          f"(min {per_step.min()}, max {per_step.max()}) of "
          f"{pairs * cfg.n_layers} a step over {len(per_step)} jit=False "
          "steps")
    try:
        Engine(cfg, runner.params, ServeConfig(precision="int8"))
        message = None
    except NotImplementedError as e:
        message = str(e)
    check(message == MOE_INT8_MESSAGE,
          f"moe: precision='int8' gave {message!r}, not JAX's message")
    print(f"[moe] precision='int8' raises JAX's message: {message}")
    lm_breakdown(torch, "moe float", runner.engines["float"], cfg, dev,
                 port=("gemm", "nvjet"), what="the cuBLAS matmuls "
                 "(attention, experts, unembedding)")
    return runner.launches


def family_vlm(torch, K, card, prompts, dev):
    """internvl2-1b at full width, served text-only in every precision,
    captured (kernel streams equal to their plain versions'; the launch
    counts checked by the runner); one prefill_fn call with
    ``frontend_positions`` patch embeddings ahead of a prompt, then
    ``VLM_PATCH_DECODE`` decode steps; the gate: a prefill whose embeds
    are the embeddings of a prompt's first tokens gives the logits and
    cache of the prefill of the whole prompt, bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    runner, served = family_runner(torch, K, card, get_config(VLM_ARCH),
                                   prompts, dev)
    cfg, streams = runner.cfg, runner.streams
    for prec in ALL_PRECISIONS:
        runner.run("vlm", prec, served, precision=prec)
    for prec in LM_KERNEL:
        check(streams[prec] == streams[prec + "-torch"],
              f"vlm {prec}: the kernel's token streams differ from the "
              "plain version's")
    print(f"[vlm] int8 and w4a8 token streams equal to their -torch "
          f"versions' ({len(served)} x {LM_NEW} tokens); "
          f"{3 * cfg.n_layers} matmul launches a prefill and a decode step")
    params = T.cast_params(runner.params, cfg)
    n_patch = cfg.frontend_positions
    tok = torch.as_tensor(served[0][None].astype(np.int64), device=dev)
    embeds = torch.randn((1, n_patch, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED)) * 0.02
    length = n_patch + tok.shape[1]
    pre = api.prefill_fn(cfg, length + VLM_PATCH_DECODE)
    dec = api.decode_fn(cfg)
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": tok, "embeds": embeds})
    sync(torch, dev)
    t_pre = time.perf_counter() - t0
    check(int(cache["len"]) == length, f"vlm: prefill length "
          f"{int(cache['len'])}, not {n_patch} patches + {tok.shape[1]}")
    t0 = time.perf_counter()
    for _ in range(VLM_PATCH_DECODE):
        logits, cache = dec(params, logits.argmax(-1), cache)
    sync(torch, dev)
    t_dec = time.perf_counter() - t0
    check(tuple(logits.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all())
          and int(cache["len"]) == length + VLM_PATCH_DECODE,
          "vlm: decode after the patch prefill is not finite or not at "
          "its length")
    print(f"[vlm] prefill_fn of {n_patch} patch embeddings + a "
          f"{tok.shape[1]}-token prompt (eager) {1e3 * t_pre:.1f} ms, then "
          f"{VLM_PATCH_DECODE} decode steps (eager) "
          f"{1e3 * t_dec / VLM_PATCH_DECODE:.1f} ms each; logits finite, "
          f"length {int(cache['len'])}")
    head = tok.shape[1] // 2
    got_l, got_c = pre(params, {"tokens": tok[:, head:],
                                "embeds": params["embed"][tok[:, :head]]})
    want_l, want_c = pre(params, {"tokens": tok})
    sync(torch, dev)
    check(torch.equal(got_l, want_l)
          and all(torch.equal(got_c[k], want_c[k]) for k in ("k", "v", "len")),
          "vlm: a prefill with the embeddings of the prompt's head as embeds "
          "differs from the prefill of the prompt")
    print(f"[vlm] a prefill with the embeddings of the prompt's first {head} "
          f"tokens as embeds, then its other {tok.shape[1] - head}: logits "
          "and cache bitwise equal to the prefill of the whole prompt")
    return runner.launches


def family_granite(torch, K, card, prompts, dev):
    """granite-3-2b at full width in every precision, captured: kernel
    streams equal to their plain versions', its FFN's 120 matmul launches
    a prefill and a decode step checked by the runner."""
    from repro_torch.configs import get_config
    runner, served = family_runner(torch, K, card,
                                   get_config(GRANITE_FFN[0]), prompts, dev)
    streams = runner.streams
    for prec in ALL_PRECISIONS:
        runner.run("granite", prec, served, precision=prec)
    for prec in LM_KERNEL:
        check(streams[prec] == streams[prec + "-torch"],
              f"granite {prec}: the kernel's token streams differ from the "
              "plain version's")
    print(f"[granite] int8 and w4a8 token streams equal to their -torch "
          f"versions' ({len(served)} x {LM_NEW} tokens); "
          f"{3 * runner.cfg.n_layers} matmul launches a prefill and a "
          f"decode step; token agreement with float: int8 "
          f"{agreement(streams['int8'], streams['float']):.4f}, w4a8 "
          f"{agreement(streams['w4a8'], streams['float']):.4f}")
    return runner.launches


def big_peak(cfg, n_layers=None) -> dict:
    """The reckoned device bytes of serving ``cfg`` in "float" with bf16
    weights (at ``n_layers``): the weights, the float32 copy of the
    unembedding that ``unembed`` makes at each call (held once by the
    eager allocator's cache, once by the graph pool), the KV cache of
    LM_BATCH x LM_MAX_LEN."""
    from repro_torch.check.config import kv_cache_bytes
    from repro_torch.serve import ServeConfig
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    f32_unembed = 4 * cfg.d_model * cfg.vocab
    parts = {"weights": 2 * (cfg.param_count() + cfg.d_model),
             "float32 unembedding (eager)": f32_unembed,
             "float32 unembedding (graph pool)": f32_unembed,
             "KV": kv_cache_bytes(cfg, ServeConfig(max_batch=LM_BATCH,
                                                   max_len=LM_MAX_LEN))}
    return dict(parts, total=sum(parts.values()))


def family_big(torch, K, card, prompts, arch, dev):
    """One of the big dense configs in "float", bf16 weights made on the
    card: the reckoned peak printed first; at full depth where
    ``BIG_HEADROOM`` stays free under it, else at the most layers that
    leave it (the cut printed); BIG_REQUESTS requests of BIG_NEW tokens,
    captured, the first BIG_EAGER again with jit=False (streams equal);
    the peak memory the card saw."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    on_card = torch.device(dev).type == "cuda"
    free = torch.cuda.mem_get_info()[0] if on_card else float("inf")
    peak = big_peak(cfg)
    layers = cfg.n_layers
    while layers > 1 and free - big_peak(cfg, layers)["total"] \
            < BIG_HEADROOM:
        layers -= 1
    print(f"[families] {arch}: reckoned peak "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peak.items())
          + f"; {free / 1e9:.2f} GB free on the card: "
          + ("served at full depth" if layers == cfg.n_layers else
             f"depth cut from {cfg.n_layers} to {layers} layers, whose "
             f"reckoned peak {big_peak(cfg, layers)['total'] / 1e9:.2f}"
             f" GB leaves {BIG_HEADROOM / 1e9:.0f} GB free"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    runner, served = family_runner(torch, K, card, cfg, prompts, dev,
                                   new_tokens=BIG_NEW, n_layers=layers)
    runner.run("families", f"{arch} float", served[:BIG_REQUESTS])
    runner.run("families", f"{arch} float jit=False", served[:BIG_EAGER],
               jit=False)
    streams = runner.streams
    check(streams[f"{arch} float jit=False"]
          == streams[f"{arch} float"][:BIG_EAGER],
          f"{arch}: jit=False token streams differ from the captured "
          "engine's")
    mem = (f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
           f"GB, reserved {torch.cuda.max_memory_reserved() / 1e9:.2f} GB"
           if on_card else "host run")
    print(f"[families] {arch}: captured token streams equal to jit=False's "
          f"({BIG_EAGER} x {BIG_NEW} tokens); {mem} on {card}")
    return runner.launches


# --------------------------------------------------------------- phase 11 --

#: phase 11: the encdec model at full size, one batch of ENCDEC_BATCH
#: requests: stub frames of ENCDEC_FRAMES positions, prompts of
#: ENCDEC_PROMPT tokens, ENCDEC_NEW new tokens, greedy
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 8, 256, 16, 32
#: the hybrid model at full width, bf16 weights, cut in whole super-blocks:
#: requests of phase 6's prompts, new tokens, of them again with jit=False
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_REQUESTS, HYBRID_NEW, HYBRID_EAGER = 8, 16, 2


def conv_per_prefill(cfg) -> int:
    """causal_conv1d launches per prefill: one per Mamba layer (an ssm
    model's every layer, a hybrid model's period - 1 a super-block)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period * (cfg.attn_period - 1)
    return cfg.n_layers


def phase_encdec_hybrid(torch, K, card, prompts):
    """The encdec and hybrid families (module docstring, 11), the first
    model freed before the second is made. Returns the launch count of
    every kernel over the runs."""
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
    for run in (lambda: family_encdec(torch, K, card),
                lambda: family_hybrid(torch, K, card, prompts)):
        for k, v in run().items():
            launches[k] += v
        torch.cuda.empty_cache()        # the model is gone
    return launches


def encdec_generate(torch, params, frames, toks, prefill, decode, captured):
    """Greedy ``ENCDEC_NEW`` tokens for the batch: the prefill, then the
    decode step eager or (``captured``) captured once with
    ``graph.capture`` over the cache, which the step updates in place, and
    replayed with the length advanced in place. Returns (the (B, new)
    token ids on the host, the TTFT of the batch in seconds, decode-step
    ms by CUDA events, the captured step or None, the cache)."""
    from repro_torch.graph.capture import capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"frames": frames, "tokens": toks})
    tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    out, cap = [tok], None
    if captured:
        # the graph's static input: a copy, written before each replay
        cap, logits = capture(lambda t: decode(params, t, cache)[0],
                              (tok.clone(),), key="encdec.decode")
        cache["len"].add_(1)
        out.append(logits[:, -1:].argmax(-1))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    while len(out) < ENCDEC_NEW:
        if cap is not None:
            cap.inputs[0].copy_(out[-1])
            logits = cap.replay()
            cache["len"].add_(1)
        else:
            logits, cache = decode(params, out[-1], cache)
        out.append(logits[:, -1:].argmax(-1))
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (ENCDEC_NEW - 1 - (cap is not None))
    check(int(cache["len"]) == toks.shape[1] + ENCDEC_NEW - 1,
          f"encdec: cache length {int(cache['len'])} after the run")
    return (torch.cat(out, 1).cpu().numpy(), ttft, step_ms, cap, cache)


def family_encdec(torch, K, card):
    """seamless-m4t-large-v2 at full size: seeded weights made on the card,
    the matrices cast to bf16 once (``cast_params``); one batch of
    ``ENCDEC_BATCH`` requests through ``api.prefill_fn`` / ``decode_fn``,
    the decode step captured, then eager: streams equal, the logits
    finite; the captured step's time, device busy and idle, its byte
    bound, the TTFT of the batch."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    cfg = get_config(ENCDEC_ARCH)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    made = sum(v.numel() for v in _leaves(params))
    d = cfg.d_model
    # param_count counts an untied unembedding (the config's
    # tied_embeddings is False; the model ties it) and no final norms
    check(made == cfg.param_count() - cfg.vocab * d + 2 * d,
          f"encdec: {made} parameters, param_count {cfg.param_count()}")
    print(f"[encdec] {cfg.name}: {cfg.n_encoder_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {d}, heads "
          f"{cfg.n_heads} / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, "
          f"{cfg.act}, vocab {cfg.vocab}; {made:,} parameters "
          f"({cfg.param_dtype}) made on the card in "
          f"{time.perf_counter() - t0:.2f} s (param_count "
          f"{cfg.param_count():,} counts an untied unembedding of "
          f"{cfg.vocab * d:,}, which the model ties to the embedding, and "
          "leaves out the two final norms); matrices cast to "
          f"{cfg.compute_dtype} once")
    params = T.cast_params(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (ENCDEC_BATCH, ENCDEC_PROMPT),
                         generator=gen, device="cuda")
    prefill = api.prefill_fn(cfg, ENCDEC_PROMPT + ENCDEC_NEW)
    decode = api.decode_fn(cfg)
    prefill(params, {"frames": frames, "tokens": toks})     # warm-up
    K.reset_launches()
    runs = {}
    for captured in (True, False):
        runs[captured] = encdec_generate(torch, params, frames, toks,
                                         prefill, decode, captured)
    got = {k.__name__: k.launches for k in K.KERNELS}
    check(not any(got.values()),
          f"encdec: launches {got} (no kernel of the port is on its path)")
    streams, ttft, step_ms, cap, cache = runs[True]
    check(np.array_equal(streams, runs[False][0]),
          "encdec: captured token streams differ from the eager ones")
    check(streams.shape == (ENCDEC_BATCH, ENCDEC_NEW)
          and ((0 <= streams) & (streams < cfg.vocab)).all(),
          "encdec: a stream is short or holds an id outside the vocabulary")
    print(f"[encdec] {ENCDEC_BATCH} requests (frames ({ENCDEC_BATCH}, "
          f"{ENCDEC_FRAMES}, {d}) bf16, {ENCDEC_PROMPT}-token prompts), "
          f"{ENCDEC_NEW} new tokens each: captured token streams equal to "
          f"the eager ones; TTFT of the batch (encode + prefill) "
          f"{ttft:.4f} s captured run, {runs[False][1]:.4f} s eager run; "
          f"decode step {step_ms:.3f} ms captured, {runs[False][2]:.3f} ms "
          f"eager (CUDA events, mean of the run's steps); first call of "
          f"the captured step (eager pass + capture) "
          f"{1e3 * cap.seconds:.1f} ms; on {card}")
    # the step's bytes: the decoder's matrices and norms, the float32
    # embedding (the tied unembedding), the self and cross K/V read
    dec = sum(v.numel() * v.element_size()
              for v in _leaves(params["dec_layers"]))
    kv = sum(cache[k].numel() * cache[k].element_size()
             for k in ("k", "v", "xk", "xv"))
    emb = params["embed"].numel() * params["embed"].element_size()
    hbm = card_model().hbm_bps
    bound_ms = 1e3 * (dec + kv + emb) / hbm
    step = time_ms(torch, cap.replay, reps=5, trials=3)
    rows = device_kernels(torch, cap.replay, 5)
    busy = sum(r.us for r in rows) / 1e3
    check(busy > 0, "torch.profiler saw no device time")
    n_ops = sum(r.launches for r in rows)
    print(f"[encdec-breakdown] one captured decode step of "
          f"{ENCDEC_BATCH} rows at position {int(cache['len'])}: "
          f"{step:.4f} ms (CUDA events), device busy {busy:.4f} ms in "
          f"{n_ops:.0f} device operations, idle {1 - busy / step:.3f}; "
          f"byte bound {bound_ms:.4f} ms ({(dec + kv + emb) / 1e9:.3f} GB: "
          f"decoder weights {dec / 1e9:.3f}, float32 embedding "
          f"{emb / 1e9:.3f}, K/V and cross K/V {kv / 1e9:.3f}, at "
          f"{hbm / 1e12:.2f} TB/s), {step / bound_ms:.2f}x it")
    for r in sorted(rows, key=lambda r: -r.us)[:6]:
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[encdec-breakdown]   {r.us:9.1f} us x{r.launches:4.0f}  "
              f"{kernel[:100]}")
    return got


def hybrid_peak(cfg, n_layers) -> dict:
    """The reckoned device bytes of serving ``cfg`` in "float" with bf16
    weights at ``n_layers``: the weights, the float32 copy of the
    unembedding (held by the eager allocator and by the graph pool), the
    cache of LM_BATCH x LM_MAX_LEN counted directly (the K/V of the
    attention sublayers, one a super-block, and the Mamba sublayers' conv
    (bf16) and ssm (float32) state), and the static scheduler's prefill
    of LM_BATCH prompts of the longest length LM_PROMPT[1]: its selective
    scan holds six float32 (B, L, d_inner, d_state) tensors at once (the
    chunk's a and b, a doubling round's previous pair, its sum and the
    new concatenation). An upper bound: the phase checks the measured
    peak against it."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    nb = n_layers // cfg.attn_period
    nm = cfg.attn_period - 1
    di = cfg.mamba.expand * cfg.d_model
    f32_unembed = 4 * cfg.d_model * cfg.vocab
    parts = {"weights": 2 * (cfg.param_count() + cfg.d_model),
             "float32 unembedding (eager)": f32_unembed,
             "float32 unembedding (graph pool)": f32_unembed,
             "K/V": 2 * 2 * nb * LM_BATCH * LM_MAX_LEN * cfg.n_kv_heads
             * cfg.head_dim,
             "conv and ssm state": nb * nm * LM_BATCH * di
             * (2 * (cfg.mamba.d_conv - 1) + 4 * cfg.mamba.d_state),
             "static prefill's scan": 6 * 4 * LM_BATCH * LM_PROMPT[1] * di
             * cfg.mamba.d_state}
    return dict(parts, total=sum(parts.values()))


def family_hybrid(torch, K, card, prompts):
    """jamba-v0.1-52b at full width with bf16 weights, cut in whole
    super-blocks to the most that leave ``BIG_HEADROOM`` free under the
    reckoned peak: the cut printed; HYBRID_REQUESTS requests of HYBRID_NEW
    tokens, captured (causal_conv1d launched 7 times a super-block per
    prefill, checked by the runner), the first HYBRID_EAGER again with
    jit=False (streams equal; the (token, expert) pairs each decode step
    drops counted there), the static scheduler on the same requests,
    captured and jit=False (streams equal); one decode step's breakdown,
    the byte bound of the weights, the peak memory against the
    reckoning."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              param_dtype="bfloat16")
    free = torch.cuda.mem_get_info()[0]
    period = cfg.attn_period
    nb = cfg.n_layers // period
    while nb > 1 and \
            free - hybrid_peak(cfg, nb * period)["total"] < BIG_HEADROOM:
        nb -= 1
    peak = hybrid_peak(cfg, nb * period)
    print(f"[hybrid] {HYBRID_ARCH}: {cfg.n_layers} layers in "
          f"{cfg.n_layers // period} super-blocks of {period}; reckoned peak "
          f"of {nb} (" + ", ".join(f"{k} {v / 1e9:.3f} GB"
                                    for k, v in peak.items())
          + f"), of {nb + 1}: "
          f"{hybrid_peak(cfg, (nb + 1) * period)['total'] / 1e9:.2f} GB; "
          f"{free / 1e9:.2f} GB free on the card: depth cut to {nb} "
          f"super-blocks, {nb * period} of {cfg.n_layers} layers, leaving "
          f"{BIG_HEADROOM / 1e9:.0f} GB free")
    torch.cuda.reset_peak_memory_stats()
    runner, served = family_runner(torch, K, card, cfg, prompts, "cuda",
                                   new_tokens=HYBRID_NEW,
                                   n_layers=nb * period)
    cfg = runner.cfg
    streams, served = runner.streams, served[:HYBRID_REQUESTS]
    eng, _ = runner.run("hybrid", "float", served)
    weights = sum(v.numel() * v.element_size()
                  for v in _leaves(eng.params))
    hbm = card_model().hbm_bps
    print(f"[hybrid] byte bound of a decode step's weights: "
          f"{weights / 1e9:.3f} GB at {hbm / 1e12:.2f} TB/s = "
          f"{1e3 * weights / hbm:.3f} ms (every expert's weights: "
          "the experts run as one batched matmul over their capacity "
          "rows)")
    lm_breakdown(torch, "hybrid float", eng, cfg, "cuda",
                 port=("gemm", "nvjet"), what="the cuBLAS matmuls "
                 "(attention, Mamba projections, experts, FFN, unembedding)")
    # one captured engine (its graph pool) at a time
    runner.engines.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    per_prefill = conv_per_prefill(cfg)
    drops, real = [], M._dispatch_combine

    def counted(x2d, probs, ids, fn, e, cap):
        over = torch.bincount(ids.reshape(-1), minlength=e) - cap
        drops.append((x2d.shape[0], over.clamp(min=0).sum()))
        return real(x2d, probs, ids, fn, e, cap)
    M._dispatch_combine = counted
    try:
        runner.run("hybrid", "float jit=False", served[:HYBRID_EAGER],
                   jit=False)
    finally:
        M._dispatch_combine = real
    check(streams["float jit=False"] == streams["float"][:HYBRID_EAGER],
          "hybrid: jit=False token streams differ from the captured "
          "engine's")
    n_moe = cfg.n_layers // cfg.moe.every_n_layers
    step = [int(d) for t, d in drops if t == LM_BATCH]
    per_step = np.add.reduceat(step, range(0, len(step), n_moe))
    pairs = LM_BATCH * cfg.moe.top_k
    print(f"[hybrid] captured token streams equal to jit=False's "
          f"({HYBRID_EAGER} x {HYBRID_NEW} tokens); causal_conv1d "
          f"{per_prefill} launches a prefill ({cfg.attn_period - 1} Mamba "
          f"sublayers x {nb} super-blocks), none a decode step; dropped "
          f"(token, expert) pairs in a decode step of {LM_BATCH} slots "
          f"(capacity {M._capacity(LM_BATCH, cfg.moe)} an expert, {pairs} "
          f"pairs a MoE layer, {n_moe} MoE layers): mean "
          f"{np.mean(per_step):.1f} (min {per_step.min()}, max "
          f"{per_step.max()}) of {pairs * n_moe} a step over "
          f"{len(per_step)} jit=False steps")
    runner.run("hybrid", "float static", served, warm=served, graphs=1,
               scheduler="static")
    # the same batch: capacity drops couple the slots of a step
    runner.run("hybrid", "float static jit=False", served, jit=False,
               scheduler="static")
    check(streams["float static jit=False"] == streams["float static"],
          "hybrid static: jit=False token streams differ from the captured "
          "engine's")
    print(f"[hybrid] static: captured token streams equal to jit=False's "
          f"({len(served)} x {HYBRID_NEW} tokens); token agreement with "
          f"the continuous engine "
          f"{agreement(streams['float static'], streams['float']):.4f} "
          "(the left pads run through the recurrence; not gated)")
    got = torch.cuda.max_memory_allocated()
    print(f"[hybrid] peak allocated {got / 1e9:.2f} GB, reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB against "
          f"the reckoned {peak['total'] / 1e9:.2f} GB, on {card}")
    check(got <= peak["total"], f"hybrid: peak allocated {got / 1e9:.2f} "
          f"GB above the reckoned {peak['total'] / 1e9:.2f} GB")
    return runner.launches


# --------------------------------------------------------------- phase 12 --

#: phase 12 (a): Qwen2-0.5B trained at full size, float32 params, bf16
#: compute: TRAIN_STEPS AdamW steps of TRAIN_BATCH x TRAIN_SEQ tokens
#: through the Trainer, a checkpoint every TRAIN_CKPT_EVERY steps
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 512, 8, 4
TRAIN_DATA_SEED = 11
#: the trained model served: requests (phase 6's prompts), new tokens,
#: and the requests run again with jit=False
TRAIN_SERVE, TRAIN_SERVE_NEW, TRAIN_SERVE_EAGER = 8, 16, 2
#: phase 12 (b): Falcon-Mamba-7B at full width, cut in whole layers to the
#: most whose reckoned training peak leaves SSM_TRAIN_HEADROOM bytes free;
#: SSM_TRAIN_STEPS timed steps of SSM_TRAIN_BATCH x SSM_TRAIN_SEQ tokens,
#: then up to SSM_PROFILE_TRIES profiled ones, until a torch.profiler
#: session holds every causal_conv1d launch of its step (in a long run a
#: session now and then drops a few device records)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 256, 4
SSM_PROFILE_TRIES = 4
SSM_TRAIN_HEADROOM = 8e9
#: the loss's chunk (lm_loss's loss_chunk default)
LOSS_CHUNK = 512
#: row 7's device time of the 64 causal_conv1d launches of one 96-token
#: Falcon-Mamba prefill (PERF.md section 6, PR 22), for comparison
PREFILL_CONV_MS = 0.1514
#: profiled steps tried until a torch.profiler session records device
#: activity (a session on the card's machine now and then records none)
TRAIN_PROFILE_TRIES = 4


def phase_train(torch, K, card, prompts):
    """Phase 12: LM training on the card (module docstring); returns the
    kernel launches of its train steps."""
    t0 = time.perf_counter()
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
    train_dense(torch, K, card, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for k, v in train_ssm(torch, K, card).items():
        launches[k] += v
    t2 = time.perf_counter()
    print(f"[train] phase 12 took {t2 - t0:.1f} s: {TRAIN_ARCH} "
          f"{t1 - t0:.1f} s, {SSM_ARCH} {t2 - t1:.1f} s")
    return launches


def dense_train_peak(cfg, batch, seq) -> dict:
    """The reckoned device bytes of a Qwen2 train step: params, gradients
    and both AdamW moments in float32 (16 B a parameter); the loss chunk's
    float32 (B, chunk, V) logits: the logits the backward recomputes and
    keeps, logsumexp's difference, exp and product in its backward and
    the gather's scattered gradient (five of them); one checkpointed
    layer's recompute (its activations kept for its backward: about 24
    (B, S, d_ff)-sized bf16 tensors and the flash scores of one KV block,
    generously); the largest stacked float32 leaf once more (autograd's
    stack of its per-layer gradients; the gradient norm's square)."""
    n = cfg.param_count() + cfg.d_model
    chunk = min(LOSS_CHUNK, seq)
    stacked = max(cfg.vocab * cfg.d_model,
                  cfg.n_layers * cfg.d_model * cfg.d_ff)
    parts = {"p, g, m, v": 16 * n,
             "loss chunk's logits (5 x float32)":
             5 * 4 * batch * chunk * cfg.vocab,
             "a layer's recompute": 24 * 2 * batch * seq * cfg.d_ff
             + 4 * 4 * batch * cfg.n_heads * seq * min(256, seq),
             "largest leaf again": 4 * stacked}
    return dict(parts, total=sum(parts.values()))


def ssm_train_peak(cfg, n_layers, batch, seq) -> dict:
    """The reckoned device bytes of a Falcon-Mamba train step at
    ``n_layers``: params, gradients and both AdamW moments in float32 (16 B
    a parameter); the largest stacked float32 leaf (in_proj) once more
    (autograd's stack of its per-layer gradients; the gradient norm's
    square); the loss chunk's five float32 logits tensors; and one
    checkpointed layer's recompute, its selective scan dominant: the
    doubling scan keeps a new (a, b) pair of float32 (B, chunk, d_inner,
    d_state) tensors each of its log2(chunk) rounds for the backward, plus
    the first pair, the states and the chunk's inputs, and the backward
    holds about six more of that size in flight; the layer's other
    activations (bf16 (B, L, 2 d_inner) and smaller), generously."""
    from repro_torch.models.mamba import chunk_size
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n = cfg.param_count() + cfg.d_model
    di, st = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    ch = chunk_size(seq, 256)
    scan = 4 * batch * ch * di * st
    rounds = max(ch - 1, 1).bit_length()
    parts = {"p, g, m, v": 16 * n,
             "largest leaf again": 4 * n_layers * cfg.d_model * 2 * di,
             "loss chunk's logits (5 x float32)":
             5 * 4 * batch * min(LOSS_CHUNK, seq) * cfg.vocab,
             "a layer's recompute (scan)": (2 * rounds + 2 + 2 + 6) * scan,
             "a layer's recompute (other)": 16 * 2 * batch * seq * 2 * di}
    return dict(parts, total=sum(parts.values()))


class StepTimer:
    """Wraps a train step: CUDA events around each call, and a
    torch.profiler session around the calls ``profile`` picks out (its
    rows and events kept for the first call whose session recorded device
    activity and, where ``accept`` is given, that ``accept(kernels)``
    takes). ``before`` runs ahead of each call, outside its events (its
    host seconds summed in ``waited``)."""

    def __init__(self, torch, fn, profile=(), before=None, accept=None):
        self.torch, self.fn, self.profile = torch, fn, set(profile)
        self.events, self.calls, self.prof = [], 0, None
        self.profiled = None
        self.before, self.waited = before, 0.0
        self.accept = accept

    def __call__(self, *args):
        torch = self.torch
        self.calls += 1
        if self.before is not None:
            self._wait()
        if self.calls in self.profile and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            # device activity only: a step's host operator events would
            # take the profiler tens of seconds to parse
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = self._timed(*args)
                torch.cuda.synchronize()
            kernels = device_events(torch, prof)
            if kernels and (self.accept is None or self.accept(kernels)):
                self.prof = (kernels, self.events[-1])
                self.profiled = self.calls
            return out
        return self._timed(*args)

    def _wait(self):
        """Run ``before`` (host work: no device launch to wait for), its
        host seconds summed in ``waited``."""
        t0 = time.perf_counter()
        self.before()
        self.waited += time.perf_counter() - t0

    def _timed(self, *args):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def device_events(torch, prof) -> list:
    """(start us, duration us, name) of every device operation a profiler
    session recorded, in start order."""
    out = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(out)


def busy_share(kernels, wall_ms) -> tuple:
    """(device busy ms, idle share) of a step of ``wall_ms``: the union of
    its device operations' intervals."""
    busy, end = 0.0, -math.inf
    for start, dur, _ in kernels:
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
    return busy / 1e3, 1 - busy / 1e3 / wall_ms


def train_dense(torch, K, card, prompts):
    """Phase 12 (a): Qwen2-0.5B at full size trained, resumed and served
    (module docstring)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, global_norm
    from repro_torch.train import (LoopConfig, TrainConfig, Trainer,
                                   estimate_model_flops, trainable,
                                   value_and_grad)
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=2,
                                     total_steps=TRAIN_STEPS),
                       remat="full", attn_impl="flash")
    ds = IndexedDataset(DataConfig(kind="lm", vocab=cfg.vocab,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH,
                                   seed=TRAIN_DATA_SEED))

    def init(gen):
        return api.init_params(cfg, gen, device="cuda")
    peak = dense_train_peak(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = estimate_model_flops(cfg, tokens)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, tied embeddings "
          f"{cfg.tied_embeddings}, {cfg.param_count() + cfg.d_model:,} "
          f"parameters in {cfg.param_dtype}, compute {cfg.compute_dtype}; "
          f"remat {tcfg.remat}, attn {tcfg.attn_impl}, AdamW warmup "
          f"{tcfg.opt.warmup_steps} of {tcfg.opt.total_steps} steps; "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; reckoned peak "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peak.items()))

    # step 0 with full attention against the trainer's flash step 0
    params = trainable(init(torch.Generator(device="cuda").manual_seed(0)))
    batch0 = next(PrefetchLoader(ds, 0))
    loss_full, g = value_and_grad(api.loss_fn(
        cfg, attn_impl="full", remat="full"))(params, batch0)
    gn_full = float(global_norm(g))
    loss_full = float(loss_full)
    del params, g, batch0
    gc.collect()
    torch.cuda.empty_cache()

    def loop(path, every):
        return LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=every,
                          ckpt_dir=str(path), keep=2, log_every=0)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        print(f"[train] checkpoints under build/, "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free on its disk")
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, tcfg, loop(tmp / "a", TRAIN_CKPT_EVERY), ds, init)
        # each timed step starts with no checkpoint write in flight: the
        # step-4 save's thread would share the host with steps 5-8
        timer = StepTimer(torch, tr.step_fn, before=tr.ckpt.wait)
        tr.step_fn = timer
        t0 = time.perf_counter()
        params, opt, step, hist = tr.run()
        wall = time.perf_counter() - t0
        got_peak = torch.cuda.max_memory_allocated()
        ms = timer.ms()
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        check(step == TRAIN_STEPS and len(hist) == TRAIN_STEPS
              and tr.skipped == 0,
              f"train {cfg.name}: step {step}, {len(hist)} finite steps, "
              f"{tr.skipped} skipped")
        check(all(math.isfinite(x) for x in losses + norms),
              f"train {cfg.name}: a loss or gradient norm is not finite")
        check(losses[-1] < losses[0] + 0.5,
              f"train {cfg.name}: loss {losses[0]} -> {losses[-1]}")
        print(f"[train] {cfg.name}: {TRAIN_STEPS} steps in {wall:.2f} s "
              f"(checkpoints at steps {TRAIN_CKPT_EVERY} and {TRAIN_STEPS} "
              f"included); losses "
              + " ".join(f"{x:.4f}" for x in losses) + "; grad norms "
              + " ".join(f"{x:.4f}" for x in norms))
        d_loss = abs(loss_full - losses[0]) / abs(losses[0])
        d_norm = abs(gn_full - norms[0]) / abs(norms[0])
        print(f"[train] step 0: flash loss {losses[0]:.6f} grad norm "
              f"{norms[0]:.6f}; full attention loss {loss_full:.6f} grad "
              f"norm {gn_full:.6f}: relative differences {d_loss:.3e} "
              f"(limit 2e-3) and {d_norm:.3e} (limit 1e-2)")
        check(d_loss <= 2e-3 and d_norm <= 1e-2,
              f"train {cfg.name}: full attention's step 0 is not flash's")
        step_ms = statistics.median(ms[1:])
        tflops = flops / (step_ms / 1e3) / 1e12
        print(f"[train] {cfg.name}: step {step_ms:.2f} ms (median of steps "
              f"2-{TRAIN_STEPS}, CUDA events, no checkpoint write in "
              f"flight: {timer.waited:.2f} s waited for the step-"
              f"{TRAIN_CKPT_EVERY} write; steps " + " ".join(
                  f"{x:.2f}" for x in ms) + " ms), "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, model "
              f"{tflops:.2f} TFLOP/s by estimate_model_flops (6 N D = "
              f"{flops / 1e12:.3f} TFLOP a step), "
              f"{tflops * 1e12 / card_model().bf16_tc_flops:.4f} of the "
              f"bf16 dense peak {card_model().bf16_tc_flops / 1e12:.0f} "
              f"TFLOP/s; peak allocated "
              f"{got_peak / 1e9:.2f} GB against the reckoned "
              f"{peak['total'] / 1e9:.2f} GB, on {card}")

        # resume: the straight run's step-4 checkpoint, a new Trainer on
        t_restore = time.perf_counter()
        like = {"params": params, "opt": opt}
        tree, at = Checkpointer(str(tmp / "a")).restore(
            like, step=TRAIN_CKPT_EVERY)
        del params, opt, like
        shutil.rmtree(tmp / "a")
        gc.collect()
        # its only checkpoint: the one its run writes at its end
        tr2 = Trainer(cfg, tcfg, loop(tmp / "b", 2 * TRAIN_STEPS), ds, init)
        timer2 = StepTimer(torch, tr2.step_fn,
                           profile=range(1, TRAIN_PROFILE_TRIES + 1))
        tr2.step_fn = timer2
        params, _, step2, hist2 = tr2.run(trainable(tree["params"]),
                                          tree["opt"], at)
        del tree
        resumed = [h["loss"] for h in hist2]
        check(at == TRAIN_CKPT_EVERY and step2 == TRAIN_STEPS
              and len(resumed) == TRAIN_STEPS - at,
              f"train resume: from step {at} to {step2}, "
              f"{len(resumed)} steps")
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[at:]))
        check(rel <= 1e-4, f"train resume: losses {resumed} differ from "
                           f"the straight run's {losses[at:]}")
        print(f"[train] resumed from the step-{at} checkpoint by a new "
              f"Trainer: losses of steps {at + 1}-{TRAIN_STEPS} "
              + " ".join(f"{x:.4f}" for x in resumed)
              + f", at most {rel:.2e} relative from the straight run's "
              f"(restore and {TRAIN_STEPS - at} steps with a checkpoint at "
              f"the end: {time.perf_counter() - t_restore:.2f} s)")
        check(timer2.prof is not None, f"train: {TRAIN_PROFILE_TRIES} "
              "profiled steps recorded no device activity")
        kernels, (s, e) = timer2.prof
        wall_ms = s.elapsed_time(e)
        busy, idle = busy_share(kernels, wall_ms)
        print(f"[train] one profiled step: {wall_ms:.2f} ms (CUDA events, "
              f"under the profiler), device busy {busy:.2f} ms in "
              f"{len(kernels)} device operations, idle {idle:.4f}; against "
              f"the unprofiled median step: idle {1 - busy / step_ms:.4f}")
        for name, (n, us) in sorted(
                kernel_sums(kernels).items(), key=lambda r: -r[1][1])[:6]:
            print(f"[train]   {us / 1e3:9.3f} ms x{n:5d}  {name[:100]}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # serve the step-8 checkpoint in bf16
        t_serve = time.perf_counter()
        like = api.init_params(dataclasses.replace(
            cfg, param_dtype="bfloat16"), torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        tree, at = Checkpointer(str(tmp / "b")).restore({"params": like})
        del like
    check(at == TRAIN_STEPS, f"train: restored step {at}")
    served = prompts[:TRAIN_SERVE]
    runner = LMRunner(torch, K, card, cfg, tree["params"], "cuda",
                      TRAIN_SERVE_NEW)
    runner.run("train", "trained bf16", served)
    runner.run("train", "trained bf16 jit=False",
               served[:TRAIN_SERVE_EAGER], jit=False)
    check(runner.streams["trained bf16 jit=False"]
          == runner.streams["trained bf16"][:TRAIN_SERVE_EAGER],
          "train: the trained model's jit=False streams differ from the "
          "captured engine's")
    print(f"[train] the step-{at} checkpoint restored into bf16 and served "
          f"captured: {TRAIN_SERVE} requests ok; the first "
          f"{TRAIN_SERVE_EAGER} again with jit=False: streams equal "
          f"(restore and serve {time.perf_counter() - t_serve:.2f} s)")


def kernel_sums(kernels) -> dict:
    """{name: (launches, device us)} of a step's device operations."""
    out = {}
    for _, dur, name in kernels:
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + 1, us + dur)
    return out


def ssm_plain_loss(torch, cfg):
    """The Falcon-Mamba training loss built here layer by layer from the
    port's ``ssm_layer`` with the plain causal_conv1d: lm_loss's sequence
    of operations (the same embedding, non-reentrant checkpoint per layer,
    final norm and chunked cross-entropy), with no knob of lm_loss."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.configs.base import torch_dtype
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import chunked_softmax_ce, rmsnorm
    cdt = torch_dtype(cfg.compute_dtype)

    def layer(h, lp):
        return T.ssm_layer(h, lp, cfg, cdt, conv_method="torch")

    def loss(params, batch):
        tokens = batch["tokens"]
        h = params["embed"][tokens[:, :-1]].to(cdt)
        stack = params["layers"]
        parts = {"ln": stack["ln"].unbind(0),
                 **{k: v.unbind(0) for k, v in stack["mamba"].items()}}
        for i in range(cfg.n_layers):
            lp = {"ln": parts["ln"][i],
                  "mamba": {k: parts[k][i] for k in stack["mamba"]}}
            h = checkpoint(layer, h, lp, use_reentrant=False,
                           preserve_rng_state=False)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return chunked_softmax_ce(h, params["unembed"], tokens[:, 1:],
                                  chunk=LOSS_CHUNK)
    return loss


def train_ssm(torch, K, card) -> dict:
    """Phase 12 (b): Falcon-Mamba-7B at full width, cut in whole layers;
    the kernel step's loss and gradients bitwise the plain step's; then
    SSM_TRAIN_STEPS timed in-place train steps and the profiled ones
    after them, each launching causal_conv1d 3 x layers times and its
    plain version never; returns the steps' launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader
    from repro_torch.models import api, mamba
    from repro_torch.obs import metrics
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.tree import leaves
    from repro_torch.train import (TrainConfig, estimate_model_flops,
                                   make_train_step, trainable, value_and_grad)
    full = get_config(SSM_ARCH)
    b, s = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ
    free = torch.cuda.mem_get_info()[0]
    layers = full.n_layers
    while layers > 1 and free - ssm_train_peak(full, layers, b, s)["total"] \
            < SSM_TRAIN_HEADROOM:
        layers -= 1
    cfg = dataclasses.replace(full, n_layers=layers)
    peak = ssm_train_peak(full, layers, b, s)
    print(f"[train] {SSM_ARCH}: d_model {cfg.d_model}, d_inner "
          f"{cfg.mamba.expand * cfg.d_model}, d_state {cfg.mamba.d_state}, "
          f"vocab {cfg.vocab}; {b} x {s} tokens a step, remat full; reckoned "
          f"peak at {layers} layers: " + ", ".join(
              f"{k} {v / 1e9:.2f} GB" for k, v in peak.items())
          + f"; at {layers + 1}: "
          f"{ssm_train_peak(full, layers + 1, b, s)['total'] / 1e9:.2f} GB; "
          f"{free / 1e9:.2f} GB free on the card: depth cut from "
          f"{full.n_layers} to {layers} layers, leaving "
          f"{SSM_TRAIN_HEADROOM / 1e9:.0f} GB free")
    torch.cuda.reset_peak_memory_stats()
    params = trainable(api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda"))
    ds = IndexedDataset(DataConfig(kind="lm", vocab=cfg.vocab, seq_len=s,
                                   global_batch=b, seed=TRAIN_DATA_SEED))
    loader = PrefetchLoader(ds, 0)
    batch0 = ds.batch(0)
    batch0 = {k: torch.as_tensor(v).cuda() for k, v in batch0.items()}
    plain = metrics.counter("kernels.dispatch.causal_conv1d.torch")
    want = 3 * layers

    # the kernel step against the plain step, bitwise
    t_check = time.perf_counter()
    K.reset_launches()
    torch_before = plain.value
    loss_k, g_k = value_and_grad(api.loss_fn(cfg, remat="full"))(params,
                                                                 batch0)
    torch.cuda.synchronize()
    conv = K.causal_conv1d.launches
    check(conv == want and plain.value == torch_before,
          f"train {SSM_ARCH}: the loss and gradients launched causal_conv1d "
          f"{conv} times (not {want}) and its plain version "
          f"{plain.value - torch_before} times")
    loss_p, g_p = value_and_grad(ssm_plain_loss(torch, cfg))(params, batch0)
    pairs = list(zip(leaves(g_k), leaves(g_p)))
    diff = max(float((a.float() - c.float()).abs().max()) for a, c in pairs)
    same = torch.equal(loss_k, loss_p) and all(torch.equal(a, c)
                                               for a, c in pairs)
    print(f"[train] {SSM_ARCH}: the kernel step's loss {float(loss_k):.6f} "
          f"and {len(pairs)} gradient leaves against the plain step's "
          f"(ssm_layer with conv_method='torch', layer by layer): "
          f"{'bitwise equal' if same else 'DIFFER'} (loss difference "
          f"{float(loss_k - loss_p):.3e}, largest gradient difference "
          f"{diff:.3e}); causal_conv1d {conv} launches = 3 x {layers} "
          "layers (forward, recompute, dx), no plain dispatch "
          f"({time.perf_counter() - t_check:.2f} s)")
    check(same, f"train {SSM_ARCH}: the kernel step is not bitwise the "
                "plain step")
    del g_k, g_p, pairs
    gc.collect()

    # train steps, in place
    most = SSM_TRAIN_STEPS + SSM_PROFILE_TRIES
    opt = OptConfig(warmup_steps=1, total_steps=most)
    state = init_opt_state(params, opt)
    sessions = []       # causal_conv1d kernels each profiled session saw

    def complete(kernels):
        sessions.append(sum("causal_conv1d" in k[2] for k in kernels))
        return sessions[-1] == want
    timer = StepTimer(torch, make_train_step(
        cfg, TrainConfig(opt=opt, remat="full")),
        profile=range(SSM_TRAIN_STEPS + 1, most + 1), accept=complete)
    losses, step_launches = [], dict.fromkeys(
        (k.__name__ for k in K.KERNELS), 0)
    t_steps = time.perf_counter()
    i = 0
    while i < SSM_TRAIN_STEPS or (timer.prof is None and i < most):
        batch = next(loader)
        K.reset_launches()
        torch_before = plain.value
        params, state, m = timer(params, state, batch)
        losses.append(float(m["loss"]))
        got = {k.__name__: k.launches for k in K.KERNELS}
        check(got["causal_conv1d"] == want and plain.value == torch_before
              and sum(got.values()) == want,
              f"train {SSM_ARCH} step {i + 1}: launches {got} and "
              f"{plain.value - torch_before} plain causal_conv1d calls, "
              f"not {want} and 0")
        for k, v in got.items():
            step_launches[k] += v
        i += 1
    got_peak = torch.cuda.max_memory_allocated()
    ms = timer.ms()
    check(all(math.isfinite(x) for x in losses),
          f"train {SSM_ARCH}: losses {losses}")
    check(max(sessions, default=0) <= want and timer.prof is not None,
          f"train {SSM_ARCH}: torch.profiler saw {sessions} causal_conv1d "
          f"kernels in the sessions of {i - SSM_TRAIN_STEPS} profiled "
          f"steps, not {want} in one")
    kernels, (s_ev, e_ev) = timer.prof
    convs = [k for k in kernels if "causal_conv1d" in k[2]]
    # in start order: the forward's, then per layer (last first) its
    # recompute and its dx
    fwd = sum(k[1] for k in convs[:layers]) \
        + sum(k[1] for k in convs[layers::2])
    dx = sum(k[1] for k in convs[layers + 1::2])
    step_ms = statistics.median(ms[1:SSM_TRAIN_STEPS])
    tokens = b * s
    flops = estimate_model_flops(cfg, tokens)
    busy, idle = busy_share(kernels, s_ev.elapsed_time(e_ev))
    print(f"[train] {SSM_ARCH} at {layers} layers: {i} steps, losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {step_ms:.2f} ms (median of steps 2-{SSM_TRAIN_STEPS}, "
          f"CUDA events; step 1 {ms[0]:.2f} ms, each step "
          + " ".join(f"{t:.1f}" for t in ms) + " ms), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, model "
          f"{flops / (step_ms / 1e3) / 1e12:.2f} TFLOP/s; causal_conv1d "
          f"{want} launches a step (the wrapper's count in every step; "
          f"torch.profiler's in step {timer.profiled}, its sessions seeing "
          f"{sessions}), "
          f"device time a step: forward and recompute {2 * layers} launches "
          f"{fwd / 1e3:.4f} ms, dx {layers} launches {dx / 1e3:.4f} ms "
          f"(row 7: {PREFILL_CONV_MS} ms for the 64 launches of a 96-token "
          f"prefill); profiled step busy {busy:.2f} ms, idle {idle:.4f} "
          f"(the steps: {time.perf_counter() - t_steps:.2f} s)")
    scan_ms = scan_step_ms(torch, cfg, b, s, mamba)
    print(f"[train] {SSM_ARCH}: the selective scan alone at the step's "
          f"shapes (forward {scan_ms[0]:.3f} ms, forward and backward "
          f"{scan_ms[1]:.3f} ms a layer, CUDA events) x {layers} layers x "
          f"(forward, recompute, backward) = "
          f"{layers * (scan_ms[0] + scan_ms[1]):.1f} ms, "
          f"{layers * (scan_ms[0] + scan_ms[1]) / step_ms:.3f} of the step")
    print(f"[train] {SSM_ARCH}: peak allocated {got_peak / 1e9:.2f} GB "
          f"against the reckoned {peak['total'] / 1e9:.2f} GB, on {card}")
    check(got_peak <= peak["total"], f"train {SSM_ARCH}: peak allocated "
          f"{got_peak / 1e9:.2f} GB above the reckoned "
          f"{peak['total'] / 1e9:.2f} GB")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return step_launches


def scan_step_ms(torch, cfg, b, s, mamba) -> tuple:
    """(forward ms, forward + backward ms) of one layer's selective scan
    on seeded inputs of the train step's shapes, by CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    di, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda") \
            .to(torch.bfloat16).requires_grad_()
    x, dt, bt, ct = rnd(b, s, di), rnd(b, s, di), rnd(b, s, n), rnd(b, s, n)
    a = -torch.rand((di, n), generator=gen, device="cuda")
    with torch.no_grad():
        dt.copy_(torch.nn.functional.softplus(dt.float()))
    g = torch.ones((b, s, di), dtype=torch.bfloat16, device="cuda")

    def fwd():
        with torch.no_grad():
            mamba.mamba_scan(x, dt, a, bt, ct)

    def both():
        y, _ = mamba.mamba_scan(x, dt, a, bt, ct)
        torch.autograd.grad(y, (x, dt, bt, ct), g)
    return time_ms(torch, fwd, reps=3, trials=3), \
        time_ms(torch, both, reps=3, trials=3)


# ---------------------------------------------------------------- phase 8 --

#: phase 8: the phase-4 plans served again with the tuned cache installed
TUNED_PLANS = ("dws", "shift-w4")
TUNE_CACHE = ROOT / "build" / "repro_torch" / "tune_cache.json"


def phase_tune(torch, K, card, plans, dev="cuda"):
    """The autotuner path: ``python -m repro_torch.tune``'s main over the
    Table-2 jobs and the four CNN primitives' int8 and W4 plans at B=256,
    plus the tuner's float pool jobs; the cache written, reloaded and
    installed; the int8 dws and W4 shift plans of phase 4 served through
    CompiledPlan with it, their trunks bitwise equal to phase 4's; their
    throughput; the host cost of a memo-hit lookup. Returns the launch
    count of every kernel over the phase."""
    from repro_torch import tune
    from repro_torch.graph import CompiledPlan
    from repro_torch.obs import metrics
    from repro_torch.tune.__main__ import _Maker, _pool
    from repro_torch.tune.__main__ import main as tune_main
    tune.reset()
    K.reset_launches()
    t0 = time.perf_counter()
    # --verbose: every candidate's device time, one line each (the tile
    # sweeps of the integer conv and the float matmul among them)
    cache = tune_main(["--shapes", "table2", "--cnn",
                       "standard,dws,shift,add", "--cnn-batch", str(BATCH),
                       "--out", str(TUNE_CACHE), "--device", str(dev),
                       "--verbose"])
    # shapes_table2 pools int8: the tuner's float pool jobs, as the JAX
    # script's _pool(dtype=...) would give them
    mk = _Maker(dev)
    for dt in ("float32", "bfloat16"):
        kernel, sig, arrays, dtype, kw = _pool(mk, 8, 32, 32, 64, 2, 2,
                                               dtype=dt)
        best, best_us = tune.autotune_into(cache, kernel, sig, arrays,
                                           dtype, kwargs=kw, reps=3,
                                           warmup=1)
        e = cache.get(tune.cache_key(kernel, sig.key(), dtype,
                                     tune.backend_tag(dev)))
        print(f"{kernel}/{sig.key()}/{dtype}: best={best} {best_us:.2f}us "
              f"default={e['default_us']:.2f}us speedup="
              f"{e['default_us'] / best_us:.2f}x")
    cache.save(str(TUNE_CACHE))
    t_tune = time.perf_counter() - t0
    entries = cache.entries
    wins = sum(e["us"] < e["default_us"] for e in entries.values())
    speedups = [e["default_us"] / e["us"] for e in entries.values()]
    print(f"[tune] {len(entries)} jobs tuned on {tune.backend_tag(dev)} in "
          f"{t_tune:.1f} s ({sum(e['n_candidates'] for e in entries.values())}"
          f" candidates, ranked by device time); {wins} beat their default "
          "config; "
          f"default/best {min(speedups):.3f}-{max(speedups):.3f}x, geometric "
          f"mean {float(np.exp(np.mean(np.log(speedups)))):.3f}x; wrote "
          f"{TUNE_CACHE.relative_to(ROOT)}")

    reloaded = tune.TuneCache(str(TUNE_CACHE))
    check(not reloaded.stale and reloaded.entries == json.loads(
        json.dumps(entries)), "tune: the reloaded cache differs from the "
                              "one written")
    tune.set_default_cache(reloaded)
    hits = metrics.counter("tune.cache.hit")
    for name in TUNED_PLANS:
        plan, x, want = plans[name]
        h0 = hits.value
        ex = CompiledPlan(plan.plan, method="cuda", device=dev)
        got = ex.trunk(x)
        check(torch.equal(got.q, want.q) and got.frac_bits == want.frac_bits,
              f"tune {name}: the tuned plan's trunk differs from phase 4's")
        n_cfg = sum(len(c) for c in ex.node_configs.values())
        check(hits.value - h0 >= n_cfg > 0,
              f"tune {name}: {hits.value - h0} cache hits for {n_cfg} "
              "resolved node configs")
        # the analytic configs (no cache) and the tuned ones, in turns:
        # analytic, tuned, tuned, analytic
        untuned = CompiledPlan(plan.plan, method="cuda", device=dev)
        ips = {"tuned": [], "analytic": []}
        for which in ("analytic", "tuned", "tuned", "analytic"):
            tune.set_default_cache(reloaded if which == "tuned"
                                   else tune.TuneCache(None))
            r = (ex if which == "tuned" else untuned).throughput(
                x, reps=10, warmup=3)
            check(r["images_per_s"] > 0, f"tune {name}: no throughput")
            ips[which].append(r["images_per_s"])
        tune.set_default_cache(reloaded)
        print(f"[tune] {name}: trunk with the tuned cache == phase 4's "
              f"bitwise; node configs {ex.node_configs}; throughput (images/s"
              f", batch {BATCH}, wall clock, in turns) tuned "
              f"{ips['tuned'][0]:.1f} and {ips['tuned'][1]:.1f}, analytic "
              f"configs {ips['analytic'][0]:.1f} and {ips['analytic'][1]:.1f} "
              f"on {card}")
    launches = {k.__name__: k.launches for k in K.KERNELS}
    missing = [k for k, v in launches.items() if not v and k != "matmul_w4"]
    check(not missing, f"tune: the tuner never launched {missing}")

    sig = tune.sig_conv2d(BATCH, 32, 32, 3, 16, 3, 1)
    tune.get_config(sig, "int8", dev)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        tune.get_config(sig, "int8", dev)
    us = 1e6 * (time.perf_counter() - t0) / n
    lost = metrics.counter("tune.profile.lost_sessions").value
    print(f"[tune] a memo-hit get_config takes {us:.3f} us of host time "
          f"({n} calls); {lost:.0f} profiler sessions of this run so far "
          "recorded none or only part of their device activity (run "
          f"again, or filled in); launches {launches}")
    tune.reset()
    return launches


# ---------------------------------------------------------------- phase 9 --

#: phase 9: the paper's deployment flow, as examples/train_cnn_torch.py runs
#: it: each primitive trained at full width, quantized, served and profiled
FLOW_PRIMS = ("standard", "grouped", "dws", "shift", "add")
FLOW_BATCH, FLOW_STEPS, FLOW_RESUME = 64, 100, 50
#: int8 kernel launches per forward of each primitive's plan (widths
#: 16/32/64; the 3-channel stem is a standard conv, PER_FORWARD's rows)
FLOW_PER_FORWARD = {"standard": {"conv2d_q8": 3, "maxpool2d_s8": 3},
                    "grouped": {"conv2d_q8": 3, "maxpool2d_s8": 3},
                    "dws": PER_FORWARD["dws"], "shift": PER_FORWARD["shift"],
                    "add": PER_FORWARD["add"]}
FLOW_CKPT = ROOT / "build" / "chip_smoke_ckpt"


def phase_cnn_flow(torch, K, card, dev="cuda", prims=FLOW_PRIMS,
                   steps=FLOW_STEPS, resume_at=FLOW_RESUME):
    """Train -> checkpoint -> resume -> PTQ -> serve -> profile for each
    primitive; returns the kernel launches of the plans' forwards and
    profiles (training launches none: it runs the float primitives)."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader
    from repro_torch.device import exact_float32
    from repro_torch.graph import CompiledPlan
    from repro_torch.models import (CNNConfig, calibrate_bn, cnn_forward,
                                    cnn_value_and_grad, init_cnn,
                                    quantize_cnn)
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    ds = IndexedDataset(DataConfig(kind="image", global_batch=FLOW_BATCH,
                                   image_size=32, num_classes=10, seed=7))
    test = IndexedDataset(DataConfig(kind="image", global_batch=BATCH,
                                     image_size=32, num_classes=10,
                                     seed=7)).batch(10_000)
    x = torch.as_tensor(test["images"], dtype=torch.float32, device=dev)
    labels = torch.as_tensor(test["labels"], device=dev).long()
    calib = torch.as_tensor(ds.batch(20_000)["images"], dtype=torch.float32,
                            device=dev)
    opt = OptConfig(lr=2e-3, warmup_steps=20, total_steps=steps,
                    weight_decay=1e-4, grad_clip=1.0)
    on_card = torch.device(dev).type == "cuda"
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for prim in prims:
        cfg = CNNConfig(primitive=prim, widths=(16, 32, 64))
        ckdir = FLOW_CKPT / prim
        shutil.rmtree(ckdir, ignore_errors=True)
        ck = Checkpointer(str(ckdir), keep=2)

        def fresh(seed):
            p = init_cnn(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
            return p, init_opt_state(p, opt)

        def train(params, state, start, save_at=None):
            loader = PrefetchLoader(ds, start_step=start, device=dev)
            losses = []
            # full float32 and deterministic cuDNN, so a resumed run
            # repeats the uninterrupted one's sums
            with exact_float32(), torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=True,
                    allow_tf32=False):
                for i in range(start, steps):
                    (loss, _), grads = cnn_value_and_grad(
                        params, next(loader), cfg)
                    params, state, _ = apply_updates(params, grads, state,
                                                     opt)
                    losses.append(loss)
                    if i + 1 == save_at:
                        ck.save(i + 1, {"params": params, "opt": state})
            return params, state, [float(v) for v in losses]

        K.reset_launches()
        sync()
        t0 = time.perf_counter()
        params, _, losses = train(*fresh(0), 0, save_at=resume_at)
        sync()
        t_train = time.perf_counter() - t0
        ck.wait()
        check(not any(k.launches for k in K.KERNELS),
              f"flow {prim}: training launched a kernel of the int8 path")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(np.isfinite(losses).all() and last < first,
              f"flow {prim}: mean loss of the last 10 steps {last:.4f} not "
              f"below the first 10's {first:.4f}")
        # kill and resume: fresh state from another seed, then the
        # checkpoint of step resume_at
        p2, s2 = fresh(1)
        tree, start = ck.restore({"params": p2, "opt": s2})
        check(start == resume_at, f"flow {prim}: restored step {start}")
        _, _, resumed = train(tree["params"], tree["opt"], start)
        gap = max(abs(a - b) for a, b in zip(resumed, losses[start:]))
        check(len(resumed) == steps - start and gap <= 1e-4,
              f"flow {prim}: resumed losses differ from the uninterrupted "
              f"run by {gap}")

        params = calibrate_bn(params, cfg, calib)
        K.reset_launches()
        plan = quantize_cnn(params, cfg, calib, method="cuda", device=dev)
        trunk = plan.trunk(x)                 # eager warm-up, capture, replay
        per = {k.__name__: k.launches for k in K.KERNELS}
        want = {k: 2 * FLOW_PER_FORWARD[prim].get(k, 0) for k in per} \
            if on_card else dict.fromkeys(per, 0)
        check(per == want, f"flow {prim}: the first forward launched {per}, "
                           f"not {want}")
        plain = CompiledPlan(plan.plan, method="torch", device=dev).trunk(x)
        check(torch.equal(trunk.q, plain.q)
              and trunk.frac_bits == plain.frac_bits,
              f"flow {prim}: cuda trunk differs from the torch trunk")
        with exact_float32():
            lf = cnn_forward(params, x, cfg)
        lq = plan(x)
        check(bool(torch.isfinite(lq).all()) and tuple(lq.shape) ==
              (BATCH, cfg.num_classes), f"flow {prim}: bad int8 logits")
        agree = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
        acc_f = float((lf.argmax(-1) == labels).float().mean())
        acc_q = float((lq.argmax(-1) == labels).float().mean())
        rows = plan.profile(x, reps=3)
        for k in K.KERNELS:
            launches[k.__name__] += k.launches
        check(all(launches[k] for k in FLOW_PER_FORWARD[prim]) or
              not on_card, f"flow {prim}: a kernel of the plan never ran")
        n = steps + steps - resume_at
        print(f"[flow] {prim}: {steps} AdamW steps (batch {FLOW_BATCH}, "
              f"32x32, widths 16/32/64) in {t_train:.2f} s, "
              f"{steps / t_train:.1f} steps/s, "
              f"{steps * FLOW_BATCH / t_train:.1f} training images/s; loss "
              f"first 10 {first:.4f} -> last 10 {last:.4f}; resumed from "
              f"step {start}: max |loss diff| {gap:.2e} over {steps - start} "
              f"steps ({n} steps in all); int8 trunk (cuda, {plan.traces} "
              f"captured graph) == torch trunk bitwise; top-1 float {acc_f:.3f}, int8 "
              f"{acc_q:.3f}, float/int8 agreement {agree:.3f} (not gated) "
              f"on {BATCH} test images; on {card}")
        for r in rows:
            mcu = "".join(f" {k} {r[k]:.4f}" for k in r if k.startswith("mcu"))
            print(f"[flow] {prim}   profile {r['name']:6s} {r['op']:8s} "
                  f"{r['us']:9.1f} us  macs {r['macs']:>10d}{mcu}")
    return launches


# ------------------------------------------------------------------- main --

SOURCES = {
    "conv2d": ("conv2d_q8", "src/repro_torch/kernels/csrc/conv_im2col.cu",
               "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d": ("depthwise2d_q8",
                    "src/repro_torch/kernels/csrc/conv_dw.cu",
                    "src/repro/kernels/conv_dw.py:85"),
    "maxpool2d": ("maxpool2d_s8", "src/repro_torch/kernels/csrc/pool.cu",
                  "src/repro/kernels/pool.py:65"),
    "shift_conv2d": ("shift_conv2d_q8",
                     "src/repro_torch/kernels/csrc/conv_shift.cu",
                     "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d": ("add_conv2d_q8", "src/repro_torch/kernels/csrc/conv_add.cu",
                   "src/repro/kernels/conv_add.py:103"),
    "conv2d_w4": ("conv2d_w4", "src/repro_torch/kernels/csrc/conv_im2col.cu",
                  "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d_w4": ("depthwise2d_w4",
                       "src/repro_torch/kernels/csrc/conv_dw.cu",
                       "src/repro/kernels/conv_dw.py:85"),
    "shift_conv2d_w4": ("shift_conv2d_w4",
                        "src/repro_torch/kernels/csrc/conv_shift.cu",
                        "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d_w4": ("add_conv2d_w4",
                      "src/repro_torch/kernels/csrc/conv_add.cu",
                      "src/repro/kernels/conv_add.py:103"),
    "matmul": ("matmul_q8", "src/repro_torch/kernels/csrc/matmul_q8.cu",
               "src/repro/kernels/matmul_q8.py:106"),
    "matmul_w4": ("matmul_w4", "src/repro_torch/kernels/csrc/matmul_q8.cu",
                  "src/repro/kernels/matmul_q8.py:106"),
    "causal_conv1d": ("causal_conv1d",
                      "src/repro_torch/kernels/csrc/conv1d_causal.cu",
                      "src/repro/kernels/conv1d_causal.py:58"),
    "conv2d_f": ("conv2d_f", "src/repro_torch/kernels/csrc/conv_im2col.cu",
                 "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d_f": ("depthwise2d_f",
                      "src/repro_torch/kernels/csrc/conv_dw.cu",
                      "src/repro/kernels/conv_dw.py:85"),
    "maxpool2d_f": ("maxpool2d_f", "src/repro_torch/kernels/csrc/pool.cu",
                    "src/repro/kernels/pool.py:65"),
    "shift_conv2d_f": ("shift_conv2d_f",
                       "src/repro_torch/kernels/csrc/conv_shift.cu",
                       "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d_f": ("add_conv2d_f",
                     "src/repro_torch/kernels/csrc/conv_add.cu",
                     "src/repro/kernels/conv_add.py:103"),
    "matmul_f": ("matmul_f", "src/repro_torch/kernels/csrc/matmul_q8.cu",
                 "src/repro/kernels/matmul_q8.py:106"),
}


# ---------------------------------------------------------------- phase 13 --

#: the dry run's sweep: 10 archs x 4 shapes x 2 meshes, of which the
#: eight full-attention archs' long_500k cells are skipped; its processes
DRYRUN_CELLS, DRYRUN_OK, DRYRUN_SKIPPED, DRYRUN_JOBS = 80, 64, 16, 6
#: the sweep is CPU work only (meta tensors): it starts before phase 10 at
#: this niceness beside phases 10-12, which drive the card from one host
#: thread, and phase 13 waits for it (run by itself it took phase 13's
#: first 121.5 s on an H100's host; PERF.md)
DRYRUN_NICE = 19
DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_TIMEOUT_S = 600
#: the roofline count's steps: Qwen2-0.5B's int8 decode step of LM_BATCH
#: slots at position ROOF_POS; a ROOF_PREFILL-token Falcon-Mamba-7B
#: prefill at full width cut to ROOF_SSM_LAYERS layers; Qwen2-0.5B's train
#: step at ROOF_TRAIN_BATCH x ROOF_TRAIN_SEQ tokens
ROOF_POS, ROOF_PREFILL, ROOF_SSM_LAYERS = 128, 96, 8
ROOF_TRAIN_BATCH, ROOF_TRAIN_SEQ = 8, 512
#: the device kernel (a part of its name in a torch.profiler record) each
#: counted kernel launches once a call
ROOF_DEVICE_KERNEL = {"matmul_q8": "matmul_q_kernel",
                      "causal_conv1d": "causal_conv1d"}


def phase_launch(torch, K, card, sweep=None) -> dict:
    """Phase 13 (module docstring): the dry run's sweep (``sweep``, started
    earlier, or one started now), then the roofline count of three steps
    on the card. Returns the kernel launches of the counted steps."""
    dryrun_sweep(torch, card, sweep or DryrunSweep())
    launches = {}
    for name, build in (("decode", roof_decode), ("prefill", roof_prefill),
                        ("train", roof_train)):
        for k, v in roof_step(torch, K, card, name, build).items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    return launches


class DryrunSweep:
    """``python -m repro_torch.launch.dryrun --all`` started in a
    subprocess that sees no card (the fake backend, meta tensors), at
    DRYRUN_NICE, in a session of its own (``stop`` ends it and its
    workers); its output in files beside DRYRUN_OUT."""

    def __init__(self):
        import os
        import shutil
        shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
        DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("REPRO_")}
        env.update(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
        self.err = DRYRUN_OUT.with_suffix(".err")
        self.t0 = time.perf_counter()
        with open(DRYRUN_OUT.with_suffix(".out"), "w") as out, \
                open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                ["nice", "-n", str(DRYRUN_NICE), sys.executable, "-m",
                 "repro_torch.launch.dryrun", "--all", "--jobs",
                 str(DRYRUN_JOBS), "--out", str(DRYRUN_OUT)],
                cwd=ROOT, env=env, stdout=out, stderr=err,
                start_new_session=True)

    def wait(self) -> tuple:
        """(its exit code, its wall seconds, the seconds waited here)."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (t0 - self.t0)))
        except subprocess.TimeoutExpired:
            self.stop()
            rc = "timed out"
        t1 = time.perf_counter()
        return rc, t1 - self.t0, t1 - t0

    def stop(self):
        import os
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def dryrun_sweep(torch, card, sweep):
    """The dry run's sweep (:class:`DryrunSweep`), waited for: 80 records
    under JAX's cell names, 64 ok and 16 skipped, none faulty by
    ``dryrun.record_faults`` (no error; every ok record with its
    collectives, none across pods at 16x16, some at 2x16x16 in a train
    cell whose FSDP spans "pod"); each ok cell's first-device argument
    bytes at 16x16 beside the card's memory, and every ok cell's
    collective bytes."""
    import collections
    from repro_torch.launch import dryrun
    rc, wall, waited = sweep.wait()
    check(rc == 0, f"launch: the dry run exited {rc}: "
                   f"{sweep.err.read_text()[-2000:]}")
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(DRYRUN_OUT.glob("*.json"))}
    status = collections.Counter(rec["status"] for rec in recs.values())
    faults = dryrun.record_faults(recs.values())
    check(not faults, "launch: dry-run records: " + "; ".join(faults))
    check(len(recs) == DRYRUN_CELLS and status["ok"] == DRYRUN_OK
          and status["skipped"] == DRYRUN_SKIPPED,
          f"launch: the dry run wrote {len(recs)} records {dict(status)}, "
          f"not {DRYRUN_CELLS} ({DRYRUN_OK} ok, {DRYRUN_SKIPPED} skipped)")
    for name, rec in recs.items():
        want = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['tag']}"
        check(name == want + ".json", f"launch: record {name} names {want}")
    mem = torch.cuda.get_device_properties(0).total_memory
    print(f"[launch] dry run (python -m repro_torch.launch.dryrun --all "
          f"--jobs {DRYRUN_JOBS}, the fake backend, no card, at nice "
          f"{DRYRUN_NICE}): {len(recs)} records, {status['ok']} ok, "
          f"{status['skipped']} skipped, 0 error, in {wall:.1f} s wall from "
          f"its start, {waited:.1f} s of it waited for here")
    fit = []
    for rec in recs.values():
        if rec["status"] != "ok" or rec["mesh"] != "16x16":
            continue
        gb = rec["memory"]["argument_bytes"] / 1e9
        fit.append(gb <= mem / 1e9)
        print(f"[launch]   {rec['arch']:22s} {rec['shape']:12s} 16x16: "
              f"{gb:8.3f} GB of arguments a device against the card's "
              f"{mem / 1e9:.1f} GB; dot FLOPs {rec['dot_flops_global']:.4e}"
              f" a step ({rec['n_chips']} devices), model FLOPs "
              f"{rec['model_flops']:.4e}")
    print(f"[launch] {sum(fit)} of {len(fit)} cells' arguments fit one "
          f"card's memory at 16x16; card: {card}")
    print("[launch] collective GB a device a step (rank 0's step at its "
          "local shapes, roofline.count; in pod / across pods), beside "
          "its argument GB; train cells under their own rules, serve cells "
          "under spmd_rules:")
    for rec in recs.values():
        if rec["status"] != "ok":
            continue
        c = rec["collectives"]
        print(f"[launch]   {rec['arch']:22s} {rec['shape']:12s} "
              f"{rec['mesh']:8s}: {c['bytes_in_pod'] / 1e9:10.3f} / "
              f"{c['bytes_cross_pod'] / 1e9:9.3f} GB in {c['calls']:5d} "
              f"calls ({c['step_rules']}), arguments "
              f"{rec['memory']['argument_bytes'] / 1e9:8.3f} GB; "
              + ", ".join(f"{k} {v / 1e9:.3f}"
                          for k, v in c["by_kind"].items()))


def roof_decode(torch, rng):
    """(label, fn, args, timed fn, device_only, profiler calls, its
    counterpart under "torch") of Qwen2-0.5B's int8 decode step: counted
    eager, timed over replays of its captured graph."""
    from repro_torch.configs import get_config
    from repro_torch.graph.capture import capture
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config(LM_ARCH)
    params, _ = make_lm_params(torch, cfg, "cuda", "launch decode")
    eng = Engine(cfg, params, ServeConfig(max_batch=LM_BATCH,
                                          max_len=LM_MAX_LEN,
                                          precision="int8"))
    del params
    cache = api.init_slot_cache(cfg, LM_BATCH, LM_MAX_LEN, device="cuda")
    cache["len"].fill_(ROOF_POS)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device="cuda")
    cap, _ = capture(lambda t: eng.decode(eng.params, t, cache)[0], (tok,),
                     key="launch.decode")
    return (f"Qwen2-0.5B int8 decode step, {LM_BATCH} slots at position "
            f"{ROOF_POS} (timed: captured replays)", eng.decode,
            (eng.params, tok, cache), cap.replay, False, 10, True)


def roof_prefill(torch, rng):
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=ROOF_SSM_LAYERS)
    params, _ = make_lm_params(torch, cfg, "cuda", "launch prefill")
    params = T.cast_params(params, cfg)      # as the engine serves them
    fn = api.prefill_fn(cfg, ROOF_PREFILL)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, ROOF_PREFILL)).astype(np.int32)).cuda()}
    return (f"Falcon-Mamba-7B prefill of {ROOF_PREFILL} tokens, full width, "
            f"{ROOF_SSM_LAYERS} of 64 layers (eager)", fn, (params, batch),
            lambda: fn(params, batch), False, 3, False)


def roof_train(torch, rng):
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step, trainable
    cfg = get_config(TRAIN_ARCH)
    params, _ = make_lm_params(torch, cfg, "cuda", "launch train")
    params = trainable(params)
    ocfg = OptConfig(warmup_steps=2, total_steps=8)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, TrainConfig(opt=ocfg, remat="full",
                                            attn_impl="flash"))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (ROOF_TRAIN_BATCH, ROOF_TRAIN_SEQ)).astype(
            np.int32)).cuda()}
    return (f"Qwen2-0.5B train step, {ROOF_TRAIN_BATCH} x {ROOF_TRAIN_SEQ} "
            "tokens, float32 params, bf16 compute, remat full, flash "
            "(eager; in place)", step, (params, opt, batch),
            lambda: step(params, opt, batch), True, 1, False)


def roof_step(torch, K, card, name, build) -> dict:
    """Count one step on the card (``roofline.count.step_report``, the
    launch counts set to 0 just before), time it (``tune.device_kernels``)
    and print its FLOPs by kind, bytes floor, device ms, roofline terms and
    binding share. Gates: the share at most 1; each counted kernel's calls
    equal to its wrapper's launches and to torch.profiler's launches of its
    device kernel a call; with ``with_torch`` the same work counted with
    every kernel call run as its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.roofline import count as R
    rng = np.random.default_rng(SEED)
    label, fn, args, timed, device_only, calls, with_torch = build(torch, rng)
    K.reset_launches()
    rep = R.step_report(fn, *args)
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in K.KERNELS if k.launches}
    del rep["outputs"]
    check(rep["kernel_calls"] == launched,
          f"launch {name}: counted kernel calls {rep['kernel_calls']}, the "
          f"wrappers launched {launched}")
    if with_torch:
        with ops.force_method("torch"):
            plain = R.step_report(fn, *args)
        del plain["outputs"]
        check(plain["flops"] == rep["flops"]
              and plain["kernel_calls"] == rep["kernel_calls"]
              and plain["bytes_floor"] == rep["bytes_floor"],
              f"launch {name}: \"torch\" counts {plain['flops']} "
              f"{plain['kernel_calls']}, \"cuda\" {rep['flops']} "
              f"{rep['kernel_calls']}")
    rows = device_kernels(torch, timed, calls) if not device_only else \
        _device_only_rows(torch, timed, calls)
    device_s = sum(r.us for r in rows) / 1e6
    check(device_s > 0, f"launch {name}: torch.profiler saw no device time")
    for kernel, n in rep["kernel_calls"].items():
        seen = sum(r.launches for r in rows
                   if ROOF_DEVICE_KERNEL[kernel] in r.key)
        check(seen == n, f"launch {name}: {n} counted {kernel} calls, "
                         f"torch.profiler saw {seen} a call")
    model = card_model()
    out = R.report(rep["flops"], rep["bytes_floor"], device_s=device_s,
                   card=model)
    check(out["share"] <= 1.0, f"launch {name}: the binding term "
                               f"{out['binding']} is {out['share']:.3f} of "
                               "the device time")
    flops = ", ".join(f"{k} {v / 1e12:.4f} T" for k, v in
                      sorted(rep["flops"].items()))
    same = ' (method="torch" counts the same work)' if with_torch else ""
    terms = ", ".join(f"{k[:-2]} {1e3 * v:.4f} ms" for k, v in
                      out["terms"].items())
    print(f"[launch] roofline of {label}: FLOPs by kind {flops}; bytes "
          f"floor {rep['bytes_floor'] / 1e9:.4f} GB (arguments and "
          f"outputs); device {1e3 * device_s:.4f} ms "
          f"(tune.device_kernels); terms at the {model.name}'s peaks "
          f"{terms}; binding {out['binding'][:-2]}, "
          f"{out['share']:.4f} of the device time; kernel calls counted "
          f"{rep['kernel_calls'] or 'none'} = the wrappers' launches = "
          f"torch.profiler's{same}; card: {card}")
    return launched


# ---------------------------------------------------------------- shard --

#: phase 14: a world of SHARD_RANKS threads on the one card, one
#: ("data", "model") mesh of (1, SHARD_RANKS)
SHARD_RANKS = 2
SHARD_MESH = ((1, SHARD_RANKS), ("data", "model"))
#: (a) SP decode: granite-3-2b at full size, a batch of prompts prefilled
#: outside the mesh into a cache of SHARD_SP_MAX positions, then greedy
#: lockstep steps through api.decode_fn(cfg, sp_axis="model")
SHARD_SP_ARCH, SHARD_SP_BATCH, SHARD_SP_PROMPT = "granite-3-2b", 2, 512
SHARD_SP_MAX, SHARD_SP_STEPS = 4096, 32
#: (a)'s (compute dtype, steps, logits bound against the unsharded
#: decode): float32 over a float32 cache, greedy, tokens equal (the bound
#: 20x the 5e-6 the card read); then the config's bfloat16, fed the
#: unsharded decode's tokens (SP rounds the softmax otherwise, so a
#: greedy stream may part on a near tie; the bound about 2x the 0.0884 and
#: 0.0955 the card read over 8 and 32 steps). JAX's 5e-2
#: (tests/test_sharded.py) is for 2 layers: at 40 the unsharded bfloat16
#: decode itself is far from float32's on the same tokens, printed beside
SHARD_SP_RUNS = (("float32", SHARD_SP_STEPS, 1e-4), ("bfloat16", 8, 0.2))
#: (b) EP MoE: granite-moe-1b-a400m at full size with the capacity factor
#: E / top_k (no pair drops, so EP and local route the same pairs): one
#: layer's moe_ffn_sharded on a SHARD_EP_X input against moe_ffn_local
#: (tests/test_torch_moe.py's bf16 tolerance), then greedy lockstep decode
#: steps of the whole model inside the mesh against the same outside it
SHARD_EP_ARCH, SHARD_EP_X = "granite-moe-1b-a400m", (8, 64, 1024)
SHARD_EP_TOL = dict(atol=2 ** -5, rtol=2 ** -6)
SHARD_EP_BATCH, SHARD_EP_PROMPT, SHARD_EP_STEPS = 8, 64, 16
#: (c) a kernel under the mesh: Falcon-Mamba-7B at full width cut to
#: SHARD_SSM_LAYERS layers, one prefill of SHARD_SSM_LEN tokens a rank
SHARD_SSM_LAYERS, SHARD_SSM_LEN = 8, 96


def phase_shard(torch, K, card) -> dict:
    """Phase 14 (module docstring): the sharded serve paths on a world of
    ``SHARD_RANKS`` threads of this process that share the one card
    (``launch.world.run_world``: torch's threaded process group; every
    thread issues to the device's default stream, which runs the work in
    issue order, and a collective's copy is queued only once every rank
    has joined it, so nothing races across threads). Returns the kernel
    launches of case (c)."""
    from repro_torch.launch.world import run_world
    t0 = time.perf_counter()
    world = run_world(lambda rank: (rank, torch.cuda.current_device()),
                      SHARD_RANKS)
    check(world.backend == "threaded" and world.ranks == SHARD_RANKS
          and [r for r, _ in world.results] == list(range(SHARD_RANKS)),
          f"shard: the world is {world}")
    print(f"[shard] world: backend {world.backend}, {world.ranks} ranks as "
          f"threads of one process on device "
          f"{sorted({d for _, d in world.results})}, "
          f"torch.cuda.device_count() {torch.cuda.device_count()}, mesh "
          f"{SHARD_MESH[0]} {SHARD_MESH[1]}; {card}")
    shard_sp(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    shard_ep(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = shard_kernel(torch, K, card)
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    check(secs <= 60, f"shard: the phase took {secs:.1f} s, over 60 s")
    return launches


def _shard_mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*SHARD_MESH)


def _greedy(torch, fn, params, tok, cache, steps, forced=None):
    """(tokens (B, steps), logits of every step (B, steps, V), ms a step
    by wall clock around synchronised ends) of ``steps`` greedy lockstep
    decode steps from ``tok``; with ``forced`` (B, steps), step i + 1
    takes ``forced[:, i]`` as its input, whatever step i chose."""
    toks, logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, cache = fn(params, tok, cache)
        toks.append(lg[:, -1:].argmax(-1))
        logits.append(lg[:, -1])
        tok = toks[-1] if forced is None else forced[:, i:i + 1]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.cat(toks, 1), torch.stack(logits, 1), ms


def shard_sp(torch, card):
    """(a): SP decode against the unsharded decode on the card, in the
    compute dtypes of ``SHARD_SP_RUNS``: float32 compute over a float32
    cache, greedy, tokens equal; the config's bfloat16, the SP path fed
    the unsharded path's tokens (its rounding differs from one softmax's,
    so greedy streams may part on a near tie), token agreement printed;
    logits within each run's bound. Beside the bfloat16 run, the
    unsharded bfloat16 decode against the float32 one, both fed the
    float32 run's tokens. Each rank's cache bytes half the whole cache's;
    step ms of both."""
    from repro_torch.configs import get_config
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as S
    base = get_config(SHARD_SP_ARCH)
    params32, made = make_lm_params(torch, base, "cuda", "shard sp")
    gen = np.random.default_rng([SEED, 14])
    toks = torch.from_numpy(gen.integers(0, base.vocab, (
        SHARD_SP_BATCH, SHARD_SP_PROMPT))).cuda()
    f32 = None
    for dtype, steps, tol in SHARD_SP_RUNS:
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        params = T.cast_params(params32, cfg)
        logits, cache = api.prefill_fn(cfg, SHARD_SP_MAX)(
            params, {"tokens": toks})
        if dtype == "float32":
            cache = {k: v.float() if v.is_floating_point() else v
                     for k, v in cache.items()}
        tok = logits.argmax(-1)
        ref_toks, ref_logits, ref_ms = _greedy(
            torch, api.decode_fn(cfg), params, tok,
            {k: v.clone() for k, v in cache.items()}, steps)
        forced = None if dtype == "float32" else ref_toks
        witness = ""
        if f32 is None:
            f32 = (tok, ref_toks, ref_logits)
        else:           # the unsharded bf16 decode on float32's tokens
            _, lg, _ = _greedy(torch, api.decode_fn(cfg), params, f32[0],
                               {k: v.clone() for k, v in cache.items()},
                               steps, f32[1][:, :steps])
            witness = (f"; the unsharded {dtype} decode against the "
                       f"unsharded float32 one on float32's tokens: logits "
                       f"max |diff| "
                       f"{float((lg - f32[2][:, :steps]).abs().max()):.6f}")
        whole = sum(cache[k].numel() * cache[k].element_size() for k in "kv")

        def rank_main(rank):
            mesh = _shard_mesh()
            rules = S.spmd_rules(S.prune_batch_axes(mesh, S.make_rules(
                mesh, cfg, "decode", sp=True), SHARD_SP_BATCH))
            with S.use_mesh(mesh), S.use_rules(rules):
                local = {k: v.clone() for k, v in S.shard_tree(
                    cache, api.cache_specs(cfg)).items()}
                mine = sum(local[k].numel() * local[k].element_size()
                           for k in "kv")
                got = _greedy(torch, api.decode_fn(cfg, sp_axis="model"),
                              params, tok, local, steps, forced)
            return mine, got
        world = run_world(rank_main, SHARD_RANKS)
        for rank, (mine, (got_toks, got_logits, ms)) in enumerate(
                world.results):
            err = float((got_logits - ref_logits).abs().max())
            agree = float((got_toks == ref_toks).float().mean())
            check(mine * SHARD_RANKS == whole,
                  f"shard sp rank {rank}: cache {mine} bytes of {whole}")
            check(bool(torch.isfinite(got_logits).all()),
                  f"shard sp {dtype} rank {rank}: logits not finite")
            check((agree == 1.0 or forced is not None) and err <= tol,
                  f"shard sp {dtype} rank {rank}: tokens {agree:.4f} "
                  f"equal, logits {err} from the unsharded decode's "
                  f"(bound {tol})")
            print(f"[shard] (a) SP decode, {SHARD_SP_ARCH} full size "
                  f"({made}), {dtype} compute, {cache['k'].dtype} cache: "
                  f"{SHARD_SP_BATCH} x {SHARD_SP_PROMPT}-token prompts "
                  f"prefilled outside the mesh into {SHARD_SP_MAX} "
                  f"positions, {steps} lockstep steps "
                  + ("greedy" if forced is None else
                     "fed the unsharded decode's tokens")
                  + f": rank {rank} holds positions "
                  f"{rank * SHARD_SP_MAX // SHARD_RANKS}-"
                  f"{(rank + 1) * SHARD_SP_MAX // SHARD_RANKS - 1}, K/V "
                  f"{mine / 2 ** 20:.1f} MiB of {whole / 2 ** 20:.1f}; "
                  f"tokens {agree:.4f} equal to the unsharded decode's, "
                  f"logits max |diff| {err:.6f} (bound {tol}){witness}; "
                  f"step {ms:.3f} ms sharded (eager, {SHARD_RANKS} "
                  f"threads) against {ref_ms:.3f} ms unsharded (eager; "
                  f"wall clock); {card}")
        del params, cache, world
        gc.collect()
        torch.cuda.empty_cache()


def shard_ep(torch, card):
    """(b): one layer's EP MoE against the local path, then greedy decode
    steps of the whole model inside the mesh against outside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as S
    cfg = get_config(SHARD_EP_ARCH)
    moe = dataclasses.replace(cfg.moe, capacity_factor=(
        cfg.moe.num_experts / cfg.moe.top_k))
    print(f"[shard] (b) config change: {SHARD_EP_ARCH} capacity_factor "
          f"{cfg.moe.capacity_factor} -> {moe.capacity_factor} (E / top_k: "
          "no (token, expert) pair drops, so EP and local route the same "
          "pairs)")
    cfg = dataclasses.replace(cfg, moe=moe)
    params, made = make_lm_params(torch, cfg, "cuda", "shard ep")
    params = T.cast_params(params, cfg)
    cdt = T._cdt(cfg)
    p0 = T._take(params["layers"]["moe"], 0)
    gen = np.random.default_rng([SEED, 15])
    x = torch.from_numpy(gen.standard_normal(SHARD_EP_X, np.float32)) \
        .cuda().to(cdt)
    local_fn = lambda: M.moe_ffn_local(x, p0, moe, cfg.act, cdt)  # noqa
    want = local_fn()
    local_ms = time_ms(torch, local_fn, reps=5, trials=3)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab, (
        SHARD_EP_BATCH, SHARD_EP_PROMPT))).cuda()
    max_len = SHARD_EP_PROMPT + SHARD_EP_STEPS
    logits, cache = api.prefill_fn(cfg, max_len)(params, {"tokens": toks})
    tok = logits.argmax(-1)
    ref_toks, _, ref_ms = _greedy(torch, api.decode_fn(cfg), params, tok,
                                  {k: v.clone() for k, v in cache.items()},
                                  SHARD_EP_STEPS)

    def rank_main(rank):
        mesh = _shard_mesh()
        rules = S.spmd_rules(S.prune_batch_axes(
            mesh, S.make_rules(mesh, cfg, "decode"), SHARD_EP_BATCH))
        with S.use_mesh(mesh), S.use_rules(rules):
            fn = lambda: M.moe_ffn_sharded(x, p0, moe, cfg.act, cdt)  # noqa
            y = fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            ep_ms = (time.perf_counter() - t0) * 1e3 / 5
            local = {k: v.clone() for k, v in S.shard_tree(
                cache, api.cache_specs(cfg)).items()}
            got = _greedy(torch, api.decode_fn(cfg), params, tok, local,
                          SHARD_EP_STEPS)
        return y, ep_ms, got
    world = run_world(rank_main, SHARD_RANKS)
    for rank, (y, ep_ms, (got_toks, _, ms)) in enumerate(world.results):
        err = (y.float() - want.float()).abs()
        ok = bool((err <= SHARD_EP_TOL["atol"] + SHARD_EP_TOL["rtol"]
                   * want.float().abs()).all())
        check(ok, f"shard ep rank {rank}: moe_ffn_sharded {float(err.max())}"
              f" from moe_ffn_local, over {SHARD_EP_TOL}")
        check(bool((got_toks == ref_toks).all()),
              f"shard ep rank {rank}: decode tokens differ from the same "
              "decode outside the mesh")
        print(f"[shard] (b) EP MoE, {SHARD_EP_ARCH} full size ({made}; "
              f"{moe.num_experts} experts, top-{moe.top_k}, "
              f"{moe.num_experts // SHARD_RANKS} a rank): layer 0's "
              f"moe_ffn_sharded on {SHARD_EP_X} bf16 against moe_ffn_local, "
              f"max |diff| {float(err.max()):.6f} (within {SHARD_EP_TOL}), "
              f"{ep_ms:.3f} ms a call on rank {rank} ({SHARD_RANKS} threads, "
              f"wall clock) against {local_ms:.3f} ms local (CUDA events); "
              f"{SHARD_EP_STEPS} greedy decode steps of {SHARD_EP_BATCH} "
              f"slots inside the mesh, every layer's moe_ffn on the EP "
              f"path: tokens equal to the decode outside the mesh; step "
              f"{ms:.3f} ms against {ref_ms:.3f} ms (eager, wall clock); "
              f"{card}")


def shard_kernel(torch, K, card) -> dict:
    """(c): a Falcon-Mamba prefill inside the mesh on every rank:
    causal_conv1d on the "cuda" route, launched once a layer a rank by its
    wrapper's count, no ``.mesh`` fallback counted, output bitwise the
    prefill outside the mesh. Returns the launches of the ranks' run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics
    from repro_torch.parallel import sharding as S
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SHARD_SSM_LAYERS)
    params, made = make_lm_params(torch, cfg, "cuda", "shard ssm")
    params = T.cast_params(params, cfg)
    gen = np.random.default_rng([SEED, 16])
    batch = {"tokens": torch.from_numpy(gen.integers(
        0, cfg.vocab, (1, SHARD_SSM_LEN))).cuda()}
    pre = api.prefill_fn(cfg, SHARD_SSM_LEN)
    want, wc = pre(params, batch)
    names = ("kernels.dispatch.causal_conv1d.cuda",
             "kernels.fallback.causal_conv1d.mesh")
    before = [metrics.counter(n).value for n in names]
    K.reset_launches()

    def rank_main(rank):
        with S.use_mesh(_shard_mesh()):
            return pre(params, batch)
    world = run_world(rank_main, SHARD_RANKS)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    calls = [metrics.counter(n).value - b for n, b in zip(names, before)]
    n = SHARD_SSM_LAYERS * SHARD_RANKS
    check(launches["causal_conv1d"] == n and calls == [n, 0]
          and sum(launches.values()) == n,
          f"shard ssm: launches {launches}, dispatch/fallback {calls}, "
          f"expected {n} causal_conv1d launches and no fallback")
    for rank, (got, gc_) in enumerate(world.results):
        check(torch.equal(got, want) and all(
            torch.equal(gc_[k], wc[k]) for k in ("conv", "ssm")),
            f"shard ssm rank {rank}: the prefill inside the mesh differs "
            "from the one outside it")
    print(f"[shard] (c) {SSM_ARCH} at {SHARD_SSM_LAYERS} layers ({made}), "
          f"one {SHARD_SSM_LEN}-token prefill a rank inside the mesh: "
          f"causal_conv1d launched {launches['causal_conv1d']} times "
          f"({SHARD_SSM_LAYERS} a rank) on the \"cuda\" route, "
          f"kernels.fallback.causal_conv1d.mesh {calls[1]:.0f}; logits and "
          f"conv / ssm state bitwise the prefill outside the mesh; {card}")
    return launches


# ---------------------------------------------------------- train shard --

#: phase 15: the sharded train step on worlds of threads on the one card
TSHARD_MESH = ((2, 2, 2), ("pod", "data", "model"))
TSHARD_RANKS = 8
#: (a) Qwen2-0.5B at full size, float32 compute; the batch and steps
TSHARD_ARCH, TSHARD_SEQ, TSHARD_BATCH, TSHARD_STEPS = \
    "qwen2-0.5b", 512, 8, 2
TSHARD_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
#: (a)'s and (c)'s bounds against the unsharded step: loss and grad norm
#: relative; the params after the steps: the norm of their difference
#: over the norm of the unsharded step's update, and no weight further
#: apart than two AdamW paths can take it (2 lr a step). Elementwise the
#: steps part: AdamW moves a weight by lr g / (|g| + eps), and at full
#: size a gradient's rounding error (the sums' other order) passes eps
#: = 1e-8, so a weight whose gradient is within rounding of zero moves by
#: up to lr either way; TSHARD_FAR counts the weights over 1% of lr apart
TSHARD_REL, TSHARD_UPDATE_REL = 1e-4, 1e-3
TSHARD_FAR = 1e-5
#: (d) the compressed all-reduce's bound on each leaf's relative error
TSHARD_COMPRESSED_REL = 0.08
#: (b) the sharded Trainer: steps, the checkpoint step, the restore mesh;
#: (a)'s model at full width cut to TSHARD_TRAINER_LAYERS layers: at 24
#: its 5.9-GB checkpoints (params, m, v) took the phase past its 150 s on
#: an H100 (PERF.md: (b) 136.2 s of 175.6)
TSHARD_TRAINER_STEPS, TSHARD_TRAINER_CKPT = 4, 2
TSHARD_TRAINER_LAYERS = 4
TSHARD_RESTORE_MESH = ((1, 2), ("data", "model"))
#: (c) Falcon-Mamba-7B at full width cut to these layers, 2 x 256 tokens
TSHARD_SSM_MESH = ((2, 2), ("data", "model"))
TSHARD_SSM_LAYERS, TSHARD_SSM_BATCH, TSHARD_SSM_SEQ = 4, 2, 256
#: (e) seamless-m4t-large-v2 at full width, float32, its encoder and
#: decoder each cut to this depth (the run's time: at full depth 22-28 s,
#: and the run passed 1,100 s on a host that ran Python at half speed);
#: TSHARD_BATCH rows of
#: TSHARD_ENCDEC_FRAMES frames and TSHARD_ENCDEC_TOKENS + 1 tokens, two
#: steps on (a)'s world
TSHARD_ENCDEC_ARCH, TSHARD_ENCDEC_LAYERS = "seamless-m4t-large-v2", 4
TSHARD_ENCDEC_FRAMES, TSHARD_ENCDEC_TOKENS = 128, 128
#: (f) jamba-v0.1-52b at full width, one super-block (7 Mamba sublayers,
#: attention, 4 MoE FFNs), float32, one step of TSHARD_BATCH x
#: TSHARD_HYBRID_SEQ tokens on (a)'s world; its experts cut to 2 (top-2,
#: so nothing drops) and its FFN width (dense and experts') to
#: TSHARD_HYBRID_FF: with 2 experts at d_ff 14,336 the super-block and
#: tables are 3.43 G parameters, 54.9 GB of params, gradients and both
#: moments, which the world's ranks hold between them as the unsharded
#: step does, and each of the 8 ranks gathers its 5.72-GB share of the
#: super-block at once (FSDP) and its gradient in the backward
#: (tshard_hybrid_reckoning). The sequence is short because the
#: super-block is one checkpoint: its backward keeps the doubling scan's
#: levels of all 7 Mamba sublayers at once (at 128 tokens the unsharded
#: step's alone took the card past its 80 GB)
TSHARD_HYBRID_ARCH, TSHARD_HYBRID_SEQ = "jamba-v0.1-52b", 32
TSHARD_HYBRID_EXPERTS, TSHARD_HYBRID_FF = 2, 1024
TSHARD_SECONDS = 150


def phase_train_shard(torch, K, card) -> dict:
    """Phase 15 (module docstring): (a) and (d), (b), (c), (e), then (f);
    returns (c)'s and (f)'s kernel launches."""
    from repro_torch.launch.world import run_world
    t0 = time.perf_counter()
    world = run_world(lambda rank: rank, TSHARD_RANKS)
    check(world.backend == "threaded" and world.results == list(range(
        TSHARD_RANKS)), f"train shard: the world is {world}")
    tshard_dense(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    tshard_trainer(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = tshard_ssm(torch, K, card)
    gc.collect()
    torch.cuda.empty_cache()
    tshard_encdec(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in tshard_hybrid(torch, K, card).items():
        launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    check(secs <= TSHARD_SECONDS,
          f"train shard: the phase took {secs:.1f} s, over "
          f"{TSHARD_SECONDS} s")
    return launches


def _tshard_rules(S, mesh, cfg, batch):
    return S.prune_batch_axes(mesh, S.make_rules(mesh, cfg, "train",
                                                 fsdp=True), batch)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _gathered_errs(torch, S, blocks, shardings, want, start,
                   prefix="", compare=True) -> dict:
    """``{path: (largest |difference|, sum of squared differences, sum of
    squared updates, elements apart by over TSHARD_FAR)}`` between the
    global arrays of a rank's ``blocks`` (each split dim gathered over its
    mesh axes, a leaf at a time) and the global tensors ``want`` (the
    same structure), the updates ``want - start``. Without ``compare``
    the rank joins the gathers and compares nothing (every rank gathers
    the same global arrays): ``{}``."""
    out = {}
    with torch.no_grad():
        for key in sorted(blocks):
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(blocks[key], dict):
                out.update(_gathered_errs(torch, S, blocks[key],
                                          shardings[key], want[key],
                                          start[key], path, compare))
                continue
            t = blocks[key]
            for dim, entry in enumerate(shardings[key].spec):
                if entry is not None and S.axis_size(entry) > 1:
                    t = S.all_gather(t, entry, dim)
            if not compare:
                continue
            w, w0 = want[key].to(t.device), start[key].to(t.device)
            d = (t.float() - w.float()).abs()
            u = w.float() - w0.float()
            out[path] = (float(d.max()), float(torch.sum(d * d)),
                         float(torch.sum(u * u)),
                         int((d > TSHARD_FAR).sum()))
            del t, d, u, w, w0
    return out


def _tshard_reference(torch, cfg, tcfg, params, batches):
    """The unsharded step on a copy of ``params``: (metrics of each step,
    the params after them, ms a step by wall clock around synchronised
    ends, the params' + moments' bytes)."""
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    ref = tree_map(lambda t: t.detach().clone(), params)
    opt = init_opt_state(ref, tcfg.opt)
    whole = 3 * _tree_bytes(ref)
    step = make_train_step(cfg, tcfg)
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        ref, opt, m = step(ref, opt, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    del opt
    return metrics, ref, ms, whole


def _param_gap(errs) -> tuple:
    """(the params' difference over the update, in norm; the largest
    elementwise difference; weights over TSHARD_FAR apart, of all)."""
    diff = sum(v[1] for v in errs.values())
    upd = sum(v[2] for v in errs.values())
    return (math.sqrt(diff / max(upd, 1e-30)),
            max(v[0] for v in errs.values()),
            sum(v[3] for v in errs.values()))


def _tshard_check(tag, rank, ref_m, got_m, errs, lr, steps):
    for (l1, g1), (l2, g2) in zip(ref_m, got_m):
        check(math.isfinite(l2) and abs(l2 - l1) <= TSHARD_REL * abs(l1)
              and abs(g2 - g1) <= TSHARD_REL * abs(g1),
              f"train shard {tag} rank {rank}: loss / grad norm {got_m} "
              f"against the unsharded {ref_m} (bound {TSHARD_REL} "
              "relative)")
    if not errs:        # a rank that joined the gathers only
        return
    rel, worst, far = _param_gap(errs)
    top = sorted(errs.items(), key=lambda kv: -kv[1][0])[:3]
    check(rel <= TSHARD_UPDATE_REL and worst <= 2 * lr * steps,
          f"train shard {tag} rank {rank}: params {rel} of the update "
          f"apart in norm (bound {TSHARD_UPDATE_REL}), {worst} at most "
          f"(bound {2 * lr * steps}), {far} weights over {TSHARD_FAR}; "
          f"largest {[(k, v[0]) for k, v in top]}")


def tshard_dense(torch, card):
    """(a) and (d): Qwen2-0.5B's sharded steps against the unsharded ones,
    and the compressed all-reduce on the step-0 gradients."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, IndexedDataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.optim import (OptConfig, allreduce_compressed,
                                   init_errors, init_opt_state)
    from repro_torch.parallel import sharding as S
    from repro_torch.train import TrainConfig, make_train_step, value_and_grad
    from repro_torch.tree import leaves
    base = get_config(TSHARD_ARCH)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    tcfg = TrainConfig(opt=OptConfig(**TSHARD_OPT), remat="full",
                       attn_impl="flash")
    print(f"[train-shard] (a) config change: {TSHARD_ARCH} compute_dtype "
          f"{base.compute_dtype} -> float32 (params {cfg.param_dtype})")
    ds = IndexedDataset(DataConfig(kind="lm", vocab=cfg.vocab,
                                   seq_len=TSHARD_SEQ,
                                   global_batch=TSHARD_BATCH,
                                   seed=TRAIN_DATA_SEED))
    batches = [{k: torch.as_tensor(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TSHARD_STEPS)]
    params, made = make_lm_params(torch, cfg, "cuda", "train shard")
    ref_m, ref, ref_ms, whole = _tshard_reference(torch, cfg, tcfg, params,
                                                  batches)
    step = make_train_step(cfg, tcfg)
    grad_fn = value_and_grad(api.loss_fn(cfg, attn_impl=tcfg.attn_impl,
                                         remat=tcfg.remat))

    def rank_main(rank):
        mesh = make_mesh(*TSHARD_MESH)
        axes = tuple(mesh.mesh_dim_names)
        with S.use_mesh(mesh), S.use_rules(_tshard_rules(S, mesh, cfg,
                                                         TSHARD_BATCH)):
            psh = S.tree_shardings(api.param_specs(cfg))
            p = S.local_tree(params, psh, copy=True)
            opt = init_opt_state(p, tcfg.opt)
            mine = 3 * _tree_bytes(p)
            want = 3 * S.local_bytes(api.param_structs(cfg), psh)
            rows = [{k: S.local_shard(v, S.named_sharding("batch", None))
                     for k, v in b.items()} for b in batches]
            # (d) on the step-0 gradients, before the sum over copies
            _, g = grad_fn(p, rows[0], 1.0 / mesh.size())
            with torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, errs = allreduce_compressed(g, init_errors(g), axes)
                torch.cuda.synchronize()
                comp_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                mean = [S.psum(x, axes) / mesh.size() for x in leaves(g)]
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                rel = max(float((a - b).abs().max() / b.abs().max().clamp(
                    min=1e-30)) for a, b in zip(leaves(got), mean))
                resid = max(float(e.abs().max()) for e in leaves(errs))
            del g, got, errs, mean
            metrics = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in rows:
                p, opt, m = step(p, opt, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            ms = (time.perf_counter() - t0) * 1e3 / len(rows)
            err = _gathered_errs(torch, S, p, psh, ref, params)
        return metrics, mine, want, ms, err, (rel, resid, comp_ms, plain_ms)
    world = run_world(rank_main, TSHARD_RANKS)
    for rank, (got_m, mine, want, ms, err, comp) in enumerate(
            world.results):
        _tshard_check("(a)", rank, ref_m, got_m, err, tcfg.opt.lr,
                      TSHARD_STEPS)
        check(mine == want, f"train shard (a) rank {rank}: param + moment "
              f"bytes {mine}, local_bytes says {want}")
        rel, resid, comp_ms, plain_ms = comp
        check(rel < TSHARD_COMPRESSED_REL and resid > 0,
              f"train shard (d) rank {rank}: compressed all-reduce {rel} "
              f"from the mean (bound {TSHARD_COMPRESSED_REL}), largest "
              f"residual {resid}")
    got_m, mine, _, ms, errs, _ = world.results[0]
    rel, worst, far = _param_gap(errs)
    comps = [r[5] for r in world.results]
    print(f"[train-shard] (a) {TSHARD_ARCH} full size ({made}), float32, "
          f"remat {tcfg.remat}, attn {tcfg.attn_impl}, AdamW lr "
          f"{tcfg.opt.lr}: {TSHARD_RANKS} threads on a {TSHARD_MESH[0]} "
          f"{TSHARD_MESH[1]} mesh, FSDP + TP, {TSHARD_BATCH} x "
          f"{TSHARD_SEQ} tokens a step ({TSHARD_BATCH * 2 // TSHARD_RANKS} "
          f"rows a rank); losses "
          + " ".join(f"{x[0]:.6f}" for x in got_m) + " against "
          + " ".join(f"{x[0]:.6f}" for x in ref_m) + ", grad norms "
          + " ".join(f"{x[1]:.6f}" for x in got_m) + " against "
          + " ".join(f"{x[1]:.6f}" for x in ref_m)
          + f" unsharded (bound {TSHARD_REL} relative); params after "
          f"{TSHARD_STEPS} steps, gathered: {rel:.3e} of the update apart "
          f"in norm (bound {TSHARD_UPDATE_REL}), max |diff| {worst:.3e} "
          f"(bound {2 * tcfg.opt.lr * TSHARD_STEPS}), {far:,} of "
          f"{sum(t.numel() for t in _leaves(params)):,} weights over "
          f"{TSHARD_FAR} apart; param + m + v bytes a rank "
          f"{mine / 2 ** 20:.1f} MiB = local_bytes, against "
          f"{whole / 2 ** 20:.1f} MiB unsharded; step {ms:.1f} ms sharded "
          f"({TSHARD_RANKS} threads, wall clock) against {ref_ms:.1f} ms "
          f"unsharded; {card}")
    print(f"[train-shard] (d) allreduce_compressed over {TSHARD_RANKS} "
          f"ranks of each rank's step-0 gradient blocks "
          f"({len(list(_leaves(params)))} leaves): largest relative error of a "
          f"leaf {max(c[0] for c in comps):.5f} (bound "
          f"{TSHARD_COMPRESSED_REL}), residuals up to "
          f"{max(c[1] for c in comps):.3e}; "
          f"{statistics.median(c[2] for c in comps):.1f} ms against "
          f"{statistics.median(c[3] for c in comps):.1f} ms for the plain "
          f"psum (median of the ranks, wall clock); {card}")


def tshard_trainer(torch, card):
    """(b): the sharded Trainer on (a)'s world, then restored from its
    step-2 checkpoint onto a world of 2 ranks."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, IndexedDataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.optim import OptConfig
    from repro_torch.parallel import sharding as S
    from repro_torch.train import LoopConfig, TrainConfig, Trainer
    base = get_config(TSHARD_ARCH)
    cfg = dataclasses.replace(base, compute_dtype="float32",
                              n_layers=TSHARD_TRAINER_LAYERS)
    print(f"[train-shard] (b) config change: {TSHARD_ARCH} n_layers "
          f"{base.n_layers} -> {cfg.n_layers} (full width), compute_dtype "
          f"{base.compute_dtype} -> float32")
    tcfg = TrainConfig(opt=OptConfig(**TSHARD_OPT), remat="full",
                       attn_impl="flash")
    ds = IndexedDataset(DataConfig(kind="lm", vocab=cfg.vocab,
                                   seq_len=TSHARD_SEQ,
                                   global_batch=TSHARD_BATCH,
                                   seed=TRAIN_DATA_SEED))
    name = f"step_{TSHARD_TRAINER_CKPT:09d}"

    def init(gen):
        return api.init_params(cfg, gen, device="cuda")

    def run(spec, directory):
        mesh = make_mesh(*spec)
        with S.use_mesh(mesh), S.use_rules(_tshard_rules(S, mesh, cfg,
                                                         TSHARD_BATCH)):
            psh = S.tree_shardings(api.param_specs(cfg))
            tr = Trainer(cfg, tcfg, LoopConfig(
                total_steps=TSHARD_TRAINER_STEPS,
                ckpt_every=TSHARD_TRAINER_CKPT, ckpt_dir=directory,
                keep=TSHARD_TRAINER_STEPS, log_every=0), ds, init, psh,
                S.named_sharding("batch", None), device="cuda")
            params, opt, start = tr.init_or_restore(SEED)
            equal = None
            if start:
                with np.load(Path(directory) / name / "shard_0.npz") as z:
                    equal = all(torch.equal(blk.cpu(), S.local_shard(
                        torch.from_numpy(z["params/" + key]),
                        sh).contiguous())
                        for key, blk, sh in _paired(params, psh))
            t0 = time.perf_counter()
            _, _, step, hist = tr.run(params, opt, start)
            secs = time.perf_counter() - t0
        return [h["loss"] for h in hist], start, equal, step, secs
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        straight, restored = Path(tmp) / "straight", Path(tmp) / "restored"
        world = run_world(lambda rank: run(TSHARD_MESH, str(straight)),
                          TSHARD_RANKS)
        losses, _, _, step, secs = world.results[0]
        check(step == TSHARD_TRAINER_STEPS
              and len(losses) == TSHARD_TRAINER_STEPS
              and all(math.isfinite(x) for x in losses)
              and all(r[0] == losses for r in world.results),
              f"train shard (b): {[r[0] for r in world.results]}")
        restored.mkdir()
        shutil.copytree(straight / name, restored / name)
        small = run_world(lambda rank: run(TSHARD_RESTORE_MESH,
                                           str(restored)), 2)
        for rank, (more, start, equal, _, secs2) in enumerate(small.results):
            gap = max(abs(a - b) for a, b in zip(
                more, losses[TSHARD_TRAINER_CKPT:]))
            check(start == TSHARD_TRAINER_CKPT and equal and len(more) == 2
                  and gap <= 1e-4,
                  f"train shard (b) rank {rank} of 2: restored step {start},"
                  f" blocks bitwise {equal}, losses {more} against "
                  f"{losses[TSHARD_TRAINER_CKPT:]}")
    print(f"[train-shard] (b) Trainer, {TSHARD_ARCH} at {cfg.n_layers} "
          f"layers, on the {TSHARD_MESH[0]} world: "
          f"{TSHARD_TRAINER_STEPS} steps in {secs:.1f} s (checkpoints at "
          f"steps {TSHARD_TRAINER_CKPT} and {TSHARD_TRAINER_STEPS}, "
          "gathered and written by the mesh's first rank), losses "
          + " ".join(f"{x:.6f}" for x in losses) + f"; step "
          f"{TSHARD_TRAINER_CKPT} restored onto 2 ranks of a "
          f"{TSHARD_RESTORE_MESH[0]} {TSHARD_RESTORE_MESH[1]} mesh, every "
          f"block bitwise its slice of the stored global array, 2 more "
          f"steps in {secs2:.1f} s: losses "
          + " ".join(f"{x:.6f}" for x in more) + f", max |diff| {gap:.2e} "
          f"from the straight run's (bound 1e-4); {card}")


def _paired(blocks, shardings, prefix=""):
    """(path, block, sharding) of every leaf of a tree of blocks."""
    for key in sorted(blocks):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(blocks[key], dict):
            yield from _paired(blocks[key], shardings[key], path)
        else:
            yield path, blocks[key], shardings[key]


def tshard_ssm(torch, K, card) -> dict:
    """(c): Falcon-Mamba-7B at full width cut to TSHARD_SSM_LAYERS layers,
    one sharded step against the unsharded one; causal_conv1d's launches
    counted in the ranks' run. Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, IndexedDataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.obs import metrics
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel import sharding as S
    from repro_torch.train import TrainConfig, make_train_step
    full = get_config(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TSHARD_SSM_LAYERS,
                              compute_dtype="float32")
    print(f"[train-shard] (c) config change: {SSM_ARCH} n_layers "
          f"{full.n_layers} -> {TSHARD_SSM_LAYERS}, compute_dtype "
          f"{full.compute_dtype} -> float32")
    tcfg = TrainConfig(opt=OptConfig(**TSHARD_OPT), remat="full")
    ds = IndexedDataset(DataConfig(kind="lm", vocab=cfg.vocab,
                                   seq_len=TSHARD_SSM_SEQ,
                                   global_batch=TSHARD_SSM_BATCH,
                                   seed=TRAIN_DATA_SEED))
    batch = {k: torch.as_tensor(v).cuda() for k, v in ds.batch(0).items()}
    params, made = make_lm_params(torch, cfg, "cuda", "train shard ssm")
    ref_m, ref, ref_ms, whole = _tshard_reference(torch, cfg, tcfg, params,
                                                  [batch])
    step = make_train_step(cfg, tcfg)
    plain = metrics.counter("kernels.dispatch.causal_conv1d.torch")
    plain_before = plain.value
    n_ranks = 1
    for n in TSHARD_SSM_MESH[0]:
        n_ranks *= n
    K.reset_launches()

    def rank_main(rank):
        mesh = make_mesh(*TSHARD_SSM_MESH)
        with S.use_mesh(mesh), S.use_rules(_tshard_rules(
                S, mesh, cfg, TSHARD_SSM_BATCH)):
            psh = S.tree_shardings(api.param_specs(cfg))
            p = S.local_tree(params, psh, copy=True)
            channels = p["layers"]["mamba"]["conv_w"].shape[-1]
            opt = init_opt_state(p, tcfg.opt)
            rows = {k: S.local_shard(v, S.named_sharding("batch", None))
                    for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, rows)
            got = [(float(m["loss"]), float(m["grad_norm"]))]
            ms = (time.perf_counter() - t0) * 1e3
            err = _gathered_errs(torch, S, p, psh, ref, params)
        return got, ms, err, channels, _tree_bytes(p) * 3
    world = run_world(rank_main, n_ranks)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    want = 3 * TSHARD_SSM_LAYERS * n_ranks
    check(launches["causal_conv1d"] == want
          and sum(launches.values()) == want
          and plain.value == plain_before,
          f"train shard (c): launches {launches}, plain causal_conv1d "
          f"{plain.value - plain_before}; expected {want} causal_conv1d "
          "launches and no plain call")
    di = cfg.mamba.expand * cfg.d_model
    for rank, (got_m, ms, err, channels, mine) in enumerate(world.results):
        _tshard_check("(c)", rank, ref_m, got_m, err, tcfg.opt.lr, 1)
        check(channels * TSHARD_SSM_MESH[0][1] == di,
              f"train shard (c) rank {rank}: {channels} of {di} channels")
    got_m, ms, errs, channels, mine = world.results[0]
    rel, worst, far = _param_gap(errs)
    print(f"[train-shard] (c) {SSM_ARCH} at {TSHARD_SSM_LAYERS} layers "
          f"({made}), float32, remat {tcfg.remat}: {n_ranks} threads on a "
          f"{TSHARD_SSM_MESH[0]} {TSHARD_SSM_MESH[1]} mesh, one step of "
          f"{TSHARD_SSM_BATCH} x {TSHARD_SSM_SEQ} tokens: loss "
          f"{got_m[0][0]:.6f} against {ref_m[0][0]:.6f}, grad norm "
          f"{got_m[0][1]:.6f} against {ref_m[0][1]:.6f} unsharded (bound "
          f"{TSHARD_REL} relative), params {rel:.3e} of the update apart "
          f"in norm (bound {TSHARD_UPDATE_REL}), max |diff| {worst:.3e}, "
          f"{far:,} weights over {TSHARD_FAR} apart; causal_conv1d launched "
          f"{launches['causal_conv1d']} times on the \"cuda\" route = 3 x "
          f"{TSHARD_SSM_LAYERS} layers x {n_ranks} ranks (forward, "
          f"recompute, dx) on {channels} of {di} channels a rank, its plain "
          f"version never; param + m + v {mine / 2 ** 30:.2f} GiB a rank "
          f"of {whole / 2 ** 30:.2f}; step {ms:.1f} ms sharded against "
          f"{ref_ms:.1f} ms unsharded (wall clock); {card}")
    return launches


def _tshard_world(torch, cfg, tcfg, make_params, batches, *,
                  on_host=False, world_ctx=contextlib.nullcontext):
    """(e) and (f)'s run: ``make_params()``'s params (global tensors on the
    card), the unsharded steps on ``batches``, then the sharded ones on
    TSHARD_MESH's world of threads inside ``world_ctx()``, each rank
    copying its blocks of the params to the card. ``on_host``: the params
    and the unsharded step's result wait on the host while the world runs
    (both would not fit beside it). Returns (the unsharded metrics and ms
    a step, the bytes of its params and moments, the world's results: per
    rank its metrics, param + m + v bytes, local_bytes' count of them, ms
    a step, ``_gathered_errs`` (rank 0's; the others join the gathers:
    with ``on_host`` each comparison copies the step's result to the card
    again), its Mamba channels)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.world import run_world
    from repro_torch.models import api
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel import sharding as S
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    params = make_params()
    ref_m, ref, ref_ms, whole = _tshard_reference(torch, cfg, tcfg, params,
                                                  batches)
    if on_host:
        params, ref = (tree_map(lambda t: t.detach().cpu(), x)
                       for x in (params, ref))
        gc.collect()
        torch.cuda.empty_cache()
    step = make_train_step(cfg, tcfg)

    def rank_main(rank):
        mesh = make_mesh(*TSHARD_MESH)
        with S.use_mesh(mesh), S.use_rules(_tshard_rules(S, mesh, cfg,
                                                         TSHARD_BATCH)):
            psh = S.tree_shardings(api.param_specs(cfg))
            p = tree_map(lambda t: t.cuda(),
                         S.local_tree(params, psh, copy=True))
            opt = init_opt_state(p, tcfg.opt)
            mine = 3 * _tree_bytes(p)
            want = 3 * S.local_bytes(api.param_structs(cfg), psh)
            mamba = p.get("blocks", {}).get("mamba")
            channels = mamba["conv_w"].shape[-1] if mamba else None
            rows = [{k: S.local_shard(v, S.named_sharding(
                "batch", *([None] * (v.dim() - 1)))) for k, v in b.items()}
                for b in batches]
            metrics = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in rows:
                p, opt, m = step(p, opt, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            ms = (time.perf_counter() - t0) * 1e3 / len(rows)
            del opt
            err = _gathered_errs(torch, S, p, psh, ref, params,
                                 compare=rank == 0)
        return metrics, mine, want, ms, err, channels
    with world_ctx():
        world = run_world(rank_main, TSHARD_RANKS)
    return ref_m, ref_ms, whole, world.results


def _tshard_gates(tag, results, ref_m, lr, steps):
    for rank, (got_m, mine, want, _, err, _) in enumerate(results):
        _tshard_check(tag, rank, ref_m, got_m, err, lr, steps)
        check(mine == want, f"train shard {tag} rank {rank}: param + moment "
              f"bytes {mine}, local_bytes says {want}")


def _tshard_line(results, ref_m, ref_ms, whole, tcfg) -> str:
    got_m, mine, _, ms, errs, _ = results[0]
    rel, worst, far = _param_gap(errs)
    return (
        "losses " + " ".join(f"{x[0]:.6f}" for x in got_m) + " against "
        + " ".join(f"{x[0]:.6f}" for x in ref_m) + ", grad norms "
        + " ".join(f"{x[1]:.6f}" for x in got_m) + " against "
        + " ".join(f"{x[1]:.6f}" for x in ref_m)
        + f" unsharded (bound {TSHARD_REL} relative); params after "
        f"{len(got_m)} step(s), gathered: {rel:.3e} of the update apart in "
        f"norm (bound {TSHARD_UPDATE_REL}), max |diff| {worst:.3e} (bound "
        f"{2 * tcfg.opt.lr * len(got_m)}), {far:,} weights over "
        f"{TSHARD_FAR} apart; param + m + v {mine / 2 ** 30:.3f} GiB a rank "
        f"= local_bytes, against {whole / 2 ** 30:.3f} GiB unsharded; step "
        f"{ms:.1f} ms sharded ({TSHARD_RANKS} threads, wall clock) against "
        f"{ref_ms:.1f} ms unsharded")


def tshard_encdec(torch, card):
    """(e): seamless-m4t-large-v2 at full width, its stacks cut to
    TSHARD_ENCDEC_LAYERS layers each: two FSDP + TP steps (heads, FFN and
    the tied vocabulary split) against the unsharded ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    full = get_config(TSHARD_ENCDEC_ARCH)
    cfg = dataclasses.replace(full, n_layers=TSHARD_ENCDEC_LAYERS,
                              n_encoder_layers=TSHARD_ENCDEC_LAYERS,
                              compute_dtype="float32")
    print(f"[train-shard] (e) config change: {cfg.name} n_encoder_layers "
          f"{full.n_encoder_layers} -> {cfg.n_encoder_layers}, n_layers "
          f"{full.n_layers} -> {cfg.n_layers} (full width), compute_dtype "
          f"{full.compute_dtype} -> float32 (params {cfg.param_dtype})")
    tcfg = TrainConfig(opt=OptConfig(**TSHARD_OPT), remat="full",
                       attn_impl="flash")
    d = cfg.d_model
    made = []

    def make_params():
        params = api.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(SEED), device="cuda")
        made.append(sum(t.numel() for t in _leaves(params)))
        return params
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_DATA_SEED)
    batches = [{"frames": torch.randn(
        (TSHARD_BATCH, TSHARD_ENCDEC_FRAMES, d), generator=gen,
        device="cuda"), "tokens": torch.randint(
            0, cfg.vocab, (TSHARD_BATCH, TSHARD_ENCDEC_TOKENS + 1),
            generator=gen, device="cuda")} for _ in range(TSHARD_STEPS)]
    t0 = time.perf_counter()
    ref_m, ref_ms, whole, results = _tshard_world(torch, cfg, tcfg,
                                                  make_params, batches)
    secs = time.perf_counter() - t0
    # param_count counts an untied unembedding, and no final norms
    check(made[0] == cfg.param_count() - cfg.vocab * d + 2 * d,
          f"train shard (e): {made[0]} parameters, param_count "
          f"{cfg.param_count()}")
    _tshard_gates("(e)", results, ref_m, tcfg.opt.lr, TSHARD_STEPS)
    print(f"[train-shard] (e) {cfg.name}, {cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers, d_model {d}, heads {cfg.n_heads} / "
          f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab:,} tied "
          f"({made[0]:,} parameters (float32) made on the card), float32, "
          f"remat {tcfg.remat}, attn {tcfg.attn_impl}, AdamW lr "
          f"{tcfg.opt.lr}: {TSHARD_RANKS} threads on a {TSHARD_MESH[0]} "
          f"{TSHARD_MESH[1]} mesh, {TSHARD_BATCH} rows of "
          f"{TSHARD_ENCDEC_FRAMES} frames and {TSHARD_ENCDEC_TOKENS} + 1 "
          f"tokens a step, {secs:.1f} s with both runs; "
          + _tshard_line(results, ref_m, ref_ms, whole, tcfg)
          + f"; {card}")


#: the logical dims the train rules split over "model" (every one of them
#: divides by 2 in jamba)
_MODEL_DIMS = ("heads", "kv_heads", "ffn", "vocab", "experts", "d_inner")


def tshard_hybrid_reckoning(cfg) -> dict:
    """(f)'s super-block in float32 at ``cfg``'s widths and experts: its
    parameters; GB of params + gradients + both moments, which the
    unsharded step holds and the world's ranks hold between them; one
    rank's gathered share of the super-block's weights with an embed dim
    (whole along it, halved along a dim "model" splits: FSDP gathers them
    at once, and their gradient comes out whole in the backward) and of
    the two tables; and the world's reckoned peak: the state and, on
    each of the 8 ranks, the share twice (weights, gradients) and the
    tables."""
    from repro_torch.models import api
    from repro_torch.train.train_step import paths_of_specs
    from repro_torch.tree import paths
    specs = dict(paths_of_specs(api.param_specs(cfg)))
    share = tables = n = 0
    for key, t in paths(api.param_structs(cfg)):
        n += t.numel()
        names = specs[key]
        half = 2 if any(x in _MODEL_DIMS for x in names) else 1
        if "embed" in names:
            share += 4 * t.numel() / half / 1e9
        elif "embed_table" in names:
            tables += 4 * t.numel() / half / 1e9
    state = 16 * n / 1e9
    return {"params": n, "state": state, "share": share, "tables": tables,
            "peak": state + TSHARD_RANKS * (2 * share + tables)}


def tshard_hybrid(torch, K, card) -> dict:
    """(f): jamba-v0.1-52b at full width, one super-block, its experts and
    FFN width cut (TSHARD_HYBRID_*): one FSDP + TP + EP step against the
    unsharded one, whose params and result wait on the host while the
    world runs; causal_conv1d launched on the "cuda" route 3 times a Mamba
    sublayer a rank and its plain version never, EP's all-to-all reached
    (the world's collectives counted by ``roofline.count``). Returns the
    world's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.obs import metrics
    from repro_torch.optim import OptConfig
    from repro_torch.roofline import count as roofline
    from repro_torch.train import TrainConfig
    full = get_config(TSHARD_HYBRID_ARCH)
    one = dataclasses.replace(full, n_layers=full.attn_period,
                              compute_dtype="float32",
                              moe=dataclasses.replace(
                                  full.moe, num_experts=TSHARD_HYBRID_EXPERTS,
                                  capacity_factor=TSHARD_HYBRID_EXPERTS
                                  / full.moe.top_k))
    cfg = dataclasses.replace(one, d_ff=TSHARD_HYBRID_FF, moe=dataclasses
                              .replace(one.moe, d_ff=TSHARD_HYBRID_FF))
    wide, cut = tshard_hybrid_reckoning(one), tshard_hybrid_reckoning(cfg)
    free = torch.cuda.mem_get_info()[0] / 1e9
    print(f"[train-shard] (f) config change: {cfg.name} n_layers "
          f"{full.n_layers} -> {cfg.n_layers} (one super-block), experts "
          f"{full.moe.num_experts} -> {cfg.moe.num_experts} (top-"
          f"{cfg.moe.top_k}, capacity factor {full.moe.capacity_factor} -> "
          f"{cfg.moe.capacity_factor}: nothing drops), d_ff and the experts' "
          f"d_ff {full.d_ff} -> {cfg.d_ff}, compute_dtype "
          f"{full.compute_dtype} -> float32 (params {cfg.param_dtype}). "
          f"Reckoned in float32 with 2 experts at d_ff {one.d_ff}: "
          f"{wide['params'] / 1e9:.2f} G parameters, {wide['state']:.1f} GB "
          f"of params, gradients and moments, which the world's ranks hold "
          f"between them as the unsharded step does, and a rank's gathered "
          f"share of the super-block {wide['share']:.2f} GB and of the "
          f"tables {wide['tables']:.2f} GB, held by all {TSHARD_RANKS} "
          f"ranks at once: the world's peak reckoned {wide['peak']:.1f} GB "
          f"against {free:.1f} GB free less 8; at d_ff {cfg.d_ff}: "
          f"{cut['params'] / 1e9:.2f} G parameters, {cut['state']:.1f} GB, "
          f"a rank's share {cut['share']:.2f} + {cut['tables']:.2f} GB, the "
          f"peak reckoned {cut['peak']:.1f} GB")
    check(wide["peak"] > free - 8 >= cut["peak"],
          f"train shard (f): reckoned {wide['peak']:.1f} GB at d_ff "
          f"{one.d_ff} and {cut['peak']:.1f} GB at {cfg.d_ff} against "
          f"{free:.1f} GB free: the cut is no longer what fits")
    tcfg = TrainConfig(opt=OptConfig(**TSHARD_OPT), remat="full",
                       attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_DATA_SEED)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (TSHARD_BATCH, TSHARD_HYBRID_SEQ + 1), generator=gen,
        device="cuda")}
    made, counted = [], []

    def make_params():
        params, text = make_lm_params(torch, cfg, "cuda", "train shard (f)")
        made.append(text)
        return params

    @contextlib.contextmanager
    def world_ctx():
        K.reset_launches()
        with roofline.counting(flops=False) as c:
            counted.append(c)
            yield
    plain = metrics.counter("kernels.dispatch.causal_conv1d.torch")
    plain_before = plain.value
    torch.cuda.reset_peak_memory_stats()
    ref_m, ref_ms, whole, results = _tshard_world(
        torch, cfg, tcfg, make_params, [batch], on_host=True,
        world_ctx=world_ctx)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k.__name__: k.launches for k in K.KERNELS}
    nm = cfg.attn_period - 1
    want = 3 * nm * TSHARD_RANKS
    check(launches["causal_conv1d"] == want
          and sum(launches.values()) == want
          and plain.value == plain_before,
          f"train shard (f): launches {launches}, plain causal_conv1d "
          f"{plain.value - plain_before}; expected {want} causal_conv1d "
          f"launches (3 x {nm} Mamba sublayers x {TSHARD_RANKS} ranks) and "
          "no plain call")
    _tshard_gates("(f)", results, ref_m, tcfg.opt.lr, 1)
    di = cfg.mamba.expand * cfg.d_model
    for rank, r in enumerate(results):
        check(r[5] * TSHARD_MESH[0][-1] == di,
              f"train shard (f) rank {rank}: {r[5]} of {di} channels")
    coll = counted[0].collective_bytes()
    a2a = sum(1 for x in counted[0].collectives if x.kind == "all-to-all")
    check(a2a > 0, f"train shard (f): no all-to-all in the world's "
                   f"collectives {coll}")
    print(f"[train-shard] (f) {cfg.name}, one super-block ({nm} Mamba, 1 "
          f"attention, {cfg.moe.num_experts} experts top-{cfg.moe.top_k}), "
          f"d_model {cfg.d_model}, d_inner {di}, heads {cfg.n_heads} / "
          f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab:,} "
          f"({made[0]}), float32, remat {tcfg.remat}: {TSHARD_RANKS} "
          f"threads on a {TSHARD_MESH[0]} {TSHARD_MESH[1]} mesh, one step of "
          f"{TSHARD_BATCH} x {TSHARD_HYBRID_SEQ} tokens, the unsharded "
          f"step's params on the host while the world ran; "
          + _tshard_line(results, ref_m, ref_ms, whole, tcfg)
          + f"; causal_conv1d launched {launches['causal_conv1d']} times in "
          f"the world on the \"cuda\" route = 3 x {nm} Mamba sublayers x "
          f"{TSHARD_RANKS} ranks (forward, recompute, dx) on "
          f"{results[0][5]} of {di} channels a rank, its plain version "
          f"never; the world's collectives (all ranks, roofline.count): "
          f"{coll['calls']} calls, {a2a} all-to-all (EP), "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                      coll["by_kind"].items())
          + f"; peak allocated {peak:.1f} GB (reckoned {cut['peak']:.1f});"
          f" {card}")
    return launches


def _device_only_rows(torch, fn, calls):
    from repro_torch.tune.runner import device_kernels as per_call
    try:
        return per_call(fn, calls=calls, device_only=True)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e


@contextlib.contextmanager
def phase_clock(name: str):
    """Print the wall time of the phase run inside the block."""
    t0 = time.perf_counter()
    yield
    print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[device] FAIL: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {kind}, {count} visible; nvidia-smi name,power.limit:")
    print(card)
    dev = torch.device("cuda")

    info = _build.build()
    _build.library()
    log = (_build.BUILD_DIR / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln] if info["built"] else []
    print(f"[build] {'built' if info['built'] else 'up to date'} "
          f"{info['path'].relative_to(ROOT)} in {info['seconds']:.1f} s; "
          + " | ".join(regs))
    # ptxas's report of the build that made the library (this run's, or
    # the one an earlier process made from the same sources)
    from repro_torch.check.footprint import ptxas_report
    for line in ptxas_report(log, TILED_KERNELS):
        print(f"[build] {line}")

    rng = np.random.default_rng(SEED)
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    with phase_clock("3 kernels"):
        per_kernel = phase_kernels(torch, K, dev, kind, rng)
    with phase_clock("check"):
        built = phase_check(torch, K, card, rng)
    resolved = {}
    with recording_configs(resolved):
        with phase_clock("4 plan"):
            plans = {name: phase_plan(torch, K, name, built[name])
                     for name in PLANS}
        del built
        with phase_clock("5 serve"):
            for p in SERVED:
                add(phase_serve(torch, K, p, plans[p][0], card, rng))
        # phases 8 and 9 run before the LM phases: in three of seven runs,
        # at the start of phase 8 right after a large LM was freed,
        # torch.profiler sessions recorded nothing for over 18 s
        with phase_clock("8 tune"):
            add(phase_tune(torch, K, card, {name: plans[name]
                                            for name in TUNED_PLANS}))
        chaos_plan = plans["dws"][0]    # served again in the chaos phase
        del plans
        with phase_clock("9 cnn-flow"):
            add(phase_cnn_flow(torch, K, card))
    with phase_clock("check configs"):
        phase_check_configs(torch, card, resolved)
    with phase_clock("6 lm"):
        lm_launches, lm_prompts, lm_params = phase_lm(torch, K, card, rng)
        add(lm_launches)
    with phase_clock("chaos"):
        add(phase_chaos(torch, K, card, lm_params, lm_prompts, chaos_plan))
    del lm_params, chaos_plan
    gc.collect()
    torch.cuda.empty_cache()    # phase 6's model is gone; 7.27 B params next
    with phase_clock("7 ssm"):
        add(phase_ssm(torch, K, card, rng))
    integer = [k for k in launches if not k.endswith("_f")]
    check(all(launches[k] > 0 for k in integer),
          f"serve: a kernel was never launched: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was never launched: {launches}")
    torch.cuda.empty_cache()    # phase 7's model is gone
    sweep = DryrunSweep()       # phase 13's, beside phases 10-12
    try:
        with phase_clock("10 families"):
            add(phase_families(torch, K, card, lm_prompts))
        torch.cuda.empty_cache()    # phase 10's last model is gone
        with phase_clock("11 encdec-hybrid"):
            add(phase_encdec_hybrid(torch, K, card, lm_prompts))
        gc.collect()
        torch.cuda.empty_cache()    # phase 11's last model is gone
        with phase_clock("12 train"):
            add(phase_train(torch, K, card, lm_prompts))
        gc.collect()
        torch.cuda.empty_cache()    # phase 12's models are gone
        with phase_clock("13 launch"):
            add(phase_launch(torch, K, card, sweep))
    finally:
        sweep.stop()
    with phase_clock("14 shard"):
        add(phase_shard(torch, K, card))
    gc.collect()
    torch.cuda.empty_cache()    # phase 14's models are gone
    with phase_clock("15 train-shard"):
        add(phase_train_shard(torch, K, card))
    print(f"[time] the run so far {time.perf_counter() - t_start:.1f} s")

    rows = []
    for kernel, (wrapper, source, replaces) in SOURCES.items():
        r = per_kernel[kernel]
        rows.append({
            "name": wrapper, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[wrapper],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["library_ms"]})
    print("# per kernel: ms, plain_ms and library_ms are device times "
          "(torch.profiler) and bound_ms the larger of the HBM and the "
          "operations floor, each summed over that kernel's launches in one "
          "256-image forward of the dws plan (the shift and add plans for "
          "the shift and add kernels; the W4 rows in the W4 plans, bytes "
          "counting the packed weights), and for matmul_q8 and matmul_w4 "
          "over the 72 launches of one Qwen2-0.5B decode step at 8 slots "
          "(library: torch._int_mm), and for causal_conv1d over the 64 "
          "launches of one 96-token Falcon-Mamba-7B prefill (1 x 96 x 8192 "
          "bf16, the in_proj view; library: cuDNN conv1d, groups=D); the float rows (*_f) "
          "over the tuner's float32 Table-2 jobs of that kernel, one launch "
          "each (pool: the tuner's float pool job; library: cuDNN conv2d, "
          "amax, torch.cdist(p=1), torch.matmul, TF32 off); launches are "
          "summed over the six served CNN runs, phase 6's LM runs "
          "(contiguous, paged, static), the ssm run, the families runs "
          "the tuner's run "
          "(phase 8) and the five trained plans' "
          f"forwards and profiles (phase 9), the families runs (phase "
          f"10: internvl2-1b and granite-3-2b in int8 and w4a8), the "
          f"hybrid runs' prefills (phase 11: jamba-v0.1-52b, 7 "
          f"causal_conv1d launches a super-block), the Falcon-Mamba "
          f"train steps (phase 12: 3 causal_conv1d launches a layer a "
          f"step) and the counted roofline steps (phase 13: Qwen2-0.5B's "
          f"int8 decode step, 72 matmul_q8, and an {ROOF_SSM_LAYERS}-layer "
          f"Falcon-Mamba prefill, {ROOF_SSM_LAYERS} causal_conv1d) and the "
          f"shard phase's prefills (phase 14: {SHARD_SSM_LAYERS} "
          f"causal_conv1d a rank on {SHARD_RANKS} ranks) and the sharded "
          f"Falcon-Mamba train step (phase 15: 3 causal_conv1d a layer a "
          f"rank, {TSHARD_SSM_LAYERS} layers on 4 ranks) and the sharded "
          f"jamba super-block's step (phase 15: 3 a Mamba sublayer a rank, "
          f"7 sublayers on {TSHARD_RANKS} ranks); card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
