#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout.  It needs one CUDA card, ``nvcc`` and
nothing of JAX.  Phases, each fatal (an exception or a failed check exits
non-zero):

1. build   -- compile ``src/repro_torch/csrc/arena.cu``,
              ``flash_attention.cu``, ``flash_decode.cu``,
              ``flash_prefill_sm90.cu``, ``flash_backward.cu``,
              ``flash_backward_sm90.cu``, ``wkv6.cu`` and ``rglru.cu``,
              and the RG-LRU control (a copy of ``rglru.cu`` whose
              backward drops a_(t+1) in one block, RGLRU_CONTROL_EDIT)
              (nvcc, sm_90a, all nine started together) and print the
              build seconds of each, the registers, shared memory and
              spills (``-Xptxas -v``) of the arena kernels (accum among
              them), the WKV-6 and RG-LRU kernels (the RG-LRU backward
              among them) and the four newer flash kernels (both backward
              kernels at D 64, 128 and 256), the card's name and power
              limit;
2. kernels -- hold each arena kernel against its plain PyTorch version on
              the card.  write and read (one vectorised byte copy split by
              ``copy_plan``), f32 and u8: every destination phase x source
              phase mod 16 the dtype allows (u8: all 256 pairs up to 65
              elements, the multiples of 4 beyond), lengths 0, 1, 3, 15,
              16, 17, 63, 64, 65, 4097 and 150,528 elements (the largest
              tensor of the DARTS cell) and one llama3.2-1b KV leaf of
              17,301,504 B, x, arena and out as views at a storage offset,
              read also into an out view through its C entry: bit-equal,
              the bytes around the slice and the sources unchanged, the
              cases counted per (op, dtype, mode); a split that does not
              fit its addresses refused.  accum (the same split over f32)
              at every arena phase x x phase mod 16 bytes, x a view at a
              storage offset, at the f32 lengths above: bit-equal to the
              plain version, the floats around the slice and x unchanged;
              a split that does not fit its addresses, or is not whole
              floats, refused.  chain_write (the same split) of every
              single op and five longer chains at every arena phase x x
              phase mod 16 bytes, at the f32 lengths above: exact chains
              bit-equal to the plain version, the rest allclose, the floats
              around the slice and x unchanged; a split that does not fit
              its addresses, or is not whole floats, refused (its launch
              raises).  accum and the exact chain ops also
              bit-equal at random offsets and lengths 0, 1, 3, 4097 and
              150,528, the transcendental chain ops allclose; n == 0
              launches nothing;
3. flash   -- hold the three flash-attention kernels (the split-K
              decode, the ``wgmma`` prefill and the simple kernel) against
              the plain PyTorch version (``impl="torch"``) and the oracle
              (``impl="ref"``) on the card, each case through every kernel
              that takes it (the simple kernel takes all; the decode kernel
              Sq * G <= 16; the prefill kernel bf16 at 64/64, 128/128,
              192/128 and 256/256, its second launch bit-equal to its
              first): bf16 and f32, every (D, Dv) the wrapper takes
              (16/16, 64/64, 128/128, 192/128, 256/256), GQA groups 1 and 4,
              decode over caches of 1/127/1056/4097 keys, causal prefill of
              1/33/1024 tokens, a sliding window, a prefill against a
              partly filled cache, non-causal attention (with a window, and
              against a partly filled cache), batch 2 at decode and
              prefill, and a cache whose tail beyond kv_len holds garbage
              that must not leak; then
              recurrentgemma-2b's multi-query shape (D 256, G 10, KV 1,
              window 2048): decode over 2592 keys, causal prefill of 2560,
              a garbage tail; f32 within rtol 1e-5 + atol 1e-5, bf16 within
              one bf16 ulp of the output + 1e-5.  Then the split-K decode's
              partials (m, l, acc of each split, at its own rule and at 7
              and 64 splits) against ``flash_decode_partials_torch`` and its
              output against ``flash_decode_combine_torch``, with splits
              fully masked for some rows and a row masked in every split
              (output 0, no NaN); and the launch a captured decode step
              makes, the position on the device and the capacity split
              rule, at llama3.2-1b's and recurrentgemma-2b's served caches
              and a small f32 one, at positions from 0 to the last: the
              rule's splits, partials and output against the plain
              versions with a tensor position and the oracle, and bit-equal
              to the host-position launch wherever the host rule splits
              alike; and the launch a batched decode step makes, a
              position per batch row (buckets 4 and 8 of llama3.2-1b's
              cache, 4 of recurrentgemma-2b's with rows cut by the
              window, a small f32 one): partials and output against the
              plain versions at the same positions and the oracle, each
              row against the oracle of the row alone, and every row at
              one position bit-equal to the 0-d launch; and the decode
              past 16 rows, in row blocks of 16, at granite-20b's shape
              (H 48, KV 1, D 128, cache 1056), bf16 and f32: host
              positions (with a garbage tail), 0-d device positions from
              0 to the last and a position per row of bucket 4, the
              cache beyond each position garbage, partials and output
              against the plain versions and the oracle (and 2 queries
              of 24 heads, row blocks across the queries, with a
              window);
4. wkv6    -- hold the WKV-6 kernel against its plain version on the card:
              bf16 and f32, N 16/32/64, batch 1 at T 1/7/256/1000/1024
              with and without an initial state, and batch 2 at T 1000
              and 3 chunks + 5 steps (T 7, 1000 and that one end in a
              ragged chunk): outputs within the flash phase's tolerances
              plus the rounding bound of two f32 sums of N + 1 terms
              (2 (N + 1) 2^-24 times the terms' magnitudes), final states
              bit-equal; a split run (T/2 + T/2, the state threaded), a
              run of T 7 one step a launch (the one-step path) and a run
              whose final state overwrites its initial state in place
              equal the whole run bit for bit;
5. rglru   -- the same for the RG-LRU kernels: gx bf16 and f32, D 16, 37
              (rows not 16-byte aligned), 40 (a ragged group of channels)
              at batch 2 and 2560 at batch 1, T 1, 5, the route threshold
              and one either side, a chunk and one either side, and 2560,
              with and without h0; every case through both kernels (the
              staged and the step kernel), which must agree bit for bit on
              h and hT; h within the same tolerances of the plain version,
              hT within rtol 1e-5 + atol 1e-5 (the bit-equal share is
              printed); in-place runs and runs split in two (at the middle,
              and after the threshold's steps, across the route boundary)
              bit-equal to the whole run;
6. main    -- plan every paper graph and full network with SERENITY and
              execute it in one arena on the card, slice-per-node and fused:
              realized == planned bytes, slice path bit-equal to
              ``run_reference`` on the card, fused path bit-equal where every
              fused chain is exact (else allclose), the planner's known
              integers, a uint8 pack/unpack round trip; then every one
              again with ``jit=True`` (one CUDA graph per program, the
              counterpart of ``repro``'s whole-program jit), slice and
              fused: the first call, a replay and a replay with other
              inputs bit-equal to the eager runs and held to
              ``run_reference`` as they are, a replay's outputs not
              overwritten by the next, realized == planned, and the arena
              launches per replay, as the capture counted them and in the
              most complete of three or more traces of a replay (up to
              ``TRACE_TRIES``), equal to the eager run's; each of the four kernels launched > 0 times over the
              run;
7. serve   -- the serving path, once per model at its published width
              (random weights from a seed; for ``rwkv6-7b`` and
              ``recurrentgemma-2b`` the recurrent mixing leaves, zeros or
              ones at init, filled with seeded values so that the carried
              state matters, which is checked) behind ``run_server``, 4
              requests of 32 generated tokens under the CLI's default
              budget: ``llama3.2-1b`` and ``rwkv6-7b`` with 1024 prompt
              tokens, ``recurrentgemma-2b`` with 2560 (longer than its
              2048-key window), every decode token through the server's
              one captured decode step (a CUDA graph for every position):
              the decode plan's integers, 4 served and
              128 tokens, tokens bit-equal to an eager prefill + decode
              loop that keeps the cache as plain tensors, the first decode
              steps' logits of the kernels allclose to the plain versions' (in
              f32, and in bf16 as served), every
              kernel's launches over the run exactly the path's count (an
              attention layer: one ``wgmma`` prefill per request and one
              split-K decode per decode step, the simple kernel never; an
              RG-LRU layer: one staged launch per prompt and one step
              launch per decode step), and
              one prefilled cache packed and unpacked at the served plan by
              the u8 kernels bit-equal to their plain versions; then the
              batched decode (``step_mode="vmap"``, one captured step per
              bucket): the same 4 requests, and the first 3 (bucket 4 with
              a padding row reserved as scratch), their tokens equal to
              the serial run's up to a first divergence at a step whose
              serial top-1 margin is under the model's bf16 logit
              tolerance, every kernel's launches over each run exactly
              the batched path's count, the peak reserved bytes 4 arenas,
              and the logits of LOGIT_STEPS batched steps of 4 rows at
              their own positions against each row's serial step (f32,
              and bf16 as served at the model's tolerance); then this
              slice's decoders at published width, one at a time:
              ``granite-moe-3b-a800m`` through the same checks, the
              timing phase and the vmap run (its logits held with each
              plain run routed and gated as its kernels' run, the
              routing flips counted with their top-K margins, which must
              lie within ROUTE_TIE, and deliberately broken decode
              kernels (CONTROLS) reading above each logit atol), and
              ``gemma-7b``, ``starcoder2-7b``, ``granite-20b`` and
              ``chameleon-34b`` lighter: the plan's integers, launches,
              served packing, tokens bit-equal to the arena-free loop,
              bf16 logits against the plain versions at their own atol,
              f32 logits at a cut depth (CUT_LAYERS) at CUT_ATOL32, with
              the controls above each, and the
              timing phase's prefill and decode times (granite-20b's
              decode runs the row-blocked kernel, timed at its served
              shapes beside its bound, plain version and SDPA);
8. timing  -- microseconds per ``execute`` of the two full networks, eager
              and captured (``jit=True``) in turns, each with the device's
              busy time and idle share, and per
              kernel at the launches the main paths made: the kernel, its
              bound, its plain version and the one torch call that computes
              the same (a yardstick, never called by the port), for write
              and read also cold (L2 flushed before each launch) and inside
              a replayed CUDA graph of the launches beside ``copy_`` there;
              for each served model its prefill ms per request, ms per
              decode token captured (the server) and eager (the same
              token's unpack, eager step and pack),
              the device's busy time and idle share over one prefill (with
              its largest kernels) and one decode step and
              its launches (no more device activities per decode token than
              ``ACTIVITIES``, in a trace that holds all of them), the u8
              arena write/read at the served leaves (one launch of each
              per leaf a decode token, by the launch counts; the kernels
              found by name in a trace of their own; replayed warm (each
              time from a trace that holds every launch, else not
              measured) and with L2 flushed before each launch, against
              the bound, the plain version and one torch copy), and its
              recurrence or
              attention kernel at
              decode and prefill shapes (attention: the routed kernel, the
              decode kernel at a device position, the
              simple kernel, the plain version and SDPA; RG-LRU: also both
              kernels at the prefill shape); chain_write beside ``copy_``
              of the same bytes, a floor of its launch; and for each
              served model the batched tick at bucket 4: ms per tick and
              per token, its launches (the captured step's recorded counts
              plus one u8 read and write a leaf and row, checked), device
              busy time, idle share and activities (no limit), each
              kernel's us per launch in the tick's trace (the kernels
              JSON rows' ``batched``), and the row staging copies against
              their bound.

9. train   -- the training path, the serving models' weights freed.
              First the optimizer kernels (``csrc/adamw.cu``,
              ``check_optim_kernels``): ``sumsq_kernel`` and
              ``adamw_update_kernel`` against their plain versions at
              llama3.2-1b's full-width leaves over OPTIM_UPDATES updates
              and on the ragged set (OPTIM_RAGGED, f32 and bf16, every
              other leaf off 16-byte alignment): the update bit-equal in
              every leaf given the same scale, each leaf's squared sum
              within SUMSQ_RTOL of torch's and bit-equal to a second run
              (on the ragged set both kernels bit-equal to their order
              emulated in torch too), the two controls
              (OPTIM_CONTROL_EDITS) above their limits in leaf 0 only;
              their times beside their bounds, plain versions and two
              timing references.  Then the Adafactor kernels
              (``csrc/adafactor.cu``, ``check_adafactor_kernels``): the
              three kernels on the ragged set (ADAFACTOR_RAGGED, 1-D to
              4-D, f32 and bf16, every other leaf off 16-byte alignment)
              and at deepseek-v3-671b's 31 full-width leaves over
              ADAFACTOR_UPDATES updates: the moments within
              ADAFACTOR_MOMENT_RTOL and each leaf's parameters within
              ADAFACTOR_P_RTOL of the update of the plain version, bit-
              equal to their order emulated in torch on the card and to a
              second run; the split route that sharded leaves take (the
              raw sums, then the moments from them: ``adafactor_sums``
              twice) bit-equal to the fused one, its raw sums and moments
              bit-equal to their order emulated on the card; the two
              controls (ADAFACTOR_CONTROL_EDITS) above
              their limits in leaf 0 only; their times beside their
              bounds, the plain update, the norm and
              ``torch.optim.Adafactor``; deepseek-v3-671b's step at
              DEEPSEEK_CLI_LAYERS captured against eager
              (ADAFACTOR_CAPTURED_STEPS each).  Then llama3.2-1b's train step captured
              in one CUDA graph (``captured_train_compare``:
              CAPTURED_STEPS captured steps bit-equal to as many eager
              ones in loss, grad_norm, lr and the final state, launches a
              replay the eager step's, ms a step, idle share and peaks).
              Then, at
              llama3.2-1b's heads (H 32, KV 8, D 64) with B 8 x S 256 and
              the ragged S 200 and 17, bf16 and f32, the forward kernel's
              output against ``_flash_torch`` and ``attention_ref`` (the
              flash tolerance) and both flash backward kernels against
              their plain version (``flash_attention_backward_torch``; f32
              within 1e-4 of each gradient's largest magnitude, bf16
              within 4 ulps of it): the tensor-core kernel
              (``flash_backward_sm90.cu``, the bf16 route) in bf16, the
              CUDA-core kernel (``flash_backward.cu``, the f32 route) in
              both; the tensor-core kernel against the CUDA-core one in
              bf16 (the readings printed) and two runs of it bit-equal;
              and ``FlashAttentionFn`` against
              autograd of the plain forward (f32 at (2, 200), bf16 at
              (8, 256), the prefill route); the full-width llama3.2-1b
              gradient through the kernels against the plain versions',
              leaf by leaf and layer by layer (relative L2 within 3e-2),
              and a deliberately broken backward reading above that; one
              full-width train step through the kernels
              (impl="auto": the ``wgmma`` prefill forward, the tensor-core
              backward) against the same step through the plain versions
              (loss and grad_norm within the bf16 logit tolerance), with
              the config's ``remat="block"``: 32 ``flash_prefill`` (each
              block's forward again in the backward) and 16
              ``flash_backward`` launches, the backward's all on the
              tensor-core route; the step's ms (host clock,
              ending in ``synchronize``), tokens/s, model FLOPs' share of
              989 TFLOP/s, device busy time and idle share, peak memory;
              ``cfg.remat`` at "none", "block" and "dots" on the same
              step: loss and every gradient leaf bit-equal to "none"'s
              under deterministic algorithms, then steps in turns (ms a
              step, median and min of TIMED_STEPS, the allocator's peak,
              the parts by CUDA events, launches a step exactly 16 / 32 / 32
              ``flash_prefill`` and 16 ``flash_backward``);
              ``launch/train.py``'s ``main`` in process for 7 steps at the
              CLI's defaults (batch 8, seq 256, AdamW, bf16) at published
              width, 2 layers deep (``--layers``: the checkpoints' disk
              writes), with a checkpoint at step 4, its launches counted
              from 0 (4 x 7 ``flash_prefill`` and 2 x 7
              ``flash_backward``, the backward's on the tensor-core
              route), every loss
              finite, and a second run
              resumed from that checkpoint alone, whose parameters and
              optimizer state end bit-equal to the first's (both under
              ``torch.use_deterministic_algorithms(True)``); and the
              flash forward and backward
              at the step's shape against their bounds, their plain
              versions and SDPA's forward and backward, the two backward
              kernels timed in turns (CUDA-core, tensor-core, tensor-core,
              CUDA-core).  Then Griffin: the RG-LRU backward kernel
              (``rglru_backward_cuda``) against ``rglru_backward_torch``
              at D 2560, (B, T) in RG_BWD_CASES, gx f32 and bf16, with and
              without h0 (and dhT): each gradient within RG_BWD_RTOL of
              its largest (the bit-equal cases counted), two runs
              bit-equal, the control above the limit in its block only;
              both flash backward kernels at Griffin's heads (H 10, KV 1,
              (256, 256)) with windows (GRIFFIN_BWD_CASES), f32 within
              1e-4, bf16 within 4 ulps, the window one key too wide
              reading above that (GRIFFIN_CONTROL_CASES), and
              ``FlashAttentionFn`` with a window against autograd;
              recurrentgemma-2b at full width (the recurrent mixing
              leaves filled from a seed): its gradient through the
              kernels against impl="torch", leaf by leaf and layer by
              layer (within GRIFFIN_GRAD_RTOL, the RG-LRU control in the
              last recurrent layer's launch and the last attention layer's
              dK zeroed above it),
              one step through the kernels against the plain step (loss
              and grad_norm within TRAIN_ATOL) with exactly 16
              ``flash_prefill``, 8 ``flash_backward`` (tensor-core), 34
              staged ``rglru`` and 18 ``rglru_backward`` launches
              (``train_launches``), ms a step, tokens/s, idle share and
              peak memory, ``launch/train.py``'s ``main`` for
              GRIFFIN_STEPS steps at published width, GRIFFIN_CLI_LAYERS
              deep (a checkpoint at GRIFFIN_CKPT_EVERY, every loss finite,
              launches counted) and the resume from that checkpoint
              bit-equal; then the RG-LRU backward and the flash backward
              at Griffin's training shapes timed beside their bounds,
              plain versions and SDPA's backward (each in a replayed CUDA
              graph).  Then RWKV-6: the WKV-6 backward kernel
              (``wkv6_backward_cuda``) against ``wkv6_backward_torch`` at
              H 64, N 64, (B, T) in WKV_BWD_CASES, f32 and bf16, with and
              without s0 and dsT (f32 within WKV_BWD_RTOL of each
              gradient's largest, bf16 within one ulp of each element
              plus that), two runs bit-equal, the control
              (WKV6_CONTROL_EDIT) above the limit in its block only;
              rwkv6-7b at published width, RWKV_LAYERS of 32 layers deep,
              through the same steps as Griffin (``family_train``: the
              gradient within RWKV_GRAD_RTOL, its two controls above it,
              one step with exactly 2L ``wkv6`` and L ``wkv6_backward``,
              the step's time and peaks, the CLI at RWKV_CLI_LAYERS and
              its bit-equal resume); the backward timed beside its bound
              and plain version.  Then the dense and MoE decoders
              (``decoders_train``): both flash backward kernels at (128,
              128), the heads of starcoder2-7b (G 9 over KV 4) and
              granite-20b (G 48 over one KV head), (B, S) in BWD_CASES,
              without a window and with D128_WINDOW, f32 within 1e-4,
              bf16 within 4 ulps, two tensor-core runs bit-equal, KV head
              0's dK zeroed above the limit, ``FlashAttentionFn`` at D 128
              against autograd; starcoder2-7b (STARCODER2_LAYERS of 32
              layers), granite-moe-3b-a800m (all 32; its gradient check
              with the kernels' runs forced to the plain run's expert ids,
              gates their own, the flips printed) and gemma-7b
              (GEMMA_LAYERS of 28) at published width through the same
              steps (``family_train``: the gradient within the family's
              DECODER_GRAD_RTOL, the last layer's dK zeroed above it, one
              step with exactly 2L ``flash_prefill`` and L
              ``flash_backward``, all on the tensor-core route, its time
              and peaks, the CLI at DECODER_CLI_LAYERS and its bit-equal
              resume); granite-20b's and chameleon-34b's gradient checks
              alone at 2 layers (``family_grads``); the (128, 128)
              backward at the three models' heads timed beside its bound,
              its plain version and SDPA's backward, the block's seconds
              by part.  Then the last two families
              (``last_families_train``): both flash backward kernels
              non-causal at (64, 64) (NONCAUSAL_HEADS, (B, (Sq, Skv)) in
              NONCAUSAL_CASES) and causal at (192, 128) at MLA's scale
              (MLA_HEADS, MLA_CASES), f32 within 1e-4, bf16 within 4
              ulps, two tensor-core runs bit-equal, a control above the
              limit in every case (non-causal: the kernel run causal,
              dK's last key tile or dQ's last query tile zeroed; (192,
              128): dV's last 64 columns zeroed), ``FlashAttentionFn``
              of each form against autograd; seamless-m4t-medium (all 12
              + 12 layers, AdamW; the gradient check's frames
              SEAMLESS_GRAD_FRAMES rows against the tokens' 256) and
              deepseek-v3-671b (DEEPSEEK_LAYERS dense layers and the MTP
              block, its config's Adafactor) at published width through
              ``family_train`` (the gradient within LAST_GRAD_RTOL, two
              controls each above it, one step with exactly
              ``train_launches``' launches, all on the tensor-core route,
              its time, the optimizer's time beside its bound, peaks, the
              CLI and its bit-equal resume); the new forms' backward timed
              at the training shapes beside the bound, the plain version
              and SDPA's backward.  Last the CLI block: every family's CLI
              run and its bit-equal resume (``cli_run_and_replay``, each
              step a replay of ``launch/steps.py:CapturedTrainStep``,
              launches ``train_launches``' with one ``sumsq`` a step and
              one ``adamw_update`` (AdamW) or one of each Adafactor kernel
              (deepseek-v3-671b)), gathered
              from ``family_train`` (CLI_QUEUE) so that the fleet's host
              runs (phase 13, ``FleetRuns``) go beside it.

11. a7     -- (run after phase 7's decoders) this slice's families:
              first each new attention shape, bf16 and f32, through the
              routed kernel and every other kernel that takes it, against
              the plain version and the oracle at the flash phase's
              tolerance: ``seamless-m4t-medium``'s non-causal encoder
              prefill (1024 frames, 16 heads of 64), its non-causal
              cross-attention prefill (1024 tokens over 1024 frames, and
              700 over 1000), its cross-attention decode over the padded
              encoder buffer (1056 rows) at a kv_len on the device (int32,
              0-d, and (4,) with lengths 1024, 1000, 517 and 33: the
              split-K partials against the plain partials, garbage past
              each length not leaking, one launch captured and replayed
              at other lengths bit-equal to eager launches), and
              ``deepseek-v3-671b``'s expanded MLA prefill at (D, Dv) =
              (192, 128), 128 heads, its softmax scale 192^-0.5 (the
              ``wgmma`` prefill in bf16, the simple kernel in f32 and held
              in bf16 too); a second launch of each kernel at a host
              position bit-equal to its first; each timed beside its
              bound, its plain version, SDPA and, where the call is
              routed elsewhere, the simple kernel.  Then each model
              served as in phase 7
              (the plan's integers, 4 requests of 1024 tokens + 32,
              seamless's with 1024 frames each, launches exactly the
              path's, served packing, tokens bit-equal to the arena-free
              loop, logits of the kernels against the plain versions with
              the model's deliberately broken kernels above each limit),
              its timing (prefill ms, captured and eager ms per token,
              idle share, activities, the weight-read bound) and its vmap
              phase: ``seamless-m4t-medium`` at full width and depth (f32
              logits at full depth), ``deepseek-v3-671b`` at published
              width with its depth cut to 4 of 61 layers (3 dense, one MoE
              of 256 experts; each plain run routed and gated as its
              kernels' run) and its f32 logits at 2 layers (one dense, one
              MoE) once the bf16 weights are freed.

10. bridge -- (run after phase 6) the graph bridge
              (``repro_torch/core/fx_bridge.py``): each function of
              ``repro_torch/graphs/programs.py`` (``wide`` at x 64 x 64,
              the rest at the bench's 64 x 128 f32, ``nas_cell`` also at
              2048 x 1024, a 76 MB arena) traced to aten, scheduled
              (host seconds printed) and run by ``compile_scheduled``
              through one planned uint8 arena on the card, eagerly and
              captured (``jit=True``): the program run once through the
              arena kernels and once through their plain versions, each
              in a zeroed arena, with bit-equal outputs and final arena
              bytes; outputs bit-equal to the unscheduled function's
              (the same aten ops on the same bytes), captured
              bit-equal to eager (a replay, one with other inputs, a
              replay's outputs kept), realized == optimal peak, arena >=
              peak, ``exact`` where ``repro``'s is, the arena launches per
              call (one write per threaded tensor, one read per op and
              distinct threaded input) in each eager call, the capture's
              count and the most complete of up to ``TRACE_TRIES`` traces
              of a replay, both kernels launched; prints nodes, the
              traced / Kahn / optimal / arena bytes, the caching
              allocator's peak over one unscheduled call and over one
              eager arena call (inputs counted in both), and us per call
              (unscheduled, eager arena, captured; CUDA events, median of
              20).  The ``arena_write``/``arena_read`` JSON rows carry the
              bridge's launches per call (``bridge``).

12. chaos  -- (run after llama3.2-1b's phases 7 and 8, its weights on the
              card) ``tests/test_chaos.py``'s generated corpus on the real
              server: 4 requests of 4 + 3 tokens, half latency-class,
              priorities 0 and 1, a budget of 3 shared arenas (one of
              them a latency-class request's: at this width its pinned
              plan alone is above 3 memory-class ones), a fault-free run
              serving all 4 (its launches counted from 0) and
              ``FaultPlan.generate(seed, n_ticks=8, rate=0.4)`` for seeds
              0-31: no request lost, never over the instantaneous budget,
              every served request's tokens bit-equal to the fault-free
              run's.

13. fleet  -- (run last) ``launch/serve.py:run_fleet`` over llama3.2-1b's
              real decode plans at the serve CLI's buckets (1056, 2112,
              8448), 4 decode + 1 prefill shards, ``FLEET_ARRIVALS``
              open-loop arrivals (rate 2, prompts of mean 1024, 32
              tokens on average, a quarter latency-class; simulated
              workers on the host): no request lost, every shard within
              its budget, one at 90% of it or more; the same arrivals
              under 8 per-shard fault scripts, each with the same
              invariants and every served request's tokens equal to the
              fault-free run's, one preempting under a shrunk budget;
              then each
              bucket's record packed on the card through ``arena_write``
              at its offsets (a random bf16 decode state) and read back
              through ``arena_read``: bit-equal, guard bytes and the
              transient region untouched, packed bytes equal to the
              record's resident extent, the arena its ``alone_bytes``;
              exactly one write and one read a leaf and bucket.  The
              ``arena_write``/``arena_read`` JSON rows carry these
              launches (``fleet``).

14. parallel -- (run after phase 9, before 13) the sharded path at world
              size 1: NCCL over an in-process store, a 1 x 1 mesh and
              ``rules_for_mesh``.  (a) llama3.2-1b at its published width,
              weights from SEED placed by ``distribute_params``, serves 4
              requests of 16 + 16 tokens under rules (eagerly: the
              captured step raises under rules, ROADMAP A8) and
              unsharded (captured): tokens equal, every step's logits of
              one request bit-equal to the captured step's, every
              kernel's launches equal (``flash_decode``,
              ``flash_prefill``, ``arena_write``, ``arena_read`` among
              them), peak memory within 1%, ms per token of both;
              (b) 2 train steps (batch 8 x seq 256, remat "block") under
              rules and unsharded, both under deterministic algorithms:
              loss, grad_norm and every state leaf bit-equal, 32
              ``flash_prefill`` and 16 ``flash_backward`` launches a
              step, ms per step of both; then the same for
              deepseek-v3-671b at its CLI's depth (1 layer + MTP) under
              Adafactor: under rules its moments take the split route
              (``adafactor_sums`` twice a step: the raw sums, their
              reduction, the moments), unsharded the fused one, the
              states bit-equal; (c) granite-moe-3b-a800m with
              ``moe_impl="ep_shardmap"`` serves 2 requests of 8 + 8
              tokens under rules with the scatter form's tokens; (d)
              ``compressed_psum`` bit-equal to quantize-then-dequantize
              on a bf16 tensor of llama's largest leaf; the process group
              destroyed at the end.  The flash, flash_backward, arena and
              Adafactor JSON rows carry its launches (``parallel``).
15. dryrun -- (run last) the dry-run (``launch/dryrun.py``): (a)
              llama3.2-1b's train step (batch 8 x seq 256, remat "block")
              and an eager decode step, full width, unsharded, on real
              tensors under the dry-run's counting mode: each kernel's
              counted launches equal its ``LAUNCHES`` delta (32
              ``flash_prefill`` + 16 ``flash_backward`` a step, 16
              ``flash_decode`` a token); (b) the same steps on fake CUDA
              tensors: launches, FLOPs, bytes and collective bytes equal
              (a)'s, ``memory_allocated`` and ``LAUNCHES`` unmoved; (c)
              the modelled t_compute no more than the measured step,
              printed beside t_memory; (d) the CLI (``python -m
              repro_torch.launch.dryrun``) for llama3.2-1b ``train_4k``
              and deepseek-v3-671b ``decode_32k`` on the single pod, on
              the card's routes over a fake 256-rank group, each in a
              process of its own started before phase 14 (they run beside
              phases 14 and 13): exit 0,
              records written (``chiprun_out/dryrun/``), max RSS under 8
              GB, llama's record 32 ``flash_prefill`` and 16
              ``flash_backward`` a device; (e) recurrentgemma-2b's train
              step at the smoke depth (4 layers, published width, window
              64) counted on real and on fake CUDA tensors: equal
              launches, FLOPs and bytes, the launches ``train_launches``'s.
              The flash rows carry llama's record's launches
              (``dryrun``).

The kernels JSON (one entry per kernel) is printed third from last, the
card's name and power limit second from last, and ``{"ok": true,
"device": {...}}`` last.  Without CUDA, or outside a checkout, it exits
non-zero before printing any of them.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

sys.path.insert(0, str(SRC))
try:
    # the card's rates and each kernel's operations and bytes
    from repro_torch.kernels import costs
    from repro_torch.kernels.costs import (
        BF16_FLOP_PER_S,
        F32_FLOP_PER_S,
        HBM_BYTES_PER_S,
    )
except ImportError:                # not run from a checkout: main() says so
    costs = None
SIZES = (0, 1, 3, 4097, 150528)    # 150,528 f32 = 28x28x48x4 B: DARTS fmap
# the copy sweep of write and read: lengths in elements; u8 runs every
# phase pair up to COPY_SHORT and the multiples of 4 beyond, and one
# llama3.2-1b KV leaf (16 layers x 1056 x 8 KV heads x 64 x bf16)
COPY_LENGTHS = (0, 1, 3, 15, 16, 17, 63, 64, 65, 4097, 150528)
COPY_SHORT, LLAMA_LEAF = 65, 17_301_504
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6  # expf/tanhf vs torch's eager kernels
FLUSH_BYTES = 256 << 20            # written between cold launches: 5x L2
SEED = 0

# file:line of the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "write": "src/repro/kernels/arena/kernel.py:65",
    "read": "src/repro/kernels/arena/kernel.py:89",
    "accum": "src/repro/kernels/arena/kernel.py:77",
    "chain_write": "src/repro/kernels/arena/kernel.py:100",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:109",
    "wkv6": "src/repro/kernels/rwkv6/kernel.py:63",
    "rglru": "src/repro/kernels/rglru/kernel.py:49",
}
FA_RTOL32 = FA_ATOL32 = 1e-5       # f32: sums in another order
FA_ATOL16 = 1e-5                   # bf16: + one ulp of the output
# recurrentgemma-2b's attention: multi-query, head dim 256, local window
MQA_H, MQA_D, MQA_WINDOW = 10, 256, 2048
# serving, each model at its published width: 4 requests of GEN tokens,
# the decode plan's known integers (from the JAX package), and the atol of
# the kernels' logits against the plain versions' over prefill and
# LOGIT_STEPS decode steps (|logit| up to ~5).  With params and cache in
# f32 the two differ by sums taken in another order: LOGIT_ATOL32 for
# all.  In bf16, as served, they differ where a rounding flips; the
# recurrent models carry each flip through their state for the whole
# prompt (rwkv6-7b: 0.217 at max |logit| 4.97 on the card, while the f32
# runs agree to 5e-5), so their bf16 atol is wider.
GEN, N_REQ, LOGIT_STEPS, LOGIT_ATOL32 = 32, 4, 8, 2e-3
SERVES = {
    "llama3.2-1b": dict(
        prompt=1024, logit_atol=5e-2,
        plan={"arena_bytes": 35_124_228, "resident_extent": 34_603_012,
              "transient_bytes": 521_216, "n_buffers": 53}),
    "rwkv6-7b": dict(
        prompt=1024, logit_atol=5e-1,
        plan={"arena_bytes": 34_357_252, "resident_extent": 34_078_724,
              "transient_bytes": 278_528, "n_buffers": 102}),
    "recurrentgemma-2b": dict(
        prompt=2560, logit_atol=5e-1,
        plan={"arena_bytes": 22_728_708, "resident_extent": 21_694_468,
              "transient_bytes": 1_034_240, "n_buffers": 89}),
}
# this slice's decoders, served at published width (4 requests of 1024
# prompt tokens + GEN) after the three models above: the MoE decoder in
# full (serve, timing, vmap), the dense ones lighter (serve, logits in bf16
# against the plain versions, ms per token; logits in f32 at a cut depth,
# ``check_cut_f32``); the decode plans' integers from the JAX package at
# smax 1056.  Each bf16 atol lies between the readings of the sound kernels
# and of the ``CONTROLS`` named in ``bf16_controls`` (on an NVIDIA H100
# 80GB HBM3 at 700.00 W, two prompts): granite-moe, each plain run routed
# and gated as its kernels' run, 0.172 and 0.1875 (the batched step vs the
# serial one 0.215), a softmax scale 5% off 1.419 and 1.447, query head 0
# zeroed 4.25 and 3.71 (the bf16 rounding of the hidden state still moves
# every expert's input through 32 layers; the f32 runs agree to 5e-5);
# the dense ones 0.035-0.047, query head 0 zeroed 0.537-1.471 (gemma 1.471
# and 1.279, starcoder2 0.703 and 0.812, granite-20b 0.686 and 0.723,
# chameleon 0.537 and 0.543).  A subtler fault (every decode output 2^-6
# too large, or a softmax scale 5% off) reads 0.047-0.068 in their bf16
# logits, inside the rounding: the f32 checks are what hold it.
DECODERS = {
    "granite-moe-3b-a800m": dict(
        prompt=1024, logit_atol=0.5, bf16_controls=("head0_zeroed",
                                                   "q_x1.05"),
        plan={"arena_bytes": 69_408_784, "resident_extent": 69_206_020,
              "transient_bytes": 202_764, "n_buffers": 101}),
    "gemma-7b": dict(
        prompt=1024, logit_atol=0.15, bf16_controls=("head0_zeroed",),
        plan={"arena_bytes": 485_478_404, "resident_extent": 484_442_116,
              "transient_bytes": 1_036_288, "n_buffers": 89}),
    "starcoder2-7b": dict(
        prompt=1024, logit_atol=0.15, bf16_controls=("head0_zeroed",),
        plan={"arena_bytes": 69_421_060, "resident_extent": 69_206_020,
              "transient_bytes": 215_040, "n_buffers": 101}),
    "granite-20b": dict(
        prompt=1024, logit_atol=0.15, bf16_controls=("head0_zeroed",),
        plan={"arena_bytes": 28_336_132, "resident_extent": 28_114_948,
              "transient_bytes": 221_184, "n_buffers": 161}),
    "chameleon-34b": dict(
        prompt=1024, logit_atol=0.15, bf16_controls=("head0_zeroed",),
        plan={"arena_bytes": 207_912_964, "resident_extent": 207_618_052,
              "transient_bytes": 294_912, "n_buffers": 149}),
}
SERVES.update(DECODERS)
# this slice's families, served at published width after the decoders
# (4 requests of 1024 prompt tokens + GEN; the encoder-decoder's requests
# carry 1024 frames each, ``launch/serve.py:encoder_frames``), each through
# the serve, timing and vmap phases: ``seamless-m4t-medium`` in full
# (12 + 12 layers; its f32 logits at full depth), ``deepseek-v3-671b`` at
# published width with its depth cut to ``depth`` layers of 61 (the 3
# dense and one MoE layer of 256 experts: 1.34 TB of bf16 weights do not
# fit one card; its f32 logits at the smaller ``f32_depth``, the bf16
# weights freed first).  The decode plans' integers from the JAX package at
# smax 1056 (the CPU tests assert them).  ``controls``: the deliberately
# broken kernels (``CONTROLS``) each logit check must read above, in f32
# and in bf16, applied where ``scope`` says (``"decode"``: the flash calls
# of one query; ``"all"``: every flash call, MLA's decode has no kernel).
A7 = {
    "seamless-m4t-medium": dict(
        prompt=1024, logit_atol=0.15, f32_atol=2e-4, scope="decode",
        f32_controls=("kv_len+1", "head0_zeroed", "out_x(1+2^-6)",
                      "q_x1.05"),
        bf16_controls=("head0_zeroed",),
        plan={"arena_bytes": 55_096_128, "resident_extent": 54_067_208,
              "transient_bytes": 1_028_920, "n_buffers": 43}),
    "deepseek-v3-671b": dict(
        prompt=1024, logit_atol=0.1, scope="all", depth=4,
        f32_depth=dict(n_layers=2, n_dense_layers=1),
        f32_controls=("head0_zeroed", "out_x(1+2^-6)", "q_x1.05"),
        bf16_controls=("head0_zeroed", "q_x1.05"),
        plan={"arena_bytes": 5_411_844, "resident_extent": 4_866_052,
              "transient_bytes": 545_792, "n_buffers": 19}),
}
SERVES.update(A7)
FAMILIES = ("llama3.2-1b", "rwkv6-7b", "recurrentgemma-2b")
MOE_ARCH = "granite-moe-3b-a800m"
RG_RTOL = RG_ATOL = 1e-5           # rglru f32: exp of two libraries
# device activities per decode token with one request in flight, counted in
# traces that hold the step's first kernels (``device_profile``'s lead), as
# the flash, arena and recurrence kernels stood before their Hopper
# redesigns; the redesigns must not add any.  Limits read from traces
# without the lead (999 / 2806 / 1511) were low by the kernels those traces
# missed, so a trace that held them failed with nothing risen.
ACTIVITIES = {"llama3.2-1b": 999, "rwkv6-7b": 2808, "recurrentgemma-2b": 1515}
TOKEN_TRACES = 3
# traces lose events at random on the card's machine (a trace of a replay
# has come back with 3514 of its 4162 activities, and four in a row have
# come back empty): a check that needs one whole trace takes up to this
# many, and the most complete of them must hold every launch
TRACE_TRIES = 8
# the split-K decode's partials against the plain version's: m to rtol/atol
# 1e-5; l and acc to 1e-5 plus 1e-5 times the summands' magnitude (at most
# l for l, l * max|v| for acc)
SPLIT_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_copy(dev) -> dict:
    """write and read, f32 and u8, at every destination phase x source
    phase mod 16 that the dtype allows (u8: all 16 x 16 up to COPY_SHORT
    elements, multiples of 4 beyond), at COPY_LENGTHS elements and (u8)
    one llama3.2-1b KV leaf.  x, the arena and out are views at a storage
    offset that sets their phase; write goes through its wrapper, read
    through its wrapper (a fresh out, phase 0) and through its C entry into
    every phase of an out view.  Each result is bit-equal to the plain
    version, and the bytes on both sides of the slice (and of the out
    view) are unchanged.  A split that does not fit its addresses is
    refused.  Returns the cases run per (op, dtype, mode)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {}

    def rand(n, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, (n,), dtype=dtype, device=dev,
                                 generator=gen)
        return torch.randn(n, device=dev, generator=gen)

    def count(op, dtype, plan):
        key = f"{op} {str(dtype).split('.')[1]} {plan.mode}"
        cases[key] = cases.get(key, 0) + 1

    def read_into(out, arena, o):
        esz, n = arena.element_size(), out.shape[0]
        plan = K.copy_plan(out.data_ptr(), arena.data_ptr() + esz * o, esz * n)
        fn = getattr(K._library(), "repro_arena_read_"
                     + ("u8" if esz == 1 else "f32"))
        _build.raise_on(fn(arena.data_ptr(), out.data_ptr(), o, n, *plan,
                           stream), "arena_read into a view")
        return plan

    for dtype in (torch.float32, torch.uint8):
        esz = torch.tensor([], dtype=dtype).element_size()
        per16 = 16 // esz            # elements in 16 bytes
        lengths = COPY_LENGTHS + ((LLAMA_LEAF,) if esz == 1 else ())
        for n in lengths:
            step = 1 if esz == 4 or n <= COPY_SHORT else 4
            phases = range(0, per16, step)
            guard = 2 * per16        # elements on each side of a slice
            full = rand(guard + n + 2 * guard, dtype)
            src = rand(n + per16, dtype)
            keep, keep_src = full.clone(), src.clone()
            outbuf = rand(n + 2 * per16, dtype)
            for dp in phases:
                o = guard + dp                 # dst phase: dp elements
                for sp in phases:
                    x = src[sp:sp + n]         # src phase: sp elements
                    a = full.clone()
                    K.arena_write_cuda(a, x, o)
                    want = R.arena_write_torch(full.clone(), x, o)
                    count("write", dtype, K.copy_plan(
                        a.data_ptr() + esz * o, x.data_ptr(), esz * n))
                    check(torch.equal(a, want)
                          and torch.equal(a[:o], full[:o])
                          and torch.equal(a[o + n:], full[o + n:]),
                          f"write {dtype} n={n} dst phase {dp} src phase "
                          f"{sp}: differs from the plain version")
                    # read: the arena seen at storage offset sp, so its
                    # slice at o has phase sp + dp; out at phase dp
                    arena = full[sp:]
                    want = R.arena_read_torch(arena, o, n)
                    out = outbuf.clone()
                    view = out[dp:dp + n]
                    count("read", dtype, read_into(view, arena, o))
                    check(torch.equal(view, want)
                          and torch.equal(out[:dp], outbuf[:dp])
                          and torch.equal(out[dp + n:], outbuf[dp + n:]),
                          f"read {dtype} n={n} into an out view at phase "
                          f"{dp}, arena phase {sp + dp}: differs from the "
                          f"plain version or wrote outside the view")
                    if dp == 0:
                        got = K.arena_read_cuda(arena, o, n)
                        count("read", dtype, K.copy_plan(
                            got.data_ptr(), arena.data_ptr() + esz * o,
                            esz * n))
                        check(torch.equal(got, want) and (
                            n == 0 or got.data_ptr() != arena.data_ptr()),
                            f"read {dtype} n={n} arena phase {sp}")
                    check(torch.equal(full, keep)
                          and torch.equal(src, keep_src),
                          f"{dtype} n={n}: a copy changed its source")
            del full, keep, src, keep_src, outbuf
    torch.cuda.synchronize()

    # a split that does not fit its two addresses is refused, not launched
    a, x = rand(64, torch.uint8), rand(48, torch.uint8)
    good = K.copy_plan(a.data_ptr() + 5, x.data_ptr(), 48)
    fn = K._library().repro_arena_write_u8
    for bad in (good._replace(phase=(good.phase + 1) % 16),
                good._replace(head=good.head + 16),
                good._replace(tail=good.tail + 1)):
        check(fn(a.data_ptr(), x.data_ptr(), 5, 48, *bad, stream) != 0,
              f"the write entry launched a wrong split {bad}")
    torch.cuda.synchronize()
    return cases


def sweep_accum(dev) -> dict:
    """accum at every arena phase x x phase mod 16 bytes (whole floats),
    at the f32 COPY_LENGTHS: x a view of a larger tensor at a storage
    offset, the slice of an arena with guard floats on both sides.  Each
    result is bit-equal to the plain version, with the guard floats and x
    unchanged; a split that does not fit its addresses, or is not whole
    floats, is refused.  Returns the cases run per mode."""
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = {}
    for n in COPY_LENGTHS:
        guard = 8                                # floats each side
        full = torch.randn(guard + n + 2 * guard, device=dev, generator=gen)
        src = 3 * torch.randn(n + 4, device=dev, generator=gen)
        keep_src = src.clone()
        for dp in range(4):                      # arena phase: dp floats
            o = guard + dp
            for sp in range(4):                  # x phase: sp floats
                x = src[sp:sp + n]
                a = full.clone()
                plan = K.copy_plan(a.data_ptr() + 4 * o, x.data_ptr(), 4 * n)
                K.arena_accum_cuda(a, x, o)
                want = R.arena_accum_torch(full.clone(), x, o)
                key = f"accum {plan.mode}"
                cases[key] = cases.get(key, 0) + 1
                check(torch.equal(a, want)
                      and torch.equal(a[:o], full[:o])
                      and torch.equal(a[o + n:], full[o + n:])
                      and torch.equal(src, keep_src),
                      f"accum n={n} arena phase {4 * dp} B, x phase "
                      f"{4 * sp} B: differs from the plain version or "
                      f"touched a float outside the slice")
    torch.cuda.synchronize()

    stream = torch.cuda.current_stream(dev).cuda_stream
    a, x = torch.zeros(64, device=dev), torch.zeros(16, device=dev)
    good = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 48)
    fn = K._library().repro_arena_accum_f32
    for bad in (good._replace(phase=(good.phase + 4) % 16),
                good._replace(head=good.head + 16),
                good._replace(tail=good.tail + 4)):
        check(fn(a.data_ptr(), x.data_ptr(), 1, 12, *bad, stream) != 0,
              f"the accum entry launched a wrong split {bad}")
    # 3 floats, all head: a split of 9 + 3 bytes fits the addresses but
    # cuts floats
    small = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 12)
    bad = small._replace(head=small.head - 3, tail=small.tail + 3)
    check(small.nvec == 0 and fn(a.data_ptr(), x.data_ptr(), 1, 3, *bad,
                                 stream) != 0,
          f"the accum entry launched a split that cuts floats {bad}")
    torch.cuda.synchronize()
    return cases


def sweep_chain(dev, chains, err) -> tuple[dict, float]:
    """chain_write of every chain in ``chains`` at every arena phase x x
    phase mod 16 bytes (whole floats), at the f32 COPY_LENGTHS, as
    sweep_accum runs accum: exact chains bit-equal to the plain version,
    the rest allclose, the guard floats and x unchanged in every case; a
    split that does not fit its addresses, or is not whole floats, is
    refused and its launch raises.  Returns the cases run per (exact or
    not, mode) and the worst error of the transcendental chains."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    from repro_torch.kernels.arena.elemwise import (
        EXACT_OPS,
        MAX_CHAIN,
        chain_codes,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cases, worst = {}, 0.0
    for n in COPY_LENGTHS:
        guard = 8                                # floats each side
        full = torch.randn(guard + n + 2 * guard, device=dev, generator=gen)
        src = 3 * torch.randn(n + 4, device=dev, generator=gen)
        keep_src = src.clone()
        for ops in chains:
            exact = set(ops) <= EXACT_OPS
            for dp in range(4):                  # arena phase: dp floats
                o = guard + dp
                for sp in range(4):              # x phase: sp floats
                    x = src[sp:sp + n]
                    a = full.clone()
                    plan = K.copy_plan(a.data_ptr() + 4 * o, x.data_ptr(),
                                       4 * n)
                    K.arena_chain_write_cuda(a, x, o, ops)
                    want = R.arena_chain_write_torch(full.clone(), x, o, ops)
                    key = f"{'exact' if exact else 'transcendental'} " \
                          f"{plan.mode}"
                    cases[key] = cases.get(key, 0) + 1
                    what = (f"chain_write {ops} n={n} arena phase {4 * dp} "
                            f"B, x phase {4 * sp} B")
                    check(torch.equal(a[:o], full[:o])
                          and torch.equal(a[o + n:], full[o + n:])
                          and torch.equal(src, keep_src),
                          f"{what}: touched a float outside the slice or x")
                    e = 0.0 if n == 0 else float(
                        (a.double() - want.double()).abs().max())
                    err["chain_write"] = max(err["chain_write"], e)
                    if exact:
                        check(torch.equal(a, want),
                              f"{what}: differs from the plain version")
                    else:
                        worst = max(worst, e)
                        check(torch.allclose(a, want, rtol=CHAIN_RTOL,
                                             atol=CHAIN_ATOL),
                              f"{what}: max abs err {e}")
    torch.cuda.synchronize()

    stream = torch.cuda.current_stream(dev).cuda_stream
    a, x = torch.zeros(64, device=dev), torch.zeros(16, device=dev)
    codes = chain_codes(("bn", "relu"))
    chain = K._ChainOps(len(codes), (ctypes.c_int * MAX_CHAIN)(*codes))
    good = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 48)
    small = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 12)
    fn = K._library().repro_arena_chain_write_f32
    for bad, n in ((good._replace(phase=(good.phase + 4) % 16), 12),
                   (good._replace(head=good.head + 16), 12),
                   (good._replace(tail=good.tail + 4), 12),
                   # 9 + 3 bytes: fits the addresses, cuts floats
                   (small._replace(head=small.head - 3,
                                   tail=small.tail + 3), 3)):
        try:
            _build.raise_on(fn(a.data_ptr(), x.data_ptr(), 1, n, *bad, chain,
                               stream), "arena_chain_write")
        except _build.KernelLaunchError:
            continue
        check(False, f"the chain_write entry launched a wrong split {bad}")
    torch.cuda.synchronize()
    return cases, worst


def phase_kernels(dev, rng, err):
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    from repro_torch.kernels.arena.elemwise import ELEMWISE_OP_CODES, EXACT_OPS

    def arena_and_x(n, dtype):
        pad = int(rng.integers(0, 97))
        size = n + pad + int(rng.integers(0, 65))
        if dtype == torch.uint8:
            a = rng.integers(0, 256, size, dtype=np.uint8)
            x = rng.integers(0, 256, n, dtype=np.uint8)
        else:
            a = rng.standard_normal(size).astype(np.float32)
            x = (3 * rng.standard_normal(n)).astype(np.float32)
        return (torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev), pad)

    def record(name, got, want):
        e = 0.0 if got.numel() == 0 else float(
            (got.double() - want.double()).abs().max())
        err[name] = max(err[name], e)
        return e

    cases = sweep_copy(dev)      # bit-equal: write/read errors stay 0
    cases.update(sweep_accum(dev))
    for n in SIZES:
        a, x, o = arena_and_x(n, torch.float32)
        got = K.arena_accum_cuda(a.clone(), x, o)
        want = R.arena_accum_torch(a.clone(), x, o)
        record("accum", got, want)
        check(torch.equal(got, want), f"accum n={n}")

    chains = [(op,) for op in ELEMWISE_OP_CODES] + [
        ("relu", "bn"), ("bn", "relu"), ("relu", "bn", "relu", "bn"),
        ("bn", "scale", "bias_add", "relu6"), ("gelu", "silu", "tanh")]
    chain_cases, chain_worst = sweep_chain(dev, chains, err)
    worst_transcendental = 0.0
    for ops in chains:
        for n in SIZES:
            a, x, o = arena_and_x(n, torch.float32)
            got = K.arena_chain_write_cuda(a.clone(), x, o, ops)
            want = R.arena_chain_write_torch(a.clone(), x, o, ops)
            e = record("chain_write", got, want)
            if set(ops) <= EXACT_OPS:
                check(torch.equal(got, want), f"chain_write {ops} n={n}")
            else:
                worst_transcendental = max(worst_transcendental, e)
                check(torch.allclose(got, want, rtol=CHAIN_RTOL,
                                     atol=CHAIN_ATOL),
                      f"chain_write {ops} n={n}: max abs err {e}")
    torch.cuda.synchronize()

    K.reset_launches()
    a, x, _ = arena_and_x(0, torch.float32)
    K.arena_write_cuda(a, x, 0)
    K.arena_accum_cuda(a, x, 0)
    K.arena_chain_write_cuda(a, x, 0, ("relu",))
    check(K.arena_read_cuda(a, 0, 0).numel() == 0, "read n=0")
    check(all(v == 0 for v in K.LAUNCHES.values()),
          f"n == 0 launched a kernel: {K.LAUNCHES}")
    say(f"kernels: write/read f32+u8 bit-equal with the guard bytes "
        f"untouched over every phase pair, cases per (op, dtype, mode) "
        f"{cases}; accum bit-equal over every phase pair of the f32 "
        f"lengths, a wrong split refused; chain_write of {len(chains)} "
        f"chains over every phase pair of the f32 lengths, cases per "
        f"(chain kind, mode) {chain_cases}: exact chains bit-equal, guard "
        f"floats and x untouched, transcendental chains max abs err "
        f"{chain_worst:.3e}, a wrong split refused; accum, exact chains "
        f"bit-equal at n in {SIZES}; transcendental chains max abs err "
        f"{worst_transcendental:.3e} (rtol {CHAIN_RTOL}, atol {CHAIN_ATOL}); "
        f"n == 0 launches nothing")


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain versions
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (f32): 2^(e - 8) for
    x = m * 2^e, 0.5 <= m < 1."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def fa_err(got, want):
    """(max abs err, within tolerance) of two outputs of one dtype."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= FA_ATOL32 + FA_RTOL32 * b.abs()).all())
    else:
        ok = bool((diff <= bf16_ulp(torch.maximum(a.abs(), b.abs()))
                   + FA_ATOL16).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def flash_routes(dtype, D, Dv, rows) -> dict:
    """The kernels that take a call, by route, each through its wrapper:
    the simple kernel always, the split-K decode at Sq * G <= 16, the
    ``wgmma`` prefill in bf16 at its pairs."""
    from repro_torch.kernels.flash_attention import kernel as FK
    out = {"simple": FK.flash_simple_cuda}
    if rows <= FK.DECODE_MAX_ROWS:
        out["decode"] = lambda *a, **kw: FK.flash_decode_cuda(*a, **kw)[0]
    if dtype == torch.bfloat16 and (D, Dv) in FK.PREFILL_HEAD_DIMS:
        out["prefill"] = FK.flash_prefill_cuda
    return out


def flash_cases():
    """The flash phase's cases, ``(name, Sq, Skv, kw)``: those run at every
    (D, Dv) and GQA group, and recurrentgemma-2b's multi-query ones."""
    cases = []
    for kv in (1, 127, 1056, 4097):        # decode: one query at kv_len - 1
        cases.append(("decode", 1, kv, dict(q_start=kv - 1, kv_len=kv)))
    for n in (1, 33, 1024):                # causal prefill
        cases.append(("prefill", n, n, dict()))
    cases.append(("window", 100, 100, dict(window=17)))
    cases.append(("tail", 1, 1056, dict(q_start=499, kv_len=500)))
    cases.append(("prefill window", 300, 300, dict(window=100)))
    cases.append(("prefill tail", 70, 1056, dict(q_start=400, kv_len=470)))
    cases.append(("noncausal", 33, 100, dict(causal=False)))
    cases.append(("noncausal window", 64, 64, dict(causal=False, window=9)))
    cases.append(("noncausal tail", 5, 1056, dict(causal=False, q_start=3,
                                                  kv_len=700)))
    cases.append(("batch decode", 1, 300, dict(q_start=299, kv_len=300,
                                               batch=2)))
    cases.append(("batch prefill tail", 70, 300, dict(q_start=200,
                                                      kv_len=270, batch=2)))
    # recurrentgemma-2b's served attention: one KV head for 10 query heads,
    # D 256, window 2048, the cache of smax 2592 and the prompt of 2560
    w = MQA_WINDOW
    mqa = [("mqa decode", 1, 2592, dict(q_start=2591, kv_len=2592,
                                        window=w)),
           ("mqa prefill", 2560, 2560, dict(window=w)),
           ("mqa decode tail", 1, 2592, dict(q_start=2199, kv_len=2200,
                                             window=w))]
    return cases, mqa


def phase_flash(dev, err):
    """Every case through every kernel that takes it; returns the worst
    error of each route."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, per_route, n_runs = {}, {}, {}

    def run(name, dtype, D, Dv, KV, G, sq, skv, kw):
        kw = dict(kw)
        B = kw.pop("batch", 1)
        q = torch.randn(B, sq, KV * G, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        args = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    q_start=kw.get("q_start", 0),
                    kv_len=kw.get("kv_len", skv))
        wants = {impl: flash_attention(q, k, v, impl=impl, **kw)
                 for impl in ("torch", "ref")}
        line = []
        for route, kernel in flash_routes(dtype, D, Dv, sq * G).items():
            got = kernel(q, k, v, **args)
            if route == "prefill":
                check(torch.equal(kernel(q, k, v, **args), got),
                      f"flash {name} {dtype} D={D} Dv={Dv} G={G}: a second "
                      f"launch of the prefill kernel differs from the first")
            for impl, want in wants.items():
                e, ok = fa_err(got, want)
                check(ok, f"flash {name} {dtype} D={D} Dv={Dv} G={G} KV={KV} "
                          f"route {route} vs {impl}: max abs err {e}")
                err["flash_attention"] = max(err["flash_attention"], e)
                key = (str(dtype).split(".")[1], impl)
                worst[key] = max(worst.get(key, 0.0), e)
                per_route[route] = max(per_route.get(route, 0.0), e)
                line.append(f"{route} vs {impl} {e:.3e}")
            n_runs[route] = n_runs.get(route, 0) + 1
            if name.endswith("tail"):
                # finite garbage beyond kv_len must not leak
                k2, v2 = k.clone(), v.clone()
                k2[:, kw["kv_len"]:] = 1e4
                v2[:, kw["kv_len"]:] = -1e4
                dirty = kernel(q, k2, v2, **args)
                check(torch.equal(dirty, got),
                      f"flash {name} {dtype} D={D} Dv={Dv} G={G} route "
                      f"{route}: garbage beyond kv_len leaked")
        say(f"flash: {name} Sq {sq} Skv {skv} {kw} "
            f"{str(dtype).split('.')[1]} D {D} Dv {Dv} G {G} KV {KV}: "
            f"max abs err {', '.join(line)}")

    cases, mqa = flash_cases()
    for dtype in (torch.float32, torch.bfloat16):
        for D, Dv in FK.HEAD_DIMS:        # every (D, Dv) the wrapper takes
            for G in (1, 4):
                for name, sq, skv, kw in cases:
                    run(name, dtype, D, Dv, 8, G, sq, skv, kw)
        for name, sq, skv, kw in mqa:
            run(name, dtype, MQA_D, MQA_D, 1, MQA_H, sq, skv, kw)
    torch.cuda.synchronize()
    say(f"flash: every case within tolerance (f32 rtol {FA_RTOL32} + atol "
        f"{FA_ATOL32}; bf16 one ulp of the output + {FA_ATOL16}); worst "
        + ", ".join(f"{d} vs {i} {e:.3e}" for (d, i), e in worst.items())
        + f"; by route {per_route}, cases per route {n_runs}")
    per_route.update(phase_flash_split(dev, gen))
    return per_route


def phase_flash_split(dev, gen):
    """The split-K decode's partials and merged output against its two plain
    versions, with splits fully masked for some rows, empty splits, and
    rows masked in every split (which must give 0 with no NaN; those rows
    are held against the oracle, since ``impl="torch"``, like ``repro``'s
    ``_flash_xla``, gives them the mean of the masked values)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_decode_combine_torch,
        flash_decode_partials_torch,
    )

    cases = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, kw, rows masked)
        ("llama decode", torch.bfloat16, 1, 1056, 32, 8, 64, 64,
         dict(q_start=1055, kv_len=1056), 0),
        ("griffin decode", torch.bfloat16, 1, 2592, 10, 1, 256, 256,
         dict(q_start=2591, kv_len=2592, window=MQA_WINDOW), 0),
        ("f32 192/128 tail", torch.float32, 1, 1056, 16, 4, 192, 128,
         dict(q_start=499, kv_len=500), 0),
        ("some splits masked", torch.bfloat16, 16, 116, 1, 1, 128, 128,
         dict(q_start=100, kv_len=116, window=20), 0),
        ("rows masked in every split", torch.float32, 4, 64, 8, 2, 16, 16,
         dict(q_start=8, kv_len=9, window=2), 2),
    ]
    worst = 0.0

    def hold(what, q, k, v, got, want, ref_kw, dtype):
        """One launch's partials and output against the plain versions'
        and the oracle; returns (m, l, acc, merge, oracle) errors and the
        mask of live (split, row) partials."""
        out, m, l, acc = got
        mw, lw, aw = want
        vmax = float(v.float().abs().max())
        check(m.shape == mw.shape, f"{what}: {m.shape} vs {mw.shape}")
        check(not any(bool(torch.isnan(t).any())
                      for t in (out.float(), m, l, acc)), f"{what}: NaN")
        live = torch.isfinite(mw)
        check(torch.equal(live, torch.isfinite(m)),
              f"{what}: the -inf splits differ")
        em = float((m - mw).abs()[live].max()) if live.any() else 0.0
        el = float((l - lw).abs().max())
        ea = float((acc - aw).abs().max())
        check(bool(((m - mw).abs()[live] <= SPLIT_TOL
                    * (1 + mw.abs()[live])).all())
              and bool(((l - lw).abs() <= SPLIT_TOL * (1 + lw)).all())
              and bool(((acc - aw).abs() <= SPLIT_TOL
                        * (1 + lw[..., None] * vmax)).all()),
              f"{what}: partials off the plain version's (m {em}, l "
              f"{el}, acc {ea})")
        check(bool((l[~live] == 0).all()) and bool((acc[~live] == 0).all()),
              f"{what}: a fully masked split is not exactly 0")
        merged = flash_decode_combine_torch(mw, lw, aw, dtype=dtype)
        e, ok = fa_err(out, merged)
        check(ok, f"{what}: output vs the plain merge: {e}")
        e2, ok2 = fa_err(out, flash_attention(q, k, v, impl="ref", **ref_kw))
        check(ok2, f"{what}: output vs the oracle: {e2}")
        return em, el, ea, e, e2, live

    for name, dtype, sq, skv, H, KV, D, Dv, kw, n_dead in cases:
        q = torch.randn(1, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(1, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(1, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        args = dict(causal=True, window=kw.get("window"),
                    q_start=kw["q_start"], kv_len=kw["kv_len"])
        for splits in (None, 7, 64):
            got = FK.flash_decode_cuda(q, k, v, splits=splits, **args)
            want = flash_decode_partials_torch(q, k, v, splits=splits, **kw)
            out, m = got[0], got[1]
            what = f"flash_decode {name} splits {splits} ({m.shape[2]})"
            em, el, ea, e, e2, live = hold(what, q, k, v, got, want, kw,
                                           dtype)
            if n_dead:
                check(not bool(out[:, -n_dead:].any()),
                      f"{what}: a row with no live key is not 0")
            worst = max(worst, e, e2)
            say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, D {D}, "
                f"Dv {Dv}, G {H // KV}, {kw}) at {m.shape[2]} splits: "
                f"partials vs plain m {em:.3e}, l {el:.3e}, acc {ea:.3e}; "
                f"output vs plain merge {e:.3e}, vs oracle {e2:.3e}; "
                f"{int((~live).sum())} of {live.numel()} (split, row) "
                f"partials fully masked, exactly 0")

    # the position on the device (a captured decode step's launch): the
    # capacity split rule at the served caches and a small f32 one, over
    # positions from 0 to the last, each against the plain versions with a
    # tensor position and the oracle; where the host rule splits alike,
    # the launch must equal the host-position launch bit for bit
    dpos = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, window, positions)
        ("llama", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (0, 31, 32, 500, 1023, 1024, 1040, 1055)),
        ("griffin", torch.bfloat16, 1, 2592, 10, 1, 256, 256, MQA_WINDOW,
         (0, 100, 2047, 2048, 2100, 2559, 2560, 2575, 2591)),
        ("f32 Sq 2 window", torch.float32, 2, 300, 8, 2, 128, 128, 40,
         (0, 1, 39, 40, 41, 150, 298)),
    ]
    worst_dev, equal_host, n_dev = 0.0, 0, 0
    for name, dtype, sq, skv, H, KV, D, Dv, w, positions in dpos:
        q = torch.randn(1, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(1, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(1, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        cap = FK.capacity_splits(1, KV, sq, H, Dv, Skv=skv, causal=True,
                                 window=w)
        for t in positions:
            pos = torch.full((), t, dtype=torch.long, device=dev)
            got = FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                       q_start=pos)
            want = flash_decode_partials_torch(q, k, v, causal=True,
                                               window=w, q_start=pos)
            what = f"flash_decode {name} at device position {t}"
            check(got[1].shape[2] == cap[0],
                  f"{what}: {got[1].shape[2]} splits, the rule {cap[0]}")
            ref_kw = dict(causal=True, window=w, q_start=t, kv_len=t + sq)
            e = hold(what, q, k, v, got, want, ref_kw, dtype)[3:5]
            host = FK.decode_splits(1, KV, sq, H, Dv, causal=True, window=w,
                                    q_start=t, kv_len=t + sq)
            if (host[0], host[2]) == cap:
                out_host = FK.flash_decode_cuda(q, k, v, **ref_kw)[0]
                check(torch.equal(got[0], out_host),
                      f"{what}: not bit-equal to the host-position launch "
                      f"of the same splits")
                equal_host += 1
            worst_dev = max(worst_dev, *e)
            n_dev += 1
        say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, Sq {sq}, "
            f"Skv {skv}, G {H // KV}, window {w}) at device positions "
            f"{positions}: {cap[0]} splits of {cap[1]} tiles (the capacity "
            f"rule) at every one, partials within the plain version's "
            f"tolerance, output vs plain merge and oracle within the "
            f"flash tolerance")
    say(f"flash: device positions: {n_dev} launches held, worst output "
        f"error {worst_dev:.3e}; {equal_host} bit-equal to the host-position "
        f"launch of the same splits")

    # a position per batch row (the batched decode step's launch): rows at
    # different positions, some cut by the window, in one grid, against
    # the plain versions at the same (B,) positions and the oracle; with
    # every row at one position, bit-equal to the 0-d launch
    rpos = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, window, positions)
        ("llama bucket 4", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (0, 500, 1023, 1055)),
        ("llama bucket 8", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (3, 31, 32, 300, 1024, 1040, 1054, 1055)),
        ("griffin bucket 4", torch.bfloat16, 1, 2592, 10, 1, 256, 256,
         MQA_WINDOW, (100, 2047, 2300, 2591)),
        ("f32 Sq 2 window", torch.float32, 2, 300, 8, 2, 128, 128, 40,
         (0, 41, 298)),
    ]
    worst_rows = 0.0
    for name, dtype, sq, skv, H, KV, D, Dv, w, positions in rpos:
        B = len(positions)
        q = torch.randn(B, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        pos = torch.tensor(positions, dtype=torch.long, device=dev)
        cut = [t for t in positions if w is not None and t - w + 1 > 0]
        got = FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                   q_start=pos)
        want = flash_decode_partials_torch(q, k, v, causal=True, window=w,
                                           q_start=pos)
        what = f"flash_decode {name} at row positions {positions}"
        ref_kw = dict(causal=True, window=w, q_start=pos)
        e = hold(what, q, k, v, got, want, ref_kw, dtype)[3:5]
        for b, t in enumerate(positions):
            row = (q[b:b + 1], k[b:b + 1], v[b:b + 1])
            e_row, ok = fa_err(got[0][b:b + 1], flash_attention(
                *row, impl="ref", causal=True, window=w, q_start=t,
                kv_len=t + sq))
            check(ok, f"{what}: row {b} vs the oracle of the row alone "
                      f"at {t}: {e_row}")
        same = torch.full((B,), positions[-1], dtype=torch.long, device=dev)
        one = torch.full((), positions[-1], dtype=torch.long, device=dev)
        check(torch.equal(
            FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                 q_start=same)[0],
            FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                 q_start=one)[0]),
            f"{what}: every row at one position is not bit-equal to the 0-d "
            f"launch")
        worst_rows = max(worst_rows, *e)
        say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, B {B}, Sq "
            f"{sq}, Skv {skv}, G {H // KV}, window {w}) at row positions "
            f"{positions} (window cuts the rows at {cut}), {got[1].shape[2]} "
            f"splits: partials within the plain version's tolerance, output "
            f"vs plain merge {e[0]:.3e}, vs oracle {e[1]:.3e}, each row "
            f"within the flash tolerance of the oracle of the row alone; "
            f"all rows at {positions[-1]}: bit-equal to the 0-d launch")
    torch.cuda.synchronize()
    worst_rb = phase_row_blocked(dev, gen, hold)
    return {"decode partials": worst, "decode at a device position":
            worst_dev, "decode at row positions": worst_rows,
            "decode in row blocks": worst_rb}


# granite-20b's served decode: 48 query heads over one KV head of D 128,
# the cache of 1024 + 32 positions; the split-K decode runs it in
# ceil(48 / 16) = 3 row blocks
G20_H, G20_D, G20_SMAX = 48, 128, 1056


def phase_row_blocked(dev, gen, hold):
    """The split-K decode past 16 rows (row blocks of 16, each (pair, row
    block) merged on its own) at granite-20b's shape, bf16 and f32: at
    host positions (the last, and a tail at 500 of the cache with finite
    garbage beyond it) at the rule's splits and at 7 and 64; at a 0-d
    device position from 0 to the last (the capacity rule; bit-equal to
    the host-position launch wherever the host rule splits alike), the
    cache beyond each position garbage; at a position per row (bucket 4,
    garbage beyond each row's position), each row against the oracle of
    the row alone and all rows at one position bit-equal to the 0-d
    launch; and 2 queries of 24 heads (row blocks that straddle the two
    queries) with a window at device positions.  Every launch's partials
    against ``flash_decode_partials_torch``, its output against their
    merge and the oracle (``hold``); garbage never leaks.  Returns the
    worst output error."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_decode_partials_torch,
    )

    H, D, Skv = G20_H, G20_D, G20_SMAX
    check(FK.row_blocks(1, H) == 3
          and FK.pick_route(1, H, torch.bfloat16, D, D, device_pos=True)
          == "decode"
          and FK.pick_route(1, H, torch.bfloat16, D, D) == "prefill",
          "the row-blocked decode's route rule")
    worst, n_launch = 0.0, 0

    def garbage(t, start):
        """``t`` with rows from ``start`` on (per batch row: a list) set to
        finite garbage."""
        t = t.clone()
        starts = start if isinstance(start, list) else [start] * len(t)
        for b, s0 in enumerate(starts):
            t[b, s0:] = 1e4
        return t

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q = torch.randn(1, 1, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(1, Skv, 1, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(1, Skv, 1, D, device=dev, generator=gen).to(dtype)
        # host positions
        for name, qs, kvl in (("last", Skv - 1, Skv), ("tail", 499, 500)):
            kw = dict(q_start=qs, kv_len=kvl)
            args = dict(causal=True, window=None, **kw)
            for splits in (None, 7, 64):
                got = FK.flash_decode_cuda(q, k, v, splits=splits, **args)
                want = flash_decode_partials_torch(q, k, v, splits=splits,
                                                   **kw)
                what = (f"row-blocked flash_decode {dn} {name} at host "
                        f"position {qs}, splits {splits}")
                e = hold(what, q, k, v, got, want, kw, dtype)[3:5]
                worst, n_launch = max(worst, *e), n_launch + 1
                if kvl < Skv:
                    dirty = FK.flash_decode_cuda(
                        q, garbage(k, kvl), garbage(v, kvl), splits=splits,
                        **args)[0]
                    check(torch.equal(dirty, got[0]),
                          f"{what}: garbage beyond kv_len leaked")
        # a 0-d device position, the cache beyond it garbage
        cap = FK.capacity_splits(1, 1, 1, H, D, Skv=Skv, causal=True,
                                 window=None)
        same_host = 0
        for t in (0, 31, 32, 500, 1023, 1024, 1040, Skv - 1):
            pos = torch.full((), t, dtype=torch.long, device=dev)
            kd, vd = garbage(k, t + 1), garbage(v, t + 1)
            got = FK.flash_decode_cuda(q, kd, vd, causal=True, window=None,
                                       q_start=pos)
            want = flash_decode_partials_torch(q, k, v, causal=True,
                                               window=None, q_start=pos)
            what = f"row-blocked flash_decode {dn} at device position {t}"
            check(got[1].shape[2] == cap[0],
                  f"{what}: {got[1].shape[2]} splits, the rule {cap[0]}")
            ref_kw = dict(causal=True, window=None, q_start=t, kv_len=t + 1)
            e = hold(what, q, k, v, got, want, ref_kw, dtype)[3:5]
            worst, n_launch = max(worst, *e), n_launch + 1
            clean = FK.flash_decode_cuda(q, k, v, causal=True, window=None,
                                         q_start=pos)[0]
            check(torch.equal(clean, got[0]),
                  f"{what}: garbage beyond the position leaked")
            host = FK.decode_splits(1, 1, 1, H, D, causal=True, window=None,
                                    q_start=t, kv_len=t + 1)
            if (host[0], host[2]) == cap:
                check(torch.equal(got[0], FK.flash_decode_cuda(
                    q, k, v, **ref_kw)[0]),
                    f"{what}: not bit-equal to the host-position launch of "
                    f"the same splits")
                same_host += 1
        # a position per row: bucket 4, garbage beyond each row's position
        positions = [3, 500, 1023, Skv - 1]
        B = len(positions)
        qb = torch.randn(B, 1, H, D, device=dev, generator=gen).to(dtype)
        kb = torch.randn(B, Skv, 1, D, device=dev, generator=gen).to(dtype)
        vb = torch.randn(B, Skv, 1, D, device=dev, generator=gen).to(dtype)
        pos = torch.tensor(positions, dtype=torch.long, device=dev)
        ends = [t + 1 for t in positions]
        got = FK.flash_decode_cuda(qb, garbage(kb, ends), garbage(vb, ends),
                                   causal=True, window=None, q_start=pos)
        want = flash_decode_partials_torch(qb, kb, vb, causal=True,
                                           window=None, q_start=pos)
        what = f"row-blocked flash_decode {dn} at row positions {positions}"
        e = hold(what, qb, kb, vb, got, want,
                 dict(causal=True, window=None, q_start=pos), dtype)[3:5]
        worst, n_launch = max(worst, *e), n_launch + 1
        for b, t in enumerate(positions):
            e_row, ok = fa_err(got[0][b:b + 1], flash_attention(
                qb[b:b + 1], kb[b:b + 1], vb[b:b + 1], impl="ref",
                causal=True, q_start=t, kv_len=t + 1))
            check(ok, f"{what}: row {b} vs the oracle of the row alone: "
                      f"{e_row}")
        one = torch.full((), positions[-1], dtype=torch.long, device=dev)
        check(torch.equal(
            FK.flash_decode_cuda(qb, kb, vb, causal=True, window=None,
                                 q_start=torch.full_like(pos, Skv - 1))[0],
            FK.flash_decode_cuda(qb, kb, vb, causal=True, window=None,
                                 q_start=one)[0]),
            f"{what}: every row at one position is not bit-equal to the 0-d "
            f"launch")
        say(f"flash: row-blocked split-K decode ({dn}, H {H}, KV 1, D {D}, "
            f"{FK.row_blocks(1, H)} row blocks, cache {Skv}): host positions "
            f"(last; tail at 500 with garbage beyond) at the rule's, 7 and "
            f"64 splits, device positions (the capacity rule, {cap[0]} "
            f"splits of {cap[1]} tiles; {same_host} bit-equal to the host "
            f"launch of the same splits) and row positions {positions}, "
            f"garbage beyond each position: partials within the plain "
            f"version's tolerance, output vs plain merge and oracle within "
            f"the flash tolerance, no garbage leaked")
    # 2 queries of 24 heads: 48 rows whose second row block holds rows of
    # both queries, with a window, at device positions
    dtype = torch.float32
    q = torch.randn(1, 2, 24, 64, device=dev, generator=gen)
    k = torch.randn(1, 300, 1, 64, device=dev, generator=gen)
    v = torch.randn(1, 300, 1, 64, device=dev, generator=gen)
    for t in (0, 39, 40, 41, 150, 298):
        pos = torch.full((), t, dtype=torch.long, device=dev)
        got = FK.flash_decode_cuda(q, k, v, causal=True, window=40,
                                   q_start=pos)
        want = flash_decode_partials_torch(q, k, v, causal=True, window=40,
                                           q_start=pos)
        e = hold(f"row-blocked flash_decode Sq 2 G 24 window 40 at {t}", q,
                 k, v, got, want, dict(causal=True, window=40, q_start=t,
                                       kv_len=t + 2), dtype)[3:5]
        worst, n_launch = max(worst, *e), n_launch + 1
    torch.cuda.synchronize()
    say(f"flash: row-blocked split-K decode: {n_launch} launches held, "
        f"worst output error {worst:.3e}")
    return worst


# ---------------------------------------------------------------------------
# Phases 4 and 5: the recurrence kernels against their plain versions
# ---------------------------------------------------------------------------


def wkv6_err(got, want, mag, N):
    """(max abs err, within tolerance) of two WKV-6 outputs: the flash
    phase's tolerance plus the error bound of two f32 sums of N + 1 terms
    taken in different orders, 2 (N + 1) 2^-24 times the sum of the terms'
    magnitudes (``mag``): an output that cancels to near 0 keeps the
    rounding of its large terms."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    slack = 2 * (N + 1) * 2.0 ** -24 * mag.float()
    if got.dtype == torch.float32:
        allowed = FA_ATOL32 + FA_RTOL32 * b.abs() + slack
    else:
        allowed = bf16_ulp(torch.maximum(a.abs(), b.abs())) + FA_ATOL16 \
            + slack
    share = float((diff / allowed).max())
    return float(diff.max()), share <= 1.0, share


# ---------------------------------------------------------------------------
# Phase 11: this slice's attention shapes (the A7 models' served calls)
# ---------------------------------------------------------------------------

# seamless-m4t-medium: 16 heads of 64, one KV head each; its cache of
# smax = 1024 + GEN rows; deepseek-v3-671b's expanded MLA prefill: 128
# heads, D 192 (128 + 64), Dv 128, its own softmax scale
SEAMLESS_H, SEAMLESS_D, MLA_H, MLA_D, MLA_DV = 16, 64, 128, 192, 128
MLA_SCALE = MLA_D ** -0.5


def a7_cases(dev, dtype, gen):
    """label -> (q, k, v, kw) of each new attention shape, kw the call's
    arguments: the encoder's non-causal prefill (1024 frames), the
    cross-attention prefill (1024 tokens over the 1024 fresh frames, and
    700 tokens over 1000 for a non-square one), the cross-attention
    decode over the padded buffer of smax rows at a device kv_len (int32,
    0-d, and ``(4,)`` with four lengths), MLA's (192, 128) causal
    prefill."""
    smax = 1024 + GEN

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    H, D = SEAMLESS_H, SEAMLESS_D
    out = {
        "encoder prefill": (rnd(1, 1024, H, D), rnd(1, 1024, H, D),
                            rnd(1, 1024, H, D),
                            dict(causal=False, q_start=0, kv_len=1024)),
        "cross prefill": (rnd(1, 1024, H, D), rnd(1, 1024, H, D),
                          rnd(1, 1024, H, D),
                          dict(causal=False, q_start=0, kv_len=1024)),
        "cross prefill 700x1000": (rnd(1, 700, H, D), rnd(1, 1000, H, D),
                                   rnd(1, 1000, H, D),
                                   dict(causal=False, q_start=0,
                                        kv_len=1000)),
    }
    lens = {"cross decode": [1024],
            "cross decode (4,)": [1024, 1000, 517, 33]}
    for label, ls in lens.items():
        B = len(ls)
        n = torch.tensor(ls, dtype=torch.int32, device=dev)
        out[label] = (rnd(B, 1, H, D), rnd(B, smax, H, D),
                      rnd(B, smax, H, D),
                      dict(causal=False, q_start=0,
                           kv_len=n[0] if B == 1 else n))
    out["mla prefill"] = (rnd(1, 1024, MLA_H, MLA_D),
                          rnd(1, 1024, MLA_H, MLA_D),
                          rnd(1, 1024, MLA_H, MLA_DV),
                          dict(causal=True, q_start=0, kv_len=1024,
                               softmax_scale=MLA_SCALE))
    return out


def phase_flash_a7(dev, err):
    """Each new attention shape, bf16 and f32: the routed kernel (the one
    the served path launches) and every other kernel that takes the call
    against the plain version and the oracle, at the flash phase's
    tolerance; at a device kv_len the split-K partials against the plain
    partials, the buffer beyond each row's length filled with garbage that
    must not leak, and one launch captured in a CUDA graph and replayed at
    other lengths (written into the same int32 tensor) bit-equal to eager
    launches at those lengths: the kernel reads the length on the device,
    with no host sync.  Returns the worst error by route."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, (q, k, v, kw) in a7_cases(dev, dtype, gen).items():
            kv = kw["kv_len"]
            args = dict(causal=kw["causal"], window=None, q_start=0,
                        kv_len=kv, softmax_scale=kw.get("softmax_scale"))
            wants = {impl: flash_attention(
                q, k, v, impl=impl, causal=kw["causal"], kv_len=kv,
                softmax_scale=kw.get("softmax_scale"))
                for impl in ("torch", "ref")}
            route = FK.pick_route(q.shape[1], q.shape[2] // k.shape[2],
                                  dtype, q.shape[3], v.shape[3],
                                  device_pos=torch.is_tensor(kv))
            kernels = {"routed": FK.flash_attention_cuda}
            if not torch.is_tensor(kv):
                # the other kernels that take the call (the routed one is
                # held above)
                kernels.update((r, fn) for r, fn in flash_routes(
                    dtype, q.shape[3], v.shape[3],
                    q.shape[1] * q.shape[2] // k.shape[2]).items()
                    if r != route)
            line = []
            for name, fn in kernels.items():
                got = fn(q, k, v, **args)
                if not torch.is_tensor(kv):
                    check(torch.equal(fn(q, k, v, **args), got),
                          f"flash {label} {dtype} {name} ({route}): a "
                          f"second launch differs from the first")
                for impl, want in wants.items():
                    e, ok = fa_err(got, want)
                    check(ok, f"flash {label} {dtype} {name} ({route}) vs "
                              f"{impl}: max abs err {e}")
                    err["flash_attention"] = max(err["flash_attention"], e)
                    r = route if name == "routed" else name
                    worst[r] = max(worst.get(r, 0.0), e)
                    line.append(f"{name} vs {impl} {e:.3e}")
            if torch.is_tensor(kv):
                line.append(check_device_len(q, k, v, kv, args, dtype,
                                             label))
            say(f"flash a7: {label} ({str(dtype).split('.')[1]}, B "
                f"{q.shape[0]}, Sq {q.shape[1]}, Skv {k.shape[1]}, H "
                f"{q.shape[2]}, KV {k.shape[2]}, D {q.shape[3]}, Dv "
                f"{v.shape[3]}, causal {kw['causal']}, kv_len "
                f"{kv.tolist() if torch.is_tensor(kv) else kv}; route "
                f"{route}): max abs err {', '.join(line)}")
    torch.cuda.synchronize()
    say(f"flash a7: every new shape within the flash tolerance; worst by "
        f"route {worst}")
    return worst


def check_device_len(q, k, v, kv, args, dtype, label):
    """The split-K decode at a device ``kv`` (int32): its partials against
    the plain partials, garbage past each row's length not leaking, and
    a captured launch replayed at other lengths bit-equal to eager ones.
    Returns a line for the log."""
    from repro_torch.core.capture import CapturedCall
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_decode_partials_torch)

    out, m, l, acc = FK.flash_decode_cuda(q, k, v, causal=False, window=None,
                                          q_start=0, kv_len=kv)
    pm, pl, pacc = flash_decode_partials_torch(q, k, v, causal=False,
                                               kv_len=kv)
    live = torch.isfinite(pm)
    check(torch.equal(live, torch.isfinite(m)),
          f"{label}: the kernel's empty splits differ from the plain ones")
    tol = lambda a, b, mag: bool(((a - b).abs() <= SPLIT_TOL + SPLIT_TOL
                                  * mag).all())
    vmax = float(v.float().abs().max())
    check(tol(m[live], pm[live], pm[live].abs())
          and tol(l, pl, pl) and tol(acc, pacc, pl[..., None] * vmax),
          f"{label} {dtype}: split-K partials at a device kv_len vs the "
          f"plain partials")
    # garbage past each row's length
    lens = kv.reshape(-1).tolist()
    k2, v2 = k.clone(), v.clone()
    for b in range(k.shape[0]):
        n = lens[b if len(lens) > 1 else 0]
        k2[b, n:] = 1e4
        v2[b, n:] = -1e4
    check(torch.equal(FK.flash_attention_cuda(q, k2, v2, **args), out),
          f"{label} {dtype}: garbage beyond the device kv_len leaked")
    # captured once, replayed at other lengths
    n_dev = kv.clone()
    call = CapturedCall(lambda: FK.flash_attention_cuda(
        q, k, v, **dict(args, kv_len=n_dev)), q.device)
    others = [[max(1, x - 1) for x in lens], [min(k.shape[1], x + 37)
                                              for x in lens]]
    for ls in others:
        n_dev.copy_(torch.tensor(ls if len(lens) > 1 else ls[0],
                                 dtype=torch.int32))
        got = call.replay()
        want = FK.flash_attention_cuda(q, k, v, **dict(args, kv_len=n_dev))
        check(torch.equal(got, want),
              f"{label} {dtype}: a captured launch replayed at kv_len {ls} "
              f"differs from the eager launch")
    return (f"partials within {SPLIT_TOL}, no leak past kv_len, captured "
            f"replays at kv_len {others} bit-equal to eager")


#: calls of each function in the CUDA graph ``graph_ms`` replays
A7_GRAPH_CALLS = 8


def graph_ms(fn, args, dev, reps=10):
    """ms a call of ``fn(*args)``: CUDA events around ``reps`` replays of
    one CUDA graph of A7_GRAPH_CALLS calls, after two replays."""
    from repro_torch.core.capture import CapturedCall
    call = CapturedCall(lambda: [fn(*args) for _ in range(A7_GRAPH_CALLS)],
                        dev)
    for _ in range(2):
        call.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        call.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * A7_GRAPH_CALLS)


def time_a7_shapes(card, dev):
    """Each new bf16 attention shape: the routed kernel's ms a call, its
    bound, the plain version's and SDPA's (the torch call; the cross
    decode's kv_len as a mask, MLA's scale as ``scale``) and, at a host
    position routed elsewhere, the simple kernel's: CUDA events over
    replays of a graph of A7_GRAPH_CALLS calls (``graph_ms``), which holds
    no host issue and needs no trace (a trace that lost events read a
    third of the time)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    out = {}
    for label, (q, k, v, kw) in a7_cases(dev, torch.bfloat16, gen).items():
        kv = kw["kv_len"]
        args = dict(causal=kw["causal"], window=None, q_start=0, kv_len=kv,
                    softmax_scale=kw.get("softmax_scale"))
        lens = kv.reshape(-1).tolist() if torch.is_tensor(kv) else [kv]
        mask = None
        if torch.is_tensor(kv):
            mask = (torch.arange(k.shape[1], device=dev)[None]
                    < kv.reshape(-1, 1))[:, None, None, :]

        def kern(q, k, v):
            return FK.flash_attention_cuda(q, k, v, **args)

        def plain(q, k, v):
            return flash_attention(q, k, v, impl="torch",
                                   causal=kw["causal"], kv_len=kv,
                                   softmax_scale=kw.get("softmax_scale"))

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=kw["causal"],
                scale=kw.get("softmax_scale"),
                enable_gqa=True).transpose(1, 2)

        route = FK.pick_route(q.shape[1], q.shape[2] // k.shape[2],
                              q.dtype, q.shape[3], v.shape[3],
                              device_pos=torch.is_tensor(kv))
        fns = [("kernel", kern), ("plain", plain), ("sdpa", sdpa)]
        if route not in ("simple", "decode"):
            fns.append(("simple", lambda q, k, v: FK.flash_simple_cuda(
                q, k, v, **args)))
        t = {n: graph_ms(fn, (q, k, v), dev) for n, fn in fns}
        bounds = [fa_bound(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                           dict(q_start=0, kv_len=n,
                                causal=kw["causal"]))
                  for b, n in enumerate(lens * q.shape[0]
                                        if len(lens) == 1 else lens)]
        b_ms = sum(b for b, _ in bounds)
        o_ms = sum(o for _, o in bounds)
        out[label] = dict(
            route=route, source=FLASH_SOURCES[route], ms=t["kernel"],
            plain_ms=t["plain"], library_ms=t["sdpa"],
            simple_ms=t.get("simple"),
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            shape=dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                       H=q.shape[2], KV=k.shape[2], D=q.shape[3],
                       Dv=v.shape[3], causal=kw["causal"], kv_len=lens))
        say(f"timing: flash_attention a7 {label} ({route}, bf16, "
            f"{out[label]['shape']}): us per call in a replayed graph "
            f"(CUDA events): kernel "
            f"{t['kernel'] * 1e3:.2f}, bound {max(b_ms, o_ms) * 1e3:.3f} "
            f"({out[label]['bound_by']}), plain {t['plain'] * 1e3:.2f}, "
            f"sdpa {t['sdpa'] * 1e3:.2f}"
            + (f", simple kernel {t['simple'] * 1e3:.2f}" if "simple" in t
               else "") + f" [{card}]")
    return out


def phase_wkv6(dev, err):
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # (B, T, with s0): batch 1 as served, batch 2 at a T that ends in a
    # ragged chunk, and the batched decode's one-step runs at buckets 4
    # and 8
    runs = [(1, T, s) for T in (1, 7, 256, 1000, 1024) for s in (False, True)]
    runs += [(2, 1000, False), (2, 3 * WK.CHUNK + 5, True)]
    runs += [(B, 1, s) for B in (N_REQ, 2 * N_REQ) for s in (False, True)]
    n, worst_share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for N in WK.HEAD_SIZES:
            H = 4096 // N if N == 64 else 4     # rwkv6-7b: 64 heads of 64
            for B, T, with_s0 in runs:
                r, k, v = (rnd(B, T, H, N).to(dtype) for _ in range(3))
                w = torch.exp(-torch.exp(rnd(B, T, H, N))).to(dtype)
                u = (0.5 * rnd(H, N)).to(dtype)
                s0 = rnd(B, H, N, N) if with_s0 else None
                o, sT = WK.wkv6_cuda(r, k, v, w, u, initial_state=s0)
                ow, sw = wkv6_ref(r, k, v, w, u, s0)
                # a bound on the summands of each output: the same
                # recurrence on |r|, |k|, |v|, |u|, |s0| (w > 0)
                mag = wkv6_ref(r.abs(), k.abs(), v.abs(), w, u.abs(),
                               None if s0 is None else s0.abs())[0]
                e, ok, share = wkv6_err(o, ow, mag, N)
                worst_share = max(worst_share, share)
                what = f"wkv6 {dtype} N={N} B={B} H={H} T={T} s0={with_s0}"
                check(ok, f"{what}: output max abs err {e}")
                check(torch.equal(sT, sw), f"{what}: final state not "
                      f"bit-equal (max abs err "
                      f"{float((sT - sw).abs().max())})")
                err["wkv6"] = max(err["wkv6"], e)
                if with_s0:             # the final state over s0, in place
                    s_in = s0.clone()
                    o_in, s_out = WK.wkv6_cuda(r, k, v, w, u,
                                               initial_state=s_in,
                                               state_out=s_in)
                    check(s_out is s_in and torch.equal(s_in, sT)
                          and torch.equal(o_in, o),
                          f"{what}: the in-place run differs")
                if T == 7:              # one step a launch: decode path
                    s_step = None if s0 is None else s0.clone()
                    outs = []
                    for t in range(T):
                        o_t, s_step = WK.wkv6_cuda(
                            r[:, t:t + 1].contiguous(),
                            k[:, t:t + 1].contiguous(),
                            v[:, t:t + 1].contiguous(),
                            w[:, t:t + 1].contiguous(), u,
                            initial_state=s_step, state_out=s_step)
                        outs.append(o_t)
                    check(torch.equal(s_step, sT)
                          and torch.equal(torch.cat(outs, 1), o),
                          f"{what}: the run one step a launch differs")
                if T > 1:               # the state threaded across two runs
                    h = T // 2
                    o1, s1 = WK.wkv6_cuda(r[:, :h].contiguous(),
                                          k[:, :h].contiguous(),
                                          v[:, :h].contiguous(),
                                          w[:, :h].contiguous(), u,
                                          initial_state=s0)
                    o2, s2 = WK.wkv6_cuda(r[:, h:].contiguous(),
                                          k[:, h:].contiguous(),
                                          v[:, h:].contiguous(),
                                          w[:, h:].contiguous(), u,
                                          initial_state=s1,
                                          state_out=s1)
                    check(s2 is s1 and torch.equal(s2, sT)
                          and torch.equal(torch.cat([o1, o2], 1), o),
                          f"{what}: the split run differs")
                n += 1
    torch.cuda.synchronize()
    say(f"wkv6: {n} cases (f32/bf16, N {WK.HEAD_SIZES}, (B, T, s0) in "
        f"{runs}; chunk {WK.CHUNK}, tile {WK.TILE_COLS}, row split "
        f"{WK.ROW_SPLIT}): outputs within tolerance of the plain version, "
        f"worst {err['wkv6']:.3e}, at most {worst_share:.3f} of the allowed "
        f"error; final states bit-equal; in-place runs, split runs with "
        f"the state threaded in place and T 7 one step a launch bit-equal "
        f"to the whole run")


def rglru_cases(RK) -> tuple[list, list, list]:
    """(D values, T values, (D, B, T) cases) of phase 5: a group of 16
    channels, a ragged group (40), rows that are not 16-byte aligned (37)
    and Griffin's width, at B 2 (Griffin's width at B 1, as served one
    request a step); T at 1, around the route threshold and a chunk, and
    2560; and at Griffin's width the batched decode's steps at buckets 4
    and 8, T 1 and STEP_MAX_T."""
    Ds = [16, 37, 40, 2560]
    Ts = sorted({1, 5, RK.STEP_MAX_T - 1, RK.STEP_MAX_T, RK.STEP_MAX_T + 1,
                 RK.CHUNK - 1, RK.CHUNK, RK.CHUNK + 1, 2560})
    cases = [(D, 1 if D == 2560 else 2, T) for D in Ds for T in Ts]
    cases += [(2560, B, T) for B in (N_REQ, 2 * N_REQ)
              for T in (1, RK.STEP_MAX_T)]
    return Ds, Ts, cases


def phase_rglru(dev, err):
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    Ds, Ts, cases = rglru_cases(RK)
    n = n_equal = n_split = 0
    worst_hT = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for D, B, T in cases:
            for with_h0 in (False, True):
                la = -0.5 * torch.exp(torch.randn(B, T, D, device=dev,
                                                  generator=gen))
                gx = torch.randn(B, T, D, device=dev,
                                 generator=gen).to(dtype)
                h0 = torch.randn(B, D, device=dev, generator=gen) \
                    if with_h0 else None
                what = f"rglru {dtype} B={B} D={D} T={T} h0={with_h0}"
                # both kernels, whatever the route: the same bits
                h, hT = RK.rglru_staged_cuda(la, gx, h0)
                hs, hTs = RK.rglru_step_cuda(la, gx, h0)
                check(torch.equal(h, hs) and torch.equal(hT, hTs),
                      f"{what}: the staged kernel differs from the step "
                      f"kernel (h max abs err "
                      f"{float((h.float() - hs.float()).abs().max())}, "
                      f"hT {float((hT - hTs).abs().max())})")
                hw, hTw = rglru_ref(la, gx, h0)
                e, ok = fa_err(h, hw)
                eT = float((hT - hTw).abs().max())
                check(ok, f"{what}: h max abs err {e}")
                check(torch.allclose(hT, hTw, rtol=RG_RTOL,
                                     atol=RG_ATOL),
                      f"{what}: hT max abs err {eT}")
                err["rglru"] = max(err["rglru"], e, eT)
                worst_hT = max(worst_hT, eT)
                n_equal += int(torch.equal(h, hw)
                               and torch.equal(hT, hTw))
                if with_h0:         # the final state over h0, in place
                    s_in = h0.clone()
                    h_in, s_out = RK.rglru_cuda(la, gx, s_in,
                                                state_out=s_in)
                    check(s_out is s_in and torch.equal(s_in, hT)
                          and torch.equal(h_in, h),
                          f"{what}: the in-place run differs")
                # the carry threaded across two routed runs: at the
                # middle, and after STEP_MAX_T steps (the first run on
                # the step kernel, the second on the staged one)
                for c in {T // 2, RK.STEP_MAX_T} - {0, T}:
                    if c > T:
                        continue
                    h1, s1 = RK.rglru_cuda(la[:, :c].contiguous(),
                                           gx[:, :c].contiguous(), h0)
                    h2, s2 = RK.rglru_cuda(la[:, c:].contiguous(),
                                           gx[:, c:].contiguous(), s1,
                                           state_out=s1)
                    check(s2 is s1 and torch.equal(s2, hT)
                          and torch.equal(torch.cat([h1, h2], 1), h),
                          f"{what}: the run split after {c} steps "
                          f"({RK.pick_route(c)} + "
                          f"{RK.pick_route(T - c)}) differs")
                    n_split += 1
                n += 1
    torch.cuda.synchronize()
    say(f"rglru: {n} cases (gx f32/bf16, D {Ds} (B 2, Griffin's 2560 B 1), "
        f"T {Ts}, and Griffin's 2560 at (B, T) "
        f"{[(B, T) for D, B, T in cases if B > 2]}, with and without h0; "
        f"staged kernel: {RK.CHANNELS} "
        f"channels a block, chunks of {RK.CHUNK}, {RK.STAGES} stages; the "
        f"step kernel takes T <= {RK.STEP_MAX_T}): the staged and the step "
        f"kernel bit-equal on h and hT in every case; h within tolerance of "
        f"the plain version, hT within rtol {RG_RTOL} + atol {RG_ATOL} "
        f"(worst {worst_hT:.3e}); {n_equal} of {n} bit-equal to the plain "
        f"version; in-place runs and {n_split} split runs (across the route "
        f"boundary too) bit-equal to the whole run")


# ---------------------------------------------------------------------------
# Phase 6: the main path
# ---------------------------------------------------------------------------


def seeded_inputs(g, rng):
    from repro_torch.core.executor import input_nodes
    return {g.nodes[u].name: rng.standard_normal(g.sizes[u] // 4)
            .astype(np.float32) for u in input_nodes(g)}


def phase_main(rng):
    import repro_torch as rt
    from repro_torch.graphs import BENCHMARK_GRAPHS, FULL_NETWORKS, swiftnet_cell
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena.elemwise import EXACT_OPS

    # the planner integers known from the JAX package
    g = swiftnet_cell("A")
    plain = rt.plan(g, rt.PlanConfig(rewrite=False))
    rew = rt.plan(g, rt.PlanConfig())
    peaks = (plain.baseline_peaks["kahn"], plain.peak_bytes, rew.peak_bytes)
    check(peaks == (3920 * 1024, 3038 * 1024, 2744 * 1024),
          f"swiftnet_cell_a peaks {peaks}")
    say(f"planner: swiftnet_cell_a TFLite {peaks[0]} B -> SERENITY "
        f"{peaks[1]} B -> rewrite {peaks[2]} B")

    graphs = {**BENCHMARK_GRAPHS, **FULL_NETWORKS}
    plans = {name: rt.plan(mk(), rt.PlanConfig()) for name, mk in graphs.items()}
    inputs = {name: seeded_inputs(p.graph, rng) for name, p in plans.items()}

    reset_launches()
    per_graph = {}
    for name, p in plans.items():
        before = dict(LAUNCHES)
        ref = rt.run_reference(p.graph, inputs[name])
        for fuse in (False, True):
            res = rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                             fuse=fuse)
            check(res.realized_matches_plan
                  and res.realized_peak_bytes == p.peak_bytes
                  and res.realized_arena_bytes == p.arena_bytes,
                  f"{name} fuse={fuse}: realized != planned")
            check(set(res.outputs) == set(ref), f"{name}: output names")
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            exact = all(set(ops) <= EXACT_OPS
                        for _, ops, _ in prog._groups.values())
            for k, v in ref.items():
                got = res.outputs[k]
                check(got.shape == v.shape and bool(torch.isfinite(got).all()),
                      f"{name}: output {k} shape or finiteness")
                if not fuse or exact:
                    check(torch.equal(got, v),
                          f"{name} fuse={fuse}: {k} not bit-equal to "
                          f"run_reference")
                else:
                    check(torch.allclose(got, v, rtol=CHAIN_RTOL,
                                         atol=CHAIN_ATOL),
                          f"{name} fuse={fuse}: {k} not allclose")
            if name == "darts_imagenet_cell" and fuse:
                counts = (prog.n_regions, prog.n_fused_nodes,
                          max(len(r) for r in prog.regions))
                check(counts == (31, 23, 4), f"darts fusion counts {counts}")
        torch.cuda.synchronize()
        per_graph[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        say(f"main: {name}: {len(p.graph)} nodes, peak {p.peak_bytes} B, "
            f"arena {p.arena_bytes} B, realized == planned (slice, fused), "
            f"slice bit-equal to run_reference, fused "
            f"{'bit-equal' if exact else 'allclose'}; launches {per_graph[name]}")

    # serving-state packing: mixed dtypes through the uint8 write/read
    p = plans["darts_imagenet_cell"]
    ids, taken = [], []     # nodes whose first 64 bytes overlap no other's
    for u in p.order:
        o = p.arena.offset_of(u)
        if p.graph.sizes[u] >= 64 and len(ids) < 4 and \
                all(o + 64 <= t or t + 64 <= o for t in taken):
            ids.append(u)
            taken.append(o)
    dts = (torch.float32, torch.int32, torch.float16, torch.uint8)
    arrays = {u: torch.from_numpy(rng.integers(0, 100, 16)).to(dt)
              for u, dt in zip(ids, dts)}
    packed = rt.pack_buffers(p.arena, arrays)
    for u, x in arrays.items():
        back = rt.unpack_buffer(packed, p.arena, u, x.shape, x.dtype)
        check(torch.equal(back.cpu(), x), f"pack/unpack node {u} {x.dtype}")
    torch.cuda.synchronize()

    captured = phase_capture(rt, plans, inputs, rng)

    launches = dict(LAUNCHES)
    say(f"main: launches over the run (eager and captured) {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    return plans, inputs, launches, per_graph, captured


# the arena kernels' names in a trace, by launch count key
ARENA_KERNELS = {"write": "arena_write_kernel", "read": "arena_read_kernel",
                 "accum": "accum_kernel", "chain_write": "chain_write_kernel"}


def phase_capture(rt, plans, inputs, rng):
    """``jit=True`` on every paper graph and full network, slice and fused:
    the first call (the capture's warm-up) and a replay bit-equal to the
    eager run, a replay with other inputs right against ``run_reference``
    of those (bit-equal where the eager run is), the first replay's
    outputs not overwritten by the second, realized == planned, and the
    arena launches per replay, both as the capture counted them and as the
    most complete of three traces of a replay holds them (more, up to
    TRACE_TRIES, while none holds them all), equal to the eager run's.  Returns {(name, fuse): launches per replay}."""
    import functools

    from repro_torch.kernels.arena import LAUNCHES
    from repro_torch.kernels.arena.elemwise import EXACT_OPS

    out = {}
    for name, p in plans.items():
        other = seeded_inputs(p.graph, rng)
        refs = {"first": rt.run_reference(p.graph, inputs[name]),
                "other": rt.run_reference(p.graph, other)}
        for fuse in (False, True):
            run = functools.partial(rt.execute, p.graph, plan=p.arena,
                                    order=p.order, fuse=fuse)
            before = dict(LAUNCHES)
            eager = run(inputs[name]).outputs
            torch.cuda.synchronize()
            per_exec = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            res = {"first": run(inputs[name], jit=True),
                   "again": run(inputs[name], jit=True)}
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            call = prog._captures[None][0]
            traces, traced = [], {}
            while len(traces) < 3 or (traced != per_exec
                                      and len(traces) < TRACE_TRIES):
                traces.append(device_profile(
                    lambda: run(inputs[name], jit=True)))
                traced = max(({op: traced_copies(t[2], op)[1]
                               for op in ARENA_KERNELS} for t in traces),
                             key=lambda d: sum(d.values()))
            res["other"] = run(other, jit=True)
            torch.cuda.synchronize()
            exact = not fuse or all(set(ops) <= EXACT_OPS
                                    for _, ops, _ in prog._groups.values())
            what = f"{name} {'fused' if fuse else 'slice'} jit=True"
            for key, r in res.items():
                check(r.realized_matches_plan
                      and r.realized_peak_bytes == p.peak_bytes
                      and r.realized_arena_bytes == p.arena_bytes,
                      f"{what} ({key}): realized != planned")
                ref = refs["other" if key == "other" else "first"]
                check(set(r.outputs) == set(ref), f"{what}: output names")
                for k, v in ref.items():
                    got = r.outputs[k]
                    if key != "other":
                        check(torch.equal(got, eager[k]),
                              f"{what} ({key}): {k} not bit-equal to the "
                              f"eager run")
                    if exact:
                        check(torch.equal(got, v),
                              f"{what} ({key}): {k} not bit-equal to "
                              f"run_reference")
                    else:
                        check(torch.allclose(got, v, rtol=CHAIN_RTOL,
                                             atol=CHAIN_ATOL),
                              f"{what} ({key}): {k} not allclose to "
                              f"run_reference")
            for k in eager:
                check(torch.equal(res["again"].outputs[k], eager[k]),
                      f"{what}: a replay's output {k} was overwritten by "
                      f"the next replay")
            per_replay = {k: call.launches[k] for k in per_exec}
            check(per_replay == per_exec,
                  f"{what}: launches per replay {per_replay}, the eager run "
                  f"{per_exec}")
            check(traced == per_exec,
                  f"{what}: the most complete of {len(traces)} traces of a "
                  f"replay holds {traced} arena kernels, the eager run "
                  f"launches {per_exec}")
            out[(name, fuse)] = per_exec
            say(f"capture: {what}: first call, replay and a replay with "
                f"other inputs bit-equal to the eager run and "
                f"{'bit-equal' if exact else 'allclose'} to run_reference, "
                f"realized == planned; arena launches per replay "
                f"{per_replay} (in a traced replay {traced}; activities in "
                f"the traces {[t[1] for t in traces]}), as the eager "
                f"run's; {call.replays} replays")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the graph bridge (core/fx_bridge.py), run after phase 6
# ---------------------------------------------------------------------------


# (program, x shape): each of ``repro_torch.graphs.programs`` at the bench's
# size (``wide``'s weights take 64 columns), and ``nas_cell`` at a size
# whose 76 MB arena makes the copies real work
BRIDGE_CASES = (("wide", (64, 64)), ("nas_cell", (64, 128)),
                ("nas_like", (64, 128)), ("moe_fanout", (64, 128)),
                ("branchy_residual", (64, 128)), ("mixed", (64, 128)),
                ("nas_cell", (2048, 1024)))
# where repro's bridge is exact (tests/test_jax_bridge.py:59 gates
# nas_cell; tests/test_torch_fx_bridge.py holds the others' integers)
BRIDGE_EXACT = ("wide", "nas_cell", "nas_like", "moe_fanout",
                "branchy_residual")
BRIDGE_REPS = 20


def bridge_close(got, want) -> bool:
    """Bit-equal: the scheduled program runs the unscheduled function's
    aten ops on the same bytes, in another order."""
    return got.dtype == want.dtype and torch.equal(got, want)


def event_us(fn, reps=BRIDGE_REPS) -> float:
    """Median us per call of ``fn()`` by CUDA events around each call
    (the host's issue included), after two warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def phase_bridge(dev, card) -> dict:
    """The graph bridge on the card: each BRIDGE_CASES program traced,
    scheduled (``schedule_fx``; host seconds) and run through the planned
    uint8 arena by ``compile_scheduled``, eagerly and captured
    (``jit=True``).  Checks, each fatal: the program through the arena
    kernels against the same program through their plain versions (outputs
    and final arena bytes bit-equal), outputs bit-equal to the unscheduled
    function's on the card, eager and
    captured bit-equal (a replay, and a replay with other inputs against
    an eager run on those; a replay's outputs not overwritten by the next),
    realized == optimal peak, arena >= peak, ``exact`` where repro's is,
    and the arena launches per call (write: one per threaded tensor; read:
    one per op and distinct threaded input) in each eager call, in the
    capture's count and in the most complete of up to TRACE_TRIES traces
    of a replay; both kernels launched.  Prints nodes, planning seconds,
    the peaks, the caching allocator's peak over one call of the
    unscheduled function and of the eager arena program, and us per call (unscheduled, eager arena,
    captured).  Returns {case: record}."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.core import fx_bridge as fb
    from repro_torch.graphs.programs import PROGRAMS
    from repro_torch.kernels.arena import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    for name, shape in BRIDGE_CASES:
        case = f"{name} {shape[0]}x{shape[1]}"
        fn, make_args = PROGRAMS[name]
        args = make_args(torch.randn(shape, device=dev, generator=gen))
        other = make_args(torch.randn(shape, device=dev, generator=gen))
        t0 = time.perf_counter()
        gm = fb.trace_fn(fn, *args)
        _, rep = fb.schedule_fx(gm)
        plan_s = time.perf_counter() - t0
        n_nodes = len(fb.fx_to_graph(gm)[0])
        torch.cuda.synchronize()

        eager = fb.compile_scheduled(fn)
        per_call = []
        for a in (args, args, other):
            reset_launches()
            res = eager(*a)
            torch.cuda.synchronize()
            per_call.append(dict(LAUNCHES))
        r = eager.report
        want = {k: 0 for k in LAUNCHES}
        want.update(write=r.n_arena_writes, read=r.n_arena_reads)
        check(all(c == want for c in per_call),
              f"bridge {case}: arena launches per eager call {per_call}, "
              f"the program's {want}")
        check(want["write"] > 0 and want["read"] > 0,
              f"bridge {case}: an arena kernel was not launched: {want}")
        check(r.realized_bytes == r.optimal_peak and r.realized_matches_plan,
              f"bridge {case}: realized {r.realized_bytes} B != optimal "
              f"peak {r.optimal_peak} B")
        check(r.arena_bytes >= r.optimal_peak,
              f"bridge {case}: arena {r.arena_bytes} B below the peak")
        check(r.exact or name not in BRIDGE_EXACT,
              f"bridge {case}: the plan fell back (exact=False)")
        check((r.optimal_peak, r.arena_bytes) == (rep.optimal_peak,
                                                 rep.arena_bytes),
              f"bridge {case}: compile_scheduled's plan differs from "
              f"schedule_fx's")

        # each arena kernel against its plain version at this program's
        # shapes and offsets: the same program on the same inputs, once
        # through the kernels and once through the plain versions, each in
        # its own zeroed arena; the aten ops between are the same calls on
        # the same bytes, so outputs and final arena bytes are bit-equal
        prog = eager.program
        flat = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        arenas = {impl: torch.zeros(max(r.arena_bytes, 1), dtype=torch.uint8,
                                    device=dev) for impl in ("auto", "torch")}
        with torch.no_grad():
            held = {impl: prog.run(arenas[impl], flat, impl=impl)
                    for impl in arenas}
        torch.cuda.synchronize()
        check(all(torch.equal(k, p) for k, p in zip(held["auto"],
                                                      held["torch"]))
              and torch.equal(arenas["auto"], arenas["torch"]),
              f"bridge {case}: the arena kernels' program differs from the "
              f"plain versions' (outputs or final arena bytes)")

        want_first = tree_leaves(fn(*args))
        want_other = tree_leaves(fn(*other))
        got_first = tree_leaves(eager(*args))
        got_other = tree_leaves(res)
        for got, ref in ((got_first, want_first), (got_other, want_other)):
            check(len(got) == len(ref) and all(
                bridge_close(g, w) for g, w in zip(got, ref)),
                f"bridge {case}: the arena program's outputs are not "
                f"bit-equal to the unscheduled function's: "
                f"{[(g - w).abs().max().item() for g, w in zip(got, ref)]}")

        cap = fb.compile_scheduled(fn, jit=True)
        runs = {"first": cap(*args), "again": cap(*args)}
        kept = [t.clone() for t in tree_leaves(runs["again"])]
        runs["other"] = cap(*other)
        torch.cuda.synchronize()
        for key, y in runs.items():
            ref = got_other if key == "other" else got_first
            check(all(torch.equal(g, w)
                      for g, w in zip(tree_leaves(y), ref)),
                f"bridge {case} jit=True ({key}): not bit-equal to the "
                f"eager arena program")
        check(all(torch.equal(g, w) for g, w in zip(
            tree_leaves(runs["again"]), kept)),
            f"bridge {case}: a replay's output was overwritten by the next")
        call = cap.program.capture
        per_replay = {k: call.launches.get(k, 0) for k in LAUNCHES}
        check(per_replay == want,
              f"bridge {case}: launches per replay {per_replay}, the "
              f"program's {want}")
        traces, traced = [], {}
        while len(traces) < 3 or (traced != per_replay
                                  and len(traces) < TRACE_TRIES):
            traces.append(device_profile(lambda: cap(*args)))
            traced = max(({op: traced_copies(t[2], op)[1]
                           for op in ARENA_KERNELS} for t in traces),
                         key=lambda d: sum(d.values()))
        check(traced == per_replay,
              f"bridge {case}: the most complete of {len(traces)} traces of "
              f"a replay holds {traced} arena kernels, the program launches "
              f"{per_replay}")

        # the caching allocator's peak over one call of the unscheduled
        # function, its inputs counted as the arena holds them: what
        # PyTorch takes for the same program
        # and the same over one eager call of the arena program (its arena,
        # the fresh tensors of its reads, each op's output before its
        # write), from the same base: the bridge's own measured memory
        in_bytes = sum(t.numel() * t.element_size() for t in flat)

        def peak_of(call) -> int:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            call(*args)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated(dev) - base + in_bytes

        del arenas, held
        alloc_peak, bridge_peak = peak_of(fn), peak_of(eager)
        us = {"plain": event_us(lambda: fn(*args)),
              "eager": event_us(lambda: eager(*args)),
              "captured": event_us(lambda: cap(*args))}
        rec = dict(nodes=n_nodes, plan_s=plan_s, original_peak=r.original_peak,
                   kahn_peak=r.kahn_peak, optimal_peak=r.optimal_peak,
                   arena_bytes=r.arena_bytes, exact=r.exact,
                   realized_bytes=r.realized_bytes,
                   n_env_bypassed=r.n_env_bypassed,
                   launches_per_call={"write": want["write"],
                                      "read": want["read"]},
                   traced=traced, allocator_peak=alloc_peak,
                   bridge_peak=bridge_peak, us=us)
        out[case] = rec
        say(f"bridge: {case}: {rec['nodes']} nodes, planned in "
            f"{plan_s:.2f} s (host); traced / Kahn / optimal / arena "
            f"{r.original_peak} / {r.kahn_peak} / {r.optimal_peak} / "
            f"{r.arena_bytes} B, exact {r.exact}, realized == optimal; "
            f"allocator peak (inputs counted) of one call: unscheduled "
            f"{alloc_peak} B, eager arena program {bridge_peak} B; "
            f"arena launches per call {rec['launches_per_call']} (eager, "
            f"per replay and traced {traced}); kernels bit-equal to the "
            f"plain versions in the program, outputs bit-equal to the "
            f"unscheduled function's, captured bit-equal to eager; us per "
            f"call (CUDA events, "
            f"median of {BRIDGE_REPS}): unscheduled {us['plain']:.1f}, "
            f"eager arena {us['eager']:.1f}, captured {us['captured']:.1f}"
            f" [{card}]")
    say(f"bridge: phase done in {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 7: serving each model at full width
# ---------------------------------------------------------------------------


KERNEL_MODULES = ("arena", "flash_attention", "rwkv6", "rglru", "optim")


def reset_all():
    import importlib
    for m in KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{m}").reset_launches()


def all_launches() -> dict:
    import importlib
    out = {}
    for m in KERNEL_MODULES:
        out.update(importlib.import_module(f"repro_torch.kernels.{m}")
                   .LAUNCHES)
    return out


def backward_routes() -> dict:
    """The flash backward's calls by kernel since the counts were last set
    to 0 (``reset_all``): the tensor-core kernel's and the CUDA-core
    one's."""
    from repro_torch.kernels.flash_attention import kernel as FK
    return dict(FK.BACKWARD_ROUTES)


def path_launches(cfg, n_cache: int, n_req: int = N_REQ,
                  batched: bool = False) -> dict:
    """Every kernel's launches over the serving run of ``n_req`` requests:
    each request runs one prefill and GEN - 1 decode steps; every forward
    runs one attention or recurrence kernel per layer of its kind
    (attention in bf16: the ``wgmma`` prefill for a prompt, the split-K
    decode for a decode step, the simple kernel never); each prefill packs
    the ``n_cache`` state leaves once, each decode step unpacks and packs
    them.  ``batched``: the requests decode together (vmap), so a decode
    step's forward runs once a tick for all of them, while the state is
    still unpacked and packed row by row.  The encoder-decoder and MLA
    count their own attention (below)."""
    want = {k: 0 for k in all_launches()}
    steps = n_req * (GEN - 1)
    forwards = GEN - 1 if batched else steps
    want["write"] = n_cache * (n_req + steps)
    want["read"] = n_cache * steps
    if cfg.is_encoder_decoder:
        # a prompt: the encoder's non-causal prefill, the decoder's causal
        # self and non-causal cross prefill in each layer; a decode step:
        # the self and the cross decode (kv_len on the device) a layer
        want["flash_prefill"] = n_req * (cfg.encoder_layers + 2 * cfg.n_layers)
        want["flash_decode"] = forwards * 2 * cfg.n_layers
        return want
    if cfg.mla is not None:
        # the expanded prefill at (192, 128), by the served dtype's route
        # (bf16: the ``wgmma`` prefill); the absorbed decode runs no kernel
        want[FLASH_LAUNCHES[mla_route(cfg, torch.bfloat16)]] = \
            n_req * cfg.n_layers
        return want
    if cfg.attn_free:
        kinds = ["wkv6"] * cfg.n_layers
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        kinds = ["rglru" if pat[i % len(pat)] == "rec" else "flash_attention"
                 for i in range(cfg.n_layers)]
    else:
        kinds = ["flash_attention"] * cfg.n_layers
    for k in kinds:
        if k == "flash_attention":
            want["flash_prefill"] += n_req
            want["flash_decode"] += forwards
        else:
            want[k] += n_req + forwards
    return want


def mla_route(cfg, dtype) -> str:
    """The kernel MLA's expanded prefill takes in ``dtype``: a prompt (more
    than 16 rows) at (D, Dv) = (nope + rope, v) at a host position."""
    from repro_torch.kernels.flash_attention import kernel as FK
    m = cfg.mla
    return FK.pick_route(FK.DECODE_MAX_ROWS + 1, 1, dtype,
                         m.qk_nope_head_dim + m.qk_rope_head_dim,
                         m.v_head_dim)


def live_leaves(cfg, params, dev):
    """Fill the recurrent mixing leaves, which the init leaves at zeros or
    ones (so that the token shift, the bonus, the convolution and every
    RG-LRU carry do nothing), with seeded values, in place:
    RWKV-6 mu_x, mu, mu_k, mu_r ~ U(0, 1); lora_b, wb ~ N(0, 0.02^2); w0
    evenly spaced over [-6, -1] across channels; u ~ N(0, 0.5^2).
    Griffin conv_w ~ N(0, 0.5^2); conv_b ~ N(0, 0.1^2); lam such that
    exp(-8 softplus(lam)) ~ U(0.9, 0.999).  (The CPU tests draw the same
    recipe with numpy.)"""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def rand(t):
        return torch.rand(t.shape, device=dev, generator=gen)

    def normal(t, std):
        return std * torch.randn(t.shape, device=dev, generator=gen)

    if cfg.attn_free:
        tm, cm = params["blocks"]["tmix"], params["blocks"]["cmix"]
        for t in (tm["mu_x"], tm["mu"], cm["mu_k"], cm["mu_r"]):
            t.copy_(rand(t))
        for t in (tm["lora_b"], tm["wb"]):
            t.copy_(normal(t, 0.02))
        tm["w0"].copy_(torch.linspace(-6.0, -1.0, cfg.d_model, device=dev)
                       .expand(tm["w0"].shape))
        tm["u"].copy_(normal(tm["u"], 0.5))
    elif cfg.family == "hybrid":
        for r in [params["groups"]["rec"]["rec"]] + \
                [t["rec"] for t in params["tail"] if "rec" in t]:
            r["conv_w"].copy_(normal(r["conv_w"], 0.5))
            r["conv_b"].copy_(normal(r["conv_b"], 0.1))
            a = 0.9 + 0.099 * rand(r["lam"])
            r["lam"].copy_(torch.log(torch.expm1(-torch.log(a) / 8.0)))


def prefill_batch(model, prompt, dev, rid=0):
    """The prefill batch of request ``rid`` as the server makes it: the
    prompt's tokens, and for an encoder-decoder its frames
    (``launch/serve.py:encoder_frames``, seeded by ``rid``)."""
    from repro_torch.launch import serve as S
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.long,
                                       device=dev)[None]}
    if model.cfg.is_encoder_decoder:
        batch["frames"] = S.encoder_frames(rid, len(prompt),
                                           model.cfg.d_model, dev)
    return batch


def cast_floats(tree, dtype):
    """The floating leaves of ``tree`` in ``dtype`` (an integer leaf, the
    encoder-decoder's ``enc_len``, as it is)."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def direct_decode(model, params, prompt, n_steps, dev, *, impl="auto",
                  forced=None, dtype=None, rid=0):
    """Prefill + ``n_steps`` greedy decode steps with the cache kept as
    plain tensors (no arena); returns (tokens, per-step logits).  With
    ``forced``, step s feeds token ``forced[s]`` instead of its own; with
    ``dtype``, the cache's floating leaves are kept in that dtype; ``rid``
    picks an encoder-decoder request's frames."""
    P = len(prompt)
    cache = model.init_cache(1, P + GEN, dev)
    if dtype is not None:
        cache = cast_floats(cache, dtype)
    logits, cache = model.prefill_fn(params, cache,
                                     prefill_batch(model, prompt, dev, rid),
                                     impl=impl)
    toks, outs = [int(torch.argmax(logits, -1)[0])], [logits]
    for s in range(n_steps):
        tok = toks[-1] if forced is None else forced[s]
        t = torch.full((1, 1), tok, dtype=torch.long, device=dev)
        logits, cache = model.decode_fn(params, cache, t, P + s, impl=impl)
        toks.append(int(torch.argmax(logits, -1)[0]))
        outs.append(logits)
    return toks, outs


class RouteLog:
    """The MoE's routing over eager forwards: while open, every
    ``moe_dispatch`` of ``repro_torch.models.layers`` records its own
    top-K experts and their gates (``routes``, one ``(idx, gate)`` pair of
    ``(G, N, K)`` tensors a call, the gates detached) and each token's
    top-K margin, the K-th minus the (K+1)-th router probability
    (``margin``).  With ``force`` (the ``routes`` of another run, call by
    call) each call takes the forced experts and the forced gates instead
    of its own, and counts the tokens whose own top-K set differs from the
    forced one (a flip) with their margins.  A flip swaps one expert's
    output for another's, and a gate computed from another run's router
    carries that run's rounding into the expert mix: forcing one run's
    routing and gates on the other keeps both out of a comparison of the
    kernels, and the flips are counted beside it.  The training form,
    ``own_gates``, forces the expert ids alone: the gates are this run's
    router probabilities at the forced ids, normalised over the K as
    ``moe_route`` normalises them, so the router's gradient flows in
    both runs (forced with its own ids, a run gives its own bits).  Calls
    are forced in order, a block that ``remat`` runs again in the
    backward included.  Captured replays run no Python and record
    nothing."""

    def __init__(self, force=None, own_gates=False):
        self.force = None if force is None else iter(force)
        self.own_gates = own_gates
        self.routes, self.margin, self.flip_margins = [], [], []
        self.flips = 0

    def __enter__(self):
        from repro_torch.models import layers as L
        self._L, self._orig = L, L.moe_dispatch
        L.moe_dispatch = self._dispatch
        return self

    def __exit__(self, *exc):
        self._L.moe_dispatch = self._orig

    def _dispatch(self, probs, cfg, capacity_factor):
        L, K = self._L, cfg.n_experts_per_tok
        top = torch.topk(probs, K + 1, dim=-1).values
        margin = top[..., K - 1] - top[..., K]
        gate, idx = L.moe_route(probs, K)
        self.routes.append((idx, gate.detach()))
        self.margin.append(margin.detach())
        if self.force is not None:
            want, want_gate = next(self.force)
            flip = (idx.sort(-1).values != want.sort(-1).values).any(-1)
            self.flips += int(flip.sum())
            self.flip_margins += margin[flip].tolist()
            idx, gate = want, want_gate
            if self.own_gates:
                g = torch.gather(probs, -1, want)
                gate = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        return (gate, idx, *L.moe_slots(idx, cfg, capacity_factor))

    def rows(self, b):
        """The routes of batch row ``b`` alone (per-row dispatch groups)."""
        return [(i[b:b + 1], g[b:b + 1]) for i, g in self.routes]

    def summary(self) -> dict:
        """Routed (token, layer) pairs, the smallest top-K margin met,
        flips against the forced routing and the largest margin at a
        flip."""
        m = torch.cat([x.reshape(-1) for x in self.margin])
        return dict(routed=int(m.numel()), min_margin=float(m.min()),
                    flips=self.flips,
                    max_flip_margin=max(self.flip_margins, default=0.0))


def _routed(moe, force=None, own_gates=False):
    return RouteLog(force, own_gates) if moe else contextlib.nullcontext()


def has_moe_layers(cfg) -> bool:
    """Whether ``cfg`` (its depth cut or not) runs an MoE layer: experts,
    and layers past its leading dense ones (deepseek-v3-671b cut to its
    three dense layers runs none)."""
    return bool(cfg.n_experts) and cfg.n_layers > cfg.n_dense_layers


# deliberately broken flash kernels that a decoder's logit checks must
# catch (each reading above the check's atol): query head 0's output
# zeroed; every output a relative 2^-6 too large (four bf16 ulps, as a
# softmax denominator 1.6% short would make it); the softmax scale 5% off
# (q scaled by 1.05); a length on the device one too long (the
# cross-attention reads one padded encoder row, which holds zeros: a key
# of score 0 and value 0).  Every f32 check of ``DECODERS`` holds the
# first three, a bf16 check those of its model's ``bf16_controls``; the
# ``A7`` models name theirs for both.
CONTROLS = {
    "head0_zeroed": lambda call, q, kw: call(q, kw).index_fill_(
        2, torch.tensor([0], device=q.device), 0),
    "out_x(1+2^-6)": lambda call, q, kw: call(q, kw).mul_(1 + 2 ** -6),
    "q_x1.05": lambda call, q, kw: call(q * 1.05, kw),
    "kv_len+1": lambda call, q, kw: call(q, dict(
        kw, kv_len=kw["kv_len"] + 1) if torch.is_tensor(kw.get("kv_len"))
        else kw),
}


@contextlib.contextmanager
def broken_decode(fault, scope="decode"):
    """Every decode call (Sq = 1) of the flash wrapper (with ``scope``
    "all", every call) through ``fault`` (a ``CONTROLS`` entry) while
    open."""
    from repro_torch.kernels.flash_attention import kernel as FK
    orig = FK.flash_attention_cuda

    def broken(q, k, v, **kw):
        call = lambda qq, kk: orig(qq, k, v, **kk)
        return fault(call, q, kw) if q.shape[1] == 1 or scope == "all" \
            else call(q, kw)

    FK.flash_attention_cuda = broken
    try:
        yield
    finally:
        FK.flash_attention_cuda = orig


def check_logits(model, params, prompt, dev, f32=True, bf16=True):
    """Prefill + LOGIT_STEPS decode steps through the kernels and through
    the plain versions, in bf16 as served (``bf16``) and (``f32``) with
    params and cache in f32, every run fed the kernels' bf16 greedy tokens
    (the f32 runs their own f32 kernels' tokens without ``bf16``); returns
    the max abs logit differences (bf16 kernels vs plain, f32 kernels vs
    plain, bf16 plain vs f32 plain; None where not run), the max |logit|
    and a dict: for a model of ``DECODERS`` or ``A7``, ``controls``, the runs
    with a deliberately broken kernel against the plain run, which the
    checks' limits must catch (in f32 the model's ``f32_controls``, else
    the first three of ``CONTROLS``; in bf16 its ``bf16_controls``);
    for an MoE model also the routing (``RouteLog``): each plain run (and
    each broken run) routed and gated as its kernels' run, its own flips
    counted (bf16 and f32)."""
    from repro_torch.models.params import tree_map
    moe = bool(model.cfg.n_experts)
    spec = {**DECODERS, **A7}.get(model.cfg.name, {})
    controls = bool(spec)
    scope = spec.get("scope", "decode")
    diff = lambda xs, ys: max(float((a - b).abs().max())
                              for a, b in zip(xs, ys))
    routes = {"controls": {}} if controls else {}
    e = e32 = gap = plain = forced = None
    peak = 0.0

    def held(p, dtype, key, names):
        # the kernels' run, the plain run routed as it, and the controls
        nonlocal forced
        mla = model.cfg.mla is not None
        if mla:
            reset_all()
        with _routed(moe) as rec:
            toks, auto = direct_decode(model, p, prompt, LOGIT_STEPS, dev,
                                       forced=forced, dtype=dtype)
        if mla:
            # the expanded prefill, one launch a layer on its dtype's route
            # (bf16: the wgmma prefill; f32: the simple kernel), and no
            # other flash launch (the absorbed decode runs none)
            got = all_launches()
            route = mla_route(model.cfg, dtype or torch.bfloat16)
            want = {n: 0 for n in FLASH_LAUNCHES.values()}
            want[FLASH_LAUNCHES[route]] = model.cfg.n_layers
            check({n: got[n] for n in want} == want,
                  f"{model.cfg.name} {key}: flash launches over prefill + "
                  f"{LOGIT_STEPS} decode steps {got}, the path needs {want}")
            say(f"serve: {model.cfg.name} {key}: MLA's prefill on the "
                f"{route} route, {model.cfg.n_layers} launches")
        check(all(bool(torch.isfinite(a).all())
                  and a.shape == (1, model.cfg.vocab_size) for a in auto),
              "logits not finite or of the wrong shape")
        if forced is None:
            forced = toks[:LOGIT_STEPS]
        force = rec.routes if moe else None
        with _routed(moe, force) as prec:
            _, ref = direct_decode(model, p, prompt, LOGIT_STEPS, dev,
                                   impl="torch", forced=forced, dtype=dtype)
        if moe:
            routes[key] = prec.summary()
            routes["kernels_" + key] = rec.summary()
        if controls:
            for name in names:
                with broken_decode(CONTROLS[name], scope), \
                        _routed(moe, force):
                    bad = direct_decode(model, p, prompt, LOGIT_STEPS, dev,
                                        forced=forced, dtype=dtype)[1]
                routes["controls"][f"{name} {key}"] = diff(bad, ref)
        return auto, ref

    if bf16:
        auto, plain = held(params, None, "bf16",
                           spec.get("bf16_controls", ()))
        e = diff(auto, plain)
        peak = max(float(a.abs().max()) for a in auto)
    if f32:
        p32 = tree_map(lambda t: t.float(), params)
        a32, t32 = held(p32, torch.float32, "f32", spec.get(
            "f32_controls", ("head0_zeroed", "out_x(1+2^-6)", "q_x1.05")))
        del p32
        e32 = diff(a32, t32)
        gap = None if plain is None else diff(plain, t32)
        peak = max(peak, max(float(a.abs().max()) for a in a32))
    torch.cuda.empty_cache()
    return e, e32, gap, peak, routes


def check_recurrence_matters(model, params, prompt, dev):
    """With the live leaves, zeroing the carried state between prefill and
    the first decode step must move the logits."""
    from repro_torch.models.params import tree_map
    cfg = model.cfg
    groups = (("tm_x", "cm_x"), ("wkv",)) if cfg.attn_free \
        else (("conv",), ("h",))
    P = len(prompt)
    cache = model.init_cache(1, P + GEN, dev)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    logits, cache = model.prefill_fn(params, cache, {"tokens": tokens})
    tok = torch.argmax(logits, -1)[:, None]

    def step(zero):
        c = tree_map(lambda t: t.clone(), cache)
        for d in [c] if cfg.attn_free else \
                [c["rec"]] + [x for x in c["tail"] if "h" in x]:
            for name in zero:
                d[name].zero_()
        return model.decode_fn(params, c, tok, P)[0]

    base = step(())
    moved = {"+".join(z): float((step(z) - base).abs().max())
             for z in groups}
    check(all(m > 1e-3 for m in moved.values()),
          f"{cfg.name}: zeroing the carried state did not move the logits "
          f"{moved}")
    return moved


def check_served_packing(model, params, plan, req, dev):
    """The u8 arena kernels at the served sizes: one request's prefilled
    cache packed into an arena of the plan's resident extent (random bytes
    to start with) by the kernels and by their plain versions must give the
    same arena, with each leaf's bytes at its planned offset; unpacking it
    both ways must give the leaves back, bit for bit."""
    from repro_torch.core.executor import pack_buffers, unpack_buffer
    from repro_torch.kernels.arena.kernel import copy_plan
    from repro_torch.models.params import tree_leaves

    cache = model.init_cache(1, len(req.prompt) + GEN, dev)
    _, cache = model.prefill_fn(params, cache,
                                prefill_batch(model, req.prompt, dev,
                                              req.rid))
    leaves = dict(enumerate(tree_leaves(cache)))
    apl = plan["plan"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    start = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    packed = {impl: pack_buffers(apl, leaves, arena=start.clone(), impl=impl,
                                 device=dev) for impl in ("cuda", "torch")}
    torch.cuda.synchronize()
    check(torch.equal(packed["cuda"], packed["torch"]),
          "served cache: the u8 write kernel's arena differs from the plain "
          "version's")
    spans, modes = [], set()
    for i, leaf in leaves.items():
        raw = leaf.reshape(-1).view(torch.uint8)
        o, n = apl.offset_of(i), raw.numel()
        spans.append((o, n))
        modes.add(copy_plan(packed["cuda"].data_ptr() + o, raw.data_ptr(),
                            n).mode)
        check(torch.equal(packed["cuda"][o:o + n], raw),
              f"served cache leaf {i}: bytes not at planned offset {o}")
        backs = {impl: unpack_buffer(packed["cuda"], apl, i, leaf.shape,
                                     leaf.dtype, impl=impl)
                 for impl in ("cuda", "torch")}
        for impl, back in backs.items():
            check(back.dtype == leaf.dtype and torch.equal(
                back.reshape(-1).view(torch.uint8), raw),
                f"served cache leaf {i}: unpacked by {impl} != the leaf")
    torch.cuda.synchronize()
    say(f"serve: one prefilled {model.cfg.name} cache "
        f"({', '.join(str(t.dtype).split('.')[1] for t in leaves.values())}"
        f") packed into {plan['resident_extent']} B by the u8 write kernel "
        f"and by its plain version: arenas bit-equal, leaves (offset, bytes) "
        f"{spans} at their planned offsets (copy modes {sorted(modes)}); "
        f"unpacked by the u8 read kernel and by its plain version: "
        f"bit-equal to the leaves")
    return spans


def served_config(arch):
    """``arch``'s config as served here: published, or (an ``A7`` model
    with ``depth``) at published width with its depth cut."""
    import repro_torch.configs as configs
    return configs.cut_depth(configs.get(arch), SERVES[arch].get("depth"))


def phase_serve(dev, arch):
    """One model behind ``run_server`` at its published width (see the
    module's phase 7); a model of ``DECODERS`` other than the MoE one has
    its logits held here in bf16 only (an f32 copy of its weights would not
    fit beside them), and in f32 at a cut depth by ``check_cut_f32``."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.params import leaf_count, tree_leaves
    from repro_torch.models.zoo import build_model

    spec = SERVES[arch]
    f32 = arch not in DECODERS or arch == MOE_ARCH
    if "f32_depth" in spec:       # held in f32 at a cut depth instead
        f32 = False
    prompt_len = spec["prompt"]
    cfg = served_config(arch)
    model = build_model(cfg)
    smax = prompt_len + GEN
    plan = S.plan_decode_arena(model, 1, smax)
    got = {k: plan[k] for k in spec["plan"]}
    check(got == spec["plan"], f"{arch} decode plan {got} != reference "
                               f"{spec['plan']}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    live_leaves(cfg, params, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == leaf_count(model.defs),
          f"{n_params} parameters made, {leaf_count(model.defs)} defined")
    free, total = torch.cuda.mem_get_info()
    depth = f"{cfg.n_layers} layers" if "depth" not in spec else (
        f"{cfg.n_layers} layers, the depth cut from "
        f"{configs.get(arch).n_layers}")
    if cfg.is_encoder_decoder:
        depth = f"{cfg.encoder_layers} encoder + {depth}"
    say(f"serve: {arch} at full width ({depth}, d "
        f"{cfg.d_model}, H {cfg.n_heads}, KV {cfg.n_kv_heads}, D "
        f"{cfg.head_dim}), {n_params} parameters in bf16 "
        f"({cfg.param_count()} without the norm scales) made on the card "
        f"in {time.perf_counter() - t0:.3f} s; {free} of {total} B of "
        f"device memory free beside them; decode plan {got}, policy "
        f"{plan['policy']} (the reference's integers)")

    budget = 4 * plan["arena_bytes"]      # the CLI's default budget
    reqs = S.synth_requests(N_REQ, prompt_len, GEN, cfg.vocab_size, SEED + 1)
    reset_all()
    m = S.run_server(model, params, reqs, smax=smax, budget_bytes=budget,
                     warm=2)
    torch.cuda.synchronize()
    launches = all_launches()
    say(f"serve: {arch}: {m['n_served']}/{m['n_requests']} served, "
        f"{m['n_rejected']} rejected, {m['n_tokens']} tokens in "
        f"{m['wall_s']:.2f} s over {m['steps']} ticks, concurrency "
        f"{m['max_concurrent']} under {budget} B; launches over the run "
        f"{launches}")
    check(m["n_served"] == N_REQ and m["n_rejected"] == 0
          and m["n_tokens"] == N_REQ * GEN,
          f"served {m['n_served']}, rejected {m['n_rejected']}, "
          f"{m['n_tokens']} tokens")
    want = path_launches(cfg, plan["n_cache"])
    for k, n in want.items():
        check(launches[k] == n, f"{arch}: {k} launched {launches[k]} times, "
                                f"the serving path needs {n}")
    routes = None
    if want["rglru"]:
        # each prompt through the staged kernel, each decode step through
        # the step kernel, in every recurrent layer
        from repro_torch.kernels.rglru import kernel as RK
        layers = want["rglru"] // (N_REQ * GEN)
        routes = dict(RK.ROUTES)
        need = {"step": layers * N_REQ * (GEN - 1), "staged": layers * N_REQ}
        check(routes == need and RK.pick_route(prompt_len) == "staged"
              and RK.pick_route(1) == "step",
              f"{arch}: rglru launches by kernel {routes}, the serving path "
              f"needs {need}")
        say(f"serve: {arch}: rglru launches by kernel {routes} (staged "
            f"prefills, step decodes)")
    spans = check_served_packing(model, params, plan, reqs[0], dev)

    for r in reqs:
        toks, _ = direct_decode(model, params, r.prompt, GEN - 1, dev,
                                rid=r.rid)
        check(toks == list(r.tokens),
              f"{arch} request {r.rid}: server tokens differ from the "
              f"arena-free loop")
    e, e32, gap, peak, routing = check_logits(model, params, reqs[0].prompt,
                                              dev, f32=f32)
    tol, tol32 = spec["logit_atol"], spec.get("f32_atol", LOGIT_ATOL32)
    check(e32 is None or e32 <= tol32,
          f"{arch}: f32 logits of the kernels vs the plain versions: max "
          f"abs err {e32} > {tol32}")
    check(e <= tol, f"{arch}: bf16 logits of the kernels vs the plain "
                    f"versions: max abs err {e} > {tol}")
    f32_said = "at a cut depth below" if e32 is None else \
        f"{e32:.3e} (atol {tol32})"
    gap_said = "" if gap is None else \
        f"; the plain versions' bf16 logits vs their f32 ones {gap:.3e}"
    say(f"serve: {arch}: tokens of all {N_REQ} requests bit-equal to the "
        f"arena-free prefill + decode loop; prefill + {LOGIT_STEPS} decode "
        f"steps' logits, kernels vs plain versions: f32 max abs err "
        f"{f32_said}, bf16 {e:.3e} (atol {tol}){gap_said}; max |logit| "
        f"{peak:.3f}")
    if routing:
        check_routes(arch, routing, tol, e)
    if cfg.attn_free or cfg.family == "hybrid":
        moved = check_recurrence_matters(model, params, reqs[0].prompt, dev)
        say(f"serve: {arch}: zeroing the carried state before the first "
            f"decode step moves the logits by {moved} (max abs)")
    return dict(model=model, params=params, plan=plan, reqs=reqs,
                launches=launches, routes=routes, spans=spans, smax=smax,
                metrics=m, logit_err=dict(bf16=e, f32=e32), routing=routing)


# the MoE's routing checks (RouteLog): a token whose own top-K set differs
# between the kernels' run and the plain run, or the batched and the
# serial step (a flip), may only have a top-K margin, the K-th minus the
# (K+1)-th router probability, within ROUTE_TIE of its dtype, about twice
# the most the rounding moved a router probability in the readings: f32
# flips at margins up to 7.9e-7, bf16 up to 1.35e-2 (7,634 and 7,662 flips
# of 33,024 routed tokens; on an NVIDIA H100 80GB HBM3 at 700.00 W)
ROUTE_TIE = {"f32": 1e-5, "bf16": 3e-2}


def check_routes(arch, routing, tol, e):
    """A decoder's logit check against deliberately broken decode kernels
    (``CONTROLS``): each one's logit error must lie above the check's
    atol, ``tol`` in bf16 (which the kernels' own reading ``e`` lies
    within) and LOGIT_ATOL32 in f32; for an MoE model the flips of each
    plain run against its kernels' run (each plain run routed and gated
    as the kernels' run), their margins within ``ROUTE_TIE``."""
    for k in ("bf16", "f32"):
        if k in routing:
            r = routing[k]
            check(r["max_flip_margin"] <= ROUTE_TIE[k],
                  f"{arch}: a routing flip ({k}) between the kernels' and "
                  f"the plain run at a top-K margin of "
                  f"{r['max_flip_margin']} > {ROUTE_TIE[k]}")
    limit = {"bf16": tol, "f32": SERVES[arch].get("f32_atol", LOGIT_ATOL32)}
    for name, bad in routing["controls"].items():
        at = limit[name.rsplit(" ", 1)[1]]
        check(bad > at, f"{arch}: the logits of a broken decode kernel "
                        f"({name}) read {bad} vs the plain versions, within "
                        f"the check's atol {at}: the check would not catch "
                        f"it")
    routed = "; ".join(f"{k} {v}" for k, v in routing.items()
                       if k != "controls")
    if routed:
        routed = (f"; routing of prefill + {LOGIT_STEPS} decode steps, each "
                  f"plain run routed and gated as its kernels' run: "
                  f"{routed} (flips at top-K margins within {ROUTE_TIE})")
    said = ", ".join(f"{k} {v:.3e}" for k, v in routing["controls"].items())
    say(f"serve: {arch}: logits of the kernels vs the plain versions, bf16 "
        f"{'not run' if e is None else f'{e:.3e}'} (atol {tol}), with a "
        f"broken kernel: {said} (atol {tol} in bf16, {limit['f32']} "
        f"in f32){routed}")


# the dense decoders' weights do not fit the card twice at full depth (an
# f32 copy beside the bf16 one), so their kernels' f32 arithmetic (G 1 at D
# 256, G 9, G 8 with qk-norm, G 48 in row blocks) is held at published
# width over CUT_LAYERS layers, at CUT_ATOL32: the sound kernels read
# 3.1e-6-7.2e-6 there, the subtlest of the CONTROLS (every decode output
# 2^-6 too large) 5.4e-3-5.0e-2, and an output 2^-7 too large 2.7e-3-2.5e-2
# (on an NVIDIA H100 80GB HBM3 at 700.00 W)
CUT_LAYERS, CUT_ATOL32 = 4, 2e-4


def floats_in_place(tree):
    """Every floating leaf of a tree of dicts and lists replaced by its f32
    copy, one leaf at a time: each bf16 leaf is freed before the next copy
    is made, so the card holds the f32 weights and one bf16 leaf at most
    beside them, never both trees."""
    # no local name keeps a replaced leaf: only the tree refers to it
    for key in list(tree) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[key], (dict, list)):
            floats_in_place(tree[key])
        elif tree[key].is_floating_point():
            tree[key] = tree[key].float()


def check_cut_f32(arch, dev):
    """``arch`` at published width and CUT_LAYERS layers (an ``A7`` model:
    its ``f32_depth``), weights drawn on the card from SEED and cast to
    f32: prefill + LOGIT_STEPS decode steps' logits through the kernels
    against the plain versions within CUT_ATOL32, each of the model's
    ``CONTROLS`` kernels reading above it (an MoE model's plain runs
    routed and gated as its kernels' run, the flips' top-K margins within
    ``ROUTE_TIE``)."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.zoo import build_model

    # the served model's weights go first: a server or a captured step
    # that held them may wait for the collector
    gc.collect()
    torch.cuda.empty_cache()
    cut = SERVES[arch].get("f32_depth", dict(n_layers=CUT_LAYERS))
    cfg = dataclasses.replace(configs.get(arch), **cut)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    floats_in_place(params)
    prompt = S.synth_requests(1, SERVES[arch]["prompt"], GEN,
                              cfg.vocab_size, SEED + 1)[0].prompt
    _, e32, _, peak, routing = check_logits(model, params, prompt, dev,
                                            f32=True, bf16=False)
    n = cfg.n_layers
    check(e32 <= CUT_ATOL32,
          f"{arch} at {n} layers: f32 logits of the kernels vs the "
          f"plain versions: max abs err {e32} > {CUT_ATOL32}")
    for name, bad in routing["controls"].items():
        check(bad > CUT_ATOL32,
              f"{arch} at {n} layers: the f32 logits of a broken "
              f"kernel ({name}) read {bad}, within {CUT_ATOL32}")
    if cfg.n_experts:
        flip = routing["f32"]["max_flip_margin"]
        check(flip <= ROUTE_TIE["f32"],
              f"{arch} at {n} layers: a routing flip (f32) between the "
              f"kernels' and the plain run at a top-K margin of {flip} > "
              f"{ROUTE_TIE['f32']}")
    batched = None
    if arch in A7:
        # the batched step vs the serial step in f32, held here
        b32, lens, bflips = check_batched_logits(model, params, prompt, dev,
                                                 f32=True)
        check(b32 <= LOGIT_ATOL32 and max(bflips or [0.0])
              <= ROUTE_TIE["f32"],
              f"{arch} at {n} layers: logits of the batched step vs the "
              f"serial step in f32: max abs err {b32} (atol {LOGIT_ATOL32}),"
              f" routing flips at top-K margins {bflips}")
        batched = dict(f32=b32, flips=bflips)
        say(f"serve: {arch} vmap at {n} layers in f32: {LOGIT_STEPS} batched "
            f"decode steps of {N_REQ} rows (prompts of {lens}) vs each row's "
            f"serial step: max abs logit err {b32:.3e} (atol "
            f"{LOGIT_ATOL32}); flips {bflips}")
    free, total = torch.cuda.mem_get_info()
    del model, params
    torch.cuda.empty_cache()
    say(f"serve: {arch} at published width, depth cut to {n} "
        f"layers ({cut}), params and cache in f32 ({free} of {total} B of "
        f"device memory free beside them): prefill + {LOGIT_STEPS} decode "
        f"steps' logits, kernels vs plain versions, max abs err {e32:.3e} "
        f"(atol {CUT_ATOL32}), max |logit| {peak:.3f}; with a broken "
        f"kernel " + ", ".join(f"{k} {v:.3e}" for k, v in
                               routing["controls"].items())
        + (f"; routing {routing.get('f32')}" if cfg.n_experts else ""))
    return dict(f32=e32, controls=routing["controls"], n_layers=n,
                routing=routing.get("f32"), batched=batched)


def hold_tokens(what, model, params, serial, batched, tol, dev):
    """The batched run's tokens against the serial run's, request by
    request: equal, or equal up to a first divergence at a step where the
    serial reference's top-1 margin is under ``tol`` (a tie that rounding
    in the batched products may break the other way).  Returns the
    divergences as (rid, step, margin)."""
    ties = []
    for a, b in zip(serial, batched):
        ta, tb = list(a.tokens), list(b.tokens)
        check(len(ta) == len(tb) == GEN, f"{what} request {a.rid}: "
                                         f"{len(tb)} tokens, {len(ta)} serial")
        if ta == tb:
            continue
        s = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
        toks, outs = direct_decode(model, params, a.prompt, s, dev,
                                   rid=a.rid)
        check(toks == ta[:s + 1], f"{what} request {a.rid}: the arena-free "
                                  f"loop differs from the serial server")
        top2 = outs[s][0].float().topk(2).values
        margin = float(top2[0] - top2[1])
        check(margin < tol,
              f"{what} request {a.rid}: tokens differ from serial at step "
              f"{s}, where the serial top-1 margin {margin} is not under "
              f"{tol}")
        ties.append((a.rid, s, margin))
    return ties


def check_batched_logits(model, params, prompt, dev, f32, rows=N_REQ):
    """LOGIT_STEPS decode steps of ``rows`` requests in one batched step
    against each row decoded alone (the serial step), through the
    kernels, both fed the batched step's greedy tokens: with params and
    cache in f32 (``f32``), or as served; the rows' prompts are cuts of
    ``prompt`` of different lengths, so that each row decodes at its own
    position (an encoder-decoder's rows also take frames of their own, so
    their ``enc_len`` differ).  An MoE model's rows decoded alone are
    routed as the batched step routed them (``RouteLog``), their own flips
    counted.  Returns the
    max abs logit difference, the lengths and the flips' top-K margins
    (an MoE model; else None)."""
    from repro_torch.launch.steps import batch_axes, init_batched_cache
    from repro_torch.models.params import tree_leaves
    cast = (lambda c: cast_floats(c, torch.float32)) if f32 else \
        (lambda c: c)
    p32 = cast(params)
    smax = len(prompt) + GEN
    lens = [len(prompt) - 7 * b for b in range(rows)]
    axes = batch_axes(model, smax)
    batched = cast(init_batched_cache(model, rows, smax, dev))
    caches, toks = [], []
    for b, n in enumerate(lens):
        c = cast(model.init_cache(1, smax, dev))
        logits, c = model.prefill_fn(p32, c, prefill_batch(
            model, prompt[:n], dev, rid=b))
        for ax, dst, one in zip(axes, tree_leaves(batched), tree_leaves(c)):
            dst.narrow(ax, b, 1).copy_(one)
        caches.append(c)
        toks.append(int(torch.argmax(logits, -1)[0]))
    worst = 0.0
    moe = bool(model.cfg.n_experts)
    flips = [] if moe else None
    for s in range(LOGIT_STEPS):
        with _routed(moe) as brec:
            got, batched = model.decode_fn(
                p32, batched, torch.tensor(toks, device=dev)[:, None],
                torch.tensor([n + s for n in lens], device=dev))
        for b in range(rows):
            with _routed(moe, brec.rows(b) if moe else None) as srec:
                want, caches[b] = model.decode_fn(
                    p32, caches[b], torch.tensor([[toks[b]]], device=dev),
                    lens[b] + s)
            if moe:
                flips += srec.flip_margins
            worst = max(worst, float((got[b] - want[0]).abs().max()))
        toks = [int(t) for t in torch.argmax(got, -1).tolist()]
    check(all(bool(torch.isfinite(t.float()).all())
              for t in tree_leaves(batched)),
          f"{model.cfg.name}: the batched state is not finite")
    del p32, batched, caches
    torch.cuda.empty_cache()
    return worst, lens, flips


#: the port's kernels in a trace, by the launch counts' names
TRACE_NAMES = {"write": "arena_write_kernel", "read": "arena_read_kernel",
               "flash_decode": "flash_decode_kernel", "wkv6": "wkv6_kernel",
               "rglru": "rglru_step_kernel"}


def phase_serve_vmap(ctx, card, dev):
    """The batched decode (``step_mode="vmap"``) of one served model at its
    published width: the 4 requests of the serial run through
    ``run_server(step_mode="vmap")`` (one captured step per bucket), their
    tokens against the serial run's (``hold_tokens``) and the kernels'
    launches over the run exactly the batched path's count; the first 3 of
    them, which pad to bucket 4 and reserve the padding row's bytes; the
    logits of LOGIT_STEPS batched steps against the serial step, in f32
    and in bf16 as served; then one
    server's ticks at bucket 4: ms per tick and per token, the launches of
    a tick (the captured step's recorded counts plus one u8 read and write
    a leaf and row), the device's busy time, idle share and activities per
    tick, each kernel's us per launch in the tick's trace, and the row
    staging copies.  Returns the numbers for the JSON.

    An MoE model's batched tokens cannot be held to the serial run's by
    the top-1 margin: a routing flip between the batched and the serial
    step moves the logits far beyond the rounding (the readings: a first
    divergence at a serial top-1 margin of 1.45 on an NVIDIA H100 80GB
    HBM3 at 700.00 W).
    Its divergences from the serial run are recorded instead, its batched
    logits are held routed alike (``check_batched_logits``), and the 4
    requests' tokens of the captured vmap server must equal, bit for bit,
    those of the same server with its batched step run eagerly."""
    from repro_torch.launch import serve as S

    model, params, plan, reqs = (ctx[k] for k in ("model", "params", "plan",
                                                  "reqs"))
    cfg, smax = model.cfg, ctx["smax"]
    name, tol, n_cache = cfg.name, SERVES[cfg.name]["logit_atol"], \
        plan["n_cache"]
    budget, arena = 4 * plan["arena_bytes"], plan["arena_bytes"]
    out = {"serial_wall_s": ctx["metrics"]["wall_s"]}
    for n in (N_REQ, N_REQ - 1):
        vreqs = S.synth_requests(n, len(reqs[0].prompt), GEN, cfg.vocab_size,
                                 SEED + 1)
        check(all(np.array_equal(a.prompt, b.prompt)
                  for a, b in zip(vreqs, reqs)), "the requests' prompts")
        reset_all()
        m = S.run_server(model, params, vreqs, smax=smax, budget_bytes=budget,
                         step_mode="vmap", warm=2)
        torch.cuda.synchronize()
        launches = all_launches()
        check(m["n_served"] == n and m["n_rejected"] == 0
              and m["n_tokens"] == n * GEN and m["max_concurrent"] == n,
              f"{name} vmap, {n} requests: served {m['n_served']}, "
              f"rejected {m['n_rejected']}, {m['n_tokens']} tokens, "
              f"concurrency {m['max_concurrent']}")
        moe = bool(cfg.n_experts)
        ties = hold_tokens(f"{name} vmap", model, params, reqs[:n], vreqs,
                           math.inf if moe else tol, dev)
        want = path_launches(cfg, n_cache, n, batched=True)
        for k, c in want.items():
            check(launches[k] == c, f"{name} vmap, {n} requests: {k} "
                                    f"launched {launches[k]} times, the "
                                    f"batched path needs {c}")
        # n = 4 fills the budget; n = 3 pads to bucket 4, whose padding row
        # is reserved for each step
        check(m["peak_reserved_bytes"] == 4 * arena <= m["budget_bytes"],
              f"{name} vmap, {n} requests: peak reserved "
              f"{m['peak_reserved_bytes']}, 4 arenas {4 * arena}")
        say(f"serve: {name} vmap: {n} requests, {m['n_tokens']} tokens in "
            f"{m['wall_s']:.2f} s ({m['tok_per_s']:.1f} tok/s; serial "
            f"{out['serial_wall_s']:.2f} s for 4) over {m['steps']} ticks, "
            f"bucket 4{' (one padding row)' if n < 4 else ''}, peak reserved "
            f"{m['peak_reserved_bytes']} B = 4 arenas; tokens against the "
            f"serial run: {'all equal' if not ties else ties} (a divergence "
            f"only where the serial top-1 margin < "
            f"{'inf, an MoE' if moe else tol}); launches over the run the "
            f"batched path's count {launches} [{card}]")
        out[f"run_{n}"] = dict(wall_s=m["wall_s"], tok_per_s=m["tok_per_s"],
                               ticks=m["steps"], ties=ties,
                               peak_reserved_bytes=m["peak_reserved_bytes"])
        if moe and n == N_REQ:
            # the same server with its batched step eager
            ereqs = S.synth_requests(n, len(reqs[0].prompt), GEN,
                                     cfg.vocab_size, SEED + 1)
            captured = S.CapturedBatchedDecodeStep
            S.CapturedBatchedDecodeStep = S.BatchedDecodeStep
            try:
                S.run_server(model, params, ereqs, smax=smax,
                             budget_bytes=budget, step_mode="vmap", warm=2)
            finally:
                S.CapturedBatchedDecodeStep = captured
            check([list(r.tokens) for r in ereqs]
                  == [list(r.tokens) for r in vreqs],
                  f"{name} vmap: the captured server's tokens differ from "
                  f"the same server's with its batched step eager")
            say(f"serve: {name} vmap: the {n} requests' tokens of the "
                f"captured server bit-equal to the same server's with its "
                f"batched step run eagerly; against the serial run they "
                f"diverge at (request, step, serial top-1 margin) {ties}, "
                f"no limit (routing flips)")

    # a model held in f32 at a cut depth (its f32 weights do not fit beside
    # its bf16 ones) has its f32 batched logits held there
    cut = "f32_depth" in SERVES[name]
    e32, lens, f32_flips = (None, None, []) if cut else check_batched_logits(
        model, params, reqs[0].prompt, dev, f32=True)
    e16, lens, flips = check_batched_logits(model, params, reqs[0].prompt,
                                            dev, f32=False)
    check((cut or e32 <= LOGIT_ATOL32) and e16 <= tol,
          f"{name}: logits of the batched step vs the serial step: max abs "
          f"err f32 {e32} (atol {LOGIT_ATOL32}), bf16 {e16} (atol {tol})")
    routed = ""
    if flips is not None:
        for k, f in (("f32", f32_flips), ("bf16", flips)):
            check(max(f, default=0.0) <= ROUTE_TIE[k],
                  f"{name}: a routing flip ({k}) between the batched and the "
                  f"serial step at a top-K margin of {max(f, default=0.0)} "
                  f"> {ROUTE_TIE[k]}")
        routed = (f"; each row routed as the batched step routed it: "
                  f"{len(f32_flips)} f32 and {len(flips)} bf16 flips of its "
                  f"own, the largest top-K margins "
                  f"{max(f32_flips, default=0.0):.3e} and "
                  f"{max(flips, default=0.0):.3e} (within {ROUTE_TIE})")
        out["route_flips"] = dict(f32=f32_flips, bf16=flips)
    f32_said = "at the cut depth (below)" if cut else f"{e32:.3e}"
    say(f"serve: {name} vmap: {LOGIT_STEPS} batched decode steps of "
        f"{N_REQ} rows (prompts of {lens}) vs each row's serial step: max "
        f"abs logit err f32 {f32_said} (atol {LOGIT_ATOL32}), bf16 as "
        f"served {e16:.3e} (atol {tol}){routed}")
    out["logit_err_f32"], out["logit_err_bf16"] = e32, e16

    # one server's ticks at bucket 4
    pool = S.make_pool(budget, step_mode="vmap")
    server = S.DecodeServer(model, params, pool, smax=smax,
                            step_mode="vmap")
    for r in S.synth_requests(N_REQ, len(reqs[0].prompt), GEN,
                              cfg.vocab_size, SEED + 1):
        server.submit(r)
    server.step()        # admit + prefill + the first tick (the capture)
    step = server._batched
    check(step.bucket == N_REQ, f"{name}: the live bucket step is of "
                                f"{step.bucket} rows, not {N_REQ}")
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tick_ms = statistics.median(ms)
    want = {k: n for k, n in step.call.launches.items() if n}
    for k in ("read", "write"):
        want[k] = want.get(k, 0) + n_cache * N_REQ
    traces = []
    for _ in range(TOKEN_TRACES):
        reset_all()
        traces.append(device_profile(server.step))
        per_tick = {k: v for k, v in all_launches().items() if v}
        check(per_tick == want,
              f"{name} vmap tick: launches {per_tick}, the captured step's "
              f"{step.call.launches} + {n_cache} leaves x {N_REQ} rows of "
              f"u8 reads and writes = {want}")
    check(step.call.replays >= 8 + TOKEN_TRACES,
          f"{name}: the vmap ticks did not replay the bucket's captured step")
    busy_us, n_dev, by_name = max(traces, key=lambda t: t[1])
    kernel_us = {}
    for k, sub in TRACE_NAMES.items():
        hits = [v for nm, v in by_name.items() if sub in nm]
        if hits:
            kernel_us[k] = (sum(v[0] for v in hits) / sum(v[1] for v in hits),
                            sum(v[1] for v in hits))
    stage_ms = time_staging(server, card)
    del step
    resident = bucket_resident(server, card)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    say(f"timing: serve {name} vmap: {tick_ms:.3f} ms per tick of {N_REQ} "
        f"rows (median of 8, min {min(ms):.3f}, host clock), "
        f"{tick_ms / N_REQ:.3f} ms per token; device busy {busy_us:.1f} us "
        f"per tick, idle share {1 - busy_us / (tick_ms * 1e3):.4f}; "
        f"{n_dev} device activities per tick (the most of "
        f"{[t[1] for t in traces]}; no limit); launches per tick {want}; "
        f"the port's kernels in the tick's trace, us per launch (launches): "
        + ", ".join(f"{k} {u:.2f} ({c})" for k, (u, c) in kernel_us.items())
        + f" [{card}]")
    say(f"timing: serve {name} vmap tick, device us by kernel (count): "
        + "; ".join(f"{k[:60]} {t:.1f} ({c})" for k, (t, c) in top))
    out["tick"] = dict(
        ms=tick_ms, min_ms=min(ms), ms_per_token=tick_ms / N_REQ,
        busy_us=busy_us, idle_share=1 - busy_us / (tick_ms * 1e3),
        activities=n_dev, launches=want, kernel_us=kernel_us,
        staging=stage_ms, resident=resident)
    del server
    torch.cuda.empty_cache()
    return out


def bucket_resident(server, card):
    """The device memory the server's live bucket step holds: its static
    ``(bucket, smax)`` cache, and the allocated and reserved bytes freed
    when the step goes (the cache and the graph's private pool).  The
    server keeps one bucket's step at a time; this drops it (the server
    holds its last reference) with the garbage collector off, as a new
    bucket does: what it frees, it frees at once."""
    from repro_torch.models.params import tree_leaves
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(server._batched.cache))
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    alloc, held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    server._batched = None
    torch.cuda.empty_cache()
    out = dict(bucket=N_REQ, cache_bytes=cache_bytes,
               allocated_bytes=alloc - torch.cuda.memory_allocated(),
               reserved_bytes=held - torch.cuda.memory_reserved())
    gc.enable()
    check(out["allocated_bytes"] >= cache_bytes,
          f"{server.model.cfg.name}: dropping the bucket-{N_REQ} step freed "
          f"{out['allocated_bytes']} B, less than its static cache "
          f"{cache_bytes} B: something still holds it")
    say(f"serve: {server.model.cfg.name} vmap: the bucket-{N_REQ} step "
        f"holds {out['allocated_bytes']} B allocated "
        f"({out['reserved_bytes']} B reserved): its static cache "
        f"{cache_bytes} B and its graph pool; the server keeps one bucket's "
        f"step at a time [{card}]")
    return out


def time_staging(server, card):
    """The row staging copies of one tick at bucket 4: each row's state
    copied from the staging tree into its row of the batched cache and
    back (one strided copy a leaf and direction), device us per tick in
    each direction, against the bound (each row's state read and written
    once)."""
    from repro_torch.models.params import tree_leaves
    cache = server._batched.cache
    stage = tree_leaves(server._stage)
    rows_in, rows_out = [], []
    for i in range(N_REQ):
        for ax, rows, one in zip(server._batch_axes, tree_leaves(cache),
                                 stage):
            rows_in.append((rows.narrow(ax, i, 1), one))
            rows_out.append((one, rows.narrow(ax, i, 1).view(one.shape)))
    row_bytes = sum(t.numel() * t.element_size() for t in stage)
    bound_us = 2 * row_bytes / HBM_BYTES_PER_S * 1e6
    out = {}
    for label, args in (("in", rows_in), ("out", rows_out)):
        dev_ms, call_ms = time_replay(args, lambda d, s: d.copy_(s), reps=5)
        out[label] = dict(us_per_tick=dev_ms * 1e3 * len(args),
                          us_per_row=dev_ms * 1e3 * len(args) / N_REQ,
                          host_us_per_tick=call_ms * 1e3 * len(args))
    out["bound_us_per_row"] = bound_us
    out["row_bytes"] = row_bytes
    say(f"timing: serve {server.model.cfg.name} vmap row staging copies "
        f"({len(stage)} leaves, {row_bytes} B a row): device us per row "
        f"in {out['in']['us_per_row']:.2f}, out {out['out']['us_per_row']:.2f}"
        f" (bound {bound_us:.2f}: the row read and written once); per tick "
        f"of {N_REQ} rows in {out['in']['us_per_tick']:.1f}, out "
        f"{out['out']['us_per_tick']:.1f} [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 8: timings
# ---------------------------------------------------------------------------


# the lead of every trace: LEAD_SPINS of torch.cuda._sleep's kernel, about
# a millisecond in all.  A trace can lose its first kernels, several of
# them, and not its last (tools/trace_lead_probe.py), so the lead is many
# short kernels, not one long one
LEAD_CYCLES, LEAD_SPINS, LEAD_KERNEL = 125_000, 16, "spin_kernel"


def device_profile(work, required=True):
    """(microseconds, activities, {name: [us, count]}) of the card during
    ``work()``: the kernels and copies of a ``torch.profiler`` trace,
    summed and counted, in all and by name.  A trace can lack the first
    kernels launched after it starts, so LEAD_SPINS short spin kernels run
    to their end in the trace before ``work()`` and are left out of the
    counts.  A short
    trace sometimes comes back empty on the card's machine; it is taken
    again, up to TRACE_TRIES times, and then None is returned, or the run
    fails if ``required``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
            work()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and LEAD_KERNEL not in e.name]
        by_name = {}
        for e in evs:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
        us = sum(t for t, _ in by_name.values())
        if us > 0:
            return us, len(evs), by_name
        time.sleep(0.5 * (attempt + 1))
    check(not required, f"the profiler saw no device activity in "
                        f"{TRACE_TRIES} traces of "
                        f"{getattr(work, '__name__', work)}")
    return None


def device_us(work) -> float:
    """Microseconds the card spent running kernels (and copies) during
    ``work()``."""
    return device_profile(work)[0]


def time_execute(rt, p, inputs, fuse, reps=20, jit=False):
    """(median, min) host-clock us per execute, and device-busy us per
    execute, with the inputs already on the card; ``jit`` replays the
    program's CUDA graph."""
    dev_inputs = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}

    def run():
        rt.execute(p.graph, dev_inputs, p.arena, order=p.order, fuse=fuse,
                   jit=jit)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    us = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
    busy = device_us(lambda: [run() for _ in range(3)]) / 3
    return statistics.median(us), min(us), busy


def record_launches(rt, plans, inputs):
    """The (kernel, arena elements, offset, n, ops) of every launch one
    execute of each full network makes, slice and fused."""
    from repro_torch.kernels.arena import kernel as K
    log = []
    names = ("write", "read", "accum", "chain_write")
    orig = {nm: getattr(K, f"arena_{nm}_cuda") for nm in names}

    def rec(nm):
        def wrapped(arena, *args):
            if nm == "read":
                offset, n = args[:2]
                log.append((nm, arena.shape[0], offset, n, ()))
            else:
                x, offset, *ops = args
                log.append((nm, arena.shape[0], offset, x.shape[0],
                            tuple(ops[0]) if ops else ()))
            return orig[nm](arena, *args)
        return wrapped

    try:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", rec(nm))
        for name in ("darts_net_x6", "randwire_net_32x8"):
            p = plans[name]
            for fuse in (False, True):
                rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                           fuse=fuse)
    finally:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", orig[nm])
    torch.cuda.synchronize()
    return [e for e in log if e[3] > 0]


def time_replay(launches_of, fn, reps=20, one_launch=False,
                complete=False):
    """(device ms, host-clock ms) per launch of ``fn`` over the recorded
    launches: the card's own time from the profiler (or, where no trace
    comes back, the CUDA events' time), and the time per call with the
    host's issue cost, from CUDA events around ``reps`` passes.  With
    ``one_launch`` (``fn`` launches one kernel a call) the device time is
    the mean over the kernels the trace holds, so a trace that lost some
    of them does not read low.  With ``complete`` (``fn`` makes one device
    activity a call) the device time comes only from a trace that holds
    every call's activity, taken up to TRACE_TRIES times, else it is None
    (not measured)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def one_pass():
        for args in launches_of:
            fn(*args)

    for _ in range(2):
        one_pass()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        one_pass()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / (reps * len(launches_of))
    # traces of a launch or two have come back empty on the card's
    # machine: trace enough passes for some 64 launches, unless a pass
    # already takes a millisecond
    passes = 1 if call_ms * len(launches_of) > 1.0 else \
        max(1, min(reps, 64 // len(launches_of)))
    calls = passes * len(launches_of)
    best = None
    for _ in range(TRACE_TRIES if complete else 1):
        prof = device_profile(lambda: [one_pass() for _ in range(passes)],
                              required=False)
        if prof is not None and (best is None or prof[1] > best[1]):
            best = prof
        if prof is None or not complete or prof[1] == calls:
            break
    if complete and (best is None or best[1] != calls):
        held = "none" if best is None else (
            f"at most {best[1]}, whose mean is "
            f"{best[0] / best[1]:.3f} us (not used)")
        say(f"timing: no trace of {getattr(fn, '__name__', fn)} held all "
            f"{calls} of its activities ({held}); its device time is not "
            f"measured")
        return None, call_ms
    if prof is None:
        say(f"timing: no trace of {getattr(fn, '__name__', fn)}; its "
            f"device time below is the CUDA events' time per call")
        return call_ms, call_ms
    if one_launch:
        if prof[1] != calls:
            say(f"timing: the trace holds {prof[1]} of {calls} launches of "
                f"{getattr(fn, '__name__', fn)}; their mean is its time")
        return prof[0] / 1e3 / prof[1], call_ms
    return prof[0] / 1e3 / calls, call_ms


class L2Flush:
    """Writes FLUSH_BYTES of scratch, which leaves none of a copy's source
    or destination in the 50 MB L2; ``names`` are its kernels' names in a
    trace, which a cold timing leaves out of the device time."""

    def __init__(self, dev):
        self.buf = torch.empty(FLUSH_BYTES // 4, device=dev)
        self.names = set(device_profile(
            lambda: [self() for _ in range(16)])[2])

    def __call__(self):
        self.buf.fill_(1.0)


def time_in_graph(launches_of, fn, dev, reps=20):
    """(device ms per launch, ms per launch of a replay) of ``fn`` over the
    recorded launches captured in one CUDA graph: the mean of the
    activities in a trace of one replay (None where every trace came back
    empty), and a replay's time by CUDA events over ``reps`` replays per
    launch (the gaps between the graph's nodes included)."""
    from repro_torch.core.capture import CapturedCall
    call = CapturedCall(lambda: [fn(*a) for a in launches_of], dev)
    for _ in range(2):
        call.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (reps * len(launches_of))
    prof = device_profile(call.replay, required=False)
    if prof is None:
        say(f"timing: no trace of a replayed graph of "
            f"{getattr(fn, '__name__', fn)}; not measured")
        return None, step_ms
    if prof[1] != len(launches_of):
        say(f"timing: the trace of a replayed graph holds {prof[1]} of "
            f"{len(launches_of)} launches of {getattr(fn, '__name__', fn)}; "
            f"their mean is its time")
    return prof[0] / 1e3 / prof[1], step_ms


def time_cold(launches_of, fn, flush):
    """Device ms per launch of ``fn`` over the recorded launches with the
    L2 flushed before each launch (the flush's own kernels left out by
    name), or None where every trace came back empty.  At least 64
    launches are traced."""
    def one_pass():
        for args in launches_of:
            flush()
            fn(*args)

    one_pass()
    passes = max(1, 64 // len(launches_of))
    prof = device_profile(lambda: [one_pass() for _ in range(passes)],
                          required=False)
    if prof is None:
        say(f"timing: no trace of {getattr(fn, '__name__', fn)} cold; "
            f"not measured")
        return None
    us = sum(t for k, (t, _) in prof[2].items() if k not in flush.names)
    return us / 1e3 / (passes * len(launches_of))


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f}"


def phase_timing(plans, inputs, launches, err, card, captured):
    import repro_torch as rt
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    executes = {}
    for name in ("darts_net_x6", "randwire_net_32x8"):
        p = plans[name]
        for fuse in (False, True):
            reset_launches()
            rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                       fuse=fuse)
            torch.cuda.synchronize()
            per_exec = dict(LAUNCHES)
            path = "fused" if fuse else "slice"
            # eager, captured (jit=True), eager, captured: in turns (an
            # eager execute takes ~70 ms: its median over 10)
            t = [time_execute(rt, p, inputs[name], fuse, jit=jit,
                              reps=20 if jit else 10)
                 for jit in (False, True, False, True)]
            for i, jit in enumerate((False, True, False, True)):
                med, best, busy = t[i]
                say(f"timing: execute {name} {path} "
                    f"{'captured (jit=True)' if jit else 'eager'}"
                    f"{' again' if i > 1 else ''}: median {med:.1f} us, min "
                    f"{best:.1f} us per execute (host clock); device busy "
                    f"{busy:.1f} us per execute, idle share "
                    f"{1 - busy / med:.4f}; arena kernel launches per "
                    f"execute {per_exec}"
                    f"{', per replay ' + str(captured[(name, fuse)]) if jit else ''}"
                    f" [{card}]")
            executes[f"{name} {path}"] = dict(
                eager_us=[x[0] for x in t[0::2]],
                eager_min_us=[x[1] for x in t[0::2]],
                eager_busy_us=[x[2] for x in t[0::2]],
                captured_us=[x[0] for x in t[1::2]],
                captured_min_us=[x[1] for x in t[1::2]],
                captured_busy_us=[x[2] for x in t[1::2]])

    say("timing: execute, eager and captured: " + json.dumps(executes)
        + f" [{card}]")
    log = record_launches(rt, plans, inputs)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    arena_elems = max(e[1] for e in log)
    arena = torch.randn(arena_elems, device=dev, generator=gen)
    xs = {}

    def x_of(n):
        if n not in xs:
            xs[n] = torch.randn(n, device=dev, generator=gen)
        return xs[n]

    impls = {
        "write": (K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": (K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
        "accum": (K.arena_accum_cuda, R.arena_accum_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].add_(x)),
        "chain_write": (K.arena_chain_write_cuda, R.arena_chain_write_torch,
                        None),
    }
    # bytes each launch must move: inputs read once, outputs written once
    per_elem = {"write": 8, "read": 8, "accum": 12, "chain_write": 8}
    flush = L2Flush(dev)
    rows = []
    for name, (kern, plain, lib) in impls.items():
        recs = [e for e in log if e[0] == name]
        check(len(recs) > 0, f"no recorded launches of {name}")
        if name == "read":
            args = [(arena, o, n) for _, _, o, n, _ in recs]
        elif name == "chain_write":
            args = [(arena, x_of(n), o, ops) for _, _, o, n, ops in recs]
        else:
            args = [(arena, x_of(n), o) for _, _, o, n, _ in recs]
        ms, call_ms = time_replay(args, kern)
        plain_ms, plain_call_ms = time_replay(args, plain)
        lib_ms, lib_call_ms = (None, None) if lib is None \
            else time_replay(args, lib)
        floor = ""
        if name == "chain_write":
            # no one torch call applies a chain: copy_ of the same bytes is
            # a floor of the launch, not the same function
            floor_ms = time_replay(
                args, lambda a, x, o, ops: a[o:o + x.shape[0]].copy_(x))[0]
            floor = (f"; launch-floor yardstick (copy_ of the same bytes, "
                     f"not the same function) {floor_ms * 1e3:.3f}")
        mean_bytes = per_elem[name] * sum(r[3] for r in recs) / len(recs)
        bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
        row = dict(
            name=f"arena_{name}", route="cuda",
            source="src/repro_torch/csrc/arena.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)
        cold = ""
        if name in ("write", "read"):
            # L2 flushed before each launch, in turns: kernel, plain,
            # torch call, kernel
            c = [time_cold(args, f, flush) for f in (kern, plain, lib, kern)]
            row.update(cold_ms=c[0], cold_plain_ms=c[1], cold_library_ms=c[2],
                       cold_ms_again=c[3])
            cold = (f"; cold (L2 flushed before each launch): kernel "
                    f"{fmt_us(c[0])} (again {fmt_us(c[3])}), plain "
                    f"{fmt_us(c[1])}, torch call {fmt_us(c[2])}")
            # inside a CUDA graph, as a captured execute runs them: kernel,
            # torch call, kernel, in turns
            g = [time_in_graph(args, f, dev) for f in (kern, lib, kern)]
            row.update(graph_ms=g[0][0], graph_step_ms=g[0][1],
                       graph_library_ms=g[1][0],
                       graph_library_step_ms=g[1][1],
                       graph_ms_again=g[2][0], graph_step_ms_again=g[2][1])
            cold += (f"; in a replayed graph of the launches, device us per "
                     f"launch (the trace's mean) kernel {fmt_us(g[0][0])} "
                     f"(again {fmt_us(g[2][0])}), torch call "
                     f"{fmt_us(g[1][0])}; us per launch of a replay (CUDA "
                     f"events, gaps between nodes included) kernel "
                     f"{fmt_us(g[0][1])} (again {fmt_us(g[2][1])}), torch "
                     f"call {fmt_us(g[1][1])}")
        say(f"timing: {name}: {len(recs)} launches at the main path's shapes "
            f"(mean n {mean_bytes / per_elem[name]:.0f}); device us per "
            f"launch: kernel {ms * 1e3:.3f}, bound {bound_ms * 1e3:.3f} "
            f"(bytes), plain {plain_ms * 1e3:.3f}, torch call "
            f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.3f}'}{cold}"
            f"{floor}; "
            f"host-clock us per call: kernel {call_ms * 1e3:.2f}, plain "
            f"{plain_call_ms * 1e3:.2f}, torch call "
            f"{'n/a' if lib_call_ms is None else f'{lib_call_ms * 1e3:.2f}'} "
            f"[{card}]")
        rows.append(row)
    return rows


def fa_bound(q, k, v, kw) -> tuple[float, float]:
    """(bytes ms, operations ms) the card needs at least for one attention
    call (causal unless ``kw["causal"]`` is false): ``costs.flash_cost``'s
    bytes over 3.35 TB/s and its flops over the bf16 tensor-core peak."""
    flops, nbytes = costs.flash_cost(
        *q.shape, *k.shape[1:3], v.shape[3], q.element_size(),
        q_start=kw["q_start"], kv_len=kw["kv_len"],
        causal=kw.get("causal", True), window=kw.get("window"))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / BF16_FLOP_PER_S * 1e3)


def wkv6_bound(B, T, H, N, esz) -> tuple[float, float]:
    """(bytes ms, operations ms) for one WKV-6 call with an initial state
    (``costs.wkv6_cost``), over 3.35 TB/s and the f32 CUDA-core peak."""
    flops, nbytes = costs.wkv6_cost(B, T, H, N, esz)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def rglru_bound(B, T, D, esz) -> tuple[float, float]:
    """(bytes ms, operations ms) for one RG-LRU call with h0
    (``costs.rglru_cost``), over 3.35 TB/s and the f32 CUDA-core peak."""
    flops, nbytes = costs.rglru_cost(B, T, D, esz)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOP_PER_S * 1e3)


def traced_copies(by_name, op) -> tuple[float, int]:
    """(device us, launches) of the arena ``op`` kernel in a trace."""
    hits = [v for k, v in by_name.items() if ARENA_KERNELS[op] in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def time_served_packing(plan, spans, by_name, card, dev):
    """The u8 arena write/read at the served cache leaves' offsets and
    sizes: their launches and device us in the decode token's trace, the
    kernels' names held in a trace of their own, and replayed, warm (as
    the decode loop finds L2) and cold (L2 flushed before each launch),
    against their bound, their plain versions and one torch copy.  Returns
    {op: numbers} for the JSON."""
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    arena = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    xs = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                        generator=gen) for _, n in spans]
    impls = {
        "write": ([(arena, x, o) for x, (o, _) in zip(xs, spans)],
                  K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": ([(arena, o, n) for o, n in spans],
                 K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
    }
    flush = L2Flush(dev)
    out = {}
    for name, (args, kern, plain, lib) in impls.items():
        # the name is held over a trace of some 64 launches over the
        # leaves, of which it may lack no more than one pass (the most
        # complete of up to TRACE_TRIES traces)
        t_us, t_n = traced_copies(by_name, name)
        passes = max(2, -(-64 // len(spans)))
        lo, hi, n_traced = (passes - 1) * len(spans), passes * len(spans), 0
        for _ in range(TRACE_TRIES):
            n_traced = max(n_traced, traced_copies(device_profile(
                lambda: [kern(*a) for _ in range(passes) for a in args])[2],
                name)[1])
            if n_traced >= lo:
                break
        check(lo <= n_traced <= hi,
              f"{name}: {n_traced} launches of arena_{name}_kernel in the "
              f"most complete trace of {passes} x {len(spans)}")
        # one device activity a call: each time from a trace that holds
        # all of them (a trace that lost some read below the DRAM bound)
        ms, plain_ms, lib_ms = (time_replay(args, f, complete=True)[0]
                                for f in (kern, plain, lib))
        cold, cold_plain, cold_lib, cold_again = (
            time_cold(args, f, flush) for f in (kern, plain, lib, kern))
        mean_n = sum(n for _, n in spans) / len(spans)
        bound_ms = 2 * mean_n / HBM_BYTES_PER_S * 1e3
        share = "not measured" if cold is None else f"{bound_ms / cold:.3f}"
        say(f"timing: serve u8 arena {name} at the served leaves "
            f"{spans}: in the decode token's trace {t_n} of its "
            f"{len(spans)} launches, {t_us:.1f} us in all; {n_traced} in a "
            f"trace of {passes} passes; replayed, device us per launch: bound "
            f"{bound_ms * 1e3:.2f} (bytes, {2 * mean_n:.0f} B); warm: kernel "
            f"{fmt_us(ms)}, plain {fmt_us(plain_ms)}, torch call "
            f"{fmt_us(lib_ms)}; cold (L2 flushed before each launch): "
            f"kernel {fmt_us(cold)} (again {fmt_us(cold_again)}), plain "
            f"{fmt_us(cold_plain)}, torch call {fmt_us(cold_lib)}; the cold "
            f"kernel reaches {share} of the bound [{card}]")
        out[name] = dict(traced_launches=t_n, traced_us=t_us,
                         ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         cold_ms=cold, cold_plain_ms=cold_plain,
                         cold_library_ms=cold_lib, cold_ms_again=cold_again,
                         bound_ms=bound_ms)
    return out


def phase_serve_timing(ctx, card, dev, packing=True):
    """Prefill ms per request, ms per decode token (host clock), the
    device's busy time and idle share over one prefill and one decode
    token, and (``packing``) the u8 arena write/read at the served leaves,
    for one served model."""
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step

    model, params, plan, reqs = (ctx[k] for k in ("model", "params", "plan",
                                                  "reqs"))
    smax, prompt = ctx["smax"], reqs[0].prompt
    prefill = make_prefill_step(model)
    batch = prefill_batch(model, prompt, dev)
    ms = []
    for _ in range(4):
        cache = model.init_cache(1, smax, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cache, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(ms[1:])
    # the card's share of one prefill: busy time, and its largest kernels
    cache = model.init_cache(1, smax, dev)
    pre_us, _, pre_by = device_profile(lambda: prefill(params, cache, batch))
    pre_top = sorted(pre_by.items(), key=lambda kv: -kv[1][0])[:4]
    del cache

    # decode through the server: one request in flight, one token a tick
    pool = S.make_pool(4 * plan["arena_bytes"])
    server = S.DecodeServer(model, params, pool, smax=smax)
    server.submit(S.Request(rid=0, prompt=prompt, max_new=GEN))
    server.step()                  # admit + prefill + the first decode
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tok_ms = statistics.median(ms)
    # a trace can lack a few of a token's kernels, never hold more: the
    # most complete of TOKEN_TRACES traces stands for the token
    n_cache, traces = plan["n_cache"], []
    for _ in range(TOKEN_TRACES):
        reset_all()
        traces.append(device_profile(server.step))
        per_tok = {k: v for k, v in all_launches().items() if v}
        check(per_tok.get("write") == per_tok.get("read") == n_cache,
              f"{model.cfg.name}: {per_tok} arena copies in a decode "
              f"token, {n_cache} leaves")
    busy_us, n_dev, by_name = max(traces, key=lambda t: t[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    name = model.cfg.name
    say(f"timing: serve {name}: prefill {prefill_ms:.2f} ms per request of "
        f"{len(prompt)} tokens (median of 3, host clock); decode "
        f"{tok_ms:.3f} ms per token (median of 8 ticks, min {min(ms):.3f}, "
        f"one request in flight, host clock); device busy {busy_us:.1f} us "
        f"per token, idle share {1 - busy_us / (tok_ms * 1e3):.4f}; {n_dev} "
        f"device activities per token (the most of "
        f"{[t[1] for t in traces]}), of them the port's kernels "
        f"{per_tok} [{card}]")
    say(f"timing: serve {name} decode token, device us by kernel (count): "
        + "; ".join(f"{k[:60]} {t:.1f} ({n})" for k, (t, n) in top))
    say(f"timing: serve {name} prefill: device busy {pre_us:.1f} us of "
        f"{prefill_ms * 1e3:.1f} (idle share "
        f"{1 - pre_us / (prefill_ms * 1e3):.4f}); device us by kernel "
        f"(count): " + "; ".join(f"{k[:60]} {t:.1f} ({n})"
                                  for k, (t, n) in pre_top) + f" [{card}]")
    check(n_dev <= ACTIVITIES.get(name, n_dev),
          f"{name}: {n_dev} device activities per decode token, more than "
          f"the limit of {ACTIVITIES.get(name)}")
    check(server._captured.call is not None
          and server._captured.call.replays >= 8 + TOKEN_TRACES,
          f"{name}: the server's decode ticks did not replay its captured "
          f"step")

    # the same token eager, as the server on the CPU makes it (and the card
    # before its capture): unpack into fresh tensors, the eager step, the
    # argmax, the pack, on a copy of the request's arena
    req = server.active[0]
    arena = req.arena.clone()
    defs = server._cache_defs()

    def eager_token():
        cache = S.unpack_decode_state(plan, arena, defs)
        tok = torch.full((1, 1), req.last_tok, dtype=torch.long, device=dev)
        logits, cache = server._decode(params, cache, tok, req.t)
        int(torch.argmax(logits, -1)[0])
        S.pack_decode_state(plan, cache, arena=arena)

    eager_token()
    ems = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_token()
        torch.cuda.synchronize()
        ems.append((time.perf_counter() - t0) * 1e3)
    e_busy, e_dev, _ = max((device_profile(eager_token)
                            for _ in range(TOKEN_TRACES)),
                           key=lambda t: t[1])
    e_ms = statistics.median(ems)
    say(f"timing: serve {name}: decode eager {e_ms:.3f} ms per token "
        f"(median of 8, min {min(ems):.3f}, host clock) against captured "
        f"{tok_ms:.3f} (min {min(ms):.3f}); device busy eager "
        f"{e_busy:.1f} us (idle share {1 - e_busy / (e_ms * 1e3):.4f}, "
        f"{e_dev} activities), captured {busy_us:.1f} us (idle share "
        f"{1 - busy_us / (tok_ms * 1e3):.4f}, {n_dev} activities) "
        f"[{card}]")
    out = time_served_packing(plan, ctx["spans"], by_name, card, dev) \
        if packing else {}
    out["decode"] = dict(
        captured_ms=tok_ms, captured_min_ms=min(ms), captured_busy_us=busy_us,
        captured_activities=n_dev, eager_ms=e_ms, eager_min_ms=min(ems),
        eager_busy_us=e_busy, eager_activities=e_dev, prefill_ms=prefill_ms,
        prefill_busy_us=pre_us)
    return out


def decode_bound(cfg, card, smax=None) -> dict:
    """The least time a decode token's weights take to read at 3.35 TB/s:
    every bf16 parameter once (``cfg.param_count()``; an MoE model in
    ``repro``'s dense ``(E, cap, D)`` form reads every expert's), and for
    an MoE model its active parameters alone
    (``cfg.active_param_count()``: the K routed experts' of each layer;
    both embeddings counted).  An encoder-decoder's decode reads no
    encoder weight but, as ``repro``, projects the whole padded encoder
    buffer (``smax`` rows) to keys and values in every layer's
    cross-attention: its bound is the larger of the decoder's weights and
    that buffer read once a layer, and of those products at the bf16
    peak."""
    n = cfg.param_count()
    if cfg.is_encoder_decoder:
        D, F = cfg.d_model, cfg.d_ff
        hd = cfg.n_heads * cfg.head_dim
        kv = cfg.n_kv_heads * cfg.head_dim
        attn = D * hd + 2 * D * kv + hd * D
        gates = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        n -= cfg.encoder_layers * (attn + gates * D * F)
        nbytes = 2 * n + 2 * cfg.n_layers * smax * D
        flops = cfg.n_layers * 2 * smax * D * 2 * kv
        out = dict(weights_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   cross_kv_flops_bound_ms=flops / BF16_FLOP_PER_S * 1e3)
    else:
        out = dict(weights_bound_ms=2 * n / HBM_BYTES_PER_S * 1e3)
    if cfg.n_experts:
        out["active_bound_ms"] = 2 * cfg.active_param_count() \
            / HBM_BYTES_PER_S * 1e3
    say(f"timing: serve {cfg.name}: a decode token's DRAM bound, its "
        f"weights read once: " + ", ".join(f"{k[:-9]} {v:.3f} ms"
                                            for k, v in out.items())
        + f" [{card}]")
    return out


def row_blocked_timing(ctx, card, dev):
    """The row-blocked split-K decode at granite-20b's served shapes: one
    query of 48 heads over the cache of its one KV head (D 128, bf16), at a
    0-d device position at the last step (the captured serial step's
    launch) and at a position per row of bucket 4 (the batched step's):
    the kernel's device us per launch, its bound, the plain version
    (``impl="torch"`` at the same positions) and SDPA (the torch call)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    cfg = ctx["model"].cfg
    H, KV, D, smax = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ctx["smax"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    for label, B in (("serial", 1), ("bucket 4", N_REQ)):
        q = torch.randn(B, 1, H, D, device=dev, generator=gen).bfloat16()
        k = torch.randn(B, smax, KV, D, device=dev, generator=gen).bfloat16()
        v = torch.randn(B, smax, KV, D, device=dev, generator=gen).bfloat16()
        last = [smax - 1 - 7 * b for b in range(B)]
        pos = torch.tensor(last, dtype=torch.long, device=dev)
        if B == 1:
            pos = pos[0]
        mask = torch.arange(smax, device=dev)[None] <= pos.reshape(-1, 1)

        def kern(q, k, v):
            return FK.flash_decode_cuda(q, k, v, causal=True, window=None,
                                        q_start=pos)[0]

        def plain(q, k, v):
            return flash_attention(q, k, v, impl="torch", q_start=pos)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None, None, :],
                enable_gqa=True).transpose(1, 2)

        e, ok = fa_err(kern(q, k, v), plain(q, k, v))
        check(ok, f"row-blocked decode at granite-20b's {label} shape vs "
                  f"the plain version: {e}")
        t = {n: time_replay([(q, k, v)], fn)[0]
             for n, fn in (("kernel", kern), ("plain", plain),
                           ("sdpa", sdpa))}
        again = time_replay([(q, k, v)], kern)[0]
        bounds = [fa_bound(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                           dict(q_start=p, kv_len=p + 1))
                  for b, p in enumerate(last)]
        b_ms = sum(b for b, _ in bounds)
        o_ms = sum(o for _, o in bounds)
        S = FK.capacity_splits(B, KV, 1, H, D, Skv=smax, causal=True,
                               window=None)
        out[label] = dict(
            ms=t["kernel"], ms_again=again, plain_ms=t["plain"],
            library_ms=t["sdpa"], bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            splits=S[0], tiles_per_split=S[1],
            row_blocks=FK.row_blocks(1, H // KV), positions=last,
            max_abs_err=e)
        say(f"timing: row-blocked flash_decode at granite-20b's {label} "
            f"decode (B {B}, H {H}, KV {KV}, D {D}, cache {smax}, positions "
            f"{last} on the device; {FK.row_blocks(1, H // KV)} row blocks, "
            f"{S[0]} splits of {S[1]} tiles): device us per launch kernel "
            f"{t['kernel'] * 1e3:.2f} (again {again * 1e3:.2f}), bound "
            f"{max(b_ms, o_ms) * 1e3:.3f} ({out[label]['bound_by']}), plain "
            f"{t['plain'] * 1e3:.2f}, sdpa {t['sdpa'] * 1e3:.2f}; vs plain "
            f"{e:.3e} [{card}]")
    return out


def flash_impls():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def sdpa(q, k, v, kw):
        n, mask = kw["kv_len"], kw.get("mask")    # the window as a mask
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :n].transpose(1, 2),
            v[:, :n].transpose(1, 2), attn_mask=mask,
            is_causal=mask is None and q.shape[1] > 1,
            enable_gqa=True).transpose(1, 2)

    def args(kw):
        return {k: kw[k] for k in ("q_start", "kv_len", "window") if k in kw}

    def cuda(fn):
        return lambda q, k, v, kw: fn(q, k, v, causal=True,
                                      **{"window": None, **args(kw)})

    return {
        # the kernel the route rule picks, and PR 12's kernel beside it
        "kernel": cuda(FK.flash_attention_cuda),
        "simple": cuda(FK.flash_simple_cuda),
        "plain": lambda q, k, v, kw: flash_attention(q, k, v, impl="torch",
                                                     **args(kw)),
        "sdpa": sdpa,
    }


def window_mask(Sq, q_start, kv_len, window, dev):
    """SDPA's boolean mask (True attends) for causal attention with a
    window: key j is live for the query at p when p - window < j <= p."""
    p = q_start + torch.arange(Sq, device=dev)[:, None]
    j = torch.arange(kv_len, device=dev)[None]
    return (j <= p) & (j > p - window)


def time_flash(name, shapes, mix, card, dev):
    """The routed flash kernel, the simple kernel, the plain version and
    SDPA at ``shapes`` (label -> (q, k, v, kw)) and over the launch ``mix``;
    returns {label or "mix": times (ms), bound and route}."""
    from repro_torch.kernels.flash_attention import kernel as FK
    impls = flash_impls()
    out = {}
    for label, args in shapes.items():
        t = {i: time_replay([args], fn) for i, fn in impls.items()}
        b_ms, o_ms = fa_bound(*args)
        e = float((impls["kernel"](*args).float()
                   - impls["sdpa"](*args).float()).abs().max())
        q, k, v = args[0], args[1], args[2]
        route = FK.pick_route(q.shape[1], q.shape[2] // k.shape[2], q.dtype,
                              q.shape[3], v.shape[3])
        kw = {x: y for x, y in args[3].items() if x != "mask"}
        out[label] = dict(
            route=route, ms=t["kernel"][0], simple_ms=t["simple"][0],
            plain_ms=t["plain"][0], library_ms=t["sdpa"][0],
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations")
        if route == "decode":
            # the launch a captured decode step makes: the position on the
            # device, the capacity split rule; beside it the host-position
            # launch again, in turns
            pos = torch.full((), kw["q_start"], dtype=torch.long, device=dev)
            dp = [time_replay([args], fn)[0] for fn in (
                lambda q, k, v, a: FK.flash_decode_cuda(
                    q, k, v, causal=True, window=a.get("window"),
                    q_start=pos)[0],
                impls["kernel"])]
            S = FK.capacity_splits(1, k.shape[2], q.shape[1], q.shape[2],
                                   v.shape[3], Skv=k.shape[1], causal=True,
                                   window=kw.get("window"))
            out[label].update(device_position_ms=dp[0],
                              device_position_splits=S[0], ms_again=dp[1])
            say(f"timing: flash_attention {name} {label} at a device "
                f"position (the capacity rule, {S[0]} splits of {S[1]} "
                f"tiles): device us per launch {dp[0] * 1e3:.2f}, the "
                f"host-position launch {t['kernel'][0] * 1e3:.2f} (again "
                f"{dp[1] * 1e3:.2f}) [{card}]")
        say(f"timing: flash_attention {name} {label} (B 1, Sq {q.shape[1]}, "
            f"Skv {k.shape[1]}, H {q.shape[2]}, KV {k.shape[2]}, D "
            f"{q.shape[3]}, bf16, {kw}): device us per launch: kernel "
            f"({route}) {t['kernel'][0] * 1e3:.2f}, bound "
            f"{max(b_ms, o_ms) * 1e3:.3f} "
            f"({'bytes' if b_ms >= o_ms else 'operations'}), simple kernel "
            f"{t['simple'][0] * 1e3:.2f}, plain {t['plain'][0] * 1e3:.2f}, "
            f"sdpa {t['sdpa'][0] * 1e3:.2f}; host-clock us per call: kernel "
            f"{t['kernel'][1] * 1e3:.2f}, simple {t['simple'][1] * 1e3:.2f}, "
            f"plain {t['plain'][1] * 1e3:.2f}, sdpa {t['sdpa'][1] * 1e3:.2f}; "
            f"kernel vs sdpa max abs err {e:.3e} [{card}]")
    t = {i: time_replay(mix, fn, reps=3)[0] for i, fn in impls.items()}
    bounds = [fa_bound(*a) for a in mix]
    bound_ms = sum(max(b) for b in bounds) / len(mix)
    by = "bytes" if sum(b for b, _ in bounds) >= sum(o for _, o in bounds) \
        else "operations"
    out["mix"] = dict(route="decode + prefill", ms=t["kernel"],
                      simple_ms=t["simple"], plain_ms=t["plain"],
                      library_ms=t["sdpa"], bound_ms=bound_ms, bound_by=by)
    say(f"timing: flash_attention {name} over the serving run's launch mix "
        f"({len(mix)} shapes): device us per launch: kernel (routed) "
        f"{t['kernel'] * 1e3:.2f}, bound {bound_ms * 1e3:.3f} ({by}), simple "
        f"kernel {t['simple'] * 1e3:.2f}, plain {t['plain'] * 1e3:.2f}, sdpa "
        f"{t['sdpa'] * 1e3:.2f} [{card}]")
    return out


def flash_shapes(cfg, prompt, smax, dev, window=None):
    """The served attention's prefill and last decode shape, and the
    serving run's launch mix (one prefill, one decode at each t)."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    def kw(Sq, q_start, kv_len):
        out = dict(q_start=q_start, kv_len=kv_len)
        if window is not None:
            out.update(window=window,
                       mask=window_mask(Sq, q_start, kv_len, window, dev))
        return out

    dec = (rnd(1, 1, H, D), rnd(1, smax, KV, D), rnd(1, smax, KV, D))
    pre = (rnd(1, prompt, H, D), rnd(1, prompt, KV, D), rnd(1, prompt, KV, D))
    shapes = {"decode": (*dec, kw(1, smax - 1, smax)),
              "prefill": (*pre, kw(prompt, 0, prompt))}
    mix = [shapes["prefill"]] + [(*dec, kw(1, t, t + 1))
                                 for t in range(prompt, prompt + GEN - 1)]
    return shapes, mix


FLASH_SOURCES = {"decode": "src/repro_torch/csrc/flash_decode.cu",
                 "prefill": "src/repro_torch/csrc/flash_prefill_sm90.cu",
                 "simple": "src/repro_torch/csrc/flash_attention.cu"}
FLASH_LAUNCHES = {"decode": "flash_decode", "prefill": "flash_prefill",
                  "simple": "flash_attention"}


def flash_row(ctx, err, card, dev):
    """llama3.2-1b's attention: the flash row of the kernels JSON.  Its
    times are the serving run's launch mix through the routed kernels;
    ``routes`` gives each kernel's times at its served shape, its source
    and its launches over the serving run; ``models`` gives each served
    attention model's decode, prefill and mix times and launches by
    route (``simple_ms``: the simple kernel at the same shape)."""
    cfg = ctx["model"].cfg
    shapes, mix = flash_shapes(cfg, len(ctx["reqs"][0].prompt), ctx["smax"],
                               dev)
    # each shape of the mix stands for N_REQ * n_layers launches
    res = time_flash(cfg.name, shapes, mix, card, dev)
    launches = {r: ctx["launches"][k] for r, k in FLASH_LAUNCHES.items()}
    routes = {}
    for label in ("decode", "prefill"):
        r = res[label]["route"]
        routes[r] = dict(res[label], source=FLASH_SOURCES[r],
                         launches=launches[r])
    mix_t = res["mix"]
    return dict(
        name="flash_attention", route="cuda",
        source=FLASH_SOURCES["decode"],
        replaces=REPLACES["flash_attention"],
        launches=sum(launches.values()),
        max_abs_err=err["flash_attention"], ms=mix_t["ms"],
        plain_ms=mix_t["plain_ms"], bound_ms=mix_t["bound_ms"],
        bound_by=mix_t["bound_by"], library_ms=mix_t["library_ms"],
        simple_ms=mix_t["simple_ms"], routes=routes,
        models={cfg.name: dict(res, launches=launches)})


def recurrence_row(name, fn, plain, bound, shapes, launches, err, card):
    """A recurrence kernel at the served decode and prefill shapes
    (``shapes``: label -> args of ``fn``), against its plain version and
    its bound (``bound``: args -> (bytes ms, operations ms)); the row's
    times are the serving run's mix, one prefill to GEN - 1 decodes."""
    t, b = {}, {}
    for label, args in shapes.items():
        reps = 20 if label == "decode" else 10
        t[label] = (time_replay([args], fn, reps=reps, one_launch=True)[0],
                    time_replay([args], plain, reps=reps)[0])
        b[label] = bound(*args)
        by = "bytes" if b[label][0] >= b[label][1] else "operations"
        shape = ", ".join(f"{tuple(a.shape)} {str(a.dtype).split('.')[1]}"
                          for a in args if isinstance(a, torch.Tensor))
        say(f"timing: {name} {label} ({shape}): device us per launch: "
            f"kernel {t[label][0] * 1e3:.2f}, bound {max(b[label]) * 1e3:.3f} "
            f"({by}; bytes {b[label][0] * 1e3:.3f}, operations "
            f"{b[label][1] * 1e3:.3f}), plain {t[label][1] * 1e3:.2f}, "
            f"torch call none [{card}]")
    mix = lambda x: (x["prefill"] + (GEN - 1) * x["decode"]) / GEN
    bytes_ms = mix({k: v[0] for k, v in b.items()})
    ops_ms = mix({k: v[1] for k, v in b.items()})
    row = dict(
        name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=err[name], ms=mix({k: v[0] for k, v in t.items()}),
        plain_ms=mix({k: v[1] for k, v in t.items()}),
        bound_ms=mix({k: max(v) for k, v in b.items()}),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None)
    say(f"timing: {name} over the serving run's mix (1 prefill : {GEN - 1} "
        f"decodes): device us per launch: kernel {row['ms'] * 1e3:.2f}, "
        f"bound {row['bound_ms'] * 1e3:.3f} ({row['bound_by']}), plain "
        f"{row['plain_ms'] * 1e3:.2f} [{card}]")
    return row


def wkv6_row(ctx, err, card, dev):
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    cfg = ctx["model"].cfg
    H, N = cfg.d_model // cfg.head_dim, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def args(T):
        r, k, v = (torch.randn(1, T, H, N, device=dev, generator=gen)
                   .bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(1, T, H, N, device=dev,
                                             generator=gen))).bfloat16()
        u = (0.5 * torch.randn(H, N, device=dev, generator=gen)).bfloat16()
        s0 = torch.randn(1, H, N, N, device=dev, generator=gen)
        return r, k, v, w, u, s0

    shapes = {"decode": args(1), "prefill": args(len(ctx["reqs"][0].prompt))}
    return recurrence_row(
        "wkv6", lambda r, k, v, w, u, s0: WK.wkv6_cuda(
            r, k, v, w, u, initial_state=s0, state_out=s0),
        lambda r, k, v, w, u, s0: wkv6_ref(r, k, v, w, u, s0, s0),
        lambda r, k, v, w, u, s0: wkv6_bound(*r.shape, r.element_size()),
        shapes, ctx["launches"], err, card)


def rglru_row(ctx, err, card, dev):
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref

    cfg = ctx["model"].cfg
    W = cfg.lru_width or cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def args(T):
        la = -0.5 * torch.exp(torch.randn(1, T, W, device=dev,
                                          generator=gen))
        gx = torch.randn(1, T, W, device=dev, generator=gen).bfloat16()
        return la, gx, torch.randn(1, W, device=dev, generator=gen)

    shapes = {"decode": args(1), "prefill": args(len(ctx["reqs"][0].prompt))}
    row = recurrence_row(
        "rglru", lambda la, gx, h0: RK.rglru_cuda(la, gx, h0, state_out=h0),
        lambda la, gx, h0: rglru_ref(la, gx, h0, h0),
        lambda la, gx, h0: rglru_bound(*gx.shape, gx.element_size()),
        shapes, ctx["launches"], err, card)
    # each kernel at the prefill shape in the same run: the staged kernel
    # (the route), the step kernel (one thread a channel), the
    # staged kernel again
    fns = {"staged": RK.rglru_staged_cuda, "step": RK.rglru_step_cuda}
    t = [(r, time_replay([shapes["prefill"]],
                         lambda la, gx, h0, f=fns[r]: f(la, gx, h0,
                                                        state_out=h0),
                         reps=10, one_launch=True)[0])
         for r in ("staged", "step", "staged")]
    row["routes"] = {
        "step": dict(source="src/repro_torch/csrc/rglru.cu "
                            "(rglru_step_kernel)",
                     launches=ctx["routes"]["step"], prefill_ms=t[1][1]),
        "staged": dict(source="src/repro_torch/csrc/rglru.cu "
                              "(rglru_staged_kernel)",
                       launches=ctx["routes"]["staged"],
                       prefill_ms=t[0][1], prefill_ms_again=t[2][1])}
    say(f"timing: rglru prefill {tuple(shapes['prefill'][1].shape)} bf16, "
        f"each kernel: device us per launch staged {t[0][1] * 1e3:.2f} "
        f"(again {t[2][1] * 1e3:.2f}), step {t[1][1] * 1e3:.2f}; launches "
        f"over the serving run {ctx['routes']} [{card}]")
    return row


def mqa_flash_timing(ctx, card, dev):
    """recurrentgemma-2b's attention (H 10, KV 1, D 256, window 2048): the
    routed kernel, the simple kernel, its plain version and SDPA with the
    window as a mask."""
    cfg = ctx["model"].cfg
    shapes, mix = flash_shapes(cfg, len(ctx["reqs"][0].prompt), ctx["smax"],
                               dev, window=cfg.local_window)
    return time_flash(cfg.name, shapes, mix, card, dev)


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

# the backward kernel against its plain version: llama3.2-1b's heads (H 32,
# KV 8, D 64) at the CLI's batch 8 x seq 256, and two ragged sequences
# (B, S); f32 within BWD_RTOL32 of each gradient's largest magnitude (sums
# in another order), bf16 within BWD_ULPS16 bf16 ulps of it (both round one
# f32 sum to bf16)
BWD_CASES = ((8, 256), (2, 200), (2, 17))
BWD_RTOL32, BWD_ULPS16 = 1e-4, 4
# the train step through the kernels against the same step through the
# plain versions (impl="torch"), full width, bf16: the loss within the bf16
# logit atol of llama3.2-1b's serving check, grad_norm within the same
# relative
TRAIN_ATOL = SERVES["llama3.2-1b"]["logit_atol"]
# and its gradient, leaf by leaf, each stacked leaf layer by layer: the
# worst relative L2 error ||g - g_plain|| / ||g_plain|| within
# TRAIN_GRAD_RTOL, set from readings on an H100 (worst of three seeds
# 2.03e-2, at an attention projection); a deliberately broken backward (one
# KV head's dK zeroed in one layer), which read 0.32-0.38, must read above
# it
TRAIN_GRAD_RTOL = 3e-2
# the CLI's run: TRAIN_STEPS steps at its defaults (batch 8, seq 256, AdamW,
# bf16) at published width, the depth cut to TRAIN_CLI_LAYERS, a checkpoint
# at TRAIN_CKPT_EVERY; the replay resumes there.  The run and its replay
# write three checkpoints (bf16 parameters and f32 AdamW moments): 11.5 GB
# at 2 layers (37.1 GB at all 16), so that Griffin's run fits beside them
# in the 45 GiB of disk writes the card's machine allows a call
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BATCH, TRAIN_SEQ = 7, 4, 8, 256
TRAIN_CLI_LAYERS = 2
# llama3.2-1b's CLI run at those settings (``family_cli``'s form)
LLAMA_CLI = dict(arch="llama3.2-1b", steps=TRAIN_STEPS,
                 ckpt_every=TRAIN_CKPT_EVERY, cli_layers=TRAIN_CLI_LAYERS)
TIMED_STEPS = 3
# cfg.remat settings the train phase runs in turns (the config's default,
# "block", is what the CLI runs)
REMAT_SETTINGS = ("none", "block", "dots")
# the memory a full-width llama3.2-1b step holds, reckoned from shapes:
# bf16 params and grads, f32 AdamW moments, f32 logits, their log-softmax
# and gradient
TRAIN_MEM_BYTES = 20e9


def bwd_tol(want, dtype) -> float:
    scale = float(want.float().abs().max())
    if dtype == torch.float32:
        return BWD_RTOL32 * scale
    return BWD_ULPS16 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30)))
                                - 7)


def train_launches(cfg, steps: int = 1, rules: bool = False) -> dict:
    """The kernels' launches over ``steps`` train steps of ``cfg``: one
    forward an attention call, and one more where ``cfg.remat``
    recomputes each wrapped block in the backward ("block", "dots"); one
    backward an attention call.  Attention calls launch ``flash_prefill``
    and ``flash_backward``: one a decoder layer, and in the
    encoder-decoder one an encoder layer (its self-attention) and two a
    decoder layer (self- and cross-attention: at seamless-m4t-medium's 12
    + 12 layers 36 backward calls a step); DeepSeek's MTP block adds one,
    its forward once (``_mtp_loss`` runs it outside ``_maybe_remat``).
    Griffin's recurrent layers the RG-LRU forward (``rglru``) and
    ``rglru_backward``; RWKV-6's layers ``wkv6`` and ``wkv6_backward``.
    Griffin wraps each group of its pattern and not
    the tail (the layers past the last whole group), whose forward runs
    once: at recurrentgemma-2b's 26 layers, 8 groups (rec, rec, attn) and
    2 rec layers, a step is 16 ``flash_prefill``, 8 ``flash_backward``,
    2 x 16 + 2 = 34 ``rglru`` and 18 ``rglru_backward``.  Every step adds
    one ``sumsq`` (the clip's norm) and its optimizer's: AdamW one
    ``adamw_update`` (the clip's scaling and the update), Adafactor
    (deepseek-v3-671b) one each of ``adafactor_sums``, ``adafactor_rms``
    and ``adafactor_update``, and under ``rules`` two of
    ``adafactor_sums`` (the raw sums, then the moments from them once
    reduced: ``ops.adafactor_kernels(split=True)``)."""
    again = 0 if cfg.remat in ("none", False) else 1
    optim = {"sumsq": steps, **({"adamw_update": steps}
                                if cfg.optimizer == "adamw" else
                                {k: steps for k in ADAFACTOR_KERNELS})}
    if rules and cfg.optimizer != "adamw":
        optim["adafactor_sums"] *= 2
    if cfg.attn_free:
        return {"wkv6": (1 + again) * cfg.n_layers * steps,
                "wkv6_backward": cfg.n_layers * steps, **optim}
    if cfg.family != "hybrid":
        wrapped = cfg.n_layers
        if cfg.is_encoder_decoder:
            wrapped = cfg.encoder_layers + 2 * cfg.n_layers
        once = 1 if cfg.mtp else 0
        return {"flash_prefill": ((1 + again) * wrapped + once) * steps,
                "flash_backward": (wrapped + once) * steps, **optim}
    pattern = cfg.block_pattern
    groups = cfg.n_layers // len(pattern)
    tail = pattern[:cfg.n_layers - groups * len(pattern)]
    out = {}
    for kind, fwd, bwd in (("attn", "flash_prefill", "flash_backward"),
                           ("rec", "rglru", "rglru_backward")):
        g, t = groups * pattern.count(kind), tail.count(kind)
        out[fwd] = ((1 + again) * g + t) * steps
        out[bwd] = (g + t) * steps
    return {**out, **optim}


def bwd_bound(q, k, v, causal: bool = True,
              window: int | None = None) -> tuple[float, float]:
    """(bytes ms, operations ms) for one backward in a training form
    (``costs.flash_backward_cost``: causal with Sq = Skv, or non-causal
    with any; D and Dv from q and v), over 3.35 TB/s and the bf16
    tensor-core peak."""
    B, Sq, H, D = q.shape
    flops, nbytes = costs.flash_backward_cost(
        B, Sq, H, k.shape[2], D, q.element_size(), Skv=k.shape[1],
        Dv=v.shape[3], causal=causal, window=window)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / BF16_FLOP_PER_S * 1e3)


def attn_inputs(dev, B, S, dtype, seed, H=32, KV=8, D=64, Dv=None,
                Skv=None):
    """q ``(B, S, H, D)``, k ``(B, Skv, KV, D)``, v ``(B, Skv, KV, Dv)``
    and dO ``(B, S, H, Dv)`` (``Dv`` default D, ``Skv`` default S), normal
    from ``seed``."""
    Dv = D if Dv is None else Dv
    Skv = S if Skv is None else Skv
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, device=dev, generator=gen).to(dtype)
            for s in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv),
                      (B, S, H, Dv))]


def attn_form(hd, S):
    """A case's heads and form: ``hd`` holds H, KV, D and optionally Dv,
    ``causal`` (default True) and ``scale`` (the softmax scale, default D
    ** -0.5); ``S`` is S or (Sq, Skv).  Returns (``attn_inputs``' head
    keywords, Sq, Skv, the keywords of a forward, backward or plain call:
    causal and softmax_scale)."""
    Sq, Skv = (S, S) if isinstance(S, int) else S
    heads = {k: hd[k] for k in ("H", "KV", "D", "Dv") if k in hd}
    return heads, Sq, Skv, dict(causal=hd.get("causal", True),
                                softmax_scale=hd.get("scale"))


def check_flash_backward(dev) -> dict:
    """The forward kernel's output and the backward kernel against their
    plain versions on the same inputs, every case of BWD_CASES in bf16 and
    f32: o (the routed kernel: the ``wgmma`` prefill in bf16, the simple
    kernel in f32) against ``_flash_torch`` and ``attention_ref`` at the
    flash tolerance (``fa_err``), then dq, dk and dv given that o against
    ``flash_attention_backward_torch``; then ``FlashAttentionFn`` (what
    ``flash_attention`` takes under autograd on the card) against autograd
    of the plain forward at (2, 200) in f32 (the simple kernel) and at the
    train step's (8, 256) in bf16 (the prefill route).  bf16 runs both
    backward kernels (the tensor-core one, bf16's route, and the CUDA-core
    one) and holds them against each other and the tensor-core kernel's
    second run bit-equal to its first (no atomics); f32 runs the CUDA-core
    kernel, its route.  Returns the worst errors."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_backward_torch,
    )
    worst = {"max_abs_err": 0.0, "bf16_ulps": 0.0, "f32_rel": 0.0,
             "forward": 0.0, "function_bf16_ulps": 0.0,
             "function_f32_rel": 0.0, "sm90_bf16_ulps": 0.0,
             "simple_bf16_ulps": 0.0, "sm90_vs_simple_bf16_ulps": 0.0}
    for B, S in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = attn_inputs(dev, B, S, dtype, SEED + S)
            o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                        q_start=0, kv_len=S)
            for impl in ("torch", "ref"):
                e, ok = fa_err(o, flash_attention(q, k, v, causal=True,
                                                  impl=impl))
                check(ok, f"flash forward (B {B}, S {S}, {dtype}, route "
                          f"{FK.pick_route(S, 4, dtype, 64, 64)}) vs {impl}: "
                          f"max abs err {e}")
                worst["forward"] = max(worst["forward"], e)
            want = flash_attention_backward_torch(q, k, v, o, do)
            route = FK.pick_backward_route(dtype, 64, 64)
            kernels = {route: FK.flash_backward_cuda}
            if dtype == torch.bfloat16:
                kernels["simple"] = FK.flash_backward_simple_cuda
            got = {}
            for kname, fn in kernels.items():
                got[kname] = fn(q, k, v, o, do)
                torch.cuda.synchronize()
                for name, g, w in zip(("dq", "dk", "dv"), got[kname], want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"flash_backward {name}: {g.dtype} "
                          f"{tuple(g.shape)}")
                    e = float((g.float() - w.float()).abs().max())
                    tol = bwd_tol(w, dtype)
                    check(e <= tol, f"flash_backward ({kname} kernel) "
                                    f"{name} (B {B}, S {S}, {dtype}): max "
                                    f"abs err {e} > {tol}")
                    worst["max_abs_err"] = max(worst["max_abs_err"], e)
                    key = "f32_rel" if dtype == torch.float32 \
                        else "bf16_ulps"
                    r = e / tol * (BWD_RTOL32 if dtype == torch.float32
                                   else BWD_ULPS16)
                    worst[key] = max(worst[key], r)
                    if dtype == torch.bfloat16:
                        worst[f"{kname}_bf16_ulps"] = max(
                            worst[f"{kname}_bf16_ulps"], r)
            if dtype == torch.bfloat16:
                again = FK.flash_backward_sm90_cuda(q, k, v, o, do)
                torch.cuda.synchronize()
                for name, a, b, c in zip(("dq", "dk", "dv"), got["sm90"],
                                         again, got["simple"]):
                    check(torch.equal(a, b), f"flash_backward (sm90 kernel) "
                                             f"{name} (B {B}, S {S}): two "
                                             f"runs differ")
                    e = float((a.float() - c.float()).abs().max())
                    worst["sm90_vs_simple_bf16_ulps"] = max(
                        worst["sm90_vs_simple_bf16_ulps"],
                        e / bwd_tol(c, dtype) * BWD_ULPS16)
    for (B, S), dtype in (((2, 200), torch.float32),
                          ((TRAIN_BATCH, TRAIN_SEQ), torch.bfloat16)):
        q, k, v, do = attn_inputs(dev, B, S, dtype, SEED + 1)
        for t in (q, k, v):
            t.requires_grad_(True)
        o = flash_attention(q, k, v, causal=True)
        check(o.grad_fn is not None and "FlashAttentionFn" in
              type(o.grad_fn).__name__,
              f"flash_attention under autograd on the card: grad_fn "
              f"{o.grad_fn}")
        got = torch.autograd.grad(o, (q, k, v), do)
        ref = flash_attention(q, k, v, causal=True, impl="torch")
        want = torch.autograd.grad(ref, (q, k, v), do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            e = float((g.float() - w.float()).abs().max())
            tol = bwd_tol(w, dtype)
            key = "function_" + ("f32_rel" if dtype == torch.float32
                                 else "bf16_ulps")
            worst[key] = max(worst[key], e / tol * (
                BWD_RTOL32 if dtype == torch.float32 else BWD_ULPS16))
            check(e <= tol, f"FlashAttentionFn {name} (B {B}, S {S}, "
                            f"{dtype}) vs autograd of the plain forward: "
                            f"max abs err {e} > {tol}")
    say(f"train: the forward kernel's o vs _flash_torch and attention_ref "
        f"and flash_backward vs flash_attention_backward_torch, (B, S) in "
        f"{BWD_CASES}, H 32, KV 8, D 64, bf16 and f32: o max abs err "
        f"{worst['forward']:.3e} (flash tolerance); gradients max abs err "
        f"{worst['max_abs_err']:.3e}, f32 (CUDA-core kernel) "
        f"{worst['f32_rel']:.3e} of the largest gradient (tol {BWD_RTOL32}), "
        f"bf16 {worst['bf16_ulps']:.2f} ulps of it (tol {BWD_ULPS16}): the "
        f"tensor-core kernel {worst['sm90_bf16_ulps']:.2f}, the CUDA-core "
        f"kernel {worst['simple_bf16_ulps']:.2f}, the two against each other "
        f"{worst['sm90_vs_simple_bf16_ulps']:.2f}; the tensor-core kernel's "
        f"two runs bit-equal; FlashAttentionFn vs autograd of "
        f"the plain forward: f32 (2, 200) {worst['function_f32_rel']:.3e} of "
        f"the largest gradient, bf16 ({TRAIN_BATCH}, {TRAIN_SEQ}) "
        f"{worst['function_bf16_ulps']:.2f} ulps of it")
    return worst


def leaf_paths(tree, prefix="") -> list[str]:
    """The leaves' paths in ``tree_flatten``'s order (sorted dict keys,
    lists and tuples in order by index, ``None`` no leaf)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, f"{prefix}/{i}")]
    return [] if tree is None else [prefix]


def loss_grads(model, params, batch, impl) -> tuple:
    """(loss, the gradient of every leaf) by ``model.loss_fn`` under
    autograd, as ``make_train_step`` takes them, before its clip."""
    from repro_torch.models.params import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = model.loss_fn(params, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def worst_grad_err(got, want, paths, n_layers,
                   stacked=None) -> tuple[float, str]:
    """The worst relative L2 error ||g - w|| / ||w|| over the leaves, a
    stacked leaf (first dim ``n_layers``, or where ``stacked(path, w)``)
    layer by layer, and where."""
    check(len(paths) == len(got) == len(want),
          f"{len(paths)} leaf paths for {len(got)} / {len(want)} gradients")
    worst, where = 0.0, ""
    is_stacked = stacked or (lambda path, w: w.dim() >= 2
                             and w.shape[0] == n_layers)
    for path, g, w in zip(paths, got, want):
        stacked = is_stacked(path, w)
        for i, (gs, ws) in enumerate(zip(g, w) if stacked else [(g, w)]):
            d = float(torch.linalg.vector_norm((gs - ws).float()))
            e = d / max(float(torch.linalg.vector_norm(ws.float())), 1e-30)
            if e > worst:
                worst, where = e, path + (f"[{i}]" if stacked else "")
    return worst, where


def grad_compare(model, params, batch) -> dict:
    """The full-width loss's gradient through the kernels (impl="auto")
    against the plain versions' (impl="torch"), leaf by leaf and layer by
    layer (``worst_grad_err``) within TRAIN_GRAD_RTOL; then the same
    reading of a deliberately broken backward, the backward kernel's dK of
    KV head 0 zeroed in its first launch (the last layer), which must
    read above TRAIN_GRAD_RTOL: the check can see a wrong attention
    gradient in one head of one layer.  Launches here are outside the
    counted runs."""
    from repro_torch.kernels.flash_attention import kernel as FK
    paths = leaf_paths(params)
    L = model.cfg.n_layers
    _, want = loss_grads(model, params, batch, "torch")
    _, got = loss_grads(model, params, batch, "auto")
    sound, sound_at = worst_grad_err(got, want, paths, L)
    del got
    kernel, broke = FK.flash_backward_cuda, []

    def broken(*a, **kw):
        dq, dk, dv = kernel(*a, **kw)
        if not broke:
            dk[:, :, 0] = 0
            broke.append(1)
        return dq, dk, dv

    FK.flash_backward_cuda = broken
    try:
        _, bad = loss_grads(model, params, batch, "auto")
    finally:
        FK.flash_backward_cuda = kernel
    broken_err, broken_at = worst_grad_err(bad, want, paths, L)
    del bad, want
    say(f"train: full-width gradient through the kernels vs the plain "
        f"versions, {len(paths)} leaves (stacked ones by layer): worst "
        f"relative L2 error {sound:.3e} at {sound_at} (limit "
        f"{TRAIN_GRAD_RTOL}); with one KV head's dK zeroed in the last "
        f"layer's backward it reads {broken_err:.3e} at {broken_at}")
    check(sound <= TRAIN_GRAD_RTOL,
          f"the full-width gradient through the kernels is {sound} (at "
          f"{sound_at}) from the plain versions', above {TRAIN_GRAD_RTOL}")
    check(broken_err > TRAIN_GRAD_RTOL,
          f"a broken attention backward reads {broken_err} (at "
          f"{broken_at}), within {TRAIN_GRAD_RTOL}: the gradient check "
          f"cannot see it")
    return dict(grad_rel_err=sound, grad_rel_err_at=sound_at,
                broken_grad_rel_err=broken_err,
                broken_grad_rel_err_at=broken_at)


def train_step_compare(dev, card):
    """One full-width llama3.2-1b train step through the kernels
    (impl="auto") against the same step through the plain versions
    (impl="torch"), from the same params, optimizer state and batch; the
    kernels' step's launches.  Returns (model, opt, state after the
    kernels' step, batch, record)."""
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.zoo import build_model

    cfg = configs.get("llama3.2-1b")
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    plain_params = tree_map(lambda t: t.clone(), params)
    pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    kw = dict(peak_lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    grads = grad_compare(model, params, batch)
    torch.cuda.empty_cache()
    state = {"params": params, "opt": opt.init(params)}
    reset_all()
    state, m_k = make_train_step(model, opt, impl="auto", **kw)(state, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    want = train_launches(cfg)
    check(launches == want, f"one train step launched {launches}, the "
                            f"train path needs {want} (remat "
                            f"{cfg.remat!r})")
    routes = backward_routes()
    want = {"sm90": cfg.n_layers, "simple": 0}
    check(routes == want, f"one bf16 train step's backward launches by "
                          f"kernel {routes}, the route gives {want}")
    plain = {"params": plain_params, "opt": opt.init(plain_params)}
    _, m_p = make_train_step(model, opt, impl="torch", **kw)(plain, batch)
    torch.cuda.synchronize()
    del plain, plain_params
    got = {k: float(m_k[k]) for k in ("loss", "grad_norm", "lr")}
    ref = {k: float(m_p[k]) for k in ("loss", "grad_norm", "lr")}
    check(all(np.isfinite(list(got.values()))), f"train step metrics {got}")
    check(abs(got["loss"] - ref["loss"]) <= TRAIN_ATOL
          and abs(got["grad_norm"] - ref["grad_norm"])
          <= TRAIN_ATOL * ref["grad_norm"],
          f"train step through the kernels {got} vs the plain versions "
          f"{ref} (loss atol {TRAIN_ATOL}, grad_norm rtol {TRAIN_ATOL})")
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    say(f"train: llama3.2-1b at full width ({n} parameters, bf16), batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: one step through the kernels "
        f"{got} vs through the plain versions {ref} (loss atol {TRAIN_ATOL}, "
        f"grad_norm rtol {TRAIN_ATOL}); its launches {launches}, the "
        f"backward's by kernel {routes} [{card}]")
    rec = dict(loss=got["loss"], loss_plain=ref["loss"],
               grad_norm=got["grad_norm"], grad_norm_plain=ref["grad_norm"],
               step_launches=launches, step_backward_routes=routes, **grads)
    return model, opt, state, batch, rec


TRAIN_PARTS = ("forward", "backward", "clip", "optimizer")


def step_parts(model, opt, state, batch) -> dict:
    """One train step in its parts: the loss (forward), its gradient
    (backward), the clip and the optimizer's update, each in a
    ``record_function`` range (for a trace) and timed twice: on the
    device by CUDA events between the parts, and on the host from the
    part's first op to its last op queued (no wait in between).  Returns
    {part: (device ms, host issue ms)}.  The parts are
    ``make_train_step``'s body, called one by one so that events can sit
    between them.  The clip is the norm and the scale (the norm one
    ``sumsq`` launch); the gradients' scaling is the optimizer's (AdamW:
    one ``adamw_update`` launch with the update; Adafactor: its three
    kernels')."""
    from torch.profiler import record_function

    from repro_torch.kernels.optim.ops import global_norm
    from repro_torch.models.params import tree_flatten, tree_unflatten
    from repro_torch.optim.schedule import cosine_warmup
    params = state["params"]
    leaves, treedef = tree_flatten(params)
    ev, host = [torch.cuda.Event(enable_timing=True)], [time.perf_counter()]

    def mark():
        host.append(time.perf_counter())
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    ev[0].record()
    with torch.enable_grad():
        with record_function("forward"):
            loss, _ = model.loss_fn(params, batch)
        mark()
        with record_function("backward"):
            grads = torch.autograd.grad(loss, leaves)
        mark()
    with record_function("clip"):
        gnorm = global_norm(grads, impl="auto" if opt.fused_clip
                            else "torch")
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = cosine_warmup(state["opt"]["step"], peak_lr=3e-4, warmup=10,
                           total=TRAIN_STEPS)
    mark()
    with record_function("optimizer"):
        opt.update(tree_unflatten(treedef, list(grads)), state["opt"],
                   params, lr_scale=lr / opt.lr, clip_scale=scale)
    mark()
    torch.cuda.synchronize()
    return {n: (ev[i].elapsed_time(ev[i + 1]),
                (host[i + 1] - host[i]) * 1e3)
            for i, n in enumerate(TRAIN_PARTS)}


def time_train_step(model, opt, state, batch, card,
                    steps: int = TIMED_STEPS) -> dict:
    """ms per step (host clock, each step ending in ``synchronize``) over
    ``steps`` steps after the first, tokens/s, the model FLOPs' share of
    the bf16 peak (6 N per token), the device's busy time and idle share
    over one traced step with its flash kernels' time, the step's parts
    (``step_parts``), the optimizer's bound (the bytes its update must
    move: the gradient read, the parameters read and written, its state
    read and written, over 3.35 TB/s) and the peak memory allocated."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in tree_leaves(tree))
    opt_bytes = 3 * nbytes(state["params"]) + 2 * nbytes(state["opt"])
    opt_name = type(opt).__name__
    step = make_train_step(model, opt, impl="auto", peak_lr=3e-4, warmup=10,
                           total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    busy, n_act, by_name = device_profile(lambda: step(state, batch))
    parts = step_parts(model, opt, state, batch)
    med = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = model.cfg.param_count()
    share = 6 * n * tokens / (med / 1e3) / BF16_FLOP_PER_S
    kern = lambda key: sum(t for name, (t, _) in by_name.items()
                           if key in name)
    out = dict(ms_median=med, ms_min=min(ms), ms=ms,
               tokens_per_s=tokens / (med / 1e3), model_flops_share=share,
               busy_us=busy, idle_share=max(0.0, 1 - busy / (med * 1e3)),
               activities=n_act, peak_allocated=peak,
               peak_reserved=torch.cuda.max_memory_reserved(),
               parts_device_host_ms=parts, optimizer=opt_name,
               optimizer_bytes=opt_bytes,
               optimizer_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
               flash_prefill_us=kern("flash_prefill_kernel"),
               flash_backward_us=kern("bwd_"),
               rglru_us=kern("rglru_staged_kernel"),
               rglru_backward_us=kern("rglru_backward_kernel"),
               wkv6_us=kern("wkv6_kernel"),
               wkv6_backward_us=kern("wkv6_backward_kernel")
               + kern("wkv6_du_kernel"),
               gemm_us=kern("gemm") + kern("nvjet") + kern("cutlass"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    say(f"train: {model.cfg.name} step (B {TRAIN_BATCH}, S {TRAIN_SEQ}, bf16, "
        f"{opt_name}): {med:.2f} ms median, {min(ms):.2f} min of {steps} "
        f"(host clock, each ending in synchronize); {out['tokens_per_s']:.0f} "
        f"tokens/s; model FLOPs (6 x {n} x {tokens}) {share:.4f} of "
        f"989 TFLOP/s; one traced step: device busy {busy:.1f} us, idle "
        f"share {out['idle_share']:.4f}, {n_act} activities, flash prefill "
        f"{out['flash_prefill_us']:.1f} us, flash backward "
        f"{out['flash_backward_us']:.1f} us, RG-LRU forward / backward "
        f"{out['rglru_us']:.1f} / {out['rglru_backward_us']:.1f} us, "
        f"WKV-6 forward / backward {out['wkv6_us']:.1f} / "
        f"{out['wkv6_backward_us']:.1f} us, products (gemm / nvjet / "
        f"cutlass kernels) {out['gemm_us']:.1f} us; parts by CUDA events "
        f"(host issue) "
        + ", ".join(f"{k} {d:.2f} ms ({h:.2f})" for k, (d, h)
                    in parts.items())
        + f" (the optimizer's bound {out['optimizer_bound_ms']:.3f} ms: "
          f"{opt_bytes} bytes)"
        + f"; peak allocated {peak} B (reckoned ~{TRAIN_MEM_BYTES:.0f}); "
        f"largest kernels "
        + ", ".join(f"{k[:60]} {t:.1f} us x {c}" for k, (t, c) in top)
        + f" [{card}]")
    return out


def remat_compare(model, opt, state, batch, card) -> dict:
    """``cfg.remat`` at each of REMAT_SETTINGS on the same step: the loss
    and every gradient leaf (``loss_grads``, before the clip) bit-equal to
    "none"'s under ``torch.use_deterministic_algorithms(True)``; then one
    train step at each setting in turns, TIMED_STEPS rounds after one
    warm-up round: ms per step (host clock, each ending in
    ``synchronize``), the caching allocator's peak over the setting's steps
    (reset before each), the flash kernels' launches a step (counted from
    0, exactly ``train_launches``), and the step's parts by CUDA events
    (``step_parts``); and the peak of the loss and its gradient alone
    (``loss_grads``, in the bit-equality pass), also above the memory held
    before it (the step's own peak lies in the optimizer's update, which
    remat does not touch).  The settings share the parameters and the optimizer
    state, which each step moves on."""
    import dataclasses
    import os

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import build_model

    models = {r: build_model(dataclasses.replace(model.cfg, remat=r))
              for r in REMAT_SETTINGS}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # each setting's loss and gradient, and their peak above what is held
    # before them (the state, and "none"'s gradients after the first):
    # where the activations and their recompute show
    equal, grad_peak, base = {}, {}, None
    try:
        for r in REMAT_SETTINGS:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = loss_grads(models[r], state["params"], batch,
                                     "auto")
            torch.cuda.synchronize()
            grad_peak[r] = (torch.cuda.max_memory_allocated(), held)
            if base is None:
                base = (loss, grads)
            else:
                equal[r] = bool(torch.equal(loss, base[0])) and all(
                    torch.equal(a, b) for a, b in zip(grads, base[1]))
            del grads
    finally:
        torch.use_deterministic_algorithms(False)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    check(all(equal.values()),
          f"loss and gradients bit-equal to remat='none' (deterministic "
          f"algorithms): {equal}")
    steps = {r: make_train_step(models[r], opt, impl="auto", peak_lr=3e-4,
                                warmup=10, total_steps=TRAIN_STEPS)
             for r in REMAT_SETTINGS}
    rec = {r: dict(ms=[], peak_allocated=0, launches=None)
           for r in REMAT_SETTINGS}
    for rnd in range(TIMED_STEPS + 1):
        for r in REMAT_SETTINGS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all()
            t0 = time.perf_counter()
            state, _ = steps[r](state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in all_launches().items() if v}
            want = train_launches(models[r].cfg)
            check(launches == want, f"a train step at remat {r!r} "
                                    f"launched {launches}, not {want}")
            if rnd:                     # round 0 warms the setting up
                rec[r]["ms"].append(ms)
                rec[r]["peak_allocated"] = max(
                    rec[r]["peak_allocated"],
                    torch.cuda.max_memory_allocated())
                rec[r]["launches"] = launches
    for r in REMAT_SETTINGS:
        ms = rec[r]["ms"]
        rec[r].update(ms_median=statistics.median(ms), ms_min=min(ms),
                      grad_peak_allocated=grad_peak[r][0],
                      grad_peak_above_held=grad_peak[r][0] - grad_peak[r][1],
                      parts_device_host_ms=step_parts(models[r], opt, state,
                                                      batch))
    rec["grads_bit_equal_to_none"] = equal
    say("train: remat in turns (llama3.2-1b, B "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ}, bf16, AdamW; loss and gradients "
        f"bit-equal to 'none': {equal}): "
        + "; ".join(
            f"{r}: {rec[r]['ms_median']:.2f} / {rec[r]['ms_min']:.2f} ms a "
            f"step (median / min of {TIMED_STEPS}), peak "
            f"{rec[r]['peak_allocated']} B (the loss and its gradient "
            f"alone: {rec[r]['grad_peak_allocated']} B, "
            f"{rec[r]['grad_peak_above_held']} above what it held), "
            f"launches "
            f"a step "
            f"{rec[r]['launches']}, parts by CUDA events (host issue) "
            + ", ".join(f"{k} {d:.2f} ({h:.2f})" for k, (d, h)
                        in rec[r]["parts_device_host_ms"].items())
            for r in REMAT_SETTINGS) + f" [{card}]")
    return rec


# odd 64-bit constants (splitmix64's) as int64, for state_digests' mix
_MIX_KEY, _MIX_1, _MIX_2 = (c - (1 << 64) for c in (
    0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB))
# words a slice of a leaf, so that the mix's temporaries stay small
_DIGEST_SLICE = 1 << 24


def _mix_words(x):
    """A bijection of int64 words, in place: splitmix64's finaliser (xor
    with a logical right shift, multiply by an odd constant, twice; each
    step is invertible modulo 2^64), so a change in any bit of a word
    spreads over all 64 bits of its image."""
    for shift, mult in ((30, _MIX_1), (27, _MIX_2), (31, None)):
        x.bitwise_xor_((x >> shift) & ((1 << (64 - shift)) - 1))
        if mult is not None:
            x.mul_(mult)
    return x


def state_digests(tree) -> list:
    """Each leaf's dtype, shape and two sums, computed on the card, of its
    bytes read as int64 words w_i (the last zero-padded): each word keyed
    by its place and mixed, x_i = mix(w_i xor i K) (``_mix_words``, a
    bijection; K odd), then sum x_i and sum (2 i + 1) x_i, both modulo
    2^64.  Integer sums do not depend
    on their order, so two bit-equal states give equal digests; since the
    mix spreads every bit of a word over its image, two leaves that differ
    in any words give equal digests only by a chance of about 2^-64 a sum
    (the mix is not linear, so no pattern of flipped bits cancels by
    construction, as it would in sums of the raw words).  (A SHA-256 of
    each leaf copied to the host took 2.1-8.6 s a state at the CLI's
    depths; this takes milliseconds, and only 16 bytes a leaf reach the
    host.)"""
    from repro_torch.models.params import tree_leaves

    sums = []
    for t in tree_leaves(tree):
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        if b.numel() % 8:
            b = torch.cat([b, b.new_zeros(8 - b.numel() % 8)])
        w = b.view(torch.int64)
        d = torch.zeros(2, dtype=torch.int64, device=w.device)
        for s in range(0, w.numel(), _DIGEST_SLICE):
            ws = w[s:s + _DIGEST_SLICE]
            i = torch.arange(s, s + ws.numel(), dtype=torch.int64,
                             device=w.device)
            x = _mix_words(torch.bitwise_xor(ws, i * _MIX_KEY))
            d += torch.stack([x.sum(), (x * i.mul_(2).add_(1)).sum()])
            del x, i
        sums.append(d)
        del b, w
    got = torch.stack(sums).cpu().tolist() if sums else []
    return [(str(t.dtype), tuple(t.shape), tuple(d))
            for t, d in zip(tree_leaves(tree), got)]


def cli_run_and_replay(dev, card, arch="llama3.2-1b", steps=TRAIN_STEPS,
                       ckpt_every=TRAIN_CKPT_EVERY,
                       layers=TRAIN_CLI_LAYERS) -> dict:
    """``launch/train.py``'s ``main`` in this process: ``steps`` steps of
    ``arch`` at published width, ``layers`` deep (``--layers``), at the
    CLI's other defaults with a checkpoint every
    ``ckpt_every`` steps, the launch counts set to 0 just before and read
    just after (the train path's own); then a second run in another
    directory that holds only the step-``ckpt_every`` checkpoint, which
    resumes there and replays to ``steps``.  Both under
    ``torch.use_deterministic_algorithms(True)``: torch's backward of the
    embedding lookup and of the loss's gather add with atomics otherwise
    (cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG``; ``:4096:8`` is the 32
    MiB PyTorch gives a Hopper card anyway).  The replay's parameters and
    optimizer state must equal the straight run's bit for bit: their
    ``state_digests`` are compared, the straight run's taken and its state
    freed before the replay (which holds a state of its own and restores
    the checkpoint beside it).  The checkpoints go under
    ``build/chip_smoke_train``, removed at the end."""
    import os
    import shutil

    import repro_torch.configs as configs
    from repro_torch.launch import train

    cfg = configs.cut_depth(configs.get(arch), layers)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", arch, "--layers", str(layers), "--steps", str(steps),
            "--ckpt-every", str(ckpt_every), "--log-every", "1",
            "--seed", str(SEED)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        reset_all()
        t0 = time.perf_counter()
        straight = train.main(argv + ["--ckpt-dir", str(root / "a")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        routes = backward_routes()
        want = train_launches(cfg, steps)
        check(launches == want, f"the CLI's {steps} steps launched "
                                f"{launches}, the train path needs {want} "
                                f"(remat {cfg.remat!r})")
        want = {"sm90": want.get("flash_backward", 0), "simple": 0}
        check(routes == want, f"the CLI's {steps} steps' backward "
                              f"launches by kernel {routes}, the bf16 route "
                              f"gives {want}")
        losses = straight["losses"]
        check(straight["end_step"] == steps
              and len(losses) == steps
              and all(np.isfinite(losses)),
              f"the CLI ended at {straight['end_step']}, losses {losses}")
        (root / "b").mkdir(parents=True)
        ck = f"step_{ckpt_every:010d}"
        os.rename(root / "a" / ck, root / "b" / ck)
        shutil.rmtree(root / "a")
        t0 = time.perf_counter()
        want = state_digests(straight.pop("state"))
        digest_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        replay = train.main(argv + ["--ckpt-dir", str(root / "b")])
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    check(replay["start"] == ckpt_every
          and replay["losses"] == losses[ckpt_every:],
          f"the replay resumed at {replay['start']} with losses "
          f"{replay['losses']}, the straight run's {losses}")
    got = state_digests(replay.pop("state"))
    check(got == want, "the replay from the checkpoint is not bit-equal to "
                       "the straight run")
    say(f"train: python -m repro_torch.launch.train {' '.join(argv)} (in "
        f"process, deterministic algorithms, checkpoints under {root}): "
        f"losses {losses}, launches "
        f"{launches} (a step: {train_launches(cfg)}, remat "
        f"{cfg.remat!r}; the backward's by kernel {routes}), "
        f"{run_s:.1f} s with "
        f"checkpoints; the replay from step {ckpt_every} "
        f"({replay_s:.1f} s) ends bit-equal in all {len(got)} leaves of "
        f"params and optimizer state (each state's digests "
        f"{digest_s:.1f} s) [{card}]")
    return dict(losses=losses, launches=launches, backward_routes=routes,
                run_s=run_s, replay_s=replay_s, digest_s=digest_s)


def backward_turn(fn, per_call: int, calls: int = 10) -> float:
    """Device ms per call of a backward wrapper that launches ``per_call``
    kernels (named ``bwd_*``): a trace of ``calls`` calls after two
    warm-up calls.  A trace that lost some of the launches (the profiler
    drops events at random) reads low, so it is taken again, up to
    TRACE_TRIES times; failing that, the most complete trace's mean per
    launch times ``per_call``, and a line says so."""
    fn(), fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(TRACE_TRIES):
        prof = device_profile(lambda: [fn() for _ in range(calls)],
                              required=False)
        if prof is None:
            continue
        got = [(t, c) for name, (t, c) in prof[2].items() if "bwd_" in name]
        n, us = sum(c for _, c in got), sum(t for t, _ in got)
        if n == calls * per_call:
            return us / calls / 1e3
        best = max(best, (n, us))
    check(best[0] > 0, "no trace held a backward kernel")
    say(f"timing: no trace held all {calls * per_call} backward launches; "
        f"the best held {best[0]}, whose mean per launch is used")
    return best[1] / best[0] * per_call / 1e3


def time_train_flash(dev, card) -> dict:
    """The flash forward (routed: the ``wgmma`` prefill) and backward
    kernels at the train step's shape (B 8, S 256, H 32, KV 8, D 64, bf16)
    against their bounds, their plain versions and SDPA's forward and
    backward (``is_causal=True, enable_gqa=True``; a yardstick, never
    called by the port).  The backward's two kernels are timed in turns
    (``backward_turn``: traces that hold every launch), the CUDA-core one,
    the tensor-core one (bf16's route), the tensor-core one, the CUDA-core
    one: ``kernel`` is the mean of the tensor-core kernel's two times,
    ``simple`` of the other's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        _flash_torch,
        flash_attention_backward_torch,
    )
    q, k, v, do = attn_inputs(dev, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16,
                              SEED + 3)
    S = TRAIN_SEQ
    o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                q_start=0, kv_len=S)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                        enable_gqa=True)
    dos = do.transpose(1, 2)
    fwd = {
        "kernel": lambda: FK.flash_attention_cuda(
            q, k, v, causal=True, window=None, q_start=0, kv_len=S),
        "plain": lambda: _flash_torch(q, k, v, causal=True, window=None,
                                      q_start=0, kv_len=None,
                                      softmax_scale=None, kv_chunk=1024),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True),
    }
    bwd = {
        "simple": lambda: FK.flash_backward_simple_cuda(q, k, v, o, do),
        "kernel": lambda: FK.flash_backward_cuda(q, k, v, o, do),
        "plain": lambda: flash_attention_backward_torch(q, k, v, o, do),
        "sdpa": lambda: torch.autograd.grad(so, (qs, ks, vs), dos,
                                            retain_graph=True),
    }
    out = {}
    with torch.no_grad():
        t_f = {i: time_replay([()], fn, reps=10)[0] for i, fn in fwd.items()}
    turns = {"simple": [], "kernel": []}
    for i in ("simple", "kernel", "kernel", "simple"):
        turns[i].append(backward_turn(bwd[i], 3 if i == "simple" else 2))
    t_b = {i: statistics.mean(t) for i, t in turns.items()}
    t_b.update({i: time_replay([()], bwd[i], reps=10)[0]
                for i in ("plain", "sdpa")})
    for name, t, bound in (("forward", t_f, fa_bound(q, k, v, dict(
            q_start=0, kv_len=S))), ("backward", t_b, bwd_bound(q, k, v))):
        by = "bytes" if bound[0] >= bound[1] else "operations"
        out[name] = dict(ms=t["kernel"], plain_ms=t["plain"],
                         library_ms=t["sdpa"], bound_ms=max(bound),
                         bound_by=by)
        extra = ""
        if name == "backward":
            out[name].update(simple_ms=t["simple"], turns_ms=turns)
            extra = (f" (the tensor-core kernel; in turns "
                     f"{turns['kernel'][0] * 1e3:.2f}, "
                     f"{turns['kernel'][1] * 1e3:.2f}), the CUDA-core kernel "
                     f"{t['simple'] * 1e3:.2f} (in turns "
                     f"{turns['simple'][0] * 1e3:.2f}, "
                     f"{turns['simple'][1] * 1e3:.2f})")
        say(f"timing: flash {name} at the train step's shape (B "
            f"{TRAIN_BATCH}, S {S}, H 32, KV 8, D 64, bf16, causal): device "
            f"us per launch: kernel {t['kernel'] * 1e3:.2f}{extra}, bound "
            f"{max(bound) * 1e3:.3f} ({by}; bytes {bound[0] * 1e3:.3f}, "
            f"operations {bound[1] * 1e3:.3f}), plain {t['plain'] * 1e3:.2f},"
            f" sdpa {t['sdpa'] * 1e3:.2f} [{card}]")
    return out


# the fleet phase (runtime/fleet.py, as launch/serve.py:run_fleet builds it)
# at llama3.2-1b's published config: the serve CLI's buckets for prompts of
# 1024 + GEN tokens, 4 decode shards and 1 prefill shard; FLEET_ARRIVALS of
# OpenLoopLoadGen(rate 2.0, prompts of mean 1024, 32 generated on average,
# a quarter latency-class), cut from 256 by time: the simulated step moves
# each request's whole resident state (34.6 MB at bucket 1056) a token on
# the host; the same arrivals again under FLEET_FAULT_SEEDS per-shard fault
# scripts (FaultPlan.generate over FLEET_FAULT_TICKS ticks, about a
# fault-free run's, at FLEET_FAULT_RATE a tick), each run in a process of
# its own (fleet_runs).  The one prefill lane (32 prompt tokens a
# request and tick, 8 requests) admits far fewer requests a tick than
# arrive, so it is the shard that fills: a run must bring a shard to
# FLEET_NEAR_BUDGET of its budget, and the fault scripts must preempt
# under a shrunk budget
FLEET_ARRIVALS = 96
FLEET_FAULT_SEEDS = 8
FLEET_FAULT_TICKS = 440
FLEET_FAULT_RATE = 0.05
FLEET_NEAR_BUDGET = 0.9
FLEET_SHARDS = (4, 1)              # decode, prefill
# bytes of 0xA5 on each side of a bucket's arena, which the packs must
# leave alone
FLEET_GUARD = 4096
# the real server's chaos corpus: tests/test_chaos.py's sizes and scripts
CHAOS_SEEDS = 32
CHAOS_PROMPT, CHAOS_GEN, CHAOS_REQ, CHAOS_ARENAS = 4, 3, 4, 3


def chaos_corpus(ctx, card) -> dict:
    """``tests/test_chaos.py``'s generated corpus on the port's real server
    on the card (``run_server``, its captured decode step), at the published
    width of ``ctx``'s model: 4 requests of 4 prompt tokens + 3, half of
    them latency-class, priorities 0 and 1, a budget of 3 shared arenas
    (one latency-class, two memory-class: at published width the pinned
    plan of a latency-class request alone is above 3 memory-class arenas),
    one warm arena; a fault-free run serving all 4, then
    ``FaultPlan.generate(seed,
    n_ticks=8, rate=0.4)`` for seeds 0 to CHAOS_SEEDS - 1.  Every run: no
    request lost (served + rejected = requests), never over the
    instantaneous budget, every served request's tokens bit-equal to the
    fault-free run's.  The fault-free run's launches are counted from 0."""
    from repro_torch.core import pin_transients, plan_shared_arena
    from repro_torch.launch import serve as S
    from repro_torch.runtime.chaos import ChaosController, FaultPlan

    t0 = time.perf_counter()
    model, params = ctx["model"], ctx["params"]
    smax = CHAOS_PROMPT + CHAOS_GEN
    plan = S.plan_decode_arena(model, 1, smax)
    budget = plan_shared_arena(
        [pin_transients(plan["plan"])]
        + [plan["plan"]] * (CHAOS_ARENAS - 1)).arena_bytes

    def serve(chaos=None):
        reqs = S.synth_requests(CHAOS_REQ, CHAOS_PROMPT, CHAOS_GEN,
                                model.cfg.vocab_size, seed=3,
                                latency_frac=0.5, priorities=(0, 1))
        m = S.run_server(model, params, reqs, smax=smax, budget_bytes=budget,
                         warm=1, chaos=chaos)
        return reqs, m

    reset_all()
    reqs, m = serve()
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    base = {r.rid: list(r.tokens) for r in reqs if not r.rejected}
    # both classes served: the budget holds a latency-class plan (its
    # transients pinned: the f32 logits of a 128,256-token vocabulary
    # among them) beside two memory-class ones
    check(set(base) == {r.rid for r in reqs}
          and {r.klass for r in reqs} == {"latency", "memory"}
          and all(len(t) == CHAOS_GEN for t in base.values()),
          f"chaos: the fault-free run served {sorted(base)} "
          f"({m['n_tokens']} tokens), rejected "
          f"{[(r.rid, r.klass, r.reject_code) for r in reqs if r.rejected]}")
    # a prompt of 4 tokens (16 query rows a KV head) and each decode step
    # take the split-K decode in every layer; a prefill packs the state,
    # each decode step unpacks and packs it
    n, L = len(base), model.cfg.n_layers
    want = {"write": plan["n_cache"] * n * CHAOS_GEN,
            "read": plan["n_cache"] * n * (CHAOS_GEN - 1),
            "flash_decode": L * n * CHAOS_GEN}
    check(launches == want, f"chaos: the fault-free run launched "
                            f"{launches}, its path needs {want}")
    totals = dict(served=0, rejected=0, preempted=0, readmitted=0,
                  transient_errors=0, budget_shrinks=0, admission_faults=0,
                  faults=0)
    for seed in range(CHAOS_SEEDS):
        fp = FaultPlan.generate(seed, n_ticks=8, rate=0.4)
        reqs, m = serve(ChaosController(fp))
        toks = {r.rid: list(r.tokens) for r in reqs if not r.rejected}
        what = f"chaos seed {seed} ({fp.describe()})"
        check(m["n_served"] + m["n_rejected"] == CHAOS_REQ,
              f"{what}: {m['n_served']} served + {m['n_rejected']} "
              f"rejected of {CHAOS_REQ}")
        check(m["max_over_budget_bytes"] <= 0,
              f"{what}: {m['max_over_budget_bytes']} B over the budget")
        check(all(r.reject_code for r in reqs if r.rejected),
              f"{what}: a request rejected without a code")
        for rid, t in toks.items():
            check(t == base[rid], f"{what}: request {rid}'s tokens {t}, "
                                  f"the fault-free run's {base[rid]}")
        totals["served"] += m["n_served"]
        totals["rejected"] += m["n_rejected"]
        totals["preempted"] += m["n_preempted"]
        totals["readmitted"] += m["n_readmitted"]
        totals["transient_errors"] += m["transient_errors"]
        totals["budget_shrinks"] += m["budget_shrinks"]
        totals["admission_faults"] += m["admission_faults"]
        totals["faults"] += len(fp.specs)
    sec = time.perf_counter() - t0
    say(f"chaos: {model.cfg.name} at full width, the real server "
        f"(captured decode) under {CHAOS_SEEDS} generated fault scripts "
        f"(FaultPlan.generate(seed, n_ticks=8, rate=0.4)), {CHAOS_REQ} "
        f"requests of {CHAOS_PROMPT} + {CHAOS_GEN} tokens, half "
        f"latency-class, under {budget} B (3 shared arenas, one of them "
        f"latency-class): the fault-free run served all {CHAOS_REQ}; no "
        f"request lost, never over the budget, every served request's "
        f"tokens bit-equal to the fault-free run's; over "
        f"the corpus {totals}; the fault-free run's launches {launches}; "
        f"{sec:.1f} s [{card}]")
    return dict(seeds=CHAOS_SEEDS, totals=totals, launches=launches,
                budget_bytes=budget, seconds=sec)


def fleet_run(seed, arrivals, buckets):
    """One run of the fleet phase on the fleet ``run_fleet`` builds over
    llama3.2-1b's plans (its default budget: 8 of the 2112 bucket's arenas
    a shard): fault-free (``seed`` None) or under per-shard fault scripts
    drawn from ``seed``.  Host work only: it touches no card.  Returns
    (the fault scripts, the metrics, each served request's tokens, each
    shard's peak over its budget, host s from the model's build on)."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.zoo import build_model
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.fleet import Fleet, bucket_key_for

    t0 = time.perf_counter()
    model = build_model(configs.get("llama3.2-1b"))
    n_decode, n_prefill = FLEET_SHARDS
    plans = None if seed is None else {
        sid: FaultPlan.generate(seed + 17 * sid, n_ticks=FLEET_FAULT_TICKS,
                                rate=FLEET_FAULT_RATE)
        for sid in range(n_decode + n_prefill)}
    planner, records = S.fleet_planner_for_model(model, buckets)
    budget = 8 * records[buckets[1]].alone_bytes
    fl = Fleet(planner, key_for=bucket_key_for(records), n_decode=n_decode,
               n_prefill=n_prefill, shard_budget_bytes=budget,
               fault_plans=plans)
    fm = dict(fl.run_arrivals(arrivals), shard_budget_bytes=budget)
    return (plans, fm, {r.rid: tuple(r.tokens) for r in fl.done},
            [round(sh.peak_reserved / budget, 4) for sh in fl.shards],
            time.perf_counter() - t0)


def fleet_runs(arrivals, buckets, pool: str = "processes") -> list:
    """The fault-free run and the FLEET_FAULT_SEEDS faulted ones
    (:func:`fleet_run`), all at once: each in a process of its own
    (started by ``spawn``: none inherits the card's context, and none
    shares the others' interpreter lock or address space), or, with
    ``pool="threads"``, in threads of this process."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    seeds = [None, *range(FLEET_FAULT_SEEDS)]
    if pool == "threads":
        ex = ThreadPoolExecutor(len(seeds))
    else:
        ex = ProcessPoolExecutor(
            len(seeds), mp_context=multiprocessing.get_context("spawn"))
    with ex:
        return list(ex.map(fleet_run, seeds, [arrivals] * len(seeds),
                           [buckets] * len(seeds)))


#: the host runs' worker processes when they run beside the train phase's
#: CLI block (two of the card machine's 8 cores left to the CLI)
FLEET_WORKERS = 6


def fleet_inputs():
    """(model, smax, buckets, arrivals) of the fleet phase."""
    import repro_torch.configs as configs
    from repro_torch.models.zoo import build_model
    from repro_torch.runtime.loadgen import OpenLoopLoadGen
    model = build_model(configs.get("llama3.2-1b"))
    smax = SERVES["llama3.2-1b"]["prompt"] + GEN
    arrivals = OpenLoopLoadGen(seed=SEED, rate=2.0, prompt_mean=1024,
                               gen_mean=32, latency_frac=0.25).arrivals(
                                   FLEET_ARRIVALS)
    return model, smax, (smax, 2 * smax, 8 * smax), arrivals


class FleetRuns:
    """The fleet's host runs (:func:`fleet_run`: the fault-free one and
    FLEET_FAULT_SEEDS faulted ones) started in FLEET_WORKERS processes of
    their own (``spawn``), to run beside the card's work; :meth:`result`
    waits for them.  They are simulations on the host: their ticks and
    tokens do not depend on how fast they run."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _, _, buckets, arrivals = fleet_inputs()
        seeds = [None, *range(FLEET_FAULT_SEEDS)]
        self.t0 = time.perf_counter()
        self.ex = ProcessPoolExecutor(
            FLEET_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.futures = [self.ex.submit(fleet_run, s, arrivals, buckets)
                        for s in seeds]

    def result(self) -> tuple[list, float]:
        """(the runs, in fleet_runs' order; seconds since they started)"""
        runs = [f.result() for f in self.futures]
        self.ex.shutdown()
        return runs, time.perf_counter() - self.t0

    def cancel(self) -> None:
        self.ex.shutdown(wait=True, cancel_futures=True)


def phase_fleet(dev, card, pending: FleetRuns | None = None) -> dict:
    """The sharded fleet over llama3.2-1b's real decode plans
    (the fleet ``launch/serve.py:run_fleet`` builds; simulated workers on
    the host): the open-loop arrivals served with no request lost (served +
    rejected = requests), every shard within its budget and one at
    FLEET_NEAR_BUDGET of it or more; the same arrivals under
    FLEET_FAULT_SEEDS per-shard fault scripts, each meeting the same
    invariants with every served request's tokens equal to the fault-free
    run's, one of them preempting under a shrunk budget.  Then each bucket's ``PlanRecord`` (the single-device server's
    decode plan, by fingerprint) realized on the card: a random bf16 decode
    state of the model at the bucket packed through ``arena_write`` at the
    record's offsets into a uint8 arena of the record's ``alone_bytes``
    (FLEET_GUARD bytes of 0xA5 on each side) and read back through
    ``arena_read``: bit-equal to the state, the guards and the transient
    region above ``resident_extent`` untouched, the packed bytes (and the
    sampled token's) the record's ``persistent_bytes`` = ``resident_extent``.
    The launches are counted from 0 over the phase: exactly one write and
    one read a state leaf and bucket.  With ``pending`` (:class:`FleetRuns`,
    started beside the train phase's CLI block) the host runs are its, and
    ``runs_s`` their time from their start, which they shared with the
    card's work."""
    from repro_torch.launch import serve as S
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime.loadgen import workload_summary

    t0 = time.perf_counter()
    model, smax, buckets, arrivals = fleet_inputs()
    n_decode, n_prefill = FLEET_SHARDS

    def invariants(m, what):
        check(m["n_lost"] == 0
              and m["n_served"] + m["n_rejected"] == m["n_requests"]
              == FLEET_ARRIVALS,
              f"fleet{what}: {m['n_served']} served + {m['n_rejected']} "
              f"rejected of {m['n_requests']} ({m['n_lost']} lost)")
        check(m["max_over_budget"] <= 0,
              f"fleet{what}: a shard {m['max_over_budget']} B over its "
              f"budget")

    reset_all()
    if pending is not None:
        runs, runs_s = pending.result()
    else:
        t1 = time.perf_counter()
        runs = fleet_runs(arrivals, buckets)
        runs_s = time.perf_counter() - t1
    run_s = [r[-1] for r in runs]
    _, m, base, peaks, base_s = runs.pop(0)
    invariants(m, "")
    check(m["n_served"] > 0, f"fleet: nothing served: {m}")
    check(max(peaks) >= FLEET_NEAR_BUDGET,
          f"fleet: no shard came near its budget (peaks {peaks} of it)")
    chaos = []
    for seed, (plans, fm, toks, fpeaks, _) in enumerate(runs):
        what = (f" seed {seed} ("
                + "; ".join(f"shard {sid}: {p.describe()}"
                            for sid, p in plans.items()) + ")")
        invariants(fm, what)
        for rid, t in toks.items():
            check(t == base[rid], f"fleet{what}: request {rid}'s tokens "
                                  f"differ from the fault-free run's")
        chaos.append(dict({k: fm[k] for k in (
            "n_served", "n_rejected", "ticks", "migrations", "handoffs",
            "requeues", "preemptions")}, peaks=fpeaks))
    # a preemption that is not a prefill handoff is a shrink below what a
    # shard held
    check(any(c["preemptions"] > c["handoffs"] for c in chaos),
          f"fleet: no fault script preempted under a shrunk budget: {chaos}")

    # each bucket's record realized on the card through the arena kernels
    _, records = S.fleet_planner_for_model(model, buckets)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    packs = {}
    for b, rec in records.items():
        d = S.plan_decode_arena(model, 1, b)
        check(rec.plan is d["plan"] and rec.alone_bytes == d["arena_bytes"]
              and rec.resident_extent == d["resident_extent"],
              f"fleet: bucket {b}'s record is not the server's decode plan")
        cache = model.init_cache(1, b, dev)
        leaves = tree_leaves(cache)
        for t in leaves:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        buf = torch.full((rec.alone_bytes + 2 * FLEET_GUARD,), 0xA5,
                         dtype=torch.uint8, device=dev)
        arena = buf[FLEET_GUARD:FLEET_GUARD + rec.alone_bytes]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        S.pack_decode_state(d, cache, arena)
        ev[1].record()
        back = tree_leaves(S.unpack_decode_state(d, arena, cache))
        ev[2].record()
        torch.cuda.synchronize()
        apl = d["plan"]
        written = sum(t.numel() * t.element_size() for t in leaves)
        top = max(apl.offset_of(i) + t.numel() * t.element_size()
                  for i, t in enumerate(leaves))
        token = rec.graph.sizes[-1]
        outside = torch.cat([buf[:FLEET_GUARD],
                             arena[rec.resident_extent:],
                             buf[FLEET_GUARD + rec.alone_bytes:]])
        check(all(torch.equal(a, w) for a, w in zip(back, leaves)),
              f"fleet: bucket {b}'s state read back differs")
        check(bool((outside == 0xA5).all()),
              f"fleet: bucket {b}'s packs wrote outside the resident region")
        check(top <= rec.resident_extent
              and written + token == rec.persistent_bytes
              == rec.resident_extent and arena.numel() == rec.alone_bytes,
              f"fleet: bucket {b}: {written} B packed (+ {token} B token), "
              f"top {top}; the record's persistent {rec.persistent_bytes}, "
              f"extent {rec.resident_extent}, alone {rec.alone_bytes}")
        packs[b] = dict(alone_bytes=rec.alone_bytes,
                        resident_extent=rec.resident_extent,
                        packed_bytes=written, leaves=len(leaves),
                        pack_ms=ev[0].elapsed_time(ev[1]),
                        unpack_ms=ev[1].elapsed_time(ev[2]))
        del cache, leaves, back, buf, arena
    torch.cuda.empty_cache()
    launches = {k: v for k, v in all_launches().items() if v}
    n_leaves = packs[smax]["leaves"]
    want = {"write": n_leaves * len(buckets), "read": n_leaves * len(buckets)}
    check(launches == want, f"fleet: the phase launched {launches}, its "
                            f"path needs {want}")
    sec = time.perf_counter() - t0
    out = dict(
        arrivals=FLEET_ARRIVALS, workload=workload_summary(arrivals),
        metrics={k: v for k, v in m.items() if k != "planner"},
        planner=m["planner"], peaks=peaks, fault_free_s=base_s, faults=chaos,
        run_s=run_s, runs_s=runs_s, packs=packs, launches=launches, seconds=sec)
    say(f"fleet: llama3.2-1b's decode plans (buckets {buckets}), "
        f"{n_decode} decode + {n_prefill} prefill shards, "
        f"{FLEET_ARRIVALS} open-loop arrivals {out['workload']}: "
        f"{m['n_served']} served, {m['n_rejected']} rejected, 0 lost, "
        f"{m['ticks']} ticks, {m['tok_per_tick']} tok/tick, p50 / p99 "
        f"{m['p50_ticks']} / {m['p99_ticks']} ticks, {m['handoffs']} "
        f"handoffs, {m['migrations']} migrations, {m['preemptions']} "
        f"preemptions, {m['requeues']} requeues, shard budget "
        f"{m['shard_budget_bytes']} B, peaks {peaks} of it by shard (the "
        f"last the prefill lane) ({base_s:.2f} s on the host, beside "
        f"the others); {FLEET_FAULT_SEEDS} fault scripts (rate "
        f"{FLEET_FAULT_RATE} a "
        f"tick and shard over {FLEET_FAULT_TICKS} ticks; all {len(runs) + 1} "
        f"runs, a process each"
        + (f" ({FLEET_WORKERS} at a time, beside the train phase's CLI "
           f"block)" if pending is not None else "")
        + f", in {runs_s:.2f} s): each lost nothing, "
        f"stayed in "
        f"budget, tokens equal to the fault-free run's: {chaos}; each "
        f"bucket's record packed and read back on the card bit-equal "
        f"(guards untouched, packed bytes = resident extent): {packs}; "
        f"launches {launches}; phase {sec:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 9, Griffin: the RG-LRU backward, the flash backward at (256, 256)
# with a window, and recurrentgemma-2b training at full width
# ---------------------------------------------------------------------------

GRIFFIN = "recurrentgemma-2b"
# the RG-LRU backward against its plain version (rglru_backward_torch) on
# the card at Griffin's width: (B, T) at the training shape, a long prefill
# and a short ragged one; gx f32 and bf16, with and without h0 (and dhT
# with it).  Where torch's exp on the card is CUDA's expf the kernel gives
# the plain version's bits; elsewhere each gradient within RG_BWD_RTOL of
# its largest magnitude (the share of bit-equal cases is printed)
RG_BWD_D = 2560
RG_BWD_CASES = ((8, 256), (1, 4096), (2, 7))
RG_BWD_RTOL = 1e-5
# the broken control: the backward with G = g in place of G = a g (the
# a_{t+1} factor dropped) in block 0, its first CHANNELS (32) channels of
# batch row 0
RGLRU_CONTROL_EDIT = ("G = __fmul_rn(a, g);",
                      "G = blockIdx.x == 0 ? g : __fmul_rn(a, g);")
# the flash backward at Griffin's heads (H 10, KV 1, D 256): (B, S, window)
# at the training shape, a long sequence where the window bites, and two
# windows that bite at S 256
GRIFFIN_HEADS = dict(H=10, KV=1, D=256)
GRIFFIN_BWD_CASES = ((8, 256, 2048), (1, 4096, 2048), (2, 256, 64),
                     (2, 256, 100))
# the cases whose control (each kernel with the window one key too wide)
# must read above the limit: one key more in 64 or 100 moves every row's
# softmax; at S 4096 one more in 2048 reads inside bf16's rounding (2.79
# ulps on an H100 80GB HBM3 at 700 W), so it is printed, not held
GRIFFIN_CONTROL_CASES = ((2, 256, 64), (2, 256, 100))


def build_rglru_control() -> Path:
    """A copy of ``csrc/rglru.cu`` with RGLRU_CONTROL_EDIT, built by the
    repository's flags into a library of its own."""
    from repro_torch.kernels import _build
    text = (SRC / "repro_torch" / "csrc" / "rglru.cu").read_text()
    old, new = RGLRU_CONTROL_EDIT
    check(text.count(old) == 1, f"the RG-LRU control's edit {old!r} is not "
                                f"in csrc/rglru.cu once")
    src = ROOT / "build" / "chip_smoke_controls" / "rglru_control.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(old, new))
    return _build.build(src, "rglru_control")


def rglru_control_fn(lib_path):
    """The control library's backward, called as ``rglru_backward_cuda``
    is (no launch counted)."""
    lib = ctypes.CDLL(str(lib_path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for sfx in ("bf16", "f32"):
        fn = getattr(lib, f"repro_rglru_backward_{sfx}")
        fn.argtypes = [vp] * 8 + [ll, ll, ll, vp]
        fn.restype = ctypes.c_int

    def run(log_a, gx, h0, dh, dhT=None):
        B, T, D = gx.shape
        dla, dgx = torch.empty_like(log_a), torch.empty_like(gx)
        dh0 = torch.empty((B, D), dtype=torch.float32, device=gx.device)
        sfx = "bf16" if gx.dtype == torch.bfloat16 else "f32"
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = getattr(lib, f"repro_rglru_backward_{sfx}")(
            log_a.data_ptr(), gx.data_ptr(), ptr(h0), dh.data_ptr(),
            ptr(dhT), dla.data_ptr(), dgx.data_ptr(), dh0.data_ptr(), B, T,
            D, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the RG-LRU control's launch failed ({err})")
        return dla, dgx, (None if h0 is None else dh0)

    return run


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (f32)."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def rglru_bwd_inputs(dev, B, T, dtype, with_h0, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = RG_BWD_D
    la = -0.5 * torch.exp(torch.randn(B, T, D, device=dev, generator=gen))
    gx = torch.randn(B, T, D, device=dev, generator=gen).to(dtype)
    dh = torch.randn(B, T, D, device=dev, generator=gen).to(dtype)
    h0 = dhT = None
    if with_h0:
        h0 = torch.randn(B, D, device=dev, generator=gen)
        dhT = torch.randn(B, D, device=dev, generator=gen)
    return la, gx, h0, dh, dhT


def check_rglru_backward(dev, control) -> dict:
    """The RG-LRU backward kernel (``rglru_backward_cuda``) against its
    plain version on the card, every case of RG_BWD_CASES x gx f32 / bf16
    x h0 (and dhT) or none: dtypes and shapes, each gradient within
    RG_BWD_RTOL of its largest (bit-equal ones counted), a second run
    bit-equal to the first; then the broken control, which must read above
    RG_BWD_RTOL in block 0's channels only.  Returns the readings."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_backward_torch
    worst, worst_abs, n, n_equal = 0.0, 0.0, 0, 0
    for B, T in RG_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                args = rglru_bwd_inputs(dev, B, T, dtype, with_h0,
                                        SEED + 7 * T + B)
                got = RK.rglru_backward_cuda(*args)
                again = RK.rglru_backward_cuda(*args)
                want = rglru_backward_torch(*args)
                torch.cuda.synchronize()
                what = f"rglru_backward ({dtype}, B {B}, T {T}, h0 {with_h0})"
                equal = True
                for name, g, w, a in zip(("dlog_a", "dgx", "dh0"), got, want,
                                         again):
                    if w is None:
                        check(g is None and a is None, f"{what}: {name}")
                        continue
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"{what}: {name} {g.dtype} {tuple(g.shape)}")
                    check(torch.equal(g, a), f"{what}: {name}: two runs "
                                             f"differ")
                    e = rel_err(g, w)
                    check(e <= RG_BWD_RTOL, f"{what}: {name} {e:.3e} of its "
                                            f"largest > {RG_BWD_RTOL}")
                    worst = max(worst, e)
                    worst_abs = max(worst_abs, float(
                        (g.float() - w.float()).abs().max()))
                    equal &= bool(torch.equal(g, w))
                n += 1
                n_equal += int(equal)
    # the control at the training shape: block 0's channels only
    B, T = RG_BWD_CASES[0]
    args = rglru_bwd_inputs(dev, B, T, torch.bfloat16, False, SEED + 1)
    want = rglru_backward_torch(*args)
    bad = control(*args)
    torch.cuda.synchronize()
    ctl = max(rel_err(g, w) for g, w in zip(bad[:2], want[:2]))
    rest = max(rel_err(g.reshape(-1, RG_BWD_D)[:, RK.CHANNELS:],
                       w.reshape(-1, RG_BWD_D)[:, RK.CHANNELS:])
               for g, w in zip(bad[:2], want[:2]))
    check(ctl > RG_BWD_RTOL, f"the RG-LRU control (a_(t+1) dropped in one "
                             f"block) reads {ctl:.3e}, within {RG_BWD_RTOL}")
    say(f"train: rglru_backward vs rglru_backward_torch at D {RG_BWD_D}, "
        f"(B, T) in {RG_BWD_CASES}, gx f32 / bf16, with and without h0 and "
        f"dhT: worst {worst:.3e} of each gradient's largest (limit "
        f"{RG_BWD_RTOL}), {n_equal} of {n} cases bit-equal, two runs "
        f"bit-equal; the control (a_(t+1) dropped in block 0) reads "
        f"{ctl:.3e}, its other blocks {rest:.3e}")
    return dict(worst_rel=worst, max_abs_err=worst_abs,
                bit_equal_cases=n_equal, cases=n, control_rel=ctl,
                control_rest_rel=rest)


def bwd_reading(g, w, dtype) -> float:
    """A gradient's error in the check's unit: a share of the largest
    magnitude (f32, limit BWD_RTOL32) or bf16 ulps of it (limit
    BWD_ULPS16)."""
    e = float((g.float() - w.float()).abs().max())
    lim = BWD_RTOL32 if dtype == torch.float32 else BWD_ULPS16
    return e / bwd_tol(w, dtype) * lim


def check_flash_backward_cases(dev, label, cases, control, control_said,
                               held, functions) -> dict:
    """Both flash backward kernels at each ``(heads, B, S, window)`` of
    ``cases`` (``heads`` and S as ``attn_form`` reads them: H, KV, D and
    optionally Dv, the mask and the softmax scale; S or (Sq, Skv)), bf16
    and f32: the forward's o (routed, with the window) against
    ``_flash_torch``, then dq, dk, dv against
    ``flash_attention_backward_torch`` (f32 within BWD_RTOL32 of each
    gradient's largest, bf16 within BWD_ULPS16 ulps of it): the
    tensor-core kernel in bf16 (two runs bit-equal), the CUDA-core kernel
    in both.  ``control(kname, fn, args, window, S, got)`` gives a broken
    output of a case's kernel (None: none; ``args`` q, k, v, o, dO and the
    case's keywords, ``S`` as the case gives it), read against the plain
    version; it must read above the limit wherever ``held(key)``.  Then
    ``FlashAttentionFn`` against autograd of the plain forward at each
    ``(heads, B, S, window, dtype)`` of ``functions``.  Returns the
    readings."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_backward_torch,
    )
    worst = {"forward": 0.0, "sm90_bf16_ulps": 0.0, "simple_bf16_ulps": 0.0,
             "simple_f32_rel": 0.0, "function_f32_rel": 0.0,
             "function_bf16_ulps": 0.0, "max_abs_err": 0.0}
    controls = {}
    for hd, B, S, w in cases:
        heads, Sq, Skv, kw = attn_form(hd, S)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = attn_inputs(dev, B, Sq, dtype,
                                      SEED + Sq + Skv + (w or 0), Skv=Skv,
                                      **heads)
            what = (f"H {hd['H']}, KV {hd['KV']}, ({B}, {S}, {w}"
                    + ("" if kw["causal"] else ", non-causal") + ")")
            o = FK.flash_attention_cuda(q, k, v, window=w, q_start=0,
                                        kv_len=Skv, **kw)
            e, ok = fa_err(o, flash_attention(q, k, v, window=w,
                                              impl="torch", **kw))
            check(ok, f"flash forward ({what}, {dtype}): max abs err {e}")
            worst["forward"] = max(worst["forward"], e)
            want = flash_attention_backward_torch(q, k, v, o, do, window=w,
                                                  **kw)
            kernels = {"simple": FK.flash_backward_simple_cuda}
            if dtype == torch.bfloat16:
                kernels["sm90"] = FK.flash_backward_sm90_cuda
            tag = "f32_rel" if dtype == torch.float32 else "bf16_ulps"
            lim = BWD_RTOL32 if dtype == torch.float32 else BWD_ULPS16
            for kname, fn in kernels.items():
                got = fn(q, k, v, o, do, window=w, **kw)
                torch.cuda.synchronize()
                for name, g, ww in zip(("dq", "dk", "dv"), got, want):
                    check(g.dtype == ww.dtype and g.shape == ww.shape,
                          f"flash_backward {name}: {g.dtype}")
                    r = bwd_reading(g, ww, dtype)
                    check(r <= lim, f"flash_backward ({kname}) {name} ("
                                    f"{what}, {dtype}): {r:.3e} > {lim}")
                    worst[f"{kname}_{tag}"] = max(worst[f"{kname}_{tag}"], r)
                    worst["max_abs_err"] = max(
                        worst["max_abs_err"],
                        float((g.float() - ww.float()).abs().max()))
                if kname == "sm90":
                    again = fn(q, k, v, o, do, window=w, **kw)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"flash_backward (sm90) ({what}): two runs differ")
                bad = control(kname, fn, (q, k, v, o, do, kw), w, S, got)
                if bad is not None:
                    torch.cuda.synchronize()
                    controls[f"{kname} {dtype} {what}"] = max(
                        bwd_reading(g, ww, dtype) for g, ww in zip(bad, want))
            del q, k, v, do, o, want
    for key, r in controls.items():
        lim = BWD_RTOL32 if "float32" in key else BWD_ULPS16
        check(r > lim or not held(key),
              f"flash_backward control {key} ({control_said}) reads "
              f"{r:.3e}, within {lim}")
    for hd, B, S, w, dtype in functions:
        heads, Sq, Skv, kw = attn_form(hd, S)
        q, k, v, do = attn_inputs(dev, B, Sq, dtype, SEED + 2, Skv=Skv,
                                  **heads)
        for x in (q, k, v):
            x.requires_grad_(True)
        o = flash_attention(q, k, v, window=w, **kw)
        check(o.grad_fn is not None and "FlashAttentionFn" in
              type(o.grad_fn).__name__, f"flash_attention under autograd "
                                        f"(window {w}, {kw}): grad_fn "
                                        f"{o.grad_fn}")
        got = torch.autograd.grad(o, (q, k, v), do)
        ref = flash_attention(q, k, v, window=w, impl="torch", **kw)
        want = torch.autograd.grad(ref, (q, k, v), do)
        key = "function_" + ("f32_rel" if dtype == torch.float32
                             else "bf16_ulps")
        lim = BWD_RTOL32 if dtype == torch.float32 else BWD_ULPS16
        for name, g, ww in zip(("dq", "dk", "dv"), got, want):
            r = bwd_reading(g, ww, dtype)
            worst[key] = max(worst[key], r)
            check(r <= lim, f"FlashAttentionFn {name} (H {hd['H']}, B {B}, "
                            f"S {S}, window {w}, {dtype}) vs autograd: "
                            f"{r:.3e} > {lim}")
    say(f"train: flash backward at {label}, {len(cases)} cases (heads, B, "
        f"S, window): o max abs err {worst['forward']:.3e}; the tensor-core "
        f"kernel {worst['sm90_bf16_ulps']:.2f} bf16 ulps of each gradient's "
        f"largest (limit {BWD_ULPS16}; two runs bit-equal), the CUDA-core "
        f"kernel {worst['simple_bf16_ulps']:.2f} ulps in bf16 and "
        f"{worst['simple_f32_rel']:.3e} of the largest in f32 (limit "
        f"{BWD_RTOL32}); {control_said} reads "
        + ", ".join(f"{k} {r:.3g}" for k, r in controls.items())
        + f"; FlashAttentionFn vs autograd: f32 "
        f"{worst['function_f32_rel']:.3e}, bf16 "
        f"{worst['function_bf16_ulps']:.2f} ulps")
    return dict(worst, controls=controls, cases=len(cases))


def check_flash_backward_griffin(dev) -> dict:
    """``check_flash_backward_cases`` at Griffin's heads (H 10, KV 1, (256,
    256)), every case of GRIFFIN_BWD_CASES (a window each).  The control:
    each kernel with the window one key too wide, read wherever the window
    bites, must read above the limit in GRIFFIN_CONTROL_CASES.
    ``FlashAttentionFn`` with a window: f32 at (2, 256, 64), bf16 at (8,
    256, 100)."""
    hd = GRIFFIN_HEADS
    return check_flash_backward_cases(
        dev, "Griffin's heads (H 10, KV 1, D 256)",
        [(hd, B, S, w) for B, S, w in GRIFFIN_BWD_CASES],
        lambda kname, fn, args, w, S, got: (fn(*args[:5], window=w + 1)
                                            if w < S else None),
        "the window one key too wide",
        lambda key: any(str(c) in key for c in GRIFFIN_CONTROL_CASES),
        [(hd, 2, 256, 64, torch.float32), (hd, 8, 256, 100, torch.bfloat16)])


# recurrentgemma-2b at full width: the gradient through the kernels against
# impl="torch", leaf by leaf (the tail's two blocks too), each stacked leaf
# layer by layer (relative L2), within GRIFFIN_GRAD_RTOL.  Two broken
# controls must read above it: the RG-LRU backward with a_(t+1) dropped in
# one block of channels (the control library) in its first launch alone
# (the last recurrent layer's), and the first attention backward's dK
# zeroed (the last attention layer's).  Readings on an H100 over seeds 0-2
# (tools/griffin_train_probe.py grads, H100 80GB HBM3 at 700 W): sound
# 1.597e-2-1.720e-2 (attention projections; the recurrent blocks' leaves
# 1.339e-2-1.359e-2), the RG-LRU control 0.225-0.669 (in its own layer's
# leaves), dK zeroed 1.0
GRIFFIN_GRAD_RTOL = 3e-2
# the CLI's run: GRIFFIN_STEPS steps at its defaults at published width, the
# depth cut to GRIFFIN_CLI_LAYERS (one group: rec, rec, attn), a checkpoint
# at GRIFFIN_CKPT_EVERY (9.1 GB: bf16 parameters and f32 AdamW moments; the
# run and its replay write three, 27.4 GB, beside llama's 11.5: the card's
# machine allows a call 45 GiB of disk writes); the replay resumes there
GRIFFIN_STEPS, GRIFFIN_CKPT_EVERY, GRIFFIN_CLI_LAYERS = 3, 2, 3


def griffin_stacked(path, w) -> bool:
    """Whether a Griffin leaf is stacked by layer: the groups' rec and attn
    stacks."""
    return path.startswith("/groups/") and w.dim() >= 2


def griffin_controls(control):
    """Griffin's gradient controls: the RG-LRU backward's control library
    (``control``) in the first launch (the last recurrent layer's), the
    first attention backward's dK zeroed (the last attention layer's)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    return (("rglru", RK, "rglru_backward_cuda", control),
            ("dk", FK, "flash_backward_cuda", None))


def griffin_routes(want):
    """A Griffin step's routes and those it must take: every attention
    backward on the tensor-core kernel, every RG-LRU forward staged."""
    from repro_torch.kernels.rglru import kernel as RK
    got = dict(backward_routes(), staged=RK.ROUTES["staged"],
               step=RK.ROUTES["step"])
    return got, {"sm90": want["flash_backward"], "simple": 0,
                 "staged": want["rglru"], "step": 0}


# recurrentgemma-2b's training (``family_train``): all 26 layers
GRIFFIN_TRAIN = dict(
    arch=GRIFFIN, layers=None, rtol=GRIFFIN_GRAD_RTOL,
    group=("rec", "/rec/", "the recurrent blocks'"),
    controls=griffin_controls,
    controls_said="rglru: a_(t+1) dropped in one block of the last "
                  "recurrent layer's backward, dk: the last attention "
                  "layer's dK zeroed",
    steps=GRIFFIN_STEPS, ckpt_every=GRIFFIN_CKPT_EVERY,
    cli_layers=GRIFFIN_CLI_LAYERS, stacked=griffin_stacked,
    routes=griffin_routes)


def family_inputs(fam, dev, seed, layers=None):
    """``fam["arch"]`` at published width, cut to ``layers`` (default
    ``fam["layers"]``; None: all): the model, its parameters from ``seed``
    with the recurrent mixing leaves filled (``live_leaves``), and the
    CLI's first batch (8 x 256; the encoder-decoder's frames as many)."""
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.models.zoo import build_model
    cfg = configs.get(fam["arch"])
    layers = fam["layers"] if layers is None else layers
    if layers is not None:
        cfg = configs.cut_depth(cfg, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    live_leaves(cfg, params, dev)
    pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    return model, params, batch


def grad_batch(fam, batch, dev, seed) -> dict:
    """The gradient check's batch: ``batch``, with the encoder-decoder's
    frames (where ``fam`` names ``grad_frames``) redrawn from ``seed`` at
    that many rows, so that its cross-attention runs with Sq != Skv (the
    timed step keeps the pipeline's batch)."""
    n = fam.get("grad_frames")
    if n is None:
        return batch
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, _, d = batch["frames"].shape
    return dict(batch, frames=torch.randn(B, n, d, device=dev,
                                          generator=gen))


def family_grad_compare(fam, model, params, batch, control) -> dict:
    """The gradient through the kernels against the plain versions', and
    the same reading of each of ``fam["controls"](control)``: (name, the
    kernel's module, its wrapper, a broken call or None for the wrapper's
    second output (dk) zeroed), each breaking the first launch alone (a
    broken call that returns None leaves that launch to the kernel and
    breaks a later one; every control must break one).  Each reading is ``worst_grad_err``'s (stacked leaves by
    layer) over all leaves and over ``fam["group"]``'s.  For an MoE the
    plain run's expert ids are recorded and forced on each run through the
    kernels (``RouteLog(..., own_gates=True)``: the gates from that run's
    own router, whose gradient flows), its flips and their largest top-K
    margin recorded (``routing``).  Launches here are outside the counted
    runs."""
    paths = leaf_paths(params)
    L = model.cfg.n_layers
    groups = {"all": [True] * len(paths),
              fam["group"][0]: [fam["group"][1] in p for p in paths]}

    def err(g, w):
        out = {}
        for name, keep in groups.items():
            sel = [i for i, k in enumerate(keep) if k]
            out[name] = worst_grad_err([g[i] for i in sel],
                                       [w[i] for i in sel],
                                       [paths[i] for i in sel], L,
                                       stacked=fam["stacked"])
        return out

    moe = has_moe_layers(model.cfg)
    with _routed(moe) as plain_log:
        loss_p, want = loss_grads(model, params, batch, "torch")
    norm_p = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in want)))

    def routed():
        return _routed(moe, plain_log.routes if moe else None, True)

    with routed() as log:
        loss_k, got = loss_grads(model, params, batch, "auto")
    routing = None
    if moe:
        check(len(log.routes) == len(plain_log.routes),
              f"the kernels' run dispatched {len(log.routes)} times, the "
              f"plain run {len(plain_log.routes)}")
        routing = log.summary()
    readings = {"sound": err(got, want)}
    del got
    for name, mod, attr, lib in fam["controls"](control):
        kernel, broke = getattr(mod, attr), []

        def broken(*a, kernel=kernel, lib=lib, broke=broke, **kw):
            if broke:
                return kernel(*a, **kw)
            if lib is not None:
                out = lib(*a, **kw)
            else:
                out = kernel(*a, **kw)
                out[1].zero_()
            if out is None:
                return kernel(*a, **kw)
            broke.append(1)
            return out

        setattr(mod, attr, broken)
        try:
            with routed():
                _, bad = loss_grads(model, params, batch, "auto")
        finally:
            setattr(mod, attr, kernel)
        check(bool(broke), f"{fam['arch']}'s {name} control broke no "
                           f"launch")
        readings[name] = err(bad, want)
        del bad
    return dict(readings=readings, n_leaves=len(paths), layers=L,
                loss_kernels=float(loss_k), loss_plain=float(loss_p),
                grad_norm_plain=norm_p, routing=routing)


def check_family_grads(fam, rec: dict):
    """Holds ``family_grad_compare``'s readings over all leaves to
    ``fam["rtol"]``: the sound gradient within it, each control above
    it."""
    r, arch, rtol = rec["readings"], fam["arch"], fam["rtol"]
    group, names = fam["group"][0], [n for n in r if n != "sound"]
    say(f"train: {arch} at published width, {rec['layers']} layers: the "
        f"gradient through the kernels vs the plain versions, "
        f"{rec['n_leaves']} leaves (stacked ones by layer), worst relative "
        f"L2 error over all leaves / {fam['group'][2]} (limit {rtol} over "
        f"all): " + "; ".join(f"{name} " + " / ".join(
            f"{r[name][g][0]:.3e} at {r[name][g][1]}" for g in ("all", group))
                              for name in ["sound"] + names)
        + f" ({fam['controls_said']}); loss {rec['loss_kernels']} vs "
          f"{rec['loss_plain']}"
        + ("" if rec["routing"] is None else
           f"; the kernels' runs routed as the plain run (expert ids "
           f"forced, gates their own): {rec['routing']['flips']} of "
           f"{rec['routing']['routed']} routed (token, layer) pairs "
           f"flipped, the largest flip's top-K margin "
           f"{rec['routing']['max_flip_margin']:.3e}"))
    got, at = r["sound"]["all"]
    check(got <= rtol, f"{arch}'s gradient through the kernels is {got} (at "
                       f"{at}) from the plain versions', above {rtol}")
    for name in names:
        got, at = r[name]["all"]
        check(got > rtol, f"{arch}'s {name} control reads {got} (at {at}), "
                          f"within {rtol}: the gradient check cannot see it")


def family_train(fam, dev, card, control) -> dict:
    """``fam["arch"]`` trains on the card at published width, cut to
    ``fam["layers"]``: the gradient against the plain versions with its
    controls (``family_grad_compare``, ``control`` the kernel's control
    library); one train step through the kernels (its loss and grad_norm
    against the plain step's, which are the plain versions' loss and
    gradient norm of the gradient check, taken before the step's clip and
    update; its launches exactly ``train_launches``, its routes, where
    ``fam["routes"]`` names them, those required); ms a step, tokens/s,
    idle share and peak memory (``time_train_step``); then
    ``launch/train.py``'s ``main`` for ``fam["steps"]`` steps at published
    width, ``fam["cli_layers"]`` deep, and a bit-equal resume
    (``cli_run_and_replay``).  Returns its record."""
    import repro_torch.configs as configs
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.params import tree_leaves
    arch = fam["arch"]
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    gc.collect()
    torch.cuda.empty_cache()
    model, params, batch = family_inputs(fam, dev, SEED)
    cfg = model.cfg
    part("set-up")
    checked = grad_batch(fam, batch, dev, SEED)
    rec = family_grad_compare(fam, model, params, checked, control)
    check_family_grads(fam, rec)
    part("gradient and controls")
    # the plain step's metrics: its loss and the global norm of its
    # gradient come before its clip and update, so they are the plain
    # loss_grads' of the gradient check (the norm summed as the step sums
    # it: each leaf's squares in f32, in leaf order), or of the step's own
    # batch where the check took another
    ref = {"loss": rec["loss_plain"], "grad_norm": rec["grad_norm_plain"],
           "lr": 0.0}
    del checked
    if fam.get("grad_frames") is not None:
        with _routed(has_moe_layers(cfg)):
            loss_p, want = loss_grads(model, params, batch, "torch")
        ref.update(loss=float(loss_p), grad_norm=float(torch.sqrt(
            sum(torch.sum(torch.square(g.float())) for g in want))))
        del want
        part("the plain step's batch")
    gc.collect()
    torch.cuda.empty_cache()
    opt = make_optimizer(cfg, lr=3e-4)
    kw = dict(peak_lr=3e-4, warmup=10, total_steps=fam["steps"])
    state = {"params": params, "opt": opt.init(params)}
    reset_all()
    state, m_k = make_train_step(model, opt, impl="auto", **kw)(state, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    want = train_launches(cfg)
    check(launches == want, f"one {arch} train step launched {launches}, "
                            f"the train path needs {want}")
    said = ""
    if fam["routes"] is not None:
        routes, want_routes = fam["routes"](want)
        check(routes == want_routes, f"one {arch} train step's routes "
                                     f"{routes}, not {want_routes}")
        rec["step_routes"] = routes
        said = f" (routes {routes})"
    got = {k: float(m_k[k]) for k in ("loss", "grad_norm", "lr")}
    check(all(np.isfinite(list(got.values()))), f"train step metrics {got}")
    check(abs(got["loss"] - ref["loss"]) <= TRAIN_ATOL
          and abs(got["grad_norm"] - ref["grad_norm"])
          <= TRAIN_ATOL * ref["grad_norm"],
          f"{arch} train step through the kernels {got} vs the plain step "
          f"{ref} (loss atol {TRAIN_ATOL}, grad_norm rtol {TRAIN_ATOL})")
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    say(f"train: {arch} at published width, {cfg.n_layers} of "
        f"{configs.get(arch).n_layers} layers ({n} parameters, bf16), batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: one step through the kernels "
        f"{got} vs the plain step {ref}; its launches {launches}{said} "
        f"[{card}]")
    part("a step")
    rec.update(loss=got["loss"], loss_plain_step=ref["loss"],
               grad_norm=got["grad_norm"],
               grad_norm_plain_step=ref["grad_norm"],
               step_launches=launches, parameters=n)
    rec["step"] = time_train_step(model, opt, state, batch, card,
                                  fam.get("timed_steps", TIMED_STEPS))
    say(f"train: {arch} at {cfg.n_layers} layers peaked at "
        f"{rec['step']['peak_allocated']} B allocated, "
        f"{rec['step']['peak_reserved']} B reserved, of the card's "
        f"{torch.cuda.get_device_properties(dev).total_memory} B [{card}]")
    part("timed steps")
    del state, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    if CLI_QUEUE is None:
        rec["cli"] = family_cli(fam, dev, card)
        part("CLI and resume")
    else:                # the train phase's CLI block runs it
        CLI_QUEUE.append((fam, rec))
    rec["seconds"] = time.perf_counter() - t0
    rec["parts_s"] = parts
    say(f"train: {arch} done in {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]")
    return rec


#: while the train phase gathers the families' CLI runs into one block (run
#: beside the fleet's host runs), ``family_train`` queues its family and
#: record here; None: each family's CLI runs inline
CLI_QUEUE: list | None = None


def family_cli(fam, dev, card) -> dict:
    """``cli_run_and_replay`` at ``fam``'s CLI settings, the card's memory
    released before and after."""
    gc.collect()
    torch.cuda.empty_cache()
    out = cli_run_and_replay(dev, card, arch=fam["arch"], steps=fam["steps"],
                             ckpt_every=fam["ckpt_every"],
                             layers=fam["cli_layers"])
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_names(fn, top: int = 3, tries: int = 3):
    """The ``top`` device kernels by time in a traced call of ``fn``, from
    the first of ``tries`` traces that is not empty (None if all are)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
        if by:
            return sorted(by, key=lambda n: -by[n])[:top]
    return None


def backward_graph_ms(fwd, inputs, grad, dev, reps=10) -> float:
    """ms a call of ``torch.autograd.grad`` of ``fwd(*inputs)``'s output at
    ``grad`` with respect to ``inputs``, as ``graph_ms`` times a kernel:
    CUDA events around ``reps`` replays of one CUDA graph of
    A7_GRAPH_CALLS calls, after two replays.  Copies of the inputs as
    leaves, and the forward, are made once, outside the graph, on the
    stream the graph is captured on: each backward op runs on its forward
    op's stream, and a leaf's on the stream it was made on."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()

    def calls():
        for _ in range(A7_GRAPH_CALLS):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)

    with torch.cuda.stream(stream):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fwd(*leaves)
        calls()
        with torch.cuda.graph(graph, stream=stream):
            calls()
    torch.cuda.current_stream(dev).wait_stream(stream)
    for _ in range(2):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * A7_GRAPH_CALLS)


def time_flash_backward(dev, card, label, B, S, hd, w=None) -> dict:
    """The flash backward at (B, S) and ``hd``'s heads and form
    (``attn_form``: S or (Sq, Skv), causal or not, Dv, the softmax scale),
    bf16, with the window ``w`` (or none): the tensor-core kernel (bf16's
    route) and the CUDA-core one in turns by ``graph_ms`` (CUDA events
    around replays of a CUDA graph of its calls: the device's time, no
    host issue and no trace, which loses events late in this script),
    SDPA's backward of the same function by ``backward_graph_ms`` (causal,
    non-causal, or the window as a boolean mask where it bites; the
    kernels it ran named from a trace), the plain version and SDPA's
    backward again by ``event_us`` (CUDA events around each eager call:
    the host's issue included), beside the bound
    (``costs.flash_backward_cost`` of the form)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_torch,
    )
    ms = lambda fn, reps: event_us(fn, reps) / 1e3  # noqa: E731
    heads, Sq, Skv, kw = attn_form(hd, S)
    q, k, v, do = attn_inputs(dev, B, Sq, torch.bfloat16, SEED + 4, Skv=Skv,
                              **heads)
    o = FK.flash_attention_cuda(q, k, v, window=w, q_start=0, kv_len=Skv,
                                **kw)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    masked = w is not None and w < Sq
    sdpa_kw = (dict(attn_mask=window_mask(Sq, 0, Skv, w, dev)) if masked
               else dict(is_causal=kw["causal"]))

    def sdpa_fwd(qs, ks, vs):
        return F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True, scale=kw["softmax_scale"],
            **sdpa_kw)

    so = sdpa_fwd(qs, ks, vs)
    dos = do.transpose(1, 2)
    fns = {
        "simple": lambda: FK.flash_backward_simple_cuda(q, k, v, o, do,
                                                        window=w, **kw),
        "kernel": lambda: FK.flash_backward_cuda(q, k, v, o, do, window=w,
                                                 **kw),
        "plain": lambda: flash_attention_backward_torch(q, k, v, o, do,
                                                        window=w, **kw),
        "sdpa": lambda: torch.autograd.grad(so, (qs, ks, vs), dos,
                                            retain_graph=True),
    }
    turns = {"simple": [], "kernel": []}
    for i in ("kernel", "simple", "simple", "kernel"):
        turns[i].append(graph_ms(fns[i], (), dev, 10 if i == "kernel" else 1))
    tb = {i: statistics.mean(x) for i, x in turns.items()}
    tb.update(plain=ms(fns["plain"], 3),
              sdpa=backward_graph_ms(sdpa_fwd, (qs, ks, vs), dos, dev),
              sdpa_eager=ms(fns["sdpa"], 10))
    backend = kernel_names(fns["sdpa"])
    flops, nbytes = costs.flash_backward_cost(
        B, Sq, hd["H"], hd["KV"], hd["D"], 2, Skv=Skv, Dv=v.shape[3],
        causal=kw["causal"], window=w)
    bound = (nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3)
    form = ("causal" if kw["causal"] else "non-causal") + (
        "" if Sq == Skv else f", Sq {Sq}, Skv {Skv}")
    out = dict(shape=[B, Sq, Skv, hd["H"], hd["KV"], hd["D"], v.shape[3],
                      w, kw["causal"]], ms=tb["kernel"],
               simple_ms=tb["simple"], turns_ms=turns, plain_ms=tb["plain"],
               library_ms=tb["sdpa"], sdpa_kernels=backend,
               library_eager_ms=tb["sdpa_eager"], bound_ms=max(bound),
               bound_by="bytes" if bound[0] >= bound[1] else "operations")
    say(f"timing: flash backward at {label} (B {B}, S {S}, H {hd['H']}, KV "
        f"{hd['KV']}, (D, Dv) ({hd['D']}, {v.shape[3]}), {form}, window {w},"
        f" bf16), us per call in a replayed graph: tensor-core kernel "
        f"{tb['kernel'] * 1e3:.2f} (in turns "
        f"{turns['kernel'][0] * 1e3:.2f}, "
        f"{turns['kernel'][1] * 1e3:.2f}), CUDA-core kernel "
        f"{tb['simple'] * 1e3:.2f}, bound {max(bound) * 1e3:.3f} "
        f"({out['bound_by']}; {nbytes} bytes {bound[0] * 1e3:.3f}, {flops} "
        f"operations {bound[1] * 1e3:.3f}), SDPA's backward "
        f"{tb['sdpa'] * 1e3:.2f} ({'boolean mask' if masked else form};"
        f" its kernels {[n[:60] for n in backend or []]}); eager, CUDA "
        f"events: plain {tb['plain'] * 1e3:.2f}, SDPA's backward "
        f"{tb['sdpa_eager'] * 1e3:.2f} [{card}]")
    return out


def time_griffin_kernels(dev, card) -> dict:
    """The new backward kernels at Griffin's training shapes, bf16: the
    RG-LRU backward at (B 8, T 256, D 2560) by ``graph_ms`` beside its
    bound and plain version (``event_us``; no torch call computes it); the
    flash backward (``time_flash_backward``) at (B 8, S 256, window 2048:
    the window does not bite) and (B 1, S 4096, window 2048)."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_backward_torch
    out = {}
    B, T = RG_BWD_CASES[0]
    args = rglru_bwd_inputs(dev, B, T, torch.bfloat16, False, SEED + 3)
    t = {"kernel": graph_ms(lambda: RK.rglru_backward_cuda(*args), (), dev,
                            10),
         "plain": event_us(lambda: rglru_backward_torch(*args), 3) / 1e3}
    flops, nbytes = costs.rglru_backward_cost(B, T, RG_BWD_D, 2)
    bound = (nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3)
    out["rglru_backward"] = dict(
        shape=[B, T, RG_BWD_D], ms=t["kernel"], plain_ms=t["plain"],
        library_ms=None, bound_ms=max(bound),
        bound_by="bytes" if bound[0] >= bound[1] else "operations")
    say(f"timing: rglru_backward at (B {B}, T {T}, D {RG_BWD_D}, bf16): us "
        f"per call in a replayed graph {t['kernel'] * 1e3:.2f}, bound "
        f"{max(bound) * 1e3:.3f} (bytes {bound[0] * 1e3:.3f}, operations "
        f"{bound[1] * 1e3:.3f}), plain {t['plain'] * 1e3:.2f} (eager, CUDA "
        f"events), no torch call [{card}]")
    for B, S, w in GRIFFIN_BWD_CASES[:2]:
        out[f"{B}x{S}"] = time_flash_backward(dev, card, "Griffin's heads",
                                              B, S, GRIFFIN_HEADS, w)
    return out


# ---------------------------------------------------------------------------
# Phase 9, RWKV-6: the WKV-6 backward and rwkv6-7b training at published
# width, its depth cut
# ---------------------------------------------------------------------------

RWKV = "rwkv6-7b"
# the WKV-6 backward against its plain version (wkv6_backward_torch) on the
# card at rwkv6-7b's heads (H 64, N 64): (B, T) at the training shape, a
# long prefill and a short ragged one; inputs f32 and bf16, with and
# without s0 (and dsT with it); w = exp(-exp(omega)), omega ~ U(-12, 6), so
# that some w round to 0 and some to 1 in bf16.  f32 within WKV_BWD_RTOL of
# each gradient's largest magnitude, bf16 within one bf16 ulp of each
# element plus WKV_BWD_RTOL of the largest (both round one f32 sum, taken
# in another order)
WKV_BWD_HEADS = dict(H=64, N=64)
WKV_BWD_CASES = ((8, 256), (1, 1024), (2, 7))
WKV_BWD_RTOL = 1e-5
# the broken control: the adjoint's update without its w_t factor (G <- G +
# r do^T) in one (batch row, head), batch row 0's last head (cluster bh = H
# - 1, both its blocks: the head of the fastest decays, where live_leaves'
# w0 runs to -1)
WKV6_CONTROL_EDIT = (
    "G[q] = __fmaf_rn(ww, G[q], __fmul_rn(rr, dq[q]));",
    "G[q] = __fmaf_rn(bh == H - 1 ? 1.f : ww, G[q], __fmul_rn(rr, dq[q]));")
# rwkv6-7b at published width (d_model 4096, 64 heads of 64, d_ff 14336,
# vocab 65536), the depth cut to RWKV_LAYERS of 32: all 32 layers hold 7.53
# B parameters, ~90 GB under bf16 AdamW (12 B a parameter), beyond the
# card.  A step's allocated peak on an H100 80GB HBM3 (tools/
# rwkv6_train_probe.py step): 65.9 GB at 16 layers, 69.6 at 17, 73.4 at
# 18, out of memory at 19.  In this script 17 layers peaked at 70.7 GB
# allocated but 82.2 GB reserved of the 85.0e9 B the card reports, 2.8 GB
# to spare on a machine whose allocator may split blocks otherwise; 16
# keeps the margin (both peaks in PERF.md section 5)
RWKV_LAYERS = 16
# its gradient through the kernels against impl="torch", leaf by leaf,
# stacked leaves layer by layer (relative L2), within RWKV_GRAD_RTOL; two
# broken controls must read above it: the control library in the first
# backward launch alone (the last layer's), and the last layer's dk zeroed.
# RWKV-6's bf16 rounding sets the limit: over seeds 0-2 the sound readings
# were 7.69e-2-8.28e-2 at 16 layers (8.17e-2-8.74e-2 at 17; at the token
# shift's mu_x and at u), while at 16 layers each bf16 gradient reads
# 0.339-0.340 from the f32 plain one there, the kernels' and the plain
# versions' alike, and the f32 gradient through the kernels 4.1e-5
# (tools/rwkv6_train_probe.py grads / noise, H100 80GB HBM3 at 700 W); the
# one-head control read 0.174-0.230 at 16 layers, dk zeroed 1.0
RWKV_GRAD_RTOL = 0.12
# the CLI's run at published width, RWKV_CLI_LAYERS deep: RWKV_STEPS steps,
# a checkpoint at RWKV_CKPT_EVERY (9.8 GB at 2 layers: 0.98 B parameters x
# 10 B), the replay resuming there
RWKV_STEPS, RWKV_CKPT_EVERY, RWKV_CLI_LAYERS = 3, 2, 2


def build_wkv6_control() -> Path:
    """A copy of ``csrc/wkv6_backward.cu`` with WKV6_CONTROL_EDIT, built by
    the repository's flags into a library of its own."""
    from repro_torch.kernels import _build
    text = (SRC / "repro_torch" / "csrc" / "wkv6_backward.cu").read_text()
    old, new = WKV6_CONTROL_EDIT
    check(text.count(old) == 1, f"the WKV-6 control's edit {old!r} is not "
                                f"in csrc/wkv6_backward.cu once")
    src = ROOT / "build" / "chip_smoke_controls" / "wkv6_backward_control.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(old, new))
    return _build.build(src, "wkv6_backward_control")


def wkv6_control_fn(lib_path):
    """The backward of another build of ``csrc/wkv6_backward.cu`` (the
    control's), called as ``wkv6_backward_cuda`` is (no launch
    counted)."""
    from repro_torch.kernels.rwkv6 import kernel as WK
    lib = WK.bind_backward(ctypes.CDLL(str(lib_path)))

    def run(r, k, v, w, u, s0, do, dsT=None):
        WK._check_backward(r, k, v, w, u, s0, do, dsT)
        out = WK.backward_launch(lib, r, k, v, w, u, s0, do, dsT)
        return (*out[:5], None if s0 is None else out[5])

    return run


def wkv6_bwd_inputs(dev, B, T, dtype, with_s0, seed):
    """(r, k, v, w, u, s0, do, dsT) at rwkv6-7b's heads."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, N = WKV_BWD_HEADS["H"], WKV_BWD_HEADS["N"]
    r, k, v, do = (torch.randn(B, T, H, N, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    om = torch.empty(B, T, H, N, device=dev).uniform_(-12.0, 6.0,
                                                      generator=gen)
    w = torch.exp(-torch.exp(om)).to(dtype)
    u = torch.randn(H, N, device=dev, generator=gen).to(dtype)
    s0 = dsT = None
    if with_s0:
        s0, dsT = (torch.randn(B, H, N, N, device=dev, generator=gen)
                   for _ in range(2))
    return r, k, v, w, u, s0, do, dsT


def wkv6_bwd_reading(g, w) -> float:
    """A gradient's error in units of its limit: f32 max |g - w| over
    WKV_BWD_RTOL of the largest |w|; bf16 the worst element's |g - w| over
    (one bf16 ulp of it + WKV_BWD_RTOL of the largest).  At most 1 within
    the limit."""
    gf, wf = g.float(), w.float()
    scale = float(wf.abs().max())
    if g.dtype == torch.float32:
        return float((gf - wf).abs().max()) / max(WKV_BWD_RTOL * scale,
                                                   1e-30)
    ulp = torch.where(wf == 0, torch.zeros_like(wf), torch.exp2(
        torch.floor(torch.log2(wf.abs())) - 7))
    return float(((gf - wf).abs() / (ulp + WKV_BWD_RTOL * scale)).max())


def check_wkv6_backward(dev, control) -> dict:
    """The WKV-6 backward kernel (``wkv6_backward_cuda``) against its plain
    version on the card, every case of WKV_BWD_CASES x f32 / bf16 x s0 (and
    dsT) or none: dtypes and shapes, each gradient within its limit
    (``wkv6_bwd_reading`` <= 1) and a second run bit-equal to the first;
    then the broken control, which must read above the limit in the
    gradients it breaks (dk, dv, dw of batch row 0's last head) and nowhere
    else.  Returns the readings."""
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_backward_torch
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    worst = {"f32": 0.0, "bf16": 0.0}
    worst_abs, n = 0.0, 0
    for B, T in WKV_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_s0 in (False, True):
                args = wkv6_bwd_inputs(dev, B, T, dtype, with_s0,
                                       SEED + 11 * T + B)
                got = WK.wkv6_backward_cuda(*args)
                again = WK.wkv6_backward_cuda(*args)
                want = wkv6_backward_torch(*args)
                torch.cuda.synchronize()
                what = (f"wkv6_backward ({dtype}, B {B}, T {T}, s0 "
                        f"{with_s0})")
                for name, g, w, a in zip(names, got, want, again):
                    if w is None:
                        check(g is None and a is None, f"{what}: {name}")
                        continue
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"{what}: {name} {g.dtype} {tuple(g.shape)}")
                    check(torch.equal(g, a), f"{what}: {name}: two runs "
                                             f"differ")
                    e = wkv6_bwd_reading(g, w)
                    check(e <= 1.0, f"{what}: {name} reads {e:.3f} of its "
                                    f"limit")
                    key = "f32" if dtype == torch.float32 else "bf16"
                    worst[key] = max(worst[key], e)
                    worst_abs = max(worst_abs, float(
                        (g.float() - w.float()).abs().max()))
                n += 1
                del args, got, again, want
    # the control at the training shape: batch row 0's last head only
    B, T = WKV_BWD_CASES[0]
    args = wkv6_bwd_inputs(dev, B, T, torch.bfloat16, False, SEED + 1)
    want = wkv6_backward_torch(*args)
    bad = control(*args)
    torch.cuda.synchronize()
    ctl = {name: wkv6_bwd_reading(g[0, :, -1], w[0, :, -1]) for name, g, w
           in zip(names[1:4], bad[1:4], want[1:4])}
    rest = max(wkv6_bwd_reading(g[0, :, :-1], w[0, :, :-1])
               for g, w in zip(bad[:4], want[:4]))
    rest = max([rest] + [wkv6_bwd_reading(g[1:], w[1:])
                         for g, w in zip(bad[:4], want[:4])])
    check(min(ctl.values()) > 1.0 and rest <= 1.0,
          f"the WKV-6 control (w_t dropped from the adjoint in one (batch "
          f"row, head)) "
          f"reads {ctl} of the limit there, {rest:.3f} in the other "
          f"blocks")
    say(f"train: wkv6_backward vs wkv6_backward_torch at H 64, N 64, (B, T) "
        f"in {WKV_BWD_CASES}, f32 / bf16, with and without s0 and dsT: worst "
        f"{worst['f32']:.3f} of the f32 limit ({WKV_BWD_RTOL} of each "
        f"gradient's largest) and {worst['bf16']:.3f} of the bf16 limit (one "
        f"ulp of each element + {WKV_BWD_RTOL} of the largest), max abs "
        f"err {worst_abs:.3e}, two runs bit-equal; the control (w_t dropped in batch row 0's last head) reads "
        + ", ".join(f"{k} {v:.1f}" for k, v in ctl.items())
        + f" of the limit there, the other blocks {rest:.3f}")
    return dict(worst_of_limit=worst, max_abs_err=worst_abs, cases=n,
                control_of_limit=ctl, control_rest_of_limit=rest)


def rwkv_controls(control):
    """RWKV-6's gradient controls: the WKV-6 backward's control library
    (``control``) in the first launch (the last layer's), the first
    launch's dk zeroed."""
    from repro_torch.kernels.rwkv6 import kernel as WK
    return (("wkv6", WK, "wkv6_backward_cuda", control),
            ("dk", WK, "wkv6_backward_cuda", None))


# rwkv6-7b's training (``family_train``): RWKV_LAYERS of its 32 layers
RWKV_TRAIN = dict(
    arch=RWKV, layers=RWKV_LAYERS, rtol=RWKV_GRAD_RTOL,
    group=("tmix", "/tmix/", "the time mix's"), controls=rwkv_controls,
    controls_said="wkv6: w_t dropped from the adjoint in one (batch row, "
                  "head) of the last layer's backward, dk: the last "
                  "layer's dk zeroed",
    steps=RWKV_STEPS, ckpt_every=RWKV_CKPT_EVERY,
    cli_layers=RWKV_CLI_LAYERS, stacked=None, routes=None)


def time_rwkv_kernels(dev, card) -> dict:
    """The WKV-6 backward at rwkv6-7b's training shape (B 8, T 256, H 64,
    N 64, bf16; dsT given, as autograd gives it) by ``graph_ms`` beside its
    bound (``costs.wkv6_backward_cost``) and its plain version by
    ``event_us`` (eager, the host's issue included); no torch call
    computes it."""
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_backward_torch
    B, T = WKV_BWD_CASES[0]
    H, N = WKV_BWD_HEADS["H"], WKV_BWD_HEADS["N"]
    r, k, v, w, u, _, do, _ = wkv6_bwd_inputs(dev, B, T, torch.bfloat16,
                                              False, SEED + 3)
    dsT = torch.zeros(B, H, N, N, device=dev)
    args = (r, k, v, w, u, None, do, dsT)
    t = {"kernel": graph_ms(lambda: WK.wkv6_backward_cuda(*args), (), dev,
                            10),
         "plain": event_us(lambda: wkv6_backward_torch(*args), 3) / 1e3}
    flops, nbytes = costs.wkv6_backward_cost(B, T, H, N, 2, dsT=True)
    bound = (nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3)
    out = dict(shape=[B, T, H, N], ms=t["kernel"], plain_ms=t["plain"],
               library_ms=None, bound_ms=max(bound),
               bound_by="bytes" if bound[0] >= bound[1] else "operations")
    say(f"timing: wkv6_backward at (B {B}, T {T}, H {H}, N {N}, bf16): us "
        f"per call in a replayed graph {t['kernel'] * 1e3:.2f}, bound "
        f"{max(bound) * 1e3:.3f} ({out['bound_by']}; bytes "
        f"{bound[0] * 1e3:.3f}, operations {bound[1] * 1e3:.3f}), plain "
        f"{t['plain'] * 1e3:.2f} (eager, CUDA events), no torch call "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 9, the dense and MoE decoders: the flash backward at (128, 128),
# starcoder2-7b, granite-moe-3b-a800m and gemma-7b trained at published
# width, granite-20b's and chameleon-34b's gradients at 2 layers
# ---------------------------------------------------------------------------

# the heads of the three (128, 128) models: starcoder2-7b 36 query heads
# over 4 KV heads, granite-20b 48 over one, chameleon-34b 64 over 8
D128_HEADS = {"starcoder2-7b": dict(H=36, KV=4, D=128),
              "granite-20b": dict(H=48, KV=1, D=128),
              "chameleon-34b": dict(H=64, KV=8, D=128)}
# both backward kernels at (128, 128) against their plain version at the
# first two models' heads, (B, S) of BWD_CASES (S 256, 200, 17), without a
# window and with D128_WINDOW keys (it bites at S 200 and 256); limits
# BWD_RTOL32 / BWD_ULPS16; the control (KV head 0's dK zeroed in the
# tensor-core kernel's output) must read above the bf16 limit in every
# case
D128_CHECKED = ("starcoder2-7b", "granite-20b")
D128_WINDOW = 100


def kv0_dk_zeroed(kname, fn, args, window, S, got):
    """The (128, 128) control: the tensor-core kernel's output with KV head
    0's dK zeroed (None for the CUDA-core kernel)."""
    if kname != "sm90":
        return None
    dk = got[1].clone()
    dk[:, :, 0] = 0
    return got[0], dk, got[2]


def check_flash_backward_d128(dev) -> dict:
    """``check_flash_backward_cases`` at (128, 128): the heads of each of
    D128_CHECKED, (B, S) of BWD_CASES, no window and D128_WINDOW; the
    control (KV head 0's dK zeroed) above the bf16 limit in every case;
    ``FlashAttentionFn`` at granite-20b's heads (2, 200) with the window in
    f32, at starcoder2-7b's (8, 256) in bf16."""
    return check_flash_backward_cases(
        dev, f"(128, 128), the heads of {' and '.join(D128_CHECKED)}",
        [(D128_HEADS[a], B, S, w) for a in D128_CHECKED
         for B, S in BWD_CASES for w in (None, D128_WINDOW)],
        kv0_dk_zeroed, "KV head 0's dK zeroed", lambda key: True,
        [(D128_HEADS["granite-20b"], 2, 200, D128_WINDOW, torch.float32),
         (D128_HEADS["starcoder2-7b"], TRAIN_BATCH, TRAIN_SEQ, None,
          torch.bfloat16)])


def time_d128_kernels(dev, card) -> dict:
    """The (128, 128) backward (``time_flash_backward``) at each of
    D128_HEADS, B 8 x S 256, no window.  Returns a record per model."""
    return {arch: time_flash_backward(dev, card, f"{arch}'s heads",
                                      TRAIN_BATCH, TRAIN_SEQ, hd)
            for arch, hd in D128_HEADS.items()}


def attn_controls(control):
    """A dense or MoE decoder's gradient control: the first flash
    backward's dK zeroed (the last layer's)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    return (("dk", FK, "flash_backward_cuda", None),)


def sm90_routes(want):
    """A dense or MoE step's backward routes and those it must take: every
    flash backward on the tensor-core kernel."""
    return backward_routes(), {"sm90": want["flash_backward"], "simple": 0}


# The dense and MoE decoders' training (``family_train``) at published
# width, B 8 x S 256 under bf16 AdamW, remat "block": the gradient through
# the kernels against impl="torch", leaf by leaf, stacked leaves layer by
# layer (relative L2) within the family's limit, the last layer's dK zeroed
# above it; one step against the plain step; the CLI at DECODER_CLI_LAYERS
# (checkpoints of bf16 parameters and f32 moments, 10 B a parameter:
# starcoder2-7b 8.9 GB, gemma-7b 13.4 GB with its tied 256000-row
# embedding, granite-moe 3.5 GB; each CLI's removed before the next).
# Depths: AdamW holds 12 B a parameter, and its f32 temporaries of the
# largest stacked leaf come on top (5.06 GiB for starcoder2-7b's MLP at 16
# layers).  A step's peaks on an H100 80GB HBM3 (tools/
# decoder_train_probe.py step; the card reports 85.0e9 B): starcoder2-7b
# 70.5 / 79.8 GB allocated / reserved at 14 layers, 75.2 / 81.1 at 15, out
# of memory at 16; gemma-7b 66.0 / 76.9 at 11, 71.1 / 81.5 at 12, out of
# memory at 14; granite-moe-3b-a800m 64.7 / 71.3 at all 32.  The depths
# keep 5 GB or more to spare.
DECODER_STEPS, DECODER_CKPT_EVERY, DECODER_CLI_LAYERS = 3, 2, 2
STARCODER2_LAYERS = 14
GEMMA_LAYERS = 11
# Limits from the sound readings over seeds 0-2 (tools/
# decoder_train_probe.py grads, H100 80GB HBM3 at 700 W): starcoder2-7b
# 1.70e-2-1.76e-2 (16 layers), gemma-7b 1.60e-2-1.81e-2 (12 layers),
# granite-20b 7.84e-3-7.88e-3 and chameleon-34b 8.75e-3-1.00e-2 (2 layers)
# keep llama's 3e-2; granite-moe-3b-a800m reads 0.181-0.200 with the
# kernels' runs forced to the plain run's expert ids.  That is bf16's
# noise: against the f32 plain gradient (32 layers, seed 0, every run
# forced to its ids) the bf16 kernels read 0.320, the bf16 plain versions
# 0.311, the f32 kernels 4.07e-5 (tools/decoder_train_probe.py noise).  The
# dK-zeroed control read 1.0 in every family
DECODER_GRAD_RTOL = {"starcoder2-7b": 3e-2, "granite-moe-3b-a800m": 0.3,
                     "gemma-7b": 3e-2, "granite-20b": 3e-2,
                     "chameleon-34b": 3e-2}


def decoder_train(arch, layers) -> dict:
    """``family_train``'s dict for a dense or MoE decoder at ``layers`` of
    its layers (None: all)."""
    return dict(
        arch=arch, layers=layers, rtol=DECODER_GRAD_RTOL[arch],
        group=("attn", "/attn/", "the attention's"), controls=attn_controls,
        controls_said="dk: the last layer's dK zeroed",
        steps=DECODER_STEPS, ckpt_every=DECODER_CKPT_EVERY,
        cli_layers=DECODER_CLI_LAYERS, stacked=None, routes=sm90_routes)


STARCODER2_TRAIN = decoder_train("starcoder2-7b", STARCODER2_LAYERS)
MOE_TRAIN = decoder_train(MOE_ARCH, None)
GEMMA_TRAIN = decoder_train("gemma-7b", GEMMA_LAYERS)
DECODER_TRAINS = (STARCODER2_TRAIN, MOE_TRAIN, GEMMA_TRAIN)
# granite-20b (G 48 over one KV head) and chameleon-34b (qk-norm, KV 8) put
# the (128, 128) kernel under the other two layouts: their gradient check
# alone at published width, 2 layers
DECODER_GRADS = tuple(decoder_train(a, 2) for a in ("granite-20b",
                                                    "chameleon-34b"))


def family_grads(fam, dev, card) -> dict:
    """``fam["arch"]``'s gradient check alone (``family_grad_compare`` and
    ``check_family_grads``) at published width, cut to ``fam["layers"]``:
    no step, no CLI.  Returns its record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, params, batch = family_inputs(fam, dev, SEED)
    rec = family_grad_compare(fam, model, params, batch, None)
    check_family_grads(fam, rec)
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    say(f"train: {fam['arch']}'s gradient check at {rec['layers']} layers "
        f"done in {rec['seconds']:.1f} s [{card}]")
    return rec


def decoders_train(dev, card) -> dict:
    """Phase 9's dense and MoE decoders: the (128, 128) backward's checks,
    each of DECODER_TRAINS through ``family_train``, each of DECODER_GRADS
    through ``family_grads``, the (128, 128) backward's times.  Returns the
    block's record, its seconds by part."""
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    rec = {"d128_checks": check_flash_backward_d128(dev)}
    part("the (128, 128) backward's checks")
    for fam in DECODER_TRAINS:
        rec[fam["arch"]] = family_train(fam, dev, card, None)
        part(fam["arch"])
    for fam in DECODER_GRADS:
        rec[fam["arch"]] = family_grads(fam, dev, card)
        part(fam["arch"])
    rec["d128_times"] = time_d128_kernels(dev, card)
    part("the (128, 128) backward's times")
    rec["seconds"] = time.perf_counter() - t0
    rec["parts_s"] = parts
    say(f"train: the dense and MoE decoders' block took "
        f"{rec['seconds']:.1f} s (" + ", ".join(
            f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]")
    return rec


# ---------------------------------------------------------------------------
# Phase 9, the last two families: the flash backward non-causal with Sq !=
# Skv (seamless-m4t-medium) and at (192, 128) (deepseek-v3-671b's MLA),
# both families trained at published width
# ---------------------------------------------------------------------------

SEAMLESS, DEEPSEEK = "seamless-m4t-medium", "deepseek-v3-671b"
# the non-causal form at (64, 64): seamless-m4t-medium's heads (16 over 16)
# and a grouped layout (8 over 2); (B, (Sq, Skv)): the training shape, the
# cross-attention's frames longer and shorter than the tokens, and a short
# ragged one
NONCAUSAL_HEADS = {"seamless": dict(H=SEAMLESS_H, KV=SEAMLESS_H,
                                    D=SEAMLESS_D, causal=False),
                   "G 4": dict(H=8, KV=2, D=SEAMLESS_D, causal=False)}
NONCAUSAL_CASES = ((TRAIN_BATCH, (TRAIN_SEQ, TRAIN_SEQ)), (2, (200, 384)),
                   (2, (384, 200)), (2, (17, 100)))
# (192, 128) causal at MLA's softmax scale: deepseek-v3-671b's heads (128,
# each its own KV head) and a grouped layout (8 over 2); (B, S)
MLA_HEADS = {"deepseek": dict(H=MLA_H, KV=MLA_H, D=MLA_D, Dv=MLA_DV,
                              scale=MLA_SCALE),
             "G 4": dict(H=8, KV=2, D=MLA_D, Dv=MLA_DV, scale=MLA_SCALE)}
MLA_CASES = ((TRAIN_BATCH, TRAIN_SEQ), (2, 200), (2, 17))
# seamless-m4t-medium's gradient check runs its frames at this many rows
# against the tokens' TRAIN_SEQ: the cross-attention's Sq != Skv
SEAMLESS_GRAD_FRAMES = 384


def noncausal_control(kname, fn, args, window, S, got):
    """The non-causal form's control, each kernel: at Sq = Skv the same
    kernel run causal (the loop bounds of the form it replaces); at Skv >
    Sq dK's last key tile zeroed (keys the queries' length would cut); at
    Sq > Skv dQ's last query tile zeroed (queries the keys' length would
    cut)."""
    q, k, v, o, do, kw = args
    Sq, Skv = S
    if Sq == Skv:
        return fn(q, k, v, o, do, window=window, **dict(kw, causal=True))
    dq, dk, dv = (t.clone() for t in got)
    if Skv > Sq:
        dk[:, (Skv - 1) // 64 * 64:] = 0
    else:
        dq[:, (Sq - 1) // 64 * 64:] = 0
    return dq, dk, dv


def dv_cols_zeroed(kname, fn, args, window, S, got):
    """The (192, 128) control, each kernel: dV's last 64 columns (its
    second column block) zeroed."""
    dv = got[2].clone()
    dv[..., 64:] = 0
    return got[0], got[1], dv


def check_flash_backward_new_forms(dev) -> dict:
    """``check_flash_backward_cases`` at the two new forms: non-causal at
    each of NONCAUSAL_HEADS and NONCAUSAL_CASES (``noncausal_control``),
    and (192, 128) causal at each of MLA_HEADS and MLA_CASES
    (``dv_cols_zeroed``), every control above the limit in every case;
    ``FlashAttentionFn`` non-causal at (2, (200, 384)) in f32 (G 4) and at
    the cross-attention's (8, (256, 384)) in bf16 (seamless's heads), at
    (192, 128) at (2, 200) in f32 (G 4) and (8, 256) in bf16 (deepseek's
    heads).  Returns both readings."""
    nc, mla = NONCAUSAL_HEADS, MLA_HEADS
    out = {"noncausal": check_flash_backward_cases(
        dev, "non-causal (64, 64), seamless-m4t-medium's heads and G 4",
        [(hd, B, S, None) for hd in nc.values() for B, S in NONCAUSAL_CASES],
        noncausal_control,
        "the kernel run causal (Sq = Skv), dK's last key tile (Skv > Sq) or "
        "dQ's last query tile (Sq > Skv) zeroed", lambda key: True,
        [(nc["G 4"], 2, (200, 384), None, torch.float32),
         (nc["seamless"], TRAIN_BATCH, (TRAIN_SEQ, SEAMLESS_GRAD_FRAMES),
          None, torch.bfloat16)])}
    out["mla"] = check_flash_backward_cases(
        dev, "(192, 128) causal at MLA's scale, deepseek-v3-671b's heads and "
             "G 4",
        [(hd, B, S, None) for hd in mla.values() for B, S in MLA_CASES],
        dv_cols_zeroed, "dV's last 64 columns zeroed", lambda key: True,
        [(mla["G 4"], 2, 200, None, torch.float32),
         (mla["deepseek"], TRAIN_BATCH, TRAIN_SEQ, None, torch.bfloat16)])
    return out


def time_new_forms(dev, card) -> dict:
    """The new forms' backward (``time_flash_backward``) at the training
    shapes: seamless's encoder (B 8, S 256, non-causal), its
    cross-attention (Sq 256 over Skv 384: the gradient check's frames) and
    deepseek's MLA (B 8, S 256, (192, 128))."""
    nc = NONCAUSAL_HEADS["seamless"]
    return {
        "seamless encoder": time_flash_backward(
            dev, card, "seamless-m4t-medium's encoder", TRAIN_BATCH,
            (TRAIN_SEQ, TRAIN_SEQ), nc),
        "seamless cross": time_flash_backward(
            dev, card, "seamless-m4t-medium's cross-attention",
            TRAIN_BATCH, (TRAIN_SEQ, SEAMLESS_GRAD_FRAMES), nc),
        "deepseek MLA": time_flash_backward(
            dev, card, "deepseek-v3-671b's MLA", TRAIN_BATCH, TRAIN_SEQ,
            MLA_HEADS["deepseek"])}


def seamless_controls(control):
    """seamless-m4t-medium's gradient controls: the first flash backward's
    dK zeroed (the last decoder layer's cross-attention); the first
    non-causal backward with Sq = Skv (the last encoder layer's
    self-attention: the decoder's cross-attention runs Sq != Skv in the
    check) run causal."""
    from repro_torch.kernels.flash_attention import kernel as FK
    kernel = FK.flash_backward_cuda

    def as_causal(q, k, v, o, do, **kw):
        if kw.get("causal", True) or q.shape[1] != k.shape[1]:
            return None
        return kernel(q, k, v, o, do, **dict(kw, causal=True))

    return (("dk", FK, "flash_backward_cuda", None),
            ("causal", FK, "flash_backward_cuda", as_causal))


def mla_controls(control):
    """deepseek-v3-671b's gradient controls, each in the first flash
    backward (the MTP block's attention, the last in the forward): KV head
    0's dK zeroed; dV's last 64 columns zeroed (the Dv tiling's second
    column block)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    kernel = FK.flash_backward_cuda

    def kv0(*a, **kw):
        dq, dk, dv = kernel(*a, **kw)
        dk[:, :, 0] = 0
        return dq, dk, dv

    def dv_cols(*a, **kw):
        dq, dk, dv = kernel(*a, **kw)
        dv[..., 64:] = 0
        return dq, dk, dv

    return (("dk_kv0", FK, "flash_backward_cuda", kv0),
            ("dv_cols", FK, "flash_backward_cuda", dv_cols))


# The last two families' training (``family_train``) at published width,
# B 8 x S 256, remat "block".  seamless-m4t-medium: all 12 + 12 layers
# under AdamW (0.88 B parameters), its gradient check at
# SEAMLESS_GRAD_FRAMES frames; its CLI at SEAMLESS_CLI_LAYERS layers of
# each stack (cut_depth cuts the encoder alike).
# deepseek-v3-671b: its three dense layers and the MTP block (3.6 B
# parameters, each MLA at 128 heads of (192, 128)) under its config's
# Adafactor; its first MoE layer (layer 4: 256 experts of 3 x 7168 x 2048,
# 11.3 B parameters) did not fit one card beside its gradient and the plain
# Adafactor's f32 temporaries; with the update fused a step at 4 layers
# peaks at 70.85 GB allocated (tools/last_families_probe.py step
# deepseek-v3-671b:4), which leaves this phase too little room, so it stays
# at 3; its CLI at one layer (with the MTP block), whose checkpoint holds
# Adafactor's factored vr / vc.
SEAMLESS_CLI_LAYERS, DEEPSEEK_LAYERS, DEEPSEEK_CLI_LAYERS = 1, 3, 1
LAST_STEPS, LAST_CKPT_EVERY, LAST_TIMED_STEPS = 3, 2, 2
# Limits from the sound readings over seeds 0-2 (tools/
# last_families_probe.py grads, H100 80GB HBM3 at 700 W): deepseek-v3-671b
# 1.31e-2-1.38e-2 keeps llama's 3e-2 (its controls 6.15e-2-0.165 and
# 0.707-0.736); seamless-m4t-medium 0.112-0.120 (at the decoder's
# cross-attention and ln_x), which is bf16's noise: against the f32 plain
# gradient (seed 0; `noise`) the bf16 kernels read 0.128, the bf16 plain
# versions 0.127, the f32 kernels 1.03e-3; so 0.18, its controls reading
# 1.0 and 3.68-3.72
LAST_GRAD_RTOL = {SEAMLESS: 0.18, DEEPSEEK: 3e-2}
SEAMLESS_TRAIN = dict(
    arch=SEAMLESS, layers=None, rtol=LAST_GRAD_RTOL[SEAMLESS],
    group=("attn", "attn", "the attention's"), controls=seamless_controls,
    controls_said="dk: the last decoder layer's cross-attention dK zeroed, "
                  "causal: the last encoder layer's backward run causal",
    steps=LAST_STEPS, ckpt_every=LAST_CKPT_EVERY,
    cli_layers=SEAMLESS_CLI_LAYERS, stacked=None, routes=sm90_routes,
    grad_frames=SEAMLESS_GRAD_FRAMES, timed_steps=LAST_TIMED_STEPS)
DEEPSEEK_TRAIN = dict(
    arch=DEEPSEEK, layers=DEEPSEEK_LAYERS, rtol=LAST_GRAD_RTOL[DEEPSEEK],
    group=("attn", "/attn/", "the attention's"), controls=mla_controls,
    controls_said="dk_kv0: the MTP block's KV head 0 dK zeroed, dv_cols: "
                  "its dV's last 64 columns zeroed",
    steps=LAST_STEPS, ckpt_every=LAST_CKPT_EVERY,
    cli_layers=DEEPSEEK_CLI_LAYERS, stacked=None, routes=sm90_routes,
    timed_steps=LAST_TIMED_STEPS)
LAST_TRAINS = (SEAMLESS_TRAIN, DEEPSEEK_TRAIN)


def last_families_train(dev, card) -> dict:
    """Phase 9's last two families: the new forms' backward checks
    (``check_flash_backward_new_forms``), each of LAST_TRAINS through
    ``family_train``, the new forms' times (``time_new_forms``).  Returns
    the block's record, its seconds by part."""
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    rec = {"checks": check_flash_backward_new_forms(dev)}
    part("the new forms' checks")
    for fam in LAST_TRAINS:
        rec[fam["arch"]] = family_train(fam, dev, card, None)
        part(fam["arch"])
    rec["times"] = time_new_forms(dev, card)
    part("the new forms' times")
    rec["seconds"] = time.perf_counter() - t0
    rec["parts_s"] = parts
    say(f"train: the last two families' block took {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]")
    return rec


# ------------------------------------------------- the optimizer kernels

OPTIM_SOURCE = "src/repro_torch/csrc/adamw.cu"
OPTIM_REPLACES = "src/repro/launch/train.py:65"
OPTIM_NOTE = ("no TPU kernel: XLA's fusion of adamw.update and the clip "
              "inside jax.jit (src/repro/optim/adamw.py:48, "
              "src/repro/launch/steps.py:42-50)")
# updates at llama3.2-1b's full-width leaves, each from new seeded
# gradients; the ragged set: leaves of these element counts in f32 and in
# bf16, every other one at an address 1 element past 16-byte alignment
# (gradient, parameter and moments alike)
OPTIM_UPDATES = 3
OPTIM_RAGGED = (1, 3, 4097, 2 * 32768 + 5)
# each leaf's squared sum by sumsq_kernel against torch.sum(torch.square(
# g.float())), relative: the two sum in other orders.  Readings on an H100
# 80GB HBM3 at 700 W: 1.463e-7 (the ragged set), 1.487e-7 (llama3.2-1b's
# leaves, 3 updates); the chunk-0 control 1.94e-3 and 1.0
SUMSQ_RTOL = 1e-6
# the controls, each a library built from a one-line edit of
# csrc/adamw.cu: the weight decay dropped in chunk 0 (leaf 0's first
# 32768 elements) of the update; chunk 0's partial skipped by sumsq
OPTIM_CONTROL_EDITS = {
    "adamw_control_wd": ("u = __fadd_rn(u, __fmul_rn(h.wd, p));",
                         "u = blockIdx.x == 0 ? u : "
                         "__fadd_rn(u, __fmul_rn(h.wd, p));"),
    "adamw_control_skip": ("partials[c] = acc;",
                           "partials[c] = c == 0 ? 0.0f : acc;"),
}
# captured against eager train steps of llama3.2-1b at published width,
# and of deepseek-v3-671b (Adafactor) at its CLI's depth
CAPTURED_STEPS, ADAFACTOR_CAPTURED_STEPS = 4, 3


def build_optim_control(name: str, source: str = OPTIM_SOURCE,
                        edits=OPTIM_CONTROL_EDITS) -> Path:
    """A copy of ``source`` (``csrc/adamw.cu``) with ``edits[name]``, built
    by the repository's flags into a library of its own."""
    from repro_torch.kernels import _build
    text = (ROOT / source).read_text()
    old, new = edits[name]
    check(text.count(old) == 1, f"the optimizer control's edit {old!r} is "
                                f"not in {source} once")
    src = ROOT / "build" / "chip_smoke_controls" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(old, new))
    return _build.build(src, name)


def optim_control_fns(lib_path):
    """The control library's ``(sumsq(grads), update(grads, params, ms,
    vs, scale, lr, bc1, bc2, opt))``, launched as the kernel's wrappers
    launch theirs, on the same leaf tables (no launch counted)."""
    from repro_torch.kernels.optim import kernel as OK
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)
    lib.repro_sumsq.argtypes = [vp, i, ll, vp, vp, vp, vp]
    lib.repro_sumsq.restype = i
    lib.repro_adamw_update.argtypes = [vp, i, ll, vp, vp, vp, vp] + [f] * 6 \
        + [vp]
    lib.repro_adamw_update.restype = i
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def sumsq(grads):
        rows, chunks = OK._table(grads)
        dev = grads[0].device
        out = torch.zeros(len(grads), dtype=torch.float32, device=dev)
        partials = torch.empty(chunks, dtype=torch.float32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.repro_sumsq(rows.ctypes.data, len(rows), chunks,
                              partials.data_ptr(), out.data_ptr(),
                              counter.data_ptr(), stream())
        check(err == 0, f"the sumsq control's launch failed ({err})")
        return out

    def update(grads, params, ms, vs, scale, lr, bc1, bc2, opt):
        rows, chunks = OK._table(grads, params, ms, vs)
        err = lib.repro_adamw_update(
            rows.ctypes.data, len(rows), chunks,
            scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2, opt.eps,
            opt.weight_decay, stream())
        check(err == 0, f"the update control's launch failed ({err})")

    return sumsq, update


def optim_scalars(opt, step: int, dev):
    """(lr, bc1, bc2) as ``adamw.update`` computes them at ``step`` (the
    step after the update), from the schedule's lr at the step before."""
    from repro_torch.optim.schedule import cosine_warmup
    s = torch.tensor(step - 1, dtype=torch.int32, device=dev)
    lr = opt.lr * (cosine_warmup(s, peak_lr=3e-4, warmup=10,
                                 total=TRAIN_STEPS) / opt.lr)
    t = (s + 1).to(torch.float32)
    return lr, 1.0 - torch.pow(opt.b1, t), 1.0 - torch.pow(opt.b2, t)


def sumsq_reading(got, want) -> list:
    """Each leaf's |got - want| / |want| (f32 squared sums)."""
    return [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
            for a, b in zip(got, want)]


def seeded_leaves(shapes, dtypes, dev, seed, offsets=None):
    """(grads, params, ms, vs) of these shapes, from ``seed``: grads and
    params in their dtypes, moments f32 (v >= 0), each leaf at
    ``offsets[i]`` elements into a buffer of its own (default 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = ([], [], [], [])
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        off = offsets[i] if offsets else 0
        n = math.prod(shape)
        for j, (kind, scale) in enumerate((("g", 1e-2), ("p", 2e-2),
                                            ("m", 1e-3), ("v", 1e-5))):
            buf = torch.empty(n + off, dtype=dt if kind in "gp"
                              else torch.float32, device=dev)
            x = torch.randn(n, generator=gen, device=dev)
            buf[off:] = (x * x if kind == "v" else x) * scale
            out[j].append(buf[off:].view(shape))
    return out


def optim_check_set(label, shapes, dtypes, dev, opt, controls, seed,
                    updates, offsets=None, emulate=False) -> dict:
    """The two kernels against their plain versions on one set of leaves,
    over ``updates`` updates, each from new seeded gradients: per update,
    sumsq's per-leaf sums within SUMSQ_RTOL of ``torch.sum(torch.square(
    g.float()))`` and bit-equal to a second run (and, with ``emulate``, to
    ``ref.sumsq_chunked_torch``'s, the kernel's order in torch on the
    host); the update given the same scale, lr, bc1 and bc2 as the plain
    clip and update, bit-equal to it in every leaf's p, m and v (and with
    ``emulate`` ``ref.adamw_update_chunked_torch`` on the host too).  Then
    the controls on the last update's leaves: the sumsq control above the
    limit in leaf 0 and bit-equal to the kernel elsewhere; one more update
    by the kernel and by the update control from the same state (the two
    states are bit-equal there): leaf 0 differs, every other leaf
    bit-equal."""
    from repro_torch.kernels.optim import kernel as OK
    from repro_torch.kernels.optim import ref as OR
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    g0, pk, mk, vk = seeded_leaves(shapes, dtypes, dev, seed, offsets)
    del g0
    pp, mp, vp = ([t.clone() for t in ts] for ts in (pk, mk, vk))
    worst, worst_abs, equal = 0.0, 0.0, True
    emul = {"sumsq": True, "adamw_update": True}
    for u in range(updates):
        grads = seeded_leaves(shapes, dtypes, dev, seed + 1 + u,
                              offsets)[0]
        got = OK.sumsq_cuda(grads)
        again = OK.sumsq_cuda(grads)
        want = torch.stack(OR.sumsq_torch(grads))
        check(torch.equal(got, again), f"{label}: sumsq's two runs differ")
        worst = max(worst, *sumsq_reading(got, want))
        worst_abs = max(worst_abs, float((got - want).abs().max()))
        if emulate:
            host = [g.cpu() for g in grads]
            em = OR.sumsq_chunked_torch(host)
            if not torch.equal(got.cpu(), em):
                emul["sumsq"] = False
                say(f"optim: {label}: sumsq {got.tolist()} against its "
                    f"order emulated {em.tolist()}")
        scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(got.sum()),
                                              min=1e-9), max=1.0)
        lr, bc1, bc2 = optim_scalars(opt, u + 3, dev)
        if emulate:
            # on the card: torch's f32 ops there round as the kernel's do
            # (the host's square root may not: a handful of elements
            # differ there)
            hs = [[t.clone() for t in ts] for ts in (grads, pk, mk, vk)]
            addrs = [tuple(t.data_ptr() for t in four)
                     for four in zip(grads, pk, mk, vk)]
            OR.adamw_update_chunked_torch(*hs, scale=scale, lr=lr, bc1=bc1,
                                          bc2=bc2, addrs=addrs, **hyper)
        OK.adamw_update_cuda(grads, pk, mk, vk, scale=scale, lr=lr,
                             bc1=bc1, bc2=bc2, **hyper)
        OR.adamw_update_torch([g.clone() for g in grads], pp, mp, vp,
                              scale=scale, lr=lr, bc1=bc1, bc2=bc2, **hyper)
        same = [all(torch.equal(a[i], b[i]) for a, b in
                    ((pk, pp), (mk, mp), (vk, vp)))
                for i in range(len(shapes))]
        equal &= all(same)
        if emulate:
            off = [int((a != b).sum()) for a, b in
                   zip(pk + mk + vk, hs[1] + hs[2] + hs[3])]
            if any(off):
                emul["adamw_update"] = False
                say(f"optim: {label}: the update's elements off its order "
                    f"emulated, p / m / v a leaf: {off}")
    check(equal, f"{label}: the update is not bit-equal to the plain clip "
                 f"and update in every leaf")
    check(worst <= SUMSQ_RTOL, f"{label}: sumsq against torch.sum reads "
                               f"{worst:.3e}, limit {SUMSQ_RTOL}")
    check(all(emul.values()), f"{label}: the kernels bit-equal to their "
                              f"order emulated in torch: {emul}")
    # the controls on the last update's gradients and the equal states
    sumsq_c, update_c = controls
    ctrl = sumsq_c(grads)
    reading = sumsq_reading(ctrl, want)
    check(reading[0] > SUMSQ_RTOL and torch.equal(ctrl[1:], got[1:]),
          f"{label}: the sumsq control (chunk 0 skipped) reads {reading[0]:.3e}"
          f" in leaf 0 (limit {SUMSQ_RTOL}); elsewhere equal to the kernel: "
          f"{torch.equal(ctrl[1:], got[1:])}")
    lr, bc1, bc2 = optim_scalars(opt, updates + 3, dev)
    OK.adamw_update_cuda(grads, pk, mk, vk, scale=scale, lr=lr, bc1=bc1,
                         bc2=bc2, **hyper)
    update_c(grads, pp, mp, vp, scale, lr, bc1, bc2, opt)
    differs = [not all(torch.equal(a[i], b[i]) for a, b in
                       ((pk, pp), (mk, mp), (vk, vp)))
               for i in range(len(shapes))]
    check(differs[0] and not any(differs[1:]),
          f"{label}: the update control (weight decay dropped in chunk 0) "
          f"changed leaves {[i for i, d in enumerate(differs) if d]}, "
          f"leaf 0 only expected")
    n = sum(math.prod(sh) for sh in shapes)
    rec = dict(leaves=len(shapes), parameters=n, updates=updates,
               update_bit_equal=equal, sumsq_worst_rel=worst,
               sumsq_max_abs_err=worst_abs,
               sumsq_control_leaf0=reading[0],
               update_control_leaves=[i for i, d in enumerate(differs) if d])
    if emulate:
        rec["emulation_bit_equal"] = all(emul.values())
    say(f"optim: {label} ({len(shapes)} leaves, {n} parameters, "
        f"{updates} updates): the update bit-equal to the plain clip and "
        f"update in every leaf; sumsq within {worst:.3e} of torch.sum "
        f"(limit {SUMSQ_RTOL}), two runs bit-equal"
        + (", both kernels bit-equal to their order emulated in torch"
           if emulate else "")
        + f"; controls: chunk 0 skipped reads {reading[0]:.3e} in leaf 0, "
          f"the weight decay dropped in chunk 0 changes leaf 0 only")
    return rec, (grads, pk, mk, vk, pp, mp, vp)


def check_optim_kernels(dev, card, controls) -> dict:
    """The optimizer kernels against their plain versions on the card
    (``optim_check_set``): at llama3.2-1b's full-width leaves (bf16
    parameters and gradients, f32 moments) over OPTIM_UPDATES updates, and
    on the ragged set (OPTIM_RAGGED in f32 and bf16, every other leaf off
    16-byte alignment) with the kernels' order emulated in torch too; then
    their times at llama's leaves (``time_optim_kernels``)."""
    import repro_torch.configs as configs
    from repro_torch.models.params import is_def, tree_leaves
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    opt = adamw(lr=3e-4)
    ragged = [(n,) for n in OPTIM_RAGGED] * 2
    dts = [torch.float32] * len(OPTIM_RAGGED) + [torch.bfloat16] * len(
        OPTIM_RAGGED)
    rec = {"ragged": optim_check_set(
        "the ragged set", ragged, dts, dev, opt, controls, SEED + 100, 2,
        offsets=[i % 2 for i in range(len(ragged))], emulate=True)[0]}
    defs = tree_leaves(build_model(configs.get("llama3.2-1b")).defs,
                       is_leaf=is_def)
    shapes = [tuple(d.shape) for d in defs]
    rec["llama"], leaves = optim_check_set(
        "llama3.2-1b's leaves", shapes, [torch.bfloat16] * len(shapes), dev,
        opt, controls, SEED, OPTIM_UPDATES)
    rec["times"] = time_optim_kernels(leaves, opt, card)
    del leaves
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    say(f"optim: the kernels' checks and times took {rec['seconds']:.1f} s "
        f"[{card}]")
    return rec


def time_optim_kernels(leaves, opt, card) -> dict:
    """ms a launch of each optimizer kernel at llama3.2-1b's leaves
    (``event_us``: CUDA events around each call, after two warm calls)
    beside its bound (the bytes it must move over 3.35 TB/s: sumsq 2 B a
    parameter, the update 22 B), its plain version's ms (``ref``'s
    per-leaf squared sums; the plain clip and update), and two PyTorch
    calls as timing references only, whose math is not ``repro``'s:
    ``torch._foreach_norm`` of the gradients and one step of
    ``torch.optim.AdamW(fused=True)`` (its moments in the parameters'
    dtype, bf16, and its weight decay applied before the update)."""
    from repro_torch.kernels.optim import kernel as OK
    from repro_torch.kernels.optim import ref as OR
    grads, pk, mk, vk, pp, mp, vp = leaves
    dev = grads[0].device
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    lr, bc1, bc2 = optim_scalars(opt, 5, dev)
    scale = torch.tensor(0.5, device=dev)
    numels = [g.numel() for g in grads]
    _, b_sumsq = costs.sumsq_cost(numels, [2] * len(numels))
    _, b_update = costs.adamw_update_cost(numels, [2] * len(numels),
                                          [2] * len(numels))
    out = dict(
        sumsq=dict(ms=event_us(lambda: OK.sumsq_cuda(grads), 10) / 1e3,
                   plain_ms=event_us(lambda: torch.sqrt(sum(
                       OR.sumsq_torch(grads))), 5) / 1e3,
                   bound_ms=b_sumsq / HBM_BYTES_PER_S * 1e3,
                   library_ms=event_us(
                       lambda: torch._foreach_norm(grads), 10) / 1e3),
        adamw_update=dict(
            ms=event_us(lambda: OK.adamw_update_cuda(
                grads, pk, mk, vk, scale=scale, lr=lr, bc1=bc1, bc2=bc2,
                **hyper), 10) / 1e3,
            plain_ms=event_us(lambda: OR.adamw_update_torch(
                grads, pp, mp, vp, scale=scale, lr=lr, bc1=bc1, bc2=bc2,
                **hyper), 3) / 1e3,
            bound_ms=b_update / HBM_BYTES_PER_S * 1e3))
    ps = [torch.nn.Parameter(p) for p in pk]
    for p, g in zip(ps, grads):
        p.grad = g
    ref_opt = torch.optim.AdamW(ps, lr=3e-4, betas=(opt.b1, opt.b2),
                                eps=opt.eps, weight_decay=opt.weight_decay,
                                fused=True)
    out["adamw_update"]["library_ms"] = event_us(ref_opt.step, 5) / 1e3
    del ref_opt, ps
    gc.collect()
    torch.cuda.empty_cache()
    for k, r in out.items():
        r.update(bound_by="bytes", parameters=sum(numels),
                 shape=f"llama3.2-1b's {len(numels)} leaves, bf16")
    say("timing: optimizer kernels at llama3.2-1b's leaves ("
        f"{sum(numels)} parameters): " + "; ".join(
            f"{k} {r['ms']:.3f} ms (bound {r['bound_ms']:.3f}, plain "
            f"{r['plain_ms']:.3f}, timing reference {r['library_ms']:.3f} "
            f"({'torch._foreach_norm' if k == 'sumsq' else 'torch.optim.AdamW(fused=True).step, bf16 moments'}"
            f"))" for k, r in out.items()) + f" [{card}]")
    return out


# ------------------------------------------------ the Adafactor kernels

ADAFACTOR_SOURCE = "src/repro_torch/csrc/adafactor.cu"
ADAFACTOR_REPLACES = "src/repro/optim/adafactor.py:67"
ADAFACTOR_NOTE = ("no TPU kernel: XLA's fusion of adafactor.update and the "
                  "clip inside jax.jit (src/repro/optim/adafactor.py:67-98, "
                  "src/repro/launch/steps.py:42-50)")
ADAFACTOR_KERNELS = ("adafactor_sums", "adafactor_rms", "adafactor_update")
# updates at deepseek-v3-671b's 31 full-width leaves (DEEPSEEK_LAYERS deep,
# 4.29 G parameters, bf16), each from new seeded gradients and the state
# the kernels left; the ragged set's leaves, in f32 and in bf16, every
# other one at an address 1 element past 16-byte alignment: 1-D to 4-D,
# a single row and a single column, rows longer than a tile (256), matrices
# of several row tiles (128); leaf 0 factored, for the controls
ADAFACTOR_UPDATES = 2
ADAFACTOR_RAGGED = ((3, 700), (5,), (3, 5, 1031), (2, 3, 130, 300), (1, 1),
                    (1, 257), (300, 1), (40000,), (129, 7))
# the moments seeded far below (1 - beta2) g^2, so that each update's rms
# exceeds clip_threshold and the clip bites (the clip control reads there)
ADAFACTOR_MOMENT_SCALE = 1e-12
# the limits against the plain version, whose sums run in another order:
# each moment (vr, vc, v) relative, max over the leaf's elements; each
# leaf's parameters ||p - p_plain|| / ||p_plain - p_before||, which in
# bf16 is set by the rare elements whose rounding the sums' order flips (a
# bf16 ulp each).  Readings over seeds 0-3 (tools/optim_probe.py
# adafactor 1 2 3; H100 80GB HBM3 at 700 W): the ragged set moments
# 2.94e-7-3.21e-7, parameters 1.31e-6-2.74e-6; deepseek-v3-671b's leaves
# moments 1.57e-6-1.79e-6, parameters 5.05e-4-9.62e-4.  The controls read
# 0.954-0.993 (skip) and 0.255-0.528 (clip)
ADAFACTOR_MOMENT_RTOL = 1e-5
ADAFACTOR_P_RTOL = 4e-3
# the controls, each a library built from a one-line edit of
# csrc/adafactor.cu: tile 0's column partials skipped (leaf 0's first 256
# columns' vc); leaf 0's RMS clip dropped in the update
ADAFACTOR_CONTROL_EDITS = {
    "adafactor_control_skip": ("colpart[b * kTileCols + tid] = a;",
                               "colpart[b * kTileCols + tid] = "
                               "b == 0 ? 0.0f : a;"),
    "adafactor_control_clip": (
        "const float d = fmaxf(__fmul_rn(rms, inv_clip), 1.0f);",
        "const float d = li == 0 ? 1.0f "
        ": fmaxf(__fmul_rn(rms, inv_clip), 1.0f);"),
}


def build_adafactor_control(name: str) -> Path:
    """A copy of ``csrc/adafactor.cu`` with
    ``ADAFACTOR_CONTROL_EDITS[name]``, built into a library of its own."""
    return build_optim_control(name, ADAFACTOR_SOURCE, ADAFACTOR_CONTROL_EDITS)


@contextlib.contextmanager
def adafactor_library(lib):
    """The Adafactor wrappers launching ``lib``'s kernels (a control)."""
    from repro_torch.kernels.optim import kernel as OK
    saved = OK._adafactor_lib
    OK._adafactor_lib = lib
    try:
        yield
    finally:
        OK._adafactor_lib = saved


def seeded_adafactor(shapes, dtypes, dev, seed, offsets=None):
    """(grads, params, vs) of these shapes from ``seed``: grads and params
    in their dtypes (scales 1e-2, 2e-2), each leaf's Adafactor state in f32
    (vr, vc or v; uniform below ADAFACTOR_MOMENT_SCALE), each tensor at
    ``offsets[i]`` elements into a buffer of its own (default 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def at(shape, dt, off, make):
        n = math.prod(shape)
        buf = torch.empty(n + off, dtype=dt, device=dev)
        buf[off:] = make(n)
        return buf[off:].view(shape)

    grads, params, vs = [], [], []
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        off = offsets[i] if offsets else 0
        grads.append(at(shape, dt, off, lambda n: torch.randn(
            n, generator=gen, device=dev) * 1e-2))
        params.append(at(shape, dt, off, lambda n: torch.randn(
            n, generator=gen, device=dev) * 2e-2))
        mom = lambda s: at(s, torch.float32, off, lambda n: torch.rand(  # noqa: E731
            n, generator=gen, device=dev) * ADAFACTOR_MOMENT_SCALE)
        shape = tuple(shape)
        vs.append({"vr": mom(shape[:-1]), "vc": mom(shape[:-2] + shape[-1:])}
                  if len(shape) >= 2 else {"v": mom(shape)})
    return grads, params, vs


def clone_vs(vs):
    return [{k: t.clone() for k, t in v.items()} for v in vs]


def adafactor_scalars(grads, opt, step: int, dev):
    """(scale, lr, beta2) as the train step computes them at ``step`` (the
    step after the update): the clip's scale from the norm by sumsq_kernel,
    the schedule's lr at the step before, ``adafactor.update``'s beta2."""
    from repro_torch.kernels.optim.ops import global_norm
    from repro_torch.optim.schedule import cosine_warmup
    scale = torch.clamp(1.0 / torch.clamp(global_norm(grads, impl="cuda"),
                                          min=1e-9), max=1.0)
    s = torch.tensor(step - 1, dtype=torch.int32, device=dev)
    lr = opt.lr * (cosine_warmup(s, peak_lr=3e-4, warmup=10,
                                 total=TRAIN_STEPS) / opt.lr)
    beta2 = 1.0 - (s + 1).to(torch.float32) ** (-opt.decay)
    return scale, lr, beta2


def adafactor_readings(params, vs, pp, vp, before):
    """Per leaf (moments, parameters): the moments' max relative error
    against the plain version's (``vp``), the parameters' ||p - pp|| /
    ||pp - before|| (0 where both are 0)."""
    mom, par = [], []
    for p, v, q, w, b in zip(params, vs, pp, vp, before):
        mom.append(max(float(((v[k] - w[k]).abs() / w[k].abs()).max())
                       for k in v))
        d = float((p.float() - q.float()).norm())
        step = float((q.float() - b.float()).norm())
        par.append(0.0 if d == 0 else d / step if step else math.inf)
    return mom, par


def leaves_equal(params, vs, pp, vp) -> list:
    """Per leaf: the parameters and every moment bit-equal."""
    return [torch.equal(p, q) and all(torch.equal(v[k], w[k]) for k in v)
            for p, v, q, w in zip(params, vs, pp, vp)]


def adafactor_controls(label, controls, grads, params, vs, clones, before,
                       kw) -> dict:
    """Each control library's update from the state ``clones()`` gives (the
    update's starting state) against the kernels' (``params``, ``vs``):
    above its limit in leaf 0, every other leaf bit-equal."""
    from repro_torch.kernels.optim import ops as OO
    out = {}
    for name, lib in controls.items():
        pc, vc = clones()
        with adafactor_library(lib):
            OO.adafactor_update(grads, pc, vc, impl="cuda", **kw)
        mom, par = adafactor_readings(pc, vc, params, vs, before)
        same = leaves_equal(pc, vc, params, vs)
        reading = mom[0] if name.endswith("skip") else par[0]
        limit = (ADAFACTOR_MOMENT_RTOL if name.endswith("skip")
                 else ADAFACTOR_P_RTOL)
        check(reading > limit and not same[0] and all(same[1:]),
              f"{label}: the control {name} reads {reading:.3e} in leaf 0 "
              f"(limit {limit}); leaves off the kernels': "
              f"{[i for i, s in enumerate(same) if not s]}, leaf 0 only "
              f"expected")
        out[name] = dict(leaf0=reading, limit=limit,
                         leaves_off=[i for i, s in enumerate(same) if not s])
        del pc, vc
    return out


def adafactor_split_sums(grads, vs, kw) -> bool:
    """The split route's first two launches from the state ``vs`` (left
    as it was): ``adafactor_sums_kernel``'s raw row and column sums, then
    its finishing mode's moments and sums of vr, each bit-equal to its
    order emulated on the card (``ref.adafactor_sums_emulated(fused=
    False)``, ``ref.adafactor_finish_emulated``)."""
    from repro_torch.kernels.optim import kernel as OK
    from repro_torch.kernels.optim import ref as OR
    one = dict(scale=kw["scale"], beta2=kw["beta2"], eps=kw["eps"])
    sk, se = OR.flat_states(clone_vs(vs)), OR.flat_states(clone_vs(vs))
    raw_k, _ = OK.adafactor_sums_cuda(grads, sk, fused=False, **one)
    raw_e, _ = OR.adafactor_sums_emulated(grads, se, fused=False, **one)
    vr_k = OK.adafactor_finish_cuda(raw_k, grads, sk, beta2=kw["beta2"])
    vr_e = OR.adafactor_finish_emulated(raw_e, grads, se, beta2=kw["beta2"])
    return (torch.equal(raw_k, raw_e) and torch.equal(vr_k, vr_e)
            and all(torch.equal(a, b) for a, b in zip(sk, se)))


def adafactor_check_set(label, shapes, dtypes, dev, opt, controls, seed,
                        updates, offsets=None, emulate=True) -> tuple:
    """The Adafactor kernels (``ops.adafactor_update(impl="cuda")``: three
    launches) on one set of leaves over ``updates`` updates, each from new
    seeded gradients, the clip's scale, lr and beta2 as the step computes
    them (``adafactor_scalars``): per update, from the same state, a second
    run bit-equal, the split route (``ops.adafactor_kernels(split=True)``:
    four launches, the route of sharded leaves, here with nothing to
    reduce) bit-equal, so within the plain version's limits as the fused
    route is; at the first update its raw sums and moments bit-equal to
    their order emulated on the card (``adafactor_split_sums``, with
    ``emulate``); ``ref.adafactor_update_chunked_torch`` on the card
    (``emulate``) bit-equal, and the plain version within
    ADAFACTOR_MOMENT_RTOL (each moment) and ADAFACTOR_P_RTOL (each leaf's
    parameters against the update's size); at the last update each control
    too, from the same state: above its limit in leaf 0, every other leaf
    bit-equal to the kernels'.  The plain version runs last (it scales the
    gradients in place; no copy of them is held at deepseek's 8.6 GB).
    Returns (its record, the leaves)."""
    from repro_torch.kernels.optim import ops as OO
    from repro_torch.kernels.optim import ref as OR
    hyper = dict(eps=opt.eps, clip_threshold=opt.clip_threshold,
                 weight_decay=opt.weight_decay)
    _, params, vs = seeded_adafactor(shapes, dtypes, dev, seed, offsets)
    n_leaves = len(shapes)
    worst_m, worst_p = [0.0] * n_leaves, [0.0] * n_leaves
    max_abs = {"moments": 0.0, "params": 0.0}
    twice, emul, split = True, True, True
    split_sums = None
    clones = lambda: ([p.clone() for p in before], clone_vs(before_v))  # noqa: E731
    for u in range(updates):
        grads = seeded_adafactor(shapes, dtypes, dev, seed + 1 + u,
                                 offsets)[0]
        scale, lr, beta2 = adafactor_scalars(grads, opt, u + 3, dev)
        kw = dict(scale=scale, lr=lr, beta2=beta2, **hyper)
        before, before_v = [p.clone() for p in params], clone_vs(vs)
        OO.adafactor_update(grads, params, vs, impl="cuda", **kw)
        p2, v2 = clones()
        OO.adafactor_update(grads, p2, v2, impl="cuda", **kw)
        twice &= all(leaves_equal(params, vs, p2, v2))
        del p2, v2
        p2, v2 = clones()
        OO.adafactor_kernels(grads, p2, v2, split=True, **kw)
        same = leaves_equal(params, vs, p2, v2)
        if not all(same):
            split = False
            say(f"optim: {label}: the Adafactor kernels' split route off "
                f"the fused one in leaves "
                f"{[i for i, s in enumerate(same) if not s]}")
        del p2, v2
        if emulate and u == 0:
            split_sums = adafactor_split_sums(grads, before_v, kw)
        if emulate:
            pe, ve = clones()
            OR.adafactor_update_chunked_torch(grads, pe, ve, **kw)
            same = leaves_equal(params, vs, pe, ve)
            if not all(same):
                emul = False
                say(f"optim: {label}: the Adafactor kernels off their order "
                    f"emulated in leaves "
                    f"{[i for i, s in enumerate(same) if not s]}")
            del pe, ve
        if u == updates - 1:
            ctrl = adafactor_controls(label, controls, grads, params, vs,
                                      clones, before, kw)
        pp, vp = clones()
        OR.adafactor_update_torch(grads, pp, vp, **kw)
        mom, par = adafactor_readings(params, vs, pp, vp, before)
        worst_m = [max(a, b) for a, b in zip(worst_m, mom)]
        worst_p = [max(a, b) for a, b in zip(worst_p, par)]
        max_abs["params"] = max(max_abs["params"], *(
            float((p.float() - q.float()).abs().max())
            for p, q in zip(params, pp)))
        max_abs["moments"] = max(max_abs["moments"], *(
            float((v[k] - w[k]).abs().max()) for v, w in zip(vs, vp)
            for k in v))
        del pp, vp
        gc.collect()
        torch.cuda.empty_cache()
    check(twice, f"{label}: two runs of the Adafactor kernels differ")
    check(split, f"{label}: the Adafactor kernels' split route is not "
                 f"bit-equal to the fused one")
    check(split_sums is not False,
          f"{label}: the split route's raw sums or moments are not "
          f"bit-equal to their order emulated in torch")
    check(emul, f"{label}: the Adafactor kernels are not bit-equal to their "
                f"order emulated in torch")
    check(max(worst_m) <= ADAFACTOR_MOMENT_RTOL
          and max(worst_p) <= ADAFACTOR_P_RTOL,
          f"{label}: the Adafactor kernels against the plain version read "
          f"moments {max(worst_m):.3e} (limit {ADAFACTOR_MOMENT_RTOL}), "
          f"parameters {max(worst_p):.3e} (limit {ADAFACTOR_P_RTOL})")
    n = sum(math.prod(s) for s in shapes)
    rec = dict(leaves=n_leaves, parameters=n, updates=updates,
               two_runs_bit_equal=twice, split_bit_equal_to_fused=split,
               moment_worst_rel=max(worst_m),
               param_worst_rel=max(worst_p), moment_rel_by_leaf=worst_m,
               param_rel_by_leaf=worst_p, max_abs_err=max_abs,
               limits=dict(moments=ADAFACTOR_MOMENT_RTOL,
                           params=ADAFACTOR_P_RTOL), controls=ctrl)
    if emulate:
        rec.update(emulation_bit_equal=emul,
                   split_sums_bit_equal_to_emulation=split_sums)
    say(f"optim: {label} ({n_leaves} leaves, {n} parameters, {updates} "
        f"updates), the Adafactor kernels: two runs bit-equal, the split "
        f"route (adafactor_sums twice) bit-equal to the fused one"
        + ("; both bit-equal to their order emulated in torch on the card "
           "(the split route's raw sums and moments too)"
           if emulate else "")
        + f"; against the plain version moments {max(worst_m):.3e} (limit "
          f"{ADAFACTOR_MOMENT_RTOL}), parameters {max(worst_p):.3e} of the "
          f"update (limit {ADAFACTOR_P_RTOL}); max abs {max_abs}; controls: "
        + ", ".join(f"{k} {c['leaf0']:.3e} in leaf 0, leaves off "
                    f"{c['leaves_off']}" for k, c in ctrl.items()))
    del before, before_v
    return rec, (grads, params, vs, scale, lr, beta2)


def deepseek_leaf_shapes(layers: int = DEEPSEEK_LAYERS) -> list:
    """deepseek-v3-671b's leaf shapes at published width, ``layers`` deep
    (``cut_depth``; the MTP block's leaves too)."""
    import repro_torch.configs as configs
    from repro_torch.models.params import is_def, tree_leaves
    from repro_torch.models.zoo import build_model
    cfg = configs.cut_depth(configs.get(DEEPSEEK), layers)
    return [tuple(d.shape) for d in tree_leaves(build_model(cfg).defs,
                                                is_leaf=is_def)]


def check_adafactor_kernels(dev, card, controls) -> dict:
    """The Adafactor kernels against their plain version on the card
    (``adafactor_check_set``): on the ragged set (ADAFACTOR_RAGGED in f32
    and bf16, every other leaf off 16-byte alignment) and at
    deepseek-v3-671b's 31 full-width leaves (bf16) over ADAFACTOR_UPDATES
    updates, both with the order emulated on the card; then their times
    there (``time_adafactor_kernels``)."""
    from repro_torch.optim import adafactor
    t0 = time.perf_counter()
    opt = adafactor(lr=3e-4)
    ragged = list(ADAFACTOR_RAGGED) * 2
    dts = ([torch.float32] * len(ADAFACTOR_RAGGED)
           + [torch.bfloat16] * len(ADAFACTOR_RAGGED))
    rec = {"ragged": adafactor_check_set(
        "the ragged set", ragged, dts, dev, opt, controls, SEED + 200, 2,
        offsets=[i % 2 for i in range(len(ragged))])[0]}
    shapes = deepseek_leaf_shapes()
    rec["deepseek"], leaves = adafactor_check_set(
        f"deepseek-v3-671b's leaves ({DEEPSEEK_LAYERS} layers + MTP)",
        shapes, [torch.bfloat16] * len(shapes), dev, opt, controls,
        SEED + 300, ADAFACTOR_UPDATES)
    rec["times"] = time_adafactor_kernels(leaves, opt, card)
    del leaves
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    say(f"optim: the Adafactor kernels' checks and times took "
        f"{rec['seconds']:.1f} s [{card}]")
    return rec


def time_adafactor_kernels(leaves, opt, card) -> dict:
    """ms a launch of each Adafactor kernel at deepseek-v3-671b's leaves
    (``event_us``) beside its own bound (the bytes it must move over 3.35
    TB/s: ``costs.adafactor_*_cost``), the three together (one
    ``ops.adafactor_update``; the split route's four, the cost of the
    fourth launch) against the whole update's bound
    (``costs.adafactor_cost``: 6 B a bf16 parameter), the plain update's
    ms, the norm (``sumsq_kernel``, 2 B a parameter) and the plain clip's
    norm, and one step of ``torch.optim.Adafactor(foreach=True)`` as a
    timing reference only (its math is not ``repro``'s: no RMS clip of the
    update, another schedule).  The clip's scale is 1 here (the same
    launches and passes; the gradients stay as they are)."""
    from repro_torch.kernels.optim import kernel as OK
    from repro_torch.kernels.optim import ops as OO
    from repro_torch.kernels.optim import ref as OR
    grads, params, vs, _, lr, beta2 = leaves
    dev = grads[0].device
    scale = torch.tensor(1.0, device=dev)
    hyper = dict(eps=opt.eps, clip_threshold=opt.clip_threshold,
                 weight_decay=opt.weight_decay)
    states = OR.flat_states(vs)
    shapes = [tuple(g.shape) for g in grads]
    es = [g.element_size() for g in grads]
    ps = [p.element_size() for p in params]
    _, vrsum = OK.adafactor_sums_cuda(grads, states, scale=scale,
                                      beta2=beta2, eps=opt.eps)
    u2sum = OK.adafactor_rms_cuda(grads, states, vrsum, scale=scale,
                                  eps=opt.eps)
    ms = lambda fn, reps=10: event_us(fn, reps) / 1e3  # noqa: E731
    bound = lambda cost: cost[1] / HBM_BYTES_PER_S * 1e3  # noqa: E731
    out = {
        "adafactor_sums": dict(
            ms=ms(lambda: OK.adafactor_sums_cuda(
                grads, states, scale=scale, beta2=beta2, eps=opt.eps)),
            bound_ms=bound(costs.adafactor_sums_cost(shapes, es))),
        "adafactor_rms": dict(
            ms=ms(lambda: OK.adafactor_rms_cuda(
                grads, states, vrsum, scale=scale, eps=opt.eps)),
            bound_ms=bound(costs.adafactor_rms_cost(shapes, es))),
        "adafactor_update": dict(
            ms=ms(lambda: OK.adafactor_update_cuda(
                grads, params, states, vrsum, u2sum, scale=scale, lr=lr,
                **hyper)),
            bound_ms=bound(costs.adafactor_update_cost(shapes, es, ps)))}
    whole = dict(
        ms=ms(lambda: OO.adafactor_update(grads, params, vs, scale=scale,
                                          lr=lr, beta2=beta2, impl="cuda",
                                          **hyper)),
        split_ms=ms(lambda: OO.adafactor_kernels(
            grads, params, vs, scale=scale, lr=lr, beta2=beta2, split=True,
            **hyper)),
        bound_ms=bound(costs.adafactor_cost(shapes, es, ps)),
        plain_ms=ms(lambda: OR.adafactor_update_torch(
            grads, params, vs, scale=scale, lr=lr, beta2=beta2, **hyper), 3))
    gc.collect()
    torch.cuda.empty_cache()
    norm = dict(ms=ms(lambda: OK.sumsq_cuda(grads)),
                bound_ms=bound(costs.sumsq_cost(
                    [g.numel() for g in grads], es)),
                plain_ms=ms(lambda: torch.sqrt(sum(OR.sumsq_torch(grads))),
                            5))
    try:
        tp = [torch.nn.Parameter(p) for p in params]
        for p, g in zip(tp, grads):
            p.grad = g
        ref_opt = torch.optim.Adafactor(tp, lr=3e-4, foreach=True)
        whole["library_ms"] = ms(ref_opt.step, 3)
        whole["library_note"] = ("timing reference only, not repro's math: "
                                 "one step of torch.optim.Adafactor("
                                 "foreach=True) (no RMS clip of the "
                                 "update, its own schedule)")
        del ref_opt, tp
    except Exception as e:            # a reference only: say why it is none
        whole["library_ms"] = None
        whole["library_note"] = f"torch.optim.Adafactor failed: {e!r}"[:300]
    gc.collect()
    torch.cuda.empty_cache()
    n = sum(g.numel() for g in grads)
    for r in (*out.values(), whole, norm):
        r.update(bound_by="bytes", parameters=n,
                 shape=f"deepseek-v3-671b's {len(grads)} leaves "
                       f"({DEEPSEEK_LAYERS} layers + MTP), bf16")
    for r in out.values():
        r.update(plain_ms=whole["plain_ms"],
                 library_ms=whole["library_ms"],
                 library_note=whole["library_note"])
    out["adafactor"] = whole
    out["sumsq"] = norm
    say("timing: the Adafactor kernels at deepseek-v3-671b's leaves "
        f"({n} parameters, bf16): "
        + "; ".join(f"{k} {out[k]['ms']:.3f} ms (bound "
                    f"{out[k]['bound_ms']:.3f})" for k in ADAFACTOR_KERNELS)
        + f"; the three (one ops.adafactor_update) {whole['ms']:.3f} ms "
          f"(the split route's four {whole['split_ms']:.3f}) "
          f"against the update's bound {whole['bound_ms']:.3f} ms, the "
          f"plain update {whole['plain_ms']:.3f} ms, torch.optim.Adafactor("
          f"foreach=True).step {whole['library_ms']} ms (timing reference "
          f"only); the norm: sumsq {norm['ms']:.3f} ms (bound "
          f"{norm['bound_ms']:.3f}), the plain clip's norm "
          f"{norm['plain_ms']:.3f} ms [{card}]")
    return out


def captured_train_compare(dev, card, arch: str = "llama3.2-1b",
                           layers: int | None = None,
                           steps: int = CAPTURED_STEPS) -> dict:
    """``arch``'s train step at published width, cut to ``layers`` (B 8 x
    S 256, its config's remat and optimizer: llama3.2-1b "block" and AdamW,
    deepseek-v3-671b Adafactor), ``steps`` steps captured in one CUDA graph
    (``CapturedTrainStep``: the warm-up and replays) against as many eager
    steps, from the same state and batches, under deterministic
    algorithms: each step's loss, grad_norm and lr bit-equal; the final
    parameters and optimizer state bit-equal (``state_digests``); launches
    per replay equal to the eager step's, both ``train_launches``.  Prints
    ms a step (host clock, each ending in ``synchronize``; the steps after
    the first), the captured step's idle share over one traced replay, and
    the caching allocator's peak allocated and reserved bytes of each
    run."""
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import (
        CapturedTrainStep,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    t0 = time.perf_counter()
    cfg = configs.get(arch)
    if layers is not None:
        cfg = configs.cut_depth(cfg, layers)
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    states = {"eager": {"params": params, "opt": opt.init(params)}}
    states["captured"] = tree_map(lambda t: t.clone(), states["eager"])
    del params
    pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=SEED)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
               for i in range(steps)]
    kw = dict(peak_lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    want = train_launches(cfg)
    rec = {}
    with deterministic():
        for kind in ("eager", "captured"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = (make_train_step(model, opt, impl="auto", **kw)
                    if kind == "eager" else
                    CapturedTrainStep(model, opt, device=dev, **kw))
            r = rec[kind] = dict(metrics=[], ms=[], launches=[])
            state = states[kind]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            for b in batches:
                reset_all()
                t1 = time.perf_counter()
                if kind == "eager":
                    b = {k: v.to(dev) for k, v in b.items()}
                state, m = step(state, b)
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t1) * 1e3)
                r["metrics"].append([float(m[k]) for k in ("loss",
                                                           "grad_norm",
                                                           "lr")])
                r["launches"].append(
                    {k: v for k, v in all_launches().items() if v})
            r.update(peak_allocated=torch.cuda.max_memory_allocated(),
                     peak_reserved=torch.cuda.max_memory_reserved(),
                     held=held, peak_above_held=(
                         torch.cuda.max_memory_allocated() - held),
                     ms_median=statistics.median(r["ms"][1:]),
                     ms_min=min(r["ms"][1:]))
            if kind == "captured":
                digests = state_digests(state)
                replay = {k: v for k, v in step.call.launches.items() if v}
                r["launches_a_replay"] = replay
                # one more replay, traced (the state moves past the check's)
                busy, n_act, _ = device_profile(
                    lambda: step(state, batches[0]))
                r.update(busy_us=busy, activities=n_act,
                         idle_share=max(0.0, 1 - busy / (
                             r["ms_median"] * 1e3)))
                del step
            else:
                digests_eager = state_digests(state)
            states[kind] = None
            del state
    e, c = rec["eager"], rec["captured"]
    check(all(x == want for x in e["launches"]),
          f"the eager steps launched {e['launches']}, a step needs {want}")
    check(c["launches_a_replay"] == want and all(
        x == want for x in c["launches"]),
          f"a replay of the captured step launches "
          f"{c['launches_a_replay']} ({c['launches']} a call), the eager "
          f"step {want}")
    check(c["metrics"] == e["metrics"],
          f"the captured steps' (loss, grad_norm, lr) {c['metrics']} are "
          f"not the eager steps' {e['metrics']}")
    check(digests == digests_eager, "the captured steps' final parameters "
                                    "and optimizer state are not bit-equal "
                                    "to the eager steps'")
    rec.update(arch=arch, layers=cfg.n_layers, steps=steps, bit_equal=True,
               seconds=time.perf_counter() - t0)
    say(f"train: {arch} at published width, {cfg.n_layers} layers (B "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ}, remat {cfg.remat!r}, "
        f"{type(opt).__name__}, deterministic "
        f"algorithms): {steps} captured steps (the warm-up and "
        f"{steps - 1} replays) bit-equal to {steps} eager "
        f"steps in loss, grad_norm and lr {e['metrics']} and in all "
        f"{len(digests)} leaves of the final state; launches a replay "
        f"{c['launches_a_replay']} = the eager step's; ms a step "
        f"(median / min of steps 2-{steps}) captured "
        f"{c['ms_median']:.2f} / {c['ms_min']:.2f}, eager "
        f"{e['ms_median']:.2f} / {e['ms_min']:.2f} (first steps "
        f"{c['ms'][0]:.1f} captured incl. the capture, {e['ms'][0]:.1f} "
        f"eager); a traced replay: device busy {c['busy_us']:.1f} us, "
        f"idle share {c['idle_share']:.4f}; peak allocated / reserved "
        f"captured {c['peak_allocated']} / {c['peak_reserved']} B, "
        f"{c['peak_above_held']} above its state's {c['held']}; eager "
        f"{e['peak_allocated']} / {e['peak_reserved']} B, "
        f"{e['peak_above_held']} above the {e['held']} held (its state "
        f"and the captured run's copy); "
        f"{rec['seconds']:.1f} s [{card}]")
    return rec


def phase_train(dev, card, err, control, wkv6_control, optim_controls,
                adafactor_controls) -> tuple[list, dict, FleetRuns]:
    """The train path: the backward kernels against their plain versions
    (llama3.2-1b's heads; the RG-LRU backward and Griffin's windowed (256,
    256) heads), one full-width llama3.2-1b step through the kernels
    against the plain versions, the step's time and memory, the CLI's run
    with a checkpoint and its bit-equal replay, the flash kernels' times
    at the step's shape; then recurrentgemma-2b's training at full width
    (``family_train``) and the new kernels' times at its shapes; then the
    WKV-6 backward against its plain version (``check_wkv6_backward``),
    rwkv6-7b's training at published width, its depth cut (``family_train``)
    and the backward's time; then the dense and MoE decoders
    (``decoders_train``: the flash backward at (128, 128), starcoder2-7b,
    granite-moe-3b-a800m and gemma-7b trained, granite-20b's and
    chameleon-34b's gradients); then the last two families
    (``last_families_train``: the flash backward non-causal and at (192,
    128), seamless-m4t-medium and deepseek-v3-671b trained).  ``control`` and ``wkv6_control`` are the
    RG-LRU's and the WKV-6's control backwards.  Returns (the
    flash_backward, rglru_backward and wkv6_backward rows of the kernels
    JSON, the phase's record)."""
    global CLI_QUEUE
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    # every family's CLI and resume waits for the CLI block at the end
    CLI_QUEUE = []
    optim = check_optim_kernels(dev, card, optim_controls)
    part("the optimizer kernels' checks and times")
    t_ada = time.perf_counter()
    adafactor = check_adafactor_kernels(dev, card, adafactor_controls)
    adafactor["captured"] = captured_train_compare(
        dev, card, arch=DEEPSEEK, layers=DEEPSEEK_CLI_LAYERS,
        steps=ADAFACTOR_CAPTURED_STEPS)
    adafactor["block_seconds"] = time.perf_counter() - t_ada
    say(f"train: the Adafactor block took {adafactor['block_seconds']:.1f} s"
        f" [{card}]")
    part("the Adafactor kernels and deepseek's captured step")
    captured = captured_train_compare(dev, card)
    part("llama's captured step")
    worst = check_flash_backward(dev)
    err["flash_backward"] = worst["max_abs_err"]
    part("llama's backward checks")
    rglru_bwd = check_rglru_backward(dev, control)
    griffin_bwd = check_flash_backward_griffin(dev)
    err["flash_backward"] = max(err["flash_backward"],
                                griffin_bwd["max_abs_err"])
    part("Griffin's kernel checks")
    model, opt, state, batch, rec = train_step_compare(dev, card)
    rec.update(optim=optim, captured=captured)
    rec["step"] = time_train_step(model, opt, state, batch, card)
    rec["remat"] = remat_compare(model, opt, state, batch, card)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    part("llama's steps, timing, remat")
    CLI_QUEUE.append((LLAMA_CLI, rec))
    flash = time_train_flash(dev, card)
    rec["flash"] = flash
    part("llama's kernel times")
    rec["griffin"] = griffin = family_train(GRIFFIN_TRAIN, dev, card, control)
    part("Griffin's training")
    gk = time_griffin_kernels(dev, card)
    rec["griffin"]["kernels"] = gk
    part("Griffin's kernel times")
    t_rwkv = time.perf_counter()
    wkv6_bwd = check_wkv6_backward(dev, wkv6_control)
    part("the WKV-6 backward's checks")
    rec["rwkv6"] = rwkv = family_train(RWKV_TRAIN, dev, card,
                                       wkv6_control)
    part("RWKV-6's training")
    wt = time_rwkv_kernels(dev, card)
    rwkv["kernel"] = wt
    part("the WKV-6 backward's time")
    rwkv["block_seconds"] = time.perf_counter() - t_rwkv
    say(f"train: the RWKV-6 block took {rwkv['block_seconds']:.1f} s "
        f"[{card}]")
    rec["decoders"] = dec = decoders_train(dev, card)
    err["flash_backward"] = max(err["flash_backward"],
                                dec["d128_checks"]["max_abs_err"])
    part("the dense and MoE decoders")
    rec["last"] = last = last_families_train(dev, card)
    err["flash_backward"] = max(err["flash_backward"],
                                *(c["max_abs_err"]
                                  for c in last["checks"].values()))
    part("the last two families")
    # the CLI block: each family's CLI and its resume on the captured step,
    # the fleet's host runs (phase 13) beside it in processes of their own
    fleet = FleetRuns()
    queue, CLI_QUEUE = CLI_QUEUE, None
    try:
        for fam, r in queue:
            r["cli"] = family_cli(fam, dev, card)
    except BaseException:
        fleet.cancel()
        raise
    part("the CLI block (8 families' CLI and resume, the fleet's host runs "
         "beside it)")
    rec["parts_s"] = parts
    b = flash["backward"]
    routes = rec["cli"]["backward_routes"]
    row = dict(
        name="flash_backward", route="cuda",
        source="src/repro_torch/csrc/flash_backward_sm90.cu",
        replaces="src/repro/kernels/flash_attention/ops.py:77",
        replaces_note="no TPU kernel: jax.grad of _flash_xla",
        launches=rec["cli"]["launches"]["flash_backward"],
        max_abs_err=err["flash_backward"], ms=b["ms"],
        plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
        bound_by=b["bound_by"], library_ms=b["library_ms"],
        simple_ms=b["simple_ms"],
        routes={"sm90": dict(
                    source="src/repro_torch/csrc/flash_backward_sm90.cu",
                    launches=routes["sm90"], ms=b["ms"],
                    turns_ms=b["turns_ms"]["kernel"]),
                "simple": dict(
                    source="src/repro_torch/csrc/flash_backward.cu",
                    launches=routes["simple"], ms=b["simple_ms"],
                    turns_ms=b["turns_ms"]["simple"])},
        errors=worst, forward_at_train_shape=flash["forward"],
        griffin=dict(
            launches=griffin["cli"]["launches"]["flash_backward"],
            launches_a_step=griffin["step_launches"]["flash_backward"],
            errors=griffin_bwd,
            shapes={k: v for k, v in gk.items() if k != "rglru_backward"}),
        d128=dict(errors=dec["d128_checks"], shapes=dec["d128_times"]),
        decoders={fam["arch"]: dict(
            launches=dec[fam["arch"]]["cli"]["launches"]["flash_backward"],
            launches_a_step=dec[fam["arch"]]["step_launches"][
                "flash_backward"])
            for fam in DECODER_TRAINS},
        new_forms=dict(errors=last["checks"], shapes=last["times"]),
        last_families={fam["arch"]: dict(
            launches=last[fam["arch"]]["cli"]["launches"]["flash_backward"],
            launches_a_step=last[fam["arch"]]["step_launches"][
                "flash_backward"])
            for fam in LAST_TRAINS})
    g = gk["rglru_backward"]
    rg_row = dict(
        name="rglru_backward", route="cuda",
        source="src/repro_torch/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru/ops.py:34",
        replaces_note="no TPU kernel: jax.grad of the xla associative scan",
        launches=griffin["cli"]["launches"]["rglru_backward"],
        launches_a_step=griffin["step_launches"]["rglru_backward"],
        max_abs_err=rglru_bwd["max_abs_err"], ms=g["ms"],
        plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
        bound_by=g["bound_by"], library_ms=None, shape=g["shape"],
        errors=rglru_bwd)
    wk_row = dict(
        name="wkv6_backward", route="cuda",
        source="src/repro_torch/csrc/wkv6_backward.cu",
        replaces="src/repro/kernels/rwkv6/ops.py:30",
        replaces_note="no TPU kernel: jax.value_and_grad of wkv6_ref's "
                      "scan (impl='xla')",
        launches=rwkv["cli"]["launches"]["wkv6_backward"],
        launches_a_step=rwkv["step_launches"]["wkv6_backward"],
        max_abs_err=wkv6_bwd["max_abs_err"], ms=wt["ms"],
        plain_ms=wt["plain_ms"], bound_ms=wt["bound_ms"],
        bound_by=wt["bound_by"], library_ms=None, shape=wt["shape"],
        errors=wkv6_bwd)
    optim_rows = [dict(
        name=k, route="cuda", source=OPTIM_SOURCE, replaces=OPTIM_REPLACES,
        replaces_note=OPTIM_NOTE, launches=rec["cli"]["launches"][k],
        launches_a_step=rec["step_launches"][k],
        launches_a_replay=captured["captured"]["launches_a_replay"][k],
        max_abs_err=(max(optim[s]["sumsq_max_abs_err"]
                         for s in ("ragged", "llama"))
                     if k == "sumsq" else 0.0),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library_note="timing reference only, not repro's math: "
        + ("torch._foreach_norm of the gradients" if k == "sumsq" else
           "one step of torch.optim.AdamW(fused=True), its moments bf16 "
           "and its weight decay applied before the update"),
        shape=t["shape"], errors={s: optim[s] for s in ("ragged", "llama")})
        for k, t in optim["times"].items()]
    ds = last[DEEPSEEK]
    at = adafactor["times"]
    ada_rows = [dict(
        name=k, route="cuda", source=ADAFACTOR_SOURCE,
        replaces=ADAFACTOR_REPLACES, replaces_note=ADAFACTOR_NOTE,
        launches=ds["cli"]["launches"][k],
        launches_a_step=ds["step_launches"][k],
        launches_a_replay=adafactor["captured"]["captured"][
            "launches_a_replay"][k],
        max_abs_err=max(adafactor[s]["max_abs_err"][
            "moments" if k == "adafactor_sums" else "params"]
            for s in ("ragged", "deepseek")),
        ms=at[k]["ms"], plain_ms=at[k]["plain_ms"],
        plain_note="the whole plain update (ref.adafactor_update_torch), "
                   "which the three kernels replace together",
        bound_ms=at[k]["bound_ms"], bound_by=at[k]["bound_by"],
        library_ms=at[k]["library_ms"], library_note=at[k]["library_note"],
        shape=at[k]["shape"], together=at["adafactor"],
        errors={s: adafactor[s] for s in ("ragged", "deepseek")})
        for k in ADAFACTOR_KERNELS]
    for r in optim_rows:
        if r["name"] == "sumsq":
            r["deepseek"] = at["sumsq"]
    rec["adafactor"] = adafactor
    rec["seconds"] = time.perf_counter() - t0
    say(f"train: phase done in {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]")
    return [row, rg_row, wk_row, *optim_rows, *ada_rows], rec, fleet


# ------------------------------------------------------------ 14. parallel

PAR_REQ, PAR_PROMPT, PAR_GEN = 4, 16, 16      # llama served under rules
PAR_EP_REQ, PAR_EP_PROMPT, PAR_EP_GEN = 2, 8, 8
PAR_TRAIN_STEPS = 2
PAR_MEM_RTOL = 0.01                 # peak memory, sharded vs unsharded


@contextlib.contextmanager
def deterministic():
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def par_serve(model, params, reqs, smax, dev, rules=None) -> dict:
    """``run_server`` of ``reqs`` (serial mode), the kernels' launches
    counted from 0, the allocator's peak from a reset, ms per token."""
    from repro_torch.launch.serve import run_server

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    t0 = time.perf_counter()
    m = run_server(model, params, reqs, smax=smax, budget_bytes=1 << 34,
                   rules=rules, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(m["n_served"] == len(reqs), f"served {m['n_served']} of "
                                      f"{len(reqs)} requests")
    return dict(tokens=[list(r.tokens) for r in reqs],
                launches={k: v for k, v in all_launches().items() if v},
                peak_bytes=torch.cuda.max_memory_allocated(),
                ms_per_token=1e3 * wall / m["n_tokens"],
                n_tokens=m["n_tokens"])


def par_decode(model, params, sharded, prompt, dev, rules) -> dict:
    """Prefill and PAR_GEN - 1 greedy decode steps of one prompt, three
    ways: with ``params`` unsharded through the captured step (as the
    server decodes) and eagerly, with ``sharded`` (the same weights as
    DTensors) eagerly under ``rules``.  Returns whether each step's logits
    under rules are bit-equal to the captured step's, and each way's ms a
    decode step (host clock ending in ``synchronize``; median over the
    steps after the first, which captures or warms up)."""
    from repro_torch.launch.steps import (
        make_captured_decode_step,
        place_state,
    )
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.sharding import full

    smax = len(prompt) + PAR_GEN
    batch = prefill_batch(model, prompt, dev)
    defs = model.make_cache_defs(1, smax)

    def run(p, r, captured):
        lg, cache = model.prefill_fn(
            p, place_state(model.init_cache(1, smax, dev), defs, r), batch,
            rules=r)
        step = None
        if captured:
            step = make_captured_decode_step(model, p, smax=smax, device=dev)
            for a, b in zip(tree_leaves(step.cache), tree_leaves(cache)):
                a.copy_(b)
        outs, ms = [full(lg).clone()], []
        for s in range(PAR_GEN - 1):
            tok = int(torch.argmax(outs[-1], -1)[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if captured:
                lg = step(tok, len(prompt) + s)
            else:
                t = torch.full((1, 1), tok, dtype=torch.long, device=dev)
                lg, cache = model.decode_fn(p, cache, t, len(prompt) + s,
                                            rules=r)
            lg = full(lg).clone()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            outs.append(lg)
        return outs, statistics.median(ms[1:])

    with torch.no_grad():
        ref, ms_cap = run(params, None, True)
        eager, ms_eager = run(params, None, False)
        got, ms_rules = run(sharded, rules, False)
    return dict(equal=[bool(torch.equal(a, b)) for a, b in zip(got, ref)],
                eager_equal=all(torch.equal(a, b)
                                for a, b in zip(eager, ref)),
                ms_captured=ms_cap, ms_eager=ms_eager, ms_rules=ms_rules)


def par_serving(dev, card, rules, mesh) -> dict:
    """(a) llama3.2-1b at its published width, weights from SEED placed by
    ``distribute_params``: served unsharded (the captured step) and under
    rules (eager), tokens, logits and launches equal, peak memory within
    PAR_MEM_RTOL."""
    import repro_torch.configs as configs
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models.params import distribute_params, tree_map
    from repro_torch.models.zoo import build_model

    cfg = configs.get("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    reqs = lambda: synth_requests(PAR_REQ, PAR_PROMPT, PAR_GEN,
                                  cfg.vocab_size, SEED + 1)
    smax = PAR_PROMPT + PAR_GEN
    ref = par_serve(model, params, reqs(), smax, dev)
    sp = distribute_params(params, model.defs, rules, mesh)
    del params
    got = par_serve(model, sp, reqs(), smax, dev, rules)
    say(f"parallel: serving under rules: {got['ms_per_token']:.2f} ms/token,"
        f" launches {got['launches']}, peak {got['peak_bytes']} B; "
        f"unsharded: {ref['ms_per_token']:.2f}, {ref['launches']}, "
        f"{ref['peak_bytes']} B [{card}]")
    check(got["tokens"] == ref["tokens"],
          f"llama3.2-1b served under rules: tokens {got['tokens']} != the "
          f"unsharded server's {ref['tokens']}")
    for k in ("flash_decode", "flash_prefill", "write", "read"):
        check(got["launches"].get(k, 0) == ref["launches"].get(k, 0) > 0,
              f"{k}: {got['launches'].get(k, 0)} launches under rules, "
              f"{ref['launches'].get(k, 0)} unsharded")
    check(got["launches"] == ref["launches"],
          f"launches under rules {got['launches']} != unsharded "
          f"{ref['launches']}")
    mem = got["peak_bytes"] / ref["peak_bytes"] - 1.0
    check(abs(mem) <= PAR_MEM_RTOL,
          f"peak memory under rules {got['peak_bytes']} B vs unsharded "
          f"{ref['peak_bytes']} B ({100 * mem:+.2f}%, limit "
          f"{100 * PAR_MEM_RTOL}%)")
    prompt = np.asarray(reqs()[0].prompt)
    # at world size 1 each DTensor's shard is the whole weight
    plain = tree_map(lambda t: t.to_local(), sp)
    dec = par_decode(model, plain, sp, prompt, dev, rules)
    check(all(dec["equal"]), f"logits under rules bit-equal to the "
                             f"captured unsharded step's at steps "
                             f"{dec['equal']}")
    say(f"parallel: llama3.2-1b served at world size 1 under rules "
        f"({PAR_REQ} x {PAR_PROMPT} + {PAR_GEN}): tokens equal, "
        f"{len(dec['equal'])} steps' logits bit-equal, launches "
        f"{got['launches']} = unsharded; served ms/token (the run's wall "
        f"over its tokens) {got['ms_per_token']:.2f} eager under rules vs "
        f"{ref['ms_per_token']:.2f} captured unsharded; ms a decode step "
        f"(median) {dec['ms_rules']:.2f} eager under rules, "
        f"{dec['ms_eager']:.2f} eager unsharded, {dec['ms_captured']:.2f} "
        f"captured; peak {got['peak_bytes']} B vs {ref['peak_bytes']} B "
        f"[{card}]")
    return dict(launches=got["launches"], ms_per_token=got["ms_per_token"],
                ms_per_token_unsharded=ref["ms_per_token"],
                ms_decode_step=dict(rules=dec["ms_rules"],
                                    eager=dec["ms_eager"],
                                    captured=dec["ms_captured"]),
                eager_bit_equal_to_captured=dec["eager_equal"],
                peak_bytes=got["peak_bytes"],
                peak_bytes_unsharded=ref["peak_bytes"],
                logits_bit_equal_steps=len(dec["equal"]),
                n_tokens=got["n_tokens"])


def par_training(dev, card, rules, mesh, arch: str = "llama3.2-1b",
                 layers: int | None = None) -> dict:
    """(b) PAR_TRAIN_STEPS train steps of ``arch`` at published width, cut
    to ``layers`` (batch TRAIN_BATCH x seq TRAIN_SEQ), under rules against
    the unsharded steps from the same state, both under deterministic
    algorithms: loss, grad_norm and the updated parameters and optimizer
    state bit-equal, the launches exactly ``train_launches`` each
    (llama3.2-1b: 32 forward, 16 backward a step, remat "block"; an
    Adafactor config's moments in two launches under rules, the fused one
    unsharded)."""
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.params import (
        distribute_params,
        tree_leaves,
        tree_map,
    )
    from repro_torch.models.zoo import build_model

    cfg = configs.get(arch)
    if layers is not None:
        cfg = configs.cut_depth(cfg, layers)
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}
               for i in range(PAR_TRAIN_STEPS)]
    kw = dict(peak_lr=3e-4, warmup=1, total_steps=10)
    sh = tree_map(lambda t: t.clone(), params)
    out, launches, ms = {}, {}, {}
    with deterministic():
        for name, r in (("unsharded", None), ("rules", rules)):
            if r is None:
                state = {"params": params, "opt": opt.init(params)}
            else:
                state = {"params": distribute_params(sh, model.defs, r, mesh),
                         "opt": distribute_params(opt.init(sh),
                                                  opt.state_defs(model.defs),
                                                  r, mesh)}
            step = make_train_step(model, opt, r, impl="auto", **kw)
            reset_all()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms_ = []
            for b in batches:
                t1 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                ms_.append(1e3 * (time.perf_counter() - t1))
            launches[name] = {k: v for k, v in all_launches().items() if v}
            ms[name] = ms_
            out[name] = (m, state)
            del state, step
    del params, sh
    (m0, s0), (m1, s1) = out["unsharded"], out["rules"]
    want = {"unsharded": train_launches(cfg, PAR_TRAIN_STEPS),
            "rules": train_launches(cfg, PAR_TRAIN_STEPS, rules=True)}
    say(f"parallel: {arch}'s train launches under rules {launches['rules']},"
        f" unsharded {launches['unsharded']}; ms/step {ms} [{card}]")
    check(launches == want,
          f"{arch}'s train launches under rules {launches['rules']}, "
          f"unsharded {launches['unsharded']}, the paths need {want}")
    for k in ("loss", "grad_norm", "lr"):
        check(torch.equal(m0[k], m1[k]), f"{arch}'s train {k} under rules "
                                          f"{float(m1[k])} != {float(m0[k])}")
    same = all(torch.equal(a, b.full_tensor())
               for a, b in zip(tree_leaves(s0), tree_leaves(s1)))
    check(same, f"{arch}'s train state after the steps under rules is not "
                f"bit-equal to the unsharded one")
    say(f"parallel: {PAR_TRAIN_STEPS} {arch} train steps ({cfg.n_layers} "
        f"layers, {type(opt).__name__}, batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}) under rules: loss "
        f"{float(m1['loss'])}, grad_norm {float(m1['grad_norm'])}, state "
        f"bit-equal to unsharded; launches {launches['rules']}; ms/step "
        f"{[round(x, 1) for x in ms['rules']]} under rules, "
        f"{[round(x, 1) for x in ms['unsharded']]} unsharded [{card}]")
    return dict(arch=arch, layers=cfg.n_layers, launches=launches["rules"],
                launches_unsharded=launches["unsharded"],
                ms_per_step=ms["rules"],
                ms_per_step_unsharded=ms["unsharded"],
                loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]))


def par_expert_parallel(dev, card, rules, mesh) -> dict:
    """(c) granite-moe-3b-a800m at its published width: the
    expert-parallel MoE (``moe_impl="ep_shardmap"``) served under rules
    gives the scatter form's tokens (unsharded): at a 1 x 1 mesh the
    dispatch is the same."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.kernels import _local
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models.params import distribute_params
    from repro_torch.models.zoo import build_model

    cfg = configs.get(MOE_ARCH)
    model = build_model(cfg)
    ep = build_model(dataclasses.replace(cfg, moe_impl="ep_shardmap"))
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    reqs = lambda: synth_requests(PAR_EP_REQ, PAR_EP_PROMPT, PAR_EP_GEN,
                                  cfg.vocab_size, SEED + 2)
    smax = PAR_EP_PROMPT + PAR_EP_GEN
    ref = par_serve(model, params, reqs(), smax, dev)
    calls = _local.LOCAL_CALLS["moe_ep"]
    got = par_serve(ep, distribute_params(params, model.defs, rules, mesh),
                    reqs(), smax, dev, rules)
    n_ep = _local.LOCAL_CALLS["moe_ep"] - calls
    check(n_ep > 0, "the expert-parallel MoE was never called")
    check(got["tokens"] == ref["tokens"],
          f"{MOE_ARCH} ep_shardmap tokens {got['tokens']} != scatter's "
          f"{ref['tokens']}")
    say(f"parallel: {MOE_ARCH} ep_shardmap under rules ({PAR_EP_REQ} x "
        f"{PAR_EP_PROMPT} + {PAR_EP_GEN}): tokens equal the scatter "
        f"form's, {n_ep} expert-parallel layer calls; "
        f"{got['ms_per_token']:.2f} ms/token vs {ref['ms_per_token']:.2f} "
        f"[{card}]")
    return dict(moe_ep_calls=n_ep, ms_per_token=got["ms_per_token"],
                ms_per_token_scatter=ref["ms_per_token"])


def par_psum(dev, mesh) -> dict:
    """(d) ``compressed_psum`` at world size 1 bit-equal to quantize then
    dequantize, on a random bf16 tensor of llama3.2-1b's largest leaf."""
    import math as _m

    import repro_torch.configs as configs
    from repro_torch.models.params import is_def, tree_leaves
    from repro_torch.models.zoo import build_model
    from repro_torch.optim.grad_compress import (
        compressed_psum,
        dequantize,
        quantize,
    )

    defs = tree_leaves(build_model(configs.get("llama3.2-1b")).defs,
                       is_leaf=is_def)
    big = max(defs, key=lambda d: _m.prod(d.shape))
    g = torch.randn(big.shape, generator=torch.Generator(device=dev)
                    .manual_seed(SEED), device=dev).to(torch.bfloat16)
    got = compressed_psum(g, (mesh, "data"))
    want = dequantize(*quantize(g)).to(torch.bfloat16)
    check(torch.equal(got, want), "compressed_psum at world size 1 is not "
                                  "quantize-then-dequantize")
    return dict(shape=list(big.shape), bit_equal=True)


def phase_parallel(dev, card) -> dict:
    """Phase 14: the sharded path at world size 1 (NCCL over an in-process
    store, a 1 x 1 mesh, ``rules_for_mesh``).  Returns its record."""
    from repro_torch.launch.mesh import (
        init_single_process,
        make_host_mesh,
        rules_for_mesh,
    )

    t0 = time.perf_counter()
    init_single_process(dev)
    try:
        mesh = make_host_mesh(1, 1, device=dev)
        rules = rules_for_mesh(mesh)
        rec = dict(serve=par_serving(dev, card, rules, mesh))
        gc.collect()
        torch.cuda.empty_cache()
        rec["train"] = par_training(dev, card, rules, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        # Adafactor's split route (the moments' raw sums, their reduction,
        # the moments): deepseek-v3-671b at its CLI's depth
        rec["train_adafactor"] = par_training(
            dev, card, rules, mesh, arch=DEEPSEEK, layers=DEEPSEEK_CLI_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        rec["ep"] = par_expert_parallel(dev, card, rules, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        rec["psum"] = par_psum(dev, mesh)
    finally:
        torch.distributed.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    say(f"parallel: phase done in {rec['seconds']:.1f} s [{card}]")
    return rec


# Phase 15: the dry-run (launch/dryrun.py).  (d)'s cells run in a process
# each on the card's routes, over a fake 256-rank group, while (a)-(c) run
# here: llama3.2-1b's train step (the train phase's batch) and one eager
# decode step at DRYRUN_POS of a DRYRUN_SMAX cache, full width, unsharded
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("deepseek-v3-671b", "decode_32k"))
DRYRUN_RSS_BYTES = 8 << 30
DRYRUN_SMAX, DRYRUN_POS = 1056, 1055
DRYRUN_TIMEOUT_S = 240


def dryrun_start(out_dir: Path) -> list:
    """(d): the dry-run's CLI for each of DRYRUN_CELLS on the single pod,
    one process each, started together; its log beside its record."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(out_dir / f"{arch}__{shape}.log", "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out",
             str(out_dir)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(SRC)))))
    return procs


def dryrun_wait(procs, deadline: float) -> dict:
    """Wait for (d)'s processes (killed at ``deadline``); returns {(arch,
    shape): (exit code, seconds)}."""
    out, t0 = {}, time.perf_counter()
    try:
        for arch, shape, log, p in procs:
            while p.poll() is None:
                check(time.perf_counter() < deadline,
                      f"dryrun: the CLI for {arch} {shape} is still running "
                      f"after {DRYRUN_TIMEOUT_S} s")
                time.sleep(0.2)
            out[arch, shape] = (p.returncode, time.perf_counter() - t0)
    finally:
        for _, _, log, p in procs:
            if p.returncode is None:
                p.kill()
                p.wait()
            log.close()
    return out


def dryrun_count(step, args, fake=None):
    """One call of ``step(*args)`` under the dry-run's counting mode
    (``fake``: in that FakeTensorMode too); returns its counts."""
    from repro_torch.launch.dryrun import CostMode
    mode = CostMode(fake)
    mode.arguments(args)
    with contextlib.ExitStack() as stack:
        if fake is not None:
            stack.enter_context(fake)
        stack.enter_context(mode)
        step(*args)
    return dict(launches=mode.launches(), kernels=mode.kernels,
                flops=dict(mode.flops), bytes=mode.bytes,
                collective_bytes=mode.collectives()["total_bytes"],
                peak=mode.peak)


def dryrun_train(dev, card, cfg) -> dict:
    """A train step of ``cfg`` (the recurrent mixing leaves filled), batch
    2 x TRAIN_SEQ, counted on real tensors and on fake CUDA tensors: equal
    launches, FLOPs and bytes, the real count equal to ``LAUNCHES``' delta
    and to ``train_launches``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    live_leaves(cfg, params, dev)
    state = {"params": params, "opt": opt.init(params)}
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED))
    step = make_train_step(model, opt, impl="auto", peak_lr=3e-4,
                           warmup=10, total_steps=TRAIN_STEPS)
    args = (state, {"tokens": tokens})
    reset_all()
    real = dryrun_count(step, args)
    torch.cuda.synchronize()
    got = {k: v for k, v in all_launches().items() if v}
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    reset_all()
    fargs = tree_map(fake.from_tensor, args)
    faked = dryrun_count(step, fargs, fake)
    want = train_launches(cfg)
    same = ("launches", "kernels", "flops", "bytes")
    check(real["launches"] == got == want,
          f"dryrun: {cfg.name}'s train step counted {real['launches']}, the "
          f"kernels launched {got}, its path needs {want}")
    check(all(faked[k] == real[k] for k in same)
          and not any(all_launches().values()),
          f"dryrun: {cfg.name}'s train step on fake tensors "
          f"{faked['launches']} differs from the real one "
          f"{real['launches']}, or launched {all_launches()}")
    say(f"dryrun: {cfg.name}'s train step at {cfg.n_layers} layers (B 2 x S "
        f"{TRAIN_SEQ}): launches {real['launches']} on real and on fake "
        f"CUDA tensors, flops {real['flops']}, bytes {real['bytes']} equal "
        f"[{card}]")
    return dict(launches=real["launches"], kernels=real["kernels"],
                flops=real["flops"], bytes=real["bytes"])


def dryrun_griffin(dev, card) -> dict:
    """(e) recurrentgemma-2b's train step at its published width and the
    smoke config's depth (4 layers: a group and a tail rec layer; the
    smoke width's head dim 32 has no backward kernel), its window cut to
    64 so that it bites at S 256, by ``dryrun_train`` (the RG-LRU forward
    and backward and the windowed flash backward among its launches)."""
    import dataclasses

    import repro_torch.configs as configs
    cfg = dataclasses.replace(configs.get(GRIFFIN),
                              n_layers=configs.smoke(GRIFFIN).n_layers,
                              local_window=64)
    return dryrun_train(dev, card, cfg)


def dryrun_rwkv6(dev, card) -> dict:
    """(f) rwkv6-7b's train step at its published width and RWKV_CLI_LAYERS
    deep, by ``dryrun_train`` (the WKV-6 forward and backward)."""
    import repro_torch.configs as configs
    return dryrun_train(dev, card, configs.cut_depth(configs.get(RWKV),
                                                     RWKV_CLI_LAYERS))


def phase_dryrun(dev, card, procs=None, started=None) -> dict:
    """Phase 15: the dry-run.  (a) llama3.2-1b's train step and an eager
    decode step, full width, unsharded, on real tensors under the counting
    mode: each kernel's counted launches equal its ``LAUNCHES`` delta; (b)
    the same steps on fake CUDA tensors: launches, FLOPs, bytes and
    collective bytes equal (a)'s, and neither ``memory_allocated`` nor
    ``LAUNCHES`` moves; (c) the modelled ``t_compute`` no more than the
    measured step; (d) the CLI's cells of DRYRUN_CELLS on the card's routes
    over a fake 256-rank group (started first, in processes of their own):
    exit 0, records written, max RSS under DRYRUN_RSS_BYTES, llama's train
    record 32 ``flash_prefill`` and 16 ``flash_backward`` a device; (e)
    ``dryrun_griffin``; (f) ``dryrun_rwkv6``.  ``procs``: (d)'s processes
    where the caller started them (``dryrun_start``, at ``started`` on the
    host clock), else they start here.  Returns its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import costs as C
    from repro_torch.launch.steps import (
        make_decode_step,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model

    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "dryrun"
    if procs is None:
        procs, started = dryrun_start(out_dir), t0
    try:
        cfg = configs.get("llama3.2-1b")
        model = build_model(cfg)
        opt = make_optimizer(cfg, lr=3e-4)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            dev)
        state = {"params": params, "opt": opt.init(params)}
        pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(0).items()}
        cache = model.init_cache(1, DRYRUN_SMAX, dev)
        tokens = torch.ones((1, 1), dtype=torch.long, device=dev)
        train = make_train_step(model, opt, impl="auto", peak_lr=3e-4,
                                warmup=10, total_steps=TRAIN_STEPS)
        decode = make_decode_step(model, impl="auto")

        def decode_step(params, cache, tokens):
            with torch.no_grad():
                decode(params, cache, tokens, DRYRUN_POS)

        steps = {"train": (train, (state, batch)),
                 "decode": (decode_step, (params, cache, tokens))}
        for fn, args in steps.values():  # what the first call caches
            fn(*args)
        torch.cuda.synchronize()
        parts = {"set-up": time.perf_counter() - t0}
        # (a) real tensors, each count against the kernels' own, and the
        # counted peak beside the allocator's
        real, peaks = {}, {}
        for name, (fn, args) in steps.items():
            reset_all()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            real[name] = dryrun_count(fn, args)
            torch.cuda.synchronize()
            alloc_peak = torch.cuda.max_memory_allocated() - base
            got = {k: v for k, v in all_launches().items() if v}
            check(real[name]["launches"] == got,
                  f"dryrun: the counting mode saw {real[name]['launches']} "
                  f"launches in the {name} step, the kernels counted {got}")
            say(f"dryrun: the {name} step's peak above its arguments: "
                f"counted {real[name]['peak']} B, the allocator's "
                f"{alloc_peak} B [{card}]")
            peaks[name] = dict(counted=real[name]["peak"],
                               allocator=alloc_peak)
        want = dict(train_launches(cfg), flash_decode=0)
        check(real["train"]["launches"] == {k: v for k, v in want.items()
                                            if v},
              f"dryrun: the train step launched {real['train']['launches']}, "
              f"its path needs {want}")
        check(real["decode"]["launches"] == {"flash_decode": cfg.n_layers},
              f"dryrun: the decode step launched "
              f"{real['decode']['launches']}, its path needs "
              f"{cfg.n_layers} flash_decode")
        parts["real"] = time.perf_counter() - t0 - sum(parts.values())
        # (b) the same steps on fake CUDA tensors
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        reset_all()
        mem = torch.cuda.memory_allocated()
        fakes = {}
        for name, (fn, args) in steps.items():
            fargs = tree_map(fake.from_tensor, args)
            fakes[name] = dryrun_count(fn, fargs, fake)
            del fargs
        moved = torch.cuda.memory_allocated() - mem
        check(moved == 0 and not any(all_launches().values()),
              f"dryrun: the fake steps allocated {moved} B and launched "
              f"{all_launches()} on the card")
        same = ("launches", "kernels", "flops", "bytes", "collective_bytes")
        for name in steps:
            peaks[name]["fake"] = fakes[name]["peak"]
            check(all(fakes[name][k] == real[name][k] for k in same),
                  f"dryrun: the {name} step's counts on fake tensors "
                  f"{fakes[name]} differ from those on real ones "
                  f"{real[name]}")
        parts["fake"] = time.perf_counter() - t0 - sum(parts.values())
        # (c) the modelled compute time against the measured step
        ms = []
        for _ in range(TIMED_STEPS):
            t1 = time.perf_counter()
            train(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        dms = []
        for _ in range(TIMED_STEPS):
            t1 = time.perf_counter()
            decode_step(params, cache, tokens)
            torch.cuda.synchronize()
            dms.append((time.perf_counter() - t1) * 1e3)
        rec = {}
        for name, meas in (("train", ms), ("decode", dms)):
            c = real[name]
            t_c = (c["flops"]["tensor"] / C.BF16_FLOP_PER_S
                   + c["flops"]["cuda_core"] / C.F32_FLOP_PER_S) * 1e3
            t_m = c["bytes"] / C.HBM_BYTES_PER_S * 1e3
            med = statistics.median(meas)
            rec[name] = dict(counts=c, t_compute_ms=t_c, t_memory_ms=t_m,
                             measured_ms_median=med, measured_ms=meas)
            say(f"dryrun: llama3.2-1b {name} step, full width, unsharded: "
                f"launches {c['launches']}, flops {c['flops']}, bytes "
                f"{c['bytes']}; modelled t_compute {t_c:.3f} ms, t_memory "
                f"{t_m:.3f} ms; measured {med:.3f} ms median of "
                f"{len(meas)} (host clock, ending in synchronize); real == "
                f"fake counts [{card}]")
        check(rec["train"]["t_compute_ms"] <= rec["train"]
              ["measured_ms_median"],
              f"dryrun: the modelled t_compute {rec['train']['t_compute_ms']}"
              f" ms exceeds the measured train step "
              f"{rec['train']['measured_ms_median']} ms")
        del state, params, cache, batch, steps
        gc.collect()
        torch.cuda.empty_cache()
        rec["griffin"] = dryrun_griffin(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        rec["rwkv6"] = dryrun_rwkv6(dev, card)
        rec["fake_alloc_bytes"] = moved
        rec["peaks"] = peaks
        parts["timed"] = time.perf_counter() - t0 - sum(parts.values())
        # (d) the CLI's cells
        ran = dryrun_wait(procs, started + DRYRUN_TIMEOUT_S)
        parts["cli wait"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        for *_, p in procs:
            if p.returncode is None:
                p.kill()
                p.wait()
    rec["cli"] = {}
    for (arch, shape), (code, sec) in ran.items():
        path = out_dir / f"{arch}__{shape}__pod16x16__baseline.json"
        check(code == 0 and path.is_file(),
              f"dryrun: the CLI for {arch} {shape} exited {code} "
              f"(log: {out_dir / f'{arch}__{shape}.log'})")
        r = json.loads(path.read_text())
        check(r["applicable"], f"dryrun: {arch} {shape} was skipped: "
                               f"{r.get('skip_reason')}")
        # the process's own peak (``dryrun.PeakRss``): a child's ru_maxrss
        # would count this process's pages, which it held until its exec
        rss = r["host_peak_rss_bytes"]
        check(rss is not None and rss < DRYRUN_RSS_BYTES,
              f"dryrun: the CLI for {arch} {shape} peaked at {rss} B of "
              f"host memory, above {DRYRUN_RSS_BYTES}")
        rec["cli"][f"{arch} {shape}"] = dict(
            seconds=sec, max_rss_bytes=rss, launches=r["launches"],
            kernels=r["kernels"], cost_analysis=r["cost_analysis"],
            memory_analysis=r["memory_analysis"],
            collectives=r["collectives"], roofline=r["roofline"],
            lower_s=r["lower_s"], compile_s=r["compile_s"])
        say(f"dryrun: CLI {arch} {shape} on pod16x16 (card's routes, fake "
            f"256-rank group): exit {code} in {sec:.1f} s, max RSS {rss} B; "
            f"per device: launches {r['launches']}, cost "
            f"{r['cost_analysis']}, memory {r['memory_analysis']}, "
            f"collective bytes {r['collectives']['bytes_by_type']}, "
            f"roofline {r['roofline']} [{card}]")
    llama = rec["cli"]["llama3.2-1b train_4k"]["launches"]
    want = train_launches(configs.get("llama3.2-1b"))
    check(llama == want, f"dryrun: llama3.2-1b train_4k's record counts "
                         f"{llama} launches a device, its path {want}")
    rec["seconds"] = time.perf_counter() - t0
    rec["parts_s"] = parts
    say(f"dryrun: phase done in {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f") [{card}]")
    return rec


def main() -> int:
    t_start = time.perf_counter()
    csrc = SRC / "repro_torch" / "csrc"
    if not all((csrc / f).is_file() for f in (
            "arena.cu", "flash_attention.cu", "flash_decode.cu",
            "flash_prefill_sm90.cu", "flash_backward.cu",
            "flash_backward_sm90.cu", "wkv6.cu", "wkv6_backward.cu",
            "rglru.cu", "adamw.cu", "adafactor.cu")):
        say("FAIL: src/repro_torch not found beside chip_smoke.py; run it "
            "from the root of a checkout")
        return 2
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this check needs a "
            "CUDA card")
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.optim import kernel as OK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rwkv6 import kernel as WK

    def timed_build(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    # one nvcc per source, all started together
    jobs = [K.build, WK.build, WK.build_backward, RK.build, OK.build,
            OK.build_adafactor, build_rglru_control, build_wkv6_control] + [
        (lambda n=n: build_optim_control(n)) for n in OPTIM_CONTROL_EDITS
    ] + [(lambda n=n: build_adafactor_control(n))
         for n in ADAFACTOR_CONTROL_EDITS
         ] + [(lambda n=n: FK.build(n)) for n in FK.SOURCES]
    optim_controls = [None, None]
    adafactor_controls = {}
    with ThreadPoolExecutor(len(jobs)) as ex:
        builds = [ex.submit(timed_build, fn) for fn in jobs]
        for fut in builds:
            lib, sec = fut.result()
            say(f"build: {lib.relative_to(ROOT)} in {sec:.1f} s")
            if lib.stem == "librglru_control":
                control = rglru_control_fn(lib)
            if lib.stem == "libwkv6_backward_control":
                wkv6_control = wkv6_control_fn(lib)
            if lib.stem == "libadamw_control_skip":
                optim_controls[0] = optim_control_fns(lib)[0]
            if lib.stem == "libadamw_control_wd":
                optim_controls[1] = optim_control_fns(lib)[1]
            if lib.stem[3:] in ADAFACTOR_CONTROL_EDITS:
                adafactor_controls[lib.stem[3:]] = OK.bind_adafactor(lib)
            if lib.stem in ("libarena", "libwkv6", "libwkv6_backward",
                            "librglru", "libadamw", "libadafactor",
                            "libflash_decode", "libflash_prefill_sm90",
                            "libflash_backward", "libflash_backward_sm90"):
                for ln in _build.ptxas_report(lib):
                    say(f"build: ptxas {lib.stem[3:]}: {ln}")
    for mod in (K, WK, RK, OK):
        mod._library()
    OK._adafactor_library()
    WK._backward_library()
    for n in FK.SOURCES:
        FK._library(n)
    say(f"card: {card}")

    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in REPLACES}
    phase_kernels(dev, rng, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    flash_err = phase_flash(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    phase_wkv6(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    phase_rglru(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    plans, inputs, launches, _, captured = phase_main(rng)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    bridge = phase_bridge(dev, card)
    say("bridge: " + json.dumps(bridge) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    rows, decode, batched = [], {}, {}
    for arch in FAMILIES:          # one model on the card at a time
        ctx = phase_serve(dev, arch)
        if arch == "llama3.2-1b":
            rows += phase_timing(plans, inputs, launches, err, card,
                                 captured)
        served = phase_serve_timing(ctx, card, dev)
        decode[arch] = served["decode"]
        batched[arch] = phase_serve_vmap(ctx, card, dev)
        for r in rows:
            if r["name"] in ("arena_write", "arena_read"):
                r.setdefault("served", {})[arch] = served[r["name"][6:]]
        if arch == "llama3.2-1b":
            flash = flash_row(ctx, err, card, dev)
            flash["max_abs_err_by_route"] = flash_err
            rows.append(flash)
            chaos = chaos_corpus(ctx, card)
        elif arch == "rwkv6-7b":
            rows.append(wkv6_row(ctx, err, card, dev))
        else:
            rows.append(rglru_row(ctx, err, card, dev))
            flash["models"][arch] = dict(
                mqa_flash_timing(ctx, card, dev),
                launches={r: ctx["launches"][k]
                          for r, k in FLASH_LAUNCHES.items()})
        del ctx
        torch.cuda.empty_cache()
        say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    # this slice's decoders: the MoE one in full, the dense ones lighter
    for arch in DECODERS:
        ctx = phase_serve(dev, arch)
        # the u8 copies are timed at the three families' leaves
        decode[arch] = phase_serve_timing(ctx, card, dev,
                                          packing=False)["decode"]
        decode[arch].update(decode_bound(ctx["model"].cfg, card))
        if arch == MOE_ARCH:
            batched[arch] = phase_serve_vmap(ctx, card, dev)
        if arch == "granite-20b":
            flash["row_blocked"] = dict(
                row_blocked_timing(ctx, card, dev),
                source=FLASH_SOURCES["decode"],
                launches=ctx["launches"]["flash_decode"])
        flash["models"][arch] = dict(
            launches={r: ctx["launches"][k]
                      for r, k in FLASH_LAUNCHES.items()},
            logit_err=ctx["logit_err"])
        del ctx
        torch.cuda.empty_cache()
        if arch != MOE_ARCH:       # the MoE is held in f32 at full depth
            flash["models"][arch]["logit_err"]["f32_at_cut_depth"] = \
                check_cut_f32(arch, dev)
        say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    # this slice's families: the encoder-decoder and MLA with the MTP head,
    # their new attention shapes first
    flash["a7_max_abs_err_by_route"] = phase_flash_a7(dev, err)
    flash["a7_shapes"] = time_a7_shapes(card, dev)
    for arch in A7:
        ctx = phase_serve(dev, arch)
        decode[arch] = phase_serve_timing(ctx, card, dev,
                                          packing=False)["decode"]
        decode[arch].update(decode_bound(ctx["model"].cfg, card,
                                         ctx["smax"]))
        batched[arch] = phase_serve_vmap(ctx, card, dev)
        flash["models"][arch] = dict(
            launches={r: ctx["launches"][k]
                      for r, k in FLASH_LAUNCHES.items()},
            logit_err=ctx["logit_err"],
            controls=(ctx["routing"] or {}).get("controls"))
        del ctx
        torch.cuda.empty_cache()
        if "f32_depth" in A7[arch]:
            flash["models"][arch]["logit_err"]["f32_at_cut_depth"] = \
                check_cut_f32(arch, dev)
        say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    say("timing: decode per token, captured and eager: "
        + json.dumps(decode) + f" [{card}]")
    say("timing: vmap decode, per model: " + json.dumps(batched)
        + f" [{card}]")
    # each kernel of the batched path: launches per tick and us per launch
    # at bucket 4, in the tick's trace
    row_of = {"write": "arena_write", "read": "arena_read",
              "flash_decode": "flash_attention", "wkv6": "wkv6",
              "rglru": "rglru"}
    for r in rows:
        for arch, b in batched.items():
            for k, name in row_of.items():
                if r["name"] == name and k in b["tick"]["launches"]:
                    us, n = b["tick"]["kernel_us"].get(k, (None, 0))
                    r.setdefault("batched", {})[arch] = dict(
                        bucket=N_REQ,
                        launches_per_tick=b["tick"]["launches"][k],
                        us_per_launch=us, traced_launches=n)

    # the bridge's arena launches per call, by case
    for r in rows:
        if r["name"] in ("arena_write", "arena_read"):
            r["bridge"] = {case: rec["launches_per_call"][r["name"][6:]]
                           for case, rec in bridge.items()}

    # the train path, the serving models' weights freed
    train_rows, train_rec, fleet_runs_ = phase_train(
        dev, card, err, control, wkv6_control, optim_controls,
        adafactor_controls)
    rows += train_rows
    for r in rows:            # the recurrences' forward launches in training
        if r["name"] == "rglru":
            g = train_rec["griffin"]
            r["train"] = dict(launches=g["cli"]["launches"]["rglru"],
                              launches_a_step=g["step_launches"]["rglru"],
                              routes_a_step=g["step_routes"])
        if r["name"] == "wkv6":
            g = train_rec["rwkv6"]
            r["train"] = dict(launches=g["cli"]["launches"]["wkv6"],
                              launches_a_step=g["step_launches"]["wkv6"])
    say("timing: train: " + json.dumps(train_rec) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    # the dry-run's CLI cells (phase 15 (d)) start here, in processes of
    # their own, and run beside phases 14 and 13 (host-bound, on fake
    # tensors: no launch, nothing allocated on the card)
    dry_started = time.perf_counter()
    dry_procs = dryrun_start(ROOT / "chiprun_out" / "dryrun")
    try:
        return finish(dev, card, t_start, rows, chaos, dry_procs,
                      dry_started, fleet_runs_)
    finally:
        fleet_runs_.cancel()
        for *_, p in dry_procs:
            if p.returncode is None:
                p.kill()
                p.wait()


def finish(dev, card, t_start, rows, chaos, dry_procs, dry_started,
           fleet_runs_) -> int:
    """Phases 14, 13 and 15 and the last lines (``main``'s tail, while the
    dry-run's CLI processes run)."""
    # the sharded path at world size 1: each count from 0 in its run
    par = phase_parallel(dev, card)
    par_rows = {"flash_attention": ("serve", ("flash_decode",
                                              "flash_prefill")),
                "flash_backward": ("train", ("flash_backward",)),
                "arena_write": ("serve", ("write",)),
                "arena_read": ("serve", ("read",))}
    for r in rows:
        if r["name"] in par_rows:
            part, keys = par_rows[r["name"]]
            r["parallel"] = {k: par[part]["launches"].get(k, 0)
                             for k in keys}
            if r["name"] == "flash_attention":
                r["parallel"]["train_flash_prefill"] = \
                    par["train"]["launches"]["flash_prefill"]
        if r["name"] in ADAFACTOR_KERNELS:
            r["parallel"] = {
                "deepseek-v3-671b train": par["train_adafactor"][
                    "launches"][r["name"]]}
    say("parallel: " + json.dumps(par) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    # the sharded fleet over llama3.2-1b's decode plans, its records
    # realized through the arena kernels; the real server's chaos corpus
    fleet = phase_fleet(dev, card, fleet_runs_)
    for r in rows:
        if r["name"] in ("arena_write", "arena_read"):
            r["fleet"] = dict(launches=fleet["launches"][r["name"][6:]],
                              packs=fleet["packs"])
    say("fleet: " + json.dumps(dict(fleet, chaos=chaos)) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    # the dry-run: the counting mode on real and fake tensors, the CLI on
    # the card's routes over a fake 256-rank group
    dry = phase_dryrun(dev, card, dry_procs, dry_started)
    for r in rows:
        if r["name"] in ("flash_attention", "flash_backward"):
            r["dryrun"] = {k: v for k, v in dry["cli"][
                "llama3.2-1b train_4k"]["launches"].items()}
    say("dryrun: " + json.dumps(dry) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # a failure goes to both streams: a caller that keeps only one of them
    # still reads why the check failed
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception:
        import traceback
        print(f"FAIL: {traceback.format_exc()}", flush=True)
        raise
