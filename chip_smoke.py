#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100): builds the
hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card, serves OPT-6.7B at full
width through them — resident at full depth, and streamed from a host
page store under a device budget of half the flash tier — and runs its
offline prefill / decode path; checks the card's engine against the CPU
engine, the streamed engine against the resident one, and the card's
prefill / decode against the CPU's; then serves through the ServeFront
under injected NAND faults and with the prefix cache, speculatively,
through the command line's entry points on granite-8b at full width,
serves MoE on the resident plane at qwen3-moe-30b-a3b's width through the
expert-grouped ECDP, and serves it streamed, expert-paged from a host page
store through the paged ECDP's expert axis; and runs the other model
families' offline path (rwkv6-3b, recurrentgemma-9b, seamless-m4t-medium)
at full width; trains: granite-8b at full width (8 of its
36 layers), the training entry point through checkpoint, deploy and
serve, and the train step card against CPU; runs the cost tools: the
dry-run of all 40 (arch x shape) cells, and the training cell's counted
peak and bound against what the card measured; and serves the streamed
dense plane tensor-parallel at OPT-6.7B width over 1, 2 and 4 shards of
the one card, and the streamed MoE plane at qwen3-moe-30b-a3b width over
1, 2 and 3; and trains over a ("data", "model") mesh of one rank: granite-8b
at full width through ``train()``'s DTensor path against the plain step,
and its checkpoint across meshes; and runs the port's four examples and
serves qwen3-moe-30b-a3b at all 48 layers through ``build_engine``.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device   — CUDA must be present; prints the card's name and power
                limit (nvidia-smi) and builds the kernels.
  2. ecdp     — the ECDP kernel against its plain version at the OPT-6.7B
                flash matmul shapes (wq/wo 4096x4096, w_up 4096x16384,
                w_down 16384x4096, lm_head 4096x50272), M in {4, 64, 512},
                RBER 0 and 2e-3, ECC on and off; times at the serving shapes
                and at prefill's M=512 (w_up, w_down, lm_head). The kernels
                line carries the registers, spills (ptxas's build log) and
                shared memory per block (static + dynamic) of each bf16
                (tensor-core) instantiation.
  3. paged    — the paged-attention kernel against its plain version and
                its plain version in the kernel's order (the bounds are
                stated at kernel_errors in kernels/paged_attn.py) at B=4,
                KV=32, TR=16, Dh=128, block 16 over scrambled block tables,
                at ragged contexts (0 .. 2047) and at contexts the resident
                run has (96 .. 544); each timed beside SDPA; and at
                OPT-2.7B's Dh=80 over the ragged contexts (checked, not
                timed). The kernels line carries the registers, spills and
                shared memory per block of each instantiation (no spills
                allowed).
  4. serving  — Engine(OPT_6_7B) on the card, compiled (the default: the
                step captured once in a CUDA graph and replayed): seeded
                init, deploy at RBER 1e-4, full width and depth, 4 slots,
                max_seq 2048, chunk 16; 6 requests (prompts 7..512 tokens,
                32 new each) run to completion. The kernels' launch
                counters are zeroed just before and read just after: ECDP
                = steps x (32 x 4 + 1), paged attention = steps x 32. Then
                the same requests again: 8 steps, 6 timed steps, 6 steps
                traced with torch.profiler (device time per kernel group,
                idle share; the replays' span from CUDA events, printed
                apart); step_traces must be 1 after both waves; and one
                step's 129 flash matmuls replayed back to back on the
                engine's weights (the ECDP times of the kernels line). Then
                an eager engine (compiled=False) on the same seeded weights
                serves the same requests the same way: every step's logits
                (so its greedy tokens) must equal the compiled engine's bit
                for bit. A replay runs no Python, so it ticks no launch
                counter: the compiled run's counters hold its warm-up and
                capture (2 x 129 ECDP, 2 x 32 paged attention), and the
                replays' kernels are counted in its profile, which must
                hold each traced step's 129 ECDP and 32 paged-attention
                kernels (and so must the eager run's); the eager run's
                counters are the kernels line's launches.
  5. parity   — the same seeded engine at OPT-6.7B width cut to 1 layer,
                compiled on the card (kernels, one graph) and on the CPU
                (plain versions, the same step body without capture):
                byte-identical deploy, per-step logits within 2^-6 of the
                row's largest logit, greedy tokens wherever the top-2
                margin exceeds twice that.
  6. paged    — the paged-ECDP kernel against its plain version (the ECDP
                bound) and against the ECDP kernel on the same dense bytes
                (bit-equal: same kernel body, same K split) at the OPT-6.7B
                paged shapes (wq/wo 4096x4096, w_up 4096x16384, w_down
                16384x4096) and two ragged ones (200x72, 136x384), M in
                {4, 64}, RBER 0 and 2e-3, ECC on and off, over page tables
                scrambled by a shuffled free list; times per launch at the
                serving shapes and one layer's four paged calls back to
                back.
  7. streamed — Engine(OPT_6_7B) at full width cut to 8 of 32 layers
                (the script's time: the step is host-bound, the read of
                half the tier; full depth took about 2 s a step, 16
                layers 0.9 s), seeded init,
                RBER 1e-4, its flash tier programmed into PageStore(
                n_planes=32) and streamed under StreamConfig(group_size=1,
                prefetch_depth=2, device_budget_bytes = half the tier); 4
                requests (prompts 7..200 tokens, 16 new each). The launch
                counters are zeroed just before and read just after:
                paged ECDP = steps x 8 x 4, ECDP = steps (lm_head), paged
                attention = steps x 8. Then a resident engine on the same
                params serves the same requests: every step's logits must
                equal the streamed engine's bit for bit.
  8. offline  — the dense model's own prefill / decode_step on OPT-6.7B.
                (a) the decode-attention kernel against its plain version
                and its plain version in the kernel's order (bounds at
                kernel_errors in kernels/decode_attn.py) at the OPT-6.7B
                decode shape (B=4, S_max=2048, KV=32, rep=1, Dh=128,
                lengths 0, 1, 513, 2048, and lengths on the walk's edges
                31, 64, 65, 1000), GQA (KV=8, rep=4), MQA (S_max=1000) and
                the OPT-2.7B decode shape (Dh=80), bf16 (tensor-core body)
                and f32 (CUDA-core body) caches;
                timed against SDPA at lengths 144 (the main path's) and 0, 1,
                513, 2048, on grouped queries (and through
                decode_attention_state, which groups them first; the kernels
                line's ms_with_grouping). The kernels line carries the
                registers, spills and shared memory per block of each
                instantiation (no spills allowed). (b) seeded init at full
                width and depth, deploy at RBER 1e-4, 4 prompts of 128 tokens
                prefilled into a cache padded to 2048, 32 greedy decode steps
                through make_decode_step(compiled=True) (one capture), then
                the same through the eager step: tokens and logits bit-equal;
                for each, launch counters zeroed just before and read just
                after: eager, decode attention = 32 x steps, ECDP = 65 x (1 +
                steps); compiled, the warm-up and the capture, 32 x 2 and
                65 x (1 + 2); then 4 decode steps timed and 4 traced with
                torch.profiler, whose records must hold 32 decode-attention
                and 65 ECDP kernels a step, the replays' included. (c) OPT-6.7B
                width cut to 1 layer on the card and the CPU: byte-identical
                deploy, prefill and 8 decode steps' logits within 2^-6 of the
                row's largest logit, greedy tokens wherever the top-2 margin
                exceeds twice that; teacher-forced decode against forward on
                the card within the same bound.
  9. faults   — the serving front under NAND faults (benchmarks/
                serve_chaos.py's dense phase). (a) OPT-6.7B width cut to 2
                layers (the armed read verifies about 24.6k pages a step on
                the host; full depth would be about 400k), seeded init,
                streamed from PageStore(n_planes=32) under StreamConfig(
                group_size=1, prefetch_depth=2) and a device budget of
                lm_head + 2 windows (both windows re-read every step), 20
                slots, behind a ServeFront: serve_chaos's 20 prompts x 8
                new tokens and its recovery prompt fault-free, then on a
                fresh engine and front armed with serve_chaos's CHAOS
                injector, a forced worker crash (two failing fetches ->
                StoreFault -> step retry) and a forced persistent step fault
                on a sacrificial request. Every other request's tokens must
                equal the fault-free run's, the sacrificial one end "error",
                the recovery one be served; ECC-corrected pages, UECC, read
                retries and relocations each > 0; no KV block or pool slot
                left; health (200, "degraded"). Launch counters zeroed just
                before each front's traffic and read after: paged ECDP 8,
                ECDP 1, paged attention 2 per step. (b) the store saved as a
                die image, opened read-only, 4 prompts fault-free and then
                armed with stuck pages: degraded pages and DRAM-tier reads
                > 0, the same tokens. (c) full-depth OPT-6.7B (phase 4's
                seeded weights), compiled, prefix_cache=True, behind a
                ServeFront: a 560-token warm-up request moves every column
                group to flash (Algorithm 2), then 4 prompts sharing a
                256-token prefix cold, then warm: each warm request saves
                >= 256 prefill tokens, fewer prefill lanes, logits within
                2^-6 of the row's largest and greedy tokens equal wherever
                the margin exceeds twice that, one capture; the counters
                hold the warm-up and the capture (2 x 129 ECDP, 2 x 32
                paged attention).
  10. spec    — speculative serving (serving/spec.py); 4 periodic
                prompts of 8 tokens, 48 new each, handed over in one
                batch. (a) full-depth OPT-6.7B (phase 4's seeded weights), 4
                slots, max_seq 2048, chunk 16, compiled; first with
                kv_aware off, as the reference's spec tests run: the
                vanilla engine (its per-token margins recorded), then the
                n-gram spec engine (k=4): one capture; after every step the
                device lengths equal the host mirror and no request is past
                max_new; accepted > 0; tokens equal vanilla's up to each
                request's first token whose vanilla top-2 margin is under
                2 x 2^-6 of the row's largest |logit| (phase 5's rule; the
                prefix lengths are printed); the counters zeroed before the
                run hold the warm-up and the capture, 2 x 66 ECDP (32 x 2
                FFN calls, lm_head and the verify lanes' lm_head: the Q/O
                flash copies are read only with Algorithm 2 on) and 2 x 32
                paged attention. Then the same with kv_aware on (the main
                path's Algorithm 2; no token gate, the two engines' bitmaps
                move at different steps): 2 x 130 ECDP. A second wave of
                each engine is timed (ms per decode / verify step,
                generated tokens/s); with kv_aware on, 4 + 4 spec verify
                steps are traced (device time by kernel group, idle share;
                the profile must hold 130 ECDP and 32 paged-attention
                kernels a step). (b) the model drafter, the reference
                build_engine's draft model (8 layers, d_model 2048, 16
                heads, d_ff 8192), k=3, window 16, kv_aware off: tokens
                equal vanilla's under the same rule, >= 1 token a verify
                step. (d) temperature 0.8, top-k 40, compiled, kv_aware off:
                every request emits exactly 48 tokens, all in the
                vocabulary, one capture. (c) OPT-6.7B width cut to 2
                layers, kv_aware off, streamed from PageStore(n_planes=32)
                under a budget of lm_head + 2 windows (both re-read each
                step), k=4: launch counters zeroed just before and read
                after (paged ECDP 4, ECDP 2, paged attention 2 a step);
                every step's logits and verify-lane logits bit-equal to the
                resident spec engine's (compiled) at 2 layers; as many
                windows a step as the vanilla streamed engine; fewer verify
                steps than tokens. Its figures are the ``spec`` JSON line.
  11. granite — the command line's path on granite-8b (RMSNorm, RoPE,
                SwiGLU, 32 heads over 8 KV heads). (a) the ECDP against
                its plain version at its flash shapes (wq/wo 4096x4096,
                w_gate/w_up 4096x14336, w_down 14336x4096, lm_head
                4096x49152), M 4 and 64, RBER 0 and 2e-3, ECC on and
                off; paged attention at B=4, KV=8, TR=16x4=64, Dh=128,
                block 16, phase 3's ragged contexts; each timed at its
                serving M beside its plain version and the library. (b)
                build_engine("granite-8b", smoke=False, rber=1e-4,
                greedy) at full width, 12 of 36 layers (the script's
                time), compiled: 6 requests of
                16 new tokens, one capture, the counters holding the
                warm-up and the capture; 6 steps profiled (a record
                the profiler loses is printed, not gated: the replays
                are held by their logits); one step's
                61 flash matmuls back to back; then an eager engine on
                the same seed: logits bit-equal at every step, 12 x 5 + 1
                ECDP and 12 paged-attention launches a step; then
                serve("granite-8b", smoke=False) at temperature 0.8: 96
                tokens, one capture. (c) phase 5's check at granite-8b
                width cut to 1 layer. (d) granite-8b width cut to 2
                layers deployed into a PageStore, the die image and the
                DRAM-tier checkpoint written (build/chip_smoke_phase11/)
                and read back as build_engine(store_image=, ckpt=) does:
                tokens and every step's logits bit-equal to a streamed
                engine programmed in process; 10 paged ECDP, 1 ECDP and 2
                paged attention a step. (e) python -m
                repro_torch.launch.deploy --store, then python -m
                repro_torch.launch.serve --store-image --ckpt, at
                granite-8b-smoke, as subprocesses: exit 0, 32 tokens.
  12. moe     — MoE on the resident plane, qwen3-moe-30b-a3b (128
                experts, top 8; d_model 2048, d_ff 768, 32 heads over 4
                KV heads, vocab 151936). (a) the expert-grouped ECDP at
                w_gate/w_up 2048x768 and w_down 768x2048, E = 128, over
                the rows of a real serve_route of 64 tokens at k = 8,
                against its plain version (ECC on and off, RBER 0 and
                2e-3), timed beside one torch.bmm over the capacity-
                padded (E, 64, K) rows, its byte bound (the routed
                experts' INT8) and the reference's shape (128 per-expert
                ECDP launches at M = 512); the same kernel at (d)'s
                capacity layouts (128 experts x 2 rows: the 16-row M
                tile; x 21 rows) against its plain version; lm_head
                2048x151936 at M = 4; paged attention at B=4, KV=4,
                TR=128, Dh=128. (b) build_engine at full width, cut to
                4 of 48 layers (the script's time), RBER 1e-4, greedy: 6
                requests x 16 tokens, compiled (one capture, the counters
                twice 4 x 3 grouped ECDP + 1 ECDP and 4 paged attention),
                6 steps profiled, the step's 12 grouped calls timed back
                to back (and with lm_head); then an eager engine on the same
                seed, logits bit-equal at every step, those counts a
                step. (c) phase 5's check at qwen3 width, 1 layer, with
                a row witness: an eager card engine beside the compiled
                one (bit-equal) and the CPU engine record every layer's
                routes; a request leaves the comparison only from the
                step its own route differs between the devices; the CPU
                router's near-ties (k-th vs (k+1)-th logit < 1e-3)
                printed. (d) the offline path at 1 layer: prefill 4 x
                64, 8 decode steps captured and eager (bit-equal, one
                capture, counters gated) and on the CPU (phase 8(c)'s
                rule), under the same row witness (a row's experts and
                which of its assignments the capacity kept).
  13. moe stream — the streamed MoE plane, qwen3-moe-30b-a3b. (a) the
                paged ECDP's expert axis (grouped_paged_ecdp_matmul) at
                w_gate/w_up 2048x768 and w_down 768x2048 over a real
                64-lane route at k = 8, the routed experts' pages
                programmed by a PageStore and uploaded into a pool, the
                engine's 128-row slab: against its plain version (ECC on
                and off, RBER 0 and 2e-3) and bit for bit against the
                dense grouped ECDP over the full bank on the same bytes
                at the path's plan; timed per launch beside its plain
                version, the dense grouped kernel, torch.bmm over the
                routed experts' dequantised weights and its byte bound.
                (b) build_engine(stream=True) at full width, 4 of 48
                layers (12(b)'s cut), RBER 1e-4, greedy, the device
                budget half the store's flash tier: 12(b)'s 6 requests
                x 16 tokens, every step's logits (slots with lanes) and
                the tokens bit-equal
                to 12(b)'s resident engine, the expert cache within its
                capacity at every step, fewer expert bytes per token than
                all-experts streaming, 4 x 3 grouped paged ECDP + 1 ECDP
                + 4 paged attention launches a step (counters zeroed
                just before, read just after); ms per prefill / decode
                step, the step-phase split, hit rate, misroute stalls,
                prefetched bytes, device memory. (c) speculative serving
                on it at 2 layers (n-gram, k = 4): tokens, logits and
                verify-lane logits bit-equal to the resident spec
                engine's. Its figures are the ``moe_stream`` JSON line.

  14. families — the other model families on the offline path. (a) the
                ECDP against its plain version at each family's flash
                shapes (rwkv6-3b 2560x2560, 2560x8960, 8960x2560, lm_head
                2560x65536; recurrentgemma-9b 4096x4096, 4096x12288,
                12288x4096, lm_head 4096x256000; seamless-m4t-medium
                1024x4096, 4096x1024, lm_head 1024x256206, N not a
                multiple of 16), M 4 and 512, RBER 0 and 2e-3, ECC on and
                off; each timed at both M beside its plain version,
                torch.matmul on the dequantised bf16 weights and its byte
                bound. Decode attention against its plain versions at
                recurrentgemma's ring (B 4, S 2048, KV 1, rep 16, Dh 256:
                the CUDA-core body; lengths 1, 700, 2047, 2048) and
                seamless's self-KV (S 96) and cross-KV (S 128, full),
                timed beside SDPA on the same cache under the length mask
                and its bound. (b) each arch at full width, rwkv6-3b cut
                to 4 of 32 layers and recurrentgemma-9b to 4 of 38 (the
                script's time), seamless-m4t-medium at full depth:
                run_deploy at RBER 1e-4 from a seeded init on the card
                (the checkpoint written under build/chip_smoke_phase14/,
                restored onto the card, removed), 4 prompts x 128 tokens
                (seamless: 128 source frames and a 16-token target, its
                self-KV padded to 96) prefilled, 32 greedy decode steps
                through make_decode_step(compiled=True) (one capture),
                then the same eagerly: tokens and logits bit-equal; the
                counters zeroed just before and read just after: a
                prefill, ECDP = 33 / 22 / 49 and no decode attention; a
                decode step, ECDP 33 / 22 / 25 and decode attention 0 /
                1 / 24 (eager: that a step; compiled: twice, the warm-up
                and the capture); 4 captured steps timed and 4 profiled
                (device time, idle share). (c) full width at cut depth
                (rwkv6 1 layer, recurrentgemma 3: one super-block,
                seamless 1 + 1; cut from 2, 5 and 2 + 2 for the script's
                time), deployed on the card; the CPU
                runs the port's plain path on the card's params: prefill
                and decode steps (the card's captured), phase 5's rule;
                recurrentgemma's prompt (2056 tokens) is longer than its
                window, so the card's captured decode writes the ring's
                slots past the wrap. Its figures are the ``families`` JSON
                line.
 15. train    — training, as ``train()`` builds it (no kernel of the
                port's: the products are cuBLAS, the chunked attention and
                the optimizer plain torch, as the reference trains through
                XLA alone). (a) granite-8b at full width, 8 of its 36
                layers (the script's time; the f32 AdamW moments of all 36
                pass the card's memory), AdamW(lr=warmup_cosine(3e-3, 2, 10)),
                make_train_step at n_micro 2 over SyntheticLM batches of 2 x
                4096 tokens through a Prefetcher: 10 steps between CUDA
                events (ms a step from step 2, tokens/s), the peak memory
                (8 GiB under the card's), the loss and grad-norm
                trajectory (all finite, the params finite after), and one
                more step profiled: device time by where it ran (the
                attention chunk loop, forward, recompute and backward; the
                optimizer; GEMM and elementwise elsewhere), cut by marker
                kernels, and the idle share. (b) ``train("granite-8b",
                smoke=True, steps=80, batch=8, seq=32, lr=1e-2)``: the
                reference's loss-drop gate (last 5 below the first 5 by more
                than 0.1); a second call resumes at step 80; a fault_hook
                raising at step 4 is retried; run_deploy of that (params,
                AdamW) checkpoint into a die image (its DRAM tier the
                trained params bit for bit) served by build_engine (2
                requests); ``python -m repro_torch.launch.train`` on the
                card (its default, 40 steps) and ``--production``
                refused (the production mesh's size error). The straggler detector is live throughout
                (train() reads each step's loss inside the timed call, so
                a step's time is the device's). (c) card vs CPU: one
                make_train_step step (n_micro 2, 2 x 128) at full width of
                granite-8b (1 layer), rwkv6-3b (2), seamless-m4t-medium
                (1 + 1), qwen3-moe-30b-a3b (1; the CPU takes the card's
                routes) and recurrentgemma-9b (3, at 2 x 32: see
                TRAIN_PARITY) from the same params:
                the loss, the first moments and the params under the
                bounds stated at TRAIN_LOSS_TOL and TRAIN_GRAD_TOL. Its
                figures are the ``train`` JSON line.
 16. dryrun   — the cost tools (``launch/dryrun.py``, ``launch/cost.py``,
                ``launch/roofline.py``; no kernel runs: each cell is
                built on fake and meta tensors, the kernels' plain versions
                counted at their boundaries). (a) ``run_cell`` in this
                process for all 40 full-size cells: 32 counted, 8 skipped
                (the sub-quadratic rule), no error, and the card's
                allocated and peak bytes unchanged across the run (the peak
                reset first). (b) 15(a)'s own cell (granite-8b, 8 layers,
                2 x 4096 tokens, n_micro 2, f32 moments) through
                ``run_cell`` with that config, shape and knobs: its peak
                live bytes within 20 % of 15(a)'s max_memory_allocated, its
                step-time bound no larger than 15(a)'s median step (their
                ratio printed: the cell's roofline fraction). Its figures
                are the ``dryrun`` JSON line. (c) the reference's
                production meshes, in subprocesses with no card visible
                (no fake process group may remain for phase 19's nccl
                one), started before (a) and collected after (b): ``--smoke
                --mesh both`` (80 cells over 16x16 and 2x16x16, 6 worker
                processes) beside granite-8b's full-size train_4k on
                16x16, at once: every cell ok or
                skipped by the reference's rule, the full cell's
                collectives and wire bytes more than 0. Its figures
                (each cell's status, collectives by kind, wire bytes by op,
                count seconds) are the ``dryrun_mesh`` JSON line.
 17. sharded  — tensor-parallel streamed serving: Engine(OPT_6_7B) at full
                width cut to 4 of 32 layers (the script's time), seeded
                init, RBER 1e-4, streamed from PageStore(n_planes=32) under
                StreamConfig(group_size=1, prefetch_depth=1 (two windows
                and lm_head do not fit half of a 4-layer tier),
                device_budget_bytes = half the tier, n_shards=S) for S in
                1, 2, 4, S > 1 over a mesh of cuda:0 repeated (the one
                card) serving the store S=1 programmed. (a) layer 0's FFN
                at S=4 (per shard its w_up columns and w_down rows through
                the paged ECDP kernel, 8 launches, then the f32 sum) against
                the unsharded paged chain on the same pages: rtol 1e-5,
                atol 1e-3, the reference's own; printed with its time. (b) 4
                requests of 128-token prompts, 16 new each: the launch
                counters zeroed just before each run and read just after
                (paged ECDP = steps x 4 x (2 + 2S), ECDP = steps, paged
                attention = steps x 4); S=2's and S=4's greedy tokens equal
                S=1's and their last step's logits within 2^-6 of each
                row's largest |logit| of S=1's. (c) pool_shard_transfers ==
                S x pool_uploads, pool_local_pages below S=1's pool_pages,
                each shard's partition on its device. (d) ms a step at each
                S beside the card's name and power limit: on one card a
                check that the shards serve, not a scaling figure. Its
                figures are the ``sharded`` JSON line and the paged ECDP's
                ``sharded`` entry in the kernels line.
 18. sharded_moe — the streamed MoE plane tensor-parallel:
                qwen3-moe-30b-a3b at full width cut to 4 of 48 layers
                (the script's time), seeded init, RBER 1e-4, streamed from
                PageStore(n_planes=32) under StreamConfig(
                device_budget_bytes = half the flash tier, n_shards=S) for
                S in 1, 2, 3 (d_ff 768 is 6 tiles: 4 shards cannot
                partition it), S > 1 over a mesh of cuda:0 repeated
                serving the store S=1 programmed; 4 requests of 128-token
                prompts, 16 new each, token budget 1024 (the stall never
                changes the plan). (a) at S = 2, 3 layer 0's expert FFN
                over a real 64-lane route (layer 0's router, top-8): per
                shard its slab of the routed experts' w_gate / w_up
                columns and w_down rows through 3 grouped paged ECDP
                launches to an f32 partial, then the f32 sum, against the
                unsharded chain on the same pages: rtol 1e-5, atol 1e-3;
                timed beside the chain, torch.bmm over each shard's routed
                experts' bf16 slices and the byte bound. (b) S = 2, 3 with
                S=1's routes handed over (RouteWitness: the router logits
                within 2^-6 of the token's largest, the experts S=1 chose
                within twice that of the k-th): every step's logits within
                2^-6 of each row's largest of S=1's, the tokens equal. (c)
                a free run at each S: the token match against S=1's at
                least 0.85 (scripts/bench_gate.py's MoE floor), the first
                flip with the logit and router margins at it. (d) every
                step 4 x 3 x S grouped paged ECDP launches, 1 ECDP, 4 paged
                attention, no dense grouped launch; pool_shard_transfers ==
                S x pool_uploads; each shard's pool within budget / S +
                the reserve + 8 pages (bench_gate's per-device bound); ms a
                step beside the card's name and power limit (one card: a
                check that the shards serve, not a scaling figure). Its
                figures are the ``sharded_moe`` JSON line and the grouped
                paged ECDP's ``sharded`` entry in the kernels line.
 19. mesh_train — training over a ("data", "model") mesh: an ``nccl``
                process group of one rank on cuda:0 (a ``FileStore`` in a
                temporary directory). (a) ``train()`` at granite-8b's full
                width cut to TRAIN_LAYERS layers (its ``get_config``
                patched for the cut), MESH_STEPS steps of 2 x 4096 tokens
                (n_micro 2): the (1, 1) mesh, every param and moment a
                DTensor placed by ``param_specs`` and ZeRO-1
                ``opt_state_specs``, the step with ``grad_specs``
                (``pin_grad`` calls counted, more than 0); then the same
                params, schedule and batches through 15(a)'s plain step:
                the losses within TRAIN_LOSS_TOL of each other, ms a step
                of each (device and wall), peak memory of each. (b)
                ``train()`` at smoke size over the mesh with a checkpoint;
                ``remesh_restore`` onto ``plan_mesh(1)`` and, the process
                group torn down, the plain ``train()``'s resume: every
                leaf bit-equal to the run's final state;
                ``train(production=True)`` raises the production mesh's
                size error. No several ranks on the one card: NCCL takes
                one rank a card, and ``gloo`` on the card's torch crashes
                in DTensor's all-gather of CUDA tensors, so the (2, 2)
                mesh is held by the CPU tests alone. Training launches
                none of the four kernels. Its figures are the
                ``mesh_train`` JSON line.
 20. moe_depth — (a) the four ``examples/torch_*.py`` (quickstart,
                train_tiny, deploy_nvllm, edge_serve) on the card at their
                default sizes, each a subprocess, started together: exit 0
                and the example's ``OK`` line last. (b) qwen3-moe-30b-a3b
                at full width and all 48 layers through
                ``build_engine(MOE_ARCH, smoke=False, rber=1e-4)``, the
                flash tier encoded as it is drawn
                (``tiering.deploy_init``): the build's seconds, its device
                peak (at least 8 GiB under the card's memory) beside the
                bytes of the bf16 tree, its flash tier and the resident
                tier from the config's shapes, the resident bytes; two
                prompts (64 and 33 tokens, 4 greedy tokens each) compiled,
                one capture, the warm-up's and the capture's counters each
                a step's 48 x 3 grouped ECDP, 1 ECDP and 48 paged
                attention; ms a step. The examples run beside (b)'s
                build and are collected before its steps. The streamed
                engine at 48 layers, bit-equal to the resident one, is
                ``scripts/moe_full_depth.py``'s: its host store takes
                about 100 s to program, past the phase's share of the
                script's time. Its figures are the ``moe_depth`` JSON
                line.

The ``spec``, ``moe_stream``, ``families``, ``train``, ``dryrun``,
``dryrun_mesh``, ``sharded``, ``sharded_moe``, ``mesh_train``,
``moe_depth`` and ``phase_seconds`` lines come before the card's name; the
second-to-last line is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Times are CUDA-event medians with the
L2 cache flushed before each timed call (the serving step streams more
weight bytes than L2 holds) and the card held while the call is enqueued
(``Timer``). bound_ms is the larger of the bytes a call
must move at 3.35 TB/s and its operations at the bf16 tensor-core peak of
989 TFLOP/s (H100 SXM data sheet, 700 W). In the kernels line ``ms`` and
``kernel_ms`` are the same number under the two names it is read by;
``launches`` is the eager run's count on the path (phase 4's or 8(b)'s;
the paged ECDP's, phase 7's streamed run) and ``replayed_in_profile`` the
kernel's records in the compiled run's profile.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
EPS32 = 2.0 ** -23


def log(*args):
    print(*args, flush=True)


def resources_row(res: dict, smem_dynamic: int, **key) -> dict:
    """One kernel instantiation's ptxas report (``build.resources``) with
    the dynamic shared memory it is launched with."""
    return dict(key, registers=res["registers"],
                spill_stores=res["spill_stores"],
                spill_loads=res["spill_loads"], smem_static=res["smem"],
                smem_dynamic=smem_dynamic, smem=res["smem"] + smem_dynamic)


def grouped_resources(build, name: str = "grouped_ecdp") -> list[dict]:
    """Registers, spills and shared memory per block of each instantiation
    of the grouped ECDP (grouped_ecdp_mma_kernel<M tile, wide, Bank>) in
    kernel library ``name``: grouped_ecdp (DenseBank) or paged_ecdp
    (PagedBank, the paged ECDP's expert axis)."""
    import re
    lib = build.load(name)
    smem_fn = (lib.grouped_paged_ecdp_smem_bytes if name == "paged_ecdp"
               else lib.grouped_ecdp_smem_bytes)
    out = []
    for fn, res in build.resources(name).items():
        m = re.search(r"grouped_ecdp_mma_kernelILi(\d+)ELb([01])E", fn)
        if m:
            m_tile = int(m.group(1))
            out.append(resources_row(res, smem_fn(m_tile), m_tile=m_tile,
                                     wide=m.group(2) == "1"))
    return sorted(out, key=lambda r: (r["m_tile"], r["wide"]))


def mma_resources(build, name: str) -> list[dict]:
    """Registers, spills and shared memory per block of each tensor-core
    instantiation (ecdp_mma_kernel<M tile, wide, W>) of kernel library
    ``name``: ptxas's report, plus the dynamic shared memory it is
    launched with (the body's, the same in both libraries)."""
    import re
    smem_fn = build.load("ecdp").ecdp_mma_smem_bytes
    out = []
    for fn, res in build.resources(name).items():
        # not grouped_ecdp_mma_kernel: paged_ecdp.cu holds both
        m = re.search(r"(?<![A-Za-z_])ecdp_mma_kernelILi(\d+)ELb([01])E", fn)
        if m:
            m_tile = int(m.group(1))
            out.append(resources_row(res, smem_fn(m_tile), m_tile=m_tile,
                                     wide=m.group(2) == "1"))
    return sorted(out, key=lambda r: (r["m_tile"], r["wide"]))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """CUDA-event time of one call, median over reps, L2 flushed first. A
    spin kernel of about 1 ms holds the card while the host enqueues the
    start event and the call, so a call that is short on the card is not
    timed with its host-side dispatch (the start event would otherwise run
    as soon as the flush ends, before the call is enqueued)."""

    HOLD_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush_l2(self):
        """Evict L2 by writing the 256 MiB buffer. The lines it leaves in L2
        are dirty: a call that misses in L2 pays their write-back."""
        self.flush.zero_()

    def __call__(self, fn, reps: int = 10, warmup: int = 2,
                 hold: int = HOLD_CYCLES) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_l2()
            torch.cuda._sleep(hold)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


# --- phase 2: ECDP ------------------------------------------------------------

ECDP_SHAPES = {"wq/wo": (4096, 4096), "w_up": (4096, 16384),
               "w_down": (16384, 4096), "lm_head": (4096, 50272)}
# M of each shape's flash matmul in a serving step: slots x chunk = 64 for
# the layers' weights, slots = 4 for lm_head
ECDP_M = {"wq/wo": 64, "w_up": 64, "w_down": 64, "lm_head": 4}
# prefill of 4 prompts of 128 tokens (phase 8) sends M = 512 rows through
# the FFN and lm_head; timed there too
PREFILL_M = 512


def ecdp_case(torch, a, fw, ecc_on: bool, what: str) -> tuple[float, float]:
    """The ECDP kernel against its plain version on one activation and
    flash weight: the same integer weights with f32 sums in another order,
    so each output within 4 sqrt(K) f32 roundoffs of its magnitude.
    Returns the max abs and relative errors."""
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    got = ecdp_matmul(a, fw.q, fw.parity, fw.scale, ecc_on)
    want = ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale, ecc_on)
    torch.cuda.synchronize()
    mag = (a.float().abs() @ fw.q.float().abs()) * fw.scale
    tol = 1e-4 + 4 * math.sqrt(a.shape[1]) * EPS32 * mag
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"ecdp {what} ecc={ecc_on}: max err "
                             f"{float(err.max())}")
    return float(err.max()), float((err / want.abs().clamp_min(1e-3)).max())


def phase_ecdp(torch, timer):
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_abs = worst_rel = 0.0
    per_shape = {}
    for name, (k, n) in ECDP_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=k + n) for r in (0.0, 2e-3)}
        w_deq = dequantize_int8(flash[0.0].q, flash[0.0].scale)
        del w
        for m in (4, 64, PREFILL_M):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            for rber, fw in flash.items():
                for ecc_on in (True, False):
                    e_abs, e_rel = ecdp_case(torch, a, fw, ecc_on,
                                             f"{name} M={m} rber={rber}")
                    worst_abs = max(worst_abs, e_abs)
                    worst_rel = max(worst_rel, e_rel)
            if m != ECDP_M[name] and not (m == PREFILL_M
                                          and name != "wq/wo"):
                continue
            fw = flash[2e-3]
            t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity,
                                                 fw.scale, True))
            t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity,
                                                      fw.scale, True), reps=3)
            t_lib = timer(lambda: torch.matmul(a, w_deq))
            nbytes = k * n * 9 / 8 + 4 * n + 2 * m * k + 4 * m * n
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
            key = name if m == ECDP_M[name] else f"{name}@M{m}"
            per_shape[key] = dict(m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=b_ms,
                                  bound_by=b_by)
            log(f"  ecdp {name:8s} M={m:3d} K={k:5d} N={n:5d}: kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul "
                f"bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del flash, w_deq
    log(f"  ecdp vs plain: max abs err {worst_abs:.3e}, max rel err "
        f"{worst_rel:.3e} (48 cases)")
    return dict(max_abs_err=worst_abs, per_launch=per_shape)


# --- phase 3: paged attention ----------------------------------------------------

# (B, KV, TR, Dh, block size, table width) of one layer of the serving step
PAGED_SHAPE = (4, 32, 16, 128, 16, 128)
PAGED_CTX = [0, 2047, 513, 1200]          # ragged, an empty slot, a long one
# contexts phase 4's resident run has mid-run (prompts 7..512 + 32 new,
# chunk 16)
PAGED_SERVING_CTX = [96, 544, 215, 146]
# OPT-2.7B's head size (2560 / 32 = 80: ten 16-byte pieces a key row, five
# k16 steps), at PAGED_SHAPE's other dims over the ragged contexts
PAGED_DH80 = 80


def paged_resources(build) -> list[dict]:
    """Registers, spills and shared memory per block of each instantiation
    (paged_attn_split_kernel<Dh, k16 tiles per chunk>) and of the merge
    kernel: ptxas's report, plus the dynamic shared memory the split
    kernel is launched with at KV >= 4."""
    import re
    smem_fn = build.load("paged_attn").paged_attn_smem_bytes
    out = []
    for fn, res in build.resources("paged_attn").items():
        m = re.search(r"paged_attn_split_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            dh, nt = int(m.group(1)), int(m.group(2))
            out.append(resources_row(res, smem_fn(4, dh, 16 * nt),
                                     kernel="split", dh=dh, k16_tiles=nt))
        elif "paged_attn_merge_kernel" in fn:
            out.append(resources_row(res, 0, kernel="merge"))
    return sorted(out, key=lambda r: (r["kernel"], r.get("dh", 0),
                                      r.get("k16_tiles", 0)))


def scrambled_tables(torch, gen, ctx, bs: int, max_blocks: int):
    """(B, max_blocks) int32 block tables over a pool of 1 + B x
    max_blocks blocks (block 0 the dump block), each slot's ceil(ctx / bs)
    blocks drawn from a shuffled free list."""
    b = len(ctx)
    perm = torch.randperm(b * max_blocks, generator=gen, device="cuda") + 1
    tables = torch.zeros((b, max_blocks), dtype=torch.int32, device="cuda")
    pi = 0
    for i, c in enumerate(ctx):
        nb = -(-c // bs)
        tables[i, :nb] = perm[pi:pi + nb].int()
        pi += nb
    return tables


def phase_paged(torch, timer):
    """The kernel against its plain versions at PAGED_SHAPE with PAGED_CTX
    and PAGED_SERVING_CTX over scrambled tables; each timed beside its
    plain version and SDPA on the K/V gathered through the tables."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import (kernel_errors, paged_attn,
                                                paged_attn_plain)

    b, n_kv, tr, dh, bs, max_blocks = PAGED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_blocks = 1 + b * max_blocks

    def table(ctx):
        return scrambled_tables(torch, gen, ctx, bs, max_blocks)

    def bf(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    ragged = table(PAGED_CTX)
    q = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k_pool, v_pool = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    rows = {}
    for name, ctx, tables in (
            ("ragged", PAGED_CTX, ragged),
            ("serving", PAGED_SERVING_CTX, table(PAGED_SERVING_CTX))):
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        acc, m, l = paged_attn(q, k_pool, v_pool, tables, lens)
        torch.cuda.synchronize()
        # each check's error over its bound (stated at kernel_errors)
        errs = kernel_errors(q, k_pool, v_pool, tables, lens, acc, m, l)
        max_abs = errs.pop("max_abs_err")
        if not all(v <= 1 for v in errs.values()):
            raise AssertionError(f"paged attention, ctx {ctx}: error / bound "
                                 f"{errs}")
        log(f"  paged_attn ctx={ctx} error / bound: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
        t_kernel = timer(lambda: paged_attn(q, k_pool, v_pool, tables, lens))
        t_plain = timer(lambda: paged_attn_plain(q, k_pool, v_pool, tables,
                                                 lens), reps=3)
        # yardstick: SDPA over the K/V gathered through the tables
        s_pad = max_blocks * bs
        kg = k_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
            1, 2).contiguous()
        vg = v_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
            1, 2).contiguous()
        mask = (torch.arange(s_pad, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        t_lib = timer(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, scale=1.0))
        live = sum(ctx)
        nbytes = (live * n_kv * dh * 2 * 2 + q.numel() * 2 + acc.numel() * 4
                  + 2 * m.numel() * 4 + tables.numel() * 4 + b * 4)
        b_ms, b_by = bound_ms(nbytes, 4.0 * tr * dh * n_kv * live)
        log(f"  paged_attn B={b} KV={n_kv} TR={tr} Dh={dh} ctx={ctx}: kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, SDPA {t_lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); max abs err {max_abs:.3e}")
        rows[name] = dict(ctx=ctx, max_abs_err=max_abs, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                          bound_by=b_by)
        del kg, vg
    # OPT-2.7B's Dh 80 under the same bounds, on the ragged tables
    dh = PAGED_DH80
    q80 = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k80, v80 = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    lens = torch.tensor(PAGED_CTX, dtype=torch.int32, device="cuda")
    acc, m, l = paged_attn(q80, k80, v80, ragged, lens)
    torch.cuda.synchronize()
    errs = kernel_errors(q80, k80, v80, ragged, lens, acc, m, l)
    max_abs = errs.pop("max_abs_err")
    if not all(v <= 1 for v in errs.values()):
        raise AssertionError(f"paged attention, Dh {dh}: error / bound "
                             f"{errs}")
    log(f"  paged_attn Dh={dh} ctx={PAGED_CTX} error / bound: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f"; max abs err {max_abs:.3e}")
    rows["dh80"] = dict(ctx=PAGED_CTX, dh=dh, max_abs_err=max_abs,
                        error_over_bound=errs)
    return rows


# --- phase 6: paged ECDP -------------------------------------------------------------

PAGED_SHAPES = {"wq/wo": (4096, 4096), "w_up": (4096, 16384),
                "w_down": (16384, 4096), "ragged 200x72": (200, 72),
                "ragged 136x384": (136, 384)}
PAGED_SERVING = ("wq/wo", "w_up", "w_down")   # M = slots x chunk = 64


def phase_paged_ecdp(torch, timer):
    import numpy as np

    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul
    from repro_torch.kernels.paged_ecdp import (gather_q, gather_scale,
                                                paged_ecdp_matmul,
                                                paged_ecdp_matmul_plain)
    from repro_torch.store import PageStore, WeightPagePool

    gen = torch.Generator(device="cuda").manual_seed(6)
    store, dense = PageStore(), {}
    for name, (k, n) in PAGED_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        for rber in (0.0, 2e-3):
            dense[(name, rber)] = encode_flash(w, rber=rber, seed=k + n)
            store.put(f"{name}@{rber}", dense[(name, rber)])
        del w
    names = list(store.table)
    n_pages = sum(store.entry_pages(x) for x in names) + 97
    pool = WeightPagePool(store, n_pages, device="cuda")
    # scrambled page tables: slots from a shuffled free list
    pool._free = [int(s) for s in
                  np.random.default_rng(6).permutation(n_pages)]
    tbls = pool.upload(names)
    torch.cuda.synchronize()

    def paged(name, rber):
        t = tbls[f"{name}@{rber}"]
        return (pool.buffer, *t["dev"], t["kn"])

    worst_abs = worst_rel = 0.0
    cases = 0
    per_launch, acts = {}, {}
    for name, (k, n) in PAGED_SHAPES.items():
        for m in (4, 64):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            acts[(name, m)] = a
            for rber in (0.0, 2e-3):
                fw = dense[(name, rber)]
                for ecc_on in (True, False):
                    got = paged_ecdp_matmul(a, *paged(name, rber), ecc_on)
                    want = paged_ecdp_matmul_plain(a, *paged(name, rber),
                                                   ecc_on)
                    same = ecdp_matmul(a, fw.q, fw.parity, fw.scale, ecc_on)
                    torch.cuda.synchronize()
                    if not torch.equal(got, same):
                        raise AssertionError(
                            f"paged ecdp {name} M={m} rber={rber} "
                            f"ecc={ecc_on}: differs from the ECDP on the "
                            f"same bytes by {float((got - same).abs().max())}")
                    mag = (a.float().abs() @ fw.q.float().abs()) * fw.scale
                    tol = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
                    err = (got - want).abs()
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"paged ecdp {name} M={m} rber={rber} "
                            f"ecc={ecc_on}: max err {float(err.max())}")
                    worst_abs = max(worst_abs, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / want.abs().clamp_min(1e-3)).max()))
                    cases += 1
        if name not in PAGED_SERVING:
            continue
        m, a, args = 64, acts[(name, 64)], paged(name, 2e-3)
        t_kernel = timer(lambda: paged_ecdp_matmul(a, *args))
        t_plain = timer(lambda: paged_ecdp_matmul_plain(a, *args), reps=3)
        # yardstick: torch.matmul on the gathered, dequantised bf16 weight
        w_deq = dequantize_int8(gather_q(args[0], args[1], k, n),
                                gather_scale(args[0], args[3], n))
        t_lib = timer(lambda: torch.matmul(a, w_deq))
        del w_deq
        nbytes = k * n * 9 / 8 + 4 * n + 2 * m * k + 4 * m * n
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
        per_launch[name] = dict(m=m, k=k, n=n, ms=t_kernel,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by)
        log(f"  paged ecdp {name:7s} M={m} K={k:5d} N={n:5d}: kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul bf16 "
            f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"  paged ecdp vs plain: max abs err {worst_abs:.3e}, max rel err "
        f"{worst_rel:.3e}; bit-equal to the ECDP on the same bytes "
        f"({cases} cases)")
    layer = time_paged_layer(torch, timer, pool, tbls, acts)
    del pool, tbls, dense, acts
    return dict(max_abs_err=worst_abs, per_launch=per_launch, layer=layer)


def time_paged_layer(torch, timer, pool, tbls, acts):
    """One layer's four paged calls as the streamed step makes them (wq,
    wo, w_up, w_down at M=64, four distinct weights) back to back: the
    kernel, its plain version and torch.matmul on the dequantised
    weights."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.paged_ecdp import (gather_q, gather_scale,
                                                paged_ecdp_matmul,
                                                paged_ecdp_matmul_plain)

    calls = []
    for name, rber in (("wq/wo", 0.0), ("wq/wo", 2e-3), ("w_up", 2e-3),
                       ("w_down", 2e-3)):
        t = tbls[f"{name}@{rber}"]
        calls.append((acts[(name, 64)], (pool.buffer, *t["dev"], t["kn"])))
    t_kernel = timer(lambda: [paged_ecdp_matmul(a, *x) for a, x in calls])
    t_plain = timer(lambda: [paged_ecdp_matmul_plain(a, *x)
                             for a, x in calls], reps=3)
    w_deq = [dequantize_int8(gather_q(x[0], x[1], *x[4]),
                             gather_scale(x[0], x[3], x[4][1]))
             for _, x in calls]
    t_lib = timer(lambda: [torch.matmul(a, w) for (a, _), w in
                           zip(calls, w_deq)])
    del w_deq
    nbytes = sum(k * n * 9 / 8 + 4 * n + 2 * a.shape[0] * k
                 + 4 * a.shape[0] * n for a, (*_, (k, n)) in calls)
    flops = sum(2.0 * a.shape[0] * k * n for a, (*_, (k, n)) in calls)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  paged ecdp, one layer's 4 calls back to back: kernel "
        f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul bf16 "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


# --- phase 7: streamed serving ------------------------------------------------------

STREAM_PROMPTS, STREAM_NEW = (7, 40, 120, 200), 16
STREAM_LAYERS = 8                  # of OPT-6.7B's 32, at full width


def _payload(k: int, n: int) -> int:
    """Store payload bytes of one (K, N) flash weight: q, parity, scales."""
    return k * n + (k // 8) * n + 4 * n


def phase_streamed(torch):
    import resource

    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import PageStore, StreamConfig

    cfg = dataclasses.replace(OPT_6_7B, n_layers=STREAM_LAYERS,
                              name=f"opt-6.7b-{STREAM_LAYERS}l")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    tier = cfg.n_layers * (_payload(d, f) + _payload(f, d)
                           + 4 * _payload(d, d)) + _payload(d, v)
    stream_cfg = StreamConfig(group_size=1, prefetch_depth=2,
                              device_budget_bytes=tier // 2)
    # token_budget 1024: the budget contracted by Algorithm 2 and the
    # streamer's stall (at worst 1024 x 0.25 x 0.25 = 64 lanes) never
    # binds below the 4 x 16 lanes the slots can use, so the streamed and
    # the resident engine plan the same steps and their logits compare
    kw = dict(max_slots=4, max_seq=256, rber=1e-4, seed=0,
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024),
              device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, v, n).tolist() for n in STREAM_PROMPTS]

    def params():
        return dense.init(cfg, torch.Generator(device="cuda").manual_seed(5),
                          device="cuda")

    t0 = time.perf_counter()
    store = PageStore(n_planes=32)
    eng = Engine(cfg, params(), weight_store=store, stream_cfg=stream_cfg,
                 **kw)
    gc.collect()
    torch.cuda.synchronize()
    assert store.total_bytes == tier > stream_cfg.device_budget_bytes
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  init + program the store ({cfg.n_layers} of 32 layers, full "
        "width): "
        f"{time.perf_counter() - t0:.1f} s; store {store.n_pages} pages, "
        f"{store.image_bytes / 2**30:.2f} GiB image ({tier / 2**30:.2f} GiB "
        f"payload; numpy array {store._data.nbytes / 2**30:.2f} GiB), "
        f"budget {stream_cfg.device_budget_bytes / 2**30:.2f} GiB, pool "
        f"{eng.wpool.n_pages} pages; peak host RSS so far {rss / 2**30:.2f}"
        f" GiB; device {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rids = [eng.submit(p, max_new=STREAM_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = []
    ecdp.ecdp_matmul.launches = 0
    paged_ecdp.paged_ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    t0 = time.perf_counter()
    while eng.step():
        logits.append(eng.last_logits.cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_ecdp": paged_ecdp.paged_ecdp_matmul.launches,
                "ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = len(logits)
    st = eng.stream_stats()
    out = {rid: list(eng.requests[rid].out) for rid in rids}
    assert all(len(o) == STREAM_NEW and all(0 <= x < v for x in o)
               for o in out.values())
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    assert launches == {"paged_ecdp": steps * cfg.n_layers * 4,
                        "ecdp": steps, "paged_attn": steps * cfg.n_layers}, \
        (launches, steps)
    assert st["bytes_streamed"] > 0 and st["pool_grows"] == 0
    assert st["pool_uploads"] == st["groups_streamed"], st
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident, (eng.wpool.used_pages, resident)
    stalls = [s["stall_frac"] for s in eng.stats]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  streamed: {len(rids)} requests (prompts {list(STREAM_PROMPTS)}, "
        f"{STREAM_NEW} new each) in {steps} steps, {wall:.2f} s: "
        f"{wall / steps * 1e3:.1f} ms/step; launches {launches}")
    log(f"  streamed {st['groups_streamed']} windows, "
        f"{st['bytes_streamed'] / steps / 2**30:.3f} GiB/step; host-to-device"
        f" copies {st['pool_bytes_staged'] / 2**30:.2f} GiB in "
        f"{st['pool_h2d_s']:.3f} s = "
        f"{st['pool_bytes_staged'] / max(st['pool_h2d_s'], 1e-9) / 1e9:.2f}"
        f" GB/s; worker read+upload {st['stream_s']:.2f} s = "
        f"{st['bytes_streamed'] / max(st['stream_s'], 1e-9) / 1e9:.2f} GB/s"
        f"; consumer stall {st['stall_s']:.2f} s; stall_frac last "
        f"{stalls[-1]:.3f}, mean {sum(stalls) / len(stalls):.3f}; cache "
        f"hits {st['cache_hits']} misses {st['cache_misses']} evictions "
        f"{st['cache_evictions']}; NAND model {st['nand_seconds']:.3f} s")
    log(f"  peak device memory while serving {peak / 2**30:.2f} GiB (pool "
        f"{eng.wpool.n_pages * store.page_bytes / 2**30:.2f} GiB); peak host"
        f" RSS {rss / 2**30:.2f} GiB, store array "
        f"{store._data.nbytes / 2**30:.2f} GiB")
    stream_ms = wall / steps * 1e3
    eng_traces = eng.step_traces
    del eng, store
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = Engine(cfg, params(), **kw)
    gc.collect()
    log(f"  resident reference built in {time.perf_counter() - t0:.1f} s")
    rids_r = [res.submit(p, max_new=STREAM_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, lg in enumerate(logits):
        assert res.step() > 0
        got = res.last_logits.cpu()
        if not torch.equal(got, lg):
            raise AssertionError(
                f"step {i}: streamed logits differ from the resident "
                f"engine's by {float((got - lg).abs().max())}")
    assert res.step() == 0
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    assert [res.requests[r].out for r in rids_r] == [out[r] for r in rids]
    assert res.step_traces == 1 and eng_traces == -1
    log(f"  resident (compiled, one graph): {steps} steps, "
        f"{wall_r / steps * 1e3:.1f} ms/step; logits bit-equal to the "
        f"streamed engine's (eager) at all {steps} steps")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, launches=launches, ms_per_step=stream_ms,
                resident_ms_per_step=wall_r / steps * 1e3)


# --- phase 4: serving -----------------------------------------------------------

PROFILE_WARMUP, PROFILE_STEPS = 8, 6
PROFILE_GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("grouped ecdp kernel", ("grouped_ecdp_",)),
    ("ecdp kernel", ("ecdp_",)),
    ("paged attention kernel", ("paged_attn_",)),
    ("decode attention kernel", ("decode_attn_",)),
    ("GEMM (DRAM projections)", ("gemm", "cutlass", "sm90_", "ampere_",
                                 "cublas", "nvjet")),
    ("sort / top-k / scan (MoE routing)", ("sort", "topk", "radix",
                                           "scan", "bitonic")),
    ("elementwise / reduction / copy", ("elementwise", "reduce", "copy",
                                        "index", "cat", "gather", "scatter",
                                        "fill", "softmax", "norm")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


# the kernel one wrapper call launches once (beside its merge or split-K
# reduce), by the start of its name; the paged ECDP shares the ECDP's. The
# first entry whose name matches takes a kernel (the grouped ECDP's name
# holds the ECDP's)
MAIN_KERNELS = {"grouped_ecdp": ("grouped_ecdp_mma_kernel<",),
                "ecdp": ("ecdp_mma_kernel<", "ecdp_kernel<"),
                "paged_attn": ("paged_attn_split_kernel<",),
                "decode_attn": ("decode_attn_mma_kernel<",
                                "decode_attn_split_kernel<")}


def _main_kernel(key: str):
    """The MAIN_KERNELS entry a profiled kernel name belongs to, or None."""
    for name, starts in MAIN_KERNELS.items():
        if any(k in key for k in starts):
            return name
    return None


def profile_steps(torch, eng, prompts, per_step: dict,
                  require_records: bool = True) -> dict:
    """The same requests again: PROFILE_WARMUP steps, then trace_steps over
    PROFILE_STEPS engine steps (the replays timed with CUDA events where
    the engine is compiled)."""
    for p in prompts:
        eng.submit(p, max_new=32)
    for _ in range(PROFILE_WARMUP):
        eng.step()
    return trace_steps(torch, eng.step, PROFILE_STEPS, per_step,
                       captured=eng.captured,
                       require_records=require_records)


def trace_steps(torch, step, n_steps: int, per_step: dict,
                captured=None, require_records: bool = True) -> dict:
    """``n_steps`` calls of ``step`` timed on the host clock, then
    ``n_steps`` more traced with torch.profiler. Prints the device time per
    kernel group and the idle share, 1 - device time / wall time, against
    the untraced steps' wall time (adjacent steps; the profiler's own host
    cost inflates the traced wall time, whose share is printed beside
    it). Fails unless the profile holds ``per_step[name]`` kernels of each
    MAIN_KERNELS entry a step (a profile short of them is retaken once
    over the next steps): a replay ticks no launch counter, so its profile
    is where its kernels are counted, and a profile without them has no
    device time of the step. ``captured``: the step's
    ``graphs.Captured`` (a compiled step, one replay a call); the replays'
    span over the untraced steps, from CUDA events around each launch, is
    printed apart (it holds the gaps between the graph's kernels). Returns
    the untraced ms/step, device ms/step, the groups' and the main
    kernels' records. ``require_records=False`` (phase 11(b), whose
    replays are held by other exact means) prints a profile still short
    after the retake instead of failing: at granite-8b's 5,900 kernels a
    replay the profiler lost one or two kernel records in about half the
    profiles (all 181 x 12 ECDP records came back in a retake of the same
    engine)."""
    from torch.profiler import ProfilerActivity, profile

    spans = []
    if captured is not None:
        replay = captured.replay

        def timed():
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
            out = replay()
            span[1].record()
            spans.append(span)
            return out
        captured.replay = timed          # an instance attribute, removed below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    finally:
        if captured is not None:
            del captured.replay
    wall = (time.perf_counter() - t0) / n_steps
    replay_ms = None
    if captured is not None:
        assert len(spans) == n_steps, (len(spans), n_steps)
        replay_ms = sum(a.elapsed_time(b) for a, b in spans) / n_steps
    want = {name: n * n_steps for name, n in per_step.items()}
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
            wall_traced = (time.perf_counter() - t0) / n_steps
        groups: dict[str, float] = {}
        counts: dict[str, int] = {}
        kernels: dict[str, float] = {}
        records = {name: 0 for name in MAIN_KERNELS}
        graph_launches = 0
        for evt in prof.key_averages():
            if "cudaGraphLaunch" in evt.key:
                graph_launches += evt.count
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            if (dev_us <= 0
                    or evt.device_type != torch.autograd.DeviceType.CUDA):
                continue
            group = _group(evt.key)
            groups[group] = groups.get(group, 0.0) + dev_us
            counts[group] = counts.get(group, 0) + evt.count
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us
            name = _main_kernel(evt.key)
            if name is not None:
                records[name] += evt.count
        if {name: records[name] for name in want} == want:
            break
        seen = sorted((evt.key[:100], str(evt.device_type), evt.count,
                       round(getattr(evt, "self_device_time_total", 0.0), 1))
                      for evt in prof.key_averages()
                      if any(k in evt.key for ks in MAIN_KERNELS.values()
                             for k in ks))
        miss = (f"the profile of {n_steps} steps ({graph_launches} "
                f"cudaGraphLaunch calls) holds {records} kernel records, "
                f"want {want}: it does not see every kernel of the steps "
                f"(records by name, device, count, device us: {seen})")
        if attempt == 2:
            if require_records:
                raise AssertionError(miss)
            log(f"  {miss}; the profiler lost those records (not a gate "
                "here)")
            break
        log(f"  {miss}; tracing {n_steps} more steps")
    busy = sum(groups.values()) / 1e6 / n_steps
    log(f"  profile: {n_steps} untraced steps {wall * 1e3:.2f} ms/step;"
        f" {n_steps} traced steps {wall_traced * 1e3:.2f} ms/step, "
        f"device {busy * 1e3:.2f} ms/step; idle share {1 - busy / wall:.3f} "
        f"(untraced wall), {1 - busy / wall_traced:.3f} (traced wall); "
        f"kernel records {({n: records[n] for n in want})}, launched "
        f"{want}")
    if replay_ms is not None:
        log(f"  replay span {replay_ms:.3f} ms/step (CUDA events around each"
            " graph launch, untraced steps)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:32s} {us / 1e3 / n_steps:9.3f} ms/step "
            f"{us / 1e6 / n_steps / busy:6.1%} {counts[group]:6d} kernels")
    log("  top kernels (device ms/step):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3 / n_steps:9.3f}  {name[:90]}")
    return dict(ms_per_step=wall * 1e3, device_ms_per_step=busy * 1e3,
                idle_share=1 - busy / wall, replay_ms=replay_ms,
                groups_ms={g: us / 1e3 / n_steps for g, us in groups.items()},
                groups_count=counts, records=records)


def ecdp_step_calls(eng):
    """One serving step's flash matmuls as (M, FlashWeight), in the step's
    order: per layer wq, wo, then the FFN's (w_gate,) w_up, w_down at M =
    slots x chunk; lm_head at M = slots."""
    m = eng.pool.n_slots * eng.admission_cfg.chunk_tokens
    calls = []
    for li, lp in enumerate(eng._layers):
        fl = eng.attn_flash[li]
        calls += [(m, fl["wq"]), (m, fl["wo"])]
        calls += [(m, lp["ffn"][k]) for k in ("w_gate", "w_up", "w_down")
                  if k in lp["ffn"]]
    return calls + [(eng.pool.n_slots, eng.params["lm_head"])]


def time_ecdp_step(torch, timer, calls):
    """The step's flash matmuls back to back on the engine's own weights
    (distinct per layer, so nothing stays in L2): the kernel, its plain
    version, and torch.matmul on the dequantised bf16 weights."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    acts = {}
    for m, fw in calls:
        if (m, fw.q.shape[0]) not in acts:
            acts[(m, fw.q.shape[0])] = torch.randn(
                (m, fw.q.shape[0]), generator=gen, device="cuda"
            ).to(torch.bfloat16)
    args = [(acts[(m, fw.q.shape[0])], fw) for m, fw in calls]
    # the card held for about 15 ms while the host enqueues the 129 calls,
    # so the time is the card's, not the host's dispatch
    hold = 30_000_000
    t_kernel = timer(lambda: [ecdp_matmul(a, fw.q, fw.parity, fw.scale, True)
                              for a, fw in args], reps=5, hold=hold)
    t_plain = timer(lambda: [ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale,
                                               True) for a, fw in args],
                    reps=1, warmup=1)
    w_deq = [dequantize_int8(fw.q, fw.scale) for _, fw in args]
    t_lib = timer(lambda: [torch.matmul(a, w) for (a, _), w in
                           zip(args, w_deq)], reps=5, hold=hold)
    del w_deq
    nbytes = sum(fw.q.numel() * 9 / 8 + fw.scale.numel() * 4 + a.numel() * 2
                 + 4 * a.shape[0] * fw.q.shape[1] for a, fw in args)
    flops = sum(2.0 * a.shape[0] * fw.q.numel() for a, fw in args)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  ecdp, one step's {len(calls)} flash matmuls back to back: kernel "
        f"{t_kernel:.3f} ms, plain {t_plain:.3f} ms, torch.matmul bf16 "
        f"{t_lib:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


def serve_run(torch, cfg, prompts, compiled: bool) -> dict:
    """Engine(cfg) on the card from the seeded init, ``prompts`` (32 new
    each) served to completion with the launch counters zeroed just before
    and read just after; every step's logits kept. The eager engine
    launches each step's kernels from Python; the compiled one launches
    them in its warm-up and into its graph, and its replays tick no
    counter. Returns the engine and the run's figures."""
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.kernels import ecdp, paged_attn
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    what = "compiled" if compiled else "eager"
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dense.init(cfg, gen, device="cuda")
    eng = Engine(cfg, params, max_slots=4, max_seq=2048, rber=1e-4, seed=0,
                 admission_cfg=AdmissionConfig(chunk_tokens=16,
                                               token_budget=64),
                 device="cuda", compiled=compiled)
    del params
    gc.collect()
    torch.cuda.synchronize()
    log(f"  {what}: init + deploy {cfg.name} ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    rids = [eng.submit(p, max_new=32) for p in prompts]
    ecdp.ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = []
    t0 = time.perf_counter()
    while eng.step():
        logits.append(eng.last_logits)
        if len(logits) == 1:        # the step's host reads synchronised
            first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    steps = len(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    out = [list(eng.requests[rid].out) for rid in rids]
    for toks in out:
        assert len(toks) == 32, len(toks)
        assert all(0 <= t < cfg.vocab_size for t in toks)
    assert len(logits) == steps
    assert bool(torch.isfinite(eng.last_logits).all())
    calls = ecdp_step_calls(eng)
    assert len(calls) == cfg.n_layers * 4 + 1
    per_step = {"ecdp": len(calls), "paged_attn": cfg.n_layers}
    bodies = 2 if compiled else steps     # warm-up + capture, or every step
    assert launches == {k: bodies * n for k, n in per_step.items()}, \
        (launches, steps)
    generated = 32 * len(rids)
    processed = sum(s["prefill_tokens"] + s["decode_tokens"]
                    for s in eng.stats)
    log(f"  {what}: served {len(rids)} requests (prompts "
        f"{[len(p) for p in prompts]}, 32 new each) in {steps} steps, "
        f"{wall:.2f} s: {generated / wall:.1f} generated tokens/s, "
        f"{processed / wall:.1f} processed tokens/s, "
        f"{wall / steps * 1e3:.1f} ms/step (the first {first_ms:.1f} ms); "
        f"step_traces {eng.step_traces}")
    log(f"  {what}: peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}; final npu_fraction {eng.stats[-1]['npu_fraction']}")
    log(f"  {what}: first request's tokens: {out[0][:12]}")
    return dict(eng=eng, out=out, logits=torch.stack(logits).cpu(),
                steps=steps, wall_s=wall, ms_per_step=wall / steps * 1e3,
                first_step_ms=first_ms,
                tokens_per_s=generated / wall, launches=launches,
                per_step=per_step, peak_bytes=peak, stats=list(eng.stats))


def phase_serving(torch, timer):
    """The compiled engine (one graph; its profile and the ECDP step), then
    the eager one on the same seeded weights: bit-equal logits at every
    step; both profiles hold every step's kernels."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B

    cfg = OPT_6_7B
    rng = np.random.default_rng(0)
    lens = [7, 64, 200, 512, 33, 130]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    runs = {}
    for compiled in (True, False):
        run = serve_run(torch, cfg, prompts, compiled)
        eng = run.pop("eng")
        assert eng.step_traces == (1 if compiled else -1), eng.step_traces
        run["profile"] = profile_steps(torch, eng, prompts, run["per_step"])
        assert eng.step_traces == (1 if compiled else -1), eng.step_traces
        if compiled:
            calls = ecdp_step_calls(eng)
            run["ecdp_step"] = time_ecdp_step(torch, timer, calls)
            del calls
        runs[compiled] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    comp, eager = runs[True], runs[False]
    assert comp["out"] == eager["out"]
    assert comp["stats"] == eager["stats"]
    assert comp["logits"].shape == eager["logits"].shape
    for i, (a, b) in enumerate(zip(comp["logits"], eager["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(f"step {i}: replayed logits differ from the"
                                 f" eager step's by "
                                 f"{float((a - b).abs().max())}")
    for what, run in (("compiled", comp), ("eager", eager)):
        prof = run["profile"]
        log(f"  {what:8s}: {run['ms_per_step']:.2f} ms/step, "
            f"{run['tokens_per_s']:.1f} generated tokens/s; profile "
            f"{prof['ms_per_step']:.2f} ms/step untraced, device "
            f"{prof['device_ms_per_step']:.2f} ms/step, idle share "
            f"{prof['idle_share']:.3f}; peak {run['peak_bytes'] / 2**30:.2f}"
            " GiB")
    log(f"  compiled vs eager: {comp['steps']} steps, logits and greedy "
        "tokens bit-equal at every step; launches counted (eager) "
        f"{eager['launches']}, profiled (compiled, {PROFILE_STEPS} steps) "
        f"{comp['profile']['records']}")
    return dict(steps=eager["steps"], launches=eager["launches"],
                ecdp_step=comp["ecdp_step"],
                **{w: {k: r[k] for k in ("ms_per_step", "tokens_per_s",
                                         "peak_bytes", "profile")}
                   for w, r in (("compiled", comp), ("eager", eager))})


# --- phase 5: engine parity, card vs CPU -------------------------------------------

# Card vs CPU logits differ where a bf16 rounding of an activation lands
# one ulp apart after f32 sums in another order; lm_head reads a bf16
# hidden state, so the bound is relative to the row's largest logit: four
# bf16 unit roundoffs (4 * 2^-8).
PARITY_REL_TOL = 2.0 ** -6
# the dense card-vs-CPU checks' depth (5, 8(c), 11(c)): 1 layer, for the
# script's time (the CPU's side, not the card's, is their cost)
PARITY_LAYERS = 1


ROUTE_TIE = 1e-3      # router logits this close at the k-th place: a near-tie


class RouteWitness:
    """Hands the card's routes to the CPU run of the same step. A router
    near-tie moves a whole expert, and the devices' router logits drift
    further apart than the k-th and (k+1)-th logits of many tokens, so the
    CPU takes the card's top-k experts (with its own gates over them) and
    every row is compared. Each route handed over is checked as phase 5
    checks logits and greedy tokens: the router logits within
    PARITY_REL_TOL of the token's largest, and every expert the card chose
    within twice that below the CPU's own k-th logit (so the top-k sets
    are equal wherever the CPU's k-th / (k+1)-th margin exceeds twice
    that). The card's routes come from eager calls (a replay runs no
    Python)."""

    def __init__(self, torch, k: int):
        self.torch, self.k = torch, k
        self.queue = []          # the card's (idx, router logits), in order
        self.where = None        # the caller's label of the step
        self.layer = 0
        self.taken = []          # (where, layer, token, CPU gap, drift)
        self.ties = 0            # CPU margins under ROUTE_TIE
        self.max_rel = 0.0       # router logits' drift / the token's largest

    def step(self, where):
        assert not self.queue, f"{len(self.queue)} card routes left over"
        self.where, self.layer = where, 0

    def record(self, logits, idx):
        self.queue.append((idx.cpu(), logits.cpu()))

    def hand_over(self, logits, valid=None):
        """The CPU's route: (gates, idx) with the card's idx."""
        torch = self.torch
        idx, lg = self.queue.pop(0)
        e = logits.shape[-1]
        lc, lg = logits.detach().reshape(-1, e), lg.reshape(-1, e)
        ok = (torch.ones(lc.shape[0], dtype=torch.bool) if valid is None
              else valid.reshape(-1))
        big = lc.abs().amax(-1)
        drift = (lc - lg).abs().amax(-1)
        if bool(ok.any()):
            self.max_rel = max(self.max_rel, float((drift / big)[ok].max()))
        bad = ok & (drift > PARITY_REL_TOL * big)
        if bool(bad.any()):
            t = int(bad.nonzero()[0])
            raise AssertionError(
                f"{self.where}, layer {self.layer}, token {t}: router logits "
                f"differ by {float(drift[t] / big[t]):.3e} of the largest")
        top = torch.topk(lc, self.k + 1)
        margin = top.values[:, -2] - top.values[:, -1]
        self.ties += int((ok & (margin < ROUTE_TIE)).sum())
        own = top.indices[:, :self.k].sort(-1).values
        card = idx.reshape(-1, self.k).long().sort(-1).values
        # how far below the CPU's own k-th logit the card's lowest pick is
        gap = top.values[:, self.k - 1] - lc.gather(-1, card).amin(-1)
        for t in (ok & (own != card).any(-1)).nonzero().flatten().tolist():
            if float(gap[t]) > 2 * PARITY_REL_TOL * float(big[t]):
                raise AssertionError(
                    f"{self.where}, layer {self.layer}, token {t}: the card "
                    f"chose an expert {float(gap[t]):.3e} below the CPU's "
                    f"k-th logit (largest {float(big[t]):.3e})")
            self.taken.append((self.where, self.layer, t,
                               round(float(gap[t]), 6),
                               round(float(drift[t]), 6)))
        self.layer += 1
        idx = idx.to(logits.device).long()
        return torch.softmax(logits.gather(-1, idx), dim=-1), idx

    def summary(self) -> str:
        return (f"router logits' drift {self.max_rel:.3e} of the token's "
                f"largest; {len(self.taken)} routes where the CPU's own "
                f"top-k differed (where, layer, token, the card's lowest pick "
                f"below the CPU's k-th logit, |router logit diff|): "
                f"{self.taken[:8]}; CPU k-th / (k+1)-th margins < "
                f"{ROUTE_TIE:g}: {self.ties}")


def phase_parity(torch, cfg=None):
    """The card engine against the CPU engine on ``cfg`` (default:
    OPT-6.7B width cut to PARITY_LAYERS). A MoE ``cfg``: an eager card engine
    steps beside the compiled one (its logits held bit-equal to the
    replay's) and hands its routes to the CPU engine (RouteWitness), so
    every request is compared."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import FlashWeight, _walk
    from repro_torch.models import family_module
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import Engine, _map_tree

    if cfg is None:
        cfg = dataclasses.replace(OPT_6_7B, n_layers=PARITY_LAYERS,
                                  name=f"opt-6.7b-{PARITY_LAYERS}l")
    is_moe = cfg.family == "moe"
    t0 = time.perf_counter()
    # drawn on the card (the CPU's generator takes 6-18 s a model here),
    # both engines built from the host copy
    params = _map_tree(lambda t: t.cpu(), family_module(cfg.family).init(
        cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda"))
    kw = dict(max_slots=2, max_seq=64, rber=1e-4, seed=1)
    eng_cpu = Engine(cfg, params, device="cpu", **kw)
    eng_gpu = Engine(cfg, params, device="cuda", **kw)
    eng_wit = (Engine(cfg, params, device="cuda", compiled=False, **kw)
               if is_moe else None)
    del params
    log(f"  {cfg.name}: built the engines in {time.perf_counter() - t0:.1f}"
        f" s (cut to {cfg.n_layers} layers, full width)")
    # the flash tier is integer work: byte-identical on both devices
    pairs = list(zip(dict(_walk(eng_gpu.params)).values(),
                     dict(_walk(eng_cpu.params)).values()))
    if eng_gpu.attn_flash is not None:
        pairs += [(g[k], c[k]) for g, c in zip(eng_gpu.attn_flash,
                                               eng_cpu.attn_flash)
                  for k in g]
    n_flash = 0
    for g, c in pairs:
        if isinstance(g, FlashWeight):
            n_flash += 1
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    wit, side, route = RouteWitness(torch, cfg.top_k), [None], \
        moe_mod.serve_route
    diverged: set = set()

    def witness_route(router, x, top_k, **kw):
        if side[0] is None:
            return route(router, x, top_k, **kw)
        lg = torch.einsum("std,de->ste", x.float(), router.float())
        if side[0] == "card":
            gates, idx = route(router, x, top_k, **kw)
            wit.record(lg, idx)
            return gates, idx
        # the CPU's valid lanes, the slots of diverged requests left out
        q = eng_cpu._host_in["q_lens"].clone()
        for rid in diverged:
            q[eng_cpu.requests[rid].slot] = 0
        valid = torch.arange(x.shape[1])[None, :] < q[:, None]
        gates, idx = wit.hand_over(lg, valid)
        return gates, idx.to(torch.int32)

    def stepped(name, eng):
        side[0] = name
        try:
            return eng.step()
        finally:
            side[0] = None

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 9).tolist(),
               rng.integers(0, cfg.vocab_size, 21).tolist()]
    for e in (eng_cpu, eng_gpu, eng_wit):
        for p in prompts:
            if e is not None:
                e.submit(p, max_new=4)
    max_diff, max_rel, compared = 0.0, 0.0, 0
    t0 = time.perf_counter()
    if is_moe:
        moe_mod.serve_route = witness_route
    try:
        while True:
            n_out = {rid: len(r.out) for rid, r in eng_cpu.requests.items()}
            slot_of = {rid: r.slot for rid, r in eng_cpu.requests.items()}
            wit.step(len(eng_cpu.stats))
            n_wit = stepped("card", eng_wit) if is_moe else None
            n_cpu = stepped("cpu", eng_cpu)
            n_gpu = eng_gpu.step()
            assert n_cpu == n_gpu and n_wit in (None, n_cpu)
            if n_cpu == 0:
                break
            lg_cpu, lg_gpu = eng_cpu.last_logits, eng_gpu.last_logits.cpu()
            if is_moe:
                assert torch.equal(eng_wit.last_logits.cpu(), lg_gpu)
            for rid, req in eng_cpu.requests.items():
                if rid in diverged or len(req.out) == n_out[rid]:
                    continue                 # sampled nothing this step
                row = slot_of[rid]
                diff = float((lg_cpu[row] - lg_gpu[row]).abs().max())
                tol = PARITY_REL_TOL * float(lg_cpu[row].abs().max())
                max_diff = max(max_diff, diff)
                max_rel = max(max_rel, diff / float(lg_cpu[row].abs().max()))
                assert diff <= tol, (rid, diff, tol)
                top2 = torch.topk(lg_cpu[row], 2).values
                t_cpu = req.out[-1]
                t_gpu = eng_gpu.requests[rid].out[-1]
                if float(top2[0] - top2[1]) > 2 * tol:
                    assert t_cpu == t_gpu, (rid, t_cpu, t_gpu)
                    compared += 1
                elif t_cpu != t_gpu:
                    diverged.add(rid)        # a near-tie broke differently
    finally:
        moe_mod.serve_route = route
    # the card engine replays one captured step; the CPU runs its body
    assert (eng_gpu.step_traces, eng_cpu.step_traces) == (1, 0)
    log(f"  parity over {len(eng_cpu.stats)} steps in "
        f"{time.perf_counter() - t0:.1f} s (card engine compiled, one "
        f"graph): {n_flash} flash weights "
        f"byte-identical, max |logit diff| {max_diff:.3e} = {max_rel:.3e} of "
        f"the row's max |logit| (tol {PARITY_REL_TOL:.3e}),"
        f" {compared} greedy tokens compared, {len(diverged)} near-tie "
        "divergences")
    if is_moe:
        log("  routes handed from the card (its eager engine bit-equal to "
            "the replay at every step) to the CPU: " + wit.summary())
    return dict(max_logit_diff=max_diff, max_rel=max_rel,
                tokens_compared=compared, diverged=len(diverged),
                route_ties=wit.ties, routes_taken=len(wit.taken),
                router_rel=wit.max_rel)


# --- phase 8: offline prefill / decode ----------------------------------------------

# (B, S_max, KV, rep, Dh, lengths): the OPT-6.7B decode shape with an empty,
# a one-row, a ragged and a full slot; the same shape with lengths on the
# walk's edges (one short of a 32-row chunk, on and one past a 64-row
# range); GQA; MQA with S_max a multiple of neither the kernel's 32-row
# chunk nor its range; the OPT-2.7B decode shape (Dh 80)
DECODE_ATTN_SHAPES = {
    "opt-6.7b": (4, 2048, 32, 1, 128, [0, 1, 513, 2048]),
    "edges": (4, 2048, 32, 1, 128, [31, 64, 65, 1000]),
    "gqa": (3, 2048, 8, 4, 128, [0, 700, 2048]),
    "mqa": (2, 1000, 1, 8, 128, [1000, 37]),
    "opt-2.7b": (4, 2048, 32, 1, 80, [0, 1, 513, 2048]),
}
OFFLINE_B, OFFLINE_PROMPT, OFFLINE_PAD, OFFLINE_STEPS = 4, 128, 2048, 32
OFFLINE_TRACE = 4
# the main path's decode attention: the OPT-6.7B cache at the middle of the
# run's decode (kv_len 128..159), timed for the kernels line
DECODE_MAIN_LEN = OFFLINE_PROMPT + OFFLINE_STEPS // 2


def _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh, dtype):
    """Unscaled queries (B, H, Dh) and caches (B, S_max, KV, Dh)."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, n_kv * rep, dh), mk(b, s_max, n_kv, dh), mk(b, s_max, n_kv,
                                                              dh)


def time_decode_attn(torch, timer, lengths):
    """Kernel, plain version and SDPA (on the same cache, a length mask)
    at the OPT-6.7B decode shape, bf16, with ``lengths``, all three on the
    same grouped queries; the kernel also through decode_attention_state
    (the queries grouped first, as earlier runs timed it); and the bound: the
    live K/V rows, q and the state at 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (decode_attention_state,
                                                 decode_attn,
                                                 decode_attn_plain,
                                                 group_decode_queries)

    b, s_max, n_kv, rep, dh, _ = DECODE_ATTN_SHAPES["opt-6.7b"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                               torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = group_decode_queries(q, n_kv, kc.dtype)          # (B, KV, 1, Dh)
    t_kernel = timer(lambda: decode_attn(qs, kc, vc, lens))
    t_grouping = timer(lambda: decode_attention_state(q, kc, vc, lens))
    t_plain = timer(lambda: decode_attn_plain(qs, kc, vc, lens), reps=3)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, scale=1.0))
    live = sum(min(x, s_max) for x in lengths)
    nbytes = (live * n_kv * dh * 2 * 2 + qs.numel() * 2
              + b * n_kv * rep * (dh + 2) * 4 + b * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * rep * dh * n_kv * live)
    log(f"  decode_attn B={b} S_max={s_max} KV={n_kv} rep={rep} Dh={dh} "
        f"lengths={lengths}: kernel {t_kernel:.4f} ms ({t_grouping:.4f} ms "
        f"with the query grouping), plain {t_plain:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=t_kernel, ms_with_grouping=t_grouping, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)


def phase_decode_attn(torch, timer):
    """8(a): the decode kernel against both plain versions (the bounds at
    kernel_errors in kernels/decode_attn.py), bf16 and f32 caches."""
    from repro_torch.kernels.decode_attn import (decode_attention_state,
                                                 group_decode_queries,
                                                 kernel_errors)

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = 0.0
    for name, (b, s_max, n_kv, rep, dh, lengths) in \
            DECODE_ATTN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                                       dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            acc, m, l = decode_attention_state(q, kc, vc, lens)
            torch.cuda.synchronize()
            errs = kernel_errors(group_decode_queries(q, n_kv, dtype), kc, vc,
                                 lens, acc, m, l)
            max_abs = errs.pop("max_abs_err")
            if not all(v <= 1 for v in errs.values()):
                raise AssertionError(f"decode attention {name} {dtype}: "
                                     f"error / bound {errs}")
            worst = max(worst, max_abs)
            log(f"  decode_attn {name:8s} {str(dtype)[6:]:8s} error / bound: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; max abs err {max_abs:.3e}")
    long_ctx = time_decode_attn(torch, timer,
                                DECODE_ATTN_SHAPES["opt-6.7b"][5])
    main = time_decode_attn(torch, timer, [DECODE_MAIN_LEN] * OFFLINE_B)
    return dict(max_abs_err=worst, at_long_ctx=dict(
        lengths=DECODE_ATTN_SHAPES["opt-6.7b"][5], **long_ctx), **main)


def decode_resources(build) -> list[dict]:
    """Registers, spills and shared memory per block of each instantiation
    of the decode-attention library: the tensor-core body
    (decode_attn_mma_kernel<Dh>, at KV >= 4), the CUDA-core body
    (decode_attn_split_kernel<T>, at rep=1, Dh=128) and the merge."""
    import re

    from repro_torch.kernels.decode_attn import smem_bytes
    out = []
    for fn, res in build.resources("decode_attn").items():
        m = re.search(r"decode_attn_mma_kernelILi(\d+)E", fn)
        if m:
            dh = int(m.group(1))
            smem = smem_bytes(1, dh, n_kv=4, mma=True)
            out.append(resources_row(res, smem, kernel="mma", dh=dh))
        elif "decode_attn_split_kernel" in fn:
            dtype = "bf16" if "bfloat16" in fn else "f32"
            out.append(resources_row(res, smem_bytes(1, 128),
                                     kernel="cuda_core", dtype=dtype))
        elif "decode_attn_merge_kernel" in fn:
            out.append(resources_row(res, 0, kernel="merge"))
    return sorted(out, key=lambda r: (r["kernel"], r.get("dh", 0),
                                      r.get("dtype", "")))


def phase_offline(torch):
    """8(b): seeded OPT-6.7B at full width and depth, deployed at RBER 1e-4;
    prefill 4 prompts of 128 tokens into a cache padded to 2048, then 32
    greedy decode steps, the launch counters zeroed just before and read
    just after; then 4 decode steps timed and 4 traced. Once through
    make_decode_step(compiled=True), once eagerly: tokens and logits
    bit-equal, one capture; the compiled run's counters hold its warm-up
    and capture, its profile the replays' kernels."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import deploy
    from repro_torch.kernels import decode_attn, ecdp, paged_attn, paged_ecdp
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import dense

    cfg = OPT_6_7B
    t0 = time.perf_counter()
    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(10),
                        device="cuda")
    params, _ = deploy(params, rber=1e-4, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    log(f"  init + deploy {cfg.name}: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    prefill = make_prefill_step(cfg, pad_to=OFFLINE_PAD)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (OFFLINE_B, OFFLINE_PROMPT))).int().cuda()
    counters = (decode_attn.decode_attention_state, ecdp.ecdp_matmul,
                paged_attn.paged_attn, paged_ecdp.paged_ecdp_matmul)
    per_pass = cfg.n_layers * 2 + 1                # FFN w_up, w_down; lm_head
    runs = {}
    for compiled in (True, False):
        what = "compiled" if compiled else "eager"
        decode = make_decode_step(cfg, compiled=compiled)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        last, cache = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        out, logits = [last.argmax(-1)], []
        t0 = time.perf_counter()
        for i in range(OFFLINE_STEPS):
            last, cache = decode(params, cache, {"token": out[-1],
                                                 "kv_len": OFFLINE_PROMPT + i})
            out.append(last.argmax(-1))
            logits.append(last)
            if i == 0:
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = {"decode_attn": counters[0].launches,
                    "ecdp": counters[1].launches,
                    "paged_attn": counters[2].launches,
                    "paged_ecdp": counters[3].launches}
        peak = torch.cuda.max_memory_allocated()
        bodies = 2 if compiled else OFFLINE_STEPS   # warm-up + capture
        assert launches == {"decode_attn": cfg.n_layers * bodies,
                            "ecdp": per_pass * (1 + bodies),
                            "paged_attn": 0, "paged_ecdp": 0}, launches
        assert tuple(cache["k"].shape) == (cfg.n_layers, OFFLINE_B,
                                           OFFLINE_PAD, cfg.n_kv_heads,
                                           cfg.head_dim)
        assert bool(torch.isfinite(last).all())
        gen_toks = torch.stack(out, 1).cpu()
        assert bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all())
        if compiled:
            assert decode.captures == 1, decode.captures
        ms_step = t_decode / OFFLINE_STEPS * 1e3
        tok_s = OFFLINE_B * OFFLINE_STEPS / t_decode
        log(f"  {what}: prefill {OFFLINE_B} x {OFFLINE_PROMPT} tokens (cache "
            f"padded to {OFFLINE_PAD}): {t_prefill * 1e3:.1f} ms; "
            f"{OFFLINE_STEPS} greedy decode steps: {ms_step:.2f} ms/step "
            f"(the first {first_ms:.1f} ms), {tok_s:.1f} generated tokens/s;"
            " peak device memory "
            f"{peak / 2**30:.2f} GiB; launches {launches}")
        log(f"  {what}: first prompt's tokens: {gen_toks[0, :12].tolist()}")
        kv = [OFFLINE_PROMPT + OFFLINE_STEPS]

        def step():
            nonlocal last, cache
            last, cache = decode(params, cache, {"token": last.argmax(-1),
                                                 "kv_len": kv[0]})
            kv[0] += 1
        prof = trace_steps(torch, step, OFFLINE_TRACE,
                           {"decode_attn": cfg.n_layers, "ecdp": per_pass},
                           captured=decode.captured if compiled else None)
        if compiled:
            assert decode.captures == 1, decode.captures
        runs[compiled] = dict(tokens=gen_toks,
                              logits=torch.stack(logits).cpu(),
                              launches=launches, prefill_ms=t_prefill * 1e3,
                              ms_per_step=ms_step, tokens_per_s=tok_s,
                              peak_bytes=peak, profile=prof)
        del cache, last, logits, out, decode
        gc.collect()
        torch.cuda.empty_cache()
    comp, eager = runs[True], runs[False]
    assert torch.equal(comp["tokens"], eager["tokens"])
    for i, (a, b) in enumerate(zip(comp["logits"], eager["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(f"decode step {i}: replayed logits differ "
                                 f"from the eager step's by "
                                 f"{float((a - b).abs().max())}")
    for what, run in (("compiled", comp), ("eager", eager)):
        prof = run["profile"]
        log(f"  {what:8s}: {run['ms_per_step']:.2f} ms/step, "
            f"{run['tokens_per_s']:.1f} generated tokens/s, prefill "
            f"{run['prefill_ms']:.1f} ms; profile {prof['ms_per_step']:.2f} "
            f"ms/step untraced, device {prof['device_ms_per_step']:.2f} "
            f"ms/step, idle share {prof['idle_share']:.3f}; peak "
            f"{run['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  compiled vs eager: {OFFLINE_STEPS} decode steps, logits and "
        "greedy tokens bit-equal, 1 capture; launches counted (eager) "
        f"{eager['launches']}, profiled (compiled, {OFFLINE_TRACE} steps) "
        f"{comp['profile']['records']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=eager["launches"], **{
        w: {k: r[k] for k in ("prefill_ms", "ms_per_step", "tokens_per_s",
                              "peak_bytes", "profile")}
        for w, r in (("compiled", comp), ("eager", eager))})


def phase_offline_parity(torch):
    """8(c): OPT-6.7B width cut to PARITY_LAYERS on the card and on the CPU:
    byte-identical deploy; prefill logits and 8 decode steps' logits (both
    fed the CPU's greedy tokens) within 2^-6 of each row's largest logit,
    greedy tokens equal wherever the top-2 margin exceeds twice that; on
    the card, teacher-forced decode_step logits against forward over the
    whole sequence within the same bound."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import FlashWeight, _walk, deploy
    from repro_torch.models import dense
    from repro_torch.serving.engine import _map_tree

    cfg = dataclasses.replace(OPT_6_7B, n_layers=PARITY_LAYERS,
                              name=f"opt-6.7b-{PARITY_LAYERS}l")
    b, s, pad, n_dec = 2, 16, 64, 8
    t0 = time.perf_counter()
    raw = dense.init(cfg, torch.Generator(device="cuda").manual_seed(11),
                     device="cuda")
    p_gpu, _ = deploy(raw, rber=1e-4, seed=2)
    p_cpu, _ = deploy(_map_tree(lambda t: t.cpu(), raw), rber=1e-4, seed=2)
    del raw
    n_flash = 0
    for (_, g), (_, c) in zip(_walk(p_gpu), _walk(p_cpu)):
        if isinstance(g, FlashWeight):
            n_flash += 1
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, s))).int()
    max_rel, compared = 0.0, 0

    def compare(lg_cpu, lg_gpu, what):
        nonlocal max_rel, compared
        lg_gpu = lg_gpu.cpu()
        row_max = lg_cpu.abs().amax(-1)
        rel = float(((lg_cpu - lg_gpu).abs().amax(-1) / row_max).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"{what}: logits differ by {rel:.3e} of the"
                                 " row's largest")
        max_rel = max(max_rel, rel)
        top2 = torch.topk(lg_cpu, 2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * PARITY_REL_TOL * row_max
        assert torch.equal(lg_cpu.argmax(-1)[sure], lg_gpu.argmax(-1)[sure]), \
            what
        compared += int(sure.sum())

    lg_c, c_cpu = dense.prefill(cfg, p_cpu, {"tokens": toks}, pad_to=pad)
    lg_g, c_gpu = dense.prefill(cfg, p_gpu, {"tokens": toks.cuda()},
                                pad_to=pad)
    compare(lg_c, lg_g, "prefill")
    seq, dec_gpu = [toks], [lg_g]
    for i in range(n_dec):
        tok = lg_c.argmax(-1).int()
        seq.append(tok[:, None])
        lg_c, c_cpu = dense.decode_step(cfg, p_cpu, c_cpu,
                                        {"token": tok, "kv_len": s + i})
        lg_g, c_gpu = dense.decode_step(cfg, p_gpu, c_gpu,
                                        {"token": tok.cuda(), "kv_len": s + i})
        compare(lg_c, lg_g, f"decode step {i}")
        dec_gpu.append(lg_g)
    # teacher-forced decode against forward over the whole sequence, card
    full = dense.forward(cfg, p_gpu, torch.cat(seq, 1).cuda())
    fwd_rel = 0.0
    for i, lg in enumerate(dec_gpu):
        want = full[:, s - 1 + i]
        rel = float(((lg - want).abs().amax(-1) / want.abs().amax(-1)).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"decode step {i} vs forward: {rel:.3e} of "
                                 "the row's largest logit")
        fwd_rel = max(fwd_rel, rel)
    log(f"  {cfg.name} (cut: {cfg.n_layers} of 32 layers; widths as "
        f"OPT-6.7B), {b} x {s}"
        f" prompt, {n_dec} decode steps, {time.perf_counter() - t0:.1f} s: "
        f"{n_flash} flash weights byte-identical; card vs CPU max |logit "
        f"diff| {max_rel:.3e} of the row's max (tol {PARITY_REL_TOL:.3e}), "
        f"{compared} greedy tokens compared; decode vs forward on the card "
        f"{fwd_rel:.3e}")
    return dict(max_rel=max_rel, fwd_rel=fwd_rel, tokens_compared=compared)


# --- phase 9: the serving front under NAND faults ------------------------------

# benchmarks/serve_chaos.py's dense phase at OPT-6.7B width, cut to 2
# layers: the armed read verifies every protected page of both windows on
# the host each step (about 24.6k pages, 400 MB), which at full depth would
# be about 400k pages a step
CHAOS_LAYERS, CHAOS_NEW, CHAOS_MAX_SEQ = 2, 8, 96
CHAOS_N = 20                                  # serve_chaos's N_DENSE
CHAOS = dict(seed=3, read_rber=2e-5, stuck_page_rate=5e-3,
             slow_read_every=9, slow_read_s=0.001, io_error_every=97,
             io_error_burst=1)                # serve_chaos's CHAOS
CHAOS_RECOVERY = [11, 22, 33]
DIE_PROMPTS, DIE_STUCK = 4, 5e-3
PREFIX_LEN, PREFIX_TAILS, PREFIX_NEW = 256, (9, 21, 33, 40), 8
PREFIX_WARMUP = 560          # prefill that moves every column group to flash


def _chaos_prompts():
    """serve_chaos's ``_dense_prompts``."""
    return [[(7 * i + j) % 400 + 1 for j in range(5 + i % 4)]
            for i in range(CHAOS_N)]


def _add_all(front, eng, prompts, max_new):
    """Hand every prompt to the front while holding the engine's lock, so
    the loop's next step admits them all: every run of the phase plans the
    same batches (Algorithm 2's bitmap follows the batch's KV length, and
    with it the Q/O projections' mix of DRAM and flash products)."""
    with eng._cv:
        return [front.add_request(p, max_new=max_new) for p in prompts]


def _drained(front, eng, free0, timeout=60.0):
    deadline = time.monotonic() + timeout
    while front.stats()["live_handles"] or eng.pool.n_free_blocks != free0:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"front did not drain: {front.stats()['live_handles']} live "
                f"handles, {eng.pool.n_free_blocks} of {free0} KV blocks free")
        time.sleep(0.01)


def _stream_counts():
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    return {"paged_ecdp": paged_ecdp.paged_ecdp_matmul.launches,
            "ecdp": ecdp.ecdp_matmul.launches,
            "paged_attn": paged_attn.paged_attn.launches}


def _zero_counts():
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    ecdp.ecdp_matmul.launches = 0
    paged_ecdp.paged_ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0


def phase_chaos(torch):
    """9(a): OPT-6.7B width, 2 layers, streamed from a writable PageStore
    through a ServeFront: a fault-free run, then a fresh engine and front
    armed with serve_chaos's schedule, a forced worker crash and a forced
    persistent step fault. 9(b): the store saved as a die image, opened
    read-only and armed with stuck pages: degraded, same tokens."""
    import tempfile

    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.core.tiering import dram_tier
    from repro_torch.models import dense
    from repro_torch.runtime.fault import StepFault
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import ServeFront
    from repro_torch.store import PageStore, StreamConfig
    from repro_torch.store.faults import FaultConfig, FaultInjector

    cfg = dataclasses.replace(OPT_6_7B, n_layers=CHAOS_LAYERS,
                              name=f"opt-6.7b-{CHAOS_LAYERS}l")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    group = _payload(d, f) + _payload(f, d) + 4 * _payload(d, d)
    lm = _payload(d, v)
    # the cache keeps lm_head (pinned) and no layer group: both windows are
    # evicted and re-read every step, so every step reads armed pages
    stream_cfg = StreamConfig(group_size=1, prefetch_depth=2,
                              device_budget_bytes=lm + 2 * group)
    # token_budget 1024: the budget (contracted by Algorithm 2 and by the
    # stall, which differ between runs) never binds, so the fault-free and
    # the armed runs plan the same steps
    kw = dict(max_slots=CHAOS_N, max_seq=CHAOS_MAX_SEQ, rber=0.0, seed=0,
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024),
              device="cuda")
    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(9),
                        device="cuda")
    prompts = _chaos_prompts()

    def streamed(store=None, p=None):
        store = store if store is not None else PageStore(n_planes=32)
        eng = Engine(cfg, p if p is not None else params, weight_store=store,
                     stream_cfg=stream_cfg, **kw)
        return eng, store

    # --- fault-free baseline ---------------------------------------------------
    t0 = time.perf_counter()
    eng0, store0 = streamed()
    log(f"  {cfg.name} (cut: {CHAOS_LAYERS} of 32 layers, widths as "
        f"OPT-6.7B): engine + store in {time.perf_counter() - t0:.1f} s; "
        f"store {store0.n_pages} pages ({store0.image_bytes / 2**30:.3f} "
        f"GiB), device budget {stream_cfg.device_budget_bytes / 2**20:.1f} "
        f"MiB = lm_head {lm / 2**20:.1f} + 2 x window {group / 2**20:.1f} "
        "MiB (no window stays resident)")
    front0 = ServeFront(eng0)
    _zero_counts()
    t0 = time.perf_counter()
    base = [h.result(timeout=600)
            for h in _add_all(front0, eng0, prompts, CHAOS_NEW)]
    base_rec = _add_all(front0, eng0, [CHAOS_RECOVERY], CHAOS_NEW)[
        0].result(timeout=600)
    clean_s = time.perf_counter() - t0
    clean_counts = _stream_counts()
    clean_steps = len(eng0.stats)
    front0.close()
    per_step = {"paged_ecdp": 4 * CHAOS_LAYERS, "ecdp": 1,
                "paged_attn": CHAOS_LAYERS}
    assert clean_counts == {k: clean_steps * n for k, n in per_step.items()}, \
        (clean_counts, clean_steps)
    assert all(len(o) == CHAOS_NEW and all(0 <= t < v for t in o)
               for o in base + [base_rec])
    assert bool(torch.isfinite(eng0.last_logits).all())
    log(f"  fault-free front: {CHAOS_N} requests + recovery in {clean_steps} "
        f"steps, {clean_s:.2f} s = {clean_s / clean_steps * 1e3:.1f} ms/step;"
        f" launches {clean_counts}")
    del eng0, store0, front0
    gc.collect()
    torch.cuda.empty_cache()

    # --- the armed run -----------------------------------------------------------
    eng, store = streamed()
    free0 = eng.pool.n_free_blocks
    t0 = time.perf_counter()
    store.attach_injector(FaultInjector(FaultConfig(**CHAOS)))
    attach_s = time.perf_counter() - t0
    n_prot = int((store._prow >= 0).sum())
    log(f"  attach_injector: {attach_s:.2f} s (fault maps and baseline "
        f"verify of {n_prot} protected pages)")
    step_fault = {"arm": False}

    def hook(step, retries):
        if step_fault["arm"]:
            raise StepFault("forced persistent step fault")

    front = ServeFront(eng, poll_s=0.01, step_fault_hook=hook)
    # forced worker crash: the next two window fetches fail, past the
    # worker's retry budget (1) -> StoreFault -> the front retries the step
    eng.streamer.max_fetch_retries = 1
    eng.streamer.retry_backoff_s = 0.001
    crash = {"left": 0}
    real_window = eng.streamer._window

    def window(g):
        if crash["left"] > 0:
            crash["left"] -= 1
            raise IOError("forced NAND channel crash")
        return real_window(g)

    eng.streamer._window = window
    _zero_counts()
    t0 = time.perf_counter()
    handles = _add_all(front, eng, prompts, CHAOS_NEW)
    next(iter(handles[0]))                  # serving is under way
    crash["left"] = 2
    got = [h.result(timeout=600) for h in handles]
    step_fault["arm"] = True                # a sacrificial request under a
    sac = front.add_request([9, 9, 9], max_new=CHAOS_NEW)   # persistent fault
    assert sac._done.wait(600), "sacrificial request hung"
    step_fault["arm"] = False
    rec = _add_all(front, eng, [CHAOS_RECOVERY], CHAOS_NEW)[0]
    got_rec = rec.result(timeout=600)
    armed_s = time.perf_counter() - t0
    counts = _stream_counts()
    steps = len(eng.stats)
    _drained(front, eng, free0)
    code, health = front.health()
    st = front.stats()
    ss = store.stats()
    front.close()
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert got == base, [i for i, (a, b) in enumerate(zip(got, base))
                         if a != b]
    assert got_rec == base_rec, (got_rec, base_rec)
    assert all(h.finish_reason == "length" for h in handles + [rec])
    assert sac.finish_reason == "error", sac.finish_reason
    for k in ("ecc_corrected_pages", "uecc_detected", "read_retries",
              "relocations"):
        assert ss[k] > 0, (k, ss)
    assert st["stream"]["fetch_faults"] >= 1 and st["step_retries"] >= 1
    assert st["step_faults"] >= 1 and st["requests_failed"] == 1
    assert (code, health["status"]) == (200, "degraded"), (code, health)
    assert eng.pool.n_free_blocks == free0
    assert eng.wpool.used_pages == resident, (eng.wpool.used_pages, resident)
    # a step that faulted after a group's compute had launched re-launches
    # it on the retry
    for k, n in per_step.items():
        assert steps * n <= counts[k] <= (steps + st["step_retries"]) * n, \
            (counts, steps, st["step_retries"])
    verify_rate = store.pages_verified / max(store.verify_s, 1e-9)
    # the injector's own cost a page, on a fresh injector (its draws: one
    # generator per (page, read), the reference's seeding)
    inj = FaultInjector(FaultConfig(**CHAOS))
    row = np.zeros((store.page_bytes,), np.uint8)
    t0 = time.perf_counter()
    for pid in range(4096):
        inj.corrupt_page(pid, row)
    inject_us = (time.perf_counter() - t0) / 4096 * 1e6
    log(f"  armed front: {CHAOS_N} requests + a sacrificial + recovery in "
        f"{steps} steps, {armed_s:.2f} s = {armed_s / steps * 1e3:.1f} "
        f"ms/step (fault-free {clean_s / clean_steps * 1e3:.1f}); every "
        "request's tokens equal the fault-free front's, the sacrificial "
        "one ended 'error'; launches " + str(counts))
    log(f"  host verify: {store.pages_verified} pages in {store.verify_s:.2f}"
        f" s = {verify_rate:.0f} pages/s = "
        f"{verify_rate * store.page_bytes / 1e9:.2f} GB/s "
        f"({store.verify_s / armed_s:.3f} of the armed run's wall time); "
        f"the injector {inject_us:.1f} us a page")
    log("  counters: " + ", ".join(f"{k} {ss[k]}" for k in (
        "ecc_corrected_pages", "uecc_detected", "read_retries",
        "retry_corrected", "relocations", "fault_transient_flips",
        "fault_stuck_reads", "fault_slow_reads", "fault_io_errors"))
        + f"; worker fetch retries {st['stream']['fetch_retries']}, "
        f"StoreFaults {st['stream']['fetch_faults']}; front step retries "
        f"{st['step_retries']}, persistent faults {st['step_faults']}, "
        f"failed requests {st['requests_failed']}; health {code} "
        f"{health['status']!r}; store grew to {store.n_pages} pages")

    # --- 9(b): a read-only die image degrades -------------------------------------
    die_prompts = prompts[:DIE_PROMPTS]
    dram = dram_tier(params)
    del eng, front
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "opt-6.7b-2l.img")
        t0 = time.perf_counter()
        store.save(path)
        save_s = time.perf_counter() - t0
        del store
        gc.collect()
        outs, stats = [], None
        for armed in (False, True):
            die = PageStore.open(path)
            eng, _ = streamed(die, dram)
            if armed:
                die.attach_injector(FaultInjector(FaultConfig(
                    seed=4, stuck_page_rate=DIE_STUCK)))
            fr = ServeFront(eng)
            hs = _add_all(fr, eng, die_prompts, CHAOS_NEW)
            outs.append([h.result(timeout=600) for h in hs])
            fr.close()
            stats = die.stats()
            del eng, fr, die
            gc.collect()
    assert outs[1] == outs[0], outs
    assert stats["degraded_pages"] > 0 and stats["dram_fallback_reads"] > 0
    assert stats["relocations"] == 0
    log(f"  die image ({save_s:.1f} s to save), read-only, stuck rate "
        f"{DIE_STUCK}: {DIE_PROMPTS} requests' tokens equal the image's "
        f"fault-free run; {stats['degraded_pages']} pages degraded, "
        f"{stats['dram_fallback_reads']} DRAM-tier fallback reads, "
        f"{stats['uecc_detected']} UECC, {stats['read_retries']} retries")
    del params, dram
    gc.collect()
    torch.cuda.empty_cache()
    return dict(clean_ms=clean_s / clean_steps * 1e3,
                armed_ms=armed_s / steps * 1e3, attach_s=attach_s,
                verify_pages_per_s=verify_rate, inject_us=inject_us,
                counters=ss)


def phase_prefix(torch):
    """9(c): full-depth OPT-6.7B on the card, compiled (one graph), with
    prefix_cache=True behind a ServeFront: prompts sharing a 256-token
    prefix served cold, then warm."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.kernels import ecdp, paged_attn
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import ServeFront

    cfg = OPT_6_7B
    t0 = time.perf_counter()
    # phase 4's seeded weights (made anew: phase 4's engines are gone)
    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    eng = Engine(cfg, params, max_slots=4, max_seq=2048, rber=1e-4, seed=0,
                 admission_cfg=AdmissionConfig(chunk_tokens=16,
                                               token_budget=1024),
                 device="cuda", prefix_cache=True)
    del params
    gc.collect()
    log(f"  {cfg.name}, {cfg.n_layers} layers, prefix_cache=True: built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(11)
    v = cfg.vocab_size
    system = rng.integers(0, v, PREFIX_LEN).tolist()
    prompts = [system + rng.integers(0, v, n).tolist() for n in PREFIX_TAILS]
    rows: dict[int, list] = {}              # rid -> sampled rows' logits
    real_step = eng.step

    def step():
        with eng._cv:
            before = {rid: len(r.out) for rid, r in eng.requests.items()}
            n = real_step()
            if n:
                for rid, r in eng.requests.items():
                    if len(r.out) > before.get(rid, 0):
                        rows.setdefault(rid, []).append(
                            eng.last_logits[r.slot].cpu())
            return n

    eng.step = step
    front = ServeFront(eng)
    free0 = eng.pool.n_free_blocks
    ecdp.ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    # Algorithm 2 moves column groups as the batch's KV grows; a warm
    # request reaches its lengths in fewer steps than its cold twin did,
    # so the two are compared once every group is on the flash side
    warm_up = rng.integers(0, v, PREFIX_WARMUP).tolist()
    _add_all(front, eng, [warm_up], 1)[0].result(timeout=600)
    assert eng.stats[-1]["npu_fraction"] == 0.0, eng.stats[-1]
    runs = {}
    for what in ("cold", "warm"):
        start = len(eng.stats)
        saved0 = eng.prefix_stats()["prefix_prefill_tokens_saved"]
        t0 = time.perf_counter()
        hs = _add_all(front, eng, prompts, PREFIX_NEW)
        outs = [h.result(timeout=600) for h in hs]
        wall = time.perf_counter() - t0
        runs[what] = dict(
            out=outs, rids=[h.rid for h in hs],
            rows=[list(rows[h.rid]) for h in hs],
            lanes=sum(s["prefill_tokens"] for s in eng.stats[start:]),
            steps=len(eng.stats) - start, wall=wall,
            saved=eng.prefix_stats()["prefix_prefill_tokens_saved"] - saved0)
    launches = {"ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    _drained(front, eng, free0 - len(eng.prefix))
    traces = eng.step_traces
    ps = eng.prefix_stats()
    front.close()
    cold, warm = runs["cold"], runs["warm"]
    compared = bit_equal = 0
    max_diff = 0.0
    for i, (a, b) in enumerate(zip(cold["rows"], warm["rows"])):
        assert len(a) == len(b) == PREFIX_NEW, (i, len(a), len(b))
        for j, (ra, rb) in enumerate(zip(a, b)):
            tol = PARITY_REL_TOL * float(ra.abs().max())
            diff = float((ra - rb).abs().max())
            max_diff = max(max_diff, diff)
            bit_equal += int(torch.equal(ra, rb))
            assert diff <= tol, (i, j, diff, tol)
            top2 = torch.topk(ra, 2).values
            if float(top2[0] - top2[1]) > 2 * tol:
                assert cold["out"][i][j] == warm["out"][i][j], (i, j)
                compared += 1
            elif cold["out"][i][j] != warm["out"][i][j]:
                break                         # a near tie: the rest differs
    assert compared > 0
    assert warm["saved"] >= PREFIX_LEN * len(prompts), warm["saved"]
    assert warm["lanes"] < cold["lanes"], (warm["lanes"], cold["lanes"])
    assert traces == 1, traces
    # the compiled engine launches in its warm-up and its capture only (the
    # first step, the warm-up request's); the replays tick no counter
    assert launches == {"ecdp": 2 * (cfg.n_layers * 4 + 1),
                        "paged_attn": 2 * cfg.n_layers}, launches
    n_rows = sum(len(r) for r in cold["rows"])
    log(f"  cold: {len(prompts)} prompts ({PREFIX_LEN}-token shared prefix "
        f"+ tails {list(PREFIX_TAILS)}), {cold['lanes']} prefill lanes in "
        f"{cold['steps']} steps, {cold['wall']:.2f} s; warm: "
        f"{warm['lanes']} lanes in {warm['steps']} steps, "
        f"{warm['wall']:.2f} s, {warm['saved']} prefill tokens saved")
    log(f"  warm vs cold: {compared} of {n_rows} greedy tokens compared "
        f"(margin > 2 tol) and equal, {bit_equal} of {n_rows} logits rows "
        f"bit-equal, max |diff| {max_diff:.3e}; step_traces {traces}; "
        f"prefix {ps['prefix_hits']} hits, {ps['prefix_entries']} entries")
    del eng, front, rows
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cold=cold["lanes"], warm=warm["lanes"],
                compared=compared, bit_equal=bit_equal)



# --- phase 10: speculative serving ------------------------------------------------

SPEC_K, SPEC_NEW = 4, 48
# four periodic prompts: the n-gram drafter finds their patterns at once
SPEC_PROMPTS = ([13] * 8, [7, 9] * 4, [101, 102, 103, 104] * 2,
                [5, 11, 5, 11, 5, 11, 5, 2])
SPEC_PROFILE_STEPS = 4
SPEC_STREAM_LAYERS = 2


def _spec_engine(torch, cfg, seed=0, kv_aware=False, **kw):
    """Engine(cfg) on the card from the seeded init (phase 4's weights at
    seed 0), RBER 1e-4, 4 slots, max_seq 2048, chunk 16; kv_aware off by
    default, as the reference's spec tests run (spec and vanilla engines
    take different step trajectories, and Algorithm 2 moves per step)."""
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    kw.setdefault("admission_cfg", AdmissionConfig(chunk_tokens=16,
                                                   token_budget=64))
    eng = Engine(cfg, params, max_slots=4, max_seq=2048, rber=1e-4, seed=0,
                 kv_aware=kv_aware, device="cuda", **kw)
    del params
    gc.collect()
    return eng


def _margin_ok(torch, rows):
    """Per logits row: is its top-2 margin at least twice phase 5's bound
    (2 x 2^-6 of the row's largest |logit|)?"""
    top2 = torch.topk(rows, 2, dim=-1).values
    tol = PARITY_REL_TOL * rows.abs().amax(dim=-1)
    return ((top2[:, 0] - top2[:, 1]) > 2 * tol).cpu().tolist()


def spec_wave(torch, eng, check=False, margins=False):
    """SPEC_PROMPTS (SPEC_NEW new tokens each) handed to the engine under
    its lock, so its first step admits and prefills them all, then served
    to completion. ``check``: after every step the device lengths equal
    the host mirror and no request is past max_new. ``margins``: per
    request, whether each emitted token's logits row passes the margin
    rule (one token a step: a vanilla engine). Returns the tokens, the
    steps, and the decode steps' wall time (after the prefill step) and
    their generated tokens."""
    with eng._cv:
        rids = [eng.submit(list(p), max_new=SPEC_NEW) for p in SPEC_PROMPTS]
    ok = {rid: [] for rid in rids}
    steps, t_dec0 = 0, None
    torch.cuda.synchronize()
    while True:
        before = {rid: len(eng.requests[rid].out) for rid in rids}
        if not eng.step():
            break
        steps += 1
        if margins:
            emitted = [r for r in rids if len(eng.requests[r].out)
                       > before[r]]
            flags = _margin_ok(torch, eng.last_logits[
                [eng.requests[r].slot for r in emitted]])
            for r, f in zip(emitted, flags):
                ok[r].append(f)
        if check:
            dev = eng.pool.lengths_dev.cpu().numpy()
            assert (dev == eng.pool.lengths).all(), (dev, eng.pool.lengths)
            assert all(len(eng.requests[r].out) <= SPEC_NEW for r in rids)
        if steps == 1:
            torch.cuda.synchronize()
            t_dec0, n_dec0 = time.perf_counter(), sum(
                len(eng.requests[r].out) for r in rids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_dec0
    out = [list(eng.requests[r].out) for r in rids]
    assert all(len(o) == SPEC_NEW for o in out), [len(o) for o in out]
    return dict(out=out, steps=steps, decode_steps=steps - 1,
                decode_wall=wall, decode_tokens=SPEC_NEW * len(rids) - n_dec0,
                ok=[ok[r] for r in rids])


def _prefix_equal(out, ref, ok):
    """Per request, the length of the vanilla prefix before its first
    token that fails the margin rule; fails unless ``out`` equals the
    vanilla tokens there."""
    lens = []
    for o, r, flags in zip(out, ref, ok):
        n = next((i for i, f in enumerate(flags) if not f), len(flags))
        assert o[:n] == r[:n], (o[:n], r[:n])
        lens.append(n)
    return lens


def time_verify_head(torch, eng) -> dict:
    """The verify lanes' lm_head call, M = slots x (k + 1), on the engine's
    own lm_head: the kernel against its plain version (phase 2's bound),
    timed beside the plain version, torch.matmul on the dequantised bf16
    weights, and the bound."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    fw = eng.params["lm_head"]
    k, n = fw.q.shape
    m = eng.pool.n_slots * (eng.spec_cfg.k + 1)
    a = torch.randn((m, k), generator=torch.Generator(
        device="cuda").manual_seed(20), device="cuda").to(torch.bfloat16)
    got = ecdp_matmul(a, fw.q, fw.parity, fw.scale, True)
    want = ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale, True)
    mag = (a.float().abs() @ fw.q.float().abs()) * fw.scale
    err = (got - want).abs()
    assert bool((err <= 1e-4 + 4 * math.sqrt(k) * EPS32 * mag).all()), \
        float(err.max())
    del mag
    timer = Timer(torch)
    t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity, fw.scale, True))
    t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale,
                                              True), reps=3)
    w_deq = dequantize_int8(fw.q, fw.scale)
    t_lib = timer(lambda: torch.matmul(a, w_deq))
    del timer, w_deq
    b_ms, b_by = bound_ms(k * n * 9 / 8 + 4 * n + 2 * m * k + 4 * m * n,
                          2.0 * m * k * n)
    log(f"  ecdp at the verify lanes' lm_head M={m} K={k} N={n}: kernel "
        f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul bf16 "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); max abs err "
        f"{float(err.max()):.3e}")
    return dict(m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=float(err.max()))


def phase_spec(torch):
    """10(a) resident, compiled: vanilla then the n-gram spec engine on
    the same weights; (b) the model drafter; (d) temperature 0.8, top-k
    40; (c) the streamed plane at 2 layers against the resident spec
    engine and the vanilla streamed engine."""
    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.models import dense
    from repro_torch.serving.sampler import SampleConfig
    from repro_torch.serving.spec import SpecConfig
    from repro_torch.store import PageStore, StreamConfig

    cfg = OPT_6_7B
    res = {}
    # --- (a) resident, compiled: vanilla, then spec -------------------------
    # kv_aware off (the gates: one trajectory of numerics for both engines;
    # the Q/O projections stay on the DRAM side, so L x 2 + 2 ECDP calls a
    # spec step), then on (the main path's Algorithm 2: L x 4 + 2, timed
    # and profiled)
    base = None
    for kv in (False, True):
        what = f"kv_aware {'on' if kv else 'off'}"
        t0 = time.perf_counter()
        van = _spec_engine(torch, cfg, kv_aware=kv)
        first = spec_wave(torch, van, margins=not kv)
        timed = spec_wave(torch, van)
        assert van.step_traces == 1
        if not kv:
            base = first
            assert timed["out"] == first["out"]
        van_ms = timed["decode_wall"] / timed["decode_steps"] * 1e3
        van_tps = timed["decode_tokens"] / timed["decode_wall"]
        log(f"  vanilla {cfg.name} (compiled, {what}): {first['steps']} "
            f"steps a wave; decode {van_ms:.2f} ms/step, {van_tps:.1f} "
            f"generated tokens/s (built and served in "
            f"{time.perf_counter() - t0:.1f} s)")
        del van
        gc.collect()
        torch.cuda.empty_cache()

        eng = _spec_engine(torch, cfg, kv_aware=kv,
                           spec_cfg=SpecConfig(k=SPEC_K))
        _zero_counts()
        run = spec_wave(torch, eng, check=True)
        launches = _stream_counts()
        per_step = {"ecdp": cfg.n_layers * (4 if kv else 2) + 2,
                    "paged_attn": cfg.n_layers}
        # the warm-up and the capture (the replays tick no counter)
        assert launches == {"ecdp": 2 * per_step["ecdp"], "paged_ecdp": 0,
                            "paged_attn": 2 * per_step["paged_attn"]}, \
            launches
        st = eng.spec_stats()
        assert st["spec_accepted"] > 0, st
        # the token gate where both engines take one bitmap: kv_aware off
        prefix = (None if kv else
                  _prefix_equal(run["out"], base["out"], base["ok"]))
        timed = spec_wave(torch, eng)
        if not kv:
            assert timed["out"] == run["out"]
        spec_ms = timed["decode_wall"] / timed["decode_steps"] * 1e3
        spec_tps = timed["decode_tokens"] / timed["decode_wall"]
        st = eng.spec_stats()
        prof = None
        if kv:
            # a third wave's prefill, then SPEC_PROFILE_STEPS untraced and
            # as many traced verify steps (at most 5 tokens a slot a step,
            # so every request still owes tokens)
            with eng._cv:
                for p in SPEC_PROMPTS:
                    eng.submit(list(p), max_new=SPEC_NEW)
            eng.step()
            prof = trace_steps(torch, eng.step, SPEC_PROFILE_STEPS, per_step,
                               captured=eng.captured)
            prof = {k: prof[k] for k in ("ms_per_step", "device_ms_per_step",
                                         "idle_share", "replay_ms",
                                         "groups_ms", "records")}
            eng.run()
            prof["verify_head"] = time_verify_head(torch, eng)
        assert eng.step_traces == 1
        log(f"  spec k={SPEC_K} (n-gram, compiled, {what}): {run['steps']} "
            f"steps a wave against {first['steps']}; decode {spec_ms:.2f} ms"
            f" per verify step against vanilla {van_ms:.2f}; "
            f"{st['spec_tokens_per_step']:.3f} tokens per verify step, "
            f"acceptance {st['spec_acceptance_rate']:.3f}; {spec_tps:.1f} "
            f"generated tokens/s against {van_tps:.1f}; step_traces "
            f"{eng.step_traces}; launches {launches} (warm-up + capture, "
            f"{per_step['ecdp']} ECDP calls a step)")
        if not kv:
            log(f"  spec tokens equal vanilla's before each request's first "
                f"token under the margin rule: prefixes {prefix} of "
                f"{SPEC_NEW}")
        res["resident_kv_aware" if kv else "resident"] = dict(
            steps=run["steps"], vanilla_steps=first["steps"],
            ms_per_verify_step=spec_ms, vanilla_ms_per_step=van_ms,
            tokens_per_verify_step=st["spec_tokens_per_step"],
            acceptance=st["spec_acceptance_rate"], tokens_per_s=spec_tps,
            vanilla_tokens_per_s=van_tps, prefix_equal=prefix,
            launches=launches, ecdp_per_step=per_step["ecdp"], profile=prof)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # --- (b) the model drafter -----------------------------------------------
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft",
                               n_layers=max(cfg.n_layers // 4, 1),
                               d_model=max(cfg.d_model // 2, 64),
                               n_heads=max(cfg.n_heads // 2, 1),
                               n_kv_heads=max(cfg.n_kv_heads // 2, 1),
                               d_ff=max(cfg.d_ff // 2, 128))
    dparams = dense.init(dcfg, torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    eng = _spec_engine(torch, cfg, spec_cfg=SpecConfig(
        k=3, drafter="model", draft_window=16), draft_cfg=dcfg,
        draft_params=dparams)
    del dparams
    run = spec_wave(torch, eng, check=True)
    st = eng.spec_stats()
    assert st["spec_tokens_per_step"] >= 1.0 and eng.step_traces == 1, st
    prefix_m = _prefix_equal(run["out"], base["out"], base["ok"])
    ms_m = run["decode_wall"] / run["decode_steps"] * 1e3
    log(f"  model drafter ({dcfg.n_layers} layers, d_model {dcfg.d_model}, "
        f"{dcfg.n_heads} heads, d_ff {dcfg.d_ff}, k=3, window 16): "
        f"{run['steps']} steps, {ms_m:.2f} ms per verify step (first wave), "
        f"{st['spec_tokens_per_step']:.3f} tokens per verify step, "
        f"{st['spec_accepted']} of {st['spec_drafted']} drafts accepted; "
        f"prefixes equal to vanilla {prefix_m}")
    res["model_drafter"] = dict(
        steps=run["steps"], ms_per_verify_step=ms_m,
        tokens_per_verify_step=st["spec_tokens_per_step"],
        acceptance=st["spec_acceptance_rate"], drafted=st["spec_drafted"],
        prefix_equal=prefix_m)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # --- (d) temperature 0.8, top-k 40, compiled ------------------------------
    eng = _spec_engine(torch, cfg, spec_cfg=SpecConfig(k=SPEC_K),
                       sample_cfg=SampleConfig(temperature=0.8, top_k=40))
    run = spec_wave(torch, eng, check=True)
    assert all(0 <= t < cfg.vocab_size for o in run["out"] for t in o)
    assert eng.step_traces == 1
    st = eng.spec_stats()
    log(f"  temperature 0.8, top-k 40: {len(run['out'])} x {SPEC_NEW} tokens"
        f" in {run['steps']} steps, all in the vocabulary; "
        f"{st['spec_tokens_per_step']:.3f} tokens per verify step, "
        f"{st['spec_accepted']} of {st['spec_drafted']} drafts accepted; "
        f"step_traces {eng.step_traces}")
    res["temperature"] = dict(steps=run["steps"],
                              tokens_per_verify_step=st[
                                  "spec_tokens_per_step"],
                              acceptance=st["spec_acceptance_rate"],
                              drafted=st["spec_drafted"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # --- (c) streamed, 2 layers -------------------------------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=SPEC_STREAM_LAYERS,
                               name=f"{cfg.name}-{SPEC_STREAM_LAYERS}l")
    d, f, v = cfg2.d_model, cfg2.d_ff, cfg2.vocab_size
    group = _payload(d, f) + _payload(f, d) + 4 * _payload(d, d)
    stream_cfg = StreamConfig(group_size=1, prefetch_depth=2,
                              device_budget_bytes=_payload(d, v) + 2 * group)
    # token_budget 1024: the stall's contraction never binds, so the
    # streamed and the resident engine plan the same steps
    kw = dict(admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024))
    stm = _spec_engine(torch, cfg2, seed=9, spec_cfg=SpecConfig(k=SPEC_K),
                       weight_store=PageStore(n_planes=32),
                       stream_cfg=stream_cfg, **kw)
    with stm._cv:
        for p in SPEC_PROMPTS:
            stm.submit(list(p), max_new=SPEC_NEW)
    rows, step_s = [], []
    _zero_counts()
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not stm.step():
            break
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rows.append((stm.last_logits.cpu(), stm.last_lane_logits.cpu()))
    launches = _stream_counts()
    steps = len(rows)
    # kv_aware off: the FFN's two paged calls a layer (the Q/O flash copies
    # stay unread), lm_head and the verify lanes' lm_head
    assert launches == {"ecdp": 2 * steps,
                        "paged_ecdp": 2 * SPEC_STREAM_LAYERS * steps,
                        "paged_attn": SPEC_STREAM_LAYERS * steps}, launches
    out = [list(r.out) for r in stm.requests.values()]
    assert all(len(o) == SPEC_NEW for o in out)
    resid = _spec_engine(torch, cfg2, seed=9, spec_cfg=SpecConfig(k=SPEC_K),
                         **kw)
    with resid._cv:
        for p in SPEC_PROMPTS:
            resid.submit(list(p), max_new=SPEC_NEW)
    for i, want in enumerate(rows):
        assert resid.step() > 0
        for what, b in zip(("last_logits", "last_lane_logits"), want):
            a = getattr(resid, what).cpu()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"step {i}: the resident spec engine's {what} differ "
                    f"from the streamed one's by {float((a - b).abs().max())}")
    assert resid.step() == 0
    assert [list(r.out) for r in resid.requests.values()] == out
    sst = stm.stream_stats()
    win_spec = sst["groups_streamed"] / len(stm.stats)
    assert sst["spec_verify_steps"] < sst["spec_emitted"], sst
    assert resid.step_traces == 1 and stm.step_traces == -1
    del resid, stm
    gc.collect()
    torch.cuda.empty_cache()
    van = _spec_engine(torch, cfg2, seed=9,
                       weight_store=PageStore(n_planes=32),
                       stream_cfg=stream_cfg, **kw)
    with van._cv:
        for p in SPEC_PROMPTS:
            van.submit(list(p), max_new=16)
    t0 = time.perf_counter()
    van.run()
    torch.cuda.synchronize()
    van_wall = time.perf_counter() - t0
    win_van = van.stream_stats()["groups_streamed"] / len(van.stats)
    assert win_spec == win_van == SPEC_STREAM_LAYERS, (win_spec, win_van)
    ms_s = sum(step_s[1:]) / (steps - 1) * 1e3     # the verify steps
    log(f"  streamed {cfg2.name} (cut: {SPEC_STREAM_LAYERS} of 32 layers), "
        f"budget lm_head + 2 windows: {steps} steps ({steps - 1} verify), "
        f"{ms_s:.1f} ms "
        f"per verify step (vanilla streamed "
        f"{van_wall / len(van.stats) * 1e3:.1f} ms/step); "
        f"{sst['spec_tokens_per_step']:.3f} tokens per window rotation, "
        f"acceptance {sst['spec_acceptance_rate']:.3f}; {win_spec:.0f} "
        f"windows a step as vanilla's {win_van:.0f}; logits and lane logits "
        f"bit-equal to the resident spec engine's (compiled) at all {steps}"
        f" steps; launches {launches}")
    res["streamed"] = dict(steps=steps, ms_per_verify_step=ms_s,
                           vanilla_ms_per_step=van_wall / len(van.stats) * 1e3,
                           tokens_per_window_rotation=sst[
                               "spec_tokens_per_step"],
                           acceptance=sst["spec_acceptance_rate"],
                           windows_per_step=win_spec, launches=launches)
    del van
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --- phase 11: the command line and granite-8b ------------------------------

# granite-8b's flash matmuls (wq/wo the Q/O flash copies, 32 x 128 = 4096
# columns; the SwiGLU FFN; lm_head over the 49152-token vocabulary) at a
# serving step's M (slots x chunk = 64; lm_head at M = slots = 4) and at 4
GRANITE_ECDP = {"wq/wo": (4096, 4096), "w_gate/w_up": (4096, 14336),
                "w_down": (14336, 4096), "lm_head": (4096, 49152)}
GRANITE_ECDP_M = {"wq/wo": 64, "w_gate/w_up": 64, "w_down": 64, "lm_head": 4}
# one granite layer's paged attention: 4 slots, 8 KV heads, 16 chunk lanes
# x rep 4 = 64 query rows a head, Dh 128, block 16, phase 3's table width
GRANITE_PAGED = (4, 8, 64, 128, 16, 128)
GRANITE_PROMPTS, GRANITE_NEW = (7, 64, 200, 33, 130, 96), 16
# 11(b)'s depth: 12 of granite-8b's 36 layers, for the script's time
GRANITE_LAYERS = 12
GRANITE_WORK = ROOT / "build" / "chip_smoke_phase11"


def granite_kernels(torch, timer) -> dict:
    """11(a): the ECDP and paged attention against their plain versions at
    granite-8b's shapes, each timed beside its plain version and the
    library."""
    import torch.nn.functional as F

    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain
    from repro_torch.kernels.paged_attn import (kernel_errors, paged_attn,
                                                paged_attn_plain)

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst, per_launch = 0.0, {}
    for name, (k, n) in GRANITE_ECDP.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=k + n) for r in (0.0, 2e-3)}
        del w
        for m in (4, 64):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            for rber, fw in flash.items():
                for ecc_on in (True, False):
                    worst = max(worst, ecdp_case(
                        torch, a, fw, ecc_on, f"{name} M={m} rber={rber}")[0])
            if m != GRANITE_ECDP_M[name]:
                continue
            fw = flash[2e-3]
            w_deq = dequantize_int8(fw.q, fw.scale)
            t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity,
                                                 fw.scale, True))
            t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity,
                                                      fw.scale, True), reps=3)
            t_lib = timer(lambda: torch.matmul(a, w_deq))
            del w_deq
            b_ms, b_by = bound_ms(k * n * 9 / 8 + 4 * n + 2 * m * k
                                  + 4 * m * n, 2.0 * m * k * n)
            per_launch[name] = dict(m=m, k=k, n=n, ms=t_kernel,
                                    plain_ms=t_plain, library_ms=t_lib,
                                    bound_ms=b_ms, bound_by=b_by)
            log(f"  ecdp {name:12s} M={m:3d} K={k:5d} N={n:5d}: kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul "
                f"bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del flash
    log(f"  ecdp at granite-8b's shapes vs plain: max abs err {worst:.3e} "
        "(32 cases)")

    b, n_kv, tr, dh, bs, max_blocks = GRANITE_PAGED
    lens = torch.tensor(PAGED_CTX, dtype=torch.int32, device="cuda")
    tables = scrambled_tables(torch, gen, PAGED_CTX, bs, max_blocks)
    n_blocks = 1 + b * max_blocks

    def bf(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    q = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k_pool, v_pool = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    acc, m, l = paged_attn(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    errs = kernel_errors(q, k_pool, v_pool, tables, lens, acc, m, l)
    max_abs = errs.pop("max_abs_err")
    if not all(v <= 1 for v in errs.values()):
        raise AssertionError(f"paged attention at granite-8b's shape: error "
                             f"/ bound {errs}")
    t_kernel = timer(lambda: paged_attn(q, k_pool, v_pool, tables, lens))
    t_plain = timer(lambda: paged_attn_plain(q, k_pool, v_pool, tables,
                                             lens), reps=3)
    s_pad = max_blocks * bs
    kg = k_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
        1, 2).contiguous()
    vg = v_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
        1, 2).contiguous()
    mask = (torch.arange(s_pad, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask, scale=1.0))
    live = sum(PAGED_CTX)
    b_ms, b_by = bound_ms(live * n_kv * dh * 2 * 2 + q.numel() * 2
                          + acc.numel() * 4 + 2 * m.numel() * 4
                          + tables.numel() * 4 + b * 4,
                          4.0 * tr * dh * n_kv * live)
    log(f"  paged_attn B={b} KV={n_kv} TR={tr} Dh={dh} ctx={PAGED_CTX}: "
        "error / bound " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ecdp=dict(max_abs_err=worst, per_launch=per_launch),
                paged_attn=dict(ctx=PAGED_CTX, b=b, kv=n_kv, tr=tr, dh=dh,
                                max_abs_err=max_abs, ms=t_kernel,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by))


def granite_run(torch, eng, prompts) -> dict:
    """``prompts`` (GRANITE_NEW new each) served to completion with the
    launch counters zeroed just before and read just after; every step's
    logits kept on the host."""
    from repro_torch.kernels import ecdp, paged_attn

    rids = [eng.submit(p, max_new=GRANITE_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ecdp.ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    logits = []
    t0 = time.perf_counter()
    while eng.step():
        logits.append(eng.last_logits.cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = [list(eng.requests[r].out) for r in rids]
    assert all(len(o) == GRANITE_NEW for o in out), out
    assert all(0 <= t < eng.cfg.vocab_size for o in out for t in o)
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    return dict(out=out, logits=logits, steps=len(logits), wall_s=wall,
                launches={"ecdp": ecdp.ecdp_matmul.launches,
                          "paged_attn": paged_attn.paged_attn.launches},
                peak_bytes=torch.cuda.max_memory_allocated(),
                stats=list(eng.stats))


def granite_full(torch, timer) -> dict:
    """11(b): granite-8b at full width, GRANITE_LAYERS of 36 layers, through
    build_engine, compiled, then an eager engine on the same seed
    (bit-equal logits; its counters give GRANITE_LAYERS x 5 + 1 ECDP and
    GRANITE_LAYERS paged-attention launches a step), then serve() at the
    default temperature 0.8."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig

    cfg = dataclasses.replace(get_config("granite-8b"),
                              n_layers=GRANITE_LAYERS,
                              name=f"granite-8b-{GRANITE_LAYERS}l")

    full_build = serve_mod.build_engine

    def build_engine(*a, **kw):
        """serve.build_engine with the registry's granite-8b at full width,
        its depth cut to GRANITE_LAYERS"""
        full_config = serve_mod.get_config
        serve_mod.get_config = lambda arch, smoke=False: (
            cfg if arch == "granite-8b" and not smoke
            else full_config(arch, smoke))
        try:
            return full_build(*a, **kw)
        finally:
            serve_mod.get_config = full_config
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in GRANITE_PROMPTS]
    per_step = {"ecdp": cfg.n_layers * 5 + 1, "paged_attn": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine("granite-8b", smoke=False, device="cuda", rber=1e-4,
                       sample_cfg=SampleConfig())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    log(f"  build_engine granite-8b ({cfg.n_layers} of 36 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}): {build_s:.1f} s, peak "
        f"{build_peak / 2**30:.2f} GiB while deploying, "
        f"{resident / 2**30:.2f} GiB resident")
    comp = granite_run(torch, eng, prompts)
    assert eng.step_traces == 1, eng.step_traces
    # warm-up and capture
    assert comp["launches"] == {k: 2 * n for k, n in per_step.items()}, \
        comp["launches"]
    # the replays are held by the capture's counters above and by their
    # logits, equal to the eager engine's at every step below
    prof = profile_steps(torch, eng, prompts, per_step,
                         require_records=False)
    assert eng.step_traces == 1, eng.step_traces
    calls = ecdp_step_calls(eng)
    assert len(calls) == per_step["ecdp"], len(calls)
    step = time_ecdp_step(torch, timer, calls)
    del calls, eng
    gc.collect()
    torch.cuda.empty_cache()

    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    eng = Engine(cfg, params, max_slots=4, max_seq=256, rber=1e-4,
                 sample_cfg=SampleConfig(), seed=0, device="cuda",
                 compiled=False)
    del params
    gc.collect()
    eager = granite_run(torch, eng, prompts)
    assert eng.step_traces == -1
    steps = eager["steps"]
    assert eager["launches"] == {k: steps * n for k, n in per_step.items()}, \
        (eager["launches"], steps)
    assert eager["out"] == comp["out"] and eager["stats"] == comp["stats"]
    assert len(comp["logits"]) == steps
    for i, (a, b) in enumerate(zip(comp["logits"], eager["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(f"granite step {i}: replayed logits differ "
                                 f"from the eager step's by "
                                 f"{float((a - b).abs().max())}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    generated = GRANITE_NEW * len(prompts)
    log(f"  compiled: {steps} steps, {comp['wall_s'] / steps * 1e3:.2f} "
        f"ms/step, {generated / comp['wall_s']:.1f} generated tokens/s, "
        f"peak {comp['peak_bytes'] / 2**30:.2f} GiB serving; eager "
        f"{eager['wall_s'] / steps * 1e3:.2f} ms/step; logits bit-equal at "
        f"every step; launches (eager) {eager['launches']} = {steps} x "
        f"{per_step}")
    t0 = time.perf_counter()
    serve_mod.build_engine = build_engine        # serve() builds through it
    try:
        out = serve_mod.serve("granite-8b", smoke=False, device="cuda",
                              n_requests=len(prompts), max_new=GRANITE_NEW)
    finally:
        serve_mod.build_engine = full_build
    assert out["tokens"] == generated and out["traces"] == 1, \
        (out["tokens"], out["traces"])
    assert all(0 <= t < cfg.vocab_size for o in out["outputs"].values()
               for t in o)
    log(f"  serve(granite-8b, temperature 0.8, top-k 40): {out['tokens']} "
        f"tokens, {out['tps']:.1f} generated tokens/s, step traces "
        f"{out['traces']}, {time.perf_counter() - t0:.1f} s with the build")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, ms_per_step=comp["wall_s"] / steps * 1e3,
                eager_ms_per_step=eager["wall_s"] / steps * 1e3,
                tokens_per_s=generated / comp["wall_s"],
                serve_tokens_per_s=out["tps"], build_s=build_s,
                build_peak_bytes=build_peak, resident_bytes=resident,
                peak_bytes=comp["peak_bytes"], launches=eager["launches"],
                per_step=per_step, profile=prof, ecdp_step=step)


def granite_image(torch) -> dict:
    """11(d): granite-8b width cut to 2 layers deployed with a store, the
    image and the DRAM-tier checkpoint written and read back as
    ``build_engine(store_image=, ckpt=)`` does, served against a streamed
    engine programmed from the same params in process: greedy tokens and
    every step's logits bit-equal; 10 paged ECDP, 1 ECDP and 2 paged
    attention launches a step."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.core.tiering import deploy, dram_tier, program_attn_flash
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig
    from repro_torch.store import PageStore, drop_store_refs

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2,
                              name="granite-8b-2l")
    rber, seed = 1e-4, 0
    # token_budget 1024, as phase 7: the streamer's stall never contracts
    # the budget below what the slots use, so both engines plan alike
    kw = dict(max_slots=4, max_seq=256, seed=seed,
              sample_cfg=SampleConfig(), device="cuda",
              admission_cfg=AdmissionConfig(token_budget=1024))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 40, 17, 120)]

    def params():
        return dense.init(cfg, torch.Generator(device="cuda").manual_seed(12),
                          device="cuda")
    shutil.rmtree(GRANITE_WORK, ignore_errors=True)
    GRANITE_WORK.mkdir(parents=True)
    image = str(GRANITE_WORK / "nand.img")
    t0 = time.perf_counter()
    p = params()
    store = PageStore()
    tiered, _ = deploy(p, rber=rber, seed=seed, store=store)
    program_attn_flash(store, p["layers"]["attn"], cfg.n_layers, rber=rber,
                       seed=seed)
    store.save(image)
    CheckpointManager(GRANITE_WORK, keep=1).save(0, drop_store_refs(tiered),
                                                {"arch": cfg.name})
    template = dram_tier(p)
    del p, tiered, store
    t_deploy = time.perf_counter() - t0
    t0 = time.perf_counter()
    opened = PageStore.open(image)
    dram, _ = CheckpointManager(GRANITE_WORK).restore(template, device="cuda")
    del template
    img_eng = Engine(cfg, dram, weight_store=opened, **kw)
    assert img_eng.store_preprogrammed
    del dram
    t_open = time.perf_counter() - t0

    def run(eng):
        rids = [eng.submit(pr, max_new=8) for pr in prompts]
        logits = []
        while eng.step():
            logits.append(eng.last_logits.cpu())
        return [eng.requests[r].out for r in rids], logits

    ecdp.ecdp_matmul.launches = 0
    paged_ecdp.paged_ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    got, got_logits = run(img_eng)
    torch.cuda.synchronize()
    steps = len(got_logits)
    launches = {"paged_ecdp": paged_ecdp.paged_ecdp_matmul.launches,
                "ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    assert launches == {"paged_ecdp": steps * cfg.n_layers * 5,
                        "ecdp": steps, "paged_attn": steps * cfg.n_layers}, \
        (launches, steps)
    img_bytes = opened.image_bytes
    img_eng.close()
    del img_eng, opened
    gc.collect()
    ref_eng = Engine(cfg, params(), weight_store=PageStore(), rber=rber,
                     **kw)
    want, want_logits = run(ref_eng)
    ref_eng.close()
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(GRANITE_WORK, ignore_errors=True)
    assert got == want, (got, want)
    assert len(want_logits) == steps
    for i, (a, b) in enumerate(zip(got_logits, want_logits)):
        if not torch.equal(a, b):
            raise AssertionError(f"die image step {i}: logits differ from "
                                 f"the in-process store's by "
                                 f"{float((a - b).abs().max())}")
    log(f"  {cfg.name}: deploy + image ({img_bytes / 2**30:.2f} GiB) + "
        f"checkpoint {t_deploy:.1f} s, open + restore + engine "
        f"{t_open:.1f} s; {steps} steps, tokens and logits bit-equal to the "
        f"in-process store's; launches {launches}")
    return dict(steps=steps, launches=launches)


def granite_cli(torch) -> None:
    """11(e): ``python -m repro_torch.launch.deploy --store`` then ``python
    -m repro_torch.launch.serve --store-image --ckpt`` on the card, at
    granite-8b-smoke, as a user runs them."""
    import os
    import shutil

    d = GRANITE_WORK / "cli"
    shutil.rmtree(GRANITE_WORK, ignore_errors=True)
    d.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = (["-m", "repro_torch.launch.deploy", "--arch", "granite-8b",
             "--out", str(d), "--store", str(d / "nand.img")],
            ["-m", "repro_torch.launch.serve", "--arch", "granite-8b",
             "--store-image", str(d / "nand.img"), "--ckpt", str(d),
             "--requests", "4", "--max-new", "8"])
    for cmd in cmds:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[:2])} exited "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
        log(f"  python {' '.join(cmd[:2])}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s")
    served = next(ln for ln in run.stdout.splitlines()
                  if ln.startswith("served "))
    log(f"  {served}")
    assert "32 generated tokens" in served and "on cuda" in served, served
    assert "step traces=" in served, served
    shutil.rmtree(GRANITE_WORK, ignore_errors=True)


def phase_granite(torch) -> dict:
    from repro_torch.configs import get_config

    timer = Timer(torch)
    kernels = granite_kernels(torch, timer)
    torch.cuda.empty_cache()
    full = granite_full(torch, timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (c) card vs CPU at granite-8b width, {PARITY_LAYERS} layer")
    phase_parity(torch, dataclasses.replace(
        get_config("granite-8b"), n_layers=PARITY_LAYERS,
        name=f"granite-8b-{PARITY_LAYERS}l"))
    log("  (d) die image round trip at granite-8b width, 2 layers")
    image = granite_image(torch)
    log("  (e) the command line at granite-8b-smoke")
    granite_cli(torch)
    return dict(kernels=kernels, full=full, image=image)


# --- phase 12: MoE serving on the resident plane, qwen3-moe-30b-a3b ----------

MOE_ARCH = "qwen3-moe-30b-a3b"
# 4 of 48 layers, for the script's time (8 until phase 18 came; 48 cannot
# be held anyway: the deploy holds the bf16 tree beside its encoded tiers,
# about 97 GB at 48 layers, past the card's 80 GB)
MOE_LAYERS = 4
# 12(c) and 12(d), the CPU's runs: 1 layer, for the script's time (the
# CPU's steps at 2 layers took 84 s)
MOE_CPU_LAYERS = 1
MOE_ROUTE_TOKENS = 64                  # a serving step's lanes: 4 slots x 16
# one qwen3 layer's paged attention: 4 slots, 4 KV heads, 16 chunk lanes x
# rep 8 = 128 query rows a head, Dh 128, block 16, phase 3's table width
MOE_PAGED = (4, 4, 128, 128, 16, 128)
MOE_PROMPTS, MOE_NEW = (7, 64, 200, 33, 130, 96), 16
MOE_OFFLINE = (4, 64, 8)               # prompts, prompt tokens, decode steps
MOE_OFFLINE_SEED = 12                  # phase 8(c)'s prompt seed
# the offline path's capacity layouts (moe._expert_matmul: expert e owns the
# C+1 rows at e (C+1) of the dispatch buffer, C = max(int(T k / E cf), 1)):
# 12(d)'s prefill, 4 x 64 tokens at capacity factor 1.25 (moe.forward), and
# its decode, 4 tokens at 2.0 (moe.decode_body)
MOE_CAPACITY = {"prefill": (MOE_OFFLINE[0] * MOE_OFFLINE[1], 1.25),
                "decode": (MOE_OFFLINE[0], 2.0)}


def moe_cfg(layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=layers,
                               name=f"{MOE_ARCH}-{layers}l")


def moe_route(torch, gen, router, k: int, tokens: int = MOE_ROUTE_TOKENS):
    """A real ``serve_route`` of ``tokens`` random bf16 lanes through
    ``router``: (order (A,), row_start (E+1,) int32, the experts' row
    counts on the host)."""
    from repro_torch.models import moe

    d, e = router.shape
    x = torch.randn((1, tokens, d), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    _, idx = moe.serve_route(router, x, k)
    flat = idx.reshape(-1).long()
    order, row_start = moe._grouped_rows(flat, flat >= 0, e)
    return order, row_start, (row_start[1:] - row_start[:-1]).tolist()


def grouped_case(torch, a, row_start, fw, ecc_on: bool, what: str,
                 max_rows: int = MOE_ROUTE_TOKENS) -> float:
    """The grouped ECDP against its plain version on every routed row,
    within the ECDP bound (the same integer weights, f32 sums in another
    order: 4 sqrt(K) f32 roundoffs of each output's magnitude). Returns the
    max abs error."""
    from repro_torch.kernels.grouped_ecdp import (grouped_ecdp_matmul,
                                                  grouped_ecdp_plain)

    got = grouped_ecdp_matmul(a, row_start, fw.q, fw.parity, fw.scale,
                              ecc_on, max_rows=max_rows)
    want = grouped_ecdp_plain(a, row_start, fw.q, fw.parity, fw.scale, ecc_on)
    torch.cuda.synchronize()
    bounds = row_start.tolist()
    worst = 0.0
    for e in range(fw.q.shape[0]):
        r0, r1 = bounds[e], bounds[e + 1]
        if r1 == r0:
            continue
        mag = (a[r0:r1].float().abs() @ fw.q[e].float().abs()) * fw.scale[e]
        tol = 1e-4 + 4 * math.sqrt(a.shape[1]) * EPS32 * mag
        err = (got[r0:r1] - want[r0:r1]).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"grouped ecdp {what} ecc={ecc_on} expert "
                                 f"{e}: max err {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def moe_kernels(torch, timer) -> dict:
    """12(a): the grouped ECDP at qwen3's bank shapes over a real route of
    64 tokens at k = 8 (RBER 0 and 2e-3, ECC on and off), timed beside one
    torch.bmm over the capacity-padded rows and beside one layer's 3 x 128
    per-expert ECDP launches at the reference's M = 512; lm_head 2048 x
    151936 at M = 4; paged attention at KV=4, TR=128."""
    import torch.nn.functional as F

    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import (_n_sms, ecdp_matmul,
                                          ecdp_matmul_plain)
    from repro_torch.kernels.grouped_ecdp import (grouped_ecdp_matmul,
                                                  grouped_ecdp_plain,
                                                  grouped_plan)
    from repro_torch.kernels.paged_attn import (kernel_errors, paged_attn,
                                                paged_attn_plain)
    from repro_torch.models import common as cm

    cfg = moe_cfg(1)
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(21)
    router = cm.dense_init(gen, d, e, torch.bfloat16, "cuda")
    order, row_start, counts = moe_route(torch, gen, router, k)
    routed = sum(1 for c in counts if c)
    rows = MOE_ROUTE_TOKENS * k
    log(f"  route of {MOE_ROUTE_TOKENS} tokens at k={k}: {rows} rows over "
        f"{routed} of {e} experts, at most {max(counts)} an expert")
    acts = {d: torch.randn((rows, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16),
            f: torch.randn((rows, f), generator=gen, device="cuda"
                           ).to(torch.bfloat16)}
    worst, per_launch, capacity = 0.0, {}, {}
    for name, (kk, n) in (("w_gate/w_up", (d, f)), ("w_down", (f, d))):
        w = torch.randn((e, kk, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=kk + n) for r in (0.0, 2e-3)}
        del w
        a = acts[kk]
        for rber, fw in flash.items():
            for ecc_on in (True, False):
                worst = max(worst, grouped_case(torch, a, row_start, fw,
                                                ecc_on, f"{name} rber={rber}"))
        fw = flash[2e-3]                          # the serving path: ECC off
        t_kernel = timer(lambda: grouped_ecdp_matmul(
            a, row_start, fw.q, fw.parity, fw.scale, False,
            max_rows=MOE_ROUTE_TOKENS))
        t_plain = timer(lambda: grouped_ecdp_plain(
            a, row_start, fw.q, fw.parity, fw.scale, False), reps=3)
        # the library: one bmm over the capacity-padded (E, 64, K) rows
        w_deq = dequantize_int8(fw.q, fw.scale)
        padded = torch.zeros((e, MOE_ROUTE_TOKENS, kk), dtype=torch.bfloat16,
                             device="cuda")
        t_lib = timer(lambda: torch.bmm(padded, w_deq))
        del w_deq, padded
        # the reference's shape: every expert over all M = 512 rows, one
        # ECDP launch each (3 x 128 a layer: this matrix's share is timed)
        t_ref = timer(lambda: [ecdp_matmul(a, fw.q[x], fw.parity[x],
                                           fw.scale[x], False)
                               for x in range(e)], reps=3,
                      hold=10_000_000)
        nbytes = (routed * (kk * n + 4 * n) + 2 * rows * kk + 4 * rows * n
                  + 4 * (e + 1))
        b_ms, b_by = bound_ms(nbytes, 2.0 * rows * kk * n)
        per_launch[name] = dict(rows=rows, routed=routed, k=kk, n=n,
                                ms=t_kernel, plain_ms=t_plain,
                                library_ms=t_lib, per_expert_ms=t_ref,
                                bound_ms=b_ms, bound_by=b_by)
        log(f"  grouped ecdp {name:12s} R={rows} K={kk:4d} N={n:4d} E={e}: "
            f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.bmm "
            f"(E, 64, K) bf16 {t_lib:.4f} ms, {e} per-expert ecdp at "
            f"M={rows} {t_ref:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        # 12(d)'s capacity layouts: every expert's C+1 rows, the M tile and
        # K splits grouped_plan gives them (decode: the 16-row tile)
        for layout, (tokens, cf) in MOE_CAPACITY.items():
            c1 = max(int(tokens * k / e * cf), 1) + 1
            rs = torch.arange(0, (e + 1) * c1, c1, dtype=torch.int32,
                              device="cuda")
            a_cap = torch.randn((e * c1, kk), generator=gen, device="cuda"
                                ).to(torch.bfloat16)
            plan = grouped_plan(e * c1, e, kk, n, c1, _n_sms(0))
            err = max(grouped_case(torch, a_cap, rs, fw_r, ecc_on,
                                   f"{name} {layout} rber={rber}",
                                   max_rows=c1)
                      for rber, fw_r in flash.items()
                      for ecc_on in (False, True))
            worst = max(worst, err)
            t_cap = timer(lambda: grouped_ecdp_matmul(
                a_cap, rs, fw.q, fw.parity, fw.scale, False, max_rows=c1))
            capacity[f"{name}@{layout}"] = dict(
                rows=e * c1, rows_per_expert=c1, m_tile=plan.m_tile,
                k_splits=plan.splits, max_abs_err=err, ms=t_cap)
            log(f"  grouped ecdp {name:12s} {layout} capacity layout R="
                f"{e * c1} ({c1} rows x {e} experts), M tile {plan.m_tile}, "
                f"{plan.splits} K splits: vs plain max abs err {err:.3e} "
                f"(ECC off / on, RBER 0 / 2e-3); kernel {t_cap:.4f} ms")
        del flash
    log(f"  grouped ecdp vs plain: max abs err {worst:.3e} (8 route cases, "
        f"{4 * len(capacity)} capacity-layout cases)")

    # lm_head at M = slots = 4
    n = cfg.vocab_size
    w = torch.randn((d, n), generator=gen, device="cuda")
    flash = {r: encode_flash(w, rber=r, seed=d + n) for r in (0.0, 2e-3)}
    del w
    a = torch.randn((4, d), generator=gen, device="cuda").to(torch.bfloat16)
    lm_worst = 0.0
    for rber, fw in flash.items():
        for ecc_on in (True, False):
            lm_worst = max(lm_worst, ecdp_case(torch, a, fw, ecc_on,
                                               f"lm_head rber={rber}")[0])
    fw = flash[2e-3]
    w_deq = dequantize_int8(fw.q, fw.scale)
    t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity, fw.scale, True))
    t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale,
                                              True), reps=3)
    t_lib = timer(lambda: torch.matmul(a, w_deq))
    del w_deq, flash
    b_ms, b_by = bound_ms(d * n * 9 / 8 + 4 * n + 2 * 4 * d + 4 * 4 * n,
                          2.0 * 4 * d * n)
    lm_head = dict(m=4, k=d, n=n, ms=t_kernel, plain_ms=t_plain,
                   library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err=lm_worst)
    log(f"  ecdp lm_head M=4 K={d} N={n}: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, torch.matmul bf16 {t_lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); vs plain max abs err {lm_worst:.3e}")

    b, n_kv, tr, dh, bs, max_blocks = MOE_PAGED
    lens = torch.tensor(PAGED_CTX, dtype=torch.int32, device="cuda")
    tables = scrambled_tables(torch, gen, PAGED_CTX, bs, max_blocks)
    n_blocks = 1 + b * max_blocks

    def bf(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    q = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k_pool, v_pool = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    acc, m, l = paged_attn(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    errs = kernel_errors(q, k_pool, v_pool, tables, lens, acc, m, l)
    max_abs = errs.pop("max_abs_err")
    if not all(v <= 1 for v in errs.values()):
        raise AssertionError(f"paged attention at qwen3's shape: error / "
                             f"bound {errs}")
    t_kernel = timer(lambda: paged_attn(q, k_pool, v_pool, tables, lens))
    t_plain = timer(lambda: paged_attn_plain(q, k_pool, v_pool, tables,
                                             lens), reps=3)
    s_pad = max_blocks * bs
    kg = k_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
        1, 2).contiguous()
    vg = v_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
        1, 2).contiguous()
    mask = (torch.arange(s_pad, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask, scale=1.0))
    live = sum(PAGED_CTX)
    b_ms, b_by = bound_ms(live * n_kv * dh * 2 * 2 + q.numel() * 2
                          + acc.numel() * 4 + 2 * m.numel() * 4
                          + tables.numel() * 4 + b * 4,
                          4.0 * tr * dh * n_kv * live)
    log(f"  paged_attn B={b} KV={n_kv} TR={tr} Dh={dh} ctx={PAGED_CTX}: "
        "error / bound " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(grouped=dict(max_abs_err=worst, per_launch=per_launch,
                             capacity_layouts=capacity,
                             route=dict(rows=rows, routed=routed,
                                        max_rows=max(counts))),
                lm_head=lm_head,
                paged_attn=dict(ctx=PAGED_CTX, b=b, kv=n_kv, tr=tr, dh=dh,
                                max_abs_err=max_abs, ms=t_kernel,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by))


def moe_counts():
    from repro_torch.kernels import ecdp, grouped_ecdp, paged_attn
    return {"grouped_ecdp": grouped_ecdp.grouped_ecdp_matmul.launches,
            "ecdp": ecdp.ecdp_matmul.launches,
            "paged_attn": paged_attn.paged_attn.launches}


def moe_zero_counts():
    from repro_torch.kernels import decode_attn, ecdp, grouped_ecdp, paged_attn
    for c in (grouped_ecdp.grouped_ecdp_matmul, ecdp.ecdp_matmul,
              paged_attn.paged_attn, decode_attn.decode_attention_state):
        c.launches = 0


def moe_run(torch, eng, prompts) -> dict:
    """``prompts`` (MOE_NEW new each) served to completion, the launch
    counters zeroed just before and read just after; every step's logits
    kept on the host."""
    rids = [eng.submit(p, max_new=MOE_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moe_zero_counts()
    logits, live = [], []
    t0 = time.perf_counter()
    while eng.step():
        logits.append(eng.last_logits.cpu())
        live.append(eng._host_in["q_lens"].numpy() > 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moe_counts()
    out = [list(eng.requests[r].out) for r in rids]
    assert all(len(o) == MOE_NEW for o in out), out
    assert all(0 <= t < eng.cfg.vocab_size for o in out for t in o)
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    return dict(out=out, logits=logits, live=live, steps=len(logits),
                wall_s=wall, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(),
                stats=list(eng.stats))


def time_moe_step(torch, timer, eng) -> dict:
    """One serving step's L x 3 grouped ECDP calls back to back on the engine's
    own banks: per layer w_gate, w_up (the rows of a real 64-token route
    through the layer's router) and w_down (random bf16 rows on the same
    route). Kernel, plain version, and the library: torch.bmm over the
    capacity-padded (E, 64, K) rows on one layer's dequantised banks
    (reused for every layer: 1.2 GB passes L2 anyway). Then the step's
    L x 3 + 1 flash matmuls (with lm_head at M = 4) for the log; lm_head's own
    numbers are 12(a)'s."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.ecdp import ecdp_matmul
    from repro_torch.kernels.grouped_ecdp import (grouped_ecdp_matmul,
                                                  grouped_ecdp_plain)

    cfg = eng.cfg
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = MOE_ROUTE_TOKENS * cfg.top_k
    calls, nbytes, flops = [], 0.0, 0.0
    for lp in eng._layers:
        _, row_start, counts = moe_route(torch, gen, lp["moe"]["router"],
                                         cfg.top_k)
        routed = sum(1 for c in counts if c)
        for name in ("w_gate", "w_up", "w_down"):
            fw = lp["moe"]["experts"][name]
            kk, n = fw.q.shape[1:]
            a = torch.randn((rows, kk), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            calls.append((a, row_start, fw))
            nbytes += (routed * (kk * n + 4 * n) + 2 * rows * kk
                       + 4 * rows * n + 4 * (cfg.n_experts + 1))
            flops += 2.0 * rows * kk * n
    lm = eng.params["lm_head"]
    a_lm = torch.randn((eng.pool.n_slots, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)

    def kernel():
        for a, rs, fw in calls:
            grouped_ecdp_matmul(a, rs, fw.q, fw.parity, fw.scale, False,
                                max_rows=MOE_ROUTE_TOKENS)

    def whole_step():
        kernel()
        ecdp_matmul(a_lm, lm.q, lm.parity, lm.scale, True)

    def plain():
        for a, rs, fw in calls:
            grouped_ecdp_plain(a, rs, fw.q, fw.parity, fw.scale, False)
    hold = 20_000_000
    t_kernel = timer(kernel, reps=5, hold=hold)
    t_step = timer(whole_step, reps=5, hold=hold)
    t_plain = timer(plain, reps=1, warmup=0)
    lp0 = eng._layers[0]["moe"]["experts"]
    deq = {name: dequantize_int8(fw.q, fw.scale) for name, fw in lp0.items()}
    padded = {kk: torch.zeros((cfg.n_experts, MOE_ROUTE_TOKENS, kk),
                              dtype=torch.bfloat16, device="cuda")
              for kk in (cfg.d_model, cfg.d_ff)}

    def library():
        for _ in eng._layers:
            for name in ("w_gate", "w_up", "w_down"):
                torch.bmm(padded[deq[name].shape[1]], deq[name])
    t_lib = timer(library, reps=5, hold=hold)
    del deq, padded
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  one step's {len(calls)} grouped ECDP calls (ECC off) back to "
        f"back: kernel {t_kernel:.3f} ms, plain {t_plain:.3f} ms, library "
        f"(torch.bmm, bf16) {t_lib:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
        f"with lm_head, the step's {len(calls) + 1} flash matmuls "
        f"{t_step:.3f} ms")
    return dict(calls=len(calls), ms=t_kernel, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                with_lm_head_ms=t_step)


def moe_full(torch, timer) -> dict:
    """12(b): qwen3-moe-30b-a3b at full width, MOE_LAYERS of 48 layers,
    through build_engine (RBER 1e-4, greedy), compiled; then an eager
    engine on the same seed: logits bit-equal at every step, MOE_LAYERS x 3
    grouped ECDP + 1 ECDP and MOE_LAYERS paged attention launches a
    step."""
    import numpy as np

    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig

    cfg = moe_cfg(MOE_LAYERS)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in MOE_PROMPTS]
    per_step = {"grouped_ecdp": cfg.n_layers * 3, "ecdp": 1,
                "paged_attn": cfg.n_layers}
    get_config = serve_mod.get_config
    # the registry's arch at full width, its depth cut to MOE_LAYERS
    serve_mod.get_config = lambda arch, smoke=False: (
        cfg if arch == MOE_ARCH and not smoke else get_config(arch, smoke))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        eng = serve_mod.build_engine(MOE_ARCH, smoke=False, device="cuda",
                                     rber=1e-4, sample_cfg=SampleConfig())
    finally:
        serve_mod.get_config = get_config
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    log(f"  build_engine {MOE_ARCH} ({cfg.n_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}): {build_s:.1f} s, peak "
        f"{build_peak / 2**30:.2f} GiB while deploying, "
        f"{resident / 2**30:.2f} GiB resident")
    comp = moe_run(torch, eng, prompts)
    assert eng.step_traces == 1, eng.step_traces
    assert comp["launches"] == {k: 2 * n for k, n in per_step.items()}, \
        comp["launches"]
    prof = profile_steps(torch, eng, prompts, per_step,
                         require_records=False)
    assert eng.step_traces == 1, eng.step_traces
    step = time_moe_step(torch, timer, eng)
    assert step["calls"] == per_step["grouped_ecdp"], step["calls"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    eng = Engine(cfg, params, max_slots=4, max_seq=256, rber=1e-4,
                 sample_cfg=SampleConfig(), seed=0, device="cuda",
                 compiled=False)
    del params
    gc.collect()
    eager = moe_run(torch, eng, prompts)
    assert eng.step_traces == -1
    steps = eager["steps"]
    assert eager["launches"] == {k: steps * n for k, n in per_step.items()}, \
        (eager["launches"], steps)
    assert eager["out"] == comp["out"] and eager["stats"] == comp["stats"]
    assert len(comp["logits"]) == steps
    for i, (a, b) in enumerate(zip(comp["logits"], eager["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{cfg.name} step {i}: replayed logits "
                                 f"differ from the eager step's by "
                                 f"{float((a - b).abs().max())}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    generated = MOE_NEW * len(prompts)
    log(f"  compiled: {steps} steps, {comp['wall_s'] / steps * 1e3:.2f} "
        f"ms/step, {generated / comp['wall_s']:.1f} generated tokens/s, "
        f"peak {comp['peak_bytes'] / 2**30:.2f} GiB serving; eager "
        f"{eager['wall_s'] / steps * 1e3:.2f} ms/step; logits bit-equal at "
        f"every step; launches (eager) {eager['launches']} = {steps} x "
        f"{per_step}")
    return dict(steps=steps, ms_per_step=comp["wall_s"] / steps * 1e3,
                eager_ms_per_step=eager["wall_s"] / steps * 1e3,
                tokens_per_s=generated / comp["wall_s"], build_s=build_s,
                build_peak_bytes=build_peak, resident_bytes=resident,
                peak_bytes=comp["peak_bytes"], launches=eager["launches"],
                per_step=per_step, profile=prof, step=step,
                # phase 13(b)'s reference: the resident plane's every step
                reference=dict(out=eager["out"], logits=eager["logits"],
                               live=eager["live"], stats=eager["stats"]))


def moe_offline(torch) -> dict:
    """12(d): qwen3 width cut to MOE_CPU_LAYERS, offline: prefill of 4 x 64
    tokens, then 8 greedy decode steps through make_decode_step(compiled=
    True) and eagerly on the card (bit-equal, one capture; the counters
    gated), and on the CPU fed the CPU's tokens, taking the card's routes
    from its eager calls (RouteWitness; the capacity's drops follow from
    the routes): every row's logits within 2^-6 of the row's largest,
    greedy tokens equal wherever the top-2 margin exceeds twice that."""
    import numpy as np

    from repro_torch.core.tiering import FlashWeight, _walk, deploy
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe
    from repro_torch.serving.engine import _map_tree

    cfg = moe_cfg(MOE_CPU_LAYERS)
    b, s, n_dec = MOE_OFFLINE
    pad = s + n_dec
    t0 = time.perf_counter()
    raw = moe.init(cfg, torch.Generator(device="cuda").manual_seed(11),
                   device="cuda")
    p_gpu, _ = deploy(raw, rber=1e-4, seed=2)
    p_cpu, _ = deploy(_map_tree(lambda t: t.cpu(), raw), rber=1e-4, seed=2)
    del raw
    n_flash = 0
    for (_, g), (_, c) in zip(_walk(p_gpu), _walk(p_cpu)):
        if isinstance(g, FlashWeight):
            n_flash += 1
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    rng = np.random.default_rng(MOE_OFFLINE_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).int()
    wit, side, route = RouteWitness(torch, cfg.top_k), [None], moe._route

    def witness_route(xt, router, k):
        if side[0] is None:
            return route(xt, router, k)
        lg = xt.float() @ router.float()
        if side[0] == "card":
            gates, idx = route(xt, router, k)
            wit.record(lg, idx)
            return gates, idx
        return wit.hand_over(lg)

    def recorded(dev, fn, *args):
        side[0] = dev
        try:
            return fn(*args)
        finally:
            side[0] = None

    compared, max_rel = 0, 0.0

    def compare(lg_cpu, lg_gpu, what):
        nonlocal max_rel, compared
        lg_gpu = lg_gpu.cpu()
        row_max = lg_cpu.abs().amax(-1)
        rel = float(((lg_cpu - lg_gpu).abs().amax(-1) / row_max).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"{what}: logits differ by {rel:.3e} of the"
                                 " row's largest")
        max_rel = max(max_rel, rel)
        top2 = torch.topk(lg_cpu, 2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * PARITY_REL_TOL * row_max
        assert torch.equal(lg_cpu.argmax(-1)[sure], lg_gpu.argmax(-1)[sure]), \
            what
        compared += int(sure.sum())

    moe._route = witness_route
    try:
        prefill = make_prefill_step(cfg, pad_to=pad)
        moe_zero_counts()
        wit.step("prefill")
        lg_g, c_gpu = recorded("card", prefill, p_gpu,
                               {"tokens": toks.cuda()})
        counts = moe_counts()
        assert counts == {"grouped_ecdp": 3 * cfg.n_layers, "ecdp": 1,
                          "paged_attn": 0}, counts
        _, c_eager = prefill(p_gpu, {"tokens": toks.cuda()})
        lg_c, c_cpu = recorded("cpu", moe.prefill, cfg, p_cpu,
                               {"tokens": toks}, pad)
        compare(lg_c, lg_g, "prefill")
        comp, eager = make_decode_step(cfg, compiled=True), \
            make_decode_step(cfg)
        moe_zero_counts()
        for i in range(n_dec):
            what = f"decode step {i}"
            wit.step(what)
            tok = lg_c.argmax(-1).int()
            batch = {"token": tok.cuda(), "kv_len": s + i}
            lg_g, c_gpu = comp(p_gpu, c_gpu, batch)
            lg_e, c_eager = recorded("card", eager, p_gpu, c_eager, batch)
            if not torch.equal(lg_g, lg_e):
                raise AssertionError(f"decode step {i}: replayed logits "
                                     "differ from the eager step's by "
                                     f"{float((lg_g - lg_e).abs().max())}")
            lg_c, c_cpu = recorded("cpu", moe.decode_step, cfg, p_cpu,
                                   c_cpu, {"token": tok, "kv_len": s + i})
            compare(lg_c, lg_g, what)
        wit.step("end")
    finally:
        moe._route = route
    torch.cuda.synchronize()
    counts = moe_counts()
    from repro_torch.kernels import decode_attn
    counts["decode_attn"] = decode_attn.decode_attention_state.launches
    # the compiled step's warm-up and capture, and n_dec eager steps
    bodies = 2 + n_dec
    assert comp.captures == 1, comp.captures
    assert counts == {"grouped_ecdp": 3 * cfg.n_layers * bodies,
                      "ecdp": bodies, "paged_attn": 0,
                      "decode_attn": cfg.n_layers * bodies}, counts
    for k in ("k", "v"):
        assert torch.equal(c_gpu[k], c_eager[k]), k
    log(f"  {cfg.name} (cut: {cfg.n_layers} of 48 layers; widths as "
        f"qwen3-moe-30b-a3b), "
        f"prefill {b} x {s}, {n_dec} decode steps, "
        f"{time.perf_counter() - t0:.1f} s: {n_flash} flash weights "
        f"byte-identical; captured decode bit-equal to eager (1 capture); "
        f"card vs CPU max |logit diff| {max_rel:.3e} of the row's max (tol "
        f"{PARITY_REL_TOL:.3e}), {compared} greedy tokens compared; routes "
        f"handed from the card to the CPU: {wit.summary()}; launches "
        f"{counts}")
    assert compared > 0, "no greedy token compared"
    return dict(max_rel=max_rel, tokens_compared=compared,
                route_ties=wit.ties, routes_taken=len(wit.taken),
                router_rel=wit.max_rel, launches=counts)


def phase_moe(torch) -> dict:
    timer = Timer(torch)
    kernels = moe_kernels(torch, timer)
    gc.collect()
    torch.cuda.empty_cache()
    full = moe_full(torch, timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (c) card vs CPU at {MOE_ARCH} width, {MOE_CPU_LAYERS} layer")
    parity = phase_parity(torch, moe_cfg(MOE_CPU_LAYERS))
    log(f"  (d) offline prefill / decode at {MOE_ARCH} width, "
        f"{MOE_CPU_LAYERS} layer")
    offline = moe_offline(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(kernels=kernels, full=full, parity=parity, offline=offline)


# --- phase 13: the streamed MoE plane -------------------------------------------

MOE_STREAM_SPEC_LAYERS = 2
MOE_STREAM_SPEC_K = 4


def moe_stream_counts():
    from repro_torch.kernels import ecdp, grouped_ecdp, paged_attn, paged_ecdp
    return {"grouped_paged_ecdp":
                paged_ecdp.grouped_paged_ecdp_matmul.launches,
            "grouped_ecdp": grouped_ecdp.grouped_ecdp_matmul.launches,
            "ecdp": ecdp.ecdp_matmul.launches,
            "paged_attn": paged_attn.paged_attn.launches}


def moe_stream_zero_counts():
    from repro_torch.kernels import paged_ecdp
    moe_zero_counts()
    paged_ecdp.grouped_paged_ecdp_matmul.launches = 0


def moe_stream_kernels(torch, timer) -> dict:
    """13(a): the grouped paged ECDP at qwen3's bank shapes over a real
    route of 64 lanes x top-8 (``moe_route``'s), its experts' pages
    programmed by a PageStore and uploaded, as the engine does, into a
    pool on the card (only the routed experts; a shuffled free list), the
    slab the engine builds (routed experts in id order, padded to 128
    rows with its first row's tables): against its plain version within
    the ECDP bound (RBER 0 and 2e-3, ECC on and off), and bit for bit
    against the dense grouped ECDP over the full bank on the same bytes at
    the path's plan; timed per launch (ECC off, as served) beside its
    plain version, torch.bmm over the routed experts' dequantised bf16
    weights and the byte bound."""
    import numpy as np

    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import FlashWeight, encode_flash
    from repro_torch.kernels.ecdp import _n_sms
    from repro_torch.kernels.grouped_ecdp import (grouped_ecdp_matmul,
                                                  grouped_plan)
    from repro_torch.kernels.paged_ecdp import (grouped_paged_ecdp_matmul,
                                                grouped_paged_ecdp_plain)
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    from repro_torch.store import PageStore, WeightPagePool

    cfg = moe_cfg(1)
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(23)
    router = cm.dense_init(gen, d, e, torch.bfloat16, "cuda")
    x = torch.randn((1, MOE_ROUTE_TOKENS, d), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    _, idx = moe.serve_route(router, x, k)
    idx_host = idx.cpu().numpy()
    routed = np.unique(idx_host).tolist()
    # the engine's slab: e_slab = min(E, slots x chunk x k) rows
    e_slab = min(e, MOE_ROUTE_TOKENS * k)
    slab_map = torch.full((e,), -1, dtype=torch.int32, device="cuda")
    slab_map[torch.tensor(routed, device="cuda")] = torch.arange(
        len(routed), dtype=torch.int32, device="cuda")
    flat = idx.reshape(-1).long()
    flat_row = slab_map[flat].long()
    order, rs_slab = moe._grouped_rows(flat_row, flat_row >= 0, e_slab)
    order_full, rs_full = moe._grouped_rows(flat, flat >= 0, e)
    rows = MOE_ROUTE_TOKENS * k
    assert torch.equal(order, order_full)
    bounds_full, bounds_slab = rs_full.tolist(), rs_slab.tolist()
    for r, ex in enumerate(routed):
        assert bounds_slab[r:r + 2] == bounds_full[ex:ex + 2]
    counts = [bounds_full[x + 1] - bounds_full[x] for x in range(e)]
    log(f"  route of {MOE_ROUTE_TOKENS} lanes at k={k}: {rows} rows over "
        f"{len(routed)} of {e} experts, at most {max(counts)} an expert; "
        f"slab of {e_slab} rows")
    acts = {d: torch.randn((rows, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16),
            f: torch.randn((rows, f), generator=gen, device="cuda"
                           ).to(torch.bfloat16)}
    worst, per_launch, layer = 0.0, {}, {}
    for name, (kk, n) in (("w_gate/w_up", (d, f)), ("w_down", (f, d))):
        w = torch.randn((e, kk, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=kk + n + 1)
                 for r in (0.0, 2e-3)}
        del w
        a = acts[kk]
        slabs = {}
        for rber, fw in flash.items():
            store = PageStore(n_planes=8)
            for ex in range(e):
                store.put(f"e@{ex}", FlashWeight(fw.q[ex], fw.parity[ex],
                                                 fw.scale[ex]))
            names = [f"e@{ex}" for ex in routed]
            n_pages = sum(store.entry_pages(x) for x in names) + 16
            pool = WeightPagePool(store, n_pages, device="cuda")
            pool._free = [int(s) for s in
                          np.random.default_rng(kk + n).permutation(n_pages)]
            tbls = pool.upload(names)
            torch.cuda.current_stream().wait_event(tbls[names[0]]["ready"])
            tabs = [torch.stack([tbls[x]["dev"][i] for x in names]
                                + [tbls[names[0]]["dev"][i]]
                                * (e_slab - len(names)))
                    for i in range(3)]
            slabs[rber] = (pool, store, tabs)
            for ecc_on in (True, False):
                got = grouped_paged_ecdp_matmul(
                    a, rs_slab, pool.buffer, *tabs, (kk, n), ecc_on,
                    max_rows=MOE_ROUTE_TOKENS, plan_experts=e)
                dense = grouped_ecdp_matmul(a, rs_full, fw.q, fw.parity,
                                            fw.scale, ecc_on,
                                            max_rows=MOE_ROUTE_TOKENS)
                want = grouped_paged_ecdp_plain(a, rs_slab, pool.buffer,
                                                *tabs, (kk, n), ecc_on)
                torch.cuda.synchronize()
                if not torch.equal(got, dense):
                    raise AssertionError(
                        f"grouped paged ecdp {name} rber={rber} ecc="
                        f"{ecc_on}: differs from the dense grouped kernel "
                        f"on the same bytes by "
                        f"{float((got - dense).abs().max())}")
                for r, ex in enumerate(routed):
                    r0, r1 = bounds_slab[r], bounds_slab[r + 1]
                    mag = (a[r0:r1].float().abs()
                           @ fw.q[ex].float().abs()) * fw.scale[ex]
                    tol = 1e-4 + 4 * math.sqrt(kk) * EPS32 * mag
                    err = (got[r0:r1] - want[r0:r1]).abs()
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"grouped paged ecdp {name} rber={rber} ecc="
                            f"{ecc_on} expert {ex}: max err "
                            f"{float(err.max())}")
                    worst = max(worst, float(err.max()))
        pool, store, tabs = slabs[2e-3]           # the serving path: ECC off
        fw = flash[2e-3]
        t_kernel = timer(lambda: grouped_paged_ecdp_matmul(
            a, rs_slab, pool.buffer, *tabs, (kk, n), False,
            max_rows=MOE_ROUTE_TOKENS, plan_experts=e))
        t_dense = timer(lambda: grouped_ecdp_matmul(
            a, rs_full, fw.q, fw.parity, fw.scale, False,
            max_rows=MOE_ROUTE_TOKENS))
        t_plain = timer(lambda: grouped_paged_ecdp_plain(
            a, rs_slab, pool.buffer, *tabs, (kk, n), False), reps=3)
        # the library: one bmm over the routed experts' dequantised bf16
        # weights, each expert's rows padded to the 64 an expert can get
        sel = torch.tensor(routed, device="cuda")
        w_deq = dequantize_int8(fw.q[sel], fw.scale[sel])
        padded = torch.zeros((len(routed), MOE_ROUTE_TOKENS, kk),
                             dtype=torch.bfloat16, device="cuda")
        t_lib = timer(lambda: torch.bmm(padded, w_deq))
        del w_deq, padded
        plan = grouped_plan(rows, e, kk, n, MOE_ROUTE_TOKENS, _n_sms(0))
        # ECC off: the routed experts' q and scales (parity unread), the
        # rows in, the f32 rows out, the tables and row_start
        nbytes = (len(routed) * (kk * n + 4 * n) + 2 * rows * kk
                  + 4 * rows * n + 4 * (e_slab + 1)
                  + 4 * len(routed) * (tabs[0][0].numel()
                                       + tabs[1].shape[1] + tabs[2].shape[1]))
        b_ms, b_by = bound_ms(nbytes, 2.0 * rows * kk * n)
        b_ecc, _ = bound_ms(len(routed) * (kk * n * 9 / 8 + 4 * n), 0.0)
        per_launch[name] = dict(rows=rows, routed=len(routed), k=kk, n=n,
                                m_tile=plan.m_tile, k_splits=plan.splits,
                                ms=t_kernel, dense_grouped_ms=t_dense,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by,
                                bound_ms_ecc_on=b_ecc)
        log(f"  grouped paged ecdp {name:12s} R={rows} K={kk:4d} N={n:4d} "
            f"slab {e_slab} ({len(routed)} routed), M tile {plan.m_tile}, "
            f"{plan.splits} K splits: kernel {t_kernel:.4f} ms (dense "
            f"grouped {t_dense:.4f}), plain {t_plain:.4f} ms, torch.bmm "
            f"(routed, 64, K) bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {b_ecc:.4f} with parity)")
        del flash, slabs, pool, store, tabs
        gc.collect()
    # one layer's expert half: w_gate, w_up, w_down
    for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                "dense_grouped_ms"):
        layer[key] = 2 * per_launch["w_gate/w_up"][key] \
            + per_launch["w_down"][key]
    layer["bound_by"] = per_launch["w_down"]["bound_by"]
    log(f"  grouped paged ecdp vs plain: max abs err {worst:.3e} (8 cases); "
        f"bit-equal to the dense grouped kernel (8 cases); one layer's 3 "
        f"launches {layer['ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms, "
        f"torch.bmm {layer['library_ms']:.4f} ms")
    return dict(max_abs_err=worst, per_launch=per_launch, layer=layer,
                route=dict(rows=rows, routed=len(routed),
                           max_rows=max(counts), e_slab=e_slab))


def _moe_stream_step_run(torch, eng, prompts, new):
    """Serve ``prompts`` (``new`` new tokens each) with the counters zeroed
    just before: every step's host wall (synchronized), logits and live
    slots, its phase times, and the cache's bytes against its capacity."""
    rids = [eng.submit(p, max_new=new) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moe_stream_zero_counts()
    logits, live, wall, phases, over = [], [], [], {}, []
    t_all = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        logits.append(eng.last_logits.cpu())
        live.append(eng._host_in["q_lens"].numpy() > 0)
        for p, s in eng._phases.items():
            phases[p] = phases.get(p, 0.0) + s
        c = eng.expert_cache
        if c.capacity is not None and c.bytes_used > c.capacity:
            over.append((len(wall), c.bytes_used, c.capacity))
    total = time.perf_counter() - t_all
    return dict(out=[list(eng.requests[r].out) for r in rids],
                logits=logits, live=live, wall=wall, total_s=total,
                phases=phases, over=over, launches=moe_stream_counts(),
                peak_bytes=torch.cuda.max_memory_allocated(),
                stats=list(eng.stats))


def _same_live_logits(torch, what, got, want):
    """Every step's logits of the slots that ran lanes, bit for bit (a slot
    with no lanes samples a padding lane, whose experts the streamed plane
    leaves unmapped); the same number of steps."""
    if len(got["logits"]) != len(want["logits"]):
        raise AssertionError(f"{what}: {len(got['logits'])} steps against "
                             f"{len(want['logits'])}")
    for i, (a, b, la, lb) in enumerate(zip(got["logits"], want["logits"],
                                           got["live"], want["live"])):
        if not (la == lb).all():
            raise AssertionError(f"{what} step {i}: slots with lanes "
                                 f"{la.tolist()} against {lb.tolist()}")
        if not torch.equal(a[la], b[lb]):
            raise AssertionError(
                f"{what} step {i}: logits differ from the resident "
                f"engine's by {float((a[la] - b[lb]).abs().max())}")


def moe_stream_full(torch, reference) -> dict:
    """13(b): qwen3-moe-30b-a3b at full width, MOE_LAYERS of 48 layers,
    streamed through build_engine(stream=True) (RBER 1e-4, greedy, the seed and
    cut of 12(b)) under half the store's flash tier: every step's logits and
    the tokens bit-equal to 12(b)'s resident engine (``reference``), the cache
    within its capacity at every step, fewer expert bytes per token than
    streaming all experts, 3 x MOE_LAYERS grouped paged ECDP launches a step
    (no dense grouped launch). The streamed engine contracts its token budget
    by its misroute-stall fraction and the resident engine does not, so its
    stall signal is read as 0 here: both plan the same steps (the stalls stay
    counted in expert_stats)."""
    import numpy as np

    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving.sampler import SampleConfig

    cfg = moe_cfg(MOE_LAYERS)
    rng = np.random.default_rng(14)                    # 12(b)'s prompts
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in MOE_PROMPTS]
    d, f = cfg.d_model, cfg.d_ff
    expert = 2 * _payload(d, f) + _payload(f, d)
    tier = cfg.n_layers * cfg.n_experts * expert + _payload(d,
                                                            cfg.vocab_size)
    budget_mib = tier / 2 / 2**20
    get_config = serve_mod.get_config
    serve_mod.get_config = lambda arch, smoke=False: (
        cfg if arch == MOE_ARCH and not smoke else get_config(arch, smoke))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        eng = serve_mod.build_engine(MOE_ARCH, smoke=False, device="cuda",
                                     rber=1e-4, stream=True,
                                     device_budget_mib=budget_mib,
                                     sample_cfg=SampleConfig())
    finally:
        serve_mod.get_config = get_config
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    store, cache = eng.store, eng.expert_cache
    assert eng.streamed_moe and store.total_bytes == tier, \
        (store.total_bytes, tier)
    assert eng.stream_cfg.device_budget_bytes < tier
    log(f"  build_engine(stream=True) {cfg.name}: {build_s:.1f} s; store "
        f"{store.total_bytes / 2**30:.2f} GiB ({cfg.n_layers} x "
        f"{cfg.n_experts} experts of {expert / 2**20:.2f} MiB + lm_head), "
        f"budget {eng.stream_cfg.device_budget_bytes / 2**30:.2f} GiB: "
        f"cache {cache.capacity / 2**30:.2f} GiB, slab {eng._e_slab} rows, "
        f"pool {eng.wpool.n_pages} pages "
        f"({eng.wpool.n_pages * store.page_bytes / 2**30:.2f} GiB); device "
        f"peak {build_peak / 2**30:.2f} GiB while deploying, "
        f"{resident / 2**30:.2f} GiB resident")
    eng._stream_stall_s = lambda: 0.0          # the resident engine's plan
    run = _moe_stream_step_run(torch, eng, prompts, MOE_NEW)
    steps = len(run["logits"])
    per_step = {"grouped_paged_ecdp": 3 * cfg.n_layers, "grouped_ecdp": 0,
                "ecdp": 1, "paged_attn": cfg.n_layers}
    assert run["launches"] == {k: steps * n for k, n in per_step.items()}, \
        (run["launches"], steps)
    assert not run["over"], run["over"]
    assert run["out"] == reference["out"], (run["out"], reference["out"])
    assert [{k: v for k, v in e.items() if k != "stall_frac"}
            for e in run["stats"]] == reference["stats"]
    _same_live_logits(torch, cfg.name, run, reference)
    st = eng.expert_stats()
    assert st["expert_bytes_per_token"] < st["all_experts_bytes_per_token"]
    assert st["pool_grows"] == 0 and st["prefetch_failures"] == 0, st
    prefill = [w for w, s in zip(run["wall"], run["stats"])
               if s["prefill_tokens"]]
    decode = [w for w, s in zip(run["wall"], run["stats"])
              if not s["prefill_tokens"]]
    ms = lambda ws: sum(ws) / max(len(ws), 1) * 1e3     # noqa: E731
    ph = run["phases"]
    dispatch = sum(ph.get(p, 0.0) for p in ("head_dispatch",
                                            "fused_dispatch",
                                            "tail_dispatch"))
    split = {p: ph.get(p, 0.0) / steps * 1e3
             for p in ("plan", "head_dispatch", "route_sync",
                       "expert_acquire", "fused_dispatch", "tail_dispatch",
                       "sync")}
    generated = MOE_NEW * len(prompts)
    log(f"  streamed: {steps} steps ({len(prefill)} with prefill), "
        f"{ms(run['wall']):.1f} ms/step: prefill steps {ms(prefill):.1f}, "
        f"decode steps {ms(decode):.1f} ms; "
        f"{generated / run['total_s']:.2f} generated tokens/s; "
        f"per step route_sync {split['route_sync']:.1f} ms, expert_acquire "
        f"{split['expert_acquire']:.1f} ms, dispatch "
        f"{dispatch / steps * 1e3:.1f} ms (head {split['head_dispatch']:.1f},"
        f" fused {split['fused_dispatch']:.1f}, tail "
        f"{split['tail_dispatch']:.1f}), sync {split['sync']:.1f} ms")
    log(f"  experts: hit rate {st['expert_hit_rate']:.3f} ({st['expert_hits']}"
        f" hits, {st['expert_misses']} misses), misroute stalls "
        f"{st['misroute_stalls']} = {st['misroute_stall_s']:.2f} s, fetched "
        f"{st['expert_bytes_fetched'] / 2**30:.2f} GiB ({st['expert_fetches']}"
        f" fetches; prefetched {st['expert_prefetched_bytes'] / 2**30:.2f} "
        f"GiB in {st['expert_prefetches']}, {st['prefetch_batches']} "
        f"rounds); {st['expert_bytes_per_token'] / 2**20:.1f} MiB/token vs "
        f"{st['all_experts_bytes_per_token'] / 2**20:.1f} MiB/token "
        f"all experts; cache {st['expert_cache_entries']} entries "
        f"{st['expert_cache_bytes'] / 2**30:.2f} GiB of "
        f"{cache.capacity / 2**30:.2f}; largest routed set "
        f"{st['max_routed_seen']}; H2D {st['pool_bytes_staged'] / 2**30:.2f}"
        f" GiB in {st['pool_h2d_s']:.2f} s")
    log(f"  peak device memory serving {run['peak_bytes'] / 2**30:.2f} GiB, "
        f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB; logits "
        f"of the slots with lanes and the tokens bit-equal to 12(b)'s "
        f"resident engine at all {steps} steps; launches {run['launches']}")
    eng.close()
    del eng, store, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, prefill_steps=len(prefill),
                ms_per_step=ms(run["wall"]),
                ms_per_prefill_step=ms(prefill),
                ms_per_decode_step=ms(decode),
                tokens_per_s=generated / run["total_s"],
                phase_ms_per_step=split,
                dispatch_ms_per_step=dispatch / steps * 1e3,
                build_s=build_s, build_peak_bytes=build_peak,
                resident_bytes=resident, peak_bytes=run["peak_bytes"],
                launches=run["launches"], per_step=per_step,
                tier_bytes=tier, experts={
                    k: st[k] for k in (
                        "expert_hit_rate", "expert_hits", "expert_misses",
                        "misroute_stalls", "misroute_stall_s",
                        "expert_bytes_fetched", "expert_prefetched_bytes",
                        "expert_prefetches", "expert_bytes_per_token",
                        "all_experts_bytes_per_token", "max_routed_seen",
                        "pool_h2d_s", "pool_bytes_staged")})


def moe_stream_spec(torch) -> dict:
    """13(c): speculative serving on the streamed MoE plane, qwen3 width at
    2 layers, n-gram k = 4, under a budget below the tier, against the
    resident spec engine on the same weights: the tokens, and every step's
    logits of the slots with lanes and its verify-lane logits within the
    lanes the routed-expert filter maps (q_lens + draft_cap), bit for bit;
    token budget 1024 on both, so the stall never contracts the plan."""
    import numpy as np

    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig
    from repro_torch.serving.spec import SpecConfig
    from repro_torch.store import PageStore, StreamConfig

    cfg = moe_cfg(MOE_STREAM_SPEC_LAYERS)
    d, f = cfg.d_model, cfg.d_ff
    expert = 2 * _payload(d, f) + _payload(f, d)
    # lm_head, the 128-row slab and a quarter of the expert tier: at 2
    # layers half the tier would not hold lm_head and the slab
    budget = (_payload(d, cfg.vocab_size) + cfg.n_experts * expert
              + cfg.n_layers * cfg.n_experts * expert // 4)
    kw = dict(max_slots=4, max_seq=256, rber=1e-4, seed=0, kv_aware=False,
              sample_cfg=SampleConfig(), device="cuda",
              spec_cfg=SpecConfig(k=MOE_STREAM_SPEC_K),
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024))
    rng = np.random.default_rng(15)
    # repeating prompts, so the n-gram drafter has something to propose
    prompts = [(rng.integers(1, cfg.vocab_size, 6).tolist() * 5)[:n]
               for n in (12, 30, 18, 24)]
    runs = {}
    for streamed in (False, True):
        params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(3),
                          device="cuda")
        extra = {}
        if streamed:
            extra = dict(weight_store=PageStore(n_planes=8),
                         stream_cfg=StreamConfig(
                             device_budget_bytes=budget))
        eng = Engine(cfg, params, **kw, **extra)
        del params
        with eng._cv:
            rids = [eng.submit(p, max_new=16) for p in prompts]
        moe_stream_zero_counts()
        rows = []
        while eng.step():
            bound = (eng._host_in["q_lens"].numpy()
                     + eng._host_in["draft_cap"].numpy())
            rows.append((eng.last_logits.cpu(), eng.last_lane_logits.cpu(),
                         eng._host_in["q_lens"].numpy() > 0, bound))
        torch.cuda.synchronize()
        runs[streamed] = dict(out=[list(eng.requests[r].out) for r in rids],
                              rows=rows, launches=moe_stream_counts(),
                              spec=eng.spec_stats(),
                              traces=eng.step_traces)
        if streamed:
            runs[streamed]["experts"] = eng.expert_stats()
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    res, stm = runs[False], runs[True]
    steps = len(stm["rows"])
    assert stm["out"] == res["out"], (stm["out"], res["out"])
    assert len(res["rows"]) == steps
    for i, ((a, la, live, bound), (b, lb, live_r, _)) in enumerate(
            zip(stm["rows"], res["rows"])):
        assert (live == live_r).all(), i
        if not torch.equal(a[live], b[live]):
            raise AssertionError(f"13(c) step {i}: logits differ by "
                                 f"{float((a[live] - b[live]).abs().max())}")
        for s, n in enumerate(bound):
            n = min(int(n), la.shape[1])
            if not torch.equal(la[s, :n], lb[s, :n]):
                raise AssertionError(f"13(c) step {i} slot {s}: verify-lane "
                                     "logits differ")
    assert stm["launches"]["grouped_paged_ecdp"] == 3 * cfg.n_layers * steps
    assert stm["launches"]["grouped_ecdp"] == 0
    assert stm["spec"] == res["spec"] and stm["traces"] == -1
    assert stm["spec"]["spec_accepted"] > 0, stm["spec"]
    log(f"  (c) streamed spec {cfg.name}, n-gram k={MOE_STREAM_SPEC_K}: "
        f"{steps} steps, {stm['spec']['spec_tokens_per_step']:.3f} tokens "
        f"per verify step, acceptance {stm['spec']['spec_acceptance_rate']:.3f}"
        f"; tokens, logits and verify-lane logits bit-equal to the resident "
        f"spec engine's (compiled) at all {steps} steps; expert hit rate "
        f"{stm['experts']['expert_hit_rate']:.3f}; launches "
        f"{stm['launches']}")
    return dict(steps=steps, spec=stm["spec"], launches=stm["launches"])


def phase_moe_stream(torch, reference) -> dict:
    timer = Timer(torch)
    kernels = moe_stream_kernels(torch, timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    full = moe_stream_full(torch, reference)
    spec = moe_stream_spec(torch)
    return dict(kernels=kernels, full=full, spec=spec)


# --- phase 14: the other model families on the offline path ------------------

FAMILY_ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "seamless-m4t-medium")
# each family's distinct flash (K, N) at full width (core/tiering's
# patterns): RWKV-6's time-mix projections and w_rgate, its channel mix and
# lm_head; RecurrentGemma's RG-LRU in/out projections, SwiGLU and lm_head;
# seamless's GELU FFN and lm_head (N 256206, not a multiple of 16: the
# narrow loads)
FAMILY_ECDP = {
    "rwkv6-3b": {"tmix/w_rkvgo, w_rgate": (2560, 2560),
                 "w_up": (2560, 8960), "w_down": (8960, 2560),
                 "lm_head": (2560, 65536)},
    "recurrentgemma-9b": {"mix/w_in_xy, w_out": (4096, 4096),
                          "w_gate/w_up": (4096, 12288),
                          "w_down": (12288, 4096),
                          "lm_head": (4096, 256000)},
    "seamless-m4t-medium": {"w_up": (1024, 4096), "w_down": (4096, 1024),
                            "lm_head": (1024, 256206)},
}
# 14(b): 4 prompts of 128 tokens (seamless: 128 source frames and a
# 16-token target prompt, its self-KV padded to 96 rows), 32 greedy decode
# steps, then 4 more timed and 4 traced on the captured step
FAMILY_B, FAMILY_PROMPT, FAMILY_STEPS, FAMILY_TRACE = 4, 128, 32, 4
FAMILY_TGT, FAMILY_PAD, FAMILY_SEED = 16, 96, 24
FAMILY_WORK = ROOT / "build" / "chip_smoke_phase14"
# decode attention at the path's shapes, (B, S_max, KV, rep, Dh, lengths
# checked, lengths timed): recurrentgemma's ring (MQA, Dh 256: the
# CUDA-core body) at lengths on its edges, timed at 14(b)'s mid-run live
# count and at a full ring; seamless's self-KV (timed mid-run) and its
# cross-KV, always at its full length
FAMILY_DECODE = {
    "recurrentgemma ring": (4, 2048, 1, 16, 256, [1, 700, 2047, 2048],
                            [FAMILY_PROMPT + FAMILY_STEPS // 2 + 1] * 4),
    "recurrentgemma full ring": (4, 2048, 1, 16, 256, None, [2048] * 4),
    "seamless self": (4, FAMILY_PAD, 16, 1, 64, [1, 33, 64, 96],
                      [FAMILY_TGT + FAMILY_STEPS // 2] * 4),
    "seamless cross": (4, FAMILY_PROMPT, 16, 1, 64, [FAMILY_PROMPT] * 4,
                       [FAMILY_PROMPT] * 4),
}
# 14(b)'s depth, for the script's time (8 and 8 until phase 18 came;
# recurrentgemma's 4 are one (r, r, a) super-block and a recurrent layer);
# seamless-m4t-medium runs at its full 12 + 12
FAMILY_DEPTH = {"rwkv6-3b": 4, "recurrentgemma-9b": 4}
# 14(c): full width at cut depth, card against CPU; recurrentgemma's prompt
# is longer than its window, so the card's captured decode wraps the ring;
# its 3 layers are one (r, r, a) super-block; rwkv6-3b and seamless run 1
# layer, for the script's time (recurrentgemma's CPU prefill takes 40-55 s)
FAMILY_CUT = {"rwkv6-3b": dict(n_layers=1),
              "recurrentgemma-9b": dict(n_layers=3),
              "seamless-m4t-medium": dict(n_layers=1, n_enc_layers=1)}
FAMILY_PARITY_IN = {"rwkv6-3b": (2, 64, 8), "recurrentgemma-9b": (1, 2056, 4),
                    "seamless-m4t-medium": (2, 64, 8)}   # B, prompt, steps


def family_cfg(arch: str, cut: bool = False):
    """The registry's config of ``arch`` at full width, its depth cut to
    FAMILY_DEPTH's (14(b)), or to FAMILY_CUT's with ``cut`` (14(c))."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cut:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-cut",
                                  **FAMILY_CUT[arch])
    elif arch in FAMILY_DEPTH:
        n = FAMILY_DEPTH[arch]
        cfg = dataclasses.replace(cfg, n_layers=n, name=f"{cfg.name}-{n}l")
    return cfg


def family_per_step(cfg) -> dict:
    """A decode step's ECDP and decode-attention launches: RWKV-6 8 flash
    projections a layer; RG-LRU 6 a recurrent layer (w_in_x, w_in_y, w_out
    and the SwiGLU) and 3 an attention layer (its SwiGLU) and one ring
    attention; seamless 2 a decoder layer (its FFN; the cross projections
    are DRAM-tier) and two attentions (self, cross); and lm_head."""
    if cfg.family == "rwkv6":
        return {"ecdp": cfg.n_layers * 8 + 1, "decode_attn": 0}
    if cfg.family == "rglru":
        n_super, n_tail = cfg.n_layers // 3, cfg.n_layers % 3
        return {"ecdp": (2 * n_super + n_tail) * 6 + n_super * 3 + 1,
                "decode_attn": n_super}
    return {"ecdp": cfg.n_layers * 2 + 1, "decode_attn": 2 * cfg.n_layers}


def expect_counts(got, want, what: str) -> None:
    """A launch count or a capture count against the path's."""
    if got != want:
        raise AssertionError(f"{what}: {got}, want {want}")


def tree_to(tree, device):
    """A deployed param tree (FlashWeight leaves too) on ``device``."""
    from repro_torch.core.tiering import FlashWeight
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, FlashWeight):
        return FlashWeight(tree.q.to(device), tree.parity.to(device),
                           tree.scale.to(device))
    return tree.to(device)


def family_inputs(torch, cfg, gen, b: int, s: int, device="cuda"):
    """(batch, kv_len after the prompt, pad_to): ``s`` prompt tokens, or
    for the encoder-decoder ``s`` source frames (bf16, normal) and a
    FAMILY_TGT-token target prompt, its self-KV padded to FAMILY_PAD."""
    n_tok = FAMILY_TGT if cfg.family == "encdec" else s
    toks = torch.randint(0, cfg.vocab_size, (b, n_tok), generator=gen,
                         device=gen.device).to(device)
    if cfg.family != "encdec":
        return {"tokens": toks}, s, None
    src = torch.randn((b, s, cfg.d_model), generator=gen, device=gen.device)
    return ({"src_embeds": src.to(device=device, dtype=torch.bfloat16),
             "tgt_tokens": toks}, FAMILY_TGT, FAMILY_PAD)


def family_ecdp(torch, timer, arch: str) -> dict:
    """14(a): the ECDP against its plain version at ``arch``'s flash
    shapes, M 4 (a decode step) and 512 (the prefill), RBER 0 and 2e-3,
    ECC on and off; each timed at both M beside its plain version,
    torch.matmul on the dequantised bf16 weights and its byte bound."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst, per_launch = 0.0, {}
    for name, (k, n) in FAMILY_ECDP[arch].items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=k + n) for r in (0.0, 2e-3)}
        del w
        w_deq = dequantize_int8(flash[0.0].q, flash[0.0].scale)
        for m in (4, PREFILL_M):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            for rber, fw in flash.items():
                for ecc_on in (True, False):
                    worst = max(worst, ecdp_case(
                        torch, a, fw, ecc_on,
                        f"{arch} {name} M={m} rber={rber}")[0])
            fw = flash[2e-3]
            t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity,
                                                 fw.scale, True))
            t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity,
                                                      fw.scale, True), reps=3)
            t_lib = timer(lambda: torch.matmul(a, w_deq))
            b_ms, b_by = bound_ms(k * n * 9 / 8 + 4 * n + 2 * m * k
                                  + 4 * m * n, 2.0 * m * k * n)
            per_launch[f"{name}@M{m}"] = dict(
                m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                wide=n % 16 == 0)
            log(f"  ecdp {arch} {name:22s} M={m:3d} K={k:5d} N={n:6d}: "
                f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
                f"torch.matmul bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
        del flash, w_deq
        torch.cuda.empty_cache()
    log(f"  ecdp at {arch}'s shapes vs plain: max abs err {worst:.3e} "
        f"({len(FAMILY_ECDP[arch]) * 8} cases)")
    return dict(max_abs_err=worst, per_launch=per_launch)


def time_decode_case(torch, timer, shape, lengths) -> dict:
    """Decode attention at ``shape`` (B, S_max, KV, rep, Dh) with
    ``lengths``, bf16: the kernel, its plain version and SDPA on the same
    cache under the length mask (the query group as SDPA's query rows),
    all on the same grouped queries; and the bound: the live K/V rows, q
    and the state at 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (decode_attn,
                                                 decode_attn_plain,
                                                 group_decode_queries)

    b, s_max, n_kv, rep, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                               torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = group_decode_queries(q, n_kv, kc.dtype)
    t_kernel = timer(lambda: decode_attn(qs, kc, vc, lens))
    t_plain = timer(lambda: decode_attn_plain(qs, kc, vc, lens), reps=3)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, scale=1.0))
    live = sum(min(x, s_max) for x in lengths)
    nbytes = (live * n_kv * dh * 2 * 2 + qs.numel() * 2
              + b * n_kv * rep * (dh + 2) * 4 + b * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * rep * dh * n_kv * live)
    return dict(lengths=list(lengths), ms=t_kernel, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)


def family_decode_attn(torch, timer) -> dict:
    """14(a): the decode-attention kernel against its plain versions (the
    bounds at kernel_errors in kernels/decode_attn.py) at recurrentgemma's
    ring and seamless's self- and cross-KV shapes, bf16, and timed beside
    SDPA and its bound; the shared memory of the ring's CUDA-core block."""
    from repro_torch.kernels.decode_attn import (_MAX_SMEM,
                                                 decode_attention_state,
                                                 group_decode_queries,
                                                 kernel_errors, smem_bytes,
                                                 uses_mma)

    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for name, (b, s_max, n_kv, rep, dh, lengths, timed) in \
            FAMILY_DECODE.items():
        row = dict(b=b, s_max=s_max, kv=n_kv, rep=rep, dh=dh)
        if lengths is not None:
            q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                                       torch.bfloat16)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            qg = group_decode_queries(q, n_kv, kc.dtype)
            mma = uses_mma(qg, kc, vc)
            smem = smem_bytes(rep, dh, n_kv=n_kv, mma=mma)
            if smem > _MAX_SMEM:
                raise AssertionError(f"decode attention {name}: {smem} B")
            acc, m, l = decode_attention_state(q, kc, vc, lens)
            torch.cuda.synchronize()
            errs = kernel_errors(qg, kc, vc, lens, acc, m, l)
            max_abs = errs.pop("max_abs_err")
            if not all(v <= 1 for v in errs.values()):
                raise AssertionError(f"decode attention {name}: error / "
                                     f"bound {errs}")
            row.update(checked_lengths=lengths, max_abs_err=max_abs,
                       body="tensor-core" if mma else "CUDA-core",
                       smem_bytes=smem)
            log(f"  decode_attn {name} B={b} S_max={s_max} KV={n_kv} "
                f"rep={rep} Dh={dh} ({row['body']} body, {smem} B shared "
                f"memory a block) lengths {lengths}: error / bound "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; max abs err {max_abs:.3e}")
        row.update(time_decode_case(torch, timer, (b, s_max, n_kv, rep, dh),
                                    timed))
        log(f"  decode_attn {name} lengths {timed}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        out[name] = row
    return out


def family_full(torch, arch: str) -> dict:
    """14(b): ``arch`` at full width, depth cut to FAMILY_DEPTH's: deployed by
    run_deploy at RBER 1e-4 from a seeded init on the card (the checkpoint
    written under FAMILY_WORK and restored onto the card, then removed), 4
    prompts x 128 tokens prefilled, 32 greedy decode steps through
    make_decode_step(compiled=True) (one capture), then the same eagerly:
    tokens and logits bit-equal; launch counters zeroed just before each run
    and read just after; then 4 captured steps timed and 4 traced (the device
    time and idle share; a kernel record the profiler loses is printed, not
    gated: the eager run's counters and the bit-equal logits hold the
    launches)."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import deploy
    from repro_torch.kernels import decode_attn, ecdp
    from repro_torch.launch import deploy as deploy_mod
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import family_module

    cfg = family_cfg(arch)
    mod = family_module(cfg.family)
    per_step = family_per_step(cfg)
    n_prefill = (per_step["ecdp"] if cfg.family != "encdec"
                 else (cfg.n_enc_layers + cfg.n_layers) * 2 + 1)
    work = FAMILY_WORK / arch
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full_config = deploy_mod.get_config
    # the registry's arch at full width, its depth cut to FAMILY_DEPTH's
    deploy_mod.get_config = lambda a, smoke=False: (
        cfg if a == arch and not smoke else full_config(a, smoke))
    try:
        stats = deploy_mod.run_deploy(arch, False, None, str(work), rber=1e-4,
                                      seed=FAMILY_SEED, device="cuda")
    finally:
        deploy_mod.get_config = full_config
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    deploy_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    # a checkpoint's template is its tree, not its shapes: the smoke
    # config's deployed tree has the full config's
    template, _ = deploy(mod.init(get_config(arch, smoke=True),
                                  torch.Generator().manual_seed(0),
                                  device="cpu"))
    t0 = time.perf_counter()
    params, extras = CheckpointManager(work).restore(template, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert extras["arch"] == arch and extras["rber"] == 1e-4, extras
    shutil.rmtree(work)
    del template
    resident = torch.cuda.memory_allocated()
    n_params = cfg.param_count()
    log(f"  {arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
        + f", d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.2f} B params): run_deploy "
        f"{deploy_s:.1f} s (flash tier {stats['flash_gib']:.2f} GiB, DRAM "
        f"tier {stats['dram_gib']:.2f} GiB), peak {deploy_peak / 2**30:.2f} "
        f"GiB while deploying; checkpoint restored onto the card in "
        f"{restore_s:.1f} s, {resident / 2**30:.2f} GiB resident")
    gen = torch.Generator(device="cuda").manual_seed(FAMILY_SEED)
    batch, start, pad_to = family_inputs(torch, cfg, gen, FAMILY_B,
                                         FAMILY_PROMPT)
    prefill = make_prefill_step(cfg, pad_to=pad_to)
    traced = {k: n for k, n in per_step.items() if n}
    runs = {}
    for compiled in (True, False):
        what = "compiled" if compiled else "eager"
        decode = make_decode_step(cfg, compiled=compiled)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ecdp.ecdp_matmul.launches = 0
        decode_attn.decode_attention_state.launches = 0
        t0 = time.perf_counter()
        last, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        expect_counts((ecdp.ecdp_matmul.launches,
                       decode_attn.decode_attention_state.launches),
                      (n_prefill, 0), f"{arch} prefill launches")
        ecdp.ecdp_matmul.launches = 0
        out, logits = [last.argmax(-1)], []
        t0 = time.perf_counter()
        for i in range(FAMILY_STEPS):
            last, cache = decode(params, cache, {"token": out[-1],
                                                 "kv_len": start + i})
            out.append(last.argmax(-1))
            logits.append(last)
            if i == 0:
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        rest = time.perf_counter() - t1
        launches = {"ecdp": ecdp.ecdp_matmul.launches,
                    "decode_attn": decode_attn.decode_attention_state.launches}
        bodies = 2 if compiled else FAMILY_STEPS      # warm-up + capture
        expect_counts(launches, {k: n * bodies for k, n in per_step.items()},
                      f"{arch} {what} decode launches")
        if compiled:
            expect_counts(decode.captures, 1, f"{arch} captures")
        gen_toks = torch.stack(out, 1).cpu()
        assert bool(torch.isfinite(torch.stack(logits)).all())
        assert bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all())
        peak = torch.cuda.max_memory_allocated()
        ms_step = rest / (FAMILY_STEPS - 1) * 1e3
        prof = None
        if compiled:
            kv = [start + FAMILY_STEPS]

            def step():
                nonlocal last, cache
                last, cache = decode(params, cache, {
                    "token": last.argmax(-1), "kv_len": kv[0]})
                kv[0] += 1
            prof = trace_steps(torch, step, FAMILY_TRACE, traced,
                               captured=decode.captured,
                               require_records=False)
            expect_counts(decode.captures, 1, f"{arch} captures")
        log(f"  {arch} {what}: prefill {FAMILY_B} x {FAMILY_PROMPT} "
            + ("frames, " + f"{FAMILY_TGT}-token targets"
               if cfg.family == "encdec" else "tokens")
            + f" {t_prefill * 1e3:.1f} ms; {FAMILY_STEPS} greedy decode "
            f"steps: the first {first_ms:.1f} ms, then {ms_step:.2f} "
            f"ms/step, {FAMILY_B / ms_step * 1e3:.1f} generated tokens/s; "
            + (f"device {prof['device_ms_per_step']:.2f} ms/step, idle "
               f"share {prof['idle_share']:.3f}; " if prof else "")
            + f"peak {peak / 2**30:.2f} GiB; launches {launches}")
        runs[compiled] = dict(tokens=gen_toks,
                              logits=torch.stack(logits).cpu(),
                              launches=launches, prefill_ms=t_prefill * 1e3,
                              first_ms=first_ms, ms_per_step=ms_step,
                              tokens_per_s=FAMILY_B / ms_step * 1e3,
                              peak_bytes=peak, profile=prof)
        del cache, last, logits, out, decode
        gc.collect()
        torch.cuda.empty_cache()
    comp, eager = runs[True], runs[False]
    assert torch.equal(comp["tokens"], eager["tokens"]), arch
    for i, (a, b) in enumerate(zip(comp["logits"], eager["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{arch} decode step {i}: replayed logits "
                                 "differ from the eager step's by "
                                 f"{float((a - b).abs().max())}")
    log(f"  {arch}: compiled vs eager, {FAMILY_STEPS} decode steps, logits "
        f"and greedy tokens bit-equal, 1 capture; first prompt's tokens "
        f"{eager['tokens'][0, :12].tolist()}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        per_step=per_step, prefill_launches=n_prefill,
        launches=eager["launches"], params=n_params,
        deploy_s=deploy_s, restore_s=restore_s, deploy_peak_bytes=deploy_peak,
        resident_bytes=resident, flash_gib=stats["flash_gib"],
        dram_gib=stats["dram_gib"],
        profile={k: comp["profile"][k] for k in (
            "ms_per_step", "device_ms_per_step", "idle_share", "groups_ms",
            "records")},
        **{w: {k: r[k] for k in ("prefill_ms", "first_ms", "ms_per_step",
                                 "tokens_per_s", "peak_bytes")}
           for w, r in (("compiled", comp), ("eager", eager))})


def family_parity(torch, arch: str) -> dict:
    """14(c): ``arch`` at full width, depth cut to FAMILY_CUT's, seeded and
    deployed at RBER 1e-4 on the card; the CPU runs the port's plain path
    on the card's params (copied). Prefill and FAMILY_PARITY_IN's decode
    steps (both fed the CPU's greedy tokens; the card's through
    make_decode_step(compiled=True), one capture): logits within 2^-6 of
    each row's largest |logit|, greedy tokens equal wherever the top-2
    margin exceeds twice that (phase 5's rule)."""
    from repro_torch.core.tiering import deploy
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import family_module

    cfg = family_cfg(arch, cut=True)
    mod = family_module(cfg.family)
    b, s, n_dec = FAMILY_PARITY_IN[arch]
    t0 = time.perf_counter()
    raw = mod.init(cfg, torch.Generator(device="cuda").manual_seed(17),
                   device="cuda")
    p_gpu, _ = deploy(raw, rber=1e-4, seed=3)
    del raw
    p_cpu = tree_to(p_gpu, "cpu")
    batch, start, pad_to = family_inputs(
        torch, cfg, torch.Generator().manual_seed(18), b, s, device="cpu")
    max_rel, compared = 0.0, 0

    def compare(lg_cpu, lg_gpu, what):
        nonlocal max_rel, compared
        lg_gpu = lg_gpu.cpu()
        row_max = lg_cpu.abs().amax(-1)
        rel = float(((lg_cpu - lg_gpu).abs().amax(-1) / row_max).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"{arch} {what}: logits differ by "
                                 f"{rel:.3e} of the row's largest")
        max_rel = max(max_rel, rel)
        top2 = torch.topk(lg_cpu, 2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * PARITY_REL_TOL * row_max
        assert torch.equal(lg_cpu.argmax(-1)[sure], lg_gpu.argmax(-1)[sure]), \
            (arch, what)
        compared += int(sure.sum())

    lg_c, c_cpu = mod.prefill(cfg, p_cpu, batch, pad_to=pad_to)
    lg_g, c_gpu = make_prefill_step(cfg, pad_to=pad_to)(
        p_gpu, {k: v.cuda() for k, v in batch.items()})
    compare(lg_c, lg_g, "prefill")
    decode = make_decode_step(cfg, compiled=True)
    for i in range(n_dec):
        tok = lg_c.argmax(-1).int()
        lg_c, c_cpu = mod.decode_step(cfg, p_cpu, c_cpu,
                                      {"token": tok, "kv_len": start + i})
        lg_g, c_gpu = decode(p_gpu, c_gpu, {"token": tok.cuda(),
                                            "kv_len": start + i})
        compare(lg_c, lg_g, f"decode step {i}")
    expect_counts(decode.captures, 1, f"{arch} parity captures")
    wrap = ""
    if cfg.family == "rglru":
        w = cfg.local_window
        assert start > w, (start, w)
        wrap = (f"; ring slots {start % w}..{(start + n_dec - 1) % w} of "
                f"{w} (positions {start}..{start + n_dec - 1})")
    log(f"  {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
        + f" at full width), {b} x {s} prompt, {n_dec} decode steps, "
        f"{time.perf_counter() - t0:.1f} s: card vs CPU max |logit diff| "
        f"{max_rel:.3e} of the row's max (tol {PARITY_REL_TOL:.3e}), "
        f"{compared} greedy tokens compared{wrap}")
    del p_gpu, p_cpu, c_gpu, c_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_rel=max_rel, tokens_compared=compared, batch=b, prompt=s,
                steps=n_dec, layers=cfg.n_layers)


def phase_families(torch) -> dict:
    """Phase 14: (a) the ECDP and decode attention at the three families'
    shapes, (b) each at full width (depth as FAMILY_DEPTH), (c) card
    against CPU at cut depth."""
    timer = Timer(torch)
    ecdp_res = {arch: family_ecdp(torch, timer, arch)
                for arch in FAMILY_ARCHS}
    da_res = family_decode_attn(torch, timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    full = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        full[arch] = family_full(torch, arch)
        log(f"  14(b) {arch} in {time.perf_counter() - t0:.1f} s")
    parity = {}
    for arch in FAMILY_ARCHS:
        parity[arch] = family_parity(torch, arch)
    return dict(ecdp=ecdp_res, decode_attn=da_res, full=full, parity=parity)


# --- phase 15: training ---------------------------------------------------------

TRAIN_ARCH = "granite-8b"
# 8 of granite-8b's 36 layers, for the script's time: 2.15 B parameters,
# whose bf16 params and f32 AdamW moments and accumulated gradients
# (n_micro 2) hold 28 GiB; at 36 layers (8.25 B) the moments alone pass one
# card's memory
TRAIN_LAYERS = 8
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 2, 2, 10
TRAIN_LR = 3e-3                         # warmup_cosine(TRAIN_LR, 2, 10)
TRAIN_TIMED_FROM = 2                    # steps 0, 1 warm the allocator up
TRAIN_SPARE_GIB = 8
TRAIN_WORK = ROOT / "build" / "chip_smoke_phase15"
# 15(b): python -m repro_torch.launch.train's step count, its straggler
# detector live (it needs 4 timed steps before it can fire)
TRAIN_CLI_STEPS = 40
# 15(c): full width, depth cut; one n_micro-2 step of (batch, seq).
# granite-8b, seamless-m4t-medium and qwen3-moe-30b-a3b run 1 layer, for
# the script's time (the CPU's steps at 2 layers took 20, 13 and 39 s);
# rwkv6-3b keeps 2, where its gap shows (tenfold its 1-layer one);
# recurrentgemma-9b 3 (one (r, r, a) group) at a shorter sequence
# (TRAIN_PARITY_SEQ): at 2 x 128 its CPU step cost 57-65 s (2.8 B params,
# most of them its 256000-row embedding and lm_head, whose products scale
# with the tokens)
TRAIN_PARITY = {"granite-8b": dict(n_layers=1),
                "rwkv6-3b": dict(n_layers=2),
                "seamless-m4t-medium": dict(n_layers=1, n_enc_layers=1),
                "qwen3-moe-30b-a3b": dict(n_layers=1),
                "recurrentgemma-9b": dict(n_layers=3)}
TRAIN_PARITY_IN = (2, 128)
TRAIN_PARITY_SEQ = {"recurrentgemma-9b": (2, 32)}
# 15(c)'s bounds, card vs CPU after one step: the loss within
# TRAIN_LOSS_TOL of it (relative); each first moment m (0.1 x the clipped
# gradient g) within TRAIN_GRAD_TOL[arch] of its leaf's largest |m|; and
# each param whose m has one sign on both devices within a bf16 ulp of it
# and one of the update (2^-7 (|p| + lr): the update is rounded to bf16
# before it is added) plus lr eps (1/|g_card| + 1/|g_cpu|). At step 1 an
# update is -lr g / (|g| + eps) (+ decay): lr x the gradient's sign, less
# lr eps / |g|, so where g is far above eps = 1e-8 the devices' updates
# agree to an ulp, and near eps (lm_head's columns of tokens the batch
# lacks, a sum over tokens near 0) they part by up to that term; a sign
# the devices' roundings split moves the param by lr the other way
# (counted, printed).
TRAIN_LOSS_TOL = 2.0 ** -10
# per arch, the power of two at about twice its reading (granite-8b
# 1.44e-2, seamless 1.25e-2, qwen3-moe 1.30e-2), and rwkv6-3b's at 1.34x
# its 4.67e-2 (tmix.w_k): there the bf16 gradients of either device lie
# 6.3-6.4 % from an f32 one and the devices' f32 gradients 0.66 % apart,
# so the gap is the model's sensitivity to rounding, not the card
# (scripts/train_diagnostics.py rwkv6; cuBLAS's reduced-precision bf16
# reductions change no bit)
# (recurrentgemma-9b's, 2^-4, is its CPU tests' GRAD_TOL, which its first
# moments met at 2.6-2.9 % at 3 layers and 2 x 128 in PR 25)
TRAIN_GRAD_TOL = {"granite-8b": 2.0 ** -5, "seamless-m4t-medium": 2.0 ** -5,
                  "qwen3-moe-30b-a3b": 2.0 ** -5, "rwkv6-3b": 2.0 ** -4,
                  "recurrentgemma-9b": 2.0 ** -4}


def train_cfg(arch: str, **cut):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (dataclasses.replace(cfg, name=f"{cfg.name}-cut", **cut) if cut
            else cfg)


def train_profile(torch, run) -> dict:
    """One call of ``run`` (a train step) traced with torch.profiler, its
    kernels split by where they ran: the attention chunk loop (every
    ``common.chunked_attention`` call, forward, its recompute and its
    backward: from the grad reaching its output to the grads of q, k and
    v), the optimizer (``AdamW.apply_``), and the rest by kernel name (GEMM,
    elementwise / reduction / copy). The windows are cut by marker kernels
    on the one stream (a bitwise_not of an int16 opens an attention
    window, a bitwise_or closes it, a bitwise_xor comes before the
    optimizer), so each kernel's place comes from the device's own order.
    The host counts the markers it launches; the trace must hold each
    kind as often, opens and closes alternating. A trace that lacks a
    marker the host launched (the profiler lost its record) is taken once
    more, and said so; any other mismatch fails."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import common as cm
    from repro_torch.optim.adamw import AdamW

    marks = torch.zeros(3, dtype=torch.int16, device="cuda")
    issued = {"open": 0, "close": 0, "optimizer": 0}

    def mark(kind):
        issued[kind] += 1
        if kind == "open":
            marks[:1].bitwise_not_()
        elif kind == "close":
            marks[1:2].bitwise_or_(1)
        else:
            marks[2:].bitwise_xor_(1)

    attn, apply_ = cm.chunked_attention, AdamW.apply_

    def traced_attn(q, k, v, **kw):
        mark("open")
        out = attn(q, k, v, **kw)
        mark("close")
        if out.requires_grad:
            left = [sum(t.requires_grad for t in (q, k, v))]

            def last(_):
                left[0] -= 1
                if left[0] == 0:
                    mark("close")
            out.register_hook(lambda _: mark("open"))
            for t in (q, k, v):
                if t.requires_grad:
                    t.register_hook(last)
        return out

    def traced_apply(self, *args):
        mark("optimizer")
        return apply_(self, *args)

    def kind(name):
        name = name.lower().replace("_", "")  # BitwiseXorFunctor, ...
        return ("open" if "bitwisenot" in name
                else "close" if "bitwiseor" in name
                else "optimizer" if "bitwisexor" in name else None)

    for attempt in (1, 2):
        for k in issued:
            issued[k] = 0
        cm.chunked_attention, AdamW.apply_ = traced_attn, traced_apply
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cm.chunked_attention, AdamW.apply_ = attn, apply_
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        seen = {k: 0 for k in issued}
        for e in kernels:
            if kind(e.name):
                seen[kind(e.name)] += 1
        if issued["open"] != issued["close"] or not issued["optimizer"]:
            raise AssertionError(f"profile markers launched: {issued}")
        if seen == issued:
            break
        if attempt == 2 or any(seen[k] > issued[k] for k in issued):
            raise AssertionError(f"profile markers: launched {issued}, in "
                                 f"the trace {seen}")
        log(f"  the trace lacks {sum(issued.values()) - sum(seen.values())}"
            f" of the {sum(issued.values())} marker kernels launched "
            f"({seen} of {issued}): the profiler lost their records; "
            f"profiling another step")
    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    in_attn, in_opt = False, False
    for e in kernels:
        what = kind(e.name)
        if what in ("open", "close"):
            if in_attn == (what == "open"):
                raise AssertionError(f"profile markers: an attention window "
                                     f"{what}s twice in a row")
            in_attn = what == "open"
            continue
        if what == "optimizer":
            in_opt = True
            continue
        group = ("optimizer (AdamW.apply_)" if in_opt
                 else "attention chunk loop" if in_attn
                 else "GEMM" if _group(e.name).startswith("GEMM")
                 else _group(e.name))
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us()
        counts[group] = counts.get(group, 0) + 1
    if in_attn or not issued["open"]:
        raise AssertionError(f"profile markers: {issued['open']} attention "
                             f"windows (open at the end: {in_attn})")
    busy = sum(groups.values()) / 1e3
    return dict(wall_ms=wall * 1e3, device_ms=busy,
                groups_ms={g: us / 1e3 for g, us in groups.items()},
                groups_count=counts, attention_windows=issued["open"],
                profiled_steps=attempt)


def train_full(torch, lr: float = TRAIN_LR, profiled: bool = True,
               fixed_batch: bool = False) -> dict:
    """15(a): granite-8b at full width, TRAIN_LAYERS layers, as ``train()``
    builds its step: AdamW(lr=warmup_cosine(lr, 2, 10)), make_train_step
    at n_micro TRAIN_MICRO, SyntheticLM batches through a Prefetcher;
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, each between CUDA
    events, then (``profiled``) one more step profiled
    (``train_profile``). Every loss and global grad norm finite, the params
    finite after the last step, and the peak device memory TRAIN_SPARE_GIB
    under the card's. ``fixed_batch``: every step on batch 0."""
    from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.optim.schedule import warmup_cosine

    cfg = train_cfg(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_module(cfg.family).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = AdamW(lr=warmup_cosine(lr, 2, TRAIN_STEPS))
    state = opt.init(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    state_gib = torch.cuda.memory_allocated() / 2**30
    log(f"  {cfg.name}: {TRAIN_LAYERS} of 36 layers at full width, "
        f"{n_params / 1e9:.3f} B params; params + AdamW state "
        f"{state_gib:.2f} GiB, made in {time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, opt, n_micro=TRAIN_MICRO)
    norms = []
    global_norm = adamw_mod.global_norm

    def recorded(tree):
        out = global_norm(tree)
        norms.append(out)
        return out

    pf = Prefetcher(make_source(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0)))
    adamw_mod.global_norm = recorded
    losses, spans = [], []
    try:
        for i in range(TRAIN_STEPS + 1):
            got, host = pf.next()
            assert got == i, (got, i)
            if not (fixed_batch and i):
                batch = {k: torch.from_numpy(v).cuda()
                         for k, v in host.items()}
            if i == TRAIN_STEPS:
                break
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
            params, state, met = step(params, state, batch)
            span[1].record()
            spans.append(span)
            losses.append(met["loss"])
        torch.cuda.synchronize()

        def one():
            nonlocal params, state
            params, state, met = step(params, state, batch)
            losses.append(met["loss"])
        prof = train_profile(torch, one) if profiled else None
    finally:
        adamw_mod.global_norm = global_norm
        pf.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    ms = [a.elapsed_time(b) for a, b in spans]
    timed = sorted(ms[TRAIN_TIMED_FROM:])
    med = timed[len(timed) // 2]
    mean = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    log(f"  {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"(n_micro {TRAIN_MICRO}): {med:.1f} ms a step (median of steps "
        f"{TRAIN_TIMED_FROM}..{TRAIN_STEPS - 1}, CUDA events; mean {mean:.1f};"
        f" every step {[round(x, 1) for x in ms]}), {tokens / med * 1e3:.0f} "
        f"tokens/s; peak {peak:.2f} GiB of {total:.2f}")
    log(f"  loss {[round(x, 4) for x in losses]}")
    log(f"  grad norm {[round(x, 4) for x in norms]}")
    busy = prof["device_ms"] if prof else math.nan
    if prof:
        log(f"  profiled step: wall {prof['wall_ms']:.1f} ms (traced), "
            f"device {busy:.1f} ms; idle share {1 - busy / med:.3f} of the "
            f"untraced median step, {1 - busy / prof['wall_ms']:.3f} of the "
            f"traced one; {prof['attention_windows']} attention windows")
        for g, v in sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]):
            log(f"    {g:32s} {v:9.2f} ms {v / busy:6.1%} "
                f"{prof['groups_count'][g]:6d} kernels")
    bad = [x for x in losses + norms if not math.isfinite(x)]
    if bad or not finite:
        raise AssertionError(f"15(a): non-finite losses / grad norms {bad}; "
                             f"params finite: {finite}")
    if peak + TRAIN_SPARE_GIB > total:
        raise AssertionError(f"15(a): peak {peak:.2f} GiB leaves less than "
                             f"{TRAIN_SPARE_GIB} GiB of the card's "
                             f"{total:.2f}: take fewer layers")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=TRAIN_LAYERS, lr=lr, params_b=n_params / 1e9,
                state_gib=state_gib, ms_per_step=med, mean_ms=mean,
                step_ms=ms, tokens_per_s=tokens / med * 1e3, peak_gib=peak,
                card_gib=total, losses=losses, grad_norms=norms,
                profile=prof, idle_share=1 - busy / med if prof else None,
                seconds=time.perf_counter() - t0)


def train_entry(torch) -> dict:
    """15(b): the entry point on the card. ``train("granite-8b", smoke=True,
    steps=80, batch=8, seq=32, lr=1e-2)`` with a checkpoint directory: the
    mean of the last 5 losses below the first 5's by more than 0.1 (the
    reference's gate); a second call at 84 steps resumes at step 80 and
    runs 4; a fault_hook raising StepFault at step 4 is retried (8 steps,
    all finite); then run_deploy of the (params, AdamW) checkpoint into a
    die image, whose DRAM tier is the trained params bit for bit, and
    build_engine serving 2 requests from it; then ``python -m
    repro_torch.launch.train`` (TRAIN_CLI_STEPS steps, on the card by
    default, its checkpoint written) and ``--production`` refused. The
    straggler detector is live throughout (train() reads each step's loss
    inside the timed call, so a step's time is the device's): a
    StepFault it raises fails the phase; the executors' step times and
    flagged steps are printed."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tiering import dram_tier
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.deploy import run_deploy
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.fault import StepFault
    from repro_torch.serving.sampler import SampleConfig

    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    ckpt = TRAIN_WORK / "ckpt"
    executors = []
    executor_cls = train_mod.FaultTolerantExecutor

    class Seen(executor_cls):             # read, not changed
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            executors.append(self)

    train_mod.FaultTolerantExecutor = Seen
    hits = {"n": 0}

    def hook(step, retries):
        if step == 4 and retries == 0:
            hits["n"] += 1
            raise StepFault("injected device loss")

    t0 = time.perf_counter()
    try:
        r1 = train_mod.train(TRAIN_ARCH, smoke=True, steps=80, batch=8,
                             seq=32, lr=1e-2, ckpt_dir=str(ckpt))
        t1 = time.perf_counter() - t0
        r2 = train_mod.train(TRAIN_ARCH, smoke=True, steps=84, batch=8,
                             seq=32, lr=1e-2, ckpt_dir=str(ckpt))
        r3 = train_mod.train(TRAIN_ARCH, smoke=True, steps=8, batch=2,
                             seq=16, lr=1e-3, seed=1, ckpt_every=3,
                             ckpt_dir=str(TRAIN_WORK / "fault"),
                             fault_hook=hook)
    finally:
        train_mod.FaultTolerantExecutor = executor_cls
    first = sum(r1["losses"][:5]) / 5
    last = sum(r1["losses"][-5:]) / 5
    times = sorted(executors[0].times)
    flagged = [h.step for h in executors[0].history if h.straggler]
    log(f"  train(smoke, 80 steps of 8 x 32) on the card in {t1:.1f} s: "
        f"loss {first:.4f} -> {last:.4f} (means of the first / last 5); "
        f"the executor's step times (the loss read inside): median "
        f"{times[len(times) // 2] * 1e3:.2f} ms, max {times[-1] * 1e3:.2f} "
        f"ms; steps past {executors[0].policy.straggler_factor:g}x the "
        f"trailing median: {flagged} (a StepFault at "
        f"{executors[0].policy.straggler_tolerance} in a row)")
    if not last < first - 0.1:
        raise AssertionError(f"15(b): no learning: {first} -> {last}")
    if r2["start_step"] != 80 or len(r2["losses"]) != 4:
        raise AssertionError(f"15(b): resume at {r2['start_step']} with "
                             f"{len(r2['losses'])} losses, want 80 and 4")
    if hits["n"] != 1 or len(r3["losses"]) != 8 or not all(
            math.isfinite(x) for x in r3["losses"]):
        raise AssertionError(f"15(b): fault hook hits {hits['n']}, losses "
                             f"{r3['losses']}")
    out = TRAIN_WORK / "deploy"
    img = str(out / "nand.img")
    run_deploy(TRAIN_ARCH, True, str(ckpt), str(out), store_path=img)
    dram, _ = CheckpointManager(out).restore(dram_tier(r2["params"]))
    for name in ("embed", "final_norm"):
        if not torch.equal(dram[name], r2["params"][name]):
            raise AssertionError(f"15(b): the deployed {name} is not the "
                                 "trained one")
    eng = build_engine(TRAIN_ARCH, store_image=img, ckpt=str(out),
                       sample_cfg=SampleConfig())
    rids = [eng.submit(p, max_new=8) for p in ([1, 2, 3], [7, 8, 9, 10])]
    served = eng.run()
    if any(len(served[r]) != 8 for r in rids):
        raise AssertionError(f"15(b): served {served}")
    del eng
    # the command line as a user runs it: on the card by default, the
    # straggler detector live for TRAIN_CLI_STEPS steps
    import os
    cli = TRAIN_WORK / "cli"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_cli = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps",
         str(TRAIN_CLI_STEPS), "--batch", "2", "--seq", "16", "--ckpt",
         str(cli)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    t_cli = time.perf_counter() - t_cli
    if run.returncode != 0 or not run.stdout.startswith("loss: "):
        raise AssertionError(f"python -m repro_torch.launch.train exited "
                             f"{run.returncode}: {run.stderr[-2000:]}")
    if CheckpointManager(cli).latest_step() != TRAIN_CLI_STEPS - 1:
        raise AssertionError("python -m repro_torch.launch.train: no "
                             f"checkpoint at step {TRAIN_CLI_STEPS - 1}")
    import logging
    argv, root = sys.argv, logging.getLogger()
    handlers, level = root.handlers[:], root.level
    sys.argv = ["repro_torch.launch.train", "--production"]
    try:                                 # main()'s parser, in this process
        train_mod.main()
        refused = ""
    except ValueError as e:              # the production mesh's size error
        refused = str(e)
    finally:
        sys.argv = argv
        root.handlers[:], root.level = handlers, level
    if "needs a world of 256 ranks" not in refused:
        raise AssertionError(f"--production: {refused!r}")
    log(f"  python -m repro_torch.launch.train --steps {TRAIN_CLI_STEPS} (on "
        f"the card, its default; the straggler detector live) in "
        f"{t_cli:.1f} s: {run.stdout.strip()}; --production refused")
    log(f"  resumed at step {r2['start_step']} ({len(r2['losses'])} steps); "
        f"fault at step 4 retried ({len(r3['losses'])} steps, loss "
        f"{r3['losses'][0]:.4f} -> {r3['losses'][-1]:.4f}); deployed the "
        f"(params, AdamW) checkpoint into a die image and served "
        f"{[served[r] for r in rids]}; 15(b) in "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    return dict(first5=first, last5=last, resumed_at=r2["start_step"],
                fault_hits=hits["n"], step_ms_median=times[len(times) // 2]
                * 1e3, step_ms_max=times[-1] * 1e3, flagged_steps=flagged,
                cli_steps=TRAIN_CLI_STEPS, cli_s=t_cli,
                seconds=time.perf_counter() - t0)


def parity_inputs(torch, arch: str):
    """15(c)'s config of ``arch`` (full width, TRAIN_PARITY's depth), its
    params from a seeded init on the card, the batch (on the CPU) and the
    step (n_micro 2, as ``train()`` builds it)."""
    import numpy as np

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine

    cfg = train_cfg(arch, **TRAIN_PARITY[arch])
    params = family_module(cfg.family).init(
        cfg, torch.Generator(device="cuda").manual_seed(21), device="cuda")
    b, s = TRAIN_PARITY_SEQ.get(arch, TRAIN_PARITY_IN)
    rng = np.random.default_rng(22)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1),
                                         dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch = {"src_embeds": torch.from_numpy(rng.standard_normal(
                     (b, s, cfg.d_model), dtype=np.float32)),
                 "tgt_tokens": batch["tokens"], "labels": batch["labels"]}
    opt = AdamW(lr=warmup_cosine(3e-3, 2, 10))
    return cfg, params, batch, opt, make_train_step(cfg, opt, n_micro=2)


def train_parity(torch, arch: str) -> dict:
    """15(c): one make_train_step step (n_micro 2) of ``arch`` at full
    width, depth cut to TRAIN_PARITY's, on the card and on the CPU from the
    same params (a seeded init on the card, copied) and the same batch:
    the loss, the first moments and the params under 15(c)'s bounds. MoE:
    the CPU takes the card's routes (``RouteWitness``; forward and
    recompute alike)."""
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg, p_gpu, batch, opt, step = parity_inputs(torch, arch)
    p_cpu = tree_map(lambda t: t.to("cpu", copy=True), p_gpu)
    wit, side, route = RouteWitness(torch, cfg.top_k), [None], moe._route

    def witness_route(xt, router, k):
        lg = xt.float() @ router.float()
        if side[0] == "card":
            gates, idx = route(xt, router, k)
            wit.record(lg.detach(), idx)
            return gates, idx
        return wit.hand_over(lg)

    moe._route = witness_route
    try:
        wit.step(f"{arch} train step")
        side[0] = "card"
        p_gpu, st_gpu, m_gpu = step(p_gpu, opt.init(p_gpu),
                                    {k: v.cuda() for k, v in batch.items()})
        side[0] = "cpu"
        p_cpu, st_cpu, m_cpu = step(p_cpu, opt.init(p_cpu), batch)
        wit.step("end")
    finally:
        moe._route = route
    loss_c, loss_g = float(m_cpu["loss"]), float(m_gpu["loss"])
    loss_rel = abs(loss_c - loss_g) / abs(loss_c)
    lr = float(opt._lr(st_cpu.step))
    names = leaf_names(p_cpu)
    grad_tol = TRAIN_GRAD_TOL[arch]
    grad_rel, p_over, split, n_all = (0.0, ""), (0.0, ""), 0, 0
    for name, mc, mg, pc, pg in zip(names, tree_leaves(st_cpu.m),
                                    tree_leaves(st_gpu.m), tree_leaves(p_cpu),
                                    tree_leaves(p_gpu)):
        mc, pc, pg = mc.cuda(), pc.cuda().float(), pg.float()   # compared
        # on the card, the CPU copies carried over
        grad_rel = max(grad_rel, (float((mg - mc).abs().max()
                                        / mc.abs().max().clamp_min(1e-30)),
                                  name))
        same = mc.sign() == mg.sign()
        # eps (1 - b1) / |m| = eps / |g|
        tol = ((torch.maximum(pc.abs(), pg.abs()) + lr) * 2.0 ** -7
               + lr * 1e-9 * (1 / mc.abs() + 1 / mg.abs()))
        over = ((pc - pg).abs() / tol)[same]
        if over.numel():
            p_over = max(p_over, (float(over.max()), name))
        split += int((~same).sum())
        n_all += same.numel()
    b, s = TRAIN_PARITY_SEQ.get(arch, TRAIN_PARITY_IN)
    log(f"  {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
        + f" at full width), one step of {b} x {s} (n_micro 2), "
        f"{time.perf_counter() - t0:.1f} s ({torch.get_num_threads()} CPU "
        f"threads): loss {loss_c:.5f} (CPU) / {loss_g:.5f} (card), rel "
        f"{loss_rel:.2e} (tol {TRAIN_LOSS_TOL:.2e});"
        f" first moments {grad_rel[0]:.3e} of their leaf's max ({grad_rel[1]};"
        f" tol {grad_tol:.3e}); params whose m has one sign at "
        f"{p_over[0]:.3f} of their bound at most ({p_over[1]}), "
        f"{split / n_all:.2e} of them with m's sign split"
        + (f"; {wit.summary()}" if cfg.family == "moe" else ""))
    if (loss_rel > TRAIN_LOSS_TOL or grad_rel[0] > grad_tol
            or p_over[0] > 1):
        raise AssertionError(f"15(c) {arch}: card vs CPU past the bounds")
    del p_gpu, p_cpu, st_gpu, st_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel=grad_rel[0],
                grad_rel_leaf=grad_rel[1], grad_tol=grad_tol,
                param_over_bound=p_over[0], param_over_leaf=p_over[1],
                sign_split_share=split / n_all, layers=cfg.n_layers,
                seconds=time.perf_counter() - t0)


def leaf_names(tree, prefix="") -> list[str]:
    """A param tree's leaf paths in sorted-key (pytree) order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def phase_train(torch) -> dict:
    """Phase 15: (a) granite-8b at full width, TRAIN_LAYERS layers; (b) the
    entry point, resume, retry and train -> deploy -> serve; (c) card vs
    CPU at cut depth."""
    t0 = time.perf_counter()
    full = train_full(torch)
    log(f"  15(a) in {time.perf_counter() - t0:.1f} s")
    entry = train_entry(torch)
    parity = {}
    for arch in TRAIN_PARITY:
        parity[arch] = train_parity(torch, arch)
    return dict(full=full, entry=entry, parity=parity)


# --- phase 16: the cost tools ------------------------------------------------

# 16(b) holds the dry-run of 15(a)'s own cell against what 15(a) measured:
# its peak within DRYRUN_PEAK_TOL (relative) of the card's, its bound no
# larger than the median step
DRYRUN_PEAK_TOL = 0.2


def dryrun_all(torch) -> dict:
    """16(a): ``launch.dryrun.run_cell`` in this process for all 40
    full-size (arch x shape) cells: 32 counted, 8 skipped, none an error,
    and no byte allocated on the card (its allocated and peak bytes the
    same before and after, the peak reset first)."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    deployed: dict = {}
    rows = [dryrun.run_cell(a, s, deployed=deployed) for a in ARCHS
            for s in SHAPES]
    seconds = time.perf_counter() - t0
    after = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    status = [r["status"] for r in rows]
    errors = [(r["arch"], r["shape"], r.get("error")) for r in rows
              if r["status"] == "error"]
    log(f"  {len(rows)} cells in {seconds:.1f} s: {status.count('ok')} ok, "
        f"{status.count('skipped')} skipped, {len(errors)} errors; the "
        f"card's allocated / peak bytes {before} before, {after} after")
    for r in rows:
        if r["status"] == "ok":
            m, rf = r["memory"], r["roofline"]
            log(f"    {r['arch']:22s} {r['shape']:12s} args "
                f"{m['argument_size_in_bytes'] / 2**30:9.2f} GiB, peak "
                f"{m['peak_live_bytes'] / 2**30:9.2f} GiB, fits "
                f"{'yes' if r['fits_card'] else 'no '}, "
                f"{rf['dominant'].removesuffix('_s'):7s} bound "
                f"{rf['step_time_lower_bound_s']:.4g} s "
                f"({r['build_s'] + r['count_s']:.2f} s)")
    if errors or status.count("ok") != 32 or status.count("skipped") != 8:
        raise AssertionError(f"16(a): {status.count('ok')} ok, "
                             f"{status.count('skipped')} skipped, errors "
                             f"{errors}")
    if after != before:
        raise AssertionError(f"16(a): the dry-run allocated on the card: "
                             f"{before} -> {after}")
    return dict(seconds=seconds, ok=status.count("ok"),
                skipped=status.count("skipped"), cuda_bytes=list(after),
                cells={f"{r['arch']}/{r['shape']}": dict(
                    status=r["status"], memory=r.get("memory"),
                    fits_card=r.get("fits_card"),
                    dominant=r.get("roofline", {}).get("dominant"),
                    bound_s=r.get("roofline", {}).get(
                        "step_time_lower_bound_s"),
                    seconds=r.get("build_s", 0) + r.get("count_s", 0))
                       for r in rows})


def dryrun_train_cell(torch, full: dict) -> dict:
    """16(b): 15(a)'s own cell (granite-8b at full width, TRAIN_LAYERS
    layers, TRAIN_BATCH x TRAIN_SEQ tokens as TRAIN_MICRO microbatches,
    f32 moments) through ``dryrun.run_cell`` with the config, shape and
    knobs given: its peak live bytes against 15(a)'s
    ``max_memory_allocated`` (within DRYRUN_PEAK_TOL), its step-time bound
    against 15(a)'s median step (no larger); their ratio is the cell's
    roofline fraction."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = train_cfg(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    r = dryrun.run_cell(TRAIN_ARCH, "train_4k", cfg=cfg, shape=shape,
                        knobs=dict(n_micro=TRAIN_MICRO,
                                   moment_dtype="float32"))
    seconds = time.perf_counter() - t0
    if r["status"] != "ok":
        raise AssertionError(f"16(b): {r['status']}: {r.get('error')}")
    peak = r["memory"]["peak_live_bytes"] / 2**30
    rf = r["roofline"]
    bound_ms = rf["step_time_lower_bound_s"] * 1e3
    measured_ms = full["ms_per_step"]
    log(f"  {cfg.name} at {TRAIN_BATCH} x {TRAIN_SEQ}, n_micro "
        f"{TRAIN_MICRO}, counted in {seconds:.1f} s: args "
        f"{r['memory']['argument_size_in_bytes'] / 2**30:.2f} GiB; peak "
        f"{peak:.2f} GiB against 15(a)'s {full['peak_gib']:.2f} (ratio "
        f"{peak / full['peak_gib']:.4f}, tol {DRYRUN_PEAK_TOL}); bound "
        f"{bound_ms:.1f} ms ({rf['dominant']}; compute "
        f"{rf['compute_s'] * 1e3:.1f} ms, memory {rf['memory_s'] * 1e3:.1f} "
        f"ms) against 15(a)'s median step {measured_ms:.1f} ms: roofline "
        f"fraction {bound_ms / measured_ms:.4f}")
    if abs(peak / full["peak_gib"] - 1) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"16(b): dry-run peak {peak:.2f} GiB against "
                             f"the card's {full['peak_gib']:.2f} GiB")
    if bound_ms > measured_ms:
        raise AssertionError(f"16(b): bound {bound_ms:.1f} ms above the "
                             f"measured step {measured_ms:.1f} ms")
    return dict(peak_gib=peak, card_peak_gib=full["peak_gib"],
                bound_ms=bound_ms, measured_ms=measured_ms,
                roofline_fraction=bound_ms / measured_ms,
                dominant=rf["dominant"], compute_ms=rf["compute_s"] * 1e3,
                memory_ms=rf["memory_s"] * 1e3, seconds=seconds,
                argument_gib=r["memory"]["argument_size_in_bytes"] / 2**30)


# 16(c): the mesh cells, counted in subprocesses with the card hidden (a
# fake process group is global to its process: none may remain when phase
# 19 makes its nccl group)
MESH_FULL_CELL = ("granite-8b", "train_4k", "single")    # 16x16, full size
MESH_JOBS = 6


def _mesh_records(out: Path) -> dict:
    recs = {}
    for f in sorted(out.glob("*.json")):
        r = json.loads(f.read_text())
        recs[f"{r['arch']}/{r['shape']}/{r['mesh']}"] = dict(
            status=r["status"], reason=r.get("reason"), error=r.get("error"),
            n_collectives=r.get("n_collectives"),
            collectives=r.get("collectives"),
            wire_bytes_by_op=r.get("roofline", {}).get("collectives_by_op"),
            collective_s=r.get("roofline", {}).get("collective_s"),
            dominant=r.get("roofline", {}).get("dominant"),
            seconds=r.get("build_s", 0) + r.get("count_s", 0))
    return recs


def start_dryrun_meshes() -> dict:
    """16(c), started: ``python -m repro_torch.launch.dryrun`` over the
    reference's production meshes, on the card's host and its torch, with
    no card visible: every smoke cell on 16x16 and 2x16x16 (``--smoke
    --mesh both``, MESH_JOBS worker processes) beside granite-8b's
    full-size ``train_4k`` on 16x16, the two commands at once, while
    16(a) and 16(b) run in this process (``finish_dryrun_meshes``)."""
    import os
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="dryrun_mesh"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.pop("WORLD_SIZE", None)
    arch, shape, mesh = MESH_FULL_CELL
    cmds = {"full": ["--arch", arch, "--shape", shape, "--mesh", mesh],
            "smoke": ["--smoke", "--mesh", "both", "--jobs", str(MESH_JOBS)]}
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cmd, "--out",
         str(work / k)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, cmd in cmds.items()}
    return dict(procs=procs, work=work, t0=time.perf_counter())


def finish_dryrun_meshes(started: dict) -> dict:
    """16(c), collected: every cell ok or skipped by the reference's rule,
    the full cell's collectives and wire bytes more than 0. Each cell's
    status, collectives, wire bytes by op and count seconds are the
    ``dryrun_mesh`` JSON line."""
    import shutil

    procs, work, t0 = started["procs"], started["work"], started["t0"]
    arch, shape, _ = MESH_FULL_CELL
    runs, seconds = {}, {}
    try:
        for k, proc in procs.items():
            runs[k] = proc.communicate(timeout=300) + (proc.returncode,)
            seconds[k] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cells = {k: _mesh_records(work / k) for k in procs}
    shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    for k, (stdout, stderr, rc) in runs.items():
        for ln in stdout.splitlines():
            if ln.startswith("["):
                log("    " + ln[:150])
        if rc != 0:
            raise AssertionError(f"16(c) {k}: the dry-run exited {rc}: "
                                 f"{stdout[-1500:]} {stderr[-1500:]}")
    errors = [k for recs in cells.values() for k, c in recs.items()
              if c["status"] != "ok" and c["status"] != "skipped"]
    smoke = [c["status"] for c in cells["smoke"].values()]
    full = cells["full"].get(f"{arch}/{shape}/16x16", dict(status="missing"))
    if errors or len(smoke) != 80 or full["status"] != "ok":
        raise AssertionError(f"16(c): {len(smoke)} smoke cells; not ok: "
                             f"{errors}; the full cell {full['status']}")
    wire = {k: round(v / 2**30, 2) for k, v in full["wire_bytes_by_op"].items()}
    log(f"  16(c): {len(smoke)} smoke cells ({smoke.count('ok')} ok, "
        f"{smoke.count('skipped')} skipped) in {seconds['smoke']:.1f} s; "
        f"{arch} {shape} 16x16 at full size: {full['n_collectives']:.0f} "
        f"collectives {full['collectives']}, wire GiB {wire}, collective "
        f"{full['collective_s']:.3g} s, counted in {full['seconds']:.1f} s "
        f"({seconds['full']:.1f} s with the process); 16(c) {wall:.1f} s")
    if not (full["n_collectives"] > 0 and sum(wire.values()) > 0):
        raise AssertionError(f"16(c): the full cell counted no collective: "
                             f"{full}")
    return dict(seconds=wall, smoke_seconds=seconds["smoke"],
                full_seconds=seconds["full"], cells=cells)


def phase_dryrun(torch, full: dict) -> dict:
    """Phase 16: (a) the dry-run of all 40 cells, allocating nothing on the
    card; (b) 15(a)'s cell counted, against what 15(a) measured; (c) the
    mesh cells, counted in subprocesses beside (a) and (b)
    (``start_dryrun_meshes``, ``finish_dryrun_meshes``)."""
    t0 = time.perf_counter()
    mesh = start_dryrun_meshes()
    cells = dryrun_all(torch)
    train = dryrun_train_cell(torch, full)
    return dict(all=cells, train_cell=train, mesh=finish_dryrun_meshes(mesh),
                seconds=time.perf_counter() - t0)


# --- phase 17: tensor-parallel streamed serving ----------------------------------

SHARD_LAYERS = 4                   # of OPT-6.7B's 32, at full width
SHARD_COUNTS = (1, 2, 4)
SHARD_PROMPT, SHARD_NEW = 128, 16  # 4 requests
SHARD_FFN_M = 64                   # 17(a): a step's 4 slots x 16 lanes
SHARD_TOL = dict(rtol=1e-5, atol=1e-3)   # the reference's psum bound


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sharded_ffn_check(torch, timer, store, cfg) -> dict:
    """17(a): layer 0's FFN (w_up, GELU, w_down) at S=4 over a mesh of the
    one card repeated — per shard its w_up columns and w_down rows through
    the paged ECDP kernel, then the f32 all-reduce (the engine's
    ``_sharded_ffn`` before its cast) — against the unsharded paged chain
    on the same pages (``dense._ffn_apply(partial=True)``)."""
    import torch.nn.functional as F

    from repro_torch.core.erdpe import all_reduce_sum, maybe_flash_matmul
    from repro_torch.kernels import paged_ecdp
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import dense
    from repro_torch.serving.engine import _paged
    from repro_torch.store import ShardedWeightPagePool, WeightPagePool

    S = max(SHARD_COUNTS)
    mesh = make_model_mesh(S, devices=["cuda:0"] * S)
    names = {"w_up": "layers/ffn/w_up@0", "w_down": "layers/ffn/w_down@0"}
    pages = sum(store.entry_pages(n) for n in names.values())
    pool1 = WeightPagePool(store, pages, device="cuda")
    poolS = ShardedWeightPagePool(store, pages // S + 4, mesh)
    t1, tS = pool1.upload(names.values()), poolS.upload(names.values())
    torch.cuda.synchronize()
    whole = {k: _paged(pool1.buffer, t1[n], t1[n]["kn"])
             for k, n in names.items()}
    shards = [{k: _paged(poolS.buffer[s], tS[n], tS[n]["kn"], shard=s)
               for k, n in names.items()} for s in range(S)]
    assert [tS[n]["kn"] for n in names.values()] == \
        [(cfg.d_model, cfg.d_ff // S), (cfg.d_ff // S, cfg.d_model)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((SHARD_FFN_M, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def unsharded():
        return dense._ffn_apply(cfg, whole, x, partial=True)

    def sharded():
        return all_reduce_sum([dense._ffn_apply(cfg, p, x, partial=True)
                               for p in shards], mesh)

    paged_ecdp.paged_ecdp_matmul.launches = 0
    got = sharded()
    assert paged_ecdp.paged_ecdp_matmul.launches == 2 * S
    want = unsharded()
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = SHARD_TOL["atol"] + SHARD_TOL["rtol"] * want.abs()
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"17(a): the S={S} sharded FFN is "
                             f"{float(err.max())} from the unsharded chain")
    # where the error comes from: the activation's bf16 elements that the
    # column-parallel w_up (N = d_ff / S: another launch plan) rounds to
    # another value than the whole w_up does
    act = [F.gelu(maybe_flash_matmul(x, p["w_up"]).float(),
                  approximate="tanh").to(torch.bfloat16)
           for p in [whole] + shards]
    cols = torch.arange(cfg.d_ff // S, device="cuda")
    flips = sum(int((h != act[0][:, ((cols // 128) * S + s) * 128
                                  + cols % 128]).sum())
                for s, h in enumerate(act[1:]))
    ms = timer(sharded)
    ms_whole = timer(unsharded)
    d, f, m = cfg.d_model, cfg.d_ff, SHARD_FFN_M
    # both matrices' pages once (w_down's scales on every shard), x, the
    # activation written and read, the partials and the sum
    nbytes = (2 * d * f * 9 / 8 + 4 * f + S * 4 * d + 2 * m * d
              + 2 * 2 * m * f + (2 * S + 1) * 4 * m * d)
    b_ms, b_by = bound_ms(nbytes, 2.0 * 2 * m * d * f)
    res = dict(n_shards=S, m=m, max_abs_err=float(err.max()),
               of_bound=float((err / bound).max()),
               max_abs_out=float(want.abs().max()), activation_flips=flips,
               ms=ms, unsharded_ms=ms_whole, bound_ms=b_ms, bound_by=b_by,
               launches=2 * S, card=_smi())
    log(f"  17(a) layer 0's FFN, S={S} over cuda:0 x {S}: max abs err "
        f"{res['max_abs_err']:.3e} against the unsharded chain (bound atol "
        f"{SHARD_TOL['atol']}, rtol {SHARD_TOL['rtol']}; at most "
        f"{res['of_bound']:.3f} of it; outputs up to "
        f"{res['max_abs_out']:.3g}; {flips} of {m * cfg.d_ff} activation "
        f"elements an ulp apart); {2 * S} paged ECDP launches + the f32 sum "
        f"{ms:.4f} ms, unsharded chain {ms_whole:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); {res['card']}")
    del pool1, poolS, t1, tS, whole, shards
    return res


def phase_sharded(torch) -> dict:
    """Phase 17: the streamed dense plane tensor-parallel at OPT-6.7B width
    (4 of 32 layers), at n_shards 1, 2 and 4 over a mesh of the one card
    repeated: (a) one layer's sharded FFN against the unsharded chain;
    (b) four requests served, S=2 and S=4 tokens equal to S=1's and their
    last step's logits within 2^-6 of each row's largest; (c) the pool's
    counters; (d) ms a step beside the card's name and power limit (a
    check that the function works on one card, not a scaling figure)."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.core.tiering import dram_tier
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import PageStore, StreamConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(OPT_6_7B, n_layers=SHARD_LAYERS,
                              name=f"opt-6.7b-{SHARD_LAYERS}l")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    tier = cfg.n_layers * (_payload(d, f) + _payload(f, d)
                           + 4 * _payload(d, d)) + _payload(d, v)
    # prefetch depth 1: at 4 layers two windows and the pinned lm_head do
    # not fit half the tier
    kw = dict(max_slots=4, max_seq=256, seed=0,
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024),
              device="cuda")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, v, SHARD_PROMPT).tolist() for _ in range(4)]
    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    store = PageStore(n_planes=32)
    smi = _smi()
    runs, ref = {}, None
    for S in SHARD_COUNTS:
        t0 = time.perf_counter()
        sc = StreamConfig(group_size=1, prefetch_depth=1,
                          device_budget_bytes=tier // 2, n_shards=S)
        if S == 1:       # programs the store (RBER 1e-4) the others serve
            eng = Engine(cfg, params, rber=1e-4, weight_store=store,
                         stream_cfg=sc, **kw)
            assert store.total_bytes == tier > sc.device_budget_bytes
        else:
            eng = Engine(cfg, dram_tier(params), weight_store=store,
                         stream_cfg=sc, mesh=["cuda:0"] * S, **kw)
            assert eng.store_preprogrammed and eng.mesh.n_shards == S
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rids = [eng.submit(p, max_new=SHARD_NEW) for p in prompts]
        torch.cuda.synchronize()
        ecdp.ecdp_matmul.launches = 0
        paged_ecdp.paged_ecdp_matmul.launches = 0
        paged_attn.paged_attn.launches = 0
        steps, t0 = 0, time.perf_counter()
        while eng.step():
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"paged_ecdp": paged_ecdp.paged_ecdp_matmul.launches,
                    "ecdp": ecdp.ecdp_matmul.launches,
                    "paged_attn": paged_attn.paged_attn.launches}
        per_layer = 2 + 2 * S          # wq, wo once; w_up, w_down a shard
        assert launches == {"paged_ecdp": steps * cfg.n_layers * per_layer,
                            "ecdp": steps,
                            "paged_attn": steps * cfg.n_layers}, \
            (S, launches, steps)
        st = eng.stream_stats()
        out = [list(eng.requests[r].out) for r in rids]
        logits = eng.last_logits.cpu()
        assert all(len(o) == SHARD_NEW and all(0 <= x < v for x in o)
                   for o in out)
        assert bool(torch.isfinite(logits).all())
        assert st["bytes_streamed"] > 0 and st["pool_grows"] == 0
        assert st["pool_uploads"] == st["groups_streamed"] > 0
        run = dict(steps=steps, ms_per_step=wall / steps * 1e3,
                   build_s=build_s, launches=launches,
                   paged_ecdp_per_step=cfg.n_layers * per_layer,
                   pool_uploads=st["pool_uploads"],
                   pool_pages=st["pool_pages"],
                   bytes_streamed_per_step=st["bytes_streamed"] / steps,
                   stall_s=st["stall_s"], h2d_s=st["pool_h2d_s"],
                   card=smi)
        if S == 1:
            ref = dict(tokens=out, logits=logits, pool_pages=st["pool_pages"],
                       steps=steps)
        else:
            parts = eng.wpool.buffer
            assert len(parts) == S and all(
                b.device == torch.device(dev) and b.is_cuda
                for b, dev in zip(parts, eng.mesh.devices))
            assert st["pool_shards"] == S
            assert st["pool_shard_transfers"] == S * st["pool_uploads"]
            assert st["pool_local_pages"] < ref["pool_pages"], \
                (st["pool_local_pages"], ref["pool_pages"])
            assert steps == ref["steps"], (steps, ref["steps"])
            if out != ref["tokens"]:
                raise AssertionError(f"S={S}: tokens {out} differ from "
                                     f"S=1's {ref['tokens']}")
            gap = ((logits - ref["logits"]).abs().amax(-1)
                   / ref["logits"].abs().amax(-1)).max()
            if not float(gap) <= PARITY_REL_TOL:
                raise AssertionError(f"S={S}: last step's logits "
                                     f"{float(gap):.3e} of the row's largest "
                                     "from S=1's")
            run.update(pool_shard_transfers=st["pool_shard_transfers"],
                       pool_local_pages=st["pool_local_pages"],
                       tokens_equal=True, logit_gap=float(gap))
        runs[f"S={S}"] = run
        log(f"  S={S}: built in {build_s:.1f} s; {len(rids)} requests "
            f"({SHARD_PROMPT}-token prompts, {SHARD_NEW} new) in {steps} "
            f"steps, {run['ms_per_step']:.1f} ms/step; launches {launches} "
            f"({run['paged_ecdp_per_step']} paged ECDP a step); pool "
            f"{st.get('pool_local_pages', st['pool_pages'])} pages a shard, "
            f"{st['pool_uploads']} uploads, "
            f"{st.get('pool_shard_transfers', st['pool_uploads'])} "
            f"transfers" + (f"; logits {run['logit_gap']:.3e} of the row's "
                            "largest from S=1's, tokens equal"
                            if S > 1 else "") + f"; {smi}")
        if S == 1:
            ffn = sharded_ffn_check(torch, Timer(torch), store, cfg)
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del store, params
    gc.collect()
    secs = time.perf_counter() - t_phase
    log(f"  phase 17 in {secs:.1f} s (one card: the ms a step are a check "
        "that the shards serve, not a tensor-parallel scaling figure)")
    return dict(ffn=ffn, runs=runs, seconds=secs)


# --- phase 18: tensor-parallel streamed MoE -----------------------------------

SHARD_MOE_LAYERS = 4               # of qwen3-moe-30b-a3b's 48, at full width
# d_ff 768 is 6 tiles of 128: S = 2 and 3 partition it, S = 4 cannot
SHARD_MOE_COUNTS = (1, 2, 3)
SHARD_MOE_PROMPT, SHARD_MOE_NEW = 128, 16      # 4 requests
# scripts/bench_gate.py SHARDED_MATCH_FLOOR["moe"]: the reference's floor
# on a free run's greedy-token match against the unsharded plane
SHARD_MOE_MATCH_FLOOR = 0.85


def _token_match(got, want) -> float:
    """Per-position greedy-token agreement over all requests
    (benchmarks/serve_sharded.py's ``_match_frac``)."""
    n = hit = 0
    for w, g in zip(want, got):
        n += max(len(w), len(g))
        hit += sum(a == b for a, b in zip(w, g))
    return hit / max(n, 1)


def sharded_moe_ffn_check(torch, timer, store, eng, experts,
                          n_shards: int) -> dict:
    """18(a): layer 0's expert FFN over a real 64-lane route (layer 0's
    router on random bf16 lanes, top-8) at ``n_shards`` over the one card
    repeated: each shard's slab of the routed experts' w_gate / w_up column
    slices and w_down row slices, bound over a ShardedWeightPagePool's
    partition, through 3 grouped paged ECDP launches to an f32 partial
    (``serve_expert_ffn(partial=True)``, the dispatch computed once), then
    the f32 all-reduce: against the unsharded chain on the same pages (the
    f32 combine of the whole experts) within rtol 1e-5 / atol 1e-3, the
    reference's psum bound; timed beside the unsharded chain, the byte
    bound and torch.bmm over each shard's routed experts' bf16 slices
    (``experts``: layer 0's bf16 banks, the weights before deployment)."""
    import numpy as np

    from repro_torch.core.erdpe import all_reduce_sum
    from repro_torch.kernels import paged_ecdp
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import moe
    from repro_torch.serving.engine import _paged
    from repro_torch.store import ShardedWeightPagePool, WeightPagePool

    cfg = eng.cfg
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    S = n_shards
    mesh = make_model_mesh(S, devices=["cuda:0"] * S)
    gen = torch.Generator(device="cuda").manual_seed(18)
    h = torch.randn((1, MOE_ROUTE_TOKENS, d), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    gates, idx = moe.serve_route(eng._layers[0]["moe"]["router"], h, k)
    routed = np.unique(idx.cpu().numpy()).tolist()
    names = {m: [ref.entry(0, x) for x in routed]
             for m, ref in eng._expert_refs.items()}
    every = [n for ns in names.values() for n in ns]
    pages = sum(store.entry_pages(n) for n in every)
    pool1 = WeightPagePool(store, pages, device="cuda")
    poolS = ShardedWeightPagePool(store, pages // S + 8, mesh)
    t1, tS = pool1.upload(every), poolS.upload(every)
    torch.cuda.synchronize()
    # the engine's slab: routed experts in id order, padded to e_slab rows
    e_slab = eng._e_slab
    slab_map = torch.full((e,), -1, dtype=torch.int32, device="cuda")
    slab_map[torch.tensor(routed, device="cuda")] = torch.arange(
        len(routed), dtype=torch.int32, device="cuda")

    def bank(pool_buf, tbls, shard=None):
        out = {}
        for m, ns in names.items():
            rows = ns + [ns[0]] * (e_slab - len(ns))
            dev = [tbls[n]["dev"] if shard is None
                   else tbls[n]["dev_shards"][shard] for n in rows]
            tbl = {"dev": tuple(torch.stack([x[j] for x in dev])
                                for j in range(3))}
            out[m] = _paged(pool_buf, tbl, tbls[ns[0]]["kn"])
        return out
    whole = bank(pool1.buffer, t1)
    shards = [bank(poolS.buffer[s], tS, s) for s in range(S)]
    assert [shards[0][m].kn for m in ("w_gate", "w_down")] == \
        [(d, f // S), (f // S, d)]

    def unsharded():
        return moe.serve_expert_ffn(whole, h, gates, idx, slab_map,
                                    partial=True)

    def sharded():
        rows = moe.expert_rows(idx, slab_map, e_slab)
        return all_reduce_sum([moe.serve_expert_ffn(
            b, h, gates, idx, slab_map, partial=True, rows=rows)
            for b in shards], mesh)

    paged_ecdp.grouped_paged_ecdp_matmul.launches = 0
    got = sharded()
    launches = paged_ecdp.grouped_paged_ecdp_matmul.launches
    assert launches == 3 * S, launches
    want = unsharded()
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = SHARD_TOL["atol"] + SHARD_TOL["rtol"] * want.abs()
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"18(a): the S={S} sharded expert FFN is "
                             f"{float(err.max())} from the unsharded chain")
    ms = timer(sharded)
    ms_whole = timer(unsharded)
    # the library: per shard, torch.bmm over its routed experts' bf16
    # w_gate / w_up column slices and w_down row slices, each expert's rows
    # padded to the 64 an expert can get
    sel = torch.tensor(routed, device="cuda")
    exp = {m: w.index_select(0, sel) for m, w in experts.items()}
    fs = f // S
    xp = torch.zeros((len(routed), MOE_ROUTE_TOKENS, d), dtype=torch.bfloat16,
                     device="cuda")
    hp = torch.zeros((len(routed), MOE_ROUTE_TOKENS, fs),
                     dtype=torch.bfloat16, device="cuda")
    lib = [(exp["w_gate"][:, :, s * fs:(s + 1) * fs].contiguous(),
            exp["w_up"][:, :, s * fs:(s + 1) * fs].contiguous(),
            exp["w_down"][:, s * fs:(s + 1) * fs].contiguous())
           for s in range(S)]

    def library():
        for wg, wu, wd in lib:
            torch.bmm(xp, wg)
            torch.bmm(xp, wu)
            torch.bmm(hp, wd)
    t_lib = timer(library)
    del exp, lib, xp, hp
    rows_n = MOE_ROUTE_TOKENS * k
    r = len(routed)
    # ECC off: the routed experts' q once and their scales (w_down's on
    # every shard); per shard the rows in and the f32 rows out of the
    # three launches, the bf16 activation; the partials and the sum
    nbytes = (r * (3 * d * f + 4 * (2 * f + S * d))
              + S * (2 * 2 * rows_n * d + 2 * 4 * rows_n * fs
                     + 2 * rows_n * fs + 4 * rows_n * d)
              + (S + 1) * 4 * MOE_ROUTE_TOKENS * d)
    b_ms, b_by = bound_ms(nbytes, 2.0 * 3 * rows_n * d * f)
    res = dict(n_shards=S, rows=rows_n, routed=r, launches=launches,
               max_abs_err=float(err.max()),
               of_bound=float((err / bound).max()),
               max_abs_out=float(want.abs().max()), ms=ms,
               unsharded_ms=ms_whole, library_ms=t_lib, bound_ms=b_ms,
               bound_by=b_by, card=_smi())
    log(f"  18(a) layer 0's expert FFN, S={S} over cuda:0 x {S}, a "
        f"{MOE_ROUTE_TOKENS}-lane route ({rows_n} rows over {r} experts): "
        f"max abs err {res['max_abs_err']:.3e} against the unsharded chain "
        f"(at most {res['of_bound']:.3f} of the bound; outputs up to "
        f"{res['max_abs_out']:.3g}); {launches} grouped paged ECDP launches "
        f"+ the f32 sum {ms:.4f} ms, unsharded chain {ms_whole:.4f} ms, "
        f"torch.bmm {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{res['card']}")
    del pool1, poolS, t1, tS, whole, shards
    return res


def _sharded_moe_run(torch, eng, prompts, record=False, witness=None):
    """Serve ``prompts`` (SHARD_MOE_NEW new tokens each) with the launch
    counters zeroed just before and read after every step: the tokens,
    every step's logits, slots with lanes, per-request output lengths and
    host wall (synchronized). ``record`` keeps each router call's (idx,
    logits) on the host, in call order; ``witness`` (a RouteWitness holding
    such a record) hands those routes over instead of the engine's own,
    the gates computed on the card over the engine's router logits."""
    from repro_torch.models import moe as moe_mod

    rids = [eng.submit(p, max_new=SHARD_MOE_NEW) for p in prompts]
    torch.cuda.synchronize()
    moe_stream_zero_counts()
    route, routes = moe_mod.serve_route, []

    def hooked(router, x, top_k, **kw):
        lg = torch.einsum("std,de->ste", x.float(), router.float())
        if witness is None:
            gates, idx = route(router, x, top_k, **kw)
            routes.append((idx.cpu(), lg.cpu()))
            return gates, idx
        q = torch.from_numpy(eng._host_in["q_lens"].numpy().copy())
        valid = torch.arange(x.shape[1])[None, :] < q[:, None]
        _, idx = witness.hand_over(lg.cpu(), valid)
        idx = idx.to(x.device)
        return torch.softmax(lg.gather(-1, idx), dim=-1), idx.to(torch.int32)

    logits, live, wall, outs, slots, per_step = [], [], [], [], [], []
    before = moe_stream_counts()
    if record or witness is not None:
        moe_mod.serve_route = hooked
    t_all = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            if not eng.step():
                break
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            logits.append(eng.last_logits.cpu())
            live.append(eng._host_in["q_lens"].numpy().copy())
            outs.append([len(eng.requests[r].out) for r in rids])
            slots.append([eng.requests[r].slot for r in rids])
            now = moe_stream_counts()
            per_step.append({k: now[k] - before[k] for k in now})
            before = now
    finally:
        moe_mod.serve_route = route
    total = time.perf_counter() - t_all
    return dict(out=[list(eng.requests[r].out) for r in rids],
                logits=logits, live=live, wall=wall, outs=outs, slots=slots,
                per_step=per_step, launches=moe_stream_counts(),
                total_s=total, routes=routes)


def _first_flip(got, want):
    """(request, position) of the first greedy token that differs, or
    None."""
    for r, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return r, j
    return None


def _flip_margins(torch, ref, r: int, j: int, n_layers: int, k: int):
    """At the step where the unsharded run emitted request ``r``'s token
    ``j``: that row's top-2 logit margin, and the smallest router k-th /
    (k+1)-th margin over the request's lanes in every layer."""
    step = next(i for i, n in enumerate(ref["outs"]) if n[r] > j)
    slot = ref["slots"][step][r]
    row = ref["logits"][step][slot]
    top2 = torch.topk(row, 2).values
    n_lanes = int(ref["live"][step][slot])
    margins = []
    for _, lg in ref["routes"][step * n_layers:(step + 1) * n_layers]:
        top = torch.topk(lg[slot, :n_lanes], k + 1).values
        margins.append(float((top[:, -2] - top[:, -1]).min()))
    return dict(step=step, logit_margin=float(top2[0] - top2[1]),
                router_margin=min(margins))


def phase_sharded_moe(torch) -> dict:
    """Phase 18: the streamed MoE plane tensor-parallel at qwen3-moe-30b-a3b
    width (4 of 48 layers) under half its flash tier, at n_shards 1, 2 and
    3 over a mesh of the one card repeated, every S served from the store
    S=1 programmed: (a) layer 0's sharded expert FFN against the unsharded
    chain at S = 2, 3; (b) S = 2 and 3 with S=1's routes handed over
    (RouteWitness): every step's logits within 2^-6 of each row's largest
    of S=1's, the greedy tokens equal; (c) a free run at each S, its token
    match against S=1's at least the reference's floor of 0.85, the first
    flip and the margins at it; (d) per step 4 x 3 x S grouped paged ECDP
    launches, pool_shard_transfers == S x pool_uploads, each shard's pool
    within budget / S + the reserve, ms a step beside the card's name and
    power limit (one card: a check that the shards serve, not a scaling
    figure)."""
    import numpy as np

    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.core.tiering import dram_tier
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.store import PageStore, StreamConfig

    t_phase = time.perf_counter()
    cfg = moe_cfg(SHARD_MOE_LAYERS)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    n_layers, k = cfg.n_layers, cfg.top_k
    expert = 2 * _payload(d, f) + _payload(f, d)
    tier = n_layers * cfg.n_experts * expert + _payload(d, v)
    budget = tier // 2
    # token budget 1024: the misroute-stall contraction never changes the
    # plan, so every S runs the same steps
    kw = dict(max_slots=4, max_seq=256, seed=0,
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024),
              device="cuda")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(1, v, SHARD_MOE_PROMPT).tolist()
               for _ in range(4)]
    params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(5),
                      device="cuda")
    experts0 = {m: w[0].clone()
                for m, w in params["layers"]["moe"]["experts"].items()}
    dram = dram_tier(params)
    store = PageStore(n_planes=32)
    smi = _smi()
    runs, ffn, ref = {}, {}, None
    for S in SHARD_MOE_COUNTS:
        t0 = time.perf_counter()
        sc = StreamConfig(device_budget_bytes=budget, n_shards=S)
        if S == 1:       # programs the store (RBER 1e-4) the others serve
            eng = Engine(cfg, params, rber=1e-4, weight_store=store,
                         stream_cfg=sc, **kw)
            del params
            assert store.total_bytes == tier > budget, \
                (store.total_bytes, tier)
        else:
            eng = Engine(cfg, dram, weight_store=store, stream_cfg=sc,
                         mesh=["cuda:0"] * S, **kw)
            assert eng.store_preprogrammed and eng.mesh.n_shards == S
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        assert eng.streamed_moe and eng._expert_kn == {
            "w_gate": (d, f // S), "w_up": (d, f // S), "w_down": (f // S, d)}
        res = {}
        if S == 1:
            run = ref = _sharded_moe_run(torch, eng, prompts, record=True)
            assert len(ref["routes"]) == len(ref["wall"]) * n_layers
            timer = Timer(torch)
            for s2 in SHARD_MOE_COUNTS[1:]:
                ffn[f"S={s2}"] = sharded_moe_ffn_check(torch, timer, store,
                                                       eng, experts0, s2)
            del timer, experts0
        else:
            wit = RouteWitness(torch, k)
            wit.queue, wit.where = list(ref["routes"]), f"18(b) S={S}"
            handed = _sharded_moe_run(torch, eng, prompts, witness=wit)
            assert not wit.queue and len(handed["logits"]) == \
                len(ref["logits"]), (len(wit.queue), len(handed["logits"]))
            gap = 0.0
            for i, (a, b, la, lb) in enumerate(zip(
                    handed["logits"], ref["logits"], handed["live"],
                    ref["live"])):
                assert (la == lb).all(), i
                rows = la > 0
                g = float(((a[rows] - b[rows]).abs().amax(-1)
                           / b[rows].abs().amax(-1)).max())
                if not g <= PARITY_REL_TOL:
                    raise AssertionError(f"18(b) S={S} step {i}: logits "
                                         f"{g:.3e} of the row's largest "
                                         "from S=1's")
                gap = max(gap, g)
            if handed["out"] != ref["out"]:
                raise AssertionError(f"18(b) S={S}: tokens with S=1's routes "
                                     f"{handed['out']} differ from S=1's "
                                     f"{ref['out']}")
            res.update(handed_logit_gap=gap, routes_taken=len(wit.taken),
                       router_rel=wit.max_rel, route_ties=wit.ties)
            run = _sharded_moe_run(torch, eng, prompts)
            match = _token_match(run["out"], ref["out"])
            flip = _first_flip(run["out"], ref["out"])
            res.update(token_match=match, first_flip=None)
            if flip is not None:
                res["first_flip"] = dict(
                    request=flip[0], position=flip[1],
                    **_flip_margins(torch, ref, flip[0], flip[1], n_layers,
                                    k))
            if match < SHARD_MOE_MATCH_FLOOR:
                raise AssertionError(f"18(c) S={S}: token match {match:.3f} "
                                     f"below {SHARD_MOE_MATCH_FLOOR}")
        steps = len(run["wall"])
        per_step = {"grouped_paged_ecdp": n_layers * 3 * S,
                    "grouped_ecdp": 0, "ecdp": 1, "paged_attn": n_layers}
        for i, c in enumerate(run["per_step"]):
            assert c == per_step, (S, i, c)
        assert run["launches"] == {x: steps * n for x, n in
                                   per_step.items()}, (S, run["launches"])
        assert all(len(o) == SHARD_MOE_NEW and all(0 <= t < v for t in o)
                   for o in run["out"])
        assert all(bool(torch.isfinite(lg).all()) for lg in run["logits"])
        eng.prefetcher.drain()
        st = eng.expert_stats()
        pb = store.page_bytes
        local = st.get("pool_local_bytes", st["pool_pages"] * pb)
        ceil = budget // S + st["pool_reserve_bytes"] + 8 * pb
        # the per-shard clamp's contract (the unsharded pool is sized by
        # the cache's budget alone)
        assert S == 1 or local <= ceil, (S, local, ceil)
        assert st["pool_grows"] == 0 and st["prefetch_failures"] == 0, st
        assert st["expert_cache_bytes"] <= eng.expert_cache.capacity
        if S > 1:
            parts = eng.wpool.buffer
            assert len(parts) == S and all(
                b.device == torch.device(dev) and b.is_cuda
                for b, dev in zip(parts, eng.mesh.devices))
            assert st["pool_shards"] == S
            assert st["pool_shard_transfers"] == S * st["pool_uploads"] > 0
        res.update(steps=steps, ms_per_step=sum(run["wall"]) / steps * 1e3,
                   tokens_per_s=SHARD_MOE_NEW * len(prompts) / run["total_s"],
                   build_s=build_s, launches=run["launches"],
                   per_step=per_step, pool_uploads=st["pool_uploads"],
                   pool_shard_transfers=st.get("pool_shard_transfers",
                                               st["pool_uploads"]),
                   pool_local_bytes=local, per_device_ceiling_bytes=ceil,
                   expert_hit_rate=st["expert_hit_rate"],
                   misroute_stalls=st["misroute_stalls"],
                   expert_bytes_per_token=st["expert_bytes_per_token"],
                   pool_h2d_s=st["pool_h2d_s"], card=smi)
        runs[f"S={S}"] = res
        log(f"  S={S}: built in {build_s:.1f} s; {len(prompts)} requests "
            f"({SHARD_MOE_PROMPT}-token prompts, {SHARD_MOE_NEW} new) in "
            f"{steps} steps, {res['ms_per_step']:.1f} ms/step; launches "
            f"{run['launches']} ({per_step['grouped_paged_ecdp']} grouped "
            f"paged ECDP a step, every step); pool {local / 2**30:.3f} GiB "
            f"a shard (ceiling {ceil / 2**30:.3f}), {st['pool_uploads']} "
            f"uploads, {res['pool_shard_transfers']} transfers; hit rate "
            f"{st['expert_hit_rate']:.3f}"
            + (f"; with S=1's routes: logits {res['handed_logit_gap']:.3e} "
               f"of the row's largest from S=1's, tokens equal "
               f"({res['routes_taken']} routes its own router would have "
               f"chosen otherwise); free run: token match "
               f"{res['token_match']:.3f}, first flip {res['first_flip']}"
               if S > 1 else "") + f"; {smi}")
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del store, dram
    gc.collect()
    secs = time.perf_counter() - t_phase
    log(f"  phase 18 in {secs:.1f} s (one card: the ms a step are a check "
        "that the shards serve, not a tensor-parallel scaling figure)")
    return dict(ffn=ffn, runs=runs, seconds=secs)


# --- phase 19: training over a ("data", "model") mesh ---------------------------

# 19(a): train() over a mesh of one rank, 15(a)'s model and batches, fewer
# steps for the script's time (15(a) runs 10; 4 until the whole script
# passed 900 s with phase 19 at 4: 920.3 s): step 0 warms up, step 2 is
# timed
MESH_STEPS = 3
MESH_WORK = ROOT / "build" / "chip_smoke_phase19"
# 19(b): train() at smoke size with a checkpoint
MESH_SMOKE = dict(smoke=True, steps=6, batch=8, seq=32, ckpt_every=3,
                  lr=1e-3, seed=5)


def _timed(torch, step, spans: list):
    """``step`` with each call between CUDA events and host clocks, the
    card synchronized before and after (the time of the whole step, host
    dispatch included)."""
    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(*args)
        ev[1].record()
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0, ev))
        return out
    return timed


def _step_ms(spans: list) -> dict:
    dev = [a.elapsed_time(b) for _, (a, b) in spans]
    wall = [w * 1e3 for w, _ in spans]
    steady = sorted(dev[TRAIN_TIMED_FROM:])
    host = sorted(wall[TRAIN_TIMED_FROM:])
    return dict(device_ms=steady[len(steady) // 2],
                wall_ms=host[len(host) // 2], every_device_ms=dev,
                every_wall_ms=wall)


def mesh_train_full(torch) -> dict:
    """19(a): granite-8b at full width, TRAIN_LAYERS layers, MESH_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ tokens (n_micro TRAIN_MICRO) through
    ``train()`` over the process group of this one rank: the (1, 1)
    ("data", "model") mesh, every param and moment a DTensor placed by
    ``param_specs`` / ZeRO-1 ``opt_state_specs``, the step with
    ``grad_specs`` (``sharding.pin_grad`` counted). Then the same params
    (seed 0), schedule and batches through 15(a)'s plain step. The losses
    within TRAIN_LOSS_TOL (relative) of each other; ms a step of each,
    device (CUDA events) and wall (host clock around a synchronized step:
    the DTensor path's host dispatch shows there); peak memory of each."""
    from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine

    cfg = train_cfg(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    mesh_spans, plain_spans, pins = [], [], [0]
    make, get, pin = (train_mod.make_train_step, train_mod.get_config,
                      sh.pin_grad)

    def counted_pin(w, spec):
        pins[0] += 1
        return pin(w, spec)

    train_mod.make_train_step = lambda *a, **kw: _timed(
        torch, make(*a, **kw), mesh_spans)
    train_mod.get_config = lambda arch, smoke=True: cfg
    sh.pin_grad = counted_pin
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        r = train_mod.train(TRAIN_ARCH, smoke=False, steps=MESH_STEPS,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            n_micro=TRAIN_MICRO, lr=TRAIN_LR, seed=0,
                            device="cuda")
    finally:
        train_mod.make_train_step, train_mod.get_config = make, get
        sh.pin_grad = pin
    t_mesh = time.perf_counter() - t0
    peak_mesh = torch.cuda.max_memory_allocated() / 2**30
    params, state = r["params"], r["opt_state"]
    mesh = sh.leaves_with_path(params)[0][1].device_mesh
    pspecs = sh.param_specs(params, mesh)
    specs = (pspecs, sh.opt_state_specs(state, pspecs, mesh, zero1=True))
    got = sh.leaves_with_path((params, state))
    wrong = [p for (p, x), (_, spec) in zip(got, sh.leaves_with_path(specs))
             if not sh.is_dtensor(x)
             or list(x.placements) != sh.placements(spec, mesh)]
    if (tuple(mesh.shape) != (1, 1) or wrong or not pins[0]
            or tuple(mesh.mesh_dim_names) != ("data", "model")):
        raise AssertionError(f"19(a): mesh {tuple(mesh.shape)}, leaves not "
                             f"placed by the specs {wrong[:4]}, pin_grad "
                             f"calls {pins[0]}")
    mesh_losses = list(r["losses"])
    del r, params, state, got
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_module(cfg.family).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, MESH_STEPS // 10 + 1, MESH_STEPS))
    state = opt.init(params)
    step = _timed(torch, make_train_step(cfg, opt, n_micro=TRAIN_MICRO),
                  plain_spans)
    pf = Prefetcher(make_source(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0)))
    plain_losses = []
    try:
        for i in range(MESH_STEPS):
            got_step, host = pf.next()
            assert got_step == i, (got_step, i)
            batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
            params, state, met = step(params, state, batch)
            plain_losses.append(float(met["loss"]))
    finally:
        pf.close()
    t_plain = time.perf_counter() - t0
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, plain_losses))
    mesh_ms, plain_ms = _step_ms(mesh_spans), _step_ms(plain_spans)
    log(f"  {cfg.name} ({TRAIN_LAYERS} layers, full width), {MESH_STEPS} "
        f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} (n_micro {TRAIN_MICRO}): "
        f"train() over the (1, 1) mesh {t_mesh:.1f} s, {pins[0]} pin_grad "
        f"calls; loss {[round(x, 5) for x in mesh_losses]}; the plain step "
        f"{[round(x, 5) for x in plain_losses]}; largest relative gap "
        f"{gap:.3e} (tol {TRAIN_LOSS_TOL:.2e})")
    log(f"  ms a step (median of steps {TRAIN_TIMED_FROM}..{MESH_STEPS - 1}"
        f"): DTensor path device {mesh_ms['device_ms']:.1f}, wall "
        f"{mesh_ms['wall_ms']:.1f}; plain device {plain_ms['device_ms']:.1f}"
        f", wall {plain_ms['wall_ms']:.1f}; every step (device) "
        f"{[round(x, 1) for x in mesh_ms['every_device_ms']]} / "
        f"{[round(x, 1) for x in plain_ms['every_device_ms']]}; peak "
        f"{peak_mesh:.2f} / {peak_plain:.2f} GiB (one rank: no scaling)")
    bad = [x for x in mesh_losses + plain_losses if not math.isfinite(x)]
    if bad or gap > TRAIN_LOSS_TOL:
        raise AssertionError(f"19(a): losses {mesh_losses} (mesh) vs "
                             f"{plain_losses} (plain)")
    return dict(layers=TRAIN_LAYERS, steps=MESH_STEPS, mesh_losses=mesh_losses,
                plain_losses=plain_losses, loss_gap=gap, pin_grad_calls=pins[0],
                mesh=mesh_ms, plain=plain_ms, peak_gib=peak_mesh,
                plain_peak_gib=peak_plain, mesh_s=t_mesh, plain_s=t_plain)


def mesh_checkpoint(torch) -> dict:
    """19(b): ``train()`` at smoke size (MESH_SMOKE) over the one rank's
    mesh with a checkpoint; ``remesh_restore`` of it onto ``plan_mesh(1)``
    and, with the process group torn down, the plain ``train()``'s resume
    of it (nothing left to do): both bit-equal to the run's final state.
    ``train(production=True)`` on the one card raises the production
    mesh's size error."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as train_mod
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.elastic import remesh_restore

    shutil.rmtree(MESH_WORK, ignore_errors=True)
    n = MESH_SMOKE["steps"]
    r = train_mod.train(TRAIN_ARCH, ckpt_dir=str(MESH_WORK), device="cuda",
                        **MESH_SMOKE)
    final = {p: x.full_tensor().clone() for p, x in sh.leaves_with_path(
        (r["params"], r["opt_state"]))}
    del r
    cfg = get_config(TRAIN_ARCH, smoke=True)
    params = family_module(cfg.family).init(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    state, es = remesh_restore(CheckpointManager(MESH_WORK),
                               (params, AdamW().init(params)), 1,
                               device="cuda")
    remeshed = [p for p, x in sh.leaves_with_path(state)
                if not torch.equal(x.full_tensor(), final[p])]
    try:
        train_mod.train(TRAIN_ARCH, production=True, device="cuda")
        refused = ""
    except ValueError as e:
        refused = str(e)
    dist.destroy_process_group()
    r2 = train_mod.train(TRAIN_ARCH, ckpt_dir=str(MESH_WORK), device="cuda",
                         **MESH_SMOKE)
    plain = [p for p, x in sh.leaves_with_path((r2["params"],
                                                r2["opt_state"]))
             if sh.is_dtensor(x) or not torch.equal(x, final[p])]
    shutil.rmtree(MESH_WORK, ignore_errors=True)
    log(f"  train() at smoke ({n} steps, checkpoint every "
        f"{MESH_SMOKE['ckpt_every']}) over the mesh; remesh_restore onto "
        f"plan_mesh(1) = {tuple(es.mesh.shape)} at step {es.step}: "
        f"{len(final) - len(remeshed)} of {len(final)} leaves bit-equal; the "
        f"plain train() resumed at step {r2['start_step']}: "
        f"{len(final) - len(plain)} of {len(final)} bit-equal; --production: "
        f"{refused!r}")
    if (remeshed or plain or es.step != n - 1 or r2["start_step"] != n
            or tuple(es.mesh.shape) != (1, 1)
            or "needs a world of 256 ranks" not in refused):
        raise AssertionError(f"19(b): remeshed {remeshed[:4]}, plain "
                             f"{plain[:4]}, refused {refused!r}")
    return dict(leaves=len(final), remesh_step=es.step,
                resumed_at=r2["start_step"], production=refused)


def phase_mesh_train(torch) -> dict:
    """Phase 19: training over a ("data", "model") mesh on one rank (an
    ``nccl`` process group of one on cuda:0): (a) the full-width step
    through ``train()``'s mesh path against the plain step, (b) the
    checkpoint across meshes and ``--production``'s refusal. No 19(c):
    ``gloo`` on this torch crashes in DTensor's all-gather of CUDA tensors
    (``_functional_collectives.all_gather_tensor``), and NCCL takes one
    rank a card, so several ranks on the one card are held by the CPU tests
    only (PERF.md §7)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    t0 = time.perf_counter()
    init_distributed("cuda")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"19: process group {dist.get_backend()} "
                                 f"of {dist.get_world_size()}")
        full = mesh_train_full(torch)
        ckpt = mesh_checkpoint(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    secs = time.perf_counter() - t0
    log(f"  phase 19 in {secs:.1f} s")
    return dict(full=full, checkpoint=ckpt, seconds=secs)


EXAMPLES = ("torch_quickstart", "torch_train_tiny", "torch_deploy_nvllm",
            "torch_edge_serve")
EXAMPLE_OK = {"torch_quickstart": "quickstart OK",
              "torch_train_tiny": "train_tiny OK",
              "torch_deploy_nvllm": "deploy_nvllm OK — corrupted flash "
                                    "reads decode identically",
              "torch_edge_serve": "edge_serve OK"}


def start_examples() -> dict:
    """20(a): the four ``examples/torch_*.py`` on the card at their
    default sizes, each a subprocess, all four started together (beside
    20(b)'s build, which holds the card's memory, not its time)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return dict(t0=time.perf_counter(), procs={name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES})


def finish_examples(started: dict) -> dict:
    """20(a)'s gate: each example exits 0 with its ``OK`` line last."""
    out = {}
    for name, proc in started["procs"].items():
        stdout, stderr = proc.communicate(timeout=300)
        lines = stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or lines[-1] != EXAMPLE_OK[name]:
            raise AssertionError(f"examples/{name}.py: exit "
                                 f"{proc.returncode}\n{stdout}\n{stderr}")
        out[name] = dict(seconds=round(time.perf_counter() - started["t0"],
                                       1), lines=lines)
        log(f"  examples/{name}.py: exit 0, {len(lines)} lines, last "
            f"{lines[-1]!r} ({out[name]['seconds']} s after the start)")
        for ln in lines[:-1]:
            log(f"    {ln}")
    return out


# 20(b): qwen3-moe-30b-a3b at all 48 layers through build_engine. Two
# prompts, MOE_DEPTH_NEW greedy tokens each; the streamed engine under a
# device budget of half the expert store.
MOE_DEPTH_PROMPTS, MOE_DEPTH_NEW = (64, 33), 4
MOE_DEPTH_SPARE_GIB = 8                 # the build's peak under the card's


def _peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _depth_run(torch, eng, prompts, counts, zero) -> dict:
    """``prompts`` served to completion, MOE_DEPTH_NEW greedy tokens each,
    the launch counters zeroed just before and read just after: each
    step's synchronized host wall, logits and slots with lanes on the
    host, and the engine's stats."""
    rids = [eng.submit(p, max_new=MOE_DEPTH_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    logits, live, wall = [], [], []
    while True:
        t0 = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        logits.append(eng.last_logits.cpu())
        live.append(eng._host_in["q_lens"].numpy() > 0)
    out = [list(eng.requests[r].out) for r in rids]
    assert all(len(o) == MOE_DEPTH_NEW for o in out), out
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    return dict(out=out, logits=logits, live=live, wall=wall,
                launches=counts(), stats=list(eng.stats),
                peak_bytes=torch.cuda.max_memory_allocated())


def moe_depth_arithmetic(cfg) -> dict:
    """The bytes the build should hold, from the config's shapes: the
    bf16 tree, its flash tier (int8 + 1/8 parity + f32 scales) and the
    DRAM tier the resident engine keeps (attention in f32, the rest bf16)."""
    from repro_torch.core.tiering import _walk, init_template, is_flash_path

    bf16 = flash = dram = 0
    for path, t in _walk(init_template(cfg)):
        bf16 += 2 * t.numel()
        if is_flash_path(path) and t.ndim >= 2:
            k, n = t.shape[-2:]
            flash += t.numel() // (k * n) * _payload(k, n)
        else:
            dram += (4 if path.startswith("layers/attn/w") else 2) * t.numel()
    return dict(bf16_tree=bf16, flash_tier=flash, dram_tier=dram,
                expected_resident=flash + dram)


def moe_depth_build(torch) -> dict:
    """20(b)'s build: qwen3-moe-30b-a3b at full width and all 48 layers
    through ``build_engine(MOE_ARCH, smoke=False, rber=1e-4)`` (the flash
    tier encoded as it is drawn, ``tiering.deploy_init``): the seconds, the
    device peak (at least MOE_DEPTH_SPARE_GIB under the card's memory)
    beside the bytes of ``moe_depth_arithmetic``, the resident bytes.
    Returns the engine with them."""
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import flash_bytes
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving.sampler import SampleConfig

    cfg = get_config(MOE_ARCH)
    assert cfg.n_layers == 48, cfg.n_layers
    want = moe_depth_arithmetic(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serve_mod.build_engine(MOE_ARCH, smoke=False, device="cuda",
                                 rber=1e-4, sample_cfg=SampleConfig())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    fb, _ = flash_bytes(eng.params)
    assert fb == want["flash_tier"], (fb, want["flash_tier"])
    gib = 2 ** 30
    log(f"  build_engine {MOE_ARCH} (48 of 48 layers, {cfg.n_experts} "
        f"experts top-{cfg.top_k} of d_ff {cfg.d_ff}, RBER 1e-4): "
        f"{build_s:.1f} s; device peak while deploying {peak / gib:.2f} "
        f"GiB of the card's {total / gib:.2f} (the bf16 tree alone: "
        f"{want['bf16_tree'] / gib:.2f} GiB; its flash tier "
        f"{want['flash_tier'] / gib:.2f} GiB; the resident tier and DRAM "
        f"weights {want['expected_resident'] / gib:.2f} GiB); resident "
        f"{resident / gib:.2f} GiB; the process's host peak RSS so far "
        f"{_peak_rss_gib():.2f} GiB")
    if peak > total - MOE_DEPTH_SPARE_GIB * gib:
        raise AssertionError(
            f"build peak {peak / gib:.2f} GiB leaves less than "
            f"{MOE_DEPTH_SPARE_GIB} GiB of the card's {total / gib:.2f}")
    return dict(engine=eng, build_s=build_s, build_peak_bytes=peak,
                resident_bytes=resident, card_bytes=total, arithmetic=want)


def moe_depth_serve(torch, built: dict, reference: bool = False) -> dict:
    """20(b)'s steps: the built engine serves the two prompts compiled,
    one capture, the warm-up's and the capture's counters each a step's
    48 x 3 grouped ECDP, 1 ECDP and 48 paged attention; ms a step. Then
    the same engine serves the same prompts again through its step body
    run eagerly: the same tokens, and the logits of the slots with lanes
    bit-equal to the replayed ones at every step, each step's launches
    counted. The engine is closed and freed. With ``reference`` every
    replayed step's logits are kept on the host (the streamed engine's
    reference, ``scripts/moe_full_depth.py``)."""
    import numpy as np

    eng = built.pop("engine")
    cfg = eng.cfg
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in MOE_DEPTH_PROMPTS]
    per_step = {"grouped_ecdp": cfg.n_layers * 3, "ecdp": 1,
                "paged_attn": cfg.n_layers}
    run = _depth_run(torch, eng, prompts, moe_counts, moe_zero_counts)
    steps = len(run["logits"])
    assert eng.step_traces == 1, eng.step_traces
    # a replay ticks no counter: the warm-up's and the capture's launches
    assert run["launches"] == {k: 2 * n for k, n in per_step.items()}, \
        run["launches"]
    # the same engine, its step body eager: the replays' check at 48 layers
    eng.compiled = False
    eager = _depth_run(torch, eng, prompts, moe_counts, moe_zero_counts)
    assert eager["out"] == run["out"], (eager["out"], run["out"])
    _same_live_logits(torch, f"{cfg.name} eager", eager, run)
    assert eager["launches"] == {k: steps * n for k, n in per_step.items()}, \
        (eager["launches"], steps)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ms = [w * 1e3 for w in run["wall"]]
    eager_ms = sum(eager["wall"]) / steps * 1e3
    log(f"  compiled: {steps} steps, {ms[0]:.1f} ms the first (warm-up and "
        f"capture), then {sum(ms[1:]) / max(steps - 1, 1):.2f} ms a step "
        f"(replays); peak {run['peak_bytes'] / 2**30:.2f} GiB serving; "
        f"launches (warm-up + capture) {run['launches']} = 2 x {per_step}; "
        f"tokens {run['out']}; the same engine eager: {eager_ms:.2f} ms a "
        f"step, the tokens and the logits of the slots with lanes bit-equal "
        f"to the replays' at all {steps} steps, launches "
        f"{eager['launches']} = {steps} x {per_step}")
    out = dict(built, steps=steps, first_step_ms=ms[0],
               ms_per_step=sum(ms[1:]) / max(steps - 1, 1),
               eager_ms_per_step=eager_ms, peak_bytes=run["peak_bytes"],
               launches=run["launches"], eager_launches=eager["launches"],
               per_step=per_step, prompts=prompts)
    if reference:
        out["reference"] = {k: run[k] for k in ("out", "logits", "live",
                                                "stats")}
    return out


def depth_launches(depth: dict, kernel: str) -> dict:
    """A kernel's launches in 20(b)'s run at 48 layers, for the kernels
    line: the compiled engine's counters hold its warm-up and capture."""
    run = depth["resident"]
    return dict(launches=run["launches"][kernel],
                per_step=run["per_step"][kernel], steps=run["steps"],
                at="20(b): qwen3-moe-30b-a3b, 48 of 48 layers, compiled; "
                   "the counters are the warm-up's and the capture's (2 x "
                   "per_step)")


def phase_moe_depth(torch) -> dict:
    """Phase 20: (a) the four torch examples, started beside (b)'s build;
    (b) qwen3-moe-30b-a3b at all 48 layers through build_engine, resident,
    compiled and then eager. The streamed half at 48 layers is
    ``scripts/moe_full_depth.py``'s (the host store's programming alone
    takes about 100 s)."""
    started = start_examples()
    built = moe_depth_build(torch)
    examples = finish_examples(started)
    resident = moe_depth_serve(torch, built)
    return dict(examples={k: v["seconds"] for k, v in examples.items()},
                resident=resident)


class PhaseClock:
    """The wall seconds of each phase, from its heading to the next one's
    (the ``phase_seconds`` JSON line): the script must end well inside its
    time limit on a slow host too."""

    def __init__(self):
        self.seconds, self.name, self.t = {}, None, time.perf_counter()

    def start(self, name: str, heading: str) -> None:
        self.stop()
        log(heading)
        self.name, self.t = name, time.perf_counter()

    def stop(self) -> None:
        if self.name is not None:
            self.seconds[self.name] = round(time.perf_counter() - self.t, 1)
        self.name = None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    clock = PhaseClock()
    clock.start("1", "phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    mma_res = {n: mma_resources(build, n) for n in ("ecdp", "paged_ecdp")}
    pa_inst = paged_resources(build)
    da_inst = decode_resources(build)
    for r in pa_inst:
        log(f"  paged_attn {r['kernel']} "
            + (f"Dh={r['dh']} k16_tiles={r['k16_tiles']}: "
               if r["kernel"] == "split" else ": ")
            + f"{r['registers']} registers, {r['smem']} B smem, spills "
              f"{r['spill_stores']}/{r['spill_loads']} B")
    if len(pa_inst) != 11 or any(r["spill_stores"] or r["spill_loads"]
                                 for r in pa_inst):
        raise AssertionError(f"paged_attn instances in the build log: "
                             f"{pa_inst} (want 10 split + merge, no spills)")
    for r in da_inst:
        log(f"  decode_attn {r['kernel']} "
            + (f"Dh={r['dh']}: " if r["kernel"] == "mma" else
               f"{r['dtype']}: " if r["kernel"] == "cuda_core" else ": ")
            + f"{r['registers']} registers, {r['smem']} B smem, spills "
              f"{r['spill_stores']}/{r['spill_loads']} B")
    if len(da_inst) != 7 or any(r["spill_stores"] or r["spill_loads"]
                                for r in da_inst):
        raise AssertionError(f"decode_attn instances in the build log: "
                             f"{da_inst} (want 4 tensor-core, 2 CUDA-core "
                             "and the merge, no spills)")
    for n, rows in mma_res.items():
        if len(rows) != 6:
            raise AssertionError(f"{n}: {len(rows)} tensor-core instances "
                                 "in the build log, want 6")
        for r in rows:
            log(f"  {n} ecdp_mma_kernel m_tile={r['m_tile']} wide="
                f"{int(r['wide'])}: {r['registers']} registers, {r['smem']} B "
                f"smem, spills {r['spill_stores']}/{r['spill_loads']} B")
    ge_inst = grouped_resources(build)
    gp_inst = grouped_resources(build, "paged_ecdp")
    for lib, rows in (("grouped_ecdp", ge_inst), ("paged_ecdp", gp_inst)):
        if len(rows) != 4:
            raise AssertionError(f"{lib}: {len(rows)} grouped tensor-core "
                                 "instances in the build log, want 4")
        for r in rows:
            log(f"  {lib} grouped_ecdp_mma_kernel m_tile={r['m_tile']} "
                f"wide={int(r['wide'])}: {r['registers']} registers, "
                f"{r['smem']} B smem, spills {r['spill_stores']}/"
                f"{r['spill_loads']} B")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)

    clock.start("2", "phase 2: ECDP kernel vs plain")
    ecdp_res = phase_ecdp(torch, timer)
    clock.start("3", "phase 3: paged attention kernel vs plain")
    pa_res = phase_paged(torch, timer)
    torch.cuda.empty_cache()
    clock.start("4", "phase 4: serving OPT-6.7B")
    serve = phase_serving(torch, timer)
    del timer
    clock.start("5", "phase 5: engine parity, card vs CPU")
    phase_parity(torch)
    clock.start("6", "phase 6: paged ECDP kernel vs plain and vs ECDP")
    timer = Timer(torch)
    paged_res = phase_paged_ecdp(torch, timer)
    del timer
    torch.cuda.empty_cache()
    clock.start("7", "phase 7: streamed serving OPT-6.7B")
    streamed = phase_streamed(torch)
    clock.start("8", "phase 8: offline prefill / decode OPT-6.7B")
    timer = Timer(torch)
    da_res = phase_decode_attn(torch, timer)
    del timer
    torch.cuda.empty_cache()
    offline = phase_offline(torch)
    phase_offline_parity(torch)
    clock.start("9", "phase 9: serving front under NAND faults")
    t0 = time.perf_counter()
    phase_chaos(torch)
    phase_prefix(torch)
    log(f"  phase 9 in {time.perf_counter() - t0:.1f} s")
    clock.start("10", "phase 10: speculative serving")
    t0 = time.perf_counter()
    spec = phase_spec(torch)
    log(f"  phase 10 in {time.perf_counter() - t0:.1f} s")
    clock.start("11", "phase 11: the command line and granite-8b")
    t0 = time.perf_counter()
    granite = phase_granite(torch)
    log(f"  phase 11 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("12", "phase 12: MoE serving on the resident plane, "
                "qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    moe_res = phase_moe(torch)
    log(f"  phase 12 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("13", "phase 13: the streamed MoE plane, qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    ms_res = phase_moe_stream(torch, moe_res["full"].pop("reference"))
    log(f"  phase 13 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("14", "phase 14: the other families (rwkv6-3b, "
                "recurrentgemma-9b, seamless-m4t-medium) on the offline path")
    t0 = time.perf_counter()
    fam = phase_families(torch)
    log(f"  phase 14 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("15", "phase 15: training (granite-8b at full width; the "
                "entry point; card vs CPU)")
    t0 = time.perf_counter()
    train_res = phase_train(torch)
    log(f"  phase 15 in {time.perf_counter() - t0:.1f} s")
    clock.start("16", "phase 16: the cost tools (the dry-run of all 40 "
                "cells; 15(a)'s cell against 15(a); the production meshes)")
    dry_res = phase_dryrun(torch, train_res["full"])
    log(f"  phase 16 in {dry_res['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("17", "phase 17: tensor-parallel streamed serving OPT-6.7B "
                "(4 layers) at 1, 2 and 4 shards on one card")
    shard_res = phase_sharded(torch)
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("18", "phase 18: tensor-parallel streamed MoE, "
                "qwen3-moe-30b-a3b (4 layers) at 1, 2 and 3 shards on one "
                "card")
    shard_moe = phase_sharded_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("19", "phase 19: training over a (data, model) mesh, one "
                "rank: granite-8b at full width through train() against the "
                "plain step; the checkpoint across meshes")
    mesh_train = phase_mesh_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    clock.start("20", "phase 20: the four torch examples; qwen3-moe-30b-a3b "
                "at all 48 layers through build_engine, resident, compiled "
                "and eager")
    depth = phase_moe_depth(torch)
    clock.stop()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s; seconds "
        f"a phase: {clock.seconds}")
    print(json.dumps({"spec": spec}), flush=True)
    print(json.dumps({"moe_stream": dict(full=ms_res["full"],
                                         spec=ms_res["spec"])}), flush=True)
    print(json.dumps({"families": dict(full=fam["full"],
                                       parity=fam["parity"])}), flush=True)
    print(json.dumps({"train": train_res}), flush=True)
    mesh_res = dry_res.pop("mesh")
    print(json.dumps({"dryrun": dry_res}), flush=True)
    print(json.dumps({"dryrun_mesh": mesh_res}), flush=True)
    print(json.dumps({"sharded": shard_res}), flush=True)
    print(json.dumps({"sharded_moe": shard_moe}), flush=True)
    print(json.dumps({"mesh_train": mesh_train}), flush=True)
    print(json.dumps({"moe_depth": depth}), flush=True)
    print(json.dumps({"phase_seconds": clock.seconds}), flush=True)

    step = serve["ecdp_step"]
    kernels = [
        {"name": "ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ecdp.cu",
         "replaces": "src/repro/kernels/ecdp.py:72",
         "launches": serve["launches"]["ecdp"],
         "replayed_in_profile": serve["compiled"]["profile"]["records"][
             "ecdp"],
         "max_abs_err": ecdp_res["max_abs_err"], "ms": step["ms"],
         "kernel_ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": step["library_ms"],
         "at": "one OPT-6.7B serving step's 129 calls back to back: 32 x "
               "(wq, wo, w_up, w_down) at M=64, lm_head at M=4",
         "per_launch": ecdp_res["per_launch"],
         "at_granite": dict(granite["full"]["ecdp_step"],
                            launches=granite["full"]["launches"]["ecdp"],
                            per_step=granite["full"]["per_step"]["ecdp"],
                            max_abs_err=granite["kernels"]["ecdp"][
                                "max_abs_err"],
                            per_launch=granite["kernels"]["ecdp"][
                                "per_launch"]),
         "at_qwen3_moe": dict(moe_res["kernels"]["lm_head"],
                              launches=moe_res["full"]["launches"]["ecdp"],
                              per_step=moe_res["full"]["per_step"]["ecdp"],
                              at="lm_head alone (the MoE step's one ECDP "
                                 "call)"),
         "at_qwen3_moe_48": depth_launches(depth, "ecdp"),
         "at_families": {
             arch: dict(fam["ecdp"][arch],
                        launches=fam["full"][arch]["launches"]["ecdp"],
                        per_step=fam["full"][arch]["per_step"]["ecdp"],
                        at=f"14(b): {FAMILY_STEPS} eager decode steps at "
                           "full width, depth as FAMILY_DEPTH")
             for arch in FAMILY_ARCHS},
         "bf16_instances": mma_res["ecdp"]},
        {"name": "paged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:94",
         "launches": serve["launches"]["paged_attn"],
         "replayed_in_profile": serve["compiled"]["profile"]["records"][
             "paged_attn"],
         "max_abs_err": max(r["max_abs_err"] for r in pa_res.values()),
         "ms": pa_res["ragged"]["ms"], "kernel_ms": pa_res["ragged"]["ms"],
         "plain_ms": pa_res["ragged"]["plain_ms"],
         "bound_ms": pa_res["ragged"]["bound_ms"],
         "bound_by": pa_res["ragged"]["bound_by"],
         "library_ms": pa_res["ragged"]["library_ms"],
         "at": "B=4 KV=32 TR=16 Dh=128 block 16, ctx %s" % PAGED_CTX,
         "at_serving_ctx": pa_res["serving"],
         "at_dh80": pa_res["dh80"],
         "at_granite": dict(granite["kernels"]["paged_attn"],
                            launches=granite["full"]["launches"][
                                "paged_attn"]),
         "at_qwen3_moe": dict(moe_res["kernels"]["paged_attn"],
                              launches=moe_res["full"]["launches"][
                                  "paged_attn"]),
         "at_qwen3_moe_48": depth_launches(depth, "paged_attn"),
         "instances": pa_inst},
        {"name": "paged_ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_ecdp.cu",
         "replaces": "src/repro/kernels/paged_ffn.py:156",
         "launches": streamed["launches"]["paged_ecdp"],
         "max_abs_err": paged_res["max_abs_err"],
         "ms": paged_res["layer"]["ms"], "kernel_ms": paged_res["layer"]["ms"],
         "plain_ms": paged_res["layer"]["plain_ms"],
         "bound_ms": paged_res["layer"]["bound_ms"],
         "bound_by": paged_res["layer"]["bound_by"],
         "library_ms": paged_res["layer"]["library_ms"],
         "at": "one OPT-6.7B layer's 4 paged calls back to back at M=64: "
               "wq, wo (4096x4096), w_up (4096x16384), w_down (16384x4096)",
         "per_launch": paged_res["per_launch"],
         "sharded": dict(
             shard_res["ffn"],
             launches={k: r["launches"]["paged_ecdp"]
                       for k, r in shard_res["runs"].items()},
             per_step={k: r["paged_ecdp_per_step"]
                       for k, r in shard_res["runs"].items()},
             ms_per_step={k: r["ms_per_step"]
                          for k, r in shard_res["runs"].items()},
             at=f"17: OPT-6.7B width, {SHARD_LAYERS} layers, streamed at "
                f"1, 2, 4 shards over one card (L x (2 + 2S) a step); "
                f"max_abs_err / ms: 17(a), layer 0's FFN at S=4 against "
                f"the unsharded chain"),
         "bf16_instances": mma_res["paged_ecdp"]},
        {"name": "decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:79",
         "launches": offline["launches"]["decode_attn"],
         "replayed_in_profile": offline["compiled"]["profile"]["records"][
             "decode_attn"],
         "max_abs_err": da_res["max_abs_err"], "ms": da_res["ms"],
         "kernel_ms": da_res["ms"],
         "ms_with_grouping": da_res["ms_with_grouping"],
         "plain_ms": da_res["plain_ms"],
         "bound_ms": da_res["bound_ms"], "bound_by": da_res["bound_by"],
         "library_ms": da_res["library_ms"],
         "at": f"B={OFFLINE_B} S_max={OFFLINE_PAD} KV=32 rep=1 Dh=128 bf16, "
               f"lengths {DECODE_MAIN_LEN} (one layer of an OPT-6.7B decode "
               "step)",
         "at_long_ctx": da_res["at_long_ctx"],
         "at_qwen3_moe_offline": dict(
             launches=moe_res["offline"]["launches"]["decode_attn"],
             at="12(d): 1 layer, 8 decode steps (warm-up + capture + 8 "
                "eager bodies)"),
         "at_families": dict(
             fam["decode_attn"],
             launches={arch: fam["full"][arch]["launches"]["decode_attn"]
                       for arch in FAMILY_ARCHS},
             per_step={arch: fam["full"][arch]["per_step"]["decode_attn"]
                       for arch in FAMILY_ARCHS},
             at=f"14(b): {FAMILY_STEPS} eager decode steps at full width, "
                "depth as FAMILY_DEPTH"),
         "instances": da_inst},
        {"name": "grouped_ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_ecdp.cu",
         "replaces": "src/repro/kernels/ecdp.py:72",
         "launches": moe_res["full"]["launches"]["grouped_ecdp"],
         "replayed_in_profile": moe_res["full"]["profile"]["records"][
             "grouped_ecdp"],
         "max_abs_err": moe_res["kernels"]["grouped"]["max_abs_err"],
         "ms": moe_res["full"]["step"]["ms"],
         "kernel_ms": moe_res["full"]["step"]["ms"],
         "plain_ms": moe_res["full"]["step"]["plain_ms"],
         "bound_ms": moe_res["full"]["step"]["bound_ms"],
         "bound_by": moe_res["full"]["step"]["bound_by"],
         "library_ms": moe_res["full"]["step"]["library_ms"],
         "at": f"one {MOE_ARCH} serving step's {MOE_LAYERS * 3} grouped "
               f"calls back to back ({MOE_LAYERS} of 48 layers x (w_gate, "
               "w_up, w_down) over a real 64-token route at k=8, ECC off); "
               "the ECDP of the reference's expert banks "
               "(src/repro/models/moe.py:105, one product per expert over "
               "the dispatch buffer) with an expert axis",
         "with_lm_head_ms": moe_res["full"]["step"]["with_lm_head_ms"],
         "per_launch": moe_res["kernels"]["grouped"]["per_launch"],
         "capacity_layouts": moe_res["kernels"]["grouped"][
             "capacity_layouts"],
         "at_qwen3_moe_48": depth_launches(depth, "grouped_ecdp"),
         "routed_rows": moe_res["kernels"]["grouped"]["route"],
         "bf16_instances": ge_inst},
        {"name": "grouped_paged_ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_ecdp.cu",
         "replaces": "src/repro/kernels/paged_ffn.py:156",
         "launches": ms_res["full"]["launches"]["grouped_paged_ecdp"],
         "per_step": ms_res["full"]["per_step"]["grouped_paged_ecdp"],
         "max_abs_err": ms_res["kernels"]["max_abs_err"],
         "ms": ms_res["kernels"]["layer"]["ms"],
         "kernel_ms": ms_res["kernels"]["layer"]["ms"],
         "plain_ms": ms_res["kernels"]["layer"]["plain_ms"],
         "bound_ms": ms_res["kernels"]["layer"]["bound_ms"],
         "bound_by": ms_res["kernels"]["layer"]["bound_by"],
         "library_ms": ms_res["kernels"]["layer"]["library_ms"],
         "dense_grouped_ms": ms_res["kernels"]["layer"]["dense_grouped_ms"],
         "at": f"one {MOE_ARCH} layer's expert half, 3 launches back to "
               "back (w_gate, w_up 2048x768, w_down 768x2048) over a slab "
               "of pool pages (the routed experts of a real 64-lane route "
               "at k=8, ECC off); the paged ECDP with an expert axis, for "
               "the reference's per-expert paged ECDP over the slab "
               "(src/repro/models/moe.py:78)",
         "per_launch": ms_res["kernels"]["per_launch"],
         "routed_rows": ms_res["kernels"]["route"],
         "at_spec": dict(launches=ms_res["spec"]["launches"][
             "grouped_paged_ecdp"], at="13(c): 2 layers, streamed spec"),
         "sharded": dict(
             launches={s: r["launches"]["grouped_paged_ecdp"]
                       for s, r in shard_moe["runs"].items()},
             per_step={s: r["per_step"]["grouped_paged_ecdp"]
                       for s, r in shard_moe["runs"].items()},
             ms_per_step={s: r["ms_per_step"]
                          for s, r in shard_moe["runs"].items()},
             layer=shard_moe["ffn"],
             at=f"18: {MOE_ARCH} width, {SHARD_MOE_LAYERS} layers, "
                f"streamed at 1, 2, 3 shards over one card (L x 3 x S a "
                f"step); layer: 18(a), layer 0's expert FFN over a "
                f"{MOE_ROUTE_TOKENS}-lane route at S = 2, 3 (3 S launches "
                f"+ the f32 sum) against the unsharded chain, torch.bmm "
                f"over each shard's routed experts' slices"),
         "bf16_instances": gp_inst},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
