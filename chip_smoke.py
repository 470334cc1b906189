#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line; any failure exits non-zero at once. The
slices and the serve runs come before any phase that opens torch.profiler:

1. device    -- a CUDA device is required; prints nvidia-smi's name and power limit.
2. build     -- compiles the CUDA kernels from src/repro_torch/csrc with nvcc;
                registers and spills of every kernel, and the HGMMA (wgmma)
                instructions in the SASS (cuobjdump) of the bf16 flash and SSD
                kernels, which must be there.
3. slice     -- qwen3-0.6b at full width, 2 layers, fp32: the same weights on the
                CPU (plain versions) and on the card (kernels), B=2, prompt 128,
                4 decode steps; logits compared.
4. serve     -- full qwen3-0.6b (28 layers, bf16, seeded random weights): 8
                requests of 1000 prompt tokens, 32 greedy tokens each, through
                the port's prefill and decode steps. Launch counts are zeroed
                just before and read just after: 28 prefill-kernel and 28 x 31
                decode-kernel launches, no SSD launch.
5. slice_ssm -- mamba2-2.7b at full width, 2 layers, fp32, CPU against card:
                B=2, prompt 600 (3 chunks, the last ragged), 4 decode steps;
                logits at every step and the final decode state compared; 2
                SSD launches, both on the fp32 route.
6. serve_ssm -- full mamba2-2.7b (64 layers, bf16, seeded random weights), the
                same 8 x 1000 prompts and 32 greedy tokens: 64 SSD launches, all
                on the wgmma route, no attention-kernel launch.
6b. serve_hybrid -- full zamba2-7b (81 Mamba2 layers, the shared attention block
                after 13 of them, head_dim 112, bf16, random weights drawn on the
                card from a seed), the same requests: 13 flash launches on wgmma
                at head_dim 112, 13 x 31 decode launches, 81 SSD launches on
                wgmma; prefill and decode times beside their bounds. Freed after.
6c. slice_moe -- qwen2-moe-a2.7b at full width, 2 layers, fp32, CPU against card:
                prefill of 1 x 576 tokens, 8 decode steps, the loss of 1 x 577
                tokens with its balance term and every gradient, at 2e-4; first
                the routing of every MoE call (top_e and the capacity verdicts,
                exactly, and the smallest gap between a token's k-th and
                (k+1)-th gate probability) is compared and printed (a flip with
                its own gap, at once); the caches after the prefill and after the
                steps at 2e-4; 6 flash (the prefill's, the loss's forward and its
                recompute: remat_policy "full") and 16 decode launches.
6d. serve_moe -- full qwen2-moe-a2.7b (24 layers, 60 routed experts padded to
                64, top-4, the shared expert, MHA 16/16 at head_dim 128, bf16,
                random weights drawn on the card from a seed), the same
                requests served twice (the repeat must equal the warm-up, whose
                routing gives the share of prefill assignments that capacity
                dropped and the experts a decode step picks): 24 flash launches
                on wgmma, 24 x 31 decode launches, no SSD launch; prefill and
                decode times beside their bounds (prefill by routed assignments
                and by the reference's dispatch slots, decode with every expert
                read and with the experts picked), the calls' shapes recorded by
                wrapping ``ops``. Freed after.
6e. slice_vlm -- internvl2-26b at full width (48 q heads on 8 kv heads of 128:
                decode at 6 q heads per kv head), 2 layers, fp32, CPU against
                card, weights drawn on the card and copied to the CPU: one
                prompt of 16 tokens behind 1,024 patch embeddings (N(0, 1) from a
                seed), 8 decode steps; the logits of each, the caches after the
                prefill and after the steps, and the index (1,040 then 1,048) at
                2e-4; 2 flash and 16 decode launches.
6f. serve_vlm -- full internvl2-26b (48 layers, untied head, bf16, 19.9 B
                parameters drawn on the card from a seed): the same 8 x 1000
                prompts, each behind 1,024 patch embeddings drawn N(0, 1) in bf16
                from a seed, 32 greedy tokens (a cache of 2,056), served twice
                (the repeat must equal the warm-up): 48 flash launches on wgmma at
                q (8, 2024, 48, 128), k/v (8, 2024, 8, 128), 48 x 31 decode
                launches at q (8, 1, 48, 128), caches (8, 2056, 8, 128), no SSD
                launch (the calls' shapes recorded by wrapping ``ops``); prefill
                and decode times beside their bounds, peak device memory. Freed
                after.
6f2. slice_moe_30b -- qwen3-moe-30b-a3b at full width (128 experts of 768,
                top-8, 32 q heads on 4 kv heads of 128: both attention kernels at
                group 8), 2 layers, fp32, CPU against card, weights drawn on the
                card and copied: prefill of 2 x 256 tokens (16 groups of 32 at
                capacity 8), 8 decode steps; every MoE call's top-8 experts and
                capacity verdicts compared exactly first, then the logits of each
                step and the caches after the prefill and after the steps at
                2e-4; 2 flash and 16 decode launches.
6f3. serve_moe_30b -- full qwen3-moe-30b-a3b (48 layers, 30,532,646,912
                parameters, 61.1 GB of bf16 drawn on the card from a seed), as
                serve_moe: the same requests served twice, the repeat identical;
                48 flash launches on wgmma at q (8, 1000, 32, 128), k/v (8, 1000,
                4, 128), 48 x 31 decode launches at q (8, 1, 32, 128), caches (8,
                1032, 4, 128), no SSD launch; the dropped share, the distinct
                experts a decode layer, prefill and decode times beside their
                bounds and peak device memory. Freed after; one decode step's
                device time comes from a torch.profiler window over the model
                built again after every timed serve (11, ``trace``).
6f4. slice_nemotron -- nemotron-4-15b at full width (48 q heads on 8 kv heads
                of 128: both attention kernels at group 6; the squared-ReLU MLP of
                24,576; the untied head of 256,000), 2 layers, fp32, CPU against
                card, weights drawn on the card and copied: prefill of 2 x 256
                tokens, 8 decode steps; the logits of each, the caches after the
                prefill and after the steps and the index at 2e-4, the greedy
                flips counted; 2 flash and 16 decode launches (``phase_slice_dense``).
6f5. serve_nemotron -- full nemotron-4-15b (32 layers, 15,628,376,064
                parameters, 31.3 GB of bf16 drawn on the card from a seed): the
                same requests served twice, the repeat identical; 32 flash
                launches on wgmma at q (8, 1000, 48, 128), k/v (8, 1000, 8, 128),
                32 x 31 = 992 decode launches at q (8, 1, 48, 128), caches (8,
                1032, 8, 128), no SSD launch; prefill and decode times beside
                their bounds and the serve's own peak device memory. Freed after
                (``phase_serve_dense``, as the two serves below).
6f6. serve_deepseek -- deepseek-67b at full width (d_model 8192, 64 q heads on 8
                kv heads of 128: both attention kernels at group 8; SwiGLU
                22,016; the untied head of 102,400) cut to 16 of 95 layers
                (12,750,954,496 parameters, 25.5 GB of bf16 drawn on the card; the
                95 layers' 134.9 GB do not fit it), as serve_nemotron: 16 flash
                launches on wgmma at q (8, 1000, 64, 128), k/v (8, 1000, 8, 128),
                16 x 31 = 496 decode launches at q (8, 1, 64, 128), caches (8,
                1032, 8, 128), no SSD launch. Freed after.
6f7. slice_gpt2 -- gpt2-2.7b (the paper's Table 4 GPT-2 2.7B: MHA 32/32 at
                head_dim 80, gelu 10,240, the untied head of 50,432) at full
                width cut to 2 layers, fp32, CPU against card, as slice_nemotron
                (the caches after the prefill and after every step); then the loss
                of 2 x 257 tokens and every gradient at 2e-4, the attention under
                FlashAttention on the fp32 route at hd 80 (4 launches: the forward
                and the recompute).
6f8. serve_gpt2 -- full gpt2-2.7b (32 layers, 2,774,960,640 parameters, 5.55
                GB of bf16 drawn on the card), as serve_nemotron: 32 flash
                launches on wgmma at q/k/v (8, 1000, 32, 80), 32 x 31 = 992 decode
                launches at q (8, 1, 32, 80), caches (8, 1032, 32, 80), no SSD
                launch. Freed after.
6f9. dryrun -- the port's dry-run (repro_torch.launch.dryrun.run_cell, fake
                tensors on a (1, 1) mesh, in a process started after the build
                and running beside the card's phases): nemotron-4-15b's prefill
                and decode cells at serve_nemotron's shape, deepseek-67b's decode
                at the same shape, deepseek-67b cut to serve_deepseek's 16
                layers, its prefill and decode. Fails unless the fit verdicts
                agree with the card (nemotron and the cut deepseek fit: they
                ran; deepseek-67b's 134.9 GB do not) and, for both that ran,
                predicted / measured peak lies in DRYRUN["peak_band"]
                ([0.95, 1.25]); prints the predicted against the measured
                peaks and the analysis FLOPs of the prefill against the bound
                helper's count.
6g. slice_encdec -- whisper-small at full width (d_model 768, 12 heads of 64,
                gelu 3,072, the tied head of 51,968), cut to 2 encoder and 2
                decoder layers, fp32, CPU against card, weights drawn on the card
                and copied to the CPU, 2 clips of 1,500 frames (N(0, 1) from a
                seed): prefill of a 16-token prompt, 8 decode steps, the logits of
                each, the self and cross caches after the prefill and after the
                steps and the index (16 then 24); then the loss of 2 x 33 tokens
                and every gradient, at 2e-4. Launches exactly: the serve part 6
                flash (2 encoder, 2 causal self, 2 cross) and 32 decode (2 layers
                x 2 attentions x 8 steps), the loss 12 flash (its forward and the
                recompute), the CPU none.
6h. serve_encdec -- full whisper-small (12 encoder and 12 decoder layers, bf16,
                238,139,904 parameters drawn on the card from a seed): 8 clips of
                1,500 frame embeddings (N(0, 1) in bf16 from a seed), a 16-token
                prompt, 32 greedy tokens, served twice (the repeat must equal the
                warm-up): 36 flash launches on wgmma (12 non-causal at q/k/v (8,
                1500, 12, 64), 12 causal at (8, 16, 12, 64), 12 non-causal at q (8,
                16, 12, 64) against k/v (8, 1500, 12, 64)), 744 decode launches
                (372 against the self cache (8, 48, 12, 64) at cur_len 17..47, 372
                against the cross cache (8, 1500, 12, 64) at cur_len 1,500), no SSD
                launch, the calls recorded by wrapping ``ops``; prefill and decode
                times beside their own bounds (``encdec_serve_bounds``: the
                encoder's full-square attention, cross_kv, both caches), peak
                device memory. Freed after.
7. train_grad -- the flash kernel under autograd (FlashAttention) against the
                plain blockwise_attention under autograd: output, dq, dk, dv at
                the training shape (bf16, B=8, S=1024, H=16, K=8, hd=128), at
                a small fp32 shape and at the scenario corpus's fp32 shapes
                (B=8 and 16, S=16, H=4, K=2, hd=16) and at gpt2-2.7b's
                training shape (bf16, 8 x 1024, 32 heads of 80). Then DecoderLM.loss of qwen3-0.6b at full
                width, 2 layers, fp32: loss, every gradient and one AdamW step
                on the card against the same port on the CPU from the same
                weights; every attention projection's gradient finite and not 0.
                The SSD under autograd (SSD: kernel forward, ssd_chunked recompute
                backward) against autograd through ssd_chunked, bf16 and fp32: y,
                the final state and the gradients of x, dt, a, B and C. The smoke
                zamba2-7b at head_dim 112, 2 layers, fp32: loss and every gradient
                (the shared block's included) card vs CPU.
7b. train_mesh -- the sharded multi-rank train step (train.step.build_train_step)
                as four gloo ranks sharing the card, each a spawned process
                (file:// rendezvous in a temporary directory), all exited before
                the next phase. (a) qwen3-0.6b at full width cut to 4 of 28
                layers, bf16, FSDP and the instant backup, 8 x 1024 tokens a step (2 x 1024 a rank), 2 steps: each
                rank's backup bit for bit its predecessor's new optimizer blocks,
                the bytes the ring sent equal to the razor's unique bytes per
                rank, the neighbour drill (after step 1 rank 1's optimizer blocks
                are dropped and rebuilt from rank 2's backup; step 2 from there
                equals the uninterrupted step 2 bit for bit on every rank), flash
                launches in every rank (all wgmma; counts zeroed in each rank just
                before its steps) and none of decode or SSD, and the first batch
                scored again lower. Prints per step the median over ranks of the
                step time and of its gradient reduce, param gathers and
                neighbor_backup, the device memory per rank (and one step with
                fsdp_params=False beside it) and each child's peak host RSS, all
                labelled as gloo through the host on one shared card. (b) Full
                width cut to 2 layers, fp32, 2 steps: the 4-rank step against
                one rank of the same step over NCCL from the same weights and
                batches (one process that saves its loss, master, m and v after
                each step; it runs train_mesh's, train_gemma_mesh's and
                train_moe_mesh's in turn beside the ranks, internvl2-26b's runs
                beside the light phases before this one; the five train phases
                share one set of four ranks: ``phase_train_group``): each rank's
                blocks against
                the one rank's, the losses and the master of step 1 (lr 0 under
                the warmup) within 1e-5 relative, m (0.1 of the gradient) of
                every step within the slice's 2e-4, each against its leaf's
                largest magnitude; v and step 2's master are reported.
7c. train_tp -- the tensor-parallel step (train.step.build_train_step on a
                (data 2, model 2) mesh: the Megatron split of the layer bodies,
                the vocab-parallel embedding and cross-entropy, and the residual
                stream split by sequence over "model": a layer body's input is
                the rank's (4, 512, 1024) block of positions, each split
                sub-layer entered by an all-gather and left by a reduce-scatter)
                as four gloo ranks sharing the card, as train_mesh. (a) qwen3-0.6b
                at full width cut to 4 of 28 layers, bf16, FSDP and the instant backup, 8 x 1024 tokens a
                step (4 x 1024 a data rank), 2 steps: on every rank and step the
                collectives over "model" the mesh counted equal
                train.step.model_collectives in calls and bytes (at 28 layers 315
                calls: 170 all-gathers, 142 reduce-scatters, 3 all-reduces), the residual
                stream entering every layer body the rank's block of positions,
                2 x 4 x 2 flash launches all on wgmma at q (4, 1024, 8, 128) (the
                rank's 8 of 16 heads, every position) and none of decode or SSD, finite
                losses, the first step's loss and global gradient norm within
                bf16 tolerances (TP_VS_MESH) of train_mesh (a)'s on (4, 1) from
                the same weights and batches, and the ring's bytes equal to the
                rank's blocks of the razor-unique leaves (a model group's sum
                the razor's per-device bytes plus the unique leaves that
                "model" does not split, once more). Prints per step the median
                over ranks of the step time and its parts (tp_reduce among
                them: every collective over "model"), the global gradient norm,
                device memory and every rank's host RSS, beside what the phase
                recorded without sequence parallelism (``BEFORE_SP``). (b) Full
                width cut to 2 layers, fp32, 2 steps on (2, 2) against one NCCL
                rank, held as train_mesh's (b): the sequence split there too.
7d. train_moe_mesh -- the MoE in the sharded step: qwen2-moe-a2.7b at full width
                (64 padded experts, top-4, the shared expert, MHA 16/16 at head_dim
                128) cut to 2 layers, weights drawn on the card from a seed, on a
                (data 2, model 2) mesh of four gloo ranks sharing the card: each
                rank holds 32 experts and routes its 4 x 1024 tokens as 8 whole
                groups of the global batch's 16, at its capacity; the residual
                stream split by sequence over "model", the MoE layer routing the
                gathered positions. (a) bf16, FSDP
                and the instant backup, 8 x 1024 tokens a step, 2 steps: the
                collectives over "model" equal model_collectives on every rank and
                step, 2 x 2 x 2 flash launches a rank on wgmma at q (4, 1024, 8,
                128), no decode or SSD launch, finite losses, dropped assignments
                on every rank, the ring's bytes the rank's unique blocks. Prints
                the step time and its parts (tp_reduce among them), the dropped
                assignments, device memory and host RSS a rank. (b) fp32, 2 steps
                of 2 microbatches (a rank's block of each global microbatch, 16
                groups of 256 tokens, 8 a data rank), against one NCCL rank of the
                same step on the global batch (run before, in its own process; the
                backup off): the losses within 1e-5, m within 2e-4 of each leaf's
                largest value (each rank's blocks against the one rank's, read
                from its saved m), every MoE call's top-k experts, positions and
                capacity verdicts equal, with the flips and the smallest gate gap
                printed, and rank 0's 16 flash launches on the fp32 route. Groups
                that straddle batch ranks (ROADMAP item 9g) are held on the CPU
                only (tests/test_torch_moe_step.py): the card's batches route 16
                groups, which divide over 2 batch ranks.
7f. train_gemma_mesh -- q heads split over "model" beside a replicated kv head:
                gemma-2b at full width (d_model 2048, 8 q heads and 1 kv head of
                256, GeGLU d_ff 16384, 256,000 tied vocabulary), weights drawn on
                the card from a seed, four gloo ranks sharing the card. (a) (data
                2, model 2), bf16, FSDP and the instant backup, 8 x 1024 tokens a
                step, 2 steps, cut to 2 of 18 layers (param_count printed): as
                train_tp (the sequence split), the collectives over "model" equal
                model_collectives on every rank and step, 8 flash launches a rank on wgmma at q (4,
                1024, 4, 256) and k/v (4, 1024, 1, 256), the ring's bytes the
                rank's unique blocks; the step's parts, device memory and host RSS
                a rank. (b) cut to 2 layers, fp32, 2 steps on (pod 2, data 1,
                model 2) with int8 cross-pod compression, against one NCCL rank's
                uncompressed step: the losses within 1e-5, every element of m of
                both steps within 2e-4 of its leaf's largest value plus the error
                the int8 rounding makes of it (each rank derives it from the
                whole leaves' scales, recorded from the compressed mean's inputs,
                and the two runs' clip factors: (1 - b1) c s / 4 a step and b1
                times the last step's), rank 0's 8 flash launches on the fp32
                route at hd 256. The compressed step against JAX's, where the
                scale of a split leaf is the whole leaf's, is held on the CPU
                (tests/test_torch_mesh_step.py): against the exact step a scale
                over fewer blocks is only closer.
7g. serve_mesh -- the serve steps on a mesh (train.serve.build_prefill_step /
                build_decode_step with a mesh): gemma-2b, whose one kv head
                cannot split, its KV cache split by sequence over "model", four
                gloo ranks sharing the card on (data 2, model 2), weights drawn on
                the card from a seed, spawned once for both parts. (a) Full width
                and depth (18 layers, bf16): 8 prompts of 1,000 tokens and 32
                greedy tokens (a rank's 4 rows and 516 of the 1,032 cache
                positions), after a 2-token warm-up; with the counts zeroed just
                before, on every rank 18 flash launches on wgmma at q (4, 1000, 4,
                256), k/v (4, 1000, 1, 256), 18 x 31 = 558 decode launches in the
                block form at q (4, 1, 8, 256), cache (4, 516, 1, 256), no SSD
                launch, and the collectives of the prefill and of every decode
                step equal to train.serve.serve_collectives; prints prefill ms,
                decode ms a step, collectives and bytes a step, device memory
                and host RSS a rank. (b) 2 layers, fp32, 8 decode steps, against
                one unsharded rank (DecoderLM.prefill and decode_step, its own
                process over NCCL, beside the ranks): the logits of the prefill and of
                every step at 2e-4, the greedy tokens exactly, each cache block
                against its slice of the one rank's cache.
7h. train_vlm_mesh -- the VLM in the sharded step: internvl2-26b at full width
                (d_model 6144, 48 q heads on 8 kv heads of 128, SwiGLU 16,384, the
                untied head of 92,672), weights and patch embeddings (N(0, 1) in
                the model's dtype) drawn on the card from a seed, four gloo ranks
                sharing the card on (data 2, model 2); each row 1,024 patches in
                front of 1,024 tokens, 2,048 positions split by sequence over
                "model" (rank 0's block all patches, the embedding's reduce-scatter
                of the whole sequence). (a) cut to 2 of 48 layers, bf16, FSDP and
                the instant backup, 8 rows a step, 2 steps, held as train_tp's
                (a): the collectives over "model" equal model_collectives at 2,048
                positions on every rank and step, the residual stream (4, 1024,
                6144) entering every layer body, 2 x 2 x 2 flash launches a rank on
                wgmma at q (4, 2048, 24, 128), k/v (4, 2048, 4, 128), no decode or
                SSD launch, the ring's bytes the rank's unique blocks. (b) cut to
                1 layer, fp32, 4 rows, 2 steps of 2 microbatches (a rank's block of
                each microbatch's patch rows), the backup off, against one NCCL
                rank of the same step: the losses within 1e-5, m within 2e-4 of
                each leaf's largest value, rank 0's 8 flash launches on fp32.
7i. serve_vlm_mesh -- serve_mesh's parts for internvl2-26b on (data 2, model 2):
                its kv heads split over "model", the cache by sequence. (a) full
                width cut to 12 of 48 layers, bf16 (the ranks draw the whole cut
                model in turn, keep their blocks and free it): 8 prompts of 1,000
                tokens behind 1,024 patches (N(0, 1) in bf16 from a seed), 32
                greedy tokens, a cache of 2,056 (a rank's 1,028: rank 0's all
                patches); on every rank 12 flash launches on wgmma at q (4, 2024,
                24, 128), k/v (4, 2024, 4, 128), 12 x 31 decode launches in the
                block form at q (4, 1, 48, 128), cache (4, 1028, 8, 128), the
                collectives of the prefill and every step equal to
                serve_collectives. (b) 2 layers, fp32, against one unsharded NCCL
                rank: logits 2e-4, tokens exact, cache blocks 2e-4.
7j. train_encdec_mesh, serve_encdec_mesh -- the enc-dec on (data 2, model 2):
                whisper-small at full width and depth (12 + 12 layers), weights and
                frame embeddings (N(0, 1) in the model's dtype) drawn on the card
                from a seed, every sub-layer a Megatron region and the residual
                streams whole over "model" (the reference's enc-dec bodies
                constrain none). Train (a): bf16, FSDP and the instant backup, 8
                rows a step of 1,500 frames and 448 + 1 tokens, 2 steps: the
                collectives over "model" (161 all-reduces a rank-step, nothing
                else) equal model_collectives on every rank and step, the streams
                entering the encoder and decoder bodies (4, 1500, 768) and (4,
                448, 768), 144 flash launches a rank on wgmma (the encoder's at
                q/k/v (4, 1500, 6, 64), the decoder's at (4, 448, 6, 64), the
                cross-attention's at q (4, 448, 6, 64) against (4, 1500, 6, 64)),
                no decode or SSD launch, the ring's bytes the rank's unique
                blocks. (b) 2 + 2 layers fp32 against one NCCL rank, as the
                others. Serve (a): serve_encdec's request set, a rank's 4 rows,
                24 of the 48 self and 750 of the 1,500 cross positions: 36 flash
                launches on wgmma, decode's block form once a layer and step on
                the cross block at cur_len 750 and on the self block where it
                holds a position (744 a rank at "model" index 0, 648 at index
                1), the collectives of the prefill and every step equal to
                serve_collectives, times beside encdec_serve_bounds. (b) 2 + 2
                layers fp32, a self cache of 24, against one unsharded rank.
                serve_mesh, serve_vlm_mesh and these run as one set of four
                ranks (``phase_mesh_group``, the mesh_group line) beside one NCCL
                process that runs their (b) references meanwhile.
7e. pipeline -- the GPipe forward (parallel.pipeline.pipeline_forward) over a
                ("pipe",) mesh of four gloo ranks sharing the card, spawned once
                for both parts: full qwen3-0.6b (28 layers, 7 a stage), bf16, 8
                microbatches of 1 x 1024 tokens through Block.apply_layer (a
                stage holds its own layers; rank 0 also the whole model), against
                the loop over the 28 layers on the whole batch on rank 0; then 8
                layers (2 a stage) in fp32 at 1e-5. 11 ring exchanges and one
                broadcast a stage (counted by the mesh), 7 x 8 flash launches a
                stage on wgmma (2 x 8 on fp32); prints each stage's wall time,
                the loop's, the ticks and bubble_fraction(4, 8) = 3/11.
8. scenarios -- the port's adversarial scenario fleet (runtime/scenarios.py).
                First all 15 corpus scenarios at the reference's scale (qwen3
                reduced, fp32, seq 16), each built and replayed as run_scenario
                does, on the card and again on the CPU: the two verdicts must be
                equal field for field and every step's loss equal within the
                fp32 slice tolerance, with the counts zeroed just before the
                card runs every flash launch on the fp32 route and no decode or
                SSD launch. Then the events of
                clean_software_failure (a software failure of worker 1 before
                step 5, 10 steps) replayed by the port's _Runner on qwen3-0.6b
                at full width cut to 2 of 28 layers (bf16, dp=4 simulated
                workers, 8 x 1024 tokens a step) with the scenario's fabric and
                reliability values: 10 steps, one recovery from the neighbour, 0
                rollbacks, 1 detection within one heartbeat of the analytic
                bound, finite losses, 2 x 2 x 10 flash launches (the forward and
                the recompute) all on wgmma. Prints the verdict
                beside the fields in which it differs from the reference-scale
                pin, the step split, tokens/s (by the median step and by the
                replay's whole window), the steps and host RSS before and after
                the recovery, recover()'s wall time beside its
                simulated time, peak memory and host RSS, and this run's FCR
                beside the measured host checkpoint share of the step.
8b. train_ssm -- mamba2-2.7b at full width cut to 2 of 64 layers, bf16, trained
                by SimCluster as train below (dp=4, 8 x 1024 tokens, 2 steps, a
                failure of worker 2, recover(), 1 step): a neighbour recovery,
                0 rollbacks, the opt vector bitwise equal across recover(), 2 x 2
                SSD launches a step (the forward and the recompute) all on wgmma,
                finite losses, and the first
                step's batch scoring lower after the run; the step split, tokens/s
                and bound as train. Placed after the replay's heap trim and before
                the first profiler session; trims the heap again after.
9. train     -- the slice: qwen3-0.6b at full width cut to 4 of 28 layers
                (bf16; the host checkpoint sets a step's time) trained by the
                port's SimCluster, dp=4 simulated workers on the one card, 8 x
                1024 tokens a step: 2 steps, a software failure of worker 2,
                recover() with the stream policy, 1 more step. Requires recovery
                from the neighbour with no rollback, the optimizer vector after
                recovery bitwise equal to a host copy taken before the failure,
                finite losses, and, with the counts zeroed just before, 2 x 4 x 3
                flash launches (all wgmma: every layer body recomputed in the
                backward under the config's remat_policy "full") and no decode or
                SSD launch. Prints
                the step split (device by CUDA events, host checkpoint by the
                host clock), tokens/s, the step's bound, peak device memory, peak
                host RSS and recover()'s wall time beside its simulated time;
                then a forward and backward of the same config on a batch of the
                step's shape, without recompute and with it (``remat_compare``:
                device ms by CUDA events, peak device memory above the model), and
                one more device step under torch.profiler (the script's first
                profiler session): busy share and the largest kernels.
9b. train_gpt2 -- gpt2-2.7b at full width cut to 2 of 32 layers, bf16, trained
                as train (dp=4, 8 x 1024 tokens, 2 steps, a failure of worker 2,
                recover(), 1 step): a neighbour recovery with no rollback, the opt
                vector bitwise equal across recover(), finite losses, 2 x 2 x 3
                flash launches all on wgmma at q/k/v (8, 1024, 32, 80) (recorded
                by wrapping ``ops``), none of decode or SSD; the step split,
                tokens/s and bound as train.
10. kernels  -- each kernel against its plain PyTorch version on the card at the
                serve shapes, zamba2-7b's at head_dim 112 too (prefill B=8,
                S=1000, H=K=32; decode T=1032, cur_len 1032; its SSD, 112 heads,
                N 64, bf16), qwen2-moe-a2.7b's in bf16 (prefill B=8, S=1000,
                H=K=16, hd 128; decode T=1032, cur_len 1032) (prefill B=8, S=1000, H=16, K=8, hd=128, causal, with
                the wrapper's route: wgmma for bf16, fp32 for fp32; bf16 also at
                the training step's S=1024; decode B=8,
                T=1032, cur_len 1 / 129 / 777 / 1032 with the planned n_split;
                SSD B=8, S=1000 (ragged last chunk) and 1024, H=80, P=64, N=128,
                chunk 256: the full ops.ssd against ssd_chunked, bf16 on the
                wgmma route, once more with an initial state, and fp32, whose
                intra-chunk kernel is also held to its three outputs; flash at
                a rank's tensor-parallel shape, q (4, 1024, 8, 128), k/v (4,
                1024, 4, 128), in both dtypes, and in bf16 at a rank's of
                train_moe_mesh, q/k/v (4, 1024, 8, 128), and a pipeline stage's,
                q (1, 1024, 16, 128), k/v (1, 1024, 8, 128); flash at head_dim 256
                in both dtypes, at a rank's of train_gemma_mesh, q (4, 1024, 4,
                256), k/v (4, 1024, 1, 256), and at a serve-like q (8, 1000, 8,
                256), k/v (8, 1000, 1, 256); decode at head_dim 256 in both
                dtypes, in the block form (o fp32, lse) at a rank's of
                serve_mesh, q (4, 1, 8, 256), cache (4, 516, 1, 256), and at the
                serve shape, q (8, 1, 8, 256), caches (8, 1032, 1, 256); flash at
                internvl2-26b's q (8, 2024, 48, 128), k/v (8, 2024, 8, 128) and
                decode at its q (8, 1, 48, 128), caches (8, 2056, 8, 128), cur_len
                2,056, both forms, each in both dtypes; flash at whisper-small's
                head_dim 64, non-causal at q/k/v (8, 1500, 12, 64) and at q (8,
                16, 12, 64) against k/v (8, 1500, 12, 64), causal at q/k/v (8,
                16, 12, 64), and decode at q (8, 1, 12, 64) against its self
                cache (8, 48, 12, 64), cur_len 17 and 47, and its cross cache
                (8, 1500, 12, 64), cur_len 1,500, each in both dtypes; flash at a
                rank's of train_vlm_mesh, q (4, 2048, 24, 128), k/v (4, 2048, 4,
                128), and of serve_vlm_mesh's prefill, q (4, 2024, 24, 128), k/v
                (4, 2024, 4, 128), and decode's block form at a rank's of
                serve_vlm_mesh, q (4,
                1, 48, 128), cache block (4, 1028, 8, 128), cur_len 996 and 1,028,
                each in both dtypes; flash at a rank's of train_encdec_mesh, the
                encoder's q/k/v (4, 1500, 6, 64) and the cross-attention's q (4,
                448, 6, 64) against k/v (4, 1500, 6, 64), non-causal, and
                decode's block form on a rank's block of serve_encdec_mesh's
                cross cache, q (4, 1, 12, 64), block (4, 750, 12, 64), cur_len
                750, each in both dtypes; flash at qwen3-moe-30b-a3b's q (8,
                1000, 32, 128), k/v (8, 1000, 4, 128) and decode at its q (8, 1,
                32, 128), caches (8, 1032, 4, 128), cur_len 1,032, each in both
                dtypes; flash at nemotron-4-15b's q (8, 1000, 48, 128), k/v (8,
                1000, 8, 128) and decode at its q (8, 1, 48, 128), caches (8,
                1032, 8, 128), cur_len 1,001 and 1,032, each in both dtypes;
                gpt2-2.7b's at head_dim 80: flash at q/k/v (8, 1000, 32, 80) in both
                dtypes and (8, 1024, 32, 80) in bf16, decode at q (8, 1, 32, 80),
                caches (8, 1032, 32, 80), cur_len 1, 129 and 1,032, both forms in
                both dtypes, and the block form on the cache's two halves merged
                against the whole cache; deepseek-67b's flash at q (8, 1000, 64,
                128), k/v (8, 1000, 8, 128) and decode at q (8, 1, 64, 128),
                caches (8, 1032, 8, 128), cur_len 1,001 and 1,032, each in both
                dtypes; the SSD
                at a rank's 40 (mamba2) and 56 (zamba2) heads, 4 x 1024, bf16),
                with the
                kernel's, the plain version's and (for attention) the library
                call's times
                (F.scaled_dot_product_attention, a yardstick only), the card's
                bound for the same work and the wrapper's host time per launch.
                Times are CUPTI device times from torch.profiler; where no
                profiler session sees device activity, CUDA events time the
                calls instead. Each kernel is also timed by events
                (``event_ms``), a check of that fallback.
11. trace    -- torch.profiler over one prefill and over 4 decode steps of each
                model: device busy share and the kernels that take the device time;
                qwen3-moe-30b-a3b built again for its window (prefill and 2
                decode steps: its decode step's device time, by kernel group).
12. serve    -- qwen3-0.6b served again, as in 4, now after the profiler
                sessions (``after_profiler``: true).

Then a ``timing`` line (kernel timings taken by CUPTI and by CUDA events, the
host seconds of each phase),
one {"kernels": [...]} line (each kernel's launches in every serve and training
phase, ``moe_launches``, ``train_tp_launches``, ``train_moe_mesh_launches``,
``train_gemma_mesh_launches``, ``serve_mesh_launches``, ``pipeline_launches``,
``vlm_launches``, ``encdec_launches``, ``vlm_mesh_launches``,
``encdec_mesh_launches``, ``moe_30b_launches``, ``nemotron_launches``,
``gpt2_launches`` and ``deepseek_launches`` among them, and its rows at the
other shapes, ``tp_shape`` / ``tp_shapes``, ``moe_mesh_shape``,
``pipeline_shape``, ``gemma_tp_shape``, ``hd256``, ``vlm_shape``,
``encdec_shape``, ``vlm_mesh_shape``, ``encdec_mesh_shape``,
``moe_30b_shape``, ``nemotron_shape``, ``hd80`` and ``deepseek_shape``
among them), the
card's name
and power
limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PREFILL = dict(b=8, s=1000, h=16, kh=8, hd=128)
DECODE = dict(b=8, t=1032, h=16, kh=8, hd=128, cur_lens=(1, 129, 777, 1032))
SSD = dict(b=8, h=80, p=64, n=128, chunk=256, seqs=(1000, 1024))
# zamba2-7b's serve shapes: MHA of 32 heads at head_dim 112 (the hd-128
# instantiations, zero-padded), and its SSD (112 heads, N 64)
PREFILL_HD112 = dict(b=8, s=1000, h=32, kh=32, hd=112)
DECODE_HD112 = dict(b=8, t=1032, h=32, kh=32, hd=112, cur_lens=(1032,))
SSD_HYBRID = dict(b=8, h=112, p=64, n=64, chunk=256, seqs=(1000,))
# qwen2-moe-a2.7b's serve shapes: MHA of 16 heads at head_dim 128 (group 1),
# bf16
PREFILL_MOE = dict(b=8, s=1000, h=16, kh=16, hd=128)
DECODE_MOE = dict(b=8, t=1032, h=16, kh=16, hd=128, cur_lens=(1032,))
# a rank's attention in the tensor-parallel step (train_tp): qwen3-0.6b's 16 q /
# 8 kv heads over model 2, 4 rows of 1024 (a data rank of 8)
PREFILL_TP = dict(b=4, s=1024, h=8, kh=4, hd=128)
# a rank's attention in the MoE's sharded step (train_moe_mesh): qwen2-moe's 16 /
# 16 heads over model 2, 4 rows of 1024; and a pipeline stage's (pipeline): qwen3's
# 16 q / 8 kv heads, one microbatch of 1 x 1024
PREFILL_MOE_TP = dict(b=4, s=1024, h=8, kh=8, hd=128)
PREFILL_PIPE = dict(b=1, s=1024, h=16, kh=8, hd=128)
# gemma-2b's MQA at head_dim 256 (the hd-256 instantiations): a rank's in
# train_gemma_mesh (its 4 of 8 q heads, the one kv head, 4 rows of 1024), and
# at the serve-like shape of 8 prompts of 1000 tokens
PREFILL_GEMMA_TP = dict(b=4, s=1024, h=4, kh=1, hd=256)
PREFILL_HD256 = dict(b=8, s=1000, h=8, kh=1, hd=256)
# a rank's SSD under tensor parallelism at model 2: mamba2-2.7b's 80 heads and
# zamba2-7b's 112, at the same rows
# decode at head_dim 256 (gemma-2b, 8 q heads on 1 kv head): a rank's block of
# serve_mesh (4 rows, 516 of the 1,032 positions) in the block form, and the
# one-card serve shape
DECODE_HD256_BLOCK = dict(b=4, t=516, h=8, kh=1, hd=256, cur_lens=(516,), partial=True)
DECODE_HD256 = dict(b=8, t=1032, h=8, kh=1, hd=256, cur_lens=(1032,))
# internvl2-26b's serve shapes: 48 q heads on 8 kv heads of 128 (group 6), 8
# prompts of 1,024 patch embeddings and 1,000 tokens (flash at S 2,024), a
# cache of 2,056 positions (decode in both forms at the full cache)
PREFILL_VLM = dict(b=8, s=2024, h=48, kh=8, hd=128)
DECODE_VLM = dict(b=8, t=2056, h=48, kh=8, hd=128, cur_lens=(2056,))
DECODE_VLM_BLOCK = dict(DECODE_VLM, partial=True)
# internvl2-26b on (data 2, model 2): a rank's attention in train_vlm_mesh (its
# 24 q and 4 kv heads, 4 rows of 1,024 patches + 1,024 tokens) and in
# serve_vlm_mesh's prefill (4 rows of 1,024 patches + 1,000 tokens: not a
# whole number of tiles), and decode's
# block form on a rank's 1,028 of serve_vlm_mesh's 2,056 cache positions with
# the q heads gathered, part-filled (rank 1 after the prefill) and full
PREFILL_VLM_TP = dict(b=4, s=2048, h=24, kh=4, hd=128)
PREFILL_VLM_SERVE_TP = dict(PREFILL_VLM_TP, s=2024)
DECODE_VLM_MESH_BLOCK = dict(b=4, t=1028, h=48, kh=8, hd=128, cur_lens=(996, 1028),
                             partial=True)
# whisper-small's serve shapes: MHA of 12 heads at head_dim 64; the encoder's
# non-causal self-attention over 8 clips of 1,500 frames, the decoder's causal
# self-attention over the 16-token prompt, its non-causal cross-attention of
# the prompt against the frames; decode against the self cache of 48
# positions (cur_len 17..47, the first and last step's) and against the
# 1,500-frame cross cache (cur_len fixed by the input)
PREFILL_ENCDEC_ENC = dict(b=8, s=1500, h=12, kh=12, hd=64, causal=False)
PREFILL_ENCDEC_SELF = dict(b=8, s=16, h=12, kh=12, hd=64)
PREFILL_ENCDEC_CROSS = dict(b=8, s=16, skv=1500, h=12, kh=12, hd=64, causal=False)
DECODE_ENCDEC_SELF = dict(b=8, t=48, h=12, kh=12, hd=64, cur_lens=(17, 47))
DECODE_ENCDEC_CROSS = dict(b=8, t=1500, h=12, kh=12, hd=64, cur_lens=(1500,))
# whisper-small on (data 2, model 2): a rank's attention in train_encdec_mesh
# (its 6 heads, 4 rows: the encoder's 1,500 frames, and the cross-attention
# of 448 tokens against them), and decode's block form on a rank's 750 of the
# 1,500-frame cross cache in serve_encdec_mesh, the q heads gathered, every
# position valid
PREFILL_ENCDEC_ENC_TP = dict(PREFILL_ENCDEC_ENC, b=4, h=6, kh=6)
PREFILL_ENCDEC_CROSS_TP = dict(PREFILL_ENCDEC_CROSS, b=4, s=448, h=6, kh=6)
DECODE_ENCDEC_MESH_BLOCK = dict(DECODE_ENCDEC_CROSS, b=4, t=750, cur_lens=(750,), partial=True)
# qwen3-moe-30b-a3b's serve shapes: 32 q heads on 4 kv heads of 128 (group 8),
# 8 prompts of 1,000 tokens (flash causal at S 1,000), a cache of 1,032
# positions (decode at the full cache)
PREFILL_MOE30 = dict(b=8, s=1000, h=32, kh=4, hd=128)
DECODE_MOE30 = dict(b=8, t=1032, h=32, kh=4, hd=128, cur_lens=(1032,))
# nemotron-4-15b's serve shapes: 48 q heads on 8 kv heads of 128 (group 6),
# 8 prompts of 1,000 tokens, a cache of 1,032 positions (decode at the first
# step's length and at the full cache)
PREFILL_NEMOTRON = dict(b=8, s=1000, h=48, kh=8, hd=128)
DECODE_NEMOTRON = dict(b=8, t=1032, h=48, kh=8, hd=128, cur_lens=(1001, 1032))
# gpt2-2.7b's shapes: MHA of 32 heads at head_dim 80 (the hd-128 tiles and
# lane mapping, columns 80-127 zero): the serve's prefill, the training
# step's, and decode against its 1,032-position cache at the first position,
# a split boundary and the full cache, in both forms (the block form's two
# halves also merged against the whole cache)
PREFILL_GPT2 = dict(b=8, s=1000, h=32, kh=32, hd=80)
PREFILL_GPT2_TRAIN = dict(PREFILL_GPT2, s=1024)
DECODE_GPT2 = dict(b=8, t=1032, h=32, kh=32, hd=80, cur_lens=(1, 129, 1032))
DECODE_GPT2_BLOCK = dict(DECODE_GPT2, partial=True)
# deepseek-67b's serve shapes: 64 q heads on 8 kv heads of 128 (group 8), 8
# prompts of 1,000 tokens, a cache of 1,032 (decode at the first step's
# length and the full cache)
PREFILL_DEEPSEEK = dict(b=8, s=1000, h=64, kh=8, hd=128)
DECODE_DEEPSEEK = dict(b=8, t=1032, h=64, kh=8, hd=128, cur_lens=(1001, 1032))
SSD_TP = dict(SSD, b=4, h=40, seqs=(1024,))
SSD_HYBRID_TP = dict(SSD_HYBRID, b=4, h=56, seqs=(1024,))
SERVE = dict(batch=8, prompt=1000, gen=32)
SSM_SLICE = dict(batch=2, prompt=600, steps=4)
# the SSD kernel's chunk states and decay against the plain version: the
# state tolerance of tests/test_kernels.py
STATE_TOL = 1e-3
# kernel against plain: the tolerances of tests/test_kernels.py
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the flash wrapper's route by dtype: bf16 on the tensor cores, fp32 on the
# CUDA cores
EXPECTED_ROUTE = {"bfloat16": "wgmma", "float32": "fp32"}
# whole slice, card against CPU, fp32: the tolerance of the reference's
# test_prefill_decode_matches_forward
SLICE_TOL = 2e-4
# the training slice: qwen3-0.6b at full width cut to 4 of 28 layers (the
# host checkpoint of a step, which sets its time, scales with the state: ~18 s
# a step at 28 layers, ~9 s at 8), dp=4 simulated workers, 8 x 1024 tokens a step, 2
# steps, a failure of worker 2, 1 more step; the step split is the median of
# the 2 steps after the first
TRAIN = dict(layers=4, dp=4, global_batch=8, seq_len=1024, steps_before=2, steps_after=1,
             failed=2)
# gpt2-2.7b trained as TRAIN, cut to 2 of its 32 layers (its fp32 optimizer
# state 4.99 GB, 1.9x that of qwen3's 4 layers)
GPT2_TRAIN = dict(TRAIN, layers=2)
# flash gradients, kernel under autograd against the plain version: bf16 at
# the training shape, fp32 (TF32 off) at a small one and at the scenario
# corpus's two shapes (the reduced qwen3-0.6b, global batch 8 and 16), bf16
# at gpt2-2.7b's training shape (head_dim 80)
GRAD = dict(bf16=dict(b=8, s=1024, h=16, kh=8, hd=128, tol=2e-2),
            fp32=dict(b=2, s=200, h=4, kh=2, hd=64, tol=1e-4),
            fp32_corpus_b8=dict(b=8, s=16, h=4, kh=2, hd=16, tol=1e-4),
            fp32_corpus_b16=dict(b=16, s=16, h=4, kh=2, hd=16, tol=1e-4),
            bf16_gpt2=dict(b=8, s=1024, h=32, kh=32, hd=80, tol=2e-2))
# DecoderLM.loss at full width, 2 layers, fp32, card against CPU: 1 x 576
# tokens (a 512-position xent chunk and a ragged one of 64)
LOSS = dict(batch=1, seq=576, tol=2e-4)
# the SSD under autograd (SSD.apply: kernel forward, plain recompute
# backward) against autograd through ssd_chunked, a small shape per route
SSD_GRAD = dict(bf16=dict(b=2, s=300, h=4, p=64, n=128, chunk=256, tol=2e-2),
                fp32=dict(b=2, s=200, h=4, p=64, n=64, chunk=64, tol=1e-4))
# the hybrid's loss and gradients, card against CPU: the smoke zamba2-7b at
# head_dim 112, 2 layers (one shared-block application), fp32
HYBRID_LOSS = dict(batch=2, seq=64, tol=2e-4)
# the MoE slice, card against CPU: qwen2-moe-a2.7b at full width cut to 2
# layers (a CPU copy of 24 fp32 layers would be 60 GB; 2 layers with the head
# and the embedding are 1.83 B parameters, 7.3 GB), fp32, the tokens of LOSS:
# prefill of 1 x 576, 8 decode steps, the loss of 1 x 577 and every gradient
MOE_SLICE = dict(arch="qwen2-moe-a2.7b", phase="slice_moe", layers=2, batch=LOSS["batch"],
                 seq=LOSS["seq"], steps=8, loss=True, tol=2e-4)
# the same for qwen3-moe-30b-a3b at full width cut to 2 layers (128 experts of
# 768, top-8, 32 q / 4 kv heads of 128, the untied head: 1,869,097,472
# parameters, 7.5 GB of fp32 a side), fp32: prefill of 2 x 256 tokens (16
# groups of 32 at capacity 8, where assignments drop), 8 decode steps, the
# caches after each; no loss (the serve path)
MOE_SLICE_30B = dict(MOE_SLICE, arch="qwen3-moe-30b-a3b", phase="slice_moe_30b", batch=2,
                     seq=256, loss=False)
# the VLM slice, card against CPU: internvl2-26b at full width cut to 2 layers
# (1,918,924,800 parameters, 7.7 GB of fp32 a side; 48 layers would be 79 GB
# on the CPU), fp32, one prompt of 16 tokens behind its 1,024 patch
# embeddings, 8 decode steps
VLM_SLICE = dict(layers=2, batch=1, prompt=16, steps=8, tol=SLICE_TOL)
# the dense slices, card against CPU, fp32, full width cut to 2 layers:
# prefill of 2 x 256 tokens, 8 decode steps. nemotron-4-15b (3,925,899,264
# parameters, 15.7 GB of fp32 a side: group 6); gpt2-2.7b (415,511,040, 1.66
# GB: head_dim 80 on both attention kernels), then its loss of 2 x 257 tokens
# and every gradient (FlashAttention on the fp32 route at hd 80)
NEMOTRON_SLICE = dict(arch="nemotron-4-15b", phase="slice_nemotron", layers=2, batch=2,
                      prompt=256, steps=8, loss=False, tol=SLICE_TOL)
GPT2_SLICE = dict(NEMOTRON_SLICE, arch="gpt2-2.7b", phase="slice_gpt2", loss=True)
# the dense serves (SERVE's requests, bf16, weights drawn on the card): each
# phase's config and the layers it keeps (None: all). deepseek-67b's 95
# layers are 134.9 GB of bf16, more than the card holds: 16 of them are
# 12,750,954,496 parameters, 25.5 GB, full width
DENSE_SERVES = {"serve_nemotron": ("nemotron-4-15b", None), "serve_gpt2": ("gpt2-2.7b", None),
                "serve_deepseek": ("deepseek-67b", 16)}
# the dry-run's prediction of one card's peak against serve_nemotron's
# measured one, as predicted / measured in [0.95, 1.25]: below by at most 5 %
# (the caching allocator rounds every block up to 512 bytes, and cuBLAS takes
# a workspace that the dry-run's plain forms do not), above by at most 25 %
# (the plain unembedding's fp32 copy of the head, 6.29 GB, reads 1.159; a
# count of every storage twice would read 2.32). deepseek-67b cut to
# serve_deepseek's depth is held to the same band; its 95 layers must not fit
DRYRUN = dict(arch="nemotron-4-15b", over="deepseek-67b", cut="serve_deepseek",
              peak_band=(0.95, 1.25))
# the enc-dec slice, card against CPU: whisper-small at full width cut to 2
# encoder and 2 decoder layers, fp32, 2 clips of 1,500 frames: prefill of a
# 16-token prompt, 8 decode steps, then the loss of 2 x 33 tokens and every
# gradient
ENCDEC_SLICE = dict(layers=2, batch=2, prompt=16, steps=8, loss_tokens=33, tol=SLICE_TOL)
# the enc-dec serve run: 8 clips of 1,500 frames, a 16-token prompt, 32 tokens
ENCDEC_SERVE = dict(batch=8, prompt=16, gen=32)
# the SSM training cell: mamba2-2.7b at full width cut to 2 of 64 layers (the
# host copies of the full 32.4 GB opt state would not fit the host, and the
# host checkpoint of a step scales with the state), dp=4
# simulated workers, 8 x 1024 tokens a step, 2 steps, a failure, 1 step (as
# train, for the script's time limit)
TRAIN_SSM = dict(layers=2, dp=4, global_batch=8, seq_len=1024, steps_before=2,
                 steps_after=1, failed=2)
L2_BYTES = 50 * 10**6
T_START = time.perf_counter()
PROFILER_SESSIONS = [0]     # torch.profiler sessions opened so far in this process
TIMING = {"cupti": 0, "cuda_events": 0}     # kernel timings taken by each method
PHASE_S: dict = {}          # host seconds of each phase, for the timing line


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host seconds added to ``PHASE_S[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
        print(f"chip_smoke: {name} {time.perf_counter() - t0:.1f} s, script "
              f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr, flush=True)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_events(torch, prof) -> list:
    """(name, microseconds) of every activity the device ran (kernels,
    copies, fills) in a torch.profiler trace, as CUPTI timed it."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
            if ev.device_type == cuda]


def profiled(torch, fn, tries: int = 2):
    """Run ``fn`` under torch.profiler and return the trace's device
    activities; a session that saw none (CUPTI now and then delivers no
    activity records) is opened again, up to ``tries`` sessions. An empty
    list means that every session saw none."""
    from torch.profiler import ProfilerActivity, profile
    events = []
    for _ in range(tries):
        torch.cuda.synchronize()
        PROFILER_SESSIONS[0] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(torch, prof)
        if events:
            break
        print("chip_smoke: a profiler session saw no device activity", file=sys.stderr,
              flush=True)
    return events


def event_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of one call by CUDA events around ``iters`` calls,
    for when the profiler sees no device activity. A spin kernel ahead of
    the calls keeps the device busy while the host enqueues them, so the
    calls run back to back and the host's launch cost stays out of the
    time; the spin is lengthened (at most twice) until the start event is
    still pending when the host has enqueued the last call. Where it never
    is, the time returned includes host gaps: an upper bound."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * host_s + 1e-3))       # >= 2x the host's time at up to 2 GHz
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
        overlapped = not start.query()
        end.synchronize()
        if overlapped:
            break
        cycles *= 4
    else:
        print("chip_smoke: event timing includes host gaps", file=sys.stderr, flush=True)
    return start.elapsed_time(end) / iters


def whole_calls(events: list, iters: int) -> bool:
    """Whether a trace of ``iters`` identical calls holds every call's
    activities: each activity name ``iters`` times, or a multiple of it. A
    session late in this script has been seen on an H100 to miss about 6
    activities of a window (every kernel row then read 0.70x its
    CUDA-event time over 20 calls)."""
    counts = collections.Counter(name for name, _ in events)
    return bool(counts) and all(n % iters == 0 for n in counts.values())


def time_ms(torch, fn, args_list, iters: int, events_ms: float | None = None) -> tuple:
    """Mean device time of one call and the method that took it: the summed
    durations of the device activities it launches, over ``iters`` calls
    that cycle through ``args_list`` (copies of the inputs, together larger
    than L2, so that each call reads its inputs from device memory), in one
    profiler session ("cupti"). Host time between launches is not counted.
    Where the session misses activities (``whole_calls``), CUDA events time
    the calls instead ("cuda_events"): ``events_ms`` where the caller took
    them already, else ``event_ms``. ``TIMING`` counts the timings taken
    each way."""
    fn(*args_list[0])

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    events = profiled(torch, run, tries=1)
    if whole_calls(events, iters):
        TIMING["cupti"] += 1
        return sum(us for _, us in events) / 1e3 / iters, "cupti"
    print(f"chip_smoke: a profiler session of {iters} calls saw {len(events)} device "
          "activities, not a whole number of calls", file=sys.stderr, flush=True)
    TIMING["cuda_events"] += 1
    if events_ms is None:
        events_ms = event_ms(torch, fn, args_list, iters)
    return events_ms, "cuda_events"


def host_us(torch, fn, args, iters: int = 200) -> float:
    """Host time to enqueue one call (checks, allocation, launch), by the
    host clock around ``iters`` calls, excluding the final synchronize."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def input_copies(tensors) -> list:
    """The inputs and enough clones of them to hold twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, math.ceil(2 * L2_BYTES / nbytes) + 1)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def check_close(name: str, out, ref, tol: float) -> float:
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff > tol + tol * ref.float().abs()).sum().item()
    if not math.isfinite(err) or bad:
        fail(f"{name}: {bad} elements beyond rtol=atol={tol}, max abs err {err}")
    return err


def demangle(names: list) -> list:
    """Short kernel names (``decode_split_kernel<__nv_bfloat16, 128, 2>``)
    by c++filt where the toolchain has it, else the mangled names."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    short = []
    for name, full in zip(names, out):
        m = re.search(r"(\w+_kernel(?:<[^>]*>)?)\(", full)
        short.append(m.group(1) if m else name)
    return short


def ptxas_summary(log: str) -> list:
    """Registers and spill bytes of every kernel in the library, from nvcc's
    ``-Xptxas -v`` output (kept beside the library by the build)."""
    rows = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers", log, re.S)
    names = demangle([name for name, _, _ in rows])
    return [dict(kernel=name, spill_store_bytes=int(sp), registers=int(r))
            for name, (_, sp, r) in zip(names, rows)]


def cuobjdump() -> str:
    """The toolkit's cuobjdump: beside the nvcc that builds the kernels,
    else the copy in Triton's package."""
    from repro_torch.kernels import _build
    path = Path(_build.nvcc()).parent / "cuobjdump"
    if path.exists():
        return str(path)
    try:
        import triton
    except ImportError:
        fail("cuobjdump not found beside nvcc and no triton package")
    path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if not path.exists():
        fail("cuobjdump not found beside nvcc nor in triton's package")
    return str(path)


# tensor-core kernels and their instantiations in the library
# instantiations of each: flash's head_dims 16, 32, 64, 80 and 112 (on the
# 128 tiles), 128, 256
WGMMA_KERNELS = {"flash_wgmma_kernel": 7, "ssd_wgmma_kernel": 7}


def sass_hgmma(library: Path) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each instantiation of the
    bf16 flash and SSD kernels; fails unless every one has some."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for kernel, instances in WGMMA_KERNELS.items():
        found = {}
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            if kernel in name:
                found[name] = block.count("HGMMA")
        if len(found) != instances or not all(found.values()):
            fail(f"HGMMA missing from the SASS of {kernel}: {found}")
        counts.update(zip(demangle(list(found)), found.values()))
    return counts


def phase_kernels(torch, F):
    from repro_torch.kernels import decode_attn, flash_attention, ops
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.roofline.hw import bound_seconds

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": {}, "decode_attention": {}}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the serve shape in both dtypes, the training step's (S=1024) in bf16,
    # zamba2-7b's serve shape (hd 112) in both dtypes, qwen2-moe-a2.7b's
    # (MHA at hd 128) in bf16, a rank's of the tensor-parallel step in both,
    # in bf16 a rank's of the MoE's sharded step and a pipeline stage's,
    # gemma-2b's at hd 256 (a rank's of train_gemma_mesh, the serve-like) in
    # both, internvl2-26b's at group 6 (patches and prompt; a rank's of
    # train_vlm_mesh) in both, and
    # whisper-small's at hd 64 (the encoder's non-causal, the decoder's
    # causal over the prompt, the cross-attention's non-causal at Sq 16
    # against 1,500 frames; a rank's of train_encdec_mesh: the encoder's and
    # the cross-attention's of 448 tokens) in both, qwen3-moe-30b-a3b's at
    # group 8 in both, nemotron-4-15b's at group 6 in both, gpt2-2.7b's at
    # head_dim 80 (the serve's in both, the training step's in bf16) and
    # deepseek-67b's at group 8 in both
    for key, dtype, p in (("bfloat16", torch.bfloat16, PREFILL),
                          ("float32", torch.float32, PREFILL),
                          ("bfloat16_train", torch.bfloat16,
                           dict(PREFILL, s=TRAIN["seq_len"])),
                          ("bfloat16_hd112", torch.bfloat16, PREFILL_HD112),
                          ("float32_hd112", torch.float32, PREFILL_HD112),
                          ("bfloat16_moe", torch.bfloat16, PREFILL_MOE),
                          ("bfloat16_tp", torch.bfloat16, PREFILL_TP),
                          ("float32_tp", torch.float32, PREFILL_TP),
                          ("bfloat16_moe_tp", torch.bfloat16, PREFILL_MOE_TP),
                          ("bfloat16_pipe", torch.bfloat16, PREFILL_PIPE),
                          ("bfloat16_gemma_tp", torch.bfloat16, PREFILL_GEMMA_TP),
                          ("float32_gemma_tp", torch.float32, PREFILL_GEMMA_TP),
                          ("bfloat16_hd256", torch.bfloat16, PREFILL_HD256),
                          ("float32_hd256", torch.float32, PREFILL_HD256),
                          ("bfloat16_vlm", torch.bfloat16, PREFILL_VLM),
                          ("float32_vlm", torch.float32, PREFILL_VLM),
                          ("bfloat16_vlm_tp", torch.bfloat16, PREFILL_VLM_TP),
                          ("float32_vlm_tp", torch.float32, PREFILL_VLM_TP),
                          ("bfloat16_vlm_serve_tp", torch.bfloat16, PREFILL_VLM_SERVE_TP),
                          ("float32_vlm_serve_tp", torch.float32, PREFILL_VLM_SERVE_TP),
                          ("bfloat16_encdec_enc", torch.bfloat16, PREFILL_ENCDEC_ENC),
                          ("float32_encdec_enc", torch.float32, PREFILL_ENCDEC_ENC),
                          ("bfloat16_encdec_self", torch.bfloat16, PREFILL_ENCDEC_SELF),
                          ("float32_encdec_self", torch.float32, PREFILL_ENCDEC_SELF),
                          ("bfloat16_encdec_cross", torch.bfloat16, PREFILL_ENCDEC_CROSS),
                          ("float32_encdec_cross", torch.float32, PREFILL_ENCDEC_CROSS),
                          ("bfloat16_encdec_enc_tp", torch.bfloat16, PREFILL_ENCDEC_ENC_TP),
                          ("float32_encdec_enc_tp", torch.float32, PREFILL_ENCDEC_ENC_TP),
                          ("bfloat16_encdec_cross_tp", torch.bfloat16, PREFILL_ENCDEC_CROSS_TP),
                          ("float32_encdec_cross_tp", torch.float32, PREFILL_ENCDEC_CROSS_TP),
                          ("bfloat16_moe30", torch.bfloat16, PREFILL_MOE30),
                          ("float32_moe30", torch.float32, PREFILL_MOE30),
                          ("bfloat16_nemotron", torch.bfloat16, PREFILL_NEMOTRON),
                          ("float32_nemotron", torch.float32, PREFILL_NEMOTRON),
                          ("bfloat16_gpt2", torch.bfloat16, PREFILL_GPT2),
                          ("float32_gpt2", torch.float32, PREFILL_GPT2),
                          ("bfloat16_gpt2_train", torch.bfloat16, PREFILL_GPT2_TRAIN),
                          ("bfloat16_deepseek", torch.bfloat16, PREFILL_DEEPSEEK),
                          ("float32_deepseek", torch.float32, PREFILL_DEEPSEEK)):
        dname = str(dtype).split(".")[-1]
        causal, skv = p.get("causal", True), p.get("skv", p["s"])
        q = rand((p["b"], p["s"], p["h"], p["hd"]), dtype)
        k = rand((p["b"], skv, p["kh"], p["hd"]), dtype)
        v = rand((p["b"], skv, p["kh"], p["hd"]), dtype)
        routed = dict(flash_attention.flash_attention.routes)
        out = flash_attention.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route = [r for r, n in flash_attention.flash_attention.routes.items()
                 if n != routed[r]]
        if route != [EXPECTED_ROUTE[dname]]:
            fail(f"flash_attention {dname}: went by route {route}, "
                 f"expected {EXPECTED_ROUTE[dname]}")
        ref = ops.flash_attention_plain(q, k, v, causal=causal)
        err = check_close(f"flash_attention {dname} {key}", out, ref, TOL[dname])
        per_call = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        args = input_copies((q, k, v))
        kernel = lambda a, b_, c: flash_attention.flash_attention(a, b_, c, causal=causal)  # noqa: E731
        ev_ms = event_ms(torch, kernel, args, 20)
        ms, ms_by = time_ms(torch, kernel, args, 20, ev_ms)
        launch_us = host_us(torch, kernel, args[0], 20)
        plain_ms, plain_by = time_ms(torch, lambda a, b_, c: ops.flash_attention_plain(
            a, b_, c, causal=causal), args, 3)
        library_ms, library_by = time_ms(torch, lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2), is_causal=causal,
            enable_gqa=True), args, 20)
        # the (q, k) pairs attended: causal (Sq = Skv), or every pair
        pairs = p["s"] * (p["s"] + 1) // 2 if causal else p["s"] * skv
        flops = 4 * p["b"] * p["h"] * p["hd"] * pairs
        bound_s, bound_by = bound_seconds(flops, per_call, dname)
        row = dict(kernel="flash_attention", dtype=dname, route=route[0], shape=p,
                   causal=causal, max_abs_err=err, tol=TOL[dname], ms=ms, event_ms=ev_ms,
                   plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
                   host_us_per_launch=launch_us, gflop=flops / 1e9, mbytes=per_call / 1e6,
                   timing=dict(ms=ms_by, plain_ms=plain_by, library_ms=library_by))
        results["flash_attention"][key] = row
        emit("kernels", **row)
        del q, k, v, out, ref, args

    for suffix, d, dtype in (("", DECODE, torch.bfloat16), ("", DECODE, torch.float32),
                             ("_hd112", DECODE_HD112, torch.bfloat16),
                             ("_hd112", DECODE_HD112, torch.float32),
                             ("_moe", DECODE_MOE, torch.bfloat16),
                             ("_hd256_block", DECODE_HD256_BLOCK, torch.bfloat16),
                             ("_hd256_block", DECODE_HD256_BLOCK, torch.float32),
                             ("_hd256", DECODE_HD256, torch.bfloat16),
                             ("_hd256", DECODE_HD256, torch.float32),
                             ("_vlm", DECODE_VLM, torch.bfloat16),
                             ("_vlm", DECODE_VLM, torch.float32),
                             ("_vlm_block", DECODE_VLM_BLOCK, torch.bfloat16),
                             ("_vlm_block", DECODE_VLM_BLOCK, torch.float32),
                             ("_vlm_mesh_block", DECODE_VLM_MESH_BLOCK, torch.bfloat16),
                             ("_vlm_mesh_block", DECODE_VLM_MESH_BLOCK, torch.float32),
                             ("_encdec_self", DECODE_ENCDEC_SELF, torch.bfloat16),
                             ("_encdec_self", DECODE_ENCDEC_SELF, torch.float32),
                             ("_encdec_cross", DECODE_ENCDEC_CROSS, torch.bfloat16),
                             ("_encdec_cross", DECODE_ENCDEC_CROSS, torch.float32),
                             ("_encdec_mesh_block", DECODE_ENCDEC_MESH_BLOCK, torch.bfloat16),
                             ("_encdec_mesh_block", DECODE_ENCDEC_MESH_BLOCK, torch.float32),
                             ("_moe30", DECODE_MOE30, torch.bfloat16),
                             ("_moe30", DECODE_MOE30, torch.float32),
                             ("_nemotron", DECODE_NEMOTRON, torch.bfloat16),
                             ("_nemotron", DECODE_NEMOTRON, torch.float32),
                             ("_gpt2", DECODE_GPT2, torch.bfloat16),
                             ("_gpt2", DECODE_GPT2, torch.float32),
                             ("_gpt2_block", DECODE_GPT2_BLOCK, torch.bfloat16),
                             ("_gpt2_block", DECODE_GPT2_BLOCK, torch.float32),
                             ("_deepseek", DECODE_DEEPSEEK, torch.bfloat16),
                             ("_deepseek", DECODE_DEEPSEEK, torch.float32)):
        dname = str(dtype).split(".")[-1]
        partial = d.get("partial", False)
        q = rand((d["b"], 1, d["h"], d["hd"]), dtype)
        kc = rand((d["b"], d["t"], d["kh"], d["hd"]), dtype)
        vc = rand((d["b"], d["t"], d["kh"], d["hd"]), dtype)
        args = input_copies((q, kc, vc))
        rows = []
        for cur_len in d["cur_lens"]:
            out = decode_attn.decode_attention(q, kc, vc, cur_len, partial=partial)
            torch.cuda.synchronize()
            n_split, rows_per_split = decode_attn.decode_attention.last_split
            ref = decode_attention_ref(q, kc, vc, cur_len, partial=partial)
            what = f"decode_attention {dname} hd={d['hd']} cur_len={cur_len}"
            if partial:          # o (fp32) and lse: the block form's two outputs
                err = max(check_close(what + " o", out[0], ref[0], TOL[dname]),
                          check_close(what + " lse", out[1], ref[1], TOL[dname]))
            else:
                err = check_close(what, out, ref, TOL[dname])
            out_bytes = (q.numel() * 4 + d["b"] * d["h"] * 4 if partial
                         else q.numel() * q.element_size())
            per_call = ((q.numel() + 2 * d["b"] * cur_len * d["kh"] * d["hd"])
                        * q.element_size() + out_bytes)
            kernel = lambda a, b_, c: decode_attn.decode_attention(  # noqa: E731
                a, b_, c, cur_len, partial=partial)
            ev_ms = event_ms(torch, kernel, args, 50)
            ms, ms_by = time_ms(torch, kernel, args, 50, ev_ms)
            launch_us = host_us(torch, kernel, args[0])
            plain_ms, plain_by = time_ms(torch, lambda a, b_, c: decode_attention_ref(
                a, b_, c, cur_len, partial=partial), args, 10)
            library_ms, library_by = time_ms(torch, lambda a, b_, c: F.scaled_dot_product_attention(
                a.transpose(1, 2), b_[:, :cur_len].transpose(1, 2),
                c[:, :cur_len].transpose(1, 2), enable_gqa=True), args, 50)
            flops = 4 * d["b"] * d["h"] * d["hd"] * cur_len
            bound_s, bound_by = bound_seconds(flops, per_call, dname)
            row = dict(kernel="decode_attention", dtype=dname,
                       shape={k_: v_ for k_, v_ in d.items() if k_ not in ("cur_lens", "partial")},
                       form="block (o fp32, lse)" if partial else "normalised",
                       cur_len=cur_len, n_split=n_split, rows_per_split=rows_per_split,
                       max_abs_err=err, tol=TOL[dname], ms=ms, event_ms=ev_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_s * 1e3, bound_by=bound_by,
                       host_us_per_launch=launch_us, mflop=flops / 1e6,
                       mbytes=per_call / 1e6,
                       timing=dict(ms=ms_by, plain_ms=plain_by, library_ms=library_by))
            rows.append(row)
            emit("kernels", **row)
        results["decode_attention"][dname + suffix] = rows
        del q, kc, vc, args
    results["decode_attention"]["gpt2_merge"] = {
        dname: decode_block_merge(torch, gen, dtype, DECODE_GPT2)
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))}
    torch.cuda.empty_cache()
    return results


def decode_block_merge(torch, gen, dtype, d: dict) -> dict:
    """Decode's block form on the two halves of a (B, T, K, hd) cache, both
    full, merged (``models.attention.merge_partials``) against the whole
    cache: against the kernel's normalised form and against the plain
    version at cur_len T, at the dtype's tolerance."""
    from repro_torch.kernels import decode_attn
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.attention import merge_partials

    dname = str(dtype).split(".")[-1]
    b, t, h, kh, hd = d["b"], d["t"], d["h"], d["kh"], d["hd"]
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, 1, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
    half = t // 2
    parts = [decode_attn.decode_attention(q, kc[:, i:i + half].contiguous(),
                                          vc[:, i:i + half].contiguous(), half, partial=True)
             for i in (0, half)]
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    whole = decode_attn.decode_attention(q, kc, vc, t)[:, 0]
    plain = decode_attention_ref(q, kc, vc, t)[:, 0]
    what = f"decode_attention {dname} hd={hd} two blocks of {half} merged"
    return dict(shape={k_: v_ for k_, v_ in d.items() if k_ != "cur_lens"}, blocks=[half, half],
                vs_kernel=check_close(what + " vs the whole cache (kernel)", merged.to(dtype),
                                      whole, TOL[dname]),
                vs_plain=check_close(what + " vs the whole cache (plain)", merged, plain,
                                     TOL[dname]), tol=TOL[dname])


def phase_slice(torch):
    """Full width, 2 layers, fp32: CPU (plain versions) against the card
    (kernels), the same weights and the same tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attn, flash_attention
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    import numpy as np
    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=2, dtype="float32")
    b, prompt, steps = 2, 128, 4
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (b, prompt)))
    max_len = prompt + steps + 1

    flash_attention.flash_attention.launches = 0
    decode_attn.decode_attention.launches = 0
    errs = []
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev), max_len)
        outs = [logits.cpu()]
        for step in range(steps):
            # both sides take the CPU's greedy token
            tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            outs.append(logits.cpu())
        runs[name] = outs
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (b, cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice logits card vs cpu", out, ref, SLICE_TOL))
    launches = (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches)
    if launches != (cfg.num_layers, cfg.num_layers * steps):
        fail(f"slice: kernel launches {launches}, expected "
             f"({cfg.num_layers}, {cfg.num_layers * steps})")
    emit("slice", config="qwen3-0.6b full width, 2 layers, fp32", batch=b, prompt=prompt,
         decode_steps=steps, max_abs_err_per_step=errs, tol=SLICE_TOL,
         flash_launches=launches[0], decode_launches=launches[1])
    del cpu, card
    torch.cuda.empty_cache()


def reset_launches() -> None:
    """Set every kernel wrapper's launch count, and the flash and SSD
    counts by route, to 0."""
    from repro_torch.kernels import decode_attn, flash_attention, ssd
    flash_attention.flash_attention.launches = 0
    flash_attention.flash_attention.routes = dict.fromkeys(
        flash_attention.flash_attention.routes, 0)
    decode_attn.decode_attention.launches = 0
    ssd.ssd.launches = 0
    ssd.ssd.routes = dict.fromkeys(ssd.ssd.routes, 0)


def read_launches() -> dict:
    from repro_torch.kernels import decode_attn, flash_attention, ssd
    return {"flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attn.decode_attention.launches,
            "ssd": ssd.ssd.launches, "ssd_routes": dict(ssd.ssd.routes)}


@contextlib.contextmanager
def record_kernel_calls():
    """The attention kernels' calls while the block runs, by wrapping
    ``ops.flash_attention`` and ``ops.decode_attention``: flash calls counted
    by (q shape, k shape, causal), decode calls by (q shape, k shape), and
    each decode cache shape's ``cur_len`` values."""
    from repro_torch.kernels import ops

    calls = {"flash": collections.Counter(), "decode": collections.Counter(),
             "cur_lens": collections.defaultdict(set)}
    flash, dec = ops.flash_attention, ops.decode_attention

    def flash_rec(q, k, v, *, causal=True):
        calls["flash"][(tuple(q.shape), tuple(k.shape), causal)] += 1
        return flash(q, k, v, causal=causal)

    def decode_rec(q, k, v, cur_len):
        calls["decode"][(tuple(q.shape), tuple(k.shape))] += 1
        calls["cur_lens"][tuple(k.shape)].add(int(cur_len))
        return dec(q, k, v, cur_len)
    ops.flash_attention, ops.decode_attention = flash_rec, decode_rec
    try:
        yield calls
    finally:
        ops.flash_attention, ops.decode_attention = flash, dec


def qk_shapes(calls) -> dict:
    """The distinct (q shape, k shape) pairs of each kernel's recorded calls."""
    return {"flash": sorted({(q, k) for q, k, _ in calls["flash"]}),
            "decode": sorted(calls["decode"])}


def serve_once(torch, prefill, decode, tokens, max_len, gen):
    """Prefill, then ``gen`` - 1 greedy decode steps: (the generated tokens
    (B, gen), whether every logit was finite, prefill s, decode s, the last
    logits' shape)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(tokens, max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(cache, tok)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return torch.stack(out, 1), bool(finite), t_prefill, t_decode, logits.shape


def serve_prefill_flops(cfg, params: int, b: int, prompt: int) -> int:
    """The operations ``serve_bounds`` counts for a prefill: 2 a weight of
    the body (every parameter but the head and an untied embedding, the
    norms' weights among them) and position, 2 a weight of the head for the
    last position, and causal attention's products over s(s+1)/2 pairs."""
    L, h, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    n_head = cfg.padded_vocab * cfg.d_model
    n_body = params - n_head - (0 if cfg.tie_embeddings else n_head)
    s = cfg.num_patch_tokens + prompt
    return 2 * n_body * b * s + 2 * n_head * b + L * 4 * b * h * hd * s * (s + 1) // 2


def serve_bounds(cfg, params: int, b: int, prompt: int, gen: int):
    """The card's least time for the serve run's prefill and for its mean
    decode step, bf16: weight bytes read once (an untied embedding table is
    gathered, not read whole), the patch embeddings read and the KV cache
    bytes written or read once, and the matrix products' and attention's
    operations over every position: a VLM's patches, then the prompt."""
    from repro_torch.roofline.hw import bound_seconds
    L, kh, h, hd = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # the head: the tied embedding or lm_head
    n_embed = 0 if cfg.tie_embeddings else n_head     # an untied embedding, gathered by row
    n_body = params - n_head - n_embed
    weight_bytes = 2 * (params - n_embed)
    s = cfg.num_patch_tokens + prompt                 # positions of the prefill
    kv_bytes_per_pos = 2 * L * b * kh * hd * 2        # K and V, all layers, bf16
    prefill_flops = serve_prefill_flops(cfg, params, b, prompt)
    prefill = bound_seconds(prefill_flops, weight_bytes + kv_bytes_per_pos * s
                            + 2 * b * cfg.num_patch_tokens * cfg.d_model, "bfloat16")
    lens = range(s + 1, s + gen)                       # attended lengths per step
    steps = gen - 1
    decode_flops = 2 * (n_body + n_head) * b + L * 4 * b * h * hd * sum(lens) / steps
    decode_bytes = weight_bytes + kv_bytes_per_pos * sum(lens) / steps
    return prefill, bound_seconds(decode_flops, decode_bytes, "bfloat16")


def phase_serve(torch, served=None):
    """Full qwen3-0.6b: build it, warm up and serve once; or, given
    ``served`` (what an earlier call returned), serve the same model again,
    as after the profiler phases."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("qwen3-0.6b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    if served is None:
        model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
        warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)
        served = (model, prefill, decode, tokens, warm)
    model, prefill, decode, tokens, warm = served

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"serve: kernel launches {launches}, expected {expected}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve: generated tokens out of range")
    prefill_bound, decode_bound = serve_bounds(cfg, param_count(cfg), b, prompt, gen)
    row = dict(config="qwen3-0.6b full (28 layers, bf16)", params=param_count(cfg),
               batch=b, prompt=prompt, gen=gen, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               after_profiler=PROFILER_SESSIONS[0] > 0,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve", **row)
    return served, row


def device_share(torch, fn, top: int = 6, classify=None):
    """Profile ``fn``: wall ms (host clock, ending in a synchronize), the
    device's busy ms (summed device activity, one stream) and its share of
    the wall time, and the activities that take the most device time; with
    ``classify`` (activity name -> group), device ms and calls by group too.
    Where no profiler session saw device activity, the device numbers are
    null (not measured)."""
    wall = []

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    events = profiled(torch, run)
    wall_ms = wall[-1]
    if not events:
        return dict(wall_ms=wall_ms, device_busy_ms=None, device_busy_share=None,
                    device_activities=None, top=[],
                    note="not measured: no profiler session saw device activity")
    by_name = {}
    for name, us in events:
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, calls + 1)
    busy_ms = sum(total for total, _ in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
               device_activities=sum(calls for _, calls in by_name.values()),
               top=[dict(name=n[:90], device_ms=t / 1e3, calls=c) for n, (t, c) in ranked])
    if classify is not None:
        groups = {}
        for name, (us, calls) in by_name.items():
            g = groups.setdefault(classify(name), [0.0, 0])
            g[0] += us / 1e3
            g[1] += calls
        out["groups"] = {g: dict(device_ms=ms, calls=c) for g, (ms, c) in
                         sorted(groups.items(), key=lambda kv: -kv[1][0])}
    return out


def train_kernel_group(name: str) -> str:
    """The group of a device activity of the training step, by its name."""
    if "flash_wgmma_kernel" in name or "flash_fwd_kernel" in name:
        return "flash kernel (ours)"
    if "gemm" in name or "nvjet" in name:
        fp32 = any(tag in name for tag in ("f32f32_f32f32", "sgemm", "ffma"))
        return "fp32 matmul (CUDA cores)" if fp32 else "bf16 matmul (tensor cores)"
    return "elementwise, reductions, copies"


def serve_kernel_group(name: str) -> str:
    """The group of a device activity of a serve step, by its name."""
    if "decode_split_kernel" in name or "decode_merge_kernel" in name:
        return "decode kernel (ours)"
    if "flash_wgmma_kernel" in name or "flash_fwd_kernel" in name:
        return "flash kernel (ours)"
    if "gemm" in name or "nvjet" in name or "cutlass" in name:
        return "matmul"
    if "sort" in name.lower() or "radix" in name.lower() or "scan" in name.lower():
        return "sort, scan (routing)"
    if any(tag in name for tag in ("index", "gather", "scatter", "Index")):
        return "index, gather, scatter"
    return "elementwise, reductions, copies"


def phase_trace(torch, prefill, decode, tokens, model: str):
    prompt, gen = SERVE["prompt"], SERVE["gen"]
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(tokens, prompt + gen)

    def run_decode():
        logits, cache = state["logits"], state["cache"]
        for _ in range(4):
            logits, cache = decode(cache, logits.argmax(-1))

    emit("trace", model=model, part="prefill", **device_share(torch, run_prefill))
    emit("trace", model=model, part="decode x4", **device_share(torch, run_decode))


def ssd_work(b: int, s: int, h: int, p: int, n: int, lc: int, itemsize: int) -> tuple:
    """(operations, bytes) of the SSD chunk kernel's function as the TPU
    kernel defines it: the causal work on the valid rows (C.B^T scores once
    per chunk, the weighted sum into y per head, the end state per head), and
    each input read once and each output written once (x, dt, a, B, C in;
    y_intra in x's dtype, chunk states and decay in fp32 out)."""
    nc = -(-s // lc)
    ops = 0
    for c in range(nc):
        rows = min(lc, s - c * lc)
        pairs = rows * (rows + 1) // 2
        ops += b * (2 * pairs * n + h * (2 * pairs * p + 2 * rows * n * p))
    nbytes = (2 * b * s * h * p * itemsize + b * s * h * 4 + h * 4
              + 2 * b * s * n * itemsize + b * nc * h * n * p * 4 + b * nc * h * 4)
    return ops, nbytes


def ssd_full_work(b: int, s: int, h: int, p: int, n: int, lc: int, itemsize: int) -> tuple:
    """(operations, bytes) of the full SSD (``ops.ssd``): the TPU kernel's
    causal work (``ssd_work``) plus the inter-chunk term C . S_prev on every
    row per head; x, dt, a, B and C read once, y (x's dtype) and the final
    state (fp32) written once."""
    ops, _ = ssd_work(b, s, h, p, n, lc, itemsize)
    ops += 2 * b * s * h * n * p
    nbytes = (2 * b * s * h * p * itemsize + b * s * h * 4 + h * 4 + 2 * b * s * n * itemsize
              + b * h * n * p * 4)
    return ops, nbytes


# The previous design's full bf16 ops.ssd (the CUDA-core chunk kernel of
# ssd.cu in bf16 plus the plain combine), device ms per call at the serve
# shape by sequence length: the ``ssd_ms`` that chip_smoke.py printed at
# commit 811c7eb on an H100 80GB HBM3 with a 700.00 W power limit. Not
# measured by this run: that code is gone.
SSD_BEFORE_MS = {1000: 2.414251599999998, 1024: 2.403853499999999}


def phase_ssd_kernel(torch) -> dict:
    """The full SSD (``ops.ssd``) against ``ssd_chunked`` at mamba2's serve
    shape (S=1000: the last 256-row chunk ragged) and at S=1024: bf16 on the
    tensor-core route (also with an initial state), fp32 on the CUDA-core
    route, whose intra-chunk kernel is also held to its three outputs; and
    bf16 at zamba2-7b's serve shape (112 heads, N 64) and at a rank's share
    of both models' heads at model 2 (40 and 56 heads, 4 x 1024)."""
    from repro_torch.kernels import ops, ssd
    from repro_torch.kernels.ref import ssd_intra_chunk_ref, ssd_ref
    from repro_torch.roofline.hw import bound_seconds

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    cases = [("mamba2-2.7b", SSD, s, dtype) for s in SSD["seqs"]
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("zamba2-7b", SSD_HYBRID, s, torch.bfloat16) for s in SSD_HYBRID["seqs"]]
    cases += [(f"{model}/tp2", k, s, torch.bfloat16)
              for model, k in (("mamba2-2.7b", SSD_TP), ("zamba2-7b", SSD_HYBRID_TP))
              for s in k["seqs"]]
    for model, k, s, dtype in cases:
        b, h, p, n, lc = k["b"], k["h"], k["p"], k["n"], k["chunk"]
        dname = str(dtype).split(".")[-1]
        # the distributions of tests/test_kernels.py
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        dt = 0.001 + 0.099 * torch.rand((b, s, h), generator=gen, device="cuda")
        a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device="cuda"))
        bm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
        cm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
        args = (x, dt, a, bm, cm)
        name = f"ssd {model} {dname} S={s}"
        extra = {}
        if dtype == torch.float32:            # the CUDA-core kernel's own outputs
            got = ssd.ssd_intra_chunk(*args, chunk=lc)
            torch.cuda.synchronize()
            want = ssd_intra_chunk_ref(*args, chunk=lc)
            extra = dict(
                y_intra_err=check_close(f"{name} y_intra", got[0], want[0], TOL[dname]),
                states_err=check_close(f"{name} chunk states", got[1], want[1], STATE_TOL),
                decay_err=check_close(f"{name} chunk decay", got[2], want[2], STATE_TOL))
            del got, want
        routed = dict(ssd.ssd.routes)
        y, final = ops.ssd(*args, chunk=lc)
        torch.cuda.synchronize()
        route = [r for r, c in ssd.ssd.routes.items() if c != routed[r]]
        if route != [EXPECTED_ROUTE[dname]]:
            fail(f"{name}: went by route {route}, expected {EXPECTED_ROUTE[dname]}")
        y_ref, final_ref = ssd_ref(*args, chunk=lc)
        if y.shape != x.shape or y.dtype != dtype or final.shape != (b, h, n, p):
            fail(f"{name}: y {tuple(y.shape)} {y.dtype}, final {tuple(final.shape)}")
        y_err = check_close(f"{name} y vs ssd_chunked", y, y_ref, TOL[dname])
        final_err = check_close(f"{name} final state vs ssd_chunked", final, final_ref,
                                STATE_TOL)
        if dtype == torch.bfloat16:           # a carried-in state
            init = torch.randn((b, h, n, p), generator=gen, device="cuda")
            y, final = ops.ssd(*args, chunk=lc, initial_state=init)
            y_ref, final_ref = ssd_ref(*args, chunk=lc, initial_state=init)
            extra = dict(
                initial_state_y_err=check_close(f"{name} y with initial state", y, y_ref,
                                                TOL[dname]),
                initial_state_final_err=check_close(
                    f"{name} final state with initial state", final, final_ref, STATE_TOL))
            del init
        del y, final, y_ref, final_ref
        copies = input_copies(args)
        kernel = lambda *t: ops.ssd(*t, chunk=lc)  # noqa: E731
        ev_ms = event_ms(torch, kernel, copies, 20)
        ms, ms_by = time_ms(torch, kernel, copies, 20, ev_ms)
        launch_us = host_us(torch, kernel, copies[0], 50)
        plain_ms, plain_by = time_ms(torch, lambda *t: ssd_ref(*t, chunk=lc), copies, 3)
        if dtype == torch.float32:
            extra["intra_kernel_ms"] = time_ms(
                torch, lambda *t: ssd.ssd_intra_chunk(*t, chunk=lc), copies, 10)[0]
        flops, nbytes = ssd_full_work(b, s, h, p, n, lc, x.element_size())
        bound_s, bound_by = bound_seconds(flops, nbytes, dname)
        tpu_flops, tpu_bytes = ssd_work(b, s, h, p, n, lc, x.element_size())
        tpu_bound_s, tpu_bound_by = bound_seconds(tpu_flops, tpu_bytes, dname)
        row = dict(kernel="ssd", model=model, dtype=dname, route=route[0],
                   shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=lc), ragged=s % lc != 0,
                   max_abs_err=y_err, tol=TOL[dname], final_state_err=final_err,
                   state_tol=STATE_TOL, **extra, ms=ms, event_ms=ev_ms,
                   plain_ms=plain_ms, plain="ssd_chunked",
                   before_ms=(SSD_BEFORE_MS[s] if dtype == torch.bfloat16
                              and model == "mamba2-2.7b" else None),
                   before_note="the previous design's ops.ssd, from SSD_BEFORE_MS: "
                               "not measured in this run",
                   library_ms=None,
                   library_note="no single PyTorch call computes the SSD",
                   bound_ms=bound_s * 1e3, bound_by=bound_by,
                   tpu_kernel_bound_ms=tpu_bound_s * 1e3, tpu_kernel_bound_by=tpu_bound_by,
                   host_us_per_launch=launch_us, gflop=flops / 1e9,
                   mbytes=nbytes / 1e6, timing=dict(ms=ms_by, plain_ms=plain_by))
        rows[(model, s, dname)] = row
        emit("kernels", **row)
        del x, dt, a, bm, cm, args, copies
        torch.cuda.empty_cache()
    return rows


def phase_slice_ssm(torch):
    """mamba2-2.7b at full width, 2 layers, fp32: CPU (plain versions)
    against the card (the SSD kernel), the same weights and tokens; logits
    at every step and the final decode state compared."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = dataclasses.replace(get_arch("mamba2-2.7b"), num_layers=2, dtype="float32")
    b, prompt, steps = SSM_SLICE["batch"], SSM_SLICE["prompt"], SSM_SLICE["steps"]
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, prompt)))

    reset_launches()
    runs, states = {}, {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev))
        outs = [logits.cpu()]
        for step in range(steps):
            tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            outs.append(logits.cpu())
        runs[name] = outs
        states[name] = {k: v.cpu() for k, v in cache["mamba"].items()}
    launches = read_launches()
    errs = []
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (b, cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice_ssm: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice_ssm logits card vs cpu", out, ref, SLICE_TOL))
    state_errs = {k: check_close(f"slice_ssm final {k} card vs cpu", states["cuda"][k],
                                 states["cpu"][k], SLICE_TOL) for k in states["cpu"]}
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": 0, "fp32": cfg.num_layers}}
    if launches != expected:
        fail(f"slice_ssm: kernel launches {launches}, expected {expected}")
    emit("slice_ssm", config="mamba2-2.7b full width, 2 layers, fp32", batch=b,
         prompt=prompt, chunks=-(-prompt // cfg.ssm_chunk), decode_steps=steps,
         max_abs_err_per_step=errs, final_state_err=state_errs, tol=SLICE_TOL,
         launches=launches)
    del cpu, card
    torch.cuda.empty_cache()


def phase_train_grad(torch):
    """The flash kernel under autograd against the plain version under
    autograd; then the loss, gradients and one AdamW step of a full-width
    2-layer fp32 qwen3-0.6b on the card against the same port on the CPU."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cast_params
    from repro_torch.train.state import grad_tree, param_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    gen = torch.Generator(device="cuda").manual_seed(3)
    flash = {}
    for dname, g in GRAD.items():
        dtype = torch.bfloat16 if dname.startswith("bf16") else torch.float32
        shapes = ((g["b"], g["s"], g["h"], g["hd"]), (g["b"], g["s"], g["kh"], g["hd"]),
                  (g["b"], g["s"], g["kh"], g["hd"]))
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in shapes)
        grad_out = torch.randn(shapes[0], generator=gen, device="cuda").to(dtype)
        runs = {}
        for name, fn in (("kernel", lambda a, b_, c: ops.flash_attention(a, b_, c)),
                         ("plain", lambda a, b_, c: ops.flash_attention_plain(a, b_, c))):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            routed = dict(fa.flash_attention.routes)
            out = fn(*leaves)
            out.backward(grad_out)
            torch.cuda.synchronize()
            runs[name] = [out.detach()] + [t.grad for t in leaves]
            if name == "kernel" and fa.flash_attention.routes == routed:
                fail(f"train_grad flash {dname}: the kernel did not run")
        errs = {part: check_close(f"train_grad flash {dname} {part}", got, want, g["tol"])
                for part, got, want in zip(("out", "dq", "dk", "dv"), runs["kernel"],
                                           runs["plain"])}
        flash[dname] = dict(shape={k_: v_ for k_, v_ in g.items() if k_ != "tol"},
                            tol=g["tol"], max_abs_err=errs)
        del q, k, v, grad_out, runs

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=2, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (LOSS["batch"], LOSS["seq"] + 1)))
    hp = AdamWConfig(warmup_steps=2, total_steps=100)
    results = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        model.requires_grad_(True)
        dev = model.device
        loss, _ = model.loss({"tokens": tokens.to(dev)})
        loss.backward()
        grads = {keystr(p): t for p, t in tree_flatten_with_path(_host_tree(grad_tree(model)))}
        params = param_tree(model)
        opt = adamw_init(params)
        adamw_update(grad_tree(model), opt, torch.tensor(3, dtype=torch.int32, device=dev), hp,
                     torch.tensor(1e-3, device=dev))
        cast_params(opt["master"], params)
        after = {keystr(p): t for p, t in tree_flatten_with_path(
            _host_tree({"opt": opt, "params": params}))}
        results[name] = (loss.detach().cpu(), grads, after)
    loss_err = check_close("train_grad loss card vs cpu", results["cuda"][0],
                           results["cpu"][0], LOSS["tol"])
    grad_err = {k: check_close(f"train_grad grad {k} card vs cpu", results["cuda"][1][k], ref,
                               LOSS["tol"]) for k, ref in results["cpu"][1].items()}
    adamw_err = max(check_close(f"train_grad adamw {k} card vs cpu", results["cuda"][2][k], ref,
                                LOSS["tol"]) for k, ref in results["cpu"][2].items())
    for k, g in results["cuda"][1].items():
        if "|attn|" in k and (not torch.isfinite(g).all() or not (g != 0).any()):
            fail(f"train_grad: attention gradient {k} is not finite or is all 0")
    del cpu, card
    emit("train_grad", flash=flash, config="qwen3-0.6b full width, 2 layers, fp32",
         tokens=list(tokens.shape), loss=float(results["cuda"][0]), loss_err=loss_err,
         grad_leaves=len(grad_err), grad_max_abs_err=max(grad_err.values()),
         attn_grad_err={k: v for k, v in grad_err.items() if "|attn|" in k},
         adamw_max_abs_err=adamw_err, tol=LOSS["tol"], ssd=ssd_grads(torch),
         hybrid=hybrid_loss_grads(torch))
    del results
    torch.cuda.empty_cache()


def ssd_grads(torch) -> dict:
    """``SSD.apply`` on the card (the kernel forward, the ``ssd_chunked``
    recompute backward) against autograd through the plain ``ssd_chunked``,
    one small shape per route: y, the final state and the gradients of x,
    dt, a, B and C, with a cotangent on both outputs."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ref import ssd_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for dname, g in SSD_GRAD.items():
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        b, s, h, p, n, lc = (g[k] for k in ("b", "s", "h", "p", "n", "chunk"))
        args = (torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype),
                0.001 + 0.099 * torch.rand((b, s, h), generator=gen, device="cuda"),
                -(0.5 + 1.5 * torch.rand((h,), generator=gen, device="cuda")),
                torch.randn((b, s, n), generator=gen, device="cuda").to(dtype),
                torch.randn((b, s, n), generator=gen, device="cuda").to(dtype))
        gy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        gf = torch.randn((b, h, n, p), generator=gen, device="cuda")
        runs = {}
        for name, fn in (("kernel", lambda *t: ssd.SSD.apply(*t, lc, None)),
                         ("plain", lambda *t: ssd_ref(*t, chunk=lc))):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            routed = dict(ssd.ssd.routes)
            y, final = fn(*leaves)
            if name == "kernel" and (y.grad_fn is None or ssd.ssd.routes == routed):
                fail(f"train_grad ssd {dname}: the kernel did not run under autograd")
            torch.autograd.backward((y, final), (gy, gf))
            torch.cuda.synchronize()
            runs[name] = [y.detach(), final.detach()] + [t.grad for t in leaves]
        errs = {part: check_close(f"train_grad ssd {dname} {part}", got, want,
                                  STATE_TOL if part == "final" else g["tol"])
                for part, got, want in zip(("y", "final", "dx", "ddt", "da", "db", "dc"),
                                           runs["kernel"], runs["plain"])}
        out[dname] = dict(shape={k: v for k, v in g.items() if k != "tol"}, tol=g["tol"],
                          final_tol=STATE_TOL, max_abs_err=errs)
    return out


def hybrid_loss_grads(torch) -> dict:
    """The hybrid's loss and every gradient on the card (the fp32 flash
    kernel at head_dim 112 and the SSD's fp32 route, both under autograd)
    against the same port on the CPU from the same weights: the smoke
    zamba2-7b at head_dim 112, 2 layers, fp32."""
    import numpy as np

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("zamba2-7b")), head_dim=112,
                              num_layers=2, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (HYBRID_LOSS["batch"], HYBRID_LOSS["seq"] + 1)))
    results = {}
    reset_launches()
    for name, model in (("cpu", cpu), ("cuda", card)):
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": tokens.to(model.device)})
        loss.backward()
        results[name] = (loss.detach().cpu(), {
            keystr(p): t for p, t in tree_flatten_with_path(_host_tree(grad_tree(model)))})
    launches = read_launches()
    expected = {"flash_attention": 1, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": 0, "fp32": cfg.num_layers}}
    if launches != expected:
        fail(f"train_grad hybrid: kernel launches {launches}, expected {expected}")
    tol = HYBRID_LOSS["tol"]
    loss_err = check_close("train_grad hybrid loss card vs cpu", results["cuda"][0],
                           results["cpu"][0], tol)
    grad_err = {k: check_close(f"train_grad hybrid grad {k} card vs cpu",
                               results["cuda"][1][k], ref, tol)
                for k, ref in results["cpu"][1].items()}
    for k, g in results["cuda"][1].items():
        if k.startswith("shared_attn|attn|") and not (g != 0).any():
            fail(f"train_grad hybrid: shared attention gradient {k} is all 0")
    return dict(config="zamba2-7b smoke at head_dim 112, 2 layers, fp32",
                tokens=list(tokens.shape), loss=float(results["cuda"][0]),
                loss_err=loss_err, grad_leaves=len(grad_err),
                grad_max_abs_err=max(grad_err.values()),
                shared_attn_grad_err={k: v for k, v in grad_err.items()
                                      if k.startswith("shared_attn")},
                launches=launches, tol=tol)


def _host_tree(tree):
    """A tree of the port's tensors as CPU fp32 tensors (Stacked leaves
    stacked), for comparing two runs leaf by leaf."""
    import torch

    from repro_torch.tree import Stacked, tree_map
    return tree_map(lambda t: torch.stack([x.detach().float().cpu() for x in t.layers])
                    if isinstance(t, Stacked) else t.detach().float().cpu(), tree)


def train_bound(cfg, params: int, tokens: int, b: int, s: int):
    """The card's least time for one training step, bf16: 6 operations per
    parameter and token (forward 2, backward 4; the tied head's product
    counts once, through the embedding's parameters; an untied embedding
    table is gathered by row and does no products), and causal attention's
    products, forward (Q.K^T and P.V) and backward (4 products, twice the
    forward's operations). Recomputation in the backward is the
    implementation's, not the step's, and is not counted. Bytes (weights,
    optimizer state read and written once) bound it far less."""
    from repro_torch.roofline.hw import bound_seconds
    n_embed = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    pairs = s * (s + 1) // 2
    attn_fwd = 4 * b * cfg.num_heads * cfg.resolved_head_dim * pairs
    flops = 6 * (params - n_embed) * tokens + 3 * cfg.num_layers * attn_fwd
    nbytes = params * (2 + 2 + 2 + 3 * 4 * 2)     # params, grads read, params written, opt r/w
    return bound_seconds(flops, nbytes, "bfloat16"), flops, attn_fwd


def peak_rss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def host_rss_gb() -> float:
    """The process's resident host memory now (Linux)."""
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def train_through_a_failure(torch, phase: str, cfg, t: dict, ckpt_name: str) -> dict:
    """Train ``cfg`` through the port's SimCluster on the card (``t``: dp,
    global batch, sequence length, steps before and after, the failed
    worker): steps, a software failure, ``recover()`` with the stream
    policy, steps. The launch counts are zeroed just before the first step
    and read just after the last. Fails the phase unless the recovery came
    from the neighbour with no rollback, the optimizer vector after it is
    bitwise equal to a host copy taken before the failure, every step
    recorded its parts and every loss is finite."""
    import shutil

    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.cluster import ClusterConfig, SimCluster
    from repro_torch.runtime.recovery import _flatten_opt

    ckpt_dir = ROOT / "build" / ckpt_name
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    rss_start = host_rss_gb()
    t0 = time.perf_counter()
    clu = SimCluster(cfg, ClusterConfig(dp=t["dp"], global_batch=t["global_batch"],
                                        seq_len=t["seq_len"], ckpt_dir=ckpt_dir),
                     clock=time.perf_counter)
    setup_s = time.perf_counter() - t0

    # the step's parts as SimCluster.step records them (device by CUDA
    # events, host by the clock); a part missing from a step fails the phase
    span_keys = {"compute_ms", "device_ms", "flatten_ms", "shard_ms", "fabric_ms", "step_ms"}
    spans = []

    def step():
        loss = clu.step()
        sp = dict(clu.last_step_timing)
        if set(sp) != span_keys or any(v is None for v in sp.values()):
            fail(f"{phase}: step timing {sp}, expected every one of {sorted(span_keys)}")
        spans.append(dict(sp, loss=loss, host_rss_gb=host_rss_gb()))

    reset_launches()
    for _ in range(t["steps_before"]):
        step()
    before, _ = _flatten_opt(clu.state["opt"])
    clu.inject_failure([t["failed"]])
    t0 = time.perf_counter()
    rep = clu.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    after, _ = _flatten_opt(clu.state["opt"])
    bitwise = bool(np.array_equal(before, after))
    vec_len = len(after)
    del before, after
    for _ in range(t["steps_after"]):
        step()
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    steps = t["steps_before"] + t["steps_after"]
    losses = [sp["loss"] for sp in spans]
    if rep.recovered_from != "neighbor" or rep.rolled_back_iterations != 0:
        fail(f"{phase}: recovered from {rep.recovered_from} with "
             f"{rep.rolled_back_iterations} iterations rolled back")
    if not bitwise:
        fail(f"{phase}: the optimizer vector after recovery differs from the copy before "
             "the failure")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: losses {losses}")
    if clu.iteration != steps:
        fail(f"{phase}: {clu.iteration} iterations after the run, expected {steps}")
    return dict(clu=clu, ckpt_dir=ckpt_dir, spans=spans, rep=rep, recover_s=recover_s,
                bitwise=bitwise, vec_len=vec_len, launches=launches,
                flash_routes=flash_routes, steps=steps, losses=losses, setup_s=setup_s,
                rss_start=rss_start)


def train_row(torch, run: dict, t: dict, params: int, bound: tuple, flops: float) -> dict:
    """The fields a training phase prints: the step split (medians of the
    steps after the first), tokens/s beside the bound, memory and the
    recovery."""
    import numpy as np

    from repro_torch.roofline.hw import HOST_LINK_BW

    spans, rep = run["spans"], run["rep"]
    later = spans[1:]

    def median(key):
        return float(np.median([sp[key] for sp in later]))

    step_ms = median("step_ms")
    tokens = t["global_batch"] * t["seq_len"]
    return dict(params=params, dp=t["dp"], global_batch=t["global_batch"],
                seq_len=t["seq_len"], tokens_per_step=tokens, steps=run["steps"],
                losses=run["losses"], step_ms=step_ms, step_ms_first=spans[0]["step_ms"],
                device_ms=median("device_ms"), step_call_ms=median("compute_ms"),
                host_ckpt_ms=float(np.median([sp["step_ms"] - sp["compute_ms"]
                                              for sp in later])),
                flatten_d2h_ms=median("flatten_ms"),
                flatten_d2h_bound_ms=run["vec_len"] * 4 / HOST_LINK_BW * 1e3,
                shard_chunk_crc_ms=median("shard_ms"), fabric_run_ms=median("fabric_ms"),
                tokens_per_s=tokens / (step_ms / 1e3),
                bound_ms=bound[0] * 1e3, bound_by=bound[1], bound_tflop=flops / 1e12,
                opt_vector_gb=run["vec_len"] * 4 / 1e9,
                peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                host_rss_at_start_gb=run["rss_start"],
                host_rss_max_gb=max(sp["host_rss_gb"] for sp in spans),
                process_peak_rss_gb=peak_rss_gb(),
                host_rss_note="host_rss_max_gb: the largest RSS read after a step; "
                              "process_peak_rss_gb includes earlier phases",
                setup_s=run["setup_s"], recovered_from=rep.recovered_from,
                rolled_back=rep.rolled_back_iterations,
                opt_vector_bitwise_equal=run["bitwise"], recover_wall_s=run["recover_s"],
                recover_simulated_s=rep.total_time,
                recover_simulated_timeline=rep.timeline,
                recover_note="recover_simulated_s is simulated fabric time, not measured",
                state_bytes_streamed=rep.state_bytes_streamed, chunks=rep.chunks_total,
                launches=run["launches"], flash_routes=run["flash_routes"], spans=spans)


def close_cluster(torch, run: dict) -> float:
    """Close the cluster's engines, free it and hand the freed host heap
    back to the OS; returns the host RSS after."""
    import ctypes
    import gc
    import shutil

    clu = run.pop("clu")
    for w in clu.workers:
        w.engine.close()
    del clu
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    shutil.rmtree(run["ckpt_dir"], ignore_errors=True)
    torch.cuda.empty_cache()
    return host_rss_gb()


def remat_compare(torch, cfg, t: dict) -> dict:
    """One forward and backward of ``cfg`` on a batch of the training
    step's shape, without recompute ("none": what the port's layers did
    before they read remat_policy) and under the config's policy, in the
    same process: the device ms (CUDA events, the median of 3 after a
    warm-up) and the device memory at the peak above the model and its
    gradients."""
    import numpy as np

    from repro_torch.models import build_model

    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (t["global_batch"], t["seq_len"] + 1))).cuda()
    out = {}
    for policy in ("none", cfg.remat_policy):
        model = build_model(dataclasses.replace(cfg, remat_policy=policy)).init(
            torch.Generator(device="cuda").manual_seed(0))
        model.requires_grad_(True)

        def step():
            model.loss({"tokens": tokens})[0].backward()
        step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[policy] = dict(device_ms=float(np.median(times)), device_ms_all=times,
                           peak_above_model_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        del model, step
        torch.cuda.empty_cache()
    return out


def phase_train(torch):
    """qwen3-0.6b at full width, cut to TRAIN's layers, trained through the
    port's SimCluster with a failure and a stream recovery in the middle;
    then a forward and backward with and without the config's recompute
    (``remat_compare``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import param_count

    t = TRAIN
    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=t["layers"])
    run = train_through_a_failure(torch, "train", cfg, t, "chip_smoke_ckpt")
    steps = run["steps"]
    flash = passes(cfg) * cfg.num_layers * steps        # the forward and the recompute
    expected = {"flash_attention": flash, "decode_attention": 0, "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if run["launches"] != expected or run["flash_routes"].get("wgmma") != flash:
        fail(f"train: kernel launches {run['launches']}, flash routes {run['flash_routes']}, "
             f"expected {expected} all on wgmma")

    remat = remat_compare(torch, cfg, t)
    # where the device step's time goes: one more step under torch.profiler,
    # after the measured run (the first profiler session of the script)
    clu = run["clu"]
    batch = clu._assemble_batch()
    trace = device_share(torch, lambda: clu._step(clu.state, batch), top=12,
                         classify=train_kernel_group)
    del clu, batch
    params = param_count(cfg)
    bound, flops, attn_fwd = train_bound(cfg, params, t["global_batch"] * t["seq_len"],
                                         t["global_batch"], t["seq_len"])
    row = dict(config=f"qwen3-0.6b full width, {cfg.num_layers} of 28 layers (bf16, tied head)",
               **train_row(torch, run, t, params, bound, flops),
               attention_fwd_gflop_per_layer=attn_fwd / 1e9, device_step_trace=trace,
               remat_policy=cfg.remat_policy, fwd_bwd_by_remat=remat)
    row["host_rss_after_free_gb"] = close_cluster(torch, run)
    emit("train", **row)
    return row


def phase_train_gpt2(torch):
    """The paper's GPT-2 2.7B at full width, cut to GPT2_TRAIN's 2 of its 32
    layers (415,511,040 parameters, head_dim 80; its fp32 optimizer state
    4.99 GB), trained through the port's SimCluster with a failure and a
    stream recovery in the middle, as ``train``: every flash launch on
    wgmma at q/k/v (8, 1024, 32, 80), the forward and the recompute of
    every layer a step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import param_count

    t = GPT2_TRAIN
    cfg = dataclasses.replace(get_arch("gpt2-2.7b"), num_layers=t["layers"])
    with record_kernel_calls() as calls:
        run = train_through_a_failure(torch, "train_gpt2", cfg, t, "chip_smoke_gpt2_ckpt")
    flash = passes(cfg) * cfg.num_layers * run["steps"]     # the forward and the recompute
    expected = {"flash_attention": flash, "decode_attention": 0, "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    qk = (t["global_batch"], t["seq_len"], h, hd)
    want_calls = {(qk, qk, True): flash}
    if run["launches"] != expected or run["flash_routes"] != {"wgmma": flash, "fp32": 0}:
        fail(f"train_gpt2: kernel launches {run['launches']}, flash routes "
             f"{run['flash_routes']}, expected {expected} all on wgmma")
    if dict(calls["flash"]) != want_calls or calls["decode"]:
        fail(f"train_gpt2: flash calls {dict(calls['flash'])}, decode calls "
             f"{dict(calls['decode'])}; expected {want_calls} and no decode")
    params = param_count(cfg)
    bound, flops, attn_fwd = train_bound(cfg, params, t["global_batch"] * t["seq_len"],
                                         t["global_batch"], t["seq_len"])
    row = dict(config=f"gpt2-2.7b full width, {cfg.num_layers} of 32 layers (bf16, MHA "
                      f"{h}/{cfg.num_kv_heads} at head_dim {hd}, gelu d_ff {cfg.d_ff}, untied "
                      f"head of {cfg.padded_vocab})",
               **train_row(torch, run, t, params, bound, flops),
               attention_fwd_gflop_per_layer=attn_fwd / 1e9, remat_policy=cfg.remat_policy,
               flash_calls=[[list(q), list(k), causal, n]
                            for (q, k, causal), n in calls["flash"].items()])
    row["host_rss_after_free_gb"] = close_cluster(torch, run)
    emit("train_gpt2", **row)
    return row


# the full-width replay of the fleet's baseline scenario: its events (a
# software failure of worker 1 before step 5, 10 steps) on qwen3-0.6b at full
# width cut to 2 of 28 layers (for the script's time limit), dp=4 simulated
# workers, 8 x 1024 tokens a step
REPLAY = dict(scenario="clean_software_failure", layers=2, global_batch=8, seq_len=1024)
# a verdict field that may differ from the reference-scale pin at full width,
# and why: the shard's size, or the simulated fabric time it takes
SCALE_FIELDS = {"state_bytes_streamed": "bytes", "chunks_reused": "bytes",
                "chunks_rebalanced": "bytes", "rebalances": "bytes",
                "exposed_seconds": "sim time", "recovery_total_s": "sim time",
                "stream_seconds": "sim time"}


# the sharded multi-rank step (train.step.build_train_step), four gloo ranks
# sharing the one card: (a) qwen3-0.6b at full width cut to 4 of 28 layers
# (the script's time: a step's host work scales with the state), bf16, FSDP
# and the instant backup, 8 x 1024 tokens a step (2 x 1024 a rank), 2 steps, then the
# neighbour drill, the first batch scored again and one step without FSDP for
# its memory; (b) full width cut to 2 layers, fp32, 2 steps, against one rank
# of the same step over NCCL from the same weights (drawn on the card from
# the seed, as the other sharded phases draw theirs) and batches. The
# children are spawned (CUDA cannot fork) and meet through file:// in a
# temporary directory.
TRAIN_MESH = dict(arch="qwen3-0.6b", smoke=False, layers=4, dtype="bfloat16", world=4,
                  global_batch=8, seq_len=1024, steps=2, seed=0, draw="cuda", timeout_s=600)
TRAIN_MESH_B = dict(arch="qwen3-0.6b", smoke=False, layers=2, dtype="float32", world=4,
                    global_batch=8, seq_len=1024, steps=2, seed=0, draw="cuda", timeout_s=300,
                    tol=1e-5,
                    grad_tol=2e-4, held=("m", "master", "v"),
                    grad_tol_why="the fp32 gradient tolerance of the training slice: over "
                    "8,192 tokens the two reduction orders differed by up to 8.8e-6 of a "
                    "leaf's largest gradient on an H100")
MESH_NOTE = ("gloo through the host on one shared card: the four ranks share one H100 and "
             "every collective crosses the host; not the figure of a ring on NVLink")
# the tensor-parallel step on a (data 2, model 2) mesh of four gloo ranks
# sharing the card: (a) qwen3-0.6b at full width cut to 4 of 28 layers (as
# train_mesh (a)), bf16, FSDP and the instant backup, 8 x 1024 tokens a step (4 x 1024 a data rank), 2 steps; (b) full width cut to
# 2 layers, fp32, 2 steps, against one rank of the same step over NCCL
TRAIN_TP = dict(TRAIN_MESH, model=2, timeout_s=600)
TRAIN_TP_B = dict(TRAIN_MESH_B, model=2)
# (a)'s first step against train_mesh (a)'s (same weights and batches on
# (4, 1)), relative: bf16 activations in two reduction orders, which on an
# H100 gave a loss 8.6e-6 and a global gradient norm 2.6e-5 apart
TP_VS_MESH = dict(loss_rtol=1e-4, grad_norm_rtol=1e-3)
# what train_tp, train_moe_mesh and train_gemma_mesh (a) recorded before the
# residual stream was split by sequence over "model" (earlier runs of this
# script, H100 80GB HBM3, 700.00 W), printed beside this run's numbers; None
# where a run did not record it; at the depths given, before the phases'
# (a) were cut
BEFORE_SP = {
    "train_tp": dict(layers=28, step_ms=7516, tp_reduce_s=[1.9, 2.4], peak_device_mem_gb=6.49,
                     model_all_reduces=[145, 1191238656]),
    "train_moe_mesh": dict(layers=2, step_ms=16503, tp_reduce_s=None, peak_device_mem_gb=None),
    "train_gemma_mesh": dict(layers=6, step_ms=7279, tp_reduce_s=[0.58, 0.74],
                             peak_device_mem_gb=None),
}
# the MoE in the sharded step on a (data 2, model 2) mesh of four gloo ranks
# sharing the card: qwen2-moe-a2.7b at full width (64 padded experts, top-4,
# the shared expert, MHA 16/16 at hd 128) cut to 2 layers (1,833,187,328
# parameters; a rank holds 32 experts), weights drawn on the card from a
# seed, 8 x 1024 tokens a step (16 groups of 512; a data rank routes 8).
# (a) bf16, FSDP and the instant backup, 2 steps; (b) fp32, 2 steps of 2
# microbatches (a rank's block of each global microbatch: 16 groups of 256,
# 8 a data rank), against one NCCL rank of the same step on the global batch
# (the backup off: it does not touch the step's math, and (a) holds it)
TRAIN_MOE = dict(arch="qwen2-moe-a2.7b", smoke=False, layers=2, dtype="bfloat16", world=4,
                 model=2, global_batch=8, seq_len=1024, steps=2, seed=0, draw="cuda",
                 timeout_s=900)
TRAIN_MOE_B = dict(TRAIN_MOE, dtype="float32", instant_ckpt=False, microbatches=2, tol=1e-5,
                   grad_tol=2e-4, held=("m",), grad_tol_why="the fp32 gradient tolerance of "
                   "the training slice", timeout_s=300)
# gemma-2b at full width (d_model 2048, 8 q heads and 1 kv head of 256,
# GeGLU d_ff 16384, 256,000 tied vocabulary) on four gloo ranks sharing the
# card, weights drawn on the card from a seed: the q heads split over
# "model", the one kv head replicated (each rank reads it for its 4 q heads,
# and sums its wk and wv gradients over "model"). (a) (data 2, model 2), bf16,
# FSDP and the instant backup, 8 x 1024 tokens a step, 2 steps, cut to 2 of
# 18 layers for the script's time (744,499,200 parameters: ~2.2 GB of master,
# m and v a rank and as much again of backup received; 18 layers,
# 2,506,172,416, would be ~90 GB for four ranks). (b) fp32, also 2 layers, on (pod 2, data
# 1, model 2) with int8 cross-pod compression, 2 steps, against one NCCL
# rank's uncompressed step: the losses within 1e-5 (step 1's update is 0
# under the warmup, so both losses see the same weights), every element of
# m of both steps within 2e-4 of its leaf's largest value plus the error
# the int8 rounding makes of it, derived on each rank from the scales it
# used (blocks_part_b, _int8_m_bound)
TRAIN_GEMMA = dict(arch="gemma-2b", smoke=False, layers=2, dtype="bfloat16", world=4, model=2,
                   global_batch=8, seq_len=1024, steps=2, seed=0, draw="cuda", timeout_s=900)
TRAIN_GEMMA_B = dict(TRAIN_GEMMA, layers=2, dtype="float32", pod=2, compress_pod_grads=True,
                     tol=1e-5, grad_tol=2e-4, held=("m",),
                     grad_tol_why="the fp32 gradient tolerance of the training slice",
                     timeout_s=400)
# internvl2-26b (the VLM) in the sharded step on four gloo ranks sharing the
# card, weights and patch embeddings (N(0, 1), in the model's dtype) drawn on
# the card from a seed: full width (d 6,144, 48 q / 8 kv heads of 128, SwiGLU
# 16,384, 92,553 words padded to 92,672), each row 1,024 patches in front of
# 1,024 text tokens, so 2,048 positions, split by sequence over "model"
# (rank 0's block all patches). (a) (data 2, model 2), bf16, FSDP and the
# instant backup, 8 rows a step, 2 steps, cut to 2 of 48 layers (1,918,924,800
# parameters: ~5.8 GB of master, m and v a rank and as much again of backup
# received; each rank draws the whole cut model, 3.84 GB, before it shards
# it; beside the models the parent holds, 2.7 GB a rank of reserved but
# unallocated blocks ran the card out of memory until the ranks' allocators
# grew expandable segments). (b) fp32, cut to 1 layer (1,528,842,240), 4
# rows, 2 microbatches (a
# rank's block of each microbatch's patch rows), the backup off, against one
# NCCL rank of the same step (~31 GB), as train_moe_mesh (b)
TRAIN_VLM = dict(arch="internvl2-26b", smoke=False, layers=2, dtype="bfloat16", world=4,
                 model=2, global_batch=8, seq_len=2048, steps=2, seed=0, draw="cuda",
                 timeout_s=900)
TRAIN_VLM_B = dict(TRAIN_VLM, layers=1, dtype="float32", global_batch=4, microbatches=2,
                   instant_ckpt=False, tol=1e-5, grad_tol=2e-4, held=("m",),
                   grad_tol_why="the fp32 gradient tolerance of the training slice",
                   timeout_s=400)
# whisper-small (the enc-dec) in the sharded step on four gloo ranks sharing
# the card, weights and frame embeddings (N(0, 1), in the model's dtype)
# drawn on the card from a seed: full width and depth (12 encoder and 12
# decoder layers, d 768, 12 heads of 64, gelu 3,072, 51,865 words padded to
# 51,968; 238,139,904 parameters), each row a clip of 1,500 frames and 448 + 1
# tokens (Whisper's text context). The residual streams stay whole over
# "model" (the reference's enc-dec bodies constrain none): the Megatron
# all-reduces. (a) (data 2, model 2), bf16, FSDP and the instant backup, 8
# rows a step, 2 steps. (b) fp32, 2 + 2 layers, 2 steps, against one NCCL
# rank of the same step
TRAIN_ENCDEC = dict(arch="whisper-small", smoke=False, layers=None, dtype="bfloat16", world=4,
                    model=2, global_batch=8, seq_len=448, steps=2, seed=0, draw="cuda",
                    timeout_s=600)
TRAIN_ENCDEC_B = dict(TRAIN_ENCDEC, layers=2, dtype="float32", tol=1e-5, grad_tol=2e-4,
                      held=("m",), grad_tol_why="the fp32 gradient tolerance of the training "
                      "slice", timeout_s=300)


def start_children(jobs: list) -> list:
    """``jobs`` ((function, args) each) started as spawned (CUDA cannot
    fork) daemon processes, which end with this one if it fails first."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args, daemon=True) for fn, args in jobs]
    for p in procs:
        p.start()
    return procs


def wait_children(name: str, procs: list, timeout_s: float) -> None:
    """Wait for all of ``procs``; a child that exits non-zero, or any still
    running ``timeout_s`` from now, kills the others and fails the phase."""
    from multiprocessing.connection import wait

    deadline = time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                fail(f"{name}: ranks still running after {timeout_s} s")
            wait([p.sentinel for p in procs if p.exitcode is None], timeout=min(left, 5.0))
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad:
                fail(f"{name}: a rank exited with {bad[0]}")
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            fail(f"{name}: a rank exited with {bad[0]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)


def run_children(name: str, jobs: list, timeout_s: float) -> None:
    """Start ``jobs`` and wait for them (``start_children``, ``wait_children``)."""
    wait_children(name, start_children(jobs), timeout_s)


def start_reference(phase: str, tb: dict, tmp: str, device: str = "cuda") -> tuple:
    """Start a sharded phase's (b) reference, ``single_part_b`` of ``tb`` on
    one rank over NCCL into ``tmp``, in its own process; ``phase_mesh``
    waits for it. Started while an earlier phase's ranks hold the card, it
    runs beside them: that phase's and this reference's device memory must
    fit the card together."""
    procs = start_children([(mesh_rank, (0, 1, tmp, f"{tmp}/rdv_single", [(single_part_b, tb)],
                                         device, "nccl" if device == "cuda" else "gloo"))])
    return f"{phase} (b), one rank", procs, tb["timeout_s"]


def _mesh_cfg(t: dict):
    from repro_torch.configs import get_arch, reduce_for_smoke
    cfg = get_arch(t["arch"])
    cfg = reduce_for_smoke(cfg) if t["smoke"] else cfg
    encoder = dict(encoder_layers=t["layers"] or cfg.encoder_layers) if cfg.encoder_layers \
        else {}
    return dataclasses.replace(cfg, num_layers=t["layers"] or cfg.num_layers,
                               dtype=t["dtype"], **encoder)


def _mesh_init(rank: int, world: int, rdv: str, backend: str, device: str) -> None:
    """One rank's process: its threads, its card (TF32 off) and the default
    process group over ``backend``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                            world_size=world)


def _mesh_build(world: int, t: dict, device: str):
    """The mesh of an initialised group of ``world`` ranks (pod t["pod"],
    data world / (pod x model), model t["model"]; (1, 1) for one rank), the
    step with and without FSDP (the instant backup unless t["instant_ckpt"]
    is False, t["microbatches"] and t["compress_pod_grads"] where given), a
    maker of the sharded initial state (weights from a host generator seeded
    with t["seed"], as SimCluster draws them, or with t["draw"] "cuda" from
    the card's generator) and this rank's rows of t["steps"] global
    batches ({"tokens"}; a VLM's with its "patch_embeds", an enc-dec's with
    its "frames", each N(0, 1) in the model's dtype drawn where the weights
    are, from t["seed"] + 1 + the step: a VLM's t["seq_len"] counts the
    patches, as the ShapeConfig's does)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step

    cfg = _mesh_cfg(t)
    draw = t.get("draw", "cpu")
    model = build_model(cfg, device=draw)
    model.init(torch.Generator(device=draw).manual_seed(t["seed"]))
    model_axis, pods = (t.get("model", 1), t.get("pod", 1)) if world > 1 else (1, 1)
    mesh = make_host_mesh(data=world // (model_axis * pods), model=model_axis, pod=pods)
    shape = ShapeConfig("train_mesh", t["seq_len"], t["global_batch"], "train")
    hp = AdamWConfig(warmup_steps=2, total_steps=100)          # SimCluster's
    arts = {fsdp: build_train_step(model, mesh, hp, fsdp_params=fsdp, shape=shape,
                                   instant_ckpt=t.get("instant_ckpt", True),
                                   microbatches=t.get("microbatches", 1),
                                   compress_pod_grads=t.get("compress_pod_grads", False),
                                   clock=time.perf_counter) for fsdp in (True, False)}
    rng = np.random.default_rng(t["seed"])
    specs = arts[True].input_pspecs
    npatch, b = cfg.num_patch_tokens, t["global_batch"]
    local = []
    for i in range(t["steps"]):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, t["seq_len"] - npatch + 1), dtype=np.int32))}
        extra = ({"patch_embeds": npatch} if npatch else
                 {"frames": cfg.encoder_seq} if cfg.encoder_layers else {})
        for key, n in extra.items():
            batch[key] = torch.randn(
                (b, n, cfg.d_model), device=draw,
                generator=torch.Generator(device=draw).manual_seed(t["seed"] + 1 + i)
            ).to(model.dtype)
        local.append({k: shd.local_block(v, specs[k], mesh).contiguous().to(device)
                      for k, v in batch.items()})

    def make_state(fsdp: bool):
        return shard_init_state(param_tree(model), arts[fsdp].plan, mesh, device=device)

    return cfg, mesh, arts, make_state, local, model


def _digests(torch, tree, piece: int = 1 << 26) -> list:
    """sha256 of the bytes of every present leaf of ``tree``, in order,
    copied to the host ``piece`` bytes at a time."""
    import hashlib

    from repro_torch.tree import tree_flatten
    out = []
    for x in tree_flatten(tree, lambda v: v is None)[0]:
        if x is None:
            continue
        h = hashlib.sha256()
        for part in x.detach().contiguous().reshape(-1).view(torch.uint8).split(piece):
            h.update(part.cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _same(torch, a, b) -> bool:
    """Two trees bit for bit (None leaves where both have them)."""
    from repro_torch.tree import tree_flatten
    la, lb = (tree_flatten(x, lambda v: v is None)[0] for x in (a, b))
    return len(la) == len(lb) and all(
        x is None and y is None or x is not None and y is not None and torch.equal(x, y)
        for x, y in zip(la, lb))


def _timing_ms(art) -> dict:
    """The last step's parts (the caller times the whole step itself)."""
    return {f"{k}_ms": v * 1e3 for k, v in art.step_fn.last_timing.items() if k != "step"}


def mesh_rank(rank: int, world: int, tmp: str, rdv: str, parts: list, device: str,
              backend: str = "gloo") -> None:
    """One spawned rank of ``world``: its process group over ``backend``,
    then each (part, config[, subdirectory]) of ``parts`` in turn,
    ``part(rank, world, dir, config, device)`` with ``dir`` ``tmp`` or its
    subdirectory, each part's tensors freed before the next. After each
    part rank 0 writes <dir>/<part's name>.done with the part's seconds
    (``await_part``: another process's (b) part waits for its reference's).
    The rank's allocator grows expandable segments, which leave no reserved
    but unallocated blocks behind."""
    import os
    if os.environ.get("PYTHONPYCACHEPREFIX"):    # bytecode_cache(): spawned with -B
        sys.dont_write_bytecode = False
    import ctypes
    import gc

    import torch
    import torch.distributed as dist

    # before the first CUDA allocation, which reads it: four ranks share the
    # card, and a rank's reserved but unallocated blocks would crowd the others
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    _mesh_init(rank, world, rdv, backend, device)
    for part, cfg, *sub in parts:
        where = os.path.join(tmp, *sub)
        t0 = time.perf_counter()
        part(rank, world, where, cfg, device)
        gc.collect()
        ctypes.CDLL("libc.so.6").malloc_trim(0)      # the freed host heap, back to the OS
        if device == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            done = os.path.join(where, f"{part.__name__}.done")
            with open(done + ".tmp", "w") as f:
                json.dump({"seconds": time.perf_counter() - t0}, f)
            os.replace(done + ".tmp", done)
    dist.destroy_process_group()


def await_part(where: str, name: str, timeout_s: float) -> dict:
    """The record of part ``name`` that another process finished in
    ``where`` (``mesh_rank`` writes it), waited for up to ``timeout_s``."""
    import os
    done = os.path.join(where, f"{name}.done")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name} did not finish in {where} within {timeout_s} s")
        time.sleep(0.5)
    with open(done) as f:
        return json.load(f)


def mesh_part_a(rank: int, world: int, tmp: str, t: dict, device: str) -> None:
    """Part (a) on one rank; its record goes to tmp/a_<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.instant import neighbor_backup
    from repro_torch.core.razor import razor_bytes_formula
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import param_count
    from repro_torch.parallel.sharding import is_spec
    from repro_torch.tree import tree_flatten, tree_map

    cfg, mesh, arts, make_state, local, _ = _mesh_build(world, t, device)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clone = lambda tree: tree_map(lambda x: x.clone(), tree, is_leaf=lambda v: v is None)
    art = arts[True]
    state = make_state(True)
    sync()
    rss = {"setup": host_rss_gb()}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    records, backup, before_last = [], None, None
    reset_launches()
    for i, batch in enumerate(local):
        if i == len(local) - 1:       # for the drill: the state after step i and its backup
            before_last = (clone(state), backup)
        t0 = time.perf_counter()
        state, metrics, backup = art.step_fn(state, batch)
        sync()
        records.append(dict(step=i + 1, step_ms=(time.perf_counter() - t0) * 1e3,
                            loss=float(metrics["loss"]), lr=float(metrics["lr"]),
                            grad_norm=float(art.step_fn.last_grad_norm),
                            **_timing_ms(art)))
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    peak_fsdp = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    rss["steps"] = host_rss_gb()

    # (i) this rank's backup is its predecessor's new optimizer blocks, bit for bit
    unique = tree_map(lambda ps, x: None if ps is None else x, art.backup_pspecs,
                      state["opt"], is_leaf=is_spec)
    every = [None] * world
    dist.all_gather_object(every, (_digests(torch, unique), _digests(torch, backup)))
    pred = (mesh.index("data") - 1) % world
    backup_bitwise = bool(every[rank][1]) and every[rank][1] == every[pred][0]
    # (ii) the bytes the ring sent
    sent = sum(x.numel() * x.element_size()
               for x in tree_flatten(backup, lambda v: v is None)[0] if x is not None)
    # (iii) the neighbour drill: rank 1 loses its optimizer blocks after step
    # n-1 and rebuilds them from rank 2's backup, sent back one hop; its FSDP
    # param blocks are cast from the rebuilt master (a replicated param, the
    # embedding, would come from any data peer). Step n from there must equal
    # the uninterrupted step n on every rank, bit for bit.
    restored, kept = before_last
    returned = neighbor_backup(kept, art.backup_pspecs, mesh, shift=-1)
    if mesh.index("data") == 1:
        for dst, src in zip(tree_flatten(restored["opt"])[0],
                            tree_flatten(returned, lambda v: v is None)[0]):
            if src is not None:
                dst.zero_()
                dst.copy_(src)
        for p, m in zip(tree_flatten(restored["params"])[0],
                        tree_flatten(restored["opt"]["master"])[0]):
            if p.shape == m.shape:
                p.zero_()
                p.copy_(m)
    del returned, kept, before_last
    drill_state, _, drill_backup = art.step_fn(restored, local[-1])
    drill_bitwise = _same(torch, drill_state, state) and _same(torch, drill_backup, backup)
    del drill_state, drill_backup, restored, unique
    rss["drill"] = host_rss_gb()
    # (v) the first batch scored again: the loss a step on a copy reports
    _, again, _ = art.step_fn(clone(state), local[0])
    first_batch_loss_after = float(again["loss"])
    del state, backup
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # fsdp_params=False once, for its device memory and step time
    plain = arts[False]
    state = make_state(False)
    t0 = time.perf_counter()
    state, metrics, _ = plain.step_fn(state, local[0])
    sync()
    no_fsdp = dict(step_ms=(time.perf_counter() - t0) * 1e3, loss=float(metrics["loss"]),
                   peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                   **_timing_ms(plain))
    rss["no_fsdp"] = host_rss_gb()
    rec = dict(rank=rank, records=records, launches=launches, flash_routes=flash_routes,
               peak_device_mem_gb=peak_fsdp, backup_bitwise=backup_bitwise,
               ring_bytes_sent=sent, razor_bytes=art.razor.unique_bytes_per_device_ring,
               formula_bytes=razor_bytes_formula(param_count(cfg), world),
               drill_bitwise=drill_bitwise, first_batch_loss_after=first_batch_loss_after,
               no_fsdp=no_fsdp, host_rss_gb=rss, host_rss_end_gb=host_rss_gb())
    with open(f"{tmp}/a_{rank}.json", "w") as f:
        json.dump(rec, f)


def _train_mesh_row(recs: list, t: dict, a_s: float, device: str) -> dict:
    """Part (a)'s checks (each failing the run) and its printed fields."""
    import numpy as np

    cfg = _mesh_cfg(t)
    steps = t["steps"]
    losses = [r["loss"] for r in recs[0]["records"]]
    flash = [r["launches"]["flash_attention"] for r in recs]
    if device == "cuda" and (
            min(flash) <= 0
            or any(r["launches"]["decode_attention"] or r["launches"]["ssd"] for r in recs)
            or any(v for r in recs for k, v in r["flash_routes"].items() if k != "wgmma")):
        fail(f"train_mesh: kernel launches {[r['launches'] for r in recs]}, flash routes "
             f"{[r['flash_routes'] for r in recs]}; expected flash launches in every rank, "
             "all on wgmma, and no decode or SSD launch")
    if not all(math.isfinite(x) for r in recs for x in (s["loss"] for s in r["records"])):
        fail(f"train_mesh: losses {[[s['loss'] for s in r['records']] for r in recs]}")
    if not all(r["backup_bitwise"] for r in recs):
        fail("train_mesh: a rank's backup differs from its predecessor's new optimizer blocks")
    if not all(r["ring_bytes_sent"] == r["razor_bytes"] for r in recs):
        fail(f"train_mesh: ring bytes {[r['ring_bytes_sent'] for r in recs]} against the "
             f"razor's {recs[0]['razor_bytes']}")
    if not all(r["drill_bitwise"] for r in recs):
        fail("train_mesh: the step after rebuilding rank 1 from its neighbour's backup "
             "differs from the uninterrupted step")
    if not recs[0]["first_batch_loss_after"] < losses[0]:
        fail(f"train_mesh: the first batch's loss {losses[0]} before the run, "
             f"{recs[0]['first_batch_loss_after']} after it; expected it to fall")

    def per_step(key):
        return [float(np.median([r["records"][i].get(key, 0.0) for r in recs]))
                for i in range(steps)]

    median_ms = float(np.median([s["step_ms"] for r in recs for s in r["records"][1:]]))

    row = dict(config=f"{cfg.name}, {cfg.num_layers} layers, {cfg.dtype}", world=t["world"],
               mesh="data=4, model=1", backend="gloo", device_note=MESH_NOTE,
               fsdp_params=True, instant_ckpt=True, global_batch=t["global_batch"],
               seq_len=t["seq_len"], tokens_per_rank=t["global_batch"] // t["world"]
               * t["seq_len"], steps=steps, losses=losses,
               grad_norms=[s["grad_norm"] for s in recs[0]["records"]],
               step_ms=per_step("step_ms"), grad_reduce_ms=per_step("grad_reduce_ms"),
               param_gather_ms=per_step("param_gather_ms"),
               neighbor_backup_ms=per_step("backup_ms"),
               median_step_ms=median_ms,
               tokens_per_s=t["global_batch"] * t["seq_len"] / (median_ms / 1e3),
               peak_device_mem_gb=[r["peak_device_mem_gb"] for r in recs],
               no_fsdp=[r["no_fsdp"] for r in recs],
               host_rss_end_gb=[r["host_rss_end_gb"] for r in recs],
               host_rss_gb_rank0=recs[0]["host_rss_gb"],
               host_rss_note="host_rss_end_gb: each rank's resident host memory when it "
                             "wrote its record (not ru_maxrss, which counts the parent's "
                             "pages at the spawn); host_rss_gb_rank0: rank 0's after its "
                             "setup, 2 steps, the drill and the step without FSDP",
               flash_launches=flash, flash_expected=2 * cfg.num_layers * steps,
               flash_note="per rank: the forward and its recompute in the backward (FSDP "
                          "recomputes each layer body, its gather included)",
               backup_bitwise=True, ring_bytes_sent=recs[0]["ring_bytes_sent"],
               razor_unique_bytes_per_device_ring=recs[0]["razor_bytes"],
               formula_12phi_over_dp=recs[0]["formula_bytes"],
               drill_bitwise=True, first_batch_loss_after=recs[0]["first_batch_loss_after"],
               seconds=a_s)
    return row


def tp_part_a(rank: int, world: int, tmp: str, t: dict, device: str) -> None:
    """Part (a) of train_tp (and train_moe_mesh) on one rank; its record goes
    to tmp/a_<rank>.json: per step its time, parts and the collectives over
    "model" the mesh counted beside ``model_collectives``, the flash calls'
    q and k shapes (and their pairs), the residual stream's shapes entering
    a layer body (an enc-dec's encoder and decoder bodies), the kernel
    launches, the ring's bytes, device memory, host RSS and, for an MoE,
    step 1's routing (its groups, capacity and drops)."""
    import gc

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.train.step import model_collectives
    from repro_torch.tree import tree_flatten

    cfg, mesh, arts, make_state, local, model = _mesh_build(world, t, device)
    q_shapes, kv_shapes, pairs, residual_shapes = set(), set(), set(), set()
    flash, run_layer = ops.flash_attention, transformer.run_layer

    def recording(q, k, *args, **kw):
        q_shapes.add(tuple(q.shape))
        kv_shapes.add(tuple(k.shape))
        pairs.add((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, *args, **kw)

    def layer(body, params, x, *rest, **kw):  # rest: a decoder layer's encoder output
        residual_shapes.add(tuple(x.shape))
        return run_layer(body, params, x, *rest, **kw)
    ops.flash_attention, transformer.run_layer = recording, layer
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    art = arts[True]
    formula = _counts(model_collectives(model, mesh, local[0]["tokens"].shape[0],
                                        t["seq_len"], fsdp_params=True))
    state = make_state(True)
    del make_state, model                       # the full weights
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sync()
    rss = {"setup": host_rss_gb()}
    free_gb = torch.cuda.mem_get_info()[0] / 1e9 if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    records, routing = [], None
    reset_launches()
    for i, batch in enumerate(local):
        mesh.reset_counts()
        backup = None                # the last step's, freed before this one's comes
        with moe.record_routing() as log:
            t0 = time.perf_counter()
            state, metrics, backup = art.step_fn(state, batch)
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3
        if i == 0 and log:
            routing = dict(dropped=sum(int((~r["valid"]).sum()) for r in log),
                           assignments=sum(r["valid"].numel() for r in log),
                           capacity=log[0]["capacity"], groups=log[0]["top_e"].shape[0])
        del log
        records.append(dict(step=i + 1, step_ms=step_ms, loss=float(metrics["loss"]),
                            aux=float(metrics["aux"]), lr=float(metrics["lr"]),
                            grad_norm=float(art.step_fn.last_grad_norm),
                            model_collectives=_counts({k: v for k, v in mesh.counts.items()
                                                       if k[1] == ("model",)}),
                            **_timing_ms(art)))
        rss[f"step{i + 1}"] = host_rss_gb()
    launches = read_launches()
    sent = sum(x.numel() * x.element_size()
               for x in tree_flatten(backup, lambda v: v is None)[0] if x is not None)
    # what the specs give: this rank's blocks of the razor-unique leaves, and
    # the bytes a data rank of those leaves that "model" does not split (each
    # model rank sends them: the razor's per-device figure counts them once)
    unique = [(spec, leaf) for spec, leaf, keep in zip(
        tree_flatten(art.plan.opt_pspecs, shd.is_spec)[0],
        tree_flatten(art.plan.state_specs["opt"])[0],
        tree_flatten(art.razor.unique_mask)[0]) if keep]
    block_bytes = sum(math.prod(shd.block_shape(spec, tuple(leaf.shape), mesh))
                      * leaf.dtype.itemsize for spec, leaf in unique)
    model_replicated = sum(math.prod(leaf.shape) * leaf.dtype.itemsize for spec, leaf in unique
                           if shd.sharded_dim(spec, "model") is None) // mesh.shape["data"]
    rec = dict(rank=rank, coords=mesh.coords, records=records, formula=list(formula),
               block_bytes=block_bytes, model_replicated_bytes=model_replicated,
               launches=launches, flash_routes=dict(fa.flash_attention.routes),
               flash_q_shapes=sorted(q_shapes), flash_kv_shapes=sorted(kv_shapes),
               flash_pairs=sorted(pairs), residual_shapes=sorted(residual_shapes),
               routing=routing,
               peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               device_free_gb_setup=free_gb,
               ring_bytes_sent=sent, razor_bytes=art.razor.unique_bytes_per_device_ring,
               host_rss_gb=rss)
    with open(f"{tmp}/a_{rank}.json", "w") as f:
        json.dump(rec, f)


def _rank_heads(cfg, model: int) -> tuple:
    """A rank's q heads at "model" size ``model`` and its kv heads, as
    attention._kv_weights picks them: its share where they divide the axis,
    else (replicated) the one its q heads share where they read one, else
    one for each q head."""
    heads = cfg.num_heads // model
    group = cfg.num_heads // cfg.num_kv_heads
    kv_heads = (cfg.num_kv_heads // model if cfg.num_kv_heads % model == 0
                else 1 if group % heads == 0 else heads)
    return heads, kv_heads


def layers(cfg) -> str:
    """A config's depth as a row prints it: an enc-dec's encoder + decoder."""
    encoder = f"{cfg.encoder_layers} + " if cfg.encoder_layers else ""
    return f"{encoder}{cfg.num_layers} layers"


def attention_calls(cfg) -> int:
    """The flash calls of one forward: one a layer, an enc-dec's decoder
    layers two (self- and cross-attention)."""
    return cfg.encoder_layers + 2 * cfg.num_layers if cfg.encoder_layers else cfg.num_layers


def passes(cfg) -> int:
    """The forwards of a layer body that autograd runs for one loss: one,
    and once more where the config's remat_policy recomputes the body in
    the backward (models.modes.run_layer; the full configs' "full")."""
    return 1 if cfg.remat_policy == "none" else 2


def _train_tp_row(phase: str, recs: list, t: dict, a_s: float, device: str,
                  mesh_row=None) -> dict:
    """Part (a)'s checks (each failing the run) and its printed fields, for
    train_tp (against ``mesh_row``, train_mesh (a)'s on (4, 1)) and
    train_moe_mesh (the routing: a rank's groups of the global batch's 16,
    and drops)."""
    import numpy as np

    from repro_torch.models import param_count
    from repro_torch.models.moe import moe_groups

    cfg = _mesh_cfg(t)
    steps, data = t["steps"], t["world"] // t["model"]
    rows = t["global_batch"] // data
    heads, kv_heads = _rank_heads(cfg, t["model"])
    hd, seq = cfg.resolved_head_dim, t["seq_len"]
    q_shape, kv_shape = [rows, seq, heads, hd], [rows, seq, kv_heads, hd]
    # an enc-dec: the encoder's attention over the frames, the decoder's over
    # the tokens and its cross-attention of the tokens against the frames
    enc = [rows, cfg.encoder_seq, heads, hd]
    pairs = (sorted([[enc, enc], [q_shape, kv_shape], [q_shape, enc]]) if cfg.encoder_layers
             else [[q_shape, kv_shape]])
    flash = [r["launches"]["flash_attention"] for r in recs]
    expected = 2 * attention_calls(cfg) * steps    # the forward and FSDP's recompute
    if device == "cuda" and (
            flash != [expected] * len(recs)
            or any(r["launches"]["decode_attention"] or r["launches"]["ssd"] for r in recs)
            or any(v for r in recs for k, v in r["flash_routes"].items() if k != "wgmma")
            or any(r["flash_pairs"] != pairs for r in recs)):
        fail(f"{phase}: kernel launches {[r['launches'] for r in recs]}, flash routes "
             f"{[r['flash_routes'] for r in recs]}, (q, k) shapes "
             f"{[r['flash_pairs'] for r in recs]}; expected {expected} flash launches in "
             f"every rank, all on wgmma at (q, k) {pairs}, and no decode or SSD launch")
    if not all(math.isfinite(s["loss"]) for r in recs for s in r["records"]):
        fail(f"{phase}: losses {[[s['loss'] for s in r['records']] for r in recs]}")
    extra = {}
    if mesh_row is not None:
        # the same weights and global batches as train_mesh (a) on (4, 1): the
        # first step's loss and global gradient norm agree within bf16 tolerances
        first, ref = recs[0]["records"][0], mesh_row
        vs_mesh = dict(loss_rel_err=abs(first["loss"] - ref["losses"][0]) / abs(ref["losses"][0]),
                       grad_norm_rel_err=abs(first["grad_norm"] - ref["grad_norms"][0])
                       / ref["grad_norms"][0])
        extra["vs_train_mesh"] = dict(vs_mesh, **TP_VS_MESH, mesh_losses=ref["losses"],
                                      mesh_grad_norms=ref["grad_norms"])
    if mesh_row is not None and (vs_mesh["loss_rel_err"] > TP_VS_MESH["loss_rtol"]
                                 or vs_mesh["grad_norm_rel_err"] > TP_VS_MESH["grad_norm_rtol"]):
        fail(f"{phase}: step 1 loss {first['loss']} and gradient norm {first['grad_norm']} "
             f"against train_mesh's {ref['losses'][0]} and {ref['grad_norms'][0]} on (4, 1): "
             f"{vs_mesh}, tolerances {TP_VS_MESH}")
    counts = [s["model_collectives"] for r in recs for s in r["records"]]
    if any(c != recs[0]["formula"] for c in counts):
        fail(f"{phase}: collectives over 'model' [op, axes, calls, bytes] {counts}, the "
             f"formula {recs[0]['formula']}")
    # the reference's constrain(x, BATCH, "model", None): the sequence splits
    # over "model" where that axis divides it, and every layer body's input
    # is then the rank's block of positions; an enc-dec's bodies have no such
    # constraint, and its streams (the encoder's frames, the decoder's
    # tokens) stay whole
    sp = seq % t["model"] == 0 and not cfg.encoder_layers
    residual = [rows, seq // t["model"] if sp else seq, cfg.d_model]
    residuals = (sorted([[rows, cfg.encoder_seq, cfg.d_model], residual])
                 if cfg.encoder_layers else [residual])
    kinds = {c[0] for c in recs[0]["formula"]}
    if (any(r["residual_shapes"] != residuals for r in recs)
            or sp != ({"all_gather", "reduce_scatter"} <= kinds)
            or not sp and kinds != {"all_reduce"}):
        fail(f"{phase}: residual streams {[r['residual_shapes'] for r in recs]} and "
             f"collectives {sorted(kinds)}; expected {residuals} in every rank"
             + (", gathers and reduce-scatters" if sp else ", all-reduces alone"))
    group = sum(r["ring_bytes_sent"] for r in recs if r["coords"]["data"] == 0)
    razor = recs[0]["razor_bytes"] + (t["model"] - 1) * recs[0]["model_replicated_bytes"]
    if not all(r["ring_bytes_sent"] == r["block_bytes"] for r in recs) or group != razor:
        fail(f"{phase}: ring bytes {[r['ring_bytes_sent'] for r in recs]} against the "
             f"unique blocks' {[r['block_bytes'] for r in recs]}; a model group's "
             f"{group} against the razor's {recs[0]['razor_bytes']} + "
             f"{t['model'] - 1} x {recs[0]['model_replicated_bytes']}")

    if cfg.is_moe:
        routing = [r["routing"] for r in recs]
        groups = moe_groups(t["global_batch"] * t["seq_len"]) // data
        if any(x["groups"] != groups or x["dropped"] <= 0 for x in routing):
            fail(f"{phase}: routing {routing}; expected {groups} groups a rank of the global "
                 "batch's, and dropped assignments")
        extra.update(routing_step1=routing[0], dropped_per_rank=[x["dropped"] for x in routing],
                     routing_note="rank 0's MoE calls of step 1's forward: its groups of the "
                                  "global batch's and the global capacity; every rank's "
                                  "dropped assignments above 0")

    def per_step(key):
        return [float(np.median([r["records"][i].get(key, 0.0) for r in recs]))
                for i in range(steps)]

    median_ms = float(np.median([s["step_ms"] for r in recs for s in r["records"][1:]]))
    return dict(config=f"{cfg.name}, {layers(cfg)}, {cfg.dtype}",
                param_count=param_count(cfg), world=t["world"],
                mesh=f"data={data}, model={t['model']}", backend="gloo", device_note=MESH_NOTE,
                fsdp_params=True, instant_ckpt=True, global_batch=t["global_batch"],
                seq_len=t["seq_len"], tokens_per_data_rank=rows * t["seq_len"], steps=steps,
                losses=[s["loss"] for s in recs[0]["records"]],
                aux=[s["aux"] for s in recs[0]["records"]],
                grad_norms=[s["grad_norm"] for s in recs[0]["records"]],
                step_ms=per_step("step_ms"), tp_reduce_ms=per_step("tp_reduce_ms"),
                grad_reduce_ms=per_step("grad_reduce_ms"),
                param_gather_ms=per_step("param_gather_ms"),
                neighbor_backup_ms=per_step("backup_ms"), median_step_ms=median_ms,
                tokens_per_s=t["global_batch"] * t["seq_len"] / (median_ms / 1e3),
                step_note="medians over the ranks; tp_reduce: every collective over "
                          "'model', forward, backward and the summed leaves' gradients",
                sequence_parallel=sp, residual_shapes=residuals,
                model_collectives=recs[0]["formula"],
                model_collectives_note="[op, axes, calls, bytes] a rank and step, equal on "
                                       "every rank and step to train.step.model_collectives",
                before_sp=BEFORE_SP.get(phase),
                before_sp_note="what the same phase recorded before the residual stream "
                               "was split by sequence (H100 80GB HBM3, 700.00 W; another "
                               "host and call, so host times compare only roughly)",
                **extra, peak_device_mem_gb=[r["peak_device_mem_gb"] for r in recs],
                device_free_gb_setup=[r["device_free_gb_setup"] for r in recs],
                host_rss_gb=[r["host_rss_gb"] for r in recs],
                host_rss_note="per rank: resident host memory after its setup and after "
                              "each step",
                flash_launches=flash, flash_expected=expected, flash_q_k_shapes=pairs,
                decode_launches=[r["launches"]["decode_attention"] for r in recs],
                ssd_launches=[r["launches"]["ssd"] for r in recs],
                flash_note="per rank: the forward and its recompute in the backward (FSDP "
                           "recomputes each layer body), at the rank's share of the q heads"
                           + ("; each encoder layer one, each decoder layer two (self- "
                              "and cross-attention)" if cfg.encoder_layers else ""),
                ring_bytes_sent=[r["ring_bytes_sent"] for r in recs],
                ring_bytes_model_group=group,
                razor_unique_bytes_per_device_ring=recs[0]["razor_bytes"],
                unique_model_replicated_bytes=recs[0]["model_replicated_bytes"],
                ring_note="each rank sends its blocks of the razor-unique leaves; a model "
                          "group's sum is the razor's per-device bytes plus (model - 1) "
                          "copies of the unique leaves that 'model' does not split",
                seconds=a_s)


def single_part_b(rank: int, world: int, tmp: str, tb: dict, device: str) -> None:
    """Part (b)'s reference: one rank of the same step on the global batch,
    tb["steps"] FSDP steps (uncompressed: one rank is one pod). After each
    it saves to tmp/single_step<i>.pt the loss, the global gradient norm,
    the optimizer leaves of tb["held"] (each whole, fp32, keyed
    "<part>|<leaf>") with each one's largest magnitude, and the routing of
    every MoE call of the forward (top_e, pos, valid, the gate
    probabilities and their smallest k-th / (k+1)-th gap; none for a dense
    model)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.tree import keystr, tree_flatten_with_path

    cfg, _, arts, make_state, local, model = _mesh_build(world, tb, device)
    art = arts[True]
    state = make_state(True)
    del make_state, model
    for i, batch in enumerate(local):
        with moe.record_routing() as log:
            state, metrics, _ = art.step_fn(state, batch)
        opt = {f"{part}|{keystr(p)}": x for part in tb["held"]
               for p, x in tree_flatten_with_path(state["opt"][part])}
        torch.save({"loss": float(metrics["loss"]),
                    "grad_norm": float(art.step_fn.last_grad_norm),
                    "opt": {k: x.cpu() for k, x in opt.items()},
                    "max": {k: float(x.abs().max()) for k, x in opt.items()},
                    "routing": [{"top_e": r["top_e"].cpu(), "pos": r["pos"].cpu(),
                                 "valid": r["valid"].cpu(), "gate_probs": r["gate_probs"].cpu(),
                                 "gap": _gate_gap(r["gate_probs"], cfg.top_k)} for r in log]},
                   f"{tmp}/single_step{i}.pt")
        del log, opt


def _gate_gap(gate_probs, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th gate probability."""
    top = gate_probs.float().topk(k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def _record_pod_scales(scales: list):
    """Wrap the compressed cross-pod mean so that each call appends to
    ``scales`` the int8 scale of every leaf as the reference defines it:
    the largest |g| of the whole leaf over all pods (every rank's block, a
    MAX over the world) / 127, taken from the mean's inputs. Returns the
    function that puts the original back."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import compression
    mean = compression.pod_compressed_mean

    def recording(grads, mesh, axis="pod"):
        top = torch.stack([g.detach().float().abs().max() for g in grads])
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        scales.append(top / 127.0)
        return mean(grads, mesh, axis)

    compression.pod_compressed_mean = recording
    return lambda: setattr(compression, "pod_compressed_mean", mean)


def blocks_part_b(rank: int, world: int, tmp: str, tb: dict, device: str) -> None:
    """Part (b) on one of the sharded ranks, after part (a): tb["steps"]
    FSDP steps in fp32; after each, this rank's blocks of the tb["held"]
    optimizer leaves against the one rank's (``single_part_b``), each
    leaf's largest difference relative to the one rank's largest
    magnitude, and its routing against the one rank's groups at its data
    index. m's limit a leaf, per element: tb["grad_tol"] of its largest
    magnitude and, with int8 cross-pod compression, the error the rounding
    makes of it (``_int8_m_bound``); the share of that limit an element
    uses most is recorded. Rank 0 writes the steps and its kernel launches
    to tmp/blocks_b.json."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import keystr, tree_flatten, tree_flatten_with_path

    _, mesh, arts, make_state, local, model = _mesh_build(world, tb, device)
    art = arts[True]
    state = make_state(True)
    del make_state, model
    gc.collect()
    specs = {part: tree_flatten(art.plan.opt_pspecs[part], shd.is_spec)[0]
             for part in tb["held"]}
    data_index = mesh.index("data")
    scales, restore = [], None
    if tb.get("compress_pod_grads"):
        restore = _record_pod_scales(scales)
    hp, bound, prev = AdamWConfig(), {}, None
    steps = []
    reset_launches()
    for i, batch in enumerate(local):
        with moe.record_routing() as log:
            state, metrics, _ = art.step_fn(state, batch)
        if i == 0:
            await_part(tmp, "single_part_b", tb["timeout_s"])
        ref = torch.load(f"{tmp}/single_step{i}.pt", mmap=True)
        clip = [min(1.0, hp.grad_clip / max(n, 1e-9))
                for n in (float(art.step_fn.last_grad_norm), ref["grad_norm"])]
        err, over = {}, {}
        for part in tb["held"]:
            for j, ((path, x), spec) in enumerate(zip(
                    tree_flatten_with_path(state["opt"][part]), specs[part])):
                key = f"{part}|{keystr(path)}"
                int8 = (dict(scale=float(scales[i][j]), clip=clip, pods=mesh.shape["pod"],
                             b1=hp.b1) if part == "m" and scales else None)
                before = (shd.local_block(prev["opt"][key], spec, mesh)
                          if int8 and prev is not None else None)
                diff, share, bound[key] = _block_error(
                    x, shd.local_block(ref["opt"][key], spec, mesh), before, bound.get(key),
                    tb["grad_tol"] * ref["max"][key] if part == "m" else None, int8)
                err[key] = diff / max(ref["max"][key], 1e-30)
                if share is not None:
                    over[key] = share
        routing = _routing_against(log, ref["routing"], data_index)
        steps.append(dict(step=i + 1, lr=float(metrics["lr"]), loss=float(metrics["loss"]),
                          single_loss=ref["loss"], clip=clip, err=err, over=over, **routing,
                          min_gate_gap=min([r["gap"] for r in ref["routing"]], default=None),
                          dropped=sum(int((~r["valid"]).sum()) for r in ref["routing"]),
                          assignments=sum(r["valid"].numel() for r in ref["routing"])))
        del log
        prev = ref
    if restore is not None:
        restore()
    launches = dict(read_launches(), flash_routes=dict(fa.flash_attention.routes))
    every = [None] * world
    dist.all_gather_object(every, (mesh.coords, steps))
    if rank == 0:
        out = []
        for i, st in enumerate(steps):
            per_rank = [s[i] for _, s in every]
            first = [s[i] for c, s in every if c["model"] == 0 and c.get("pod", 0) == 0]
            out.append(dict(st, **{k: {key: max(s[k][key] for s in per_rank) for key in st[k]}
                                   for k in ("err", "over")},
                            **{k: sum(s[k] for s in first) for k in _ROUTING_COUNTS},
                            explained_gap_max=max(s["explained_gap_max"] for s in per_rank),
                            gate_noise=max(s["gate_noise"] for s in per_rank),
                            unexplained_on_any_rank=any(
                                s["unexplained_flips"] or s["unexplained_diffs"]
                                for s in per_rank)))
        with open(f"{tmp}/blocks_b.json", "w") as f:
            json.dump(dict(steps=out, launches=launches), f)


def _block_error(x, block, before, bound, limit, int8, piece: int = 1 << 24):
    """The largest |x - block| (x this rank's leaf on its device, block the
    one rank's block of it on the host), taken ``piece`` elements at a time
    so that the copies on the card stay small. With ``limit`` (m's) also
    the largest share of each element's limit that it uses: ``limit`` plus,
    with ``int8`` (the compressed step's scale, clip factors, pod count and
    b1), ``_int8_m_bound`` from ``before`` (the one rank's block of the
    last step, or None) and ``bound`` (the last step's, flat on the host,
    or None). Returns the difference, the share (None without a limit) and
    this step's bound (None without ``int8``)."""
    import torch
    xf, rf = x.reshape(-1), block.reshape(-1)
    pf = before.reshape(-1) if before is not None else None
    new = torch.empty_like(rf) if int8 else None
    diff, share = 0.0, None
    for lo in range(0, xf.numel(), piece):
        part = slice(lo, lo + piece)
        r = rf[part].to(x.device)
        d = (xf[part] - r).abs()
        diff = max(diff, float(d.max()))
        if limit is None:
            continue
        lim = limit
        if int8:
            b = _int8_m_bound(None if bound is None else bound[part].to(x.device), r,
                              None if pf is None else pf[part].to(x.device), **int8)
            new[part] = b.cpu()
            lim = b + limit
        share = max(share or 0.0, float((d / lim).max()))
    return diff, share, new


def _int8_m_bound(before, m_exact, m_exact_prev, scale: float, clip: list, pods: int,
                  b1: float):
    """The most by which each element of m may differ between the step with
    int8 cross-pod compression and the exact one, this step (tensors of
    this rank's block). A pod's compressed mean is (g_p + sum of the other
    pods' q s) / pods, each q s within s / 2 of its g: it is off the exact
    mean by at most (pods - 1) s / (2 pods). m adds (1 - b1) of the clipped
    gradient: off by (1 - b1) c s (pods - 1) / (2 pods), c the compressed
    step's clip factor, plus what the two steps' clip factors (clip: the
    compressed one's and the exact one's) make of the exact term, |c / c_e
    - 1| |m_e - b1 m_e'|; and b1 times the last step's bound. It holds
    while both runs' steps start from the same weights: the first step's
    learning rate is 0 under the warmup."""
    term = m_exact if m_exact_prev is None else m_exact - b1 * m_exact_prev
    out = ((1 - b1) * clip[0] * scale * (pods - 1) / (2 * pods)
           + abs(clip[0] / clip[1] - 1) * term.abs())
    return out if before is None else b1 * before + out


_ROUTING_COUNTS = ("flips", "explained_flips", "unexplained_flips", "pos_diff", "valid_diff",
                   "unexplained_diffs")


def _routing_against(log: list, ref: list, data_index: int) -> dict:
    """This rank's routing of every MoE call (its groups of the global
    batch) against the one rank's, at its data index. A flipped assignment
    (another expert in a top-k slot) is explained where the one rank's gap
    between the two experts' gate probabilities is within twice the largest
    difference between the two runs' gate probabilities (``gate_noise``):
    the two reduction orders' rounding decides it. Positions and capacity
    verdicts may then differ in that group only; every other difference is
    unexplained."""
    import torch

    if len(log) != len(ref):
        fail(f"train_moe_mesh (b): {len(log)} MoE calls against {len(ref)}")
    out = dict.fromkeys(_ROUTING_COUNTS, 0)
    out.update(explained_gap_max=0.0, gate_noise=0.0)
    for mine, full in zip(log, ref):
        g = mine["top_e"].shape[0]             # this rank's groups of the global batch
        part = slice(data_index * g, (data_index + 1) * g)
        probs, probs_ref = mine["gate_probs"].cpu(), full["gate_probs"][part]
        top, top_ref = mine["top_e"].cpu(), full["top_e"][part]
        noise = float((probs - probs_ref).abs().max())
        out["gate_noise"] = max(out["gate_noise"], noise)
        flipped = set()
        for gi, ti, si in (top != top_ref).nonzero().tolist():
            a, b = int(top_ref[gi, ti, si]), int(top[gi, ti, si])
            gap = float((probs_ref[gi, ti, a] - probs_ref[gi, ti, b]).abs())
            out["flips"] += 1
            if gap <= 2 * noise:
                out["explained_flips"] += 1
                out["explained_gap_max"] = max(out["explained_gap_max"], gap)
                flipped.add(gi)
            else:
                out["unexplained_flips"] += 1
        for key, diff in (("pos_diff", mine["pos"].cpu() != full["pos"][part]),
                          ("valid_diff", mine["valid"].cpu() != full["valid"][part])):
            out[key] += int(diff.sum())
            keep = torch.ones(g, dtype=torch.bool)
            keep[sorted(flipped)] = False
            out["unexplained_diffs"] += int(diff[keep].sum())
    return out


def await_reference(rank: int, world: int, tmp: str, tb: dict, device: str) -> None:
    """A part that waits until the (b) reference of ``tmp``'s phase has
    finished: that reference and the phase's ranks do not fit the card
    together."""
    await_part(tmp, "single_part_b", tb["timeout_s"])


TRAIN_MESH_PHASES = ("train_mesh", "train_moe_mesh", "train_gemma_mesh", "train_vlm_mesh")


def phase_train_group(torch, tmp: dict, vlm_ref: tuple, device: str = "cuda") -> tuple:
    """The sharded train phases (train_mesh, train_tp, train_moe_mesh,
    train_gemma_mesh, train_vlm_mesh) in one set of four spawned gloo ranks,
    each phase's (a) then (b) in turn in ``tmp``'s directory of its phase,
    beside one single-rank NCCL process that runs the (b) references of
    train_mesh (which train_tp's (b) reads too), train_gemma_mesh and
    train_moe_mesh meanwhile, in that order: one start-up of each, and the
    references off the ranks' path. internvl2-26b's reference (``vlm_ref``,
    38 GB, started beside the light phases before) is waited for before the
    ranks start, and train_moe_mesh's (a) waits for its reference
    (``await_reference``): the card holds no two of the largest (internvl2's
    reference, qwen2-moe's, a heavy phase's ranks) at once. Prints each
    phase's lines (a phase's seconds are its rank 0's (a) and (b), start-up
    excluded) and a train_group line with every part's seconds; returns the
    phases' rows in that order, each with its (b) under "part_b"."""
    import os
    import tempfile
    phases = (("train_mesh", TRAIN_MESH, TRAIN_MESH_B, mesh_part_a),
              ("train_tp", TRAIN_TP, TRAIN_TP_B, tp_part_a),
              ("train_moe_mesh", TRAIN_MOE, TRAIN_MOE_B, tp_part_a),
              ("train_gemma_mesh", TRAIN_GEMMA, TRAIN_GEMMA_B, tp_part_a),
              ("train_vlm_mesh", TRAIN_VLM, TRAIN_VLM_B, tp_part_a))
    dirs = dict(tmp, train_tp=os.path.join(tmp["train_mesh"], "tp"))
    # train_tp's (b) reads train_mesh's reference: the one-rank step has no
    # "model" axis, so TRAIN_TP_B's is TRAIN_MESH_B's
    os.makedirs(dirs["train_tp"])
    for name in ["single_part_b.done"] + [f"single_step{i}.pt"
                                          for i in range(TRAIN_TP_B["steps"])]:
        os.symlink(os.path.join(dirs["train_mesh"], name), os.path.join(dirs["train_tp"], name))
    refs = [(single_part_b, tb, dirs[phase]) for phase, tb in (
        ("train_mesh", TRAIN_MESH_B), ("train_gemma_mesh", TRAIN_GEMMA_B),
        ("train_moe_mesh", TRAIN_MOE_B))]
    parts = []
    for phase, t, tb, part_a in phases:
        if phase == "train_moe_mesh":
            parts.append((await_reference, tb, dirs[phase]))
        parts += [(part_a, t, dirs[phase]), (blocks_part_b, tb, dirs[phase])]
    wait_children(*vlm_ref)
    parent = dict(parent_host_rss_gb=host_rss_gb(), parent_device_reserved_gb=None)
    if device == "cuda":
        torch.cuda.empty_cache()
        parent["parent_device_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    world = TRAIN_MESH["world"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_group_") as root:
        t0 = time.perf_counter()
        run_children("train_group",
                     [(mesh_rank, (0, 1, root, f"{root}/rdv_single", refs, device,
                                   "nccl" if device == "cuda" else "gloo"))]
                     + [(mesh_rank, (r, world, root, f"{root}/rdv", parts, device))
                        for r in range(world)],
                     sum(cfg["timeout_s"] for _, cfg, _ in parts))
        seconds = time.perf_counter() - t0

    def secs(where: str, part) -> float:
        with open(os.path.join(where, f"{part.__name__}.done")) as f:
            return json.load(f)["seconds"]

    def load(phase: str, name: str):
        with open(os.path.join(dirs[phase], name)) as f:
            return json.load(f)

    rows, mesh_row = [], None
    for phase, t, tb, part_a in phases:
        recs = [load(phase, f"a_{r}.json") for r in range(world)]
        a_s = secs(dirs[phase], part_a) + secs(dirs[phase], blocks_part_b)
        if phase == "train_mesh":
            row = mesh_row = _train_mesh_row(recs, t, a_s, device)
        else:
            row = _train_tp_row(phase, recs, t, a_s, device,
                                mesh_row if phase == "train_tp" else None)
        row = dict(row, **parent)
        emit(phase, **row)
        part_b = _blocks_b_row(phase, load(phase, "blocks_b.json"), tb,
                               secs(dirs[phase], single_part_b), device)
        emit(f"{phase}_world1", **part_b)
        rows.append(dict(row, part_b=part_b))
    emit("train_group", seconds=seconds,
         rank0_part_s=[[os.path.relpath(d, os.path.dirname(dirs["train_mesh"])), part.__name__,
                        secs(d, part)] for part, _, d in parts],
         reference_part_s=[[os.path.basename(d), secs(d, single_part_b)] for _, _, d in refs],
         note="one set of four gloo ranks runs every part in turn; one NCCL process runs "
              "the references meanwhile (each (b) part waits for its own, train_moe_mesh's "
              "(a) too); a part's seconds are its rank 0's or the reference process's, "
              "start-up excluded")
    return tuple(rows)


def _blocks_b_row(phase: str, part_b: dict, tb: dict, single_s, device: str) -> dict:
    """Part (b)'s checks: the losses within tb["tol"] of one NCCL rank, every
    element of m within its limit (``blocks_part_b``), the master of step 1
    (lr 0 under the warmup) within tb["tol"] where it is held, an MoE's
    routing equal, rank 0's flash launches all on the fp32 route."""
    cfg = _mesh_cfg(tb)
    tol, compressed = tb["tol"], tb.get("compress_pod_grads", False)
    steps_b, launches = part_b["steps"], part_b["launches"]
    bad = []
    if compressed and len(steps_b) > 1 and steps_b[0]["lr"] != 0:
        bad.append(f"step 1's learning rate {steps_b[0]['lr']}: the int8 bound of m holds "
                   "only while both runs start each step from the same weights")
    for st in steps_b:
        if abs(st["loss"] - st["single_loss"]) > tol * abs(st["single_loss"]):
            bad.append(f"step {st['step']} loss {st['loss']} vs {st['single_loss']}")
        bad += [f"step {st['step']} {k}: {st['err'][k]} of its largest value, {x} of its "
                "limit" for k, x in st["over"].items() if x > 1]
        if st["step"] == 1:
            bad += [f"step 1 {k}: {e} (limit {tol})" for k, e in st["err"].items()
                    if k.startswith("master|") and e > tol]
        if st["unexplained_on_any_rank"]:
            bad.append(f"step {st['step']} routing: {st['unexplained_flips']} flipped "
                       f"assignments beyond the gate noise {st['gate_noise']}, "
                       f"{st['unexplained_diffs']} positions or capacity verdicts differing in "
                       f"groups without such a flip ({st['flips']} flips, {st['pos_diff']} "
                       f"positions, {st['valid_diff']} verdicts in all; smallest gate gap "
                       f"{st['min_gate_gap']})")
    # the fp32 route of flash in every layer and microbatch, forward and recompute
    flash = 2 * attention_calls(cfg) * tb["steps"] * tb.get("microbatches", 1)
    if device == "cuda" and launches["flash_routes"] != {"wgmma": 0, "fp32": flash}:
        bad.append(f"flash routes {launches['flash_routes']} on rank 0, expected {flash} fp32")
    if bad:
        fail(f"{phase} (b): sharded against one nccl rank: " + "; ".join(bad))
    model_axis, pods = tb.get("model", 1), tb.get("pod", 1)
    routing = ("; every MoE call's top-k experts, positions and capacity verdicts equal (a "
               "rank's groups the one rank's, at its data index) but for flips explained by "
               "the gate noise: the one rank's gap between the two experts within twice the "
               "largest difference of the two runs' gate probabilities (exact ties among "
               "them), and the positions and verdicts of their groups; each counted"
               if cfg.is_moe else "")
    limit = (f"grad_tol ({tb['grad_tol_why']}) of its leaf's largest value" + (
        " plus the error int8 cross-pod compression makes of it: (1 - b1) c s / 4 a step "
        "for 2 pods, s the whole leaf's scale (the largest |g| of every pod's block / 127, "
        "recorded from the compressed mean's inputs) and c the step's clip factor, what "
        "the two runs' clip factors make of the exact term, and b1 times the last step's"
        if compressed else ""))
    return dict(config=f"{cfg.name}, {layers(cfg)}, fp32",
                sharded=f"{tb['world']} gloo ranks",
                against="one rank over nccl" + (", uncompressed" if compressed else ""),
                mesh=(f"pod={pods}, " if pods > 1 else "")
                + f"data={tb['world'] // (model_axis * pods)}, model={model_axis}",
                compress_pod_grads=compressed, microbatches=tb.get("microbatches", 1),
                instant_ckpt=tb.get("instant_ckpt", True), tol=tol, grad_tol=tb["grad_tol"],
                single_rank_s=single_s, launches=launches,
                steps=[dict(step=st["step"], lr=st["lr"], loss=st["loss"],
                            single_loss=st["single_loss"],
                            loss_rel_err=abs(st["loss"] - st["single_loss"])
                            / abs(st["single_loss"]),
                            **{f"{part}_rel_err_max": max(e for k, e in st["err"].items()
                                                          if k.startswith(part + "|"))
                               for part in tb["held"]},
                            m_share_of_limit_max=max(st["over"].values()),
                            **(dict(clip_factors=st["clip"]) if compressed else {}),
                            **(dict(m_rel_err_moe=max(e for k, e in st["err"].items()
                                                      if "|moe|" in k),
                                    flipped_assignments=st["flips"],
                                    explained_flips=st["explained_flips"],
                                    explained_gap_max=st["explained_gap_max"],
                                    gate_noise=st["gate_noise"],
                                    positions_differ=st["pos_diff"],
                                    valid_differs=st["valid_diff"],
                                    min_gate_gap=st["min_gate_gap"],
                                    dropped_assignments=st["dropped"],
                                    assignments=st["assignments"]) if cfg.is_moe else {}))
                       for st in steps_b],
                note=f"held: the losses within tol; every element of m, each rank's block "
                     f"against the one rank's, within {limit}"
                     + ("; the master of step 1 (lr 0) within tol; v and the later master "
                        "reported" if "master" in tb["held"] else "")
                     + f"; rank 0's {flash} flash launches on the fp32 route" + routing)


# Serving on a mesh (train.serve's mesh builders): gemma-2b, whose one kv
# head cannot split over "model", so its KV cache splits by sequence alone.
# (a) full width and depth (18 layers), bf16, four gloo ranks sharing the
# card on (data 2, model 2): 8 prompts of 1,000 tokens and 32 greedy tokens
# (a rank's 4 rows and 516 of the 1,032 cache positions), after a warm-up
# of ``warmup_gen`` tokens. (b) the same ranks at 2 layers in fp32 against
# one unsharded rank (its own process over NCCL): the logits of the prefill
# and of every decode step at ``tol``, the greedy tokens exactly, each cache
# block against its slice of the one rank's cache.
SERVE_MESH = dict(arch="gemma-2b", smoke=False, layers=None, dtype="bfloat16", world=4,
                  data=2, model=2, seed=0, draw="cuda", batch=SERVE["batch"],
                  prompt=SERVE["prompt"], gen=SERVE["gen"],
                  max_len=SERVE["prompt"] + SERVE["gen"], warmup_gen=2, timeout_s=600)
SERVE_MESH_B = dict(SERVE_MESH, layers=2, dtype="float32", gen=9, tol=SLICE_TOL,
                    timeout_s=300)
# the VLM served on a mesh: internvl2-26b at full width (48 q / 8 kv heads of
# 128: the kv heads split over "model", the cache by sequence) on (data 2,
# model 2), 8 prompts of 1,000 tokens behind 1,024 patch embeddings (N(0, 1)
# drawn on the card from a seed), 32 greedy tokens, a cache of 2,056
# positions (a rank's 1,028: rank 0's all patches, so decode's block form
# runs on a full block there and a filling one on rank 1). (a) bf16, cut to
# 12 of 48 layers: each rank draws the whole cut model, 11.6 GB, before it
# keeps its blocks, 5.8 GB (the ranks take turns: four whole models at once
# and their blocks would fill the card; at 48 layers the blocks alone would
# be 19.9 GB a rank, and a whole model 39.7 GB). (b) 2 layers, fp32, against
# one unsharded NCCL rank, as serve_mesh (b)
SERVE_VLM_MESH = dict(SERVE_MESH, arch="internvl2-26b", layers=12,
                      max_len=1024 + SERVE["prompt"] + SERVE["gen"])
SERVE_VLM_MESH_B = dict(SERVE_VLM_MESH, layers=2, dtype="float32", gen=9, tol=SLICE_TOL,
                        timeout_s=300)
# the enc-dec served on a mesh: whisper-small at full width and depth on (data
# 2, model 2), serve_encdec's request set (8 clips of 1,500 frames, N(0, 1)
# drawn on the card from a seed, 16-token prompts, 32 greedy tokens, a self
# cache of 48): a rank's 4 rows, 24 of the 48 self positions (rank 1's block
# empty until position 24: its block form launches nothing for the first 8
# steps) and 750 of the 1,500 cross positions, every one valid. (b) 2 + 2
# layers fp32, 8 decode steps into a self cache of 24 (every block filled by
# the prompt), against one unsharded NCCL rank
SERVE_ENCDEC_MESH = dict(SERVE_MESH, arch="whisper-small", layers=None,
                         prompt=ENCDEC_SERVE["prompt"], gen=ENCDEC_SERVE["gen"],
                         max_len=ENCDEC_SERVE["prompt"] + ENCDEC_SERVE["gen"])
SERVE_ENCDEC_MESH_B = dict(SERVE_ENCDEC_MESH, layers=2, dtype="float32", gen=9,
                           max_len=ENCDEC_SERVE["prompt"] + 8, tol=SLICE_TOL, timeout_s=300)


def _serve_mesh_model(t: dict, device: str):
    """The model of ``t`` drawn from its seed (on the card where
    t["draw"] says so and the run is on it) and the prompts: {"tokens"},
    and a VLM's "patch_embeds" or an enc-dec's "frames", N(0, 1) in the
    model's dtype drawn where the weights are from t["seed"] + 1."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    cfg = _mesh_cfg(t)
    draw = t["draw"] if device == "cuda" else "cpu"
    model = build_model(cfg, device=draw).init(torch.Generator(device=draw).manual_seed(t["seed"]))
    prompts = {"tokens": torch.from_numpy(np.random.default_rng(t["seed"]).integers(
        0, cfg.vocab_size, (t["batch"], t["prompt"]))).to(device)}
    extra = ({"patch_embeds": cfg.num_patch_tokens} if cfg.num_patch_tokens else
             {"frames": cfg.encoder_seq} if cfg.encoder_layers else {})
    for key, n in extra.items():
        prompts[key] = torch.randn(
            (t["batch"], n, cfg.d_model), device=draw,
            generator=torch.Generator(device=draw).manual_seed(t["seed"] + 1)
        ).to(device=device, dtype=model.dtype)
    return cfg, model, prompts


def _serve_mesh_steps(world: int, t: dict, device: str):
    """This rank's mesh, serve steps, param blocks (the full model freed),
    its rows of the prompts (and of a VLM's patches), the cache's specs and
    ``serve_collectives``. The ranks draw the whole model and keep their
    blocks one at a time, so that the card holds one whole model and the
    blocks of the others at once, not four whole models."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.serve import build_decode_step, build_prefill_step, serve_collectives
    from repro_torch.train.state import param_tree, shard_params

    mesh = make_host_mesh(data=t["data"], model=t["model"])
    b, prompt, max_len = t["batch"], t["prompt"], t["max_len"]
    for turn in range(world):
        if dist.get_rank() == turn:
            cfg, model, prompts = _serve_mesh_model(t, device)
            prefill, plan, in_specs = build_prefill_step(
                model, mesh, ShapeConfig("serve_mesh", cfg.num_patch_tokens + prompt, b,
                                         "prefill"))
            decode, _, dec_specs = build_decode_step(
                model, mesh, ShapeConfig("serve_mesh", max_len, b, "decode"))
            params = shard_params(param_tree(model), plan, mesh, device)
            want = serve_collectives(model, mesh, b, prompt, max_len)
            cache_specs = shd.cache_pspecs(cfg, model.cache_specs(b, max_len), mesh)
            del model
            gc.collect()
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    local = {k: shd.local_block(v, in_specs[k], mesh).contiguous() for k, v in prompts.items()}
    rows = shd.block_slices(in_specs["tokens"], tuple(prompts["tokens"].shape), mesh)
    return cfg, mesh, prefill, decode, params, local, rows, cache_specs, want


def _counts(counts: dict) -> list:
    return sorted([op, list(axes), calls, nbytes] for (op, axes), (calls, nbytes)
                  in counts.items())


def serve_mesh_part_a(rank: int, world: int, tmp: str, t: dict, device: str) -> None:
    """(a) on one rank: a warm-up serve, then the serve with the counts
    zeroed just before; its record goes to tmp/serve_a_<rank>.json: prefill
    and decode times, the collectives of the prefill and of every decode
    step beside ``serve_collectives``, the kernel launches and the shapes
    of their calls, device memory and host RSS."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    cfg, mesh, prefill, decode, params, local, _, _, want = _serve_mesh_steps(world, t, device)
    shapes = {"flash": set(), "decode": set()}
    cur_lens = {}                 # a cache block's shape: the cur_len of each call
    flash, partial = ops.flash_attention, ops.decode_attention_partial

    def flash_rec(q, k, *args, **kw):
        shapes["flash"].add((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, *args, **kw)

    def partial_rec(q, k, v, cur_len):
        shapes["decode"].add((tuple(q.shape), tuple(k.shape)))
        cur_lens.setdefault(str(list(k.shape)), []).append(int(cur_len))
        return partial(q, k, v, cur_len)
    ops.flash_attention, ops.decode_attention_partial = flash_rec, partial_rec
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def serve(gen: int):
        sync()
        mesh.reset_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, dict(local, max_len=t["max_len"]))
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts = {"prefill": _counts(mesh.counts), "decode": []}
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        tok = logits.argmax(-1)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            mesh.reset_counts()
            logits, cache = decode(params, cache, tok)
            counts["decode"].append(_counts(mesh.counts))
            finite &= bool(torch.isfinite(logits).all())
            tok = logits.argmax(-1)
            out.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
        return dict(prefill_ms=prefill_ms, decode_s=decode_s, counts=counts, finite=finite,
                    logits_shape=shape, tokens=torch.stack(out, 1).tolist(),
                    cache_block=list(cache["k"].shape),
                    cross_block=list(cache["cross_k"].shape) if "cross_k" in cache else None)

    serve(t["warmup_gen"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shapes["flash"].clear()
    shapes["decode"].clear()
    cur_lens.clear()
    reset_launches()
    run = serve(t["gen"])
    launches = read_launches()
    ops.flash_attention, ops.decode_attention_partial = flash, partial
    rec = dict(rank=rank, coords=mesh.coords, **run, want={k: _counts(v) for k, v in want.items()},
               launches=launches, flash_routes=dict(fa.flash_attention.routes),
               flash_shapes=sorted(shapes["flash"]), decode_shapes=sorted(shapes["decode"]),
               decode_cur_lens={k: [len(v), min(v), max(v)] for k, v in cur_lens.items()},
               peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               host_rss_gb=host_rss_gb())
    with open(f"{tmp}/serve_a_{rank}.json", "w") as f:
        json.dump(rec, f)


def serve_single_b(rank: int, world: int, tmp: str, tb: dict, device: str) -> None:
    """(b)'s reference: one rank serving the unsharded model (its
    ``prefill`` and ``decode_step``); saves to tmp/serve_single.pt the
    logits of the prefill and of every decode step, the greedy tokens and
    the final caches (an enc-dec's cross cache too)."""
    import torch

    _, model, prompts = _serve_mesh_model(tb, device)
    with torch.inference_mode():
        logits, cache = model.prefill(prompts["tokens"], tb["max_len"],
                                      prompts.get("patch_embeds"), prompts.get("frames"))
        out, toks = [logits.cpu()], [logits.argmax(-1)]
        for _ in range(tb["gen"] - 1):
            logits, cache = model.decode_step(cache, toks[-1])
            out.append(logits.cpu())
            toks.append(logits.argmax(-1))
    torch.save({"logits": out, "tokens": torch.stack(toks, 1).cpu(),
                "cache": {k: x.cpu() for k, x in cache.items() if k != "index"}},
               f"{tmp}/serve_single.pt")


def serve_mesh_part_b(rank: int, world: int, tmp: str, tb: dict, device: str) -> None:
    """(b) on one rank: the same serve on the mesh, held to the one rank's
    (tmp/serve_single.pt) on its rows and cache block; the record goes to
    tmp/serve_b_<rank>.json."""
    import torch

    from repro_torch.parallel import sharding as shd

    cfg, mesh, prefill, decode, params, local, rows, cache_specs, _ = _serve_mesh_steps(
        world, tb, device)
    await_part(tmp, "serve_single_b", tb["timeout_s"])
    ref = torch.load(f"{tmp}/serve_single.pt")
    lo, n = (rows[0][1], rows[0][2]) if rows else (0, tb["batch"])
    tol = tb["tol"]

    def err(got, want):
        got, want = got.float().cpu(), want.float()
        diff = (got - want).abs()
        return dict(max_abs_err=float(diff.max()),
                    bad=int((diff > tol + tol * want.abs()).sum()))

    reset_launches()
    with torch.inference_mode():
        logits, cache = prefill(params, dict(local, max_len=tb["max_len"]))
        errs = [err(logits, ref["logits"][0][lo:lo + n])]
        tok = logits.argmax(-1)
        toks = [tok]
        for i in range(1, tb["gen"]):
            logits, cache = decode(params, cache, tok)
            errs.append(err(logits, ref["logits"][i][lo:lo + n]))
            tok = logits.argmax(-1)
            toks.append(tok)
    launches = read_launches()
    tokens_equal = bool(torch.equal(torch.stack(toks, 1).cpu(), ref["tokens"][lo:lo + n]))
    cache_errs = {k: err(cache[k], shd.local_block(x, cache_specs[k], mesh))
                  for k, x in ref["cache"].items()}
    rec = dict(rank=rank, coords=mesh.coords, logits=errs, tokens_equal=tokens_equal,
               cache=cache_errs, cache_block=list(cache["k"].shape), launches=launches)
    with open(f"{tmp}/serve_b_{rank}.json", "w") as f:
        json.dump(rec, f)


def _serve_mesh_expected(cfg, t: dict, model_index: int) -> dict:
    """What a serve of ``t`` launches on the rank at ``model_index`` of
    "model" (the self cache split over "model" alone, the batch over
    "data"): flash once a layer (an enc-dec: its encoder's, and its decoder's
    self- and cross-attention), decode's block form once a layer and step
    on the self cache where the block holds a position below index + 1 (a
    block past the prompt launches nothing until the sequence reaches it),
    and an enc-dec's on the cross cache's block every step; the (q, k)
    shapes of both, and the cache blocks."""
    L, gen, rows = cfg.num_layers, t["gen"], t["batch"] // t["data"]
    hd, h, kh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    heads, kv_heads = _rank_heads(cfg, t["model"])
    block = t["max_len"] // t["model"]
    positions = cfg.num_patch_tokens + t["prompt"]
    filled = sum(positions + i + 1 > model_index * block for i in range(gen - 1))
    q, kv = [rows, positions, heads, hd], [rows, positions, kv_heads, hd]
    out = dict(launches={"flash_attention": L, "decode_attention": L * filled, "ssd": 0},
               flash=[[q, kv]], decode=[[[rows, 1, h, hd], [rows, block, kh, hd]]],
               block=[L, rows, block, kh, hd], cross_block=None)
    if cfg.encoder_layers:
        cross = cfg.encoder_seq // t["model"]
        enc = [rows, cfg.encoder_seq, heads, hd]
        out.update(launches={"flash_attention": attention_calls(cfg),
                             "decode_attention": L * (filled + gen - 1), "ssd": 0},
                   flash=sorted([[enc, enc], [q, kv], [q, enc]]),
                   decode=sorted(out["decode"] + [[[rows, 1, h, hd], [rows, cross, kh, hd]]]),
                   cross_block=[L, rows, cross, kh, hd])
    return out


def _serve_mesh_row(phase: str, recs: list, t: dict, seconds: float, device: str) -> dict:
    """(a)'s checks, each failing the run, and its printed fields."""
    from repro_torch.configs import get_arch
    from repro_torch.models import param_count
    cfg = _mesh_cfg(t)
    bad = []
    L, gen = cfg.num_layers, t["gen"]
    rows = t["batch"] // t["data"]
    block = t["max_len"] // t["model"]
    for r in recs:
        tag = f"rank {r['rank']}"
        want = _serve_mesh_expected(cfg, t, r["coords"]["model"])
        if r["counts"]["prefill"] != r["want"]["prefill"]:
            bad.append(f"{tag} prefill collectives {r['counts']['prefill']}, "
                       f"serve_collectives {r['want']['prefill']}")
        off = [i for i, c in enumerate(r["counts"]["decode"]) if c != r["want"]["decode"]]
        if off or len(r["counts"]["decode"]) != gen - 1:
            bad.append(f"{tag} decode collectives differ from serve_collectives at steps {off}")
        got = {k: r["launches"][k] for k in want["launches"]}
        if device == "cuda" and got != want["launches"]:
            bad.append(f"{tag} launches {got}, expected {want['launches']}")
        if device == "cuda" and r["launches"]["ssd_routes"] != {"wgmma": 0, "fp32": 0}:
            bad.append(f"{tag} SSD routes {r['launches']['ssd_routes']}")
        if device == "cuda" and r["flash_routes"].get("fp32"):
            bad.append(f"{tag} flash on the fp32 route {r['flash_routes']}")
        if r["flash_shapes"] != want["flash"]:
            bad.append(f"{tag} flash calls at {r['flash_shapes']}, expected {want['flash']}")
        if r["decode_shapes"] != want["decode"]:
            bad.append(f"{tag} decode calls at {r['decode_shapes']}, expected {want['decode']}")
        if cfg.encoder_layers and r["decode_cur_lens"].get(str(want["cross_block"][1:])) != [
                L * (gen - 1), want["cross_block"][2], want["cross_block"][2]]:
            bad.append(f"{tag} cross-cache decode calls [calls, least and largest cur_len] "
                       f"{r['decode_cur_lens']}, expected {L * (gen - 1)} at "
                       f"{want['cross_block'][2]}")
        if not r["finite"] or r["logits_shape"] != [rows, cfg.padded_vocab]:
            bad.append(f"{tag} logits not finite or of shape {r['logits_shape']}")
        if r["cache_block"] != want["block"] or r["cross_block"] != want["cross_block"]:
            bad.append(f"{tag} cache blocks {r['cache_block']}, {r['cross_block']}")
        if not all(0 <= x < cfg.padded_vocab for row in r["tokens"] for x in row):
            bad.append(f"{tag} generated tokens out of range")
    if bad:
        fail(f"{phase} (a): " + "; ".join(bad))
    med = lambda xs: sorted(xs)[len(xs) // 2]                              # noqa: E731
    decode_ms = [r["decode_s"] * 1e3 / (gen - 1) for r in recs]
    per_step = recs[0]["want"]["decode"]
    params = param_count(cfg)
    prefill_bound, decode_bound = (
        encdec_serve_bounds(cfg, t["batch"], t["prompt"], gen)[:2] if cfg.encoder_layers
        else serve_bounds(cfg, params, t["batch"], t["prompt"], gen))
    depth = get_arch(t["arch"]).num_layers
    encoder = f"{cfg.encoder_layers} encoder + " if cfg.encoder_layers else ""
    return dict(config=f"{cfg.name} full width, {encoder}{L} of {depth} layers, {t['dtype']}",
                params=params, mesh=f"data={t['data']}, model={t['model']}",
                ranks=f"{t['world']} gloo ranks sharing one card", batch=t["batch"],
                patches=cfg.num_patch_tokens, prompt=t["prompt"], gen=gen,
                max_len=t["max_len"],
                rows_per_rank=rows, cache_positions_per_rank=block,
                cross_positions_per_rank=(cfg.encoder_seq // t["model"] if cfg.encoder_layers
                                          else None),
                prefill_ms_median=med([r["prefill_ms"] for r in recs]),
                prefill_ms_max=max(r["prefill_ms"] for r in recs),
                decode_ms_per_step_median=med(decode_ms), decode_ms_per_step_max=max(decode_ms),
                decode_tok_s=t["batch"] * 1e3 / max(decode_ms),
                one_card_bound_ms=dict(prefill=prefill_bound[0] * 1e3,
                                       decode_step=decode_bound[0] * 1e3,
                                       note="the same serve's least time on one card: "
                                            "a yardstick, the four ranks share the card"),
                prefill_collectives=recs[0]["want"]["prefill"],
                decode_collectives_per_step=per_step,
                decode_collective_calls_per_step=sum(c[2] for c in per_step),
                decode_collective_bytes_per_step=sum(c[3] for c in per_step),
                collectives_equal_serve_collectives=True,
                launches_per_rank=recs[0]["launches"],
                launches_by_rank=[r["launches"] for r in recs],
                flash_shape=recs[0]["flash_shapes"], decode_shape=recs[0]["decode_shapes"],
                decode_cur_lens_by_rank=[r["decode_cur_lens"] for r in recs],
                peak_device_mem_gb=[r["peak_device_mem_gb"] for r in recs],
                host_rss_gb=[r["host_rss_gb"] for r in recs],
                first_sequence=recs[0]["tokens"][0], seconds=seconds,
                note=MESH_NOTE)


def _serve_mesh_b_row(phase: str, recs: list, tb: dict, single_s: float, device: str) -> dict:
    """(b)'s checks, each failing the run, and its printed fields."""
    cfg = _mesh_cfg(tb)
    bad = []
    for r in recs:
        tag = f"rank {r['rank']}"
        want = _serve_mesh_expected(cfg, tb, r["coords"]["model"])["launches"]
        off = [i for i, e in enumerate(r["logits"]) if e["bad"]]
        if off:
            bad.append(f"{tag} logits beyond {tb['tol']} at steps {off}: "
                       f"{[r['logits'][i]['max_abs_err'] for i in off]}")
        if not r["tokens_equal"]:
            bad.append(f"{tag} greedy tokens differ from the one rank's")
        bad += [f"{tag} cache {k} beyond {tb['tol']}: {e['max_abs_err']}"
                for k, e in r["cache"].items() if e["bad"]]
        got = {k: r["launches"][k] for k in want}
        if device == "cuda" and got != want:
            bad.append(f"{tag} launches {got}, expected {want}")
        if device == "cuda" and r["launches"]["ssd_routes"] != {"wgmma": 0, "fp32": 0}:
            bad.append(f"{tag} SSD routes {r['launches']['ssd_routes']}")
    if bad:
        fail(f"{phase} (b): sharded against one rank: " + "; ".join(bad))
    return dict(config=f"{cfg.name}, {layers(cfg)}, fp32",
                sharded=f"{tb['world']} gloo ranks, data={tb['data']}, model={tb['model']}",
                against="one unsharded rank over nccl (the model's prefill, decode_step)",
                batch=tb["batch"], prompt=tb["prompt"], decode_steps=tb["gen"] - 1,
                max_len=tb["max_len"], tol=tb["tol"], single_rank_s=single_s,
                logits_max_abs_err=max(e["max_abs_err"] for r in recs for e in r["logits"]),
                logits_max_abs_err_per_step=[max(r["logits"][i]["max_abs_err"] for r in recs)
                                             for i in range(tb["gen"])],
                tokens_equal=True,
                cache_max_abs_err=max(e["max_abs_err"] for r in recs
                                      for e in r["cache"].values()),
                cache_block=recs[0]["cache_block"], launches_per_rank=recs[0]["launches"],
                launches_by_rank=[r["launches"] for r in recs])


def phase_mesh_group(torch, device: str = "cuda") -> dict:
    """serve_mesh, serve_vlm_mesh and the enc-dec's train and serve on a
    mesh in one set of four spawned gloo ranks, beside one single-rank NCCL
    process that runs every (b) reference meanwhile, each phase in its own
    subdirectory (a rank's (b) part waits for its reference, ``await_part``):
    one start-up of each, and the references off the ranks' path. Prints
    each phase's lines (serve_mesh, serve_vlm_mesh, train_encdec_mesh,
    serve_encdec_mesh and each one's _world1) and a mesh_group line with
    every part's seconds; returns {phase: row}, the enc-dec's train row with
    its (b) under "part_b" and its serve's under "serve"."""
    import os
    import tempfile
    refs = [(serve_single_b, SERVE_MESH_B, "serve_mesh"),
            (serve_single_b, SERVE_VLM_MESH_B, "serve_vlm_mesh"),
            (single_part_b, TRAIN_ENCDEC_B, "encdec_mesh"),
            (serve_single_b, SERVE_ENCDEC_MESH_B, "encdec_mesh")]
    parts = [(serve_mesh_part_a, SERVE_MESH, "serve_mesh"),
             (serve_mesh_part_b, SERVE_MESH_B, "serve_mesh"),
             (serve_mesh_part_a, SERVE_VLM_MESH, "serve_vlm_mesh"),
             (serve_mesh_part_b, SERVE_VLM_MESH_B, "serve_vlm_mesh"),
             (tp_part_a, TRAIN_ENCDEC, "encdec_mesh"),
             (blocks_part_b, TRAIN_ENCDEC_B, "encdec_mesh"),
             (serve_mesh_part_a, SERVE_ENCDEC_MESH, "encdec_mesh"),
             (serve_mesh_part_b, SERVE_ENCDEC_MESH_B, "encdec_mesh")]
    world = TRAIN_ENCDEC["world"]
    parent = dict(parent_host_rss_gb=host_rss_gb(), parent_device_reserved_gb=None)
    if device == "cuda":
        torch.cuda.empty_cache()
        parent["parent_device_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_group_") as tmp:
        for sub in {sub for *_, sub in parts}:
            os.makedirs(f"{tmp}/{sub}")
        t0 = time.perf_counter()
        run_children("mesh_group", [(mesh_rank, (0, 1, tmp, f"{tmp}/rdv_single", refs, device,
                                                 "nccl" if device == "cuda" else "gloo"))]
                     + [(mesh_rank, (r, world, tmp, f"{tmp}/rdv", parts, device))
                        for r in range(world)],
                     sum(cfg["timeout_s"] for _, cfg, _ in parts))
        seconds = time.perf_counter() - t0

        def load(sub: str, name: str):
            with open(f"{tmp}/{sub}/{name}") as f:
                return json.load(f)

        def secs(sub: str, *parts_run) -> float:
            return sum(load(sub, f"{part.__name__}.done")["seconds"] for part in parts_run)

        def ranks(sub: str, name: str) -> list:
            return [load(sub, f"{name}_{r}.json") for r in range(world)]

        rows = {}
        for phase, t, tb in (("serve_mesh", SERVE_MESH, SERVE_MESH_B),
                             ("serve_vlm_mesh", SERVE_VLM_MESH, SERVE_VLM_MESH_B)):
            row = _serve_mesh_row(phase, ranks(phase, "serve_a"), t,
                                  secs(phase, serve_mesh_part_a, serve_mesh_part_b), device)
            emit(phase, **row)
            part_b = _serve_mesh_b_row(phase, ranks(phase, "serve_b"), tb,
                                       secs(phase, serve_single_b), device)
            emit(f"{phase}_world1", **part_b)
            rows[phase] = dict(row, part_b=part_b)
        sub = "encdec_mesh"
        train = dict(_train_tp_row("train_encdec_mesh", ranks(sub, "a"), TRAIN_ENCDEC,
                                   secs(sub, tp_part_a), device), **parent)
        emit("train_encdec_mesh", **train)
        train_b = _blocks_b_row("train_encdec_mesh", load(sub, "blocks_b.json"), TRAIN_ENCDEC_B,
                                secs(sub, single_part_b), device)
        emit("train_encdec_mesh_world1", **train_b)
        serve = _serve_mesh_row("serve_encdec_mesh", ranks(sub, "serve_a"), SERVE_ENCDEC_MESH,
                                secs(sub, serve_mesh_part_a), device)
        emit("serve_encdec_mesh", **serve)
        serve_b = _serve_mesh_b_row("serve_encdec_mesh", ranks(sub, "serve_b"),
                                    SERVE_ENCDEC_MESH_B, secs(sub, serve_single_b), device)
        emit("serve_encdec_mesh_world1", **serve_b)
        rows["encdec_mesh"] = dict(train, part_b=train_b, serve=dict(serve, part_b=serve_b))
        emit("mesh_group", seconds=seconds,
             rank0_part_s=[[sub, part.__name__, secs(sub, part)] for part, _, sub in parts],
             reference_part_s=[[sub, part.__name__, secs(sub, part)] for part, _, sub in refs],
             note="one set of four gloo ranks runs every part in turn; one NCCL process runs "
                  "the references meanwhile (each (b) part waits for its own); a part's "
                  "seconds are its rank 0's or the reference process's, start-up excluded")
    return rows


# GPipe over a ("pipe",) mesh of four gloo ranks sharing the card:
# full qwen3-0.6b (28 layers, 7 a stage), bf16, forward only, M = 8
# microbatches of 1 x 1024 tokens through Block.apply_layer, held against the
# loop over the 28 layers on the whole batch on rank 0; then fp32 at 8 layers
# (2 a stage) held at 1e-5. ``tol`` is relative to the loop's largest value:
# bf16's is the kernels' bf16 tolerance (an H100 read 0: the stages' products
# over one microbatch equalled the loop's over eight, bit for bit; another
# library may pick other kernels for the two row counts), fp32's the reading
# 2.6e-6 with headroom
PIPELINE = dict(arch="qwen3-0.6b", smoke=False, world=4, microbatches=8, rows=1,
                seq_len=1024, seed=0, timeout_s=300,
                parts=(dict(layers=None, dtype="bfloat16", tol=TOL["bfloat16"]),
                       dict(layers=8, dtype="float32", tol=1e-5)))


def _pipe_cfg(t: dict, part: dict):
    return _mesh_cfg(dict(arch=t["arch"], smoke=t["smoke"], layers=part["layers"],
                          dtype=part["dtype"]))


def pipe_part(rank: int, world: int, tmp: str, t: dict, device: str) -> None:
    """Both parts of the pipeline phase on one stage; the record goes to
    tmp/pipe_<rank>.json."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed_lookup
    from repro_torch.parallel import bubble_fraction, pipeline_forward
    from repro_torch.tree import tree_map

    mesh = make_mesh((world,), ("pipe",))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    parts = []
    for part in t["parts"]:
        cfg = _pipe_cfg(t, part)
        model = build_model(cfg, device=device).init(
            torch.Generator(device=device).manual_seed(t["seed"]))
        tokens = torch.from_numpy(np.random.default_rng(t["seed"]).integers(
            0, cfg.vocab_size, (t["microbatches"], t["rows"], t["seq_len"]))).to(device)
        with torch.no_grad():
            x = embed_lookup(model.embed["w"], tokens)          # (M, mb, S, D)
        per = cfg.num_layers // world
        blocks = list(model.blocks)
        stage = tree_map(lambda *layers: torch.stack(layers),
                         *[b.layer_params() for b in blocks[rank * per:(rank + 1) * per]])
        body = blocks[0]
        if rank:                                   # a stage holds its own layers only
            del model, blocks
            gc.collect()
        mesh.reset_counts()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out = pipeline_forward(lambda p, h: body.apply_layer(p, h)[0], stage, x, mesh)
        sync()
        wall_s = time.perf_counter() - t0
        rec = dict(config=f"{cfg.name}, {cfg.num_layers} layers, {cfg.dtype}",
                   stage_layers=per, wall_s=wall_s, launches=read_launches(),
                   flash_routes=dict(fa.flash_attention.routes),
                   counts={f"{op}|{'.'.join(a)}": list(v) for (op, a), v in mesh.counts.items()},
                   ticks=t["microbatches"] + world - 1,
                   bubble_fraction=bubble_fraction(world, t["microbatches"]),
                   finite=bool(torch.isfinite(out).all()), shape=list(out.shape))
        if rank == 0:                              # the loop over every layer, whole batch
            with torch.no_grad():
                sync()
                t0 = time.perf_counter()
                h = x.reshape(-1, *x.shape[2:])
                for b in blocks:
                    h = b.apply_layer(b.layer_params(), h)[0]
                sync()
                rec["sequential_s"] = time.perf_counter() - t0
            ref = h.reshape(x.shape).float()
            rec["max_abs_err"] = float((out.float() - ref).abs().max())
            rec["ref_max_abs"] = float(ref.abs().max())
            rec["rel_err"] = rec["max_abs_err"] / rec["ref_max_abs"]
            rec["tol"] = part["tol"]
            del model, blocks, ref, h
        parts.append(rec)
        del stage, body, x, out
        gc.collect()
        torch.cuda.empty_cache()
    with open(f"{tmp}/pipe_{rank}.json", "w") as f:
        json.dump(dict(rank=rank, parts=parts), f)


def phase_pipeline(torch, t: dict = PIPELINE, device: str = "cuda") -> dict:
    """GPipe over four stages: full qwen3-0.6b in bf16, then 8 layers in
    fp32, each against the sequential loop on rank 0."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        t0 = time.perf_counter()
        run_children("pipeline", [(mesh_rank, (r, t["world"], tmp, f"{tmp}/rdv_pipe",
                                               [(pipe_part, t)], device))
                                  for r in range(t["world"])], t["timeout_s"])
        recs = []
        for r in range(t["world"]):
            with open(f"{tmp}/pipe_{r}.json") as f:
                recs.append(json.load(f))
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    world, m = t["world"], t["microbatches"]
    rows = []
    for i, part in enumerate(t["parts"]):
        per_rank = [r["parts"][i] for r in recs]
        head = per_rank[0]
        dname = part["dtype"]
        layers = head["stage_layers"] * world
        tick_bytes = (t["rows"] * t["seq_len"] * _pipe_cfg(t, part).d_model
                      * (2 if dname == "bfloat16" else 4))
        want_counts = {"ring_exchange|pipe": [m + world - 1, (m + world - 1) * tick_bytes],
                       "broadcast|pipe": [1, m * tick_bytes]}
        flash = [r["launches"]["flash_attention"] for r in per_rank]
        route = EXPECTED_ROUTE[dname]
        if device == "cuda" and (
                flash != [head["stage_layers"] * m] * world
                or any(r["flash_routes"].get(route) != r["launches"]["flash_attention"]
                       for r in per_rank)
                or any(r["launches"]["decode_attention"] or r["launches"]["ssd"]
                       for r in per_rank)):
            fail(f"pipeline ({dname}): kernel launches {[r['launches'] for r in per_rank]}, "
                 f"routes {[r['flash_routes'] for r in per_rank]}; expected "
                 f"{head['stage_layers'] * m} flash launches a stage on {route}")
        if any(r["counts"] != want_counts for r in per_rank):
            fail(f"pipeline ({dname}): collectives {[r['counts'] for r in per_rank]}, "
                 f"expected {want_counts}")
        if not all(r["finite"] for r in per_rank) or head["rel_err"] > part["tol"]:
            fail(f"pipeline ({dname}): against the sequential loop over {layers} layers "
                 f"{head['rel_err']} of its largest value (limit {part['tol']})")
        rows.append(dict(config=head["config"], stages=world, stage_layers=head["stage_layers"],
                         microbatches=m, microbatch=[t["rows"], t["seq_len"]],
                         ticks=head["ticks"], bubble_fraction=head["bubble_fraction"],
                         wall_s=[r["wall_s"] for r in per_rank],
                         sequential_s=head["sequential_s"],
                         rel_err=head["rel_err"], max_abs_err=head["max_abs_err"],
                         ref_max_abs=head["ref_max_abs"], tol=part["tol"],
                         ring_exchange=head["counts"]["ring_exchange|pipe"],
                         broadcast=head["counts"]["broadcast|pipe"],
                         flash_launches=flash, flash_route=route))
    row = dict(parts=rows, backend="gloo", device_note=MESH_NOTE.replace("four ranks",
                                                                         "four stages"),
               note="forward only; a stage skips its bubble ticks, so it runs its layers "
                    "M times; wall_s per stage from its first tick to the broadcast; "
                    "sequential_s: rank 0's loop over every layer on the whole batch; "
                    "ring_exchange / broadcast: (calls, bytes) a stage",
               seconds=seconds)
    emit("pipeline", **row)
    return row


def phase_scenarios(torch):
    """The adversarial scenario fleet of the port: the whole corpus at the
    reference's scale on the card and on the CPU (verdicts equal), then one
    scenario's events replayed at full qwen3-0.6b width on the card."""
    import ctypes
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.fcr import fcr, is_free
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline.hw import PEAK_FLOPS
    from repro_torch.runtime.cluster import SimCluster
    from repro_torch.runtime.scenarios import _cluster_kwargs, _Runner, build_cluster, corpus

    # ---- 1. the corpus at the reference's scale: card, then CPU ---- #
    # each scenario as run_scenario replays it, keeping the cluster so that
    # its losses, which the card computes, are held to the CPU's as well
    def replay(sc, root, device):
        clu = build_cluster(sc, root / sc.name, device=device)
        verdict = _Runner(sc, clu).run()
        losses = torch.tensor(clu.loss_history, dtype=torch.float64)
        for w in clu.workers:
            w.engine.close()
        return verdict, losses

    scs = corpus()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scenarios_"))
    card, cpu, secs = {}, {}, {}
    reset_launches()
    for sc in scs:
        t0 = time.perf_counter()
        card[sc.name] = replay(sc, tmp / "cuda", "cuda")
        secs[sc.name] = [time.perf_counter() - t0]
    launches = read_launches()
    routes = dict(fa.flash_attention.routes)
    for sc in scs:
        t0 = time.perf_counter()
        cpu[sc.name] = replay(sc, tmp / "cpu", "cpu")
        secs[sc.name].append(time.perf_counter() - t0)
    shutil.rmtree(tmp, ignore_errors=True)
    loss_err = {}
    for sc in scs:
        (v, losses), (v_cpu, losses_cpu) = card[sc.name], cpu[sc.name]
        if len(losses) != len(losses_cpu) or not torch.isfinite(losses).all():
            fail(f"scenarios: {sc.name} losses on the card {losses.tolist()}, "
                 f"on the CPU {losses_cpu.tolist()}")
        loss_err[sc.name] = check_close(f"scenarios: {sc.name} losses card vs cpu", losses,
                                        losses_cpu, SLICE_TOL)
        emit("scenario", name=sc.name, dp=sc.dp, steps=sc.steps, card_s=secs[sc.name][0],
             cpu_s=secs[sc.name][1], recoveries=v.recoveries, rollbacks=v.rollbacks,
             detection_latency_s=v.detection_latency_s,
             equal_to_cpu=v.pinned() == v_cpu.pinned(), losses=len(losses),
             loss_max_abs_err=loss_err[sc.name], loss_tol=SLICE_TOL)
    differ = [n for n in card if card[n][0].pinned() != cpu[n][0].pinned()]
    if differ:
        fail(f"scenarios: verdicts on the card differ from the CPU's for {differ}")
    if (launches["flash_attention"] == 0 or routes.get("fp32") != launches["flash_attention"]
            or launches["decode_attention"] or launches["ssd"]):
        fail(f"scenarios: corpus kernel launches {launches}, flash routes {routes}, "
             "expected flash launches all on fp32 and no decode or SSD launch")
    corpus_row = dict(scenarios=len(scs), card_s=sum(x[0] for x in secs.values()),
                      cpu_s=sum(x[1] for x in secs.values()), launches=launches,
                      flash_routes=routes, verdicts_equal=True,
                      loss_max_abs_err=max(loss_err.values()), loss_tol=SLICE_TOL)

    # ---- 2. one scenario's events at full width ---- #
    sc = next(s for s in scs if s.name == REPLAY["scenario"])
    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=REPLAY["layers"])
    ckpt_dir = ROOT / "build" / "chip_smoke_replay_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # wired as build_cluster wires a scenario's cluster, at full width
    clu = SimCluster(cfg, device="cuda", clock=time.perf_counter,
                     **_cluster_kwargs(sc, ckpt_dir, global_batch=REPLAY["global_batch"],
                                       seq_len=REPLAY["seq_len"]))
    setup_s = time.perf_counter() - t0
    span_keys = {"compute_ms", "device_ms", "flatten_ms", "shard_ms", "fabric_ms", "step_ms"}
    spans, reports = [], []

    def step():
        loss = SimCluster.step(clu)
        sp = dict(clu.last_step_timing)
        if set(sp) != span_keys or any(v is None for v in sp.values()):
            fail(f"scenarios: step timing {sp}, expected every one of {sorted(span_keys)}")
        spans.append(dict(sp, loss=loss, host_rss_gb=host_rss_gb()))
        return loss

    def recover(*args, **kw):
        t0 = time.perf_counter()
        rep = SimCluster.recover(clu, *args, **kw)
        torch.cuda.synchronize()
        reports.append((rep, time.perf_counter() - t0, len(spans)))
        return rep

    clu.step, clu.recover = step, recover        # the runner calls these
    reset_launches()
    t0 = time.perf_counter()
    verdict = _Runner(sc, clu).run()
    replay_s = time.perf_counter() - t0
    launches = read_launches()
    routes = dict(fa.flash_attention.routes)
    losses = [sp["loss"] for sp in spans]
    rel = sc.reliability
    analytic = rel.heartbeat_period + rel.scan_period + rel.notify_latency
    if (verdict.steps_completed != sc.steps or verdict.recoveries != 1
            or verdict.rollbacks != 0 or verdict.detections != 1 or len(reports) != 1
            or reports[0][0].recovered_from != "neighbor"):
        fail(f"scenarios: full-width verdict {verdict.pinned()}, reports "
             f"{[r[0].recovered_from for r in reports]}; expected {sc.steps} steps, one "
             "recovery from the neighbour, 0 rollbacks and 1 detection")
    if (verdict.detection_latency_s is None
            or abs(verdict.detection_latency_s - analytic) > rel.heartbeat_period + 1e-9):
        fail(f"scenarios: detection latency {verdict.detection_latency_s} s, analytic "
             f"{analytic} s, allowed one heartbeat ({rel.heartbeat_period} s)")
    if len(losses) != sc.steps or not all(math.isfinite(x) for x in losses):
        fail(f"scenarios: full-width losses {losses}")
    flash = passes(cfg) * cfg.num_layers * sc.steps     # the forward and the recompute
    expected = {"flash_attention": flash, "decode_attention": 0,
                "ssd": 0, "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected or routes.get("wgmma") != flash:
        fail(f"scenarios: full-width kernel launches {launches}, flash routes {routes}, "
             f"expected {expected} all on wgmma")

    pin = card[sc.name][0].pinned()
    got = verdict.pinned()
    differs = {k: dict(full_width=got[k], reference_scale=pin[k], why=SCALE_FIELDS[k])
               for k in got if k in SCALE_FIELDS and got[k] != pin[k]}
    unexplained = [k for k in got if k not in SCALE_FIELDS and got[k] != pin[k]]
    if unexplained:
        fail(f"scenarios: full-width verdict differs from the pin in {unexplained}")
    later = spans[1:]

    def median(key):
        return float(np.median([sp[key] for sp in later]))

    step_ms = median("step_ms")
    tokens = REPLAY["global_batch"] * REPLAY["seq_len"]
    host_share = float(np.median([(sp["step_ms"] - sp["compute_ms"]) / sp["step_ms"]
                                  for sp in later]))
    b_worker = REPLAY["global_batch"] / sc.dp
    fcr_value = fcr(REPLAY["seq_len"], b_worker, sc.link_bw, PEAK_FLOPS["bfloat16"])
    rep, recover_s, recovered_after = reports[0]

    # the steps before the recovery and after it: the spilled checkpoint
    # chunks pile up on the host until the recovery resets the streams
    def regime(part):
        return dict(steps=len(part), step_ms=[sp["step_ms"] for sp in part],
                    step_ms_median=float(np.median([sp["step_ms"] for sp in part])),
                    host_rss_gb=[sp["host_rss_gb"] for sp in part])
    row = dict(corpus=corpus_row,
               replay=dict(scenario=sc.name, events=[[e.at_step, e.action, e.kwargs()]
                                                     for e in sc.events],
                           config=f"qwen3-0.6b full width, {cfg.num_layers} layers, bf16",
                           dp=sc.dp, global_batch=REPLAY["global_batch"],
                           seq_len=REPLAY["seq_len"], link_bw=sc.link_bw, dcn_bw=sc.dcn_bw,
                           verdict=got, differs_from_pin=differs,
                           detection_latency_s=verdict.detection_latency_s,
                           detection_analytic_s=analytic,
                           losses=losses, step_ms=step_ms, step_ms_first=spans[0]["step_ms"],
                           tokens_per_s=tokens / (step_ms / 1e3),
                           window_ms_per_step=replay_s * 1e3 / sc.steps,
                           tokens_per_s_window=tokens * sc.steps / replay_s,
                           regimes=dict(before_recovery=regime(later[:recovered_after - 1]),
                                        after_recovery=regime(spans[recovered_after:])),
                           split_ms=dict(device=median("device_ms"),
                                         step_call=median("compute_ms"),
                                         flatten=median("flatten_ms"),
                                         shard_chunk_crc=median("shard_ms"),
                                         fabric=median("fabric_ms")),
                           host_ckpt_share=host_share,
                           recover_wall_s=recover_s, recover_simulated_s=rep.total_time,
                           recovered_from=rep.recovered_from,
                           exposed_seconds_simulated=verdict.exposed_seconds,
                           note="recover_simulated_s, exposed_seconds_simulated and the "
                                "verdict's times are simulated fabric time, not measured",
                           peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                           peak_host_rss_gb=peak_rss_gb(), setup_s=setup_s,
                           replay_s=replay_s, launches=launches, flash_routes=routes,
                           fcr=dict(s=REPLAY["seq_len"], b=b_worker, v=sc.link_bw,
                                    c=PEAK_FLOPS["bfloat16"], value=fcr_value,
                                    free=is_free(REPLAY["seq_len"], b_worker, sc.link_bw,
                                                 PEAK_FLOPS["bfloat16"]),
                                    measured_host_ckpt_share=host_share),
                           spans=spans))
    for w in clu.workers:
        w.engine.close()
    del clu, w, step, recover, reports, rep
    gc.collect()
    # hand the freed host heap back to the OS before train builds its
    # cluster: the replay's backlog of exposed checkpoint chunks leaves
    # tens of GB of freed but resident heap behind
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    row["replay"]["host_rss_after_free_gb"] = host_rss_gb()
    emit("scenarios", **row)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def ssm_serve_bounds(cfg, params: int, b: int, prompt: int):
    """The card's least time for the mamba2 serve run's prefill and for one
    decode step, bf16: weight bytes read once; the decode state (SSD state
    fp32, conv windows bf16) written once by prefill, read and written once
    by a decode step; the matrix products' and the SSD's operations."""
    from repro_torch.roofline.hw import bound_seconds
    L, h, n, p = cfg.num_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # the embedding, also the head
    n_body = params - n_head
    weight_bytes = 2 * params
    state_bytes = L * b * (h * n * p * 4 + (cfg.ssm_conv_kernel - 1)
                           * (cfg.ssm_inner + 2 * n) * 2)
    ssd_flops, _ = ssd_full_work(b, prompt, h, p, n, min(cfg.ssm_chunk, prompt), 2)
    prefill_flops = 2 * n_body * b * prompt + 2 * n_head * b + L * ssd_flops
    prefill = bound_seconds(prefill_flops, weight_bytes + state_bytes, "bfloat16")
    decode_flops = 2 * params * b + L * b * h * n * p * 4
    decode = bound_seconds(decode_flops, weight_bytes + 2 * state_bytes, "bfloat16")
    return prefill, decode


def phase_serve_ssm(torch):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("mamba2-2.7b")
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": cfg.num_layers, "fp32": 0}}
    if launches != expected:
        fail(f"serve_ssm: kernel launches {launches}, expected {expected}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_ssm: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_ssm: generated tokens out of range")
    params = param_count(cfg)
    prefill_bound, decode_bound = ssm_serve_bounds(cfg, params, b, prompt)
    row = dict(config="mamba2-2.7b full (64 layers, bf16)", params=params,
               batch=b, prompt=prompt, gen=gen, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               first_sequence=seqs[0].tolist())
    emit("serve_ssm", **row)
    return model, prefill, decode, tokens, row


def hybrid_serve_bounds(cfg, params: int, shared: int, b: int, prompt: int, gen: int):
    """The card's least time for the hybrid serve run's prefill and for its
    mean decode step, bf16. Operations: the matrix products of every
    parameter but the embedding once a token, with the shared block's
    counted once per application, the head's for the last position only,
    the causal attention of each application and each layer's SSD (the
    prefill; a decode step's state update and read-out). Bytes: the weights
    read once, the shared block once more per further application (a decode
    step), the KV cache written (prefill) or read up to the attended length
    (decode), the SSD state fp32 and the conv windows bf16 written (prefill)
    or read and written (decode)."""
    from repro_torch.roofline.hw import bound_seconds
    L, h, n, p = cfg.num_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    n_attn = sum(k == "mamba_attn" for k in cfg.layer_kinds())
    kh, hq, hd = cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # the embedding, also the head
    n_eff = params - n_head + (n_attn - 1) * shared   # matmul parameters a token
    weight_bytes = 2 * params
    state_bytes = L * b * (h * n * p * 4 + (cfg.ssm_conv_kernel - 1)
                           * (cfg.ssm_inner + 2 * n) * 2)
    kv_bytes_per_pos = 2 * n_attn * b * kh * hd * 2
    ssd_flops, _ = ssd_full_work(b, prompt, h, p, n, min(cfg.ssm_chunk, prompt), 2)
    prefill_flops = (2 * n_eff * b * prompt + 2 * n_head * b + L * ssd_flops
                     + n_attn * 4 * b * hq * hd * prompt * (prompt + 1) // 2)
    prefill = bound_seconds(prefill_flops, weight_bytes + kv_bytes_per_pos * prompt
                            + state_bytes, "bfloat16")
    lens = range(prompt + 1, prompt + gen)             # attended lengths per step
    steps = gen - 1
    decode_flops = (2 * (n_eff + n_head) * b + L * b * h * n * p * 4
                    + n_attn * 4 * b * hq * hd * sum(lens) / steps)
    decode_bytes = (weight_bytes + 2 * (n_attn - 1) * shared + 2 * state_bytes
                    + kv_bytes_per_pos * sum(lens) / steps)
    return (prefill, prefill_flops, weight_bytes + kv_bytes_per_pos * prompt + state_bytes,
            bound_seconds(decode_flops, decode_bytes, "bfloat16"), decode_bytes)


def phase_serve_hybrid(torch):
    """Full zamba2-7b (81 Mamba2 layers, the shared attention block after 13
    of them, bf16), random weights drawn on the card from a seed: the same 8
    x 1000 prompts and 32 greedy tokens. 13 flash launches on wgmma at head
    dim 112, 13 x 31 decode launches, 81 SSD launches on wgmma."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("zamba2-7b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    t0 = time.perf_counter()
    # drawn by a CUDA generator on the card: 6.6 B numbers drawn on the host
    # would cost minutes of host time and a 26 GB fp32 copy
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    n_attn = len(model.attn_layers)
    expected = {"flash_attention": n_attn, "decode_attention": n_attn * (gen - 1),
                "ssd": cfg.num_layers, "ssd_routes": {"wgmma": cfg.num_layers, "fp32": 0}}
    if (launches != expected or flash_routes != {"wgmma": n_attn, "fp32": 0}
            or cfg.resolved_head_dim != 112):
        fail(f"serve_hybrid: kernel launches {launches}, flash routes {flash_routes}, "
             f"head_dim {cfg.resolved_head_dim}; expected {expected}, flash all on wgmma "
             f"at head_dim 112")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_hybrid: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_hybrid: generated tokens out of range")
    params = param_count(cfg)
    shared = sum(p.numel() for p in model.shared_attn.parameters())
    prefill_bound, prefill_flops, prefill_bytes, decode_bound, decode_bytes = \
        hybrid_serve_bounds(cfg, params, shared, b, prompt, gen)
    row = dict(config=f"zamba2-7b full ({cfg.num_layers} layers, shared block after "
                      f"{n_attn}, head_dim {cfg.resolved_head_dim}, bf16)",
               params=params, shared_block_params=shared, batch=b, prompt=prompt, gen=gen,
               init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               prefill_tflop=prefill_flops / 1e12, prefill_gbytes=prefill_bytes / 1e9,
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_step_gbytes=decode_bytes / 1e9,
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve_hybrid", **row)
    del model, prefill, decode
    torch.cuda.empty_cache()
    return row


def routing_compare(card_log: list, cpu_log: list, k: int, phase: str) -> dict:
    """The routing of the card's run against the CPU's, record by record
    (one per MoE call: layer by layer, prefill, decode steps, loss): the
    assignments whose expert differs (flips), the capacity verdicts that
    differ, and, on the card's gate probabilities, the smallest gap between
    a token's k-th and (k+1)-th expert over the real experts: how close the
    closest token came to flipping. A flipped token's own gate gap (the
    smallest gap between adjacent ones of its k+1 largest gate
    probabilities on the CPU) is listed, and any difference is printed at
    once, before a later check can stop the run."""
    flips = valid_diff = 0
    gap = math.inf
    flip_gaps = []
    for a, b in zip(card_log, cpu_log):
        differs = a["top_e"].cpu() != b["top_e"]
        flips += int(differs.sum())
        valid_diff += int((a["valid"].cpu() != b["valid"]).sum())
        gap = min(gap, _gate_gap(a["gate_probs"], k))
        if differs.any():
            top = b["gate_probs"][differs.any(-1)].float().topk(k + 1, dim=-1).values
            flip_gaps += (top[:, :-1] - top[:, 1:]).min(-1).values.tolist()
    if len(card_log) != len(cpu_log):
        fail(f"{phase}: {len(card_log)} MoE calls on the card, {len(cpu_log)} on the CPU")
    out = dict(moe_calls=len(card_log), flipped_assignments=flips,
               valid_differs=valid_diff, min_gate_gap=gap, flip_gate_gaps=flip_gaps[:16],
               dropped_assignments=sum(int((~r["valid"]).sum()) for r in cpu_log),
               assignments=sum(r["valid"].numel() for r in cpu_log))
    if flips or valid_diff:
        print(f"chip_smoke: {phase} routing differs card vs cpu: {json.dumps(out)}",
              file=sys.stderr, flush=True)
    return out


def phase_slice_moe(torch, m: dict = MOE_SLICE):
    """An MoE config of ``m`` (qwen2-moe-a2.7b, or qwen3-moe-30b-a3b at 128
    experts and top-8) at full width, cut to 2 layers, fp32: the same weights
    on the CPU (plain versions) and on the card (kernels). Prefill of the
    prompt, then decode steps (both sides take the CPU's greedy token), with
    the caches after the prefill and after the steps; where ``m["loss"]``,
    then the loss of the prompt and one more token and every gradient. The
    routing of every MoE call is compared first."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, moe
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    phase = m["phase"]
    cfg = dataclasses.replace(get_arch(m["arch"]), num_layers=m["layers"], dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card (1.8 B numbers drawn on the host take ~15 s), then
    # copied to the CPU
    card = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (m["batch"], m["seq"] + 1)))
    prompt = tokens[:, :m["seq"]]
    reset_launches()
    runs, logs = {}, {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        with moe.record_routing() as log:
            logits, cache = prefill(prompt.to(dev), m["seq"] + m["steps"] + 1)
            # copies: decode writes the cache in place (.cpu() of a CPU tensor is itself)
            outs = [logits.cpu()]
            caches = {"k": cache["k"].cpu().clone(), "v": cache["v"].cpu().clone()}
            for step in range(m["steps"]):
                tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
                logits, cache = decode(cache, tok.to(dev))
                outs.append(logits.cpu())
            caches.update(final_k=cache["k"].cpu(), final_v=cache["v"].cpu())
            del cache
            if m["loss"]:
                model.requires_grad_(True)
                loss, aux = model.loss({"tokens": tokens.to(dev)})
        if m["loss"]:
            # outside the log: the backward's recompute of each layer body
            # (remat_policy "full") routes the forward's tokens again, in
            # this thread on the CPU and in the autograd engine's on the card
            loss.backward()
        runs[name] = outs
        runs[name + "_caches"] = caches
        logs[name] = log
        if m["loss"]:
            runs[name + "_loss"] = [loss.detach().cpu(), aux["xent"].detach().cpu(),
                                    aux["aux"].detach().cpu()]
            runs[name + "_grads"] = {keystr(p): t for p, t in
                                     tree_flatten_with_path(_host_tree(grad_tree(model)))}
    launches = read_launches()
    routing = routing_compare(logs["cuda"], logs["cpu"], cfg.top_k, phase)
    del logs
    expected = {"flash_attention": (1 + passes(cfg) * m["loss"]) * cfg.num_layers,
                "decode_attention": cfg.num_layers * m["steps"], "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"{phase}: kernel launches {launches}, expected {expected} (prefill, the "
             f"loss's forward and its recompute each run flash once a layer)")
    errs = []
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (m["batch"], cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"{phase}: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close(f"{phase} logits card vs cpu", out, ref, m["tol"]))
    cache_err = {key: check_close(f"{phase} cache {key} card vs cpu", got,
                                  runs["cpu_caches"][key], m["tol"])
                 for key, got in runs["cuda_caches"].items()}
    row = dict(config=f"{m['arch']} full width, {cfg.num_layers} layers, fp32, "
                      f"{cfg.num_experts} experts, top-{cfg.top_k}, {cfg.num_heads} q / "
                      f"{cfg.num_kv_heads} kv heads of {cfg.resolved_head_dim}",
               batch=m["batch"], prompt=m["seq"], decode_steps=m["steps"], init_s=init_s,
               routing=routing, logits_max_abs_err_per_step=errs,
               cache_max_abs_err=cache_err, tol=m["tol"], launches=launches)
    if m["loss"]:
        loss_err = {part: check_close(f"{phase} {part} card vs cpu", got, want, m["tol"])
                    for part, got, want in zip(("loss", "xent", "aux"), runs["cuda_loss"],
                                               runs["cpu_loss"])}
        grad_err = {k: check_close(f"{phase} grad {k} card vs cpu", runs["cuda_grads"][k],
                                   ref, m["tol"]) for k, ref in runs["cpu_grads"].items()}
        for k, g in runs["cuda_grads"].items():
            if "|moe|" in k and (not torch.isfinite(g).all() or not (g != 0).any()):
                fail(f"{phase}: MoE gradient {k} is not finite or is all 0")
        row.update(loss_tokens=list(tokens.shape), loss=float(runs["cuda_loss"][0]),
                   aux=float(runs["cuda_loss"][2]), loss_err=loss_err,
                   grad_leaves=len(grad_err), grad_max_abs_err=max(grad_err.values()),
                   moe_grad_err={k: v for k, v in grad_err.items() if "|moe|" in k})
    emit(phase, **row)
    del cpu, card, runs
    torch.cuda.empty_cache()
    return row


def moe_serve_bounds(cfg, params: int, b: int, prompt: int, gen: int, slots: int,
                     distinct_experts: float):
    """The card's least times of the MoE serve run, bf16. Operations: the
    matrix products of every parameter but the embedding, the head's and
    the routed experts' once a token, the head's for the last position only
    (prefill), the routed experts' once per assignment (k a token) or, for
    the reference's dispatch, once per slot of its (G, E, C) table (``slots``
    a layer), and the causal attention. Bytes: every weight but the
    embedding table read once and the KV cache written (prefill) or read up
    to the attended length (decode). A decode step's bytes are given twice:
    with all E experts a layer read (the reference's dispatch runs every
    expert) and with the ``distinct_experts`` a layer that this run's steps
    picked on average. Returns a dict of (seconds, bound_by) and the counts."""
    from repro_torch.roofline.hw import bound_seconds
    L, kh, h, hd = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    d, e, k = cfg.d_model, cfg.padded_experts, cfg.top_k
    per_expert = 3 * d * cfg.moe_d_ff
    n_embed = n_head = cfg.padded_vocab * d           # untied
    n_routed = L * e * per_expert
    n_dense = params - n_embed - n_head - n_routed    # attention, shared expert, router, norms
    tokens = b * prompt
    kv_bytes_per_pos = 2 * L * b * kh * hd * 2
    attn_flops = L * 4 * b * h * hd * prompt * (prompt + 1) // 2
    weights = 2 * (params - n_embed)
    prefill_bytes = weights + kv_bytes_per_pos * prompt
    prefill_assigned = (2 * n_dense * tokens + 2 * n_head * b
                        + 2 * per_expert * L * tokens * k + attn_flops)
    prefill_slots = prefill_assigned - 2 * per_expert * L * tokens * k \
        + 2 * per_expert * L * slots
    lens = range(prompt + 1, prompt + gen)
    steps = gen - 1
    kv_read = kv_bytes_per_pos * sum(lens) / steps
    decode_flops = (2 * (n_dense + n_head) * b + 2 * per_expert * L * b * k
                    + L * 4 * b * h * hd * sum(lens) / steps)
    decode_all = weights + kv_read
    decode_picked = weights - 2 * n_routed + 2 * L * distinct_experts * per_expert + kv_read
    return dict(prefill_assigned=bound_seconds(prefill_assigned, prefill_bytes, "bfloat16"),
                prefill_slots=bound_seconds(prefill_slots, prefill_bytes, "bfloat16"),
                decode_all_experts=bound_seconds(decode_flops, decode_all, "bfloat16"),
                decode_picked_experts=bound_seconds(decode_flops, decode_picked, "bfloat16"),
                prefill_tflop_assigned=prefill_assigned / 1e12,
                prefill_tflop_slots=prefill_slots / 1e12,
                decode_gbytes_all_experts=decode_all / 1e9,
                decode_gbytes_picked_experts=decode_picked / 1e9)


# the MoE serves: each phase's config and what it must be (depth, q heads,
# kv heads and head_dim, real and padded experts, top-k)
MOE_SERVES = {
    "serve_moe": dict(arch="qwen2-moe-a2.7b", layers=24, heads=(16, 16, 128),
                      experts=(60, 64), top_k=4),
    "serve_moe_30b": dict(arch="qwen3-moe-30b-a3b", layers=48, heads=(32, 4, 128),
                          experts=(128, 128), top_k=8),
}
def phase_serve_moe(torch, phase: str = "serve_moe"):
    """A full MoE config of ``MOE_SERVES[phase]`` (qwen2-moe-a2.7b: 24
    layers, 60 routed experts padded to 64, top-4, a shared expert of 5632,
    MHA of 16 heads at head_dim 128; qwen3-moe-30b-a3b: 48 layers, 128
    experts of 768, top-8, no shared expert, 32 q heads on 4 kv heads of 128,
    qk-norm; both with an untied head, bf16), random weights drawn on the
    card from a seed: the same 8 x 1000 prompts and 32 greedy tokens, served
    twice (the first a warm-up whose routing is recorded). L flash launches
    on wgmma, L x 31 decode launches, no SSD launch, the calls' shapes
    recorded by wrapping ``ops``. Freed after."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import active_param_count, build_model, moe, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    want = MOE_SERVES[phase]
    cfg = get_arch(want["arch"])
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if (cfg.num_layers, (h, kh, hd), (cfg.num_experts, cfg.padded_experts), cfg.top_k) != (
            want["layers"], want["heads"], want["experts"], want["top_k"]):
        fail(f"{phase}: {cfg.name} is {cfg.num_layers} layers, {h} q / {kh} kv heads of "
             f"{hd}, {cfg.num_experts} experts padded to {cfg.padded_experts}, top-"
             f"{cfg.top_k}; expected {want}")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    L = cfg.num_layers
    t0 = time.perf_counter()
    # drawn by a CUDA generator on the card: 15 to 30 B numbers drawn on the
    # host would cost minutes of host time
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    with moe.record_routing() as log:
        warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)
    pre, dec = log[:L], log[L:]
    if len(dec) != L * (gen - 1):
        fail(f"{phase}: {len(log)} MoE calls in the warm-up, expected {L * gen}")
    dropped = sum(int((~r["valid"]).sum()) for r in pre) / sum(r["valid"].numel() for r in pre)
    slots = pre[0]["top_e"].shape[0] * cfg.padded_experts * pre[0]["capacity"]
    distinct = sum(int(r["top_e"].unique().numel()) for r in dec) / len(dec)
    dec_dropped = sum(int((~r["valid"]).sum()) for r in dec)
    # how alike the prefill's tokens route: the share of a layer's tokens
    # whose first expert is that layer's most common first expert
    mode_share = sum(int(torch.bincount(r["top_e"][..., 0].reshape(-1)).max())
                     / r["top_e"][..., 0].numel() for r in pre) / len(pre)
    # and within a group (500 consecutive tokens of one prompt): the experts
    # its assignments reach
    per_group = sum(int(g.unique().numel()) for r in pre for g in r["top_e"]) \
        / sum(r["top_e"].shape[0] for r in pre)
    if max(int(r["top_e"].max()) for r in log) >= cfg.num_experts:
        fail(f"{phase}: a padded expert was routed to")
    groups, cap = pre[0]["top_e"].shape[0], pre[0]["capacity"]
    del log, pre, dec

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with record_kernel_calls() as calls:
        seqs, finite, t_prefill, t_decode, shape = serve_once(
            torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"flash_attention": L, "decode_attention": L * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected or flash_routes != {"wgmma": L, "fp32": 0}:
        fail(f"{phase}: kernel launches {launches}, flash routes {flash_routes}; expected "
             f"{expected}, flash all on wgmma")
    want_shapes = {"flash": [((b, prompt, h, hd), (b, prompt, kh, hd))],
                   "decode": [((b, 1, h, hd), (b, prompt + gen, kh, hd))]}
    got_shapes = qk_shapes(calls)
    if got_shapes != want_shapes:
        fail(f"{phase}: kernel calls at (q, k) {got_shapes}, expected {want_shapes}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"{phase}: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail(f"{phase}: generated tokens out of range")
    repeat = bool((warm == seqs).all())
    if not repeat:
        fail(f"{phase}: the repeat generated other tokens than the warm-up")
    params = param_count(cfg)
    bounds = moe_serve_bounds(cfg, params, b, prompt, gen, slots, distinct)
    shared = f", shared {cfg.shared_expert_d_ff}" if cfg.num_shared_experts else ""
    row = dict(config=f"{cfg.name} full ({L} layers, {cfg.num_experts} experts of "
                      f"{cfg.moe_d_ff} padded to {cfg.padded_experts}, top-{cfg.top_k}"
                      f"{shared}, {h} q / {kh} kv heads of {hd}, untied head, bf16)",
               params=params, active_params=active_param_count(cfg), batch=b,
               prompt=prompt, gen=gen, init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_assigned_ms=bounds["prefill_assigned"][0] * 1e3,
               prefill_bound_assigned_by=bounds["prefill_assigned"][1],
               prefill_bound_slots_ms=bounds["prefill_slots"][0] * 1e3,
               prefill_bound_slots_by=bounds["prefill_slots"][1],
               prefill_tflop_assigned=bounds["prefill_tflop_assigned"],
               prefill_tflop_slots=bounds["prefill_tflop_slots"],
               prefill_groups=groups, prefill_capacity=cap, prefill_slots_per_layer=slots,
               prefill_dropped_share=dropped, prefill_top1_mode_share=mode_share,
               prefill_experts_per_group=per_group,
               decode_dropped=dec_dropped,
               decode_distinct_experts_per_layer=distinct,
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_bound_all_experts_ms=bounds["decode_all_experts"][0] * 1e3,
               decode_bound_all_experts_by=bounds["decode_all_experts"][1],
               decode_bound_picked_experts_ms=bounds["decode_picked_experts"][0] * 1e3,
               decode_bound_picked_experts_by=bounds["decode_picked_experts"][1],
               decode_gbytes_all_experts=bounds["decode_gbytes_all_experts"],
               decode_gbytes_picked_experts=bounds["decode_gbytes_picked_experts"],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=peak_gb, mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes, kernel_shapes=got_shapes,
               logits_finite=finite, repeat_identical=repeat,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit(phase, **row)
    del model, prefill, decode
    torch.cuda.empty_cache()
    return row


def phase_slice_vlm(torch):
    """internvl2-26b at full width (48 q heads on 8 kv heads of 128: the
    decode kernel at group 6), cut to 2 layers, fp32: the same weights and
    the same patch embeddings (N(0, 1) from a seed) on the CPU (plain
    versions) and on the card (kernels). Prefill of one prompt of 16 tokens
    behind 1,024 patches, then 8 decode steps (both sides take the CPU's
    greedy token): the logits of each, the caches after the prefill and
    after the steps, and the index, at 2e-4."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    m = VLM_SLICE
    cfg = dataclasses.replace(get_arch("internvl2-26b"), num_layers=m["layers"],
                              dtype="float32")
    npatch = cfg.num_patch_tokens
    t0 = time.perf_counter()
    # drawn on the card (1.9 B numbers drawn on the host are slow), then
    # copied to the CPU
    card = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (m["batch"], m["prompt"])))
    patches = torch.from_numpy(rng.standard_normal((m["batch"], npatch, cfg.d_model),
                                                   dtype=np.float32))
    max_len = npatch + m["prompt"] + m["steps"]
    reset_launches()
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev), max_len, patches.to(dev))
        # copies: decode writes the cache in place (.cpu() of a CPU tensor is itself)
        run = dict(logits=[logits.cpu()], index=cache["index"], k=cache["k"].cpu().clone(),
                   v=cache["v"].cpu().clone())
        for step in range(m["steps"]):
            tok = (runs["cpu"] if name == "cuda" else run)["logits"][step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            run["logits"].append(logits.cpu())
        run.update(final_k=cache["k"].cpu(), final_v=cache["v"].cpu(),
                   index_after=cache["index"])
        runs[name] = run
        del cache
    launches = read_launches()
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * m["steps"], "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"slice_vlm: kernel launches {launches}, expected {expected}")
    want_index = (npatch + m["prompt"], npatch + m["prompt"] + m["steps"])
    for name, run in runs.items():
        if (run["index"], run["index_after"]) != want_index:
            fail(f"slice_vlm: {name} cache index {run['index']} then {run['index_after']}, "
                 f"expected {want_index}")
    errs = []
    for ref, out in zip(runs["cpu"]["logits"], runs["cuda"]["logits"]):
        if out.shape != (m["batch"], cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice_vlm: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice_vlm logits card vs cpu", out, ref, m["tol"]))
    cache_err = {key: check_close(f"slice_vlm cache {key} card vs cpu", runs["cuda"][key],
                                  runs["cpu"][key], m["tol"])
                 for key in ("k", "v", "final_k", "final_v")}
    row = dict(config=f"internvl2-26b full width, {cfg.num_layers} layers, fp32, 48 q / 8 kv "
                      "heads of 128 (group 6)",
               batch=m["batch"], patches=npatch, prompt=m["prompt"], decode_steps=m["steps"],
               init_s=init_s, logits_max_abs_err_per_step=errs, cache_max_abs_err=cache_err,
               index=list(want_index), tol=m["tol"], launches=launches)
    emit("slice_vlm", **row)
    del cpu, card, runs
    torch.cuda.empty_cache()
    return row


def phase_serve_vlm(torch):
    """Full internvl2-26b (48 layers, d_model 6144, 48 q heads on 8 kv heads
    of 128, SwiGLU 16,384, untied head of 92,553 padded to 92,672, bf16,
    random weights drawn on the card from a seed): 8 prompts of 1,000
    tokens behind 1,024 patch embeddings each (N(0, 1) in bf16 from a seed,
    so that a misplaced or dropped patch would change the tokens), 32
    greedy tokens, served twice (the first a warm-up). 48 flash launches on
    wgmma at q (8, 2024, 48, 128), k/v (8, 2024, 8, 128), 48 x 31 decode
    launches at group 6 against caches of (8, 2056, 8, 128), no SSD launch;
    prefill and decode times beside their bounds. Freed after."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("internvl2-26b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    npatch, L = cfg.num_patch_tokens, cfg.num_layers
    max_len = npatch + prompt + gen
    t0 = time.perf_counter()
    # 19.9 B numbers drawn by a CUDA generator on the card
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    patches = torch.randn((b, npatch, cfg.d_model), device="cuda", dtype=torch.bfloat16,
                          generator=torch.Generator(device="cuda").manual_seed(1))
    prefill = functools.partial(build_prefill_step(model), patch_embeds=patches)
    decode = build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, max_len, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with record_kernel_calls() as calls:
        seqs, finite, t_prefill, t_decode, shape = serve_once(
            torch, prefill, decode, tokens, max_len, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    expected = {"flash_attention": L, "decode_attention": L * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    want_shapes = {"flash": [((b, npatch + prompt, 48, 128), (b, npatch + prompt, 8, 128))],
                   "decode": [((b, 1, 48, 128), (b, max_len, 8, 128))]}
    got_shapes = qk_shapes(calls)
    if launches != expected or flash_routes != {"wgmma": L, "fp32": 0}:
        fail(f"serve_vlm: kernel launches {launches}, flash routes {flash_routes}; expected "
             f"{expected}, flash all on wgmma")
    if got_shapes != want_shapes:
        fail(f"serve_vlm: kernel calls at (q, k) {got_shapes}, expected {want_shapes}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_vlm: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_vlm: generated tokens out of range")
    repeat = bool((warm == seqs).all())
    if not repeat:
        fail("serve_vlm: the repeat generated other tokens than the warm-up")
    params = param_count(cfg)
    prefill_bound, decode_bound = serve_bounds(cfg, params, b, prompt, gen)
    row = dict(config=f"internvl2-26b full ({L} layers, d_model {cfg.d_model}, "
                      f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
                      f"{cfg.resolved_head_dim}, untied head, bf16)",
               params=params, batch=b, patches=npatch, prompt=prompt, gen=gen,
               max_len=max_len, init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes, kernel_shapes=got_shapes,
               logits_finite=finite, repeat_identical=repeat,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve_vlm", **row)
    del model, prefill, decode, patches
    torch.cuda.empty_cache()
    return row


def phase_slice_dense(torch, m: dict):
    """A dense config of ``m`` at full width, cut to ``m["layers"]``, fp32:
    the same weights on the CPU (plain versions) and on the card (kernels),
    drawn on the card and copied to the CPU. Prefill of ``batch`` x
    ``prompt`` tokens, then ``steps`` decode steps (both sides take the
    CPU's greedy token): the logits of each, the caches after the prefill
    and after every step, and the index, at ``tol``; the tokens the card's
    logits would have chosen otherwise are counted (flips). Where
    ``m["loss"]``, then the loss of ``batch`` x (prompt + 1) tokens and
    every gradient at ``tol``, the attention under ``FlashAttention`` on
    the fp32 route (its forward and, under remat_policy "full", the
    recompute)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    phase = m["phase"]
    cfg = dataclasses.replace(get_arch(m["arch"]), num_layers=m["layers"], dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card (billions of numbers drawn on the host are slow),
    # then copied to the CPU
    card = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (m["batch"], m["prompt"])))
    max_len = m["prompt"] + m["steps"]
    reset_launches()
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev), max_len)
        # copies: decode writes the cache in place (.cpu() of a CPU tensor is itself)
        run = dict(logits=[logits.cpu()], index=cache["index"],
                   caches=[(cache["k"].cpu().clone(), cache["v"].cpu().clone())])
        for step in range(m["steps"]):
            tok = (runs["cpu"] if name == "cuda" else run)["logits"][step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            run["logits"].append(logits.cpu())
            run["caches"].append((cache["k"].cpu().clone(), cache["v"].cpu().clone()))
        run["index_after"] = cache["index"]
        runs[name] = run
        del cache
    launches = read_launches()
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * m["steps"], "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"{phase}: kernel launches {launches}, expected {expected}")
    want_index = (m["prompt"], m["prompt"] + m["steps"])
    for name, run in runs.items():
        if (run["index"], run["index_after"]) != want_index:
            fail(f"{phase}: {name} cache index {run['index']} then "
                 f"{run['index_after']}, expected {want_index}")
    errs = []
    for ref, out in zip(runs["cpu"]["logits"], runs["cuda"]["logits"]):
        if out.shape != (m["batch"], cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"{phase}: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close(f"{phase} logits card vs cpu", out, ref, m["tol"]))
    flips = sum(int((out.argmax(-1) != ref.argmax(-1)).sum())
                for ref, out in zip(runs["cpu"]["logits"], runs["cuda"]["logits"]))
    cache_err = [max(check_close(f"{phase} cache {key} after step {i} card vs cpu", got, want,
                                 m["tol"])
                     for key, got, want in zip("kv", card_kv, cpu_kv))
                 for i, (card_kv, cpu_kv) in enumerate(zip(runs["cuda"]["caches"],
                                                           runs["cpu"]["caches"]))]
    hd = cfg.resolved_head_dim
    row = dict(config=f"{m['arch']} full width, {cfg.num_layers} layers, fp32, "
                      f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of {hd}, "
                      f"{cfg.mlp_type} d_ff {cfg.d_ff}, "
                      f"{'tied' if cfg.tie_embeddings else 'untied'} head of {cfg.padded_vocab}",
               batch=m["batch"], prompt=m["prompt"], decode_steps=m["steps"], init_s=init_s,
               logits_max_abs_err_per_step=errs, greedy_flips=flips,
               greedy_tokens=(1 + m["steps"]) * m["batch"],
               cache_max_abs_err_after_prefill_and_each_step=cache_err,
               index=list(want_index), tol=m["tol"], launches=launches)
    del runs
    if m["loss"]:
        loss_tokens = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (m["batch"], m["prompt"] + 1)))
        reset_launches()
        results = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            model.requires_grad_(True)
            loss, _ = model.loss({"tokens": loss_tokens.to(model.device)})
            loss.backward()
            results[name] = (loss.detach().cpu(), {
                keystr(p): t for p, t in tree_flatten_with_path(_host_tree(grad_tree(model)))})
        loss_launches, routes = read_launches(), dict(fa.flash_attention.routes)
        flash = passes(cfg) * cfg.num_layers       # the forward and the recompute
        if loss_launches["flash_attention"] != flash or routes != {"wgmma": 0, "fp32": flash} \
                or loss_launches["decode_attention"] or loss_launches["ssd"]:
            fail(f"{phase}: the loss's launches {loss_launches}, routes {routes}; expected "
                 f"{flash} flash on fp32 and nothing else")
        loss_err = check_close(f"{phase} loss card vs cpu", results["cuda"][0],
                               results["cpu"][0], m["tol"])
        grad_err = {k: check_close(f"{phase} grad {k} card vs cpu", results["cuda"][1][k], ref,
                                   m["tol"]) for k, ref in results["cpu"][1].items()}
        for k, g in results["cuda"][1].items():
            if not torch.isfinite(g).all() or not (g != 0).any():
                fail(f"{phase}: gradient {k} is not finite or is all 0")
        row.update(loss_tokens=list(loss_tokens.shape), loss=float(results["cuda"][0]),
                   loss_err=loss_err, grad_leaves=len(grad_err),
                   grad_max_abs_err=max(grad_err.values()),
                   attn_grad_err={k: v for k, v in grad_err.items() if "|attn|" in k},
                   loss_launches=loss_launches, loss_flash_routes=routes)
        del results
    emit(phase, **row)
    del cpu, card
    torch.cuda.empty_cache()
    return row


def phase_serve_dense(torch, phase: str):
    """A dense config of ``DENSE_SERVES[phase]`` at full width (and full
    depth, or cut to the given layers), bf16, its weights drawn on the card
    from a seed: 8 prompts of 1,000 tokens, 32 greedy tokens (a cache of
    1,032), served twice (the first a warm-up, the repeat identical): one
    flash launch a layer on wgmma at q (8, 1000, H, hd), k/v (8, 1000, K,
    hd), 31 decode launches a layer at q (8, 1, H, hd) against caches of
    (8, 1032, K, hd), no SSD launch; prefill and decode times beside their
    bounds, and the serve's own peak device memory (above what the card
    held before the model was built), which the dryrun phase predicts.
    Freed after."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    arch, layers = DENSE_SERVES[phase]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    L, max_len = cfg.num_layers, prompt + gen
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # billions of numbers drawn by a CUDA generator on the card
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, max_len, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with record_kernel_calls() as calls:
        seqs, finite, t_prefill, t_decode, shape = serve_once(
            torch, prefill, decode, tokens, max_len, gen)
    launches = read_launches()
    peak_own = torch.cuda.max_memory_allocated() - base
    flash_routes = dict(fa.flash_attention.routes)
    expected = {"flash_attention": L, "decode_attention": L * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    want_shapes = {"flash": [((b, prompt, h, hd), (b, prompt, kh, hd))],
                   "decode": [((b, 1, h, hd), (b, max_len, kh, hd))]}
    got_shapes = qk_shapes(calls)
    if launches != expected or flash_routes != {"wgmma": L, "fp32": 0}:
        fail(f"{phase}: kernel launches {launches}, flash routes {flash_routes}; "
             f"expected {expected}, flash all on wgmma")
    if got_shapes != want_shapes:
        fail(f"{phase}: kernel calls at (q, k) {got_shapes}, expected {want_shapes}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"{phase}: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail(f"{phase}: generated tokens out of range")
    repeat = bool((warm == seqs).all())
    if not repeat:
        fail(f"{phase}: the repeat generated other tokens than the warm-up")
    params = param_count(cfg)
    prefill_bound, decode_bound = serve_bounds(cfg, params, b, prompt, gen)
    depth = f"{L} layers" if L == full.num_layers else f"{L} of {full.num_layers} layers"
    row = dict(config=f"{arch} full width, {depth} (d_model {cfg.d_model}, {h} q / {kh} kv "
                      f"heads of {hd}, {cfg.mlp_type} d_ff {cfg.d_ff}, "
                      f"{'tied' if cfg.tie_embeddings else 'untied'} head of "
                      f"{cfg.padded_vocab}, bf16)",
               params=params, batch=b, prompt=prompt, gen=gen, max_len=max_len,
               init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               prefill_bound_tflop=serve_prefill_flops(cfg, params, b, prompt) / 1e12,
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               serve_peak_mem_gb=peak_own / 1e9, serve_peak_mem_bytes=peak_own,
               launches=launches, flash_routes=flash_routes, kernel_shapes=got_shapes,
               logits_finite=finite, repeat_identical=repeat,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit(phase, **row)
    del model, prefill, decode
    torch.cuda.empty_cache()
    return row


def dryrun_child(path: str) -> None:
    """The dry-run (``repro_torch.launch.dryrun``) of serve_nemotron's
    cells, in a process of its own beside the card's phases (its fake
    tensors never touch the card): nemotron-4-15b's prefill of SERVE's
    prompts into a cache of prompt + gen positions and its decode step at
    that cache, each the production step and the analysis probes, and
    deepseek-67b's decode at the same shape, the production step alone, and
    deepseek-67b cut to serve_deepseek's layers, its prefill and decode
    cells, the production steps alone, all on a (1, 1) mesh, which needs no
    process group. The cells' JSON go to ``path``."""
    import os
    if os.environ.get("PYTHONPYCACHEPREFIX"):    # bytecode_cache(): spawned with -B
        sys.dont_write_bytecode = False
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import Mesh

    torch.set_num_threads(1)
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    mesh = Mesh(("data", "model"), (1, 1))
    prefill = ShapeConfig("serve_prefill", prompt, b, "prefill")
    decode = ShapeConfig("serve_decode", prompt + gen, b, "decode")
    arch, over = get_arch(DRYRUN["arch"]), get_arch(DRYRUN["over"])
    cut = dataclasses.replace(over, num_layers=DENSE_SERVES[DRYRUN["cut"]][1])
    cells = {}
    t0 = time.perf_counter()
    for name, cfg, shape, kw in (
            ("prefill", arch, prefill, dict(max_len=prompt + gen)),
            ("decode", arch, decode, {}),
            ("over", over, decode, dict(production_only=True)),
            ("cut_prefill", cut, prefill, dict(max_len=prompt + gen, production_only=True)),
            ("cut_decode", cut, decode, dict(production_only=True))):
        cells[name] = run_cell(cfg, shape, mesh, "one_card", verbose=False, **kw)
    cells["seconds"] = time.perf_counter() - t0
    with open(path + ".tmp", "w") as f:
        json.dump(cells, f)
    os.replace(path + ".tmp", path)


def phase_dryrun(torch, child, path: str, served: dict, served_cut: dict) -> dict:
    """The dry-run's verdicts held against the card: ``dryrun_child``'s
    cells (started after the build, waited for here) beside
    serve_nemotron's and serve_deepseek's measured runs. Fails unless
    nemotron-4-15b's cells fit one card (it ran), deepseek-67b's decode
    does not (134.9 GB of bf16 parameters) and deepseek-67b cut to
    serve_deepseek's layers does (it ran), by the report's rule (peak <=
    hw.HBM_BYTES), and unless for both configs that ran the predicted peak
    (the larger of the prefill's and the decode's, of the plain forms) over
    the measured serve's own peak lies in DRYRUN["peak_band"]. Prints the analysis FLOPs of the prefill
    against ``serve_prefill_flops``'s count: dense attention computes every
    (q, k) pair where the causal count takes s(s+1)/2, and the bound counts
    the norms' weights as weights of products."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import peak_bytes
    from repro_torch.models import param_count
    from repro_torch.roofline import hw

    wait_children(*child)
    with open(path) as f:
        cells = json.load(f)
    pre, dec, over = cells["prefill"], cells["decode"], cells["over"]
    predicted = max(pre["peak_memory_per_device"], dec["peak_memory_per_device"])
    measured = served["serve_peak_mem_bytes"]
    over_peak = peak_bytes(over["memory_analysis"])
    cut_peaks = {kind: peak_bytes(cells[f"cut_{kind}"]["memory_analysis"])
                 for kind in ("prefill", "decode")}
    cut_predicted, cut_measured = max(cut_peaks.values()), served_cut["serve_peak_mem_bytes"]
    cut = f"{DRYRUN['over']} ({DENSE_SERVES[DRYRUN['cut']][1]} layers)"
    fits = {DRYRUN["arch"]: bool(pre["fits_hbm"] and dec["fits_hbm"]),
            DRYRUN["over"]: over_peak <= hw.HBM_BYTES, cut: cut_predicted <= hw.HBM_BYTES}
    if fits != {DRYRUN["arch"]: True, DRYRUN["over"]: False, cut: True}:
        fail(f"dryrun: fit verdicts {fits}; {DRYRUN['arch']} and {cut} ran on the card, "
             f"{DRYRUN['over']}'s parameters alone exceed it")
    lo, hi = DRYRUN["peak_band"]
    for name, p_, m_ in ((DRYRUN["arch"], predicted, measured),
                         (cut, cut_predicted, cut_measured)):
        if not lo <= p_ / m_ <= hi:
            fail(f"dryrun: {name}'s predicted peak {p_ / 1e9:.3f} GB, measured "
                 f"{m_ / 1e9:.3f} GB: predicted / measured outside [{lo}, {hi}]")
    cfg = get_arch(DRYRUN["arch"])
    b, prompt = SERVE["batch"], SERVE["prompt"]
    L, h, hd, d = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    bound_flops = serve_prefill_flops(cfg, param_count(cfg), b, prompt)
    upper = L * 2 * b * h * hd * prompt * (prompt - 1)       # pairs above the diagonal
    norms = 2 * (2 * L * d + d) * b * prompt                  # ln1, ln2, final_norm
    want = bound_flops + upper - norms
    flops_rel_err = abs(pre["flops_per_device"] - want) / want
    if flops_rel_err > 1e-6:
        fail(f"dryrun: analysis FLOPs {pre['flops_per_device']:.6e}, the bound's count "
             f"with dense attention and without the norms {want:.6e}")
    row = dict(config=f"{DRYRUN['arch']} serve cells on a (1, 1) mesh, fake tensors "
                      "(repro_torch.launch.dryrun.run_cell)",
               predicted_peak_gb=dict(prefill=pre["peak_memory_per_device"] / 1e9,
                                      decode=dec["peak_memory_per_device"] / 1e9),
               measured_serve_peak_gb=measured / 1e9,
               predicted_over_measured=predicted / measured, peak_band=DRYRUN["peak_band"],
               cut=dict(config=f"{cut} at serve_deepseek's shape, production steps",
                        predicted_peak_gb={k: v / 1e9 for k, v in cut_peaks.items()},
                        predicted_peak_bytes=cut_peaks, measured_serve_peak_gb=cut_measured / 1e9,
                        predicted_over_measured=cut_predicted / cut_measured,
                        memory_analysis={k: cells[f"cut_{k}"]["memory_analysis"]
                                         for k in cut_peaks}),
               memory_analysis=dict(prefill=pre["memory_analysis"],
                                    decode=dec["memory_analysis"]),
               fits_hbm=fits, over_peak_gb=over_peak / 1e9, hbm_gb=hw.HBM_BYTES / 1e9,
               analysis_prefill_flops=pre["flops_per_device"],
               bound_prefill_flops=bound_flops, dense_upper_triangle_flops=upper,
               norm_weight_flops=norms, flops_rel_err=flops_rel_err,
               roofline=dict(prefill={k: pre[k] for k in ("compute_s", "memory_s",
                                                         "bottleneck")},
                             decode={k: dec[k] for k in ("compute_s", "memory_s",
                                                        "bottleneck")}),
               recompute=pre["recompute"], child_s=cells["seconds"],
               production_step_s=dict(prefill=pre["compile_s"], decode=dec["compile_s"],
                                      over=over["compile_s"],
                                      cut_prefill=cells["cut_prefill"]["compile_s"],
                                      cut_decode=cells["cut_decode"]["compile_s"]))
    emit("dryrun", **row)
    return row


def phase_slice_encdec(torch):
    """whisper-small at full width (d_model 768, 12 heads of 64, gelu 3,072,
    the tied head of 51,968), cut to 2 encoder and 2 decoder layers, fp32:
    the same weights (drawn on the card, copied to the CPU) and the same
    frames (2 clips of 1,500, N(0, 1) from a seed) on the CPU (plain
    versions) and on the card (kernels). Prefill of a 16-token prompt, then
    8 decode steps (both sides take the CPU's greedy token): the logits of
    each, the self and cross caches after the prefill and after the steps,
    and the index; then the loss of 2 x 33 tokens and every gradient, at
    2e-4. The launches of each part are asserted exactly."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    m = ENCDEC_SLICE
    cfg = dataclasses.replace(get_arch("whisper-small"), num_layers=m["layers"],
                              encoder_layers=m["layers"], dtype="float32")
    L, senc = cfg.num_layers, cfg.encoder_seq
    t0 = time.perf_counter()
    card = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.standard_normal((m["batch"], senc, cfg.d_model),
                                                  dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (m["batch"], m["loss_tokens"])))
    prompt = tokens[:, :m["prompt"]]
    max_len = m["prompt"] + m["steps"]
    runs, launches = {}, {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        reset_launches()
        logits, cache = prefill(prompt.to(dev), max_len, None, frames.to(dev))
        # copies: decode writes the self cache in place (.cpu() of a CPU tensor is itself)
        run = dict(logits=[logits.cpu()], index=cache["index"],
                   **{key: cache[key].cpu().clone() for key in ("k", "v", "cross_k", "cross_v")})
        for step in range(m["steps"]):
            tok = (runs["cpu"] if name == "cuda" else run)["logits"][step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            run["logits"].append(logits.cpu())
        run.update({f"final_{key}": cache[key].cpu() for key in ("k", "v", "cross_k", "cross_v")})
        run["index_after"] = cache["index"]
        launches[name + "_serve"] = read_launches()
        del cache
        model.requires_grad_(True)
        reset_launches()
        loss, aux = model.loss({"tokens": tokens.to(dev), "frames": frames.to(dev)})
        loss.backward()
        launches[name + "_loss"] = read_launches()
        run["loss"] = [loss.detach().cpu(), aux["xent"].detach().cpu()]
        run["grads"] = {keystr(p): t for p, t in
                        tree_flatten_with_path(_host_tree(grad_tree(model)))}
        runs[name] = run
    none = {"flash_attention": 0, "decode_attention": 0, "ssd": 0,
            "ssd_routes": {"wgmma": 0, "fp32": 0}}
    # serve: flash once a layer in the encoder, twice a decoder layer (causal
    # self, cross) in the prefill; decode twice a decoder layer a step (self,
    # cross); the loss's forward flash as the prefill's, and its recompute
    expected = {"cpu_serve": none, "cpu_loss": none,
                "cuda_serve": dict(none, flash_attention=cfg.encoder_layers + 2 * L,
                                   decode_attention=2 * L * m["steps"]),
                "cuda_loss": dict(none, flash_attention=passes(cfg) * (cfg.encoder_layers
                                                                       + 2 * L))}
    if launches != expected:
        fail(f"slice_encdec: kernel launches {launches}, expected {expected}")
    want_index = (m["prompt"], m["prompt"] + m["steps"])
    for name, run in runs.items():
        if (run["index"], run["index_after"]) != want_index:
            fail(f"slice_encdec: {name} cache index {run['index']} then "
                 f"{run['index_after']}, expected {want_index}")
    errs = []
    for ref, out in zip(runs["cpu"]["logits"], runs["cuda"]["logits"]):
        if out.shape != (m["batch"], cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice_encdec: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice_encdec logits card vs cpu", out, ref, m["tol"]))
    keys = ("k", "v", "cross_k", "cross_v")
    cache_err = {key: check_close(f"slice_encdec cache {key} card vs cpu", runs["cuda"][key],
                                  runs["cpu"][key], m["tol"])
                 for key in keys + tuple(f"final_{k_}" for k_ in keys)}
    for key in ("cross_k", "cross_v"):
        if runs["cuda"][key].shape != (L, m["batch"], senc, cfg.num_kv_heads,
                                       cfg.resolved_head_dim) \
                or not torch.equal(runs["cuda"][key], runs["cuda"]["final_" + key]):
            fail(f"slice_encdec: the card's {key} is not (L, B, {senc}, K, hd) or changed "
                 "in the decode steps")
    loss_err = {part: check_close(f"slice_encdec {part} card vs cpu", got, want, m["tol"])
                for part, got, want in zip(("loss", "xent"), runs["cuda"]["loss"],
                                           runs["cpu"]["loss"])}
    grad_err = {k: check_close(f"slice_encdec grad {k} card vs cpu", runs["cuda"]["grads"][k],
                               ref, m["tol"]) for k, ref in runs["cpu"]["grads"].items()}
    for k, g in runs["cuda"]["grads"].items():
        if not torch.isfinite(g).all() or not (g != 0).any():
            fail(f"slice_encdec: gradient {k} is not finite or is all 0")
    row = dict(config=f"whisper-small full width, {cfg.encoder_layers} encoder + {L} decoder "
                      "layers, fp32, 12 heads of 64 (MHA)",
               batch=m["batch"], frames=senc, prompt=m["prompt"], decode_steps=m["steps"],
               loss_tokens=list(tokens.shape), init_s=init_s,
               logits_max_abs_err_per_step=errs, cache_max_abs_err=cache_err,
               index=list(want_index), loss=float(runs["cuda"]["loss"][0]), loss_err=loss_err,
               grad_leaves=len(grad_err), grad_max_abs_err=max(grad_err.values()),
               cross_grad_err={k: v for k, v in grad_err.items()
                               if "|cross|" in k or k.startswith("encoder")},
               tol=m["tol"], launches=launches)
    emit("slice_encdec", **row)
    del cpu, card, runs
    torch.cuda.empty_cache()
    return row


def encdec_serve_bounds(cfg, b: int, prompt: int, gen: int):
    """The card's least time for the enc-dec serve run's prefill and for its
    mean decode step, bf16. Prefill: the encoder's matrix products (2 x its
    weights x B x Senc) and full-square attention (4 B H hd Senc^2 a layer),
    cross_kv (2 x wk, wv x B x Senc a decoder layer), the decoder's products
    over the prompt (self-attention, cross q and o, MLP), its causal and
    cross attention, and the head at the last position; every weight, the
    frames and the caches written once. Decode: the decoder's products and
    the tied head for one token a row, self attention over the attended
    lengths, cross attention over Senc; the decoder's weights but the cross
    wk and wv (their products are the cross cache, read instead), the
    embedding table (the head reads it whole) and both caches read once."""
    from repro_torch.roofline.hw import bound_seconds
    L, Le, senc = cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn_w = 2 * d * h * hd + 2 * d * kh * hd          # wq, wo, wk, wv
    mlp_w = 2 * d * f                                  # w_up, w_down (gelu)
    norms = 2 * d                                      # ln1, ln2
    enc_params = Le * (attn_w + mlp_w + norms) + d     # and enc_norm
    dec_params = L * (2 * attn_w + mlp_w + norms + d) + d
    params = enc_params + dec_params + v * d
    dec_token_w = 2 * d * h * hd + 2 * d * kh * hd + 2 * d * h * hd + mlp_w  # a token a layer
    cross_kv_w = 2 * d * kh * hd
    prefill_flops = (2 * Le * (attn_w + mlp_w) * b * senc + Le * 4 * b * h * hd * senc ** 2
                     + 2 * L * cross_kv_w * b * senc + 2 * L * dec_token_w * b * prompt
                     + L * 4 * b * h * hd * (prompt * (prompt + 1) // 2 + prompt * senc)
                     + 2 * v * d * b)
    kv_pos = 2 * L * b * kh * hd * 2                   # self K and V a position, bf16
    cross_bytes = kv_pos * senc                        # the cross cache, bf16
    prefill_bytes = 2 * params + 2 * b * senc * d + kv_pos * prompt + cross_bytes
    lens = range(prompt + 1, prompt + gen)             # attended self lengths per step
    steps = gen - 1
    decode_flops = (2 * (L * dec_token_w + v * d) * b
                    + L * 4 * b * h * hd * (sum(lens) / steps + senc))
    decode_bytes = (2 * (dec_params - L * cross_kv_w + v * d) + kv_pos * sum(lens) / steps
                    + cross_bytes)
    return (bound_seconds(prefill_flops, prefill_bytes, "bfloat16"),
            bound_seconds(decode_flops, decode_bytes, "bfloat16"),
            dict(params=params, prefill_tflop=prefill_flops / 1e12,
                 prefill_gbytes=prefill_bytes / 1e9,
                 decode_gflop=decode_flops / 1e9, decode_gbytes=decode_bytes / 1e9,
                 cross_cache_gbytes=cross_bytes / 1e9))


def phase_serve_encdec(torch):
    """Full whisper-small (12 encoder and 12 decoder layers, d_model 768, 12
    heads of 64, gelu 3,072, the tied head of 51,865 padded to 51,968,
    bf16, random weights drawn on the card from a seed): 8 clips of 1,500
    frame embeddings (N(0, 1) in bf16 from a seed), a 16-token prompt, 32
    greedy tokens, served twice (the first a warm-up, the repeat must give
    its tokens). 36 flash launches on wgmma (12 non-causal at q/k/v (8,
    1500, 12, 64), 12 causal at (8, 16, 12, 64), 12 non-causal at q (8, 16,
    12, 64) against k/v (8, 1500, 12, 64)), 12 x 2 x 31 decode launches
    (against the self cache (8, 48, 12, 64) at cur_len 17..47 and the cross
    cache (8, 1500, 12, 64) at cur_len 1,500), no SSD launch, the calls'
    shapes recorded by wrapping ``ops``; prefill and decode times beside
    their bounds. Freed after."""

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("whisper-small")
    b, prompt, gen = ENCDEC_SERVE["batch"], ENCDEC_SERVE["prompt"], ENCDEC_SERVE["gen"]
    L, senc = cfg.num_layers, cfg.encoder_seq
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    max_len = prompt + gen
    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((b, senc, cfg.d_model), device="cuda", dtype=torch.bfloat16,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    prefill = functools.partial(build_prefill_step(model), frames=frames)
    decode = build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, max_len, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with record_kernel_calls() as calls:
        seqs, finite, t_prefill, t_decode, shape = serve_once(
            torch, prefill, decode, tokens, max_len, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    expected = {"flash_attention": 3 * L, "decode_attention": 2 * L * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    enc_shape, dec_shape = (b, senc, h, hd), (b, prompt, h, hd)
    self_cache, cross_cache = (b, max_len, h, hd), (b, senc, h, hd)
    want_calls = {"flash": {(enc_shape, enc_shape, False): cfg.encoder_layers,
                            (dec_shape, dec_shape, True): L,
                            (dec_shape, enc_shape, False): L},
                  "decode": {((b, 1, h, hd), self_cache): L * (gen - 1),
                             ((b, 1, h, hd), cross_cache): L * (gen - 1)}}
    want_lens = {self_cache: (prompt + 1, prompt + gen - 1), cross_cache: (senc, senc)}
    got_calls = {k: dict(calls[k]) for k in ("flash", "decode")}
    got_lens = {k: (min(v), max(v)) for k, v in calls["cur_lens"].items()}
    if launches != expected or flash_routes != {"wgmma": 3 * L, "fp32": 0}:
        fail(f"serve_encdec: kernel launches {launches}, flash routes {flash_routes}; "
             f"expected {expected}, flash all on wgmma")
    if got_calls != want_calls or got_lens != want_lens \
            or calls["cur_lens"][cross_cache] != {senc}:
        fail(f"serve_encdec: kernel calls {got_calls}, decode cur_len ranges {got_lens}; "
             f"expected {want_calls}, {want_lens}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_encdec: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_encdec: generated tokens out of range")
    repeat = bool((warm == seqs).all())
    if not repeat:
        fail("serve_encdec: the repeat generated other tokens than the warm-up")
    params = param_count(cfg)
    prefill_bound, decode_bound, work = encdec_serve_bounds(cfg, b, prompt, gen)
    if work["params"] != params:
        fail(f"serve_encdec: the bound counts {work['params']} parameters, the model "
             f"{params}")
    row = dict(config=f"whisper-small full ({cfg.encoder_layers} encoder + {L} decoder layers, "
                      f"d_model {cfg.d_model}, {h} heads of {hd}, tied head, bf16)",
               params=params, batch=b, frames=senc, prompt=prompt, gen=gen,
               max_len=max_len, init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode, bound_work=work,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes,
               kernel_calls={k: [[list(map(list, key[:2])) + list(key[2:]), n]
                                 for key, n in sorted(v.items())]
                             for k, v in got_calls.items()},
               decode_cur_len_ranges=[[list(k), list(v)] for k, v in sorted(got_lens.items())],
               logits_finite=finite, repeat_identical=repeat,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve_encdec", **row)
    del model, prefill, decode, frames
    torch.cuda.empty_cache()
    return row


def phase_trace_moe(torch, phase: str = "serve_moe_30b"):
    """The MoE serve's config of ``phase`` built again from the same seed
    (its serve phase freed it) for a torch.profiler window over its prefill
    and 2 decode steps, placed after every timed serve (a serve run after a
    profiler session is slower on the host): the device's busy time of a
    decode step (the summed device activities, one stream), its share of
    the wall time, and the time by kernel group: the decode step's device
    time (CUDA events cannot take it: a step's ~7,000 device activities
    fill the launch queue, so the host cannot enqueue a step ahead of the
    device). Freed after."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch(MOE_SERVES[phase]["arch"])
    # 2 steps: the profiler's cost grows with the ~7,000 device activities a step
    b, prompt, gen, steps = SERVE["batch"], SERVE["prompt"], SERVE["gen"], 2
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(tokens, prompt + gen)

    def run_decode():
        logits, cache = state["logits"], state["cache"]
        for _ in range(steps):
            logits, cache = decode(cache, logits.argmax(-1))

    rows = {}
    for part, fn in (("prefill", run_prefill), (f"decode x{steps}", run_decode)):
        rows[part] = device_share(torch, fn, classify=serve_kernel_group)
        emit("trace", model=cfg.name, part=part, **rows[part])
    busy = rows[f"decode x{steps}"]["device_busy_ms"]
    del model, prefill, decode, state
    torch.cuda.empty_cache()
    return dict(ms=None if busy is None else busy / steps, method="torch.profiler (CUPTI)",
                steps=steps, wall_ms=rows[f"decode x{steps}"]["wall_ms"] / steps,
                device_busy_share=rows[f"decode x{steps}"]["device_busy_share"],
                groups=rows[f"decode x{steps}"].get("groups"),
                prefill_device_busy_ms=rows["prefill"]["device_busy_ms"])


def phase_train_ssm(torch):
    """mamba2-2.7b at full width, cut to TRAIN_SSM's layers, trained by the port's
    SimCluster with a failure and a stream recovery in the middle: the SSD
    kernel under autograd on the main training path."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import param_count
    from repro_torch.roofline.hw import bound_seconds

    t = TRAIN_SSM
    cfg = dataclasses.replace(get_arch("mamba2-2.7b"), num_layers=t["layers"])
    run = train_through_a_failure(torch, "train_ssm", cfg, t, "chip_smoke_ssm_ckpt")
    steps, losses = run["steps"], run["losses"]
    ssd = passes(cfg) * cfg.num_layers * steps          # the forward and the recompute
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": ssd,
                "ssd_routes": {"wgmma": ssd, "fp32": 0}}
    if run["launches"] != expected:
        fail(f"train_ssm: kernel launches {run['launches']}, expected {expected}")
    # the loss falls: the first step's batch (the same tokens, from the
    # loaders) scored again after the run. Each step's own batch is new
    # uniform random tokens, whose loss moves by batch noise more than by
    # what 3 updates can learn about them.
    clu = run["clu"]
    batch0 = {"tokens": torch.from_numpy(np.concatenate(
        [w.loader.get(0) for w in clu.workers[:clu.active_dp]], axis=0)).to(clu.device)}
    with torch.no_grad():
        first_batch_loss_after = float(clu.model.loss(batch0)[0])
    del clu, batch0
    if not first_batch_loss_after < losses[0]:
        fail(f"train_ssm: the first batch's loss {losses[0]} before the run, "
             f"{first_batch_loss_after} after it; expected it to fall")

    params = param_count(cfg)
    # 6 operations per parameter and token, and the SSD's own (forward once,
    # backward twice the forward's)
    ssd_flops, _ = ssd_full_work(t["global_batch"], t["seq_len"], cfg.ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, 2)
    flops = (6 * params * t["global_batch"] * t["seq_len"]
             + 3 * cfg.num_layers * ssd_flops)
    bound = bound_seconds(flops, params * (2 + 2 + 2 + 3 * 4 * 2), "bfloat16")
    row = dict(config=f"mamba2-2.7b full width, {cfg.num_layers} of 64 layers, bf16",
               **train_row(torch, run, t, params, bound, flops),
               first_batch_loss_after=first_batch_loss_after)
    row["host_rss_after_free_gb"] = close_cluster(torch, run)
    emit("train_ssm", **row)
    return row


def bytecode_cache() -> None:
    """Let this process and the ranks it spawns cache the bytecode of the
    modules they import, under build/pycache of the checkout: a Python run
    with PYTHONDONTWRITEBYTECODE (or a read-only installation) compiles
    every module from source in every process, several seconds a spawned
    rank, and torch.utils.checkpoint's first call imports torch._dynamo.
    A spawned child inherits -B from this process's flags: ``mesh_rank``
    turns the writing on again before it imports torch."""
    import os
    cache = str(ROOT / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    bytecode_cache()
    torch.backends.cuda.matmul.allow_tf32 = False      # full fp32 comparisons
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    path, build_s, log = _build.build()
    emit("build", seconds=build_s, library=str(path.relative_to(ROOT)),
         sources=[str(s.relative_to(ROOT)) for s in _build._sources()],
         ptxas=ptxas_summary(log), sass_hgmma=sass_hgmma(path))
    # the dry-run of serve_nemotron's cells runs on the host beside the
    # card's phases, in its own process (fake tensors, no card)
    dry_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    dry_path = f"{dry_dir.name}/cells.json"
    dry_child = ("dryrun", start_children([(dryrun_child, (dry_path,))]), 900)

    # the slices and both serve runs come before any torch.profiler session
    timed("slice", phase_slice, torch)
    served, serve = timed("serve", phase_serve, torch)
    timed("slice_ssm", phase_slice_ssm, torch)
    ssm_model, ssm_prefill, ssm_decode, ssm_tokens, serve_ssm = timed(
        "serve_ssm", phase_serve_ssm, torch)
    serve_hybrid = timed("serve_hybrid", phase_serve_hybrid, torch)
    timed("slice_moe", phase_slice_moe, torch)
    serve_moe = timed("serve_moe", phase_serve_moe, torch)
    timed("slice_vlm", phase_slice_vlm, torch)
    serve_vlm = timed("serve_vlm", phase_serve_vlm, torch)
    # qwen3-moe-30b-a3b (61.1 GB of bf16 weights) once internvl2-26b is freed
    # and before internvl2-26b's (b) reference takes 38 GB of the card
    timed("slice_moe_30b", phase_slice_moe, torch, MOE_SLICE_30B)
    serve_moe_30b = timed("serve_moe_30b", phase_serve_moe, torch, "serve_moe_30b")
    # nemotron-4-15b (31.3 GB of bf16) once qwen3-moe-30b-a3b is freed, before
    # internvl2-26b's (b) reference takes 38 GB of the card
    timed("slice_nemotron", phase_slice_dense, torch, NEMOTRON_SLICE)
    serve_nemotron = timed("serve_nemotron", phase_serve_dense, torch, "serve_nemotron")
    # deepseek-67b cut to 16 layers (25.5 GB of bf16) once nemotron is freed
    serve_deepseek = timed("serve_deepseek", phase_serve_dense, torch, "serve_deepseek")
    # the paper's GPT-2 2.7B: head_dim 80 on both attention kernels
    timed("slice_gpt2", phase_slice_dense, torch, GPT2_SLICE)
    serve_gpt2 = timed("serve_gpt2", phase_serve_dense, torch, "serve_gpt2")
    timed("dryrun", phase_dryrun, torch, dry_child, dry_path, serve_nemotron, serve_deepseek)
    dry_dir.cleanup()
    with contextlib.ExitStack() as stack:
        tmp = {phase: stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"chip_smoke_{phase}_")) for phase in TRAIN_MESH_PHASES}
        # internvl2-26b's (b) reference (38 GB on the card) beside the light
        # phases that follow, once serve_vlm has freed its model
        ref = {"train_vlm_mesh": start_reference("train_vlm_mesh", TRAIN_VLM_B,
                                                 tmp["train_vlm_mesh"])}
        timed("slice_encdec", phase_slice_encdec, torch)
        serve_encdec = timed("serve_encdec", phase_serve_encdec, torch)
        timed("train_grad", phase_train_grad, torch)
        train_mesh, train_tp, train_moe_mesh, train_gemma_mesh, train_vlm_mesh = timed(
            "train_group", phase_train_group, torch, tmp, ref["train_vlm_mesh"])
    group = timed("mesh_group", phase_mesh_group, torch)
    serve_mesh, serve_vlm_mesh = group["serve_mesh"], group["serve_vlm_mesh"]
    encdec_mesh = group["encdec_mesh"]
    serve_encdec_mesh = encdec_mesh["serve"]
    pipeline = timed("pipeline", phase_pipeline, torch)
    scenarios = timed("scenarios", phase_scenarios, torch)
    train_ssm = timed("train_ssm", phase_train_ssm, torch)
    train = timed("train", phase_train, torch)
    train_gpt2 = timed("train_gpt2", phase_train_gpt2, torch)
    kernels = timed("kernels", phase_kernels, torch, F)
    ssd_rows = timed("kernels", phase_ssd_kernel, torch)
    _, prefill, decode, tokens, _ = served
    timed("trace", phase_trace, torch, prefill, decode, tokens, "qwen3-0.6b")
    timed("trace", phase_trace, torch, ssm_prefill, ssm_decode, ssm_tokens, "mamba2-2.7b")
    del ssm_model, ssm_prefill, ssm_decode
    torch.cuda.empty_cache()
    emit("serve_moe_30b_decode_device",
         **timed("trace", phase_trace_moe, torch, "serve_moe_30b"))
    timed("serve", phase_serve, torch, served)        # the same serve, after the profiler

    fa = kernels["flash_attention"]["bfloat16"]
    fa_train = kernels["flash_attention"]["bfloat16_train"]
    da = kernels["decode_attention"]["bfloat16"]
    da_main = da[-1]                                  # cur_len 1032 = the cache length
    ssd_main = ssd_rows[("mamba2-2.7b", SERVE["prompt"], "bfloat16")]  # the serve run's shape
    ssd_hyb = ssd_rows[("zamba2-7b", SERVE["prompt"], "bfloat16")]
    keys = ("shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def hd112(rows):
        """The hd-112 rows (bf16, fp32) of one kernel for the kernels line."""
        return {dname: {k_: row[k_] for k_ in keys} for dname, row in rows.items()}

    def moe_shape(row):
        """A kernel's row at qwen2-moe-a2.7b's shape (bf16) for the kernels line."""
        return {k_: row[k_] for k_ in keys}
    line = [
        dict(name="flash_attention", route="cuda", dispatch=fa["route"],
             source="src/repro_torch/csrc/flash_attention_wgmma.cu",
             fp32_source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:25",
             tpu_kernel="_flash_fwd_kernel (pl.pallas_call at flash_attention.py:80)",
             design="redesigned for Hopper: bf16 Q.K^T and P.V on wgmma with P kept in "
                    "registers; TMA loads by a producer warp into a 3-stage swizzled ring; two "
                    "consumer warpgroups in ping-pong; fp32 inputs on the CUDA-core kernel",
             launches=serve["launches"]["flash_attention"],
             train_launches=train["launches"]["flash_attention"],
             scenario_launches=dict(
                 corpus=scenarios["corpus"]["launches"]["flash_attention"],
                 full_width=scenarios["replay"]["launches"]["flash_attention"]),
             max_abs_err=fa["max_abs_err"], tol=fa["tol"], shape=fa["shape"],
             dtype="bfloat16", ms=fa["ms"], plain_ms=fa["plain_ms"],
             bound_ms=fa["bound_ms"], bound_by=fa["bound_by"], library_ms=fa["library_ms"],
             timing=fa["timing"],
             train_shape={k_: fa_train[k_] for k_ in ("shape", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
             hybrid_launches=serve_hybrid["launches"]["flash_attention"],
             train_ssm_launches=train_ssm["launches"]["flash_attention"],
             train_mesh_launches=train_mesh["flash_launches"],
             hd112=hd112({d: kernels["flash_attention"][f"{d}_hd112"]
                          for d in ("bfloat16", "float32")}),
             moe_launches=serve_moe["launches"]["flash_attention"],
             moe_shape=moe_shape(kernels["flash_attention"]["bfloat16_moe"]),
             train_tp_launches=train_tp["flash_launches"],
             tp_shape={d: moe_shape(kernels["flash_attention"][f"{d}_tp"])
                       for d in ("bfloat16", "float32")},
             train_moe_mesh_launches=train_moe_mesh["flash_launches"],
             moe_mesh_shape=moe_shape(kernels["flash_attention"]["bfloat16_moe_tp"]),
             pipeline_launches={p["config"]: p["flash_launches"] for p in pipeline["parts"]},
             pipeline_shape=moe_shape(kernels["flash_attention"]["bfloat16_pipe"]),
             train_gemma_mesh_launches=dict(
                 a=train_gemma_mesh["flash_launches"],
                 b_rank0=train_gemma_mesh["part_b"]["launches"]["flash_routes"]),
             serve_mesh_launches=dict(
                 a=serve_mesh["launches_per_rank"]["flash_attention"],
                 b=serve_mesh["part_b"]["launches_per_rank"]["flash_attention"]),
             gemma_tp_shape={d: moe_shape(kernels["flash_attention"][f"{d}_gemma_tp"])
                             for d in ("bfloat16", "float32")},
             hd256={d: moe_shape(kernels["flash_attention"][f"{d}_hd256"])
                    for d in ("bfloat16", "float32")},
             vlm_launches=serve_vlm["launches"]["flash_attention"],
             vlm_shape={d: moe_shape(kernels["flash_attention"][f"{d}_vlm"])
                        for d in ("bfloat16", "float32")},
             vlm_mesh_launches=dict(
                 train_a=train_vlm_mesh["flash_launches"],
                 train_b_rank0=train_vlm_mesh["part_b"]["launches"]["flash_routes"],
                 serve_a=serve_vlm_mesh["launches_per_rank"]["flash_attention"],
                 serve_b=serve_vlm_mesh["part_b"]["launches_per_rank"]["flash_attention"]),
             vlm_mesh_shape={f"{d}_{part}": moe_shape(kernels["flash_attention"][
                                 f"{d}_vlm_{key}"])
                             for d in ("bfloat16", "float32")
                             for part, key in (("train", "tp"), ("serve", "serve_tp"))},
             encdec_launches=serve_encdec["launches"]["flash_attention"],
             encdec_shape={f"{d}_{part}": moe_shape(kernels["flash_attention"][
                               f"{d}_encdec_{part}"])
                           for d in ("bfloat16", "float32")
                           for part in ("enc", "self", "cross")},
             encdec_mesh_launches=dict(
                 train_a=encdec_mesh["flash_launches"],
                 train_b_rank0=encdec_mesh["part_b"]["launches"]["flash_routes"],
                 serve_a=serve_encdec_mesh["launches_per_rank"]["flash_attention"],
                 serve_b=serve_encdec_mesh["part_b"]["launches_per_rank"]["flash_attention"]),
             encdec_mesh_shape={f"{d}_{part}": moe_shape(kernels["flash_attention"][
                                    f"{d}_encdec_{part}_tp"])
                                for d in ("bfloat16", "float32") for part in ("enc", "cross")},
             moe_30b_launches=serve_moe_30b["launches"]["flash_attention"],
             moe_30b_shape={d: moe_shape(kernels["flash_attention"][f"{d}_moe30"])
                            for d in ("bfloat16", "float32")},
             nemotron_launches=serve_nemotron["launches"]["flash_attention"],
             nemotron_shape={d: moe_shape(kernels["flash_attention"][f"{d}_nemotron"])
                             for d in ("bfloat16", "float32")},
             gpt2_launches=dict(serve=serve_gpt2["launches"]["flash_attention"],
                                train=train_gpt2["launches"]["flash_attention"],
                                train_routes=train_gpt2["flash_routes"]),
             hd80={key: moe_shape(kernels["flash_attention"][key])
                   for key in ("bfloat16_gpt2", "float32_gpt2", "bfloat16_gpt2_train")},
             deepseek_launches=serve_deepseek["launches"]["flash_attention"],
             deepseek_shape={d: moe_shape(kernels["flash_attention"][f"{d}_deepseek"])
                             for d in ("bfloat16", "float32")},
             backward="plain blockwise_attention recompute (FlashAttention), no kernel"),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attn.cu",
             replaces="src/repro/kernels/decode_attn.py:24",
             tpu_kernel="_decode_kernel (pl.pallas_call at decode_attn.py:71)",
             design="redesigned for Hopper: split over the cache, grid (K, B, n_split), "
                    "partials merged by a second grid in the same call",
             n_split=da_main["n_split"], rows_per_split=da_main["rows_per_split"],
             launches=serve["launches"]["decode_attention"],
             train_launches=train["launches"]["decode_attention"],
             scenario_launches=scenarios["replay"]["launches"]["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in da), tol=da_main["tol"],
             shape=da_main["shape"], cur_len=da_main["cur_len"], dtype="bfloat16",
             ms=da_main["ms"], plain_ms=da_main["plain_ms"],
             bound_ms=da_main["bound_ms"], bound_by=da_main["bound_by"],
             library_ms=da_main["library_ms"], timing=da_main["timing"],
             hybrid_launches=serve_hybrid["launches"]["decode_attention"],
             train_ssm_launches=train_ssm["launches"]["decode_attention"],
             hd112=hd112({d: kernels["decode_attention"][f"{d}_hd112"][-1]
                          for d in ("bfloat16", "float32")}),
             moe_launches=serve_moe["launches"]["decode_attention"],
             train_tp_launches=train_tp["decode_launches"],
             train_moe_mesh_launches=train_moe_mesh["decode_launches"],
             train_gemma_mesh_launches=train_gemma_mesh["decode_launches"],
             train_vlm_mesh_launches=train_vlm_mesh["decode_launches"],
             moe_shape=moe_shape(kernels["decode_attention"]["bfloat16_moe"][-1]),
             serve_mesh_launches=dict(
                 a=serve_mesh["launches_per_rank"]["decode_attention"],
                 b=serve_mesh["part_b"]["launches_per_rank"]["decode_attention"],
                 note="a rank's, block form on its 516 of 1,032 positions, every layer "
                      "and decode step"),
             hd256={f"{d}_{form}": moe_shape(kernels["decode_attention"][f"{d}_{key}"][-1])
                    for d in ("bfloat16", "float32")
                    for form, key in (("block", "hd256_block"), ("serve", "hd256"))},
             vlm_launches=serve_vlm["launches"]["decode_attention"],
             vlm_shape={f"{d}_{form}": moe_shape(kernels["decode_attention"][f"{d}_{key}"][-1])
                        for d in ("bfloat16", "float32")
                        for form, key in (("serve", "vlm"), ("block", "vlm_block"))},
             vlm_mesh_launches=dict(
                 a=serve_vlm_mesh["launches_per_rank"]["decode_attention"],
                 b=serve_vlm_mesh["part_b"]["launches_per_rank"]["decode_attention"],
                 note="a rank's, block form on its 1,028 of 2,056 positions, every layer "
                      "and decode step"),
             vlm_mesh_shape={f"{d}_{c}": moe_shape(row)
                             for d in ("bfloat16", "float32")
                             for c, row in zip(("part", "full"), kernels["decode_attention"][
                                 f"{d}_vlm_mesh_block"])},
             encdec_launches=serve_encdec["launches"]["decode_attention"],
             encdec_shape={f"{d}_{part}": moe_shape(
                               kernels["decode_attention"][f"{d}_encdec_{part}"][-1])
                           for d in ("bfloat16", "float32") for part in ("self", "cross")},
             train_encdec_mesh_launches=encdec_mesh["decode_launches"],
             encdec_mesh_launches=dict(
                 a=[x["decode_attention"] for x in serve_encdec_mesh["launches_by_rank"]],
                 b=[x["decode_attention"]
                    for x in serve_encdec_mesh["part_b"]["launches_by_rank"]],
                 note="per rank, block form: 372 on its 750 of the 1,500 cross positions "
                      "(cur_len 750) and one a layer and step on its 24 of the 48 self "
                      "positions where they hold one below index + 1 (rank 1's from the "
                      "9th step)"),
             encdec_mesh_shape={f"{d}_cross_block": moe_shape(
                                    kernels["decode_attention"][f"{d}_encdec_mesh_block"][-1])
                                for d in ("bfloat16", "float32")},
             moe_30b_launches=serve_moe_30b["launches"]["decode_attention"],
             moe_30b_shape={d: moe_shape(kernels["decode_attention"][f"{d}_moe30"][-1])
                            for d in ("bfloat16", "float32")},
             nemotron_launches=serve_nemotron["launches"]["decode_attention"],
             nemotron_shape={f"{d}_{row['cur_len']}": moe_shape(row)
                             for d in ("bfloat16", "float32")
                             for row in kernels["decode_attention"][f"{d}_nemotron"]},
             gpt2_launches=dict(serve=serve_gpt2["launches"]["decode_attention"],
                                train=train_gpt2["launches"]["decode_attention"]),
             hd80={f"{d}_{form}_{row['cur_len']}": moe_shape(row)
                   for d in ("bfloat16", "float32")
                   for form, key in (("serve", "gpt2"), ("block", "gpt2_block"))
                   for row in kernels["decode_attention"][f"{d}_{key}"]},
             hd80_two_blocks_merged=kernels["decode_attention"]["gpt2_merge"],
             deepseek_launches=serve_deepseek["launches"]["decode_attention"],
             deepseek_shape={f"{d}_{row['cur_len']}": moe_shape(row)
                             for d in ("bfloat16", "float32")
                             for row in kernels["decode_attention"][f"{d}_deepseek"]},
             head_dims="16, 32, 64, 80 and 112 (on 128's lanes), 128, 256 (two loads a lane "
                       "in fp32)",
             groups="1, 2, 4, 6, 8 q heads per kv head"),
        dict(name="ssd", route="cuda", dispatch=ssd_main["route"],
             source="src/repro_torch/csrc/ssd_wgmma.cu",
             fp32_source="src/repro_torch/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:24",
             tpu_kernel="_ssd_chunk_kernel (pl.pallas_call at ssd.py:76) and the plain "
                        "inter-chunk combine of ssd() (ssd.py:128-154)",
             design="redesigned for Hopper: the whole SSD in one launch, a block per (batch, "
                    "2 heads) walking 64-row steps with the state in registers; scores, "
                    "inter and intra terms and the state update on wgmma, weighted operands "
                    "split into bf16 high and low parts; TMA issued by one thread; y written "
                    "once in bf16; fp32 inputs on the CUDA-core kernel plus a plain combine",
             launches=serve_ssm["launches"]["ssd"],
             train_launches=train["launches"]["ssd"],
             scenario_launches=scenarios["replay"]["launches"]["ssd"],
             max_abs_err=ssd_main["max_abs_err"], tol=ssd_main["tol"],
             final_state_err=ssd_main["final_state_err"], state_tol=STATE_TOL,
             shape=ssd_main["shape"], dtype="bfloat16", ms=ssd_main["ms"],
             plain_ms=ssd_main["plain_ms"], bound_ms=ssd_main["bound_ms"],
             bound_by=ssd_main["bound_by"], library_ms=None,
             library_note=ssd_main["library_note"], timing=ssd_main["timing"],
             hybrid_launches=serve_hybrid["launches"]["ssd"],
             train_ssm_launches=train_ssm["launches"]["ssd"],
             hybrid_shape={k_: ssd_hyb[k_] for k_ in keys},
             moe_launches=serve_moe["launches"]["ssd"],
             train_tp_launches=train_tp["ssd_launches"],
             train_moe_mesh_launches=train_moe_mesh["ssd_launches"],
             train_gemma_mesh_launches=train_gemma_mesh["ssd_launches"],
             serve_mesh_launches=serve_mesh["launches_per_rank"]["ssd"],
             train_vlm_mesh_launches=train_vlm_mesh["ssd_launches"],
             serve_vlm_mesh_launches=serve_vlm_mesh["launches_per_rank"]["ssd"],
             vlm_launches=serve_vlm["launches"]["ssd"],
             encdec_launches=serve_encdec["launches"]["ssd"],
             encdec_mesh_launches=dict(
                 train_a=encdec_mesh["ssd_launches"],
                 serve_a=[x["ssd"] for x in serve_encdec_mesh["launches_by_rank"]]),
             moe_30b_launches=serve_moe_30b["launches"]["ssd"],
             nemotron_launches=serve_nemotron["launches"]["ssd"],
             gpt2_launches=dict(serve=serve_gpt2["launches"]["ssd"],
                                train=train_gpt2["launches"]["ssd"]),
             deepseek_launches=serve_deepseek["launches"]["ssd"],
             tp_shapes={model: {k_: ssd_rows[(f"{model}/tp2", 1024, "bfloat16")][k_]
                                for k_ in keys}
                        for model in ("mamba2-2.7b", "zamba2-7b")},
             backward="plain ssd_chunked recompute (SSD), no kernel"),
    ]
    emit("timing", kernel_timings=TIMING, profiler_sessions=PROFILER_SESSIONS[0],
         phase_s=PHASE_S, script_s=time.perf_counter() - T_START)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
