#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises and exits non-zero,
with no final ``ok`` line):

  1. device   — fail without CUDA; print the card's name and power limit
                (nvidia-smi) and build the kernels from ``src/repro_torch/
                csrc`` (nvcc, one process per source); a line each of
                ptxas's registers, shared memory, spills and performance
                warnings for the tensor-core kernels, swa_tc_kernel and
                ssd_tc_kernel, and the fp32 routes' 3xTF32 kernels,
                swa_kernel (with swa_combine_kernel), ssd_kernel,
                ssd_cell_kernel, edc_part_kernel and edc_sums_kernel.
  2. kernels  — each hand-written kernel against its plain PyTorch version
                on the same inputs at the main paths' shapes and ragged ones:
                max abs error (within atol + rtol·|plain|, elementwise:
                3e-5 for edc_cosine / madc / swa_attention's fp32 route,
                2e-4 for both ssd_intra_chunk routes — fp32 sums in another
                order from the same inputs (the tensor-core route splits its
                fp32 operands into three bf16 terms, in two decay regimes);
                1e-2 for swa_attention's tensor-core
                route, which rounds P to bf16 before P·V), kernel / plain /
                library-call time (CUDA events, warmed, many launches), the
                least time the card could take (bytes over 3.35 TB/s or
                FLOPs over the peak of the input type: 989 TFLOP/s bf16
                tensor cores, 67 TFLOP/s fp32; for the fp32 routes also the
                bound of their units: three TF32 products per fp32
                product at 495 TFLOP/s); at each main-path shape and at
                the fp32 routes' zamba2-prefill-fp32 shapes also the
                device time from torch.profiler and the wrapper's host
                time per call (1,000 calls, no synchronise); for every
                edc_cosine case (m = 5 at the main shape, m = 17 and 32
                at n = 200, m = 100 in bf16, ragged ones) the device time,
                the host time (median of 5 bursts of 100 calls, below the
                launch queue's depth), bit-repeatability,
                F.cosine_similarity's time (where its (n, d, m) broadcast
                passes 8 GB, the sum of its times over column chunks of V
                that fit, with the chunks and the whole broadcast's
                bytes), and
                the time of dW.sum(), a pass that only reads ΔW;
                edc_cosine's partial-sum entry (``edc_cosine_partial``:
                the packed dots and sums of squares of a d-block, nothing
                divided) at a rank's block of phase 6e's ΔW, n 64, d
                51,907,328, m 5, fp32 and bf16, against its plain version
                (E finished from each's sums within 3e-5 / 2e-2, the raw
                sums' largest relative error reported, bit-repeatable),
                its ms, device ms, plain ms and byte bound (no library
                call gives the packed sums); madc's device time at each
                tile edge over a sweep of n. The fp32
                routes are checked at Zamba2's fp32 forward (B=1, S=256)
                and prefill (B=4, S=2048) shapes, SSD in the model's
                layout (stride-0 B/C group) in both decay regimes and in
                the Pallas cells layout, and at unaligned shapes.
  3. reference — a tiny run on the CPU (plain versions) and on the card
                (kernels) with the same draws must agree: FedGroup with
                each measure, then IFCA, FeSEM, FedClust, LCFL and FedGroup
                with the shift detector at threshold 0.0 (membership equal
                every round; the shift run must probe and re-route on both
                devices), then all six trainers in round blocks
                (block_size 4, 6 rounds: the eager block on the CPU, the
                captured graphs on the card; membership equal, rtol
                1e-3), then FedGroup with the quarantine, streamed, with
                clients killed in round 1 and NaN payloads in round 2 (no
                deadline: it depends on timing): ``stats``, membership and
                quarantined counts equal, the same tolerances; it is also
                the warm-up of the card's libraries.
  4. main     — FedGroup on the paper's FEMNIST MLP-512 (d_w = 415,258):
                Alg. 3 cold start + 3 fused rounds with measure=edc, then
                with measure=madc; per-round metrics, cold-start and round
                time (host clock around work ending in synchronize()), peak
                device memory, and the kernels' launch counts (reset just
                before each run, read just after); then the EDC group cold
                start alone with 20 groups (n_pre = 200, m > 16: two
                column tiles): the kernel launched, labels in [0, 20), E
                within 3e-5 of the plain version on the same ΔW and V.
     4c         the dynamic-assignment strategies IFCA, FeSEM, FedClust
                and LCFL (``strategies.make_trainer``) and FedGroup with
                the shift detector (threshold 0.35, a probe every round),
                same data, model and knobs, ROUNDS rounds each: per-round
                metrics and round time (the shift run's first round holds
                its cold start), membership changes and migrations, probes,
                comm_params, peak memory, FeSEM / FedClust's (N, d_w)
                ``local_flat`` bytes and device; fails on a non-finite
                metric, a label outside [0, m), a ``local_flat`` off the
                card or a shift run that probes nobody.
     4d         round blocks (``fed/graphs.py``: one fused round captured
                as a CUDA graph, replayed per round): FedAvg, FedGroup
                (EDC) at α = 40 (all 200 clients founders) and at α = 20,
                IFCA, FeSEM, FedClust and LCFL, BLOCK_ROUNDS rounds once
                per round (eager) and once in blocks of BLOCK_SIZE, same
                seed: membership equal wherever the blocked run shows it,
                loss / discrepancy / accuracy within 1e-5 relative, graph
                replays equal to the blocked rounds (else the run fails);
                host-clock ms of every eager round, every block and the
                staging, the capture's ms, peak memory of both runs, one
                eager round and one more block under torch.profiler
                (busy share, device ops, host launch calls), and how many
                of FedGroup α = 20's rounds went through blocks.
     4e         streamed populations (``fed/population.py``). 4e-i:
                FedAvg, FedGroup (EDC) and FeSEM at phase 4's full width,
                ROUNDS rounds pinned and ROUNDS through ``Population(
                ArrayClientStore(data), PopulationConfig(prefetch=2))``,
                same seed: membership equal every round, loss /
                discrepancy / accuracy within 1e-5 relative (else the run
                fails); round ms of both, the producer's stage ms and the
                H2D bytes of each cohort, one round's eval ms on both
                paths, peak memory of both (and what earlier phases left
                live), one more streamed round under torch.profiler (busy
                share; from its chrome trace, how long the copy stream's
                H2D ran while a kernel ran), FeSEM's host ``local_flat``
                rows (fails unless on the CPU) and one cohort's table
                update timed inline (the state writer's saving). 4e-ii: the reference
                population bench's setup, ``virtual_synthetic(n_clients=
                100_000)`` with ``mclr(60, 10)``, FedGroup (EDC), K = 50,
                E = 4, 10,000 clients active at the start, Poisson(5)
                arrivals, eval every 5th round over 2,000 clients, 20
                rounds, five times: ``prefetch`` 2, then 2, 0, 0, 2 (in
                turns; the first run is reported apart); equal membership
                and metrics within 1e-5 across the five (else fails), round
                and stage ms, cold starts and arrivals a round (fails if
                none), clients generated, host RSS, peak device memory,
                labels in [0, m) and finite metrics (else fails).
     4f         the fault-tolerant runtime at phase 4's width. 4f-i:
                kill-and-resume of FedGroup (EDC) pinned and of FeSEM
                streamed (``PopulationConfig(prefetch=2, initial_active=
                150, arrival_rate=2.0)``): RESUME_ROUNDS rounds
                uninterrupted; the same trainer with ``checkpoint_every=2``
                into ``build/ckpt_<trainer>`` killed after 3 rounds; a
                fresh one loads the directory (t = 2) and runs 2 more:
                histories equal, max |Δ| of every parameter 0, membership
                and FeSEM's host rows equal (else fails); the archive's
                bytes, ``save_checkpoint`` / ``load_checkpoint`` ms and
                their share of the median round. 4f-ii: FedAvg with the
                quarantine, streamed, ``prefetch=2``, round 0 straggling
                2 s against a 0.3 s deadline (4 chunks), 5 clients killed
                in round 1, 3 NaN payloads in round 2: fails unless the
                counts are exactly those, the deadline fired, round 2
                quarantined, the parameters are finite and the degraded
                cohort's H2D transfer, read from the run's torch.profiler
                trace (the bytes of the copy stream's first three
                host-to-device copies), is its staged rows' bytes, not
                the slot's; round ms, each cohort's stage ms, rows and
                tensor bytes; the phase's seconds.
     4g         the async runtime (``FedConfig.async_depth``) at phase 4's
                width, ASYNC_ROUNDS rounds a run. 4g-i, the equivalence
                mode (D = 1, α = 1, β = 0): FedAvg, FedGroup (EDC, α =
                20), IFCA and FeSEM pinned against their ``block_size=4``
                runs, FedAvg, FedGroup and FeSEM through ``Population(
                ArrayClientStore(data), PopulationConfig(prefetch=2))``
                against their per-round runs: histories equal, max |Δ| of
                every parameter 0, membership and FeSEM's rows equal,
                ``staleness_hist == {"0": rounds}``, and pinned every
                dispatch a graph replay (replays = dispatches = folds, one
                capture, no eager round executor built), else fails.
                4g-ii: FedGroup at α = 40 (all founders: no newcomer's
                eq. 9 waits on the card) and FeSEM pinned at D = 1, 2, 3
                with α = 0.8, β = 0.5: round ms (the median gap between
                consecutive leases turning ready) against D = 1 and
                against phase 4d's blocked round, wall ms of the run,
                ``async_stats``, ``group_version``, one more fold window
                of 4 rounds under torch.profiler (busy share, host launch
                calls a round), peak memory; then FedGroup pinned and
                FedAvg streamed at D = 2 on a small configuration (40
                clients, mclr) on the card and on the CPU: labels and
                ``async_stats`` equal, rtol 1e-3, accuracy within 0.01.
                4g-iii: FedAvg pinned at D = 2 with one lease scripted
                never to report ready: lease_expiries = requeues = 1,
                dispatches = folds + 1, rounds in order. 4g-iv:
                kill-and-resume mid-async (D = 2, a checkpoint every 3
                rounds) of FedGroup pinned and FeSEM streamed: deviation 0.
     4h         telemetry and the elastic control plane at phase 4's width,
                FedGroup (EDC) at α = 40, FLEET_ROUNDS rounds a run on three
                paths: per round, blocks of BLOCK_SIZE (replayed graphs),
                async D = 2. 4h-i: each path without and with a telemetry
                dir (``build/telemetry_<path>``): histories equal, max |Δ|
                0, membership equal, blocks still replays, the dir passes
                ``repro_torch.launch.inspect.check_dir`` (else fails);
                median round ms off and on, spans a round by kind,
                ``metrics.jsonl`` bytes, ``finalize`` ms; then one
                ``Telemetry.profile()`` window of 2 rounds: the spans found
                in the capture and the device ms under each. 4h-ii:
                ``Coordinator(trainer, FleetConfig(n_workers=1))`` (a
                worker thread) against ``trainer.run()`` on the three
                paths and FeSEM streamed (``prefetch=2``): deviation 0,
                histories and membership equal, jobs = results, fleet
                blocks replays of one graph (else fails); median round ms
                of both and their ratio; then two workers with the holder
                of dispatch 3 killed and dispatch 4's, 5's and 6's results
                dropped, duplicated and held back: equal to the unfaulted
                run, each fault counted, ``fleet.*`` and recovery ms.
                4h-iii: PROC_ROUNDS rounds through two spawned workers
                (``ProcTransport``; each builds its replica with
                ``fleet_worker_replica``, a local solve run at build so
                that a job is not its process's first use of the card),
                unkilled and with round PROC_KILL_ROUND's holder
                SIGKILLed: the two equal exactly
                (else fails), their deviation from the in-process run
                (expected 0), spawn and build s, round ms, payload bytes
                each way a dispatch, the kill's recovery ms; the phase's
                seconds.
     4i         the client axis over torch.distributed ranks (a 1-D data
                mesh, ``launch/mesh.py``, ``fed/parallel.py``) at phase
                4's width: FedAvg's and IFCA's first round (m = 5), and
                FedGroup (EDC) for MESH_ROUNDS rounds, α = 20 per round, α
                = 40 (every client a founder) in blocks of MESH_BLOCK, α =
                20 streamed. 4i-i: an NCCL world of one in this process,
                every pinned path against mesh=None: equal bit for bit
                (histories, labels, membership, max |Δ| 0), block replays
                = the blocked rounds with the NCCL all_reduce inside the
                graphs; cold-start and round ms of both. 4i-ii: two
                spawned ranks sharing the card over gloo (the library
                built by this process first; each rank warms up on a
                small run), every path (streamed through
                ``ShardedClientStore(…, 2)``) against one device
                (streamed: ``ShardedClientStore(…, 1)``): the first
                rounds within the CPU mesh tests' tolerances (accuracy
                MESH_ACC_ATOL, loss and discrepancy MESH_RTOL, each leaf
                MESH_LEAF_RTOL in relative Frobenius norm); FedGroup's
                runs with labels, founders and membership equal and
                accuracy and discrepancy within the reference's own
                bound, MESH_ACC_ATOL absolute (the card rounds a
                client's update by the rank's batch, and three rounds
                amplify it: loss and leaves reported); the two ranks'
                replicas equal bit for bit; each rank's edc_cosine
                launches; a rank's streamed cohort's x and y bytes half
                of one device's; replays 0 (gloo runs the block
                eagerly); cold-start and round ms at S = 1 and 2. 4i-iii:
                one rank a card over NCCL where the machine has two
                cards, else a line saying it has one. 4i-iv: the runtime
                services on the mesh (``"phase": "services"`` lines),
                FedGroup (EDC) at phase 4's width for SVC_ROUNDS rounds.
                On an NCCL world of one in this process: an archive every
                2 rounds, a run killed after round SVC_KILL and resumed
                from its archive equal bit for bit to the uninterrupted
                one (save / load ms, archive bytes); telemetry on equal to
                off (``check_dir`` clean); async D = 1 equal to the
                blocked run, every dispatch a replay with the all-reduces
                captured (replays = dispatches, the block's = its
                rounds), D = 2's round ms; a fleet of one equal to
                ``run()`` per round and in blocks (replays). On two
                spawned ranks sharing the card over gloo: both killed
                (SIGKILL) after round SVC_KILL's archive and respawned,
                equal bit for bit to the uninterrupted two-rank run; a
                streamed run with SVC_FAULTS (a kill, two poisoned lanes
                quarantined, a straggle past a 0.3 s deadline): the same
                degraded prefix, membership and ``Population.stats`` on
                both ranks, exactly the scripted counts. Every line
                carries nvidia-smi's name and power limit.
     4j         the 2-D (data, model) layout (``launch/mesh.py``'s model
                axis; checked after phase 6e, whose Alg. 3 it is held
                to): two spawned ranks sharing the card over gloo as a (1, 2)
                mesh. FedGroup (EDC) at phase 4's width, MESH_ROUNDS
                rounds per round and at α = 40 in blocks of MESH_BLOCK,
                each rank solving half of each cohort with the group
                parameters gathered over the model group and keeping its
                blocks of them (``group_param_pspec``; the blocks joined
                must have the spec's shapes), its Alg. 3 on its half of
                ΔW's d_w through ``edc_cosine_partial``: labels, founders
                and membership equal to phase 4i's runs of one device,
                accuracy and discrepancy within 2e-3 (the card's mesh
                tolerance; loss and leaves reported), the two ranks'
                replicas equal; each rank's cold-start and round ms, peak
                memory, partial-entry launches. Then Alg. 3 on phase 6e's
                ΔW (64, 103,814,656) with its columns split over the two
                ranks (each builds its 13.3 GB block from the same
                generators), each QR
                (Householder as TSQR over the model group, CholeskyQR2
                with its Grams all-reduced): labels equal to phase 6e's,
                E within 3e-5 after matching column signs, V's subspace
                (the ranks' rows stacked) within 1e-3, ms beside phase
                6e's, one partial-entry launch a rank and QR.
     4k         the runtime services under a model axis and process
                workers under a mesh (its ranks run after 4j's): two
                spawned ranks sharing the card over gloo, FedGroup (EDC)
                at phase 4's
                width and α = 20 for SVC_ROUNDS rounds on a (1, 2) mesh
                (``"phase": "services2d"`` lines), each rank's cold starts
                through ``edc_cosine_partial``. Kill-and-resume (both
                ranks SIGKILLed after round SVC_KILL's archive and
                respawned) equal bit for bit to the uninterrupted run,
                save / load ms, archive bytes, the archive's leaves whole
                and resumed on one device in this process (membership
                equal, accuracy and discrepancy within 2e-3 of the ranks'
                run); telemetry on equal to off (rank 0 writes,
                ``check_dir`` clean); async D = 1 equal to the synchronous
                run, D = 2's round ms, and phase 4g-ii's small D = 2 run
                on the ranks against the CPU at 4g's tolerances; a thread
                fleet of one equal to ``run()`` and one of two with a
                holder declared dead while its job is held and one killed
                (the CPU's ``fedgroup_fleet2``); a streamed run with
                SVC_FAULTS and a deadline, and one whose deadline cuts a
                round with two poisoned lanes (the CPU's
                ``fedgroup_streamed_corrupt_deadline``), each with the
                same prefix and ``stats`` on both ranks. Then the two
                ranks as a 1-D mesh: a process fleet of two workers a rank
                (each its own CUDA context, warmed up by one local solve
                as it is built, computing its rank's rows' local
                solves), the last rank's holder of dispatch
                SVC2D_PROC_KILL SIGKILLed, equal bit for bit to the ranks'
                run without a fleet, with the same job counters on both
                ranks; round and recovery ms.
     4l         the zoo's tensor parallelism for serving (its ranks run
                after 4k's): two spawned ranks sharing the card over gloo
                as a (1, 2) mesh, each holding only its blocks of the
                params (``zoo.shard_params``) and of the decode cache
                (``zoo.init_cache(mesh=)``), rank 0 first running each
                model whole on its own while the other waits
                (``"phase": "zoo_tp"`` lines). Zamba2-1.2B whole: fp32
                B=1, S=256 ``forward`` and 32 ``serve_step`` calls within
                2e-3 of one device's (max |Δ| over max |logit|), the bf16
                B=4, S=2048 prefill's ms (CUDA events, median of 3 after a
                warm-up) and peak against one device's, each rank's
                counted bf16 forward launching 6 swa_attention and 38
                ssd_intra_chunk on the tensor-core routes on its 16 and 32
                local heads (else the run fails); Gemma-2B at its widths
                cut to 4 layers: 32 fp32 decode steps at B=1 through the
                slot-split cache (``kv_spec``: kv 1 < 2 ranks), the
                vocab-parallel embedding and tied head over 256,000 rows,
                within 2e-3; Granite-MoE-1B whole: fp32 B=1, S=256
                prefill with 16 experts a rank, within 2e-3. The gathered
                logits equal on both ranks (a digest). In phase 4i-iv's
                NCCL world of one (the forked process): Zamba2-1.2B's
                (1, 1) path (fp32 prefill and 32 decode steps) equal to
                ``mesh=None`` bit for bit.
     4m         the zoo's tensor parallelism for training (its ranks run
                after 4l's on the lane, once 6c and the serving CLIs are
                done; 6d waits for them): Zamba2-1.2B whole on two
                spawned ranks sharing the card over gloo as (1, 2), each
                holding only its ``state_specs`` blocks of the train state
                (``zoo.init_train_state(mesh=)``), rank 0 first running
                one device on its own (``"phase": "zoo_train_tp"``
                lines): an fp32 B1 S256 ``loss_and_grads`` and two
                ``train_step``s, the loss, each leaf's gradient (gathered)
                and the second step's loss within 2e-3 of one device's
                (else the run fails), a bf16 B1 S2048 step's ms (median of
                2 after a warm-up), peak and launches on each rank against
                one device's, each counted step launching 6
                swa_attention_bwd (``tc``) and 38 ssd_intra_chunk_bwd on
                its 16 and 32 local heads (else the run fails); on four
                ranks as (2, 2), fp32 B4 S256: Gemma-2B at its widths cut
                to 2 layers (the vocab-parallel cross-entropy over 256,000
                rows) plain, with ZeRO-1 and with ZeRO-3, each within
                2e-3 of one device and the two layouts' params equal to
                the plain one's bit for bit; Granite-MoE-1B cut to 4
                layers with its 32 experts over data × model (8 a rank),
                within 2e-3. The losses equal on every rank (a digest).
                In phase 4i-iv's NCCL world of one: a train step of
                Zamba2-1.2B cut to 4 layers through the (1, 1) path equal
                to ``mesh=None`` bit for bit.
  5. breakdown — where the time goes: the batched local solver (the
                cold start's 100 clients, a round's 20) vs the EDC / MADC
                measure on the same inputs; one more round under
                torch.profiler for the device's busy share.
  6. zamba2   — Zamba2-1.2B at full width (1,170,473,856 params, random
                from seed 0): prefill ``forward`` at B=4, S=2048 in bf16,
                with and without a 512 window — ms (CUDA events, warmed),
                finite logits, peak memory, kernel launches per forward
                (38 ssd_intra_chunk and 6 swa_attention, both on their
                tensor-core routes; the two counted forwards fail the run
                unless they launch 76 and 12 such); one forward and one
                decode step under torch.profiler (the kernels' share of
                device time by route, launches per decode step); fp32
                B=1, S=256 ``forward`` (both kernels on their fp32 routes)
                against 256 ``serve_step`` calls (no kernel),
                within 2e-3, with and without a 64 window and a 64-slot
                ring cache; then ``python -m repro_torch.launch.serve
                --arch zamba2-1.2b --batch 4 --prompt-len 32 --gen 32`` in
                a child process.
  6b. families — the zoo's attention families at their published widths,
                random from seed 0, each model's weights freed before the
                next, with its peak memory and seconds: Gemma-2B whole
                (2,506,172,416 params; MQA, hd 256, GeGLU, tied and scaled
                embeddings): bf16 prefill B=4, S=2048 (18 swa_attention
                launches on the fp32 route, else the run fails), the
                long_500k variant from ``shapes.config_for`` (an 8,192
                window) at B=1, S=16,384 (18 more), a profiled prefill and
                decode step, fp32 B=1, S=256 ``forward`` against 256
                ``serve_step`` calls within 2e-3 with and without a 64
                window and 64-slot ring, then the serve CLI with its
                default arch in a child process; Granite-MoE-1B-A400M whole
                (1,385,481,216): bf16 prefill B=4, S=2048 under both
                ``moe_impl`` values (24 tc launches each), the first
                layer's expert load (sums to 1), a profiled scatter
                prefill, fp32 forward against
                serve with ``capacity_factor=100``, the serve CLI;
                InternVL2-1B whole (631,658,368; 256 patch embeddings
                before 768 text tokens, B=4, tc) with forward against
                serve on text at S=128; HuBERT-XLarge whole (945,153,280;
                bidirectional, hd 80: fp32 route, B=4, S=1024) and the
                serve CLI's encoder-only line with exit code 1;
                GLM-4-9B, Granite-20B and Nemotron-4-15B at published
                widths cut to 2 layers (listed in ``reduced``): bf16
                prefill B=2, S=2048 (tc) and forward against serve at
                S=128. Phase 2 holds swa_attention at each family's
                prefill shape (GQA / MQA k, v with KV heads; SDPA with
                ``enable_gqa=True`` as the library call), DeepSeek's MTP
                block too (H = KV = 128, hd 56: the fp32 route).
  6c. last families — random from seed 0, each model's weights freed
                before the next, with its peak memory and seconds:
                DeepSeek-V3 at published widths (MLA: q_rank 1,536,
                kv_rank 512, 128 heads of 128 + 64 rope dims, v 128; the
                MoE layer's top 8 of routed experts of d_ff 2,048 and one
                shared) cut to 3 layers and 16 routed experts with the MTP
                head on (5,013,474,304 params; the cuts in ``reduced``):
                bf16 prefill B=2, S=2048 (MLA is plain einsums: no
                launch), ``forward(return_hidden=True)`` then
                ``mtp_logits`` (fails unless the MTP call launches one
                swa_attention, on the fp32 route at hd 56), fp32 B=1,
                S=2048 with ``attn_q_chunk=512`` against no chunking (the
                first layer's ``mla_fwd`` within 1e-5 with its ms and peak
                memory, the logits equal exactly), a profiled prefill and
                decode step, fp32 B=1, S=256 ``forward`` against 256
                ``serve_step`` calls (the absorbed decode over the
                compressed cache) within 2e-3 with and without a 64
                window and 64-slot ring at ``capacity_factor=100``, the
                serve CLI with ``--arch deepseek-v3-671b --smoke``;
                xLSTM-350M whole (519,001,248; 20 mLSTM and 4 sLSTM
                layers): bf16 prefill B=4, S=2048 with the chunkwise
                mLSTM; fp32 B=1, S=512: each mLSTM layer's chunkwise form
                against its recurrent form on the same input within 1e-4,
                each whole forward's ms and launches; fp32 B=1, S=256:
                each layer's 256 block steps against its forward on the
                same input within 2e-3 (the whole forward against 256
                ``serve_step`` calls, and the two forms' logits, are
                recorded, not held: with random weights the sLSTM
                post-FFNs grow the residual stream ~3,000× and fp32
                rounding with it, in the JAX package too); a profiled
                decode step; the serve CLI with
                ``--arch xlstm-350m``. The xLSTM forwards' launches are
                their ATen ops (a dispatch-mode count).
  6d. training — the backward kernels (swa_attention_bwd's two routes,
                ``tc``: ``csrc/swa_attention_bwd_tc.cu``, bf16 tensor
                cores, and ``fp32``: ``csrc/swa_attention_bwd.cu``; and
                ``csrc/ssd_chunk_bwd.cu``, 3xTF32) against their plain
                versions and ``torch.autograd.grad`` through the plain
                forward, on the same CUDA tensors, each called twice and
                equal bit for bit, each case naming its route:
                swa_attention_bwd at Zamba2's shape (B4 S2048 H32 hd64
                bf16), Gemma's (H8 KV1 hd256), HuBERT's (hd80,
                bidirectional), a 64 window with Sq < Sk (all ``tc``), and
                fp32 (``fp32``) (within 2e-2 bf16 / 1e-4 fp32 of each
                gradient's largest magnitude; the ``tc`` cases also
                against the plain version that rounds as they round), ms,
                plain ms, bound (10·hd FLOPs a kept pair, 2.5 × the
                forward's) and the library's (``autograd.grad`` through
                SDPA); ssd_intra_chunk_bwd at Zamba2's (b4, 16 chunks, 64
                heads, Q128, P = N = 64, B and C one group; bf16 and fp32;
                elementwise 2e-4 of the plain version and of autograd
                through the plain forward, both in float64, with the
                fp32 plain version's distances recorded; dB, dC one a
                group), no library call.
                Then one ``train_step`` of every registry arch's smoke
                variant (remat on) on the card against the CPU's (loss
                1e-4, gradients 1e-4 of each leaf's largest, params 1e-3
                Frobenius over the tree), a MoE arch's forward and
                step twice, equal bit for bit; Zamba2-1.2B at published
                widths (fp32 params and moments, bf16 activations, remat,
                B4 S2048): three steps, each 6 swa_attention_bwd and 38
                ssd_intra_chunk_bwd launches (else the run fails), step
                ms, loss, peak memory, a fourth step under torch.profiler
                (busy share, the backward kernels' device ms, GEMMs,
                casts), a fifth under a dispatch mode that fails the run
                on any sum of a per-head (…, h, n) tensor over its heads
                (a dense per-head dB or dC); the same cut to 6 layers with
                remat
                on and off: loss and gradients equal bit for bit, both
                peaks; Gemma-2B whole (B1 S2048): three steps, 18
                swa_attention_bwd launches each, step ms and peak, and a
                profiled fourth.
  6e. dry runs — the dry runs without a mesh (``launch/fed_dryrun.py``,
                ``launch/dryrun.py``) on the card. 6e-i: one
                ``make_parallel_round`` at the reference's production
                size, K = 1,024 clients, max_n = 256, ``mlp(784, 512,
                62)``, m = 5, E = 20, B = 10, lr 0.03 (after a first call
                at E = 1): round ms, peak memory, finite outputs; the same
                round at K = 16 on the CPU and on the card from the same
                draws, each leaf of each output within 1e-3 in the
                Frobenius norm, and at E = 1 (26 local steps) also within
                1e-3 elementwise (|card − CPU| over the leaf's largest
                magnitude). 6e-ii: Alg. 3 on ΔW (64, 103,814,656) fp32
                (the reference's d_w of 415,258,624 cut by 4), built on the
                card as a decaying spectrum plus noise: ``run_coldstart``'s
                step with each QR, Householder and CholeskyQR2 (E from
                edc_cosine: the phase's counted launches; labels in [0,
                5)), each step's and each randomized SVD's ms, the two V's
                one subspace (the singular values of |V₁ᵀV₂| within 1e-3 of
                1), E from the kernel within 3e-5 of the plain version on
                the same ΔW and V, its ms, device ms, plain ms, bound (ΔW's
                and V's bytes at 3.35 TB/s), F.cosine_similarity's ms over
                chunks of rows and columns that fit, the peak. 6e-iii: the
                zoo's dry-run records on meta at a batch cut held to the
                same step on the card: Zamba2-1.2B ``train_4k`` (B 2),
                Gemma-2B ``prefill_32k`` (B 1), Zamba2-1.2B ``decode_32k``
                (B 8): the record's argument bytes equal to the real
                tensors' (else fails), the step's ms (the median of three
                after a first call, which is timed apart), peak and the
                temporaries meta cannot give (peak minus what was live).
  7. the ``{"kernels": [...]}`` line (the two routes of swa_attention, of
     ssd_intra_chunk and of swa_attention_bwd as rows of their own,
     ``<name>.tc`` and ``<name>.fp32``, and ``ssd_intra_chunk_bwd``; the
     backward kernels' ``replaces`` names the jnp
     function whose ``jax.vjp`` each matches; edc_cosine's launches count
     phase 4's EDC, MADC, 20-group and shift runs, phase 4d's, 4e's,
     4f's, 4g's, 4h's and 4i's FedGroup runs (4i's ranks' too) and phase
     6e's two cold starts; edc_cosine_partial's phase 4j's ranks' cold
     starts;
     swa_attention's count Zamba2's and phase 6b's counted forwards,
     phase 6c's counted MTP call, phase 4l's ranks' counted bf16
     forwards and phase 4m's ranks' counted bf16 steps (ssd_intra_chunk's
     too), not phase 2's comparisons; the backward kernels' count phase
     6d's counted train steps and phase 4m's ranks'), then the
     ``{"ok": true, ...}`` line.

Order. Phase 1, then phase 2 with every kernel check (the zoo's forward
and the backward kernels' too), 3, 4 and 5 run one after another in
this process, alone on the card: every kernel time and phase 4's and
5's times are the card's alone. Then three lanes run beside this
process's zoo phases 6, 6b, 6c and 6d: phases 4c to 4h with 4i-i /
4i-iv's NCCL worlds of one in a forked process (``fed_phases``; its
lines are printed here when it ends); the mesh phases' spawned ranks,
one rank set after another (4j's, 4k's, 4l's, 4m's, 4i-ii's, 4i-iv's;
4m's, ~25 GB, start when 6c and the serving CLIs are done, and 6d's
~42 GB wait for them); and the
serving CLIs but the default one (~17 GB), one after another. 4j's Alg.
3 holds ~24 GB a rank: the families and the serving CLIs start after
it; 6d waits for the serving CLIs, 6e (~57 GB) for every lane, and the
mesh phases' checks run after 6e. The ranks and the forked process
start as forks of one fork server that imported torch and the port
once. So the lines of 4c to 4l, 6 to 6d and the serving CLIs were
measured beside each other (``lanes`` gives each job's seconds and how
long 6e waited for them). Each line goes to stderr too, after the
seconds since the start (the forked process's own clock in its stderr,
copied here).

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import re
import resource
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 dense tensor cores
TF32_TERMS = 3                 # the fp32 routes: 3 TF32 products a product
TOL = 3e-5                     # kernel vs plain: fp32 sums in another order
TOL_BF16 = 2e-2                # a bf16 input's kernel vs plain
# edc_cosine's partial-sum entry vs plain, on its packed output: both sum
# fp32 products of the same inputs (bf16 ones widened exactly) in other
# orders, ~1e-7 relative over 5.2e7 terms; the dots are held relative to
# ‖ΔW_i‖·‖V_j‖ (a typical |E| is 1/√d ≈ 1.4e-4, so a wrong dot shows), the
# row and column squares relative to themselves, for fp32 and bf16 alike
PARTIAL_RTOL = 1e-5
SWA_TC_TOL = 1e-2              # P rounded to bf16: 2^-9 per p, over |v| <~ 4
SSD_TOL = 2e-4                 # SSD outputs are sums of ~Q products of ~N
EDC_LIBRARY_BYTES = 8e9        # F.cosine_similarity's broadcast, at most
EDC_GROUPS = 20                # the cold start with m > 16 column tiles
STRATEGIES = ("ifca", "fesem", "fedclust", "lcfl")
ROUNDS = 3
BLOCK_ROUNDS, BLOCK_SIZE = 8, 4  # phase 4d: 8 rounds, blocks of 4
BLOCK_RTOL = 1e-5              # graph vs eager round: cuBLAS may pick other
                               # algorithms under capture
# phase 4d's trainers and α: FedGroup at α = 40 has all 200 clients as
# founders (no newcomer breaks a block), at phase 4's α = 20 half of them
BLOCK_RUNS = (("fedavg", 20), ("fedgroup", 40), ("fedgroup", 20),
              ("ifca", 20), ("fesem", 20), ("fedclust", 20), ("lcfl", 20))
STREAM_RTOL = 1e-5             # phase 4e: streamed vs pinned on the card
STREAM_RUNS = ("fedavg", "fedgroup", "fesem")
POP_ROUNDS, POP_CLIENTS = 20, 100_000   # phase 4e-ii: the reference bench's
# phase 4e-ii: the prefetch depth of each run; the first is held apart
# (the process's first prefetching run at this scale reads slower)
POP_ORDER = (2, 2, 0, 0, 2)
RESUME_ROUNDS = 4              # phase 4f: 4 rounds, checkpoints every 2
RESUME_POP = dict(prefetch=2, initial_active=150, arrival_rate=2.0)
ASYNC_ROUNDS = 8               # phase 4g: rounds a run
ASYNC_EQ_PINNED = ("fedavg", "fedgroup", "ifca", "fesem")
ASYNC_EQ_STREAMED = ("fedavg", "fedgroup", "fesem")
ASYNC_DEPTHS = (1, 2, 3)
ASYNC_WEIGHTS = dict(async_alpha=0.8, async_beta=0.5)
# phase 4g-ii's trainers and α: FedGroup at α = 40 has every client as a
# founder, so no newcomer's eq. 9 (a host read of the card) drains the
# in-flight window
ASYNC_DEPTH_RUNS = (("fedgroup", 40), ("fesem", 20))
# phase 4h: FedGroup at α = 40 (every client a founder) on three paths,
# FLEET_ROUNDS rounds; a 5 s heartbeat window for the equivalence runs, a
# 0.5 s one for the chaos run (the in-process kill is found by it)
FLEET_ROUNDS, FLEET_ALPHA = 8, 40
FLEET_PATHS = {"round": {}, "block": {"block_size": BLOCK_SIZE},
               "async2": dict(async_depth=2, **ASYNC_WEIGHTS)}
FLEET_CALM = dict(heartbeat_interval=0.05, heartbeat_miss=100)
FLEET_CHAOS = dict(heartbeat_interval=0.05, heartbeat_miss=10,
                   backoff=0.005, backoff_cap=0.02)
PROC_ROUNDS, PROC_KILL_ROUND = 4, 2   # phase 4h-iii: spawned workers
PROC_BUILDER = "chip_smoke:fleet_worker_replica"   # their replica builder
PROC_BEAT = (0.1, 50)          # heartbeat interval s and misses: 5 s window
# phase 4i: FedGroup (EDC) at phase 4's width on a data mesh, MESH_ROUNDS
# rounds a run, the blocked run in blocks of MESH_BLOCK; ranks against one
# device at the CPU mesh tests' tolerances (accuracy absolute, loss and
# discrepancy relative, each group-parameter leaf in the Frobenius norm)
MESH_ROUNDS, MESH_BLOCK = 3, 2
MESH_ACC_ATOL, MESH_RTOL, MESH_LEAF_RTOL = 2e-3, 1e-4, 1e-5
# the card's batched products round a client's update by the batch's
# size (a rank's K / S against K: ~1e-6 relative) and three rounds of
# training amplify that far past MESH_RTOL, as a 1e-7 nudge of the data
# does (phase 6e): a first round (FedAvg, IFCA: the same inputs on every
# rank) is held at the CPU tests' tolerances, FedGroup's runs at the
# reference's own bound of a sharded run (accuracy and discrepancy within
# MESH_ACC_ATOL absolute), their loss and leaves reported
MESH_FIRST = ("fedavg", "ifca")
MESH_PATHS = MESH_FIRST + ("round", "block", "stream")
MESH_TIMEOUT_S = 400           # a spawned rank's whole run
# phase 4i-iv: the runtime services on the data mesh, FedGroup (EDC) at
# phase 4's width for SVC_ROUNDS rounds, killed after SVC_KILL; the
# streamed run's faults: round 1 kills a client and poisons two lanes
# (quarantined), round 2 straggles 0.6 s a chunk of 4 clients against a
# 0.3 s deadline (phase 4f's), which fires before the second chunk
SVC_ROUNDS, SVC_KILL = 4, 2
SVC_FAULTS = {1: dict(kill=1, corrupt=2), 2: dict(straggle=3.0)}
SVC_POP = dict(prefetch=0, deadline=0.3, stage_chunks=5)
SVC_ASYNC2 = dict(async_depth=2, async_alpha=0.8, async_beta=0.5)
SVC_TIMEOUT_S = 300            # a spawned rank's whole run
# phase 4j: the 2-D (data, model) layout on two ranks sharing the card
# over gloo as a (1, 2) mesh: FedGroup (EDC) at phase 4's width per round
# and in blocks (MESH_ROUNDS, MESH_BLOCK), and Alg. 3 on ΔW (FED_NPRE,
# FED_DW) with its d_w columns split over the two ranks, against phase 4i's
# and phase 6e's runs of one device
MESH2D_MODEL = 2
MESH2D_PATHS = ("round", "block")
MESH2D_TIMEOUT_S = 400         # a spawned rank's whole run
# phase 4k: the runtime services on a (1, MESH2D_MODEL) mesh and process
# workers on the 1-D mesh of the same two ranks sharing the card over
# gloo; FedGroup (EDC) at phase 4's width, α = 20, SVC_ROUNDS rounds. The
# CPU's fedgroup_fleet2 (a holder muted past a 0.5 s heartbeat window
# while its job is held, then one killed) and
# fedgroup_streamed_corrupt_deadline (round 2: two lanes poisoned, a 3 s
# straggle over 2 chunks of 10 against the deadline: a prefix of 10)
SVC2D_FLEET2 = {1: dict(heartbeat_delay=1.5), 2: dict(worker_kill=True)}
SVC2D_CORRUPT = {2: dict(corrupt=2, corrupt_mode="scale", straggle=3.0)}
SVC2D_CORRUPT_POP = dict(prefetch=0, deadline=0.3, stage_chunks=2)
SVC2D_PROC_KILL = 1            # the dispatch whose holder is SIGKILLed
SVC2D_PROC_BUILDER = "chip_smoke:svc2d_worker_trainer"
SVC2D_TIMEOUT_S = 400          # a spawned rank's whole run
# phase 4l: the zoo over a model axis, two ranks sharing the card over
# gloo as (1, ZOO_TP_MODEL): Zamba2-1.2B, Gemma-2B (the slot-split decode)
# and Granite-MoE-1B at published widths, fp32 runs of ZOO_TP_S positions
# or ZOO_TP_STEPS decode steps held to one device within ZOO_TP_TOL (the
# card's forward-vs-decode rule)
ZOO_TP_MODEL = 2
ZOO_TP_S, ZOO_TP_STEPS, ZOO_TP_TOL = 256, 32, 2e-3
ZOO_TP_GEMMA_LAYERS = 4        # Gemma-2B's depth cut (of 18): the phase
                               # runs beside the zoo phases' ~40 GB
ZOO_TP_TIMEOUT_S = 300         # a spawned rank's whole run
# phase 4m: the zoo's training over a model axis: Zamba2-1.2B whole on two
# ranks as (1, ZOO_TP_MODEL), fp32 B1 steps of ZOO_TRAIN_S positions held
# to one device within ZOO_TRAIN_TOL, a bf16 B1 step of ZOO_TRAIN_BF16_S
# timed (the median of ZOO_TRAIN_TIMED after a warm-up); Gemma-2B and
# Granite-MoE-1B at published widths cut in depth on four ranks as
# (2, ZOO_TP_MODEL), fp32 B ZOO_TRAIN_B steps
ZOO_TRAIN_S, ZOO_TRAIN_BF16_S, ZOO_TRAIN_TOL = 256, 2048, 2e-3
ZOO_TRAIN_B, ZOO_TRAIN_TIMED = 4, 2
ZOO_TRAIN_GEMMA_LAYERS = 2     # Gemma-2B's depth cut (of 18)
ZOO_TRAIN_GRANITE_LAYERS = 4   # Granite-MoE-1B's (of 24)
ZOO_TRAIN_NCCL1_LAYERS = 4     # the NCCL world of one's Zamba2 (of 38)
ZOO_TRAIN_TIMEOUT_S = 400      # a spawned rank set's whole run
ZOO_TRAIN_GO = threading.Event()   # set when 4m may run: 6d waits for it
FED_CHILD_TIMEOUT_S = 900      # fed_phases' whole run, once 6d is over
# phase 2: edc_cosine's partial-sum entry at a rank's d_w block of phase
# 6e's ΔW (FED_DW over MESH2D_MODEL)
PARTIAL_N, PARTIAL_D, PARTIAL_M = 64, 51_907_328, 5
ZAMBA_B, ZAMBA_S = 4, 2048     # prefill batch and length
CONSIST_S, CONSIST_TOL = 256, 2e-3
# phase 2's swa_attention cases at the zoo families' shapes: label ->
# (B, S, H, KV, hd, window, causal, route of bf16 q/k/v)
FAMILY_SWA = {
    "gemma-prefill": (4, 2048, 8, 1, 256, None, True, "fp32"),
    "gemma-long500k": (1, 16384, 8, 1, 256, 8192, True, "fp32"),
    "glm4": (4, 2048, 32, 2, 128, None, True, "tc"),
    "granite20b": (2, 2048, 48, 1, 128, None, True, "tc"),
    "internvl2": (4, 1024, 14, 2, 64, None, True, "tc"),
    "hubert": (4, 1024, 16, 16, 80, None, False, "fp32"),
    # DeepSeek-V3's MTP block: MHA at hd 7,168 / 128 = 56, padded to 64
    "deepseek-mtp": (2, 2048, 128, 128, 56, None, True, "fp32"),
}
SSD_DECAY = {"fast": 1.0, "slow": 0.01}   # dtA = -s · softplus(randn)
# phase 6b: the zoo's attention families
FAMILY_B, FAMILY_S = 4, 2048   # bf16 prefill batch and length
LONG_S = 16384                 # Gemma long_500k: twice the 8,192 window
CUT_ARCHS, CUT_LAYERS = ("glm4-9b", "granite-20b", "nemotron-4-15b"), 2
FAMILY_PARAMS = {"gemma-2b": 2_506_172_416, "glm4-9b": 9_399_951_360,
                 "granite-20b": 28_167_493_632,
                 "nemotron-4-15b": 15_628_376_064,
                 "internvl2-1b": 631_658_368, "hubert-xlarge": 945_153_280,
                 "granite-moe-1b-a400m": 1_385_481_216,
                 "deepseek-v3-671b": 703_797_812_224,
                 "xlstm-350m": 519_001_248}
# phase 6c: the zoo's last two families. DeepSeek-V3 at its published
# widths, cut to fit one card in fp32 (2.8 TB whole), with the MTP head on
DEEPSEEK_CUT = dict(n_layers=3, n_experts=16, mtp=True)
DEEPSEEK_CUT_PARAMS = 5_013_474_304
DEEPSEEK_B = 2                 # bf16 prefill batch (S = FAMILY_S)
# MLA's query chunks at fp32, B=1: a layer within 1e-5, the logits equal
# exactly (chunking changes no sum; the MoE combine adds in a fixed order)
Q_CHUNK, Q_CHUNK_S, Q_CHUNK_TOL, Q_CHUNK_LOGIT_TOL = 512, 2048, 1e-5, 0.0
# phase 6d: LM training. The backward kernels against their plain
# versions within TRAIN_TOL of each gradient's largest magnitude (SSD
# elementwise within SSD_TOL), at the training shapes: label -> (B, Sq,
# Sk, H, KV, hd, window, causal, dtype)
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# swa_attention_bwd's tc route against the plain version that rounds dO, P
# and dS to bf16 where it does: its fp32 scores differ from the plain
# version's in the last bits, which can flip a P or dS element by one bf16
# step
SWA_TC_RND_TOL = 5e-3
TRAIN_SWA = {"zamba2-train": (4, 2048, 2048, 32, 32, 64, None, True,
                              "bfloat16"),
             "gemma-train": (1, 2048, 2048, 8, 1, 256, None, True,
                             "bfloat16"),
             "hubert-train": (4, 1024, 1024, 16, 16, 80, None, False,
                              "bfloat16"),
             "window64-sq<sk": (2, 512, 1024, 8, 2, 64, 64, True,
                                "bfloat16"),
             "fp32": (1, 256, 256, 32, 32, 64, None, True, "float32")}
TRAIN_SSD_SHAPE = (4, 16, 128, 64, 64, 64)    # b, chunks, Q, h, P, N
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 64           # every arch's smoke variant
TRAIN_S, TRAIN_STEPS = 2048, 3                 # published widths
ZAMBA_TRAIN_B, GEMMA_TRAIN_B, ZAMBA_CUT_LAYERS = 4, 1, 6
XLSTM_B = 4                    # chunkwise bf16 prefill batch (S = FAMILY_S)
XLSTM_REC_S, XLSTM_IMPL_TOL = 512, 1e-4   # recurrent vs chunkwise, fp32 B=1
# phase 6e: the dry runs without a mesh. The federated round at the
# reference's production size (launch/fed_dryrun.py's run_round), card vs
# CPU at FED_CHECK_K clients: each leaf of each output (group models,
# global model, group deltas) within FED_RTOL in the Frobenius norm. At
# E = 20 (520 SGD steps) the two devices drift apart elementwise as a 1e-7
# nudge of X moves one device's run (ReLU units flip), so the elementwise
# check, FED_RTOL of each leaf's largest magnitude, runs at
# FED_ELEM_EPOCHS, before the flips build up. Alg. 3 on
# ΔW (64, FED_DW): the reference's d_w of 415,258,624 cut by 4 (106.3 GB
# fp32 whole; 26.6 GB at the cut); the two QRs' subspaces within
# SUBSPACE_TOL. The zoo pairs held to the card at a batch cut: (arch,
# shape, batch)
FED_ROUND = dict(n_clients=1024, max_n=256, dim=784, n_groups=5, epochs=20,
                 batch=10)
FED_CHECK_K, FED_RTOL, FED_ELEM_EPOCHS = 16, 1e-3, 1
FED_DW, FED_NPRE, FED_M, SUBSPACE_TOL = 103_814_656, 64, 5, 1e-3
HELD_PAIRS = (("zamba2-1.2b", "train_4k", 2), ("gemma-2b", "prefill_32k", 1),
              ("zamba2-1.2b", "decode_32k", 8))
HELD_STEPS = 3                 # timed steps of a held pair after its first


T_START = time.perf_counter()
EMIT_LOCK = threading.Lock()    # the lanes' threads emit too


def emit(obj):
    """Print ``obj`` as a JSON line; stderr gets the seconds since the
    script started beside the line's phase, the run's clock."""
    line = json.dumps(obj) + "\n"
    mark = (f"[{time.perf_counter() - T_START:8.1f} s] "
            f"{obj.get('phase', next(iter(obj), ''))}\n")
    with EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()
        sys.stderr.write(mark)
        sys.stderr.flush()


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def allclose_err(torch, got, want, atol, rtol):
    """(max abs error, whether |got - want| <= atol + rtol·|want| holds
    everywhere, and every value of got is finite)."""
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(torch, fn, match, iters: int = 20):
    """Device time of one call from torch.profiler: the kernels whose name
    holds ``match`` (a string or a tuple of them), summed over ``iters``
    warmed calls, over iters. None where the profiler saw no such kernel
    (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = (match,) if isinstance(match, str) else match
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and any(m in e.key for m in names)]
    if not ev:
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3 / iters


def host_us(torch, fn, calls: int = 1000) -> float:
    """The host's time per call over ``calls`` calls with no synchronise
    between them (where the card is slower, the queue fills and this reads
    the card's pace)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def call_times(torch, fn, match) -> dict:
    return {"device_ms": profiled_ms(torch, fn, match),
            "host_us_per_call": host_us(torch, fn)}


def host_us_bursts(torch, fn, bursts: int = 5, calls: int = 100) -> float:
    """The host's time per call, the median of ``bursts`` bursts of
    ``calls`` calls each, synchronised between bursts: short enough that
    the launch queue never fills, so it reads the host even where the
    card is slower."""
    times = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def ptxas_report(log: str, source: str, kernel: str,
                 note: str = "registers at entry (launch bound 384 "
                             "threads); setmaxnreg gives the consumers 240 "
                             "and the producer 24") -> dict:
    """A kernel's registers, spills and shared memory from ptxas -v, and any
    warning or performance note (C7511: wgmma serialized) about its
    source."""
    inst, cur, warn = [], False, []
    section = log.split(f"== {source}")[-1].split("\n== ")[0]
    for line in section.splitlines():
        if "Compiling entry function" in line:
            cur = kernel in line
            if cur:
                inst.append({"function": line.split("'")[1]})
            continue
        if "warning" in line.lower() or "Performance Loss" in line:
            warn.append(line.strip())
        if not (cur and inst):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            inst[-1]["spill_stores"] = int(m[1])
            inst[-1]["spill_loads"] = int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            inst[-1]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        inst[-1].setdefault("static_smem", 0)
        if m:
            inst[-1]["static_smem"] = int(m[1])
    if not inst:
        raise AssertionError(f"no ptxas report of {kernel} in the build log")
    return {"phase": "ptxas", "kernel": kernel, "instances": inst,
            "warnings": warn, "note": note}


def check_kernels(torch):
    """Phase 2: every kernel against its plain version, on the card."""
    import torch.nn.functional as F

    from repro_torch.core.measures import cosine_similarity_matrix
    from repro_torch.kernels import edc_cosine as edc_mod
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import madc as madc_mod

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def edc_case(n, d, m, dtype, label):
        dW = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        V = torch.randn((d, m), generator=gen, device="cuda").to(dtype)
        got = edc_mod.edc_cosine(dW, V)
        want = ref.cosine_block_ref(dW, V)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        repeat = bool(torch.equal(got, edc_mod.edc_cosine(dW, V)))
        es = dW.element_size()
        b_ms, b_by = bound_ms(n * d * es + d * m * V.element_size()
                              + n * m * 4, 2.0 * n * d * (m + 1))
        # F.cosine_similarity broadcasts (n, d, m) fp32: timed over column
        # chunks of V whose broadcast fits in EDC_LIBRARY_BYTES, summed
        bcast = 4 * n * d * m
        step = max(1, min(m, int(EDC_LIBRARY_BYTES // (4 * n * d))))
        chunks = [(j, min(j + step, m)) for j in range(0, m, step)]
        fn = lambda: edc_mod.edc_cosine(dW, V)  # noqa: E731
        row = {"phase": "kernel", "name": "edc_cosine", "case": label,
               "n": n, "d": d, "m": m, "dtype": str(dtype).split(".")[-1],
               "plan": edc_mod.plan(n, d, m, build.sm_count(0))._asdict(),
               "max_abs_err": err, "tol": TOL, "bit_repeatable": repeat,
               "ms": cuda_ms(torch, fn, 20),
               "device_ms": profiled_ms(torch, fn, "edc_"),
               "host_us_per_call": host_us_bursts(torch, fn),
               "plain_ms": cuda_ms(torch,
                                   lambda: ref.cosine_block_ref(dW, V), 10),
               "library_ms": sum(cuda_ms(
                   torch, lambda j0=j0, j1=j1: F.cosine_similarity(
                       dW[:, :, None].float(), V[None, :, j0:j1].float(),
                       dim=1), 3, warmup=1) for j0, j1 in chunks),
               "library_column_chunks": chunks,
               "library_broadcast_bytes": bcast,
               # one pass that only reads ΔW (a yardstick of the card's
               # read rate for these bytes, not the same function)
               "read_dW_ms": cuda_ms(torch, lambda: dW.sum(), 20),
               "bound_ms": b_ms, "bound_by": b_by}
        if row["device_ms"]:
            row["share_of_bound_device"] = b_ms / row["device_ms"]
        row["share_of_bound_events"] = b_ms / row["ms"]
        emit(row)
        if not (err <= TOL and repeat):
            raise AssertionError(f"edc_cosine {label}: max abs err {err}, "
                                 f"bit-repeatable {repeat}")
        return row

    def madc_case(n, label, main=False):
        x = torch.randn((n, 64), generator=gen, device="cuda")
        M = cosine_similarity_matrix(x).contiguous()
        got = madc_mod.madc(M)
        want = ref.madc_ref(M)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        symmetric = bool(torch.equal(got, got.T))
        # MADC(i, j) = MADC(j, i): the function needs the n(n-1)/2 distinct
        # pairs, each a select, a subtract, an abs-add over n-2 z's; M read
        # once, the (n, n) result written once
        b_ms, b_by = bound_ms(2.0 * n * n * 4,
                              3.0 * n * (n - 1) * max(n - 2, 0) / 2)
        row = {"phase": "kernel", "name": "madc", "case": label, "n": n,
               "tile": madc_mod.madc_tiles(n), "dtype": "float32",
               "max_abs_err": err, "tol": TOL, "symmetric": symmetric,
               "ms": cuda_ms(torch, lambda: madc_mod.madc(M), 20),
               "plain_ms": cuda_ms(torch, lambda: ref.madc_ref(M), 5),
               # Σ_z |M_iz − M_jz| over all z; MADC drops z = i, j from it
               "library_ms": cuda_ms(torch,
                                     lambda: torch.cdist(M, M, p=1), 20),
               "library_call": "torch.cdist(M, M, p=1)",
               "bound_ms": b_ms, "bound_by": b_by}
        if main:
            row.update(call_times(torch, lambda: madc_mod.madc(M),
                                  "madc_kernel"))
        emit(row)
        if not (err <= TOL and symmetric):
            raise AssertionError(f"madc {label}: max abs err {err}, "
                                 f"symmetric {symmetric}")
        return row

    def madc_tile_sweep():
        """Device time of each tile edge (torch.profiler): the numbers
        behind ``madc_tiles``."""
        for n in (100, 257, 512, 768, 1024, 1280, 1536, 2048):
            M = cosine_similarity_matrix(torch.randn(
                (n, 64), generator=gen, device="cuda")).contiguous()
            row = {"phase": "madc_tiles", "n": n,
                   "picked": madc_mod.madc_tiles(n)}
            for tile in madc_mod.TILES:
                row[f"device_ms_tile{tile}"] = profiled_ms(
                    torch, lambda: madc_mod.madc(M, tile=tile),
                    "madc_kernel")
            row["cdist_ms"] = cuda_ms(torch, lambda: torch.cdist(M, M, p=1),
                                      20)
            emit(row)

    def partial_case(n, d, m, dtype, label):
        """edc_cosine's partial-sum entry against its plain version
        (``ref.cosine_sums_ref``), on the packed output itself: the dots
        relative to ‖ΔW_i‖·‖V_j‖, the row and column squares relative to
        themselves, each within PARTIAL_RTOL; E from the sums within TOL
        (fp32) / TOL_BF16 (bf16) as well."""
        dW = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        V = (torch.randn((d, m), generator=gen, device="cuda")
             / math.sqrt(d)).to(dtype)
        got = edc_mod.edc_cosine_partial(dW, V)
        want = ref.cosine_sums_ref(dW, V)
        torch.cuda.synchronize()
        e_want = edc_mod.cosine_from_sums(want, n, m)
        e_err = float((edc_mod.cosine_from_sums(got, n, m)
                       - e_want).abs().max())
        (gd, gr, gc), (wd, wr, wc) = (edc_mod.split_sums(t, n, m)
                                      for t in (got, want))
        errs = {"dots_err_of_norms": float(((gd - wd).abs() / (
                    wr.sqrt()[:, None] * wc.sqrt()[None])).max()),
                "row_sq_max_rel_err": float(((gr - wr).abs() / wr).max()),
                "col_sq_max_rel_err": float(((gc - wc).abs() / wc).max())}
        repeat = bool(torch.equal(got, edc_mod.edc_cosine_partial(dW, V)))
        tol = TOL if dtype == torch.float32 else TOL_BF16
        es = dW.element_size()
        b_ms, b_by = bound_ms(n * d * es + d * m * V.element_size()
                              + (n * m + n + m) * 4,
                              2.0 * n * d * (m + 1) + 2.0 * d * m)
        fn = lambda: edc_mod.edc_cosine_partial(dW, V)  # noqa: E731
        row = {"phase": "kernel", "name": "edc_cosine_partial",
               "case": label, "n": n, "d": d, "m": m,
               "dtype": str(dtype).split(".")[-1],
               "plan": edc_mod.plan(n, d, m, build.sm_count(0))._asdict(),
               "max_abs_err": e_err, "max_abs_err_of": "E from the sums",
               "E_max_abs_ref": float(e_want.abs().max()), **errs,
               "sums_rtol": PARTIAL_RTOL, "tol": tol,
               "bit_repeatable": repeat, "ms": cuda_ms(torch, fn, 10),
               "device_ms": profiled_ms(torch, fn, "edc_", iters=5),
               "plain_ms": cuda_ms(torch, lambda: ref.cosine_sums_ref(dW, V),
                                   3, warmup=1),
               "library_ms": None,
               "library_note": "no single PyTorch call gives the packed "
                               "dots and both sums of squares",
               "bound_ms": b_ms, "bound_by": b_by}
        row["share_of_bound_events"] = b_ms / row["ms"]
        emit(row)
        del dW, V, got, want
        torch.cuda.empty_cache()
        if not (e_err <= tol and repeat
                and max(errs.values()) <= PARTIAL_RTOL):
            raise AssertionError(f"edc_cosine_partial {label}: E max abs err "
                                 f"{e_err} (tol {tol}), packed sums {errs} "
                                 f"(rtol {PARTIAL_RTOL}), bit-repeatable "
                                 f"{repeat}")
        return row

    rows["edc_cosine"] = edc_case(100, 415_258, 5, torch.float32, "main")
    rows["edc_cosine_partial"] = partial_case(
        PARTIAL_N, PARTIAL_D, PARTIAL_M, torch.float32, "rank-block")
    partial_case(PARTIAL_N, PARTIAL_D, PARTIAL_M, torch.bfloat16,
                 "rank-block-bf16")
    edc_case(200, 415_258, 17, torch.float32, "m17")
    edc_case(200, 415_258, 32, torch.float32, "m32")
    edc_case(130, 4_097, 100, torch.bfloat16, "m100-bf16")
    edc_case(37, 100_003, 3, torch.bfloat16, "ragged-bf16")
    edc_case(130, 4_097, 16, torch.float32, "ragged-m16")
    edc_case(9, 333, 11, torch.bfloat16, "ragged-small-bf16")
    rows["madc"] = madc_case(100, "main", main=True)
    madc_case(257, "ragged")
    madc_case(1024, "large")
    madc_case(3, "tiny")
    madc_tile_sweep()
    return rows


def kept_pairs(Sq: int, Sk: int, window, causal: bool) -> int:
    """(query, key) pairs the mask keeps: the work the attention needs."""
    n = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(Sk, qpos + 1) if causal else Sk
        lo = max(0, qpos - window + 1) if window else 0
        n += max(hi - lo, 0)
    return n


def check_zoo_kernels(torch):
    """Phase 2, the zoo's kernels: swa_attention and ssd_intra_chunk against
    their plain versions at Zamba2's prefill shapes and unaligned ones."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.kernels import swa_attention as swa_mod

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def swa_case(B, Sq, Sk, H, hd, window, causal, dtype, label,
                 main=False, times=False, KV=None, want_route=None):
        KV = KV or H
        q = randn((B, Sq, H, hd), dtype)
        k, v = randn((B, Sk, KV, hd), dtype), randn((B, Sk, KV, hd), dtype)
        route = swa_mod._route(dtype, dtype, hd)
        if want_route and route != want_route:
            raise AssertionError(f"swa_attention {label}: route {route}, "
                                 f"not {want_route}")
        before = swa_mod.launches_by_route[route]
        got = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
        want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        if swa_mod.launches_by_route[route] != before + 1:
            raise AssertionError(f"swa_attention {label}: not launched on "
                                 f"the {route} route")
        tol = SWA_TC_TOL if route == "tc" else TOL
        err, ok = allclose_err(torch, got, want, tol, tol)
        del want
        es = q.element_size()
        pairs = kept_pairs(Sq, Sk, window, causal)
        bf16 = dtype == torch.bfloat16
        n_bytes = ((B * Sq * H * hd + 2 * B * Sk * KV * hd) * es
                   + B * Sq * H * hd * 4)
        flops = 4.0 * B * H * hd * pairs
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_OPS_PER_S if bf16 else
                              FP32_OPS_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = {"enable_gqa": True} if KV != H else {}
        if causal and not window and Sq == Sk:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, **gqa)
        elif not causal and not window:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, **gqa)
        else:
            qpos = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
            kpos = torch.arange(Sk, device="cuda")[None, :]
            keep = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
            if causal:
                keep &= kpos <= qpos
            if window:
                keep &= kpos > qpos - window
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=keep, **gqa)
        row = {"phase": "kernel", "name": "swa_attention", "case": label,
               "route": route, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV,
               "hd": hd,
               "window": window, "causal": causal,
               "dtype": str(dtype).split(".")[-1], "kept_pairs": pairs,
               "max_abs_err": err, "tol": tol,
               "ms": cuda_ms(torch, lambda: swa_mod.swa_attention(
                   q, k, v, window=window, causal=causal), 50),
               "plain_ms": cuda_ms(torch, lambda: ref.swa_attention_ref(
                   q, k, v, window=window, causal=causal), 3, warmup=1),
               "library_ms": cuda_ms(torch, lib, 50),
               "library_call": "F.scaled_dot_product_attention"
                               + (" (enable_gqa=True)" if gqa else ""),
               "bound_ms": b_ms, "bound_by": b_by,
               "peak": "bf16 989 TFLOP/s" if bf16 else "fp32 67 TFLOP/s"}
        if route == "fp32":
            row.update(units_bound(n_bytes, flops, row["ms"]))
        if main or times:
            row.update(call_times(torch, lambda: swa_mod.swa_attention(
                q, k, v, window=window, causal=causal),
                "swa_tc_kernel" if route == "tc"
                else ("swa_kernel", "swa_combine_kernel")))
        emit(row)
        if not ok:
            raise AssertionError(f"swa_attention {label}: max abs err {err}")
        return row

    def ssd_case(args, dtype, label, main=False, decay="fast", times=False):
        """args: (Xc, A_cs, Bc, Cc) in the model's chunked layout."""
        Xc, A_cs, Bc, Cc = args
        b, c, Q, h, p = Xc.shape
        n = Bc.shape[-1]
        route = ssd_mod._route(Xc.dtype, Bc.dtype, Q, p, n)
        before = ssd_mod.launches_by_route[route]
        Y, S = ssd_mod.ssd_intra_chunk(*args)
        Yr, Sr = ref.ssd_intra_chunk_ref(*args)
        torch.cuda.synchronize()
        if ssd_mod.launches_by_route[route] != before + 1:
            raise AssertionError(f"ssd_intra_chunk {label}: not launched on "
                                 f"the {route} route")
        ey, oky = allclose_err(torch, Y, Yr, SSD_TOL, SSD_TOL)
        es, oks = allclose_err(torch, S, Sr, SSD_TOL, SSD_TOL)
        # the check is elementwise, |got - want| <= tol·(1 + |want|): its
        # worst ratio (<= 1 where it holds) beside the max abs error
        ratio = max(float(((got - want).abs() / (SSD_TOL * (1 + want.abs())))
                          .max()) for got, want in ((Y, Yr), (S, Sr)))
        del Yr, Sr
        # bytes each input holds (a stride-0 head expansion is read once
        # per group), outputs fp32; FLOPs of the causal lower triangle, C·Bᵀ
        # once per group
        uniq = lambda t: t.untyped_storage().nbytes()  # noqa: E731
        tri = Q * (Q + 1) / 2
        groups = 1 if Bc.stride(3) == 0 and Cc.stride(3) == 0 else h
        bf16 = dtype == torch.bfloat16
        n_bytes = sum(uniq(t) for t in args) + (Y.numel() + S.numel()) * 4
        flops = b * c * (groups * 2 * tri * n
                         + h * (2 * tri * p + 2 * Q * n * p))
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_OPS_PER_S if bf16 else
                              FP32_OPS_PER_S)
        row = {"phase": "kernel", "name": "ssd_intra_chunk", "case": label,
               "route": route, "decay": decay,
               "b": b, "chunks": c, "Q": Q, "h": h, "P": p, "N": n,
               "bc_head_stride": Bc.stride(3),
               "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(ey, es), "tol": SSD_TOL,
               "max_err_over_tol": ratio,
               "ms": cuda_ms(torch, lambda: ssd_mod.ssd_intra_chunk(*args),
                             50),
               "plain_ms": cuda_ms(torch,
                                   lambda: ref.ssd_intra_chunk_ref(*args), 3,
                                   warmup=1),
               "library_ms": None,
               "library_call": "none: no one PyTorch call computes Y_diag "
                               "and the chunk states",
               "bound_ms": b_ms, "bound_by": b_by,
               "peak": "bf16 989 TFLOP/s" if bf16 else "fp32 67 TFLOP/s"}
        if route == "fp32":
            row["heads_per_cta"] = ssd_mod.ssd_heads_per_cta(
                b, c, h, groups > 1, torch.cuda.get_device_properties(
                    0).multi_processor_count)
            row.update(units_bound(n_bytes, flops, row["ms"]))
        if main or times:
            row.update(call_times(
                torch, lambda: ssd_mod.ssd_intra_chunk(*args),
                "ssd_tc_kernel" if route == "tc"
                else ("ssd_kernel", "ssd_cell_kernel")))
        emit(row)
        if not (oky and oks):
            raise AssertionError(f"ssd_intra_chunk {label}: max abs err "
                                 f"{max(ey, es)}")
        return row

    def ssd_model_args(b, c, Q, h, p, n, dtype, decay="fast"):
        """As ``ssd_chunked`` passes them: X (b, l, h, p) split into chunks
        by a view, B/C one group expanded over the heads with stride 0.
        dtA = −s·softplus(randn): s = 1 ("fast") or 0.01 ("slow": L ~ 1
        across the chunk, the worst case for the tc route's rounding)."""
        X = randn((b, c * Q, h, p), dtype).reshape(b, c, Q, h, p)
        dtA = -SSD_DECAY[decay] * F.softplus(randn((b, h, c, Q),
                                                   torch.float32))
        Bg, Cg = randn((b, c * Q, 1, n), dtype), randn((b, c * Q, 1, n), dtype)
        ex = lambda g: g.expand(b, c * Q, h, n).reshape(  # noqa: E731
            b, c, Q, h, n)
        return X, torch.cumsum(dtA, -1), ex(Bg), ex(Cg)

    def ssd_cells_args(BH, NC, Q, P, N, dtype):
        """The Pallas kernel's (BH, NC, Q, ·) layout, B/C head-expanded."""
        X = randn((BH, NC, Q, P), dtype)
        dtA = -F.softplus(randn((BH, NC, Q), torch.float32))
        Bm, Cm = randn((BH, NC, Q, N), dtype), randn((BH, NC, Q, N), dtype)
        return (X[:, :, :, None], torch.cumsum(dtA, -1)[:, None],
                Bm[:, :, :, None], Cm[:, :, :, None])

    bf, f32 = torch.bfloat16, torch.float32
    B, S = ZAMBA_B, ZAMBA_S
    # the tensor-core route at Zamba2's bf16 prefill; the fp32 route at its
    # fp32 forward (phase 6's consistency check, B=1, S=256)
    rows["swa_attention.tc"] = swa_case(B, S, S, 32, 64, None, True, bf,
                                        "zamba2-prefill", main=True)
    swa_case(B, S, S, 32, 64, 512, True, bf, "zamba2-prefill-w512")
    swa_case(B, 1, S, 32, 64, None, True, bf, "decode-tail")
    swa_case(2, 1000, 1000, 8, 128, None, True, bf, "hd128-bf16")
    rows["swa_attention.fp32"] = swa_case(
        1, CONSIST_S, CONSIST_S, 32, 64, None, True, f32, "zamba2-fp32",
        main=True)
    swa_case(B, S, S, 32, 64, None, True, f32, "zamba2-prefill-fp32",
             times=True)
    swa_case(1, CONSIST_S, CONSIST_S, 32, 64, 64, True, f32,
             "zamba2-fp32-w64")
    swa_case(2, 33, 65, 2, 40, 16, True, f32, "unaligned-fp32")
    swa_case(1, 96, 96, 2, 80, None, False, f32, "bidirectional-fp32")
    # the zoo families' head layouts (phase 6b's bf16 prefills): MQA at hd
    # 256 (Gemma, also in the long_500k window), GQA on the tensor cores,
    # HuBERT's bidirectional hd 80
    for label, (b, s_, h, kv, hd, w, causal, route) in FAMILY_SWA.items():
        swa_case(b, s_, s_, h, hd, w, causal, bf, label, KV=kv,
                 want_route=route,
                 times=label in ("gemma-prefill", "deepseek-mtp"))
    # the tensor-core route at Zamba2's bf16 prefill, in both decay regimes;
    # the fp32 route at its fp32 forward (B=1, S=256: two chunks)
    rows["ssd_intra_chunk.tc"] = ssd_case(
        ssd_model_args(B, S // 128, 128, 64, 64, 64, bf), bf,
        "zamba2-prefill", main=True)
    ssd_case(ssd_model_args(B, S // 128, 128, 64, 64, 64, bf, "slow"), bf,
             "zamba2-prefill-slow-decay", decay="slow")
    ssd_case(ssd_cells_args(B * 64, S // 128, 128, 64, 64, bf), bf,
             "zamba2-cells-bf16")
    rows["ssd_intra_chunk.fp32"] = ssd_case(
        ssd_model_args(1, CONSIST_S // 128, 128, 64, 64, 64, f32), f32,
        "zamba2-fp32", main=True)
    ssd_case(ssd_model_args(B, S // 128, 128, 64, 64, 64, f32), f32,
             "zamba2-prefill-fp32", times=True)
    ssd_case(ssd_model_args(B, S // 128, 128, 64, 64, 64, f32, "slow"), f32,
             "zamba2-prefill-fp32-slow-decay", decay="slow")
    ssd_case(ssd_cells_args(B * 64, S // 128, 128, 64, 64, f32), f32,
             "zamba2-cells-fp32")
    ssd_case(ssd_cells_args(6, 3, 37, 23, 11, f32), f32, "unaligned-fp32")
    ssd_heads_sweep(torch, ssd_mod, ssd_model_args(B, S // 128, 128, 64, 64,
                                                   64, f32))
    return rows


def ssd_heads_sweep(torch, ssd_mod, args):
    """Device time of the fp32 SSD route at Zamba2's fp32 prefill for each
    power-of-two head block (torch.profiler): the numbers behind
    ``ssd_heads_per_cta``."""
    b, c, _, h, _ = args[0].shape
    row = {"phase": "ssd_heads", "b": b, "chunks": c, "h": h,
           "picked": ssd_mod.ssd_heads_per_cta(
               b, c, h, False,
               torch.cuda.get_device_properties(0).multi_processor_count)}
    for hb in (1, 2, 4, 8, 16, 32):
        row[f"device_ms_hb{hb}"] = profiled_ms(
            torch, lambda: ssd_mod.ssd_intra_chunk(*args, heads_per_cta=hb),
            ("ssd_kernel", "ssd_cell_kernel"))
    emit(row)


def units_bound(n_bytes: float, flops: float, ms: float) -> dict:
    """The fp32 routes run each fp32 product as three TF32 tensor-core
    products: their bound at those units (bytes over 3.35 TB/s, or 3·FLOPs
    over 495 TFLOP/s), and the kernel's share of it and of the fp32 bound
    (67 TFLOP/s, ``bound_ms``)."""
    tc_ms, tc_by = bound_ms(n_bytes, TF32_TERMS * flops, TF32_OPS_PER_S)
    fp32_ms, _ = bound_ms(n_bytes, flops, FP32_OPS_PER_S)
    return {"bound_3xtf32_ms": tc_ms, "bound_3xtf32_by": tc_by,
            "share_of_fp32_bound": fp32_ms / ms,
            "share_of_3xtf32_bound": tc_ms / ms}


def fedgroup_run(torch, data, model, measure: str):
    """Phase 4: one FedGroup run at full width; returns its record."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.engine import FedConfig
    from repro_torch.kernels import ops

    cfg = FedConfig(n_rounds=ROUNDS, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=5, pretrain_scale=20,
                    measure=measure, seed=0)
    tr = FedGroupTrainer(model, data, cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pre_idx, labels = tr.group_cold_start()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    sizes = [int(v) for v in
             torch.bincount(torch.as_tensor(labels, dtype=torch.int64),
                            minlength=tr.m)]
    emit({"phase": "cold_start", "measure": measure, "n_pre": len(pre_idx),
          "d_w": tr.model_size, "group_sizes": sizes, "cold_ms": cold_ms})
    round_ms = []
    for t in range(ROUNDS):
        t1 = time.perf_counter()
        m = tr.round(t)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
        rec = {"phase": "round", "measure": measure, "t": t,
               "acc": m.weighted_acc, "loss": m.mean_loss,
               "disc": m.discrepancy, "cold": tr.last_cold,
               "round_ms": round_ms[-1]}
        emit(rec)
        for k in ("acc", "loss", "disc"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{measure} round {t}: {k} = {rec[k]}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "run", "measure": measure, "launches": counts,
          "cold_ms": cold_ms, "round_ms": round_ms,
          "peak_device_bytes": peak})
    return tr, pre_idx, counts


def edc_cold_start_many_groups(torch, data, model):
    """Phase 4b: FedGroup's EDC group cold start with EDC_GROUPS groups
    (n_pre = min(20·20, 200) = 200 clients, m > 16: two column tiles of
    the kernel), on the main path's data: the kernel launched, every label
    in [0, EDC_GROUPS), and the E it gave within TOL of the plain version
    on the same ΔW and V (captured from ``edc_embed``)."""
    from repro_torch.core import measures
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.engine import FedConfig
    from repro_torch.kernels import ops, ref

    cfg = FedConfig(n_rounds=1, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=EDC_GROUPS,
                    pretrain_scale=20, measure="edc", seed=0)
    tr = FedGroupTrainer(model, data, cfg, device="cuda")
    seen = {}
    embed = measures.edc_embed

    def capture(dW, m, omega, mesh=None):
        E, V = embed(dW, m, omega, mesh=mesh)
        seen.update(dW=dW, E=E, V=V)
        return E, V

    measures.edc_embed = capture
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pre_idx, labels = tr.group_cold_start()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
    finally:
        measures.edc_embed = embed
    labels = [int(x) for x in labels]
    err = float((seen["E"] - ref.cosine_block_ref(
        seen["dW"].contiguous(), seen["V"].contiguous())).abs().max())
    emit({"phase": "cold_start_many_groups", "n_groups": EDC_GROUPS,
          "n_pre": len(pre_idx), "d_w": tr.model_size,
          "launches": counts, "cold_ms": cold_ms, "max_abs_err": err,
          "tol": TOL, "group_sizes": [labels.count(j)
                                      for j in range(EDC_GROUPS)]})
    if counts["edc_cosine"] < 1:
        raise AssertionError("20-group cold start launched no edc_cosine")
    if not all(0 <= x < EDC_GROUPS for x in labels):
        raise AssertionError(f"20-group cold start: labels {labels}")
    if not err <= TOL:
        raise AssertionError(f"20-group cold start: E max abs err {err}")
    return counts


def strategy_run(torch, data, model, name: str):
    """Phase 4c: one dynamic-assignment strategy (``strategies
    .make_trainer``), or FedGroup with the shift detector at the reference
    tests' threshold 0.35 (``name == "shift"``), at full width for ROUNDS
    rounds. Fails on a non-finite metric, a label outside [0, m), a
    FeSEM / FedClust ``local_flat`` off the card, or a shift run that
    probes nobody. Returns the run's kernel launch counts."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedConfig
    from repro_torch.kernels import ops

    shift = name == "shift"
    cfg = FedConfig(n_rounds=ROUNDS, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=5, pretrain_scale=20,
                    seed=0, shift_threshold=0.35 if shift else None,
                    shift_check_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = (FedGroupTrainer(model, data, cfg, device="cuda") if shift else
          strategies.make_trainer(name, model, data, cfg, device="cuda"))
    rec = {"phase": "strategy", "strategy": name, "rounds": []}
    for t in range(ROUNDS):
        before = tr.membership.copy()
        mig0 = tr.counters["rounds.migrations"]
        t1 = time.perf_counter()
        m = tr.round(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        row = {"t": t, "acc": m.weighted_acc, "loss": m.mean_loss,
               "disc": m.discrepancy, "round_ms": ms,
               "changed": int(np.sum((before >= 0)
                                     & (before != tr.membership))),
               "newly_assigned": int(np.sum((before < 0)
                                            & (tr.membership >= 0))),
               "migrations": tr.counters["rounds.migrations"] - mig0}
        if shift:
            row["probed"], row["shifted"] = tr._shift_last
        rec["rounds"].append(row)
        for k in ("acc", "loss", "disc"):
            if not math.isfinite(row[k]):
                raise AssertionError(f"{name} round {t}: {k} = {row[k]}")
    counts = ops.launch_counts()
    labels = tr.membership[tr.membership >= 0]
    rec.update(migrations=tr.counters["rounds.migrations"],
               comm_params=tr.comm_params,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               group_sizes=[int(v) for v in np.bincount(labels,
                                                        minlength=tr.m)],
               launches=counts)
    if shift:
        rec["shift_checks"] = tr.counters["rounds.shift_checks"]
        rec["cached_dirs"] = len(tr._pin_dirs)
    if hasattr(tr, "local_flat"):
        lf = tr.local_flat
        rec["local_flat"] = {"shape": list(lf.shape),
                             "bytes": lf.numel() * lf.element_size(),
                             "device": str(lf.device)}
    emit(rec)
    if not ((labels >= 0) & (labels < tr.m)).all():
        raise AssertionError(f"{name}: labels outside [0, {tr.m})")
    if "local_flat" in rec and tr.local_flat.device.type != "cuda":
        raise AssertionError(f"{name}: local_flat is not on the card")
    if shift and rec["shift_checks"] < 1:
        raise AssertionError("the shift run probed nobody")
    return counts


def breakdown(torch, tr, pre_idx):
    """Phase 5: the cold start's two parts, timed apart on the same
    pre-training cohort, and a round's local solve alone (host clock
    around work ending in synchronize)."""
    from repro_torch.core import measures
    from repro_torch.core.svd import OVERSAMPLE
    from repro_torch.models.modules import flatten_stacked

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (deltas, _, _), solve_ms = timed(lambda: tr._solve(tr.params, pre_idx))
    cohort = pre_idx[:tr.cfg.clients_per_round]
    _, round_solve_ms = timed(lambda: tr._solve(tr.params, cohort))
    dW = flatten_stacked(deltas)
    omega = tr.draws.svd_omega(len(pre_idx),
                               min(tr.m + OVERSAMPLE, len(pre_idx)), "cuda")
    _, edc_ms = timed(lambda: measures.edc_embed(dW, tr.m, omega))
    _, madc_ms = timed(lambda: measures.madc(
        measures.cosine_similarity_matrix(dW)))
    emit({"phase": "breakdown", "n_pre": len(pre_idx),
          "local_solver_ms": solve_ms, "k": len(cohort),
          "round_local_solver_ms": round_solve_ms, "edc_embed_ms": edc_ms,
          "cosine_plus_madc_ms": madc_ms,
          "note": "local solver is plain PyTorch (autograd); the kernels "
                  "sit inside edc_embed / madc"})


def round_profile(torch, tr):
    """Phase 5: one more round under torch.profiler: the device's busy
    share of the round's wall time (sum of kernel times over the host
    clock around the round), the kernel launches, and the kernels that
    take the most device time. ``None`` where the profiler records no
    device activity (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.round(len(tr.history.rounds))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    emit({"phase": "round_profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "kernel_launches": sum(e.count for e in kern) if kern else None,
          "top_kernels": [[e.key[:80], e.count,
                           e.self_device_time_total / 1e3] for e in top]})


def reference_check(torch):
    """Phase 3: the same tiny run on the CPU (plain versions) and on the
    card (kernels), with the same draws (TorchDraws uses a CPU generator):
    cold-start labels equal, losses and discrepancies within rtol 1e-3
    (float sums in another order over many SGD steps), accuracy within
    0.01 (argmax can flip at a near-tie)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mlp

    data = mnist_like(seed=0, n_clients=30, classes_per_client=2,
                      total_train=2000, dim=32)
    for measure in ("edc", "madc"):
        cfg = FedConfig(n_rounds=2, clients_per_round=8, local_epochs=2,
                        batch_size=10, lr=0.05, n_groups=3,
                        pretrain_scale=4, measure=measure, seed=0)
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = FedGroupTrainer(mlp(32, 16, 10), data, cfg, device=dev)
            runs[dev] = (tr.run(), tr.membership.copy())
        (hc, mc), (hg, mg) = runs["cpu"], runs["cuda"]
        ok = bool((mc == mg).all())
        for rc, rg in zip(hc.rounds, hg.rounds):
            ok &= math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
            ok &= math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
            ok &= abs(rc.weighted_acc - rg.weighted_acc) <= 0.01
        emit({"phase": "reference", "measure": measure, "ok": ok,
              "cpu": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                      for r in hc.rounds],
              "cuda": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                       for r in hg.rounds]})
        if not ok:
            raise AssertionError(f"{measure}: card run disagrees with CPU")
    for name in STRATEGIES + ("shift",):
        reference_check_strategy(torch, data, name)
    reference_check_block(torch, data)
    reference_check_faults(torch, data)


def make_block_trainer(model, data, name: str, block_size: int, **kw):
    """FedAvg, FedGroup or a registered strategy with ``block_size``."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig

    device = kw.pop("device", "cuda")
    cfg = FedConfig(block_size=block_size, **kw)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, device=device)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device=device)
    return strategies.make_trainer(name, model, data, cfg, device=device)


def reference_check_block(torch, data):
    """Phase 3, round blocks: the same tiny run with ``block_size=4`` over
    6 rounds on the CPU (the eager block) and on the card (the captured
    graphs), for all six trainers: membership equal, loss and discrepancy
    within rtol 1e-3, accuracy within 0.01, and the card's blocked rounds
    all replays."""
    from repro_torch.models.paper_models import mlp

    for name in ("fedavg", "fedgroup") + STRATEGIES:
        kw = dict(n_rounds=6, clients_per_round=8, local_epochs=2,
                  batch_size=10, lr=0.05, n_groups=3, pretrain_scale=8,
                  seed=0)
        trs = {dev: make_block_trainer(mlp(32, 16, 10), data, name, 4,
                                       device=dev, **kw)
               for dev in ("cpu", "cuda")}
        hist = {dev: tr.run() for dev, tr in trs.items()}
        ex = trs["cuda"]._block_exec
        ok = ex.replays >= 1 and ex.captures == 1
        if name != "fedavg":
            ok &= bool((trs["cpu"].membership
                        == trs["cuda"].membership).all())
        for rc, rg in zip(hist["cpu"].rounds, hist["cuda"].rounds):
            ok &= math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
            ok &= math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
            ok &= abs(rc.weighted_acc - rg.weighted_acc) <= 0.01
        emit({"phase": "reference", "block": name, "ok": ok,
              "replays": ex.replays,
              "cpu": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                      for r in hist["cpu"].rounds],
              "cuda": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                       for r in hist["cuda"].rounds]})
        if not ok:
            raise AssertionError(f"block {name}: card run disagrees with "
                                 "CPU, or no round was replayed")


def reference_check_strategy(torch, data, name: str):
    """Phase 3, the dynamic-assignment strategies and FedGroup's shift
    detector at threshold 0.0 (every probed client re-routed, so the
    invalidate, cache and eq.-9 steps all run): the same tiny run on the
    CPU and on the card with the same draws and group inits (both drawn
    on the CPU), 2 rounds. Membership equal after every round, loss and
    discrepancy within rtol 1e-3, accuracy within 0.01; the shift run must
    probe and re-route somebody on both devices."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mlp

    cfg = FedConfig(n_rounds=2, clients_per_round=8, local_epochs=2,
                    batch_size=10, lr=0.05, n_groups=3, pretrain_scale=4,
                    seed=0, shift_threshold=0.0 if name == "shift" else None)
    trainers = {dev: (FedGroupTrainer(mlp(32, 16, 10), data, cfg, device=dev)
                      if name == "shift" else
                      strategies.make_trainer(name, mlp(32, 16, 10), data,
                                              cfg, device=dev))
                for dev in ("cpu", "cuda")}
    ok, rounds, shifted = True, {"cpu": [], "cuda": []}, {}
    for t in range(cfg.n_rounds):
        for dev, tr in trainers.items():
            r = tr.round(t)
            rounds[dev].append([r.weighted_acc, r.mean_loss, r.discrepancy])
            if name == "shift":
                shifted.setdefault(dev, []).append(len(tr._last_shifted))
        c, g = trainers["cpu"], trainers["cuda"]
        (ac, lc, dc), (ag, lg, dg) = rounds["cpu"][-1], rounds["cuda"][-1]
        ok &= bool((c.membership == g.membership).all())
        ok &= math.isclose(lc, lg, rel_tol=1e-3)
        ok &= math.isclose(dc, dg, rel_tol=1e-3)
        ok &= abs(ac - ag) <= 0.01
    rec = {"phase": "reference", "strategy": name, "ok": ok, **rounds}
    if name == "shift":
        rec["shift_checks"] = {dev: tr.counters["rounds.shift_checks"]
                               for dev, tr in trainers.items()}
        rec["shifted_per_round"] = shifted
        ok &= all(rec["shift_checks"][d] > 0 and sum(shifted[d]) > 0
                  for d in trainers)
        rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: card run disagrees with CPU, or the "
                             "shift run re-routed nobody")


def profile_window(torch, fn, trace_path=None) -> dict:
    """``fn`` under torch.profiler: wall ms (host clock, ended by
    synchronize), the device's busy ms and share (kernels and copies), the
    device kernels, and the host's launch calls (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, copies). None where the profiler recorded no
    device activity (not measured). ``trace_path``: where to write the
    chrome trace too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    host = [e for e in ev if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    calls = lambda *keys: sum(e.count for e in host  # noqa: E731
                              if any(k in e.key for k in keys))
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if dev else None,
            "device_busy_share": busy / wall_ms if dev else None,
            "device_ops": sum(e.count for e in dev) if dev else None,
            "host_kernel_launches": calls("LaunchKernel"),
            "host_graph_launches": calls("GraphLaunch"),
            "host_copies": calls("Memcpy")}


def block_run(torch, data, model, name: str, alpha: int):
    """Phase 4d: one trainer at full width, BLOCK_ROUNDS rounds per round
    (eager) and in blocks of BLOCK_SIZE (captured graphs), from the same
    seed. Host-clock ms (ended by synchronize) of every eager round, of
    every block and of the staging; the capture's ms; one eager round and
    one block under torch.profiler; peak memory of each run. Fails unless
    membership is equal wherever the blocked run shows it (after each
    per-round round and each block), every round's loss, discrepancy and
    accuracy agree within BLOCK_RTOL, and the graph replays equal the
    blocked rounds."""
    kw = dict(n_rounds=BLOCK_ROUNDS, clients_per_round=20, local_epochs=2,
              batch_size=10, lr=0.03, n_groups=5, pretrain_scale=alpha,
              seed=0)
    grouped = name != "fedavg"
    membership = lambda tr: tr.membership.copy() if grouped else None  # noqa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = make_block_trainer(model, data, name, 1, **kw)
    eager_ms, mem_a = [], []
    for _ in range(BLOCK_ROUNDS):
        t0 = time.perf_counter()
        a.run(1)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        mem_a.append(membership(a))
    eager_peak = torch.cuda.max_memory_allocated()
    eager_rounds = list(a.history.rounds)
    eager_prof = profile_window(torch, lambda: a.run(1))
    del a
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = make_block_trainer(model, data, name, BLOCK_SIZE, **kw)
    ex = b._block_executor()
    stage_ms, block_ms, block_len, seen = [], [], [], {}
    stage_block, run_block, one_round = b._stage_block, b._run_block, b.round

    def timed_stage(t0, max_b):
        t1 = time.perf_counter()
        out = stage_block(t0, max_b)
        stage_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    def timed_block(t0, staged):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_block(t0, staged)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t1) * 1e3)
        block_len.append(len(staged))
        seen[t0 + len(staged) - 1] = membership(b)

    def seen_round(t, idx=None):
        out = one_round(t, idx)
        seen[t] = membership(b)
        return out

    b._stage_block, b._run_block, b.round = (timed_stage, timed_block,
                                             seen_round)
    t0 = time.perf_counter()
    b.run(BLOCK_ROUNDS)
    torch.cuda.synchronize()
    blocked_total_ms = (time.perf_counter() - t0) * 1e3
    blocked_peak = torch.cuda.max_memory_allocated()
    blocked = sum(block_len)

    dev = {"acc": 0.0, "loss": 0.0, "disc": 0.0}
    for ra, rb in zip(eager_rounds, b.history.rounds, strict=True):
        for k, f in (("acc", "weighted_acc"), ("loss", "mean_loss"),
                     ("disc", "discrepancy")):
            x, y = getattr(ra, f), getattr(rb, f)
            dev[k] = max(dev[k], abs(y - x) / max(abs(x), 1e-30))
    mem_ok = all(m is None or bool((m == mem_a[t]).all())
                 for t, m in seen.items())
    # the first block holds the capture; later blocks are steady replays
    steady = [(ms, n) for ms, n in zip(block_ms[1:], block_len[1:])]
    rec = {"phase": "block", "trainer": name, "alpha": alpha,
           "rounds": BLOCK_ROUNDS, "block_size": BLOCK_SIZE,
           "blocks": list(block_len), "rounds_in_blocks": blocked,
           "graph_replays": ex.replays, "eval_replays": ex.eval_replays,
           "captures": ex.captures, "capture_ms": ex.capture_ms,
           "membership_equal": mem_ok, "membership_checked_at": sorted(seen),
           "max_rel_dev": dev, "rtol": BLOCK_RTOL,
           "eager_round_ms": eager_ms, "block_ms": list(block_ms),
           "blocked_round_ms_steady": (sum(ms for ms, _ in steady)
                                       / sum(n for _, n in steady)
                                       if steady else None),
           "stage_ms": stage_ms,
           "stage_ms_per_round": (sum(stage_ms) / blocked if blocked
                                  else None),
           "eager_total_ms": sum(eager_ms),
           "blocked_total_ms": blocked_total_ms,
           "eager_peak_device_bytes": eager_peak,
           "blocked_peak_device_bytes": blocked_peak,
           "eager_round_profile": eager_prof,
           "acc": [r.weighted_acc for r in b.history.rounds]}
    rec["eager_host_launches_per_round"] = (
        eager_prof["host_kernel_launches"] + eager_prof["host_copies"])
    if (name, alpha) != ("fedgroup", 20):
        # one more block of BLOCK_SIZE rounds, profiled
        r0 = ex.replays
        prof = profile_window(torch, lambda: b.run(BLOCK_SIZE))
        rec["block_profile"] = {**prof, "replays": ex.replays - r0}
        rec["blocked_host_launches_per_round"] = (
            prof["host_kernel_launches"] + prof["host_graph_launches"]
            + prof["host_copies"]) / BLOCK_SIZE
        if ex.replays - r0 != BLOCK_SIZE:
            raise AssertionError(f"block {name}: the profiled block "
                                 f"replayed {ex.replays - r0} rounds")
    emit(rec)
    if ex.replays != sum(block_len) or (blocked and ex.captures != 1):
        raise AssertionError(f"block {name}: {ex.replays} graph replays "
                             f"for {sum(block_len)} blocked rounds")
    if blocked == 0 and (name, alpha) != ("fedgroup", 20):
        raise AssertionError(f"block {name}: no round ran in a block")
    if not mem_ok:
        raise AssertionError(f"block {name}: membership differs from the "
                             "eager run")
    if max(dev.values()) > BLOCK_RTOL:
        raise AssertionError(f"block {name}: metrics deviate {dev}")
    return rec


def h2d_overlap(trace_path: Path) -> dict:
    """From a chrome trace of torch.profiler: the host-to-device copies on
    streams that ran no kernel (the population's copy stream), and how
    long they ran while a kernel ran on another stream."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if "ts" in e]

    def span(e):
        return (e["ts"], e["ts"] + e.get("dur", 0),
                e.get("args", {}).get("stream"))

    kernels = [span(e) for e in events if e.get("cat") == "kernel"]
    compute = {s for _, _, s in kernels}
    copies = [span(e) for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    side = [c for c in copies if c[2] not in compute]
    overlap_us = sum(max(0.0, min(a1, b1) - max(a0, b0))
                     for a0, a1, _ in side for b0, b1, _ in kernels)
    return {"h2d_copies": len(copies),
            "h2d_copies_off_compute_streams": len(side),
            "h2d_us_off_compute_streams": sum(b - a for a, b, _ in side),
            "h2d_overlap_with_kernels_us": overlap_us,
            "h2d_overlaps_compute": overlap_us > 0.0}


H2D_MARK = 4_099     # bytes of the marker copy that opens a traced window


def traced_h2d_bytes(torch, fn, trace_path: Path) -> list:
    """``fn`` under torch.profiler after one warm-up step: CUPTI is
    enabled in the warm-up and capture starts at the traced step (a
    profiler started cold in a process that profiled before missed the
    first half second of phase 4f's run on the H100). Marker copies of
    H2D_MARK bytes open the traced step, the last one five seconds after
    the first (a trace that opened late in the step still holds it: one
    opened 2.5 s late on the H100). Returns,
    in start order, the bytes of the host-to-device copies after the last
    marker on streams that ran no kernel (the population's copy stream).
    Raises when the trace lacks a marker or the byte counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    mark = torch.zeros(H2D_MARK, dtype=torch.uint8).pin_memory()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(trace_path))) as prof:
        mark.to("cuda")
        torch.cuda.synchronize()
        prof.step()
        mark.to("cuda")
        torch.cuda.synchronize()
        time.sleep(5.0)
        mark.to("cuda")
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        prof.step()
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if "ts" in e]
    compute = {e.get("args", {}).get("stream") for e in events
               if e.get("cat") == "kernel"}
    copies = sorted((e for e in events if e.get("cat") == "gpu_memcpy"
                     and "HtoD" in e.get("name", "")), key=lambda e: e["ts"])
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        raise AssertionError(f"{trace_path}: host-to-device copies without "
                             "byte counts")
    first = max((i for i, e in enumerate(copies)
                 if e["args"]["bytes"] == H2D_MARK), default=None)
    if first is None:
        t0 = min((e["ts"] for e in events if e.get("cat") == "cpu_op"),
                 default=0.0)
        emit({"phase": "trace_diagnostic", "trace": str(trace_path),
              "events": len(events), "first_cpu_op_ts": t0,
              "first_gpu_ts": min((e["ts"] for e in events if e.get("cat")
                                   in ("kernel", "gpu_memcpy")),
                                  default=None),
              "h2d": [[e["ts"] - t0, e["args"].get("bytes"),
                       e["args"].get("stream")] for e in copies[:20]],
              "runtime_copies": [e["ts"] - t0 for e in sorted(
                  (e for e in events if e.get("cat") == "cuda_runtime"
                   and "Memcpy" in e.get("name", "")),
                  key=lambda e: e["ts"])[:10]]})
        raise AssertionError(f"{trace_path}: the marker copy is missing, so "
                             "the trace began after the traced window did")
    return [int(e["args"]["bytes"]) for e in copies[first + 1:]
            if e["args"].get("stream") not in compute]


def stream_trainer(model, data, name: str, population=None):
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig

    cfg = FedConfig(n_rounds=ROUNDS, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=5, pretrain_scale=20,
                    seed=0)
    kw = dict(device="cuda", population=population)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, **kw)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, **kw)
    return strategies.make_trainer(name, model, data, cfg, **kw)


def eval_ms(torch, tr) -> float:
    """Host ms of one round's evaluation (``_round_eval`` of a round on
    the eval cadence), ended by synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._round_eval(0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def timed_rounds(torch, tr, rounds: int, grouped: bool):
    """``rounds`` calls of ``tr.run(1)``: host ms of each (ended by
    synchronize), the membership after each, and the history."""
    ms, mem = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        mem.append(tr.membership.copy() if grouped else None)
    return ms, mem, list(tr.history.rounds)


def max_rel_dev(a_rounds, b_rounds) -> dict:
    """Largest relative deviation of loss, discrepancy and accuracy (NaN
    where the round is off the eval cadence, equal in both runs)."""
    dev = {"acc": 0.0, "loss": 0.0, "disc": 0.0}
    for ra, rb in zip(a_rounds, b_rounds, strict=True):
        for k, f in (("acc", "weighted_acc"), ("loss", "mean_loss"),
                     ("disc", "discrepancy")):
            x, y = getattr(ra, f), getattr(rb, f)
            if math.isnan(x) and math.isnan(y):
                continue
            dev[k] = max(dev[k], abs(y - x) / max(abs(x), 1e-30))
    return dev


def stream_run(torch, data, model, name: str):
    """Phase 4e-i: one trainer at full width for ROUNDS rounds pinned and
    ROUNDS rounds through ``Population(ArrayClientStore(data),
    PopulationConfig(prefetch=2))``, same seed. Fails unless membership is
    equal every round and loss, discrepancy and accuracy agree within
    STREAM_RTOL. Prints round ms of both, the producer's stage ms and the
    H2D bytes per cohort, peak memory of both, one more streamed round
    under torch.profiler (busy share; whether the copy stream's H2D ran
    while a kernel ran) and, for FeSEM, the host ``local_flat`` and the
    time of one cohort's table update done inline (what the state writer
    thread saves a round)."""
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore

    grouped = name != "fedavg"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()   # earlier phases' live tensors
    a = stream_trainer(model, data, name)
    pin_ms, pin_mem, pin_rounds = timed_rounds(torch, a, ROUNDS, grouped)
    pin_peak = torch.cuda.max_memory_allocated()
    pin_eval_ms = eval_ms(torch, a)
    del a
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pop = Population(ArrayClientStore(data), PopulationConfig(prefetch=2))
    b = stream_trainer(model, None, name, population=pop)
    cohorts = []
    next_cohort = pop.next_cohort

    def seen_cohort():
        c = next_cohort()
        cohorts.append({"t": c.t, "stage_ms": c.stage_ms, "h2d_bytes": sum(
            v.numel() * v.element_size() for v in (c.x, c.y, c.n))})
        return c

    pop.next_cohort = seen_cohort
    st_ms, st_mem, st_rounds = timed_rounds(torch, b, ROUNDS, grouped)
    st_peak = torch.cuda.max_memory_allocated()
    st_eval_ms = eval_ms(torch, b)
    dev = max_rel_dev(pin_rounds, st_rounds)
    mem_ok = all(x is None or bool((x == y).all())
                 for x, y in zip(pin_mem, st_mem))
    trace = ROOT / "build" / f"population_{name}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof = profile_window(torch, lambda: b.run(1), trace_path=str(trace))
    overlap = h2d_overlap(trace)
    rec = {"phase": "stream", "trainer": name, "rounds": ROUNDS,
           "prefetch": 2, "membership_equal": mem_ok, "max_rel_dev": dev,
           "rtol": STREAM_RTOL, "pinned_round_ms": pin_ms,
           "streamed_round_ms": st_ms, "cohorts": cohorts,
           "pinned_eval_ms": pin_eval_ms, "streamed_eval_ms": st_eval_ms,
           "device_bytes_before": before,
           "pinned_peak_device_bytes": pin_peak,
           "streamed_peak_device_bytes": st_peak,
           "streamed_round_profile": {**prof, **overlap},
           "acc": [r.weighted_acc for r in st_rounds]}
    b.close()                   # lands every pending state-table write
    if name == "fesem":
        table = pop.state._local_flat
        rec["local_flat_host"] = {
            "rows": len(table), "d_w": b.model_size,
            "bytes": len(table) * b.model_size * 4,
            "device": str(table.default_row.device),
            "rows_on_cpu": all(r.device.type == "cpu"
                               for r in table.rows.values()),
            "inline_scatter_ms": inline_scatter_ms(
                pop, b.cfg.clients_per_round)}
    emit(rec)
    if not mem_ok:
        raise AssertionError(f"stream {name}: membership differs from the "
                             "pinned run")
    if max(dev.values()) > STREAM_RTOL:
        raise AssertionError(f"stream {name}: metrics deviate {dev}")
    if name == "fesem" and not (rec["local_flat_host"]["rows_on_cpu"] and
                                rec["local_flat_host"]["device"] == "cpu"):
        raise AssertionError("stream fesem: local_flat rows off the host")
    if cohorts and cohorts[0]["h2d_bytes"] <= 0:
        raise AssertionError(f"stream {name}: no H2D bytes")
    return rec


def inline_scatter_ms(pop, k: int, reps: int = 5) -> float:
    """Median ms of one cohort's ``local_flat`` table update run on the
    calling thread: the work the state writer thread takes off a FeSEM
    round. The rows are read back and written again, so the table keeps
    its values."""
    ids = np.fromiter(pop.state._local_flat.rows, np.int64)[:k]
    rows = pop.state.gather_local_flat(ids)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pop.state.scatter_local_flat(ids, rows)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_rss_bytes() -> int:
    """The process's resident set now (``/proc/self/statm``)."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * resource.getpagesize()


def resume_trainer(model, data, name: str, ckpt_dir=None):
    """Phase 4f's trainers at phase 4's width: FedGroup pinned (EDC), or
    FeSEM streamed with newcomer arrivals (RESUME_POP)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedConfig
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore

    ck = (dict(checkpoint_every=2, checkpoint_dir=str(ckpt_dir))
          if ckpt_dir is not None else {})
    cfg = FedConfig(n_rounds=RESUME_ROUNDS, clients_per_round=20,
                    local_epochs=2, batch_size=10, lr=0.03, n_groups=5,
                    pretrain_scale=20, seed=0, **ck)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device="cuda")
    pop = Population(ArrayClientStore(data), PopulationConfig(**RESUME_POP))
    return strategies.make_trainer(name, model, None, cfg, device="cuda",
                                   population=pop)


def resume_run(torch, data, model, name: str) -> dict:
    """Phase 4f-i: kill-and-resume at full width. RESUME_ROUNDS rounds
    uninterrupted; the same trainer with ``checkpoint_every=2`` killed
    after 3 rounds; a fresh one ``load_checkpoint``s the directory (must
    return 2) and runs 2 more. Fails unless the histories are equal, every
    parameter and group parameter differs by 0, membership is equal and,
    for FeSEM, every host ``local_flat`` row is equal. Prints the archive's
    bytes, ``save_checkpoint`` and ``load_checkpoint`` ms (host clock, the
    save ending in its fsync, the load in synchronize) and their share of
    the uninterrupted run's median round (t >= 1)."""
    import shutil

    ckpt_dir = ROOT / "build" / f"ckpt_{name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = resume_trainer(model, data, name)
    ref_ms, _, _ = timed_rounds(torch, ref, RESUME_ROUNDS, False)
    ref.close()

    killed = resume_trainer(model, data, name, ckpt_dir)
    save_ms = []
    save = killed.save_checkpoint

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(*a, **kw)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return path

    killed.save_checkpoint = timed_save
    killed.run(3)
    killed.close()
    del killed
    archives = sorted(p.name for p in ckpt_dir.iterdir())

    resumed = resume_trainer(model, data, name, ckpt_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = resumed.load_checkpoint(str(ckpt_dir))
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    resumed.run(RESUME_ROUNDS - t)
    resumed.close()

    dev = 0.0
    for a, b in ((ref.params, resumed.params),
                 (ref.group_params, resumed.group_params)):
        for k in a:
            dev = max(dev, float((a[k] - b[k]).abs().max()))
    mem_equal = bool((ref.membership == resumed.membership).all())
    rows_equal = None
    if ref.population is not None:
        ids = np.arange(ref.n_clients)
        rows_equal = bool(torch.equal(ref.population.gather_local_flat(ids),
                                      resumed.population.gather_local_flat(
                                          ids)))
    hist_equal = resumed.history.rounds == ref.history.rounds
    median = float(np.median(ref_ms[1:]))
    archive = ckpt_dir / archives[0]
    rec = {"phase": "resume", "trainer": name,
           "streamed": ref.population is not None,
           "rounds": RESUME_ROUNDS, "killed_after": 3, "resumed_at": t,
           "archives": archives, "archive_bytes": archive.stat().st_size,
           "save_ms": save_ms, "load_ms": load_ms,
           "round_ms": ref_ms, "median_round_ms": median,
           "save_share_of_round": save_ms[0] / median,
           "load_share_of_round": load_ms / median,
           "history_equal": hist_equal, "max_abs_param_dev": dev,
           "membership_equal": mem_equal, "local_flat_rows_equal": rows_equal,
           "acc": [r.weighted_acc for r in resumed.history.rounds]}
    emit(rec)
    if t != 2 or archives != ["ckpt_00000002.npz"]:
        raise AssertionError(f"resume {name}: resumed at {t} from "
                             f"{archives}")
    if not (hist_equal and dev == 0.0 and mem_equal
            and rows_equal is not False):
        raise AssertionError(f"resume {name}: the resumed run differs "
                             f"from the uninterrupted one: {rec}")
    return rec


def faults_run(torch, data, model) -> dict:
    """Phase 4f-ii: FedAvg with the quarantine, streamed (``prefetch=2``)
    under FAULTS_4F with a 0.3 s deadline and 4 chunks, RESUME_ROUNDS
    rounds. Fails unless 5 clients were killed and 3 corrupted, the
    deadline fired and dropped clients, round 2 quarantined a client, the
    parameters are finite, and the degraded cohort's H2D transfer is its
    staged rows' bytes (fewer than the slot's K rows). The run is traced
    by torch.profiler (``traced_h2d_bytes``): the transfer is the bytes of
    the copy stream's first three host-to-device copies (x, y, n of round
    0's claimed prefix; nothing is copied on that stream before). Prints
    round ms (under the profiler) and each cohort's stage ms, rows and
    tensor bytes."""
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    from repro_torch.fed.store import ArrayClientStore

    faults = FaultConfig({0: FaultSpec(straggle=2.0), 1: FaultSpec(kill=5),
                          2: FaultSpec(corrupt=3, corrupt_mode="nan")})
    pop = Population(ArrayClientStore(data), PopulationConfig(
        prefetch=2, faults=faults, deadline=0.3, stage_chunks=4))
    K = 20
    cfg = FedConfig(n_rounds=RESUME_ROUNDS, clients_per_round=K,
                    local_epochs=2, batch_size=10, lr=0.03, seed=0,
                    quarantine=True)
    tr = FedAvgTrainer(model, None, cfg, device="cuda", population=pop)
    cohorts = []
    next_cohort = pop.next_cohort

    def seen_cohort():
        c = next_cohort()
        cohorts.append({"t": c.t, "rows": len(c.idx),
                        "stage_ms": c.stage_ms, "h2d_bytes": sum(
                            v.numel() * v.element_size()
                            for v in (c.x, c.y, c.n))})
        return c

    pop.next_cohort = seen_cohort
    round_ms = []
    one_round = tr.round

    def timed_round(*a, **kw):
        t0 = time.perf_counter()
        m = one_round(*a, **kw)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        return m

    tr.round = timed_round
    trace = ROOT / "build" / "faults_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    out = []                                # one run: stats reset once
    copies = traced_h2d_bytes(
        torch, lambda: out.append(tr.run(RESUME_ROUNDS)), trace)
    rounds = out[0].rounds
    tr.close()
    # a cohort row: x float32, y and n int64
    row_bytes = (4 * int(np.prod(data.x_train.shape[1:]))
                 + 8 * data.y_train.shape[1] + 8)
    deg = cohorts[0]
    deg["h2d_transfer_bytes"] = sum(copies[:3])
    finite = all(bool(torch.isfinite(v).all()) for v in tr.params.values())
    rec = {"phase": "faults", "trainer": "fedavg", "quarantine": True,
           "prefetch": 2, "deadline_s": 0.3, "stage_chunks": 4,
           "faults": "0: straggle 2.0 s, 1: kill 5, 2: corrupt 3 nan",
           "stats": dict(pop.stats), "round_ms_profiled": round_ms,
           "cohorts": cohorts, "copy_stream_h2d_bytes": copies,
           "quarantined": [r.quarantined for r in rounds],
           "degraded_tensor_bytes": deg["h2d_bytes"],
           "degraded_h2d_transfer_bytes": deg["h2d_transfer_bytes"],
           "degraded_rows_bytes": deg["rows"] * row_bytes,
           "slot_bytes": K * row_bytes, "params_finite": finite,
           "acc": [r.weighted_acc for r in rounds]}
    emit(rec)
    st = pop.stats
    ok = (st["killed_clients"] == 5 and st["corrupted_clients"] == 3
          and st["deadline_rounds"] >= 1
          and st["deadline_dropped_clients"] >= 1
          and rounds[2].quarantined >= 1 and finite
          and deg["rows"] < K
          and deg["h2d_transfer_bytes"] == deg["rows"] * row_bytes)
    if not ok:
        raise AssertionError(f"faults: a gate failed: {rec}")
    return rec


def fault_tolerance_phase(torch, data, model) -> dict:
    """Phase 4f: kill-and-resume (FedGroup pinned, FeSEM streamed), then
    the faulted streamed run; returns the kernels' launch counts of the
    phase (FedGroup's two cold starts launch ``edc_cosine``)."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for name in ("fedgroup", "fesem"):
        resume_run(torch, data, model, name)
        torch.cuda.empty_cache()
    faults_run(torch, data, model)
    counts = ops.launch_counts()
    emit({"phase": "fault_tolerance", "launches": counts,
          "seconds": time.perf_counter() - t0})
    if counts["edc_cosine"] < 2:
        raise AssertionError("phase 4f's FedGroup runs launched no "
                             "edc_cosine kernel")
    return counts


def reference_check_faults(torch, data):
    """Phase 3, faults: a tiny FedGroup run with the quarantine, streamed
    (``prefetch=2``), clients killed in round 1 and NaN payloads in round
    2, no deadline (it depends on timing), on the CPU and on the card:
    ``stats`` equal, membership equal, loss and discrepancy within rtol
    1e-3, accuracy within 0.01, quarantined counts equal."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.engine import FedConfig
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    from repro_torch.fed.store import ArrayClientStore
    from repro_torch.models.paper_models import mlp

    cfg = FedConfig(n_rounds=3, clients_per_round=8, local_epochs=2,
                    batch_size=10, lr=0.05, n_groups=3, pretrain_scale=4,
                    seed=0, quarantine=True)
    faults = FaultConfig({1: FaultSpec(kill=3),
                          2: FaultSpec(corrupt=2, corrupt_mode="nan")})
    runs = {}
    for dev in ("cpu", "cuda"):
        pop = Population(ArrayClientStore(data), PopulationConfig(
            prefetch=2, faults=faults))
        tr = FedGroupTrainer(mlp(32, 16, 10), None, cfg, device=dev,
                             population=pop)
        runs[dev] = (tr.run(), tr.membership.copy(), dict(pop.stats))
        tr.close()
    (hc, mc, sc), (hg, mg, sg) = runs["cpu"], runs["cuda"]
    ok = bool((mc == mg).all()) and sc == sg
    for rc, rg in zip(hc.rounds, hg.rounds):
        ok &= math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
        ok &= math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
        ok &= abs(rc.weighted_acc - rg.weighted_acc) <= 0.01
        ok &= rc.quarantined == rg.quarantined
    emit({"phase": "reference", "faults": "fedgroup", "ok": ok,
          "stats": {"cpu": sc, "cuda": sg},
          "quarantined": [r.quarantined for r in hg.rounds],
          "cpu": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                  for r in hc.rounds],
          "cuda": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                   for r in hg.rounds]})
    if not ok:
        raise AssertionError("faults: card run disagrees with CPU")


def async_trainer(model, data, name: str, alpha: int = 20,
                  population=None, **kw):
    """Phase 4g's trainers at phase 4's width, ASYNC_ROUNDS rounds."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig

    cfg = FedConfig(n_rounds=ASYNC_ROUNDS, clients_per_round=20,
                    local_epochs=2, batch_size=10, lr=0.03, n_groups=5,
                    pretrain_scale=alpha, seed=0, **kw)
    args = dict(device="cuda", population=population)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, **args)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, **args)
    return strategies.make_trainer(name, model, data, cfg, **args)


def timed_async(torch, tr, rounds: int):
    """``tr.run(rounds)``: wall ms (host clock, ended by synchronize) and
    the ms between consecutive leases turning ready (``_wait_ready``
    returning True): the loop's round period."""
    ready = []
    wait = tr._wait_ready

    def stamped(lease):
        ok = wait(lease)
        if ok:
            ready.append(time.perf_counter())
        return ok

    tr._wait_ready = stamped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(rounds)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    tr._wait_ready = wait
    return wall, [float(v) for v in np.diff(ready) * 1e3]


def model_state(tr) -> dict:
    """The tensors a run must reproduce: params, group params, FeSEM's
    rows (pinned on the card, streamed from the host table)."""
    out = {f"params/{k}": v for k, v in tr.params.items()}
    out.update({f"group_params/{k}": v for k, v in
                (getattr(tr, "group_params", None) or {}).items()})
    if tr.population is not None:
        if tr.population.state._local_flat is not None:
            out["local_flat"] = tr.population.gather_local_flat(
                np.arange(tr.n_clients))
    elif getattr(tr, "local_flat", None) is not None:
        out["local_flat"] = tr.local_flat
    return out


def max_abs_dev(a: dict, b: dict) -> float:
    if sorted(a) != sorted(b):
        return float("inf")
    return max(float((x.double().cpu() - b[k].double().cpu()).abs().max())
               for k, x in a.items())


def same_membership(a, b) -> bool:
    return not hasattr(a, "membership") or bool(
        (a.membership == b.membership).all())


def async_equivalence(torch, data, model, name: str, streamed: bool):
    """Phase 4g-i: the equivalence mode (D = 1, α = 1, β = 0) against the
    synchronous path of the same seed: ``block_size=4`` pinned, per round
    streamed (``prefetch=2``). Fails unless the histories are equal,
    every parameter differs by 0, membership and FeSEM's rows are equal,
    every fold had staleness 0 and, pinned, every dispatch was a replay of
    the one captured graph and no eager round executor was built."""
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore

    def make(**kw):
        if not streamed:
            return async_trainer(model, data, name, **kw)
        pop = Population(ArrayClientStore(data), PopulationConfig(prefetch=2))
        return async_trainer(model, None, name, population=pop, **kw)

    sync = make(**({} if streamed else {"block_size": BLOCK_SIZE}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync.run(ASYNC_ROUNDS)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    asy = make(async_depth=1)
    wall, gaps = timed_async(torch, asy, ASYNC_ROUNDS)
    dev = max_abs_dev(model_state(sync), model_state(asy))
    hist_equal = asy.history.rounds == sync.history.rounds
    mem_equal = same_membership(sync, asy)
    sync.close()
    asy.close()
    st = dict(asy.history.async_stats)
    rec = {"phase": "async", "part": "equivalence", "trainer": name,
           "streamed": streamed, "rounds": ASYNC_ROUNDS, "depth": 1,
           "history_equal": hist_equal, "max_abs_param_dev": dev,
           "membership_equal": mem_equal, "async_stats": st,
           "sync_wall_ms": sync_ms, "async_wall_ms": wall,
           "async_round_ms": gaps,
           "acc": [r.weighted_acc for r in asy.history.rounds]}
    ok = (hist_equal and dev == 0.0 and mem_equal
          and st["staleness_hist"] == {"0": ASYNC_ROUNDS}
          and st["dispatches"] == st["folds"] == ASYNC_ROUNDS
          and st["max_in_flight"] == 1)
    if not streamed:
        ex = asy._async_exec
        rec.update(graph_replays=ex.replays, captures=ex.captures,
                   capture_ms=ex.capture_ms,
                   eager_round_executor_built=asy._round_exec is not None)
        ok &= (ex.replays == st["dispatches"] and ex.captures == 1
               and asy._round_exec is None)
    emit(rec)
    if not ok:
        raise AssertionError(f"async {name} (streamed={streamed}): D = 1 "
                             f"differs from the synchronous run: {rec}")


def async_depth_run(torch, data, model, name: str, alpha: int, depth: int,
                    blocked_ms) -> dict:
    """Phase 4g-ii: one pinned trainer at depth ``depth`` with α = 0.8,
    β = 0.5: round ms, wall ms, ``async_stats``, ``group_version``, a
    profiled window of 4 more rounds, peak memory. Fails on a non-finite
    metric or parameter, a fold count off the rounds, a window that never
    filled to ``depth``, or a dispatch that was not a replay."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = async_trainer(model, data, name, alpha=alpha, async_depth=depth,
                       **ASYNC_WEIGHTS)
    wall, gaps = timed_async(torch, tr, ASYNC_ROUNDS)
    peak = torch.cuda.max_memory_allocated()
    st = dict(tr.history.async_stats)
    prof = profile_window(torch, lambda: tr.run(4))
    launches = (prof["host_kernel_launches"] + prof["host_graph_launches"]
                + prof["host_copies"]) / 4
    ex = tr._async_exec
    rounds = tr.history.rounds
    rec = {"phase": "async", "part": "depth", "trainer": name,
           "alpha": alpha, "depth": depth, **ASYNC_WEIGHTS,
           "rounds": ASYNC_ROUNDS, "wall_ms": wall, "round_ms": gaps,
           # the last depth - 1 gaps are the window draining, not rounds
           "round_ms_median": float(np.median(gaps[:len(gaps) - depth + 1])),
           "blocked_round_ms_phase4d": blocked_ms,
           "async_stats": st, "group_version": tr.group_version.tolist(),
           "graph_replays": ex.replays, "captures": ex.captures,
           "capture_ms": ex.capture_ms, "peak_device_bytes": peak,
           "fold_window_profile": prof,
           "host_launch_calls_per_round": launches,
           "acc": [r.weighted_acc for r in rounds],
           "loss": [r.mean_loss for r in rounds]}
    emit(rec)
    finite = all(math.isfinite(r.mean_loss) and math.isfinite(r.discrepancy)
                 for r in rounds) and all(
        bool(torch.isfinite(v).all()) for v in model_state(tr).values())
    if not (finite and st["folds"] == ASYNC_ROUNDS
            and st["max_in_flight"] == depth
            and ex.replays == tr.history.async_stats["dispatches"]):
        raise AssertionError(f"async {name} D = {depth}: a gate failed: "
                             f"{rec}")
    return rec


def async_reference_check(torch):
    """Phase 4g-ii: FedGroup pinned and FedAvg streamed at D = 2 (α = 0.8,
    β = 0.5) on a small configuration (40 clients, mclr(16, 10), K = 8,
    E = 2) on the CPU and on the card with the same draws: labels,
    ``async_stats`` and ``group_version`` equal, loss and discrepancy
    within rtol 1e-3, accuracy within 0.01."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore
    from repro_torch.models.paper_models import mclr

    data = mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                    seed=0, async_depth=2, **ASYNC_WEIGHTS)
    for name in ("fedgroup", "fedavg"):
        runs = {}
        for dev in ("cpu", "cuda"):
            if name == "fedgroup":
                tr = FedGroupTrainer(mclr(16, 10), data, cfg, device=dev)
            else:
                pop = Population(ArrayClientStore(data), PopulationConfig(
                    prefetch=2, initial_active=30, arrival_rate=2.0))
                tr = FedAvgTrainer(mclr(16, 10), None, cfg, device=dev,
                                   population=pop)
            h = tr.run()
            tr.close()
            runs[dev] = (h, getattr(tr, "membership", None),
                         tr.group_version.tolist(), dict(h.async_stats))
        (hc, mc, vc, sc), (hg, mg, vg, sg) = runs["cpu"], runs["cuda"]
        ok = (mc is None or bool((mc == mg).all())) and vc == vg and sc == sg
        for rc, rg in zip(hc.rounds, hg.rounds, strict=True):
            ok &= math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
            ok &= math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
            ok &= abs(rc.weighted_acc - rg.weighted_acc) <= 0.01
        emit({"phase": "reference", "async": name, "depth": 2, "ok": ok,
              "streamed": name == "fedavg", "async_stats": sg,
              "group_version": {"cpu": vc, "cuda": vg},
              "cpu": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                      for r in hc.rounds],
              "cuda": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                       for r in hg.rounds]})
        if not ok:
            raise AssertionError(f"async {name}: card run at D = 2 "
                                 "disagrees with the CPU")


def async_expiry_run(torch, data, model) -> dict:
    """Phase 4g-iii: FedAvg pinned at D = 2, 6 rounds, a 0.5 s lease, the
    first lease scripted never to report ready: it expires, is requeued and
    folds later. Fails unless lease_expiries = requeues = 1, dispatches =
    folds + 1, the rounds are 0..5 in order and every dispatch replayed
    the graph."""
    tr = async_trainer(model, data, "fedavg", async_depth=2,
                       async_lease_timeout=0.5, async_backoff=0.01,
                       async_backoff_cap=0.02)
    real, doomed = tr._lease_ready, []

    def scripted(lease):
        if not doomed:
            doomed.append(lease)
        return False if lease is doomed[0] else real(lease)

    tr._lease_ready = scripted
    wall, gaps = timed_async(torch, tr, 6)
    st = dict(tr.history.async_stats)
    rec = {"phase": "async", "part": "expiry", "trainer": "fedavg",
           "depth": 2, "lease_timeout_s": 0.5, "async_stats": st,
           "rounds": [r.round for r in tr.history.rounds],
           "graph_replays": tr._async_exec.replays, "wall_ms": wall,
           "round_ms": gaps}
    emit(rec)
    if not (st["lease_expiries"] == st["requeues"] == 1
            and st["dispatches"] == st["folds"] + 1 == 7
            and rec["rounds"] == list(range(6))
            and rec["graph_replays"] == st["dispatches"]):
        raise AssertionError(f"async expiry: a gate failed: {rec}")
    return rec


def async_resume_run(torch, data, model, name: str) -> dict:
    """Phase 4g-iv: kill-and-resume mid-async at D = 2 (α = 0.8, β = 0.5),
    a checkpoint every 3 rounds into ``build/ckpt_async_<trainer>``:
    ASYNC_ROUNDS rounds uninterrupted; killed after 5 (the crossing at 3
    drains the window: the archive is t = 4); a fresh trainer loads it and
    runs the rest. FedGroup pinned, FeSEM streamed (RESUME_POP). Fails
    unless the histories, ``async_stats``, ``group_version`` and
    membership are equal and every parameter and row differs by 0."""
    import shutil

    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore

    ckpt = ROOT / "build" / f"ckpt_async_{name}"
    shutil.rmtree(ckpt, ignore_errors=True)

    def make(ckpt_dir):
        kw = dict(async_depth=2, checkpoint_every=3,
                  checkpoint_dir=str(ckpt_dir), **ASYNC_WEIGHTS)
        if name == "fedgroup":
            return async_trainer(model, data, name, **kw)
        pop = Population(ArrayClientStore(data), PopulationConfig(
            **RESUME_POP))
        return async_trainer(model, None, name, population=pop, **kw)

    ref = make(ckpt / "ref")
    ref.run(ASYNC_ROUNDS)
    ref.close()
    killed = make(ckpt / "kill")
    killed.run(5)
    killed.close()
    del killed
    resumed = make(ckpt / "kill")
    t = resumed.load_checkpoint(str(ckpt / "kill"))
    resumed.run(ASYNC_ROUNDS - t)
    resumed.close()
    dev = max_abs_dev(model_state(ref), model_state(resumed))
    rec = {"phase": "async", "part": "resume", "trainer": name,
           "streamed": ref.population is not None, "depth": 2,
           "killed_after": 5, "resumed_at": t,
           "history_equal": resumed.history.rounds == ref.history.rounds,
           "async_stats_equal": (dict(resumed.history.async_stats)
                                 == dict(ref.history.async_stats)),
           "group_version": {"ref": ref.group_version.tolist(),
                             "resumed": resumed.group_version.tolist()},
           "max_abs_param_dev": dev,
           "membership_equal": same_membership(ref, resumed),
           "async_stats": dict(resumed.history.async_stats)}
    emit(rec)
    if not (t == 4 and rec["history_equal"] and rec["async_stats_equal"]
            and dev == 0.0 and rec["membership_equal"]
            and rec["group_version"]["ref"]
            == rec["group_version"]["resumed"]):
        raise AssertionError(f"async resume {name}: a gate failed: {rec}")
    return rec


def async_phase(torch, data, model, blocked_ms: dict) -> dict:
    """Phase 4g; returns the kernels' launch counts of the phase
    (FedGroup's cold starts launch ``edc_cosine``)."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for name in ASYNC_EQ_PINNED:
        async_equivalence(torch, data, model, name, streamed=False)
        torch.cuda.empty_cache()
    for name in ASYNC_EQ_STREAMED:
        async_equivalence(torch, data, model, name, streamed=True)
        torch.cuda.empty_cache()
    for name, alpha in ASYNC_DEPTH_RUNS:
        for depth in ASYNC_DEPTHS:
            async_depth_run(torch, data, model, name, alpha, depth,
                            blocked_ms.get((name, alpha)))
            torch.cuda.empty_cache()
    async_reference_check(torch)
    async_expiry_run(torch, data, model)
    for name in ("fedgroup", "fesem"):
        async_resume_run(torch, data, model, name)
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    emit({"phase": "async_runtime", "launches": counts,
          "seconds": time.perf_counter() - t0})
    if counts["edc_cosine"] < 1:
        raise AssertionError("phase 4g's FedGroup runs launched no "
                             "edc_cosine kernel")
    return counts


# ---------------------------------------------------------------------------
# phase 4h: telemetry and the elastic control plane
# ---------------------------------------------------------------------------
def fleet_trainer(model, data, path: str, population=None, **kw):
    """Phase 4h's trainer: FedGroup (EDC) at α = 40 (every client a
    founder) on ``path`` ("round", "block" or "async2"), FLEET_ROUNDS
    rounds; FeSEM when streamed."""
    name = "fesem" if population is not None else "fedgroup"
    return async_trainer(model, data, name, alpha=FLEET_ALPHA,
                         population=population, **FLEET_PATHS[path], **kw)


def timed_run(torch, tr, path: str, run, rounds: int) -> dict:
    """One ``run(rounds)`` (the trainer's, or a coordinator's, which runs
    the trainer's loop), with the host ms of each unit of work: every
    ``round`` and ``_run_block`` call ended by synchronize (a block's ms
    over its rounds), or the gaps between leases turning ready (async).
    ``round_ms_median`` leaves out the cold-start round, the first block
    (its capture) and the async window's drain."""
    if path == "async2":
        wall, gaps = timed_async(torch, tr, rounds)
        steady = gaps[:len(gaps) - 1]
        return {"wall_ms": wall, "round_ms": gaps,
                "round_ms_median": float(np.median(steady))}
    units = []
    name = "_run_block" if path == "block" else "round"
    real = getattr(tr, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        b = len(args[1]) if path == "block" else 1
        units.append(((time.perf_counter() - t0) * 1e3, b))
        return out

    setattr(tr, name, timed)           # the instance's, ahead of the class's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run(rounds)
        torch.cuda.synchronize()
    finally:
        delattr(tr, name)
    wall = (time.perf_counter() - t0) * 1e3
    per_round = [ms / b for ms, b in units]
    return {"wall_ms": wall, "round_ms": per_round,
            "round_ms_median": float(np.median(per_round[1:]))}


def round_dispatches(tr) -> int:
    """Per-round executor calls a traced run made (its dispatch spans)."""
    return sum(1 for r in tr.obs.tracer.records()
               if r.kind == "dispatch" and r.attrs.get("exec") == "round")


def telemetry_run(torch, data, model, path: str) -> dict:
    """Phase 4h-i: FedGroup pinned on ``path`` without and with a
    telemetry dir. Fails unless the histories are equal, every parameter
    differs by 0, membership is equal, the dir passes the inspector's
    check and, blocked, the traced run replayed the one captured graph for
    every blocked round. Prints both median round ms, spans a round by
    kind, ``metrics.jsonl`` bytes and ``finalize`` ms."""
    import shutil

    from repro_torch.launch import inspect as tinspect

    tdir = ROOT / "build" / f"telemetry_{path}"
    shutil.rmtree(tdir, ignore_errors=True)
    off = fleet_trainer(model, data, path)
    t_off = timed_run(torch, off, path, off.run, FLEET_ROUNDS)
    on = fleet_trainer(model, data, path, telemetry_dir=str(tdir))
    t_on = timed_run(torch, on, path, on.run, FLEET_ROUNDS)
    t0 = time.perf_counter()
    on.obs.finalize(on._summary_extra())
    finalize_ms = (time.perf_counter() - t0) * 1e3
    dev = max_abs_dev(model_state(off), model_state(on))
    hist_equal = on.history.rounds == off.history.rounds
    mem_equal = same_membership(off, on)
    kinds = {}
    for r in on.obs.tracer.records():
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    errors = tinspect.check_dir(str(tdir))
    rec = {"phase": "telemetry", "trainer": "fedgroup", "alpha": FLEET_ALPHA,
           "path": path, "rounds": FLEET_ROUNDS, "history_equal": hist_equal,
           "max_abs_param_dev": dev, "membership_equal": mem_equal,
           "round_ms_median_off": t_off["round_ms_median"],
           "round_ms_median_on": t_on["round_ms_median"],
           "wall_ms_off": t_off["wall_ms"], "wall_ms_on": t_on["wall_ms"],
           "spans_per_round": {k: v / FLEET_ROUNDS
                               for k, v in sorted(kinds.items())},
           "metrics_jsonl_bytes": (tdir / "metrics.jsonl").stat().st_size,
           "trace_json_bytes": (tdir / "trace.json").stat().st_size,
           "finalize_ms": finalize_ms, "inspect_errors": errors}
    ok = hist_equal and dev == 0.0 and mem_equal and errors == []
    if path == "block":
        ex_on, ex_off = on._block_exec, off._block_exec
        blocked = FLEET_ROUNDS - round_dispatches(on)
        rec.update(graph_replays_on=ex_on.replays,
                   graph_replays_off=ex_off.replays, blocked_rounds=blocked,
                   captures_on=ex_on.captures)
        ok &= (ex_on.replays == ex_off.replays == blocked > 0
               and ex_on.captures == 1)
    if path == "async2":
        ex = on._async_exec
        rec.update(graph_replays_on=ex.replays,
                   async_stats=dict(on.history.async_stats))
        ok &= ex.replays == on.history.async_stats["dispatches"]
    emit(rec)
    if path == "round":
        emit(telemetry_profile(torch, on))
    off.close()
    on.close()
    if not ok:
        raise AssertionError(f"telemetry on {path}: a gate failed: {rec}")
    return rec


def telemetry_profile(torch, tr) -> dict:
    """Phase 4h-i: one ``Telemetry.profile()`` window of 2 more rounds
    with the spans annotated: each span kind found in the capture, its
    count, host ms, the device ms of the kernels launched under it, and
    the extent of its range on the device (first kernel to last, idle
    gaps included)."""
    from torch.autograd import DeviceType

    from repro_torch.obs.trace import SPAN_KINDS

    tr.obs.tracer.annotate = True
    with tr.obs.profile() as p:
        tr.run(2)
        torch.cuda.synchronize()
    tr.obs.tracer.annotate = False
    spans = {}
    for e in p.prof.events():
        if e.name not in SPAN_KINDS:
            continue
        s = spans.setdefault(e.name, {"count": 0, "host_ms": 0.0,
                                      "kernel_ms": 0.0,
                                      "device_extent_ms": 0.0})
        if e.device_type == DeviceType.CPU:
            # the range on the host, and the kernels launched inside it
            s["count"] += 1
            s["host_ms"] += e.cpu_time_total / 1e3
            s["kernel_ms"] += e.device_time_total / 1e3
        else:
            # the range's mirror on the device: first kernel to last
            s["device_extent_ms"] += e.device_time_total / 1e3
    if "dispatch" not in spans:
        raise AssertionError(f"the profile window shows no dispatch span: "
                             f"{sorted(spans)}")
    return {"phase": "telemetry", "part": "profile", "rounds": 2,
            "spans": spans, "trace": str(Path(p.log_dir).relative_to(ROOT))}


def fleet_equivalence(torch, data, model, path: str,
                      streamed: bool = False) -> dict:
    """Phase 4h-ii: ``Coordinator(trainer, FleetConfig(n_workers=1))``
    against ``trainer.run()``, FedGroup pinned on ``path`` or FeSEM
    streamed (``prefetch=2``). Fails unless histories, parameters (max
    |Δ| 0) and membership are equal, every dispatch went through the fleet
    and, blocked, the fleet-routed blocks were replays of one graph."""
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore
    from repro_torch.launch.coordinator import Coordinator, FleetConfig

    def make():
        if not streamed:
            return fleet_trainer(model, data, path)
        pop = Population(ArrayClientStore(data), PopulationConfig(prefetch=2))
        return fleet_trainer(model, None, path, population=pop)

    plain = make()
    t_plain = timed_run(torch, plain, path, plain.run, FLEET_ROUNDS)
    tr = make()
    coord = Coordinator(tr, FleetConfig(n_workers=1, **FLEET_CALM))
    t_fleet = timed_run(torch, tr, path, coord.run, FLEET_ROUNDS)
    dev = max_abs_dev(model_state(plain), model_state(tr))
    hist_equal = tr.history.rounds == plain.history.rounds
    mem_equal = same_membership(plain, tr)
    reg = tr.registry
    snap = {k: reg.get(k) for k in reg.names("fleet.")}
    rec = {"phase": "fleet", "part": "equivalence",
           "trainer": "fesem" if streamed else "fedgroup",
           "streamed": streamed, "path": path, "rounds": FLEET_ROUNDS,
           "history_equal": hist_equal, "max_abs_param_dev": dev,
           "membership_equal": mem_equal, "fleet": snap,
           "plain_round_ms_median": t_plain["round_ms_median"],
           "fleet_round_ms_median": t_fleet["round_ms_median"],
           "fleet_over_plain": (t_fleet["round_ms_median"]
                                / t_plain["round_ms_median"]),
           "plain_wall_ms": t_plain["wall_ms"],
           "fleet_wall_ms": t_fleet["wall_ms"]}
    ok = (hist_equal and dev == 0.0 and mem_equal
          and snap["fleet.jobs"] == snap["fleet.results"] > 0)
    if path in ("block", "async2"):
        ex = tr._block_exec if path == "block" else tr._async_exec
        ex_plain = plain._block_exec if path == "block" else \
            plain._async_exec
        rec.update(graph_replays=ex.replays, captures=ex.captures,
                   graph_replays_plain=ex_plain.replays)
        ok &= ex.replays == ex_plain.replays > 0 and ex.captures == 1
    coord.close()
    plain.close()
    emit(rec)
    if not ok:
        raise AssertionError(f"fleet of 1 on {path}: a gate failed: {rec}")
    return rec


def fleet_chaos(torch, data, model) -> dict:
    """Phase 4h-ii: two in-process workers, FedGroup pinned per round, the
    holder of dispatch 3 killed, then dispatch 4's result dropped, 5's
    duplicated and 6's held back. Fails unless the run equals the
    unfaulted one (histories, max |Δ| 0, membership) and each fault was
    counted. Prints ``fleet.*`` and the killed round's recovery ms over
    the median round."""
    from repro_torch.fed.population import FaultConfig, FaultSpec
    from repro_torch.launch.coordinator import Coordinator, FleetConfig

    faults = FaultConfig(rounds={3: FaultSpec(worker_kill=True),
                                 4: FaultSpec(msg_drop=True),
                                 5: FaultSpec(msg_dup=True),
                                 6: FaultSpec(msg_reorder=True)})
    plain = fleet_trainer(model, data, "round")
    plain.run()
    tr = fleet_trainer(model, data, "round")
    coord = Coordinator(tr, FleetConfig(n_workers=2, faults=faults,
                                        **FLEET_CHAOS))
    t = timed_run(torch, tr, "round", coord.run, FLEET_ROUNDS)
    dev = max_abs_dev(model_state(plain), model_state(tr))
    hist_equal = tr.history.rounds == plain.history.rounds
    mem_equal = same_membership(plain, tr)
    reg = tr.registry
    snap = {k: reg.get(k) for k in reg.names("fleet.")}
    coord.close()
    plain.close()
    ms = t["round_ms"]
    calm = float(np.median([m for i, m in enumerate(ms)
                            if i not in (0, 3, 4, 5, 6)]))
    window = FLEET_CHAOS["heartbeat_interval"] * FLEET_CHAOS["heartbeat_miss"]
    rec = {"phase": "fleet", "part": "chaos", "trainer": "fedgroup",
           "workers": 2, "faults": {"worker_kill": 3, "msg_drop": 4,
                                    "msg_dup": 5, "msg_reorder": 6},
           "history_equal": hist_equal, "max_abs_param_dev": dev,
           "membership_equal": mem_equal, "fleet": snap,
           "heartbeat_window_s": window, "round_ms": ms,
           "round_ms_median_unfaulted": calm,
           "kill_recovery_ms": ms[3] - calm,
           "drop_recovery_ms": ms[4] - calm}
    emit(rec)
    ok = (hist_equal and dev == 0.0 and mem_equal
          and snap["fleet.worker_deaths"] >= 1
          and snap["fleet.requeues"] >= 2
          and snap["fleet.msgs_dropped"] == snap["fleet.msgs_duplicated"]
          == snap["fleet.msgs_reordered"] == 1
          and snap["fleet.stale_results"] >= 1)
    if not ok:
        raise AssertionError(f"fleet chaos: a gate failed: {rec}")
    return rec


def fleet_worker_trainer(data=None, model=None, rounds: int = PROC_ROUNDS):
    """Phase 4h-iii's trainer (FedGroup, EDC, α = 40, phase 4's width,
    per round), also the process workers' replica (``fleet_worker_replica``):
    without ``data`` and ``model`` it makes phase 4's from seed 0, as every
    worker does."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import femnist_like
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mlp

    if data is None:
        data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    if model is None:
        model = mlp(784, 512, 26)
    cfg = FedConfig(n_rounds=rounds, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=5,
                    pretrain_scale=FLEET_ALPHA, seed=0)
    return FedGroupTrainer(model, data, cfg, device="cuda")


def fleet_worker_replica():
    """Phase 4h-iii's process workers' replica (``PROC_BUILDER``; a spawned
    worker inherits this process's ``sys.path``, ``src/`` included):
    ``fleet_worker_trainer`` on phase 4's data from seed 0, warmed up by a
    local solve of a cohort's 20 clients."""
    return warm_replica(fleet_worker_trainer(), 20)


def first_difference(a, b) -> dict | None:
    """The first round metric that differs between two histories."""
    for ra, rb in zip(a.history.rounds, b.history.rounds):
        for f in ("weighted_acc", "mean_loss", "discrepancy", "quarantined"):
            if getattr(ra, f) != getattr(rb, f):
                return {"round": ra.round, "metric": f,
                        "a": getattr(ra, f), "b": getattr(rb, f)}
    return None


def payload_bytes(tree) -> int:
    """Bytes of the numpy arrays in a nest of dicts, lists and tuples (a
    process worker's payload, ``launch.worker._to_numpy``'s output)."""
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(payload_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(payload_bytes(v) for v in tree)
    return 0


def proc_fleet_start(data, model, killed: bool):
    """Phase 4h-iii: a coordinator over two spawned workers (each its own
    CUDA context, its replica built by ``PROC_BUILDER``), killed or not;
    the workers start building at once."""
    from repro_torch.fed.population import FaultConfig, FaultSpec
    from repro_torch.launch import worker as worker_lib
    from repro_torch.launch.coordinator import Coordinator, FleetConfig

    faults = (FaultConfig(rounds={PROC_KILL_ROUND: FaultSpec(
        worker_kill=True)}) if killed else None)
    tr = fleet_worker_trainer(data, model)
    coord = Coordinator(tr, FleetConfig(
        n_workers=2, transport="proc", faults=faults,
        worker_spec=worker_lib.WorkerSpec(PROC_BUILDER, {}),
        heartbeat_interval=PROC_BEAT[0], heartbeat_miss=PROC_BEAT[1],
        lease_timeout=600.0, join_timeout=600.0))
    return tr, coord


def proc_fleet_run(torch, tr, coord, count_bytes: bool) -> tuple:
    """Phase 4h-iii: PROC_ROUNDS rounds through ``coord``'s workers:
    per-round ms, ``fleet.*``, the model state and, with ``count_bytes``,
    the numpy payload's bytes each way a dispatch."""
    from repro_torch.launch import worker as worker_lib

    sent, received = [], []
    if count_bytes:
        real = coord._dispatch

        def counted(fn_name, args, remote):
            sent.append(payload_bytes(worker_lib._to_numpy(args)))
            out = real(fn_name, args, remote)
            received.append(payload_bytes(worker_lib._to_numpy(out)))
            return out

        coord._dispatch = counted
    try:
        t = timed_run(torch, tr, "round", coord.run, PROC_ROUNDS)
        reg = tr.registry
        snap = {k: reg.get(k) for k in reg.names("fleet.")}
        state = {k: v.detach().clone() for k, v in model_state(tr).items()}
    finally:
        coord.close()
    return state, snap, t["round_ms"], sent, received


def proc_fleet(torch, data, model) -> dict:
    """Phase 4h-iii: FedGroup pinned per round, PROC_ROUNDS rounds through
    two spawned workers, unkilled and with the holder of round
    PROC_KILL_ROUND's dispatch SIGKILLed (both fleets' four workers built
    at once). Fails unless the killed run equals the unkilled one exactly
    (histories, max |Δ| 0, membership) and the death was detected and
    recovered. Prints the deviation of the process runs from the
    in-process run (expected 0; else the first metric that differs), the
    spawn and replica-build s (a replica's build runs one local solve: the
    process's first use of the card), each worker's first job and the
    later rounds' ms, payload bytes each
    way a dispatch and the kill's recovery ms."""
    plain = fleet_worker_trainer(data, model)
    plain.run()
    plain_state = model_state(plain)
    t0 = time.perf_counter()
    fleets = [proc_fleet_start(data, model, killed) for killed in (0, 1)]
    end = time.monotonic() + 600.0
    while any(len(c._live) < 2 for _, c in fleets):
        if time.monotonic() > end:
            raise AssertionError("process workers did not join")
        for _, c in fleets:
            c._pump(0.02)
    spawn_s = time.perf_counter() - t0
    (clean, c_clean), (kill, c_kill) = fleets
    clean_state, _, ms_clean, _, _ = proc_fleet_run(torch, clean, c_clean,
                                                    False)
    kill_state, snap, ms, sent, recv = proc_fleet_run(torch, kill, c_kill,
                                                      True)
    dev = max_abs_dev(clean_state, kill_state)
    hist_equal = kill.history.rounds == clean.history.rounds
    mem_equal = same_membership(clean, kill)
    dev_inproc = max_abs_dev(plain_state, kill_state)
    # rounds 0 and 1 are each worker's first job (warmed at build, yet
    # slower); the killed round's requeue lands on the other worker
    calm = [m for i, m in enumerate(ms) if i >= 2 and i != PROC_KILL_ROUND]
    rec = {"phase": "fleet", "part": "process", "trainer": "fedgroup",
           "workers": 2, "rounds": PROC_ROUNDS,
           "killed_round": PROC_KILL_ROUND, "history_equal": hist_equal,
           "max_abs_param_dev_killed_vs_unkilled": dev,
           "membership_equal": mem_equal,
           "max_abs_param_dev_vs_inprocess": dev_inproc,
           "first_metric_differing_from_inprocess": first_difference(
               plain, kill),
           "fleet": snap, "spawn_and_build_s_4_workers": spawn_s,
           "first_job_ms_unkilled": ms_clean[:2],
           "first_job_ms_killed": ms[:2],
           "round_ms_unkilled": ms_clean, "round_ms_killed": ms,
           "round_ms_median_warm_unkilled": float(np.median(ms_clean[2:])),
           "payload_bytes_sent": sent, "payload_bytes_received": recv,
           "heartbeat_window_s": PROC_BEAT[0] * PROC_BEAT[1],
           "kill_recovery_ms": ms[PROC_KILL_ROUND] - float(np.median(calm))}
    emit(rec)
    plain.close()
    ok = (hist_equal and dev == 0.0 and mem_equal
          and snap["fleet.worker_deaths"] == 1
          and snap["fleet.requeues"] >= 1 and snap["fleet.workers"] == 1)
    if not ok:
        raise AssertionError(f"process fleet: a gate failed: {rec}")
    return rec


def fleet_phase(torch, data, model) -> dict:
    """Phase 4h; returns the kernels' launch counts of the phase
    (FedGroup's cold starts launch ``edc_cosine``; the process workers run
    only the round executor)."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for path in FLEET_PATHS:
        telemetry_run(torch, data, model, path)
        torch.cuda.empty_cache()
    for path in FLEET_PATHS:
        fleet_equivalence(torch, data, model, path)
        torch.cuda.empty_cache()
    fleet_equivalence(torch, data, model, "round", streamed=True)
    fleet_chaos(torch, data, model)
    torch.cuda.empty_cache()
    proc_fleet(torch, data, model)
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    emit({"phase": "fleet_phase", "launches": counts,
          "seconds": time.perf_counter() - t0})
    if counts["edc_cosine"] < 1:
        raise AssertionError("phase 4h's FedGroup runs launched no "
                             "edc_cosine kernel")
    return counts


# ---------------------------------------------------------------------------
# Phase 4i: the client axis over torch.distributed ranks (a data mesh)
# ---------------------------------------------------------------------------

def mesh_trainer(model, data, mesh, alpha: int = 20, block_size: int = 1,
                 population=None, framework: str = "fedgroup"):
    """FedGroup (EDC), FedAvg or IFCA at phase 4's width on ``mesh``
    (None: one device)."""
    from repro_torch.fed import strategies
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig

    cfg = FedConfig(n_rounds=MESH_ROUNDS, clients_per_round=20,
                    local_epochs=2, batch_size=10, lr=0.03, n_groups=5,
                    pretrain_scale=alpha, measure="edc", seed=0,
                    block_size=block_size)
    kw = dict(device="cuda", mesh=mesh, population=population)
    if framework == "fedavg":
        return FedAvgTrainer(model, data, cfg, **kw)
    return strategies.make_trainer(
        "static" if framework == "fedgroup" else framework, model, data,
        cfg, **kw)


def mesh_run(torch, model, data, mesh, path: str, population=None) -> dict:
    """One phase-4i run on ``path``: "fedavg" / "ifca", FedAvg's / IFCA's
    first round from the initial parameters (the ranks' inputs equal one
    device's, so their round differs by the card's rounding alone; IFCA's
    has m = 5 groups and its assignment stage); "round", FedGroup's Alg.
    3 cold start, then MESH_ROUNDS rounds (α = 20); "block", the same at α
    = 40 (every client a founder) in blocks of MESH_BLOCK; "stream", as
    "round" through ``population``. Host clock ended by synchronize; a
    blocked run then times one more block (``block_round_ms_steady``).
    Returns the run's record and its state (CPU copies) for comparison."""
    from repro_torch.kernels import ops

    alpha, bs = (40, MESH_BLOCK) if path == "block" else (20, 1)
    first = path in MESH_FIRST
    tr = mesh_trainer(model, data, mesh, alpha, bs, population,
                      path if first else "fedgroup")
    h2d = []
    if population is not None:
        nxt = population.next_cohort

        def seen():
            c = nxt()
            h2d.append({"xy": c.x.nbytes + c.y.nbytes, "n": c.n.nbytes,
                        "rows": int(c.x.shape[0]), "cohort": len(c.idx)})
            return c
        population.next_cohort = seen
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pre_idx, labels, cold_ms = [], [], None
    if not first:
        t0 = time.perf_counter()
        pre_idx, labels = tr.group_cold_start()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
    round_ms = []
    rounds = 1 if first else MESH_ROUNDS
    for _ in range(1 if path == "block" else rounds):
        t1 = time.perf_counter()
        tr.run(rounds if path == "block" else 1)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
    if path == "block":
        round_ms = [round_ms[0] / rounds]      # the run's rounds, averaged
    counts = {**ops.launch_counts(), **ops.partial_launch_counts()}
    blk = tr._block_exec
    params = tr.params if path == "fedavg" else tr.group_params
    state = {f"params/{k}": v.detach().cpu().clone()
             for k, v in params.items()}
    if not first:
        state["group_delta"] = tr.group_delta.detach().cpu().clone()
    rec = {"path": path, "alpha": alpha, "cold_ms": cold_ms,
           "round_ms": round_ms, "block_round_ms_steady": None,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts,
           "replays": 0 if blk is None else blk.replays,
           "labels": [int(x) for x in labels],
           "pre_idx": [int(x) for x in pre_idx],
           "membership": [int(x) for x in getattr(tr, "membership", [])],
           "hist": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                    for r in tr.history.rounds],
           "h2d": h2d}
    if path == "block":
        # one more block after the compared run: its rounds' ms, no capture
        # in it (the graphs exist; gloo runs it eagerly)
        t1 = time.perf_counter()
        tr.run(MESH_BLOCK)
        torch.cuda.synchronize()
        rec["block_round_ms_steady"] = ((time.perf_counter() - t1) * 1e3
                                        / MESH_BLOCK)
    tr.close()
    return rec, state


def mesh_compare(ref: dict, ref_state: dict, got: dict, got_state: dict,
                 hold: str) -> dict:
    """``got`` against ``ref``: labels, founders and membership equal; each
    history column's largest deviation (accuracy and discrepancy absolute
    and relative, loss relative); each parameter leaf's relative Frobenius
    distance. ``hold``: "exact" (all 0, max |Δ| too), "tight" (the CPU
    mesh tests' tolerances: accuracy MESH_ACC_ATOL, loss and discrepancy
    MESH_RTOL, leaves MESH_LEAF_RTOL) or "reference" (the reference's own
    bound of a sharded run, ``tests/test_trainer_sharding.py``: accuracy and
    discrepancy within MESH_ACC_ATOL absolute;
    the loss and leaves reported)."""
    same = {k: got[k] == ref[k] for k in ("labels", "pre_idx", "membership")}
    h, hr = np.asarray(got["hist"]), np.asarray(ref["hist"])
    dev = {"acc": float(np.nanmax(np.abs(h[:, 0] - hr[:, 0]))),
           "disc_abs": float(np.max(np.abs(h[:, 2] - hr[:, 2]))),
           "loss": float(np.max(np.abs(h[:, 1] - hr[:, 1]) / np.abs(hr[:, 1]))),
           "disc": float(np.max(np.abs(h[:, 2] - hr[:, 2]) / np.abs(hr[:, 2])))}
    leaf = {k: float((got_state[k] - v).norm() / v.norm())
            for k, v in ref_state.items()}
    max_abs = max(float((got_state[k] - v).abs().max())
                  for k, v in ref_state.items())
    ok = all(same.values()) and h.shape == hr.shape
    if hold == "exact":
        ok = ok and max_abs == 0.0 and max(dev.values()) == 0.0
    elif hold == "tight":
        ok = (ok and dev["acc"] <= MESH_ACC_ATOL
              and max(dev["loss"], dev["disc"]) <= MESH_RTOL
              and max(leaf.values()) <= MESH_LEAF_RTOL)
    else:
        ok = ok and max(dev["acc"], dev["disc_abs"]) <= MESH_ACC_ATOL
    return {"hold": hold, "equal": same, "max_dev": dev, "leaf_rel_fro": leaf,
            "leaf_rel_fro_max": max(leaf.values()), "max_abs_dev": max_abs,
            "ok": ok}


def mesh_warmup(torch, mesh):
    """A small FedGroup run on ``mesh`` (the Alg. 3 cold start, a round
    and a block): a fresh process's first cuBLAS, cuSOLVER, torch.func and
    collective calls, kept out of the timed runs."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mclr

    data = mnist_like(seed=0, n_clients=16, classes_per_client=2,
                      total_train=1200, dim=16)
    cfg = FedConfig(clients_per_round=8, local_epochs=1, batch_size=10,
                    lr=0.05, n_groups=2, pretrain_scale=8, seed=0,
                    block_size=2)
    tr = FedGroupTrainer(mclr(16, 10), data, cfg, device="cuda", mesh=mesh)
    tr.run(3)
    torch.cuda.synchronize()
    tr.close()


# The modules a rank imports, loaded once by the fork server the ranks
# start from (no CUDA is initialised there): ``import torch`` alone takes
# ~10 s on the card's host
RANK_PRELOAD = ("numpy", "torch", "torch.distributed", "repro_torch",
                "repro_torch.core.fedgroup", "repro_torch.data.generators",
                "repro_torch.fed.engine", "repro_torch.fed.population",
                "repro_torch.launch.coordinator", "repro_torch.launch.mesh",
                "repro_torch.models.paper_models")
RANK_CTX: list = []             # the fork-server context, made at first use
LIVE_RANKS: list = []           # every rank started, killed on the way out
SPAWN_S: dict = {}              # a lane job's (run s, resume s)


def rank_context():
    """The multiprocessing context every spawned rank starts from: a fork
    server that imported RANK_PRELOAD once, so a rank is a fork of it (a
    process of its own, with its own CUDA context) instead of a fresh
    interpreter."""
    import multiprocessing as mp

    if not RANK_CTX:
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(list(RANK_PRELOAD))
        RANK_CTX.append(ctx)
    return RANK_CTX[0]


def rank_entry(fn: str, log: str, *args):
    """A spawned rank's body: its stdout and stderr to ``log``, then this
    script's ``fn(*args)``, whose return is the rank's exit code."""
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    sys.exit(globals()[fn](*args))


def run_ranks(fn: str, world: int, d: Path, store: str, extra: tuple,
              timeout: float, rc: int, what: str) -> None:
    """Start ``world`` ranks, rank r running ``fn(r, world, d/store,
    d/rank<r>, *extra)``, and wait for all: each must exit ``rc``. Any
    other exit, or a rank still running after ``timeout`` s, fails
    ``what``: every rank still running is killed and each rank's log tail
    goes to stderr."""
    ctx = rank_context()
    logs = [d / f"rank{r}.{store}.log" for r in range(world)]
    procs = [ctx.Process(target=rank_entry, args=(
        fn, str(logs[r]), r, world, str(d / store), str(d / f"rank{r}"),
        *extra)) for r in range(world)]
    for p in procs:
        p.start()
        LIVE_RANKS.append(p)
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    rcs = [p.exitcode for p in procs]
    if rcs != [rc] * world:
        for r, log in enumerate(logs):
            tail = (log.read_text(errors="replace")[-4000:]
                    if log.exists() else "")
            print(f"--- {what} rank {r} (exit {rcs[r]}):\n{tail}",
                  file=sys.stderr)
        raise AssertionError(f"{what}: rank exit codes {rcs}")


def kill_live_ranks() -> None:
    for p in LIVE_RANKS:
        if p.is_alive():
            p.kill()
            p.join()


def child_entry(fn: str, d: str, *args):
    """A forked phase's body: stdout (its JSON lines) to ``d``/out.jsonl,
    stderr to ``d``/err.log, then this script's ``fn(*args)``, whose
    return goes to ``d``/result.pt."""
    import torch

    for fd, name in ((1, "out.jsonl"), (2, "err.log")):
        f = os.open(f"{d}/{name}", os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                    0o644)
        os.dup2(f, fd)
        os.close(f)
    torch.save(globals()[fn](*args), f"{d}/result.pt")
    sys.exit(0)


def start_child(fn: str, name: str, *args):
    """Start ``fn(*args)`` as a fork of the ranks' fork server (a process
    of its own, with its own CUDA context) in ``build/child_<name>``."""
    d = ROOT / "build" / f"child_{name}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    p = rank_context().Process(target=child_entry, args=(fn, str(d), *args))
    p.start()
    LIVE_RANKS.append(p)
    return p, d


def join_child(torch, child, timeout: float, what: str):
    """Wait for ``start_child``'s process (killed past ``timeout`` s), emit
    its JSON lines here in their order, copy its stderr (its own clock
    among it) to this process's, and return its result; fail ``what`` on
    any exit but 0."""
    p, d = child
    p.join(timeout)
    if p.is_alive():
        p.kill()
        p.join()
    out = d / "out.jsonl"
    for line in (out.read_text().splitlines() if out.exists() else []):
        try:
            emit(json.loads(line))
        except ValueError:
            print(line, file=sys.stderr)
    err = d / "err.log"
    if err.exists():
        sys.stderr.write(f"--- {what} (exit {p.exitcode}), its stderr:\n"
                         + err.read_text(errors="replace"))
        sys.stderr.flush()
    if p.exitcode != 0:
        raise AssertionError(f"{what}: exit code {p.exitcode}")
    return torch.load(d / "result.pt", weights_only=False)


class Lane(threading.Thread):
    """The mesh phases' spawned ranks (4j, 4k, 4l, 4m, 4i-ii, 4i-iv), one job
    after another on a thread of this process, while this process goes on
    with the phases that need the card little beside them. A job's records
    stay in its directory under ``build/`` for its phase's checks, which
    run in this process after ``wait``; a job is skipped once one failed."""

    def __init__(self, jobs: list):
        super().__init__(daemon=True)
        self.jobs = jobs
        self.done = {name: threading.Event() for name, _ in jobs}
        self.seconds, self.error = {}, None

    def run(self):
        for name, job in self.jobs:
            try:
                if self.error is None:
                    t0 = time.perf_counter()
                    job()
                    self.seconds[name] = time.perf_counter() - t0
            except BaseException as e:          # noqa: BLE001 (re-raised)
                self.error = (name, e)
            finally:
                self.done[name].set()

    def wait(self, name: str) -> float:
        """Block until job ``name`` is over; its seconds, or raise if it
        (or a job before it) failed."""
        self.done[name].wait()
        if self.error is not None:
            raise AssertionError(f"mesh lane job {self.error[0]} failed: "
                                 f"{self.error[1]}") from self.error[1]
        return self.seconds[name]


def mesh_rank_main(rank: int, world: int, store: str, out: str,
                   local_world: int) -> int:
    """A phase-4i rank (run in a process of its own): joins the world
    through the FileStore at ``store`` with the backend ``launch.mesh``
    picks for ``local_world`` ranks on this host's cards, warms up, runs
    MESH_PATHS (streamed through a ``ShardedClientStore`` of ``world``
    shards) and writes its records to ``out``.json and its state to
    ``out``.pt."""
    import torch

    from repro_torch.data.generators import femnist_like
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.paper_models import mlp

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=local_world)
    try:
        mesh = mesh_lib.make_fed_mesh(world)
        t0 = time.perf_counter()
        mesh_warmup(torch, mesh)
        recs, states = {"warmup_s": time.perf_counter() - t0}, {}
        data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
        model = mlp(784, 512, 26)
        for path in MESH_PATHS:
            pop = None
            if path == "stream":
                pop = Population(ShardedClientStore(ArrayClientStore(data),
                                                    world),
                                 PopulationConfig(prefetch=2))
            recs[path], states[path] = mesh_run(
                torch, model, None if pop else data, mesh, path, pop)
        recs["backend"], recs["device"] = mesh.backend, str(mesh.device)
        Path(out + ".json").write_text(json.dumps(recs))
        torch.save(states, out + ".pt")
    finally:
        mesh_lib.destroy_process_group()
    return 0


def mesh_ranks(world: int, local_world: int, tag: str) -> None:
    """Run ``world`` phase-4i ranks (each its own process and CUDA context;
    the kernels were built by this process already, so the ranks only
    load the library) in ``build/mesh_<tag>``: any rank's failure fails
    the phase (``run_ranks``)."""
    d = ROOT / "build" / f"mesh_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    run_ranks("mesh_rank_main", world, d, "store", (local_world,),
              MESH_TIMEOUT_S, 0, f"phase 4i {tag}")


def mesh_ranks_out(torch, world: int, tag: str) -> list:
    """Each phase-4i rank's (records, state) from ``build/mesh_<tag>``."""
    d = ROOT / "build" / f"mesh_{tag}"
    return [(json.loads((d / f"rank{r}.json").read_text()),
             torch.load(d / f"rank{r}.pt")) for r in range(world)]


def mesh_check_ranks(torch, tag: str, ranks: list, ref: dict,
                     ref_state: dict) -> int:
    """Phase 4i-ii / iii: each rank against the run of one device (FedAvg's
    first round at the CPU tests' tolerances, FedGroup's runs at the
    reference's own bound: ``mesh_compare``), the ranks' replicas bit for
    bit, each rank's ``edc_cosine`` launches, the streamed cohort's H2D
    bytes a rank (x and y: one device's over the world), graph replays (0
    over gloo). Emits a record per path; returns the ranks' ``edc_cosine``
    launches."""
    launches = 0
    world = len(ranks)
    gloo = ranks[0][0]["backend"] == "gloo"
    for path in MESH_PATHS:
        rows = []
        for r, (recs, states) in enumerate(ranks):
            cmp = mesh_compare(ref[path], ref_state[path], recs[path],
                               states[path],
                               "tight" if path in MESH_FIRST else "reference")
            rows.append({"rank": r, **cmp,
                         "cold_ms": recs[path]["cold_ms"],
                         "round_ms": recs[path]["round_ms"],
                         "block_round_ms_steady":
                             recs[path]["block_round_ms_steady"],
                         "edc_cosine": recs[path]["launches"]["edc_cosine"],
                         "replays": recs[path]["replays"]})
            launches += recs[path]["launches"]["edc_cosine"]
        replicas = all(
            recs[path][k] == ranks[0][0][path][k]
            for recs, _ in ranks[1:] for k in ("labels", "membership", "hist"))
        replicas = replicas and all(
            torch.equal(states[path][k], ranks[0][1][path][k])
            for _, states in ranks[1:] for k in states[path])
        rec = {"phase": "mesh", "part": tag, "path": path, "world": world,
               "backend": ranks[0][0]["backend"],
               "devices": [recs["device"] for recs, _ in ranks],
               "warmup_s": [recs["warmup_s"] for recs, _ in ranks],
               "ranks": rows, "replicas_equal": replicas,
               "world1_cold_ms": ref[path]["cold_ms"],
               "world1_round_ms": ref[path]["round_ms"],
               "world1_block_round_ms_steady":
                   ref[path]["block_round_ms_steady"],
               "world1_replays": ref[path]["replays"],
               "hist": ranks[0][0][path]["hist"],
               "world1_hist": ref[path]["hist"],
               "tolerances": {"acc": MESH_ACC_ATOL, "rtol": MESH_RTOL,
                              "leaf_rel_fro": MESH_LEAF_RTOL}}
        if path == "stream":
            rec["h2d_per_cohort"] = [recs[path]["h2d"] for recs, _ in ranks]
            rec["world1_h2d_per_cohort"] = ref[path]["h2d"]
            share = all(c["xy"] * world == w["xy"] and c["n"] == w["n"]
                        for recs, _ in ranks
                        for c, w in zip(recs[path]["h2d"], ref[path]["h2d"],
                                        strict=True))
            rec["xy_bytes_a_rank_are_world1_over_world"] = share
            if not share:
                raise AssertionError(f"phase 4i {tag}: a rank's streamed "
                                     "cohort is not its share")
        emit(rec)
        if not all(x["ok"] for x in rows):
            raise AssertionError(f"phase 4i {tag} {path}: a rank differs "
                                 "from the run of one device")
        if not replicas:
            raise AssertionError(f"phase 4i {tag} {path}: the ranks' "
                                 "replicas differ")
        if path not in MESH_FIRST and any(x["edc_cosine"] < 1 for x in rows):
            raise AssertionError(f"phase 4i {tag} {path}: a rank launched "
                                 "no edc_cosine")
        if path == "block" and any(
                x["replays"] != (0 if gloo else MESH_ROUNDS - 1)
                for x in rows):
            raise AssertionError(f"phase 4i {tag}: block replays "
                                 f"{[x['replays'] for x in rows]}")
    return launches


# phase 4i's runs of one device that phase 4j holds its ranks to, and
# phase 6e's cold start of one device: {path or "coldstart": ...}
MESH2D_REF = {}


def mesh_refs(torch, data, model) -> dict:
    """Phase 4i-i in this process (an NCCL world of one against
    mesh=None) and the runs of one device the ranks are held to ->
    {"ref", "ref_state", "counts" (launches), "seconds"}."""
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # 4i-i: an NCCL world of one in this process, against mesh=None
    store = ROOT / "build" / "mesh_nccl1_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    ref, ref_state = {}, {}
    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=0, world_size=1, local_rank=0,
                                local_world=1)
    try:
        mesh = mesh_lib.make_fed_mesh(1)
        for path in MESH_FIRST + ("round", "block"):
            ref[path], ref_state[path] = mesh_run(torch, model, data, None,
                                                  path)
            got, got_state = mesh_run(torch, model, data, mesh, path)
            add(got["launches"])
            cmp = mesh_compare(ref[path], ref_state[path], got, got_state,
                               "exact")
            rec = {"phase": "mesh", "part": "nccl_world_of_one",
                   "path": path, "backend": mesh.backend, **cmp,
                   "cold_ms": got["cold_ms"], "round_ms": got["round_ms"],
                   "none_cold_ms": ref[path]["cold_ms"],
                   "none_round_ms": ref[path]["round_ms"],
                   "block_round_ms_steady": got["block_round_ms_steady"],
                   "none_block_round_ms_steady":
                       ref[path]["block_round_ms_steady"],
                   "replays": got["replays"],
                   "none_replays": ref[path]["replays"],
                   "launches": got["launches"]}
            emit(rec)
            if mesh.backend != "nccl" or not cmp["ok"]:
                raise AssertionError(f"phase 4i-i {path}: a mesh of one "
                                     f"differs from mesh=None: {cmp}")
            if path == "block" and not (
                    got["replays"] == ref[path]["replays"]
                    == MESH_ROUNDS - 1):
                raise AssertionError("phase 4i-i: block replays "
                                     f"{got['replays']}")
    finally:
        mesh_lib.destroy_process_group()
    torch.cuda.empty_cache()

    # world 1 streamed, the reference of the ranks' streamed runs
    pop = Population(ShardedClientStore(ArrayClientStore(data), 1),
                     PopulationConfig(prefetch=2))
    ref["stream"], ref_state["stream"] = mesh_run(torch, model, None, None,
                                                  "stream", pop)
    MESH2D_REF.update({p: (ref[p], ref_state[p]) for p in MESH2D_PATHS})
    return {"ref": ref, "ref_state": ref_state, "counts": counts,
            "seconds": time.perf_counter() - t0}


def mesh_phase(torch, refs: dict, lane: Lane) -> dict:
    """Phase 4i: the ranks held to ``refs`` (``mesh_refs``); returns the
    kernels' launch counts of the phase (this process's world-of-one runs
    and, as ``edc_cosine``, every rank's)."""
    t0 = time.perf_counter()
    ref, ref_state, counts = refs["ref"], refs["ref_state"], refs["counts"]
    # 4i-ii: two ranks sharing the card over gloo (run on the lane)
    ranks_s = lane.wait("mesh_gloo2")
    ranks = mesh_ranks_out(torch, 2, "gloo2")
    counts["edc_cosine"] = counts.get("edc_cosine", 0) + mesh_check_ranks(
        torch, "gloo_two_ranks_one_card", ranks, ref, ref_state)

    # 4i-iii: one rank a card over NCCL, where the machine has the cards
    n = torch.cuda.device_count()
    if n >= 2:
        mesh_ranks(2, 2, "nccl2")
        ranks = mesh_ranks_out(torch, 2, "nccl2")
        counts["edc_cosine"] += mesh_check_ranks(
            torch, "nccl_rank_a_card", ranks, ref, ref_state)
    else:
        emit({"phase": "mesh", "part": "nccl_rank_a_card", "skipped":
              f"this machine has {n} card: NCCL takes one rank a card"})
    emit({"phase": "mesh_phase", "launches": counts, "ranks_s": ranks_s,
          "seconds": refs["seconds"] + time.perf_counter() - t0})
    return counts


# ---------------------------------------------------------------------------
# Phase 4i-iv: the runtime services on the data mesh
# ---------------------------------------------------------------------------

def svc_trainer(model, data, mesh, alpha: int = 40, population=None, **over):
    """Phase 4i-iv's FedGroup (EDC) at phase 4's width on ``mesh`` (None:
    one device), SVC_ROUNDS rounds; α = 40 makes every client a founder
    (no newcomer breaks a block)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.engine import FedConfig

    cfg = FedConfig(n_rounds=SVC_ROUNDS, clients_per_round=20,
                    local_epochs=2, batch_size=10, lr=0.03, n_groups=5,
                    pretrain_scale=alpha, measure="edc", seed=0, **over)
    return FedGroupTrainer(model, None if population is not None else data,
                           cfg, device="cuda", mesh=mesh,
                           population=population)


def svc_state(torch, tr) -> dict:
    """CPU copies of what a services run must reproduce: the model state,
    the group directions, membership, the history."""
    out = {k: v.detach().cpu().clone() for k, v in model_state(tr).items()}
    out["group_delta"] = tr.group_delta.detach().cpu().clone()
    out["membership"] = torch.as_tensor(np.asarray(tr.membership).copy())
    out["hist"] = torch.tensor([[r.round, r.weighted_acc, r.mean_loss,
                                 r.discrepancy, r.quarantined]
                                for r in tr.history.rounds],
                               dtype=torch.float64)
    return out


def svc_same(a: dict, b: dict) -> bool:
    """Bit for bit (NaN and -0.0 included)."""
    return sorted(a) == sorted(b) and all(
        a[k].shape == b[k].shape and a[k].numpy().tobytes()
        == b[k].numpy().tobytes() for k in a)


def svc_dir(name: str) -> Path:
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def svc_timed(torch, tr, rounds: int):
    """``tr.run(rounds)`` ended by a synchronize -> (state, round ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(rounds)
    torch.cuda.synchronize()
    return svc_state(torch, tr), (time.perf_counter() - t0) * 1e3 / rounds


def svc_nccl1(torch, data, model, smi: str) -> dict:
    """Phase 4i-iv in this process on an NCCL world of one: save and load
    with resume bit-equal, telemetry on equal to off, async D = 1 equal to
    the synchronous (blocked) run, D = 2's round ms, a fleet of one equal
    to ``run()`` per round and in blocks. Every blocked round and every
    dispatch is a replay of a captured graph with the NCCL all-reduces
    inside. Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.coordinator import Coordinator, FleetConfig
    from repro_torch.launch.inspect import check_dir

    store = svc_dir("svc_nccl1") / "store"
    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=0, world_size=1, local_rank=0,
                                local_world=1)
    ops.reset_launch_counts()
    try:
        mesh = mesh_lib.make_fed_mesh(1)
        base = {"phase": "services", "world": 1, "backend": mesh.backend,
                "nvidia_smi": smi}
        if mesh.backend != "nccl":
            raise AssertionError(f"phase 4i-iv: backend {mesh.backend}")
        # the synchronous reference: α = 40 in blocks of 4 (round 0 runs
        # the cold start per round, rounds 1-3 one block of replays)
        tr = svc_trainer(model, data, mesh, block_size=4)
        sync, sync_ms = svc_timed(torch, tr, SVC_ROUNDS)
        sync_replays = tr._block_exec.replays
        tr.close()
        # checkpoints: blocks of 2, an archive every 2 rounds; the killed
        # run stops at SVC_KILL and a fresh trainer resumes its archive
        full_dir, kill_dir = svc_dir("svc_ckpt_full"), svc_dir("svc_ckpt_kill")
        tr = svc_trainer(model, data, mesh, block_size=2,
                         checkpoint_every=SVC_KILL,
                         checkpoint_dir=str(full_dir))
        full, _ = svc_timed(torch, tr, SVC_ROUNDS)
        tr.close()
        tr = svc_trainer(model, data, mesh, block_size=2,
                         checkpoint_every=SVC_KILL,
                         checkpoint_dir=str(kill_dir))
        tr.run(SVC_KILL)
        probe = kill_dir.parent / "svc_ckpt_probe.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(str(probe))
        save_ms = (time.perf_counter() - t0) * 1e3
        del tr
        back = svc_trainer(model, data, mesh, block_size=2,
                           checkpoint_every=SVC_KILL,
                           checkpoint_dir=str(kill_dir))
        t0 = time.perf_counter()
        back.load_checkpoint(str(kill_dir))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        resumed, _ = svc_timed(torch, back, SVC_ROUNDS - SVC_KILL)
        back.close()
        ok = svc_same(full, resumed)
        emit({**base, "part": "checkpoint", "resume_equal": ok,
              "max_abs_dev": max_abs_dev(full, resumed),
              "save_ms": save_ms, "load_ms": load_ms,
              "archive_bytes": probe.stat().st_size})
        if not ok:
            raise AssertionError("phase 4i-iv: the resumed run differs")
        # telemetry on == off (the blocked reference), check_dir clean
        tel = svc_dir("svc_telemetry")
        tr = svc_trainer(model, data, mesh, block_size=4,
                         telemetry_dir=str(tel))
        on, on_ms = svc_timed(torch, tr, SVC_ROUNDS)
        tr.close()
        errors = check_dir(str(tel))
        ok = svc_same(on, sync) and not errors
        emit({**base, "part": "telemetry", "on_equals_off": svc_same(on,
                                                                     sync),
              "check_dir": errors, "files": sorted(os.listdir(tel)),
              "round_ms_on": on_ms, "round_ms_off": sync_ms})
        if not ok:
            raise AssertionError("phase 4i-iv: telemetry changed the run "
                                 f"or its directory is bad: {errors}")
        # async D = 1 == the blocked run; every dispatch a replay
        tr = svc_trainer(model, data, mesh, async_depth=1)
        d1, d1_ms = svc_timed(torch, tr, SVC_ROUNDS)
        d1_replays = tr._async_exec.replays
        tr.close()
        tr = svc_trainer(model, data, mesh, **SVC_ASYNC2)
        _, d2_ms = svc_timed(torch, tr, SVC_ROUNDS)
        st = dict(tr.history.async_stats)
        d2_replays = tr._async_exec.replays
        tr.close()
        ok = (svc_same(d1, sync) and d1_replays == SVC_ROUNDS
              and d2_replays == st["dispatches"]
              and sync_replays == SVC_ROUNDS - 1)
        emit({**base, "part": "async", "d1_equals_sync": svc_same(d1, sync),
              "d1_replays": d1_replays, "d2_replays": d2_replays,
              "block_replays": sync_replays, "d1_round_ms": d1_ms,
              "d2_round_ms": d2_ms, "blocked_round_ms": sync_ms,
              "d2_async_stats": st,
              "note": "round ms: run() time over its rounds, the cold "
                      "start's round included, ended by a synchronize"})
        if not ok:
            raise AssertionError("phase 4i-iv: async D = 1 differs from the "
                                 "synchronous run or a dispatch ran eagerly")
        # a fleet of one == run(): per round (α = 20: eq. 9 newcomers) and
        # in blocks (the worker thread captures the NCCL graphs)
        fleet = {}
        for path, over in (("round", dict(alpha=20)),
                           ("block", dict(block_size=4))):
            plain = sync                  # the blocked reference
            if path == "round":
                tr = svc_trainer(model, data, mesh, **over)
                plain, _ = svc_timed(torch, tr, SVC_ROUNDS)
                tr.close()
            tr = svc_trainer(model, data, mesh, **over)
            coord = Coordinator(tr, FleetConfig(n_workers=1,
                                                **FLEET_CALM))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coord.run(SVC_ROUNDS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SVC_ROUNDS
            got = svc_state(torch, tr)
            fleet[path] = {"equal": svc_same(got, plain), "round_ms": ms,
                           "replays": (0 if tr._block_exec is None else
                                       tr._block_exec.replays),
                           "jobs": tr.registry.get("fleet.jobs")}
            coord.close()
        emit({**base, "part": "fleet", **fleet})
        if not all(v["equal"] for v in fleet.values()) \
                or fleet["block"]["replays"] != SVC_ROUNDS - 1:
            raise AssertionError("phase 4i-iv: a fleet of one differs from "
                                 "run()")
        # phase 4l's world of one: the zoo's (1, 1) path == mesh=None
        zoo_nccl1(torch, mesh, smi)
    finally:
        mesh_lib.destroy_process_group()
    torch.cuda.empty_cache()
    return ops.launch_counts()


def svc_rank_main(rank: int, world: int, store: str, out: str,
                  mode: str) -> int:
    """A phase-4i-iv rank on the card over gloo (a process of its own).
    ``run``: the uninterrupted checkpointing run (blocks of 2), the
    streamed run with SVC_FAULTS and a deadline that fires, then the
    killed run's first SVC_KILL rounds, and SIGKILL. ``resume``: the
    killed run resumed from its archive. Writes ``out``.json / ``out``.pt
    (``.resume`` before the suffix when resuming)."""
    import torch

    from repro_torch.data.generators import femnist_like
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.paper_models import mlp

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=world)
    mesh = mesh_lib.make_fed_mesh(world)
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    kill_dir = Path(out).parent / "ckpt_kill"
    ops.reset_launch_counts()
    if mode == "resume":
        tr = svc_trainer(model, data, mesh, block_size=2,
                         checkpoint_every=SVC_KILL,
                         checkpoint_dir=str(kill_dir))
        t0 = time.perf_counter()
        tr.load_checkpoint(str(kill_dir))
        load_ms = (time.perf_counter() - t0) * 1e3
        state, ms = svc_timed(torch, tr, SVC_ROUNDS - SVC_KILL)
        tr.close()
        Path(out + ".resume.json").write_text(json.dumps(
            {"load_ms": load_ms, "round_ms": ms,
             "launches": ops.launch_counts()}))
        torch.save(state, out + ".resume.pt")
        mesh_lib.destroy_process_group()
        return 0
    tr = svc_trainer(model, data, mesh, block_size=2,
                     checkpoint_every=SVC_KILL,
                     checkpoint_dir=str(Path(out).parent / "ckpt_full"))
    full, full_ms = svc_timed(torch, tr, SVC_ROUNDS)
    tr.close()
    pop = Population(
        ShardedClientStore(ArrayClientStore(data), world),
        PopulationConfig(**SVC_POP, faults=FaultConfig(
            {t: FaultSpec(**kw) for t, kw in SVC_FAULTS.items()})))
    cohorts = []
    nxt = pop.next_cohort

    def seen():
        c = nxt()
        cohorts.append({"rows": int(c.x.shape[0]),
                        "idx": [int(i) for i in c.idx]})
        return c
    pop.next_cohort = seen
    tr = svc_trainer(model, None, mesh, alpha=20, population=pop,
                     quarantine=True)
    stream, stream_ms = svc_timed(torch, tr, SVC_ROUNDS)
    stats = {k: int(v) for k, v in pop.stats.items()}
    tr.close()
    rec = {"backend": mesh.backend, "device": str(mesh.device),
           "full_round_ms": full_ms, "stream_round_ms": stream_ms,
           "cohorts": cohorts, "stats": stats,
           "launches": ops.launch_counts()}
    Path(out + ".json").write_text(json.dumps(rec))
    torch.save({"full": full, "stream": stream}, out + ".pt")
    tr = svc_trainer(model, data, mesh, block_size=2,
                     checkpoint_every=SVC_KILL, checkpoint_dir=str(kill_dir))
    tr.run(SVC_KILL)
    torch.cuda.synchronize()
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)      # the world dies here
    return 1


def svc_ranks() -> tuple:
    """Phase 4i-iv's two ranks in ``build/svc_gloo2``: ``run`` (which kills
    itself) then ``resume`` -> (run s, resume s)."""
    d = svc_dir("svc_gloo2")
    t0 = time.perf_counter()
    run_ranks("svc_rank_main", 2, d, "store_run", ("run",), SVC_TIMEOUT_S,
              -signal.SIGKILL, "phase 4i-iv run")
    t1 = time.perf_counter()
    run_ranks("svc_rank_main", 2, d, "store_resume", ("resume",),
              SVC_TIMEOUT_S, 0, "phase 4i-iv resume")
    SPAWN_S["svc_gloo2"] = (t1 - t0, time.perf_counter() - t1)


def svc_gloo2(torch, smi: str) -> int:
    """Phase 4i-iv on two spawned ranks sharing the card over gloo: kill
    both after round SVC_KILL's archive and respawn them, bit-equal to the
    uninterrupted two-rank run; the streamed faulted run's degraded prefix,
    membership and ``Population.stats`` the same on both ranks. Returns the
    ranks' edc_cosine launches."""
    world = 2
    d = ROOT / "build" / "svc_gloo2"
    run_s, resume_s = SPAWN_S["svc_gloo2"]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(world)]
    states = [torch.load(d / f"rank{r}.pt") for r in range(world)]
    back = [json.loads((d / f"rank{r}.resume.json").read_text())
            for r in range(world)]
    resumed = [torch.load(d / f"rank{r}.resume.pt") for r in range(world)]
    resume_ok = all(svc_same(states[r]["full"], resumed[r])
                    for r in range(world))
    replicas = all(svc_same(states[r][k], states[0][k])
                   for r in range(1, world) for k in ("full", "stream"))
    prefix_same = all(recs[r]["cohorts"] == recs[0]["cohorts"]
                      for r in range(1, world))
    stats_same = all(recs[r]["stats"] == recs[0]["stats"]
                     for r in range(1, world))
    degraded = [len(c["idx"]) for c in recs[0]["cohorts"]]
    emit({"phase": "services", "part": "gloo_two_ranks_one_card",
          "world": world, "backend": recs[0]["backend"],
          "devices": [r["device"] for r in recs], "nvidia_smi": smi,
          "resume_equal": resume_ok, "replicas_equal": replicas,
          "max_abs_dev_resume": max(max_abs_dev(states[r]["full"],
                                                resumed[r])
                                    for r in range(world)),
          "cohort_clients": degraded,
          "cohort_rows_a_rank": [[c["rows"] for c in r["cohorts"]]
                                 for r in recs],
          "prefix_same": prefix_same, "stats": recs[0]["stats"],
          "stats_same": stats_same,
          "full_round_ms": [r["full_round_ms"] for r in recs],
          "stream_round_ms": [r["stream_round_ms"] for r in recs],
          "resume_round_ms": [r["round_ms"] for r in back],
          "load_ms": [r["load_ms"] for r in back],
          "run_spawn_s": run_s, "resume_spawn_s": resume_s})
    st = recs[0]["stats"]
    if not (resume_ok and replicas and prefix_same and stats_same):
        raise AssertionError("phase 4i-iv: the two ranks' services differ")
    if not (st["deadline_rounds"] == 1 and st["killed_clients"] == 1
            and st["corrupted_clients"] == 2 and degraded[2] == 4):
        raise AssertionError(f"phase 4i-iv: faults and deadline {st}, "
                             f"cohorts {degraded}")
    return sum(r["launches"]["edc_cosine"] for r in recs + back)


def services_phase(torch, nccl1: dict, lane: Lane, smi: str) -> dict:
    """Phase 4i-iv: ``nccl1`` is {"counts": ``svc_nccl1``'s launches,
    "seconds"}, run before the two ranks (on the lane) are checked here;
    returns the launch counts of the phase (this process's NCCL world of
    one and, as ``edc_cosine``, both ranks')."""
    t0 = time.perf_counter()
    ranks_s = lane.wait("svc_gloo2")
    counts = dict(nccl1["counts"])
    counts["edc_cosine"] = counts.get("edc_cosine", 0) + svc_gloo2(torch,
                                                                   smi)
    if counts["edc_cosine"] < 1:
        raise AssertionError("phase 4i-iv launched no edc_cosine")
    emit({"phase": "services_phase", "launches": counts, "ranks_s": ranks_s,
          "seconds": nccl1["seconds"] + time.perf_counter() - t0,
          "nvidia_smi": smi})
    return counts


# ---------------------------------------------------------------------------
# Phase 4j: the 2-D (data, model) layout on two ranks sharing the card
# ---------------------------------------------------------------------------

def mesh2d_rank_main(rank: int, world: int, store: str, out: str) -> int:
    """A phase-4j rank (a process of its own) of a (1, MESH2D_MODEL) mesh
    over gloo: warms up, runs MESH2D_PATHS of FedGroup (EDC) at phase 4's
    width (the group parameters this rank's blocks, each cohort's clients
    split over the ranks), then Alg. 3 on its d_w columns of phase 6e's
    ΔW (built from ``decaying_update_matrix``'s generators: the one-device
    matrix's columns) with each QR. Writes ``out``.json (records),
    ``out``.pt (the FedGroup runs' state) and ``out``.V_<qr>.pt (its rows
    of V)."""
    import torch

    from repro_torch.data.generators import femnist_like
    from repro_torch.fed import parallel as fp
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.paper_models import mlp

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world // MESH2D_MODEL, MESH2D_MODEL)
        t0 = time.perf_counter()
        mesh_warmup(torch, mesh)
        recs = {"warmup_s": time.perf_counter() - t0,
                "backend": mesh.backend, "device": str(mesh.device),
                "model_index": mesh.model_index}
        states = {}
        data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
        model = mlp(784, 512, 26)
        for path in MESH2D_PATHS:
            torch.cuda.reset_peak_memory_stats()
            recs[path], states[path] = mesh_run(torch, model, data, mesh,
                                                path)
        torch.save(states, out + ".pt")
        del data
        torch.cuda.empty_cache()
        # Alg. 3 on this rank's columns of phase 6e's ΔW
        n, d, m = FED_NPRE, FED_DW, FED_M
        lo, hi = mesh.model_cols(d)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dW = fed_dryrun.decaying_update_matrix(n, d, "cuda", cols=(lo, hi))
        torch.cuda.synchronize()
        cold = {"cols": [lo, hi], "dW_bytes": dW.nbytes,
                "build_dW_s": time.perf_counter() - t0}
        # run_coldstart's draw of Ω
        omega = torch.randn((n, min(m + 8, n)), generator=torch.Generator()
                            .manual_seed(0)).cuda()
        for qr in ("householder", "cholesky"):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E, V = fp.edc_embedding_distributed(dW, m, omega=omega,
                                                qr_impl=qr, mesh=mesh)
            assign, _ = fp.kmeans_step(E, E[:m])
            torch.cuda.synchronize()
            cold[qr] = {"ms": (time.perf_counter() - t0) * 1e3,
                        "E": E.cpu().tolist(), "labels": assign.tolist(),
                        "launches": {**ops.launch_counts(),
                                     **ops.partial_launch_counts()}}
            torch.save(V.cpu(), f"{out}.V_{qr}.pt")
            del E, V
        cold["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        recs["coldstart"] = cold
        del dW
        Path(out + ".json").write_text(json.dumps(recs))
    finally:
        mesh_lib.destroy_process_group()
    return 0


def mesh2d_ranks() -> None:
    """Phase 4j's (1, MESH2D_MODEL) ranks in ``build/mesh2d``; any rank's
    failure fails the phase (``run_ranks``)."""
    d = ROOT / "build" / "mesh2d"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    run_ranks("mesh2d_rank_main", MESH2D_MODEL, d, "store", (),
              MESH2D_TIMEOUT_S, 0, "phase 4j")


def mesh2d_whole(torch, ranks: list, path: str, ref_state: dict) -> dict:
    """The ranks' stored blocks of each group-parameter leaf of ``path``'s
    run joined along ``group_param_pspec``'s dim (in model-index order)
    into whole leaves; fails unless each block has the spec's shape. What
    is kept whole (a leaf the spec does not split, the update directions)
    must be equal on every rank."""
    from repro_torch.sharding.specs import model_dim

    out = {}
    for k, want in ref_state.items():
        blocks = [st[path][k] for _, st in ranks]
        dim = (model_dim(tuple(want.shape), MESH2D_MODEL)
               if k.startswith("params/") else None)
        if dim is None:
            if not all(torch.equal(b, blocks[0]) for b in blocks):
                raise AssertionError(f"phase 4j {path}: {k} differs across "
                                     "the ranks")
            out[k] = blocks[0]
            continue
        size = want.shape[dim] // MESH2D_MODEL
        if any(b.shape[dim] != size for b in blocks):
            raise AssertionError(f"phase 4j {path}: {k}'s blocks "
                                 f"{[tuple(b.shape) for b in blocks]} are "
                                 "not group_param_pspec's")
        out[k] = torch.cat(blocks, dim=dim)
    return out


def mesh2d_phase(torch, lane: Lane, smi: str) -> dict:
    """Phase 4j: two spawned ranks sharing the card over gloo as a (1, 2)
    mesh, held to the runs of one device (phase 4i's FedGroup runs, phase
    6e's Alg. 3): labels and membership equal, accuracy and discrepancy
    within MESH_ACC_ATOL (the card's mesh tolerance), E within TOL after
    matching each column's sign, V's subspace within SUBSPACE_TOL. Returns
    the ranks' launch counts (``edc_cosine_partial`` among them)."""
    t_phase = time.perf_counter()
    world = MESH2D_MODEL
    d = ROOT / "build" / "mesh2d"
    spawn_s = lane.wait("mesh2d")
    ranks = [(json.loads((d / f"rank{r}.json").read_text()),
              torch.load(d / f"rank{r}.pt")) for r in range(world)]
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    for path in MESH2D_PATHS:
        ref, ref_state = MESH2D_REF[path]
        whole = mesh2d_whole(torch, ranks, path, ref_state)
        cmp = mesh_compare(ref, ref_state, ranks[0][0][path], whole,
                           "reference")
        replicas = all(recs[path][k] == ranks[0][0][path][k]
                       for recs, _ in ranks[1:]
                       for k in ("labels", "membership", "hist"))
        for recs, _ in ranks:
            add(recs[path]["launches"])
        rec = {"phase": "mesh2d", "part": "fedgroup", "path": path,
               "mesh": [world // MESH2D_MODEL, MESH2D_MODEL],
               "backend": ranks[0][0]["backend"], "nvidia_smi": smi, **cmp,
               "replicas_equal": replicas,
               "cold_ms": [recs[path]["cold_ms"] for recs, _ in ranks],
               "round_ms": [recs[path]["round_ms"] for recs, _ in ranks],
               "block_round_ms_steady": [recs[path]["block_round_ms_steady"]
                                         for recs, _ in ranks],
               "peak_device_bytes": [recs[path]["peak_device_bytes"]
                                     for recs, _ in ranks],
               "partial_launches": [recs[path]["launches"][
                   "edc_cosine_partial"] for recs, _ in ranks],
               "world1_cold_ms": ref["cold_ms"],
               "world1_round_ms": ref["round_ms"],
               "world1_block_round_ms_steady": ref["block_round_ms_steady"],
               "warmup_s": [recs["warmup_s"] for recs, _ in ranks],
               "hist": ranks[0][0][path]["hist"], "world1_hist": ref["hist"],
               "tolerances": {"acc_and_disc_abs": MESH_ACC_ATOL}}
        emit(rec)
        if not (cmp["ok"] and replicas):
            raise AssertionError(f"phase 4j {path}: the ranks differ from "
                                 "one device or from each other")
        if any(x < 1 for x in rec["partial_launches"]):
            raise AssertionError(f"phase 4j {path}: a rank's cold start "
                                 "launched no edc_cosine_partial")
    for qr in ("householder", "cholesky"):
        ref = MESH2D_REF["coldstart"][qr]
        E1 = ref["E"]
        V = torch.cat([torch.load(d / f"rank{r}.V_{qr}.pt")
                       for r in range(world)])
        sv = torch.linalg.svdvals(ref["V"].T @ V)
        sub_err = float((sv - 1).abs().max())
        del V
        rows = []
        for recs, _ in ranks:
            c = recs["coldstart"][qr]
            E = torch.tensor(c["E"])
            sign = torch.sign((E * E1).sum(0))
            rows.append({"labels_equal": c["labels"] == ref["labels"],
                         "E_max_abs_err": float((E * sign - E1).abs().max())
                         if bool((sign != 0).all()) else float("inf"),
                         "ms": c["ms"], "launches": c["launches"]})
            add(c["launches"])
        rec = {"phase": "mesh2d", "part": "coldstart", "qr": qr,
               "n": FED_NPRE, "d": FED_DW, "m": FED_M,
               "cols": [recs["coldstart"]["cols"] for recs, _ in ranks],
               "dW_bytes_a_rank": [recs["coldstart"]["dW_bytes"]
                                   for recs, _ in ranks],
               "build_dW_s": [recs["coldstart"]["build_dW_s"]
                              for recs, _ in ranks],
               "peak_device_bytes": [recs["coldstart"]["peak_device_bytes"]
                                     for recs, _ in ranks],
               "ranks": rows, "subspace_singular_values": sv.tolist(),
               "subspace_err": sub_err, "world1_ms": ref["ms"],
               "tolerances": {"E": TOL, "subspace": SUBSPACE_TOL},
               "nvidia_smi": smi, "backend": ranks[0][0]["backend"]}
        emit(rec)
        if not (all(r["labels_equal"] and r["E_max_abs_err"] <= TOL
                    for r in rows) and sub_err <= SUBSPACE_TOL):
            raise AssertionError(f"phase 4j coldstart {qr}: labels, E or "
                                 "the subspace differ from one device")
        if any(r["launches"]["edc_cosine_partial"] != 1 for r in rows):
            raise AssertionError(f"phase 4j coldstart {qr}: want one "
                                 "edc_cosine_partial launch a rank")
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "mesh2d_phase", "launches": counts, "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return counts


# ---------------------------------------------------------------------------
# Phase 4k: the runtime services under a model axis, process workers under
# a mesh
# ---------------------------------------------------------------------------

class HeldUntilDeath:
    """The round executor with its second call (dispatch 1's first
    attempt) held until this rank's coordinator declared a worker dead, so
    that attempt's result comes back only after its lease was given up
    (the CPU tests' ``fedgroup_fleet2``)."""

    def __init__(self, real, registry):
        self.real, self.registry, self.calls = real, registry, 0

    def __call__(self, *args):
        self.calls += 1
        end = time.monotonic() + 60.0
        while self.calls == 2 and not self.registry.get(
                "fleet.worker_deaths"):
            if time.monotonic() > end:
                raise AssertionError("no worker was declared dead")
            time.sleep(0.005)
        return self.real(*args)


def warm_replica(tr, rows: int):
    """One local solve of ``tr``'s first ``rows`` clients, synchronised: a
    spawned worker's first use of the card (its CUDA libraries loaded),
    run while it builds its replica so that its first job is not."""
    import torch

    ex = tr._round_executor()
    x, y, n = tr._client_batch(np.arange(rows))
    _, args = ex.prepare(tr.group_params, torch.zeros(
        rows, dtype=torch.long, device=tr.device), x, y, n,
        tr._batch_indices(n, ex.max_steps))
    ex.local(*args)
    torch.cuda.synchronize()
    return tr


def svc2d_worker_trainer(rows: int = 10):
    """Phase 4k's process workers' replica (``SVC2D_PROC_BUILDER``): the
    ranks' FedGroup at α = 20 on the card with phase 4's data from seed 0,
    without a mesh (a spawned worker is in no process group), warmed up by
    a local solve of ``rows`` clients (a rank's share of a cohort)."""
    from repro_torch.data.generators import femnist_like
    from repro_torch.models.paper_models import mlp

    return warm_replica(svc_trainer(mlp(784, 512, 26), femnist_like(
        seed=0, dim=784, n_classes=26, n_clients=200), None, alpha=20),
        rows)


def svc2d_streamed(torch, model, data, mesh, faults: dict, pop_kw: dict):
    """A streamed FedGroup run (α = 20, the quarantine on) with scripted
    ``faults`` -> (state, round ms, the consumed cohorts' rows held and
    ids, ``Population.stats``)."""
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore

    pop = Population(
        ShardedClientStore(ArrayClientStore(data), mesh.data_shards),
        PopulationConfig(**pop_kw, faults=FaultConfig(
            {t: FaultSpec(**kw) for t, kw in faults.items()})))
    cohorts = []
    nxt = pop.next_cohort

    def seen():
        c = nxt()
        cohorts.append({"rows": int(c.x.shape[0]),
                        "idx": [int(i) for i in c.idx]})
        return c
    pop.next_cohort = seen
    tr = svc_trainer(model, None, mesh, alpha=20, population=pop,
                     quarantine=True)
    state, ms = svc_timed(torch, tr, SVC_ROUNDS)
    stats = {k: int(v) for k, v in pop.stats.items()}
    tr.close()
    return state, ms, cohorts, stats


def svc2d_small_async(mesh, device: str) -> dict:
    """Phase 4g-ii's small FedGroup run at D = 2 (α = 0.8, β = 0.5; 40
    clients, mclr(16, 10), K = 8, E = 2) on ``mesh`` (None: one device)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mclr

    data = mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                    seed=0, async_depth=2, **ASYNC_WEIGHTS)
    tr = FedGroupTrainer(mclr(16, 10), data, cfg, device=device, mesh=mesh)
    h = tr.run()
    tr.close()
    return {"hist": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                     for r in h.rounds],
            "membership": [int(v) for v in tr.membership],
            "group_version": [int(v) for v in tr.group_version],
            "async_stats": dict(h.async_stats)}


def svc2d_fleet(torch, model, data, mesh, fleet_kw: dict, held: bool):
    """FedGroup (α = 20) per round through a thread fleet on ``mesh``;
    with ``held`` rank 0 holds dispatch 1's first attempt until it has
    declared a worker dead -> (state, round ms, ``fleet.*``)."""
    from repro_torch.launch.coordinator import Coordinator, FleetConfig

    tr = svc_trainer(model, data, mesh, alpha=20)
    coord = Coordinator(tr, FleetConfig(**fleet_kw))
    if held and mesh.rank == 0:
        coord._table["round"] = HeldUntilDeath(coord._table["round"],
                                               tr.registry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coord.run(SVC_ROUNDS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SVC_ROUNDS
    state = svc_state(torch, tr)
    coord.close()                  # a stale result has come back by then
    reg = tr.registry
    return state, ms, {k: reg.get(k) for k in reg.names("fleet.")}


def svc2d_proc(torch, model, data, mesh) -> tuple:
    """FedGroup (α = 20) per round through a process fleet of two workers
    a rank on ``mesh``, the last rank's holder of dispatch
    SVC2D_PROC_KILL SIGKILLed -> (state, record: spawn s, each round's
    ms, ``fleet.*``, children left after close)."""
    from repro_torch.fed.population import FaultConfig, FaultSpec
    from repro_torch.launch.coordinator import Coordinator, FleetConfig
    from repro_torch.launch.worker import WorkerSpec

    last = mesh.rank == mesh.world - 1
    faults = (FaultConfig({SVC2D_PROC_KILL: FaultSpec(worker_kill=True)})
              if last else None)
    tr = svc_trainer(model, data, mesh, alpha=20)
    t0 = time.perf_counter()
    coord = Coordinator(tr, FleetConfig(
        n_workers=2, transport="proc", faults=faults,
        worker_spec=WorkerSpec(SVC2D_PROC_BUILDER, {}),
        heartbeat_interval=PROC_BEAT[0], heartbeat_miss=PROC_BEAT[1],
        lease_timeout=600.0, join_timeout=600.0))
    rec = {}
    try:
        end = time.monotonic() + 600.0
        while len(coord._live) < 2:
            if time.monotonic() > end:
                raise AssertionError("phase 4k: process workers did not "
                                     "join")
            coord._pump(0.02)
        rec["spawn_and_build_s"] = time.perf_counter() - t0
        ms = []
        for _ in range(SVC_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coord.run(1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        state = svc_state(torch, tr)
        reg = tr.registry
        rec["fleet"] = {k: reg.get(k) for k in reg.names("fleet.")}
    finally:
        coord.close()
    rec["round_ms"] = ms
    rec["children_left"] = len(coord._transport._procs)
    return state, rec


def svc2d_rank_main(rank: int, world: int, store: str, out: str,
                    mode: str) -> int:
    """A phase-4k rank (a process of its own) on the card over gloo.
    ``run``: on the (1, MESH2D_MODEL) mesh the synchronous run, telemetry,
    the uninterrupted checkpointing run, async D = 1 and 2, 4g-ii's small
    D = 2 run, two thread fleets and two faulted streamed runs, then the
    killed run's first SVC_KILL rounds (a timed save), and SIGKILL.
    ``resume``: the killed run resumed from its archive, then on the
    ranks' 1-D mesh the run without a fleet and with a process fleet.
    Writes ``out``.json / ``out``.pt (``.resume`` before the suffix when
    resuming; ``.save.json`` the save)."""
    import torch

    from repro_torch.data.generators import femnist_like
    from repro_torch.fed.population import FaultConfig, FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.paper_models import mlp

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=world)
    mesh = mesh_lib.make_fed_mesh(world // MESH2D_MODEL, MESH2D_MODEL)
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    d = Path(out).parent
    kill_dir = d / "ckpt_kill"
    mesh_warmup(torch, mesh)
    ops.reset_launch_counts()
    rec = {"backend": mesh.backend, "device": str(mesh.device),
           "model_index": mesh.model_index}
    states = {}
    if mode == "resume":
        tr = svc_trainer(model, data, mesh, alpha=20,
                         checkpoint_every=SVC_KILL,
                         checkpoint_dir=str(kill_dir))
        t0 = time.perf_counter()
        tr.load_checkpoint(str(kill_dir))
        torch.cuda.synchronize()
        rec["load_ms"] = (time.perf_counter() - t0) * 1e3
        states["resumed"], rec["resume_round_ms"] = svc_timed(
            torch, tr, SVC_ROUNDS - SVC_KILL)
        tr.close()
        rec["launches_2d"] = {**ops.launch_counts(),
                              **ops.partial_launch_counts()}
        # the same ranks as a 1-D mesh: a process fleet against run()
        flat = mesh_lib.make_fed_mesh(world)
        ops.reset_launch_counts()
        tr = svc_trainer(model, data, flat, alpha=20)
        states["plain"], rec["plain_round_ms"] = svc_timed(torch, tr,
                                                           SVC_ROUNDS)
        tr.close()
        states["proc"], rec["proc"] = svc2d_proc(torch, model, data, flat)
        rec["launches_1d"] = ops.launch_counts()
        Path(out + ".resume.json").write_text(json.dumps(rec))
        torch.save(states, out + ".resume.pt")
        mesh_lib.destroy_process_group()
        return 0
    tr = svc_trainer(model, data, mesh, alpha=20)
    states["sync"], rec["sync_round_ms"] = svc_timed(torch, tr, SVC_ROUNDS)
    tr.close()
    tr = svc_trainer(model, data, mesh, alpha=20,
                     telemetry_dir=str(d / "telemetry"))
    states["telemetry"], rec["telemetry_round_ms"] = svc_timed(
        torch, tr, SVC_ROUNDS)
    tr.close()
    tr = svc_trainer(model, data, mesh, alpha=20, checkpoint_every=SVC_KILL,
                     checkpoint_dir=str(d / "ckpt_full"))
    states["full"], rec["full_round_ms"] = svc_timed(torch, tr, SVC_ROUNDS)
    tr.close()
    tr = svc_trainer(model, data, mesh, alpha=20, async_depth=1)
    states["d1"], rec["d1_round_ms"] = svc_timed(torch, tr, SVC_ROUNDS)
    tr.close()
    tr = svc_trainer(model, data, mesh, alpha=20, **SVC_ASYNC2)
    _, rec["d2_round_ms"] = svc_timed(torch, tr, SVC_ROUNDS)
    rec["d2_async_stats"] = dict(tr.history.async_stats)
    tr.close()
    rec["small_d2"] = svc2d_small_async(mesh, "cuda")
    for name, kw, held in (
            ("fleet1", dict(n_workers=1, **FLEET_CALM), False),
            ("fleet2", dict(n_workers=2, heartbeat_interval=0.05,
                            heartbeat_miss=10, lease_timeout=60.0,
                            faults=FaultConfig({t: FaultSpec(**f) for t, f
                                                in SVC2D_FLEET2.items()})),
             True)):
        states[name], ms, fleet = svc2d_fleet(torch, model, data, mesh, kw,
                                              held)
        rec[name] = {"round_ms": ms, "fleet": fleet}
    for name, faults, pop_kw in (("faults", SVC_FAULTS, SVC_POP),
                                 ("corrupt", SVC2D_CORRUPT,
                                  SVC2D_CORRUPT_POP)):
        states[name], ms, cohorts, stats = svc2d_streamed(
            torch, model, data, mesh, faults, pop_kw)
        rec[name] = {"round_ms": ms, "cohorts": cohorts, "stats": stats}
    rec["launches"] = {**ops.launch_counts(), **ops.partial_launch_counts()}
    Path(out + ".json").write_text(json.dumps(rec))
    torch.save(states, out + ".pt")
    tr = svc_trainer(model, data, mesh, alpha=20, checkpoint_every=SVC_KILL,
                     checkpoint_dir=str(kill_dir))
    tr.run(SVC_KILL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe = d / "ckpt_probe.npz"
    tr.save_checkpoint(str(probe))
    Path(out + ".save.json").write_text(json.dumps(
        {"save_ms": (time.perf_counter() - t0) * 1e3}))
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)      # the world dies here
    return 1


def svc2d_ranks() -> None:
    """Phase 4k's two ranks in ``build/svc2d``: ``run`` (which kills
    itself) then ``resume``."""
    d = svc_dir("svc2d")
    t0 = time.perf_counter()
    run_ranks("svc2d_rank_main", MESH2D_MODEL, d, "store_run", ("run",),
              SVC2D_TIMEOUT_S, -signal.SIGKILL, "phase 4k run")
    t1 = time.perf_counter()
    run_ranks("svc2d_rank_main", MESH2D_MODEL, d, "store_resume",
              ("resume",), SVC2D_TIMEOUT_S, 0, "phase 4k resume")
    SPAWN_S["svc2d"] = (t1 - t0, time.perf_counter() - t1)


def svc2d_join(torch, blocks: list, whole):
    """The ranks' blocks of a parameter leaf joined along
    ``group_param_pspec``'s dim (model-index order) into ``whole``'s
    shape; a leaf the spec keeps whole is the first rank's."""
    from repro_torch.sharding.specs import model_dim

    dim = model_dim(tuple(whole.shape), MESH2D_MODEL)
    return blocks[0] if dim is None else torch.cat(blocks, dim=dim)


def svc2d_replicas(a: dict, b: dict) -> bool:
    """Two ranks' whole state (membership, history, update directions) bit
    for bit; the parameters are each rank's blocks."""
    keys = ("membership", "hist", "group_delta")
    return svc_same({k: a[k] for k in keys}, {k: b[k] for k in keys})


def services2d_phase(torch, lane: Lane, smi: str) -> dict:
    """Phase 4k: two spawned ranks sharing the card over gloo; see the
    module docstring. Returns the ranks' launch counts (each rank's cold
    starts on the (1, 2) mesh launch ``edc_cosine_partial``; on the 1-D
    mesh ``edc_cosine``)."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.data.generators import femnist_like
    from repro_torch.fed.population import FaultConfig
    from repro_torch.launch.inspect import check_dir
    from repro_torch.models.paper_models import mlp

    t_phase = time.perf_counter()
    world = MESH2D_MODEL
    d = ROOT / "build" / "svc2d"
    lane.wait("svc2d")
    run_s, resume_s = SPAWN_S["svc2d"]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(world)]
    states = [torch.load(d / f"rank{r}.pt") for r in range(world)]
    saves = [json.loads((d / f"rank{r}.save.json").read_text())
             for r in range(world)]
    backs = [json.loads((d / f"rank{r}.resume.json").read_text())
             for r in range(world)]
    bstates = [torch.load(d / f"rank{r}.resume.pt") for r in range(world)]
    base = {"phase": "services2d", "mesh": [1, MESH2D_MODEL],
            "backend": recs[0]["backend"],
            "devices": [r["device"] for r in recs], "nvidia_smi": smi}
    failed = []

    def gate(ok: bool, what: str):
        if not ok:
            failed.append(what)

    # checkpoints: kill-and-resume bit-equal on both ranks; the archive's
    # leaves whole; the archive resumed on one device in this process
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    resume_ok = all(svc_same(states[r]["full"], bstates[r]["resumed"])
                    for r in range(world))
    archive = d / "ckpt_kill" / f"ckpt_{SVC_KILL:08d}.npz"
    specs = ckpt_io.saved_array_specs(str(archive))
    shapes = {k: tuple(v.shape) for k, v in model.init(None, "meta").items()}
    whole = all(specs[f"model/params/{k}"][0] == v and
                specs[f"model/group_params/{k}"][0] == (5,) + v
                for k, v in shapes.items())
    tr = svc_trainer(model, data, None, alpha=20, checkpoint_every=SVC_KILL,
                     checkpoint_dir=str(svc_dir("svc2d_one")))
    tr.load_checkpoint(str(archive))
    one, one_ms = svc_timed(torch, tr, SVC_ROUNDS - SVC_KILL)
    tr.close()
    full = {k: (svc2d_join(torch, [st["full"][k] for st in states], v)
                if "params/" in k else states[0]["full"][k])
            for k, v in one.items()}
    hist_dev = (full["hist"] - one["hist"]).abs()
    one_ok = (torch.equal(full["membership"], one["membership"])
              and float(hist_dev[:, [1, 3]].max()) <= MESH_ACC_ATOL)
    leaf_err = max(float((full[k] - one[k]).norm() / one[k].norm())
                   for k in one if "params/" in k)
    emit({**base, "part": "checkpoint", "resume_equal": resume_ok,
          "max_abs_dev_resume": max(max_abs_dev(
              {k: v for k, v in states[r]["full"].items()},
              bstates[r]["resumed"]) for r in range(world)),
          "save_ms": [s["save_ms"] for s in saves],
          "load_ms": [b["load_ms"] for b in backs],
          "archive_bytes": archive.stat().st_size,
          "archive_leaves_whole": whole,
          "one_device_resume_ok": one_ok,
          "one_device_max_hist_dev_acc_disc": float(
              hist_dev[:, [1, 3]].max()),
          "one_device_max_leaf_rel_err": leaf_err,
          "one_device_round_ms": one_ms,
          "resume_round_ms": [b["resume_round_ms"] for b in backs],
          "tolerances": {"acc_and_disc_abs": MESH_ACC_ATOL}})
    gate(resume_ok and whole and one_ok, "checkpoint")
    # telemetry on == off; rank 0 writes a clean directory
    tel = d / "telemetry"
    errors = check_dir(str(tel))
    on_ok = all(svc_same(st["telemetry"], st["sync"]) for st in states)
    emit({**base, "part": "telemetry", "on_equals_off": on_ok,
          "check_dir": errors, "files": sorted(os.listdir(tel)),
          "round_ms_on": [r["telemetry_round_ms"] for r in recs],
          "round_ms_off": [r["sync_round_ms"] for r in recs]})
    gate(on_ok and not errors, "telemetry")
    # async: D = 1 == sync; 4g-ii's small D = 2 run against the CPU
    cpu = svc2d_small_async(None, "cpu")
    small_ok = True
    for r in recs:
        got = r["small_d2"]
        small_ok &= (got["membership"] == cpu["membership"]
                     and got["group_version"] == cpu["group_version"]
                     and got["async_stats"] == cpu["async_stats"])
        for (ac, lc, dc), (ag, lg, dg) in zip(cpu["hist"], got["hist"],
                                               strict=True):
            small_ok &= (math.isclose(lc, lg, rel_tol=1e-3)
                         and math.isclose(dc, dg, rel_tol=1e-3)
                         and abs(ac - ag) <= 0.01)
    d1_ok = all(svc_same(st["d1"], st["sync"]) for st in states)
    emit({**base, "part": "async", "d1_equals_sync": d1_ok,
          "d1_round_ms": [r["d1_round_ms"] for r in recs],
          "d2_round_ms": [r["d2_round_ms"] for r in recs],
          "sync_round_ms": [r["sync_round_ms"] for r in recs],
          "d2_async_stats": recs[0]["d2_async_stats"],
          "small_d2_matches_cpu": small_ok,
          "small_d2_cuda": recs[0]["small_d2"]["hist"],
          "small_d2_cpu": cpu["hist"],
          "tolerances": {"loss_and_disc_rel": 1e-3, "acc_abs": 0.01},
          "note": "round ms: run() time over its rounds, the cold start's "
                  "round included, ended by a synchronize"})
    gate(d1_ok and small_ok, "async")
    # thread fleets: of one, and of two with a death and a kill
    f2 = [r["fleet2"]["fleet"] for r in recs]
    fleet_ok = all(svc_same(st["fleet1"], st["sync"])
                   and svc_same(st["fleet2"], st["sync"]) for st in states)
    counts_ok = all((f["fleet.jobs"], f["fleet.results"],
                     f["fleet.lease_expiries"], f["fleet.requeues"])
                    == (6, 4, 2, 2) for f in f2)
    emit({**base, "part": "fleet", "fleet1_equals_run": all(
              svc_same(st["fleet1"], st["sync"]) for st in states),
          "fleet2_equals_run": all(svc_same(st["fleet2"], st["sync"])
                                   for st in states),
          "fleet1_round_ms": [r["fleet1"]["round_ms"] for r in recs],
          "fleet2_round_ms": [r["fleet2"]["round_ms"] for r in recs],
          "fleet1": recs[0]["fleet1"]["fleet"], "fleet2": f2})
    gate(fleet_ok and counts_ok, "thread fleets")
    # the faulted streamed runs: the same prefix and stats on both ranks
    lanes = np.random.default_rng([FaultConfig({}).seed, 0xFA017, 2]).choice(
        20, 2, replace=False)
    for name, k_cut in (("faults", 4), ("corrupt", 10)):
        rows = [r[name] for r in recs]
        same = all(x["cohorts"] == rows[0]["cohorts"]
                   and x["stats"] == rows[0]["stats"] for x in rows[1:])
        replicas = all(svc2d_replicas(st[name], states[0][name])
                       for st in states[1:])
        st = rows[0]["stats"]
        clients = [len(c["idx"]) for c in rows[0]["cohorts"]]
        want = ({"deadline_rounds": 1, "killed_clients": 1,
                 "corrupted_clients": 2} if name == "faults" else
                {"deadline_rounds": 1,
                 "corrupted_clients": int(np.sum(lanes < k_cut))})
        counts = all(st[k] == v for k, v in want.items())
        emit({**base, "part": "faults", "run": name, "prefix_same": same,
              "replicas_equal": replicas, "stats": st,
              "cohort_clients": clients,
              "cohort_rows_a_rank": [[c["rows"] for c in x["cohorts"]]
                                     for x in rows],
              "round_ms": [x["round_ms"] for x in rows]})
        gate(same and replicas and counts and clients[2] == k_cut,
             f"streamed {name}")
    # process workers on the 1-D mesh: the SIGKILLed worker recovered
    procs = [b["proc"] for b in backs]
    dev = max(max_abs_dev(st["proc"], st["plain"]) for st in bstates)
    proc_ok = (all(svc_same(st["proc"], st["plain"]) for st in bstates)
               and svc_same(bstates[1]["proc"], bstates[0]["proc"]))
    job_counts = [(p["fleet"]["fleet.jobs"], p["fleet"]["fleet.results"],
                   p["fleet"]["fleet.lease_expiries"],
                   p["fleet"]["fleet.requeues"]) for p in procs]
    deaths = [p["fleet"]["fleet.worker_deaths"] for p in procs]
    ms = procs[-1]["round_ms"]
    emit({**base, "part": "process", "mesh": [world, 1],
          "max_abs_dev_vs_run": dev, "equal_to_run": proc_ok,
          "job_counters": job_counts, "worker_deaths": deaths,
          "children_left": [p["children_left"] for p in procs],
          "spawn_and_build_s": [p["spawn_and_build_s"] for p in procs],
          "round_ms": [p["round_ms"] for p in procs],
          "plain_round_ms": [b["plain_round_ms"] for b in backs],
          "killed_dispatch": SVC2D_PROC_KILL,
          "kill_recovery_ms": (ms[SVC2D_PROC_KILL] + ms[SVC2D_PROC_KILL + 1]
                               - 2 * ms[-1]),
          "note": "recovery ms: the killed rank's killed round and the "
                  "next (whose worker may still run the superseded "
                  "attempt) less twice its last round"})
    gate(proc_ok and all(c == (5, 4, 1, 1) for c in job_counts)
         and deaths == [0] * (world - 1) + [1]
         and all(p["children_left"] == 0 for p in procs), "process fleet")
    counts = {"edc_cosine": 0, "edc_cosine_partial": 0}
    for r, b in zip(recs, backs):
        counts["edc_cosine"] += b["launches_1d"]["edc_cosine"]
        counts["edc_cosine_partial"] += (
            r["launches"]["edc_cosine_partial"]
            + b["launches_2d"]["edc_cosine_partial"])
    emit({"phase": "services2d_phase", "launches": counts,
          "partial_launches_a_rank": [r["launches"]["edc_cosine_partial"]
                                      for r in recs],
          "run_spawn_s": run_s, "resume_spawn_s": resume_s,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    if any(r["launches"]["edc_cosine_partial"] < 1 for r in recs):
        failed.append("a rank's cold starts launched no edc_cosine_partial")
    if failed:
        raise AssertionError(f"phase 4k: {failed}")
    shutil.rmtree(d, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 4l: the zoo over a model axis (tensor parallelism for serving) on two
# ranks sharing the card, and its world of one over NCCL
# ---------------------------------------------------------------------------

def zoo_tp_blocks(torch, mesh, cfg, one_device):
    """A rank's blocks of ``cfg``'s params (random from seed 0 on the
    card, cut by ``zoo.shard_params``), each rank in turn (the whole tree
    is on the card for one rank at a time), and rank 0's ``one_device(
    whole)`` first, the other ranks waiting: -> (blocks, one_device's
    return on rank 0, else None)."""
    import gc

    from repro_torch.models import zoo

    blocks = ref = None
    for r in range(mesh.world):
        if mesh.rank == r:
            whole = zoo.init_params(torch.Generator(device="cuda")
                                    .manual_seed(0), cfg, device="cuda")
            if r == 0:
                ref = one_device(whole)
            blocks = zoo.shard_params(whole, cfg, mesh)
            del whole
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        mesh.barrier()
    return blocks, ref


def zoo_decode(torch, params, cfg, tok, mesh=None, kv_spec=None,
               seq_shard=False):
    """ZOO_TP_STEPS ``serve_step`` calls over ``tok``'s positions from an
    empty cache (the rank's blocks of it on a mesh) -> (logits (B, steps,
    V), each step's host ms ended by a synchronize)."""
    from repro_torch.models import zoo

    B = tok.shape[0]
    cache = zoo.init_cache(cfg, B, ZOO_TP_STEPS, device="cuda", mesh=mesh,
                           seq_shard=seq_shard)
    outs, ms = [], []
    for t in range(ZOO_TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = zoo.serve_step(params, cfg, cache, tok[:, t:t + 1],
                                   torch.full((B,), t, device="cuda"),
                                   kv_spec=kv_spec, mesh=mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg.float())
    return torch.stack(outs, 1), ms


def zoo_tp_zamba2(torch, mesh) -> dict:
    """Zamba2-1.2B whole on (1, 2): the fp32 prefill at B1 S ZOO_TP_S and
    ZOO_TP_STEPS decode steps against one device's (rank 0's whole params
    while the other rank waits), the bf16 B4 S2048 prefill's ms (median of
    3 after a warm-up) and peak against one device's, a counted bf16
    forward's launches."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves

    cfg = registry.get("zamba2-1.2b")
    f32 = cfg.replace(dtype="float32")
    g = torch.Generator(device="cuda")
    tok_f = torch.randint(0, cfg.vocab_size, (1, ZOO_TP_S), device="cuda",
                          generator=g.manual_seed(3))
    tok_b = torch.randint(0, cfg.vocab_size, (ZAMBA_B, ZAMBA_S),
                          device="cuda", generator=g.manual_seed(2))

    def runs(params, mesh):
        out = {}
        with torch.inference_mode():
            out["prefill"] = zoo.forward(params, f32, {"tokens": tok_f},
                                         mesh=mesh)[0].float()
            out["decode"], ms = zoo_decode(torch, params, f32, tok_f, mesh)
            out["decode_step_ms"] = statistics.median(ms)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

            def fwd():
                return zoo.forward(params, cfg, {"tokens": tok_b},
                                   mesh=mesh)[0]
            fwd()                                       # warm-up
            out["prefill_bf16_ms_each"] = [cuda_ms(torch, fwd, 1, warmup=0)
                                           for _ in range(3)]
            out["prefill_bf16_ms"] = statistics.median(
                out["prefill_bf16_ms_each"])
            ops.reset_launch_counts()
            logits = fwd()
            torch.cuda.synchronize()
            out["launches"] = ops.launch_counts()
            out["finite"] = bool(torch.isfinite(logits).all())
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            del logits
        return out

    blocks, ref = zoo_tp_blocks(torch, mesh, cfg, lambda p: runs(p, None))
    got = runs(blocks, mesh)
    for k in ("prefill", "decode"):
        mesh.same_on_every_rank(f"zamba2 {k} logits", got[k])
    rec = {k: v for k, v in got.items() if k not in ("prefill", "decode")}
    rec["param_bytes"] = sum(t.nbytes for t in tree_leaves(blocks))
    if ref is not None:
        rec["one_device"] = {k: v for k, v in ref.items()
                             if k not in ("prefill", "decode")}
        for k in ("prefill", "decode"):
            rec[f"{k}_rel_err"] = grad_rel_err(torch, [got[k]], [ref[k]])
    return rec


def zoo_tp_gemma(torch, mesh) -> dict:
    """Gemma-2B at its published widths cut to ZOO_TP_GEMMA_LAYERS layers,
    fp32, on (1, 2): ZOO_TP_STEPS decode steps at B1 with the slot-split
    cache (kv 1 < 2 ranks: ``cache_specs(seq_shard=True)``, ``kv_spec``),
    the vocab-parallel embedding and tied head over 256,000 rows, against
    one device's steps."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.sharding import specs as sh

    published = registry.get("gemma-2b")
    cfg = published.replace(dtype="float32", n_layers=ZOO_TP_GEMMA_LAYERS)
    tok = torch.randint(0, cfg.vocab_size, (1, ZOO_TP_STEPS), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(4))
    whole = zoo.init_cache(cfg, 1, ZOO_TP_STEPS, device="meta")
    kv_spec = tuple(sh.cache_specs(whole, cfg, mesh, mp=mesh.model_shards,
                                   seq_shard=True)["k"][1:])

    def one_device(params):
        with torch.inference_mode():
            logits, ms = zoo_decode(torch, params, cfg, tok)
        return {"decode": logits, "decode_step_ms": statistics.median(ms)}

    blocks, ref = zoo_tp_blocks(torch, mesh, cfg, one_device)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        logits, ms = zoo_decode(torch, blocks, cfg, tok, mesh, kv_spec, True)
    mesh.same_on_every_rank("gemma decode logits", logits)
    rec = {"reduced": f"n_layers {published.n_layers} -> {cfg.n_layers}",
           "kv_spec": list(kv_spec), "decode_step_ms": statistics.median(ms),
           "cache_slots_a_rank": ZOO_TP_STEPS // mesh.model_shards,
           "embed_rows_a_rank": int(blocks["embed"].shape[0]),
           "finite": bool(torch.isfinite(logits).all()),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if ref is not None:
        rec["one_device_decode_step_ms"] = ref["decode_step_ms"]
        rec["decode_rel_err"] = grad_rel_err(torch, [logits],
                                             [ref["decode"]])
    return rec


def zoo_tp_granite(torch, mesh) -> dict:
    """Granite-MoE-1B whole, fp32, on (1, 2): the prefill at B1 S ZOO_TP_S
    with half the experts a rank, against one device's."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo

    cfg = registry.get("granite-moe-1b-a400m").replace(dtype="float32")
    tok = torch.randint(0, cfg.vocab_size, (1, ZOO_TP_S), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))

    def prefill(params, mesh=None):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = zoo.forward(params, cfg, {"tokens": tok},
                                 mesh=mesh)[0].float()
            torch.cuda.synchronize()
        return {"prefill": logits,
                "prefill_ms": (time.perf_counter() - t0) * 1e3}

    blocks, ref = zoo_tp_blocks(torch, mesh, cfg, prefill)
    got = prefill(blocks, mesh)
    mesh.same_on_every_rank("granite-moe prefill logits", got["prefill"])
    rec = {"prefill_ms": got["prefill_ms"],
           "experts_a_rank": int(blocks["blocks"]["moe"]["w_up"].shape[1]),
           "finite": bool(torch.isfinite(got["prefill"]).all())}
    if ref is not None:
        rec["one_device_prefill_ms"] = ref["prefill_ms"]
        rec["prefill_rel_err"] = grad_rel_err(torch, [got["prefill"]],
                                              [ref["prefill"]])
    return rec


def zoo_tp_rank_main(rank: int, world: int, store: str, out: str) -> int:
    """A phase-4l rank (a process of its own) of a (1, ZOO_TP_MODEL) mesh
    over gloo: Zamba2-1.2B, Gemma-2B (the slot-split decode) and
    Granite-MoE-1B on its blocks (``zoo_tp_zamba2`` / ``_gemma`` /
    ``_granite``), rank 0 also running each whole on its own first; the
    gathered logits must be equal on every rank. Writes ``out``.json."""
    import torch

    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world // ZOO_TP_MODEL, ZOO_TP_MODEL)
        recs = {"backend": mesh.backend, "device": str(mesh.device),
                "model_index": mesh.model_index}
        for name, fn in (("zamba2", zoo_tp_zamba2), ("gemma", zoo_tp_gemma),
                         ("granite_moe", zoo_tp_granite)):
            t0 = time.perf_counter()
            recs[name] = fn(torch, mesh)
            recs[name]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        Path(out + ".json").write_text(json.dumps(recs))
    finally:
        mesh_lib.destroy_process_group()
    return 0


def zoo_tp_ranks() -> None:
    """Phase 4l's (1, ZOO_TP_MODEL) ranks in ``build/zoo_tp``; any rank's
    failure fails the phase (``run_ranks``)."""
    d = ROOT / "build" / "zoo_tp"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    run_ranks("zoo_tp_rank_main", ZOO_TP_MODEL, d, "store", (),
              ZOO_TP_TIMEOUT_S, 0, "phase 4l")


def zoo_tp_phase(torch, lane: Lane, smi: str) -> dict:
    """Phase 4l: the ranks' records checked here: rank 0's logits within
    ZOO_TP_TOL of one device's (max |Δ| over max |logit|), every output
    finite, the gloo backend on one card, each rank's counted bf16 Zamba2
    forward launching swa_attention (``tc``) once a shared-block
    application and ssd_intra_chunk (``tc``) once a layer on its local
    heads. Returns the launch counts of the ranks' counted forwards."""
    t_phase = time.perf_counter()
    spawn_s = lane.wait("zoo_tp")
    d = ROOT / "build" / "zoo_tp"
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(ZOO_TP_MODEL)]
    from repro_torch.configs import registry
    want = expected_launches(torch, registry.get("zamba2-1.2b"))
    failed, counts = [], {}
    for r, rec in enumerate(recs):
        for name in ("zamba2", "gemma", "granite_moe"):
            emit({"phase": "zoo_tp", "model": name, "rank": r,
                  "mesh": f"1x{ZOO_TP_MODEL}", "backend": rec["backend"],
                  "device": rec["device"], "nvidia_smi": smi, **rec[name]})
            if not rec[name]["finite"]:
                failed.append(f"rank {r} {name}: non-finite logits")
        z = rec["zamba2"]
        if z["launches"] != want:
            failed.append(f"rank {r}: a bf16 Zamba2 forward launched "
                          f"{z['launches']}, not {want}")
        for k, v in z["launches"].items():
            counts[k] = counts.get(k, 0) + v
        if rec["backend"] != "gloo":
            failed.append(f"rank {r}: backend {rec['backend']}")
    r0 = recs[0]
    for name, keys in (("zamba2", ("prefill_rel_err", "decode_rel_err")),
                       ("gemma", ("decode_rel_err",)),
                       ("granite_moe", ("prefill_rel_err",))):
        for k in keys:
            if not r0[name][k] <= ZOO_TP_TOL:
                failed.append(f"{name} {k} {r0[name][k]} > {ZOO_TP_TOL}")
    emit({"phase": "zoo_tp_phase", "launches": counts, "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    if failed:
        raise AssertionError(f"phase 4l: {failed}")
    return counts


def zoo_nccl1(torch, mesh, smi: str) -> dict:
    """Phase 4l on an NCCL world of one (``mesh``, in ``svc_nccl1``):
    Zamba2-1.2B whole, the fp32 B1 S ZOO_TP_S prefill and ZOO_TP_STEPS
    decode steps through the mesh's (1, 1) path against ``mesh=None``:
    equal bit for bit (a model axis of one rank is the path of one
    device)."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo

    cfg = registry.get("zamba2-1.2b").replace(dtype="float32")
    params = zoo.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (1, ZOO_TP_S), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
    with torch.inference_mode():
        out = {}
        for label, m in (("none", None), ("mesh", mesh)):
            local = params if m is None else zoo.shard_params(params, cfg, m)
            out[label] = (zoo.forward(local, cfg, {"tokens": tok},
                                      mesh=m)[0],
                          zoo_decode(torch, local, cfg, tok, m)[0])
    rec = {"phase": "zoo_tp", "model": "zamba2", "world": 1,
           "backend": mesh.backend, "nvidia_smi": smi,
           "prefill_equal": bool(torch.equal(out["mesh"][0],
                                             out["none"][0])),
           "decode_equal": bool(torch.equal(out["mesh"][1],
                                            out["none"][1]))}
    emit(rec)
    del params, out
    torch.cuda.empty_cache()
    if mesh.backend != "nccl" or not (rec["prefill_equal"]
                                      and rec["decode_equal"]):
        raise AssertionError(f"phase 4l: the NCCL world of one differs from "
                             f"mesh=None: {rec}")
    train = zoo_train_nccl1(torch, mesh, smi)
    return {**rec, "train_equal": train["train_equal"]}


def zoo_train_nccl1(torch, mesh, smi: str) -> dict:
    """Phase 4m on the NCCL world of one (``mesh``, in ``svc_nccl1``): one
    ``train_step`` of Zamba2-1.2B cut to ZOO_TRAIN_NCCL1_LAYERS layers
    (bf16 activations, fp32 state, B1 S ZOO_TRAIN_S) through the (1, 1)
    path against ``mesh=None`` from the same state: the loss, params and
    moments equal bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves

    cfg = registry.get("zamba2-1.2b").replace(
        n_layers=ZOO_TRAIN_NCCL1_LAYERS)
    batch = lm_batch(torch.Generator(device="cuda").manual_seed(6), cfg, 1,
                     ZOO_TRAIN_S, "cuda")
    out = {}
    for label, m in (("none", None), ("mesh", mesh)):
        st = zoo.init_train_state(torch.Generator(device="cuda")
                                  .manual_seed(0), cfg, device="cuda",
                                  mesh=m)
        st, met = zoo.train_step(st, batch, cfg, mesh=m)
        out[label] = (met["loss"], st)
    equal = bool(torch.equal(out["mesh"][0], out["none"][0])) and all(
        torch.equal(a, b) for key in ("params", "mu", "nu")
        for a, b in zip(tree_leaves(out["mesh"][1][key]),
                        tree_leaves(out["none"][1][key])))
    rec = {"phase": "zoo_train_tp", "model": "zamba2", "world": 1,
           "backend": mesh.backend, "nvidia_smi": smi,
           "reduced": f"n_layers 38 -> {cfg.n_layers}",
           "loss": float(out["none"][0]), "train_equal": equal}
    emit(rec)
    del out
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"phase 4m: the NCCL world of one's train step "
                             f"differs from mesh=None: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Phase 4m: the zoo's training over a model axis on two and four ranks
# sharing the card
# ---------------------------------------------------------------------------

def whole_leaf(t, spec, mesh):
    """A rank's block of a leaf placed by ``spec`` gathered whole on every
    rank: its model dims over the model group, then its "data" dims over
    the data axis (an entry of both counts the data axis first)."""
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (e,)
        if "model" in axes:
            t = mesh.model_gather(t.contiguous(), d)
        if "data" in axes:
            t = mesh.fsdp_gather(t.contiguous(), d)
    return t


def zoo_train_ref(torch, cfg, batch) -> dict:
    """One device's run from the state of seed 0: the loss, each leaf's
    gradient (on the host) and two ``train_step``s' losses."""
    import gc

    from repro_torch.models import zoo

    st = zoo.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    loss, _, grads = zoo.loss_and_grads(st["params"], cfg, batch)
    grads = [g.cpu() for g in grads]
    losses = []
    for _ in range(2):
        st, m = zoo.train_step(st, batch, cfg)
        losses.append(float(m["loss"]))
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": float(loss), "grads": grads, "losses": losses}


def zoo_train_mesh(torch, cfg, batch, mesh, ref, flags: dict):
    """The same run on the rank's blocks of the state of seed 0
    (``init_train_state(mesh=)`` with ``flags``' layout) and its rows of
    ``batch``: the loss and the steps' losses (equal on every rank), each
    leaf's gradient gathered whole and held to ``ref``'s on rank 0 (max
    |Δ| over the leaf's max |ref|). -> (record, the state after the
    steps)."""
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves
    from repro_torch.sharding import specs as sh

    layout = {k: flags.get(k, False) for k in ("zero", "fsdp", "moe_2d")}
    bom = flags.get("batch_over_model", False)
    st = zoo.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda", mesh=mesh, **layout)
    mine = sh.tree_blocks(batch, sh.data_specs(batch, mesh,
                                               include_model=bom), mesh)
    kw = dict(fsdp=layout["fsdp"], moe_2d=layout["moe_2d"],
              batch_over_model=bom)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = zoo.loss_and_grads(st["params"], cfg, mine, mesh, **kw)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    specs = zoo._spec_leaves(zoo._state_specs(cfg, mesh, **layout)["params"])
    worst = 0.0
    for i, (g, spec) in enumerate(zip(grads, specs)):
        w = whole_leaf(g, spec, mesh)
        if ref is not None:
            r = ref["grads"][i].to(w.device)
            worst = max(worst, float((w.float() - r.float()).abs().max()
                                     / r.float().abs().max().clamp_min(1e-30)))
        grads[i] = w = None
    losses = []
    for _ in range(2):
        st, m = zoo.train_step(st, mine, cfg, mesh=mesh, **flags)
        losses.append(float(m["loss"]))
    mesh.same_on_every_rank("the train losses", torch.tensor(
        [float(loss)] + losses, dtype=torch.float64))
    rec = {"flags": sorted(k for k, v in flags.items() if v), "loss":
           float(loss), "losses": losses, "grad_ms": grad_ms,
           "finite": all(math.isfinite(x) for x in [float(loss)] + losses),
           "state_bytes": sum(t.nbytes for key in ("params", "mu", "nu")
                              for t in tree_leaves(st[key]))}
    if ref is not None:
        rec.update(loss_rel_err=abs(float(loss) - ref["loss"])
                   / max(abs(ref["loss"]), 1e-30), grad_rel_err=worst,
                   step2_loss_rel_err=abs(losses[1] - ref["losses"][1])
                   / max(abs(ref["losses"][1]), 1e-30),
                   one_device_loss=ref["loss"],
                   one_device_losses=ref["losses"])
    return rec, st


def zoo_train_bf16(torch, cfg, state, batch, mesh=None) -> dict:
    """A bf16 step's ms (host clock, synchronised; the median of
    ZOO_TRAIN_TIMED after a warm-up), the peak over them, and a counted
    step's launches, on ``state`` (the rank's blocks on ``mesh``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.sharding import specs as sh

    mine = batch if mesh is None else sh.tree_blocks(
        batch, sh.data_specs(batch, mesh), mesh)
    state, _ = zoo.train_step(state, mine, cfg, mesh=mesh)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(ZOO_TRAIN_TIMED):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = zoo.train_step(state, mine, cfg, mesh=mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"bf16_step_ms_each": ms, "bf16_step_ms": statistics.median(ms),
            "bf16_loss": float(m["loss"]),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "backward": ops.backward_launch_counts(),
            "backward_routes": ops.backward_route_counts()}


def zoo_train_zamba2(torch, mesh) -> dict:
    """Zamba2-1.2B whole on (1, 2): the fp32 B1 S ZOO_TRAIN_S run against
    one device's (rank 0 alone first, the other rank waiting), then the
    bf16 B1 S ZOO_TRAIN_BF16_S step's ms, peak and launches on each rank
    against one device's."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import zoo

    cfg = registry.get("zamba2-1.2b")
    f32 = cfg.replace(dtype="float32")
    g = torch.Generator(device="cuda")
    b32 = lm_batch(g.manual_seed(7), f32, 1, ZOO_TRAIN_S, "cuda")
    b16 = lm_batch(g.manual_seed(8), cfg, 1, ZOO_TRAIN_BF16_S, "cuda")
    ref = one = None
    if mesh.rank == 0:
        ref = zoo_train_ref(torch, f32, b32)
        st = zoo.init_train_state(torch.Generator(device="cuda")
                                  .manual_seed(0), cfg, device="cuda")
        one = zoo_train_bf16(torch, cfg, st, b16)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    mesh.barrier()
    rec, st = zoo_train_mesh(torch, f32, b32, mesh, ref, {})
    rec.update(zoo_train_bf16(torch, cfg, st, b16, mesh))
    if one is not None:
        rec["one_device"] = one
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def zoo_train_cut(torch, mesh, arch: str, layers: int, runs: tuple) -> dict:
    """``arch`` at its published widths cut to ``layers`` layers, fp32, on
    (2, 2): one device's run (rank 0 alone first), then each layout of
    ``runs`` on the ranks' blocks; a layout's params after its steps equal
    the plain layout's (cut to its blocks) bit for bit where the layout
    only moves where the state lies."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.launch.train import lm_batch
    from repro_torch.models.modules import tree_leaves

    published = registry.get(arch)
    cfg = published.replace(dtype="float32", n_layers=layers)
    batch = lm_batch(torch.Generator(device="cuda").manual_seed(9), cfg,
                     ZOO_TRAIN_B, ZOO_TRAIN_S, "cuda")
    ref = zoo_train_ref(torch, cfg, batch) if mesh.rank == 0 else None
    mesh.barrier()
    out, plain = {"reduced": f"n_layers {published.n_layers} -> {layers}"}, \
        None
    for flags in runs:
        rec, st = zoo_train_mesh(torch, cfg, batch, mesh, ref, flags)
        name = "_".join(rec["flags"]) or "plain"
        if not flags:
            plain = st["params"]
        elif plain is not None and not flags.get("moe_2d"):
            rec["params_equal_plain"] = all(
                torch.equal(a, plain_cut(b, a, mesh.fsdp_index))
                for a, b in zip(tree_leaves(st["params"]),
                                tree_leaves(plain)))
        if flags.get("moe_2d"):
            rec["experts_a_rank"] = int(
                st["params"]["blocks"]["moe"]["w_up"].shape[1])
        out[name] = rec
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return out


def plain_cut(t, like, index: int):
    """A plain layout's param block ``t`` cut to ``like``'s shape along the
    one dim ZeRO-3 splits over "data" (block ``index``, the rank's place
    on the data axis): the same tensor where the shapes agree."""
    for d, (a, b) in enumerate(zip(t.shape, like.shape)):
        if a != b:
            return t.narrow(d, index * b, b)
    return t


def zoo_train_rank_main(rank: int, world: int, store: str, out: str,
                        which: str) -> int:
    """A phase-4m rank (a process of its own) over gloo: ``"zamba2"`` on
    (1, ZOO_TP_MODEL), ``"cut"`` (Gemma-2B plain, ZeRO-1 and ZeRO-3;
    Granite-MoE-1B with 2-D experts) on (world / ZOO_TP_MODEL,
    ZOO_TP_MODEL). Writes ``out``.json."""
    import torch

    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                local_rank=rank, local_world=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world // ZOO_TP_MODEL, ZOO_TP_MODEL)
        recs = {"backend": mesh.backend, "device": str(mesh.device),
                "mesh": f"{world // ZOO_TP_MODEL}x{ZOO_TP_MODEL}"}
        jobs = ((("zamba2", lambda: zoo_train_zamba2(torch, mesh)),)
                if which == "zamba2" else
                (("gemma", lambda: zoo_train_cut(
                    torch, mesh, "gemma-2b", ZOO_TRAIN_GEMMA_LAYERS,
                    ({}, {"zero": True}, {"fsdp": True}))),
                 ("granite_moe", lambda: zoo_train_cut(
                     torch, mesh, "granite-moe-1b-a400m",
                     ZOO_TRAIN_GRANITE_LAYERS, ({"moe_2d": True},)))))
        for name, fn in jobs:
            t0 = time.perf_counter()
            recs[name] = fn()
            recs[name]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        Path(out + ".json").write_text(json.dumps(recs))
    finally:
        mesh_lib.destroy_process_group()
    return 0


def zoo_train_ranks() -> None:
    """Phase 4m's rank sets in ``build/zoo_train``, once ``ZOO_TRAIN_GO``
    is set (6d waits for them): two ranks as (1, 2), then four as (2, 2);
    any rank's failure fails the phase (``run_ranks``)."""
    ZOO_TRAIN_GO.wait()
    d = ROOT / "build" / "zoo_train"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    run_ranks("zoo_train_rank_main", ZOO_TP_MODEL, d, "store2", ("zamba2",),
              ZOO_TRAIN_TIMEOUT_S, 0, "phase 4m (1, 2)")
    for r in range(ZOO_TP_MODEL):
        (d / f"rank{r}.json").rename(d / f"zamba2_rank{r}.json")
    run_ranks("zoo_train_rank_main", 2 * ZOO_TP_MODEL, d, "store4", ("cut",),
              ZOO_TRAIN_TIMEOUT_S, 0, "phase 4m (2, 2)")


def zoo_train_phase(torch, lane: Lane, smi: str) -> dict:
    """Phase 4m: the ranks' records checked here: rank 0's loss, gathered
    gradients and second step's loss within ZOO_TRAIN_TOL of one device's
    (each leaf's max |Δ| over its max |ref|; the losses relative), every
    loss finite, the gloo backend on one card, ZeRO-1 / ZeRO-3's params
    equal to the plain layout's on every rank, each rank's counted bf16
    Zamba2 step launching swa_attention_bwd (``tc``) once a shared-block
    application and ssd_intra_chunk_bwd once a layer on its local heads.
    Returns the launch counts of the ranks' counted steps."""
    t_phase = time.perf_counter()
    spawn_s = lane.wait("zoo_train_tp")
    d = ROOT / "build" / "zoo_train"
    z = [json.loads((d / f"zamba2_rank{r}.json").read_text())
         for r in range(ZOO_TP_MODEL)]
    cut = [json.loads((d / f"rank{r}.json").read_text())
           for r in range(2 * ZOO_TP_MODEL)]
    want_bwd = {"swa_attention_bwd": 6, "ssd_intra_chunk_bwd": 38}
    want_routes = {"swa_attention_bwd.tc": 6, "swa_attention_bwd.fp32": 0}
    failed, counts = [], {}
    for r, rec in enumerate(z):
        emit({"phase": "zoo_train_tp", "model": "zamba2", "rank": r,
              "mesh": rec["mesh"], "backend": rec["backend"],
              "device": rec["device"], "nvidia_smi": smi, **rec["zamba2"]})
        zr = rec["zamba2"]
        if zr["backward"] != want_bwd or zr["backward_routes"] != \
                want_routes:
            failed.append(f"zamba2 rank {r}: a bf16 step launched "
                          f"{zr['backward']} {zr['backward_routes']}")
        for k, v in {**zr["launches"], **zr["backward_routes"],
                     **zr["backward"]}.items():
            counts[k] = counts.get(k, 0) + v
    for r, rec in enumerate(cut):
        for name in ("gemma", "granite_moe"):
            emit({"phase": "zoo_train_tp", "model": name, "rank": r,
                  "mesh": rec["mesh"], "backend": rec["backend"],
                  "device": rec["device"], "nvidia_smi": smi, **rec[name]})
            for run, v in rec[name].items():
                if isinstance(v, dict) and v.get("params_equal_plain") is \
                        False:
                    failed.append(f"{name} rank {r} {run}: params differ "
                                  "from the plain layout's")
    runs = [("zamba2", z[0]["zamba2"])] + [
        (f"{name} {run}", v) for name in ("gemma", "granite_moe")
        for run, v in cut[0][name].items() if isinstance(v, dict)]
    for label, rec in runs:
        keys = ["loss_rel_err", "grad_rel_err", "step2_loss_rel_err"]
        for k in keys:
            if not rec[k] <= ZOO_TRAIN_TOL:
                failed.append(f"{label} {k} {rec[k]} > {ZOO_TRAIN_TOL}")
        if not rec["finite"]:
            failed.append(f"{label}: a loss is not finite")
    from repro_torch.configs import registry
    want_e = registry.get("granite-moe-1b-a400m").n_experts // len(cut)
    for rec in z + cut:
        if rec["backend"] != "gloo":
            failed.append(f"backend {rec['backend']}")
    for r, rec in enumerate(cut):
        got_e = rec["granite_moe"]["moe_2d"]["experts_a_rank"]
        if got_e != want_e:
            failed.append(f"granite_moe rank {r}: {got_e} experts, not "
                          f"{want_e}")
    if z[0]["zamba2"]["one_device"]["backward"] != want_bwd:
        failed.append("zamba2 one device's bf16 step launched "
                      f"{z[0]['zamba2']['one_device']['backward']}")
    emit({"phase": "zoo_train_phase", "launches": counts,
          "spawn_s": spawn_s, "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    if failed:
        raise AssertionError(f"phase 4m: {failed}")
    return counts


def population_run(torch, prefetch: int):
    """Phase 4e-ii: the reference population bench's setup on the card:
    ``virtual_synthetic(alpha=1, beta=1, seed=0, n_clients=100_000)`` (LRU
    backend) with ``mclr(60, 10)``, FedGroup (EDC), m = 5, α = 20, K = 50,
    E = 4, B = 10, lr = 0.05, eval every 5th round over 2,000 clients,
    10,000 clients active at the start and Poisson(5) arrivals a round,
    POP_ROUNDS rounds. Returns the run's record, the history and the
    membership after each round."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import virtual_synthetic
    from repro_torch.fed.engine import FedConfig
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.models.paper_models import mclr

    rss_before = host_rss_bytes()
    t0 = time.perf_counter()
    store = virtual_synthetic(alpha=1, beta=1, seed=0,
                              n_clients=POP_CLIENTS)
    setup_s = time.perf_counter() - t0
    pop = Population(store, PopulationConfig(
        initial_active=10_000, arrival_rate=5.0, prefetch=prefetch,
        eval_clients=2_000, eval_batch=512))
    cfg = FedConfig(n_rounds=POP_ROUNDS, clients_per_round=50,
                    local_epochs=4, batch_size=10, lr=0.05, n_groups=5,
                    pretrain_scale=20, eval_every=5, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()   # earlier phases' live tensors
    tr = FedGroupTrainer(mclr(60, 10), None, cfg, device="cuda",
                         population=pop)
    ms, mem, cold, arrivals, stage = [], [], [], [], []
    for _ in range(POP_ROUNDS):
        t1 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        mem.append(tr.membership.copy())
        cold.append(tr.last_cold)
        arrivals.append(pop._cohort.n_new)
        stage.append(pop._cohort.stage_ms)
    rounds = list(tr.history.rounds)
    tr.close()
    labels = tr.membership[tr.membership >= 0]
    finite = all(math.isfinite(r.mean_loss) and math.isfinite(r.discrepancy)
                 and (math.isfinite(r.weighted_acc)
                      or not tr._should_eval(r.round)) for r in rounds)
    rec = {"phase": "population", "prefetch": prefetch,
           "store": store.name, "n_clients": POP_CLIENTS, "K": 50, "E": 4,
           "m": 5, "alpha": 20, "d_w": tr.model_size,
           "rounds": POP_ROUNDS, "store_setup_s": setup_s,
           "round_ms": ms, "stage_ms": stage, "cold_started": cold,
           "arrivals_in_cohort": arrivals,
           "active_clients": int(pop.scheduler.active.sum()),
           "assigned_clients": int(len(labels)),
           "generated_clients": store.generated_clients,
           "host_rows_touched": pop.state.touched_rows(),
           "host_rss_bytes_before": rss_before,
           "host_rss_bytes_after": host_rss_bytes(),
           "peak_host_rss_bytes": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024,
           "device_bytes_before": before,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "labels_in_range": bool(((labels >= 0) & (labels < 5)).all()),
           "metrics_finite": finite,
           "acc": [None if math.isnan(r.weighted_acc) else r.weighted_acc
                   for r in rounds],
           "loss": [r.mean_loss for r in rounds]}
    emit(rec)
    if not rec["labels_in_range"] or not finite:
        raise AssertionError(f"population prefetch={prefetch}: labels or "
                             "metrics out of range")
    if sum(cold) == 0 or sum(arrivals) == 0:
        raise AssertionError(f"population prefetch={prefetch}: no newcomer "
                             "was cold-started in any round")
    return rec, rounds, mem


def population_phase(torch):
    """Phase 4e-ii, once for each prefetch depth of POP_ORDER: every run
    must give the first run's membership every round and its metrics
    within STREAM_RTOL. Prints each run's median round ms over rounds
    t >= 1 (round 0 holds the cold start): the first run's apart, then
    each depth's over the runs after it, which take turns (2, 0, 0, 2) so
    host drift between runs falls on both."""
    runs = [population_run(torch, prefetch) for prefetch in POP_ORDER]
    _, first_rounds, first_mem = runs[0]
    dev = {"acc": 0.0, "loss": 0.0, "disc": 0.0}
    mem_ok = True
    for _, rounds, mem in runs[1:]:
        for k, v in max_rel_dev(first_rounds, rounds).items():
            dev[k] = max(dev[k], v)
        mem_ok &= all(bool((x == y).all()) for x, y in zip(first_mem, mem))
    def median(rec):
        ms = sorted(rec["round_ms"][1:])
        return ms[len(ms) // 2]

    medians = {f"prefetch_{p}": [] for p in sorted(set(POP_ORDER[1:]))}
    for (rec, _, _), prefetch in zip(runs[1:], POP_ORDER[1:]):
        medians[f"prefetch_{prefetch}"].append(median(rec))
    emit({"phase": "population_compare", "order": list(POP_ORDER),
          "membership_equal": mem_ok, "max_rel_dev": dev,
          "rtol": STREAM_RTOL,
          "first_run_round_ms_median": median(runs[0][0]),
          "round_ms_median_t_ge_1": medians})
    if not mem_ok or max(dev.values()) > STREAM_RTOL:
        raise AssertionError(f"population: the prefetch depths differ "
                             f"({dev}, membership equal: {mem_ok})")


def zamba2_params(torch):
    """Phase 6: Zamba2-1.2B at its published widths, random from seed 0."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.models.modules import param_count

    cfg = registry.get("zamba2-1.2b")
    t0 = time.perf_counter()
    params = zoo.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    torch.cuda.synchronize()
    n = param_count(params)
    emit({"phase": "zamba2_config", "arch": cfg.name, "source": cfg.source,
          "params": n, "param_dtype": cfg.param_dtype,
          "act_dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "shared_attn_period":
          cfg.shared_attn_period, "init_s": time.perf_counter() - t0,
          "note": "weights random from seed 0 (no checkpoint in the repo); "
                  "no depth or width cut"})
    if n != 1_170_473_856:
        raise AssertionError(f"Zamba2-1.2B has {n} params, not 1,170,473,856")
    return cfg, params


def expected_launches(torch, cfg) -> dict:
    """One Zamba2 forward: an SSD launch per Mamba2 layer, a SWA launch per
    application of the shared block, on the route of the config's dtype
    (bf16: the tensor cores; fp32: the CUDA cores)."""
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.kernels import swa_attention as swa_mod

    dt = getattr(torch, cfg.dtype)
    n_swa, n_ssd = cfg.n_layers // cfg.shared_attn_period, cfg.n_layers
    route = swa_mod._route(dt, dt, cfg.head_dim)
    ssd_route = ssd_mod._route(dt, dt, cfg.ssd_chunk, cfg.ssm_head_dim,
                               cfg.ssm_state)
    return {"edc_cosine": 0, "madc": 0, "ssd_intra_chunk": n_ssd,
            "swa_attention": n_swa,
            "swa_attention.tc": n_swa if route == "tc" else 0,
            "swa_attention.fp32": n_swa if route == "fp32" else 0,
            "ssd_intra_chunk.tc": n_ssd if ssd_route == "tc" else 0,
            "ssd_intra_chunk.fp32": n_ssd if ssd_route == "fp32" else 0}


def zamba2_prefill(torch, cfg, params):
    """Phase 6: the prefill ``forward`` at B=4, S=2048, bf16, with and
    without a 512 window. Returns the launches of the counted forwards."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    tok = torch.randint(0, cfg.vocab_size, (ZAMBA_B, ZAMBA_S),
                        generator=torch.Generator(device="cuda").manual_seed(
                            2), device="cuda")
    total = {}
    for label, c in (("full", cfg), ("window512", cfg.with_window(512))):
        with torch.inference_mode():
            def fwd():
                return zoo.forward(params, c, {"tokens": tok})[0]
            fwd()                                       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            logits = fwd()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(logits).all())
            shape = list(logits.shape)
            del logits
            ms = cuda_ms(torch, fwd, 3, warmup=0)
        emit({"phase": "zamba2_prefill", "case": label, "B": ZAMBA_B,
              "S": ZAMBA_S, "window": c.window, "dtype": c.dtype,
              "forward_ms": ms, "tokens_per_s": ZAMBA_B * ZAMBA_S / ms * 1e3,
              "logits_shape": shape, "finite": finite,
              "peak_device_bytes": peak, "launches": counts})
        if not finite:
            raise AssertionError(f"zamba2 prefill {label}: non-finite logits")
        if counts != expected_launches(torch, c):
            raise AssertionError(f"zamba2 prefill {label}: launches {counts},"
                                 f" expected {expected_launches(torch, c)}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if total["swa_attention.tc"] < 12:
        raise AssertionError("the counted bf16 prefills launched the "
                             "tensor-core swa_attention route "
                             f"{total['swa_attention.tc']} times, not >= 12")
    if total["ssd_intra_chunk.tc"] != 76:
        raise AssertionError("the counted bf16 prefills launched the "
                             "tensor-core ssd_intra_chunk route "
                             f"{total['ssd_intra_chunk.tc']} times, not 76")
    return total


def device_summary(torch, prof, wall_ms: float, avgs=None) -> dict:
    """Device time by kernel from a torch.profiler run (``avgs`` its
    ``key_averages()`` where the caller has them): busy share, the two zoo
    kernels' share, launches, the top kernels, and the host ops with the
    most self CPU time. None where the profiler saw no device activity
    (not measured)."""
    from torch.autograd import DeviceType

    if avgs is None:
        avgs = prof.key_averages()
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA]
    if not kern:
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    busy = sum(e.self_device_time_total for e in kern) / 1e3

    def share(*names):
        t = sum(e.self_device_time_total for e in kern
                if any(n in e.key for n in names)) / 1e3
        return t, t / busy

    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    swa_tc_ms, swa_tc_share = share("swa_tc_kernel")
    swa_f32_ms, swa_f32_share = share("swa_kernel", "swa_combine_kernel")
    ssd_tc_ms, ssd_tc_share = share("ssd_tc_kernel")
    ssd_f32_ms, ssd_f32_share = share("ssd_kernel", "ssd_cell_kernel")
    gemm_ms, gemm_share = share("gemm", "Gemm", "nvjet", "sm90_xmma",
                                "cutlass")
    copy_ms, copy_share = share("copy", "Copy")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "kernel_launches": sum(e.count for e in kern),
            "swa_ms": swa_tc_ms + swa_f32_ms,
            "swa_share": swa_tc_share + swa_f32_share,
            "swa_ms_by_route": {"tc": swa_tc_ms, "fp32": swa_f32_ms},
            "swa_share_by_route": {"tc": swa_tc_share, "fp32": swa_f32_share},
            "ssd_ms": ssd_tc_ms + ssd_f32_ms,
            "ssd_share": ssd_tc_share + ssd_f32_share,
            "ssd_ms_by_route": {"tc": ssd_tc_ms, "fp32": ssd_f32_ms},
            "gemm_ms": gemm_ms, "gemm_share": gemm_share,
            "copy_cast_ms": copy_ms, "copy_cast_share": copy_share,
            "top_kernels": [[e.key[:90], e.count,
                             e.self_device_time_total / 1e3] for e in top],
            "top_host_ops": [[e.key[:60], e.count,
                              e.self_cpu_time_total / 1e3] for e in host]}


def zamba2_profile(torch, cfg, params):
    """Phase 6: where the time goes — one prefill forward and one decode
    step (B=4, after a 32-token prompt) under torch.profiler; decode ms per
    step on the host clock over 16 steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import zoo

    tok = torch.randint(0, cfg.vocab_size, (ZAMBA_B, ZAMBA_S),
                        generator=torch.Generator(device="cuda").manual_seed(
                            3), device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            zoo.forward(params, cfg, {"tokens": tok})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        emit({"phase": "zamba2_profile", "what": "prefill forward B=4 "
              "S=2048 bf16", **device_summary(torch, prof, wall)})

        cache = zoo.init_cache(cfg, ZAMBA_B, 64, device="cuda")
        step = 0

        def decode():
            nonlocal cache, step
            pos = torch.full((ZAMBA_B,), step, device="cuda")
            lg, cache = zoo.serve_step(params, cfg, cache,
                                       tok[:, step:step + 1], pos)
            step += 1
            return lg
        for _ in range(32):                              # the prompt
            decode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            decode()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 16
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        emit({"phase": "zamba2_profile", "what": "one decode step B=4 bf16",
              "decode_step_ms": step_ms, **device_summary(torch, prof, wall)})


def zamba2_consistency(torch, cfg, params):
    """Phase 6: fp32, B=1, S=256 (two SSD chunks): ``forward`` through both
    kernels against 256 ``serve_step`` calls (recurrent Mamba2, cached
    attention, no kernel), within 2e-3, with and without a 64 window."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    c32 = cfg.replace(dtype="float32")
    S = CONSIST_S
    total = {}
    tok = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator(device="cuda").manual_seed(
                            4), device="cuda")
    for window in (None, 64):
        c = c32 if window is None else c32.with_window(window)
        with torch.inference_mode():
            ops.reset_launch_counts()
            full = zoo.forward(params, c, {"tokens": tok})[0]
            torch.cuda.synchronize()
            fwd_counts = ops.launch_counts()
            cache = zoo.init_cache(c, 1, window or S, device="cuda")
            outs = []
            t0 = time.perf_counter()
            for t in range(S):
                lg, cache = zoo.serve_step(
                    params, c, cache, tok[:, t:t + 1],
                    torch.full((1,), t, device="cuda"))
                outs.append(lg)
            dec = torch.stack(outs, 1)
            torch.cuda.synchronize()
            serve_ms = (time.perf_counter() - t0) * 1e3
            serve_counts = ops.launch_counts()
        err, ok = allclose_err(torch, dec, full, CONSIST_TOL, CONSIST_TOL)
        emit({"phase": "zamba2_consistency", "B": 1, "S": S,
              "window": window, "cache_slots": window or S,
              "dtype": "float32", "max_abs_err": err, "tol": CONSIST_TOL,
              "max_abs_logit": float(full.abs().max()), "ok": ok,
              "forward_launches": fwd_counts,
              "serve_launches_added": {k: serve_counts[k] - fwd_counts[k]
                                       for k in fwd_counts},
              "serve_steps_ms": serve_ms})
        if not ok:
            raise AssertionError(f"zamba2 consistency window={window}: "
                                 f"max abs err {err}")
        if (fwd_counts != expected_launches(torch, c)
                or serve_counts != fwd_counts):
            raise AssertionError(f"zamba2 consistency window={window}: "
                                 f"launches {fwd_counts} / {serve_counts}")
        for k, v in fwd_counts.items():
            total[k] = total.get(k, 0) + v
    return total


def serve_cli(phase: str, arch=None, extra=()) -> dict:
    """The serving CLI at full width (``--arch arch``, or its default; its
    smoke variant with ``extra=["--smoke"]``), in a child process: B=4, a
    32-token prompt, 32 generated."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
    cmd += ["--arch", arch] if arch else []
    cmd += ["--batch", "4", "--prompt-len", "32", "--gen", "32", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    m = re.search(r"prefill ([\d.]+)ms\s+decode ([\d.]+)ms \(([\d.]+) tok/s\)",
                  proc.stdout)
    rec = {"phase": phase, "cmd": " ".join(cmd[1:]),
           "rc": proc.returncode, "stdout": proc.stdout.splitlines(),
           "prefill_ms": float(m.group(1)) if m else None,
           "decode_ms": float(m.group(2)) if m else None,
           "decode_tok_s": float(m.group(3)) if m else None,
           "child_s": time.perf_counter() - t0}
    emit(rec)
    if proc.returncode != 0 or m is None:
        raise AssertionError(f"serve CLI failed:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    return rec


def zamba2_serve():
    """Phase 6: the serving CLI at full width, in a child process."""
    serve_cli("zamba2_serve", "zamba2-1.2b")


# ---------------------------------------------------------------------------
# phase 6b: the zoo's attention families
# ---------------------------------------------------------------------------

def family_params(torch, arch: str, cut_params=None, **cut):
    """Phase 6b, 6c: ``arch`` at its published widths, random from seed 0,
    cut (``cut``: fewer layers, fewer experts) where its fp32 weights would
    not leave room on one card; the published config's param count is
    checked on ``meta``, and the cut's on the card against ``cut_params``
    where given. ``mtp=True`` in ``cut`` turns DeepSeek's MTP head on (an
    addition, not a cut)."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.models.modules import param_count

    cfg = registry.get(arch)
    full = param_count(zoo.init_params(None, cfg, device="meta"))
    if full != FAMILY_PARAMS[arch]:
        raise AssertionError(f"{arch} has {full} params, not "
                             f"{FAMILY_PARAMS[arch]:,}")
    published = cfg
    cfg = cfg.replace(**cut)
    reduced = [f"{k} {getattr(published, k)} -> {v}: fp32 weights of "
               f"{full * 4 / 1e9:.1f} GB in full leave no room on one card "
               "for the casts and activations"
               for k, v in cut.items() if k in ("n_layers", "n_experts")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = zoo.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    torch.cuda.synchronize()
    n = param_count(params)
    emit({"phase": "family_config", "arch": arch, "family": cfg.family,
          "source": cfg.source, "params_full_depth": full,
          "params_on_card": n, "param_bytes": n * 4,
          "n_layers": cfg.n_layers, "n_layers_published": published.n_layers,
          "reduced": reduced, "mtp": cfg.mtp,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
          "d_ff": cfg.moe_d_ff or cfg.d_ff, "vocab": cfg.vocab_size,
          "mlp": f"{cfg.mlp_act}{' gated' if cfg.mlp_gated else ''}",
          "causal": cfg.causal, "tied": cfg.tie_embeddings,
          "init_s": time.perf_counter() - t0,
          "note": "weights random from seed 0 (no checkpoint in the repo)"})
    if cut_params is not None and n != cut_params:
        raise AssertionError(f"{arch} cut {cut} has {n} params on the card, "
                             f"not {cut_params:,}")
    return cfg, params


def family_inputs(torch, cfg, B: int, S: int, seed: int, patches=None):
    """A batch of S positions: frames (audio), or tokens, a VLM's
    ``patches`` patch embeddings (the config's by default) before S −
    patches text tokens."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        return {"frames": torch.randn((B, S, cfg.frontend_dim), generator=gen,
                                      device="cuda").to(dt)}
    n = 0
    batch = {}
    if cfg.family == "vlm":
        n = cfg.n_patches if patches is None else patches
        batch["patch_embeds"] = torch.randn(
            (B, n, cfg.frontend_dim), generator=gen, device="cuda").to(dt)
    batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S - n),
                                    generator=gen, device="cuda")
    return batch


def family_launches(torch, cfg) -> dict:
    """One forward of a family without Mamba2: a swa_attention launch per
    layer, on the route of the config's dtype and head dim; none for MLA
    and xLSTM (plain PyTorch, as in the JAX package)."""
    from repro_torch.kernels import swa_attention as swa_mod

    dt = getattr(torch, cfg.dtype)
    route = swa_mod._route(dt, dt, cfg.hd)
    n = 0 if cfg.mla or cfg.family == "ssm" else cfg.n_layers
    return {"edc_cosine": 0, "madc": 0, "ssd_intra_chunk": 0,
            "swa_attention": n,
            "swa_attention.tc": n if route == "tc" else 0,
            "swa_attention.fp32": n if route == "fp32" else 0,
            "ssd_intra_chunk.tc": 0, "ssd_intra_chunk.fp32": 0}


def family_prefill(torch, cfg, params, B: int, S: int, label: str,
                   route: str, iters: int = 3) -> dict:
    """Phase 6b, 6c: a bf16 ``forward`` of B × S positions: ms (CUDA
    events, warmed), finite logits and aux, peak memory, launches by route
    (fails unless one launch per layer on ``route``; ``route=None``: a
    family without the kernel, no launch). Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    batch = family_inputs(torch, cfg, B, S, seed=5)
    with torch.inference_mode():
        def fwd():
            return zoo.forward(params, cfg, batch)
        fwd()                                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        logits, aux = fwd()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(v).all()) for v in aux.values())
        shape = list(logits.shape)
        aux = {k: float(v) for k, v in aux.items()}
        del logits
        ms = cuda_ms(torch, lambda: fwd()[0], iters, warmup=0)
    rec = {"phase": "family_prefill", "arch": cfg.name, "case": label,
           "B": B, "S": S, "window": cfg.window, "dtype": cfg.dtype,
           "moe_impl": cfg.moe_impl if cfg.family == "moe" else None,
           "forward_ms": ms, "positions_per_s": B * S / ms * 1e3,
           "logits_shape": shape, "finite": finite, "aux": aux,
           "peak_device_bytes": peak, "launches": counts}
    emit(rec)
    if not finite:
        raise AssertionError(f"{cfg.name} {label}: non-finite output")
    want = family_launches(torch, cfg)
    if counts != want or (route and want[f"swa_attention.{route}"]
                          != cfg.n_layers):
        raise AssertionError(f"{cfg.name} {label}: launches {counts}, "
                             f"expected {want} ({route} route)")
    return counts


def family_profile(torch, cfg, params, B: int, S: int, label: str,
                   decode: bool = True, prefill: bool = True):
    """Phase 6b, 6c: one bf16 prefill forward (``prefill``) and
    (``decode``) one decode step (after a 32-token prompt) under
    torch.profiler, where the device time goes; decode ms a step on the
    host clock over 8 steps, and the step's ATen ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = family_inputs(torch, cfg, B, S, seed=6)
    with torch.inference_mode():
        torch.cuda.synchronize()
        if prefill:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                zoo.forward(params, cfg, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            emit({"phase": "family_profile", "arch": cfg.name,
                  "what": f"{label} forward B={B} S={S} {cfg.dtype}",
                  **device_summary(torch, prof, wall)})
        if not decode:
            return
        cache = zoo.init_cache(cfg, B, 64, device="cuda")
        tok = batch["tokens"]

        def step(t):
            return zoo.serve_step(params, cfg, cache, tok[:, t:t + 1],
                                  torch.full((B,), t, device="cuda"))[1]
        for t in range(32):                              # the prompt
            cache = step(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(32, 40):
            cache = step(t)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 8
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(40)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        w_bytes = sum(p.numel() for p in tree_leaves(params)) * 6
        emit({"phase": "family_profile", "arch": cfg.name,
              "what": f"one decode step B={B} {cfg.dtype}",
              "decode_step_ms": step_ms, "weight_cast_bytes": w_bytes,
              "aten_ops": aten_ops(lambda: step(41)),
              "weight_cast_note": "each fp32 weight is read and written "
                                  "as a bf16 copy at every use (4 + 2 "
                                  "bytes a param)",
              **device_summary(torch, prof, wall)})


def family_consistency(torch, cfg, params, S: int, window=None,
                       **replace) -> dict:
    """Phase 6b: fp32, B=1: ``forward`` (the fp32 route) against S
    ``serve_step`` calls (no kernel) within 2e-3; with ``window``, a
    window-slot ring cache. A VLM's forward gets no patches, so both read
    the same text. Returns the forward's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    c = cfg.replace(dtype="float32", **replace)
    if window:
        c = c.with_window(window)
    batch = family_inputs(torch, c, 1, S, seed=7, patches=0)
    tok = batch["tokens"]
    with torch.inference_mode():
        ops.reset_launch_counts()
        full = zoo.forward(params, c, batch)[0]
        torch.cuda.synchronize()
        fwd_counts = ops.launch_counts()
        cache = zoo.init_cache(c, 1, window or S, device="cuda")
        outs = []
        t0 = time.perf_counter()
        for t in range(S):
            lg, cache = zoo.serve_step(params, c, cache, tok[:, t:t + 1],
                                       torch.full((1,), t, device="cuda"))
            outs.append(lg)
        dec = torch.stack(outs, 1)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_counts = ops.launch_counts()
    err, ok = allclose_err(torch, dec, full, CONSIST_TOL, CONSIST_TOL)
    emit({"phase": "family_consistency", "arch": cfg.name, "B": 1, "S": S,
          "n_layers": c.n_layers, "window": window,
          "cache_slots": window or S, "dtype": "float32", **replace,
          "max_abs_err": err, "tol": CONSIST_TOL,
          "max_abs_logit": float(full.abs().max()), "ok": ok,
          "forward_launches": fwd_counts, "serve_steps_ms": serve_ms,
          "serve_step_ms": serve_ms / S})
    del full, dec
    if not ok:
        raise AssertionError(f"{cfg.name} consistency window={window}: max "
                             f"abs err {err}")
    if fwd_counts != family_launches(torch, c) or serve_counts != fwd_counts:
        raise AssertionError(f"{cfg.name} consistency window={window}: "
                             f"launches {fwd_counts} / {serve_counts}")
    return fwd_counts


def family_done(torch, cfg, params, t0: float):
    """Phase 6b: the model's peak memory since its init and its seconds;
    frees its weights."""
    import gc

    emit({"phase": "family_done", "arch": cfg.name,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0})
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()


def moe_load(torch, cfg, params) -> dict:
    """Phase 6b: Granite-MoE's first MoE layer on the prefill batch's
    normed embeddings under both dispatches: each expert load sums to 1."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import zoo
    from repro_torch.models.modules import rmsnorm, tree_index

    p0 = tree_index(params["blocks"], 0)
    batch = family_inputs(torch, cfg, FAMILY_B, FAMILY_S, seed=5)
    out = {}
    with torch.inference_mode():
        x, _ = zoo.embed_inputs(params, cfg, batch)
        xn = rmsnorm(p0["ln2"], x, cfg.norm_eps)
        for impl, fn in (("scatter", moe_lib.moe_apply),
                         ("grouped", moe_lib.moe_apply_grouped)):
            _, a = fn(p0["moe"], xn, top_k=cfg.top_k,
                      capacity_factor=cfg.capacity_factor, act=cfg.mlp_act)
            out[impl] = {"load_sum": float(a.expert_load.sum()),
                         "load_max": float(a.expert_load.max()),
                         "load_balance_loss": float(a.load_balance_loss),
                         "router_z_loss": float(a.router_z_loss)}
    emit({"phase": "family_moe_load", "arch": cfg.name, "layer": 0,
          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "capacity_factor": cfg.capacity_factor, **out})
    for impl, o in out.items():
        if abs(o["load_sum"] - 1.0) > 1e-5:
            raise AssertionError(f"{cfg.name} {impl}: expert load sums to "
                                 f"{o['load_sum']}")


def hubert_serve() -> dict:
    """Phase 6b: the serving CLI with an encoder-only arch: its line and
    exit code 1, as the JAX launcher (in-process: it stops before any
    weight is made)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", "hubert-xlarge"])
    rec = {"phase": "family_serve", "arch": "hubert-xlarge", "rc": rc,
           "stdout": buf.getvalue().splitlines()}
    emit(rec)
    if rc != 1 or rec["stdout"] != ["hubert-xlarge is encoder-only: no "
                                    "decode step"]:
        raise AssertionError(f"hubert serve CLI: rc {rc}, {rec['stdout']}")
    return rec


def family_phase(torch) -> dict:
    """Phase 6b: Gemma-2B, Granite-MoE, InternVL2-1B and HuBERT-XLarge
    whole, GLM-4-9B, Granite-20B and Nemotron-4-15B at 2 layers. Returns
    the launches of the counted forwards (bf16 prefills, fp32 consistency
    forwards)."""
    from repro_torch.configs import shapes

    t_phase = time.perf_counter()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # Gemma-2B whole: prefill, the long_500k window, forward vs serve
    t0 = time.perf_counter()
    cfg, params = family_params(torch, "gemma-2b")
    add(family_prefill(torch, cfg, params, FAMILY_B, FAMILY_S, "prefill",
                       "fp32"))
    long_cfg = shapes.config_for(cfg, shapes.SHAPES["long_500k"])
    add(family_prefill(torch, long_cfg, params, 1, LONG_S, "long_500k",
                       "fp32", iters=1))
    family_profile(torch, cfg, params, FAMILY_B, FAMILY_S, "prefill")
    add(family_consistency(torch, cfg, params, CONSIST_S))
    add(family_consistency(torch, cfg, params, CONSIST_S, window=64))
    family_done(torch, cfg, params, t0)
    serve_cli("family_serve")     # the default arch (~17 GB: not on a lane)
    # Granite-MoE whole: both dispatches, forward vs serve without drops
    t0 = time.perf_counter()
    cfg, params = family_params(torch, "granite-moe-1b-a400m")
    for impl in ("scatter", "grouped"):
        add(family_prefill(torch, cfg.replace(moe_impl=impl), params,
                           FAMILY_B, FAMILY_S, f"prefill-{impl}", "tc"))
    moe_load(torch, cfg, params)
    family_profile(torch, cfg, params, FAMILY_B, FAMILY_S, "prefill-scatter",
                   decode=False)
    add(family_consistency(torch, cfg, params, CONSIST_S,
                           capacity_factor=100.0))
    family_done(torch, cfg, params, t0)
    # InternVL2-1B and HuBERT-XLarge whole
    t0 = time.perf_counter()
    cfg, params = family_params(torch, "internvl2-1b")
    add(family_prefill(torch, cfg, params, FAMILY_B, 1024, "patches+text",
                       "tc"))
    add(family_consistency(torch, cfg, params, 128))
    family_done(torch, cfg, params, t0)
    t0 = time.perf_counter()
    cfg, params = family_params(torch, "hubert-xlarge")
    add(family_prefill(torch, cfg, params, FAMILY_B, 1024, "frames",
                       "fp32"))
    family_done(torch, cfg, params, t0)
    hubert_serve()
    # GLM-4-9B, Granite-20B, Nemotron-4-15B at published widths, 2 layers
    for arch in CUT_ARCHS:
        t0 = time.perf_counter()
        cfg, params = family_params(torch, arch, n_layers=CUT_LAYERS)
        add(family_prefill(torch, cfg, params, 2, FAMILY_S, "prefill", "tc"))
        add(family_consistency(torch, cfg, params, 128))
        family_done(torch, cfg, params, t0)
    emit({"phase": "family_phase", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


# ---------------------------------------------------------------------------
# phase 6c: the zoo's last two families (MLA with the MTP head, xLSTM)
# ---------------------------------------------------------------------------

def deepseek_mtp(torch, cfg, params) -> dict:
    """Phase 6c: bf16 B=2, S=2048: ``forward(return_hidden=True)``, then
    ``mtp_logits`` on its hidden state; the counted MTP call fails the run
    unless it launches exactly one swa_attention, on the ``fp32`` route
    (its dense block's hd 56). Returns the MTP call's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    batch = family_inputs(torch, cfg, DEEPSEEK_B, FAMILY_S, seed=8)
    tok = batch["tokens"]
    with torch.inference_mode():
        _, aux = zoo.forward(params, cfg, batch, return_hidden=True)
        hidden = aux["hidden"]
        del aux

        def mtp():
            return zoo.mtp_logits(params, cfg, hidden, tok)
        mtp()                                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        logits = mtp()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        del logits
        ms = cuda_ms(torch, mtp, 3, warmup=0)
    want = {k: 0 for k in counts}
    want.update({"swa_attention": 1, "swa_attention.fp32": 1})
    emit({"phase": "family_mtp", "arch": cfg.name, "B": DEEPSEEK_B,
          "S": FAMILY_S, "dtype": cfg.dtype, "mtp_head_dim": cfg.hd,
          "mtp_ms": ms, "logits_shape": shape, "finite": finite,
          "peak_device_bytes": peak, "launches": counts})
    if not finite or shape != [DEEPSEEK_B, FAMILY_S - 1, cfg.padded_vocab]:
        raise AssertionError(f"mtp_logits: finite {finite}, shape {shape}")
    if counts != want:
        raise AssertionError(f"mtp_logits launched {counts}, not one "
                             "swa_attention on the fp32 route")
    return counts


def deepseek_q_chunk(torch, cfg, params):
    """Phase 6c: fp32, B=1, S=2048, MLA's prefill in query chunks of 512
    against no chunking: the first layer's ``mla_fwd`` within 1e-5 (its
    ms, CUDA events, and peak memory each), and the whole forward's logits
    equal exactly (the chunks sum nothing in another order, and the MoE
    combine uses no atomics)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import zoo
    from repro_torch.models.modules import rmsnorm, tree_index

    c = cfg.replace(dtype="float32")
    batch = family_inputs(torch, c, 1, Q_CHUNK_S, seed=9)
    p0 = tree_index(params["blocks"], 0)
    layer, logits, rec = {}, {}, {}
    with torch.inference_mode():
        x, _ = zoo.embed_inputs(params, c, batch)
        xn = rmsnorm(p0["ln1"], x, c.norm_eps)
        for qc in (None, Q_CHUNK):
            def mla():
                return attn.mla_fwd(p0["attn"], xn, causal=c.causal,
                                    q_chunk=qc, **zoo._mla_kw(c))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            layer[qc] = mla()
            torch.cuda.synchronize()
            rec[str(qc)] = {"mla_fwd_ms": cuda_ms(torch, mla, 3, warmup=1),
                            "mla_fwd_peak_bytes_over_inputs":
                                torch.cuda.max_memory_allocated() - base}
            logits[qc] = zoo.forward(params, c.replace(attn_q_chunk=qc),
                                     batch)[0]
    err, ok = allclose_err(torch, layer[Q_CHUNK], layer[None], Q_CHUNK_TOL,
                           Q_CHUNK_TOL)
    lerr, lok = allclose_err(torch, logits[Q_CHUNK], logits[None],
                             Q_CHUNK_LOGIT_TOL, Q_CHUNK_LOGIT_TOL)
    emit({"phase": "family_q_chunk", "arch": cfg.name, "B": 1,
          "S": Q_CHUNK_S, "dtype": "float32", "q_chunk": Q_CHUNK,
          "mla_fwd_max_abs_err": err, "mla_fwd_tol": Q_CHUNK_TOL,
          "logits_max_abs_err": lerr, "logits_tol": Q_CHUNK_LOGIT_TOL,
          "ok": ok and lok, "max_abs_logit": float(logits[None].abs().max()),
          "by_q_chunk": rec,
          "note": "the unchunked scores are (B, 128, S, S) fp32; the "
                  "chunked (B, 128, q_chunk, S)"})
    del layer, logits
    if not (ok and lok):
        raise AssertionError(f"MLA q_chunk={Q_CHUNK}: layer max abs err "
                             f"{err}, logits {lerr}")


def aten_ops(fn) -> int:
    """The ATen ops one call of ``fn`` dispatches, counted by a
    ``TorchDispatchMode``: on CUDA tensors each launches about one kernel
    (a view none), where torch.profiler's post-processing of a forward of
    ~300 k launches takes minutes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def xlstm_layer_io(torch, cfg, params, x) -> list:
    """The inputs of every xLSTM layer and the last one's output, the
    stack run in ``cfg``'s mLSTM form (fp32, B=1)."""
    from repro_torch.models import zoo

    xs = [x]
    for kind, p in zip(cfg.xlstm_pattern, params["blocks_list"]):
        xs.append(zoo._xlstm_block_fwd(cfg, kind, p, xs[-1]))
    return xs


def xlstm_impls(torch, cfg, params):
    """Phase 6c: fp32, B=1, S=512: each mLSTM layer in its chunkwise form
    against its recurrent form on the same input (the recurrent stack's)
    within 1e-4, the JAX package's own claim for the two forms; each
    form's whole forward (ms on the host clock, ended by a synchronize;
    its ATen ops) and their logits' difference, recorded (with random
    weights the residual stream grows ~3,000× through the four sLSTM
    post-FFNs and fp32 rounding with it: see PERF.md)."""
    from repro_torch.models import zoo

    batch = family_inputs(torch, cfg, 1, XLSTM_REC_S, seed=10)
    rec_cfg = cfg.replace(dtype="float32", mlstm_impl="recurrent")
    chk_cfg = rec_cfg.replace(mlstm_impl="chunkwise")
    rec = {}
    with torch.inference_mode():
        x, _ = zoo.embed_inputs(params, rec_cfg, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs = xlstm_layer_io(torch, rec_cfg, params, x)
        logits_rec = zoo._logits(params, rec_cfg, xs[-1])
        torch.cuda.synchronize()
        rec["recurrent"] = {"forward_ms": (time.perf_counter() - t0) * 1e3}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_chk = zoo.forward(params, chk_cfg, batch)[0]
        torch.cuda.synchronize()
        rec["chunkwise"] = {"forward_ms": (time.perf_counter() - t0) * 1e3}
        for c in (rec_cfg, chk_cfg):
            rec[c.mlstm_impl]["aten_ops"] = aten_ops(
                lambda: zoo.forward(params, c, batch))
        layers = []
        for i, kind in enumerate(cfg.xlstm_pattern):
            if kind != "m":
                continue
            got = zoo._xlstm_block_fwd(chk_cfg, kind,
                                       params["blocks_list"][i], xs[i])
            err, ok = allclose_err(torch, got, xs[i + 1], XLSTM_IMPL_TOL,
                                   XLSTM_IMPL_TOL)
            layers.append({"layer": i, "max_abs_err": err, "ok": ok,
                           "max_abs_input": float(xs[i].abs().max())})
    lerr, _ = allclose_err(torch, logits_chk, logits_rec, XLSTM_IMPL_TOL,
                           XLSTM_IMPL_TOL)
    ok = all(r["ok"] for r in layers)
    emit({"phase": "family_xlstm_impls", "arch": cfg.name, "B": 1,
          "S": XLSTM_REC_S, "dtype": "float32", "tol": XLSTM_IMPL_TOL,
          "ok": ok, "layers_max_abs_err": max(r["max_abs_err"]
                                              for r in layers),
          "layers": layers, "logits_max_abs_err": lerr,
          "max_abs_logit": float(logits_rec.abs().max()),
          "max_abs_residual": float(xs[-1].abs().max()), "by_impl": rec})
    del xs, logits_rec, logits_chk
    if not ok:
        raise AssertionError(f"xLSTM chunkwise vs recurrent: {layers}")


def xlstm_consistency(torch, cfg, params) -> dict:
    """Phase 6c: fp32, B=1, S=256: each layer's S block steps from its
    empty state against its forward on the same input (the forward's)
    within 2e-3; the whole forward against 256 ``serve_step`` calls,
    their logits' difference recorded. Returns the forward's launches
    (none: xLSTM is plain PyTorch)."""
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.models import zoo

    c = cfg.replace(dtype="float32")
    S = CONSIST_S
    batch = family_inputs(torch, c, 1, S, seed=7)
    tok = batch["tokens"]
    with torch.inference_mode():
        ops.reset_launch_counts()
        full = zoo.forward(params, c, batch)[0]
        torch.cuda.synchronize()
        fwd_counts = ops.launch_counts()
        cache = zoo.init_cache(c, 1, S, device="cuda")
        outs = []
        t0 = time.perf_counter()
        for t in range(S):
            lg, cache = zoo.serve_step(params, c, cache, tok[:, t:t + 1],
                                       torch.full((1,), t, device="cuda"))
            outs.append(lg)
        dec = torch.stack(outs, 1)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_counts = ops.launch_counts()
        xs = xlstm_layer_io(torch, c, params,
                            zoo.embed_inputs(params, c, batch)[0])
        layers = []
        for i, (kind, p) in enumerate(zip(c.xlstm_pattern,
                                          params["blocks_list"])):
            if kind == "s":
                st = xlstm_lib.init_slstm_cache(1, c.d_model, torch.float32,
                                                "cuda")
                step = lambda st, x: xlstm_lib.slstm_block_step(  # noqa: E731
                    p, st, x, n_heads=c.n_heads)
            else:
                st = xlstm_lib.init_mlstm_cache(1, c.d_model, c.n_heads,
                                                c.mlstm_proj_factor,
                                                device="cuda")
                step = lambda st, x: xlstm_lib.mlstm_block_step(  # noqa: E731
                    p, st, x, n_heads=c.n_heads,
                    proj_factor=c.mlstm_proj_factor)
            ys = []
            for t in range(S):
                y, st = step(st, xs[i][:, t:t + 1])
                ys.append(y)
            err, ok = allclose_err(torch, torch.cat(ys, 1), xs[i + 1],
                                   CONSIST_TOL, CONSIST_TOL)
            layers.append({"layer": i, "kind": kind, "max_abs_err": err,
                           "ok": ok,
                           "max_abs_output": float(xs[i + 1].abs().max())})
    err, _ = allclose_err(torch, dec, full, CONSIST_TOL, CONSIST_TOL)
    ok = all(r["ok"] for r in layers)
    emit({"phase": "family_consistency", "arch": cfg.name, "B": 1, "S": S,
          "n_layers": c.n_layers, "window": None, "cache_slots": S,
          "dtype": "float32", "tol": CONSIST_TOL, "ok": ok,
          "layers_max_abs_err": max(r["max_abs_err"] for r in layers),
          "layers": layers, "logits_max_abs_err": err,
          "max_abs_logit": float(full.abs().max()),
          "max_abs_residual": float(xs[-1].abs().max()),
          "forward_launches": fwd_counts, "serve_steps_ms": serve_ms,
          "serve_step_ms": serve_ms / S})
    del full, dec, xs
    if not ok:
        raise AssertionError(f"{cfg.name} consistency: {layers}")
    if fwd_counts != family_launches(torch, c) or serve_counts != fwd_counts:
        raise AssertionError(f"{cfg.name} consistency: launches "
                             f"{fwd_counts} / {serve_counts}")
    return fwd_counts


def last_families_phase(torch) -> dict:
    """Phase 6c: DeepSeek-V3 at published widths cut to 3 layers and 16
    routed experts with the MTP head, and xLSTM-350M whole, each model's
    weights freed before the next. Returns the launches of the counted
    calls (forwards, the MTP head, fp32 consistency forwards)."""
    t_phase = time.perf_counter()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    cfg, params = family_params(torch, "deepseek-v3-671b",
                                cut_params=DEEPSEEK_CUT_PARAMS,
                                **DEEPSEEK_CUT)
    add(family_prefill(torch, cfg, params, DEEPSEEK_B, FAMILY_S, "prefill",
                       None))
    add(deepseek_mtp(torch, cfg, params))
    deepseek_q_chunk(torch, cfg, params)
    family_profile(torch, cfg, params, DEEPSEEK_B, FAMILY_S, "prefill")
    for window in (None, 64):
        add(family_consistency(torch, cfg, params, CONSIST_S, window=window,
                               capacity_factor=100.0))
    family_done(torch, cfg, params, t0)

    t0 = time.perf_counter()
    cfg, params = family_params(torch, "xlstm-350m")
    chunkwise = cfg.replace(mlstm_impl="chunkwise")
    add(family_prefill(torch, chunkwise, params, XLSTM_B, FAMILY_S,
                       "prefill-chunkwise", None, iters=1))
    xlstm_impls(torch, cfg, params)
    add(xlstm_consistency(torch, cfg, params))
    # the decode step only: a profiled prefill of ~300 k launches takes
    # torch.profiler minutes to read
    family_profile(torch, chunkwise, params, XLSTM_B, FAMILY_S,
                   "prefill-chunkwise", prefill=False)
    family_done(torch, cfg, params, t0)
    emit({"phase": "last_families_phase", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


# ---------------------------------------------------------------------------
# phase 6d: LM training
# ---------------------------------------------------------------------------
def grad_rel_err(torch, got, want) -> float:
    """The largest |got − want| over the largest |want|, of any pair."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def sdpa_grad_call(torch, q, k, v, do, window, causal):
    """The library yardstick of ``swa_attention_bwd``: one
    ``torch.autograd.grad`` through ``F.scaled_dot_product_attention``
    (``enable_gqa`` for KV < H; a bool mask for a window or Sq < Sk) on
    leaves of q, k, v's values in (B, H, S, hd), the graph kept."""
    import torch.nn.functional as F

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    gqa = {"enable_gqa": True} if KV != H else {}
    if causal and not window and Sq == Sk:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             **gqa)
    elif not causal and not window:
        out = F.scaled_dot_product_attention(qt, kt, vt, **gqa)
    else:
        qpos = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device="cuda")[None, :]
        keep = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
        if causal:
            keep &= kpos <= qpos
        if window:
            keep &= kpos > qpos - window
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                             **gqa)
    dot = do.transpose(1, 2).to(q.dtype)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def check_train_kernels(torch) -> dict:
    """Phase 6d-i: ``swa_attention_bwd`` and ``ssd_intra_chunk_bwd`` on the
    card against their plain versions (``*_bwd_ref``) and against
    ``torch.autograd.grad`` through the plain forward, on the same CUDA
    tensors, each kernel called twice and equal bit for bit; ms, plain ms,
    bound, and for SWA the library's (``autograd.grad`` through SDPA)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.kernels import swa_attention as swa_mod

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for label, (B, Sq, Sk, H, KV, hd, window, causal, dt) in TRAIN_SWA.items():
        dtype = getattr(torch, dt)
        q = randn((B, Sq, H, hd), dtype)
        k, v = randn((B, Sk, KV, hd), dtype), randn((B, Sk, KV, hd), dtype)
        do = randn((B, Sq, H, hd))
        o = ref.swa_attention_ref(q, k, v, window=window, causal=causal)

        def bwd():
            return swa_mod.swa_attention_bwd(q, k, v, o, do, window=window,
                                             causal=causal)
        route = swa_mod._bwd_route(q.dtype, k.dtype, hd)
        before = swa_mod.launches_bwd_by_route[route]
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        if swa_mod.launches_bwd_by_route[route] != before + 2:
            raise AssertionError(f"swa_attention_bwd {label}: the {route} "
                                 "route was not launched")
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = ref.swa_attention_bwd_ref(q, k, v, o, do, window=window,
                                         causal=causal)
        err = grad_rel_err(torch, got, want)
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        del want
        # the tc route against the plain version that rounds where it does
        err_rnd = None
        if route == "tc":
            rnd = ref.swa_attention_bwd_ref(q, k, v, o, do, window=window,
                                            causal=causal, rounded=True)
            err_rnd = grad_rel_err(torch, got, rnd)
            del rnd
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (q, k, v)]
        auto = torch.autograd.grad(ref.swa_attention_ref(
            *leaves, window=window, causal=causal), leaves, do)
        err_auto = grad_rel_err(torch, got, auto)
        del auto, leaves
        tol = TRAIN_TOL[dt]
        bf16 = dtype == torch.bfloat16
        pairs = kept_pairs(Sq, Sk, window, causal)
        n_in = B * Sq * H * hd + 2 * B * Sk * KV * hd
        n_bytes = n_in * q.element_size() + 2 * B * Sq * H * hd * 4 + n_in * 4
        flops = 10.0 * B * H * hd * pairs          # 2.5 × the forward's
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_OPS_PER_S if bf16 else
                              FP32_OPS_PER_S)
        lib = sdpa_grad_call(torch, q, k, v, do, window, causal)
        row = {"phase": "train_kernel", "name": "swa_attention_bwd",
               "route": route, "case": label, "B": B, "Sq": Sq, "Sk": Sk,
               "H": H, "KV": KV, "hd": hd, "window": window,
               "causal": causal, "dtype": dt, "kept_pairs": pairs,
               "max_abs_err": abs_err, "max_rel_err": err,
               "max_rel_err_autograd": err_auto,
               "max_rel_err_rounded_plain": err_rnd,
               "tol": tol, "tol_rounded_plain": SWA_TC_RND_TOL,
               "bit_repeatable": repeat,
               "ms": cuda_ms(torch, bwd, 10, warmup=1),
               "plain_ms": cuda_ms(torch, lambda: ref.swa_attention_bwd_ref(
                   q, k, v, o, do, window=window, causal=causal), 2,
                   warmup=1),
               "library_ms": cuda_ms(torch, lib, 10, warmup=2),
               "library_call": "torch.autograd.grad through "
                               "F.scaled_dot_product_attention"
                               + (" (enable_gqa=True)" if KV != H else ""),
               "bound_ms": b_ms, "bound_by": b_by,
               "peak": "bf16 989 TFLOP/s" if bf16 else "fp32 67 TFLOP/s"}
        emit(row)
        del lib, got
        if not (repeat and err <= tol and err_auto <= tol
                and (err_rnd is None or err_rnd <= SWA_TC_RND_TOL)):
            raise AssertionError(f"swa_attention_bwd {label}: rel err {err} "
                                 f"(autograd {err_auto}, rounded plain "
                                 f"{err_rnd}), repeatable {repeat}")
        rows.setdefault(f"swa_attention_bwd.{route}", row)

    b, c, Q, h, p, n = TRAIN_SSD_SHAPE
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        X = randn((b, c, Q, h, p), dtype)
        A_cs = torch.cumsum(-0.1 * torch.rand((b, h, c, Q), generator=gen,
                                              device="cuda"), -1)
        Bg, Cg = randn((b, c, Q, 1, n), dtype), randn((b, c, Q, 1, n), dtype)
        dY, dS = randn((b, c, Q, h, p)), randn((b, c, h, p, n))

        def bwd():
            return ssd_mod.ssd_intra_chunk_bwd(X, A_cs, Bg, Cg, dY, dS)
        before = ssd_mod.launches_bwd
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        if ssd_mod.launches_bwd != before + 2:
            raise AssertionError(f"ssd_intra_chunk_bwd {dt}: not launched")
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        # the plain version on the same inputs in float64 (the exact
        # answer to ~1e-15): each group's dB, dC sums 64 heads x 128 rows,
        # so the plain version in fp32 is itself ~0.9 of SSD_TOL away from
        # it at this shape; its distance is recorded beside the kernel's
        want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in (
            X, A_cs, Bg, Cg, dY, dS)))
        got64 = [g.double() for g in got]
        checks = [allclose_err(torch, g, w, SSD_TOL, SSD_TOL)
                  for g, w in zip(got64, want)]
        mags = [float(w.abs().max()) for w in want]
        plain32 = ref.ssd_intra_chunk_bwd_ref(X, A_cs, Bg, Cg, dY, dS)
        ratio = lambda g, w: float(((g.double() - w).abs()  # noqa: E731
                                    / (SSD_TOL + SSD_TOL * w.abs())).max())
        ratios = {"kernel_vs_float64": [ratio(g, w) for g, w in
                                        zip(got, want)],
                  "kernel_vs_fp32_plain": [ratio(g, w.double()) for g, w in
                                           zip(got, plain32)],
                  "fp32_plain_vs_float64": [ratio(p_, w) for p_, w in
                                            zip(plain32, want)]}
        del plain32
        leaves = [t.detach().double().requires_grad_(True)
                  for t in (X, A_cs, Bg, Cg)]
        Y, St = ref.ssd_intra_chunk_ref(*leaves)
        auto = torch.autograd.grad((Y, St), leaves, (dY.double(),
                                                     dS.double()))
        del Y, St, leaves, want
        # the kernel writes dB, dC once a group, as autograd sums them
        checks_auto = [allclose_err(torch, g, w, SSD_TOL, SSD_TOL)
                       for g, w in zip(got64, auto)]
        del auto, got64
        uniq = lambda t: t.untyped_storage().nbytes()  # noqa: E731
        n_bytes = (sum(uniq(t) for t in (X, A_cs, Bg, Cg, dY, dS))
                   + sum(t.numel() for t in got) * 4)
        # the products this call needs over the causal triangle: per head
        # dY Xᵀ and Mᵀ dY (Q²·P each) and B dSᵀ, X dS (2·Q·P·N each); per
        # group C Bᵀ, (ΣW) B and (ΣW)ᵀ C (Q²·N each); fp32 accuracy as
        # three TF32 products on the tensor cores
        g = Bg.shape[3]
        flops = b * c * (h * (2 * Q * Q * p + 4 * Q * p * n)
                         + g * 3 * Q * Q * n)
        b_ms, b_by = bound_ms(n_bytes, 3 * flops, TF32_OPS_PER_S)
        ok = repeat and all(k[1] for k in checks + checks_auto)
        row = {"phase": "train_kernel", "name": "ssd_intra_chunk_bwd",
               "case": f"zamba2-train-{dt}", "b": b, "chunks": c, "Q": Q,
               "h": h, "P": p, "N": n, "dtype": dt, "bc": "one group "
               "(b, c, Q, 1, n); dB, dC one a group",
               "max_abs_err": max(k[0] for k in checks),
               "max_abs_err_by_output": dict(zip(("dX", "dA_cs", "dB", "dC"),
                                                 (k[0] for k in checks))),
               "max_abs_by_output": dict(zip(("dX", "dA_cs", "dB", "dC"),
                                             mags)),
               "max_abs_err_autograd": max(k[0] for k in checks_auto),
               "err_over_tol_by_output (dX, dA_cs, dB, dC)": ratios,
               "reference": "the plain version in float64; autograd "
                            "through the plain forward in float64",
               "tol": SSD_TOL, "bit_repeatable": repeat,
               "ms": cuda_ms(torch, bwd, 10, warmup=1),
               "plain_ms": cuda_ms(torch, lambda: ref.ssd_intra_chunk_bwd_ref(
                   X, A_cs, Bg, Cg, dY, dS), 2, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "flops": flops, "bytes": n_bytes,
               "peak": "3 x TF32 495 TFLOP/s (fp32 accuracy), HBM 3.35 TB/s",
               "bound_fp32_cores_ms": flops / FP32_OPS_PER_S * 1e3}
        emit(row)
        del got
        if not ok:
            raise AssertionError(f"ssd_intra_chunk_bwd {dt}: {row}")
        rows.setdefault("ssd_intra_chunk_bwd", row)
    return rows


def loss_and_grads(torch, params, cfg, batch):
    """(loss, gradients of every leaf) of ``zoo.loss_fn``."""
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = zoo.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


def train_smoke_steps(torch) -> dict:
    """Phase 6d-ii: one ``train_step`` of every registry arch's smoke
    variant (remat on) on the card against the same step on the CPU: loss
    within 1e-4; the gradients, read as ``mu`` (0.1 · g after one step from
    zero), within 1e-4 of each leaf's largest; the params after the update
    within 1e-3 in Frobenius norm over the whole tree (an element whose
    gradient is ~0 steps by up to lr either way, as AdamW normalises it);
    a MoE arch's forward twice and its step twice, equal bit for bit.
    Returns the backward kernels' launches of the card's counted steps."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_leaves, tree_map

    total = {"swa_attention_bwd": 0, "ssd_intra_chunk_bwd": 0,
             "swa_attention_bwd.tc": 0, "swa_attention_bwd.fp32": 0}
    for arch in sorted(registry.ARCHS):
        cfg = registry.smoke_variant(registry.get(arch)).replace(remat=True)
        st_cpu = zoo.init_train_state(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")
        st = tree_map(lambda t: t.cuda(), st_cpu)
        batch = lm_batch(torch.Generator().manual_seed(1), cfg,
                         TRAIN_SMOKE_B, TRAIN_SMOKE_S, "cpu")
        gb = tree_map(lambda t: t.cuda(), batch)
        moe = cfg.family == "moe"
        twin = tree_map(torch.clone, st) if moe else None
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = zoo.train_step(st, gb, cfg)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = {**ops.backward_launch_counts(),
                  **ops.backward_route_counts()}
        for key in total:
            total[key] += counts[key]
        st_cpu, m_cpu = zoo.train_step(st_cpu, batch, cfg)
        loss_err = abs(float(m["loss"]) - float(m_cpu["loss"]))
        grad_err = grad_rel_err(torch, [t.cpu() for t in tree_leaves(
            st["mu"])], tree_leaves(st_cpu["mu"]))
        params = list(zip(tree_leaves(st["params"]),
                          tree_leaves(st_cpu["params"])))
        fro = math.sqrt(sum(float(torch.sum((a.cpu() - b_) ** 2))
                            for a, b_ in params)
                        / sum(float(torch.sum(b_ ** 2)) for _, b_ in params))
        rec = {"phase": "train_smoke", "arch": arch, "family": cfg.family,
               "B": TRAIN_SMOKE_B, "S": TRAIN_SMOKE_S, "remat": True,
               "loss": float(m["loss"]), "loss_cpu": float(m_cpu["loss"]),
               "loss_abs_err": loss_err, "grad_rel_err": grad_err,
               "params_fro_err": fro, "card_step_s": card_s,
               "backward_launches": counts}
        ok = loss_err <= 1e-4 and grad_err <= 1e-4 and fro <= 1e-3
        if moe:
            with torch.no_grad():
                f1 = zoo.forward(twin["params"], cfg, gb)[0]
                f2 = zoo.forward(twin["params"], cfg, gb)[0]
            twin, m2 = zoo.train_step(twin, gb, cfg)
            rec["forward_bit_repeatable"] = bool(torch.equal(f1, f2))
            rec["step_bit_repeatable"] = bool(
                torch.equal(m["loss"], m2["loss"])
                and all(torch.equal(a, b_) for a, b_ in
                        zip(tree_leaves(st), tree_leaves(twin))))
            ok = ok and rec["forward_bit_repeatable"] \
                and rec["step_bit_repeatable"]
            del f1, f2, twin
        rec["ok"] = ok
        emit(rec)
        if not ok:
            raise AssertionError(f"train step {arch}: {rec}")
    return total


def train_full(torch, arch: str, B: int, want_params: int,
               want_bwd: dict) -> dict:
    """Phase 6d-iii: ``arch`` at its published widths (fp32 params and
    moments, bf16 activations, remat on), random from seed 0, TRAIN_STEPS
    ``train_step``s at B × TRAIN_S on one batch: each step's ms (host
    clock, synchronised), loss and backward launches (``want_bwd`` a step,
    else the run fails), the peak memory of the steps; then a profiled
    step (``train_profile``). Returns the state and the launches."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import zoo
    from repro_torch.models.modules import param_count

    cfg = registry.get(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # earlier phases' live tensors
    t0 = time.perf_counter()
    st = zoo.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    torch.cuda.synchronize()
    n = param_count(st["params"])
    if n != want_params:
        raise AssertionError(f"{arch} has {n} params, not {want_params:,}")
    batch = lm_batch(torch.Generator(device="cuda").manual_seed(1), cfg, B,
                     TRAIN_S, "cuda")
    state_bytes = torch.cuda.memory_allocated() - base
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    routes_want = {"swa_attention_bwd.tc": want_bwd["swa_attention_bwd"],
                   "swa_attention_bwd.fp32": 0}
    steps, total = [], dict.fromkeys([*want_bwd, *routes_want], 0)
    for _ in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = zoo.train_step(st, batch, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bwd = ops.backward_launch_counts()
        routes = ops.backward_route_counts()
        fwd = {k: v for k, v in ops.launch_counts().items() if v}
        steps.append({"ms": ms, "loss": float(m["loss"]), "backward": bwd,
                      "backward_routes": routes, "forward": fwd})
        if bwd != want_bwd or routes != routes_want:
            raise AssertionError(f"{arch} train step: backward launches "
                                 f"{bwd}, routes {routes}, not {want_bwd}, "
                                 f"{routes_want}")
        for key in total:
            total[key] += {**bwd, **routes}[key]
    rec = {"phase": "train_full", "arch": arch, "source": cfg.source,
           "params": n, "param_dtype": cfg.param_dtype,
           "act_dtype": cfg.dtype, "remat": cfg.remat, "B": B, "S": TRAIN_S,
           "steps": steps,
           "step_ms_median_2_3": statistics.median(s["ms"]
                                                   for s in steps[1:]),
           "state_bytes": state_bytes, "peak_device_bytes":
           torch.cuda.max_memory_allocated(), "peak_bytes_over_base":
           torch.cuda.max_memory_allocated() - base, "base_bytes": base,
           "init_s": init_s,
           "losses_finite": all(math.isfinite(s["loss"]) for s in steps),
           "note": "weights and tokens random from seeds 0 and 1; no cut; "
                   "forward launches count remat's recompute too"}
    emit(rec)
    if not rec["losses_finite"]:
        raise AssertionError(f"{arch} train step: a loss is not finite")
    train_profile(torch, arch, st, batch, cfg)
    per_head_bc_sums(torch, arch, st, batch, cfg)
    return st, total


def train_profile(torch, arch: str, st, batch, cfg):
    """Phase 6d-iii: one more ``train_step`` under torch.profiler: the
    device's busy share, the backward kernels' device ms, GEMMs, casts
    and copies, the top kernels (not counted in the launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import zoo

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        zoo.train_step(st, batch, cfg)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    summary = device_summary(torch, prof, wall_ms, avgs)
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA]
    bwd = {name: sum(e.self_device_time_total for e in kern
                     if match in e.key) / 1e3
           for name, match in (("swa_attention_bwd_ms", "swa_bwd_"),
                               ("swa_attention_bwd_tc_ms", "swa_bwd_tc_"),
                               ("ssd_intra_chunk_bwd_ms", "ssd_bwd_"))}
    emit({"phase": "train_profile", "arch": arch, **summary, **bwd})


def per_head_bc_sums(torch, arch: str, st, batch, cfg):
    """Phase 6d-iii: one more ``train_step`` under a dispatch mode that
    records every sum of a tensor whose last two dims are (SSM heads,
    d_state) over the heads alone: a dense per-head dB or dC summed over
    a group's heads. The SSD backward writes them by group, so a step has
    none; the run fails on any."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import zoo

    if cfg.family != "hybrid":            # no Mamba2 block
        return None
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    n, hits, sums = cfg.ssm_state, [], [0]
    aten = torch.ops.aten

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in (aten.sum.dim_IntList, aten.sum.default):
                sums[0] += 1
                x = args[0]
                dims = args[1] if len(args) > 1 else kwargs.get("dim")
                if dims is not None and x.dim() >= 3 \
                        and tuple(x.shape[-2:]) == (h, n):
                    norm = sorted(d % x.dim() for d in dims)
                    if norm == [x.dim() - 2]:
                        hits.append({"shape": list(x.shape),
                                     "dtype": str(x.dtype)})
            return func(*args, **kwargs)

    with Watch():
        zoo.train_step(st, batch, cfg)
    torch.cuda.synchronize()
    rec = {"phase": "train_per_head_bc", "arch": arch, "ssm_heads": h,
           "d_state": n, "sums_seen": sums[0], "per_head_sums": hits}
    emit(rec)
    if hits:
        raise AssertionError(f"{arch} train step sums dense per-head B/C "
                             f"gradients over the heads: {hits}")
    return rec


def zamba2_remat_cut(torch) -> dict:
    """Phase 6d-iii: Zamba2-1.2B cut to ZAMBA_CUT_LAYERS layers, the same
    seed, loss and every gradient with remat on and off: equal bit for bit,
    and each one's peak memory."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import zoo

    cut = registry.get("zamba2-1.2b").replace(n_layers=ZAMBA_CUT_LAYERS)
    batch = lm_batch(torch.Generator(device="cuda").manual_seed(1), cut,
                     ZAMBA_TRAIN_B, TRAIN_S, "cuda")
    out, peaks = {}, {}
    for remat in (True, False):
        cfg = cut.replace(remat=remat)
        params = zoo.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[remat] = loss_and_grads(torch, params, cfg, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        del params
    (l_on, g_on), (l_off, g_off) = out[True], out[False]
    equal = bool(torch.equal(l_on, l_off)) and all(
        torch.equal(a, b) for a, b in zip(g_on, g_off))
    rec = {"phase": "train_remat", "arch": "zamba2-1.2b",
           "n_layers": ZAMBA_CUT_LAYERS, "B": ZAMBA_TRAIN_B, "S": TRAIN_S,
           "loss": float(l_on), "bit_equal": equal,
           "max_abs_grad_diff": max(float((a - b).abs().max())
                                    for a, b in zip(g_on, g_off)),
           "peak_bytes_over_params_remat_on": peaks[True],
           "peak_bytes_over_params_remat_off": peaks[False],
           "reduced": [f"n_layers 38 -> {ZAMBA_CUT_LAYERS}: remat off keeps "
                       "every layer's activations"]}
    emit(rec)
    del out, g_on, g_off
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"Zamba2 remat on != off: {rec}")
    return rec


def training_phase(torch) -> dict:
    """Phase 6d: a train step of every smoke variant, Zamba2-1.2B and
    Gemma-2B at published widths (the backward kernels' checks,
    ``check_train_kernels``, run in phase 2). Returns the backward
    kernels' launches of the counted steps."""
    import gc

    t_phase = time.perf_counter()
    total = train_smoke_steps(torch)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    st, counts = train_full(torch, "zamba2-1.2b", ZAMBA_TRAIN_B,
                            1_170_473_856, {"swa_attention_bwd": 6,
                                            "ssd_intra_chunk_bwd": 38})
    add(counts)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    zamba2_remat_cut(torch)
    st, counts = train_full(torch, "gemma-2b", GEMMA_TRAIN_B,
                            2_506_172_416, {"swa_attention_bwd": 18,
                                            "ssd_intra_chunk_bwd": 0})
    add(counts)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "training_phase", "backward_launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


def leaf_errs(got: dict, want: dict) -> dict:
    """{leaf: (‖got − want‖ / ‖want‖, max |got − want| / max |want|)}, each
    leaf on its own."""
    out = {}
    for k in sorted(want):
        g, w = got[k].cpu(), want[k]
        out[k] = (float((g - w).norm() / w.norm().clamp(min=1e-30)),
                  float((g - w).abs().max() / w.abs().max().clamp(
                      min=1e-30)))
    return out


def card_vs_cpu(torch, **kw) -> list:
    """The round at ``kw`` on the CPU and on the card from the same draws:
    for each output (group models, global model, group deltas), its
    ``leaf_errs``."""
    from repro_torch.launch import fed_dryrun

    fc, ac = fed_dryrun.run_round("cpu", **kw)
    fg, ag = fed_dryrun.run_round("cuda", **kw)
    return [leaf_errs(g, c) for g, c in zip(fg(*ag), fc(*ac))]


def fed_round_card(torch):
    """Phase 6e-i: one ``make_parallel_round`` at the reference's size on
    the card (round ms, peak, finite outputs), then the same round at
    FED_CHECK_K clients on the CPU and on the card from the same draws."""
    from repro_torch.launch import fed_dryrun

    t0 = time.perf_counter()
    fn, args = fed_dryrun.run_round("cuda", **FED_ROUND)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # a first call at E = 1 takes the card's one-off costs (the round's
    # kernels loaded, its ~9 GB allocated) out of the timed round
    warm, _ = fed_dryrun.run_round("meta", **dict(FED_ROUND, epochs=1))
    t0 = time.perf_counter()
    warm(*args[:5], args[5][:, :warm.max_steps])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    finite = all(bool(torch.isfinite(t).all()) for part in out
                 for t in part.values())
    row = {"phase": "fed_dryrun", "part": "round", **FED_ROUND,
           "model": "mlp(784, 512, 62)", "lr": fed_dryrun.LR,
           "local_steps": fn.max_steps, "setup_s": setup_s,
           "first_call_ms_at_E1": warm_ms, "round_ms": round_ms,
           "finite": finite,
           "argument_bytes": sum(t.nbytes for t in [*args[0].values(),
                                                    *args[1:]]),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    del out, args
    small = dict(FED_ROUND, n_clients=FED_CHECK_K)
    full = card_vs_cpu(torch, **small)
    short = card_vs_cpu(torch, **dict(small, epochs=FED_ELEM_EPOCHS))
    outs = ("group_params", "global_params", "agg_delta")
    row.update({
        "check_clients": FED_CHECK_K, "rtol": FED_RTOL,
        "card_vs_cpu_leaf_rel_norm": {o: {k: e[0] for k, e in t.items()}
                                      for o, t in zip(outs, full)},
        "card_vs_cpu_leaf_elementwise_not_held": {
            o: {k: e[1] for k, e in t.items()} for o, t in zip(outs, full)},
        "elementwise_epochs": FED_ELEM_EPOCHS,
        "card_vs_cpu_leaf_rel_norm_at_elementwise_epochs": {
            o: {k: e[0] for k, e in t.items()} for o, t in zip(outs, short)},
        "card_vs_cpu_leaf_elementwise": {
            o: {k: e[1] for k, e in t.items()} for o, t in zip(outs, short)}})
    emit(row)
    worst_norm = max(e[0] for t in full + short for e in t.values())
    worst_elem = max(e[1] for t in short for e in t.values())
    if not (finite and worst_norm <= FED_RTOL and worst_elem <= FED_RTOL):
        raise AssertionError(
            f"fed round: finite {finite}, card vs CPU per leaf: norm "
            f"{worst_norm}, elementwise at E = {FED_ELEM_EPOCHS} "
            f"{worst_elem} (rtol {FED_RTOL})")
    torch.cuda.empty_cache()


def fed_coldstart_card(torch) -> dict:
    """Phase 6e-ii: Alg. 3 on ΔW (FED_NPRE, FED_DW) built on the card:
    ``run_coldstart``'s step with each QR (E from edc_cosine: the counted
    launches), the two V's one subspace, the kernel's E against the plain
    version on the same ΔW and V, its times beside the bound. Returns the
    launch counts of the two counted steps."""
    import torch.nn.functional as F

    from repro_torch.fed import parallel as fp
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import edc_cosine as edc_mod
    from repro_torch.launch import fed_dryrun

    n, d, m = FED_NPRE, FED_DW, FED_M
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn, (dW, omega) = fed_dryrun.run_coldstart(
        "cuda", n_pre=n, d_w=d, m=m, qr_impl="householder")
    torch.cuda.synchronize()
    row = {"phase": "fed_dryrun", "part": "coldstart", "n": n, "d": d, "m": m,
           "dtype": "float32", "reduced": "d_w 415,258,624 -> 103,814,656 "
           "(64 x 415,258,624 fp32 is 106.3 GB)",
           "spectrum": list(fed_dryrun.SPECTRUM), "noise": fed_dryrun.NOISE,
           "build_dW_s": time.perf_counter() - t0, "dW_bytes": dW.nbytes,
           "plan": edc_mod.plan(n, d, m, build.sm_count(0))._asdict()}
    # the main path: run_coldstart's step with each QR, counted
    ops.reset_launch_counts()
    for qr in ("householder", "cholesky"):
        if qr == "cholesky":
            fn = fed_dryrun.coldstart_step(m, qr)
        t0 = time.perf_counter()
        assign, centers, E = fn(dW, omega)
        torch.cuda.synchronize()
        row[f"coldstart_ms_{qr}"] = (time.perf_counter() - t0) * 1e3
        ok = (bool(torch.isfinite(E).all()) and bool(
            torch.isfinite(centers).all()) and 0 <= int(assign.min())
            and int(assign.max()) < m)
        row[f"labels_{qr}"] = assign.tolist()
        MESH2D_REF.setdefault("coldstart", {})[qr] = {
            "E": E.cpu(), "labels": assign.tolist(),
            "ms": row[f"coldstart_ms_{qr}"]}
        if not ok:
            raise AssertionError(f"coldstart {qr}: non-finite E / centers "
                                 "or a label outside [0, m)")
    counts = ops.launch_counts()
    if counts["edc_cosine"] != 2:
        raise AssertionError(f"coldstart: {counts['edc_cosine']} edc_cosine "
                             "launches, want 2 (one a QR)")
    # the two QRs' V, timed apart
    V = {}
    for qr in ("householder", "cholesky"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        V[qr] = fp.rsvd_sharded(dW, m, omega=omega, qr_impl=qr)
        torch.cuda.synchronize()
        row[f"rsvd_ms_{qr}"] = (time.perf_counter() - t0) * 1e3
        MESH2D_REF["coldstart"][qr]["V"] = V[qr].cpu()
    sv = torch.linalg.svdvals((V["householder"].T @ V["cholesky"]).abs())
    row["subspace_singular_values"] = sv.tolist()
    row["subspace_err"] = float((sv - 1).abs().max())
    Vh = V["householder"]
    got = edc_mod.edc_cosine(dW, Vh)
    want = ref.cosine_block_ref(dW, Vh)
    err = float((got - want).abs().max())
    b_ms, b_by = bound_ms(4.0 * (n * d + d * m + n * m),
                          2.0 * n * d * (m + 1))
    # F.cosine_similarity broadcasts (rows, d, columns) fp32: over chunks
    # of ΔW's rows and V's columns whose broadcast fits EDC_LIBRARY_BYTES
    rstep = max(1, int(EDC_LIBRARY_BYTES // (4 * d)))
    chunks = [(i, min(i + rstep, n), j) for i in range(0, n, rstep)
              for j in range(m)]
    fn = lambda: edc_mod.edc_cosine(dW, Vh)  # noqa: E731
    row.update({
        "max_abs_err": err, "tol": TOL, "ms": cuda_ms(torch, fn, 10),
        "device_ms": profiled_ms(torch, fn, "edc_", iters=5),
        "plain_ms": cuda_ms(torch, lambda: ref.cosine_block_ref(dW, Vh), 3,
                            warmup=1),
        "library_ms": sum(cuda_ms(
            torch, lambda i0=i0, i1=i1, j=j: F.cosine_similarity(
                dW[i0:i1, :, None], Vh[None, :, j:j + 1], dim=1), 1,
            warmup=1) for i0, i1, j in chunks),
        "library_chunks": f"{len(chunks)} calls: rows of {rstep}, one "
                          "column each",
        "read_dW_ms": cuda_ms(torch, lambda: dW.sum(), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": counts["edc_cosine"],
        "peak_device_bytes": torch.cuda.max_memory_allocated()})
    row["share_of_bound_events"] = b_ms / row["ms"]
    emit(row)
    if not (err <= TOL and row["subspace_err"] <= SUBSPACE_TOL):
        raise AssertionError(f"coldstart: E max abs err {err} (tol {TOL}), "
                             f"subspace {row['subspace_err']} (tol "
                             f"{SUBSPACE_TOL})")
    del dW, V, Vh, got, want
    torch.cuda.empty_cache()
    return counts


def held_pair(torch, arch: str, shape_name: str, batch: int):
    """Phase 6e-iii: one zoo pair's dry-run record on meta at a batch cut,
    then the same step on the card: the record's argument bytes against
    the real tensors', and the step's peak (the temp meta cannot give)."""
    import gc

    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun

    full = shp.SHAPES[shape_name]
    shape = shp.InputShape(shape_name, full.seq_len, batch, full.kind)
    rec = dryrun.run_one(arch, shape_name, shape=shape, mesh="1",
                         save=False, verbose=False)
    cfg = shp.config_for(dryrun.arch_config(arch), shape)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fn, args = dryrun.build_step(cfg, shape, device="cuda", gen=gen)
    real = dryrun.nbytes(args)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(1 + HELD_STEPS):          # a first call, then the timed
        out = None
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    logits = out[1]["loss"] if full.kind == "train" else (
        out if full.kind == "prefill" else out[0])
    finite = bool(torch.isfinite(logits).all())
    mem = rec["memory_analysis"]
    row = {"phase": "fed_dryrun", "part": "zoo", "arch": arch,
           "shape": shape_name, "seq_len": full.seq_len, "batch": batch,
           "reduced": f"global_batch {full.global_batch} -> {batch}",
           "status": rec["status"], "trace_s": rec["trace_s"],
           "flops": rec["cost_analysis"]["flops"], **mem,
           "real_argument_bytes": real,
           "arguments_equal": mem["argument_size_in_bytes"] == real,
           "first_call_ms": times[0],
           "step_ms": statistics.median(times[1:]), "step_ms_each": times[1:],
           "peak_device_bytes": peak,
           "live_before_bytes": live, "temp_bytes_measured": peak - live,
           "finite": finite}
    emit(row)
    del out, args, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not (row["arguments_equal"] and finite and rec["status"] == "ok"):
        raise AssertionError(
            f"{arch} x {shape_name}: record {rec['status']}, argument "
            f"bytes {mem['argument_size_in_bytes']} vs {real}, finite "
            f"{finite}")


def dryrun_phase(torch) -> dict:
    """Phase 6e: the dry runs without a mesh. Returns the launch counts of
    the counted cold starts."""
    t_phase = time.perf_counter()
    fed_round_card(torch)
    counts = fed_coldstart_card(torch)
    for arch, shape_name, batch in HELD_PAIRS:
        held_pair(torch, arch, shape_name, batch)
    emit({"phase": "dryrun_phase", "launches": counts,
          "seconds": time.perf_counter() - t_phase})
    return counts


def fed_phases(smi: str) -> dict:
    """Phases 4c to 4h, and 4i-i's and 4i-iv's worlds of one, in a forked
    process of their own (``start_child``) beside the zoo phases: phase
    4's data and model made again from seed 0, a process's first runs
    kept out of the timed ones by ``mesh_warmup``. Returns each phase's
    launch counts, the runs of one device the mesh ranks are held to
    (``mesh_refs``) and 4i-iv's world of one (``svc_nccl1``)."""
    import torch

    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.data.generators import femnist_like
    from repro_torch.kernels import ops
    from repro_torch.models.paper_models import mlp

    mesh_warmup(torch, None)
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    out = {}
    # phase 4c: the dynamic-assignment strategies and the shift detector
    for name in STRATEGIES:
        strategy_run(torch, data, model, name)
    out["shift"] = strategy_run(torch, data, model, "shift")
    if out["shift"]["edc_cosine"] < 1:
        raise AssertionError("shift run launched no edc_cosine kernel")
    # phase 4d: round blocks, each fused round a replayed CUDA graph
    ops.reset_launch_counts()
    blocked_ms = {}
    for name, alpha in BLOCK_RUNS:
        rec = block_run(torch, data, model, name, alpha)
        blocked_ms[(name, alpha)] = rec["blocked_round_ms_steady"]
        torch.cuda.empty_cache()
    out["block"] = ops.launch_counts()
    if out["block"]["edc_cosine"] < 2:
        raise AssertionError("the block phase's FedGroup runs launched "
                             "no edc_cosine kernel")
    # phase 4e: streamed populations (prefetcher, state table, arrivals)
    ops.reset_launch_counts()
    for name in STREAM_RUNS:
        stream_run(torch, data, model, name)
        torch.cuda.empty_cache()
    population_phase(torch)
    out["stream"] = ops.launch_counts()
    if out["stream"]["edc_cosine"] < 1:
        raise AssertionError("the population phase launched no edc_cosine "
                             "kernel")
    # phase 4f: checkpoints with kill-and-resume, faults and the deadline
    out["ft"] = fault_tolerance_phase(torch, data, model)
    # phase 4g: the async runtime (leases, staleness folds, graph dispatch)
    out["async"] = async_phase(torch, data, model, blocked_ms)
    # phase 4h: telemetry and the elastic control plane (coordinator and
    # workers over threads and spawned processes)
    out["fleet"] = fleet_phase(torch, data, model)
    torch.cuda.empty_cache()
    # phase 4i-i: the client axis, an NCCL world of one in this process,
    # and the runs of one device the ranks are held to
    out["mesh_refs"] = mesh_refs(torch, data, model)
    # phase 4i-iv in this process: the runtime services on an NCCL world
    # of one (checkpoints, telemetry, async, the fleet)
    t0 = time.perf_counter()
    out["nccl1"] = {"counts": svc_nccl1(torch, data, model, smi)}
    out["nccl1"]["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 3

    # phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "library": lib.name})
    kernels_lib, log = build.library(), build.build_log()
    emit({**ptxas_report(log, "swa_attention_tc.cu", "swa_tc_kernel"),
          "dynamic_smem": {hd: kernels_lib.swa_attention_tc_smem(hd)
                           for hd in (64, 128)}})
    emit({**ptxas_report(log, "ssd_chunk_tc.cu", "ssd_tc_kernel"),
          "dynamic_smem": {f"Q{q}_{'per_head' if ph else 'shared_bc'}":
                           kernels_lib.ssd_intra_chunk_tc_smem(q, ph)
                           for q in (64, 128) for ph in (0, 1)},
          "heads_per_cta_zamba2_prefill":
              kernels_lib.ssd_intra_chunk_tc_heads_per_cta(
                  ZAMBA_B, ZAMBA_S // 128, 64,
                  torch.cuda.get_device_properties(0).multi_processor_count)})
    fp32_note = ("registers at entry (launch bound 128 threads); 3xTF32 "
                 "mma.sync, operands split in registers")
    emit(ptxas_report(log, "swa_attention.cu", "swa_kernel", fp32_note))
    emit(ptxas_report(log, "swa_attention.cu", "swa_combine_kernel",
                      "registers at entry (256 threads)"))
    emit(ptxas_report(log, "ssd_chunk.cu", "ssd_kernel", fp32_note))
    emit(ptxas_report(log, "ssd_chunk.cu", "ssd_cell_kernel",
                      "registers at entry (launch bound 256 threads, two "
                      "CTAs an SM); 3xTF32 mma.sync"))
    for pass_, kern, note in (
            (0, "swa_bwd_tc_rows_kernel", "registers at entry (launch bound "
             "256 threads); mma.sync m16n8k16 bf16, one instance per DM 64, "
             "80, 128, 256"),
            (1, "swa_bwd_tc_dkv_kernel", "registers at entry (256 threads, "
             "2 CTAs an SM at DM <= 80, else 1); a warp's dK and dV: 16 keys "
             "x the head dim (its half at 256)"),
            (2, "swa_bwd_tc_dq_kernel", "registers at entry (256 threads, 2 "
             "CTAs an SM at DM <= 80, else 1)")):
        emit({**ptxas_report(log, "swa_attention_bwd_tc.cu", kern, note),
              "dynamic_smem": {hd: kernels_lib.swa_attention_bwd_tc_smem(
                  hd, pass_) for hd in (56, 64, 80, 128, 256)}})
    emit(ptxas_report(log, "ssd_chunk_bwd.cu", "ssd_bwd_kernel",
                      "registers at entry (launch bound 128 threads, one "
                      "CTA an SM); 3xTF32 mma.sync, one instance per dtype"))
    emit(ptxas_report(log, "ssd_chunk_bwd.cu", "ssd_bwd_group_kernel",
                      "registers at entry (launch bound 256 threads)"))
    emit(ptxas_report(log, "edc_cosine.cu", "edc_part_kernel",
                      "registers at entry (launch bound 256 threads, two "
                      "CTAs an SM); one instance per dtype pair and column "
                      "tile width 4, 8, 12, 16"))
    emit(ptxas_report(log, "edc_cosine.cu", "edc_sums_kernel",
                      "registers at entry (256 threads): the partial-sum "
                      "entry's second kernel"))

    # phase 2: kernels against their plain versions (the federated ones,
    # the zoo's forward ones, the backward ones), each alone on the card
    rows = check_kernels(torch)
    rows.update(check_zoo_kernels(torch))
    rows.update(check_train_kernels(torch))
    torch.cuda.empty_cache()

    # phase 3: the port on the card agrees with the port on the CPU; this
    # tiny run is also the warm-up (first use of cuBLAS / cuSOLVER /
    # torch.func on the card), so the main path's times exclude it
    reference_check(torch)

    # phase 4: the main path at full width (FEMNIST MLP-512, paper Table 2)
    from repro_torch.data.generators import femnist_like
    from repro_torch.models.paper_models import mlp
    t0 = time.perf_counter()
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    emit({"phase": "config", "dataset": "femnist_like(dim=784, "
          "n_classes=26, n_clients=200)", "model": "mlp(784, 512, 26)",
          "m": 5, "alpha": 20, "K": 20, "B": 10, "lr": 0.03, "E": 2,
          "rounds": ROUNDS, "data_s": time.perf_counter() - t0,
          "note": "E cut from the paper's 20 to 2 to fit the smoke's time "
                  "limit; weights random from seed 0"})
    tr_edc, pre_idx, counts_edc = fedgroup_run(torch, data, model, "edc")
    _, _, counts_madc = fedgroup_run(torch, data, model, "madc")
    counts_many = edc_cold_start_many_groups(torch, data, model)
    if counts_edc["edc_cosine"] < 1:
        raise AssertionError("EDC run launched no edc_cosine kernel")
    if counts_madc["madc"] < 1:
        raise AssertionError("MADC run launched no madc kernel")
    # phase 5: where the time goes
    breakdown(torch, tr_edc, pre_idx)
    round_profile(torch, tr_edc)
    del tr_edc, data, model
    torch.cuda.empty_cache()

    # Three lanes beside this process's zoo phases (see Order above): the
    # federated phases 4c to 4h and 4i-i / 4i-iv's worlds of one in a
    # forked process; the mesh phases' spawned ranks, 4j first (its Alg. 3
    # holds ~24 GB a rank: the families' weights and the serving CLIs wait
    # for it); the serving CLIs but the ~17 GB default one, each in a
    # child process. 6e, whose Alg. 3 holds ~57 GB, waits for all three
    fed = start_child("fed_phases", "fed", smi)
    lane = Lane([("mesh2d", mesh2d_ranks), ("svc2d", svc2d_ranks),
                 ("zoo_tp", zoo_tp_ranks), ("zoo_train_tp", zoo_train_ranks),
                 ("mesh_gloo2", lambda: mesh_ranks(2, 2, "gloo2")),
                 ("svc_gloo2", svc_ranks)])
    lane.start()
    serve = Lane([("after_mesh2d", lambda: lane.wait("mesh2d")),
                  ("zamba2", zamba2_serve),
                  ("granite_moe", lambda: serve_cli(
                      "family_serve", "granite-moe-1b-a400m")),
                  ("deepseek_smoke", lambda: serve_cli(
                      "family_serve", "deepseek-v3-671b", ["--smoke"])),
                  ("xlstm", lambda: serve_cli("family_serve",
                                              "xlstm-350m"))])
    serve.start()

    # phase 6: Zamba2-1.2B prefill and serving
    cfg, params = zamba2_params(torch)
    counts_zoo = zamba2_prefill(torch, cfg, params)
    zamba2_profile(torch, cfg, params)
    counts_f32 = zamba2_consistency(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    lane.wait("mesh2d")
    # phase 6b: the zoo's attention families (dense, VLM, audio, MoE)
    counts_fam = family_phase(torch)
    # phase 6c: the zoo's last two families (DeepSeek-V3 cut, xLSTM-350M)
    counts_last = last_families_phase(torch)
    serve.wait("xlstm")
    serve.join()
    # phase 4m's ranks (~25 GB) run now, alone beside the forked 4c-4h: 6d
    # (~42 GB) waits for them
    ZOO_TRAIN_GO.set()
    lane.wait("zoo_train_tp")
    # phase 6d: LM training (every smoke variant, Zamba2-1.2B and Gemma-2B
    # at published widths)
    counts_train = training_phase(torch)
    t0 = time.perf_counter()
    lane.wait("svc_gloo2")
    lane.join()
    fed_out = join_child(torch, fed, FED_CHILD_TIMEOUT_S, "phases 4c-4h")
    emit({"phase": "lanes", "mesh_jobs_s": lane.seconds,
          "serve_jobs_s": serve.seconds, "waited_s":
          time.perf_counter() - t0})
    # phase 6e: the dry runs without a mesh (the federated round and Alg. 3
    # at production size, the zoo's dry-run records held to the card)
    counts_dry = dryrun_phase(torch)

    # the lanes' checks
    counts_shift, counts_block = fed_out["shift"], fed_out["block"]
    counts_stream, counts_ft = fed_out["stream"], fed_out["ft"]
    counts_async, counts_fleet = fed_out["async"], fed_out["fleet"]
    refs = fed_out["mesh_refs"]
    MESH2D_REF.update({p: (refs["ref"][p], refs["ref_state"][p])
                       for p in MESH2D_PATHS})
    # phase 4i-ii: two spawned ranks sharing the card over gloo, checked
    counts_mesh = mesh_phase(torch, refs, lane)
    # phase 4i-iv: faults and the deadline on two ranks, checked
    counts_svc = services_phase(torch, fed_out["nccl1"], lane, smi)
    # phase 4j: the 2-D (data, model) layout on two ranks sharing the card
    # (checked after 6e, whose one-device Alg. 3 it is held to)
    counts_2d = mesh2d_phase(torch, lane, smi)
    # phase 4k: the runtime services under a model axis and process workers
    # under a mesh, on two ranks sharing the card
    counts_2k = services2d_phase(torch, lane, smi)
    # phase 4l: the zoo over a model axis on two ranks sharing the card
    counts_tp = zoo_tp_phase(torch, lane, smi)
    # phase 4m: the zoo's training over a model axis on two and four ranks
    counts_4m = zoo_train_phase(torch, lane, smi)

    # phase 7: the kernels line and the result. Launches: FedGroup's EDC
    # and MADC runs, the 20-group EDC cold start, the shift run, the
    # block phase's FedGroup runs, the population phase's FedGroup runs,
    # phase 4f's, 4g's, 4h's, 4i's, 4i-iv's and 4k's FedGroup runs (their
    # ranks' too; 4j's and 4k's model axis through the partial-sum entry),
    # phase 6e's two cold starts;
    # Zamba2's two counted bf16 prefills (the tensor-core routes) and its
    # two fp32 consistency forwards (the fp32 routes); phase 6b's counted
    # bf16 prefills and fp32 consistency forwards (swa_attention, both
    # routes); phase 6c's counted MTP call (the fp32 route); phase 6d's
    # counted train steps (the backward kernels)
    launches = {"edc_cosine": counts_edc["edc_cosine"]
                + counts_madc["edc_cosine"] + counts_many["edc_cosine"]
                + counts_shift["edc_cosine"] + counts_block["edc_cosine"]
                + counts_stream["edc_cosine"] + counts_ft["edc_cosine"]
                + counts_async["edc_cosine"] + counts_fleet["edc_cosine"]
                + counts_mesh["edc_cosine"] + counts_svc["edc_cosine"]
                + counts_dry["edc_cosine"] + counts_2d["edc_cosine"]
                + counts_2k["edc_cosine"],
                "edc_cosine_partial": counts_2d["edc_cosine_partial"]
                + counts_2k["edc_cosine_partial"],
                "madc": counts_edc["madc"] + counts_madc["madc"],
                "swa_attention.tc": counts_zoo["swa_attention.tc"]
                + counts_fam["swa_attention.tc"]
                + counts_last["swa_attention.tc"]
                + counts_tp["swa_attention.tc"]
                + counts_4m.get("swa_attention.tc", 0),
                "swa_attention.fp32": counts_f32["swa_attention.fp32"]
                + counts_fam["swa_attention.fp32"]
                + counts_last["swa_attention.fp32"],
                "ssd_intra_chunk.tc": counts_zoo["ssd_intra_chunk.tc"]
                + counts_tp["ssd_intra_chunk.tc"]
                + counts_4m.get("ssd_intra_chunk.tc", 0),
                "ssd_intra_chunk.fp32": counts_f32["ssd_intra_chunk.fp32"],
                "swa_attention_bwd.tc": counts_train["swa_attention_bwd.tc"]
                + counts_4m["swa_attention_bwd.tc"],
                "swa_attention_bwd.fp32":
                    counts_train["swa_attention_bwd.fp32"],
                "ssd_intra_chunk_bwd": counts_train["ssd_intra_chunk_bwd"]
                + counts_4m["ssd_intra_chunk_bwd"]}
    src_of = {"edc_cosine": ("src/repro_torch/csrc/edc_cosine.cu",
                             "src/repro/kernels/edc_cosine.py:49"),
              # the partial-sum entry: edc_cosine on a d-block, its sums
              # all-reduced over the model axis (XLA's partitioning of the
              # same Pallas kernel's products)
              "edc_cosine_partial": ("src/repro_torch/csrc/edc_cosine.cu",
                                     "src/repro/kernels/edc_cosine.py:49"),
              "madc": ("src/repro_torch/csrc/madc.cu",
                       "src/repro/kernels/madc.py:78"),
              "swa_attention.tc": ("src/repro_torch/csrc/swa_attention_tc.cu",
                                   "src/repro/kernels/swa_attention.py:73"),
              "swa_attention.fp32": ("src/repro_torch/csrc/swa_attention.cu",
                                     "src/repro/kernels/swa_attention.py:73"),
              "ssd_intra_chunk.tc": ("src/repro_torch/csrc/ssd_chunk_tc.cu",
                                     "src/repro/kernels/ssd_chunk.py:49"),
              "ssd_intra_chunk.fp32": ("src/repro_torch/csrc/ssd_chunk.cu",
                                       "src/repro/kernels/ssd_chunk.py:49"),
              # the backward kernels replace no Pallas kernel: the jnp
              # function whose jax.vjp each matches
              "swa_attention_bwd.tc": ("src/repro_torch/csrc/"
                                       "swa_attention_bwd_tc.cu",
                                       "src/repro/kernels/ref.py:23"),
              "swa_attention_bwd.fp32": ("src/repro_torch/csrc/"
                                         "swa_attention_bwd.cu",
                                         "src/repro/kernels/ref.py:23"),
              "ssd_intra_chunk_bwd": ("src/repro_torch/csrc/ssd_chunk_bwd.cu",
                                      "src/repro/models/ssm.py:86")}
    kernels = []
    for name, (source, replaces) in src_of.items():
        row = rows[name]
        if launches[name] < 1:
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        kill_live_ranks()
    sys.exit(rc)
